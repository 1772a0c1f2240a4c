"""Carry weights between the JAX package's flax tree and the port's modules.

The port names its parameters as the flax tree does and keeps flax's (in,
out) kernel layout, so the mapping is by path:

- ``token_emb`` ((vocab_total + 1) rows rounded up to 128; BOS is row
  ``vocab_total``), ``text_pos_emb``, ``img_row_emb``, ``img_col_emb``,
  ``lm_head/kernel`` when the head is untied;
- the blocks: ``transformer/cycle/block_{uid}`` (the weight-shared
  ``nn.scan`` layout) or ``transformer/block_{uid}`` (unrolled), plus
  ``transformer/block_wconv`` and ``transformer/final_norm``, all onto
  ``transformer.blocks.block_*`` / ``transformer.final_norm``;
- inside a block: ``attn/{q,k,v}/kernel`` (bias-free), ``attn/out/{kernel,
  bias}``, ``ff/{wi,gate,wo}/{kernel,bias}``, ``{attn,ff}_norm/{scale,bias}``.

The ``dense_scan`` layout (stacked per-repetition leaves) is not taken.

:func:`opt_state_from_jax` carries the 8-bit LAMB's state across the same
way, so that both optimizers can step from one state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dalle_tpu_torch.config import ModelConfig
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops.quant import Quantized


def jax_layout_scanned(cfg: ModelConfig) -> bool:
    """Whether the JAX model stores its shared blocks under
    ``transformer/cycle`` (its stack ran as an ``nn.scan``)."""
    cycle = cfg.shared_block_cycle
    if not cycle:
        return False
    body = cfg.depth - (1 if cfg.final_conv_block else 0)
    return -(-body // (cycle * max(1, cfg.scan_unroll))) > 1


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _port_name(path) -> str:
    if path[0] == "transformer" and path[1] == "cycle":
        path = ("transformer", "blocks") + path[2:]
    elif path[0] == "transformer" and path[1].startswith("block"):
        path = ("transformer", "blocks") + path[1:]
    return ".".join(path)


def params_from_jax(tree, cfg: ModelConfig) -> DALLE:
    """A port ``DALLE`` (on the CPU) holding the flax tree's weights.
    ``tree``: the flax variables as nested dicts of numpy arrays (with or
    without the top-level ``params`` key)."""
    if cfg.dense_scan_reps() > 0:
        raise ValueError("params_from_jax: the dense_scan layout (stacked "
                         "per-repetition block leaves) is not supported; "
                         "convert an unrolled or weight-shared tree")
    root = tree["params"] if "params" in tree else tree
    state = {_port_name(tuple(path)): _to_torch(leaf)
             for path, leaf in _flatten(root)}
    model = DALLE(cfg)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise ValueError(f"params_from_jax: tree does not match the config: "
                         f"missing {missing[:8]}, unexpected {extra[:8]}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{tuple(expected[name].shape)}")
    model.load_state_dict(state)
    return model


def _moment_from_jax(leaf):
    """A port moment from a JAX one: a ``Quantized`` (codes, absmax, shape,
    signed) or a dense f32 array."""
    if hasattr(leaf, "codes"):
        return Quantized(_to_torch(leaf.codes), _to_torch(leaf.absmax),
                         tuple(leaf.shape), bool(leaf.signed))
    return _to_torch(leaf)


def _moments_from_jax(tree) -> Dict:
    root = tree["params"] if "params" in tree else tree
    return {_port_name(tuple(path)): _moment_from_jax(leaf)
            for path, leaf in _flatten(root)}


def opt_state_from_jax(state, cfg: ModelConfig):
    """The port's ``Lamb8bitState`` (on the CPU, keyed by the port's
    parameter names) holding the JAX package's ``Lamb8bitState``: ``count``
    and the ``mu``/``nu`` trees, whose leaves are numpy ``Quantized`` records
    (codes (n_blocks, block) u8, absmax (n_blocks, 1) f32) or dense f32
    moments, in the flax layout of ``cfg``'s model."""
    from dalle_tpu_torch.optim.lamb8bit import Lamb8bitState
    if cfg.dense_scan_reps() > 0:
        raise ValueError("opt_state_from_jax: the dense_scan layout is not "
                         "supported")
    expected = set(DALLE(cfg).state_dict())
    mu, nu = _moments_from_jax(state.mu), _moments_from_jax(state.nu)
    for moments in (mu, nu):
        if set(moments) != expected:
            raise ValueError(
                "opt_state_from_jax: moments do not match the config: "
                f"missing {sorted(expected - set(moments))[:8]}, "
                f"unexpected {sorted(set(moments) - expected)[:8]}")
    return Lamb8bitState(int(np.asarray(state.count)), mu, nu)


def flax_path(name: str, cfg: ModelConfig) -> Tuple[str, ...]:
    """The flax tree path (under ``params``) of the port parameter
    ``name``, in the layout the JAX model of ``cfg`` writes."""
    path = name.split(".")
    if path[:2] == ["transformer", "blocks"]:
        scanned = jax_layout_scanned(cfg) and path[2] != "block_wconv"
        path = (["transformer", "cycle"] if scanned
                else ["transformer"]) + path[2:]
    return tuple(path)


def params_to_jax(model: DALLE) -> Dict:
    """The flax tree (``{"params": ...}``, numpy leaves) of ``model``, in
    the layout the JAX model of the same config writes."""
    out: Dict = {}
    for name, t in model.state_dict().items():
        path = flax_path(name, model.cfg)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_numpy(t)
    return {"params": out}
