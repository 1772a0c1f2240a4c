"""Carry weights between the JAX package's flax tree and the port's modules.

The port names its parameters as the flax tree does and keeps flax's (in,
out) kernel layout, so the mapping is by path:

- ``token_emb`` ((vocab_total + 1) rows rounded up to 128; BOS is row
  ``vocab_total``), ``text_pos_emb``, ``img_row_emb``, ``img_col_emb``,
  ``lm_head/kernel`` when the head is untied;
- the blocks: ``transformer/cycle/block_{uid}`` (the weight-shared
  ``nn.scan`` layout, or the ``dense_scan`` layout's stacked blocks, one a
  position of the attention-type group with a leading axis of
  ``dense_scan_reps()``) or ``transformer/block_{uid}`` (unrolled), plus
  ``transformer/block_wconv`` and ``transformer/final_norm``, all onto
  ``transformer.blocks.block_*`` / ``transformer.final_norm``;
- inside a block: ``attn/{q,k,v}/kernel`` (bias-free), ``attn/out/{kernel,
  bias}``, ``ff/{wi,gate,wo}/{kernel,bias}``, ``{attn,ff}_norm/{scale,bias}``.

:func:`opt_state_from_jax` carries the 8-bit LAMB's state across the same
way, so that both optimizers can step from one state.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from dalle_tpu_torch.config import ModelConfig
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops.quant import Quantized


def jax_layout_scanned(cfg: ModelConfig) -> bool:
    """Whether the JAX model stores its body blocks under
    ``transformer/cycle`` (its stack ran as an ``nn.scan``: the shared
    blocks, or the stacked ``dense_scan`` ones)."""
    if cfg.dense_scan_reps() > 0:
        return True
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
    if isinstance(arr, torch.Tensor):  # a leaf read by training/checkpoint
        return arr.detach().clone()
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


def _conv_from_flax(kernel) -> torch.Tensor:
    """flax conv kernel (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def _f32(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32))


def vqgan_from_jax(tree, cfg):
    """A :class:`~dalle_tpu_torch.models.vqgan.VQGANDecoder` with the
    weights of the JAX package's ``VQGANDecoder`` parameters (``{"params":
    ...}``): the inverse of ``dalle_tpu.models.vqgan.map_taming_state_dict``
    (flax names -> taming's)."""
    from dalle_tpu_torch.models.vqgan import VQGANDecoder

    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {
        "quantize.embedding.weight": _f32(p["codebook"])}

    def conv(prefix, leaf):
        sd[f"{prefix}.weight"] = _conv_from_flax(leaf["kernel"])
        sd[f"{prefix}.bias"] = _f32(leaf["bias"])

    def norm(prefix, leaf):
        sd[f"{prefix}.weight"] = _f32(leaf["scale"])
        sd[f"{prefix}.bias"] = _f32(leaf["bias"])

    def block(prefix, leaf):
        for name, sub in leaf.items():
            (norm if name.startswith("norm") else conv)(
                f"{prefix}.{name}", sub)

    conv("post_quant_conv", p["post_quant_conv"])
    conv("decoder.conv_in", p["conv_in"])
    for name in ("block_1", "attn_1", "block_2"):
        block(f"decoder.mid.{name}", p[f"mid_{name}"])
    for name, leaf in p.items():
        if name.startswith("up_"):
            _, level, kind, *idx = name.split("_")
            prefix = (f"decoder.up.{level}.upsample.conv"
                      if kind == "upsample"
                      else f"decoder.up.{level}.{kind}.{idx[0]}")
            (conv if kind == "upsample" else block)(prefix, leaf)
    norm("decoder.norm_out", p["norm_out"])
    conv("decoder.conv_out", p["conv_out"])
    model = VQGANDecoder(cfg)
    model.load_state_dict(sd)
    return model.eval()


def clip_from_jax(tree, cfg):
    """A :class:`~dalle_tpu_torch.models.clip.CLIPModel` with the weights
    of the JAX package's ``CLIPModel`` parameters: the inverse of
    ``dalle_tpu.models.clip.map_openai_state_dict`` (per-head flax
    attention kernels -> the packed ``in_proj_weight``)."""
    from dalle_tpu_torch.models.clip import CLIPModel

    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}

    def ln(prefix, leaf):
        sd[f"{prefix}.weight"] = _f32(leaf["scale"])
        sd[f"{prefix}.bias"] = _f32(leaf["bias"])

    def dense(prefix, leaf):
        sd[f"{prefix}.weight"] = _f32(leaf["kernel"]).t().contiguous()
        sd[f"{prefix}.bias"] = _f32(leaf["bias"])

    def block(prefix, leaf, width):
        attn = leaf["attn"]
        sd[f"{prefix}.attn.in_proj_weight"] = torch.cat([
            _f32(attn[n]["kernel"]).reshape(width, width).t()
            for n in ("query", "key", "value")])
        sd[f"{prefix}.attn.in_proj_bias"] = torch.cat([
            _f32(attn[n]["bias"]).reshape(width)
            for n in ("query", "key", "value")])
        sd[f"{prefix}.attn.out_proj.weight"] = _f32(
            attn["out"]["kernel"]).reshape(width, width).t().contiguous()
        sd[f"{prefix}.attn.out_proj.bias"] = _f32(attn["out"]["bias"])
        ln(f"{prefix}.ln_1", leaf["ln_1"])
        ln(f"{prefix}.ln_2", leaf["ln_2"])
        dense(f"{prefix}.mlp.c_fc", leaf["mlp_fc"])
        dense(f"{prefix}.mlp.c_proj", leaf["mlp_proj"])

    sd["visual.conv1.weight"] = _conv_from_flax(p["patch_embed"]["kernel"])
    sd["visual.class_embedding"] = _f32(p["class_embedding"])
    sd["visual.positional_embedding"] = _f32(p["vision_pos"])
    ln("visual.ln_pre", p["ln_pre"])
    ln("visual.ln_post", p["ln_post"])
    sd["visual.proj"] = _f32(p["vision_proj"])
    sd["token_embedding.weight"] = _f32(p["token_embedding"])
    sd["positional_embedding"] = _f32(p["text_pos"])
    ln("ln_final", p["ln_final"])
    sd["text_projection"] = _f32(p["text_proj"])
    sd["logit_scale"] = _f32(p["logit_scale"])
    for i in range(cfg.vision_layers):
        block(f"visual.transformer.resblocks.{i}", p[f"vision_block_{i}"],
              cfg.vision_width)
    for i in range(cfg.text_layers):
        block(f"transformer.resblocks.{i}", p[f"text_block_{i}"],
              cfg.text_width)
    model = CLIPModel(cfg)
    model.load_state_dict(sd)
    return model.eval()


# -- the JAX package's leaf order (the swarm wire and the checkpoints) ----

def jax_leaf_names(cfg: ModelConfig) -> List[str]:
    """The port's parameter names in the order of
    ``jax.tree_util.tree_leaves(params)`` for the JAX model of ``cfg``:
    the flax paths with the keys of every level sorted. Gradients cross
    the swarm wire, and state is transferred and averaged, in this order,
    so a torch peer and a JAX peer average the same coordinates."""
    return list(_jax_leaf_names(cfg))


@functools.lru_cache(maxsize=16)
def _jax_leaf_names(cfg: ModelConfig) -> Tuple[str, ...]:
    with torch.device("meta"):      # names only: no parameter storage
        names = list(DALLE(cfg).state_dict())
    return tuple(sorted(names, key=lambda n: flax_path(n, cfg)))


#: one leaf of the (params, opt_state) state: ("param", name), ("count",),
#: or (moment, name, part) with moment "mu"/"nu" and part "codes",
#: "absmax" (a quantized moment) or "dense"
StateLeaf = Tuple[str, ...]


def jax_state_leaves(cfg: ModelConfig, opt_state) -> List[StateLeaf]:
    """The leaves of ``(params, opt_state)`` in the order of the JAX
    package's ``CollaborativeOptimizer._state_leaves``: the parameters
    (:func:`jax_leaf_names`), the LAMB step count, then the ``mu`` and the
    ``nu`` trees in the same order, a quantized moment as its codes and
    then its absmax."""
    names = jax_leaf_names(cfg)
    out: List[StateLeaf] = [("param", n) for n in names]
    out.append(("count",))
    for moment in ("mu", "nu"):
        tree = getattr(opt_state, moment)
        for n in names:
            if isinstance(tree[n], Quantized):
                out += [(moment, n, "codes"), (moment, n, "absmax")]
            else:
                out.append((moment, n, "dense"))
    return out


def state_leaf_tensors(model: DALLE, opt_state) -> List[torch.Tensor]:
    """The tensors of ``(model, opt_state)`` in :func:`jax_state_leaves`
    order (live references, except the count: a new 0-d int32 tensor)."""
    params = dict(model.named_parameters())
    out = []
    for leaf in jax_state_leaves(model.cfg, opt_state):
        if leaf[0] == "param":
            out.append(params[leaf[1]].detach())
        elif leaf[0] == "count":
            out.append(torch.tensor(int(opt_state.count), dtype=torch.int32))
        else:
            moment = getattr(opt_state, leaf[0])[leaf[1]]
            out.append(moment if leaf[2] == "dense"
                       else getattr(moment, leaf[2]))
    return out


def _as_tensor_like(a, like: torch.Tensor) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.reshape(like.shape).to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def load_state_leaves(model: DALLE, opt_state, arrays):
    """Adopt ``arrays`` (host arrays or tensors in :func:`jax_state_leaves`
    order) as the state: parameters are copied in place, each cast to its
    parameter's dtype; returns the new optimizer state (same type, moments
    on the parameters' device). Raises on a count or shape mismatch."""
    leaves = jax_state_leaves(model.cfg, opt_state)
    if len(arrays) != len(leaves):
        raise ValueError(f"state has {len(leaves)} leaves, got "
                         f"{len(arrays)}")
    params = dict(model.named_parameters())
    count = opt_state.count
    mu, nu = dict(opt_state.mu), dict(opt_state.nu)
    fresh = {}
    for leaf, a in zip(leaves, arrays):
        if leaf[0] == "param":
            p = params[leaf[1]]
            p.copy_(_as_tensor_like(a, p))
        elif leaf[0] == "count":
            count = int(np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                   else a))
        else:
            tree = mu if leaf[0] == "mu" else nu
            old = tree[leaf[1]]
            if leaf[2] == "dense":
                tree[leaf[1]] = _as_tensor_like(a, old)
            else:
                fresh.setdefault((leaf[0], leaf[1]), {})[leaf[2]] = \
                    _as_tensor_like(a, getattr(old, leaf[2]))
    for (moment, name), parts in fresh.items():
        tree = mu if moment == "mu" else nu
        old = tree[name]
        tree[name] = Quantized(parts["codes"], parts["absmax"], old.shape,
                               old.signed)
    return type(opt_state)(count, mu, nu)
