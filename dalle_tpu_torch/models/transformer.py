"""Transformer stack with the weight-sharing schedule (counterpart of
``dalle_tpu/models/transformer.py``).

Parameters are named as in the flax tree (``attn/q/kernel``,
``ff/wi/bias``, ``attn_norm/scale`` ...) and kept in flax's (in, out)
kernel layout, so ``params.py`` maps one tree onto the other by name and the
GEGLU kernel takes ``Wi`` as (d, K) as the TPU kernel does. Blocks that
share an id are one module; the depth is a Python loop over
``cfg.layer_schedule()`` (no scan).

A dense model that the JAX package stacks (``cfg.dense_scan_reps() > 0``,
its ``dense_scan`` layout) holds one module a position of the attention-type
group, ``block_{u}`` for ``u`` in ``range(len(attn_types))``, each of whose
parameters has a leading axis of ``reps``: body layer ``i`` reads slice ``i
// group`` of ``block_{i % group}``. Each forward unbinds every stacked
parameter once (:meth:`Transformer.layers`), so autograd gives the stacked
gradient in one ``stack`` and every slice is contiguous. The slices go to
per-layer views that hold no parameters of their own: :func:`bound` puts
them in a view only while a part of it runs, and a rematerialised view's
checkpoint keeps them for its replay, so no slice (nor the cast copy it
views) outlives the step's autograd graph. Where the body is not a
multiple of the group (the flagship's 63 = 15 x 4 + 3), the last repetition
has slices that no layer reads: the JAX scan applies them and discards the
result, the port never applies them, and in both their gradient is zero.

Remat, as the JAX package configures it (``cfg.remat``, the highest
``remat_skip_blocks`` body block ids left plain, ``w_conv`` always
rematerialised), applies only while autograd records: under ``no_grad`` or
``inference_mode`` every block runs exactly as the plain forward. A
rematerialised block is ``torch.utils.checkpoint`` (non-reentrant):

- ``remat_policy=None`` (blanket remat): the whole block is one
  checkpoint, so only its input is kept and backward replays it, the
  attention forward kernels included.
- ``remat_policy="save_attn"``: the JAX policy saves the rotated q/k/v
  and the attention kernels' out/lse. Here the block is two checkpoints,
  the part before the attention Functions (norm, projections, rotary ->
  q, k, v) and the part after them (output projection, residual, norm,
  FF), with the Functions between them, outside both: their saved
  tensors (q, k, v, prefix, out, lse) are the residuals, so the attention
  forward kernels never run again in backward. The replay of the first
  part recomputes the q/k/v projections, which JAX does not (it needs
  only the norm's output for their weight gradients).
- ``remat_policy="save_ctx"`` is not ported and raises.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dalle_tpu_torch.config import ATTN_AXIAL_COL, ATTN_AXIAL_ROW, ModelConfig
from dalle_tpu_torch.models.attention import (apply_rotary, join_halves,
                                              rotary_cos_sin,
                                              zoo_attention_halves)
from dalle_tpu_torch.ops import LAUNCHES
from dalle_tpu_torch.ops.geglu import GEGLUFn
from dalle_tpu_torch.ops.layer_norm import LayerNormFn

LN_EPS = 1e-6


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Dense(nn.Module):
    """flax ``nn.Dense`` parameters: ``kernel`` (in, out), optional
    ``bias`` (out,). Applied in the computation dtype, as flax casts
    both operands to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 param_dtype: torch.dtype, stack: Tuple[int, ...] = ()):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(
            *stack, in_features, out_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(*stack, out_features,
                                              dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class LayerNorm(nn.Module):
    """The block norm: ``{scale, bias}`` (d,) in param dtype.

    ``fused`` (``cfg.ln_fusion``) is the JAX package's ``FusedLayerNorm``:
    the LayerNorm kernel, ``(x - mean) * rstd * scale + bias``. Otherwise
    flax's ``nn.LayerNorm``: ``(x - mean) * (rstd * scale) + bias``. Both
    take f32 statistics with the fast variance."""

    def __init__(self, dim: int, fused: bool, param_dtype: torch.dtype,
                 stack: Tuple[int, ...] = ()):
        super().__init__()
        self.fused = fused
        self.scale = nn.Parameter(torch.ones(*stack, dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(*stack, dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shape = x.shape
        if self.fused:
            y = LayerNormFn.apply(x.reshape(-1, shape[-1]), self.scale,
                                  self.bias, LN_EPS)
            return y.reshape(shape).to(dtype)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        msq = (xf * xf).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(torch.clamp(msq - mean * mean, min=0.0) + LN_EPS)
        y = (xf - mean) * (rstd * self.scale.float()) + self.bias.float()
        return y.to(dtype)


class ZooAttention(nn.Module):
    """Bias-free q/k/v projections, rotary, zoo attention, biased out:
    three steps, which :class:`TransformerBlock` chains (and checkpoints
    apart under ``save_attn``)."""

    def __init__(self, cfg: ModelConfig, attn_type: str,
                 stack: Tuple[int, ...] = ()):
        super().__init__()
        self.cfg, self.attn_type = cfg, attn_type
        pd = torch_dtype(cfg.param_dtype)
        self.q = Dense(cfg.dim, cfg.dim, False, pd, stack)
        self.k = Dense(cfg.dim, cfg.dim, False, pd, stack)
        self.v = Dense(cfg.dim, cfg.dim, False, pd, stack)
        self.out = Dense(cfg.dim, cfg.dim, True, pd, stack)

    def qkv(self, x: torch.Tensor, rot):
        """The rotated (B, T, H, d) q, k and v of the normed input."""
        cfg = self.cfg
        cd = torch_dtype(cfg.dtype)
        b, t, _ = x.shape
        q, k, v = (proj(x, cd).reshape(b, t, cfg.heads, cfg.head_dim)
                   for proj in (self.q, self.k, self.v))
        if rot is not None:
            cos, sin = rot
            q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        return q, k, v

    def attend(self, q, k, v):
        """The attention kernels' (text, image) outputs, (B, H, t, d)."""
        cfg = self.cfg
        return zoo_attention_halves(
            q, k, v, attn_type=self.attn_type, text_len=cfg.text_seq_len,
            grid=cfg.image_grid, conv_kernel=cfg.conv_kernel)

    def project(self, out_t, out_i) -> torch.Tensor:
        """The output projection of the joined halves, (B, T, dim)."""
        out = join_halves(out_t, out_i)
        b, t = out.shape[:2]
        return self.out(out.reshape(b, t, self.cfg.dim),
                        torch_dtype(self.cfg.dtype))


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP with biased ``wi``/``gate``/``wo``. ``fuse`` routes it
    through the fused GEGLU kernel (``cfg.fuse_ff``); otherwise the
    unfused ``h * gelu(gate)`` in the computation dtype, as the JAX
    package computes it on the blocks it does not fuse."""

    def __init__(self, cfg: ModelConfig, fuse: bool,
                 stack: Tuple[int, ...] = ()):
        super().__init__()
        self.cfg, self.fuse = cfg, fuse
        pd = torch_dtype(cfg.param_dtype)
        inner = cfg.ff_mult * cfg.dim
        self.wi = Dense(cfg.dim, inner, True, pd, stack)
        self.gate = Dense(cfg.dim, inner, True, pd, stack)
        self.wo = Dense(inner, cfg.dim, True, pd, stack)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = torch_dtype(self.cfg.dtype)
        if self.fuse:
            b, t, d = x.shape
            out = GEGLUFn.apply(x.reshape(b * t, d).to(cd),
                                *(p.to(cd) for p in (
                                    self.wi.kernel, self.gate.kernel,
                                    self.wo.kernel, self.wi.bias,
                                    self.gate.bias, self.wo.bias)))
            return out.reshape(b, t, self.cfg.dim)
        h = self.wi(x, cd)
        gate = self.gate(x, cd)
        return self.wo(h * F.gelu(gate, approximate="tanh"), cd)


class TransformerBlock(nn.Module):
    """Pre-norm attention + GEGLU FF with residuals. ``remat``: checkpoint
    the block (by ``cfg.remat_policy``) while autograd records. ``stack``:
    the leading axes of every parameter (``(reps,)`` for a stacked
    ``dense_scan`` block, which only holds the parameters: its layers
    apply them, :meth:`Transformer.layers`)."""

    def __init__(self, cfg: ModelConfig, attn_type: str, fuse_ff: bool,
                 remat: bool = False, stack: Tuple[int, ...] = ()):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        pd = torch_dtype(cfg.param_dtype)
        self.attn_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd, stack)
        self.attn = ZooAttention(cfg, attn_type, stack)
        self.ff_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd, stack)
        self.ff = GEGLUFeedForward(cfg, fuse_ff, stack)

    def _pre(self, x, rot):
        return self.attn.qkv(self.attn_norm(x, torch_dtype(self.cfg.dtype)),
                             rot)

    def _post(self, x, out_t, out_i):
        x = x + self.attn.project(out_t, out_i)
        return x + self.ff(self.ff_norm(x, torch_dtype(self.cfg.dtype)))

    def _block(self, x, rot):
        return self._post(x, *self.attn.attend(*self._pre(x, rot)))

    def forward(self, x: torch.Tensor, rot, params=None) -> torch.Tensor:
        """``params``: a stacked layer view's slices (:meth:`Transformer.
        layers`), bound while each part runs; a checkpoint holds them in
        its closure for the replay."""
        def run(fn, *args):
            with bound(params):
                return fn(*args)

        if not (self.remat and torch.is_grad_enabled()):
            return run(self._block, x, rot)
        policy = self.cfg.remat_policy
        if policy is None:
            return checkpoint(run, self._block, x, rot, use_reentrant=False)
        if policy == "save_attn":
            q, k, v = checkpoint(run, self._pre, x, rot, use_reentrant=False)
            halves = self.attn.attend(q, k, v)
            return checkpoint(run, self._post, x, *halves,
                              use_reentrant=False)
        raise NotImplementedError(
            f"remat_policy={policy!r} is not ported; ROADMAP.md Queue 1 "
            "lists it (remat_policy='save_ctx')")


Slices = List[Tuple[nn.Module, str, torch.Tensor]]


@contextlib.contextmanager
def bound(params: Optional[Slices]):
    """Within the block, each ``(module, name, tensor)`` of ``params`` is
    that module's parameter ``name``; after it, None again."""
    params = params or ()
    for module, name, tensor in params:
        module._parameters[name] = tensor
    try:
        yield
    finally:
        for module, name, _ in params:
            module._parameters[name] = None


def block_name(uid: int) -> str:
    return "block_wconv" if uid == -1 else f"block_{uid}"


class Transformer(nn.Module):
    """The depth-``cfg.depth`` stack: one module per unique block id (or per
    group position of the stacked ``dense_scan`` layout), applied in
    ``cfg.layer_schedule()`` order, then the final norm."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        plain = set(cfg.plain_block_ids())
        reps = cfg.dense_scan_reps()
        group = len(cfg.attn_types)
        self.blocks = nn.ModuleDict()
        for uid, attn_type in cfg.layer_schedule():
            stacked = reps > 0 and uid != -1
            name = block_name(uid % group if stacked else uid)
            if name not in self.blocks:
                self.blocks[name] = TransformerBlock(
                    cfg, attn_type, cfg.fuse_ff(uid in plain),
                    remat=cfg.remat and uid not in plain,
                    stack=(reps,) if stacked else ())
        self.final_norm = LayerNorm(cfg.dim, cfg.ln_fusion,
                                    torch_dtype(cfg.param_dtype))
        # the stacked layout's layers: modules without storage of their
        # own (built on the meta device, never registered, so they are
        # neither parameters nor moved by ``to``), whose parameters are
        # None but while :func:`bound` puts a repetition's slices in;
        # _slots lists (group position, block module, parameter name, the
        # layers' modules)
        self._views, self._slots = [], []
        for u in range(group if reps else 0):
            block = self.blocks[block_name(u)]
            with torch.device("meta"):
                views = [TransformerBlock(cfg, cfg.attn_types[u],
                                          block.ff.fuse, block.remat)
                         for _ in range(reps)]
            self._views.append(views)
            for mod_name, mod in block.named_modules():
                for leaf in mod._parameters:
                    subs = [v.get_submodule(mod_name) for v in views]
                    for sub in subs:
                        sub._parameters[leaf] = None
                    self._slots.append((u, mod, leaf, subs))

    def rotary(self, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.cfg.rotary:
            return None
        return rotary_cos_sin(torch.arange(self.cfg.total_seq_len,
                                           device=device), self.cfg.head_dim)

    def layers(self) -> List[Tuple[nn.Module, Optional[Slices]]]:
        """``(module, params)`` for each ``cfg.layer_schedule()`` position:
        params None for a block with parameters of its own. In the stacked
        layout the module is a storage-free view and params its
        repetition's slices of every stacked parameter as it is now (a
        cast copy under ``cast_parameters`` included), which the module
        binds (:func:`bound`) while it runs. Call it once per forward."""
        slices = [[[] for _ in views] for views in self._views]
        for u, block_param, leaf, subs in self._slots:
            parts = block_param._parameters[leaf].unbind(0)
            for rep, (sub, part) in enumerate(zip(subs, parts)):
                slices[u][rep].append((sub, leaf, part))
        group = len(self.cfg.attn_types)
        out = []
        for uid, _ in self.cfg.layer_schedule():
            if self._views and uid != -1:
                rep, u = divmod(uid, group)
                out.append((self._views[u][rep], slices[u][rep]))
            else:
                out.append((self.blocks[block_name(uid)], None))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rot = self.rotary(x.device)
        for layer, params in self.layers():
            x = layer(x, rot, params)
        return self.final_norm(x, torch_dtype(self.cfg.dtype))


def wrapper_calls(cfg: ModelConfig, training: bool) -> Dict[str, int]:
    """The kernel wrappers' calls (the keys of ``ops.LAUNCHES``) in one
    forward of a (B, T) batch, from the schedule and the remat set; with
    ``training``, also those of its backward: one backward call per forward
    call, and the forward calls a rematerialised block runs again (under
    ``save_attn`` all but the attention's; under blanket remat all). The
    wrappers the model never calls (the backward ones without
    ``training``, the quantizers) count 0."""
    plain = set(cfg.plain_block_ids())
    calls = {"layer_norm": 0, "line_attention": 0, "window_attention": 0,
             "geglu_ff": 0}

    def block(uid: int, attn_type: str, n: int, attention: bool = True):
        calls["layer_norm"] += 2 * n if cfg.ln_fusion else 0
        if attention:
            calls["line_attention"] += n
            axial = attn_type in (ATTN_AXIAL_ROW, ATTN_AXIAL_COL)
            calls["line_attention" if axial else "window_attention"] += n
        calls["geglu_ff"] += n if cfg.fuse_ff(uid in plain) else 0

    sched = cfg.layer_schedule()
    for uid, attn_type in sched:
        block(uid, attn_type, 1)
    calls["layer_norm"] += 1 if cfg.ln_fusion else 0      # final norm
    out = dict(calls)
    if training:
        out.update({f"{k}_bwd": v for k, v in calls.items()})
        for uid, attn_type in sched:
            if cfg.remat and uid not in plain:
                block(uid, attn_type, 1,
                      attention=cfg.remat_policy is None)
        out.update(calls)
    return dict.fromkeys(LAUNCHES, 0) | out
