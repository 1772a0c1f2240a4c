"""Transformer stack with the weight-sharing schedule (counterpart of
``dalle_tpu/models/transformer.py``).

Parameters are named as in the flax tree (``attn/q/kernel``,
``ff/wi/bias``, ``attn_norm/scale`` ...) and kept in flax's (in, out)
kernel layout, so ``params.py`` maps one tree onto the other by name and the
GEGLU kernel takes ``Wi`` as (d, K) as the TPU kernel does. Blocks that
share an id are one module; the depth is a Python loop over
``cfg.layer_schedule()`` (no scan).

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

from typing import Dict, Optional, Tuple

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
                 param_dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features,
                                               dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype))
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

    def __init__(self, dim: int, fused: bool, param_dtype: torch.dtype):
        super().__init__()
        self.fused = fused
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

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

    def __init__(self, cfg: ModelConfig, attn_type: str):
        super().__init__()
        self.cfg, self.attn_type = cfg, attn_type
        pd = torch_dtype(cfg.param_dtype)
        self.q = Dense(cfg.dim, cfg.dim, False, pd)
        self.k = Dense(cfg.dim, cfg.dim, False, pd)
        self.v = Dense(cfg.dim, cfg.dim, False, pd)
        self.out = Dense(cfg.dim, cfg.dim, True, pd)

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

    def __init__(self, cfg: ModelConfig, fuse: bool):
        super().__init__()
        self.cfg, self.fuse = cfg, fuse
        pd = torch_dtype(cfg.param_dtype)
        inner = cfg.ff_mult * cfg.dim
        self.wi = Dense(cfg.dim, inner, True, pd)
        self.gate = Dense(cfg.dim, inner, True, pd)
        self.wo = Dense(inner, cfg.dim, True, pd)

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
    the block (by ``cfg.remat_policy``) while autograd records."""

    def __init__(self, cfg: ModelConfig, attn_type: str, fuse_ff: bool,
                 remat: bool = False):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        pd = torch_dtype(cfg.param_dtype)
        self.attn_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd)
        self.attn = ZooAttention(cfg, attn_type)
        self.ff_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd)
        self.ff = GEGLUFeedForward(cfg, fuse_ff)

    def _pre(self, x, rot):
        return self.attn.qkv(self.attn_norm(x, torch_dtype(self.cfg.dtype)),
                             rot)

    def _post(self, x, out_t, out_i):
        x = x + self.attn.project(out_t, out_i)
        return x + self.ff(self.ff_norm(x, torch_dtype(self.cfg.dtype)))

    def _block(self, x, rot):
        return self._post(x, *self.attn.attend(*self._pre(x, rot)))

    def forward(self, x: torch.Tensor, rot) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(x, rot)
        policy = self.cfg.remat_policy
        if policy is None:
            return checkpoint(self._block, x, rot, use_reentrant=False)
        if policy == "save_attn":
            q, k, v = checkpoint(self._pre, x, rot, use_reentrant=False)
            halves = self.attn.attend(q, k, v)
            return checkpoint(self._post, x, *halves, use_reentrant=False)
        raise NotImplementedError(
            f"remat_policy={policy!r} is not ported; ROADMAP.md Queue 1 "
            "lists it (remat_policy='save_ctx')")


def block_name(uid: int) -> str:
    return "block_wconv" if uid == -1 else f"block_{uid}"


class Transformer(nn.Module):
    """The depth-``cfg.depth`` stack: one module per unique block id, applied
    in ``cfg.layer_schedule()`` order, then the final norm."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        plain = set(cfg.plain_block_ids())
        self.blocks = nn.ModuleDict()
        for uid, attn_type in cfg.layer_schedule():
            name = block_name(uid)
            if name not in self.blocks:
                self.blocks[name] = TransformerBlock(
                    cfg, attn_type, cfg.fuse_ff(uid in plain),
                    remat=cfg.remat and uid not in plain)
        self.final_norm = LayerNorm(cfg.dim, cfg.ln_fusion,
                                    torch_dtype(cfg.param_dtype))

    def rotary(self, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.cfg.rotary:
            return None
        return rotary_cos_sin(torch.arange(self.cfg.total_seq_len,
                                           device=device), self.cfg.head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rot = self.rotary(x.device)
        for uid, _ in self.cfg.layer_schedule():
            x = self.blocks[block_name(uid)](x, rot)
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
