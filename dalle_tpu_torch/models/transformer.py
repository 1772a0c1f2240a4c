"""Transformer stack with the weight-sharing schedule (counterpart of
``dalle_tpu/models/transformer.py``).

Parameters are named as in the flax tree (``attn/q/kernel``,
``ff/wi/bias``, ``attn_norm/scale`` ...) and kept in flax's (in, out)
kernel layout, so ``params.py`` maps one tree onto the other by name and the
GEGLU kernel takes ``Wi`` as (d, K) as the TPU kernel does. Blocks that
share an id are one module; the depth is a Python loop over
``cfg.layer_schedule()`` (no scan, and no remat: this is the forward).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dalle_tpu_torch.config import ModelConfig
from dalle_tpu_torch.models.attention import (apply_rotary, rotary_cos_sin,
                                              zoo_attention)
from dalle_tpu_torch.ops.geglu import geglu_ff
from dalle_tpu_torch.ops.layer_norm import layer_norm

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
            y = layer_norm(x.reshape(-1, shape[-1]), self.scale, self.bias,
                           LN_EPS)
            return y.reshape(shape).to(dtype)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        msq = (xf * xf).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(torch.clamp(msq - mean * mean, min=0.0) + LN_EPS)
        y = (xf - mean) * (rstd * self.scale.float()) + self.bias.float()
        return y.to(dtype)


class ZooAttention(nn.Module):
    """Bias-free q/k/v projections, rotary, zoo attention, biased out."""

    def __init__(self, cfg: ModelConfig, attn_type: str):
        super().__init__()
        self.cfg, self.attn_type = cfg, attn_type
        pd = torch_dtype(cfg.param_dtype)
        self.q = Dense(cfg.dim, cfg.dim, False, pd)
        self.k = Dense(cfg.dim, cfg.dim, False, pd)
        self.v = Dense(cfg.dim, cfg.dim, False, pd)
        self.out = Dense(cfg.dim, cfg.dim, True, pd)

    def forward(self, x: torch.Tensor, rot) -> torch.Tensor:
        cfg = self.cfg
        cd = torch_dtype(cfg.dtype)
        b, t, _ = x.shape
        q, k, v = (proj(x, cd).reshape(b, t, cfg.heads, cfg.head_dim)
                   for proj in (self.q, self.k, self.v))
        if rot is not None:
            cos, sin = rot
            q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        out = zoo_attention(q, k, v, attn_type=self.attn_type,
                            text_len=cfg.text_seq_len, grid=cfg.image_grid,
                            conv_kernel=cfg.conv_kernel)
        return self.out(out.reshape(b, t, cfg.dim), cd)


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
            out = geglu_ff(x.reshape(b * t, d).to(cd),
                           *(p.to(cd) for p in (
                               self.wi.kernel, self.gate.kernel,
                               self.wo.kernel, self.wi.bias,
                               self.gate.bias, self.wo.bias)))
            return out.reshape(b, t, self.cfg.dim)
        h = self.wi(x, cd)
        gate = self.gate(x, cd)
        return self.wo(h * F.gelu(gate, approximate="tanh"), cd)


class TransformerBlock(nn.Module):
    """Pre-norm attention + GEGLU FF with residuals."""

    def __init__(self, cfg: ModelConfig, attn_type: str, fuse_ff: bool):
        super().__init__()
        self.cfg = cfg
        pd = torch_dtype(cfg.param_dtype)
        self.attn_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd)
        self.attn = ZooAttention(cfg, attn_type)
        self.ff_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd)
        self.ff = GEGLUFeedForward(cfg, fuse_ff)

    def forward(self, x: torch.Tensor, rot) -> torch.Tensor:
        cd = torch_dtype(self.cfg.dtype)
        x = x + self.attn(self.attn_norm(x, cd), rot)
        return x + self.ff(self.ff_norm(x, cd))


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
                    cfg, attn_type, cfg.fuse_ff(uid in plain))
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
