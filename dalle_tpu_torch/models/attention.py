"""The DALL-E attention zoo in PyTorch (counterpart of
``dalle_tpu/models/attention.py``).

Text tokens attend causally to text; image token (r, c) attends to all text
plus, by layer type: ``full`` every earlier image token, ``axial_row`` its
row up to c, ``axial_col`` its column up to r, ``conv_like`` the raster-
causal k x k window around it.

:func:`zoo_attention_halves` routes every type through the port's kernels
as the JAX package routes them through Pallas: axial layers run
``line_attention`` for the text half and the image half; ``full`` and
``conv_like`` layers run ``line_attention`` for the text half and
``window_attention`` for the image half. Each call goes through its
autograd Function (``LineAttention``, ``WindowAttention``), so the backward
kernels give the gradients. The text keys and values are both the text
call's k/v and the image call's prefix: their gradient is the sum of the
text call's dk/dv and the image call's dkp/dvp, which autograd forms where
the two slices of k and v meet.
:func:`dense_attention` with :func:`zoo_attention_mask` is the masked
lowering the cached decode uses.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from dalle_tpu_torch.config import (ATTN_AXIAL_COL, ATTN_AXIAL_ROW,
                                    ATTN_CONV_LIKE, ATTN_FULL)
from dalle_tpu_torch.ops.attention import LineAttention, WindowAttention

NEG_INF = -1e9


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   base: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., head_dim) in f32 for the given positions."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.full((), base, dtype=torch.float32,
                                       device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding in f32 with rotate_half = concat(-x2, x1).
    x: (..., T, H, d); cos/sin: (T, d), or already broadcastable to x."""
    if cos.dim() < x.dim():
        cos, sin = cos[..., :, None, :], sin[..., :, None, :]
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


@functools.lru_cache(maxsize=64)
def zoo_attention_mask(attn_type: str, text_len: int, grid: int,
                       conv_kernel: int = 11) -> np.ndarray:
    """Boolean (T, T) mask, True = may attend, T = text_len + grid^2."""
    img_len = grid * grid
    total = text_len + img_len
    idx = np.arange(total)
    causal = idx[None, :] <= idx[:, None]
    mask = np.zeros((total, total), dtype=bool)
    mask[:text_len, :text_len] = causal[:text_len, :text_len]
    qi = np.arange(img_len)
    qr, qc = qi // grid, qi % grid
    kr, kc = qr, qc
    mask[text_len:, :text_len] = True
    if attn_type == ATTN_FULL:
        img_img = qi[None, :] <= qi[:, None]
    elif attn_type == ATTN_AXIAL_ROW:
        img_img = (kr[None, :] == qr[:, None]) & (kc[None, :] <= qc[:, None])
    elif attn_type == ATTN_AXIAL_COL:
        img_img = (kc[None, :] == qc[:, None]) & (kr[None, :] <= qr[:, None])
    elif attn_type == ATTN_CONV_LIKE:
        hw = conv_kernel // 2
        window = (np.abs(kr[None, :] - qr[:, None]) <= hw) & \
                 (np.abs(kc[None, :] - qc[:, None]) <= hw)
        img_img = window & (qi[None, :] <= qi[:, None])
    else:
        raise ValueError(f"unknown attention type {attn_type!r}")
    mask[text_len:, text_len:] = img_img
    return mask


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked attention. q: (B, Tq, H, d), k/v: (B, Tk, H, d), mask
    broadcastable to (B, H, Tq, Tk). Scores in f32, -1e9 fill, the
    probabilities cast to v's dtype before the f32-accumulated P.V."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def zoo_attention_halves(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, attn_type: str, text_len: int, grid: int,
                         conv_kernel: int = 11, saved=None):
    """The kernel calls of one zoo layer: ``(out_text, out_image)``, each
    (B, H, t, d). q/k/v: (B, T, H, d). ``saved``: under
    ``remat_policy="save_ctx"``, the two calls'
    :class:`~dalle_tpu_torch.ops.attention.SavedContext` holders."""
    saved_t, saved_i = saved or (None, None)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, T, d) views
    q_t, k_t, v_t = (x[:, :, :text_len] for x in (q, k, v))
    q_i, k_i, v_i = (x[:, :, text_len:] for x in (q, k, v))
    out_t = LineAttention.apply(q_t, k_t, v_t, None, None, text_len, 0,
                                False, saved_t)
    if attn_type in (ATTN_AXIAL_ROW, ATTN_AXIAL_COL):
        out_i = LineAttention.apply(q_i, k_i, v_i, k_t, v_t, grid, grid,
                                    attn_type == ATTN_AXIAL_COL, saved_i)
    elif attn_type in (ATTN_CONV_LIKE, ATTN_FULL):
        hw = conv_kernel // 2 if attn_type == ATTN_CONV_LIKE else None
        out_i = WindowAttention.apply(q_i, k_i, v_i, k_t, v_t, grid, hw,
                                      saved_i)
    else:
        raise ValueError(f"unknown attention type {attn_type!r}")
    return out_t, out_i


def join_halves(out_t: torch.Tensor, out_i: torch.Tensor) -> torch.Tensor:
    """(B, H, t, d) text and image outputs -> (B, T, H, d)."""
    return torch.cat([out_t.transpose(1, 2), out_i.transpose(1, 2)], dim=1)
