"""Forward line and window attention: CUDA kernels and plain versions.

Replaces the TPU kernels of ``dalle_tpu/ops/pallas/attention_kernels.py``:

- :func:`line_attention`: ``_line_attention_fwd`` -- softmax over
  ``[q . k_prefix^T ; causal q . k_line^T]`` against ``[v_prefix; v_line]``,
  lines of ``n`` tokens (text causal: one line, no prefix; axial_row: raster
  rows; axial_col: raster columns);
- :func:`window_attention`: ``_window_attention_fwd`` -- the text prefix plus
  the raster-causal conv window ``|dr|, |dc| <= hw`` (``conv_like``), or
  every earlier token (``hw=None``, ``full``).

Both return ``(out, lse)``: ``out`` (B, H, T, d) in q's dtype and the row
logsumexp ``lse`` (B, H, 1, T) f32 in raster token order (for axial_col the
TPU kernel keeps its statistics in column-major order; the port keeps one
order for every policy).

Numerics of the TPU kernels, kept by both versions here: scores in f32 with
the bf16 operands' products exact, masked scores filled with -1e9,
probabilities cast to the value dtype before P.V with f32 accumulation, and
the division by the f32 denominator at the end. The plain versions are the
XLA lowerings of ``dalle_tpu/models/attention.py`` (``_axial_lines``,
``_text_causal``, the dense masked path), written to also return the
logsumexp.

Operands may be strided views (unit stride along d): the model passes
(B, T, H, d) projections through ``transpose(1, 2)`` without a copy, and
the kernel reads axial_col lines with strides instead of relayout copies.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dalle_tpu_torch.ops import LAUNCHES, _build

NEG_INF = -1e9
POLICY_LINE, POLICY_CONV, POLICY_FULL = 0, 1, 2
HEAD_DIM = 64  # the kernel's compiled head dim


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _attend(s, v, s_p, v_p, dtype):
    """Joint softmax over [prefix scores || main scores] (already masked),
    against [v_p; v]: returns (out f32, lse f32)."""
    m = s.amax(dim=-1)
    if s_p is not None:
        m = torch.maximum(m, s_p.amax(dim=-1))
    e = torch.exp(s - m[..., None])
    denom = e.sum(dim=-1)
    o = e.to(dtype).float() @ v.float()
    if s_p is not None:
        e_p = torch.exp(s_p - m[..., None])
        denom = denom + e_p.sum(dim=-1)
        o = o + e_p.to(dtype).float() @ v_p.float()
    return o / denom[..., None], m + torch.log(denom)


def _col_major(x: torch.Tensor, grid: int) -> torch.Tensor:
    """Raster order <-> column-major order over the token axis (its own
    inverse): (B, H, grid*grid, ...) -> same."""
    b, h = x.shape[:2]
    rest = x.shape[3:]
    return x.reshape(b, h, grid, grid, *rest).transpose(2, 3).reshape(
        b, h, grid * grid, *rest)


def line_attention_plain(q, kl, vl, kp, vp, n: int, grid_side: int,
                         transpose: bool):
    b, h, t, d = q.shape
    scale = d ** -0.5
    if transpose:
        q, kl, vl = (_col_major(x, grid_side) for x in (q, kl, vl))
    lines = t // n
    qf, kf = (x.float().reshape(b, h, lines, n, d) for x in (q, kl))
    vf = vl.reshape(b, h, lines, n, d)
    s = (qf @ kf.transpose(-1, -2)) * scale
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, NEG_INF)
    s_p = v_p = None
    if kp is not None:
        s_p = (qf @ kp.float()[:, :, None].transpose(-1, -2)) * scale
        v_p = vp[:, :, None]
    o, lse = _attend(s, vf, s_p, v_p, vl.dtype)
    out = o.reshape(b, h, t, d).to(q.dtype)
    lse = lse.reshape(b, h, t)
    if transpose:
        out, lse = _col_major(out, grid_side), _col_major(lse, grid_side)
    return out, lse[:, :, None, :]


def window_mask(t: int, grid: int, hw: Optional[int], device) -> torch.Tensor:
    """(T, T) image-token mask of the window kernel: raster-causal, and for
    ``conv_like`` inside the (2hw+1)^2 window."""
    i = torch.arange(t, device=device)
    qi, ki = i[:, None], i[None, :]
    m = ki <= qi
    if hw is not None:
        m &= ((ki // grid - qi // grid).abs() <= hw) & \
             ((ki % grid - qi % grid).abs() <= hw)
    return m


def window_attention_plain(q, k, v, kp, vp, grid: int, hw: Optional[int]):
    b, h, t, d = q.shape
    scale = d ** -0.5
    qf = q.float()
    s = (qf @ k.float().transpose(-1, -2)) * scale
    s = torch.where(window_mask(t, grid, hw, q.device), s, NEG_INF)
    s_p = None
    if kp is not None:
        s_p = (qf @ kp.float().transpose(-1, -2)) * scale
    o, lse = _attend(s, v, s_p, vp, v.dtype)
    return o.to(q.dtype), lse[:, :, None, :]


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

class _AttnArgs(ctypes.Structure):
    """Mirror of ``struct AttnArgs`` in ``csrc/attention_fwd.cu``."""

    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("q", "k", "v", "kp", "vp", "out", "lse")]
                + [(name, ctypes.c_longlong * 3)
                   for name in ("q_s", "k_s", "v_s", "kp_s", "vp_s", "o_s")]
                + [(name, ctypes.c_int)
                   for name in ("B", "H", "T", "S", "policy", "n", "grid",
                                "hw", "transpose")]
                + [("scale", ctypes.c_float)])


def _lib():
    lib = _build.load("attention_fwd")
    if not getattr(lib, "_typed", False):
        lib.attention_fwd.argtypes = [ctypes.POINTER(_AttnArgs),
                                      ctypes.c_void_p]
        lib.attention_fwd.restype = ctypes.c_int
        lib.attention_fwd_error.argtypes = [ctypes.c_int]
        lib.attention_fwd_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operand(name: str, x: torch.Tensor, shape, device) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or x.device != device:
        raise ValueError(f"{name}: expected bf16 on {device}, got "
                         f"{x.dtype} on {x.device}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned with unit "
                         f"stride along d (strides {x.stride()})")


def _launch(counter: str, q, k, v, kp, vp, policy: int, n: int, grid: int,
            hw: int, transpose: bool):
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{counter}: the kernel takes head_dim "
                         f"{HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(f"{counter} {name}", x, (b, h, t, d), q.device)
    s = 0
    if (kp is None) != (vp is None):
        raise ValueError(f"{counter}: kp and vp come together")
    if kp is not None:
        s = kp.shape[2]
        for name, x in (("kp", kp), ("vp", vp)):
            _check_operand(f"{counter} {name}", x, (b, h, s, d), q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, 1, t), dtype=torch.float32, device=q.device)
    strides = lambda x: (ctypes.c_longlong * 3)(*x.stride()[:3])  # noqa: E731
    none3 = (ctypes.c_longlong * 3)(0, 0, 0)
    args = _AttnArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        kp=kp.data_ptr() if kp is not None else None,
        vp=vp.data_ptr() if vp is not None else None,
        out=out.data_ptr(), lse=lse.data_ptr(),
        q_s=strides(q), k_s=strides(k), v_s=strides(v),
        kp_s=strides(kp) if kp is not None else none3,
        vp_s=strides(vp) if vp is not None else none3,
        o_s=strides(out), B=b, H=h, T=t, S=s, policy=policy, n=n,
        grid=grid, hw=hw, transpose=int(transpose), scale=d ** -0.5)
    lib = _lib()
    err = lib.attention_fwd(ctypes.byref(args),
                            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{counter}: launch failed: "
                           f"{lib.attention_fwd_error(err).decode()}")
    LAUNCHES[counter] += 1
    return out, lse


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def line_attention(q, kl, vl, kp, vp, n: int, grid_side: int,
                   transpose: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused [prefix || causal line] attention (the TPU kernel's arguments).

    q/kl/vl: (B, H, T, d) line tokens in raster order; kp/vp: optional
    (B, H, S, d) prefix; ``n`` tokens per line; ``transpose`` makes raster
    columns the lines (axial_col, ``n == grid_side``). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/attention_fwd.cu``."""
    t = q.shape[2]
    if t % n or (transpose and t != grid_side * grid_side):
        raise ValueError(f"line_attention: T={t} is not whole lines of "
                         f"{n} (grid {grid_side}, transpose {transpose})")
    if q.device.type == "cpu":
        return line_attention_plain(q, kl, vl, kp, vp, n, grid_side,
                                    transpose)
    if q.device.type != "cuda":
        raise ValueError(f"line_attention: unsupported device {q.device}")
    return _launch("line_attention", q, kl, vl, kp, vp, POLICY_LINE, n,
                   grid_side, 0, transpose)


def window_attention(q, k, v, kp, vp, grid: int,
                     hw: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused [prefix || raster-window causal] attention over the image
    tokens (B, H, grid*grid, d); ``hw=None`` is plain causal ('full')."""
    t = q.shape[2]
    if t != grid * grid:
        raise ValueError(f"window_attention: T={t} != grid^2={grid * grid}")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, kp, vp, grid, hw)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    policy = POLICY_FULL if hw is None else POLICY_CONV
    return _launch("window_attention", q, k, v, kp, vp, policy, 0, grid,
                   hw or 0, False)
