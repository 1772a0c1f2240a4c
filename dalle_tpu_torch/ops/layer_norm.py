"""LayerNorm forward and backward: Triton kernels and their plain versions.

Replaces the TPU kernels of ``dalle_tpu/ops/pallas/ln_kernels.py``:
``_fwd_call`` (``_ln_fwd_kernel``) and ``_bwd_call`` (``_ln_bwd_kernel``
plus the XLA sum of its per-tile partials). Numerics are the JAX
package's: statistics in f32 from the input, fast variance
``E[x^2] - E[x]^2`` clipped at 0, ``eps`` inside the rsqrt, the affine in
f32, the output in the input's dtype. The backward recomputes the
statistics from ``x``, so :class:`LayerNormFn` saves only ``{x, scale}``
(as the TPU kernel's ``_vjp_fwd`` does), and returns ``dx`` in x's dtype
and ``dscale``/``dbias`` summed in f32 and cast to the parameters' dtype.

On the card both directions are bound by memory bandwidth (at the
flagship, B=4: 5120 rows of 1024 bf16, about 21 MB each way), with a
handful of f32 operations per element and no tensor-core work.

- Forward: one program holds one whole row in registers, forms both
  statistics from that one read and writes the row.
- Backward: one pass over ``x`` and ``dy``. A program walks ``ROWS_BWD``
  rows, writes each row's ``dx`` and keeps the ``dscale``/``dbias``
  partials of its rows in f32 registers, then writes them as one row of a
  (programs, d) f32 buffer. A second kernel sums that buffer over programs
  in a fixed order, one block of 32 columns per program, in (64, 32)
  tiles: no atomics, so the result is bitwise the same on every run.
"""

from __future__ import annotations

import torch

from dalle_tpu_torch.ops import LAUNCHES

ROWS_BWD = 16       # rows per program of the backward row pass
SUM_BLOCK = 32      # columns per program of the partial sum
SUM_CHUNK = 64      # partial rows per tile of the partial sum

_KERNELS = None


def _stats(xf: torch.Tensor, eps: float):
    """f32 row statistics, fast variance clipped at 0 (as
    ``ln_kernels._stats``)."""
    mean = xf.mean(dim=-1, keepdim=True)
    msq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(msq - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The plain version: LayerNorm over the last axis of ``x`` (M, d)."""
    xf = x.float()
    mean, rstd = _stats(xf, eps)
    y = (xf - mean) * rstd * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         dy: torch.Tensor, eps: float = 1e-6):
    """The plain backward (``ln_kernels._ln_bwd_kernel``): ``(dx, dscale,
    dbias)`` with ``dx`` in x's dtype and the two sums over rows in f32."""
    xf, dyf = x.float(), dy.float()
    mean, rstd = _stats(xf, eps)
    xhat = (xf - mean) * rstd
    dyg = dyf * scale.float()
    c1 = (dyg * xhat).mean(dim=-1, keepdim=True)
    c2 = dyg.mean(dim=-1, keepdim=True)
    dx = (rstd * (dyg - xhat * c1 - c2)).to(x.dtype)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _build():
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd(x_ptr, g_ptr, b_ptr, y_ptr, stride_x, stride_y, d, eps,
                BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / d
        msq = tl.sum(x * x, axis=0) / d
        var = tl.maximum(msq - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt_rn(var + eps)
        g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean) * rstd * g + b
        tl.store(y_ptr + row * stride_y + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _ln_bwd(x_ptr, g_ptr, dy_ptr, dx_ptr, pg_ptr, pb_ptr, stride_x,
                stride_dy, stride_dx, m, d, eps, ROWS: tl.constexpr,
                BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        acc_g = tl.zeros([BLOCK], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK], dtype=tl.float32)
        for r in range(ROWS):
            row = pid * ROWS + r
            ok = mask & (row < m)
            # rows past m and columns past d load zeros: their dy is 0, so
            # they add nothing to the partials
            x = tl.load(x_ptr + row * stride_x + cols, mask=ok,
                        other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + row * stride_dy + cols, mask=ok,
                         other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / d
            msq = tl.sum(x * x, axis=0) / d
            var = tl.maximum(msq - mean * mean, 0.0)
            rstd = 1.0 / tl.sqrt_rn(var + eps)
            xhat = (x - mean) * rstd
            dyg = dy * g
            c1 = tl.sum(dyg * xhat, axis=0) / d
            c2 = tl.sum(dyg, axis=0) / d
            dx = rstd * (dyg - xhat * c1 - c2)
            tl.store(dx_ptr + row * stride_dx + cols,
                     dx.to(dx_ptr.dtype.element_ty), mask=ok)
            acc_g += dy * xhat
            acc_b += dy
        tl.store(pg_ptr + pid * d + cols, acc_g, mask=mask)
        tl.store(pb_ptr + pid * d + cols, acc_b, mask=mask)

    @triton.jit
    def _ln_bwd_sum(pg_ptr, pb_ptr, dg_ptr, db_ptr, n, d,
                    BLOCK: tl.constexpr, CHUNK: tl.constexpr):
        cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        rows = tl.arange(0, CHUNK)
        acc_g = tl.zeros([BLOCK], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK], dtype=tl.float32)
        # (CHUNK, BLOCK) tiles in a fixed order, each summed by a fixed
        # tree: bitwise reproducible
        for i in range(0, n, CHUNK):
            r = i + rows
            mask = (r < n)[:, None] & (cols < d)[None, :]
            offs = r[:, None] * d + cols[None, :]
            acc_g += tl.sum(tl.load(pg_ptr + offs, mask=mask, other=0.0), 0)
            acc_b += tl.sum(tl.load(pb_ptr + offs, mask=mask, other=0.0), 0)
        tl.store(dg_ptr + cols, acc_g, mask=cols < d)
        tl.store(db_ptr + cols, acc_b, mask=cols < d)

    _KERNELS = (_ln_fwd, _ln_bwd, _ln_bwd_sum, triton)
    return _KERNELS


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (M, d), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if x.stride(1) != 1:
        raise ValueError(f"{name}: rows must have unit column stride")


def _check_param(what: str, name: str, p: torch.Tensor, d: int,
                 device) -> None:
    if (p.shape != (d,) or p.device != device or not p.is_contiguous()
            or p.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{what}: {name} must be a contiguous ({d},) "
                         f"bf16/f32 tensor on {device}")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (M, d) with (d,) ``scale`` and
    ``bias``. CPU tensors take the plain version; CUDA tensors launch the
    Triton kernel (bf16 or f32 ``x``, rows with unit column stride)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    _check_rows("layer_norm x", x)
    m, d = x.shape
    for name, p in (("scale", scale), ("bias", bias)):
        _check_param("layer_norm", name, p, d, x.device)
    kernel, _, _, triton = _build()
    y = torch.empty((m, d), dtype=x.dtype, device=x.device)
    block = triton.next_power_of_2(d)
    kernel[(m,)](x, scale, bias, y, x.stride(0), y.stride(0), d, eps,
                 BLOCK=block, num_warps=4 if block <= 2048 else 8)
    LAUNCHES["layer_norm"] += 1
    return y


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-6):
    """``(dx, dscale, dbias)`` of :func:`layer_norm` for the cotangent
    ``dy`` (M, d): dx in x's dtype, the parameter sums in f32. CPU tensors
    take the plain version; CUDA tensors launch the two Triton kernels."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: unsupported device {x.device}")
    _check_rows("layer_norm_bwd x", x)
    _check_rows("layer_norm_bwd dy", dy)
    m, d = x.shape
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} does not match x {tuple(x.shape)}")
    _check_param("layer_norm_bwd", "scale", scale, d, x.device)
    _, kernel, reduce, triton = _build()
    n = -(-m // ROWS_BWD)
    dx = torch.empty((m, d), dtype=x.dtype, device=x.device)
    parts = torch.empty((2, n, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    dbias = torch.empty(d, dtype=torch.float32, device=x.device)
    block = triton.next_power_of_2(d)
    kernel[(n,)](x, scale, dy, dx, parts[0], parts[1], x.stride(0),
                 dy.stride(0), dx.stride(0), m, d, eps, ROWS=ROWS_BWD,
                 BLOCK=block, num_warps=4 if block <= 2048 else 8)
    reduce[(-(-d // SUM_BLOCK),)](parts[0], parts[1], dscale, dbias, n, d,
                                  BLOCK=SUM_BLOCK, CHUNK=SUM_CHUNK,
                                  num_warps=4)
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dscale, dbias


class LayerNormFn(torch.autograd.Function):
    """:func:`layer_norm` with :func:`layer_norm_bwd` as its gradient
    (``ln_kernels.layer_norm``'s ``custom_vjp``). Residuals: ``{x,
    scale}``; ``dscale``/``dbias`` come back in the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        ctx.bias_dtype = bias.dtype
        return layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, dscale, dbias = layer_norm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None
