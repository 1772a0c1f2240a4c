"""LayerNorm forward and backward: a Triton forward, a CUDA backward, and
their plain versions.

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

- Forward (Triton): one program holds one whole row in registers, forms
  both statistics from that one read and writes the row.
- Backward (``csrc/layer_norm_bwd.cu``): one warp a row with shuffle
  reductions, a persistent grid whose warps walk rows held in registers
  (the next row loading while this one computes), the ``dscale``/``dbias``
  partials summed per block in a fixed order and then over blocks by a
  second kernel: no atomics, so the result is bitwise the same on every
  run. The source says why this design. Its
  domain: bf16 or f32 ``x``/``dy`` with 16-byte aligned rows and d a
  multiple of 8 up to ``BWD_MAX_D``; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from dalle_tpu_torch.ops import LAUNCHES, _build

BWD_MAX_D = 8192    # widest row of the backward kernel (MAX_D in its source)
# x dtypes of the backward kernel (DTYPE_* of layer_norm_bwd.cu)
BWD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_KERNELS = None
_GRIDS = {}         # (device, dtype, M, d) -> blocks of the backward row pass


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


def _build_fwd():
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

    _KERNELS = (_ln_fwd, triton)
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
    kernel, triton = _build_fwd()
    y = torch.empty((m, d), dtype=x.dtype, device=x.device)
    block = triton.next_power_of_2(d)
    kernel[(m,)](x, scale, bias, y, x.stride(0), y.stride(0), d, eps,
                 BLOCK=block, num_warps=4 if block <= 2048 else 8)
    LAUNCHES["layer_norm"] += 1
    return y


class _LnBwdArgs(ctypes.Structure):
    """Mirror of ``struct LnBwdArgs`` in ``csrc/layer_norm_bwd.cu``."""

    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("x", "dy", "scale", "dx", "parts", "sums")]
                + [("x_s", ctypes.c_longlong), ("dy_s", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in ("M", "d", "scale_bf16")]
                + [("eps", ctypes.c_float)])


def _bwd_lib():
    lib = _build.load("layer_norm_bwd")
    if not getattr(lib, "_typed", False):
        lib.layer_norm_bwd_grid.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.layer_norm_bwd.argtypes = [ctypes.POINTER(_LnBwdArgs),
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.layer_norm_bwd_grid.restype = lib.layer_norm_bwd.restype = \
            ctypes.c_int
        lib.layer_norm_bwd_error.argtypes = [ctypes.c_int]
        lib.layer_norm_bwd_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_bwd(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.layer_norm_bwd_error(err).decode()
        raise RuntimeError(f"{what}: launch failed: {msg}")


def _rows_ready(t: torch.Tensor) -> bool:
    """Whether the rows of ``t`` (M, d) start on 16-byte boundaries, as the
    backward kernel's 16-byte copies need."""
    return (t.stride(1) == 1 and (t.stride(0) * t.element_size()) % 16 == 0
            and t.data_ptr() % 16 == 0)


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-6):
    """``(dx, dscale, dbias)`` of :func:`layer_norm` for the cotangent
    ``dy`` (M, d): dx in x's dtype, the parameter sums in f32. CPU tensors
    take the plain version; CUDA tensors launch ``csrc/layer_norm_bwd.cu``
    (its row pass and its partial sum)."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: unsupported device {x.device}")
    _check_rows("layer_norm_bwd x", x)
    _check_rows("layer_norm_bwd dy", dy)
    m, d = x.shape
    if (dy.shape != x.shape or dy.device != x.device
            or dy.dtype != x.dtype):
        raise ValueError(f"layer_norm_bwd: dy {dy.dtype} {tuple(dy.shape)} "
                         f"on {dy.device} does not match x {x.dtype} "
                         f"{tuple(x.shape)}")
    if d % 8 or d > BWD_MAX_D:
        raise ValueError(f"layer_norm_bwd: d={d} is not a multiple of 8 up "
                         f"to {BWD_MAX_D}")
    for name, t in (("x", x), ("dy", dy)):
        if not _rows_ready(t):
            raise ValueError(f"layer_norm_bwd: {name} rows must start on "
                             f"16-byte boundaries (strides {t.stride()})")
    _check_param("layer_norm_bwd", "scale", scale, d, x.device)
    lib = _bwd_lib()
    key = (x.device, x.dtype, m, d)
    grid = _GRIDS.get(key)
    if grid is None:
        out = ctypes.c_int()
        _check_bwd(lib, lib.layer_norm_bwd_grid(BWD_DTYPES[x.dtype], m, d,
                                                ctypes.byref(out)),
                   "layer_norm_bwd_grid")
        grid = _GRIDS[key] = out.value
    dx = torch.empty((m, d), dtype=x.dtype, device=x.device)
    parts = torch.empty((2, grid, d), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, d), dtype=torch.float32, device=x.device)
    args = _LnBwdArgs(
        x=x.data_ptr(), dy=dy.data_ptr(), scale=scale.data_ptr(),
        dx=dx.data_ptr(), parts=parts.data_ptr(), sums=sums.data_ptr(),
        x_s=x.stride(0), dy_s=dy.stride(0), M=m, d=d,
        scale_bf16=int(scale.dtype == torch.bfloat16), eps=eps)
    _check_bwd(lib, lib.layer_norm_bwd(
        ctypes.byref(args), BWD_DTYPES[x.dtype], grid,
        torch.cuda.current_stream(x.device).cuda_stream), "layer_norm_bwd")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, sums[0], sums[1]


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
        if x.is_cuda:
            # rows as the kernel's 16-byte copies take them (a copy of a
            # view whose rows start elsewhere)
            x, dy = (t if _rows_ready(t)
                     else t.clone(memory_format=torch.contiguous_format)
                     for t in (x, dy))
        dx, dscale, dbias = layer_norm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None
