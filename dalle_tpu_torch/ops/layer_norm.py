"""LayerNorm forward: a Triton kernel and its plain PyTorch version.

Replaces the TPU kernel ``dalle_tpu/ops/pallas/ln_kernels.py`` ``_fwd_call``
(``_ln_fwd_kernel``). Numerics are the JAX package's: statistics in f32 from
the input, fast variance ``E[x^2] - E[x]^2`` clipped at 0, ``eps`` inside the
rsqrt, the affine in f32, the output in the input's dtype.

On the card the kernel is bound by memory bandwidth: it reads each row once
and writes it once (at the flagship, B=4: 5120 rows of 1024 bf16, about 21
MB), with a handful of f32 operations per element and no tensor-core work.
One program holds one whole row in registers, forms both statistics from
that one read and writes the row, so no byte moves twice.
"""

from __future__ import annotations

import torch

from dalle_tpu_torch.ops import LAUNCHES

_KERNEL = None


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


def _build():
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
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

    _KERNEL = (_ln_fwd, triton)
    return _KERNEL


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (M, d) with (d,) ``scale`` and
    ``bias``. CPU tensors take the plain version; CUDA tensors launch the
    Triton kernel (bf16 or f32 ``x``, rows with unit column stride)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"layer_norm: x must be (M, d), got {tuple(x.shape)}")
    m, d = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer_norm: unsupported dtype {x.dtype}")
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.shape != (d,) or p.device != x.device or not p.is_contiguous()
                or p.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"layer_norm: {name} must be a contiguous ({d},) "
                             f"bf16/f32 tensor on {x.device}")
    if x.stride(1) != 1:
        raise ValueError("layer_norm: x rows must have unit column stride")
    kernel, triton = _build()
    y = torch.empty((m, d), dtype=x.dtype, device=x.device)
    block = triton.next_power_of_2(d)
    kernel[(m,)](x, scale, bias, y, x.stride(0), y.stride(0), d, eps,
                 BLOCK=block, num_warps=4 if block <= 2048 else 8)
    LAUNCHES["layer_norm"] += 1
    return y
