"""Fused GEGLU feed-forward forward: CUDA kernels and the plain version.

Replaces the TPU kernel ``dalle_tpu/ops/pallas/geglu_kernels.py``
``_ff_fwd`` (``_ff_fwd_kernel``): ``(x.Wi + bi) * gelu_tanh(x.Wg + bg)``,
rounded to the activation dtype, then ``. Wo + bo`` with an f32
accumulator seeded with ``bo``. On the card it runs as two hand-written
GEMM kernels (``csrc/geglu_fwd.cu``: the dual GEMM with the gate epilogue,
then the output GEMM); the source says why the TPU kernel's single pass
was split there.
"""

from __future__ import annotations

import ctypes

import torch

from dalle_tpu_torch.ops import LAUNCHES, _build

GELU_C = 0.044715
SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu, the formula of ``geglu_kernels._gelu``."""
    u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g)
    return 0.5 * g * (1.0 + torch.tanh(u))


def geglu_ff_plain(x, wi, wg, wo, bi, bg, bo) -> torch.Tensor:
    """The plain version. Products of the (bf16) operands are taken in f32,
    which is exact, so they match f32 accumulation of bf16 inputs."""
    h = x.float() @ wi.float() + bi.float()
    g = x.float() @ wg.float() + bg.float()
    hg = (h * gelu_tanh(g)).to(x.dtype)
    return (bo.float() + hg.float() @ wo.float()).to(x.dtype)


def _lib():
    lib = _build.load("geglu_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.geglu_gate_fwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.geglu_gate_fwd.restype = i
        lib.geglu_out_fwd.argtypes = [p, p, p, p, i, i, i, p]
        lib.geglu_out_fwd.restype = i
        lib.geglu_fwd_error.argtypes = [i]
        lib.geglu_fwd_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed: "
                           f"{lib.geglu_fwd_error(err).decode()}")


def geglu_ff(x, wi, wg, wo, bi, bg, bo) -> torch.Tensor:
    """x (M, d); wi/wg (d, K); wo (K, d); bi/bg (K,); bo (d,). Returns
    (M, d) in x's dtype. CPU tensors take the plain version; CUDA tensors
    launch the two kernels (bf16, contiguous, d % 64 == 0, K % 64 == 0)."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, wi, wg, wo, bi, bg, bo)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: unsupported device {x.device}")
    m, d = x.shape
    k = wi.shape[1]
    shapes = {"x": (x, (m, d)), "wi": (wi, (d, k)), "wg": (wg, (d, k)),
              "wo": (wo, (k, d)), "bi": (bi, (k,)), "bg": (bg, (k,)),
              "bo": (bo, (d,))}
    for name, (t, shape) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"geglu_ff: {name} must be a contiguous, "
                             f"16-byte aligned bf16 {shape} tensor on "
                             f"{x.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if d % 64 or k % 64:
        raise ValueError(f"geglu_ff: d={d} and K={k} must be multiples of 64")
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hg = torch.empty((m, k), dtype=x.dtype, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    _check(lib, lib.geglu_gate_fwd(x.data_ptr(), wi.data_ptr(), wg.data_ptr(),
                                   bi.data_ptr(), bg.data_ptr(), hg.data_ptr(),
                                   m, d, k, stream), "geglu_gate_fwd")
    _check(lib, lib.geglu_out_fwd(hg.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                  out.data_ptr(), m, k, d, stream),
           "geglu_out_fwd")
    LAUNCHES["geglu_ff"] += 1
    return out
