"""Fused GEGLU feed-forward: CUDA kernels and the plain versions.

Replaces the TPU kernels of ``dalle_tpu/ops/pallas/geglu_kernels.py``:

- ``_ff_fwd`` (``_ff_fwd_kernel``): ``(x.Wi + bi) * gelu_tanh(x.Wg + bg)``,
  rounded to the activation dtype, then ``. Wo + bo`` with an f32
  accumulator seeded with ``bo``. On the card it runs as two hand-written
  GEMM kernels (``csrc/geglu_fwd.cu``: the dual GEMM with the gate
  epilogue, then the output GEMM); the source says why the TPU kernel's
  single pass was split there.
- ``_ff_bwd_tensors`` (``_ff_bwd_kernel``): recomputes ``h = x.Wi + bi``
  and ``g = x.Wg + bg``, forms ``dhg = dO.Wo^T`` and emits, in the
  activation dtype, ``dh = dhg * gelu(g)``, ``dg = dhg * h * gelu'(g)`` and
  ``hg = h * gelu(g)`` (``csrc/geglu_bwd.cu``, one triple-GEMM kernel).

On the card every call takes one of two routes, picked by
:func:`geglu_route` from the operands' dtype and widths before any launch:
the fast kernels above (bf16, d and K multiples of 64) or the generic
instances of ``csrc/geglu_generic.cu`` (bf16 or f32, d and K multiples of
8: one ``mma.sync`` tensor-core GEMM template with the gate, output and
backward epilogues; f32 products in three TF32 passes on the hi/lo split
of each operand, :func:`split_tf32`). Anything outside both raises.

Both fast sources are persistent, warp-specialised Hopper GEMMs built from
``csrc/gemm_sm90.cuh``: TMA loads into a shared-memory ring, ``wgmma``
products with register accumulators, and the epilogues straight from
those registers. The C entry points build their TMA tensor maps from the
pointers and shapes on every call (no cache).

:class:`GEGLUFn` is the ``custom_vjp`` of ``geglu_kernels.geglu_ff``: it
saves ``x`` and the weights, and its backward runs the tensors kernel and
then the contractions the JAX package leaves to XLA (``dx``, ``dWi``,
``dWg``, ``dWo``, the bias sums) as ``torch.matmul``/``sum``. The kernel
writes ``dh`` and ``dg`` side by side into one (M, 2K) buffer, so that
``dx = [dh | dg] . [Wi | Wg]^T`` is one GEMM: its f32 accumulator sums
both products and rounds once, as ``_vjp_bwd`` adds the two f32 products
before its single cast; and ``[dWi | dWg] = x^T . [dh | dg]`` is one GEMM.
"""

from __future__ import annotations

import ctypes

import torch

from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, _build

GELU_C = 0.044715
SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu, the formula of ``geglu_kernels._gelu``."""
    u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g)
    return 0.5 * g * (1.0 + torch.tanh(u))


def gelu_tanh_grad(g: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / dg, the formula of ``geglu_kernels._gelu_grad``."""
    u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g)
    t = torch.tanh(u)
    du = SQRT_2_OVER_PI * (1.0 + 3.0 * GELU_C * g * g)
    return 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * du


def geglu_ff_plain(x, wi, wg, wo, bi, bg, bo) -> torch.Tensor:
    """The plain version. Products of the (bf16) operands are taken in f32,
    which is exact, so they match f32 accumulation of bf16 inputs."""
    h = x.float() @ wi.float() + bi.float()
    g = x.float() @ wg.float() + bg.float()
    hg = (h * gelu_tanh(g)).to(x.dtype)
    return (bo.float() + hg.float() @ wo.float()).to(x.dtype)


def geglu_ff_bwd_plain(x, wi, wg, wo, bi, bg, dout):
    """The plain backward tensors (``geglu_kernels._ff_bwd_kernel``):
    ``(dhdg, hg)`` in x's dtype, ``dhdg`` (M, 2K) holding ``dh`` in its
    first K columns and ``dg`` in its last K, ``hg`` (M, K)."""
    h = x.float() @ wi.float() + bi.float()
    g = x.float() @ wg.float() + bg.float()
    a = gelu_tanh(g)
    dhg = dout.float() @ wo.float().t()
    dh = (dhg * a).to(x.dtype)
    dg = (dhg * h * gelu_tanh_grad(g)).to(x.dtype)
    return torch.cat([dh, dg], dim=1), (h * a).to(x.dtype)


def split_tf32(x: torch.Tensor):
    """The 3xTF32 split of an f32 tensor, as ``csrc/geglu_generic.cu`` makes
    it in registers: ``hi`` is ``x`` rounded to TF32 (10 mantissa bits: the
    low 13 bits of the f32 pattern zero) to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds, and ``lo`` is ``x - hi`` (exact in
    f32) truncated to TF32, so that ``a.b ~ a_lo.b_hi + a_hi.b_lo +
    a_hi.b_hi``. Finite inputs only. The tests use it to hold that
    arithmetic on the CPU; nothing on the model's path calls it."""
    def to_int32(bits):   # the low 32 bits of a non-negative int64
        return (bits - (bits >= 1 << 31).to(torch.int64) * (1 << 32)).to(
            torch.int32).view(torch.float32)

    def bits64(t):
        return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    hi = to_int32((bits64(x.float()) + 0x1000) & 0xFFFFE000)
    return hi, to_int32(bits64(x.float() - hi) & 0xFFFFE000)


FAST_ALIGN = 64     # d and K of the fast kernels: multiples of this
GENERIC_ALIGN = 8   # d and K of the generic instances: multiples of this
# operand dtypes of the generic instances (DTYPE_* of geglu_generic.cu)
GENERIC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def geglu_route(dtype: torch.dtype, d: int, k: int) -> str:
    """The route of CUDA operands of ``dtype`` with model width ``d`` and
    FF width ``k``: ``"fast"`` (``csrc/geglu_fwd.cu``/``geglu_bwd.cu``:
    bf16, d and K multiples of 64) or ``"generic"``
    (``csrc/geglu_generic.cu``: bf16 or f32, d and K multiples of 8).
    Raises ``ValueError`` naming the missing instance for anything else."""
    if dtype == torch.bfloat16 and not (d % FAST_ALIGN or k % FAST_ALIGN):
        return "fast"
    if dtype in GENERIC_DTYPES and not (d % GENERIC_ALIGN
                                         or k % GENERIC_ALIGN):
        return "generic"
    raise ValueError(
        f"geglu: no kernel instance for {dtype} with d={d}, K={k} (fast: "
        f"bfloat16 with d and K multiples of {FAST_ALIGN}; generic: "
        f"bfloat16 or float32 with d and K multiples of {GENERIC_ALIGN})")


_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(_I)
# argument types of each library's entry points (pointers, ints, stream)
_SIGNATURES = {
    "geglu_fwd": {"geglu_gate_fwd": [_P] * 6 + [_I] * 3 + [_P],
                  "geglu_out_fwd": [_P] * 4 + [_I] * 3 + [_P],
                  "geglu_fwd_resources": [_I, _IP]},
    "geglu_bwd": {"geglu_bwd_tensors": [_P] * 9 + [_I] * 3 + [_P],
                  "geglu_bwd_resources": [_IP]},
    "geglu_generic": {"geglu_generic_fwd": [_P] * 9 + [_I] * 4 + [_P],
                      "geglu_generic_bwd": [_P] * 9 + [_I] * 4 + [_P]},
}


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        err = getattr(lib, f"{name}_error")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def kernel_resources() -> dict:
    """Registers, static and dynamic shared memory (bytes a block) and local
    (spill) bytes a thread of the three GEGLU kernels, keyed like
    ``geglu_fwd_kernel<1>`` (1: the gate GEMM, 0: the output GEMM) and
    ``geglu_bwd_kernel``, as the CUDA runtime reports them. Builds and loads
    both libraries; needs a GPU."""
    keys = ("registers", "smem_static", "smem_dynamic", "local_bytes")
    fwd = _lib("geglu_fwd").geglu_fwd_resources
    bwd = _lib("geglu_bwd").geglu_bwd_resources
    calls = [(f"geglu_fwd_kernel<{gate}>", lambda buf, g=gate: fwd(g, buf))
             for gate in (1, 0)] + [("geglu_bwd_kernel", bwd)]
    out = {}
    for name, call in calls:
        buf = (_I * 4)()
        if call(buf) != 0:
            raise RuntimeError(f"{name}: cudaFuncGetAttributes failed")
        out[name] = dict(zip(keys, buf))
    return out


def _check(lib, name: str, err: int, what: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error")(err).decode()
        raise RuntimeError(f"{what}: launch failed: {msg}")


def _check_operands(what: str, x, shapes) -> str:
    """Checks the operands against ``x`` and returns their route."""
    m, d = x.shape
    k = shapes["wi"][1][1]
    route = geglu_route(x.dtype, d, k)
    for name, (t, shape) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be a contiguous 16-byte "
                             f"aligned {x.dtype} {shape} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return route


def _generic(what: str, fn: str, x, ptrs, m: int, d: int, k: int) -> None:
    """Launches the generic entry point ``fn`` and counts the call."""
    lib = _lib("geglu_generic")
    _check(lib, "geglu_generic", getattr(lib, fn)(
        *ptrs, m, d, k, GENERIC_DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream), fn)
    GENERIC_LAUNCHES[what] += 1


def geglu_ff(x, wi, wg, wo, bi, bg, bo) -> torch.Tensor:
    """x (M, d); wi/wg (d, K); wo (K, d); bi/bg (K,); bo (d,). Returns
    (M, d) in x's dtype. CPU tensors take the plain version; CUDA tensors
    (contiguous, of x's dtype) launch the two kernels of
    :func:`geglu_route`'s route."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, wi, wg, wo, bi, bg, bo)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: unsupported device {x.device}")
    m, d = x.shape
    k = wi.shape[1]
    route = _check_operands("geglu_ff", x, {
        "x": (x, (m, d)), "wi": (wi, (d, k)), "wg": (wg, (d, k)),
        "wo": (wo, (k, d)), "bi": (bi, (k,)), "bg": (bg, (k,)),
        "bo": (bo, (d,))})
    hg = torch.empty((m, k), dtype=x.dtype, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    if route == "generic":
        _generic("geglu_ff", "geglu_generic_fwd", x,
                 [t.data_ptr() for t in (x, wi, wg, wo, bi, bg, bo, hg, out)],
                 m, d, k)
    else:
        lib = _lib("geglu_fwd")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib, "geglu_fwd",
               lib.geglu_gate_fwd(x.data_ptr(), wi.data_ptr(), wg.data_ptr(),
                                  bi.data_ptr(), bg.data_ptr(), hg.data_ptr(),
                                  m, d, k, stream), "geglu_gate_fwd")
        _check(lib, "geglu_fwd",
               lib.geglu_out_fwd(hg.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                 out.data_ptr(), m, k, d, stream),
               "geglu_out_fwd")
    LAUNCHES["geglu_ff"] += 1
    return out


def geglu_ff_bwd(x, wi, wg, wo, bi, bg, dout):
    """The backward tensors of :func:`geglu_ff` for the cotangent ``dout``
    (M, d): ``(dhdg, hg)`` as :func:`geglu_ff_bwd_plain` returns them. CPU
    tensors take the plain version; CUDA tensors (contiguous, of x's dtype)
    launch the backward kernel of :func:`geglu_route`'s route."""
    if x.device.type == "cpu":
        return geglu_ff_bwd_plain(x, wi, wg, wo, bi, bg, dout)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff_bwd: unsupported device {x.device}")
    m, d = x.shape
    k = wi.shape[1]
    route = _check_operands("geglu_ff_bwd", x, {
        "x": (x, (m, d)), "wi": (wi, (d, k)), "wg": (wg, (d, k)),
        "wo": (wo, (k, d)), "bi": (bi, (k,)), "bg": (bg, (k,)),
        "dout": (dout, (m, d))})
    dhdg = torch.empty((m, 2 * k), dtype=x.dtype, device=x.device)
    hg = torch.empty((m, k), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, wi, wg, wo, bi, bg, dout, dhdg, hg)]
    if route == "generic":
        _generic("geglu_ff_bwd", "geglu_generic_bwd", x, ptrs, m, d, k)
    else:
        lib = _lib("geglu_bwd")
        _check(lib, "geglu_bwd", lib.geglu_bwd_tensors(
            *ptrs, m, d, k, torch.cuda.current_stream(x.device).cuda_stream),
            "geglu_bwd_tensors")
    LAUNCHES["geglu_ff_bwd"] += 1
    return dhdg, hg


class GEGLUFn(torch.autograd.Function):
    """:func:`geglu_ff` with the tensors kernel plus plain contractions as
    its gradient (``geglu_kernels.geglu_ff``'s ``custom_vjp``). Residuals:
    ``x`` and the weights; the (M, K) intermediates are recomputed."""

    @staticmethod
    def forward(ctx, x, wi, wg, wo, bi, bg, bo):
        ctx.save_for_backward(x, wi, wg, wo, bi, bg)
        ctx.bo_dtype = bo.dtype
        return geglu_ff(x, wi, wg, wo, bi, bg, bo)

    @staticmethod
    def backward(ctx, dout):
        x, wi, wg, wo, bi, bg = ctx.saved_tensors
        dout = dout.contiguous()
        dhdg, hg = geglu_ff_bwd(x, wi, wg, wo, bi, bg, dout)
        k = wi.shape[1]
        # the contractions the JAX package leaves to XLA: each GEMM takes
        # bf16 operands with an f32 accumulator and rounds its result once
        dx = torch.matmul(dhdg, torch.cat([wi, wg], dim=1).t())
        dw = torch.matmul(x.t(), dhdg)
        dwo = torch.matmul(hg.t(), dout)
        db = dhdg.float().sum(dim=0)
        return (dx, dw[:, :k].to(wi.dtype), dw[:, k:].to(wg.dtype),
                dwo.to(wo.dtype), db[:k].to(bi.dtype), db[k:].to(bg.dtype),
                dout.float().sum(dim=0).to(ctx.bo_dtype))
