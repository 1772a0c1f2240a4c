"""Line and window attention, forward and backward: CUDA kernels and plain
versions.

Replaces the TPU kernels of ``dalle_tpu/ops/pallas/attention_kernels.py``:

- :func:`line_attention`: ``_line_attention_fwd`` -- softmax over
  ``[q . k_prefix^T ; causal q . k_line^T]`` against ``[v_prefix; v_line]``,
  lines of ``n`` tokens (text causal: one line, no prefix; axial_row: raster
  rows; axial_col: raster columns);
- :func:`window_attention`: ``_window_attention_fwd`` -- the text prefix plus
  the raster-causal conv window ``|dr|, |dc| <= hw`` (``conv_like``), or
  every earlier token (``hw=None``, ``full``);
- :func:`line_attention_bwd` / :func:`window_attention_bwd`:
  ``_line_attention_bwd`` / ``_window_attention_bwd`` -- ``(dq, dk, dv,
  dkp, dvp)`` from the forward's output and logsumexp
  (``csrc/attention_bwd.cu``, a query-major dq pass, a key-major dk/dv
  pass over the main keys and, with a prefix, the prefix's dk/dv in
  4-block clusters; no atomics).

On the card every call takes one of two routes, picked by
:func:`attention_route` from q's dtype and head_dim before any launch: the
fast kernels (``csrc/attention_fwd.cu``, ``csrc/attention_bwd.cu``: bf16
with head_dim 64, the flagship's) or the generic instances
(``csrc/attention_generic.cu``: bf16 or f32 with head_dim 16, 32, 64 or
128, as the TPU kernels take any). Anything outside both raises.

The forwards return ``(out, lse)``: ``out`` (B, H, T, d) in q's dtype and
the row logsumexp ``lse`` (B, H, 1, T) f32 in raster token order (for
axial_col the TPU kernel keeps its statistics in column-major order; the
port keeps one order for every policy). :class:`LineAttention` and
:class:`WindowAttention` are the ``custom_vjp`` pairs: they save q, k, v,
the prefix, ``out`` and ``lse`` (the residuals of the TPU kernels'
``_vjp_fwd``), so backward never runs the forward kernel again.

Numerics of the TPU kernels, kept by both versions here: scores in f32 with
the bf16 operands' products exact, masked scores filled with -1e9,
probabilities cast to the value dtype before P.V with f32 accumulation, and
the division by the f32 denominator at the end. Backward: P = exp(s - lse)
in f32, dd = rowsum(dO . O), dS = P (dP - dd), dS cast to the operand dtype
before its products, dq and dk scaled at the end, dv = P^T dO with P in f32.
The plain versions are the XLA lowerings of ``dalle_tpu/models/attention.py``
(``_axial_lines``, ``_text_causal``, the dense masked path), written to also
return the logsumexp, and the TPU backward kernels' formulas written out.

Operands may be strided views (unit stride along d): the model passes
(B, T, H, d) projections through ``transpose(1, 2)`` without a copy, and
the kernels read axial_col lines with strides instead of relayout copies.
The backward wrappers write every gradient into (B, T, H, d) storage and
return its (B, H, T, d) view, so the model's transposes chain without
copies; a cotangent that arrives with strides the kernel does not take is
copied once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, _build

NEG_INF = -1e9
POLICY_LINE, POLICY_CONV, POLICY_FULL = 0, 1, 2
FAST_HEAD_DIM = 64                     # the fast kernels' compiled head dim
GENERIC_HEAD_DIMS = (16, 32, 64, 128)  # csrc/attention_generic.cu's instances
# operand dtypes of the generic instances (DTYPE_* of attention_generic.cu)
GENERIC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of CUDA operands of ``dtype`` and ``head_dim``: ``"fast"``
    (``csrc/attention_fwd.cu``/``attention_bwd.cu``: bf16 with head_dim
    64) or ``"generic"`` (``csrc/attention_generic.cu``: bf16 or f32 with
    head_dim 16, 32, 64 or 128). Raises ``ValueError`` naming the missing
    instance for anything else."""
    if dtype == torch.bfloat16 and head_dim == FAST_HEAD_DIM:
        return "fast"
    if dtype in GENERIC_DTYPES and head_dim in GENERIC_HEAD_DIMS:
        return "generic"
    raise ValueError(
        f"attention: no kernel instance for {dtype} with head_dim "
        f"{head_dim} (fast: bfloat16 with head_dim {FAST_HEAD_DIM}; generic: "
        f"bfloat16 or float32 with head_dim in {GENERIC_HEAD_DIMS})")


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


def _grads(qf, kf, vf, gf, dd, s, lse, op_dtype):
    """Backward through masked scores ``s`` (already scaled and filled):
    ``(dq, dk, dv)`` f32 before the final scaling, P in f32 for dv."""
    p = torch.exp(s - lse[..., None])
    dp = gf.to(op_dtype).float() @ vf.transpose(-1, -2)
    ds = (p * (dp - dd)).to(op_dtype).float()
    return ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ gf


def _prefix_grads(qf, kp, vp, gf, dd, lse, scale, op_dtype):
    """``attention_kernels._prefix_grads``: the prefix's share of dq and
    (dkp, dvp), over all of a (b, h)'s queries at once (f32, unscaled dq)."""
    kpf, vpf = kp.float(), vp.float()
    s_p = (qf @ kpf.transpose(-1, -2)) * scale
    return _grads(qf, kpf, vpf, gf, dd, s_p, lse, op_dtype)


def line_attention_bwd_plain(q, kl, vl, kp, vp, out, lse, dout, n: int,
                             grid_side: int, transpose: bool):
    """The plain backward of :func:`line_attention_plain`
    (``attention_kernels._bwd_kernel``): ``(dq, dk, dv, dkp, dvp)`` in q's
    dtype, ``dkp``/``dvp`` None without a prefix."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    lse = lse[:, :, 0, :]
    if transpose:
        q, kl, vl, out, dout = (_col_major(x, grid_side)
                                for x in (q, kl, vl, out, dout))
        lse = _col_major(lse, grid_side)
    qf, kf, vf, gf = (x.float() for x in (q, kl, vl, dout))
    dd = (gf * out.float()).sum(dim=-1, keepdim=True)
    lines = t // n
    per_line = lambda x: x.reshape(b, h, lines, n, -1)  # noqa: E731
    s = (per_line(qf) @ per_line(kf).transpose(-1, -2)) * scale
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, NEG_INF)
    dq, dk, dv = (x.reshape(b, h, t, d) for x in _grads(
        per_line(qf), per_line(kf), per_line(vf), per_line(gf), per_line(dd),
        s, lse.reshape(b, h, lines, n), q.dtype))
    dkp = dvp = None
    if kp is not None:
        dq_p, dkp, dvp = _prefix_grads(qf, kp, vp, gf, dd, lse, scale,
                                       q.dtype)
        dq = dq + dq_p
        dkp, dvp = (dkp * scale).to(q.dtype), dvp.to(q.dtype)
    dq, dk, dv = ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
                  dv.to(q.dtype))
    if transpose:
        dq, dk, dv = (_col_major(x, grid_side) for x in (dq, dk, dv))
    return dq, dk, dv, dkp, dvp


def window_attention_bwd_plain(q, k, v, kp, vp, out, lse, dout, grid: int,
                               hw: Optional[int]):
    """The plain backward of :func:`window_attention_plain`
    (``attention_kernels._win_bwd_kernel``)."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    lse = lse[:, :, 0, :]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    dd = (gf * out.float()).sum(dim=-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)) * scale
    s = torch.where(window_mask(t, grid, hw, q.device), s, NEG_INF)
    dq, dk, dv = _grads(qf, kf, vf, gf, dd, s, lse, q.dtype)
    dkp = dvp = None
    if kp is not None:
        dq_p, dkp, dvp = _prefix_grads(qf, kp, vp, gf, dd, lse, scale,
                                       q.dtype)
        dq = dq + dq_p
        dkp, dvp = (dkp * scale).to(q.dtype), dvp.to(q.dtype)
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype), dkp, dvp)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

class _AttnArgs(ctypes.Structure):
    """Mirror of ``struct AttnArgs`` in ``csrc/attention_common.cuh``."""

    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("q", "k", "v", "kp", "vp", "out", "lse")]
                + [(name, ctypes.c_longlong * 3)
                   for name in ("q_s", "k_s", "v_s", "kp_s", "vp_s", "o_s")]
                + [(name, ctypes.c_int)
                   for name in ("B", "H", "T", "S", "policy", "n", "grid",
                                "hw", "transpose")]
                + [("scale", ctypes.c_float)])


class _AttnBwdArgs(ctypes.Structure):
    """Mirror of ``struct AttnBwdArgs`` in ``csrc/attention_common.cuh``."""

    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("q", "k", "v", "kp", "vp", "o", "dout", "lse",
                              "dd", "dq", "dk", "dv", "dkp", "dvp")]
                + [(name, ctypes.c_longlong * 3)
                   for name in ("q_s", "k_s", "v_s", "kp_s", "vp_s", "o_s",
                                "do_s", "dq_s", "dk_s", "dv_s", "dkp_s",
                                "dvp_s")]
                + [(name, ctypes.c_int)
                   for name in ("B", "H", "T", "S", "policy", "n", "grid",
                                "hw", "transpose")]
                + [("scale", ctypes.c_float)])


_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# argument types of each library's entry points
_SIGNATURES = {
    "attention_fwd": {"attention_fwd": [ctypes.POINTER(_AttnArgs), _P],
                      "attention_fwd_resources": [_I, _IP]},
    "attention_bwd": {"attention_bwd": [ctypes.POINTER(_AttnBwdArgs), _P],
                      "attention_bwd_resources": [_I, _I, _IP]},
    "attention_generic": {
        "attention_generic_fwd": [ctypes.POINTER(_AttnArgs), _I, _I, _P],
        "attention_generic_bwd": [ctypes.POINTER(_AttnBwdArgs), _I, _I, _P]},
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


BWD_PASSES = ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel",
              "attn_bwd_dkdv_prefix_kernel")


def kernel_resources() -> dict:
    """Registers, static and dynamic shared memory (bytes a block) and local
    (spill) bytes a thread of every fast attention kernel instance, keyed
    like ``attn_fwd_kernel<0>`` (the template's policy number), as the CUDA
    runtime reports them. Builds and loads both libraries; needs a GPU."""
    keys = ("registers", "smem_static", "smem_dynamic", "local_bytes")
    fwd = _lib("attention_fwd").attention_fwd_resources
    bwd = _lib("attention_bwd").attention_bwd_resources
    out = {}
    for policy in (POLICY_LINE, POLICY_CONV, POLICY_FULL):
        calls = [("attn_fwd_kernel", lambda buf: fwd(policy, buf))] + [
            (name, lambda buf, i=i: bwd(policy, i, buf))
            for i, name in enumerate(BWD_PASSES)]
        for name, call in calls:
            buf = (ctypes.c_int * 4)()
            if call(buf) != 0:
                raise RuntimeError(f"{name}<{policy}>: cudaFuncGetAttributes "
                                   "failed")
            out[f"{name}<{policy}>"] = dict(zip(keys, buf))
    return out


def _run(direction: str, route: str, args, q, counter: str) -> None:
    """Launches the ``direction`` ("fwd" or "bwd") entry point of ``route``
    on the current stream, raises if the launch failed, and counts it."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "fast":
        name = f"attention_{direction}"
        lib = _lib(name)
        err = getattr(lib, name)(ctypes.byref(args), stream)
    else:
        name = "attention_generic"
        lib = _lib(name)
        err = getattr(lib, f"{name}_{direction}")(
            ctypes.byref(args), GENERIC_DTYPES[q.dtype], q.shape[-1], stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error")(err).decode()
        raise RuntimeError(f"{counter}: launch failed: {msg}")
    LAUNCHES[counter] += 1
    if route == "generic":
        GENERIC_LAUNCHES[counter] += 1


def _kernel_ready(x: torch.Tensor) -> bool:
    """Whether ``x`` (B, H, T, d) has the strides the fast kernels take
    (16-byte rows; the generic ones take any with unit stride along d)."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_operand(name: str, x: torch.Tensor, shape, like: torch.Tensor,
                   route: str) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{name}: expected {like.dtype} on {like.device}, "
                         f"got {x.dtype} on {x.device}")
    if route == "fast" and not _kernel_ready(x):
        raise ValueError(f"{name}: rows must be 16-byte aligned with unit "
                         f"stride along d (strides {x.stride()})")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: needs unit stride along d (strides "
                         f"{x.stride()})")


def _check_operands(counter: str, q, k, v, kp, vp):
    """Checks q/k/v (and the prefix) for the route their dtype and head_dim
    take; returns ``(S, route)``, S = 0 without a prefix."""
    b, h, t, d = q.shape
    route = attention_route(q.dtype, d)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(f"{counter} {name}", x, (b, h, t, d), q, route)
    if (kp is None) != (vp is None):
        raise ValueError(f"{counter}: kp and vp come together")
    if kp is None:
        return 0, route
    s = kp.shape[2]
    for name, x in (("kp", kp), ("vp", vp)):
        _check_operand(f"{counter} {name}", x, (b, h, s, d), q, route)
    return s, route


def _strides(x):
    if x is None:
        return (ctypes.c_longlong * 3)(0, 0, 0)
    return (ctypes.c_longlong * 3)(*x.stride()[:3])


def _ptr(x):
    return None if x is None else x.data_ptr()


def _bthd(b, t, h, d, like):
    """An empty (B, H, T, d) view of (B, T, H, d) storage."""
    return torch.empty((b, t, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch(counter: str, q, k, v, kp, vp, policy: int, n: int, grid: int,
            hw: int, transpose: bool):
    b, h, t, d = q.shape
    s, route = _check_operands(counter, q, k, v, kp, vp)
    out = _bthd(b, t, h, d, q)
    lse = torch.empty((b, h, 1, t), dtype=torch.float32, device=q.device)
    args = _AttnArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), kp=_ptr(kp),
        vp=_ptr(vp), out=out.data_ptr(), lse=lse.data_ptr(),
        q_s=_strides(q), k_s=_strides(k), v_s=_strides(v),
        kp_s=_strides(kp), vp_s=_strides(vp), o_s=_strides(out), B=b, H=h,
        T=t, S=s, policy=policy, n=n, grid=grid, hw=hw,
        transpose=int(transpose), scale=d ** -0.5)
    _run("fwd", route, args, q, counter)
    return out, lse


def _launch_bwd(counter: str, q, k, v, kp, vp, out, lse, dout, policy: int,
                n: int, grid: int, hw: int, transpose: bool):
    b, h, t, d = q.shape
    s, route = _check_operands(counter, q, k, v, kp, vp)
    for name, x in (("out", out), ("dout", dout)):
        _check_operand(f"{counter} {name}", x, (b, h, t, d), q, route)
    if (tuple(lse.shape) != (b, h, 1, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{counter}: lse must be a contiguous f32 "
                         f"({b}, {h}, 1, {t}) tensor on {q.device}")
    dq, dk, dv = (_bthd(b, t, h, d, q) for _ in range(3))
    dkp = dvp = None
    if kp is not None:
        dkp, dvp = (_bthd(b, s, h, d, q) for _ in range(2))
    dd = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    args = _AttnBwdArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), kp=_ptr(kp),
        vp=_ptr(vp), o=out.data_ptr(), dout=dout.data_ptr(),
        lse=lse.data_ptr(), dd=dd.data_ptr(), dq=dq.data_ptr(),
        dk=dk.data_ptr(), dv=dv.data_ptr(), dkp=_ptr(dkp), dvp=_ptr(dvp),
        q_s=_strides(q), k_s=_strides(k), v_s=_strides(v),
        kp_s=_strides(kp), vp_s=_strides(vp), o_s=_strides(out),
        do_s=_strides(dout), dq_s=_strides(dq), dk_s=_strides(dk),
        dv_s=_strides(dv), dkp_s=_strides(dkp), dvp_s=_strides(dvp),
        B=b, H=h, T=t, S=s, policy=policy, n=n, grid=grid, hw=hw,
        transpose=int(transpose), scale=d ** -0.5)
    _run("bwd", route, args, q, counter)
    return dq, dk, dv, dkp, dvp


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _check_lines(what: str, t: int, n: int, grid_side: int,
                 transpose: bool) -> None:
    if t % n or (transpose and t != grid_side * grid_side):
        raise ValueError(f"{what}: T={t} is not whole lines of {n} (grid "
                         f"{grid_side}, transpose {transpose})")


def _plain(what: str, q: torch.Tensor) -> bool:
    """Whether to take the plain version (a CPU tensor) rather than the
    kernel (a CUDA tensor); other devices raise."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return False


def line_attention(q, kl, vl, kp, vp, n: int, grid_side: int,
                   transpose: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused [prefix || causal line] attention (the TPU kernel's arguments).

    q/kl/vl: (B, H, T, d) line tokens in raster order; kp/vp: optional
    (B, H, S, d) prefix; ``n`` tokens per line; ``transpose`` makes raster
    columns the lines (axial_col, ``n == grid_side``). CPU tensors take the
    plain version; CUDA tensors launch the forward kernel of
    :func:`attention_route`'s route."""
    _check_lines("line_attention", q.shape[2], n, grid_side, transpose)
    if _plain("line_attention", q):
        return line_attention_plain(q, kl, vl, kp, vp, n, grid_side,
                                    transpose)
    return _launch("line_attention", q, kl, vl, kp, vp, POLICY_LINE, n,
                   grid_side, 0, transpose)


def line_attention_bwd(q, kl, vl, kp, vp, out, lse, dout, n: int,
                       grid_side: int, transpose: bool):
    """``(dq, dkl, dvl, dkp, dvp)`` of :func:`line_attention` for the
    cotangent ``dout`` (B, H, T, d), from its ``out`` and ``lse``; the
    prefix pair is None without a prefix. CPU tensors take the plain
    version; CUDA tensors launch the backward kernels of
    :func:`attention_route`'s route."""
    _check_lines("line_attention_bwd", q.shape[2], n, grid_side, transpose)
    if _plain("line_attention_bwd", q):
        return line_attention_bwd_plain(q, kl, vl, kp, vp, out, lse, dout,
                                        n, grid_side, transpose)
    return _launch_bwd("line_attention_bwd", q, kl, vl, kp, vp, out, lse,
                       dout, POLICY_LINE, n, grid_side, 0, transpose)


def window_attention(q, k, v, kp, vp, grid: int,
                     hw: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused [prefix || raster-window causal] attention over the image
    tokens (B, H, grid*grid, d); ``hw=None`` is plain causal ('full')."""
    t = q.shape[2]
    if t != grid * grid:
        raise ValueError(f"window_attention: T={t} != grid^2={grid * grid}")
    if _plain("window_attention", q):
        return window_attention_plain(q, k, v, kp, vp, grid, hw)
    policy = POLICY_FULL if hw is None else POLICY_CONV
    return _launch("window_attention", q, k, v, kp, vp, policy, 0, grid,
                   hw or 0, False)


def window_attention_bwd(q, k, v, kp, vp, out, lse, dout, grid: int,
                         hw: Optional[int]):
    """``(dq, dk, dv, dkp, dvp)`` of :func:`window_attention` for the
    cotangent ``dout``. CPU tensors take the plain version; CUDA tensors
    launch the backward kernels of :func:`attention_route`'s route."""
    t = q.shape[2]
    if t != grid * grid:
        raise ValueError(f"window_attention_bwd: T={t} != "
                         f"grid^2={grid * grid}")
    if _plain("window_attention_bwd", q):
        return window_attention_bwd_plain(q, k, v, kp, vp, out, lse, dout,
                                          grid, hw)
    policy = POLICY_FULL if hw is None else POLICY_CONV
    return _launch_bwd("window_attention_bwd", q, k, v, kp, vp, out, lse,
                       dout, policy, 0, grid, hw or 0, False)


def _cotangent(dout: torch.Tensor) -> torch.Tensor:
    """The cotangent as the kernels take it: a view with other strides
    (for example a broadcast) is copied once."""
    if dout.device.type == "cuda" and not _kernel_ready(dout):
        return dout.contiguous()
    return dout


class LineAttention(torch.autograd.Function):
    """:func:`line_attention` returning ``out`` only, with
    :func:`line_attention_bwd` as its gradient (the ``custom_vjp`` of
    ``attention_kernels.line_attention``)."""

    @staticmethod
    def forward(ctx, q, kl, vl, kp, vp, n, grid_side, transpose):
        out, lse = line_attention(q, kl, vl, kp, vp, n, grid_side, transpose)
        ctx.save_for_backward(q, kl, vl, kp, vp, out, lse)
        ctx.line = (n, grid_side, transpose)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = line_attention_bwd(*ctx.saved_tensors, _cotangent(dout),
                                   *ctx.line)
        return grads + (None, None, None)


class WindowAttention(torch.autograd.Function):
    """:func:`window_attention` returning ``out`` only, with
    :func:`window_attention_bwd` as its gradient (the ``custom_vjp`` of
    ``attention_kernels.window_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, kp, vp, grid, hw):
        out, lse = window_attention(q, k, v, kp, vp, grid, hw)
        ctx.save_for_backward(q, k, v, kp, vp, out, lse)
        ctx.window = (grid, hw)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = window_attention_bwd(*ctx.saved_tensors, _cotangent(dout),
                                     *ctx.window)
        return grads + (None, None)
