"""The port's kernel modules (dalle_tpu_torch/ops) against the JAX package's
Pallas kernels run in interpret mode, at the shapes of the JAX package's own
kernel tests, in f32 and bf16: each forward, and each autograd Function's
gradients against ``jax.vjp`` of the Pallas ``custom_vjp`` function.

On the CPU each wrapper runs its plain PyTorch version, which is what these
tests hold against the TPU kernels (tests/test_torch_cuda.py holds the
Hopper kernels against the plain versions on a GPU).

Tolerances: f32 1e-5 (the same math in another summation order); bf16
outputs 2 bf16 ulps relative (2^-7), since one rounding of an f32 value that
differs in its last f32 bits can land on the neighbouring bf16 value.
Gradients take the same tolerances.

The attention cases run at head_dim 8 and, as the card's generic instances
take them, 32 and 128; the LayerNorm cases add d = 64 and the XL width
1792 with M = 8 x an odd count (the Pallas kernels tile M by multiples of 8;
ragged M is held against the plain version on the card, in
tests/test_torch_cuda.py). ``attention_route`` and ``geglu_route`` pick the
card's route from dtype and widths alone, so they are tested here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops.pallas import attention_kernels as jak
from dalle_tpu.ops.pallas.geglu_kernels import geglu_ff as jax_geglu_ff
from dalle_tpu.ops.pallas.ln_kernels import layer_norm as jax_layer_norm
from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.ops.attention import (LineAttention, WindowAttention,
                                           attention_route, line_attention,
                                           window_attention)
from dalle_tpu_torch.ops.geglu import GEGLUFn, geglu_ff, geglu_route
from dalle_tpu_torch.ops.layer_norm import LayerNormFn, layer_norm

torch.set_num_threads(2)

DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16,
                 dict(rtol=2 ** -7, atol=2 ** -7)),
}


def _both(a: np.ndarray, dtype: str):
    """The same f32 numpy values as a JAX and a torch array of ``dtype``
    (both round to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jdt),
            torch.from_numpy(a).to(tdt))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# the JAX kernel tests' shapes, the tiny width and the XL width
LN_SHAPES = [(256, 128), (384, 256), (296, 64), (1000, 1792)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", LN_SHAPES)
def test_layer_norm_matches_pallas(dtype, m, d):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.3).astype(np.float32)
    g = (rng.standard_normal(d) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    xj, xt = _both(x, dtype)
    want = jax_layer_norm(xj, jnp.asarray(g), jnp.asarray(b), 1e-6, 128,
                          True)
    reset_launches()
    got = layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b), 1e-6)
    assert LAUNCHES["layer_norm"] == 0   # the CPU takes the plain version
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(256, 512), (384, 640)])
def test_geglu_matches_pallas(dtype, m, k):
    d = 128
    rng = np.random.default_rng(1)
    shapes = [(m, d), (d, k), (d, k), (k, d), (k,), (k,), (d,)]
    scales = [0.5, 0.05, 0.05, 0.05, 0.1, 0.1, 0.1]
    ops = [(rng.standard_normal(s) * sc).astype(np.float32)
           for s, sc in zip(shapes, scales)]
    pairs = [_both(a, dtype) for a in ops]
    want = jax_geglu_ff(*(p[0] for p in pairs), 128, 256, True)
    got = geglu_ff(*(p[1] for p in pairs))
    assert got.dtype == pairs[0][1].dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **DTYPES[dtype][2])


TEXT, H, D = 16, 2, 8


def _qkv(seed, t, b=2, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, H, t, d)).astype(np.float32)
            for _ in range(3)]


def _with_head_dims(cases, wider):
    """``cases`` at head_dim D (their ids as they were) and ``wider``
    (case, head_dim) pairs, ids suffixed with the head dim."""
    def idx(case):
        return "-".join(str(v) for v in case)
    return ([pytest.param(*c, D, id=idx(c)) for c in cases]
            + [pytest.param(*c, hd, id=f"{idx(c)}-d{hd}") for c, hd in wider])


def _col_major_stats(stats, grid):
    b, h, _, t = stats.shape
    return stats.reshape(b, h, 1, grid, grid).swapaxes(3, 4).reshape(
        b, h, 1, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,grid,hd", _with_head_dims(
    [("text", 4), ("axial_row", 4), ("axial_col", 4), ("axial_row", 6),
     ("axial_col", 6)],
    [(("text", 4), 32), (("axial_col", 4), 128)]))
def test_line_attention_matches_pallas(dtype, kind, grid, hd):
    tol = DTYPES[dtype][2]
    if kind == "text":
        q, k, v = (_both(a, dtype) for a in _qkv(2, TEXT, d=hd))
        kp = vp = (None, None)
        n, side, transpose = TEXT, 0, False
    else:
        q, k, v = (_both(a, dtype) for a in _qkv(3, grid * grid, d=hd))
        kp, vp = (_both(a, dtype) for a in _qkv(4, TEXT, d=hd)[:2])
        n, side, transpose = grid, grid, kind == "axial_col"
    out_j, stats_j = jak._line_attention_fwd(
        q[0], k[0], v[0], kp[0], vp[0], n=n, grid_side=side,
        transpose=transpose, interpret=True)
    out_t, lse_t = line_attention(q[1], k[1], v[1], kp[1], vp[1], n, side,
                                  transpose)
    stats_j = _f32(stats_j)
    if transpose:   # the TPU kernel keeps axial_col stats column-major
        stats_j = _col_major_stats(stats_j, grid)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), **tol)
    np.testing.assert_allclose(_f32(lse_t), stats_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["conv_like", "full"])
@pytest.mark.parametrize("grid,conv_kernel,hd", _with_head_dims(
    [(4, 3), (8, 5)], [((4, 3), 32), ((8, 5), 128)]))
def test_window_attention_matches_pallas(dtype, kind, grid, conv_kernel, hd):
    """(8, 5) is the multi-group case: queries span several key groups
    and conv windows overlap group boundaries."""
    tol = DTYPES[dtype][2]
    hw = conv_kernel // 2 if kind == "conv_like" else None
    q, k, v = (_both(a, dtype) for a in _qkv(5, grid * grid, d=hd))
    kp, vp = (_both(a, dtype) for a in _qkv(6, TEXT, d=hd)[:2])
    out_j, stats_j = jak._window_attention_fwd(
        q[0], k[0], v[0], kp[0], vp[0], grid=grid, hw=hw, interpret=True)
    out_t, lse_t = window_attention(q[1], k[1], v[1], kp[1], vp[1], grid, hw)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), **tol)
    np.testing.assert_allclose(_f32(lse_t), _f32(stats_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,widths,route", [
    (torch.float32, (16,), "generic"), (torch.bfloat16, (64,), "fast"),
    (torch.bfloat16, (128,), "generic"), (torch.float32, (64,), "generic"),
    (torch.bfloat16, (32,), "generic"), (torch.float16, (64,), None),
    (torch.float32, (48,), None), (torch.bfloat16, (8,), None)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_attention_route(dtype, widths, route):
    """The fast kernels take bf16 at head_dim 64, the generic instances bf16
    or f32 at 16, 32, 64 and 128; anything else names the missing one."""
    if route is None:
        with pytest.raises(ValueError, match="no kernel instance"):
            attention_route(dtype, *widths)
    else:
        assert attention_route(dtype, *widths) == route


@pytest.mark.parametrize("dtype,widths,route", [
    (torch.float32, (1024, 4096), "generic"),
    (torch.bfloat16, (1024, 4096), "fast"),
    (torch.bfloat16, (64, 64), "fast"), (torch.bfloat16, (72, 136), "generic"),
    (torch.float32, (64, 256), "generic"), (torch.float16, (64, 256), None),
    (torch.bfloat16, (100, 64), None), (torch.float32, (64, 260), None)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_geglu_route(dtype, widths, route):
    """The fast kernels take bf16 with d and K multiples of 64, the generic
    instances bf16 or f32 with multiples of 8; anything else raises."""
    if route is None:
        with pytest.raises(ValueError, match="no kernel instance"):
            geglu_route(dtype, *widths)
    else:
        assert geglu_route(dtype, *widths) == route


def test_wrappers_refuse_bad_shapes():
    q = torch.zeros(1, 2, 10, 8)
    with pytest.raises(ValueError):
        line_attention(q, q, q, None, None, 4, 0, False)   # 10 % 4 != 0
    with pytest.raises(ValueError):
        window_attention(q, q, q, None, None, 4, 1)         # 10 != 4 * 4


def _leaves(pairs):
    """(jax arrays, torch leaves requiring grad) of ``_both`` pairs."""
    return ([p[0] for p in pairs],
            [p[1].clone().requires_grad_(True) for p in pairs])


def _assert_grads(got, want, dtype, names):
    for name, g, w in zip(names, got, want):
        assert g is not None, name
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=name,
                                   **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", LN_SHAPES)
def test_layer_norm_grads_match_pallas_vjp(dtype, m, d):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.3).astype(np.float32)
    g = (rng.standard_normal(d) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((m, d)).astype(np.float32)
    xj, xt = _both(x, dtype)
    dyj, dyt = _both(dy, dtype)
    _, vjp = jax.vjp(lambda *a: jax_layer_norm(*a, 1e-6, 128, True), xj,
                     jnp.asarray(g), jnp.asarray(b))
    want = vjp(dyj)
    leaves = [xt.clone().requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for a in (g, b)]
    reset_launches()
    LayerNormFn.apply(*leaves, 1e-6).backward(dyt)
    assert LAUNCHES["layer_norm_bwd"] == 0   # the plain backward on the CPU
    assert leaves[0].grad.dtype == xt.dtype
    _assert_grads([t.grad for t in leaves], want, dtype,
                  ["dx", "dscale", "dbias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(256, 512), (384, 640)])
def test_geglu_grads_match_pallas_vjp(dtype, m, k):
    d = 128
    rng = np.random.default_rng(11)
    shapes = [(m, d), (d, k), (d, k), (k, d), (k,), (k,), (d,)]
    scales = [0.5, 0.05, 0.05, 0.05, 0.1, 0.1, 0.1]
    pairs = [_both((rng.standard_normal(s) * sc).astype(np.float32), dtype)
             for s, sc in zip(shapes, scales)]
    dy = _both(rng.standard_normal((m, d)).astype(np.float32), dtype)
    jargs, leaves = _leaves(pairs)
    _, vjp = jax.vjp(lambda *a: jax_geglu_ff(*a, 128, 256, True), *jargs)
    want = vjp(dy[0])
    reset_launches()
    GEGLUFn.apply(*leaves).backward(dy[1])
    assert LAUNCHES["geglu_ff_bwd"] == 0
    _assert_grads([t.grad for t in leaves], want, dtype,
                  ["dx", "dwi", "dwg", "dwo", "dbi", "dbg", "dbo"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,grid,hd", _with_head_dims(
    [("text", 4), ("axial_row", 4), ("axial_col", 4), ("axial_row", 6),
     ("axial_col", 6), ("axial_row_noprefix", 4)],
    [(("axial_col", 6), 32), (("axial_row_noprefix", 4), 128)]))
def test_line_attention_grads_match_pallas_vjp(dtype, kind, grid, hd):
    if kind == "text":
        arrays, n, side, transpose = _qkv(12, TEXT, d=hd), TEXT, 0, False
    else:
        arrays = _qkv(13, grid * grid, d=hd)
        if not kind.endswith("noprefix"):
            arrays += _qkv(14, TEXT, d=hd)[:2]
        n, side, transpose = grid, grid, kind == "axial_col"
    pairs = [_both(a, dtype) for a in arrays]
    dy = _both(np.random.default_rng(15).standard_normal(
        arrays[0].shape).astype(np.float32), dtype)
    jargs, leaves = _leaves(pairs)
    pad = [None] * (5 - len(jargs))

    def jfn(*a):
        return jak.line_attention(*a, *pad, n, side, transpose, True)

    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp(dy[0])
    reset_launches()
    LineAttention.apply(*leaves, *pad, n, side, transpose).backward(dy[1])
    assert LAUNCHES["line_attention_bwd"] == 0
    _assert_grads([t.grad for t in leaves], want, dtype,
                  ["dq", "dk", "dv", "dkp", "dvp"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["conv_like", "full"])
@pytest.mark.parametrize("grid,conv_kernel,prefix,hd", _with_head_dims(
    [(4, 3, True), (8, 5, True), (4, 3, False)],
    [((4, 3, True), 32), ((8, 5, True), 128)]))
def test_window_attention_grads_match_pallas_vjp(dtype, kind, grid,
                                                 conv_kernel, prefix, hd):
    hw = conv_kernel // 2 if kind == "conv_like" else None
    arrays = _qkv(16, grid * grid, d=hd) + (_qkv(17, TEXT, d=hd)[:2]
                                            if prefix else [])
    pairs = [_both(a, dtype) for a in arrays]
    dy = _both(np.random.default_rng(18).standard_normal(
        arrays[0].shape).astype(np.float32), dtype)
    jargs, leaves = _leaves(pairs)
    pad = [None] * (5 - len(jargs))

    def jfn(*a):
        return jak.window_attention(*a, *pad, grid, hw, True)

    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp(dy[0])
    reset_launches()
    WindowAttention.apply(*leaves, *pad, grid, hw).backward(dy[1])
    assert LAUNCHES["window_attention_bwd"] == 0
    _assert_grads([t.grad for t in leaves], want, dtype,
                  ["dq", "dk", "dv", "dkp", "dvp"])
