"""The port's kernel modules (dalle_tpu_torch/ops) against the JAX package's
Pallas kernels run in interpret mode, at the shapes of the JAX package's own
kernel tests, in f32 and bf16.

On the CPU each wrapper runs its plain PyTorch version, which is what these
tests hold against the TPU kernels (tests/test_torch_cuda.py holds the
Hopper kernels against the plain versions on a GPU).

Tolerances: f32 1e-5 (the same math in another summation order); bf16
outputs 2 bf16 ulps relative (2^-7), since one rounding of an f32 value that
differs in its last f32 bits can land on the neighbouring bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops.pallas import attention_kernels as jak
from dalle_tpu.ops.pallas.geglu_kernels import geglu_ff as jax_geglu_ff
from dalle_tpu.ops.pallas.ln_kernels import layer_norm as jax_layer_norm
from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.ops.attention import line_attention, window_attention
from dalle_tpu_torch.ops.geglu import geglu_ff
from dalle_tpu_torch.ops.layer_norm import layer_norm

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(256, 128), (384, 256)])
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


def _qkv(seed, t, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, H, t, D)).astype(np.float32)
            for _ in range(3)]


def _col_major_stats(stats, grid):
    b, h, _, t = stats.shape
    return stats.reshape(b, h, 1, grid, grid).swapaxes(3, 4).reshape(
        b, h, 1, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,grid", [("text", 4), ("axial_row", 4),
                                       ("axial_col", 4), ("axial_row", 6),
                                       ("axial_col", 6)])
def test_line_attention_matches_pallas(dtype, kind, grid):
    tol = DTYPES[dtype][2]
    if kind == "text":
        q, k, v = (_both(a, dtype) for a in _qkv(2, TEXT))
        kp = vp = (None, None)
        n, side, transpose = TEXT, 0, False
    else:
        q, k, v = (_both(a, dtype) for a in _qkv(3, grid * grid))
        kp, vp = (_both(a, dtype) for a in _qkv(4, TEXT)[:2])
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
@pytest.mark.parametrize("grid,conv_kernel", [(4, 3), (8, 5)])
def test_window_attention_matches_pallas(dtype, kind, grid, conv_kernel):
    """(8, 5) is the multi-group case: queries span several key groups
    and conv windows overlap group boundaries."""
    tol = DTYPES[dtype][2]
    hw = conv_kernel // 2 if kind == "conv_like" else None
    q, k, v = (_both(a, dtype) for a in _qkv(5, grid * grid))
    kp, vp = (_both(a, dtype) for a in _qkv(6, TEXT)[:2])
    out_j, stats_j = jak._window_attention_fwd(
        q[0], k[0], v[0], kp[0], vp[0], grid=grid, hw=hw, interpret=True)
    out_t, lse_t = window_attention(q[1], k[1], v[1], kp[1], vp[1], grid, hw)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), **tol)
    np.testing.assert_allclose(_f32(lse_t), _f32(stats_j), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_refuse_bad_shapes():
    q = torch.zeros(1, 2, 10, 8)
    with pytest.raises(ValueError):
        line_attention(q, q, q, None, None, 4, 0, False)   # 10 % 4 != 0
    with pytest.raises(ValueError):
        window_attention(q, q, q, None, None, 4, 1)         # 10 != 4 * 4
