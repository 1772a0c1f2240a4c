"""The arithmetic of the generic GEGLU kernels' f32 route, on the CPU.

``csrc/geglu_generic.cu`` runs f32 products on the tensor cores as 3xTF32:
each operand is split into ``hi`` (TF32, rounded to nearest with ties away
from zero) and ``lo`` (``a - hi`` truncated to TF32), and a product is
summed as ``lo.hi + hi.lo + hi.hi``. ``ops.geglu.split_tf32`` is that split
in plain PyTorch. These tests hold it to its definition (hand-made ties,
zero low bits, the split's error bound) and show that the GEGLU forward and
backward tensors built from 3xTF32 products stay within the card tests'
f32 tolerance (rtol = atol = 1e-5, ``F32`` in tests/test_torch_cuda.py) of
the plain versions and of the JAX package's Pallas kernels in interpret
mode, at the kernel tests' shapes and at a flagship-width slice (M = 256,
d = 1024, K = 4096), where one TF32 pass misses even ``chip_smoke.py``'s
1e-4. The card's own accumulation order is not modelled: the card tests
hold the kernels to the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops.pallas.geglu_kernels import _ff_bwd_tensors, _ff_fwd
from dalle_tpu_torch.ops.geglu import (gelu_tanh, gelu_tanh_grad,
                                       geglu_ff_bwd_plain, geglu_ff_plain,
                                       split_tf32)

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
SMOKE_F32_TOL = 1e-4   # chip_smoke.py's F32_TOL


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_split_tf32_leaves_tf32_values():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(
        -20, 20, 4096)).astype(np.float32))
    hi, lo = split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()
    # hi is x rounded: within half a TF32 ulp (2^-11 relative)
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    # lo keeps the rest to a TF32 ulp of itself: 2^-21 relative to x
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= x.abs().double() * 2.0 ** -21).all())


@pytest.mark.parametrize("value,hi,lo", [
    (1 + 2 ** -11, 1 + 2 ** -10, -2 ** -11),     # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10), 2 ** -11),
    # below the tie: down; the rest, 12 bits, loses its last to truncation
    (1 + 2 ** -11 - 2 ** -23, 1.0, 2 ** -11 - 2 ** -22),
    (2 + 2 ** -10, 2 + 2 ** -9, -2 ** -10),     # a tie one binade up
    (2.0 ** 100 * (1 + 2 ** -11), 2.0 ** 100 * (1 + 2 ** -10), -2.0 ** 89),
    (0.0, 0.0, 0.0)])
def test_split_tf32_rounds_ties_away_from_zero(value, hi, lo):
    got_hi, got_lo = split_tf32(torch.tensor([value], dtype=torch.float32))
    assert (got_hi.item(), got_lo.item()) == (hi, lo)


def _mm3(a, b):
    """a.b from 3xTF32 products, each pass summed in f32."""
    ahi, alo = split_tf32(a)
    bhi, blo = split_tf32(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _mm1(a, b):
    """a.b from one TF32 pass (each operand rounded once)."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


def _fwd(x, wi, wg, wo, bi, bg, bo, mm):
    """geglu_ff_plain's math (f32) with its three products taken by mm."""
    h = mm(x, wi) + bi
    g = mm(x, wg) + bg
    return bo + mm(h * gelu_tanh(g), wo)


def _bwd(x, wi, wg, wo, bi, bg, dout, mm):
    """geglu_ff_bwd_plain's tensors (f32) with its products taken by mm."""
    h = mm(x, wi) + bi
    g = mm(x, wg) + bg
    a = gelu_tanh(g)
    dhg = mm(dout, wo.t())
    return (torch.cat([dhg * a, dhg * h * gelu_tanh_grad(g)], dim=1),
            h * a)


def _operands(m, d, k, scales, seed):
    """x, Wi, Wg, Wo, bi, bg, bo, dO as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = [(m, d), (d, k), (d, k), (k, d), (k,), (k,), (d,), (m, d)]
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in zip(shapes, scales)]


# the shapes of tests/test_torch_ops.py's GEGLU cases (d = 128, their
# scales) and a flagship-width slice scaled as the model's initialisation
# scales it (weights by 1/sqrt(fan-in))
CASES = [
    (256, 128, 512, (0.5, 0.05, 0.05, 0.05, 0.1, 0.1, 0.1, 1.0)),
    (384, 128, 640, (0.5, 0.05, 0.05, 0.05, 0.1, 0.1, 0.1, 1.0)),
    (256, 1024, 4096, (1.0, 1024 ** -0.5, 1024 ** -0.5, 4096 ** -0.5,
                       0.1, 0.1, 0.1, 1.0)),
]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"m{c[0]}_d{c[1]}_k{c[2]}")
def case(request):
    m, d, k, scales = request.param
    arrays = _operands(m, d, k, scales, seed=m + d + k)
    return (m, d, k), arrays, [torch.from_numpy(a) for a in arrays]


def test_3xtf32_forward_within_f32_tolerance(case):
    (m, d, k), arrays, ops = case
    got = _fwd(*ops[:7], mm=_mm3)
    torch.testing.assert_close(got, geglu_ff_plain(*ops[:7]), **F32)
    jx = [jnp.asarray(a) for a in arrays[:7]]
    want = np.asarray(_ff_fwd(*jx, 256, 512, True))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_3xtf32_backward_within_f32_tolerance(case):
    (m, d, k), arrays, ops = case
    dhdg, hg = _bwd(*ops[:6], ops[7], mm=_mm3)
    want_dhdg, want_hg = geglu_ff_bwd_plain(*ops[:6], ops[7])
    torch.testing.assert_close(dhdg, want_dhdg, **F32)
    torch.testing.assert_close(hg, want_hg, **F32)
    jx = [jnp.asarray(a) for a in arrays[:6] + arrays[7:]]
    dh, dg, jhg = (np.asarray(t) for t in _ff_bwd_tensors(*jx, 256, 512,
                                                           True))
    np.testing.assert_allclose(dhdg.numpy(), np.concatenate([dh, dg], 1),
                               **F32)
    np.testing.assert_allclose(hg.numpy(), jhg, **F32)


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why three passes: one TF32 pass is not within even 1e-4 at the
    flagship's widths."""
    m, d, k, scales = CASES[-1]
    ops = [torch.from_numpy(a) for a in _operands(m, d, k, scales,
                                                  seed=m + d + k)]
    want = geglu_ff_plain(*ops[:7])
    got = _fwd(*ops[:7], mm=_mm1)
    excess = (got - want).abs() - SMOKE_F32_TOL * want.abs()
    assert excess.max().item() > SMOKE_F32_TOL
