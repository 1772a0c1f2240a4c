"""The arithmetic of the generic window attention kernels' f32 route, on the
CPU.

``csrc/attention_window_generic.cuh`` runs every f32 product on the tensor
cores as 3xTF32 (``ops.geglu.split_tf32``'s split, a product summed as
``lo.hi + hi.lo + hi.hi``), and sums each tile's product in a fresh
partial: the forward folds each key tile's P.V into O after the online
rescale, the backward each key tile's dS.K into dq and each query tile's
dS^T.Q and P^T.dO into dk and dv; the scores take the head dims 64 at a
time. These tests build the window forward and backward that way, with
64-row tiles, and hold them to the card tests' f32 tolerance (rtol = atol
= 1e-5, ``F32`` in tests/test_torch_cuda.py) against the plain f32
versions and the JAX package's Pallas kernels in interpret mode at the
card tests' shape (B 2, H 3, a 6 x 6 grid after 20 text tokens, hw 1 and
``None``, head_dim 16 and 64), and against the plain versions alone at a
flagship-width slice (B 1, H 2, a 32 x 32 grid after 256 text tokens, hw
5, head_dim 64), where one TF32 pass misses even ``chip_smoke.py``'s
1e-4. The card's own accumulation order (and its rounding toward zero
inside an mma) is not modelled: the card tests hold the kernels to the
plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops.pallas import attention_kernels as jak
from dalle_tpu_torch.ops.attention import (NEG_INF, window_attention_bwd_plain,
                                           window_attention_plain,
                                           window_mask)
from dalle_tpu_torch.ops.geglu import split_tf32

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
SMOKE_F32_TOL = 1e-4   # chip_smoke.py's F32_TOL
TILE = 64              # rows of a streamed tile in the kernels
DEPTH = 64             # head dims a partial of the scores


def _mm3(a, b):
    """a.b from 3xTF32 products, each pass summed in f32."""
    ahi, alo = split_tf32(a)
    bhi, blo = split_tf32(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _mm1(a, b):
    """a.b from one TF32 pass (each operand rounded once)."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


def _scores(a, b, mm):
    """a.b^T over the head dims, DEPTH of them a partial."""
    d = a.shape[-1]
    s = None
    for c in range(0, d, DEPTH):
        part = mm(a[..., c:c + DEPTH], b[..., c:c + DEPTH].transpose(-1, -2))
        s = part if s is None else s + part
    return s


def _key_tiles(t, s):
    """The key tiles the kernels walk: the prefix's, then the main keys'."""
    return ([(True, k0, min(k0 + TILE, s)) for k0 in range(0, s, TILE)]
            + [(False, k0, min(k0 + TILE, t)) for k0 in range(0, t, TILE)])


def window_fwd(q, k, v, kp, vp, grid, hw, mm):
    """The forward as the kernels sum it: online softmax over key tiles,
    each tile's P.V in a fresh partial added after the rescale."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    mask = window_mask(t, grid, hw, q.device)
    m = torch.full((b, h, t), float("-inf"))
    l = torch.zeros((b, h, t))
    o = torch.zeros((b, h, t, d))
    for pfx, k0, k1 in _key_tiles(t, kp.shape[2]):
        kt, vt = (kp, vp) if pfx else (k, v)
        s = _scores(q, kt[:, :, k0:k1], mm) * scale
        if not pfx:
            s = torch.where(mask[:, k0:k1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + mm(p, vt[:, :, k0:k1])
        m = m_new
    return o / l[..., None], (m + torch.log(l))[:, :, None, :]


def window_bwd(q, k, v, kp, vp, out, lse, dout, grid, hw, mm):
    """(dq, dk, dv, dkp, dvp) as the kernels sum them: each key tile's
    dS.K a fresh partial of dq, each query tile's dS^T.Q and P^T.dO fresh
    partials of dk and dv."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    mask = window_mask(t, grid, hw, q.device)
    lse = lse[:, :, 0, :]
    dd = (dout * out).sum(dim=-1)
    dq = torch.zeros_like(q)
    grads = {True: (torch.zeros_like(kp), torch.zeros_like(vp)),
             False: (torch.zeros_like(k), torch.zeros_like(v))}
    for pfx, k0, k1 in _key_tiles(t, kp.shape[2]):
        kt, vt = (kp, vp) if pfx else (k, v)
        kt, vt = kt[:, :, k0:k1], vt[:, :, k0:k1]
        p = torch.exp(_scores(q, kt, mm) * scale - lse[..., None])
        if not pfx:
            p = torch.where(mask[:, k0:k1], p, 0.0)
        ds = p * (_scores(dout, vt, mm) - dd[..., None])
        dq = dq + mm(ds, kt)
        gk, gv = grads[pfx]
        for q0 in range(0, t, TILE):
            rows = slice(q0, q0 + TILE)
            gk[:, :, k0:k1] += mm(ds[:, :, rows].transpose(-1, -2),
                                  q[:, :, rows])
            gv[:, :, k0:k1] += mm(p[:, :, rows].transpose(-1, -2),
                                  dout[:, :, rows])
    (dkp, dvp), (dk, dv) = grads[True], grads[False]
    return dq * scale, dk * scale, dv, dkp * scale, dvp


def _operands(b, h, grid, text, d, seed):
    """q, k, v, dO (B, H, grid^2, d) and kp, vp (B, H, text, d), f32."""
    rng = np.random.default_rng(seed)
    t = grid * grid
    shapes = [(b, h, t, d)] * 4 + [(b, h, text, d)] * 2
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


NAMES = ("dq", "dk", "dv", "dkp", "dvp")


@pytest.mark.parametrize("hw", [1, None], ids=["conv_like", "full"])
@pytest.mark.parametrize("d", [16, 64])
def test_3xtf32_window_attention_within_f32_tolerance(hw, d):
    """The card tests' shape: the forward and backward built from 3xTF32
    products against the plain f32 versions and the Pallas kernels."""
    grid = 6
    arrays = _operands(2, 3, grid, 20, d, seed=d + (hw or 0))
    q, k, v, do, kp, vp = (torch.from_numpy(a) for a in arrays)
    out, lse = window_fwd(q, k, v, kp, vp, grid, hw, _mm3)
    out_p, lse_p = window_attention_plain(q, k, v, kp, vp, grid, hw)
    torch.testing.assert_close(out, out_p, **F32)
    torch.testing.assert_close(lse, lse_p, **F32)
    got = window_bwd(q, k, v, kp, vp, out_p, lse_p, do, grid, hw, _mm3)
    want = window_attention_bwd_plain(q, k, v, kp, vp, out_p, lse_p, do,
                                      grid, hw)
    for name, a, w in zip(NAMES, got, want):
        torch.testing.assert_close(a, w, msg=name, **F32)

    jq, jk, jv, jdo, jkp, jvp = (jnp.asarray(a) for a in arrays)
    out_j, stats_j = jak._window_attention_fwd(jq, jk, jv, jkp, jvp,
                                               grid=grid, hw=hw,
                                               interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(stats_j), **F32)
    want_j = jak._window_attention_bwd(jq, jk, jv, jkp, jvp, stats_j, out_j,
                                       jdo, grid=grid, hw=hw, interpret=True)
    got = window_bwd(q, k, v, kp, vp, torch.from_numpy(np.array(out_j)),
                     torch.from_numpy(np.array(stats_j)), do, grid, hw, _mm3)
    for name, a, w in zip(NAMES, got, want_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **F32)


@pytest.fixture(scope="module")
def flagship_slice():
    """One batch row, two heads of 64 at the flagship's grid and prefix,
    conv_like hw 5, and the plain versions' outputs on it."""
    grid, hw = 32, 5
    ops = [torch.from_numpy(a) for a in _operands(1, 2, grid, 256, 64, 5)]
    q, k, v, do, kp, vp = ops
    out, lse = window_attention_plain(q, k, v, kp, vp, grid, hw)
    grads = window_attention_bwd_plain(q, k, v, kp, vp, out, lse, do, grid,
                                       hw)
    return ops, (grid, hw), (out, lse), grads


def test_3xtf32_window_attention_flagship_slice(flagship_slice):
    (q, k, v, do, kp, vp), (grid, hw), (out_p, lse_p), want = flagship_slice
    out, lse = window_fwd(q, k, v, kp, vp, grid, hw, _mm3)
    torch.testing.assert_close(out, out_p, **F32)
    torch.testing.assert_close(lse, lse_p, **F32)
    got = window_bwd(q, k, v, kp, vp, out_p, lse_p, do, grid, hw, _mm3)
    for name, a, w in zip(NAMES, got, want):
        torch.testing.assert_close(a, w, msg=name, **F32)


def test_one_tf32_pass_misses_the_f32_tolerance(flagship_slice):
    """Why three passes: one TF32 pass is not within even 1e-4 of the f32
    backward at the flagship's widths."""
    (q, k, v, do, kp, vp), (grid, hw), (out_p, lse_p), want = flagship_slice
    got = window_bwd(q, k, v, kp, vp, out_p, lse_p, do, grid, hw, _mm1)
    excess = max(((a - w).abs() - SMOKE_F32_TOL * w.abs()).max().item()
                 for a, w in zip(got, want))
    assert excess > SMOKE_F32_TOL
