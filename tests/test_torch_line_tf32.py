"""The arithmetic of the generic line attention kernels' f32 route, on the
CPU.

``csrc/attention_window_generic.cuh`` runs the line calls (the text-causal
call, axial_row, and axial_col through ``transpose``) under its line
policy, with the window calls' arithmetic: every f32 product on the tensor
cores as 3xTF32 (``ops.geglu.split_tf32``'s split, a product summed as
``lo.hi + hi.lo + hi.hi``), each tile's product summed in a fresh partial,
the scores over the head dims 64 at a time. Main tokens are walked in
packed order (an axial_col line is a raster column): a block of 64 query
rows reads the prefix's key tiles, then the main keys from the first key
of its first row's line on, 64 at a time (so its tiles need not start on a
multiple of 64 when lines are shorter than a block); a block of 64 keys
reads the query tiles from its first key to the end of its last key's
line. These tests build the line forward and backward that way and hold
them to the card tests' f32 tolerance (rtol = atol = 1e-5, ``F32`` in
tests/test_torch_cuda.py) against the plain f32 versions and the JAX
package's Pallas line kernels in interpret mode (B 2, H 3; lines of 6 and
10 tokens, which do not divide a warp's 16 rows; text calls of 20 and 256
tokens; head_dim 16 and 64), and against the plain versions alone at a
flagship-width slice (B 1, H 2, a 32 x 32 grid after 256 text tokens,
head_dim 64). The card's own accumulation order inside a tile (and its
rounding toward zero inside an mma) is not modelled: the card tests hold
the kernels to the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops.pallas import attention_kernels as jak
from dalle_tpu_torch.ops.attention import (NEG_INF, _col_major,
                                           line_attention_bwd_plain,
                                           line_attention_plain)
from dalle_tpu_torch.ops.geglu import split_tf32

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
BLOCK = 64   # rows a block owns (queries; keys in the dk/dv pass)
TILE = 64    # rows of a streamed tile (f32 at head_dim 16 to 64)
DEPTH = 64   # head dims a partial of the scores


def _mm3(a, b):
    """a.b from 3xTF32 products, each pass summed in f32."""
    ahi, alo = split_tf32(a)
    bhi, blo = split_tf32(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _scores(a, b):
    """a.b^T over the head dims, DEPTH of them a partial."""
    d = a.shape[-1]
    s = None
    for c in range(0, d, DEPTH):
        part = _mm3(a[..., c:c + DEPTH],
                    b[..., c:c + DEPTH].transpose(-1, -2))
        s = part if s is None else s + part
    return s


def _line_mask(t, n):
    """(T, T) packed-order mask: causal inside each line of n tokens."""
    i = torch.arange(t)
    q, k = i[:, None], i[None, :]
    return (k <= q) & (k >= q - q % n)


def _query_tiles(q0, q1, n, s):
    """The key tiles a block of queries [q0, q1) walks: the prefix's, then
    the main keys from its first row's line on."""
    lo = q0 // n * n
    return ([(True, k0, min(k0 + TILE, s)) for k0 in range(0, s, TILE)]
            + [(False, k0, min(k0 + TILE, q1)) for k0 in range(lo, q1, TILE)])


def _packed(xs, grid, transpose):
    return [_col_major(x, grid) if transpose else x for x in xs]


def line_fwd(q, k, v, kp, vp, n, grid, transpose):
    """The forward as the kernels sum it: online softmax over each block's
    key tiles, each tile's P.V in a fresh partial added after the rescale;
    out and lse back in raster order."""
    q, k, v = _packed((q, k, v), grid, transpose)
    b, h, t, d = q.shape
    scale = d ** -0.5
    s_len = 0 if kp is None else kp.shape[2]
    mask = _line_mask(t, n)
    out = torch.zeros_like(q)
    lse = torch.zeros((b, h, t))
    for q0 in range(0, t, BLOCK):
        q1 = min(q0 + BLOCK, t)
        qb = q[:, :, q0:q1]
        m = torch.full((b, h, q1 - q0), float("-inf"))
        l = torch.zeros((b, h, q1 - q0))
        o = torch.zeros((b, h, q1 - q0, d))
        for pfx, k0, k1 in _query_tiles(q0, q1, n, s_len):
            kt, vt = (kp, vp) if pfx else (k, v)
            s = _scores(qb, kt[:, :, k0:k1]) * scale
            if not pfx:
                s = torch.where(mask[q0:q1, k0:k1], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + _mm3(p, vt[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = o / l[..., None]
        lse[:, :, q0:q1] = m + torch.log(l)
    out, lse = _packed((out, lse), grid, transpose)
    return out, lse[:, :, None, :]


def line_bwd(q, k, v, kp, vp, out, lse, dout, n, grid, transpose):
    """(dq, dk, dv, dkp, dvp) as the kernels sum them: the dq pass a fresh
    partial each key tile of a query block, the dk/dv passes a fresh
    partial each query tile of a key block (the main keys' from the block's
    first key to the end of its last key's line, the prefix's over every
    query)."""
    q, k, v, out, dout, lse = _packed((q, k, v, out, dout, lse[:, :, 0]),
                                      grid, transpose)
    b, h, t, d = q.shape
    scale = d ** -0.5
    s_len = 0 if kp is None else kp.shape[2]
    mask = _line_mask(t, n)
    dd = (dout * out).sum(dim=-1)

    def probs(q0, q1, kt, vt, k0, k1, masked):
        p = torch.exp(_scores(q[:, :, q0:q1], kt[:, :, k0:k1]) * scale
                      - lse[:, :, q0:q1, None])
        if masked:
            p = torch.where(mask[q0:q1, k0:k1], p, 0.0)
        ds = p * (_scores(dout[:, :, q0:q1], vt[:, :, k0:k1])
                  - dd[:, :, q0:q1, None])
        return p, ds

    dq = torch.zeros_like(q)
    for q0 in range(0, t, BLOCK):
        q1 = min(q0 + BLOCK, t)
        for pfx, k0, k1 in _query_tiles(q0, q1, n, s_len):
            kt, vt = (kp, vp) if pfx else (k, v)
            _, ds = probs(q0, q1, kt, vt, k0, k1, not pfx)
            dq[:, :, q0:q1] += _mm3(ds, kt[:, :, k0:k1])

    def key_grads(kt, vt, k0, k1, qlo, qhi, masked):
        gk = torch.zeros((b, h, k1 - k0, d))
        gv = torch.zeros((b, h, k1 - k0, d))
        for qs in range(qlo, qhi, TILE):
            qe = min(qs + TILE, t)
            p, ds = probs(qs, qe, kt, vt, k0, k1, masked)
            gk += _mm3(ds.transpose(-1, -2), q[:, :, qs:qe])
            gv += _mm3(p.transpose(-1, -2), dout[:, :, qs:qe])
        return gk, gv

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, t, BLOCK):
        k1 = min(k0 + BLOCK, t)
        qhi = min(t, ((k1 - 1) // n + 1) * n)
        dk[:, :, k0:k1], dv[:, :, k0:k1] = key_grads(k, v, k0, k1, k0, qhi,
                                                     True)
    dkp = dvp = None
    if kp is not None:
        dkp, dvp = torch.zeros_like(kp), torch.zeros_like(vp)
        for k0 in range(0, s_len, BLOCK):
            k1 = min(k0 + BLOCK, s_len)
            dkp[:, :, k0:k1], dvp[:, :, k0:k1] = key_grads(kp, vp, k0, k1, 0,
                                                           t, False)
        dkp = dkp * scale
    dq, dk, dv = _packed((dq * scale, dk * scale, dv), grid, transpose)
    return dq, dk, dv, dkp, dvp


def _operands(b, h, t, text, d, seed):
    """q, k, v, dO (B, H, t, d) and kp, vp (B, H, text, d) (None without
    a prefix), f32."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32)
              for _ in range(4)]
    pfx = [rng.standard_normal((b, h, text, d)).astype(np.float32)
           for _ in range(2)] if text else [None, None]
    return arrays + pfx


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


NAMES = ("dq", "dk", "dv", "dkp", "dvp")

# (kind, lines: grid or text length, prefix tokens, head_dim)
CASES = ([("text", t, 0, d) for t in (20, 256) for d in (16, 64)]
         + [(kind, grid, text, d) for kind in ("axial_row", "axial_col")
            for grid in (6, 10) for text in (0, 20) for d in (16, 64)])


def _line_args(kind, lines):
    """(t, n, grid_side, transpose) of a case."""
    if kind == "text":
        return lines, lines, 0, False
    return lines * lines, lines, lines, kind == "axial_col"


def _close(got, want, what):
    for name, a, w in zip(NAMES, got, want):
        assert (a is None) == (w is None), (what, name)
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(w),
                                       err_msg=f"{what} {name}", **F32)


@pytest.mark.parametrize("kind,lines,text,d", CASES,
                         ids=[f"{c[0]}-{c[1]}-p{c[2]}-d{c[3]}"
                              for c in CASES])
def test_3xtf32_line_attention_within_f32_tolerance(kind, lines, text, d):
    """The forward and backward built from 3xTF32 products against the
    plain f32 versions and the Pallas kernels in interpret mode."""
    t, n, side, transpose = _line_args(kind, lines)
    arrays = _operands(2, 3, t, text, d, seed=t + text + d)
    q, k, v, do, kp, vp = (_torch(a) for a in arrays)
    line = (n, side, transpose)
    out, lse = line_fwd(q, k, v, kp, vp, *line)
    out_p, lse_p = line_attention_plain(q, k, v, kp, vp, *line)
    torch.testing.assert_close(out, out_p, **F32)
    torch.testing.assert_close(lse, lse_p, **F32)
    got = line_bwd(q, k, v, kp, vp, out_p, lse_p, do, *line)
    want = line_attention_bwd_plain(q, k, v, kp, vp, out_p, lse_p, do, *line)
    _close(got, want, "plain")

    jq, jk, jv, jdo, jkp, jvp = (_jax(a) for a in arrays)
    kw = dict(n=n, grid_side=side, transpose=transpose, interpret=True)
    out_j, stats_j = jak._line_attention_fwd(jq, jk, jv, jkp, jvp, **kw)
    lse_j = torch.from_numpy(np.array(stats_j))
    if transpose:   # the TPU kernel keeps axial_col stats column-major
        lse_j = _col_major(lse_j[:, :, 0], side)[:, :, None]
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **F32)
    np.testing.assert_allclose(lse.numpy(), lse_j.numpy(), **F32)
    want_j = jak._line_attention_bwd(jq, jk, jv, jkp, jvp, stats_j, out_j,
                                     jdo, **kw)
    got = line_bwd(q, k, v, kp, vp, torch.from_numpy(np.array(out_j)), lse_j,
                   do, *line)
    _close(got, want_j, "pallas")


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["axial_row", "axial_col"])
def test_3xtf32_line_attention_flagship_slice(transpose):
    """One batch row, two heads of 64 at the flagship's grid and prefix:
    the image call of an axial layer (32 lines of 32 after 256 text
    tokens) against the plain versions."""
    grid = 32
    q, k, v, do, kp, vp = (_torch(a) for a in _operands(
        1, 2, grid * grid, 256, 64, seed=7 + transpose))
    line = (grid, grid, transpose)
    out_p, lse_p = line_attention_plain(q, k, v, kp, vp, *line)
    out, lse = line_fwd(q, k, v, kp, vp, *line)
    torch.testing.assert_close(out, out_p, **F32)
    torch.testing.assert_close(lse, lse_p, **F32)
    got = line_bwd(q, k, v, kp, vp, out_p, lse_p, do, *line)
    want = line_attention_bwd_plain(q, k, v, kp, vp, out_p, lse_p, do, *line)
    _close(got, want, "plain")
