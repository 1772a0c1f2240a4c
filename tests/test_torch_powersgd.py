"""PowerSGD in the port (dalle_tpu_torch/swarm/powersgd.py) against the
JAX package's (dalle_tpu/swarm/powersgd.py).

The host pieces are bitwise equal: ``orthogonalize`` (the default basis
step), the epoch-seeded Q and the plan. The device products — ``(M+e) @ Q``,
``(M+e)^T @ P_orth``, the reconstruction ``P_orth @ Q_avg^T`` and the error
feedback ``e = M - G`` — are each framework's own f32 matmul, held within
``REL_TOL`` of the largest magnitude of the JAX result: the JAX package
accepts the same difference across XLA builds, and the averaged factor
bytes that cross the wire stay identical (test_torch_swarm_mixed.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.swarm import powersgd as jps
from dalle_tpu_torch.swarm import powersgd as tps

torch.set_num_threads(2)

#: f32 products of up to a few hundred terms in another summation order
REL_TOL = 1e-5

SHAPES = [(48, 40), (16, 6, 5), (37,), (3, 100), (64, 3)]


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", ["gaussian", "tall", "rank_deficient",
                                  "tiny_values", "zero_column"])
def test_orthogonalize_is_bitwise_equal(case):
    rng = np.random.RandomState(["gaussian", "tall", "rank_deficient",
                                 "tiny_values", "zero_column"].index(case))
    p = {"gaussian": lambda: rng.randn(32, 4),
         "tall": lambda: rng.randn(4096, 4) * 1e-3,
         "rank_deficient": lambda: np.ones((64, 1)) @ np.array(
             [[2.0, 3.0, 4.0]]),
         "tiny_values": lambda: rng.randn(50, 3) * 1e-30,
         "zero_column": lambda: np.concatenate(
             [rng.randn(20, 2), np.zeros((20, 1))], axis=1)}[case]()
    p = p.astype(np.float32)
    got, want = tps.orthogonalize(p), jps.orthogonalize(p)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_q_and_plan_are_equal():
    leaves = [np.zeros(s, np.float32) for s in
              [(256, 128), (64,), (3, 3), (8, 1000), (1024, 4), (5, 6, 7)]]
    for rank, ratio in ((4, 0.5), (2, 10.0), (6, 0.5)):
        tc = tps.PowerSGDCompressor(rank=rank, seed=3, min_ratio=ratio)
        jc = jps.PowerSGDCompressor(rank=rank, seed=3, min_ratio=ratio)
        tplans, jplans = tc.plan(leaves), jc.plan(leaves)
        assert [(p.index, p.shape, p.m, p.n) for p in tplans] \
            == [(p.index, p.shape, p.m, p.n) for p in jplans]
        for tp_, jp_ in zip(tplans, jplans):
            for epoch in (0, 1, 17):
                assert (tc._q_for(tp_, epoch).tobytes()
                        == jc._q_for(jp_, epoch).tobytes())


def _lockstep(comps, grads, epoch, mean):
    """One factor exchange among ``comps`` (each with its peer's grads),
    the averages given by ``mean``; returns every stage's outputs."""
    plans = [c.plan(g) for c, g in zip(comps, grads)]
    ps = [c.phase1_ps(g, p, epoch) for c, g, p in zip(comps, grads, plans)]
    avg_ps = mean(ps)
    qs = [c.phase2_qs(p, avg_ps) for c, p in zip(comps, plans)]
    avg_qs = mean(qs)
    outs = [c.reconstruct(list(g), p, avg_qs)
            for c, g, p in zip(comps, grads, plans)]
    return ps, avg_ps, qs, avg_qs, outs


def _mean(factors):
    return [sum(np.asarray(f[i], np.float32) for f in factors)
            / np.float32(len(factors)) for i in range(len(factors[0]))]


def _grads(rng, n=2):
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES]
            for _ in range(n)]


def test_full_rank_is_the_exact_mean_and_peers_agree():
    rng = np.random.RandomState(0)
    grads = [[rng.randn(16, 6).astype(np.float32),
              rng.randn(8).astype(np.float32)] for _ in range(2)]
    comps = [tps.PowerSGDCompressor(rank=6, min_ratio=10.0)
             for _ in range(2)]
    *_, outs = _lockstep(comps, [[torch.from_numpy(a) for a in g]
                                 for g in grads], 0, _mean)
    want = (grads[0][0] + grads[1][0]) / 2
    np.testing.assert_allclose(outs[0][0].numpy(), want, rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("host_orth", [True, False])
def test_factors_and_reconstruction_match_jax(host_orth):
    """Three epochs of a two-peer exchange, the port's compressors and the
    JAX package's side by side. Each stage is fed the SAME averaged bytes
    (JAX's), as the wire does in a mixed pair: then P_orth is bitwise
    equal under host MGS, and every product is within REL_TOL."""
    rng = np.random.RandomState(1)
    tcomps = [tps.PowerSGDCompressor(rank=3, host_orthogonalize=host_orth)
              for _ in range(2)]
    jcomps = [jps.PowerSGDCompressor(rank=3, host_orthogonalize=host_orth)
              for _ in range(2)]
    for epoch in range(3):
        grads = _grads(rng)
        jplans = [c.plan(g) for c, g in zip(jcomps, grads)]
        tplans = [c.plan(g) for c, g in zip(tcomps, grads)]
        jps_ = [c.phase1_ps(g, p, epoch)
                for c, g, p in zip(jcomps, grads, jplans)]
        tps_ = [c.phase1_ps([torch.from_numpy(a) for a in g], p, epoch)
                for c, g, p in zip(tcomps, grads, tplans)]
        for t, j in zip(tps_, jps_):
            for a, b in zip(t, j):
                _close(a, b, f"P epoch {epoch}")
        avg_p = _mean(jps_)
        jqs = [c.phase2_qs(p, avg_p) for c, p in zip(jcomps, jplans)]
        tqs = [c.phase2_qs(p, avg_p) for c, p in zip(tcomps, tplans)]
        for plan in tplans[0]:
            po_t = tcomps[0]._p_orth[plan.index].numpy()
            po_j = np.asarray(jcomps[0]._p_orth[plan.index])
            if host_orth:
                assert po_t.tobytes() == po_j.tobytes()
            else:
                _close(po_t, po_j, "device P_orth")
        for t, j in zip(tqs, jqs):
            for a, b in zip(t, j):
                _close(a, b, f"Q epoch {epoch}")
        avg_q = _mean(jqs)
        jouts = [c.reconstruct(list(g), p, avg_q)
                 for c, g, p in zip(jcomps, grads, jplans)]
        touts = [c.reconstruct([torch.from_numpy(a) for a in g], p, avg_q)
                 for c, g, p in zip(tcomps, grads, tplans)]
        for plan in tplans[0]:
            for k in range(2):
                _close(touts[k][plan.index], jouts[k][plan.index],
                       f"reconstruction epoch {epoch}")
                _close(tcomps[k]._errors[plan.index],
                       jcomps[k]._errors[plan.index],
                       f"error feedback epoch {epoch}")


def test_device_orthogonalize_zeroes_dependent_columns():
    rank1 = np.ones((64, 1), np.float32) @ np.array([[2., 3., 4.]],
                                                    np.float32)
    got = tps.orthogonalize_device(torch.from_numpy(rank1)).numpy()
    want = np.asarray(jps._orthogonalize_dev(jnp.asarray(rank1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[:, 1:] == 0.0)


def test_error_feedback_recovers_lost_mass():
    """A rank-1 compressor on a rank-2 gradient loses mass each round;
    error feedback makes the running mean of the outputs converge to the
    gradient (the JAX package's test, on the port)."""
    rng = np.random.RandomState(1)
    u1, v1 = rng.randn(32, 1), rng.randn(1, 24)
    u2, v2 = rng.randn(32, 1), rng.randn(1, 24)
    grad = torch.from_numpy((u1 @ v1 + 0.3 * u2 @ v2).astype(np.float32))

    def ident(tensors, phase):
        return [np.array(t, copy=True) for t in tensors]

    def run(feedback):
        comp = tps.PowerSGDCompressor(rank=1, min_ratio=10.0)
        outs = []
        for r in range(12):
            if not feedback:
                comp._errors.clear()
            outs.append(tps.average_with_powersgd(comp, [grad], ident,
                                                  epoch=r)[0])
        return outs

    outs = run(True)
    err1 = float(torch.linalg.norm(grad - outs[0]))
    assert err1 > 0.1
    cum_err = float(torch.linalg.norm(torch.stack(outs).mean(0) - grad))
    nofb_err = float(torch.linalg.norm(torch.stack(run(False)).mean(0)
                                       - grad))
    assert cum_err < 0.25 * err1
    assert cum_err < 0.5 * nofb_err


def test_average_with_powersgd_matches_jax_and_keeps_device_tensors():
    rng = np.random.RandomState(4)
    grads = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    wire = []

    def reduce_fn(tensors, phase):
        wire.append((phase, [np.asarray(t).shape for t in tensors]))
        assert all(isinstance(t, np.ndarray) for t in tensors)
        return [np.array(t, copy=True) for t in tensors]

    tcomp = tps.PowerSGDCompressor(rank=2)
    tout = tps.average_with_powersgd(tcomp, [torch.from_numpy(g)
                                             for g in grads], reduce_fn, 5)
    twire, wire[:] = list(wire), []
    jout = jps.average_with_powersgd(jps.PowerSGDCompressor(rank=2), grads,
                                     reduce_fn, 5)
    assert twire == wire
    planned = {p.index for p in tcomp.plan(grads)}
    for i, (t, j) in enumerate(zip(tout, jout)):
        if i in planned:
            assert isinstance(t, torch.Tensor)
            _close(t, j, f"leaf {i}")
        else:
            assert isinstance(t, np.ndarray)
            assert t.tobytes() == np.asarray(j).tobytes()
    assert all(isinstance(e, torch.Tensor) for e in tcomp._errors.values())


def test_incomplete_round_falls_back_to_local_grads():
    grad = torch.from_numpy(
        np.random.RandomState(3).randn(32, 24).astype(np.float32))
    comp = tps.PowerSGDCompressor(rank=2, min_ratio=10.0)

    def dying(tensors, phase):
        raise tps.IncompleteRound(phase)

    out = tps.average_with_powersgd(comp, [grad], dying, epoch=0)
    assert torch.equal(out[0], grad)
    assert not comp._errors and not comp._mat_cache


def test_factors_stay_on_the_device_when_asked():
    comp = tps.PowerSGDCompressor(rank=4, keep_factors_on_device=True)
    leaves = [torch.ones(256, 128), torch.ones(8)]
    seen = []

    def reduce_fn(tensors, phase):
        seen.append([type(t) for t in tensors])
        return [t.numpy().copy() for t in tensors]

    out = tps.average_with_powersgd(comp, leaves, reduce_fn, epoch=0)
    assert seen == [[torch.Tensor], [torch.Tensor, torch.Tensor]]
    torch.testing.assert_close(out[0], leaves[0], rtol=1e-5, atol=1e-5)
