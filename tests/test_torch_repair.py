"""Round repair in the port (dalle_tpu_torch/swarm/repair.py) against the
JAX package's (dalle_tpu/swarm/repair.py): ``apply_flat_correction`` gives
the same bytes and the same verdict on numpy leaves and on tensors (the
port's averaged gradients may live on the card, where only the
correction's window is touched), the plane's counters move alike, and the
audit worker's byte-bounded ring evicts alike.
"""

import numpy as np
import pytest
import torch

from dalle_tpu.swarm import audit as jaudit
from dalle_tpu.swarm import repair as jrepair
from dalle_tpu_torch.swarm import audit as taudit
from dalle_tpu_torch.swarm import repair as trepair

torch.set_num_threads(2)

SHAPES = [(3, 5), (7,), (2, 2, 4), (1,)]
TOTAL = sum(int(np.prod(s)) for s in SHAPES)


def _action(mod, rng, lo, n, served_from=None, prefix="run_grads",
            epoch=0, part=0):
    served = (served_from[lo:lo + n].copy() if served_from is not None
              else rng.normal(size=n).astype(np.float32))
    honest = rng.normal(size=n).astype(np.float32)
    return mod.RepairAction(prefix=prefix, epoch=epoch, part=part,
                            owner="ab" * 32, lo=lo, served=served,
                            honest=honest)


def _leaves(rng):
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _flat(leaves):
    return np.concatenate([np.asarray(a).reshape(-1) for a in leaves])


# (lo, n, window holds the served bytes): inside a leaf, across leaf
# boundaries, the whole vector, a stale window, an alien overrun
CASES = {
    "exact_inside_leaf": (1, 3, True),
    "exact_across_leaves": (12, 10, True),
    "exact_whole_vector": (0, TOTAL, True),
    "stale_across_leaves": (10, 9, False),
    "stale_last_element": (TOTAL - 1, 1, False),
    "alien_overrun": (TOTAL - 2, 5, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("leaf_kind", ["numpy", "tensor"])
def test_apply_flat_correction_matches_jax(name, leaf_kind):
    lo, n, exact = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    base = _leaves(rng)
    flat = _flat(base)
    arng = np.random.default_rng(7)
    ja = _action(jrepair, arng, lo, n,
                 served_from=flat if exact else None)
    ta = trepair.RepairAction(**{k: getattr(ja, k) for k in (
        "prefix", "epoch", "part", "owner", "lo", "served", "honest")})
    jleaves = [a.copy() for a in base]
    want = jrepair.apply_flat_correction(jleaves, ja)
    if leaf_kind == "numpy":
        tleaves = [a.copy() for a in base]
    else:
        tleaves = [torch.from_numpy(a.copy()) for a in base]
    ptrs = [t.data_ptr() for t in tleaves] if leaf_kind == "tensor" else []
    got = trepair.apply_flat_correction(tleaves, ta)
    assert got is want
    assert _flat([np.asarray(t) for t in tleaves]).tobytes() \
        == _flat(jleaves).tobytes()
    if leaf_kind == "tensor":
        # patched in place: the gradient tensors were never replaced
        assert [t.data_ptr() for t in tleaves] == ptrs
    if want is None:
        assert _flat([np.asarray(t) for t in tleaves]).tobytes() \
            == flat.tobytes()


def test_second_application_compensates_as_jax_does():
    rng = np.random.default_rng(3)
    base = _leaves(rng)
    ja = _action(jrepair, rng, 4, 9, served_from=_flat(base))
    ta = trepair.RepairAction(**vars(ja))
    jl = [a.copy() for a in base]
    tl = [torch.from_numpy(a.copy()) for a in base]
    for _ in range(2):
        assert (trepair.apply_flat_correction(tl, ta)
                is jrepair.apply_flat_correction(jl, ja))
    assert _flat([t.numpy() for t in tl]).tobytes() == _flat(jl).tobytes()


def test_non_contiguous_tensor_is_refused():
    t = torch.zeros(4, 4).t()
    a = trepair.RepairAction(prefix="p", epoch=0, part=0, owner="x", lo=0,
                             served=np.zeros(2, np.float32),
                             honest=np.ones(2, np.float32))
    with pytest.raises(ValueError, match="contiguous"):
        trepair.apply_flat_correction([t], a)


def _plane_script(mod, plane_kwargs):
    """Submits, scoped drains and applies, returning the snapshots, the
    landed counts and the target bytes after each apply."""
    rng = np.random.default_rng(11)
    plane = mod.RepairPlane(**plane_kwargs)
    target = rng.normal(size=TOTAL).astype(np.float32)
    out = []
    prefixes = ["run_grads", "run_grads_p", "run_state", "other"]
    for e in range(5):
        for p in prefixes:
            lo = int(rng.integers(0, TOTAL - 4))
            exact = bool(rng.integers(0, 2))
            plane.submit(_action(mod, rng, lo, 4,
                                 served_from=target if exact else None,
                                 prefix=p, epoch=e))
        out.append(dict(plane.snapshot(),
                        pending_grads=plane.pending("run_grads")))
        landed = plane.apply([target], prefix="run_grads")
        out.append((landed, target.tobytes()))
        out.append([a.epoch for a in plane.drain("run_state")])
    out.append(plane.apply([target]))
    out.append((plane.snapshot(), target.tobytes()))
    return out


@pytest.mark.parametrize("plane_kwargs", [
    dict(),
    dict(accept_prefix=("run_grads", "run_grads_p", "run_state")),
    dict(accept_prefix="run_grads", max_actions=3),
], ids=["all", "aux_prefixes", "one_prefix_overflow"])
def test_plane_counters_match_jax(plane_kwargs):
    assert (_plane_script(trepair, plane_kwargs)
            == _plane_script(jrepair, plane_kwargs))


def _ring_script(mod):
    w = mod.AuditWorker(None, None, max_bytes=100)
    sizes = [40, 40, 30, 500, 10, 1, 1, 1, 1, 1, 1, 1]
    for e, n in enumerate(sizes):
        ra = mod.RoundAudit("ring", e)
        ra.begun = e != 5
        ra.evidence[0] = b"x" * n
        ra.gathered = {1: np.zeros(e, np.float32)}
        w.submit(ra)
    with w._lock:
        pending = ([r.epoch for r in w._pending], w._pending_bytes)
    return pending, w.counters()


def test_retained_bytes_and_ring_eviction_match_jax():
    for mod in (jaudit, taudit):
        ra = mod.RoundAudit("rb", 0)
        ra.frames = {1: {0: b"abcd"}, 2: {0: b"x", 1: b"yz"}}
        ra.evidence = {2: b"ee"}
        ra.self_frames = [b"fff"]
        ra.gathered = {0: np.zeros(4, np.float32)}
        ra.gather_frames = {0: {0: b"gg"}}
        assert ra.retained_bytes() == 4 + 3 + 2 + 3 + 16 + 2
    assert _ring_script(taudit) == _ring_script(jaudit)
    # the port's worker also records its peak retention
    w = taudit.AuditWorker(None, None, max_bytes=100)
    ra = taudit.RoundAudit("ring", 0)
    ra.begun = True
    ra.evidence[0] = b"x" * 60
    w.submit(ra)
    assert w.timing() == {"rounds": 0, "busy_s": 0.0, "retained_peak": 60,
                          "fetch_s": 0.0, "open_s": 0.0, "replay_s": 0.0}
