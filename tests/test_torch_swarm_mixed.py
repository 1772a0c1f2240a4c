"""A mixed pair: one JAX node and one port node run the butterfly
all-reduce on loopback, and both end every round with byte-identical
averaged arrays, equal to what an all-JAX pair with the same identities and
inputs ends with.

The JAX node runs its host codec on numpy arrays; the port node hands CPU
tensors to its device codec (the wire kernels' plain versions). The
pinned-codec rounds carry error-feedback residuals through two rounds and
run the pipelined butterfly.
"""

import threading

import numpy as np
import pytest
import torch

from dalle_tpu.swarm import dht as jdht
from dalle_tpu.swarm import error_feedback as jef
from dalle_tpu.swarm import identity as jid
from dalle_tpu.swarm import matchmaking as jmm
from dalle_tpu.swarm.allreduce import run_allreduce as j_allreduce
from dalle_tpu_torch.swarm import compression as tcomp
from dalle_tpu_torch.swarm import dht as tdht
from dalle_tpu_torch.swarm import error_feedback as tef
from dalle_tpu_torch.swarm import identity as tid
from dalle_tpu_torch.swarm import matchmaking as tmm
from dalle_tpu_torch.swarm.allreduce import run_allreduce as t_allreduce

torch.set_num_threads(2)

SHAPES = [(300, 257), (70001,), (33,)]

KINDS = {
    "jax": dict(dht=jdht.DHT, identity=jid.Identity, group=jmm.make_group,
                allreduce=j_allreduce, ef=jef.ErrorFeedback, backend="host",
                tensor=lambda a: a),
    "torch": dict(dht=tdht.DHT, identity=tid.Identity, group=tmm.make_group,
                  allreduce=t_allreduce, ef=tef.ErrorFeedback,
                  backend="device", tensor=torch.from_numpy),
}

CASES = {
    "none": dict(codec=tcomp.NONE),
    "float16": dict(codec=tcomp.FLOAT16),
    "uniform8bit": dict(codec=tcomp.UNIFORM8BIT),
    "size_adaptive": dict(codec=None),
    "pinned8_ef_pipelined": dict(codec=tcomp.UNIFORM8BIT,
                                 gather_codec=tcomp.UNIFORM8BIT,
                                 pin_codec=True, ef=True,
                                 pipeline_hops=True),
    "pinned4_ef_pipelined": dict(codec=tcomp.UNIFORM4BIT,
                                 gather_codec=tcomp.UNIFORM4BIT,
                                 pin_codec=True, ef=True,
                                 pipeline_hops=True),
}


def _inputs(seed, rounds):
    rng = np.random.default_rng(seed)
    return [[[(rng.normal(size=s) * rng.choice([1e-3, 1.0, 30.0])
               ).astype(np.float32) for s in SHAPES] for _ in range(2)]
            for _ in range(rounds)]


def _pair(kinds, pems, prefix, case, inputs, weights):
    """Run ``len(inputs)`` rounds on a fresh pair; per round, per peer, the
    averaged arrays."""
    case = dict(case)
    ef = case.pop("ef", False)
    mods = [KINDS[k] for k in kinds]
    ids = [m["identity"].load_or_create(p) for m, p in zip(mods, pems)]
    first = mods[0]["dht"](identity=ids[0], rpc_timeout=2.0)
    second = mods[1]["dht"](initial_peers=[first.visible_address],
                            identity=ids[1], rpc_timeout=2.0)
    nodes = [first, second]
    efs = [(m["ef"](), m["ef"]()) if ef else (None, None) for m in mods]
    out = []
    try:
        for r, per_peer in enumerate(inputs):
            results = [None, None]
            errors = []

            def peer(i, r=r, per_peer=per_peer):
                try:
                    m = mods[i]
                    g = m["group"](nodes[i], prefix, epoch=r,
                                   weight=weights[i], matchmaking_time=4.0,
                                   min_group_size=2, encrypt=True)
                    assert g is not None and g.size == 2
                    results[i] = m["allreduce"](
                        nodes[i], g, prefix, r,
                        [m["tensor"](a.copy()) for a in per_peer[i]],
                        weight=weights[i], allreduce_timeout=15.0,
                        codec_backend=m["backend"], ef_scatter=efs[i][0],
                        ef_gather=efs[i][1], **case)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=peer, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
            if errors:
                raise errors[0]
            out.append(results)
    finally:
        second.shutdown()
        first.shutdown()
    return out


@pytest.fixture(scope="module")
def pems(tmp_path_factory):
    d = tmp_path_factory.mktemp("ids")
    paths = [str(d / f"peer{i}.pem") for i in range(2)]
    for p in paths:
        jid.Identity.load_or_create(p)
    return paths


@pytest.mark.parametrize("name", sorted(CASES))
def test_mixed_pair_rounds_are_byte_identical(pems, name):
    case = CASES[name]
    rounds = 2 if case.get("ef") else 1
    inputs = _inputs(sorted(CASES).index(name), rounds)
    weights = [3.0, 5.0]
    mixed = _pair(("jax", "torch"), pems, f"mx_{name}", case, inputs,
                  weights)
    ref = _pair(("jax", "jax"), pems, f"mj_{name}", case, inputs, weights)
    for r in range(rounds):
        for peer in range(2):
            for got, want in zip(mixed[r][peer], ref[r][0]):
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
            for got, want in zip(mixed[r][peer], ref[r][1]):
                np.testing.assert_array_equal(got, want)
    if name == "none":
        flat = [np.concatenate([a.reshape(-1) for a in p])
                for p in inputs[0]]
        want = (flat[0] * weights[0] + flat[1] * weights[1]) / sum(weights)
        got = np.concatenate([a.reshape(-1) for a in mixed[0][1]])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_wire_kernel_launch_counts_in_a_round(pems, monkeypatch):
    """The port node's u8 round goes through the ``wire_quantize_u8``
    wrapper (its scatter encode and its part's gather re-encode)."""
    from dalle_tpu_torch.swarm import device_codec
    calls = []
    real = device_codec.wire_quantize_u8

    def counting(x):
        calls.append(x.numel())
        return real(x)

    monkeypatch.setattr(device_codec, "wire_quantize_u8", counting)
    inputs = _inputs(5, 1)
    _pair(("jax", "torch"), pems, "mx_count", CASES["uniform8bit"], inputs,
          [1.0, 1.0])
    total = sum(int(np.prod(s)) for s in SHAPES)
    assert len(calls) >= 1 and max(calls) <= total


# -- the trust plane and PowerSGD across the two packages --------------------

def _audit_pair(kinds, prefix, tamper=None, epoch=0):
    """One u8 round of a mixed pair with every part challenged
    (``audit_frac=1.0``), screening and encryption on; ``tamper`` (peer
    index) makes that owner serve a wrong part after posting its honest
    transcript. Returns (nodes, ras, ledgers, screens, outputs); the
    caller shuts the nodes down."""
    from dalle_tpu.swarm import audit as jaudit
    from dalle_tpu.swarm import health as jhealth
    from dalle_tpu.swarm import screening as jscreen
    from dalle_tpu_torch.swarm import audit as taudit
    from dalle_tpu_torch.swarm import health as thealth
    from dalle_tpu_torch.swarm import screening as tscreen
    trust = {"jax": (jaudit, jhealth, jscreen),
             "torch": (taudit, thealth, tscreen)}
    mods = [KINDS[k] for k in kinds]
    ids = [m["identity"].generate() for m in mods]
    first = mods[0]["dht"](identity=ids[0], rpc_timeout=2.0)
    second = mods[1]["dht"](initial_peers=[first.visible_address],
                            identity=ids[1], rpc_timeout=2.0)
    nodes = [first, second]
    if tamper is not None:
        nodes[tamper].tamper_gather_part = (
            lambda ep, part, values, prefix: values + np.float32(0.25))
    ras, ledgers, screens = [], [], []
    for k in kinds:
        audit, health, screening = trust[k]
        ras.append(audit.RoundAudit(prefix, epoch,
                                    audit.AuditPolicy(frac=1.0,
                                                      fetch_timeout=2.0)))
        ledgers.append(health.PeerHealthLedger())
        screens.append(screening.GradientScreen(screening.ScreenPolicy()))
    inputs = _inputs(17, 1)[0]
    results, errors = [None, None], []

    def peer(i):
        try:
            m = mods[i]
            g = m["group"](nodes[i], prefix, epoch=epoch, weight=4.0,
                           matchmaking_time=3.0, min_group_size=2,
                           encrypt=True)
            assert g is not None and g.size == 2
            results[i] = m["allreduce"](
                nodes[i], g, prefix, epoch,
                [m["tensor"](a.copy()) for a in inputs[i]], weight=4.0,
                allreduce_timeout=15.0, codec=tcomp.UNIFORM8BIT,
                codec_backend=m["backend"], ledger=ledgers[i],
                screen=screens[i], max_peer_weight=16.0, audit=ras[i])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=peer, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    if errors:
        second.shutdown()
        first.shutdown()
        raise errors[0]
    return nodes, ras, ledgers, screens, results, trust


@pytest.mark.parametrize("kinds", [("jax", "torch"), ("torch", "jax")])
def test_mixed_pair_audited_round_is_clean(kinds):
    nodes, ras, ledgers, _, results, trust = _audit_pair(kinds, "mx_aud")
    try:
        for a, b in zip(results[0], results[1]):
            np.testing.assert_array_equal(a, b)
        reports = [trust[k][0].audit_round(nodes[i], ras[i], ledgers[i])
                   for i, k in enumerate(kinds)]
        assert [len(r["audited"]) for r in reports] == [1, 1]
        for rep, led in zip(reports, ledgers):
            assert not (rep["failed"] or rep["unserved"] or rep["omitted"])
            assert led.snapshot() == {}
    finally:
        nodes[1].shutdown()
        nodes[0].shutdown()


@pytest.mark.parametrize("hostile", ["jax", "torch"])
def test_hostile_owner_is_convicted_across_packages(hostile):
    """The hostile owner's wrong part is convicted by the other package's
    auditor (replayed-bytes-mismatch); the proof bundle it builds passes
    BOTH packages' ProofVerifier; and the correction it queues equals,
    byte for byte, the one the JAX package's audit queues on the same
    retention."""
    from dalle_tpu.swarm import audit as jaudit
    from dalle_tpu.swarm import repair as jrepair
    from dalle_tpu.swarm.allreduce import CHUNK_ELEMS
    from dalle_tpu_torch.swarm import audit as taudit
    from dalle_tpu_torch.swarm import repair as trepair
    kinds = (hostile, "torch" if hostile == "jax" else "jax")
    nodes, ras, ledgers, screens, _, trust = _audit_pair(
        kinds, "mx_host", tamper=0)
    try:
        honest = 1
        audit = trust[kinds[honest]][0]
        repair_mod = trepair if kinds[honest] == "torch" else jrepair
        plane = repair_mod.RepairPlane()
        rep = audit.audit_round(nodes[honest], ras[honest],
                                ledgers[honest], repair=plane)
        assert [f["why"] for f in rep["failed"]] \
            == ["replayed-bytes-mismatch"]
        accused = ras[honest].owners[ras[honest].my_part ^ 1].peer_id
        assert accused == nodes[0].peer_id
        assert ledgers[honest].snapshot()[accused] > 0
        part = rep["failed"][0]["part"]
        ra = ras[honest]
        blob = audit.fetch_transcript(nodes[honest], ra.owners[part].addr,
                                      ra.prefix, ra.epoch, part, ra.policy,
                                      group_key=ra.group.group_key)
        proof = audit.build_proof_evidence(ra, part, blob)
        assert proof is not None
        for mod in (taudit, jaudit):
            verifier = mod.ProofVerifier(
                "mx_host", frac=1.0, chunk_elems=CHUNK_ELEMS,
                codec=tcomp.UNIFORM8BIT, screen=screens[honest],
                max_peer_weight=16.0)
            assert verifier(proof, accused, 0) == "mx_host"
        # the other package's audit on the same retention queues the same
        # correction
        other = jaudit if audit is taudit else taudit
        other_plane = (jrepair if other is jaudit else trepair).RepairPlane()
        clone = other.RoundAudit(ra.prefix, ra.epoch, ra.policy)
        clone.__dict__.update({k: v for k, v in ra.__dict__.items()
                               if k != "policy"})
        other.audit_round(nodes[honest], clone, None, repair=other_plane)
        (a,), (b,) = plane.drain(), other_plane.drain()
        assert (a.prefix, a.epoch, a.part, a.owner, a.lo) \
            == (b.prefix, b.epoch, b.part, b.owner, b.lo)
        assert a.served.tobytes() == b.served.tobytes()
        assert a.honest.tobytes() == b.honest.tobytes()
        assert a.honest.tobytes() != a.served.tobytes()
    finally:
        nodes[1].shutdown()
        nodes[0].shutdown()


def test_mixed_powersgd_epoch_has_identical_factor_bytes():
    """A JAX peer and a port peer run one PowerSGD exchange over the real
    butterfly (fp16 factors, the P round then the Q round and the raw
    tail, each audited under its phase prefix): the averaged factor bytes
    are identical on both, and the reconstructions agree within the
    f32 tolerance of tests/test_torch_powersgd.py."""
    from dalle_tpu.swarm import audit as jaudit
    from dalle_tpu.swarm import powersgd as jps
    from dalle_tpu_torch.swarm import audit as taudit
    from dalle_tpu_torch.swarm import powersgd as tps
    kinds = ("jax", "torch")
    mods = [KINDS[k] for k in kinds]
    audits = [jaudit, taudit]
    comps = [jps.PowerSGDCompressor(rank=2),
             tps.PowerSGDCompressor(rank=2, keep_factors_on_device=True)]
    averaging = [jps.average_with_powersgd, tps.average_with_powersgd]
    first = mods[0]["dht"](identity=mods[0]["identity"].generate(),
                           rpc_timeout=2.0)
    second = mods[1]["dht"](initial_peers=[first.visible_address],
                            identity=mods[1]["identity"].generate(),
                            rpc_timeout=2.0)
    nodes = [first, second]
    rng = np.random.default_rng(23)
    grads = [[rng.normal(size=s).astype(np.float32)
              for s in ((96, 64), (40, 30), (50,))] for _ in range(2)]
    seen = [{}, {}]
    outs, errors, ras = [None, None], [], [[], []]

    def peer(i):
        m = mods[i]

        def reduce_fn(tensors, phase):
            prefix = f"mx_psgd_grads_{phase}"
            g = m["group"](nodes[i], prefix, epoch=3, weight=2.0,
                           matchmaking_time=3.0, min_group_size=2,
                           encrypt=True)
            assert g is not None and g.size == 2
            ra = audits[i].RoundAudit(prefix, 3, audits[i].AuditPolicy(
                frac=1.0, fetch_timeout=2.0))
            ras[i].append(ra)
            rep = {}
            out = m["allreduce"](nodes[i], g, prefix, 3, tensors,
                                 weight=2.0, allreduce_timeout=15.0,
                                 codec=tcomp.FLOAT16, report=rep,
                                 codec_backend=m["backend"], audit=ra)
            assert rep["complete"]
            seen[i][phase] = [np.array(a, copy=True) for a in out]
            return out

        try:
            leaves = [m["tensor"](a.copy()) for a in grads[i]]
            outs[i] = averaging[i](comps[i], leaves, reduce_fn, epoch=3)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=peer, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if errors:
            raise errors[0]
        for phase in ("p", "q"):
            assert len(seen[0][phase]) == len(seen[1][phase])
            for a, b in zip(seen[0][phase], seen[1][phase]):
                assert a.tobytes() == b.tobytes()
        for i in range(2):
            rep = audits[i].audit_round(nodes[i], ras[i][0], None)
            assert len(rep["audited"]) == 1 and not rep["failed"]
        for a, b in zip(outs[1], outs[0]):
            got = a.numpy() if isinstance(a, torch.Tensor) else a
            want = np.asarray(b)
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * scale)
    finally:
        second.shutdown()
        first.shutdown()
