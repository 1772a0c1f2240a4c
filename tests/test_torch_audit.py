"""Verified aggregation in the port (dalle_tpu_torch/swarm/audit.py)
against the JAX package's (dalle_tpu/swarm/audit.py).

Two live 5-peer rounds on loopback, one of port nodes and one of JAX
nodes, with the same identities and inputs and every part challenged:
the owners' signed transcripts are byte-identical across the two
packages, each package opens and replays the other's, the lying
mutations and the fabricated self-contribution of the JAX package's
tests are refused with the same verdict by both replays, and the honest
rounds audit clean. The challenge function and the evidence bundles are
held equal too.
"""

import threading

import numpy as np
import pytest
import torch

from dalle_tpu.swarm import audit as jaudit
from dalle_tpu.swarm import dht as jdht
from dalle_tpu.swarm import identity as jid
from dalle_tpu.swarm import matchmaking as jmm
from dalle_tpu.swarm import screening as jscreen
from dalle_tpu.swarm.allreduce import run_allreduce as j_allreduce
from dalle_tpu.swarm.health import PeerHealthLedger as JLedger
from dalle_tpu_torch.swarm import audit as taudit
from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm import dht as tdht
from dalle_tpu_torch.swarm import identity as tid
from dalle_tpu_torch.swarm import matchmaking as tmm
from dalle_tpu_torch.swarm import screening as tscreen
from dalle_tpu_torch.swarm.allreduce import run_allreduce as t_allreduce
from dalle_tpu_torch.swarm.health import PeerHealthLedger as TLedger
from dalle_tpu_torch.utils import msgpack

torch.set_num_threads(2)

PREFIX = "tr"
N = 5

KINDS = {
    "torch": dict(dht=tdht.DHT, identity=tid, group=tmm.make_group,
                  allreduce=t_allreduce, audit=taudit, ledger=TLedger,
                  screen=tscreen, tensor=torch.from_numpy,
                  backend="device"),
    "jax": dict(dht=jdht.DHT, identity=jid, group=jmm.make_group,
                allreduce=j_allreduce, audit=jaudit, ledger=JLedger,
                screen=jscreen, tensor=lambda a: a, backend="host"),
}


@pytest.mark.parametrize("prefix, epoch, n_parts, frac", [
    ("p", 0, 5, 1.0), ("p", 0, 5, 0.0), ("p", 0, 0, 1.0),
    ("p", 3, 64, 0.25), ("run_grads", 11, 2, 0.25),
    ("run_grads_q", 7, 16, 0.5), ("run_state", 2, 100, 0.05)])
def test_challenged_parts_equal_jax(prefix, epoch, n_parts, frac):
    assert (taudit.challenged_parts(prefix, epoch, n_parts, frac)
            == jaudit.challenged_parts(prefix, epoch, n_parts, frac))
    for p in (prefix, prefix + "_p", prefix + "_state", ""):
        assert taudit.phase_of_prefix(p) == jaudit.phase_of_prefix(p)
    assert (taudit._audit_tag(prefix, epoch, n_parts, 1)
            == jaudit._audit_tag(prefix, epoch, n_parts, 1))


def _inputs(seed=9, size=400):
    rng = np.random.RandomState(seed)
    base = rng.randint(-8, 9, size=size).astype(np.float32)
    return [[base + i] for i in range(N)]


def _round(kind, base=71):
    """One audited 5-peer round; returns (nodes, ras, ledgers, screen)."""
    m = KINDS[kind]
    nodes = []
    for i in range(N):
        peers = [nodes[0].visible_address] if nodes else []
        ident = m["identity"].Identity(
            m["identity"].Ed25519PrivateKey.from_private_bytes(
                bytes([base + i]) * 32))
        nodes.append(m["dht"](initial_peers=peers, identity=ident,
                              rpc_timeout=2.0))
    screen = m["screen"].GradientScreen(m["screen"].ScreenPolicy())
    policy = m["audit"].AuditPolicy(frac=1.0, fetch_timeout=2.0)
    ledgers = [m["ledger"]() for _ in range(N)]
    ras = [m["audit"].RoundAudit(PREFIX, 0, policy) for _ in range(N)]
    tensors = _inputs()
    errors = []

    def peer(i):
        try:
            g = m["group"](nodes[i], PREFIX, epoch=0, weight=1.0,
                           matchmaking_time=2.0, min_group_size=N)
            assert g is not None and g.size == N
            m["allreduce"](nodes[i], g, PREFIX, 0,
                           [m["tensor"](a.copy()) for a in tensors[i]],
                           weight=1.0, allreduce_timeout=8.0,
                           sender_timeout=1.5, codec=compression.NONE,
                           ledger=ledgers[i], screen=screen,
                           max_peer_weight=100.0, audit=ras[i],
                           codec_backend=m["backend"])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=peer, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        for nd in nodes:
            nd.shutdown()
        raise errors[0]
    return nodes, ras, ledgers, screen


@pytest.fixture(scope="module")
def rounds():
    out = {kind: _round(kind) for kind in ("torch", "jax")}
    yield out
    for nodes, *_ in out.values():
        for nd in nodes:
            nd.shutdown()


def _owner(nodes, ras, part):
    i = next(i for i, ra in enumerate(ras) if ra.my_part == part)
    return i, nodes[i], ras[i]


def _replay_kwargs(ra, screen):
    return dict(group=ra.group, prefix=ra.prefix, epoch=ra.epoch,
                part=ra.my_part, part_elems=ra.part_sizes[ra.my_part],
                chunk_elems=ra.chunk_elems, codec=ra.codec,
                adaptive_threshold=ra.adaptive_threshold, screen=screen,
                max_peer_weight=100.0)


@pytest.mark.parametrize("part", range(N))
def test_transcripts_are_byte_identical_and_cross_open(rounds, part):
    tnodes, tras, _, tscr = rounds["torch"]
    jnodes, jras, _, jscr = rounds["jax"]
    _, tnode, tra = _owner(tnodes, tras, part)
    _, jnode, jra = _owner(jnodes, jras, part)
    assert tra.audits_mine and tra.posted and jra.posted
    tblob = tra.build_transcript(tnode.identity)
    jblob = jra.build_transcript(jnode.identity)
    assert tblob == jblob
    # the JAX serializer on the port's retention gives the same bytes
    clone = jaudit.RoundAudit(PREFIX, 0)
    clone.__dict__.update(tra.__dict__)
    assert clone.build_transcript(tnode.identity) == tblob
    owner = tra.owners[part].peer_id
    opened = [mod.open_transcript(blob, PREFIX, 0, part, owner)
              for mod in (taudit, jaudit) for blob in (tblob, jblob)]
    assert all(o == opened[0] for o in opened) and opened[0] is not None
    # each package replays the other's transcript to the gathered bytes
    for mod, ra, scr in ((taudit, jra, jscr), (jaudit, tra, tscr)):
        res = mod.replay_transcript(opened[0], **_replay_kwargs(ra, scr))
        assert res.ok, res.why
        for other in (tras + jras):
            if part in other.gathered:
                assert res.values.tobytes() \
                    == other.gathered[part].tobytes()


def _mutated(mod, node, ra, mutate):
    """The owner's own transcript, mutated and re-signed with the owner's
    real identity (what a lying owner can do), opened by ``mod``."""
    blob = ra.build_transcript(node.identity)
    tr = mod.open_transcript(blob, ra.prefix, ra.epoch, ra.my_part,
                             ra.owners[ra.my_part].peer_id)
    raw = {"v": 1, "epoch": ra.epoch, "part": ra.my_part,
           "init": tr["init"], "order": list(tr["order"]),
           "drops": {str(k): v for k, v in tr["drops"].items()},
           "evidence": {str(k): v for k, v in tr["evidence"].items()},
           "frames": {str(k): v for k, v in tr["frames"].items()}}
    mutate(raw)
    from dalle_tpu_torch.swarm.identity import signed_frame
    forged = signed_frame(node.identity,
                          taudit._audit_ctx(ra.prefix, ra.epoch, ra.my_part),
                          b"", msgpack.packb(raw, use_bin_type=True))
    return mod.open_transcript(forged, ra.prefix, ra.epoch, ra.my_part,
                               ra.owners[ra.my_part].peer_id)


def _fake_corrupt(r):
    s = r["order"].pop()
    r["frames"].pop(str(s), None)
    r["drops"][str(s)] = "corrupt-chunk"


def _fake_screen_drop(r):
    s = r["order"].pop()
    r["drops"][str(s)] = "screen-outlier"


MUTATIONS = {
    "duplicate-sender-in-order":
        lambda r: r["order"].append(r["order"][0]),
    "sender-both-applied-and-dropped": lambda r: r["drops"].update(
        {str(r["order"][0]): "screen-outlier"}),
    "unevidenced-corrupt-drop": _fake_corrupt,
    "screen-replay-mismatch": _fake_screen_drop,
    "wrong-init": lambda r: r.update(init="zeros"),
    "applied-sender-missing-frames":
        lambda r: r["frames"].pop(str(r["order"][0])),
}


@pytest.mark.parametrize("why", sorted(MUTATIONS))
def test_lying_mutations_are_refused_like_jax(rounds, why):
    nodes, ras, _, screen = rounds["torch"]
    _, node, ra = _owner(nodes, ras, 0)
    kw = _replay_kwargs(ra, screen)
    got = [mod.replay_transcript(_mutated(mod, node, ra, MUTATIONS[why]),
                                 **kw) for mod in (taudit, jaudit)]
    assert [(r.ok, r.why) for r in got] == [(False, why)] * 2


def test_dropped_self_frames_replay_to_other_bytes(rounds):
    """Without its self frames the transcript replays coherently as "the
    owner contributed nothing", so the served bytes disagree: the
    byte-compare's catch, in both packages alike."""
    nodes, ras, _, screen = rounds["torch"]
    _, node, ra = _owner(nodes, ras, 1)
    kw = _replay_kwargs(ra, screen)

    def no_self(r):
        r["init"] = "zeros"
        r["frames"].pop(str(ra.group.my_index), None)

    for mod in (taudit, jaudit):
        res = mod.replay_transcript(_mutated(mod, node, ra, no_self), **kw)
        honest = mod.replay_transcript(
            _mutated(mod, node, ra, lambda r: None), **kw)
        assert res.ok and honest.ok
        assert res.values.tobytes() != honest.values.tobytes()


def test_fabricated_self_contribution_is_caught_like_jax(rounds):
    from dalle_tpu_torch.swarm.allreduce import (_chunk_slices, _make_frame,
                                                 _sign_ctx)
    nodes, ras, _, screen = rounds["torch"]
    _, node, ra = _owner(nodes, ras, 2)
    n = ra.part_sizes[ra.my_part]
    chunks = _chunk_slices(n, ra.chunk_elems)
    ctx = _sign_ctx(ra.prefix, ra.epoch, "scatter",
                    ra.owners[ra.my_part].peer_id)
    fake = np.ones(n, np.float32) * 1000.0

    def swap_self(r):
        r["frames"][str(ra.group.my_index)] = [
            _make_frame(node.identity, ctx, ra.group.group_hash,
                        ra.group.my_index, 1.0, chi - clo,
                        compression.NONE,
                        compression.compress(fake[clo:chi],
                                             compression.NONE),
                        chunk=ci, n_chunks=len(chunks))
            for ci, (clo, chi) in enumerate(chunks)]

    for mod in (taudit, jaudit):
        res = mod.replay_transcript(_mutated(mod, node, ra, swap_self),
                                    **_replay_kwargs(ra, screen))
        assert not res.ok and res.why == "screen-replay-mismatch"
        assert ra.group.my_index in res.screen_drops


def test_honest_rounds_audit_clean_in_both_packages(rounds):
    for kind, mod in (("torch", taudit), ("jax", jaudit)):
        nodes, ras, ledgers, _ = rounds[kind]
        reports = [mod.audit_round(nodes[i], ras[i], ledgers[i])
                   for i in range(N)]
        for rep, led in zip(reports, ledgers):
            assert len(rep["audited"]) == N - 1, (kind, rep)
            assert not (rep["failed"] or rep["unserved"]
                        or rep["omitted"]), (kind, rep)
            assert led.snapshot() == {}


def test_proof_evidence_bundles_are_byte_identical(rounds):
    """The evidence a conviction would ship: the port's bundle equals the
    JAX package's on the same retention, and both packages' verifiers
    refuse it (the served bytes match the replay: no contradiction)."""
    from dalle_tpu.swarm.allreduce import CHUNK_ELEMS
    nodes, ras, _, screen = rounds["torch"]
    ra = next(r for r in ras if r.my_part != 3)
    owner_i, onode, ora = _owner(nodes, ras, 3)
    blob = ora.build_transcript(onode.identity)
    clone = jaudit.RoundAudit(PREFIX, 0)
    clone.__dict__.update(ra.__dict__)
    tbundle = taudit.build_proof_evidence(ra, 3, blob)
    assert tbundle is not None
    assert tbundle == jaudit.build_proof_evidence(clone, 3, blob)
    for mod in (taudit, jaudit):
        verifier = mod.ProofVerifier(PREFIX, frac=1.0,
                                     chunk_elems=CHUNK_ELEMS,
                                     codec=compression.NONE, screen=screen,
                                     max_peer_weight=100.0)
        assert verifier(tbundle, ra.owners[3].peer_id, 0) is None
        assert verifier.rejected == 1


def test_audit_worker_drains_and_stops():
    worker = taudit.AuditWorker(None, None, period=0.05)
    worker.start()
    ra = taudit.RoundAudit("w", 0)   # never begun: ignored
    worker.submit(ra)
    worker.stop()
    assert not worker.is_alive()
    assert worker.counters()["audited"] == 0
