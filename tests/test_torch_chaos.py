"""The port's fault injector (``dalle_tpu_torch/swarm/chaos.py``) against the
JAX package's (``dalle_tpu/swarm/chaos.py``), mirroring
``tests/test_chaos.py``:

- the plan: JSON round trip (inline and file), unknown ops and keys
  refused, ``maybe_wrap`` transparent without a plan;
- the wrapper on a stub transport: inert rules forward byte-identically,
  the same seed gives the same schedule, corrupt and truncate, a dropped
  send still acks, peer patterns, blackouts, crash at epoch, time windows;
- one decision trace of both copies for one plan and one call sequence
  (every transport op, injected sleeps, counters) and the byzantine seams'
  tampered arrays: equal, exactly;
- on real loopback port DHTs: a wrapped round byte-identical to a raw one,
  and a corrupt sender struck while the round completes over the honest
  peers.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dalle_tpu.swarm import chaos as jchaos
from dalle_tpu_torch.swarm import chaos as tchaos
from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm.allreduce import (_part_slices, flatten_tensors,
                                             run_allreduce)
from dalle_tpu_torch.swarm.chaos import (Blackout, ChaosDHT, FaultPlan,
                                         FaultRule, maybe_wrap)
from dalle_tpu_torch.swarm.dht import DHT, get_dht_time
from dalle_tpu_torch.swarm.health import PeerHealthLedger
from dalle_tpu_torch.swarm.identity import Ed25519PrivateKey, Identity
from dalle_tpu_torch.swarm.matchmaking import make_group

torch.set_num_threads(2)


class _StubDHT:
    """A transport double that records what reaches the 'wire'."""

    peer_id = "ab" * 32

    def __init__(self):
        self.sent, self.posted, self.stored = [], [], []
        self.inbox, self.mailbox, self.records = {}, {}, {}

    def send(self, addr, tag, payload, timeout=None):
        self.sent.append((addr, tag, payload))
        return True

    def recv(self, tag, timeout):
        return self.inbox.get(tag)

    def fetch(self, addr, tag, timeout=None):
        return self.mailbox.get((addr, tag))

    def post(self, tag, payload, expiration_time):
        self.posted.append((tag, payload))
        return True

    def store(self, key, subkey, value, expiration_time):
        self.stored.append((key, subkey, value))
        return True

    def get(self, key, latest=True):
        return self.records.get(key)

    def shutdown(self):
        pass


def _wrap(plan, clock=None, module=tchaos):
    stub = _StubDHT()
    kwargs = {"clock": clock} if clock is not None else {}
    return stub, module.ChaosDHT(stub, plan, **kwargs)


# -- the plan -------------------------------------------------------------

def test_plan_json_round_trip_inline_and_file(tmp_path):
    plan = FaultPlan(
        seed=7, rules=(FaultRule(ops=("send",), drop=0.25,
                                 delay_s=(0.1, 0.2), peers=("beef",)),),
        blackouts=(Blackout(start_s=1.0, end_s=2.0),), crash_at_epoch=5)
    assert FaultPlan.from_json(plan.to_json()) == plan
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert FaultPlan.load(str(path)) == plan
    assert FaultPlan.load(plan.to_json()) == plan
    # the JAX package reads the port's JSON as the same plan, and back
    jplan = jchaos.FaultPlan.load(plan.to_json())
    assert jplan.to_json() == plan.to_json()


@pytest.mark.parametrize("obj, match", [
    ({"rules": [{"ops": ["sendd"]}]}, "unknown fault op"),
    ({"rules": [{"ops": ["send"], "corupt": 1.0}]}, "unknown rule key"),
    ({"blackouts": [{"start_s": 0.0, "end_s": 1.0, "total": True}]},
     "unknown blackout key"),
    ({"seeed": 3}, "unknown plan key"),
    ({"byzantine": [{"kind": "flip"}]}, "unknown byzantine kind"),
    ({"byzantine": [{"kind": "scale", "phase": "grad"}]},
     "unknown byzantine phase"),
    ({"rules": [{"drop": 1.5}]}, "probability"),
])
def test_unknown_ops_and_keys_are_refused(obj, match):
    for module in (tchaos, jchaos):
        with pytest.raises(ValueError, match=match):
            module.FaultPlan.from_dict(obj)


def test_maybe_wrap_is_transparent_without_a_plan():
    stub = _StubDHT()
    assert maybe_wrap(stub, None) is stub
    assert maybe_wrap(stub, "") is stub
    assert maybe_wrap(stub, '{"seed": 9}') is stub
    assert not FaultPlan().enabled and FaultPlan(crash_at_epoch=0).enabled
    wrapped = maybe_wrap(
        stub, '{"seed": 1, "rules": [{"ops": ["send"], "drop": 1.0}]}')
    assert isinstance(wrapped, ChaosDHT)
    assert wrapped.peer_id == stub.peer_id


# -- the wrapper on a stub ------------------------------------------------

def test_an_inert_rule_forwards_every_call_untouched():
    stub, chaos = _wrap(FaultPlan(rules=(FaultRule(),)))
    stub.inbox[3] = b"in"
    stub.mailbox[("a:1", 4)] = b"mail"
    stub.records["k"] = {"s": 1}
    assert chaos.send("a:1", 2, b"payload") is True
    assert stub.sent == [("a:1", 2, b"payload")]
    assert chaos.recv(3, timeout=0.1) == b"in"
    assert chaos.fetch("a:1", 4) == b"mail"
    assert chaos.post(5, b"posted", get_dht_time() + 5)
    assert stub.posted == [(5, b"posted")]
    assert chaos.store("k2", "s", 7, get_dht_time() + 5)
    assert chaos.get("k") == {"s": 1}
    assert chaos.injected == {}


def test_the_same_seed_gives_the_same_schedule():
    def pattern(seed):
        stub, chaos = _wrap(FaultPlan(seed=seed, rules=(FaultRule(
            ops=("send",), drop=0.4, corrupt=0.3),)))
        for i in range(60):
            chaos.send("x:1", 7, bytes([i]) * 33)
        return [p for (_a, _t, p) in stub.sent]

    assert pattern(5) == pattern(5)
    assert pattern(5) != pattern(6)


def test_corrupt_and_truncate_mutate_the_payload():
    stub, chaos = _wrap(FaultPlan(seed=2, rules=(FaultRule(
        ops=("send",), corrupt=1.0),)))
    chaos.send("x:1", 1, b"A" * 64)
    (_a, _t, wire), = stub.sent
    assert wire != b"A" * 64 and len(wire) == 64
    assert chaos.injected["corrupt"] == 1
    stub, chaos = _wrap(FaultPlan(seed=2, rules=(FaultRule(
        ops=("send",), truncate=1.0),)))
    chaos.send("x:1", 1, b"A" * 64)
    (_a, _t, wire), = stub.sent
    assert len(wire) < 64 and wire == b"A" * len(wire)


def test_a_dropped_send_still_acks_and_peer_patterns_scope_rules():
    stub, chaos = _wrap(FaultPlan(seed=0, rules=(FaultRule(
        ops=("send",), drop=1.0, peers=("10.0.0.9",)),)))
    assert chaos.send("10.0.0.9:1", 1, b"dropped") is True
    assert chaos.send("10.0.0.8:1", 1, b"delivered")
    assert [a for (a, _t, _p) in stub.sent] == ["10.0.0.8:1"]
    assert chaos.injected["drop"] == 1


def test_blackout_severs_both_planes_then_heals():
    now = {"t": 0.0}
    stub, chaos = _wrap(FaultPlan(blackouts=(Blackout(start_s=1.0,
                                                      end_s=2.0),)),
                        clock=lambda: now["t"])
    stub.inbox[3] = b"in"
    stub.records["k"] = {"s": 1}
    assert chaos.send("x:1", 1, b"pre")
    now["t"] = 1.5
    assert not chaos.send("x:1", 1, b"cut")
    assert chaos.recv(3, timeout=0.01) is None
    assert chaos.get("k") is None
    assert not chaos.store("k", "s", 2, get_dht_time() + 5)
    now["t"] = 2.5
    assert chaos.send("x:1", 1, b"post")
    assert chaos.recv(3, timeout=0.01) == b"in"
    assert [p for (_a, _t, p) in stub.sent] == [b"pre", b"post"]
    assert chaos.injected["sever"] >= 4


def test_crash_at_epoch_kills_the_transport_and_the_optimizer_calls_it():
    from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
    stub, chaos = _wrap(FaultPlan(crash_at_epoch=3))
    assert not chaos.note_epoch(2)
    assert chaos.alive and chaos.send("x:1", 1, b"live")
    # the optimizer's epoch hook reaches note_epoch (a plain DHT has none)
    fake = SimpleNamespace(ledger=PeerHealthLedger(), dht=chaos,
                           local_epoch=3)
    CollaborativeOptimizer._note_epoch_advanced(fake)
    assert not chaos.alive and chaos.injected["crash"] == 1
    assert not chaos.note_epoch(4)
    assert not chaos.send("x:1", 1, b"dead")
    assert chaos.recv(1, timeout=0.01) is None
    assert chaos.fetch("x:1", 1) is None and chaos.get("k") is None
    assert len(stub.sent) == 1
    CollaborativeOptimizer._note_epoch_advanced(
        SimpleNamespace(ledger=PeerHealthLedger(), dht=stub, local_epoch=3))


def test_rule_time_window():
    now = {"t": 0.0}
    stub, chaos = _wrap(FaultPlan(rules=(FaultRule(
        ops=("send",), drop=1.0, start_s=1.0, end_s=2.0),)),
        clock=lambda: now["t"])
    assert chaos.send("x:1", 1, b"early")
    now["t"] = 1.5
    assert chaos.send("x:1", 1, b"windowed")
    now["t"] = 3.0
    assert chaos.send("x:1", 1, b"late")
    assert [p for (_a, _t, p) in stub.sent] == [b"early", b"late"]


# -- the port's decisions are the JAX copy's --------------------------------

TRACE_PLAN = {
    "seed": 11,
    "rules": [
        {"ops": ["send"], "peers": ["10.0.0.9"], "drop": 1.0},
        {"ops": ["send", "recv", "fetch", "post"], "drop": 0.2,
         "duplicate": 0.3, "corrupt": 0.25, "truncate": 0.15,
         "delay_s": [0.0, 0.5], "bandwidth_bps": 1e6},
        {"ops": ["store", "get"], "drop": 0.4, "delay_s": [0.1, 0.2]},
    ],
    "blackouts": [{"start_s": 40.0, "end_s": 45.0, "peers": ["10.0.0.7"]}],
}


def _decision_trace(module, plan_json):
    """Drive one wrapper through a fixed call sequence on a stub; return
    what reached the wire, what came back, every injected sleep and the
    counters."""
    now = {"t": 0.0}
    stub, chaos = _wrap(module.FaultPlan.from_json(plan_json),
                        clock=lambda: now["t"], module=module)
    slept = []
    chaos._sleep = slept.append
    out = []
    for i in range(120):
        now["t"] = float(i) / 2
        payload = bytes((i * 7 + j) % 256 for j in range(17 + i % 23))
        tag = 1000 + i % 5
        addr = ("10.0.0.9:1", "10.0.0.8:1", "10.0.0.7:1")[i % 3]
        stub.inbox[tag] = payload
        stub.mailbox[(addr, tag)] = payload[::-1]
        stub.records[f"k{i % 4}"] = {"v": i}
        out.append(("send", chaos.send(addr, tag, payload)))
        out.append(("recv", chaos.recv(tag, timeout=0.0)))
        out.append(("fetch", chaos.fetch(addr, tag)))
        out.append(("post", chaos.post(tag, payload, 0.0)))
        out.append(("store", chaos.store(f"k{i % 4}", "s", i, 0.0)))
        out.append(("get", chaos.get(f"k{i % 4}")))
    return (out, stub.sent, stub.posted, stub.stored, slept,
            dict(chaos.injected))


def test_decision_trace_equals_the_jax_copy():
    """One plan, one call sequence: the port makes the JAX copy's every
    drop, duplicate, corruption, truncation, delay and sever, exactly."""
    import json
    plan = json.dumps(TRACE_PLAN)
    port, jax_ = _decision_trace(tchaos, plan), _decision_trace(jchaos, plan)
    assert port == jax_
    injected = port[-1]
    for kind in ("drop", "duplicate", "corrupt", "truncate", "delay",
                 "sever"):
        assert injected.get(kind, 0) > 0, (kind, injected)


@pytest.mark.parametrize("kind, factor", [
    ("sign_flip", 10.0), ("scale", -3.5), ("garbage", 2.0),
    ("weight_inflate", 1e9)])
def test_sender_byzantine_values_equal_the_jax_copy(kind, factor):
    """``tamper_contribution`` rewrites a contribution as the JAX copy
    does: the same arrays (bit for bit, host or tensor input) and the
    same claimed weight; phase-scoped ops fire only on their phase."""
    plan = {"seed": 4, "byzantine": [{"kind": kind, "factor": factor,
                                      "start_epoch": 2, "end_epoch": 5,
                                      "phase": "grads"}]}
    import json
    rng = np.random.default_rng(5)
    tensors = [rng.standard_normal(s).astype(np.float32)
               for s in ((3, 7), (11,))]
    _, tch = _wrap(tchaos.FaultPlan.from_dict(plan))
    _, jch = _wrap(jchaos.FaultPlan.from_json(json.dumps(plan)),
                   module=jchaos)
    for epoch, prefix in ((1, "r_grads"), (2, "r_grads"), (4, "r_grads"),
                          (3, "r_grads_psgd_p"), (5, "r_grads")):
        want, wweight = jch.tamper_contribution(epoch, tensors, 2.0,
                                                prefix=prefix)
        for given in (tensors, [torch.from_numpy(t) for t in tensors]):
            got, weight = tch.tamper_contribution(epoch, given, 2.0,
                                                  prefix=prefix)
            assert weight == wweight
            assert len(got) == len(want)
            for a, b in zip(got, want):
                a = a.numpy() if isinstance(a, torch.Tensor) else a
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert tch.injected == {k: 2 * v for k, v in jch.injected.items()}


def test_owner_byzantine_values_equal_the_jax_copy():
    import json
    plan = {"seed": 4, "byzantine": [
        {"kind": "wrong_gather_part", "factor": 0.75, "phase": "state"},
        {"kind": "omit_sender", "start_epoch": 1}]}
    _, tch = _wrap(tchaos.FaultPlan.from_dict(plan))
    _, jch = _wrap(jchaos.FaultPlan.from_json(json.dumps(plan)),
                   module=jchaos)
    part = np.linspace(-1, 1, 33, dtype=np.float32)
    for prefix in ("run_state", "run_grads"):
        want = jch.tamper_gather_part(3, 1, part, prefix=prefix)
        got = tch.tamper_gather_part(3, 1, part, prefix=prefix)
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    pids = ["cc" * 32, "aa" * 32, "bb" * 32]
    for epoch in (0, 1):
        assert (tch.omit_sender_target(epoch, pids, prefix="run_grads")
                == jch.omit_sender_target(epoch, pids, prefix="run_grads"))
    assert tch.injected == jch.injected


# -- real loopback rounds ---------------------------------------------------

def _det_swarm(n, base=101):
    """Loopback port peers with deterministic identities: part ownership
    follows the peer-id order and chaos rolls hash the peer id."""
    nodes = []
    for i in range(n):
        peers = [nodes[0].visible_address] if nodes else []
        ident = Identity(Ed25519PrivateKey.from_private_bytes(
            bytes([base + i]) * 32))
        nodes.append(DHT(initial_peers=peers, identity=ident,
                         rpc_timeout=2.0))
    return nodes


def _run_threads(fns, timeout=60):
    results, errors = [None] * len(fns), []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors:
        raise errors[0]
    return results


def test_a_wrapped_round_is_byte_identical_to_a_raw_one():
    rng = np.random.RandomState(17)
    tensors = [[rng.randn(2048).astype(np.float32)] for _ in range(2)]

    def round_once(wrap):
        nodes = _det_swarm(2)
        dhts = [ChaosDHT(n, FaultPlan(rules=(FaultRule(),))) if wrap else n
                for n in nodes]
        try:
            def peer(i):
                g = make_group(dhts[i], "par", epoch=0, weight=1.0,
                               matchmaking_time=3.0, min_group_size=2)
                assert g is not None and g.size == 2
                return run_allreduce(
                    dhts[i], g, "par", 0, tensors[i], weight=1.0,
                    allreduce_timeout=10.0, codec=compression.UNIFORM8BIT,
                    chunk_elems=512)
            return _run_threads([lambda i=i: peer(i) for i in range(2)])
        finally:
            for n in nodes:
                n.shutdown()

    raw, wrapped = round_once(False), round_once(True)
    for r, c in zip(raw, wrapped):
        np.testing.assert_array_equal(r[0], c[0])


def test_a_corrupt_sender_degrades_the_round_gracefully():
    """Three peers, one whose every send is corrupted: the round completes
    in time, each honest owner's part averages the two honest
    contributions, and both honest peers name and strike the offender."""
    nodes = _det_swarm(3, base=131)
    pids = [n.peer_id for n in nodes]
    bad = pids.index(max(pids))
    honest = [i for i in range(3) if i != bad]
    dhts = list(nodes)
    dhts[bad] = ChaosDHT(nodes[bad], FaultPlan(seed=9, rules=(FaultRule(
        ops=("send",), corrupt=1.0),)))
    rng = np.random.RandomState(23)
    tensors = [[rng.randn(300).astype(np.float32)] for _ in range(3)]
    reports = [dict() for _ in range(3)]
    ledgers = [PeerHealthLedger() for _ in range(3)]

    def peer(i):
        g = make_group(dhts[i], "cor", epoch=0, weight=1.0,
                       matchmaking_time=3.0, min_group_size=3)
        assert g is not None and g.size == 3
        return g, run_allreduce(
            dhts[i], g, "cor", 0, tensors[i], weight=1.0,
            allreduce_timeout=8.0, sender_timeout=1.5,
            codec=compression.NONE, report=reports[i], ledger=ledgers[i])

    t0 = time.monotonic()
    try:
        results = _run_threads([lambda i=i: peer(i) for i in range(3)])
    finally:
        for n in nodes:
            n.shutdown()
    assert time.monotonic() - t0 < 25
    members = [m.peer_id for m in results[honest[0]][0].members]
    flats = [flatten_tensors(t) for t in tensors]
    slices = _part_slices(flats[0].size, 3)
    honest_avg = (flats[honest[0]] + flats[honest[1]]) / 2
    for i in honest:
        blamed = (set(reports[i]["corrupt_senders"])
                  | set(reports[i]["timeout_senders"]))
        assert pids[bad] in blamed, reports[i]
        assert not reports[i]["complete"]
        assert ledgers[i].score(pids[bad]) > 0
        lo, hi = slices[members.index(pids[i])]
        got = flatten_tensors(results[i][1])
        np.testing.assert_allclose(got[lo:hi], honest_avg[lo:hi],
                                   rtol=1e-5, atol=1e-6)
