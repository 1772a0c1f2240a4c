"""Deterministic fault injection for the swarm transport (counterpart of
``dalle_tpu/swarm/chaos.py``: the same plans, the same decisions and the
same tampered values for the same call sequence, so one plan drives a
mixed swarm of JAX and port peers alike; a byzantine seam given tensors
on a device works on their host f32 copies).

The paper's core claim is that a swarm of elastic, unreliable volunteers
behaves like one synchronous data-parallel trainer. The failure paths
that make that true — sender bans in ``allreduce.py``, confirm-wait
deadlines in ``matchmaking.py``, the ALONE-epoch fallback in
``optimizer.py``, server failover in ``state_transfer.py``, the
evidence-fetch budget/failover/zero-ledger-effect rules in
``audit.EvidencePlane`` (its mailbox posts and fetches ride the same
``post``/``fetch`` ops this wrapper faults) — need to be *drivable*,
not just reachable by ad-hoc peer kills. This module wraps a
:class:`~dalle_tpu_torch.swarm.dht.DHT` with a seeded, declarative
:class:`FaultPlan` that injects message drop / delay / duplication,
payload corruption / truncation, per-peer bandwidth throttling, timed
blackouts (partitions) and crash-at-epoch — at the transport seam, so
every protocol layer above it is exercised unmodified.

Design rules:

- **Bit-transparent when disabled.** ``maybe_wrap(dht, None)`` returns
  the raw DHT; a :class:`ChaosDHT` with an empty plan delegates every
  call untouched (pinned by test) — chaos can ship enabled-by-flag in
  every entry point with zero cost on the clean path.
- **Deterministic.** Every fault decision is a pure function of
  ``(plan.seed, peer_id, op, key, per-key call index)`` — no ambient
  ``random`` state — so the same seed reproduces the same fault
  schedule for the same per-channel call sequence, and two runs of the
  churn soak disagree only where thread interleaving reorders calls on
  the *same* channel.
- **Faults are lossy the way real networks are.** A dropped ``send``
  still returns True (the transport ack'd; the receiver's process never
  acted — the nastiest real-world loss mode). A total blackout makes
  the peer an island: sends fail, fetches and gets come back empty,
  stores and mailbox posts stop propagating, inbound frames are
  consumed and discarded. A peer-scoped blackout severs outbound only
  (see :class:`Blackout`).

Selectable via ``CollabConfig.chaos_plan`` (a JSON file path or an
inline JSON object), which every swarm entry point (``run_trainer``,
``run_aux_peer``) exposes as ``--chaos-plan``. See CHAOS.md for the
fault matrix and the plan schema.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from dalle_tpu_torch.swarm.audit import AVERAGING_PHASES, phase_of_prefix

logger = logging.getLogger(__name__)

#: ops a FaultRule may target. "send"/"fetch" are addressed (peer
#: patterns match the remote address); "recv"/"post" are local channel
#: ops; "store"/"get" are record-plane ops (peer patterns never match).
FAULT_OPS = ("send", "recv", "fetch", "store", "get", "post")

#: hard cap on any injected sleep (delay jitter or bandwidth throttle):
#: an over-aggressive plan must degrade a round, not wedge a thread
#: past every protocol deadline.
MAX_INJECTED_SLEEP_S = 5.0

#: byzantine attack kinds a plan may inject. Unlike every transport
#: fault above, these fire ABOVE the signature. SENDER kinds rewrite
#: the peer's own contribution before it is flattened and signed, so
#: the wire carries validly-signed wrong data — the attack class the
#: content screen (swarm/screening.py) exists to catch, invisible to
#: signature checks and strict parsing by construction. OWNER kinds
#: fire at the part-owner seam instead: the peer screens and averages
#: honestly, then serves a WRONG gather part (``wrong_gather_part``)
#: or silently discards one delivered sender's contribution
#: (``omit_sender``) — the attack class the aggregation AUDIT
#: (swarm/audit.py) exists to catch, invisible to every input-side
#: defense by construction.
SENDER_BYZANTINE_KINDS = ("sign_flip", "scale", "garbage",
                          "weight_inflate")
OWNER_BYZANTINE_KINDS = ("wrong_gather_part", "omit_sender")
BYZANTINE_KINDS = SENDER_BYZANTINE_KINDS + OWNER_BYZANTINE_KINDS

#: averaging phases a byzantine op may scope itself to. Every phase of
#: the protocol runs the same butterfly (and, since r16, the same
#: audit), but their prefixes differ — the mapping is protocol
#: knowledge and lives with the audit (swarm/audit.py:
#: AVERAGING_PHASES / phase_of_prefix, re-exported here); this
#: test-time layer only consumes it. ``phase=None`` matches every
#: phase (the pre-r16 semantics). The seams in ``run_allreduce`` pass
#: the round prefix; ops filter on the derived phase so one plan can
#: attack the gradient, factor and state rounds independently.
BYZANTINE_PHASES = AVERAGING_PHASES


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One fault clause: WHICH traffic (ops/peers/time window) gets WHAT
    (drop/dup/corrupt/truncate probabilities, delay jitter, throttle).
    The first matching rule wins per operation."""

    ops: Tuple[str, ...] = FAULT_OPS
    #: remote-peer patterns (peer-id hex prefix or substring of the
    #: "host:port[/peer_id]" address). Empty = every peer. Only
    #: addressed ops (send/fetch) have a remote to match; a rule with
    #: patterns never fires on recv/store/get/post.
    peers: Tuple[str, ...] = ()
    drop: float = 0.0
    duplicate: float = 0.0
    corrupt: float = 0.0
    truncate: float = 0.0
    #: [min, max] seconds of per-message latency jitter
    delay_s: Tuple[float, float] = (0.0, 0.0)
    #: payload bytes/second throttle; 0 = unlimited
    bandwidth_bps: float = 0.0
    #: active window relative to wrapper construction; end None = forever
    start_s: float = 0.0
    end_s: Optional[float] = None

    def __post_init__(self):
        # strictness at construction, not first-fire: a malformed value
        # (delay_s arity, probability out of [0,1]) must not parse into
        # a rule that explodes mid-soak on a worker thread
        if len(self.delay_s) != 2:
            raise ValueError(
                f"delay_s must be [min, max] seconds, got {self.delay_s!r}")
        lo, hi = self.delay_s
        if lo < 0 or hi < lo:
            raise ValueError(
                f"delay_s must satisfy 0 <= min <= max, got {self.delay_s!r}")
        for name in ("drop", "duplicate", "corrupt", "truncate"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"{name} must be a probability in [0, 1], got {p!r}")
        if self.bandwidth_bps < 0:
            raise ValueError(
                f"bandwidth_bps must be >= 0, got {self.bandwidth_bps!r}")

    def active(self, elapsed: float) -> bool:
        return elapsed >= self.start_s and (
            self.end_s is None or elapsed < self.end_s)


@dataclasses.dataclass(frozen=True)
class Blackout:
    """A timed partition. Empty ``peers`` (a TOTAL blackout) isolates
    the peer entirely, both directions: outbound fails, inbound frames
    are consumed and discarded, mailbox posts fail, and the DHT record
    plane is severed too (stores stop propagating, gets come back
    empty). Peer-scoped blackouts sever OUTBOUND traffic only
    (send/fetch to matching remotes): inbound frames carry no sender
    identity at the transport seam, so an asymmetric link is what a
    peer-scoped clause actually models — scope the blackout total (or
    mirror it on the other peer's plan) for a true pairwise
    partition."""

    start_s: float
    end_s: float
    peers: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.end_s < self.start_s or self.start_s < 0:
            raise ValueError(
                "blackout window must satisfy 0 <= start_s <= end_s, "
                f"got [{self.start_s!r}, {self.end_s!r})")

    def active(self, elapsed: float) -> bool:
        return self.start_s <= elapsed < self.end_s

    @property
    def total(self) -> bool:
        return not self.peers


@dataclasses.dataclass(frozen=True)
class ByzantineOp:
    """One byzantine clause: make this peer contribute valid-but-wrong
    data for epochs in ``[start_epoch, end_epoch)``.

    - ``sign_flip`` — negate the gradient (``factor`` unused);
    - ``scale`` — multiply it by ``factor`` (e.g. -10.0);
    - ``garbage`` — replace it with seeded N(0, factor^2) noise drawn
      deterministically from (plan.seed, epoch), then signed with the
      attacker's REAL identity like any honest contribution;
    - ``weight_inflate`` — claim ``factor`` as the frame weight on the
      wire (the classic "my batch was 1e9 samples"); the data itself
      stays honest, so only the weight clamp can catch it;
    - ``wrong_gather_part`` — OWNER seam: screen and average honestly,
      then serve ``averaged + factor`` as the gather part (every
      input-side defense stays quiet; only the replay audit sees it);
    - ``omit_sender`` — OWNER seam: silently discard the delivered
      contribution of the lowest-peer-id sender, leaving no drop-set
      trace (``factor`` unused; the sender-side omission audit is the
      only defense with standing to catch it).

    The first active op of the relevant seam wins (FaultRule
    precedence semantics, per seam). ``phase`` scopes the op to one
    averaging phase ("grads", "powersgd", "state" —
    :func:`phase_of_prefix` maps round prefixes); None fires on every
    phase (the pre-r16 semantics).
    """

    kind: str
    factor: float = 10.0
    start_epoch: int = 0
    end_epoch: Optional[int] = None
    phase: Optional[str] = None

    def __post_init__(self):
        if self.kind not in BYZANTINE_KINDS:
            raise ValueError(
                f"unknown byzantine kind {self.kind!r}; expected one of "
                f"{BYZANTINE_KINDS}")
        if self.phase is not None and self.phase not in BYZANTINE_PHASES:
            raise ValueError(
                f"unknown byzantine phase {self.phase!r}; expected one "
                f"of {BYZANTINE_PHASES} or null")
        if not math.isfinite(self.factor):
            raise ValueError("byzantine factor must be finite")
        if self.kind == "weight_inflate" and self.factor <= 0:
            raise ValueError(
                f"weight_inflate factor must be > 0 (it is the claimed "
                f"frame weight), got {self.factor!r}")
        if self.kind == "scale" and self.factor == 0:
            raise ValueError("scale factor 0 is a zero contribution, "
                             "not an attack; use garbage instead")
        if self.kind == "wrong_gather_part" and self.factor == 0:
            raise ValueError("wrong_gather_part factor 0 serves the "
                             "HONEST part (factor is the additive "
                             "perturbation); use a nonzero factor")
        if self.start_epoch < 0 or (self.end_epoch is not None
                                    and self.end_epoch < self.start_epoch):
            raise ValueError(
                "byzantine window must satisfy 0 <= start_epoch <= "
                f"end_epoch, got [{self.start_epoch!r}, "
                f"{self.end_epoch!r})")

    def active(self, epoch: int) -> bool:
        return epoch >= self.start_epoch and (
            self.end_epoch is None or epoch < self.end_epoch)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded fault schedule for one peer's transport."""

    seed: int = 0
    rules: Tuple[FaultRule, ...] = ()
    blackouts: Tuple[Blackout, ...] = ()
    #: the peer's transport self-destructs when the training loop
    #: reports this epoch (optimizer calls ``note_epoch``); None = never
    crash_at_epoch: Optional[int] = None
    #: byzantine data attacks (valid-but-wrong contributions), injected
    #: at the contribution seam rather than the transport seam
    byzantine: Tuple[ByzantineOp, ...] = ()

    @property
    def enabled(self) -> bool:
        return bool(self.rules or self.blackouts or self.byzantine
                    or self.crash_at_epoch is not None)

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @staticmethod
    def _reject_unknown_keys(obj: dict, cls_, what: str) -> None:
        # a typoed fault field ("corupt") silently parsing as an
        # all-defaults clause would make the harness green while
        # injecting nothing — for a fault-injection layer, strictness
        # IS the safety property
        known = {f.name for f in dataclasses.fields(cls_)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f"unknown {what} key(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}")

    @classmethod
    def from_dict(cls, obj: dict) -> "FaultPlan":
        cls._reject_unknown_keys(obj, cls, "plan")
        rules = []
        for r in obj.get("rules", ()):
            cls._reject_unknown_keys(r, FaultRule, "rule")
            bad_ops = set(r.get("ops", ())) - set(FAULT_OPS)
            if bad_ops:
                raise ValueError(
                    f"unknown fault op(s) {sorted(bad_ops)}; "
                    f"expected a subset of {FAULT_OPS}")
            rules.append(FaultRule(
                ops=tuple(r.get("ops", FAULT_OPS)),
                peers=tuple(r.get("peers", ())),
                drop=float(r.get("drop", 0.0)),
                duplicate=float(r.get("duplicate", 0.0)),
                corrupt=float(r.get("corrupt", 0.0)),
                truncate=float(r.get("truncate", 0.0)),
                delay_s=tuple(r.get("delay_s", (0.0, 0.0))),  # type: ignore
                bandwidth_bps=float(r.get("bandwidth_bps", 0.0)),
                start_s=float(r.get("start_s", 0.0)),
                end_s=(None if r.get("end_s") is None
                       else float(r["end_s"]))))
        for b in obj.get("blackouts", ()):
            cls._reject_unknown_keys(b, Blackout, "blackout")
        blackouts = tuple(
            Blackout(start_s=float(b["start_s"]), end_s=float(b["end_s"]),
                     peers=tuple(b.get("peers", ())))
            for b in obj.get("blackouts", ()))
        byz = []
        for z in obj.get("byzantine", ()):
            cls._reject_unknown_keys(z, ByzantineOp, "byzantine op")
            if "kind" not in z:
                raise ValueError("byzantine op needs a 'kind' "
                                 f"(one of {BYZANTINE_KINDS})")
            byz.append(ByzantineOp(
                kind=str(z["kind"]),
                factor=float(z.get("factor", 10.0)),
                start_epoch=int(z.get("start_epoch", 0)),
                end_epoch=(None if z.get("end_epoch") is None
                           else int(z["end_epoch"])),
                phase=(None if z.get("phase") is None
                       else str(z["phase"]))))
        crash = obj.get("crash_at_epoch")
        return cls(seed=int(obj.get("seed", 0)), rules=tuple(rules),
                   blackouts=blackouts,
                   crash_at_epoch=None if crash is None else int(crash),
                   byzantine=tuple(byz))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, spec: str) -> "FaultPlan":
        """A plan from an inline JSON object (starts with '{') or a
        path to a JSON file — the ``--chaos-plan`` flag accepts both."""
        spec = spec.strip()
        if spec.startswith("{"):
            return cls.from_json(spec)
        with open(spec, "r", encoding="utf-8") as fh:
            return cls.from_json(fh.read())


def _host_f32(t) -> np.ndarray:
    """A contribution leaf (host array or tensor) as a host f32 array."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _match(patterns: Tuple[str, ...], addr: str) -> bool:
    """Whether a remote address ("host:port" or
    "relay:port/<peer id>") matches any peer pattern. Patterns match as
    a prefix of the relayed peer id or a substring of the address."""
    if not patterns:
        return True
    target = addr.rpartition("/")[2]
    return any(p in addr or target.startswith(p) for p in patterns)


class ChaosDHT:
    """A DHT proxy that injects the plan's faults at the transport seam.

    Everything not overridden here (identity, kx, peer_id, addresses,
    shutdown, punch, ...) delegates to the wrapped node, so every
    consumer — matchmaking, all-reduce, state transfer, progress,
    rendezvous — runs unmodified on top of it.
    """

    def __init__(self, dht, plan: FaultPlan,
                 clock=time.monotonic):
        self._inner = dht
        self.plan = plan
        self._clock = clock
        self._t0 = clock()
        self._dead = False
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        # observability: what actually fired, by fault kind
        self.injected: Dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------

    def kill(self) -> None:
        """Simulate an abrupt process death for the *protocol* layers:
        every subsequent op fails (sends False, reads None/empty)
        without touching the native node — so in-flight worker threads
        unwind through their normal failure paths instead of racing a
        native teardown. Tear the node down for real (``shutdown``)
        after those threads are joined."""
        self._dead = True

    @property
    def alive(self) -> bool:
        return not self._dead

    def note_epoch(self, epoch: int) -> bool:
        """Training-loop hook (CollaborativeOptimizer calls this as the
        epoch advances): triggers the plan's crash-at-epoch. Returns
        True when the crash fired on this call."""
        if (self.plan.crash_at_epoch is not None and not self._dead
                and epoch >= self.plan.crash_at_epoch):
            logger.warning("chaos: crash-at-epoch %d fired (epoch %d)",
                           self.plan.crash_at_epoch, epoch)
            self._count("crash")
            self.kill()
            return True
        return False

    @staticmethod
    def _byz_key(op: ByzantineOp) -> str:
        """Injected-counter key: phase-suffixed for phase-scoped ops
        (aux-phase oracles key on these), the bare r13/r14 key for
        unscoped and grads-scoped ops (back-compat)."""
        if op.phase in (None, "grads"):
            return f"byz_{op.kind}"
        return f"byz_{op.kind}:{op.phase}"

    def byzantine_op(self, epoch: int,
                     kinds: Tuple[str, ...] = BYZANTINE_KINDS,
                     phase: str = "grads") -> Optional[ByzantineOp]:
        """The first byzantine clause of one of ``kinds`` active at
        ``epoch`` whose phase scope covers ``phase``, or None. The
        sender seam and the owner seam filter to their own kinds, so
        one plan can carry both attack classes (and per-phase
        variants)."""
        for op in self.plan.byzantine:
            if (op.kind in kinds and op.active(epoch)
                    and op.phase in (None, phase)):
                return op
        return None

    def tamper_contribution(self, epoch: int, tensors, weight: float,
                            prefix: str = ""):
        """The SENDER byzantine injection seam, called by
        ``run_allreduce`` BEFORE flatten and signing: returns
        (tensors, frame_weight) — possibly rewritten — so the wire
        carries this peer's valid-but-wrong contribution under its
        real identity. The garbage draw is deterministic in
        (plan.seed, epoch), keeping soak runs seed-reproducible. A
        plan with no byzantine clauses (or none active this epoch)
        returns the inputs untouched, so an inert wrapper stays
        bit-transparent."""
        op = self.byzantine_op(epoch, SENDER_BYZANTINE_KINDS,
                               phase_of_prefix(prefix))
        if op is None:
            return tensors, weight
        self._count(self._byz_key(op))
        logger.warning("chaos: byzantine %s active at epoch %d "
                       "(factor=%r)", op.kind, epoch, op.factor)
        if op.kind == "weight_inflate":
            return tensors, float(op.factor)
        if op.kind == "sign_flip":
            return [np.negative(_host_f32(t)) for t in tensors], weight
        if op.kind == "scale":
            return [_host_f32(t) * np.float32(op.factor)
                    for t in tensors], weight
        # garbage: seeded, epoch-varying noise at |factor| magnitude
        digest = hashlib.sha256(
            f"{self.plan.seed}|byz-garbage|{epoch}".encode()).digest()
        rng = np.random.RandomState(
            int.from_bytes(digest[:4], "big"))
        return [rng.standard_normal(tuple(t.shape)).astype(np.float32)
                * np.float32(abs(op.factor)) for t in tensors], weight

    def tamper_gather_part(self, epoch: int, part: int, values,
                           prefix: str = ""):
        """The OWNER byzantine seam, called by ``run_allreduce`` after
        the honest average (and after the audit transcript is
        recorded): an active ``wrong_gather_part`` op perturbs the
        part this owner is about to serve by ``+factor`` per element —
        a plausible, finite, validly-signed wrong part that no
        input-side defense can see. Fires on the phase the round
        prefix names (grads / powersgd factor / state averaging) when
        the op is phase-scoped. Inert plans return ``values``
        untouched (bit-transparency)."""
        op = self.byzantine_op(epoch, ("wrong_gather_part",),
                               phase_of_prefix(prefix))
        if op is None:
            return values
        self._count(self._byz_key(op))
        logger.warning("chaos: wrong_gather_part active at epoch %d "
                       "(part %d, phase %s, +%r)", epoch, part,
                       op.phase or "any", op.factor)
        return _host_f32(values) + np.float32(op.factor)

    def omit_sender_target(self, epoch: int, candidate_pids,
                           prefix: str = ""):
        """The OWNER omission seam: an active ``omit_sender`` op names
        the lowest-peer-id candidate (deterministic given the roster)
        whose delivered contribution this owner silently discards —
        no ban, no transcript entry. None when inert."""
        op = self.byzantine_op(epoch, ("omit_sender",),
                               phase_of_prefix(prefix))
        if op is None or not candidate_pids:
            return None
        victim = min(candidate_pids)
        self._count(self._byz_key(op))
        logger.warning("chaos: omit_sender active at epoch %d "
                       "(victim %s)", epoch, victim[:16])
        return victim

    # -- deterministic decisions -------------------------------------------

    def _elapsed(self) -> float:
        return self._clock() - self._t0

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    #: channel-counter bound: many channels are one-shot (state-transfer
    #: tags embed a fresh nonce per download, allreduce tags vary per
    #: epoch and chunk), so an hours-long soak would otherwise grow the
    #: dict forever. FIFO eviction at the cap: an evicted channel that is
    #: somehow revisited restarts at index 0, which only weakens
    #: cross-run roll reproducibility for runs long past the point where
    #: real-socket timing already dominates.
    _MAX_CHANNELS = 1 << 16

    def _roll(self, op: str, key: str) -> int:
        """A deterministic 128-bit roll for the next call on channel
        (op, key): hash of (seed, peer, op, key, per-channel index).
        Wide enough that the four per-fault probability draws (bits
        0/20/40/60), the delay jitter (bits 80-95) and the mutation
        placement never share bits — overlapping draws would correlate
        drop/corrupt/truncate/duplicate decisions."""
        with self._lock:
            idx = self._counters.get((op, key), 0)
            if idx == 0 and len(self._counters) >= self._MAX_CHANNELS:
                self._counters.pop(next(iter(self._counters)))
            self._counters[(op, key)] = idx + 1
        msg = f"{self.plan.seed}|{self._inner.peer_id}|{op}|{key}|{idx}"
        return int.from_bytes(
            hashlib.sha256(msg.encode()).digest()[:16], "big")

    def _rule_for(self, op: str, addr: Optional[str]) -> Optional[FaultRule]:
        elapsed = self._elapsed()
        for r in self.plan.rules:
            if op not in r.ops or not r.active(elapsed):
                continue
            if r.peers and (addr is None or not _match(r.peers, addr)):
                continue
            return r
        return None

    def _blacked_out(self, addr: Optional[str]) -> bool:
        elapsed = self._elapsed()
        for b in self.plan.blackouts:
            if not b.active(elapsed):
                continue
            if b.total or (addr is not None and _match(b.peers, addr)):
                return True
        return False

    def _total_blackout(self) -> bool:
        elapsed = self._elapsed()
        return any(b.active(elapsed) and b.total
                   for b in self.plan.blackouts)

    def _sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(min(seconds, MAX_INJECTED_SLEEP_S))

    def _pre_delay(self, rule: FaultRule, roll: int, nbytes: int) -> None:
        lo, hi = rule.delay_s
        d = lo + (hi - lo) * ((roll >> 80 & 0xFFFF) / 0xFFFF)
        if rule.bandwidth_bps > 0:
            d += nbytes / rule.bandwidth_bps
        if d > 0:
            self._count("delay")
            self._sleep(d)

    @staticmethod
    def _mutate(payload: bytes, roll: int, truncate: bool) -> bytes:
        """Deterministically damage a payload: cut the tail, or XOR a
        byte (never a no-op — an all-zero flip mask is skipped)."""
        if not payload:
            return payload
        if truncate:
            cut = 1 + (roll >> 8) % max(1, len(payload) // 2)
            return payload[:len(payload) - cut]
        pos = roll % len(payload)
        flip = 1 + ((roll >> 24) % 255)
        out = bytearray(payload)
        out[pos] ^= flip
        return bytes(out)

    @staticmethod
    def _p(roll: int, shift: int) -> float:
        """One of several independent uniform [0,1) draws from a roll."""
        return ((roll >> shift) & 0xFFFFF) / float(1 << 20)

    # -- faulted transport ops ---------------------------------------------

    def send(self, addr: str, tag: int, payload: bytes,
             timeout: Optional[float] = None) -> bool:
        if self._dead or self._blacked_out(addr):
            self._count("sever")
            return False
        rule = self._rule_for("send", addr)
        if rule is None:
            return self._inner.send(addr, tag, payload, timeout=timeout)
        roll = self._roll("send", str(tag))
        self._pre_delay(rule, roll, len(payload))
        if self._p(roll, 0) < rule.drop:
            self._count("drop")
            return True  # ack'd but never processed: silent loss
        if self._p(roll, 20) < rule.truncate:
            self._count("truncate")
            payload = self._mutate(payload, roll, truncate=True)
        elif self._p(roll, 40) < rule.corrupt:
            self._count("corrupt")
            payload = self._mutate(payload, roll, truncate=False)
        ok = self._inner.send(addr, tag, payload, timeout=timeout)
        if ok and self._p(roll, 60) < rule.duplicate:
            self._count("duplicate")
            self._inner.send(addr, tag, payload, timeout=timeout)
        return ok

    def recv(self, tag: int, timeout: float) -> Optional[bytes]:
        if self._dead:
            self._sleep(min(timeout, 0.2))
            return None
        got = self._inner.recv(tag, timeout)
        if got is None:
            return None
        if self._total_blackout():
            self._count("sever")
            return None  # consumed and lost: partition semantics
        rule = self._rule_for("recv", None)
        if rule is None:
            return got
        roll = self._roll("recv", str(tag))
        self._pre_delay(rule, roll, len(got))
        if self._p(roll, 0) < rule.drop:
            self._count("drop")
            return None
        if self._p(roll, 20) < rule.truncate:
            self._count("truncate")
            return self._mutate(got, roll, truncate=True)
        if self._p(roll, 40) < rule.corrupt:
            self._count("corrupt")
            return self._mutate(got, roll, truncate=False)
        return got

    def fetch(self, addr: str, tag: int,
              timeout: Optional[float] = None) -> Optional[bytes]:
        if self._dead or self._blacked_out(addr):
            self._count("sever")
            return None
        rule = self._rule_for("fetch", addr)
        if rule is None:
            return self._inner.fetch(addr, tag, timeout=timeout)
        roll = self._roll("fetch", str(tag))
        self._pre_delay(rule, roll, 0)
        if self._p(roll, 0) < rule.drop:
            self._count("drop")
            return None
        got = self._inner.fetch(addr, tag, timeout=timeout)
        if got is None:
            return None
        if self._p(roll, 20) < rule.truncate:
            self._count("truncate")
            return self._mutate(got, roll, truncate=True)
        if self._p(roll, 40) < rule.corrupt:
            self._count("corrupt")
            return self._mutate(got, roll, truncate=False)
        return got

    def post(self, tag: int, payload: bytes, expiration_time: float) -> bool:
        # a totally-partitioned peer must not publish FRESH mailbox data
        # (pull-plane consumers on unwrapped nodes would read through the
        # partition); stale pre-partition posts staying readable is the
        # one inbound leak this wrapper cannot intercept
        if self._dead or self._total_blackout():
            self._count("sever")
            return False
        rule = self._rule_for("post", None)
        if rule is not None:
            roll = self._roll("post", str(tag))
            if self._p(roll, 0) < rule.drop:
                self._count("drop")
                return True
            if self._p(roll, 20) < rule.truncate:
                self._count("truncate")
                payload = self._mutate(payload, roll, truncate=True)
            elif self._p(roll, 40) < rule.corrupt:
                self._count("corrupt")
                payload = self._mutate(payload, roll, truncate=False)
        return self._inner.post(tag, payload, expiration_time)

    def store(self, key, subkey, value, expiration_time: float) -> bool:
        if self._dead or self._total_blackout():
            self._count("sever")
            return False
        rule = self._rule_for("store", None)
        if rule is not None:
            roll = self._roll("store", str(key))
            self._pre_delay(rule, roll, 0)
            if self._p(roll, 0) < rule.drop:
                self._count("drop")
                return True  # "stored" but never replicated
        return self._inner.store(key, subkey, value, expiration_time)

    def get(self, key, latest: bool = True):
        if self._dead or self._total_blackout():
            self._count("sever")
            return None
        rule = self._rule_for("get", None)
        if rule is not None:
            roll = self._roll("get", str(key))
            self._pre_delay(rule, roll, 0)
            if self._p(roll, 0) < rule.drop:
                self._count("drop")
                return None
        return self._inner.get(key, latest=latest)

    # -- transparent delegation --------------------------------------------

    def __getattr__(self, name):
        # everything not faulted (identity, kx, peer_id, addresses,
        # bootstrap, punch, peers, shutdown, validators, _relay_addr,
        # _parse_addr, ...) is the wrapped node's business
        return getattr(self._inner, name)

    def __enter__(self) -> "ChaosDHT":
        return self

    def __exit__(self, *exc) -> None:
        self._inner.shutdown()


def maybe_wrap(dht, chaos_plan: Optional[str]):
    """Wrap ``dht`` in a ChaosDHT when a plan is configured
    (``CollabConfig.chaos_plan``: JSON file path or inline JSON), else
    return it untouched — the zero-cost disabled path."""
    if not chaos_plan:
        return dht
    plan = FaultPlan.load(chaos_plan)
    if not plan.enabled:
        return dht
    logger.warning(
        "CHAOS ENABLED: transport faults injected per plan (seed=%d, "
        "%d rule(s), %d blackout(s), %d byzantine op(s), "
        "crash_at_epoch=%s) — this peer is deliberately unreliable",
        plan.seed, len(plan.rules), len(plan.blackouts),
        len(plan.byzantine), plan.crash_at_epoch)
    return ChaosDHT(dht, plan)
