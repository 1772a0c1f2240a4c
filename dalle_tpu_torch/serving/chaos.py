"""Deterministic fault injection for the serving plane.

The port's copy of ``dalle_tpu/serving/chaos.py`` (stdlib and numpy
only): the same plan or the same calls give the same decisions and
counters, which ``tests/test_torch_serving.py`` holds.

The swarm got its fault story in `swarm/chaos.py` (a seeded `FaultPlan`
wrapping the DHT transport); the serving stack that is supposed to carry
"heavy traffic from millions of users" had none — overload meant 429s
from a FIFO, a vanished client pinned a slot for the full decode, and
the admission/pixel/engine-thread paths had never run under injected
failure. This module is the serving twin: a seeded, declarative
:class:`ServeFaultPlan` whose hooks ride at the seams the front-end
(`server.py`), the pixel worker (`pixels.py`) and the engine thread
(`engine.py`) already cross on every request:

- ``client_recv`` — a slow or stalled client: the handler sleeps before
  reading the request body (the connection thread is pinned exactly as
  a real trickling uploader pins it).
- ``client_send`` — a half-closed or vanished client: an injected stall
  before the response write, and/or severing the connection's read side
  so the handler's disconnect probe sees EOF (the request's slots must
  be cancelled, not decoded for nobody).
- ``pixel`` — pixel-worker stalls (sleep inside the worker) and
  exceptions (:class:`ChaosInjectedError` raised in place of the pixel
  fn), exercising the failed-request path under load.
- ``admit`` — stalls inside the engine thread's admission step, plus a
  deterministic ``crash_at_admission``: the Nth admission batch raises,
  driving the engine's crash-path cancel sweep (no orphaned handles).
- ``floods`` — timed artificial queue floods: the engine injects a
  burst of synthetic low-lane requests at a scheduled offset, consuming
  real queue and decode capacity (the saturation that engages shedding
  and brownout on demand).

Design rules, inherited from `swarm/chaos.py`:

- **Bit-transparent when disabled.** :func:`maybe_wrap_serving` returns
  ``None`` for an empty/absent plan; every seam guards with
  ``if chaos is not None``. A constructed :class:`ServeChaos` whose
  plan has no matching rule delegates untouched (pinned by test —
  engine output and HTTP bodies identical with and without the seam).
- **Deterministic.** Every decision is a pure function of
  ``(plan.seed, op, key, per-channel call index)`` — a SHA-256 roll,
  no ambient ``random`` state — so one seed reproduces one fault
  schedule for the same per-channel call sequence.
- **Strict parsing.** An unknown key, op or out-of-range probability
  raises at parse time: a typoed plan must not pass as an inert green
  soak (for a fault harness, strictness IS the safety property).

Selectable via ``ServingConfig.chaos_plan`` (`--chaos-plan` on
``cli/run_server.py``: a JSON file path or an inline JSON object). See
CHAOS.md for the serving fault matrix and the plan schema.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

#: ops a ServeFaultRule may target (see the module docstring for what
#: each seam injects).
SERVE_FAULT_OPS = ("client_recv", "client_send", "pixel", "admit")

#: hard cap on any injected stall: serving deadlines run on sub-second
#: scales, so an over-aggressive plan must degrade a request, not wedge
#: a handler/worker thread past every request timeout.
MAX_INJECTED_STALL_S = 2.0


class ChaosInjectedError(RuntimeError):
    """An injected failure (pixel exception / admission crash). Message
    always starts with 'chaos:' so logs and error payloads attribute
    the failure to the plan, never to the product code under test."""


@dataclasses.dataclass(frozen=True)
class ServeFaultRule:
    """One fault clause: WHICH seam (ops + time window) gets WHAT
    (stall range, failure probability, half-close probability). The
    first matching rule wins per operation."""

    ops: Tuple[str, ...] = SERVE_FAULT_OPS
    #: [min, max] seconds of injected stall per matched call
    stall_s: Tuple[float, float] = (0.0, 0.0)
    #: probability of raising ChaosInjectedError (pixel/admit seams)
    fail: float = 0.0
    #: probability of severing the connection (client_send seam only)
    half_close: float = 0.0
    #: active window relative to ServeChaos construction; None = forever
    start_s: float = 0.0
    end_s: Optional[float] = None

    def __post_init__(self):
        # strictness at construction, not first fire: a malformed value
        # must not parse into a rule that explodes mid-soak on a worker
        if len(self.stall_s) != 2:
            raise ValueError(
                f"stall_s must be [min, max] seconds, got {self.stall_s!r}")
        lo, hi = self.stall_s
        if lo < 0 or hi < lo:
            raise ValueError(
                f"stall_s must satisfy 0 <= min <= max, got {self.stall_s!r}")
        for name in ("fail", "half_close"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"{name} must be a probability in [0, 1], got {p!r}")
        if self.half_close > 0 and "client_send" not in self.ops:
            raise ValueError(
                "half_close only fires on the client_send seam; scope the "
                f"rule's ops accordingly (got ops={self.ops!r})")
        if self.end_s is not None and self.end_s < self.start_s:
            raise ValueError(
                f"rule window must satisfy start_s <= end_s, got "
                f"[{self.start_s!r}, {self.end_s!r})")

    def active(self, elapsed: float) -> bool:
        return elapsed >= self.start_s and (
            self.end_s is None or elapsed < self.end_s)


@dataclasses.dataclass(frozen=True)
class Flood:
    """A timed artificial queue flood: at ``at_s`` after construction
    the engine injects ``burst`` synthetic low-lane requests (real queue
    entries, real decode work — resolved internally, excluded from the
    completion ledger)."""

    at_s: float
    burst: int

    def __post_init__(self):
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s!r}")
        if int(self.burst) != self.burst or self.burst < 1:
            raise ValueError(
                f"burst must be a positive integer, got {self.burst!r}")


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """Declarative, seeded fault schedule for one serving process."""

    seed: int = 0
    rules: Tuple[ServeFaultRule, ...] = ()
    floods: Tuple[Flood, ...] = ()
    #: the engine thread raises inside its Nth admission batch
    #: (1-based); None = never. Drives the crash-path cancel sweep.
    crash_at_admission: Optional[int] = None

    def __post_init__(self):
        # the strict-parse property covers every field: a zero/negative
        # batch index would silently mean "crash at the first batch" —
        # a different schedule than the plan author wrote
        if self.crash_at_admission is not None \
                and self.crash_at_admission < 1:
            raise ValueError(
                f"crash_at_admission is 1-based; must be >= 1 or None, "
                f"got {self.crash_at_admission!r}")

    @property
    def enabled(self) -> bool:
        return bool(self.rules or self.floods
                    or self.crash_at_admission is not None)

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @staticmethod
    def _reject_unknown_keys(obj: dict, cls_, what: str) -> None:
        known = {f.name for f in dataclasses.fields(cls_)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f"unknown {what} key(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}")

    @classmethod
    def from_dict(cls, obj: dict) -> "ServeFaultPlan":
        cls._reject_unknown_keys(obj, cls, "plan")
        rules = []
        for r in obj.get("rules", ()):
            cls._reject_unknown_keys(r, ServeFaultRule, "rule")
            bad_ops = set(r.get("ops", ())) - set(SERVE_FAULT_OPS)
            if bad_ops:
                raise ValueError(
                    f"unknown serve fault op(s) {sorted(bad_ops)}; "
                    f"expected a subset of {SERVE_FAULT_OPS}")
            end = r.get("end_s")
            rules.append(ServeFaultRule(
                ops=tuple(r.get("ops", SERVE_FAULT_OPS)),
                stall_s=tuple(r.get("stall_s", (0.0, 0.0))),  # type: ignore
                fail=float(r.get("fail", 0.0)),
                half_close=float(r.get("half_close", 0.0)),
                start_s=float(r.get("start_s", 0.0)),
                end_s=None if end is None else float(end)))
        for fl in obj.get("floods", ()):
            cls._reject_unknown_keys(fl, Flood, "flood")
        floods = tuple(Flood(at_s=float(fl["at_s"]), burst=int(fl["burst"]))
                       for fl in obj.get("floods", ()))
        crash = obj.get("crash_at_admission")
        return cls(seed=int(obj.get("seed", 0)), rules=tuple(rules),
                   floods=floods,
                   crash_at_admission=None if crash is None else int(crash))

    @classmethod
    def from_json(cls, text: str) -> "ServeFaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, spec: str) -> "ServeFaultPlan":
        """A plan from an inline JSON object (starts with '{') or a
        path to a JSON file — ``--chaos-plan`` accepts both."""
        spec = spec.strip()
        if spec.startswith("{"):
            return cls.from_json(spec)
        with open(spec, "r", encoding="utf-8") as fh:
            return cls.from_json(fh.read())


class ServeChaos:
    """The plan's runtime: seam hooks called by the front-end, the
    pixel worker and the engine thread. One instance is SHARED by every
    component of one serving process (the engine owns it; `server.py`
    and `pixels.py` reach it through the engine) so flood state and the
    admission counter are process-global, like real load is."""

    def __init__(self, plan: ServeFaultPlan, clock=time.monotonic):
        self.plan = plan
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        self._admissions = 0
        self._floods_fired = [False] * len(plan.floods)
        # observability: what actually fired, by fault kind
        self.injected: Dict[str, int] = {}

    # -- deterministic decisions -------------------------------------------

    def _elapsed(self) -> float:
        return self._clock() - self._t0

    def _count(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + n

    def _roll(self, op: str, key: str) -> int:
        """A deterministic 128-bit roll for the next call on channel
        (op, key): hash of (seed, op, key, per-channel index). The
        failure draw (bits 0-19), half-close draw (bits 20-39) and
        stall jitter (bits 80-95) never share bits."""
        with self._lock:
            idx = self._counters.get((op, key), 0)
            self._counters[(op, key)] = idx + 1
        msg = f"{self.plan.seed}|{op}|{key}|{idx}"
        return int.from_bytes(
            hashlib.sha256(msg.encode()).digest()[:16], "big")

    def _rule_for(self, op: str) -> Optional[ServeFaultRule]:
        elapsed = self._elapsed()
        for r in self.plan.rules:
            if op in r.ops and r.active(elapsed):
                return r
        return None

    @staticmethod
    def _p(roll: int, shift: int) -> float:
        """One of several independent uniform [0,1) draws from a roll."""
        return ((roll >> shift) & 0xFFFFF) / float(1 << 20)

    def _stall(self, rule: ServeFaultRule, roll: int) -> None:
        lo, hi = rule.stall_s
        d = lo + (hi - lo) * ((roll >> 80 & 0xFFFF) / 0xFFFF)
        if d > 0:
            self._count("stall")
            time.sleep(min(d, MAX_INJECTED_STALL_S))

    # -- seam hooks --------------------------------------------------------

    def on_client_recv(self, conn_key: str) -> None:
        """Front-end, before reading a request body: a slow client."""
        rule = self._rule_for("client_recv")
        if rule is None:
            return
        self._stall(rule, self._roll("client_recv", conn_key))

    def on_client_send(self, conn_key: str) -> bool:
        """Front-end, after submit / before the response write. Returns
        True when the connection should be severed (the half-closed /
        vanished client) — the handler then shuts the read side down so
        its own disconnect probe fires, exactly the signal a real EOF
        delivers."""
        rule = self._rule_for("client_send")
        if rule is None:
            return False
        roll = self._roll("client_send", conn_key)
        self._stall(rule, roll)
        if self._p(roll, 20) < rule.half_close:
            self._count("half_close")
            return True
        return False

    def on_pixel(self, rid: int) -> None:
        """Pixel worker, before running the pixel fn for request
        ``rid``: stall and/or fail the stage."""
        rule = self._rule_for("pixel")
        if rule is None:
            return
        roll = self._roll("pixel", str(rid))
        self._stall(rule, roll)
        if self._p(roll, 0) < rule.fail:
            self._count("pixel_fail")
            raise ChaosInjectedError(
                f"chaos: injected pixel-stage failure for request {rid}")

    def on_admit(self, n_requests: int) -> None:
        """Engine thread, at the top of each admission batch. Raising
        here crashes the engine loop mid-admission (the _admitting
        window), which must cancel every outstanding handle — the
        crash-path sweep this hook exists to exercise."""
        with self._lock:
            self._admissions += 1
            batch_idx = self._admissions
        if (self.plan.crash_at_admission is not None
                and batch_idx >= self.plan.crash_at_admission):
            self._count("admit_crash")
            raise ChaosInjectedError(
                f"chaos: engine crash at admission batch {batch_idx} "
                f"({n_requests} request(s) mid-admission)")
        rule = self._rule_for("admit")
        if rule is None:
            return
        roll = self._roll("admit", str(batch_idx))
        self._stall(rule, roll)
        if self._p(roll, 0) < rule.fail:
            self._count("admit_crash")
            raise ChaosInjectedError(
                f"chaos: injected admission failure at batch {batch_idx}")

    def flood_due(self) -> int:
        """Engine loop, once per boundary: total synthetic-request burst
        due now (each flood fires exactly once, at the first boundary
        past its offset). NOT counted into ``injected`` here — the
        engine caps the burst to queue room and reports what actually
        landed via :meth:`note_flood`, so the chaos ledger never claims
        injection that never happened."""
        elapsed = self._elapsed()
        burst = 0
        with self._lock:
            for i, fl in enumerate(self.plan.floods):
                if not self._floods_fired[i] and elapsed >= fl.at_s:
                    self._floods_fired[i] = True
                    burst += fl.burst
        return burst

    def note_flood(self, n: int) -> None:
        """Engine callback: ``n`` synthetic requests actually entered
        the queue (after the capacity cap)."""
        if n:
            self._count("flood", n)


def maybe_wrap_serving(chaos_plan: Optional[str]) -> Optional[ServeChaos]:
    """A ServeChaos when a plan is configured and enabled
    (``ServingConfig.chaos_plan``: JSON file path or inline JSON), else
    ``None`` — the zero-cost disabled path every seam guards on."""
    if not chaos_plan:
        return None
    plan = ServeFaultPlan.load(chaos_plan)
    if not plan.enabled:
        return None
    logger.warning(
        "SERVE CHAOS ENABLED: faults injected per plan (seed=%d, "
        "%d rule(s), %d flood(s), crash_at_admission=%s) — this server "
        "is deliberately unreliable", plan.seed, len(plan.rules),
        len(plan.floods), plan.crash_at_admission)
    return ServeChaos(plan)
