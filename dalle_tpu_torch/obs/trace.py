"""Swarm flight recorder: protocol-id span tracing for both planes.

The port's copy of ``dalle_tpu/obs/trace.py`` (stdlib only, unchanged);
the serving engine records its request lifecycle through it when
``ServingConfig.trace_file`` is set.

The soak gates can tell you *that* a run went red; until now nothing
could tell you which phase of which round on which peer stalled or
diverged first — the only evidence was counters and interleaved log
lines. This module is the missing layer: monotonic-clock spans whose
trace ids are **protocol ids** (swarm ``{prefix}:{epoch}`` round ids,
state-transfer nonces, serving request ids), so per-peer span files
merge into one cross-peer round timeline with no clock synchronization
at all. Wall clocks never enter a trace id; within one peer the
monotonic ``t0`` orders spans, across peers the protocol id does — the
same shared-round-id determinism the r14 audit challenge exploits.

Three consumers share one :class:`Tracer`:

- the **JSONL sink** appends one row per span (``sink_path``), the
  per-peer half of a cross-peer timeline (`scripts/trace_report.py`
  merges them);
- the **flight ring** keeps the most recent spans in a byte-capped
  in-memory ring (the r16 audit-ring discipline) so a failure can dump
  the last N rounds (:meth:`Tracer.dump`, ``SOAK_FLIGHT.json``);
- the **phase histograms** accumulate per-(plane, phase) latency
  buckets for the Prometheus exposition (`obs/exposition.py`).

Disabled is FREE: every instrumented call site guards on
``tracer is None`` (or goes through :func:`span`, which returns the
shared :data:`NULL_SPAN` singleton — no allocation, no clock read), so
recorder-off code paths are bit/byte-identical to the uninstrumented
protocol. This transparency is pinned by ``tests/test_obs.py``.

Locking discipline: :meth:`Tracer.add` takes only the tracer's own
lock and touches memory only — file writes happen in :meth:`flush`,
which swaps the pending buffer under the lock and writes OUTSIDE it
(the exact shape the graftlint ``blocking-io-under-lock`` rule
enforces; a hot-path JSONL sink is the pattern that rule exists for).

Span row schema (one JSON object per line; OBSERVABILITY.md):

``{"v": 1, "peer": str, "plane": "swarm"|"serving", "phase": str,
"trace": str, "t0": float, "dur_s": float, "a": {...}}``

``t0`` is this peer's ``time.monotonic()`` at span start — meaningful
only relative to other spans from the SAME peer. Events are spans with
``dur_s == 0``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

SCHEMA_VERSION = 1

#: log-spaced latency buckets (seconds) for the per-phase histograms —
#: the Prometheus ``le`` edges; one implicit +Inf bucket follows.
BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: cheap per-row byte ESTIMATE for the ring cap (exact JSON sizing
#: would cost an encode per span on the hot path; the ring exists to
#: bound memory, and a conservative estimate bounds it just as hard)
_ROW_BASE_BYTES = 112
_ATTR_EST_BYTES = 28


class _NullSpan:
    """The shared disabled-path span: a no-op context manager. One
    module singleton — identity-comparable, so tests can PROVE the
    disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records on ``__exit__`` (errors annotate, never
    swallow). ``set(**attrs)`` attaches attributes mid-flight."""

    __slots__ = ("_tracer", "plane", "phase", "trace", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", plane: str, phase: str,
                 trace: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.plane = plane
        self.phase = phase
        self.trace = trace
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        return self

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = self._tracer._clock()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer.add(self.plane, self.phase, self.trace,
                         self._t0, t1 - self._t0, **self.attrs)
        return False


def span(tracer: Optional["Tracer"], plane: str, phase: str,
         trace: str, **attrs):
    """``with span(maybe_tracer, ...)`` — the guarded call-site helper.
    With ``tracer=None`` this returns the shared :data:`NULL_SPAN`
    (zero allocation, zero clock reads): disabled tracing costs one
    ``is None`` test."""
    if tracer is None:
        return NULL_SPAN
    return tracer.span(plane, phase, trace, **attrs)


class Tracer:
    """One peer's span recorder: flight ring + optional JSONL sink +
    per-phase latency histograms. Thread-safe; every mutation holds
    ``_lock``, and the lock is never held across I/O."""

    def __init__(self, peer: str = "", sink_path: Optional[str] = None,
                 ring_bytes: int = 256 * 1024,
                 flush_interval_s: float = 2.0,
                 clock=time.monotonic):
        self.peer = peer
        self.sink_path = sink_path
        self.ring_bytes = int(ring_bytes)
        self.flush_interval_s = flush_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque()      # (est_bytes, row)
        self._ring_used = 0
        self._pending: List[dict] = []   # rows awaiting the sink flush
        self._last_flush = 0.0
        # (plane, phase) -> [bucket counts (len(BUCKETS_S)+1), sum, n]
        self._hist: Dict[Tuple[str, str], list] = {}
        self.spans_recorded = 0
        self.ring_evictions = 0

    # -- recording -------------------------------------------------------

    def span(self, plane: str, phase: str, trace: str, **attrs) -> _Span:
        return _Span(self, plane, phase, trace, attrs)

    def event(self, plane: str, phase: str, trace: str, **attrs) -> None:
        """A zero-duration span (lifecycle marker: submit, admit,
        fault_injected, ...)."""
        self.add(plane, phase, trace, self._clock(), 0.0, **attrs)

    def add(self, plane: str, phase: str, trace: str, t0: float,
            dur_s: float, **attrs) -> None:
        """Record one span from pre-measured times — how the optimizer
        converts its existing ``last_timings`` seams into spans without
        re-timing anything. Memory-only: never touches the sink file."""
        row = {"v": SCHEMA_VERSION, "peer": self.peer, "plane": plane,
               "phase": phase, "trace": trace,
               "t0": round(t0, 6), "dur_s": round(dur_s, 6)}
        if attrs:
            row["a"] = attrs
        est = (_ROW_BASE_BYTES + len(phase) + len(trace)
               + _ATTR_EST_BYTES * len(attrs))
        hkey = (plane, phase)
        with self._lock:
            self.spans_recorded += 1
            self._ring.append((est, row))
            self._ring_used += est
            while self._ring_used > self.ring_bytes and len(self._ring) > 1:
                gone, _ = self._ring.popleft()
                self._ring_used -= gone
                self.ring_evictions += 1
            if self.sink_path is not None:
                self._pending.append(row)
            if dur_s <= 0.0:
                return  # events are markers, not latencies: they ride
                # the ring/sink but never the phase histograms (the
                # same treatment trace_report's phase table applies)
            h = self._hist.get(hkey)
            if h is None:
                h = self._hist[hkey] = [[0] * (len(BUCKETS_S) + 1),
                                        0.0, 0]
            counts = h[0]
            i = 0
            for edge in BUCKETS_S:
                if dur_s <= edge:
                    break
                i += 1
            counts[i] += 1
            h[1] += dur_s
            h[2] += 1

    # -- the JSONL sink --------------------------------------------------

    def maybe_flush(self) -> None:
        """Flush the sink if the interval elapsed — the engine-loop /
        epoch-boundary cadence hook (no-op without a sink)."""
        if self.sink_path is None:
            return
        now = self._clock()
        with self._lock:
            if now - self._last_flush < self.flush_interval_s:
                return
            self._last_flush = now
        self.flush()

    def flush(self) -> None:
        """Write buffered rows to the JSONL sink. The buffer is swapped
        out under the lock; encoding and the file write happen OUTSIDE
        it (blocking-io-under-lock discipline)."""
        if self.sink_path is None:
            return
        with self._lock:
            rows, self._pending = self._pending, []
        if not rows:
            return
        text = "".join(json.dumps(r) + "\n" for r in rows)
        with open(self.sink_path, "a", encoding="utf-8") as fh:
            fh.write(text)

    # -- the flight ring -------------------------------------------------

    def dump(self) -> List[dict]:
        """The ring's current rows, oldest first (copies of the row
        dicts' references — rows are write-once after ``add``)."""
        with self._lock:
            return [row for _est, row in self._ring]

    def last_rounds(self, n: int = 3) -> List[dict]:
        """Rows belonging to the last ``n`` distinct trace ids seen —
        "the last N rounds" a failure dump wants, regardless of how
        many spans each round produced."""
        rows = self.dump()
        seen: List[str] = []
        for row in reversed(rows):
            t = row["trace"]
            if t not in seen:
                seen.append(t)
                if len(seen) >= n:
                    break
        keep = set(seen)
        return [r for r in rows if r["trace"] in keep]

    # -- exposition ------------------------------------------------------

    def histogram_snapshot(self) -> Dict[Tuple[str, str], dict]:
        """Per-(plane, phase) cumulative latency histograms:
        ``{"buckets": [(le, cumulative_count), ...], "sum": s,
        "count": n}`` with a final ``("+Inf", n)`` bucket — directly
        renderable as a Prometheus histogram."""
        with self._lock:
            out = {}
            for key, (counts, total, n) in self._hist.items():
                cum, acc = [], 0
                for edge, c in zip(BUCKETS_S, counts):
                    acc += c
                    cum.append((edge, acc))
                cum.append(("+Inf", n))
                out[key] = {"buckets": cum, "sum": total, "count": n}
            return out


# -- merging (trace_report + the soak flight dumps) -----------------------

def _trace_key(trace: str) -> tuple:
    """Natural sort key for protocol trace ids: numeric ``:``-separated
    segments compare as integers, so ``run:grads:10`` sorts AFTER
    ``run:grads:9`` (lexicographic order would misorder every run past
    epoch 9)."""
    return tuple((0, int(seg)) if seg.isdigit() else (1, seg)
                 for seg in str(trace).split(":"))


def merge_rows(per_peer_rows: Iterable[Iterable[dict]]) -> List[dict]:
    """Merge per-peer span rows into one cross-peer timeline, ordered
    by (trace id, peer, t0) — trace ids in natural (epoch-numeric)
    order. Clocks are per-peer monotonic — only the within-peer order
    of ``t0`` is meaningful, which is exactly what this sort preserves;
    across peers the shared PROTOCOL trace id is the correlation, not
    the clock."""
    merged = [row for rows in per_peer_rows for row in rows]
    merged.sort(key=lambda r: (_trace_key(r.get("trace", "")),
                               str(r.get("peer", "")),
                               float(r.get("t0", 0.0))))
    return merged


def load_jsonl(path: str) -> List[dict]:
    """Rows from one per-peer JSONL trace file (bad lines skipped —
    a crash mid-append may tear the final line)."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict) and "phase" in row:
                out.append(row)
    return out


# -- process-default tracer (CLI wiring) ----------------------------------

_default: Optional[Tracer] = None


def configure(peer: str = "", sink_path: Optional[str] = None,
              ring_bytes: int = 256 * 1024) -> Tracer:
    """Install (and return) the process-default tracer. Library code
    takes tracers as explicit parameters — this default exists for CLI
    entry points and tools that want one shared recorder."""
    global _default
    _default = Tracer(peer=peer, sink_path=sink_path,
                      ring_bytes=ring_bytes)
    return _default


def default_tracer() -> Optional[Tracer]:
    return _default
