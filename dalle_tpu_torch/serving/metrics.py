"""Serving metrics: per-request accounting + engine-level counters.

The port's copy of ``dalle_tpu/serving/metrics.py`` (stdlib and numpy
only): the same plan or the same calls give the same decisions and
counters, which ``tests/test_torch_serving.py`` holds.

Per request: queue wait (submit -> admit), TTFT (submit -> first image
code), latency (submit -> final artifact, pixels included when the
overlap worker runs), lane, deadline outcome. Engine-level: occupancy
(live slots / n_slots, sampled every step call), queue depth, img/s,
p50/p95 overall and p50/p95/p99 per lane, shed / brownout / mid-decode
cancel counters, goodput (deadline-met completions per second — the
number the overload soak's oracles read). A JSONL sink appends one
snapshot row per ``interval_s`` so a run leaves an auditable trace the
way the trainer's ``--metrics-file`` does.

The ledger also keeps a **decode service-time EMA** (admit -> harvest,
fed by the engine at harvest begin, so it is host-clock work measured
at the chunk granularity the r9 position mirror schedules at). This is
the cadence the deadline shedder multiplies by queue depth — see
``SlotScheduler.predict_completion_s``.

Thread-safety: the engine thread, the pixel worker and HTTP handler
threads all report here; every mutation holds ``_lock``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from dalle_tpu_torch.serving.scheduler import LANES

# completed-request records kept for percentile computation; FIFO-capped
# so a long-lived server's metrics stay O(1)
_MAX_RECORDS = 16384

#: service-EMA smoothing: ~the last dozen completions dominate, so the
#: shed predictor tracks load shifts without whiplashing on one outlier
_SERVICE_EMA_ALPHA = 0.3


def percentiles(values: List[float], qs=(50.0, 95.0)) -> List[float]:
    """Linear-interpolated percentiles ([] -> NaNs)."""
    if not values:
        return [float("nan")] * len(qs)
    arr = np.asarray(values, np.float64)
    return [float(np.percentile(arr, q)) for q in qs]


class ServingMetrics:
    def __init__(self, n_slots: int, jsonl_path: Optional[str] = None,
                 interval_s: float = 5.0):
        self.n_slots = n_slots
        self._jsonl_path = jsonl_path
        self._interval_s = interval_s
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._last_flush = self._t0
        self._submit_t: Dict[int, float] = {}
        self._admit_t: Dict[int, float] = {}
        self._ttft: Dict[int, float] = {}
        self._lane: Dict[int, str] = {}
        # per-rid prefix-cache verdict (set at admit when the engine
        # runs a prefix pool); rides the completion row so benches can
        # split TTFT by hit/miss per request
        self._prefix_hit: Dict[int, bool] = {}
        self._records: List[dict] = []
        self._submitted = 0
        self._admitted = 0
        self._completed = 0
        self._cancelled = 0
        self._cancelled_mid_decode = 0
        self._failed = 0
        self._shed = 0
        self._shed_queued = 0
        self._shed_by_lane = {lane: 0 for lane in LANES}
        self._completed_by_lane = {lane: 0 for lane in LANES}
        self._browned = 0
        self._flood_injected = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._deadline_met = 0
        self._deadline_missed = 0
        self._service_ema_s: Optional[float] = None
        self._occ_sum = 0.0
        self._occ_n = 0
        self._depth_sum = 0.0
        self._depth_max = 0
        self._depth_n = 0

    # -- per-request lifecycle ------------------------------------------

    def record_submit(self, rid: int, lane: str = LANES[0]) -> None:
        with self._lock:
            self._submitted += 1
            self._submit_t[rid] = time.monotonic()
            self._lane[rid] = lane

    def record_admit(self, rid: int,
                     prefix_hit: Optional[bool] = None) -> None:
        """``prefix_hit``: whether admission scattered a pooled prompt
        prefix (None = the engine runs no prefix pool — the completion
        row then carries no verdict)."""
        with self._lock:
            self._admitted += 1
            self._admit_t[rid] = time.monotonic()
            if prefix_hit is not None:
                self._prefix_hit[rid] = prefix_hit
                if prefix_hit:
                    self._prefix_hits += 1
                else:
                    self._prefix_misses += 1

    def record_first_code(self, rid: int) -> None:
        """First image code emitted (chunk-boundary granularity; the
        pipelined engine loop records at DISPATCH of the crossing
        chunk, so ttft_s is optimistic by up to one in-flight chunk —
        exact under ``host_sync_loop``. Latency/completion timing is
        device-confirmed either way: ``record_complete`` runs only
        after the codes have landed on the host)."""
        with self._lock:
            if rid not in self._ttft and rid in self._submit_t:
                self._ttft[rid] = time.monotonic() - self._submit_t[rid]

    def note_service(self, rid: int) -> None:
        """Engine harvest-begin hook: fold this request's admit→harvest
        decode time into the service EMA the deadline shedder reads.
        Host clocks only — never a device sync."""
        now = time.monotonic()
        with self._lock:
            t_adm = self._admit_t.get(rid)
            if t_adm is None:
                return
            s = now - t_adm
            self._service_ema_s = (
                s if self._service_ema_s is None
                else (1 - _SERVICE_EMA_ALPHA) * self._service_ema_s
                + _SERVICE_EMA_ALPHA * s)

    @property
    def service_ema_s(self) -> Optional[float]:
        """Measured decode service time per request (None until the
        first harvest — the shedder admits optimistically until then)."""
        with self._lock:
            return self._service_ema_s

    def prime_service(self, service_s: float,
                      force: bool = False) -> None:
        """Seed the service EMA from a calibration run (or a prior
        server's measurement) so the deadline shedder is live from the
        FIRST request instead of admitting optimistically until the
        first harvest. Later harvests fold in normally. ``force``
        overwrites an EXISTING EMA — the post-warm-up reset: the
        first wave's inflated samples (graph capture, warm-up)
        otherwise poison the cadence that shedding AND router
        placement read (a router
        shuns a freshly-booted engine for dozens of requests while the
        alpha-0.3 EMA decays back to truth)."""
        if not service_s > 0:
            raise ValueError(
                f"service_s must be > 0, got {service_s!r}")
        with self._lock:
            if force or self._service_ema_s is None:
                self._service_ema_s = service_s

    def record_complete(self, rid: int,
                        deadline_ok: Optional[bool] = None) -> dict:
        """Close out a request; returns its timing row (attached to the
        response by the front-end). ``deadline_ok``: whether it beat
        its deadline (None = it had none, which counts as met — goodput
        is work delivered in time, and undeadlined work always is)."""
        now = time.monotonic()
        with self._lock:
            t_sub = self._submit_t.pop(rid, now)
            t_adm = self._admit_t.pop(rid, t_sub)
            row = {
                "request_id": rid,
                "lane": self._lane.pop(rid, LANES[0]),
                "queue_wait_s": round(t_adm - t_sub, 6),
                "ttft_s": round(self._ttft.pop(rid, now - t_sub), 6),
                "latency_s": round(now - t_sub, 6),
            }
            if rid in self._prefix_hit:
                row["prefix_hit"] = self._prefix_hit.pop(rid)
            self._completed += 1
            self._completed_by_lane[row["lane"]] = \
                self._completed_by_lane.get(row["lane"], 0) + 1
            if deadline_ok is None or deadline_ok:
                self._deadline_met += 1
            else:
                self._deadline_missed += 1
            self._records.append(row)
            if len(self._records) > _MAX_RECORDS:
                del self._records[: len(self._records) - _MAX_RECORDS]
            return row

    def record_cancelled(self, rid: int, mid_decode: bool = False) -> None:
        with self._lock:
            self._cancelled += 1
            if mid_decode:
                self._cancelled_mid_decode += 1
            self._drop_timers(rid)

    def record_failed(self, rid: int) -> None:
        """A request that errored downstream (e.g. the pixel stage):
        closed out WITHOUT feeding the completion count or the latency
        percentiles — a burst of fast failures must not read as
        higher throughput on /stats."""
        with self._lock:
            self._failed += 1
            self._drop_timers(rid)

    def record_shed(self, lane: str, rid: Optional[int] = None) -> None:
        """A deadline shed — at submit (rid None, never queued) or at a
        boundary expiry (rid set: already submitted, timers dropped).
        Shed work is neither completed nor cancelled: it is load the
        SLO machinery refused before decode was spent, accounted
        separately so goodput-vs-shed stays auditable."""
        with self._lock:
            self._shed += 1
            self._shed_by_lane[lane] = self._shed_by_lane.get(lane, 0) + 1
            if rid is not None:
                # shed AFTER submit (expired in queue): distinguishable
                # so submitted == completed+cancelled+failed+shed_queued
                # stays a checkable identity for the soak oracles
                self._shed_queued += 1
                self._drop_timers(rid)

    def record_brownout(self) -> None:
        """A request served degraded under brownout (counted per
        request, not per trimmed image — SLOs are per request)."""
        with self._lock:
            self._browned += 1

    def record_flood(self, n: int) -> None:
        """Synthetic chaos-flood requests injected (they bypass the
        submitted/completed ledger entirely — they are load, not work)."""
        with self._lock:
            self._flood_injected += n

    def _drop_timers(self, rid: int) -> None:
        # callers hold _lock
        self._submit_t.pop(rid, None)
        self._admit_t.pop(rid, None)
        self._ttft.pop(rid, None)
        self._lane.pop(rid, None)
        self._prefix_hit.pop(rid, None)

    # -- engine-level sampling ------------------------------------------

    def record_step(self, live_slots: int, queue_depth: int) -> None:
        """Sampled by the engine at every chunk boundary."""
        with self._lock:
            self._occ_sum += live_slots / max(1, self.n_slots)
            self._occ_n += 1
            self._depth_sum += queue_depth
            self._depth_max = max(self._depth_max, queue_depth)
            self._depth_n += 1

    # -- reporting ------------------------------------------------------

    def counters(self) -> dict:
        """The O(1) counter slice — everything a readiness probe needs,
        none of the percentile sorting ``snapshot`` pays. Probes must
        stay cheap and truthful when everything else is on fire."""
        with self._lock:
            elapsed = max(1e-9, time.monotonic() - self._t0)
            return {
                "shed": self._shed,
                "browned": self._browned,
                "cancelled_mid_decode": self._cancelled_mid_decode,
                "goodput_img_per_s": round(
                    self._deadline_met / elapsed, 4),
                "prefix_hits": self._prefix_hits,
                "prefix_misses": self._prefix_misses,
                "service_ema_s": (None if self._service_ema_s is None
                                  else round(self._service_ema_s, 6)),
            }

    def snapshot(self) -> dict:
        with self._lock:
            lat = [r["latency_s"] for r in self._records]
            ttft = [r["ttft_s"] for r in self._records]
            p50, p95 = percentiles(lat)
            t50, t95 = percentiles(ttft)
            lanes = {}
            for lane in LANES:
                lane_lat = [r["latency_s"] for r in self._records
                            if r["lane"] == lane]
                l50, l95, l99 = percentiles(lane_lat, (50.0, 95.0, 99.0))
                lanes[lane] = {
                    # cumulative, matching the top-level ledger; the
                    # percentiles below run over the FIFO-capped record
                    # window (last _MAX_RECORDS completions)
                    "completed": self._completed_by_lane.get(lane, 0),
                    "shed": self._shed_by_lane.get(lane, 0),
                    "p50_latency_s": round(l50, 6),
                    "p95_latency_s": round(l95, 6),
                    "p99_latency_s": round(l99, 6),
                }
            elapsed = max(1e-9, time.monotonic() - self._t0)
            return {
                "uptime_s": round(elapsed, 3),
                "submitted": self._submitted,
                "admitted": self._admitted,
                "completed": self._completed,
                "cancelled": self._cancelled,
                "cancelled_mid_decode": self._cancelled_mid_decode,
                "failed": self._failed,
                "shed": self._shed,
                "shed_queued": self._shed_queued,
                "browned": self._browned,
                "flood_injected": self._flood_injected,
                "prefix_hits": self._prefix_hits,
                "prefix_misses": self._prefix_misses,
                "deadline_met": self._deadline_met,
                "deadline_missed": self._deadline_missed,
                "img_per_s": round(self._completed / elapsed, 4),
                "goodput_img_per_s": round(
                    self._deadline_met / elapsed, 4),
                "service_ema_s": (None if self._service_ema_s is None
                                  else round(self._service_ema_s, 6)),
                "p50_latency_s": round(p50, 6),
                "p95_latency_s": round(p95, 6),
                "p50_ttft_s": round(t50, 6),
                "p95_ttft_s": round(t95, 6),
                "lanes": lanes,
                "mean_occupancy": round(
                    self._occ_sum / self._occ_n, 4) if self._occ_n else 0.0,
                "mean_queue_depth": round(
                    self._depth_sum / self._depth_n,
                    4) if self._depth_n else 0.0,
                "max_queue_depth": self._depth_max,
            }

    def maybe_flush(self) -> None:
        """Append one snapshot row to the JSONL sink if the interval
        elapsed (no-op without a path). Called from the engine loop."""
        if not self._jsonl_path or self._interval_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_flush < self._interval_s:
                return
            self._last_flush = now
        row = self.snapshot()
        row["t"] = time.time()
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
