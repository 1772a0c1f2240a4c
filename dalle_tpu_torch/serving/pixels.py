"""Pixel stage overlap: VQGAN decode + CLIP rerank of finished slots.

The port's copy of ``dalle_tpu/serving/pixels.py``. On the card the
worker runs ``pixel_fn`` on a CUDA stream of its own, so the pixel
stage's kernels overlap the engine's chunk graphs; it reads only code
rows the engine already copied to the host behind an event.

The one-shot CLI runs the reference pipeline serially — generate all
codes, then VQGAN-decode to pixels, then CLIP-score (``decode_bench.py``
e2e measures exactly that serialization). Online, that puts the conv
stack and the ViT forward on the token-generation critical path. This
worker moves them off it: the engine hands each finished slot's codes to
a bounded queue and keeps decoding wave *i+1* while this thread turns
wave *i* into pixels and scores.

One worker, bounded queue, daemonized, signalled AND bounded-joined by
``stop()`` — the ``tests/test_thread_lifecycle.py`` no-stray-threads
discipline (same shape as ``training/remote_sink.UploadWorker``). The
bounded queue is deliberate backpressure: if the pixel stage truly is
the bottleneck, the engine blocks on submit rather than queueing
unboundedly.

Overload hooks (r12): a job handed off while the engine is browned out
runs ``degraded_fn`` when one is configured (typically VQGAN decode
WITHOUT the CLIP rerank — brownout trades candidate quality for
latency, never correctness), and the serve-chaos seam
(``serving/chaos.py``) may stall or fail a job here exactly where a
real VQGAN/CLIP hiccup would land.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from dalle_tpu_torch.serving.chaos import ServeChaos
from dalle_tpu_torch.serving.metrics import ServingMetrics

logger = logging.getLogger(__name__)


class PixelPipeline:
    """Runs ``pixel_fn(codes) -> dict`` per finished request on a worker
    thread and resolves the request's handle with codes + that dict.

    ``pixel_fn`` takes an (image_seq_len,) int32 code row and returns a
    dict to merge into the result payload — typically ``{"images":
    (H, W, 3) uint8}`` and optionally ``{"clip_score": float}``. It runs
    only on this thread (on ``stream``, when one is given: work on the
    card then runs beside the engine's), so it needs no locking.

    ``degraded_fn``: the brownout variant (same contract). When the
    engine hands off a job with ``degraded=True`` and a degraded fn
    exists, it runs instead and the payload is marked
    ``"degraded": true`` — the client learns its artifact was served
    under brownout. Without a degraded fn the full fn still runs (the
    flag still rides the payload; brownout then only trims image
    counts at the front-end).
    """

    def __init__(self, pixel_fn: Callable[[np.ndarray], dict],
                 metrics: Optional[ServingMetrics] = None,
                 degraded_fn: Optional[Callable[[np.ndarray], dict]] = None,
                 chaos: Optional[ServeChaos] = None,
                 maxsize: int = 32, stream=None):
        self._fn = pixel_fn
        self._stream = stream
        self._degraded_fn = degraded_fn
        # bind_metrics/bind_chaos/bind_tracer rebind these ONCE
        # (None -> engine's instance) right after construction; the
        # worker tolerates the brief None window, so the unsynchronized
        # single-transition publication is deliberate
        # graftlint: handoff=bind-once-wiring
        self._metrics = metrics
        # graftlint: handoff=bind-once-wiring
        self._chaos = chaos
        # graftlint: handoff=bind-once-wiring
        self._tracer = None
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(target=self._run,
                                        name="pixel-worker", daemon=True)
        self._thread.start()

    def bind_metrics(self, metrics: ServingMetrics) -> None:
        """Adopt the engine's metrics when none were given at
        construction (DecodeEngine calls this) so completions recorded
        here and submissions recorded there land in one ledger."""
        if self._metrics is None:
            self._metrics = metrics

    def bind_chaos(self, chaos: Optional[ServeChaos]) -> None:
        """Adopt the engine's ServeChaos (one shared seam per serving
        process — DecodeEngine calls this, mirroring bind_metrics)."""
        if self._chaos is None:
            self._chaos = chaos

    def bind_tracer(self, tracer) -> None:
        """Adopt the engine's flight recorder (obs/trace.py) so the
        pixel stage's spans land in the same per-request timeline as
        the engine's admit/harvest events. None = tracing off."""
        if self._tracer is None:
            self._tracer = tracer

    def submit(self, handle, rid: int, codes: np.ndarray,
               degraded: bool = False,
               deadline: Optional[float] = None) -> None:
        """Blocking put — backpressure when the pixel stage lags.
        ``degraded``: the engine was browned out at harvest;
        ``deadline``: the request's absolute monotonic deadline (its
        met/missed verdict is judged AFTER pixels, where the client
        actually receives the artifact)."""
        self._q.put((handle, rid, codes, degraded, deadline))

    def stop(self, timeout: float = 60.0) -> None:
        """Drain everything already queued, then reap the worker. The
        sentinel rides the FIFO behind pending jobs, so every handed-off
        request still resolves. Bounded even when the worker is wedged
        mid-job with a full queue (the sentinel put itself times out
        rather than blocking shutdown forever)."""
        try:
            self._q.put(None, timeout=timeout)
        except queue.Full:
            logger.warning("pixel queue still full after %.1fs; "
                           "abandoning the worker (daemon)", timeout)
            return
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning("pixel worker did not drain within %.1fs",
                           timeout)

    def _run(self) -> None:
        if self._stream is None:
            self._work()
            return
        import torch
        with torch.cuda.stream(self._stream):
            self._work()

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            handle, rid, codes, degraded, deadline = item
            if not handle._claim():
                # resolved elsewhere (the engine's stop()-abandonment
                # sweep or a mid-decode cancel won the race): skip the
                # work AND the ledger — a request must never count both
                # cancelled and completed/failed
                continue
            fn = (self._degraded_fn
                  if degraded and self._degraded_fn is not None
                  else self._fn)
            try:
                if self._chaos is not None:
                    self._chaos.on_pixel(rid)
                if self._tracer is None:
                    extra = fn(codes)
                else:
                    t0 = time.monotonic()
                    extra = fn(codes)
                    self._tracer.add("serving", "pixels", f"req:{rid}",
                                     t0, time.monotonic() - t0,
                                     degraded=degraded)
            except Exception as e:  # noqa: BLE001 - a pixel-stage
                # failure (ChaosInjectedError included) must fail THAT
                # request, never kill the worker the engine relies on
                # for every later completion
                logger.warning("pixel stage failed for request %d: %s",
                               rid, e)
                if self._metrics:   # failed, NOT completed: keep /stats
                    self._metrics.record_failed(rid)   # throughput honest
                handle._deliver({"error": f"pixel stage failed: {e}"})
                continue
            if degraded:
                extra = {**extra, "degraded": True}
            deadline_ok = (None if deadline is None
                           else time.monotonic() <= deadline)
            row = (self._metrics.record_complete(rid,
                                                 deadline_ok=deadline_ok)
                   if self._metrics else {})
            handle._deliver({"codes": codes, **extra, **row})
            if self._tracer is not None:
                self._tracer.event("serving", "complete", f"req:{rid}")
