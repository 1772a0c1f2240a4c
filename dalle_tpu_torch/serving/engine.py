"""Slot-recycled continuous-batching decode engine (counterpart of
``dalle_tpu/serving/engine.py``).

``generate_images`` decodes a batch in lockstep: one shared position,
every request entering and leaving together. This engine runs the SAME
per-row math (``decode_step`` with a per-slot position tensor) but gives
every KV-cache slot its own clock: a request is admitted into any free
slot at a chunk boundary, decodes its teacher-forced text prefix and its
sampled image codes at its own offset, and the slot is recycled from the
request queue the moment it finishes. Completed slots hand off to the
pixel worker (``serving/pixels.py``) while token generation continues.

Structure:

- Device state (:class:`EngineState`): the KV cache at ``n_slots`` batch
  rows plus per-slot position / next-input / seed / text prefix /
  emitted-code / sampling-knob tensors. They are allocated once and every
  chunk, admission, release and warm scatter writes them in place.
- The chunk (:class:`ChunkRunner`): ``steps_per_call`` decode steps of
  every slot. On the CPU it runs eagerly. On the card it replays one CUDA
  graph per visible bucket, all captured in :meth:`DecodeEngine.start`
  (before the engine thread and the HTTP handlers exist) into one shared
  memory pool; the sampling knobs are per-slot tensors, so one graph
  serves every request's SamplingConfig. A capture or a replay that
  fails raises: the card never falls back to the eager chunk.
- Host loop (:meth:`DecodeEngine._run`): **zero-sync** — positions
  advance deterministically by ``steps_per_call`` for live slots, so the
  host mirrors them in numpy, launches chunk k+1 while chunk k still
  computes, and never blocks on a device read. The only device reads are
  per-completion code rows, copied ``non_blocking`` into pinned buffers
  behind a CUDA event and resolved one chunk later.

Per-row draws: the sampling noise of a slot is a function of (request
seed, position, vocabulary index) (``decode.gumbel_noise``), so a request
admitted mid-flight samples the codes of its own ``generate_images`` run
with the same seed, whatever slot it lands in and whoever shares the
batch, and a warm admission at ``pos = text_seq_len`` needs no generator
state from the skipped text positions.

Prefix buckets: attention reads are truncated to the smallest bucket
bound covering every live slot's chunk-end position (``resolve_buckets``
picks the bucket count, the policy ``generate_images`` uses).

Overload SLOs: admission runs over priority lanes (``scheduler.LANES``,
bounded low-lane bypass); a request with a deadline is SHED before any
decode is spent when the predicted completion (queue depth x measured
service cadence) misses it, and re-shed from the queue when its deadline
becomes unmeetable; :meth:`DecodeEngine.cancel` frees a live slot at the
next chunk boundary; sustained saturation engages brownout (trimmed image
counts, degraded pixel stage) instead of a 429 wall. The seeded serving
fault seam (``serving/chaos.py``) hooks admission (crash/stall) and timed
queue floods directly in this loop.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dalle_tpu_torch.config import ModelConfig, ServingConfig
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.decode import (SamplingConfig, bucket_bounds,
                                           decode_step, decode_tables,
                                           gumbel_noise, init_cache,
                                           resolve_buckets, sample_logits)
from dalle_tpu_torch.serving.chaos import ServeChaos, maybe_wrap_serving
from dalle_tpu_torch.serving.metrics import ServingMetrics
from dalle_tpu_torch.serving.prefix_cache import (PrefixCache,
                                                  extract_prefix,
                                                  prefix_entry_bytes,
                                                  prompt_fingerprint,
                                                  scatter_prefix,
                                                  stack_entries)
from dalle_tpu_torch.serving.scheduler import (LANES, SlotScheduler,
                                               kv_bytes_per_slot)

logger = logging.getLogger(__name__)

#: request seeds are int64 on the device
SEED_MIN, SEED_MAX = -2 ** 63, 2 ** 63 - 1


class QueueFullError(RuntimeError):
    """submit() refused: the request queue is at capacity (back off and
    retry — the front-end maps this to HTTP 429)."""


class EngineStoppedError(RuntimeError):
    """submit() refused: the engine is stopping or its thread is gone
    (the front-end maps this to HTTP 503)."""


class DeadlineShedError(RuntimeError):
    """submit() refused BEFORE any decode was spent: the predicted
    completion (queue depth × measured service cadence, see
    ``SlotScheduler.predict_completion_s``) already misses the
    request's deadline. The front-end maps this to HTTP 429 with
    ``"shed": true`` — the honest answer under overload is an instant
    cheap no, not a 504 after burning a slot."""


class EngineState(NamedTuple):
    """Per-slot decode state, allocated once on the model's device and
    updated in place. ``pos == total_seq_len`` marks a slot free (or
    finished and awaiting harvest). The sampling knobs ride here, so one
    chunk (one captured graph a bucket) serves every request's
    SamplingConfig."""

    cache: Dict[str, torch.Tensor]   # init_cache(cfg, n_slots): k, v
    pos: torch.Tensor          # (S,) int64 next position to decode
    tokens: torch.Tensor       # (S,) int64 input token for that position
    seeds: torch.Tensor        # (S,) int64 per-request noise seeds
    text: torch.Tensor         # (S, text_seq_len) int64 prefixes
    codes: torch.Tensor        # (S, image_seq_len) int64 emitted codes
    temp: torch.Tensor         # (S,) f32 per-slot sampling temperature
    top_k: torch.Tensor        # (S,) int64 per-slot top-k (0 = off)
    top_p: torch.Tensor        # (S,) f32 per-slot top-p (1.0 = off)


def init_state(cfg: ModelConfig, n_slots: int, device) -> EngineState:
    """Every slot free."""
    s, total = n_slots, cfg.total_seq_len

    def full(value, *shape, dtype=torch.long):
        return torch.full(shape, value, dtype=dtype, device=device)

    return EngineState(
        cache=init_cache(cfg, s, device),
        pos=full(total, s), tokens=full(cfg.vocab_total, s),
        seeds=full(0, s), text=full(0, s, cfg.text_seq_len),
        codes=full(0, s, cfg.image_seq_len),
        temp=full(1.0, s, dtype=torch.float32), top_k=full(0, s),
        top_p=full(1.0, s, dtype=torch.float32))


@torch.no_grad()
def chunk_step(model: DALLE, st: EngineState, tables, visible: int) -> None:
    """One decode position of every slot, in place on ``st``; no host
    sync (it is captured in a CUDA graph on the card)."""
    cfg = model.cfg
    total, text_len = cfg.total_seq_len, cfg.text_seq_len
    active = st.pos < total
    # done/free slots clamp to the last position; their writes land on a
    # row the causal mask hides from any NEW occupant (a recycled slot
    # rewrites rows 0..p before reading them)
    pos_c = torch.clamp(st.pos, max=total - 1)
    logits, _ = decode_step(model, st.cache, st.tokens, pos_c, tables,
                            visible=visible)
    sampled = sample_logits(
        logits, SamplingConfig(st.temp, st.top_k, st.top_p),
        gumbel_noise(st.seeds, pos_c, cfg.vocab_total))
    # position p emits S_p, the input at p+1: teacher-forced to the
    # caption while p is a text position, the sampled code once p is in
    # the image block (generate_images parity)
    tf = st.text.gather(1, torch.clamp(pos_c, max=text_len - 1)[:, None])
    nxt = torch.where(pos_c < text_len, tf[:, 0], sampled)
    rows = torch.arange(st.codes.shape[0], device=st.codes.device)
    img_idx = torch.clamp(pos_c - text_len, 0, cfg.image_seq_len - 1)
    emit = active & (pos_c >= text_len)
    st.codes[rows, img_idx] = torch.where(emit, sampled - cfg.vocab_text,
                                          st.codes[rows, img_idx])
    st.tokens.copy_(torch.where(active, nxt, st.tokens))
    st.pos.copy_(torch.where(active, st.pos + 1, st.pos))


class ChunkRunner:
    """``n_steps`` chunk steps at one visible bucket. On the CPU
    :meth:`run` is :meth:`eager`; on the card it replays the bucket's
    graph from :meth:`capture` and raises when there is none."""

    def __init__(self, model: DALLE, state: EngineState, n_steps: int,
                 bounds: List[int]):
        self.model, self.state = model, state
        self.n_steps, self.bounds = n_steps, list(bounds)
        self.device = state.pos.device
        self.tables = decode_tables(model.cfg, self.device)
        # filled by capture(), which DecodeEngine.start() runs before it
        # starts the engine thread; the thread only reads it after that
        # graftlint: handoff=captured-before-engine-thread-start
        self.graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}

    def eager(self, visible: int) -> None:
        for _ in range(self.n_steps):
            chunk_step(self.model, self.state, self.tables, visible)

    def capture(self) -> None:
        """One graph a bucket, into one shared pool, each after one eager
        warm-up chunk on this runner's capture stream (every slot is free
        at capture, so the warm-up changes nothing a request reads: it
        writes cache row T-1 of free slots). Call before any other thread
        uses the card.

        The capture stream is the runner's own: cuBLAS keeps a workspace a
        stream, and a graph replays with the workspace of the stream it
        was captured on. On torch's default capture stream, one for the
        process, two engines' graphs would share one workspace and
        corrupt each other's products when they replay at once."""
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need the model on the card")
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        for visible in self.bounds:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.eager(visible)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.eager(visible)
            self.graphs[visible] = graph
        torch.cuda.synchronize(self.device)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every state tensor by name (the cache's as ``cache.k``,
        ``cache.v``)."""
        out = {f"cache.{n}": t for n, t in self.state.cache.items()}
        out.update((n, t) for n, t in self.state._asdict().items()
                   if n != "cache")
        return out

    def replay_equals_eager(self, visible: int) -> List[str]:
        """One chunk run eagerly and one run by :meth:`run` (the graph
        replay, on the card) from the same state: the names of the state
        tensors whose bits differ afterwards (none, when the graph holds
        the eager chunk). Leaves the state as it found it."""
        state = self.tensors()
        before = {n: t.clone() for n, t in state.items()}

        def restore():
            for n, t in state.items():
                t.copy_(before[n])

        self.eager(visible)
        eager = {n: t.clone() for n, t in state.items()}
        restore()
        self.run(visible)
        differ = [n for n, t in state.items() if not torch.equal(t, eager[n])]
        restore()
        return differ

    def run(self, visible: int) -> None:
        if self.device.type != "cuda":
            self.eager(visible)
            return
        graph = self.graphs.get(visible)
        if graph is None:
            raise RuntimeError(
                f"no captured graph for visible bucket {visible} "
                f"(captured: {sorted(self.graphs)}); DecodeEngine.start() "
                "captures them")
        graph.replay()


def _on(device, array: np.ndarray) -> torch.Tensor:
    """A host array on ``device``: through a pinned buffer and a
    non-blocking copy on the card (the host does not wait)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class RequestHandle:
    """Future for one submitted request. ``result()`` blocks until the
    engine (or the pixel worker, when attached) resolves it."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._claimed = False
        self._payload: Optional[dict] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (or ``timeout``); True when resolved.
        Unlike :meth:`result` this never raises — front-end wait loops
        interleave it with client-disconnect probes."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        """Payload dict: ``codes`` (image_seq_len,) int32 plus, with a
        pixel pipeline, ``images``/``clip_score``; plus the timing row
        (``latency_s``, ``ttft_s``, ``queue_wait_s``). Raises on
        timeout or cancellation."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done within {timeout}s")
        if "error" in self._payload:
            # typed markers ride the payload so the front-end maps a
            # queued-shed to 429 and an engine-stop cancellation to 503
            # (retryable elsewhere — a router fails these over) without
            # matching message text
            exc = (DeadlineShedError if self._payload.get("shed")
                   else EngineStoppedError if self._payload.get("stopped")
                   else RuntimeError)
            raise exc(
                f"request {self.request_id}: {self._payload['error']}")
        return self._payload

    def _claim(self) -> bool:
        """Atomically claim the right to resolve this handle (first
        claim wins — the engine, the pixel worker and the stop()-
        abandonment path can race). The winner, and ONLY the winner,
        may feed the metrics ledger and then ``_deliver``."""
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def _deliver(self, payload: dict) -> None:
        """Publish the payload and wake waiters. Call only after
        winning ``_claim()``."""
        self._payload = payload
        self._event.set()

    def _resolve(self, payload: dict) -> bool:
        """claim + deliver in one step; returns whether this call won."""
        if not self._claim():
            return False
        self._deliver(payload)
        return True


@dataclass
class _Pending:
    rid: int
    text: np.ndarray
    seed: int
    handle: RequestHandle
    sampling: SamplingConfig
    lane: str = LANES[0]
    #: absolute monotonic completion deadline; None = never shed
    deadline: Optional[float] = None
    #: chaos-flood filler: occupies queue + decode capacity like real
    #: work but resolves out of band and never feeds the ledger
    synthetic: bool = False
    first_code_seen: bool = field(default=False)
    #: prompt fingerprint for the prefix pool (None = pool off or
    #: synthetic); hit verdict set at admission
    prefix_key: Optional[str] = None
    prefix_hit: bool = False


class DecodeEngine:
    """The continuous-batching engine. ``start()`` spawns the decode
    thread (daemonized); ``stop()`` signals AND bounded-joins it — the
    ``tests/test_thread_lifecycle.py`` discipline. On the card,
    ``start()`` first captures the chunk graphs (see :class:`ChunkRunner`).

    When a :class:`~dalle_tpu_torch.serving.pixels.PixelPipeline` is attached
    the engine hands each finished slot's codes to it and keeps
    decoding; the pipeline resolves the request's handle (and its
    completion metrics) after pixels + rerank. The engine owns the
    pipeline's shutdown: ``stop()`` drains and reaps it.
    """

    def __init__(self, model: DALLE, cfg: Optional[ModelConfig] = None,
                 serving: Optional[ServingConfig] = None,
                 sampling: SamplingConfig = SamplingConfig(),
                 pixel_pipeline=None,
                 metrics: Optional[ServingMetrics] = None,
                 chaos: Optional[ServeChaos] = None,
                 tracer=None):
        serving = serving or ServingConfig()
        serving.validate()
        cfg = cfg or model.cfg
        if cfg != model.cfg:
            raise ValueError("cfg differs from the model's own config")
        # Flight recorder (obs/trace.py, OBSERVABILITY.md): request-
        # lifecycle events (submit → admit → first_code → harvest →
        # pixels → complete; trace id = the request id) plus chunk-
        # cadence spans. None (the default, unless the config names a
        # trace_file) records nothing — every seam below pays one
        # `is None` test, so the recorder-off loop runs the same work.
        self._tracer = tracer
        if self._tracer is None and getattr(serving, "trace_file", None):
            from dalle_tpu_torch.obs.trace import Tracer
            self._tracer = Tracer(
                peer="engine", sink_path=serving.trace_file,
                ring_bytes=getattr(serving, "trace_ring_kb", 256) * 1024)
        self._cfg = cfg
        self._serving = serving
        # fail FAST on a bad engine-wide default: a server booted with
        # temperature=-1 must die at construction, not 400 every
        # knob-less request against an operator misconfiguration
        self._sampling = self._validated_sampling(sampling)
        self._pixels = pixel_pipeline
        s = serving.n_slots
        total = cfg.total_seq_len
        n_buckets = resolve_buckets(serving.decode_buckets, s)
        self._bounds = bucket_bounds(total, n_buckets)
        self._chunk = serving.steps_per_call
        # prompt-prefix pool (serving/prefix_cache.py): device-resident
        # text-segment KV per distinct prompt; its byte budget is
        # RESERVED out of kv_budget_mb when one is set, so slots + pool
        # stay under the one existing budget
        self._prefix: Optional[PrefixCache] = None
        prefix_reserved = 0
        if serving.prefix_cache_mb is not None:
            prefix_budget = int(serving.prefix_cache_mb * 2 ** 20)
            self._prefix = PrefixCache(prefix_entry_bytes(cfg),
                                       prefix_budget)
            prefix_reserved = prefix_budget
        self.scheduler = SlotScheduler(
            s, kv_bytes_per_slot(cfg), serving.kv_budget_mb,
            admit_burst=serving.admit_burst,
            low_lane_bypass=serving.low_lane_bypass,
            reserved_bytes=prefix_reserved)
        self.metrics = metrics or ServingMetrics(
            n_slots=s, interval_s=serving.metrics_interval_s)
        # ONE ServeChaos per serving process: the front-end and pixel
        # worker reach it through the engine, so flood state and the
        # admission counter are shared the way real load is
        self._chaos = (chaos if chaos is not None
                       else maybe_wrap_serving(serving.chaos_plan))
        if pixel_pipeline is not None:
            # a pipeline built without metrics adopts the engine's —
            # submit/admit and complete/fail must share one ledger
            pixel_pipeline.bind_metrics(self.metrics)
            pixel_pipeline.bind_chaos(self._chaos)
            pixel_pipeline.bind_tracer(self._tracer)
        self._device = model.token_emb.device
        self._state = init_state(cfg, s, self._device)
        self.runner = ChunkRunner(model, self._state, self._chunk,
                                  self._bounds)
        # the engine thread's stream on the card (set in start()) and
        # the end of the last chunk launched there
        self._stream = None
        self._in_flight: Optional[torch.cuda.Event] = None
        # host mirror of the device position vector: live positions
        # advance deterministically by steps_per_call per chunk (and
        # reset to 0 at admission), so the loop schedules from THIS —
        # never from a blocking device→host pull
        self._pos_host = np.full((s,), total, np.int32)
        # engine-thread-only slot table: _Pending per occupied slot;
        # readiness()/snapshot() take benign stale reads (telemetry)
        # graftlint: handoff=engine-thread-owned
        self._slots: List[Optional[_Pending]] = [None] * s
        # completions whose code rows are still in flight to the host:
        # copied (non-blocking, behind an event) right after the chunk
        # that finished them and resolved one iteration later, so the
        # device never idles while the host turns a row into a response;
        # engine-thread-owned, foreign reads are telemetry
        # graftlint: handoff=engine-thread-owned
        self._harvests: List[Tuple[_Pending, torch.Tensor,
                                   Optional[torch.cuda.Event]]] = []
        # engine-thread-only: requests popped from the queue but not yet
        # landed in _slots (the admission window) — swept by the crash-
        # path cancel so a mid-admission failure can't orphan a handle
        # graftlint: handoff=engine-thread-owned
        self._admitting: List[_Pending] = []
        self._cv = threading.Condition()
        # per-lane FIFO queues, priority order (scheduler.LANES)
        self._queues: Dict[str, List[_Pending]] = \
            {ln: [] for ln in LANES}           # guarded by _cv
        # mid-decode cancellations flagged for the engine thread:
        # rid -> reason; processed (slot freed) at the next boundary
        self._cancel_rids: Dict[int, str] = {}  # guarded by _cv
        # brownout state: engine thread writes, front-end reads (bool —
        # a stale read degrades or upgrades one response, by design)
        # graftlint: handoff=engine-thread-owned
        self._brownout = False
        self._saturated_since: Optional[float] = None
        self._handles: Dict[int, RequestHandle] = {}   # guarded by _cv
        self._handles_prune_at = 2 * serving.queue_capacity  # guarded by _cv
        self._next_id = 0                      # guarded by _cv
        self._stopping = False                 # guarded by _cv
        self._draining = True                  # guarded by _cv
        self._thread = threading.Thread(target=self._run,
                                        name="decode-engine", daemon=True)

    # -- public API -----------------------------------------------------

    def start(self) -> "DecodeEngine":
        """Start the engine thread; on the card, capture one chunk graph
        a visible bucket first, on the engine's own stream, before any
        other thread of the engine exists. A failed capture raises."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
            self._stream = torch.cuda.Stream(self._device)
            with torch.cuda.stream(self._stream):
                self.runner.capture()
        self._thread.start()
        return self

    def submit(self, text_tokens, rng=0,
               sampling: Optional[SamplingConfig] = None,
               lane: str = LANES[0],
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Queue one image request. ``text_tokens``: (text_seq_len,)
        tokenizer ids; ``rng``: the request's int seed (int64) — the
        SAME seed handed to ``generate_images`` samples the SAME codes.
        ``sampling``: this request's SamplingConfig (default: the
        engine's). Per-request knobs are per-slot tensors of the chunk
        — a novel temperature never needs a new graph.
        ``lane``: priority lane (``"high"`` default / ``"low"``).
        ``deadline_s``: seconds from now this request's artifact is
        worth delivering (default ``ServingConfig.default_deadline_s``);
        when the predicted completion already misses it, submit raises
        :class:`DeadlineShedError` BEFORE the request costs any decode,
        and a queued request whose deadline becomes unmeetable is shed
        at the next boundary."""
        text = np.asarray(text_tokens, np.int32).reshape(-1)
        if text.shape[0] != self._cfg.text_seq_len:
            raise ValueError(
                f"text must be ({self._cfg.text_seq_len},) tokenizer ids, "
                f"got shape {text.shape}")
        if lane not in LANES:
            raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
        if deadline_s is None:
            deadline_s = self._serving.default_deadline_s
        if deadline_s is not None and not (
                np.isfinite(deadline_s) and deadline_s > 0):
            # malformed input is a 400, not a shed: a non-positive
            # deadline inflating the shed counter would masquerade as
            # load the SLO machinery refused
            raise ValueError(
                f"deadline_s must be a finite positive number or None, "
                f"got {deadline_s!r}")
        if isinstance(rng, (bool, np.bool_)) or not isinstance(
                rng, (int, np.integer)) or not SEED_MIN <= rng <= SEED_MAX:
            raise ValueError(f"rng must be an int64 seed, got {rng!r}")
        seed = int(rng)
        sampling = self._validated_sampling(sampling)
        # fingerprint outside the lock: hashing 256 ids is cheap but
        # the queue lock's hold time is the admission latency floor
        prefix_key = (prompt_fingerprint(text)
                      if self._prefix is not None else None)
        with self._cv:
            if self._stopping:
                raise EngineStoppedError("engine is stopping; submit "
                                         "refused")
            if sum(len(q) for q in self._queues.values()) \
                    >= self._serving.queue_capacity:
                raise QueueFullError(
                    f"request queue full ({self._serving.queue_capacity})")
            deadline = None
            if deadline_s is not None:
                predicted = self._predict_completion_locked(lane)
                if predicted is not None and predicted > deadline_s:
                    self.metrics.record_shed(lane)
                    raise DeadlineShedError(
                        f"shed: predicted completion {predicted:.2f}s "
                        f"misses the {deadline_s:.2f}s deadline "
                        f"(lane {lane!r})")
                deadline = time.monotonic() + deadline_s
            rid = self._next_id
            self._next_id += 1
            handle = RequestHandle(rid)
            self._queues[lane].append(_Pending(
                rid, text, seed, handle, sampling, lane=lane,
                deadline=deadline, prefix_key=prefix_key))
            if len(self._handles) >= self._handles_prune_at:
                # lazy prune: resolved handles leave the abandonment
                # registry so a long-lived server stays O(outstanding).
                # The next prune point doubles with the surviving size,
                # so a backlog of live handles cannot trigger an
                # O(outstanding) rebuild on EVERY submit (amortized O(1))
                self._handles = {r: h for r, h in self._handles.items()
                                 if not h.done()}
                self._handles_prune_at = max(
                    2 * self._serving.queue_capacity,
                    2 * len(self._handles))
            self._handles[rid] = handle
            self.metrics.record_submit(rid, lane)
            # timestamp INSIDE the lock (one clock read), record
            # outside it: the engine thread can admit the moment
            # notify() lands, and the per-peer t0 order submit < admit
            # is the timeline contract
            t_submit = (time.monotonic() if self._tracer is not None
                        else 0.0)
            self._cv.notify()
        if self._tracer is not None:
            # outside _cv: the recorder must never extend the queue
            # lock's hold time (and never nest under it)
            self._tracer.add("serving", "submit", f"req:{rid}",
                             t_submit, 0.0, lane=lane)
        return handle

    def _predict_completion_locked(self, lane: str) -> Optional[float]:
        """Predicted completion (seconds from now) for a request queued
        on ``lane`` NOW: same-or-higher-lane queue depth and live slots
        through ``SlotScheduler.predict_completion_s`` at the measured
        service cadence. None until the first harvest has measured one
        (admit optimistically rather than shed on a guess). Caller
        holds ``_cv``; the lock order _cv → metrics._lock is the same
        one every metrics call under submit already takes."""
        service = self.metrics.service_ema_s
        if service is None:
            return None
        ahead = 0
        for ln in LANES:
            ahead += len(self._queues[ln])
            if ln == lane:
                break
        live = sum(p is not None for p in self._slots)
        return self.scheduler.predict_completion_s(ahead, live, service)

    def cancel(self, request_id: int,
               reason: str = "cancelled by client") -> bool:
        """Cancel an outstanding request (the client timed out, hung
        up, or gave up). Still queued: resolved here, immediately.
        Mid-decode: flagged for the engine thread, which frees the slot
        at the NEXT call boundary — the grant that follows sees it, so
        the slot returns to the scheduler within one boundary. Already
        resolved (or unknown): returns False, changes nothing. A cancel
        racing a completion is safe by the ``_claim``/``_deliver``
        discipline: first resolution wins, the loser is a no-op."""
        with self._cv:
            for lane in LANES:
                q = self._queues[lane]
                for i, pend in enumerate(q):
                    if pend.rid == request_id:
                        q.pop(i)
                        if pend.handle._resolve({"error": reason}) \
                                and not pend.synthetic:
                            # synthetic flood filler never recorded a
                            # submit; counting its cancel would break
                            # the ledger identity the soak audits
                            self.metrics.record_cancelled(pend.rid)
                        return True
            handle = self._handles.get(request_id)
            if handle is None or handle.done():
                return False
            self._cancel_rids[request_id] = reason
            self._cv.notify()
        return True

    def _validated_sampling(self, sampling: Optional[SamplingConfig]
                            ) -> SamplingConfig:
        sam = self._sampling if sampling is None else sampling
        temp, top_p = float(sam.temperature), float(sam.top_p)
        # >= rejects NaN; isfinite rejects inf — an infinite temperature
        # collapses the finite segment-vocab mask (decode.py NEG_INF) to
        # 0 and samples the WRONG vocabulary segment, returning corrupt
        # codes with a 200 attached
        if not (temp >= 0.0 and np.isfinite(temp)):
            raise ValueError(
                f"temperature must be finite and >= 0, got {temp}")
        raw_k = sam.top_k
        if isinstance(raw_k, bool) or not (
                isinstance(raw_k, (int, np.integer))
                or (isinstance(raw_k, float) and raw_k.is_integer())):
            # a silently truncated 3.9 would serve DIFFERENT sampling
            # than the caller asked for — guard here so the Python API
            # is as protected as the HTTP one
            raise ValueError(f"top_k must be an integer, got {raw_k!r}")
        top_k = int(raw_k)
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        return SamplingConfig(temp, top_k, top_p)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the engine thread. ``drain=True`` finishes queued and
        in-flight requests first (bounded by ``timeout``, default the
        config's ``drain_timeout_s``); ``drain=False`` cancels
        everything outstanding immediately. If the bounded join times
        out, every still-unresolved handle is resolved with an error
        payload — a client blocked in ``result()`` must not hang past
        the drain bound. Also drains and reaps an attached pixel
        pipeline. Idempotent; safe before ``start()``."""
        timeout = (self._serving.drain_timeout_s
                   if timeout is None else timeout)
        with self._cv:
            self._stopping = True
            self._draining = drain
            self._cv.notify_all()
        if self._thread.ident is not None:        # started at least once
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.warning("decode engine thread did not drain within "
                               "%.1fs; abandoning in-flight work", timeout)
                self._abandon_outstanding(timeout)
        else:                                     # never started: nothing
            self._cancel_outstanding()            # will run the loop exit
        if self._pixels is not None:
            self._pixels.stop()

    @property
    def cfg(self) -> ModelConfig:
        return self._cfg

    @property
    def default_sampling(self) -> SamplingConfig:
        """The engine-level SamplingConfig used when submit() gets no
        per-request override (the front-end merges partial overrides
        against this)."""
        return self._sampling

    @property
    def n_buckets(self) -> int:
        return len(self._bounds)

    @property
    def brownout_active(self) -> bool:
        """Whether sustained saturation has engaged degraded serving
        (the front-end trims image counts and the pixel stage skips
        CLIP rerank while this holds)."""
        return self._brownout

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        """The prompt-prefix pool (None when ``prefix_cache_mb`` is
        unset) — tests and the bench reach hit/eviction accounting
        through here."""
        return self._prefix

    @property
    def chaos(self) -> Optional[ServeChaos]:
        """The process-wide ServeChaos (None on the clean path) — the
        front-end and pixel worker reach the shared seam through here."""
        return self._chaos

    @property
    def tracer(self):
        """The engine's flight recorder (None when tracing is off) —
        the front-end's /metrics exposition reads phase histograms
        through here."""
        return self._tracer

    @property
    def alive(self) -> bool:
        """Liveness: the engine can still make progress — its thread is
        running, or it has not been started yet. False once the loop
        exited (clean stop or crash): /healthz flips and the
        orchestrator restarts or reroutes."""
        if self._thread.ident is None:
            with self._cv:
                return not self._stopping
        return self._thread.is_alive()

    def readiness(self) -> dict:
        """The cheap readiness slice for /readyz AND the DHT serving
        record (``serving/router.py`` advertises exactly this — the
        router's placement inputs): queue state, live-slot occupancy,
        the admission clamp, the measured service cadence and the
        prefix-pool counters — no percentile math, no record-window
        scan (those stay on /stats)."""
        with self._cv:
            depths = {ln: len(self._queues[ln]) for ln in LANES}
            draining = self._stopping
        out = self.metrics.counters()
        out["queue_depth_by_lane"] = depths
        out["queue_depth"] = sum(depths.values())
        out["queue_capacity"] = self._serving.queue_capacity
        out["brownout"] = self._brownout
        out["draining"] = draining
        # _slots is engine-thread-owned; this unlocked read is a benign
        # telemetry race (fixed-length list of refs, each entry read
        # once) — a probe must never contend with the admission path
        out["live_slots"] = sum(p is not None for p in self._slots)
        out["n_slots"] = self._serving.n_slots
        out["max_live"] = self.scheduler.max_live
        out["occupancy"] = round(
            out["live_slots"] / max(1, self._serving.n_slots), 4)
        return out

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        with self._cv:
            depths = {ln: len(self._queues[ln]) for ln in LANES}
            draining = self._stopping
        snap["queue_depth"] = sum(depths.values())
        snap["queue_depth_by_lane"] = depths
        snap["queue_capacity"] = self._serving.queue_capacity
        snap["brownout"] = self._brownout
        snap["draining"] = draining
        snap["n_slots"] = self._serving.n_slots
        snap["max_live_slots"] = self.scheduler.max_live
        if self._prefix is not None:
            snap["prefix_cache"] = self._prefix.stats()
        return snap

    @property
    def serving(self) -> ServingConfig:
        """The resolved ServingConfig (the front-end reads the brownout
        image cap and queue capacity from here)."""
        return self._serving

    # -- engine thread --------------------------------------------------

    def _visible_for(self, max_end_pos: int) -> int:
        """Smallest bucket bound covering every position this chunk will
        decode (callers of decode_step guarantee pos < visible)."""
        for bound in self._bounds:
            if bound >= max_end_pos:
                return bound
        return self._cfg.total_seq_len

    def _pick_visible(self, live_slots: List[int]) -> int:
        """Bucket choice from the PREDICTED chunk-end positions: live
        positions advance deterministically by ``steps_per_call``, so
        the host mirror knows chunk k+1's span before chunk k finishes
        — no device readback. (The speculative-bucket reconciliation
        rule, SERVING.md: admissions land in the state BEFORE the next
        dispatch, so the prediction is exact, never a guess.)"""
        max_end = int(self._pos_host[live_slots].max()) + self._chunk
        return self._visible_for(min(max_end, self._cfg.total_seq_len))

    def _admit_batch(self, admitted: List[_Pending],
                     slots: List[int]) -> None:
        """Write all K admitted requests into their slots, in place, one
        batched write a state tensor (cold and warm each): COLD requests
        prefill from pos 0; WARM requests (their prompt's text KV is
        pooled) get the cached prefix scattered into their cache rows and
        start at pos = text_len with the prompt's last token as input,
        skipping the text prefill entirely (bit-exact: the rows are the
        bytes a cold prefill writes, and the noise at an image position
        depends on nothing before it)."""
        warm_entries: Dict[int, Dict[str, torch.Tensor]] = {}
        if self._prefix is not None:
            for i, p in enumerate(admitted):
                if p.prefix_key is None:
                    continue
                entry = self._prefix.lookup(p.prefix_key, p.text)
                if entry is not None:
                    warm_entries[i] = entry
                    p.prefix_hit = True
        text_len = self._cfg.text_seq_len
        st, dev = self._state, self._device
        for warm in (False, True):
            group = [i for i in range(len(admitted))
                     if (i in warm_entries) == warm]
            if not group:
                continue
            ps = [admitted[i] for i in group]
            idx = _on(dev, np.asarray([slots[i] for i in group], np.int64))
            texts = np.stack([p.text for p in ps]).astype(np.int64)
            if warm:
                scatter_prefix(st.cache, idx, stack_entries(
                    [warm_entries[i] for i in group]), text_len)
            st.pos[idx] = text_len if warm else 0
            st.tokens[idx] = (_on(dev, texts[:, -1]) if warm
                              else self._cfg.vocab_total)
            st.seeds[idx] = _on(dev, np.asarray([p.seed for p in ps],
                                                np.int64))
            st.text[idx] = _on(dev, texts)
            st.codes[idx] = 0
            st.temp[idx] = _on(dev, np.asarray(
                [p.sampling.temperature for p in ps], np.float32))
            st.top_k[idx] = _on(dev, np.asarray(
                [p.sampling.top_k for p in ps], np.int64))
            st.top_p[idx] = _on(dev, np.asarray(
                [p.sampling.top_p for p in ps], np.float32))
        for pending, slot in zip(admitted, slots):
            self._slots[slot] = pending
            self._pos_host[slot] = text_len if pending.prefix_hit else 0
            if not pending.synthetic:
                self.metrics.record_admit(
                    pending.rid,
                    prefix_hit=(pending.prefix_hit
                                if self._prefix is not None else None))
                if self._tracer is not None:
                    self._tracer.event("serving", "admit",
                                       f"req:{pending.rid}", slot=slot,
                                       prefix_hit=pending.prefix_hit)

    def _after_chunk(self, live_slots: List[int], queue_depth: int,
                     mirror_current: bool = False) -> List[int]:
        """Advance the host position mirror exactly as the device does
        (+steps_per_call per live slot, clamped) and return the slots
        that finished at this chunk's end. ``mirror_current=True``
        skips the advance — the sync loop already reconciled the
        mirror from the blocking device pull."""
        total = self._cfg.total_seq_len
        text_len = self._cfg.text_seq_len
        if not mirror_current:
            self._pos_host[live_slots] = np.minimum(
                self._pos_host[live_slots] + self._chunk, total)
        self.metrics.record_step(len(live_slots), queue_depth)
        finished = []
        for slot in live_slots:
            pending = self._slots[slot]
            if not pending.first_code_seen \
                    and self._pos_host[slot] > text_len:
                pending.first_code_seen = True
                self.metrics.record_first_code(pending.rid)
                if self._tracer is not None and not pending.synthetic:
                    self._tracer.event("serving", "first_code",
                                       f"req:{pending.rid}")
            if self._pos_host[slot] >= total:
                finished.append(slot)
        return finished

    def _begin_harvest(self, slots: List[int]) -> None:
        """Start each finished slot's code-row copy to the host WITHOUT
        blocking (on the card: into a pinned buffer, ``non_blocking``,
        then an event); the slot is recycled immediately. The copy is
        enqueued on the engine's stream BEFORE any later admission, so
        in-order execution reads the row before admission zeroes it."""
        for slot in slots:
            pending = self._slots[slot]
            if not pending.synthetic:
                # decode service sample for the shed predictor (host
                # clocks only — the admit timestamp is already local)
                self.metrics.note_service(pending.rid)
                if self._tracer is not None:
                    self._tracer.event("serving", "harvest",
                                       f"req:{pending.rid}", slot=slot)
            # pool this prompt's text prefix while the slot's text rows
            # are still intact (image-position writes never touch them;
            # the copy is enqueued on the post-chunk state BEFORE any
            # later write can overwrite it, the same in-order guarantee
            # the code-row harvest below rides)
            if (self._prefix is not None and not pending.synthetic
                    and pending.prefix_key is not None
                    and pending.prefix_key not in self._prefix
                    and self._prefix.insertable()):
                self._prefix.insert(
                    pending.prefix_key, pending.text,
                    extract_prefix(self._state.cache, slot,
                                   self._cfg.text_seq_len))
            # copy BEFORE clearing the slot: if the copy raises, the
            # pending is still reachable from _slots for the crash-path
            # cancel sweep (first-claim-wins dedupes the both-places
            # overlap)
            src = self._state.codes[slot]
            event = None
            if self._device.type == "cuda":
                row = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                row.copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                row = src.clone()
            self._harvests.append((pending, row, event))
            self._slots[slot] = None

    def _drain_harvests(self) -> None:
        """Resolve completions whose rows were sliced on an EARLIER
        iteration — by now the producing chunk has finished (or the
        wait overlaps the chunk currently in flight), so this is the
        loop's only device-dependent wait and it never stalls the
        dispatch pipeline."""
        # pop AFTER each successful resolution: a device error surfacing
        # at the event leaves the failing entry (and everything
        # behind it) in _harvests, where the crash-path cancel sweep can
        # still resolve the handles — never orphan a client in result()
        while self._harvests:
            pending, row, event = self._harvests[0]
            if event is not None:
                event.synchronize()
            self._finish_harvest(pending, row.numpy().astype(np.int32))
            self._harvests.pop(0)

    def _finish_harvest(self, pending: _Pending, codes: np.ndarray) -> None:
        if pending.synthetic:
            # chaos-flood filler: load, not work — resolve out of band,
            # never feed the completion ledger or the pixel stage
            pending.handle._resolve({"codes": codes, "synthetic": True})
            return
        if self._pixels is not None:
            # the deadline verdict is judged AFTER pixels, where the
            # client actually receives the artifact (pixels.py)
            self._pixels.submit(pending.handle, pending.rid, codes,
                                degraded=self._brownout,
                                deadline=pending.deadline)
        elif pending.handle._claim():
            # claim BEFORE touching the ledger: a handle the stop()-
            # abandonment sweep already resolved must not also count
            # as completed (and its popped timers would fabricate a
            # ~0s latency row, skewing the percentiles)
            deadline_ok = (None if pending.deadline is None
                           else time.monotonic() <= pending.deadline)
            pending.handle._deliver(
                {"codes": codes,
                 **self.metrics.record_complete(pending.rid,
                                                deadline_ok=deadline_ok)})
            if self._tracer is not None:
                self._tracer.event("serving", "complete",
                                   f"req:{pending.rid}")
        else:
            logger.debug("request %d resolved elsewhere before "
                         "harvest landed", pending.rid)

    def _sync_pull(self) -> None:
        """The host-synchronous reconciliation (the ``host_sync_loop``
        escape hatch / bench baseline): block on a device→host position
        pull every chunk. The pulled values always
        equal the host mirror — positions advance deterministically —
        so this buys nothing but the stall it exists to measure."""
        self._pos_host[:] = self._state.pos.cpu().numpy()

    def _cancel_outstanding(self) -> None:
        with self._cv:
            leftover = [p for ln in LANES for p in self._queues[ln]]
            for q in self._queues.values():
                q.clear()
        harvests, self._harvests = self._harvests, []
        # _admitting covers the popped-but-not-yet-in-_slots window (a
        # loop crash mid-admission): those pendings belong to none of
        # the other structures and must still resolve. Requests already
        # handed to the pixel queue are deliberately NOT swept — their
        # decode finished; PixelPipeline.stop() drains and resolves
        # them (first-claim-wins dedupes any overlap here).
        admitting, self._admitting = self._admitting, []
        for pend in (leftover + admitting
                     + [p for p in self._slots if p is not None]
                     + [p for p, _row, _event in harvests]):
            # "stopped" is the typed marker: result() raises
            # EngineStoppedError, the front-end answers 503 — a router
            # retries the request on another engine instead of treating
            # a dying engine's cancellations as a deterministic 500
            if pend.handle._resolve({"error": "cancelled at engine stop",
                                     "stopped": True}) \
                    and not pend.synthetic:
                self.metrics.record_cancelled(pend.rid)
        self._slots = [None] * self._serving.n_slots

    def _abandon_outstanding(self, timeout: float) -> None:
        """stop(drain=True) hit its bound with the engine thread still
        alive: resolve every unresolved handle with an error payload so
        no client hangs in result() waiting on work nobody will finish.
        First-resolution-wins keeps this safe against the wedged thread
        limping through a late completion."""
        with self._cv:
            handles = [h for h in self._handles.values() if not h.done()]
        for h in handles:
            if h._resolve({"error": "abandoned: engine drain timed out "
                                    f"after {timeout:.1f}s",
                           "stopped": True}):
                self.metrics.record_cancelled(h.request_id)

    def _launch_chunk(self, visible: int) -> None:
        """One chunk on every slot (a graph replay on the card, queued
        without a host wait), then wait for the chunk BEFORE it: the
        host runs at most one chunk ahead of the device, so chunk-
        boundary timestamps (TTFT) lag the device by at most a chunk."""
        self.runner.run(visible)
        if self._device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            if self._in_flight is not None:
                self._in_flight.synchronize()
            self._in_flight = done

    def _run(self) -> None:
        try:
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    self._serve_loop()
            else:
                self._serve_loop()
        except Exception:  # noqa: BLE001 - the engine thread is the only
            # place these can surface; a hang-forever future is strictly
            # worse than a cancelled one
            logger.exception("decode engine crashed; cancelling "
                             "outstanding requests")
        finally:
            # refuse further submits the moment the loop is gone — a
            # crashed engine must fail fast (503 at the front-end), not
            # queue requests no consumer will ever serve
            with self._cv:
                self._stopping = True
            self._cancel_outstanding()

    def _take_cancels(self) -> Dict[int, str]:
        with self._cv:
            cancels, self._cancel_rids = self._cancel_rids, {}
        return cancels

    def _release_cancelled(self, cancels: Dict[int, str]) -> None:
        """Free the slots of mid-decode-cancelled requests: resolve each
        handle (first claim wins — a completion already harvested keeps
        its win and its slot was already recycled), clear the slot
        table + host mirror, and mark the device positions free in ONE
        batched write. Runs at the boundary top, so the grant that
        follows can hand the freed slots straight to the queue. A rid
        whose decode already finished (riding _harvests or the pixel
        queue) is deliberately skipped — its slot is free and its
        completion resolves the handle."""
        slots = []
        total = self._cfg.total_seq_len
        for slot, pending in enumerate(self._slots):
            if pending is None or pending.rid not in cancels:
                continue
            if pending.handle._resolve({"error": cancels[pending.rid]}) \
                    and not pending.synthetic:
                self.metrics.record_cancelled(pending.rid, mid_decode=True)
            self._slots[slot] = None
            self._pos_host[slot] = total
            slots.append(slot)
        if slots:
            self._state.pos[_on(self._device, np.asarray(slots, np.int64))] \
                = total

    def _maybe_flood(self) -> None:
        """Chaos seam: inject any due artificial queue flood as
        synthetic low-lane requests (bounded by queue capacity — a
        flood models pressure, and pressure is what a full queue is)."""
        # single-writer stale read on the zero-sync loop: stop() sets
        # _stopping under _cv, this thread only ever observes it late
        # by one chunk — taking _cv here would serialize the hot loop
        # graftlint: disable=lock-inconsistent-access
        if self._chaos is None or self._stopping:
            # no synthetic load once a drain has begun: the fault
            # harness must exercise shutdown, not extend it
            return
        burst = self._chaos.flood_due()
        if not burst:
            return
        n = 0
        with self._cv:
            room = self._serving.queue_capacity - sum(
                len(q) for q in self._queues.values())
            n = max(0, min(burst, room))
            for _ in range(n):
                rid = self._next_id
                self._next_id += 1
                self._queues[LANES[-1]].append(_Pending(
                    rid, np.zeros(self._cfg.text_seq_len, np.int32),
                    0, RequestHandle(rid),
                    self._sampling, lane=LANES[-1], synthetic=True))
        if n:
            self._chaos.note_flood(n)
            self.metrics.record_flood(n)
            logger.warning("chaos: queue flood injected %d synthetic "
                           "request(s) (%d in plan burst)", n, burst)

    def _expire_queued_deadlines(self) -> None:
        """Shed queued requests whose deadline has become unmeetable
        BEFORE they reach a slot — the decode they would burn can serve
        a request that can still win. Unmeetable: the deadline already
        passed, or now + one measured service time exceeds it (even an
        immediate grant loses). Without a measured cadence yet, only
        already-expired deadlines shed. Caller holds ``_cv``."""
        service = self.metrics.service_ema_s
        now = time.monotonic()
        for lane in LANES:
            kept = []
            for pend in self._queues[lane]:
                limit = pend.deadline
                if limit is not None and not pend.synthetic and (
                        now > limit
                        or (service is not None
                            and now + service > limit)):
                    if pend.handle._resolve(
                            {"error": "shed: deadline became unmeetable "
                                      "while queued", "shed": True}):
                        self.metrics.record_shed(lane, rid=pend.rid)
                    continue
                kept.append(pend)
            self._queues[lane][:] = kept

    def _update_brownout(self, queue_depth: int) -> None:
        """Brownout hysteresis + hold: engage once the total queue has
        sat at/above ``brownout_high_frac × queue_capacity`` for
        ``brownout_hold_s`` seconds; disengage when it falls to
        ``brownout_low_frac × capacity``. Engine thread only; readers
        (the front-end trimming image counts, /readyz) see a bool."""
        cfg = self._serving
        now = time.monotonic()
        if queue_depth >= cfg.brownout_high_frac * cfg.queue_capacity:
            if self._saturated_since is None:
                self._saturated_since = now
            if (not self._brownout
                    and now - self._saturated_since >= cfg.brownout_hold_s):
                self._brownout = True
                logger.warning(
                    "brownout ENGAGED: queue %d/%d sustained %.2fs — "
                    "serving degraded (image cap %d, rerank off)",
                    queue_depth, cfg.queue_capacity,
                    now - self._saturated_since, cfg.brownout_max_images)
        else:
            self._saturated_since = None
            if self._brownout \
                    and queue_depth <= cfg.brownout_low_frac \
                    * cfg.queue_capacity:
                self._brownout = False
                logger.info("brownout disengaged: queue depth %d",
                            queue_depth)

    def _serve_loop(self) -> None:
        sync = self._serving.host_sync_loop
        while True:
            cancels = self._take_cancels()
            if cancels:
                self._release_cancelled(cancels)
            self._maybe_flood()
            with self._cv:
                if self._stopping and not self._draining:
                    break
                self._expire_queued_deadlines()
                free = [i for i, p in enumerate(self._slots) if p is None]
                live = self._serving.n_slots - len(free)
                grants = self.scheduler.grant_lanes(
                    [len(self._queues[ln]) for ln in LANES], live,
                    len(free))
                admitted = []
                for ln, n_adm in zip(LANES, grants):
                    for _ in range(n_adm):
                        admitted.append(self._queues[ln].pop(0))
                queue_depth = sum(len(q) for q in self._queues.values())
                if not admitted and live == 0:
                    if self._stopping:
                        break      # drained: queue empty, slots empty
                    if not self._harvests:
                        self._cv.wait(timeout=0.1)
                    idle = True
                else:
                    idle = False
            self._update_brownout(queue_depth)
            if idle:
                # a finished wave may still be riding the harvest
                # pipeline, and the JSONL trace must keep ticking while
                # idle — a silent gap is indistinguishable from a dead
                # server
                self._drain_harvests()
                self.metrics.maybe_flush()
                continue
            if admitted:
                self._admitting = admitted
                if self._chaos is not None:
                    # the crash-at-admission seam fires INSIDE the
                    # _admitting window, so the crash-path sweep is
                    # what keeps these handles from orphaning
                    self._chaos.on_admit(len(admitted))
                self._admit_batch(admitted, free[: len(admitted)])
                self._admitting = []
            live_slots = [i for i, p in enumerate(self._slots)
                          if p is not None]
            visible = self._pick_visible(live_slots)
            # launch chunk k+1 BEFORE resolving chunk k's harvests: the
            # device computes while the host turns rows into responses
            # — one chunk always in flight, no blocking read on this
            # path
            if self._tracer is None:
                self._launch_chunk(visible)
            else:
                # the span measures the LAUNCH wall (the loop is
                # zero-sync; device wall shows up as backpressure on a
                # later launch) — the host-cadence number
                t_chunk = time.monotonic()
                self._launch_chunk(visible)
                self._tracer.add("serving", "chunk", "engine", t_chunk,
                                 time.monotonic() - t_chunk,
                                 live=len(live_slots), visible=visible)
            self._drain_harvests()
            if sync:
                # block on the pull BEFORE any bookkeeping, so
                # first-code (TTFT) is recorded only once the device
                # actually produced it — sync-mode TTFT is exact
                self._sync_pull()
            finished = self._after_chunk(live_slots, queue_depth,
                                         mirror_current=sync)
            self._begin_harvest(finished)
            if sync:
                self._drain_harvests()
            self.metrics.maybe_flush()
            if self._tracer is not None:
                self._tracer.maybe_flush()
        # loop exited with completions possibly still in flight (their
        # decode DID finish) — land them before the cancel sweep
        self._drain_harvests()
        if self._tracer is not None:
            self._tracer.flush()
