"""Stdlib HTTP front-end for the decode engine.

The port's copy of ``dalle_tpu/serving/server.py``: the same endpoints,
status codes and reply keys. Image *i* of a request decodes with the
noise seed ``seed + i`` (the JAX front-end folds ``i`` into a PRNG key),
so a one-image request with seed s samples ``generate_images``'s codes
for seed s.

Endpoints (JSON in/out, no dependencies beyond the stdlib):

- ``POST /generate`` — body ``{"text": "<caption>"}`` (needs a
  tokenizer) or ``{"tokens": [...]}`` (raw ids, tests/benches), plus
  optional ``"n_images"`` (default 1), ``"seed"`` (default 0; image
  *i* of a request uses seed ``seed + i`` so a multi-image query is
  n independent single-image requests — exactly how the engine recycles
  slots), per-request sampling knobs ``"temperature"`` / ``"top_k"`` /
  ``"top_p"``, a priority ``"lane"`` (``"high"`` default / ``"low"``)
  and a ``"deadline_s"`` (seconds from receipt the artifact is worth
  delivering). Blocks until every image resolves; the response carries
  each request's codes (and ``clip_score`` when the pixel stage
  reranks) with its TTFT / latency / queue-wait accounting.
- ``GET /stats``  — the metrics snapshot + live queue depth (per lane),
  shed / brownout / cancel counters and goodput.
- ``GET /metrics`` — the same ledger as Prometheus text format, plus
  span-derived per-phase latency histograms when the flight recorder
  is on (``obs/``, OBSERVABILITY.md names every metric).
- ``GET /healthz`` — LIVENESS only: is the engine thread able to make
  progress. Flips false on a crashed/stopped engine so an orchestrator
  restarts the pod; it says nothing about load.
- ``GET /readyz`` — READINESS: whether a router should place new work
  here. Reports (and 503s on) draining and queue-full states, plus the
  overload telemetry a placement decision wants: brownout flag,
  per-lane queue depth, shed/brownout/cancel counters, goodput.

Overload behavior: queue full → **429**; deadline shed (predicted
completion already misses ``deadline_s``) → **429** with
``"shed": true`` — both cheap instant refusals, spent before any decode.
Under brownout the front-end trims ``n_images`` to the configured cap
and marks the response ``"brownout": true`` instead of collapsing into
429s. A request that times out (``request_timeout_s``) or whose client
vanishes mid-wait is **cancelled mid-decode** — every sibling handle is
cancelled too, so slots return to the scheduler instead of decoding for
nobody.

One handler thread per in-flight connection (``ThreadingHTTPServer``,
daemonized); a stopping or crashed engine surfaces as HTTP 503.
"""

from __future__ import annotations

import json
import logging
import select
import socket
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dalle_tpu_torch.models.decode import SamplingConfig
from dalle_tpu_torch.serving.engine import (SEED_MAX, SEED_MIN,
                                            DeadlineShedError,
                                            EngineStoppedError,
                                            QueueFullError)
from dalle_tpu_torch.serving.scheduler import LANES

logger = logging.getLogger(__name__)


class _ClientGone(Exception):
    """The requester hung up mid-wait (EOF on the connection): cancel
    its work, write nothing."""


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True   # connection threads must not block exit
    # the stdlib default accept backlog (5) DROPS connections under a
    # burst — a router fanning a spike onto this engine would see
    # connection-refused noise instead of queue-depth backpressure
    request_queue_size = 128

    def __init__(self, address, engine, tokenizer=None,
                 request_timeout_s: float = 300.0, registry=None):
        super().__init__(address, _Handler)
        self.engine = engine
        self.tokenizer = tokenizer
        self.request_timeout_s = request_timeout_s
        # /metrics: the unified Prometheus exposition (obs/,
        # OBSERVABILITY.md). The default registry unifies the serving
        # ledger (the SAME snapshot /stats serves — the two endpoints
        # agree by construction) with the engine's span-derived phase
        # histograms when tracing is on. Callers may pass their own
        # registry to add sources (e.g. a co-tenant trainer's).
        if registry is None:
            from dalle_tpu_torch.obs.exposition import (MetricsRegistry,
                                                        serving_source,
                                                        tracer_source)
            registry = MetricsRegistry()
            registry.register("serving", serving_source(engine))
            if getattr(engine, "tracer", None) is not None:
                registry.register("trace", tracer_source(engine.tracer))
        self.registry = registry


class _Handler(BaseHTTPRequestHandler):
    server: ServingHTTPServer

    # stdlib logs every request to stderr by default; route to logging
    def log_message(self, fmt, *args):  # noqa: A003
        logger.debug("%s " + fmt, self.client_address[0], *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib handler contract
        engine = self.server.engine
        if self.path == "/healthz":
            # liveness ONLY — no locks, no queue math: a health probe
            # must stay cheap and truthful when everything else is on
            # fire. Restart-worthy states (crashed/stopped loop) 503.
            alive = engine.alive
            self._reply(200 if alive else 503, {"ok": alive})
        elif self.path == "/readyz":
            # counters-only telemetry (engine.readiness): a router may
            # probe this every few seconds — it must never pay /stats'
            # percentile math under the metrics lock
            state = engine.readiness()
            full = state["queue_depth"] >= state["queue_capacity"]
            ready = engine.alive and not state["draining"] and not full
            self._reply(200 if ready else 503, {
                "ready": ready,
                "draining": state["draining"],
                "queue_full": full,
                "brownout": state["brownout"],
                "queue_depth_by_lane": state["queue_depth_by_lane"],
                "queue_depth": state["queue_depth"],
                "queue_capacity": state["queue_capacity"],
                "live_slots": state["live_slots"],
                "n_slots": state["n_slots"],
                "max_live": state["max_live"],
                "occupancy": state["occupancy"],
                "service_ema_s": state["service_ema_s"],
                "shed": state["shed"],
                "browned": state["browned"],
                "cancelled_mid_decode": state["cancelled_mid_decode"],
                "goodput_img_per_s": state["goodput_img_per_s"],
                "prefix_hits": state["prefix_hits"],
                "prefix_misses": state["prefix_misses"],
            })
        elif self.path == "/stats":
            self._reply(200, engine.stats())
        elif self.path == "/metrics":
            # Prometheus text exposition (obs/exposition.py): the
            # serving ledger + span-derived phase histograms, scrapable
            # by anything that speaks the text format
            from dalle_tpu_torch.obs.exposition import \
                write_metrics_response
            write_metrics_response(self, self.server.registry)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib handler contract
        if self.path != "/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        engine = self.server.engine
        chaos = engine.chaos
        # one stable channel per seam: the per-channel call index keeps
        # decisions seed-reproducible given the same connection ORDER
        # (keying on the client's ephemeral port would re-roll every
        # run and break replayability of a soak failure)
        conn_key = "http"
        if chaos is not None:
            chaos.on_client_recv(conn_key)     # the slow/stalled client
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            tokens = self._tokens_from(body)
            sampling = self._sampling_from(body, engine.default_sampling)
            n_images = int(body.get("n_images", 1))
            seed = int(body.get("seed", 0))
            lane = body.get("lane", LANES[0])
            deadline_s = body.get("deadline_s")
            if deadline_s is not None:
                deadline_s = float(deadline_s)
            if not (1 <= n_images <= 64):
                raise ValueError(f"n_images must be in [1, 64], "
                                 f"got {n_images}")
            if not SEED_MIN <= seed <= SEED_MAX - (n_images - 1):
                raise ValueError(f"seed {seed} is out of the int64 range "
                                 f"for {n_images} image(s)")
        except (ValueError, KeyError, TypeError, OverflowError,
                json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return

        # a request accepted while brownout is engaged is SERVED UNDER
        # BROWNOUT whether or not its image count needed trimming (the
        # pixel stage degrades it either way): the reply marker and the
        # browned counter cover both, and the counter lands only once
        # the submits succeed — a trimmed-then-rejected request was
        # never served degraded and must not skew placement telemetry
        browned = engine.brownout_active
        if browned:
            # fewer CLIP candidates, same caption, same parity for the
            # images that ARE produced
            n_images = min(n_images, engine.serving.brownout_max_images)

        handles = []
        try:
            for i in range(n_images):
                handles.append(engine.submit(
                    tokens, seed + i,
                    sampling=sampling, lane=lane, deadline_s=deadline_s))
        except ValueError as e:         # wrong-length token vector /
            # out-of-range sampling knob / bad lane
            self._cancel_all(handles)
            self._reply(400, {"error": str(e)})
            return
        except DeadlineShedError as e:  # predicted miss: instant cheap
            # no — retry against a less-loaded replica (readyz routes)
            self._cancel_all(handles)
            self._reply(429, {"error": str(e), "shed": True})
            return
        except QueueFullError as e:     # backpressure: retry later
            self._cancel_all(handles)
            self._reply(429, {"error": str(e)})
            return
        except (EngineStoppedError, RuntimeError) as e:  # stopping/
            # crashed; already-submitted sibling handles are cancelled
            # so their slots return to the scheduler
            self._cancel_all(handles)
            self._reply(503, {"error": str(e)})
            return
        if browned:
            engine.metrics.record_brownout()

        if chaos is not None and chaos.on_client_send(conn_key):
            # the half-closed / vanished client: sever our read side so
            # the disconnect probe below sees EOF — the request's slots
            # must be reclaimed, not decoded for nobody
            try:
                self.connection.shutdown(socket.SHUT_RD)
            except OSError:
                pass

        deadline = time.monotonic() + self.server.request_timeout_s
        results = []
        try:
            for h in handles:
                payload = self._await_result(h, deadline)
                results.append(self._result_row(payload))
        except TimeoutError as e:
            # the satellite fix: a timed-out request USED to keep
            # decoding (the front-end returned 504 and leaked the slot
            # for the full decode) — now every sibling is cancelled and
            # the slots return to the scheduler within one boundary
            self._cancel_all(handles)
            self._reply(504, {"error": str(e)})
            return
        except _ClientGone:
            self._cancel_all(handles)
            logger.info("client %s vanished mid-wait; cancelled %d "
                        "in-flight request(s)", conn_key, len(handles))
            self.close_connection = True
            return
        except DeadlineShedError as e:
            # shed while queued (the handle's payload carried the typed
            # shed marker): same contract as the submit-time shed
            self._cancel_all(handles)
            self._reply(429, {"error": str(e), "shed": True})
            return
        except EngineStoppedError as e:
            # the engine stopped/crashed under this request (typed
            # "stopped" payload marker): 503, the retryable answer — a
            # router fails the request over to another engine; the work
            # here was cancelled, so a retry cannot double-decode
            self._cancel_all(handles)
            self._reply(503, {"error": str(e)})
            return
        except RuntimeError as e:
            self._cancel_all(handles)   # siblings must not keep decoding
            # pixel-stage failure / cancelled: a deterministic server
            # error, NOT a timeout — retrying it verbatim would just
            # duplicate full-decode work
            self._reply(500, {"error": str(e)})
            return
        reply = {"seed": seed, "results": results}
        if browned:
            reply["brownout"] = True
        self._reply(200, reply)

    def _await_result(self, handle, deadline: float) -> dict:
        """Block on one handle with a disconnect probe: a client that
        hung up must free its slots now, not at request_timeout_s."""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"request {handle.request_id} not done within "
                    f"{self.server.request_timeout_s}s")
            if handle.wait(min(0.1, remaining)):
                return handle.result(timeout=0)
            if self._client_vanished():
                raise _ClientGone()

    def _client_vanished(self) -> bool:
        """EOF probe on the connection: readable + empty peek means the
        peer closed (or half-closed) its end while we decode for it."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            if not readable:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _cancel_all(self, handles) -> None:
        """Cancel every outstanding sibling of a failed/abandoned
        request (idempotent: resolved handles are skipped by the
        engine's first-claim discipline)."""
        engine = self.server.engine
        for h in handles:
            engine.cancel(h.request_id,
                          reason="cancelled: client gone or timed out")

    @staticmethod
    def _result_row(payload: dict) -> dict:
        """JSON-ready row for one resolved request (hoisted out of the
        result-wait loop)."""
        row = {k: v for k, v in payload.items() if k != "images"}
        row["codes"] = np.asarray(payload["codes"]).tolist()
        if "images" in payload:     # pixels stay binary-free: shape only
            row["image_shape"] = list(np.asarray(payload["images"]).shape)
        return row

    @staticmethod
    def _sampling_from(body: dict, default: SamplingConfig):
        """Per-request SamplingConfig from the POST body, or None to use
        the engine's default unchanged. Knobs absent from the body
        inherit the engine default (a partial override is a delta, not
        a reset). Values are range-checked by the engine's submit
        (ValueError -> 400)."""
        knobs = {k: body[k] for k in ("temperature", "top_k", "top_p")
                 if k in body}
        if not knobs:
            return None
        # values ride through RAW — the engine's _validated_sampling
        # owns range/type checks (finite temperature, integral top_k),
        # so the Python API and the HTTP API reject identically
        return SamplingConfig(
            temperature=float(knobs.get("temperature",
                                        default.temperature)),
            top_k=knobs.get("top_k", default.top_k),
            top_p=float(knobs.get("top_p", default.top_p)))

    def _tokens_from(self, body: dict):
        if "tokens" in body:
            return np.asarray(body["tokens"], np.int32)
        if "text" in body:
            if self.server.tokenizer is None:
                raise ValueError(
                    "server started without --tokenizer-path; "
                    "submit pre-tokenized ids via 'tokens'")
            text_len = self.server.engine.cfg.text_seq_len
            ids, _ = self.server.tokenizer.encode(body["text"], text_len)
            return np.asarray(ids, np.int32)
        raise ValueError("body needs 'text' or 'tokens'")
