"""Fleet routing: DHT-advertised engines + a placing HTTP front-end (the
port's copy of ``dalle_tpu/serving/router.py``; the same records, the same
placement decisions, so a router of either package places to engines of
both).

The swarm control plane already makes many unreliable peers behave like
one machine for TRAINING (rendezvous discovery, TTL'd liveness records,
elastic membership); this module applies the same machinery to the
serving plane. Serving peers advertise under ``{prefix}_serving``
exactly the way trainers advertise under ``{prefix}_rendezvous``
(``swarm/rendezvous.py`` is the pattern): a TTL'd, identity-bound
record per engine, re-published every ``ttl / 3`` by a daemonized,
bounded-joined advertiser thread. The record payload is the O(1)
``/readyz`` slice ``DecodeEngine.readiness()`` already computes — queue
depth (total and per lane), live-slot occupancy, the admission clamp,
the measured admit→harvest service EMA, goodput, shed/brownout
counters, prefix-cache hit rates — plus, when the flight recorder is
on, the span-derived chunk cadence. The queue/occupancy telemetry
reaches the DHT records a router places by, and an aux peer's aggregate
can sum fleet-wide goodput from the same records.

The router (:class:`Router` + :class:`RouterHTTPServer`) places each
``POST /generate`` by **least predicted completion**: the same wave
model the deadline shedder uses (``SlotScheduler.predict_completion_s``
— waves of ``max_live`` requests at the measured service cadence), fed
from the advertised records plus the router's own in-flight counts (so
a burst between record refreshes spreads instead of piling onto one
engine). **Prompt affinity**: requests hash their prompt with the SAME
fingerprint the engines key their prefix pools by, and the hash picks a
home engine — duplicate/trending prompts land where their text prefix
is already cached — unless the home engine's predicted completion
trails the best engine by more than about one service time (load beats
affinity; a cache hit saves a fraction of one decode, never a whole
queue wave).

Failover: 429 (queue full / shed), 503 (draining, stopping, crashed)
and transport-level failures (connection refused/reset, attempt
timeout) move the request to the next-best engine. This can never
double-decode: 429/503 mean the engine accepted nothing, and an
abandoned attempt's severed connection trips the engine front-end's
client-vanished probe, which cancels the work within one call boundary.
Stale records — TTL-expired in the DHT, or older than
``record_max_age_s`` — are never placed to.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import select
import socket
import threading
import time
import urllib.parse
from http.client import HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dalle_tpu_torch.serving.prefix_cache import prompt_fingerprint
from dalle_tpu_torch.serving.scheduler import completion_waves
from dalle_tpu_torch.swarm.dht import get_dht_time
from dalle_tpu_torch.swarm.rendezvous import RendezvousAdvertiser

logger = logging.getLogger(__name__)


class _ClientGone(Exception):
    """The ROUTER's client hung up mid-placement: sever the engine
    attempt (its front-end's vanished-client probe then cancels the
    decode within one boundary) and write nothing."""

#: serving records expire fast relative to the rendezvous TTL: placement
#: reads load, and minutes-old load is noise — an engine that stops
#: re-publishing ages out of the table within one TTL
DEFAULT_SERVING_TTL = 30.0

#: readiness-slice fields copied verbatim into the DHT record (the
#: record IS the /readyz slice — one source of truth for probes and
#: placement)
_RECORD_FIELDS = (
    "queue_depth", "queue_depth_by_lane", "queue_capacity", "live_slots",
    "n_slots", "max_live", "occupancy", "service_ema_s", "brownout",
    "draining", "shed", "browned", "cancelled_mid_decode",
    "goodput_img_per_s", "prefix_hits", "prefix_misses")


def serving_key(prefix: str) -> str:
    return f"{prefix}_serving"


def engine_record(engine, url: str) -> dict:
    """One engine's DHT serving record: its reachable URL + the O(1)
    readiness slice, stamped with the publish time (staleness guard)
    and, when the flight recorder runs, the span-derived chunk cadence
    (span telemetry reaching the placement plane)."""
    r = engine.readiness()
    rec = {k: r[k] for k in _RECORD_FIELDS if k in r}
    rec["url"] = url
    rec["t"] = get_dht_time()
    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        hist = tracer.histogram_snapshot().get(("serving", "chunk"))
        if hist and hist["count"]:
            rec["span_chunk_mean_s"] = round(
                hist["sum"] / hist["count"], 6)
            rec["span_chunks_total"] = hist["count"]
    return rec


def advertise_serving(dht, prefix: str, record: dict,
                      ttl: float = DEFAULT_SERVING_TTL) -> bool:
    return dht.store(serving_key(prefix), dht.peer_id, record,
                     expiration_time=get_dht_time() + ttl)


def discover_engines(dht, prefix: str) -> Dict[str, dict]:
    """Advertised serving records by verified peer id. Identity-bound
    like ``rendezvous.discover``: a subkey claiming another peer's id
    under the wrong key is dropped; records without a URL are noise."""
    entries = dht.get(serving_key(prefix)) or {}
    out: Dict[str, dict] = {}
    for subkey, item in entries.items():
        rec = item.value
        if not isinstance(rec, dict) or not rec.get("url"):
            continue
        pid = dht.bound_peer_id(subkey)
        if pid is None:
            continue
        out[pid] = rec
    return out


class ServingAdvertiser(RendezvousAdvertiser):
    """The rendezvous advertiser pointed at the serving key: the SAME
    republish-every-``ttl/3`` loop, daemonization and signal-AND-
    bounded-join stop discipline (one implementation — a fix to the
    lifecycle machinery fixes both planes), publishing this engine's
    serving record instead of a rendezvous address."""

    def __init__(self, dht, prefix: str, engine, url: str,
                 ttl: float = DEFAULT_SERVING_TTL):
        super().__init__(dht, prefix, ttl=ttl)
        self.name = "serving-advertiser"
        self.engine = engine
        self.url = url

    def publish_once(self) -> bool:
        return advertise_serving(self.dht, self.prefix,
                                 engine_record(self.engine, self.url),
                                 ttl=self.ttl)


def request_fingerprint(body: dict) -> Optional[str]:
    """The affinity key for one /generate body: pre-tokenized requests
    hash their token ids with the SAME fingerprint the engines key
    their prefix pools by (so affinity and pool agree); text requests
    hash the caption string (the router has no tokenizer — consistency
    is what affinity needs, not the engine's exact key)."""
    if "tokens" in body:
        try:
            return prompt_fingerprint(np.asarray(body["tokens"], np.int32))
        except (ValueError, TypeError, OverflowError):
            return None
    if "text" in body:
        return hashlib.sha256(str(body["text"]).encode()).hexdigest()
    return None


class Router:
    """The placement brain: a record table refreshed from a provider
    (DHT discovery in production, any ``() -> {peer_id: record}``
    callable in tests/benches), in-flight accounting, and the
    least-predicted-completion + prompt-affinity candidate order.

    ``start()`` spawns the refresher thread (daemonized); ``stop()``
    signals and bounded-joins it. ``refresh_once()`` works without the
    thread for deterministic tests.
    """

    def __init__(self, fetch_records: Callable[[], Dict[str, dict]],
                 refresh_s: float = 2.0,
                 record_max_age_s: float = DEFAULT_SERVING_TTL,
                 affinity_slack_waves: float = 0.5):
        self._fetch = fetch_records
        self.refresh_s = refresh_s
        self.record_max_age_s = record_max_age_s
        self.affinity_slack_waves = affinity_slack_waves
        self._lock = threading.Lock()
        self._table: Dict[str, dict] = {}      # peer_id -> record
        # router-placed work still outstanding: ticket -> (peer id,
        # placement time, images). Predictions count ONLY placements
        # NEWER than a peer's record timestamp — once the engine's own
        # advertised queue depth includes a placement, counting it here
        # too would double it (and exclude engines at half capacity)
        self._inflight: Dict[int, Tuple[str, float, int]] = {}
        self._next_ticket = 0
        self._ledger = {
            "requests": 0,          # valid POSTs accepted for placement
            "placed": 0,            # engine attempts
            "completed": 0,         # 200s relayed
            "result_rows": 0,       # images inside those 200s
            "failovers": 0,         # attempts moved to the next engine
            "relayed_errors": 0,    # final non-200 relayed to the client
            "no_engine": 0,         # 503: nothing placeable
            "client_gone": 0,       # our client vanished mid-placement
        }
        self._per_engine: Dict[str, Dict[str, int]] = {}
        self._stop_event = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="router-refresh", daemon=True)

    # -- table ----------------------------------------------------------

    def start(self) -> "Router":
        self._thread.start()
        return self

    def stop(self, join_timeout: Optional[float] = 10.0) -> None:
        self._stop_event.set()
        if join_timeout is not None and self._thread.ident is not None \
                and threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout)

    def _run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.refresh_once()
            except Exception:  # noqa: BLE001 - a refresh failure must
                # not kill placement; the stale-age guard quarantines
                # whatever the last good refresh left behind
                logger.warning("router record refresh failed",
                               exc_info=True)
            self._stop_event.wait(self.refresh_s)

    def refresh_once(self) -> None:
        records = self._fetch() or {}
        now = get_dht_time()
        fresh = {}
        for pid, rec in records.items():
            if not isinstance(rec, dict) or not rec.get("url"):
                continue
            age = now - float(rec.get("t", 0.0))
            if age > self.record_max_age_s:
                # the stale-record rule: an engine that stopped
                # publishing (dead, partitioned, torn down) is never
                # placed to, even if a long-expiry record lingers
                continue
            fresh[pid] = rec
        with self._lock:
            self._table = fresh

    # -- in-flight + ledger ---------------------------------------------

    def note_placed(self, peer_id: str, n_images: int) -> int:
        """Record an attempt; returns the ticket ``note_done`` retires.
        The timestamp lets predictions ignore placements old enough to
        already ride the peer's advertised queue depth."""
        with self._lock:
            self._ledger["placed"] += 1
            ticket = self._next_ticket
            self._next_ticket += 1
            self._inflight[ticket] = (peer_id, get_dht_time(), n_images)
            eng = self._per_engine.setdefault(
                peer_id, {"placed": 0, "completed": 0, "failovers": 0})
            eng["placed"] += 1
        return ticket

    def note_done(self, ticket: int) -> None:
        with self._lock:
            self._inflight.pop(ticket, None)

    @staticmethod
    def _unseen_inflight(inflight, peer_id: str, rec_t: float) -> int:
        """Images this router placed on ``peer_id`` AFTER its record
        was stamped — load the record cannot know about yet. (Record
        timestamps come from the ENGINE's clock; cross-host skew only
        shades this heuristic, it cannot break accounting — tickets
        retire on response regardless.)"""
        return sum(n for p, t, n in inflight.values()
                   if p == peer_id and t > rec_t)

    def note_completed(self, peer_id: str, rows: int) -> None:
        with self._lock:
            self._ledger["completed"] += 1
            self._ledger["result_rows"] += rows
            self._per_engine.setdefault(
                peer_id, {"placed": 0, "completed": 0,
                          "failovers": 0})["completed"] += 1

    def note_failover(self, peer_id: str) -> None:
        with self._lock:
            self._ledger["failovers"] += 1
            self._per_engine.setdefault(
                peer_id, {"placed": 0, "completed": 0,
                          "failovers": 0})["failovers"] += 1

    def note_request(self) -> None:
        with self._lock:
            self._ledger["requests"] += 1

    def note_terminal(self, kind: str) -> None:
        with self._lock:
            self._ledger[kind] += 1

    def stats(self) -> dict:
        with self._lock:
            inflight: Dict[str, int] = {}
            for p, _t, n in self._inflight.values():
                inflight[p] = inflight.get(p, 0) + n
            return {
                "ledger": dict(self._ledger),
                "per_engine": {p: dict(c)
                               for p, c in self._per_engine.items()},
                "inflight": inflight,
                "engines": {p: dict(r) for p, r in self._table.items()},
            }

    # -- placement ------------------------------------------------------

    def _predict(self, rec: dict, inflight: int,
                 fallback_service: float) -> Tuple[float, int]:
        """(predicted completion s, waves) for a request placed on this
        engine NOW — the ``SlotScheduler.predict_completion_s`` wave
        model over the ADVERTISED queue/occupancy plus the router's own
        not-yet-visible placements. Engines that have not measured a
        service cadence yet ride the fleet's fallback (the max of the
        known cadences — pessimistic enough that an unmeasured engine
        never looks infinitely fast)."""
        max_live = max(1, int(rec.get("max_live")
                              or rec.get("n_slots") or 1))
        depth = int(rec.get("queue_depth", 0)) + inflight
        live = int(rec.get("live_slots", 0))
        waves = completion_waves(depth, live, max_live)
        service = rec.get("service_ema_s")
        if service is None:
            service = fallback_service
        return waves * float(service), waves

    def healthy(self) -> List[Tuple[str, dict]]:
        """Placeable engines: advertised fresh, not draining, queue not
        full (advertised depth + the router's record-unseen in-flight
        placements)."""
        with self._lock:
            table = dict(self._table)
            inflight = dict(self._inflight)
        out = []
        for pid, rec in sorted(table.items()):
            if rec.get("draining"):
                continue
            cap = int(rec.get("queue_capacity", 1))
            unseen = self._unseen_inflight(inflight, pid,
                                           float(rec.get("t", 0.0)))
            if int(rec.get("queue_depth", 0)) + unseen >= cap:
                continue
            out.append((pid, rec))
        return out

    def candidates(self, fingerprint: Optional[str] = None
                   ) -> List[Tuple[str, dict]]:
        """Engines in placement order: least predicted completion
        first, with the prompt's affinity home moved to the front when
        its prediction is within ``affinity_slack_waves`` service times
        of the best (default 0.5: a prefix hit saves the TEXT fraction
        of one decode — roughly half a service time — so affinity is
        worth about that much extra predicted wait and no more)."""
        healthy = self.healthy()
        if not healthy:
            return []
        with self._lock:
            inflight = dict(self._inflight)

        def unseen(pid, rec):
            return self._unseen_inflight(inflight, pid,
                                         float(rec.get("t", 0.0)))

        known = [r.get("service_ema_s") for _, r in healthy
                 if r.get("service_ema_s")]
        fallback = max(known) if known else 0.0
        scored = sorted(
            ((self._predict(rec, unseen(pid, rec), fallback),
              pid, rec) for pid, rec in healthy),
            key=lambda t: (t[0], t[1]))
        order = [(pid, rec) for _, pid, rec in scored]
        if fingerprint is not None and len(order) > 1:
            # rendezvous (highest-random-weight) hashing: the home is
            # the max of hash(fingerprint, peer) over the CURRENT
            # healthy set, so one engine dropping out (queue-full,
            # draining, stale) remaps only the prompts homed THERE —
            # a modulo over the list length would remap nearly every
            # prompt on any membership change and collapse the fleet's
            # prefix hit rate exactly when it is loaded
            home_pid, home_rec = max(
                healthy,
                key=lambda t: hashlib.sha256(
                    (fingerprint + t[0]).encode()).hexdigest())
            if home_pid != order[0][0]:
                home_pred = self._predict(
                    home_rec, unseen(home_pid, home_rec), fallback)
                best_pred = scored[0][0]
                slack = self.affinity_slack_waves * (
                    home_rec.get("service_ema_s") or fallback)
                if home_pred[0] <= best_pred[0] + slack:
                    order = [(home_pid, home_rec)] + [
                        (p, r) for p, r in order if p != home_pid]
        return order


class RouterHTTPServer(ThreadingHTTPServer):
    """Stdlib front-end over a :class:`Router`: ``POST /generate`` is
    placed and proxied; ``GET /stats`` is the router ledger + engine
    table; ``/healthz`` is router liveness; ``/readyz`` answers whether
    ANY engine is placeable; ``/engines`` dumps the record table."""

    daemon_threads = True
    # accept-backlog sized for bursts, like ServingHTTPServer: the
    # router IS the spike absorber — refusing TCP connects at backlog 5
    # would shed load invisibly before any placement decision ran
    request_queue_size = 128

    def __init__(self, address, router: Router,
                 request_timeout_s: float = 300.0):
        super().__init__(address, _RouterHandler)
        self.router = router
        self.request_timeout_s = request_timeout_s


class _RouterHandler(BaseHTTPRequestHandler):
    server: RouterHTTPServer

    def log_message(self, fmt, *args):  # noqa: A003 - route to logging
        logger.debug("%s " + fmt, self.client_address[0], *args)

    def _reply_json(self, code: int, payload: dict) -> None:
        self._relay(code, json.dumps(payload).encode())

    def _relay(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # OUR client vanished while the engine worked; the work
            # completed exactly once — nothing to unwind here
            self.close_connection = True

    def do_GET(self):  # noqa: N802 - stdlib handler contract
        router = self.server.router
        if self.path == "/healthz":
            self._reply_json(200, {"ok": True})
        elif self.path == "/readyz":
            n = len(router.healthy())
            self._reply_json(200 if n else 503,
                             {"ready": n > 0, "placeable_engines": n})
        elif self.path == "/stats":
            self._reply_json(200, router.stats())
        elif self.path == "/engines":
            self._reply_json(200, router.stats()["engines"])
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib handler contract
        if self.path != "/generate":
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        router = self.server.router
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) or b"{}"
            body = json.loads(raw)
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            n_images = int(body.get("n_images", 1))
            if not 1 <= n_images <= 64:
                # the engine front-end's bound, enforced BEFORE the
                # value enters the in-flight accounting placement reads
                # (a negative or huge count would skew predictions for
                # the whole attempt window)
                raise ValueError(f"n_images must be in [1, 64], "
                                 f"got {n_images}")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            # malformed bodies are refused BEFORE entering the ledger:
            # "requests" counts work the router actually tried to
            # place, so requests == completed + relayed_errors +
            # no_engine stays a closed identity (the soak's
            # router_ledger_closes oracle)
            self._reply_json(400, {"error": str(e)})
            return
        router.note_request()
        fingerprint = request_fingerprint(body)
        deadline = time.monotonic() + self.server.request_timeout_s
        last: Optional[Tuple[int, bytes]] = None
        tried = set()
        # candidate order is re-computed per attempt: a failover target
        # chosen before the first attempt's outcome would ignore what
        # that outcome just taught us (and the refreshed table)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            nxt = next(((pid, rec)
                        for pid, rec in router.candidates(fingerprint)
                        if pid not in tried), None)
            if nxt is None:
                break
            pid, rec = nxt
            tried.add(pid)
            ticket = router.note_placed(pid, n_images)
            try:
                status, payload = self._forward(rec["url"], raw,
                                                timeout=remaining)
            except _ClientGone:
                # OUR client hung up while the engine worked: the
                # severed engine connection trips its vanished-client
                # probe (work cancelled within one boundary); write
                # nothing, account the terminal
                router.note_done(ticket)
                router.note_terminal("client_gone")
                logger.info("router client vanished mid-placement; "
                            "severed the attempt on %s", pid[:12])
                self.close_connection = True
                return
            except (HTTPException, OSError, ValueError) as e:
                # transport-level failure: refused/reset (engine gone),
                # or our attempt timeout. Abandoning the attempt severs
                # the connection, and the engine front-end's client-
                # vanished probe cancels any accepted work within one
                # boundary — so the retry below cannot double-decode
                router.note_done(ticket)
                router.note_failover(pid)
                logger.info("engine %s unreachable (%s); failing over",
                            pid[:12], e)
                continue
            router.note_done(ticket)
            if status in (429, 503):
                # the engine refused (queue full / shed / draining /
                # stopped): nothing was accepted there — next-best
                router.note_failover(pid)
                last = (status, payload)
                continue
            if status == 200:
                rows = 0
                try:
                    rows = len(json.loads(payload).get("results", []))
                except (ValueError, AttributeError):
                    pass
                router.note_completed(pid, rows)
            else:
                router.note_terminal("relayed_errors")
            self._relay(status, payload)
            return
        if last is not None:
            router.note_terminal("relayed_errors")
            self._relay(*last)
            return
        router.note_terminal("no_engine")
        self._reply_json(503, {"error": "no engine available"})

    def _forward(self, url: str, raw: bytes, timeout: float
                 ) -> Tuple[int, bytes]:
        """POST to one engine on a worker thread while THIS thread
        probes our own client for EOF (the engine front-end's
        ``_await_result`` discipline, one hop up): a client that hung
        up must not keep an engine decoding for nobody. On a vanished
        client the engine connection is closed from here — the worker
        errors out, the engine sees EOF and cancels — and
        :class:`_ClientGone` is raised."""
        parsed = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(
            parsed.hostname, parsed.port, timeout=timeout)
        result: dict = {}

        def run():
            try:
                conn.request("POST", "/generate", body=raw,
                             headers={"Content-Type":
                                      "application/json"})
                resp = conn.getresponse()
                result["reply"] = (resp.status, resp.read())
            # not swallowed: the handler thread re-raises
            # result["error"] verbatim after joining this worker
            # (the failover / _ClientGone paths)
            # graftlint: disable=silent-except
            except Exception as e:  # noqa: BLE001 - re-raised above
                result["error"] = e
            finally:
                conn.close()

        worker = threading.Thread(target=run, name="router-forward",
                                  daemon=True)
        worker.start()
        while True:
            worker.join(0.1)
            if not worker.is_alive():
                break
            if self._client_vanished():
                conn.close()        # sever: the engine cancels on EOF
                worker.join(5.0)
                raise _ClientGone()
        if "error" in result:
            raise result["error"]
        return result["reply"]

    def _client_vanished(self) -> bool:
        """EOF probe on OUR client connection (server.py's probe, one
        hop up): readable + empty peek means the peer closed while an
        engine decodes for it."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            if not readable:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True


def dht_fetch_records(dht, prefix: str) -> Callable[[], Dict[str, dict]]:
    """The production record provider: DHT discovery under the serving
    key (benches/tests may hand ``Router`` any callable instead)."""
    return lambda: discover_engines(dht, prefix)
