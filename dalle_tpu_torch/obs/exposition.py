"""Unified metrics exposition: one registry, Prometheus text format.

The port's copy of ``dalle_tpu/obs/exposition.py`` (stdlib only), with
the serving, tracer and aux-peer sources and the standalone server; the
trainer's swarm source is not copied (no port entry point serves it).

Before this module each plane had its own reporting dialect — the
serving ledger spoke JSON on ``/stats``, the swarm robustness counters
rode ``last_timings["robust"]`` and the DHT metrics records, and the
span-derived phase latencies had nowhere to go at all. The registry
unifies them: every source contributes metric *families* (name, type,
help, samples), and :meth:`MetricsRegistry.render` emits standard
Prometheus text format (``text/plain; version=0.0.4``) that any scraper
parses. The serving front-end serves it at ``/metrics``
(serving/server.py) and the aux peer exposes the swarm-wide aggregate
under ``--metrics-port`` (cli/run_aux_peer.py).

Sources are callables evaluated at scrape time, so a scrape always sees
live values and a dead source degrades to absence, never to a wedged
endpoint. Family shape::

    {"name": "dalle_serving_submitted", "type": "counter",
     "help": "...", "samples": [(suffix, labels_dict, value), ...]}

``suffix`` is appended to the family name (histograms use ``_bucket`` /
``_sum`` / ``_count``; counters conventionally end in ``_total`` via
their suffix). The ledger identity pinned by test: the ``/metrics``
counters and the ``/stats`` JSON are snapshots of the SAME
ServingMetrics ledger, so their values agree.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Tuple

logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

Family = Dict[str, object]
Source = Callable[[], List[Family]]


def _fmt_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Named sources -> one Prometheus text page. Sources that raise are
    skipped with a log line (a scrape must degrade, never 500 the whole
    page because one plane is mid-shutdown)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: List[Tuple[str, Source]] = []

    def register(self, name: str, source: Source) -> None:
        with self._lock:
            self._sources.append((name, source))

    def render(self) -> str:
        with self._lock:
            sources = list(self._sources)
        lines: List[str] = []
        for name, source in sources:
            # the per-source guard covers RENDERING too: a malformed
            # family (missing key, non-numeric value) loses that
            # source's lines, never the whole page
            src_lines: List[str] = []
            try:
                for fam in source():
                    fname = str(fam["name"])
                    ftype = str(fam.get("type", "gauge"))
                    fhelp = str(fam.get("help", ""))
                    if fhelp:
                        src_lines.append(f"# HELP {fname} {fhelp}")
                    src_lines.append(f"# TYPE {fname} {ftype}")
                    for suffix, labels, value in fam["samples"]:
                        if value is None:
                            continue
                        src_lines.append(f"{fname}{suffix}"
                                         f"{_fmt_labels(labels)} "
                                         f"{_fmt_value(value)}")
            except Exception:  # noqa: BLE001 - a scrape must degrade
                logger.warning("metrics source %s failed; skipped",
                               name, exc_info=True)
                continue
            lines.extend(src_lines)
        return "\n".join(lines) + "\n"


# -- parsing (tests + trace_report cross-checks) --------------------------

def parse_text(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal Prometheus text parser:
    ``{metric_name: {label_string_or_'': value}}``. Enough structure
    for the identity oracles (``/metrics`` vs ``/stats``) — not a full
    client library."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, _, val = line.rpartition(" ")
        name, labels = body, ""
        if "{" in body:
            name, _, rest = body.partition("{")
            labels = "{" + rest
        out.setdefault(name, {})[labels] = float(val)
    return out


# -- sources --------------------------------------------------------------

def _counterish(prefix: str, stats: Dict[str, object],
                counters: Tuple[str, ...], gauges: Tuple[str, ...],
                help_prefix: str) -> List[Family]:
    fams: List[Family] = []
    for key in counters:
        if key in stats:
            fams.append({"name": f"{prefix}_{key}", "type": "counter",
                         "help": f"{help_prefix}: cumulative {key}",
                         "samples": [("_total", {}, stats[key])]})
    for key in gauges:
        if key in stats and isinstance(stats[key], (int, float)):
            fams.append({"name": f"{prefix}_{key}", "type": "gauge",
                         "help": f"{help_prefix}: {key}",
                         "samples": [("", {}, stats[key])]})
    return fams


_SERVING_COUNTERS = (
    "submitted", "admitted", "completed", "cancelled",
    "cancelled_mid_decode", "failed", "shed", "shed_queued", "browned",
    "flood_injected", "deadline_met", "deadline_missed",
    "prefix_hits", "prefix_misses")
_SERVING_GAUGES = (
    "uptime_s", "img_per_s", "goodput_img_per_s", "service_ema_s",
    "p50_latency_s", "p95_latency_s", "p50_ttft_s", "p95_ttft_s",
    "mean_occupancy", "mean_queue_depth", "max_queue_depth",
    "queue_depth", "queue_capacity", "n_slots")


def serving_source(engine) -> Source:
    """The serving ledger as Prometheus families — the SAME
    ``engine.stats()`` snapshot ``/stats`` serves, so the two endpoints
    agree by construction (the identity the acceptance test pins)."""

    def collect() -> List[Family]:
        stats = engine.stats()
        fams = _counterish("dalle_serving", stats, _SERVING_COUNTERS,
                           _SERVING_GAUGES, "serving ledger")
        lanes = stats.get("lanes", {})
        if lanes:
            fams.append({
                "name": "dalle_serving_lane_completed",
                "type": "counter",
                "help": "serving ledger: completions per priority lane",
                "samples": [("_total", {"lane": ln},
                             lanes[ln]["completed"]) for ln in lanes]})
            fams.append({
                "name": "dalle_serving_lane_shed", "type": "counter",
                "help": "serving ledger: sheds per priority lane",
                "samples": [("_total", {"lane": ln}, lanes[ln]["shed"])
                            for ln in lanes]})
        for flag in ("brownout", "draining"):
            if flag in stats:
                fams.append({"name": f"dalle_serving_{flag}",
                             "type": "gauge",
                             "help": f"serving state flag: {flag}",
                             "samples": [("", {},
                                          1.0 if stats[flag] else 0.0)]})
        return fams

    return collect


def aggregate_source(read_stats: Callable[[], Dict[str, object]]) -> Source:
    """Aux-peer source: the latest swarm-wide aggregate (the dict
    ``run_aux_peer.aggregate`` computes each refresh round) as gauges —
    ``read_stats`` returns the most recent aggregate (or {})."""

    def collect() -> List[Family]:
        stats = read_stats() or {}
        fams: List[Family] = []
        for key, value in sorted(stats.items()):
            if not isinstance(value, (int, float)) or isinstance(
                    value, bool):
                continue
            fams.append({"name": f"dalle_swarm_agg_{key}",
                         "type": "gauge",
                         "help": f"aux aggregate over live peer "
                                 f"records: {key}",
                         "samples": [("", {}, value)]})
        return fams

    return collect


def tracer_source(tracer) -> Source:
    """Span-derived per-phase latency histograms + recorder health
    counters from a :class:`~dalle_tpu_torch.obs.trace.Tracer`."""

    def collect() -> List[Family]:
        fams: List[Family] = [
            {"name": "dalle_trace_spans", "type": "counter",
             "help": "flight recorder: spans recorded",
             "samples": [("_total", {}, tracer.spans_recorded)]},
            {"name": "dalle_trace_ring_evictions", "type": "counter",
             "help": "flight recorder: ring rows evicted by the "
                     "byte cap",
             "samples": [("_total", {}, tracer.ring_evictions)]},
        ]
        samples_b, samples_s, samples_c = [], [], []
        for (plane, phase), h in sorted(
                tracer.histogram_snapshot().items()):
            base = {"plane": plane, "phase": phase}
            for le, cum in h["buckets"]:
                samples_b.append(("_bucket",
                                  {**base, "le": str(le)}, cum))
            samples_s.append(("_sum", base, h["sum"]))
            samples_c.append(("_count", base, h["count"]))
        if samples_c:
            fams.append({
                "name": "dalle_phase_latency_seconds",
                "type": "histogram",
                "help": "span-derived per-phase latency (seconds)",
                "samples": samples_b + samples_s + samples_c})
        return fams

    return collect


def write_metrics_response(handler: BaseHTTPRequestHandler,
                           registry: MetricsRegistry) -> None:
    """Render the registry and write one complete Prometheus text
    response on ``handler`` (the serving front-end's /metrics)."""
    body = registry.render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


# -- the standalone exposition server (aux peer flag) ---------------------

class _MetricsHandler(BaseHTTPRequestHandler):
    server: "MetricsHTTPServer"

    def log_message(self, fmt, *args):  # noqa: A003 - route to logging
        logger.debug("%s " + fmt, self.client_address[0], *args)

    def do_GET(self):  # noqa: N802 - stdlib handler contract
        if self.path == "/metrics":
            write_metrics_response(self, self.server.registry)
        elif self.path == "/healthz":
            body = json.dumps({"ok": True}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()


class MetricsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, registry: MetricsRegistry):
        super().__init__(address, _MetricsHandler)
        self.registry = registry


def start_metrics_server(registry: MetricsRegistry,
                         host: str = "127.0.0.1", port: int = 0
                         ) -> Tuple[MetricsHTTPServer, threading.Thread]:
    """Serve ``registry`` at ``/metrics`` on a daemon thread; returns
    (server, thread). Callers stop it with ``server.shutdown();
    server.server_close(); thread.join(timeout=...)``."""
    server = MetricsHTTPServer((host, port), registry)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-metrics-http", daemon=True)
    thread.start()
    return server, thread
