"""95th percentile of the seconds from a request's submit to its first
image code, over the requests whose first code came in the window (the
engine's ``record_submit`` and ``record_first_code``). Moves
``serve_latency_p95_s``."""

from benchmark import harness


def read(record):
    return harness.percentile(record.get("ttft_s") or [], 95.0)
