"""Observability for the port: span tracing and the Prometheus text
exposition (copies of ``dalle_tpu/obs``, stdlib only)."""

from dalle_tpu_torch.obs.exposition import (CONTENT_TYPE,  # noqa: F401
                                            MetricsRegistry, parse_text,
                                            serving_source, tracer_source)
from dalle_tpu_torch.obs.trace import (BUCKETS_S, NULL_SPAN,  # noqa: F401
                                       Tracer, configure, default_tracer,
                                       load_jsonl, merge_rows, span)
