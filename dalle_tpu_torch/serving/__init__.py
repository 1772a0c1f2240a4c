"""Continuous-batching serving stack (the port's ``dalle_tpu/serving``).

- :mod:`engine`    — the slot-recycled KV-cache decode engine on
  ``decode_step``'s per-slot position tensor, with priority lanes,
  deadline shedding, mid-decode cancellation and brownout; on the card
  its chunk is one CUDA graph a visible bucket
- :mod:`scheduler` — admission by free slots + KV budget across
  priority lanes, deadline prediction
- :mod:`metrics`   — per-request TTFT/latency, occupancy, queue depth,
  img/s, per-lane percentiles, shed/brownout/cancel counters, goodput
- :mod:`pixels`    — VQGAN pixel decode + CLIP rerank of finished slots
  on a worker thread, overlapped with token generation
- :mod:`chaos`     — seeded declarative fault injection
- :mod:`server`    — the stdlib HTTP front-end (``cli/run_server.py``)
- :mod:`prefix_cache` — the prompt-prefix KV pool: warm admission skips
  the teacher-forced text prefill bit-exactly

The fleet router (``dalle_tpu/serving/router.py``) waits for the port's
swarm DHT.
"""

from dalle_tpu_torch.serving.chaos import (ServeChaos, ServeFaultPlan,
                                           maybe_wrap_serving)
from dalle_tpu_torch.serving.engine import (DeadlineShedError, DecodeEngine,
                                            RequestHandle)
from dalle_tpu_torch.serving.metrics import ServingMetrics
from dalle_tpu_torch.serving.pixels import PixelPipeline
from dalle_tpu_torch.serving.prefix_cache import (PrefixCache,
                                                  prompt_fingerprint)
from dalle_tpu_torch.serving.scheduler import (LANES, SlotScheduler,
                                               kv_bytes_per_slot)

__all__ = [
    "LANES",
    "DeadlineShedError",
    "DecodeEngine",
    "PixelPipeline",
    "PrefixCache",
    "RequestHandle",
    "ServeChaos",
    "ServeFaultPlan",
    "ServingMetrics",
    "SlotScheduler",
    "kv_bytes_per_slot",
    "maybe_wrap_serving",
    "prompt_fingerprint",
]
