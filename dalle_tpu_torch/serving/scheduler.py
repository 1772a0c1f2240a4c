"""Admission control for the continuous-batching engine.

The port's copy of ``dalle_tpu/serving/scheduler.py``: the same inputs
give the same grants and predictions; ``kv_bytes_per_slot`` measures the
port's flat cache.

r8 policy was FIFO over one queue, admitted when (a) a cache slot is
free and (b) the KV budget allows another live slot. This round adds
**priority lanes** and **deadline awareness** on top of the same slot
machinery:

- Lanes (:data:`LANES`): ``"high"`` (interactive — strict priority) and
  ``"low"`` (batch/bulk). Admission serves the high lane first, with a
  **bounded bypass** for starvation freedom: after ``low_lane_bypass``
  consecutive boundaries where the low lane had queued work but every
  grant went high, one slot is reserved for the low lane before the
  high queue is served. Image generation is fixed-length, so within a
  lane admission order is completion order up to slot-level skew; the
  bypass bounds cross-lane starvation to ``low_lane_bypass`` waves.
- Deadline prediction (:meth:`SlotScheduler.predict_completion_s`): a
  pure function of queue depth ahead, live slots and the measured
  per-request decode service time (an EMA the metrics ledger keeps from
  admit→harvest timing, which the r9 host position mirror makes exact
  at chunk granularity). The engine sheds a request — at submit, before
  any decode is spent — when the prediction strictly exceeds its
  deadline, and re-sheds queued requests whose deadline has become
  unmeetable while they waited.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from dalle_tpu_torch.config import ModelConfig

#: priority order, index 0 highest. Two lanes deliberately: every lane
#: is a head-of-line-blocking boundary and a starvation surface; more
#: tiers than "interactive" vs "bulk" buys ordering nobody asked for.
LANES = ("high", "low")


def completion_waves(ahead: int, live: int, max_live: int) -> int:
    """Admission waves until a request queued behind ``ahead`` others
    (with ``live`` slots decoding) reaches a slot: the queue drains
    ``max_live`` at a time. ONE definition for the engine's deadline
    shedder and the router's placement predictions — the two sides of
    the same admission economy must never disagree."""
    return 1 + (ahead + live) // max(1, max_live)


def predict_completion_s(ahead: int, live: int, max_live: int,
                         service_s: float) -> float:
    """The wave model: waves × the measured per-request service time.
    Exact for saturated fixed-length decode, optimistic by partial-wave
    progress otherwise — the right bias for a shed/placement decision
    (never reject work a healthy engine would have finished)."""
    return completion_waves(ahead, live, max_live) * service_s


def kv_bytes_per_slot(cfg: ModelConfig) -> int:
    """KV-cache bytes one slot (batch row) owns, from the port's own cache
    (``models/decode.init_cache`` on the meta device): (n_layers, B, T,
    H*d) k and v, one pair per layer application. The flagship: 64 x 1280
    x 1024 x 2 (k, v) x 2 B = 335,544,320 B in bf16. The JAX package's
    cycle layout keeps 65 slots (its scan's discarded overhang
    application), so it counts 340,787,200 B for the same model."""
    from dalle_tpu_torch.models.decode import init_cache

    cache = init_cache(cfg, 1, "meta")
    return sum(t.numel() * t.element_size() for t in cache.values())


class SlotScheduler:
    """Free-slot + KV-budget admission with priority lanes.

    ``kv_budget_mb`` caps how many slots may be LIVE at once:
    ``floor(budget / bytes-per-slot)``, clamped to [1, n_slots]. The
    cache is statically allocated at ``n_slots`` either way (static
    shapes); the budget models co-tenancy pressure — an engine sharing
    HBM with a trainer admits fewer concurrent requests instead of
    OOMing mid-flight. The budget is lane-blind by design: a saturated
    high lane consumes the whole clamp and the low lane rides only the
    bypass.

    ``admit_burst`` caps admissions PER CALL BOUNDARY, across all lanes
    combined. The pipelined engine scatters a whole admission batch in
    one dispatch; a huge burst (cold start against a deep queue) puts
    one outsized scatter + prefix upload between two chunks and dents
    the dispatch cadence — bounding the burst amortizes admission over
    several boundaries instead. None = admit everything eligible.

    ``low_lane_bypass``: consecutive starved boundaries the low lane
    tolerates before one admission is reserved for it (None disables —
    strict priority, the low lane may starve forever under sustained
    high-lane load).
    """

    def __init__(self, n_slots: int, bytes_per_slot: int,
                 kv_budget_mb: Optional[int] = None,
                 admit_burst: Optional[int] = None,
                 low_lane_bypass: Optional[int] = None,
                 reserved_bytes: int = 0):
        self.n_slots = n_slots
        self.bytes_per_slot = bytes_per_slot
        self.admit_burst = admit_burst
        if low_lane_bypass is not None and low_lane_bypass < 1:
            raise ValueError(
                f"low_lane_bypass must be >= 1 or None, "
                f"got {low_lane_bypass}")
        self.low_lane_bypass = low_lane_bypass
        self._low_starved = 0
        if kv_budget_mb is None:
            self.max_live = n_slots
        else:
            # reserved_bytes carves a co-tenant pool (the prompt-prefix
            # cache) out of the SAME budget: live slots + pool together
            # stay under kv_budget_mb, with at least one slot always
            # admissible (the clamp below) so a misconfigured reserve
            # degrades throughput, never wedges admission
            by_budget = (kv_budget_mb * 2 ** 20
                         - max(0, int(reserved_bytes))) \
                // max(1, bytes_per_slot)
            self.max_live = int(max(1, min(n_slots, by_budget)))

    def grant(self, queued: int, live: int, free: int) -> int:
        """Total admissions this call boundary (lane-blind: the r8
        contract, still the budget/burst arbiter under lanes)."""
        n = max(0, min(queued, free, self.max_live - live))
        if self.admit_burst is not None:
            n = min(n, self.admit_burst)
        return n

    def grant_lanes(self, queued: Sequence[int], live: int,
                    free: int) -> List[int]:
        """Per-lane admissions this boundary, ``queued`` in
        :data:`LANES` priority order. The total is exactly
        ``grant(sum(queued), live, free)`` — lanes change WHO is
        admitted, never how many — and higher lanes are served first
        except for the bounded low-lane bypass.

        Starvation bookkeeping lives here (one scheduler per engine,
        called once per boundary from the engine thread): a boundary
        counts as starving the low lane when it had queued work, some
        OTHER lane was granted, and it got nothing. A zero-grant
        boundary (no free slot / budget) starves nobody — there was
        nothing to bypass into.
        """
        if len(queued) != len(LANES):
            raise ValueError(
                f"queued must have one entry per lane {LANES}, "
                f"got {len(queued)}")
        budget = self.grant(sum(queued), live, free)
        grants = [0] * len(LANES)
        low = len(LANES) - 1
        if (budget > 0 and queued[low] > 0
                and self.low_lane_bypass is not None
                and self._low_starved >= self.low_lane_bypass):
            grants[low] = 1
            budget -= 1
        for i, q in enumerate(queued):
            take = min(budget, q - grants[i])
            grants[i] += take
            budget -= take
        if grants[low] > 0:
            self._low_starved = 0
        elif queued[low] > 0 and sum(grants) > 0:
            self._low_starved += 1
        return grants

    def predict_completion_s(self, ahead: int, live: int,
                             service_s: float) -> float:
        """Predicted seconds until a request queued behind ``ahead``
        same-or-higher-lane requests (with ``live`` slots already
        decoding) completes, given the measured per-request decode
        service time — the module-level wave model at this scheduler's
        admission clamp (see :func:`predict_completion_s`)."""
        return predict_completion_s(ahead, live, self.max_live,
                                    service_s)
