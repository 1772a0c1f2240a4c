"""Configuration of the PyTorch port.

The port's own copy of ``dalle_tpu/config.py``'s model and optimizer
halves (``ModelConfig``, the attention-type names, ``tiny_model_config``,
the flagship preset and ``OptimizerConfig``): the port imports nothing of
``dalle_tpu``. Field names, defaults and the derived schedule are
identical, so one set of keyword arguments builds the same model in either
package, and the parameter converter (``params.py``) can map one tree onto
the other.

The training knobs ``remat``, ``remat_policy``, ``remat_skip_blocks`` and
``param_cast_hoist`` shape the port's training step as they shape the JAX
one (``remat`` and ``remat_skip_blocks`` also decide which blocks run the
fused GEGLU kernel, ``fuse_ff``). ``scan_unroll``, ``head_chunk`` and
``sequence_parallel`` are kept so both packages build the same
configuration: ``scan_unroll`` decides which parameter layout the JAX model
writes, and the port ignores the other two.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

ATTN_FULL = "full"
ATTN_AXIAL_ROW = "axial_row"
ATTN_AXIAL_COL = "axial_col"
ATTN_CONV_LIKE = "conv_like"

VALID_ATTN_TYPES = (ATTN_FULL, ATTN_AXIAL_ROW, ATTN_AXIAL_COL, ATTN_CONV_LIKE)

SP_NONE = "none"
SP_ULYSSES = "ulysses"
SP_RING = "ring"

VALID_SP_MODES = (SP_NONE, SP_ULYSSES, SP_RING)


@dataclass(frozen=True)
class ModelConfig:
    """DALL-E transformer shape (defaults: the 1.3B flagship, dim 1024,
    depth 64 over 4 weight-shared blocks plus a final ``conv_like`` block,
    16 heads x 64, text 256 + image 32x32 tokens)."""

    vocab_text: int = 32100
    vocab_image: int = 8192
    text_seq_len: int = 256
    image_grid: int = 32
    dim: int = 1024
    depth: int = 64
    heads: int = 16
    head_dim: int = 64
    ff_mult: int = 4
    attn_types: Tuple[str, ...] = (
        ATTN_AXIAL_ROW, ATTN_AXIAL_COL, ATTN_AXIAL_ROW, ATTN_AXIAL_ROW)
    shared_block_cycle: int = 4
    dense_scan: bool = False
    final_conv_block: bool = True
    conv_kernel: int = 11
    rotary: bool = True
    tied_embeddings: bool = True
    dropout: float = 0.0
    loss_img_weight: float = 7.0
    remat: bool = True
    remat_policy: Optional[str] = None
    remat_skip_blocks: int = 0
    head_chunk: int = 0
    scan_unroll: int = 1
    param_cast_hoist: bool = False
    ff_fusion: str = "plain"
    ln_fusion: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    sequence_parallel: str = SP_NONE

    @property
    def image_seq_len(self) -> int:
        return self.image_grid * self.image_grid

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def vocab_total(self) -> int:
        return self.vocab_text + self.vocab_image

    def fuse_ff(self, is_plain: bool) -> bool:
        """Whether a block's FF goes through the fused GEGLU kernel: "all"
        fuses every block; "plain" fuses the blocks the JAX trainer does not
        rematerialise (``remat_skip_blocks``), or every block without remat."""
        return (self.ff_fusion == "all"
                or (self.ff_fusion == "plain"
                    and (is_plain or not self.remat)))

    def plain_block_ids(self) -> Tuple[int, ...]:
        """Unique body block ids the JAX model leaves un-rematerialised: the
        highest ``remat_skip_blocks`` ids of the body (``w_conv`` never)."""
        if not (self.remat and self.remat_skip_blocks):
            return ()
        body = sorted({u for u, _ in self.layer_schedule() if u != -1})
        return tuple(body[len(body) - self.remat_skip_blocks:])

    def layer_schedule(self) -> Tuple[Tuple[int, str], ...]:
        """(unique_block_id, attn_type) per layer; the final ``conv_like``
        block, when present, has id -1."""
        sched = []
        body = self.depth - (1 if self.final_conv_block else 0)
        cycle = self.shared_block_cycle or body
        for i in range(body):
            uid = i % cycle
            sched.append((uid, self.attn_types[uid % len(self.attn_types)]))
        if self.final_conv_block:
            sched.append((-1, ATTN_CONV_LIKE))
        return tuple(sched)

    def dense_scan_reps(self) -> int:
        """Scan repetitions of the JAX ``dense_scan`` layout (0 when the
        dense stack is not stacked)."""
        if self.shared_block_cycle or not self.dense_scan:
            return 0
        body = self.depth - (1 if self.final_conv_block else 0)
        reps = -(-body // len(self.attn_types))
        return reps if reps > 1 else 0

    def validate(self) -> None:
        for t in self.attn_types:
            if t not in VALID_ATTN_TYPES:
                raise ValueError(f"unknown attention type {t!r}")
        if self.dim != self.heads * self.head_dim:
            raise ValueError("dim must equal heads * head_dim")
        if self.remat_policy not in (None, "save_ctx", "save_attn"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                "expected None, 'save_ctx' or 'save_attn'")
        if not (0 <= self.remat_skip_blocks
                <= max(self.shared_block_cycle, 0)):
            raise ValueError(
                f"remat_skip_blocks {self.remat_skip_blocks} outside "
                f"[0, shared_block_cycle={self.shared_block_cycle}]")
        if self.ff_fusion not in ("none", "plain", "all"):
            raise ValueError(
                f"unknown ff_fusion {self.ff_fusion!r}; "
                "expected 'none', 'plain' or 'all'")
        if self.sequence_parallel not in VALID_SP_MODES:
            raise ValueError(
                f"unknown sequence_parallel {self.sequence_parallel!r}; "
                f"expected one of {VALID_SP_MODES}")
        if self.sequence_parallel == SP_RING:
            types = set(self.attn_types) | (
                {ATTN_CONV_LIKE} if self.final_conv_block else set())
            if types != {ATTN_FULL}:
                raise ValueError(
                    "sequence_parallel='ring' requires every layer be "
                    f"'full' attention (got {sorted(types)})")


def tiny_model_config(**overrides: Any) -> ModelConfig:
    """CPU-sized configuration (the JAX package's ``tiny_model_config``)."""
    base = dict(
        vocab_text=128, vocab_image=64, text_seq_len=16, image_grid=4,
        dim=64, depth=4, heads=4, head_dim=16, shared_block_cycle=0,
        final_conv_block=False, attn_types=(ATTN_FULL,), rotary=True,
        dtype="float32", remat=False,
    )
    base.update(overrides)
    return ModelConfig(**base)


# The JAX package's flagship training knobs. ``ln_fusion`` and
# ``remat_skip_blocks`` (through ``fuse_ff``) change what the forward runs;
# ``remat_policy`` and ``param_cast_hoist`` shape the training step;
# ``head_chunk`` and ``scan_unroll`` are kept so the two packages build the
# same configuration.
FLAGSHIP_TUNED = dict(remat_skip_blocks=1, head_chunk=2048, scan_unroll=2,
                      ln_fusion=True, remat_policy="save_attn",
                      param_cast_hoist=True)


def flagship_model_config(**overrides: Any) -> ModelConfig:
    """The 1.3B flagship with ``FLAGSHIP_TUNED`` applied."""
    base = dict(FLAGSHIP_TUNED)
    base.update(overrides)
    return dataclasses.replace(ModelConfig(), **base)


@dataclass(frozen=True)
class OptimizerConfig:
    """LAMB hyperparameters (``dalle_tpu.config.OptimizerConfig``, the
    fields this port reads). ``state_bits`` 8 (the default, as in the JAX
    package) is the 8-bit LAMB: moments of tensors with at least
    ``min_8bit_size`` elements block-quantized in blocks of ``block_size``;
    32 is the fp32 clipped LAMB. ``max_grad_norm`` None turns the global
    clip off."""

    learning_rate: float = 2.5e-3
    warmup_steps: int = 3125
    total_steps: int = 31250
    beta1: float = 0.9
    beta2: float = 0.96
    eps: float = 1e-6
    weight_decay: float = 0.045
    max_grad_norm: Optional[float] = 4.0
    clamp_value: float = 10000.0
    state_bits: int = 8
    block_size: int = 4096
    min_8bit_size: int = 65536


@dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching decode engine knobs (``serving/``): the JAX
    package's ``ServingConfig``, field for field, with its defaults.

    The reference has no serving path at all (its inference tool is a
    one-shot CLI); these knobs size the slot-recycled KV-cache engine
    that replaces whole-batch lockstep decode for online traffic.
    """

    # KV-cache slots = max concurrently decoding requests. The cache is
    # allocated once at this batch size; a finished slot is recycled
    # immediately from the request queue (image generation is fixed-
    # length, so staggered admission gives staggered completion).
    n_slots: int = 4
    # Decode positions advanced per chunk call (one CUDA graph replay on
    # the card). Admission, completion
    # harvest and metrics sampling happen at call boundaries, so this is
    # the scheduling granularity: smaller = finer admission latency,
    # larger = less host-loop overhead per token.
    steps_per_call: int = 8
    # Cap on KV-cache bytes the engine may OCCUPY concurrently; caps
    # admitted slots at floor(budget / bytes-per-slot) when set. The
    # cache itself is statically allocated at n_slots (the captured
    # graphs need static shapes) — the budget models co-tenancy
    # pressure (HBM shared with a trainer or a second engine) by
    # bounding live occupancy.
    kv_budget_mb: Optional[int] = None
    # Prefix-bucket count for the statically-truncated cache reads
    # (models/decode.py resolve_buckets); None = the measured adaptive
    # choice for n_slots. Each bucket captures one chunk graph.
    decode_buckets: Optional[int] = None
    # Cap on requests admitted per chunk boundary (None = all eligible).
    # The pipelined loop scatters each admission batch as ONE
    # dispatch; bounding the burst keeps a cold start against a deep
    # queue from wedging one outsized scatter between chunks.
    admit_burst: Optional[int] = None
    # Fall back to the r8 host-synchronous loop: block on a device→host
    # position pull after every chunk instead of scheduling from the
    # deterministic host mirror. Exists as the A/B baseline for
    # scripts/engine_loop_bench.py and as a debug escape hatch — the
    # pulled values always equal the mirror, so this buys nothing but
    # the stall it measures.
    host_sync_loop: bool = False
    # Queued (not yet admitted) requests beyond this are rejected at
    # submit — backpressure instead of unbounded growth. The capacity
    # is shared across priority lanes.
    queue_capacity: int = 256
    # Starvation bound for the low priority lane: after this many
    # consecutive boundaries where the low lane had queued work but
    # every grant went high, one admission is reserved for it. None =
    # strict priority (the low lane may starve under sustained load).
    low_lane_bypass: Optional[int] = 8
    # Default per-request completion deadline (seconds from submit)
    # when the request carries none; None = no deadline (never shed).
    # A request whose predicted completion (queue depth x measured
    # decode cadence) misses its deadline is SHED at submit, before
    # any decode is spent.
    default_deadline_s: Optional[float] = None
    # Brownout hysteresis: degraded serving (front-end trims n_images
    # to brownout_max_images, pixel stage skips CLIP rerank) engages
    # once the queue sits at/above high_frac x queue_capacity for
    # hold_s seconds, and disengages at low_frac x queue_capacity.
    brownout_high_frac: float = 0.75
    brownout_low_frac: float = 0.25
    brownout_hold_s: float = 1.0
    brownout_max_images: int = 1
    # Prompt-prefix KV cache (serving/prefix_cache.py): pool the
    # teacher-forced text-segment KV per distinct prompt on device and
    # admit repeated prompts at pos = text_seq_len, skipping their
    # whole text prefill (bit-exact to the cold path — the text KV is
    # a pure function of the prompt; pinned by test). The value is the
    # pool's byte budget in MB (fixed-size entries, LRU eviction); when
    # kv_budget_mb is also set the pool is RESERVED out of it, so the
    # engine's total KV footprint stays under the one existing budget.
    # None (the default) disables the pool — admission byte-identical
    # to the r12 path.
    prefix_cache_mb: Optional[float] = None
    # Serving fault plan (serving/chaos.py ServeFaultPlan: inline JSON
    # or a file path). None = the bit-transparent clean path.
    chaos_plan: Optional[str] = None
    # How long a front-end waits on a request future before 504 (the
    # timeout also CANCELS the request mid-decode — slots are
    # reclaimed, not left decoding for a client that gave up).
    request_timeout_s: float = 300.0
    # stop(drain=True) bound: finish queued + in-flight work within this
    # window, then the engine thread is joined regardless.
    drain_timeout_s: float = 60.0
    # Serving front-end bind address (stdlib HTTP server).
    http_host: str = "127.0.0.1"
    http_port: int = 8080
    # Seconds between metrics JSONL snapshot rows (0 disables).
    metrics_interval_s: float = 5.0
    # Flight recorder (dalle_tpu/obs, OBSERVABILITY.md): append the
    # engine's request-lifecycle spans (submit → admit → first_code →
    # harvest → pixels → complete, trace id = the request id) plus
    # chunk-cadence spans as JSONL. None (the default) records
    # nothing; the engine loop pays one `is None` test.
    trace_file: Optional[str] = None
    trace_ring_kb: int = 256

    def validate(self) -> None:
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1 (got {self.n_slots})")
        if self.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1 (got {self.steps_per_call})")
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1 (got {self.queue_capacity})")
        if self.admit_burst is not None and self.admit_burst < 1:
            raise ValueError(
                f"admit_burst must be >= 1 or None (got {self.admit_burst})")
        if self.low_lane_bypass is not None and self.low_lane_bypass < 1:
            raise ValueError(
                f"low_lane_bypass must be >= 1 or None "
                f"(got {self.low_lane_bypass})")
        if self.default_deadline_s is not None \
                and not self.default_deadline_s > 0:
            raise ValueError(
                f"default_deadline_s must be > 0 or None "
                f"(got {self.default_deadline_s})")
        if not 0.0 < self.brownout_high_frac <= 1.0:
            raise ValueError(
                f"brownout_high_frac must be in (0, 1] "
                f"(got {self.brownout_high_frac})")
        if not 0.0 <= self.brownout_low_frac < self.brownout_high_frac:
            raise ValueError(
                "brownout_low_frac must satisfy 0 <= low < high_frac "
                f"(got {self.brownout_low_frac})")
        if self.brownout_hold_s < 0:
            raise ValueError(
                f"brownout_hold_s must be >= 0 "
                f"(got {self.brownout_hold_s})")
        if self.brownout_max_images < 1:
            raise ValueError(
                f"brownout_max_images must be >= 1 "
                f"(got {self.brownout_max_images})")
        if self.prefix_cache_mb is not None \
                and not self.prefix_cache_mb > 0:
            raise ValueError(
                f"prefix_cache_mb must be > 0 or None "
                f"(got {self.prefix_cache_mb})")
