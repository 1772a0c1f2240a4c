"""Configuration of the PyTorch port.

The port's own copy of ``dalle_tpu/config.py`` (``ModelConfig``, the
attention-type names, ``tiny_model_config``, the flagship, XL and
long-context presets,
``OptimizerConfig``, the trainer peer's ``TrainerConfig``, ``CollabConfig``
and ``PeerConfig``, the aux peer's ``AuxConfig``, and ``ServingConfig``):
the port imports nothing of ``dalle_tpu``. The trainer peer's dataclasses
carry every JAX field with its default, because the CLIs derive their
flags from them; the mesh axes (``dp``, ``fsdp``, ``tp``, ``sp``) lay the
peer's processes out as ``parallel/mesh.py`` says. Field names, defaults
and the derived schedule are identical, so one set of keyword arguments
builds the same model in either package, and the parameter converter (``params.py``) can
map one tree onto the other.

The training knobs ``remat``, ``remat_policy``, ``remat_skip_blocks`` and
``param_cast_hoist`` shape the port's training step as they shape the JAX
one (``remat`` and ``remat_skip_blocks`` also decide which blocks run the
fused GEGLU kernel, ``fuse_ff``); ``sequence_parallel`` picks ring or
Ulysses attention on a mesh with ``sp > 1`` (``parallel/sequence.py``),
and ``"none"`` leaves the token axis whole (the ``sp`` ranks are then
replicas, as in JAX); ``head_chunk`` streams the tied head's logsumexp
over that many vocabulary rows (``models/dalle.py``). ``scan_unroll`` is
kept so both packages build the same configuration: it decides which
parameter layout the JAX model writes.
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
        highest ``remat_skip_blocks`` ids of the body (``w_conv`` never);
        none in the stacked ``dense_scan`` layout, whose scan rematerialises
        every block."""
        if not (self.remat and self.remat_skip_blocks) \
                or self.dense_scan_reps():
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
# ``remat_policy``, ``param_cast_hoist`` and ``head_chunk`` shape the
# training step; ``scan_unroll`` is kept so the two packages build the same
# configuration.
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
    clip off. ``offload`` keeps the optimizer state in (pinned) host
    memory between updates and streams it through the device for each
    update (``training/offload.py``)."""

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
    # host-resident optimizer state (training/offload.py)
    offload: bool = False
    # dense_scan stacked-leaf leading-axis size (ModelConfig
    # .dense_scan_reps()), threaded in by the task wiring so LAMB's
    # per-slice trust ratios are config-derived. 0 = the model has no
    # stacked leaves; None = infer from the parameter names and ranks.
    stacked_reps: "int | None" = None


@dataclass(frozen=True)
class TrainerConfig:
    """Local training-loop knobs (reference ``arguments.py:8-56``)."""

    per_device_batch: int = 2         # arguments.py:12-14
    grad_accum_steps: int = 1
    seed: int = 0
    text_pad_id: int = 1              # T5 pad token (=eos in reference, task.py:58-59)
    # Mesh axis sizes; -1 means "use all remaining devices" on the dp axis
    # (in the port: the peer's processes, one device each, parallel/mesh.py)
    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1                       # sequence parallelism (ring attention)

    @property
    def local_batch_per_step(self) -> int:
        return self.per_device_batch * self.grad_accum_steps


@dataclass(frozen=True)
class CollabConfig:
    """Swarm-wide optimizer semantics (reference ``arguments.py:60-78``)."""

    run_id: str = "dalle-tpu"
    target_batch_size: int = 4096     # arguments.py:62-65
    matchmaking_time: float = 15.0    # arguments.py:66-68
    allreduce_timeout: float = 60.0   # arguments.py:69-71
    averaging_timeout: float = 180.0  # arguments.py:72-74
    # Average params+opt state with peers every N epochs to bound drift.
    # Rounds are byte-identical across surviving members (part owners apply
    # the same lossy wire bytes they broadcast), so state averaging is
    # repair for peers that missed chunks, not a per-epoch necessity —
    # and keeping it off the common path halves the per-epoch matchmaking
    # cost, which keeps peers' matchmaking windows aligned.
    average_state_every: int = 10
    # Compression: tensors with <= threshold elems -> fp16, else uniform 8-bit
    # (SizeAdaptiveCompression(threshold=2**16+1, ...), task.py:125-126).
    # "power_sgd" instead exchanges rank-r low-rank factors with error
    # feedback (swarm/powersgd.py; hivemind carries PowerSGD upstream,
    # SURVEY.md §2 component 15).
    size_adaptive_threshold: int = 2 ** 16 + 1
    # NOTE: the tuned flagship operating point (FLAGSHIP_TUNED, PERF.md)
    # was measured against the HBM wall with size_adaptive compression.
    # power_sgd keeps device-resident f32 error-feedback + in-flight M
    # caches at gradient size (~500 MB persistent + ~2x transient for the
    # flagship's 125.6M unique params) — see PERF.md's PowerSGD footprint
    # note before combining it with the tuned micro/accum point.
    grad_compression: str = "size_adaptive"
    state_compression: str = "size_adaptive"
    # Where the u8/u4/f16 wire codec EXECUTES (never what it emits —
    # wire bytes are backend-identical, mixed groups interoperate):
    # "device" runs quantize/dequantize as jitted programs on the
    # accelerator (swarm/device_codec.py; measured on the JAX package: 20.1 s +
    # 13.8 s of host numpy codec per N=4 flagship epoch while the TPU
    # idled) and hands gradients to the wire without the host f32 pull;
    # "host" is the numpy path; "auto" picks device on TPU peers, host
    # elsewhere.
    wire_codec_backend: str = "auto"
    # --- In-collective quantization (EQuARX arxiv 2506.17615,
    # DynamiQ arxiv 2602.08923). wire_bits_reduce / wire_bits_gather PIN
    # the wire codec of the butterfly's two legs for the whole run —
    # 8 -> blockwise u8, 4 -> blockwise u4 (half the sync bytes again)
    # — instead of the per-part SizeAdaptive dispatch. A pinned leg
    # also REJECTS frames naming any other codec (codec flapping is
    # authenticated garbage: error-feedback residual scales are only
    # meaningful against one stable quantizer). None keeps the legacy
    # grad_compression dispatch for that leg, byte-identical to the unpinned protocol.
    wire_bits_reduce: "int | None" = None
    wire_bits_gather: "int | None" = None
    # Error-feedback residuals through the collective: each sender
    # carries the previous round's quantization error into this round's
    # scatter encode (device-resident, donated under the device codec
    # backend), and each part owner carries its own residual into the
    # gather re-quantize (the DynamiQ second aggregation-hop stage; the
    # carry-in is suspended on audit-challenged parts so the audit replay
    # stays bit-exact — swarm/error_feedback.py). Requires BOTH
    # wire_bits knobs pinned; False + 8-bit leaves every round
    # byte-identical to the unpinned protocol.
    ef_residuals: bool = False
    # --- In-collective hop pipelining (DynamiQ arXiv 2602.08923,
    # EQuARX arXiv 2506.17615: the win is overlapping compressed hops
    # INSIDE the collective against compute, not just overlapping the
    # round as a whole). With pipeline_hops the butterfly's legs stop
    # being strictly sequential: gather-leg frames drain/decode/apply
    # on a background thread from round start, the owner's averaged
    # part is served as soon as the reduce finishes (before the scatter
    # barrier + EF store), and scatter parts are encoded/sent with at
    # most pipeline_depth parts in flight so encode(part i+1) overlaps
    # send(part i). OFF leaves every round byte-identical to the
    # sequential protocol; ON changes only wall-clock placement — the
    # averaged bytes, EF residuals, and audit transcripts are bit-exact
    # either way (pinned by tests/test_pipeline.py).
    pipeline_hops: bool = False
    # Max scatter parts concurrently in the encode/send window (>=1).
    pipeline_depth: int = 2
    powersgd_rank: int = 4
    # Run PowerSGD's Gram-Schmidt on the host (bit-stable IEEE f32 loop
    # order) instead of on device. Cross-peer basis agreement needs every
    # group member to orthogonalize identical averaged bytes identically;
    # device MGS guarantees that only on a homogeneous XLA backend, and a
    # volunteer swarm is exactly where jax/XLA builds differ — divergent
    # bases silently corrupt reconstructed gradients on every peer. Host
    # MGS is bit-stable across peers and costs O(m*r^2) on a rank-4
    # (m x 4) factor — noise next to the wire round-trip — so it is the
    # DEFAULT; flip off only for a fleet known to run one backend build.
    powersgd_host_orthogonalize: bool = True
    # AEAD-encrypt the all-reduce data plane under a per-round group key
    # distributed through the signed matchmaking confirmation
    # (swarm/crypto.py). The reference gets transport encryption from
    # libp2p's security handshake; ours is framing-level.
    encrypt_data_plane: bool = True
    delay_optimizer_step: bool = True  # task.py:129
    reuse_grad_buffers: bool = True    # task.py:133
    metrics_expiration: float = 600.0  # statistics_expiration, arguments.py:129-131
    # --- Byzantine defense (swarm/screening.py + swarm/health.py;
    # CHAOS.md "Defense in depth"). Signatures and strict parsing stop
    # forged/malformed traffic; these knobs govern the CONTENT layer:
    # screening of valid-but-wrong gradients, the sender-weight clamp,
    # and gossiped signed strike receipts.
    # Norm/cosine outlier screening of scatter contributions at each
    # part owner (drop/keep, never reweight — surviving rounds stay
    # bit-identical to an honest-only round). Auto-skipped below
    # screen_min_senders weighted contributors (small swarms keep the
    # pre-screening semantics byte-for-byte).
    screen_gradients: bool = True
    screen_min_senders: int = 4
    # never drop a majority (see screening.ScreenPolicy for the
    # calibration rationale on every threshold)
    screen_max_drop_frac: float = 0.49
    screen_norm_tolerance: float = 8.0
    screen_cosine_floor: float = -0.5
    # Clamp on sender-supplied frame weights (a single signed frame
    # claiming weight=1e9 otherwise drowns the swarm with no value
    # screen tripping): claims outside [0, max_peer_weight] are dropped
    # with an attributable strike. None -> target_batch_size (no single
    # peer can legitimately carry more than the whole swarm's target);
    # 0 disables the clamp.
    max_peer_weight: "float | None" = None
    # Gossip attributable strikes as Ed25519-signed receipts under
    # {run_id}_strikes and fold verified remote receipts into the local
    # ledger (bounded influence: no issuer veto, and remote evidence
    # alone can never convict — health.py). Off = ledger stays local.
    gossip_strikes: bool = True
    strike_gossip_period: float = 5.0
    # Verified aggregation (swarm/audit.py; CHAOS.md "Defense in
    # depth" row 7): each round a deterministic challenge derived from
    # the shared round id selects parts whose owner must serve a
    # signed audit transcript (the sender-signed inputs it averaged,
    # its drop-set, the accumulation order); any member replays the
    # weighted mean + the screen decisions and bit-compares against
    # the part it gathered. A mismatch is an owner-audit-fail strike
    # that gossips via the signed-receipt plane. audit_frac is the
    # per-part challenge probability per round: a challenged part
    # costs its owner the transcript (≈ the part's scatter traffic
    # re-served from its mailbox) and each auditor a fetch + full
    # re-verify/replay, so the default SAMPLES — every owner is
    # audited in expectation every ~1/frac rounds, which convicts a
    # persistent cheat within a few epochs at a quarter of the
    # bandwidth/CPU tax (the soaks and gates run frac=1.0 for
    # deterministic conviction-latency oracles). audit_ttl bounds how
    # long a transcript stays fetchable in the owner's mailbox. Off =
    # zero retention, rounds byte-identical to the pre-audit protocol.
    audit_gather: bool = True
    audit_frac: float = 0.25
    audit_ttl: float = 120.0
    # Round repair (swarm/repair.py; CHAOS.md "Round repair"): an
    # owner-audit-fail conviction whose replay SUCCEEDED (the
    # replayed-bytes-mismatch class — the wrong_gather_part attack
    # shape) has recomputed the honest part bytes bit-exactly, so the
    # optimizer applies the compensating correction honest - served:
    # assigned over the averaged gradients when the conviction beats
    # the apply (bit-exact), added into the next applied gradient
    # vector after the LAMB step fired (bounded-staleness
    # compensation — one step of preconditioner staleness). False
    # keeps the detection-only behavior byte-for-byte.
    repair_convicted: bool = True
    # BYTE bound on the audit worker's retained-round ring (the
    # pending RoundAudits hold signed frames + gathered part copies
    # that late repair/proofs need): oldest-first eviction with a
    # counted eviction, so flagship-size parts cannot balloon host
    # RAM under a slow audit. The round-count bound (8) still applies.
    audit_ring_bytes: int = 256 << 20
    # Audit the two auxiliary averaging phases too — PowerSGD factor
    # rounds ({run}_grads_p/_q) and periodic state averaging
    # ({run}_state) ride the same butterfly and, with this on, the
    # same challenge/transcript/replay machinery (each phase under its
    # own prefix). Convictions there strike + gossip proof-carrying
    # receipts.
    audit_aux_phases: bool = True
    # aux-phase REPAIR: a replayed-bytes-mismatch conviction in a
    # PowerSGD factor round or in state averaging queues its
    # honest - served correction into the factor buffers / the
    # averaged-state application (same pre-step-exact /
    # bounded-staleness split as gradient repair, each phase drained
    # at its own application site). Requires repair_convicted and
    # audit_aux_phases; False keeps factor/state convictions
    # detection + proof.
    repair_aux_phases: bool = True
    # evidence by reference (swarm/audit.EvidencePlane): evidence
    # bundles too large to embed inline in a proof receipt
    # (PROOF_MAX_BYTES) are parked chunked in the issuer's mailbox and
    # the receipt carries a sha256 digest + mailbox descriptor;
    # verifiers fetch under the hard byte/time budgets below
    # (hash-check before any sized allocation), replay, and re-serve
    # verified bundles for failover. Off: over-budget convictions
    # degrade to the capped accusation.
    proof_by_reference: bool = True
    # hard per-bundle byte budget a verifier will fetch (an oversize
    # descriptor claim is rejected before any allocation or I/O); the
    # flagship 502 MB part's bundle (~2x part bytes: transcript
    # frames + gather frames) sizes the default
    proof_fetch_max_bytes: int = 2 << 30
    # hard wall-clock budget for one bundle fetch, covering every
    # retry and failover server — the gossip fold blocks at most this
    # long per by-reference receipt
    proof_fetch_budget_s: float = 30.0
    # per-chunk mailbox-read attempts (exponential backoff between)
    # before a server is abandoned for the next one
    proof_fetch_retries: int = 3
    # Plausible-lead bound on progress-record EPOCH claims (the epoch
    # twin of the sample cap): a peer's claimed epoch may lead this
    # node's local epoch by at most this margin in the aggregate —
    # clamped always, struck (progress-overclaim) only beyond 100x
    # the bound, because honest peers legitimately run several epochs
    # ahead of a slow or partitioned node. 0 disables.
    progress_max_epoch_lead: int = 2
    # Absolute per-sender L2 norm ceiling in the gradient screen,
    # active at ANY sender count — it narrows the <4-sender gap where
    # leave-one-out screening must skip. Below the screen quorum the
    # drop is unstruck (2-peer unattributability preserved). 0
    # disables; size it well above the honest gradient envelope (the
    # bound is model- and scale-specific, hence no finite default).
    screen_abs_norm_ceiling: float = 0.0
    # Deterministic fault injection (swarm/chaos.py, CHAOS.md): a
    # FaultPlan as inline JSON ('{...}') or a path to a JSON file. The
    # plan wraps this peer's DHT transport with seeded message
    # drop/delay/duplication, payload corruption/truncation, bandwidth
    # throttles, timed blackouts (partitions) and crash-at-epoch — the
    # churn-soak harness (scripts/churn_soak.py) drives it. None (the
    # default) leaves the transport untouched; every swarm entry point
    # exposes it as --chaos-plan.
    chaos_plan: Optional[str] = None
    # Flight recorder (dalle_tpu/obs, OBSERVABILITY.md): append this
    # peer's round-lifecycle spans (matchmaking → allreduce phases →
    # apply → state averaging, plus state-transfer streams) as JSONL
    # rows whose trace ids are protocol ids — merge files from
    # several peers with scripts/trace_report.py for the cross-peer
    # round timeline. None (the default) records nothing and the
    # round paths stay byte-identical to the uninstrumented protocol.
    trace_file: Optional[str] = None
    # Byte cap on the in-memory flight ring behind the tracer (the
    # last-N-rounds dump a failure artifact wants).
    trace_ring_kb: int = 256


@dataclass(frozen=True)
class PeerConfig:
    """Peer identity and networking (reference ``arguments.py:81-137``)."""

    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral, like /ip4/0.0.0.0/tcp/0
    initial_peers: Tuple[str, ...] = ()
    client_mode: bool = False          # outbound-only peers (arguments.py:89-92)
    identity_path: Optional[str] = None  # persisted keypair (arguments.py:118-124)
    experiment_prefix: str = "dalle-tpu"
    statistics_expiration: float = 600.0
    # Access-token authorization (swarm/auth.py; reference
    # huggingface_auth.py:46-193): hex Ed25519 public key of the experiment
    # authority (None = open swarm) and the path to this peer's token file
    # issued by ``python -m dalle_tpu.cli.issue_token``.
    auth_authority: Optional[str] = None
    auth_token_path: Optional[str] = None
    # Rendezvous bootstrap (swarm/rendezvous.py) — the offline-exercisable
    # analogue of the reference's IPFS-assisted bootstrap (use_ipfs,
    # arguments.py:100-106): a shared file (NFS / mounted bucket) where
    # routable peers advertise and joiners with an empty initial_peers
    # list find their first contact; peers also advertise in the DHT
    # under {prefix}_rendezvous for list-repair after first contact.
    rendezvous_path: Optional[str] = None


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


@dataclass(frozen=True)
class AuxConfig:
    """Aux (monitor/checkpoint) peer knobs (the JAX package's
    ``AuxConfig``, reference ``arguments.py:140-165``)."""

    refresh_period: float = 10.0
    checkpoint_dir: Optional[str] = None
    upload_interval: Optional[float] = None
    store_checkpoints: bool = True
    # join every gradient round as a weight-0 part owner (swarm/assist.py):
    # reduce/gather capacity for the trainers, no data. Refused with
    # grad_compression="power_sgd", whose wire shapes an aux peer without
    # a model cannot reproduce.
    assist_in_averaging: bool = False


def xl_model_config(**overrides: Any) -> ModelConfig:
    """DALL-E-XL ~3B (the JAX package's ``xl_model_config``): dim 1792,
    depth 64 with the same 4-block weight sharing, 28 heads x 64,
    VQGAN-f16 tokens (16384-code codebook; 512px images -> 32x32 codes).
    The JAX package keeps the plain LayerNorm lowering on this shape
    (``ln_fusion`` off), and so does this copy."""
    base = dict(dim=1792, heads=28, head_dim=64,
                vocab_image=16384, image_grid=32,
                remat_skip_blocks=0, head_chunk=2048, scan_unroll=2)
    base.update(overrides)
    return dataclasses.replace(ModelConfig(), **base)


def long_context_model_config(**overrides: Any) -> ModelConfig:
    """Long-sequence variant (the JAX package's
    ``long_context_model_config``): a 64x64 code grid (4096 image tokens,
    e.g. 512px images under an f8 VQGAN) with full-causal layers, sharded
    over the ``sp`` mesh axis by ring attention when the mesh has one."""
    base = dict(image_grid=64, attn_types=(ATTN_FULL,),
                final_conv_block=False, sequence_parallel=SP_RING)
    base.update(overrides)
    return dataclasses.replace(ModelConfig(), **base)
