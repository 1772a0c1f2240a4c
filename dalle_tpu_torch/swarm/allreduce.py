"""Butterfly all-reduce over the swarm data plane.

Capability parity with hivemind's ``AllReduceRunner`` (the averaging hot
path behind ``hivemind.Optimizer`` — reference SURVEY §2, component 14: "each tensor
is flattened, concatenated, chunked into parts; each group member
reduce-scatters its part, averages, then all-gathers", with per-part
compression chosen at task.py:125-126 and timeout/ban elasticity at
arguments.py:69-74).

Shape of one round, group of N members (sorted by peer id), member i:

  scatter  — split the flattened concat vector into N contiguous parts;
             send my local data for part j to member j (compressed).
  reduce   — collect the other N-1 members' chunks of part i; average with
             per-peer sample weights. A sender that makes no progress for
             ``sender_timeout`` is excluded and its weight dropped
             (hivemind's ban-and-proceed, bounded per missing sender), and
             the phase as a whole yields at 3/4 of the round budget so a
             slow-but-alive sender cannot starve the gather phase either.
  gather   — send the averaged part i to every member; collect the other
             averaged parts (no-progress-bounded like reduce, with the
             timer anchored past the senders' own legitimate stall);
             parts whose owner died fall back to this peer's
             locally-weighted value, so the round always returns.
             The part owner applies the same compress->decompress result
             it broadcasts, so every member ends the round with
             byte-identical averaged values even under lossy codecs.

Every message carries the 16-byte group hash from matchmaking; chunks from
a peer with a divergent group view are dropped (it effectively leaves the
group). Client-mode members (no listener) contribute weight=their samples
but own no part and receive nothing; their data still reaches part owners
because *they* send in the scatter phase.

WEIGHT-0 members are averaging ASSISTANTS (the reference's
``assist_in_averaging`` aux mode, declared-but-stubbed at its
run_aux_peer.py:99-104, here implemented): they own a part — absorbing
reduce/gather bandwidth from the trainers — but contribute no data, so
they skip the scatter phase entirely, receivers never wait on their
(nonexistent) contribution, and they skip collecting the gathered result
they have no model to apply. A trainer that legitimately accumulated 0
samples gets the same treatment: nothing to contribute, nothing waited
on.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import logging
import os
import struct
import threading as _threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.identity import (Identity, PK_LEN, SIG_LEN,
                                      open_frame, signed_frame)
from dalle_tpu_torch.swarm.matchmaking import AveragingGroup

logger = logging.getLogger(__name__)

# group_hash, sender_index, weight, n_elems (this chunk), chunk_idx,
# n_chunks, codec
_HDR = struct.Struct(">16sIdIIIB")
_PREFIX_LEN = _HDR.size + PK_LEN + SIG_LEN

#: elements per wire chunk. Parts larger than this are split into
#: independently-compressed, independently-signed chunks: the daemon
#: rejects frames over 64 MiB (native/swarm/swarm.cc kMaxFrame), and a
#: flagship-scale part (125.6M params / N owners) must also PIPELINE —
#: with one frame per part, encode, wire and decode serialize; with ~16 MB
#: chunks the owner reduces chunk i while chunk i+1 is still in flight.
#: Multiple of the u8 codec's 256-element block so chunk boundaries do not
#: change the quantization math.
CHUNK_ELEMS = 1 << 22


def _pool_workers(cap: int) -> int:
    """Worker count for the codec/send/decode pools, bounded by HOST
    parallelism: the pipelining exists to overlap codec with wire, but
    on a small host extra threads only add scheduler thrash — measured
    on the 1-core bench box, 16 threads/peer REGRESSED the flagship
    N=4 epoch wall 40->66 s vs sizing the pools to the core count."""
    return max(1, min(cap, os.cpu_count() or 1))


def _sign_ctx(prefix: str, epoch: int, phase: str,
              receiver: str = "") -> bytes:
    """Domain-separation context bound into every chunk signature: run,
    epoch, phase, and (for scatter, where each receiver gets a distinct
    part) the intended receiver — so a chunk cannot be replayed into
    another round NOR cross-fed to a different part owner with the honest
    sender's attribution."""
    return f"{prefix}:ar:{epoch}:{phase}:{receiver}".encode()


def _make_frame(identity: Identity, ctx: bytes, group_hash: bytes,
                sender: int, weight: float, n: int, codec: int,
                payload: bytes, chunk: int = 0, n_chunks: int = 1) -> bytes:
    """Signed data-plane chunk. Frames carry sender-supplied weights and
    gradient bytes; unsigned they let any peer that knows the run id
    inject arbitrary contributions. ``chunk``/``n_chunks``
    place this frame inside its part (CHUNK_ELEMS chunking)."""
    hdr = _HDR.pack(group_hash, sender, weight, n, chunk, n_chunks, codec)
    return signed_frame(identity, ctx, hdr, payload)


def _verify_frame(raw: bytes, ctx: bytes, group: AveragingGroup,
                  sender: int) -> bool:
    return open_frame(raw, ctx, _HDR.size,
                      group.members[sender].peer_id) is not None


def _tag(prefix: str, epoch: int, phase: str, receiver: str) -> int:
    digest = hashlib.sha256(
        f"{prefix}:ar:{epoch}:{phase}:{receiver}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _part_slices(total: int, owners: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) per part, like np.array_split bounds."""
    base, rem = divmod(total, owners)
    out, start = [], 0
    for k in range(owners):
        stop = start + base + (1 if k < rem else 0)
        out.append((start, stop))
        start = stop
    return out


def _chunk_slices(n: int, chunk_elems: int) -> List[Tuple[int, int]]:
    """[start, stop) per wire chunk WITHIN a part of ``n`` elements.
    Both sender and receiver derive the identical chunking from the part
    size, so chunk_idx alone places a frame."""
    if n == 0:
        return [(0, 0)]
    return [(lo, min(n, lo + chunk_elems))
            for lo in range(0, n, chunk_elems)]


def _host_f32(t, copy: bool) -> np.ndarray:
    """``t`` (a host array or a tensor) as a host f32 array; ``copy``
    forces a fresh buffer."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to(torch.float32)
        if copy and t.device.type == "cpu":
            t = t.clone()
        return t.cpu().numpy()
    return np.array(t, np.float32, copy=copy)


def flatten_tensors(tensors: Sequence[np.ndarray]) -> np.ndarray:
    return np.concatenate(
        [np.asarray(t, np.float32).reshape(-1) for t in tensors]) \
        if tensors else np.zeros((0,), np.float32)


def unflatten_tensors(flat: np.ndarray,
                      like: Sequence[np.ndarray]) -> List[np.ndarray]:
    out, off = [], 0
    for t in like:
        n = int(np.prod(t.shape)) if t.shape else 1
        # views of the (freshly allocated) flat buffer, not copies:
        # astype() here duplicated the whole 500 MB flagship set per call
        # (measured ~7 s/peer in the payload bench); asarray with the
        # matching dtype is a no-op on an f32 input
        out.append(np.asarray(flat[off:off + n].reshape(t.shape),
                              np.float32))
        off += n
    return out


class _HopMeter:
    """Per-(part, leg) hop aggregation for ``report["phases"]["hops"]``
    plus live per-hop span emission into an obs tracer.

    Spans are emitted per CHUNK as the work completes, under four
    BOUNDED phase ids (``ar_hop_scatter`` / ``ar_hop_reduce`` /
    ``ar_hop_gather`` / ``ar_hop_gather_serve`` — part and chunk index
    ride as span attributes, so the exposition histograms keep bounded
    cardinality); the report rows aggregate first-start -> last-end
    wall, total wire bytes and chunk count per (leg, part). Thread-
    safe by one internal lock: chunks complete on codec/send pool
    workers, on the reduce drain, and on the pipelined gather drain
    thread concurrently.
    """

    def __init__(self, tracer=None, trace: str = "") -> None:
        self._lock = _threading.Lock()
        self._rows: Dict[Tuple[str, int], list] = {}
        self._tracer = tracer
        self._trace = trace

    def note(self, leg: str, part: int, t0: float, dur_s: float,
             nbytes: int, hop: int) -> None:
        tr = self._tracer
        if tr is not None:
            tr.add("swarm", "ar_hop_" + leg, self._trace, t0, dur_s,
                   part=part, hop=hop, bytes=nbytes)
        with self._lock:
            row = self._rows.get((leg, part))
            if row is None:
                self._rows[(leg, part)] = [t0, t0 + dur_s, nbytes, 1]
            else:
                row[0] = min(row[0], t0)
                row[1] = max(row[1], t0 + dur_s)
                row[2] += nbytes
                row[3] += 1

    def rows(self) -> List[dict]:
        with self._lock:
            items = sorted(self._rows.items())
        return [{"part": part, "leg": leg,
                 "wall_s": round(t1 - t0, 6), "bytes": b, "chunks": n}
                for (leg, part), (t0, t1, b, n) in items]


def _scatter_pipeline(pool, produce, part_tasks, depth, on_part):
    """Bounded-depth scatter scheduling (``pipeline_hops``): submit the
    chunk tasks of at most ``depth`` parts at a time; each part's
    completion launches the next, so encode(part i+1) overlaps
    send(part i) without the sequential path's submit-everything burst
    (which queues every chunk of every part up front and lets the pool
    interleave them arbitrarily). Returns ``(done_event, snapshot)``:
    the event is set once every chunk of every part completed, after
    which ``snapshot()`` is stable and complete.

    Completion callbacks run on pool worker threads; the scheduler
    state lives behind one lock, and the futures list must only be
    consumed through ``snapshot()`` after the event is set.
    """
    done = _threading.Event()
    futures: List[concurrent.futures.Future] = []
    lock = _threading.Lock()
    if not part_tasks:
        done.set()
        return done, lambda: []
    state = {"next": 0, "left": sum(len(a) for _k, a in part_tasks)}
    remaining = {k: len(a) for k, a in part_tasks}

    def submit_part(idx: int) -> None:
        _k, args_list = part_tasks[idx]

        def chunk_done(_f, part=_k):
            launch = None
            with lock:
                state["left"] -= 1
                remaining[part] -= 1
                part_complete = remaining[part] == 0
                if part_complete and state["next"] < len(part_tasks):
                    launch = state["next"]
                    state["next"] += 1
                all_done = state["left"] == 0
            if part_complete and on_part is not None:
                on_part("scatter", part)
            if launch is not None:
                submit_part(launch)
            if all_done:
                done.set()

        for a in args_list:
            f = pool.submit(produce, *a)
            with lock:
                futures.append(f)
            f.add_done_callback(chunk_done)

    first = min(max(1, int(depth)), len(part_tasks))
    with lock:
        state["next"] = first
    for i in range(first):
        submit_part(i)

    def snapshot() -> List[concurrent.futures.Future]:
        with lock:
            return list(futures)
    return done, snapshot


class _GatherPipeline:
    """Early gather drain for the pipelined butterfly (pipeline_hops).

    Sequential rounds collect gather frames only after the scatter
    barrier and the EF scatter store; pipelined rounds start THIS
    drain at round start, so other owners' averaged parts decode and
    land in the output buffer while the local reduce/scatter legs are
    still running — the pipelined drain generalized across legs.

    Thread shape: one daemon drain thread recv's the gather tag and
    applies decoded chunks (decodes run on a private pool); the ROUND
    thread polls hop progress and finally joins in ``finish()``. The
    per-part in-flight table ``_parts`` and the completion flags
    ``_complete`` / ``_dead`` are guarded by ``_cv`` on every thread;
    ``finish()`` reads the leftover table, the drain's ban verdicts
    and the progress bit under ``_cv`` BEFORE the join, then hands
    them to the round thread for the ledger/report merge (the drain
    never calls ``ban_peer`` itself — the report sink lists are
    round-thread state). The output buffer and the parts-left mirror
    are the two deliberate lock-free exceptions, annotated below.
    """

    def __init__(self, dht, group, out, slices, part_chunks, pending,
                 sender_to_part, gather_tag, gather_ctx, codec_mod,
                 pin_gather, decrypt, audit, audited_parts, deadline,
                 sender_timeout, gather_baseline, meter, on_part):
        self._dht = dht
        self._group = group
        # gather chunks land in non-overlapping [lo, hi) slices of the
        # round's output buffer, and the round thread reads it only
        # after finish() joins the drain thread; no two threads ever
        # touch the same element concurrently
        # graftlint: handoff=disjoint-slice-writes
        self._out = out
        self._slices = slices
        self._part_chunks = part_chunks
        self._sender_to_part = sender_to_part
        self._tag = gather_tag
        self._ctx = gather_ctx
        self._codec_mod = codec_mod
        self._pin = pin_gather
        self._decrypt = decrypt
        self._audit = audit
        self._audited = audited_parts
        self._deadline = deadline
        self._sender_timeout = sender_timeout
        self._baseline = gather_baseline
        self._meter = meter
        self._on_part = on_part
        self._cv = _threading.Condition()
        # part -> pending chunk ids: the per-part in-flight table,
        # guarded by _cv on BOTH threads (the drain completes chunks
        # and pops finished parts; the round thread reads the
        # leftovers in finish())
        self._parts: Dict[int, set] = pending
        self._n0 = len(pending)
        self._complete = False  # every part landed/abandoned — under _cv
        self._dead = False      # drain thread exited — under _cv
        self._stop = False      # round thread abort request — under _cv
        self._bans: List[Tuple[str, str]] = []  # (peer_id, reason) — _cv
        self._progressed = False  # any chunk/ban landed — under _cv
        # the drain thread alone writes this count of parts still
        # pending; the round thread's hop-progress poll reads it
        # lock-free and tolerates a stale value (at worst one delayed
        # progress report) — correctness stays with the _cv-guarded
        # table above
        # graftlint: handoff=single-writer-mirror
        self._parts_left = len(pending)
        self._thread = _threading.Thread(
            target=self._drain, name="allreduce-gather-drain",
            daemon=True)

    def start(self) -> None:
        self._thread.start()

    def remaining(self) -> int:
        """Parts still pending — lock-free single-writer mirror, for
        hop-progress polling only."""
        return self._parts_left

    def request_stop(self) -> None:
        """Abort the drain early (crash-path cleanup); the normal path
        ends through completion/deadline + ``finish()``."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def finish(self) -> Tuple[Dict[int, set], List[Tuple[str, str]],
                              bool]:
        """Round-thread side: wait out the drain (it exits on
        completion, the round deadline, or the no-progress timeout —
        the same bounds as the sequential collect loop), then hand
        back the leftover pending table, the bans the drain recorded,
        and whether any chunk ever landed (the strike-attribution
        bit)."""
        with self._cv:
            while not (self._complete or self._dead):
                self._cv.wait(timeout=0.5)
            leftover = {k: set(v) for k, v in self._parts.items()}
            bans = list(self._bans)
            progressed = self._progressed
        self._thread.join()
        return leftover, bans, progressed

    # -- drain thread --------------------------------------------------

    def _drain(self) -> None:
        dec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_pool_workers(4))
        try:
            decoding: List[concurrent.futures.Future] = []
            # anchor the no-progress timer past the senders' own
            # legitimate stall window, exactly like the sequential
            # collect loop (owners post their parts late when they
            # waited out a dead peer)
            last_progress = max(time.monotonic(), self._baseline)
            while True:
                with self._cv:
                    if self._stop:
                        break
                    if not self._parts:
                        self._complete = True
                        break
                now = time.monotonic()
                if now >= self._deadline or (
                        not decoding
                        and now - last_progress >= self._sender_timeout):
                    break  # dead owners: their parts keep local values
                still: List[concurrent.futures.Future] = []
                for f in decoding:
                    if not f.done():
                        still.append(f)
                        continue
                    if self._apply(f.result()):
                        last_progress = time.monotonic()
                decoding = still
                raw = self._dht.recv(self._tag, timeout=min(
                    0.2, max(0.05, self._deadline - now)))
                if raw is not None:
                    decoding.append(dec_pool.submit(self._decode, raw))
            # salvage decodes that already completed — without waiting
            # (the deadline is a promise to the caller, same semantics
            # as the sequential drain's no-wait salvage)
            for f in decoding:
                if f.done():
                    self._apply(f.result())
        finally:
            dec_pool.shutdown(wait=False)
            with self._cv:
                self._complete = self._complete or not self._parts
                self._dead = True
                self._cv.notify_all()

    def _decode(self, raw_enc: bytes):
        t_d = time.monotonic()
        raw = self._decrypt(raw_enc)
        if raw is None:
            return None
        head = _peek(raw, self._group)
        if head is None:
            return None
        part = self._sender_to_part.get(head[0])
        if part is None:
            return None
        with self._cv:
            live = part in self._parts
        if not live:
            return None  # completed part: skip the multi-MB decode
        parsed = _parse(raw, self._group, self._part_chunks[part],
                        self._ctx, self._codec_mod, pinned=self._pin)
        if parsed is None:
            return None
        return part, parsed, _HDR.unpack_from(raw)[6], raw, t_d

    def _apply(self, res) -> bool:
        if res is None:
            return False
        part, (status, sender, _w, ci, data), gcodec, raw, t_d = res
        if status == "bad":
            # the part OWNER is serving damaged bytes: stop waiting on
            # it — the part keeps this peer's local values (dead-owner
            # elasticity), the ban is handed to the round thread
            dropped = False
            with self._cv:
                if part in self._parts:
                    self._parts.pop(part, None)
                    self._bans.append(
                        (self._group.members[sender].peer_id,
                         "corrupt-chunk"))
                    self._progressed = True
                    dropped = True
                    self._cv.notify_all()
            if not dropped:
                return False
            self._parts_left -= 1
            logger.warning(
                "allreduce[pipelined]: part %d owner %s served a "
                "corrupt/truncated chunk — keeping local values for "
                "that part", part,
                self._group.members[sender].peer_id[:16])
            return True
        plo, _phi = self._slices[part]
        pclo, pchi = self._part_chunks[part][ci]
        done_part = False
        with self._cv:
            pend_set = self._parts.get(part)
            if pend_set is None or ci not in pend_set:
                return False  # duplicate chunk or completed part
            pend_set.discard(ci)
            self._progressed = True
            if not pend_set:
                self._parts.pop(part, None)
                done_part = True
                self._cv.notify_all()
        # lock-free by design: chunks write disjoint slices (see the
        # _out handoff note above)
        self._out[plo + pclo:plo + pchi] = data
        if self._audit is not None and part in self._audited:
            self._audit.note_gather_codec(part, ci, gcodec)
            self._audit.note_gather_frame(part, ci, raw)
        if self._meter is not None:
            self._meter.note("gather", part, t_d,
                             time.monotonic() - t_d, len(raw), ci)
        if done_part:
            self._parts_left -= 1
            if self._audit is not None and part in self._audited:
                # retain the exact bytes this member will live with —
                # the replay's comparison target (the final chunk's
                # write above happens-before this read: same thread)
                alo, ahi = self._slices[part]
                self._audit.note_gathered(part, self._out[alo:ahi])
            if self._on_part is not None:
                self._on_part("gather", part)
        return True


def run_allreduce(dht: DHT, group: AveragingGroup, prefix: str, epoch: int,
                  tensors: Sequence[np.ndarray], weight: float,
                  allreduce_timeout: float = 60.0,
                  codec: Optional[int] = None,
                  adaptive_threshold: int =
                  compression.SIZE_ADAPTIVE_THRESHOLD,
                  sender_timeout: Optional[float] = None,
                  report: Optional[dict] = None,
                  chunk_elems: int = CHUNK_ELEMS,
                  codec_backend: str = compression.HOST_BACKEND,
                  ledger=None,
                  screen=None,
                  max_peer_weight: Optional[float] = None,
                  audit=None,
                  gather_codec: Optional[int] = None,
                  ef_scatter=None,
                  ef_gather=None,
                  pin_codec: bool = False,
                  pipeline_hops: bool = False,
                  pipeline_depth: int = 2,
                  tracer=None,
                  trace: str = "",
                  progress=None
                  ) -> List[np.ndarray]:
    """Weighted-average ``tensors`` across the group; returns new arrays.

    ``report`` (optional dict) receives ``{"complete": bool}``: True iff
    every expected reduce chunk and every gather part arrived — i.e. this
    peer's result reflects the full roster. PowerSGD needs this to detect
    rounds whose averaged bytes may diverge across survivors. It also
    receives ``corrupt_senders``/``timeout_senders``: peer ids whose
    contribution was dropped for affirmatively malformed chunks (bad
    geometry / codec under a VALID signature — authenticated garbage,
    detected immediately, no timeout burned) or for never delivering a
    usable contribution (dead, slow, or their traffic was damaged in
    flight — unattributable, so it is never blamed as corruption; see
    ``_parse``). Either way
    the offender's weight is renormalized out (``total_w`` only ever
    counts fully-applied senders), so one bad peer degrades the round
    instead of poisoning it.

    ``ledger`` (optional :class:`~dalle_tpu_torch.swarm.health
    .PeerHealthLedger`) receives a strike per banned peer, so
    matchmaking can down-rank repeat offenders in later epochs.

    ``weight`` is this peer's contribution weight (its accumulated sample
    count, hivemind's per-peer weighting). ``codec=None`` selects
    SizeAdaptive per part with ``adaptive_threshold``; receivers decode
    whatever codec the wire header names. ``sender_timeout`` bounds how
    long the reduce phase waits without receiving any new chunk before
    banning the missing senders (default: a quarter of the round budget),
    so one dead peer cannot burn the whole round's budget.

    When the group carries a ``group_key`` (matchmaking with
    ``encrypt=True``), every chunk on the wire — pushes and mailbox posts
    alike — is AEAD-wrapped with it (crypto.py), so gradients are opaque to
    anyone outside the round's membership.

    ``screen`` (optional :class:`~dalle_tpu_torch.swarm.screening
    .GradientScreen`) enables Byzantine content screening on this
    peer's part: when the weighted-sender roster is large enough
    (``ScreenPolicy.min_senders``), fully-delivered contributions are
    BUFFERED through the reduce phase instead of streamed into the
    accumulator, then norm/cosine-screened against the leave-one-out
    aggregate; outliers are hard-DROPPED (never reweighted) with the
    same weight renormalization as a corrupt ban, an attributable
    ``screen-outlier`` ledger strike, and ``report["screened_senders"]``
    naming them. Costs one extra part-sized buffer per live sender
    while the round is in flight. Below ``min_senders`` (and always
    when ``screen`` is None) the original streaming accumulation runs
    unmodified — small swarms keep the pre-screening semantics
    byte-for-byte, because with 2-3 senders a leave-one-out "consensus"
    is one peer's word against another's. A round whose ROSTER cleared
    the quorum but whose DELIVERIES did not (churn, or a roster split
    while offenders are penalized at different peers) is stricter
    still: the part is WITHHELD (dead-owner elasticity — members keep
    local values) rather than averaged unscreened, because an
    under-delivered round is exactly the window a colluding minority
    could otherwise slip tampered data through.

    ``max_peer_weight`` (optional) clamps the sender-supplied frame
    weight: a signed frame claiming a weight outside ``[0,
    max_peer_weight]`` (or a non-finite one) has its sender's whole
    contribution dropped with an attributable ``weight-overclaim``
    strike — without it, one frame claiming ``weight=1e9`` drowns every
    honest contribution without any *value* screen tripping. The
    caller's own ``weight`` is clamped to the same bound (a buggy local
    accumulator must not make this peer the over-claimer).

    When the transport is chaos-wrapped with an active ``byzantine``
    plan (swarm/chaos.py), the wrapper's ``tamper_contribution`` hook
    rewrites this peer's OWN tensors/claimed weight before flatten and
    signing — attacks are injected above the signature so the wire
    carries validly-signed wrong data, which is exactly what the screen
    exists to catch.

    ``audit`` (optional :class:`~dalle_tpu.swarm.audit.RoundAudit`)
    arms the verified-aggregation layer for this round: the
    deterministic challenge (derived from ``prefix``/``epoch`` — every
    member computes the same set) names audited parts; a challenged
    part OWNER retains the signed frames it applied, its drop-set
    (with the offending frame as evidence for provable reasons) and
    the accumulation order, then signs and posts the transcript into
    its mailbox before serving the part; every member retains the
    gathered bytes of audited parts plus which owners transport-acked
    its own scatter, so the post-round audit (audit.audit_round) can
    replay and bit-compare. Retention copies bytes and never touches
    the accumulation — ``audit=None`` rounds are byte-identical to the
    pre-audit protocol, and audit-ON honest rounds produce identical
    averages (pinned by test).

    ``codec_backend="device"`` runs the u8/u4/f16 wire codec as jitted
    device programs (swarm/device_codec.py): ``tensors`` may be jax
    device arrays (flattened on device, no per-leaf host pull), each
    scatter/gather part is quantized in ONE device call with only the
    packed code/scale buffers crossing to the host, and receive-side
    decodes dispatch to the device from the same decode pools — the
    pipelined drain structure is identical to the host backend, and so
    are the wire bytes (byte-compatible codecs, mixed-backend groups are
    fine). With the device backend, an unscreened part owner also runs
    the FUSED accumulate: each completed sender's validated wire
    payloads feed a jitted donated accumulate (codes+scales in, the f32
    part accumulator in/out, bit-equal to the host multiply-then-add —
    device_codec.fused_accumulate), so the reduce hot path never
    touches host f32 numpy; screening keeps the host-segment path (its
    statistics need the decoded segments on the host).

    ``gather_codec`` (optional) selects a DIFFERENT codec for the
    gather leg than the scatter leg (None = same dispatch as
    ``codec``) — the two-stage compression split of CollabConfig
    .wire_bits_reduce/wire_bits_gather. ``pin_codec`` (set by the
    wire_bits knobs, and implied by either EF leg or an explicit
    ``gather_codec``) additionally ENFORCES the round's codecs:
    receivers reject validly-signed frames naming any other codec as
    authenticated garbage ("codec flapping" — error-feedback residual
    scales are only meaningful against one stable quantizer), banning
    the sender exactly like bad geometry. Enforcement must be
    config-homogeneous across the run (the audit replay re-applies
    the recorded pin), so no peer-LOCAL condition ever implies it:
    unpinned rounds keep the accept-what-the-header-names
    semantics byte-for-byte — a round may legitimately mix per-caller
    codecs (an averaging assistant serves its part with ITS config's
    codec, whatever the trainers pass), and the fused device path
    below falls back to host decode for such senders rather than
    banning them.

    ``ef_scatter`` / ``ef_gather`` (optional
    :class:`~dalle_tpu_torch.swarm.error_feedback.ErrorFeedback`) arm the
    two error-feedback legs: the sender adds its persistent residual
    to the flattened gradients before the per-part encode and stores
    the new quantization error after the scatter (device-resident,
    donated, under the device backend); the part owner compensates its
    averaged part with its own residual before the gather re-quantize
    (the DynamiQ second stage). Both require a pinned u8/u4 codec on
    their leg and block-aligned ``chunk_elems``. The gather carry-in
    is SUSPENDED on audit-challenged parts so the audit replay recomputes
    the served (quantized) part bit-exactly — see swarm/error_feedback
    .py's determinism contract; the fresh error is still stored. With
    both EF legs None, rounds are byte-identical to the unpinned protocol.

    ``pipeline_hops`` rebuilds the round's INSIDE as a per-part
    pipeline (CollabConfig.pipeline_hops): a background drain collects
    and applies gather frames from round start (other owners serve
    their parts as soon as their reduces finish — waiting for the
    local scatter barrier to even LOOK at them is pure exposed wall);
    this owner's part is served the moment its reduce completes,
    before the scatter barrier and the EF scatter store; and scatter
    parts are encoded/sent with at most ``pipeline_depth`` parts in
    flight, so encode(part i+1) overlaps send(part i). OFF keeps the
    sequential protocol byte-identical; ON changes only wall-clock
    placement — the wire bytes, averaged values, EF residuals and
    audit transcripts are bit-exact either way because every protocol
    ordering that feeds bytes (audit-post-before-serve, EF compensate
    -> encode -> store, per-part chunk dedup, recorded accumulation
    order) is preserved, only moved earlier. Client-mode members and
    weight-0 assistants always run the sequential path (they collect
    via mailbox pulls / not at all).

    ``tracer`` / ``trace`` (optional obs.trace.Tracer + protocol trace
    id) emit live per-hop spans — phase ids ``ar_hop_scatter`` /
    ``ar_hop_reduce`` / ``ar_hop_gather`` / ``ar_hop_gather_serve``
    with (part, hop, bytes) attributes — from inside the round, in
    BOTH modes, so cross-peer timelines can prove (not infer) hop/
    compute overlap. When either a tracer or a ``report`` is given,
    ``report["phases"]["hops"]`` also receives aggregated per-(leg,
    part) rows ``{part, leg, wall_s, bytes, chunks}``.

    ``progress`` (optional callable ``(leg, part)``) is invoked on
    part-granular completion events — scatter part fully sent
    (pipelined mode only: the sequential burst submit has no per-part
    completion), own part reduced, a gathered part fully applied — so
    the caller's round thread can expose hop-granular progress while
    parts are still in flight. It is called from pool/drain threads
    and must be thread-safe; exceptions are swallowed (a progress sink
    must never kill the wire round).
    """
    from dalle_tpu_torch.swarm.crypto import maybe_decrypt, maybe_encrypt
    gkey = group.group_key
    codec_mod = compression.backend_module(codec_backend)
    use_device = codec_mod is not compression
    device_codec = codec_mod if use_device else None
    if max_peer_weight is not None and not (0.0 <= weight
                                            <= max_peer_weight):
        # self-clamp: a buggy caller claiming an absurd local weight
        # would earn this peer weight-overclaim strikes at every honest
        # part owner — clamp here and say so
        logger.warning(
            "allreduce: local weight %r outside [0, %r] — clamped "
            "(receivers drop over-claiming senders outright)",
            weight, max_peer_weight)
        weight = min(max(weight, 0.0), max_peer_weight) \
            if np.isfinite(weight) else max_peer_weight
    # Byzantine injection seam (swarm/chaos.py), AFTER the self-clamp:
    # an active byzantine op rewrites this peer's own contribution
    # before flatten and signing, so the wire carries validly-signed
    # wrong data. frame_weight is the weight claimed on scatter frames
    # — a weight_inflate op's claim deliberately bypasses the clamp
    # (it exists to exercise the receivers' check); the local
    # accumulate keeps the honest ``weight`` either way.
    tamper = getattr(dht, "tamper_contribution", None)
    frame_weight = weight
    if tamper is not None:
        tensors, frame_weight = tamper(epoch, tensors, weight,
                                       prefix=prefix)
    # wall time per protocol phase (floats), plus — when hop metering
    # is armed — the per-(leg, part) "hops" row list
    phases: Dict[str, object] = {}
    corrupt_senders: List[str] = []
    timeout_senders: List[str] = []
    screened_senders: List[str] = []
    overweight_senders: List[str] = []
    struck: set = set()  # (peer_id, reason) pairs already sent to the ledger
    if report is not None:
        report["complete"] = True  # falsified below on any missing chunk
        report["phases"] = phases  # wall time per protocol phase
        report["corrupt_senders"] = corrupt_senders
        report["timeout_senders"] = timeout_senders
        report["screened_senders"] = screened_senders
        report["overweight_senders"] = overweight_senders
    # per-hop observability: armed by either sink (the tracer gets live
    # spans, the report gets aggregated rows); None keeps the hot paths
    # free of even the timestamp reads
    meter = (_HopMeter(tracer, trace)
             if (tracer is not None or report is not None) else None)

    def note_part(leg: str, part: int) -> None:
        if progress is None:
            return
        try:
            progress(leg, part)
        except Exception:  # noqa: BLE001 — a progress sink must never
            # kill the wire round
            logger.debug("allreduce: progress hook failed",
                         exc_info=True)

    def ban_peer(peer_id: str, reason: str, strike: bool = True) -> None:
        """Cross-round memory of an in-round ban: one ledger strike per
        (peer, reason) per round, so matchmaking can down-rank repeat
        offenders (health.PeerHealthLedger). ``strike=False`` records
        the ban in the report but withholds the ledger strike — used
        when the failure is unattributable (a round where NOTHING
        arrived from several peers points at the local node, and
        striking every honest sender would self-isolate it)."""
        sink = {"corrupt-chunk": corrupt_senders,
                "screen-outlier": screened_senders,
                "weight-overclaim": overweight_senders} \
            .get(reason, timeout_senders)
        if peer_id not in sink:
            sink.append(peer_id)
        # the report sinks dedup per (peer, phase-family) but strikes
        # dedup per (peer, reason): reduce- and gather-timeout share the
        # timeout_senders sink, and a peer that both withheld its
        # contribution AND never served its part has earned both strikes
        if strike and ledger is not None and (peer_id, reason) not in struck:
            struck.add((peer_id, reason))
            ledger.strike(peer_id, reason)
    owners = [m for m in group.members if m.addr]  # part owners
    total_elems = sum(int(np.prod(np.shape(t))) if np.shape(t) else 1
                      for t in tensors)
    if group.size <= 1 or not owners or total_elems == 0:
        # degenerate round: nothing crosses the wire — skip the flatten
        # (in device mode that would be a jitted concat plus a full
        # payload device-to-host copy, for nothing). EF residuals stay
        # untouched: nothing was quantized.
        return [_host_f32(t, copy=True) for t in tensors]
    quant_codecs = (compression.UNIFORM8BIT, compression.UNIFORM4BIT)
    if ef_scatter is not None and (
            codec not in quant_codecs
            or chunk_elems % compression.codec_block(codec)):
        raise ValueError(
            "ef_scatter needs a pinned u8/u4 scatter codec and "
            "block-aligned chunk_elems (residual scales are only "
            "meaningful against one stable quantizer)")
    eff_gather = gather_codec if gather_codec is not None else codec
    if ef_gather is not None and (
            eff_gather not in quant_codecs
            or chunk_elems % compression.codec_block(eff_gather)):
        raise ValueError(
            "ef_gather needs a pinned u8/u4 gather codec and "
            "block-aligned chunk_elems")
    # Pinned-codec enforcement (None = the accept-what-the-header-
    # names acceptance): on a pinned leg, receivers reject frames
    # naming any other codec as authenticated garbage — codec flapping
    # breaks EF residual scales and has no honest cause when the run
    # pins the codec. Enforcement is strictly OPT-IN (pin_codec / EF /
    # an explicit gather_codec) and must be config-homogeneous across
    # the run: the audit replay re-applies the recorded pin, so a
    # peer-LOCAL condition (like the device backend's fused path) must
    # never imply it — the fused path instead falls back to per-sender
    # host decode for frames in any other codec.
    enforce = (pin_codec or gather_codec is not None
               or ef_scatter is not None or ef_gather is not None)
    pin_scatter = codec if enforce else None
    pin_gather = eff_gather if enforce else None
    t_flat = time.monotonic()
    if use_device:
        # flatten on device; the one host copy below feeds the reduce
        # accumulate and the gather fallback template (it must be
        # writable — device pulls surface as read-only views). The EF
        # compensate runs on device BEFORE that copy: host and device
        # views of the compensated vector are the same bytes.
        flat_dev = device_codec.flatten_device(tensors)
        if ef_scatter is not None and weight > 0:
            flat_dev = ef_scatter.compensate(flat_dev)
        flat = device_codec.to_host(flat_dev)
    else:
        flat_dev = None
        flat = flatten_tensors(tensors)
        if ef_scatter is not None and weight > 0:
            flat = ef_scatter.compensate(flat)

    me = group.members[group.my_index]
    owner_index = {m.peer_id: k for k, m in enumerate(owners)}
    my_part = owner_index.get(me.peer_id)  # None in client mode
    slices = _part_slices(flat.size, len(owners))
    # verified aggregation (swarm/audit.py): the deterministic
    # challenge is known at round start, so retention costs nothing on
    # unchallenged parts; retain_mine arms the owner-side transcript
    # hooks for this peer's own part only
    if audit is not None:
        audit.begin(group, owners, my_part,
                    [hi_ - lo_ for lo_, hi_ in slices], chunk_elems,
                    codec, adaptive_threshold, max_peer_weight, screen,
                    gather_codec=gather_codec, pinned=pin_scatter)
    audited_parts = audit.audited if audit is not None else frozenset()
    retain_mine = audit is not None and audit.audits_mine
    t0 = time.monotonic()
    phases["flatten_s"] = round(t0 - t_flat, 3)
    deadline = t0 + allreduce_timeout
    if sender_timeout is None:
        sender_timeout = max(1.0, 0.25 * allreduce_timeout)
    gather_ctx = _sign_ctx(prefix, epoch, "gather")
    # The reduce phase may use at most 3/4 of the budget even while chunks
    # are still trickling in, so a slow-but-alive sender cannot starve the
    # gather phase into returning divergent, unaveraged parts (a dead
    # sender is banned earlier by the no-progress sender_timeout).
    reduce_deadline = t0 + 0.75 * allreduce_timeout
    # Gather no-progress timers start no earlier than this: senders that
    # stalled on a dead peer legitimately post their parts only after their
    # own sender_timeout fires, so a receiver counting from gather entry
    # would give up the moment the parts appear.
    gather_baseline = reduce_deadline

    def part_codec(n: int) -> int:
        if codec is None:
            return compression.adaptive_codec(n, adaptive_threshold)
        return codec

    def gather_part_codec(n: int) -> int:
        if gather_codec is not None:
            return gather_codec
        return part_codec(n)

    fused_capable = (use_device and screen is None
                     and codec in quant_codecs
                     and chunk_elems % compression.codec_block(codec)
                     == 0)

    def send_raw(addr: str, tag: int, wire_body: bytes) -> bool:
        remaining = max(0.1, deadline - time.monotonic())
        return dht.send(addr, tag, wire_body, timeout=remaining)

    def fetch_chunk(addr: str, tag: int, timeout: float) -> Optional[bytes]:
        return maybe_decrypt(gkey, dht.fetch(addr, tag, timeout=timeout))

    # --- pipelined mode (pipeline_hops): arm the early gather drain
    # and the dedicated serve pools before any leg starts. The output
    # buffer must exist NOW (the drain applies other owners' parts into
    # it from round start); ``flat`` is final at this point — nothing
    # below mutates it — so the copy is byte-identical to the
    # sequential path's later one. Client-mode members (mailbox pulls)
    # and weight-0 assistants (no collection at all) keep the
    # sequential path. On a crash mid-round the drain self-terminates
    # at the deadline (daemon thread) and the pools' idle workers exit
    # when the executor is collected — cleanup needs no global
    # try/finally.
    pipe = None
    serve_pool = serve_codec_pool = None
    out: Optional[np.ndarray] = None
    if (pipeline_hops and weight > 0 and bool(me.addr)
            and len(owners) > 1):
        out = flat.copy()
        part_chunks_all = {k: _chunk_slices(hi_ - lo_, chunk_elems)
                           for k, (lo_, hi_) in enumerate(slices)}
        pend0 = {owner_index[m.peer_id]: set(range(len(
            part_chunks_all[owner_index[m.peer_id]])))
            for m in owners if m.peer_id != me.peer_id}
        sender_to_part_all = {
            group.members.index(m): owner_index[m.peer_id]
            for m in owners}
        serve_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_pool_workers(8))
        serve_codec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_pool_workers(4))
        pipe = _GatherPipeline(
            dht=dht, group=group, out=out, slices=slices,
            part_chunks=part_chunks_all, pending=pend0,
            sender_to_part=sender_to_part_all,
            gather_tag=_tag(prefix, epoch, "gather", me.peer_id),
            gather_ctx=gather_ctx, codec_mod=codec_mod,
            pin_gather=pin_gather,
            decrypt=lambda b: maybe_decrypt(gkey, b),
            audit=audit, audited_parts=audited_parts,
            deadline=deadline, sender_timeout=sender_timeout,
            gather_baseline=gather_baseline, meter=meter,
            on_part=note_part)
        pipe.start()

    # Device-codec parts: the whole part is quantized in ONE device call,
    # shared lazily by its chunk producers (the first pool task to need
    # it pays the dispatch, so part encodes overlap the wire exactly like
    # per-chunk host encodes do). Only valid when chunk boundaries land
    # on the codec's quant blocks — CHUNK_ELEMS is a multiple of both
    # the u8 and u4 blocks; a caller with an unaligned chunk_elems falls
    # back to per-chunk device encodes, which produce the same bytes at
    # more dispatches.
    def _enc_codec_for(pinned: Optional[int]) -> int:
        # the whole-part encode codec for a leg: its pin when that is a
        # block codec, else u8 (what SizeAdaptive picks at part scale)
        return pinned if pinned in (compression.UNIFORM8BIT,
                                    compression.UNIFORM4BIT) \
            else compression.UNIFORM8BIT

    def _part_aligned(enc_codec: int) -> bool:
        return chunk_elems % compression.codec_block(enc_codec) == 0

    def lazy_part_enc(src, lo: int, hi: int, enc_codec: int):
        holder: dict = {}
        lock = _threading.Lock()

        def get():
            with lock:
                if "enc" not in holder:
                    holder["enc"] = device_codec.encode_part(
                        src, lo, hi, enc_codec)
                return holder["enc"]
        return get

    # --- scatter: my data for part k -> owner k, chunk by chunk ---------
    # weight-0 members (averaging assistants / 0-sample trainers) have
    # nothing to contribute: they send no scatter chunks.
    # The WHOLE per-chunk production — compress, sign, encrypt, send —
    # runs as one pool task per chunk, so the codec work for chunk i+1
    # overlaps the wire of chunk i AND the receive thread enters the
    # reduce phase immediately instead of after serializing every encode
    # (encode-serial rounds spent half their wall on
    # the codec). chunk_idx places each frame; order is irrelevant.
    scatter_enc_codec = _enc_codec_for(codec)

    def produce_scatter(addr: str, tag: int, ctx: bytes, part: int,
                        lo: int, clo: int, chi: int, ci: int,
                        n_chunks: int, enc_get
                        ) -> Tuple[str, int, bytes, bool]:
        t_c0 = time.monotonic()
        nelem = chi - clo
        c = part_codec(nelem)
        if enc_get is not None and c == scatter_enc_codec:
            payload = device_codec.part_payload(enc_get(), clo, chi)
        else:
            src = flat_dev if use_device else flat
            payload = codec_mod.compress(src[lo + clo:lo + chi], c)
        body = _make_frame(dht.identity, ctx, group.group_hash,
                           group.my_index, frame_weight, nelem, c,
                           payload, chunk=ci, n_chunks=n_chunks)
        wire_body = maybe_encrypt(gkey, body)
        ok = send_raw(addr, tag, wire_body)
        if meter is not None:
            meter.note("scatter", part, t_c0,
                       time.monotonic() - t_c0, len(wire_body), ci)
        return addr, tag, wire_body, ok

    # --- the serve seam, shared by both modes ---------------------------
    # pre_serve(): transcript post -> EF second stage -> chaos tamper
    # seam, in THAT order (the ordering is part of the audit contract).
    # start_serve(): compress + local-apply + sign + encrypt this
    # owner's averaged part per chunk and fan the sends out. The
    # sequential path calls both between the scatter barrier and the
    # gather collect (the historical protocol point); the pipelined
    # path calls both the moment the reduce finishes, so the serve
    # overlaps the scatter barrier and the EF scatter store — same
    # bytes, earlier wall-clock.
    ef_gather_active = False
    send_lock = _threading.Lock()
    g_futures: List[concurrent.futures.Future] = []
    g_sends: List[Tuple[str, int, bytes]] = []
    g_produce: List[concurrent.futures.Future] = []

    def pre_serve() -> None:
        nonlocal averaged_mine, ef_gather_active
        # serve the audit transcript BEFORE the part: any member that
        # completes the gather can immediately fetch the honest record
        # the owner signed (the post is mailbox-local, no round-trips)
        if retain_mine and averaged_mine is not None:
            t_post = time.monotonic()
            try:
                if not audit.post_transcript(dht):
                    # a False post (native mailbox rc != 0, chaos
                    # fault) is the same outcome as the raise below:
                    # members that gathered this part will strike
                    # audit-timeout — the owner deserves a local
                    # diagnostic either way
                    logger.warning(
                        "allreduce: audit transcript post rejected by "
                        "the mailbox — part %d's challenge will go "
                        "unserved", my_part)
            except Exception:  # noqa: BLE001 - an unserved transcript
                # only costs THIS owner audit-timeout strikes; the
                # round must not die for it
                logger.warning("allreduce: audit transcript post "
                               "failed", exc_info=True)
            phases["audit_post_s"] = round(time.monotonic() - t_post, 3)
        # EF second stage (DynamiQ): the owner carries its own residual
        # into the gather re-quantize — SUSPENDED on audit-challenged
        # parts, so the replay's codec round-trip of the replayed
        # average stays bit-exact without any private residual entering
        # a transcript (a buffer a hostile owner could fabricate to
        # "explain" a wrong part; the deterministic challenge means
        # owner and auditors agree on the suspension at round start).
        # The fresh error is still stored after the serve.
        ef_gather_active = (ef_gather is not None and my_part is not None
                            and averaged_mine is not None and weight > 0)
        if ef_gather_active and my_part not in audited_parts:
            glo_, ghi_ = slices[my_part]
            averaged_mine = ef_gather.compensate_slice(
                averaged_mine, glo_, ghi_, flat.size)
        # hostile-owner chaos seam (swarm/chaos.py wrong_gather_part):
        # an active op rewrites the part THIS owner is about to serve —
        # after the honest average and after the transcript, which is
        # exactly the attack shape the replay audit convicts
        tamper_part = getattr(dht, "tamper_gather_part", None)
        if (tamper_part is not None and my_part is not None
                and averaged_mine is not None):
            averaged_mine = tamper_part(epoch, my_part, averaged_mine,
                                        prefix=prefix)

    def start_serve(g_pool, g_codec_pool) -> None:
        # averaged_mine is None only for a member that received no
        # usable contributions (or a screen-withheld round): withhold
        # the part — receivers fall back to local values
        if my_part is None or averaged_mine is None:
            return
        slo, _shi = slices[my_part]
        serve_chunks = _chunk_slices(averaged_mine.size, chunk_elems)
        have_clients = any(not m.addr and m.weight > 0
                           for m in group.members)
        # weight-0 assistants never drain their gather tag (they skip
        # collection) — pushing to them would pile full-size parts
        # into their native recv queue every round, unbounded
        push_to = [m for m in group.members
                   if m.peer_id != me.peer_id and m.addr
                   and m.weight > 0]

        # device backend: the averaged part is quantized in one device
        # call shared by its chunk producers, and the local apply reads
        # the device dequantize of the same buffers
        gather_enc_codec = _enc_codec_for(eff_gather)
        gather_enc_get = (lazy_part_enc(averaged_mine, 0,
                                        averaged_mine.size,
                                        gather_enc_codec)
                          if use_device
                          and _part_aligned(gather_enc_codec)
                          else None)

        def produce_gather(ci: int, clo: int, chi: int) -> None:
            # compress + local-apply + sign + encrypt on a codec
            # worker; the sends fan out through the send pool, so the
            # codec of chunk i+1 overlaps the wire of chunk i AND the
            # collection (drain thread / receive loop) runs meanwhile
            t_c0 = time.monotonic()
            nelem = chi - clo
            c = gather_part_codec(nelem)
            # apply the same lossy wire bytes locally so all members
            # end the round with byte-identical values for this part
            # (chunks write disjoint slices of out: thread-safe)
            if gather_enc_get is not None \
                    and c == gather_enc_codec:
                enc = gather_enc_get()
                wire = device_codec.part_payload(enc, clo, chi)
                out[slo + clo:slo + chi] = device_codec.part_decode(
                    enc, clo, chi)
            else:
                piece = averaged_mine[clo:chi]
                wire = codec_mod.compress(piece, c)
                out[slo + clo:slo + chi] = codec_mod.decompress(
                    wire, c, nelem)
            body = _make_frame(dht.identity, gather_ctx,
                               group.group_hash, group.my_index, 1.0,
                               nelem, c, wire,
                               chunk=ci, n_chunks=len(serve_chunks))
            # the gather body is receiver-independent: encrypt ONCE
            # per chunk, not once per recipient (the scatter path must
            # stay per-receiver, its bodies differ)
            wire_body = maybe_encrypt(gkey, body)
            with send_lock:
                for m in push_to:
                    gtag = _tag(prefix, epoch, "gather", m.peer_id)
                    g_sends.append((m.addr, gtag, wire_body))
                    g_futures.append(g_pool.submit(
                        send_raw, m.addr, gtag, wire_body))
            if have_clients:
                # client-mode members can't receive pushes: publish
                # each chunk of the averaged part in this owner's
                # mailbox for them to pull (per-chunk tags)
                dht.post(_tag(prefix, epoch, f"mailbox{ci}",
                              me.peer_id),
                         wire_body,
                         expiration_time=time.time()
                         + 2 * allreduce_timeout)
            if meter is not None:
                meter.note("gather_serve", my_part, t_c0,
                           time.monotonic() - t_c0, len(wire_body), ci)

        for ci, (clo, chi) in enumerate(serve_chunks):
            g_produce.append(
                g_codec_pool.submit(produce_gather, ci, clo, chi))

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=_pool_workers(8)) as pool, \
            concurrent.futures.ThreadPoolExecutor(
                max_workers=_pool_workers(4)) as dec_pool:
        futures = []
        scatter_to = list(enumerate(owners)) if weight > 0 else []
        scatter_encs: Dict[int, object] = {}  # part -> lazy EncodedPart
        part_tasks: List[Tuple[int, List[tuple]]] = []
        for k, owner in scatter_to:
            if k == my_part:
                continue
            lo, hi = slices[k]
            chunks = _chunk_slices(hi - lo, chunk_elems)
            ctx = _sign_ctx(prefix, epoch, "scatter", owner.peer_id)
            tag = _tag(prefix, epoch, "scatter", owner.peer_id)
            enc_get = (lazy_part_enc(flat_dev, lo, hi, scatter_enc_codec)
                       if use_device and _part_aligned(scatter_enc_codec)
                       else None)
            scatter_encs[k] = enc_get
            part_tasks.append((k, [
                (owner.addr, tag, ctx, k, lo, clo, chi, ci, len(chunks),
                 enc_get)
                for ci, (clo, chi) in enumerate(chunks)]))
        scatter_sched = None
        if pipe is not None:
            # bounded-depth per-part scheduling: encode(part i+1)
            # overlaps send(part i), at most pipeline_depth parts in
            # the encode/send window
            scatter_sched = _scatter_pipeline(
                pool, produce_scatter, part_tasks, pipeline_depth,
                note_part)
        else:
            # sequential burst submit (the historical path): every
            # chunk of every part queued up front, pool order decides
            for _k, args_list in part_tasks:
                for a in args_list:
                    futures.append(pool.submit(produce_scatter, *a))
        t_built = time.monotonic()
        phases["scatter_build_s"] = round(t_built - t0, 3)

        # --- reduce my part while scatter encode+sends run --------------
        averaged_mine: Optional[np.ndarray] = None
        if my_part is not None:
            lo, hi = slices[my_part]
            mine = flat[lo:hi]
            n_mine = hi - lo
            my_chunks = _chunk_slices(n_mine, chunk_elems)
            # weight-0 members contribute nothing (and send nothing):
            # never wait on them
            expected = {i for i, m in enumerate(group.members)
                        if m.peer_id != me.peer_id and m.weight > 0}
            n_expected0 = len(expected)
            # Byzantine screening engages only when the weighted roster
            # (self included) is big enough for a leave-one-out
            # consensus; otherwise — and whenever screening is off —
            # the pre-screening streaming accumulation below runs
            # UNMODIFIED, byte-for-byte (small-swarm transparency).
            n_weighted = n_expected0 + (1 if weight > 0 else 0)
            screen_active = (screen is not None
                             and n_weighted >= screen.policy.min_senders)
            # Fused device accumulation: with no screen configured (its
            # statistics need host segments) and a pinned block codec,
            # each completed sender's validated wire payloads feed a
            # jitted donated decode+weighted-add — the accumulator stays
            # on device and host f32 numpy leaves the reduce hot path.
            # (fused_capable implies pin_scatter == codec: the payloads
            # are interpreted under the round's one codec.)
            fused = fused_capable
            # screened mode BUFFERS fully-delivered contributions (one
            # part-sized array per live sender) and accumulates after
            # the verdict, in sender order — same f32 multiply-add
            # sequence as the streaming path over the survivors
            complete: Dict[int, Tuple[float, np.ndarray]] = {}
            if screen_active:
                acc = None  # summed after the screen verdict
                total_w = 0.0
            elif (screen is not None and weight > 0
                    and screen.over_ceiling(mine)):
                # the absolute ceiling binds the OWNER's own
                # contribution too, at any sender count — otherwise a
                # hostile owner below the screen quorum could
                # self-sign an arbitrarily huge "own contribution"
                # and serve the poisoned part with a transcript the
                # replay would certify. Below the quorum the
                # self-drop is unstruck like any ceiling drop.
                acc = np.zeros(n_mine, np.float32)
                total_w = 0.0
                ban_peer(me.peer_id, "screen-outlier", strike=False)
                if report is not None:
                    report["complete"] = False
                logger.warning(
                    "allreduce: own contribution over the absolute "
                    "norm ceiling (%g) — withheld from this part",
                    screen.policy.abs_norm_ceiling)
                if retain_mine:
                    audit.note_init("zeros")
                    audit.note_drop(group.my_index, "screen-outlier")
            else:
                # fused path: seed the DEVICE accumulator with the same
                # f32 multiply the host path runs (bit-equal)
                acc = (device_codec.accumulator_init(flat_dev, lo, hi,
                                                     weight)
                       if fused else mine * weight)
                total_w = weight
                if retain_mine:
                    # streaming accumulation initializes from this
                    # owner's own contribution (weight may be 0)
                    audit.note_init("self")
            # hostile-owner chaos seam (swarm/chaos.py omit_sender):
            # an active op names one delivered sender whose whole
            # contribution this owner silently discards — no ban, no
            # transcript entry. The sender-side omission audit is what
            # catches exactly this.
            omit_pick = getattr(dht, "omit_sender_target", None)
            omit_target = None
            if omit_pick is not None and expected:
                omit_target = omit_pick(epoch, sorted(
                    group.members[i].peer_id for i in expected),
                    prefix=prefix)
            # a sender's contribution applies ATOMICALLY once all its
            # chunks arrived (partial senders are dropped wholesale, the
            # same elasticity semantics as the unchunked protocol)
            bufs: Dict[int, np.ndarray] = {}
            got: Dict[int, set] = {}
            # the weight APPLIED for a sender is its chunk-0 frame's
            # claim, deterministically — never "whichever frame
            # completed the set" (arrival order). Every chunk's claim
            # still faces the clamp below, but only chunk 0 governs:
            # a sender shipping inconsistent in-clamp weights across
            # its chunks gains nothing and — crucially — cannot make
            # an honest owner's audit transcript unreplayable (the
            # replay re-derives the same chunk-0 weight)
            wts: Dict[int, float] = {}
            # deterministic pipelined fold: with the pipeline
            # on, the drain lands chunks in arrival order, which made
            # the f32 accumulation order — and therefore the round's
            # output bytes — a per-run artifact. Pipelined rounds now
            # BUFFER each completed contribution and fold at the round
            # seam in roster index order, so the same seeded schedule
            # produces bit-identical bytes across runs and the audit
            # transcript's recorded order is a pinned roster-derived
            # invariant instead of a transcript artifact. Sequential
            # rounds keep the streaming accumulate untouched (byte
            # transparency), and the screened path already folds in
            # sorted sender order.
            det_fold = pipe is not None and not screen_active
            det_buf: Dict[int, Tuple[float, object]] = {}
            my_tag = _tag(prefix, epoch, "scatter", me.peer_id)
            my_ctx = _sign_ctx(prefix, epoch, "scatter", me.peer_id)

            def fold_contrib(sender: int, w: float, payload) -> None:
                # one contribution into the accumulator — the SAME
                # f32 ops whether called streaming (sequential mode)
                # or from the roster-ordered seam fold (pipelined)
                nonlocal acc, total_w
                if fused:
                    chunks_b = payload
                    if all(isinstance(p, (bytes, bytearray))
                           for p in chunks_b):
                        acc = device_codec.fused_accumulate(
                            acc, chunks_b, codec, n_mine, w)
                    else:
                        # a sender in some OTHER codec (unpinned
                        # rounds accept it): decode
                        # on the host and add the host-multiplied
                        # contribution to the device accumulator —
                        # the add is the same IEEE f32 op either
                        # way, so parity with the host path holds
                        seg = np.zeros(n_mine, np.float32)
                        for ci2, (clo2, chi2) in enumerate(my_chunks):
                            p = chunks_b[ci2]
                            seg[clo2:chi2] = (
                                codec_mod.decompress(
                                    bytes(p), codec, chi2 - clo2)
                                if isinstance(p, (bytes, bytearray))
                                else p)
                        acc = device_codec.add_contrib(
                            acc, seg * np.float32(w))
                else:
                    acc += payload * w
                total_w += w
                if retain_mine:
                    audit.note_applied(sender)

            def decode_reduce(raw_enc: bytes):
                # decrypt+verify+decompress off the receive thread: the
                # wire read of chunk i+1 overlaps the decode of chunk i
                # (device backend: the decompress dispatches to the
                # accelerator from this same pool — the drain structure
                # is backend-independent). The decrypted signed frame
                # rides along for the audit transcript's retention.
                t_d = time.monotonic()
                raw = maybe_decrypt(gkey, raw_enc)
                if raw is None:
                    return None
                return raw, _parse(raw, group, my_chunks, my_ctx,
                                   codec_mod, pinned=pin_scatter,
                                   defer_codec=codec if fused else None
                                   ), t_d

            banned_reduce = 0  # corrupt-banned senders (no data applied)

            def apply_reduce(item) -> bool:
                nonlocal acc, total_w, banned_reduce
                if item is None:
                    return False
                raw, parsed, t_d = item
                if parsed is None:
                    return False
                status, sender, w, ci, data = parsed
                if sender not in expected:
                    return False  # duplicate or already-complete sender
                if status == "bad":
                    # authenticated garbage (valid signature over bad
                    # geometry / codec — _parse never blames an
                    # unsigned frame): drop this sender's WHOLE
                    # contribution now — buffered chunks included —
                    # instead of holding the round open until the
                    # no-progress timeout. Its weight never reaches
                    # total_w, so the average renormalizes over the
                    # honest contributors by construction.
                    expected.discard(sender)
                    bufs.pop(sender, None)
                    got.pop(sender, None)
                    wts.pop(sender, None)
                    banned_reduce += 1
                    ban_peer(group.members[sender].peer_id,
                             "corrupt-chunk")
                    if retain_mine:
                        # the bad frame IS the proof: auditors replay
                        # the parse and confirm the verdict
                        audit.note_drop(sender, "corrupt-chunk",
                                        evidence=raw)
                    if report is not None:
                        report["complete"] = False
                    logger.warning(
                        "allreduce: banned sender %s for a signed but "
                        "unusable chunk (contribution dropped, weight "
                        "renormalized out). Hostile/buggy sender, OR a "
                        "config mismatch — a peer with a different "
                        "model shape or chunk_elems produces frames "
                        "this receiver can never apply",
                        group.members[sender].peer_id[:16])
                    return True  # the roster shrank: that is progress
                if max_peer_weight is not None and not (
                        0.0 <= w <= max_peer_weight):
                    # a VALIDLY SIGNED frame claiming an absurd (or
                    # non-finite) weight: without this clamp a single
                    # weight=1e9 claim drowns the swarm while every
                    # value-level screen stays quiet (the data can be
                    # perfectly honest). The signature makes the claim
                    # attributable — drop the whole contribution and
                    # strike, exactly like authenticated garbage.
                    expected.discard(sender)
                    bufs.pop(sender, None)
                    got.pop(sender, None)
                    wts.pop(sender, None)
                    banned_reduce += 1
                    ban_peer(group.members[sender].peer_id,
                             "weight-overclaim")
                    if retain_mine:
                        audit.note_drop(sender, "weight-overclaim",
                                        evidence=raw)
                    if report is not None:
                        report["complete"] = False
                    logger.warning(
                        "allreduce: banned sender %s for claiming "
                        "weight %r outside [0, %r] (contribution "
                        "dropped)", group.members[sender].peer_id[:16],
                        w, max_peer_weight)
                    return True
                if sender not in bufs:
                    bufs[sender] = {} if fused \
                        else np.zeros(n_mine, np.float32)
                    got[sender] = set()
                if ci in got[sender]:
                    return False  # duplicate chunk
                if fused:
                    # validated wire payload (round-codec frames), or a
                    # decoded host chunk (any OTHER codec an unpinned
                    # round still accepts — the mixed-codec interop)
                    bufs[sender][ci] = data
                else:
                    clo, chi = my_chunks[ci]
                    bufs[sender][clo:chi] = data
                got[sender].add(ci)
                if meter is not None:
                    meter.note("reduce", my_part, t_d,
                               time.monotonic() - t_d, len(raw), ci)
                if ci == 0:
                    wts[sender] = w
                if retain_mine:
                    audit.note_frame(sender, ci, raw)
                if len(got[sender]) == len(my_chunks):
                    w = wts.pop(sender)  # chunk-0 claim governs
                    pid = group.members[sender].peer_id
                    if omit_target is not None and pid == omit_target:
                        # chaos omit_sender: discard the delivered
                        # contribution wholesale, leave no trace (the
                        # attack the omission audit convicts)
                        bufs.pop(sender)
                    elif screen_active:
                        # buffer for the post-drain screen; weight and
                        # accumulation are deferred to the verdict
                        complete[sender] = (w, bufs.pop(sender))
                    elif fused:
                        # jitted donated accumulate per sender: wire
                        # codes+scales in, f32 accumulator in/out —
                        # bit-equal to the host multiply-then-add
                        payloads = bufs.pop(sender)
                        chunks_b = [payloads[i]
                                    for i in range(len(my_chunks))]
                        if det_fold:
                            det_buf[sender] = (w, chunks_b)
                        else:
                            fold_contrib(sender, w, chunks_b)
                    else:
                        seg = bufs.pop(sender)
                        if screen is not None \
                                and screen.over_ceiling(seg):
                            # absolute-norm ceiling, active at ANY
                            # sender count (the <4-sender narrowing):
                            # below the screen quorum the delivered
                            # segment is dropped but NOT struck — the
                            # 2-peer unattributability rule
                            ban_peer(pid, "screen-outlier",
                                     strike=False)
                            if retain_mine:
                                audit.note_drop(sender,
                                                "screen-outlier")
                            if report is not None:
                                report["complete"] = False
                            logger.warning(
                                "allreduce: dropped sender %s — "
                                "segment norm over the absolute "
                                "ceiling (%g); below the screen "
                                "quorum the drop is unstruck",
                                pid[:16],
                                screen.policy.abs_norm_ceiling)
                        elif det_fold:
                            det_buf[sender] = (w, seg)
                        else:
                            fold_contrib(sender, w, seg)
                    got.pop(sender)
                    expected.discard(sender)
                return True

            decoding: List[concurrent.futures.Future] = []
            last_progress = time.monotonic()
            while expected:
                now = time.monotonic()
                if now >= reduce_deadline:
                    break  # gather keeps the remaining budget
                if (now - last_progress >= sender_timeout
                        and not decoding):
                    break  # no chunk for a while: remaining senders banned
                still: List[concurrent.futures.Future] = []
                for f in decoding:
                    if not f.done():
                        still.append(f)
                        continue
                    if apply_reduce(f.result()):
                        last_progress = time.monotonic()
                decoding = still
                if not expected:
                    break
                raw = dht.recv(my_tag, timeout=min(
                    0.2, max(0.05, reduce_deadline - now)))
                if raw is not None:
                    decoding.append(dec_pool.submit(decode_reduce, raw))
            # chunks already received (and possibly mid-decode) when the
            # deadline fired still count: dropping them would discard a
            # fully-delivered sender's whole buffered contribution. The
            # grace is bounded by the round's remaining overall budget —
            # a flat grace here let a round overrun allreduce_timeout by
            # up to ~4 s across the two drain points.
            if decoding and expected:
                concurrent.futures.wait(decoding, timeout=max(
                    0.0, min(2.0, deadline - time.monotonic())))
                for f in decoding:
                    if f.done():
                        apply_reduce(f.result())
            if det_buf:
                # the round seam: every buffered contribution folds in
                # roster index order, whatever order the drain landed
                # them — the accumulation sequence (and the audit
                # transcript's applied order) is now a function of the
                # roster alone
                for s in sorted(det_buf):
                    w_s, payload = det_buf[s]
                    fold_contrib(s, w_s, payload)
                det_buf.clear()
            # strike attribution: a no-show while OTHER senders' data
            # landed here is that peer's fault; zero data from anyone
            # (including the only peer of a 2-peer swarm) is equally
            # consistent with local inbound loss — renormalize and
            # report, but don't feed the ledger strikes that would
            # down-rank every honest peer and self-isolate this node
            delivered_any = ((n_expected0 - len(expected) - banned_reduce)
                             > 0 or bool(bufs))
            blame_remote = delivered_any
            for s in expected:
                # never delivered a full contribution within the round's
                # patience: the classic dead/slow-peer ban
                ban_peer(group.members[s].peer_id, "reduce-timeout",
                         strike=blame_remote)
                if retain_mine:
                    # a claimed timeout is the one unprovable drop —
                    # recorded reason-only, earns nobody a strike at
                    # replay (silence semantics)
                    audit.note_drop(s, "reduce-timeout")
            if expected and report is not None:
                report["complete"] = False
            if screen_active:
                # every fully-delivered contribution (self included) is
                # screened together: the screen's verdict is drop/keep
                # only, so the surviving sum below is bit-identical to
                # an honest-only round over the same survivors
                if weight > 0:
                    complete[group.my_index] = (weight, mine)
                verdict = screen.screen(complete)
                for k in sorted(verdict.dropped):
                    ban_peer(group.members[k].peer_id, "screen-outlier")
                    if retain_mine:
                        audit.note_drop(k, "screen-outlier")
                    if report is not None:
                        report["complete"] = False
                    logger.warning(
                        "allreduce: screened out sender %s (%s) — "
                        "validly signed but content-outlying "
                        "contribution dropped, weight renormalized "
                        "out%s", group.members[k].peer_id[:16],
                        verdict.dropped[k],
                        " [own contribution]"
                        if k == group.my_index else "")
                if retain_mine and verdict.skipped:
                    audit.note_withheld()
                if verdict.skipped:
                    # the ROSTER promised a screenable quorum
                    # (screen_active) but actual deliveries fell below
                    # min_senders — churn, or a mid-epoch roster split
                    # while offenders are being penalized at different
                    # peers. The screen cannot certify ANYTHING about
                    # this under-delivered set, and averaging it
                    # unscreened is exactly the window an attacker
                    # needs (observed in the byzantine soak: a
                    # transition epoch landed tampered data through
                    # the skip). WITHHOLD the part — the dead-owner
                    # elasticity path: every member keeps its local
                    # values and the round reports incomplete.
                    acc = np.zeros(n_mine, np.float32)
                    total_w = 0.0
                    if report is not None:
                        report["complete"] = False
                    logger.warning(
                        "allreduce: %d/%d contributions delivered — "
                        "below the screen quorum (%d); withholding "
                        "this part (members keep local values)",
                        len(complete), n_weighted,
                        screen.policy.min_senders)
                elif weight > 0 and group.my_index not in verdict.dropped:
                    acc = mine * weight
                    total_w = weight
                    if retain_mine:
                        audit.note_init("self")
                else:
                    acc = np.zeros(n_mine, np.float32)
                    total_w = 0.0
                    if retain_mine:
                        audit.note_init("zeros")
                if not verdict.skipped:
                    for k in sorted(complete):
                        if k == group.my_index or k in verdict.dropped:
                            continue
                        w_k, seg = complete[k]
                        acc += seg * w_k
                        total_w += w_k
                        if retain_mine:
                            audit.note_applied(k)
            if report is not None:
                # contributors whose full data reached this part (self
                # included when weight > 0) — an assistant uses this to
                # detect rounds where nothing ever parsed (e.g. a model
                # mismatch producing un-parseable chunk geometry).
                # Corrupt-banned senders left ``expected`` without
                # contributing: subtract them.
                report["reduced_senders"] = (n_expected0 - len(expected)
                                             - banned_reduce
                                             + (1 if weight > 0 else 0))
            if total_w > 0:
                if fused:
                    # the round's ONE reduce-side host pull: the
                    # finished accumulator (the trust seams — screen
                    # ceilings, audit, tamper — and the gather encode
                    # consume host values); the divide stays the same
                    # host f32 op as the unfused path
                    acc = device_codec.to_host(acc)
                averaged_mine = acc / total_w
            else:
                # an assistant that received NO contributions must not
                # gather its zero template — broadcasting it would
                # silently zero this part on every trainer while the
                # round looks complete. Withhold the part: receivers
                # fall back to their local values and flag the round
                # incomplete, the same dead-owner elasticity path.
                # (Without screening a weight>0 member always has
                # total_w >= weight > 0; with it, a round whose every
                # contribution was screened out — own included — takes
                # this same withhold path.)
                averaged_mine = None
            if retain_mine and averaged_mine is not None:
                # self-sign this owner's own contribution (exact codec)
                # so the transcript's inputs fully explain the average
                audit.note_self(dht.identity, my_ctx, group.group_hash,
                                group.my_index, weight, mine, my_chunks)
            phases["reduce_s"] = round(time.monotonic() - t_built, 3)
            note_part("reduce", my_part)

        if pipe is not None:
            # pipelined: serve this owner's averaged part NOW — the
            # serve codec+sends overlap the scatter barrier, the send
            # retry pass and the EF store below (the sequential path
            # reaches the same two calls after them — same bytes,
            # earlier wall-clock; the transcript post stays ahead of
            # the part's first served chunk in BOTH modes)
            pre_serve()
            start_serve(serve_pool, serve_codec_pool)
        t_wait = time.monotonic()
        if scatter_sched is not None:
            # the bounded-depth scheduler may still be launching parts
            # from chunk callbacks: wait for the last part's completion
            # callback, then snapshot the full futures list for the
            # barrier + retry pass below
            scatter_sched[0].wait(timeout=max(
                5.0, deadline - time.monotonic() + 10.0))
            futures = scatter_sched[1]()
        concurrent.futures.wait(futures)
        # One application-layer retry for scatter sends that failed: the
        # wire layer never resends a mutating frame after a lost reply
        # (swarm.cc rpc), but at THIS layer a resend is safe —
        # receivers de-duplicate by (sender, chunk_idx) — so a dropped
        # connection costs one retry instead of this peer's whole
        # contribution being banned at the owner. The produced wire body
        # rides the future result, so the retry skips the codec.
        retries = [f.result()[:3] for f in futures
                   if not f.cancelled() and not f.result()[3]]
        failed_tags = {t for _a, t, _b in retries}
        if retries and time.monotonic() < deadline:
            retry_futs = [pool.submit(send_raw, *s) for s in retries]
            concurrent.futures.wait(retry_futs)
            # consume every retry outcome: an exception in send_raw (or
            # a still-failing send) must leave a trace, not vanish in an
            # unread Future (graftlint unchecked-pool-future)
            failed_tags = set()
            still_failed = 0
            for f, s in zip(retry_futs, retries):
                if not f.done() or not f.result():
                    still_failed += 1
                    failed_tags.add(s[1])
            if still_failed:
                logger.warning(
                    "allreduce: %d/%d scatter chunk(s) undeliverable "
                    "after retry (receivers will ban this sender's "
                    "contribution)", still_failed, len(retry_futs))
        if audit is not None and weight > 0:
            # sender-side bookkeeping for the omission audit: which
            # audited parts this peer's WHOLE contribution was
            # transport-acked into (any chunk's send still failing
            # after retry disqualifies the part — the owner may
            # legitimately never have seen us)
            for k, owner in scatter_to:
                if k == my_part or k not in audited_parts:
                    continue
                if _tag(prefix, epoch, "scatter",
                        owner.peer_id) not in failed_tags:
                    audit.note_scatter_ok(k)
        phases["scatter_wait_s"] = round(time.monotonic() - t_wait, 3)

        if ef_scatter is not None and weight > 0:
            # Store this round's quantization error: compensated minus
            # what each part OWNER decoded. The own part is applied raw
            # f32 (its pending error was delivered in full — residual
            # clears); sent parts subtract the dequantize of the exact
            # wire bytes. Device path: the whole update is one donated
            # jitted subtract over the already-encoded parts — the
            # compensated vector must not be read afterwards, so the
            # device flat is dropped here.
            t_ef = time.monotonic()
            if use_device and all(g is not None
                                  for k_, g in scatter_encs.items()
                                  if k_ != my_part):
                segs = []
                for k in range(len(owners)):
                    lo_, hi_ = slices[k]
                    if k == my_part or scatter_encs.get(k) is None:
                        segs.append(flat_dev[lo_:hi_])
                    else:
                        segs.append(scatter_encs[k]().decoded_dev())
                ef_scatter.store(flat_dev, segs)
                flat_dev = None  # donated into the residual update
            else:
                # host backend: re-derive each sent part's decode with
                # the same block-aligned codec (one extra round-trip per
                # part — the device backend is the EF production home)
                decoded = flat.copy()
                for k, _owner in scatter_to:
                    if k == my_part:
                        continue
                    lo_, hi_ = slices[k]
                    buf = compression.compress(flat[lo_:hi_], codec)
                    decoded[lo_:hi_] = compression.decompress(
                        buf, codec, hi_ - lo_)
                ef_scatter.store(flat, [decoded])
            phases["ef_scatter_s"] = round(time.monotonic() - t_ef, 3)

    if pipe is None:
        # sequential mode: the serve prep (transcript post -> EF gather
        # compensate -> tamper seam) runs HERE, the historical protocol
        # point — pipelined rounds already ran it inside the scatter
        # block, right after the reduce finished
        pre_serve()
        # --- gather: averaged part i -> everyone; collect the rest ------
        # an assistant's return value is meaningless (it collects nothing
        # and its caller discards it) — skip the full-size copy; gather-
        # send's local writes land in ``flat``, which is already this
        # call's own buffer (flatten_tensors concatenates into a fresh
        # array)
        out = flat.copy() if weight > 0 else flat

    t_gather = time.monotonic()
    if pipe is not None:
        # --- pipelined gather tail ---------------------------------------
        # the drain thread has been collecting other owners' parts since
        # before the scatter — by now most frames have already decoded
        # and applied. The serve (start_serve above) is racing on its own
        # pools. All that remains: join the drain, merge its verdicts,
        # and flush the serve.
        leftover, drain_bans, progressed = pipe.finish()
        for peer_id, reason in drain_bans:
            # verdicts reached on the drain thread are applied HERE, on
            # the caller thread — ban_peer mutates the ledger and the
            # report, neither of which the drain touches directly
            ban_peer(peer_id, reason)
            if report is not None:
                report["complete"] = False
            logger.warning(
                "allreduce: part owner %s served a corrupt/truncated "
                "chunk — keeping local values for that part",
                peer_id[:16])
        # chunks never received keep this peer's local values (owner died
        # mid-round): degraded but well-defined. Same strike attribution
        # as the sequential sweep — owners silent with zero gather data
        # point at the local node as much as at them.
        blame_owners = progressed
        for k in leftover:
            ban_peer(owners[k].peer_id, "gather-timeout",
                     strike=blame_owners)
        if leftover and report is not None:
            report["complete"] = False
        concurrent.futures.wait(g_produce)
        for f in g_produce:
            f.result()  # surface codec bugs instead of dropping the part
        if ef_gather_active:
            # the served values are now fully applied locally in ``out``
            # (the exact wire bytes' dequantize): record this round's
            # gather quantization error against the compensated (or, on
            # a challenged part, raw) average actually encoded
            glo, ghi = slices[my_part]
            ef_gather.store_slice(averaged_mine, out[glo:ghi],
                                  glo, ghi, flat.size)
        concurrent.futures.wait(g_futures)
        # same application-layer retry as scatter: gather chunks are
        # de-duplicated by (part, chunk_idx) at every receiver
        retries = [s for f, s in zip(g_futures, g_sends)
                   if not f.cancelled() and not f.result()]
        if retries and time.monotonic() < deadline:
            retry_futs = [serve_pool.submit(send_raw, *s)
                          for s in retries]
            concurrent.futures.wait(retry_futs)
            still_failed = sum(1 for f in retry_futs
                               if f.done() and not f.result())
            if still_failed:
                logger.warning(
                    "allreduce: %d/%d gather chunk send(s) "
                    "undeliverable after retry", still_failed,
                    len(retry_futs))
        serve_pool.shutdown(wait=False)
        serve_codec_pool.shutdown(wait=False)
        phases["gather_s"] = round(time.monotonic() - t_gather, 3)
        if meter is not None:
            hop_rows = meter.rows()
            if hop_rows:
                phases["hops"] = hop_rows
        if weight == 0:
            return [_host_f32(t, copy=False) for t in tensors]
        t_out = time.monotonic()
        result = unflatten_tensors(out, tensors)
        phases["unflatten_s"] = round(time.monotonic() - t_out, 3)
        return result

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=_pool_workers(8)) as pool, \
            concurrent.futures.ThreadPoolExecutor(
                max_workers=_pool_workers(4)) as codec_pool, \
            concurrent.futures.ThreadPoolExecutor(
                max_workers=_pool_workers(4)) as dec_pool:
        # averaged_mine is None only for an assistant that received no
        # contributions: withhold the part (see the reduce phase)
        start_serve(pool, codec_pool)

        # weight-0 assistants collect no result at all (nothing to apply
        # it to — and a routable assistant must NOT fall into the
        # client-mode mailbox poll below, which would burn the round's
        # remaining budget fetching chunks that are pushed, not posted)
        if weight == 0:
            pass
        elif me.addr:
            part_chunks = {
                k: _chunk_slices(hi_ - lo_, chunk_elems)
                for k, (lo_, hi_) in enumerate(slices)}
            # pending chunk ids per part
            pending: Dict[int, set] = {
                owner_index[m.peer_id]:
                    set(range(len(part_chunks[owner_index[m.peer_id]])))
                for m in owners if m.peer_id != me.peer_id}
            n_pending0 = len(pending)
            sender_to_part = {
                group.members.index(m): owner_index[m.peer_id]
                for m in owners}
            gather_tag = _tag(prefix, epoch, "gather", me.peer_id)

            def decode_gather(raw_enc: bytes):
                # decrypt+verify+decompress on a decode worker; the
                # receive thread keeps draining the wire meanwhile
                t_d = time.monotonic()
                raw = maybe_decrypt(gkey, raw_enc)
                if raw is None:
                    return None
                head = _peek(raw, group)
                if head is None:
                    return None
                part = sender_to_part.get(head[0])
                # skip the multi-MB verify+decompress for parts already
                # complete (retried duplicates). Reading `pending` from
                # the pool races benignly with the receive thread: a
                # stale read only costs one wasted decode — correctness
                # stays with the authoritative dedup at apply time.
                if part is None or part not in pending:
                    return None
                parsed = _parse(raw, group, part_chunks[part], gather_ctx,
                                codec_mod, pinned=pin_gather)
                if parsed is None:
                    return None
                # the codec this chunk ACTUALLY arrived in (the wire
                # header, post-signature-verify): the audit replays the
                # gather re-encode with the codecs this member applied,
                # so mixed-codec (unpinned) owners replay faithfully.
                # The raw signed frame rides along for audited parts —
                # it is the owner-signed half of a proof receipt and
                # the served bytes the repair plane corrects.
                return part, parsed, _HDR.unpack_from(raw)[6], raw, t_d

            def apply_gather(res) -> bool:
                if res is None:
                    return False
                part, (status, sender, _w, ci, data), gcodec, raw, t_d \
                    = res
                if part not in pending:
                    return False  # completed part
                if status == "bad":
                    # the part OWNER is serving damaged bytes: stop
                    # waiting on it — the part keeps this peer's local
                    # values (the dead-owner elasticity path), the
                    # round reports incomplete, the owner is struck
                    pending.pop(part, None)
                    ban_peer(group.members[sender].peer_id,
                             "corrupt-chunk")
                    if report is not None:
                        report["complete"] = False
                    logger.warning(
                        "allreduce: part %d owner %s served a corrupt/"
                        "truncated chunk — keeping local values for "
                        "that part", part,
                        group.members[sender].peer_id[:16])
                    return True
                if ci not in pending[part]:
                    return False  # duplicate chunk
                # NB: fresh names — produce_gather's codec threads read
                # the enclosing lo/clo/chi lazily; rebinding them here
                # would corrupt the local-apply offsets
                plo, _phi = slices[part]
                pclo, pchi = part_chunks[part][ci]
                out[plo + pclo:plo + pchi] = data
                pending[part].discard(ci)
                if meter is not None:
                    meter.note("gather", part, t_d,
                               time.monotonic() - t_d, len(raw), ci)
                if audit is not None and part in audited_parts:
                    audit.note_gather_codec(part, ci, gcodec)
                    audit.note_gather_frame(part, ci, raw)
                if not pending[part]:
                    del pending[part]
                    if audit is not None and part in audited_parts:
                        # retain the exact bytes this member will live
                        # with — the replay's comparison target
                        alo, ahi = slices[part]
                        audit.note_gathered(part, out[alo:ahi])
                    note_part("gather", part)
                return True

            decoding: List[concurrent.futures.Future] = []
            last_progress = max(time.monotonic(), gather_baseline)
            while pending:
                now = time.monotonic()
                if now >= deadline or (not decoding and
                                       now - last_progress
                                       >= sender_timeout):
                    break  # dead owners: their parts keep local values
                still: List[concurrent.futures.Future] = []
                for f in decoding:
                    if not f.done():
                        still.append(f)
                        continue
                    if apply_gather(f.result()):
                        last_progress = time.monotonic()
                decoding = still
                if not pending:
                    break
                raw = dht.recv(gather_tag, timeout=min(
                    0.2, max(0.05, deadline - now)))
                if raw is not None:
                    decoding.append(dec_pool.submit(decode_gather, raw))
            # salvage decodes that COMPLETED during the last recv poll —
            # without waiting: this point is only reachable at the
            # overall deadline (the no-progress break requires an empty
            # decode queue), and the deadline is a promise to the caller
            # (the old flat 2.0 s grace here let a round
            # overrun allreduce_timeout). Chunks still mid-decode this
            # late are dropped; the round reports incomplete and the
            # parts keep local values — the normal degraded path.
            if decoding and pending:
                for f in decoding:
                    if f.done():
                        apply_gather(f.result())
            # chunks never received keep this peer's local values (owner
            # died mid-round): degraded but well-defined. Same strike
            # attribution as the reduce sweep: owners silent with zero
            # gather data points at the local node as much as at them —
            # report the bans, withhold the ledger strikes.
            progressed = (len(pending) < n_pending0 or any(
                len(v) < len(part_chunks[k]) for k, v in pending.items()))
            blame_owners = progressed
            for k in pending:
                ban_peer(owners[k].peer_id, "gather-timeout",
                         strike=blame_owners)
            if pending and report is not None:
                report["complete"] = False
        else:
            # client mode: pull each averaged part's chunks from its
            # owner's mailbox
            part_chunks = {
                k: _chunk_slices(hi_ - lo_, chunk_elems)
                for k, (lo_, hi_) in enumerate(slices)}
            pending = {k: set(range(len(part_chunks[k])))
                       for k in range(len(owners))}
            last_progress = max(time.monotonic(), gather_baseline)
            while pending:
                now = time.monotonic()
                if now >= deadline or now - last_progress >= sender_timeout:
                    break
                for k in list(pending):
                    owner = owners[k]
                    for ci in sorted(pending[k]):
                        t_f0 = time.monotonic()
                        raw = fetch_chunk(
                            owner.addr,
                            _tag(prefix, epoch, f"mailbox{ci}",
                                 owner.peer_id),
                            timeout=min(2.0, max(
                                0.1, deadline - time.monotonic())))
                        if raw is None:
                            continue
                        parsed = _parse(raw, group, part_chunks[k],
                                        gather_ctx, codec_mod,
                                        pinned=pin_gather)
                        if parsed is None:
                            continue
                        status, psender, _, pci, data = parsed
                        if (status == "bad" or group.members[psender]
                                .peer_id != owner.peer_id):
                            # the OWNER's mailbox served damaged goods:
                            # authenticated garbage, or a replayed
                            # frame validly signed by some OTHER peer
                            # (the shared gather ctx makes that frame
                            # verify — the mailbox it came from is what
                            # convicts). Abandon the part (local
                            # values) and strike the owner — NEVER the
                            # signer, or a hostile owner could frame
                            # honest peers by replaying their frames.
                            pending.pop(k, None)
                            ban_peer(owner.peer_id, "corrupt-chunk")
                            if report is not None:
                                report["complete"] = False
                            last_progress = time.monotonic()
                            break
                        if pci not in pending[k]:
                            continue
                        lo, hi = slices[k]
                        clo, chi = part_chunks[k][pci]
                        out[lo + clo:lo + chi] = data
                        pending[k].discard(pci)
                        if meter is not None:
                            meter.note("gather", k, t_f0,
                                       time.monotonic() - t_f0,
                                       len(raw), pci)
                        if audit is not None and k in audited_parts:
                            audit.note_gather_codec(
                                k, pci, _HDR.unpack_from(raw)[6])
                            audit.note_gather_frame(k, pci, raw)
                        last_progress = time.monotonic()
                    if not pending.get(k):
                        if k in pending:
                            if (audit is not None
                                    and k in audited_parts):
                                alo, ahi = slices[k]
                                audit.note_gathered(k, out[alo:ahi])
                            note_part("gather", k)
                        pending.pop(k, None)
                if pending:
                    time.sleep(0.1)
            # same strike attribution as the push path: every-owner
            # silence with zero pulled chunks points at the local node
            progressed = (len(pending) < len(owners) or any(
                len(v) < len(part_chunks[k]) for k, v in pending.items()))
            blame_owners = progressed
            for k in pending:
                ban_peer(owners[k].peer_id, "gather-timeout",
                         strike=blame_owners)
            if pending and report is not None:
                report["complete"] = False

        concurrent.futures.wait(g_produce)
        for f in g_produce:
            f.result()  # surface codec bugs instead of dropping the part
        if ef_gather_active:
            # the served values are now fully applied locally in ``out``
            # (the exact wire bytes' dequantize): record this round's
            # gather quantization error against the compensated (or, on
            # a challenged part, raw) average actually encoded
            glo, ghi = slices[my_part]
            ef_gather.store_slice(averaged_mine, out[glo:ghi],
                                  glo, ghi, flat.size)
        concurrent.futures.wait(g_futures)
        # same application-layer retry as scatter: gather chunks are
        # de-duplicated by (part, chunk_idx) at every receiver
        retries = [s for f, s in zip(g_futures, g_sends)
                   if not f.cancelled() and not f.result()]
        if retries and time.monotonic() < deadline:
            retry_futs = [pool.submit(send_raw, *s) for s in retries]
            concurrent.futures.wait(retry_futs)
            # read back every retry (graftlint unchecked-pool-future):
            # a receiver that still missed the chunk falls back to its
            # local values for this part — worth a trace here too
            still_failed = sum(1 for f in retry_futs
                               if f.done() and not f.result())
            if still_failed:
                logger.warning(
                    "allreduce: %d/%d gather chunk send(s) undeliverable "
                    "after retry", still_failed, len(retry_futs))

    phases["gather_s"] = round(time.monotonic() - t_gather, 3)
    if meter is not None:
        hop_rows = meter.rows()
        if hop_rows:
            phases["hops"] = hop_rows
    if weight == 0:
        # assistants discard the result: skip the unflatten copies
        return [_host_f32(t, copy=False) for t in tensors]
    t_out = time.monotonic()
    result = unflatten_tensors(out, tensors)
    phases["unflatten_s"] = round(time.monotonic() - t_out, 3)
    return result


def _peek(raw: bytes, group: AveragingGroup
          ) -> Optional[Tuple[int, float]]:
    if len(raw) < _PREFIX_LEN:
        return None
    ghash, sender, w, _n, _ci, _nc, _c = _HDR.unpack_from(raw)
    if ghash != group.group_hash or not (0 <= sender < group.size):
        return None
    return sender, w


def _parse(raw: bytes, group: AveragingGroup,
           chunks: List[Tuple[int, int]], ctx: bytes,
           codec_mod=compression, pinned: Optional[int] = None,
           defer_codec: Optional[int] = None
           ) -> Optional[Tuple[str, int, float, int,
                               Optional[np.ndarray]]]:
    """-> ("ok", sender, weight, chunk_idx, decoded chunk),
    ("bad", sender, 0.0, -1, None), or None.

    ``chunks`` is the receiver-side chunking of the part this tag carries
    (both sides derive it from the part size, so chunk_idx and the chunk's
    element count must both agree — a frame chunked differently is
    malformed). ``codec_mod`` is the decompress backend (compression or
    device_codec — identical wire semantics).

    ``pinned`` (a codec id) rejects validly-signed frames naming ANY
    other codec as "bad" — codec flapping: on a pinned-codec run
    (the wire_bits knobs' ``pin_codec`` opt-in) a frame in a
    different codec has no honest cause, and error-feedback residual
    scales are only meaningful against one stable quantizer. ``None``
    keeps the accept-what-the-header-names semantics.
    ``defer_codec`` (the fused reduce path): frames IN that codec
    skip the decode and return their STRUCTURALLY VALIDATED wire
    payload bytes as ``data`` (u8/u4 only — every byte is a valid
    code, so the length/header checks are exactly as strict as the
    decompress try); frames in any OTHER codec fall through to the
    normal decode, so an unpinned fused round still interoperates
    with mixed-codec senders.

    ``"bad"`` is an AUTHENTICATED verdict: it fires only when the
    frame's signature verifies under the claimed sender's key yet the
    signed content is malformed (wrong geometry for the agreed part
    chunking, undecodable codec payload) — that sender provably
    produced bytes this receiver can never apply, so the receiver bans
    its contribution immediately (weight renormalized out) instead of
    holding the round open until the no-progress timeout. NOTE the
    verdict is "cannot interoperate", not necessarily malice: geometry
    derives from receiver-local config, so an honest peer running a
    different model shape or ``chunk_elems`` lands here too — and the
    resulting corrupt-chunk strikes make config-skewed peers mutually
    down-rank until the swarm re-partitions into compatible groups,
    which is the useful outcome (grouping with a peer whose frames
    never parse burns every round's ban budget). The ledger's decay
    bounds the split if the config converges. Anything that fails the signature check —
    wire corruption, truncation, a forged frame naming someone else —
    returns None: blame there would let any byte flip (or any peer who
    knows the group hash) evict an HONEST member's contribution and
    feed the health ledger false strikes. Unattributable damage still
    degrades gracefully, just slower: the true sender times out and is
    renormalized out via the "reduce-timeout" path."""
    head = _peek(raw, group)
    if head is None:
        return None
    sender, w = head
    if not _verify_frame(raw, ctx, group, sender):
        return None
    _, _, _, n, ci, nc, codec = _HDR.unpack_from(raw)
    if nc != len(chunks) or not (0 <= ci < nc):
        return "bad", sender, 0.0, -1, None
    if pinned is not None and codec != pinned:
        # codec flapping under a pinned run: authenticated garbage
        return "bad", sender, 0.0, -1, None
    clo, chi = chunks[ci]
    if n != chi - clo:
        return "bad", sender, 0.0, -1, None
    body = raw[_PREFIX_LEN:]
    if defer_codec is not None and codec == defer_codec:
        if not compression.quant_payload_valid(body, codec, n):
            return "bad", sender, 0.0, -1, None
        return "ok", sender, float(w), ci, body
    try:
        data = codec_mod.decompress(body, codec, n)
    except (ValueError, struct.error):
        return "bad", sender, 0.0, -1, None
    return "ok", sender, float(w), ci, data
