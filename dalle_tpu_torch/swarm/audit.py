"""Verified aggregation: audit part owners by replaying their rounds
(counterpart of ``dalle_tpu/swarm/audit.py``, host numpy, byte for byte:
``tests/test_torch_audit.py`` holds challenges, transcripts, replays and
proofs equal across the two packages).

Every defense below this layer — signatures, strict parsing, the frame
weight clamp, the content screen, the health ledger (CHAOS.md "Defense
in depth") — runs on a part owner's INPUTS. The owner's OUTPUT, the
averaged part it serves in the gather phase, has exactly one
authoritative source and no cross-sender view to screen against: a
hostile owner that averages honestly-signed inputs into a wrong part
passes everything. This module is the BTARD-style answer (validator
recomputation of aggregator outputs, Gorbunov et al. arXiv 2106.11257)
adapted to the butterfly protocol:

- **Challenge.** Each reduce round, a deterministic challenge derived
  from the shared round id — ``sha256(prefix, epoch, part)`` against
  ``AuditPolicy.frac`` — selects which parts are audited. Every member
  computes the same set with no coordinator, and the challenged owner
  KNOWS it is challenged at round start, so retention costs nothing on
  unchallenged rounds.
- **Transcript.** The challenged owner serves an audit transcript: the
  signed scatter frames it averaged (its own contribution included,
  self-signed with the exact codec), its drop-set with reasons (and
  the offending frame as evidence for every provable reason), and the
  accumulation order. The transcript is itself Ed25519-signed by the
  owner under a (run, epoch, part)-bound context and published in the
  owner's mailbox, chunked, AEAD-wrapped under the round's group key
  like every other data-plane message.
- **Replay.** Any member holding the gathered part re-derives it:
  verify every frame signature, re-run the weight clamp and the
  (deterministic, f64-statistics) :class:`~dalle_tpu_torch.swarm.screening
  .GradientScreen` decisions, re-accumulate the weighted mean in the
  transcript's order with the same f32 operation sequence, re-apply
  the wire codec round-trip, and BIT-COMPARE against the part it
  gathered.

Why the owner cannot cheat:

- **Fabrication is impossible** — every input frame is sender-signed;
  the only frames the owner can mint are its OWN, and a fabricated
  self-contribution crafted to "explain" a wrong output is exactly
  what the replayed screen catches (an outlying self-segment the
  transcript claims was kept fails the screen replay; below the
  screen quorum the absolute-norm ceiling bounds the same move).
- **Omission is attributable to its victim** — a sender whose
  delivered (transport-acked) frames appear neither in the applied
  set nor in the drop-set strikes the owner (``owner-audit-omit``,
  local: only the victim can know it delivered). A *claimed* timeout
  is the one unprovable drop and earns nobody a strike — the same
  silence rule the ban paths follow.
- **A wrong part is a conviction** — replay mismatch is an
  ``owner-audit-fail`` strike that gossips through the signed
  receipt plane (health.StrikeGossip), so a wrong-part owner is
  down-ranked swarm-wide within ~2 epochs. Receipts alone still never
  convict (bounded influence); every member that RECEIVED the wrong
  part corroborates locally, and an owner that equivocates (serves
  different bytes to different members) convicts at every member
  whose bytes disagree with the one transcript it signed.
- **Refusing the audit does not evade it** — an unserved challenge is
  an ``audit-timeout`` strike (local, timeout-weighted: silence is
  never gossiped) at every member that gathered the part, so a
  stonewalling owner converges to the same down-ranking, just without
  the gossip speed-up.

Audit-off rounds are byte-identical to pre-audit rounds (the retention
hooks are inert when ``audit`` is None), and audit-ON honest rounds
produce byte-identical averages — retention copies bytes, it never
touches the accumulation (pinned by test and by the hostile-owner
soak's control pass).

Determinism boundary: the replay's f32 re-accumulation and wire-codec
round-trip are elementwise and bit-stable on any host. The SCREEN
replay's norm/dot statistics run a FIXED-ORDER summation
(screening._fixed_order_sum: row-wise elementwise adds in an order
the code spells out, combined with an exactly-rounded math.fsum — a
pure function of the input bytes on any numpy build; previously f64
numpy/BLAS reductions whose SIMD order could split honest verdicts
on ulp-boundary inputs — the CHAOS.md "Known gaps" entry this
closed).
Quantized rounds add one more surface: the gather re-quantize is
replayed with the round's pinned gather codec, and the owner's gather
error-feedback carry is SUSPENDED on challenged parts (the
deterministic challenge is known round-wide at round start), so the
served part is a pure function of the transcript's signed inputs —
see swarm/error_feedback.py's determinism contract.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import logging
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: replay mismatch — the owner served a part its own signed transcript
#: cannot explain. Attributable (the transcript is owner-signed over
#: sender-signed inputs), so it gossips as a receipt.
AUDIT_FAIL_REASON = "owner-audit-fail"
#: a delivered sender's frames are missing from the transcript
#: entirely (not applied, not dropped). Attributable only to the
#: victim — third parties cannot verify the delivery — so it stays a
#: LOCAL strike.
AUDIT_OMIT_REASON = "owner-audit-omit"
#: challenged owner never served a transcript. Unattributable silence
#: (mailbox loss looks identical), timeout-weighted, never gossiped.
AUDIT_TIMEOUT_REASON = "audit-timeout"

#: wire framing of one posted transcript chunk: (chunk_idx, n_chunks)
_TCHDR = struct.Struct(">II")

#: the averaging phases of the protocol, by round-prefix convention:
#: the main gradient rounds ("{run}_grads"), the PowerSGD factor
#: rounds ("{run}_grads_p"/"_q") and the periodic state averaging
#: ("{run}_state"). Protocol knowledge — the audit (and the chaos
#: layer's phase-scoped attack ops) key on it.
AVERAGING_PHASES = ("grads", "powersgd", "state")


def phase_of_prefix(prefix: str) -> str:
    """Map a round prefix to its averaging phase (see
    :data:`AVERAGING_PHASES`)."""
    if prefix.endswith("_state"):
        return "state"
    if prefix.endswith("_p") or prefix.endswith("_q"):
        return "powersgd"
    return "grads"


def _audit_ctx(prefix: str, epoch: int, part: int) -> bytes:
    """Signature context of a transcript: bound to run, epoch and part
    so a transcript cannot be replayed across rounds or parts."""
    return f"{prefix}:audit-transcript:{epoch}:{part}".encode()


def _audit_tag(prefix: str, epoch: int, part: int, chunk: int) -> int:
    digest = hashlib.sha256(
        f"{prefix}:audit:{epoch}:{part}:{chunk}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def challenged_parts(prefix: str, epoch: int, n_parts: int,
                     frac: float) -> Set[int]:
    """The deterministic challenge: which parts are audited this round.

    A pure function of the shared round id — every member derives the
    identical set with no coordinator, and no member (owner included)
    can influence it: the inputs are fixed before the round exists.
    ``frac`` is the per-part audit probability; >= 1 audits every
    part, <= 0 none.
    """
    if frac <= 0.0 or n_parts <= 0:
        return set()
    if frac >= 1.0:
        return set(range(n_parts))
    out: Set[int] = set()
    for k in range(n_parts):
        digest = hashlib.sha256(
            f"{prefix}:audit-challenge:{epoch}:{k}".encode()).digest()
        if int.from_bytes(digest[:8], "big") / float(1 << 64) < frac:
            out.add(k)
    return out


@dataclasses.dataclass(frozen=True)
class AuditPolicy:
    """Knobs of the audit layer (CollabConfig.audit_* wiring).

    ``frac`` is the per-part challenge probability per round (1.0 =
    every part every round — the soak setting; production swarms can
    sample). ``ttl`` bounds how long a transcript stays fetchable in
    the owner's mailbox; ``fetch_timeout``/``fetch_retries`` bound one
    auditor's patience per chunk. ``chunk_bytes`` splits large
    transcripts under the native 64 MiB frame cap.
    """

    frac: float = 1.0
    ttl: float = 120.0
    fetch_timeout: float = 3.0
    fetch_retries: int = 3
    chunk_bytes: int = 8 << 20

    def __post_init__(self):
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac must be in [0, 1], got {self.frac!r}")
        if self.ttl <= 0 or self.fetch_timeout <= 0:
            raise ValueError("ttl and fetch_timeout must be > 0")
        if self.fetch_retries < 1:
            raise ValueError("fetch_retries must be >= 1")
        if self.chunk_bytes < 1024:
            raise ValueError("chunk_bytes must be >= 1024")


class RoundAudit:
    """Per-round retention + transcript container.

    Created by the round's caller and handed to ``run_allreduce``,
    which fills it through the ``note_*`` hooks; after the round the
    caller (AuditWorker, or the soak's synchronous loop) runs
    :func:`audit_round` over it. All mutation happens on the round's
    receive thread; reads happen strictly after the round returns —
    the hand-off to the worker is the synchronization point.
    """

    def __init__(self, prefix: str, epoch: int,
                 policy: AuditPolicy = AuditPolicy()):
        self.prefix = prefix
        self.epoch = epoch
        self.policy = policy
        self.begun = False
        # filled by begin() from inside run_allreduce
        self.group = None
        self.owners: List = []
        self.my_part: Optional[int] = None
        self.part_sizes: List[int] = []
        self.chunk_elems = 0
        self.codec: Optional[int] = None
        self.gather_codec: Optional[int] = None
        self.pinned: Optional[int] = None
        self.adaptive_threshold = 0
        self.max_peer_weight: Optional[float] = None
        self.screen = None
        self.audited: Set[int] = set()
        # owner-side retention (my challenged part)
        self.frames: Dict[int, Dict[int, bytes]] = {}
        self.evidence: Dict[int, bytes] = {}
        self.drops: Dict[int, str] = {}
        self.order: List[int] = []
        self.init: str = "zeros"
        self.self_frames: List[bytes] = []
        self.withheld = False
        self.posted = False
        # collector-side retention
        self.gathered: Dict[int, np.ndarray] = {}
        #: part -> {chunk_idx: raw signed gather frame} — the OWNER-
        #: signed bytes this member applied. Two consumers: the repair
        #: plane (the served part that must be corrected is exactly
        #: these bytes' decode) and the proof-carrying receipt (the
        #: frames are the third-party-verifiable half of the evidence:
        #: the owner signed BOTH a transcript and a part the transcript
        #: cannot reproduce)
        self.gather_frames: Dict[int, Dict[int, bytes]] = {}
        #: part -> {chunk_idx: codec} the gathered chunks ACTUALLY
        #: arrived in (wire-header ground truth): the replay re-encodes
        #: with these, so an unpinned mixed-codec owner — who is free
        #: to serve its part in ITS config's codec —
        #: replays faithfully instead of being convicted for a codec
        #: choice. Under a pinned run the parse already guarantees
        #: these equal the pin.
        self.gather_codecs: Dict[int, Dict[int, int]] = {}
        self.scatter_ok: Set[int] = set()

    # -- hooks called by run_allreduce ---------------------------------

    def begin(self, group, owners, my_part: Optional[int],
              part_sizes: Sequence[int], chunk_elems: int,
              codec: Optional[int], adaptive_threshold: int,
              max_peer_weight: Optional[float], screen=None,
              gather_codec: Optional[int] = None,
              pinned: Optional[int] = None) -> None:
        """Called by ``run_allreduce`` with the ROUND'S context —
        codec (scatter AND gather legs),
        the scatter-leg ENFORCEMENT pin (``pinned``: None on rounds
        that accept mixed codecs — the replay must
        apply exactly the acceptance rule the round ran under, or
        honest owners of mixed-codec rounds get convicted), clamp,
        screen. The audit reads these back from here rather than
        having callers re-plumb them (a drifted clamp/screen would
        falsely convict honest owners)."""
        self.group = group
        self.owners = list(owners)
        self.my_part = my_part
        self.part_sizes = list(part_sizes)
        self.chunk_elems = chunk_elems
        self.codec = codec
        self.gather_codec = gather_codec
        self.pinned = pinned
        self.adaptive_threshold = adaptive_threshold
        self.max_peer_weight = max_peer_weight
        self.screen = screen
        self.audited = challenged_parts(self.prefix, self.epoch,
                                        len(self.owners), self.policy.frac)
        self.begun = True

    @property
    def audits_mine(self) -> bool:
        """Whether this peer's own part is challenged this round (the
        owner must retain and serve)."""
        return (self.begun and self.my_part is not None
                and self.my_part in self.audited)

    def note_init(self, kind: str) -> None:
        assert kind in ("self", "zeros")
        self.init = kind

    def note_frame(self, sender: int, ci: int, raw: bytes) -> None:
        self.frames.setdefault(sender, {})[ci] = raw

    def note_applied(self, sender: int) -> None:
        self.order.append(sender)

    def note_drop(self, sender: int, reason: str,
                  evidence: Optional[bytes] = None) -> None:
        self.drops[sender] = reason
        if evidence is not None:
            self.evidence[sender] = evidence

    def note_self(self, identity, ctx: bytes, group_hash: bytes,
                  my_index: int, weight: float, mine: np.ndarray,
                  chunks: Sequence[Tuple[int, int]]) -> None:
        """Self-sign this owner's own contribution with the EXACT codec
        (NONE): the local accumulate uses the raw f32 values, so the
        transcript's self-evidence must round-trip them bit-exactly
        regardless of the wire codec other senders used."""
        from dalle_tpu_torch.swarm import compression
        from dalle_tpu_torch.swarm.allreduce import _make_frame
        self.self_frames = []
        for ci, (clo, chi) in enumerate(chunks):
            payload = compression.compress(mine[clo:chi], compression.NONE)
            self.self_frames.append(_make_frame(
                identity, ctx, group_hash, my_index, weight, chi - clo,
                compression.NONE, payload, chunk=ci, n_chunks=len(chunks)))

    def note_withheld(self) -> None:
        self.withheld = True

    def note_gathered(self, part: int, values: np.ndarray) -> None:
        self.gathered[part] = np.array(values, np.float32, copy=True)

    def note_gather_codec(self, part: int, ci: int, codec: int) -> None:
        self.gather_codecs.setdefault(part, {})[ci] = codec

    def note_gather_frame(self, part: int, ci: int, raw: bytes) -> None:
        self.gather_frames.setdefault(part, {})[ci] = raw

    def note_scatter_ok(self, part: int) -> None:
        self.scatter_ok.add(part)

    # -- retention accounting (the byte-bounded repair ring) -----------

    def part_lo(self, part: int) -> int:
        """The part's offset in the round's flat gradient layout."""
        return int(sum(self.part_sizes[:part]))

    def retained_bytes(self) -> int:
        """Approximate host RAM this round's retention holds — the
        quantity the AuditWorker's byte-bounded pending ring evicts
        by. Counts every retained frame/evidence blob and the gathered
        part copies; bookkeeping (orders, codecs, sets) is noise."""
        n = 0
        for chunks in self.frames.values():
            n += sum(len(b) for b in chunks.values())
        n += sum(len(b) for b in self.evidence.values())
        n += sum(len(b) for b in self.self_frames)
        n += sum(int(a.nbytes) for a in self.gathered.values())
        for chunks in self.gather_frames.values():
            n += sum(len(b) for b in chunks.values())
        return n

    # -- transcript (owner side) ---------------------------------------

    def build_transcript(self, identity) -> bytes:
        """The signed transcript blob: msgpack payload under the
        (run, epoch, part)-bound signature context. Frames ship only
        for senders the replay needs (applied, screen-dropped, self);
        provable drops carry their offending frame as evidence;
        timeout drops ship reason-only (unprovable both ways)."""
        from dalle_tpu_torch.utils import msgpack

        from dalle_tpu_torch.swarm.identity import signed_frame
        need_frames = set(self.order)
        for s, reason in self.drops.items():
            if reason == "screen-outlier":
                need_frames.add(s)
        frames = {str(s): [self.frames[s][ci]
                           for ci in sorted(self.frames[s])]
                  for s in sorted(need_frames) if s in self.frames}
        my_index = self.group.my_index
        if self.self_frames:
            frames[str(my_index)] = list(self.self_frames)
        payload = msgpack.packb({
            "v": 1,
            "epoch": int(self.epoch),
            "part": int(self.my_part),
            "init": self.init,
            "order": [int(s) for s in self.order],
            "drops": {str(s): r for s, r in self.drops.items()},
            "evidence": {str(s): raw for s, raw in self.evidence.items()
                         if self.drops.get(s) in ("corrupt-chunk",
                                                  "weight-overclaim")},
            "frames": frames,
        }, use_bin_type=True)
        return signed_frame(
            identity, _audit_ctx(self.prefix, self.epoch, self.my_part),
            b"", payload)

    def post_transcript(self, dht) -> bool:
        """Publish the signed transcript into this owner's mailbox,
        chunked under ``chunk_bytes`` (native frame cap) and
        AEAD-wrapped under the round's group key like every data-plane
        message. Local-only work — no wire round-trips."""
        from dalle_tpu_torch.swarm.crypto import maybe_encrypt
        blob = self.build_transcript(dht.identity)
        step = self.policy.chunk_bytes
        pieces = [blob[o:o + step] for o in range(0, len(blob), step)] \
            or [b""]
        exp = time.time() + self.policy.ttl
        ok = True
        for ci, piece in enumerate(pieces):
            body = _TCHDR.pack(ci, len(pieces)) + piece
            wire = maybe_encrypt(self.group.group_key, body)
            ok = dht.post(_audit_tag(self.prefix, self.epoch,
                                     self.my_part, ci), wire, exp) and ok
        self.posted = ok
        return ok


# -- fetch + open (auditor side) -------------------------------------------

def fetch_transcript(dht, addr: str, prefix: str, epoch: int, part: int,
                     policy: AuditPolicy, group_key=None
                     ) -> Optional[bytes]:
    """Pull one owner's transcript chunks from its mailbox and
    reassemble the signed blob; None when the owner never served it
    (within the policy's patience)."""
    from dalle_tpu_torch.swarm.crypto import maybe_decrypt

    def one(ci: int) -> Optional[bytes]:
        for attempt in range(policy.fetch_retries):
            raw = dht.fetch(addr, _audit_tag(prefix, epoch, part, ci),
                            timeout=policy.fetch_timeout)
            body = maybe_decrypt(group_key, raw)
            if body is not None and len(body) >= _TCHDR.size:
                return body
            if attempt + 1 < policy.fetch_retries:
                time.sleep(0.1 * (attempt + 1))
        return None

    first = one(0)
    if first is None:
        return None
    ci0, n_chunks = _TCHDR.unpack_from(first)
    if ci0 != 0 or n_chunks < 1:
        return None
    pieces = [first[_TCHDR.size:]]
    for ci in range(1, n_chunks):
        body = one(ci)
        if body is None:
            return None
        gci, gn = _TCHDR.unpack_from(body)
        if gci != ci or gn != n_chunks:
            return None
        pieces.append(body[_TCHDR.size:])
    return b"".join(pieces)


def open_transcript(blob: bytes, prefix: str, epoch: int, part: int,
                    owner_pid: str) -> Optional[dict]:
    """Verify the owner's signature and STRICT-parse the payload;
    None on any failure (an unverifiable transcript is treated as
    unserved — silence semantics, never blame on unsigned bytes)."""
    from dalle_tpu_torch.utils import msgpack

    from dalle_tpu_torch.swarm.identity import open_frame
    opened = open_frame(bytes(blob), _audit_ctx(prefix, epoch, part), 0,
                        expected_pid=owner_pid)
    if opened is None:
        return None
    _head, payload, _signer = opened
    try:
        obj = msgpack.unpackb(payload, raw=False, strict_map_key=False)
        if set(obj) != {"v", "epoch", "part", "init", "order", "drops",
                        "evidence", "frames"}:
            return None
        if (int(obj["v"]) != 1 or int(obj["epoch"]) != epoch
                or int(obj["part"]) != part
                or obj["init"] not in ("self", "zeros")):
            return None
        return {
            "init": str(obj["init"]),
            "order": [int(s) for s in obj["order"]],
            "drops": {int(s): str(r) for s, r in obj["drops"].items()},
            "evidence": {int(s): bytes(raw)
                         for s, raw in obj["evidence"].items()},
            "frames": {int(s): [bytes(f) for f in fl]
                       for s, fl in obj["frames"].items()},
        }
    # the transcript plane is attacker-writable (any peer can stuff a
    # mailbox); unparseable content is exactly "unserved"
    # graftlint: disable=silent-except
    except Exception:  # noqa: BLE001 - any parse failure = no transcript
        return None


# -- replay (the heart of the audit) ---------------------------------------

@dataclasses.dataclass
class ReplayResult:
    """Outcome of replaying one transcript. ``ok`` False means the
    transcript cannot explain ANY honest round (the owner lied) —
    ``why`` says how. ``values`` is the replayed post-codec part
    (present iff ok); ``screen_drops`` is the replayed drop-set, the
    determinism surface the tests pin."""

    ok: bool
    why: str = ""
    values: Optional[np.ndarray] = None
    screen_drops: Dict[int, str] = dataclasses.field(default_factory=dict)


def replay_transcript(tr: dict, *, group, prefix: str, epoch: int,
                      part: int, part_elems: int, chunk_elems: int,
                      codec: Optional[int], adaptive_threshold: int,
                      screen=None, max_peer_weight: Optional[float] = None,
                      gather_codec: Optional[int] = None,
                      pinned: Optional[int] = None,
                      observed_codecs: Optional[Dict[int, int]] = None
                      ) -> ReplayResult:
    """Re-derive the averaged part from the transcript's signed inputs.

    Mirrors the owner path of ``run_allreduce`` operation for
    operation: frame verification via the same ``_parse``, the same
    weight clamp, the same screen decision (f64 statistics — bit-equal
    on every honest replayer), the same f32 accumulate in the
    transcript's recorded order, the same wire-codec round-trip. Any
    internal inconsistency — an unevidenced provable drop, a kept
    over-ceiling sender, a screen verdict the replay disagrees with —
    fails the replay outright: an honest owner's transcript never
    contains one.
    """
    from dalle_tpu_torch.swarm import compression
    from dalle_tpu_torch.swarm.allreduce import (_chunk_slices, _parse,
                                                 _sign_ctx)
    # the part -> member mapping: owners are the addressable members in
    # roster order, exactly as run_allreduce builds them
    owners = [m for m in group.members if m.addr]
    if not 0 <= part < len(owners):
        return ReplayResult(False, "no-such-part")
    owner_pid = owners[part].peer_id
    owner_index = next(i for i, m in enumerate(group.members)
                       if m.peer_id == owner_pid)
    chunks = _chunk_slices(part_elems, chunk_elems)
    ctx = _sign_ctx(prefix, epoch, "scatter", owner_pid)

    order = tr["order"]
    drops = tr["drops"]
    if set(order) & set(drops):
        return ReplayResult(False, "sender-both-applied-and-dropped")
    if len(set(order)) != len(order):
        return ReplayResult(False, "duplicate-sender-in-order")
    if owner_index in order:
        return ReplayResult(False, "owner-in-order")

    # 1. parse + verify every shipped frame set. Scatter frames face
    # exactly the acceptance rule the round ran under: the ENFORCED
    # pin when the run pinned its codec (a codec-flapping frame the
    # owner evidence-banned must replay as "bad"), the accept-any
    # rule otherwise (mixed-codec rounds are honest — convicting an
    # owner for applying a legitimately-coded frame would be a false
    # positive). The owner's SELF frames are always exempt — the
    # transcript protocol signs them with the exact NONE codec
    # whatever the wire pin is.
    parsed: Dict[int, Tuple[float, np.ndarray]] = {}
    for sender, raws in tr["frames"].items():
        if not (0 <= sender < group.size):
            return ReplayResult(False, "unknown-sender")
        seg = np.zeros(part_elems, np.float32)
        seen: Set[int] = set()
        w_claimed: Optional[float] = None
        bad = False
        for raw in raws:
            p = _parse(raw, group, chunks, ctx,
                       pinned=None if sender == owner_index else pinned)
            if p is None:
                return ReplayResult(False, "unverifiable-frame")
            status, psender, w, ci, data = p
            if psender != sender:
                return ReplayResult(False, "misfiled-frame")
            if status == "bad":
                bad = True
                continue
            if ci == 0:
                # the chunk-0 claim governs, mirroring apply_reduce —
                # a sender shipping inconsistent in-clamp weights
                # across its chunks must not be able to make an
                # honest owner's transcript unreplayable
                w_claimed = w
            if ci in seen:
                return ReplayResult(False, "duplicate-chunk")
            clo, chi = chunks[ci]
            seg[clo:chi] = data
            seen.add(ci)
        if bad:
            # a sender shipped as evidence of corruption: must be
            # dropped as such, never applied
            if drops.get(sender) != "corrupt-chunk":
                return ReplayResult(False, "bad-frame-not-dropped")
            continue
        if len(seen) == len(chunks) and w_claimed is not None:
            parsed[sender] = (w_claimed, seg)
        elif sender in order:
            return ReplayResult(False, "applied-sender-incomplete")

    # 2. drop-set consistency: provable reasons need verifying evidence
    for sender, reason in drops.items():
        if reason == "corrupt-chunk":
            ev = tr["evidence"].get(sender)
            p = _parse(ev, group, chunks, ctx, pinned=pinned) \
                if ev is not None else None
            if p is None or p[0] != "bad" or p[1] != sender:
                return ReplayResult(False, "unevidenced-corrupt-drop")
        elif reason == "weight-overclaim":
            ev = tr["evidence"].get(sender)
            p = _parse(ev, group, chunks, ctx, pinned=pinned) \
                if ev is not None else None
            if (p is None or p[0] != "ok" or p[1] != sender
                    or max_peer_weight is None
                    or 0.0 <= p[2] <= max_peer_weight):
                return ReplayResult(False, "unevidenced-overclaim-drop")
        elif reason == "screen-outlier":
            if sender != owner_index and sender not in parsed:
                return ReplayResult(False, "screen-drop-missing-frames")
        # timeout reasons: unprovable either way, accepted as claimed

    # 3. applied senders must obey the weight clamp the owner claims to
    # enforce (an over-claimed weight the owner kept is a lie)
    for sender in order:
        if sender not in parsed:
            return ReplayResult(False, "applied-sender-missing-frames")
        w = parsed[sender][0]
        if max_peer_weight is not None and not (0.0 <= w
                                                <= max_peer_weight):
            return ReplayResult(False, "kept-overclaimed-weight")

    # 4. the owner's own contribution
    own = parsed.get(owner_index)
    if tr["init"] == "self" and own is None:
        return ReplayResult(False, "init-self-without-self-frames")
    own_w = own[0] if own is not None else 0.0

    # 5. screen replay: same activation rule as run_allreduce — the
    # WEIGHTED ROSTER decides whether screening was required
    n_expected0 = sum(1 for m in group.members
                      if m.peer_id != group.members[owner_index].peer_id
                      and m.weight > 0)
    n_weighted = n_expected0 + (1 if own_w > 0 else 0)
    screen_active = (screen is not None
                     and n_weighted >= screen.policy.min_senders)
    claimed_screen = {s for s, r in drops.items() if r == "screen-outlier"}
    replay_drops: Dict[int, str] = {}
    if screen_active:
        complete = {s: parsed[s] for s in order}
        for s in claimed_screen:
            if s in parsed:
                complete[s] = parsed[s]
        if own is not None and own_w > 0:
            complete[owner_index] = own
        verdict = screen.screen(complete)
        replay_drops = dict(verdict.dropped)
        replay_drops.update(verdict.dropped_unstruck)
        if verdict.skipped:
            # deliveries below the screen quorum are WITHHELD, never
            # served: a transcript for such a round is itself the lie
            return ReplayResult(False, "under-delivered-part-served",
                                screen_drops=replay_drops)
        if set(replay_drops) != claimed_screen:
            return ReplayResult(False, "screen-replay-mismatch",
                                screen_drops=replay_drops)
        expect_init = ("self" if own_w > 0
                       and owner_index not in replay_drops else "zeros")
        if tr["init"] != expect_init:
            return ReplayResult(False, "wrong-init",
                                screen_drops=replay_drops)
        expect_order = [s for s in sorted(complete)
                        if s != owner_index and s not in replay_drops]
        if order != expect_order:
            return ReplayResult(False, "wrong-screened-order",
                                screen_drops=replay_drops)
    else:
        # streaming rules: only the absolute-norm ceiling applies (the
        # <4-sender narrowing), and a kept over-ceiling sender — the
        # OWNER'S OWN contribution included — is a lie
        ceiling = (screen.policy.abs_norm_ceiling
                   if screen is not None else 0.0)
        if ceiling > 0:
            for s in order:
                if screen.over_ceiling(parsed[s][1]):
                    return ReplayResult(False, "kept-over-ceiling-sender")
            if (tr["init"] == "self" and own_w > 0
                    and screen.over_ceiling(own[1])):
                # a below-quorum owner cannot mint itself a huge
                # "own contribution" to explain a poisoned part
                return ReplayResult(False, "kept-over-ceiling-sender")
            for s in claimed_screen:
                if s in parsed and not screen.over_ceiling(parsed[s][1]):
                    return ReplayResult(False, "ceiling-drop-not-over")
            replay_drops = {s: "abs-norm" for s in claimed_screen}
        elif claimed_screen:
            return ReplayResult(False, "screen-drop-without-screen")
        expect_init = ("zeros" if owner_index in claimed_screen
                       else "self")
        if tr["init"] != expect_init:
            # the streaming path initializes from the owner's own
            # contribution (weight may be 0) unless the owner
            # ceiling-dropped ITSELF
            return ReplayResult(False, "wrong-init")

    # 6. re-accumulate: identical f32 operation sequence as the owner
    if tr["init"] == "self":
        acc = own[1] * own_w
        total_w = own_w
    else:
        acc = np.zeros(part_elems, np.float32)
        total_w = 0.0
    for s in order:
        w, seg = parsed[s]
        acc += seg * w
        total_w += w
    if total_w <= 0:
        # the owner should have WITHHELD this part (dead-owner path);
        # serving bytes for it cannot be honest
        return ReplayResult(False, "zero-weight-part-served",
                            screen_drops=replay_drops)
    averaged = acc / total_w

    # 7. wire-codec round-trip with the GATHER leg's codec, chunk by
    # chunk, exactly as the gather phase applies its own broadcast
    # bytes locally. ``observed_codecs`` — what each gathered chunk's
    # wire header actually named (per-member ground truth: these ARE
    # the bytes the member applied) — takes precedence, so an unpinned
    # owner serving its config's codec replays faithfully; the
    # auditor-side dispatch is the fallback for synthetic replays.
    # Gather error-feedback never enters here: the carry-in is
    # suspended on challenged parts (error_feedback.py's determinism
    # contract), so an honest challenged owner served exactly
    # quantize(average).
    out = np.empty(part_elems, np.float32)
    g_pin = gather_codec if gather_codec is not None else codec
    for ci, (clo, chi) in enumerate(chunks):
        nelem = chi - clo
        c = (observed_codecs or {}).get(ci)
        if c is None:
            c = (g_pin if g_pin is not None
                 else compression.adaptive_codec(nelem,
                                                 adaptive_threshold))
        wire = compression.compress(averaged[clo:chi], c)
        out[clo:chi] = compression.decompress(wire, c, nelem)
    return ReplayResult(True, values=out, screen_drops=replay_drops)


# -- proof-carrying receipts (third-party verifiable convictions) ----------
#
# An ``owner-audit-fail`` verdict of the ``replayed-bytes-mismatch``
# class rests ENTIRELY on owner-signed bytes: the transcript (signed
# under the (run, epoch, part)-bound context) and the gather frames the
# issuer applied (signed under the round's gather context). Shipping
# both as receipt evidence lets ANY peer — in the round or not — rerun
# the replay and confirm the contradiction, upgrading the receipt from
# a bounded accusation (the ≤2.0 influence cap) to a PROOF that
# convicts on its own. The roster the evidence claims is authenticated
# by the group hash bound into every signed frame header; structural
# claims a hostile issuer could lie about (part size, weights, flags)
# are fail-safe by construction: the verifier convicts ONLY when its
# own replay succeeds AND the replayed bytes contradict the evidence
# frames — both pure functions of owner-signed data plus the
# verifier's OWN config — so a lie anywhere else can only make an
# honest owner's evidence fail verification (falling back to the
# capped influence), never convict one. Config-dependent replay
# failures (screen/clamp/codec drift) are likewise treated as
# UNVERIFIED, under the same run-config-homogeneity contract the
# audit already documents.


def build_proof_evidence(ra: RoundAudit, part: int,
                         transcript_blob: bytes,
                         limit: Optional[int] = None) -> Optional[bytes]:
    """The evidence bundle for one ``replayed-bytes-mismatch``
    conviction: the owner-signed transcript + the owner-signed gather
    frames this member applied, plus the (group-hash-authenticated)
    roster a verifier needs to rebuild the round context. None when the
    retention is incomplete (a partial frame set cannot prove a
    mismatch to a third party).

    ``limit`` caps the built bundle: None means ``PROOF_MAX_BYTES``
    (the inline-receipt bound — without an evidence plane a larger
    blob would only be built for the gossip to drop), <= 0 means
    unbounded (the by-reference plane serves bundles of any size
    from the issuer's mailbox)."""
    from dalle_tpu_torch.utils import msgpack

    from dalle_tpu_torch.swarm.health import PROOF_MAX_BYTES
    frames = ra.gather_frames.get(part)
    if not frames or ra.group is None:
        return None
    n_chunks = len(_chunk_slices_for(ra.part_sizes[part],
                                     ra.chunk_elems))
    if set(frames) != set(range(n_chunks)):
        return None
    cap = PROOF_MAX_BYTES if limit is None else limit
    body = sum(len(b) for b in frames.values()) + len(transcript_blob)
    if cap > 0 and body > cap:
        # flagship-size parts cannot ship inline evidence and no
        # by-reference plane is armed: skip BUILDING the
        # multi-hundred-MB blob the gossip would only drop against
        # the cap — the conviction degrades to the capped receipt
        logger.warning(
            "proof evidence for part %d is %d bytes (> %d): receipt "
            "will carry no proof", part, body, cap)
        return None
    return msgpack.packb({
        "v": 1,
        "prefix": ra.prefix,
        "epoch": int(ra.epoch),
        "part": int(part),
        "part_elems": int(ra.part_sizes[part]),
        "members": [[m.peer_id, 1 if m.addr else 0, float(m.weight)]
                    for m in ra.group.members],
        "group_hash": bytes(ra.group.group_hash),
        "transcript": bytes(transcript_blob),
        "frames": [bytes(frames[ci]) for ci in range(n_chunks)],
    }, use_bin_type=True)


def _chunk_slices_for(n: int, chunk_elems: int):
    from dalle_tpu_torch.swarm.allreduce import _chunk_slices
    return _chunk_slices(n, chunk_elems)


# -- evidence by reference -------------------------------------------------
#
# Past PROOF_MAX_BYTES a receipt cannot embed its evidence, and before
# this plane it degraded to the capped accusation — a flagship-scale
# (hundreds of MB) conviction could never ship its proof. Now the
# receipt carries a ~100-byte DESCRIPTOR instead: the bundle's sha256
# digest, its exact size/chunking, and the issuer's mailbox address.
# The issuer parks the chunked bundle in its mailbox
# (state_transfer-style framing: the same (chunk_idx, n_chunks) header
# the transcript plane uses, under digest-derived tags), and any
# verifier fetches, hash-checks BEFORE any sized allocation or parse,
# then replays under the existing all-or-nothing predicate. A peer
# that verified a fetched bundle re-serves it from its own mailbox and
# advertises under ``{prefix}_evsrv`` so later verifiers fail over
# when the issuer churns out. Unfetchable or digest-mismatched
# evidence has NO ledger effect (the receipt is dropped outright); an
# issuer that cannot park the bundle at all (unroutable, mailbox post
# failure) falls back to publishing the plain capped accusation.

#: how long a parked evidence bundle stays fetchable; re-posted by the
#: serving worker while retained, so the effective window is the
#: retention, not one TTL
EVIDENCE_SERVE_TTL = 300.0

#: sanity bounds a descriptor must satisfy before any fetch I/O — the
#: receipt plane is attacker-writable
_EVREF_MAX_CHUNKS = 65536
_EVREF_MAX_CHUNK_BYTES = 64 << 20  # the native frame cap


def evidence_servers_key(prefix: str) -> str:
    """The DHT key under which verified re-servers advertise
    (subkey ``{digest_hex}.{peer_id}`` -> mailbox address)."""
    return f"{prefix}_evsrv"


def _evidence_tag(digest: bytes, chunk: int) -> int:
    d = hashlib.sha256(b"evidence:" + digest
                       + struct.pack(">I", chunk)).digest()
    return int.from_bytes(d[:8], "big")


def parse_evidence_ref(obj: dict, max_bytes: int) -> Optional[dict]:
    """STRICT-validate a by-reference descriptor. None on anything
    malformed or over budget — notably an oversize claim is rejected
    HERE, before any allocation or wire I/O happens for it."""
    try:
        digest = bytes(obj["digest"])
        size = int(obj["size"])
        n_chunks = int(obj["n_chunks"])
        chunk = int(obj["chunk"])
        addr = str(obj["addr"])
    # attacker-writable plane: malformed is exactly "unverifiable"
    # graftlint: disable=silent-except
    except Exception:  # noqa: BLE001 - any parse failure = reject
        return None
    if len(digest) != 32 or not 0 < size <= max_bytes:
        return None
    if not 1024 <= chunk <= _EVREF_MAX_CHUNK_BYTES:
        return None
    if n_chunks != (size + chunk - 1) // chunk \
            or n_chunks > _EVREF_MAX_CHUNKS:
        return None
    if len(addr) > 256:
        return None
    return {"digest": digest, "size": size, "n_chunks": n_chunks,
            "chunk": chunk, "addr": addr}


class EvidencePlane:
    """Serve + fetch half of the by-reference proof plane.

    **Serve** (issuer side): :meth:`publish` chunks a bundle into this
    peer's mailbox under digest-derived tags, advertises this peer
    under :func:`evidence_servers_key`, retains the bundle (bounded
    bytes, oldest-first eviction) and returns the msgpack descriptor
    the receipt embeds; None when the mailbox post fails — the caller
    degrades to the capped accusation. A verifier that replayed a
    fetched bundle to a conviction calls ``publish(..., reserve=True)``
    so the evidence survives the issuer churning out (failover).

    **Fetch** (verifier side): :meth:`fetch` resolves a validated
    descriptor to the full bundle. Requests are deduplicated by digest
    in an in-flight table and executed by ONE background worker
    thread, so the caller's wait is hard-bounded by ``budget_s`` even
    when a mailbox read wedges; each candidate server (issuer first,
    then advertised re-servers) is pulled completely and independently
    — chunks are never mixed across servers, a half-poisoned server
    cannot corrupt a fetch another server could have satisfied — with
    capped per-chunk retries and exponential backoff. The assembled
    bytes are length- and sha256-checked against the descriptor BEFORE
    they are returned (and so before any parse or sized allocation
    downstream).

    Thread roles: public methods run on their callers (gossip thread,
    tests); ``_run`` is the fetch/refresh worker. Every shared field
    below is guarded by ``_cv`` through *visible* ``with self._cv:``
    blocks — deliberately NOT ``guarded-by`` annotations, so
    a lockset analysis can prove the guarding rather than
    trusting a declaration (and a dropped lock is a lint error, not a
    silent regression). The worker thread is started last in
    ``__init__`` so field initialization happens-before its first read.
    """

    def __init__(self, dht, prefix: str, *,
                 max_bytes: int = 1 << 30, budget_s: float = 30.0,
                 retries: int = 3, fetch_timeout: float = 2.0,
                 chunk_bytes: int = 8 << 20,
                 serve_ttl: float = EVIDENCE_SERVE_TTL,
                 serve_max_bytes: int = 1 << 30, tracer=None):
        self._dht = dht
        self.prefix = prefix
        self.max_bytes = int(max_bytes)
        self.budget_s = float(budget_s)
        self.retries = max(1, int(retries))
        self.fetch_timeout = float(fetch_timeout)
        self.chunk_bytes = int(chunk_bytes)
        self.serve_ttl = float(serve_ttl)
        self.serve_max_bytes = int(serve_max_bytes)
        self._tracer = tracer
        self._cv = threading.Condition()
        # digest -> retained bundle bytes this peer serves (issuer or
        # verified re-server); insertion-ordered for byte eviction
        self._served: Dict[bytes, bytes] = {}
        self._served_bytes = 0
        # digest -> in-flight fetch job (dedup: concurrent verifiers of
        # the same bundle share one wire fetch)
        self._inflight: Dict[bytes, dict] = {}
        self._jobs: deque = deque()
        self._stop = False
        # observability counters (surfaced as proof_fetch_* in the
        # robustness snapshot) — written under _cv from both roles
        self.fetch_attempted = 0
        self.fetch_ok = 0
        self.fetch_failed = 0
        self.fetch_timeouts = 0
        self.fetch_failover = 0
        self.fetch_cached = 0
        self.fetch_bytes = 0
        self.published = 0
        self.reserved = 0
        self.publish_failed = 0
        self._refresh_due = time.monotonic() + self.serve_ttl / 4
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="evidence-fetch")
        self._thread.start()

    # -- serve half (issuer / verified re-server) ----------------------

    def publish(self, bundle: bytes, reserve: bool = False
                ) -> Optional[bytes]:
        """Park ``bundle`` in this peer's mailbox and return the
        descriptor bytes a receipt embeds; None when the post or the
        advertisement fails (the caller falls back to the capped
        accusation). Idempotent per digest — re-publishing refreshes
        the TTL instead of duplicating retention."""
        from dalle_tpu_torch.utils import msgpack
        bundle = bytes(bundle)
        digest = hashlib.sha256(bundle).digest()
        addr = getattr(self._dht, "visible_address", "")
        if not addr:
            with self._cv:
                self.publish_failed += 1
            logger.warning("evidence publish: no reachable mailbox "
                           "address — receipt degrades to the capped "
                           "accusation")
            return None
        step = self.chunk_bytes
        pieces = [bundle[o:o + step]
                  for o in range(0, len(bundle), step)] or [b""]
        if not self._post_chunks(digest, pieces):
            with self._cv:
                self.publish_failed += 1
            return None
        self._advertise(digest, addr)
        with self._cv:
            if digest not in self._served:
                self._retain_locked(digest, bundle)
            if reserve:
                self.reserved += 1
            else:
                self.published += 1
        from dalle_tpu_torch.obs.trace import span
        with span(self._tracer, "swarm", "proof_serve",
                  f"{self.prefix}:evidence:{digest.hex()[:12]}",
                  bytes=len(bundle), chunks=len(pieces),
                  reserve=bool(reserve)):
            pass
        return msgpack.packb(
            {"v": 2, "byref": 1, "digest": digest, "size": len(bundle),
             "n_chunks": len(pieces), "chunk": step, "addr": addr},
            use_bin_type=True)

    def _post_chunks(self, digest: bytes, pieces: List[bytes]) -> bool:
        exp = time.time() + self.serve_ttl
        ok = True
        for ci, piece in enumerate(pieces):
            body = _TCHDR.pack(ci, len(pieces)) + piece
            try:
                ok = self._dht.post(_evidence_tag(digest, ci), body,
                                    exp) and ok
            # a raising post is a failing post: the descriptor must
            # not name chunks nobody can fetch
            # graftlint: disable=silent-except
            except Exception:  # noqa: BLE001 - degrade, don't die
                ok = False
        return ok

    def _advertise(self, digest: bytes, addr: str) -> None:
        from dalle_tpu_torch.swarm.dht import get_dht_time
        try:
            self._dht.store(
                evidence_servers_key(self.prefix),
                f"{digest.hex()}.{self._dht.peer_id}", addr,
                expiration_time=get_dht_time() + self.serve_ttl)
        # advertisement is best-effort: the issuer addr in the
        # descriptor still serves
        # graftlint: disable=silent-except
        except Exception:  # noqa: BLE001
            pass

    def _retain_locked(self, digest: bytes, bundle: bytes) -> None:
        # caller holds _cv
        self._served[digest] = bundle
        self._served_bytes += len(bundle)
        while self._served_bytes > self.serve_max_bytes \
                and len(self._served) > 1:
            old, blob = next(iter(self._served.items()))
            del self._served[old]
            self._served_bytes -= len(blob)

    # -- fetch half (verifier side) ------------------------------------

    def fetch(self, ref: dict) -> Optional[bytes]:
        """Resolve a :func:`parse_evidence_ref`-validated descriptor to
        the full, digest-checked bundle; None on any failure within
        the hard time budget. Never raises."""
        digest = ref["digest"]
        deadline = time.monotonic() + self.budget_s
        with self._cv:
            cached = self._served.get(digest)
            if cached is not None:
                self.fetch_cached += 1
                return cached
            job = self._inflight.get(digest)
            if job is None:
                job = {"ref": dict(ref), "deadline": deadline,
                       "done": False, "blob": None, "failover": False}
                self._inflight[digest] = job
                self._jobs.append(job)
                self.fetch_attempted += 1
                self._cv.notify_all()
            else:
                # a later caller may extend the worker's patience, never
                # shrink it under the first caller
                job["deadline"] = max(job["deadline"], deadline)
            while not job["done"]:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=min(0.2, left))
            if not job["done"]:
                self.fetch_timeouts += 1
                return None
            return job["blob"]

    # -- worker --------------------------------------------------------

    def _run(self) -> None:
        while True:
            job = None
            with self._cv:
                while not self._jobs and not self._stop:
                    self._cv.wait(timeout=0.2)
                    if time.monotonic() >= self._refresh_due:
                        break
                if self._stop and not self._jobs:
                    return
                if self._jobs:
                    job = self._jobs.popleft()
            if job is None:
                self._refresh_serves()
                continue
            from dalle_tpu_torch.obs.trace import span
            digest = job["ref"]["digest"]
            with span(self._tracer, "swarm", "proof_fetch",
                      f"{self.prefix}:evidence:{digest.hex()[:12]}",
                      size=job["ref"]["size"]) as sp:
                blob = self._fetch_job(job)
                sp.set(ok=blob is not None,
                       failover=bool(job.get("failover")))
            with self._cv:
                job["blob"] = blob
                job["done"] = True
                self._inflight.pop(digest, None)
                if blob is not None:
                    self.fetch_ok += 1
                    self.fetch_bytes += len(blob)
                    if job.get("failover"):
                        self.fetch_failover += 1
                    self._retain_locked(digest, blob)
                else:
                    self.fetch_failed += 1
                self._cv.notify_all()

    def _servers_for(self, ref: dict) -> List[str]:
        servers = [ref["addr"]] if ref["addr"] else []
        try:
            ads = self._dht.get(evidence_servers_key(self.prefix)) or {}
        # the advert plane is best-effort; the issuer addr remains
        # graftlint: disable=silent-except
        except Exception:  # noqa: BLE001
            ads = {}
        want = ref["digest"].hex() + "."
        for sk in sorted(ads):
            skey = sk.decode() if isinstance(sk, bytes) else str(sk)
            if not skey.startswith(want):
                continue
            v = ads[sk].value
            if isinstance(v, str) and v and v not in servers:
                servers.append(v)
        return servers

    def _fetch_job(self, job: dict) -> Optional[bytes]:
        ref = job["ref"]
        servers = self._servers_for(ref)
        for si, server in enumerate(servers):
            with self._cv:
                if self._stop:
                    return None
            if time.monotonic() >= job["deadline"]:
                return None  # hard time budget
            blob = self._pull_from(server, ref, job)
            if blob is not None:
                if si > 0:
                    job["failover"] = True
                return blob
            logger.warning(
                "evidence fetch: server %s could not satisfy digest "
                "%s — %s", server, ref["digest"].hex()[:12],
                "failing over" if si + 1 < len(servers)
                else "giving up")
        return None

    def _pull_from(self, addr: str, ref: dict, job: dict
                   ) -> Optional[bytes]:
        """One server, pulled completely: per-chunk capped retries with
        exponential backoff, the CLAIMED size as the byte budget, and
        the digest check before any caller sees a byte."""
        digest, size = ref["digest"], ref["size"]
        n_chunks, step = ref["n_chunks"], ref["chunk"]
        pieces: List[bytes] = []
        got = 0
        for ci in range(n_chunks):
            body = None
            backoff = 0.1
            for attempt in range(self.retries):
                left = job["deadline"] - time.monotonic()
                if left <= 0:
                    return None
                try:
                    raw = self._dht.fetch(
                        addr, _evidence_tag(digest, ci),
                        timeout=min(self.fetch_timeout,
                                    max(0.1, left)))
                # a raising transport is a missing chunk (retry/fail)
                # graftlint: disable=silent-except
                except Exception:  # noqa: BLE001
                    raw = None
                if raw is not None and len(raw) >= _TCHDR.size:
                    gci, gn = _TCHDR.unpack_from(raw)
                    if gci == ci and gn == n_chunks \
                            and len(raw) - _TCHDR.size <= step:
                        body = bytes(raw[_TCHDR.size:])
                        break
                if attempt + 1 < self.retries:
                    time.sleep(min(backoff, max(
                        0.0, job["deadline"] - time.monotonic())))
                    backoff *= 2
            if body is None:
                return None
            got += len(body)
            if got > size:
                return None  # stream over the claimed size: poisoned
            pieces.append(body)
        blob = b"".join(pieces)
        if len(blob) != size:
            return None  # truncated stream
        if hashlib.sha256(blob).digest() != digest:
            return None  # forged/substituted content
        return blob

    def _refresh_serves(self) -> None:
        """Periodic TTL refresh of every retained bundle's mailbox
        chunks + advertisement, so a bundle outlives one serve TTL for
        as long as it stays retained."""
        with self._cv:
            self._refresh_due = time.monotonic() + self.serve_ttl / 4
            batch = list(self._served.items())
        addr = getattr(self._dht, "visible_address", "")
        for digest, bundle in batch:
            step = self.chunk_bytes
            pieces = [bundle[o:o + step]
                      for o in range(0, len(bundle), step)] or [b""]
            self._post_chunks(digest, pieces)
            if addr:
                self._advertise(digest, addr)

    def counters(self) -> Dict[str, int]:
        with self._cv:
            return {
                "attempted": self.fetch_attempted,
                "ok": self.fetch_ok,
                "failed": self.fetch_failed,
                "timeouts": self.fetch_timeouts,
                "failover": self.fetch_failover,
                "cached": self.fetch_cached,
                "bytes": self.fetch_bytes,
                "published": self.published,
                "reserved": self.reserved,
                "publish_failed": self.publish_failed,
            }

    def stop(self, join_timeout: Optional[float] = 10.0) -> None:
        """Signal AND (bounded) join before the owner tears the DHT
        down — an in-flight mailbox read on a destroyed native node is
        a use-after-free."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if join_timeout is not None and self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout)


class _ProofMember:
    __slots__ = ("peer_id", "addr", "weight")

    def __init__(self, peer_id: str, addr: str, weight: float):
        self.peer_id = peer_id
        self.addr = addr
        self.weight = weight


class _ProofGroup:
    """The minimal AveragingGroup stand-in the replay machinery reads
    (members / size / group_hash) — rebuilt from proof evidence."""

    def __init__(self, members, group_hash: bytes):
        self.members = members
        self.group_hash = group_hash

    @property
    def size(self) -> int:
        return len(self.members)


class ProofVerifier:
    """Independent re-verification of proof-carrying receipts.

    One per peer, configured with the verifier's OWN round context
    (codec/pin/screen/clamp — the run-config-homogeneity contract; an
    issuer-supplied context would let a hostile issuer frame honest
    owners). ``__call__`` is the :class:`~dalle_tpu_torch.swarm.health
    .StrikeGossip` hook: True iff the evidence independently proves
    the accused owner served a part its own signed transcript cannot
    reproduce. Every False is a REJECTION — the receipt folds with at
    most the capped influence (or, for the gossip's all-or-nothing
    proof rule, not at all); it never convicts.
    """

    #: how far the receipt's (ledger-clock) epoch may sit from the
    #: evidence's round epoch: audits run asynchronously and the
    #: issuer stamps the receipt with its LEDGER clock at conviction
    #: time, so the two legitimately skew by up to the AuditWorker's
    #: whole pending ring (MAX_PENDING rounds) plus a little gossip
    #: lag — but an OLD proof re-wrapped under a fresh receipt epoch
    #: (the replay attack that would re-convict a long-reformed peer
    #: forever) lands far outside this slack and is rejected
    EPOCH_SLACK = 10  # AuditWorker.MAX_PENDING (8) + gossip lag

    def __init__(self, run_prefix: str, *, frac: float,
                 chunk_elems: int, codec: Optional[int] = None,
                 adaptive_threshold: int = 0, screen=None,
                 max_peer_weight: Optional[float] = None,
                 gather_codec: Optional[int] = None,
                 pinned: Optional[int] = None,
                 phase_overrides: Optional[Dict[str, dict]] = None,
                 fetcher: Optional["EvidencePlane"] = None):
        self.run_prefix = run_prefix
        self.frac = frac
        self.chunk_elems = chunk_elems
        self.codec = codec
        self.adaptive_threshold = adaptive_threshold
        self.screen = screen
        self.max_peer_weight = max_peer_weight
        self.gather_codec = gather_codec
        self.pinned = pinned
        #: optional by-reference resolver (EvidencePlane): without
        #: it, a by-reference receipt is rejected (fail-safe — no
        #: ledger effect), exactly like any other unverifiable proof
        self.fetcher = fetcher
        #: phase -> {codec/gather_codec/pinned/screen/...} replay-knob
        #: overrides: the auxiliary phases (PowerSGD factors, state
        #: averaging) run the same butterfly under DIFFERENT codec
        #: config, and a proof must be judged under the config its
        #: phase runs with (an always-reject here would only fail safe,
        #: but would blind this peer to aux-phase proofs)
        self.phase_overrides = dict(phase_overrides or {})
        self.verified = 0       # observability counters
        self.rejected = 0

    def _knob(self, phase: str, name: str):
        over = self.phase_overrides.get(phase)
        if over is not None and name in over:
            return over[name]
        return getattr(self, name)

    def _reject(self, why: str) -> Optional[str]:
        self.rejected += 1
        logger.warning("proof receipt rejected: %s", why)
        return None

    def __call__(self, proof: bytes, accused: str,
                 epoch: int) -> Optional[str]:
        """The verified evidence's round PREFIX on success (truthy —
        the gossip folds it into the proven-strike dedup ref so
        per-phase convictions stay distinguishable), None on any
        rejection."""
        from dalle_tpu_torch.utils import msgpack

        from dalle_tpu_torch.swarm.allreduce import _parse, _sign_ctx
        try:
            obj = msgpack.unpackb(bytes(proof), raw=False)
        # the proof plane is attacker-writable; malformed evidence is
        # exactly "unverifiable"
        except Exception:  # noqa: BLE001 - any parse failure = reject
            return self._reject("malformed evidence")
        fetched: Optional[bytes] = None
        if isinstance(obj, dict) and obj.get("byref"):
            # evidence by reference: the receipt carried a digest +
            # mailbox descriptor instead of inline bytes. Resolve it —
            # validation (oversize claims die before any allocation),
            # budgeted fetch with failover, digest check — then judge
            # the fetched bundle under the unchanged all-or-nothing
            # predicate below. Any fetch failure is a rejection with
            # zero ledger effect.
            if self.fetcher is None:
                return self._reject(
                    "by-reference evidence with no fetch plane armed")
            ref = parse_evidence_ref(obj, self.fetcher.max_bytes)
            if ref is None:
                return self._reject(
                    "malformed or over-budget evidence reference")
            fetched = self.fetcher.fetch(ref)
            if fetched is None:
                return self._reject(
                    "evidence unfetchable within budget (digest "
                    f"{ref['digest'].hex()[:12]})")
            try:
                obj = msgpack.unpackb(fetched, raw=False)
            # fetched bytes matched the signed digest but do not
            # parse: the ISSUER parked garbage — still just a reject
            except Exception:  # noqa: BLE001
                return self._reject("fetched evidence does not parse")
        try:
            prefix = str(obj["prefix"])
            p_epoch = int(obj["epoch"])
            part = int(obj["part"])
            part_elems = int(obj["part_elems"])
            members = [_ProofMember(str(pid), "o" if int(flag) else "",
                                    float(w))
                       for pid, flag, w in obj["members"]]
            group_hash = bytes(obj["group_hash"])
            blob = bytes(obj["transcript"])
            frames = [bytes(f) for f in obj["frames"]]
        # the proof plane is attacker-writable; malformed evidence is
        # exactly "unverifiable"
        except Exception:  # noqa: BLE001 - any parse failure = reject
            return self._reject("malformed evidence")
        # the proof must name THIS run: the receipt context already
        # binds the run prefix, and the audit prefix must be the run
        # itself or one of its phase prefixes (grads / powersgd factor
        # / state averaging)
        if not (prefix == self.run_prefix
                or prefix.startswith(self.run_prefix + "_")):
            return self._reject(f"foreign round prefix {prefix!r}")
        if abs(p_epoch - epoch) > self.EPOCH_SLACK:
            # stale/replayed evidence: a receipt re-dated to a live
            # epoch must not resurrect an old round's proof (the
            # slack covers the async audit's legitimate clock skew)
            return self._reject("evidence epoch far from receipt epoch")
        if part_elems <= 0 or not members:
            return self._reject("degenerate round context")
        # plausibility bounds BEFORE any sized allocation: the proof
        # plane is attacker-writable, and the claimed part size must
        # be payable by the evidence itself (even the densest codec
        # spends >= half a byte per element on its gather frames; an
        # inline receipt is capped at PROOF_MAX_BYTES, a fetched
        # bundle at its digest-checked actual size, which the fetch
        # budget already bounded) — without this, a tiny receipt
        # claiming part_elems ~ 1e13 would have the gossip worker
        # attempt a multi-TB np.empty per poll
        from dalle_tpu_torch.swarm.health import PROOF_MAX_BYTES
        bound = max(PROOF_MAX_BYTES,
                    len(fetched) if fetched is not None else 0)
        if part_elems > 2 * bound or len(members) > 4096:
            return self._reject("implausible round context")
        # roster authentication: the group hash bound into every signed
        # frame header commits to the member ids — the ONE formula
        # matchmaking defines (it reads only peer_id, so the proof
        # members satisfy it)
        from dalle_tpu_torch.swarm.matchmaking import group_hash_of
        if group_hash_of(members) != group_hash:
            return self._reject("roster does not hash to the group")
        owners = [m for m in members if m.addr]
        if not 0 <= part < len(owners):
            return self._reject("no such part")
        if owners[part].peer_id != accused:
            return self._reject("accused is not the part owner")
        if part not in challenged_parts(prefix, p_epoch, len(owners),
                                        self.frac):
            # an unchallenged owner owed nobody a transcript: a
            # "proof" about one is a fabrication attempt by
            # construction
            return self._reject("part was never challenged")
        tr = open_transcript(blob, prefix, p_epoch, part,
                             owners[part].peer_id)
        if tr is None:
            return self._reject("transcript does not verify")
        group = _ProofGroup(members, group_hash)
        owner_index = next(i for i, m in enumerate(members)
                           if m.peer_id == accused)
        chunks = _chunk_slices_for(part_elems, self.chunk_elems)
        if len(frames) != len(chunks):
            return self._reject("gather frame count != part chunking")
        gather_ctx = _sign_ctx(prefix, p_epoch, "gather")
        served = np.empty(part_elems, np.float32)
        observed: Dict[int, int] = {}
        seen: Set[int] = set()
        for raw in frames:
            # evidence frames are judged accept-any (pinned=None): they
            # are what the issuer APPLIED, and the replay re-encodes
            # with their observed codecs — an unpinned mixed-codec
            # owner's proof must verify too
            parsed = _parse(raw, group, chunks, gather_ctx)
            if parsed is None or parsed[0] != "ok":
                return self._reject("gather frame does not verify")
            _status, sender, _w, ci, data = parsed
            if sender != owner_index:
                # a frame the accused never signed (or another part's
                # owner): transcript-frame mismatch
                return self._reject("gather frame not owner-signed")
            if ci in seen:
                return self._reject("duplicate gather chunk")
            clo, chi = chunks[ci]
            served[clo:chi] = data
            seen.add(ci)
            from dalle_tpu_torch.swarm.allreduce import _HDR
            observed[ci] = _HDR.unpack_from(raw)[6]
        if len(seen) != len(chunks):
            return self._reject("incomplete gather frame set")
        phase = phase_of_prefix(prefix)
        res = replay_transcript(
            tr, group=group, prefix=prefix, epoch=p_epoch, part=part,
            part_elems=part_elems, chunk_elems=self.chunk_elems,
            codec=self._knob(phase, "codec"),
            adaptive_threshold=self.adaptive_threshold,
            screen=self._knob(phase, "screen"),
            max_peer_weight=self.max_peer_weight,
            gather_codec=self._knob(phase, "gather_codec"),
            pinned=self._knob(phase, "pinned"),
            observed_codecs=observed)
        if not res.ok:
            # an inconsistent transcript under MY config is
            # inconclusive from outside the round (config drift and
            # issuer lies about roster weights both land here):
            # conviction needs the unambiguous signed contradiction
            return self._reject(f"replay not conclusive ({res.why})")
        if res.values.tobytes() == served.tobytes():
            return self._reject("served bytes match the replay "
                                "(no contradiction)")
        self.verified += 1
        if fetched is not None and self.fetcher is not None:
            # this peer just REPLAYED the fetched bundle to a
            # conviction: re-serve it from its own mailbox and
            # advertise, so later verifiers fail over here when the
            # issuer churns out (best-effort — a failed re-post only
            # loses the failover, never the conviction)
            self.fetcher.publish(fetched, reserve=True)
        return prefix


# -- the audit pass (auditor side) -----------------------------------------

def audit_round(dht, ra: RoundAudit, ledger, *, jobs: int = 1,
                repair=None,
                evidence_limit: Optional[int] = None) -> dict:
    """Audit every challenged part this peer fully gathered: fetch the
    owner's transcript, replay it, bit-compare, and strike. Also runs
    the sender-side omission check for parts this peer's own
    contribution was transport-acked into. Returns an observability
    report; strikes land in ``ledger`` (gossipable reasons queue
    receipts there automatically).

    ``repair`` (optional :class:`~dalle_tpu_torch.swarm.repair.RepairPlane`)
    arms the correction path: a ``replayed-bytes-mismatch`` conviction
    — the one class whose replay SUCCEEDED, so the honest part bytes
    were recomputed bit-exactly — queues ``honest - served`` for the
    optimizer to apply (pre-step assign when it beats the apply,
    bounded-staleness compensation after; swarm/repair.py). The same
    class attaches the owner-signed transcript + gather frames to its
    ledger strike as PROOF evidence, so the gossiped receipt convicts
    at any verifying peer without local corroboration.

    The replay judges owners by the ROUND'S recorded context
    (``ra.screen``/``ra.max_peer_weight``/codec — captured by
    ``begin()``), never by caller-supplied values: a clamp or screen
    that drifted between the round and a deferred audit would
    otherwise falsely convict honest owners.

    ``jobs`` > 1 fans the per-part audits out over a thread pool —
    replay is a pure function of (transcript, group, round context),
    so parallel audits are bit-equal to serial ones (pinned by test).
    """
    report = {"epoch": ra.epoch, "audited": [], "ok": [], "failed": [],
              "omitted": [], "unserved": [],
              # host seconds by stage, summed over parts (the port's
              # addition): fetch + AEAD open, transcript signature and
              # parse, replay (frame signatures, decode, re-accumulate,
              # re-encode, compare)
              "stage_s": {"fetch": 0.0, "open": 0.0, "replay": 0.0}}
    if not ra.begun:
        return report
    my_index = ra.group.my_index
    todo = [p for p in sorted(ra.audited)
            if p != ra.my_part and p in ra.gathered]

    def audit_one(p: int) -> Tuple[int, str, str, Dict[int, str],
                                   Optional[np.ndarray],
                                   Optional[bytes]]:
        owner = ra.owners[p]
        t0 = time.monotonic()
        blob = fetch_transcript(dht, owner.addr, ra.prefix, ra.epoch, p,
                                ra.policy, group_key=ra.group.group_key)
        t1 = time.monotonic()
        tr = (open_transcript(blob, ra.prefix, ra.epoch, p,
                              owner.peer_id)
              if blob is not None else None)
        t2 = time.monotonic()
        stages = report["stage_s"]
        stages["fetch"] += t1 - t0
        stages["open"] += t2 - t1
        if tr is None:
            return p, "unserved", "", {}, None, None
        res = replay_transcript(
            tr, group=ra.group, prefix=ra.prefix, epoch=ra.epoch,
            part=p, part_elems=ra.part_sizes[p],
            chunk_elems=ra.chunk_elems, codec=ra.codec,
            adaptive_threshold=ra.adaptive_threshold, screen=ra.screen,
            max_peer_weight=ra.max_peer_weight,
            gather_codec=ra.gather_codec, pinned=ra.pinned,
            observed_codecs=ra.gather_codecs.get(p))
        mismatch = res.ok and (res.values.tobytes()
                               != ra.gathered[p].tobytes())
        stages["replay"] += time.monotonic() - t2
        if not res.ok:
            return p, "failed", res.why, res.screen_drops, None, None
        if mismatch:
            # the one conviction class that carries its own honest
            # reconstruction (the replay succeeded) AND is third-party
            # provable (every input is owner-signed): values feed the
            # repair plane, the transcript blob feeds the proof receipt
            return (p, "failed", "replayed-bytes-mismatch",
                    res.screen_drops, res.values, blob)
        # sender-side omission check: my delivery must be accounted for
        if (p in ra.scatter_ok and my_index not in tr["frames"]
                and my_index not in tr["drops"]):
            return p, "omitted", "", res.screen_drops, None, None
        return p, "ok", "", res.screen_drops, None, None

    if jobs > 1 and len(todo) > 1:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(jobs, len(todo))) as pool:
            futs = [pool.submit(audit_one, p) for p in todo]
            # every future is read: a failed audit must surface, not
            # vanish in an unread Future
            outcomes = [f.result() for f in futs]
    else:
        outcomes = [audit_one(p) for p in todo]

    for p, status, why, screen_drops, honest, blob in outcomes:
        owner_pid = ra.owners[p].peer_id
        entry = {"part": p, "owner": owner_pid, "why": why,
                 "screen_drops": {int(k): v
                                  for k, v in screen_drops.items()}}
        report["audited"].append(p)
        if status == "unserved":
            # silence: local, timeout-weighted, never gossiped
            if ledger is not None:
                ledger.strike(owner_pid, AUDIT_TIMEOUT_REASON)
            report["unserved"].append(entry)
            logger.warning(
                "audit: part %d owner %s never served its challenged "
                "transcript (epoch %d) — audit-timeout strike",
                p, owner_pid[:16], ra.epoch)
        elif status == "failed":
            evidence = None
            if honest is not None and blob is not None:
                evidence = build_proof_evidence(ra, p, blob,
                                                limit=evidence_limit)
                if repair is not None and repair.accepts(ra.prefix):
                    # the copies are built only for a plane that will
                    # take them, and "repaired" reports what the plane
                    # actually ACCEPTED (an overflow drop is not a
                    # repair)
                    from dalle_tpu_torch.swarm.repair import RepairAction
                    entry["repaired"] = repair.submit(RepairAction(
                        prefix=ra.prefix, epoch=ra.epoch, part=p,
                        owner=owner_pid, lo=ra.part_lo(p),
                        served=np.array(ra.gathered[p], np.float32,
                                        copy=True),
                        honest=np.array(honest, np.float32,
                                        copy=True)))
            if ledger is not None:
                ledger.strike(owner_pid, AUDIT_FAIL_REASON,
                              evidence=evidence)
            report["failed"].append(entry)
            logger.warning(
                "audit: part %d owner %s FAILED replay (%s, epoch %d) — "
                "owner-audit-fail strike (receipt gossiped)",
                p, owner_pid[:16], why, ra.epoch)
        elif status == "omitted":
            if ledger is not None:
                ledger.strike(owner_pid, AUDIT_OMIT_REASON)
            report["omitted"].append(entry)
            logger.warning(
                "audit: part %d owner %s omitted this peer's DELIVERED "
                "contribution from its transcript (epoch %d) — "
                "owner-audit-omit strike", p, owner_pid[:16], ra.epoch)
        else:
            report["ok"].append(entry)
    return report


class AuditWorker(threading.Thread):
    """Background auditor: drains completed rounds' :class:`RoundAudit`
    objects and runs :func:`audit_round` over each, off the training
    thread. Lifecycle mirrors StrikeGossip: daemon worker, ``stop()``
    signals AND bounded-joins (an in-flight fetch on a torn-down DHT
    is a use-after-free), ``step()`` drains synchronously for tests
    and the soak.
    """

    #: pending-round bound: auditing is best-effort observability — a
    #: backlogged worker drops the OLDEST round (its transcripts are
    #: expiring anyway) rather than growing without bound
    MAX_PENDING = 8
    #: default BYTE bound on the retained-round repair ring: the
    #: pending RoundAudits hold signed frames + gathered part copies,
    #: so at flagship part sizes a slow audit behind MAX_PENDING rounds
    #: could pin gigabytes of host RAM — evict oldest-first by bytes
    #: too (CollabConfig.audit_ring_bytes overrides)
    MAX_BYTES = 256 << 20

    def __init__(self, dht, ledger, *, period: float = 0.5,
                 jobs: int = 1, repair=None,
                 max_bytes: int = MAX_BYTES,
                 evidence_limit: Optional[int] = None):
        super().__init__(daemon=True, name="audit-worker")
        self.dht = dht
        self.ledger = ledger
        self.period = period
        self.jobs = jobs
        self.repair = repair
        self.max_bytes = max_bytes
        #: forwarded to build_proof_evidence: None keeps the inline
        #: PROOF_MAX_BYTES cap, <= 0 builds unbounded bundles for the
        #: by-reference plane
        self.evidence_limit = evidence_limit
        self._stop_event = threading.Event()
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._pending_bytes = 0
        self.audited = 0            # observability counters
        self.failures = 0
        self.omissions = 0
        self.unserved = 0
        self.ring_evictions = 0
        self.last_report: Optional[dict] = None
        #: host seconds spent in audit_round and the largest retention
        #: the ring has held (bytes), for the peer's round report
        self.busy_s = 0.0
        self.rounds = 0
        self.retained_peak = 0
        self.stage_s = {"fetch": 0.0, "open": 0.0, "replay": 0.0}

    def counters(self) -> Dict[str, int]:
        """Consistent snapshot of the observability counters, under the
        same lock step() mutates them with — the stats exposition reads
        THIS, never the bare attributes from the training thread."""
        with self._lock:
            return {
                "audited": self.audited,
                "failures": self.failures,
                "omissions": self.omissions,
                "unserved": self.unserved,
                "ring_evictions": self.ring_evictions,
            }

    def timing(self) -> Dict[str, float]:
        """Rounds audited, their host seconds (in all and by stage), and
        the ring's peak retention in bytes (not part of the JAX package's
        counters)."""
        with self._lock:
            return {"rounds": self.rounds, "busy_s": self.busy_s,
                    "retained_peak": self.retained_peak,
                    **{f"{k}_s": v for k, v in self.stage_s.items()}}

    def submit(self, ra: RoundAudit) -> None:
        if ra is None or not ra.begun:
            return
        nbytes = ra.retained_bytes()
        with self._lock:
            # a SINGLE round over the whole byte budget is admitted
            # without evicting the backlog (flushing every pending
            # audit could never make room anyway — the bound is
            # knowingly exceeded by exactly one round, and dropping
            # the NEW round instead would let a flagship-size part
            # evade auditing entirely)
            budget = (self.max_bytes if nbytes <= self.max_bytes
                      else self._pending_bytes + nbytes)
            while self._pending and (
                    len(self._pending) >= self.MAX_PENDING
                    or self._pending_bytes + nbytes > budget):
                dropped = self._pending.popleft()
                self._pending_bytes -= dropped.retained_bytes()
                self.ring_evictions += 1
                logger.warning(
                    "audit ring backlogged (%d rounds / %d bytes "
                    "retained): dropping epoch %d audit oldest-first",
                    len(self._pending) + 1,
                    self._pending_bytes + dropped.retained_bytes(),
                    dropped.epoch)
            self._pending.append(ra)
            self._pending_bytes += nbytes
            self.retained_peak = max(self.retained_peak,
                                     self._pending_bytes)

    def step(self) -> int:
        """Drain and audit every pending round synchronously; returns
        the number of rounds audited."""
        n = 0
        while True:
            with self._lock:
                if not self._pending:
                    return n
                ra = self._pending.popleft()
                self._pending_bytes -= ra.retained_bytes()
            t0 = time.monotonic()
            rep = audit_round(self.dht, ra, self.ledger,
                              jobs=self.jobs, repair=self.repair,
                              evidence_limit=self.evidence_limit)
            with self._lock:
                self.busy_s += time.monotonic() - t0
                self.rounds += 1
                for k, v in rep["stage_s"].items():
                    self.stage_s[k] += v
                self.audited += len(rep["audited"])
                self.failures += len(rep["failed"])
                self.omissions += len(rep["omitted"])
                self.unserved += len(rep["unserved"])
                self.last_report = rep
            n += 1

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.step()
            except Exception:  # noqa: BLE001 - auditing must not die
                logger.warning("audit round failed", exc_info=True)
            self._stop_event.wait(max(0.05, self.period))

    def stop(self, join_timeout: Optional[float] = 10.0) -> None:
        """Signal AND (bounded) join before the owner tears the DHT
        down — an in-flight transcript fetch on a destroyed native
        node is a use-after-free. ``join_timeout=None`` skips the
        join (signal-only)."""
        self._stop_event.set()
        if join_timeout is not None and self.is_alive() \
                and threading.current_thread() is not self:
            self.join(timeout=join_timeout)
