"""Peer-health ledger: strike counts with epoch decay + gossiped
signed strike receipts.

The all-reduce already bans a misbehaving sender *within* a round
(corrupt chunks, no-progress timeouts, content screening —
``allreduce.py`` / ``screening.py``), but until now that knowledge died
with the round: the same flapping or hostile peer re-entered
matchmaking the very next epoch and cost every survivor another ban
timeout. The ledger is the cross-round memory: bans feed strikes,
strikes decay after a few epochs, and repeat offenders are down-ranked
— dropped from this peer's matchmaking candidate view
(``matchmaking._read_candidates``) and ignored by the progress
aggregation (``progress.ProgressTracker``) until their strikes age out.

Three evidence planes:

- **Local strikes** are this node's own verdicts. They can cross the
  penalty threshold on their own — the node SAW the offense.
- **Remote receipts** (:class:`StrikeGossip`) are other peers' signed
  verdicts, gossiped under a DHT strike prefix. They are folded in
  with bounded influence: at most ``max_issuer_influence`` per
  (issuer, offender) — so no single issuer can evict anyone (no veto)
  — and at most ``max_remote_influence`` total per offender, chosen
  BELOW the penalty threshold so remote receipts ALONE can never
  convict: a Sybil flock minting fresh identities to co-sign receipts
  against an honest peer tips the scale at most to
  ``max_remote_influence``; conviction still requires local evidence.
  What gossip buys is speed: one honest victim's attributable verdict
  reaches the whole swarm within a gossip period, so a repeat offender
  is down-ranked swarm-wide within ~2 epochs instead of per-victim —
  and a fresh joiner inherits the swarm's evidence instead of paying
  its own ban timeouts to rediscover it.
- **Verified proofs**: an ``owner-audit-fail`` receipt may embed
  its EVIDENCE — the accused owner's signed transcript plus its
  signed gather frames (swarm/audit.build_proof_evidence). A reader
  with a :class:`~dalle_tpu.swarm.audit.ProofVerifier` armed replays
  the evidence itself; a verified proof is no longer an accusation but
  a demonstrated contradiction in the OFFENDER'S OWN signatures, so it
  scores the full penalty threshold (``proven_strike``) with no local
  corroboration. Verification is all-or-nothing: an unverifiable
  proof is dropped without ledger effect (not even the capped
  accusation — attaching bogus evidence is self-discrediting), which
  keeps the Sybil argument intact: influence beyond the accusation caps is
  only ever granted to evidence the reader checked independently.

Only ATTRIBUTABLE reasons gossip (:data:`GOSSIP_REASONS`): a receipt
is a signed accusation, and the issuer must have held proof (a valid
signature over bad content) the accused peer cannot disown. Timeout
strikes never gossip — silence is unattributable (the issuer's own
inbound path is an equally good explanation), and gossiping it would
let one badly-connected node spray blame across the swarm.

The ledger is LOCAL knowledge. Peers' ledgers can disagree (one peer
saw the corrupt chunk, another didn't) and the matchmaking roster can
therefore diverge transiently — that is the existing elasticity
contract: followers prefer the leader's signed roster, and residual
disagreement falls out through group-hash mismatch drops. Down-ranking
is a *bias*, not a consensus verdict.

Thread-safety: strikes arrive from wire/round worker threads and the
gossip worker while the training thread reads penalties — every
mutation holds the lock.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: default strike weights by reason (anything else counts 1.0).
#: "confirm-timeout" is deliberately sub-threshold on its own: a
#: missing confirmation is unattributable (the leader may be alive but
#: slow, or the follower's roster may have diverged), so even striking
#: the same leader EVERY epoch (0.5 x ttl 3 = 1.5) can never cross the
#: default penalty threshold (3.0) without corroborating allreduce
#: evidence — unattributable signals tip the scale, they don't convict.
STRIKE_WEIGHTS = {
    "corrupt-chunk": 2.0,       # affirmatively malformed traffic
    "screen-outlier": 2.0,      # validly signed, content-outlying data
    "weight-overclaim": 2.0,    # validly signed absurd frame weight
    "progress-overclaim": 1.0,  # absurd signed progress claim
    "owner-audit-fail": 2.0,    # served a part its own signed
                                # transcript cannot explain (replay
                                # mismatch — swarm/audit.py)
    "owner-audit-omit": 2.0,    # omitted this node's DELIVERED frames
                                # from its transcript (only the victim
                                # has standing: never gossiped)
    "audit-timeout": 1.0,       # challenged owner never served a
                                # transcript (silence: never gossiped)
    "reduce-timeout": 1.0,      # never delivered its contribution
    "gather-timeout": 1.0,      # owned a part and never served it
    "confirm-timeout": 0.5,     # announced leader, never confirmed
}

#: reasons whose strikes may be gossiped as signed receipts: every one
#: is an AUTHENTICATED verdict — the issuer verified a valid signature
#: over provably-wrong content, so the receipt is an accusation the
#: accused produced the evidence for. Timeout/no-show reasons are
#: deliberately absent (see module docstring).
GOSSIP_REASONS = frozenset({
    "corrupt-chunk", "screen-outlier", "weight-overclaim",
    "progress-overclaim", "owner-audit-fail"})

#: receipts, events and seen-sets are bounded everywhere: gossip is an
#: attacker-writable plane and must not become a memory amplifier
_MAX_EVENTS = 4096
_MAX_SEEN = 8192

#: largest evidence bundle a receipt will embed INLINE. Proof-carrying
#: receipts (swarm/audit.py build_proof_evidence) ship the owner-signed
#: transcript + gather frames inline so any peer can replay them.
#: Beyond this bound (flagship-scale parts) the receipt carries a
#: by-REFERENCE descriptor instead — the bundle's sha256 digest + the
#: issuer's mailbox reference (swarm/audit.EvidencePlane) — and
#: verifiers fetch, hash-check and replay the parked bundle. Only when
#: no evidence store is armed, or the issuer cannot park the bundle
#: (unroutable peer, mailbox post failure), does the receipt degrade
#: to the plain capped accusation — the conviction still lands
#: through local corroboration, just not by proof alone. Sized under
#: the native 64 MiB frame cap with headroom for the DHT record plane.
PROOF_MAX_BYTES = 4 << 20


class PeerHealthLedger:
    """Decaying per-peer strike counts, local + bounded remote.

    A strike is recorded with the epoch it happened in; only strikes
    from the last ``ttl_epochs`` epochs count toward the penalty score.
    ``penalized(pid)`` is True while the live score is at or above
    ``penalty_threshold`` — "down-ranked for the next few epochs".

    ``score(pid)`` = live local strikes + remote evidence, where remote
    evidence is capped per issuer (``max_issuer_influence``) and in
    total (``max_remote_influence`` — default strictly below the
    penalty threshold, see the module docstring's no-veto argument).
    """

    def __init__(self, ttl_epochs: int = 3,
                 penalty_threshold: float = 3.0,
                 max_peers: int = 4096,
                 max_issuer_influence: float = 1.0,
                 max_remote_influence: float = 2.0):
        self.ttl_epochs = ttl_epochs
        self.penalty_threshold = penalty_threshold
        self.max_peers = max_peers
        self.max_issuer_influence = max_issuer_influence
        self.max_remote_influence = max_remote_influence
        self._lock = threading.Lock()
        self._epoch = 0
        # peer_id -> [(epoch, weight), ...]
        self._strikes: Dict[str, List[Tuple[int, float]]] = {}
        # peer_id -> issuer_id -> [(epoch, weight), ...]
        self._remote: Dict[str, Dict[str, List[Tuple[int, float]]]] = {}
        # peer_id -> {dedup ref: epoch} of VERIFIED proof convictions
        # (independently replayed evidence — swarm/audit.ProofVerifier).
        # A live proof contributes the full penalty threshold to the
        # score: a verified proof convicts with no local corroboration,
        # the upgrade from the capped-accusation plane.
        self._proven: Dict[str, Dict[str, int]] = {}
        # (epoch, peer, reason, evidence) local gossipable verdicts
        # awaiting publication (StrikeGossip drains this); evidence is
        # the optional proof bundle an owner-audit-fail conviction
        # attaches (None for every other reason)
        self._events: List[Tuple[int, str, str, Optional[bytes]]] = []

    # -- writes ------------------------------------------------------------

    def strike(self, peer_id: str, reason: str = "",
               weight: float = 0.0,
               evidence: Optional[bytes] = None) -> None:
        """Record one LOCAL offense. ``weight`` 0 looks the reason up in
        STRIKE_WEIGHTS (unknown reasons count 1.0). Attributable
        reasons (GOSSIP_REASONS) also queue a gossip event; ``evidence``
        (a proof bundle from the aggregation audit) rides the event so
        the published receipt carries the proof."""
        w = weight or STRIKE_WEIGHTS.get(reason, 1.0)
        with self._lock:
            if (peer_id not in self._strikes
                    and len(self._strikes) >= self.max_peers):
                return  # bound memory against an id-churning flood
            self._strikes.setdefault(peer_id, []).append((self._epoch, w))
            if reason in GOSSIP_REASONS and len(self._events) < _MAX_EVENTS:
                self._events.append((self._epoch, peer_id, reason,
                                     evidence))

    def remote_strike(self, issuer_id: str, peer_id: str, reason: str,
                      epoch: int, weight: float = 0.0) -> None:
        """Fold one verified REMOTE receipt in. The receipt's epoch is
        clamped to this ledger's clock — a forward-dated receipt must
        not outlive the decay window — and influence caps are applied
        at read time (``score``), so late caps-config changes apply
        retroactively."""
        w = weight or STRIKE_WEIGHTS.get(reason, 1.0)
        with self._lock:
            e = min(int(epoch), self._epoch)
            if e <= self._epoch - self.ttl_epochs:
                return  # already aged out on arrival
            if (peer_id not in self._remote
                    and len(self._remote) >= self.max_peers):
                return
            issuers = self._remote.setdefault(peer_id, {})
            if (issuer_id not in issuers
                    and len(issuers) >= self.max_peers):
                return
            rec = issuers.setdefault(issuer_id, [])
            if len(rec) < _MAX_EVENTS:
                rec.append((e, w))

    def proven_strike(self, peer_id: str, reason: str, epoch: int,
                      ref: str) -> bool:
        """Fold one VERIFIED proof conviction: the caller (StrikeGossip
        with a :class:`~dalle_tpu.swarm.audit.ProofVerifier` armed)
        independently replayed the receipt's evidence and confirmed the
        contradiction. A live proof scores the full penalty threshold —
        conviction with no local corroboration — which is safe exactly
        because verification is all-or-nothing: an unverifiable proof
        never reaches here (it folds at most as a plain capped
        receipt, or not at all). ``ref`` dedups re-wrapped copies of
        the same evidence (peer/reason/epoch/phase), so a Sybil flock
        re-publishing one proof gains nothing; the proof decays with
        the ttl window like every strike. Returns True iff recorded."""
        with self._lock:
            e = min(int(epoch), self._epoch)
            if e <= self._epoch - self.ttl_epochs:
                return False  # stale evidence: aged out on arrival
            if (peer_id not in self._proven
                    and len(self._proven) >= self.max_peers):
                return False
            refs = self._proven.setdefault(peer_id, {})
            if ref in refs:
                return False  # replayed proof: idempotent
            if len(refs) >= _MAX_EVENTS:
                return False
            refs[ref] = e
            return True

    def advance_epoch(self, epoch: int) -> None:
        """Move the decay clock forward (never backward) and prune
        strikes that have aged out everywhere."""
        with self._lock:
            if epoch <= self._epoch:
                return
            self._epoch = epoch
            floor = epoch - self.ttl_epochs
            for pid in list(self._strikes):
                live = [(e, w) for e, w in self._strikes[pid] if e > floor]
                if live:
                    self._strikes[pid] = live
                else:
                    del self._strikes[pid]
            for pid in list(self._remote):
                issuers = self._remote[pid]
                for iid in list(issuers):
                    live = [(e, w) for e, w in issuers[iid] if e > floor]
                    if live:
                        issuers[iid] = live
                    else:
                        del issuers[iid]
                if not issuers:
                    del self._remote[pid]
            for pid in list(self._proven):
                live_refs = {r: e for r, e in self._proven[pid].items()
                             if e > floor}
                if live_refs:
                    self._proven[pid] = live_refs
                else:
                    del self._proven[pid]

    def drain_events(self) -> List[Tuple[int, str, str, Optional[bytes]]]:
        """Pop the queued gossipable verdicts (StrikeGossip publishes
        them as signed receipts, proof evidence attached when the
        verdict carried one)."""
        with self._lock:
            out, self._events = self._events, []
            return out

    def requeue_events(self, events) -> None:
        """Put drained-but-unpublished verdicts back (a failed store —
        transient DHT outage, blackout — must retry next period, not
        silently lose the receipt). Bounded like the queue itself."""
        if not events:
            return
        with self._lock:
            self._events = (list(events) + self._events)[:_MAX_EVENTS]

    # -- reads -------------------------------------------------------------

    def _local_score(self, peer_id: str, floor: int) -> float:
        return sum(w for e, w in self._strikes.get(peer_id, ())
                   if e > floor)

    def _remote_score(self, peer_id: str, floor: int) -> float:
        issuers = self._remote.get(peer_id)
        if not issuers:
            return 0.0
        total = 0.0
        for rec in issuers.values():
            live = sum(w for e, w in rec if e > floor)
            total += min(live, self.max_issuer_influence)
        return min(total, self.max_remote_influence)

    def _proven_score(self, peer_id: str, floor: int) -> float:
        """The penalty threshold while ANY verified proof is live —
        a proof convicts outright; stacking proofs adds nothing (one
        contradiction already proves dishonesty)."""
        refs = self._proven.get(peer_id)
        if refs and any(e > floor for e in refs.values()):
            return self.penalty_threshold
        return 0.0

    def score(self, peer_id: str) -> float:
        """Live (un-decayed) strike weight for a peer: local evidence
        plus capped remote evidence, plus the full penalty threshold
        while a verified proof conviction is live."""
        with self._lock:
            floor = self._epoch - self.ttl_epochs
            return (self._local_score(peer_id, floor)
                    + self._remote_score(peer_id, floor)
                    + self._proven_score(peer_id, floor))

    def remote_score(self, peer_id: str) -> float:
        """The (capped) remote-receipt component of ``score`` alone —
        observability for the byzantine soak's gossip oracle."""
        with self._lock:
            floor = self._epoch - self.ttl_epochs
            return self._remote_score(peer_id, floor)

    def local_score(self, peer_id: str) -> float:
        """This node's OWN live evidence alone — the soak's proof
        oracle asserts a peer with zero local evidence still convicts
        through a verified proof."""
        with self._lock:
            floor = self._epoch - self.ttl_epochs
            return self._local_score(peer_id, floor)

    def proof_convictions(self, peer_id: str) -> Dict[str, int]:
        """{dedup ref: epoch} of live verified-proof convictions
        against a peer — observability for the repair soak's
        no-local-corroboration oracle."""
        with self._lock:
            floor = self._epoch - self.ttl_epochs
            return {r: e for r, e
                    in self._proven.get(peer_id, {}).items()
                    if e > floor}

    def penalized(self, peer_id: str) -> bool:
        return self.score(peer_id) >= self.penalty_threshold

    def snapshot(self) -> Dict[str, float]:
        """{peer_id: live score} for logging/metrics (local + capped
        remote, same arithmetic as ``score``)."""
        with self._lock:
            floor = self._epoch - self.ttl_epochs
            out = {}
            for pid in (set(self._strikes) | set(self._remote)
                        | set(self._proven)):
                s = (self._local_score(pid, floor)
                     + self._remote_score(pid, floor)
                     + self._proven_score(pid, floor))
                if s > 0:
                    out[pid] = s
            return out


# -- signed strike receipts ------------------------------------------------

def _receipt_ctx(prefix: str) -> bytes:
    """Domain-separation context for receipt signatures: bound to the
    run prefix so a receipt cannot be replayed into another swarm."""
    return f"{prefix}:strike-receipt".encode()


def strike_key(prefix: str) -> str:
    """The DHT key receipts gossip under."""
    return f"{prefix}_strikes"


def make_receipt(identity, prefix: str, peer_id: str, reason: str,
                 epoch: int, proof: Optional[bytes] = None) -> bytes:
    """An Ed25519-signed (peer, reason, epoch) verdict from
    ``identity``. The issuer IS the signing key — receipts carry no
    separate issuer field to forge. ``proof`` (optional) embeds an
    evidence bundle (swarm/audit.build_proof_evidence) under the same
    signature: a verifying reader can then replay the conviction
    independently instead of trusting the issuer's word."""
    from dalle_tpu_torch.utils import msgpack

    from dalle_tpu_torch.swarm.identity import signed_frame
    obj = {"peer": peer_id, "reason": reason, "epoch": int(epoch)}
    if proof is not None:
        obj["proof"] = bytes(proof)
    payload = msgpack.packb(obj, use_bin_type=True)
    return signed_frame(identity, _receipt_ctx(prefix), b"", payload)


def open_receipt_full(raw: bytes, prefix: str
                      ) -> Optional[Tuple[str, str, str, int,
                                          Optional[bytes]]]:
    """(issuer_id, peer_id, reason, epoch, proof_or_None) iff ``raw``
    is a validly signed receipt with a well-formed, gossipable
    payload; None otherwise. STRICT on content: unknown reasons and
    malformed ids are rejected outright — the strike plane is
    attacker-writable and a verifier must never fold a claim it
    cannot price."""
    from dalle_tpu_torch.utils import msgpack

    from dalle_tpu_torch.swarm.identity import open_frame
    opened = open_frame(bytes(raw), _receipt_ctx(prefix), 0,
                        expected_pid=None)
    if opened is None:
        return None
    _head, payload, issuer = opened
    try:
        obj = msgpack.unpackb(payload, raw=False)
        peer = str(obj["peer"])
        reason = str(obj["reason"])
        epoch = int(obj["epoch"])
        proof = obj.get("proof")
        if proof is not None:
            # type BEFORE size: bytes(2**34) on an int-typed field
            # would allocate attacker-chosen memory before any check
            if not isinstance(proof, (bytes, bytearray)) \
                    or len(proof) > PROOF_MAX_BYTES:
                return None  # malformed/oversized evidence
            proof = bytes(proof)
    # rejecting unparseable receipts IS the verifier contract (hostile
    # writers expected on this plane); logging per record would hand a
    # flood a log-spam amplifier
    # graftlint: disable=silent-except
    except Exception:  # noqa: BLE001 - any parse failure = invalid
        return None
    if reason not in GOSSIP_REASONS or epoch < 0:
        return None
    if len(peer) != 64 or any(c not in "0123456789abcdef" for c in peer):
        return None  # peer ids are hex sha256 digests
    return issuer, peer, reason, epoch, proof


def open_receipt(raw: bytes, prefix: str
                 ) -> Optional[Tuple[str, str, str, int]]:
    """The capped-accusation view of :func:`open_receipt_full` (proof dropped)."""
    full = open_receipt_full(raw, prefix)
    return None if full is None else full[:4]


class StrikeGossip(threading.Thread):
    """The gossip worker: publish this node's attributable verdicts as
    signed receipts, and fold other peers' verified receipts into the
    local ledger.

    Receipts live under ``{prefix}_strikes`` with one subkey per
    (issuer, peer, reason, epoch) — the dedup unit: re-publishing the
    same verdict refreshes its TTL instead of stacking influence, and
    the fold-side ``_seen`` set makes folding idempotent even when the
    DHT returns the record on every poll. Verification happens on READ
    (the store/routing plane is native and validates nothing): the
    receipt's own Ed25519 signature names the issuer, so forged or
    tampered receipts drop before they touch the ledger.

    Lifecycle mirrors RendezvousAdvertiser: a daemon worker looping
    every ``period`` seconds; ``stop()`` signals AND bounded-joins so
    the owner can tear the DHT down afterwards without racing an
    in-flight publish. ``step()`` runs one publish+fold synchronously —
    the deterministic face the tests and the soak drive directly.
    """

    def __init__(self, dht, ledger: PeerHealthLedger, prefix: str,
                 period: float = 5.0, receipt_ttl: float = 180.0,
                 max_fold_per_poll: int = 512, verifier=None):
        super().__init__(daemon=True, name="strike-gossip")
        self.dht = dht
        self.ledger = ledger
        self.prefix = prefix
        self.period = period
        self.receipt_ttl = receipt_ttl
        self.max_fold_per_poll = max_fold_per_poll
        #: optional proof verifier (swarm/audit.ProofVerifier): with it
        #: armed, a proof-carrying receipt is re-verified by REPLAYING
        #: its evidence — verified ⇒ a proven conviction (full penalty
        #: weight, no local corroboration needed), unverifiable ⇒
        #: DROPPED outright (all-or-nothing: a receipt whose attached
        #: evidence fails its own check earns its issuer nothing, not
        #: even the capped accusation — attaching bogus proof is
        #: self-discrediting). Without a verifier, proof receipts fold
        #: exactly like plain receipts (capped influence).
        # armed once by the owner after codec resolution (a single
        # None -> ProofVerifier transition the run thread tolerates)
        # graftlint: handoff=bind-once-wiring
        self.verifier = verifier
        #: optional by-reference evidence store (swarm/audit
        #: .EvidencePlane): with it armed, evidence too large to embed
        #: is parked in this issuer's mailbox and the receipt carries
        #: the descriptor; without it (or when parking fails) the
        #: over-budget receipt degrades to the capped accusation
        # graftlint: handoff=bind-once-wiring
        self.evidence_store = None
        self._stop_event = threading.Event()
        self._seen: set = set()     # (issuer, peer, reason, epoch, ref)
        # observability counters: written by whichever thread drives
        # publish_once/fold_once (the run loop, or main via step());
        # foreign reads are telemetry, a lost increment skews a gauge
        # graftlint: handoff=single-driver-counter
        self.published = 0
        # graftlint: handoff=single-driver-counter
        self.folded = 0
        # graftlint: handoff=single-driver-counter
        self.proofs_published = 0
        # graftlint: handoff=single-driver-counter
        self.proofs_convicted = 0
        # graftlint: handoff=single-driver-counter
        self.proofs_rejected = 0
        # graftlint: handoff=single-driver-counter
        self.proofs_by_reference = 0

    # -- one synchronous round (tests / soak drive this directly) ---------

    def publish_once(self) -> int:
        import hashlib as _hashlib

        from dalle_tpu_torch.swarm.dht import get_dht_time
        n = 0
        events = self.ledger.drain_events()
        failed: List[Tuple[int, str, str, Optional[bytes]]] = []
        for i, (epoch, peer, reason, evidence) in enumerate(events):
            if peer == self.dht.peer_id:
                continue  # self-verdicts are local bookkeeping only
            proof = (evidence if evidence is not None
                     and len(evidence) <= PROOF_MAX_BYTES else None)
            if evidence is not None and proof is None \
                    and self.evidence_store is not None:
                # evidence by reference: park the oversize bundle
                # in this issuer's mailbox and embed the ~100-byte
                # descriptor under the receipt signature instead
                proof = self.evidence_store.publish(evidence)
                if proof is not None:
                    self.proofs_by_reference += 1
            if evidence is not None and proof is None:
                # stonewalled: no store armed, or the park failed —
                # the capped accusation is the floor
                logger.warning(
                    "strike evidence too large to embed (%d > %d "
                    "bytes) and not parkable by reference: receipt "
                    "degrades to the capped accusation",
                    len(evidence), PROOF_MAX_BYTES)
            receipt = make_receipt(self.dht.identity, self.prefix,
                                   peer, reason, epoch, proof=proof)
            sub = f"{self.dht.peer_id}.{peer}.{reason}.{epoch}"
            if proof is not None:
                # distinct evidence (e.g. two phase convictions in one
                # epoch) must not collide on the dedup subkey
                sub += "." + _hashlib.sha256(proof).hexdigest()[:8]
                self.proofs_published += 1
            try:
                ok = self.dht.store(strike_key(self.prefix), sub, receipt,
                                    expiration_time=get_dht_time()
                                    + self.receipt_ttl)
            except Exception:  # noqa: BLE001 - requeued, not lost
                # the rest of the batch must not be dropped because one
                # store raised mid-loop: requeue everything unpublished
                # (this event included), log, and let fold still run
                self.ledger.requeue_events(
                    failed + [e for e in events[i:]
                              if e[1] != self.dht.peer_id])
                logger.warning("strike receipt store raised; batch "
                               "requeued for the next period",
                               exc_info=True)
                self.published += n
                return n
            if ok:
                n += 1
            else:
                # a False store (outage, blackout rule) retries next
                # period — a one-shot offense's receipt must not vanish
                failed.append((epoch, peer, reason, evidence))
        if failed:
            self.ledger.requeue_events(failed)
        self.published += n
        return n

    def fold_once(self) -> int:
        import hashlib as _hashlib
        entries = self.dht.get(strike_key(self.prefix)) or {}
        n = 0
        for _subkey, item in entries.items():
            if n >= self.max_fold_per_poll:
                break  # bounded work per poll under a receipt flood
            if not isinstance(item.value, (bytes, bytearray)):
                continue
            opened = open_receipt_full(item.value, self.prefix)
            if opened is None:
                continue
            issuer, peer, reason, epoch, proof = opened
            if issuer == self.dht.peer_id:
                continue  # our own verdicts are already local strikes
            if peer == self.dht.peer_id:
                continue  # never fold accusations against self
            if peer == issuer:
                continue  # self-confessions carry no information
            ref = ("" if proof is None
                   else _hashlib.sha256(proof).hexdigest()[:16])
            mark = (issuer, peer, reason, epoch, ref)
            if mark in self._seen:
                continue
            if len(self._seen) >= _MAX_SEEN:
                self._seen.clear()  # re-folds are idempotent-ish: the
                # per-issuer influence cap bounds any double count
            self._seen.add(mark)
            if proof is not None and self.verifier is not None:
                # all-or-nothing: a verified proof convicts outright
                # (no local corroboration needed); an unverifiable one
                # is dropped WITHOUT ledger effect — forged, stale,
                # mismatched or unchallenged evidence earns its issuer
                # nothing, not even the capped accusation
                verified_prefix = self.verifier(proof, peer, epoch)
                if verified_prefix:
                    self.proofs_convicted += 1
                    self.ledger.proven_strike(
                        peer, reason, epoch,
                        ref=f"{reason}:{verified_prefix}:{ref}")
                    n += 1
                else:
                    self.proofs_rejected += 1
                continue
            self.ledger.remote_strike(issuer, peer, reason, epoch)
            n += 1
        self.folded += n
        return n

    def step(self) -> None:
        self.publish_once()
        self.fold_once()

    # -- worker lifecycle --------------------------------------------------

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.step()
            except Exception:  # noqa: BLE001 - gossip must not die
                logger.warning("strike gossip round failed",
                               exc_info=True)
            self._stop_event.wait(max(0.1, self.period))

    def stop(self, join_timeout: Optional[float] = 10.0) -> None:
        """Signal AND (bounded) join: an in-flight step() touching a
        torn-down native DHT node is a use-after-free, so the owner
        must not proceed to DHT.shutdown while this thread may still
        be inside a publish/fold. ``join_timeout=None`` skips the join
        (signal-only)."""
        self._stop_event.set()
        if join_timeout is not None and self.is_alive() \
                and threading.current_thread() is not self:
            self.join(timeout=join_timeout)
