"""Matchmaking: form an averaging group for one swarm epoch.

Capability parity with hivemind's ``Matchmaking`` (used by
``DecentralizedAverager`` — reference SURVEY: DHT group keys, waiting for
stragglers at most ``matchmaking_time=15s``, reference arguments.py:66-68).

Protocol (epoch-scoped DHT key + leader confirmation):

1. Every candidate stores ``{addr, weight}`` under
   ``{prefix}_matchmaking.e{epoch}`` (subkey = its peer id) and polls the
   key until ``matchmaking_time`` elapses (early exit once the candidate
   set has been stable for two polls and has >= 2 CONTRIBUTORS — weight-0
   averaging assistants never rush a group).
2. The candidate set is ordered by peer id; the lowest-id CONTRIBUTOR
   (weight > 0) is the *leader* — racing views that differ only in
   which weight-0 assistants they saw still elect the same leader.
   The leader sends the final member list to every follower over the data
   plane (and parks a copy in its mailbox for client-mode followers, who
   have no listener to push to); followers prefer the leader's list over
   their own DHT view, so all members agree on the part assignment.
3. Residual disagreement (a follower that missed the confirmation and saw
   a different DHT snapshot) is tolerated downstream: every all-reduce
   message carries the group hash, and mismatching messages are dropped —
   the divergent peer just falls out of the round (hivemind's ban-and-
   proceed elasticity, arguments.py:69-74).

Client-mode peers (outbound-only, reference arguments.py:89-92) announce
with weight but no listener address; they are skipped for part ownership.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import List, Optional, Tuple

from dalle_tpu_torch.utils import msgpack

from dalle_tpu_torch.swarm.dht import DHT, get_dht_time, owner_public_key

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GroupMember:
    peer_id: str
    addr: str          # "" for client-mode peers (no listener)
    weight: float
    # access token from the member's announce (swarm/auth.py); rides the
    # signed confirmation so followers can validate leader-confirmed
    # members their own DHT snapshot missed. Empty when auth is off.
    token: bytes = b""
    # the member's X25519 key-agreement public key (swarm/crypto.py);
    # the leader seals the round's group key to it
    kx: bytes = b""


@dataclasses.dataclass
class AveragingGroup:
    members: List[GroupMember]      # sorted by peer_id
    my_index: int
    group_hash: bytes               # binds messages to this membership
    # symmetric key for this round's data-plane AEAD (crypto.py); None
    # when encryption is off or this peer missed the key distribution
    # (it then falls out of the encrypted round — plain elasticity)
    group_key: Optional[bytes] = None

    @property
    def size(self) -> int:
        return len(self.members)


def group_hash_of(members: List[GroupMember]) -> bytes:
    h = hashlib.sha256()
    for m in members:
        h.update(m.peer_id.encode())
        h.update(b"|")
    return h.digest()[:16]


def _confirm_tag(prefix: str, epoch: int, peer_id: str) -> int:
    digest = hashlib.sha256(
        f"{prefix}:mm-confirm:{epoch}:{peer_id}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _confirm_context(prefix: str, epoch: int) -> bytes:
    return f"{prefix}:mm-confirm:{epoch}".encode()


def _signed_confirmation(identity, prefix: str, epoch: int,
                         members: List[GroupMember],
                         sealed_keys: Optional[dict] = None) -> bytes:
    """Roster signed with the leader's Ed25519 identity: an unsigned
    confirmation would let any peer forge a roster and eject members from
    the round. Members' access tokens ride along so
    followers can admit authorized peers their own DHT snapshot missed;
    ``sealed_keys`` maps peer_id -> the round's group key sealed to that
    member's kx public key (crypto.py), signed so a relay cannot swap
    them."""
    body = msgpack.packb(
        {"members": [[m.peer_id, m.addr, m.weight, m.token, m.kx]
                     for m in members],
         "keys": sealed_keys or {}},
        use_bin_type=True)
    sig = identity.sign(_confirm_context(prefix, epoch) + body)
    return msgpack.packb({"m": body, "pk": identity.public_bytes,
                          "sig": sig}, use_bin_type=True)


def member_authorized(member: GroupMember, authorizer) -> bool:
    """A member is authorized iff its token (a) was issued by the
    experiment authority, (b) is unexpired, and (c) is bound to the exact
    identity whose hash is the member's peer id — so a stolen token cannot
    be re-attached to another roster entry."""
    if authorizer is None:
        return True
    from dalle_tpu_torch.swarm.auth import AccessToken

    token = AccessToken.from_bytes(bytes(member.token or b""))
    if token is None:
        return False
    if hashlib.sha256(token.peer_public_key).hexdigest() != member.peer_id:
        return False
    return authorizer.validate_token(
        token, token.peer_public_key) is not None


def verify_confirmation(raw: bytes, prefix: str, epoch: int,
                        leader_peer_id: str, authorizer=None
                        ) -> Optional[Tuple[List[GroupMember], dict]]:
    """(members, sealed_keys) iff the confirmation is signed by
    ``leader_peer_id``; with an authorizer, members whose embedded token
    fails validation are dropped (a malicious leader cannot confirm
    unauthorized ids into an honest peer's roster)."""
    from dalle_tpu_torch.swarm.identity import Identity

    try:
        obj = msgpack.unpackb(raw, raw=False)
        body, pk, sig = bytes(obj["m"]), bytes(obj["pk"]), bytes(obj["sig"])
    except Exception:  # noqa: BLE001 - malformed wire data
        # an unparseable confirmation silently degrades this peer to its
        # own DHT view of the roster — worth a trace when rounds
        # mysteriously split
        logger.warning("malformed group confirmation from leader %s "
                       "(%d bytes): falling back to the DHT roster view",
                       leader_peer_id, len(raw), exc_info=True)
        return None
    if hashlib.sha256(pk).hexdigest() != leader_peer_id:
        return None
    if not Identity.verify(pk, sig, _confirm_context(prefix, epoch) + body):
        return None
    try:
        decoded = msgpack.unpackb(body, raw=False)
        members = [GroupMember(str(p), str(a), float(w), bytes(t),
                               bytes(k) if len(bytes(k)) == 32 else b"")
                   for p, a, w, t, k in decoded["members"]]
        keys = {str(pid): bytes(blob)
                for pid, blob in dict(decoded["keys"]).items()}
    except (msgpack.UnpackException, ValueError, TypeError, KeyError):
        return None
    return [m for m in members if member_authorized(m, authorizer)], keys


def choose_leader(members: List[GroupMember]) -> GroupMember:
    """The lowest-id CONTRIBUTOR (weight > 0), not merely the lowest id:
    candidate views race during the stability window, and a weight-0
    averaging assistant visible to only SOME candidates must not change
    who they each wait on — two leaders means two confirmed rosters and
    a splintered round (observed in an assist CLI drive). Views that
    agree on the lowest-id trainer agree on the leader regardless of
    assistants. An all-assistant lobby falls back to the lowest id
    (members must be sorted by peer id)."""
    return next((m for m in members if m.weight > 0), members[0])


def _recv_leader_confirmation(dht: DHT, tag: int, prefix: str, epoch: int,
                              leader_peer_id: str, authorizer,
                              wait: float) -> Optional[bytes]:
    """The first confirmation on this follower's tag that its leader
    signed, or None when ``wait`` runs out. Any peer can send to the tag:
    a peer whose own view of the group differs (an unauthorized peer
    counts itself in, and confirms as leader when its view makes it one)
    sends its confirmation there too. The JAX package reads one message
    and, when it is not the leader's, sits the round out without a group
    key, so such a peer can keep honest followers out of a round; here
    other messages are skipped and the wait goes on."""
    deadline = time.monotonic() + wait
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        raw = dht.recv(tag, timeout=remaining)
        if raw is None:
            return None
        if verify_confirmation(raw, prefix, epoch, leader_peer_id,
                               authorizer) is not None:
            return raw
        logger.debug("matchmaking: skipped a confirmation not signed by "
                     "leader %s", leader_peer_id[:16])


def make_group(dht: DHT, prefix: str, epoch: int, weight: float,
               matchmaking_time: float = 15.0,
               min_group_size: int = 1,
               client_mode: bool = False,
               authorizer=None,
               encrypt: bool = False,
               ledger=None) -> Optional[AveragingGroup]:
    """Announce, wait, and agree on this epoch's averaging group.

    Returns None if this peer somehow isn't in the final group (can happen
    only if its own announce failed and a leader confirmation without it
    arrived) — callers should then skip averaging this epoch.

    ``ledger`` (optional :class:`~dalle_tpu_torch.swarm.health
    .PeerHealthLedger`) down-ranks repeat offenders: candidates this
    peer's ledger currently penalizes (strikes from recent allreduce
    bans, decaying over a few epochs) are dropped from the local
    candidate view, so a flapping or hostile peer stops costing every
    epoch a ban timeout. The ledger is local knowledge — rosters can
    diverge transiently, which the group-hash drop rule already
    tolerates (a leader-confirmed roster still overrides).

    With an ``authorizer`` (swarm/auth.py), the announce carries this
    peer's access token and every honest member drops candidates whose
    token does not validate against the experiment authority and bind to
    the announcing identity — unauthorized peers never enter a group.
    Tokens also ride the signed leader confirmation, so a follower admits
    leader-confirmed members its own DHT snapshot missed (each validated
    individually) while a malicious leader still cannot confirm an
    unauthorized id into an honest roster — the gate is each peer's own
    validation, the reference's authorizer trust model
    (``huggingface_auth.py:62-68``).
    """
    key = f"{prefix}_matchmaking.e{epoch}"
    my_id = dht.peer_id
    # relay-attached client peers announce their relay route and act as
    # full (part-owning) members; only plain client-mode peers announce ""
    addr = dht.reachable_address
    deadline = time.monotonic() + matchmaking_time
    announce = {"addr": addr, "weight": float(weight),
                "kx": dht.kx.public_bytes}
    if authorizer is not None:
        announce["tok"] = authorizer.local_token_bytes()
    dht.store(key, my_id, announce,
              expiration_time=get_dht_time() + matchmaking_time * 4 + 60)

    seen: List[GroupMember] = []
    stable_polls = 0
    while True:
        now = time.monotonic()
        if now >= deadline:
            break
        current = _read_candidates(dht, key, authorizer, ledger)
        if [m.peer_id for m in current] == [m.peer_id for m in seen]:
            stable_polls += 1
        else:
            stable_polls = 0
        seen = current
        # only CONTRIBUTORS (weight > 0) count toward the early-exit
        # quorum: a weight-0 averaging assistant camping in the
        # matchmaking key must not make the first trainer to arrive
        # rush a 2-member group before its real peers announce
        contributors = sum(1 for m in seen if m.weight > 0)
        if (contributors >= max(2, min_group_size) and stable_polls >= 2):
            break
        time.sleep(min(0.25, max(0.0, deadline - now)))

    members = _read_candidates(dht, key, authorizer, ledger)
    if not any(m.peer_id == my_id for m in members):
        # our own announce hasn't landed anywhere readable: run solo
        members = sorted(
            members + [GroupMember(my_id, addr, float(weight),
                                   bytes(announce.get("tok") or b""),
                                   dht.kx.public_bytes)],
            key=lambda m: m.peer_id)

    # leader confirmation round
    leader = choose_leader(members)
    confirm_wait = min(5.0, matchmaking_time)
    group_key: Optional[bytes] = None
    if leader.peer_id == my_id:
        sealed_keys = None
        if encrypt and len(members) > 1:
            from dalle_tpu_torch.swarm.crypto import new_group_key, seal_to
            group_key = new_group_key()
            sealed_keys = {m.peer_id: seal_to(m.kx, group_key)
                           for m in members if m.kx}
        payload = _signed_confirmation(dht.identity, prefix, epoch, members,
                                       sealed_keys)
        if any(not m.addr for m in members):
            # client-mode members have no listener: park the confirmation in
            # the leader's mailbox for them to pull. Post BEFORE the sends —
            # a send to a dead follower can still burn its own timeout, and
            # the clients' polling window must not wait on that.
            dht.post(_confirm_tag(prefix, epoch, "clients"), payload,
                     expiration_time=get_dht_time()
                     + matchmaking_time * 4 + 60)
        targets = [m for m in members if m.peer_id != my_id and m.addr]
        if targets:
            # bounded-PARALLEL confirmation fan-out: serially, each send
            # to a dead follower blocked for up to confirm_wait, so a
            # leader confirming K followers took K x confirm_wait — long
            # past every follower's own confirmation deadline. In
            # parallel the whole fan-out is bounded by ~confirm_wait
            # regardless of K; stragglers past the bound are abandoned
            # (their sends self-terminate on their own timeout) and the
            # affected followers fall back to their DHT roster view,
            # the normal degraded path.
            # daemon threads, not a ThreadPoolExecutor: pool workers are
            # non-daemon, so abandoning stragglers with
            # shutdown(wait=False) left up to confirm_wait of exit-time
            # join (threading._shutdown) and tripped thread-hygiene
            # checks. Each send self-terminates on its own confirm_wait
            # timeout either way.
            delivered = [False] * len(targets)

            def _confirm_one(k: int, m: GroupMember) -> None:
                try:
                    delivered[k] = dht.send(
                        m.addr, _confirm_tag(prefix, epoch, m.peer_id),
                        payload, confirm_wait)
                except Exception:  # noqa: BLE001 - counted undelivered
                    logger.debug("confirmation send to %s raised",
                                 m.peer_id[:16], exc_info=True)
            threads = [threading.Thread(target=_confirm_one, args=(k, m),
                                        name=f"confirm-{m.peer_id[:8]}",
                                        daemon=True)
                       for k, m in enumerate(targets)]
            for t in threads:
                t.start()
            bound = time.monotonic() + confirm_wait + 1.0
            for t in threads:
                t.join(max(0.0, bound - time.monotonic()))
            straggling = sum(1 for t in threads if t.is_alive())
            undelivered = sum(
                1 for k, t in enumerate(threads)
                if not t.is_alive() and not delivered[k])
            if undelivered or straggling:
                logger.info(
                    "leader confirmation fan-out: %d/%d send(s) failed, "
                    "%d still in flight at the bound (followers fall "
                    "back to their DHT roster view)", undelivered,
                    len(targets), straggling)
    else:
        awaited_leader = True
        if client_mode and dht._relay_addr is None:
            # plain client mode (no relay): pull from the leader's
            # mailbox; poll, since the leader may still be finishing its
            # own matchmaking window. An addr-less (client-mode) leader
            # has no mailbox to poll — this peer never waits on it, so
            # a missing confirmation is NOT evidence of a vanished
            # leader and must not feed the ledger.
            raw = None
            awaited_leader = bool(leader.addr)
            confirm_deadline = time.monotonic() + confirm_wait
            while raw is None and leader.addr:
                remaining = confirm_deadline - time.monotonic()
                if remaining <= 0:
                    break
                raw = dht.fetch(leader.addr,
                                _confirm_tag(prefix, epoch, "clients"),
                                timeout=min(2.0, remaining))
                if raw is None:
                    time.sleep(min(0.2, max(0.0, confirm_deadline
                                            - time.monotonic())))
        else:
            raw = _recv_leader_confirmation(
                dht, _confirm_tag(prefix, epoch, my_id), prefix, epoch,
                leader.peer_id, authorizer, confirm_wait)
        if raw is not None:
            verified = verify_confirmation(raw, prefix, epoch,
                                           leader.peer_id, authorizer)
            if verified is not None and any(
                    m.peer_id == my_id for m in verified[0]):
                members, sealed_keys = verified
                if encrypt and my_id in sealed_keys:
                    from dalle_tpu_torch.swarm.crypto import open_sealed
                    group_key = open_sealed(dht.kx, sealed_keys[my_id])
            # unsigned/forged/mismatched: fall back to our own DHT view
            # (group_key stays None -> this peer sits the encrypted round
            # out, ban-and-proceed elasticity)
        elif ledger is not None and awaited_leader:
            # the announced leader vanished in the announce->confirm
            # window: the bounded confirm_wait we actually spent
            # waiting elapsed, so the epoch proceeds on our DHT roster
            # view (the dead leader is banned-and-renormalized inside
            # the round) — record the no-show so a flapping leader is
            # down-ranked out of the candidate view for the next few
            # epochs
            ledger.strike(leader.peer_id, "confirm-timeout")

    members = sorted(members, key=lambda m: m.peer_id)
    try:
        my_index = [m.peer_id for m in members].index(my_id)
    except ValueError:
        return None
    return AveragingGroup(members=members, my_index=my_index,
                          group_hash=group_hash_of(members),
                          group_key=group_key)


def _read_candidates(dht: DHT, key: str,
                     authorizer=None, ledger=None) -> List[GroupMember]:
    entries = dht.get(key) or {}
    out = {}
    for _subkey, item in entries.items():
        rec = item.value
        if not isinstance(rec, dict) or "addr" not in rec:
            continue
        # the record is signed; the authoritative peer id comes from the
        # subkey's owner, but we store it redundantly in no field — use
        # the addr-keyed identity the announcer wrote under its own subkey
        pid = dht.bound_peer_id(_subkey)
        if pid is None:
            continue
        if (ledger is not None and pid != dht.peer_id
                and ledger.penalized(pid)):
            # down-ranked repeat offender (recent allreduce bans, see
            # health.py): keep it out of this peer's candidate view
            # until its strikes decay. DEBUG: this poll repeats every
            # ~0.25 s for the whole matchmaking window
            logger.debug("matchmaking: skipping penalized peer %s "
                         "(health score %.1f)", pid[:16], ledger.score(pid))
            continue
        token = bytes(rec.get("tok") or b"")
        if authorizer is not None:
            pk = owner_public_key(_subkey)
            if pk is None or authorizer.validate_token_bytes(
                    token, pk) is None:
                continue  # unauthorized announce: not a candidate
        kx = bytes(rec.get("kx") or b"")
        if len(kx) != 32:
            # a malformed kx must not crash the leader's seal loop (a
            # remotely triggerable DoS); the member just gets no group key
            kx = b""
        out[pid] = GroupMember(pid, str(rec["addr"]),
                               float(rec.get("weight", 1.0)), token, kx)
    return sorted(out.values(), key=lambda m: m.peer_id)
