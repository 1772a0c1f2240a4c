"""The swarm DHT: Python identity/validation over the C++ daemon.

Capability parity with the reference's ``hivemind.DHT`` surface
(learning-at-home/dalle task.py:104-119): construction with initial peers /
client mode / persisted identity, ``store(key, subkey, value,
expiration_time)`` (callback.py:81-86), ``get(key, latest=True)``
(run_aux_peer.py:107), ``peer_id`` (task.py:116), visible addresses
(task.py:118), and ``get_dht_time`` (callback.py:84).

Record validation follows hivemind's validator design (utils.py:27-30 wires
an RSASignatureValidator + pydantic SchemaValidator): signatures bind a
record to the writing peer's public key, schemas reject malformed metrics.
One deliberate difference: hivemind's Python DHT node validates inbound
STOREs server-side; here the store/routing plane is native C++, so
validation runs on the *read* path (every consumer drops forged or
malformed entries) — same end-to-end guarantee, no Python in the daemon.

Values are msgpack-serialized (hivemind's MSGPackSerializer equivalent).
Addresses are ``host:port`` strings (multiaddr-lite).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import struct
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

from dalle_tpu_torch.utils import msgpack

from dalle_tpu_torch.swarm import _native
from dalle_tpu_torch.swarm.identity import Identity

logger = logging.getLogger(__name__)


def get_dht_time() -> float:
    """Swarm-wide clock (hivemind.get_dht_time parity; callback.py:84)."""
    return time.time()


def key_hash(key: Union[str, bytes]) -> bytes:
    if isinstance(key, str):
        key = key.encode()
    return hashlib.sha256(key).digest()


class ValueWithExpiration(NamedTuple):
    value: Any
    expiration_time: float


_OWNER_OPEN = b"[owner:"
_OWNER_CLOSE = b"]"


def _signing_message(khash: bytes, wire_subkey: bytes, value: bytes,
                     expiration: float) -> bytes:
    return khash + wire_subkey + value + struct.pack(">d", expiration)


class RecordValidatorBase:
    """Transforms records on write and checks them on read."""

    def on_store(self, khash: bytes, subkey: bytes, value: bytes,
                 expiration: float) -> Tuple[bytes, bytes]:
        return subkey, value

    def on_read(self, khash: bytes, subkey: bytes, value: bytes,
                expiration: float) -> Optional[Tuple[bytes, bytes]]:
        """(clean_subkey, clean_value) or None to reject the entry."""
        return subkey, value


def owner_public_key(subkey: bytes) -> Optional[bytes]:
    """Public key from an ``[owner:...]``-marked wire subkey, or None."""
    open_at = subkey.rfind(_OWNER_OPEN)
    if open_at < 0 or not subkey.endswith(_OWNER_CLOSE):
        return None
    try:
        return bytes.fromhex(
            subkey[open_at + len(_OWNER_OPEN):-len(_OWNER_CLOSE)].decode())
    except ValueError:
        return None


def strip_owner(subkey: bytes) -> bytes:
    """Wire subkey without its ownership marker (for display/grouping)."""
    open_at = subkey.rfind(_OWNER_OPEN)
    if open_at < 0 or not subkey.endswith(_OWNER_CLOSE):
        return subkey
    return subkey[:open_at]


def owner_bound_peer_id(subkey: bytes) -> Optional[str]:
    """The peer id a subkey claims, verified against its signing key.

    Consumers that interpret a record's subkey as a peer identity (the
    progress tracker, metrics aggregation, matchmaking, state-server
    announcements) must not trust the claimed id alone: a signed record's
    subkey content is attacker-chosen, so a peer could impersonate another
    by writing the victim's id under its OWN valid signature. The binding
    rule: with an ownership marker present, the claimed id must equal
    sha256(owner_pubkey); without a marker (open/unvalidated swarms, e.g.
    tests) the claimed id is returned as-is. Returns None for a marked
    subkey whose claimed id does not match its key (spoofing attempt).
    """
    raw = strip_owner(subkey)
    try:
        claimed = raw.decode()
    except UnicodeDecodeError:
        return None
    public_bytes = owner_public_key(subkey)
    if public_bytes is None:
        return claimed
    if hashlib.sha256(public_bytes).hexdigest() == claimed:
        return claimed
    return None


class SignatureValidator(RecordValidatorBase):
    """Peer-signed subkeys: the public key IS the peer identity.

    Ed25519 stand-in for hivemind's RSASignatureValidator (reference
    utils.py:27-30). Outbound: the wire subkey gains an ``[owner:<pubkey>]``
    suffix and the value a 64-byte signature over (key, subkey, value,
    expiration). Inbound: any owner-marked record with a bad signature is
    dropped. The marker stays in the returned subkey — stripping it would
    let an *unsigned* record with the bare subkey shadow a signed one in
    the freshest-expiration merge. For keys listed in ``protected_keys``,
    unmarked (unsigned) records are rejected outright, so consumers of
    e.g. the metrics key only ever see authenticated entries.
    """

    def __init__(self, identity: Identity,
                 protected_keys: Sequence[Union[str, bytes]] = ()):
        self.identity = identity
        self.ownership_marker = (
            _OWNER_OPEN + identity.public_bytes.hex().encode() + _OWNER_CLOSE)
        self._protected = {key_hash(k) for k in protected_keys}

    def on_store(self, khash, subkey, value, expiration):
        wire_subkey = subkey + self.ownership_marker
        sig = self.identity.sign(
            _signing_message(khash, wire_subkey, value, expiration))
        return wire_subkey, value + sig

    def on_read(self, khash, subkey, value, expiration):
        public_bytes = owner_public_key(subkey)
        if public_bytes is None:
            if khash in self._protected:
                return None  # protected keys accept only signed records
            return subkey, value  # unsigned record on an open key
        if len(value) < 64:
            return None
        payload, sig = value[:-64], value[-64:]
        if not Identity.verify(
                public_bytes, sig,
                _signing_message(khash, subkey, payload, expiration)):
            return None
        return subkey, payload


class SchemaValidator(RecordValidatorBase):
    """Reject records whose decoded value fails a pydantic schema.

    Parity with the reference's ``SchemaValidator(MetricSchema)``
    (utils.py:15-30): ``schemas`` maps the exact DHT key (pre-hash) to a
    pydantic model validated against the msgpack-decoded value.
    """

    def __init__(self, schemas: Dict[str, Any]):
        self._by_hash = {key_hash(k): v for k, v in schemas.items()}

    def on_read(self, khash, subkey, value, expiration):
        model = self._by_hash.get(khash)
        if model is None:
            return subkey, value
        try:
            model.model_validate(msgpack.unpackb(value, raw=False))
        # rejecting unparseable/schema-failing records IS this
        # validator's contract (hostile writers are expected); logging
        # per record would hand floods a log-spam amplifier
        # graftlint: disable=silent-except
        except Exception:  # noqa: BLE001 - any parse/validation error
            return None
        return subkey, value


class DHT:
    """A peer in the swarm: DHT records + tagged data plane.

    Mirrors ``hivemind.DHT(start=True, initial_peers=..., client_mode=...,
    identity_path=..., record_validators=...)`` (reference task.py:104-114).
    """

    def __init__(self,
                 host: str = "127.0.0.1",
                 port: int = 0,
                 initial_peers: Sequence[str] = (),
                 client_mode: bool = False,
                 identity: Optional[Identity] = None,
                 identity_path: Optional[str] = None,
                 record_validators: Sequence[RecordValidatorBase] = (),
                 rpc_timeout: float = 5.0):
        self.identity = identity or Identity.load_or_create(identity_path)
        # per-process X25519 key-agreement keypair for data-plane
        # confidentiality (swarm/crypto.py); its public half rides this
        # peer's signed announces/requests
        from dalle_tpu_torch.swarm.crypto import KxKeypair
        self.kx = KxKeypair()
        self.client_mode = client_mode
        self.validators = list(record_validators)
        self._lib = _native.load()
        self._node = self._lib.swarm_node_create(
            host.encode(), port, self.identity.node_id, int(client_mode))
        if not self._node:
            raise RuntimeError(f"failed to start swarm node on {host}:{port}")
        self._lib.swarm_node_set_timeout(self._node, int(rpc_timeout * 1000))
        self.host = host
        self.port = self._lib.swarm_node_port(self._node)
        self._relay_addr: Optional[str] = None
        # (khash, subkey) pairs already warned about in get(): an
        # undecodable record persists until expiration, so the warning
        # is once per record, not once per poll (capped to bound memory
        # against a flood of distinct malformed records)
        self._undecodable_warned: set = set()
        for addr in initial_peers:
            self.bootstrap(addr)

    # -- identity / addressing ------------------------------------------

    @property
    def peer_id(self) -> str:
        return self.identity.node_id.hex()

    @functools.cached_property
    def signature_enforced(self) -> bool:
        """Whether this node runs a SignatureValidator (validated swarm)."""
        return any(isinstance(v, SignatureValidator) for v in self.validators)

    def bound_peer_id(self, subkey: bytes) -> Optional[str]:
        """The verified peer identity a record subkey claims.

        In a validated swarm (a SignatureValidator is installed) an
        UNMARKED subkey is rejected too: otherwise an attacker could skip
        signing entirely and claim any identity on keys that are not in
        ``protected_keys`` — the exact spoofing the marker check exists to
        stop. Open swarms (no validator, e.g. tests) accept the claimed id.
        """
        bound = owner_bound_peer_id(subkey)
        if bound is None:
            return None
        if self.signature_enforced and owner_public_key(subkey) is None:
            return None
        return bound

    @property
    def visible_address(self) -> str:
        """Copyable --initial_peers entry (reference utils.py:39-56).

        A client-mode peer attached to a relay is reachable at
        ``relay_host:relay_port/<its peer id>`` — the data plane routes
        sends and mailbox fetches through the relay transparently, so a
        relay-attached peer participates (and owns all-reduce parts) like
        a routable one.
        """
        if self._relay_addr is not None:
            return f"{self._relay_addr}/{self.peer_id}"
        return f"{self.host}:{self.port}"

    @property
    def reachable_address(self) -> str:
        """The address other peers can deliver pushes to: the listener, a
        relay route for an attached client-mode peer, or "" for a plain
        client-mode peer (pull-only)."""
        if self._relay_addr is not None:
            return self.visible_address
        return "" if self.client_mode else self.visible_address

    def bootstrap(self, addr: str) -> bool:
        # a relayed address ("host:port/<peer id>") bootstraps off the
        # relay itself — the banner advertises relayed visible_addresses
        # as copyable --initial-peers entries
        host, port, _ = self._parse_addr(addr)
        rc = self._lib.swarm_node_bootstrap(self._node, host.encode(), port)
        return rc == 0

    def attach_relay(self, addr: str) -> bool:
        """Attach to a routable relay peer (reference libp2p relay /
        client_mode surface, arguments.py:89-124): keeps one persistent
        outbound connection over which the relay forwards tagged messages
        and mailbox fetches to this (listener-less) peer.

        Accepts a bare ``host:port`` or a relayed ``host:port/<peer id>``
        entry (what the banner advertises as copyable ``--initial-peers``)
        — attachment always targets the relay's own host:port component
        (``rpartition(':')`` would choke on the /<peer id> suffix)."""
        host, port, _ = self._parse_addr(addr)
        rc = self._lib.swarm_node_attach_relay(
            self._node, host.encode(), port)
        if rc == 0:
            self._relay_addr = f"{host}:{port}"
        return rc == 0

    @staticmethod
    def _parse_addr(addr: str):
        """(host, port, relayed_target_id_bytes | None)."""
        hostport, _, target = addr.partition("/")
        host, _, port = hostport.rpartition(":")
        return host, int(port), bytes.fromhex(target) if target else None

    # -- hole punch --------------------------------------------------------

    @property
    def observed_host(self) -> Optional[str]:
        """This peer's address as seen by its relay (server-reflexive —
        what a NAT'd peer must advertise for punching; the local bind
        address is private). None until a relay attach reported one."""
        out_len = ctypes.c_size_t()
        ptr = self._lib.swarm_node_observed_host(self._node,
                                                 ctypes.byref(out_len))
        if not ptr:
            return None
        return _native.take_buffer(ptr, out_len.value).decode()

    def punch(self, other_addr: str, timeout: float = 15.0) -> bool:
        """DHT-coordinated TCP hole punch toward the (relay-addressed)
        peer at ``other_addr`` (reference: the libp2p daemon's
        transport-level hole punching behind arguments.py:89-124).

        BOTH peers must call punch() toward each other within the window.
        Each binds a socket (the smaller node id will dial, the larger
        accept — native/swarm/swarm.cc), advertises its relay-observed
        host + bound port under a shared DHT key, polls for the other
        side's record, then completes the TCP connection and a signed
        hello. A failed attempt re-binds a fresh port, re-advertises and
        keeps polling (a stale record from the other side's earlier
        attempt is tried at most once). On success every subsequent
        relayed send/fetch to that peer uses the punched link directly;
        the relay stays the fallback if the link dies (half-open links
        are detected by TCP_USER_TIMEOUT and dropped).

        NAT reach (v1): the advertised host is the relay-observed one,
        the port is the local bind — punches succeed on loopback/LAN and
        through NATs that preserve source ports (full-cone); symmetric
        NATs need a STUN-style per-socket probe and stay on the relay.
        """
        _, _, target = self._parse_addr(other_addr)
        if target is None:
            return False
        other_hex = target.hex()
        pair = "|".join(sorted((self.peer_id, other_hex)))
        key = f"punch:{pair}"
        other_sub = other_hex.encode()
        deadline = time.monotonic() + timeout

        def advertise() -> int:
            port = self._lib.swarm_node_punch_prepare(self._node, target)
            if port > 0:
                self.store(key, self.peer_id,
                           {"host": self.observed_host or self.host,
                            "port": port},
                           expiration_time=get_dht_time() + timeout + 5)
            return port

        if advertise() <= 0:
            return False
        tried = None
        while time.monotonic() < deadline:
            got = self.get(key)
            rec = None
            for sub, r in (got or {}).items():
                if strip_owner(sub) == other_sub:
                    rec = (str(r.value["host"]), int(r.value["port"]))
            if rec is not None and rec != tried:
                # cap the per-attempt budget: a stale record (the other
                # side already re-bound) must not burn the whole window —
                # the loop re-polls and picks up the fresh one
                remaining = max(1.0, deadline - time.monotonic())
                attempt = min(remaining, 3.0)
                rc = self._lib.swarm_node_punch_connect(
                    self._node, target, rec[0].encode(), rec[1],
                    int(attempt * 1000))
                if rc == 0:
                    return True
                tried = rec  # stale/failed: re-bind and wait for a fresh one
                if advertise() <= 0:
                    return False
            time.sleep(0.1)
        return False

    def has_direct(self, other_addr: str) -> bool:
        """True if a live punched link exists to the peer id in
        ``other_addr`` (any address form carrying a /<peer id>)."""
        _, _, target = self._parse_addr(other_addr)
        if target is None:
            return False
        return bool(self._lib.swarm_node_has_direct(self._node, target))

    @property
    def relay_traffic_served(self) -> int:
        """Frames this node forwarded in its RELAY role (tests use this
        to observe punched links bypassing the relay)."""
        return int(self._lib.swarm_node_relay_served(self._node))

    # -- records ----------------------------------------------------------

    def store(self, key: Union[str, bytes], subkey: Union[str, bytes, None],
              value: Any, expiration_time: float) -> bool:
        """Signed, replicated store (reference callback.py:81-86)."""
        khash = key_hash(key)
        skey = (subkey.encode() if isinstance(subkey, str)
                else (subkey or b""))
        val = msgpack.packb(value, use_bin_type=True)
        for v in self.validators:
            skey, val = v.on_store(khash, skey, val, expiration_time)
        rc = self._lib.swarm_node_store(
            self._node, khash, skey, len(skey), val, len(val),
            float(expiration_time))
        return rc >= 0

    def get(self, key: Union[str, bytes], latest: bool = True
            ) -> Optional[Dict[bytes, ValueWithExpiration]]:
        """Merged subkey map or None (reference run_aux_peer.py:107).

        ``latest`` is accepted for interface parity; the lookup always
        merges all live replicas keeping the freshest expiration per subkey.
        """
        del latest
        khash = key_hash(key)
        out_len = ctypes.c_size_t()
        ptr = self._lib.swarm_node_get(self._node, khash,
                                       ctypes.byref(out_len))
        if not ptr:
            return None
        buf = _native.take_buffer(ptr, out_len.value)
        entries = _parse_entries(buf)
        result: Dict[bytes, ValueWithExpiration] = {}
        for skey, val, exp in entries:
            clean = (skey, val)
            # peel write-side transformations in reverse order
            for v in reversed(self.validators):
                clean = v.on_read(khash, clean[0], clean[1], exp)
                if clean is None:
                    break
            if clean is None:
                continue
            skey, val = clean
            try:
                decoded = msgpack.unpackb(val, raw=False)
            except Exception:  # noqa: BLE001 - undecodable record
                # a record that passed signature/schema validation but
                # does not unpack means a buggy or hostile writer —
                # dropping it silently hid exactly that once. Warn ONCE
                # per record: the record persists until expiration and
                # get() polls sub-second, so unthrottled warnings would
                # hand a flooder a log-spam amplifier.
                mark = (khash, bytes(skey))
                if mark not in self._undecodable_warned:
                    if len(self._undecodable_warned) < 1024:
                        self._undecodable_warned.add(mark)
                    logger.warning(
                        "dropping undecodable DHT record under key %s "
                        "(subkey %r, %d bytes)", key, skey, len(val),
                        exc_info=True)
                else:
                    logger.debug("dropping undecodable DHT record "
                                 "under key %s (repeat)", key)
                continue
            if skey not in result or exp >= result[skey].expiration_time:
                result[skey] = ValueWithExpiration(decoded, exp)
        return result or None

    # -- data plane (tensor parts for averaging) --------------------------

    def send(self, addr: str, tag: int, payload: bytes,
             timeout: Optional[float] = None) -> bool:
        """One-shot timeouts apply to this send only (the node-wide RPC
        timeout is untouched). ``addr`` may be a plain ``host:port`` or a
        relayed ``relay_host:relay_port/<peer id>``."""
        host, port, target = self._parse_addr(addr)
        timeout_ms = 0 if timeout is None else max(1, int(timeout * 1000))
        if target is not None:
            rc = self._lib.swarm_node_relay_send(
                self._node, host.encode(), port, target, tag,
                payload, len(payload), timeout_ms)
        else:
            rc = self._lib.swarm_node_send(
                self._node, host.encode(), port, tag, payload, len(payload),
                timeout_ms)
        return rc == 0

    def recv(self, tag: int, timeout: float) -> Optional[bytes]:
        out_len = ctypes.c_size_t()
        ptr = self._lib.swarm_node_recv(
            self._node, tag, int(timeout * 1000), ctypes.byref(out_len))
        if not ptr:
            return None
        return _native.take_buffer(ptr, out_len.value)

    def post(self, tag: int, payload: bytes, expiration_time: float) -> bool:
        """Publish into this node's mailbox for remote ``fetch`` (the
        pull half of the data plane, serving client-mode peers that have
        no listener — reference arguments.py:89-92)."""
        rc = self._lib.swarm_node_post(
            self._node, tag, payload, len(payload), float(expiration_time))
        return rc == 0

    def fetch(self, addr: str, tag: int,
              timeout: Optional[float] = None) -> Optional[bytes]:
        """Single-round-trip mailbox read from a remote peer (poll to
        wait). A relayed address fetches THROUGH the relay: the relay
        forwards the request down the target's attachment and returns its
        mailbox answer."""
        host, port, target = self._parse_addr(addr)
        timeout_ms = 0 if timeout is None else max(1, int(timeout * 1000))
        out_len = ctypes.c_size_t()
        if target is not None:
            ptr = self._lib.swarm_node_relay_fetch(
                self._node, host.encode(), port, target, tag, timeout_ms,
                ctypes.byref(out_len))
        else:
            ptr = self._lib.swarm_node_fetch(
                self._node, host.encode(), port, tag, timeout_ms,
                ctypes.byref(out_len))
        if not ptr:
            return None
        return _native.take_buffer(ptr, out_len.value)

    # -- introspection -----------------------------------------------------

    def peers(self) -> Dict[str, str]:
        """{peer_id_hex: "host:port"} routing table dump."""
        out_len = ctypes.c_size_t()
        ptr = self._lib.swarm_node_peers(self._node, ctypes.byref(out_len))
        if not ptr:
            return {}
        buf = _native.take_buffer(ptr, out_len.value)
        off = 4
        count = int.from_bytes(buf[0:4], "big")
        peers = {}
        for _ in range(count):
            pid = buf[off:off + 32].hex()
            off += 32
            hlen = int.from_bytes(buf[off:off + 4], "big")
            off += 4
            host = buf[off:off + hlen].decode()
            off += hlen
            port = int.from_bytes(buf[off:off + 2], "big")
            off += 2
            peers[pid] = f"{host}:{port}"
        return peers

    def shutdown(self) -> None:
        """Destroy the native node. ORDERING CONTRACT: anything that may
        still be calling into this DHT from another thread — a
        CollaborativeOptimizer's overlapped round worker, a StateServer,
        an AveragingAssistant, a RendezvousAdvertiser — must be shut
        down FIRST (``task.shutdown()`` does this); a call into a
        destroyed node is a native use-after-free."""
        if self._node:
            self._lib.swarm_node_destroy(self._node)
            # the ordering contract above IS the happens-before: every
            # worker thread that dereferences _node is joined first
            # graftlint: disable=shared-write-unlocked
            self._node = None

    def __enter__(self) -> "DHT":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def _parse_entries(buf: bytes):
    """Decode the native get() buffer: u32 count, then
    (u32 len subkey, u32 len value, f64 expiration) entries."""
    off = 4
    count = int.from_bytes(buf[0:4], "big")
    out = []
    for _ in range(count):
        slen = int.from_bytes(buf[off:off + 4], "big")
        off += 4
        skey = buf[off:off + slen]
        off += slen
        vlen = int.from_bytes(buf[off:off + 4], "big")
        off += 4
        val = buf[off:off + vlen]
        off += vlen
        (exp,) = struct.unpack(">d", buf[off:off + 8])
        off += 8
        out.append((skey, val, exp))
    return out
