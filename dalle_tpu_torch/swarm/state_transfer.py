"""Peer-to-peer training-state transfer.

Capability parity with hivemind's ``load_state_from_peers`` /
``TrainingStateAverager`` download path (reference callback.py:41,
run_aux_peer.py:48): a joining or recovering peer downloads the latest
params + optimizer state + epoch from any live peer, so the swarm is the
checkpoint.

Mechanism: state servers advertise ``{addr, epoch}`` under
``{prefix}_state_servers`` (TTL'd, dead servers expire away). A client
sends a request carrying its own address and a nonce; the server streams
the serialized state back in chunks over the data plane (frames are capped
well under the transport's 64 MB limit; tensors are compressed with the
same SizeAdaptive codec used for state averaging, task.py:125-126).

The chunked-stream-with-failover shape defined here — advertise servers
under a TTL'd DHT key, pull framed chunks with bounded retries, fail
over to the next advertised server, validate before adopting — is the
template the evidence-by-reference plane
(:class:`~dalle_tpu.swarm.audit.EvidencePlane`) reuses for oversized
audit proofs, with the roles inverted: there the *content hash* is the
advertisement key and integrity gate, here the epoch is.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dalle_tpu_torch.utils import msgpack
import numpy as np
import torch

from dalle_tpu_torch.obs.trace import span as obs_span
from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm.dht import DHT, get_dht_time
from dalle_tpu_torch.swarm.identity import Identity, open_frame, signed_frame

logger = logging.getLogger(__name__)

_CHUNK = 8 << 20  # 8 MB frames (native transport caps at 64 MB)
#: minimum amortized wall grant per outbound stream frame: the stream
#: budget is max(stream_timeout, n_frames * this), so multi-GB states
#: stay servable while a slow client is still bounded per frame
_FRAME_BUDGET_S = 5.0


def _seal_maybe(req_kx: bytes, frame: bytes) -> bytes:
    """Seal a chunk to the requester's kx key when it supplied one, so the
    state stream is confidential to the requester (the signed frame stays
    inside the sealed box — authenticity AND confidentiality)."""
    if not req_kx:
        return frame
    from dalle_tpu_torch.swarm.crypto import seal_to
    return seal_to(req_kx, frame)


def _unseal(dht: DHT, raw: bytes) -> bytes:
    """Open a sealed chunk with this peer's kx key; passthrough for
    plaintext frames (sealed blobs never parse as valid signed frames, so
    a failed guess is harmless)."""
    from dalle_tpu_torch.swarm.crypto import open_sealed
    opened = open_sealed(dht.kx, bytes(raw))
    return opened if opened is not None else bytes(raw)


def _chunk_frame(identity: Identity, prefix: str, nonce: bytes, i: int,
                 n: int, part: bytes) -> bytes:
    """Signed state chunk: an unsigned stream would let any peer that
    learns the nonce poison a joiner's entire training state."""
    head = struct.pack(">II", i, n)
    ctx = b"%s:state:%s" % (prefix.encode(), nonce)
    return signed_frame(identity, ctx, head, part)


def _open_chunk(raw: bytes, prefix: str, nonce: bytes,
                expected_pid: str):
    """(idx, total, payload) iff signed by ``expected_pid``, else None."""
    ctx = b"%s:state:%s" % (prefix.encode(), nonce)
    opened = open_frame(raw, ctx, 8, expected_pid)
    if opened is None:
        return None
    head, payload, _signer = opened
    i, n = struct.unpack(">II", head)
    return i, n, payload


def _req_tag(prefix: str, peer_id: str) -> int:
    d = hashlib.sha256(f"{prefix}:state_req:{peer_id}".encode()).digest()
    return int.from_bytes(d[:8], "big")


def _rsp_tag(prefix: str, nonce: bytes) -> int:
    d = hashlib.sha256(b"%s:state_rsp:%s" % (prefix.encode(), nonce)).digest()
    return int.from_bytes(d[:8], "big")


def _chunk_tag(prefix: str, nonce: bytes, i: int) -> int:
    d = hashlib.sha256(
        b"%s:state_chunk:%s:%d" % (prefix.encode(), nonce, i)).digest()
    return int.from_bytes(d[:8], "big")


def _host_leaf(a) -> Tuple[np.ndarray, str]:
    """A state leaf as a host array and its dtype name. A tensor comes to
    the host; a bfloat16 one as float32 (its values exactly), since numpy
    has no bfloat16 without ``ml_dtypes``."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    a = np.asarray(a)
    return a, a.dtype.name


def serialize_state(epoch: int, arrays: Sequence,
                    codec: Optional[int] = None,
                    adaptive_threshold: int =
                    compression.SIZE_ADAPTIVE_THRESHOLD) -> bytes:
    """Dtype-preserving: float leaves ride the wire codec (lossy for the
    8-bit path, like hivemind's state_averaging_compression); integer
    leaves (step counters, quantized moment codes) are exact raw bytes.
    Leaves are numpy arrays or tensors."""
    frames = []
    for a in arrays:
        a, name = _host_leaf(a)
        if compression.is_float_dtype(name):
            f32 = a.astype(np.float32)
            c = (compression.adaptive_codec(f32.size, adaptive_threshold)
                 if codec is None else codec)
            frames.append({"shape": list(a.shape), "dtype": name,
                           "data": compression.pack_array(f32, c)})
        else:
            frames.append({"shape": list(a.shape), "dtype": name,
                           "raw": a.tobytes()})
    return msgpack.packb({"epoch": int(epoch), "arrays": frames},
                         use_bin_type=True)


def deserialize_state(blob: bytes) -> Tuple[int, List[np.ndarray]]:
    """(epoch, arrays). Float leaves come back as float32 arrays (what the
    codec decoded; a ``bfloat16`` leaf too, cast by whoever adopts it),
    the others in their own dtype."""
    obj = msgpack.unpackb(blob, raw=False)
    arrays = []
    for fr in obj["arrays"]:
        if "raw" in fr:
            arrays.append(np.frombuffer(fr["raw"], np.dtype(fr["dtype"]))
                          .reshape(fr["shape"]).copy())
        else:
            flat, _codec = compression.unpack_array(fr["data"])
            dtype = (np.float32 if fr["dtype"] == "bfloat16"
                     else np.dtype(fr["dtype"]))
            arrays.append(flat.reshape(fr["shape"]).astype(dtype))
    return int(obj["epoch"]), arrays


class StateServer:
    """Background thread serving this peer's training state to the swarm."""

    def __init__(self, dht: DHT, prefix: str,
                 provider: Callable[[], Tuple[int, List[np.ndarray]]],
                 announce_period: float = 15.0,
                 codec: Optional[int] = None,
                 adaptive_threshold: int =
                 compression.SIZE_ADAPTIVE_THRESHOLD,
                 max_concurrent_streams: int = 2,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 stream_timeout: float = 60.0,
                 tracer=None):
        self.dht = dht
        self.prefix = prefix
        self.provider = provider
        # flight recorder (dalle_tpu/obs): each served stream is one
        # span under the request's nonce-derived trace id — the SAME id
        # the requesting peer's state_fetch span carries, so the two
        # sides of a transfer correlate across peers with no clock sync
        self.tracer = tracer
        # wall budget for ONE outbound state stream (floored at
        # _FRAME_BUDGET_S per frame so huge states stay servable);
        # per-frame send timeouts are derived from what remains of it,
        # so a slow or dead client pins a server thread for a bounded
        # amortized grant per frame — not a hard-coded 30 s PER FRAME
        # (a multi-GB state is hundreds of frames). Callers wire the
        # swarm's averaging_timeout here.
        self.stream_timeout = stream_timeout
        # cheap epoch probe so announcements refresh the moment the epoch
        # advances; stale announced epochs otherwise starve resyncing
        # stragglers for a whole period. Without it, announcements stay on
        # the period cadence (probing via the provider would materialize
        # the full state snapshot every loop tick).
        self.epoch_fn = epoch_fn
        self.codec = codec
        self.adaptive_threshold = adaptive_threshold
        self.announce_period = announce_period
        self.key = f"{prefix}_state_servers"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        # streams run on worker threads so a multi-GB transfer neither
        # starves the announce loop (whose record has a 3x TTL) nor
        # serializes behind another joiner's download
        self._stream_slots = threading.Semaphore(max_concurrent_streams)

    def start(self) -> "StateServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _announce(self, epoch: int) -> None:
        self.dht.store(
            self.key, self.dht.peer_id,
            {"addr": self.dht.visible_address, "epoch": int(epoch)},
            expiration_time=get_dht_time() + 3 * self.announce_period)

    def _run(self) -> None:
        tag = _req_tag(self.prefix, self.dht.peer_id)
        last_announce = 0.0
        last_epoch: Optional[int] = None
        while not self._stop.is_set():
            now = time.monotonic()
            epoch: Optional[int] = None
            if self.epoch_fn is not None:
                try:
                    epoch = int(self.epoch_fn())
                except Exception:  # noqa: BLE001 - racing shutdown
                    logger.debug("state-server epoch probe failed "
                                 "(racing shutdown?)", exc_info=True)
                    epoch = last_epoch
            due = now - last_announce >= self.announce_period
            if due or (epoch is not None and epoch != last_epoch):
                try:
                    if epoch is None:
                        epoch = int(self.provider()[0])
                    self._announce(epoch)
                    last_epoch = epoch
                except Exception:  # noqa: BLE001 - dht may be shutting down
                    # a dead announce starves resyncing stragglers for a
                    # whole period — say so (at most once per period)
                    logger.warning("state-server announce failed (dht "
                                   "shutting down?)", exc_info=True)
                last_announce = now
            raw = self.dht.recv(tag, timeout=0.5)
            if raw is None:
                continue
            try:
                req = msgpack.unpackb(raw, raw=False)
                reply_addr, nonce = str(req["addr"]), bytes(req["nonce"])
                req_kx = bytes(req.get("kx") or b"")
            except Exception:  # noqa: BLE001 - malformed request
                logger.warning("dropping malformed state request "
                               "(%d bytes)", len(raw), exc_info=True)
                continue
            if not self._stream_slots.acquire(blocking=False):
                continue  # at capacity: requester retries another server
            threading.Thread(target=self._stream, daemon=True,
                             args=(reply_addr, nonce, req_kx)).start()

    def _stream(self, reply_addr: str, nonce: bytes,
                req_kx: bytes = b"") -> None:
        try:
            with obs_span(self.tracer, "swarm", "state_serve",
                      _xfer_trace(self.prefix, nonce),
                      to=reply_addr or "<mailbox>") as sp:
                epoch, arrays = self.provider()
                blob = serialize_state(epoch, arrays, self.codec,
                                       self.adaptive_threshold)
                sp.set(epoch=epoch, bytes=len(blob))
                if reply_addr:
                    self._send_chunks(reply_addr, nonce, blob, req_kx)
                else:
                    # client-mode requester (no listener): park the
                    # chunks in this server's mailbox for the requester
                    # to pull
                    self._post_chunks(nonce, blob, req_kx)
        except Exception:  # noqa: BLE001 - peer vanished mid-stream
            # the requester retries another server; this side still says
            # which download died so operators can correlate
            logger.warning("state stream to %s failed mid-transfer",
                           reply_addr or "<mailbox>", exc_info=True)
        finally:
            self._stream_slots.release()

    def _post_chunks(self, nonce: bytes, blob: bytes,
                     req_kx: bytes = b"") -> None:
        n = max(1, (len(blob) + _CHUNK - 1) // _CHUNK)
        exp = time.time() + 300.0
        for i in range(n):
            part = blob[i * _CHUNK:(i + 1) * _CHUNK]
            frame = _chunk_frame(self.dht.identity, self.prefix, nonce,
                                 i, n, part)
            frame = _seal_maybe(req_kx, frame)
            self.dht.post(_chunk_tag(self.prefix, nonce, i), frame, exp)

    def _send_chunks(self, addr: str, nonce: bytes, blob: bytes,
                     req_kx: bytes = b"") -> None:
        tag = _rsp_tag(self.prefix, nonce)
        n = max(1, (len(blob) + _CHUNK - 1) // _CHUNK)
        # one deadline for the WHOLE stream: each frame gets what
        # remains of the transfer budget, never a flat per-frame grant
        # that a slow client could collect n times over. The budget
        # scales with the frame count so a state bigger than
        # stream_timeout's worth of wall time stays servable — the
        # floor caps a slow client at ~_FRAME_BUDGET_S per frame
        # AMORTIZED (8 MB frames -> a minimum-bandwidth bar), while a
        # dead client still exits on its first failed send
        budget = max(self.stream_timeout, n * _FRAME_BUDGET_S)
        deadline = time.monotonic() + budget
        for i in range(n):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                logger.warning(
                    "state stream to %s aborted: %d/%d frames within "
                    "the %.0fs stream budget (client too slow or gone)",
                    addr, i, n, budget)
                return
            part = blob[i * _CHUNK:(i + 1) * _CHUNK]
            frame = _chunk_frame(self.dht.identity, self.prefix, nonce,
                                 i, n, part)
            frame = _seal_maybe(req_kx, frame)
            if not self.dht.send(addr, tag, frame,
                                 timeout=min(30.0, remaining)):
                return


def _xfer_trace(prefix: str, nonce: bytes) -> str:
    """The protocol trace id of one state-transfer stream: derived from
    the request nonce, so the requester's ``state_fetch`` span and the
    server's ``state_serve`` span share it across peers."""
    return f"{prefix}:xfer:{nonce.hex()[:12]}"


def _advertised_servers(dht: DHT, prefix: str
                        ) -> List[Tuple[int, str, str]]:
    """Live (advertised_epoch, addr, peer_id) records, freshest first."""
    entries = dht.get(f"{prefix}_state_servers") or {}
    servers = []
    for subkey, item in entries.items():
        rec = item.value
        if not isinstance(rec, dict) or "addr" not in rec:
            continue
        pid = dht.bound_peer_id(subkey)
        if pid is None or pid == dht.peer_id:
            continue
        servers.append((int(rec.get("epoch", 0)), str(rec["addr"]), pid))
    servers.sort(reverse=True)
    return servers


def load_state_from_peers(dht: DHT, prefix: str,
                          min_epoch: int = 0,
                          timeout: float = 60.0,
                          tracer=None
                          ) -> Optional[Tuple[int, List[np.ndarray]]]:
    """Download (epoch, arrays) from the freshest advertised state server.

    Tries servers in descending *advertised* epoch order. Advertisements
    are stale lower bounds (servers re-announce on epoch change, but the
    record still has store/propagation latency), so servers advertising
    less than ``min_epoch`` are still tried; the epoch that matters is the
    one in the downloaded state. If nobody serves ``min_epoch`` or newer,
    the freshest state actually received is returned — catching a
    straggler up partway beats returning nothing.

    Failure handling (the elasticity contract): a server that dies or
    stalls MID-STREAM costs a ~10 s stall window (the chunk collectors'
    no-fresh-chunk abandon) — not the whole timeout — and the client
    moves on to a *different* advertised server; a healthy-but-slow
    stream is never cut off while it makes progress. Once every
    advertised server has been tried the list is re-fetched (new
    servers may have announced meanwhile) with a capped exponential
    backoff between sweeps, until the deadline.
    """
    deadline = time.monotonic() + timeout
    best: Optional[Tuple[int, List[np.ndarray]]] = None
    fail_counts: Dict[str, int] = {}
    backoff = 0.5
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        servers = _advertised_servers(dht, prefix)
        if not servers:
            if not fail_counts and best is None:
                # nobody has EVER advertised a state server (sharded
                # trainers don't run one): the historical fast exit —
                # resync/archive callers poll at their own cadence, and
                # sleeping out their full timeout here pinned the
                # training thread / aux archive for minutes per call.
                # Re-sweeps are only for failing over FROM a server that
                # vanished or stalled mid-stream.
                return None
            time.sleep(min(backoff, remaining))
            backoff = min(backoff * 2, 4.0)
            continue
        # retry order: servers that have not failed on us first, then by
        # advertised freshness — "a different advertised server" before
        # hammering the one that just died mid-stream
        servers.sort(key=lambda s: (fail_counts.get(s[2], 0), -s[0]))
        for advertised, addr, pid in servers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if advertised < min_epoch and best is not None:
                # a fallback is in hand and this server cannot promise
                # better: skip it this sweep
                continue
            # no hard per-attempt cap — a healthy server that is merely
            # slow (big state, thin pipe) keeps the full remaining
            # deadline and is never cut off mid-progress. A DEAD server
            # is abandoned by the chunk collectors' no-fresh-chunk
            # stall window instead, scaled so that even under a short
            # caller timeout one corpse leaves budget for the other
            # advertised servers
            stall = min(10.0, max(2.0, remaining / max(2, len(servers))))
            nonce = os.urandom(16)  # CSPRNG: the freshness binding
            # relay-attached client peers CAN receive pushed chunks
            # (their relay route is the reply address); only plain
            # client mode pays the mailbox-poll pull path
            reply_addr = dht.reachable_address
            # the kx public key lets the server seal chunks so only this
            # requester can read the state stream (swarm/crypto.py)
            req = msgpack.packb({"addr": reply_addr, "nonce": nonce,
                                 "kx": dht.kx.public_bytes},
                                use_bin_type=True)
            # flight recorder: one span per download ATTEMPT under the
            # nonce-derived trace id the server's state_serve span
            # shares (obs/trace.py; ``continue``/``return`` both close
            # the span normally)
            with obs_span(tracer, "swarm", "state_fetch",
                      _xfer_trace(prefix, nonce), server=pid[:16],
                      advertised=advertised) as sp:
                if not dht.send(addr, _req_tag(prefix, pid), req,
                                timeout=min(10.0, remaining)):
                    fail_counts[pid] = fail_counts.get(pid, 0) + 1
                    sp.set(ok=False, why="request-send")
                    continue
                if not reply_addr:
                    blob = _pull_chunks(dht, prefix, addr, nonce,
                                        deadline, pid,
                                        stall_timeout=stall)
                else:
                    blob = _collect_chunks(dht, _rsp_tag(prefix, nonce),
                                           deadline, prefix, nonce,
                                           pid, stall_timeout=stall)
                if blob is None:
                    fail_counts[pid] = fail_counts.get(pid, 0) + 1
                    sp.set(ok=False, why="stream")
                    logger.info(
                        "state stream from %s failed/stalled "
                        "mid-transfer: trying a different server",
                        pid[:16])
                    continue
                try:
                    result = deserialize_state(blob)
                except Exception:  # noqa: BLE001 - corrupt stream
                    fail_counts[pid] = fail_counts.get(pid, 0) + 1
                    sp.set(ok=False, why="corrupt")
                    logger.warning(
                        "corrupt state stream from %s (advertised "
                        "epoch %d): trying the next server", pid,
                        advertised, exc_info=True)
                    continue
                sp.set(ok=True, bytes=len(blob), epoch=result[0])
                if result[0] >= min_epoch:
                    return result
                if best is None or result[0] > best[0]:
                    best = result
        if best is not None and not any(
                adv >= min_epoch and fail_counts.get(pid, 0) == 0
                for adv, _a, pid in servers):
            # nothing un-failed still promises min_epoch: the fallback
            # is the best this swarm can do right now
            break
        # pause between sweeps whether or not this one made progress: a
        # server whose advert runs ahead of its snapshot (announce fires
        # before the epoch's state is applied) serves a stale epoch with
        # no failure recorded, and without growing backoff the loop
        # re-downloads the full state back-to-back until the snapshot
        # catches up
        time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
        backoff = min(backoff * 2, 4.0)
    return best


def _pull_chunks(dht: DHT, prefix: str, addr: str, nonce: bytes,
                 deadline: float, expected_pid: str,
                 stall_timeout: float = 10.0) -> Optional[bytes]:
    """Client-mode download: poll the server's mailbox for each chunk.
    Abandons the stream (returns None) after ``stall_timeout`` seconds
    without a fresh chunk — a server that died mid-stream must cost a
    stall window, not the whole deadline."""
    chunks = {}
    total = None
    i = 0
    last_progress = time.monotonic()
    while time.monotonic() < deadline:
        if time.monotonic() - last_progress >= stall_timeout:
            return None  # mid-stream stall: caller tries another server
        raw = dht.fetch(addr, _chunk_tag(prefix, nonce, i),
                        timeout=min(5.0, max(
                            0.1, deadline - time.monotonic())))
        if raw is None:
            time.sleep(0.2)  # server still serializing/posting
            continue
        opened = _open_chunk(_unseal(dht, raw), prefix, nonce,
                             expected_pid)
        if opened is None:
            return None
        idx, n, part = opened
        if idx != i or (total is not None and n != total):
            return None
        total = n
        chunks[i] = part
        i += 1
        last_progress = time.monotonic()
        if i == total:
            return b"".join(chunks[k] for k in range(total))
    return None


def _collect_chunks(dht: DHT, tag: int, deadline: float, prefix: str,
                    nonce: bytes, expected_pid: str,
                    stall_timeout: float = 10.0) -> Optional[bytes]:
    """Drain the pushed state stream. Abandons (returns None) after
    ``stall_timeout`` seconds without a fresh chunk, so a server that
    died mid-stream costs a stall window, not the caller's deadline."""
    chunks = {}
    total = None
    last_progress = time.monotonic()
    while time.monotonic() < deadline:
        if time.monotonic() - last_progress >= stall_timeout:
            return None  # mid-stream stall: caller tries another server
        raw = dht.recv(tag, timeout=min(
            1.0, max(0.05, deadline - time.monotonic())))
        if raw is None:
            if total is not None and len(chunks) == total:
                break
            continue
        opened = _open_chunk(_unseal(dht, raw), prefix, nonce,
                             expected_pid)
        if opened is None:
            continue
        i, n, part = opened
        total = n if total is None else total
        if n != total or i >= n:
            continue
        chunks[i] = part
        last_progress = time.monotonic()
        if len(chunks) == total:
            break
    if total is None or len(chunks) != total:
        return None
    return b"".join(chunks[i] for i in range(total))
