"""Rendezvous bootstrap: find the swarm without a hand-passed peer list.

The reference's analogue is libp2p's IPFS-assisted bootstrap
(``use_ipfs``, reference arguments.py:100-106): peers advertise under a
well-known rendezvous point so operators don't have to copy
``--initial_peers`` around. Two mechanisms here, both exercisable
offline (the public IPFS DHT is not):

1. **DHT rendezvous key** — every routable peer stores its address under
   ``{prefix}_rendezvous`` (subkey = peer id, TTL'd like every liveness
   record). A joiner that knows ANY live peer discovers the rest from the
   key — covering the "my initial_peers list is stale/partial" case the
   reference solves by asking IPFS.
2. **Rendezvous file** (``PeerConfig.rendezvous_path``) — a shared
   file (NFS / mounted bucket / shared volume: the fleet amenity a TPU-VM
   pod actually has) where routable peers append ``timestamp addr`` lines
   and joiners with no initial peers read the fresh entries. This is the
   zero-config first-contact channel; the DHT key takes over from there.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import List, Optional

from dalle_tpu_torch.swarm.dht import DHT, get_dht_time

logger = logging.getLogger(__name__)

#: one-time flag for the lockless-filesystem warning in publish()
_FLOCK_WARNED = False

#: rendezvous records expire like the reference's statistics records
#: (arguments.py:129-131) so dead peers age out of discovery
DEFAULT_TTL = 600.0


def rendezvous_key(prefix: str) -> str:
    return f"{prefix}_rendezvous"


def advertise(dht: DHT, prefix: str, ttl: float = DEFAULT_TTL) -> None:
    """Publish this peer's reachable address under the rendezvous key.
    No-op for pull-only peers (nothing reachable to advertise)."""
    addr = dht.reachable_address
    if not addr:
        return
    dht.store(rendezvous_key(prefix), dht.peer_id,
              {"addr": addr, "time": get_dht_time()},
              expiration_time=get_dht_time() + ttl)


def discover(dht: DHT, prefix: str) -> List[str]:
    """Addresses of advertised peers (identity-bound records only),
    excluding self."""
    entries = dht.get(rendezvous_key(prefix)) or {}
    out = []
    for subkey, item in entries.items():
        rec = item.value
        if not isinstance(rec, dict) or "addr" not in rec:
            continue
        pid = dht.bound_peer_id(subkey)
        if pid is None or pid == dht.peer_id:
            continue
        addr = str(rec["addr"])
        if addr:
            out.append(addr)
    return sorted(set(out))


class RendezvousAdvertiser(threading.Thread):
    """Re-publish this peer's rendezvous presence every ``ttl / 3``
    seconds (records and file lines expire after ``ttl`` — a one-shot
    publish at startup would leave late joiners an empty rendezvous 10
    minutes in). Covers both channels: the DHT key
    and, when configured, the shared file."""

    def __init__(self, dht: DHT, prefix: str,
                 rdv_file: Optional["RendezvousFile"] = None,
                 ttl: float = DEFAULT_TTL):
        super().__init__(daemon=True, name="rendezvous-advertiser")
        self.dht = dht
        self.prefix = prefix
        self.rdv_file = rdv_file
        self.ttl = ttl
        self._stop_event = threading.Event()

    def publish_once(self) -> None:
        advertise(self.dht, self.prefix, ttl=self.ttl)
        if self.rdv_file is not None:
            try:
                self.rdv_file.publish(self.dht.peer_id,
                                      self.dht.reachable_address)
            except OSError:
                logger.warning("rendezvous file publish failed",
                               exc_info=True)

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.publish_once()
            except Exception:  # noqa: BLE001 - advertising must not die
                logger.warning("rendezvous advertise failed",
                               exc_info=True)
            self._stop_event.wait(max(1.0, self.ttl / 3))

    def stop(self, join_timeout: Optional[float] = 10.0) -> None:
        """Signal AND (bounded) join: an in-flight publish_once()
        touching a torn-down native DHT node is a use-after-free, so
        the caller must not proceed to DHT.shutdown while this thread
        may still be inside a publish. ``join_timeout=None`` skips the
        join (signal-only)."""
        self._stop_event.set()
        if join_timeout is not None and self.is_alive() \
                and threading.current_thread() is not self:
            self.join(timeout=join_timeout)


class RendezvousFile:
    """Shared-file first contact: ``timestamp peer_id addr`` lines.

    Writers re-publish periodically (callers decide cadence); readers
    take entries fresher than ``max_age``. The rewrite is atomic
    (tempfile + rename) and self-compacting: stale lines and this
    peer's own previous line are dropped on every publish.
    """

    def __init__(self, path: str, max_age: float = DEFAULT_TTL):
        self.path = path
        self.max_age = max_age

    def _read_lines(self) -> List[tuple]:
        out = []
        try:
            with open(self.path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 3:
                        continue
                    try:
                        out.append((float(parts[0]), parts[1], parts[2]))
                    except ValueError:
                        continue
        except FileNotFoundError:
            pass
        return out

    def publish(self, peer_id: str, addr: str) -> None:
        if not addr:
            return  # pull-only peers have nothing to advertise
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        # the read-modify-write must be exclusive: N peers booting at
        # once would otherwise each rewrite the file with only their own
        # line and the last rename wins . flock on a
        # sidecar so readers (which just open the data file) never block.
        with open(self.path + ".lock", "w") as lockf:
            try:
                import fcntl
                fcntl.flock(lockf, fcntl.LOCK_EX)
            except (ImportError, OSError) as e:
                # best-effort on filesystems without lock support — but
                # say so ONCE: the unlocked read-modify-write can lose
                # concurrent publishers' lines , and operators
                # on e.g. NFS-without-lockd should know rendezvous may
                # silently drop peers
                global _FLOCK_WARNED
                if not _FLOCK_WARNED:
                    # warn-once latch: a racing double-warn is the
                    # whole failure mode, and it's cosmetic
                    # graftlint: disable=shared-write-unlocked
                    _FLOCK_WARNED = True
                    logger.warning(
                        "file lock unavailable for %s (%s): rendezvous "
                        "publish falls back to unlocked read-modify-"
                        "write; concurrent publishers may lose lines",
                        self.path, e)
            now = time.time()
            lines = [(t, pid, a) for t, pid, a in self._read_lines()
                     if pid != peer_id and now - t <= self.max_age]
            lines.append((now, peer_id, addr))
            fd, tmp = tempfile.mkstemp(dir=d)
            try:
                with os.fdopen(fd, "w") as f:
                    for t, pid, a in lines:
                        f.write(f"{t:.3f} {pid} {a}\n")
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

    def fresh_peers(self, exclude_peer_id: Optional[str] = None
                    ) -> List[str]:
        now = time.time()
        return sorted({a for t, pid, a in self._read_lines()
                       if now - t <= self.max_age
                       and pid != exclude_peer_id})
