"""Swarm progress tracking: the DHT epoch clock.

Capability parity with hivemind's ``ProgressTracker`` (used via
``hivemind.Optimizer`` at reference task.py:122-135; surfaced through
``.tracker.global_epoch`` at callback.py:79 and
``.tracker.performance_ema.samples_per_second`` at callback.py:63):

- every peer publishes ``{samples_accumulated, samples_per_second, epoch}``
  into the DHT under ``{run_id}_progress`` (subkey = peer id);
- every peer aggregates all entries to estimate swarm-wide progress toward
  ``target_batch_size`` and decide when the next global step (*epoch*) is
  due. The epoch counter is the global clock of the swarm.

Unlike hivemind this tracker is synchronous: :meth:`report_local_progress`
publishes (throttled) and :meth:`global_progress` fetches (throttled), both
called from the training loop — no background thread, so behavior is
deterministic under test. The DHT record TTL plays the role of hivemind's
liveness: dead peers' contributions expire away
(``statistics_expiration``-style, reference arguments.py:129-131).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

from dalle_tpu_torch.swarm.dht import DHT, get_dht_time

logger = logging.getLogger(__name__)


class PerformanceEMA:
    """Samples/sec exponential moving average (hivemind parity,
    reference callback.py:63)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.samples_per_second = 0.0
        self._last_time: Optional[float] = None

    def update(self, n_samples: int) -> float:
        now = time.perf_counter()
        if self._last_time is not None and n_samples > 0:
            elapsed = max(now - self._last_time, 1e-9)
            rate = n_samples / elapsed
            if self.samples_per_second == 0.0:
                self.samples_per_second = rate
            else:
                self.samples_per_second = (
                    self.alpha * rate
                    + (1 - self.alpha) * self.samples_per_second)
        self._last_time = now
        return self.samples_per_second

    def reset_timer(self) -> None:
        self._last_time = time.perf_counter()


@dataclasses.dataclass
class LocalProgress:
    peer_id: str
    epoch: int
    samples_accumulated: int
    samples_per_second: float
    time: float
    client_mode: bool


@dataclasses.dataclass
class GlobalProgress:
    epoch: int                  # max epoch over live peers
    samples_accumulated: int    # sum over peers at the max epoch
    target_batch_size: int
    num_peers: int
    num_clients: int
    eta_next_epoch: float       # absolute dht-time estimate
    samples_per_second: float   # swarm-wide sum
    # live peers with a published progress record. Differs from
    # num_peers when nobody reports: num_peers floors at 1 (the "alone
    # in the swarm" local view a trainer needs), reporting_peers is 0 —
    # the signal a non-training observer (the averaging assistant) needs
    # to know the swarm is idle.
    reporting_peers: int = 0

    @property
    def ready_to_update(self) -> bool:
        return (self.samples_accumulated >= self.target_batch_size
                or get_dht_time() >= self.eta_next_epoch)


class ProgressTracker:
    def __init__(self, dht: DHT, run_id: str, target_batch_size: int,
                 expected_drift_peers: float = 3.0,
                 metadata_expiration: float = 60.0,
                 min_refresh_period: float = 0.5,
                 client_mode: bool = False,
                 ledger=None,
                 max_peer_samples: Optional[int] = None,
                 overclaim_factor: float = 100.0,
                 max_epoch_lead: int = 2):
        self.dht = dht
        self.key = f"{run_id}_progress"
        self.target_batch_size = target_batch_size
        self.metadata_expiration = metadata_expiration
        self.min_refresh_period = min_refresh_period
        self.client_mode = client_mode
        # optional health.PeerHealthLedger: progress records from peers
        # this node's ledger currently penalizes (repeat allreduce
        # offenders) are ignored in the aggregate — a peer spewing
        # corrupt rounds must not also drive our epoch clock or inflate
        # the swarm's sample total. Strikes decay, so a rehabilitated
        # peer re-enters the aggregate after a few clean epochs.
        self.ledger = ledger
        # Per-peer share cap on the progress aggregate (the progress
        # twin of allreduce's max_peer_weight clamp): one signed record
        # claiming samples_accumulated=1e9 would fire ready_to_update
        # on every honest peer instantly, stealing the epoch
        # advancement the swarm hasn't earned. The CLAMP is the
        # defense: each peer's contribution to the aggregate is capped
        # at the swarm-wide target, so an inflated claim moves the
        # clock by at most one honest peer's worth. The STRIKE fires
        # only far beyond the cap (``overclaim_factor`` x, default
        # 100x): honest overshoot is real and can be large — samples
        # keep accumulating for the whole wall-clock of matchmaking +
        # allreduce, so a fast peer over a slow round legitimately
        # claims MANY multiples of a small target (observed 12x in the
        # 2-peer CPU drive) — while a fabricated claim is orders of
        # magnitude out. Strikes dedup per (peer, claimed epoch) so the
        # sub-second polling loop cannot turn one bad record into a
        # strike flood.
        self.max_peer_samples = (int(target_batch_size)
                                 if max_peer_samples is None
                                 else int(max_peer_samples))
        self.overclaim_factor = overclaim_factor
        # Plausible-lead bound on epoch claims (the epoch twin of the
        # sample cap): the aggregate epoch is max-over-peers, so ONE
        # signed record claiming epoch 10^9 would otherwise drag every
        # honest clock (and the resync target) arbitrarily far. The
        # CLAMP is the defense: a claim may lead this node's local
        # epoch by at most ``max_epoch_lead`` in the aggregate — an
        # honestly-ahead swarm still pulls us forward (the clamp
        # window slides as we catch up, and a state download adopts
        # the server's true epoch regardless). A clamped record also
        # contributes ZERO samples: its samples belong to a round this
        # node cannot place, and merging far-future buckets into the
        # clamped epoch would both overstate progress and hand a liar
        # ready_to_update. The STRIKE mirrors the samples 100x rule —
        # only a lead beyond ``overclaim_factor x max_epoch_lead`` is
        # even a candidate — AND additionally requires an in-bound
        # corroborating reporter (some OTHER peer whose claim is
        # within the bound): if every other reporter is also far
        # ahead, the anomalous clock is OURS (a restart, a resumed
        # checkpoint, a long partition), and striking the whole
        # honest swarm — receipts gossiped — would be this node
        # self-isolating. Honest overshoot is pinned by the
        # slow-round honest-overshoot test. 0 disables the bound.
        self.max_epoch_lead = int(max_epoch_lead)
        self._overclaim_struck: set = set()
        self.performance_ema = PerformanceEMA()
        self.local_epoch = 0
        self.samples_accumulated = 0
        self._last_publish = 0.0
        self._last_fetch = 0.0
        self._cached_global: Optional[GlobalProgress] = None
        del expected_drift_peers  # accepted for config parity

    # -- local side -----------------------------------------------------

    def report_local_progress(self, epoch: int, samples_accumulated: int,
                              force: bool = False) -> None:
        """Publish this peer's progress; throttled to min_refresh_period."""
        new_samples = samples_accumulated - self.samples_accumulated
        if new_samples > 0:
            self.performance_ema.update(new_samples)
        self.local_epoch = epoch
        self.samples_accumulated = samples_accumulated
        now = time.monotonic()
        if not force and now - self._last_publish < self.min_refresh_period:
            return
        self._last_publish = now
        record = {
            "peer_id": self.dht.peer_id,
            "epoch": int(epoch),
            "samples_accumulated": int(samples_accumulated),
            "samples_per_second": float(
                self.performance_ema.samples_per_second),
            "time": get_dht_time(),
            "client_mode": self.client_mode,
        }
        self.dht.store(self.key, self.dht.peer_id, record,
                       expiration_time=get_dht_time()
                       + self.metadata_expiration)

    def reset_epoch(self, epoch: int) -> None:
        """Start accumulating for a new epoch (after a global step)."""
        self.local_epoch = epoch
        self.samples_accumulated = 0
        self.performance_ema.reset_timer()
        self.report_local_progress(epoch, 0, force=True)

    # -- global side ----------------------------------------------------

    def global_progress(self, force_refresh: bool = False) -> GlobalProgress:
        now = time.monotonic()
        if (not force_refresh and self._cached_global is not None
                and now - self._last_fetch < self.min_refresh_period):
            return self._cached_global
        self._last_fetch = now

        entries = self.dht.get(self.key) or {}
        by_peer = {}
        records = []
        # liveness = record TTL: dead peers' entries expire out of the DHT
        for subkey, item in entries.items():
            rec = item.value
            if not isinstance(rec, dict):
                continue
            # the peer identity is the subkey, verified against the record's
            # signing key — a record claiming another peer's id is dropped
            # (and the record's own peer_id field must agree)
            bound = self.dht.bound_peer_id(subkey)
            if bound is None or str(rec.get("peer_id")) != bound:
                continue
            if (self.ledger is not None and bound != self.dht.peer_id
                    and self.ledger.penalized(bound)):
                continue  # down-ranked offender: not part of our clock
            try:
                prog = LocalProgress(
                    peer_id=bound,
                    epoch=int(rec["epoch"]),
                    samples_accumulated=int(rec["samples_accumulated"]),
                    samples_per_second=float(rec["samples_per_second"]),
                    time=float(rec["time"]),
                    client_mode=bool(rec.get("client_mode", False)))
            except (KeyError, TypeError, ValueError):
                continue
            if prog.samples_accumulated < 0:
                continue  # nonsense claim: not part of our clock
            records.append((bound, prog))
        # reporters whose epoch claim is inside the plausible-lead
        # window — the strike's corroboration cohort (see __init__)
        in_bound = {b for b, p in records
                    if p.epoch - self.local_epoch <= self.max_epoch_lead}
        for bound, prog in records:
            lead = prog.epoch - self.local_epoch
            if self.max_epoch_lead > 0 and lead > self.max_epoch_lead:
                corroborated = any(b != bound and b != self.dht.peer_id
                                   for b in in_bound)
                if (bound != self.dht.peer_id
                        and self.ledger is not None
                        and corroborated
                        and lead > self.overclaim_factor
                        * self.max_epoch_lead
                        and ("lead", bound, prog.epoch)
                        not in self._overclaim_struck
                        and len(self._overclaim_struck) < 4096):
                    # strike only the unambiguous fabrication: beyond
                    # 100x the bound (the samples rule's epoch twin)
                    # AND outlying against an in-bound cohort — when
                    # every other reporter is also far ahead, the
                    # stale clock is OURS (restart/partition), and
                    # with no third reporter it is one clock's word
                    # against another's (the 2-peer unattributability
                    # rule). Honest overshoot is clamped, never
                    # struck.
                    self._overclaim_struck.add(
                        ("lead", bound, prog.epoch))
                    self.ledger.strike(bound, "progress-overclaim")
                    logger.warning(
                        "progress: peer %s claims epoch %d (local %d, "
                        "max plausible lead %d) — clamped and struck",
                        bound[:16], prog.epoch, self.local_epoch,
                        self.max_epoch_lead)
                # clamp the clock pull AND zero the samples: they
                # belong to a round this node cannot place, and
                # merging far-future buckets into the clamped epoch
                # would overstate progress (or hand a fabricated
                # claim ready_to_update)
                prog = dataclasses.replace(
                    prog, epoch=self.local_epoch + self.max_epoch_lead,
                    samples_accumulated=0)
            cap = self.max_peer_samples
            if cap > 0 and prog.samples_accumulated > cap:
                if (bound != self.dht.peer_id
                        and self.ledger is not None
                        and prog.samples_accumulated
                        > self.overclaim_factor * cap
                        and (bound, prog.epoch)
                        not in self._overclaim_struck
                        and len(self._overclaim_struck) < 4096):
                    # strike ONLY when the dedup mark landed: once the
                    # set is full (an epoch-churning flooder), further
                    # claims are clamped but not struck — otherwise the
                    # full set would re-enable the exact per-poll
                    # strike/log flood it exists to prevent
                    self._overclaim_struck.add((bound, prog.epoch))
                    self.ledger.strike(bound, "progress-overclaim")
                    logger.warning(
                        "progress: peer %s claims %d samples at epoch "
                        "%d (cap %d) — clamped and struck", bound[:16],
                        prog.samples_accumulated, prog.epoch, cap)
                prog = dataclasses.replace(prog, samples_accumulated=cap)
            by_peer[bound] = prog
        peers = list(by_peer.values())

        if not peers:
            # alone in the swarm: progress is whatever we have locally
            sps = max(self.performance_ema.samples_per_second, 1e-9)
            remaining = max(
                0, self.target_batch_size - self.samples_accumulated)
            result = GlobalProgress(
                epoch=self.local_epoch,
                samples_accumulated=self.samples_accumulated,
                target_batch_size=self.target_batch_size,
                num_peers=1, num_clients=int(self.client_mode),
                eta_next_epoch=get_dht_time() + remaining / sps,
                samples_per_second=self.performance_ema.samples_per_second,
                reporting_peers=0)
            self._cached_global = result
            return result

        epoch = max(p.epoch for p in peers)
        epoch = max(epoch, self.local_epoch)
        current = [p for p in peers if p.epoch == epoch]
        samples = sum(p.samples_accumulated for p in current)
        sps = sum(p.samples_per_second for p in peers)
        remaining = max(0, self.target_batch_size - samples)
        eta = get_dht_time() + remaining / max(sps, 1e-9)
        result = GlobalProgress(
            epoch=epoch, samples_accumulated=samples,
            target_batch_size=self.target_batch_size,
            num_peers=len(peers),
            reporting_peers=len(peers),
            num_clients=sum(1 for p in peers if p.client_mode),
            eta_next_epoch=eta, samples_per_second=sps)
        self._cached_global = result
        return result
