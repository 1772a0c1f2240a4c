"""Averaging-assist aux mode: bandwidth-donor participation in the
gradient all-reduce (counterpart of ``dalle_tpu/swarm/assist.py``; a port
assistant serves a part in a round of JAX trainers and a JAX assistant in
a round of port trainers, as the wire is one).

The reference DECLARES this mode and stubs it with ``NotImplementedError``
(learning-at-home/dalle run_aux_peer.py:99-104, ``--assist_in_averaging``);
here it is implemented: an aux peer joins each epoch's matchmaking with
``weight=0`` and a zero gradient vector of the run's flat size. Weight-0
members own an all-reduce part like any routable member — absorbing a
1/(owners) share of every trainer's reduce/gather traffic — but
contribute no data (they skip the scatter phase, receivers never wait on
them, and they skip collecting the averaged result; swarm/allreduce.py).
The assist is PURE capacity, and what it buys is part-SERVING load, not
raw per-trainer byte totals (those redistribute: scatter upload rises
with the extra owner while gather upload falls): each assistant absorbs
a ``1/(owners)`` share of the reduce fan-in and gather fan-out that the
routable trainers would otherwise serve — decisive when volunteer
up-links are the bottleneck (gather parts now come from the aux's fat
pipe) and in client-mode-heavy swarms, where the few routable trainers
are the only part owners until assistants join.

An assistant that dies mid-round degrades exactly like any dead part
owner (the elasticity path: its part falls back to each trainer's local
values and the round reports incomplete) — assisting never makes a round
less reliable than running it without the assistant, except that the
round's part layout included it.

Not supported with ``grad_compression="power_sgd"``: those rounds
exchange per-matrix low-rank factors whose flat size depends on the
compressor's device state, which an aux peer without a model cannot
reproduce. The CLI refuses the combination loudly.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from dalle_tpu_torch.config import CollabConfig, ModelConfig
from dalle_tpu_torch.swarm.allreduce import run_allreduce
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.matchmaking import make_group
from dalle_tpu_torch.swarm.progress import ProgressTracker

logger = logging.getLogger(__name__)


def grad_flat_elements(model_cfg: ModelConfig) -> int:
    """Flat element count of the run's gradient vector (the unique
    parameter tree the trainers exchange, every slice of a stacked
    ``dense_scan`` leaf included) — counted on the meta device, no
    parameters allocated."""
    import torch

    from dalle_tpu_torch.models.dalle import DALLE

    with torch.device("meta"):
        model = DALLE(model_cfg)
    return int(sum(p.numel() for p in model.parameters()))


def assist_one_round(dht: DHT, cfg: CollabConfig, epoch: int,
                     template: np.ndarray, authorizer=None,
                     codec: Optional[int] = None,
                     gather_codec: Optional[int] = None,
                     pin_codec: bool = False,
                     audit_policy=None) -> str:
    """Join epoch ``epoch``'s gradient matchmaking as a weight-0 member
    and, if a real group forms, serve as a part owner for its all-reduce.

    Returns ``"assisted"`` (at least one contributor's data reached this
    peer's part), ``"empty"`` (a group formed but NOTHING parseable
    arrived — with a healthy network that means this assistant's flat
    size disagrees with the trainers', i.e. a model-config mismatch), or
    ``"idle"`` (no group with contributors formed).

    ``codec``/``gather_codec``/``pin_codec`` must match the trainers'
    wire codec choice (None = the size-adaptive default; the r15
    wire_bits knobs map exactly as the optimizer maps them) — each
    owner compresses the part it gathers, so an assistant with a
    different codec would gather its part at different fidelity than
    trainer-owned parts, and on a PINNED run the trainers would ban a
    wrong-codec assistant's part outright as codec flapping.

    ``audit_policy`` (optional :class:`~dalle_tpu_torch.swarm.audit
    .AuditPolicy`) arms the OWNER side of the verified-aggregation
    layer: an assistant owns a part like any routable member, so when
    the deterministic challenge names its part it must retain the
    frames it averaged and serve the signed transcript — an r14 gap:
    trainers audited assistant-owned parts but honest assistants never
    posted, earning steady ``audit-timeout`` strikes. The assistant
    audits nobody in return (weight 0: it gathers no parts and
    scatters nothing, so it has neither replay targets nor omission
    standing) — the RoundAudit here is pure owner-side duty."""
    group = make_group(
        dht, f"{cfg.run_id}_grads", epoch, weight=0.0,
        matchmaking_time=cfg.matchmaking_time, min_group_size=2,
        authorizer=authorizer, encrypt=cfg.encrypt_data_plane)
    if group is None or group.size <= 1:
        return "idle"
    if not any(m.weight > 0 for m in group.members):
        return "idle"  # a lobby of assistants has nothing to average
    report: dict = {}
    ra = None
    if audit_policy is not None:
        from dalle_tpu_torch.swarm.audit import RoundAudit
        ra = RoundAudit(f"{cfg.run_id}_grads", epoch, audit_policy)
    # assistants honor the configured codec backend too: an aux host
    # with an accelerator runs its (large) share of codec work there
    from dalle_tpu_torch.swarm.device_codec import resolve_backend
    run_allreduce(dht, group, f"{cfg.run_id}_grads", epoch, [template],
                  weight=0.0, allreduce_timeout=cfg.allreduce_timeout,
                  codec=codec, gather_codec=gather_codec,
                  pin_codec=pin_codec,
                  adaptive_threshold=cfg.size_adaptive_threshold,
                  report=report, audit=ra,
                  codec_backend=resolve_backend(
                      getattr(cfg, "wire_codec_backend", "auto")))
    return "assisted" if report.get("reduced_senders", 0) > 0 else "empty"


class AveragingAssistant(threading.Thread):
    """Background loop: follow the run's progress tracker and join every
    epoch's gradient round as a weight-0 part owner.

    The loop re-announces continuously (each ``make_group`` call both
    announces and waits out the stability window), so whenever the
    trainers hit ``target_batch_size`` and matchmake, the assistant's
    fresh announce is in their candidate set. A missed window degrades to
    a round without the assistant (or, rarely, to the dead-owner
    elasticity path if trainers confirmed a roster the assistant had
    already abandoned)."""

    def __init__(self, dht: DHT, cfg: CollabConfig,
                 model_cfg: ModelConfig, authorizer=None):
        super().__init__(daemon=True, name="averaging-assistant")
        if cfg.grad_compression == "power_sgd":
            # refuse HERE, not only in the aux CLI: power_sgd rounds
            # exchange low-rank factors whose flat size depends on the
            # compressor's device state, which an aux peer without a
            # model cannot reproduce — and _CODECS has no power_sgd
            # entry, so run() would die with an unlogged KeyError
            raise ValueError(
                "assist_in_averaging is unsupported with "
                "grad_compression='power_sgd'")
        self.dht = dht
        self.cfg = cfg
        self.authorizer = authorizer
        self._n_elements = grad_flat_elements(model_cfg)
        self._stop_event = threading.Event()
        self.rounds_assisted = 0

    def stop(self, join_timeout: Optional[float] = 5.0) -> None:
        """Signal AND (bounded) join. The default bound only covers the
        idle polls; a stop during an in-flight assisted round needs the
        round deadlines — pass ``join_timeout=matchmaking_time +
        allreduce_timeout + slack`` (as run_aux_peer does) to guarantee
        the thread is gone before the DHT is torn down, or ``None`` to
        skip the join (signal-only). The thread is a daemon either way:
        a missed bound degrades to process-exit cleanup, never a hang."""
        self._stop_event.set()
        if join_timeout is not None and self.is_alive() \
                and threading.current_thread() is not self:
            self.join(timeout=join_timeout)

    def run(self) -> None:  # pragma: no cover - exercised via tests' join
        # the trainers' wire codec: each owner compresses the part it
        # gathers, so the assistant's part must ride the SAME codec or
        # 1/N of every gradient step silently changes fidelity — and on
        # an r15 wire_bits run the trainers PIN the codec, so a
        # mismatched assistant would be banned as codec flapping. Map
        # the knobs exactly as CollaborativeOptimizer maps them.
        from dalle_tpu_torch.swarm.compression import codec_for_bits
        from dalle_tpu_torch.swarm.optimizer import _CODECS
        wb_r = getattr(self.cfg, "wire_bits_reduce", None)
        wb_g = getattr(self.cfg, "wire_bits_gather", None)
        codec = (codec_for_bits(wb_r) if wb_r is not None
                 else _CODECS[self.cfg.grad_compression])
        gather_codec = codec_for_bits(wb_g)
        pin = wb_r is not None or wb_g is not None
        # owner-side audit duty (see assist_one_round): the assistant
        # must answer challenges on the part it owns, or every trainer
        # down-ranks it with audit-timeout strikes
        audit_policy = None
        if getattr(self.cfg, "audit_gather", False):
            from dalle_tpu_torch.swarm.audit import AuditPolicy
            audit_policy = AuditPolicy(frac=self.cfg.audit_frac,
                                       ttl=self.cfg.audit_ttl)
        template = np.zeros(self._n_elements, np.float32)
        tracker = ProgressTracker(self.dht, self.cfg.run_id,
                                  self.cfg.target_batch_size)
        logger.info("averaging assistant up: %d grad elements (%.1f MB "
                    "f32 parts pool)", self._n_elements,
                    self._n_elements * 4 / 1e6)
        # last epoch this assistant is DONE with — set on "assisted" AND
        # on a CONFIRMED "empty" (a group formed; whatever it was, this
        # epoch's announces are spent): re-joining the same epoch would
        # only matchmake against the round's stale announces and burn
        # another window, possibly costing trainers an elasticity
        # timeout each time (ADVICE r4). One exception (r20): the FIRST
        # "empty" on an epoch gets one retry before the epoch is marked
        # handled — an assistant that matchmade a beat early can form a
        # stragglers-only group and see nothing parseable while the
        # epoch's REAL round is still ahead; writing the epoch off on
        # that single sample forfeits an assist a second window often
        # wins. "idle" keeps retrying — the epoch's real round may
        # simply not have started yet, and camping through the window
        # is how the assistant's announce makes the roster.
        last_handled = -1
        empty_streak = 0
        retried_epoch = -1
        while not self._stop_event.is_set():
            try:
                progress = tracker.global_progress(force_refresh=True)
                if progress.reporting_peers == 0:
                    # nobody training (num_peers floors at 1 — the
                    # trainer-facing "alone" view — so test the raw
                    # record count): don't camp in the matchmaking key.
                    # Poll briskly — a trainer's first epoch can go from
                    # first progress report to matchmaking in a second.
                    self._stop_event.wait(0.5)
                    continue
                if progress.epoch <= last_handled:
                    self._stop_event.wait(0.5)
                    continue
                outcome = assist_one_round(self.dht, self.cfg,
                                           progress.epoch, template,
                                           self.authorizer, codec=codec,
                                           gather_codec=gather_codec,
                                           pin_codec=pin,
                                           audit_policy=audit_policy)
                if outcome == "assisted":
                    self.rounds_assisted += 1
                    last_handled = progress.epoch
                    empty_streak = 0
                    logger.info("assisted epoch %d (total %d rounds)",
                                progress.epoch, self.rounds_assisted)
                elif outcome == "empty":
                    if retried_epoch != progress.epoch:
                        # first empty on this epoch: retry once before
                        # permanently marking it handled
                        retried_epoch = progress.epoch
                        logger.info(
                            "assist round for epoch %d was empty — "
                            "retrying once before writing the epoch "
                            "off", progress.epoch)
                        continue
                    empty_streak += 1
                    last_handled = progress.epoch
                    if empty_streak >= 3:
                        # groups form but NOTHING this assistant can
                        # parse ever arrives: almost certainly this aux
                        # peer's model preset/flags disagree with the
                        # trainers' (different flat grad size -> every
                        # chunk fails geometry checks). Keep monitoring
                        # duties but back off the assist loop hard —
                        # occupying a part slot while unparseable is
                        # WORSE than not assisting.
                        logger.error(
                            "%d consecutive DISTINCT epochs' assisted "
                            "rounds received no parseable contribution — "
                            "almost certainly a model config mismatch "
                            "with the trainers (this peer expects %d "
                            "grad elements). Backing off 60s",
                            empty_streak, self._n_elements)
                        self._stop_event.wait(60.0)
            except Exception:  # noqa: BLE001 - a failed round must not
                # take the aux peer's monitoring duties down with it
                logger.warning("assist round failed", exc_info=True)
                self._stop_event.wait(1.0)
