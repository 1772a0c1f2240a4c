"""The trainer peer's host loop: warmup self-check, then accumulate/step
(counterpart of ``dalle_tpu/training/loop.py``).

Capability parity with the reference's host loop
(``run_trainer_tpu.py:47-91``): a few warmup steps validate the step and
the data flow before joining the swarm; then until the epoch or step
budget is spent: draw a batch, run the grad step, hand the gradients to
the collaborative optimizer, and do per-epoch bookkeeping (metrics
publish, checkpoints, NaN rollback) through callbacks. Gradients stay on
the device until the swarm round needs them.

``profile_dir`` takes a ``torch.profiler`` trace (CPU and CUDA activity,
Chrome trace JSON) of local steps ``profile_steps[0]..[1]``.

Every process of a multi-process peer (``parallel/multihost.py``) runs the
loop in lockstep. The coordinator alone touches the checkpoint directory
and publishes metrics; at the start every process adopts the
coordinator's (restored or fresh) state and epoch, and after each global
step a broadcast code tells the followers whether the coordinator rolled
back (then they adopt its state again) or failed on the way (then they
raise instead of waiting for it). On a sharded mesh
(``parallel/sharding.py``) every process also reads the checkpoints,
keeping its shards of their whole leaves, and takes part in each save's
gather and in the finite-parameters check; the coordinator alone writes.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Callable, List, Optional

from dalle_tpu_torch.swarm.metrics import LocalMetrics, publish_metrics
from dalle_tpu_torch.task import TrainingTask

logger = logging.getLogger(__name__)


class EpochReport:
    """What the loop knows at the end of a global step."""

    def __init__(self, epoch: int, loss: float, mini_steps: int,
                 samples_per_second: float):
        self.epoch = epoch
        self.loss = loss
        self.mini_steps = mini_steps
        self.samples_per_second = samples_per_second


def warmup(task: TrainingTask, steps: int = 3) -> float:
    """Run the grad step a few times before joining the swarm (the
    reference's explicit warmup, ``run_trainer_tpu.py:47-57``). Returns the
    last warmup loss; raises if it is not finite."""
    batches = task.batches()
    model = task.collab_optimizer.state.model
    loss = float("nan")
    for i in range(steps):
        t0 = time.monotonic()
        _grads, metrics = task.grad_step(model, next(batches))
        loss = float(metrics["loss"])      # waits for the device
        logger.info("warmup %d/%d: loss=%.4f (%.2fs)",
                    i + 1, steps, loss, time.monotonic() - t0)
    if not math.isfinite(loss):
        raise RuntimeError(f"warmup produced non-finite loss {loss}")
    # warmup gradients are discarded; the tracker timer starts fresh
    task.collab_optimizer.tracker.performance_ema.reset_timer()
    return loss


def train_loop(task: TrainingTask,
               max_epochs: Optional[int] = None,
               max_steps: Optional[int] = None,
               warmup_steps: int = 3,
               publish_metrics_records: bool = True,
               on_epoch: Optional[Callable[[EpochReport], None]] = None,
               on_step: Optional[Callable[[int, float], None]] = None,
               checkpoint_dir: Optional[str] = None,
               save_every: int = 10,
               backup_every: int = 1,
               keep_checkpoints: int = 3,
               profile_dir: Optional[str] = None,
               profile_steps: tuple = (2, 6)
               ) -> List[EpochReport]:
    """Run the peer until ``max_epochs`` global steps (None = forever).

    With ``checkpoint_dir``: resume from the freshest local checkpoint on
    start (reference ``run_trainer.py:55-56``; the port's files and the
    JAX trainer's), write a rolling backup every ``backup_every`` epochs
    and a numbered checkpoint every ``save_every`` (``callback.py:102-113``),
    sweep the params for NaN/Inf after every global step and roll back to
    the backup on corruption (``callback.py:95-100,50-54``).

    Returns the per-epoch reports.
    """
    from dalle_tpu_torch.parallel import multihost
    from dalle_tpu_torch.training.checkpoint import CheckpointManager

    collab = task.collab_optimizer
    coordinator = collab.role.swarm_enabled
    multi = collab.role.n_processes > 1
    # a sharded peer's processes each hold shards: all of them read the
    # checkpoints (each keeping its shards) and take part in each save's
    # gather; the coordinator alone writes
    sharded = getattr(collab.state.model, "mesh", None) is not None
    ckpt = None
    if checkpoint_dir is not None and (coordinator or sharded):
        # a multi-process peer: only the coordinator writes the checkpoint
        # directory; its (restored or fresh) state is broadcast below
        ckpt = CheckpointManager(checkpoint_dir, keep=keep_checkpoints,
                                 write=coordinator)
        with collab.state_lock:
            restored = ckpt.restore_latest(collab.state)
        if restored is not None:
            state, epoch = restored
            collab.state = state
            collab.local_epoch = max(collab.local_epoch, epoch)
            collab.tracker.reset_epoch(collab.local_epoch)
            logger.info("resumed from local checkpoint at epoch %d", epoch)
            # if the swarm is ahead, the straggler-resync path in
            # collab.step() will still pull fresher state from peers
    if multi:
        # align every process on the coordinator's initial state (a fresh
        # init is seed-identical, but a restore is the coordinator's alone)
        _align(collab, coordinator)
    if warmup_steps:
        warmup(task, warmup_steps)

    reports: List[EpochReport] = []
    loss_sum, mini_steps, local_steps = 0.0, 0, 0
    profiler = _StepProfiler(profile_dir, profile_steps)
    batches = task.batches()
    try:
        while ((max_epochs is None or collab.local_epoch < max_epochs)
               and (max_steps is None or local_steps < max_steps)):
            profiler.tick(local_steps)
            batch = next(batches)
            grads, metrics = task.grad_step(collab.state.model, batch)
            loss = float(metrics["loss"])
            loss_sum += loss
            mini_steps += 1
            local_steps += 1
            if on_step is not None:
                on_step(local_steps, loss)

            epoch_before = collab.local_epoch
            did_global = collab.step(grads,
                                     batch_size=task.local_batch_size)
            del grads
            if logger.isEnabledFor(logging.DEBUG):
                prog = collab.round_progress()
                if prog is not None:
                    logger.debug(
                        "round in flight (epoch %d): scatter=%d "
                        "reduce=%d gather=%d parts done, %d grad steps "
                        "overlapped", prog["epoch"], prog["scatter"],
                        prog["reduce"], prog["gather"],
                        prog["overlapped_steps"])
            rolled_back = False
            if did_global and ckpt is not None:
                try:
                    rolled_back = _checkpoint_epoch(collab, ckpt, save_every,
                                                    backup_every, sharded)
                except BaseException:
                    # a coordinator dying between the global step and the
                    # rollback broadcast would leave every follower
                    # waiting in broadcast_decision: send the abort code
                    # first, then re-raise
                    if multi:
                        multihost.broadcast_decision(_ABORT)
                    raise
            if did_global and multi:
                # a coordinator-side rollback re-aligns the followers
                code = multihost.broadcast_decision(
                    _ROLLED_BACK if rolled_back else _KEEP)
                if code == _ABORT:
                    raise RuntimeError("the peer's coordinator failed "
                                       "during checkpoint handling")
                if code == _ROLLED_BACK:
                    _align(collab, coordinator)
            if collab.local_epoch != epoch_before:
                # global step OR resync-from-peers: either way a new epoch
                report = EpochReport(
                    epoch=collab.local_epoch,
                    loss=loss_sum / max(mini_steps, 1),
                    mini_steps=mini_steps,
                    samples_per_second=(
                        collab.tracker.performance_ema.samples_per_second))
                reports.append(report)
                if did_global and publish_metrics_records and coordinator:
                    robust = collab.robustness_snapshot()
                    publish_metrics(
                        task.dht, task.peer_cfg.experiment_prefix,
                        LocalMetrics(
                            peer_id=task.dht.peer_id,
                            epoch=report.epoch,
                            samples_per_second=report.samples_per_second,
                            samples_accumulated=0,
                            loss=report.loss,
                            mini_steps=report.mini_steps,
                            parts_audited=robust["parts_audited"],
                            audit_convictions=(robust["audit_fail"]
                                               + robust["audit_omit"]),
                            repairs_applied=robust["repairs_applied"],
                            repair_ring_evictions=robust["ring_evictions"],
                            ef_lost_rounds=robust["ef_lost_rounds"],
                            proofs_published=robust["proofs_published"],
                            proofs_convicted=robust["proofs_convicted"],
                            proofs_rejected=robust["proofs_rejected"]),
                        expiration=task.collab_cfg.metrics_expiration)
                logger.info(
                    "epoch %d: mean_loss=%.4f mini_steps=%d sps=%.1f%s",
                    report.epoch, report.loss, report.mini_steps,
                    report.samples_per_second,
                    (" hops=%s" % (collab.last_timings["round_hops"],)
                     if "round_hops" in collab.last_timings else ""))
                if on_epoch is not None:
                    on_epoch(report)
                loss_sum, mini_steps = 0.0, 0
        # an overlapped round may still be in flight when the loop exits:
        # apply it rather than lose the epoch's averaging — EXCEPT when the
        # epoch budget is already spent (applying it would overshoot the
        # caller's contract)
        if max_epochs is not None and collab.local_epoch >= max_epochs:
            collab.drop_pending_round()
        elif collab.finalize():
            if mini_steps > 0:
                reports.append(EpochReport(
                    epoch=collab.local_epoch,
                    loss=loss_sum / mini_steps,
                    mini_steps=mini_steps,
                    samples_per_second=(
                        collab.tracker.performance_ema.samples_per_second)))
            if ckpt is not None and _finite(collab, sharded):
                ckpt.save_backup(collab.state, collab.local_epoch)
    finally:
        profiler.close()
        if ckpt is not None:
            ckpt.close()  # drain async checkpoint writes before returning
    # no process of a peer returns before the coordinator's checkpoint
    # writes have landed
    multihost.sync()
    return reports


#: the codes the coordinator broadcasts after each global step
_KEEP, _ROLLED_BACK, _ABORT = 0, 1, 2


def _finite(collab, sharded: bool) -> bool:
    """Whether the parameters are finite: on a sharded peer, every
    process's shards (a collective)."""
    from dalle_tpu_torch.parallel import multihost
    from dalle_tpu_torch.training.checkpoint import params_are_finite
    finite = params_are_finite(collab.state.model)
    return multihost.all_processes(finite) if sharded else finite


def _checkpoint_epoch(collab, ckpt, save_every: int, backup_every: int,
                      sharded: bool = False) -> bool:
    """After a global step: roll back to the local backup when the
    parameters are not finite (returns True), else write the epoch's
    checkpoint and backup as scheduled. On a sharded peer every process
    runs it (the checks, restores and saves are collectives)."""
    from dalle_tpu_torch.parallel import multihost
    epoch = collab.local_epoch
    if not _finite(collab, sharded):
        logger.warning("non-finite params after epoch %d: rolling back to "
                       "the local backup", epoch)
        # a round launched in the same step() that reconciled the
        # NaN-producing apply carries the divergent trajectory's
        # gradients: discard it before restoring
        collab.drop_pending_round()
        if sharded:
            # the coordinator's queued writes land before any process
            # reads the backup
            ckpt.flush()
            multihost.sync()
        with collab.state_lock:
            restored = ckpt.restore_backup(collab.state)
            if restored is None:
                restored = ckpt.restore_latest(collab.state)
        if restored is None:
            raise RuntimeError("params corrupted and no backup to restore")
        collab.state, backup_epoch = restored
        collab.local_epoch = backup_epoch
        collab.tracker.reset_epoch(backup_epoch)
        return True
    do_backup = backup_every and epoch % backup_every == 0
    if save_every and epoch % save_every == 0:
        ckpt.save(collab.state, epoch, backup=do_backup)
    elif do_backup:
        ckpt.save_backup(collab.state, epoch)
    return False


def _align(collab, coordinator: bool) -> None:
    """Every process of a multi-process peer adopts the coordinator's
    state and epoch (the broadcasts of ``parallel/multihost.py``)."""
    from dalle_tpu_torch.parallel import multihost
    leaves = collab._state_leaves()
    leaves = multihost.broadcast_arrays(leaves if coordinator else None,
                                        like=leaves)
    collab._replace_state_leaves(leaves)
    collab.local_epoch = multihost.broadcast_decision(collab.local_epoch)
    collab.tracker.reset_epoch(collab.local_epoch)


class _StepProfiler:
    """Start/stop a ``torch.profiler`` trace over a window of local steps;
    a close() in the loop's ``finally`` writes the trace even when the run
    dies mid-window."""

    def __init__(self, profile_dir: Optional[str], steps: tuple):
        self.dir = profile_dir
        self.first, self.last = steps
        self.prof = None

    def tick(self, local_step: int) -> None:
        if self.dir is None:
            return
        if local_step == self.first and self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        elif local_step >= self.last and self.prof is not None:
            self._stop()

    def close(self) -> None:
        if self.prof is not None:
            self._stop()

    def _stop(self) -> None:
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
