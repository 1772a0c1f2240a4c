"""Aux peer CLI: swarm bootstrap node, metrics aggregator, checkpointer
(the port's ``dalle_tpu/cli/run_aux_peer.py``).

Capability parity with the reference's monitor peer
(``run_aux_peer.py:21-152`` of learning-at-home/dalle): a non-training
peer that (a) anchors the DHT so joiners have a stable ``--initial-peers``
target, (b) aggregates every trainer's signed per-epoch metrics records
into swarm-wide stats each ``refresh_period`` (alive peers, summed
samples/sec, loss — the reference's wandb dashboard, ``:106-144``; here a
JSONL sink and the log, wandb optional), (c) periodically downloads the
freshest training state from the swarm and archives it as a local
checkpoint (``CheckpointHandler``, ``:38-76``; the JAX package's file
layout), uploaded to ``--archive-remote`` when given, and (d) with
``--assist-in-averaging`` joins every gradient round as a weight-0 part
owner (``swarm/assist.py``). ``--chaos-plan`` wraps its DHT in the fault
injector. ``--device`` (default ``cuda``, raising without a GPU) holds the
archived state; it takes the place of the JAX CLI's ``--platform``.

Usage::

    python -m dalle_tpu_torch.cli.run_aux_peer --preset tiny --device cpu \\
        --port 31337 --checkpoint-dir archive/ --assist-in-averaging
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Optional, Sequence

from dalle_tpu_torch.cli import MODEL_PRESETS
from dalle_tpu_torch.cli._args import (add_dataclass_args,
                                       check_no_collisions,
                                       dataclass_from_args)
from dalle_tpu_torch.cli.run_trainer import banner, maybe_wandb_run
from dalle_tpu_torch.config import (AuxConfig, CollabConfig, ModelConfig,
                                    OptimizerConfig, PeerConfig)

logger = logging.getLogger("dalle_tpu_torch.aux")

CONFIG_CLASSES = (ModelConfig, OptimizerConfig, CollabConfig, PeerConfig,
                  AuxConfig)


def build_parser() -> argparse.ArgumentParser:
    check_no_collisions(*CONFIG_CLASSES)
    parser = argparse.ArgumentParser(
        prog="dalle-torch-aux-peer", description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=sorted(MODEL_PRESETS),
                        default="flagship")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu: "
                             "where the archived state is held")
    parser.add_argument("--wandb-project", type=str, default=None,
                        help="log aggregated swarm stats to this wandb "
                             "project (reference run_aux_peer.py:92-93); "
                             "requires wandb to be installed")
    parser.add_argument("--max-rounds", type=int, default=None,
                        help="stop after this many refresh rounds")
    parser.add_argument("--save-every-epochs", type=int, default=2,
                        help="archive swarm state every N global epochs "
                             "(reference pulls every 2, arguments.py:150)")
    parser.add_argument("--metrics-file", type=str, default=None,
                        help="append one JSON line per refresh round")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve the swarm-wide aggregate as "
                             "Prometheus text on this port's /metrics "
                             "(0 = ephemeral)")
    parser.add_argument("--archive-remote", type=str, default=None,
                        help="also upload each archived checkpoint to this "
                             "destination: a directory / file:// URL, a "
                             "gs:// path (gsutil) or an rsync target (the "
                             "reference uploads to the HF Hub, "
                             "run_aux_peer.py:59-76)")
    parser.add_argument("--log-level", type=str, default="INFO")
    for cls in CONFIG_CLASSES:
        add_dataclass_args(parser, cls)
    return parser


_ROBUST_SUM_FIELDS = (
    "parts_audited", "audit_convictions", "repairs_applied",
    "repair_ring_evictions", "ef_lost_rounds", "proofs_published",
    "proofs_convicted", "proofs_rejected")


_FLEET_SUM_FIELDS = (
    ("goodput_img_per_s", "fleet_goodput_img_per_s"),
    ("queue_depth", "fleet_queue_depth"),
    ("live_slots", "fleet_live_slots"),
    ("shed", "fleet_shed"),
    ("prefix_hits", "fleet_prefix_hits"),
    ("prefix_misses", "fleet_prefix_misses"))


def fleet_stats(records):
    """Fleet-wide SERVING stats from the DHT serving records
    (``serving/router.py`` — the same records the router places by):
    engine count plus summed goodput/queue/occupancy/prefix counters.
    Serving peers are optional in a training swarm, so an empty record
    set reports zero engines rather than omitting the keys (the
    /metrics exposition wants stable gauge names)."""
    out = {"fleet_engines": len(records)}
    for src, dst in _FLEET_SUM_FIELDS:
        total = sum(float(r.get(src) or 0) for r in records.values())
        out[dst] = round(total, 4)
    return out


def aggregate(metrics):
    """Swarm-wide stats from per-peer reports (run_aux_peer.py:119-144).

    The robustness counters are cumulative per peer, so the swarm-wide
    view is their sum over every live record, the proof-plane counters
    (proofs published / convicted / rejected) included."""
    if not metrics:
        return {"alive_peers": 0, "epoch": -1, "sum_sps": 0.0,
                "mean_loss": None, "sum_mini_steps": 0,
                **{f: 0 for f in _ROBUST_SUM_FIELDS}}
    epoch = max(m.epoch for m in metrics)
    current = [m for m in metrics if m.epoch == epoch]
    return {
        "alive_peers": len(metrics),
        "epoch": epoch,
        "sum_sps": sum(m.samples_per_second for m in metrics),
        "mean_loss": sum(m.loss for m in current) / len(current),
        "sum_mini_steps": sum(m.mini_steps for m in current),
        **{f: sum(getattr(m, f) for m in metrics)
           for f in _ROBUST_SUM_FIELDS},
    }


def archive_state(task, collab: CollabConfig, ckpt_mgr, uploader=None):
    """Download the freshest swarm state into the task's train state and
    save it as a numbered checkpoint (and the backup); the epoch saved,
    or None when no peer answered."""
    from dalle_tpu_torch.params import load_state_leaves
    from dalle_tpu_torch.swarm.state_transfer import load_state_from_peers

    result = load_state_from_peers(task.dht, collab.run_id,
                                   timeout=collab.averaging_timeout)
    if result is None:
        logger.warning("state archive pull failed this round")
        return None
    epoch, arrays = result
    state = task.train_state
    state.opt_state = load_state_leaves(state.model, state.opt_state,
                                        arrays)
    saved_path = ckpt_mgr.save(state, epoch, backup=True)
    logger.info("archived swarm state at epoch %d", epoch)
    if uploader is not None:
        uploader.submit(saved_path)
    return epoch


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from dalle_tpu_torch.config import TrainerConfig
    from dalle_tpu_torch.serving.router import discover_engines
    from dalle_tpu_torch.swarm.metrics import fetch_metrics
    from dalle_tpu_torch.task import TrainingTask

    model = dataclass_from_args(ModelConfig, args,
                                base=MODEL_PRESETS[args.preset]())
    opt = dataclass_from_args(OptimizerConfig, args)
    collab = dataclass_from_args(CollabConfig, args)
    peer = dataclass_from_args(PeerConfig, args)
    aux = dataclass_from_args(AuxConfig, args)

    task = TrainingTask(model, opt, TrainerConfig(), collab, peer,
                        device=args.device)
    ckpt_mgr = None
    if aux.checkpoint_dir:
        from dalle_tpu_torch.training.checkpoint import CheckpointManager
        # sync writes: the aux peer is off the training path, and the
        # upload worker reads the file right after save returns
        ckpt_mgr = CheckpointManager(aux.checkpoint_dir,
                                     async_writes=False)
    # averaging assist: the reference declares-but-stubs this mode (its
    # run_aux_peer.py:99-104 raises NotImplementedError); here it is
    # weight-0 part ownership in every gradient round (swarm/assist.py),
    # started inside the task context below
    assist = aux.assist_in_averaging
    if assist and collab.grad_compression == "power_sgd":
        logger.warning(
            "assist_in_averaging is OFF: power_sgd rounds exchange "
            "low-rank factors whose flat size an aux peer without a "
            "model cannot reproduce")
        assist = False
    from dalle_tpu_torch.training.remote_sink import RemoteSink, UploadWorker
    remote_sink = RemoteSink.create(args.archive_remote)
    if remote_sink is not None and ckpt_mgr is None:
        logger.warning(
            "--archive-remote %s requires --checkpoint-dir (the local "
            "archive is what gets uploaded): remote archiving is OFF",
            args.archive_remote)
        remote_sink = None
    # one worker + 1-slot latest-wins queue: a slow/hung transfer never
    # stalls the swarm's only monitoring writer, never piles up threads,
    # and the final upload is drained at shutdown
    uploader = UploadWorker(remote_sink, args.archive_remote) \
        if remote_sink is not None else None
    wandb_run = maybe_wandb_run(args.wandb_project,
                                f"aux-{peer.experiment_prefix}")

    # /metrics: the aux peer already aggregates every trainer's signed
    # record each refresh round; the registry source reads the latest
    # aggregate, so a scrape never blocks on the DHT
    latest_stats: dict = {}
    metrics_server = metrics_thread = None
    if args.metrics_port is not None:
        from dalle_tpu_torch.obs.exposition import (MetricsRegistry,
                                                    aggregate_source,
                                                    start_metrics_server)
        registry = MetricsRegistry()
        registry.register("aux", aggregate_source(lambda: latest_stats))
        metrics_server, metrics_thread = start_metrics_server(
            registry, port=args.metrics_port)
        logger.info("serving Prometheus /metrics on port %d",
                    metrics_server.server_address[1])

    last_archived = -1
    rounds = 0
    assistant = None
    try:
        with task:
            banner(task)
            if assist:
                from dalle_tpu_torch.swarm.assist import AveragingAssistant
                assistant = AveragingAssistant(task.dht, collab, model,
                                               authorizer=task.authorizer)
                assistant.start()
            try:
                while args.max_rounds is None or rounds < args.max_rounds:
                    rounds += 1
                    time.sleep(aux.refresh_period)
                    stats = aggregate(fetch_metrics(
                        task.dht, peer.experiment_prefix))
                    # the serving fleet's view, from the DHT serving
                    # records the router places by
                    stats.update(fleet_stats(discover_engines(
                        task.dht, peer.experiment_prefix)))
                    latest_stats = stats
                    logger.info(
                        "round %d: epoch=%s alive=%d sum_sps=%.1f "
                        "mean_loss=%s", rounds, stats["epoch"],
                        stats["alive_peers"], stats["sum_sps"],
                        stats["mean_loss"])
                    if args.metrics_file:
                        with open(args.metrics_file, "a") as f:
                            f.write(json.dumps({"round": rounds, **stats})
                                    + "\n")
                    if wandb_run is not None:
                        wandb_run.log({k: v for k, v in stats.items()
                                       if v is not None})
                    if (ckpt_mgr is not None and aux.store_checkpoints
                            and stats["epoch"] >= 0
                            and stats["epoch"] >= last_archived
                            + args.save_every_epochs):
                        epoch = archive_state(task, collab, ckpt_mgr,
                                              uploader)
                        if epoch is not None:
                            last_archived = epoch
            finally:
                if assistant is not None:
                    # join before the task context tears the DHT down:
                    # an in-flight round may run this long
                    assistant.stop(join_timeout=collab.matchmaking_time
                                   + collab.allreduce_timeout + 5)
    finally:
        # drain the freshest upload and flush wandb even when the loop
        # exits on an exception: the final checkpoint is the one most
        # worth having remotely
        if uploader is not None:
            uploader.close()
        if wandb_run is not None:
            wandb_run.finish()
        if metrics_server is not None:
            metrics_server.shutdown()
            metrics_server.server_close()
            metrics_thread.join(timeout=5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
