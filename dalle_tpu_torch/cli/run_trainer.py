"""Trainer peer CLI: join the swarm and train (the port's
``dalle_tpu/cli/run_trainer.py``).

Capability parity with the reference's volunteer entry points
(``run_trainer.py:26-56`` and the host loop ``run_trainer_tpu.py:26-91``):
parse the three-axis config split, assemble the task, print the connection
banner with a copyable ``--initial-peers`` line (``utils.py:39-56``), run
the warmup self-check, then the accumulate -> swarm-step loop (bounded by
``--max-epochs``/``--max-steps``). Every field of the config dataclasses
is a flag (bool fields as ``--x``/``--no-x``); ``--device`` (default
``cuda``, raising without a GPU) takes the place of the JAX CLI's
``--platform``. ``--data-path`` (msgpack code shards: a directory, a file,
a shard URL or a manifest URL) with ``--tokenizer-path`` (a
``tokenizer.json``) trains on real data; without them the peer trains on
``SyntheticCodes``. ``--remat-policy save_ctx`` keeps only the attention
outputs for backward; ``--offload`` keeps the optimizer state in pinned
host memory between updates. The CLI starts no ``torch.distributed``
group of its own: a multi-process peer is a launcher that initialises a
``gloo`` group in each of its processes and then calls :func:`main` there
with the same flags (``parallel/multihost.py``). ``--dp``, ``--fsdp``,
``--tp`` and ``--sp`` lay those processes out as the JAX mesh
(``parallel/mesh.py``), one process a mesh device; a mesh that does not
cover them raises the JAX ``ValueError``. A sharded mesh (``--fsdp``,
``--tp`` or ``--sp`` above 1) trains with its shards; its checkpoints
hold whole leaves, written by the coordinator from every process's
shards. The trust
plane (``--audit-gather``, ``--repair-convicted`` and the rest) is on by
default as in the JAX CLI; ``--grad-compression power_sgd`` with
``--powersgd-rank`` and ``--[no-]powersgd-host-orthogonalize`` selects
PowerSGD.

Usage::

    python -m dalle_tpu_torch.cli.run_trainer --preset tiny --device cpu \\
        --port 31337                                           # first peer
    python -m dalle_tpu_torch.cli.run_trainer --preset tiny --device cpu \\
        --initial-peers 127.0.0.1:31337                        # joiner
    python -m dalle_tpu_torch.cli.run_trainer --preset xl \\
        --remat-policy save_ctx --offload                      # XL, low memory
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

from dalle_tpu_torch.cli import MODEL_PRESETS
from dalle_tpu_torch.cli._args import (add_dataclass_args,
                                       check_no_collisions,
                                       dataclass_from_args)
from dalle_tpu_torch.config import (CollabConfig, ModelConfig,
                                    OptimizerConfig, PeerConfig,
                                    TrainerConfig)

logger = logging.getLogger("dalle_tpu_torch.trainer")

CONFIG_CLASSES = (ModelConfig, OptimizerConfig, TrainerConfig, CollabConfig,
                  PeerConfig)


def maybe_wandb_run(project: Optional[str], name: str):
    """Best-effort wandb run: None when no project is configured or wandb
    is unusable — the JSONL metrics file stays the always-on sink, and a
    missing install / auth failure must never take a training peer
    down."""
    if not project:
        return None
    try:
        import wandb
        return wandb.init(project=project, name=name)
    except Exception:  # noqa: BLE001 - wandb is strictly optional
        logger.warning("wandb unavailable (--wandb-project %s); "
                       "continuing with the metrics file", project,
                       exc_info=True)
        return None


def make_epoch_sink(metrics_file: Optional[str], wandb_run,
                    timings_fn=None):
    """Per-epoch report sink: one JSON line per epoch to
    ``metrics_file`` and, when a wandb run is live, the same scalars
    (timings flattened under ``timings/``) to wandb."""
    def on_epoch(report):
        timings = timings_fn() if timings_fn is not None else {}
        row = {
            "epoch": report.epoch,
            "loss": report.loss,
            "mini_steps": report.mini_steps,
            "samples_per_second": report.samples_per_second,
            "timings": timings,
        }
        if metrics_file:
            with open(metrics_file, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        if wandb_run is not None:
            scalars = {k: v for k, v in row.items()
                       if k != "timings" and v is not None}
            scalars.update({f"timings/{k}": v
                            for k, v in (timings or {}).items()
                            if isinstance(v, (int, float))})
            wandb_run.log(scalars)
    return on_epoch


def build_parser() -> argparse.ArgumentParser:
    check_no_collisions(*CONFIG_CLASSES)
    parser = argparse.ArgumentParser(
        prog="dalle-torch-trainer", description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=sorted(MODEL_PRESETS),
                        default="flagship",
                        help="base model shape that field flags override")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--wandb-project", type=str, default=None,
                        help="log per-epoch training stats to this wandb "
                             "project (requires wandb to be installed)")
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="stop after this many global steps")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many local mini-steps")
    parser.add_argument("--warmup-batches", type=int, default=3,
                        help="self-check steps before joining")
    parser.add_argument("--data-path", type=str, default=None,
                        help="codes dataset: shard dir/file or URL "
                             "(default: synthetic data)")
    parser.add_argument("--tokenizer-path", type=str, default=None,
                        help="tokenizer.json for --data-path")
    parser.add_argument("--metrics-file", type=str, default=None,
                        help="append one JSON line per epoch to this file")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="resume from + checkpoint into this directory "
                             "(reads the JAX trainer's checkpoints too)")
    parser.add_argument("--save-every-epochs", type=int, default=10)
    parser.add_argument("--backup-every-epochs", type=int, default=1)
    parser.add_argument("--keep-checkpoints", type=int, default=3)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of a few early "
                             "steps into this directory")
    parser.add_argument("--log-level", type=str, default="INFO")
    for cls in CONFIG_CLASSES:
        add_dataclass_args(parser, cls)
    return parser


def configs_from_args(args: argparse.Namespace):
    model = dataclass_from_args(ModelConfig, args,
                                base=MODEL_PRESETS[args.preset]())
    return (model,
            dataclass_from_args(OptimizerConfig, args),
            dataclass_from_args(TrainerConfig, args),
            dataclass_from_args(CollabConfig, args),
            dataclass_from_args(PeerConfig, args))


def banner(task) -> None:
    """Connection banner with the copyable joiner line (utils.py:39-56),
    on the coordinator only (the followers of a multi-process peer have no
    DHT to advertise)."""
    if not task.slice_role.swarm_enabled:
        return
    addr = task.dht.visible_address
    logger.info("=" * 60)
    logger.info("peer %s listening on %s", task.dht.peer_id[:16], addr)
    logger.info("to join this swarm, run a peer with:")
    logger.info("    --initial-peers %s", addr)
    logger.info("=" * 60)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from dalle_tpu_torch.task import TrainingTask
    from dalle_tpu_torch.training.loop import train_loop

    model, opt, trainer, collab, peer = configs_from_args(args)
    task = TrainingTask(model, opt, trainer, collab, peer,
                        data_path=args.data_path,
                        tokenizer_path=args.tokenizer_path,
                        device=args.device)

    wandb_run = maybe_wandb_run(args.wandb_project,
                                f"trainer-{peer.experiment_prefix}")
    on_epoch = make_epoch_sink(
        args.metrics_file, wandb_run,
        timings_fn=lambda: task.collab_optimizer.last_timings)

    try:
        with task:
            banner(task)
            reports = train_loop(task,
                                 max_epochs=args.max_epochs,
                                 max_steps=args.max_steps,
                                 warmup_steps=args.warmup_batches,
                                 on_epoch=on_epoch,
                                 checkpoint_dir=args.checkpoint_dir,
                                 save_every=args.save_every_epochs,
                                 backup_every=args.backup_every_epochs,
                                 keep_checkpoints=args.keep_checkpoints,
                                 profile_dir=args.profile_dir)
    finally:
        # flush wandb even when the loop exits on an exception
        if wandb_run is not None:
            wandb_run.finish()
    if reports:
        logger.info("done: %d epochs, final mean loss %.4f",
                    len(reports), reports[-1].loss)
    return 0


if __name__ == "__main__":
    sys.exit(main())
