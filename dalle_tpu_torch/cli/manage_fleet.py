"""Provision a fleet of Spot H100 VM trainer peers on GCP (the port's
``dalle_tpu/cli/manage_fleet.py``).

Capability parity with the reference's Azure VMSS fleet
(``manage_scaleset.py:84-236`` of learning-at-home/dalle: create/delete a
scale set of 4 spot GPU VMs whose cloud-init installs the stack and joins
the swarm pointing at a hard-coded initial peer, with
``spot_restore_policy`` re-creating evicted VMs). Each worker is a Spot
Compute Engine VM with one H100, made by ``gcloud compute instances
create`` (no cloud SDK to pin) with these documented flags:
``--machine-type`` (default ``a3-highgpu-1g``, GCP's one-H100 A3 type,
whose GPU comes with the machine type), ``--provisioning-model=SPOT``,
``--instance-termination-action=DELETE``,
``--maintenance-policy=TERMINATE`` (a GPU VM cannot live-migrate),
``--image-family`` / ``--image-project`` (default a Deep Learning VM
PyTorch image, with the ``install-nvidia-driver=True`` metadata key),
``--boot-disk-size=200GB`` and ``--metadata=startup-script=...``. The
startup script clones the repository and launches ``python3 -m
dalle_tpu_torch.cli.run_trainer --device cuda`` from the clone into the
swarm: it installs nothing (the image carries PyTorch, Triton and the CUDA
toolkit; no JAX, no package of finished kernels) and the kernels build at
their first use, as ``chip_smoke.py`` builds them. Credentials come from
the instance's metadata or environment, never from the script's text.

The JAX CLI's TPU flags map onto the card's: ``--accelerator-type`` (a TPU
slice) becomes ``--machine-type``, and ``--runtime-version`` (the TPU VM
image) becomes ``--image-family`` with ``--image-project``. Its queued
resources become plain instances. An eviction deletes the VM (the
termination action) and is a graceful peer departure for the swarm
(``swarm/matchmaking.py``); running ``create`` again re-creates the
missing workers, the ``spot_restore_policy`` analogue, as in the JAX
package.

Every gcloud invocation is printed, and ``--dry-run`` prints without
executing: the fleet logic is testable with no cloud account.

Usage::

    python -m dalle_tpu_torch.cli.manage_fleet create \\
        --project my-proj --zone us-central1-a --swarm-size 4 \\
        --initial-peer 10.0.0.2:31334 [--dry-run]
    python -m dalle_tpu_torch.cli.manage_fleet delete --project ... --zone ...
    python -m dalle_tpu_torch.cli.manage_fleet list --project ... --zone ...
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from typing import List, Optional, Sequence

FLEET_PREFIX = "dalle-h100-worker"

# The reference bakes worker bootstrap into cloud-init
# (manage_scaleset.py:24-81); here a VM startup script. The swarm address
# and experiment knobs are interpolated; credentials never are (the
# reference's inline github/wandb tokens are exactly what not to copy).
# gcloud splits --metadata at commas, so the script holds none.
STARTUP_SCRIPT = """#!/bin/bash
set -ex
mkdir -p /opt /var/lib/dalle-h100
cd /opt
if [ ! -d dalle-tpu ]; then
  git clone {repo_url} dalle-tpu
fi
cd dalle-tpu
ulimit -n 8192
exec python3 -m dalle_tpu_torch.cli.run_trainer \\
    --device cuda \\
    --preset {preset} \\
    --experiment-prefix {experiment_prefix} \\
    --run-id {experiment_prefix} \\
    {initial_peer_flag} \\
    --identity-path /var/lib/dalle-h100/identity.pem \\
    >> /var/log/dalle-h100-trainer.log 2>&1
"""


def worker_name(index: int) -> str:
    return f"{FLEET_PREFIX}-{index}"


def startup_script(args) -> str:
    initial_peer_flag = (
        f"--initial-peers {args.initial_peer}" if args.initial_peer else "")
    return STARTUP_SCRIPT.format(
        repo_url=args.repo_url, preset=args.preset,
        experiment_prefix=args.experiment_prefix,
        initial_peer_flag=initial_peer_flag)


def build_create_command(args, index: int) -> List[str]:
    return [
        "gcloud", "compute", "instances", "create", worker_name(index),
        f"--project={args.project}", f"--zone={args.zone}",
        f"--machine-type={args.machine_type}",
        "--provisioning-model=SPOT",   # the reference's spot VMs
        # an evicted worker is deleted, so a later create re-makes it
        "--instance-termination-action=DELETE",
        "--maintenance-policy=TERMINATE",
        f"--image-family={args.image_family}",
        f"--image-project={args.image_project}",
        "--boot-disk-size=200GB",
        "--metadata=install-nvidia-driver=True,"
        f"startup-script={startup_script(args)}",
    ]


def build_delete_commands(args, index: int) -> List[List[str]]:
    return [["gcloud", "compute", "instances", "delete", worker_name(index),
             f"--project={args.project}", f"--zone={args.zone}", "--quiet"]]


def build_list_command(args) -> List[str]:
    return ["gcloud", "compute", "instances", "list",
            f"--project={args.project}", f"--zones={args.zone}",
            f"--filter=name~^{FLEET_PREFIX}"]


def run(cmd: List[str], dry_run: bool) -> int:
    print("+ " + " ".join(shlex.quote(c) for c in cmd))
    if dry_run:
        return 0
    return subprocess.run(cmd, check=False).returncode


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dalle-h100-manage-fleet", description=__doc__.splitlines()[0])
    parser.add_argument("command", choices=("create", "delete", "list"))
    parser.add_argument("--project", required=True)
    parser.add_argument("--zone", default="us-central1-a")
    parser.add_argument("--machine-type", default="a3-highgpu-1g",
                        help="a one-H100 machine type (the JAX CLI's "
                             "--accelerator-type)")
    parser.add_argument("--image-family", default="pytorch-latest-gpu",
                        help="an image with PyTorch, Triton and the CUDA "
                             "toolkit (the JAX CLI's --runtime-version)")
    parser.add_argument("--image-project",
                        default="deeplearning-platform-release")
    parser.add_argument("--swarm-size", type=int, default=4,
                        help="number of worker VMs (reference "
                             "SWARM_SIZE=4, manage_scaleset.py:22)")
    parser.add_argument("--initial-peer", default=None,
                        help="host:port of a bootstrap peer (the aux peer)")
    parser.add_argument("--repo-url",
                        default="https://example.com/dalle-tpu.git",
                        help="where workers clone the framework from")
    parser.add_argument("--preset", default="flagship")
    parser.add_argument("--experiment-prefix", default="dalle-h100")
    parser.add_argument("--dry-run", action="store_true",
                        help="print gcloud commands without executing")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rc = 0
    if args.command == "create":
        for i in range(args.swarm_size):
            rc |= run(build_create_command(args, i), args.dry_run)
    elif args.command == "delete":
        for i in range(args.swarm_size):
            for cmd in build_delete_commands(args, i):
                rc |= run(cmd, args.dry_run)
    else:
        rc = run(build_list_command(args), args.dry_run)
    return rc


if __name__ == "__main__":
    sys.exit(main())
