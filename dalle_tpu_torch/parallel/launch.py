"""Run one function in every process of a ``gloo`` group (port-only).

The port's mesh devices are processes (``parallel/mesh.py``), so a sharded
program, its tests and its dry run start one process a mesh device:
:func:`spawn` starts ``n`` Python processes, each joins a ``gloo`` group
on a free loopback port (``tcp://127.0.0.1:<port>``, its world size and
rank given), runs ``target(rank, n, args)`` and writes what it returns (a
dict of numpy arrays and numbers) to an ``.npz`` file, which the parent
reads back. Every process gets ``timeout`` seconds: one that fails, or
outlives it, fails the call loudly (``RuntimeError`` with each process's
last output), and every process is stopped.

Groups started by different processes of one machine (the workers of a
parallel test run, say) run one after another: :func:`group_lock`, an
advisory ``fcntl.flock`` on a file in ``tempfile.gettempdir()``, is held
for the life of each group, and a group's ``timeout`` starts once it holds
the lock.

Run as a module it is the child: ``python -m
dalle_tpu_torch.parallel.launch TARGET RANK WORLD PORT ARGS_JSON OUT``,
``TARGET`` as ``package.module:function`` or ``path/to/file.py:function``.
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve(target: str) -> Callable:
    """The function named by ``target``."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


#: torch's intra-op threads in each process (several share one machine)
THREADS = 2
#: the lock file of :func:`group_lock`, in the temporary directory
LOCK_NAME = "dalle_tpu_torch_process_groups.lock"


@contextlib.contextmanager
def group_lock():
    """Holds the machine-wide lock of process groups while the block runs
    (waiting for it first): an exclusive ``fcntl.flock`` on ``LOCK_NAME``
    in ``tempfile.gettempdir()``, released when the block ends or the
    process dies. Not re-entrant: a process that holds it starts no group
    that takes it again."""
    with open(os.path.join(tempfile.gettempdir(), LOCK_NAME), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def spawn(target: str, n: int, args: Optional[Dict] = None,
          timeout: float = 120.0) -> List[Dict]:
    """``target(rank, n, args)`` in ``n`` processes of one ``gloo`` group;
    the list of what each returned, by rank (its stdout under
    ``"stdout"``). ``args`` must be JSON. The group runs under
    :func:`group_lock`."""
    with group_lock():
        return _spawn(target, n, args, timeout)


def _spawn(target: str, n: int, args: Optional[Dict],
           timeout: float) -> List[Dict]:
    port = free_port()
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in child_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    with tempfile.TemporaryDirectory(prefix="dalle_spawn_") as out:
        procs = []
        for rank in range(n):
            log = open(os.path.join(out, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "dalle_tpu_torch.parallel.launch",
                 target, str(rank), str(n), str(port),
                 json.dumps(args or {}), out],
                stdout=log, stderr=subprocess.STDOUT, env=child_env,
                cwd=str(REPO)), log))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while True:
                codes = [proc.poll() for proc, _ in procs]
                bad = [(r, c) for r, c in enumerate(codes)
                       if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = f"still running after {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        logs = [Path(out, f"rank{r}.log").read_text(errors="replace")
                for r in range(n)]
        if failed:
            tails = "\n".join(f"--- rank {r} ---\n{text[-3000:]}"
                              for r, text in enumerate(logs))
            raise RuntimeError(f"spawn {target} x{n}: {failed}\n{tails}")
        results = []
        for r in range(n):
            with np.load(os.path.join(out, f"rank{r}.npz"),
                         allow_pickle=False) as data:
                res = {k: data[k] for k in data.files}
            res["stdout"] = logs[r]
            results.append(res)
        return results


def _main(argv: List[str]) -> None:
    target, rank, world, port, args, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        result = resolve(target)(rank, world, json.loads(args)) or {}
        arrays = {k: np.asarray(v) for k, v in result.items()}
        np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
        sys.stdout.flush()
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
