"""A sharded multi-process peer in the swarm (``swarm/optimizer.py`` on a
sharded mesh).

Two processes at fsdp=2 (a ``gloo`` group on loopback, each holding its
shards of a tiny model and its 8-bit state) form one peer beside a
one-process peer; both push constant gradients for two epochs with state
averaging after each. The slice gathers its gradient shards whole for the
round, keeps its shards of the averaged gradients and of the averaged
state, and its whole state (``multihost.host_global``) ends every epoch
bitwise equal to the one-process peer's: with no clip (``max_grad_norm``
None) the whole-leaf update is the one-process update on the same bits.
Tolerance: exact. Each child has its own timeout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dalle_tpu_torch.parallel.launch import free_port

REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 80

_CHILD = r"""
import datetime, hashlib, json, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from dalle_tpu_torch import config as tconfig
rank, port, dht_port = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
if rank >= 0:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.parallel.mesh import make_mesh
from dalle_tpu_torch.parallel.multihost import SliceRole
from dalle_tpu_torch.parallel.sharding import shard_train_state
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.identity import Identity
from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
from dalle_tpu_torch.training.steps import TrainState, apply_step

role = SliceRole()
mesh = make_mesh(dp=1, fsdp=2) if rank >= 0 else None
dht = None
if rank == 0:
    dht = DHT(host="127.0.0.1", port=dht_port, identity=Identity.generate())
elif rank < 0:
    dht = DHT(host="127.0.0.1", port=0, identity=Identity.generate())
    deadline = time.monotonic() + 20
    while not dht.bootstrap(f"127.0.0.1:{dht_port}"):
        if time.monotonic() > deadline:
            raise SystemExit("could not bootstrap to the coordinator")
        time.sleep(0.2)
cfg = tconfig.CollabConfig(
    run_id="ms", target_batch_size=32, matchmaking_time=2.0,
    allreduce_timeout=15.0, averaging_timeout=25.0, average_state_every=1,
    grad_compression="none", audit_gather=False, encrypt_data_plane=False)
model = init_params(tconfig.tiny_model_config(),
                    torch.Generator().manual_seed(0), mesh=mesh)
tx = make_optimizer(tconfig.OptimizerConfig(
    warmup_steps=0, total_steps=10, max_grad_norm=None, min_8bit_size=1024,
    block_size=256))
state = TrainState.create(model, tx)
if mesh is not None:
    state = shard_train_state(mesh, state)
opt = CollaborativeOptimizer(dht, cfg, state,
                             lambda s, g: apply_step(s, g, tx),
                             serve_state=False, role=role)
opt.tracker.min_refresh_period = 0.05
grads = {n: torch.full_like(p, 0.01 * (i % 7 - 3))
         for i, (n, p) in enumerate(model.named_parameters())}


def digest():
    h = hashlib.sha256()
    for a in opt._state_leaves():
        h.update(a.tobytes())
    return h.hexdigest()


rows, deadline = [], time.monotonic() + 60
while opt.local_epoch < 2 and time.monotonic() < deadline:
    epoch = opt.local_epoch
    opt.step(grads, batch_size=8)
    if opt.local_epoch != epoch:
        rows.append(dict(epoch=opt.local_epoch, digest=digest(),
                         group=opt.last_timings.get("group_size")))
print(json.dumps({"rank": rank, "epoch": opt.local_epoch, "rows": rows,
                  "sharded": mesh is not None and model.sharded}),
      flush=True)
opt.shutdown()
if dht is not None:
    dht.shutdown()
if rank >= 0:
    dist.destroy_process_group()
"""


def test_a_sharded_slice_and_a_peer_average_bitwise(tmp_path):
    port, dht_port = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = {}
    for rank in (0, 1, -1):
        log = open(tmp_path / f"log{rank}.txt", "w")
        procs[rank] = (subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(rank), str(port),
             str(dht_port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=log, text=True), log)
    outs = {}
    try:
        for rank, (p, _) in procs.items():
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                pytest.fail(f"rank {rank} exited {p.returncode}: " +
                            (tmp_path / f"log{rank}.txt").read_text()[-3000:])
            outs[rank] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    assert outs[0]["sharded"] and outs[1]["sharded"]
    for rank, out in outs.items():
        assert out["epoch"] == 2, (rank, out)
        assert [r["epoch"] for r in out["rows"]] == [1, 2], (rank, out)
    for e in range(2):
        digests = {rank: out["rows"][e]["digest"]
                   for rank, out in outs.items()}
        assert len(set(digests.values())) == 1, (e, digests)
    assert [r["group"] for r in outs[0]["rows"]] == [2, 2]


def test_a_sharded_peer_checkpoints_and_resumes_in_the_loop(tmp_path):
    """A sharded peer (fsdp=2, two processes) trains two solo epochs
    through ``train_loop`` with a checkpoint directory: the coordinator's
    file holds the whole leaves (the port reads them back equal to the
    peer's ``host_global`` state), and a second run of the peer, from
    other initial weights, resumes from it at epoch 2, every process
    keeping its shards, with the same whole state. Tolerance: exact."""
    from dalle_tpu_torch.parallel.launch import spawn
    children = str(Path(__file__).with_name("torch_mesh_children.py"))
    args = dict(identity=str(tmp_path / "id.pem"), dir=str(tmp_path / "ck"),
                epochs=2)
    first = spawn(f"{children}:loop_ckpt", 2, args, timeout=CHILD_TIMEOUT)
    again = spawn(f"{children}:loop_ckpt", 2, dict(args, seed=7),
                  timeout=CHILD_TIMEOUT)
    n = sum(1 for k in first[0] if k.startswith("leaf"))
    assert n > 0 and int(first[0]["file_epoch"]) == 2
    for run in (first, again):
        for r in run:
            assert int(r["epoch"]) == 2 and bool(r["sharded"])
    for i in range(n):
        want = first[0][f"leaf{i}"]
        for r in first[1:] + again:
            assert (r[f"leaf{i}"] == want).all(), i
        got = first[0][f"file{i}"]
        assert got.reshape(want.shape).tobytes() == want.tobytes(), i
