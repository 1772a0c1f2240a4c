"""A sharded multi-process peer in the swarm (``swarm/optimizer.py`` on a
sharded mesh).

Two processes at fsdp=2 (a ``gloo`` group on loopback, each holding its
shards of a tiny model and its 8-bit state) form one peer beside a
one-process peer; both push the same gradients for two epochs with state
averaging after each. The slice gathers its gradient shards whole for the
round, keeps its shards of the averaged gradients and of the averaged
state, and its whole state (``multihost.host_global``) ends every epoch
bitwise equal to the one-process peer's: with no clip (``max_grad_norm``
None) the whole-leaf update is the one-process update on the same bits.
Tolerance: exact.

Under ``grad_compression="power_sgd"`` (as JAX's
``_run_sharded_slice_with_peer("power_sgd")``) both slice processes run
the compressor in lockstep on their whole gradients and only the
coordinator's factor rounds cross the wire. The gradients are small
integers times 2^-10, so every peer's accumulated mean is exactly them.
The slice's applied averaged gradients, gathered whole, are held to the
JAX package's ``average_with_powersgd`` on the same whole gradients
within 1e-5 of each leaf's largest magnitude (the f32 tolerance of
tests/test_torch_powersgd.py). Its ``reduce_fn`` is the plain mean of the
peers' factors; the wire carries the mean as fp16, so the reference
checks the slice's averaged factors against that mean within one fp16
rounding (rtol 2^-10, atol 2^-24) and reconstructs from the wire's
bytes, as tests/test_torch_swarm_mixed.py does across packages. A
data-parallel slice (two processes with the same whole gradients and no
mesh) runs PowerSGD in the same lockstep and is held to the same
reference. A factor round that is incomplete on the slice's coordinator
leaves every process of the slice its exact local gradients; one that
raises there raises on every process. Each child has its own timeout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dalle_tpu_torch.parallel.launch import free_port

REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 80
#: the PowerSGD reference: the f32 tolerance of tests/test_torch_powersgd.py
REL_TOL = 1e-5
#: the wire's fp16 rounding of an averaged factor
FP16_RTOL, FP16_ATOL = 2 ** -10, 2 ** -24

_CHILD = r"""
import datetime, hashlib, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from dalle_tpu_torch import config as tconfig
rank, port, dht_port = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
compression, out_dir, mode = sys.argv[4], sys.argv[5], sys.argv[6]
layout = sys.argv[7]
epochs = 1 if mode in ("incomplete", "raise") else 2
if rank >= 0:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.parallel.mesh import make_mesh
from dalle_tpu_torch.parallel.multihost import SliceRole
from dalle_tpu_torch.parallel.sharding import (shard_tensor,
                                               shard_train_state,
                                               unshard_tensor)
from dalle_tpu_torch.params import jax_leaf_names
from dalle_tpu_torch.swarm import optimizer as opt_mod
from dalle_tpu_torch.swarm import powersgd
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.identity import Identity
from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
from dalle_tpu_torch.training.steps import TrainState, apply_step

role = SliceRole()
mesh = make_mesh(dp=1, fsdp=2) if rank >= 0 and layout == "fsdp" else None
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
    grad_compression=compression, audit_gather=False,
    encrypt_data_plane=False)
model_cfg = tconfig.tiny_model_config()
model = init_params(model_cfg, torch.Generator().manual_seed(0), mesh=mesh)
tx = make_optimizer(tconfig.OptimizerConfig(
    warmup_steps=0, total_steps=10, max_grad_norm=None, min_8bit_size=1024,
    block_size=256))
state = TrainState.create(model, tx)
if mesh is not None:
    state = shard_train_state(mesh, state)
applied, calls, wire = [], [], {}


def apply(s, g):
    applied.append({n: t.clone() for n, t in g.items()})
    return apply_step(s, g, tx)


def host(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float32)


average = powersgd.average_with_powersgd


def recorded(comp, leaves, reduce_fn, epoch=0):
    calls.append(dict(epoch=epoch, leaves=[host(x) for x in leaves]))
    return average(comp, leaves, reduce_fn, epoch=epoch)


powersgd.average_with_powersgd = recorded
run_allreduce = opt_mod.run_allreduce


def wired(dht_, group, prefix, epoch, tensors, **kw):
    out = run_allreduce(dht_, group, prefix, epoch, tensors, **kw)
    wire[f"{prefix.rsplit('_', 1)[1]}{epoch}"] = [host(a) for a in out]
    if rank == 0 and prefix.endswith("_grads_q"):
        if mode == "incomplete":
            kw["report"]["complete"] = False
        elif mode == "raise":
            raise TypeError("injected after the Q round")
    return out


opt_mod.run_allreduce = wired
opt = CollaborativeOptimizer(dht, cfg, state, apply, serve_state=False,
                             role=role)
opt.tracker.min_refresh_period = 0.05
names = jax_leaf_names(model_cfg)
if compression == "none":
    grads = {n: torch.full_like(p, 0.01 * (i % 7 - 3))
             for i, (n, p) in enumerate(model.named_parameters())}
else:
    # small integers times 2^-10: every accumulated mean is exact
    rng = np.random.RandomState(1)
    grads = {}
    for n in names:
        whole = torch.from_numpy((rng.randint(-64, 65, model.whole_shapes[n]
                                              if mesh is not None else
                                              model.get_parameter(n).shape)
                                  * 2.0 ** -10).astype(np.float32))
        grads[n] = (shard_tensor(whole, model.shard_specs[n], mesh)
                    if mesh is not None else whole)


def digest():
    h = hashlib.sha256()
    for a in opt._state_leaves():
        h.update(a.tobytes())
    return h.hexdigest()


rows, error, deadline = [], None, time.monotonic() + 60
while opt.local_epoch < epochs and time.monotonic() < deadline:
    epoch = opt.local_epoch
    try:
        opt.step(grads, batch_size=8)
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
        break
    if opt.local_epoch != epoch:
        rows.append(dict(epoch=opt.local_epoch, digest=digest(),
                         group=opt.last_timings.get("group_size")))
arrays = {}
for k, g in enumerate(applied):
    for i, n in enumerate(names):
        t = g[n]
        if mesh is not None:
            t = unshard_tensor(t, model.shard_specs[n], mesh)
        arrays[f"applied{k}_{i}"] = host(t)
for k, call in enumerate(calls):
    arrays[f"epoch{k}"] = np.array(call["epoch"])
    for i, x in enumerate(call["leaves"]):
        arrays[f"input{k}_{i}"] = x
for key, outs in wire.items():
    for i, x in enumerate(outs):
        arrays[f"wire_{key}_{i}"] = x
np.savez(f"{out_dir}/rank{rank}.npz", **arrays)
comp = opt._powersgd
print(json.dumps({"rank": rank, "epoch": opt.local_epoch, "rows": rows,
                  "error": error,
                  "sharded": mesh is not None and model.sharded,
                  "applied": len(applied), "calls": len(calls),
                  "errors": len(comp._errors) if comp else 0,
                  "cached": len(comp._mat_cache) if comp else 0}),
      flush=True)
opt.shutdown()
if dht is not None:
    dht.shutdown()
if rank >= 0:
    dist.destroy_process_group()
"""


def _run(tmp_path, compression, mode="bitwise", layout="fsdp"):
    """The slice's two processes (``layout`` "fsdp": sharded; "dp":
    whole leaves, no mesh) and the peer; each one's JSON line and its
    arrays (``rank{r}.npz``)."""
    port, dht_port = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = {}
    for rank in (0, 1, -1):
        log = open(tmp_path / f"log{rank}.txt", "w")
        procs[rank] = (subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(rank), str(port),
             str(dht_port), compression, str(tmp_path), mode, layout],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=log,
            text=True), log)
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
    arrays = {}
    for rank in outs:
        with np.load(tmp_path / f"rank{rank}.npz") as data:
            arrays[rank] = {k: data[k] for k in data.files}
    return outs, arrays


def _leaves(arrays, prefix):
    n = sum(1 for k in arrays if k.startswith(prefix))
    return [arrays[f"{prefix}{i}"] for i in range(n)]


def _jax_reference(arrays, rank=4):
    """The JAX package's ``average_with_powersgd`` on the slice's inputs,
    epoch by epoch, with the plain-mean ``reduce_fn`` (module docstring);
    each epoch's averaged gradients in the wire order."""
    from dalle_tpu.swarm import powersgd as jps
    comp = jps.PowerSGDCompressor(rank=rank)
    outs = []
    for k in range(sum(1 for key in arrays if key.startswith("epoch"))):
        epoch = int(arrays[f"epoch{k}"])

        def reduce_fn(tensors, phase, epoch=epoch):
            # the two peers push the same gradients: their factors'
            # plain mean is either's
            mean = [(np.asarray(t, np.float32) + np.asarray(t, np.float32))
                    / np.float32(2) for t in tensors]
            got = _leaves(arrays, f"wire_{phase}{epoch}_")
            assert len(got) == len(mean)
            for g, m in zip(got, mean):
                np.testing.assert_allclose(g.reshape(m.shape), m,
                                           rtol=FP16_RTOL, atol=FP16_ATOL)
            return [g.reshape(m.shape) for g, m in zip(got, mean)]

        outs.append([np.asarray(x) for x in jps.average_with_powersgd(
            comp, _leaves(arrays, f"input{k}_"), reduce_fn, epoch=epoch)])
    return outs


def _check_two_epochs(outs):
    """Every process ended both epochs, in 2-peer rounds, with one whole
    state digest a epoch."""
    for rank, out in outs.items():
        assert out["epoch"] == 2 and out["error"] is None, (rank, out)
        assert [r["epoch"] for r in out["rows"]] == [1, 2], (rank, out)
    for e in range(2):
        digests = {rank: out["rows"][e]["digest"]
                   for rank, out in outs.items()}
        assert len(set(digests.values())) == 1, (e, digests)
    assert [r["group"] for r in outs[0]["rows"]] == [2, 2]


def _check_powersgd(outs, arrays):
    """Every process of the slice ran the compressor on the same whole
    gradients and carries error feedback, and the slice's applied
    averaged gradients are the JAX package's."""
    for rank in (0, 1, -1):
        assert outs[rank]["calls"] == 2 and outs[rank]["errors"] > 0
    for key, val in arrays[0].items():
        if key.startswith(("input", "applied")):
            assert val.tobytes() == arrays[1][key].tobytes(), key
    want = _jax_reference(arrays[0])
    for k, leaves in enumerate(want):
        got = _leaves(arrays[0], f"applied{k}_")
        assert len(got) == len(leaves)
        for i, (g, w) in enumerate(zip(got, leaves)):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g.reshape(w.shape), w, rtol=0,
                                       atol=REL_TOL * scale,
                                       err_msg=f"epoch {k} leaf {i}")


@pytest.mark.parametrize("compression", ["none", "power_sgd"])
def test_a_sharded_slice_and_a_peer_average_bitwise(tmp_path, compression):
    outs, arrays = _run(tmp_path, compression)
    assert outs[0]["sharded"] and outs[1]["sharded"]
    _check_two_epochs(outs)
    if compression == "power_sgd":
        _check_powersgd(outs, arrays)


def test_a_dp_slice_and_a_peer_average_under_powersgd(tmp_path):
    """A data-parallel slice (two processes holding the same whole
    gradients, no mesh) runs the compressor in lockstep as a sharded one
    does: the same digests, error feedback on every process, and the JAX
    package's averaged gradients."""
    outs, arrays = _run(tmp_path, "power_sgd", layout="dp")
    assert not outs[0]["sharded"] and not outs[1]["sharded"]
    _check_two_epochs(outs)
    _check_powersgd(outs, arrays)


def test_an_incomplete_factor_round_leaves_the_slice_its_local_gradients(
        tmp_path):
    """The slice's coordinator sees its Q round incomplete (its report
    marked so after the wire completed): both processes of the slice
    abandon the round together and apply their exact local gradients,
    recording no error feedback and keeping no cached matrix, while the
    peer, whose round completed, applies the rank-r average."""
    outs, arrays = _run(tmp_path, "power_sgd", mode="incomplete")
    for rank, out in outs.items():
        assert out["epoch"] == 1 and out["applied"] == 1, (rank, out)
        assert out["calls"] == 1 and out["cached"] == 0, (rank, out)
    assert outs[0]["rows"][0]["group"] == 2
    for rank in (0, 1):
        assert outs[rank]["errors"] == 0, outs[rank]
        local = _leaves(arrays[rank], "input0_")
        got = _leaves(arrays[rank], "applied0_")
        assert len(got) == len(local)
        for i, (g, x) in enumerate(zip(got, local)):
            assert g.reshape(x.shape).tobytes() == x.tobytes(), (rank, i)
    assert outs[0]["rows"][0]["digest"] == outs[1]["rows"][0]["digest"]
    assert outs[-1]["errors"] > 0
    peer = _leaves(arrays[-1], "applied0_")
    local = _leaves(arrays[-1], "input0_")
    assert any(g.reshape(x.shape).tobytes() != x.tobytes()
               for g, x in zip(peer, local))


def test_a_factor_round_that_raises_on_the_coordinator_raises_everywhere(
        tmp_path):
    """The slice's coordinator raises in its Q round (after the wire
    completed): it raises its own error from ``step``, its follower raises
    with it, and neither applies anything, while the peer, whose round
    completed, applies the rank-r average."""
    outs, arrays = _run(tmp_path, "power_sgd", mode="raise")
    assert outs[0]["error"] == "TypeError: injected after the Q round"
    assert outs[1]["error"].startswith("RuntimeError: factor round q "
                                       "failed"), outs[1]
    for rank in (0, 1):
        out = outs[rank]
        assert out["epoch"] == 0 and out["applied"] == 0, (rank, out)
        assert out["calls"] == 1 and out["rows"] == [], (rank, out)
    assert outs[-1]["error"] is None
    assert outs[-1]["epoch"] == 1 and outs[-1]["errors"] > 0, outs[-1]


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

