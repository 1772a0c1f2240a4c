"""Multi-process peers in the port (``dalle_tpu_torch/parallel/multihost.py``,
``parallel/mesh.py`` and the follower paths of ``swarm/optimizer.py``,
``task.py`` and ``training/loop.py``); the counterpart of
tests/test_multihost.py.

The children are real processes joined in a ``gloo`` ``torch.distributed``
group on a free loopback port, each with its own timeout (well under a
minute), started under ``parallel/launch.group_lock`` as the mesh tests'
groups are (groups of parallel test workers run one after another; the
timeout starts once the lock is held). The slice's processes must end
bitwise equal; a slice and a one-process peer that averaged in one round
must end bitwise equal too.
The dp=2 gradient is held to the one-process gradient of the whole batch
and to the JAX package's ``make_grad_step`` on a dp=2 CPU mesh at f32
tolerance: each leaf within 1e-5 of its largest magnitude (the two
micro-batch means are summed in another order), the losses within 1e-6
relative.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dalle_tpu_torch.parallel.launch import group_lock

REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 50

torch.set_num_threads(2)

_PRELUDE = r"""
import hashlib, json, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.params import state_leaf_tensors


def digest(state):
    h = hashlib.sha256()
    for t in state_leaf_tensors(state.model, state.opt_state):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def join(rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
"""

# a slice of two processes, or (rank -1) a one-process peer bootstrapped
# from the slice's coordinator; constant gradients a process, one epoch
_SLICE = _PRELUDE + r"""
rank, port, dht_port, grad = (int(sys.argv[1]), sys.argv[2],
                              int(sys.argv[3]), float(sys.argv[4]))
if rank >= 0:
    join(rank, port)
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.parallel.multihost import SliceRole
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.identity import Identity
from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
from dalle_tpu_torch.training.steps import TrainState, apply_step

role = SliceRole()
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
group = int(sys.argv[5])
cfg = tconfig.CollabConfig(
    run_id="mh", target_batch_size=16 * group, matchmaking_time=2.0,
    allreduce_timeout=10.0, averaging_timeout=20.0, average_state_every=0,
    grad_compression="none", audit_gather=False, encrypt_data_plane=False)
model = init_params(tconfig.tiny_model_config(),
                    torch.Generator().manual_seed(0))
tx = make_optimizer(tconfig.OptimizerConfig(state_bits=32, warmup_steps=0,
                                            total_steps=10))
opt = CollaborativeOptimizer(
    dht, cfg, TrainState.create(model, tx),
    lambda s, g: apply_step(s, g, tx), serve_state=False,
    matchmaking_min_group=group, role=role)
opt.tracker.min_refresh_period = 0.05
grads = {n: torch.full_like(p, grad) for n, p in model.named_parameters()}
steps, deadline = 0, time.monotonic() + 35
while opt.local_epoch < 1 and time.monotonic() < deadline:
    opt.step(grads, batch_size=8)
    steps += 1
out = {"rank": rank, "epoch": opt.local_epoch, "steps": steps,
       "digest": digest(opt.state),
       "group": opt.last_timings.get("group_size")}
print(json.dumps(out), flush=True)
opt.shutdown()
if dht is not None:
    dht.shutdown()
"""

# a TrainingTask over a dp=2 slice: one grad step on this process's rows
_GRAD = _PRELUDE + r"""
import numpy as np
rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
join(rank, port)
from dalle_tpu_torch.task import TrainingTask
task = TrainingTask(
    tconfig.tiny_model_config(), tconfig.OptimizerConfig(state_bits=32),
    tconfig.TrainerConfig(per_device_batch=2, grad_accum_steps=2),
    tconfig.CollabConfig(),
    tconfig.PeerConfig(identity_path=f"{out_dir}/id{rank}.pem"),
    device="cpu")
task.model.load_state_dict(torch.load(f"{out_dir}/model.pt"))
batch = next(task.batches())
grads, aux = task.grad_step(task.model, batch)
np.savez(f"{out_dir}/grads{rank}.npz",
         **{k: v.numpy() for k, v in grads.items()},
         **{f"aux.{k}": v.numpy() for k, v in aux.items()},
         **{f"batch.{k}": v.numpy() for k, v in batch.items()})
print(json.dumps({"rank": rank, "data_seed": str(task.data_seed),
                  "local_batch_size": task.local_batch_size,
                  "shards": task.data_shards}), flush=True)
"""

# a slice that is behind a one-process peer at epoch 3 resyncs from it
_RESYNC = _PRELUDE + r"""
rank, port, dht_port, out_dir = (int(sys.argv[1]), sys.argv[2],
                                 int(sys.argv[3]), sys.argv[4])
if rank >= 0:
    join(rank, port)
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.parallel.multihost import SliceRole
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.identity import Identity
from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
from dalle_tpu_torch.training.steps import TrainState, apply_step

role = SliceRole()
dht = None
if rank < 0:
    dht = DHT(host="127.0.0.1", port=dht_port, identity=Identity.generate())
elif rank == 0:
    dht = DHT(host="127.0.0.1", port=0, identity=Identity.generate())
    deadline = time.monotonic() + 20
    while not dht.bootstrap(f"127.0.0.1:{dht_port}"):
        if time.monotonic() > deadline:
            raise SystemExit("could not bootstrap to the ahead peer")
        time.sleep(0.2)
cfg = tconfig.CollabConfig(
    run_id="rs", target_batch_size=10 ** 6, matchmaking_time=1.0,
    averaging_timeout=20.0, average_state_every=0, audit_gather=False,
    state_compression="none", encrypt_data_plane=False)
seed = 5 if rank < 0 else 0
model = init_params(tconfig.tiny_model_config(),
                    torch.Generator().manual_seed(seed))
tx = make_optimizer(tconfig.OptimizerConfig(warmup_steps=0, total_steps=10,
                                            min_8bit_size=4096))
state = TrainState.create(model, tx)
opt = CollaborativeOptimizer(dht, cfg, state,
                             lambda s, g: apply_step(s, g, tx),
                             serve_state=rank < 0, role=role)
opt.tracker.min_refresh_period = 0.05
grads = {n: torch.full_like(p, 0.1) for n, p in model.named_parameters()}
if rank < 0:
    # ahead of the slice: three updates, then serve until the slice is done
    for _ in range(3):
        opt.state = apply_step(opt.state, grads, tx)
    opt.local_epoch = 3
    opt.tracker.reset_epoch(3)
    opt.tracker.report_local_progress(3, 0, force=True)
    print(json.dumps({"rank": rank, "epoch": opt.local_epoch,
                      "digest": digest(opt.state)}), flush=True)
    import os
    deadline = time.monotonic() + 40
    while not os.path.exists(f"{out_dir}/done") and \
            time.monotonic() < deadline:
        time.sleep(0.2)
else:
    steps, deadline = 0, time.monotonic() + 35
    while opt.local_epoch < 3 and time.monotonic() < deadline:
        opt.step(grads, batch_size=1)
        steps += 1
    print(json.dumps({"rank": rank, "epoch": opt.local_epoch,
                      "steps": steps, "digest": digest(opt.state)}),
          flush=True)
    dist.barrier()
    if rank == 0:
        open(f"{out_dir}/done", "w").close()
opt.shutdown()
if dht is not None:
    dht.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(children):
    """Start every ``(script, args)`` child under the process groups' lock;
    each must exit 0 within ``CHILD_TIMEOUT`` and print one JSON line."""
    with group_lock():
        return _run_locked(children)


def _run_locked(children):
    procs = [subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                              env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for script, args in children]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    except subprocess.TimeoutExpired:
        raise AssertionError("multi-process children hung:\n" + "\n".join(
            o[-2000:] for o in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads([ln for ln in out.splitlines()
                        if ln.startswith("{")][-1]) for out in outs]


def test_two_process_slice_applies_identical_updates():
    port, dht_port = _free_port(), _free_port()
    rows = _run([(_SLICE, (rank, port, dht_port, 2.0, 1))
                 for rank in (0, 1)])
    by_rank = {r["rank"]: r for r in rows}
    assert by_rank[0]["epoch"] == by_rank[1]["epoch"] == 1
    assert by_rank[0]["digest"] == by_rank[1]["digest"]
    # followers and coordinator ran the same number of lockstep steps
    assert by_rank[0]["steps"] == by_rank[1]["steps"]


def test_slice_and_one_process_peer_end_an_epoch_bitwise_equal():
    """A slice of two processes and a one-process peer with other
    gradients form one group: all three end the epoch with the same
    parameters and moments, bit for bit."""
    port, dht_port = _free_port(), _free_port()
    rows = _run([(_SLICE, (0, port, dht_port, 2.0, 2)),
                 (_SLICE, (1, port, dht_port, 2.0, 2)),
                 (_SLICE, (-1, port, dht_port, 4.0, 2))])
    assert [r["epoch"] for r in rows] == [1, 1, 1]
    assert rows[0]["group"] == rows[2]["group"] == 2
    assert len({r["digest"] for r in rows}) == 1


def test_follower_resyncs_with_its_coordinator():
    """A slice behind the swarm: the coordinator's resync decision and the
    state it downloads reach the follower, and both end at the ahead
    peer's epoch with its state, bit for bit."""
    import tempfile
    port, dht_port = _free_port(), _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        rows = _run([(_RESYNC, (-1, port, dht_port, tmp)),
                     (_RESYNC, (0, port, dht_port, tmp)),
                     (_RESYNC, (1, port, dht_port, tmp))])
    ahead, coord, follower = rows
    assert coord["epoch"] == follower["epoch"] == ahead["epoch"] == 3
    assert coord["digest"] == follower["digest"] == ahead["digest"]


def test_dp2_gradient_equals_the_whole_batch_and_jax(tmp_path):
    """Two processes at ``per_device_batch=2``, ``grad_accum_steps=2``: each
    takes its rows of the slice's 8-row batch (rank r: rows 2r, 2r+1 of
    each 4-row micro-batch), and the mean of their gradients equals the
    one-process gradient of the whole batch and JAX's ``make_grad_step``
    over a dp=2 CPU mesh."""
    from dalle_tpu import config as jconfig
    from dalle_tpu.models.dalle import DALLE as JaxDALLE
    from dalle_tpu.models.dalle import init_params as jax_init
    from dalle_tpu.parallel.mesh import batch_sharding, make_mesh
    from dalle_tpu.training.steps import make_grad_step
    from dalle_tpu_torch import config as tconfig
    from dalle_tpu_torch.data.synthetic import SyntheticCodes
    from dalle_tpu_torch.params import params_from_jax
    from dalle_tpu_torch.training.steps import grad_step

    jcfg, tcfg = jconfig.tiny_model_config(), tconfig.tiny_model_config()
    params = jax.tree.map(np.asarray,
                          jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))
    model = params_from_jax(params, tcfg)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    port = _free_port()
    rows = _run([(_GRAD, (rank, port, tmp_path)) for rank in (0, 1)])
    assert rows[0]["data_seed"] == rows[1]["data_seed"]
    assert rows[0]["local_batch_size"] == 8 and rows[0]["shards"] == 2
    g0, g1 = (dict(np.load(tmp_path / f"grads{r}.npz")) for r in (0, 1))
    # the same batch sequence, split by rank within each micro-batch
    whole = next(SyntheticCodes(tcfg, num_samples=64, seed=0).batches(
        8, seed=int(rows[0]["data_seed"])))
    for key in ("text", "image"):
        for rank, g in enumerate((g0, g1)):
            want = whole[key][[2 * rank, 2 * rank + 1,
                               4 + 2 * rank, 5 + 2 * rank]]
            np.testing.assert_array_equal(g[f"batch.{key}"], want)
    grads = {k: v for k, v in g0.items() if not k.startswith(("aux.",
                                                               "batch."))}
    for k in g0:
        if not k.startswith("batch."):
            np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)

    tb = {k: torch.from_numpy(v).long() for k, v in whole.items()}
    loss, _, one = grad_step(model, tb, accum_steps=2)
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    jb = jax.device_put({k: np.asarray(v, np.int32) for k, v in
                         whole.items()}, batch_sharding(mesh))
    jgrads, jaux = jax.jit(make_grad_step(JaxDALLE(jcfg), accum_steps=2))(
        params, jb)
    jflat = dict(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                 tcfg).named_parameters())
    assert sorted(grads) == sorted(one) == sorted(jflat)
    for name, g in grads.items():
        for want in (one[name].numpy(), jflat[name].detach().numpy()):
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * scale,
                                       err_msg=name)
    np.testing.assert_allclose(float(g0["aux.loss"]), float(loss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(g0["aux.loss"]), float(jaux["loss"]),
                               rtol=1e-6)


def test_mesh_resolution_follows_jax():
    from dalle_tpu_torch.parallel.mesh import make_mesh
    assert make_mesh(n_devices=2).shape == {"dp": 2, "fsdp": 1, "tp": 1,
                                            "sp": 1}
    assert make_mesh(dp=1, n_devices=1).dp == 1
    with pytest.raises(ValueError, match=r"mesh 2x1x1x1 != device count 3"):
        make_mesh(dp=2, n_devices=3)
    # the sharded axes resolve as JAX's (their groups and placement:
    # tests/test_torch_sharding.py)
    from dalle_tpu.parallel.mesh import make_mesh as jax_make_mesh
    for axis in ("fsdp", "tp", "sp"):
        got = make_mesh(n_devices=2, **{axis: 2})
        want = jax_make_mesh(**{axis: 2}, devices=jax.devices()[:2])
        assert got.shape == dict(want.shape)
        with pytest.raises(ValueError, match="not divisible"):
            make_mesh(n_devices=3, **{axis: 2})


def test_masked_slice_mean_is_the_mean_of_process_means():
    """A deliberate difference: with a loss mask (real data), a dp=2
    slice's gradient is the mean of its processes' masked means, as
    micro-batch accumulation's is of its micro-batches'; JAX's global mesh
    takes one masked mean over the slice's rows (the port's whole-batch
    step). The two agree where both processes' rows hold the same number
    of unmasked tokens, and differ where they do not."""
    from dalle_tpu_torch import config as tconfig
    from dalle_tpu_torch.data.synthetic import SyntheticCodes
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.training.steps import grad_step

    cfg = tconfig.tiny_model_config()
    model = init_params(cfg, torch.Generator().manual_seed(0))
    data = next(SyntheticCodes(cfg, num_samples=4, seed=0).batches(4))
    batch = {k: torch.from_numpy(v).long() for k, v in data.items()}

    def gap(mask):
        batch["mask"] = mask
        _, _, whole = grad_step(model, batch)
        halves = [grad_step(model, {k: v[r:r + 2] for k, v in
                                    batch.items()})[2] for r in (0, 2)]
        return max(float((whole[n] - (halves[0][n] + halves[1][n]) / 2)
                         .abs().max() / whole[n].abs().max().clamp(
                             min=1e-12)) for n in whole)

    t = cfg.total_seq_len
    even = torch.ones(4, t)
    even[:, -3:] = 0.0
    assert gap(even) < 1e-5
    uneven = torch.ones(4, t)
    uneven[2:, cfg.text_seq_len:cfg.text_seq_len + 8] = 0.0
    assert gap(uneven) > 1e-3
