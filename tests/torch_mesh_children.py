"""The processes of the port's mesh tests (``parallel/launch.spawn``).

Each function runs in every process of a ``gloo`` group on the CPU and
returns numpy arrays to the test: tests/test_torch_sharding.py,
tests/test_torch_sequence.py, tests/test_torch_mesh_model.py and
tests/test_torch_mesh_train.py. The module imports no JAX, so that a child
starts in a second or two; inputs come from the test as ``.npz`` files
(the JAX package's weights as flat ``a/b/c`` keys, and the batch).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.parallel.collectives import gather_whole
from dalle_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from dalle_tpu_torch.parallel.sharding import (moment_spec, shard_tensor,
                                               shard_train_state,
                                               unshard_moment, unshard_tensor)


def _cfg(args):
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in args["cfg"].items()}
    maker = getattr(tconfig, args.get("preset", "tiny_model_config"))
    return maker(**kw)


def _inputs(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _model(cfg, mesh, flat):
    """The port model for ``mesh`` holding the flax tree ``flat`` (whole,
    until ``shard_train_state``)."""
    from dalle_tpu_torch.models.dalle import DALLE
    from dalle_tpu_torch.params import params_from_jax
    tree = {}
    for key, val in flat.items():
        if not key.startswith("p/"):
            continue
        node = tree
        parts = key[2:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    whole = params_from_jax(tree, cfg)
    model = DALLE(cfg, mesh=mesh)
    model.load_state_dict(whole.state_dict())
    return model


def _whole_grads(model, grads, mesh):
    return {"g:" + n: unshard_tensor(g, model.shard_specs[n], mesh).numpy()
            for n, g in grads.items()}


def roundtrip(rank, n, args):
    """shard -> unshard of random whole leaves under every spec of the
    mesh, and of a tiny model's 8-bit train state."""
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.training.steps import TrainState
    mesh = make_mesh(**args["mesh"])
    gen = torch.Generator().manual_seed(0)
    ok = []
    for spec in [("fsdp", "tp"), ("tp", "fsdp"), ("tp", None), (None,),
                 (None, "fsdp", "tp"), ("sp", "dp"), ()]:
        whole = torch.randn((4, 8, 4)[:max(len(spec), 1)], generator=gen)
        part = shard_tensor(whole, spec, mesh)
        ok.append(torch.equal(unshard_tensor(part, spec, mesh), whole))
    cfg = _cfg(args)
    tx = make_optimizer(tconfig.OptimizerConfig(min_8bit_size=1024,
                                                block_size=64))
    model = init_params(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, tx)
    init = state.opt_state
    state = shard_train_state(mesh, state)
    for name, p in model.named_parameters():
        spec = model.shard_specs[name]
        ok.append(tuple(p.shape) != model.whole_shapes[name]
                  or all(a is None or mesh.shape[a] == 1 for a in spec))
        ok.append(torch.equal(unshard_tensor(p.detach(), spec, mesh),
                              before[name]))
        for tree, whole in ((state.opt_state.mu, init.mu),
                            (state.opt_state.nu, init.nu)):
            m = tree[name]
            got = unshard_moment(m, moment_spec(mesh, m, spec), mesh)
            want = whole[name]
            if hasattr(want, "codes"):
                ok.append(torch.equal(got.codes, want.codes)
                          and torch.equal(got.absmax, want.absmax))
            else:
                ok.append(torch.equal(got, want))
    return {"ok": np.array(ok)}


def sequence(rank, n, args):
    """sp_zoo_attention on this rank's shards of the global q/k/v (and
    the gradient of ``sum(out * w)``), for each ``(mode, attn_type)`` of
    ``args["cases"]``; returns the local outputs and gradients with this
    rank's coordinates."""
    from dalle_tpu_torch.parallel.sequence import sp_zoo_attention
    mesh = make_mesh(**args["mesh"])
    data = _inputs(args["inputs"])
    q, k, v, w = (torch.from_numpy(data[x]) for x in "qkvw")
    b, t, h, _ = q.shape
    bl, tl, hl = (b // (mesh.dp * mesh.fsdp), t // mesh.sp, h // mesh.tp)
    bi, si, ti = mesh.index("batch"), mesh.index("sp"), mesh.index("tp")

    def local(x):
        return x[bi * bl:(bi + 1) * bl, si * tl:(si + 1) * tl,
                 ti * hl:(ti + 1) * hl].clone()

    out = {"coords": np.array([bi, si, ti])}
    for i, (mode, attn_type) in enumerate(args["cases"]):
        ql, kl, vl = (local(x).requires_grad_(True) for x in (q, k, v))
        o = sp_zoo_attention(ql, kl, vl, mesh=mesh, mode=mode,
                             attn_type=attn_type, text_len=args["text"],
                             grid=args["grid"], conv_kernel=3)
        (o * local(w)).sum().backward()
        out[f"out{i}"] = o.detach().numpy()
        for name, x in (("dq", ql), ("dk", kl), ("dv", vl)):
            out[f"{name}{i}"] = x.grad.numpy()
    return out


def model_grads(rank, n, args):
    """The port model on its mesh from the JAX weights: ``grad_step`` on
    this process's rows of the batch; the loss, every gradient whole, the
    mesh axes whose lines carried the grad step's collectives
    (``collectives.AXIS_TRAFFIC``), and the logits of ``return_logits``
    gathered over the batch axes."""
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.parallel.collectives import (AXIS_TRAFFIC,
                                                      reset_traffic)
    from dalle_tpu_torch.training.steps import TrainState, grad_step
    mesh = make_mesh(**args["mesh"])
    cfg = _cfg(args)
    data = _inputs(args["inputs"])
    model = _model(cfg, mesh, data)
    shard_train_state(mesh, TrainState.create(
        model, make_optimizer(tconfig.OptimizerConfig(state_bits=32))))
    accum = args.get("accum", 1)
    batch = {k: torch.from_numpy(data[k]).long() for k in ("text", "image")}
    if "mask" in data:
        batch["mask"] = torch.from_numpy(data["mask"])
    rows = batch_sharding(mesh, batch)
    batch = batch_sharding(mesh, batch, accum)
    reset_traffic()
    loss, aux, grads = grad_step(model, batch, accum)
    axes = sorted(AXIS_TRAFFIC)
    with torch.no_grad():
        logits = model(rows["text"], rows["image"], rows.get("mask"),
                       return_logits=True)[2]
    return {"loss": float(loss), "loss_img": float(aux["loss_img"]),
            "axes": np.array(axes, dtype=str),
            "logits": gather_whole(logits, [(0, mesh.group("batch"))])
            .numpy(), **_whole_grads(model, grads, mesh)}


def train_steps(rank, n, args):
    """``args["steps"]`` LAMB steps (fp32 or 8-bit) of the port model on
    its mesh from the JAX weights (with ``args["offload"]``, through the
    offloaded update); every parameter, moment and metric whole. With
    ``args["ckpt"]``: the sharded state is also written as a
    checkpoint (rank 0 writes the gathered bytes), and with
    ``args["restore"]`` a checkpoint is read into the fresh sharded state
    first."""
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.parallel.multihost import host_global
    from dalle_tpu_torch.parallel.sharding import state_leaf_specs
    from dalle_tpu_torch.params import state_leaf_tensors
    from dalle_tpu_torch.training.checkpoint import (load_state_dict_into,
                                                     read_checkpoint,
                                                     serialize_state_dict,
                                                     state_to_state_dict)
    from dalle_tpu_torch.training.steps import TrainState, train_step
    mesh = make_mesh(**args["mesh"])
    cfg = _cfg(args)
    data = _inputs(args["inputs"])
    model = _model(cfg, mesh, data)
    tx = make_optimizer(tconfig.OptimizerConfig(**args["opt"]))
    state = shard_train_state(mesh, TrainState.create(model, tx))
    if args.get("restore"):
        load_state_dict_into(state, read_checkpoint(args["restore"])[1])
    batch = batch_sharding(mesh, {k: torch.from_numpy(data[k]).long()
                                  for k in ("text", "image")})
    step = functools.partial(train_step, optimizer=tx)
    if args.get("offload"):
        from dalle_tpu_torch.training.offload import (
            make_offloaded_apply_step, offload_train_state)
        state = offload_train_state(state)
        step = _offloaded_step(make_offloaded_apply_step(tx))
    out = {}
    for i in range(args["steps"]):
        state, metrics = step(state, batch)
        out[f"loss{i}"] = float(metrics["loss"])
        out[f"grad_norm{i}"] = float(metrics["grad_norm"])
    specs = model.shard_specs
    for name, p in model.named_parameters():
        out["p:" + name] = unshard_tensor(p.detach(), specs[name],
                                          mesh).numpy()
        for moment in ("mu", "nu"):
            m = getattr(state.opt_state, moment)[name]
            w = unshard_moment(m, moment_spec(mesh, m, specs[name]), mesh)
            if isinstance(w, Quantized):
                out[f"{moment}:{name}:codes"] = w.codes.numpy()
                out[f"{moment}:{name}:absmax"] = w.absmax.numpy()
            else:
                out[f"{moment}:{name}"] = w.numpy()
    leaves = host_global(state_leaf_tensors(model, state.opt_state),
                         state_leaf_specs(model, state.opt_state), mesh)
    out["host_global_n"] = len(leaves)
    for i, a in enumerate(leaves):
        out[f"hg{i}"] = a
    if args.get("ckpt"):
        blob = serialize_state_dict(state_to_state_dict(state),
                                    state.step)
        if rank == 0:
            with open(args["ckpt"], "wb") as f:
                f.write(blob)
    return out


def run_task(cfg, args):
    """``args["steps"]`` grad steps and applies of a ``TrainingTask`` (its
    train state, its batches, its grad and apply steps); the task, the
    losses and the rows of each batch."""
    from dalle_tpu_torch.task import TrainingTask
    task = TrainingTask(cfg, tconfig.OptimizerConfig(**args["opt"]),
                        tconfig.TrainerConfig(**args["trainer"]),
                        tconfig.CollabConfig(),
                        tconfig.PeerConfig(identity_path=args["identity"]),
                        device="cpu")
    state, losses, rows = task.train_state, [], []
    for batch, _ in zip(task.batches(), range(args["steps"])):
        grads, metrics = task.grad_step(state.model, batch)
        state = task.apply_step(state, grads)
        losses.append(float(metrics["loss"]))
        rows.append(batch["text"].shape[0])
    return task, losses, rows


def _offloaded_step(apply):
    """``train_step`` with the offloaded update ``apply``."""
    from dalle_tpu_torch.optim.lamb import sharded_global_norm
    from dalle_tpu_torch.params import jax_leaf_names
    from dalle_tpu_torch.training.steps import grad_step

    def step(state, batch):
        _, aux, grads = grad_step(state.model, batch)
        norm = sharded_global_norm(grads, jax_leaf_names(state.model.cfg),
                                   state.model)
        return apply(state, grads), dict(aux, grad_norm=norm)
    return step


def task_steps(rank, n, args):
    """:func:`run_task` on the sharded mesh of ``args["trainer"]``; the
    losses and the parameters whole."""
    task, losses, rows = run_task(_cfg(args), args)
    model = task.train_state.model
    return {"losses": np.array(losses), "rows": np.array(rows),
            "sharded": bool(task.sharded),
            **{"p:" + n_: unshard_tensor(p.detach(), model.shard_specs[n_],
                                         task.mesh).numpy()
               for n_, p in model.named_parameters()}}


def cuda_ring(rank, n, args):
    """Ring attention on the card at sp=``n`` over this rank's slice of
    seeded bf16 q/k/v (B, T, H, d): the output and the gradients of
    ``sum(out * w)``, this rank's slices."""
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.parallel.sequence import ring_attention
    dev = resolve_device("cuda")
    mesh = make_mesh(dp=1, sp=n)
    q, k, v, w = ring_inputs(args, dev)
    tl = q.shape[1] // n
    sl = slice(rank * tl, (rank + 1) * tl)
    ql, kl, vl = (x[:, sl].clone().requires_grad_(True) for x in (q, k, v))
    out = ring_attention(ql, kl, vl, group=mesh.group("sp"), n_shards=n,
                         index=rank)
    (out.float() * w[:, sl].float()).sum().backward()
    return {"out": out.detach().float().cpu().numpy(),
            **{name: x.grad.float().cpu().numpy()
               for name, x in (("dq", ql), ("dk", kl), ("dv", vl))}}


def ring_inputs(args, device):
    """The seeded bf16 q, k, v and cotangent of :func:`cuda_ring`."""
    g = torch.Generator(device="cpu").manual_seed(args["seed"])
    shape = (args["b"], args["t"], args["h"], 64)
    return [torch.randn(shape, generator=g).to(torch.bfloat16).to(device)
            for _ in range(4)]


def collectives_check(rank, n, args):
    """Each differentiable collective over the whole group, forward and
    backward, against its definition on small integers (exact in f32),
    and the permutations on bf16 bits."""
    import torch.distributed as dist
    from dalle_tpu_torch.parallel import collectives as C
    group = dist.new_group(list(range(n)), backend="gloo")
    ok = {}

    def grad(y, x, g):
        return torch.autograd.grad(y, x, g)[0]

    r = float(rank)
    x = torch.full((2, 3), r, requires_grad=True)
    y = C.all_gather(x, 0, group)
    want = torch.cat([torch.full((2, 3), float(i)) for i in range(n)])
    g = torch.full((2 * n, 3), r + 1)
    ok["all_gather"] = torch.equal(y, want) and torch.equal(
        grad(y, x, g), torch.full((2, 3), float(sum(range(1, n + 1)))))

    x = torch.full((2 * n, 3), r + 1, requires_grad=True)
    y = C.reduce_scatter(x, 0, group)
    g = torch.full((2, 3), r)
    ok["reduce_scatter"] = torch.equal(
        y, torch.full((2, 3), float(sum(range(1, n + 1))))) and torch.equal(
        grad(y, x, g), torch.cat([torch.full((2, 3), float(i))
                                  for i in range(n)]))

    for mode, back in (("identity", r), ("all_reduce", float(sum(range(n))))):
        x = torch.full((3,), r, requires_grad=True)
        y = C.all_reduce(x, group, grad=mode)
        ok[f"all_reduce_{mode}"] = torch.equal(
            y, torch.full((3,), float(sum(range(n))))) and torch.equal(
            grad(y, x, torch.full((3,), r)), torch.full((3,), back))

    x = torch.full((3,), 2.0, requires_grad=True)
    y = C.reduce_grad(x, group)
    ok["reduce_grad"] = torch.equal(y, x.detach()) and torch.equal(
        grad(y, x, torch.full((3,), r)),
        torch.full((3,), float(sum(range(n)))))

    x = torch.arange(4.0 * n, requires_grad=True)
    y = C.split(x, 0, group)
    ok["split"] = torch.equal(y, torch.arange(4.0 * rank, 4.0 * rank + 4))
    ok["split"] &= torch.equal(grad(y, x, torch.full((4,), r)), torch.cat(
        [torch.full((4,), float(i)) for i in range(n)]))

    ring = [(i, (i + 1) % n) for i in range(n)]
    one = [(0, 1)]
    x = torch.full((2, 3), r + 1, requires_grad=True)
    y = C.ppermute(x, (ring, one), group)
    g = torch.full((2, 3), 10 * r)
    want_y = torch.stack([torch.full((3,), float((rank - 1) % n + 1)),
                          torch.full((3,), 1.0 if rank == 1 else 0.0)])
    want_g = torch.stack([torch.full((3,), 10.0 * ((rank + 1) % n)),
                          torch.full((3,), 10.0 if rank == 0 else 0.0)])
    ok["ppermute"] = torch.equal(y, want_y) and torch.equal(
        grad(y, x, g), want_g)

    bits = torch.randn(5, generator=torch.Generator().manual_seed(rank))
    bits = bits.to(torch.bfloat16)
    got = C.ppermute(bits[None], (ring,), group)[0]
    want = torch.randn(5, generator=torch.Generator().manual_seed(
        (rank - 1) % n)).to(torch.bfloat16)
    ok["ppermute_bf16"] = got.dtype == torch.bfloat16 and torch.equal(
        got, want)

    # all_to_all: rank r's row block j goes to rank j; what arrives is
    # concatenated along the columns in rank order
    x = (torch.arange(n, dtype=torch.float32)[:, None] * 10 + r).repeat(
        1, 2).requires_grad_(True)                        # (n, 2)
    y = C.all_to_all(x, 0, 1, group)                      # (1, 2n)
    want = torch.tensor([[10.0 * rank + i for i in range(n)
                          for _ in range(2)]])
    g = torch.arange(2.0 * n)[None] + 100 * r
    back = torch.stack([torch.tensor([2.0 * rank, 2.0 * rank + 1])
                        + 100 * j for j in range(n)])
    ok["all_to_all"] = torch.equal(y, want) and torch.equal(
        grad(y, x, g), back)
    return {k: np.array(bool(v)) for k, v in ok.items()}


def loop_ckpt(rank, n, args):
    """A sharded peer (fsdp=2, weights from ``args["seed"]``) trains up to
    ``args["epochs"]`` solo epochs through ``train_loop`` with a
    checkpoint directory (a checkpoint and a backup every epoch), resuming
    from it when it holds one; returns its epoch and its whole state leaves
    (``host_global``), with the whole leaves of the last checkpoint file
    as the port reads it."""
    from dalle_tpu_torch.params import jax_state_leaves
    from dalle_tpu_torch.task import TrainingTask
    from dalle_tpu_torch.training.checkpoint import (CheckpointManager,
                                                     read_checkpoint)
    from dalle_tpu_torch.training.loop import train_loop
    cfg = tconfig.tiny_model_config()
    task = TrainingTask(
        cfg, tconfig.OptimizerConfig(warmup_steps=0, total_steps=10,
                                     min_8bit_size=1024, block_size=256),
        tconfig.TrainerConfig(per_device_batch=2, fsdp=2,
                              seed=args.get("seed", 0)),
        tconfig.CollabConfig(run_id="lc", target_batch_size=4,
                             matchmaking_time=0.3, audit_gather=False,
                             delay_optimizer_step=False),
        tconfig.PeerConfig(identity_path=args["identity"], port=0,
                           host="127.0.0.1"), device="cpu")
    with task:
        train_loop(task, max_epochs=args["epochs"], warmup_steps=0,
                   checkpoint_dir=args["dir"], save_every=1,
                   backup_every=1)
        collab = task.collab_optimizer
        out = {"epoch": collab.local_epoch,
               "sharded": bool(task.sharded)}
        for i, a in enumerate(collab._state_leaves()):
            out[f"leaf{i}"] = a
        if rank == 0:
            epoch, path = CheckpointManager(args["dir"]).checkpoints()[-1]
            sd = read_checkpoint(path)[1]
            out["file_epoch"] = epoch
            leaves = jax_state_leaves(cfg, collab.state.opt_state)
            from dalle_tpu_torch.params import flax_path
            for i, leaf in enumerate(leaves):
                if leaf[0] == "param":
                    node = sd["params"]["params"]
                    for key in flax_path(leaf[1], cfg):
                        node = node[key]
                elif leaf[0] == "count":
                    node = sd["opt_state"]["count"]
                else:
                    node = sd["opt_state"][leaf[0]]["params"]
                    for key in flax_path(leaf[1], cfg):
                        node = node[key]
                    if leaf[2] != "dense":
                        node = node[leaf[2]]
                out[f"file{i}"] = np.asarray(node.cpu() if hasattr(
                    node, "cpu") else node)
    return out
