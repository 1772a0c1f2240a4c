"""Training on a sharded mesh in the port against the JAX package.

- fp32 and 8-bit LAMB steps on a sharded state (the zoo at fsdp=2 tp=2;
  four ``gloo`` processes on the CPU) against JAX's ``make_train_step`` on
  ``shard_train_state`` over the same mesh, from the same weights and
  batch: two steps (the first at learning rate 0), then every parameter,
  moment and metric. The same for ``dense_scan`` under fsdp=4 is in
  tests/test_torch_mesh_dense.py, which shares this file's helpers (the
  JAX side's compiles take most of the time, so the files run in
  parallel).
- A checkpoint written from the sharded port state holds whole leaves in
  the JAX format and restores in the JAX package bit for bit; one written
  by the JAX package restores into a sharded port state bit for bit.
- ``multihost.host_global`` of the sharded state leaves equals the whole
  leaves; the offloaded update of a sharded state (host-resident shards
  of the moments) equals the on-device one bit for bit.
- A ``TrainingTask`` on a sharded mesh (fsdp=2 tp=2, four processes)
  takes two steps through its own train state, batches, grad and apply
  steps, equal to a one-process task on the same data.
- ``entry.dryrun_multichip(4, device="cpu")`` prints the JAX dry run's
  lines.

Tolerances (f32): losses and gradient norms 1e-5 relative; parameters
and dense moments 1e-3 relative, with 1e-5 absolute for a parameter (times
its leaf's largest magnitude where that exceeds 1) and 1e-5 of its leaf's
largest magnitude for a moment (a moment is a gradient, or its square,
and a bias's first update is the sign-like ``m / sqrt(v)``, whose
elements follow the gradient's, which agree to JAX's gradient tolerance,
rtol 5e-4, as tests/test_torch_mesh_model.py holds them: the gradients
sum in another order in each package); 8-bit codes within one code of
JAX's, on at most 0.1% of them (a code at a bucket edge moves with the
gradient's last bits). Checkpoints and ``host_global``: exact.
"""

import contextlib
import functools
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from dalle_tpu import config as jconfig
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu.optim import make_optimizer as jax_make_optimizer
from dalle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dalle_tpu.parallel.sharding import shard_train_state as jax_shard
from dalle_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from dalle_tpu.training.steps import TrainState as JaxTrainState
from dalle_tpu.training.steps import make_train_step
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.entry import dryrun_multichip
from dalle_tpu_torch.ops.quant import Quantized
from dalle_tpu_torch.parallel.launch import spawn
from dalle_tpu_torch.params import (jax_leaf_names, opt_state_from_jax,
                                    params_from_jax)

torch.set_num_threads(2)
CHILDREN = str(Path(__file__).with_name("torch_mesh_children.py"))
B = 4
TOL = 1e-5
ELEM_RTOL = 1e-3
CODES_SHARE = 1e-3

ZOO = dict(attn_types=("axial_row", "axial_col", "axial_row", "axial_row"),
           depth=5, shared_block_cycle=4, final_conv_block=True,
           conv_kernel=3, remat=True)
DENSE = dict(attn_types=("axial_row", "axial_col", "full", "conv_like"),
             depth=9, shared_block_cycle=0, dense_scan=True,
             final_conv_block=True, conv_kernel=3, remat=True)
CASES = {
    "zoo_fsdp2_tp2": (ZOO, dict(dp=1, fsdp=2, tp=2, sp=1)),
    "dense_scan_fsdp4": (DENSE, dict(dp=1, fsdp=4, tp=1, sp=1)),
}


def _flat(tree, prefix="p"):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flat(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    kw, _ = CASES[case]
    jcfg = jconfig.tiny_model_config(**kw)
    return jax.tree.map(np.asarray,
                        jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))


def _setup(tmp_path, case):
    kw, _ = CASES[case]
    jcfg, tcfg = jconfig.tiny_model_config(**kw), \
        tconfig.tiny_model_config(**kw)
    params = _jax_params(case)
    rng = np.random.RandomState(0)
    text = rng.randint(0, jcfg.vocab_text, (B, jcfg.text_seq_len))
    image = rng.randint(0, jcfg.vocab_image, (B, jcfg.image_seq_len))
    path = tmp_path / "inputs.npz"
    np.savez(path, text=text, image=image, **_flat(params))
    return jcfg, tcfg, params, {"text": text, "image": image}, str(path)


def _opt(bits):
    return dict(state_bits=bits, warmup_steps=1, total_steps=10,
                min_8bit_size=1024, block_size=256)


@functools.lru_cache(maxsize=None)
def _jax_result(case, bits, steps=2):
    """JAX's state and metrics after ``steps`` steps of ``case`` (shared
    by the tests that need them)."""
    kw, mesh = CASES[case]
    jcfg = jconfig.tiny_model_config(**kw)
    rng = np.random.RandomState(0)
    batch = {"text": rng.randint(0, jcfg.vocab_text, (B, jcfg.text_seq_len)),
             "image": rng.randint(0, jcfg.vocab_image,
                                  (B, jcfg.image_seq_len))}
    return _jax_steps(jcfg, _jax_params(case), batch, mesh, _opt(bits),
                      steps)


def _jax_steps(jcfg, params, batch, mesh, opt, steps):
    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
    jm = jax_make_mesh(**mesh, devices=jax.devices()[:n])
    tx = jax_make_optimizer(jconfig.OptimizerConfig(**opt))
    state = jax_shard(jm, JaxTrainState.create(params, tx))
    step = jax.jit(make_train_step(JaxDALLE(jcfg), tx))
    metrics = []
    for _ in range(steps):
        state, m = step(state, {k: jax.numpy.asarray(v, jax.numpy.int32)
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def _child_args(kw, mesh, path, opt, steps, **extra):
    return dict(cfg={k: list(v) if isinstance(v, tuple) else v
                     for k, v in kw.items()},
                mesh=mesh, inputs=path, opt=opt, steps=steps, **extra)


def _assert_state_close(got, jstate, tcfg, exact=False, step_size=0.0):
    """The child's whole leaves against the JAX state (converted to the
    port's names). ``step_size``: under the 8-bit LAMB, a parameter whose
    moment code moved by one may differ by up to one update of this size
    (on at most ``CODES_SHARE`` of a leaf)."""
    model = params_from_jax(jstate.params, tcfg)
    for name, p in model.named_parameters():
        want = p.detach().numpy()
        atol = 0 if exact else TOL * max(float(np.abs(want).max()), 1.0)
        off = ~np.isclose(got["p:" + name], want,
                          rtol=0 if exact else ELEM_RTOL, atol=atol)
        if step_size and off.sum() <= CODES_SHARE * off.size:
            off &= np.abs(got["p:" + name] - want) > step_size
        assert not off.any(), (name, int(off.sum()), float(
            np.abs(got["p:" + name] - want).max()))
    if not hasattr(jstate.opt_state, "mu"):
        return
    opt = opt_state_from_jax(jstate.opt_state, tcfg)
    diff = total = 0
    for moment in ("mu", "nu"):
        for name, w in getattr(opt, moment).items():
            if isinstance(w, Quantized):
                d = (got[f"{moment}:{name}:codes"].astype(int)
                     - w.codes.numpy().astype(int))
                assert np.abs(d).max() <= (0 if exact else 1), name
                diff, total = diff + int((d != 0).sum()), total + d.size
                if exact:
                    np.testing.assert_array_equal(
                        got[f"{moment}:{name}:absmax"], w.absmax.numpy())
            else:
                want = w.numpy()
                atol = 0 if exact else TOL * float(np.abs(want).max())
                np.testing.assert_allclose(got[f"{moment}:{name}"], want,
                                           rtol=0 if exact else ELEM_RTOL,
                                           atol=atol, err_msg=name)
    assert diff <= CODES_SHARE * max(total, 1), (diff, total)


def check_lamb_steps(tmp_path, case, bits):
    """Two steps of ``case`` in the port's processes against JAX's."""
    kw, mesh = CASES[case]
    _, tcfg, _, _, path = _setup(tmp_path, case)
    jstate, jmetrics = _jax_result(case, bits)
    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
    got = spawn(f"{CHILDREN}:train_steps", n,
                _child_args(kw, mesh, path, _opt(bits), 2), timeout=150)[0]
    for i, m in enumerate(jmetrics):
        np.testing.assert_allclose(float(got[f"loss{i}"]), m["loss"],
                                   rtol=TOL)
        np.testing.assert_allclose(float(got[f"grad_norm{i}"]),
                                   m["grad_norm"], rtol=TOL)
    _assert_state_close(got, jstate, tcfg, step_size=(
        tconfig.OptimizerConfig().learning_rate if bits == 8 else 0.0))


@pytest.mark.parametrize("bits", [32, 8])
def test_sharded_lamb_steps_match_jax(tmp_path, bits):
    check_lamb_steps(tmp_path, "zoo_fsdp2_tp2", bits)


def test_sharded_checkpoints_cross_packages_and_host_global(tmp_path):
    """A sharded port peer's checkpoint restores in JAX bit for bit, a JAX
    checkpoint restores into the sharded port state bit for bit, and
    ``host_global`` gives every whole state leaf."""
    kw, mesh = CASES["zoo_fsdp2_tp2"]
    _, tcfg, params, _, path = _setup(tmp_path, "zoo_fsdp2_tp2")
    opt = _opt(8)
    ckpt_dir = tmp_path / "port"
    ckpt_dir.mkdir()
    got = spawn(f"{CHILDREN}:train_steps", 4, _child_args(
        kw, mesh, path, opt, 2, ckpt=str(ckpt_dir / "ckpt_2.msgpack")),
        timeout=150)[0]

    # host_global: the state leaves in the JAX order, whole
    leaves = [got[f"hg{i}"] for i in range(int(got["host_global_n"]))]
    names = jax_leaf_names(tcfg)
    want = [got["p:" + n] for n in names] + [None]
    for moment in ("mu", "nu"):
        for n in names:
            if f"{moment}:{n}:codes" in got:
                want += [got[f"{moment}:{n}:codes"],
                         got[f"{moment}:{n}:absmax"]]
            else:
                want.append(got[f"{moment}:{n}"])
    assert len(leaves) == len(want)
    for a, w in zip(leaves, want):
        if w is None:
            assert int(a) == 2
        else:
            np.testing.assert_array_equal(a, w)

    # port -> JAX
    tx = jax_make_optimizer(jconfig.OptimizerConfig(**opt))
    template = JaxTrainState.create(params, tx)
    restored, epoch = JaxCkpt(str(ckpt_dir)).restore_latest(template)
    assert epoch == 2
    _assert_state_close(got, jax.tree.map(np.asarray, restored), tcfg,
                        exact=True)

    # JAX -> port: the JAX package's state after its own two steps
    jstate, _ = _jax_result("zoo_fsdp2_tp2", 8)
    jdir = tmp_path / "jax"
    manager = JaxCkpt(str(jdir))
    manager.save(jax.tree.map(jax.numpy.asarray, jstate), 7)
    manager.flush()
    back = spawn(f"{CHILDREN}:train_steps", 4, _child_args(
        kw, mesh, path, opt, 0, restore=manager._ckpt_path(7)),
        timeout=150)[0]
    _assert_state_close(back, jstate, tcfg, exact=True)


def test_dryrun_multichip_prints_the_jax_lines():
    """The port's dry run over four CPU processes prints the JAX dry
    run's lines (its labels, from the same ``_factor_mesh``), each with a
    finite loss."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(4, device="cpu", timeout=150)
    lines = out.getvalue().splitlines()
    dp, fsdp, tp = __graft_entry__._factor_mesh(4)
    labels = [f"mesh dp={dp} fsdp={fsdp} tp={tp}",
              f"mesh dp={dp} fsdp={fsdp} tp={tp} dense_scan",
              "mesh dp=1 tp=2 sp=2 mode=ring",
              "mesh dp=1 tp=2 sp=2 mode=ulysses"]
    assert [ln.split(" loss=")[0] for ln in lines] == \
        [f"dryrun_multichip ok: {label}" for label in labels]
    assert all(np.isfinite(float(ln.rsplit("=", 1)[1])) for ln in lines)


def test_a_task_on_a_sharded_mesh_trains_as_one_process(tmp_path):
    """Four processes at fsdp=2 tp=2 (``TrainerConfig``'s mesh axes, 2
    rows a process and batch index) and one process (4 rows) read the
    same batches (the identity's data seed) and end two fp32 steps with
    the same losses and parameters (f32 tolerances above)."""
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_mesh_children import run_task

    kw = dict(ZOO)
    args = dict(cfg={k: list(v) if isinstance(v, tuple) else v
                     for k, v in kw.items()},
                opt=_opt(32), steps=2, identity=str(tmp_path / "id.pem"),
                trainer=dict(per_device_batch=2, dp=-1, fsdp=2, tp=2))
    got = spawn(f"{CHILDREN}:task_steps", 4, args, timeout=150)[0]
    assert bool(got["sharded"]) and list(got["rows"]) == [2, 2]
    one, losses, rows = run_task(
        tconfig.tiny_model_config(**kw),
        dict(args, trainer=dict(per_device_batch=4)))
    assert rows == [4, 4] and not one.sharded
    np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
    for name, p in one.train_state.model.named_parameters():
        want = p.detach().numpy()
        np.testing.assert_allclose(
            got["p:" + name], want, rtol=ELEM_RTOL,
            atol=TOL * max(float(np.abs(want).max()), 1.0), err_msg=name)


def test_sharded_offloaded_update_equals_on_device(tmp_path):
    """Two 8-bit steps of the sharded zoo with its moments' shards in host
    memory (``training/offload.py``) end bit for bit where the on-device
    steps do. Tolerance: exact."""
    kw, mesh = CASES["zoo_fsdp2_tp2"]
    _, _, _, _, path = _setup(tmp_path, "zoo_fsdp2_tp2")
    runs = [spawn(f"{CHILDREN}:train_steps", 4, _child_args(
        kw, mesh, path, _opt(8), 2, offload=offload), timeout=150)[0]
        for offload in (False, True)]
    keys = [k for k in runs[0] if k != "stdout"]
    assert sorted(keys) == sorted(k for k in runs[1] if k != "stdout")
    for k in keys:
        assert np.array_equal(runs[0][k], runs[1][k]), k
