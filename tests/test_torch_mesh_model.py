"""The port's model on a sharded mesh against the JAX package's.

JAX's two parametrisations of
``test_model_loss_and_grads_match_single_device`` in
tests/test_sequence_parallel.py (ring at dp=2 sp=4 over a full-causal
stack; Ulysses at fsdp=2 tp=2 sp=2 over the axial zoo; both
weight-shared, rematerialised), plus the zoo with its final
``conv_like`` block at dp=1 fsdp=2 tp=2 with two micro-batches and a loss
mask whose rows keep different counts (JAX's masked mean over all the
processes' tokens, not a mean of per-process means), and an untied head
(``lm_head/kernel`` as ``P("fsdp", "tp")``) at dp=1 fsdp=2 tp=2, and one
whose vocabulary ``tp`` does not divide (``P("fsdp", None)``, every rank
computing the whole vocabulary, as JAX replicates the leaf): the port's
processes (``gloo`` on the CPU, ``parallel/launch.spawn``)
each hold their shards of the JAX package's weights, run ``grad_step`` on
their rows and token slices, and gather every gradient whole. The loss and
every gradient are held to the JAX package's single-device values (which
JAX's own test holds its mesh to), and for the two sp cases also to JAX's
mesh model, at JAX's tolerances: loss 1e-5, gradients rtol 5e-4 with atol
5e-5 (f32). Each case's ``return_logits`` logits (the process's rows, the
whole token axis and vocabulary, gathered over the batch axes) are held
to the JAX package's single-device logits at the loss tolerance.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dalle_tpu.config import tiny_model_config as jax_tiny
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu.parallel.mesh import BATCH_SPEC
from dalle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dalle_tpu.parallel.sharding import param_shardings
from dalle_tpu.training.steps import make_grad_step
from dalle_tpu_torch.parallel.launch import spawn
from dalle_tpu_torch.params import _port_name

torch.set_num_threads(2)
CHILDREN = str(Path(__file__).with_name("torch_mesh_children.py"))
B = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)

CASES = {
    "ring": (dict(attn_types=("full",), sequence_parallel="ring",
                  shared_block_cycle=2, depth=4, remat=True),
             dict(dp=2, fsdp=1, tp=1, sp=4), 1),
    "ulysses": (dict(attn_types=("axial_row", "axial_col"),
                     sequence_parallel="ulysses", shared_block_cycle=2,
                     depth=4, remat=True),
                dict(dp=1, fsdp=2, tp=2, sp=2), 1),
    "zoo_fsdp_tp_masked": (dict(attn_types=("axial_row", "axial_col",
                                            "axial_row", "axial_row"),
                                depth=5, shared_block_cycle=4,
                                final_conv_block=True, conv_kernel=3,
                                remat=True),
                           dict(dp=1, fsdp=2, tp=2, sp=1), 2),
    "untied_fsdp_tp": (dict(attn_types=("axial_row", "axial_col"),
                            tied_embeddings=False, depth=3,
                            shared_block_cycle=2),
                       dict(dp=1, fsdp=2, tp=2, sp=1), 1),
    # tp=2 does not divide vocab_total 193: the head is whole on each rank
    "untied_whole_vocab": (dict(tied_embeddings=False, vocab_image=65,
                                depth=2),
                           dict(dp=1, fsdp=2, tp=2, sp=1), 1),
}


def _flat(tree, prefix="p"):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flat(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val)
    return out


def _batch(cfg, masked, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"text": rng.randint(0, cfg.vocab_text, (B, cfg.text_seq_len)),
             "image": rng.randint(0, cfg.vocab_image,
                                  (B, cfg.image_seq_len))}
    if masked:
        keep = np.array([0.9, 0.2, 0.6, 0.4])[:, None]
        batch["mask"] = (rng.rand(B, cfg.total_seq_len) < keep).astype(
            np.float32)
    return batch


def _jax_logits(model, params, batch):
    fn = jax.jit(lambda p, t, i, m: model.apply(p, t, i, m,
                                                return_logits=True)[2])
    return np.asarray(fn(params, batch["text"], batch["image"],
                         batch.get("mask")))


def _jax_loss_and_grads(model, params, batch, accum):
    step = jax.jit(make_grad_step(model, accum))
    grads, aux = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(aux["loss"]), grads


def _by_port_name(grads):
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {_port_name(tuple(str(p.key) for p in path)[1:]): np.asarray(g)
            for path, g in flat}


def _jax_mesh_loss_and_grads(cfg, mesh, params, batch, accum):
    """JAX's model on its mesh of CPU devices: under ring or Ulysses built
    with the mesh; with ``sequence_parallel="none"`` without one, as JAX's
    ``task.py`` builds it, its parameters placed by ``param_shardings`` and
    the batch by ``BATCH_SPEC`` (every ``sp`` device a replica)."""
    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
    jm = jax_make_mesh(**mesh, devices=jax.devices()[:n])
    if cfg.sequence_parallel != "none":
        return _jax_loss_and_grads(JaxDALLE(cfg, mesh=jm), params, batch,
                                   accum)
    rows = NamedSharding(jm, BATCH_SPEC)
    return _jax_loss_and_grads(
        JaxDALLE(cfg), jax.device_put(params, param_shardings(jm, params)),
        {k: jax.device_put(jnp.asarray(v), rows) for k, v in batch.items()},
        accum)


def check_case(tmp_path, case, kw, mesh, accum, masked=False):
    """The port's mesh of processes on the JAX package's weights against
    the JAX package on one device (and, with ``sp > 1``, on its mesh):
    loss, every gradient and ``return_logits``; returns what each process
    gave."""
    cfg = jax_tiny(**kw)
    ref_cfg = cfg.__class__(**{**cfg.__dict__, "sequence_parallel": "none"})
    params = jax_init(JaxDALLE(ref_cfg), jax.random.PRNGKey(0))
    batch = _batch(cfg, masked)
    path = tmp_path / "inputs.npz"
    np.savez(path, **batch, **_flat(params))

    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
    results = spawn(f"{CHILDREN}:model_grads", n,
                    dict(cfg={k: list(v) if isinstance(v, tuple) else v
                              for k, v in kw.items()},
                         mesh=mesh, inputs=str(path), accum=accum),
                    timeout=150)
    got = results[0]
    assert all(float(r["loss"]) == float(got["loss"]) for r in results)

    wants = [_jax_loss_and_grads(JaxDALLE(ref_cfg), params, batch, accum)]
    if mesh["sp"] > 1:
        wants.append(_jax_mesh_loss_and_grads(cfg, mesh, params, batch,
                                              accum))
    logits = _jax_logits(JaxDALLE(ref_cfg), params, batch)
    for r in results:
        np.testing.assert_allclose(r["logits"], logits, **LOSS_TOL,
                                   err_msg=f"{case} logits")
    for loss, grads in wants:
        np.testing.assert_allclose(float(got["loss"]), loss, **LOSS_TOL)
        flat = _by_port_name(grads)
        assert set(flat) == {k[2:] for k in got if k.startswith("g:")}
        for name, g in flat.items():
            np.testing.assert_allclose(got["g:" + name], g, **GRAD_TOL,
                                       err_msg=f"{case} {name}")
    return results


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_model_loss_and_grads_match_jax(tmp_path, case):
    kw, mesh, accum = CASES[case]
    check_case(tmp_path, case, kw, mesh, accum, case.endswith("masked"))
