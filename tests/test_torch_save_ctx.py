"""``remat_policy="save_ctx"`` in the port against the JAX package's.

The JAX policy saves only the attention kernels' outputs (``attn_out``,
``attn_stats``): backward replays the norm, the q/k/v projections and
rotary, never the attention forward. The port keeps each call's out and
lse in a :class:`~dalle_tpu_torch.ops.attention.SavedContext` that its
checkpoint's replay reads (``models/transformer.py``).

Tolerances: the loss and every gradient against JAX as
tests/test_torch_train.py holds ``save_attn`` (f32: losses 2e-4 relative,
a gradient leaf within 2e-4 of its largest magnitude); against the port's
own ``save_attn`` exactly, since both replays recompute the same q/k/v
with the same operations.
"""

import gc

import numpy as np
import pytest
import torch

from dalle_tpu_torch.models.transformer import Dense, wrapper_calls
from dalle_tpu_torch.ops import attention as tatt
from dalle_tpu_torch.training.steps import grad_step
from tests.test_torch_train import (LOSS_TOL, _assert_grads_close,
                                    _batches, _count_wrappers,
                                    _jax_loss_and_grads, _setup,
                                    pallas_interpret)  # noqa: F401

torch.set_num_threads(2)

#: the stacked dense_scan layout at flagship_tiny's widths (depth 10: the
#: body's 9 layers in 3 repetitions of 4 with three overhang slices)
DENSE = dict(shared_block_cycle=0, dense_scan=True, remat_skip_blocks=0,
             scan_unroll=1)


def test_loss_and_every_gradient_match_jax(pallas_interpret):  # noqa: F811
    jcfg, tcfg, params, model, text, image = _setup(
        "flagship_tiny", remat_policy="save_ctx")
    assert jcfg.remat_policy == tcfg.remat_policy == "save_ctx"
    assert tcfg.remat and tcfg.remat_skip_blocks == 1
    jb, tb = _batches(text, image)
    loss_j, aux_j, jgrads = _jax_loss_and_grads(jcfg, params, jb)
    loss, aux, grads = grad_step(model, tb)
    for key in ("loss", "loss_text", "loss_img"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]),
                                   **LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), **LOSS_TOL)
    _assert_grads_close(tcfg, grads, jgrads)


@pytest.mark.parametrize("layout", ["shared", "dense_scan"])
def test_equals_save_attn_exactly(layout):
    """Two micro-batches under ``save_ctx`` give ``save_attn``'s loss and
    gradients bit for bit."""
    extra = DENSE if layout == "dense_scan" else {}
    out = {}
    for policy in ("save_attn", "save_ctx"):
        _, tcfg, _, model, text, image = _setup(
            "flagship_tiny", batch=4, remat_policy=policy, **extra)
        assert bool(tcfg.dense_scan_reps()) == (layout == "dense_scan")
        _, tb = _batches(text, image)
        out[policy] = grad_step(model, tb, accum_steps=2)
    (loss_a, aux_a, g_a), (loss_c, aux_c, g_c) = out.values()
    assert torch.equal(loss_a, loss_c)
    assert all(torch.equal(aux_a[k], aux_c[k]) for k in aux_a)
    assert sorted(g_a) == sorted(g_c)
    assert all(torch.equal(g_a[n], g_c[n]) for n in g_a)


def test_attention_runs_once_and_the_projections_replay(monkeypatch):
    """The attention forward wrappers run once a layer and micro-batch,
    as ``wrapper_calls`` says (every wrapper's count equal to it); the
    q/k/v projections of each rematerialised layer run twice (the
    forward and the replay), the plain block's once. After the step no
    holder is left."""
    _, tcfg, _, model, text, image = _setup(
        "flagship_tiny", batch=4, remat_policy="save_ctx")
    _, tb = _batches(text, image)
    calls = _count_wrappers(monkeypatch)
    proj = {"count": 0}
    dense_forward = Dense.forward

    def counting(self, x, dtype):
        if any(self is getattr(block.attn, name)
               for block in model.transformer.blocks.values()
               for name in ("q", "k", "v")):
            proj["count"] += 1
        return dense_forward(self, x, dtype)

    monkeypatch.setattr(Dense, "forward", counting)
    grad_step(model, tb, accum_steps=2)
    assert calls == {k: 2 * v
                     for k, v in wrapper_calls(tcfg, training=True).items()}
    layers = len(tcfg.layer_schedule())
    # two calls a layer (text, image), two micro-batches
    assert calls["line_attention"] + calls["window_attention"] == \
        2 * 2 * layers
    plain = set(tcfg.plain_block_ids())
    remat = sum(1 for uid, _ in tcfg.layer_schedule() if uid not in plain)
    assert 0 < remat < layers
    assert proj["count"] == 2 * 3 * (2 * remat + (layers - remat))
    gc.collect()
    assert not [o for o in gc.get_objects()
                if type(o) is tatt.SavedContext]

