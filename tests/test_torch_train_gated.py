"""The port's training loss and every gradient against
``jax.value_and_grad`` of the JAX package's loss (Pallas in interpret
mode) on ``gated``: the flagship's structure (``FLAGSHIP_TUNED``: fused
LayerNorm, ``save_attn`` remat with ``block_3`` left plain and its fused
GEGLU, ``w_conv``, hoisted parameter casts) at a width where JAX runs its
LayerNorm and GEGLU backward kernels too, in f32 and in bf16. Helpers and
tolerances: tests/test_torch_train.py."""

import numpy as np
import torch

from dalle_tpu_torch.training.steps import grad_step
from tests.test_torch_train import (LOSS_TOL, _assert_grads_close,
                                    _batches, _jax_loss_and_grads, _setup,
                                    pallas_interpret)  # noqa: F401


def test_loss_and_grads_match_jax(pallas_interpret):  # noqa: F811
    jcfg, tcfg, params, model, text, image = _setup("gated")
    assert tcfg.remat and tcfg.remat_policy == "save_attn"
    jb, tb = _batches(text, image)
    loss_j, aux_j, jgrads = _jax_loss_and_grads(jcfg, params, jb)
    loss, aux, grads = grad_step(model, tb)
    for key in ("loss", "loss_text", "loss_img"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]),
                                   **LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), **LOSS_TOL)
    _assert_grads_close(tcfg, grads, jgrads)


def test_hoisted_bf16_grads_match_jax(pallas_interpret):  # noqa: F811
    """``param_cast_hoist`` at bf16: the parameters cast once at the top,
    shared blocks' gradients summed in bf16 over their applications. The
    two frameworks round bf16 activations at different places through
    the depth (a relative 2^-8 each), and the shared blocks' bf16 sums
    round again, so a leaf is held to 2^-4 of its largest magnitude: a
    lost or doubled contribution (a whole application's share) still
    shows."""
    jcfg, tcfg, params, model, text, image = _setup(
        "gated", dtype="bfloat16")
    assert tcfg.param_cast_hoist
    jb, tb = _batches(text, image)
    loss_j, _, jgrads = _jax_loss_and_grads(jcfg, params, jb)
    loss, _, grads = grad_step(model, tb)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2 ** -7)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _assert_grads_close(tcfg, grads, jgrads, tol=2 ** -4)
