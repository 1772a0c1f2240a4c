"""The port's training loss and every gradient against
``jax.value_and_grad`` of the JAX package's loss (Pallas in interpret
mode) on the tiny zoo configs: full, axial row/col, the weight-shared scan
with ``w_conv``, and flax's plain LayerNorm with the unfused FF and an
untied head. Helpers and tolerances: tests/test_torch_train.py."""

import numpy as np
import pytest

from dalle_tpu_torch.training.steps import grad_step
from tests.test_torch_train import (LOSS_TOL, _assert_grads_close,
                                    _batches, _jax_loss_and_grads, _setup,
                                    pallas_interpret)  # noqa: F401


@pytest.mark.parametrize("name", ["full", "axial", "scan_wconv",
                                  "plain_untied"])
def test_loss_and_grads_match_jax(name, pallas_interpret):  # noqa: F811
    jcfg, tcfg, params, model, text, image = _setup(name)
    jb, tb = _batches(text, image)
    loss_j, aux_j, jgrads = _jax_loss_and_grads(jcfg, params, jb)
    loss, aux, grads = grad_step(model, tb)
    for key in ("loss", "loss_text", "loss_img"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]),
                                   **LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), **LOSS_TOL)
    _assert_grads_close(tcfg, grads, jgrads)
