"""Host-offloaded optimizer state (``dalle_tpu_torch/training/offload.py``)
against the on-device update and the JAX package's offloaded apply
(``dalle_tpu.training.offload``); the counterpart of tests/test_offload.py.

The offloaded apply runs the same per-leaf update as the on-device one on
the same device, so the two are held to each other exactly (parameters,
every moment tensor, the count). Against JAX's
``make_offloaded_apply_step``, which jits the update on the host (where
XLA may contract ``b1 * m + (1 - b1) * g`` into one fused multiply-add,
one rounding where the port takes two, and sums the global norm in
another order): parameters within 1e-6 of the leaf's largest magnitude,
dense moments within 1e-6 of theirs, 8-bit codes each within one code on
all but 0.1% of the elements and absmax within 1e-5 relative (the
tolerances of tests/test_torch_quant.py with the clip on).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.optim import make_optimizer as jax_make_optimizer
from dalle_tpu.parallel.mesh import make_mesh
from dalle_tpu.training.offload import make_offloaded_apply_step as \
    jax_offloaded_apply
from dalle_tpu.training.offload import offload_train_state as jax_offload
from dalle_tpu.training.steps import TrainState as JaxTrainState
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.ops.quant import Quantized
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.params import params_from_jax, state_leaf_tensors
from dalle_tpu_torch.training.offload import (make_offloaded_apply_step,
                                              offload_train_state)
from dalle_tpu_torch.training.steps import TrainState, apply_step
from tests.test_torch_quant import OPT, _assert_moments, _grads, _tiny

torch.set_num_threads(2)
UPDATES = 3
CLIP = 0.5          # the global clip scales every update here


def _opt_cfg(pkg, bits):
    return pkg.OptimizerConfig(**dict(OPT, state_bits=bits,
                                      max_grad_norm=CLIP))


def _moment_tensors(opt_state):
    out = []
    for tree in (opt_state.mu, opt_state.nu):
        for name in sorted(tree):
            m = tree[name]
            out += [m.codes, m.absmax] if isinstance(m, Quantized) else [m]
    return out


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in zip(state_leaf_tensors(a.model, a.opt_state),
                    state_leaf_tensors(b.model, b.opt_state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bits", [32, 8])
def test_offloaded_apply_matches_on_device_and_jax(bits):
    jcfg, tcfg, params = _tiny()
    jtx = jax_make_optimizer(_opt_cfg(jconfig, bits))
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jstate = jax_offload(mesh, JaxTrainState.create(params, jtx))
    japply = jax_offloaded_apply(jtx, mesh)

    tx = make_optimizer(_opt_cfg(tconfig, bits))
    model = params_from_jax(params, tcfg)
    on_dev = TrainState.create(model, tx)
    off = offload_train_state(TrainState.create(copy.deepcopy(model), tx))
    apply_off = make_offloaded_apply_step(tx)
    host = [t.data_ptr() for t in _moment_tensors(off.opt_state)]
    for i in range(UPDATES):
        jgrads = _grads(params, i, 0.1)
        grads = {n: p.detach() for n, p in params_from_jax(
            jgrads, tcfg).named_parameters()}
        jstate = japply(jstate, jgrads)
        on_dev = apply_step(on_dev, grads, tx)
        off = apply_off(off, grads)
        _assert_states_equal(off, on_dev)
        if bits == 8:
            assert _assert_moments(off.opt_state, jstate.opt_state, tcfg,
                                   exact=False) > 4
    # the host tensors were updated in place
    assert [t.data_ptr() for t in _moment_tensors(off.opt_state)] == host
    assert int(jstate.step) == off.step == UPDATES
    want = dict(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                tcfg).named_parameters())
    for name, p in off.model.named_parameters():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=name)


def test_offloaded_state_lives_on_host_and_params_stay():
    """The moments are host tensors (pinned only on a CUDA peer, so here
    plain CPU memory), the parameters stay in the model; applies keep
    the state on the host, and a second apply steps it again."""
    _, tcfg, params = _tiny()
    tx = make_optimizer(_opt_cfg(tconfig, 8))
    model = params_from_jax(params, tcfg)
    state = offload_train_state(TrainState.create(model, tx))
    assert state.model is model
    tensors = _moment_tensors(state.opt_state)
    assert any(t.dtype == torch.uint8 for t in tensors)
    assert all(t.device.type == "cpu" and not t.is_pinned()
               for t in tensors)
    apply_off = make_offloaded_apply_step(tx)
    grads = {n: torch.full_like(p, 0.01) for n, p in
             model.named_parameters()}
    state = apply_off(apply_off(state, grads), grads)
    assert state.step == 2 and state.opt_state.count == 2
    assert all(t.device.type == "cpu"
               for t in _moment_tensors(state.opt_state))


def test_task_wires_offload(tmp_path):
    from dalle_tpu_torch.task import TrainingTask
    from dalle_tpu_torch.training.offload import make_offloaded_apply_step
    task = TrainingTask(
        tconfig.tiny_model_config(),
        tconfig.OptimizerConfig(warmup_steps=2, total_steps=10,
                                offload=True, state_bits=32),
        tconfig.TrainerConfig(per_device_batch=1),
        tconfig.CollabConfig(),
        tconfig.PeerConfig(identity_path=str(tmp_path / "id.pem")),
        device="cpu")
    state = task.train_state
    assert all(t.device.type == "cpu"
               for t in _moment_tensors(state.opt_state))
    assert task.apply_step.__qualname__ == \
        make_offloaded_apply_step(task.tx).__qualname__
    grads, _ = task.grad_step(state.model, next(task.batches()))
    new_state = task.apply_step(state, grads)
    assert new_state.step == 1 and new_state.opt_state.count == 1
