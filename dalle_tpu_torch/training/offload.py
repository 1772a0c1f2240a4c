"""Host-offloaded optimizer state (counterpart of
``dalle_tpu/training/offload.py``).

Capability parity with the reference's ``OffloadOptimizer``
(``lib/training/offload.py:10-93`` of learning-at-home/dalle, enabled by
``offload_optimizer=True`` at ``task.py:130``): the optimizer state lives
in host memory between updates, so the device holds only the parameters,
the activations and the gradients. With ``OptimizerConfig.offload`` the
task places the state with :func:`offload_train_state` and applies
updates with :func:`make_offloaded_apply_step`, the same
``(state, grads) -> state`` seam as the on-device apply, so the
collaborative optimizer cannot tell the difference.

The port's mechanics: the moments (an 8-bit moment's codes and absmax)
are host tensors, pinned when the parameters are on a CUDA device. The
update runs on the parameters' device, not on the host: the gradients are
clipped by their global norm first, over all of them, as on the device;
then each leaf's moments are copied to the device in the JAX leaf order,
updated there by the optimizer's own :meth:`~dalle_tpu_torch.optim.lamb.
LambBase.leaf_update` (the 8-bit one re-quantizes with the
``quantize_blockwise`` kernel), its parameter is updated in place, and the
new moments are copied back into the host tensors. So an offloaded update
equals the on-device update bit for bit, and between updates the device
holds none of the optimizer state. The copies run on the current stream,
which the apply waits for before it returns, so every reader of the host
tensors (checkpoints, the state server, state averaging) sees the state
of the last update.

On a sharded mesh (``parallel/sharding.py``) the host holds this
process's shards of the moments, as JAX's offload places the state by
``param_shardings``: :func:`offload_train_state` runs after
``shard_train_state``, and each leaf's update gathers the leaf whole on
the device (``LambBase.sharded_leaf_update``) and stores the process's
shards back.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from dalle_tpu_torch.ops.quant import Quantized
from dalle_tpu_torch.params import jax_leaf_names
from dalle_tpu_torch.training.steps import TrainState


def host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory with ``pin``."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return out.copy_(t)


def _moment_to(m, device: torch.device):
    if isinstance(m, Quantized):
        return Quantized(m.codes.to(device, non_blocking=True),
                         m.absmax.to(device, non_blocking=True), m.shape,
                         m.signed)
    return m.to(device, non_blocking=True)


def _moment_host(m, pin: bool):
    if isinstance(m, Quantized):
        return Quantized(host_copy(m.codes, pin), host_copy(m.absmax, pin),
                         m.shape, m.signed)
    return host_copy(m, pin)


def _store(host, new) -> None:
    """Copy the updated moment ``new`` (on the device) into ``host``."""
    if isinstance(host, Quantized):
        host.codes.copy_(new.codes, non_blocking=True)
        host.absmax.copy_(new.absmax, non_blocking=True)
    else:
        host.copy_(new, non_blocking=True)


def offload_train_state(state: TrainState) -> TrainState:
    """``state`` with its optimizer state moved to the host (pinned when
    the parameters are on a CUDA device); the parameters stay where they
    are."""
    device = next(state.model.parameters()).device
    pin = device.type == "cuda"
    opt = state.opt_state
    state.opt_state = type(opt)(
        opt.count, {n: _moment_host(m, pin) for n, m in opt.mu.items()},
        {n: _moment_host(m, pin) for n, m in opt.nu.items()})
    return state


def make_offloaded_apply_step(tx) -> Callable[[TrainState, Dict],
                                              TrainState]:
    """``(state, averaged grads) -> state``: one update of ``tx`` (a
    :class:`~dalle_tpu_torch.optim.lamb.LambBase`) against the host-resident
    state of :func:`offload_train_state`, computed on the parameters'
    device one leaf at a time. The host tensors are updated in place."""

    @torch.no_grad()
    def apply_step(state: TrainState, grads: Dict) -> TrainState:
        model, opt = state.model, state.opt_state
        device = next(model.parameters()).device
        grads, lr, decay, stacked = tx.prepare(grads, opt.count, model)
        params = dict(model.named_parameters())
        sharded = getattr(model, "mesh", None) is not None
        for n in jax_leaf_names(model.cfg):
            if sharded:
                update, m, v = tx.sharded_leaf_update(
                    model, n, grads[n], opt.mu[n], opt.nu[n], lr, decay[n],
                    stacked[n])
            else:
                update, m, v = tx.leaf_update(
                    grads[n], _moment_to(opt.mu[n], device),
                    _moment_to(opt.nu[n], device), params[n], lr, decay[n],
                    stacked[n])
            params[n].add_(update)
            _store(opt.mu[n], m)
            _store(opt.nu[n], v)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        state.opt_state = type(opt)(opt.count + 1, opt.mu, opt.nu)
        state.step += 1
        return state

    return apply_step
