"""Training steps with micro-batch accumulation (counterpart of
``dalle_tpu/training/steps.py``).

- :func:`grad_step`: forward/backward over ``accum_steps`` micro-batches;
  the mean loss, aux and f32 gradients (an f32 accumulator, then
  x 1/accum_steps), without touching the optimizer state. What a swarm
  peer runs while it accumulates toward the target batch.
- :func:`apply_step`: applies (averaged) gradients through the optimizer;
  once per swarm epoch.
- :func:`train_step`: the fused local step, both of the above, with the
  metrics ``loss``, ``loss_text``, ``loss_img`` and ``grad_norm`` (the
  global norm of the gradients before the optimizer's clip).

Parameters are updated in place (the JAX steps donate their state, to the
same end). A batch is a dict of (B, ...) tensors on the model's device:
``text`` (B, text_seq_len), ``image`` (B, image_seq_len) and an optional
``mask`` (B, T); micro-batch ``i`` is rows ``[i*B/a, (i+1)*B/a)``.

``cfg.param_cast_hoist`` casts every floating parameter to the activation
dtype once per micro-batch, at the top of the loss, and runs the model on
the cast copies (:func:`cast_parameters`): the weight-shared blocks'
gradient contributions from all their applications then sum in the
activation dtype into the one cast copy, and its cast turns the sum to f32
once, as JAX's hoisted cast does. Master parameters, the accumulator and
LAMB stay f32. The copies stay in the modules through the backward pass,
because the rematerialised blocks run their forward again there.

On a sharded mesh (``models/dalle.py``) each process's loss is its part of
the global loss, and :func:`grad_step` accumulates the micro-batches'
gradients on its shards, then :func:`reduce_gradients` sums them over the
batch axes and the token shards: the gradients of JAX's grad step over the
global mesh, each process holding its shards.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch import nn

from dalle_tpu_torch.models.transformer import seq_group, torch_dtype
from dalle_tpu_torch.optim.lamb import (apply_updates, global_norm,
                                        sharded_global_norm)

Batch = Dict[str, torch.Tensor]
AUX_KEYS = ("loss", "loss_text", "loss_img")


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Any

    @classmethod
    def create(cls, model: nn.Module, optimizer) -> "TrainState":
        return cls(step=0, model=model, opt_state=optimizer.init(model))


@contextlib.contextmanager
def cast_parameters(model: nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter of ``model`` is replaced
    by one cast copy (``p.to(dtype)``, a shared parameter by one copy for
    all its uses), through which gradients flow back to the parameter.
    The parameters are put back on exit."""
    swapped, copies = [], {}
    for module in model.modules():
        for name, p in module._parameters.items():
            if p is not None and p.is_floating_point():
                if id(p) not in copies:
                    copies[id(p)] = p.to(dtype)
                swapped.append((module, name, p))
    for module, name, p in swapped:
        module._parameters[name] = copies[id(p)]
    try:
        yield
    finally:
        for module, name, p in swapped:
            module._parameters[name] = p


def grad_step(model: nn.Module, batch: Batch, accum_steps: int = 1
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         Dict[str, torch.Tensor]]:
    """Mean ``(loss, aux, grads)`` over ``accum_steps`` micro-batches;
    ``grads`` f32, keyed by parameter name."""
    rows = next(iter(batch.values())).shape[0]
    if rows % accum_steps:
        raise ValueError(f"batch of {rows} does not split into "
                         f"{accum_steps} micro-batches")
    mb = rows // accum_steps
    names, params = zip(*model.named_parameters())
    cfg = model.cfg

    def hoist():
        if not cfg.param_cast_hoist:
            return contextlib.nullcontext()
        return cast_parameters(model, torch_dtype(cfg.dtype))

    grads = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in zip(names, params)}
    loss_acc = None
    aux_acc = dict.fromkeys(AUX_KEYS)
    for i in range(accum_steps):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        with hoist():
            loss, aux = model(micro["text"], micro["image"],
                              loss_mask=micro.get("mask"))
            g = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        for n, gi in zip(names, g):
            grads[n].add_(gi)
        # the global loss (on a sharded mesh ``loss`` is this rank's part)
        loss = aux["loss"].detach().float()
        loss_acc = loss if loss_acc is None else loss_acc + loss
        for key in AUX_KEYS:
            val = aux[key].detach().float()
            aux_acc[key] = val if aux_acc[key] is None else aux_acc[key] + val
    if getattr(model, "mesh", None) is not None:
        reduce_gradients(model, grads)
    inv = 1.0 / accum_steps
    for g in grads.values():
        g.mul_(inv)
    return (loss_acc * inv, {k: v * inv for k, v in aux_acc.items()},
            grads)


@torch.no_grad()
def reduce_gradients(model: nn.Module, grads: Dict[str, torch.Tensor]
                     ) -> None:
    """Sum each shard's gradient, in place, over the processes whose
    parts of the loss it has not yet summed: the token shards (each saw
    its tokens; under ring or Ulysses, ``models.transformer.
    token_shards``) and the batch ranks, where a kernel's fsdp all-gather
    has already reduce-scattered it over ``fsdp`` (then over ``dp``
    alone). The ``tp`` ranks' gradients are whole already (column- and
    row-parallel products, and the leaves ``tp`` does not divide computed
    whole on every rank, ``models/transformer.py``), and so are the
    ``sp`` ranks' where ``sp`` is a replica axis: each holds the whole
    gradient of its rows, the same bits on every ``sp`` rank. One
    collective a group over the flat concatenation."""
    from dalle_tpu_torch.parallel.collectives import sum_over
    mesh = model.mesh
    specs = model.shard_specs
    seq = seq_group(mesh, model.cfg)
    for axes, pick in (([mesh.group("dp"), seq], lambda s: "fsdp" in s),
                       ([mesh.group("batch"), seq],
                        lambda s: "fsdp" not in s)):
        names = [n for n in grads if pick(specs[n])]
        if not names or all(g is None for g in axes):
            continue
        flat = sum_over(torch.cat([grads[n].reshape(-1) for n in names]),
                        axes)
        offset = 0
        for n in names:
            size = grads[n].numel()
            grads[n].copy_(flat[offset:offset + size].view(grads[n].shape))
            offset += size


def apply_step(state: TrainState, grads: Dict[str, torch.Tensor],
               optimizer) -> TrainState:
    """One optimizer update with ``grads``; returns the advanced state."""
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.model)
    apply_updates(state.model, updates)
    state.step += 1
    state.opt_state = opt_state
    return state


def train_step(state: TrainState, batch: Batch, optimizer,
               accum_steps: int = 1) -> Tuple[TrainState, Dict]:
    """The fused step: ``grad_step`` then ``apply_step``; metrics ``loss``,
    ``loss_text``, ``loss_img`` and ``grad_norm``, as 0-d tensors."""
    _, aux, grads = grad_step(state.model, batch, accum_steps)
    metrics = dict(aux)
    model = state.model
    if getattr(model, "mesh", None) is not None:
        from dalle_tpu_torch.params import jax_leaf_names
        metrics["grad_norm"] = sharded_global_norm(
            grads, jax_leaf_names(model.cfg), model)
    else:
        metrics["grad_norm"] = global_norm(grads.values())
    return apply_step(state, grads, optimizer), metrics
