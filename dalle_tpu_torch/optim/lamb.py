"""LAMB with built-in global-norm clipping, fp32 state (counterpart of
``dalle_tpu/optim/lamb.py``).

Numerics follow the JAX package's fp32 optimizer (``lamb`` /
``make_optimizer_fp32``): gradients cast to f32 and clipped by their global
norm before the moments; no bias correction; per-tensor trust ratio
``clamp(||w||, max=clamp_value) / ||m/(sqrt(v)+eps) + wd*w||``, 1.0 where
either norm is zero; weight decay only where ``default_wd_mask`` allows it.
The step's learning rate comes from ``make_lr_schedule`` at the state's
count, so the first update (count 0) has learning rate 0, as in JAX.

Parameters, gradients and moments are dicts keyed by the port's parameter
names (``model.named_parameters()``). The JAX optimizer's per-slice trust
ratio for ``dense_scan``'s stacked leaves has no counterpart: the port
keeps every layer's weights as their own tensors (it never stacks them,
and ``params.py`` refuses the stacked layout), so every trust ratio is
per tensor, and :meth:`Lamb.init` refuses a stacked parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from dalle_tpu_torch.config import OptimizerConfig
from dalle_tpu_torch.params import flax_path

Tensors = Dict[str, torch.Tensor]


class LambState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(t.float()))
                                   for t in tensors]).sum())


def default_wd_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies: the rule of the JAX package's
    ``default_wd_mask`` (no decay where the lowercased parameter path
    contains "bias", "norm" or "scale"), applied to the flax path each
    port parameter maps to."""
    out = {}
    for name, _ in model.named_parameters():
        joined = "/".join(("params",) + flax_path(name, model.cfg)).lower()
        out[name] = not ("bias" in joined or "norm" in joined
                         or "scale" in joined)
    return out


def lamb_leaf_update(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     decay: bool, lr: float, *, eps: float,
                     weight_decay: float,
                     clamp_value: float) -> torch.Tensor:
    """The per-tensor LAMB update (``lamb.lamb_leaf_update``):
    adam_step = m/(sqrt(v)+eps) + wd*p; trust = clamp(||p||, clamp_value) /
    ||adam_step|| (1.0 where either norm is 0); update = -lr*trust*adam_step,
    in p's dtype."""
    p32 = p.float()
    adam_step = m / (torch.sqrt(v) + eps)
    if weight_decay:
        adam_step = adam_step + (weight_decay if decay else 0.0) * p32
    wnorm = torch.clamp(torch.sqrt(torch.sum(p32 * p32)), max=clamp_value)
    anorm = torch.sqrt(torch.sum(adam_step * adam_step))
    trust = torch.where((wnorm > 0) & (anorm > 0), wnorm / (anorm + 1e-12),
                        torch.ones_like(wnorm))
    return (-lr * trust * adam_step).to(p.dtype)


def check_unstacked(model: nn.Module) -> None:
    """Refuse stacked per-layer parameters, by the rule of
    ``lamb.default_stacked_mask``: a block leaf above its kind's rank
    (kernel 2, bias/scale 1) would be stacked."""
    for name, p in model.named_parameters():
        canonical = 2 if name.endswith("kernel") else 1
        if name.startswith("transformer.blocks.") and p.dim() > canonical:
            raise ValueError(f"{name}: stacked per-layer parameters are "
                             "not supported")


def clip_grads(grads: Tensors, max_grad_norm) -> Tensors:
    """The gradients in f32, scaled by ``min(1, max_grad_norm / (global
    norm + 1e-12))``; unscaled when ``max_grad_norm`` is None."""
    grads = {n: g.float() for n, g in grads.items()}
    if max_grad_norm is None:
        return grads
    scale = torch.clamp(max_grad_norm / (global_norm(grads.values()) + 1e-12),
                        max=1.0)
    return {n: g * scale for n, g in grads.items()}


def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """``optax.linear_schedule(init, end, steps)`` at ``count``, in the
    float32 arithmetic optax runs it in."""
    if steps <= 0:
        return np.float32(init)
    frac = np.float32(1) - (np.float32(min(max(count, 0), steps))
                            / np.float32(steps))
    return np.float32(init - end) * frac + np.float32(end)


def make_lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Linear warmup from 0 to ``learning_rate`` over ``warmup_steps``, then
    linear decay to 0 at ``total_steps`` (``lamb.make_lr_schedule``)."""
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return float(_linear(0.0, cfg.learning_rate, cfg.warmup_steps,
                                 count))
        return float(_linear(cfg.learning_rate, 0.0, decay_steps,
                             count - cfg.warmup_steps))

    return schedule


class Lamb:
    """Clipped LAMB with f32 moments (``lamb.lamb`` as
    ``make_optimizer_fp32`` builds it): ``init(model)`` -> state;
    ``update(grads, state, model)`` -> ``(updates, state)``; the updates are
    applied with :func:`apply_updates`. The hyperparameters are ``cfg``'s,
    the learning rate is ``schedule(count)``."""

    def __init__(self, schedule: Callable[[int], float],
                 cfg: OptimizerConfig):
        self.schedule, self.cfg = schedule, cfg

    def init(self, model: nn.Module) -> LambState:
        check_unstacked(model)
        zeros = {name: torch.zeros_like(p, dtype=torch.float32)
                 for name, p in model.named_parameters()}
        return LambState(0, zeros,
                         {n: torch.zeros_like(t) for n, t in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: LambState,
               model: nn.Module) -> Tuple[Tensors, LambState]:
        cfg = self.cfg
        grads = clip_grads(grads, cfg.max_grad_norm)
        mu = {n: cfg.beta1 * state.mu[n] + (1 - cfg.beta1) * g
              for n, g in grads.items()}
        nu = {n: cfg.beta2 * state.nu[n] + (1 - cfg.beta2) * g * g
              for n, g in grads.items()}
        lr = self.schedule(state.count)
        decay = default_wd_mask(model)
        params = dict(model.named_parameters())
        updates = {n: lamb_leaf_update(
            params[n], mu[n], nu[n], decay[n], lr, eps=cfg.eps,
            weight_decay=cfg.weight_decay, clamp_value=cfg.clamp_value)
            for n in grads}
        return updates, LambState(state.count + 1, mu, nu)


@torch.no_grad()
def apply_updates(model: nn.Module, updates: Tensors) -> None:
    """``optax.apply_updates`` in place: each parameter += its update (the
    update is already in the parameter's dtype)."""
    for name, p in model.named_parameters():
        p.add_(updates[name])


def make_optimizer_fp32(cfg: OptimizerConfig) -> Lamb:
    """The fp32 clipped LAMB with the linear schedule
    (``lamb.make_optimizer_fp32``)."""
    return Lamb(make_lr_schedule(cfg), cfg)
