"""LAMB with block-wise 8-bit quantized moments (counterpart of
``dalle_tpu/optim/lamb8bit.py``, the JAX package's default optimizer).

The update math is the fp32 LAMB's (:mod:`dalle_tpu_torch.optim.lamb`):
the gradients are cast to f32 and clipped by their global norm first, then
``m = b1 * deq(m) + (1 - b1) * g`` and ``v = b2 * deq(v) + (1 - b2) * g * g``
in that op order, then ``lamb_leaf_update``, then the moments are quantized
again. Moments of tensors with at least ``min_8bit_size`` elements are
stored as :class:`~dalle_tpu_torch.ops.quant.Quantized` (blocks of
``block_size``; the first moment with the signed dynamic codebook, the
second with the unsigned one); smaller tensors keep dense f32 moments. The
threshold is ``>=``: a tensor of exactly 65536 elements is quantized. (The
swarm wire's size-adaptive codec, ``swarm/compression.py``, takes u8 from
65537 elements: the two thresholds differ by one.)

On a GPU each update launches the ``quantize_blockwise`` kernel twice per
quantized tensor. The re-quantize writes new tensors, as the JAX update
returns a new state; nothing in the old state is modified.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch
from torch import nn

from dalle_tpu_torch.config import OptimizerConfig
from dalle_tpu_torch.ops.quant import (Quantized, dequantize_blockwise,
                                       quantize_blockwise)
from dalle_tpu_torch.optim.lamb import LambBase, make_lr_schedule

Moment = Union[Quantized, torch.Tensor]


class Lamb8bitState(NamedTuple):
    count: int
    mu: Dict[str, Moment]
    nu: Dict[str, Moment]


class Lamb8bit(LambBase):
    """Clipped LAMB with 8-bit moments (``lamb8bit.lamb8bit`` as
    ``make_optimizer_8bit`` builds it), the interface of
    :class:`~dalle_tpu_torch.optim.lamb.LambBase`."""

    def _quantize(self, x: torch.Tensor, signed: bool) -> Moment:
        if x.numel() >= self.cfg.min_8bit_size:
            return quantize_blockwise(x, self.cfg.block_size, signed=signed)
        return x

    def init(self, model: nn.Module) -> Lamb8bitState:
        """Quantized zeros (dense f32 zeros below ``min_8bit_size``; a
        stacked leaf counts all of its slices)."""
        mu, nu = {}, {}
        for name, p in model.named_parameters():
            zeros = torch.zeros_like(p, dtype=torch.float32)
            mu[name] = self._quantize(zeros, True)
            nu[name] = self._quantize(zeros, False)
        return Lamb8bitState(0, mu, nu)

    def leaf_update(self, g, m_s: Moment, v_s: Moment, p, lr: float,
                    decay: bool, stacked: bool):
        cfg = self.cfg
        m = cfg.beta1 * _dequantize(m_s) + (1 - cfg.beta1) * g
        v = cfg.beta2 * _dequantize(v_s) + (1 - cfg.beta2) * g * g
        update = self.lamb_update(p, m, v, lr, decay, stacked)
        if isinstance(m_s, Quantized):
            m = quantize_blockwise(m, cfg.block_size, signed=True)
        if isinstance(v_s, Quantized):
            v = quantize_blockwise(v, cfg.block_size, signed=False)
        return update, m, v


def _dequantize(moment: Moment) -> torch.Tensor:
    return (dequantize_blockwise(moment) if isinstance(moment, Quantized)
            else moment)


def make_optimizer_8bit(cfg: OptimizerConfig) -> Lamb8bit:
    """The 8-bit clipped LAMB with the linear schedule
    (``lamb8bit.make_optimizer_8bit``)."""
    return Lamb8bit(make_lr_schedule(cfg), cfg)


def optimizer_state_bytes(state) -> int:
    """Bytes held by the optimizer state, counted as the JAX package counts
    its leaves: u8 codes 1 byte, absmax and dense moments 4, and 4 for the
    step count (an int32 leaf there)."""
    total = 4
    for moments in (state.mu, state.nu):
        for m in moments.values():
            tensors = (m.codes, m.absmax) if isinstance(m, Quantized) else (m,)
            total += sum(t.numel() * t.element_size() for t in tensors)
    return total
