"""The plain reference of the 8-bit LAMB (the optimizer of the JAX
package and of learning-at-home/dalle's ``task.py``, LAMB with
block-wise 8-bit moments), in PyTorch and NumPy alone.

Per update: the gradients in f32, clipped by their global norm
(``max_grad_norm``); for each leaf ``m = b1 * deq(m) + (1 - b1) * g`` and
``v = b2 * deq(v) + (1 - b2) * g * g``; ``adam = m / (sqrt(v) + eps)`` plus
``weight_decay * p`` where the leaf's name has no "bias", "norm" or
"scale"; the trust ratio ``min(||p||, clamp_value) / ||adam||`` (1 where
either norm is 0); ``p -= lr * trust * adam``; the moments of leaves of at
least ``min_8bit_size`` elements stored again in blocks of ``block_size``
as the index of the nearest entry of a 256-entry dynamic-tree codebook
(signed for ``m``, unsigned for ``v``) and the block's absmax. The
learning rate rises linearly from 0 over ``warmup_steps`` and falls
linearly to 0 at ``total_steps``; the first update has rate 0.

The codebook is a frozen copy of the port's plain ``dynamic_codebook``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class LambConfig:
    learning_rate: float = 2.5e-3
    warmup_steps: int = 3125
    total_steps: int = 31250
    beta1: float = 0.9
    beta2: float = 0.96
    eps: float = 1e-6
    weight_decay: float = 0.045
    max_grad_norm: float = 4.0
    clamp_value: float = 10000.0
    block_size: int = 4096
    min_8bit_size: int = 65536


@lru_cache(maxsize=4)
def codebook(signed: bool) -> np.ndarray:
    data_bits = 7 if signed else 8
    mags = [0.0]
    for e in range(data_bits):
        n = 2 ** (data_bits - 1 - e)
        mags.extend((10.0 ** -e) * (np.arange(n) + 1.0) / n)
    mags = np.asarray(sorted(set(mags)), dtype=np.float64)
    vals = np.concatenate([-mags[::-1], mags[1:]]) if signed else mags
    vals = np.unique(vals.astype(np.float32))
    while vals.size > 256:
        nz = np.nonzero(vals)[0]
        vals = np.delete(vals, nz[np.argmin(np.abs(vals[nz]))])
    while vals.size < 256:
        i = int(np.argmax(np.diff(vals)))
        mid = np.float32(0.5 * (vals[i] + vals[i + 1]))
        if mid == vals[i] or mid == vals[i + 1]:
            break
        vals = np.insert(vals, i + 1, mid)
    return vals


@dataclass
class Q8:
    codes: torch.Tensor     # (n_blocks, block) uint8
    absmax: torch.Tensor    # (n_blocks, 1) f32
    shape: Tuple[int, ...]
    signed: bool


Moment = Union[Q8, torch.Tensor]


def quantize(x: torch.Tensor, block: int, signed: bool) -> Q8:
    flat = x.reshape(-1).float()
    pad = -flat.numel() % block
    blocks = F.pad(flat, (0, pad)).view(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    normed = blocks / torch.where(absmax > 0, absmax,
                                  torch.ones_like(absmax))
    cb = codebook(signed)
    mids = torch.from_numpy((0.5 * (cb[:-1] + cb[1:])).astype(np.float32))
    codes = torch.searchsorted(mids.to(x.device), normed, right=False)
    return Q8(codes.to(torch.uint8), absmax, tuple(x.shape), signed)


def dequantize(codes: torch.Tensor, absmax: torch.Tensor, shape, signed: bool
               ) -> torch.Tensor:
    """``codebook[codes] * absmax`` cut back to ``shape``; also reads a
    quantized moment of the program's state (its codes and absmax)."""
    cb = torch.from_numpy(codebook(signed)).to(codes.device)
    n = int(np.prod(shape))
    return (cb[codes.long()] * absmax).reshape(-1)[:n].reshape(shape)


def dense(moment: Moment) -> torch.Tensor:
    if isinstance(moment, Q8):
        return dequantize(moment.codes, moment.absmax, moment.shape,
                          moment.signed)
    return moment


def learning_rate(cfg: LambConfig, count: int) -> float:
    if count < cfg.warmup_steps:
        return cfg.learning_rate * count / cfg.warmup_steps
    decay = max(cfg.total_steps - cfg.warmup_steps, 1)
    done = min(count - cfg.warmup_steps, decay)
    return cfg.learning_rate * (1.0 - done / decay)


def decays(name: str) -> bool:
    low = name.lower()
    return not ("bias" in low or "norm" in low or "scale" in low)


class Lamb8bit:
    def __init__(self, cfg: LambConfig):
        self.cfg = cfg
        self.count = 0
        self.mu: Dict[str, Moment] = {}
        self.nu: Dict[str, Moment] = {}

    def _store(self, x: torch.Tensor, signed: bool) -> Moment:
        if x.numel() >= self.cfg.min_8bit_size:
            return quantize(x, self.cfg.block_size, signed)
        return x

    def init(self, params: Dict[str, torch.Tensor]) -> None:
        for n, p in params.items():
            zero = torch.zeros_like(p, dtype=torch.float32)
            self.mu[n], self.nu[n] = (self._store(zero, True),
                                      self._store(zero, False))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """One update, in place on ``params``."""
        cfg = self.cfg
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                              for g in grads.values()))
        scale = torch.clamp(cfg.max_grad_norm / (norm + 1e-12), max=1.0)
        lr = learning_rate(cfg, self.count)
        for n, p in params.items():
            g = grads[n].float() * scale
            m = cfg.beta1 * dense(self.mu[n]) + (1 - cfg.beta1) * g
            v = cfg.beta2 * dense(self.nu[n]) + (1 - cfg.beta2) * g * g
            adam = m / (torch.sqrt(v) + cfg.eps)
            if decays(n):
                adam = adam + cfg.weight_decay * p.float()
            wnorm = torch.clamp(p.float().norm(), max=cfg.clamp_value)
            anorm = adam.norm()
            trust = torch.where((wnorm > 0) & (anorm > 0),
                                wnorm / (anorm + 1e-12),
                                torch.ones_like(wnorm))
            p.add_((-lr * trust * adam).to(p.dtype))
            self.mu[n] = self._store(m, True)
            self.nu[n] = self._store(v, False)
        self.count += 1
