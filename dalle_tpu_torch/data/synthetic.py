"""Synthetic VQGAN-code dataset (the port's own copy of
``dalle_tpu/data/synthetic.py``, numpy only).

Batches have the schema of the real data (caption token ids + int image
codes), with a learnable deterministic caption -> codes mapping, so a loss
curve means something without the real dataset. The same configuration,
size and seed give the same arrays as the JAX package's ``SyntheticCodes``.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from dalle_tpu_torch.config import ModelConfig


class SyntheticCodes:
    """``num_samples`` fixed (caption, codes) pairs; codes derive from the
    caption."""

    def __init__(self, cfg: ModelConfig, num_samples: int = 64,
                 seed: int = 0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        n = num_samples
        self.text = rng.integers(
            2, cfg.vocab_text, size=(n, cfg.text_seq_len), dtype=np.int32)
        # code[j] = (a*j + b) % vocab_image with (a, b) from the first
        # caption tokens
        a = self.text[:, 0] % 7 + 1
        b = self.text[:, 1]
        j = np.arange(cfg.image_seq_len)
        self.image = ((a[:, None] * j[None, :] + b[:, None])
                      % cfg.vocab_image).astype(np.int32)

    def __len__(self) -> int:
        return self.text.shape[0]

    def batches(self, batch_size: int, seed: int = 0,
                loop: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled batches; ``seed`` is the per-peer data seed."""
        rng = np.random.default_rng(seed)
        n = len(self)
        if batch_size > n:
            raise ValueError(
                f"batch_size {batch_size} > dataset size {n}")
        while True:
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i: i + batch_size]
                yield {"text": self.text[idx], "image": self.image[idx]}
            if not loop:
                return
