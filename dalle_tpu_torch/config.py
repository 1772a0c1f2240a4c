"""Configuration of the PyTorch port.

The port's own copy of ``dalle_tpu/config.py``'s model and optimizer
halves (``ModelConfig``, the attention-type names, ``tiny_model_config``,
the flagship preset and ``OptimizerConfig``): the port imports nothing of
``dalle_tpu``. Field names, defaults and the derived schedule are
identical, so one set of keyword arguments builds the same model in either
package, and the parameter converter (``params.py``) can map one tree onto
the other.

The training knobs ``remat``, ``remat_policy``, ``remat_skip_blocks`` and
``param_cast_hoist`` shape the port's training step as they shape the JAX
one (``remat`` and ``remat_skip_blocks`` also decide which blocks run the
fused GEGLU kernel, ``fuse_ff``). ``scan_unroll``, ``head_chunk`` and
``sequence_parallel`` are kept so both packages build the same
configuration: ``scan_unroll`` decides which parameter layout the JAX model
writes, and the port ignores the other two.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

ATTN_FULL = "full"
ATTN_AXIAL_ROW = "axial_row"
ATTN_AXIAL_COL = "axial_col"
ATTN_CONV_LIKE = "conv_like"

VALID_ATTN_TYPES = (ATTN_FULL, ATTN_AXIAL_ROW, ATTN_AXIAL_COL, ATTN_CONV_LIKE)

SP_NONE = "none"
SP_ULYSSES = "ulysses"
SP_RING = "ring"

VALID_SP_MODES = (SP_NONE, SP_ULYSSES, SP_RING)


@dataclass(frozen=True)
class ModelConfig:
    """DALL-E transformer shape (defaults: the 1.3B flagship, dim 1024,
    depth 64 over 4 weight-shared blocks plus a final ``conv_like`` block,
    16 heads x 64, text 256 + image 32x32 tokens)."""

    vocab_text: int = 32100
    vocab_image: int = 8192
    text_seq_len: int = 256
    image_grid: int = 32
    dim: int = 1024
    depth: int = 64
    heads: int = 16
    head_dim: int = 64
    ff_mult: int = 4
    attn_types: Tuple[str, ...] = (
        ATTN_AXIAL_ROW, ATTN_AXIAL_COL, ATTN_AXIAL_ROW, ATTN_AXIAL_ROW)
    shared_block_cycle: int = 4
    dense_scan: bool = False
    final_conv_block: bool = True
    conv_kernel: int = 11
    rotary: bool = True
    tied_embeddings: bool = True
    dropout: float = 0.0
    loss_img_weight: float = 7.0
    remat: bool = True
    remat_policy: Optional[str] = None
    remat_skip_blocks: int = 0
    head_chunk: int = 0
    scan_unroll: int = 1
    param_cast_hoist: bool = False
    ff_fusion: str = "plain"
    ln_fusion: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    sequence_parallel: str = SP_NONE

    @property
    def image_seq_len(self) -> int:
        return self.image_grid * self.image_grid

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def vocab_total(self) -> int:
        return self.vocab_text + self.vocab_image

    def fuse_ff(self, is_plain: bool) -> bool:
        """Whether a block's FF goes through the fused GEGLU kernel: "all"
        fuses every block; "plain" fuses the blocks the JAX trainer does not
        rematerialise (``remat_skip_blocks``), or every block without remat."""
        return (self.ff_fusion == "all"
                or (self.ff_fusion == "plain"
                    and (is_plain or not self.remat)))

    def plain_block_ids(self) -> Tuple[int, ...]:
        """Unique body block ids the JAX model leaves un-rematerialised: the
        highest ``remat_skip_blocks`` ids of the body (``w_conv`` never)."""
        if not (self.remat and self.remat_skip_blocks):
            return ()
        body = sorted({u for u, _ in self.layer_schedule() if u != -1})
        return tuple(body[len(body) - self.remat_skip_blocks:])

    def layer_schedule(self) -> Tuple[Tuple[int, str], ...]:
        """(unique_block_id, attn_type) per layer; the final ``conv_like``
        block, when present, has id -1."""
        sched = []
        body = self.depth - (1 if self.final_conv_block else 0)
        cycle = self.shared_block_cycle or body
        for i in range(body):
            uid = i % cycle
            sched.append((uid, self.attn_types[uid % len(self.attn_types)]))
        if self.final_conv_block:
            sched.append((-1, ATTN_CONV_LIKE))
        return tuple(sched)

    def dense_scan_reps(self) -> int:
        """Scan repetitions of the JAX ``dense_scan`` layout (0 when the
        dense stack is not stacked)."""
        if self.shared_block_cycle or not self.dense_scan:
            return 0
        body = self.depth - (1 if self.final_conv_block else 0)
        reps = -(-body // len(self.attn_types))
        return reps if reps > 1 else 0

    def validate(self) -> None:
        for t in self.attn_types:
            if t not in VALID_ATTN_TYPES:
                raise ValueError(f"unknown attention type {t!r}")
        if self.dim != self.heads * self.head_dim:
            raise ValueError("dim must equal heads * head_dim")
        if self.remat_policy not in (None, "save_ctx", "save_attn"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                "expected None, 'save_ctx' or 'save_attn'")
        if not (0 <= self.remat_skip_blocks
                <= max(self.shared_block_cycle, 0)):
            raise ValueError(
                f"remat_skip_blocks {self.remat_skip_blocks} outside "
                f"[0, shared_block_cycle={self.shared_block_cycle}]")
        if self.ff_fusion not in ("none", "plain", "all"):
            raise ValueError(
                f"unknown ff_fusion {self.ff_fusion!r}; "
                "expected 'none', 'plain' or 'all'")
        if self.sequence_parallel not in VALID_SP_MODES:
            raise ValueError(
                f"unknown sequence_parallel {self.sequence_parallel!r}; "
                f"expected one of {VALID_SP_MODES}")
        if self.sequence_parallel == SP_RING:
            types = set(self.attn_types) | (
                {ATTN_CONV_LIKE} if self.final_conv_block else set())
            if types != {ATTN_FULL}:
                raise ValueError(
                    "sequence_parallel='ring' requires every layer be "
                    f"'full' attention (got {sorted(types)})")


def tiny_model_config(**overrides: Any) -> ModelConfig:
    """CPU-sized configuration (the JAX package's ``tiny_model_config``)."""
    base = dict(
        vocab_text=128, vocab_image=64, text_seq_len=16, image_grid=4,
        dim=64, depth=4, heads=4, head_dim=16, shared_block_cycle=0,
        final_conv_block=False, attn_types=(ATTN_FULL,), rotary=True,
        dtype="float32", remat=False,
    )
    base.update(overrides)
    return ModelConfig(**base)


# The JAX package's flagship training knobs. ``ln_fusion`` and
# ``remat_skip_blocks`` (through ``fuse_ff``) change what the forward runs;
# ``remat_policy`` and ``param_cast_hoist`` shape the training step;
# ``head_chunk`` and ``scan_unroll`` are kept so the two packages build the
# same configuration.
FLAGSHIP_TUNED = dict(remat_skip_blocks=1, head_chunk=2048, scan_unroll=2,
                      ln_fusion=True, remat_policy="save_attn",
                      param_cast_hoist=True)


def flagship_model_config(**overrides: Any) -> ModelConfig:
    """The 1.3B flagship with ``FLAGSHIP_TUNED`` applied."""
    base = dict(FLAGSHIP_TUNED)
    base.update(overrides)
    return dataclasses.replace(ModelConfig(), **base)


@dataclass(frozen=True)
class OptimizerConfig:
    """LAMB hyperparameters (``dalle_tpu.config.OptimizerConfig``, the
    fields this port reads). ``state_bits`` 8 (the default, as in the JAX
    package) is the 8-bit LAMB: moments of tensors with at least
    ``min_8bit_size`` elements block-quantized in blocks of ``block_size``;
    32 is the fp32 clipped LAMB. ``max_grad_norm`` None turns the global
    clip off."""

    learning_rate: float = 2.5e-3
    warmup_steps: int = 3125
    total_steps: int = 31250
    beta1: float = 0.9
    beta2: float = 0.96
    eps: float = 1e-6
    weight_decay: float = 0.045
    max_grad_norm: Optional[float] = 4.0
    clamp_value: float = 10000.0
    state_bits: int = 8
    block_size: int = 4096
    min_8bit_size: int = 65536
