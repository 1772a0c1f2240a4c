"""Optimizers of the port (counterpart of ``dalle_tpu/optim``).

:func:`make_optimizer` dispatches on ``OptimizerConfig.state_bits`` as the
JAX package's does: 32 is the fp32 clipped LAMB. 8, the JAX package's
default (the block-quantized 8-bit LAMB and its ``quantize_blockwise``
kernel), is not ported yet and raises; it never falls back to fp32.
"""

from dalle_tpu_torch.config import OptimizerConfig
from dalle_tpu_torch.optim.lamb import (  # noqa: F401
    Lamb,
    apply_updates,
    default_wd_mask,
    make_lr_schedule,
    make_optimizer_fp32,
)


def make_optimizer(cfg: OptimizerConfig) -> Lamb:
    if cfg.state_bits == 8:
        raise NotImplementedError(
            "state_bits=8 (8-bit LAMB with quantize_blockwise) is not "
            "ported yet: ROADMAP.md, slice 2b; use state_bits=32")
    if cfg.state_bits == 32:
        return make_optimizer_fp32(cfg)
    raise ValueError(f"unsupported state_bits={cfg.state_bits}")
