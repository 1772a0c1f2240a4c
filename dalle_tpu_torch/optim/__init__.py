"""Optimizers of the port (counterpart of ``dalle_tpu/optim``).

:func:`make_optimizer` dispatches on ``OptimizerConfig.state_bits`` as the
JAX package's does: 8 (the default) is the 8-bit LAMB with block-quantized
moments (``lamb8bit.py``, the ``quantize_blockwise`` kernel), 32 the fp32
clipped LAMB (``lamb.py``).
"""

from typing import Union

from dalle_tpu_torch.config import OptimizerConfig
from dalle_tpu_torch.optim.lamb import (  # noqa: F401
    Lamb,
    apply_updates,
    default_wd_mask,
    make_lr_schedule,
    make_optimizer_fp32,
)
from dalle_tpu_torch.optim.lamb8bit import (  # noqa: F401
    Lamb8bit,
    make_optimizer_8bit,
    optimizer_state_bytes,
)


def make_optimizer(cfg: OptimizerConfig) -> Union[Lamb, Lamb8bit]:
    if cfg.state_bits == 8:
        return make_optimizer_8bit(cfg)
    if cfg.state_bits == 32:
        return make_optimizer_fp32(cfg)
    raise ValueError(f"unsupported state_bits={cfg.state_bits}")
