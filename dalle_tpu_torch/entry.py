"""Entry points of the port: the flagship forward loss (counterpart of
``__graft_entry__.entry``) and one flagship training step (the regime of
``bench.py``: micro-batches accumulated, then one LAMB update)."""

from __future__ import annotations

import torch

from dalle_tpu_torch import resolve_device
from dalle_tpu_torch.config import OptimizerConfig, flagship_model_config
from dalle_tpu_torch.data.synthetic import SyntheticCodes
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.training.steps import TrainState, train_step


def entry(device="cuda", batch: int = 1, seed: int = 0):
    """``(fn, args)``: ``fn(*args)`` is the flagship model's forward loss
    on ``batch`` all-zero captions and code grids, with bf16 parameters
    drawn from ``seed``. Runs on the GPU unless ``device="cpu"`` is asked
    for; raises when the GPU is asked for and absent."""
    dev = resolve_device(device)
    cfg = flagship_model_config(param_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    model.eval()
    text = torch.zeros((batch, cfg.text_seq_len), dtype=torch.long,
                       device=dev)
    image = torch.zeros((batch, cfg.image_seq_len), dtype=torch.long,
                        device=dev)

    def forward(model, text, image):
        with torch.inference_mode():
            loss, _ = model(text, image)
        return loss

    return forward, (model, text, image)


def train_entry(device="cuda", micro: int = 4, accum: int = 2,
                seed: int = 0, state_bits: int = 8, **model_overrides):
    """``(fn, args)``: ``fn(*args)`` is one flagship training step, ``(state,
    metrics)``, over ``accum`` micro-batches of ``micro`` samples followed
    by one LAMB update. The model: the flagship with
    ``FLAGSHIP_TUNED`` (fused LayerNorm, ``save_attn`` remat of all blocks
    but ``block_3``, hoisted bf16 parameter casts), f32 parameters drawn
    from ``seed``, bf16 activations; ``model_overrides`` change it (for
    example a smaller ``depth``, or ``dtype="float32"``). The batch: the
    first of ``SyntheticCodes(cfg, micro * accum, seed)``. The optimizer:
    ``OptimizerConfig(state_bits=state_bits, warmup_steps=2,
    total_steps=100)``, the 8-bit LAMB by default (the JAX package's and
    ``bench.py``'s), the fp32 LAMB with ``state_bits=32``; the learning rate
    leaves 0 at the second step. Runs on the GPU unless ``device="cpu"`` is
    asked for."""
    dev = resolve_device(device)
    cfg = flagship_model_config(**{"param_dtype": "float32",
                                   "dtype": "bfloat16", **model_overrides})
    tx = make_optimizer(OptimizerConfig(state_bits=state_bits,
                                        warmup_steps=2, total_steps=100))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    model.train()
    state = TrainState.create(model, tx)
    n = micro * accum
    data = next(SyntheticCodes(cfg, num_samples=n, seed=seed).batches(n))
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in data.items()}

    def step(state, batch):
        return train_step(state, batch, tx, accum_steps=accum)

    return step, (state, batch)
