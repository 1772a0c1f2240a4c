"""Entry point of the port: the flagship forward loss (counterpart of
``__graft_entry__.entry``)."""

from __future__ import annotations

import torch

from dalle_tpu_torch import resolve_device
from dalle_tpu_torch.config import flagship_model_config
from dalle_tpu_torch.models.dalle import init_params


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
