"""The whole training step's share of the chip's bf16 peak: the model's
operations per image (``work.train_flops_per_image``: matmuls, attention
over the pairs each mask allows, the tied head; forward and backward,
no recomputation) times the images of the traced run's window, over the
window's seconds and 989 TFLOP/s. Moves ``train_img_s``."""

from benchmark import work


def read(record):
    if not record.get("steps"):
        return None
    flops = (work.train_flops_per_image(record["model"]) * record["rows"]
             * record["steps"])
    return 100.0 * flops / record["window_s"] / work.BF16_FLOP_PER_S
