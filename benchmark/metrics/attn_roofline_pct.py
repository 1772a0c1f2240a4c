"""Attention's share of its roofline inside the training step: the least
time of the attention work the cell's shapes and masks need
(``work.attention_step_least_ms``, forward and backward, each call's
bytes at 3.35 TB/s or operations at 989 TFLOP/s, whichever is larger)
over the device time of every kernel the trace shows doing attention,
whoever wrote it, per traced step. Moves ``train_img_s``."""

from benchmark import work

# the port's fused and generic kernels, and the library's flash,
# memory-efficient and cuDNN attention
MARKS = ("attn_", "flash", "fmha", "efficient_attention", "sdpa", "mha_",
         "attention")


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    spent = sum(s for name, s in trace.device_ops.items()
                if any(mark in name.lower() for mark in MARKS))
    if spent <= 0:
        return None
    least_s = work.attention_step_least_ms(record["model"],
                                           record["rows"]) / 1e3
    return 100.0 * least_s * trace.units / spent
