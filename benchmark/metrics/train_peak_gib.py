"""Peak device memory allocated over the window's training steps
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), GiB. Moves ``train_img_s``: memory is what lets a card hold the
micro-batch."""


def read(record):
    peak = record.get("peak_window_bytes")
    return peak / 2 ** 30 if peak else None
