"""The whole decode step's share of the chip's peak: the least time of
each decode position the engine ran in the window
(``work.decode_step_least_s``: the weights of every layer application
and the tied head read once, each live slot's mask-allowed keys and
values read once, or the operations at 989 TFLOP/s, whichever is
larger), summed over the window's chunks, over the window's seconds.
Moves ``serve_img_s``."""

from benchmark import work


def read(record):
    chunks = record.get("chunks")
    if not chunks:
        return None
    least = sum(work.decode_step_least_s(record["model"], live)
                for _, live in chunks) * record["steps_per_call"]
    return 100.0 * least / record["window_s"]
