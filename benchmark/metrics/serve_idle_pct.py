"""Share of the traced serving stretch's wall time in which no device
operation ran. Moves ``serve_img_s``."""


def read(record):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
