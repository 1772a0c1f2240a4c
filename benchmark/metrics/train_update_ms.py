"""Host ms of one optimizer update (``apply_step``: the clip, the 8-bit
LAMB and the parameter writes), synchronised before and after, averaged
over the traced run's window steps. Moves ``train_img_s``."""


def read(record):
    ms = record.get("update_ms") or []
    return sum(ms) / len(ms) if ms else None
