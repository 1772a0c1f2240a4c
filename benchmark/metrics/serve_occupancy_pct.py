"""Mean share of the engine's slots that were live at the window's chunk
boundaries (the engine's ``record_step``). Moves ``serve_img_s``."""


def read(record):
    chunks = record.get("chunks")
    if not chunks:
        return None
    return 100.0 * sum(live for _, live in chunks) / (
        len(chunks) * record["n_slots"])
