"""Time the port's flagship inference path, as found in a given checkout.

    python3 dalle_tpu_torch/time_inference.py [--tree DIR]

``dalle_tpu_torch`` is imported from ``DIR`` (by default the checkout this
file is in), so that two versions of the port are timed one after the
other on one card by the same harness. Only what every version of the
port has is used: ``entry.entry``, ``models.decode`` and ``ops._build``.

One JSON line is printed: the flagship forward loss at B=4 through
``entry`` (host wall ms of ``REPEATS`` calls after a warm-up call, each
ending in a synchronise), the device's busy ms and idle share over one
call traced with ``torch.profiler`` (busy = the summed device time of the
rows with device time and no host time, as ``chip_smoke.py --profile``
counts it), and the host ms per position of ``POSITIONS`` teacher-forced
cached-decode steps at B=1. Needs a GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
BATCH = 4
REPEATS = 5
POSITIONS = 128


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout whose dalle_tpu_torch is timed")
    args = parser.parse_args()
    tree = Path(args.tree or Path(__file__).resolve().parents[1]).resolve()
    # the script's own directory goes: the package comes from the tree
    sys.path[0] = str(tree)

    import torch
    if not torch.cuda.is_available():
        print("time_inference: no GPU", file=sys.stderr)
        return 2
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import dalle_tpu_torch
    from dalle_tpu_torch.entry import entry
    from dalle_tpu_torch.models.decode import (decode_step, decode_tables,
                                               init_cache)
    from dalle_tpu_torch.ops import _build
    if Path(dalle_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"dalle_tpu_torch imported from "
                           f"{dalle_tpu_torch.__file__}, not from {tree}")
    t_start = time.perf_counter()
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    fn, (model, _, _) = entry(device="cuda", batch=BATCH, seed=SEED)
    cfg = model.cfg
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    text = torch.from_numpy(rng.integers(
        1, cfg.vocab_text, (BATCH, cfg.text_seq_len))).to(dev)
    image = torch.from_numpy(rng.integers(
        0, cfg.vocab_image, (BATCH, cfg.image_seq_len))).to(dev)
    loss = float(fn(model, text, image))
    torch.cuda.synchronize()
    wall = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn(model, text, image)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    for _ in range(2):          # the first traced call warms the tracer
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(model, text, image)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.cpu_time_total == 0) / 1e3

    with torch.inference_mode():
        labels = torch.cat([text[:1], image[:1] + cfg.vocab_text], 1)
        inputs = torch.cat([torch.full((1, 1), cfg.vocab_total, device=dev,
                                       dtype=labels.dtype), labels[:, :-1]],
                           1)
        cache = init_cache(cfg, 1, dev)
        tables = decode_tables(cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(POSITIONS):
            _, cache = decode_step(model, cache, inputs[:, p], p, tables)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0

    print(json.dumps(dict(
        tree=str(tree), card=smi, loss=loss, forward_ms=wall,
        traced_ms=traced_ms, device_busy_ms=busy,
        device_idle_share=1.0 - busy / traced_ms,
        decode_positions=POSITIONS,
        decode_ms_per_position=decode_s * 1e3 / POSITIONS,
        seconds=time.perf_counter() - t_start)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
