"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics and the device's busy seconds and breakdown. The
last line of standard output is one JSON object; the numbers compared
for ``correct`` and their limits are the last lines of standard error
and the last key of that object. Without the cards, or with a module of
the JAX package loaded at the end, it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / "cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # kernel caches at fixed paths inside the checkout: only a cell's
    # first run there compiles
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))

    from benchmark import harness
    try:
        cell = harness.load_cell(args.workload, ROOT)
        import torch
        if not torch.cuda.is_available():
            raise harness.BenchError("no CUDA device: the benchmark runs "
                                     "on the card only")
        if torch.cuda.device_count() < cell.entry["chips"]:
            raise harness.BenchError(
                f"{cell.name} needs {cell.entry['chips']} cards, "
                f"{torch.cuda.device_count()} visible")
        run = harness.Run(cell, args.seed, args.seconds, bool(args.trace))
        outcome = harness.driver(cell).run(run)
        line = harness.result_line(cell, outcome, run.traced)
        for note in outcome.notes:
            print(f"note {note}", file=sys.stderr)
        bad = harness.forbidden_modules()
        if bad:
            raise harness.BenchError(f"modules of JAX or the JAX package "
                                     f"were loaded: {bad}")
    except harness.BenchError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
