"""Readings that set the limits of ``correct``; not run by the benchmark's
own runs.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

On the card, at the cell's own size. A training cell: for each seed, the
float32 reference over the first steps of the cell's traffic, and against
it the program (the set-up steps of a run, through the window's own
call), the control (the reference in float8 e4m3 put in the program's
place) and the fault of a step that leaves out half of each micro-batch
(planted in the reference). A serving cell: for each seed, the cell's run with a
window of ``--seconds`` (long enough to finish the first requests), and
on its served greedy sequences the program's widest gap, the control's
(at each position, the code that the float8 reference puts first) and
that of a code altered where it is produced. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=40.0)
    parser.add_argument("--kinds", default="program,control,half_batch",
                        help="training readings to take: the program's "
                        "set-up steps, the control, the half-batch fault")
    args = parser.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path[0] = str(ROOT)
    import os
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / "cache"
                                         / "triton")
    import numpy as np
    import torch

    from benchmark import harness
    cell = harness.load_cell(args.workload, ROOT)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.driver == "train":
            from benchmark.traffic import train
            tr, m = cell.traffic, cell.model
            n = cell.limits["ref_steps"]
            kinds = args.kinds.split(",")
            prog = None
            if "program" in kinds:
                s = train.start(cell, seed, dev)
                prog, batches = s["prog"], s["kept"]
                del s
                train.free(dev)
            else:
                feed = train.Feed(m, tr, seed, dev, tr["micro"] * tr["accum"])
                batches = [feed.next() for _ in range(n)]
            common = (m, seed, batches, tr["accum"], n,
                      cell.limits["ref_rows"], train.opt_cfg_of(tr), dev)
            want = train.follow(*common)
            plants = {"control": {"prec": "fp8"}, "half_batch": {"half": True}}
            for kind in kinds:
                got = prog if kind == "program" else train.follow(
                    *common, **plants[kind])
                print(json.dumps({"cell": cell.name, "seed": seed,
                                  "kind": kind, "readings": train.readings(
                                      got, want, n)}), flush=True)
        else:
            from benchmark.traffic import serve
            run = harness.Run(cell, seed, args.seconds, False, device=dev)
            out = serve.run(run)
            captured = out.record["checked"]
            m = cell.model
            rng = np.random.default_rng(seed)
            altered = []
            for row in captured:
                codes = np.array(row["codes"])
                j = int(rng.integers(len(codes)))
                codes[j] = (codes[j] + 1) % m["vocab_image"]
                altered.append(dict(row, codes=codes))
            readings = {
                "program": out.checks["logit_gap"][0],
                "control": serve.served_gap(m, seed, captured, dev,
                                            torch.bfloat16, "fp8")
                if captured else None,
                "altered": serve.served_gap(m, seed, altered, dev)
                if altered else None,
                "sequences": len(captured),
                "serve_img_s": out.e2e["serve_img_s"],
            }
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "kind": "serve", "readings": readings}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
