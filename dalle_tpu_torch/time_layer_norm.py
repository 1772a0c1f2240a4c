"""Time the port's LayerNorm backward at the flagship shape, as found in a
given checkout.

    python3 dalle_tpu_torch/time_layer_norm.py [--tree DIR] [--label NAME]

``dalle_tpu_torch`` is imported from ``DIR`` (by default the checkout this
file is in), so that two versions of the kernel are timed one after the
other on one card by the same harness (for example parent, change, change,
parent in one run). Only what every version of the port has is used: the
wrapper ``layer_norm_bwd`` of ``ops.layer_norm`` and ``ops._build``.

One JSON line is printed: the device time (us, CUDA-graph replay of
``ITERS`` calls cycling through ``SETS`` input sets, more than the 50 MB L2
together, as ``chip_smoke.py`` times kernels) and the eager time (launched
from Python, CUDA events) of one backward at M = 4 x 1280 rows of d = 1024
bf16 with a bf16 scale (the hoisted cast), beside the least time the card
could take (x, dy and the scale read once, dx and the two f32 sums
written once, at 3.35 TB/s), and the card's name and power limit. Needs a
GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
BATCH = 4
SETS = 4
ITERS = 40
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout whose dalle_tpu_torch is timed")
    parser.add_argument("--label", default=None,
                        help="a name for the tree in the printed line")
    args = parser.parse_args()
    tree = Path(args.tree or Path(__file__).resolve().parents[1]).resolve()
    # the script's own directory goes: the package comes from the tree
    sys.path[0] = str(tree)

    import torch
    if not torch.cuda.is_available():
        print("time_layer_norm: no GPU", file=sys.stderr)
        return 2

    import dalle_tpu_torch
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import flagship_model_config
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops.layer_norm import layer_norm_bwd
    if Path(dalle_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"dalle_tpu_torch imported from "
                           f"{dalle_tpu_torch.__file__}, not from {tree}")
    # a tree whose backward is CUDA builds it; one in Triton has no source
    _build.build_all([n for n in _build.sources()
                      if n.startswith("layer_norm")])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    dev = resolve_device("cuda")
    cfg = flagship_model_config()
    m, d = BATCH * cfg.total_seq_len, cfg.dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def run_all(arg_sets):
        for i in range(ITERS):
            layer_norm_bwd(*arg_sets[i % len(arg_sets)])

    def events_us(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / ITERS

    # x, scale, dy: 21 MB a set
    sets = [(randn(m, d, scale=2.0), randn(d, scale=0.2) + 1, randn(m, d))
            for _ in range(SETS)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_all(sets)
    torch.cuda.current_stream().wait_stream(side)
    eager = events_us(lambda: run_all(sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run_all(sets)
    graph.replay()
    device = events_us(graph.replay)
    print(json.dumps({
        "tree": args.label or str(tree), "card": smi,
        "shape": f"x, dy ({m}, {d}) bf16, scale ({d},) bf16",
        "layer_norm_bwd_us": device, "layer_norm_bwd_eager_us": eager,
        "bound_us": (3 * m * d * 2 + d * 2 + 2 * d * 4) / HBM_BYTES_PER_S
        * 1e6}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
