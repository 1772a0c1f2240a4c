"""Time the port's GEGLU kernels at the flagship shapes, as found in a given
checkout.

    python3 dalle_tpu_torch/time_geglu.py [--tree DIR] [--label NAME]

``dalle_tpu_torch`` is imported from ``DIR`` (by default the checkout this
file is in), so that two versions of the kernels are timed one after the
other on one card by the same harness (for example parent, change, change,
parent in one run). Only what every version of the port has is used:
the two wrappers ``geglu_ff`` and ``geglu_ff_bwd`` of ``ops.geglu`` and
``ops._build``.

One JSON line is printed: the device time (us, CUDA-graph replay of
``ITERS`` calls cycling through ``SETS`` input sets, more than the 50 MB L2
together, as ``chip_smoke.py`` times kernels) of the forward (both kernels)
and of the backward tensors at M = 4 x 1280 tokens, d = 1024, K = 4096, and
the card's name and power limit. Needs a GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
BATCH = 4
SETS = 2
ITERS = 20


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
        print("time_geglu: no GPU", file=sys.stderr)
        return 2

    import dalle_tpu_torch
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import flagship_model_config
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops.geglu import geglu_ff, geglu_ff_bwd
    if Path(dalle_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"dalle_tpu_torch imported from "
                           f"{dalle_tpu_torch.__file__}, not from {tree}")
    _build.build_all(["geglu_fwd", "geglu_bwd"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    dev = resolve_device("cuda")
    cfg = flagship_model_config()
    m, d = BATCH * cfg.total_seq_len, cfg.dim
    k = cfg.ff_mult * d
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def device_us(fn, arg_sets):
        def run():
            for i in range(ITERS):
                fn(*arg_sets[i % len(arg_sets)])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / ITERS

    # x, Wi, Wg, Wo, bi, bg, bo, dO: 45 MB a set
    sets = [(randn(m, d), randn(d, k, scale=d ** -0.5),
             randn(d, k, scale=d ** -0.5), randn(k, d, scale=k ** -0.5),
             randn(k, scale=0.1), randn(k, scale=0.1), randn(d, scale=0.1),
             randn(m, d)) for _ in range(SETS)]
    out = {"tree": args.label or str(tree), "card": smi,
           "shape": f"M={m} d={d} K={k}"}
    out["geglu_fwd_us"] = device_us(
        lambda x, wi, wg, wo, bi, bg, bo, do: geglu_ff(x, wi, wg, wo, bi, bg,
                                                       bo), sets)
    out["geglu_bwd_us"] = device_us(
        lambda x, wi, wg, wo, bi, bg, bo, do: geglu_ff_bwd(x, wi, wg, wo, bi,
                                                           bg, do), sets)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
