"""Time the port's attention kernels at the flagship shapes, as found in a
given checkout.

    python3 dalle_tpu_torch/time_attention.py [--tree DIR] [--label NAME]

``dalle_tpu_torch`` is imported from ``DIR`` (by default the checkout this
file is in), so that two versions of the kernels are timed one after the
other on one card by the same harness (for example parent, change, change,
parent in one session). Only what every version of the port has is used:
the four wrappers of ``ops.attention`` and ``ops._build``.

One JSON line is printed: the device time (us, CUDA-graph replay of
``ITERS`` calls cycling through ``SETS`` input sets, more than the 50 MB L2
together, as ``chip_smoke.py`` times kernels) of one axial layer's forward
(the text call and the image call with its 256-token prefix) for
axial_row and axial_col, the conv_like window forward, and the same three
backwards, at B=4, 16 heads of 64, text 256 + a 32x32 grid; q, k, v and dO
are strided (B, T, H, d) views, as the model makes them. Needs a GPU; exits
2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
BATCH = 4
SETS = 3
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
        print("time_attention: no GPU", file=sys.stderr)
        return 2

    import dalle_tpu_torch
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import flagship_model_config
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops.attention import (line_attention,
                                               line_attention_bwd,
                                               window_attention,
                                               window_attention_bwd)
    if Path(dalle_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"dalle_tpu_torch imported from "
                           f"{dalle_tpu_torch.__file__}, not from {tree}")
    _build.build_all(["attention_fwd", "attention_bwd"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    dev = resolve_device("cuda")
    cfg = flagship_model_config()
    h, dh, tt, g = cfg.heads, cfg.head_dim, cfg.text_seq_len, cfg.image_grid
    hw = cfg.conv_kernel // 2
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def view():
        return torch.randn((BATCH, tt + g * g, h, dh), generator=gen,
                           device=dev).to(torch.bfloat16).transpose(1, 2)

    def split(x):
        return x[:, :, :tt], x[:, :, tt:]

    def line_fwd(q, k, v, col):
        (qt, qi), (kt, ki), (vt, vi) = split(q), split(k), split(v)
        return (line_attention(qt, kt, vt, None, None, tt, 0, False),
                line_attention(qi, ki, vi, kt, vt, g, g, col))

    def line_bwd(q, k, v, do, fo, col):
        (qt, qi), (kt, ki), (vt, vi) = split(q), split(k), split(v)
        (ot, lt), (oi, li) = fo
        line_attention_bwd(qt, kt, vt, None, None, ot, lt, do[:, :, :tt],
                           tt, 0, False)
        line_attention_bwd(qi, ki, vi, kt, vt, oi, li, do[:, :, tt:], g, g,
                           col)

    def win_fwd(q, k, v):
        (_, qi), (kt, ki), (vt, vi) = split(q), split(k), split(v)
        return window_attention(qi, ki, vi, kt, vt, g, hw)

    def win_bwd(q, k, v, do, fo):
        (_, qi), (kt, ki), (vt, vi) = split(q), split(k), split(v)
        window_attention_bwd(qi, ki, vi, kt, vt, *fo, do[:, :, tt:], g, hw)

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

    sets = [tuple(view() for _ in range(4)) for _ in range(SETS)]
    out = {"tree": args.label or str(tree), "card": smi}
    for col in (False, True):
        name = "axial_col" if col else "axial_row"
        out[f"line_fwd_{name}_us"] = device_us(
            lambda q, k, v, do: line_fwd(q, k, v, col), sets)
        bsets = [(q, k, v, do, line_fwd(q, k, v, col))
                 for q, k, v, do in sets]
        out[f"line_bwd_{name}_us"] = device_us(
            lambda *a: line_bwd(*a, col), bsets)
    out["window_fwd_us"] = device_us(
        lambda q, k, v, do: win_fwd(q, k, v), sets)
    out["window_bwd_us"] = device_us(
        win_bwd, [(q, k, v, do, win_fwd(q, k, v)) for q, k, v, do in sets])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
