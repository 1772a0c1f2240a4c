"""Time the port's ``quantize_blockwise`` kernel at the sizes the flagship's
8-bit LAMB quantizes, as found in a given checkout.

    python3 dalle_tpu_torch/time_quant.py [--tree DIR] [--label NAME]
                                          [--trace PATH]

``dalle_tpu_torch`` is imported from ``DIR`` (by default the checkout this
file is in), so that two versions of the kernel are timed one after the
other on one card by the same harness (for example parent, change, change,
parent in one run). Only what every version of the port has is used: the
wrapper ``quantize_blockwise`` of ``ops.quant`` and ``ops._build``.

One JSON line is printed: for each size of ``MOMENTS`` (the flagship's 37
tensors of at least ``min_8bit_size`` elements, 1 to 20 of each size), the
device time (us, CUDA-graph replay of at least ``ITERS`` calls cycling
through input sets that together exceed the 50 MB L2) of one call with the
signed codebook (the first moment) and one with the unsigned one (the
second), each beside the least time the card could take
(:func:`quantize_bytes` at 3.35 TB/s);
then the sum over one 8-bit step's 74 launches (a signed and an unsigned
call per tensor) beside its bound, and the card's name and power limit.

With ``--trace PATH``, one 8-bit ``Lamb8bit.update`` of the flagship's
parameters (random gradients) is also traced with ``torch.profiler`` and its
device time split by kernel class (this quantize kernel, the dequantize
gathers, elementwise ops, reductions); the table goes to PATH and the split
into a second JSON line. Needs a GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
BLOCK = 4096
ITERS = 20
L2_BYTES = 80_000_000      # input sets a size cycles through exceed this
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# elements -> tensors of that size among the flagship's quantized moments
MOMENTS = {262_144: 1, 1_048_576: 20, 4_194_304: 15, 41_287_680: 1}
TRACE_CLASSES = (
    ("quantize_blockwise", "quantize_blockwise kernel"),
    ("index", "dequantize: codebook gathers (index kernels)"),
    ("gather", "dequantize: codebook gathers (index kernels)"),
    ("reduce", "reductions (norms, absmax of the plain parts)"),
)


def quantize_bytes(n: int, block: int = BLOCK) -> int:
    """The bytes one ``quantize_blockwise`` call must move, whatever its
    design: the n f32 read, the (n_blocks, block) u8 codes and n_blocks f32
    absmax written, and the 255 f32 codebook midpoints read, each once.
    ``chip_smoke.py`` takes its bound from here too."""
    blocks = -(-n // block)
    return 4 * n + blocks * block + 4 * blocks + 255 * 4


def bound_us(n: int) -> float:
    return quantize_bytes(n) / HBM_BYTES_PER_S * 1e6


def trace_update(torch, path: str) -> dict:
    """Device time of one flagship 8-bit LAMB update by kernel class (the
    second of two traced updates: the first warms the tracer)."""
    from torch.profiler import ProfilerActivity, profile

    from dalle_tpu_torch.config import OptimizerConfig, flagship_model_config
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.optim import make_optimizer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = init_params(flagship_model_config(param_dtype="float32"), gen)
    tx = make_optimizer(OptimizerConfig(state_bits=8, warmup_steps=2,
                                        total_steps=100))
    state = tx.init(model)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for n, p in model.named_parameters()}
    _, state = tx.update(grads, state, model)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tx.update(grads, state, model)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    classes = {}
    for e in events:
        if e.self_device_time_total <= 0 or e.cpu_time_total != 0:
            continue
        cls = next((c for mark, c in TRACE_CLASSES if mark in e.key),
                   "elementwise ops and copies")
        ms, count = classes.get(cls, (0.0, 0))
        # profiler microseconds to ms for a report; no quantized value
        # passes through this division
        # graftlint: disable=literal-divisor-in-quant
        classes[cls] = (ms + e.self_device_time_total / 1e3, count + e.count)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(events.table(sort_by="self_device_time_total",
                                       row_limit=60))
    busy = sum(ms for ms, _ in classes.values())
    return {"update_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "classes": {c: {"ms": ms, "kernels": count}
                        for c, (ms, count) in sorted(
                            classes.items(), key=lambda kv: -kv[1][0])}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout whose dalle_tpu_torch is timed")
    parser.add_argument("--label", default=None,
                        help="a name for the tree in the printed line")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="also trace one flagship 8-bit LAMB update")
    args = parser.parse_args()
    tree = Path(args.tree or Path(__file__).resolve().parents[1]).resolve()
    # the script's own directory goes: the package comes from the tree
    sys.path[0] = str(tree)

    import torch
    if not torch.cuda.is_available():
        print("time_quant: no GPU", file=sys.stderr)
        return 2

    import dalle_tpu_torch
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops.quant import quantize_blockwise
    if Path(dalle_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"dalle_tpu_torch imported from "
                           f"{dalle_tpu_torch.__file__}, not from {tree}")
    _build.build_all(["quant"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def events_us(fn, iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / iters

    def device_us(sets, signed):
        iters = max(ITERS, len(sets))

        def run_all():
            for i in range(iters):
                quantize_blockwise(sets[i % len(sets)], BLOCK, signed=signed)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run_all()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run_all()
        graph.replay()
        us = events_us(graph.replay, iters)
        del graph
        return us

    sizes, step_us, step_bound = [], 0.0, 0.0
    for n, count in MOMENTS.items():
        rec = {"n": n, "tensors": count, "bound_us": bound_us(n)}
        n_sets = max(2, -(-L2_BYTES // (5 * n)))
        for signed, tag in ((True, "signed"), (False, "unsigned")):
            sets = []
            for _ in range(n_sets):
                x = torch.randn(n, generator=gen, device=dev) * 1e-3
                sets.append(x if signed else x * x)
            rec[f"{tag}_us"] = device_us(sets, signed)
            del sets
        step_us += count * (rec["signed_us"] + rec["unsigned_us"])
        step_bound += count * 2 * rec["bound_us"]
        sizes.append(rec)
    print(json.dumps({
        "tree": args.label or str(tree), "card": smi, "block": BLOCK,
        "sizes": sizes, "step_launches": 2 * sum(MOMENTS.values()),
        "step_us": step_us, "step_bound_us": step_bound}), flush=True)
    if args.trace:
        print(json.dumps({"tree": args.label or str(tree), "card": smi,
                          "lamb8bit_update": trace_update(torch, args.trace)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
