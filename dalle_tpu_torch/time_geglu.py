"""Time the port's GEGLU kernels at the flagship shapes, as found in a given
checkout.

    python3 dalle_tpu_torch/time_geglu.py [--tree DIR] [--label NAME]
        [--route fast|generic] [--dtype bfloat16|float32]

``dalle_tpu_torch`` is imported from ``DIR`` (by default the checkout this
file is in), so that two versions of the kernels are timed one after the
other on one card by the same harness (for example parent, change, change,
parent in one run). Only what every version of the port since the
generic route has is used: the two wrappers ``geglu_ff`` and
``geglu_ff_bwd``, ``_lib`` and ``GENERIC_DTYPES`` of ``ops.geglu``, and
``ops._build``.

One JSON line is printed: the device time (us, CUDA-graph replay of
``ITERS`` calls cycling through ``SETS`` input sets, more than the 50 MB L2
together, as ``chip_smoke.py`` times kernels) of the forward (both kernels)
and of the backward tensors at M = 4 x 1280 tokens, d = 1024, K = 4096, and
the card's name and power limit. Needs a GPU; exits 2 without one.

``--route generic`` times the generic instances (``csrc/geglu_generic.cu``)
instead, in ``--dtype``, through their C entry points (which every version
has; the wrappers would send bf16 at the flagship's widths to the fast
kernels): at the flagship's widths and at d = 1000, K = 4000 (widths only
the generic route takes), each beside cuBLAS's two products alone on the
same inputs (``x.[Wi|Wg]`` and ``hg.Wo`` for the forward, ``x.[Wi|Wg]``
and ``dO.Wo^T`` for the backward; TF32 off).
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


def generic_entry(geglu_mod, m: int, d: int, k: int, dtype, device):
    """``(fwd, bwd)``: the generic instances' C entry points
    (``geglu_generic_fwd``, ``geglu_generic_bwd``) called directly for
    operands of ``dtype`` with M = ``m``, d = ``d``, K = ``k`` on
    ``device``, whatever route the wrappers would take.
    ``fwd(x, wi, wg, wo, bi, bg, bo)`` returns ``out``;
    ``bwd(x, wi, wg, wo, bi, bg, dout)`` returns ``(dhdg, hg)``. They count
    no launch. ``geglu_mod`` is the ``ops.geglu`` module of the tree
    timed."""
    import torch
    lib = geglu_mod._lib("geglu_generic")
    code = geglu_mod.GENERIC_DTYPES[dtype]

    def call(fn, tensors):
        err = fn(*[t.data_ptr() for t in tensors], m, d, k, code,
                 torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"geglu_generic: launch failed ({err})")

    def fwd(x, wi, wg, wo, bi, bg, bo):
        hg = torch.empty((m, k), dtype=dtype, device=device)
        out = torch.empty((m, d), dtype=dtype, device=device)
        call(lib.geglu_generic_fwd, (x, wi, wg, wo, bi, bg, bo, hg, out))
        return out

    def bwd(x, wi, wg, wo, bi, bg, dout):
        dhdg = torch.empty((m, 2 * k), dtype=dtype, device=device)
        hg = torch.empty((m, k), dtype=dtype, device=device)
        call(lib.geglu_generic_bwd, (x, wi, wg, wo, bi, bg, dout, dhdg, hg))
        return dhdg, hg

    return fwd, bwd


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout whose dalle_tpu_torch is timed")
    parser.add_argument("--label", default=None,
                        help="a name for the tree in the printed line")
    parser.add_argument("--route", choices=("fast", "generic"),
                        default="fast")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16",
                        help="operand dtype of --route generic")
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
    from dalle_tpu_torch.ops import geglu as geglu_mod
    from dalle_tpu_torch.ops.geglu import geglu_ff, geglu_ff_bwd
    if Path(dalle_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"dalle_tpu_torch imported from "
                           f"{dalle_tpu_torch.__file__}, not from {tree}")
    _build.build_all(["geglu_fwd", "geglu_bwd"] if args.route == "fast"
                     else ["geglu_generic"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    dev = resolve_device("cuda")
    cfg = flagship_model_config()
    m, d = BATCH * cfg.total_seq_len, cfg.dim
    k = cfg.ff_mult * d
    gen = torch.Generator(device=dev).manual_seed(SEED)

    dtype = getattr(torch, args.dtype) if args.route == "generic" \
        else torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

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

    def operand_sets(d, k):
        # x, Wi, Wg, Wo, bi, bg, bo, dO: 45 MB a set in bf16
        return [(randn(m, d), randn(d, k, scale=d ** -0.5),
                 randn(d, k, scale=d ** -0.5), randn(k, d, scale=k ** -0.5),
                 randn(k, scale=0.1), randn(k, scale=0.1),
                 randn(d, scale=0.1), randn(m, d)) for _ in range(SETS)]

    out = {"tree": args.label or str(tree), "card": smi,
           "route": args.route, "dtype": args.dtype}
    if args.route == "fast":
        sets = operand_sets(d, k)
        out["shape"] = f"M={m} d={d} K={k}"
        out["geglu_fwd_us"] = device_us(
            lambda x, wi, wg, wo, bi, bg, bo, do: geglu_ff(x, wi, wg, wo, bi,
                                                           bg, bo), sets)
        out["geglu_bwd_us"] = device_us(
            lambda x, wi, wg, wo, bi, bg, bo, do: geglu_ff_bwd(
                x, wi, wg, wo, bi, bg, do), sets)
        print(json.dumps(out), flush=True)
        return 0

    for d_, k_ in ((d, k), (1000, 4000)):
        sets = operand_sets(d_, k_)
        gfwd, gbwd = generic_entry(geglu_mod, m, d_, k_, dtype, dev)

        def fwd(x, wi, wg, wo, bi, bg, bo, do):
            gfwd(x, wi, wg, wo, bi, bg, bo)

        def bwd(x, wi, wg, wo, bi, bg, bo, do):
            gbwd(x, wi, wg, wo, bi, bg, do)

        hg = torch.empty((m, k_), dtype=dtype, device=dev)
        cat = [torch.cat([st[1], st[2]], dim=1) for st in sets]
        tag = f"d{d_}_k{k_}"
        out[f"shape_{tag}"] = f"M={m} d={d_} K={k_} {args.dtype}"
        out[f"generic_fwd_us_{tag}"] = device_us(fwd, sets)
        out[f"generic_bwd_us_{tag}"] = device_us(bwd, sets)
        out[f"cublas_fwd_us_{tag}"] = device_us(
            lambda x, w, wo: (torch.matmul(x, w), torch.matmul(hg, wo)),
            [(st[0], w, st[3]) for st, w in zip(sets, cat)])
        out[f"cublas_bwd_us_{tag}"] = device_us(
            lambda x, w, do, wo: (torch.matmul(x, w),
                                  torch.matmul(do, wo.t())),
            [(st[0], w, st[7], st[3]) for st, w in zip(sets, cat)])
        del sets, cat, hg
    out["tf32"] = torch.backends.cuda.matmul.allow_tf32
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
