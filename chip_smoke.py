#!/usr/bin/env python3
"""Drive the PyTorch port's flagship inference and training paths, the
8-bit LAMB, a swarm round's device codec and the generic kernel route on
one NVIDIA GPU.

    python3 chip_smoke.py [--out RECORDS.json] [--profile TABLE.txt]

Phases, each printed as one JSON line; any failure ends the run with a
nonzero exit and no ``ok`` line (there is no CPU fallback):

1. the card (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``dalle_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together; the Triton LayerNorm forward compiles at first call);
2. each of the four forward kernels against its plain PyTorch version on
   the card, at the flagship shapes in bf16, with kernel, plain and library
   times (CUDA events, inputs rotated through more than the 50 MB L2) and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the bf16 tensor-core peak of 989 TFLOP/s, whichever is larger);
   the attention records also carry their time over SDPA's
   (``ms_vs_library``), the GEGLU records cuBLAS's time for the same
   products without the epilogues (``cublas_ms``, ``ms_vs_cublas``), and
   both each kernel instance's registers, shared memory and spills
   (``resources``: the runtime's attributes and ``ptxas``); the GEGLU
   forward runs twice on the same inputs (bitwise-equal outputs);
3. the flagship forward loss at B=4 through ``dalle_tpu_torch.entry`` with
   seeded random weights, with every kernel's launch count from that run
   (129 LayerNorm / 127 line / 1 window / 15 GEGLU) and its peak memory;
   every flagship phase (2-9) must run no generic-route kernel
   (``ops.GENERIC_LAUNCHES`` stays 0);
4. teacher-forced cached decode of one sequence against the forward's
   logits on the card;
5. ``generate_images`` for 2 captions x 2 images (temperature 1, top-k 64);
6. each of the four backward kernels against its plain backward on the
   card at the flagship shapes, run twice (bitwise-equal outputs), with
   the same times, bound and library yardstick (autograd of the PyTorch
   call, timed eagerly); the attention backwards also split one call's
   device time by pass from one ``torch.profiler`` trace (``ms_dq_pass``,
   ``ms_dkdv_pass``, ``ms_dkdv_prefix_pass``), and one trace splits the
   GEGLU forward between its gate and output GEMMs (``geglu_ff_split``);
7. six flagship training steps through ``dalle_tpu_torch.entry.train_entry``
   (micro-batch 4, accumulation 2, fp32 LAMB, one fixed batch): finite and
   falling loss, the exact launch counts of the eight wrappers (forward,
   remat replay, backward), step time, img/s and peak memory;
8. the three quantizer kernels against their plain versions on the card,
   codes and scales identical: ``quantize_blockwise`` on every float32 in
   [-1, 1] (blocks led by a 1.0, so that the codebook lookup sees each bit
   pattern itself) under both codebooks, on a tensor the size of
   ``token_emb`` (signed and unsigned, twice: identical bytes), at block
   sizes 1 to 65536, and timed at each size the 8-bit LAMB quantizes with
   the sum over one step's launches beside its bound; the wire u8 and u4
   kernels on one quarter of the flat gradient (a 4-peer round's part);
   ragged sizes;
   then six flagship training steps with the 8-bit LAMB (same weights and
   batch as phase 7): steps 1-2 equal phase 7's, the loss falls and stays
   within ``LOSS_GAP`` of phase 7's, exact launch counts (two
   ``quantize_blockwise`` per quantized tensor per step and at init), and
   peak memory below phase 7's;
9. one swarm round's device codec on the gradients of one 8-bit
   ``grad_step``: the flat vector in 4 parts, each encoded u8 and u4 by
   ``encode_part``; every wire chunk byte-identical to the host codec's,
   the device decodes, the fused accumulation of three senders and one
   error-feedback round bitwise equal to the host arithmetic;
10. the generic route (the kernels for f32 operands and the head dims and
   widths the fast kernels do not take): every generic attention instance
   (dtype x head_dim) against its plain version, forward and backward twice
   bitwise, then each of the six generic wrappers timed at the flagship's
   widths in f32 (``flagship_model_config(dtype="float32")``'s shapes) with
   bound and library yardstick, and the GEGLU instances in bf16 at widths
   that are multiples of 8 only; then the tiny model
   (``tiny_model_config`` with every attention type, fused LayerNorm and
   GEGLU, f32, head_dim 16) through its forward and one ``grad_step`` on
   the card against the same weights on the CPU (loss, logits, every
   gradient within ``TINY_TOL``), counting the generic launches of that run;
11. the ``kernels`` line (the eleven ported kernels and the six generic
   instances).

With ``--profile``, one flagship forward and one training micro-batch are
traced with ``torch.profiler`` and split by kernel class.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor cores
F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
BF16_TOL = 2 ** -6             # rtol = atol for bf16 outputs (see phase 2)
F32_TOL = 1e-4                 # rtol = atol for f32 outputs of the generic
                               # kernels at flagship widths: sums of up to
                               # 4096 products in another order than the
                               # plain version's cuBLAS/PyTorch reductions
TINY_TOL = 2e-4                # the tiny model on the card vs the CPU (the
                               # tolerance the CPU tests hold it to JAX with)
LSE_TOL = 1e-4                 # f32 logsumexp
SUM_TOL = 1e-4                 # f32 sums over 5120 rows (LN dscale/dbias)
ARGMAX_AGREE = 0.9             # cached decode vs forward, share of positions
SEED = 0                       # weights, inputs and sampling noise
TRAIN_STEPS = 6                # flagship train steps on one fixed batch
MICRO, ACCUM = 4, 2            # micro-batch size, micro-batches per step
LOSS_FALL = 0.2                # least fall of the loss over the six steps
                               # (0.489 in the first run on one H100)
LOSS_GAP = 0.02                # 8-bit LAMB vs fp32: largest loss gap as a
                               # share of the fp32 loss (the JAX package's
                               # tests/test_quant.py allows 2% drift)
SAME_LOSS = 1e-6               # steps 1-2: 8-bit vs fp32 (same weights)
CHUNK_ELEMS = 1 << 22          # a swarm wire chunk (allreduce.CHUNK_ELEMS)
PARTS = 4                      # peers of the swarm round in phase 9


RECORDS = []
T_START = time.perf_counter()


def emit(**record) -> None:
    """Print a phase's record as one JSON line, with the seconds since the
    script started (``t_s``)."""
    record["t_s"] = time.perf_counter() - T_START
    RECORDS.append(record)
    print(json.dumps(record), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


KERNEL_CLASSES = (
    ("_generic", "generic attention and GEGLU instances"),
    ("attn_fwd_kernel", "attention kernel, forward"),
    ("attn_bwd_", "attention kernels, backward (dq pass, dk/dv pass, "
                  "prefix dk/dv pass)"),
    ("geglu_bwd_kernel", "GEGLU backward kernel"),
    ("geglu_fwd_kernel", "GEGLU forward kernels"),
    ("ln_bwd_", "LayerNorm backward kernels (row pass, partial sum)"),
    ("_ln_fwd", "LayerNorm forward kernel"),
)
CUBLAS_MARKS = ("nvjet", "xmma", "gemm", "cutlass")
# the GEGLU forward's two kernels, by their names in a profiler trace
GEGLU_FWD_PASSES = ("geglu_fwd_kernel<1>", "geglu_fwd_kernel<0>")


def kernel_class(key: str) -> str:
    for mark, cls in KERNEL_CLASSES:
        if mark in key:
            return cls
    if any(m in key for m in CUBLAS_MARKS):
        return "cuBLAS GEMMs"
    return "PyTorch elementwise, copies, reductions"


def ptxas_instances(reports) -> dict:
    """Registers and spill bytes of every kernel instance that ``nvcc
    -Xptxas -v`` reported while building, keyed like ``attn_fwd_kernel<0>``
    (the template's integer argument), ``geglu_bwd_kernel`` (no template)
    or the plain name of an ``extern "C"`` kernel."""
    out = {}
    for log in reports.values():
        cur = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                cur = m.group(1)
                mangled = re.match(r"_Z(\d+)(\w+)", cur)
                if mangled:
                    n = int(mangled.group(1))
                    name, rest = mangled.group(2)[:n], mangled.group(2)[n:]
                    targs = re.match(r"ILi(\d+)E", rest)
                    cur = f"{name}<{targs.group(1)}>" if targs else name
                out[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                out[cur].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[cur]["ptxas_registers"] = int(m.group(1))
    return out


def pass_ms(torch, fn, args, marks) -> dict:
    """Device ms of one call of ``fn`` split by kernel, from one
    ``torch.profiler`` trace (the second of two, as in ``profile_run``: the
    first warms the tracer): for each mark (a substring of the kernel's
    name) the sum over the kernels it names, None where the trace holds
    none."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
    out = dict.fromkeys(marks)
    for e in prof.key_averages():
        for mark in marks:
            if mark in e.key and e.self_device_time_total > 0:
                out[mark] = (out[mark] or 0.0) + e.self_device_time_total / 1e3
    return out


def profile_run(torch, fn, args, path: str, phase: str) -> None:
    """Trace one call of ``fn`` (a first traced call warms the tracer):
    device time by kernel, and the device's busy share of the host's wall
    clock over the traced call. Kernel rows are the rows with device time
    and no host time of their own."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events
                  if e.self_device_time_total > 0 and e.cpu_time_total == 0),
                 key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    classes = {}
    for key, ms, _ in dev:
        cls = kernel_class(key)
        classes[cls] = classes.get(cls, 0.0) + ms
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(f"== {phase} ==\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=80))
        f.write("\n")
    emit(phase=phase, wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, classes_ms=classes,
         top=[dict(kernel=k[:90], ms=ms, calls=n) for k, ms, n in dev[:16]])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write every record to this JSON file")
    parser.add_argument("--profile", default=None, metavar="PATH",
                        help="also trace one flagship forward and one "
                             "training micro-batch with torch.profiler and "
                             "write their tables to PATH")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2

    import copy

    import numpy as np
    import torch.nn.functional as F

    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import (OptimizerConfig,
                                        flagship_model_config,
                                        tiny_model_config)
    from dalle_tpu_torch.entry import entry, train_entry
    from dalle_tpu_torch.models.attention import zoo_attention_mask
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.decode import (SamplingConfig, decode_step,
                                               decode_tables,
                                               generate_images, init_cache)
    from dalle_tpu_torch.models.transformer import wrapper_calls
    from dalle_tpu_torch.ops import (GENERIC_LAUNCHES, LAUNCHES, _build,
                                     reset_launches)
    from dalle_tpu_torch.ops.attention import (BWD_PASSES,
                                               GENERIC_HEAD_DIMS,
                                               attention_route,
                                               kernel_resources,
                                               line_attention,
                                               line_attention_bwd,
                                               line_attention_bwd_plain,
                                               line_attention_plain,
                                               window_attention,
                                               window_attention_bwd,
                                               window_attention_bwd_plain,
                                               window_attention_plain)
    from dalle_tpu_torch.ops.geglu import (geglu_ff, geglu_ff_bwd,
                                           geglu_ff_bwd_plain, geglu_ff_plain)
    from dalle_tpu_torch.ops.geglu import \
        kernel_resources as geglu_resources
    from dalle_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                                layer_norm_bwd_plain,
                                                layer_norm_plain)
    from dalle_tpu_torch.ops.quant import (codebook_midpoints,
                                           quantize_blockwise,
                                           quantize_blockwise_plain,
                                           wire_quantize_u4,
                                           wire_quantize_u4_plain,
                                           wire_quantize_u8,
                                           wire_quantize_u8_plain)
    from dalle_tpu_torch.optim import optimizer_state_bytes
    from dalle_tpu_torch.time_quant import quantize_bytes
    from dalle_tpu_torch.swarm import compression, device_codec
    from dalle_tpu_torch.swarm.error_feedback import ErrorFeedback
    from dalle_tpu_torch.training.steps import grad_step

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    card = dict(name=torch.cuda.get_device_name(0), nvidia_smi=smi,
                count=torch.cuda.device_count(), torch=torch.__version__,
                cuda=torch.version.cuda)
    emit(phase="device", **card)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    usage = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit(phase="build", seconds=build_s, sources=_build.sources(),
         ptxas=usage, instances=ptxas_instances(reports))

    cfg = flagship_model_config(param_dtype="bfloat16")
    B, H, Dh = 4, cfg.heads, cfg.head_dim
    T, TT, G = cfg.total_seq_len, cfg.text_seq_len, cfg.image_grid
    M, D, K = B * T, cfg.dim, cfg.ff_mult * cfg.dim
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf)

    def events_ms(run, iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters

    def cuda_ms(fn, arg_sets, iters=20):
        """(device ms, eager ms) per call, cycling through argument sets
        whose bytes together exceed the L2 cache. Device time replays the
        calls captured in a CUDA graph, so the host's launch cost is out of
        it; eager time launches from Python as the model does."""
        def run():
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        eager = events_ms(run, iters)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        graph.replay()
        device = events_ms(graph.replay, iters)
        del graph
        return device, eager

    def compare(name, got, want, tol):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        ok = bool((err <= tol + tol * want.abs()).all())
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version: max |diff| {err.max().item()} "
                                 f"(tolerance {tol} + {tol}*|plain|)")
        return err.max().item()

    def release_memory():
        """Return cached blocks, the cuBLAS workspaces of the timing
        streams included (each stream that ran cuBLAS keeps one), so that
        the next phase's peak memory counts only its own."""
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()

    def assert_no_generic(where):
        """The flagship runs only the fast kernels: no call since the last
        reset took the generic route."""
        if any(GENERIC_LAUNCHES.values()):
            raise AssertionError(f"{where}: generic-route launches "
                                 f"{dict(GENERIC_LAUNCHES)} on the flagship")

    def twice(name, kernel_fn, *args):
        """The kernel's outputs; a second run must give the same bits."""
        first, second = kernel_fn(*args), kernel_fn(*args)
        for a, b in zip(first, second):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{name}: two runs on the same inputs "
                                     "gave different bits")
        return first

    def times(kernel, plain, library, sets, iters=20):
        out = {}
        for key, f in (("ms", kernel), ("plain_ms", plain),
                       ("library_ms", library)):
            out[key] = None
            if f is not None:
                out[key], out[key.replace("ms", "eager_ms")] = cuda_ms(
                    f, sets, iters)
        return out

    kernels = {}

    # -- 2a. LayerNorm ------------------------------------------------------
    ln_sets = [(randn(M, D, scale=2.0), randn(D, scale=0.2) + 1,
                randn(D, scale=0.1)) for _ in range(6)]
    err = compare("layer_norm", layer_norm(*ln_sets[0]),
                  layer_norm_plain(*ln_sets[0]), BF16_TOL)
    lib_ln = lambda x, g, b: F.layer_norm(x, (D,), g, b, 1e-6)  # noqa: E731
    bms, by = bound(2 * M * D * 2 + 2 * D * 2, 7 * M * D, F32_FLOP_PER_S)
    kernels["layer_norm"] = dict(
        name="layer_norm", route="triton",
        source="dalle_tpu_torch/ops/layer_norm.py",
        replaces="dalle_tpu/ops/pallas/ln_kernels.py:77",
        max_abs_err=err, tolerance=f"rtol=atol={BF16_TOL} (bf16 output)",
        **times(layer_norm, layer_norm_plain, lib_ln, ln_sets),
        bound_ms=bms, bound_by=by,
        shape=f"x ({M}, {D}) bf16, scale/bias ({D},) bf16")

    # -- 2b/c. attention: q/k/v as the model makes them, (B, T, H, d) -----
    def qkv_set():
        return [randn(B, T, H, Dh).transpose(1, 2) for _ in range(3)]

    att_sets = [qkv_set() for _ in range(3)]

    def split(q, k, v):
        return ([x[:, :, :TT] for x in (q, k, v)],
                [x[:, :, TT:] for x in (q, k, v)])

    def line_layer(q, k, v, col=False, fn=line_attention):
        (qt, kt, vt), (qi, ki, vi) = split(q, k, v)
        ot, lt = fn(qt, kt, vt, None, None, TT, 0, False)
        oi, li = fn(qi, ki, vi, kt, vt, G, G, col)
        return ot, lt, oi, li

    hw = cfg.conv_kernel // 2

    def window_call(q, k, v, fn=window_attention):
        (_, kt, vt), (qi, ki, vi) = split(q, k, v)
        return fn(qi, ki, vi, kt, vt, G, hw)

    errs = []
    for col in (False, True):
        got = line_layer(*att_sets[0], col=col)
        want = line_layer(*att_sets[0], col=col, fn=line_attention_plain)
        errs += [compare("line_attention out", got[0], want[0], BF16_TOL),
                 compare("line_attention out", got[2], want[2], BF16_TOL)]
        compare("line_attention lse", got[1], want[1], LSE_TOL)
        compare("line_attention lse", got[3], want[3], LSE_TOL)
    got, want = (window_call(*att_sets[0]),
                 window_call(*att_sets[0], fn=window_attention_plain))
    win_err = compare("window_attention out", got[0], want[0], BF16_TOL)
    compare("window_attention lse", got[1], want[1], LSE_TOL)

    def masks_for(attn_type):
        full = torch.from_numpy(zoo_attention_mask(
            attn_type, TT, G, cfg.conv_kernel)).to(dev)
        return full, full[TT:]

    row_mask, _ = masks_for("axial_row")
    _, conv_rows = masks_for("conv_like")

    def sdpa_layer(q, k, v):   # one call: the whole axial_row layer
        return F.scaled_dot_product_attention(q, k, v, attn_mask=row_mask)

    def sdpa_window(q, k, v):  # one call: image queries over [text; image]
        return F.scaled_dot_product_attention(q[:, :, TT:], k, v,
                                              attn_mask=conv_rows)

    def pairs(mask):
        return int(mask.sum().item())

    text_pairs = TT * (TT + 1) // 2
    row_pairs = pairs(row_mask[TT:])
    att_row_bytes = lambda t, s: (4 * B * H * t * Dh * 2  # noqa: E731
                                  + 2 * B * H * s * Dh * 2 + B * H * t * 4)
    # one layer reads the text k/v once: the image call's prefix is the
    # text call's k/v, already counted
    line_bytes = att_row_bytes(TT, 0) + att_row_bytes(G * G, 0)
    bms, by = bound(line_bytes, 4 * Dh * B * H * (text_pairs + row_pairs))
    kernels["line_attention"] = dict(
        name="line_attention", route="cuda",
        source="dalle_tpu_torch/csrc/attention_fwd.cu",
        replaces="dalle_tpu/ops/pallas/attention_kernels.py:227",
        max_abs_err=max(errs),
        tolerance=f"rtol=atol={BF16_TOL} (bf16 out), {LSE_TOL} (f32 lse)",
        **times(line_layer,
                lambda *a: line_layer(*a, fn=line_attention_plain),
                sdpa_layer, att_sets),
        ms_axial_col=cuda_ms(lambda *a: line_layer(*a, col=True),
                             att_sets)[0],
        bound_ms=bms, bound_by=by,
        shape=(f"one axial_row layer: text call q/k/v ({B},{H},{TT},{Dh}) "
               f"+ image call ({B},{H},{G * G},{Dh}) with a {TT}-token "
               f"prefix, bf16, strided (B,T,H,d) views"))

    win_pairs = pairs(conv_rows)
    bms, by = bound(att_row_bytes(G * G, TT), 4 * Dh * B * H * win_pairs)
    kernels["window_attention"] = dict(
        name="window_attention", route="cuda",
        source="dalle_tpu_torch/csrc/attention_fwd.cu",
        replaces="dalle_tpu/ops/pallas/attention_kernels.py:518",
        max_abs_err=win_err,
        tolerance=f"rtol=atol={BF16_TOL} (bf16 out), {LSE_TOL} (f32 lse)",
        **times(window_call,
                lambda *a: window_call(*a, fn=window_attention_plain),
                sdpa_window, att_sets),
        bound_ms=bms, bound_by=by,
        shape=(f"conv_like hw={hw}: image q/k/v ({B},{H},{G * G},{Dh}) "
               f"with a {TT}-token prefix, bf16"))

    # per template instance: registers, shared memory and local bytes from
    # the runtime, registers and spills from ptxas (when this run built it)
    resources, ptxas = kernel_resources(), ptxas_instances(reports)

    def instance_resources(names, policy):
        return {f"{n}<{policy}>": resources[f"{n}<{policy}>"]
                | ptxas.get(f"{n}<{policy}>", {}) for n in names}

    for name, policy in (("line_attention", 0), ("window_attention", 1)):
        rec = kernels[name]
        rec["ms_vs_library"] = rec["ms"] / rec["library_ms"]
        rec["resources"] = instance_resources(("attn_fwd_kernel",), policy)
    ff_resources = geglu_resources()

    def geglu_kernel_resources(names):
        return {n: ff_resources[n] | ptxas.get(n, {}) for n in names}

    ff_sets = [(randn(M, D), randn(D, K, scale=D ** -0.5),
                randn(D, K, scale=D ** -0.5), randn(K, D, scale=K ** -0.5),
                randn(K, scale=0.1), randn(K, scale=0.1), randn(D, scale=0.1))
               for _ in range(2)]
    ff_err = compare("geglu_ff", twice("geglu_ff",
                                       lambda *a: (geglu_ff(*a),),
                                       *ff_sets[0])[0],
                     geglu_ff_plain(*ff_sets[0]), BF16_TOL)
    ff_bytes = (2 * M * D + 3 * D * K + 2 * K + D) * 2
    bms, by = bound(ff_bytes, 6 * M * D * K)
    kernels["geglu_ff"] = dict(
        name="geglu_ff", route="cuda",
        source="dalle_tpu_torch/csrc/geglu_fwd.cu",
        replaces="dalle_tpu/ops/pallas/geglu_kernels.py:126",
        max_abs_err=ff_err, tolerance=f"rtol=atol={BF16_TOL} (bf16 output)",
        bitwise_reproducible=True,
        **times(geglu_ff, geglu_ff_plain, None, ff_sets, iters=10),
        bound_ms=bms, bound_by=by,
        shape=f"x ({M}, {D}), Wi/Wg ({D}, {K}), Wo ({K}, {D}) bf16; "
              "two launches per call (gate GEMM, output GEMM)",
        resources=geglu_kernel_resources(GEGLU_FWD_PASSES))
    # the yardstick: cuBLAS on the same two products, the epilogues (bias,
    # gelu, product) left out; never called by the port
    hg_sets = [(x, torch.cat([wi, wg], dim=1), randn(M, K), wo)
               for x, wi, wg, wo, *_ in ff_sets]
    rec = kernels["geglu_ff"]
    rec["cublas_ms"] = cuda_ms(
        lambda x, w, h, wo: (torch.matmul(x, w), torch.matmul(h, wo)),
        hg_sets, 10)[0]
    rec["cublas"] = "torch.matmul: x.[Wi|Wg], then an (M, K) bf16 hg.Wo"
    rec["ms_vs_cublas"] = rec["ms"] / rec["cublas_ms"]
    del hg_sets
    for rec in kernels.values():
        emit(phase="kernel_check", **rec)

    # -- 3. the flagship forward through the entry point ------------------
    # the checks' buffers go first, so that the peak is the forward's own
    del ln_sets, att_sets, ff_sets, got, want
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    fn, (model, _, _) = entry(device="cuda", batch=B, seed=SEED)
    rng = np.random.default_rng(SEED)
    text = torch.from_numpy(rng.integers(
        1, cfg.vocab_text, (B, TT))).to(dev)
    image = torch.from_numpy(rng.integers(
        0, cfg.vocab_image, (B, cfg.image_seq_len))).to(dev)
    torch.cuda.synchronize()
    assert_no_generic("phase 2, the forward kernel checks")
    reset_launches()
    loss = fn(model, text, image)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    expected = dict.fromkeys(LAUNCHES, 0) | {
        "layer_norm": 2 * cfg.depth + 1,
        "line_attention": 2 * (cfg.depth - 1) + 1, "window_attention": 1,
        "geglu_ff": sum(1 for u, _ in cfg.layer_schedule() if u == 3)}
    loss = float(loss)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if not (math.isfinite(loss) and 0.0 < loss < 20.0):
        raise AssertionError(f"flagship loss {loss} is not a sane value")
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(model, text, image)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    emit(phase="forward", batch=B, loss=loss, launches=launches,
         expected=expected, forward_ms=fwd_ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         mem_before_gb=mem_base / 1e9)
    if args.profile:
        if os.path.exists(args.profile):
            os.remove(args.profile)
        profile_run(torch, fn, (model, text, image), args.profile,
                    "profile")
    for name, rec in kernels.items():
        rec["launches"] = launches[name]

    # -- 4. teacher-forced cached decode vs the forward's logits ----------
    with torch.inference_mode():
        _, _, logits = model(text[:1], image[:1], return_logits=True)
        labels = torch.cat([text[:1], image[:1] + cfg.vocab_text], 1)
        inputs = torch.cat([torch.full((1, 1), cfg.vocab_total, device=dev,
                                       dtype=labels.dtype),
                            labels[:, :-1]], 1)
        cache = init_cache(cfg, 1, dev)
        tables = decode_tables(cfg, dev)
        t0 = time.perf_counter()
        steps = []
        for p in range(T):
            lp, cache = decode_step(model, cache, inputs[:, p], p, tables)
            steps.append(lp)
        got = torch.stack(steps, 1)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    valid = logits > -1e8
    diff = (got - logits).abs()[valid].max().item()
    scale = logits[valid].abs().max().item()
    # bf16 keeps 8 significant bits; the two paths round at different
    # places through 64 layers (~sqrt(64) = 8 independent roundings of
    # 2^-8), doubled for margin: 2^-4 of the logit range
    dec_tol = 2 ** -4 * scale
    agree = (got.argmax(-1) == logits.argmax(-1)).float().mean().item()
    if not diff <= dec_tol:
        raise AssertionError(f"cached decode vs forward: max |diff| {diff} "
                             f"> {dec_tol}")
    # the bound on |diff| is loose; a fault confined to a few positions or
    # one attention type shows as argmax disagreement instead
    if not agree >= ARGMAX_AGREE:
        raise AssertionError(f"cached decode vs forward: argmax agrees on "
                             f"{agree:.3f} of positions < {ARGMAX_AGREE}")
    emit(phase="decode_vs_forward", positions=T, max_abs_err=diff,
         tolerance=dec_tol, logit_range=scale, argmax_agreement=agree,
         decode_s=dec_s)

    # -- 5. generation ----------------------------------------------------
    captions = torch.from_numpy(rng.integers(1, cfg.vocab_text,
                                             (2, TT))).to(dev)
    prompts = captions.repeat_interleave(2, dim=0)
    sampling = SamplingConfig(temperature=1.0, top_k=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = generate_images(model, prompts,
                            torch.Generator(device=dev).manual_seed(1),
                            sampling)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if (tuple(codes.shape) != (4, cfg.image_seq_len)
            or not bool(((codes >= 0) & (codes < cfg.vocab_image)).all())):
        raise AssertionError(f"generated codes out of range: "
                             f"{tuple(codes.shape)}, {codes.min().item()}.."
                             f"{codes.max().item()}")
    emit(phase="generate", images=4, captions=2, sampling=sampling._asdict(),
         seconds=gen_s, img_per_s=4 / gen_s,
         distinct_codes=int(codes.unique().numel()))

    del model, fn, logits, got, cache, codes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 6. the backward kernels against their plain backwards ------------
    def library_ms(fn, arg_sets, iters=20):
        """Eager time of the library yardstick (autograd through a kept
        graph: no CUDA graph capture)."""
        def run():
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
        run()
        return events_ms(run, iters)

    def backward_record(name, route, source, replaces, kernel_fn, plain_fn,
                        sets, lib_fn, lib_sets, nbytes, flops, peak, errs,
                        tolerance, shape, iters=20):
        bms, by = bound(nbytes, flops, peak)
        rec = dict(name=name, route=route, source=source, replaces=replaces,
                   max_abs_err=max(errs), tolerance=tolerance,
                   bitwise_reproducible=True,
                   **times(kernel_fn, plain_fn, None, sets, iters),
                   bound_ms=bms, bound_by=by, shape=shape)
        rec["library_ms"] = (library_ms(lib_fn, lib_sets, iters)
                             if lib_fn is not None else None)
        rec["library"] = ("autograd backward of one PyTorch call, eager"
                          if lib_fn is not None else None)
        return rec

    # one axial layer's and one window call's forward and backward, as the
    # model makes them (any dtype)
    def line_fwd(q, k, v, col):
        (qt, kt, vt), (qi, ki, vi) = split(q, k, v)
        return (line_attention(qt, kt, vt, None, None, TT, 0, False),
                line_attention(qi, ki, vi, kt, vt, G, G, col))

    def line_bwd_layer(q, k, v, do, fo, col=False, fn=line_attention_bwd):
        """One axial layer's backward: the text call and the image call
        (whose prefix gradients autograd adds to the text k/v)."""
        (qt, kt, vt), (qi, ki, vi) = split(q, k, v)
        (ot, lt), (oi, li) = fo
        gt = fn(qt, kt, vt, None, None, ot, lt, do[:, :, :TT], TT, 0, False)
        gi = fn(qi, ki, vi, kt, vt, oi, li, do[:, :, TT:], G, G, col)
        return gt[:3] + gi

    def win_fwd(q, k, v):
        (_, kt, vt), (qi, ki, vi) = split(q, k, v)
        return window_attention(qi, ki, vi, kt, vt, G, hw)

    def win_bwd(q, k, v, do, fo, fn=window_attention_bwd):
        (_, kt, vt), (qi, ki, vi) = split(q, k, v)
        return fn(qi, ki, vi, kt, vt, *fo, do[:, :, TT:], G, hw)

    def sdpa_graph(q, k, v, do, mask, image_queries=False):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        qq = leaves[0][:, :, TT:] if image_queries else leaves[0]
        out = F.scaled_dot_product_attention(qq, leaves[1], leaves[2],
                                             attn_mask=mask)
        return out, leaves, do[:, :, TT:] if image_queries else do

    def att_bytes(t, s, es=2):
        """Bytes of one attention backward call over t queries with an
        s-token prefix, es-byte operands: q, k, v, O, dO and the f32 lse
        read, dq, dk, dv written; the prefix read and its gradients
        written."""
        return (5 * B * H * t * Dh * es + B * H * t * 4
                + 3 * B * H * t * Dh * es + 2 * B * H * s * Dh * es)

    def check_backward_kernels():
        recs = {}
        # LayerNorm backward: scale in bf16, as the hoisted cast gives it
        sets = [(randn(M, D, scale=2.0), randn(D, scale=0.2) + 1,
                 randn(M, D)) for _ in range(4)]
        got = twice("layer_norm_bwd", layer_norm_bwd, *sets[0])
        want = layer_norm_bwd_plain(*sets[0])
        errs = [compare("layer_norm_bwd dx", got[0], want[0], BF16_TOL),
                compare("layer_norm_bwd dscale", got[1], want[1], SUM_TOL),
                compare("layer_norm_bwd dbias", got[2], want[2], SUM_TOL)]

        def ln_graph(x, g, dy):
            leaves = [x.clone().requires_grad_(True),
                      g.clone().requires_grad_(True),
                      torch.zeros_like(g).requires_grad_(True)]
            return (F.layer_norm(leaves[0], (D,), leaves[1], leaves[2],
                                 1e-6), leaves, dy)

        lib_sets = [ln_graph(*st) for st in sets]
        recs["layer_norm_bwd"] = backward_record(
            "layer_norm_bwd", "cuda", "dalle_tpu_torch/csrc/layer_norm_bwd.cu",
            "dalle_tpu/ops/pallas/ln_kernels.py:94", layer_norm_bwd,
            layer_norm_bwd_plain, sets, autograd_retained, lib_sets,
            3 * M * D * 2 + D * 2 + 2 * D * 4, 16 * M * D, F32_FLOP_PER_S,
            errs, f"rtol=atol={BF16_TOL} (bf16 dx), {SUM_TOL} (f32 sums)",
            f"x, dy ({M}, {D}) bf16, scale ({D},) bf16; two launches per "
            "call (the persistent row pass, the partial sum over blocks)")
        del sets, lib_sets, got, want

        # GEGLU backward tensors
        sets = [(randn(M, D), randn(D, K, scale=D ** -0.5),
                 randn(D, K, scale=D ** -0.5), randn(K, D, scale=K ** -0.5),
                 randn(K, scale=0.1), randn(K, scale=0.1), randn(M, D))
                for _ in range(2)]
        got = twice("geglu_ff_bwd", geglu_ff_bwd, *sets[0])
        want = geglu_ff_bwd_plain(*sets[0])
        errs = [compare("geglu_ff_bwd dh|dg", got[0], want[0], BF16_TOL),
                compare("geglu_ff_bwd hg", got[1], want[1], BF16_TOL)]
        recs["geglu_ff_bwd"] = backward_record(
            "geglu_ff_bwd", "cuda", "dalle_tpu_torch/csrc/geglu_bwd.cu",
            "dalle_tpu/ops/pallas/geglu_kernels.py:153", geglu_ff_bwd,
            geglu_ff_bwd_plain, sets, None, None,
            (2 * M * D + 3 * D * K + 2 * K + 3 * M * K) * 2,
            3 * 2 * M * D * K, BF16_FLOP_PER_S, errs,
            f"rtol=atol={BF16_TOL} (bf16 outputs)",
            f"x, dO ({M}, {D}), Wi/Wg ({D}, {K}), Wo ({K}, {D}) bf16 -> "
            f"dh|dg ({M}, {2 * K}), hg ({M}, {K}) bf16", iters=10)
        rec = recs["geglu_ff_bwd"]
        rec["cublas_ms"] = cuda_ms(
            lambda x, w, do, wo: (torch.matmul(x, w),
                                  torch.matmul(do, wo.t())),
            [(st[0], torch.cat([st[1], st[2]], dim=1), st[6], st[3])
             for st in sets], 10)[0]
        rec["cublas"] = "torch.matmul: x.[Wi|Wg] and dO.Wo^T"
        rec["ms_vs_cublas"] = rec["ms"] / rec["cublas_ms"]
        rec["resources"] = geglu_kernel_resources(("geglu_bwd_kernel",))
        # the forward's split between its two kernels (traced here, after
        # the forward's timings, which no profiler trace precedes)
        x, wi, wg, wo, bi, bg, _ = sets[0]
        ff_split = pass_ms(torch, geglu_ff, (x, wi, wg, wo, bi, bg,
                                             randn(D, scale=0.1)),
                           GEGLU_FWD_PASSES)
        emit(phase="geglu_ff_split", ms_gate_pass=ff_split[
            GEGLU_FWD_PASSES[0]], ms_out_pass=ff_split[GEGLU_FWD_PASSES[1]])
        del sets, got, want

        # attention: q/k/v/dO as the model makes them, (B, T, H, d) views
        def att_set():
            q, k, v, do = (randn(B, T, H, Dh).transpose(1, 2)
                           for _ in range(4))
            return q, k, v, do

        sets = []
        for _ in range(3):
            q, k, v, do = att_set()
            sets.append((q, k, v, do, line_fwd(q, k, v, False)))
        errs = []
        for col in (False, True):
            q, k, v, do, _ = sets[0]
            fo = line_fwd(q, k, v, col)
            got = twice("line_attention_bwd",
                        lambda *a: line_bwd_layer(*a, col=col),
                        q, k, v, do, fo)
            want = line_bwd_layer(q, k, v, do, fo, col=col,
                                  fn=line_attention_bwd_plain)
            errs += [compare(f"line_attention_bwd {n}", a, b, BF16_TOL)
                     for n, a, b in zip(("dq_t", "dk_t", "dv_t", "dq_i",
                                         "dk_i", "dv_i", "dkp", "dvp"),
                                        got, want)]

        lib_sets = [sdpa_graph(*st[:4], row_mask) for st in sets]
        # the image call reads the text k/v (counted with the text call)
        # and writes their prefix gradients
        recs["line_attention_bwd"] = backward_record(
            "line_attention_bwd", "cuda",
            "dalle_tpu_torch/csrc/attention_bwd.cu",
            "dalle_tpu/ops/pallas/attention_kernels.py:259",
            line_bwd_layer,
            lambda *a: line_bwd_layer(*a, fn=line_attention_bwd_plain),
            sets, autograd_retained, lib_sets,
            att_bytes(TT, 0) + att_bytes(G * G, TT),
            10 * Dh * B * H * (text_pairs + row_pairs), BF16_FLOP_PER_S,
            errs, f"rtol=atol={BF16_TOL} (bf16 gradients)",
            f"one axial_row layer: text call ({B},{H},{TT},{Dh}) + image "
            f"call ({B},{H},{G * G},{Dh}) with a {TT}-token prefix, bf16, "
            "strided (B,T,H,d) views; per wrapper call one launch each of "
            "the dq pass and the dk/dv pass, and with a prefix one of the "
            "prefix dk/dv pass (4-block clusters)")
        recs["line_attention_bwd"]["ms_axial_col"] = cuda_ms(
            lambda *a: line_bwd_layer(*a, col=True),
            [(q, k, v, do, line_fwd(q, k, v, True))
             for q, k, v, do, _ in sets])[0]
        del lib_sets

        def passes(name, fn, args, policy):
            """The record's pass split (one traced call), its time over
            SDPA's and its kernels' resources."""
            rec = recs[name]
            split = pass_ms(torch, fn, args, BWD_PASSES)
            rec.update(ms_dq_pass=split[BWD_PASSES[0]],
                       ms_dkdv_pass=split[BWD_PASSES[1]],
                       ms_dkdv_prefix_pass=split[BWD_PASSES[2]],
                       ms_vs_library=rec["ms"] / rec["library_ms"],
                       resources=instance_resources(BWD_PASSES, policy))

        passes("line_attention_bwd", line_bwd_layer, sets[0], 0)

        sets = [(q, k, v, do, win_fwd(q, k, v)) for q, k, v, do, _ in sets]
        got = twice("window_attention_bwd", win_bwd, *sets[0])
        want = win_bwd(*sets[0], fn=window_attention_bwd_plain)
        errs = [compare(f"window_attention_bwd {n}", a, b, BF16_TOL)
                for n, a, b in zip(("dq", "dk", "dv", "dkp", "dvp"), got,
                                   want)]
        lib_sets = [sdpa_graph(*st[:4], conv_rows, image_queries=True)
                    for st in sets]
        # the window call's text k/v are its prefix: read, and written as
        # dkp/dvp
        recs["window_attention_bwd"] = backward_record(
            "window_attention_bwd", "cuda",
            "dalle_tpu_torch/csrc/attention_bwd.cu",
            "dalle_tpu/ops/pallas/attention_kernels.py:548", win_bwd,
            lambda *a: win_bwd(*a, fn=window_attention_bwd_plain), sets,
            autograd_retained, lib_sets,
            att_bytes(G * G, TT) + 2 * B * H * TT * Dh * 2,
            10 * Dh * B * H * win_pairs, BF16_FLOP_PER_S, errs,
            f"rtol=atol={BF16_TOL} (bf16 gradients)",
            f"conv_like hw={hw}: image call ({B},{H},{G * G},{Dh}) with a "
            f"{TT}-token prefix, bf16; three kernel launches per call "
            "(dq pass, dk/dv pass, prefix dk/dv pass)")
        passes("window_attention_bwd", win_bwd, sets[0], 1)
        return recs

    def autograd_retained(out, leaves, do):
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    def check_generic_route():
        """Phase 10: every generic attention instance against its plain
        version; the six generic wrappers at the flagship's widths in f32,
        timed; the GEGLU instances in bf16 at widths that are multiples of
        8 only; then the tiny model's forward and ``grad_step`` on the card
        against the CPU, whose generic launches the records report."""
        f32 = torch.float32
        tolerance = {f32: F32_TOL, bf: BF16_TOL}
        attn_src = "dalle_tpu_torch/csrc/attention_generic.cu"
        ff_src = "dalle_tpu_torch/csrc/geglu_generic.cu"

        def rand(dtype, *shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dtype)

        # (a) each (dtype, head_dim) instance: a text call, an axial_col
        # call with a prefix and a conv window call, forward and backward
        bq, hq, gq, tq = 2, 2, 8, 32
        instances = []
        for dtype in (f32, bf):
            for hd in GENERIC_HEAD_DIMS:
                if attention_route(dtype, hd) != "generic":
                    continue
                q, k, v, do = (rand(dtype, bq, tq + gq * gq, hq, hd)
                               .transpose(1, 2) for _ in range(4))
                t_ops = [x[:, :, :tq] for x in (q, k, v, do)]
                i_ops = [x[:, :, tq:] for x in (q, k, v, do)]
                calls = (
                    ("line text", line_attention, line_attention_bwd,
                     line_attention_plain, line_attention_bwd_plain,
                     (*t_ops[:3], None, None), t_ops[3], (tq, 0, False)),
                    ("line axial_col", line_attention, line_attention_bwd,
                     line_attention_plain, line_attention_bwd_plain,
                     (*i_ops[:3], *t_ops[1:3]), i_ops[3], (gq, gq, True)),
                    ("window conv_like", window_attention,
                     window_attention_bwd, window_attention_plain,
                     window_attention_bwd_plain, (*i_ops[:3], *t_ops[1:3]),
                     i_ops[3], (gq, 1)))
                errs = []
                for what, fwd, bwd, pfwd, pbwd, ops, dout, extra in calls:
                    what = f"generic {what} {dtype} head_dim {hd}"
                    out, lse = fwd(*ops, *extra)
                    want = pfwd(*ops, *extra)
                    errs.append(compare(f"{what} out", out, want[0],
                                        tolerance[dtype]))
                    compare(f"{what} lse", lse, want[1], LSE_TOL)
                    got = twice(f"{what} backward", bwd, *ops, out, lse,
                                dout, *extra)
                    want = pbwd(*ops, out, lse, dout, *extra)
                    errs += [compare(f"{what} {n}", a, w, tolerance[dtype])
                             for n, a, w in zip(("dq", "dk", "dv", "dkp",
                                                 "dvp"), got, want)
                             if a is not None]
                instances.append(dict(dtype=str(dtype), head_dim=hd,
                                      max_abs_err=max(errs)))
        emit(phase="generic_attention_instances", instances=instances,
             shape=f"B={bq}, H={hq}, text {tq}, grid {gq}; text call, "
                   "axial_col call with the text prefix, conv_like hw=1 "
                   "call with the text prefix; backward twice, bitwise")

        # (b) the six wrappers at the flagship's widths in f32, timed
        recs = {}
        sets = []
        for _ in range(2):
            q, k, v, do = (rand(f32, B, T, H, Dh).transpose(1, 2)
                           for _ in range(4))
            sets.append((q, k, v, do))
        shape_f32 = (f"f32 at the flagship's widths: text ({B},{H},{TT},"
                     f"{Dh}) + image ({B},{H},{G * G},{Dh}) with a "
                     f"{TT}-token prefix, strided (B,T,H,d) views")
        fwd_bytes = lambda t, s: (4 * B * H * t * Dh * 4  # noqa: E731
                                  + 2 * B * H * s * Dh * 4 + B * H * t * 4)

        def fwd_record(name, replaces, fn, plain, lib, nbytes, pairs_,
                       errs, shape):
            bms, by = bound(nbytes, 4 * Dh * B * H * pairs_, F32_FLOP_PER_S)
            return dict(name=name, route="cuda", source=attn_src,
                        replaces=replaces, max_abs_err=max(errs),
                        tolerance=f"rtol=atol={F32_TOL} (f32 out), "
                                  f"{LSE_TOL} (f32 lse)",
                        **times(fn, plain, lib, [st[:3] for st in sets],
                                iters=10),
                        bound_ms=bms, bound_by=by, shape=shape)

        q, k, v, do = sets[0]
        got = line_layer(q, k, v)
        want = line_layer(q, k, v, fn=line_attention_plain)
        errs = [compare("generic line_attention out", got[i], want[i],
                        F32_TOL) for i in (0, 2)]
        for i in (1, 3):
            compare("generic line_attention lse", got[i], want[i], LSE_TOL)
        recs["line_attention_generic"] = fwd_record(
            "line_attention_generic",
            "dalle_tpu/ops/pallas/attention_kernels.py:227", line_layer,
            lambda *a: line_layer(*a, fn=line_attention_plain), sdpa_layer,
            fwd_bytes(TT, 0) + fwd_bytes(G * G, 0), text_pairs + row_pairs,
            errs, "one axial_row layer, " + shape_f32)
        got, want = (window_call(q, k, v),
                     window_call(q, k, v, fn=window_attention_plain))
        errs = [compare("generic window_attention out", got[0], want[0],
                        F32_TOL)]
        compare("generic window_attention lse", got[1], want[1], LSE_TOL)
        recs["window_attention_generic"] = fwd_record(
            "window_attention_generic",
            "dalle_tpu/ops/pallas/attention_kernels.py:518", window_call,
            lambda *a: window_call(*a, fn=window_attention_plain),
            sdpa_window, fwd_bytes(G * G, TT), win_pairs, errs,
            f"conv_like hw={hw}, image queries, " + shape_f32)

        bsets = [(q, k, v, do, line_fwd(q, k, v, False))
                 for q, k, v, do in sets]
        got = twice("generic line_attention_bwd", line_bwd_layer, *bsets[0])
        want = line_bwd_layer(*bsets[0], fn=line_attention_bwd_plain)
        errs = [compare(f"generic line_attention_bwd {i}", a, w, F32_TOL)
                for i, (a, w) in enumerate(zip(got, want))]
        lib_sets = [sdpa_graph(*st[:4], row_mask) for st in bsets]
        recs["line_attention_bwd_generic"] = backward_record(
            "line_attention_bwd_generic", "cuda", attn_src,
            "dalle_tpu/ops/pallas/attention_kernels.py:259", line_bwd_layer,
            lambda *a: line_bwd_layer(*a, fn=line_attention_bwd_plain),
            bsets, autograd_retained, lib_sets,
            att_bytes(TT, 0, 4) + att_bytes(G * G, TT, 4),
            10 * Dh * B * H * (text_pairs + row_pairs), F32_FLOP_PER_S, errs,
            f"rtol=atol={F32_TOL} (f32 gradients)",
            "one axial_row layer, " + shape_f32 + "; per wrapper call a dq "
            "pass, a dk/dv pass and with a prefix a prefix dk/dv pass",
            iters=10)
        del lib_sets
        bsets = [(q, k, v, do, win_fwd(q, k, v)) for q, k, v, do in sets]
        got = twice("generic window_attention_bwd", win_bwd, *bsets[0])
        want = win_bwd(*bsets[0], fn=window_attention_bwd_plain)
        errs = [compare(f"generic window_attention_bwd {i}", a, w, F32_TOL)
                for i, (a, w) in enumerate(zip(got, want))]
        lib_sets = [sdpa_graph(*st[:4], conv_rows, image_queries=True)
                    for st in bsets]
        recs["window_attention_bwd_generic"] = backward_record(
            "window_attention_bwd_generic", "cuda", attn_src,
            "dalle_tpu/ops/pallas/attention_kernels.py:548", win_bwd,
            lambda *a: win_bwd(*a, fn=window_attention_bwd_plain), bsets,
            autograd_retained, lib_sets,
            att_bytes(G * G, TT, 4) + 2 * B * H * TT * Dh * 4,
            10 * Dh * B * H * win_pairs, F32_FLOP_PER_S, errs,
            f"rtol=atol={F32_TOL} (f32 gradients)",
            f"conv_like hw={hw}, image queries, " + shape_f32, iters=10)
        del lib_sets, bsets, sets

        ff = [(rand(f32, M, D), rand(f32, D, K, scale=D ** -0.5),
               rand(f32, D, K, scale=D ** -0.5),
               rand(f32, K, D, scale=K ** -0.5), rand(f32, K, scale=0.1),
               rand(f32, K, scale=0.1), rand(f32, D, scale=0.1),
               rand(f32, M, D)) for _ in range(2)]
        ff_shape = (f"x, dO ({M}, {D}), Wi/Wg ({D}, {K}), Wo ({K}, {D}) "
                    "f32 (the flagship's widths)")
        fwd_sets = [st[:7] for st in ff]
        err = compare("generic geglu_ff", twice(
            "generic geglu_ff", lambda *a: (geglu_ff(*a),),
            *fwd_sets[0])[0], geglu_ff_plain(*fwd_sets[0]), F32_TOL)
        bms, by = bound((2 * M * D + 3 * D * K + 2 * K + D) * 4,
                        6 * M * D * K, F32_FLOP_PER_S)
        recs["geglu_ff_generic"] = dict(
            name="geglu_ff_generic", route="cuda", source=ff_src,
            replaces="dalle_tpu/ops/pallas/geglu_kernels.py:126",
            max_abs_err=err, tolerance=f"rtol=atol={F32_TOL} (f32 output)",
            bitwise_reproducible=True,
            **times(geglu_ff, geglu_ff_plain, None, fwd_sets, iters=5),
            bound_ms=bms, bound_by=by,
            shape=ff_shape + "; two launches per call (gate, output)")
        bwd_sets = [st[:6] + st[7:] for st in ff]
        got = twice("generic geglu_ff_bwd", geglu_ff_bwd, *bwd_sets[0])
        want = geglu_ff_bwd_plain(*bwd_sets[0])
        errs = [compare(f"generic geglu_ff_bwd {n}", a, w, F32_TOL)
                for n, a, w in zip(("dh|dg", "hg"), got, want)]
        recs["geglu_ff_bwd_generic"] = backward_record(
            "geglu_ff_bwd_generic", "cuda", ff_src,
            "dalle_tpu/ops/pallas/geglu_kernels.py:153", geglu_ff_bwd,
            geglu_ff_bwd_plain, bwd_sets, None, None,
            (2 * M * D + 3 * D * K + 2 * K + 3 * M * K) * 4,
            3 * 2 * M * D * K, F32_FLOP_PER_S, errs,
            f"rtol=atol={F32_TOL} (f32 outputs)", ff_shape, iters=5)
        # the yardstick: cuBLAS's f32 products alone (TF32 off)
        recs["geglu_ff_generic"]["cublas_ms"] = cuda_ms(
            lambda x, w, h, wo: (torch.matmul(x, w), torch.matmul(h, wo)),
            [(st[0], torch.cat([st[1], st[2]], dim=1), rand(f32, M, K),
              st[3]) for st in ff], 5)[0]
        recs["geglu_ff_bwd_generic"]["cublas_ms"] = cuda_ms(
            lambda x, w, do, wo: (torch.matmul(x, w),
                                  torch.matmul(do, wo.t())),
            [(st[0], torch.cat([st[1], st[2]], dim=1), st[7], st[3])
             for st in ff], 5)[0]
        del ff, fwd_sets, bwd_sets, got, want
        for rec in recs.values():
            rec["tf32"] = torch.backends.cuda.matmul.allow_tf32
            emit(phase="kernel_check", **rec)

        # (c) the bf16 GEGLU instances at widths that are multiples of 8
        mb_, db_, kb_ = 1000, 200, 808
        ops = [rand(bf, *sh, scale=sc) for sh, sc in (
            ((mb_, db_), 1.0), ((db_, kb_), db_ ** -0.5),
            ((db_, kb_), db_ ** -0.5), ((kb_, db_), kb_ ** -0.5),
            ((kb_,), 0.1), ((kb_,), 0.1), ((db_,), 0.1), ((mb_, db_), 1.0))]
        errs = [compare("generic geglu_ff bf16", twice(
            "generic geglu_ff bf16", lambda *a: (geglu_ff(*a),),
            *ops[:7])[0], geglu_ff_plain(*ops[:7]), BF16_TOL)]
        got = twice("generic geglu_ff_bwd bf16", geglu_ff_bwd,
                    *ops[:6], ops[7])
        errs += [compare(f"generic geglu_ff_bwd bf16 {n}", a, w, BF16_TOL)
                 for n, a, w in zip(("dh|dg", "hg"), got, geglu_ff_bwd_plain(
                     *ops[:6], ops[7]))]
        emit(phase="generic_geglu_bf16", shape=f"M={mb_}, d={db_}, K={kb_}"
             " bf16", max_abs_err=max(errs), tolerance=f"rtol=atol="
             f"{BF16_TOL}", bitwise_reproducible=True)
        del ops, got

        # (d) the tiny model: forward and one grad_step on the card against
        # the CPU; the generic launches of this run are the records'
        tiny = dict(attn_types=("axial_row", "axial_col", "conv_like",
                                "full"), conv_kernel=3, ln_fusion=True,
                    ff_fusion="all")
        tcfg = tiny_model_config(**tiny)
        cpu_model = init_params(tcfg, torch.Generator().manual_seed(SEED))
        trng = np.random.default_rng(SEED)
        with torch.no_grad():   # nonzero biases and scales: a dropped term
            for pname, prm in cpu_model.named_parameters():   # shows
                if pname.endswith(("bias", "scale")):
                    prm.add_(torch.from_numpy(0.05 * trng.standard_normal(
                        prm.shape)).to(prm.dtype))
        card_model = copy.deepcopy(cpu_model).to(dev)
        tbatch = {"text": torch.from_numpy(trng.integers(
                      1, tcfg.vocab_text, (2, tcfg.text_seq_len))),
                  "image": torch.from_numpy(trng.integers(
                      0, tcfg.vocab_image, (2, tcfg.image_seq_len)))}
        with torch.no_grad():
            loss_c, _, logits_c = cpu_model(tbatch["text"], tbatch["image"],
                                            return_logits=True)
        gloss_c, _, grads_c = grad_step(cpu_model, tbatch)
        dbatch = {key: val.to(dev) for key, val in tbatch.items()}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss_g, _, logits_g = card_model(dbatch["text"], dbatch["image"],
                                             return_logits=True)
        gloss_g, _, grads_g = grad_step(card_model, dbatch)
        torch.cuda.synchronize()
        tiny_s = time.perf_counter() - t0
        generic = dict(GENERIC_LAUNCHES)
        launches = dict(LAUNCHES)
        idle = sorted(key for key, n in generic.items() if n == 0)
        if idle:
            raise AssertionError(f"tiny model: generic kernels {idle} were "
                                 f"not launched ({generic})")
        errs = {"loss": compare("tiny forward loss", loss_g.cpu(), loss_c,
                                TINY_TOL),
                "logits": compare("tiny forward logits", logits_g.cpu(),
                                  logits_c, TINY_TOL),
                "grad_step loss": compare("tiny grad_step loss",
                                          gloss_g.cpu(), gloss_c, TINY_TOL)}
        errs["gradients"] = max(compare(f"tiny gradient {key}",
                                        grads_g[key].cpu(), g, TINY_TOL)
                                for key, g in grads_c.items())
        emit(phase="generic_tiny_model", config=tiny,
             widths=dict(dim=tcfg.dim, depth=tcfg.depth, heads=tcfg.heads,
                         head_dim=tcfg.head_dim, dtype=tcfg.dtype),
             loss_card=float(loss_g), loss_cpu=float(loss_c),
             max_abs_err=errs, tolerance=f"rtol=atol={TINY_TOL}",
             generic_launches=generic, launches=launches, seconds=tiny_s)
        for name, rec in recs.items():
            rec["launches"] = generic[name[:-len("_generic")]]
        return recs

    bwd_kernels = check_backward_kernels()
    for rec in bwd_kernels.values():
        emit(phase="kernel_check", **rec)
    kernels.update(bwd_kernels)
    release_memory()

    # -- 7. flagship training steps through the entry point ---------------
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    step, (state, batch) = train_entry(device="cuda", micro=MICRO,
                                       accum=ACCUM, seed=SEED, state_bits=32)
    tcfg = state.model.cfg
    per_micro = wrapper_calls(tcfg, training=True)
    expected = {k: ACCUM * v for k, v in per_micro.items()}
    losses, norms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 0:
            assert_no_generic("the phases before this training run")
            reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            train_launches = dict(LAUNCHES)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if train_launches != expected:
        raise AssertionError(f"training launch counts {train_launches} != "
                             f"{expected} ({ACCUM} x one micro-batch: "
                             f"{per_micro})")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad_norm: {losses}, "
                             f"{norms}")
    # step 1 has learning rate 0 (count 0), so the loss can fall from
    # step 2 on; it must fall at every step after that
    falls = [losses[i] - losses[i + 1] for i in range(1, TRAIN_STEPS - 1)]
    if not (min(falls) > 0 and losses[-1] < losses[0] - LOSS_FALL):
        raise AssertionError(f"the loss does not fall: {losses}")
    steady = step_s[1:]
    fp32 = dict(losses=losses, peak=torch.cuda.max_memory_allocated(),
                launches=train_launches,
                step_s=sum(steady) / len(steady),
                emb_numel=state.model.token_emb.numel(),
                n_params=sum(p.numel() for p in state.model.parameters()),
                sizes=[p.numel() for p in state.model.parameters()])
    emit(phase="train", micro=MICRO, accum=ACCUM, steps=TRAIN_STEPS,
         optimizer="fp32 LAMB, OptimizerConfig(state_bits=32, "
                   "warmup_steps=2, total_steps=100)",
         losses=losses, grad_norms=norms, loss_fall=losses[0] - losses[-1],
         launches=train_launches, launches_per_micro_batch=per_micro,
         step_s=step_s, step_s_mean=sum(steady) / len(steady),
         img_per_s=MICRO * ACCUM * len(steady) / sum(steady),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         mem_before_gb=mem_base / 1e9, card=smi)
    # the step's split: its gradient half alone (the rest is LAMB and the
    # metrics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad_step(state.model, batch, ACCUM)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    emit(phase="train_split", grad_step_s=grad_s,
         step_minus_grad_s=sum(steady) / len(steady) - grad_s)
    for name in ("layer_norm_bwd", "geglu_ff_bwd", "line_attention_bwd",
                 "window_attention_bwd"):
        kernels[name]["launches"] = train_launches[name]
    if args.profile:
        micro = {k: v[:MICRO] for k, v in batch.items()}
        profile_run(torch, grad_step, (state.model, micro), args.profile,
                    "profile_train_micro_batch")
    del state, batch, step

    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 8a. the three quantizers against their plain versions ------------
    def exact(name, got, want):
        """Codes and scales must be identical, not merely close."""
        for a, b in zip(got, want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{name}: kernel differs from its plain "
                                     f"version ({tuple(a.shape)} vs "
                                     f"{tuple(b.shape)})")

    def f32_set(n, square=False):
        x = torch.randn(n, generator=gen, device=dev) * 1e-3
        return (x * x if square else x,)

    def ragged(n):
        """Zeros, -0.0, and values on exact midpoints of the codebook and
        half steps of a power-of-two wire scale (ties)."""
        x = torch.randn(n, generator=gen, device=dev)
        x[: n // 5] = 0.0
        x[n // 5: n // 5 + 9] = -0.0
        k = torch.arange(-127, 127, dtype=torch.float32, device=dev)
        x[256:256 + k.numel()] = (k + 0.5) * 2 ** -3
        x[256 + k.numel()] = 127 * 2 ** -3
        mids = torch.from_numpy(codebook_midpoints(True)).to(dev)
        x[4096:4096 + mids.numel()] = mids * 2.0
        x[4096 + mids.numel()] = 2.0
        return x

    def qtuple(q):
        return q.codes, q.absmax

    def quant_record(name, replaces, kernel, plain, sets, nbytes, ops,
                     shape):
        bms, by = bound(nbytes, ops, F32_FLOP_PER_S)
        return dict(name=name, route="cuda",
                    source="dalle_tpu_torch/csrc/quant.cu",
                    replaces=replaces, max_abs_err=0.0,
                    tolerance="identical codes and scales (torch.equal)",
                    **times(kernel, plain, None, sets), bound_ms=bms,
                    bound_by=by, library=None, shape=shape)

    def every_float(signed, per=4095, chunk_blocks=1 << 15):
        """Every float32 bit pattern in [-1, 1] (both signs) through the
        kernel against the plain version: blocks of per + 1 values whose
        first is 1.0, so that x / absmax == x and the lookup sees each
        pattern itself; in chunks of chunk_blocks blocks."""
        top = int(np.float32(1.0).view(np.int32)) + 1
        step = per * chunk_blocks
        count = 0
        for sign in (0, -(1 << 31)):
            for start in range(0, top, step):
                bits = torch.arange(start, min(start + step, top),
                                    dtype=torch.int32, device=dev) | sign
                vals = F.pad(bits.view(torch.float32),
                             (0, -bits.numel() % per))
                x = torch.cat([torch.ones(vals.numel() // per, 1,
                                          device=dev), vals.view(-1, per)],
                              dim=1).reshape(-1)
                exact(f"quantize_blockwise every float32 in [-1, 1] "
                      f"signed={signed}, {'negative' if sign else 'positive'}"
                      f" bits from {start:#x}",
                      qtuple(quantize_blockwise(x, per + 1, signed=signed)),
                      quantize_blockwise_plain(x, per + 1, signed=signed))
                count += bits.numel()
                del bits, vals, x
        return count

    n_emb = fp32["emb_numel"]
    quant = {}
    t0 = time.perf_counter()
    floats = {signed: every_float(signed) for signed in (True, False)}
    sweep_s = time.perf_counter() - t0
    # every instance: float4 groups of 1 to 512 threads (8192), scalar
    # groups (4097: 512), two passes float4 (16384 up) and scalar (10001)
    blocks_checked = (1, 100, 128, 1152, 4096, 4097, 8192, 10001, 16384,
                      32768, 65536)
    for signed in (True, False):
        sets = [f32_set(n_emb, square=not signed) for _ in range(2)]
        exact(f"quantize_blockwise signed={signed}",
              twice(f"quantize_blockwise signed={signed}",
                    lambda x: qtuple(quantize_blockwise(x, signed=signed)),
                    *sets[0]),
              quantize_blockwise_plain(*sets[0], signed=signed))
        x = ragged(3 * 4096 + 1000)
        x = x if signed else x.abs()
        exact("quantize_blockwise ragged", qtuple(quantize_blockwise(
            x, signed=signed)), quantize_blockwise_plain(x, signed=signed))
        x = ragged(2 * 65536 + 1001)
        x = x if signed else x.abs()
        for block in blocks_checked:
            exact(f"quantize_blockwise block={block}", qtuple(
                quantize_blockwise(x, block, signed=signed)),
                quantize_blockwise_plain(x, block, signed=signed))
        nb = -(-n_emb // 4096)
        quant[signed] = quant_record(
            "quantize_blockwise", "dalle_tpu/ops/pallas/quant_kernels.py:64",
            lambda x, s=signed: quantize_blockwise(x, signed=s),
            lambda x, s=signed: quantize_blockwise_plain(x, signed=s), sets,
            quantize_bytes(n_emb), 11 * n_emb,
            f"token_emb-sized moment ({n_emb},) f32 -> ({nb}, 4096) u8 + "
            f"({nb}, 1) f32, {'signed' if signed else 'unsigned'} codebook")
        del sets, x
    # each size the 8-bit LAMB quantizes (flagship: 262,144 to 41,287,680),
    # cold (inputs rotated through more than the L2), and the sum over one
    # step's launches: a signed (m) and an unsigned (v) call per tensor
    big = [n for n in fp32["sizes"] if n >= OptimizerConfig().min_8bit_size]
    per_size = {}
    for n in sorted(set(big)):
        rec = dict(n=n, tensors=big.count(n))
        n_sets = max(2, -(-80_000_000 // (5 * n)))
        for signed, tag in ((True, "signed"), (False, "unsigned")):
            sets = [f32_set(n, square=not signed) for _ in range(n_sets)]
            exact(f"quantize_blockwise n={n}", qtuple(quantize_blockwise(
                *sets[0], signed=signed)), quantize_blockwise_plain(
                *sets[0], signed=signed))
            rec[f"{tag}_us"] = cuda_ms(
                lambda x, s=signed: quantize_blockwise(x, signed=s), sets,
                max(20, n_sets))[0] * 1e3
            rec[f"{tag}_bound_us"] = bound(quantize_bytes(n), 11 * n,
                                           F32_FLOP_PER_S)[0] * 1e3
            del sets
        per_size[n] = rec
    step_us = sum(per_size[n]["signed_us"] + per_size[n]["unsigned_us"]
                  for n in big)
    step_bound_us = sum(per_size[n]["signed_bound_us"]
                        + per_size[n]["unsigned_bound_us"] for n in big)
    emit(phase="quantize_blockwise_sizes", every_float32_checked=floats,
         every_float32_s=sweep_s, blocks_checked=blocks_checked,
         sizes=list(per_size.values()), step_launches=2 * len(big),
         step_us=step_us, step_bound_us=step_bound_us,
         step_share_of_bound=step_bound_us / step_us, card=smi)
    kernels["quantize_blockwise"] = quant[True]
    kernels["quantize_blockwise"]["unsigned_ms"] = quant[False]["ms"]
    kernels["quantize_blockwise"]["unsigned_plain_ms"] = \
        quant[False]["plain_ms"]

    # one part of a 4-peer round over the flagship's flat gradient
    n_part = fp32["n_params"] // PARTS // 1024 * 1024
    for name, replaces, kernel, plain, block, code_bytes in (
            ("wire_quantize_u8", "dalle_tpu/ops/pallas/quant_kernels.py:126",
             wire_quantize_u8, wire_quantize_u8_plain, 256, lambda n: n),
            ("wire_quantize_u4", "dalle_tpu/ops/pallas/quant_kernels.py:155",
             wire_quantize_u4, wire_quantize_u4_plain, 1024,
             lambda n: (n + 1) // 2)):
        sets = [f32_set(n_part) for _ in range(2)]
        exact(name, kernel(*sets[0]), plain(*sets[0]))
        for n in (1_000_003, 4096 + 1001, 5):       # ragged, odd
            x = ragged(max(n, 5000))[:n].contiguous()
            exact(f"{name} n={n}", kernel(x), plain(x))
        nb = -(-n_part // block)
        kernels[name] = quant_record(
            name, replaces, kernel, plain, sets,
            4 * n_part + code_bytes(n_part) + 4 * nb, 6 * n_part,
            f"one part of a {PARTS}-peer round ({n_part},) f32 -> "
            f"{code_bytes(n_part)} code bytes + ({nb},) f32 scales"
            + ("; nibble pairs packed in the kernel" if block == 1024
               else ""))
        del sets
    for name in ("quantize_blockwise", "wire_quantize_u8",
                 "wire_quantize_u4"):
        emit(phase="kernel_check", **kernels[name])
    release_memory()

    # -- 8b. flagship training steps with the 8-bit LAMB -------------------
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    assert_no_generic("phases 7-8a (fp32 training, quantizer checks)")
    reset_launches()
    step, (state, batch) = train_entry(device="cuda", micro=MICRO,
                                       accum=ACCUM, seed=SEED, state_bits=8)
    torch.cuda.synchronize()
    n_big = sum(p.numel() >= OptimizerConfig().min_8bit_size
                for p in state.model.parameters())
    init_launches = dict(LAUNCHES)
    if init_launches != dict.fromkeys(LAUNCHES, 0) | {
            "quantize_blockwise": 2 * n_big}:
        raise AssertionError(f"8-bit LAMB init launches {init_launches}, "
                             f"expected 2 x {n_big} quantize_blockwise")
    expected = fp32["launches"] | {"quantize_blockwise": 2 * n_big}
    losses, norms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 0:
            assert_no_generic("the phases before this training run")
            reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            train_launches = dict(LAUNCHES)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if train_launches != expected:
        raise AssertionError(f"8-bit training launch counts {train_launches}"
                             f" != {expected}")
    if LAUNCHES["quantize_blockwise"] != TRAIN_STEPS * 2 * n_big:
        raise AssertionError(f"{LAUNCHES['quantize_blockwise']} "
                             f"quantize_blockwise launches in {TRAIN_STEPS} "
                             f"steps, expected {TRAIN_STEPS} x 2 x {n_big}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"8-bit LAMB: non-finite loss or grad_norm: "
                             f"{losses}, {norms}")
    same = [abs(losses[i] - fp32["losses"][i]) for i in range(2)]
    if max(same) > SAME_LOSS:
        raise AssertionError(f"8-bit LAMB steps 1-2 {losses[:2]} differ from "
                             f"the fp32 run's {fp32['losses'][:2]}")
    falls = [losses[i] - losses[i + 1] for i in range(1, TRAIN_STEPS - 1)]
    if not (min(falls) > 0 and losses[-1] < losses[0] - LOSS_FALL):
        raise AssertionError(f"8-bit LAMB: the loss does not fall: {losses}")
    gaps = [a - b for a, b in zip(losses, fp32["losses"])]
    gap_share = max(abs(g) / b for g, b in zip(gaps, fp32["losses"]))
    if gap_share > LOSS_GAP:
        raise AssertionError(f"8-bit LAMB loss gaps to fp32 {gaps}: "
                             f"{gap_share:.4f} of the loss > {LOSS_GAP}")
    peak = torch.cuda.max_memory_allocated()
    if not peak < fp32["peak"]:
        raise AssertionError(f"8-bit LAMB peak memory {peak / 1e9:.3f} GB "
                             f"is not below the fp32 run's "
                             f"{fp32['peak'] / 1e9:.3f} GB")
    steady = step_s[1:]
    emit(phase="train_8bit", micro=MICRO, accum=ACCUM, steps=TRAIN_STEPS,
         optimizer="8-bit LAMB, OptimizerConfig(state_bits=8, "
                   "warmup_steps=2, total_steps=100)",
         losses=losses, grad_norms=norms, loss_fall=losses[0] - losses[-1],
         loss_gaps_to_fp32=gaps, max_gap_share=gap_share,
         quantized_tensors=n_big, init_launches=init_launches,
         launches=train_launches, state_bytes=optimizer_state_bytes(
             state.opt_state),
         step_s=step_s, step_s_mean=sum(steady) / len(steady),
         img_per_s=MICRO * ACCUM * len(steady) / sum(steady),
         fp32_step_s_mean=fp32["step_s"],
         peak_mem_gb=peak / 1e9, fp32_peak_mem_gb=fp32["peak"] / 1e9,
         mem_before_gb=mem_base / 1e9, card=smi)
    kernels["quantize_blockwise"]["launches"] = \
        train_launches["quantize_blockwise"]

    # -- 9. one swarm round's device codec ---------------------------------
    _, _, grads = grad_step(state.model, batch, ACCUM)
    del state, batch, step
    t0 = time.perf_counter()
    flat = device_codec.flatten_device(list(grads.values()))
    torch.cuda.synchronize()
    flatten_s = time.perf_counter() - t0
    del grads
    n = flat.numel()
    host = flat.cpu().numpy()
    cuts = [n * i // PARTS // 1024 * 1024 for i in range(PARTS)] + [n]
    parts = list(zip(cuts[:-1], cuts[1:]))
    U8, U4 = compression.UNIFORM8BIT, compression.UNIFORM4BIT
    codec_rec = dict(phase="swarm_codec", elements=n, parts=parts,
                     chunk_elems=CHUNK_ELEMS, flatten_s=flatten_s)
    for codec, name in ((U8, "wire_quantize_u8"), (U4, "wire_quantize_u4")):
        torch.cuda.synchronize()
        assert_no_generic("phases 8b-9 (8-bit training, the codec)")
        reset_launches()
        t0 = time.perf_counter()
        encs = [device_codec.encode_part(flat, lo, hi, codec)
                for lo, hi in parts]
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        if launches != dict.fromkeys(LAUNCHES, 0) | {name: PARTS}:
            raise AssertionError(f"{name}: encode launches {launches}, "
                                 f"expected {PARTS}")
        kernels[name]["launches"] = launches[name]
        t0 = time.perf_counter()
        chunks = 0
        payloads = []
        for (lo, hi), enc in zip(parts, encs):
            mine = []
            for clo in range(0, hi - lo, CHUNK_ELEMS):
                chi = min(hi - lo, clo + CHUNK_ELEMS)
                got = device_codec.part_payload(enc, clo, chi)
                if got != compression.compress(host[lo + clo:lo + chi],
                                               codec):
                    raise AssertionError(f"{name}: chunk [{lo + clo}, "
                                         f"{lo + chi}) differs from the host "
                                         "codec's bytes")
                mine.append(got)
                chunks += 1
            payloads.append(mine)
        frame_s = time.perf_counter() - t0
        for (lo, hi), enc, pls in zip(parts, encs, payloads):
            want = np.concatenate([compression.decompress(
                p, codec, min(hi - lo, c + CHUNK_ELEMS) - c)
                for p, c in zip(pls, range(0, hi - lo, CHUNK_ELEMS))])
            if enc.decoded_dev().cpu().numpy().tobytes() != want.tobytes():
                raise AssertionError(f"{name}: decoded_dev differs from the "
                                     "host decompress")
        # the owner of part 0 folds three senders' payloads of its part
        # (stand-ins: the payloads of parts 1-3 over part 0's length)
        m = min(hi - lo for lo, hi in parts)
        weights = (0.25, 0.3, 0.7, 1.0 / 3.0)
        acc = device_codec.accumulator_init(flat, 0, m, weights[0])
        want = host[:m] * np.float32(weights[0])
        for j, w in zip(range(1, PARTS), weights[1:]):
            pls = [device_codec.part_payload(encs[j], c,
                                             min(m, c + CHUNK_ELEMS))
                   for c in range(0, m, CHUNK_ELEMS)]
            acc = device_codec.fused_accumulate(acc, pls, codec, m, w)
            dec = np.concatenate([compression.decompress(
                p, codec, min(m, c + CHUNK_ELEMS) - c)
                for p, c in zip(pls, range(0, m, CHUNK_ELEMS))])
            want = want + dec * np.float32(w)
        if acc.cpu().numpy().tobytes() != want.tobytes():
            raise AssertionError(f"{name}: fused_accumulate differs from "
                                 "the host arithmetic")
        codec_rec[name] = dict(encode_s=encode_s, frame_and_check_s=frame_s,
                               chunks=chunks,
                               wire_bytes=sum(len(p) for ps in payloads
                                              for p in ps))
        del encs, payloads, acc
    # error feedback (the wire_bits=4 rounds' residual): two rounds, the
    # own part raw, the others as their owners decode them
    ef, ef_host = ErrorFeedback(), ErrorFeedback()
    for _ in range(2):
        comp = ef.compensate(flat.clone())
        comp_h = ef_host.compensate(host.copy())
        segs, segs_h = [], []
        for i, (lo, hi) in enumerate(parts):
            if i == 0:
                segs.append(comp[lo:hi].clone())
                segs_h.append(comp_h[lo:hi])
            else:
                segs.append(device_codec.encode_part(comp, lo, hi,
                                                     U4).decoded_dev())
                segs_h.append(compression.decompress(compression.compress(
                    comp_h[lo:hi], U4), U4, hi - lo))
        ef.store(comp, segs)
        ef_host.store(comp_h, segs_h)
        if ef.residual_host().tobytes() != ef_host.residual_host().tobytes():
            raise AssertionError("error feedback: the device residual "
                                 "differs from the host version's")
    codec_rec["error_feedback_rounds"] = 2
    emit(**codec_rec)
    del flat, host, ef, ef_host, comp, segs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 10. the generic route ---------------------------------------------
    assert_no_generic("phases 8b-9 (8-bit training, the codec)")
    kernels.update(check_generic_route())
    release_memory()

    # -- 11. kernels line and the end ------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernel_line = {"kernels": [{k: rec[k] for k in keys}
                               for rec in kernels.values()]}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RECORDS + [dict(phase="kernels", **kernel_line)], f,
                      indent=1)
    print(json.dumps(kernel_line), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
