#!/usr/bin/env python3
"""Drive the PyTorch port's flagship inference and training paths, the
8-bit LAMB, a swarm round's device codec, the generic kernel route, the
collaborative trainer peer, real data, the serving router, access tokens,
the stacked ``dense_scan`` model, the averaging assistant, fault
injection, ``save_ctx`` remat on the XL model, the offloaded optimizer
state, a multi-process peer, the long-context model, the sharded mesh
(fsdp, tp, ring and Ulysses sequence parallelism), PowerSGD on a sharded
peer, the untied head on a mesh, and the meshes whose axes JAX leaves
undivided (``sp`` as a replica axis, XL's heads at ``tp=8``) on one NVIDIA
GPU.

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
4. teacher-forced cached decode of all 1280 positions of one sequence
   against the forward's logits on the card, on the flagship's weights
   cut to ``GEN_DEPTH`` layers;
5. ``generate_images`` for 2 captions x 2 seeds (temperature 1, top-k 64;
   the fourth row greedy), one noise seed a row, on phase 4's model;
   then the serving slice on the same model (no kernel runs there: the
   counters must not move): a ``DecodeEngine`` (4 slots, 8-position
   chunks, a 256 MiB prefix cache) whose chunk is one CUDA graph a visible
   bucket, a ``PixelPipeline`` on its own stream with a full-size VQGAN
   decoder and CLIP ViT-B/32 (random weights from the seed), behind a
   ``ServingHTTPServer`` on 127.0.0.1: wave 1 posts the four requests of
   the ``generate_images`` call (cold), wave 2 the same four in reverse
   order (warm: each in another slot, every one a prefix hit); wave 2's
   codes must equal wave 1's bitwise, every reply carries 1024 codes, a
   (256, 256, 3) image and a finite CLIP score, and the probes answer 200;
   then, at every bucket, one graph-replayed chunk equals the eager chunk
   bitwise from the same live state; the VQGAN decode and one CLIP score
   on the card within 1e-4 of the CPU; with the eager and replayed ms a
   position, per-request TTFT and latency, img/s a wave, pixel ms an
   image, KV and prefix-entry bytes, peak memory and the device-idle share
   of one traced chunk replay;
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
   remat replay, backward), step time, img/s and peak memory (the tied
   head's logsumexp streamed over ``head_chunk=2048`` vocabulary rows, as
   ``FLAGSHIP_TUNED`` sets; then the peak and seconds of more steps with
   the chunks and with ``head_chunk=0``, the one-pass head, beside them,
   alternated: ``HEAD_ROUNDS`` rounds of chunked, one-pass, one-pass,
   chunked here and in 8b, one pair in 14a; and here the head's loss
   alone, forward and backward, both routes by CUDA events);
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
   bound and library yardstick (the GEGLU pair and the attention pairs,
   line and window, also beside the bound of three TF32 passes,
   ``bound_ms_3xtf32``, and with each instance's registers and spills; no
   generic attention kernel may spill); the generic GEGLU entry points in
   bf16 at M = 5120, d = 1000, K = 4000 (widths only they take) and at the
   flagship's (beside this run's fast kernels), each against its plain
   version twice bitwise and timed beside cuBLAS's two products; the GEGLU
   instances in bf16 at widths that are multiples of 8 only; then the tiny
   model (``tiny_model_config`` with every attention type, fused LayerNorm
   and GEGLU, f32, head_dim 16) through its forward and one ``grad_step``
   on the card against the same weights on the CPU (loss, logits, every
   gradient within ``TINY_TOL``), counting the generic launches of that
   run; and (e) ``flagship_model_config(dtype="float32")`` at full width
   cut to ``MESH_DEPTH`` layers, micro-batch 1, the same on the card and on
   the CPU (loss, logits, every gradient within ``TINY_TOL``), its generic
   launches exactly the schedule's (``wrapper_calls``);
11. the trainer peer at the JAX package's swarm defaults: (a) two
   flagship peers in this process (two threads, each a ``TrainingTask`` on
   a loopback DHT, the second bootstrapped from the first; micro-batch 4 x
   accumulation 2, the 8-bit LAMB, ``CollabConfig(target_batch_size=16,
   allreduce_timeout=60, average_state_every=0,
   wire_codec_backend="device", audit_frac=1.0)`` and the other defaults:
   size-adaptive codec, encryption, screening, strike gossip, the
   overlapped round, and the trust plane (verified aggregation, round
   repair, proof receipts)) run ``train_loop`` for two epochs: both epochs
   form a 2-peer group, each peer audits the other's part of both rounds
   (every part is challenged) with no failure, omission, unserved
   transcript or strike, the peers' params and moments end ``torch.equal``,
   the rounds launch ``wire_quantize_u8`` (its launch count in the
   ``kernels`` line is this run's, both peers together), no generic
   kernel runs, the losses are finite; recorded: each round's
   matchmaking, all-reduce and apply seconds, its wire bytes and the host
   walls of its legs, the swarm's samples/s, peak memory, the device idle
   share of one traced round, the audit's host seconds a round and its
   ring's peak retention; (b) ``python -m dalle_tpu_torch.cli.run_trainer
   --preset flagship`` at the defaults as a subprocess (one solo epoch, a
   checkpoint directory under ``build/``) exits 0 and its checkpoint
   restores here at epoch 1 with finite params; (c) the two peers of (a)
   with ``grad_compression="power_sgd"`` (rank 4, host Gram-Schmidt) for
   two epochs: both factor rounds complete in every epoch (and are
   audited clean), params and moments end ``torch.equal``, the losses are
   finite; recorded: round seconds, the factor rounds' wire bytes, peak
   memory;
12. real data, text prompts and access tokens (the fixtures in
   ``tests/data`` are the JAX package's, made by
   ``tests/data/make_fixtures.py``): (a) the port's ``prepare_data
   synthetic-shards --preset flagship`` shards (2 x 64 records, seed 0)
   and the first two batches its ``CodesDataset`` reads from them with
   the fixture tokenizer equal the committed sha256 digests; the reader's
   host ms a batch of read + tokenize and us a caption are recorded; then
   ``run_trainer --data-path --tokenizer-path`` trains 3 flagship steps
   solo in this process (finite losses, every model kernel launched, no
   generic launch); (b) two ``ServingHTTPServer`` engines (phase 5b's
   config, greedy, each on a copy of the flagship cut to
   ``ROUTER_DEPTH`` layers, bf16 parameters from the seed) with the fixture
   tokenizer, advertised by ``ServingAdvertiser`` on a loopback DHT,
   behind a ``Router`` and ``RouterHTTPServer``: four ``{"text": ...}``
   posts through the router (one caption twice) give the golden ids and
   the codes of direct ``{"tokens": ...}`` posts, the repeated caption
   lands twice on its affinity home; the router's added ms to TTFT and to
   latency are recorded; (c) phase 11a's pair at the default
   ``audit_frac`` for one epoch with an ``auth_authority`` and tokens from
   the port's ``issue_token``, and a third peer whose token another
   authority signed: the pair forms its 2-peer group without it and ends
   ``torch.equal``;
13. the stacked ``dense_scan`` layout, the averaging assistant and fault
   injection: (a) the dense flagship (64 independent layers, the body's 63
   in 16 stacked repetitions of 4 with one overhang slice, 1,133,068,288
   parameters) through ``train_entry`` with the 8-bit LAMB (micro-batch 4
   x accumulation 2): 45 quantized leaves, the stacked FF biases among
   them, the overhang slices' gradient exactly 0, four steps with the
   schedule's exact launch counts (2 x 45 ``quantize_blockwise`` a step),
   no generic launch, finite losses that fall, no layer view holding its
   slices between steps (the memory allocated then is recorded beside the
   state's bytes); teacher-forced cached decode over the text and two
   image rows within phase 4's tolerance;
   a stepped 8-bit state of the same layout at depth 8 through a
   checkpoint, restored ``torch.equal``; (b) 12c's pair plus an
   ``AveragingAssistant`` on an aux peer's task, one epoch: a 3-member
   group, the assistant owns a part, the pair ends ``torch.equal``, and
   the aux peer's archive of the swarm state restores ``torch.equal``;
   the round's seconds and bytes a leg beside 12c's; (c) the pair under
   seeded fault plans (delay and duplicate on the leader's sends, corrupt
   on the other's) with an honest assistant and one whose transport
   crashes after matchmaking: both trainers end the epoch, the crashed
   assistant's round ends, the leader's round names the corrupt sender
   and strikes it, and every fault fired;
14. ``save_ctx`` remat, the offloaded optimizer state and a peer of two
   processes: (a) one ``grad_step`` under ``save_attn`` and one under
   ``save_ctx`` on the same weights, on the flagship of phase 7 and on
   ``xl_model_config()`` at full width and depth (344,537,088
   parameters): the loss and every gradient ``torch.equal``, the exact
   launch counts (the attention forward once a layer and micro-batch),
   each one's peak memory; then four XL steps with the 8-bit LAMB under
   ``save_ctx`` (step s, img/s, peak memory, a falling loss); (b) phase
   8's and phase 7's steps, four updates each, on the device and then
   offloaded (moments in pinned host memory): every parameter and moment
   ``torch.equal`` after each update, the memory between steps lower by
   the state's bytes within 0.05 GB, ``quantize_blockwise`` on the card
   and never its plain version, each update's s; (c) ``python -m
   dalle_tpu_torch.cli.run_trainer --preset xl --remat-policy save_ctx
   --offload`` solo for four epochs with a checkpoint directory: exit 0,
   finite losses, a lower loss over its data than at step 0, the
   checkpoint restored into an offloaded and an on-device state
   ``torch.equal``, each serializing to the file's bytes; (d) a ``gloo``
   group of two processes (``dp=2``, phase 8's step on each process's 8
   rows, the flagship cut to ``MESH_DEPTH`` layers) as one peer beside a
   one-process peer, two epochs at
   ``target_batch_size=16`` and the JAX defaults otherwise: all three
   bitwise equal after every epoch, every round a 2-peer group, each
   child within its timeout; recorded: the slice's gradient mean s a
   step, the rounds' s, the swarm's samples/s;
15. the sharded mesh, each mesh a group of processes on the one card over
   ``gloo`` (``parallel/launch.spawn``): (a) ``long_context_model_config()``
   at full width and depth (64 ``full`` layers over 4 shared blocks, text
   256 + 64x64 codes) in one process, two 8-bit steps of 2 samples through
   the window kernel (exact launch counts; step s, img/s, peak memory),
   and the window kernel at that shape against its plain version, forward
   and backward, timed beside SDPA and its bound; (b) the same model cut
   to ``RING_DEPTH`` layers, two processes at ``sp=2`` (ring), one grad
   step against one process; (c) the flagship of phase 8 cut to
   ``MESH_DEPTH`` layers, four processes at ``dp=1 fsdp=2 tp=2``, one
   8-bit step of 4 samples against one process (loss and gradients; then
   the update from the one-process gradients: parameters and 8-bit
   codes; each process's resident bytes); (d) that flagship with
   ``sequence_parallel="ulysses"``, four processes at ``tp=2 sp=2``, one
   grad step against one process, the attention kernels on ``H/(tp*sp)``
   heads; (e)
   ``entry.dryrun_multichip(4)``: its four cases' finite losses;
16. PowerSGD on a sharded peer and the untied head on a mesh: (a) 14d's
   slice and peer with the slice at ``fsdp=2`` and
   ``grad_compression="power_sgd"`` (rank 4), the flagship cut to
   ``MESH_DEPTH`` layers, two epochs, no global clip: the slice's whole
   state and the peer's bitwise equal after every epoch, every round a
   2-peer group with both factor rounds complete, no
   ``wire_quantize_u8`` launch; recorded: the wire bytes a peer and round,
   the gloo bytes and s of the slice's rounds, the rounds' s, the swarm's
   samples/s, the error feedback's bytes a process; (b) 15c with an
   untied head (``lm_head/kernel`` as ``P("fsdp", "tp")``): 15c's checks,
   and ``return_logits`` within 2^-4 of the logit range of one process's;
17. the meshes whose axes JAX's rules leave undivided: (a) 15c's flagship
   at ``dp=1 fsdp=2 tp=1 sp=2`` with ``sequence_parallel="none"`` (the
   ``sp`` ranks replicas on whole sequences), against 15c's one-process
   run: the loss and gradients within 15c's limits, every process's
   gradients bitwise equal, no collective over ``sp``; (b)
   ``xl_model_config()`` at full width cut to ``MESH_DEPTH`` layers,
   eight processes at ``tp=8`` (28 heads: each rank gathers q/k/v and
   attends on all of them) against one process, 15c's limits, with the
   warm grad step's s and gloo's share; every mesh of 15-17 launches each
   kernel as often as one process's grad step;
18. the ``kernels`` line (the eleven ported kernels and the six generic
   instances).

The order differs from the numbers in one place: 15a runs right after
10, and then phases 14d-17 (every path of more than one process but 11-12)
run in a second process of this script (``--multiprocess``, at niceness
``MULTIPROCESS_NICE``, in a session of its own that is killed at the end)
beside 11-14c, so that no other process shares the card while a kernel
is timed. The second process's records are printed after 14c's, with
``t_s`` on the same clock; it fails the run if it fails or has not ended
``MULTIPROCESS_DEADLINE_S`` after the start.

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
TF32_FLOP_PER_S = 495e12       # dense TF32 tensor cores (3 passes for f32)
BF16_TOL = 2 ** -6             # rtol = atol for bf16 outputs (see phase 2)
BF16_BWD_TOL = 2 ** -7         # bf16 backward tensors (tests/test_torch_cuda)
F32_TOL = 1e-4                 # rtol = atol for f32 outputs of the generic
                               # kernels at flagship widths: sums of up to
                               # 4096 products in another order than the
                               # plain version's cuBLAS/PyTorch reductions
TINY_TOL = 2e-4                # the tiny model on the card vs the CPU (the
                               # tolerance the CPU tests hold it to JAX with)
LSE_TOL = 1e-4                 # f32 logsumexp
SUM_TOL = 1e-4                 # f32 sums over 5120 rows (LN dscale/dbias)
ARGMAX_AGREE = 0.9             # cached decode vs forward, share of positions
GEN_DEPTH = 9                  # phases 4, 5 and 5b: the flagship (the
                               # same five blocks and weights) cut for
                               # time to 9 layers, each shared block
                               # called twice, as MESH_DEPTH
SEED = 0                       # weights, inputs and sampling noise
TRAIN_STEPS = 6                # flagship train steps on one fixed batch
MICRO, ACCUM = 4, 2            # micro-batch size, micro-batches per step
HEAD_ROUNDS = 2                # 7 and 8b: rounds of chunked, one-pass,
                               # one-pass, chunked head steps timed
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


def release_memory() -> None:
    """Return cached blocks, the cuBLAS workspaces of the timing streams
    included (each stream that ran cuBLAS keeps one), so that the next
    phase's peak memory counts only its own."""
    import torch
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


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


def profile_run(torch, fn, args, path, phase: str) -> dict:
    """Trace one call of ``fn`` (a first traced call warms the tracer):
    device time by kernel, and the device's busy share of the host's wall
    clock over the traced call (with ``path``, the table is appended
    there). Kernel rows are the rows with device time and no host time of
    their own."""
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
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(f"== {phase} ==\n")
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=80))
            f.write("\n")
    rec = dict(wall_ms=wall_ms, device_busy_ms=busy,
               device_idle_share=1.0 - busy / wall_ms, classes_ms=classes,
               top=[dict(kernel=k[:90], ms=ms, calls=n)
                    for k, ms, n in dev[:16]])
    emit(phase=phase, **rec)
    return rec


def serving_phase(torch, np, dev, smi, model, captions, seeds, knobs,
                  gen_codes, release_memory) -> None:
    """Phase 5b: the serving slice on phase 5's model (see the module
    docstring). Runs no kernel of the port; every check raises."""
    import copy
    import threading
    import urllib.request

    from dalle_tpu_torch.cli.run_server import pixel_fns
    from dalle_tpu_torch.config import ServingConfig
    from dalle_tpu_torch.models import clip as tclip
    from dalle_tpu_torch.models import vqgan as tvqgan
    from dalle_tpu_torch.models.decode import SamplingConfig
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
    from dalle_tpu_torch.serving.engine import DecodeEngine
    from dalle_tpu_torch.serving.pixels import PixelPipeline
    from dalle_tpu_torch.serving.prefix_cache import prefix_entry_bytes
    from dalle_tpu_torch.serving.scheduler import kv_bytes_per_slot
    from dalle_tpu_torch.serving.server import ServingHTTPServer

    cfg = model.cfg
    total, n_img = cfg.total_seq_len, cfg.image_seq_len
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    serving = ServingConfig(n_slots=4, steps_per_call=8, prefix_cache_mb=256)
    pgen = torch.Generator(device=dev).manual_seed(SEED)
    vqgan = tvqgan.init_params(tvqgan.VQGANConfig(), pgen)
    clip = tclip.init_params(tclip.CLIPConfig(), pgen)
    # CLIP takes token ids: start, 9 random ids, end (the largest id)
    ctx, vocab = clip.cfg.context_length, clip.cfg.vocab_size
    clip_tokens = torch.zeros((1, ctx), dtype=torch.long)
    clip_tokens[0, 1:10] = torch.randint(1, vocab - 2, (9,), generator=torch
                                         .Generator().manual_seed(SEED))
    clip_tokens[0, 0], clip_tokens[0, 10] = vocab - 2, vocab - 1
    clip_tokens = clip_tokens.to(dev)
    pixel_fn, degraded_fn = pixel_fns(vqgan, clip, clip_tokens)
    pipeline = PixelPipeline(pixel_fn, degraded_fn=degraded_fn,
                             stream=torch.cuda.Stream(dev))
    engine = DecodeEngine(model, cfg, serving,
                          sampling=SamplingConfig(1.0, 64),
                          pixel_pipeline=pipeline)
    t0 = time.perf_counter()
    engine.start()                      # captures one graph a bucket
    capture_s = time.perf_counter() - t0
    runner = engine.runner
    if sorted(runner.graphs) != runner.bounds:
        raise AssertionError(f"captured {sorted(runner.graphs)}, buckets "
                             f"{runner.bounds}")
    httpd = ServingHTTPServer(("127.0.0.1", 0), engine,
                              request_timeout_s=600.0)
    http = threading.Thread(target=httpd.serve_forever, daemon=True)
    http.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [dict(tokens=captions[i // 2].tolist(), seed=seeds[i],
                   temperature=t, top_k=k, top_p=p)
              for i, (t, k, p) in enumerate(knobs)]

    def post(i, out):
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                out[i] = (resp.status, json.loads(resp.read()))
        except Exception as e:  # noqa: BLE001 - reported by the wave
            out[i] = (None, repr(e))

    def wave(order):
        """The four requests posted in ``order``, admitted at one chunk
        boundary: the scheduler's live clamp is held at 0 until all four
        are queued (so the slots decode in lockstep)."""
        base = engine.stats()["submitted"]
        engine.scheduler.max_live = 0
        out, threads = [None] * 4, []
        t0 = time.perf_counter()
        for n, i in enumerate(order):
            threads.append(threading.Thread(target=post, args=(i, out)))
            threads[-1].start()
            limit = time.monotonic() + 60
            while engine.stats()["submitted"] < base + n + 1:
                if time.monotonic() > limit:
                    raise AssertionError(f"request {i} never queued: {out}")
                time.sleep(0.002)
        engine.scheduler.max_live = serving.n_slots
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        rows = []
        for i, (status, body) in enumerate(out):
            if status != 200:
                raise AssertionError(f"request {i}: {status} {body}")
            row = body["results"][0]
            codes = np.asarray(row["codes"])
            if (codes.shape != (n_img,) or codes.min() < 0
                    or codes.max() >= cfg.vocab_image):
                raise AssertionError(f"request {i}: codes {codes.shape} "
                                     f"{codes.min()}..{codes.max()}")
            if row["image_shape"] != [256, 256, 3] or not math.isfinite(
                    row["clip_score"]):
                raise AssertionError(f"request {i}: image "
                                     f"{row['image_shape']}, clip score "
                                     f"{row['clip_score']}")
            rows.append(row)
        return rows, wall

    cold, cold_s = wave([0, 1, 2, 3])
    warm, warm_s = wave([3, 2, 1, 0])      # each lands in another slot
    for i, (c, w) in enumerate(zip(cold, warm)):
        if c["codes"] != w["codes"]:
            first = int(np.argmax(np.asarray(c["codes"])
                                  != np.asarray(w["codes"])))
            raise AssertionError(f"request {i}: warm codes differ from "
                                 f"cold from code {first}")
    stats = engine.stats()
    if (stats["prefix_hits"], stats["prefix_misses"]) != (4, 4) or not all(
            w.get("prefix_hit") for w in warm):
        raise AssertionError(f"prefix counters {stats['prefix_hits']} hits "
                             f"/ {stats['prefix_misses']} misses, expected "
                             "4 / 4")
    probes = {}
    for path in ("/healthz", "/readyz", "/metrics"):
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            probes[path] = resp.status
    if set(probes.values()) != {200}:
        raise AssertionError(f"probes {probes}")
    leading = []
    for i, row in enumerate(cold):
        same = np.asarray(row["codes"]) == gen_codes[i]
        leading.append(int(n_img if same.all() else np.argmin(same)))

    # one chunk at every bucket: graph replay == eager, bitwise, from four
    # live slots just below the bound on the cache the waves left
    torch.cuda.synchronize()
    st = runner.state
    eager_ms, graph_ms = [], []
    for visible in runner.bounds:
        pos = [max(0, visible - serving.steps_per_call - 3 * j)
               for j in range(4)]
        st.pos.copy_(torch.tensor(pos))
        st.tokens.copy_(st.text[:, 0])
        st.seeds.copy_(torch.tensor(seeds))
        for name, k in zip(("temp", "top_k", "top_p"), zip(*knobs)):
            getattr(st, name).copy_(torch.tensor(k))
        differ = runner.replay_equals_eager(visible)
        if differ:
            raise AssertionError(f"bucket {visible}: graph replay and eager "
                                 f"chunk differ in {differ}")
        saved = st.pos.clone()
        for run, out in ((runner.eager, eager_ms), (runner.run, graph_ms)):
            st.pos.copy_(saved)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(visible)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3
                       / serving.steps_per_call)
    st.pos.copy_(saved)
    trace = profile_run(torch, runner.run, (runner.bounds[-1],), None,
                        "serving_chunk_trace")
    st.pos.fill_(total)                    # every slot free again

    # the pixel stage: ms an image, and the card against the CPU in f32
    row = np.asarray(cold[0]["codes"], np.int32)
    pixel_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pixel_fn(row)
        torch.cuda.synchronize()
        pixel_ms.append((time.perf_counter() - t0) * 1e3)
    codes_t = torch.from_numpy(row[None]).long()
    with torch.no_grad():
        img_card = vqgan(codes_t.to(dev))
        vq_cpu = copy.deepcopy(vqgan).cpu()
        img_cpu = vq_cpu(codes_t)
    u8 = tvqgan.decode_codes(vq_cpu, codes_t)
    clip_in = tclip.resize_for_clip(u8, clip.cfg)
    score_card = tclip.clip_scores(clip, clip_in.to(dev), clip_tokens)
    score_cpu = tclip.clip_scores(copy.deepcopy(clip).cpu(), clip_in,
                                  clip_tokens.cpu())
    pix_err = {}
    for name, got, want in (("vqgan", img_card.cpu(), img_cpu),
                            ("clip", score_card.cpu(), score_cpu)):
        err = (got - want).abs()
        if not (bool(torch.isfinite(got).all())
                and bool((err <= 1e-4 + 1e-4 * want.abs()).all())):
            raise AssertionError(f"{name} on the card vs the CPU: max "
                                 f"|diff| {err.max().item()}")
        pix_err[name] = err.max().item()
    if any(LAUNCHES.values()) or any(GENERIC_LAUNCHES.values()):
        raise AssertionError(f"the serving slice launched port kernels: "
                             f"{dict(LAUNCHES)} {dict(GENERIC_LAUNCHES)}")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in st.cache.values()) // serving.n_slots
    if cache_bytes != kv_bytes_per_slot(cfg):
        raise AssertionError(f"KV bytes a slot {cache_bytes} != "
                             f"{kv_bytes_per_slot(cfg)}")
    peak = torch.cuda.max_memory_allocated()
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    http.join(30)
    emit(phase="serving", card=smi, n_slots=serving.n_slots,
         steps_per_call=serving.steps_per_call, buckets=runner.bounds,
         capture_s=capture_s, eager_ms_per_position=eager_ms,
         graph_ms_per_position=graph_ms,
         requests=[dict(wave=w, request=i, seed=seeds[i],
                        sampling=dict(zip(SamplingConfig._fields, knobs[i])),
                        ttft_s=r["ttft_s"], latency_s=r["latency_s"],
                        queue_wait_s=r["queue_wait_s"],
                        prefix_hit=r.get("prefix_hit"),
                        clip_score=r["clip_score"])
                   for w, rows in (("cold", cold), ("warm", warm))
                   for i, r in enumerate(rows)],
         wave_s=dict(cold=cold_s, warm=warm_s),
         img_per_s=dict(cold=4 / cold_s, warm=4 / warm_s),
         warm_equals_cold=True, prefix=engine.prefix_cache.stats(),
         leading_codes_equal_generate_images=leading,
         pixel_ms_per_image=pixel_ms, pixels_vs_cpu_max_abs_err=pix_err,
         kv_bytes_per_slot=cache_bytes,
         prefix_entry_bytes=prefix_entry_bytes(cfg),
         peak_mem_gb=peak / 1e9, probes=probes,
         chunk_trace=trace, launches=dict(LAUNCHES))
    del engine, pipeline, vqgan, clip, vq_cpu
    release_memory()


# matchmaking_time stays at the default 15 s: the two peers share one GIL
# with the audit's host work, and their round launches may lie a grad step
# (4-8 s) apart; a shorter window lets the earlier peer leave before the
# later one announces, which then forms a 2-peer group alone
TRAINER_COLLAB = dict(target_batch_size=16, allreduce_timeout=60,
                      average_state_every=0, wire_codec_backend="device",
                      audit_frac=1.0)
POWERSGD_COLLAB = dict(TRAINER_COLLAB, grad_compression="power_sgd",
                       powersgd_rank=4, powersgd_host_orthogonalize=True)
TRAINER_CLI = ["--preset", "flagship", "--per-device-batch", "4",
               "--grad-accum-steps", "2", "--max-epochs", "1",
               "--target-batch-size", "8", "--matchmaking-time", "3",
               "--warmup-batches", "1"]
AUDIT_WAIT_S = 240             # the last rounds' audits after the loops


def _peer_pair(torch, make_task, collab_kw, trace_round, epochs=2,
               outsider=False, helpers=None):
    """Two peers (threads of this process, loopback DHT) train ``epochs``
    epochs through ``train_loop``; with ``trace_round``, peer 0's second
    round is traced. ``make_task(peers, collab_kw, i)`` builds peer ``i``;
    with ``outsider``, a third peer (``i == 2``) joins the same DHT and
    trains as long as the pair, its rounds, reports and errors kept apart
    (``run["outsider"]``). ``helpers(address)``, when given, starts
    non-training members (averaging assistants) bootstrapped from peer 0
    before the peers train. Returns the run's record: the tasks, per-epoch
    reports, step end times, launches, peak memory and the traced
    round."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from dalle_tpu_torch.ops import (GENERIC_LAUNCHES, LAUNCHES,
                                     reset_launches)
    from dalle_tpu_torch.training.loop import train_loop

    tasks = [make_task((), collab_kw, 0)]
    for i in range(1, 3 if outsider else 2):
        tasks.append(make_task((tasks[0].dht.visible_address,), collab_kw,
                               i))
    for task in tasks:
        task.collab_optimizer          # model, optimizer state, swarm
    if helpers is not None:
        helpers(tasks[0].dht.visible_address)
    torch.cuda.synchronize()
    if trace_round:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=tasks[0].device).add_(1)   # warms it
            torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    n_peers = len(tasks)
    reports = [[] for _ in range(n_peers)]
    step_ends = [[] for _ in range(n_peers)]   # host clock after each step
    errors = [[] for _ in range(n_peers)]

    def run(i):
        collab = tasks[i].collab_optimizer

        def on_epoch(report):
            reports[i].append(dict(
                epoch=report.epoch, loss=report.loss,
                mini_steps=report.mini_steps,
                timings={k: v for k, v in collab.last_timings.items()
                         if k != "robust"},
                wire=collab.last_wire_report))

        def on_step(n, loss):
            step_ends[i].append(time.perf_counter())
        try:
            train_loop(tasks[i], max_epochs=epochs, warmup_steps=1,
                       on_epoch=on_epoch, on_step=on_step)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors[i].append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_peers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    trace = None
    collab0 = tasks[0].collab_optimizer
    if trace_round:
        # one traced round: from peer 0's first epoch to its second
        while threads[0].is_alive() and collab0.local_epoch < 1:
            time.sleep(0.05)
    if trace_round and threads[0].is_alive():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        tw = time.perf_counter()
        while threads[0].is_alive() and collab0.local_epoch < 2:
            time.sleep(0.05)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tw) * 1e3
        prof.stop()
        busy = sum(e.self_device_time_total / 1e3
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0 and e.cpu_time_total == 0)
        trace = dict(wall_ms=wall_ms, device_busy_ms=busy,
                     device_idle_share=1.0 - busy / wall_ms)
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    run_rec = dict(tasks=tasks[:2], epochs=reports[:2],
                   step_ends=step_ends[:2], wall_s=wall_s, trace=trace,
                   launches=dict(LAUNCHES), generic=dict(GENERIC_LAUNCHES),
                   peak=torch.cuda.max_memory_allocated())
    if outsider:
        run_rec["outsider"] = dict(task=tasks[2], epochs=reports[2],
                                   steps=len(step_ends[2]),
                                   errors=errors[2])
    if errors[0] or errors[1]:
        for task in tasks[::-1]:
            task.shutdown()
        raise (errors[0] or errors[1])[0]
    return run_rec


def _check_pair(torch, run, where, epochs=2, group=2, equal=True):
    """The checks every two-peer run shares: ``epochs`` epochs on both
    peers, a ``group``-member group in each (assistants count), finite
    losses, params and moments ``torch.equal`` (unless not ``equal``) and
    no generic kernel."""
    from dalle_tpu_torch.params import state_leaf_tensors
    collabs = [t.collab_optimizer for t in run["tasks"]]
    if [c.local_epoch for c in collabs] != [epochs, epochs]:
        raise AssertionError(f"{where}: epochs "
                             f"{[c.local_epoch for c in collabs]}, "
                             f"expected {epochs} on both peers")
    groups = [[e["timings"].get("group_size") for e in ep]
              for ep in run["epochs"]]
    if any(g != [group] * epochs for g in groups):
        raise AssertionError(f"{where}: group sizes {groups}, expected a "
                             f"{group}-member group in every epoch on both "
                             "peers")
    losses = [e["loss"] for ep in run["epochs"] for e in ep]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{where}: non-finite losses {losses}")
    a, b = (state_leaf_tensors(c.state.model, c.state.opt_state)
            for c in collabs)
    if equal and (len(a) != len(b)
                  or not all(torch.equal(x, y) for x, y in zip(a, b))):
        raise AssertionError(f"{where}: the peers' params or moments "
                             "differ")
    if any(run["generic"].values()):
        raise AssertionError(f"{where}: generic launches {run['generic']}")
    return collabs


def _wait_audits(collabs, parts, where):
    """Wait for each peer's auditor to finish ``parts`` challenged parts,
    then require a clean audit: no failure, omission or unserved
    transcript, and no strike in either ledger. Returns each peer's
    robustness counters and its auditor's timing."""
    deadline = time.perf_counter() + AUDIT_WAIT_S
    while time.perf_counter() < deadline and any(
            c.robustness_snapshot()["parts_audited"] < parts
            for c in collabs):
        time.sleep(0.25)
    robust = [c.robustness_snapshot() for c in collabs]
    for r in robust:
        if r["parts_audited"] < parts:
            raise AssertionError(f"{where}: {r['parts_audited']} parts "
                                 f"audited, expected {parts}: {robust}")
        bad = {k: r[k] for k in ("audit_fail", "audit_omit",
                                 "audit_unserved", "proofs_convicted",
                                 "repairs_applied") if r[k]}
        if bad:
            raise AssertionError(f"{where}: the audit convicted an honest "
                                 f"peer: {bad}")
    strikes = [c.ledger.snapshot() for c in collabs]
    if any(strikes):
        raise AssertionError(f"{where}: strikes {strikes}")
    timing = [c._auditor.timing() for c in collabs]
    return robust, timing


def _round_rows(epochs, report_of):
    """Per peer and epoch: loss, timings and the wire legs (bytes, chunks,
    longest wall) of the round's reports (``report_of(wire)`` lists them)."""
    rows = []
    for i, ep in enumerate(epochs):
        for e in ep:
            legs, phases = {}, {}
            for rep in report_of(e["wire"]):
                for row in rep.get("phases", {}).get("hops", []):
                    leg = legs.setdefault(row["leg"], dict(
                        bytes=0, wall_s=0.0, chunks=0))
                    leg["bytes"] += row["bytes"]
                    leg["chunks"] += row["chunks"]
                    leg["wall_s"] = max(leg["wall_s"], row["wall_s"])
                for k, v in rep.get("phases", {}).items():
                    if k != "hops" and isinstance(v, (int, float)):
                        phases[k] = phases.get(k, 0.0) + v
            rows.append(dict(peer=i, epoch=e["epoch"], loss=e["loss"],
                             mini_steps=e["mini_steps"],
                             timings=e["timings"], wire_phases=phases,
                             legs=legs))
    return rows


def _swarm_rate(run, batch):
    """The swarm's samples/s after both peers' first step (warmup, the
    kernels' first calls and the threads' start are behind it): the
    samples of the steps that ended between the later first step and the
    earlier last."""
    ends_all = run["step_ends"]
    t_a = max(ends[0] for ends in ends_all)
    t_b = min(ends[-1] for ends in ends_all)
    n_in = sum(1 for ends in ends_all for t in ends if t_a < t <= t_b)
    return n_in * batch / (t_b - t_a) if t_b > t_a else None


def trainer_phase(torch, smi, kernels, release_memory, dev="cuda",
                  model_overrides=None, cli_argv=TRAINER_CLI) -> None:
    """Phase 11: the trainer peer at the JAX package's swarm defaults.
    11a: two flagship peers in this process (two threads, loopback DHT)
    train two epochs through ``TrainingTask`` and ``train_loop`` with the
    trust plane on and every part of every round challenged
    (``audit_frac=1.0``); both epochs must form a 2-peer group, each peer
    must audit the other's part of both rounds with no failure and no
    strike, the peers' params and moments end ``torch.equal``, the real
    rounds launch ``wire_quantize_u8``, no generic kernel runs, the losses
    are finite. Records the round split, wire bytes, the host walls of
    the wire legs, the swarm's samples/s, peak memory, the device idle
    share of one traced round, and the audit's host seconds a round and
    its ring's peak retention. 11b: ``python -m
    dalle_tpu_torch.cli.run_trainer`` (the defaults, audit on) as a
    subprocess (one solo epoch) exits 0, and its checkpoint restores here
    (epoch 1, finite params). 11c: the same two peers with
    ``grad_compression="power_sgd"`` (rank 4, host Gram-Schmidt) for two
    epochs: both factor rounds complete in both epochs, params and moments
    end ``torch.equal``, the losses are finite; records the round
    seconds, the factor rounds' wire bytes and peak memory."""
    import shutil

    from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                        PeerConfig, TrainerConfig,
                                        flagship_model_config)
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.task import TrainingTask
    from dalle_tpu_torch.training.checkpoint import (CheckpointManager,
                                                     params_are_finite)
    from dalle_tpu_torch.training.steps import TrainState

    model_cfg = flagship_model_config(**(model_overrides or {}))
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)

    def make_task(peers, collab_kw, i):
        return TrainingTask(
            model_cfg, opt_cfg,
            TrainerConfig(per_device_batch=4, grad_accum_steps=2),
            CollabConfig(run_id="smoke", **collab_kw),
            PeerConfig(initial_peers=tuple(peers),
                       experiment_prefix="smoke"),
            device=dev)

    # -- 11a. two peers, every part audited --------------------------------
    release_memory()
    run = _peer_pair(torch, make_task, TRAINER_COLLAB, trace_round=True)
    tasks = run["tasks"]
    try:
        collabs = _check_pair(torch, run, "trainer")
        if run["launches"]["wire_quantize_u8"] <= 0:
            raise AssertionError("trainer: the rounds launched no "
                                 "wire_quantize_u8")
        robust, audit_timing = _wait_audits(collabs, 2, "trainer")
        kernels["wire_quantize_u8"]["launches"] = \
            run["launches"]["wire_quantize_u8"]
        batch = tasks[0].local_batch_size
        emit(phase="trainer_peers", card=smi, peers=2, epochs=2,
             collab=TRAINER_COLLAB, local_batch=batch,
             steps=[len(ends) for ends in run["step_ends"]],
             step_s=[[b - a for a, b in zip(ends, ends[1:])]
                     for ends in run["step_ends"]],
             wall_s=run["wall_s"],
             swarm_samples_per_s=_swarm_rate(run, batch),
             peak_mem_gb=run["peak"] / 1e9, launches=run["launches"],
             generic_launches=run["generic"],
             rounds=_round_rows(run["epochs"],
                                lambda w: [w] if w else []),
             traced_round=run["trace"], robust=robust,
             audit=[dict(t, busy_s_per_round=(
                 t["busy_s"] / t["rounds"] if t["rounds"] else None))
                 for t in audit_timing])
    finally:
        for task in tasks[::-1]:
            task.shutdown()
    del run, tasks, collabs
    release_memory()

    # -- 11b. the entry point --------------------------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = os.path.join(root, "build", "dalle_tpu_torch", "smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    metrics = os.path.join(ckpt_dir, "metrics.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "dalle_tpu_torch.cli.run_trainer",
           *cli_argv, "--checkpoint-dir", ckpt_dir, "--metrics-file",
           metrics, "--log-level", "WARNING"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"run_trainer exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    model = init_params(model_cfg, torch.Generator(device=dev).manual_seed(
        SEED + 1))
    state = TrainState.create(model, make_optimizer(opt_cfg))
    ckpt = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    restored = ckpt.restore_latest(state)
    restore_s = time.perf_counter() - t0
    ckpt.close()
    if restored is None or restored[1] != 1:
        raise AssertionError(f"run_trainer's checkpoint: restored "
                             f"{restored and restored[1]}, expected epoch 1")
    if not params_are_finite(restored[0].model):
        raise AssertionError("run_trainer's checkpoint: non-finite params")
    size = sum(os.path.getsize(os.path.join(ckpt_dir, n))
               for n in os.listdir(ckpt_dir) if n.endswith(".msgpack"))
    emit(phase="trainer_cli", card=smi, argv=cli_argv, seconds=cli_s,
         epochs=[r["epoch"] for r in rows], losses=[r["loss"] for r in rows],
         timings=rows[-1]["timings"] if rows else None,
         checkpoint_bytes=size, restore_s=restore_s,
         restored_epoch=restored[1], restored_step=restored[0].step)
    del model, state, restored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    release_memory()

    # -- 11c. PowerSGD ------------------------------------------------------
    run = _peer_pair(torch, make_task, POWERSGD_COLLAB, trace_round=False)
    tasks = run["tasks"]
    try:
        collabs = _check_pair(torch, run, "powersgd")
        factor_rounds = [[{ph: bool((e["wire"] or {}).get(ph, {}).get(
            "complete")) for ph in ("p", "q")} for e in ep]
            for ep in run["epochs"]]
        if any(not all(r.values()) for ep in factor_rounds for r in ep):
            raise AssertionError(f"powersgd: factor rounds {factor_rounds},"
                                 " expected both complete in every epoch")
        plan = collabs[0]._powersgd.plan(
            [collabs[0].state.model.get_parameter(n)
             for n in collabs[0]._names])
        robust, audit_timing = _wait_audits(collabs, 4, "powersgd")
        batch = tasks[0].local_batch_size
        emit(phase="trainer_powersgd", card=smi, peers=2, epochs=2,
             collab=POWERSGD_COLLAB, local_batch=batch,
             planned_leaves=len(plan),
             factor_elements=sum(p.m + p.n for p in plan)
             * POWERSGD_COLLAB["powersgd_rank"],
             steps=[len(ends) for ends in run["step_ends"]],
             wall_s=run["wall_s"],
             swarm_samples_per_s=_swarm_rate(run, batch),
             peak_mem_gb=run["peak"] / 1e9, launches=run["launches"],
             rounds=_round_rows(run["epochs"], lambda w: [
                 (w or {}).get(ph) or {} for ph in ("p", "q")]),
             factor_rounds=factor_rounds, robust=robust,
             audit=audit_timing)
    finally:
        for task in tasks[::-1]:
            task.shutdown()
    del run, tasks, collabs
    release_memory()


# the data, router and auth phase (12): the fixtures below are made from
# the JAX package by tests/data/make_fixtures.py
DATA_DIR = os.path.join("tests", "data")
ROUTER_PREFIX = "smoke-router"
ROUTER_DEPTH = 8               # 12b's engines: the flagship cut for time
#: 12a: each of the 3 steps closes a solo epoch (a synchronous round), so
#: each step's loss reaches the metrics file
DATA_CLI = ["--preset", "flagship", "--per-device-batch", "4",
            "--grad-accum-steps", "2", "--max-steps", "3",
            "--target-batch-size", "8", "--matchmaking-time", "2",
            "--no-delay-optimizer-step", "--warmup-batches", "1"]
#: 12c: phase 11a's pair at the default audit_frac, for one epoch
AUTH_COLLAB = {k: v for k, v in TRAINER_COLLAB.items() if k != "audit_frac"}
READ_BATCHES = 32              # steady-state batches timed in 12a
PROBES = 16                    # 12b: refused requests timed a route
#: the kernels a flagship training step launches (8-bit LAMB)
STEP_KERNELS = ("layer_norm", "line_attention", "window_attention",
                "geglu_ff", "layer_norm_bwd", "line_attention_bwd",
                "window_attention_bwd", "geglu_ff_bwd", "quantize_blockwise")


def _digest(array) -> str:
    """sha256 of an array's dtype, shape and C-order bytes (the digest
    ``tests/data/make_fixtures.py`` commits)."""
    import hashlib

    import numpy as np
    a = np.ascontiguousarray(array)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def data_phase(torch, smi, root, dev="cuda", model_overrides=None,
               cli_argv=DATA_CLI, step_kernels=STEP_KERNELS) -> None:
    """12a: real data. The port's ``prepare_data synthetic-shards --preset
    flagship`` writes 2 shards x 64 records (seed 0) whose sha256 and the
    first two batches' digests (text, image, mask; reader seed and batch
    from the golden file) must equal the JAX package's committed ones;
    the host time of the reader (first batch: the 8192-record shuffle
    buffer fills; then ms a batch of read + tokenize, and us a caption of
    tokenize alone) is recorded. Then ``run_trainer --data-path
    --tokenizer-path`` (the fixture tokenizer) trains 3 steps solo in
    this process: finite losses, every model kernel launched, no generic
    launch."""
    import hashlib
    import tempfile

    from dalle_tpu_torch.cli import prepare_data, run_trainer
    from dalle_tpu_torch.config import ModelConfig
    from dalle_tpu_torch.data.dataset import CodesDataset
    from dalle_tpu_torch.data.tokenizer import CaptionTokenizer
    from dalle_tpu_torch.ops import (GENERIC_LAUNCHES, LAUNCHES,
                                     reset_launches)

    tok_path = os.path.join(root, DATA_DIR, "tokenizer.json")
    with open(os.path.join(root, DATA_DIR, "golden_data.json")) as f:
        golden = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        shards = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        prepare_data.main(["synthetic-shards", "--out", shards,
                           *golden["shard_args"]])
        write_s = time.perf_counter() - t0
        got = {n: hashlib.sha256(open(os.path.join(shards, n), "rb").read())
               .hexdigest() for n in sorted(os.listdir(shards))}
        if got != golden["shards"]:
            raise AssertionError(f"data: shard sha256 {got} != the JAX "
                                 f"writer's {golden['shards']}")
        tokenizer = CaptionTokenizer.load(tok_path)
        ds = CodesDataset(shards, ModelConfig(), tokenizer=tokenizer)
        it = ds.batches(golden["batch"], seed=golden["seed"])
        t0 = time.perf_counter()
        first = next(it)
        first_s = time.perf_counter() - t0
        batches = [first, next(it)]
        digests = [{k: _digest(v) for k, v in b.items()} for b in batches]
        if digests != golden["batches"]:
            raise AssertionError(f"data: batch digests {digests} != the "
                                 f"JAX reader's {golden['batches']}")
        t0 = time.perf_counter()
        captions = []
        for _ in range(READ_BATCHES):
            batch = next(it)
            captions.append(batch["text"])
        read_s = (time.perf_counter() - t0) / READ_BATCHES
        texts = [tokenizer.decode(row) for b in captions for row in b]
        t0 = time.perf_counter()
        for text in texts:
            tokenizer.encode(text, ds.cfg.text_seq_len)
        caption_s = (time.perf_counter() - t0) / len(texts)

        metrics = os.path.join(tmp, "metrics.jsonl")
        overrides = [f"--{k.replace('_', '-')}={v}"
                     for k, v in (model_overrides or {}).items()]
        argv = [*cli_argv, *overrides, "--device", str(dev),
                "--data-path", shards, "--tokenizer-path", tok_path,
                "--identity-path", os.path.join(tmp, "id.pem"),
                "--metrics-file", metrics, "--log-level", "WARNING"]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rc = run_trainer.main(argv)
        train_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches, generic = dict(LAUNCHES), dict(GENERIC_LAUNCHES)
        rows = []
        if os.path.exists(metrics):
            with open(metrics) as f:
                rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    if rc != 0 or len(rows) != 3 or not all(math.isfinite(x)
                                            for x in losses):
        raise AssertionError(f"data: run_trainer rc {rc}, losses {losses} "
                             "(expected 3 solo epochs)")
    idle = [k for k in step_kernels if not launches.get(k)]
    if idle:
        raise AssertionError(f"data: run_trainer launched no {idle}: "
                             f"{launches}")
    if any(generic.values()):
        raise AssertionError(f"data: generic launches {generic}")
    emit(phase="data", card=smi, shards=golden["shards"],
         batch=golden["batch"], write_s=write_s,
         first_batch_s=first_s, read_tokenize_ms_per_batch=read_s * 1e3,
         tokenize_us_per_caption=caption_s * 1e6,
         captions_timed=len(texts), trainer_argv=cli_argv,
         trainer_s=train_s, epochs=[r["epoch"] for r in rows],
         losses=losses, launches=launches, generic_launches=generic)


def _hrw_home(fingerprint, pids):
    """The router's affinity home among ``pids``: the highest
    sha256(fingerprint + peer id) (``Router.candidates``)."""
    import hashlib
    return max(pids, key=lambda p: hashlib.sha256(
        (fingerprint + p).encode()).hexdigest())


def router_phase(torch, np, smi, root, make_model, release_memory) -> None:
    """12b: text prompts through the router. Two ``ServingHTTPServer``
    engines (phase 5b's serving config, each on its own copy of
    ``make_model()``'s model, greedy) with the fixture tokenizer, each
    advertised by a ``ServingAdvertiser`` on a loopback DHT, behind a
    ``Router`` and ``RouterHTTPServer``. Wave 1 posts three captions
    through the router together; wave 2 posts their ids (the golden ids)
    directly to the engine that served each, and the first caption again
    through the router. Each engine admits a wave's requests at one chunk
    boundary (its live clamp held at 0 until all are queued), all of them
    cold (wave 1) or all warm (wave 2: prefix hits), so a request decodes
    through the buckets it would take alone. Checks: the
    port's ids equal the golden ids, the two engines' weights are equal,
    every routed reply's codes equal the direct reply's, each caption
    (the repeated one twice) lands on its affinity home.
    Records the router's added ms before the engine's submit (TTFT) and
    in all (latency), over direct posts."""
    import threading
    import urllib.error
    import urllib.request

    from dalle_tpu_torch.config import ServingConfig
    from dalle_tpu_torch.data.tokenizer import CaptionTokenizer
    from dalle_tpu_torch.models.decode import SamplingConfig
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES
    from dalle_tpu_torch.serving import router as prouter
    from dalle_tpu_torch.serving.engine import DecodeEngine
    from dalle_tpu_torch.serving.server import ServingHTTPServer
    from dalle_tpu_torch.swarm.dht import DHT
    from dalle_tpu_torch.swarm.identity import Identity

    with open(os.path.join(root, DATA_DIR, "golden_ids.json")) as f:
        golden = json.load(f)
    captions = golden["captions"][:4]
    if captions[3] != captions[0]:
        raise AssertionError("router: golden captions 0 and 3 must repeat")
    tokenizer = CaptionTokenizer.load(os.path.join(root, DATA_DIR,
                                                   "tokenizer.json"))
    release_memory()
    serving = ServingConfig(n_slots=4, steps_per_call=8, prefix_cache_mb=256)
    nodes, engines, servers, advs, submits = [], [], [], [], {}
    router = front = None
    try:
        nodes.append(DHT(identity=Identity.generate()))
        models = [make_model() for _ in range(2)]
        for (name, a), (_, b) in zip(models[0].state_dict().items(),
                                     models[1].state_dict().items()):
            if not torch.equal(a, b):
                raise AssertionError(f"router: the engines' {name} differ")
        for e, model in enumerate(models):
            cfg = model.cfg
            ids = [tokenizer.encode(c, cfg.text_seq_len)[0].tolist()
                   for c in captions]
            if ids != golden["ids_256"][:4]:
                raise AssertionError("router: the port's caption ids differ "
                                     "from the golden ids")
            engine = DecodeEngine(model, cfg, serving,
                                  sampling=SamplingConfig(temperature=0.0))
            submit = engine.submit

            def timed_submit(text_tokens, rng=0, *a, _submit=submit, _e=e,
                             **kw):
                # every request has its own seed (greedy ignores it): it
                # names the request at the engine that admits it
                submits[int(rng)] = (_e, time.monotonic())
                return _submit(text_tokens, rng, *a, **kw)
            engine.submit = timed_submit
            engine.start()
            httpd = ServingHTTPServer(("127.0.0.1", 0), engine,
                                      tokenizer=tokenizer,
                                      request_timeout_s=600.0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            nodes.append(DHT(initial_peers=[nodes[0].visible_address],
                             identity=Identity.generate()))
            adv = prouter.ServingAdvertiser(nodes[-1], ROUTER_PREFIX, engine,
                                            url)
            adv.publish_once()
            adv.start()
            engines.append(engine)
            servers.append((httpd, url))
            advs.append(adv)
        router = prouter.Router(prouter.dht_fetch_records(
            nodes[0], ROUTER_PREFIX)).start()
        deadline = time.perf_counter() + 60
        while len(router.healthy()) < 2:
            if time.perf_counter() > deadline:
                raise AssertionError(f"router: {len(router.healthy())} of 2 "
                                     "engines discovered")
            router.refresh_once()
            time.sleep(0.2)
        by_url = {rec["url"]: pid for pid, rec in router.healthy()}
        pids = [by_url[url] for _, url in servers]
        front = prouter.RouterHTTPServer(("127.0.0.1", 0), router,
                                         request_timeout_s=600.0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        rurl = f"http://127.0.0.1:{front.server_address[1]}"

        def post(url, body, out, key):
            req = urllib.request.Request(
                url + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            with urllib.request.urlopen(req, timeout=600) as resp:
                reply = json.loads(resp.read())
            out[key] = dict(t_post=t0, t_recv=time.monotonic(),
                            row=reply["results"][0], seed=body["seed"])

        def wave(jobs, expect):
            """Post ``jobs`` together, each engine's live clamp held at 0
            until it has queued its ``expect`` requests: the requests of
            an engine decode in lockstep from their first position, as a
            request alone does (the same buckets, so the same bits)."""
            base = [e.stats()["submitted"] for e in engines]
            for e in engines:
                e.scheduler.max_live = 0
            out, threads = {}, []
            for url, body, key in jobs:
                t = threading.Thread(target=post, args=(url, body, out, key))
                t.start()
                threads.append(t)
            limit = time.monotonic() + 120
            while any(e.stats()["submitted"] < b + n
                      for e, b, n in zip(engines, base, expect)):
                if time.monotonic() > limit:
                    now = [e.stats()["submitted"] for e in engines]
                    raise AssertionError(f"router: requests never queued: "
                                         f"{now} from {base}, expected "
                                         f"{expect} more")
                time.sleep(0.002)
            for e in engines:
                e.scheduler.max_live = serving.n_slots
            for t in threads:
                t.join()
            return out

        # on an idle fleet every engine predicts the same completion, so
        # each caption goes to its affinity home
        homes = [pids.index(_hrw_home(prouter.request_fingerprint(
            {"text": c}), pids)) for c in captions]
        # wave 1: the three captions through the router (all cold); wave
        # 2: the golden ids straight to the engine that served each, and
        # the first caption again through the router (all warm: the
        # prefix pool holds each engine's captions). One admission
        # boundary and one state (cold or warm) an engine and wave: every
        # request decodes through the buckets it would take alone
        waves = ([(rurl, {"text": c, "seed": 100 + i}, f"r{i}", homes[i])
                  for i, c in enumerate(captions[:3])],
                 [(servers[homes[i]][1], {"tokens": ids[i],
                                          "seed": 200 + i}, f"d{i}",
                   homes[i]) for i in range(3)]
                 + [(rurl, {"text": captions[3], "seed": 103}, "r3",
                     homes[3])])
        walls, res = [], {}
        for jobs in waves:
            t_wave = time.perf_counter()
            res.update(wave([j[:3] for j in jobs],
                            [sum(j[3] == e for j in jobs) for e in range(2)]))
            walls.append(time.perf_counter() - t_wave)
        # which engine served each request, and when it was submitted
        served = {}
        for key, r in res.items():
            r["engine"], r["t_submit"] = submits[r["seed"]]
            served[key] = r["engine"]
        detail = {k: dict(engine=r["engine"], ttft_s=r["row"]["ttft_s"],
                          codes_head=r["row"]["codes"][:8])
                  for k, r in sorted(res.items())}
        if [served[f"r{i}"] for i in range(4)] != homes:
            raise AssertionError(f"router: captions served by engines "
                                 f"{[served[f'r{i}'] for i in range(4)]}, "
                                 f"their homes are {homes}: {detail}")
        for i in range(4):
            codes = res[f"r{i}"]["row"]["codes"]
            want = res[f"d{i % 3}"]["row"]["codes"]
            if codes != want:
                diff = sum(a != b for a, b in zip(codes, want))
                raise AssertionError(f"router: caption {i}'s routed codes "
                                     f"differ from the direct tokens post "
                                     f"at {diff} of {len(codes)} positions:"
                                     f" {detail}")
            if len(codes) != cfg.image_seq_len or not all(
                    0 <= c < cfg.vocab_image for c in codes):
                raise AssertionError(f"router: caption {i}'s codes out of "
                                     "range")
        stats = router.stats()

        # the router's own cost: requests the engine refuses at submit (a
        # negative temperature, 400) cost no decode, so the host ms from
        # post to the engine's submit (what the router adds to TTFT) and
        # from post to reply (to latency) compare routed and direct posts
        # of the same caption, in turns
        def probe(url, seed):
            req = urllib.request.Request(url + "/generate", data=json.dumps(
                {"text": captions[0], "seed": seed, "temperature": -1.0}
            ).encode(), headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            try:
                urllib.request.urlopen(req, timeout=60).close()
                code = 200
            except urllib.error.HTTPError as e:
                e.close()
                code = e.code
            t1 = time.monotonic()
            if code != 400 or seed not in submits:
                raise AssertionError(f"router: probe {seed} got {code}, "
                                     "expected the engine's 400")
            return (submits[seed][1] - t0) * 1e3, (t1 - t0) * 1e3
        probes = {"router": [], "direct": []}
        routes = [("router", rurl), ("direct", servers[homes[0]][1])]
        for k in range(PROBES):
            for n, (kind, url) in enumerate(routes[::-1] if k % 2
                                            else routes):
                probes[kind].append(probe(url, 1000 + 2 * k + n))
        added_ttft = float(np.median([p for p, _ in probes["router"]])
                           - np.median([p for p, _ in probes["direct"]]))
        added_total = float(np.median([t for _, t in probes["router"]])
                            - np.median([t for _, t in probes["direct"]]))
        if any(GENERIC_LAUNCHES.values()):
            raise AssertionError(f"router: generic launches "
                                 f"{dict(GENERIC_LAUNCHES)}")
        emit(phase="router", card=smi, engines=2, serving=dict(
            n_slots=serving.n_slots, steps_per_call=serving.steps_per_call,
            prefix_cache_mb=serving.prefix_cache_mb), captions=captions,
            served=served, homes=homes, wave_s=walls,
            ttft_s={k: r["row"]["ttft_s"] for k, r in res.items()},
            latency_s={k: r["row"]["latency_s"] for k, r in res.items()},
            probe_ms={k: [dict(to_submit=p, to_reply=t) for p, t in v]
                      for k, v in probes.items()},
            router_added_ttft_ms=added_ttft,
            router_added_latency_ms=added_total,
            ledger=stats["ledger"], per_engine=stats["per_engine"])
    finally:
        if front is not None:
            front.shutdown()
            front.server_close()
        if router is not None:
            router.stop()
        for adv in advs:
            adv.stop()
        for httpd, _ in servers:
            httpd.shutdown()
            httpd.server_close()
        for engine in engines:
            engine.stop()
        for node in nodes[::-1]:
            node.shutdown()
    del engines, models
    release_memory()


def auth_phase(torch, smi, release_memory, dev="cuda",
               model_overrides=None) -> None:
    """12c: access tokens. Phase 11a's pair (micro-batch 4 x accumulation
    2, the 8-bit LAMB) at the default ``audit_frac`` for one epoch, with
    an ``auth_authority`` and tokens issued by the port's ``issue_token``
    CLI, and a third peer on the same DHT whose token another authority
    signed: the pair forms a 2-peer group (the third never enters it),
    ends ``torch.equal``, finite losses, no generic launch."""
    import contextlib
    import io
    import tempfile

    from dalle_tpu_torch.cli import issue_token
    from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                        PeerConfig, TrainerConfig,
                                        flagship_model_config)
    from dalle_tpu_torch.swarm.identity import Identity
    from dalle_tpu_torch.task import TrainingTask

    model_cfg = flagship_model_config(**(model_overrides or {}))
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        def authority_hex(key):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                issue_token.main(["--authority-key", path(key),
                                  "--print-public-key"])
            return out.getvalue().strip()
        authority = authority_hex("authority.pem")
        authority_hex("rogue.pem")
        for i, key in enumerate(["authority.pem", "authority.pem",
                                 "rogue.pem"]):
            Identity.load_or_create(path(f"peer{i}.pem"))
            with contextlib.redirect_stdout(io.StringIO()):
                rc = issue_token.main([
                    "--authority-key", path(key), "--username", f"peer{i}",
                    "--peer-identity", path(f"peer{i}.pem"), "--ttl", "3600",
                    "--out", path(f"peer{i}.token")])
            if rc != 0:
                raise AssertionError(f"auth: issue_token exited {rc}")

        def make_task(peers, collab_kw, i):
            if i == 2:
                # the outsider's rounds never complete: its own budget is
                # short, so it falls back and stops soon after the pair
                collab_kw = dict(collab_kw, allreduce_timeout=10)
            return TrainingTask(
                model_cfg, opt_cfg,
                TrainerConfig(per_device_batch=4, grad_accum_steps=2),
                CollabConfig(run_id="smoke-auth", **collab_kw),
                PeerConfig(initial_peers=tuple(peers),
                           experiment_prefix="smoke-auth",
                           identity_path=path(f"peer{i}.pem"),
                           auth_authority=authority,
                           auth_token_path=path(f"peer{i}.token")),
                device=dev)

        release_memory()
        run = _peer_pair(torch, make_task, AUTH_COLLAB, trace_round=False,
                         epochs=1, outsider=True)
        tasks = run["tasks"] + [run["outsider"]["task"]]
        try:
            collabs = _check_pair(torch, run, "auth", epochs=1)
            rounds = _round_rows(run["epochs"], lambda w: [w] if w else [])
            rogue = tasks[2].dht.peer_id
            outsider = run["outsider"]
            if outsider["errors"]:
                raise AssertionError(f"auth: the third peer raised "
                                     f"{outsider['errors'][0]!r}")
            emit(phase="auth", card=smi, peers=2, outsider=1, epochs=1,
                 collab=AUTH_COLLAB, wall_s=run["wall_s"], rounds=rounds,
                 outsider_steps=outsider["steps"],
                 outsider_epochs=[dict(epoch=e["epoch"], loss=e["loss"],
                                       group_size=e["timings"].get(
                                           "group_size"))
                                  for e in outsider["epochs"]],
                 rogue_peer=rogue[:16], launches=run["launches"],
                 generic_launches=run["generic"],
                 peak_mem_gb=run["peak"] / 1e9,
                 robust=[c.robustness_snapshot() for c in collabs])
        finally:
            for task in tasks[::-1]:
                task.shutdown()
    del run, tasks
    release_memory()
    return rounds


# -- 13: the stacked dense_scan layout, the averaging assistant and the aux
# peer, fault injection ------------------------------------------------------

#: the dense flagship (``scripts/config_bench.py``'s "dense" row): 64
#: independent layers, the body's 63 in 16 stacked repetitions of 4 (the
#: last repetition's block_3 slice is the overhang) plus block_wconv
DENSE_FLAGSHIP = dict(shared_block_cycle=0, remat_skip_blocks=0,
                      scan_unroll=1, dense_scan=True)
DENSE_STEPS = 4                # 8-bit LAMB steps of the dense flagship
DENSE_QUANTIZED = 45           # its leaves with >= 65536 elements, of 81
DENSE_PARAMS = 1_133_068_288
DENSE_DECODE_ROWS = 2          # image rows decoded after the text in 13a
#: the checkpoint round trip runs at this depth (body 7: two repetitions
#: of 4 with one overhang slice, and block_wconv): the full dense state's
#: ~5.7 GB file would take much of the script's time limit to write and read
DENSE_CKPT_DEPTH = 8
#: 13b: phase 12c's pair settings; the state server sends f32 leaves, so
#: that the aux peer's archive equals the trainers' state bit for bit
ASSIST_COLLAB = dict(AUTH_COLLAB, state_compression="none")
#: 13c: the pair and two assistants under fault plans, one epoch; a
#: shorter all-reduce budget bounds the wait on the crashed assistant
CHAOS_COLLAB = dict(AUTH_COLLAB, allreduce_timeout=30)
DELAY_DUP_PLAN = {"seed": 5, "rules": [{"ops": ["send"], "duplicate": 1.0,
                                        "delay_s": [0.0, 0.02]}]}
CORRUPT_PLAN = {"seed": 9, "rules": [{"ops": ["send"], "corrupt": 1.0}]}
CRASH_PLAN = {"seed": 1, "crash_at_epoch": 0}


def dense_phase(torch, smi, release_memory, dev="cuda", model_overrides=None,
                decode_rows=DENSE_DECODE_ROWS) -> dict:
    """13a: the dense flagship in the stacked ``dense_scan`` layout at
    full width and depth through ``train_entry`` (random weights from the
    seed, micro-batch 4 x accumulation 2, the 8-bit LAMB): its 8-bit state
    quantizes the 45 leaves of at least ``min_8bit_size`` elements, the
    stacked FF biases among them (2 x 45 ``quantize_blockwise`` at init and
    a step); one ``grad_step``'s gradient of the overhang slices is
    exactly 0 and every other slice's is not; ``DENSE_STEPS`` steps with
    the exact launch counts of the schedule and no generic launch, finite
    losses that fall once the learning rate leaves 0, and no layer view
    holding its slices between steps (the memory allocated after each step
    is recorded beside the state's bytes); teacher-forced
    cached decode of the trained model over the text and
    ``decode_rows`` image rows within phase 4's 2^-4 of the logit range;
    and, at ``DENSE_CKPT_DEPTH``, a checkpoint of a stepped 8-bit state
    that restores ``torch.equal``. Returns the launch counts of the
    steps."""
    import tempfile

    from dalle_tpu_torch.config import OptimizerConfig, flagship_model_config
    from dalle_tpu_torch.entry import train_entry
    from dalle_tpu_torch.models.decode import (decode_step, decode_tables,
                                               init_cache)
    from dalle_tpu_torch.models.transformer import wrapper_calls
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import apply_updates, make_optimizer
    from dalle_tpu_torch.params import state_leaf_tensors
    from dalle_tpu_torch.training.checkpoint import CheckpointManager
    from dalle_tpu_torch.training.steps import TrainState, grad_step

    overrides = dict(DENSE_FLAGSHIP, **(model_overrides or {}))
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    step, (state, batch) = train_entry(device=dev, micro=MICRO, accum=ACCUM,
                                       seed=SEED, state_bits=8, **overrides)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state.model
    cfg = model.cfg
    reps, group = cfg.dense_scan_reps(), len(cfg.attn_types)
    body = cfg.depth - (1 if cfg.final_conv_block else 0)
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves = len(list(model.parameters()))
    quantized = sorted(n for n, m in state.opt_state.mu.items()
                       if isinstance(m, Quantized))
    n_q = len(quantized)
    if model_overrides is None and (reps != 16 or n_params != DENSE_PARAMS
                                    or n_q != DENSE_QUANTIZED):
        raise AssertionError(f"dense: {reps} repetitions, {n_params} "
                             f"parameters, {n_q} quantized leaves; expected "
                             f"16, {DENSE_PARAMS}, {DENSE_QUANTIZED}")
    stacked_biases = [n for n in quantized if n.endswith(("ff.wi.bias",
                                                          "ff.gate.bias"))]
    if model_overrides is None and len(stacked_biases) != 2 * group:
        raise AssertionError(f"dense: quantized FF biases {stacked_biases}")
    if dict(LAUNCHES) != dict.fromkeys(LAUNCHES, 0) | {
            "quantize_blockwise": 2 * n_q}:
        raise AssertionError(f"dense: 8-bit LAMB init launches "
                             f"{dict(LAUNCHES)}, expected 2 x {n_q}")

    # the overhang: slices of the last repetition no layer reads
    overhang = [u for u in range(group) if (reps - 1) * group + u >= body]
    _, _, grads = grad_step(model, batch, ACCUM)
    zero, live = [], []       # per stacked leaf: overhang nonzero, live ok
    for name, g in grads.items():
        if not name.startswith("transformer.blocks.block_") \
                or "wconv" in name:
            continue
        if int(name.split(".")[2].split("_")[1]) in overhang:
            zero.append(bool(g[reps - 1].any()))
        live.append(all(bool(g[r].any()) for r in range(reps - 1)))
    if not overhang or any(zero) or not all(live):
        raise AssertionError(f"dense: overhang blocks {overhang}: nonzero "
                             f"{sum(zero)} of {len(zero)} overhang "
                             f"gradients, {live.count(False)} stacked "
                             "leaves with an all-zero live slice")
    del grads

    per_micro = wrapper_calls(cfg, training=True)
    expected = {k: ACCUM * v for k, v in per_micro.items()} | {
        "quantize_blockwise": 2 * n_q}
    losses, norms, step_s, between = [], [], [], []
    for i in range(DENSE_STEPS):
        torch.cuda.synchronize()
        if i == 0:
            reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        between.append(torch.cuda.memory_allocated())
        if i == 0:
            launches = dict(LAUNCHES)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if launches != expected:
        raise AssertionError(f"dense: launch counts {launches} != "
                             f"{expected}")
    if LAUNCHES["quantize_blockwise"] != DENSE_STEPS * 2 * n_q:
        raise AssertionError(f"dense: {LAUNCHES['quantize_blockwise']} "
                             f"quantize_blockwise launches in {DENSE_STEPS} "
                             f"steps, expected {DENSE_STEPS} x 2 x {n_q}")
    if any(GENERIC_LAUNCHES.values()):
        raise AssertionError(f"dense: generic launches "
                             f"{dict(GENERIC_LAUNCHES)}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"dense: non-finite loss or grad_norm: "
                             f"{losses}, {norms}")
    # step 1 has learning rate 0: steps 1 and 2 see the same weights
    if not (abs(losses[1] - losses[0]) <= SAME_LOSS * abs(losses[0])
            and all(losses[i + 1] < losses[i]
                    for i in range(1, DENSE_STEPS - 1))):
        raise AssertionError(f"dense: the loss does not fall: {losses}")
    peak = torch.cuda.max_memory_allocated()
    steady = step_s[1:]
    all_launches = dict(LAUNCHES)
    # between steps only the state (and the batch) is allocated: no layer
    # view keeps its slices, nor the cast copy they view
    state_bytes = sum(t.numel() * t.element_size() for t in
                      state_leaf_tensors(model, state.opt_state))
    held = [n for views in model.transformer._views for v in views
            for n, _ in v.named_parameters()]
    if held:
        raise AssertionError(
            f"dense: the layer views hold {len(held)} slices between steps;"
            f" allocated between steps {[b / 1e9 for b in between]} GB, "
            f"the state {state_bytes / 1e9} GB")

    # teacher-forced cached decode of the trained stacked model
    T, TT, G = cfg.total_seq_len, cfg.text_seq_len, cfg.image_grid
    n_pos = min(T, TT + decode_rows * G)
    text, image = batch["text"][:1], batch["image"][:1]
    with torch.inference_mode():
        _, _, logits = model(text, image, return_logits=True)
        logits = logits[:, :n_pos]
        labels = torch.cat([text, image + cfg.vocab_text], 1)
        inputs = torch.cat([torch.full((1, 1), cfg.vocab_total, device=dev,
                                       dtype=labels.dtype),
                            labels[:, :-1]], 1)
        cache = init_cache(cfg, 1, dev)
        tables = decode_tables(cfg, dev)
        t0 = time.perf_counter()
        got = torch.stack([decode_step(model, cache, inputs[:, p], p,
                                       tables)[0]
                           for p in range(n_pos)], 1)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    valid = logits > -1e8
    diff = (got - logits).abs()[valid].max().item()
    scale = logits[valid].abs().max().item()
    dec_tol = 2 ** -4 * scale
    agree = (got.argmax(-1) == logits.argmax(-1)).float().mean().item()
    if not (diff <= dec_tol and agree >= ARGMAX_AGREE):
        raise AssertionError(f"dense: cached decode vs forward: max |diff| "
                             f"{diff} (tolerance {dec_tol}), argmax "
                             f"agreement {agree:.3f}")
    del state, step, batch, model, cache, logits, got, metrics
    release_memory()

    # a stepped 8-bit state through a checkpoint, at DENSE_CKPT_DEPTH
    small = dict(overrides, depth=DENSE_CKPT_DEPTH)
    _, (ck_state, ck_batch) = train_entry(device=dev, micro=1, accum=1,
                                          seed=SEED, state_bits=8, **small)
    ck_cfg = ck_state.model.cfg
    tx = make_optimizer(OptimizerConfig(
        warmup_steps=2, total_steps=100,
        stacked_reps=ck_cfg.dense_scan_reps()))
    for _ in range(2):
        _, _, g = grad_step(ck_state.model, ck_batch, 1)
        updates, ck_state.opt_state = tx.update(g, ck_state.opt_state,
                                                ck_state.model)
        apply_updates(ck_state.model, updates)
        ck_state.step += 1
    with tempfile.TemporaryDirectory(dir=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build")) as tmp:
        mgr = CheckpointManager(tmp, async_writes=False)
        t0 = time.perf_counter()
        path = mgr.save(ck_state, 2)
        save_s = time.perf_counter() - t0
        ck_bytes = os.path.getsize(path)
        _, (template, _) = train_entry(device=dev, micro=1, accum=1,
                                       seed=SEED + 1, state_bits=8, **small)
        t0 = time.perf_counter()
        restored = mgr.restore_latest(template)
        restore_s = time.perf_counter() - t0
    if restored is None or restored[1] != 2 or restored[0].step != 2:
        raise AssertionError(f"dense: checkpoint restored "
                             f"{restored and (restored[1], restored[0].step)}"
                             ", expected epoch 2, step 2")
    a = state_leaf_tensors(ck_state.model, ck_state.opt_state)
    b = state_leaf_tensors(restored[0].model, restored[0].opt_state)
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("dense: the restored checkpoint differs")
    emit(phase="dense_scan", card=smi, config=overrides,
         stacked_reps=reps, overhang_blocks=[f"block_{u}" for u in overhang],
         params=n_params, leaves=n_leaves,
         quantized_leaves=n_q, stacked_quantized_biases=stacked_biases,
         micro=MICRO, accum=ACCUM, steps=DENSE_STEPS, init_s=init_s,
         losses=losses, grad_norms=norms, launches=launches,
         launches_all_steps=all_launches, step_s=step_s,
         step_s_mean=sum(steady) / len(steady),
         img_per_s=MICRO * ACCUM * len(steady) / sum(steady),
         peak_mem_gb=peak / 1e9,
         between_steps_gb=[b / 1e9 for b in between],
         state_gb=state_bytes / 1e9, decode_positions=n_pos,
         decode_max_abs_err=diff, decode_tolerance=dec_tol,
         decode_argmax_agreement=agree, decode_s=dec_s,
         checkpoint_depth=DENSE_CKPT_DEPTH, checkpoint_bytes=ck_bytes,
         checkpoint_save_s=save_s, checkpoint_restore_s=restore_s)
    del ck_state, template, restored, a, b
    release_memory()
    return launches


def _crashing_assistant(dht, cfg, n_elements, epoch, out):
    """An assistant whose transport dies at ``epoch`` (its ``ChaosDHT``'s
    ``crash_at_epoch``) right after it joined the round's group: it owns a
    part it never serves, as a dead owner does."""
    import numpy as np

    from dalle_tpu_torch.swarm.allreduce import run_allreduce
    from dalle_tpu_torch.swarm.matchmaking import make_group

    prefix = f"{cfg.run_id}_grads"
    group = make_group(dht, prefix, epoch, weight=0.0,
                       matchmaking_time=cfg.matchmaking_time,
                       min_group_size=2, encrypt=cfg.encrypt_data_plane)
    out["group_size"] = group.size if group is not None else 1
    out["crashed"] = dht.note_epoch(epoch)
    if group is not None and group.size > 1:
        report = {}
        run_allreduce(dht, group, prefix, epoch,
                      [np.zeros(n_elements, np.float32)], weight=0.0,
                      allreduce_timeout=cfg.allreduce_timeout,
                      report=report)
        out["reduced_senders"] = report.get("reduced_senders")


def assist_chaos_phase(torch, smi, release_memory, without_rounds,
                       dev="cuda", model_overrides=None) -> None:
    """13b: phase 12c's pair (the phase 8 step, the device codec) plus an
    ``AveragingAssistant`` on an aux peer's ``TrainingTask`` (as
    ``run_aux_peer --assist-in-averaging`` builds it), one epoch: both
    trainers form a 3-member group whose parts the assistant shares, the
    assistant assists, the pair ends ``torch.equal``, and the aux peer's
    archive of the swarm state (``run_aux_peer.archive_state``) restores
    ``torch.equal`` to the trainers' state; the round's all-reduce seconds
    and bytes a leg are recorded beside 12c's (``without_rounds``). 13c:
    the pair under seeded fault plans with an honest assistant and one
    whose transport crashes at epoch 0 after matchmaking, one epoch:
    delay and duplicate on the lower peer's sends (the leader), corrupt on
    the higher's; both trainers and the crashed assistant's round end the
    epoch (no hang), the leader's
    round names the corrupt sender and its ledger strikes it, the round
    reports incomplete, and every fault fired."""
    import tempfile

    from dalle_tpu_torch.cli.run_aux_peer import archive_state
    from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                        PeerConfig, TrainerConfig,
                                        flagship_model_config)
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.params import state_leaf_tensors
    from dalle_tpu_torch.swarm.assist import (AveragingAssistant,
                                              grad_flat_elements)
    from dalle_tpu_torch.swarm.chaos import ChaosDHT, FaultPlan
    from dalle_tpu_torch.swarm.dht import DHT
    from dalle_tpu_torch.swarm.identity import Identity
    from dalle_tpu_torch.swarm.metrics import make_validators
    from dalle_tpu_torch.task import TrainingTask
    from dalle_tpu_torch.training.checkpoint import CheckpointManager
    from dalle_tpu_torch.training.steps import TrainState

    model_cfg = flagship_model_config(**(model_overrides or {}))
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    root = os.path.dirname(os.path.abspath(__file__))

    # -- 13b. the averaging assistant and the aux peer's archive ----------
    run_id = "smoke-assist"
    collab_cfg = CollabConfig(run_id=run_id, **ASSIST_COLLAB)

    def make_task(peers, collab_kw, i):
        return TrainingTask(
            model_cfg, opt_cfg,
            TrainerConfig(per_device_batch=4, grad_accum_steps=2),
            CollabConfig(run_id=run_id, **collab_kw),
            PeerConfig(initial_peers=tuple(peers), experiment_prefix=run_id),
            device=dev)

    helpers = {}

    def start_aux(address):
        aux = TrainingTask(model_cfg, opt_cfg, TrainerConfig(), collab_cfg,
                           PeerConfig(initial_peers=(address,),
                                      experiment_prefix=run_id),
                           device=dev)
        helpers["aux"] = aux
        helpers["assistant"] = AveragingAssistant(
            aux.dht, collab_cfg, model_cfg, authorizer=aux.authorizer)
        helpers["assistant"].start()

    release_memory()
    run = _peer_pair(torch, make_task, ASSIST_COLLAB, trace_round=False,
                     epochs=1, helpers=start_aux)
    tasks = run["tasks"]
    aux, assistant = helpers["aux"], helpers["assistant"]
    try:
        collabs = _check_pair(torch, run, "assist", epochs=1, group=3)
        deadline = time.perf_counter() + 60
        while assistant.rounds_assisted < 1 \
                and time.perf_counter() < deadline:
            time.sleep(0.25)
        if assistant.rounds_assisted < 1:
            raise AssertionError("assist: the assistant never assisted")
        parts = [sorted({row["part"] for row in
                         (c.last_wire_report or {}).get("phases", {})
                         .get("hops", [])}) for c in collabs]
        if any(len(p) != 3 for p in parts):
            raise AssertionError(f"assist: the trainers' rounds touched "
                                 f"parts {parts}, expected 3 (the "
                                 "assistant owns one)")
        assistant.stop(join_timeout=collab_cfg.matchmaking_time
                       + collab_cfg.allreduce_timeout + 5)
        with tempfile.TemporaryDirectory(dir=os.path.join(root,
                                                          "build")) as tmp:
            mgr = CheckpointManager(tmp, async_writes=False)
            t0 = time.perf_counter()
            epoch = archive_state(aux, collab_cfg, mgr)
            archive_s = time.perf_counter() - t0
            if epoch != 1:
                raise AssertionError(f"assist: the aux peer archived epoch "
                                     f"{epoch}, expected 1")
            archive_bytes = sum(os.path.getsize(os.path.join(tmp, n))
                                for n in os.listdir(tmp))
            template = TrainState.create(
                init_params(model_cfg, torch.Generator(
                    device=dev).manual_seed(SEED + 2)),
                make_optimizer(opt_cfg))
            restored = mgr.restore_latest(template)
        if restored is None or restored[1] != 1:
            raise AssertionError("assist: the archive does not restore")
        got = state_leaf_tensors(restored[0].model, restored[0].opt_state)
        want = state_leaf_tensors(collabs[0].state.model,
                                  collabs[0].state.opt_state)
        if len(got) != len(want) or not all(
                torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError("assist: the archive differs from the "
                                 "trainers' state")
        emit(phase="assist", card=smi, peers=2, assistants=1, epochs=1,
             collab=ASSIST_COLLAB, wall_s=run["wall_s"],
             grad_elements=grad_flat_elements(model_cfg),
             rounds_assisted=assistant.rounds_assisted, parts=parts,
             rounds=_round_rows(run["epochs"], lambda w: [w] if w else []),
             rounds_without_assistant=without_rounds,
             archive_s=archive_s, archive_bytes=archive_bytes,
             launches=run["launches"], generic_launches=run["generic"],
             peak_mem_gb=run["peak"] / 1e9)
    finally:
        assistant.stop(join_timeout=collab_cfg.matchmaking_time
                       + collab_cfg.allreduce_timeout + 5)
        for task in tasks[::-1] + [aux]:
            task.shutdown()
    del run, tasks, aux, assistant, collabs, got, want, restored, template
    release_memory()

    # -- 13c. fault injection ----------------------------------------------
    run_id = "smoke-chaos"
    collab_cfg = CollabConfig(run_id=run_id, **CHAOS_COLLAB)
    with tempfile.TemporaryDirectory() as tmp:
        pems = [os.path.join(tmp, f"peer{i}.pem") for i in range(2)]
        pids = [Identity.load_or_create(p).node_id.hex() for p in pems]
        bad = pids.index(max(pids))     # the leader (lowest id) is honest
        plans = [json.dumps(CORRUPT_PLAN if i == bad else DELAY_DUP_PLAN)
                 for i in range(2)]

        def make_chaos_task(peers, collab_kw, i):
            return TrainingTask(
                model_cfg, opt_cfg,
                TrainerConfig(per_device_batch=4, grad_accum_steps=2),
                CollabConfig(run_id=run_id, chaos_plan=plans[i],
                             **collab_kw),
                PeerConfig(initial_peers=tuple(peers),
                           experiment_prefix=run_id, identity_path=pems[i]),
                device=dev)

        helpers = {}

        def assistant_dht(address):
            # the trainers sign their records: read them as a TrainingTask
            # peer does, through the record validators
            ident = Identity.generate()
            return DHT(initial_peers=[address], identity=ident,
                       record_validators=make_validators(ident, run_id))

        def start_assistants(address):
            import threading
            honest = assistant_dht(address)
            crash = ChaosDHT(assistant_dht(address),
                             FaultPlan.from_dict(CRASH_PLAN))
            helpers["dhts"] = [honest, crash]
            helpers["assistant"] = AveragingAssistant(honest, collab_cfg,
                                                      model_cfg)
            helpers["assistant"].start()
            helpers["crash"] = {}
            helpers["crash_thread"] = threading.Thread(
                target=_crashing_assistant,
                args=(crash, collab_cfg, grad_flat_elements(model_cfg), 0,
                      helpers["crash"]))
            helpers["crash_thread"].start()

        release_memory()
        t0 = time.perf_counter()
        run = _peer_pair(torch, make_chaos_task, CHAOS_COLLAB,
                         trace_round=False, epochs=1,
                         helpers=start_assistants)
        tasks = run["tasks"]
        try:
            helpers["crash_thread"].join(timeout=120)
            if helpers["crash_thread"].is_alive() \
                    or "reduced_senders" not in helpers["crash"]:
                raise AssertionError(
                    "chaos: the crashed assistant's round did not end "
                    f"within 120 s: {helpers['crash']}")
            chaos_s = time.perf_counter() - t0
            collabs = _check_pair(torch, run, "chaos", epochs=1, group=4,
                                  equal=False)
            good = 1 - bad
            report = collabs[good].last_wire_report or {}
            blamed = (set(report.get("corrupt_senders", []))
                      | set(report.get("timeout_senders", [])))
            if report.get("complete") is not False or pids[bad] not in blamed:
                raise AssertionError(
                    f"chaos: the leader's round {dict(complete=report.get('complete'), corrupt=report.get('corrupt_senders'), timeout=report.get('timeout_senders'))}"
                    f" does not name the corrupt sender {pids[bad][:16]}")
            strike = collabs[good].ledger.score(pids[bad])
            if not strike > 0:
                raise AssertionError("chaos: the corrupt sender was not "
                                     "struck")
            injected = [dict(t.dht.injected) for t in tasks]
            crash_dht = helpers["dhts"][1]
            if not (injected[good].get("delay") and
                    injected[good].get("duplicate") and
                    injected[bad].get("corrupt") and
                    crash_dht.injected.get("crash") == 1 and
                    helpers["crash"].get("group_size") == 4):
                raise AssertionError(f"chaos: faults injected {injected}, "
                                     f"crash {crash_dht.injected}, the "
                                     f"crashed assistant {helpers['crash']}")
            emit(phase="chaos", card=smi, peers=2, assistants=2, epochs=1,
                 collab=CHAOS_COLLAB, plans=dict(
                     leader=DELAY_DUP_PLAN, corrupt=CORRUPT_PLAN,
                     assistant=CRASH_PLAN),
                 wall_s=chaos_s, injected=injected,
                 crashed_assistant=dict(helpers["crash"],
                                        injected=crash_dht.injected),
                 honest_assistant_rounds=helpers["assistant"]
                 .rounds_assisted,
                 leader_report=dict(
                     complete=report.get("complete"),
                     corrupt_senders=[p[:16] for p in
                                      report.get("corrupt_senders", [])],
                     timeout_senders=[p[:16] for p in
                                      report.get("timeout_senders", [])]),
                 strike_score=strike,
                 rounds=_round_rows(run["epochs"],
                                    lambda w: [w] if w else []),
                 launches=run["launches"], generic_launches=run["generic"],
                 peak_mem_gb=run["peak"] / 1e9)
        finally:
            helpers["assistant"].stop(join_timeout=collab_cfg
                                      .matchmaking_time
                                      + collab_cfg.allreduce_timeout + 5)
            helpers["crash_thread"].join(timeout=120)
            for task in tasks[::-1]:
                task.shutdown()
            for node in helpers["dhts"][::-1]:
                node.shutdown()
    del run, tasks
    release_memory()


# -- 14: save_ctx remat, host-offloaded optimizer state, multi-process peers
# ---------------------------------------------------------------------------

XL_STEPS = 4                   # 8-bit steps of XL under save_ctx (14a)
OFFLOAD_UPDATES = 4            # updates with and without offload (14b)
OFFLOAD_MEM_TOL = 0.05e9       # 14b: the between-steps memory saving
                               # against the state's bytes, in bytes
#: 14c: the CLI on XL with both memory switches, solo: every grad step of
#: 8 samples is an epoch; the schedule leaves lr 0 after the first update
XL_CLI = ["--preset", "xl", "--remat-policy", "save_ctx", "--offload",
          "--per-device-batch", str(MICRO), "--grad-accum-steps",
          str(ACCUM), "--max-epochs", "4", "--target-batch-size", "8",
          "--matchmaking-time", "3", "--warmup-batches", "1",
          "--warmup-steps", "2", "--total-steps", "100",
          "--backup-every-epochs", "2"]
#: 14d: the slice's processes and the one-process peer, with the JAX
#: defaults but the target (16 for 4096) and the run id
SLICE_COLLAB = dict(run_id="slice", target_batch_size=16)
SLICE_EPOCHS = 2
SLICE_TIMEOUT_S = 600          # each child of 14d, start to exit

SLICE_CHILD = r"""
import datetime, hashlib, json, os, sys, time
import torch
role, gloo_port, dht_port, tmp, dev = sys.argv[1:6]
overrides, collab_kw = json.loads(sys.argv[6]), json.loads(sys.argv[7])
epochs, trainer_kw = int(sys.argv[8]), json.loads(sys.argv[9])
opt_kw = json.loads(sys.argv[10])


def wait_for(path, timeout=240):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise SystemExit(f"{role}: no {path} after {timeout} s")
        time.sleep(0.1)


if role != "peer":
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{gloo_port}", world_size=2,
        rank=int(role), timeout=datetime.timedelta(seconds=300))
from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                    PeerConfig, TrainerConfig,
                                    flagship_model_config)
from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
from dalle_tpu_torch.parallel import collectives
from dalle_tpu_torch.task import TrainingTask
from dalle_tpu_torch.training.loop import train_loop, warmup

coordinator = role == "0"
peer = PeerConfig(port=int(dht_port) if coordinator else 0,
                  initial_peers=((f"127.0.0.1:{dht_port}",)
                                 if role == "peer" else ()),
                  identity_path=f"{tmp}/id_{role}.pem",
                  experiment_prefix="smoke")
task = TrainingTask(flagship_model_config(**overrides),
                    OptimizerConfig(warmup_steps=2, total_steps=100,
                                    **opt_kw),
                    TrainerConfig(per_device_batch=4, grad_accum_steps=2,
                                  **(trainer_kw if role != "peer" else {})),
                    CollabConfig(**collab_kw), peer, device=dev)
collab = task.collab_optimizer
open(f"{tmp}/dht_{role}", "w").close()   # the DHT is up: the peer may join
warmup(task, 1)    # the first step's setup, before the start signal
open(f"{tmp}/ready_{role}", "w").close()
wait_for(f"{tmp}/go")


def digest():
    # the whole state (a sharded slice's gathered: every process calls it)
    h = hashlib.sha256()
    for a in collab._state_leaves():
        h.update(a.tobytes())
    return h.hexdigest()


def legs(report):
    # per wire leg: bytes and chunks of the round's reports (a PowerSGD
    # round's under "p" and "q"), and each factor round's completeness
    reps = ([(report or {}).get(ph) or {} for ph in ("p", "q")]
            if report and ("p" in report or "q" in report) else
            [report or {}])
    out = {}
    for rep in reps:
        for row in (rep.get("phases") or {}).get("hops", []):
            leg = out.setdefault(row["leg"], dict(bytes=0, chunks=0))
            leg["bytes"] += int(row["bytes"])
            leg["chunks"] += int(row["chunks"])
    complete = {ph: bool(((report or {}).get(ph) or {}).get("complete"))
                for ph in ("p", "q")}
    return out, complete


rows, step_ends, mean_s = [], [], []


def on_epoch(report):
    traffic = {k: list(v) for k, v in collectives.TRAFFIC.items()}
    round_s = time.perf_counter() - step_ends[-1]
    wire, complete = legs(collab.last_wire_report)
    rows.append(dict(epoch=report.epoch, loss=report.loss,
                     mini_steps=report.mini_steps, digest=digest(),
                     round_s=round_s, gloo=traffic, wire=wire,
                     factor_rounds=complete,
                     timings={k: v for k, v in collab.last_timings.items()
                              if k != "robust"}))


def on_step(n, loss):
    step_ends.append(time.perf_counter())
    mean_s.append(task.grad_mean_s)
    collectives.reset_traffic()


if dev == "cuda":
    torch.cuda.reset_peak_memory_stats()
reset_launches()
train_loop(task, max_epochs=epochs, warmup_steps=0, on_epoch=on_epoch,
           on_step=on_step)
comp = collab._powersgd
out = dict(role=role, epoch=collab.local_epoch, epochs=rows,
           step_ends=step_ends, grad_mean_s=mean_s,
           local_batch=task.local_batch_size, sharded=task.sharded,
           ef_bytes=(sum(e.numel() * e.element_size()
                         for e in comp._errors.values()) if comp else 0),
           processes=collab.role.n_processes, launches=dict(LAUNCHES),
           generic=dict(GENERIC_LAUNCHES),
           peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                    if dev == "cuda" else None))
task.shutdown()
with open(f"{tmp}/out_{role}.json", "w") as f:
    json.dump(out, f)
if role != "peer":
    dist.destroy_process_group()
"""


def head_chunk_peaks(torch, model, run, rounds: int = 1,
                     images: int = MICRO * ACCUM) -> dict:
    """The peak memory and seconds of ``run()`` (a training step of
    ``model`` on ``images`` images) with the model's ``head_chunk`` (the
    tied head's logsumexp streamed over vocabulary chunks) and with
    ``head_chunk=0`` (the whole vocabulary's f32 logits, their log-softmax
    and gradients in one pass), each from a reset of the peak counter, in
    ``rounds`` rounds of chunked, one-pass, one-pass, chunked (one round
    of chunked, one-pass where ``rounds`` is 1), so that the host's drift
    falls on both routes alike; what the chunks save."""
    import dataclasses
    cfg = model.cfg
    order = (["head_chunk", "one_pass"] if rounds == 1 else
             ["head_chunk", "one_pass", "one_pass", "head_chunk"] * rounds)
    chunks = {"head_chunk": cfg.head_chunk, "one_pass": 0}
    out = {label: dict(head_chunk=chunk, peak_gb=0.0,
                       peak_above_start_gb=0.0, step_s=[])
           for label, chunk in chunks.items()}
    try:
        for label in order:
            model.cfg = dataclasses.replace(cfg, head_chunk=chunks[label])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            rec = out[label]
            rec["step_s"].append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            rec["peak_gb"] = max(rec["peak_gb"], peak / 1e9)
            rec["peak_above_start_gb"] = max(rec["peak_above_start_gb"],
                                             (peak - base) / 1e9)
    finally:
        model.cfg = cfg
    for rec in out.values():
        rec["step_s_mean"] = sum(rec["step_s"]) / len(rec["step_s"])
        rec["img_per_s"] = images / rec["step_s_mean"]
    out["saved_gb"] = out["one_pass"]["peak_gb"] - out["head_chunk"][
        "peak_gb"]
    return out


def head_pass_ms(torch, cfg, reps: int = 5) -> dict:
    """The tied head's loss alone, forward and backward, on one
    micro-batch at ``cfg``'s shapes (both segments; ``h`` in the
    computation dtype, the f32 table): ms by CUDA events, launch to
    finish, with ``cfg.head_chunk`` and with the one-pass route,
    alternated ``reps`` times (chunked, one-pass, one-pass, chunked ...),
    and the largest relative difference of their losses and gradients."""
    from dalle_tpu_torch.models.dalle import _segment_nll
    from dalle_tpu_torch.models.transformer import torch_dtype
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cd = torch_dtype(cfg.dtype)
    h = (torch.randn(MICRO, cfg.total_seq_len, cfg.dim, device="cuda",
                     generator=gen).to(cd).requires_grad_())
    table = (torch.randn(cfg.vocab_total, cfg.dim, device="cuda",
                         generator=gen) * 0.02).requires_grad_()
    segs = ((slice(0, cfg.text_seq_len), 0, cfg.vocab_text),
            (slice(cfg.text_seq_len, None), cfg.vocab_text, cfg.vocab_total))
    targets = [torch.randint(0, b - a, (MICRO, h[:, sl].shape[1]),
                             device="cuda", generator=gen)
               for sl, a, b in segs]

    def once(chunk):
        h.grad = table.grad = None
        loss = sum(_segment_nll(h[:, sl], table[a:b], t, chunk).sum()
                   for (sl, a, b), t in zip(segs, targets))
        loss.backward()
        return loss.detach(), h.grad, table.grad

    results = {}
    for chunk in (cfg.head_chunk, 0):            # warm both routes
        results[chunk] = once(chunk)
    diff = max(_rel_err(x, y) for x, y in zip(results[cfg.head_chunk],
                                              results[0]))
    times = {cfg.head_chunk: [], 0: []}
    for i in range(2 * reps):
        chunk = (cfg.head_chunk, 0)[(i + i // 2) % 2]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda.synchronize()
        start.record()
        once(chunk)
        end.record()
        torch.cuda.synchronize()
        times[chunk].append(start.elapsed_time(end))
    return dict(head_chunk=cfg.head_chunk, micro=MICRO,
                chunked_ms=times[cfg.head_chunk],
                chunked_ms_mean=sum(times[cfg.head_chunk]) / reps,
                one_pass_ms=times[0], one_pass_ms_mean=sum(times[0]) / reps,
                max_rel_diff=diff)


def _moment_tensors(opt_state) -> list:
    """Every tensor of the optimizer state's moments (a quantized moment's
    codes and absmax)."""
    from dalle_tpu_torch.ops.quant import Quantized
    return [t for tree in (opt_state.mu, opt_state.nu)
            for m in tree.values()
            for t in ((m.codes, m.absmax) if isinstance(m, Quantized)
                      else (m,))]


def _remat_pair(torch, name, make_cfg, release_memory, dev):
    """One ``grad_step`` of ``make_cfg(remat_policy)``'s model (weights and
    batch from the seed) under ``save_attn``, then one under ``save_ctx``:
    the loss and every gradient ``torch.equal`` (else the first leaf that
    differs, in the JAX leaf order, fails the phase), the exact launch
    counts of ``wrapper_calls`` and no generic launch. Returns ``(record
    per policy, the save_ctx model, the batch)``; a record holds the loss,
    the step's s, its peak memory and the peak above what was allocated
    before it (the parameters and the batch)."""
    from dalle_tpu_torch.data.synthetic import SyntheticCodes
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.transformer import wrapper_calls
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
    from dalle_tpu_torch.params import jax_leaf_names
    from dalle_tpu_torch.training.steps import grad_step

    release_memory()
    n = MICRO * ACCUM
    cfgs = {p: make_cfg(p) for p in ("save_attn", "save_ctx")}
    data = next(SyntheticCodes(cfgs["save_ctx"], num_samples=n,
                               seed=SEED).batches(n))
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in data.items()}
    policies, host = {}, {}
    for policy, cfg in cfgs.items():
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED))
        model.train()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss, _, grads = grad_step(model, batch, ACCUM)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        expected = {k: ACCUM * v
                    for k, v in wrapper_calls(cfg, training=True).items()}
        if dict(LAUNCHES) != expected:
            raise AssertionError(f"{name} {policy}: launch counts "
                                 f"{dict(LAUNCHES)} != {expected}")
        if any(GENERIC_LAUNCHES.values()):
            raise AssertionError(f"{name} {policy}: generic launches "
                                 f"{dict(GENERIC_LAUNCHES)}")
        policies[policy] = dict(
            loss=float(loss), grad_step_s=secs, peak_gb=peak / 1e9,
            peak_above_start_gb=(peak - base) / 1e9,
            launches=dict(LAUNCHES))
        host[policy] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                        {k: p.detach().cpu()
                         for k, p in model.named_parameters()})
        del loss, grads
        if policy == "save_attn":
            del model
            release_memory()
    (loss_a, g_a, p_a), (loss_c, g_c, p_c) = host.values()
    if not all(torch.equal(p_a[k], p_c[k]) for k in p_a):
        raise AssertionError(f"{name}: the two models' weights differ")
    got, want = dict(g_c, loss=loss_c), dict(g_a, loss=loss_a)
    differ = [k for k in ["loss"] + list(jax_leaf_names(cfgs["save_ctx"]))
              if not torch.equal(got[k], want[k])]
    if differ:
        k = differ[0]
        raise AssertionError(
            f"{name}: save_ctx differs from save_attn in {len(differ)} "
            f"tensors, first {k}: max |diff| "
            f"{(got[k] - want[k]).abs().max().item()}")
    policies["save_ctx_saving_gb"] = (
        policies["save_attn"]["peak_above_start_gb"]
        - policies["save_ctx"]["peak_above_start_gb"])
    return policies, model, batch


def xl_phase(torch, smi, release_memory, dev="cuda",
             model_overrides=None) -> None:
    """14a: ``save_ctx`` against ``save_attn`` (:func:`_remat_pair`) on the
    flagship of phase 7 (``FLAGSHIP_TUNED``: ``block_3`` plain) and on
    ``xl_model_config()`` at full width and depth (dim 1792, 28 heads of
    64, 64 layers over 4 shared blocks and ``w_conv``, all
    rematerialised, 16384 image codes, the plain LayerNorm; f32
    parameters, micro-batch 4 x accumulation 2); then ``XL_STEPS`` XL steps
    with the 8-bit LAMB under ``save_ctx``: the exact launch counts,
    finite losses that fall once the learning rate leaves 0, step s,
    img/s and peak memory."""
    from dalle_tpu_torch.config import (OptimizerConfig,
                                        flagship_model_config,
                                        xl_model_config)
    from dalle_tpu_torch.models.transformer import wrapper_calls
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import make_optimizer, optimizer_state_bytes
    from dalle_tpu_torch.training.steps import TrainState, train_step

    overrides = dict(model_overrides or {})
    flagship, model, batch = _remat_pair(
        torch, "flagship", lambda p: flagship_model_config(
            remat_policy=p, **overrides), release_memory, dev)
    del model, batch
    policies, model, batch = _remat_pair(
        torch, "xl", lambda p: xl_model_config(remat_policy=p, **overrides),
        release_memory, dev)
    n = MICRO * ACCUM
    n_params = sum(p.numel() for p in model.parameters())

    # XL_STEPS 8-bit steps under save_ctx
    cfg = model.cfg
    tx = make_optimizer(OptimizerConfig(state_bits=8, warmup_steps=2,
                                        total_steps=100))
    state = TrainState.create(model, tx)
    n_q = sum(isinstance(m, Quantized) for m in state.opt_state.mu.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s = [], []
    for _ in range(XL_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, tx, ACCUM)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    expected = {k: XL_STEPS * ACCUM * v
                for k, v in wrapper_calls(cfg, training=True).items()} | {
        "quantize_blockwise": XL_STEPS * 2 * n_q}
    if dict(LAUNCHES) != expected:
        raise AssertionError(f"xl: 8-bit steps' launch counts "
                             f"{dict(LAUNCHES)} != {expected}")
    if any(GENERIC_LAUNCHES.values()):
        raise AssertionError(f"xl: generic launches "
                             f"{dict(GENERIC_LAUNCHES)}")
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[1] - losses[0]) <= SAME_LOSS * abs(losses[0])
            and all(losses[i + 1] < losses[i]
                    for i in range(1, XL_STEPS - 1))):
        raise AssertionError(f"xl: the loss does not fall: {losses}")
    steady = step_s[1:]
    peak, launches = torch.cuda.max_memory_allocated(), dict(LAUNCHES)
    heads = head_chunk_peaks(torch, model,
                             lambda: train_step(state, batch, tx, ACCUM))
    emit(phase="xl", card=smi, config=dict(
        dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
        head_dim=cfg.head_dim, vocab_image=cfg.vocab_image,
        remat_skip_blocks=cfg.remat_skip_blocks, ln_fusion=cfg.ln_fusion),
        overrides=overrides, params=n_params, micro=MICRO, accum=ACCUM,
        policies=policies, flagship_policies=flagship, grads_equal=True,
        quantized_leaves=n_q,
        state_gb=optimizer_state_bytes(state.opt_state) / 1e9,
        steps=XL_STEPS, losses=losses, step_s=step_s,
        step_s_mean=sum(steady) / len(steady),
        img_per_s=n * len(steady) / sum(steady), peak_gb=peak / 1e9,
        head_chunk_peaks=heads, launches=launches)
    del state, model, batch, metrics
    release_memory()


def offload_phase(torch, smi, release_memory, dev="cuda",
                  model_overrides=None) -> None:
    """14b: the flagship's training step of phase 8 (8-bit LAMB) and of
    phase 7 (fp32), ``OFFLOAD_UPDATES`` updates each, first with the
    optimizer state on the device, then offloaded
    (``training/offload.py``) from the same weights: after each update
    the parameters and every moment tensor are ``torch.equal`` to the
    on-device run's; the offloaded moments are pinned host tensors; the
    memory allocated between steps is lower by the state's bytes
    (``optimizer_state_bytes``) within ``OFFLOAD_MEM_TOL``; the update
    launches ``quantize_blockwise`` on the card twice a quantized tensor
    and never its plain version. Records each update's s in both."""
    from dalle_tpu_torch.config import OptimizerConfig
    from dalle_tpu_torch.entry import train_entry
    from dalle_tpu_torch.ops import LAUNCHES, reset_launches
    from dalle_tpu_torch.ops import quant as quant_ops
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import make_optimizer, optimizer_state_bytes
    from dalle_tpu_torch.params import state_leaf_tensors
    from dalle_tpu_torch.training.offload import (make_offloaded_apply_step,
                                                  offload_train_state)
    from dalle_tpu_torch.training.steps import apply_step, grad_step

    plain_calls = []
    plain = quant_ops.quantize_blockwise_plain

    def counted_plain(*a, **k):
        plain_calls.append(1)
        return plain(*a, **k)

    quant_ops.quantize_blockwise_plain = counted_plain
    try:
        for bits in (8, 32):
            tx = make_optimizer(OptimizerConfig(state_bits=bits,
                                                warmup_steps=2,
                                                total_steps=100))
            snaps, runs = [], {}
            for mode in ("device", "offload"):
                release_memory()
                _, (state, batch) = train_entry(
                    device=dev, micro=MICRO, accum=ACCUM, seed=SEED,
                    state_bits=bits, **(model_overrides or {}))
                if mode == "offload":
                    state = offload_train_state(state)
                    apply = make_offloaded_apply_step(tx)
                else:
                    def apply(s, g):
                        return apply_step(s, g, tx)
                state_bytes = optimizer_state_bytes(state.opt_state)
                n_q = sum(isinstance(m, Quantized)
                          for m in state.opt_state.mu.values())
                update_s, between = [], []
                reset_launches()
                for i in range(OFFLOAD_UPDATES):
                    _, _, grads = grad_step(state.model, batch, ACCUM)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state = apply(state, grads)
                    torch.cuda.synchronize()
                    update_s.append(time.perf_counter() - t0)
                    del grads
                    between.append(torch.cuda.memory_allocated())
                    leaves = [t.detach().to("cpu", copy=True)
                              for t in state_leaf_tensors(state.model,
                                                          state.opt_state)]
                    if mode == "device":
                        snaps.append(leaves)
                        continue
                    if not all(torch.equal(a, b)
                               for a, b in zip(leaves, snaps[i])):
                        raise AssertionError(
                            f"offload {bits}-bit: update {i + 1} differs "
                            "from the on-device update")
                    if dev == "cuda" and not all(
                            t.is_pinned()
                            for t in _moment_tensors(state.opt_state)):
                        raise AssertionError(f"offload {bits}-bit: a "
                                             "moment is not pinned")
                want = OFFLOAD_UPDATES * 2 * n_q
                if LAUNCHES["quantize_blockwise"] != want:
                    raise AssertionError(
                        f"offload {bits}-bit {mode}: "
                        f"{LAUNCHES['quantize_blockwise']} "
                        f"quantize_blockwise launches, expected {want}")
                runs[mode] = dict(update_s=update_s,
                                  between_gb=[b / 1e9 for b in between],
                                  launches=dict(LAUNCHES))
                del state, batch, leaves
            if plain_calls:
                raise AssertionError(f"offload {bits}-bit: the plain "
                                     f"quantize ran {len(plain_calls)} "
                                     "times")
            saved = [d - o for d, o in zip(runs["device"]["between_gb"],
                                           runs["offload"]["between_gb"])]
            if any(abs(s * 1e9 - state_bytes) > OFFLOAD_MEM_TOL
                   for s in saved):
                raise AssertionError(
                    f"offload {bits}-bit: memory between steps lower by "
                    f"{saved} GB, the state is {state_bytes / 1e9} GB")
            emit(phase="offload", card=smi, state_bits=bits,
                 updates=OFFLOAD_UPDATES, state_bytes=state_bytes,
                 quantized_leaves=n_q, equal=True, pinned=dev == "cuda",
                 saved_between_steps_gb=saved, **{
                     f"{mode}_{k}": v for mode, r in runs.items()
                     for k, v in r.items()},
                 added_update_s=[o - d for d, o in zip(
                     runs["device"]["update_s"],
                     runs["offload"]["update_s"])])
            del snaps
    finally:
        quant_ops.quantize_blockwise_plain = plain
    release_memory()


def xl_cli_phase(torch, smi, release_memory, root, dev="cuda",
                 cli_argv=XL_CLI, model_overrides=None) -> None:
    """14c: ``python -m dalle_tpu_torch.cli.run_trainer --preset xl
    --remat-policy save_ctx --offload`` (``XL_CLI``; no ``--device``, so on
    the card) solo as a subprocess with a checkpoint directory under
    ``build/``: it exits 0 and its epochs' losses are finite; its freshest
    checkpoint, restored here into an offloaded XL state and into one on
    the device, gives the same state in both (``torch.equal``, the
    offloaded moments pinned) and serializes to the checkpoint file's
    bytes from either; and the restored model's mean loss over the CLI's
    64 synthetic samples is below the same weights' at step 0 (the
    epochs' own batches differ, so their losses do not show the fall)."""
    import shutil

    from dalle_tpu_torch.config import OptimizerConfig, xl_model_config
    from dalle_tpu_torch.data.synthetic import SyntheticCodes
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.params import state_leaf_tensors
    from dalle_tpu_torch.training.checkpoint import (CheckpointManager,
                                                     serialize_state_dict,
                                                     state_to_state_dict)
    from dalle_tpu_torch.training.offload import offload_train_state
    from dalle_tpu_torch.training.steps import TrainState

    release_memory()
    ckpt_dir = os.path.join(root, "build", "dalle_tpu_torch", "smoke_xl")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    metrics = os.path.join(ckpt_dir, "metrics.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "dalle_tpu_torch.cli.run_trainer",
           *cli_argv, "--checkpoint-dir", ckpt_dir, "--metrics-file",
           metrics, "--identity-path", os.path.join(ckpt_dir, "id.pem"),
           "--log-level", "WARNING"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"xl run_trainer exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    if len(losses) < 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"xl run_trainer: losses {losses}")
    cfg = xl_model_config(remat_policy="save_ctx",
                          **(model_overrides or {}))

    def data_loss(model):
        """The mean loss over the CLI's synthetic data set (its 64
        samples, every epoch's batches drawn from them): an epoch's own
        batches differ, so the falling loss is read on the same samples
        before and after training."""
        data = SyntheticCodes(cfg, num_samples=64, seed=0)
        total = 0.0
        with torch.inference_mode():
            for b in data.batches(MICRO, loop=False):
                loss, _ = model(torch.from_numpy(b["text"]).long().to(dev),
                                torch.from_numpy(b["image"]).long().to(dev))
                total += float(loss) * MICRO
        return total / 64

    # the CLI's weights at step 0: trainer seed 0 on the same device
    loss_init = data_loss(init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)).eval())
    tx = make_optimizer(OptimizerConfig(warmup_steps=2, total_steps=100))
    mgr = CheckpointManager(ckpt_dir, async_writes=False)
    path = mgr._candidates()[0][1]
    with open(path, "rb") as f:
        blob = f.read()
    states = []
    for i, offload in enumerate((True, False)):
        state = TrainState.create(init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 1 + i)), tx)
        if offload:
            state = offload_train_state(state)
        t0 = time.perf_counter()
        restored = mgr.restore_latest(state)
        restore_s = time.perf_counter() - t0
        if restored is None or restored[1] != rows[-1]["epoch"]:
            raise AssertionError(f"xl run_trainer's checkpoint: restored "
                                 f"{restored and restored[1]}, expected "
                                 f"epoch {rows[-1]['epoch']}")
        state, epoch = restored
        if serialize_state_dict(state_to_state_dict(state), epoch) != blob:
            raise AssertionError(f"xl: the restored state (offload "
                                 f"{offload}) does not serialize to "
                                 f"{os.path.basename(path)}'s bytes")
        states.append((state, restore_s))
    (off, off_s), (on, _) = states
    loss_trained = data_loss(on.model.eval())
    if not loss_trained < loss_init:
        raise AssertionError(f"xl run_trainer: the loss on its data went "
                             f"from {loss_init} to {loss_trained}")
    a = state_leaf_tensors(off.model, off.opt_state)
    b = state_leaf_tensors(on.model, on.opt_state)
    if len(a) != len(b) or not all(torch.equal(x.cpu(), y.cpu())
                                   for x, y in zip(a, b)):
        raise AssertionError("xl: the offloaded and the on-device restores "
                             "differ")
    if dev == "cuda" and not all(t.is_pinned()
                                 for t in _moment_tensors(off.opt_state)):
        raise AssertionError("xl: a restored offloaded moment is not "
                             "pinned")
    emit(phase="xl_cli", card=smi, argv=cli_argv, seconds=cli_s,
         epochs=[r["epoch"] for r in rows], losses=losses,
         timings=rows[-1]["timings"], checkpoint=os.path.basename(path),
         checkpoint_bytes=len(blob), restore_offloaded_s=off_s,
         restored_epoch=rows[-1]["epoch"], data_loss_init=loss_init,
         data_loss_trained=loss_trained)
    del states, off, on, a, b, blob
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    release_memory()


def _run_slice(root, dev, overrides, collab_kw, trainer_kw, epochs,
               where, opt_kw=None):
    """A peer of two processes on the one card (a ``gloo`` group on
    loopback, laid out by ``trainer_kw``) and a one-process peer, at
    flagship width (``overrides``) with phase 8's step (8-bit LAMB with
    ``opt_kw``, micro-batch 4 x accumulation 2), ``epochs`` epochs through
    ``train_loop``: every child exits 0 within ``SLICE_TIMEOUT_S``.
    Returns each role's record and the seconds from the start signal to
    the last exit."""
    import socket
    import tempfile

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    gloo_port, dht_port = free_port(), free_port()
    procs = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(
            root, "build")) as tmp:
        def start(role):
            args = [role, gloo_port, dht_port, tmp, dev,
                    json.dumps(overrides or {}), json.dumps(collab_kw),
                    epochs, json.dumps(trainer_kw),
                    json.dumps(opt_kw or {})]
            log = open(os.path.join(tmp, f"log_{role}.txt"), "w")
            procs[role] = (subprocess.Popen(
                [sys.executable, "-c", SLICE_CHILD, *map(str, args)],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT),
                log)

        def tail(role):
            with open(os.path.join(tmp, f"log_{role}.txt")) as f:
                return f.read()[-3000:]

        def wait_file(name, timeout):
            deadline = time.perf_counter() + timeout
            while not os.path.exists(os.path.join(tmp, name)):
                dead = [r for r, (p, _) in procs.items()
                        if p.poll() not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(
                        f"{where}: no {name} ({dead or 'timeout'}):\n" +
                        "\n".join(f"[{r}] {tail(r)}" for r in procs))
                time.sleep(0.1)

        t0 = time.perf_counter()
        try:
            start("0")
            start("1")
            wait_file("dht_0", 300)    # the peer bootstraps from 0's DHT
            start("peer")
            for role in ("0", "1", "peer"):
                wait_file(f"ready_{role}", 300)
            open(os.path.join(tmp, "go"), "w").close()
            t_go = time.perf_counter()
            for role, (p, _) in procs.items():
                left = SLICE_TIMEOUT_S - (time.perf_counter() - t0)
                try:
                    rc = p.wait(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"{where}: child {role} hung:\n"
                                         f"{tail(role)}")
                if rc != 0:
                    raise AssertionError(f"{where}: child {role} exited "
                                         f"{rc}:\n{tail(role)}")
            wall_s = time.perf_counter() - t_go
            outs = {}
            for role in procs:
                with open(os.path.join(tmp, f"out_{role}.json")) as f:
                    outs[role] = json.load(f)
        finally:
            for p, log in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    return outs, wall_s


def _check_slice(outs, epochs, where):
    """The checks a slice and a peer share: ``epochs`` epochs on every
    role, no generic launch, finite losses, every round a 2-peer group,
    all three whole states equal (sha256) after every epoch. Returns the
    rounds a role."""
    for role, out in outs.items():
        if out["epoch"] != epochs or [r["epoch"] for r in out["epochs"]] \
                != list(range(1, epochs + 1)):
            raise AssertionError(f"{where}: {role} epochs "
                                 f"{[r['epoch'] for r in out['epochs']]}")
        if any(out["generic"].values()):
            raise AssertionError(f"{where}: {role} generic launches "
                                 f"{out['generic']}")
        losses = [r["loss"] for r in out["epochs"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{where}: {role} losses {losses}")
    rounds = {role: [dict(epoch=r["epoch"], loss=r["loss"],
                          mini_steps=r["mini_steps"], round_s=r["round_s"],
                          wire=r["wire"], gloo=r["gloo"],
                          factor_rounds=r["factor_rounds"], **r["timings"])
                     for r in out["epochs"]]
              for role, out in outs.items()}
    groups = {role: [r["timings"].get("group_size") for r in out["epochs"]]
              for role, out in outs.items() if role != "1"}
    if any(g != [2] * epochs for g in groups.values()):
        raise AssertionError(f"{where}: group sizes {groups}, expected two "
                             f"peers in every round: {rounds}")
    for e in range(epochs):
        digests = {role: out["epochs"][e]["digest"]
                   for role, out in outs.items()}
        if len(set(digests.values())) != 1:
            raise AssertionError(f"{where}: epoch {e + 1}: states differ "
                                 f"{digests}: {rounds}")
    if outs["0"]["processes"] != 2 or outs["0"]["local_batch"] != 16:
        raise AssertionError(f"{where}: {outs['0']['processes']} processes,"
                             f" local batch {outs['0']['local_batch']}")
    return rounds


def _slice_rate(outs):
    """The swarm's samples/s between the later first step and the earlier
    last: the slice's steps count 16 samples, the peer's 8."""
    runs = [(outs["0"]["step_ends"], outs["0"]["local_batch"]),
            (outs["peer"]["step_ends"], outs["peer"]["local_batch"])]
    t_a = max(ends[0] for ends, _ in runs)
    t_b = min(ends[-1] for ends, _ in runs)
    samples = sum(b for ends, b in runs for t in ends if t_a < t <= t_b)
    return samples / (t_b - t_a) if t_b > t_a else None


def slice_phase(torch, smi, release_memory, root, dev="cuda",
                model_overrides=None, epochs=SLICE_EPOCHS) -> None:
    """14d: a peer of two processes on the one card (a ``gloo`` group on
    loopback, ``dp=2``: each trains on its 8 rows of the slice's 16 a step,
    and the gradients are their mean) and a one-process peer, at flagship
    width cut to ``MESH_DEPTH`` layers for time (every block kept, as in
    16a) with phase 8's step (8-bit LAMB, micro-batch 4 x accumulation 2)
    and ``SLICE_COLLAB`` (the JAX defaults otherwise), ``epochs`` epochs
    through ``train_loop``: every child exits 0 within
    ``SLICE_TIMEOUT_S``; after every epoch the slice's two processes and
    the peer hold the same parameters and moments (sha256 of every state
    leaf), every round is a 2-peer group, the losses are finite and no
    generic kernel runs. Records the slice's gradient mean s a step, the
    rounds' s and wire bytes a leg, and the swarm's samples/s."""
    release_memory()
    overrides = {"depth": MESH_DEPTH, **(model_overrides or {})}
    outs, wall_s = _run_slice(root, dev, overrides, SLICE_COLLAB, {},
                              epochs, "slice")
    rounds = _check_slice(outs, epochs, "slice")
    means = outs["0"]["grad_mean_s"][1:] + outs["1"]["grad_mean_s"][1:]
    emit(phase="slice", card=smi, processes=2, peers=2, epochs=epochs,
         collab=SLICE_COLLAB, wall_s=wall_s, digests_equal=True,
         grad_mean_s=dict(per_step=[outs["0"]["grad_mean_s"],
                                    outs["1"]["grad_mean_s"]],
                          mean=sum(means) / max(len(means), 1)),
         rounds=rounds, swarm_samples_per_s=_slice_rate(outs),
         peak_gb={role: out["peak_gb"] for role, out in outs.items()},
         launches={role: out["launches"] for role, out in outs.items()})
    release_memory()


# -- 15: the sharded mesh: long context, ring, fsdp x tp, Ulysses, dry run --
# ---------------------------------------------------------------------------

LONG_MICRO, LONG_STEPS = 2, 2  # 15a: micro-batch (accumulation 1), steps
RING_DEPTH = 4                 # 15b: the long-context depth, cut for time
MESH_DEPTH = 9                 # 15c-d, 16 and 17: the flagship's and XL's
                               # depth, cut for time to the fewest layers
                               # that call each of the four shared blocks
                               # twice (their gradients summed over calls
                               # through the fsdp gathers and the tp
                               # partials) and keep w_conv: every
                               # collective crosses gloo through host
                               # memory (66 s a grad step at depth 64 in
                               # 15c, 31 s at 16, 4.8 s at 8)
MESH_TIMEOUT_S = 600           # each spawned group of 15b-e, start to exit
# 15b-d tolerances, each against one process on the same weights and batch
# (bf16 activations, so rounding differs where the sharded program sums in
# another order; PERF.md "PR 14"):
MESH_LOSS_TOL = 2e-3           # |loss - loss_1| / loss_1
MESH_GRAD_TOL = 8e-2           # per leaf: ||g - g_1|| / ||g_1|| (bf16;
                               # 0.021-0.035 at the worst leaf in the first
                               # runs; 2e-6 in f32 on the CPU)
MESH_PARAM_TOL = 1e-6          # 15c, the update from the one-process
                               # gradients: per leaf max |p - p_1| over
                               # max |p_1| (only the clip norm's summation
                               # order differs)
MESH_CODES_SHARE = 1e-4        # 15c, the same update: share of the 8-bit
                               # codes that may differ


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(torch, dev):
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated() / 1e9
    return None


def _rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _mesh_batch(torch, cfg, n, dev):
    from dalle_tpu_torch.data.synthetic import SyntheticCodes
    data = next(SyntheticCodes(cfg, num_samples=n, seed=SEED).batches(n))
    return {k: torch.from_numpy(v).long().to(dev) for k, v in data.items()}


def _mesh_cfg(case: str, overrides):
    from dalle_tpu_torch.config import (flagship_model_config,
                                        long_context_model_config,
                                        xl_model_config)
    if case == "ring":
        return long_context_model_config(**{"depth": RING_DEPTH,
                                            **overrides})
    if case == "xl_tp8":
        return xl_model_config(**{"depth": MESH_DEPTH, **overrides})
    overrides = {"depth": MESH_DEPTH, **overrides}
    if case == "ulysses":
        return flagship_model_config(sequence_parallel="ulysses",
                                     **overrides)
    if case == "untied":
        return flagship_model_config(tied_embeddings=False, **overrides)
    return flagship_model_config(**overrides)


#: 15b-d, 16b and 17: (mesh axes, micro-batch, accumulation, 8-bit
#: update?)
MESH_CASES = {
    "ring": (dict(dp=1, fsdp=1, tp=1, sp=2), LONG_MICRO, 1, False),
    "fsdp_tp": (dict(dp=1, fsdp=2, tp=2, sp=1), MICRO, 1, True),
    "ulysses": (dict(dp=1, fsdp=1, tp=2, sp=2), MICRO, 1, False),
    "untied": (dict(dp=1, fsdp=2, tp=2, sp=1), MICRO, 1, True),
    # 17a: sp a replica axis (sequence_parallel "none")
    "sp_none": (dict(dp=1, fsdp=2, tp=1, sp=2), MICRO, 1, False),
    # 17b: XL's 28 heads at tp=8 (3.5 a rank: q/k/v gathered, every rank
    # attends on all 28)
    "xl_tp8": (dict(dp=1, fsdp=1, tp=8, sp=1), MICRO, 1, False),
}
#: a case held to another case's one-process run (the same model, weights
#: and batch): 17a reuses 15c's
MESH_REFS = {"sp_none": "fsdp_tp"}
#: 16b: return_logits against one process, as phase 4's decode: max |diff|
#: over the unmasked logits within this share of their largest magnitude
LOGITS_TOL = 2 ** -4


def mesh_child(rank: int, world: int, args) -> dict:
    """One process of 15b-d, 16b and 17 (``parallel/launch.spawn``): the
    case's model on its mesh from the seed, sharded; one grad step on its
    rows after a warm-up step (and, with the update, one 8-bit update from
    the one-process gradients, cut to its shards); every leaf gathered
    whole and held to the one-process reference at ``args["ref"]`` on rank
    0; where ``sp`` is a replica axis, a digest of every whole gradient."""
    import hashlib

    import numpy as np
    import torch

    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import OptimizerConfig
    from dalle_tpu_torch.models import attention as attn_mod
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.transformer import token_shards
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import make_optimizer, optimizer_state_bytes
    from dalle_tpu_torch.parallel import collectives
    from dalle_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from dalle_tpu_torch.parallel.sequence import ring_attention
    from dalle_tpu_torch.parallel.sharding import (moment_spec,
                                                   shard_tensor,
                                                   shard_train_state,
                                                   unshard_moment,
                                                   unshard_tensor)
    from dalle_tpu_torch.training.steps import (TrainState, apply_step,
                                                grad_step)

    case = args["case"]
    axes, micro, accum, update = MESH_CASES[case]
    dev = resolve_device(args["dev"])
    cfg = _mesh_cfg(case, args["overrides"])
    mesh = make_mesh(**axes)
    heads = []
    for fn in (attn_mod.LineAttention, attn_mod.WindowAttention):
        orig = fn.apply

        def seen(*a, _orig=orig):
            heads.append(int(a[0].shape[1]))
            return _orig(*a)
        fn.apply = seen
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        mesh=mesh)
    model.train()
    tx = make_optimizer(OptimizerConfig(state_bits=8, warmup_steps=2,
                                        total_steps=100))
    state = shard_train_state(mesh, TrainState.create(model, tx))
    batch = batch_sharding(mesh, _mesh_batch(torch, cfg, micro * accum, dev),
                           accum)
    resident = (sum(p.numel() * p.element_size() for p in model.parameters())
                + optimizer_state_bytes(state.opt_state))
    _sync(torch, dev)
    # what the process holds once sharded: the shards, the batch and the
    # CUDA context's own allocations
    allocated = (torch.cuda.memory_allocated() if dev.type == "cuda"
                 else 0)
    # a first grad step warms the process up (CUDA context, cuBLAS
    # handles: 15a's first step takes 9 s against 0.7), on one row a data
    # rank, so that its collectives carry a fraction of the timed step's
    # bytes; the second, on the same weights, is timed and checked
    warm_rows = axes["dp"] * axes["fsdp"] * accum
    grad_step(model, batch_sharding(
        mesh, _mesh_batch(torch, cfg, warm_rows, dev), accum), accum)
    _sync(torch, dev)
    _reset_peak(torch, dev)
    reset_launches()
    collectives.reset_traffic()
    t0 = time.perf_counter()
    loss, _, grads = grad_step(model, batch, accum)
    _sync(torch, dev)
    grad_s = time.perf_counter() - t0
    traffic = {k: list(v) for k, v in collectives.TRAFFIC.items()}
    axis_traffic = {k: list(v) for k, v in collectives.AXIS_TRAFFIC.items()}
    launches, generic = dict(LAUNCHES), dict(GENERIC_LAUNCHES)
    out = dict(loss=float(loss), grad_s=grad_s, resident=resident,
               allocated=allocated,
               traffic_json=json.dumps(traffic),
               axis_traffic_json=json.dumps(axis_traffic),
               launches_json=json.dumps(launches),
               generic_json=json.dumps(generic),
               heads=np.array(sorted(set(heads)) or [0]))
    ref = torch.load(args["ref"], map_location="cpu", weights_only=True) \
        if rank == 0 or update else None
    if update:
        # the update's inputs are the one-process gradients, cut to this
        # process's shards: the sharded update is held to the one-process
        # update alone (the gradients are held to theirs below)
        reset_launches()
        ref_grads = {n: shard_tensor(g.to(dev), model.shard_specs[n], mesh)
                     for n, g in ref["grads"].items()}
        _sync(torch, dev)
        t0 = time.perf_counter()
        state = apply_step(state, ref_grads, tx)
        _sync(torch, dev)
        out["apply_s"] = time.perf_counter() - t0
        out["quantize_launches"] = LAUNCHES["quantize_blockwise"]
        del ref_grads
    out["peak_gb"] = _peak_gb(torch, dev) or 0.0
    if case == "untied":
        # this process's rows with the whole token axis and vocabulary (a
        # collective over tp), held to one process's on rank 0's rows
        with torch.no_grad():
            logits = model(batch["text"], batch["image"],
                           return_logits=True)[2]
        if rank == 0:
            want = torch.load(args["ref"] + ".logits", map_location=dev,
                              weights_only=True)
            valid = want > -1e8
            out["logits_err"] = float((logits - want).abs()[valid].max())
            out["logit_range"] = float(want[valid].abs().max())
            out["logits_shape"] = np.array(logits.shape)
            del want, valid
        del logits
    if case == "ring":
        # the ring alone at one layer's shape: forward + backward, and its
        # bytes (this rank's, to gloo)
        b, tl = micro, cfg.total_seq_len // mesh.sp
        gen = torch.Generator(device=dev).manual_seed(SEED + rank)
        q, k, v = (torch.randn((b, tl, cfg.heads, cfg.head_dim),
                               generator=gen, device=dev).to(torch.bfloat16)
                   .requires_grad_(True) for _ in range(3))
        kw = dict(group=mesh.group("sp"), n_shards=mesh.sp,
                  index=mesh.index("sp"))
        ring_attention(q, k, v, **kw).float().sum().backward()
        collectives.reset_traffic()
        times = []
        for _ in range(3):
            _sync(torch, dev)
            t0 = time.perf_counter()
            o = ring_attention(q, k, v, **kw)
            _sync(torch, dev)
            t1 = time.perf_counter()
            o.float().sum().backward()
            _sync(torch, dev)
            times.append((t1 - t0, time.perf_counter() - t1))
        out["ring_fwd_ms"] = min(t[0] for t in times) * 1e3
        out["ring_bwd_ms"] = min(t[1] for t in times) * 1e3
        out["ring_bytes"] = sum(r[1] for r in
                                collectives.TRAFFIC.values()) / 3
    # every leaf whole, held to the reference on rank 0
    errs, perrs, codes_diff, codes_total = {}, {}, 0, 0
    replica = mesh.sp > 1 and token_shards(mesh, cfg) == 1
    digest = hashlib.sha256()
    for name, g in grads.items():
        spec = model.shard_specs[name]
        whole = unshard_tensor(g, spec, mesh).cpu()
        if replica:
            digest.update(whole.numpy().tobytes())
        if rank == 0:
            errs[name] = _rel_err(whole, ref["grads"][name])
        if update:
            p = unshard_tensor(model.get_parameter(name).detach(), spec,
                               mesh).cpu()
            if rank == 0:
                want = ref["params"][name].float()
                perrs[name] = float((p.float() - want).abs().max()
                                    / want.abs().max().clamp_min(1e-30))
            for moment in ("mu", "nu"):
                m = getattr(state.opt_state, moment)[name]
                if isinstance(m, Quantized):
                    w = unshard_moment(m, moment_spec(mesh, m, spec), mesh)
                    if rank == 0:
                        codes = ref[moment][name]
                        codes_diff += int((w.codes.cpu() != codes).sum())
                        codes_total += codes.numel()
    if replica:
        out["grad_digest"] = digest.hexdigest()
    if rank == 0:
        out["loss_err"] = abs(float(loss) - float(ref["loss"])) / abs(
            float(ref["loss"]))
        worst = max(errs, key=errs.get)
        out["grad_err"], out["grad_worst"] = errs[worst], worst
        if update:
            pw = max(perrs, key=perrs.get)
            out["param_err"], out["param_worst"] = perrs[pw], pw
            out["codes_diff"], out["codes_total"] = codes_diff, codes_total
    return out


def _expected_resident(cfg, axes) -> int:
    """The bytes each process of ``axes``'s mesh should hold of the
    flagship's parameters and 8-bit state: every leaf's bytes over the
    mesh axes of its spec (``param_shardings``); a quantized moment's
    codes and absmax over ``fsdp`` where its block count divides; the
    step count's 4 (``optimizer_state_bytes``)."""
    from torch import device as torch_device

    from dalle_tpu_torch.config import OptimizerConfig
    from dalle_tpu_torch.models.dalle import DALLE
    from dalle_tpu_torch.parallel.mesh import make_mesh
    from dalle_tpu_torch.parallel.sharding import param_shardings
    opt = OptimizerConfig(state_bits=8)
    mesh = make_mesh(**axes, n_devices=axes["dp"] * axes["fsdp"]
                     * axes["tp"] * axes["sp"])
    with torch_device("meta"):
        model = DALLE(cfg)
    specs = param_shardings(mesh, model)
    total = 4
    for name, p in model.named_parameters():
        split = math.prod(mesh.shape[a] for a in specs[name] if a)
        total += p.numel() * p.element_size() // split
        if p.numel() >= opt.min_8bit_size:
            blocks = -(-p.numel() // opt.block_size)
            per = mesh.fsdp if blocks % mesh.fsdp == 0 else 1
            total += 2 * blocks * (opt.block_size + 4) // per
        else:
            total += 2 * p.numel() * 4 // split
    return total


def _mesh_reference(torch, case, overrides, dev, path, release_memory):
    """The one-process run of a 15b-d case on the same weights and batch,
    saved to ``path``: loss and gradients (and, with the 8-bit update,
    the updated parameters and the moments' codes); returns its record."""
    from dalle_tpu_torch.config import OptimizerConfig
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import make_optimizer, optimizer_state_bytes
    from dalle_tpu_torch.training.steps import (TrainState, apply_step,
                                                grad_step)
    release_memory()
    axes, micro, accum, update = MESH_CASES[case]
    cfg = _mesh_cfg(case, overrides)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    model.train()
    tx = make_optimizer(OptimizerConfig(state_bits=8, warmup_steps=2,
                                        total_steps=100))
    state = TrainState.create(model, tx)
    resident = (sum(p.numel() * p.element_size() for p in model.parameters())
                + optimizer_state_bytes(state.opt_state))
    batch = _mesh_batch(torch, cfg, micro * accum, dev)
    _sync(torch, dev)
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    loss, _, grads = grad_step(model, batch, accum)
    _sync(torch, dev)
    rec = dict(loss=float(loss), grad_s=time.perf_counter() - t0,
               resident=resident)
    saved = dict(loss=loss.cpu(), grads={k: g.cpu() for k, g in
                                         grads.items()})
    if update:
        t0 = time.perf_counter()
        state = apply_step(state, grads, tx)
        _sync(torch, dev)
        rec["apply_s"] = time.perf_counter() - t0
        saved["params"] = {k: p.detach().cpu()
                           for k, p in model.named_parameters()}
        for moment in ("mu", "nu"):
            saved[moment] = {k: m.codes.cpu() for k, m in
                             getattr(state.opt_state, moment).items()
                             if isinstance(m, Quantized)}
    rec["peak_gb"] = _peak_gb(torch, dev)
    if case == "untied":
        # the logits of the rows rank 0 holds (batch index 0)
        rows = micro // (axes["dp"] * axes["fsdp"])
        with torch.no_grad():
            logits = model(batch["text"][:rows], batch["image"][:rows],
                           return_logits=True)[2]
        torch.save(logits.cpu(), path + ".logits")
        del logits
    torch.save(saved, path)
    del state, model, grads, loss, saved
    release_memory()
    return rec


def mesh_case_phase(torch, smi, release_memory, root, case, dev="cuda",
                    model_overrides=None, refs=None) -> dict:
    """15b-d, 16b and 17: the case's one-process reference (or that of
    the case ``MESH_REFS`` names, already in ``refs``, a directory kept
    across the phases), then its mesh of processes on the card
    (``parallel/launch.spawn``, a ``gloo`` group): every process exits 0
    within ``MESH_TIMEOUT_S``; the loss within ``MESH_LOSS_TOL``, every
    gradient within ``MESH_GRAD_TOL`` (and, with the update, every
    parameter within ``MESH_PARAM_TOL`` and at most ``MESH_CODES_SHARE``
    of the 8-bit codes different; for the untied head, the logits within
    ``LOGITS_TOL`` of their range); no generic launch; each process's
    kernel launches those of one process's grad step
    (``wrapper_calls``), the attention kernels on the heads each rank
    attends on (``H/tp`` where ``tp`` splits whole heads, over ``sp``
    again under Ulysses, and all of them where ``tp`` splits a head),
    none under the ring; where ``sp`` is a replica axis, every process's
    gradients bitwise equal and no collective over ``sp``."""
    import contextlib
    import tempfile

    import numpy as np

    from dalle_tpu_torch.models.transformer import (token_shards,
                                                    wrapper_calls)
    from dalle_tpu_torch.parallel.launch import spawn
    from dalle_tpu_torch.parallel.mesh import Mesh
    overrides = dict(model_overrides or {})
    axes, micro, accum, update = MESH_CASES[case]
    n = axes["dp"] * axes["fsdp"] * axes["tp"] * axes["sp"]
    cfg = _mesh_cfg(case, overrides)
    ref_case = MESH_REFS.get(case, case)
    if (_mesh_cfg(ref_case, overrides) != cfg
            or MESH_CASES[ref_case][1:3] != (micro, accum)):
        raise AssertionError(f"{case}: {ref_case}'s reference runs another "
                             "model or batch")
    with contextlib.ExitStack() as stack:
        if refs is None:
            refs = stack.enter_context(tempfile.TemporaryDirectory(
                dir=os.path.join(root, "build")))
        path = os.path.join(refs, f"{ref_case}.pt")
        if os.path.exists(path):
            with open(path + ".json") as f:
                ref = json.load(f)
        else:
            ref = _mesh_reference(torch, ref_case, overrides, dev, path,
                                  release_memory)
            with open(path + ".json", "w") as f:
                json.dump(ref, f)
        t0 = time.perf_counter()
        outs = spawn(f"{os.path.abspath(__file__)}:mesh_child", n,
                     dict(case=case, ref=path, dev=str(dev),
                          overrides=overrides), timeout=MESH_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        if case != ref_case or ref_case not in MESH_REFS.values():
            # no later case reads it (nor its record and logits)
            for name in os.listdir(refs):
                if name.startswith(f"{ref_case}.pt"):
                    os.remove(os.path.join(refs, name))
    r0 = outs[0]
    launches = [json.loads(str(o["launches_json"])) for o in outs]
    generic = [json.loads(str(o["generic_json"])) for o in outs]
    if any(any(g.values()) for g in generic):
        raise AssertionError(f"{case}: generic launches {generic}")
    losses = [float(o["loss"]) for o in outs]
    if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 1:
        raise AssertionError(f"{case}: the processes' losses {losses}")
    checks = dict(loss_err=(float(r0["loss_err"]), MESH_LOSS_TOL),
                  grad_err=(float(r0["grad_err"]), MESH_GRAD_TOL))
    if case == "untied":
        checks["logits_err"] = (float(r0["logits_err"])
                                / float(r0["logit_range"]), LOGITS_TOL)
    if update:
        checks["param_err"] = (float(r0["param_err"]), MESH_PARAM_TOL)
        checks["codes_share"] = (int(r0["codes_diff"])
                                 / max(int(r0["codes_total"]), 1),
                                 MESH_CODES_SHARE)
    bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"{case}: against one process {bad} (worst "
                             f"gradient {r0['grad_worst']})")
    resident = [int(o["resident"]) for o in outs]
    expected = _expected_resident(cfg, axes)
    if update and resident != [expected] * n:
        raise AssertionError(f"{case}: resident bytes {resident}, "
                             f"expected {expected} a process")
    attn = ("line_attention", "window_attention")
    heads = sorted({int(h) for o in outs for h in np.asarray(o["heads"])})
    if case == "ring":
        if any(l[k] for l in launches for k in attn):
            raise AssertionError(f"ring: attention kernels launched "
                                 f"{launches}")
    else:
        # (a CPU rehearsal runs the plain versions, which count nothing)
        calls = {k: accum * v
                 for k, v in wrapper_calls(cfg, training=True).items()}
        if torch.device(dev).type == "cuda" and any(
                l != calls for l in launches):
            raise AssertionError(f"{case}: launch counts {launches}, "
                                 f"expected {calls} a process")
        tp = axes["tp"] if cfg.heads % axes["tp"] == 0 else 1
        want = cfg.heads // (tp * token_shards(Mesh(**axes), cfg))
        if heads != [want]:
            raise AssertionError(f"{case}: the attention kernels saw "
                                 f"{heads} heads, expected {want}")
    axis_traffic = [json.loads(str(o["axis_traffic_json"])) for o in outs]
    if "grad_digest" in r0:
        digests = {str(o["grad_digest"]) for o in outs}
        if len(digests) != 1 or any("sp" in a for a in axis_traffic):
            raise AssertionError(
                f"{case}: sp replicas' gradients differ ({len(digests)} "
                f"digests) or a collective ran over sp {axis_traffic}")
    rec = dict(phase=f"mesh_{case}", card=smi, mesh=axes, processes=n,
               config=dict(dim=cfg.dim, depth=cfg.depth,
                           image_grid=cfg.image_grid,
                           sequence_parallel=cfg.sequence_parallel),
               overrides=overrides, micro=micro, accum=accum,
               reference=ref, wall_s=wall_s, losses=losses,
               checks={k: dict(value=v[0], tolerance=v[1])
                       for k, v in checks.items()},
               grad_worst=str(r0["grad_worst"]),
               grad_s=[float(o["grad_s"]) for o in outs],
               peak_gb=[float(o["peak_gb"]) for o in outs],
               resident_bytes=resident, expected_resident_bytes=expected,
               resident_share=[r / ref["resident"] for r in resident],
               allocated_after_shard_bytes=[int(o["allocated"])
                                            for o in outs],
               traffic=[json.loads(str(o["traffic_json"])) for o in outs],
               axis_traffic=axis_traffic,
               gloo_share=[sum(v[2] for v in json.loads(
                   str(o["traffic_json"])).values()) / float(o["grad_s"])
                   for o in outs],
               attention_heads=heads, launches=launches)
    if "grad_digest" in r0:
        rec["grad_digests_equal"] = True
    if update:
        rec["apply_s"] = [float(o["apply_s"]) for o in outs]
        rec["quantize_launches"] = [int(o["quantize_launches"])
                                    for o in outs]
    if case == "untied":
        rec["logits"] = dict(shape=[int(x) for x in r0["logits_shape"]],
                             max_abs_err=float(r0["logits_err"]),
                             logit_range=float(r0["logit_range"]))
    if case == "ring":
        rec["ring_layer"] = dict(
            fwd_ms=[float(o["ring_fwd_ms"]) for o in outs],
            bwd_ms=[float(o["ring_bwd_ms"]) for o in outs],
            bytes_per_rank=[float(o["ring_bytes"]) for o in outs])
    emit(**rec)
    release_memory()
    return rec


def long_context_phase(torch, smi, release_memory, cuda_ms, dev="cuda",
                       model_overrides=None) -> dict:
    """15a: ``long_context_model_config()`` at full width and depth (dim
    1024, 64 ``full`` layers over 4 shared blocks, text 256 + 64x64 codes,
    blanket remat) in one process: ``LONG_STEPS`` 8-bit steps of
    ``LONG_MICRO`` samples through the window kernel (the exact launch
    counts, no generic launch, finite losses), with step s, img/s and peak
    memory; then the window kernel at this shape against its plain
    version, forward and backward (``BF16_TOL``; the backward twice,
    bitwise), its time by CUDA-graph replay beside the plain version's,
    SDPA's and the bound."""
    import torch.nn.functional as F

    from dalle_tpu_torch.config import (OptimizerConfig,
                                        long_context_model_config)
    from dalle_tpu_torch.models.attention import zoo_attention_mask
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.transformer import wrapper_calls
    from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
    from dalle_tpu_torch.ops.attention import (window_attention,
                                               window_attention_bwd,
                                               window_attention_bwd_plain,
                                               window_attention_plain)
    from dalle_tpu_torch.ops.quant import Quantized
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.training.steps import TrainState, train_step

    release_memory()
    overrides = dict(model_overrides or {})
    cfg = long_context_model_config(**overrides)
    n = LONG_MICRO
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    model.train()
    tx = make_optimizer(OptimizerConfig(state_bits=8, warmup_steps=2,
                                        total_steps=100))
    state = TrainState.create(model, tx)
    n_q = sum(isinstance(m, Quantized) for m in state.opt_state.mu.values())
    batch = _mesh_batch(torch, cfg, n, dev)
    _sync(torch, dev)
    _reset_peak(torch, dev)
    reset_launches()
    losses, step_s = [], []
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, tx, 1)
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = _peak_gb(torch, dev)
    per_step = wrapper_calls(cfg, training=True)
    expected = {k: LONG_STEPS * v for k, v in per_step.items()} | {
        "quantize_blockwise": LONG_STEPS * 2 * n_q}
    if dict(LAUNCHES) != expected:
        raise AssertionError(f"long_context: launch counts "
                             f"{dict(LAUNCHES)} != {expected}")
    if any(GENERIC_LAUNCHES.values()) or LAUNCHES["window_attention"] == 0:
        raise AssertionError(f"long_context: generic launches "
                             f"{dict(GENERIC_LAUNCHES)}, window "
                             f"{LAUNCHES['window_attention']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"long_context: losses {losses}")
    launches = dict(LAUNCHES)
    del state, model, metrics, batch
    release_memory()

    # the window kernel at this shape: image queries over 256 text + 4096
    # image keys, 'full' (plain causal over the image)
    B, H, Dh = n, cfg.heads, cfg.head_dim
    TT, G = cfg.text_seq_len, cfg.image_grid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def qkv():
        q, k, v = (randn(B, cfg.total_seq_len, H, Dh).transpose(1, 2)
                   for _ in range(3))
        return [x[:, :, TT:] for x in (q, k, v)] + [k[:, :, :TT],
                                                   v[:, :, :TT]]

    sets = [qkv() for _ in range(2)]
    got = window_attention(*sets[0], G, None)
    want = window_attention_plain(*sets[0], G, None)
    errs = [_cmp(torch, "window_attention 64x64 out", got[0], want[0],
                 BF16_TOL)]
    _cmp(torch, "window_attention 64x64 lse", got[1], want[1], LSE_TOL)
    dout = randn(*got[0].shape)
    bwd = [window_attention_bwd(*sets[0], got[0], got[1], dout, G, None)
           for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*bwd)):
        raise AssertionError("window_attention_bwd 64x64: two runs gave "
                             "different bits")
    bwd_plain = window_attention_bwd_plain(*sets[0], got[0], got[1], dout,
                                           G, None)
    for a, b in zip(bwd[0], bwd_plain):
        errs.append(_cmp(torch, "window_attention_bwd 64x64", a, b,
                         BF16_TOL))
    del got, want, bwd, bwd_plain
    mask = torch.from_numpy(zoo_attention_mask(
        "full", TT, G, cfg.conv_kernel)).to(dev)[TT:]

    def sdpa(q, k, v, kp, vp):
        return F.scaled_dot_product_attention(
            q, torch.cat([kp, k], 2), torch.cat([vp, v], 2), attn_mask=mask)

    img = G * G
    pairs = img * TT + img * (img + 1) // 2
    nbytes = 4 * B * H * img * Dh * 2 + 2 * B * H * TT * Dh * 2 \
        + B * H * img * 4
    bms, by = bound(nbytes, 4 * Dh * B * H * pairs)
    fwd = dict(ms=cuda_ms(lambda *a: window_attention(*a, G, None), sets,
                          10)[0],
               plain_ms=cuda_ms(lambda *a: window_attention_plain(
                   *a, G, None), sets, 4)[0],
               library_ms=cuda_ms(sdpa, sets, 10)[0],
               bound_ms=bms, bound_by=by)
    outs = [window_attention(*s, G, None) for s in sets]
    bsets = [s + [o[0], o[1], dout] for s, o in zip(sets, outs)]
    bwd_bound = bound(nbytes + 3 * B * H * img * Dh * 2
                      + 2 * B * H * TT * Dh * 2, 10 * Dh * B * H * pairs)
    bwd_t = dict(ms=cuda_ms(lambda *a: window_attention_bwd(*a, G, None),
                            bsets, 10)[0],
                 plain_ms=cuda_ms(lambda *a: window_attention_bwd_plain(
                     *a, G, None), bsets, 4)[0],
                 library_ms=_sdpa_bwd_ms(torch, F, bsets, mask, 10),
                 library="autograd backward of one SDPA call (zoo mask, "
                         "prefix and image keys as one tensor), eager",
                 bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
    window = dict(shape=(f"image q/k/v ({B},{H},{img},{Dh}) with a "
                         f"{TT}-token prefix, full, bf16"),
                  max_abs_err=max(errs), fwd=fwd, bwd=bwd_t,
                  launches_per_micro_batch=dict(
                      fwd=per_step["window_attention"],
                      bwd=per_step["window_attention_bwd"]))
    del sets, outs, bsets
    steady = step_s[1:] or step_s
    rec = dict(phase="long_context", card=smi, config=dict(
        dim=cfg.dim, depth=cfg.depth, image_grid=cfg.image_grid,
        total_seq_len=cfg.total_seq_len, attn_types=list(cfg.attn_types),
        remat_policy=cfg.remat_policy), overrides=overrides, micro=n,
        accum=1, steps=LONG_STEPS, losses=losses, step_s=step_s,
        img_per_s=n * len(steady) / sum(steady), peak_gb=peak,
        quantized_leaves=n_q, launches=launches, window_grid64=window)
    emit(**rec)
    release_memory()
    return rec


def _sdpa_bwd_ms(torch, F, bsets, mask, iters) -> float:
    """Eager ms of SDPA's autograd backward (a kept graph) for the window
    call's inputs ``(q, k, v, k_prefix, v_prefix, out, lse, dout)``: one
    call over the prefix and image keys as one tensor."""
    graphs = []
    for q, k, v, kp, vp, _, _, dout in bsets:
        keys, values = torch.cat([kp, k], 2), torch.cat([vp, v], 2)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q, keys, values)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        graphs.append((out, leaves, dout))

    def run():
        for i in range(iters):
            out, leaves, dout = graphs[i % len(graphs)]
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
    run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _cmp(torch, name, got, want, tol) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |diff| {err.max().item()} "
                             f"(tolerance {tol} + {tol}*|plain|)")
    return err.max().item()


# -- 16: PowerSGD on a sharded peer, the untied head on a mesh -------------
# ---------------------------------------------------------------------------

#: 16a: the slice at fsdp=2 and the one-process peer, PowerSGD rank 4 and
#: 14d's settings otherwise, but a 30 s matchmaking window and synchronous
#: rounds: the slice's grad step crosses gloo for every block (seconds)
#: where the peer's takes a tenth of one, so at the default 15 s the
#: peer's window closed before the slice joined (PERF.md "PR 15", call 1),
#: and an overlapped peer ran ~150 grad steps on the shared card while it
#: waited, then a last round no one joined (a slice's rounds are
#: synchronous anyway); no global clip (the sharded clip norm sums each
#: leaf's squares in another order than one process, so only an unclipped
#: update is the one-process update on the same bits)
POWERSGD_SLICE_COLLAB = dict(SLICE_COLLAB, run_id="psgd_slice",
                             grad_compression="power_sgd", powersgd_rank=4,
                             matchmaking_time=30,
                             delay_optimizer_step=False)
POWERSGD_SLICE_OPT = dict(max_grad_norm=None)


def sharded_powersgd_phase(torch, smi, release_memory, root, dev="cuda",
                           model_overrides=None,
                           epochs=SLICE_EPOCHS) -> dict:
    """16a: 14d's slice and peer with the slice sharded (``fsdp=2``: each
    process holds half of every fsdp leaf and its 8-bit state) and
    ``grad_compression="power_sgd"`` at rank 4, phase 8's flagship cut to
    ``MESH_DEPTH`` layers (every block kept), two epochs: every child
    exits 0; after every epoch the slice's whole state (gathered) and the
    peer's are bitwise equal; every round is a 2-peer group whose two
    factor rounds completed on the slice's coordinator and on the peer;
    ``wire_quantize_u8`` is launched 0 times (the factors cross as fp16).
    Records the wire bytes a peer and round by leg, the gloo traffic of
    the slice's rounds (``collectives.TRAFFIC``: the gathers of the
    gradient shards and the broadcasts of flags and factors), the rounds'
    s, the swarm's samples/s and the error feedback's bytes a process."""
    release_memory()
    overrides = {"depth": MESH_DEPTH, **(model_overrides or {})}
    outs, wall_s = _run_slice(root, dev, overrides, POWERSGD_SLICE_COLLAB,
                              dict(fsdp=2), epochs, "powersgd_slice",
                              POWERSGD_SLICE_OPT)
    rounds = _check_slice(outs, epochs, "powersgd_slice")
    if not (outs["0"]["sharded"] and outs["1"]["sharded"]):
        raise AssertionError("powersgd_slice: the slice is not sharded")
    factor_rounds = {role: [r["factor_rounds"]
                            for r in outs[role]["epochs"]]
                     for role in ("0", "peer")}
    if not all(all(r.values()) for rs in factor_rounds.values()
               for r in rs):
        raise AssertionError(f"powersgd_slice: factor rounds "
                             f"{factor_rounds}, expected both complete in "
                             "every round")
    u8 = {role: out["launches"].get("wire_quantize_u8", 0)
          for role, out in outs.items()}
    if any(u8.values()):
        raise AssertionError(f"powersgd_slice: wire_quantize_u8 launched "
                             f"{u8}")
    wire = {role: [sum(leg["bytes"] for leg in r["wire"].values())
                   for r in outs[role]["epochs"]]
            for role in ("0", "peer")}
    rec = dict(phase="powersgd_slice", card=smi, processes=2, peers=2,
               mesh=dict(dp=1, fsdp=2, tp=1, sp=1), epochs=epochs,
               depth=overrides["depth"], collab=POWERSGD_SLICE_COLLAB,
               optimizer=POWERSGD_SLICE_OPT, wall_s=wall_s,
               digests_equal=True, factor_rounds=factor_rounds,
               wire_bytes_per_round=wire, wire_quantize_u8=u8,
               rounds=rounds, swarm_samples_per_s=_slice_rate(outs),
               error_feedback_bytes={role: out["ef_bytes"]
                                     for role, out in outs.items()},
               peak_gb={role: out["peak_gb"] for role, out in outs.items()},
               launches={role: out["launches"]
                         for role, out in outs.items()})
    emit(**rec)
    release_memory()
    return rec


def untied_phase(torch, smi, release_memory, root, dev="cuda",
                 model_overrides=None, refs=None) -> dict:
    """16b: the flagship with an untied head (``lm_head/kernel`` as
    ``P("fsdp", "tp")``), cut to ``MESH_DEPTH`` layers, four processes at
    ``dp=1 fsdp=2 tp=2`` against one process: 15c's checks and limits
    (one grad step, the 8-bit update from the one-process gradients), and
    ``return_logits``' logits of rank 0's rows within 2^-4 of the logit
    range (phase 4's limit)."""
    return mesh_case_phase(torch, smi, release_memory, root, "untied",
                           dev=dev, model_overrides=model_overrides,
                           refs=refs)


def undivided_phase(torch, smi, release_memory, root, refs,
                    dev="cuda", model_overrides=None) -> None:
    """17: the meshes JAX runs whose axes its rules leave undivided. (a)
    15c's flagship at ``dp=1 fsdp=2 tp=1 sp=2`` with
    ``sequence_parallel="none"`` (every ``sp`` rank a replica on whole
    sequences), held to 15c's one-process run: 15c's limits, the
    processes' gradients bitwise equal, no collective over ``sp``. (b)
    ``xl_model_config()`` at full width cut to ``MESH_DEPTH`` layers at
    ``tp=8``, eight processes: 28 heads over 8 ranks, so each gathers
    q/k/v and attends on all 28, the projections and the vocabulary
    split; against one process, 15c's limits; the warm grad step's s and
    gloo's share of it recorded."""
    for case in ("sp_none", "xl_tp8"):
        mesh_case_phase(torch, smi, release_memory, root, case, dev=dev,
                        model_overrides=model_overrides, refs=refs)


F32_FLAGSHIP_BATCH = 1         # 10e: the f32 flagship's micro-batch


def f32_flagship_phase(torch, np, compare, dev="cuda",
                       model_overrides=None) -> dict:
    """Phase 10e: ``flagship_model_config(dtype="float32")`` at full width
    cut to ``MESH_DEPTH`` layers (each shared block called twice), random
    weights from ``SEED`` with nonzero biases and scales, one forward with
    logits and one ``grad_step`` of ``F32_FLAGSHIP_BATCH`` sample(s) on the
    card against the same weights and batch on the CPU (plain versions):
    loss, logits and every gradient within ``TINY_TOL``. Every wrapper
    launches exactly as the schedule says (``wrapper_calls``), all of the
    attention and GEGLU calls on the generic route (the GEGLU ones: the
    fused blocks' FF, ``block_3`` twice at 9 layers)."""
    import copy

    from dalle_tpu_torch.config import flagship_model_config
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.transformer import wrapper_calls
    from dalle_tpu_torch.ops import (GENERIC_LAUNCHES, LAUNCHES,
                                     reset_launches)
    from dalle_tpu_torch.training.steps import grad_step
    t_phase = time.perf_counter()
    cfg = flagship_model_config(**{"dtype": "float32", "depth": MESH_DEPTH,
                                   **(model_overrides or {})})
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    with torch.no_grad():   # nonzero biases and scales: a dropped term shows
        for pname, prm in cpu_model.named_parameters():
            if pname.endswith(("bias", "scale")):
                prm.add_(torch.from_numpy(0.05 * rng.standard_normal(
                    prm.shape)).to(prm.dtype))
    card_model = copy.deepcopy(cpu_model).to(dev)
    b = F32_FLAGSHIP_BATCH
    batch = {"text": torch.from_numpy(rng.integers(
                 1, cfg.vocab_text, (b, cfg.text_seq_len))),
             "image": torch.from_numpy(rng.integers(
                 0, cfg.vocab_image, (b, cfg.image_seq_len)))}
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_c, _, logits_c = cpu_model(batch["text"], batch["image"],
                                        return_logits=True)
    gloss_c, _, grads_c = grad_step(cpu_model, batch)
    cpu_s = time.perf_counter() - t0
    dbatch = {key: val.to(dev) for key, val in batch.items()}
    _sync(torch, dev)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_g, _, logits_g = card_model(dbatch["text"], dbatch["image"],
                                         return_logits=True)
    gloss_g, _, grads_g = grad_step(card_model, dbatch)
    _sync(torch, dev)
    card_s = time.perf_counter() - t0
    launches, generic = dict(LAUNCHES), dict(GENERIC_LAUNCHES)
    fwd_calls = wrapper_calls(cfg, training=False)
    step_calls = wrapper_calls(cfg, training=True)
    expected = {key: fwd_calls[key] + step_calls[key] for key in LAUNCHES}
    expected_generic = {key: expected[key] for key in GENERIC_LAUNCHES}
    if launches != expected or generic != expected_generic:
        raise AssertionError(
            f"f32 flagship: launches {launches} (generic {generic}) != the "
            f"schedule's {expected} (generic {expected_generic})")
    errs = {"loss": compare("f32 flagship loss", loss_g.cpu(), loss_c,
                            TINY_TOL),
            "logits": compare("f32 flagship logits", logits_g.cpu(),
                              logits_c, TINY_TOL),
            "grad_step loss": compare("f32 flagship grad_step loss",
                                      gloss_g.cpu(), gloss_c, TINY_TOL)}
    errs["gradients"] = max(compare(f"f32 flagship gradient {key}",
                                    grads_g[key].cpu(), g, TINY_TOL)
                            for key, g in grads_c.items())
    rec = dict(widths=dict(dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
                           head_dim=cfg.head_dim, vocab_text=cfg.vocab_text,
                           vocab_image=cfg.vocab_image, dtype=cfg.dtype),
               batch=b, loss_card=float(loss_g), loss_cpu=float(loss_c),
               max_abs_err=errs, tolerance=f"rtol=atol={TINY_TOL}",
               launches=launches, generic_launches=generic, card_s=card_s,
               cpu_s=cpu_s, seconds=time.perf_counter() - t_phase)
    emit(phase="generic_f32_flagship", **rec)
    del cpu_model, card_model, grads_c, grads_g, logits_c, logits_g
    return rec


def dryrun_phase(smi) -> dict:
    """15e: ``entry.dryrun_multichip(4)`` on the card: four processes of
    one ``gloo`` group, its cases' lines with finite losses."""
    import contextlib
    import io

    from dalle_tpu_torch.entry import dryrun_multichip
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4, device="cuda", timeout=MESH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("dryrun_multichip ok:")]
    losses = [float(ln.rsplit("loss=", 1)[1]) for ln in lines]
    if len(lines) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dryrun_multichip(4): {buf.getvalue()}")
    rec = dict(phase="dryrun_multichip", card=smi, processes=4,
               lines=lines, seconds=secs)
    emit(**rec)
    return rec


#: the second process's niceness: the first process's phases (11-14c),
#: whose swarm rounds keep time, come first where both want a CPU core
MULTIPROCESS_NICE = 10
#: the second process must have ended this many seconds after the start
MULTIPROCESS_DEADLINE_S = 1150


def multiprocess_phases(torch, smi, root) -> None:
    """14d-17, the paths of more than one process (a slice beside a peer,
    the meshes of 15-17, the dry run), in the order of their numbers,
    each with the launch counts set to 0 just before it and read just
    after. ``main()`` runs them in a second process of this script
    (``--multiprocess``) beside phases 11-14c."""
    import tempfile
    slice_phase(torch, smi, release_memory, root)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as refs:
        for case in ("ring", "fsdp_tp", "ulysses"):
            mesh_case_phase(torch, smi, release_memory, root, case,
                            refs=refs)
        dryrun_phase(smi)
        sharded_powersgd_phase(torch, smi, release_memory, root)
        untied_phase(torch, smi, release_memory, root, refs=refs)
        undivided_phase(torch, smi, release_memory, root, refs)


def start_multiprocess(root):
    """Starts ``--multiprocess`` (phases 14d-17) in a session of its own,
    its output into anonymous temporary files; ``(process, out, err)``."""
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multiprocess",
         "--t-start", repr(T_START)],
        cwd=root, stdout=out, stderr=err, start_new_session=True)
    return proc, out, err


def stop_multiprocess(second, deadline_s=None) -> int:
    """Waits for the second process until ``deadline_s`` after the start
    (``None``: not at all), then kills its session, the groups it spawned
    included; prints its output (its records also go to ``RECORDS``) and
    returns its exit code (``None`` if it was still running)."""
    import signal
    proc, out, err = second
    rc = proc.poll()
    if rc is None and deadline_s is not None:
        try:
            rc = proc.wait(timeout=max(
                deadline_s - (time.perf_counter() - T_START), 1))
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()
    out.seek(0)
    err.seek(0)
    sys.stderr.write(err.read())
    sys.stderr.flush()
    for line in out.read().splitlines():
        print(line, flush=True)
        if line.startswith('{"phase"'):
            RECORDS.append(json.loads(line))
    out.close()
    err.close()
    return rc


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write every record to this JSON file")
    parser.add_argument("--profile", default=None, metavar="PATH",
                        help="also trace one flagship forward and one "
                             "training micro-batch with torch.profiler and "
                             "write their tables to PATH")
    parser.add_argument("--multiprocess", action="store_true",
                        help="run only phases 14d-17 (the run without it "
                             "starts them so, beside phases 11-14c)")
    parser.add_argument("--t-start", type=float, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if args.multiprocess:
        global T_START
        if args.t_start is not None:
            T_START = args.t_start      # one clock for both processes' t_s
        os.nice(MULTIPROCESS_NICE)
        multiprocess_phases(torch, nvidia_smi(), root)
        return 0

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
                                               POLICY_CONV, POLICY_LINE,
                                               WINDOW_GENERIC_PASSES,
                                               attention_route,
                                               kernel_resources,
                                               line_attention,
                                               line_attention_bwd,
                                               line_attention_bwd_plain,
                                               line_attention_plain,
                                               window_attention,
                                               window_attention_bwd,
                                               window_attention_bwd_plain,
                                               window_attention_plain,
                                               window_generic_kernel)
    from dalle_tpu_torch.ops import geglu as geglu_module
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
    from dalle_tpu_torch.time_geglu import generic_entry
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
    # every position of one sequence, on the flagship's weights cut to
    # GEN_DEPTH layers (phase 5's model: the same five blocks)
    del model, fn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gcfg = flagship_model_config(param_dtype="bfloat16", depth=GEN_DEPTH)
    model = init_params(
        gcfg, torch.Generator(device=dev).manual_seed(SEED)).eval()
    with torch.inference_mode():
        _, _, logits = model(text[:1], image[:1], return_logits=True)
        labels = torch.cat([text[:1], image[:1] + cfg.vocab_text], 1)
        inputs = torch.cat([torch.full((1, 1), cfg.vocab_total, device=dev,
                                       dtype=labels.dtype),
                            labels[:, :-1]], 1)
        cache = init_cache(gcfg, 1, dev)
        tables = decode_tables(gcfg, dev)
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
    # places through the layers (at 64 layers ~sqrt(64) = 8 independent
    # roundings of 2^-8), doubled for margin: 2^-4 of the logit range
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
    emit(phase="decode_vs_forward", positions=T, depth=GEN_DEPTH,
         max_abs_err=diff,
         tolerance=dec_tol, logit_range=scale, argmax_agreement=agree,
         decode_s=dec_s)

    # -- 5. generation ----------------------------------------------------
    del logits, got, cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    captions = torch.from_numpy(rng.integers(1, cfg.vocab_text,
                                             (2, TT))).to(dev)
    prompts = captions.repeat_interleave(2, dim=0)
    # two seeds a caption; rows 0-2 temperature 1 and top-k 64, row 3
    # greedy: the four requests of the serving waves below
    seeds = [1, 2, 1, 2]
    knobs = [(1.0, 64, 1.0)] * 3 + [(0.0, 64, 1.0)]
    sampling = SamplingConfig(*(torch.tensor(k, device=dev)
                                for k in zip(*knobs)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = generate_images(model, prompts, seeds, sampling)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if (tuple(codes.shape) != (4, cfg.image_seq_len)
            or not bool(((codes >= 0) & (codes < cfg.vocab_image)).all())):
        raise AssertionError(f"generated codes out of range: "
                             f"{tuple(codes.shape)}, {codes.min().item()}.."
                             f"{codes.max().item()}")
    emit(phase="generate", images=4, captions=2, seeds=seeds,
         sampling=[dict(zip(SamplingConfig._fields, k)) for k in knobs],
         seconds=gen_s, img_per_s=4 / gen_s,
         ms_per_position=gen_s * 1e3 / T,
         distinct_codes=int(codes.unique().numel()))

    serving_phase(torch, np, dev, smi, model, captions, seeds, knobs,
                  codes.cpu().numpy(), release_memory)

    del model, codes
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
        attn_src = "dalle_tpu_torch/csrc/attention_window_generic.cuh"
        ff_src = "dalle_tpu_torch/csrc/geglu_generic.cu"

        def rand(dtype, *shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dtype)

        # (a) each (dtype, head_dim) instance: a text call, axial_row and
        # axial_col calls with a prefix and a conv window call, forward and
        # backward
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
                    ("line axial_row", line_attention, line_attention_bwd,
                     line_attention_plain, line_attention_bwd_plain,
                     (*i_ops[:3], *t_ops[1:3]), i_ops[3], (gq, gq, False)),
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
        # the generic kernels of every instance and policy: registers and
        # local bytes from the runtime, spill stores from ptxas (when this
        # run built it); none may spill
        gen_kernels = {
            key: [res["registers"], res["local_bytes"],
                  ptxas.get(key, {}).get("spill_stores")]
            for key, res in resources.items() if key.startswith("attn_win_")}
        spilled = {key: r for key, r in gen_kernels.items()
                   if r[1] or r[2]}
        if spilled:
            raise AssertionError(f"generic attention kernels spill: "
                                 f"{spilled}")
        emit(phase="generic_attention_instances", instances=instances,
             shape=f"B={bq}, H={hq}, text {tq}, grid {gq}; text call, "
                   "axial_row and axial_col calls with the text prefix, "
                   "conv_like hw=1 call with the text prefix; backward "
                   "twice, bitwise",
             generic_kernels=gen_kernels,
             generic_kernels_fields=["registers", "local_bytes",
                                     "spill_stores"])

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
                       errs, shape, source=attn_src):
            bms, by = bound(nbytes, 4 * Dh * B * H * pairs_, F32_FLOP_PER_S)
            return dict(name=name, route="cuda", source=source,
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
        # the tensor cores' bound of three TF32 passes, and each instance's
        # registers and spills (ptxas, when this run built the source)
        for name, instances in (
                ("geglu_ff_generic", ("geglu_generic_gate_f32",
                                      "geglu_generic_out_f32")),
                ("geglu_ff_bwd_generic", ("geglu_generic_bwd_f32",))):
            rec = recs[name]
            rec["bound_ms_3xtf32"] = 6 * M * D * K / (TF32_FLOP_PER_S / 3) \
                * 1e3
            rec["ms_vs_cublas"] = rec["ms"] / rec["cublas_ms"]
            rec["resources"] = {n: ptxas.get(n, {}) for n in instances}
        # the same for the attention pairs (f32 at head_dim 64): the line
        # pair of one axial_row layer, the conv_like window pair
        for name, flops, passes, policy in (
                ("line_attention_generic",
                 4 * Dh * B * H * (text_pairs + row_pairs),
                 WINDOW_GENERIC_PASSES[:1], POLICY_LINE),
                ("line_attention_bwd_generic",
                 10 * Dh * B * H * (text_pairs + row_pairs),
                 WINDOW_GENERIC_PASSES[1:], POLICY_LINE),
                ("window_attention_generic", 4 * Dh * B * H * win_pairs,
                 WINDOW_GENERIC_PASSES[:1], POLICY_CONV),
                ("window_attention_bwd_generic", 10 * Dh * B * H * win_pairs,
                 WINDOW_GENERIC_PASSES[1:], POLICY_CONV)):
            rec = recs[name]
            rec["bound_ms_3xtf32"] = flops / (TF32_FLOP_PER_S / 3) * 1e3
            rec["ms_vs_library"] = rec["ms"] / rec["library_ms"]
            keys = [window_generic_kernel(f32, Dh, policy, p)
                    for p in passes]
            rec["resources"] = {n: resources[n] | ptxas.get(n, {})
                                for n in keys}
        for rec in recs.values():
            rec["tf32"] = torch.backends.cuda.matmul.allow_tf32
            emit(phase="kernel_check", **rec)

        # bf16 through the generic entry points, called directly: at widths
        # only they take, and at the flagship's (where the wrappers take
        # the fast kernels, timed in phases 2 and 6 of this run)
        for db_, kb_ in ((1000, 4000), (D, K)):
            bsets = [[rand(bf, *sh, scale=sc) for sh, sc in (
                ((M, db_), 1.0), ((db_, kb_), db_ ** -0.5),
                ((db_, kb_), db_ ** -0.5), ((kb_, db_), kb_ ** -0.5),
                ((kb_,), 0.1), ((kb_,), 0.1), ((db_,), 0.1), ((M, db_), 1.0))]
                for _ in range(2)]
            gfwd, gbwd = generic_entry(geglu_module, M, db_, kb_, bf, dev)
            fwd_args = [st[:7] for st in bsets]
            bwd_args = [st[:6] + st[7:] for st in bsets]
            what = f"generic entry bf16 M={M} d={db_} K={kb_}"
            err_f = compare(f"{what} forward", twice(
                f"{what} forward", lambda *a: (gfwd(*a),), *fwd_args[0])[0],
                geglu_ff_plain(*fwd_args[0]), BF16_TOL)
            got = twice(f"{what} backward", gbwd, *bwd_args[0])
            err_b = max(compare(f"{what} backward {n}", a, w, BF16_BWD_TOL)
                        for n, a, w in zip(("dh|dg", "hg"), got,
                                           geglu_ff_bwd_plain(*bwd_args[0])))
            flops = 6 * M * db_ * kb_
            rec = dict(
                shape=f"x, dO ({M}, {db_}), Wi/Wg ({db_}, {kb_}), Wo "
                      f"({kb_}, {db_}) bf16",
                max_abs_err=dict(forward=err_f, backward=err_b),
                tolerance=f"rtol=atol={BF16_TOL} (forward), {BF16_BWD_TOL} "
                          "(backward tensors)", bitwise_reproducible=True,
                fwd_ms=cuda_ms(gfwd, fwd_args, 10)[0],
                bwd_ms=cuda_ms(gbwd, bwd_args, 10)[0],
                bound_ms=bound((2 * M * db_ + 3 * db_ * kb_ + 2 * kb_ + db_)
                               * 2, flops)[0],
                bwd_bound_ms=bound((2 * M * db_ + 3 * db_ * kb_ + 2 * kb_
                                    + 3 * M * kb_) * 2, flops)[0],
                cublas_fwd_ms=cuda_ms(
                    lambda x, w, h, wo: (torch.matmul(x, w),
                                         torch.matmul(h, wo)),
                    [(st[0], torch.cat([st[1], st[2]], dim=1),
                      rand(bf, M, kb_), st[3]) for st in bsets], 10)[0],
                cublas_bwd_ms=cuda_ms(
                    lambda x, w, do, wo: (torch.matmul(x, w),
                                          torch.matmul(do, wo.t())),
                    [(st[0], torch.cat([st[1], st[2]], dim=1), st[7], st[3])
                     for st in bsets], 10)[0],
                resources={n: ptxas.get(n, {}) for n in (
                    "geglu_generic_gate_bf16", "geglu_generic_out_bf16",
                    "geglu_generic_bwd_bf16")})
            if (db_, kb_) == (D, K):
                rec["fast_fwd_ms"] = kernels["geglu_ff"]["ms"]
                rec["fast_bwd_ms"] = kernels["geglu_ff_bwd"]["ms"]
            emit(phase="generic_geglu_bf16_entry", **rec)
            del bsets, fwd_args, bwd_args, got

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
        errs += [compare(f"generic geglu_ff_bwd bf16 {n}", a, w,
                         BF16_BWD_TOL)
                 for n, a, w in zip(("dh|dg", "hg"), got, geglu_ff_bwd_plain(
                     *ops[:6], ops[7]))]
        emit(phase="generic_geglu_bf16", shape=f"M={mb_}, d={db_}, K={kb_}"
             " bf16", max_abs_err=max(errs), tolerance=f"rtol=atol="
             f"{BF16_TOL} (output), {BF16_BWD_TOL} (backward tensors)",
             bitwise_reproducible=True)
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
        del cpu_model, card_model, grads_g, grads_c, logits_g, logits_c
        release_memory()

        # (e) the f32 flagship at full width on the card against the CPU
        f32_flagship_phase(torch, np, compare, dev=dev)
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
    heads = head_chunk_peaks(torch, state.model, lambda: step(state, batch),
                             rounds=HEAD_ROUNDS)
    heads["head_alone"] = head_pass_ms(torch, tcfg)
    emit(phase="train", micro=MICRO, accum=ACCUM, steps=TRAIN_STEPS,
         optimizer="fp32 LAMB, OptimizerConfig(state_bits=32, "
                   "warmup_steps=2, total_steps=100)",
         losses=losses, grad_norms=norms, loss_fall=losses[0] - losses[-1],
         launches=train_launches, launches_per_micro_batch=per_micro,
         step_s=step_s, step_s_mean=sum(steady) / len(steady),
         img_per_s=MICRO * ACCUM * len(steady) / sum(steady),
         peak_mem_gb=fp32["peak"] / 1e9, head_chunk_peaks=heads,
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
    heads = head_chunk_peaks(torch, state.model, lambda: step(state, batch),
                             rounds=HEAD_ROUNDS)
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
         head_chunk_peaks=heads, mem_before_gb=mem_base / 1e9, card=smi)
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

    # -- 15a. the long-context model, its window kernel timed alone -------
    long_context_phase(torch, smi, release_memory, cuda_ms)

    # -- 14d-17 in a second process, beside 11-14c ------------------------
    second = start_multiprocess(root)
    try:
        # -- 11. the trainer peer -----------------------------------------
        trainer_phase(torch, smi, kernels, release_memory)

        # -- 12. real data, text prompts through the router, access tokens
        data_phase(torch, smi, root)
        release_memory()
        router_phase(torch, np, smi, root,
                     lambda: init_params(flagship_model_config(
                         param_dtype="bfloat16", depth=ROUTER_DEPTH),
                         torch.Generator(device=dev).manual_seed(
                             SEED)).eval(),
                     release_memory)
        auth_rounds = auth_phase(torch, smi, release_memory)

        # -- 13. the stacked dense_scan layout, the assistant, faults -----
        dense_phase(torch, smi, release_memory)
        assist_chaos_phase(torch, smi, release_memory, auth_rounds)

        # -- 14a-c. save_ctx on XL, offload, the XL CLI -------------------
        xl_phase(torch, smi, release_memory)
        offload_phase(torch, smi, release_memory)
        xl_cli_phase(torch, smi, release_memory, root)
    except BaseException:
        stop_multiprocess(second)
        raise
    # -- 14d, 15b-e, 16, 17: the slice, the meshes, the dry run -----------
    rc = stop_multiprocess(second, MULTIPROCESS_DEADLINE_S)
    if rc != 0:
        raise AssertionError(
            "phases 14d-17 (the second process): " +
            (f"still running {MULTIPROCESS_DEADLINE_S} s after the start"
             if rc is None else f"exit code {rc}"))

    # -- 18. kernels line and the end ------------------------------------
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
