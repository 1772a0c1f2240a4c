"""Serving traffic: a closed loop of clients in front of the program's
``DecodeEngine``; each client submits a caption, waits for its codes and
submits the next.

Parameters (``traffic/<mix>.json``): ``clients``, the engine's ``n_slots``
and ``steps_per_call``, ``caption_len`` (as the training mixes),
``stagger_chunks`` (client ``i`` starts once the engine has run ``i``
times that many chunks, so the live slots spread over the positions as
independent arrivals spread them), the sampled requests' ``temperature``,
``top_k`` and ``top_p`` (every other request of a client is greedy, for
the check), ``profile_chunks`` (the chunks a ``--trace 1`` run traces
after the window, with the clients still running). The cell's file
gives ``check_requests`` and the ``limits``.

The window opens once every client's first request has been admitted and
lasts ``--seconds``; no request is submitted after it (a traced run
profiles first). ``serve_img_s`` is the images' worth of decoding in the
window: the slot-positions the engine decoded (live slots times
``steps_per_call`` at each chunk its ``record_step`` stamps in the
window) over the positions of one request (text and image), over the
window's seconds; ``serve_latency_p95_s`` is over the requests completed
in the window, from the client's submit to the codes in its hands.
Requests still running at the close are cancelled.

Once the engine and the model are freed, the reference reads the served
sequences of ``check_requests`` greedy requests that finished, drawn from
the seed (the outcome's ``record["checked"]``), and the check is the
widest gap by which a served code's logit lies below the reference's
best code at its position; ``lost``, the requests of the window that
failed, has the limit 0.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import dalle as ref


def caption(rng: np.random.Generator, m: Dict, lo: int, hi: int
            ) -> np.ndarray:
    """One caption as the collator pads it (harness.caption_batch)."""
    n = int(rng.integers(lo, hi + 1))
    text = np.zeros(m["text_seq_len"], np.int64)
    text[:n - 1] = rng.integers(2, m["vocab_text"], n - 1)
    text[n - 1] = 1
    return text


def counting_metrics(n_slots: int):
    """The engine's ``ServingMetrics`` with every chunk, admission, submit
    and first code stamped on the harness's clock."""
    from dalle_tpu_torch.serving.metrics import ServingMetrics

    class Counting(ServingMetrics):
        def __init__(self):
            super().__init__(n_slots=n_slots, interval_s=3600.0)
            self.chunks: List = []
            self.admits: List = []
            self.submits: Dict[int, float] = {}
            self.firsts: Dict[int, float] = {}
            self.hook = None

        def record_step(self, live_slots, queue_depth):
            super().record_step(live_slots, queue_depth)
            self.chunks.append((time.perf_counter(), live_slots))
            if self.hook is not None:
                self.hook()

        def record_admit(self, rid, prefix_hit=None):
            super().record_admit(rid, prefix_hit)
            self.admits.append((time.perf_counter(), rid))

        def record_submit(self, rid, *args, **kwargs):
            super().record_submit(rid, *args, **kwargs)
            self.submits[rid] = time.perf_counter()

        def record_first_code(self, rid):
            super().record_first_code(rid)
            self.firsts.setdefault(rid, time.perf_counter())

    return Counting()


def profile_chunks(engine, metrics, prof, n: int, wait) -> harness.Trace:
    """Trace ``n`` chunks of the running engine. The profiler starts and
    stops on the engine's own thread, between two chunks (from the
    metrics' per-chunk hook), never beside a graph replay on another
    thread: a first chunk warms the tracer, the next ``n`` are traced."""
    state = {"chunk": 0, "error": None}
    done = threading.Event()

    def hook():
        k = state["chunk"]
        state["chunk"] = k + 1
        try:
            if k == 0:
                prof.start()
            elif k == 1:
                prof.stop(sync=False)
                prof.start()
            elif k == n + 1:
                prof.stop(sync=False)
                metrics.hook = None
                done.set()
        except Exception as err:  # noqa: BLE001 - re-raised on the caller
            state["error"] = err
            metrics.hook = None
            done.set()

    metrics.hook = hook
    wait(done.is_set, "the traced chunks")
    if state["error"] is not None:
        raise state["error"]
    return prof.result()


def run(r: harness.Run) -> harness.Outcome:
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import ServingConfig
    from dalle_tpu_torch.models.decode import SamplingConfig
    from dalle_tpu_torch.serving.engine import DecodeEngine

    cell, tr, m = r.cell, r.cell.traffic, r.cell.model
    dev = resolve_device(r.device) if r.device == "cuda" else \
        torch.device(r.device)
    cuda = dev.type == "cuda"
    n_clients = tr["clients"]
    lo, hi = tr["caption_len"]

    cfg = harness.model_config(cell, "serve")
    wdtype = getattr(torch, cfg.param_dtype)
    model = harness.build_model(cfg, ref.make_weights(m, r.seed, dev,
                                                      wdtype), dev)
    model.eval()
    metrics = counting_metrics(tr["n_slots"])
    engine = DecodeEngine(model, serving=ServingConfig(
        n_slots=tr["n_slots"], steps_per_call=tr["steps_per_call"]),
        metrics=metrics)
    engine.start()

    stop_submit = threading.Event()
    done: List[Dict] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        rng = np.random.default_rng([int(r.seed) % 2 ** 63, i])
        k = 0
        while not stop_submit.is_set():
            text = caption(rng, m, lo, hi)
            seed = int(rng.integers(0, 2 ** 62))
            greedy = (i + k) % 2 == 0
            sampling = SamplingConfig(
                0.0 if greedy else tr["temperature"], tr["top_k"],
                tr["top_p"])
            t_s = time.perf_counter()
            row = {"client": i, "k": k, "greedy": greedy, "text": text,
                   "submit": t_s}
            try:
                res = engine.submit(text, rng=seed, sampling=sampling)
                row["codes"] = res.result(timeout=tr["timeout_s"])["codes"]
            except Exception as err:  # noqa: BLE001 - counted as a failure
                row["error"] = repr(err)
                if not engine.alive:
                    stop_submit.set()
            row["done"] = time.perf_counter()
            with lock:
                done.append(row)
            k += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    deadline = time.perf_counter() + tr["timeout_s"]

    def wait(done_, what: str) -> None:
        while not done_():
            if not engine.alive or time.perf_counter() > deadline:
                raise harness.BenchError(f"set-up stalled waiting for {what}"
                                         f" (engine alive: {engine.alive})")
            time.sleep(0.002)

    try:
        for i, th in enumerate(threads):
            wait(lambda: len(metrics.chunks) >= i * tr["stagger_chunks"],
                 f"chunk {i * tr['stagger_chunks']}")
            th.start()
        wait(lambda: len(metrics.admits) >= n_clients, "the admissions")
        t0 = time.perf_counter()
        setup_s = time.time() - r.t_start
        time.sleep(max(0.0, t0 + r.seconds - time.perf_counter()))
        t1 = time.perf_counter()
        trace = None
        if r.traced:
            trace = profile_chunks(engine, metrics, harness.Profiler(
                r.scratch, cuda), tr["profile_chunks"], wait)
        stop_submit.set()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        stop_submit.set()
        engine.stop(drain=False, timeout=30.0)
        for th in threads:
            th.join(timeout=60.0)
    alive = [th.name for th in threads if th.is_alive()]
    if alive:
        raise harness.BenchError(f"clients still running: {alive}")

    rows = sorted(done, key=lambda row: (row["client"], row["k"]))
    ok = [row for row in rows if "codes" in row]
    in_window = [row for row in ok if t0 <= row["done"] <= t1]
    lost = [row for row in rows if "error" in row and row["done"] <= t1]
    chunks = [(t, live) for t, live in metrics.chunks if t0 <= t <= t1]
    positions = sum(live for _, live in chunks) * tr["steps_per_call"]
    e2e = {"serve_img_s": positions / (m["text_seq_len"]
                                       + m["image_grid"] ** 2) / (t1 - t0),
           "serve_latency_p95_s": harness.percentile(
               [row["done"] - row["submit"] for row in in_window], 95.0),
           "setup_s": setup_s}
    firsts = [metrics.firsts[rid] - metrics.submits[rid]
              for rid in metrics.firsts
              if rid in metrics.submits and t0 <= metrics.firsts[rid] <= t1]
    record = {"model": m, "window_s": t1 - t0, "chunks": chunks,
              "steps_per_call": tr["steps_per_call"],
              "n_slots": tr["n_slots"], "ttft_s": firsts, "trace": trace}
    device = r.device_info(peak)

    del engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    greedy = [row for row in ok if row["greedy"] and row["done"] <= t1]
    pick = np.random.default_rng(int(r.seed) % 2 ** 63).permutation(
        len(greedy))[:cell.limits["check_requests"]]
    record["checked"] = [greedy[j] for j in sorted(pick)]
    widest = served_gap(m, r.seed, record["checked"], dev,
                        wdtype) if len(pick) else float("inf")
    limits = cell.limits["limits"]
    checks = {"logit_gap": (widest, limits["logit_gap"]),
              "lost": (float(len(lost)), 0.0)}
    return harness.Outcome(attempted=len(in_window) + len(lost),
                           failed=len(lost), e2e=e2e, record=record,
                           checks=checks, device=device, trace=trace)


def served_gap(m: Dict, seed: int, rows: List[Dict], device,
               wdtype=torch.bfloat16, prec: str = "f32") -> float:
    """The widest gap, over the served codes of ``rows``, between the
    reference's best image logit at a position and the served code's;
    with ``prec`` other than f32, the codes are the ones that precision's
    reference puts first (the control)."""
    ref.no_tf32()
    weights = {k: v.float() for k, v in
               ref.make_weights(m, seed, device, wdtype).items()}
    widest = 0.0
    for row in rows:
        text = torch.as_tensor(row["text"], device=device)
        codes = torch.as_tensor(np.asarray(row["codes"]), device=device
                                ).long()
        logits = ref.image_logits(weights, m, text, codes)
        if prec != "f32":
            codes = ref.image_logits(weights, m, text, codes, prec
                                     ).argmax(-1)
        best = logits.max(-1).values
        served = logits.gather(-1, codes[:, None])[:, 0]
        widest = max(widest, float((best - served).max()))
    return widest
