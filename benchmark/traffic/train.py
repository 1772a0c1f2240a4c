"""Training traffic: one trainer in a closed loop, a new synthetic batch
each step, every step one optimizer update.

Parameters (``traffic/<mix>.json``): ``micro`` and ``accum`` (a step is
``accum`` micro-batches of ``micro`` images), ``caption_len`` (the
shortest and longest caption, eos included, padded to the text length
with a loss mask, as the collator of learning-at-home/dalle pads),
``optimizer`` (``OptimizerConfig`` fields over its defaults),
``profile_steps`` (steps traced in a ``--trace 1`` run, after one warming
step). The cell's file (``workloads/<cell>.json``) gives ``ref_steps``
(2 or 3), ``ref_rows`` (samples the reference takes at a time) and the
``limits``.

The run: weights from the seed on the card; the program's model, 8-bit
LAMB and ``TrainState``; three set-up steps through the window's own call
on the first three batches (they warm every shape); then the window:
steps until ``--seconds`` have passed, each ended by reading its loss
(a synchronisation, as a trainer that logs its loss makes). With
``--trace 1`` the window runs ``grad_step`` and ``apply_step`` apart,
timing the update, and a traced stretch follows it.

Once the window has closed and the program's state is freed, the
reference follows the first ``ref_steps`` steps from the same weights and
batches, and the comparison takes each step's loss and gradient norm
(before the clip), the first gradient by leaf as the optimizer holds it
after one step (its first moment over ``1 - beta1``), and each leaf's
change after ``ref_steps`` steps. A leaf is judged by the gap of the two
norms against the reference's norm of that leaf or of the median leaf,
whichever is larger: ``grad_leaf`` is the worst leaf's first gradient;
leaves whose first gradient in the reference is under a thousandth of
the median leaf's move by round-off alone and are left out of the
change. The cell's file gives each of these numbers its limit.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from benchmark import harness
from benchmark.reference import dalle as ref
from benchmark.reference import lamb8bit as rlamb

SETUP_STEPS = 3
ZERO_GRAD = 1e-3


class Feed:
    """Batches made on the device from the seed, a new one each call."""

    def __init__(self, m: Dict, traffic: Dict, seed: int, device,
                 rows: int):
        self.m, self.rows, self.device = m, rows, device
        self.lo, self.hi = traffic["caption_len"]
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) + 0x9E3779B9) % 2 ** 63)

    def next(self) -> Dict[str, torch.Tensor]:
        m = self.m
        text, tmask = harness.caption_batch(
            self.gen, self.rows, m["text_seq_len"], self.lo, self.hi,
            m["vocab_text"], self.device)
        n = m["image_grid"] ** 2
        image = torch.randint(0, m["vocab_image"], (self.rows, n),
                              generator=self.gen, device=self.device)
        mask = torch.cat([tmask, torch.ones(self.rows, n,
                                            device=self.device)], 1)
        return {"text": text, "image": image, "mask": mask}


def _moment(moment) -> torch.Tensor:
    if hasattr(moment, "codes"):
        return rlamb.dequantize(moment.codes, moment.absmax, moment.shape,
                                moment.signed)
    return moment


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def leaf_gaps(prog: Dict[str, float], refs: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's ``|prog - ref|`` over the larger of the reference's norm
    of that leaf and of the median leaf."""
    names = [n for n in refs if keep is None or keep(n)]
    med = harness.median([refs[n] for n in names])
    return {n: abs(prog[n] - refs[n]) / max(refs[n], med, 1e-30)
            for n in names}


def start(cell: harness.Cell, seed: int, dev) -> Dict:
    """The set-up of a run: weights from the seed on ``dev``, the
    program's model, 8-bit LAMB and ``TrainState``, and the first
    ``SETUP_STEPS`` steps through the window's own call. Returns the
    state, the optimizer, the feed (at the window's first batch), the
    program's readings and the batches the reference follows."""
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.training import steps as psteps

    tr, m = cell.traffic, cell.model
    accum = tr["accum"]
    ref_steps = cell.limits["ref_steps"]
    opt_cfg = opt_cfg_of(tr)
    cfg = harness.model_config(cell, "train")
    weights = ref.make_weights(m, seed, dev)
    model = harness.build_model(cfg, weights, dev)
    model.train()
    tx = make_optimizer(opt_cfg)
    state = psteps.TrainState.create(model, tx)
    feed = Feed(m, tr, seed, dev, tr["micro"] * accum)
    first = [feed.next() for _ in range(SETUP_STEPS)]
    kept = [{k: v.clone() for k, v in b.items()} for b in first[:ref_steps]]
    prog = {"loss": [], "grad_norm": []}
    for k, batch in enumerate(first):
        state, met = psteps.train_step(state, batch, tx, accum_steps=accum)
        prog["loss"].append(float(met["loss"]))
        prog["grad_norm"].append(float(met["grad_norm"]))
        if k == 0:
            prog["grad_leaf"] = {
                n: float(_moment(mu).norm()) / (1 - opt_cfg.beta1)
                for n, mu in state.opt_state.mu.items()}
        if k + 1 == ref_steps:
            with torch.no_grad():
                prog["update_leaf"] = {
                    n: float((p.float() - weights[n]).norm())
                    for n, p in model.named_parameters()}
    return {"state": state, "tx": tx, "feed": feed, "prog": prog,
            "kept": kept}


def run(r: harness.Run) -> harness.Outcome:
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.training import steps as psteps

    cell, tr, m = r.cell, r.cell.traffic, r.cell.model
    dev = resolve_device(r.device) if r.device == "cuda" else \
        torch.device(r.device)
    accum = tr["accum"]
    rows = tr["micro"] * accum

    # --- set-up: weights, the program's state, three steps -------------
    s = start(cell, r.seed, dev)
    state, tx, feed = s["state"], s["tx"], s["feed"]
    _sync(dev)
    peak_setup = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # --- the window -------------------------------------------------------
    update_ms: List[float] = []

    def one_step() -> float:
        nonlocal state
        batch = feed.next()
        if not r.traced:
            state, met = psteps.train_step(state, batch, tx,
                                           accum_steps=accum)
            return float(met["loss"])
        _, aux, grads = psteps.grad_step(state.model, batch, accum)
        _sync(dev)
        t_a = time.perf_counter()
        state = psteps.apply_step(state, grads, tx)
        _sync(dev)
        update_ms.append((time.perf_counter() - t_a) * 1e3)
        return float(aux["loss"])

    setup_s = time.time() - r.t_start
    t0 = time.perf_counter()
    n_steps = failed = 0
    while True:
        failed += not math.isfinite(one_step())
        n_steps += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    window_update_ms = list(update_ms)
    peak_window = _peak(dev)
    trace = None
    if r.traced:
        prof = harness.Profiler(r.scratch, dev.type == "cuda")
        prof.warm(one_step)
        steps = tr["profile_steps"]
        trace, _ = prof.trace(lambda: [one_step() for _ in range(steps)])
        trace.units = steps
    record = {"model": m, "rows": rows, "steps": n_steps,
              "window_s": window_s, "update_ms": window_update_ms,
              "peak_window_bytes": peak_window, "trace": trace}
    e2e = {"train_img_s": n_steps * rows / window_s, "setup_s": setup_s}
    device = r.device_info(max(peak_setup, peak_window))

    # --- the reference, with the program's state freed ---------------------
    prog, kept = s["prog"], s["kept"]
    del state, tx, feed, s
    free(dev)
    ref_steps = cell.limits["ref_steps"]
    refs = follow(m, r.seed, kept, accum, ref_steps, cell.limits["ref_rows"],
                  opt_cfg_of(tr), dev)
    got = readings(prog, refs, ref_steps)
    limits = cell.limits["limits"]
    checks = compare(got, limits)
    notes = worst_leaves(prog, refs)
    return harness.Outcome(attempted=n_steps, failed=failed, e2e=e2e,
                           record=record, checks=checks, device=device,
                           trace=trace, notes=notes)


def free(dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def opt_cfg_of(traffic: Dict):
    from dalle_tpu_torch.config import OptimizerConfig
    return OptimizerConfig(**traffic.get("optimizer", {}))


def lamb_config(opt_cfg) -> rlamb.LambConfig:
    fields = rlamb.LambConfig.__dataclass_fields__
    return rlamb.LambConfig(**{k: getattr(opt_cfg, k) for k in fields})


def follow(m: Dict, seed: int, batches, accum: int, n: int, rows: int,
           opt_cfg, device, prec: str = "f32", half: bool = False) -> Dict:
    """The reference's readings over the first ``n`` steps: each step's
    loss and gradient norm, the first gradient by leaf (from the state
    after one step) and each leaf's change after ``n`` steps. ``half``
    plants the fault of a step that leaves out half of each micro-batch
    and takes the mean over the rest."""
    ref.no_tf32()
    params = ref.make_weights(m, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    opt = rlamb.Lamb8bit(lamb_config(opt_cfg))
    opt.init(params)
    out = {"loss": [], "grad_norm": []}
    for k in range(n):
        batch = batches[k]
        if half:
            mb = batch["text"].shape[0] // accum
            batch = {key: torch.cat([v[i * mb:i * mb + mb // 2]
                                     for i in range(accum)])
                     for key, v in batch.items()}
        loss, grads = ref.loss_and_grads(params, m, batch, accum, rows,
                                         prec)
        out["loss"].append(loss)
        out["grad_norm"].append(float(torch.sqrt(
            sum(torch.sum(g * g) for g in grads.values()))))
        opt.step(params, grads)
        del grads
        if k == 0:
            out["grad_leaf"] = {
                name: float(rlamb.dense(mu).norm()) / (1 - opt_cfg.beta1)
                for name, mu in opt.mu.items()}
    out["update_leaf"] = {name: float((params[name] - start[name]).norm())
                          for name in params}
    return out


def worst_leaves(prog: Dict, refs: Dict, n: int = 3) -> List[str]:
    """The leaves that set ``grad_leaf`` and ``update_leaf``, with both
    sides' norms."""
    out = []
    for key in ("grad_leaf", "update_leaf"):
        g = refs[key]
        med = harness.median(list(g.values()))
        rows = sorted(g, key=lambda k: -abs(prog[key][k] - g[k])
                      / max(g[k], med, 1e-30))[:n]
        out += [f"{key} {k} program {prog[key][k]!r} reference {g[k]!r}"
                for k in rows]
    out.append(f"loss program {prog['loss']!r} reference {refs['loss']!r}")
    out.append(f"grad_norm program {prog['grad_norm']!r} "
               f"reference {refs['grad_norm']!r}")
    return out


def readings(prog: Dict, refs: Dict, n: int) -> Dict[str, float]:
    """The numbers the comparison takes. ``grad_leaf`` is the worst leaf's
    first-gradient gap; ``update_leaf`` leaves out the leaves that move by
    round-off alone."""
    g = refs["grad_leaf"]
    med = harness.median(list(g.values()))
    moving = {name for name, v in g.items() if v >= ZERO_GRAD * med}
    first = leaf_gaps(prog["grad_leaf"], g)
    return {
        "loss": max(harness.gap(a, b) for a, b in
                    zip(prog["loss"][:n], refs["loss"])),
        "grad_norm": max(harness.gap(a, b) for a, b in
                         zip(prog["grad_norm"][:n], refs["grad_norm"])),
        "grad_leaf": max(first.values()),
        "update_leaf": max(leaf_gaps(prog["update_leaf"],
                                     refs["update_leaf"],
                                     keep=moving.__contains__).values()),
    }


def compare(got: Dict[str, float], limits: Dict) -> Dict:
    """Each reading with the limit the cell's file gives it."""
    return {k: (v, limits[k]) for k, v in got.items()}
