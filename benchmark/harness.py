"""What every cell's run shares: finding a cell's files by name, building
the program's model from a configuration file, the weights, the reduction
of a profiler trace, the check for modules of the JAX package, and the
result line.

A cell names a configuration (``configs/<config>.json``), a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``traffic/<driver>.py``)
and its own limits (``workloads/<cell>.json``); each per-layer metric is
``metrics/<metric>.py``. Nothing here knows a cell, a mix or a metric by
name, so a later change adds them as files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dalle_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a
    forbidden module): the command exits non-zero and prints none."""


# ---------------------------------------------------------------------------
# files by name
# ---------------------------------------------------------------------------

def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` and the files it names."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    bench: Dict
    root: Path

    @property
    def model(self) -> Dict:
        return self.config["model"]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    def metrics(self, section: str) -> List[Dict]:
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``)
        that this cell reports."""
        return [mt for mt in self.bench[section]
                if "workloads" not in mt or self.name in mt["workloads"]]


def load_cell(name: str, root: Path = HERE.parent) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json "
                         f"(cells: {sorted(entries)})")
    entry = entries[name]
    base = root / "benchmark"
    files = {"config": base / "configs" / f"{entry['config']}.json",
             "traffic": base / "traffic" / f"{entry['traffic']}.json",
             "limits": base / "workloads" / f"{name}.json"}
    missing = [str(p) for p in files.values() if not p.is_file()]
    if missing:
        raise BenchError(f"cell {name!r}: missing {missing}")
    cell = Cell(name, entry, read_json(files["config"]),
                read_json(files["traffic"]), read_json(files["limits"]),
                bench, root)
    if not (base / "traffic" / f"{cell.driver}.py").is_file():
        raise BenchError(f"cell {name!r}: no driver {cell.driver}.py")
    for mt in cell.metrics("per_layer"):
        if not (base / "metrics" / f"{mt['name']}.py").is_file():
            raise BenchError(f"no reader metrics/{mt['name']}.py")
    return cell


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(cell.root / "benchmark" / "traffic"
                       / f"{cell.driver}.py", f"bench_traffic_{cell.driver}")


def reader(cell: Cell, metric: str) -> Callable:
    mod = load_module(cell.root / "benchmark" / "metrics" / f"{metric}.py",
                      "bench_metric_" + metric.replace(".", "_"))
    return mod.read


# ---------------------------------------------------------------------------
# the program's model
# ---------------------------------------------------------------------------

def model_config(cell: Cell, use: str):
    """The program's ``ModelConfig``: the configuration file's builder with
    the dtypes of ``use`` (``train`` or ``serve``), checked against the
    file's sizes, so the file states what runs."""
    from dalle_tpu_torch import config as pconfig
    build = getattr(pconfig, cell.config["builder"])
    kwargs = dict(cell.config.get("overrides", {}), **cell.config["dtypes"][use])
    cfg = build(**{k: tuple(v) if isinstance(v, list) else v
                   for k, v in kwargs.items()})
    for key, want in cell.model.items():
        got = getattr(cfg, key)
        got = list(got) if isinstance(got, tuple) else got
        if got != want:
            raise BenchError(f"{cell.config['builder']} gives {key}={got!r}; "
                             f"the configuration file states {want!r}")
    return cfg


def build_model(cfg, weights: Dict[str, Any], device):
    """The program's DALLE on ``device`` holding ``weights`` (the
    benchmark's, by the names both give every parameter)."""
    import torch
    from dalle_tpu_torch.models.dalle import DALLE
    with torch.device(device):
        model = DALLE(cfg)
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise BenchError(
            "parameters differ: program only "
            f"{sorted(set(names) - set(weights))[:4]}, benchmark only "
            f"{sorted(set(weights) - set(names))[:4]}")
    with torch.no_grad():
        for n, p in names.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise BenchError(f"{n}: program {tuple(p.shape)}, "
                                 f"benchmark {tuple(weights[n].shape)}")
            p.copy_(weights[n])
    return model


def caption_batch(gen, rows: int, text_len: int, lo: int, hi: int,
                  vocab_text: int, device):
    """Captions as the collator makes them: ``L`` ids (``lo <= L <= hi``,
    eos included) drawn uniformly from the text vocabulary above the pad
    (0) and eos (1) ids, eos (1), then pad (0); and the loss mask over
    the real tokens."""
    import torch
    lengths = torch.randint(lo, hi + 1, (rows, 1), generator=gen,
                            device=device)
    ids = torch.randint(2, vocab_text, (rows, text_len), generator=gen,
                        device=device)
    pos = torch.arange(text_len, device=device)[None]
    text = torch.where(pos < lengths - 1, ids,
                       torch.where(pos == lengths - 1, 1, 0))
    return text, (pos < lengths).float()


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(ln.split()[1]) for ln in f
                        if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
MARKER = "bench.traced"


def merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Trace:
    """A profiled stretch: its wall (``window_s``), the seconds with a
    device operation running (``busy_s``), device seconds by operation
    name, the idle gaps by what the host was doing, and how much work
    it spans (``units``: steps or decode positions)."""

    window_s: float
    busy_s: float
    device_ops: Dict[str, float]
    idle_gaps: Dict[str, float]
    units: float = 1.0

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def reduce_events(events: List[Dict], label_gaps: int = 2000) -> Trace:
    """The Trace of a Chrome-trace event list: the window is the
    ``MARKER`` annotation's span; device operations are clipped to it;
    each of the ``label_gaps`` longest idle gaps is put under the
    innermost host operation open at its middle."""
    mark = [e for e in events if e.get("name") == MARKER
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise BenchError(f"the trace has no {MARKER} span")
    w0 = min(e["ts"] for e in mark)
    w1 = max(e["ts"] + e["dur"] for e in mark)
    ops: Dict[str, float] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            spans.append((a, b))
            ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) / 1e6
    busy = merge(spans)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != MARKER)
    labels: Dict[str, float] = {}
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:label_gaps]
    rest = sum(b - a for a, b in gaps) - sum(b - a for a, b in longest)
    if host and longest:
        import numpy as np
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
        for a, b in longest:
            mid = 0.5 * (a + b)
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = host[open_[-1]][2] if open_.size else "no host op"
            labels[name] = labels.get(name, 0.0) + (b - a) / 1e6
    else:
        for a, b in longest:
            labels["no host op"] = labels.get("no host op", 0.0) + (b - a) / 1e6
    if rest > 0:
        labels["shorter gaps"] = rest / 1e6
    return Trace(window_s=(w1 - w0) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 device_ops=ops, idle_gaps=labels)


class Profiler:
    """``torch.profiler`` over a stretch of the run (host and device),
    reduced to a :class:`Trace` from its Chrome trace, which is written
    under ``scratch`` and deleted once read. A first, discarded session
    warms the tracer. :meth:`start` and :meth:`stop` may run on another
    thread than :meth:`result` (the serving engine's, between chunks)."""

    def __init__(self, scratch: Path, cuda: bool = True):
        from torch.profiler import ProfilerActivity
        self.scratch, self.cuda = scratch, cuda
        self.activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        self._prof = self._mark = None

    def warm(self, fn: Callable[[], None]) -> None:
        from torch.profiler import profile
        with profile(activities=self.activities):
            fn()

    def start(self) -> None:
        from torch.profiler import profile, record_function
        self._prof = profile(activities=self.activities)
        self._prof.__enter__()
        self._mark = record_function(MARKER)
        self._mark.__enter__()

    def stop(self, sync: bool = True) -> None:
        import torch
        if sync and self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def result(self) -> Trace:
        self.scratch.mkdir(parents=True, exist_ok=True)
        path = self.scratch / f"trace-{os.getpid()}.json"
        try:
            self._prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)
        finally:
            path.unlink(missing_ok=True)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events)

    def trace(self, fn: Callable[[], Any]) -> Tuple[Trace, Any]:
        self.start()
        out = fn()
        self.stop()
        return self.result(), out


# ---------------------------------------------------------------------------
# statistics, modules and the result
# ---------------------------------------------------------------------------

def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default); None for no values."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, as a whole word) is the JAX package's, JAX's or flax's."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """One run of one cell: what the command line gave, the device, the
    clock's zero (the process's start) and a directory for the trace."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: str = "cuda"
    t_start: float = field(default_factory=process_start)
    scratch: Path = field(default_factory=lambda: Path(
        os.environ.get("TMPDIR", "/tmp")))

    def device_info(self, peak_bytes: int) -> Dict[str, Any]:
        import torch
        if self.device == "cpu":
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": peak_bytes}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": self.cell.entry["chips"],
                "memory_peak_bytes": peak_bytes}


@dataclass
class Outcome:
    """What a driver hands back."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    record: Dict[str, Any]
    checks: Dict[str, Tuple[float, float]]
    device: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Trace] = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def result_line(cell: Cell, out: Outcome, traced: bool) -> Dict:
    """The last line's object; ``checks``, the numbers compared and their
    limits, comes last."""
    metrics = {}
    if not traced:
        for mt in cell.metrics("end_to_end"):
            if mt["name"] not in out.e2e:
                raise BenchError(f"traffic/{cell.driver}.py gave no "
                                 f"{mt['name']}")
            metrics[mt["name"]] = {"value": out.e2e[mt["name"]],
                                   "unit": mt["unit"]}
    else:
        for mt in cell.metrics("per_layer"):
            value = reader(cell, mt["name"])(out.record)
            if value is not None:
                metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if traced and out.trace is not None:
        line["device"] = dict(out.device, busy_s=out.trace.busy_s,
                              window_s=out.trace.window_s)
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def gap(a: float, b: float) -> float:
    """``|a - b| / |b|``."""
    return abs(a - b) / max(abs(b), 1e-30)


def median(xs):
    return statistics.median(xs)
