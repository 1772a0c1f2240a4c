"""A checkout of the benchmark in a temporary directory whose cells run on
the CPU at a tiny size: the real drivers, readers and yardstick, tiny
configuration files, and a ``BENCHMARK.json`` naming them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]

SIZES = dict(vocab_text=64, vocab_image=32, text_seq_len=8, image_grid=4,
             dim=32, depth=5, heads=2, head_dim=16, ff_mult=4,
             shared_block_cycle=4, conv_kernel=3, rotary=True,
             tied_embeddings=True, loss_img_weight=7.0)
ZOO = dict(SIZES, attn_types=["axial_row", "axial_col", "axial_row",
                              "axial_row"], final_conv_block=True)
FULL = dict(SIZES, attn_types=["full"], final_conv_block=False)
# the flagship's training knobs at this size
KNOBS = dict(remat=True, remat_policy="save_attn", remat_skip_blocks=1,
             head_chunk=16, ln_fusion=True, param_cast_hoist=True)
F32 = {"param_dtype": "float32", "dtype": "float32"}

TRAIN = {"driver": "train", "micro": 4, "accum": 2, "caption_len": [2, 6],
         "optimizer": {"state_bits": 8, "min_8bit_size": 512,
                       "block_size": 64, "warmup_steps": 2},
         "profile_steps": 1}
SERVE = {"driver": "serve", "clients": 3, "n_slots": 2, "steps_per_call": 4,
         "caption_len": [2, 6], "stagger_chunks": 2, "temperature": 1.0,
         "top_k": 0, "top_p": 1.0, "profile_chunks": 2, "timeout_s": 120.0}
TRAIN_LIMITS = {"loss": 1e-4, "grad_norm": 1e-4, "grad_leaf": 1e-3,
                "update_leaf": 1e-3}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """The tiny checkout: cells ``tiny-train`` (the flagship's zoo),
    ``tiny-full`` (full attention, blanket remat) and ``tiny-serve``."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = root / "benchmark"
    write(base / "configs" / "tiny_zoo.json", {
        "builder": "tiny_model_config", "overrides": dict(ZOO, **KNOBS),
        "dtypes": {"train": F32, "serve": F32}, "model": ZOO})
    write(base / "configs" / "tiny_full.json", {
        "builder": "tiny_model_config",
        "overrides": dict(FULL, remat=True, sequence_parallel="ring"),
        "dtypes": {"train": F32}, "model": FULL})
    write(base / "traffic" / "tiny_train.json", TRAIN)
    write(base / "traffic" / "tiny_serve.json", SERVE)
    write(base / "workloads" / "tiny-train.json",
          {"ref_steps": 3, "ref_rows": 3, "limits": TRAIN_LIMITS})
    write(base / "workloads" / "tiny-full.json",
          {"ref_steps": 2, "ref_rows": 8, "limits": TRAIN_LIMITS})
    write(base / "workloads" / "tiny-serve.json",
          {"check_requests": 2, "limits": {"logit_gap": 1e-3}})
    cells = [("tiny-train", "tiny_zoo", "tiny_train"),
             ("tiny-full", "tiny_full", "tiny_train"),
             ("tiny-serve", "tiny_zoo", "tiny_serve")]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "a CPU test"} for n, c, t in cells]
    for section in ("end_to_end", "per_layer"):
        for mt in bench[section]:
            if "workloads" in mt:
                train = any("train" in w for w in mt["workloads"])
                mt["workloads"] = (["tiny-train", "tiny-full"] if train
                                   else ["tiny-serve"])
    write(root / "BENCHMARK.json", bench)
    return root


def run_cell(root: Path, name: str, seed: int = 5, seconds: float = 0.5,
             traced: bool = False) -> dict:
    """One run of a tiny cell on the CPU, its result line; ``traced``
    runs the per-layer readers on a CPU trace."""
    torch.manual_seed(0)
    cell = harness.load_cell(name, root)
    run = harness.Run(cell, seed, seconds, traced, device="cpu",
                      scratch=root / "scratch")
    out = harness.driver(cell).run(run)
    return harness.result_line(cell, out, traced)
