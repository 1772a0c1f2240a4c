"""Weights carried between the JAX package's flax tree and the PyTorch port
(dalle_tpu_torch/params.py), and the port's isolation from JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dalle_tpu.config import tiny_model_config as jax_tiny
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu_torch.config import tiny_model_config
from dalle_tpu_torch.params import (jax_layout_scanned, params_from_jax,
                                    params_to_jax)

torch.set_num_threads(2)

ZOO = dict(attn_types=("axial_row", "axial_col", "axial_row", "axial_row"),
           shared_block_cycle=4, final_conv_block=True, conv_kernel=3)

LAYOUTS = {
    "scan_unroll1": dict(ZOO, depth=10, scan_unroll=1),
    "scan_unroll2": dict(ZOO, depth=10, scan_unroll=2),
    "unrolled_wconv": dict(ZOO, depth=5),
    "dense": dict(attn_types=("axial_row", "axial_col"), depth=4),
}


def _jax_tree(overrides, param_dtype="float32"):
    cfg = jax_tiny(param_dtype=param_dtype, **overrides)
    params = jax_init(JaxDALLE(cfg), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(b))
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key], f"{path}/{key}")
        else:
            assert a[key].dtype == b[key].dtype, f"{path}/{key}"
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]),
                                          err_msg=f"{path}/{key}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_convert_and_round_trip(layout):
    overrides = LAYOUTS[layout]
    tree = _jax_tree(overrides)
    cfg = tiny_model_config(**overrides)
    transformer = tree["params"]["transformer"]
    assert ("cycle" in transformer) == jax_layout_scanned(cfg)
    assert ("block_wconv" in transformer) == cfg.final_conv_block
    model = params_from_jax(tree, cfg)
    # every layer application reads the flax leaves of its block
    for uid, _ in cfg.layer_schedule():
        name = "block_wconv" if uid == -1 else f"block_{uid}"
        src = transformer.get("cycle", transformer)
        src = transformer[name] if name == "block_wconv" else src[name]
        np.testing.assert_array_equal(
            model.transformer.blocks[name].ff.wi.kernel.detach().numpy(),
            src["ff"]["wi"]["kernel"])
    np.testing.assert_array_equal(model.token_emb.detach().numpy(),
                                  tree["params"]["token_emb"])
    assert model.token_emb.shape[0] % 128 == 0
    assert model.token_emb.shape[0] >= cfg.vocab_total + 1
    _assert_trees_equal(params_to_jax(model), tree)


def test_bf16_params_round_trip():
    tree = _jax_tree(LAYOUTS["scan_unroll2"], param_dtype="bfloat16")
    cfg = tiny_model_config(param_dtype="bfloat16", **LAYOUTS["scan_unroll2"])
    model = params_from_jax(tree, cfg)
    assert model.token_emb.dtype == torch.bfloat16
    _assert_trees_equal(params_to_jax(model), tree)


def test_mismatched_tree_and_dense_scan_raise():
    """A tree of another layout raises. The ``dense_scan`` layout was
    refused until the port took the stacked leaves: its stacked tree now
    converts both ways, and the unrolled tree of the same blocks is a
    mismatch for it."""
    tree = _jax_tree(LAYOUTS["dense"])
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, tiny_model_config(**LAYOUTS["scan_unroll1"]))
    stacked = dict(LAYOUTS["dense"], dense_scan=True)
    cfg = tiny_model_config(**stacked)
    assert cfg.dense_scan_reps() == 2 and jax_layout_scanned(cfg)
    stacked_tree = _jax_tree(stacked)
    _assert_trees_equal(params_to_jax(params_from_jax(stacked_tree, cfg)),
                        stacked_tree)
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, cfg)


def test_port_imports_neither_jax_nor_the_jax_package():
    root = Path(__file__).resolve().parents[1]
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "dalle_tpu_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"dalle_tpu_torch.swarm.chaos", "dalle_tpu_torch.swarm.assist",
            "dalle_tpu_torch.training.remote_sink",
            "dalle_tpu_torch.cli.run_aux_peer",
            "dalle_tpu_torch.utils.torch_io"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax',"
        " 'msgpack', 'pydantic', 'tokenizers')"
        " or m.startswith(('jax.', 'flax.', 'optax.', 'msgpack.',"
        " 'pydantic.', 'tokenizers.'))"
        " or m == 'dalle_tpu' or m.startswith('dalle_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for mod in ("dalle_tpu_torch.models.decode", "dalle_tpu_torch.entry",
                "dalle_tpu_torch.optim", "dalle_tpu_torch.optim.lamb",
                "dalle_tpu_torch.optim.lamb8bit", "dalle_tpu_torch.ops.quant",
                "dalle_tpu_torch.swarm", "dalle_tpu_torch.swarm.compression",
                "dalle_tpu_torch.swarm.device_codec",
                "dalle_tpu_torch.swarm.error_feedback",
                "dalle_tpu_torch.training.steps",
                "dalle_tpu_torch.data.synthetic",
                "dalle_tpu_torch.time_layer_norm",
                "dalle_tpu_torch.time_quant",
                "dalle_tpu_torch.serving", "dalle_tpu_torch.serving.engine",
                "dalle_tpu_torch.serving.scheduler",
                "dalle_tpu_torch.serving.metrics",
                "dalle_tpu_torch.serving.chaos",
                "dalle_tpu_torch.serving.prefix_cache",
                "dalle_tpu_torch.serving.pixels",
                "dalle_tpu_torch.serving.server",
                "dalle_tpu_torch.obs", "dalle_tpu_torch.obs.trace",
                "dalle_tpu_torch.obs.exposition",
                "dalle_tpu_torch.models.vqgan", "dalle_tpu_torch.models.clip",
                "dalle_tpu_torch.cli", "dalle_tpu_torch.cli._args",
                "dalle_tpu_torch.cli.run_server",
                "dalle_tpu_torch.cli.run_inference",
                "dalle_tpu_torch.cli.run_trainer",
                "dalle_tpu_torch.utils.msgpack", "dalle_tpu_torch.task",
                "dalle_tpu_torch.parallel.multihost",
                "dalle_tpu_torch.training.checkpoint",
                "dalle_tpu_torch.training.loop",
                "dalle_tpu_torch.swarm._fallback_crypto",
                "dalle_tpu_torch.swarm.crypto",
                "dalle_tpu_torch.swarm.identity",
                "dalle_tpu_torch.swarm._native", "dalle_tpu_torch.swarm.dht",
                "dalle_tpu_torch.swarm.metrics",
                "dalle_tpu_torch.swarm.rendezvous",
                "dalle_tpu_torch.swarm.health",
                "dalle_tpu_torch.swarm.screening",
                "dalle_tpu_torch.swarm.progress",
                "dalle_tpu_torch.swarm.matchmaking",
                "dalle_tpu_torch.swarm.allreduce",
                "dalle_tpu_torch.swarm.state_transfer",
                "dalle_tpu_torch.swarm.optimizer",
                "dalle_tpu_torch.swarm.audit",
                "dalle_tpu_torch.swarm.repair",
                "dalle_tpu_torch.swarm.powersgd",
                "dalle_tpu_torch.swarm.auth",
                "dalle_tpu_torch.serving.router",
                "dalle_tpu_torch.data.tokenizer",
                "dalle_tpu_torch.data.dataset",
                "dalle_tpu_torch.data.remote",
                "dalle_tpu_torch.cli.prepare_data",
                "dalle_tpu_torch.cli.run_router",
                "dalle_tpu_torch.cli.issue_token"):
        assert mod in mods, mod
    # chip_smoke.py imports inside main(): read every import it names
    tree = ast.parse((root / "chip_smoke.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "flax", "optax", "dalle_tpu",
                                        "msgpack", "pydantic", "tokenizers"))
    assert not bad, bad
    assert {"dalle_tpu_torch.training.steps",
            "dalle_tpu_torch.serving.engine",
            "dalle_tpu_torch.training.loop"} <= names
    assert "dalle_tpu_torch.swarm.error_feedback" in names
