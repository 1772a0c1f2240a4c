"""The look for modules of JAX and the JAX package, and the refusal to
run without a card."""

import subprocess
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("dalle_tpu", True), ("dalle_tpu.models.dalle",
                                                True),
    ("dalle_tpu_torch", False), ("dalle_tpu_torch.models.dalle", False),
    ("jaxtyping", False), ("torch", False)])
def test_top_level_names_whole(name, bad):
    modules = {"torch": types.ModuleType("torch"),
               name: types.ModuleType(name)}
    assert bool(harness.forbidden_modules(modules)) is bad


def test_a_fake_jax_in_this_process_is_seen(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, work\n"
            "from benchmark.reference import dalle, lamb8bit\n"
            "from benchmark.traffic import train, serve\n"
            "import dalle_tpu_torch.serving.engine\n"
            "import dalle_tpu_torch.training.steps\n"
            "print(harness.forbidden_modules())\n" % str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(tiny.REPO / "benchmark" / "run.py"),
         "--workload", "longctx-train", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tiny.REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_only_the_benchmark_files_are_not_enough(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the command fails and prints no result."""
    import shutil
    shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "longctx-train",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
