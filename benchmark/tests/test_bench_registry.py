"""BENCHMARK.json against the contract it is held to, every name it uses
found as a file, and a cell, a traffic mix, a configuration and a
per-layer metric added as files and entries alone."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert one_line(entry[key]), (entry["name"], key)
    assert len(names) == len(set(names))


def test_configs_are_files_with_their_sizes():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = REPO / c["file"]
        assert c["file"].startswith("benchmark/") and path.is_file()
        data = json.loads(path.read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert set(data["model"]) >= {"dim", "depth", "heads", "head_dim"}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_cells_report_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        cell = harness.load_cell(w["name"], REPO)
        ends = {m["name"] for m in cell.metrics("end_to_end")}
        layers = cell.metrics("per_layer")
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for m in layers:
            assert m["moves"] in ends, (w["name"], m["name"])


def test_every_name_is_found():
    base = REPO / "benchmark"
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], REPO)
        assert harness.driver(cell).run
        limits = cell.limits["limits"]
        assert limits and all(v >= 0 for v in limits.values())
    for m in BENCH["per_layer"]:
        assert (base / "metrics" / f"{m['name']}.py").is_file()
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_a_missing_file_is_refused(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "benchmark" / "workloads" / "tiny-train.json").unlink()
    with pytest.raises(harness.BenchError, match="missing"):
        harness.load_cell("tiny-train", root)
    with pytest.raises(harness.BenchError, match="no cell"):
        harness.load_cell("no-such-cell", root)


def test_cell_config_mix_and_metric_added_as_files(tmp_path):
    """A checkout with cells, configurations and a traffic mix of its own
    (tiny.make_root), plus one more per-layer metric as a reader file and
    an entry: the loader finds them and a traced run reports the metric."""
    root = tiny.make_root(tmp_path)
    (root / "benchmark" / "metrics" / "train_steps_n.py").write_text(
        "def read(record):\n    return float(record['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "train_steps_n", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "training step and optimizer",
        "moves": "train_img_s", "workloads": ["tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = tiny.run_cell(root, "tiny-train", traced=True)
    assert line["correct"]
    assert line["metrics"]["train_steps_n"]["value"] >= 1
    assert "train_update_ms" in line["metrics"]
    assert list(line)[-1] == "checks"
    plain = tiny.run_cell(root, "tiny-train")
    assert set(plain["metrics"]) == {"train_img_s", "setup_s"}
