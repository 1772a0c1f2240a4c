"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference in float8 put in the program's
place); a sound run comes out correct. Tiny cells on the CPU: the harness
skips only its look for a card."""

import numpy as np
import pytest
import torch

from benchmark.reference import dalle as ref
from benchmark.tests import tiny
from benchmark.traffic import serve, train

import dalle_tpu_torch.serving.engine as engine
import dalle_tpu_torch.training.steps as steps


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-full", "tiny-serve"])
def test_sound_runs_are_correct(root, cell):
    line = tiny.run_cell(root, cell, seconds=2.0 if "serve" in cell else 0.3)
    assert line["correct"], line["checks"]


def test_serve_rate_counts_the_decoded_positions(root):
    """``serve_img_s`` is the slot-positions decoded at the window's chunks
    over one request's positions, over the window's seconds; the checked
    requests are greedy ones that finished, handed back in the record."""
    from benchmark import harness
    torch.manual_seed(0)
    cell = harness.load_cell("tiny-serve", root)
    out = serve.run(harness.Run(cell, 5, 2.0, False, device="cpu",
                                scratch=root / "scratch"))
    rec, m = out.record, cell.model
    per_request = m["text_seq_len"] + m["image_grid"] ** 2
    want = sum(live for _, live in rec["chunks"]) * rec["steps_per_call"] \
        / per_request / rec["window_s"]
    assert want > 0
    assert out.e2e["serve_img_s"] == pytest.approx(want)
    assert rec["checked"] and all(row["greedy"] for row in rec["checked"])
    assert len(rec["checked"]) <= cell.limits["check_requests"]


def test_unchanged_state(root, monkeypatch):
    real = steps.train_step

    def frozen(state, batch, optimizer, accum_steps=1):
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        state, metrics = real(state, batch, optimizer, accum_steps)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(before[n])
        return state, metrics

    monkeypatch.setattr(steps, "train_step", frozen)
    line = tiny.run_cell(root, "tiny-train", seconds=0.3)
    assert not line["correct"]
    assert line["checks"]["update_leaf"]["value"] == pytest.approx(1.0)


def test_half_the_batch(root, monkeypatch):
    real = steps.grad_step

    def half(model, batch, accum_steps=1):
        mb = next(iter(batch.values())).shape[0] // accum_steps
        kept = {k: torch.cat([v[i * mb:i * mb + mb // 2]
                              for i in range(accum_steps)])
                for k, v in batch.items()}
        return real(model, kept, accum_steps)

    monkeypatch.setattr(steps, "grad_step", half)
    line = tiny.run_cell(root, "tiny-train", seconds=0.3)
    assert not line["correct"]


def test_altered_token(root, monkeypatch):
    real = engine.sample_logits

    def altered(logits, sampling, noise):
        out = real(logits, sampling, noise)
        vt = 64
        return torch.where(out >= vt, vt + (out - vt + 1) % 32, out)

    monkeypatch.setattr(engine, "sample_logits", altered)
    line = tiny.run_cell(root, "tiny-serve", seconds=2.0)
    assert not line["correct"]


def test_training_control_fails(root):
    """The reference in float8 e4m3 as the program: its readings against
    the float32 reference's fail the cell's limits."""
    from benchmark import harness
    cell = harness.load_cell("tiny-train", root)
    m, tr = cell.model, cell.traffic
    from dalle_tpu_torch.config import OptimizerConfig
    opt_cfg = OptimizerConfig(**tr["optimizer"])
    rows = tr["micro"] * tr["accum"]
    feed = train.Feed(m, tr, 7, "cpu", rows)
    batches = [feed.next() for _ in range(3)]
    args = (m, 7, batches, tr["accum"], 3, 4, opt_cfg, "cpu")
    want = train.follow(*args)
    low = train.follow(*args, prec="fp8")
    checks = train.compare(train.readings(low, want, 3),
                           cell.limits["limits"])
    assert any(v > lim for v, lim in checks.values()), checks


def test_serving_control_fails(root):
    """At the positions of served sequences, the codes the float8
    reference puts first lie below the float32 reference's best by more
    than the cell's limit."""
    from benchmark import harness
    cell = harness.load_cell("tiny-serve", root)
    m = cell.model
    rng = np.random.default_rng(3)
    rows = [{"text": serve.caption(rng, m, 2, 6),
             "codes": rng.integers(0, m["vocab_image"], 16)}
            for _ in range(2)]
    gap = serve.served_gap(m, 9, rows, "cpu", torch.float32, prec="fp8")
    assert gap > cell.limits["limits"]["logit_gap"]


def test_fp8_rounding_is_coarse():
    x = torch.linspace(-3, 3, 101)
    err = (ref._fp8(x) - x).abs().max() / x.abs().max()
    assert 1e-3 < float(err) < 0.1


def test_a_cell_compares_the_numbers_its_file_limits():
    """Each reading is compared with the limit the cell's file gives it,
    and a file that leaves a reading without a limit is refused."""
    prog = {"loss": [1.0, 1.0], "grad_norm": [2.0, 2.0],
            "grad_leaf": {"a": 1.0, "b": 2.2, "c": 3.0},
            "update_leaf": {"a": 1.0, "b": 1.0, "c": 1.0}}
    refs = {"loss": [1.0, 1.1], "grad_norm": [2.0, 2.0],
            "grad_leaf": {"a": 1.0, "b": 2.0, "c": 4.0},
            "update_leaf": {"a": 1.0, "b": 1.0, "c": 1.0}}
    got = train.readings(prog, refs, 2)
    assert set(got) == {"loss", "grad_norm", "grad_leaf", "update_leaf"}
    assert got["grad_leaf"] == pytest.approx(0.25)
    assert got["loss"] == pytest.approx(0.1 / 1.1)
    limits = {"loss": 0.5, "grad_norm": 0.1, "grad_leaf": 0.2,
              "update_leaf": 0.1}
    checks = train.compare(got, limits)
    assert checks["grad_leaf"] == (got["grad_leaf"], 0.2)
    assert set(checks) == set(got)
    with pytest.raises(KeyError):
        train.compare(got, {"loss": 0.5})
