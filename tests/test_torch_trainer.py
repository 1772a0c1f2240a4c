"""The port's trainer peer end to end on the CPU: ``TrainingTask`` +
``train_loop`` against the JAX package's, checkpoints (the port's own and
the JAX trainer's), the ``run_trainer`` entry point, the serving CLIs on a
checkpoint the JAX trainer wrote, and the settings the port refuses.

The solo parity run: the same identity file (so the same data seed), the
same initial weights (the JAX task's, carried over with
``params_from_jax``), the synchronous round (``delay_optimizer_step=False``)
and a tracker that refreshes on every step, so both loops see the same
batches and close an epoch after the same steps. The JAX task shards its
batch over the 8 virtual CPU devices of tests/conftest.py, so its
``per_device_batch`` is the port's divided by 8.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                    PeerConfig, TrainerConfig,
                                    tiny_model_config)
from dalle_tpu_torch.params import (jax_leaf_names, opt_state_from_jax,
                                    params_from_jax, state_leaf_tensors)
from dalle_tpu_torch.task import TrainingTask
from dalle_tpu_torch.training.checkpoint import (CheckpointManager,
                                                 params_are_finite)
from dalle_tpu_torch.training.loop import train_loop

torch.set_num_threads(2)

MODEL = dict(dim=256, heads=4, head_dim=64, depth=2)
OPT = dict(warmup_steps=2, total_steps=100)
COLLAB = dict(target_batch_size=16, matchmaking_time=0.3,
              allreduce_timeout=5.0, averaging_timeout=10.0,
              average_state_every=0, delay_optimizer_step=False,
              audit_gather=False, gossip_strikes=False)
#: the loss tolerance of tests/test_torch_train.py, and the 8-bit training
#: path's parameter rule of tests/test_torch_quant.py: each parameter
#: within UPDATE_TOL of its leaf's largest update, except on at most
#: MOMENT_FLIPS of the leaf's elements (those whose moment code flipped by
#: one), which stay within FLIPPED_STEP of it
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
UPDATE_TOL, MOMENT_FLIPS, FLIPPED_STEP = 1e-3, 1e-3, 0.5


def _fixed_identity(path, seed: int = 7):
    """An identity file from a fixed Ed25519 seed: the data seed derives
    from the identity, so a fixed file gives a fixed data order."""
    from dalle_tpu_torch.swarm import _fallback_crypto as fb
    key = fb.Ed25519PrivateKey.from_private_bytes(bytes([seed]) * 32)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(key.private_bytes(fb.serialization.Encoding.PEM,
                                       fb.serialization.PrivateFormat.PKCS8,
                                       fb.serialization.NoEncryption()))


def _port_task(tmp_path, run_id="solo", collab=None, state_bits=8,
               **trainer):
    cfgs = (tiny_model_config(**MODEL),
            OptimizerConfig(state_bits=state_bits, **OPT),
            TrainerConfig(**{"per_device_batch": 8, **trainer}),
            CollabConfig(run_id=run_id, **{**COLLAB, **(collab or {})}),
            PeerConfig(identity_path=str(tmp_path / "id.pem"),
                       experiment_prefix=run_id))
    return TrainingTask(*cfgs, device="cpu")


def _jax_task(tmp_path, run_id="solo", state_bits=8):
    from dalle_tpu.config import CollabConfig as JCC
    from dalle_tpu.config import OptimizerConfig as JOC
    from dalle_tpu.config import PeerConfig as JPC
    from dalle_tpu.config import TrainerConfig as JTC
    from dalle_tpu.config import tiny_model_config as jtiny
    from dalle_tpu.task import TrainingTask as JTask
    return JTask(jtiny(**MODEL), JOC(state_bits=state_bits, **OPT),
                 JTC(per_device_batch=1),
                 JCC(run_id=run_id, **COLLAB),
                 JPC(identity_path=str(tmp_path / "id.pem"),
                     experiment_prefix=run_id))


def _load_jax_params(task, params):
    import jax
    src = params_from_jax(jax.tree.map(np.asarray, params),
                          task.model_cfg)
    with torch.no_grad():
        for (name, p), (_, q) in zip(task.model.named_parameters(),
                                     src.named_parameters()):
            p.copy_(q)


@pytest.mark.parametrize("state_bits, epochs", [(8, 2), (32, 3)])
def test_solo_train_loop_matches_jax(tmp_path, state_bits, epochs):
    """Per-epoch losses within LOSS_TOL; the final params by the 8-bit
    rule. The 8-bit run stops after the first nonzero update (the
    schedule's first step has learning rate 0), where that rule was
    measured; the fp32 run goes one update further."""
    import jax

    _fixed_identity(tmp_path / "id.pem")
    jtask = _jax_task(tmp_path, state_bits=state_bits)
    ptask = _port_task(tmp_path, state_bits=state_bits)
    try:
        assert ptask.data_seed == jtask.data_seed
        assert ptask.local_batch_size == jtask.local_batch_size
        _load_jax_params(ptask, jtask.collab_optimizer.state.params)
        init_leaves = [np.array(x) for x in jax.tree_util.tree_leaves(
            jtask.collab_optimizer.state.params)]
        for task in (jtask, ptask):
            task.collab_optimizer.tracker.min_refresh_period = 0.0
        from dalle_tpu.training.loop import train_loop as jloop
        jrep = jloop(jtask, max_epochs=epochs, warmup_steps=1,
                     publish_metrics_records=False)
        prep = train_loop(ptask, max_epochs=epochs, warmup_steps=1)
        assert [r.epoch for r in prep] == [r.epoch for r in jrep] == \
            list(range(1, epochs + 1))
        assert [r.mini_steps for r in prep] == [r.mini_steps for r in jrep]
        np.testing.assert_allclose([r.loss for r in prep],
                                   [r.loss for r in jrep], **LOSS_TOL)
        names = jax_leaf_names(ptask.model_cfg)
        params = dict(ptask.model.named_parameters())
        for name, leaf, init in zip(names, jax.tree_util.tree_leaves(
                jtask.collab_optimizer.state.params), init_leaves):
            want = np.asarray(leaf)
            step = max(float(np.abs(want - init).max()), 1e-12)
            gap = np.abs(params[name].detach().numpy() - want) / step
            assert (gap > UPDATE_TOL).mean() <= MOMENT_FLIPS, name
            assert gap.max() <= FLIPPED_STEP, name
    finally:
        ptask.shutdown()
        jtask.shutdown()


def _state_tensors(state):
    return [t.clone() for t in state_leaf_tensors(state.model,
                                                  state.opt_state)]


def test_checkpoint_save_restore_keep_and_backup(tmp_path):
    task = _port_task(tmp_path)
    try:
        state = task.train_state
        ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
        saved = {}
        for epoch in range(1, 5):
            g = {n: torch.full_like(p, 0.01 * epoch)
                 for n, p in state.model.named_parameters()}
            state = task.apply_step(state, g)
            saved[epoch] = _state_tensors(state)
            ckpt.save(state, epoch, backup=(epoch == 2))
        ckpt.flush()
        assert [e for e, _ in ckpt.checkpoints()] == [3, 4]
        fresh = _port_task(tmp_path / "other").train_state
        restored, epoch = ckpt.restore_latest(fresh)
        assert epoch == 4 and restored.step == 4
        assert all(torch.equal(a, b) for a, b in
                   zip(_state_tensors(restored), saved[4]))
        restored, epoch = ckpt.restore_backup(fresh)
        assert epoch == 2
        assert all(torch.equal(a, b) for a, b in
                   zip(_state_tensors(restored), saved[2]))
        ckpt.close()
    finally:
        task.shutdown()


def test_nan_rolls_back_to_the_backup(tmp_path):
    task = _port_task(tmp_path)
    applied = []
    real = task.apply_step

    def poisoned(state, grads):
        state = real(state, grads)
        applied.append(state.opt_state.count)
        if len(applied) == 3:          # the third apply corrupts the params
            with torch.no_grad():
                next(state.model.parameters())[0, 0] = float("nan")
        return state

    task.__dict__["apply_step"] = poisoned
    epochs = []
    try:
        task.collab_optimizer.tracker.min_refresh_period = 0.0
        reports = train_loop(task, max_epochs=4, warmup_steps=0,
                             checkpoint_dir=str(tmp_path / "ck"),
                             on_epoch=lambda r: epochs.append(r.epoch))
        assert reports
        assert len(applied) == 5       # one apply undone and done again
        assert epochs == [1, 2, 3, 4]
        assert params_are_finite(task.collab_optimizer.state.model)
        assert task.collab_optimizer.local_epoch == 4
    finally:
        task.shutdown()


def test_resume_from_a_checkpoint_the_jax_trainer_wrote(tmp_path):
    import jax

    from dalle_tpu.training.checkpoint import CheckpointManager as JCM

    jtask = _jax_task(tmp_path, run_id="jx")
    try:
        jstate = jtask.collab_optimizer.state
        g = jax.tree.map(lambda x: x * 0.01 + 0.001, jstate.params)
        for _ in range(3):
            jstate = jtask.apply_step(jstate, g)
        JCM(str(tmp_path / "ck"), async_writes=False).save(jstate, 3,
                                                           backup=True)
        want_params = jax.tree.map(np.asarray, jstate.params)
        want_opt = opt_state_from_jax(jstate.opt_state,
                                      tiny_model_config(**MODEL))
    finally:
        jtask.shutdown()
    task = _port_task(tmp_path / "p", run_id="pt")
    try:
        reports = train_loop(task, max_epochs=3, warmup_steps=0,
                             checkpoint_dir=str(tmp_path / "ck"))
        assert reports == []
        collab = task.collab_optimizer
        assert collab.local_epoch == 3 and collab.state.step == 3
        want = state_leaf_tensors(params_from_jax(
            want_params, task.model_cfg), want_opt)
        got = state_leaf_tensors(collab.state.model, collab.state.opt_state)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # and it trains on from there
        reports = train_loop(task, max_epochs=4, warmup_steps=0,
                             checkpoint_dir=str(tmp_path / "ck"))
        assert collab.local_epoch == 4 and reports[-1].epoch == 4
    finally:
        task.shutdown()


def test_run_trainer_cli_trains_and_writes_metrics(tmp_path):
    from dalle_tpu_torch.cli import run_trainer
    metrics = tmp_path / "m.jsonl"
    rc = run_trainer.main([
        "--preset", "tiny", "--device", "cpu", "--max-epochs", "2",
        "--per-device-batch", "4", "--target-batch-size", "8",
        "--matchmaking-time", "0.3", "--no-audit-gather",
        "--no-delay-optimizer-step", "--warmup-batches", "1",
        "--identity-path", str(tmp_path / "id.pem"),
        "--checkpoint-dir", str(tmp_path / "ck"),
        "--metrics-file", str(metrics), "--log-level", "WARNING"])
    assert rc == 0
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert "apply_s" in rows[0]["timings"]
    assert os.path.exists(tmp_path / "ck" / "backup.msgpack")


@pytest.mark.parametrize("argv, match", [
    (["--dense-scan"], "dense_scan"),
    (["--dense-scan", "--depth", "8"], "dense_scan"),
    (["--chaos-plan", "{}"], "chaos"),
    (["--remat", "--remat-policy", "save_ctx"], "save_ctx"),
    (["--offload"], "offload"),
    (["--stacked-reps", "2"], "stacked_reps"),
    (["--fsdp", "2"], "one GPU"),
    (["--dp", "2"], "one GPU"),
    (["--sequence-parallel", "ring"], "sequence_parallel"),
])
def test_unported_flags_raise(tmp_path, argv, match):
    """A flag whose module the port lacks raises, naming it. The
    ``dense_scan`` layout, ``--stacked-reps`` and ``--chaos-plan`` raised
    until the port took them: with them the CLI now trains one epoch."""
    from dalle_tpu_torch.cli import run_trainer
    base = ["--preset", "tiny", "--device", "cpu", "--max-epochs", "1",
            "--identity-path", str(tmp_path / "id.pem")]
    if match in ("dense_scan", "chaos", "stacked_reps"):
        metrics = tmp_path / "m.jsonl"
        assert run_trainer.main(base + argv + [
            "--per-device-batch", "4", "--target-batch-size", "4",
            "--matchmaking-time", "0.3", "--no-audit-gather",
            "--no-delay-optimizer-step", "--warmup-batches", "1",
            "--metrics-file", str(metrics),
            "--log-level", "WARNING"]) == 0
        rows = [json.loads(line) for line in metrics.read_text().splitlines()]
        assert [r["epoch"] for r in rows] == [1]
        assert np.isfinite(rows[0]["loss"])
        return
    with pytest.raises(NotImplementedError, match=match):
        run_trainer.main(base + argv)


def test_run_trainer_cli_runs_under_an_active_chaos_plan(tmp_path):
    """``--chaos-plan`` with faults that fire (delays and duplicates on
    every send, dropped DHT gets) still trains: the wrapper sits under
    the whole peer."""
    from dalle_tpu_torch.cli import run_trainer
    metrics = tmp_path / "m.jsonl"
    plan = ('{"seed": 3, "rules": [{"ops": ["send"], "duplicate": 1.0, '
            '"delay_s": [0.0, 0.01]}, {"ops": ["get"], "drop": 0.2}]}')
    assert run_trainer.main([
        "--preset", "tiny", "--device", "cpu", "--max-epochs", "2",
        "--identity-path", str(tmp_path / "id.pem"),
        "--chaos-plan", plan, "--per-device-batch", "4",
        "--target-batch-size", "4", "--matchmaking-time", "0.3",
        "--no-audit-gather", "--no-delay-optimizer-step",
        "--warmup-batches", "1", "--metrics-file", str(metrics),
        "--log-level", "WARNING"]) == 0
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]


@pytest.mark.parametrize("argv, plane", [
    ([], "_auditor"),
    (["--grad-compression", "power_sgd", "--powersgd-rank", "2",
      "--no-powersgd-host-orthogonalize"], "_powersgd"),
])
def test_trust_plane_and_powersgd_flags_build_the_optimizer(tmp_path, argv,
                                                            plane):
    """The JAX defaults (audit, repair, proofs) and PowerSGD build a
    peer from the CLI's flags; they raised until this slice."""
    from dalle_tpu_torch.cli import run_trainer
    from dalle_tpu_torch.task import TrainingTask
    args = run_trainer.build_parser().parse_args(
        ["--preset", "tiny", "--identity-path", str(tmp_path / "id.pem")]
        + argv)
    model, opt, trainer, collab, peer = run_trainer.configs_from_args(args)
    assert collab.audit_gather and collab.repair_convicted
    with TrainingTask(model, opt, trainer, collab, peer,
                      device="cpu") as task:
        collab_opt = task.collab_optimizer
        assert getattr(collab_opt, plane) is not None
        assert collab_opt._repair is not None
        if plane == "_powersgd":
            assert collab_opt._powersgd.rank == 2
            assert not collab_opt._powersgd.host_orthogonalize


def test_multi_process_peers_raise(monkeypatch):
    import torch.distributed as dist

    from dalle_tpu_torch.parallel import multihost
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="multi-process"):
        multihost.SliceRole()


def test_xl_preset_equals_jax():
    from dalle_tpu.config import xl_model_config as jxl
    from dalle_tpu_torch.config import xl_model_config
    assert dataclasses.asdict(xl_model_config()) == \
        dataclasses.asdict(jxl())
    assert dataclasses.asdict(xl_model_config(depth=4)) == \
        dataclasses.asdict(jxl(depth=4))


def test_trainer_configs_equal_jax_field_for_field():
    from dalle_tpu import config as jcfg
    from dalle_tpu_torch import config as tcfg
    for name in ("TrainerConfig", "CollabConfig", "PeerConfig",
                 "OptimizerConfig"):
        jf = {f.name: f.default for f in
              dataclasses.fields(getattr(jcfg, name))}
        tf = {f.name: f.default for f in
              dataclasses.fields(getattr(tcfg, name))}
        assert tf == jf, name


def _jax_checkpoint(tmp_path):
    import jax

    from dalle_tpu.config import OptimizerConfig as JOC
    from dalle_tpu.config import tiny_model_config as jtiny
    from dalle_tpu.models.dalle import DALLE as JDALLE
    from dalle_tpu.models.dalle import init_params as jinit
    from dalle_tpu.optim import make_optimizer as jmake
    from dalle_tpu.training.checkpoint import CheckpointManager as JCM
    from dalle_tpu.training.steps import TrainState as JTS

    params = jinit(JDALLE(jtiny()), jax.random.PRNGKey(11))
    JCM(str(tmp_path), async_writes=False).save(
        JTS.create(params, jmake(JOC())), 5, backup=True)
    return params_from_jax(jax.tree.map(np.asarray, params),
                           tiny_model_config())


def test_run_server_serves_a_jax_checkpoint(tmp_path, monkeypatch):
    from dalle_tpu_torch.cli import run_server
    from dalle_tpu_torch.serving import engine as engine_mod
    from dalle_tpu_torch.serving import server as server_mod

    want = _jax_checkpoint(tmp_path / "ck")
    served = {}

    class Recording(engine_mod.DecodeEngine):
        def __init__(self, model, *a, **k):
            served["model"] = model
            super().__init__(model, *a, **k)

    def stop(self):
        raise KeyboardInterrupt

    monkeypatch.setattr(engine_mod, "DecodeEngine", Recording)
    monkeypatch.setattr(server_mod.ServingHTTPServer, "serve_forever", stop)
    rc = run_server.main(["--preset", "tiny", "--device", "cpu",
                          "--checkpoint-dir", str(tmp_path / "ck"),
                          "--http-port", "0", "--metrics-interval-s", "0",
                          "--log-level", "WARNING"])
    assert rc == 0
    got = dict(served["model"].named_parameters())
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p), name
    assert run_server.main(["--preset", "tiny", "--device", "cpu",
                            "--checkpoint-dir", str(tmp_path / "none"),
                            "--log-level", "WARNING"]) == 1


def test_run_inference_generates_from_a_jax_checkpoint(tmp_path):
    from dalle_tpu_torch.cli import run_inference
    from dalle_tpu_torch.models.decode import SamplingConfig, generate_images

    model = _jax_checkpoint(tmp_path / "ck").eval()
    out = tmp_path / "gen.npz"
    rc = run_inference.main(["--preset", "tiny", "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path / "ck"),
                             "--tokens", "5,9,12", "--images-per-query",
                             "2", "--seed", "3", "--out", str(out),
                             "--log-level", "WARNING"])
    assert rc == 0
    ids = run_inference.prompt_ids("5,9,12", model.cfg.text_seq_len)
    text = torch.from_numpy(np.tile(ids[None], (2, 1)))
    want = generate_images(model, text, [3, 4], SamplingConfig())
    got = np.load(out)["query_0_codes"]
    np.testing.assert_array_equal(
        got, want.numpy().reshape(-1, model.cfg.image_grid,
                                  model.cfg.image_grid))
