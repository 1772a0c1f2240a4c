"""The averaging assistant and the aux peer of the port
(``dalle_tpu_torch/swarm/assist.py``, ``training/remote_sink.py``,
``cli/run_aux_peer.py``) against the JAX package's, mirroring
``tests/test_assist.py``:

- the weight-0 protocol on port peers: the assistant owns a part and the
  trainers' result excludes it; a 0-sample trainer is not waited on; an
  assistant that receives nothing withholds its part; a dead assistant
  degrades like a dead owner; an assistant never leads;
- ``grad_flat_elements`` equals the JAX count (a stacked ``dense_scan``
  tree's overhang slices included), counted on the meta device;
- the ``AveragingAssistant`` thread in a real round of port trainers;
- a JAX assistant in a round of port trainers, and a port assistant in a
  round of JAX trainers: the trainers end byte-identical to each other and
  to the same round with an assistant of their own package (u8 codec, so
  the assistant's gather encode is on the wire);
- ``run_aux_peer``: ``aggregate`` and ``fleet_stats`` equal the JAX
  CLI's; with ``--assist-in-averaging`` beside a port trainer it assists
  rounds, archives the swarm state in a checkpoint that the JAX package
  restores bit for bit, and uploads it through the directory sink.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                    PeerConfig, TrainerConfig,
                                    tiny_model_config)
from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm.allreduce import flatten_tensors, run_allreduce
from dalle_tpu_torch.swarm.assist import (AveragingAssistant,
                                          assist_one_round,
                                          grad_flat_elements)
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm import identity as tid
from dalle_tpu_torch.swarm.identity import Identity
from dalle_tpu_torch.swarm.matchmaking import make_group

torch.set_num_threads(2)

SHAPES = [(33,), (8, 9), (5,)]
N_ELEMS = 33 + 72 + 5


def _make_swarm(n):
    nodes = []
    for _ in range(n):
        peers = [nodes[0].visible_address] if nodes else []
        nodes.append(DHT(initial_peers=peers, identity=Identity.generate(),
                         rpc_timeout=2.0))
    return nodes


@pytest.fixture
def swarm3():
    nodes = _make_swarm(3)
    yield nodes
    for n in nodes:
        n.shutdown()


def _run_threads(fns, timeout=60):
    results, errors = [None] * len(fns), []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors:
        raise errors[0]
    return results


def _tensors(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _cfg(**over):
    return CollabConfig(run_id="as", encrypt_data_plane=False, **over)


# -- the weight-0 protocol ---------------------------------------------------

def test_the_assistant_owns_a_part_and_the_result_excludes_it(swarm3):
    tensors, weights = [_tensors(0), _tensors(1)], [1.0, 3.0]

    def trainer(i):
        g = make_group(swarm3[i], "as_grads", epoch=0, weight=weights[i],
                       matchmaking_time=3.0, min_group_size=2)
        assert g is not None and g.size == 3
        assert sum(1 for m in g.members if m.addr) == 3
        return run_allreduce(swarm3[i], g, "as_grads", 0, tensors[i],
                             weight=weights[i], allreduce_timeout=10.0,
                             codec=compression.NONE)

    def assistant():
        outcome = assist_one_round(
            swarm3[2], _cfg(matchmaking_time=3.0, allreduce_timeout=10.0),
            0, np.zeros(N_ELEMS, np.float32), codec=compression.NONE)
        assert outcome == "assisted", outcome

    results = _run_threads([lambda: trainer(0), lambda: trainer(1),
                            assistant])
    want = (flatten_tensors(tensors[0]) * weights[0]
            + flatten_tensors(tensors[1]) * weights[1]) / sum(weights)
    for res in results[:2]:
        np.testing.assert_allclose(flatten_tensors(res), want, rtol=1e-5,
                                   atol=1e-6)


def test_a_zero_sample_trainer_is_not_waited_on(swarm3):
    tensors = [_tensors(0), _tensors(1), _tensors(2)]
    weights = [2.0, 1.0, 0.0]

    def peer(i):
        g = make_group(swarm3[i], "zs", epoch=1, weight=weights[i],
                       matchmaking_time=3.0, min_group_size=2)
        assert g is not None and g.size == 3
        t0 = time.monotonic()
        res = run_allreduce(swarm3[i], g, "zs", 1, tensors[i],
                            weight=weights[i], allreduce_timeout=30.0,
                            codec=compression.NONE)
        return res, time.monotonic() - t0

    out = _run_threads([lambda i=i: peer(i) for i in range(3)])
    want = sum(flatten_tensors(t) * w for t, w in
               zip(tensors[:2], weights[:2])) / sum(weights[:2])
    for res, dt in out[:2]:
        np.testing.assert_allclose(flatten_tensors(res), want, rtol=1e-5,
                                   atol=1e-6)
        assert dt < 6.0, dt


def test_an_assistant_without_contributions_withholds_its_part(swarm3):
    def dead_trainer():
        assert make_group(swarm3[0], "wh", epoch=3, weight=1.0,
                          matchmaking_time=3.0, min_group_size=2)

    def assistant():
        g = make_group(swarm3[1], "wh", epoch=3, weight=0.0,
                       matchmaking_time=3.0, min_group_size=2)
        assert g is not None and g.size == 2
        report = {}
        run_allreduce(swarm3[1], g, "wh", 3, [np.zeros(N_ELEMS, np.float32)],
                      weight=0.0, allreduce_timeout=5.0,
                      codec=compression.NONE, report=report)
        assert report["reduced_senders"] == 0
        assert report["complete"] is False

    _run_threads([dead_trainer, assistant])


def test_a_dead_assistant_degrades_like_a_dead_owner(swarm3):
    tensors = [_tensors(0), _tensors(1)]

    def trainer(i):
        g = make_group(swarm3[i], "ad", epoch=2, weight=1.0,
                       matchmaking_time=3.0, min_group_size=2)
        assert g is not None and g.size == 3
        report = {}
        res = run_allreduce(swarm3[i], g, "ad", 2, tensors[i], weight=1.0,
                            allreduce_timeout=6.0, codec=compression.NONE,
                            report=report)
        return res, report

    def dead_assistant():
        assert make_group(swarm3[2], "ad", epoch=2, weight=0.0,
                          matchmaking_time=3.0, min_group_size=2)

    out = _run_threads([lambda: trainer(0), lambda: trainer(1),
                        dead_assistant])
    want = (flatten_tensors(tensors[0]) + flatten_tensors(tensors[1])) / 2
    for res, report in out[:2]:
        flat = flatten_tensors(res)
        assert report["complete"] is False
        matches = np.isclose(flat, want, rtol=1e-5, atol=1e-6)
        assert 0 < matches.sum() < flat.size


def test_an_assistant_never_leads_a_mixed_group():
    from dalle_tpu_torch.swarm.matchmaking import GroupMember, choose_leader

    def m(pid, w):
        return GroupMember(pid, f"127.0.0.1:{ord(pid[0])}", w, b"", b"")

    trainers = [m("bbb", 2.0), m("ccc", 1.0)]
    assistant = m("aaa", 0.0)
    assert choose_leader(sorted([assistant] + trainers,
                                key=lambda x: x.peer_id)).peer_id == "bbb"
    assert choose_leader(trainers).peer_id == "bbb"
    assert choose_leader([assistant]).peer_id == "aaa"


def test_power_sgd_is_refused():
    with pytest.raises(ValueError, match="power_sgd"):
        AveragingAssistant(None, _cfg(grad_compression="power_sgd"),
                           tiny_model_config())


# -- the flat size --------------------------------------------------------

@pytest.mark.parametrize("model", [
    dict(),
    dict(depth=7, attn_types=("full", "axial_row"), dense_scan=True,
         shared_block_cycle=0, final_conv_block=False),
    "flagship_dense",
])
def test_grad_flat_elements_equals_the_jax_count(model):
    from dalle_tpu import config as jconfig
    from dalle_tpu.swarm.assist import grad_flat_elements as jax_count
    from dalle_tpu_torch import config as tconfig
    if model == "flagship_dense":
        kw = dict(shared_block_cycle=0, remat_skip_blocks=0, scan_unroll=1,
                  dense_scan=True)
        jcfg, tcfg = (jconfig.flagship_model_config(**kw),
                      tconfig.flagship_model_config(**kw))
        assert tcfg.dense_scan_reps() == 16
    else:
        jcfg, tcfg = (jconfig.tiny_model_config(**model),
                      tconfig.tiny_model_config(**model))
    assert grad_flat_elements(tcfg) == jax_count(jcfg)
    if model == "flagship_dense":
        assert grad_flat_elements(tcfg) == 1_133_068_288


# -- the assistant thread ---------------------------------------------------

def test_the_thread_assists_a_real_round(swarm3):
    from dalle_tpu_torch.swarm.progress import ProgressTracker

    model_cfg = tiny_model_config()
    n = grad_flat_elements(model_cfg)
    cfg = _cfg(matchmaking_time=3.0, allreduce_timeout=10.0,
               target_batch_size=8)
    assistant = AveragingAssistant(swarm3[2], cfg, model_cfg)
    sizes = []

    def trainer(i):
        tensors = [np.random.RandomState(i).randn(n).astype(np.float32)]
        tracker = ProgressTracker(swarm3[i], cfg.run_id,
                                  cfg.target_batch_size)
        tracker.report_local_progress(0, 8, force=True)
        time.sleep(1.0)
        g = make_group(swarm3[i], f"{cfg.run_id}_grads", 0, weight=8.0,
                       matchmaking_time=cfg.matchmaking_time,
                       min_group_size=2)
        assert g is not None
        sizes.append(g.size)
        return run_allreduce(swarm3[i], g, f"{cfg.run_id}_grads", 0,
                             tensors, weight=8.0,
                             allreduce_timeout=cfg.allreduce_timeout,
                             codec=compression.NONE)

    assistant.start()
    try:
        results = _run_threads([lambda: trainer(0), lambda: trainer(1)])
        assert sizes == [3, 3]
        np.testing.assert_allclose(flatten_tensors(results[0]),
                                   flatten_tensors(results[1]),
                                   rtol=1e-6, atol=1e-7)
        deadline = time.monotonic() + 20.0
        while assistant.rounds_assisted < 1:
            assert time.monotonic() < deadline, "assistant never assisted"
            time.sleep(0.1)
    finally:
        assistant.stop()
        assistant.join(timeout=30.0)
    assert not assistant.is_alive()


# -- across packages ------------------------------------------------------

def _mixed_round(trainer_kind, assistant_kind, epoch):
    """Two trainers of ``trainer_kind`` and an assistant of
    ``assistant_kind`` on one loopback swarm with fixed identities (so
    the part layout is fixed); one u8 round. The trainers' results."""
    from dalle_tpu.swarm import allreduce as jar
    from dalle_tpu.swarm import assist as jassist
    from dalle_tpu.swarm import dht as jdht
    from dalle_tpu.swarm import identity as jid
    from dalle_tpu.swarm import matchmaking as jmm
    from dalle_tpu.config import CollabConfig as JCollab
    from dalle_tpu_torch.swarm import assist as tassist

    mods = {"jax": (jdht.DHT, jid, jmm.make_group, jar.run_allreduce,
                    jassist.assist_one_round, JCollab),
            "torch": (DHT, tid, make_group, run_allreduce,
                      tassist.assist_one_round, CollabConfig)}
    kinds = [trainer_kind, trainer_kind, assistant_kind]
    nodes = []
    for i, kind in enumerate(kinds):
        dht_cls, idm = mods[kind][0], mods[kind][1]
        ident = idm.Identity(idm.Ed25519PrivateKey.from_private_bytes(
            bytes([61 + i]) * 32))
        peers = [nodes[0].visible_address] if nodes else []
        nodes.append(dht_cls(initial_peers=peers, identity=ident,
                             rpc_timeout=2.0))
    rng = np.random.default_rng(epoch)
    tensors = [[(rng.standard_normal(s) * 3).astype(np.float32)
                for s in ((300, 41), (7000,), (9,))] for _ in range(2)]
    n = sum(t.size for t in tensors[0])

    def trainer(i):
        _, _, group, allreduce, _, _ = mods[trainer_kind]
        g = group(nodes[i], "mx_grads", epoch=epoch, weight=2.0 + i,
                  matchmaking_time=3.0, min_group_size=2)
        assert g is not None and g.size == 3
        return allreduce(nodes[i], g, "mx_grads", epoch, tensors[i],
                         weight=2.0 + i, allreduce_timeout=15.0,
                         codec=compression.UNIFORM8BIT)

    def assistant():
        assist, collab = mods[assistant_kind][4], mods[assistant_kind][5]
        cfg = collab(run_id="mx", encrypt_data_plane=False,
                     matchmaking_time=3.0, allreduce_timeout=15.0,
                     wire_codec_backend="host")
        return assist(nodes[2], cfg, epoch, np.zeros(n, np.float32),
                      codec=compression.UNIFORM8BIT)

    try:
        out = _run_threads([lambda: trainer(0), lambda: trainer(1),
                            assistant], timeout=90)
    finally:
        for node in reversed(nodes):
            node.shutdown()
    assert out[2] == "assisted", out[2]
    return [flatten_tensors(r) for r in out[:2]]


@pytest.mark.parametrize("trainers, assistant", [("torch", "jax"),
                                                 ("jax", "torch")])
def test_an_assistant_of_the_other_package_serves_a_part(trainers,
                                                         assistant):
    mixed = _mixed_round(trainers, assistant, epoch=4)
    same = _mixed_round(trainers, trainers, epoch=4)
    assert mixed[0].tobytes() == mixed[1].tobytes()
    assert mixed[0].tobytes() == same[0].tobytes()


# -- the aux peer CLI ---------------------------------------------------------

def test_aggregate_and_fleet_stats_equal_the_jax_cli():
    from dalle_tpu.cli import run_aux_peer as jaux
    from dalle_tpu.swarm.metrics import LocalMetrics as JMetrics
    from dalle_tpu_torch.cli import run_aux_peer as taux
    from dalle_tpu_torch.swarm.metrics import LocalMetrics

    rows = [dict(peer_id="a", epoch=3, samples_per_second=1.5,
                 samples_accumulated=16, loss=2.25, mini_steps=4,
                 parts_audited=2, proofs_rejected=1),
            dict(peer_id="b", epoch=4, samples_per_second=2.0,
                 samples_accumulated=8, loss=2.0, mini_steps=2,
                 audit_convictions=1),
            dict(peer_id="c", epoch=4, samples_per_second=0.25,
                 samples_accumulated=8, loss=1.5, mini_steps=3)]
    for subset in (rows, rows[:1], []):
        assert taux.aggregate([LocalMetrics(**r) for r in subset]) == \
            jaux.aggregate([JMetrics(**r) for r in subset])
    fleet = {"e1": {"goodput_img_per_s": 1.25, "queue_depth": 3,
                    "live_slots": 2, "prefix_hits": 5},
             "e2": {"goodput_img_per_s": "0.5", "shed": 1,
                    "prefix_misses": None}}
    for records in (fleet, {}):
        assert taux.fleet_stats(records) == jaux.fleet_stats(records)


def test_the_directory_sink_uploads(tmp_path):
    from dalle_tpu_torch.training.remote_sink import (RemoteSink,
                                                      UploadWorker,
                                                      _CommandSink,
                                                      _DirSink)
    src = tmp_path / "ckpt_00000001.msgpack"
    src.write_bytes(b"state" * 100)
    for dest in (str(tmp_path / "remote"),
                 "file://" + str(tmp_path / "remote2")):
        sink = RemoteSink.create(dest)
        assert isinstance(sink, _DirSink)
        worker = UploadWorker(sink, dest)
        worker.submit(str(src))
        worker.close(timeout=30)
        target = dest.replace("file://", "")
        assert (open(os.path.join(target, src.name), "rb").read()
                == src.read_bytes())
        assert not [f for f in os.listdir(target) if f.endswith(".tmp")]
    assert RemoteSink.create(None) is None
    gs = RemoteSink.create("gs://bucket/prefix")
    assert isinstance(gs, _CommandSink) and gs.argv_prefix[0] == "gsutil"
    rs = RemoteSink.create("user@host:/archive")
    assert isinstance(rs, _CommandSink) and rs.argv_prefix[0] == "rsync"
    assert not _DirSink(str(src)).upload(str(src))   # a file, not a dir


def test_run_aux_peer_assists_and_archives_a_state_jax_restores(tmp_path):
    """A port trainer and ``run_aux_peer --assist-in-averaging`` on one
    loopback swarm: the assistant joins the trainer's rounds, the aux
    peer archives the swarm state (and uploads it), and the JAX package's
    ``CheckpointManager`` restores that file to the trainer's state bit
    for bit."""
    import jax

    from dalle_tpu import config as jconfig
    from dalle_tpu.models.dalle import DALLE as JaxDALLE
    from dalle_tpu.models.dalle import init_params as jax_init
    from dalle_tpu.optim import make_optimizer as jax_make_optimizer
    from dalle_tpu.training import steps as jsteps
    from dalle_tpu.training.checkpoint import CheckpointManager as JCM
    from dalle_tpu_torch.cli import run_aux_peer
    from dalle_tpu_torch.params import (opt_state_from_jax, params_from_jax,
                                        state_leaf_tensors)
    from dalle_tpu_torch.task import TrainingTask
    from dalle_tpu_torch.training.loop import train_loop

    model = dict(depth=3, attn_types=("full", "axial_row"), dense_scan=True,
                 shared_block_cycle=0, final_conv_block=False)
    assert tiny_model_config(**model).dense_scan_reps() == 2
    opt = dict(warmup_steps=1, total_steps=100, min_8bit_size=256)
    # state_compression "none": the default size-adaptive state transfer
    # is lossy (f16/u8 leaves), and the archive is compared exactly
    collab = dict(run_id="aux", target_batch_size=8, matchmaking_time=1.5,
                  state_compression="none",
                  allreduce_timeout=10.0, averaging_timeout=20.0,
                  average_state_every=0, delay_optimizer_step=False,
                  audit_gather=False, gossip_strikes=False)
    anchor = DHT(identity=Identity.generate(), rpc_timeout=2.0)
    trainer = TrainingTask(
        tiny_model_config(**model), OptimizerConfig(**opt),
        TrainerConfig(per_device_batch=8),
        CollabConfig(**collab),
        PeerConfig(identity_path=str(tmp_path / "t.pem"),
                   experiment_prefix="aux",
                   initial_peers=(anchor.visible_address,)),
        device="cpu")
    flags = [f"--{k.replace('_', '-')}" if v is True else
             f"--no-{k.replace('_', '-')}" if v is False else
             f"--{k.replace('_', '-')}={v}" for k, v in
             {**model, **opt, **collab}.items()
             if k not in ("attn_types",)]
    argv = ["--preset", "tiny", "--device", "cpu", "--max-rounds", "8",
            "--refresh-period", "1.0", "--save-every-epochs", "1",
            "--attn-types", "full", "axial_row",
            "--checkpoint-dir", str(tmp_path / "archive"),
            "--archive-remote", str(tmp_path / "remote"),
            "--metrics-file", str(tmp_path / "aux.jsonl"),
            "--assist-in-averaging", "--experiment-prefix", "aux",
            "--identity-path", str(tmp_path / "aux.pem"),
            "--initial-peers", anchor.visible_address,
            "--log-level", "WARNING"] + flags
    done = threading.Event()
    errors = []

    def train():
        try:
            train_loop(trainer, max_epochs=3, warmup_steps=0)
            # keep serving the state until the aux peer has archived it
            done.wait(timeout=60)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=train)
    thread.start()
    try:
        assert run_aux_peer.main(argv) == 0
        done.set()
        thread.join(timeout=60)
        assert not errors, errors
        collab_opt = trainer.collab_optimizer
        assert collab_opt.local_epoch == 3
        # the assistant owned a part of the trainer's rounds
        reports = collab_opt.last_wire_report or {}
        assert reports, "no round report"
        archive = sorted(os.listdir(tmp_path / "archive"))
        assert "backup.msgpack" in archive, archive
        assert os.path.exists(tmp_path / "remote" / "backup.msgpack") or \
            any(f.startswith("ckpt_") for f in os.listdir(
                tmp_path / "remote"))
        jcfg = jconfig.tiny_model_config(**model)
        jtx = jax_make_optimizer(jconfig.OptimizerConfig(
            **opt, stacked_reps=jcfg.dense_scan_reps()))
        template = jsteps.TrainState.create(
            jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)), jtx)
        restored, epoch = JCM(str(tmp_path / "archive"),
                              async_writes=False).restore_latest(template)
        assert epoch == 3
        tcfg = tiny_model_config(**model)
        got = state_leaf_tensors(
            params_from_jax(jax.tree.map(np.asarray, restored.params),
                            tcfg),
            opt_state_from_jax(jax.tree.map(np.asarray,
                                            restored.opt_state), tcfg))
        state = collab_opt.state
        want = state_leaf_tensors(state.model, state.opt_state)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        done.set()
        thread.join(timeout=60)
        trainer.shutdown()
        anchor.shutdown()


def test_the_aux_metrics_endpoint_serves_the_aggregate():
    """``--metrics-port``: the aggregate as Prometheus gauges (numbers
    only; booleans, None and strings left out), ``/healthz``, and 404
    elsewhere, as the JAX package's exposition server does."""
    import json as _json
    import urllib.error
    import urllib.request

    from dalle_tpu.obs import exposition as jexp
    from dalle_tpu_torch.obs import exposition as texp

    stats = {"alive_peers": 2, "epoch": 7, "sum_sps": 3.5,
             "mean_loss": None, "flag": True, "note": "x"}
    reg, jreg = texp.MetricsRegistry(), jexp.MetricsRegistry()
    reg.register("aux", texp.aggregate_source(lambda: stats))
    jreg.register("aux", jexp.aggregate_source(lambda: stats))
    assert reg.render() == jreg.render()
    server, thread = texp.start_metrics_server(reg, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            parsed = texp.parse_text(r.read().decode())
        assert parsed["dalle_swarm_agg_alive_peers"][""] == 2
        assert parsed["dalle_swarm_agg_sum_sps"][""] == 3.5
        assert not any(k.endswith(("mean_loss", "flag", "note"))
                       for k in parsed)
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert _json.loads(r.read()) == {"ok": True}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
