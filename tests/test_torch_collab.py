"""The port's CollaborativeOptimizer (dalle_tpu_torch/swarm/optimizer.py):
port peers co-training to bitwise-equal state, straggler resync, state
averaging, a snapshot taken during an apply, a mixed JAX + port pair
training a tiny DALLE, and a port joiner loading a JAX peer's state.

All peers here are tiny DALLEs on the CPU with the 8-bit LAMB (dim 256, so
the block-quantized moments are in play), on loopback DHTs. Most cases pass
``audit_gather=False`` to keep their rounds lean; the cases at the JAX
defaults run the trust plane (audit, repair, proofs) and PowerSGD.
"""

import threading
import time

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                    tiny_model_config)
from dalle_tpu_torch.data.synthetic import SyntheticCodes
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.params import (jax_leaf_names, opt_state_from_jax,
                                    params_from_jax, state_leaf_tensors)
from dalle_tpu_torch.swarm import DHT, Identity
from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
from dalle_tpu_torch.training.steps import TrainState, apply_step, grad_step

torch.set_num_threads(2)

MODEL = dict(dim=256, heads=4, head_dim=64, depth=2)
OPT = OptimizerConfig(warmup_steps=2, total_steps=100)
#: the tolerance of tests/test_torch_train.py on gradients and params
TOL = 2e-4


def _collab(run_id, **kw):
    base = dict(run_id=run_id, target_batch_size=16, matchmaking_time=2.0,
                allreduce_timeout=15.0, averaging_timeout=30.0,
                average_state_every=0, audit_gather=False,
                max_peer_weight=0)
    base.update(kw)
    return CollabConfig(**base)


def _port_peer(dht, cfg, seed=0, model=None, serve_state=True):
    tx = make_optimizer(OPT)
    if model is None:
        model = init_params(tiny_model_config(**MODEL),
                            torch.Generator().manual_seed(seed))
    model.train()
    opt = CollaborativeOptimizer(dht, cfg, TrainState.create(model, tx),
                                 lambda s, g: apply_step(s, g, tx),
                                 serve_state=serve_state)
    opt.tracker.min_refresh_period = 0.05
    return opt


def _nodes(n, module=None):
    dht_cls = DHT if module is None else module.DHT
    ident = Identity if module is None else module.Identity
    nodes = []
    for _ in range(n):
        peers = [nodes[0].visible_address] if nodes else []
        nodes.append(dht_cls(initial_peers=peers,
                             identity=ident.generate(), rpc_timeout=2.0))
    return nodes


def _batches(seed, n=8):
    data = SyntheticCodes(tiny_model_config(**MODEL), 64, seed=0)
    for b in data.batches(n, seed=seed):
        yield {k: torch.from_numpy(v).long() for k, v in b.items()}


def _run(fns):
    results, errors = [None] * len(fns), []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i, f))
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return results


def _train(opt, seed, epochs):
    it = _batches(seed)
    deadline = time.monotonic() + 60
    while opt.local_epoch < epochs and time.monotonic() < deadline:
        _, _, g = grad_step(opt.state.model, next(it))
        opt.step(g, batch_size=8)
    opt.finalize()
    return opt.local_epoch


def _state(opt):
    return state_leaf_tensors(opt.state.model, opt.state.opt_state)


@pytest.mark.parametrize("delay", [False, True])
def test_two_port_peers_end_bitwise_equal(delay):
    nodes = _nodes(2)
    cfg = _collab(f"co_{delay}", delay_optimizer_step=delay,
                  grad_compression="uniform8bit",
                  wire_codec_backend="device")
    opts = [_port_peer(n, cfg) for n in nodes]
    try:
        epochs = _run([lambda i=i: _train(opts[i], i, 2) for i in range(2)])
        assert min(epochs) >= 2
        a, b = _state(opts[0]), _state(opts[1])
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert opts[0].last_timings["group_size"] == 2
        # the params moved away from the shared init
        init = init_params(tiny_model_config(**MODEL),
                           torch.Generator().manual_seed(0))
        assert not torch.equal(init.token_emb, opts[0].state.model.token_emb)
    finally:
        for o in opts:
            o.shutdown()
        for n in nodes:
            n.shutdown()


def _wait_audited(opts, parts, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snaps = [o.robustness_snapshot() for o in opts]
        if all(s["parts_audited"] >= parts for s in snaps):
            return snaps
        time.sleep(0.1)
    return [o.robustness_snapshot() for o in opts]


@pytest.mark.parametrize("audit_frac", [None, 1.0],
                         ids=["defaults", "every_part"])
def test_two_port_peers_at_the_jax_defaults(audit_frac):
    """Two port peers with CollabConfig's defaults (audit, repair, proof
    receipts, screening, gossip, encryption, the overlapped round) but for
    the round's timing: they end bitwise equal, and the audit finds
    nothing (with every part challenged, each peer audits the other's
    part of both rounds)."""
    kw = dict(run_id=f"co_def_{audit_frac}", target_batch_size=16,
              matchmaking_time=4.0, allreduce_timeout=15.0,
              averaging_timeout=30.0)
    if audit_frac is not None:
        kw["audit_frac"] = audit_frac
    cfg = CollabConfig(**kw)
    assert cfg.audit_gather and cfg.repair_convicted and cfg.gossip_strikes
    nodes = _nodes(2)
    opts = [_port_peer(n, cfg) for n in nodes]
    try:
        epochs = _run([lambda i=i: _train(opts[i], i, 2) for i in range(2)])
        assert min(epochs) >= 2
        a, b = _state(opts[0]), _state(opts[1])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        snaps = _wait_audited(opts, 2 if audit_frac else 0)
        for o, snap in zip(opts, snaps):
            assert o._auditor is not None and o._repair is not None
            assert o._gossip.verifier is not None
            for key in ("audit_fail", "audit_omit", "audit_unserved",
                        "repairs_applied", "proofs_convicted"):
                assert snap[key] == 0, (key, snap)
            assert o.ledger.snapshot() == {}
            if audit_frac:
                assert snap["parts_audited"] >= 2, snap
    finally:
        for o in opts:
            o.shutdown()
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("delay", [False, True])
def test_two_port_peers_with_powersgd_end_bitwise_equal(delay):
    nodes = _nodes(2)
    cfg = _collab(f"co_psgd_{delay}", delay_optimizer_step=delay,
                  grad_compression="power_sgd", powersgd_rank=2,
                  audit_gather=True, audit_frac=1.0, matchmaking_time=4.0)
    opts = [_port_peer(n, cfg) for n in nodes]
    try:
        init = [p.detach().clone()
                for p in opts[0].state.model.parameters()]
        epochs = _run([lambda i=i: _train(opts[i], i, 2) for i in range(2)])
        assert min(epochs) >= 2
        a, b = _state(opts[0]), _state(opts[1])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(torch.isfinite(x.float()).all() for x in a)
        assert opts[0].last_timings["group_size"] == 2
        assert any(not torch.equal(p, q) for p, q in zip(
            init, opts[0].state.model.parameters()))
        assert opts[0]._powersgd._errors    # error feedback carried
        snaps = _wait_audited(opts, 2)
        for snap in snaps:
            assert snap["parts_audited"] >= 2 and snap["audit_fail"] == 0
    finally:
        for o in opts:
            o.shutdown()
        for n in nodes:
            n.shutdown()


@pytest.mark.parametrize("stale", [False, True])
def test_apply_lands_a_queued_correction_in_the_device_gradients(stale):
    """A conviction's correction queued on the repair plane lands in the
    averaged gradients the next apply consumes: assigned exactly when the
    window still holds the served bytes, added otherwise; the gradient
    tensors are patched in place, outside the window nothing moves."""
    from dalle_tpu_torch.swarm.repair import RepairAction
    nodes = _nodes(1)
    opt = _port_peer(nodes[0], _collab("co_rep", audit_gather=True))
    try:
        names = jax_leaf_names(opt.state.model.cfg)
        params = dict(opt.state.model.named_parameters())
        gen = torch.Generator().manual_seed(5)
        averaged = [torch.randn(params[n].shape, generator=gen)
                    for n in names]
        before = torch.cat([a.reshape(-1) for a in averaged]).clone()
        lo = int(params[names[0]].numel()) - 7   # spans two leaves
        served = before[lo:lo + 20].numpy().copy()
        if stale:
            served += 1.0
        honest = np.random.default_rng(2).normal(size=20).astype(np.float32)
        assert opt._repair.submit(RepairAction(
            prefix="co_rep_grads", epoch=0, part=1, owner="ab" * 32, lo=lo,
            served=served, honest=honest))
        got = {}

        def recording(state, grads):
            got.update(grads)
            return state

        opt.apply_step = recording
        ptrs = [a.data_ptr() for a in averaged]
        opt._apply_averaged(averaged)
        assert [a.data_ptr() for a in averaged] == ptrs
        flat = torch.cat([got[n].reshape(-1) for n in names])
        want = before.clone()
        if stale:
            want[lo:lo + 20] += torch.from_numpy(honest - served)
        else:
            want[lo:lo + 20] = torch.from_numpy(honest)
        assert torch.equal(flat, want)
        snap = opt.robustness_snapshot()
        assert snap["repairs_applied"] == 1
        assert snap["repairs_exact"] == (0 if stale else 1)
        assert snap["repairs_pending"] == 0
    finally:
        opt.shutdown()
        nodes[0].shutdown()


def test_straggler_resyncs_from_peers():
    nodes = _nodes(2)
    cfg = _collab("co_late", matchmaking_time=1.0, allreduce_timeout=5.0,
                  averaging_timeout=10.0, delay_optimizer_step=False)
    fast = _port_peer(nodes[0], cfg)
    late = None
    try:
        assert _train(fast, 0, 1) >= 1
        late = _port_peer(nodes[1], cfg, seed=3)
        it = _batches(5)
        deadline = time.monotonic() + 20
        while late.local_epoch < 1 and time.monotonic() < deadline:
            _, _, g = grad_step(late.state.model, next(it))
            late.step(g, batch_size=1)
            time.sleep(0.05)
        assert late.local_epoch >= 1
        for x, y in zip(_state(late)[:len(jax_leaf_names(
                late.state.model.cfg))], _state(fast)):
            torch.testing.assert_close(x, y, rtol=0, atol=2e-3)
        assert late.state.opt_state.count == fast.state.opt_state.count
    finally:
        if late is not None:
            late.shutdown()
        fast.shutdown()
        for n in nodes:
            n.shutdown()


def test_state_averaging_requantizes_moments_as_jax_does():
    """Divergent 8-bit moments are dequantized, averaged and quantized
    again with the JAX package's quantizer; the params are averaged too."""
    import jax.numpy as jnp

    from dalle_tpu.ops.quant import quantize_blockwise as jquant
    from dalle_tpu_torch.ops.quant import Quantized, dequantize_blockwise

    nodes = _nodes(2)
    cfg = _collab("co_avg", target_batch_size=10 ** 9,
                  state_compression="none")
    opts = [_port_peer(n, cfg, seed=i, serve_state=False)
            for i, n in enumerate(nodes)]
    try:
        for i, opt in enumerate(opts):
            # diverge the moments: one update with peer-specific gradients
            g = {n: torch.full_like(p, 0.1 * (i + 1))
                 for n, p in opt.state.model.named_parameters()}
            opt.state = opt.apply_step(opt.state, g)
        before = [(dict(o.state.model.named_parameters()),
                   o.state.opt_state) for o in opts]
        before = [({k: v.detach().clone() for k, v in p.items()},
                   {k: dequantize_blockwise(m) if isinstance(m, Quantized)
                    else m.clone() for k, m in s.mu.items()})
                  for p, s in before]
        _run([lambda o=o: o._average_state() for o in opts])
        a, b = _state(opts[0]), _state(opts[1])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        mu = opts[0].state.opt_state.mu
        params = dict(opts[0].state.model.named_parameters())
        for name, moment in mu.items():
            avg = (before[0][1][name] + before[1][1][name]) / 2
            if isinstance(moment, Quantized):
                want = jquant(jnp.asarray(avg.numpy()),
                              moment.codes.shape[1], signed=True)
                np.testing.assert_array_equal(moment.codes.numpy(),
                                              np.asarray(want.codes))
                np.testing.assert_array_equal(moment.absmax.numpy(),
                                              np.asarray(want.absmax))
            else:
                torch.testing.assert_close(moment, avg, rtol=0, atol=0)
            torch.testing.assert_close(
                params[name],
                (before[0][0][name] + before[1][0][name]) / 2,
                rtol=0, atol=0)
    finally:
        for o in opts:
            o.shutdown()
        for n in nodes:
            n.shutdown()


def test_snapshot_during_an_apply_is_never_half_applied():
    nodes = _nodes(1)
    opt = _port_peer(nodes[0], _collab("co_snap"))
    started = threading.Event()
    params = list(opt.state.model.parameters())

    def slow_apply(state, grads):
        with torch.no_grad():
            params[0].add_(1.0)
            started.set()
            time.sleep(0.5)
            params[-1].add_(1.0)
        return state

    opt.apply_step = slow_apply
    before = [p.detach().clone() for p in (params[0], params[-1])]
    got = {}

    def snap():
        started.wait(10)
        got["snap"] = opt._state_snapshot()

    try:
        t = threading.Thread(target=snap)
        t.start()
        names = jax_leaf_names(opt.state.model.cfg)
        opt._apply_averaged([np.zeros(1, np.float32)] * len(names))
        t.join(10)
        epoch, arrays = got["snap"]
        named = dict(zip(names, arrays))
        order = [n for n, _ in opt.state.model.named_parameters()]
        assert epoch == 1
        np.testing.assert_array_equal(named[order[0]],
                                      before[0].numpy() + 1.0)
        np.testing.assert_array_equal(named[order[-1]],
                                      before[1].numpy() + 1.0)
    finally:
        opt.shutdown()
        nodes[0].shutdown()


# -- the JAX package's peers -------------------------------------------------

def _jax_peer(dht, cfg, params, record=None):
    import jax

    from dalle_tpu.optim import make_optimizer as jmake
    from dalle_tpu.swarm.optimizer import CollaborativeOptimizer as JCO
    from dalle_tpu.training.steps import TrainState as JTS
    from dalle_tpu.training.steps import make_apply_step

    tx = jmake(OPT_J())
    apply = jax.jit(make_apply_step(tx))

    def recording(state, grads):
        if record is not None:
            record.append([np.asarray(x)
                           for x in jax.tree_util.tree_leaves(grads)])
        return apply(state, grads)

    opt = JCO(dht, cfg, JTS.create(params, tx), recording)
    opt.tracker.min_refresh_period = 0.05
    return opt


def OPT_J():
    from dalle_tpu.config import OptimizerConfig as JOC
    return JOC(warmup_steps=OPT.warmup_steps, total_steps=OPT.total_steps)


def _jax_cfg(cfg):
    import dataclasses

    from dalle_tpu.config import CollabConfig as JCC
    fields = {f.name for f in dataclasses.fields(JCC)}
    return JCC(**{k: v for k, v in dataclasses.asdict(cfg).items()
                  if k in fields})


def test_mixed_tiny_dalle_pair_trains_on_identical_rounds():
    """A JAX peer (dalle_tpu.training.steps) and a port peer (the port's
    steps) start from the same weights and train 2 epochs together: every
    round's averaged gradients are byte-identical on both, and their params
    stay within the port's training tolerance."""
    import jax

    from dalle_tpu.config import tiny_model_config as jtiny
    from dalle_tpu.models.dalle import DALLE as JDALLE
    from dalle_tpu.models.dalle import init_params as jinit
    from dalle_tpu.swarm import dht as jdht
    from dalle_tpu.swarm import identity as jid
    from dalle_tpu.training.steps import make_grad_step

    jcfg = jtiny(**MODEL)
    jmodel = JDALLE(jcfg)
    params = jinit(jmodel, jax.random.PRNGKey(0))
    grad_fn = jax.jit(make_grad_step(jmodel))
    cfg = _collab("co_mixed", delay_optimizer_step=False,
                  matchmaking_time=4.0, target_batch_size=16,
                  wire_codec_backend="device")
    jnode = jdht.DHT(identity=jid.Identity.generate(), rpc_timeout=2.0)
    tnode = DHT(initial_peers=[jnode.visible_address],
                identity=Identity.generate(), rpc_timeout=2.0)
    jrec, trec = [], []
    jopt = _jax_peer(jnode, _jax_cfg(cfg), params, jrec)
    tmodel = params_from_jax(jax.tree.map(np.asarray, params),
                             tiny_model_config(**MODEL))
    topt = _port_peer(tnode, cfg, model=tmodel)
    names = jax_leaf_names(tmodel.cfg)
    real_apply = topt.apply_step

    def recording(state, grads):
        trec.append([grads[n].numpy().copy() for n in names])
        return real_apply(state, grads)

    topt.apply_step = recording

    def run_jax():
        it = _batches(1)
        deadline = time.monotonic() + 90
        while jopt.local_epoch < 2 and time.monotonic() < deadline:
            b = {k: jax.numpy.asarray(v.numpy()) for k, v in
                 next(it).items()}
            grads, _ = grad_fn(jopt.state.params, b)
            jopt.step(grads, batch_size=8)
        return jopt.local_epoch

    try:
        epochs = _run([run_jax, lambda: _train(topt, 2, 2)])
        assert min(epochs) >= 2
        assert len(jrec) == len(trec) >= 2
        for jr, tr in zip(jrec, trec):
            for a, b in zip(jr, tr):
                np.testing.assert_array_equal(a, b)
        jleaves = jax.tree_util.tree_leaves(jopt.state.params)
        tparams = dict(topt.state.model.named_parameters())
        for name, leaf in zip(names, jleaves):
            want = np.asarray(leaf)
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(tparams[name].detach().numpy(), want,
                                       rtol=0, atol=TOL * scale,
                                       err_msg=name)
    finally:
        topt.shutdown()
        jopt.shutdown()
        tnode.shutdown()
        jnode.shutdown()


def test_port_joiner_loads_a_jax_peers_state_exactly():
    import jax

    from dalle_tpu.config import tiny_model_config as jtiny
    from dalle_tpu.models.dalle import DALLE as JDALLE
    from dalle_tpu.models.dalle import init_params as jinit
    from dalle_tpu.swarm import dht as jdht
    from dalle_tpu.swarm import identity as jid

    jcfg = jtiny(**MODEL)
    params = jinit(JDALLE(jcfg), jax.random.PRNGKey(4))
    cfg = _collab("co_join", state_compression="none",
                  target_batch_size=10 ** 9)
    jnode = jdht.DHT(identity=jid.Identity.generate(), rpc_timeout=2.0)
    tnode = DHT(initial_peers=[jnode.visible_address],
                identity=Identity.generate(), rpc_timeout=2.0)
    jopt = _jax_peer(jnode, _jax_cfg(cfg), params)
    topt = None
    try:
        # move the server's state off its init: two LAMB updates
        g = jax.tree.map(lambda x: x * 0.01 + 0.001, params)
        for _ in range(2):
            jopt.state = jopt.apply_step(jopt.state, g)
        jopt.local_epoch = 2
        topt = _port_peer(tnode, cfg, seed=9, serve_state=False)
        assert topt.load_state_from_peers(timeout=20)
        assert topt.local_epoch == 2
        cfg_t = tiny_model_config(**MODEL)
        want = state_leaf_tensors(
            params_from_jax(jax.tree.map(np.asarray, jopt.state.params),
                            cfg_t),
            opt_state_from_jax(jopt.state.opt_state, cfg_t))
        got = _state(topt)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    finally:
        if topt is not None:
            topt.shutdown()
        jopt.shutdown()
        tnode.shutdown()
        jnode.shutdown()
