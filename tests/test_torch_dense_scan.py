"""The stacked ``dense_scan`` layout of the port (``models/transformer.py``,
``params.py``, ``optim/lamb.py``, ``optim/lamb8bit.py``,
``training/checkpoint.py``, ``models/decode.py``) against the JAX package's
(``transformer/cycle/block_{u}`` leaves with a leading axis of
``dense_scan_reps()``), on weights converted from the JAX tree.

Each config has an overhang: a body that is not a multiple of the
attention-type group, so the last repetition holds slices no layer reads
(the flagship's 63 = 15 x 4 + 3). JAX applies them and discards the result,
the port never applies them; both give them a zero gradient.

At dim 64 no leaf reaches the default ``min_8bit_size``, so the 8-bit tests
set it to 1024: one layer's FF bias (256) stays f32 while the stacked one
(4 x 256) is quantized, as at the flagship (4096 against 16 x 4096).

Tolerances: losses 2e-4 relative and every gradient leaf within 2e-4 of
its largest magnitude (``tests/test_torch_train.py``); fp32 LAMB
parameters within 1e-6 of the leaf's largest magnitude and 8-bit moment
codes identical without the clip (``tests/test_torch_quant.py``; with the
clip the norm sums in another order, so a code may differ by one); decode
logits within 2e-4; the tree, the checkpoints, the leaf order and the
PowerSGD plan exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.models import attention as jattention
from dalle_tpu.models import decode as jdecode
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu.optim.lamb import default_stacked_mask as jax_stacked_mask
from dalle_tpu.optim.lamb import make_optimizer_fp32 as jax_lamb_fp32
from dalle_tpu.optim.lamb8bit import make_optimizer_8bit as jax_lamb8bit
from dalle_tpu.swarm import powersgd as jps
from dalle_tpu.training import steps as jsteps
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.models import decode as tdecode
from dalle_tpu_torch.models import transformer as ttransformer
from dalle_tpu_torch.ops import quant as tquant
from dalle_tpu_torch.optim import apply_updates, make_optimizer
from dalle_tpu_torch.optim.lamb import default_stacked_mask
from dalle_tpu_torch.params import (flax_path, jax_layout_scanned,
                                    jax_leaf_names, opt_state_from_jax,
                                    params_from_jax, params_to_jax,
                                    state_leaf_tensors)
from dalle_tpu_torch.swarm import powersgd as tps
from dalle_tpu_torch.training.steps import TrainState, grad_step

torch.set_num_threads(2)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 2e-4

DENSE = dict(depth=7, attn_types=("full", "axial_row"), dense_scan=True,
             shared_block_cycle=0, final_conv_block=False)
CONFIGS = {
    # body 7: four repetitions of two, one overhang slice (block_1, rep 3)
    "dense": ("tiny", DENSE),
    # the same body and a final conv_like block of its own
    "dense_wconv": ("tiny", dict(DENSE, depth=8, final_conv_block=True,
                                 conv_kernel=3)),
    # the flagship's knobs at tiny width (fused LN, save_attn remat,
    # hoisted casts): body 9 in 3 x 4, three overhang slices, w_conv
    "flagship_dense": ("flagship", dict(
        depth=10, dim=64, heads=4, head_dim=16, text_seq_len=16,
        image_grid=4, vocab_text=128, vocab_image=64, conv_kernel=3,
        dtype="float32", head_chunk=48, shared_block_cycle=0,
        remat_skip_blocks=0, scan_unroll=1, dense_scan=True)),
}
OPT = dict(warmup_steps=1, total_steps=10, min_8bit_size=1024,
           block_size=256)


def _configs(name):
    kind, kw = CONFIGS[name]
    if kind == "flagship":
        return (jconfig.flagship_model_config(**kw),
                tconfig.flagship_model_config(**kw))
    return jconfig.tiny_model_config(**kw), tconfig.tiny_model_config(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jcfg, _ = _configs(name)
    params = jax.tree.map(np.asarray,
                          jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def noise(path, leaf):   # nonzero biases: a dropped bias must show
        if path[-1].key == "bias":
            return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(noise, params)


def _setup(name, batch=2, seed=0):
    jcfg, tcfg = _configs(name)
    params = _jax_params(name)
    rng = np.random.default_rng(seed)
    text = rng.integers(2, jcfg.vocab_text, (batch, jcfg.text_seq_len))
    image = rng.integers(0, jcfg.vocab_image, (batch, jcfg.image_seq_len))
    return jcfg, tcfg, params, params_from_jax(params, tcfg), text, image


def _overhang(tcfg):
    """(port name prefix, rep) of every stacked slice no layer reads."""
    group = len(tcfg.attn_types)
    body = tcfg.depth - (1 if tcfg.final_conv_block else 0)
    reps = tcfg.dense_scan_reps()
    return [(f"transformer.blocks.block_{u}.", reps - 1)
            for u in range(group) if (reps - 1) * group + u >= body]


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattention, "_PALLAS_INTERPRET", True)


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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tree_round_trips_and_leaf_order_equals_jax(name):
    """The stacked tree converts both ways exactly, every stacked leaf has
    the leading axis of ``dense_scan_reps()``, and ``jax_leaf_names``
    lists the parameters in ``jax.tree_util`` order."""
    _, tcfg, params, model, _, _ = _setup(name)
    reps = tcfg.dense_scan_reps()
    assert reps > 1 and jax_layout_scanned(tcfg)
    tree = params["params"]["transformer"]
    assert sorted(tree["cycle"]) == [f"block_{u}" for u in
                                     range(len(tcfg.attn_types))]
    _assert_trees_equal(params_to_jax(model), params)
    for n, p in model.named_parameters():
        if n.startswith("transformer.blocks.block_") and "wconv" not in n:
            assert p.shape[0] == reps, n
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [tuple(k.key for k in path) for path, _ in leaves] == [
        ("params",) + flax_path(n, tcfg) for n in jax_leaf_names(tcfg)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_every_gradient_match_jax(name, pallas_interpret):
    """The forward loss and every gradient against ``jax.value_and_grad``
    of the JAX loss; the overhang slices' gradient is exactly 0 in both
    packages, and every other slice's is not."""
    jcfg, tcfg, params, model, text, image = _setup(name)
    jb = {"text": jnp.asarray(text, jnp.int32),
          "image": jnp.asarray(image, jnp.int32)}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps._loss_fn(JaxDALLE(jcfg), p, jb),
        has_aux=True))(params)
    loss, aux, grads = grad_step(model, {"text": torch.from_numpy(text),
                                         "image": torch.from_numpy(image)})
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for key in ("loss_text", "loss_img"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   **LOSS_TOL)
    want = dict(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                tcfg).named_parameters())
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        w = want[n].detach().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()),
                                   err_msg=n)
    overhang = _overhang(tcfg)
    assert overhang
    for n, g in grads.items():
        for prefix, rep in overhang:
            if n.startswith(prefix):
                assert not g[rep].any() and not want[n][rep].any(), n
                assert all(g[r].any() for r in range(rep)), n


def test_layers_read_contiguous_slices_of_the_stacked_leaves():
    """Each layer's view gets views of its repetition's slices (no storage
    of its own, contiguous for the kernels' stride checks) and holds them
    only while it runs, and the schedule's layers are ``block_{i %
    group}``'s slice ``i // group``."""
    _, tcfg, _, model, _, _ = _setup("dense_wconv")
    layers = model.transformer.layers()
    group = len(tcfg.attn_types)
    assert len(layers) == tcfg.depth
    assert layers[-1] == (model.transformer.blocks["block_wconv"], None)
    for i, (layer, params) in enumerate(layers[:-1]):
        block = model.transformer.blocks[f"block_{i % group}"]
        assert not list(layer.parameters())
        assert len(params) == len(list(block.parameters()))
        for (n, p), (sub, leaf, v) in zip(block.named_parameters(), params):
            mod_name, _, leaf_name = n.rpartition(".")
            assert sub is layer.get_submodule(mod_name) and leaf == leaf_name
            assert v.is_contiguous(), n
            assert v.data_ptr() == p[i // group].data_ptr(), n
        with ttransformer.bound(params):
            assert len(list(layer.parameters())) == len(params)
        assert not list(layer.parameters())
    assert not any(n.startswith("transformer._views")
                   for n, _ in model.named_parameters())


def test_no_slice_outlives_the_step():
    """After ``grad_step`` (cast copies hoisted, ``save_attn`` remat) and
    after a decode step, no layer view holds a tensor, so the cast copy
    of the stacked leaves is freed with the step's graph; a view run
    without its slices raises instead of reading stale weights."""
    _, tcfg, _, model, text, image = _setup("flagship_dense")
    assert tcfg.param_cast_hoist and tcfg.remat_policy == "save_attn"
    views = [v for vs in model.transformer._views for v in vs]

    def held():
        return [n for v in views for n, _ in v.named_parameters()]

    grad_step(model, {"text": torch.from_numpy(text),
                      "image": torch.from_numpy(image)})
    assert not held()
    cache = tdecode.init_cache(tcfg, 1, "cpu")
    tdecode.decode_step(model, cache, torch.tensor([tcfg.vocab_total]), 0)
    assert not held()
    layer, _ = model.transformer.layers()[0]
    x = torch.zeros(1, tcfg.total_seq_len, tcfg.dim)
    with pytest.raises((AttributeError, TypeError)):
        layer(x, model.transformer.rotary("cpu"))


def test_stacked_mask_equals_jax():
    _, tcfg, params, model, _, _ = _setup("dense_wconv")
    reps = tcfg.dense_scan_reps()
    for arg in (None, reps, 0, reps + 1):
        jmask = jax_stacked_mask(params, arg)
        want = {n: bool(m) for n, m in zip(
            jax_leaf_names(tcfg), jax.tree.leaves(jmask))}
        assert default_stacked_mask(model, arg) == want, arg
    assert sum(default_stacked_mask(model, reps).values()) == 2 * 15


def _grads(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


def _port_grads(jgrads, tcfg):
    return {n: p.detach() for n, p in params_from_jax(
        jgrads, tcfg).named_parameters()}


def _assert_params_close(model, params, tcfg, rel):
    want = dict(params_from_jax(jax.tree.map(np.asarray, params),
                                tcfg).named_parameters())
    for n, p in model.named_parameters():
        w = want[n].detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize("clip", [None, 4.0])
def test_fp32_lamb_three_steps_match_jax(clip):
    """Three fp32 LAMB updates from both packages' own init on the same
    gradients, with each stacked slice's own trust ratio. A trust ratio
    taken over the whole stacked leaf would move the parameters
    differently."""
    _, tcfg, params, model, _, _ = _setup("dense")
    opt = dict(OPT, state_bits=32, max_grad_norm=clip,
               stacked_reps=tcfg.dense_scan_reps())
    jtx = jax_lamb_fp32(jconfig.OptimizerConfig(**opt))
    tx = make_optimizer(tconfig.OptimizerConfig(**opt))
    jstate, state = jtx.init(params), tx.init(model)
    for i in range(3):
        jgrads = _grads(params, i)
        upd, jstate = jtx.update(jgrads, jstate, params)
        params = optax.apply_updates(params, upd)
        updates, state = tx.update(_port_grads(jgrads, tcfg), state, model)
        apply_updates(model, updates)
    _assert_params_close(model, params, tcfg, 1e-6)
    unsliced = make_optimizer(tconfig.OptimizerConfig(
        **dict(opt, stacked_reps=0)))
    other, _ = unsliced.update(_port_grads(_grads(params, 9), tcfg),
                               state, model)
    sliced, _ = tx.update(_port_grads(_grads(params, 9), tcfg), state,
                          model)
    name = "transformer.blocks.block_0.ff.wi.kernel"
    assert not torch.allclose(other[name], sliced[name], rtol=1e-3, atol=0)


def _assert_moments(state, jstate, tcfg, exact):
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    n_q = []
    for got_m, want_m in ((state.mu, want.mu), (state.nu, want.nu)):
        for n, g in got_m.items():
            w = want_m[n]
            assert isinstance(g, tquant.Quantized) == isinstance(
                w, tquant.Quantized), n
            if not isinstance(g, tquant.Quantized):
                atol = 0 if exact else 1e-6 * float(w.abs().max())
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                           atol=atol, err_msg=n)
                continue
            n_q.append(n)
            diff = g.codes.numpy().astype(int) - w.codes.numpy()
            assert np.abs(diff).max() <= (0 if exact else 1), n
            if exact:
                np.testing.assert_array_equal(g.absmax.numpy(),
                                              w.absmax.numpy(), err_msg=n)
    return n_q


@pytest.mark.parametrize("clip", [None, 4.0])
def test_lamb8bit_three_steps_match_jax(clip):
    """Three 8-bit LAMB updates from both packages' own init: the stacked
    FF biases (4 x 256 >= 1024) are quantized in both, one layer's (256)
    would not be; codes identical without the clip. With the clip the
    norm's last bits differ (its sums run in another order), a code may
    differ by one, and a one-code difference grows in the next update, so
    each update there starts from the JAX package's state."""
    _, tcfg, params, model, _, _ = _setup("dense")
    opt = dict(OPT, state_bits=8, max_grad_norm=clip,
               stacked_reps=tcfg.dense_scan_reps())
    jtx = jax_lamb8bit(jconfig.OptimizerConfig(**opt))
    tx = make_optimizer(tconfig.OptimizerConfig(**opt))
    jstate, state = jtx.init(params), tx.init(model)
    quantized = _assert_moments(state, jstate, tcfg, exact=True)
    for u in (0, 1):
        for leaf in ("wi", "gate"):
            assert f"transformer.blocks.block_{u}.ff.{leaf}.bias" in \
                quantized
    assert 256 < OPT["min_8bit_size"] <= 4 * 256
    for i in range(3):
        if clip is not None:
            model = params_from_jax(params, tcfg)
            state = opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                       tcfg)
        jgrads = _grads(params, i)
        upd, jstate = jtx.update(jgrads, jstate, params)
        params = optax.apply_updates(params, upd)
        updates, state = tx.update(_port_grads(jgrads, tcfg), state, model)
        apply_updates(model, updates)
        _assert_moments(state, jstate, tcfg, exact=clip is None)
    _assert_params_close(model, params, tcfg, 1e-6)


def test_checkpoints_load_both_ways_exactly(tmp_path):
    """A port checkpoint of a stacked model restores in the JAX package,
    and a JAX checkpoint restores in the port, bit for bit (params, the
    8-bit moments and the count)."""
    from dalle_tpu.training.checkpoint import CheckpointManager as JCM
    from dalle_tpu_torch.training.checkpoint import CheckpointManager

    _, tcfg, params, model, _, _ = _setup("dense_wconv")
    opt = dict(OPT, state_bits=8, stacked_reps=tcfg.dense_scan_reps())
    jtx = jax_lamb8bit(jconfig.OptimizerConfig(**opt))
    tx = make_optimizer(tconfig.OptimizerConfig(**opt))
    jstate = jsteps.TrainState.create(params, jtx)
    jstate = jsteps.make_apply_step(jtx)(jstate, _grads(params, 3))
    JCM(str(tmp_path / "j"), async_writes=False).save(jstate, 5)
    state = TrainState.create(model, tx)
    restored, epoch = CheckpointManager(
        str(tmp_path / "j"), async_writes=False).restore_latest(state)
    assert epoch == 5 and restored.step == 1
    want = state_leaf_tensors(
        params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg),
        opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt_state),
                           tcfg))
    got = state_leaf_tensors(restored.model, restored.opt_state)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    updates, restored.opt_state = tx.update(
        _port_grads(_grads(params, 4), tcfg), restored.opt_state,
        restored.model)
    apply_updates(restored.model, updates)
    restored.step += 1
    CheckpointManager(str(tmp_path / "p"), async_writes=False).save(
        restored, 6)
    template = jsteps.TrainState.create(params, jtx)
    jrestored, jepoch = JCM(str(tmp_path / "p"),
                            async_writes=False).restore_latest(template)
    assert jepoch == 6 and int(jrestored.step) == 2
    _assert_trees_equal(jax.tree.map(np.asarray, jrestored.params),
                        params_to_jax(restored.model))
    back = opt_state_from_jax(jax.tree.map(np.asarray,
                                           jrestored.opt_state), tcfg)
    got = state_leaf_tensors(restored.model, restored.opt_state)
    want = state_leaf_tensors(restored.model, back)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_decode_of_a_stacked_model_matches_jax():
    """Teacher-forced ``decode_step`` of the stacked model against JAX
    ``decode_step`` on the stacked tree (each layer reads its repetition's
    slice), and against the port's own forward; greedy codes equal."""
    jcfg, tcfg, params, model, text, image = _setup("dense_wconv", seed=2)
    labels = np.concatenate([text, image + jcfg.vocab_text], 1)
    inputs = np.concatenate([np.full((2, 1), jcfg.vocab_total),
                             labels[:, :-1]], 1)
    jstep = jax.jit(lambda c, ids, p: jdecode.decode_step(params, jcfg, c,
                                                          ids, p))
    jcache = jdecode.init_cache(jcfg, batch=2)
    tcache = tdecode.init_cache(tcfg, 2, "cpu")
    got_j, got_t = [], []
    for p in range(jcfg.total_seq_len):
        lj, jcache = jstep(jcache, jnp.asarray(inputs[:, p], jnp.int32),
                           jnp.asarray(p))
        lt, tcache = tdecode.decode_step(model, tcache,
                                         torch.from_numpy(inputs[:, p]), p)
        got_j.append(np.asarray(lj))
        got_t.append(lt.numpy())
    got_t = np.stack(got_t, 1)
    np.testing.assert_allclose(got_t, np.stack(got_j, 1), **LOSS_TOL)
    with torch.no_grad():
        _, _, logits = model(torch.from_numpy(text), torch.from_numpy(image),
                             return_logits=True)
    np.testing.assert_allclose(got_t, logits.numpy(), **LOSS_TOL)
    want = np.asarray(jdecode.generate_images(
        params, jcfg, jnp.asarray(text, jnp.int32), jax.random.PRNGKey(0),
        jdecode.SamplingConfig(temperature=0.0)))
    got = tdecode.generate_images(model, torch.from_numpy(text), [0, 1],
                                  tdecode.SamplingConfig(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_powersgd_plan_equals_jax():
    """A stacked kernel is one (reps, in x out) matrix in both packages'
    plans; the plans (and the first epoch's Q) are equal."""
    _, tcfg, params, model, _, _ = _setup("dense_wconv")
    jleaves = jax.tree.leaves(params)
    named = dict(model.named_parameters())
    tleaves = [named[n].detach() for n in jax_leaf_names(tcfg)]
    # rank 1: at reps 4 a rank-2 factor pair of a stacked kernel is over
    # the default min_ratio, and the plan would skip it
    tc = tps.PowerSGDCompressor(rank=1, seed=3)
    jc = jps.PowerSGDCompressor(rank=1, seed=3)
    tplans, jplans = tc.plan(tleaves), jc.plan(jleaves)
    assert [(p.index, p.shape, p.m, p.n) for p in tplans] \
        == [(p.index, p.shape, p.m, p.n) for p in jplans]
    reps = tcfg.dense_scan_reps()
    assert any(p.m == reps and len(p.shape) == 3 for p in tplans)
    for tp_, jp_ in zip(tplans, jplans):
        assert tc._q_for(tp_, 0).tobytes() == jc._q_for(jp_, 0).tobytes()


def test_the_serving_engine_decodes_a_stacked_model():
    """The continuous-batching engine runs the stacked model through the
    same per-layer slices: each request emits its one-row
    ``generate_images`` codes for the same seed, code for code (as
    ``tests/test_torch_serving.py`` holds for an unstacked model)."""
    from dalle_tpu_torch.serving.engine import DecodeEngine

    _, tcfg, _, model, _, _ = _setup("dense_wconv")
    sampling = tdecode.SamplingConfig(temperature=1.0, top_k=8)
    rng = np.random.default_rng(100)
    texts = [rng.integers(2, tcfg.vocab_text, tcfg.text_seq_len)
             for _ in range(2)]
    engine = DecodeEngine(model, tcfg, tconfig.ServingConfig(
        n_slots=1, steps_per_call=4), sampling=sampling).start()
    try:
        rows = [engine.submit(t, 1000 + i).result(timeout=120)
                for i, t in enumerate(texts)]
    finally:
        engine.stop()
    for i, (row, text) in enumerate(zip(rows, texts)):
        want = tdecode.generate_images(model, torch.from_numpy(text[None]),
                                       [1000 + i], sampling, buckets=4)
        np.testing.assert_array_equal(row["codes"], want[0].numpy())
