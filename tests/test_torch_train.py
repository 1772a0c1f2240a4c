"""The port's training slice against the JAX package: micro-batch
accumulation, the text k/v gradient, the fp32 LAMB and its schedule and
weight-decay mask, the routing of training through the kernel wrappers, on
converted weights; and the loss and every gradient against the JAX
package's on ``flagship_tiny``. The same comparison on the
other configs is in tests/test_torch_train_zoo.py and
tests/test_torch_train_gated.py, which share this file's helpers (the JAX
side's interpret-mode kernels take most of their time, so the files run in
parallel).

The JAX side is ``dalle_tpu.training.steps`` with its Pallas kernels in
interpret mode (``models.attention._PALLAS_INTERPRET``). The ZOO and
``flagship_tiny`` configs are those of tests/test_torch_model.py; at their
widths the JAX package's shape gates send its LayerNorm and GEGLU to the
plain lowerings, so the ``gated`` config (dim 128, two heads of 64, text 16,
an 8x8 grid, B 2: ``ln_supported``/``geglu_supported`` pass) makes JAX run
those two backward kernels too.

Tolerances (f32): losses 2e-4 relative, as the forward test; a gradient
leaf within 2e-4 of its largest magnitude, since a gradient sums many
products in another order in each framework and its small entries carry
that absolute error.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.data.synthetic import SyntheticCodes as JaxSyntheticCodes
from dalle_tpu.models import attention as jattention
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu.optim.lamb import default_wd_mask as jax_wd_mask
from dalle_tpu.optim.lamb import make_lr_schedule as jax_lr_schedule
from dalle_tpu.optim.lamb import make_optimizer_fp32 as jax_lamb_fp32
from dalle_tpu.training import steps as jsteps
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.data.synthetic import SyntheticCodes
from dalle_tpu_torch.models import transformer as ttransformer
from dalle_tpu_torch.models.transformer import wrapper_calls
from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.optim import (Lamb, Lamb8bit, default_wd_mask,
                                   make_lr_schedule, make_optimizer)
from dalle_tpu_torch.params import params_from_jax
from dalle_tpu_torch.training.steps import TrainState, grad_step, train_step

torch.set_num_threads(2)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 2e-4

FLAGSHIP_TINY = dict(depth=10, dim=64, heads=4, head_dim=16, text_seq_len=16,
                     image_grid=4, vocab_text=128, vocab_image=64,
                     conv_kernel=3, dtype="float32", head_chunk=48)
GATED = dict(FLAGSHIP_TINY, depth=5, dim=128, heads=2, head_dim=64,
             image_grid=8)
ZOO = {
    "full": dict(),
    "axial": dict(attn_types=("axial_row", "axial_col"), depth=4),
    "scan_wconv": dict(attn_types=("axial_row", "axial_col", "axial_row",
                                   "axial_row"),
                       depth=10, shared_block_cycle=4, final_conv_block=True,
                       conv_kernel=3),
    "plain_untied": dict(attn_types=("axial_row", "axial_col"), depth=4,
                         tied_embeddings=False),
}


def _configs(name, **extra):
    """(jax cfg, port cfg) built from the same keyword arguments."""
    if name in ("flagship_tiny", "gated"):
        kw = dict(FLAGSHIP_TINY if name == "flagship_tiny" else GATED,
                  **extra)
        return (jconfig.flagship_model_config(**kw),
                tconfig.flagship_model_config(**kw))
    kw = dict(ZOO[name], ln_fusion=True, ff_fusion="all", **extra)
    if name == "plain_untied":
        kw.update(ln_fusion=False, ff_fusion="none")
    return jconfig.tiny_model_config(**kw), tconfig.tiny_model_config(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg):
    return jax.tree.map(np.asarray,
                        jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))


def _setup(name, seed=0, batch=2, **extra):
    jcfg, tcfg = _configs(name, **extra)
    params = _jax_params(jcfg)
    rng = np.random.default_rng(seed)

    # nonzero biases: a dropped bias add (or its gradient) must show
    def noise(path, leaf):
        if path[-1].key == "bias":
            return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(noise, params)
    text = rng.integers(2, jcfg.vocab_text, (batch, jcfg.text_seq_len))
    image = rng.integers(0, jcfg.vocab_image, (batch, jcfg.image_seq_len))
    model = params_from_jax(params, tcfg)
    return jcfg, tcfg, params, model, text, image


def _batches(text, image):
    jb = {"text": jnp.asarray(text, jnp.int32),
          "image": jnp.asarray(image, jnp.int32)}
    tb = {"text": torch.from_numpy(text), "image": torch.from_numpy(image)}
    return jb, tb


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattention, "_PALLAS_INTERPRET", True)


def _jax_loss_and_grads(jcfg, params, jbatch):
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jsteps._loss_fn(JaxDALLE(jcfg), p, jbatch),
        has_aux=True))(params)
    return loss, aux, jax.tree.map(np.asarray, grads)


def _assert_grads_close(tcfg, grads, jgrads, tol=GRAD_TOL):
    """Every port gradient against the JAX gradient of the same flax leaf
    (the JAX tree loaded through the converter): within ``tol`` of the
    leaf's largest JAX magnitude."""
    want = dict(params_from_jax(jgrads, tcfg).named_parameters())
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        w = want[name].detach().float().numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=tol * scale, err_msg=name)


def test_text_kv_grads_sum_both_calls():
    """The text keys/values feed the text call (as its k/v) and the image
    call (as its prefix): their gradient is the sum of the two."""
    from dalle_tpu_torch.models.attention import (join_halves,
                                                  zoo_attention_halves)
    from dalle_tpu_torch.ops.attention import LineAttention

    rng = np.random.default_rng(7)
    text, grid = 8, 4
    q, k, v, dy = (torch.from_numpy(rng.standard_normal(
        (2, text + grid * grid, 2, 8)).astype(np.float32)) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    join_halves(*zoo_attention_halves(
        *leaves, attn_type="axial_row", text_len=text,
        grid=grid)).backward(dy)
    parts = [x.transpose(1, 2).clone().requires_grad_(True)
             for x in (q, k, v)]
    t = [x[:, :, :text] for x in parts]
    i = [x[:, :, text:] for x in parts]
    dyt = dy.transpose(1, 2)
    text_out = LineAttention.apply(*t, None, None, text, 0, False)
    dk_t, dv_t = torch.autograd.grad(text_out, t[1:], dyt[:, :, :text])
    img_out = LineAttention.apply(*i, t[1], t[2], grid, grid, False)
    dkp, dvp = torch.autograd.grad(img_out, (t[1], t[2]), dyt[:, :, text:])
    for leaf, own, prefix in ((leaves[1], dk_t, dkp), (leaves[2], dv_t, dvp)):
        got = leaf.grad.transpose(1, 2)[:, :, :text]
        torch.testing.assert_close(got, own + prefix)
        assert prefix.abs().max() > 0.1 * own.abs().max()


def test_accumulated_grads_equal_one_double_batch():
    _, tcfg, _, model, text, image = _setup("flagship_tiny", batch=4)
    _, tb = _batches(text, image)
    loss2, aux2, grads2 = grad_step(model, tb, accum_steps=2)
    loss1, aux1, grads1 = grad_step(model, tb, accum_steps=1)
    torch.testing.assert_close(loss2, loss1, rtol=1e-6, atol=1e-6)
    for key in aux1:
        torch.testing.assert_close(aux2[key], aux1[key], rtol=1e-6,
                                   atol=1e-6)
    for name in grads1:
        scale = float(grads1[name].abs().max())
        torch.testing.assert_close(grads2[name], grads1[name], rtol=0,
                                   atol=1e-5 * max(scale, 1e-12))


def test_loss_grads_and_two_lamb_steps_match_jax(pallas_interpret):
    """``flagship_tiny`` (FLAGSHIP_TUNED at tiny width: fused LayerNorm,
    ``save_attn`` remat with ``block_3`` plain and its fused GEGLU,
    ``w_conv``, hoisted casts, f32): the loss and every gradient, then two
    fused steps with the fp32 LAMB. JAX's ``make_train_step`` is its
    ``make_grad_step`` followed by its ``make_apply_step``; the test jits
    those two halves, so one compile of the gradient serves both checks.
    The first step has lr 0 (count 0), the second moves every parameter.
    Parameters within 1e-5 of the leaf's largest magnitude (the updates
    are ~lr = 2.5e-3 of it); the metrics as the loss."""
    jcfg, tcfg, params, model, text, image = _setup("flagship_tiny")
    assert tcfg.remat and tcfg.remat_policy == "save_attn"
    jb, tb = _batches(text, image)
    jgrad = jax.jit(jsteps.make_grad_step(JaxDALLE(jcfg)))
    jgrads, aux_j = jgrad(params, jb)
    loss, aux, grads = grad_step(model, tb)
    for key in ("loss", "loss_text", "loss_img"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]),
                                   **LOSS_TOL)
    np.testing.assert_allclose(float(loss), float(aux_j["loss"]),
                               **LOSS_TOL)
    _assert_grads_close(tcfg, grads, jax.tree.map(np.asarray, jgrads))

    opt_cfg = tconfig.OptimizerConfig(state_bits=32, warmup_steps=1,
                                      total_steps=10)
    jopt = jax_lamb_fp32(jconfig.OptimizerConfig(
        state_bits=32, warmup_steps=1, total_steps=10))
    japply = jax.jit(jsteps.make_apply_step(jopt))
    jstate = jsteps.TrainState.create(params, jopt)
    tx = make_optimizer(opt_cfg)
    state = TrainState.create(model, tx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):
        jgrads, jmetrics = jgrad(jstate.params, jb)
        jmetrics["grad_norm"] = optax.global_norm(jgrads)
        jstate = japply(jstate, jgrads)
        state, metrics = train_step(state, tb, tx)
        for key in ("loss", "loss_text", "loss_img", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), **LOSS_TOL)
    assert state.step == 2 and state.opt_state.count == 2
    want = dict(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                tcfg).named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach().numpy()
        assert not torch.equal(p, before[name]), name
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_lr_schedule_equals_optax():
    for warmup, total in ((2, 100), (3125, 31250), (0, 10)):
        cfg = tconfig.OptimizerConfig(warmup_steps=warmup, total_steps=total)
        jsched = jax_lr_schedule(jconfig.OptimizerConfig(
            warmup_steps=warmup, total_steps=total))
        sched = make_lr_schedule(cfg)
        for count in (0, 1, warmup, warmup + 1, total):
            assert sched(count) == float(jsched(jnp.int32(count))), \
                (warmup, total, count)
    assert make_lr_schedule(tconfig.OptimizerConfig(warmup_steps=2))(0) == 0


@pytest.mark.parametrize("name", ["scan_wconv", "flagship_tiny",
                                  "plain_untied"])
def test_wd_mask_equals_jax(name):
    _, tcfg, params, model, _, _ = _setup(name)
    jmask = jax.tree.map(lambda b: np.float32(b),
                         jax_wd_mask(params))
    want = {n: bool(p.item() if p.numel() == 1 else p.flatten()[0])
            for n, p in params_from_jax(
                jax.tree.map(lambda m, leaf: np.full(leaf.shape, m),
                             jmask, params), tcfg).named_parameters()}
    got = default_wd_mask(model)
    assert got == want
    assert not got["transformer.final_norm.scale"]
    assert got["token_emb"]


def test_configs_and_data_copies_equal_jax():
    for field in ("learning_rate", "warmup_steps", "total_steps", "beta1",
                  "beta2", "eps", "weight_decay", "max_grad_norm",
                  "clamp_value", "state_bits", "block_size",
                  "min_8bit_size"):
        assert getattr(tconfig.OptimizerConfig(), field) == \
            getattr(jconfig.OptimizerConfig(), field), field
    jcfg, tcfg = _configs("flagship_tiny")
    a, b = JaxSyntheticCodes(jcfg, 16, seed=3), SyntheticCodes(tcfg, 16,
                                                                seed=3)
    np.testing.assert_array_equal(a.text, b.text)
    np.testing.assert_array_equal(a.image, b.image)
    for x, y in zip(a.batches(4, seed=5, loop=False),
                    b.batches(4, seed=5, loop=False)):
        for key in ("text", "image"):
            np.testing.assert_array_equal(x[key], y[key])


def test_unported_options_raise():
    # state_bits=8, the default, is the 8-bit LAMB (tests/test_torch_quant.py)
    assert isinstance(make_optimizer(tconfig.OptimizerConfig()), Lamb8bit)
    assert isinstance(make_optimizer(tconfig.OptimizerConfig(state_bits=32)),
                      Lamb)
    with pytest.raises(ValueError, match="state_bits"):
        make_optimizer(tconfig.OptimizerConfig(state_bits=16))
    # remat_policy="save_ctx" trains since it was ported
    # (tests/test_torch_save_ctx.py); an unknown policy is refused
    with pytest.raises(ValueError, match="remat_policy"):
        _setup("flagship_tiny", remat_policy="save_all")


def _count_wrappers(monkeypatch):
    import dalle_tpu_torch.ops.attention as tatt
    import dalle_tpu_torch.ops.geglu as tgeglu
    import dalle_tpu_torch.ops.layer_norm as tln

    calls = dict.fromkeys(LAUNCHES, 0)
    for mod, names in ((tln, ("layer_norm", "layer_norm_bwd")),
                       (tgeglu, ("geglu_ff", "geglu_ff_bwd")),
                       (tatt, ("line_attention", "line_attention_bwd",
                               "window_attention", "window_attention_bwd"))):
        for name in names:
            def counting(*a, _name=name, _fn=getattr(mod, name), **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counting)
    return calls


@pytest.mark.parametrize("policy", ["save_attn", None, "save_ctx"])
def test_training_routes_through_every_wrapper(policy, monkeypatch):
    """One micro-batch with grad on flagship_tiny calls the eight wrappers
    as often as the schedule and the remat set say (forward, the replays
    of the rematerialised blocks, backward); on the CPU no kernel
    launches. Under ``no_grad`` no block is checkpointed."""
    _, tcfg, _, model, text, image = _setup("flagship_tiny",
                                            remat_policy=policy)
    _, tb = _batches(text, image)
    calls = _count_wrappers(monkeypatch)
    reset_launches()
    grad_step(model, tb)
    assert calls == wrapper_calls(tcfg, training=True)
    assert calls["layer_norm"] > calls["layer_norm_bwd"]   # the replays
    assert all(v == 0 for v in LAUNCHES.values())

    def no_checkpoint(*a, **k):
        raise AssertionError("checkpoint under no_grad")

    monkeypatch.setattr(ttransformer, "checkpoint", no_checkpoint)
    for key in calls:
        calls[key] = 0
    with torch.no_grad():
        model(tb["text"], tb["image"])
    assert calls == wrapper_calls(tcfg, training=False) | dict.fromkeys(
        ("layer_norm_bwd", "line_attention_bwd", "window_attention_bwd",
         "geglu_ff_bwd"), 0)


def test_train_entry_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    from dalle_tpu_torch.entry import train_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_entry()
    step, (state, batch) = train_entry(
        "cpu", micro=2, accum=2, state_bits=32, depth=6, dim=64, heads=4,
        head_dim=16, text_seq_len=16, image_grid=4, vocab_text=128,
        vocab_image=64, conv_kernel=3)
    assert batch["text"].shape == (4, 16)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert losses[1] == losses[0]          # count 0: learning rate 0
    assert losses[2] < losses[1]
