"""The port's inference slice as a whole against the JAX package: the
forward loss and logits, the cached ``decode_step`` logits, greedy
generation and the sampling filters, on converted weights.

The JAX side runs its Pallas kernels in interpret mode
(``models.attention._PALLAS_INTERPRET``); at these widths the LayerNorm and
GEGLU kernels' shape gates send JAX to its plain lowerings, which
tests/test_torch_ops.py holds the port's versions against. Tolerance 2e-4
(f32), as the JAX package's own decode-vs-forward test uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.models import attention as jattention
from dalle_tpu.models import decode as jdecode
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.models import decode as tdecode
from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.params import params_from_jax

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)

FLAGSHIP_TINY = dict(depth=10, dim=64, heads=4, head_dim=16, text_seq_len=16,
                     image_grid=4, vocab_text=128, vocab_image=64,
                     conv_kernel=3, dtype="float32", head_chunk=48)

# the zoo configs of tests/test_decode.py, with the kernels' routing on
# ("plain_untied": flax's nn.LayerNorm, the unfused FF and an untied head)
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


def _configs(name):
    """(jax cfg, port cfg) built from the same keyword arguments."""
    if name == "flagship_tiny":
        return (jconfig.flagship_model_config(**FLAGSHIP_TINY),
                tconfig.flagship_model_config(**FLAGSHIP_TINY))
    kw = dict(ZOO[name], ln_fusion=True, ff_fusion="all")
    if name == "plain_untied":
        kw.update(ln_fusion=False, ff_fusion="none")
    return jconfig.tiny_model_config(**kw), tconfig.tiny_model_config(**kw)


def _setup(name, seed=0):
    jcfg, tcfg = _configs(name)
    params = jax.tree.map(np.asarray,
                          jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    # nonzero biases: a dropped bias add must show
    def noise(path, leaf):
        if path[-1].key == "bias":
            return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(noise, params)
    text = rng.integers(2, jcfg.vocab_text, (2, jcfg.text_seq_len))
    image = rng.integers(0, jcfg.vocab_image, (2, jcfg.image_seq_len))
    model = params_from_jax(params, tcfg).eval()
    return jcfg, tcfg, params, model, text, image


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattention, "_PALLAS_INTERPRET", True)


@pytest.mark.parametrize("name", ["full", "axial", "scan_wconv",
                                  "flagship_tiny", "plain_untied"])
def test_forward_matches_jax(name, pallas_interpret):
    jcfg, tcfg, params, model, text, image = _setup(name)
    jm = JaxDALLE(jcfg)
    jt, ji = jnp.asarray(text, jnp.int32), jnp.asarray(image, jnp.int32)
    loss_j, aux_j = jm.apply(params, jt, ji)
    loss_lj, _, logits_j = jm.apply(params, jt, ji, return_logits=True)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    with torch.no_grad():
        loss_t, aux_t = model(tt, ti)
        loss_lt, _, logits_t = model(tt, ti, return_logits=True)
    for key in ("loss", "loss_text", "loss_img"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]),
                                   **TOL)
    np.testing.assert_allclose(float(loss_lt), float(loss_lj), **TOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)


def test_flagship_tiny_routes_like_the_flagship(monkeypatch):
    """The flagship routing at tiny width: every LayerNorm through the
    LayerNorm wrapper, the fused FF only on the un-rematted block_3, the
    line wrapper on the text half of every layer and the image half of
    the axial ones, the window wrapper on w_conv."""
    import dalle_tpu_torch.ops.attention as tatt
    import dalle_tpu_torch.ops.geglu as tgeglu
    import dalle_tpu_torch.ops.layer_norm as tln

    _, tcfg, _, model, text, image = _setup("flagship_tiny")
    fused = {name for name, blk in model.transformer.blocks.items()
             if blk.ff.fuse}
    assert fused == {"block_3"}
    calls = dict.fromkeys(LAUNCHES, 0)

    def counting(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    # the autograd Functions call the wrappers by their module's name
    for mod, name in ((tln, "layer_norm"), (tgeglu, "geglu_ff"),
                      (tatt, "line_attention"), (tatt, "window_attention"),
                      (tln, "layer_norm_bwd"), (tgeglu, "geglu_ff_bwd"),
                      (tatt, "line_attention_bwd"),
                      (tatt, "window_attention_bwd")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    reset_launches()
    with torch.no_grad():
        model(torch.from_numpy(text), torch.from_numpy(image))
    depth = tcfg.depth
    n_block3 = sum(1 for uid, _ in tcfg.layer_schedule() if uid == 3)
    assert calls == {"layer_norm": 2 * depth + 1,
                     "line_attention": 2 * (depth - 1) + 1,
                     "window_attention": 1, "geglu_ff": n_block3,
                     "layer_norm_bwd": 0, "line_attention_bwd": 0,
                     "window_attention_bwd": 0, "geglu_ff_bwd": 0,
                     "quantize_blockwise": 0, "wire_quantize_u8": 0,
                     "wire_quantize_u4": 0}
    # on the CPU every wrapper took its plain version: no kernel launched
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("name", ["axial", "scan_wconv", "plain_untied"])
def test_decode_step_matches_jax_and_own_forward(name):
    jcfg, tcfg, params, model, text, image = _setup(name, seed=1)
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
    np.testing.assert_allclose(got_t, np.stack(got_j, 1), **TOL)
    # teacher-forced cached decode reproduces the port's own forward
    with torch.no_grad():
        _, _, logits = model(torch.from_numpy(text), torch.from_numpy(image),
                             return_logits=True)
    np.testing.assert_allclose(got_t, logits.numpy(), **TOL)


@pytest.mark.parametrize("name", ["full", "scan_wconv"])
def test_greedy_codes_equal_jax(name):
    jcfg, tcfg, params, model, text, _ = _setup(name, seed=2)
    want = np.asarray(jdecode.generate_images(
        params, jcfg, jnp.asarray(text, jnp.int32), jax.random.PRNGKey(0),
        jdecode.SamplingConfig(temperature=0.0)))
    got = tdecode.generate_images(
        model, torch.from_numpy(text), [0, 1],
        tdecode.SamplingConfig(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("knobs", [dict(top_k=5), dict(top_p=0.6),
                                   dict(top_k=12, top_p=0.8,
                                        temperature=0.7)])
def test_sampled_ids_lie_in_the_jax_support(knobs, monkeypatch):
    """Every id the port samples is one the JAX filter keeps: the JAX
    sampler's filtered logits are read at its categorical draw."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    cfg = jdecode.SamplingConfig(**{"temperature": 1.0, **knobs})
    seen = {}

    def capture(key, x):
        seen["x"] = np.asarray(x)
        return jnp.argmax(x, axis=-1)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jdecode.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits), cfg)
    support = seen["x"] > jdecode.NEG_INF / 2
    assert 0 < support.sum() < support.size
    tcfg = tdecode.SamplingConfig(**cfg._asdict())
    hits = np.zeros_like(support)
    seeds = torch.arange(4)
    for pos in range(200):
        ids = tdecode.sample_logits(torch.from_numpy(logits), tcfg,
                                    tdecode.gumbel_noise(seeds, pos, 64))
        hits[np.arange(4), ids.numpy()] = True
    assert not (hits & ~support).any()
    assert hits.sum() > 4   # it samples, not argmax


def test_entry_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(device="cuda")
    assert resolve_device("cpu").type == "cpu"
