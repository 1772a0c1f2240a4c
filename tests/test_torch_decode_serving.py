"""The port's per-slot decode against the JAX package: ``decode_step``
with a (B,) position tensor (``dalle_tpu/models/decode.py``'s vector-pos
branch), the tensor-knob sampler against ``sample_logits`` and
``_sample_logits_traced`` on the same noise, and the counter-based per-row
draw (``gumbel_noise``) that replaces the JAX package's threefry chains.

Tolerance 1e-5 on f32 logits and cache rows (the tiny configs run in f32);
sampled ids are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.models import decode as jdecode
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.models import decode as tdecode
from dalle_tpu_torch.params import params_from_jax

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)

# a flat cache layout and the cycle layout with the final conv block (the
# flagship's), as tests/test_serving.py runs them
LAYOUTS = {
    "flat": dict(attn_types=("axial_row", "axial_col"), depth=2),
    "cycle": dict(attn_types=("axial_row", "axial_col", "axial_row",
                              "axial_row"), depth=6, shared_block_cycle=4,
                  final_conv_block=True, conv_kernel=3),
}


def _setup(name):
    kw = LAYOUTS[name]
    jcfg, tcfg = jconfig.tiny_model_config(**kw), \
        tconfig.tiny_model_config(**kw)
    params = jax.tree.map(np.asarray,
                          jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    # nonzero biases: a dropped bias add must show
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf + 0.05 * rng.standard_normal(
            leaf.shape).astype(leaf.dtype) if path[-1].key == "bias"
        else leaf, params)
    return jcfg, tcfg, params, params_from_jax(params, tcfg)


def _jax_cache_rows(cache, cfg):
    """The JAX cache as the port's (n_layers, B, T, H*d) k and v: the
    cycle layout's body slots in schedule order (its overhang slots
    dropped), then the conv slot."""
    if "k" in cache:
        return np.asarray(cache["k"]), np.asarray(cache["v"])
    n_body = len(cfg.layer_schedule()) - 1
    out = []
    for n in ("k", "v"):
        body = np.asarray(cache[f"{n}_body"])
        body = body.reshape((-1,) + body.shape[2:])[:n_body]
        out.append(np.concatenate([body, np.asarray(cache[f"{n}_conv"])[
            None]], 0))
    return tuple(out)


@pytest.mark.parametrize("visible", [None, "bucket"])
@pytest.mark.parametrize("name", ["flat", "cycle"])
def test_vector_pos_decode_step_matches_jax(name, visible):
    """Three rows at three different positions (offsets 0, 5, 11) walk
    their teacher-forced sequences through the per-slot step; rows past
    the end clamp to the last position, as the engine's free slots do.
    Logits at every step and the final cache rows within 1e-5 of the JAX
    package's vector-pos ``decode_step``."""
    jcfg, tcfg, params, model = _setup(name)
    total = jcfg.total_seq_len
    rng = np.random.default_rng(1)
    b = 3
    labels = np.concatenate([
        rng.integers(2, jcfg.vocab_text, (b, jcfg.text_seq_len)),
        rng.integers(0, jcfg.vocab_image, (b, jcfg.image_seq_len))
        + jcfg.vocab_text], 1)
    inputs = np.concatenate([np.full((b, 1), jcfg.vocab_total),
                             labels[:, :-1]], 1)
    offsets = np.array([0, 5, 11])
    jstep = jax.jit(lambda c, ids, p, vis: jdecode.decode_step(
        params, jcfg, c, ids, p, visible=vis), static_argnums=3)
    jcache = jdecode.init_cache(jcfg, b)
    tcache = tdecode.init_cache(tcfg, b, "cpu")
    tables = tdecode.decode_tables(tcfg, "cpu")
    bounds = jdecode.bucket_bounds(total, 4)
    for step in range(total - offsets.min() - 4):
        pos = np.minimum(step + offsets, total - 1)
        vis = (None if visible is None
               else next(h for h in bounds if h > pos.max()))
        ids = inputs[np.arange(b), pos]
        lj, jcache = jstep(jcache, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(pos, jnp.int32), vis)
        lt, tcache = tdecode.decode_step(
            model, tcache, torch.from_numpy(ids), torch.from_numpy(pos),
            tables, visible=vis)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    jk, jv = _jax_cache_rows(jcache, jcfg)
    np.testing.assert_allclose(tcache["k"].numpy(), jk, **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), jv, **TOL)


def test_vector_pos_equals_scalar_pos_bitwise():
    """With every row at one position, the vector branch gives the scalar
    branch's bits (the lockstep ``generate_images`` and the engine run the
    same arithmetic)."""
    _, tcfg, _, model = _setup("cycle")
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(
        rng.integers(0, tcfg.vocab_total, (2, tcfg.total_seq_len)))
    caches = [tdecode.init_cache(tcfg, 2, "cpu") for _ in range(2)]
    tables = tdecode.decode_tables(tcfg, "cpu")
    bounds = tdecode.bucket_bounds(tcfg.total_seq_len, 4)
    for p in range(tcfg.total_seq_len):
        vis = next(h for h in bounds if h > p)
        ls, _ = tdecode.decode_step(model, caches[0], ids[:, p], p, tables,
                                    visible=vis)
        lv, _ = tdecode.decode_step(model, caches[1], ids[:, p],
                                    torch.full((2,), p), tables,
                                    visible=vis)
        assert torch.equal(ls, lv), p
    assert all(torch.equal(caches[0][n], caches[1][n]) for n in "kv")


# (temperature, top_k, top_p) per row: one batch mixes greedy, plain,
# top-k, top-p and both
ROWS = [(1.0, 0, 1.0), (0.0, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.6),
        (1.0, 12, 0.8), (0.7, 12, 0.8), (0.0, 3, 0.5)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tensor_knob_sampling_matches_jax_on_the_same_noise(seed,
                                                            monkeypatch):
    """The port's one sampler with (B,) knob tensors picks, row by row,
    the id JAX's ``_sample_logits_traced`` picks with the same knobs when
    its categorical draw is the port's Gumbel noise; and the id of JAX's
    static-knob ``sample_logits`` where the temperature is 0 or 1 (a
    static 0.7 is a literal divisor XLA may fold into a multiply)."""
    rng = np.random.default_rng(seed)
    b, v = len(ROWS), 96
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[:, :16] = jdecode.NEG_INF          # a masked segment
    seeds = torch.arange(b) * 7919 + seed
    noise = tdecode.gumbel_noise(seeds, 40 + seed, v)
    temp, top_k, top_p = (list(c) for c in zip(*ROWS))
    got = tdecode.sample_logits(
        torch.from_numpy(logits),
        tdecode.SamplingConfig(torch.tensor(temp), torch.tensor(top_k),
                               torch.tensor(top_p)), noise).numpy()
    row_noise = {}
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, x: jnp.argmax(x + row_noise["n"],
                                                  axis=-1))
    for i, (t, k, p) in enumerate(ROWS):
        row_noise["n"] = jnp.asarray(noise[i:i + 1].numpy())
        row = jnp.asarray(logits[i:i + 1])
        want = int(jdecode._sample_logits_traced(
            jax.random.PRNGKey(0), row, jnp.float32(t), jnp.int32(k),
            jnp.float32(p))[0])
        assert got[i] == want, (i, ROWS[i])
        if t in (0.0, 1.0):
            static = jdecode.sample_logits(jax.random.PRNGKey(0), row,
                                           jdecode.SamplingConfig(t, k, p))
            assert got[i] == int(static[0]), (i, ROWS[i])
    # greedy rows are argmax of the raw logits
    for i in (1, 6):
        assert got[i] == logits[i].argmax()


def test_scalar_knobs_equal_tensor_knobs():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy((rng.standard_normal((4, 50)) * 2).astype(
        np.float32))
    noise = tdecode.gumbel_noise(torch.arange(4), 9, 50)
    for t, k, p in ROWS:
        one = tdecode.sample_logits(logits, tdecode.SamplingConfig(t, k, p),
                                    noise)
        many = tdecode.sample_logits(logits, tdecode.SamplingConfig(
            torch.full((4,), t), torch.full((4,), k), torch.full((4,), p)),
            noise)
        assert torch.equal(one, many)


def test_gumbel_noise_is_a_function_of_seed_position_and_index():
    """Row i's noise depends on (seeds[i], pos[i], v) only: the same for
    the row alone, in any batch and in any order; it changes with each of
    the three; its uniforms lie strictly inside (0, 1) with mean ~1/2."""
    seeds = torch.tensor([0, 5, -3, 2 ** 62 + 11])
    pos = torch.tensor([0, 17, 17, 1279])
    v = 4099
    batch = tdecode.gumbel_noise(seeds, pos, v)
    for i in range(4):
        alone = tdecode.gumbel_noise(seeds[i:i + 1], int(pos[i]), v)
        assert torch.equal(alone[0], batch[i])
    perm = torch.tensor([3, 1, 0, 2])
    assert torch.equal(tdecode.gumbel_noise(seeds[perm], pos[perm], v),
                       batch[perm])
    assert not torch.equal(batch[1], batch[2])     # seed
    assert not torch.equal(tdecode.gumbel_noise(seeds, pos + 1, v), batch)
    assert not torch.equal(batch[0, :v // 2], batch[0, v // 2:v // 2 * 2])
    u = torch.exp(-torch.exp(-batch.double()))
    assert bool(((u > 0) & (u < 1)).all())
    assert abs(u.mean().item() - 0.5) < 0.01
    assert torch.isfinite(batch).all()


def test_uniform_grid_edges_stay_inside_the_unit_interval():
    """The extreme hashes map strictly inside (0, 1), so no Gumbel value is
    infinite: an infinite one would outrank the segment mask's -1e9 and
    let a text id win at an image position."""
    bits = torch.tensor([0, 1, 511, 512, 2 ** 31, 2 ** 32 - 513,
                         2 ** 32 - 512, 2 ** 32 - 1])
    u = tdecode.uniform_from_bits(bits)
    assert bool(((u > 0) & (u < 1)).all())
    assert u[-1].item() == 1 - 2.0 ** -24 and u[0].item() == 2.0 ** -24
    g = -torch.log(-torch.log(u))
    assert torch.isfinite(g).all() and g.abs().max() < 20
    # masked ids never win, whatever the noise
    logits = torch.full((1, len(bits)), tdecode.NEG_INF)
    logits[0, 3] = -50.0
    noisy = tdecode.sample_logits(logits, tdecode.SamplingConfig(1.0, 0, 1.0),
                                  g[None])
    assert noisy.item() == 3


def test_generate_images_rows_do_not_depend_on_the_batch():
    """A row's codes are those of its own one-row run with the same seed,
    whatever the other rows are and wherever it sits in the batch."""
    _, tcfg, _, model = _setup("flat")
    rng = np.random.default_rng(4)
    text = torch.from_numpy(rng.integers(2, tcfg.vocab_text,
                                         (3, tcfg.text_seq_len)))
    sam = tdecode.SamplingConfig(1.0, 8, 1.0)
    seeds = [11, 12, 13]
    both = tdecode.generate_images(model, text, seeds, sam, buckets=4)
    for i in range(3):
        solo = tdecode.generate_images(model, text[i:i + 1], seeds[i:i + 1],
                                       sam, buckets=4)
        assert torch.equal(solo[0], both[i])
    rev = tdecode.generate_images(model, text.flip(0), seeds[::-1], sam,
                                  buckets=4)
    assert torch.equal(rev.flip(0), both)
    assert int(((both >= 0) & (both < tcfg.vocab_image)).all())


def test_bucket_helpers_match_jax():
    for total, n in [(1280, 4), (1280, 2), (32, 4), (7, 3), (5, 9), (5, 0)]:
        assert tdecode.bucket_bounds(total, n) == \
            jdecode.bucket_bounds(total, n)
    for buckets, batch in [(None, 1), (None, 8), (None, 12), (3, 4)]:
        assert tdecode.resolve_buckets(buckets, batch) == \
            jdecode.resolve_buckets(buckets, batch)
