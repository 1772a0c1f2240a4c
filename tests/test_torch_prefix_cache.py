"""The port's prompt-prefix KV cache (``dalle_tpu_torch/serving/
prefix_cache.py`` and the engine's warm admission), as
``tests/test_prefix_cache.py`` holds the JAX package's.

The invariant: a WARM-admitted request (its prompt's text KV scattered
from the pool into its slot, decoding from ``pos = text_seq_len``) emits
EXACTLY the codes of the cold path, which equal ``generate_images`` for
the same seed: the text KV is a function of the prompt alone, and the
noise at an image position depends on (seed, position, index) alone.
Pinned through recycled slots, next to cold co-tenants, under mid-flight
eviction; a budget too small for one entry and a fingerprint collision
both degrade to the cold path, never to another prompt's prefix.
"""

import numpy as np
import pytest
import torch

from dalle_tpu.config import flagship_model_config as jax_flagship
from dalle_tpu.serving.prefix_cache import \
    prompt_fingerprint as jax_fingerprint
from dalle_tpu_torch.config import (ServingConfig, flagship_model_config,
                                    tiny_model_config)
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.models.decode import SamplingConfig, generate_images
from dalle_tpu_torch.serving import engine as engine_mod
from dalle_tpu_torch.serving import prefix_cache as pc
from dalle_tpu_torch.serving.engine import DecodeEngine
from dalle_tpu_torch.serving.prefix_cache import (PrefixCache,
                                                  extract_prefix,
                                                  prefix_entry_bytes,
                                                  prompt_fingerprint,
                                                  scatter_prefix,
                                                  stack_entries)
from dalle_tpu_torch.serving.scheduler import (SlotScheduler,
                                               kv_bytes_per_slot)

torch.set_num_threads(2)
SAM = SamplingConfig(temperature=1.0, top_k=8)
LAYOUTS = {
    "flat": dict(attn_types=("axial_row", "axial_col"), depth=2),
    "cycle": dict(attn_types=("axial_row", "axial_col", "axial_row",
                              "axial_row"), depth=6, shared_block_cycle=4,
                  final_conv_block=True, conv_kernel=3),
}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def setup(request):
    cfg = tiny_model_config(**LAYOUTS[request.param])
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def flat():
    cfg = tiny_model_config(**LAYOUTS["flat"])
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def _text(cfg, seed=100):
    return np.random.default_rng(seed).integers(2, cfg.vocab_text,
                                                cfg.text_seq_len)


def _solo(model, text, seed):
    return generate_images(model, torch.from_numpy(text[None]), [seed], SAM,
                           buckets=4)[0].numpy()


def _engine(cfg, model, n_slots=2, prefix_mb=8.0, **kw):
    return DecodeEngine(model, cfg, ServingConfig(
        n_slots=n_slots, steps_per_call=4, prefix_cache_mb=prefix_mb, **kw),
        sampling=SAM).start()


def test_warm_equals_cold_equals_solo(setup):
    cfg, model = setup
    text = _text(cfg)
    engine = _engine(cfg, model)
    try:
        rows = [engine.submit(text, 7 + i).result(timeout=120)
                for i in range(3)]
    finally:
        engine.stop()
    # the first request is the cold landing that pools the prefix; every
    # later one is warm, and all equal their solo codes
    assert [r["prefix_hit"] for r in rows] == [False, True, True]
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row["codes"], _solo(model, text, 7 + i))


def test_warm_equals_cold_bitwise_same_seed(flat):
    """The same request twice: the warm one's codes are the cold one's."""
    cfg, model = flat
    text = _text(cfg, 5)
    engine = _engine(cfg, model, n_slots=1)
    try:
        cold = engine.submit(text, 3).result(timeout=120)
        warm = engine.submit(text, 3).result(timeout=120)
    finally:
        engine.stop()
    assert (cold["prefix_hit"], warm["prefix_hit"]) == (False, True)
    np.testing.assert_array_equal(warm["codes"], cold["codes"])


def test_warm_parity_through_recycled_slots_and_cotenants(flat):
    """Repeated and distinct prompts ragged through two slots: warm
    admissions land in recycled slots next to cold co-tenants, and every
    request reproduces its solo codes."""
    cfg, model = flat
    a, b, c = _text(cfg, 100), _text(cfg, 101), _text(cfg, 102)
    trace = [a, b, a, c, a, b]
    engine = _engine(cfg, model)
    try:
        handles = [engine.submit(t, 40 + i) for i, t in enumerate(trace)]
        rows = [h.result(timeout=120) for h in handles]
    finally:
        engine.stop()
    for i, (row, t) in enumerate(zip(rows, trace)):
        np.testing.assert_array_equal(row["codes"], _solo(model, t, 40 + i))
    assert sum(r["prefix_hit"] for r in rows) >= 2


def test_eviction_mid_flight_keeps_parity(flat):
    """Evicting an entry while its warm request decodes drops only the
    pool's reference; the codes stay exact."""
    cfg, model = flat
    text = _text(cfg)
    engine = _engine(cfg, model)
    try:
        engine.submit(text, 11).result(timeout=120)
        h2 = engine.submit(text, 12)
        assert engine.prefix_cache.evict(prompt_fingerprint(text))
        r2 = h2.result(timeout=120)
        r3 = engine.submit(text, 13).result(timeout=120)
    finally:
        engine.stop()
    np.testing.assert_array_equal(r2["codes"], _solo(model, text, 12))
    np.testing.assert_array_equal(r3["codes"], _solo(model, text, 13))


def test_budget_full_falls_back_to_cold_path(flat):
    cfg, model = flat
    text = _text(cfg)
    engine = _engine(cfg, model, prefix_mb=1e-5)
    try:
        r1 = engine.submit(text, 21).result(timeout=120)
        r2 = engine.submit(text, 22).result(timeout=120)
        stats = engine.prefix_cache.stats()
    finally:
        engine.stop()
    assert r1["prefix_hit"] is False and r2["prefix_hit"] is False
    assert stats["entries"] == 0 and stats["refused"] >= 2
    np.testing.assert_array_equal(r2["codes"], _solo(model, text, 22))


def test_hash_collision_serves_a_miss_never_wrong_prefix(flat, monkeypatch):
    """Every prompt on one fingerprint: the second prompt is a miss (the
    stored tokens differ), and its codes stay exact."""
    cfg, model = flat
    monkeypatch.setattr(pc, "prompt_fingerprint", lambda tokens: "collide")
    monkeypatch.setattr(engine_mod, "prompt_fingerprint",
                        lambda tokens: "collide")
    ta, tb = _text(cfg, 100), _text(cfg, 101)
    engine = _engine(cfg, model)
    try:
        ra = engine.submit(ta, 31).result(timeout=120)
        rb = engine.submit(tb, 32).result(timeout=120)
        stats = engine.prefix_cache.stats()
    finally:
        engine.stop()
    assert ra["prefix_hit"] is False and rb["prefix_hit"] is False
    assert stats["collisions"] >= 1
    np.testing.assert_array_equal(rb["codes"], _solo(model, tb, 32))


def test_lru_eviction_and_token_check():
    entry = 1000
    pool = PrefixCache(entry, budget_bytes=2 * entry)
    kv = {"k": torch.zeros(1), "v": torch.zeros(1)}
    ta, tb, tc = (np.arange(4), np.arange(4, 8), np.arange(8, 12))
    assert pool.insert("a", ta, kv) and pool.insert("b", tb, kv)
    assert pool.lookup("a", ta) is not None      # refresh a
    assert pool.insert("c", tc, kv)              # evicts b, not a
    assert "a" in pool and "c" in pool and "b" not in pool
    assert pool.lookup("a", ta + 1) is None      # a collision is a miss
    stats = pool.stats()
    assert (stats["evictions"], stats["collisions"], stats["bytes"]) == \
        (1, 1, 2 * entry)


@pytest.mark.parametrize("tokens", [
    np.arange(16), np.zeros(256, np.int64), np.full(256, 32099),
    np.random.default_rng(0).integers(0, 32100, 256)])
def test_fingerprint_equals_jax(tokens):
    """The router keys prompt affinity on this string across engines of
    both packages."""
    assert prompt_fingerprint(tokens) == jax_fingerprint(tokens)
    assert prompt_fingerprint(torch.from_numpy(np.asarray(tokens)).numpy()) \
        == jax_fingerprint(np.asarray(tokens, np.int32))


def test_entry_bytes_and_budget_accounting():
    """A flagship entry is the text fraction of a slot: 67,108,864 B of
    335,544,320 in bf16; the pool's budget is reserved out of
    ``kv_budget_mb``."""
    cfg = flagship_model_config()
    assert prefix_entry_bytes(cfg) == 64 * 256 * 1024 * 2 * 2 == 67_108_864
    assert prefix_entry_bytes(cfg) * cfg.total_seq_len \
        == kv_bytes_per_slot(cfg) * cfg.text_seq_len
    assert jax_flagship().text_seq_len == cfg.text_seq_len
    per_slot = 2 ** 20
    assert SlotScheduler(8, per_slot, kv_budget_mb=4).max_live == 4
    assert SlotScheduler(8, per_slot, kv_budget_mb=4,
                         reserved_bytes=2 * per_slot).max_live == 2
    assert SlotScheduler(8, per_slot, kv_budget_mb=4,
                         reserved_bytes=10 ** 12).max_live == 1


def test_extract_scatter_round_trip(flat):
    """extract -> stack -> scatter writes exactly the text rows of the
    target slots and nothing else."""
    cfg, _ = flat
    g = torch.Generator().manual_seed(1)
    shape = (2, 3, cfg.total_seq_len, cfg.dim)
    cache = {n: torch.randn(shape, generator=g) for n in "kv"}
    before = {n: t.clone() for n, t in cache.items()}
    tl = cfg.text_seq_len
    e0, e1 = (extract_prefix(cache, s, tl) for s in (0, 1))
    assert e0["k"].shape == (2, tl, cfg.dim)
    scatter_prefix(cache, torch.tensor([2, 0]), stack_entries([e0, e1]), tl)
    for n in "kv":
        assert torch.equal(cache[n][:, 2, :tl], before[n][:, 0, :tl])
        assert torch.equal(cache[n][:, 0, :tl], before[n][:, 1, :tl])
        assert torch.equal(cache[n][:, :, tl:], before[n][:, :, tl:])
        assert torch.equal(cache[n][:, 1], before[n][:, 1])


def test_prefix_counters_ride_readiness_and_stats(flat):
    cfg, model = flat
    text = _text(cfg)
    engine = _engine(cfg, model)
    try:
        engine.submit(text, 0).result(timeout=120)
        engine.submit(text, 1).result(timeout=120)
        ready, snap = engine.readiness(), engine.stats()
    finally:
        engine.stop()
    assert (ready["prefix_hits"], ready["prefix_misses"]) == (1, 1)
    assert snap["prefix_cache"]["entries"] == 1


def test_no_pool_means_no_verdict(flat):
    cfg, model = flat
    engine = DecodeEngine(model, cfg, ServingConfig(n_slots=1,
                                                    steps_per_call=4),
                          sampling=SAM).start()
    try:
        row = engine.submit(_text(cfg), 0).result(timeout=120)
    finally:
        engine.stop()
    assert "prefix_hit" not in row and engine.prefix_cache is None
