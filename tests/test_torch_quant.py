"""The port's block-wise quantizer and 8-bit LAMB against the JAX package
(dalle_tpu_torch/ops/quant.py, dalle_tpu_torch/optim/lamb8bit.py).

The JAX side's Pallas kernel runs in interpret mode, as tests/test_quant.py
runs it, on at most three quant blocks; its XLA path and the 8-bit LAMB run
op by op (no jit: inside one XLA program the CPU backend may contract
``b1 * m + (1 - b1) * g`` into a fused multiply-add, one rounding where the
port takes two).

Tolerances: codes and absmax exactly (byte equality). With the same
gradients and the global clip off, the 8-bit LAMB's codes are identical
over three updates. With the clip on, the two frameworks sum the global
norm in another order, so the clip scale may differ in its last bit; the
codes then agree on all but a small share of elements (measured: all
equal at this size, limit 0.1%), each within one code. Parameters within
1e-6 of the leaf's largest magnitude (the trust ratio's norms are sums in
another order); dense moments exactly without the clip, within 1e-6 of
the leaf's largest magnitude with it. The 8-bit training path against
``dalle_tpu.training.steps``: losses 2e-4 relative and dense moments within
2e-4 of the leaf's largest magnitude, as tests/test_torch_train.py holds
gradients; the gradients differ in their last bits, so the moments' codes
agree on all but 0.1% of elements, each within one code. After the second
(first nonzero) update, each parameter is within 1e-3 of the leaf's
largest update except on at most 0.1% of its elements, those whose moment
code flipped, which stay within half of it (measured: at most 0.037% of a
leaf's elements, 0.127 of its largest update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu.ops import quant as jquant
from dalle_tpu.ops.pallas.quant_kernels import quantize_blockwise_pallas
from dalle_tpu.optim.lamb8bit import make_optimizer_8bit as jax_lamb8bit
from dalle_tpu.optim.lamb8bit import \
    optimizer_state_bytes as jax_state_bytes
from dalle_tpu.training import steps as jsteps
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.ops import quant as tquant
from dalle_tpu_torch.optim import (Lamb8bit, apply_updates, make_optimizer,
                                   optimizer_state_bytes)
from dalle_tpu_torch.params import (opt_state_from_jax, params_from_jax,
                                    params_to_jax)

torch.set_num_threads(2)
MOMENT_FLIPS = 1e-3   # share of codes allowed to differ by one (see above)
UPDATE_TOL = 1e-3     # 8-bit training path: parameter gap / largest update
FLIPPED_STEP = 0.5    # ... where a moment's code flipped


@pytest.mark.parametrize("signed", [True, False])
def test_codebook_and_midpoints_equal_jax(signed):
    assert (tquant.dynamic_codebook(signed).tobytes()
            == jquant.dynamic_codebook(signed).tobytes())
    assert (tquant.codebook_midpoints(signed).tobytes()
            == jquant.codebook_midpoints(signed).tobytes())
    assert tquant.codebook_midpoints(signed).dtype == np.float32


def _tie_block(signed, block=4096, seed=0):
    """A block whose absmax is 2.0 and whose other values are codebook
    midpoints times 2 (exact), so ``x / absmax`` lands on every midpoint: a
    tie takes the lower code. The rest random."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, block).astype(np.float32)
    if not signed:
        x = np.abs(x)
    mids = tquant.codebook_midpoints(signed)
    x[:mids.size] = mids * np.float32(2.0)
    x[mids.size] = 2.0
    return x


def _cases(signed):
    """Three quant blocks of 4096: midpoint ties; a zero block with -0.0;
    a ragged tail of 1000 values."""
    rng = np.random.default_rng(1)
    zero = np.zeros(4096, np.float32)
    zero[::7] = -0.0
    tail = rng.standard_normal(1000).astype(np.float32) * 3
    if not signed:
        tail = np.abs(tail)
    return np.concatenate([_tie_block(signed), zero, tail])


def _nonfinite(signed):
    """Blocks of 128 with +inf, NaN, -inf and -0.0 in them (+-inf over an
    infinite absmax gives a NaN ``x / absmax``), and a finite block."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    x[0, 3] = np.inf
    x[1, 5] = np.nan
    x[2, 7] = -np.inf if signed else np.inf
    x[2, 8] = -0.0
    return x.reshape(-1)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("case", ["ties_zeros_tail", "nonfinite"])
def test_plain_quantize_matches_jax_xla_and_pallas(signed, case):
    x = _cases(signed) if case == "ties_zeros_tail" else _nonfinite(signed)
    block = 4096 if case == "ties_zeros_tail" else 128
    got = tquant.quantize_blockwise(torch.from_numpy(x), block, signed=signed)
    assert got.codes.dtype == torch.uint8 and got.absmax.dtype == torch.float32
    assert got.shape == x.shape
    assert got.absmax.shape == (-(-x.size // block), 1)
    codes, absmax = got.codes.numpy(), got.absmax.numpy()
    pal_codes, pal_absmax = quantize_blockwise_pallas(
        jnp.asarray(x), block, signed=signed, interpret=True)
    xla = jquant.quantize_blockwise(jnp.asarray(x), block, signed=signed,
                                    use_pallas=False)
    np.testing.assert_array_equal(codes, np.asarray(pal_codes))
    np.testing.assert_array_equal(absmax, np.asarray(pal_absmax))
    np.testing.assert_array_equal(absmax, np.asarray(xla.absmax))
    # the JAX package's XLA path sorts a NaN x/absmax last (code 255) where
    # its kernel counts 0; everywhere else the three agree
    normed = tquant.to_blocks(torch.from_numpy(x), block) / torch.where(
        got.absmax > 0, got.absmax, torch.ones_like(got.absmax))
    nan = torch.isnan(normed).numpy()
    assert nan.any() == (case == "nonfinite")
    np.testing.assert_array_equal(codes[~nan], np.asarray(xla.codes)[~nan])
    assert (codes[nan] == 0).all()
    assert (np.asarray(xla.codes)[nan] == 255).all()
    if case == "ties_zeros_tail":
        mids = tquant.codebook_midpoints(signed)
        # a value on midpoint k takes code k (the lower of its two entries)
        np.testing.assert_array_equal(codes[0, :mids.size],
                                      np.arange(mids.size))
        assert absmax[1, 0] == 0.0


def test_dequantize_equals_jax_and_block_checks():
    for signed in (True, False):
        x = _cases(signed)
        q = tquant.quantize_blockwise(torch.from_numpy(x), signed=signed)
        jq = jquant.quantize_blockwise(jnp.asarray(x), signed=signed,
                                       use_pallas=False)
        got = tquant.dequantize_blockwise(q)
        want = jquant.dequantize_blockwise(jq, use_tree=False)
        assert got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="at least 1"):
        tquant.quantize_blockwise(torch.zeros(10), block_size=0)
    empty = tquant.quantize_blockwise(torch.zeros(0))
    assert empty.codes.shape == (0, 4096) and empty.absmax.shape == (0, 1)



# -- the kernel's bucketed codebook lookup -----------------------------------


def _bucket_lookup(v, table, lo):
    """The CUDA kernel's lookup (``code_of`` in csrc/quant.cu), in numpy:
    the bucket of |v|'s bits clamped to the table, the row of v's sign bit,
    base plus one compare with the real midpoint; NaN takes 0."""
    nb = table.shape[1]
    bits = v.view(np.uint32)
    raw = (bits & 0x7FFFFFFF) >> tquant.BUCKET_SHIFT
    b = np.clip(raw.astype(np.int64) - lo, 0, nb - 1)
    entry = table[(bits >> 31).astype(np.int64), b]
    code = entry[:, 1].astype(np.int64) + (entry[:, 0].view(np.float32) < v)
    return np.where(np.isnan(v), 0, code)


def _search(v, mids):
    """The plain answer: midpoints strictly below v; NaN takes 0."""
    return np.where(np.isnan(v), 0, np.searchsorted(mids, v, side="left"))


@pytest.mark.parametrize("signed", [True, False])
def test_bucket_table_holds_one_midpoint_a_bucket(signed):
    """Every midpoint sits in the bucket its entry names, and no bucket
    holds more midpoints of one sign than the kernel compares (one)."""
    table, lo = tquant.bucket_table(signed)
    mids = tquant.codebook_midpoints(signed)
    nb = table.shape[1]
    assert table.shape == (2, nb, 2) and table.dtype == np.uint32
    assert table.nbytes <= 48 * 1024          # the kernel's shared memory
    held = table[:, :, 0].view(np.float32)
    for row, sign in ((0, mids > 0), (1, mids < 0)):
        stored = held[row][np.isfinite(held[row])]
        np.testing.assert_array_equal(np.sort(stored), mids[sign])
        bucket = (np.abs(mids[sign]).view(np.uint32)
                  >> tquant.BUCKET_SHIFT).astype(np.int64) - lo
        assert ((bucket >= 0) & (bucket < nb)).all()
        assert np.bincount(bucket, minlength=1).max() <= 1
        np.testing.assert_array_equal(held[row][bucket], mids[sign])
    assert not (held == -np.inf).any()
    assert nb == (1342 if signed else 1558)
    # |v| <= 1 never needs the upper clamp: 1.0 is in the last bucket
    top = np.float32(1.0).view(np.uint32) >> tquant.BUCKET_SHIFT
    assert top - lo == nb - 1


@pytest.mark.parametrize("signed", [True, False])
def test_bucket_lookup_equals_searchsorted(signed):
    """The kernel's lookup, emulated from the table ``ops/quant.py``
    builds, against ``searchsorted`` (left) on every 64th float32 bit
    pattern in [-1, 1], every midpoint and its two neighbours, and the
    edges: +-0.0, +-inf, NaN, subnormals, +-1 and magnitudes past 1 (a NaN
    in a block leaves its scale at 1)."""
    table, lo = tquant.bucket_table(signed)
    mids = tquant.codebook_midpoints(signed)
    one = int(np.float32(1.0).view(np.uint32))
    for sign in (0, 0x80000000):
        for start in range(0, one + 1, 1 << 25):
            bits = np.arange(start, min(start + (1 << 25), one + 1), 64,
                             dtype=np.uint32) | np.uint32(sign)
            v = bits.view(np.float32)
            np.testing.assert_array_equal(_bucket_lookup(v, table, lo),
                                          _search(v, mids))
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, tiny,
                      -tiny, tiny * 1000, -tiny * 1000,
                      np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                      1.5, -1.5, 3e38, -3e38], np.float32)
    near = np.concatenate([mids, np.nextafter(mids, np.float32(np.inf)),
                           np.nextafter(mids, np.float32(-np.inf)), edges])
    got = _bucket_lookup(near, table, lo)
    np.testing.assert_array_equal(got, _search(near, mids))
    # on a midpoint: the lower code; just above: the next
    k = np.arange(mids.size)
    np.testing.assert_array_equal(got[:mids.size], k)
    np.testing.assert_array_equal(got[mids.size:2 * mids.size], k + 1)
    assert _bucket_lookup(np.array([np.nan], np.float32), table, lo)[0] == 0
    zero_code = int(np.searchsorted(mids, 0.0))
    np.testing.assert_array_equal(
        _bucket_lookup(np.array([0.0, -0.0, tiny], np.float32), table, lo),
        zero_code)
    assert _bucket_lookup(np.array([np.inf, -np.inf], np.float32), table,
                          lo).tolist() == [255, 0]


@pytest.mark.parametrize("block", [1, 100, 127, 4097, 32768])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_blockwise_any_block_size_matches_jax(block, signed):
    """Block sizes that are not multiples of 128 (the JAX package computes
    them through its XLA path): codes and absmax equal, ragged tails
    included."""
    rng = np.random.default_rng(block)
    n = 2 * 32768 + 1001
    x = (rng.standard_normal(n) * rng.choice([1e-6, 1.0, 100.0], n)
         ).astype(np.float32)
    x[::11] = 0.0
    if not signed:
        x = np.abs(x)
    got = tquant.quantize_blockwise(torch.from_numpy(x), block, signed=signed)
    want = jquant.quantize_blockwise(jnp.asarray(x), block, signed=signed,
                                     use_pallas=False)
    assert got.codes.shape == (-(-n // block), block)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.absmax.numpy(),
                                  np.asarray(want.absmax))
    np.testing.assert_array_equal(
        tquant.dequantize_blockwise(got).numpy(),
        np.asarray(jquant.dequantize_blockwise(want, use_tree=False)))

# -- the 8-bit LAMB ----------------------------------------------------------

TINY = dict(attn_types=("axial_row", "axial_col"), depth=2)
OPT = dict(state_bits=8, warmup_steps=1, total_steps=10, min_8bit_size=4096,
           block_size=1536)


def _tiny():
    jcfg = jconfig.tiny_model_config(**TINY)
    params = jax.tree.map(np.asarray, jax_init(JaxDALLE(jcfg),
                                               jax.random.PRNGKey(0)))
    return jcfg, tconfig.tiny_model_config(**TINY), params


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


def _assert_moments(state, jstate, tcfg, exact, dense_tol=1e-6):
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    assert state.count == want.count
    n_q = 0
    for got_m, want_m in ((state.mu, want.mu), (state.nu, want.nu)):
        for name, g in got_m.items():
            w = want_m[name]
            assert isinstance(g, tquant.Quantized) == isinstance(
                w, tquant.Quantized), name
            if not isinstance(g, tquant.Quantized):
                w = w.numpy()
                atol = 0 if exact else dense_tol * float(np.abs(w).max())
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                           err_msg=name)
                continue
            n_q += 1
            assert (g.shape, g.signed) == (w.shape, w.signed), name
            diff = g.codes.numpy().astype(int) - w.codes.numpy()
            if exact:
                assert not diff.any(), name
                np.testing.assert_array_equal(g.absmax.numpy(),
                                              w.absmax.numpy(), err_msg=name)
            else:
                assert np.abs(diff).max() <= 1, name
                assert (diff != 0).mean() <= MOMENT_FLIPS, name
                np.testing.assert_allclose(g.absmax.numpy(), w.absmax.numpy(),
                                           rtol=1e-5, err_msg=name)
    return n_q


@pytest.mark.parametrize("clip", [None, 0.5])
def test_lamb8bit_matches_jax_over_three_updates(clip):
    """From a state carried across by ``opt_state_from_jax`` (one JAX update
    in), three updates of each optimizer on the same gradients."""
    jcfg, tcfg, params = _tiny()
    jtx = jax_lamb8bit(jconfig.OptimizerConfig(max_grad_norm=clip, **OPT))
    tx = make_optimizer(tconfig.OptimizerConfig(max_grad_norm=clip, **OPT))
    assert isinstance(tx, Lamb8bit)
    jstate = jtx.init(params)
    upd, jstate = jtx.update(_grads(params, 0, 0.1), jstate, params)
    params = optax.apply_updates(params, upd)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    assert _assert_moments(state, jstate, tcfg, exact=True) > 4
    for i in range(3):
        jgrads = _grads(params, i + 1, 0.1)
        grads = {n: p.detach() for n, p in params_from_jax(
            jgrads, tcfg).named_parameters()}
        upd, jstate = jtx.update(jgrads, jstate, params)
        params = optax.apply_updates(params, upd)
        updates, state = tx.update(grads, state, model)
        apply_updates(model, updates)
        _assert_moments(state, jstate, tcfg, exact=clip is None)
    want = dict(params_from_jax(jax.tree.map(np.asarray, params),
                                tcfg).named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=name)
    assert optimizer_state_bytes(state) == jax_state_bytes(jstate)



def test_lamb8bit_block_size_100_matches_jax():
    """``block_size=100`` (not a multiple of 128): from both packages' own
    init, one update on the same gradients gives identical moment codes
    and absmax and the same parameters."""
    jcfg, tcfg, params = _tiny()
    opt = dict(OPT, block_size=100)
    jtx = jax_lamb8bit(jconfig.OptimizerConfig(max_grad_norm=None, **opt))
    tx = make_optimizer(tconfig.OptimizerConfig(max_grad_norm=None, **opt))
    jstate = jtx.init(params)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    state = tx.init(model)
    assert _assert_moments(state, jstate, tcfg, exact=True) > 4
    assert {m.codes.shape[1] for m in state.mu.values()
            if isinstance(m, tquant.Quantized)} == {100}
    jgrads = _grads(params, 5, 0.1)
    grads = {n: p.detach() for n, p in params_from_jax(
        jgrads, tcfg).named_parameters()}
    upd, jstate = jtx.update(jgrads, jstate, params)
    params = optax.apply_updates(params, upd)
    updates, state = tx.update(grads, state, model)
    apply_updates(model, updates)
    _assert_moments(state, jstate, tcfg, exact=True)
    want = dict(params_from_jax(jax.tree.map(np.asarray, params),
                                tcfg).named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=name)

def test_lamb8bit_init_quantizes_from_min_8bit_size():
    """Tensors of at least ``min_8bit_size`` elements (the threshold
    itself included) get quantized zeros; the rest dense f32 zeros."""
    _, tcfg, params = _tiny()
    model = params_from_jax(params, tcfg)
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    edge = sorted(set(sizes.values()))[-2]
    tx = make_optimizer(tconfig.OptimizerConfig(min_8bit_size=edge))
    state = tx.init(model)
    for name, numel in sizes.items():
        for m, signed in ((state.mu[name], True), (state.nu[name], False)):
            if numel >= edge:
                assert isinstance(m, tquant.Quantized) and m.signed == signed
                assert not m.absmax.any()
            else:
                assert m.dtype == torch.float32 and not m.any()
    assert any(v == edge for v in sizes.values())


def test_8bit_train_entry_matches_jax_steps():
    """Two steps of ``train_entry("cpu", ..., state_bits=8)`` (its model at
    dim 256, where ``token_emb`` holds exactly 65536 elements) against JAX's
    grad step and 8-bit apply step from the same weights and batch."""
    from dalle_tpu_torch.entry import train_entry

    kw = dict(depth=3, dim=256, heads=4, head_dim=64, text_seq_len=16,
              image_grid=4, vocab_text=128, vocab_image=64, conv_kernel=3,
              dtype="float32")
    step, (state, batch) = train_entry("cpu", micro=1, accum=2, **kw)
    assert state.model.token_emb.numel() == 65536
    jcfg = jconfig.flagship_model_config(param_dtype="float32", **kw)
    jtx = jax_lamb8bit(jconfig.OptimizerConfig(warmup_steps=2,
                                               total_steps=100))
    jstate = jsteps.TrainState.create(
        jax.tree.map(jnp.asarray, params_to_jax(state.model)), jtx)
    jgrad = jax.jit(jsteps.make_grad_step(JaxDALLE(jcfg), accum_steps=2))
    japply = jsteps.make_apply_step(jtx)
    jbatch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    reset_launches()
    for _ in range(2):
        jgrads, jmetrics = jgrad(jstate.params, jbatch)
        jstate = japply(jstate, jgrads)
        state, metrics = step(state, batch)
        for key in ("loss", "loss_text", "loss_img"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), rtol=2e-4)
    assert LAUNCHES["quantize_blockwise"] == 0      # the CPU: plain versions
    tcfg = state.model.cfg
    n_q = _assert_moments(state.opt_state, jstate.opt_state, tcfg,
                          exact=False, dense_tol=2e-4)
    assert n_q == 2 * sum(p.numel() >= 65536
                          for p in state.model.parameters())
    want = dict(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                tcfg).named_parameters())
    for name, p in state.model.named_parameters():
        step_jax = want[name].detach() - before[name]
        gap = (p.detach() - want[name].detach()).abs() / step_jax.abs().max()
        # an element whose moment code differs by one takes another Adam
        # step: a share of elements like the codes' flips, each off by up
        # to a few tenths of the largest step
        assert float((gap > UPDATE_TOL).float().mean()) <= MOMENT_FLIPS, name
        assert float(gap.max()) <= FLIPPED_STEP, name
