"""The plain reference against the program at tiny sizes on the CPU: the
loss and every gradient, the 8-bit LAMB's update and moments, and the
logits of a cached decode. Both sides get the benchmark's weights."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import dalle as ref
from benchmark.reference import lamb8bit as rlamb
from benchmark.tests import tiny

from dalle_tpu_torch.config import OptimizerConfig, tiny_model_config
from dalle_tpu_torch.models.decode import decode_step, init_cache
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.training.steps import TrainState, train_step

CASES = {
    "zoo": (tiny.ZOO, tiny.KNOBS),
    "full": (tiny.FULL, dict(remat=True)),
}


def program(m, knobs, weights):
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in dict(m, **knobs).items()}
    cfg = tiny_model_config(**kw, param_dtype="float32", dtype="float32")
    return harness.build_model(cfg, weights, "cpu")


def batch(m, rows, seed):
    gen = torch.Generator().manual_seed(seed)
    text, tmask = harness.caption_batch(gen, rows, m["text_seq_len"], 2, 6,
                                        m["vocab_text"], "cpu")
    n = m["image_grid"] ** 2
    image = torch.randint(0, m["vocab_image"], (rows, n), generator=gen)
    return {"text": text, "image": image,
            "mask": torch.cat([tmask, torch.ones(rows, n)], 1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients(case):
    m, knobs = CASES[case]
    weights = ref.make_weights(m, 3, "cpu")
    model = program(m, knobs, weights)
    b = batch(m, 6, 1)
    from dalle_tpu_torch.training.steps import grad_step
    loss, _, grads = grad_step(model, b, accum_steps=2)
    want_loss, want = ref.loss_and_grads(weights, m, b, 2, rows=2)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for name, g in want.items():
        torch.testing.assert_close(grads[name], g, rtol=1e-4, atol=1e-6,
                                   msg=name)


def test_lamb8bit_step_matches():
    m, knobs = CASES["zoo"]
    weights = ref.make_weights(m, 4, "cpu")
    model = program(m, knobs, weights)
    opt_cfg = OptimizerConfig(min_8bit_size=512, block_size=64,
                              warmup_steps=2)
    tx = make_optimizer(opt_cfg)
    state = TrainState.create(model, tx)
    params = {k: v.clone() for k, v in weights.items()}
    opt = rlamb.Lamb8bit(rlamb.LambConfig(min_8bit_size=512, block_size=64,
                                          warmup_steps=2))
    opt.init(params)
    for step in range(3):
        b = batch(m, 4, 10 + step)
        state, _ = train_step(state, b, tx, accum_steps=1)
        _, grads = ref.loss_and_grads(params, m, b, 1, rows=4)
        opt.step(params, grads)
    quantized = 0
    for name, p in model.named_parameters():
        # a moment's code can flip across a codebook midpoint on a
        # last-bit difference of the gradients: the changes agree to a few
        # percent, the moments to their block's code resolution
        got, want = p.detach() - weights[name], params[name] - weights[name]
        assert float((got - want).norm()) <= 0.05 * float(want.norm()), name
        mu = state.opt_state.mu[name]
        if hasattr(mu, "codes"):
            quantized += 1
            got = rlamb.dequantize(mu.codes, mu.absmax, mu.shape, mu.signed)
            want = rlamb.dense(opt.mu[name])
            assert float((got - want).norm()) <= 0.05 * float(want.norm())
    assert quantized


def test_decode_logits_match_the_full_forward():
    """The program's cached decode, fed a sequence, scores every image
    position as the reference's full forward does."""
    m, knobs = CASES["zoo"]
    weights = ref.make_weights(m, 6, "cpu")
    model = program(m, knobs, weights).eval()
    rng = np.random.default_rng(2)
    text = torch.as_tensor(rng.integers(2, 64, 8))
    codes = torch.as_tensor(rng.integers(0, 32, 16))
    inputs, _ = ref.inputs_of(m, text[None], codes[None])
    cache = init_cache(model.cfg, 1, "cpu")
    got = []
    for pos in range(inputs.shape[1]):
        logits, cache = decode_step(model, cache, inputs[:, pos], pos)
        if pos >= 8:
            got.append(logits[0, 64:96])
    want = ref.image_logits(weights, m, text, codes)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4,
                               atol=1e-5)


def test_quantizer_codes_equal_the_programs():
    from dalle_tpu_torch.ops.quant import quantize_blockwise_plain
    x = torch.randn(5000, generator=torch.Generator().manual_seed(0))
    for signed in (True, False):
        xs = x if signed else x.abs()
        codes, absmax = quantize_blockwise_plain(xs, 256, signed)
        q = rlamb.quantize(xs, 256, signed)
        assert torch.equal(codes, q.codes) and torch.equal(absmax, q.absmax)
