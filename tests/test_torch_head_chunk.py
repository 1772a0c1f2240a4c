"""The tied head's ``head_chunk`` (``dalle_tpu_torch/models/dalle.py``,
``ChunkedNLL``) against the JAX package's ``_segment_nll``.

The per-token NLL and its gradients in ``h`` and the table (``jax.vjp``)
on seeded f32 inputs, with chunks narrower than the segment that do not
divide it (JAX pads the last chunk and masks the padding out; the port's
last chunk is narrower), at JAX's tolerances: 1e-5 on the values, rtol
5e-4 and atol 5e-5 on the gradients. The chunked route against the
port's one-pass route: within f32 rounding (1e-6 of the largest
magnitude), and in bf16 within one bf16 rounding of it (2^-7);
``head_chunk=0`` and a segment no wider than the chunk take the one-pass
route bit for bit. Then the whole model with ``head_chunk`` on one
process (the loss and every gradient against JAX's grad step) and on a
mesh whose ``tp`` ranks hold vocabulary slices of the table (``dp=1
fsdp=2 tp=2``, tests/test_torch_mesh_model.check_case), where each rank
streams its slice and the ranks' maxima and sums combine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import tiny_model_config as jax_tiny
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import _segment_nll as jax_segment_nll
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu_torch.config import tiny_model_config
from dalle_tpu_torch.models.dalle import _head_logits, _nll, _segment_nll
from dalle_tpu_torch.params import params_from_jax
from dalle_tpu_torch.training.steps import grad_step
from tests.test_torch_mesh_model import (GRAD_TOL, LOSS_TOL, _batch,
                                         _by_port_name, _jax_loss_and_grads,
                                         check_case)

torch.set_num_threads(2)
B, T, D = 2, 5, 32
CHUNK = 48                     # narrower than both tiny segments (128, 64)


def _inputs(v, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    table = (rng.standard_normal((v, D)) * 0.5).astype(np.float32)
    targets = rng.integers(0, v, (B, T))
    cot = rng.standard_normal((B, T)).astype(np.float32)
    return h, table, targets, cot


def _port(h, table, targets, cot, chunk, dtype=torch.float32):
    ht = torch.tensor(h).to(dtype).requires_grad_(True)
    tt = torch.tensor(table).requires_grad_(True)
    nll = _segment_nll(ht, tt, torch.tensor(targets), chunk)
    dh, dt = torch.autograd.grad(nll, (ht, tt), torch.tensor(cot))
    return nll.detach(), dh, dt


@pytest.mark.parametrize("v", [128, 64, 130])
def test_chunked_nll_matches_jax(v):
    h, table, targets, cot = _inputs(v)
    nll, vjp = jax.vjp(lambda a, b: jax_segment_nll(a, b, targets, CHUNK),
                       jnp.asarray(h), jnp.asarray(table))
    dh, dt = vjp(jnp.asarray(cot))
    got = _port(h, table, targets, cot, CHUNK)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(nll), **LOSS_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(dh), **GRAD_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dt), **GRAD_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7)])
def test_chunked_and_one_pass_routes_agree(dtype, tol):
    h, table, targets, cot = _inputs(130, seed=1)
    one = _port(h, table, targets, cot, 0, dtype)
    for chunk in (1, 7, CHUNK, 129):
        got = _port(h, table, targets, cot, chunk, dtype)
        for a, b in zip(got, one):
            a, b = a.float(), b.float()
            assert float((a - b).abs().max()) <= tol * float(
                b.abs().max()), (chunk, dtype)


def test_no_chunk_or_a_narrow_segment_takes_the_one_pass_route():
    h, table, targets, cot = _inputs(64, seed=2)
    ht, tt = torch.tensor(h), torch.tensor(table)
    want = _nll(_head_logits(ht, tt), torch.tensor(targets))
    for chunk in (0, 64, 100):
        assert torch.equal(_segment_nll(ht, tt, torch.tensor(targets),
                                        chunk), want)
        one = _port(h, table, targets, cot, 0)
        got = _port(h, table, targets, cot, chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, one))


def test_model_with_head_chunk_matches_jax_on_one_process():
    kw = dict(head_chunk=CHUNK, attn_types=("axial_row", "axial_col"),
              depth=3)
    jcfg = jax_tiny(**kw)
    params = jax.tree.map(np.asarray, jax_init(JaxDALLE(jcfg),
                                               jax.random.PRNGKey(0)))
    batch = _batch(jcfg, masked=True)
    loss, grads = _jax_loss_and_grads(JaxDALLE(jcfg), params, batch, 1)
    model = params_from_jax(params, tiny_model_config(**kw))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["text"], tb["image"] = tb["text"].long(), tb["image"].long()
    got_loss, _, got = grad_step(model, tb)
    np.testing.assert_allclose(float(got_loss), loss, **LOSS_TOL)
    want = _by_port_name(grads)
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, **GRAD_TOL,
                                   err_msg=name)


def test_model_with_head_chunk_on_a_vocab_sharded_mesh(tmp_path):
    check_case(tmp_path, "head_chunk_tp",
               dict(head_chunk=CHUNK, attn_types=("axial_row", "axial_col"),
                    depth=3),
               dict(dp=1, fsdp=2, tp=2, sp=1), 1, masked=True)


def test_bf16_chunks_round_once_where_jax_rounds_each_chunk():
    """In bf16 the port's chunked gradients keep its one-pass rounding
    (f32 sums over the chunks, each gradient cast once): within 2^-16 of
    each gradient's largest magnitude. JAX's scan rounds each chunk's
    contribution to ``h``'s bf16, so its chunked gradients differ from its
    one-pass ones by more (here 2^-8 on ``h``'s, 2^-9 on the table's);
    both packages stay within 2^-7 of JAX's one-pass head."""
    h, table, targets, cot = _inputs(1000, seed=3)

    def jax_grads(chunk):
        _, vjp = jax.vjp(
            lambda a, b: jax_segment_nll(a, b, targets, chunk),
            jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(table))
        return [np.asarray(g.astype(jnp.float32))
                for g in vjp(jnp.asarray(cot))]

    def port_grads(chunk):
        return [g.float().numpy() for g in _port(
            h, table, targets, cot, chunk, torch.bfloat16)[1:]]

    def err(got, want):
        return max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(got, want))

    one = jax_grads(0)
    assert err(port_grads(64), port_grads(0)) <= 2 ** -16
    assert err(port_grads(64), one) <= 2 ** -7
    assert err(jax_grads(64), one) <= 2 ** -7
