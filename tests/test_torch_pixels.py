"""The port's pixel stage (``dalle_tpu_torch/models/vqgan.py``,
``models/clip.py``, ``serving/pixels.py``) against the JAX package's.

VQGAN decode and CLIP scores within 1e-5 of the JAX modules on parameters
converted from the flax trees (``vqgan_from_jax``, ``clip_from_jax``);
the taming and OpenAI checkpoint loaders of both packages on one synthetic
state dict with the released key schema (written to ``tmp_path``, so no
weights are downloaded); the CLIP resize and BPE tokenizer; and the pixel
worker's failure path inside the engine.
"""

import gzip
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.models import clip as jclip
from dalle_tpu.models import vqgan as jvqgan
from dalle_tpu_torch.config import ServingConfig, tiny_model_config
from dalle_tpu_torch.models import clip as tclip
from dalle_tpu_torch.models import vqgan as tvqgan
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.models.decode import SamplingConfig
from dalle_tpu_torch.params import clip_from_jax, vqgan_from_jax
from dalle_tpu_torch.serving.engine import DecodeEngine
from dalle_tpu_torch.serving.pixels import PixelPipeline

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def vq():
    cfg = jvqgan.tiny_vqgan_config()
    codes = np.random.default_rng(0).integers(
        0, cfg.n_embed, (2, cfg.code_grid ** 2)).astype(np.int32)
    params = jvqgan.VQGANDecoder(cfg).init(jax.random.PRNGKey(0),
                                           jnp.asarray(codes))
    # nonzero biases and norms: a dropped or transposed one must show
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf + 0.1 * rng.standard_normal(
            leaf.shape).astype(np.float32)
        if path[-1].key in ("bias", "scale") else leaf, _np(params))
    return cfg, params, codes


@pytest.fixture(scope="module")
def cl():
    cfg = jclip.tiny_clip_config()
    rng = np.random.default_rng(2)
    images = rng.random((3, cfg.image_size, cfg.image_size, 3)).astype(
        np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 1,
                          (2, cfg.context_length)).astype(np.int32)
    tokens[:, 5] = cfg.vocab_size - 1             # the EOT (largest id)
    params = _np(jclip.CLIPModel(cfg).init(
        jax.random.PRNGKey(3), jnp.asarray(images), jnp.asarray(tokens)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf + 0.1 * rng.standard_normal(
            leaf.shape).astype(np.float32)
        if path[-1].key in ("bias", "scale") else leaf, params)
    return cfg, params, images, tokens


def test_vqgan_matches_jax_on_converted_params(vq):
    cfg, params, codes = vq
    model = vqgan_from_jax(params, tvqgan.tiny_vqgan_config())
    want = np.asarray(jvqgan.VQGANDecoder(cfg).apply(params,
                                                     jnp.asarray(codes)))
    with torch.no_grad():
        got = model(torch.from_numpy(codes)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    u8 = tvqgan.decode_codes(model, torch.from_numpy(codes)).numpy()
    assert u8.dtype == np.uint8 and u8.shape == (2, 16, 16, 3)
    ju8 = np.asarray(jvqgan.decode_codes(params, cfg, jnp.asarray(codes)))
    # uint8 truncation of values within 1e-5: at most one step apart
    assert np.abs(u8.astype(int) - ju8.astype(int)).max() <= 1


def test_clip_matches_jax_on_converted_params(cl):
    cfg, params, images, tokens = cl
    model = clip_from_jax(params, tclip.tiny_clip_config())
    want = np.asarray(jclip.clip_scores(params, cfg, jnp.asarray(images),
                                        jnp.asarray(tokens)))
    got = tclip.clip_scores(model, torch.from_numpy(images),
                            torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    m = jclip.CLIPModel(cfg)
    with torch.no_grad():
        for name, jfn, tfn, arg in (
                ("image", m.encode_image, model.encode_image, images),
                ("text", m.encode_text, model.encode_text, tokens)):
            w = np.asarray(m.apply(params, jnp.asarray(arg), method=jfn))
            np.testing.assert_allclose(tfn(torch.from_numpy(arg)).numpy(),
                                       w, **TOL, err_msg=name)


@pytest.mark.parametrize("size", [16, 24, 40, 224])
def test_clip_resize_matches_jax(size):
    """uint8 (B, H, W, 3) to the CLIP input size, down and up, with the
    antialiased bilinear weights of ``jax.image.resize``."""
    u8 = np.random.default_rng(size).integers(0, 256, (2, 32, 48, 3)).astype(
        np.uint8)
    want = np.asarray(jclip.resize_for_clip(
        jnp.asarray(u8), jclip.tiny_clip_config(image_size=size)))
    got = tclip.resize_for_clip(torch.from_numpy(u8), tclip.tiny_clip_config(
        image_size=size)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_taming_checkpoint_loaders_agree(vq, tmp_path):
    """One synthetic taming-transformers checkpoint (Gumbel codebook name,
    encoder keys beside the decoder's, a lightning ``state_dict`` wrapper)
    through both packages' loaders: the same pixels."""
    cfg, params, codes = vq
    sd = vqgan_from_jax(params, tvqgan.tiny_vqgan_config()).state_dict()
    sd["quantize.embed.weight"] = sd.pop("quantize.embedding.weight")
    sd["encoder.conv_in.weight"] = torch.zeros(4, 3, 3, 3)
    sd["quantize.proj.weight"] = torch.zeros(8, 4, 1, 1)
    path = str(tmp_path / "vqgan.ckpt")
    torch.save({"state_dict": sd}, path)
    model = tvqgan.load_taming_checkpoint(path, tvqgan.tiny_vqgan_config())
    jparams = jvqgan.load_taming_checkpoint(path, cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(codes)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jvqgan.VQGANDecoder(cfg).apply(jparams,
                                                     jnp.asarray(codes)))
    np.testing.assert_allclose(got, want, **TOL)


def test_openai_checkpoint_loaders_agree(cl, tmp_path):
    """One synthetic openai/CLIP state dict (with the released file's
    extra scalar entries) through both packages' loaders: the same
    scores."""
    cfg, params, images, tokens = cl
    sd = clip_from_jax(params, tclip.tiny_clip_config()).state_dict()
    sd.update(input_resolution=torch.tensor(cfg.image_size),
              context_length=torch.tensor(cfg.context_length),
              vocab_size=torch.tensor(cfg.vocab_size))
    path = str(tmp_path / "clip.pt")
    torch.save(sd, path)
    model = tclip.load_openai_checkpoint(path, tclip.tiny_clip_config())
    jparams = jclip.load_openai_checkpoint(path, cfg)
    got = tclip.clip_scores(model, torch.from_numpy(images),
                            torch.from_numpy(tokens)).numpy()
    want = np.asarray(jclip.clip_scores(jparams, cfg, jnp.asarray(images),
                                        jnp.asarray(tokens)))
    np.testing.assert_allclose(got, want, **TOL)


def _merges(tmp_path, merges):
    path = tmp_path / "merges.txt.gz"
    buf = io.StringIO("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                                  for a, b in merges))
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write(buf.getvalue())
    return str(path)


@pytest.mark.parametrize("text", [
    "low", "ox", "lo x", "a LOW, low-lying &amp; lower\tcow's ox_box 42",
    "a very long caption that overflows the context window easily"])
def test_clip_tokenizer_equals_jax(text, tmp_path):
    path = _merges(tmp_path, [("l", "o"), ("lo", "w</w>"), ("o", "x</w>"),
                              ("c", "o")])
    want = jclip.CLIPTokenizer(path, context_length=8).encode(text)
    got = tclip.CLIPTokenizer(path, context_length=8).encode(text)
    np.testing.assert_array_equal(got, want)
    eot = tclip.CLIPTokenizer(path, 8).encoder["<|endoftext|>"]
    assert got.max() == eot


def test_pixel_failure_fails_the_request_not_the_worker():
    cfg = tiny_model_config(attn_types=("axial_row", "axial_col"), depth=2)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    vqgan = tvqgan.VQGANDecoder(tvqgan.tiny_vqgan_config()).eval()
    calls = {"n": 0}

    def flaky(codes):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("synthetic pixel failure")
        return {"images": tvqgan.decode_codes(
            vqgan, torch.from_numpy(codes[None]))[0].numpy()}

    engine = DecodeEngine(model, cfg, ServingConfig(n_slots=1,
                                                    steps_per_call=4),
                          sampling=SamplingConfig(1.0, 8),
                          pixel_pipeline=PixelPipeline(flaky)).start()
    rng = np.random.default_rng(0)
    try:
        h1, h2 = (engine.submit(rng.integers(2, 128, cfg.text_seq_len), s)
                  for s in (0, 1))
        with pytest.raises(RuntimeError, match="pixel stage failed"):
            h1.result(timeout=120)
        row = h2.result(timeout=120)
        snap = engine.metrics.snapshot()
    finally:
        engine.stop()
    assert row["images"].shape == (16, 16, 3)
    assert row["codes"].shape == (cfg.image_seq_len,)
    assert snap["failed"] == 1 and snap["completed"] == 1
