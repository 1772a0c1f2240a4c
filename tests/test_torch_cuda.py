"""The port's Hopper kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (a
CUDA kernel has no CPU mode; tests/test_torch_ops.py holds the plain
versions against the JAX kernels there). This file imports no JAX, so on a
GPU machine without JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: bf16 outputs 2^-7 relative and absolute (the kernel and the
plain version round the same f32 math, summed in another order; the GEGLU
output 2^-6, since its hg intermediate is rounded to bf16 in both before a
4096-term sum); the f32 logsumexp 1e-5; the LayerNorm backward's f32
parameter sums 1e-4 (sums over 512 rows in another order). Every backward
kernel also runs twice on the same inputs and must give identical bits (no
atomics, fixed reduction orders), and so must the GEGLU forward. The three
quantizers' codes and scales must equal their plain versions' exactly.

The generic attention and GEGLU instances (the route of f32 operands and of
head dims and widths the fast kernels do not take) are held to the same
bf16 tolerances, and in f32 to 1e-5 (the same f32 math summed in another
order; f32 products on the card run in full f32, TF32 off). The tiny
model's forward and one ``grad_step`` on the card, all through those
instances, are held against the same parameters on the CPU (plain
versions) at 2e-4, the tolerance the CPU tests hold the port to JAX with.
"""

import copy

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import tiny_model_config
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.ops import GENERIC_LAUNCHES, LAUNCHES, reset_launches
from dalle_tpu_torch.ops.attention import (attention_route, line_attention,
                                           line_attention_bwd,
                                           line_attention_bwd_plain,
                                           line_attention_plain,
                                           window_attention,
                                           window_attention_bwd,
                                           window_attention_bwd_plain,
                                           window_attention_plain)
from dalle_tpu_torch.ops.geglu import (geglu_ff, geglu_ff_bwd,
                                       geglu_ff_bwd_plain, geglu_ff_plain,
                                       geglu_route)
from dalle_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                            layer_norm_bwd_plain,
                                            layer_norm_plain)
from dalle_tpu_torch.ops.quant import (codebook_midpoints,
                                       quantize_blockwise,
                                       quantize_blockwise_plain,
                                       wire_quantize_u4,
                                       wire_quantize_u4_plain,
                                       wire_quantize_u8,
                                       wire_quantize_u8_plain)
from dalle_tpu_torch.training.steps import grad_step

BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
F32 = dict(rtol=1e-5, atol=1e-5)
TOL = {torch.bfloat16: BF16, torch.float32: F32}
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU "
                    "mode; tests/test_torch_ops.py covers their plain "
                    "versions")
    return torch.device("cuda")


def _rand(shape, seed, device, dtype, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(device)


def _bf16(shape, seed, device, scale=1.0):
    return _rand(shape, seed, device, torch.bfloat16, scale)


@pytest.mark.cuda
def test_cuda_layer_norm_kernel(cuda_device):
    x = _bf16((512, 1024), 0, cuda_device, 2.0)
    g = torch.ones(1024, device=cuda_device)
    b = torch.zeros(1024, device=cuda_device)
    reset_launches()
    got = layer_norm(x, g, b)
    assert LAUNCHES["layer_norm"] == 1
    torch.testing.assert_close(got.float(), layer_norm_plain(x, g, b).float(),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.cuda
def test_cuda_geglu_kernel(cuda_device):
    m, d, k = 320, 256, 512
    ops = [_bf16(s, i, cuda_device, sc) for i, (s, sc) in enumerate(
        [((m, d), 0.5), ((d, k), 0.05), ((d, k), 0.05), ((k, d), 0.05),
         ((k,), 0.1), ((k,), 0.1), ((d,), 0.1)])]
    got = geglu_ff(*ops)
    torch.testing.assert_close(got.float(), geglu_ff_plain(*ops).float(),
                               rtol=2 ** -6, atol=2 ** -6)


# The flagship's shape and the edges of the GEGLU kernels' tiles: M not a
# multiple of the 128-row tile, K a multiple of 64 but not of the forward's
# 128-column tile (and an odd number of the backward's 64-column tiles),
# d = 64 (one k-block of depth 64), and a single row with one column tile.
GEGLU_SHAPES = [(5120, 1024, 4096), (1000, 1024, 4096), (384, 256, 320),
                (200, 64, 256), (1, 64, 64), (64, 128, 192)]


def _geglu_operands(m, d, k, device, seed):
    """x, Wi, Wg, Wo, bi, bg, bo and a cotangent dO, scaled as the model's
    initialisation scales them (weights by 1/sqrt(fan-in))."""
    shapes = [((m, d), 1.0), ((d, k), d ** -0.5), ((d, k), d ** -0.5),
              ((k, d), k ** -0.5), ((k,), 0.1), ((k,), 0.1), ((d,), 0.1),
              ((m, d), 1.0)]
    return [_bf16(s, seed + i, device, sc) for i, (s, sc) in enumerate(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k", GEGLU_SHAPES)
def test_cuda_geglu_kernel_shapes(cuda_device, m, d, k):
    *ops, _ = _geglu_operands(m, d, k, cuda_device, 50)
    reset_launches()
    got, again = geglu_ff(*ops), geglu_ff(*ops)
    assert LAUNCHES["geglu_ff"] == 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), geglu_ff_plain(*ops).float(),
                               rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k", GEGLU_SHAPES)
def test_cuda_geglu_bwd_kernel_shapes(cuda_device, m, d, k):
    x, wi, wg, wo, bi, bg, _, dout = _geglu_operands(m, d, k, cuda_device, 60)
    reset_launches()
    got = _same_twice(geglu_ff_bwd, x, wi, wg, wo, bi, bg, dout)
    assert LAUNCHES["geglu_ff_bwd"] == 2
    want = geglu_ff_bwd_plain(x, wi, wg, wo, bi, bg, dout)
    for name, a, w in zip(("dh|dg", "hg"), got, want):
        assert a.shape == w.shape, name
        torch.testing.assert_close(a.float(), w.float(), msg=name, **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text", "axial_row", "axial_col",
                                  "conv_like", "full"])
def test_cuda_attention_kernels(cuda_device, kind):
    b, h, grid, text = 2, 4, 8, 32
    if kind == "text":
        q, k, v = (_bf16((b, text, h, 64), i, cuda_device).transpose(1, 2)
                   for i in range(3))
        args, fn, plain = (None, None, text, 0, False), line_attention, \
            line_attention_plain
    else:
        q, k, v = (_bf16((b, grid * grid, h, 64), i, cuda_device)
                   .transpose(1, 2) for i in range(3))
        kp, vp = (_bf16((b, text, h, 64), 5 + i, cuda_device).transpose(1, 2)
                  for i in range(2))
        if kind.startswith("axial"):
            args = (kp, vp, grid, grid, kind == "axial_col")
            fn, plain = line_attention, line_attention_plain
        else:
            args = (kp, vp, grid, 2 if kind == "conv_like" else None)
            fn, plain = window_attention, window_attention_plain
    out, lse = fn(q, k, v, *args)
    out_p, lse_p = plain(q, k, v, *args)
    torch.testing.assert_close(out.float(), out_p.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


def _same_twice(fn, *args):
    """Runs ``fn`` twice; asserts bitwise-equal outputs; returns the first."""
    first, second = fn(*args), fn(*args)
    for a, b in zip(first, second):
        if a is not None:
            assert torch.equal(a, b)
    return first


@pytest.mark.cuda
def test_cuda_layer_norm_bwd_kernel(cuda_device):
    x = _bf16((512, 1024), 0, cuda_device, 2.0)
    dy = _bf16((512, 1024), 1, cuda_device)
    g = _bf16((1024,), 2, cuda_device, 0.2).float() + 1.0
    reset_launches()
    got = _same_twice(layer_norm_bwd, x, g, dy)
    assert LAUNCHES["layer_norm_bwd"] == 2
    want = layer_norm_bwd_plain(x, g, dy)
    torch.testing.assert_close(got[0].float(), want[0].float(), **BF16)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_geglu_bwd_kernel(cuda_device):
    m, d, k = 320, 256, 512
    ops = [_bf16(s, i, cuda_device, sc) for i, (s, sc) in enumerate(
        [((m, d), 0.5), ((d, k), 0.05), ((d, k), 0.05), ((k, d), 0.05),
         ((k,), 0.1), ((k,), 0.1), ((m, d), 1.0)])]
    reset_launches()
    got = _same_twice(geglu_ff_bwd, *ops)
    assert LAUNCHES["geglu_ff_bwd"] == 2
    for a, b in zip(got, geglu_ff_bwd_plain(*ops)):
        torch.testing.assert_close(a.float(), b.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text", "axial_row", "axial_col",
                                  "axial_row_noprefix", "conv_like", "full",
                                  "conv_like_noprefix"])
def test_cuda_attention_bwd_kernels(cuda_device, kind):
    b, h, grid, text = 2, 4, 8, 32
    t = text if kind == "text" else grid * grid
    q, k, v, dout = (_bf16((b, t, h, 64), 10 + i, cuda_device).transpose(1, 2)
                     for i in range(4))
    kp = vp = None
    if kind != "text" and not kind.endswith("noprefix"):
        kp, vp = (_bf16((b, text, h, 64), 20 + i, cuda_device).transpose(1, 2)
                  for i in range(2))
    if kind == "text":
        extra = (text, 0, False)
    elif kind.startswith("axial"):
        extra = (grid, grid, kind == "axial_col")
    else:
        extra = (grid, 2 if kind.startswith("conv_like") else None)
    if len(extra) == 3:
        fwd, bwd, plain = line_attention, line_attention_bwd, \
            line_attention_bwd_plain
    else:
        fwd, bwd, plain = window_attention, window_attention_bwd, \
            window_attention_bwd_plain
    out, lse = fwd(q, k, v, kp, vp, *extra)
    reset_launches()
    got = _same_twice(bwd, q, k, v, kp, vp, out, lse, dout, *extra)
    assert sum(LAUNCHES.values()) == 2
    want = plain(q, k, v, kp, vp, out, lse, dout, *extra)
    for name, a, w in zip(("dq", "dk", "dv", "dkp", "dvp"), got, want):
        assert (a is None) == (w is None), name
        if a is not None:
            assert a.shape == w.shape, name
            torch.testing.assert_close(a.float(), w.float(), msg=name,
                                       **BF16)


# The flagship's lengths: image grid 32 (four query tiles a line of raster
# rows, sixteen in all) with the 256-token text prefix (the prefix dk/dv
# pass's clusters each walk four query tiles), a ragged 40-token prefix,
# and text-causal at 256 (four query tiles, a causal walk of one to four).
FLAGSHIP_CASES = [("axial_row", 256), ("axial_col", 256), ("conv_like", 256),
                  ("full", 256), ("axial_row", 40), ("axial_col", 40),
                  ("conv_like", 40), ("full", 40), ("text", 256)]


def _flagship_case(kind, prefix, device, seed):
    """(q, k, v, dout, kp, vp, extra, fwd, bwd, plain_fwd, plain_bwd) at
    b=1, h=2: strided (B, T, H, d) views as the model makes them."""
    b, h, grid = 1, 2, 32
    t = prefix if kind == "text" else grid * grid
    q, k, v, dout = (_bf16((b, t, h, 64), seed + i, device).transpose(1, 2)
                     for i in range(4))
    kp = vp = None
    if kind != "text":
        kp, vp = (_bf16((b, prefix, h, 64), seed + 4 + i, device)
                  .transpose(1, 2) for i in range(2))
    if kind == "text":
        extra = (t, 0, False)
    elif kind.startswith("axial"):
        extra = (grid, grid, kind == "axial_col")
    else:
        extra = (grid, 5 if kind == "conv_like" else None)
    if len(extra) == 3:
        fns = (line_attention, line_attention_bwd, line_attention_plain,
               line_attention_bwd_plain)
    else:
        fns = (window_attention, window_attention_bwd, window_attention_plain,
               window_attention_bwd_plain)
    return (q, k, v, dout, kp, vp, extra) + fns


@pytest.mark.cuda
@pytest.mark.parametrize("kind,prefix", FLAGSHIP_CASES)
def test_cuda_attention_kernels_flagship_lengths(cuda_device, kind, prefix):
    q, k, v, _, kp, vp, extra, fwd, _, plain, _ = _flagship_case(
        kind, prefix, cuda_device, 30)
    reset_launches()
    out, lse = fwd(q, k, v, kp, vp, *extra)
    assert sum(LAUNCHES.values()) == 1
    out_p, lse_p = plain(q, k, v, kp, vp, *extra)
    torch.testing.assert_close(out.float(), out_p.float(), **BF16)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,prefix", FLAGSHIP_CASES)
def test_cuda_attention_bwd_kernels_flagship_lengths(cuda_device, kind,
                                                     prefix):
    q, k, v, dout, kp, vp, extra, fwd, bwd, _, plain = _flagship_case(
        kind, prefix, cuda_device, 40)
    out, lse = fwd(q, k, v, kp, vp, *extra)
    reset_launches()
    got = _same_twice(bwd, q, k, v, kp, vp, out, lse, dout, *extra)
    assert sum(LAUNCHES.values()) == 2
    want = plain(q, k, v, kp, vp, out, lse, dout, *extra)
    for name, a, w in zip(("dq", "dk", "dv", "dkp", "dvp"), got, want):
        assert (a is None) == (w is None), name
        if a is not None:
            assert a.shape == w.shape, name
            torch.testing.assert_close(a.float(), w.float(), msg=name,
                                       **BF16)


def _quant_input(n, seed, device):
    """Mixed magnitudes, zeros, -0.0, and values on exact midpoints and
    half steps of power-of-two scales (ties)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, generator=g) * torch.tensor([1e-6, 1.0, 100.0])[
        torch.randint(0, 3, (n,), generator=g)]
    x[: n // 5] = 0.0
    x[n // 5: n // 5 + 7] = -0.0
    if n >= 4096:
        k = torch.arange(-127, 127, dtype=torch.float32)
        x[256:256 + k.numel()] = (k + 0.5) * 2 ** -3
        x[256 + k.numel()] = 127 * 2 ** -3
    return x.to(device)


# block sizes of every kernel instance: the register path with float4 loads
# (block % 4 == 0; groups of 1 to 512 threads a block, 8192 the widest) and
# with scalar loads (1, 100, 127; 4097 a 512-thread group), and the two-pass
# kernel for blocks wider than one CTA's registers (above 8192) with float4
# loads (16384, 32768, 65536) and scalar loads (10001)
QUANT_BLOCKS = (4096, 128, 1152, 1, 100, 127, 4097, 8192, 10001, 16384,
                32768, 65536)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 3 * 4096 + 1000, 129, 70001])
@pytest.mark.parametrize("signed", [True, False])
def test_cuda_quantize_blockwise_kernel(cuda_device, n, signed):
    x = _quant_input(n, n, cuda_device)
    if not signed:
        x = x.abs()
    for block in QUANT_BLOCKS:
        reset_launches()
        q = quantize_blockwise(x, block, signed=signed)
        assert LAUNCHES["quantize_blockwise"] == 1
        codes, absmax = quantize_blockwise_plain(x, block, signed)
        assert torch.equal(q.codes, codes), block
        assert torch.equal(q.absmax, absmax), block
    y = x.clone()
    y[5], y[n // 2] = float("inf"), float("nan")
    q = quantize_blockwise(y, 128, signed=signed)
    codes, absmax = quantize_blockwise_plain(y, 128, signed)
    assert torch.equal(q.codes, codes)
    assert torch.equal(q.absmax.isnan(), absmax.isnan())
    ok = ~absmax.isnan()
    assert torch.equal(q.absmax[ok], absmax[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False])
def test_cuda_quantize_blockwise_lookup_edges(cuda_device, signed):
    """Blocks whose first value is 1.0, so that ``x / absmax == x``: every
    midpoint and its two float32 neighbours, +-0.0, subnormals, +-1, and
    every 4096th float32 bit pattern in [-1, 1]; then +-inf and values past
    1 beside a NaN (which leaves the block's scale at 1)."""
    mids = torch.from_numpy(codebook_midpoints(signed))
    tiny = torch.finfo(torch.float32).smallest_normal
    sub = torch.tensor([0.0, -0.0, 1e-45, -1e-45, tiny / 3, -tiny / 3, tiny,
                        -tiny, 1.0, -1.0])
    one = int(torch.tensor(1.0).view(torch.int32))
    bits = torch.arange(0, one + 1, 4096, dtype=torch.int32)
    pats = bits.view(torch.float32)
    vals = torch.cat([mids, torch.nextafter(mids, torch.tensor(2.0)),
                      torch.nextafter(mids, torch.tensor(-2.0)), sub, pats,
                      -pats])
    per = 4095
    vals = torch.cat([vals, torch.zeros(-vals.numel() % per)])
    x = torch.cat([torch.ones(vals.numel() // per, 1), vals.view(-1, per)],
                  dim=1).reshape(-1).to(cuda_device)
    for block in (4096, 2048 + 1):
        q = quantize_blockwise(x, block, signed=signed)
        codes, absmax = quantize_blockwise_plain(x, block, signed)
        assert torch.equal(q.codes, codes) and torch.equal(q.absmax, absmax)
    y = torch.tensor([float("nan"), float("inf"), float("-inf"), 1.5, -1.5,
                      0.5, -0.0, 3e38] * 16, device=cuda_device)
    q = quantize_blockwise(y, 128, signed=signed)
    codes, _ = quantize_blockwise_plain(y, 128, signed)
    assert torch.equal(q.codes, codes)
    assert q.codes[0, :3].tolist() == [0, 255, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 255, 256, 257, 1023, 1024, 1025, 4096,
                               65537, 100_003])
def test_cuda_wire_quantize_kernels(cuda_device, n):
    x = _quant_input(n, 7 + n, cuda_device)
    reset_launches()
    got8, got4 = wire_quantize_u8(x), wire_quantize_u4(x)
    assert LAUNCHES["wire_quantize_u8"] == LAUNCHES["wire_quantize_u4"] == 1
    for got, want in ((got8, wire_quantize_u8_plain(x)),
                      (got4, wire_quantize_u4_plain(x))):
        assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got4[0].numel() == (n + 1) // 2
    if n % 2:
        assert int(got4[0][-1]) >> 4 == 0       # the pad nibble
    with pytest.raises(ValueError, match="float32"):
        wire_quantize_u8(x.double())


# -- generic instances ------------------------------------------------------

# every generic (dtype, head_dim) instance: f32 at all four head dims, bf16
# at the three the fast kernels do not take
GENERIC_ATTENTION = [(torch.float32, 16), (torch.float32, 32),
                     (torch.float32, 64), (torch.float32, 128),
                     (torch.bfloat16, 16), (torch.bfloat16, 32),
                     (torch.bfloat16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim", GENERIC_ATTENTION,
                         ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("kind", ["text", "axial_row", "axial_col",
                                  "axial_row_noprefix", "conv_like", "full",
                                  "conv_like_noprefix"])
def test_cuda_attention_generic_kernels(cuda_device, dtype, head_dim, kind):
    """Forward and backward of the generic instance against the plain
    versions, strided (B, T, H, d) views as the model makes them; the
    backward twice, bitwise equal."""
    assert attention_route(dtype, head_dim) == "generic"
    b, h, grid, text = 2, 3, 6, 20
    t = text if kind == "text" else grid * grid
    q, k, v, dout = (_rand((b, t, h, head_dim), 70 + i, cuda_device, dtype)
                     .transpose(1, 2) for i in range(4))
    kp = vp = None
    if kind != "text" and not kind.endswith("noprefix"):
        kp, vp = (_rand((b, text, h, head_dim), 80 + i, cuda_device, dtype)
                  .transpose(1, 2) for i in range(2))
    if kind == "text":
        extra = (text, 0, False)
    elif kind.startswith("axial"):
        extra = (grid, grid, kind == "axial_col")
    else:
        extra = (grid, 1 if kind.startswith("conv_like") else None)
    if len(extra) == 3:
        fns = (line_attention, line_attention_bwd, line_attention_plain,
               line_attention_bwd_plain)
    else:
        fns = (window_attention, window_attention_bwd, window_attention_plain,
               window_attention_bwd_plain)
    fwd, bwd, plain_fwd, plain_bwd = fns
    reset_launches()
    out, lse = fwd(q, k, v, kp, vp, *extra)
    out_p, lse_p = plain_fwd(q, k, v, kp, vp, *extra)
    torch.testing.assert_close(out.float(), out_p.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_p, **F32)
    got = _same_twice(bwd, q, k, v, kp, vp, out, lse, dout, *extra)
    name = fwd.__name__
    assert GENERIC_LAUNCHES[name] == LAUNCHES[name] == 1
    assert GENERIC_LAUNCHES[f"{name}_bwd"] == LAUNCHES[f"{name}_bwd"] == 2
    want = plain_bwd(q, k, v, kp, vp, out, lse, dout, *extra)
    for grad, a, w in zip(("dq", "dk", "dv", "dkp", "dvp"), got, want):
        assert (a is None) == (w is None), grad
        if a is not None:
            assert a.shape == w.shape and a.dtype == dtype, grad
            torch.testing.assert_close(a.float(), w.float(), msg=grad,
                                       **TOL[dtype])


# widths the fast kernels take in f32 only through the generic route, and
# multiples of 8 that are not of 64 (a ragged M too)
GENERIC_GEGLU = [(torch.float32, 320, 256, 1024), (torch.float32, 64, 64, 256),
                 (torch.float32, 200, 72, 136), (torch.bfloat16, 200, 72, 136),
                 (torch.bfloat16, 1, 8, 16), (torch.float32, 1000, 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,d,k", GENERIC_GEGLU,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_cuda_geglu_generic_kernels(cuda_device, dtype, m, d, k):
    assert geglu_route(dtype, d, k) == "generic"
    assert not torch.backends.cuda.matmul.allow_tf32
    shapes = [((m, d), 1.0), ((d, k), d ** -0.5), ((d, k), d ** -0.5),
              ((k, d), k ** -0.5), ((k,), 0.1), ((k,), 0.1), ((d,), 0.1),
              ((m, d), 1.0)]
    x, wi, wg, wo, bi, bg, bo, dout = (
        _rand(sh, 90 + i, cuda_device, dtype, sc)
        for i, (sh, sc) in enumerate(shapes))
    reset_launches()
    got, again = geglu_ff(x, wi, wg, wo, bi, bg, bo), \
        geglu_ff(x, wi, wg, wo, bi, bg, bo)
    assert torch.equal(got, again)
    out_tol = dict(rtol=2 ** -6, atol=2 ** -6) if dtype == torch.bfloat16 \
        else F32
    torch.testing.assert_close(
        got.float(), geglu_ff_plain(x, wi, wg, wo, bi, bg, bo).float(),
        **out_tol)
    grads = _same_twice(geglu_ff_bwd, x, wi, wg, wo, bi, bg, dout)
    assert GENERIC_LAUNCHES["geglu_ff"] == LAUNCHES["geglu_ff"] == 2
    assert GENERIC_LAUNCHES["geglu_ff_bwd"] == LAUNCHES["geglu_ff_bwd"] == 2
    want = geglu_ff_bwd_plain(x, wi, wg, wo, bi, bg, dout)
    for name, a, w in zip(("dh|dg", "hg"), grads, want):
        assert a.shape == w.shape and a.dtype == dtype, name
        torch.testing.assert_close(a.float(), w.float(), msg=name,
                                   **TOL[dtype])


# the flagship's shape, the tiny model's (f32, d = 64), the XL width (bf16,
# d = 1792: partials in shared memory) with M not a multiple of the 8 warps
# of a block, a ragged M at the flagship width, f32 above 1024 and the
# domain's edges (d = 8 and d = 8192)
LN_BWD_SHAPES = [(torch.bfloat16, 5120, 1024), (torch.float32, 128, 64),
                 (torch.bfloat16, 1003, 1792), (torch.bfloat16, 517, 1024),
                 (torch.float32, 333, 4096), (torch.float32, 77, 8),
                 (torch.bfloat16, 45, 8192), (torch.float32, 9, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,d", LN_BWD_SHAPES,
                         ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32],
                         ids=["scale_bf16", "scale_f32"])
def test_cuda_layer_norm_bwd_shapes(cuda_device, dtype, m, d, scale_dtype):
    x = _rand((m, d), 1, cuda_device, dtype, 2.0) + 0.3
    dy = _rand((m, d), 2, cuda_device, dtype)
    g = (_rand((d,), 3, cuda_device, torch.float32, 0.2) + 1.0).to(
        scale_dtype)
    reset_launches()
    got = _same_twice(layer_norm_bwd, x, g, dy)
    assert LAUNCHES["layer_norm_bwd"] == 2
    want = layer_norm_bwd_plain(x, g, dy)
    assert got[0].dtype == dtype
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for name, a, w in zip(("dscale", "dbias"), got[1:], want[1:]):
        assert a.dtype == torch.float32, name
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4, msg=name)


def _tiny_pair(cuda_device, overrides):
    """The same tiny model on the CPU and on the card: seeded weights, with
    the biases and LayerNorm scales perturbed so that a dropped term
    shows."""
    cfg = tiny_model_config(**overrides)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(torch.from_numpy(
                    0.05 * rng.standard_normal(p.shape)).to(p.dtype))
    card = copy.deepcopy(cpu).to(cuda_device)
    text = torch.from_numpy(rng.integers(1, cfg.vocab_text,
                                         (2, cfg.text_seq_len)))
    image = torch.from_numpy(rng.integers(0, cfg.vocab_image,
                                          (2, cfg.image_seq_len)))
    return cfg, cpu, card, text, image


TINY = {"tiny": dict(),
        "tiny_zoo_fused": dict(attn_types=("axial_row", "axial_col",
                                           "conv_like", "full"),
                               conv_kernel=3, ln_fusion=True,
                               ff_fusion="all")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_cuda_tiny_model_matches_cpu(cuda_device, name):
    """``tiny_model_config()`` (f32, head_dim 16) on the card, through the
    generic attention and GEGLU instances (and, fused, the LayerNorm
    kernels), against the plain versions on the CPU: the forward's loss and
    logits, then one ``grad_step``'s loss and every gradient."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card, text, image = _tiny_pair(cuda_device, TINY[name])
    tc, ic = text.to(cuda_device), image.to(cuda_device)
    with torch.no_grad():
        loss_c, _, logits_c = cpu(text, image, return_logits=True)
        reset_launches()
        loss_g, _, logits_g = card(tc, ic, return_logits=True)
    torch.testing.assert_close(loss_g.cpu(), loss_c, **MODEL_TOL)
    torch.testing.assert_close(logits_g.cpu(), logits_c, **MODEL_TOL)
    fwd_generic = dict(GENERIC_LAUNCHES)
    assert fwd_generic["line_attention"] > 0
    assert fwd_generic["window_attention"] > 0
    assert fwd_generic["geglu_ff"] > 0
    batch = {"text": text, "image": image}
    loss_c, _, grads_c = grad_step(cpu, batch)
    reset_launches()
    loss_g, _, grads_g = grad_step(card, {k: v.to(cuda_device)
                                          for k, v in batch.items()})
    for key in GENERIC_LAUNCHES:
        assert GENERIC_LAUNCHES[key] > 0, key
        assert GENERIC_LAUNCHES[key] == LAUNCHES[key], key
    if cfg.ln_fusion:
        assert LAUNCHES["layer_norm"] > 0 and LAUNCHES["layer_norm_bwd"] > 0
    torch.testing.assert_close(loss_g.cpu(), loss_c, **MODEL_TOL)
    assert grads_g.keys() == grads_c.keys()
    for key, g in grads_c.items():
        torch.testing.assert_close(grads_g[key].cpu(), g, msg=key,
                                   **MODEL_TOL)


# -- the serving slice on the card: no kernel, CUDA graphs ----------------

def _live_slots(runner, visible, seed):
    """Every slot live just below ``visible`` (at different positions),
    with random cache contents, inputs, seeds and per-slot knobs."""
    st, cfg = runner.state, runner.model.cfg
    s, dev = st.pos.shape[0], st.pos.device
    g = torch.Generator().manual_seed(seed)
    pos = [max(0, visible - runner.n_steps - 3 * i) for i in range(s)]
    st.pos.copy_(torch.tensor(pos))
    st.tokens.copy_(torch.randint(0, cfg.vocab_text, (s,), generator=g))
    st.seeds.copy_(torch.randint(0, 2 ** 62, (s,), generator=g))
    st.text.copy_(torch.randint(1, cfg.vocab_text, st.text.shape,
                                generator=g))
    st.temp.copy_(torch.tensor([1.0, 0.0, 0.7, 1.0] * s)[:s])
    st.top_k.copy_(torch.tensor([64, 0, 5, 0] * s)[:s])
    st.top_p.copy_(torch.tensor([1.0, 1.0, 0.9, 0.8] * s)[:s])
    for t in st.cache.values():
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_cuda_chunk_graph_equals_eager(cuda_device, name):
    """The engine's captured chunk against the same chunk run eagerly,
    bitwise, from the same live state, at every visible bucket: the tiny
    f32 config and the full-width flagship in bf16 (4 slots, 8 steps)."""
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import flagship_model_config
    from dalle_tpu_torch.models.decode import bucket_bounds
    from dalle_tpu_torch.serving.engine import ChunkRunner, init_state

    dev = resolve_device("cuda")
    cfg = (tiny_model_config(attn_types=("axial_row", "axial_col"), depth=2)
           if name == "tiny"
           else flagship_model_config(param_dtype="bfloat16"))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    bounds = bucket_bounds(cfg.total_seq_len, 4)
    runner = ChunkRunner(model, init_state(cfg, 4, dev), 8, bounds)
    runner.capture()
    assert sorted(runner.graphs) == bounds
    reset_launches()
    for i, visible in enumerate(bounds):
        _live_slots(runner, visible, i)
        assert runner.replay_equals_eager(visible) == [], visible
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_engine_greedy_codes_equal_cpu(cuda_device):
    """The tiny engine on the card (graph replays, 2 slots, staggered and
    recycled) gives the greedy codes the same weights give on the CPU."""
    import time

    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.config import ServingConfig
    from dalle_tpu_torch.models.decode import SamplingConfig
    from dalle_tpu_torch.serving.engine import DecodeEngine

    dev = resolve_device("cuda")
    cfg, cpu, card, _, _ = _tiny_pair(cuda_device, dict(
        attn_types=("axial_row", "axial_col"), depth=2))
    texts = [np.random.default_rng(i).integers(2, cfg.vocab_text,
                                               cfg.text_seq_len)
             for i in range(4)]
    rows = {}
    for where, model in (("cpu", cpu), ("cuda", card.to(dev))):
        engine = DecodeEngine(model, cfg, ServingConfig(
            n_slots=2, steps_per_call=4), sampling=SamplingConfig(0.0))
        engine.start()
        if where == "cuda":
            assert len(engine.runner.graphs) == engine.n_buckets
        try:
            handles = []
            for i, t in enumerate(texts):
                handles.append(engine.submit(t, i))
                time.sleep(0.01 * i)
            rows[where] = [h.result(timeout=120)["codes"] for h in handles]
        finally:
            engine.stop()
    for got, want in zip(rows["cuda"], rows["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_pixels_match_cpu(cuda_device):
    """VQGAN decode and CLIP scores on the card against the same weights
    on the CPU, in f32 (TF32 off), at 1e-4."""
    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.models import clip, vqgan

    dev = resolve_device("cuda")
    g = torch.Generator().manual_seed(0)
    vq_cpu = vqgan.init_params(vqgan.tiny_vqgan_config(), g)
    cl_cpu = clip.init_params(clip.tiny_clip_config(), g)
    codes = torch.randint(0, 64, (2, 16), generator=g)
    tokens = torch.randint(1, 63, (1, 12), generator=g)
    tokens[0, 6] = 63
    with torch.no_grad():
        want = vq_cpu(codes)
        got = copy.deepcopy(vq_cpu).to(dev)(codes.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    imgs = clip.resize_for_clip(vqgan.decode_codes(vq_cpu, codes),
                                cl_cpu.cfg)
    want = clip.clip_scores(cl_cpu, imgs, tokens)
    got = clip.clip_scores(copy.deepcopy(cl_cpu).to(dev), imgs.to(dev),
                           tokens.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
