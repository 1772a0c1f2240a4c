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
"""

import pytest
import torch

from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.ops.attention import (line_attention,
                                           line_attention_bwd,
                                           line_attention_bwd_plain,
                                           line_attention_plain,
                                           window_attention,
                                           window_attention_bwd,
                                           window_attention_bwd_plain,
                                           window_attention_plain)
from dalle_tpu_torch.ops.geglu import (geglu_ff, geglu_ff_bwd,
                                       geglu_ff_bwd_plain, geglu_ff_plain)
from dalle_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                            layer_norm_bwd_plain,
                                            layer_norm_plain)
from dalle_tpu_torch.ops.quant import (quantize_blockwise,
                                       quantize_blockwise_plain,
                                       wire_quantize_u4,
                                       wire_quantize_u4_plain,
                                       wire_quantize_u8,
                                       wire_quantize_u8_plain)

BF16 = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU "
                    "mode; tests/test_torch_ops.py covers their plain "
                    "versions")
    return torch.device("cuda")


def _bf16(shape, seed, device, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16).to(
        device)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 3 * 4096 + 1000, 129, 70001])
@pytest.mark.parametrize("signed", [True, False])
def test_cuda_quantize_blockwise_kernel(cuda_device, n, signed):
    x = _quant_input(n, n, cuda_device)
    if not signed:
        x = x.abs()
    for block in (4096, 128, 1152):
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
