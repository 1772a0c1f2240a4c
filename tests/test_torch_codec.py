"""The port's swarm wire codec against the JAX package's
(dalle_tpu_torch/swarm/compression.py, device_codec.py, error_feedback.py).

The port's ``compression`` is a numpy copy, held byte-identical to
``dalle_tpu.swarm.compression`` for every codec. Its ``device_codec`` runs
here on CPU tensors, i.e. through the plain versions of the wire kernels,
and is held byte-identical to the JAX ``device_codec`` (its XLA path) and
to the Pallas wire kernels in interpret mode, as tests/test_device_codec.py
runs them. Everything is exact: the wire has no tolerance.

Pitfalls the data pins: the u8/u4 header is a BIG-endian u32 and the
scales native-endian f32; rounding is half to even, so blocks whose scale
is a power of two carry values on exact half multiples of it; ragged tails
and odd sizes (the u4 pad nibble); the size-adaptive codec takes u8 from
65537 elements (one more than the 8-bit LAMB's 65536).
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.ops.pallas.quant_kernels import (wire_quantize_u4_pallas,
                                                wire_quantize_u8_pallas)
from dalle_tpu.swarm import compression as jcomp
from dalle_tpu.swarm import device_codec as jdc
from dalle_tpu.swarm import error_feedback as jef
from dalle_tpu_torch.ops import LAUNCHES, reset_launches
from dalle_tpu_torch.ops import quant as tquant
from dalle_tpu_torch.swarm import compression as tcomp
from dalle_tpu_torch.swarm import device_codec as tdc
from dalle_tpu_torch.swarm import error_feedback as tef

torch.set_num_threads(2)

U8, U4, F16 = tcomp.UNIFORM8BIT, tcomp.UNIFORM4BIT, tcomp.FLOAT16
CODECS = [tcomp.NONE, F16, U8, U4]
SIZES = [1, 5, 255, 256, 257, 1023, 1024, 1025, 2 ** 16, 2 ** 16 + 7]


def _payload(n, seed=0):
    """Mixed magnitudes, exact zeros, and two blocks of exact ties: a u8
    block whose absmax is 127 * 2^-3 (scale 2^-3) and a u4 block whose
    absmax is 7 * 2^-2 (scale 2^-2), each holding (k + 0.5) * scale."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * rng.choice([1e-6, 1.0, 100.0], size=n)
         ).astype(np.float32)
    x[: n // 3] = 0.0
    if n >= 2048:
        k = np.arange(-127, 127, dtype=np.float32)
        x[256:256 + k.size] = (k + 0.5) * np.float32(2 ** -3)
        x[256 + k.size] = 127 * 2 ** -3
        x[1024:1038] = (np.arange(-7, 7, dtype=np.float32) + 0.5) * 0.25
        x[1038] = 7 * 0.25
    return x


def test_constants_and_small_helpers_equal_jax():
    for name in ("NONE", "FLOAT16", "UNIFORM8BIT", "UNIFORM4BIT",
                 "SIZE_ADAPTIVE_THRESHOLD", "_QBLOCK", "_QBLOCK4"):
        assert getattr(tcomp, name) == getattr(jcomp, name), name
    assert tcomp.SIZE_ADAPTIVE_THRESHOLD == 65537
    assert tquant.WIRE_QBLOCK == tcomp._QBLOCK
    assert tquant.WIRE_QBLOCK4 == tcomp._QBLOCK4
    for bits in (None, 4, 8):
        assert tcomp.codec_for_bits(bits) == jcomp.codec_for_bits(bits)
    with pytest.raises(ValueError):
        tcomp.codec_for_bits(2)
    for codec in CODECS:
        assert tcomp.codec_block(codec) == jcomp.codec_block(codec)
    for n in (0, 65536, 65537, 10 ** 6):
        assert tcomp.adaptive_codec(n) == jcomp.adaptive_codec(n)
    assert tcomp.adaptive_codec(65536) == F16
    assert tcomp.adaptive_codec(65537) == U8
    assert tdc.resolve_backend("host") == "host"
    auto = "device" if torch.cuda.is_available() else "host"
    assert tdc.resolve_backend("auto") == auto
    with pytest.raises(ValueError):
        tdc.resolve_backend("gpu")


@pytest.mark.parametrize("codec", CODECS)
def test_compression_bytes_equal_jax(codec):
    """Host compress, decompress, pack_array/unpack_array and
    quant_payload_valid of the port's copy against the JAX package's."""
    for n in SIZES:
        x = _payload(n, seed=n)
        buf = tcomp.compress(x, codec)
        assert buf == jcomp.compress(x, codec), n
        got = tcomp.decompress(buf, codec, n)
        assert got.tobytes() == jcomp.decompress(buf, codec, n).tobytes(), n
        framed = tcomp.pack_array(x, codec)
        assert framed == jcomp.pack_array(x, codec), n
        arr, c = tcomp.unpack_array(framed)
        assert c == codec and arr.tobytes() == got.tobytes()
        if codec in (U8, U4):
            assert struct.unpack(">I", buf[:4])[0] == n   # big-endian count
            for cut in (buf, buf[:-1], buf[:3]):
                assert (tcomp.quant_payload_valid(cut, codec, n)
                        == jcomp.quant_payload_valid(cut, codec, n))
            assert tcomp.quant_payload_valid(buf, codec, n)
            assert not tcomp.quant_payload_valid(buf, codec, n + 1)


@pytest.mark.parametrize("codec", CODECS)
def test_device_codec_bytes_equal_jax_device_codec(codec):
    """The port's device codec (CPU tensors: the kernels' plain versions)
    against the JAX device codec, both directions, and the host codec."""
    for n in SIZES:
        x = _payload(n, seed=n + 1)
        want = jcomp.compress(x, codec)
        assert tdc.compress(torch.from_numpy(x), codec) == want, n
        assert tdc.compress(x, codec) == want, n
        assert jdc.compress(jnp.asarray(x), codec) == want, n
        got = tdc.decompress(want, codec, n, device=torch.device("cpu"))
        assert got.tobytes() == jdc.decompress(want, codec, n).tobytes(), n
    if codec in (U8, U4):
        with pytest.raises(ValueError, match="expected 301"):
            tdc.decompress(tcomp.compress(_payload(300), codec), codec, 301,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("codec", [U8, U4])
def test_wire_plain_versions_equal_pallas_and_xla(codec):
    """The plain versions of the wire kernels against the Pallas kernels in
    interpret mode and JAX's XLA encodes, on 10,007 values with ties."""
    x = _payload(10_007, seed=6)
    reset_launches()
    if codec == U8:
        codes, scales = tquant.wire_quantize_u8(torch.from_numpy(x))
        pal_codes, pal_scales = wire_quantize_u8_pallas(jnp.asarray(x),
                                                        interpret=True)
        xla_codes, xla_scales = jdc._enc_u8_xla(jnp.asarray(x))
    else:
        codes, scales = tquant.wire_quantize_u4(torch.from_numpy(x))
        pal_codes, pal_scales = wire_quantize_u4_pallas(jnp.asarray(x),
                                                        interpret=True)
        pal_codes = jdc._pack_nibbles(pal_codes)
        xla_codes, xla_scales = jdc._enc_u4_xla(jnp.asarray(x))
    assert not any(LAUNCHES.values())
    assert codes.dtype == torch.uint8 and scales.dtype == torch.float32
    for want_c, want_s in ((pal_codes, pal_scales), (xla_codes, xla_scales)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    # the tie block (block 1 of either codec) rounds half to even
    if codec == U8:
        assert scales[1].item() == 2.0 ** -3
        k = np.arange(-127, 127, dtype=np.float32)
        np.testing.assert_array_equal(codes[256:256 + k.size].numpy(),
                                      np.rint(k + 0.5) + 128)
    else:
        assert scales[1].item() == 0.25
        k = np.arange(-7, 7, dtype=np.float32)
        want = (np.rint(k + 0.5) + 8).astype(np.uint8)
        np.testing.assert_array_equal(codes[512:519].numpy(),
                                      want[0::2] | (want[1::2] << 4))


@pytest.mark.parametrize("codec", [U8, U4])
def test_part_payload_decode_and_encode_part(codec):
    """``encode_part`` of a slice of the flat vector, framed per chunk by
    ``part_payload``: each chunk's bytes equal ``compress`` of that chunk;
    ``part_decode`` and ``decoded_dev`` equal the host decode, and JAX's."""
    chunk = 4 * 1024
    n = 5 * chunk + 777          # a ragged, odd last chunk
    flat = tdc.flatten_device([torch.from_numpy(_payload(n - 3000, 1)),
                               _payload(3000, 2)])
    assert flat.shape == (n,) and flat.dtype == torch.float32
    lo, hi = 2048, n
    host = flat.numpy()[lo:hi]
    enc = tdc.encode_part(flat, lo, hi, codec)
    jenc = jdc.encode_part(jnp.asarray(flat.numpy()), lo, hi, codec)
    m = hi - lo
    for clo in range(0, m, chunk):
        chi = min(m, clo + chunk)
        payload = tdc.part_payload(enc, clo, chi)
        assert payload == jcomp.compress(host[clo:chi], codec), clo
        assert payload == jdc.part_payload(jenc, clo, chi), clo
        np.testing.assert_array_equal(
            tdc.part_decode(enc, clo, chi),
            jcomp.decompress(payload, codec, chi - clo))
    dec = enc.decoded_dev()
    assert dec.numpy().tobytes() == np.asarray(jenc.decoded_dev()).tobytes()
    assert dec.numpy().tobytes() == jcomp.decompress(
        jcomp.compress(host, codec), codec, m).tobytes()
    with pytest.raises(ValueError, match="quant block"):
        tdc.part_payload(enc, 100, 200)
    with pytest.raises(ValueError, match="unsupported"):
        tdc.encode_part(flat, 0, 10, F16)


@pytest.mark.parametrize("codec", [U8, U4])
def test_fused_accumulate_bitwise_equals_host_arithmetic(codec):
    """The owner's seed ``part * w0`` and three senders' payloads with
    distinct weights folded in: bitwise the host's decode-then-``* w``-then-
    ``+=`` (two roundings), and JAX's fused accumulate."""
    chunk = 4096
    n = 3 * chunk + 1001
    own = _payload(n, seed=10)
    weights = [0.3, 0.7, 1.0 / 3.0]
    senders = [_payload(n, seed=11 + i) for i in range(3)]
    acc = tdc.accumulator_init(torch.from_numpy(own), 0, n, 0.25)
    jacc = jdc.accumulator_init(jnp.asarray(own), 0, n, 0.25)
    want = own * np.float32(0.25)
    for x, w in zip(senders, weights):
        payloads = [tcomp.compress(x[c:c + chunk], codec)
                    for c in range(0, n, chunk)]
        assert all(tcomp.quant_payload_valid(p, codec, len(x[c:c + chunk]))
                   for p, c in zip(payloads, range(0, n, chunk)))
        acc = tdc.fused_accumulate(acc, payloads, codec, n, w)
        jacc = jdc.fused_accumulate(jacc, payloads, codec, n, w)
        dec = np.concatenate([tcomp.decompress(p, codec, len(x[c:c + chunk]))
                              for p, c in zip(payloads, range(0, n, chunk))])
        want = want + dec * np.float32(w)
    assert acc.numpy().tobytes() == want.tobytes()
    assert acc.numpy().tobytes() == np.asarray(jacc).tobytes()
    extra = _payload(n, seed=20) * np.float32(0.5)
    acc = tdc.add_contrib(acc, extra)
    assert acc.numpy().tobytes() == (want + extra).tobytes()


def test_error_feedback_matches_jax():
    """Two scatter rounds on tensors (u4 parts decoded on the device, the
    own part raw) and two gather rounds on host slices: the residuals
    bitwise equal to the JAX ErrorFeedback's on host arrays."""
    n, own = 4 * 1024 + 300, (1024, 2048)
    scatter, gather = tef.make_pair()
    jscatter, jgather = jef.make_pair()
    for r in range(2):
        grad = _payload(n, seed=30 + r)
        comp = scatter.compensate(torch.from_numpy(grad.copy()))
        jcomp_ = jscatter.compensate(grad.copy())
        assert comp.numpy().tobytes() == jcomp_.tobytes()
        bounds = [(0, own[0]), own, (own[1], n)]
        segs, jsegs = [], []
        for lo, hi in bounds:
            if (lo, hi) == own:
                segs.append(comp[lo:hi].clone())
                jsegs.append(jcomp_[lo:hi])
            else:
                segs.append(tdc.encode_part(comp, lo, hi, U4).decoded_dev())
                jsegs.append(jcomp.decompress(
                    jcomp.compress(jcomp_[lo:hi], U4), U4, hi - lo))
        scatter.store(comp, segs)
        jscatter.store(jcomp_, jsegs)
        assert (scatter.residual_host().tobytes()
                == jscatter.residual_host().tobytes())
        part = _payload(own[1] - own[0], seed=40 + r)
        got = gather.compensate_slice(part, *own, n)
        want = jgather.compensate_slice(part, *own, n)
        assert got.tobytes() == want.tobytes()
        dec = jcomp.decompress(jcomp.compress(got, U4), U4, got.size)
        gather.store_slice(got, dec, *own, n)
        jgather.store_slice(want, dec, *own, n)
        assert (gather.residual_host().tobytes()
                == jgather.residual_host().tobytes())
    assert scatter.rounds == gather.rounds == 2
    assert scatter.lost_rounds == 0
    scatter.compensate(torch.zeros(n))
    scatter.compensate(torch.zeros(n))       # no store between: one lost
    assert scatter.lost_rounds == 1
