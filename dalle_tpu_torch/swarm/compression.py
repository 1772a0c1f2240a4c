"""Wire compression codecs for swarm averaging: the port's own numpy copy
of ``dalle_tpu/swarm/compression.py``, the bytes every peer puts on the
wire. ``tests/test_torch_codec.py`` holds it byte-identical to the JAX
package's module.

The reference's choice (learning-at-home/dalle task.py:12,125-126) is
``SizeAdaptiveCompression(threshold=2**16 + 1, less=Float16Compression(),
greater_equal=Uniform8BitQuantization())``: tensors of at least 65537
elements go as u8, smaller ones as f16. (The 8-bit LAMB quantizes moments
from 65536 elements, ``optim/lamb8bit.py``: the two thresholds differ by
one.)

Formats: u8 is a BIG-endian u32 element count, ceil(n/256) native-endian
f32 scales (absmax / 127), then n codes (128 is zero); u4 is the same
header, ceil(n/1024) scales (absmax / 7), then ceil(n/2) bytes of nibble
pairs, low nibble first (8 is zero; an odd n pads a zero nibble). Both
round half to even (``np.rint``). :func:`pack_array` adds a one-byte codec
id and the element count, so a stream can mix codecs per tensor.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

# codec ids (wire stable)
NONE = 0
FLOAT16 = 1
UNIFORM8BIT = 2
UNIFORM4BIT = 3

#: elements >= this threshold use 8-bit, below it fp16 (task.py:125-126)
SIZE_ADAPTIVE_THRESHOLD = 2 ** 16 + 1

_QBLOCK = 256
#: u4 quantization block. Larger than u8's 256 so the per-block f32
#: scale overhead shrinks with the payload: u4 wire bytes are
#: n/2 + 4*ceil(n/1024) ~ 0.504n vs u8's n + 4*ceil(n/256) ~ 1.016n.
_QBLOCK4 = 1024


def codec_for_bits(bits: "int | None") -> "int | None":
    """CollabConfig.wire_bits_* knob -> codec id (None passes through):
    the one mapping every consumer of the knob shares."""
    if bits is None:
        return None
    if bits == 8:
        return UNIFORM8BIT
    if bits == 4:
        return UNIFORM4BIT
    raise ValueError(f"wire_bits must be None, 4 or 8 (got {bits!r})")


def codec_block(codec: int) -> int:
    """Quantization block of ``codec`` in elements (1 for the
    unblocked codecs): wire chunk boundaries must be multiples of this
    for whole-part encodes to slice per chunk (device_codec)."""
    if codec == UNIFORM8BIT:
        return _QBLOCK
    if codec == UNIFORM4BIT:
        return _QBLOCK4
    return 1


def compress_f16(x: np.ndarray) -> bytes:
    x = np.asarray(x, np.float32)
    f16 = np.clip(x, np.finfo(np.float16).min, np.finfo(np.float16).max)
    return f16.astype(np.float16).tobytes()


def decompress_f16(buf: bytes, n: int) -> np.ndarray:
    return np.frombuffer(buf, np.float16, count=n).astype(np.float32)


def compress_u8(x: np.ndarray) -> bytes:
    """Block-wise symmetric uniform quantization to uint8.

    Layout: u32 n, then ceil(n/256) fp32 scales, then n uint8 codes
    (code 128 = zero, scale = max|x| per block / 127).

    The quantize chain runs in place on one padded working copy.
    """
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    pad = (-n) % _QBLOCK
    padded = np.pad(flat, (0, pad)).reshape(-1, _QBLOCK)  # working copy
    scales = np.abs(padded).max(axis=1)
    scales /= 127.0
    safe = np.where(scales > 0, scales, 1.0)
    np.divide(padded, safe[:, None], out=padded)
    np.rint(padded, out=padded)
    np.clip(padded, -128.0, 127.0, out=padded)
    padded += 128.0
    codes = padded.astype(np.uint8)
    return (struct.pack(">I", n) + scales.astype(np.float32).tobytes()
            + codes.reshape(-1)[:n].tobytes())


def decompress_u8(buf: bytes) -> np.ndarray:
    (n,) = struct.unpack(">I", buf[:4])
    nblocks = (n + _QBLOCK - 1) // _QBLOCK
    scales = np.frombuffer(buf, np.float32, count=nblocks, offset=4)
    codes = np.frombuffer(buf, np.uint8, count=n, offset=4 + 4 * nblocks)
    pad = nblocks * _QBLOCK - n
    out = codes.astype(np.float32)   # the one working copy
    out -= 128.0
    padded = np.pad(out, (0, pad)) if pad else out
    padded = padded.reshape(nblocks, _QBLOCK)
    padded *= scales[:, None]
    return padded.reshape(-1)[:n]


def compress_u4(x: np.ndarray) -> bytes:
    """Block-wise symmetric uniform quantization to 4-bit nibbles.

    Layout: u32 n, then ceil(n/1024) fp32 scales, then ceil(n/2) bytes
    of packed codes — two per byte, low nibble first (code 8 = zero,
    scale = max|x| per block / 7; an odd tail pads nibble 0, sliced off
    at decode). Same op sequence as the u8 codec, which the device codec
    (swarm/device_codec.py) repeats byte for byte.
    """
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    pad = (-n) % _QBLOCK4
    padded = np.pad(flat, (0, pad)).reshape(-1, _QBLOCK4)  # working copy
    scales = np.abs(padded).max(axis=1)
    scales /= 7.0
    safe = np.where(scales > 0, scales, 1.0)
    np.divide(padded, safe[:, None], out=padded)
    np.rint(padded, out=padded)
    np.clip(padded, -8.0, 7.0, out=padded)
    padded += 8.0
    codes = padded.astype(np.uint8).reshape(-1)[:n]
    if n % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    packed = codes[0::2] | (codes[1::2] << 4)
    return (struct.pack(">I", n) + scales.astype(np.float32).tobytes()
            + packed.tobytes())


def decompress_u4(buf: bytes) -> np.ndarray:
    (n,) = struct.unpack(">I", buf[:4])
    nblocks = (n + _QBLOCK4 - 1) // _QBLOCK4
    scales = np.frombuffer(buf, np.float32, count=nblocks, offset=4)
    packed = np.frombuffer(buf, np.uint8, count=(n + 1) // 2,
                           offset=4 + 4 * nblocks)
    codes = np.empty(2 * packed.size, np.uint8)
    codes[0::2] = packed & 0x0F
    codes[1::2] = packed >> 4
    out = codes[:n].astype(np.float32)   # the one working copy
    out -= 8.0
    pad = nblocks * _QBLOCK4 - n
    padded = np.pad(out, (0, pad)) if pad else out
    padded = padded.reshape(nblocks, _QBLOCK4)
    padded *= scales[:, None]
    return padded.reshape(-1)[:n]


def quant_payload_valid(buf: bytes, codec: int, n: int) -> bool:
    """Structural validity of a u8/u4 wire payload for ``n`` elements
    without decoding it (every byte is a valid code for these codecs, so
    header and length checks are exactly as strict as a decode). The
    fused device accumulate (device_codec.py) takes validated payloads."""
    if codec not in (UNIFORM8BIT, UNIFORM4BIT):
        return False
    if len(buf) < 4:
        return False
    (n_hdr,) = struct.unpack(">I", buf[:4])
    if n_hdr != n:
        return False
    block = codec_block(codec)
    nblocks = (n + block - 1) // block
    code_bytes = n if codec == UNIFORM8BIT else (n + 1) // 2
    return len(buf) >= 4 + 4 * nblocks + code_bytes


def adaptive_codec(n_elements: int,
                   threshold: int = SIZE_ADAPTIVE_THRESHOLD) -> int:
    """SizeAdaptiveCompression dispatch (reference task.py:125-126)."""
    return UNIFORM8BIT if n_elements >= threshold else FLOAT16


def compress(x: np.ndarray, codec: int) -> bytes:
    if codec == NONE:
        return np.asarray(x, np.float32).tobytes()
    if codec == FLOAT16:
        return compress_f16(x)
    if codec == UNIFORM8BIT:
        return compress_u8(x)
    if codec == UNIFORM4BIT:
        return compress_u4(x)
    raise ValueError(f"unknown codec {codec}")


def decompress(buf: bytes, codec: int, n: int) -> np.ndarray:
    if codec == NONE:
        return np.frombuffer(buf, np.float32, count=n).copy()
    if codec == FLOAT16:
        return decompress_f16(buf, n)
    if codec == UNIFORM8BIT:
        out = decompress_u8(buf)
        if out.size != n:
            raise ValueError(f"decoded {out.size} elements, expected {n}")
        return out
    if codec == UNIFORM4BIT:
        out = decompress_u4(buf)
        if out.size != n:
            raise ValueError(f"decoded {out.size} elements, expected {n}")
        return out
    raise ValueError(f"unknown codec {codec}")


def pack_array(x: np.ndarray, codec: int) -> bytes:
    """Self-describing frame: u8 codec, u32 n_elements, payload."""
    flat = np.asarray(x, np.float32).reshape(-1)
    return struct.pack(">BI", codec, flat.size) + compress(flat, codec)


def unpack_array(buf: bytes) -> Tuple[np.ndarray, int]:
    """-> (flat float32 array, codec used)."""
    codec, n = struct.unpack(">BI", buf[:5])
    return decompress(buf[5:], codec, n), codec
