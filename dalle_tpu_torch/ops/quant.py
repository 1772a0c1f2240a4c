"""Block-wise quantization: the 8-bit LAMB's dynamic-tree quantizer and the
swarm wire's linear u8/u4 quantizers, as CUDA kernels beside their plain
versions (counterpart of ``dalle_tpu/ops/quant.py`` and the TPU kernels of
``dalle_tpu/ops/pallas/quant_kernels.py``).

- :func:`quantize_blockwise` (``quantize_blockwise_pallas``): per block of
  ``block_size`` values (4096 in the 8-bit LAMB; any size >= 1, as the JAX
  package's XLA path takes) the absmax, and the index of the nearest entry
  of a 256-entry dynamic-tree codebook (sign bit, unary exponent, linear
  fraction; Dettmers et al. 2021) for ``x / absmax``, as the number of the
  255 float32 midpoints strictly below it: a value on a midpoint takes the
  lower code. The kernel finds it with one lookup in :func:`bucket_table`
  (a bucket of the value's float32 exponent and top mantissa bits, holding
  at most one midpoint) and one compare; the plain version with
  ``searchsorted``. :func:`dequantize_blockwise` is a
  256-entry gather, plain PyTorch (no kernel in the JAX package either; the
  TPU's select tree, a workaround for its slow gathers, is not ported).
- :func:`wire_quantize_u8` (``wire_quantize_u8_pallas``): per 256 values
  ``scale = absmax / 127`` and ``clip(rint(x / scale), -128, 127) + 128``,
  the wire format of ``swarm/compression.py``.
- :func:`wire_quantize_u4` (``wire_quantize_u4_pallas``): per 1024 values
  ``scale = absmax / 7`` and ``clip(rint(x / scale), -8, 7) + 8``, returned
  PACKED two per byte (low nibble first, a zero nibble after an odd n), as
  the wire carries them; the TPU kernel returns unpacked codes and the JAX
  codec packs them in a second pass.

All three kernels are in ``csrc/quant.cu``. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The plain versions
divide by tensors, never by a Python number: on the GPU PyTorch turns a
division by a scalar into a multiplication by its reciprocal, which differs
from the IEEE divide in the last bit for a few percent of values, and the
bytes must equal numpy's and XLA's.

One difference inside the JAX package itself: for a NaN ``x / absmax`` (a
NaN in the block, or +-inf over an infinite absmax) its XLA path's
``searchsorted`` sorts NaN last and gives code 255, while its Pallas kernel's
count gives 0. The port follows the kernel it replaces: 0, in the kernel
and in the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dalle_tpu_torch.ops import LAUNCHES, _build

DEFAULT_BLOCK = 4096
WIRE_QBLOCK = 256      # the u8 wire block (swarm/compression._QBLOCK)
WIRE_QBLOCK4 = 1024    # the u4 wire block (swarm/compression._QBLOCK4)


@functools.lru_cache(maxsize=8)
def dynamic_codebook(signed: bool = True) -> np.ndarray:
    """256-entry sorted float32 codebook in [-1, 1] (signed) or [0, 1]
    (unsigned): for exponent level e, magnitudes ``10**-e * linspace`` with
    ``2**(data_bits - 1 - e)`` linear steps, deduplicated and fitted to 256
    entries in float32 exactly as ``dalle_tpu.ops.quant.dynamic_codebook``
    does."""
    data_bits = 7 if signed else 8
    mags = [0.0]
    for e in range(data_bits):
        n = 2 ** (data_bits - 1 - e)
        if n == 0:
            break
        frac = (np.arange(n) + 1.0) / n
        mags.extend((10.0 ** -e) * frac)
    mags = np.asarray(sorted(set(mags)), dtype=np.float64)
    vals = np.concatenate([-mags[::-1], mags[1:]]) if signed else mags
    vals = np.unique(vals.astype(np.float32))
    while vals.size > 256:
        # drop the entry closest to zero (zero itself stays)
        nz = np.nonzero(vals)[0]
        vals = np.delete(vals, nz[np.argmin(np.abs(vals[nz]))])
    while vals.size < 256:
        # insert a midpoint into the widest gap
        i = int(np.argmax(np.diff(vals)))
        mid = np.float32(0.5 * (vals[i] + vals[i + 1]))
        if mid == vals[i] or mid == vals[i + 1]:
            break
        vals = np.insert(vals, i + 1, mid)
    assert vals.size == 256 and (np.diff(vals) > 0).all(), vals.size
    return vals


@functools.lru_cache(maxsize=8)
def codebook_midpoints(signed: bool = True) -> np.ndarray:
    """The 255 float32 decision boundaries between consecutive codebook
    entries: ``code(v) = #{k : v > mid_k}``."""
    cb = dynamic_codebook(signed)
    return (0.5 * (cb[:-1] + cb[1:])).astype(np.float32)


BUCKET_BITS = 6   # mantissa bits in a bucket's index
BUCKET_SHIFT = 23 - BUCKET_BITS   # passed to the kernel with lo and nb


@functools.lru_cache(maxsize=8)
def bucket_table(signed: bool = True) -> Tuple[np.ndarray, int]:
    """The ``quantize_blockwise`` kernel's codebook lookup, built from the
    float32 midpoints: ``(table, lo)`` with ``table`` (2, nb, 2) uint32.

    Bucket ``b`` of a value ``v`` is ``(bits(|v|) >> BUCKET_SHIFT) - lo``,
    clamped to [0, nb - 1], where ``lo`` is the bucket of the smallest
    nonzero |midpoint| and ``lo + nb - 1`` that of 1.0 (so that no |v| <= 1
    needs the upper clamp). The sign bit of ``v`` picks the row: 0 for
    ``v >= +0``, 1 for ``v <= -0``. Entry ``(mid, base)`` holds the float32
    bits of the one midpoint of that sign inside the bucket (+inf where
    there is none) and the count of midpoints below the bucket, so that
    ``code = base + (mid < v)`` is ``#{k : mid_k < v}`` for every non-NaN
    float32 (a NaN takes code 0 in the kernel): row 0's base counts the
    midpoints below the bucket's low edge, row 1's those at or below minus
    its high edge. Clamping is exact because no midpoint is 0 and none lies
    nearer 0 than bucket ``lo`` or beyond 1: zeros, subnormals and tiny
    magnitudes of either sign, -0.0 included, take the count of the
    negative midpoints, and magnitudes past 1 take 255 (positive) or 0."""
    mids = codebook_midpoints(signed)
    assert (mids != 0).all() and (np.diff(mids) > 0).all()
    assert (np.abs(mids) < 1).all()
    shift = BUCKET_SHIFT
    bucket = (np.abs(mids).view(np.uint32) >> shift).astype(np.int64)
    lo = int(bucket.min())
    nb = int(np.float32(1.0).view(np.uint32) >> shift) - lo + 1
    edges = ((np.arange(nb + 1, dtype=np.int64) + lo) << shift).astype(
        np.uint32).view(np.float32)            # bucket b is [edges[b], edges[b+1])
    table = np.empty((2, nb, 2), np.uint32)
    table[0, :, 1] = np.searchsorted(mids, edges[:-1], side="left")
    table[1, :, 1] = np.searchsorted(mids, -edges[1:], side="right")
    for row, sign in ((0, mids > 0), (1, mids < 0)):
        held = bucket[sign] - lo
        # the kernel compares a value with ONE midpoint of its bucket
        assert np.bincount(held, minlength=nb).max() <= 1
        mid = np.full(nb, np.inf, np.float32)
        mid[held] = mids[sign]
        table[row, :, 0] = mid.view(np.uint32)
    # -0.0 (row 1, bucket 0) takes +0.0's code (row 0, bucket 0)
    assert (table[1, 0, 1] + np.isfinite(table[1, 0, 0].view(np.float32))
            == table[0, 0, 1] == np.searchsorted(mids, 0.0))
    return table, lo


_TABLES: Dict[Tuple[str, bool, torch.device], torch.Tensor] = {}


def _table(kind: str, signed: bool, device: torch.device) -> torch.Tensor:
    """The codebook (f32), the midpoints (f32) or the kernel's bucket table
    (:func:`bucket_table`, int32 bits) as a tensor on ``device``, cached."""
    key = (kind, signed, device)
    if key not in _TABLES:
        if kind == "codebook":
            arr = dynamic_codebook(signed)
        elif kind == "midpoints":
            arr = codebook_midpoints(signed)
        else:
            arr = bucket_table(signed)[0].view(np.int32)
        _TABLES[key] = torch.from_numpy(arr.copy()).to(device)
    return _TABLES[key]


@dataclass(frozen=True)
class Quantized:
    """A block-quantized tensor: ``codes`` (n_blocks, block) u8, ``absmax``
    (n_blocks, 1) f32, the original ``shape`` and the codebook's sign."""

    codes: torch.Tensor
    absmax: torch.Tensor
    shape: Tuple[int, ...]
    signed: bool = True

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def to_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n_blocks, block_size) f32 blocking of ``x``, zero-padded at the
    tail."""
    flat = x.reshape(-1).float()
    n_blocks = -(-flat.numel() // block_size)
    pad = n_blocks * block_size - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n_blocks, block_size)


def quantize_blockwise_plain(x: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                             signed: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(codes (n_blocks, block) u8, absmax (n_blocks,
    1) f32)``. ``searchsorted`` (left) over the midpoints counts those
    strictly below the value; a NaN takes code 0, as the count does."""
    blocks = to_blocks(x, block_size)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    normed = blocks / scale
    codes = torch.searchsorted(_table("midpoints", signed, x.device), normed,
                               right=False)
    codes = torch.where(torch.isnan(normed), torch.zeros_like(codes), codes)
    return codes.to(torch.uint8), absmax


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"quantize_blockwise": [_P, _L, _I, _P, _I, _I, _I, _P, _P,
                                      _P],
               "wire_quantize_u8": [_P, _L, _P, _P, _P],
               "wire_quantize_u4": [_P, _L, _P, _P, _P]}


def _lib():
    lib = _build.load("quant")
    if not getattr(lib, "_typed", False):
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.quant_error.argtypes = [_I]
        lib.quant_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _cuda_input(what: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened, checked for what the kernels take: a contiguous,
    16-byte aligned f32 tensor on a GPU."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"{what}: x must be a contiguous, 16-byte aligned "
                         f"float32 tensor, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (strided)'} at "
                         f"offset {x.data_ptr() % 16}")
    return x.reshape(-1)


def _launch(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed: "
                           f"{_lib().quant_error(err).decode()}")


def quantize_blockwise(x: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                       signed: bool = True) -> Quantized:
    """Block-quantize ``x`` (``dalle_tpu.ops.quant.quantize_blockwise``),
    any ``block_size >= 1``. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/quant.cu`` (f32, contiguous, 16-byte aligned)."""
    if block_size < 1:
        raise ValueError(f"block_size must be at least 1, got {block_size}")
    shape = tuple(x.shape)
    if x.device.type == "cpu":
        codes, absmax = quantize_blockwise_plain(x, block_size, signed)
        return Quantized(codes, absmax, shape, signed)
    flat = _cuda_input("quantize_blockwise", x)
    if block_size > 2 ** 31 - 1:
        raise ValueError(f"quantize_blockwise: block_size {block_size} "
                         "exceeds the kernel's 32-bit block length")
    n = flat.numel()
    n_blocks = -(-n // block_size)
    codes = torch.empty((n_blocks, block_size), dtype=torch.uint8,
                        device=x.device)
    absmax = torch.empty((n_blocks, 1), dtype=torch.float32, device=x.device)
    if n:
        table = _table("buckets", signed, x.device)
        lo, nb = bucket_table(signed)[1], table.shape[1]
        _launch("quantize_blockwise", _lib().quantize_blockwise(
            flat.data_ptr(), n, block_size, table.data_ptr(), BUCKET_SHIFT,
            lo, nb, codes.data_ptr(), absmax.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream))
        LAUNCHES["quantize_blockwise"] += 1
    return Quantized(codes, absmax, shape, signed)


def dequantize_blockwise(q: Quantized) -> torch.Tensor:
    """``codebook[codes] * absmax``, cut back to the original shape (f32)."""
    vals = _table("codebook", q.signed, q.codes.device)[q.codes.long()]
    vals = vals * q.absmax
    return vals.reshape(-1)[:q.size].reshape(q.shape)


# -- the wire's linear quantizers ---------------------------------------


def _wire_plain(x: torch.Tensor, block: int, divisor: float, lo: float,
                hi: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpacked codes (n,) u8 and scales (n_blocks,) f32, in the op order of
    ``compression.compress_u8``/``compress_u4``."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    blocks = to_blocks(flat, block)
    scales = blocks.abs().amax(dim=1) / torch.full(
        (1,), divisor, dtype=torch.float32, device=flat.device)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(blocks / safe[:, None]), lo, hi) - lo
    return q.to(torch.uint8).reshape(-1)[:n], scales


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Two u4 codes a byte, low nibble first; an odd tail packs a zero."""
    if codes.numel() % 2:
        codes = F.pad(codes, (0, 1))
    return codes[0::2] | (codes[1::2] << 4)


def wire_quantize_u8_plain(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(codes (n,) u8, scales (ceil(n/256),) f32)``."""
    return _wire_plain(x, WIRE_QBLOCK, 127.0, -128.0, 127.0)


def wire_quantize_u4_plain(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(packed (ceil(n/2),) u8, scales
    (ceil(n/1024),) f32)``."""
    codes, scales = _wire_plain(x, WIRE_QBLOCK4, 7.0, -8.0, 7.0)
    return pack_nibbles(codes), scales


def _wire(name: str, x: torch.Tensor, block: int, code_bytes) -> Tuple[
        torch.Tensor, torch.Tensor]:
    flat = _cuda_input(name, x)
    n = flat.numel()
    codes = torch.empty((code_bytes(n),), dtype=torch.uint8, device=x.device)
    scales = torch.empty((-(-n // block),), dtype=torch.float32,
                         device=x.device)
    if n:
        lib = _lib()
        _launch(name, getattr(lib, name)(
            flat.data_ptr(), n, codes.data_ptr(), scales.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream))
        LAUNCHES[name] += 1
    return codes, scales


def wire_quantize_u8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes (n,) u8, scales (ceil(n/256),) f32)`` of ``x`` flattened,
    the u8 wire codec's quantize half. CPU tensors take the plain version;
    CUDA tensors launch ``csrc/quant.cu`` (f32, contiguous, 16-byte
    aligned)."""
    if x.device.type == "cpu":
        return wire_quantize_u8_plain(x)
    return _wire("wire_quantize_u8", x, WIRE_QBLOCK, lambda n: n)


def wire_quantize_u4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(packed codes (ceil(n/2),) u8, scales (ceil(n/1024),) f32)`` of
    ``x`` flattened, the u4 wire codec's quantize half with its nibble
    pack. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/quant.cu``."""
    if x.device.type == "cpu":
        return wire_quantize_u4_plain(x)
    return _wire("wire_quantize_u4", x, WIRE_QBLOCK4, lambda n: (n + 1) // 2)
