"""The swarm wire codec's device half: quantize and dequantize a trainer
peer's gradients on the GPU, and leave the host to frame and ship bytes
(counterpart of ``dalle_tpu/swarm/device_codec.py``).

**Byte compatibility is the contract.** Every function here produces and
consumes the wire format of :mod:`dalle_tpu_torch.swarm.compression`
(identical to the JAX package's), so peers of either codec and either
framework interoperate chunk by chunk. The u8 and u4 encodes are the
``wire_quantize_u8``/``wire_quantize_u4`` kernels (``csrc/quant.cu``; on the
CPU their plain versions), whose IEEE divide, round-half-even and clip give
numpy's bytes. The decodes are plain PyTorch in numpy's op order:
``(codes - 128) * scale`` (u4: ``- 8``), which is exact up to the one
rounding of the multiply on both sides.

**Whole-part encode.** :func:`encode_part` quantizes one all-reduce part
in one kernel launch and returns an :class:`EncodedPart` that keeps the
packed codes and scales on the device. :func:`part_payload` pulls them to
the host once and frames each wire chunk by byte slicing (chunk boundaries
are multiples of the quant block, so the part's blocks are the chunks'
blocks); :func:`part_decode` and :meth:`EncodedPart.decoded_dev` give the
values every receiver of those bytes decodes.

**Fused accumulate.** :func:`fused_accumulate` folds one sender's complete
contribution into the part owner's f32 accumulator on the device:
``acc += decode(payloads) * w``. The multiply and the add are two separate
operations, never one fused multiply-add: the host path rounds twice, and
an FMA rounds once, which would flip low bits against peers that
accumulate on the host and against the audit's replay. (Eager PyTorch runs
them as two launches; a kernel that fuses them must use
``__fmul_rn``/``__fadd_rn``.)

Device: tensors stay where they are; host input (numpy, bytes) goes to
:func:`default_device`, the GPU when there is one, the counterpart of
``jax.default_backend()`` in the JAX codec.
"""

from __future__ import annotations

import struct
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from dalle_tpu_torch.ops.quant import (WIRE_QBLOCK, WIRE_QBLOCK4,
                                       wire_quantize_u4, wire_quantize_u8)
from dalle_tpu_torch.swarm import compression

_F16_MIN = float(np.finfo(np.float16).min)
_F16_MAX = float(np.finfo(np.float16).max)


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_backend(name: Optional[str]) -> str:
    """A config value as a concrete codec backend: ``auto`` (or None) is
    ``device`` when a GPU is present (the JAX codec: when the backend is a
    TPU) and ``host`` otherwise."""
    if name in (None, "auto"):
        return "device" if torch.cuda.is_available() else "host"
    if name not in ("host", "device"):
        raise ValueError(f"unknown wire codec backend {name!r}")
    return name


def _as_flat_f32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` as a flat, contiguous, 16-byte aligned f32 tensor (the wire
    kernels' input). A tensor stays on its device (copied only when it is
    not already such a tensor); anything else goes to ``device`` or
    :func:`default_device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        x = x.to(device or default_device())
    flat = x.reshape(-1).to(torch.float32).contiguous()
    if flat.data_ptr() % 16:
        flat = flat.clone()
    return flat


def _dec_u8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``(codes - 128) * scale`` per 256-block, in f32."""
    n, n_blocks = codes.numel(), scales.numel()
    c = codes.to(torch.float32) - 128.0
    c = torch.nn.functional.pad(c, (0, n_blocks * WIRE_QBLOCK - n))
    return (c.reshape(n_blocks, WIRE_QBLOCK) * scales[:, None]).reshape(-1)[:n]


def _dec_u4(packed: torch.Tensor, scales: torch.Tensor, n: int
            ) -> torch.Tensor:
    """Unpack the nibble pairs, then ``(code - 8) * scale`` per 1024-block."""
    n_blocks = scales.numel()
    codes = torch.stack([packed & 0x0F, packed >> 4], dim=1).reshape(-1)[:n]
    c = codes.to(torch.float32) - 8.0
    c = torch.nn.functional.pad(c, (0, n_blocks * WIRE_QBLOCK4 - n))
    return (c.reshape(n_blocks, WIRE_QBLOCK4)
            * scales[:, None]).reshape(-1)[:n]


def _enc_f16(flat: torch.Tensor) -> torch.Tensor:
    return torch.clamp(flat, _F16_MIN, _F16_MAX).to(torch.float16)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_host(t: torch.Tensor) -> np.ndarray:
    """A writable host copy of ``t``. A GPU tensor is copied into a pinned
    buffer on the current stream, and only that copy is waited for."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.cpu().numpy().copy()
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return pinned.numpy()


def flatten_device(tensors: Sequence) -> torch.Tensor:
    """All tensors flattened and cast to f32 in one ``torch.cat`` on their
    device, without a host pull. Host arrays among them go to the device
    of the first tensor (or :func:`default_device`)."""
    device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                  default_device())
    leaves = [(t if isinstance(t, torch.Tensor)
               else torch.from_numpy(np.asarray(t))).to(device).reshape(-1)
              .to(torch.float32) for t in tensors]
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.cat(leaves)


# -- single-buffer wire codec (registry entries) -------------------------

def _frame(n: int, scales: torch.Tensor, codes: torch.Tensor) -> bytes:
    return (struct.pack(">I", n) + _host(scales).tobytes()
            + _host(codes).tobytes())


def compress(x, codec: int) -> bytes:
    """The device twin of :func:`compression.compress`: the same bytes;
    ``x`` may be a tensor (no host pull of its floats) or a host array."""
    if codec == compression.NONE:
        if isinstance(x, torch.Tensor):
            x = _host(x.to(torch.float32))
        return np.asarray(x, np.float32).tobytes()
    flat = _as_flat_f32(x)
    if codec == compression.FLOAT16:
        return _host(_enc_f16(flat)).tobytes()
    if codec == compression.UNIFORM8BIT:
        codes, scales = wire_quantize_u8(flat)
        return _frame(flat.numel(), scales, codes)
    if codec == compression.UNIFORM4BIT:
        packed, scales = wire_quantize_u4(flat)
        return _frame(flat.numel(), scales, packed)
    raise ValueError(f"unknown codec {codec}")


def _parse(buf: bytes, codec: int):
    """(n, scales, codes) numpy views of a u8/u4 payload."""
    (n,) = struct.unpack(">I", buf[:4])
    block = compression.codec_block(codec)
    n_blocks = (n + block - 1) // block
    scales = np.frombuffer(buf, np.float32, count=n_blocks, offset=4)
    count = n if codec == compression.UNIFORM8BIT else (n + 1) // 2
    codes = np.frombuffer(buf, np.uint8, count=count, offset=4 + 4 * n_blocks)
    return n, scales, codes


def _to(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr.copy()).to(device)


def decompress(buf: bytes, codec: int, n: int,
               device: Optional[torch.device] = None) -> np.ndarray:
    """The device twin of :func:`compression.decompress`: parses the header
    on the host, dequantizes on ``device`` (default: :func:`default_device`)
    and returns host f32."""
    device = device or default_device()
    if codec == compression.NONE:
        return np.frombuffer(buf, np.float32, count=n).copy()
    if codec == compression.FLOAT16:
        h = np.frombuffer(buf, np.float16, count=n)
        return _host(_to(h, device).to(torch.float32))
    if codec in (compression.UNIFORM8BIT, compression.UNIFORM4BIT):
        n_hdr, scales, codes = _parse(buf, codec)
        scales, codes = _to(scales, device), _to(codes, device)
        out = _host(_dec_u8(codes, scales)
                    if codec == compression.UNIFORM8BIT
                    else _dec_u4(codes, scales, n_hdr))
        if out.size != n:
            raise ValueError(f"decoded {out.size} elements, expected {n}")
        return out
    raise ValueError(f"unknown codec {codec}")


# -- whole-part encode for the all-reduce hot path -----------------------

class EncodedPart:
    """A u8- or u4-quantized all-reduce part: the device buffers of one
    encode, pulled to the host at most once (under a lock: chunk producers
    race on it from the send pool), then framed per chunk by byte slicing.
    The host decode of the same buffers is cached for the part owner's
    local apply, so the values applied are the wire bytes' values."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, n: int,
                 codec: int = compression.UNIFORM8BIT):
        self._codes_dev = codes          # u4: packed nibble pairs
        self._scales_dev = scales
        self.n = n
        self.codec = codec
        self._lock = threading.Lock()
        self._codes: Optional[np.ndarray] = None
        self._scales: Optional[np.ndarray] = None
        self._decoded: Optional[np.ndarray] = None

    def _materialize(self) -> None:
        with self._lock:
            if self._codes is None:
                self._codes = _host(self._codes_dev)
                self._scales = _host(self._scales_dev)

    def decoded_dev(self) -> torch.Tensor:
        """The dequantized part on the device: what every receiver of these
        wire bytes decodes. The error-feedback residual update subtracts it
        from the compensated gradient without a host round trip."""
        if self.codec == compression.UNIFORM4BIT:
            return _dec_u4(self._codes_dev, self._scales_dev, self.n)
        return _dec_u8(self._codes_dev, self._scales_dev)

    def _decode(self) -> np.ndarray:
        with self._lock:
            if self._decoded is None:
                self._decoded = _host(self.decoded_dev())
            return self._decoded


def encode_part(src, lo: int, hi: int,
                codec: int = compression.UNIFORM8BIT) -> EncodedPart:
    """Quantize ``src[lo:hi]`` (u8 or u4) in one kernel launch, returning
    while it runs. ``src`` is the flat gradient on the device; a host array
    works too (pushed once)."""
    if codec not in (compression.UNIFORM8BIT, compression.UNIFORM4BIT):
        raise ValueError(f"encode_part: unsupported codec {codec}")
    piece = _as_flat_f32(src[lo:hi])
    quantize = (wire_quantize_u4 if codec == compression.UNIFORM4BIT
                else wire_quantize_u8)
    codes, scales = quantize(piece)
    return EncodedPart(codes, scales, hi - lo, codec)


def part_payload(enc: EncodedPart, clo: int, chi: int) -> bytes:
    """The wire payload of the chunk ``[clo, chi)`` of an encoded part:
    byte-identical to ``compression.compress(part[clo:chi], enc.codec)``
    when ``clo`` is a multiple of the codec's quant block (wire chunks are:
    their size is a multiple of both blocks, and the u4 block is even, so
    nibble pairs never straddle a chunk)."""
    block = compression.codec_block(enc.codec)
    if clo % block:
        raise ValueError(f"chunk start {clo} is not a multiple of the quant "
                         f"block {block}")
    enc._materialize()
    b_lo, b_hi = clo // block, (chi + block - 1) // block
    if enc.codec == compression.UNIFORM4BIT:
        body = enc._codes[clo // 2:(chi + 1) // 2]
    else:
        body = enc._codes[clo:chi]
    return (struct.pack(">I", chi - clo) + enc._scales[b_lo:b_hi].tobytes()
            + body.tobytes())


def part_decode(enc: EncodedPart, clo: int, chi: int) -> np.ndarray:
    """The dequantized values of the chunk ``[clo, chi)`` on the host: one
    device decode per part, then views."""
    return enc._decode()[clo:chi]


# -- fused owner accumulation (the reduce phase's hot path) ---------------

def add_contrib(acc: torch.Tensor, contrib) -> torch.Tensor:
    """Add a weighted contribution computed on the host (a sender whose
    frames came in another codec) to the device accumulator in place; the
    same f32 add as the host path."""
    return acc.add_(_as_flat_f32(contrib, acc.device))


def accumulator_init(src, lo: int, hi: int, weight: float) -> torch.Tensor:
    """The owner's own contribution as the accumulator seed:
    ``src[lo:hi] * weight``, the host path's f32 multiply."""
    piece = _as_flat_f32(src[lo:hi])
    return piece * _weight(weight, piece.device)


def _weight(w: float, device) -> torch.Tensor:
    return torch.full((1,), w, dtype=torch.float32, device=device)


def fused_accumulate(acc: torch.Tensor, payloads: Sequence[bytes],
                     codec: int, n: int, w: float) -> torch.Tensor:
    """Add one sender's complete contribution to the device accumulator
    (in place; returned). ``payloads`` are the sender's validated wire
    chunk payloads in chunk order (``compression.quant_payload_valid``):
    their scales and codes concatenate into the whole part's, because chunk
    boundaries are quant-block multiples."""
    parsed = [_parse(p, codec) for p in payloads]
    scales = _to(np.concatenate([s for _, s, _ in parsed]), acc.device)
    codes = _to(np.concatenate([c for _, _, c in parsed]), acc.device)
    dec = (_dec_u4(codes, scales, n) if codec == compression.UNIFORM4BIT
           else _dec_u8(codes, scales))
    contrib = dec * _weight(w, acc.device)   # one rounding ...
    return acc.add_(contrib)                 # ... and another
