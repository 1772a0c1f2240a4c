"""A MessagePack reader and writer in plain Python.

The swarm encodes every DHT record, matchmaking confirmation and state
frame with MessagePack, and checkpoints use it for their header and state
dict. The ``msgpack`` package is not a dependency of the port, so this
module carries the subset the swarm and the checkpoints use, with the
package's behaviour as the contract:

- :func:`packb` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
  for None, bool, int, float, str, bytes (bytearray, memoryview), list,
  tuple, dict and :class:`ExtType`: the narrowest int encoding (unsigned
  for values >= 0), float64 for every float, str8/bin8 and fixext forms.
  Subclasses of those types pack as their base type; anything else goes
  to ``default`` or raises ``TypeError``.
- :func:`unpackb` and :class:`Unpacker` decode as the package does with
  ``raw=False``: arrays become lists, bin becomes bytes, ext becomes
  :class:`ExtType` (or what ``ext_hook`` returns), and they refuse what
  the package refuses, with ``ValueError`` subclasses: truncated input,
  trailing bytes (:class:`ExtraData`), the reserved byte 0xc1
  (:class:`FormatError`), map keys other than str/bytes under
  ``strict_map_key`` (the default), invalid UTF-8 and nesting deeper than
  the package's stack.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional

__all__ = ["ExtType", "packb", "unpackb", "Unpacker", "UnpackException",
           "ExtraData", "FormatError", "StackError", "OutOfData"]

_STACK_LIMIT = 1024    # nesting the package's C unpacker accepts


class UnpackException(Exception):
    """Base of the refusals below (``msgpack.UnpackException``)."""


class OutOfData(UnpackException):
    """:meth:`Unpacker.unpack` ran out of fed bytes."""


class FormatError(ValueError, UnpackException):
    """A byte that starts no MessagePack object."""


class StackError(ValueError, UnpackException):
    """Nesting deeper than the unpacker's stack."""


class ExtraData(ValueError):
    """:func:`unpackb` decoded one object and bytes were left over."""

    def __init__(self, unpacked, extra):
        super().__init__("unpack(b) received extra data.")
        self.unpacked = unpacked
        self.extra = extra


class ExtType(NamedTuple):
    """An extension value: a type ``code`` and its ``data`` bytes."""

    code: int
    data: bytes


class _Incomplete(Exception):
    pass


# -- writer ----------------------------------------------------------------

_pk_b = struct.Struct(">B").pack
_pk_bb = struct.Struct(">BB").pack
_pk_bh = struct.Struct(">BH").pack
_pk_bi = struct.Struct(">BI").pack
_pk_bq = struct.Struct(">BQ").pack
_pk_bbs = struct.Struct(">Bb").pack
_pk_bhs = struct.Struct(">Bh").pack
_pk_bis = struct.Struct(">Bi").pack
_pk_bqs = struct.Struct(">Bq").pack
_pk_bd = struct.Struct(">Bd").pack


def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80:
        out.append(_pk_b(x))
    elif -0x20 <= x < 0:
        out.append(_pk_b(x & 0xFF))
    elif 0 <= x <= 0xFF:
        out.append(_pk_bb(0xCC, x))
    elif -0x80 <= x < 0:
        out.append(_pk_bbs(0xD0, x))
    elif 0 <= x <= 0xFFFF:
        out.append(_pk_bh(0xCD, x))
    elif -0x8000 <= x < 0:
        out.append(_pk_bhs(0xD1, x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(_pk_bi(0xCE, x))
    elif -0x80000000 <= x < 0:
        out.append(_pk_bis(0xD2, x))
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(_pk_bq(0xCF, x))
    elif -0x8000000000000000 <= x < 0:
        out.append(_pk_bqs(0xD3, x))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: Optional[int], fix_max: int, c8: Optional[int],
              c16: int, c32: int, out: list, what: str) -> None:
    if fix is not None and n <= fix_max:
        out.append(_pk_b(fix | n))
    elif c8 is not None and n <= 0xFF:
        out.append(_pk_bb(c8, n))
    elif n <= 0xFFFF:
        out.append(_pk_bh(c16, n))
    elif n <= 0xFFFFFFFF:
        out.append(_pk_bi(c32, n))
    else:
        raise ValueError(f"{what} is too large")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(obj: Any, out: list, default: Optional[Callable],
          depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(_pk_bd(0xCB, float(obj)))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, 0xC4, 0xC5, 0xC6, out, "bytes")
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, 0xD9, 0xDA, 0xDB, out, "str")
        out.append(data)
    elif isinstance(obj, ExtType):
        code, data = obj
        if not isinstance(code, int) or not -128 <= code <= 127:
            raise ValueError("ext code must be in [-128, 127]")
        data = bytes(data)
        n = len(data)
        if n in _FIXEXT:
            out.append(_pk_b(_FIXEXT[n]))
        else:
            _pack_len(n, None, 0, 0xC7, 0xC8, 0xC9, out, "ext data")
        out.append(struct.pack(">b", code))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, None, 0xDC, 0xDD, out, "list")
        for item in obj:
            _pack(item, out, default, depth - 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, None, 0xDE, 0xDF, out, "dict")
        for k, v in obj.items():
            _pack(k, out, default, depth - 1)
            _pack(v, out, default, depth - 1)
    elif default is not None:
        _pack(default(obj), out, None, depth - 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any, default: Optional[Callable] = None,
          use_bin_type: bool = True) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)``); ``default`` converts objects of other types."""
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is supported")
    out: list = []
    _pack(obj, out, default, 511)
    return b"".join(out)


# -- reader ----------------------------------------------------------------

_FMT = {
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
    0xCA: (">f", 4), 0xCB: (">d", 8),
}
_LEN = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4,
        0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4, 0xC7: 1, 0xC8: 2, 0xC9: 4}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf, strict_map_key: bool,
                 ext_hook: Optional[Callable]):
        self.buf = memoryview(buf)
        self.pos = 0
        self.strict = strict_map_key
        self.ext_hook = ext_hook

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise _Incomplete
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def _unpack_fmt(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def read(self, depth: int = 0):
        if depth > _STACK_LIMIT:
            raise StackError("nesting too deep")
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, depth)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F, depth)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FMT:
            return self._unpack_fmt(*_FMT[b])
        if b in _LEN:
            width = _LEN[b]
            n = self._unpack_fmt(_LEN_FMT[width], width)
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self._take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self._str(n)
            if b in (0xDC, 0xDD):
                return self._array(n, depth)
            if b in (0xDE, 0xDF):
                return self._map(n, depth)
            return self._ext(n)
        if b in _FIXEXT_LEN:
            return self._ext(_FIXEXT_LEN[b])
        raise FormatError(f"reserved byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int, depth: int) -> list:
        return [self.read(depth + 1) for _ in range(n)]

    def _map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(depth + 1)
            if self.strict and type(key) not in (str, bytes):
                raise ValueError(
                    f"{type(key).__name__} is not allowed for map key "
                    "when strict_map_key=True")
            out[key] = self.read(depth + 1)
        return out

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        data = bytes(self._take(n))
        if self.ext_hook is not None:
            return self.ext_hook(code, data)
        return ExtType(code, data)


def unpackb(packed, raw: bool = False, strict_map_key: bool = True,
            ext_hook: Optional[Callable] = None):
    """The one object in ``packed`` (``msgpack.unpackb(packed,
    raw=False)``)."""
    if raw:
        raise ValueError("only raw=False is supported")
    reader = _Reader(packed, strict_map_key, ext_hook)
    try:
        obj = reader.read()
    except _Incomplete:
        raise ValueError("Unpack failed: incomplete input") from None
    except RecursionError:
        raise StackError("nesting too deep") from None
    if reader.pos != len(reader.buf):
        raise ExtraData(obj, bytes(reader.buf[reader.pos:]))
    return obj


class Unpacker:
    """Streaming reader (``msgpack.Unpacker(file_like, raw=False)``):
    objects from a file or from :meth:`feed`, one per :meth:`unpack` or
    per step of iteration (which ends where the bytes end, as the
    package's does); :meth:`tell` is the count of bytes consumed so far."""

    def __init__(self, file_like=None, raw: bool = False,
                 strict_map_key: bool = True,
                 ext_hook: Optional[Callable] = None,
                 read_size: int = 1 << 16):
        if raw:
            raise ValueError("only raw=False is supported")
        self._file = file_like
        # unread bytes are self._buf[self._pos:]; decoding reads them in
        # place, so a shard of many small records is not copied per record
        self._buf = b""
        self._pos = 0
        self._consumed = 0
        self._strict = strict_map_key
        self._ext_hook = ext_hook
        self._read_size = read_size

    def feed(self, data) -> None:
        self._buf = self._buf[self._pos:] + bytes(data)
        self._pos = 0

    def tell(self) -> int:
        return self._consumed

    def unpack(self):
        while True:
            reader = _Reader(self._buf, self._strict, self._ext_hook)
            reader.pos = self._pos
            try:
                obj = reader.read()
            except _Incomplete:
                chunk = (self._file.read(self._read_size)
                         if self._file is not None else b"")
                if not chunk:
                    raise OutOfData from None
                self.feed(chunk)
                continue
            self._consumed += reader.pos - self._pos
            self._pos = reader.pos
            return obj

    def __iter__(self) -> "Unpacker":
        return self

    def __next__(self):
        try:
            return self.unpack()
        except OutOfData:
            raise StopIteration from None
