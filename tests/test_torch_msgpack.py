"""The port's MessagePack (dalle_tpu_torch/utils/msgpack.py) against the
``msgpack`` package, and the port's checkpoint array codec against flax's
state-dict serialization.

Packing must be byte-identical to ``msgpack.packb(obj, use_bin_type=True)``
(DHT records are signed over these bytes, and a JAX peer reads what a port
peer wrote); unpacking must return the same values and refuse what the
package refuses with ``raw=False``.
"""

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from dalle_tpu_torch.training import checkpoint as tckpt
from dalle_tpu_torch.utils import msgpack as tmsgpack

torch.set_num_threads(2)

_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
          2 ** 32, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128,
          -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
_INTS = st.one_of(st.sampled_from(_EDGES),
                  st.integers(-2 ** 63, 2 ** 64 - 1))
_SCALARS = st.one_of(
    st.none(), st.booleans(), _INTS,
    st.floats(allow_nan=False), st.text(max_size=300),
    st.binary(max_size=300))
_KEYS = st.one_of(st.text(max_size=40), st.binary(max_size=40))
_TREES = st.recursive(
    _SCALARS,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(_KEYS, inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_TREES)
def test_pack_is_byte_identical_and_round_trips(tree):
    want = msgpack.packb(tree, use_bin_type=True)
    assert tmsgpack.packb(tree) == want
    assert tmsgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("value", [
    *_EDGES, 0.0, -0.0, 1.5, float("inf"), float("-inf"), "", "a" * 31,
    "a" * 32, "a" * 255, "a" * 256, "é" * 40000, b"", b"x" * 255,
    b"x" * 256, b"x" * 65536, [], [0] * 15, [0] * 16, [0] * 65536, {},
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"k": [1, {"n": b"v"}]}, (1, 2, (3,)),
])
def test_length_and_width_boundaries(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert tmsgpack.packb(value) == want
    assert tmsgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 17, 255, 256, 70000])
def test_ext_types_match(n):
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    want = msgpack.packb(msgpack.ExtType(5, data), use_bin_type=True)
    assert tmsgpack.packb(tmsgpack.ExtType(5, data)) == want
    assert tmsgpack.unpackb(want) == tmsgpack.ExtType(5, data)


def test_nan_packs_identically():
    assert (tmsgpack.packb(float("nan"))
            == msgpack.packb(float("nan"), use_bin_type=True))


@pytest.mark.parametrize("value", [2 ** 64, -2 ** 63 - 1])
def test_out_of_range_ints_refused(value):
    with pytest.raises(OverflowError):
        msgpack.packb(value, use_bin_type=True)
    with pytest.raises(OverflowError):
        tmsgpack.packb(value)


@pytest.mark.parametrize("value", [np.int64(3), np.float32(1.0), object(),
                                   {1, 2}])
def test_unsupported_types_refused(value):
    with pytest.raises(TypeError):
        msgpack.packb(value, use_bin_type=True)
    with pytest.raises(TypeError):
        tmsgpack.packb(value)


_BAD = [
    b"", b"\x92\x01", b"\x01\x02", b"\xc1", b"\x81\x01\x02",
    b"\x81\xc0\x01", b"\x81\x92\x01\x02\x03", b"\x81\xcb" + b"\0" * 8 + b"\1",
    b"\xa1\xff", b"\xd9", b"\xd9\x05ab", b"\xc4\x05ab", b"\xdc\x00",
    b"\xde\x00\x01\xa1k", b"\xcb\x00", b"\xd4\x05", b"\xc7\x03\x05a",
    b"\x80\x80", b"\xa2\xc3\x28",
]


@pytest.mark.parametrize("buf", _BAD)
def test_refusals_match(buf):
    with pytest.raises(ValueError):
        msgpack.unpackb(buf, raw=False)
    with pytest.raises(ValueError):
        tmsgpack.unpackb(buf)


@settings(max_examples=200, deadline=None)
@given(_TREES, st.integers(0, 400))
def test_truncated_or_extended_input_refused_alike(tree, cut):
    buf = msgpack.packb(tree, use_bin_type=True)
    for bad in (buf[:cut] if cut < len(buf) else None, buf + b"\x00"):
        if bad is None:
            continue
        try:
            want = ("ok", msgpack.unpackb(bad, raw=False))
        except ValueError:
            want = ("err",)
        try:
            got = ("ok", tmsgpack.unpackb(bad))
        except ValueError:
            got = ("err",)
        assert got == want


def test_streaming_unpacker_tells_the_header_length(tmp_path):
    head = msgpack.packb({"epoch": 7}, use_bin_type=True)
    body = msgpack.packb({"x": b"y" * 100000}, use_bin_type=True)
    path = tmp_path / "f.bin"
    path.write_bytes(head + body)
    with open(path, "rb") as f:
        unpacker = tmsgpack.Unpacker(f, read_size=3)
        assert unpacker.unpack() == {"epoch": 7}
        assert unpacker.tell() == len(head)
    fed = tmsgpack.Unpacker()
    fed.feed(head[:2])
    with pytest.raises(tmsgpack.OutOfData):
        fed.unpack()
    fed.feed(head[2:] + body[:10])
    assert fed.unpack() == {"epoch": 7} and fed.tell() == len(head)
    ref = msgpack.Unpacker(raw=False)
    ref.feed(head + body[:10])
    ref.unpack()
    assert ref.tell() == fed.tell()


def _flax_tree(rng):
    return {
        "params": {
            "w": rng.normal(size=(3, 5)).astype(np.float32),
            "h": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
            "codes": rng.integers(0, 256, size=(2, 4)).astype(np.uint8),
            "step": np.asarray(3, np.int32),
            "empty": np.zeros((0, 4), np.float32),
        },
        "count": np.asarray(-2, np.int32),
    }


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_flax_state_dicts_read_back_exactly():
    tree = _flax_tree(np.random.default_rng(0))
    blob = serialization.msgpack_serialize(tree)
    got = tmsgpack.unpackb(blob, ext_hook=tckpt._unpack_tensor)
    for key in tree["params"]:
        want = tree["params"][key]
        have = _as_numpy(got["params"][key])
        assert have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(have.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))
    assert int(got["count"]) == -2


def test_port_state_dicts_are_flax_bytes():
    tree = _flax_tree(np.random.default_rng(1))
    as_torch = {
        "params": {k: (torch.from_numpy(v.view(np.int16).copy()).view(
            torch.bfloat16) if v.dtype == ml_dtypes.bfloat16
            else torch.from_numpy(v.copy()))
            for k, v in tree["params"].items()},
        "count": torch.tensor(-2, dtype=torch.int32),
    }
    blob = tckpt.pack_state_dict(as_torch)
    assert blob == serialization.msgpack_serialize(tree)
    back = serialization.msgpack_restore(blob)
    for key, want in tree["params"].items():
        np.testing.assert_array_equal(
            np.asarray(back["params"][key]).reshape(-1).view(np.uint8),
            want.reshape(-1).view(np.uint8))


def test_chunked_flax_arrays_are_joined():
    arr = np.arange(10, dtype=np.float32)
    chunked = {"a": {"__msgpack_chunked_array__": True,
                     "shape": {"0": 2, "1": 5},
                     "chunks": {"0": arr[:4], "1": arr[4:]}}}
    blob = serialization.msgpack_serialize(chunked)
    got = tckpt._unchunk(tmsgpack.unpackb(blob,
                                          ext_hook=tckpt._unpack_tensor))
    np.testing.assert_array_equal(got["a"].numpy(), arr.reshape(2, 5))
