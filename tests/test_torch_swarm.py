"""The port's swarm network half (dalle_tpu_torch/swarm) against the JAX
package's: identities and crypto, DHT records and validators, the metrics
record validator, progress, matchmaking and the butterfly all-reduce.

The port's modules are copies on its own MessagePack and its own build of
the repository's C++ daemon (``build/dalle_tpu_torch/``; the JAX package's
lives under ``native/build/``), so the two packages meet here through two
copies of the library in one process, on loopback.
"""

import threading

import numpy as np
import pydantic
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from dalle_tpu.swarm import _fallback_crypto as jfb
from dalle_tpu.swarm import crypto as jcrypto
from dalle_tpu.swarm import dht as jdht
from dalle_tpu.swarm import identity as jid
from dalle_tpu.swarm import metrics as jmetrics
from dalle_tpu_torch.swarm import _fallback_crypto as tfb
from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm import crypto as tcrypto
from dalle_tpu_torch.swarm import dht as tdht
from dalle_tpu_torch.swarm import identity as tid
from dalle_tpu_torch.swarm import metrics as tmetrics
from dalle_tpu_torch.swarm.allreduce import (_part_slices, flatten_tensors,
                                             run_allreduce,
                                             unflatten_tensors)
from dalle_tpu_torch.swarm.matchmaking import make_group
from dalle_tpu_torch.swarm.progress import ProgressTracker

torch.set_num_threads(2)


def make_swarm(n):
    nodes = []
    for _ in range(n):
        peers = [nodes[0].visible_address] if nodes else []
        nodes.append(tdht.DHT(initial_peers=peers,
                              identity=tid.Identity.generate(),
                              rpc_timeout=2.0))
    return nodes


@pytest.fixture
def swarm3():
    nodes = make_swarm(3)
    yield nodes
    for n in nodes:
        n.shutdown()


def run_threads(fns):
    results, errors = [None] * len(fns), []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return results


# -- identity and crypto ----------------------------------------------------

def test_identity_files_and_signatures_cross_packages(tmp_path):
    path = str(tmp_path / "id.pem")
    t = tid.Identity.load_or_create(path)
    j = jid.Identity.load_or_create(path)
    assert t.public_bytes == j.public_bytes and t.node_id == j.node_id
    msg = b"round 7 part 3"
    assert jid.Identity.verify(t.public_bytes, t.sign(msg), msg)
    assert tid.Identity.verify(j.public_bytes, j.sign(msg), msg)
    assert not tid.Identity.verify(j.public_bytes, j.sign(msg), msg + b"!")
    frame = tid.signed_frame(t, b"ctx", b"head", b"payload")
    assert jid.open_frame(frame, b"ctx", 4, t.node_id.hex()) is not None
    assert jid.open_frame(frame, b"other", 4, t.node_id.hex()) is None
    frame = jid.signed_frame(j, b"ctx", b"head", b"payload")
    opened = tid.open_frame(frame, b"ctx", 4, j.node_id.hex())
    assert opened is not None and opened[:2] == (b"head", b"payload")


def test_sealed_boxes_and_group_keys_cross_packages():
    tkx, jkx = tcrypto.KxKeypair(), jcrypto.KxKeypair()
    assert jcrypto.open_sealed(jkx, tcrypto.seal_to(jkx.public_bytes,
                                                    b"state")) == b"state"
    assert tcrypto.open_sealed(tkx, jcrypto.seal_to(tkx.public_bytes,
                                                    b"state")) == b"state"
    key = tcrypto.new_group_key()
    assert jcrypto.decrypt(key, tcrypto.encrypt(key, b"chunk")) == b"chunk"
    assert tcrypto.decrypt(key, jcrypto.encrypt(key, b"chunk")) == b"chunk"
    assert tcrypto.decrypt(tcrypto.new_group_key(),
                           jcrypto.encrypt(key, b"chunk")) is None


def test_fallback_crypto_copies_interoperate():
    """The card's machine has no ``cryptography``: both packages then run
    their bundled fallback, whose signatures, key agreement and AEAD must
    meet."""
    tkey = tfb.Ed25519PrivateKey.generate()
    pem = tkey.private_bytes(tfb.serialization.Encoding.PEM,
                             tfb.serialization.PrivateFormat.PKCS8,
                             tfb.serialization.NoEncryption())
    jkey = jfb.serialization.load_pem_private_key(pem)
    assert tkey.sign(b"m") == jkey.sign(b"m")
    jkey.public_key().verify(tkey.sign(b"m"), b"m")
    ta, ja = tfb.X25519PrivateKey.generate(), jfb.X25519PrivateKey.generate()
    shared_t = ta.exchange(tfb.X25519PublicKey.from_public_bytes(
        ja.public_key().public_bytes(tfb.serialization.Encoding.Raw,
                                     tfb.serialization.PublicFormat.Raw)))
    shared_j = ja.exchange(jfb.X25519PublicKey.from_public_bytes(
        ta.public_key().public_bytes(jfb.serialization.Encoding.Raw,
                                     jfb.serialization.PublicFormat.Raw)))
    assert shared_t == shared_j
    key, nonce = bytes(range(32)), bytes(12)
    sealed = tfb.ChaCha20Poly1305(key).encrypt(nonce, b"frame", b"")
    assert jfb.ChaCha20Poly1305(key).decrypt(nonce, sealed, b"") == b"frame"


# -- DHT records and validators ---------------------------------------------

def _metrics(peer_id, epoch=3):
    return dict(peer_id=peer_id, epoch=epoch, samples_per_second=2.5,
                samples_accumulated=0, loss=1.25, mini_steps=4)


def test_dht_records_cross_packages():
    jnode_id, tnode_id = jid.Identity.generate(), tid.Identity.generate()
    j = jdht.DHT(identity=jnode_id, rpc_timeout=2.0,
                 record_validators=jmetrics.make_validators(jnode_id, "x"))
    t = tdht.DHT(initial_peers=[j.visible_address], identity=tnode_id,
                 rpc_timeout=2.0,
                 record_validators=tmetrics.make_validators(tnode_id, "x"))
    try:
        exp = tdht.get_dht_time() + 60
        assert jmetrics.publish_metrics(
            j, "x", jmetrics.LocalMetrics(**_metrics(j.peer_id)))
        assert tmetrics.publish_metrics(
            t, "x", tmetrics.LocalMetrics(**_metrics(t.peer_id, 5)))
        assert t.store("plain", b"k", {"v": [1, b"2"]}, exp)
        assert j.store("plain", b"j", {"v": -7.5}, exp)
        # an unsigned record under the protected metrics key: both drop it
        assert t.store("x_metrics", None, _metrics(t.peer_id), exp) in (
            True, False)
        for node, mod in ((t, tmetrics), (j, jmetrics)):
            got = {m.peer_id: m.epoch for m in mod.fetch_metrics(node, "x")}
            assert got == {j.peer_id: 3, t.peer_id: 5}
        for node in (t, j):
            plain = {tdht.strip_owner(k): v.value
                     for k, v in node.get("plain").items()}
            assert plain == {b"k": {"v": [1, b"2"]}, b"j": {"v": -7.5}}
    finally:
        t.shutdown()
        j.shutdown()


_NUMERIC_TEXT = st.from_regex(
    r"\A[ \t]{0,2}[+-]?[0-9]{1,4}(_[0-9]{1,3})?(\.[0-9]{0,3})?"
    r"([eE][+-]?[0-9]{1,3})?[ \t]{0,2}\Z", fullmatch=True)
_VALUES = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(), st.floats(-2.0 ** 64, 2.0 ** 64).map(float.__floor__)
    .map(float), _NUMERIC_TEXT, _NUMERIC_TEXT.map(str.encode),
    st.sampled_from(["inf", "-inf", "nan", "NaN", "Infinity", "1_0",
                     "1.0", "0.000", "", " ", "x", "1e3"]),
    st.text(max_size=8), st.binary(max_size=4),
    st.lists(st.integers(), max_size=2))
_FIELDS = [f for f in jmetrics.LocalMetrics.model_fields]


@settings(max_examples=400, deadline=None)
@example({"samples_per_second": "0_0 "}, {}, True)
@example({"samples_per_second": " 0_0"}, {}, True)
@example({"samples_per_second": " 1_0 "}, {}, True)
@example({"samples_per_second": "1 "}, {}, True)
@example({"samples_per_second": " 1"}, {}, True)
@example({"samples_per_second": "1_000.5"}, {}, True)
@example({"samples_per_second": "0-1"}, {}, True)
@example({"samples_per_second": "\x1c1"}, {}, True)
@example({"epoch": "0_0 "}, {}, True)
@example({"epoch": " 0_0"}, {}, True)
@example({"epoch": " 1_0 "}, {}, True)
@example({"epoch": "1 "}, {}, True)
@example({"epoch": " 1"}, {}, True)
@example({"epoch": "1_000.5"}, {}, True)
@example({"epoch": "0-1"}, {}, True)
@example({"epoch": "\x1c1"}, {}, True)
@given(st.dictionaries(st.sampled_from(_FIELDS), _VALUES),
       st.dictionaries(st.sampled_from(["extra", "", "Epoch"]), _VALUES,
                       max_size=1),
       st.booleans())
def test_metrics_validator_matches_pydantic(fields, extra, base):
    record = dict(_metrics("p")) if base else {}
    record.update(fields)
    record.update(extra)
    try:
        want = jmetrics.LocalMetrics.model_validate(record).model_dump()
    except pydantic.ValidationError:
        want = None
    try:
        got = tmetrics.LocalMetrics.model_validate(record).model_dump()
    except tmetrics.ValidationError:
        got = None
    if want is None or got is None:
        assert want is got
    else:
        assert got.keys() == want.keys()
        for k in want:
            assert type(got[k]) is type(want[k])
            assert got[k] == want[k] or (got[k] != got[k]
                                         and want[k] != want[k])


def test_metrics_validator_refuses_non_maps():
    for value in ([1], None, "x", 3):
        with pytest.raises(tmetrics.ValidationError):
            tmetrics.LocalMetrics.model_validate(value)


def test_peer_data_seed_equals_jax(tmp_path):
    path = str(tmp_path / "id.pem")
    t = tid.Identity.load_or_create(path)
    j = jid.Identity.load_or_create(path)
    for base in (0, 7):
        assert (tmetrics.peer_data_seed(t, base)
                == jmetrics.peer_data_seed(j, base))


# -- progress and matchmaking among port peers ------------------------------

def test_progress_aggregation_agrees(swarm3):
    trackers = [ProgressTracker(n, "run", target_batch_size=30)
                for n in swarm3]
    for i, tr in enumerate(trackers):
        tr.report_local_progress(0, 10 * (i + 1), force=True)
    views = [tr.global_progress(force_refresh=True) for tr in trackers]
    for v in views:
        assert v.samples_accumulated == 60 and v.num_peers == 3
        assert v.ready_to_update


def test_matchmaking_agrees(swarm3):
    groups = run_threads([
        lambda i=i: make_group(swarm3[i], "mm", epoch=1, weight=1.0 + i,
                               matchmaking_time=3.0, min_group_size=3,
                               encrypt=True)
        for i in range(3)])
    assert all(g is not None and g.size == 3 for g in groups)
    assert len({g.group_hash for g in groups}) == 1
    assert len({g.group_key for g in groups}) == 1
    assert [g.members[g.my_index].peer_id for g in groups] == \
        [n.peer_id for n in swarm3]


# -- the butterfly all-reduce among port peers (test_collab's TestAllReduce)

def _weighted_mean(tensors_per_peer, weights):
    flats = [flatten_tensors(t) for t in tensors_per_peer]
    return sum(f * w for f, w in zip(flats, weights)) / sum(weights)


def _round(swarm, prefix, epoch, tensors, weights, **kw):
    def peer(i):
        g = make_group(swarm[i], prefix, epoch=epoch, weight=weights[i],
                       matchmaking_time=3.0, min_group_size=len(swarm))
        assert g is not None and g.size == len(swarm)
        return run_allreduce(swarm[i], g, prefix, epoch, tensors[i],
                             weight=weights[i], allreduce_timeout=10.0,
                             **kw)
    return run_threads([lambda i=i: peer(i) for i in range(len(swarm))])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_weighted_average_exact(swarm3, backend):
    rng = np.random.RandomState(3)
    shapes = [(33,), (8, 9), (5,)]
    tensors = [[rng.randn(*s).astype(np.float32) for s in shapes]
               for _ in swarm3]
    if backend == "device":
        tensors = [[torch.from_numpy(a) for a in ts] for ts in tensors]
    weights = [1.0, 2.0, 5.0]
    results = _round(swarm3, f"ar{backend}", 0, tensors, weights,
                     codec=compression.NONE, codec_backend=backend)
    expected = unflatten_tensors(
        _weighted_mean([[np.asarray(a) for a in ts] for ts in tensors],
                       weights), [np.asarray(a) for a in tensors[0]])
    for res in results:
        for got, want in zip(res, expected):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_lossy_rounds_are_byte_identical(swarm3, backend):
    rng = np.random.RandomState(11)
    tensors = [[rng.randn(90000).astype(np.float32)] for _ in swarm3]
    if backend == "device":
        tensors = [[torch.from_numpy(t[0])] for t in tensors]
    results = _round(swarm3, f"arb{backend}", 4, tensors, [1.0] * 3,
                     codec=compression.UNIFORM8BIT, codec_backend=backend)
    for res in results[1:]:
        np.testing.assert_array_equal(res[0], results[0][0])


def test_dead_sender_leaves_gather_budget(swarm3):
    rng = np.random.RandomState(12)
    tensors = [[rng.randn(300).astype(np.float32)] for _ in swarm3]

    def peer(i):
        g = make_group(swarm3[i], "arg", epoch=5, weight=1.0,
                       matchmaking_time=3.0, min_group_size=3)
        assert g is not None and g.size == 3
        if i == 2:
            return g, None  # dies silently after matchmaking
        return g, run_allreduce(swarm3[i], g, "arg", 5, tensors[i],
                                weight=1.0, allreduce_timeout=6.0,
                                sender_timeout=1.0, codec=compression.NONE)

    results = run_threads([lambda i=i: peer(i) for i in range(3)])
    group = results[0][0]
    flats = [flatten_tensors(t) for t in tensors]
    slices = _part_slices(flats[0].size, 3)
    member_ids = [m.peer_id for m in group.members]
    live_avg = (flats[0] + flats[1]) / 2
    for i in (0, 1):
        got = flatten_tensors(results[i][1])
        other_part = member_ids.index(swarm3[1 - i].peer_id)
        lo, hi = slices[other_part]
        np.testing.assert_allclose(got[lo:hi], live_avg[lo:hi],
                                   rtol=1e-5, atol=1e-6)


def test_chunked_parts_average_exact(swarm3):
    rng = np.random.RandomState(21)
    tensors = [[rng.randn(1300).astype(np.float32)] for _ in swarm3]
    weights = [1.0, 3.0, 0.5]
    reports = [dict() for _ in swarm3]

    def peer(i):
        g = make_group(swarm3[i], "arch", epoch=7, weight=weights[i],
                       matchmaking_time=3.0, min_group_size=3)
        return run_allreduce(swarm3[i], g, "arch", 7, tensors[i],
                             weight=weights[i], allreduce_timeout=10.0,
                             codec=compression.NONE, report=reports[i],
                             chunk_elems=100)

    results = run_threads([lambda i=i: peer(i) for i in range(3)])
    expected = _weighted_mean(tensors, weights)
    for res, rep in zip(results, reports):
        np.testing.assert_allclose(res[0], expected, rtol=1e-5, atol=1e-6)
        assert rep["complete"]
