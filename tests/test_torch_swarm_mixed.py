"""A mixed pair: one JAX node and one port node run the butterfly
all-reduce on loopback, and both end every round with byte-identical
averaged arrays, equal to what an all-JAX pair with the same identities and
inputs ends with.

The JAX node runs its host codec on numpy arrays; the port node hands CPU
tensors to its device codec (the wire kernels' plain versions). The
pinned-codec rounds carry error-feedback residuals through two rounds and
run the pipelined butterfly.
"""

import threading

import numpy as np
import pytest
import torch

from dalle_tpu.swarm import dht as jdht
from dalle_tpu.swarm import error_feedback as jef
from dalle_tpu.swarm import identity as jid
from dalle_tpu.swarm import matchmaking as jmm
from dalle_tpu.swarm.allreduce import run_allreduce as j_allreduce
from dalle_tpu_torch.swarm import compression as tcomp
from dalle_tpu_torch.swarm import dht as tdht
from dalle_tpu_torch.swarm import error_feedback as tef
from dalle_tpu_torch.swarm import identity as tid
from dalle_tpu_torch.swarm import matchmaking as tmm
from dalle_tpu_torch.swarm.allreduce import run_allreduce as t_allreduce

torch.set_num_threads(2)

SHAPES = [(300, 257), (70001,), (33,)]

KINDS = {
    "jax": dict(dht=jdht.DHT, identity=jid.Identity, group=jmm.make_group,
                allreduce=j_allreduce, ef=jef.ErrorFeedback, backend="host",
                tensor=lambda a: a),
    "torch": dict(dht=tdht.DHT, identity=tid.Identity, group=tmm.make_group,
                  allreduce=t_allreduce, ef=tef.ErrorFeedback,
                  backend="device", tensor=torch.from_numpy),
}

CASES = {
    "none": dict(codec=tcomp.NONE),
    "float16": dict(codec=tcomp.FLOAT16),
    "uniform8bit": dict(codec=tcomp.UNIFORM8BIT),
    "size_adaptive": dict(codec=None),
    "pinned8_ef_pipelined": dict(codec=tcomp.UNIFORM8BIT,
                                 gather_codec=tcomp.UNIFORM8BIT,
                                 pin_codec=True, ef=True,
                                 pipeline_hops=True),
    "pinned4_ef_pipelined": dict(codec=tcomp.UNIFORM4BIT,
                                 gather_codec=tcomp.UNIFORM4BIT,
                                 pin_codec=True, ef=True,
                                 pipeline_hops=True),
}


def _inputs(seed, rounds):
    rng = np.random.default_rng(seed)
    return [[[(rng.normal(size=s) * rng.choice([1e-3, 1.0, 30.0])
               ).astype(np.float32) for s in SHAPES] for _ in range(2)]
            for _ in range(rounds)]


def _pair(kinds, pems, prefix, case, inputs, weights):
    """Run ``len(inputs)`` rounds on a fresh pair; per round, per peer, the
    averaged arrays."""
    case = dict(case)
    ef = case.pop("ef", False)
    mods = [KINDS[k] for k in kinds]
    ids = [m["identity"].load_or_create(p) for m, p in zip(mods, pems)]
    first = mods[0]["dht"](identity=ids[0], rpc_timeout=2.0)
    second = mods[1]["dht"](initial_peers=[first.visible_address],
                            identity=ids[1], rpc_timeout=2.0)
    nodes = [first, second]
    efs = [(m["ef"](), m["ef"]()) if ef else (None, None) for m in mods]
    out = []
    try:
        for r, per_peer in enumerate(inputs):
            results = [None, None]
            errors = []

            def peer(i, r=r, per_peer=per_peer):
                try:
                    m = mods[i]
                    g = m["group"](nodes[i], prefix, epoch=r,
                                   weight=weights[i], matchmaking_time=4.0,
                                   min_group_size=2, encrypt=True)
                    assert g is not None and g.size == 2
                    results[i] = m["allreduce"](
                        nodes[i], g, prefix, r,
                        [m["tensor"](a.copy()) for a in per_peer[i]],
                        weight=weights[i], allreduce_timeout=15.0,
                        codec_backend=m["backend"], ef_scatter=efs[i][0],
                        ef_gather=efs[i][1], **case)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=peer, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
            if errors:
                raise errors[0]
            out.append(results)
    finally:
        second.shutdown()
        first.shutdown()
    return out


@pytest.fixture(scope="module")
def pems(tmp_path_factory):
    d = tmp_path_factory.mktemp("ids")
    paths = [str(d / f"peer{i}.pem") for i in range(2)]
    for p in paths:
        jid.Identity.load_or_create(p)
    return paths


@pytest.mark.parametrize("name", sorted(CASES))
def test_mixed_pair_rounds_are_byte_identical(pems, name):
    case = CASES[name]
    rounds = 2 if case.get("ef") else 1
    inputs = _inputs(sorted(CASES).index(name), rounds)
    weights = [3.0, 5.0]
    mixed = _pair(("jax", "torch"), pems, f"mx_{name}", case, inputs,
                  weights)
    ref = _pair(("jax", "jax"), pems, f"mj_{name}", case, inputs, weights)
    for r in range(rounds):
        for peer in range(2):
            for got, want in zip(mixed[r][peer], ref[r][0]):
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
            for got, want in zip(mixed[r][peer], ref[r][1]):
                np.testing.assert_array_equal(got, want)
    if name == "none":
        flat = [np.concatenate([a.reshape(-1) for a in p])
                for p in inputs[0]]
        want = (flat[0] * weights[0] + flat[1] * weights[1]) / sum(weights)
        got = np.concatenate([a.reshape(-1) for a in mixed[0][1]])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_wire_kernel_launch_counts_in_a_round(pems, monkeypatch):
    """The port node's u8 round goes through the ``wire_quantize_u8``
    wrapper (its scatter encode and its part's gather re-encode)."""
    from dalle_tpu_torch.swarm import device_codec
    calls = []
    real = device_codec.wire_quantize_u8

    def counting(x):
        calls.append(x.numel())
        return real(x)

    monkeypatch.setattr(device_codec, "wire_quantize_u8", counting)
    inputs = _inputs(5, 1)
    _pair(("jax", "torch"), pems, "mx_count", CASES["uniform8bit"], inputs,
          [1.0, 1.0])
    total = sum(int(np.prod(s)) for s in SHAPES)
    assert len(calls) >= 1 and max(calls) <= total
