"""The port's access tokens against ``dalle_tpu/swarm/auth.py``: the same
token bytes and signing message, tokens issued by either package verify
in both, expired, forged and rebound tokens are refused, the
``issue_token`` CLI works, a mixed JAX + port pair with an authority ends
its all-reduce with byte-identical averages, and a peer holding another
authority's token never enters a group.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from dalle_tpu.swarm import auth as jauth
from dalle_tpu.swarm import dht as jdht
from dalle_tpu.swarm import identity as jid
from dalle_tpu.swarm import matchmaking as jmm
from dalle_tpu.swarm import metrics as jmetrics
from dalle_tpu.swarm.allreduce import run_allreduce as j_allreduce
from dalle_tpu_torch.swarm import auth as pauth
from dalle_tpu_torch.swarm import compression as tcomp
from dalle_tpu_torch.swarm import dht as tdht
from dalle_tpu_torch.swarm import identity as tid
from dalle_tpu_torch.swarm import matchmaking as tmm
from dalle_tpu_torch.swarm import metrics as tmetrics
from dalle_tpu_torch.swarm.allreduce import run_allreduce as t_allreduce

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """PEM files: the authority, a rogue authority and three peers."""
    d = tmp_path_factory.mktemp("keys")
    out = {}
    for name in ("authority", "rogue", "p0", "p1", "p2"):
        out[name] = str(d / f"{name}.pem")
        jid.Identity.load_or_create(out[name])
    return out


def _token(mod, authority_pem, peer_pem, exp=4.0e9, user="alice"):
    idmod = jid if mod is jauth else tid
    authority = idmod.Identity.load_or_create(authority_pem)
    peer = idmod.Identity.load_or_create(peer_pem)
    tok = mod.AccessToken(username=user,
                          peer_public_key=peer.public_bytes,
                          expiration_time=exp, signature=b"")
    return dataclasses.replace(
        tok, signature=authority.sign(tok.signing_message()))


@pytest.mark.parametrize("user, exp", [("alice", 4.0e9), ("", 1.5),
                                        ("猫-peer", 1.7e9 + 0.25)])
def test_token_bytes_equal_jax(keys, user, exp):
    a = _token(jauth, keys["authority"], keys["p0"], exp, user)
    b = _token(pauth, keys["authority"], keys["p0"], exp, user)
    assert a.signing_message() == b.signing_message()
    assert a.signature == b.signature
    assert a.to_bytes() == b.to_bytes()
    assert pauth.AccessToken.from_bytes(a.to_bytes()) == b
    assert jauth.AccessToken.from_bytes(b.to_bytes()) == a


@pytest.mark.parametrize("raw", [b"", b"\x80", b"\xc1", b"\x93\x01\x02\x03",
                                 b"\x81\xa1u\xa1x"])
def test_malformed_tokens_parse_to_none(raw):
    assert pauth.AccessToken.from_bytes(raw) is None
    assert jauth.AccessToken.from_bytes(raw) is None


def _authorizers(keys, authority="authority"):
    pub = jid.Identity.load_or_create(keys[authority]).public_bytes
    return (jauth.ExperimentAuthorizer(pub), pauth.ExperimentAuthorizer(pub))


def test_tokens_verify_across_packages(keys):
    """Issued by either package's ``ExperimentAuthority``: valid in both
    authorizers; expired, forged, rebound or another authority's: refused
    by both."""
    peer_pk = jid.Identity.load_or_create(keys["p0"]).public_bytes
    other_pk = jid.Identity.load_or_create(keys["p1"]).public_bytes
    issued = [
        jauth.ExperimentAuthority(jid.Identity.load_or_create(
            keys["authority"])).issue("alice", peer_pk, ttl=600),
        pauth.ExperimentAuthority(tid.Identity.load_or_create(
            keys["authority"])).issue("alice", peer_pk, ttl=600)]
    for tok in issued:
        raw = tok.to_bytes()
        for az in _authorizers(keys):
            assert az.validate_token_bytes(raw, peer_pk) == "alice"
            assert az.validate_token_bytes(raw, other_pk) is None   # rebound
            assert az.validate_token_bytes(None, peer_pk) is None
        for az in _authorizers(keys, "rogue"):
            assert az.validate_token_bytes(raw, peer_pk) is None
    expired = _token(pauth, keys["authority"], keys["p0"], exp=100.0)
    forged = dataclasses.replace(issued[1], username="mallory")
    resigned = _token(pauth, keys["rogue"], keys["p0"])
    for bad in (expired, forged, resigned):
        for az in _authorizers(keys):
            assert az.validate_token_bytes(bad.to_bytes(), peer_pk) is None
    with pytest.raises(ValueError, match="32 raw bytes"):
        pauth.ExperimentAuthorizer(b"short")


def test_member_authorized_equals_jax(keys):
    """The roster check: the token must be bound to the identity whose
    hash is the member's peer id."""
    import hashlib
    tok = _token(pauth, keys["authority"], keys["p0"]).to_bytes()
    pk0 = jid.Identity.load_or_create(keys["p0"]).public_bytes
    pid0 = hashlib.sha256(pk0).hexdigest()
    pid1 = hashlib.sha256(jid.Identity.load_or_create(
        keys["p1"]).public_bytes).hexdigest()
    jaz, paz = _authorizers(keys)
    for pid, token, want in ((pid0, tok, True), (pid1, tok, False),
                             (pid0, b"", False), (pid0, b"junk", False)):
        jm = jmm.GroupMember(pid, "a:1", 1.0, token, b"")
        tm = tmm.GroupMember(pid, "a:1", 1.0, token, b"")
        assert jmm.member_authorized(jm, jaz) is want
        assert tmm.member_authorized(tm, paz) is want
        assert tmm.member_authorized(tm, None) is True


def test_authorizer_local_token_and_refresh(keys, tmp_path):
    """The peer side: the token file read and refreshed near expiry; an
    expired file raises with the re-issue command; no source raises."""
    path = tmp_path / "alice.token"
    path.write_bytes(_token(pauth, keys["authority"], keys["p0"]).to_bytes())
    pub = jid.Identity.load_or_create(keys["authority"]).public_bytes
    az = pauth.make_authorizer(pub.hex(), str(path))
    assert az.local_token_bytes() == path.read_bytes()
    assert pauth.make_authorizer(None, str(path)) is None
    path.write_bytes(_token(pauth, keys["authority"], keys["p0"],
                            exp=100.0).to_bytes())
    with pytest.raises(RuntimeError, match="issue_token"):
        pauth.make_authorizer(pub.hex(), str(path))._acquire_token()
    with pytest.raises(RuntimeError, match="no token source"):
        pauth.ExperimentAuthorizer(pub)._acquire_token()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("not yet")
        return "done"
    assert pauth.retry_with_backoff(flaky, initial_delay=0.0) == "done"
    assert len(calls) == 3


def test_credentials_from_env(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_USERNAME", "bob")
    assert pauth.credentials_from_env() == jauth.credentials_from_env() \
        == "bob"
    monkeypatch.delenv("DALLE_TPU_USERNAME")
    monkeypatch.setenv("USER", "carol")
    assert pauth.credentials_from_env() == "carol"


def test_issue_token_cli(keys, tmp_path, capsys):
    """The port's CLI prints the authority key and issues a token file the
    JAX package's authorizer accepts; a missing identity is refused."""
    from dalle_tpu_torch.cli import issue_token
    auth_pem = str(tmp_path / "auth.pem")
    assert issue_token.main(["--authority-key", auth_pem,
                             "--print-public-key"]) == 0
    pub_hex = capsys.readouterr().out.strip()
    assert bytes.fromhex(pub_hex) == \
        jid.Identity.load_or_create(auth_pem).public_bytes
    out = tmp_path / "t" / "bob.token"
    out.parent.mkdir()
    assert issue_token.main(["--authority-key", auth_pem, "--username",
                             "bob", "--peer-identity", keys["p1"],
                             "--ttl", "600", "--out", str(out)]) == 0
    pk = jid.Identity.load_or_create(keys["p1"]).public_bytes
    assert jauth.make_authorizer(pub_hex, None).validate_token_bytes(
        out.read_bytes(), pk) == "bob"
    assert issue_token.main(["--authority-key", auth_pem, "--username",
                             "bob", "--peer-identity",
                             str(tmp_path / "nope.pem")]) == 2
    assert not (tmp_path / "nope.pem").exists()


KINDS = {
    "jax": dict(dht=jdht.DHT, identity=jid.Identity, group=jmm.make_group,
                allreduce=j_allreduce, auth=jauth, backend="host",
                validators=jmetrics.make_validators,
                tensor=lambda a: a),
    "torch": dict(dht=tdht.DHT, identity=tid.Identity, group=tmm.make_group,
                  allreduce=t_allreduce, auth=pauth, backend="device",
                  validators=tmetrics.make_validators,
                  tensor=torch.from_numpy),
}


def _swarm(keys, kinds, authorities, prefix, inputs, pems=None):
    """One matchmaking + all-reduce round over ``len(kinds)`` peers, each
    with a token from its authority and an authorizer of the experiment
    authority. Returns (group sizes, member sets, averaged arrays)."""
    import os
    import tempfile
    mods = [KINDS[k] for k in kinds]
    pems = pems or [keys[f"p{i}"] for i in range(len(kinds))]
    ids = [m["identity"].load_or_create(p) for m, p in zip(mods, pems)]
    pub = jid.Identity.load_or_create(keys["authority"]).public_bytes
    tmp = tempfile.mkdtemp()
    azs = []
    for i, (m, a) in enumerate(zip(mods, authorities)):
        path = os.path.join(tmp, f"{i}.token")
        with open(path, "wb") as f:
            f.write(_token(m["auth"], keys[a], pems[i]).to_bytes())
        azs.append(m["auth"].ExperimentAuthorizer(pub, token_path=path))
    # the signed-record validators a task's DHT carries: an announce's
    # subkey names its owner's key, which the token must be bound to
    nodes = []
    for m, ident in zip(mods, ids):
        nodes.append(m["dht"](
            initial_peers=[nodes[0].visible_address] if nodes else [],
            identity=ident, rpc_timeout=2.0,
            record_validators=m["validators"](ident, prefix)))
    sizes, members, results = [None] * len(kinds), [None] * len(kinds), \
        [None] * len(kinds)
    errors = []

    def peer(i):
        try:
            m = mods[i]
            g = m["group"](nodes[i], prefix, epoch=0, weight=1.0,
                           matchmaking_time=6.0, min_group_size=2,
                           encrypt=True, authorizer=azs[i])
            if g is None:
                return
            sizes[i] = g.size
            members[i] = sorted(x.peer_id for x in g.members)
            results[i] = m["allreduce"](
                nodes[i], g, prefix, 0,
                [m["tensor"](a.copy()) for a in inputs[i]], weight=1.0,
                # a rogue's round never completes: it waits less
                allreduce_timeout=30.0 if authorities[i] == "authority"
                else 3.0, codec_backend=m["backend"],
                codec=tcomp.NONE)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=peer, args=(i,))
               for i in range(len(kinds))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
    finally:
        for n in nodes[::-1]:
            n.shutdown()
    if errors:
        raise errors[0]
    return sizes, members, results, [n.peer_id for n in nodes]


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=s).astype(np.float32)
             for s in ((300, 7), (513,))] for _ in range(n)]


@pytest.mark.parametrize("kinds", [("jax", "torch"), ("torch", "jax")])
def test_mixed_pair_with_auth_ends_byte_identical(keys, kinds):
    inputs = _inputs(2)
    sizes, _, results, _ = _swarm(keys, kinds, ["authority"] * 2,
                                  f"auth-{kinds[0]}", inputs)
    assert sizes == [2, 2]
    for a, b in zip(*results):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rogue_first", [True, False])
def test_a_peer_with_another_authoritys_token_never_enters_a_group(
        keys, tmp_path, rogue_first):
    """Two authorized port peers and one whose token the rogue authority
    signed: the two form a group of two without it (its own view may list
    them, but no honest roster lists it), and average alike. With the
    rogue's id sorting first, its view makes it the leader and it sends
    its confirmation to the honest followers too; they skip it and join
    their own leader's group."""
    import hashlib

    def pid(pem):
        return hashlib.sha256(jid.Identity.load_or_create(
            pem).public_bytes).hexdigest()
    pems = [keys["p0"], keys["p1"]]
    n = 0
    while True:
        rogue = str(tmp_path / f"rogue{n}.pem")
        n += 1
        if (pid(rogue) < min(map(pid, pems))) == rogue_first:
            break
    sizes, members, results, pids = _swarm(
        keys, ("torch", "torch", "torch"),
        ["authority", "authority", "rogue"], f"auth-rogue-{rogue_first}",
        _inputs(3, 1), pems=pems + [rogue])
    assert sizes[:2] == [2, 2]
    assert members[0] == members[1] == sorted(pids[:2])
    assert pids[2] not in members[0]
    for a, b in zip(results[0], results[1]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_collaborative_peers_with_auth_exclude_a_rogue_peer(keys, tmp_path):
    """Three port ``CollaborativeOptimizer`` peers on tiny models, each
    with the experiment authority's authorizer; the third's token is the
    rogue authority's. The two authorized peers average in a group of
    two and end bitwise equal; the rogue's round never joins theirs."""
    import time

    from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                        tiny_model_config)
    from dalle_tpu_torch.data.synthetic import SyntheticCodes
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.optim import make_optimizer
    from dalle_tpu_torch.params import state_leaf_tensors
    from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
    from dalle_tpu_torch.training.steps import (TrainState, apply_step,
                                                grad_step)

    model_cfg = tiny_model_config(dim=64, heads=4, head_dim=16, depth=2)
    # synchronous rounds: a peer stops at the epoch its first round
    # closes, so both honest peers hold the state of that one round
    # a round's budget is min(allreduce_timeout, averaging_timeout minus
    # matchmaking) and a sender silent for a quarter of it is dropped:
    # 60 s keeps a loaded test host from dropping an honest sender
    cfg = CollabConfig(run_id="auth_co", target_batch_size=16,
                       matchmaking_time=3.0, allreduce_timeout=60.0,
                       averaging_timeout=60.0, average_state_every=0,
                       audit_gather=False, max_peer_weight=0,
                       delay_optimizer_step=False)
    tx = make_optimizer(OptimizerConfig(warmup_steps=2, total_steps=100))
    pub = jid.Identity.load_or_create(keys["authority"]).public_bytes
    nodes, opts = [], []
    for i, authority in enumerate(["authority", "authority", "rogue"]):
        ident = tid.Identity.load_or_create(keys[f"p{i}"])
        nodes.append(tdht.DHT(
            initial_peers=[nodes[0].visible_address] if nodes else [],
            identity=ident, rpc_timeout=2.0,
            record_validators=tmetrics.make_validators(ident, "auth_co")))
        token = tmp_path / f"{i}.token"
        token.write_bytes(_token(pauth, keys[authority],
                                 keys[f"p{i}"]).to_bytes())
        model = init_params(model_cfg, torch.Generator().manual_seed(0))
        model.train()
        # the rogue's round never completes: it waits less
        opt = CollaborativeOptimizer(
            nodes[-1], cfg if i < 2 else dataclasses.replace(
                cfg, allreduce_timeout=5.0, averaging_timeout=5.0),
            TrainState.create(model, tx),
            lambda s, g: apply_step(s, g, tx),
            authorizer=pauth.make_authorizer(pub.hex(), str(token)))
        opt.tracker.min_refresh_period = 0.05
        opts.append(opt)

    def train(i):
        data = SyntheticCodes(model_cfg, 64, seed=0).batches(8, seed=i)
        deadline = time.monotonic() + (90 if i < 2 else 20)
        while opts[i].local_epoch < 1 and time.monotonic() < deadline:
            batch = {k: torch.from_numpy(v).long()
                     for k, v in next(data).items()}
            _, _, g = grad_step(opts[i].state.model, batch)
            opts[i].step(g, batch_size=8)
        opts[i].finalize()

    threads = [threading.Thread(target=train, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [o.local_epoch for o in opts[:2]] == [1, 1]
        assert [o.last_timings["group_size"] for o in opts[:2]] == [2, 2]
        a, b = (state_leaf_tensors(o.state.model, o.state.opt_state)
                for o in opts[:2])
        assert all(torch.equal(x, y) for x, y in zip(a, b)), [
            (o.last_timings, {k: v for k, v in (o.last_wire_report or {})
                              .items() if k != "phases"}) for o in opts]
    finally:
        for o in opts:
            o.shutdown()
        for n in nodes[::-1]:
            n.shutdown()


def test_a_follower_skips_a_confirmation_its_leader_did_not_sign(keys):
    """A confirmation another peer signed reaches the follower's tag
    before its leader's (an unauthorized peer's view makes it a leader):
    the port's follower skips it and takes the leader's; the JAX
    package's reads only the first message and would sit the round out."""
    ids = [tid.Identity.load_or_create(keys[k]) for k in ("p0", "p1", "p2")]
    nodes = [tdht.DHT(identity=i, rpc_timeout=2.0) for i in ids]
    try:
        follower, leader, other = nodes
        members = [tmm.GroupMember(n.peer_id, n.visible_address, 1.0, b"",
                                   n.kx.public_bytes)
                   for n in (follower, leader)]
        tag = tmm._confirm_tag("cf", 3, follower.peer_id)
        forged = tmm._signed_confirmation(ids[2], "cf", 3, members, None)
        real = tmm._signed_confirmation(ids[1], "cf", 3, members, None)
        assert other.send(follower.visible_address, tag, forged, 5.0)
        assert leader.send(follower.visible_address, tag, real, 5.0)
        assert tmm._recv_leader_confirmation(
            follower, tag, "cf", 3, leader.peer_id, None, 5.0) == real
        # only messages the leader did not sign: None when the wait ends
        assert other.send(follower.visible_address, tag, forged, 5.0)
        assert tmm._recv_leader_confirmation(
            follower, tag, "cf", 3, leader.peer_id, None, 0.5) is None
    finally:
        for n in nodes[::-1]:
            n.shutdown()
