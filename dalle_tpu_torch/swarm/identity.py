"""Peer identity: Ed25519 keypair, persisted, hashed into a DHT node id.

Parity with the reference's persistent libp2p identity
(learning-at-home/dalle arguments.py:118-124: ``identity_path`` pointing at
an RSA key generated by go-libp2p-daemon's p2p-keygen) and with hivemind's
"public key IS the peer identity" validator design (utils.py:27-30). Ed25519
replaces RSA — smaller keys/signatures on the wire, standard for modern p2p
stacks.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Optional

try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey, Ed25519PublicKey)
except ImportError:  # hosts without the wheel: bundled RFC 8032 fallback
    from dalle_tpu_torch.swarm._fallback_crypto import (  # type: ignore
        Ed25519PrivateKey, Ed25519PublicKey, serialization, warn_once)
    warn_once()  # loudly, whichever path (generate/load) is used first


class Identity:
    """An Ed25519 keypair with the derived 32-byte DHT node id."""

    def __init__(self, private_key: Ed25519PrivateKey):
        self._key = private_key
        self.public_bytes = self._key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        self.node_id = hashlib.sha256(self.public_bytes).digest()

    @classmethod
    def generate(cls) -> "Identity":
        return cls(Ed25519PrivateKey.generate())

    @classmethod
    def load_or_create(cls, path: Optional[str]) -> "Identity":
        """Deterministic identity from a key file (created on first use);
        None -> fresh ephemeral identity (reference arguments.py:118-124)."""
        if path is None:
            return cls.generate()
        p = Path(path)
        if p.exists():
            key = serialization.load_pem_private_key(p.read_bytes(),
                                                     password=None)
            if not isinstance(key, Ed25519PrivateKey):
                raise ValueError(f"{path} is not an Ed25519 private key")
            return cls(key)
        ident = cls.generate()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(ident._key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
        p.chmod(0o600)
        return ident

    def sign(self, message: bytes) -> bytes:
        return self._key.sign(message)

    @staticmethod
    def verify(public_bytes: bytes, signature: bytes, message: bytes) -> bool:
        try:
            Ed25519PublicKey.from_public_bytes(public_bytes).verify(
                signature, message)
            return True
        # signature-verify contract: malformed key, bad length, and bad
        # signature all mean exactly "invalid" — hot read-path callers
        # (every DHT record, every wire frame) drop and move on
        # graftlint: disable=silent-except
        except Exception:  # noqa: BLE001 - any crypto failure = invalid
            return False


PK_LEN, SIG_LEN = 32, 64


def signed_frame(identity: "Identity", ctx: bytes, head: bytes,
                 payload: bytes) -> bytes:
    """``head || pubkey || sig || payload`` with the Ed25519 signature over
    ``sha256(ctx || head || payload)``. The single signed-frame scheme for
    every data-plane message (all-reduce chunks, state-transfer chunks) —
    one implementation so a binding fix cannot silently miss a call site.
    """
    digest = hashlib.sha256(ctx + head + payload).digest()
    return head + identity.public_bytes + identity.sign(digest) + payload


def open_frame(raw: bytes, ctx: bytes, head_len: int,
               expected_pid: Optional[str]):
    """(head, payload) iff the frame verifies; ``expected_pid`` (hex
    sha256 of the signer's key) pins the signer when known, else the
    caller must check the recovered signer id itself (also returned).

    Returns (head, payload, signer_pid) or None.
    """
    prefix_len = head_len + PK_LEN + SIG_LEN
    if len(raw) < prefix_len:
        return None
    head = raw[:head_len]
    pk = raw[head_len:head_len + PK_LEN]
    sig = raw[head_len + PK_LEN:prefix_len]
    payload = raw[prefix_len:]
    signer = hashlib.sha256(pk).hexdigest()
    if expected_pid is not None and signer != expected_pid:
        return None
    digest = hashlib.sha256(ctx + head + payload).digest()
    if not Identity.verify(pk, sig, digest):
        return None
    return head, payload, signer
