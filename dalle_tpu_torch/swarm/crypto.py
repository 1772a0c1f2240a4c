"""Confidentiality for the swarm data plane.

The reference rides go-libp2p-daemon, whose transports are encrypted by
libp2p's security handshake (SURVEY.md §2 component 17); our C++ daemon
speaks plain TCP. Rather than re-implementing a
transport handshake inside the daemon, confidentiality is layered at the
framing level, above the existing Ed25519 *authentication* (signed records,
signed data-plane frames, signed matchmaking confirmations):

- :func:`seal_to` / :func:`open_sealed` — an X25519 sealed box (ephemeral-
  static ECDH -> HKDF-SHA256 -> ChaCha20-Poly1305). Used for state-transfer
  chunks (the requester's ephemeral public key rides in its signed request)
  and for distributing group keys.
- :func:`encrypt` / :func:`decrypt` — symmetric AEAD under a per-round
  *group key*: the matchmaking leader mints a random 32-byte key and seals
  it to each member's kx public key inside the signed confirmation
  (swarm/matchmaking.py), then every all-reduce chunk of the round is
  AEAD-wrapped. A peer that missed the confirmation cannot decrypt and
  simply falls out of the round — the same ban-and-proceed elasticity as
  any other failure.

All primitives come from the ``cryptography`` library (the package already
used for Ed25519 identities); nothing here is hand-rolled crypto.
"""

from __future__ import annotations

import os
from typing import Optional

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
except ImportError:  # hosts without the wheel: bundled RFC 7748/8439
    # fallback — NOTE its AEAD is not wire-compatible with the real
    # ChaCha20-Poly1305 (see _fallback_crypto docstring); mixed fleets
    # need encrypt_data_plane=False
    from dalle_tpu_torch.swarm._fallback_crypto import (  # type: ignore
        ChaCha20Poly1305, HKDF, X25519PrivateKey, X25519PublicKey, hashes,
        serialization, warn_once)
    warn_once()

_NONCE = 12
_EPK = 32
_HKDF_INFO = b"dalle-tpu-sealed-box-v1"


class KxKeypair:
    """X25519 key-agreement keypair (per-process; published next to the
    peer's signed announces, never persisted — forward secrecy across
    restarts comes free)."""

    def __init__(self, private_key: Optional[X25519PrivateKey] = None):
        self._key = private_key or X25519PrivateKey.generate()
        self.public_bytes = self._key.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    def _derive(self, their_public: bytes) -> bytes:
        shared = self._key.exchange(
            X25519PublicKey.from_public_bytes(their_public))
        return HKDF(algorithm=hashes.SHA256(), length=32, salt=None,
                    info=_HKDF_INFO).derive(shared)


def seal_to(recipient_public: bytes, plaintext: bytes) -> bytes:
    """Encrypt so only the holder of the matching X25519 private key can
    read: ``ephemeral_pub(32) || nonce(12) || AEAD ciphertext``."""
    eph = KxKeypair()
    key = eph._derive(recipient_public)
    nonce = os.urandom(_NONCE)
    ct = ChaCha20Poly1305(key).encrypt(nonce, plaintext, eph.public_bytes)
    return eph.public_bytes + nonce + ct


def open_sealed(kx: KxKeypair, blob: bytes) -> Optional[bytes]:
    if len(blob) < _EPK + _NONCE + 16:
        return None
    epk, nonce, ct = (blob[:_EPK], blob[_EPK:_EPK + _NONCE],
                      blob[_EPK + _NONCE:])
    try:
        key = kx._derive(epk)
        return ChaCha20Poly1305(key).decrypt(nonce, ct, epk)
    # AEAD-open contract: every failure mode collapses to "unreadable"
    # on purpose — distinguishing (or logging) why a ciphertext failed
    # builds a decryption oracle out of the log stream
    # graftlint: disable=silent-except
    except Exception:  # noqa: BLE001 - any crypto failure = unreadable
        return None


def new_group_key() -> bytes:
    return os.urandom(32)


def encrypt(group_key: bytes, plaintext: bytes) -> bytes:
    """Symmetric AEAD under the round's group key:
    ``nonce(12) || ciphertext``."""
    nonce = os.urandom(_NONCE)
    return nonce + ChaCha20Poly1305(group_key).encrypt(nonce, plaintext, b"")


def decrypt(group_key: bytes, blob: bytes) -> Optional[bytes]:
    if len(blob) < _NONCE + 16:
        return None
    try:
        return ChaCha20Poly1305(group_key).decrypt(
            blob[:_NONCE], blob[_NONCE:], b"")
    # same AEAD-open contract as open_sealed: constant "unreadable"
    # behavior, no failure-reason oracle in the logs
    # graftlint: disable=silent-except
    except Exception:  # noqa: BLE001 - any crypto failure = unreadable
        return None


def maybe_encrypt(group_key: Optional[bytes], frame: bytes) -> bytes:
    return frame if group_key is None else encrypt(group_key, frame)


def maybe_decrypt(group_key: Optional[bytes],
                  blob: Optional[bytes]) -> Optional[bytes]:
    if blob is None or group_key is None:
        return blob
    return decrypt(group_key, bytes(blob))
