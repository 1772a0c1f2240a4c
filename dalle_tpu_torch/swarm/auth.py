"""Access-token authorization for swarm membership (the port's copy of
``dalle_tpu/swarm/auth.py``; tokens are byte-identical across the two
packages, so either package's authority issues tokens both accept).

Capability parity with the reference's HuggingFace auth flow
(``huggingface_auth.py:46-193`` of learning-at-home/dalle): an *authority*
(there: the HF "collaborative training auth" server) issues signed access
tokens binding ``{username, peer public key, expiration}``; every peer
carries its token, refreshes it before expiry (``:116-141``), and validates
other peers' tokens before collaborating (hivemind's ``TokenAuthorizerBase``
contract, ``:62-68``). Credential acquisition retries with exponential
backoff (``:23-35``).

No HTTP server: the authority is an Ed25519 keypair (the same
:class:`~dalle_tpu_torch.swarm.identity.Identity` machinery as peer
identities). Whoever runs the experiment holds the private key and issues
token files (``python -m dalle_tpu_torch.cli.issue_token``); peers are
configured with the authority's *public* key and their token, and
matchmaking drops candidates whose announce lacks a valid token bound to
their identity (``swarm/matchmaking.py``), so unauthorized peers never
enter an averaging group. Enforcement through the signed-record/confirmation layer means a
forged token cannot be grafted onto another peer's announce.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional

from dalle_tpu_torch.swarm.dht import get_dht_time
from dalle_tpu_torch.swarm.identity import Identity
from dalle_tpu_torch.utils import msgpack

logger = logging.getLogger(__name__)

_TOKEN_DOMAIN = b"dalle-tpu-access-token:"


@dataclasses.dataclass(frozen=True)
class AccessToken:
    """Signed statement: ``username`` may participate with the peer whose
    Ed25519 public key is ``peer_public_key``, until ``expiration_time``
    (DHT time). Mirrors the reference token fields (username, peer public
    key, expiry, signature — ``huggingface_auth.py:74-115``)."""

    username: str
    peer_public_key: bytes
    expiration_time: float
    signature: bytes

    def signing_message(self) -> bytes:
        return msgpack.packb(
            [_TOKEN_DOMAIN, self.username, self.peer_public_key,
             self.expiration_time])

    def to_bytes(self) -> bytes:
        return msgpack.packb(
            {"u": self.username, "pk": self.peer_public_key,
             "exp": self.expiration_time, "sig": self.signature})

    @classmethod
    def from_bytes(cls, raw: bytes) -> Optional["AccessToken"]:
        try:
            obj = msgpack.unpackb(raw, raw=False)
            return cls(username=str(obj["u"]),
                       peer_public_key=bytes(obj["pk"]),
                       expiration_time=float(obj["exp"]),
                       signature=bytes(obj["sig"]))
        # pure wire parser: None IS the "not a token" result; callers
        # (member_authorized) treat it as unauthorized and the roster
        # paths log the resulting drop where the context lives
        # graftlint: disable=silent-except
        except Exception:  # noqa: BLE001 - malformed wire data
            return None


class ExperimentAuthority:
    """Token issuer — the role the reference's auth server plays
    (``huggingface_auth.py:74-115``). Runs wherever the experiment owner
    keeps the authority private key (e.g. alongside the aux peer)."""

    def __init__(self, identity: Identity):
        self.identity = identity

    @property
    def public_key(self) -> bytes:
        return self.identity.public_bytes

    def issue(self, username: str, peer_public_key: bytes,
              ttl: float = 24 * 3600.0) -> AccessToken:
        token = AccessToken(username=username,
                            peer_public_key=peer_public_key,
                            expiration_time=get_dht_time() + ttl,
                            signature=b"")
        sig = self.identity.sign(token.signing_message())
        return dataclasses.replace(token, signature=sig)


def retry_with_backoff(fn: Callable, max_tries: int = 5,
                       initial_delay: float = 1.0, factor: float = 2.0):
    """Run ``fn`` retrying on exception with exponential backoff (parity
    with ``huggingface_auth.py:23-35``)."""
    delay = initial_delay
    for attempt in range(max_tries):
        try:
            return fn()
        except Exception:  # noqa: BLE001 - retried, re-raised on last try
            if attempt == max_tries - 1:
                raise
            logger.warning("auth operation failed (attempt %d/%d); "
                           "retrying in %.1fs", attempt + 1, max_tries,
                           delay, exc_info=True)
            time.sleep(delay)
            delay *= factor


class TokenAuthorizerBase:
    """Local-token management + remote-token validation (the contract the
    reference gets from hivemind's ``TokenAuthorizerBase``,
    ``huggingface_auth.py:62-68,116-141``).

    Subclasses implement ``_acquire_token`` (how a fresh local token is
    obtained) and ``validate_token`` (whether a remote token is good).
    """

    #: refresh the local token when it has less than this much life left
    refresh_margin: float = 300.0

    def __init__(self) -> None:
        self._local: Optional[AccessToken] = None

    def _acquire_token(self) -> AccessToken:
        raise NotImplementedError

    def get_token(self) -> Optional[AccessToken]:
        """The current local token, refreshed when close to expiry."""
        if (self._local is None or
                self._local.expiration_time - get_dht_time()
                < self.refresh_margin):
            self._local = retry_with_backoff(self._acquire_token)
        return self._local

    def local_token_bytes(self) -> Optional[bytes]:
        token = self.get_token()
        return token.to_bytes() if token is not None else None

    def validate_token(self, token: AccessToken,
                       peer_public_key: bytes) -> Optional[str]:
        """Username iff ``token`` is valid *and bound to this peer key*."""
        raise NotImplementedError

    def validate_token_bytes(self, raw: Optional[bytes],
                             peer_public_key: bytes) -> Optional[str]:
        if not raw:
            return None
        token = AccessToken.from_bytes(bytes(raw))
        if token is None:
            return None
        return self.validate_token(token, peer_public_key)


class ExperimentAuthorizer(TokenAuthorizerBase):
    """Peer-side authorizer: validates against the experiment authority's
    public key; acquires the local token from a file (written by
    ``cli.issue_token``) or a supplier callback."""

    def __init__(self, authority_public_key: bytes,
                 token_path: Optional[str] = None,
                 token_supplier: Optional[Callable[[], AccessToken]] = None):
        super().__init__()
        if len(authority_public_key) != 32:
            raise ValueError("authority public key must be 32 raw bytes")
        self.authority_public_key = authority_public_key
        self.token_path = token_path
        self.token_supplier = token_supplier

    def _acquire_token(self) -> AccessToken:
        if self.token_supplier is not None:
            return self.token_supplier()
        if self.token_path is None:
            raise RuntimeError(
                "authorization enabled but no token source configured "
                "(set auth_token_path or pass a token_supplier)")
        token = AccessToken.from_bytes(Path(self.token_path).read_bytes())
        if token is None:
            raise RuntimeError(f"unreadable access token {self.token_path}")
        if token.expiration_time < get_dht_time():
            # Without this check the peer would announce an expired token
            # forever: every honest peer silently drops its announces and it
            # trains solo with no diagnostic (the file never refreshes
            # itself — a human must re-issue it).
            raise RuntimeError(
                f"access token {self.token_path} expired at "
                f"{token.expiration_time:.0f} (now {get_dht_time():.0f}); "
                "re-issue with `python -m dalle_tpu_torch.cli.issue_token`")
        return token

    def validate_token(self, token: AccessToken,
                       peer_public_key: bytes) -> Optional[str]:
        if token.peer_public_key != peer_public_key:
            return None  # token stolen from / issued to another peer
        if token.expiration_time < get_dht_time():
            return None
        if not Identity.verify(self.authority_public_key, token.signature,
                               token.signing_message()):
            return None
        return token.username


def credentials_from_env() -> Optional[str]:
    """Username from the environment (the reference reads credentials from
    env vars before prompting, ``huggingface_auth.py:148-193``; there is no
    interactive prompt in an unattended peer)."""
    return (os.environ.get("DALLE_TPU_USERNAME")
            or os.environ.get("USER") or None)


def make_authorizer(authority_public_key_hex: Optional[str],
                    token_path: Optional[str]
                    ) -> Optional[ExperimentAuthorizer]:
    """Config-level constructor: None when auth is disabled (no authority
    configured), mirroring the reference's optional authorizer
    (``task.py:95-99``: authorizer only when ``authorize=True``)."""
    if not authority_public_key_hex:
        return None
    return ExperimentAuthorizer(bytes.fromhex(authority_public_key_hex),
                                token_path=token_path)
