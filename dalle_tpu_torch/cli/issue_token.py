"""Issue an access token for a peer (the experiment-authority role; the
port's copy of ``dalle_tpu/cli/issue_token.py``, whose tokens both
packages accept).

The reference's tokens come from the HuggingFace "collaborative training
auth" server (``huggingface_auth.py:74-115`` of learning-at-home/dalle:
join experiment -> signed token {username, peer public key, expiry}). Here
the authority is an Ed25519 keypair held by whoever runs the experiment;
this tool signs a token binding a username to a peer identity.

Usage::

    # once: create the authority key and print its public key
    python -m dalle_tpu_torch.cli.issue_token --authority-key authority.pem \
        --print-public-key

    # per peer: issue a token for a peer's identity file
    python -m dalle_tpu_torch.cli.issue_token --authority-key authority.pem \
        --username alice --peer-identity peer.pem --ttl 86400 \
        --out alice.token

Peers then run with ``--auth-authority <hex pubkey>
--auth-token-path alice.token``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dalle-torch-issue-token", description=__doc__.splitlines()[0])
    parser.add_argument("--authority-key", type=str, required=True,
                        help="authority Ed25519 PEM (created if missing)")
    parser.add_argument("--print-public-key", action="store_true",
                        help="print the authority public key (hex) and exit")
    parser.add_argument("--username", type=str, default=None,
                        help="defaults to DALLE_TPU_USERNAME / USER from "
                             "the environment")
    parser.add_argument("--peer-identity", type=str, default=None,
                        help="peer identity PEM (its public key is bound "
                             "into the token)")
    parser.add_argument("--ttl", type=float, default=24 * 3600.0,
                        help="token lifetime in seconds")
    parser.add_argument("--out", type=str, default=None,
                        help="token output path (default <username>.token)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from dalle_tpu_torch.swarm.auth import (ExperimentAuthority,
                                            credentials_from_env)
    from dalle_tpu_torch.swarm.identity import Identity

    authority = ExperimentAuthority(
        Identity.load_or_create(args.authority_key))
    if args.print_public_key:
        print(authority.public_key.hex())
        return 0

    username = args.username or credentials_from_env()
    if not username or not args.peer_identity:
        print("--username (or DALLE_TPU_USERNAME/USER in the environment) "
              "and --peer-identity are required to issue", file=sys.stderr)
        return 2
    if not Path(args.peer_identity).exists():
        # load-only: silently minting a fresh keypair here would bind the
        # token to a key the real peer does not hold
        print(f"peer identity {args.peer_identity} does not exist",
              file=sys.stderr)
        return 2
    peer = Identity.load_or_create(args.peer_identity)
    token = authority.issue(username, peer.public_bytes, ttl=args.ttl)
    out = Path(args.out or f"{username}.token")
    out.write_bytes(token.to_bytes())
    print(f"issued token for {username!r} -> {out} "
          f"(peer {peer.node_id.hex()[:16]}, "
          f"authority {authority.public_key.hex()[:16]}...)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
