"""Router CLI: the fleet-serving HTTP front-end (the port's copy of
``dalle_tpu/cli/run_router.py``).

Joins the swarm DHT, discovers serving engines advertised under
``{experiment_prefix}_serving`` (``run_server --advertise`` publishes
them), and places every ``POST /generate`` by least predicted
completion with prompt-affinity hashing and 429/503/timeout failover
(``dalle_tpu_torch/serving/router.py``).

Usage::

    # engines (one per host/card):
    python -m dalle_tpu_torch.cli.run_server --preset tiny --device cpu \
        --http-port 8081 --prefix-cache-mb 64 \
        --advertise --port 31338 --initial-peers HOST:31337

    # the router:
    python -m dalle_tpu_torch.cli.run_router \
        --initial-peers HOST:31337 --http-port 8080

    curl -s localhost:8080/generate -d '{"tokens": [...], "seed": 7}'
    curl -s localhost:8080/stats     # ledger + engine table

``--static-engines URL[,URL...]`` skips the DHT entirely and routes
over a fixed engine list (each engine's /readyz slice is polled
directly) — smoke tests and single-host benches.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import urllib.error
import urllib.request
from typing import Dict, Optional, Sequence

from dalle_tpu_torch.cli._args import add_dataclass_args, dataclass_from_args
from dalle_tpu_torch.config import PeerConfig

logger = logging.getLogger("dalle_tpu_torch.router")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dalle-torch-router", description=__doc__.splitlines()[0])
    parser.add_argument("--http-host", type=str, default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=8080)
    parser.add_argument("--refresh-s", type=float, default=2.0,
                        help="record-table refresh period")
    parser.add_argument("--record-max-age-s", type=float, default=30.0,
                        help="records older than this are never placed "
                             "to (the stale-engine guard)")
    parser.add_argument("--request-timeout-s", type=float, default=300.0)
    parser.add_argument("--static-engines", type=str, default=None,
                        help="comma-separated engine base URLs: route "
                             "over this fixed list (polling each "
                             "/readyz) instead of DHT discovery")
    parser.add_argument("--log-level", type=str, default="INFO")
    add_dataclass_args(parser, PeerConfig)
    return parser


def static_fetch_records(urls, timeout_s: float = 5.0):
    """Record provider for ``--static-engines``: poll each engine's
    /readyz directly and shape the answer like a DHT record (same
    placement inputs, no DHT). A non-answering engine simply has no
    record this refresh — the staleness rule the DHT path gets from
    TTL expiry."""
    from dalle_tpu_torch.swarm.dht import get_dht_time

    def fetch() -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for url in urls:
            try:
                with urllib.request.urlopen(url + "/readyz",
                                            timeout=timeout_s) as resp:
                    rec = json.loads(resp.read())
            except urllib.error.HTTPError as e:
                # 503 is a DESIGNED /readyz answer (draining/full): the
                # body still carries the slice; the healthy() filter
                # reads draining/queue state from it
                try:
                    with e:
                        rec = json.loads(e.read())
                except (ValueError, OSError):
                    continue
            except Exception as e:  # noqa: BLE001 - an unreachable
                # engine has no record this refresh (the staleness
                # rule); debug-level because this polls every refresh
                logger.debug("engine %s unreachable this refresh: %s",
                             url, e)
                continue
            if not isinstance(rec, dict):
                continue
            rec["url"] = url
            rec["t"] = get_dht_time()
            out[url] = rec
        return out

    return fetch


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from dalle_tpu_torch.serving.router import (Router, RouterHTTPServer,
                                                dht_fetch_records)

    dht = None
    if args.static_engines:
        urls = [u.strip().rstrip("/")
                for u in args.static_engines.split(",") if u.strip()]
        fetch = static_fetch_records(urls)
        source = f"{len(urls)} static engine(s)"
    else:
        peer = dataclass_from_args(PeerConfig, args)
        from dalle_tpu_torch.swarm.dht import DHT
        from dalle_tpu_torch.swarm.identity import Identity
        from dalle_tpu_torch.swarm.metrics import make_validators
        # the standard validator chain: in a validated swarm, records
        # without the signed ownership marker are dropped on read —
        # a router built without validators would SEE them, but its
        # own reads must enforce the same authenticity bar the rest
        # of the swarm does (spoofed engine records are a traffic-
        # steering primitive otherwise)
        ident = Identity.load_or_create(peer.identity_path)
        dht = DHT(host=peer.host, port=peer.port,
                  initial_peers=list(peer.initial_peers),
                  client_mode=peer.client_mode,
                  identity=ident,
                  record_validators=make_validators(
                      ident, peer.experiment_prefix))
        fetch = dht_fetch_records(dht, peer.experiment_prefix)
        source = (f"DHT key '{peer.experiment_prefix}_serving' "
                  f"(peer {dht.peer_id[:12]})")

    router = Router(fetch, refresh_s=args.refresh_s,
                    record_max_age_s=args.record_max_age_s).start()
    router.refresh_once()
    httpd = RouterHTTPServer((args.http_host, args.http_port), router,
                             request_timeout_s=args.request_timeout_s)
    logger.info("=" * 60)
    logger.info("routing on http://%s:%d over %s", args.http_host,
                httpd.server_address[1], source)
    logger.info("POST /generate (placed by least predicted completion, "
                "prompt affinity, 429/503/timeout failover) | "
                "GET /stats | /engines | /readyz")
    logger.info("=" * 60)

    import signal

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("interrupt: stopping router")
    finally:
        httpd.server_close()
        router.stop()
        if dht is not None:
            dht.shutdown()
        logger.info("final ledger: %s", router.stats()["ledger"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
