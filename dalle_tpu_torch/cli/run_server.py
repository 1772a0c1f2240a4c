"""Serving CLI: the continuous-batching HTTP front-end (the port's
``dalle_tpu/cli/run_server.py``).

A slot-recycled KV-cache engine (``dalle_tpu_torch/serving/``) admits
requests mid-flight instead of waiting for batch formation, and VQGAN
pixel decode + CLIP rerank of finished requests overlap ongoing token
generation on a worker thread. On the card the engine's chunk is one
CUDA graph a prefix bucket, captured at start.

Usage::

    python -m dalle_tpu_torch.cli.run_server --preset tiny --device cpu \\
        --tokenizer-path tok/tokenizer.json --http-port 8080

    curl -s localhost:8080/generate -d '{"text": "a red cat", \\
        "n_images": 4, "seed": 7, "temperature": 0.8, "top_k": 64}'
    curl -s localhost:8080/stats

Weights come from the freshest checkpoint under ``--checkpoint-dir``
(the port trainer's files and the JAX trainer's), or else from ``--seed``
(``init_params``), as the JAX CLIs serve them with ``--random-init``.
With ``--tokenizer-path`` a request may carry a caption (``text``);
without it, pre-tokenized ``tokens`` only. ``--advertise`` joins the swarm
DHT (the ``PeerConfig`` flags) and publishes this engine's ``/readyz``
slice under ``{prefix}_serving`` for ``run_router``.
``--temperature``/``--top-k``/``--top-p`` set the engine-wide default; a request body may override any
of them per request (the knobs are per-slot tensors of the chunk, so a
novel temperature captures nothing new). Ctrl-C and SIGTERM both drain.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from dalle_tpu_torch.cli import MODEL_PRESETS, restore_weights
from dalle_tpu_torch.cli._args import (add_dataclass_args,
                                       check_no_collisions,
                                       dataclass_from_args)
from dalle_tpu_torch.config import ModelConfig, PeerConfig, ServingConfig

logger = logging.getLogger("dalle_tpu_torch.server")

CONFIG_CLASSES = (ModelConfig, ServingConfig, PeerConfig)


def build_parser() -> argparse.ArgumentParser:
    check_no_collisions(*CONFIG_CLASSES)
    parser = argparse.ArgumentParser(
        prog="dalle-torch-server", description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=sorted(MODEL_PRESETS),
                        default="flagship")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="serve the parameters of the freshest "
                             "checkpoint here (port or JAX trainer)")
    parser.add_argument("--random-init", action="store_true",
                        help="serve freshly initialized weights (the "
                             "default without --checkpoint-dir)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the initialized weights")
    parser.add_argument("--tokenizer-path", type=str, default=None,
                        help="tokenizer.json; without it only "
                             "pre-tokenized 'tokens' requests are served")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--metrics-file", type=str, default=None,
                        help="append one serving-metrics JSON line per "
                             "--metrics-interval-s")
    parser.add_argument(
        "--vqgan-checkpoint", type=str, default=None,
        help="taming-transformers VQGAN .ckpt: decode finished requests "
             "to pixels on the overlap worker")
    parser.add_argument(
        "--clip-checkpoint", type=str, default=None,
        help="openai CLIP .pt: score decoded images against the query "
             "(requires --vqgan-checkpoint and --clip-bpe)")
    parser.add_argument("--clip-bpe", type=str, default=None)
    parser.add_argument(
        "--allow-unsafe-pickle", action="store_true",
        help="permit torch's full unpickler for VQGAN/CLIP checkpoints "
             "(EXECUTES code from the file — trusted origins only)")
    parser.add_argument(
        "--advertise", action="store_true",
        help="join the swarm DHT (PeerConfig flags: --port, "
             "--initial-peers, --identity-path, --experiment-prefix) "
             "and advertise this engine's /readyz slice under "
             "{prefix}_serving so a run_router front-end places to it")
    parser.add_argument(
        "--advertise-url", type=str, default=None,
        help="the URL OTHER hosts reach this engine at (default "
             "http://<http-host>:<http-port> — override when bound to "
             "0.0.0.0 or behind a port map)")
    parser.add_argument("--advert-ttl", "--advertise-ttl", type=float,
                        default=None, dest="advert_ttl",
                        help="serving-record TTL seconds (default "
                             "router.DEFAULT_SERVING_TTL)")
    parser.add_argument(
        "--prime-service-s", type=float, default=None,
        help="seed the decode service EMA with this calibrated "
             "per-request cadence (seconds): the deadline shedder is "
             "live from request one")
    parser.add_argument("--log-level", type=str, default="INFO")
    for cls in CONFIG_CLASSES:
        add_dataclass_args(parser, cls)
    return parser


def pixel_fns(vqgan, clip=None, clip_tokens=None):
    """(pixel_fn, degraded_fn) for the overlap worker from a VQGAN decoder
    and, optionally, a CLIP model with the (1, context_length) tokens to
    score against. ``pixel_fn`` decodes and scores, ``degraded_fn`` (the
    brownout variant) only decodes; both run on the caller's current
    stream (the worker's own, on the card)."""
    import torch

    from dalle_tpu_torch.models.clip import clip_scores, resize_for_clip
    from dalle_tpu_torch.models.vqgan import decode_codes

    device = next(vqgan.parameters()).device

    def decode(codes):
        return decode_codes(vqgan, torch.from_numpy(codes[None]).to(device))

    def degraded_fn(codes):
        return {"images": decode(codes)[0].cpu().numpy()}

    if clip is None:
        return degraded_fn, degraded_fn

    def pixel_fn(codes):
        imgs = decode(codes)
        score = clip_scores(clip, resize_for_clip(imgs, clip.cfg),
                            clip_tokens)
        return {"images": imgs[0].cpu().numpy(),
                "clip_score": float(score[0, 0])}

    return pixel_fn, degraded_fn


def _build_pixel_fn(args, cfg, device):
    """(pixel_fn, degraded_fn) from the checkpoints, or (None, None) when
    no VQGAN checkpoint is configured."""
    if not args.vqgan_checkpoint:
        return None, None
    import torch

    from dalle_tpu_torch.models.vqgan import (VQGANConfig,
                                              load_taming_checkpoint)
    vqgan = load_taming_checkpoint(
        args.vqgan_checkpoint,
        VQGANConfig(n_embed=cfg.vocab_image, resolution=cfg.image_grid * 8),
        allow_unsafe=args.allow_unsafe_pickle).to(device)
    clip = tokens = None
    if args.clip_checkpoint:
        if not args.clip_bpe:
            raise SystemExit("--clip-checkpoint requires --clip-bpe")
        from dalle_tpu_torch.models.clip import (CLIPConfig, CLIPTokenizer,
                                                 load_openai_checkpoint)
        cl_cfg = CLIPConfig()
        clip = load_openai_checkpoint(
            args.clip_checkpoint, cl_cfg,
            allow_unsafe=args.allow_unsafe_pickle).to(device)
        # served requests have no caption handy post-tokenization;
        # score against the empty prompt as a fixed anchor (rerank
        # across a query's n_images stays meaningful)
        tokens = torch.from_numpy(CLIPTokenizer(
            args.clip_bpe, cl_cfg.context_length).encode("")[None]).to(
                device)
    return pixel_fns(vqgan, clip, tokens)


def advertise_engine(args, serving, engine, httpd):
    """``(dht, advertiser)`` for ``--advertise`` (else ``(None, None)``):
    this engine's ``/readyz`` slice rides a TTL'd DHT record under
    ``{prefix}_serving``, the router's placement input. The DHT carries
    the standard validator chain, so the record's subkey has the signed
    ownership marker that validated swarm peers demand."""
    if not args.advertise:
        return None, None
    from dalle_tpu_torch.serving.router import (DEFAULT_SERVING_TTL,
                                                ServingAdvertiser)
    from dalle_tpu_torch.swarm.dht import DHT
    from dalle_tpu_torch.swarm.identity import Identity
    from dalle_tpu_torch.swarm.metrics import make_validators
    peer = dataclass_from_args(PeerConfig, args)
    ident = Identity.load_or_create(peer.identity_path)
    dht = DHT(host=peer.host, port=peer.port,
              initial_peers=list(peer.initial_peers),
              client_mode=peer.client_mode, identity=ident,
              record_validators=make_validators(ident,
                                                peer.experiment_prefix))
    url = args.advertise_url or (
        f"http://{serving.http_host}:{httpd.server_address[1]}")
    advertiser = ServingAdvertiser(
        dht, peer.experiment_prefix, engine, url,
        ttl=args.advert_ttl or DEFAULT_SERVING_TTL)
    advertiser.publish_once()
    advertiser.start()
    logger.info("advertising %s under '%s_serving' (peer %s)",
                url, peer.experiment_prefix, dht.peer_id[:12])
    return dht, advertiser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    import torch

    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.decode import SamplingConfig
    from dalle_tpu_torch.serving.engine import DecodeEngine
    from dalle_tpu_torch.serving.metrics import ServingMetrics
    from dalle_tpu_torch.serving.pixels import PixelPipeline
    from dalle_tpu_torch.serving.server import ServingHTTPServer

    device = resolve_device(args.device)
    cfg = dataclass_from_args(ModelConfig, args,
                              base=MODEL_PRESETS[args.preset]())
    serving = dataclass_from_args(ServingConfig, args)
    serving.validate()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed)).eval()
    if args.checkpoint_dir and not restore_weights(
            model, args.checkpoint_dir, logger):
        return 1

    metrics = ServingMetrics(n_slots=serving.n_slots,
                             jsonl_path=args.metrics_file,
                             interval_s=serving.metrics_interval_s)
    if args.prime_service_s is not None:
        metrics.prime_service(args.prime_service_s, force=True)
    pixel_fn, degraded_fn = _build_pixel_fn(args, cfg, device)
    pipeline = (PixelPipeline(
        pixel_fn, metrics=metrics, degraded_fn=degraded_fn,
        stream=torch.cuda.Stream(device) if device.type == "cuda" else None)
        if pixel_fn is not None else None)
    engine = DecodeEngine(
        model, cfg, serving,
        sampling=SamplingConfig(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        pixel_pipeline=pipeline, metrics=metrics).start()

    tokenizer = None
    if args.tokenizer_path:
        from dalle_tpu_torch.data.tokenizer import CaptionTokenizer
        tokenizer = CaptionTokenizer.load(args.tokenizer_path)
    httpd = ServingHTTPServer((serving.http_host, serving.http_port),
                              engine, tokenizer=tokenizer,
                              request_timeout_s=serving.request_timeout_s)
    dht, advertiser = advertise_engine(args, serving, engine, httpd)

    logger.info("=" * 60)
    logger.info("serving %s on http://%s:%d (%s, %d slots, %d-step chunks, "
                "%d prefix buckets%s)", args.preset, serving.http_host,
                httpd.server_address[1], device, serving.n_slots,
                serving.steps_per_call, engine.n_buckets,
                ", pixel overlap" if pipeline else "")
    logger.info("POST /generate {\"text\"|\"tokens\", \"n_images\", "
                "\"seed\", \"lane\", \"deadline_s\"} | GET /stats | "
                "GET /metrics | GET /healthz (live) | GET /readyz "
                "(placement)")
    if engine.chaos is not None:
        logger.warning("serve chaos plan ACTIVE (--chaos-plan) — this "
                       "server injects faults on purpose")
    logger.info("=" * 60)

    # SIGTERM (k8s/systemd stop) drains exactly like Ctrl-C: the handler
    # runs on the main thread, so raising here unwinds serve_forever
    import signal

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("interrupt: draining engine "
                    "(bounded by drain_timeout_s=%.0fs)",
                    serving.drain_timeout_s)
    finally:
        # the advertiser stops before the DHT is torn down (a publish
        # against a dead native node is a use-after-free)
        if advertiser is not None:
            advertiser.stop()
        httpd.server_close()
        engine.stop(drain=True)
        if dht is not None:
            dht.shutdown()
        logger.info("drained; final stats: %s", engine.stats())
    return 0


if __name__ == "__main__":
    sys.exit(main())
