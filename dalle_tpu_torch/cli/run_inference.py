"""Inference CLI: generate VQGAN code grids for prompts (the port's
``dalle_tpu/cli/run_inference.py``).

Samples ``--images-per-query`` image-code sequences a prompt with
temperature/top-k/top-p and saves the (B, grid, grid) code grids as
``.npz``; pixel decoding and CLIP reranking plug in behind
``--vqgan-checkpoint`` / ``--clip-checkpoint``. Image *j* of prompt *q*
samples with the noise seed ``--seed + q * images_per_query + j``.

Weights come from ``--seed`` (``init_params``); ``--checkpoint-dir`` and
``--tokenizer-path`` (and so ``--query``) raise until the port has a
checkpoint reader and a caption tokenizer. Prompts are given
pre-tokenized with ``--tokens`` (comma-separated ids, zero-padded to
``text_seq_len``), the counterpart of the server's ``tokens`` body.

Usage::

    python -m dalle_tpu_torch.cli.run_inference --preset tiny --device cpu \\
        --tokens 5,9,12 --images-per-query 2 --out out.npz
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from dalle_tpu_torch.cli import (CHECKPOINT_UNPORTED, MODEL_PRESETS,
                                 TOKENIZER_UNPORTED)
from dalle_tpu_torch.cli._args import add_dataclass_args, dataclass_from_args
from dalle_tpu_torch.config import ModelConfig

logger = logging.getLogger("dalle_tpu_torch.inference")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dalle-torch-inference", description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=sorted(MODEL_PRESETS),
                        default="flagship")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--tokenizer-path", type=str, default=None)
    parser.add_argument("--query", action="append", default=[],
                        help="caption to generate for (repeatable; needs "
                             "--tokenizer-path)")
    parser.add_argument("--tokens", action="append", default=[],
                        help="a pre-tokenized prompt, comma-separated ids "
                             "(repeatable)")
    parser.add_argument("--images-per-query", type=int, default=16,
                        help="reference generates 16 per query")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights and of the sampling")
    parser.add_argument("--out", type=str, default="generated.npz")
    parser.add_argument("--log-level", type=str, default="INFO")
    parser.add_argument(
        "--vqgan-checkpoint", type=str, default=None,
        help="taming-transformers f8 VQGAN .ckpt; decodes code grids to "
             "RGB pixels")
    parser.add_argument(
        "--clip-checkpoint", type=str, default=None,
        help="openai CLIP ViT-B/32 .pt; reranks decoded images (requires "
             "--vqgan-checkpoint and --clip-bpe)")
    parser.add_argument(
        "--clip-bpe", type=str, default=None,
        help="path to bpe_simple_vocab_16e6.txt.gz for CLIP tokenization")
    parser.add_argument(
        "--allow-unsafe-pickle", action="store_true",
        help="permit torch's full unpickler for VQGAN/CLIP checkpoints "
             "(EXECUTES code from the file — trusted origins only)")
    add_dataclass_args(parser, ModelConfig)
    return parser


def prompt_ids(spec: str, text_len: int):
    """``"5,9,12"`` -> (text_len,) int64 ids, zero-padded."""
    import numpy as np

    ids = [int(t) for t in spec.split(",") if t.strip()]
    if not 0 < len(ids) <= text_len:
        raise SystemExit(f"--tokens needs 1 to {text_len} ids, got "
                         f"{len(ids)}")
    out = np.zeros(text_len, np.int64)
    out[:len(ids)] = ids
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    if args.checkpoint_dir:
        raise SystemExit(CHECKPOINT_UNPORTED)
    if args.tokenizer_path or args.query:
        raise SystemExit(TOKENIZER_UNPORTED)
    if not args.tokens:
        raise SystemExit("give at least one prompt with --tokens")
    if args.clip_checkpoint and not (args.vqgan_checkpoint
                                     and args.clip_bpe):
        raise SystemExit("--clip-checkpoint requires --vqgan-checkpoint "
                         "and --clip-bpe")

    import numpy as np
    import torch

    from dalle_tpu_torch import resolve_device
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.decode import SamplingConfig, generate_images

    device = resolve_device(args.device)
    cfg = dataclass_from_args(ModelConfig, args,
                              base=MODEL_PRESETS[args.preset]())
    model = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed)).eval()
    sampling = SamplingConfig(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)

    vqgan = clip = clip_tok = None
    if args.vqgan_checkpoint:
        from dalle_tpu_torch.models.vqgan import (VQGANConfig, decode_codes,
                                                  load_taming_checkpoint)
        # f8 decoder: 8px per code in both axes
        vqgan = load_taming_checkpoint(
            args.vqgan_checkpoint,
            VQGANConfig(n_embed=cfg.vocab_image,
                        resolution=cfg.image_grid * 8),
            allow_unsafe=args.allow_unsafe_pickle).to(device)
    if args.clip_checkpoint:
        from dalle_tpu_torch.models.clip import (CLIPConfig, CLIPTokenizer,
                                                 clip_scores,
                                                 load_openai_checkpoint,
                                                 resize_for_clip)
        cl_cfg = CLIPConfig()
        clip = load_openai_checkpoint(
            args.clip_checkpoint, cl_cfg,
            allow_unsafe=args.allow_unsafe_pickle).to(device)
        clip_tok = CLIPTokenizer(args.clip_bpe, cl_cfg.context_length)

    n = args.images_per_query
    results = {}
    for qi, spec in enumerate(args.tokens):
        ids = prompt_ids(spec, cfg.text_seq_len)
        text = torch.from_numpy(np.tile(ids[None], (n, 1))).to(device)
        seeds = [args.seed + qi * n + j for j in range(n)]
        codes = generate_images(model, text, seeds, sampling).cpu().numpy()
        grids = codes.reshape(-1, cfg.image_grid, cfg.image_grid)
        results[f"query_{qi}_codes"] = grids
        results[f"query_{qi}_tokens"] = ids
        logger.info("prompt %d -> %d code grids (%dx%d, vocab %d)", qi,
                    grids.shape[0], cfg.image_grid, cfg.image_grid,
                    cfg.vocab_image)
        if vqgan is not None:
            images = decode_codes(vqgan, torch.from_numpy(codes).to(device))
            if clip is not None:
                # the prompt is ids, not a caption: score against the
                # empty prompt as a fixed anchor (as the server does; the
                # rerank across a prompt's images stays meaningful)
                tok = torch.from_numpy(clip_tok.encode("")[None]).to(device)
                scores = clip_scores(clip, resize_for_clip(images, clip.cfg),
                                     tok)[:, 0].cpu().numpy()
                order = np.argsort(-scores)
                images = images[torch.from_numpy(order).to(device)]
                results[f"query_{qi}_codes"] = grids[order]
                results[f"query_{qi}_clip_scores"] = scores[order]
            results[f"query_{qi}_images"] = images.cpu().numpy()
    np.savez(args.out, **results)
    logger.info("saved %s", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
