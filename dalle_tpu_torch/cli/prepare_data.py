"""Data preparation CLI: train a tokenizer, build demo shards (the port's
copy of ``dalle_tpu/cli/prepare_data.py``).

The reference streams a prepared dataset from the HF Hub
(``laion/laion_100m_vqgan_f8``, ``data.py:42``); this tool covers the
offline legs of that pipeline:

- ``train-tokenizer``: fit the T5-style Unigram caption tokenizer from a
  text file (one caption per line) and save ``tokenizer.json``.
- ``synthetic-shards``: emit msgpack code shards from the synthetic
  generator — a runnable stand-in for a real VQGAN-codes export, in the
  exact on-disk schema ``CodesDataset`` consumes; the bytes equal the JAX
  package's for the same arguments. Needs no tokenizer.

``train-tokenizer`` needs the ``tokenizers`` package (its Unigram
trainer); nothing else here does.

Usage::

    python -m dalle_tpu_torch.cli.prepare_data train-tokenizer \
        --input captions.txt --vocab-size 8192 --out tok/tokenizer.json
    python -m dalle_tpu_torch.cli.prepare_data synthetic-shards \
        --out data/ --shards 4 --records 1024 --preset tiny
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

logger = logging.getLogger("dalle_tpu_torch.prepare_data")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dalle-torch-prepare-data")
    sub = parser.add_subparsers(dest="command", required=True)

    tt = sub.add_parser("train-tokenizer",
                        help="fit the caption tokenizer from a text file")
    tt.add_argument("--input", required=True,
                    help="text file, one caption per line")
    tt.add_argument("--vocab-size", type=int, default=32100)
    tt.add_argument("--out", required=True, help="tokenizer.json path")

    ss = sub.add_parser("synthetic-shards",
                        help="emit demo msgpack shards (synthetic codes)")
    ss.add_argument("--out", required=True, help="output directory")
    ss.add_argument("--shards", type=int, default=2)
    ss.add_argument("--records", type=int, default=512,
                    help="records per shard")
    ss.add_argument("--preset", choices=("tiny", "flagship"),
                    default="tiny")
    ss.add_argument("--seed", type=int, default=0)
    ss.add_argument(
        "--structured", action="store_true",
        help="codes follow a deterministic caption->texture grammar "
             "(8x8 motif tiling) instead of uniform noise: conditional "
             "code entropy given the caption is ~0 and the per-image "
             "alphabet is 64 codes, so a training run can drive the loss "
             "far below the ~9.0 uniform-entropy floor — the end-to-end "
             "learning-proof dataset")
    return parser


def train_tokenizer(args) -> None:
    from dalle_tpu_torch.data.tokenizer import CaptionTokenizer

    def corpus():
        with open(args.input) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line

    tok = CaptionTokenizer.train(corpus(), vocab_size=args.vocab_size,
                                 save_path=args.out)
    logger.info("trained tokenizer: vocab=%d -> %s", tok.vocab_size,
                args.out)


def structured_codes(caption: str, cfg, motif_bank) -> "np.ndarray":
    """Deterministic caption->codes grammar: the image grid is an 8x8
    texture motif (chosen by the caption's first word) tiled across the
    grid, value-shifted by the second word and row-sheared by the word
    count. Fully determined by the caption with a 64-code alphabet per
    image — a model that learns the grammar drives its image loss toward
    zero, far below the uniform floor ln(vocab)~9.0 that uniform shards
    cannot cross (the learning-proof dataset)."""
    import hashlib

    import numpy as np

    words = caption.split()
    h = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "big")
         for w in words[:3]] + [0, 0, 0]
    motif = motif_bank[h[0] % len(motif_bank)]          # (8, 8)
    shift = h[1] % cfg.vocab_image
    shear = len(words) % 8
    g = cfg.image_grid
    r = np.arange(g)[:, None]
    c = np.arange(g)[None, :]
    grid = motif[(r + shear * (c // 8)) % 8, c % 8]
    return ((grid + shift) % cfg.vocab_image).astype("<i2").reshape(-1)


def make_motif_bank(vocab_image: int, n: int = 16, seed: int = 7):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_image, size=(8, 8)) for _ in range(n)]


def synthetic_shards(args) -> None:
    import os

    import numpy as np

    from dalle_tpu_torch.config import ModelConfig, tiny_model_config
    from dalle_tpu_torch.data.dataset import write_shard

    cfg = (ModelConfig() if args.preset == "flagship"
           else tiny_model_config())
    rng = np.random.default_rng(args.seed)
    words = ["red", "blue", "green", "cat", "dog", "tree", "house", "sky",
             "boat", "mountain", "tiny", "large", "painting", "photo"]
    motif_bank = make_motif_bank(cfg.vocab_image) if args.structured \
        else None
    os.makedirs(args.out, exist_ok=True)
    for s in range(args.shards):
        records = []
        for _ in range(args.records):
            n = int(rng.integers(3, 8))
            caption = " ".join(rng.choice(words, size=n))
            if args.structured:
                codes = structured_codes(caption, cfg, motif_bank)
            else:
                codes = rng.integers(0, cfg.vocab_image,
                                     size=cfg.image_seq_len).astype("<i2")
            records.append({"caption": caption, "codes": codes.tobytes(),
                            "NSFW": "UNLIKELY",
                            "width": 256, "height": 256})
        path = os.path.join(args.out, f"shard_{s:05d}.msgpack")
        write_shard(path, records)
        logger.info("wrote %s (%d records%s)", path, len(records),
                    ", structured" if args.structured else "")


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level="INFO")
    args = build_parser().parse_args(argv)
    if args.command == "train-tokenizer":
        train_tokenizer(args)
    elif args.command == "synthetic-shards":
        synthetic_shards(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
