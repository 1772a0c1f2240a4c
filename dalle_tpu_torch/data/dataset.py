"""Streaming (caption, VQGAN-codes) dataset from shard files (the port's
copy of ``dalle_tpu/data/dataset.py``, on the port's MessagePack).

Capability parity with the reference's pipeline (``data.py:11-47`` of
learning-at-home/dalle), which streams ``laion/laion_100m_vqgan_f8`` and:

- filters records: caption at least 3 characters, NSFW marker ``UNLIKELY``,
  aspect ratio at most 2 (``data.py:12-20``);
- decodes the pre-computed VQGAN f8 image codes from little-endian int16
  bytes (``data.py:29-30``);
- shuffles with a bounded buffer (8192) seeded **per peer** so volunteers
  see different data order (``data.py:42-43``, seed from ``task.py:173``);
- T5-tokenizes captions and pads to max length with a loss mask over real
  tokens (``task.py:58-59,178-181``).

Records live in ``.msgpack`` shard files (one map per record, streamed):
a directory of shards, one file, a shard URL or a manifest URL
(``data/remote.py``). :func:`write_shard` writes the JAX package's bytes,
and :meth:`CodesDataset.batches` makes the JAX reader's
``np.random.Generator`` calls in its order, so a seed gives both packages
the same batches.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from dalle_tpu_torch.config import ModelConfig
from dalle_tpu_torch.data.tokenizer import CaptionTokenizer
from dalle_tpu_torch.utils import msgpack

SHUFFLE_BUFFER = 8192  # reference data.py:42-43


def write_shard(path: str, records: Sequence[Dict]) -> None:
    """Write records as a streamable msgpack shard.

    Each record: ``caption`` (str), ``codes`` (int16-LE bytes or int list),
    optional ``nsfw`` (str), ``width``/``height`` (int).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        for rec in records:
            rec = dict(rec)
            codes = rec.get("codes")
            if isinstance(codes, (list, tuple, np.ndarray)):
                rec["codes"] = np.asarray(codes, "<i2").tobytes()
            f.write(msgpack.packb(rec))


def record_filter(rec: Dict) -> bool:
    """The reference's quality filters (``data.py:12-20``)."""
    caption = rec.get("caption")
    if not isinstance(caption, str) or len(caption) < 3:
        return False
    nsfw = rec.get("NSFW", rec.get("nsfw"))
    if nsfw is not None and nsfw != "UNLIKELY":
        return False
    width, height = rec.get("width"), rec.get("height")
    if width and height:
        ratio = max(width, height) / max(1, min(width, height))
        if ratio > 2:
            return False
    return True


def decode_codes(rec: Dict, image_seq_len: int) -> Optional[np.ndarray]:
    """int32 codes from the record's int16-LE bytes (``data.py:29-30``)."""
    raw = rec.get("codes")
    if isinstance(raw, bytes):
        codes = np.frombuffer(raw, dtype="<i2").astype(np.int32)
    elif isinstance(raw, (list, tuple)):
        codes = np.asarray(raw, np.int32)
    else:
        return None
    if codes.shape[0] != image_seq_len:
        return None
    return codes


class CodesDataset:
    """Sharded streaming reader with per-peer shuffling and tokenization."""

    def __init__(self, path: str, cfg: ModelConfig,
                 tokenizer: Optional[CaptionTokenizer] = None,
                 tokenizer_path: Optional[str] = None,
                 shuffle_buffer: int = SHUFFLE_BUFFER):
        if tokenizer is None:
            if tokenizer_path is None:
                raise ValueError("need a tokenizer or tokenizer_path")
            tokenizer = CaptionTokenizer.load(tokenizer_path)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.shuffle_buffer = shuffle_buffer
        # local paths, single shard URLs and manifest URLs all resolve to
        # lazy openers: remote shards download into the local cache on
        # first use
        from dalle_tpu_torch.data.remote import resolve_shards
        self.shards = resolve_shards(path)
        if not self.shards:
            raise FileNotFoundError(f"no shard files under {path}")

    # -- record stream ----------------------------------------------------

    def _records(self, rng: np.random.Generator,
                 loop: bool) -> Iterator[Dict]:
        while True:
            order = rng.permutation(len(self.shards))
            for si in order:
                with open(self.shards[si](), "rb") as f:
                    for rec in msgpack.Unpacker(f):
                        if isinstance(rec, dict) and record_filter(rec):
                            yield rec
            if not loop:
                return

    def _shuffled(self, rng: np.random.Generator,
                  loop: bool) -> Iterator[Dict]:
        """Bounded-buffer shuffle (the reference's buffer(8192) semantics)."""
        buf: List[Dict] = []
        for rec in self._records(rng, loop):
            if len(buf) < self.shuffle_buffer:
                buf.append(rec)
                continue
            i = int(rng.integers(len(buf)))
            buf[i], rec = rec, buf[i]
            yield rec
        rng.shuffle(buf)  # type: ignore[arg-type]
        yield from buf

    # -- batches ----------------------------------------------------------

    def batches(self, batch_size: int, seed: int = 0,
                loop: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Collated batches: tokenized+padded text, int32 codes, loss mask
        (1 everywhere on image positions, caption padding masked out)."""
        cfg = self.cfg
        rng = np.random.default_rng(seed & 0xFFFFFFFF)
        texts: List[str] = []
        codes: List[np.ndarray] = []
        for rec in self._shuffled(rng, loop):
            c = decode_codes(rec, cfg.image_seq_len)
            if c is None or (c < 0).any() or (c >= cfg.vocab_image).any():
                continue
            texts.append(rec["caption"])
            codes.append(c)
            if len(texts) == batch_size:
                text_ids, text_mask = self.tokenizer.encode_batch(
                    texts, cfg.text_seq_len)
                img_mask = np.ones(
                    (batch_size, cfg.image_seq_len), np.float32)
                yield {
                    "text": text_ids,
                    "image": np.stack(codes),
                    "mask": np.concatenate([text_mask, img_mask], axis=1),
                }
                texts, codes = [], []
