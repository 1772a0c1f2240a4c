"""Make the data slice's committed fixtures from the JAX package.

The card's machine has neither JAX nor the ``tokenizers`` package, so the
port's data path is held there against numbers made here, by the
reference:

- ``tests/data/tokenizer.json``: a caption tokenizer trained by the JAX
  ``CaptionTokenizer.train`` on :func:`caption_corpus` (a vocabulary of
  ~1.5k). The library's Unigram trainer is not deterministic in the last
  bits of its scores (its hash maps order the sums), so a retrain gives
  the same vocabulary and components with scores that agree to ~1e-12;
  the committed file is the one every golden below is made from.
- ``tests/data/golden_ids.json``: the JAX tokenizer's ids and masks for
  :data:`EDGE_CAPTIONS` at the flagship's 256 text positions and at 8.
- ``tests/data/golden_data.json``: the sha256 of the two shards that the
  JAX ``prepare_data synthetic-shards --preset flagship --shards 2
  --records 64 --seed 0`` writes, and of the text, image and mask arrays
  of the first two batches of 8 that the JAX ``CodesDataset`` reads from
  them with :data:`DATA_SEED` and the fixture tokenizer.
- ``dalle_tpu_torch/data/_unicode_tables.py``: the code points that
  Python's ``unicodedata`` normalizes and the library's NFKC does not
  know (the library's Unicode tables are older).

Run from the repository root (needs JAX, ``msgpack`` and ``tokenizers``)::

    JAX_PLATFORMS=cpu python tests/data/make_fixtures.py

``tests/test_torch_tokenizer.py`` and ``tests/test_torch_data.py``
regenerate each fixture and compare it with the committed copy.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import unicodedata
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "tests", "data")
TOKENIZER = os.path.join(HERE, "tokenizer.json")
GOLDEN_IDS = os.path.join(HERE, "golden_ids.json")
GOLDEN_DATA = os.path.join(HERE, "golden_data.json")
UNICODE_TABLES = os.path.join(ROOT, "dalle_tpu_torch", "data",
                              "_unicode_tables.py")

VOCAB_SIZE = 2000
DATA_SEED = 12345          # the reader's seed for the golden batches
DATA_BATCH = 8             # the flagship trainer's local batch (4 x 2)
SHARD_ARGS = ["--shards", "2", "--records", "64", "--preset", "flagship",
              "--seed", "0"]
MAX_LENS = (256, 8)

#: captions with Unicode and whitespace edge cases; the first four are
#: the text prompts of chip_smoke.py's phase 12b
EDGE_CAPTIONS: List[str] = [
    "a red cat on a blue boat",
    "painting of a large mountain at dusk",
    "photo of a tiny green house",
    "a red cat on a blue boat",
    "",
    " ",
    "   ",
    "a",
    "  leading and trailing  ",
    "tabs\tand\nnewlines\r\nand\x0bcontrol\x01chars\x7f\x00nul",
    "no-break\u00a0space and\u2009thin\u3000ideographic\u1680ogham",
    "zero\u200bwidth\u200djoiner\ufeffbom\u2028line\u2029para",
    "literal {2,} pattern",
    "many     spaces     here",
    "\u2581metaspace\u2581\u2581char",
    "caf\u00e9 cafe\u0301 na\u00efve \u00fcber",
    "\ufb01sh \u2460 \uff21\uff22\uff23 \u00bd \u2167",
    "\u65e5\u672c \u6771\u4eac \u732b \u72ac",
    "emoji \U0001f642\U0001f680 \U0001f1fa\U0001f1f8",
    "\u32ff \ua7f2 \U00010781 \U0001e030 a\u07fd\u0301",
    "\u0915\u094d\u0937 \u0627\u0644\u0639\u0631\u0628\u064a\u0629",
    "<pad> special </s> tokens <unk> inline",
    "a<pad>b</s>",
    "\uff1cpad\uff1e fullwidth brackets",
    "\ufffd replacement \t\t tabs",
    "qqqq zzzz xxxx unknown letters",
    "UPPER lower MiXeD 12345 !?.,;:",
    "s\u00e3o paulo z\u00fcrich cr\u00e8me br\u00fbl\u00e9e se\u00f1or",
    " ".join(["red cat"] * 200),
]

_SYLLABLES = ["ka", "ri", "mo", "ta", "ne", "su", "lo", "vi", "pe", "ar",
              "en", "il", "on", "us", "th", "st", "gr", "bl", "ch", "sh",
              "qu", "xa", "zo", "yu", "fe", "da", "ba", "ga", "wi", "ho"]
_WORDS = ["red", "blue", "green", "cat", "dog", "tree", "house", "sky",
          "boat", "mountain", "tiny", "large", "painting", "photo", "of",
          "a", "the", "on", "at", "dusk", "with", "in", "café",
          "naïve", "über", "façade", "日本",
          "東京", "猫", "犬", "\U0001f642", "\U0001f680",
          "Ω", "ﬁsh", "résumé", "São",
          "Zürich", "crème", "brûlée", "señor",
          "jalapeño"]


def caption_corpus(n: int = 20000, seed: int = 0) -> List[str]:
    """Deterministic captions: the synthetic shards' words, some Unicode
    words and 3000 made-up words of 1-3 syllables, 3-11 words each."""
    rng = np.random.default_rng(seed)
    made = ["".join(rng.choice(_SYLLABLES, size=int(rng.integers(1, 4))))
            for _ in range(3000)]
    words = _WORDS + made
    return [" ".join(rng.choice(words, size=int(rng.integers(3, 12))))
            for _ in range(n)]


def train_tokenizer_json() -> str:
    """A fresh fixture tokenizer's JSON text (the JAX trainer)."""
    from dalle_tpu.data.tokenizer import CaptionTokenizer
    tok = CaptionTokenizer.train(caption_corpus(), vocab_size=VOCAB_SIZE)
    return tok._tok.to_str(pretty=True)


def golden_ids(tokenizer_path: str = TOKENIZER) -> Dict:
    from dalle_tpu.data.tokenizer import CaptionTokenizer
    tok = CaptionTokenizer.load(tokenizer_path)
    out = {"captions": EDGE_CAPTIONS, "vocab_size": tok.vocab_size}
    for max_len in MAX_LENS:
        ids, mask = tok.encode_batch(EDGE_CAPTIONS, max_len)
        out[f"ids_{max_len}"] = ids.tolist()
        out[f"mask_{max_len}"] = mask.astype(int).tolist()
    out["decoded"] = [tok.decode(row) for row in out["ids_256"]]
    return out


def digest(array: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and C-order bytes."""
    a = np.ascontiguousarray(array)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def golden_data(tokenizer_path: str = TOKENIZER) -> Dict:
    from dalle_tpu.cli import prepare_data
    from dalle_tpu.config import ModelConfig
    from dalle_tpu.data.dataset import CodesDataset
    with tempfile.TemporaryDirectory() as tmp:
        prepare_data.main(["synthetic-shards", "--out", tmp, *SHARD_ARGS])
        names = sorted(os.listdir(tmp))
        shards = {n: hashlib.sha256(open(os.path.join(tmp, n), "rb")
                                    .read()).hexdigest() for n in names}
        ds = CodesDataset(tmp, ModelConfig(), tokenizer_path=tokenizer_path)
        it = ds.batches(DATA_BATCH, seed=DATA_SEED)
        batches = [{k: digest(v) for k, v in next(it).items()}
                   for _ in range(2)]
    return {"shard_args": SHARD_ARGS, "seed": DATA_SEED,
            "batch": DATA_BATCH, "shards": shards, "batches": batches}


def library_unknown() -> List[int]:
    """Code points Python normalizes (NFKC) and the library does not know:
    those whose NFKC differs alone, those whose combining class shows
    against neighbouring marks, and both halves of a composition the
    library does not make."""
    from tokenizers import normalizers
    lib = normalizers.NFKC().normalize_str

    def py(s):
        return unicodedata.normalize("NFKC", s)
    out = set()
    for c in range(0x110000):
        if 0xD800 <= c <= 0xDFFF:
            continue
        ch = chr(c)
        if lib(ch) != py(ch):
            out.add(c)
        if unicodedata.combining(ch) and any(
                lib(s) != py(s) for s in ("a" + ch + "\u0334",
                                          "a\u0345" + ch,
                                          "a" + ch + "\u0316",
                                          "a\u0316" + ch)):
            out.add(c)
        d = unicodedata.decomposition(ch)
        if d and not d.startswith("<") and len(d.split()) == 2:
            pair = "".join(chr(int(x, 16)) for x in d.split())
            if lib(pair) != py(pair):
                out.update(ord(x) for x in pair)
    return sorted(out)


def unicode_tables_source() -> str:
    import tokenizers
    rows = library_unknown()
    body = ",\n".join(
        "    " + ", ".join(f"0x{c:05X}" for c in rows[i:i + 8])
        for i in range(0, len(rows), 8))
    return (
        '"""Code points whose NFKC differs between Python\'s '
        "``unicodedata``\n"
        "and the ``tokenizers`` library's tables (generated by\n"
        "``tests/data/make_fixtures.py``; do not edit).\n\n"
        "The library treats each as an unassigned character. The set was\n"
        f"taken against ``tokenizers`` {tokenizers.__version__} and "
        f"``unicodedata``\n{unicodedata.unidata_version}.\n"
        '"""\n\n'
        f'UNIDATA_VERSION = "{unicodedata.unidata_version}"\n\n'
        "LIBRARY_UNKNOWN = frozenset([\n" + body + ",\n])\n")


def main() -> int:
    sys.path.insert(0, ROOT)
    with open(UNICODE_TABLES, "w", encoding="utf-8") as f:
        f.write(unicode_tables_source())
    with open(TOKENIZER, "w", encoding="utf-8") as f:
        f.write(train_tokenizer_json())
    with open(GOLDEN_IDS, "w", encoding="utf-8") as f:
        json.dump(golden_ids(), f, ensure_ascii=True)
        f.write("\n")
    with open(GOLDEN_DATA, "w", encoding="utf-8") as f:
        json.dump(golden_data(), f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
