"""Caption tokenizer (the port's ``dalle_tpu/data/tokenizer.py``).

The JAX package encodes captions with the Rust ``tokenizers`` library; the
card's machine does not have that package. Like ``utils/msgpack.py``, this
module carries its own encoder, and it is the only encoding path on every
machine, so a caption gives the same ids everywhere. The contract is the
library's behaviour (``tokenizers`` 0.22.2) on the files that
:meth:`CaptionTokenizer.train` writes:

- added tokens ``<pad>`` = 0, ``</s>`` = 1, ``<unk>`` = 2 (special, not
  normalized), cut out of the raw text first, longest match leftmost;
- the normalizer ``Sequence[Nmt, NFKC, Replace]``: Nmt drops ASCII control
  characters and maps the other whitespace code points to a space; NFKC
  follows the library's Unicode tables (``data/_unicode_tables.py``); the
  Replace pattern is a literal string (``{"String": " {2,}"}``), not a
  regex, so runs of spaces are kept;
- the pre-tokenizer Metaspace (``"▁"``, ``prepend_scheme`` "always",
  ``split``): spaces become ``▁``, a piece not starting with one gets it
  prepended, and the text splits before every ``▁``;
- the Unigram model (Viterbi over the vocabulary's log-probabilities; an
  unknown character scores the vocabulary's least score minus 10, and
  consecutive unknowns fuse into one ``<unk>`` token); no byte fallback;
- no post-processor, truncation or padding, and the Metaspace decoder.

:meth:`CaptionTokenizer.load` refuses, with ``NotImplementedError`` naming
it, any other component (a real T5 file's ``Precompiled`` normalizer or
``TemplateProcessing`` post-processor, for example). ``tokenizers`` is
imported only by :meth:`CaptionTokenizer.train`, which needs the library's
trainer.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from dalle_tpu_torch.data._unicode_tables import (LIBRARY_UNKNOWN,
                                                   UNIDATA_VERSION)

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2

_METASPACE = "▁"
_UNK_PENALTY = 10.0      # the library's K_UNK_PENALTY

#: the code points Nmt drops, and those it maps to a space
_NMT_DROP = frozenset([*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F,
                       0x8F, 0x9F])
_NMT_SPACE = frozenset([0x09, 0x0A, 0x0C, 0x0D, 0x1680,
                        *range(0x200B, 0x2010), 0x2028, 0x2029, 0x2581,
                        0xFEFF, 0xFFFD])
_NMT_TABLE = {**{c: None for c in _NMT_DROP},
              **{c: " " for c in _NMT_SPACE}}

#: splits out the code points that Python's ``unicodedata`` normalizes but
#: the library's older Unicode tables do not know: the library treats each
#: as an unassigned character (no decomposition, combining class 0,
#: composes with nothing), so the text is normalized in the runs between
#: them
_UNKNOWN_RE = re.compile(
    "([" + "".join(re.escape(chr(c)) for c in sorted(LIBRARY_UNKNOWN))
    + "])")


def _nfkc(text: str) -> str:
    """NFKC as the library computes it (its Unicode tables)."""
    parts = _UNKNOWN_RE.split(text)
    # odd indices are the unknown characters, kept as they are
    return "".join(p if i % 2 else unicodedata.normalize("NFKC", p)
                   for i, p in enumerate(parts))


def _check(cond: bool, component: str) -> None:
    if not cond:
        raise NotImplementedError(
            f"tokenizer.json component {component} is not supported: the "
            "port implements what CaptionTokenizer.train writes (Nmt, "
            "NFKC, literal Replace, Metaspace, Unigram)")


class _Spec:
    """The parsed ``tokenizer.json``: the normalizer steps, the added
    tokens, the Unigram vocabulary and its Viterbi constants."""

    def __init__(self, obj: dict):
        for key in ("truncation", "padding", "post_processor"):
            _check(obj.get(key) is None,
                   f"{key}={json.dumps(obj.get(key))[:80]}")
        self.normalizers = self._normalizers(obj.get("normalizer"))
        meta = {"type": "Metaspace", "replacement": _METASPACE,
                "prepend_scheme": "always", "split": True}
        for key in ("pre_tokenizer", "decoder"):
            got = obj.get(key)
            _check(isinstance(got, dict)
                   and {k: got.get(k) for k in meta} == meta
                   and set(got) <= set(meta),
                   f"{key}={json.dumps(got)[:120]}")
        model = obj.get("model") or {}
        _check(model.get("type") == "Unigram",
               f"model type {model.get('type')!r}")
        _check(not model.get("byte_fallback", False),
               "Unigram byte_fallback=true")
        _check(model.get("unk_id") is not None, "Unigram without unk_id")
        vocab = [(str(t), float(s)) for t, s in model["vocab"]]
        self.unk_id = int(model["unk_id"])
        self.token_to_id: Dict[str, int] = {}
        for i, (tok, _score) in enumerate(vocab):
            self.token_to_id[tok] = i
        self.scores = [s for _t, s in vocab]
        self.unk_score = min(self.scores) - _UNK_PENALTY
        self.max_len = max(len(t) for t, _s in vocab)
        added = obj.get("added_tokens") or []
        self.added: Dict[str, int] = {}
        self.special_ids = set()
        for a in added:
            _check(not any(a.get(k) for k in ("single_word", "lstrip",
                                               "rstrip", "normalized")),
                   f"added token {json.dumps(a)}")
            self.added[a["content"]] = int(a["id"])
            if a.get("special"):
                self.special_ids.add(int(a["id"]))
        # leftmost match, the longest of those starting there
        self.added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self.id_to_token = {i: t for i, (t, _s) in enumerate(vocab)}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self.vocab_size = len(set(self.token_to_id) | set(self.added))

    @staticmethod
    def _normalizers(norm) -> List[Tuple[str, object]]:
        if norm is None:
            return []
        steps = norm["normalizers"] if norm.get("type") == "Sequence" \
            else [norm]
        out = []
        for step in steps:
            kind = step.get("type")
            if kind == "Nmt":
                out.append(("nmt", None))
            elif kind == "NFKC":
                if UNIDATA_VERSION != unicodedata.unidata_version:
                    raise NotImplementedError(
                        "NFKC: the library's Unicode tables were matched "
                        f"against unicodedata {UNIDATA_VERSION}; this "
                        f"Python has {unicodedata.unidata_version}")
                out.append(("nfkc", None))
            elif kind == "Replace":
                pattern = step.get("pattern") or {}
                _check(set(pattern) == {"String"},
                       f"Replace pattern {json.dumps(pattern)}")
                out.append(("replace", (pattern["String"],
                                        step["content"])))
            else:
                _check(False, f"normalizer {kind}")
        return out

    # -- encoding ---------------------------------------------------------

    def normalize(self, text: str) -> str:
        for kind, arg in self.normalizers:
            if kind == "nmt":
                text = text.translate(_NMT_TABLE)
            elif kind == "nfkc":
                text = _nfkc(text)
            else:
                pattern, content = arg
                text = text.replace(pattern, content)
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        if not text:
            return []
        text = text.replace(" ", _METASPACE)
        if not text.startswith(_METASPACE):
            text = _METASPACE + text
        # split before every ▁ (the delimiter merged with the next piece)
        return [p for p in re.split(f"(?={_METASPACE})", text) if p]

    def viterbi(self, piece: str) -> List[int]:
        """The Unigram best path over ``piece``: ties go to the path found
        first (the earlier start), as the library's strict comparison
        does; consecutive unknown characters fuse into one token."""
        n = len(piece)
        best = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        ids = [0] * (n + 1)
        t2i, scores = self.token_to_id, self.scores
        for s in range(n):
            here = best[s]
            single = False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                tid = t2i.get(piece[s:e])
                if tid is None:
                    continue
                cand = scores[tid] + here
                if start[e] is None or cand > best[e]:
                    best[e], start[e], ids[e] = cand, s, tid
                if e == s + 1:
                    single = True
            if not single:
                cand = self.unk_score + here
                if start[s + 1] is None or cand > best[s + 1]:
                    best[s + 1], start[s + 1], ids[s + 1] = \
                        cand, s, self.unk_id
        tokens: List[str] = []
        unk_run: List[str] = []
        e = n
        while e > 0:
            s = start[e]
            if ids[e] == self.unk_id:
                unk_run.append(piece[s:e])
            else:
                if unk_run:
                    tokens.append("".join(reversed(unk_run)))
                    unk_run = []
                tokens.append(piece[s:e])
            e = s
        if unk_run:
            tokens.append("".join(reversed(unk_run)))
        return [t2i.get(t, self.unk_id) for t in reversed(tokens)]

    def encode(self, text: str) -> List[int]:
        segments: List[Tuple[str, Optional[int]]] = []
        pos = 0
        if self.added_re is not None:
            for m in self.added_re.finditer(text):
                if m.start() > pos:
                    segments.append((text[pos:m.start()], None))
                segments.append((m.group(), self.added[m.group()]))
                pos = m.end()
        if pos < len(text):
            segments.append((text[pos:], None))
        out: List[int] = []
        for seg, tid in segments:
            if tid is not None:
                out.append(tid)
                continue
            for piece in self.pre_tokenize(self.normalize(seg)):
                out.extend(self.viterbi(piece))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [self.id_to_token[i] for i in ids
                  if i in self.id_to_token and i not in self.special_ids]
        # the Metaspace decoder: ▁ is a space, and dropped from the first
        # token
        return "".join(
            t.replace(_METASPACE, "") if i == 0
            else t.replace(_METASPACE, " ") for i, t in enumerate(tokens))


class CaptionTokenizer:
    """Encode/decode captions; pad-to-max with a loss mask."""

    def __init__(self, spec_json: str):
        self._json = spec_json
        self._spec = _Spec(json.loads(spec_json))
        self.vocab_size = self._spec.vocab_size
        self.pad_id = PAD_ID
        self.eos_id = EOS_ID

    # -- construction -----------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "CaptionTokenizer":
        """Load a saved ``tokenizer.json`` (raises ``NotImplementedError``
        for a component the port does not implement)."""
        with open(path, encoding="utf-8") as f:
            return cls(f.read())

    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 32100,
              save_path: Optional[str] = None) -> "CaptionTokenizer":
        """Train a T5-style Unigram tokenizer from an iterator of captions
        with the ``tokenizers`` library (the JAX package's trainer, the
        same settings); the result encodes through the port's encoder."""
        try:
            from tokenizers import (Tokenizer, decoders, models,
                                    normalizers, pre_tokenizers, trainers)
        except ImportError as e:
            raise ImportError(
                "training a tokenizer needs the `tokenizers` package; "
                "loading and encoding with a trained tokenizer.json "
                "do not") from e
        tok = Tokenizer(models.Unigram())
        tok.normalizer = normalizers.Sequence(
            [normalizers.Nmt(), normalizers.NFKC(),
             normalizers.Replace(r" {2,}", " ")])
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        trainer = trainers.UnigramTrainer(
            vocab_size=vocab_size,
            special_tokens=["<pad>", "</s>", "<unk>"],
            unk_token="<unk>")
        tok.train_from_iterator(corpus, trainer=trainer)
        out = cls(tok.to_str(pretty=True))
        if save_path is not None:
            out.save(save_path)
        return out

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(self._json)

    # -- encoding ---------------------------------------------------------

    def ids(self, text: str) -> List[int]:
        """The library's ``encode(text).ids``: no eos, no padding."""
        return self._spec.encode(text)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) padded/truncated to ``max_len``; eos-terminated.

        The mask marks real tokens (incl. eos) with 1 and padding with 0 —
        the collator's loss mask.
        """
        ids = self.ids(text)
        # append </s> unless the encoding already ends with it
        if not ids or ids[-1] != self.eos_id:
            ids.append(self.eos_id)
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.eos_id]
        n = len(ids)
        out = np.full((max_len,), self.pad_id, np.int32)
        out[:n] = np.asarray(ids, np.int32)
        mask = np.zeros((max_len,), np.float32)
        mask[:n] = 1.0
        return out, mask

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t, max_len) for t in texts]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) not in (self.pad_id,
                                                     self.eos_id)]
        return self._spec.decode(ids)
