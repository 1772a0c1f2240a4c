"""The port's caption tokenizer against the JAX package's (the
``tokenizers`` library): ids and masks exactly equal on the committed
fixture and on a freshly trained tokenizer, for edge-case and
hypothesis-drawn Unicode and whitespace captions; the normalizer's two
tables on every code point; the committed fixtures regenerate; components
the port does not implement raise; only ``train`` imports ``tokenizers``.
"""

import importlib.util
import json
import os
import subprocess
import sys
import unicodedata

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from dalle_tpu_torch.data import tokenizer as ptok
from dalle_tpu_torch.data._unicode_tables import LIBRARY_UNKNOWN

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "tokenizer.json")


def _fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(ROOT, "tests", "data",
                                      "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _fixtures()


@pytest.fixture(scope="module")
def pair():
    """(port, JAX) tokenizers on the committed fixture."""
    from dalle_tpu.data.tokenizer import CaptionTokenizer as J
    return ptok.CaptionTokenizer.load(FIXTURE), J.load(FIXTURE)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """(port, JAX) on a tokenizer the port's ``train`` just wrote: a
    corpus unlike the fixture's (few words, many unknown characters
    later), a vocabulary of 300."""
    from dalle_tpu.data.tokenizer import CaptionTokenizer as J
    path = str(tmp_path_factory.mktemp("tok") / "sub" / "tokenizer.json")
    rng = np.random.default_rng(3)
    words = ["tree", "house", "a", "of", "sky", "bl\u00e5", "\u00fcber",
             "\u732b", "\u2460", "night", "ocean"]
    corpus = [" ".join(rng.choice(words, size=int(rng.integers(2, 9))))
              for _ in range(3000)]
    port = ptok.CaptionTokenizer.train(corpus, vocab_size=300,
                                       save_path=path)
    return port, J.load(path), ptok.CaptionTokenizer.load(path)


def _captions():
    return FX.EDGE_CAPTIONS


@pytest.mark.parametrize("max_len", [256, 8, 1])
def test_edge_captions_equal_jax(pair, fresh, max_len):
    for port, jax_tok in (pair, fresh[:2]):
        for text in _captions():
            got = port.encode(text, max_len)
            want = jax_tok.encode(text, max_len)
            assert got[0].dtype == want[0].dtype == np.int32
            assert got[1].dtype == want[1].dtype == np.float32
            np.testing.assert_array_equal(got[0], want[0], err_msg=text)
            np.testing.assert_array_equal(got[1], want[1], err_msg=text)
        got = port.encode_batch(_captions(), max_len)
        want = jax_tok.encode_batch(_captions(), max_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_golden_ids_and_decode(pair):
    """The committed golden ids (the card's reference) equal the port's;
    decode equals the JAX decode."""
    port, _ = pair
    with open(os.path.join(ROOT, "tests", "data", "golden_ids.json")) as f:
        golden = json.load(f)
    assert golden["captions"] == _captions()
    assert golden["vocab_size"] == port.vocab_size
    for max_len in FX.MAX_LENS:
        ids, mask = port.encode_batch(golden["captions"], max_len)
        assert ids.tolist() == golden[f"ids_{max_len}"]
        assert mask.astype(int).tolist() == golden[f"mask_{max_len}"]
    assert [port.decode(r) for r in golden["ids_256"]] == golden["decoded"]


def test_decode_equals_jax(pair, fresh):
    rng = np.random.default_rng(0)
    for port, jax_tok in (pair, fresh[:2]):
        n = port.vocab_size
        for _ in range(200):
            ids = rng.integers(0, n, size=int(rng.integers(0, 12))).tolist()
            assert port.decode(ids) == jax_tok.decode(ids), ids


_ALPHABET = st.one_of(
    st.sampled_from(list(" \t\n\r\x0b\x0c\x00\x01\x7f\u00a0\u1680\u2009"
                         "\u200b\u200d\u2028\u3000\ufeff\ufffd\u2581"
                         "\u0301\u0316\u0345\u07fd\u032f\u3099")
                    + ["<pad>", "</s>", "<unk>", " {2,}", "\uff1c"]),
    st.sampled_from(sorted(chr(c) for c in LIBRARY_UNKNOWN)),
    st.sampled_from(["red", "cat", "tree", "house", "blue", "caf\u00e9",
                     "\u732b", "\u2460", "\ufb01"]),
    st.characters(blacklist_categories=("Cs",)),
)
_CAPTION = st.lists(_ALPHABET, max_size=24).map("".join)


@settings(max_examples=400, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_CAPTION)
@example("  a  b  ")
@example("\u2581\u2581a")
@example("a<pad>\x01")
@example("e\u0301\u0316 \u1100\u1161\u11a8")
def test_hypothesis_captions_equal_the_library(pair, fresh, text):
    port, jax_tok = pair
    assert port.ids(text) == list(jax_tok._tok.encode(text).ids)
    fport, fjax, floaded = fresh
    want = list(fjax._tok.encode(text).ids)
    assert fport.ids(text) == want
    assert floaded.ids(text) == want


def test_nmt_and_nfkc_tables_on_every_code_point():
    """Nmt char by char, NFKC alone and next to marks of low and high
    combining class, over every code point but the surrogates."""
    from tokenizers import normalizers
    nmt, nfkc = normalizers.Nmt(), normalizers.NFKC()
    for c in range(0x110000):
        if 0xD800 <= c <= 0xDFFF:
            continue
        ch = chr(c)
        assert ch.translate(ptok._NMT_TABLE) == nmt.normalize_str(ch), hex(c)
        assert ptok._nfkc(ch) == nfkc.normalize_str(ch), hex(c)
        if unicodedata.combining(ch) or c in LIBRARY_UNKNOWN:
            for s in ("a" + ch + "\u0334", "a\u0345" + ch,
                      "e\u0301" + ch + "\u0316", ch + "\u0300x"):
                assert ptok._nfkc(s) == nfkc.normalize_str(s), hex(c)


def test_unicode_table_regenerates():
    with open(FX.UNICODE_TABLES, encoding="utf-8") as f:
        assert f.read() == FX.unicode_tables_source()


def test_fixture_tokenizer_regenerates():
    """A retrain gives the committed vocabulary and components; the
    library's trainer sums scores in a hash order, so they agree to a
    relative 1e-9, not bitwise."""
    fresh = json.loads(FX.train_tokenizer_json())
    with open(FIXTURE, encoding="utf-8") as f:
        committed = json.load(f)
    for key in committed:
        if key != "model":
            assert fresh[key] == committed[key], key
    f_model = dict(fresh["model"])
    c_model = dict(committed["model"])
    f_vocab, c_vocab = dict(f_model.pop("vocab")), dict(c_model.pop("vocab"))
    assert f_model == c_model
    assert set(f_vocab) == set(c_vocab)
    for tok, score in c_vocab.items():
        assert f_vocab[tok] == pytest.approx(score, rel=1e-9, abs=1e-12), tok


def test_golden_ids_regenerate():
    with open(FX.GOLDEN_IDS, encoding="utf-8") as f:
        assert json.load(f) == json.loads(json.dumps(FX.golden_ids()))


def _edit(obj, path, value):
    obj = json.loads(json.dumps(obj))
    node = obj
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return obj


@pytest.mark.parametrize("path, value, name", [
    (("normalizer",), {"type": "Precompiled", "precompiled_charsmap": ""},
     "Precompiled"),
    (("normalizer", "normalizers", 2, "pattern"), {"Regex": " {2,}"},
     "Regex"),
    (("normalizer", "normalizers", 0), {"type": "NFC"}, "NFC"),
    (("post_processor",), {"type": "TemplateProcessing", "single": [],
                           "pair": [], "special_tokens": {}},
     "TemplateProcessing"),
    (("pre_tokenizer",), {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"}]}, "WhitespaceSplit"),
    (("pre_tokenizer", "prepend_scheme"), "first", "first"),
    (("decoder", "split"), False, "decoder"),
    (("model", "type"), "BPE", "BPE"),
    (("model", "byte_fallback"), True, "byte_fallback"),
    (("added_tokens", 0, "lstrip"), True, "lstrip"),
    (("truncation",), {"max_length": 8}, "truncation"),
    (("padding",), {"strategy": "BatchLongest"}, "padding"),
])
def test_unsupported_components_raise(path, value, name):
    with open(FIXTURE, encoding="utf-8") as f:
        obj = json.load(f)
    with pytest.raises(NotImplementedError, match=name):
        ptok.CaptionTokenizer(json.dumps(_edit(obj, path, value)))


def test_save_load_round_trip(pair, tmp_path):
    """The port's save writes the loaded file's bytes: both packages read
    it back to the same ids."""
    from dalle_tpu.data.tokenizer import CaptionTokenizer as J
    port, _ = pair
    out = str(tmp_path / "a" / "tokenizer.json")
    port.save(out)
    with open(out, "rb") as a, open(FIXTURE, "rb") as b:
        assert a.read() == b.read()
    again, jax_tok = ptok.CaptionTokenizer.load(out), J.load(out)
    for text in _captions()[:12]:
        assert again.ids(text) == list(jax_tok._tok.encode(text).ids)


def test_only_train_imports_tokenizers(tmp_path):
    """Loading, encoding, reading shards and the serving and trainer CLIs'
    imports never import ``tokenizers``; ``train`` without it raises."""
    code = (
        "import sys\n"
        "from dalle_tpu_torch.data.tokenizer import CaptionTokenizer\n"
        "from dalle_tpu_torch.data import dataset, remote\n"
        "from dalle_tpu_torch.cli import (run_trainer, run_server,\n"
        "    run_inference, run_router, prepare_data, issue_token)\n"
        "import dalle_tpu_torch.serving.router, dalle_tpu_torch.task\n"
        f"t = CaptionTokenizer.load({FIXTURE!r})\n"
        "print(t.encode('a red cat', 8)[0].tolist())\n"
        "assert 'tokenizers' not in sys.modules, 'tokenizers imported'\n"
        "sys.modules['tokenizers'] = None\n"
        "try:\n"
        "    CaptionTokenizer.train(['a b c'], vocab_size=10)\n"
        "except ImportError as e:\n"
        "    assert 'tokenizers' in str(e)\n"
        "else:\n"
        "    raise SystemExit('train did not raise')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
