"""The port's data readers against the JAX package's: ``write_shard``
bytes, ``CodesDataset`` batches for several seeds and buffer sizes (with
filtered and out-of-vocabulary records), shard resolution over
``file://``, manifests and a loopback HTTP server (the same cache file as
JAX's), ``prepare_data`` output, the committed shard and batch digests, a
tiny ``TrainingTask`` on shards (its first batch and loss equal the JAX
task's), and the ``dense_scan`` refusal.
"""

import functools
import http.server
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import (CollabConfig, OptimizerConfig,
                                    PeerConfig, TrainerConfig,
                                    tiny_model_config)
from dalle_tpu_torch.data import dataset as pdata
from dalle_tpu_torch.data import remote as premote
from dalle_tpu_torch.task import TrainingTask

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "tokenizer.json")
#: tiny widths with a text vocabulary that holds the fixture tokenizer's
MODEL = dict(vocab_text=2048, text_seq_len=12)


def _fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(ROOT, "tests", "data",
                                      "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(rng, n, seq_len, vocab):
    """Records of every kind the reader meets: good ones, and ones the
    filter drops (short caption, NSFW, aspect ratio, not a map) or the
    vocabulary check skips (negative, too large, wrong length, no codes)."""
    words = ["red", "cat", "on", "a", "blue", "boat", "café",
             "猫", "sky"]
    out = []
    for i in range(n):
        caption = " ".join(rng.choice(words, size=int(rng.integers(1, 7))))
        codes = rng.integers(0, vocab, size=seq_len).astype("<i2")
        rec = {"caption": caption, "codes": codes.tobytes(),
               "NSFW": "UNLIKELY", "width": 256, "height": 256}
        kind = i % 11
        if kind == 1:
            rec["caption"] = "ab"
        elif kind == 2:
            rec["NSFW"] = "NSFW"
        elif kind == 3:
            rec["width"], rec["height"] = 900, 300
        elif kind == 4:
            rec["codes"] = np.full(seq_len, -1, "<i2").tobytes()
        elif kind == 5:
            rec["codes"] = np.full(seq_len, vocab, "<i2").tobytes()
        elif kind == 6:
            rec["codes"] = codes[:-1].tobytes()
        elif kind == 7:
            rec["codes"] = codes.tolist()
        elif kind == 8:
            del rec["codes"]
        elif kind == 9:
            rec = {"nsfw": "UNLIKELY", "caption": caption,
                   "codes": codes.tobytes()}
        out.append(rec)
    return out


def _write_both(tmp_path, records_per_shard, seed=0):
    """The same records written by both packages into two directories;
    returns them after checking the bytes are equal."""
    from dalle_tpu.data.dataset import write_shard as jwrite
    cfg = tiny_model_config(**MODEL)
    rng = np.random.default_rng(seed)
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for s, n in enumerate(records_per_shard):
        recs = _records(rng, n, cfg.image_seq_len, cfg.vocab_image)
        name = f"shard_{s:05d}.msgpack"
        jwrite(str(dirs[0] / name), recs)
        pdata.write_shard(str(dirs[1] / name), recs)
        assert (dirs[0] / name).read_bytes() == \
            (dirs[1] / name).read_bytes()
    (dirs[1] / "notes.txt").write_text("not a shard")
    return [str(d) for d in dirs]


def test_write_shard_bytes_equal_jax(tmp_path):
    from dalle_tpu.data.dataset import write_shard as jwrite
    recs = [{"caption": "a cat", "codes": [1, -2, 300]},
            {"caption": "x", "codes": np.arange(5)},
            {"caption": "猫", "codes": (7, 8), "width": 3,
             "height": 4, "nsfw": "UNLIKELY", "extra": [1.5, None, True]},
            {"codes": b"\x01\x00", "NSFW": "UNSURE"}]
    jwrite(str(tmp_path / "j" / "s.msgpack"), recs)
    pdata.write_shard(str(tmp_path / "p" / "s.msgpack"), recs)
    assert (tmp_path / "j" / "s.msgpack").read_bytes() == \
        (tmp_path / "p" / "s.msgpack").read_bytes()


@pytest.mark.parametrize("record_filter_case", [
    {"caption": "ab"}, {"caption": None}, {"caption": "abc"},
    {"caption": "abc", "NSFW": "X"}, {"caption": "abc", "nsfw": "UNLIKELY"},
    {"caption": "abc", "width": 10, "height": 30},
    {"caption": "abc", "width": 0, "height": 30},
    {"caption": "abc", "width": 20, "height": 10},
])
def test_record_filter_equals_jax(record_filter_case):
    from dalle_tpu.data.dataset import record_filter as jfilter
    assert pdata.record_filter(record_filter_case) == \
        jfilter(record_filter_case)


@pytest.mark.parametrize("seed, buffer, loop, shards", [
    (0, 8192, True, (40, 31)),
    (1, 16, True, (40, 31)),
    (2, 7, False, (40, 31, 5)),
    (2 ** 40 + 3, 1, True, (23,)),
    (-5, 64, False, (0, 50)),
])
def test_batches_equal_jax(tmp_path, seed, buffer, loop, shards):
    """Equal batches, in order, for the same seed: the same Generator
    calls (shard permutation, buffer swaps, the final shuffle), the
    filtered and out-of-vocabulary records consuming them alike."""
    from dalle_tpu.config import tiny_model_config as jtiny
    from dalle_tpu.data.dataset import CodesDataset as JData
    jdir, pdir = _write_both(tmp_path, shards)
    jds = JData(jdir, jtiny(**MODEL), tokenizer_path=FIXTURE,
                shuffle_buffer=buffer)
    pds = pdata.CodesDataset(pdir, tiny_model_config(**MODEL),
                             tokenizer_path=FIXTURE, shuffle_buffer=buffer)
    n = 0
    for jb, pb in zip(jds.batches(5, seed=seed, loop=loop),
                      pds.batches(5, seed=seed, loop=loop)):
        assert set(jb) == set(pb) == {"text", "image", "mask"}
        for k in jb:
            assert jb[k].dtype == pb[k].dtype, k
            np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        n += 1
        if n == 40:
            break
    assert n >= 3
    if not loop:
        assert len(list(jds.batches(5, seed=seed, loop=False))) == \
            len(list(pds.batches(5, seed=seed, loop=False)))


def test_dataset_needs_a_tokenizer_and_shards(tmp_path):
    cfg = tiny_model_config(**MODEL)
    with pytest.raises(ValueError, match="tokenizer"):
        pdata.CodesDataset(str(tmp_path), cfg)
    with pytest.raises(FileNotFoundError):
        pdata.CodesDataset(str(tmp_path), cfg, tokenizer_path=FIXTURE)


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture()
def http_root(tmp_path):
    """A loopback HTTP server over ``tmp_path / 'www'``."""
    root = tmp_path / "www"
    root.mkdir()
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet, directory=str(root)))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(5)


def test_resolve_shards_equals_jax(tmp_path, http_root):
    """Directories, files, ``file://`` shard and manifest URLs, and a
    loopback HTTP manifest (JSON and text, relative and absolute names)
    resolve in both packages to the same local files: the same cache
    names, contents intact."""
    from dalle_tpu.data import remote as jremote
    www, base = http_root
    _, pdir = _write_both(tmp_path, (9, 4))
    names = sorted(n for n in os.listdir(pdir) if n.endswith(".msgpack"))
    for n in names:
        (www / n).write_bytes(open(os.path.join(pdir, n), "rb").read())
    (www / "m.json").write_text(json.dumps(names))
    (www / "m.txt").write_text(
        "# shards\n" + f"{base}/{names[0]}\n\n{names[1]}\n")
    refs = [pdir, os.path.join(pdir, names[0]),
            f"file://{os.path.join(pdir, names[1])}",
            f"{base}/{names[0]}", f"{base}/m.json", f"{base}/m.txt"]
    file_manifest = tmp_path / "local.manifest"
    file_manifest.write_text(json.dumps(
        [f"file://{os.path.join(pdir, n)}" for n in names]))
    refs.append(f"file://{file_manifest}")
    for ref in refs:
        jc, pc = str(tmp_path / "jc"), str(tmp_path / "pc")
        jpaths = [f() for f in jremote.resolve_shards(ref, cache_dir=jc)]
        ppaths = [f() for f in premote.resolve_shards(ref, cache_dir=pc)]
        assert [os.path.basename(p) for p in jpaths] == \
            [os.path.basename(p) for p in ppaths], ref
        for a, b in zip(jpaths, ppaths):
            if premote.is_url(ref):
                assert os.path.dirname(b) == pc
            assert open(a, "rb").read() == open(b, "rb").read()
    # the manifest's entries, relative and absolute, as the cache names
    pc = str(tmp_path / "names")
    got = [os.path.basename(f()) for f in premote.resolve_shards(
        f"{base}/m.txt", cache_dir=pc)]
    assert got == [premote.cache_name(f"{base}/{n}") for n in names[:2]]
    # one cache directory shared by both packages: the port reuses the
    # file the JAX package fetched (no second download)
    shared = str(tmp_path / "shared")
    j = [f() for f in jremote.resolve_shards(f"{base}/m.json",
                                             cache_dir=shared)]
    (www / names[0]).write_bytes(b"changed on the server")
    p = [f() for f in premote.resolve_shards(f"{base}/m.json",
                                             cache_dir=shared)]
    assert j == p
    assert open(p[0], "rb").read() != b"changed on the server"
    with pytest.raises(ValueError, match="scheme"):
        premote.cached_fetch("ftp://x/a.msgpack", cache_dir=shared)


def test_cache_name_equals_jax():
    """The cache key (sha256 of the URL, 24 hex digits, and the path's
    base name) and the default cache directory are the JAX package's."""
    import hashlib
    import urllib.parse

    from dalle_tpu.data import remote as jremote
    for url in ("http://h:1/a/b.msgpack", "file:///x/y.shard",
                "https://h/m?x=1"):
        want = (hashlib.sha256(url.encode()).hexdigest()[:24] + "_"
                + os.path.basename(urllib.parse.urlparse(url).path))
        assert premote.cache_name(url) == want
    assert jremote.DEFAULT_CACHE == premote.DEFAULT_CACHE


@pytest.mark.parametrize("argv", [
    ["--shards", "2", "--records", "9", "--preset", "tiny", "--seed", "4"],
    ["--shards", "1", "--records", "6", "--preset", "tiny", "--structured"],
    ["--shards", "2", "--records", "3", "--preset", "flagship"],
])
def test_prepare_data_synthetic_shards_equal_jax(tmp_path, argv):
    from dalle_tpu.cli import prepare_data as jprep
    from dalle_tpu_torch.cli import prepare_data as pprep
    assert jprep.main(["synthetic-shards", "--out", str(tmp_path / "j"),
                       *argv]) == 0
    assert pprep.main(["synthetic-shards", "--out", str(tmp_path / "p"),
                       *argv]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and names
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "p" / n).read_bytes()


def test_prepare_data_train_tokenizer(tmp_path, monkeypatch):
    """``train-tokenizer`` writes a tokenizer both packages read alike;
    without the ``tokenizers`` package it raises a clear error."""
    import sys

    from dalle_tpu.data.tokenizer import CaptionTokenizer as J
    from dalle_tpu_torch.cli import prepare_data as pprep
    from dalle_tpu_torch.data.tokenizer import CaptionTokenizer as P
    corpus = tmp_path / "captions.txt"
    corpus.write_text("\n".join(["a red cat", "", "a blue boat on sky",
                                 "café 猫"] * 50))
    out = tmp_path / "tok" / "tokenizer.json"
    assert pprep.main(["train-tokenizer", "--input", str(corpus),
                       "--vocab-size", "60", "--out", str(out)]) == 0
    for text in ("a red cat", "blue  sky", "猫!"):
        assert P.load(str(out)).ids(text) == \
            list(J.load(str(out))._tok.encode(text).ids)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="tokenizers"):
        pprep.main(["train-tokenizer", "--input", str(corpus),
                    "--out", str(tmp_path / "t2.json")])


def test_golden_shards_and_batches():
    """The committed digests regenerate from the JAX package, and the
    port's own writer and reader give them too (the card's phase 12a
    checks the same digests)."""
    import hashlib
    import tempfile

    from dalle_tpu_torch.cli import prepare_data as pprep
    from dalle_tpu_torch.config import ModelConfig
    fx = _fixtures()
    with open(fx.GOLDEN_DATA) as f:
        golden = json.load(f)
    assert fx.golden_data() == golden
    with tempfile.TemporaryDirectory() as tmp:
        pprep.main(["synthetic-shards", "--out", tmp, *golden["shard_args"]])
        assert {n: hashlib.sha256(open(os.path.join(tmp, n), "rb").read())
                .hexdigest() for n in sorted(os.listdir(tmp))} == \
            golden["shards"]
        it = pdata.CodesDataset(tmp, ModelConfig(), tokenizer_path=FIXTURE
                                ).batches(golden["batch"],
                                          seed=golden["seed"])
        got = [{k: fx.digest(v) for k, v in next(it).items()}
               for _ in range(2)]
    assert got == golden["batches"]


# -- the task ------------------------------------------------------------

TASK_MODEL = dict(MODEL, dim=64, heads=4, head_dim=16, depth=2)
COLLAB = dict(target_batch_size=16, matchmaking_time=0.3,
              allreduce_timeout=5.0, average_state_every=0,
              delay_optimizer_step=False, audit_gather=False,
              gossip_strikes=False)


def _tasks(tmp_path, data_dir):
    from dalle_tpu.config import CollabConfig as JCC
    from dalle_tpu.config import OptimizerConfig as JOC
    from dalle_tpu.config import PeerConfig as JPC
    from dalle_tpu.config import TrainerConfig as JTC
    from dalle_tpu.config import tiny_model_config as jtiny
    from dalle_tpu.task import TrainingTask as JTask
    ident = str(tmp_path / "id.pem")
    jtask = JTask(jtiny(**TASK_MODEL), JOC(), JTC(per_device_batch=1),
                  JCC(run_id="d", **COLLAB),
                  JPC(identity_path=ident, experiment_prefix="d"),
                  data_path=data_dir, tokenizer_path=FIXTURE)
    ptask = TrainingTask(tiny_model_config(**TASK_MODEL), OptimizerConfig(),
                         TrainerConfig(per_device_batch=8),
                         CollabConfig(run_id="d", **COLLAB),
                         PeerConfig(identity_path=ident,
                                    experiment_prefix="d"),
                         data_path=data_dir, tokenizer_path=FIXTURE,
                         device="cpu")
    return jtask, ptask


def test_task_on_shards_first_batch_and_loss_equal_jax(tmp_path):
    import jax

    from dalle_tpu_torch.params import params_from_jax
    from dalle_tpu_torch.cli import prepare_data as pprep
    data = tmp_path / "shards"
    pprep.main(["synthetic-shards", "--out", str(data), "--shards", "2",
                "--records", "24", "--preset", "tiny", "--seed", "5"])
    jtask, ptask = _tasks(tmp_path, str(data))
    try:
        assert ptask.data_seed == jtask.data_seed
        assert ptask.local_batch_size == jtask.local_batch_size == 8
        assert type(ptask.dataset).__name__ == "CodesDataset"
        jb = next(jtask.batches())
        pb = next(ptask.batches())
        assert set(jb) == set(pb) == {"text", "image", "mask"}
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]),
                                          pb[k].numpy(), err_msg=k)
        assert pb["text"].dtype == pb["image"].dtype == torch.int64
        assert pb["mask"].dtype == torch.float32
        params = jtask.train_state.params
        _, jmetrics = jtask.grad_step(params, jb)
        src = params_from_jax(jax.tree.map(np.asarray, params),
                              ptask.model_cfg)
        _, pmetrics = ptask.grad_step(src, pb)
        np.testing.assert_allclose(float(pmetrics["loss"]),
                                   float(jmetrics["loss"]),
                                   rtol=2e-5, atol=2e-5)
    finally:
        ptask.shutdown()
        jtask.shutdown()


def test_task_refuses_a_tokenizer_larger_than_the_vocabulary(tmp_path):
    from dalle_tpu_torch.cli import prepare_data as pprep
    data = tmp_path / "shards"
    pprep.main(["synthetic-shards", "--out", str(data), "--shards", "1",
                "--records", "4", "--preset", "tiny"])
    task = TrainingTask(tiny_model_config(), OptimizerConfig(),
                        TrainerConfig(), CollabConfig(), PeerConfig(),
                        data_path=str(data), tokenizer_path=FIXTURE,
                        device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        task.dataset


@pytest.mark.parametrize("model, refused", [
    (dict(dense_scan=True), True),
    (dict(dense_scan=True, depth=8, attn_types=("full", "axial_row")),
     True),
    (dict(dense_scan=True, depth=1), False),
    (dict(dense_scan=True, shared_block_cycle=2, depth=4), False),
    (dict(dense_scan=False), False),
])
def test_dense_scan_with_stacked_blocks_is_refused(model, refused):
    """A stacked ``dense_scan`` layout (``dense_scan_reps() > 0``) raises,
    naming the ROADMAP item; shared blocks or one repetition build."""
    cfg = tiny_model_config(**model)
    args = (cfg, OptimizerConfig(), TrainerConfig(), CollabConfig(),
            PeerConfig())
    assert (cfg.dense_scan_reps() > 0) == refused
    if refused:
        with pytest.raises(NotImplementedError, match="dense_scan"):
            TrainingTask(*args, device="cpu")
    else:
        TrainingTask(*args, device="cpu").shutdown()
