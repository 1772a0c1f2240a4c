"""The port's continuous-batching engine, scheduler, metrics, chaos seam
and HTTP front-end (``dalle_tpu_torch/serving/``) against the JAX
package's ``dalle_tpu/serving/`` and against the port's own
``generate_images``, on the CPU (the chunk runs eagerly there).

The load-bearing invariant, as in ``tests/test_serving.py``: a request
decoded by the engine emits EXACTLY the codes ``generate_images`` samples
for the same seed and SamplingConfig, alone in one slot and under
continuous batching (ragged admission, recycled slots, co-tenants with
other knobs). The sampling noise is a function of (seed, position,
vocabulary index) in the port, so it cannot equal the JAX package's
threefry draws: against the JAX engine the codes are compared under
greedy decoding, on weights converted with ``params_from_jax``.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.models import decode as jdecode
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.models.dalle import init_params as jax_init
from dalle_tpu.serving import chaos as jchaos
from dalle_tpu.serving import metrics as jmetrics
from dalle_tpu.serving import scheduler as jsched
from dalle_tpu.serving.engine import DecodeEngine as JaxEngine
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.models.decode import SamplingConfig, generate_images
from dalle_tpu_torch.obs.exposition import parse_text
from dalle_tpu_torch.params import params_from_jax
from dalle_tpu_torch.serving import chaos as tchaos
from dalle_tpu_torch.serving import metrics as tmetrics
from dalle_tpu_torch.serving import scheduler as tsched
from dalle_tpu_torch.serving.engine import DecodeEngine
from dalle_tpu_torch.serving.server import ServingHTTPServer

torch.set_num_threads(2)
SAM = SamplingConfig(temperature=1.0, top_k=8)
GREEDY = SamplingConfig(temperature=0.0)
FLAT = dict(attn_types=("axial_row", "axial_col"), depth=2)


@pytest.fixture(scope="module")
def flat_setup():
    jcfg, tcfg = (jconfig.tiny_model_config(**FLAT),
                  tconfig.tiny_model_config(**FLAT))
    params = jax.tree.map(np.asarray,
                          jax_init(JaxDALLE(jcfg), jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, params_from_jax(params, tcfg)


def _texts(cfg, n, seed=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_text, cfg.text_seq_len)
            for _ in range(n)]


def _solo(model, text, seed, sampling=SAM, buckets=4):
    return generate_images(model, torch.from_numpy(text[None]), [seed],
                           sampling, buckets=buckets)[0].numpy()


def _run(engine, texts, seeds, stagger=0.0, **kw):
    try:
        handles = []
        for i, (t, s) in enumerate(zip(texts, seeds)):
            handles.append(engine.submit(t, s, **kw))
            time.sleep(stagger * i)     # admission lands mid-chunk
        return [h.result(timeout=120) for h in handles]
    finally:
        engine.stop()


# -- against the port's generate_images ---------------------------------

@pytest.mark.parametrize("n_slots,stagger", [(1, 0.0), (2, 0.01)])
def test_engine_codes_equal_generate_images(flat_setup, n_slots, stagger):
    """One slot, and five requests ragged through two slots (every slot
    recycled): each request emits its one-row ``generate_images`` codes
    for the same seed, code for code."""
    _, cfg, _, model = flat_setup
    texts = _texts(cfg, 5 if n_slots > 1 else 2)
    seeds = [1000 + i for i in range(len(texts))]
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
        n_slots=n_slots, steps_per_call=4), sampling=SAM).start()
    rows = _run(engine, texts, seeds, stagger)
    for row, t, s in zip(rows, texts, seeds):
        np.testing.assert_array_equal(row["codes"], _solo(model, t, s))
        assert row["latency_s"] >= row["ttft_s"] >= 0
    stats = engine.stats()
    assert stats["completed"] == stats["admitted"] == len(texts)
    assert 0 < stats["mean_occupancy"] <= 1.0


def test_per_request_sampling_cotenancy_exact(flat_setup):
    """Three co-tenants with three SamplingConfigs (the default, greedy,
    top-p) in one chunk: each equals its own ``generate_images``."""
    _, cfg, _, model = flat_setup
    texts = _texts(cfg, 3)
    sams = [SAM, GREEDY, SamplingConfig(1.0, 0, 0.7)]
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
        n_slots=2, steps_per_call=4), sampling=SAM).start()
    try:
        handles = [engine.submit(t, 500 + i, sampling=s)
                   for i, (t, s) in enumerate(zip(texts, sams))]
        rows = [h.result(timeout=120) for h in handles]
    finally:
        engine.stop()
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(
            row["codes"], _solo(model, texts[i], 500 + i, sams[i]))


# -- against the JAX engine (greedy) -------------------------------------

def test_greedy_codes_equal_the_jax_engine(flat_setup):
    """Greedy codes of four requests through the JAX package's
    ``DecodeEngine`` (two slots, staggered admission, recycled slots)
    equal the port engine's with one slot and with two."""
    jcfg, cfg, params, model = flat_setup
    texts = _texts(cfg, 4, seed=7)
    serving = dict(steps_per_call=4)
    jeng = JaxEngine(params, jcfg, jconfig.ServingConfig(
        n_slots=2, **serving),
        sampling=jdecode.SamplingConfig(temperature=0.0)).start()
    want = [r["codes"] for r in _run(jeng, texts, range(4), 0.01)]
    for n_slots in (1, 2):
        engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
            n_slots=n_slots, **serving), sampling=GREEDY).start()
        got = _run(engine, texts, range(4), 0.01)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["codes"], w)


# -- scheduler, metrics and chaos decisions equal the JAX package's -------

SCHED_CASES = {
    "plain": dict(n_slots=4, bytes_per_slot=100),
    "budget": dict(n_slots=8, bytes_per_slot=2 ** 20, kv_budget_mb=3),
    "burst": dict(n_slots=8, bytes_per_slot=100, admit_burst=2),
    "bypass": dict(n_slots=4, bytes_per_slot=100, low_lane_bypass=2),
    "reserved": dict(n_slots=8, bytes_per_slot=2 ** 20, kv_budget_mb=5,
                     reserved_bytes=2 * 2 ** 20),
}


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_decisions_equal_jax(case):
    kw = SCHED_CASES[case]
    js, ts = jsched.SlotScheduler(**kw), tsched.SlotScheduler(**kw)
    assert ts.max_live == js.max_live
    rng = np.random.default_rng(len(case))
    for _ in range(200):
        queued = [int(q) for q in rng.integers(0, 6, 2)]
        live = int(rng.integers(0, kw["n_slots"] + 1))
        free = kw["n_slots"] - live
        assert ts.grant_lanes(queued, live, free) == \
            js.grant_lanes(queued, live, free)
        assert ts.grant(sum(queued), live, free) == \
            js.grant(sum(queued), live, free)
        ahead, service = int(rng.integers(0, 20)), float(rng.random())
        assert ts.predict_completion_s(ahead, live, service) == \
            js.predict_completion_s(ahead, live, service)
        assert tsched.completion_waves(ahead, live, ts.max_live) == \
            jsched.completion_waves(ahead, live, js.max_live)


def test_kv_bytes_per_slot_differs_from_jax_by_the_overhang_slot():
    """A deliberate difference: the port's flat cache holds one k/v pair
    per layer application, 64 at the flagship (335,544,320 B a slot in
    bf16); the JAX cycle layout keeps 65 (its scan's discarded overhang
    application), 340,787,200 B. Configs without a cycle agree."""
    t_flag = tsched.kv_bytes_per_slot(tconfig.flagship_model_config())
    j_flag = jsched.kv_bytes_per_slot(jconfig.flagship_model_config())
    assert t_flag == 64 * 1280 * 1024 * 2 * 2 == 335_544_320
    assert j_flag == 65 * 1280 * 1024 * 2 * 2 == 340_787_200
    for kw in (FLAT, dict(attn_types=("full",), depth=3)):
        assert tsched.kv_bytes_per_slot(tconfig.tiny_model_config(**kw)) \
            == jsched.kv_bytes_per_slot(jconfig.tiny_model_config(**kw))


METRIC_CALLS = [
    ("record_submit", (0, "high")), ("record_submit", (1, "low")),
    ("record_submit", (2, "high")), ("record_admit", (0, True)),
    ("record_admit", (1, False)), ("record_first_code", (0,)),
    ("record_step", (2, 1)), ("note_service", (0,)),
    ("record_complete", (0, True)), ("record_cancelled", (1, True)),
    ("record_shed", ("low", 2)), ("record_shed", ("high",)),
    ("record_brownout", ()), ("record_flood", (3,)),
    ("record_submit", (3, "high")), ("record_failed", (3,)),
    ("record_step", (1, 4)),
]
_TIMED = ("uptime_s", "img_per_s", "goodput_img_per_s", "service_ema_s",
          "p50_latency_s", "p95_latency_s", "p50_ttft_s", "p95_ttft_s",
          "lanes")


@pytest.mark.parametrize("n", [4, 10, len(METRIC_CALLS)])
def test_metrics_ledger_equals_jax(n):
    """The same calls give the same counters and snapshot (everything but
    clock-valued entries)."""
    jm, tm = jmetrics.ServingMetrics(n_slots=4), \
        tmetrics.ServingMetrics(n_slots=4)
    for name, args in METRIC_CALLS[:n]:
        getattr(jm, name)(*args)
        getattr(tm, name)(*args)
    js, ts = jm.snapshot(), tm.snapshot()
    assert js.keys() == ts.keys()
    for key in js:
        if key not in _TIMED:
            assert ts[key] == js[key], key
    jc, tc = jm.counters(), tm.counters()
    assert jc.keys() == tc.keys()
    assert all(tc[k] == jc[k] for k in jc if k not in _TIMED)
    assert tmetrics.percentiles([3.0, 1.0, 2.0], (50.0, 99.0)) == \
        jmetrics.percentiles([3.0, 1.0, 2.0], (50.0, 99.0))


CHAOS_PLANS = {
    "pixel_fail": {"seed": 3, "rules": [{"ops": ["pixel"], "fail": 0.5}]},
    "half_close": {"seed": 9, "rules": [{"ops": ["client_send"],
                                         "half_close": 0.3}]},
    "admit": {"seed": 1, "rules": [{"ops": ["admit"], "fail": 0.2}],
              "floods": [{"at_s": 0.0, "burst": 3},
                         {"at_s": 5.0, "burst": 2}]},
    "crash": {"seed": 0, "crash_at_admission": 4},
}


def _chaos_trace(mod, plan, clock):
    chaos = mod.ServeChaos(mod.ServeFaultPlan.from_dict(plan), clock=clock)
    out = []
    for i in range(40):
        step = []
        for call in (lambda: chaos.on_client_send("http"),
                     lambda: chaos.on_pixel(i),
                     lambda: chaos.on_admit(2),
                     chaos.flood_due):
            try:
                step.append(call())
            except RuntimeError as e:       # ChaosInjectedError
                step.append(str(e))
        out.append(step)
        clock.t += 0.25
    return out, dict(chaos.injected)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("name", sorted(CHAOS_PLANS))
def test_chaos_decisions_equal_jax(name):
    """The same plan makes the same decisions, call by call: the same
    SHA-256 rolls, failures, half-closes, crashes and floods."""
    plan = CHAOS_PLANS[name]
    assert _chaos_trace(tchaos, plan, _Clock()) == \
        _chaos_trace(jchaos, plan, _Clock())
    tplan = tchaos.ServeFaultPlan.from_dict(plan)
    assert tplan.to_json() == jchaos.ServeFaultPlan.from_dict(plan).to_json()
    with pytest.raises(ValueError):
        tchaos.ServeFaultPlan.from_dict({**plan, "typo": 1})


# -- lifecycle ----------------------------------------------------------

def test_submit_validates_and_threads_are_reaped(flat_setup):
    _, cfg, _, model = flat_setup
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
        n_slots=1, queue_capacity=1))
    text = np.zeros(cfg.text_seq_len, np.int32)
    for bad in (dict(rng=1.5), dict(rng=2 ** 63), dict(rng=True),
                dict(sampling=SamplingConfig(temperature=-1.0)),
                dict(sampling=SamplingConfig(top_k=3.9)),
                dict(lane="urgent"), dict(deadline_s=0.0)):
        with pytest.raises(ValueError):
            engine.submit(text, **bad)
    with pytest.raises(ValueError):
        engine.submit(text[:-1])
    engine.submit(text, -5)
    with pytest.raises(RuntimeError, match="queue full"):
        engine.submit(text, 1)
    before = {t.name for t in threading.enumerate()}
    engine.start()
    engine.stop(drain=False)
    assert "decode-engine" not in {t.name for t in threading.enumerate()
                                   if t.name not in before}
    assert not engine.alive


def test_mid_decode_cancel_frees_the_slot(flat_setup):
    """A cancel while the request decodes frees its slot at the next
    boundary; the queued request then decodes its own codes. The first
    chunk waits on a gate, so the cancel lands mid-decode."""
    _, cfg, _, model = flat_setup
    texts = _texts(cfg, 2)
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
        n_slots=1, steps_per_call=2), sampling=SAM)
    gate, run = threading.Event(), engine.runner.run

    def gated(visible):
        run(visible)
        assert gate.wait(30)

    engine.runner.run = gated
    engine.start()
    try:
        first = engine.submit(texts[0], 1)
        second = engine.submit(texts[1], 2)
        while engine.readiness()["live_slots"] == 0:
            time.sleep(0.002)
        assert engine.cancel(first.request_id)
        gate.set()
        with pytest.raises(RuntimeError, match="cancelled"):
            first.result(timeout=60)
        row = second.result(timeout=120)
    finally:
        gate.set()
        engine.stop()
    np.testing.assert_array_equal(row["codes"], _solo(model, texts[1], 2))
    assert engine.stats()["cancelled"] == 1


# -- the HTTP front-end ---------------------------------------------------

def _serve(engine):
    httpd = ServingHTTPServer(("127.0.0.1", 0), engine,
                              request_timeout_s=60.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_http_round_trip(flat_setup):
    """/generate (two images: seeds s and s + 1, each equal to its
    ``generate_images`` row), the error paths, /healthz, /readyz, /stats
    and /metrics (the same ledger as /stats), with the JAX front-end's
    reply keys."""
    _, cfg, _, model = flat_setup
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
        n_slots=2, steps_per_call=4), sampling=SAM).start()
    httpd, thread, url = _serve(engine)
    try:
        tokens = _texts(cfg, 1)[0]
        status, body = _post(url, {"tokens": tokens.tolist(),
                                   "n_images": 2, "seed": 11})
        assert status == 200 and set(body) == {"seed", "results"}
        assert body["seed"] == 11
        for i, row in enumerate(body["results"]):
            assert {"codes", "request_id", "lane", "queue_wait_s",
                    "ttft_s", "latency_s"} <= set(row)
            np.testing.assert_array_equal(row["codes"],
                                          _solo(model, tokens, 11 + i))
        for bad in ({"text": "no tokenizer"}, {}, {"tokens": [1, 2]},
                    {"tokens": None},
                    {"tokens": tokens.tolist(), "seed": 2 ** 72},
                    {"tokens": tokens.tolist(), "temperature": -0.5},
                    {"tokens": tokens.tolist(), "top_k": 3.9},
                    {"tokens": tokens.tolist(), "n_images": 0}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, bad)
            assert e.value.code == 400, bad
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url, "/nope")
        assert e.value.code == 404
        status, health = _get(url, "/healthz")
        assert status == 200 and json.loads(health) == {"ok": True}
        status, ready = _get(url, "/readyz")
        ready = json.loads(ready)
        assert status == 200 and ready["ready"] and ready["n_slots"] == 2
        status, stats = _get(url, "/stats")
        stats = json.loads(stats)
        status, text = _get(url, "/metrics")
        assert status == 200
        fams = parse_text(text)
        assert fams["dalle_serving_completed_total"][""] == \
            stats["completed"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        thread.join(timeout=10)


def test_http_deadline_shed_is_429(flat_setup):
    """A predicted completion past the deadline is refused before any
    decode: 429 with ``"shed": true``."""
    _, cfg, _, model = flat_setup
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(n_slots=1))
    engine.metrics.prime_service(1000.0)
    httpd, thread, url = _serve(engine)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"tokens": _texts(cfg, 1)[0].tolist(),
                        "deadline_s": 1.0})
        assert e.value.code == 429
        assert json.loads(e.value.read())["shed"] is True
        assert engine.stats()["shed"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop(drain=False)
        thread.join(timeout=10)


def test_http_vanished_client_cancels_its_requests(flat_setup):
    """A client that hangs up mid-wait: the handler's disconnect probe
    cancels every request of the call, so the slots return to the
    scheduler instead of decoding for nobody."""
    _, cfg, _, model = flat_setup
    engine = DecodeEngine(model, cfg, tconfig.ServingConfig(
        n_slots=1, steps_per_call=1), sampling=SAM)
    httpd, thread, url = _serve(engine)
    try:
        body = json.dumps({"tokens": _texts(cfg, 1)[0].tolist(),
                           "n_images": 3}).encode()
        port = httpd.server_address[1]
        with socket.create_connection(("127.0.0.1", port), 10) as sock:
            sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: " + str(len(body)).encode()
                         + b"\r\n\r\n" + body)
            deadline = time.monotonic() + 30
            while engine.stats()["submitted"] < 3:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        # the engine has not started: nothing can finish before the
        # handler's disconnect probe cancels the three requests
        deadline = time.monotonic() + 60
        while engine.stats()["cancelled"] < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        engine.start()
        engine.stop()
        stats = engine.stats()
        assert (stats["completed"], stats["admitted"]) == (0, 0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop(drain=False)
        thread.join(timeout=10)
