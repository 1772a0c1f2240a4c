"""The port's serving router against ``dalle_tpu/serving/router.py``:
placement order (least predicted completion, prompt affinity), the healthy
set, stale-record eviction and failover on 429, 503 and transport errors
are decided exactly alike on the same records and in-flight counts; the
serving record crosses packages through the DHT; and end to end, a router
in front of two tiny port engines with the fixture tokenizer serves
``{"text": ...}`` prompts with the codes of a direct ``{"tokens": ...}``
request, a repeated caption landing on its home engine.
"""

import http.server
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dalle_tpu.serving import router as jrouter
from dalle_tpu_torch.serving import router as prouter

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "tokenizer.json")


def _records(rng, n, now):
    out = {}
    for i in range(n):
        pid = f"{int(rng.integers(1 << 62)):016x}{i}"
        rec = {"url": f"http://127.0.0.1:{9000 + i}",
               "t": now - float(rng.uniform(0, 40)),
               "queue_depth": int(rng.integers(0, 6)),
               "queue_capacity": int(rng.integers(1, 8)),
               "live_slots": int(rng.integers(0, 5)),
               "n_slots": 4}
        if rng.random() < 0.7:
            rec["max_live"] = int(rng.integers(1, 5))
        if rng.random() < 0.8:
            rec["service_ema_s"] = float(rng.choice(
                [0.5, 1.0, 1.0, 2.5, float(rng.uniform(0.1, 3))]))
        if rng.random() < 0.15:
            rec["draining"] = True
        if rng.random() < 0.1:
            del rec["url"]
        out[pid] = rec
    return out


def _routers(records, max_age=30.0, slack=0.5):
    """A JAX and a port Router over the same records."""
    return [mod.Router(lambda: dict(records), record_max_age_s=max_age,
                       affinity_slack_waves=slack)
            for mod in (jrouter, prouter)]


@pytest.fixture()
def frozen_now(monkeypatch):
    """Both packages' DHT clock fixed at one instant."""
    import dalle_tpu.swarm.dht as jdht
    now = 1.7e9
    monkeypatch.setattr(jdht, "get_dht_time", lambda: now)
    monkeypatch.setattr(prouter, "get_dht_time", lambda: now)
    return now


@pytest.mark.parametrize("seed", range(12))
def test_placement_equals_jax(frozen_now, seed):
    rng = np.random.default_rng(seed)
    now = frozen_now
    records = _records(rng, int(rng.integers(1, 7)), now)
    slack = float(rng.choice([0.0, 0.5, 2.0]))
    routers = _routers(records, max_age=float(rng.choice([10.0, 30.0])),
                       slack=slack)
    pids = sorted(records)
    inflight = {}
    for t in range(int(rng.integers(0, 8))):
        pid = pids[int(rng.integers(len(pids)))]
        inflight[t] = (pid, now - float(rng.uniform(-5, 45)),
                       int(rng.integers(1, 4)))
    for r in routers:
        r.refresh_once()
        r._inflight = dict(inflight)
    j, p = routers
    assert p.stats() == j.stats()
    assert p.healthy() == j.healthy()
    bodies = [{"tokens": [5, 9, 1]}, {"text": "a red cat"}, {},
              {"text": str(seed)}, {"tokens": "bad"}]
    for body in bodies:
        fp = prouter.request_fingerprint(body)
        assert fp == jrouter.request_fingerprint(body)
        assert p.candidates(fp) == j.candidates(fp)


def test_request_fingerprint_equals_jax():
    for body in ({"tokens": list(range(20))}, {"tokens": [[1, 2]]},
                 {"tokens": [2 ** 40]}, {"text": "猫 cat"},
                 {"text": 5}, {"n_images": 2}):
        assert prouter.request_fingerprint(body) == \
            jrouter.request_fingerprint(body)


def test_stale_records_are_evicted_alike(monkeypatch):
    import dalle_tpu.swarm.dht as jdht
    clock = [1000.0]
    monkeypatch.setattr(jdht, "get_dht_time", lambda: clock[0])
    monkeypatch.setattr(prouter, "get_dht_time", lambda: clock[0])
    records = {"a": {"url": "u1", "t": 990.0}, "b": {"url": "u2",
                                                     "t": 960.0},
               "c": {"url": "u3"}, "d": "junk", "e": {"t": 999.0}}
    routers = _routers(records, max_age=30.0)
    for when in (1000.0, 1015.0, 1025.0):
        clock[0] = when
        for r in routers:
            r.refresh_once()
        assert sorted(routers[1].stats()["engines"]) == \
            sorted(routers[0].stats()["engines"])
    assert routers[1].stats()["engines"] == {}


class _Stub(http.server.BaseHTTPRequestHandler):
    """An engine that answers every POST with a fixed status."""

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        code = self.server.code
        self.server.hits += 1
        body = json.dumps({"results": [{"codes": [1]}], "who":
                           self.server.name} if code == 200
                          else {"error": str(code)}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _stub(code, name):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    srv.code, srv.name, srv.hits = code, name, 0
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def _front(mod, router):
    httpd = mod.RouterHTTPServer(("127.0.0.1", 0), router,
                                 request_timeout_s=30.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.mark.parametrize("codes", [
    (429, 200), (503, 200), ("dead", 200), (429, 503), ("dead", "dead"),
    (200, 429), (500, 200),
])
def test_failover_equals_jax(codes):
    """Engines answering 429/503, refusing connections, or erroring:
    both routers try the same engines in the same order and relay the same
    answer, with the same ledger."""
    stubs, records = [], {}
    now = time.time()
    for i, c in enumerate(codes):
        if c == "dead":
            s = _stub(200, f"e{i}")
            url = f"http://127.0.0.1:{s.server_address[1]}"
            s.shutdown()
            s.server_close()
        else:
            s = _stub(c, f"e{i}")
            url = f"http://127.0.0.1:{s.server_address[1]}"
            stubs.append(s)
        # equal load: the first engine is the one with the lesser id
        records[f"p{i}"] = {"url": url, "t": now, "queue_depth": 0,
                            "queue_capacity": 4, "live_slots": 0,
                            "max_live": 2, "service_ema_s": 1.0}
    outcomes = []
    for mod in (jrouter, prouter):
        for s in stubs:
            s.hits = 0
        router = mod.Router(lambda: dict(records))
        router.refresh_once()
        httpd, url = _front(mod, router)
        try:
            status, body = _post(url, {"tokens": [1, 2, 3]})
            bad_status, _ = _post(url, {"n_images": 0})
        finally:
            httpd.shutdown()
            httpd.server_close()
        outcomes.append((status, body, bad_status, router.stats()["ledger"],
                         [s.hits for s in stubs]))
    for s in stubs:
        s.shutdown()
        s.server_close()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][2] == 400


def test_serving_record_crosses_packages(tmp_path):
    """A port engine's advertised record, read back by the port's and the
    JAX package's ``discover_engines`` through a mixed pair of DHT
    nodes."""
    from dalle_tpu.swarm import dht as jdht
    from dalle_tpu.swarm import identity as jid
    from dalle_tpu_torch.swarm import dht as tdht
    from dalle_tpu_torch.swarm import identity as tid

    class _Engine:
        tracer = None

        def readiness(self):
            return {"queue_depth": 2, "queue_capacity": 8, "live_slots": 1,
                    "n_slots": 4, "max_live": 4, "service_ema_s": 0.5,
                    "draining": False, "not_a_record_field": 1}

    tnode = tdht.DHT(identity=tid.Identity.generate(), rpc_timeout=2.0)
    jnode = jdht.DHT(initial_peers=[tnode.visible_address],
                     identity=jid.Identity.generate(), rpc_timeout=2.0)
    adv = prouter.ServingAdvertiser(tnode, "rt", _Engine(), "http://e:1",
                                    ttl=30.0)
    try:
        assert adv.publish_once()
        want = prouter.engine_record(_Engine(), "http://e:1")
        assert "not_a_record_field" not in want
        deadline = time.time() + 20
        while True:
            seen_j = jrouter.discover_engines(jnode, "rt")
            seen_p = prouter.discover_engines(tnode, "rt")
            if seen_j and seen_p or time.time() > deadline:
                break
            time.sleep(0.1)
        assert list(seen_p) == list(seen_j) == [tnode.peer_id]
        rec = seen_p[tnode.peer_id]
        assert {k: v for k, v in rec.items() if k != "t"} == \
            {k: v for k, v in want.items() if k != "t"}
        assert seen_j[tnode.peer_id] == rec
    finally:
        adv.stop()
        jnode.shutdown()
        tnode.shutdown()


# -- end to end: two tiny port engines behind the router --------------------

def test_router_serves_text_prompts_through_two_engines():
    from dalle_tpu_torch.config import ServingConfig, tiny_model_config
    from dalle_tpu_torch.data.tokenizer import CaptionTokenizer
    from dalle_tpu_torch.models.dalle import init_params
    from dalle_tpu_torch.models.decode import SamplingConfig
    from dalle_tpu_torch.serving.engine import DecodeEngine
    from dalle_tpu_torch.serving.server import ServingHTTPServer
    from dalle_tpu_torch.swarm import dht as tdht
    from dalle_tpu_torch.swarm import identity as tid

    cfg = tiny_model_config(vocab_text=2048, depth=2,
                            attn_types=("axial_row", "axial_col"))
    model = init_params(cfg, torch.Generator().manual_seed(3)).eval()
    tok = CaptionTokenizer.load(FIXTURE)
    greedy = SamplingConfig(temperature=0.0)
    nodes, engines, servers, advs = [], [], [], []
    router = front = None
    try:
        nodes.append(tdht.DHT(identity=tid.Identity.generate(),
                              rpc_timeout=2.0))
        for _ in range(2):
            nodes.append(tdht.DHT(initial_peers=[nodes[0].visible_address],
                                  identity=tid.Identity.generate(),
                                  rpc_timeout=2.0))
            eng = DecodeEngine(model, cfg, ServingConfig(
                n_slots=2, steps_per_call=4), sampling=greedy).start()
            httpd = ServingHTTPServer(("127.0.0.1", 0), eng, tokenizer=tok,
                                      request_timeout_s=60.0)
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            adv = prouter.ServingAdvertiser(nodes[-1], "e2e", eng, url)
            adv.publish_once()
            adv.start()
            engines.append(eng)
            servers.append((httpd, url))
            advs.append(adv)
        router = prouter.Router(prouter.dht_fetch_records(nodes[0], "e2e"),
                                refresh_s=0.5).start()
        deadline = time.time() + 20
        while len(router.healthy()) < 2 and time.time() < deadline:
            router.refresh_once()
            time.sleep(0.1)
        assert len(router.healthy()) == 2
        front, rurl = _front(prouter, router)
        captions = ["a red cat on a blue boat", "photo of a tiny house",
                    "a red cat on a blue boat"]
        rows, served = [], []
        for c in captions:
            before = [e.stats()["admitted"] for e in engines]
            status, body = _post(rurl, {"text": c, "seed": 4})
            assert status == 200, body
            rows.append(body["results"][0])
            after = [e.stats()["admitted"] for e in engines]
            served.append([i for i in range(2) if after[i] > before[i]])
        for c, row in zip(captions, rows):
            ids, _ = tok.encode(c, cfg.text_seq_len)
            status, direct = _post(servers[0][1], {"tokens": ids.tolist(),
                                                   "seed": 4})
            assert status == 200
            assert row["codes"] == direct["results"][0]["codes"]
            assert len(row["codes"]) == cfg.image_seq_len
        assert sum(e["completed"] for e in
                   router.stats()["per_engine"].values()) == 3
        # both copies of the repeated caption went to one engine: the
        # home its fingerprint picks when the engines are idle
        fp = prouter.request_fingerprint({"text": captions[0]})
        home = router.candidates(fp)[0][1]["url"]
        assert served[0] == served[2] and len(served[0]) == 1
        assert servers[served[0][0]][1] == home
        status, ready = 0, None
        with urllib.request.urlopen(rurl + "/readyz", timeout=10) as r:
            status, ready = r.status, json.loads(r.read())
        assert status == 200 and ready["placeable_engines"] == 2
    finally:
        if front is not None:
            front.shutdown()
            front.server_close()
        if router is not None:
            router.stop()
        for adv in advs:
            adv.stop()
        for httpd, _ in servers:
            httpd.shutdown()
            httpd.server_close()
        for eng in engines:
            eng.stop()
        for node in nodes[::-1]:
            node.shutdown()


def test_static_fetch_records_reads_readyz():
    """``run_router --static-engines``' provider: each engine's /readyz
    shaped as a record, a dead engine absent."""
    from dalle_tpu_torch.cli import run_router

    class _Ready(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):  # noqa: N802
            body = json.dumps({"queue_depth": 1, "draining": False}).encode()
            self.send_response(503 if self.server.busy else 200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    live = []
    for busy in (False, True):
        s = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Ready)
        s.busy = busy
        threading.Thread(target=s.serve_forever, daemon=True).start()
        live.append(s)
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in live]
    dead = "http://127.0.0.1:9"
    try:
        recs = run_router.static_fetch_records(urls + [dead],
                                               timeout_s=2.0)()
    finally:
        for s in live:
            s.shutdown()
            s.server_close()
    assert sorted(recs) == sorted(urls)
    for u in urls:
        assert recs[u]["url"] == u and recs[u]["queue_depth"] == 1
