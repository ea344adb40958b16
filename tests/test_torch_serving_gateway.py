"""The port's serving gateway against the JAX package's.

Both gateways run in this process on the CPU (the port with
``device="cpu"``), each on its own loopback port, and each scenario of
``tests/test_serving_gateway.py`` (all but its data-iterator class) and of
``tests/test_quantize.py::TestServingQuantize`` runs through both: the
same requests give the same status codes, the same ``Retry-After`` rule,
the same keys in ``/healthz``, ``/readyz``, ``/models`` and ``/slo``, and
the same monitoring families (names and labels). Real networks are built
by the JAX package and cross to the port through the zip; their predict
outputs agree within 1e-5. Stub models (plain Python) keep the timing
scenarios fast. ``import deeplearning4j_tpu_torch.generation`` loads no
HTTP stack.

The pairing helpers here (:class:`Pkg`, the isolation fixture, the HTTP
helpers, the JAX-built nets) serve ``test_torch_serving_sessions.py`` and
``test_torch_parallel_inference.py`` too.
"""

import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.env import env as jax_env
from deeplearning4j_tpu_torch.common.env import env

_VARS = ("DL4J_TORCH_MONITORING", "DL4J_TPU_MONITORING",
         "DL4J_TORCH_TRACING", "DL4J_TPU_TRACING", "DL4J_TORCH_FLIGHT",
         "DL4J_TPU_FLIGHT", "DL4J_TORCH_FAULTS", "DL4J_TPU_FAULTS")
TOL = 1e-5


class Pkg:
    """One package's serving tier, as the scenarios use it; the port's
    entry points get ``device="cpu"``."""

    def __init__(self, name):
        self.name = name
        root = "deeplearning4j_tpu" if name == "jax" else \
            "deeplearning4j_tpu_torch"
        mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
        self.serving = mod("serving")
        self.monitoring = mod("monitoring")
        self.flight = mod("monitoring.flight")
        self.context = mod("monitoring.context")
        self.registry_mod = mod("monitoring.registry")
        self.tracing = mod("monitoring.tracing")
        self.faults = mod("faults")
        self.inference = mod("parallel.inference")
        self.lifecycle = mod("serving.lifecycle")
        self.admission = mod("serving.admission")
        self.failover = mod("serving.failover")
        self.http = mod("serving.http")
        self.tenancy = mod("serving.tenancy")
        self.slo = mod("serving.slo")
        self.generation = mod("generation")
        self.serialization = mod("util.serialization")
        self.kw = {} if name == "jax" else {"device": "cpu"}

    def gateway(self, **kw):
        return self.serving.ServingGateway(**kw, **self.kw)

    def pi(self, model, **kw):
        return self.inference.ParallelInference(model, **kw, **self.kw)

    def model_server(self, model, **kw):
        return self.serving.ModelServer(model, **kw, **self.kw)

    def engine(self, net, **kw):
        return self.generation.GenerationEngine(net, **kw, **self.kw)

    def restore(self, path):
        """The zip as this package's network (the port's on the CPU)."""
        return self.serialization.restore_model(path, load_updater=False,
                                                **self.kw)

    def metrics_on(self):
        self.monitoring.reset()
        self.monitoring.enable()

    def __repr__(self):
        return self.name


JAX, PORT = Pkg("jax"), Pkg("torch")
PKGS = (JAX, PORT)


def _reset_all():
    for p in PKGS:
        p.monitoring.reset()
        p.faults.reset()
        p.lifecycle.reset()
        p.flight.configure(enabled=False)


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Both packages' monitoring, flight recorder, fault plans and
    lifecycle managers back to off, the env variables cleared BEFORE the
    teardown reloads ``env`` (no arming leaks into the next file)."""
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    env.reload()
    jax_env.reload()
    _reset_all()
    yield
    for var in _VARS:
        os.environ.pop(var, None)
    env.reload()
    jax_env.reload()
    _reset_all()


def both(scenario, *args, **kw):
    """``scenario(pkg, ...)`` on the JAX package, then on the port, each
    from a clean state: (jax's observation, the port's)."""
    out = []
    for p in PKGS:
        _reset_all()
        out.append(scenario(p, *args, **kw))
    _reset_all()
    return tuple(out)


class StubModel:
    """Plain-Python stand-in for a network: affine transform with optional
    service delay; records every input shape it executes."""

    def __init__(self, scale=1.0, delay=0.0):
        self.scale = scale
        self.delay = delay
        self.shapes = set()
        self._lock = threading.Lock()

    def output(self, x):
        x = np.asarray(x)
        with self._lock:
            self.shapes.add(tuple(x.shape))
        if self.delay:
            time.sleep(self.delay)
        return x * self.scale


def post(base, path, payload, timeout=30, headers=None):
    """POST helper returning (status, body-dict, headers)."""
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def get(base, path, timeout=10):
    try:
        r = urllib.request.urlopen(base + path, timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def families(text, prefixes=("dl4j_serving", "dl4j_tenant", "dl4j_slo",
                             "dl4j_recovery", "dl4j_generate",
                             "dl4j_retry")):
    """{(sample name, label names)} of an exposition, for the prefixes."""
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"([a-zA-Z_:][\w:]*)(\{(.*)\})?\s", line)
        if m and m.group(1).startswith(prefixes):
            labels = tuple(sorted(re.findall(r'(\w+)="', m.group(3) or "")))
            out.add((m.group(1), labels))
    return out


# ----------------------------------------------- networks built by JAX
def jax_dense(seed, n_in=4, hidden=8, n_out=3):
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.optimize.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Sgd(lr=0.1)).list()
            .layer(DenseLayer(n_out=hidden, activation="relu"))
            .layer(OutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf).init()


def jax_zip(net, path):
    from deeplearning4j_tpu.util.serialization import write_model

    write_model(net, str(path))
    return str(path)


TENANTS = [
    {"key": "key-int", "name": "alice", "klass": "interactive",
     "requests_per_window": 100},
    {"key": "key-bat", "name": "bob", "klass": "batch",
     "tokens_per_window": 4, "window_s": 60.0},
]


# ------------------------------------------------------------- buckets
def test_buckets_agree():
    for p in PKGS:
        s = p.serving
        assert s.pow2_buckets(32) == (1, 2, 4, 8, 16, 32)
        assert s.pow2_buckets(24) == (1, 2, 4, 8, 16, 24)
        assert s.pow2_buckets(1) == (1,)
        bs = s.pow2_buckets(32)
        assert [s.bucket_for(n, bs) for n in (1, 3, 32, 100)] == \
            [1, 4, 32, 32]


# --------------------------------------------------------- gateway basics
def _routing_and_canary(p):
    p.metrics_on()
    gw = p.gateway(port=0, batch_limit=8, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    obs = {}
    try:
        obs["healthz"] = get(base, "/healthz")[0]
        obs["readyz_empty"] = get(base, "/readyz")[0]
        obs["unknown"] = post(base, "/v1/nope/predict", {"inputs": [[1.0]]})[0]
        gw.register_model("m", "v1", StubModel(1.0), warmup_shape=(4,))
        obs["readyz"] = json.loads(get(base, "/readyz")[1])
        gw.register_model("m", "v2", StubModel(2.0), warmup_shape=(4,),
                          weight=0.0)
        gw.set_split("m", {"v1": 0.9, "v2": 0.1})
        versions = []
        for _ in range(60):
            code, body, _ = post(base, "/v1/m/predict",
                                 {"inputs": [[1.0, 2.0, 3.0, 4.0]]})
            assert code == 200
            scale = {"v1": 1.0, "v2": 2.0}[body["version"]]
            np.testing.assert_allclose(body["outputs"][0],
                                       [scale, 2 * scale, 3 * scale,
                                        4 * scale])
            versions.append(body["version"])
        obs["versions"] = versions
        models = json.loads(get(base, "/models")[1])["models"]
        obs["model_keys"] = sorted(models["m"])
        obs["version_keys"] = sorted(models["m"]["versions"]["v1"])
        obs["split"] = models["m"]["split"]
        obs["healthz_keys"] = sorted(json.loads(get(base, "/healthz")[1]))
        scrape = get(base, "/metrics")[1]
        obs["scraped"] = [
            'dl4j_serving_model_request_seconds_bucket{model="m"' in scrape,
            'dl4j_serving_model_loaded{model="m",version="v1"} 1' in scrape]
    finally:
        gw.stop()
    return obs


def test_lifecycle_routing_and_canary():
    jx, pt = both(_routing_and_canary)
    assert pt == jx
    assert [pt[k] for k in ("healthz", "readyz_empty", "unknown")] == \
        [200, 503, 404]
    assert pt["readyz"] == {"ready": True, "models": ["m"]}
    seen = {v: pt["versions"].count(v) for v in ("v1", "v2")}
    assert seen["v1"] > seen["v2"] > 0
    assert pt["split"] == {"v1": 0.9, "v2": 0.1}
    assert pt["scraped"] == [True, True]


def _warmup_shapes(p):
    p.metrics_on()
    gw = p.gateway(port=0, batch_limit=8, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        m = StubModel()
        gw.register_model("m", "v1", m, warmup_shape=(4,))
        warmed = set(m.shapes)
        codes = [post(base, "/v1/m/predict", {"inputs": [[0.0] * 4] * n})[0]
                 for n in (1, 2, 3, 5, 8)]
        fam = p.monitoring.registry().get("dl4j_serving_warmup_seconds")
        return {"warmed": sorted(warmed), "after": sorted(m.shapes),
                "codes": codes,
                "warmup_count": fam.labels(model="m", version="v1").count}
    finally:
        gw.stop()


def test_warmup_covers_every_request_shape():
    jx, pt = both(_warmup_shapes)
    assert pt == jx
    assert pt["warmed"] == sorted((b, 4) for b in (1, 2, 4, 8))
    assert pt["after"] == pt["warmed"]      # no unwarmed request shape
    assert pt["codes"] == [200] * 5 and pt["warmup_count"] == 4


# ----------------------------------------------------- admission control
def _overload(p):
    p.metrics_on()
    gw = p.gateway(port=0, batch_limit=1, max_queue=2, seed=0,
                   queue_timeout_s=0.001).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("slow", "v1", StubModel(delay=0.1),
                          warmup_shape=(2,))
        results, lock = [], threading.Lock()

        def fire():
            code, body, headers = post(base, "/v1/slow/predict",
                                       {"inputs": [[1.0, 2.0]]})
            with lock:
                results.append((code, headers.get("Retry-After"),
                                sorted(body)))

        threads = [threading.Thread(target=fire) for _ in range(16)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        elapsed = time.monotonic() - t0
        shed = p.monitoring.registry().get("dl4j_serving_shed_total")
        n_shed = shed.labels(model="slow", reason="queue_full",
                             **{"class": "default"}).value
        return results, elapsed, n_shed
    finally:
        gw.stop()


def test_overload_sheds_429_never_hangs():
    for results, elapsed, n_shed in both(_overload):
        codes = [c for c, _, _ in results]
        assert len(codes) == 16 and set(codes) <= {200, 429}, codes
        assert codes.count(429) >= 1 and codes.count(200) >= 1, codes
        for code, retry_after, keys in results:
            assert keys == (["error"] if code == 429
                            else ["model", "outputs", "version"])
            if code == 429:
                assert 1 <= int(retry_after) <= 30
        assert elapsed < 10.0
        assert n_shed == codes.count(429)


def _deadline_and_error(p):
    class Broken:
        def output(self, x):
            raise RuntimeError("boom")

    gw = p.gateway(port=0, batch_limit=1, seed=0,
                   queue_timeout_s=0.001).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("slow", "v1", StubModel(delay=0.2),
                          warmup_shape=(2,))
        gw.register_model("b", "v1", Broken(), warmup=False)
        c1, b1, _ = post(base, "/v1/slow/predict",
                         {"inputs": [[1.0, 2.0]], "timeout_ms": 30})
        c2, _, _ = post(base, "/v1/slow/predict",
                        {"inputs": [[1.0, 2.0]], "timeout_ms": 5000})
        c3, b3, _ = post(base, "/v1/b/predict", {"inputs": [[1.0]]})
        return [c1, "deadline" in b1["error"], c2, c3, "boom" in b3["error"]]
    finally:
        gw.stop()


def test_deadline_504_and_model_error_500():
    jx, pt = both(_deadline_and_error)
    assert pt == jx == [504, True, 200, 500, True]


# -------------------------------------------------------------- lifecycle
def _drain_in_flight(p):
    gw = p.gateway(port=0, batch_limit=1, seed=0,
                   queue_timeout_s=0.001).start()
    base = f"http://127.0.0.1:{gw.port}"
    gw.register_model("slow", "v1", StubModel(delay=0.3), warmup_shape=(2,))
    results = {}

    def fire(tag):
        results[tag] = post(base, "/v1/slow/predict",
                            {"inputs": [[1.0, 2.0]]})[0]

    inflight = threading.Thread(target=fire, args=("inflight",))
    inflight.start()
    time.sleep(0.1)
    stopper = threading.Thread(target=gw.stop)
    stopper.start()
    time.sleep(0.05)
    late = threading.Thread(target=fire, args=("late",))
    late.start()
    for t in (inflight, late, stopper):
        t.join(timeout=30)
    return results


def test_drain_completes_in_flight():
    jx, pt = both(_drain_in_flight)
    assert pt == jx == {"inflight": 200, "late": 503}


def _hot_reload(p):
    gw = p.gateway(port=0, batch_limit=4, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("m", "v1", StubModel(1.0), warmup_shape=(2,))
        stop = threading.Event()
        outcomes, lock = [], threading.Lock()

        def hammer():
            while not stop.is_set():
                code, body, _ = post(base, "/v1/m/predict",
                                     {"inputs": [[1.0, 2.0]]})
                with lock:
                    outcomes.append((code, body.get("outputs")))

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        gw.register_model("m", "v1", StubModel(2.0), warmup_shape=(2,))
        time.sleep(0.15)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        return outcomes
    finally:
        gw.stop()


def test_hot_reload_zero_drops():
    for outcomes in both(_hot_reload):
        assert outcomes
        assert {c for c, _ in outcomes} == {200}
        for _, outs in outcomes:
            assert outs[0] in ([1.0, 2.0], [2.0, 4.0])
        assert outcomes[-1][1][0] == [2.0, 4.0]


# ------------------------------------------------------------ admin routes
@pytest.fixture(scope="module")
def dense_zips(tmp_path_factory):
    """Two JAX-built dense nets, written to zips by the JAX package."""
    d = tmp_path_factory.mktemp("dense")
    nets = {v: jax_dense(seed) for v, seed in (("v1", 1), ("v2", 2))}
    return nets, {v: jax_zip(n, d / f"{v}.zip") for v, n in nets.items()}


def _admin_from_disk(p, paths, xs):
    gw = p.gateway(port=0, batch_limit=4, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        codes = [post(base, "/models/load",
                      {"name": "mlp", "version": v, "path": paths[v],
                       "warmup": False})[0] for v in ("v1", "v2")]
        code, body, _ = post(base, "/models/split",
                             {"name": "mlp", "split": {"v1": 0.5, "v2": 0.5}})
        codes.append(code)
        split = body["split"]
        outs = []
        for _ in range(20):
            code, body, _ = post(base, "/v1/mlp/predict",
                                 {"inputs": xs.tolist()})
            codes.append(code)
            outs.append((body["version"], np.asarray(body["outputs"])))
        codes.append(post(base, "/models/unload", {"name": "mlp"})[0])
        codes.append(post(base, "/v1/mlp/predict",
                          {"inputs": xs.tolist()})[0])
        codes.append(get(base, "/readyz")[0])
        return codes, split, outs
    finally:
        gw.stop()


def test_load_split_unload_from_disk(dense_zips):
    nets, paths = dense_zips
    xs = np.linspace(-1, 1, 8).reshape(2, 4).astype(np.float32)
    (jc, jsplit, jouts), (pc, psplit, pouts) = both(_admin_from_disk, paths,
                                                    xs)
    assert pc == jc == [200] * 3 + [200] * 20 + [200, 404, 503]
    assert psplit == jsplit == {"v1": 0.5, "v2": 0.5}
    # the same routing sequence (both routers are random.Random(0))
    assert [v for v, _ in pouts] == [v for v, _ in jouts]
    assert {v for v, _ in pouts} == {"v1", "v2"}
    for (v, got), (_, want) in zip(pouts, jouts):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        np.testing.assert_allclose(got, np.asarray(nets[v].output(xs)),
                                   rtol=0, atol=TOL)


def _bad_admin(p):
    gw = p.gateway(port=0, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        out = [post(base, "/models/load", {"name": "x"})[0],
               post(base, "/models/unload", {"name": "x"})[0],
               post(base, "/models/split",
                    {"name": "x", "split": {"v": 1}})[0]]
    finally:
        gw.stop()
    gw = p.gateway(port=0, seed=0, admin=False).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("m", "v1", StubModel(), warmup=False)
        out += [post(base, "/models/unload", {"name": "m"})[0],
                post(base, "/v1/m/predict", {"inputs": [[1.0]]})[0]]
    finally:
        gw.stop()
    return out


def test_bad_and_disabled_admin_requests():
    jx, pt = both(_bad_admin)
    assert pt == jx == [400, 404, 404, 404, 200]


# ----------------------------------------------------- legacy ModelServer
def _model_server(p):
    server = p.model_server(StubModel(delay=0.5), port=0, batch_limit=1,
                            queue_timeout=0.1)
    server._pi.queue_timeout_s = 0.001
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, body, _ = post(base, "/predict",
                             {"inputs": [[1.0], [2.0], [3.0]]})
        deadline = time.monotonic() + 10
        while server._pi.backlog() and time.monotonic() < deadline:
            time.sleep(0.01)
        out = [code, "timed out" in body["error"], server._pi.backlog()]
    finally:
        server.stop()
    server = p.model_server(StubModel(3.0), port=0, batch_limit=4).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, body, _ = post(base, "/predict", {"inputs": [[1.0, 2.0]]})
        out += [code, body, json.loads(get(base, "/health")[1])]
    finally:
        server.stop()
    return out


def test_model_server_timeout_and_healthy_predict():
    jx, pt = both(_model_server)
    assert pt == jx == [504, True, 0, 200, {"outputs": [[3.0, 6.0]]},
                        {"status": "ok"}]


def test_real_model_warmup_and_serve(tmp_path):
    """A JAX-built network through the port's ``/models/load``, warmed at
    every bucket: its outputs are the JAX network's within 1e-5 and the
    first request pays no first-call cost that warm-up should have."""
    net = jax_dense(0, hidden=16)
    path = jax_zip(net, tmp_path / "mlp.zip")
    PORT.metrics_on()
    gw = PORT.gateway(port=0, batch_limit=8, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        code, body, _ = post(base, "/models/load",
                             {"name": "mlp", "version": "v1", "path": path,
                              "warmup_shape": [4], "batch_limit": 8})
        assert code == 200 and body["loaded"]["warmed"] == [1, 2, 4, 8]
        assert sorted(gw.registry.get("mlp", "v1").warmup_timings) == \
            [1, 2, 4, 8]
        xs = np.linspace(-1, 1, 12).reshape(3, 4).astype(np.float32)
        t0 = time.perf_counter()
        code, body, _ = post(base, "/v1/mlp/predict", {"inputs": xs.tolist()})
        first = time.perf_counter() - t0
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["outputs"]),
                                   np.asarray(net.output(xs)), rtol=0,
                                   atol=TOL)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            post(base, "/v1/mlp/predict", {"inputs": xs.tolist()})
            times.append(time.perf_counter() - t0)
        assert first < max(20 * float(np.median(times)), 1.0)
    finally:
        gw.stop()


# ----------------------------------------------------------- multi-tenant
def _auth_and_quota(p):
    p.metrics_on()
    gw = p.gateway(port=0, seed=0, tenants=TENANTS).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("m", "v1", StubModel(scale=2.0), warmup=False)
        x = {"inputs": [[1.0, 2.0]]}
        out = []
        for payload, hdr in ((x, None), (x, {"X-Api-Key": "nope"}),
                             (x, {"X-Api-Key": "key-int"}),
                             (dict(x, api_key="key-int"), None),
                             ({"inputs": [[1.0, 2.0]] * 4,
                               "api_key": "key-bat"}, None),
                             (dict(x, api_key="key-bat"), None)):
            code, body, hdrs = post(base, "/v1/m/predict", payload,
                                    headers=hdr)
            out.append((code, body.get("outputs"),
                        "API key" in body.get("error", ""),
                        "quota" in body.get("error", ""),
                        "Retry-After" in hdrs))
        text = p.monitoring.registry().exposition()
        out.append([
            'dl4j_serving_shed_total{model="m",reason="quota",'
            'class="batch"} 1' in text,
            'dl4j_tenant_requests_total{tenant="bob",'
            'outcome="quota_tokens"} 1' in text])
        return out
    finally:
        gw.stop()


def test_auth_required_and_quota_shed():
    jx, pt = both(_auth_and_quota)
    assert pt == jx
    assert [o[0] for o in pt[:-1]] == [401, 401, 200, 200, 200, 429]
    assert pt[0][2] and pt[2][1] == [[2.0, 4.0]]
    assert pt[5][3] and pt[5][4] and pt[-1] == [True, True]


def _slo_shed(p):
    p.metrics_on()
    slo = p.serving.SloTracker(
        {"interactive": {"objective_ms": 1, "target": 0.5}}, min_samples=2)
    gw = p.gateway(port=0, seed=0, tenants=TENANTS, slo=slo).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("m", "v1", StubModel(), warmup=False)
        for _ in range(4):
            gw.slo.observe("interactive", 1.0)
        out = [gw.slo.should_shed("batch"), gw.slo.should_shed("interactive")]
        x = {"inputs": [[1.0, 2.0]]}
        code, body, _ = post(base, "/v1/m/predict", dict(x, api_key="key-bat"))
        out += [code, "higher-priority" in body["error"]]
        out.append(post(base, "/v1/m/predict", dict(x, api_key="key-int"))[0])
        text = p.monitoring.registry().exposition()
        out.append('dl4j_serving_shed_total{model="m",reason="slo",'
                   'class="batch"} 1' in text)
        code, raw = get(base, "/slo")
        status = json.loads(raw)
        inter = status["classes"]["interactive"]
        # the interactive latency the predict above adds is the only
        # timing-dependent field
        out += [code, sorted(status), sorted(status["classes"]),
                sorted(inter), inter["burn_rate"] > 1.0, inter["shedding"],
                status["priority_order"], status["shed_threshold"],
                inter["objective_ms"], inter["target"]]
        return out
    finally:
        gw.stop()


def test_slo_sheds_lowest_class_first():
    jx, pt = both(_slo_shed)
    assert pt == jx
    assert pt[:6] == [True, False, 429, True, 200, True]
    assert pt[6] == 200 and pt[10] is True and pt[11] is False
    assert pt[12] == ["interactive", "default", "batch"]


def test_retry_after_tracks_drain_rate():
    seqs = []
    for p in PKGS:
        adm = p.serving.AdmissionController(retry_after_s=2.0)
        seq = [adm.retry_after_for(None), adm.retry_after_for(5)]
        adm.observe_service(2.0)
        seq += [adm.retry_after_for(n) for n in (5, 1, 1000)]
        for _ in range(40):
            adm.observe_service(0.001)
        seq += [adm.retry_after_for(1), adm._ewma_service_s < 0.1]
        seqs.append(seq)
    assert seqs[1] == seqs[0] == [2, 2, 10, 2, 30, 1, True]


def _priority_lane_order(p):
    order, lock = [], threading.Lock()

    class Recorder:
        def output(self, x):
            x = np.asarray(x)
            with lock:
                order.extend(float(v) for v in x[:, 0])
            time.sleep(0.15)
            return x

    pi = p.pi(Recorder(), batch_limit=1, queue_timeout_s=0.001).start()
    try:
        qs = [pi.submit(np.zeros(2))]
        time.sleep(0.05)
        qs += [pi.submit(np.full(2, 10.0 + i), klass="batch")
               for i in range(3)]
        qs += [pi.submit(np.full(2, 1.0 + i)) for i in range(2)]
        for q in qs:
            p.inference.resolve(q.get(timeout=30))
        return order
    finally:
        pi.stop(drain=False)


def test_priority_lane_served_before_batch():
    jx, pt = both(_priority_lane_order)
    assert pt == jx == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]


def _shed_gauge(p):
    p.metrics_on()
    gw = p.gateway(port=0, seed=0, queue_timeout_s=0.001)
    mv = gw.register_model("m", "v1", StubModel(delay=0.1), warmup=False,
                           batch_limit=1)
    try:
        gauge = p.monitoring.registry().get("dl4j_serving_model_queue_depth")
        q0 = mv.pi.submit(np.ones(2))
        time.sleep(0.03)
        dead = [mv.pi.submit(np.ones(2), deadline=time.monotonic() - 1.0)
                for _ in range(3)]
        out = [mv.pi.backlog()]
        out += [type(q.get(timeout=30)).__name__ for q in dead]
        q0.get(timeout=30)
        deadline = time.monotonic() + 5
        while (gauge.labels(model="m", version="v1").value != 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        shed = p.monitoring.registry().get("dl4j_serving_shed_total")
        out += [gauge.labels(model="m", version="v1").value,
                shed.labels(model="m", reason="deadline",
                            **{"class": "default"}).value]
        return out
    finally:
        gw.registry.shutdown()


def test_shed_decrements_queue_depth_gauge():
    jx, pt = both(_shed_gauge)
    assert pt == jx == [3] + ["DeadlineExceeded"] * 3 + [0, 3]


def _autoscale(p):
    p.metrics_on()
    gw = p.gateway(port=0, seed=0, queue_timeout_s=0.001)
    mv = gw.register_model("m", "v1", StubModel(delay=0.02), warmup=False,
                           batch_limit=1)
    asc = p.serving.ReplicaAutoscaler(gw.registry, max_replicas=3,
                                      high_backlog=2.0, low_backlog=1.0,
                                      scale_up_after=2, scale_down_after=3)
    try:
        out = [mv.pi.replicas()]
        qs = [mv.pi.submit(np.ones(2)) for _ in range(20)]
        d1, d2 = asc.tick()["m/v1"], asc.tick()["m/v1"]
        out += [d1["scaled"], d2["scaled"], d2["replicas"]]
        for q in qs:
            q.get(timeout=30)
        out += [asc.tick()["m/v1"]["scaled"] for _ in range(2)]
        d5 = asc.tick()["m/v1"]
        out += [d5["scaled"], d5["replicas"]]
        deadline = time.monotonic() + 5
        while mv.pi.replicas() > 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        out.append(mv.pi.replicas())
        out.append([asc.tick()["m/v1"]["scaled"] for _ in range(6)])
        out.append(mv.pi._target)
        text = p.monitoring.registry().exposition()
        out += [f'dl4j_serving_autoscale_total{{model="m",version="v1",'
                f'direction="{d}"}} 1' in text for d in ("up", "down")]
        out.append(sorted(asc.describe()))
        return out
    finally:
        gw.registry.shutdown()


def test_autoscaler_hysteresis_and_bounds():
    jx, pt = both(_autoscale)
    assert pt == jx
    assert pt[:8] == [1, None, "up", 2, None, None, "down", 1]
    assert pt[8] == 1 and "down" not in pt[9] and pt[10] == 1
    assert pt[11:13] == [True, True]


def test_unconfigured_gateway_makes_zero_tenancy_calls(monkeypatch):
    """Zero-overhead contract, in the port: with no tenants, SLO,
    autoscaling, tracing or recorder, and monitoring off, an HTTP predict
    makes no metric write and no tenancy, SLO, tracer or recorder call."""
    p = PORT
    assert not p.monitoring.enabled()
    calls = []

    def spy(name):
        def record(self, *a, **kw):
            calls.append(name)
        return record

    reg, ctx = p.registry_mod, p.context
    for cls, meth in ((reg.Counter, "inc"), (reg.Gauge, "set"),
                      (reg.Gauge, "inc"), (reg.Gauge, "dec"),
                      (reg.Histogram, "observe"),
                      (p.tenancy.TenantTable, "authorize"),
                      (p.tenancy.TenantTable, "admit"),
                      (p.slo.SloTracker, "observe"),
                      (p.slo.SloTracker, "should_shed"),
                      (ctx.RequestTracer, "begin"),
                      (ctx.RequestTrace, "add_span"),
                      (ctx.RequestTrace, "event"),
                      (p.flight.FlightRecorder, "record"),
                      (p.tracing.SpanTracer, "complete"),
                      (p.tracing.SpanTracer, "instant")):
        monkeypatch.setattr(cls, meth, spy(f"{cls.__name__}.{meth}"))
    gw = p.gateway(port=0, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        assert (gw.tenancy, gw.slo, gw.autoscaler, gw.tracer) == \
            (None, None, None, None)
        gw.register_model("m", "v1", StubModel(), warmup=False)
        code, body, _ = post(base, "/v1/m/predict", {"inputs": [[1.0, 2.0]]})
        assert code == 200 and body["outputs"] == [[1.0, 2.0]]
        code, raw = get(base, "/slo")
        assert code == 200 and json.loads(raw) == {"enabled": False}
    finally:
        gw.stop()
    assert calls == []


def _mixed_priority_drain(p):
    p.metrics_on()
    gw = p.gateway(port=0, seed=0, batch_limit=1, queue_timeout_s=0.001,
                   tenants=TENANTS).start()
    base = f"http://127.0.0.1:{gw.port}"
    mv = gw.register_model("slow", "v1", StubModel(delay=0.2), warmup=False,
                           batch_limit=1)
    results = {}

    def fire(tag, key):
        results[tag] = post(base, "/v1/slow/predict",
                            {"inputs": [[1.0, 2.0]], "api_key": key})[0]

    t_int = threading.Thread(target=fire, args=("inflight", "key-int"))
    t_int.start()
    time.sleep(0.1)
    with p.faults.injected("infer_crash:1") as plan:
        t_b = [threading.Thread(target=fire, args=(f"qb{i}", "key-bat"))
               for i in range(2)]
        for t in t_b:
            t.start()
        time.sleep(0.05)
        stopper = threading.Thread(target=gw.stop)
        stopper.start()
        time.sleep(0.05)
        t_late = threading.Thread(target=fire, args=("late", "key-bat"))
        t_late.start()
        for t in [t_int, *t_b, t_late, stopper]:
            t.join(timeout=30)
            assert not t.is_alive()
        injected = plan.injected["infer_crash"]
    return [results["inflight"], sorted([results["qb0"], results["qb1"]]),
            results["late"], injected, mv.pi.backlog()]


def test_drain_mixed_classes_with_injected_crash():
    jx, pt = both(_mixed_priority_drain)
    assert pt == jx == [200, [200, 500], 503, 1, 0]


def _chaos(p):
    p.metrics_on()
    gw = p.gateway(port=0, seed=0, batch_limit=2, max_queue=64,
                   tenants=TENANTS,
                   slo={"interactive": {"objective_ms": 5000}}).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        gw.register_model("m", "v1", StubModel(delay=0.005), warmup=False)
        codes = []
        with p.faults.injected("worker_crash:1;traffic_spike:1") as plan:
            for _ in range(6):
                burst = 3 if plan.fires("traffic_spike") else 1
                for _ in range(burst):
                    codes.append(post(base, "/v1/m/predict",
                                      {"inputs": [[1.0, 2.0]],
                                       "api_key": "key-int"})[0])
            injected = dict(plan.injected)
        code, body, _ = post(base, "/v1/m/predict",
                             {"inputs": [[3.0, 4.0]], "api_key": "key-int"})
        text = p.monitoring.registry().exposition()
        return [codes, injected, code, body["outputs"],
                'dl4j_recovery_total{component="serving",'
                'outcome="worker_restarted"} 1' in text,
                families(text)]
    finally:
        gw.stop()


def test_worker_crash_and_traffic_spike():
    jx, pt = both(_chaos)
    assert pt[:5] == jx[:5]
    codes, injected = pt[0], pt[1]
    assert injected == {"worker_crash": 1, "traffic_spike": 1}
    assert codes.count(500) == 1 and codes.count(200) == len(codes) - 1
    assert pt[2:5] == [200, [[3.0, 4.0]], True]
    # the families the gateway emitted: the same names and label names
    assert pt[5] == jx[5] and pt[5]


# ------------------------------------------------------ load-time int8
def _serving_quantize(p, path, x):
    gw = p.gateway(port=0, batch_limit=4, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        code, body, _ = post(base, "/models/load",
                             {"name": "m", "version": "v1", "path": path,
                              "warmup": False, "quantize": "int8"})
        models = json.loads(get(base, "/models")[1])["models"]
        quantized = models["m"]["versions"]["v1"]["quantized"]
        pcode, pbody, _ = post(base, "/v1/m/predict", {"inputs": x})
        bad = post(base, "/models/load",
                   {"name": "m", "version": "v2", "path": path,
                    "warmup": False, "quantize": "int4"})[0]
        return [code, quantized, pcode, bad], np.asarray(pbody["outputs"])
    finally:
        gw.stop()


def test_load_time_quantization(tmp_path):
    net = jax_dense(21, n_in=4, hidden=8, n_out=3)
    path = jax_zip(net, tmp_path / "m.zip")
    x = [[1.0, 2.0, 3.0, 4.0], [-1.0, 0.5, 0.25, 2.0]]
    (jc, jout), (pc, pout) = both(_serving_quantize, path, x)
    assert pc == jc == [200, True, 200, 400]
    # the port's load-time int8 against its own quantize() (the JAX test's
    # tolerance) and against the JAX gateway's answer
    want = PORT.restore(path).quantize().output(np.asarray(x, np.float32))
    np.testing.assert_allclose(pout, want.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pout, jout, rtol=0, atol=TOL)


# ------------------------------------------------------- device contract
def test_entry_points_take_the_card_unless_told():
    """Without a card, every serving entry point asked for the default
    device raises; a ``mesh`` on another device type than the queue's
    raises; ``KNNServer`` names the module it waits for."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import (
        KNNServer, ModelRegistry, ModelServer, ServingGateway,
    )

    if not torch.cuda.is_available():
        for build in (ServingGateway, ModelRegistry,
                      lambda: ParallelInference(StubModel()),
                      lambda: ModelServer(StubModel())):
            with pytest.raises(RuntimeError, match="cuda"):
                build()
    class CardMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="mesh runs on cuda"):
        ParallelInference(StubModel(), mesh=CardMesh(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            KNNServer(np.zeros((4, 2)))
    server = KNNServer(np.eye(4, 2, dtype=np.float32), backend="brute",
                       device="cpu")
    assert server._query_one([1.0, 0.0], 1)[0]["index"] == 0


def test_load_route_restores_onto_the_gateway_device(dense_zips):
    _, paths = dense_zips
    gw = PORT.gateway(port=0, seed=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        assert post(base, "/models/load",
                    {"name": "m", "version": "v1", "path": paths["v1"],
                     "warmup": False})[0] == 200
        model = gw.registry.get("m", "v1").model
        assert model.device == gw.device == torch.device("cpu")
        assert model.params[0]["W"].device.type == "cpu"
    finally:
        gw.stop()


# ---------------------------------------------------------- import graph
def test_generation_import_pulls_no_http_stack():
    """``import deeplearning4j_tpu_torch.generation`` loads the warm-up
    buckets only: no HTTP server, gateway or JAX."""
    code = (
        "import sys; import deeplearning4j_tpu_torch.generation; "
        "bad = [m for m in ('jax', 'deeplearning4j_tpu', "
        "'deeplearning4j_tpu_torch.serving.http', "
        "'deeplearning4j_tpu_torch.serving.gateway', "
        "'deeplearning4j_tpu_torch.serving.registry') "
        "if m in sys.modules]; assert not bad, bad"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env=dict(os.environ, PYTHONPATH=root))


def test_base_import_pulls_no_serving_or_generation():
    code = (
        "import sys; import deeplearning4j_tpu_torch; "
        "bad = [m for m in sys.modules if m.startswith(("
        "'deeplearning4j_tpu_torch.generation', "
        "'deeplearning4j_tpu_torch.serving'))]; assert not bad, bad"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env=dict(os.environ, PYTHONPATH=root))


def test_lazy_exports_match_the_jax_package():
    assert sorted(PORT.serving.__all__) == sorted(JAX.serving.__all__)
    assert sorted(PORT.serving._EXPORTS) == sorted(JAX.serving._EXPORTS)
    for name in PORT.serving._EXPORTS:
        assert getattr(PORT.serving, name) is not None
