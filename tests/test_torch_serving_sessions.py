"""The port's streaming generate route, sessions, lifecycle and failover
against the JAX package's.

Each scenario of ``tests/test_sessions.py`` (``TestPreemptionLifecycle``,
``TestHttpReconnect``, ``TestCircuitBreaker``, ``TestGatewayFailover``,
``TestZeroOverheadSpies``) and of ``tests/test_generation.py``
(``TestStreamingHTTP``, ``TestPriorityLanes``, ``TestMixedPriorityDrain``)
runs through both packages' gateways in this process, the port's on the
CPU, with the same network (the JAX package builds it; the port restores
its zip): the same status codes, finish reasons, journal states and
breaker transitions. Sampled streams are each package's own (the two
samplers draw differently), and each must survive a preemption, a restart
and a reconnect token for token; greedy ndjson streams of a small LSTM
and a small causal LM are equal across the packages token for token.
"""

import http.client
import json
import time

import numpy as np
import pytest

from test_torch_serving_gateway import (  # noqa: F401 (the autouse fixture)
    PKGS, PORT, _isolate, both, jax_zip, post,
)

V = 13
SAMPLER = dict(max_new_tokens=12, temperature=0.9, seed=11)


def _jax_lstm():
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(LSTMLayer(n_out=12))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, 8)).build())
    return MultiLayerNetwork(conf).init()


def _jax_ring():
    """One causal transformer layer (the JAX test's ``ring_net``)."""
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import (
        EmbeddingSequenceLayer, RnnOutputLayer,
    )
    from deeplearning4j_tpu.nn.layers.attention import (
        PositionalEmbeddingLayer, TransformerEncoderLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(5).list()
            .layer(EmbeddingSequenceLayer(n_out=16, n_in=V))
            .layer(PositionalEmbeddingLayer(max_len=32))
            .layer(TransformerEncoderLayer(d_model=16, n_heads=2,
                                           causal=True))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, 12)).build())
    return MultiLayerNetwork(conf).init()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """{pkg name: (lstm net, causal LM)}: the JAX package's, and the port's
    restored from their zips."""
    d = tmp_path_factory.mktemp("nets")
    jl, jr = _jax_lstm(), _jax_ring()
    pl, pr = (PORT.restore(jax_zip(n, d / f"{k}.zip"))
              for k, n in (("lstm", jl), ("ring", jr)))
    return {"jax": (jl, jr), "torch": (pl, pr)}


def _codec(p):
    return p.generation.CharCodec("abcdefghijklm")


def _stream_req(port, name, payload, headers=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    conn.request("POST", f"/v1/{name}/generate",
                 json.dumps(payload).encode(), h)
    return conn, conn.getresponse()


def _read_stream(port, name, payload, headers=None):
    conn, r = _stream_req(port, name, payload, headers)
    lines = [json.loads(x) for x in r if x.strip()]
    conn.close()
    return r, lines


# ------------------------------------------------------ lifecycle + faults
def _unmanaged_preempt(p, net, tmp_path):
    p.monitoring.enable()
    p.flight.configure(enabled=True)
    path = str(tmp_path / f"{p.name}-unmanaged.ndjson")
    eng = p.engine(net, slots=4, max_len=64,
                   journal=p.generation.SessionJournal(path))
    eng.start()
    with p.faults.injected("preempt:1@step>=3"):
        s = eng.submit([1, 2, 3], request_id="r", **SAMPLER)
        assert s.wait(timeout=30)
    out = [s.finish_reason,
           0 < len(s.tokens) < SAMPLER["max_new_tokens"]]
    try:
        eng.submit([1], max_new_tokens=1)
        out.append("accepted")
    except RuntimeError:
        out.append("RuntimeError")
    eng.journal.close()
    j2 = p.generation.SessionJournal(path)
    out.append([r.request_id for r in j2.interrupted()])
    j2.close()
    out.append("preempt" in [ev["kind"] for ev in p.flight.recorder().tail()])
    return out


def test_unmanaged_preempt_fault_self_preempts_engine(nets, tmp_path):
    jx, pt = (_unmanaged_preempt(p, nets[p.name][0], tmp_path)
              for p in PKGS)
    assert pt == jx == ["preempted", True, "RuntimeError", ["r"], True]


def _managed_preempt(p, net, tmp_path):
    path = str(tmp_path / f"{p.name}-managed.ndjson")
    eng = p.engine(net, slots=4, max_len=64)
    gw = p.gateway(port=0).start()
    gw.register_generator("g", eng, sessions=path)
    mgr = p.lifecycle.LifecycleManager(grace_s=0.0).register_gateway(gw)
    mgr.install(signals=())
    stream = eng.submit([1, 2, 3], request_id="r", max_new_tokens=500 - 3,
                        temperature=0.7, seed=2)
    deadline = time.monotonic() + 10
    while not stream.tokens and time.monotonic() < deadline:
        time.sleep(0.01)
    out = [bool(stream.tokens)]
    mgr.preempt(reason="test", wait=True)
    out += [mgr.errors, stream.finish_reason, gw._draining]
    j2 = p.generation.SessionJournal(path)
    rec = j2.get("r")
    out += [rec.finish_reason, rec.corrupt, rec.tokens == stream.tokens,
            sorted(mgr.describe())]
    j2.close()
    return out


def test_managed_preempt_drains_gateway_and_journals(nets, tmp_path):
    jx, pt = (_managed_preempt(p, nets[p.name][0], tmp_path) for p in PKGS)
    assert pt == jx
    assert pt[:7] == [True, [], "preempted", True, None, False, True]


def _checkpoint_and_idempotence(p):
    saved = []
    mgr = p.lifecycle.LifecycleManager(
        grace_s=5.0, exit_fn=lambda code: saved.append(("exit", code)))
    mgr.register_checkpoint(lambda: saved.append(("ckpt", None)))
    mgr.preempt(reason="test", wait=True)
    mgr2 = p.lifecycle.LifecycleManager(grace_s=5.0)
    mgr2.preempt(reason="first", wait=True)
    mgr2.preempt(reason="second", wait=True)
    return [saved, mgr.errors, mgr2.reason]


def test_emergency_checkpoint_and_idempotent_preempt():
    jx, pt = both(_checkpoint_and_idempotence)
    assert pt == jx == [[("ckpt", None), ("exit", 0)], [], "first"]


def test_unmanaged_delivery_raises_preemption_fault():
    for p in PKGS:
        with pytest.raises(p.faults.PreemptionFault, match="generation"):
            p.lifecycle.deliver_preemption(source="generation", step=3)
        mgr = p.lifecycle.LifecycleManager(grace_s=1.0).install(signals=())
        assert p.lifecycle.manager() is mgr
        assert p.lifecycle.deliver_preemption(source="x") is mgr
        assert mgr.wait(10) and mgr.reason == "injected:x"
        p.lifecycle.reset()
        assert p.lifecycle.manager() is None


# ----------------------------------------------------------- HTTP sessions
def _reconnect(p, net, tmp_path):
    codec = _codec(p)
    eng = p.engine(net, slots=4, max_len=64, codec=codec)
    gw = p.gateway(port=0).start()
    gw.register_generator("charlm", eng,
                          sessions=str(tmp_path / f"{p.name}-s.ndjson"))
    try:
        payload = {"prompt": "abc", "max_new_tokens": 10,
                   "temperature": 0.9, "seed": 5}
        r, lines = _read_stream(gw.port, "charlm", payload)
        ref = [d["token"] for d in lines if not d.get("done")]
        assert lines[-1]["done"] and "request_id" not in lines[-1]
        assert all("seq" not in d for d in lines[:-1])
        conn, r = _stream_req(gw.port, "charlm", payload,
                              headers={"X-Request-Id": "s1"})
        got = []
        for _ in range(4):
            d = json.loads(r.readline())
            assert d["request_id"] == "s1" and d["seq"] == len(got) + 1
            got.append(d["token"])
        conn.close()
        journal = gw._sessions["charlm"]
        deadline = time.monotonic() + 10
        while (journal.get("s1").finish_reason is None
               and time.monotonic() < deadline):
            time.sleep(0.02)
        journaled = journal.get("s1").tokens
        r, lines = _read_stream(gw.port, "charlm", {"last_seq": 4},
                                headers={"X-Request-Id": "s1"})
        tail = [d for d in lines if not d.get("done")]
        assert [d["seq"] for d in tail] == list(range(5, 5 + len(tail)))
        term = lines[-1]
        return [len(ref), journaled == ref, got + [d["token"] for d in tail]
                == ref, term["finish_reason"], term["n_tokens"],
                sorted(term)]
    finally:
        gw.stop(timeout=5)


def test_disconnect_then_reconnect_exactly_once(nets, tmp_path):
    jx, pt = (_reconnect(p, nets[p.name][0], tmp_path) for p in PKGS)
    assert pt == jx == [10, True, True, "length", 10,
                        ["done", "finish_reason", "model", "n_tokens",
                         "request_id", "resumes"]]


def _corrupt_journal(p, net, tmp_path):
    path = str(tmp_path / f"{p.name}-bad.ndjson")
    with open(path, "w") as f:
        f.write('{"e":"open","id":"bad","prompt":[1],"max_new":8,'
                '"temp":0.0,"top_k":0,"top_p":1.0,"seed":0}\n')
        f.write('{"e":"tok","id":"bad","seq":1,"tok')  # torn tail
    eng = p.engine(net, slots=4, max_len=64)
    gw = p.gateway(port=0).start()
    try:
        gw.register_generator("g", eng, sessions=path)
        t0 = time.monotonic()
        conn, r = _stream_req(gw.port, "g", {"last_seq": 0},
                              headers={"X-Request-Id": "bad"}, timeout=10)
        body = json.loads(r.read())
        conn.close()
        return [r.status, "corrupt" in body["error"],
                time.monotonic() - t0 < 5.0]
    finally:
        gw.stop(timeout=5)


def test_corrupt_journal_is_clean_503_never_a_hang(nets, tmp_path):
    jx, pt = (_corrupt_journal(p, nets[p.name][0], tmp_path) for p in PKGS)
    assert pt == jx == [503, True, True]


def _restart_resume_reconnect(p, net, tmp_path):
    codec = _codec(p)
    kw = dict(max_new_tokens=40, temperature=0.9, seed=99)
    ref = p.engine(net, slots=4, max_len=64, codec=codec).generate("abc",
                                                                   **kw)
    path = str(tmp_path / f"{p.name}-restart.ndjson")
    eng = p.engine(net, slots=4, max_len=64, codec=codec)
    gw = p.gateway(port=0).start()
    gw.register_generator("charlm", eng, sessions=path)
    conn, r = _stream_req(gw.port, "charlm", dict(kw, prompt="abc"),
                          headers={"X-Request-Id": "s2"})
    pre = [json.loads(r.readline())["token"] for _ in range(3)]
    mgr = p.lifecycle.LifecycleManager(grace_s=15.0).register_gateway(gw)
    mgr.preempt(reason="test", wait=True)
    conn.close()
    eng2 = p.engine(net, slots=4, max_len=64, codec=codec)
    gw2 = p.gateway(port=0).start()
    try:
        gw2.register_generator("charlm", eng2, sessions=path)
        r, lines = _read_stream(gw2.port, "charlm", {"last_seq": 3},
                                headers={"X-Request-Id": "s2"})
        tail = [d for d in lines if not d.get("done")]
        assert [d["seq"] for d in tail] == list(range(4, 4 + len(tail)))
        return [mgr.errors, lines[-1]["finish_reason"], lines[-1]["resumes"],
                pre + [d["token"] for d in tail] == ref, len(ref)]
    finally:
        gw2.stop(timeout=5)


def test_restart_resume_reconnect_bit_identical(nets, tmp_path):
    jx, pt = (_restart_resume_reconnect(p, nets[p.name][0], tmp_path)
              for p in PKGS)
    assert pt == jx == [[], "length", 0, True, 40]


# ----------------------------------------------------------- failover tier
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breakers(p):
    fo = p.failover
    clk = _Clock()
    b = fo.CircuitBreaker(consecutive_errors=3, cooldown_s=5.0, clock=clk)
    out = [b.record(False), b.record(False), b.record(False), b.allow()]
    clk.t = 6.0
    out += [b.allow(), b.allow(), b.record(True), b.allow(), b.describe()]
    clk = _Clock()
    b = fo.CircuitBreaker(consecutive_errors=1, cooldown_s=1.0, clock=clk)
    out.append(b.record(False))
    clk.t = 2.0
    out += [b.allow(), b.record(False), b.allow()]
    b = fo.CircuitBreaker(consecutive_errors=100, error_rate=0.5, window=4)
    out.append([b.record(ok) for ok in (True, False, True, False)])
    clk = _Clock()
    c = fo.IdempotencyCache(ttl_s=10.0, capacity=2, clock=clk)
    c.put("k", {"v": 1})
    out.append(c.get("k"))
    clk.t = 11.0
    out += [c.get("k"), c.replays]
    return out


def test_circuit_breakers_and_idempotency_cache():
    jx, pt = both(_breakers)
    assert pt == jx
    assert pt[:8] == [None, None, "opened", False, True, False, "closed",
                      True]
    assert pt[9:13] == ["opened", True, "opened", False]
    assert pt[13][-1] == "opened" and pt[14:] == [{"v": 1}, None, 1]


class _StubModel:
    def __init__(self, scale=1.0):
        self.scale = scale

    def output(self, x):
        return np.asarray(x) * self.scale


def _gw2v(p):
    gw = p.gateway(port=0, seed=0,
                   failover=dict(consecutive_errors=2, cooldown_s=30.0,
                                 retries=1,
                                 retry_base_delay_s=0.0)).start()
    gw.register_model("m", "v1", _StubModel(1.0), warmup_shape=(4,))
    gw.register_model("m", "v2", _StubModel(2.0), warmup_shape=(4,))
    gw.set_split("m", {"v1": 0.5, "v2": 0.5})
    return gw, f"http://127.0.0.1:{gw.port}"


X4 = [[1.0, 2.0, 3.0, 4.0]]


def _fails_over(p, monkeypatch):
    gw, base = _gw2v(p)
    with monkeypatch.context() as monkeypatch:
        p.monitoring.enable()
        adm = p.admission.AdmissionController
        orig = adm.gather

        def gather(self, mv, queues, deadline, klass=None, trace=None):
            if mv.version == "v1":
                raise p.http.HttpError(500, "injected replica failure")
            return orig(self, mv, queues, deadline, klass=klass, trace=trace)

        monkeypatch.setattr(adm, "gather", gather)
        out = [post(base, "/v1/m/predict", {"inputs": X4})[:2]
               for _ in range(8)]
        st = json.loads(urllib_get(base, "/failover"))
        mt = p.monitoring.metrics_text()
        return [[(c, b["version"], b["outputs"]) for c, b in out],
                st["enabled"], st["breakers"]["m/v1"]["state"],
                sorted(st), sorted(st["breakers"]["m/v1"]),
                'dl4j_recovery_total{component="gateway",'
                'outcome="breaker_opened"}' in mt,
                'dl4j_retry_attempts_total{component="gateway"}' in mt]
    gw.stop(timeout=5)


def urllib_get(base, path):
    import urllib.request

    return urllib.request.urlopen(base + path, timeout=10).read()


def test_failed_replica_fails_over_to_sibling(monkeypatch):
    jx, pt = both(_fails_over, monkeypatch)
    assert pt == jx
    assert pt[0] == [(200, "v2", [[2.0, 4.0, 6.0, 8.0]])] * 8
    assert pt[1:3] == [True, "open"] and pt[5:] == [True, True]


def _idempotent_replay(p, monkeypatch):
    gw, base = _gw2v(p)
    with monkeypatch.context() as monkeypatch:
        calls = []
        adm = p.admission.AdmissionController
        orig = adm.gather

        def gather(self, mv, queues, deadline, klass=None, trace=None):
            calls.append(mv.version)
            return orig(self, mv, queues, deadline, klass=klass, trace=trace)

        monkeypatch.setattr(adm, "gather", gather)
        hdr = {"Idempotency-Key": "idem-1"}
        c1, b1, _ = post(base, "/v1/m/predict", {"inputs": X4}, headers=hdr)
        n = len(calls)
        c2, b2, _ = post(base, "/v1/m/predict", {"inputs": X4}, headers=hdr)
        return [c1, c2, b1 == b2, len(calls) == n,
                gw.failover.idempotency.replays]
    gw.stop(timeout=5)


def test_idempotency_key_replays_cached_response(monkeypatch):
    jx, pt = both(_idempotent_replay, monkeypatch)
    assert pt == jx == [200, 200, True, True, 1]


def _unconfigured_failover(p):
    gw = p.gateway(port=0).start()
    try:
        gw.register_model("m", "v1", _StubModel(1.0), warmup_shape=(4,))
        code = post(f"http://127.0.0.1:{gw.port}", "/v1/m/predict",
                    {"inputs": X4})[0]
        return [code, json.loads(urllib_get(f"http://127.0.0.1:{gw.port}",
                                            "/failover"))]
    finally:
        gw.stop(timeout=5)


def test_unconfigured_gateway_predict_path_unchanged():
    jx, pt = both(_unconfigured_failover)
    assert pt == jx == [200, {"enabled": False}]


# ------------------------------------------------------------ zero overhead
def test_unconfigured_engine_makes_zero_journal_calls(nets, monkeypatch):
    calls = []
    journal = PORT.generation.SessionJournal
    for meth in ("attach", "emitted", "finished"):
        monkeypatch.setattr(journal, meth,
                            lambda self, *a, _m=meth, **k: calls.append(_m))
    PORT.engine(nets["torch"][0], slots=2, max_len=64).generate(
        [1, 2], max_new_tokens=4)
    assert calls == []


def test_unconfigured_gateway_makes_zero_failover_calls(monkeypatch):
    fo = PORT.failover
    calls = []
    monkeypatch.setattr(fo.CircuitBreaker, "allow",
                        lambda self: calls.append("allow") or True)
    monkeypatch.setattr(fo.CircuitBreaker, "record",
                        lambda self, ok: calls.append("record") and None)
    monkeypatch.setattr(fo.IdempotencyCache, "get",
                        lambda self, k: calls.append("idem") and None)
    gw = PORT.gateway(port=0).start()
    try:
        gw.register_model("m", "v1", _StubModel(1.0), warmup_shape=(4,))
        code, _, _ = post(f"http://127.0.0.1:{gw.port}", "/v1/m/predict",
                          {"inputs": [[1.0, 2.0]]},
                          headers={"Idempotency-Key": "spy"})
        assert code == 200
    finally:
        gw.stop(timeout=5)
    assert calls == []


def test_untracked_generate_makes_zero_session_calls(nets, monkeypatch):
    gw = PORT.gateway(port=0).start()
    eng = PORT.engine(nets["torch"][0], slots=2, max_len=64,
                      codec=_codec(PORT))
    try:
        gw.register_generator("g", eng)
        assert gw._sessions == {} and eng.journal is None
        calls = []
        monkeypatch.setattr(PORT.generation.SessionJournal, "attach",
                            lambda self, *a, **k: calls.append("attach"))
        r, lines = _read_stream(gw.port, "g",
                                {"prompt": "ab", "max_new_tokens": 3})
        assert r.status == 200 and lines[-1]["done"]
        assert calls == []
    finally:
        gw.stop(timeout=5)


# ----------------------------------------------------- streaming generate
def _streaming(p, net):
    p.metrics_on()
    codec = _codec(p)
    eng = p.engine(net, slots=4, max_len=64, codec=codec)
    gw = p.gateway(port=0).start()
    gw.register_generator("charlm", eng)
    base = f"http://127.0.0.1:{gw.port}"
    try:
        r, lines = _read_stream(gw.port, "charlm",
                                {"prompt": "abc", "max_new_tokens": 5,
                                 "seed": 3})
        toks = [d["token"] for d in lines[:-1]]
        out = [r.status, r.getheader("Content-Type"), lines[-1]["done"],
               lines[-1]["finish_reason"], lines[-1]["n_tokens"], len(toks),
               toks == eng.generate("abc", max_new_tokens=5, seed=3),
               "".join(d["text"] for d in lines[:-1]) == codec.decode(toks),
               "dl4j_generate_requests_total" in p.monitoring.metrics_text()]
        code, body, _ = post(base, "/v1/charlm/generate",
                             {"prompt": "ab", "stream": False,
                              "max_new_tokens": 4})
        out += [code, sorted(body), len(body["tokens"]),
                body["finish_reason"], len(body["text"])]
        out.append(post(base, "/v1/nope/generate", {"prompt_ids": [1]})[0])
        code, body, _ = post(base, "/v1/charlm/generate", {})
        out += [code, "prompt" in body["error"]]
        return out, toks
    finally:
        gw.stop(timeout=5)


def test_streaming_round_trip_one_shot_and_errors(nets):
    (jx, jtoks), (pt, ptoks) = (_streaming(p, nets[p.name][0]) for p in PKGS)
    assert pt == jx
    assert pt[:9] == [200, "application/x-ndjson", True, "length", 5, 5,
                      True, True, True]
    assert pt[9:] == [200, ["finish_reason", "model", "n_tokens", "text",
                            "tokens"], 4, "length", 4, 404, 400, True]
    assert ptoks == jtoks     # greedy: the same tokens in both packages


def _backlog_shed(p, net):
    p.metrics_on()
    eng = p.engine(net, slots=1, max_len=64)
    gw = p.gateway(port=0, generate_max_queue=1).start()
    gw._generators["g"] = eng   # not started: the backlog stays queued
    try:
        eng.submit([1], max_new_tokens=4)
        code, _, headers = post(f"http://127.0.0.1:{gw.port}",
                                "/v1/g/generate", {"prompt_ids": [1]})
        return [code, "Retry-After" in headers,
                'outcome="shed"' in p.monitoring.metrics_text()]
    finally:
        del gw._generators["g"]
        gw.stop(timeout=2)
        eng.shutdown(timeout=0)


def test_backlog_sheds_429_with_retry_after(nets):
    jx, pt = (_backlog_shed(p, nets[p.name][0]) for p in PKGS)
    assert pt == jx == [429, True, True]


def _drain_streams(p, net):
    eng = p.engine(net, slots=4, max_len=64, codec=_codec(p))
    gw = p.gateway(port=0).start()
    gw.register_generator("charlm", eng)
    conn, r = _stream_req(gw.port, "charlm",
                          {"prompt": "a", "max_new_tokens": 3000})
    json.loads(r.readline())
    import threading

    stopper = threading.Thread(target=lambda: gw.stop(timeout=10))
    stopper.start()
    time.sleep(0.05)
    late = post(f"http://127.0.0.1:{gw.port}", "/v1/charlm/generate",
                {"prompt": "b", "max_new_tokens": 1})[0]
    lines = [json.loads(x) for x in r if x.strip()]
    stopper.join()
    conn.close()
    return [bool(lines) and lines[-1].get("done"),
            lines[-1]["finish_reason"] in ("length", "cancelled"), late]


def test_drain_finishes_streams_and_rejects_new(nets):
    jx, pt = (_drain_streams(p, nets[p.name][0]) for p in PKGS)
    assert pt == jx == [True, True, 503]


# ------------------------------------------------------- priority classes
def _priority_lanes(p, net):
    eng = p.engine(net, slots=1, max_len=32)
    a = eng.submit([1], max_new_tokens=2)
    b = eng.submit([2], max_new_tokens=2, klass="batch")
    c = eng.submit([3], max_new_tokens=2)
    eng.drain()
    out = [[s.finish_reason for s in (a, b, c)],
           a.finished_at < c.finished_at < b.finished_at,
           eng.pending_count(), eng.pool.occupancy()]
    eng = p.engine(net, slots=1, max_len=32)
    running = eng.submit([1], max_new_tokens=10 ** 6)
    queued = eng.submit([2], max_new_tokens=4, klass="batch")
    out.append(eng.pending_count())
    eng.step()
    out.append(eng.pending_count())
    eng.shutdown(timeout=0.0)
    out += [running.finish_reason, queued.finish_reason,
            eng.pool.occupancy()]
    return out


def test_priority_lanes(nets):
    jx, pt = (_priority_lanes(p, nets[p.name][0]) for p in PKGS)
    assert pt == jx == [["length"] * 3, True, 0, 0, 2, 1, "cancelled",
                        "cancelled", 0]


def _mixed_priority_stream_drain(p, net):
    import threading

    eng = p.engine(net, slots=1, max_len=64)
    gw = p.gateway(
        port=0, tenants=[{"key": "ki", "name": "int", "klass": "interactive"},
                         {"key": "kb", "name": "bat",
                          "klass": "batch"}]).start()
    gw.register_generator("g", eng)
    conn, r = _stream_req(gw.port, "g", {"prompt_ids": [1],
                                         "max_new_tokens": 2000,
                                         "api_key": "ki"})
    out = [r.status]
    json.loads(r.readline())
    qb = eng.submit([2], max_new_tokens=4, klass="batch")
    stopper = threading.Thread(target=lambda: gw.stop(timeout=10))
    stopper.start()
    time.sleep(0.05)
    late = post(f"http://127.0.0.1:{gw.port}", "/v1/g/generate",
                {"prompt_ids": [3], "max_new_tokens": 1, "api_key": "kb"})[0]
    lines = [json.loads(x) for x in r if x.strip()]
    stopper.join()
    conn.close()
    return out + [lines[-1].get("done"),
                  lines[-1]["finish_reason"] in ("length", "cancelled"),
                  late, qb.finish_reason is not None, eng.pool.occupancy(),
                  eng.pending_count()]


def test_drain_streams_finish_batch_rejected(nets):
    jx, pt = (_mixed_priority_stream_drain(p, nets[p.name][0])
              for p in PKGS)
    assert pt == jx == [200, True, True, 503, True, 0, 0]


# ------------------------------------------- greedy streams, both packages
def _greedy_streams(p, net, prompts, max_len):
    eng = p.engine(net, slots=4, max_len=max_len)
    gw = p.gateway(port=0).start()
    gw.register_generator("g", eng)
    try:
        out = []
        for ids, n in prompts:
            r, lines = _read_stream(gw.port, "g", {"prompt_ids": ids,
                                                   "max_new_tokens": n})
            assert r.status == 200 and lines[-1]["done"]
            out.append(([d["token"] for d in lines[:-1]],
                        lines[-1]["finish_reason"]))
        return out
    finally:
        gw.stop(timeout=5)


@pytest.mark.parametrize("which", [0, 1], ids=["lstm", "causal_lm"])
def test_greedy_ndjson_streams_equal_across_packages(nets, which):
    rng = np.random.default_rng(3 + which)
    prompts = [(rng.integers(0, V, int(n)).tolist(), 12)
               for n in rng.integers(1, 10, 4)]
    jx, pt = (_greedy_streams(p, nets[p.name][which], prompts, 32)
              for p in PKGS)
    assert pt == jx
    assert all(len(t) == 12 and f == "length" for t, f in pt)
