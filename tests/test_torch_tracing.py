"""The port's tracing, request traces and flight recorder against the JAX
package, and the recovery paths' counters.

Under a patched clock, ``SpanTracer`` gives the JAX package's Chrome JSON
event for event (ring eviction and the dropped counter included), and
``RequestTrace`` the same summaries and ``to_chrome`` documents; the
flight recorder keeps the same ring and writes the same dump bundles. A
traced generate on the CPU engine records the JAX engine's spans and
events with the same tokens; ``GenerationStream.follow`` serves
reconnecting consumers; the ``dl4j_generate_*`` families count the
streams. Faults, retries, checkpoint restores and session resumes land in
``dl4j_recovery_total`` and the flight recorder.
"""

import itertools
import json
import os
import threading

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import faults as jax_faults
from deeplearning4j_tpu import monitoring as jax_monitoring
from deeplearning4j_tpu.common.env import env as jax_env
from deeplearning4j_tpu.faults import RetryPolicy as JaxRetryPolicy
from deeplearning4j_tpu.generation import GenerationEngine as JaxEngine
from deeplearning4j_tpu.monitoring import context as jax_context
from deeplearning4j_tpu.monitoring.flight import (
    FlightRecorder as JaxFlightRecorder,
)
from deeplearning4j_tpu.monitoring.tracing import SpanTracer as JaxSpanTracer
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTMLayer as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch import faults, monitoring
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.faults import RetryPolicy
from deeplearning4j_tpu_torch.generation import (
    GenerationEngine, SessionJournal,
)
from deeplearning4j_tpu_torch.monitoring import context, flight
from deeplearning4j_tpu_torch.monitoring.context import (
    RequestTrace, RequestTracer, bind, current_trace_id,
)
from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder
from deeplearning4j_tpu_torch.monitoring.tracing import (
    SpanTracer, validate_nesting,
)
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)
from deeplearning4j_tpu_torch.optimize.async_dispatch import (
    AsyncScoreWindow, AsyncStepError,
)
from deeplearning4j_tpu_torch.util.checkpoints import TrainingCheckpointer

V = 11
_VARS = ("DL4J_TORCH_MONITORING", "DL4J_TORCH_TRACING", "DL4J_TORCH_FLIGHT",
         "DL4J_TORCH_FLIGHT_DIR", "DL4J_TORCH_FLIGHT_CAP",
         "DL4J_TORCH_TRACE_MAX_EVENTS", "DL4J_TPU_MONITORING")


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Fresh registries, recorders and fault plans in both packages; the
    env variables cleared BEFORE the teardown reloads ``env``."""
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    env.reload()
    jax_env.reload()
    for m, f in ((monitoring, faults), (jax_monitoring, jax_faults)):
        m.reset()
        f.configure("")
    yield
    for var in _VARS:
        os.environ.pop(var, None)
    env.reload()
    jax_env.reload()
    for m, f in ((monitoring, faults), (jax_monitoring, jax_faults)):
        f.configure("")
        m.reset()


class _Clock:
    """A fake clock: each read advances it by ``step`` seconds."""

    def __init__(self, start=100.0, step=0.001):
        self._it = itertools.count()
        self.start, self.step = start, step

    def __call__(self):
        return self.start + self.step * next(self._it)


def _with_clock(monkeypatch, fn):
    """``fn()`` with fresh fake ``perf_counter``, ``monotonic`` and
    ``time`` clocks (the same readings in every call)."""
    monkeypatch.setattr("time.perf_counter", _Clock(5.0))
    monkeypatch.setattr("time.monotonic", _Clock(50.0, 0.002))
    monkeypatch.setattr("time.time", _Clock(1.7e9, 0.5))
    return fn()


# -------------------------------------------------------------- span tracer
def _span_sequence(cls, cap):
    tr = cls(process_name="proc", max_events=cap)
    with tr.span("fit.iteration", step=3, obj=object):
        with tr.span("fit.device_step"):
            tr.instant("mark", n=1)
        tr.complete("queue_wait", 0.25, trace_id="abc")

    def worker():
        with tr.span("serve"):
            pass

    th = threading.Thread(target=worker, name="worker-0")
    th.start()
    th.join()
    for i in range(cap):
        tr.instant(f"e{i}")
    return tr


@pytest.mark.parametrize("cap", [4, 1000])
def test_span_tracer_matches_jax(monkeypatch, tmp_path, cap):
    """The same events (ring eviction included, the thread named on first
    sight), the same drop count and dropped-events counter, and a file
    that loads as the same JSON."""
    monitoring.enable()
    jax_monitoring.enable()
    docs = []
    for cls, m in ((SpanTracer, monitoring), (JaxSpanTracer, jax_monitoring)):
        tr = _with_clock(monkeypatch, lambda cls=cls: _span_sequence(cls, cap))
        path = str(tmp_path / f"{cls.__module__}.json")
        tr.save(path)
        fam = m.registry().get("dl4j_trace_events_dropped_total")
        docs.append((json.load(open(path)), tr.dropped,
                     None if fam is None else fam.value))
    ref = docs[1]
    for e in ref[0]["traceEvents"] + docs[0][0]["traceEvents"]:
        e.pop("tid", None)  # the two worker threads have their own ids
    assert docs[0] == ref
    if cap == 4:
        assert ref[1] > 0 and ref[2] == ref[1]
    else:
        validate_nesting(_span_sequence(SpanTracer, cap).events())


def test_span_tracer_ring_cap_from_env(monkeypatch):
    monkeypatch.setattr(env, "trace_max_events", 16)
    assert SpanTracer()._cap == 16
    tr = SpanTracer(max_events=3)
    with tr.span("a"):
        pass
    for _ in range(10):
        tr.instant("x")
    assert len(tr._events) == 3 and tr.dropped == 9
    assert {e["name"] for e in tr.events() if e["ph"] == "M"} == {
        "process_name", "thread_name"}
    with pytest.raises(ValueError):
        validate_nesting([{"ph": "B", "name": "a", "tid": 1},
                          {"ph": "E", "name": "b", "tid": 1}])


# ---------------------------------------------------------- request traces
def _request_sequence(trace_cls, tracer_cls, bind_fn):
    tr = trace_cls("tid1", "rid1", "/v1/*/generate", model="m", none=None)
    with tr.span("quota_check"):
        pass
    tr.add_span("queue_wait", 50.0, 50.01, slot=2)
    tr.event("admit", slot=2)
    with tr.span("prefill", prompt_len=3):
        tr.event("retire", reason="eos")
    tr.finish("served", code=200, reason="eos")
    rt = tracer_cls(capacity=2)
    begun = [rt.begin("/r", headers={"X-Trace-Id": h}) for h in
             ("client-id_9.a", "evil\nid", "x" * 65, "ok2", "ok3")]
    for t in begun[:4]:
        rt.finish(t, "served", code=200)
    out = {"summary": tr.summary(), "chrome": tr.to_chrome(),
           "ids": [t.trace_id for t in begun],
           "completed": [t.trace_id for t in rt.completed()],
           "inflight": [t.trace_id for t in rt.inflight()],
           "evicted": rt.get("client-id_9.a") is None}
    with bind_fn(tr):
        out["bound"] = tr.trace_id
    return out


def test_request_trace_matches_jax(monkeypatch):
    """Summaries and ``to_chrome`` documents equal to the JAX package's
    under a patched clock, the same header adoption (safe ids kept,
    hostile ones replaced by minted 16-hex ids) and completed ring."""
    ids = itertools.count()
    monkeypatch.setattr(context, "_mint_id", lambda: f"{next(ids):016x}")
    port = _with_clock(monkeypatch, lambda: _request_sequence(
        RequestTrace, RequestTracer, bind))
    ids = itertools.count()
    monkeypatch.setattr(jax_context, "_mint_id", lambda: f"{next(ids):016x}")
    ref = _with_clock(monkeypatch, lambda: _request_sequence(
        jax_context.RequestTrace, jax_context.RequestTracer,
        jax_context.bind))
    assert port == ref
    assert port["ids"][0] == "client-id_9.a" and port["evicted"]
    assert port["summary"]["stages"]["queue_wait"]["count"] == 1


def test_async_step_error_names_the_ambient_trace():
    class _Model:
        step_count, epoch_count, listeners = 3, 1, ()

    win = AsyncScoreWindow(_Model(), max_in_flight=4)
    with bind(RequestTrace("tidw", "ridw", "/train")):
        assert current_trace_id() == "tidw"
        h = win.submit("not-a-number")
    assert current_trace_id() is None
    with pytest.raises(AsyncStepError) as e:
        win.drain()
    assert h.trace_id == "tidw" == e.value.trace_id
    assert "[trace tidw]" in str(e.value)


# ---------------------------------------------------------- flight recorder
def _flight_sequence(cls, d, m):
    rec = cls(capacity=4, dump_dir=str(d), min_dump_interval_s=3600.0)
    tr = m.context.RequestTrace("tdump", "r1", "/r")
    for i in range(6):
        rec.record("admit", route="/r", n=i, skip=None)
    rec.record("worker_crash", severity="error", trace=tr, worker="w0")
    rec.record("numeric_trip", severity="error")  # rate-limited
    forced = rec.dump("manual", force=True, path=str(d / "forced.json"))
    bundles = [json.load(open(p)) for p in rec.dumps]
    return {"tail": rec.tail(), "describe": {
        k: v for k, v in rec.describe(tail=3).items()
        if k not in ("dump_dir", "dumps")},
        "dumps": [os.path.basename(p) for p in rec.dumps],
        "forced": os.path.basename(forced), "bundles": bundles}


def test_flight_recorder_matches_jax(monkeypatch, tmp_path):
    out = []
    for cls, m, name in ((FlightRecorder, monitoring, "port"),
                         (JaxFlightRecorder, jax_monitoring, "jax")):
        d = tmp_path / name
        out.append(_with_clock(monkeypatch, lambda cls=cls, m=m, d=d:
                               _flight_sequence(cls, d, m)))
    port, ref = out
    for o in out:
        for b in o["bundles"]:
            for e in b.get("trace", {}).get("chrome", {}).get(
                    "traceEvents", []):
                e.pop("tid", None)
    assert port == ref
    assert port["dumps"] == ["flight_0001_worker_crash.json", "forced.json"]
    assert port["describe"]["dropped"] == 4


def test_flight_env_arming(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TORCH_FLIGHT", "1")
    monkeypatch.setenv("DL4J_TORCH_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TORCH_FLIGHT_CAP", "9")
    rec = flight.reset()
    assert rec is flight.recorder() and rec.capacity == 9
    assert rec.dump_dir == str(tmp_path)
    for var in ("DL4J_TORCH_FLIGHT", "DL4J_TORCH_FLIGHT_DIR",
                "DL4J_TORCH_FLIGHT_CAP"):
        monkeypatch.delenv(var)
    assert flight.reset() is None and flight.recorder() is None


# ----------------------------------------------------------- the engine
def _nets():
    conf = (JaxNNC.builder().seed(7).list().layer(JaxLSTM(n_out=12))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V, 8)).build())
    jnet = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, net


PROMPTS = ([1, 2, 3], [4], [5, 6, 7, 8, 9], [2, 2])


def test_traced_generate_matches_the_jax_engine():
    """One RequestTrace per request on both engines (greedy): the same
    tokens, the same spans (queue_wait, prefill, decode, one each) and
    events (admit, retire), mirrored into the process span tracer; the
    dl4j_generate_* families count the streams."""
    monitoring.enable()
    jax_monitoring.enable()
    runs = []
    for which, eng_cls, m in (("port", GenerationEngine, monitoring),
                              ("jax", JaxEngine, jax_monitoring)):
        jnet, net = _nets()
        kw = dict(device="cpu") if which == "port" else {}
        eng = eng_cls(net if which == "port" else jnet, slots=2, max_len=32,
                      **kw)
        tracer = m.start_tracing()
        rt = m.context.RequestTracer()
        traces = [rt.begin("generate") for _ in PROMPTS]
        streams = [eng.submit(p, max_new_tokens=4 + i, trace=t)
                   for i, (p, t) in enumerate(zip(PROMPTS, traces))]
        eng.drain()
        for t, s in zip(traces, streams):
            rt.finish(t, "served", reason=s.finish_reason)
        m.stop_tracing()
        runs.append(dict(
            tokens=[s.tokens for s in streams],
            stages=[{k: v["count"] for k, v in t.summary()["stages"].items()}
                    for t in traces],
            events=[t.summary()["events"] for t in traces],
            mirrored=sorted({(e["ph"], e["name"]) for e in tracer.events()
                             if e["ph"] in ("X", "i")}),
            ids={t.trace_id for t in traces}, reg=m.registry()))
    port, ref = runs
    for k in ("tokens", "stages", "events", "mirrored"):
        assert port[k] == ref[k], k
    assert port["stages"][0] == {"queue_wait": 1, "prefill": 1, "decode": 1}
    assert port["events"][0] == ["admit", "retire"]
    reg = port["reg"]
    n_tokens = sum(len(t) for t in port["tokens"])
    assert reg.get("dl4j_generate_tokens_total").value == n_tokens
    assert sum(c.value for _, c in reg.get(
        "dl4j_generate_requests_total").children()) == len(PROMPTS)
    ttft = reg.get("dl4j_generate_ttft_seconds")
    assert ttft.count == len(PROMPTS)
    exemplar_ids = {e[0]["trace_id"]
                    for e in ttft._only().exemplars().values()}
    assert exemplar_ids and exemplar_ids <= port["ids"]
    for name in ("dl4j_generate_decode_steps_total",
                 "dl4j_generate_tokens_total"):
        assert reg.get(name).value == ref["reg"].get(name).value
    assert reg.get("dl4j_generate_prefill_seconds").count == len(PROMPTS)


def test_engine_tracer_from_env(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_TRACING", "1")
    env.reload()
    _, net = _nets()
    eng = GenerationEngine(net, slots=2, max_len=32, device="cpu")
    assert isinstance(eng.tracer, RequestTracer)
    streams = [eng.submit(p, max_new_tokens=3) for p in PROMPTS]
    eng.drain()
    done = eng.tracer.completed()
    assert {t.trace_id for t in done} == {s.trace.trace_id for s in streams}
    assert len(done) == len(PROMPTS) and not eng.tracer.inflight()
    assert all(t.disposition == "served" and t.reason == "length"
               for t in done)


def test_follow_serves_reconnecting_consumers():
    """Any number of consumers follow one stream, each from its own
    last_seq, and each sees every later token once, in order."""
    _, net = _nets()
    eng = GenerationEngine(net, slots=2, max_len=64, device="cpu").start()
    try:
        stream = eng.submit([1, 2, 3], max_new_tokens=24)
        got = {}

        def consume(name, last_seq, stop_after=None):
            out = []
            for seq, tok in stream.follow(last_seq):
                out.append((seq, tok))
                if stop_after is not None and len(out) == stop_after:
                    break  # the client drops; it reconnects below
            got[name] = out

        threads = [threading.Thread(target=consume, args=a) for a in
                   (("all", 0), ("late", 10), ("dropped", 0, 5))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        consume("reconnected", got["dropped"][-1][0])
        assert stream.wait(60)
    finally:
        eng.shutdown()
    want = list(enumerate(stream.tokens, start=1))
    assert len(want) == 24
    assert got["all"] == want and got["late"] == want[10:]
    assert got["dropped"] + got["reconnected"] == want


# ------------------------------------------------------------- recovery
def _recovery_sequence(f_mod, retry_cls):
    plan = f_mod.configure("ckpt_io:2;data_io:1@step>=2")
    for step in range(4):
        plan.fires("ckpt_io", step=step)
        plan.fires("data_io", step=step, name="mnist")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    policy = retry_cls(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0,
                       deadline_s=60.0)
    assert policy.call(flaky, component="checkpoint") == "ok"
    with pytest.raises(OSError):
        policy.call(lambda: (_ for _ in ()).throw(OSError("down")),
                    component="dataset")
    f_mod.configure("")


def test_fault_and_retry_counters_match_jax(monkeypatch):
    """The same faults injected and retries made give the same recovery
    families and the same fault_injected flight events."""
    out = []
    for m, f, r in ((monitoring, faults, RetryPolicy),
                    (jax_monitoring, jax_faults, JaxRetryPolicy)):
        m.enable()
        rec = m.flight.configure(enabled=True)
        _with_clock(monkeypatch, lambda f=f, r=r: _recovery_sequence(f, r))
        out.append((m.metrics_text(), [
            {k: v for k, v in e.items() if k != "t"} for e in rec.tail()]))
    assert out[0] == out[1]
    text = out[0][0]
    assert 'dl4j_faults_injected_total{cls="ckpt_io"} 2' in text
    assert ('dl4j_recovery_total{component="checkpoint",outcome='
            '"retried_ok"} 1') in text
    assert ('dl4j_recovery_total{component="dataset",outcome="gave_up"} 1'
            in text)
    assert 'dl4j_retry_attempts_total{component="dataset"} 3' in text
    assert [e["kind"] for e in out[0][1]] == ["fault_injected"] * 3


def test_checkpoint_restore_fallback_counters(tmp_path):
    monitoring.enable()
    _, net = _nets()
    ckpt = TrainingCheckpointer(str(tmp_path), keep_last=3, async_save=False)
    ckpt.save(1, net)
    ckpt.save(2, net)
    ckpt._corrupt_step(2)
    with pytest.warns(UserWarning):
        assert ckpt.restore_latest(net) == 1
    ckpt._corrupt_step(1)
    with pytest.warns(UserWarning):
        assert ckpt.restore_latest(net) is None
    ckpt.close()
    rec = monitoring.registry().get("dl4j_recovery_total")
    assert rec.labels(component="checkpoint", outcome="fallback").value == 1
    assert rec.labels(component="checkpoint",
                      outcome="no_valid_checkpoint").value == 1


def test_session_resume_counters_and_flight_event(tmp_path):
    monitoring.enable()
    rec = monitoring.flight.configure(enabled=True)
    _, net = _nets()
    path = str(tmp_path / "journal.ndjson")
    eng = GenerationEngine(net, slots=2, max_len=32, device="cpu",
                           journal=SessionJournal(path))
    for i, p in enumerate(PROMPTS[:2]):
        eng.submit(p, max_new_tokens=8, request_id=f"r{i}")
    for _ in range(3):
        eng.step()
    eng.shutdown(timeout=0.0, reason="preempted")
    eng.journal.close()
    journal = SessionJournal(path)
    eng2 = GenerationEngine(net, slots=2, max_len=32, device="cpu",
                            journal=journal)
    assert journal.resume_into(eng2) == {"resumed": 2, "lost": 0,
                                         "completed": 0}
    eng2.drain()
    fam = monitoring.registry().get("dl4j_recovery_total")
    assert fam.labels(component="generation",
                      outcome="session_resumed").value == 2
    (ev,) = [e for e in rec.tail() if e["kind"] == "session_resume"]
    assert ev["resumed"] == 2 and ev["path"] == path
