"""The port's monitoring layer against the JAX package.

The same sequence of counter, gauge and histogram calls (labels with
escapes, exemplars, help texts with newlines) gives the same
``metrics_text``, byte for byte; every instrument bundle registers the
same families (name, help, type, labels, buckets) as the JAX package's.
The fit loop's phases count as the JAX package's do, sync and async, on
both network classes; ``MetricsListener`` samples the system metrics on
the CPU; checkpoint saves, the import optimizer's rewrites, the kernel
builds and the warm-up land in their families. With monitoring, tracing
and guardrails off, ``fit_batch``, ``fit``, the async drain and
``GenerationEngine.step`` make no registry, tracer or guard call.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import monitoring as jax_monitoring
from deeplearning4j_tpu.common.env import env as jax_env
from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JaxArrayIter
from deeplearning4j_tpu.modelimport.onnx import OnnxModelImport as JaxOnnx
from deeplearning4j_tpu.nn import (
    InputType as JaxInputType, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JaxDense, OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optimize import Sgd as JaxSgd
from deeplearning4j_tpu_torch import guardrails, monitoring
from deeplearning4j_tpu_torch.common import sysmetrics
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.guardrails import sentinel
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxModelImport
from deeplearning4j_tpu_torch.monitoring import (
    Counter, Gauge, Histogram, MetricFamily, MetricsListener,
    MetricsRegistry, RequestTrace, SpanTracer, validate_nesting,
)
from deeplearning4j_tpu_torch.monitoring import compile as compile_metrics
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.ops.cuda import build
from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
from deeplearning4j_tpu_torch.serving.warmup import warmup_model
from deeplearning4j_tpu_torch.util.checkpoints import TrainingCheckpointer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
_VARS = ("DL4J_TORCH_ASYNC_STEPS", "DL4J_TORCH_MONITORING",
         "DL4J_TORCH_GUARDRAILS", "DL4J_TORCH_TRACING",
         "DL4J_TPU_ASYNC_STEPS", "DL4J_TPU_MONITORING")


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Fresh registries in both packages, the env variables cleared BEFORE
    the teardown reloads ``env`` (so no test's arming leaks into the next
    file on the worker)."""
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    env.reload()
    jax_env.reload()
    monitoring.reset()
    jax_monitoring.reset()
    yield
    for var in _VARS:
        os.environ.pop(var, None)
    env.reload()
    jax_env.reload()
    monitoring.reset()
    jax_monitoring.reset()


def _async(monkeypatch, steps):
    monkeypatch.setenv("DL4J_TORCH_ASYNC_STEPS", str(steps))
    monkeypatch.setenv("DL4J_TPU_ASYNC_STEPS", str(steps))
    env.reload()
    jax_env.reload()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(graph=False):
    """A JAX network and the port's, with the JAX weights."""
    b = JaxNNC.builder().seed(5).updater(JaxSgd(lr=0.1))
    if graph:
        conf = (b.graph_builder().add_inputs("in")
                .set_input_types(**{"in": JaxInputType.feed_forward(4)})
                .add_layer("d", JaxDense(n_out=8, activation="relu"), "in")
                .add_layer("o", JaxOutput(n_out=3, activation="softmax",
                                          loss="mcxent"), "d")
                .set_outputs("o").build())
        jn = JaxGraph(conf).init()
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            conf.to_json())).init(device="cpu")
    else:
        conf = (b.list().layer(JaxDense(n_out=8, activation="relu"))
                .layer(JaxOutput(n_out=3, activation="softmax",
                                 loss="mcxent"))
                .set_input_type(JaxInputType.feed_forward(4)).build())
        jn = JaxNet(conf).init()
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json())).init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    return jn, load_jax_opt_state(net, _np(jn.opt_state))


def _data(n=16, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


# ------------------------------------------------------------- exposition
def _drive(reg):
    """One scripted sequence of instrument calls."""
    c = reg.counter("req_total", 'requests "served"\nby route',
                    labels=("route", "code"))
    c.labels(route="/predict", code=200).inc(3)
    c.labels(route='/we"ird\\path\n', code=500).inc()
    reg.counter("plain_total").inc(2.5)
    g = reg.gauge("queue_depth", "pending")
    g.set(7)
    g.inc(0.25)
    g.dec(2)
    reg.gauge("big", "large values").set(3e20)
    reg.gauge("tiny", "").set(1.5e-7)
    h = reg.histogram("lat_seconds", "latency", labels=("model",))
    for v, ex in ((0.0004, None), (0.003, {"trace_id": "ab12"}),
                  (0.2, None), (7.5, {"trace_id": 'q"x'}), (99.0, None)):
        h.labels(model="m1").observe(v, exemplar=ex)
    sz = reg.histogram("batch", "sizes", buckets=(1, 2, 4, 8))
    for v in (1, 3, 3, 8, 9):
        sz.observe(v)
    reg.histogram("never", "an unobserved histogram")
    return reg


@pytest.mark.parametrize("exemplars", [False, True])
def test_exposition_is_the_jax_packages_byte_for_byte(monkeypatch,
                                                      exemplars):
    monkeypatch.setattr("time.time", lambda: 1712345678.25)
    port = _drive(MetricsRegistry()).exposition(exemplars=exemplars)
    ref = _drive(jax_monitoring.MetricsRegistry()).exposition(
        exemplars=exemplars)
    assert port == ref
    assert ('req_total{route="/we\\"ird\\\\path\\n",code="500"} 1' in port)


def test_metrics_text_of_every_bundle_matches_jax(monkeypatch):
    """Every bundle made in both packages, each family touched the same
    way: the same ``metrics_text``."""
    monitoring.enable()
    jax_monitoring.enable()
    texts = []
    for m in (monitoring, jax_monitoring):
        for name in _BUNDLES:
            getattr(m, name)()
        fm = m.fit_monitor()
        fm.iteration_done(0.5)
        m.generate_monitor().requests_total.labels(outcome="eos").inc()
        m.recovery_monitor().recovery_total.labels(
            component="checkpoint", outcome="fallback").inc(2)
        m.quantize_monitor().observe_pass(dtype="int8", tensors=3,
                                          bytes_before=4096,
                                          bytes_after=1024, seconds=0.02)
        texts.append(m.metrics_text())
    assert texts[0] == texts[1]


_BUNDLES = ("fit_monitor", "serving_monitor", "localsgd_monitor",
            "checkpoint_monitor", "import_monitor", "recovery_monitor",
            "compile_monitor", "generate_monitor", "quantize_monitor",
            "tenant_monitor", "slo_monitor", "guardrail_monitor")


def _families(reg):
    return {f.name: (f.help, f.kind, f.label_names, f._buckets)
            for f in reg.families()}


def test_families_are_one_source_of_truth_with_jax():
    """After every bundle (and the MetricsListener) is made, the port's
    registry holds the JAX package's families: the same names, help
    strings, types, labels and buckets."""
    monitoring.enable()
    jax_monitoring.enable()
    for name in _BUNDLES:
        assert getattr(monitoring, name)() is not None
        getattr(jax_monitoring, name)()
    MetricsListener()._instruments()
    jax_monitoring.MetricsListener()._instruments()
    port = _families(monitoring.registry())
    ref = _families(jax_monitoring.registry())
    assert port == ref and len(port) > 50
    assert sorted(n for n in dir(monitoring) if n.endswith("_monitor")) == \
        sorted(n for n in dir(jax_monitoring) if n.endswith("_monitor"))


def test_bundles_are_none_while_off_and_follow_enable():
    for name in _BUNDLES:
        assert getattr(monitoring, name)() is None
    monitoring.enable()
    assert monitoring.fit_monitor() is not None
    monitoring.disable()
    assert monitoring.fit_monitor() is None


# ------------------------------------------------------------- fit phases
def _phase_counts(reg):
    return {k: reg.get(f"dl4j_train_{k}_seconds").count
            for k in ("data_wait", "device_step", "dispatch", "drain",
                      "listener")} | {
        "iterations": reg.get("dl4j_train_iterations_total").value}


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("steps", [0, 2])
def test_fit_phases_count_as_in_jax(monkeypatch, tmp_path, graph, steps):
    """Sync mode times device_step (dispatch and host fetch), async mode
    dispatch and drain; both time the listeners and each iterator pull.
    The counts are the JAX package's, and the trace's B/E spans nest."""
    _async(monkeypatch, steps)
    monitoring.enable()
    jax_monitoring.enable()
    tracer = monitoring.start_tracing()
    jn, net = _pair(graph)
    x, y = _data(16)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=3)
    jn.fit(JaxArrayIter(x, y, batch_size=8), epochs=3)
    got = _phase_counts(monitoring.registry())
    assert got == _phase_counts(jax_monitoring.registry())
    assert got["iterations"] == 6
    assert got["device_step" if steps == 0 else "dispatch"] == 6
    path = str(tmp_path / "fit.json")
    monitoring.stop_tracing(path)
    events = tracer.events()
    validate_nesting(events)
    names = {e["name"] for e in events}
    want = {"fit.data_wait", "fit.listeners"} | (
        {"fit.device_step"} if steps == 0 else {"fit.dispatch",
                                                "fit.drain"})
    assert want <= names and os.path.getsize(path) > 0


def test_tbptt_is_monitored_and_unguarded(monkeypatch):
    """A tBPTT fit_batch delivers its mean score through the monitored
    listeners phase, and takes no guarded step even when armed (as in the
    JAX package)."""
    _async(monkeypatch, 0)
    monitoring.enable()
    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(LSTMLayer(n_out=6))
            .layer(RnnOutputLayer(n_out=5, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(5, 6)).build())
    net = MultiLayerNetwork(dataclasses.replace(
        conf, tbptt_fwd_length=3, tbptt_bwd_length=3)).init(device="cpu")
    guard = guardrails.arm(net)
    rng = np.random.default_rng(1)
    x = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 6))]
    assert np.isfinite(float(net.fit_batch((x, x))))
    reg = monitoring.registry()
    assert reg.get("dl4j_train_listener_seconds").count == 1
    assert reg.get("dl4j_train_iterations_total").value == 1
    assert guard.trips == 0 and guard.sentinel_trace() == []


# ----------------------------------------------------------- listener
def test_metrics_listener_with_sysmetrics_on_the_cpu():
    assert not monitoring.enabled()  # attaching the listener is the opt-in
    _, net = _pair()
    net.set_listeners(MetricsListener(sysmetrics_every=2))
    x, y = _data(16)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=2)
    reg = monitoring.registry()
    assert np.isfinite(reg.get("dl4j_train_score").value)
    assert reg.get("dl4j_train_iteration_seconds").count == 2
    assert reg.get("dl4j_train_epochs_total").value == 2
    assert reg.get("dl4j_host_rss_mb").value > 0
    # a CPU model reports no device memory, as the JAX CPU backend
    assert reg.get("dl4j_device_mem_in_use_mb").value == 0
    assert sysmetrics.device_memory_mb("cpu") == {}
    sm = sysmetrics.system_metrics("cpu")
    assert set(sm) == {"host_rss_mb"} and sm["host_rss_mb"] > 0


# -------------------------------------------------- checkpoints, imports
def test_checkpoint_metrics_and_span(tmp_path):
    monitoring.enable()
    tracer = monitoring.start_tracing()
    _, net = _pair()
    nbytes = sum(t.numel() * t.element_size() for t in
                 jax.tree_util.tree_leaves((net.params, net.state,
                                            net.opt_state)))
    ckpt = TrainingCheckpointer(str(tmp_path / "ck"), keep_last=2,
                                async_save=False)
    try:
        ckpt.save(1, net)
        ckpt.save(2, net)
        ckpt.wait()
    finally:
        ckpt.close()
    reg = monitoring.registry()
    assert reg.get("dl4j_checkpoint_saves_total").value == 2
    assert reg.get("dl4j_checkpoint_save_seconds").count == 2
    assert reg.get("dl4j_checkpoint_bytes_total").value == 2 * nbytes
    spans = [e for e in tracer.events() if e["name"] == "checkpoint.save"]
    assert [e["ph"] for e in spans] == ["B", "E", "B", "E"]
    assert spans[0]["args"] == {"step": 1, "bytes": nbytes}


def test_import_optimizer_counter_equals_import_opt_stats():
    monitoring.enable()
    jax_monitoring.enable()
    path = os.path.join(FIXTURES, "bert_tiny.onnx")
    port = OnnxModelImport.import_model(path, device="cpu")
    ref = JaxOnnx.import_model(path)
    fam = monitoring.registry().get("dl4j_import_opt_rewrites_total")
    got = {key[1]: child.value for key, child in fam.children()}
    assert got == {k: v for k, v in port.import_opt_stats.items() if v}
    assert got["fuse_attention"] == 2
    jfam = jax_monitoring.registry().get("dl4j_import_opt_rewrites_total")
    assert {k: c.value for k, c in jfam.children()} == {
        k: c.value for k, c in fam.children()}
    assert port.import_opt_stats == ref.import_opt_stats


# ------------------------------------------------------- compile, warmup
def test_kernel_build_directory_and_compile_metrics(monkeypatch, tmp_path):
    """A library found already built in the build directory is a cache
    hit; a build is a compile and a miss. The directory is the configured
    one."""
    monitoring.enable()
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(compile_metrics, "_configured_dir", None)
    assert compile_metrics.configure_compile_cache(str(tmp_path)) == \
        str(tmp_path)
    assert build.BUILD_DIR == tmp_path
    lib = build.CudaLibrary("lrn_fwd.cu", {})
    lib.library_path().write_bytes(b"")
    assert lib.build() == lib.library_path() and lib.build_seconds == 0.0
    compile_metrics.record_build(2.5)
    reg = monitoring.registry()
    ev = reg.get("dl4j_compile_cache_events_total")
    assert ev.labels(kind="hit").value == 1
    assert ev.labels(kind="miss").value == 1
    assert reg.get("dl4j_compiles_total").value == 1
    assert reg.get("dl4j_compile_seconds").sum == 2.5
    monkeypatch.setenv("DL4J_TORCH_COMPILE_CACHE", str(tmp_path / "env"))
    env.reload()
    assert compile_metrics.configure_compile_cache() == str(tmp_path / "env")
    assert build.BUILD_DIR == tmp_path / "env"


def test_warmup_histogram():
    monitoring.enable()
    _, net = _pair()
    t = warmup_model(net, (4,), (1, 2, 4), labels=("m", "v1"))
    h = monitoring.registry().get("dl4j_serving_warmup_seconds")
    child = h.labels(model="m", version="v1")
    assert child.count == 3 and child.sum == pytest.approx(sum(t.values()))


# ---------------------------------------------------------- zero overhead
def _char_net():
    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(LSTMLayer(n_out=8))
            .layer(RnnOutputLayer(n_out=11, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(11, 6)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_off_paths_make_no_registry_tracer_or_guard_call(monkeypatch):
    """The spy: every registry, tracer, request-trace and guard entry point
    raises; fit_batch (sync and async), fit, the async drain and the
    engine's step still run with monitoring, tracing and guardrails off."""
    assert not monitoring.enabled() and monitoring.tracer() is None

    def boom(*a, **k):
        raise AssertionError("an off path touched the observability layer")

    for cls, names in ((MetricsRegistry, ("counter", "gauge", "histogram",
                                          "get")),
                       (MetricFamily, ("inc", "dec", "set", "observe",
                                       "labels")),
                       (Counter, ("inc",)), (Gauge, ("set", "inc", "dec")),
                       (Histogram, ("observe",)),
                       (SpanTracer, ("span", "instant", "complete")),
                       (RequestTrace, ("add_span", "span", "event")),
                       (guardrails.Guardrail, ("step", "deliver"))):
        for n in names:
            monkeypatch.setattr(cls, n, boom)
    monkeypatch.setattr(sentinel, "screen", boom)
    monkeypatch.setattr(monitoring.flight, "_RECORDER", None)
    x, y = _data(16)
    for steps in (0, 2):
        _async(monkeypatch, steps)
        _, net = _pair()
        for _ in range(3):
            net.fit_batch((x, y))
        drain_scores(net)
        net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=2)
        assert net.step_count == 7
    eng = GenerationEngine(_char_net(), slots=2, max_len=16, device="cpu")
    streams = [eng.submit([1, 2, 3], max_new_tokens=3),
               eng.submit([4], max_new_tokens=2)]
    eng.drain()
    assert [len(s.tokens) for s in streams] == [3, 2]
    assert eng.tracer is None and all(s.trace is None for s in streams)


# ------------------------------------------------- the op registry's cache
def test_choice_cache_bounded_under_300_prompt_lengths(monkeypatch):
    """The recurrent adapter prefills at the true prompt length, one
    choice-cache key each. 300 distinct lengths leave ``lstm_layer``'s
    cache at its bound, and the bounded cache picks what an unbounded one
    picks (the same implementation for every key it holds, the same
    streams)."""
    import collections

    from deeplearning4j_tpu_torch.ops import registry

    saved = {n: collections.OrderedDict(op._choices)
             for n, op in registry._REGISTRY.items()}
    op = registry.get_op("lstm_layer")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 11, n).tolist() for n in range(2, 302)]
    net = _char_net()
    runs = []
    try:
        for size in (10 ** 6, registry.CHOICE_CACHE_SIZE):
            monkeypatch.setattr(registry, "CHOICE_CACHE_SIZE", size)
            op._choices.clear()
            eng = GenerationEngine(net, slots=4, max_len=320, device="cpu")
            streams = [eng.submit(p, max_new_tokens=1) for p in prompts]
            eng.drain()
            runs.append(([s.tokens for s in streams],
                         collections.OrderedDict(op._choices)))
    finally:
        for n, choices in saved.items():
            registry._REGISTRY[n]._choices = choices
    (tokens_ref, unbounded), (tokens, bounded) = runs
    assert len(unbounded) > registry.CHOICE_CACHE_SIZE
    assert len(bounded) == registry.CHOICE_CACHE_SIZE
    assert all(unbounded[k] is impl for k, impl in bounded.items())
    assert list(bounded) == list(unbounded)[-registry.CHOICE_CACHE_SIZE:]
    assert tokens == tokens_ref


def test_choice_cache_eviction_race_between_threads(monkeypatch):
    """A second thread evicts the key that the first thread's lookup just
    found, between that lookup and its reorder (the cache is bounded at 2
    here). The lookup must still return its choice: unguarded, the reorder
    raised ``KeyError`` in the middle of a forward. The choices stay what
    they were."""
    import collections
    import threading

    import torch

    from deeplearning4j_tpu_torch.ops import registry

    op = registry._Op("race_probe")
    op.impls.append(registry.OpImpl("race_probe", registry.PLAIN,
                                    lambda x: x))
    monkeypatch.setattr(registry, "CHOICE_CACHE_SIZE", 2)
    x = torch.zeros(1)
    impl = op.select(x)
    others = []

    def evict():  # two new signatures push the first key out
        others.extend(op.select(torch.zeros(n)) for n in (2, 3))

    class Interleaved(collections.OrderedDict):
        hit = False

        def get(self, key, default=None):
            found = super().get(key, default)
            if found is not None and not Interleaved.hit:
                Interleaved.hit = True
                t = threading.Thread(target=evict)
                t.start()
                t.join(timeout=0.5)   # blocks here while select holds its lock
                threads.append(t)
            return found

    threads = []
    op._choices = Interleaved(op._choices)
    assert op.select(x) is impl
    for t in threads:
        t.join(timeout=10)
    assert Interleaved.hit and others == [impl, impl]
    assert len(op._choices) == 2
    assert all(v is impl for v in op._choices.values())
