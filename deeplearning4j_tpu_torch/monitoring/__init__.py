"""Unified monitoring layer: metrics registry + host-side span tracing.

Counterpart of ``deeplearning4j_tpu/monitoring/__init__.py``:

- a process-wide **MetricsRegistry** (Counter / Gauge / Histogram, labeled,
  thread-safe) with Prometheus text exposition (:func:`metrics_text`);
- a host-side **SpanTracer** (``span("name")``, nestable, thread-aware)
  emitting Chrome trace-event JSON, the host timeline beside
  ``profiler.trace()``'s device timeline.

Instrumented subsystems (the fit loop and its async window, checkpoints,
faults and retries, the generation engine and its session journal, the
import-graph optimizer, the kernel builds, the guardrails) fetch their
instrument bundle through the ``*_monitor()`` accessors below, which return
``None`` while monitoring is off. The callers skip ALL instrumentation on
``None``, so the default-off hot path makes one check and no registry or
tracer call (``tests/test_torch_monitoring.py``'s spy). Every bundle of the
JAX file is here, with the same family names, help texts, types and labels,
those whose callers come in later slices (serving, tenant, SLO, local-SGD,
quantize) included: one dashboard reads both packages.

Enablement: ``DL4J_TORCH_MONITORING`` (default off, read at import) or
``monitoring.enable()`` / ``disable()`` at runtime. Tracing is a separate
switch: ``start_tracing()`` installs the global tracer, ``stop_tracing(path)``
detaches it and optionally writes the trace JSON.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.monitoring import flight
from deeplearning4j_tpu_torch.monitoring.flight import FlightRecorder
from deeplearning4j_tpu_torch.monitoring.registry import (
    DEFAULT_BUCKETS, SIZE_BUCKETS, Counter, Gauge, Histogram, MetricFamily,
    MetricsRegistry,
)
from deeplearning4j_tpu_torch.monitoring.tracing import SpanTracer, validate_nesting

_REGISTRY = MetricsRegistry()
_enabled: bool = env.monitoring
_tracer: Optional[SpanTracer] = None
_fit_mon = None
_serving_mon = None
_localsgd_mon = None
_ckpt_mon = None
_import_mon = None
_recovery_mon = None
_compile_mon = None
_generate_mon = None
_quantize_mon = None
_tenant_mon = None
_slo_mon = None
_guardrail_mon = None


def registry() -> MetricsRegistry:
    """The process-wide registry every scrape endpoint reads."""
    return _REGISTRY


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Fresh registry + tracer detached + enablement back to the env flag.
    Test isolation hook; instrument bundles are re-created lazily against
    the new registry."""
    global _REGISTRY, _tracer, _enabled
    global _fit_mon, _serving_mon, _localsgd_mon, _ckpt_mon, _import_mon
    global _recovery_mon, _compile_mon, _generate_mon, _quantize_mon
    global _tenant_mon, _slo_mon, _guardrail_mon
    _REGISTRY = MetricsRegistry()
    _tracer = None
    _enabled = env.monitoring
    _fit_mon = _serving_mon = _localsgd_mon = _ckpt_mon = None
    _import_mon = _recovery_mon = _compile_mon = _generate_mon = None
    _quantize_mon = _tenant_mon = _slo_mon = _guardrail_mon = None
    flight.reset()


def metrics_text(exemplars: bool = False) -> str:
    """The Prometheus exposition body for GET /metrics (``exemplars=True``
    appends OpenMetrics exemplars to histogram buckets — the
    ``?exemplars=1`` scrape)."""
    return _REGISTRY.exposition(exemplars=exemplars)


# ---- tracing ------------------------------------------------------------
def start_tracing() -> SpanTracer:
    """Install (and return) the global span tracer."""
    global _tracer
    _tracer = SpanTracer()
    return _tracer


def stop_tracing(path: Optional[str] = None) -> Optional[SpanTracer]:
    """Detach the global tracer; with ``path``, save its Chrome trace
    JSON there first. Returns the detached tracer (None if none active)."""
    global _tracer
    t, _tracer = _tracer, None
    if t is not None and path is not None:
        t.save(path)
    return t


def tracer() -> Optional[SpanTracer]:
    return _tracer


@contextlib.contextmanager
def span(name: str, **args):
    """A span on the global tracer; transparent no-op when tracing is
    inactive. For per-iteration hot paths prefer the ``*_monitor()``
    bundles (None-gated), which skip even this check."""
    t = _tracer
    if t is None:
        yield None
    else:
        with t.span(name, **args):
            yield t


# ---- per-subsystem instrument bundles -----------------------------------
class _FitMonitor:
    """Fit-loop instruments: the per-iteration wall-time split as histograms
    + spans, plus iteration counter and score gauge. Sync mode times
    "device_step" (dispatch + host fetch, i.e. the device sync); async mode
    (optimize/async_dispatch) splits that into "dispatch" (enqueue only,
    host never blocks) and "drain" (the deferred host fetch) — the
    host-blocked fraction of a fit is then drain/(dispatch+drain)."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.iterations = reg.counter(
            "dl4j_train_iterations_total", "Completed training iterations")
        self.score = reg.gauge(
            "dl4j_train_score", "Training loss/score of the latest iteration")
        self._hists = {
            "data_wait": reg.histogram(
                "dl4j_train_data_wait_seconds",
                "Per-iteration time fit() waits on the data iterator"),
            "device_step": reg.histogram(
                "dl4j_train_device_step_seconds",
                "Host-observed jitted train-step time incl. device sync"),
            "dispatch": reg.histogram(
                "dl4j_train_dispatch_seconds",
                "Async mode: time to enqueue one train step (no host sync)"),
            "drain": reg.histogram(
                "dl4j_train_drain_seconds",
                "Async mode: deferred host fetch of an in-flight loss"),
            "listeners": reg.histogram(
                "dl4j_train_listener_seconds",
                "Per-iteration time in host-side listener callbacks"),
        }

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one fit phase into its histogram (and the tracer, when a
        trace is active)."""
        t = _tracer
        cm = t.span("fit." + name) if t is not None else None
        if cm is not None:
            cm.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._hists[name].observe(time.perf_counter() - t0)
            if cm is not None:
                cm.__exit__(None, None, None)

    def iteration_done(self, score: float) -> None:
        self.iterations.inc()
        self.score.set(float(score))

    def wrap_batches(self, data):
        """Iterate ``data`` timing each pull as the data-wait phase."""
        it = iter(data)
        while True:
            with self.phase("data_wait"):
                try:
                    ds = next(it)
                except StopIteration:
                    return
            yield ds


class _ServingMonitor:
    """Serving-tier instruments: request latency by route/status, in-flight
    and queue-depth gauges, device batch-size distribution — plus the
    gateway's per-model/per-version tier: predict latency, load-shed
    counters by reason (queue_full / deadline / draining), per-model queue
    depth, warmup compile durations, and a loaded-version gauge."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.request_seconds = reg.histogram(
            "dl4j_serving_request_seconds",
            "HTTP request handling latency", labels=("route", "code"))
        self.in_flight = reg.gauge(
            "dl4j_serving_in_flight", "Requests currently being handled")
        self.batch_size = reg.histogram(
            "dl4j_serving_batch_size",
            "Coalesced inference batch sizes", buckets=SIZE_BUCKETS)
        self.queue_depth = reg.gauge(
            "dl4j_serving_queue_depth",
            "Pending requests in the batching queue at dispatch")
        # ---- gateway (per-model) tier ----
        self.model_request_seconds = reg.histogram(
            "dl4j_serving_model_request_seconds",
            "Gateway predict latency per model/version/status",
            labels=("model", "version", "code"))
        self.shed_total = reg.counter(
            "dl4j_serving_shed_total",
            "Requests shed by admission control, by reason and priority "
            "class (class='default' for untenanted traffic)",
            labels=("model", "reason", "class"))
        self.model_queue_depth = reg.gauge(
            "dl4j_serving_model_queue_depth",
            "Admitted-but-undispatched requests per model worker",
            labels=("model", "version"))
        self.warmup_seconds = reg.histogram(
            "dl4j_serving_warmup_seconds",
            "Per-bucket warmup (compile+run) duration at model load",
            labels=("model", "version"),
            buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
        self.model_loaded = reg.gauge(
            "dl4j_serving_model_loaded",
            "1 while the (model, version) is registered and servable",
            labels=("model", "version"))
        # ---- autoscaling tier ----
        self.replicas = reg.gauge(
            "dl4j_serving_replicas",
            "Inference worker replicas currently running per model version",
            labels=("model", "version"))
        self.autoscale_total = reg.counter(
            "dl4j_serving_autoscale_total",
            "Autoscaler replica changes, by direction (up/down)",
            labels=("model", "version", "direction"))


class _LocalSgdMonitor:
    """Local-SGD round instruments: sync (round) duration, rounds counter,
    rows dropped by rebatching/round boundaries."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.sync_seconds = reg.histogram(
            "dl4j_localsgd_sync_seconds",
            "Wall time of one averaging round (K local steps + pmean sync)")
        self.rounds = reg.counter(
            "dl4j_localsgd_rounds_total", "Completed averaging rounds")
        self.dropped_rows = reg.counter(
            "dl4j_localsgd_dropped_rows_total",
            "Sample rows dropped by global-batch/round boundaries")


class _CheckpointMonitor:
    """Checkpoint instruments: save submit duration + payload bytes."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.save_seconds = reg.histogram(
            "dl4j_checkpoint_save_seconds",
            "Checkpoint save() duration (submit time under async saves)")
        self.saved_bytes = reg.counter(
            "dl4j_checkpoint_bytes_total",
            "Total bytes of checkpoint payloads saved")
        self.saves = reg.counter(
            "dl4j_checkpoint_saves_total", "Checkpoint saves issued")


class _RecoveryMonitor:
    """Fault-tolerance instruments: every recovery action any subsystem
    takes (checkpoint fallback, retry-then-succeed, straggler drop, worker
    restart) lands in ``dl4j_recovery_total{component,outcome}``; retry
    attempts and injected faults (``faults``) ride along so
    an injected-fault run is fully reconstructable from /metrics."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.recovery_total = reg.counter(
            "dl4j_recovery_total",
            "Recovery actions taken, by component and outcome",
            labels=("component", "outcome"))
        self.retry_attempts = reg.counter(
            "dl4j_retry_attempts_total",
            "Retry attempts made by RetryPolicy call sites",
            labels=("component",))
        self.faults_injected = reg.counter(
            "dl4j_faults_injected_total",
            "Faults injected by the deeplearning4j_tpu.faults plan",
            labels=("cls",))


class _GuardrailMonitor:
    """Training-guardrail instruments (``guardrails``):
    sentinel trips by kind, policy-ladder actions, steps lost to skips
    and quarantines, bisection probe cost, and the last observed global
    gradient norm — the ``dl4j_guardrail_*`` runbook tier documented in
    docs/fault_tolerance.md."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.trips = reg.counter(
            "dl4j_guardrail_trips_total",
            "Sentinel trips observed at delivery, by trip kind",
            labels=("kind",))
        self.actions = reg.counter(
            "dl4j_guardrail_actions_total",
            "Policy-ladder actions taken on sentinel trips",
            labels=("action",))
        self.steps_lost = reg.counter(
            "dl4j_guardrail_steps_lost_total",
            "Train steps discarded by the guardrail (skips + quarantines)")
        self.bisect_probes = reg.counter(
            "dl4j_guardrail_bisect_probes_total",
            "Replay dispatches spent bisecting for culprit batches")
        self.grad_norm = reg.gauge(
            "dl4j_guardrail_grad_norm",
            "Last pre-clip global gradient norm seen by the sentinel")


class _CompileMonitor:
    """Compile-time instruments (monitoring/compile.py): every nvcc build
    of a hand-written kernel's library lands in
    ``dl4j_compile_seconds``/``dl4j_compiles_total``; each library load
    that finds its hashed build already on disk counts as a cache hit, each
    build as a miss, in ``dl4j_compile_cache_events_total``. The help
    texts are the JAX package's word for word (one dashboard reads both),
    so they still say XLA."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.compiles = reg.counter(
            "dl4j_compiles_total", "XLA backend compiles in this process")
        self.compile_seconds = reg.histogram(
            "dl4j_compile_seconds", "XLA backend compile durations",
            buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
        self.cache_events = reg.counter(
            "dl4j_compile_cache_events_total",
            "Persistent compilation cache probes, by outcome",
            labels=("kind",))


class _ImportMonitor:
    """Import-graph optimizer instruments: per-rule rewrite counts per
    frontend (modelimport/optimizer.py), so the effect of the pass on each
    imported model is observable in the same registry the serving and fit
    tiers scrape."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.rewrites = reg.counter(
            "dl4j_import_opt_rewrites_total",
            "Import-graph optimizer rewrites applied, by frontend and rule",
            labels=("frontend", "rule"))


class _GenerateMonitor:
    """Generation-engine (continuous-batching decode) instruments: the
    streaming SLO trio — time-to-first-token, inter-token latency, token
    throughput — plus slot occupancy, decode-step count, prefill duration,
    and ``dl4j_generate_requests_total{outcome}`` (eos / length / cancelled
    / shed / error), so a serving incident decomposes into admission vs
    prefill vs steady-state decode from one /metrics read."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.requests_total = reg.counter(
            "dl4j_generate_requests_total",
            "Finished generate requests, by outcome",
            labels=("outcome",))
        self.tokens_total = reg.counter(
            "dl4j_generate_tokens_total",
            "Tokens emitted across all streams (rate = tokens/sec)")
        self.decode_steps_total = reg.counter(
            "dl4j_generate_decode_steps_total",
            "Compiled decode-step replays executed")
        self.ttft_seconds = reg.histogram(
            "dl4j_generate_ttft_seconds",
            "Time from submit to a stream's first token")
        self.inter_token_seconds = reg.histogram(
            "dl4j_generate_inter_token_seconds",
            "Gap between consecutive tokens of one stream",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5))
        self.prefill_seconds = reg.histogram(
            "dl4j_generate_prefill_seconds",
            "Prompt prefill duration (bucketed shapes; includes compiles)")
        self.slot_occupancy = reg.gauge(
            "dl4j_generate_slot_occupancy",
            "Active sequence slots after the latest decode step")


class _TenantMonitor:
    """Multi-tenant gateway instruments: per-tenant request outcomes
    (admitted / quota_requests / quota_tokens / unauthorized), token spend,
    and remaining sliding-window quota headroom — the runbook view of which
    tenant an overload is coming from and which quota is biting."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.requests_total = reg.counter(
            "dl4j_tenant_requests_total",
            "Tenant-authenticated requests, by tenant and outcome",
            labels=("tenant", "outcome"))
        self.tokens_total = reg.counter(
            "dl4j_tenant_tokens_total",
            "Quota tokens charged across all requests, by tenant",
            labels=("tenant",))
        self.quota_remaining = reg.gauge(
            "dl4j_tenant_quota_remaining",
            "Sliding-window quota headroom after the latest charge, by "
            "tenant and resource (requests/tokens)",
            labels=("tenant", "resource"))


class _SloMonitor:
    """SLO-layer instruments: per-priority-class latency distribution,
    objective violations, and the burn rate (observed violation fraction /
    error budget) the shed-lowest-class-first policy acts on. Burn rate
    > 1.0 on a class means its error budget is being consumed faster than
    the objective allows — lower classes start shedding."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.latency_seconds = reg.histogram(
            "dl4j_slo_latency_seconds",
            "Served-request latency per priority class", labels=("class",))
        self.violations_total = reg.counter(
            "dl4j_slo_violations_total",
            "Requests that missed their class latency objective",
            labels=("class",))
        self.burn_rate = reg.gauge(
            "dl4j_slo_burn_rate",
            "Error-budget burn rate per class over the sliding window",
            labels=("class",))
        self.objective_seconds = reg.gauge(
            "dl4j_slo_objective_seconds",
            "Configured latency objective per class", labels=("class",))


class _QuantizeMonitor:
    """Quantization-tier instruments: each ``quantize_network`` pass records
    how many weight tensors moved to int8, the param-tree footprint before
    and after (the bandwidth lever being claimed), and the pass duration —
    so a serving fleet's /metrics shows whether a loaded model is actually
    running the shrunk weights it was asked to."""

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg
        self.passes_total = reg.counter(
            "dl4j_quantize_passes_total",
            "Post-training quantization passes run, by target dtype",
            labels=("dtype",))
        self.tensors_total = reg.counter(
            "dl4j_quantize_tensors_total",
            "Weight tensors converted across all passes")
        self.bytes_before = reg.gauge(
            "dl4j_quantize_bytes_before",
            "Param-tree bytes of the last pass's input network")
        self.bytes_after = reg.gauge(
            "dl4j_quantize_bytes_after",
            "Param-tree bytes of the last pass's quantized view")
        self.pass_seconds = reg.histogram(
            "dl4j_quantize_pass_seconds",
            "Quantization pass duration",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))

    def observe_pass(self, *, dtype, tensors, bytes_before, bytes_after,
                     seconds):
        self.passes_total.labels(dtype=dtype).inc()
        self.tensors_total.inc(tensors)
        self.bytes_before.set(bytes_before)
        self.bytes_after.set(bytes_after)
        self.pass_seconds.observe(seconds)


def _bundle(cache_name: str, cls):
    if not _enabled:
        return None
    mon = globals()[cache_name]
    if mon is None or mon.reg is not _REGISTRY:
        mon = cls(_REGISTRY)
        globals()[cache_name] = mon
    return mon


def fit_monitor() -> Optional[_FitMonitor]:
    """Fit-loop bundle, or None when monitoring is off (callers skip all
    instrumentation on None — the zero-overhead contract)."""
    return _bundle("_fit_mon", _FitMonitor)


def serving_monitor() -> Optional[_ServingMonitor]:
    return _bundle("_serving_mon", _ServingMonitor)


def localsgd_monitor() -> Optional[_LocalSgdMonitor]:
    return _bundle("_localsgd_mon", _LocalSgdMonitor)


def checkpoint_monitor() -> Optional[_CheckpointMonitor]:
    return _bundle("_ckpt_mon", _CheckpointMonitor)


def import_monitor() -> Optional[_ImportMonitor]:
    return _bundle("_import_mon", _ImportMonitor)


def recovery_monitor() -> Optional[_RecoveryMonitor]:
    return _bundle("_recovery_mon", _RecoveryMonitor)


def compile_monitor() -> Optional[_CompileMonitor]:
    return _bundle("_compile_mon", _CompileMonitor)


def generate_monitor() -> Optional[_GenerateMonitor]:
    return _bundle("_generate_mon", _GenerateMonitor)


def quantize_monitor() -> Optional[_QuantizeMonitor]:
    return _bundle("_quantize_mon", _QuantizeMonitor)


def tenant_monitor() -> Optional[_TenantMonitor]:
    return _bundle("_tenant_mon", _TenantMonitor)


def slo_monitor() -> Optional[_SloMonitor]:
    return _bundle("_slo_mon", _SloMonitor)


def guardrail_monitor() -> Optional[_GuardrailMonitor]:
    return _bundle("_guardrail_mon", _GuardrailMonitor)


from deeplearning4j_tpu_torch.monitoring.listener import MetricsListener  # noqa: E402 (cycle: listener imports this module)
from deeplearning4j_tpu_torch.monitoring.context import (  # noqa: E402 (cycle: context imports this module)
    RequestTrace, RequestTracer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "SpanTracer", "MetricsListener", "DEFAULT_BUCKETS", "SIZE_BUCKETS",
    "FlightRecorder", "RequestTrace", "RequestTracer", "flight",
    "registry", "enabled", "enable", "disable", "reset", "metrics_text",
    "start_tracing", "stop_tracing", "tracer", "span", "validate_nesting",
    "fit_monitor", "serving_monitor", "localsgd_monitor",
    "checkpoint_monitor", "import_monitor", "recovery_monitor",
    "compile_monitor", "generate_monitor", "quantize_monitor",
    "tenant_monitor", "slo_monitor", "guardrail_monitor",
]
