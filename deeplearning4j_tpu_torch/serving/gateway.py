"""The production serving gateway: registry + admission + warmup + lifecycle.

Counterpart of ``deeplearning4j_tpu/serving/gateway.py``, copied, with a
``device`` (the card unless the caller passes ``device="cpu"``): every
model's worker stages its batches there, and ``/models/load`` restores
its zip onto it (``restore_model(path, device=..., load_updater=False)``),
with ``"quantize": "int8"`` through the port's ``net.quantize()``.

One HTTP server multiplexing many named, versioned models:

    POST /v1/<name>/predict   {"inputs": [[...]], "timeout_ms": 250}
    POST /v1/<name>/generate  {"prompt"|"prompt_ids", sampling knobs,
                               "stream": true} — ndjson token streaming
                              from a continuous-batching GenerationEngine
                              (serving/generate.py)
    POST /models/load         {"name", "version", "path", "weight",
                               "warmup_shape", "batch_limit"}
    POST /models/reload       (same body — hot swap, zero dropped requests)
    POST /models/unload       {"name", "version"?}
    POST /models/split        {"name", "split": {"v1": 0.9, "v2": 0.1}}
    GET  /models              registry + splits + backlogs
    GET  /healthz             process liveness (200 once the server is up;
                              body reports "degraded" + the affected
                              model workers when any inference worker
                              died/was self-heal restarted)
    GET  /readyz              traffic readiness (503 until a model is
                              loaded, and again once draining)
    GET  /slo                 per-class SLO status: objective, burn rate,
                              and whether the class is currently shedding
                              ({"enabled": false} without SLO config)
    GET  /metrics             Prometheus exposition (process-wide registry;
                              ``?exemplars=1`` upgrades to OpenMetrics with
                              trace-id exemplars on latency buckets)
    GET  /debug/requests      request-tracer table: in-flight + recently
                              completed traces with per-stage timing
                              ({"enabled": false} without ``trace=``)
    GET  /debug/trace/<id>    ONE request as Chrome trace-event JSON
                              (load in Perfetto / chrome://tracing)
    GET  /debug/flight        flight-recorder tail: recent structured
                              incidents and where bundles were dumped

Admission outcomes a client sees: 200 (served), 429 + ``Retry-After``
(queue full, over quota, or shed for a burning higher class — back off),
503 (no servable model, or draining), 504 (deadline exceeded), 500 (model
forward failed), 404 (unknown model), 401 (multi-tenant mode, bad/missing
API key).

Multi-tenant mode (all opt-in; see docs/slo.md):

- ``tenants=[Tenant(...)]`` — API-key auth, priority classes
  (``interactive`` > ``default`` > ``batch``; batch rides the workers'
  low-priority lane), sliding-window request/token quotas (429 with a
  drain-aware ``Retry-After``);
- ``slo={"interactive": {"objective_ms": 250, "target": 0.95}, ...}`` —
  per-class latency objectives with shed-lowest-class-first overload
  behavior and the ``GET /slo`` burn-rate surface;
- ``autoscale={"max_replicas": 4, ...}`` — backlog-driven replica
  autoscaling of every model's worker pool, started/stopped with the
  gateway lifecycle.

None of the three configured = none of the machinery built: the request
path does zero tenancy/SLO/priority bookkeeping (spy-guarded contract).

Lifecycle: ``stop()`` is a graceful drain — stop admitting (``/readyz``
goes 503 so balancers eject the instance), wait for in-flight requests,
flush every model's worker queue, then join. Nothing admitted is dropped.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.common.device import DeviceLike
from deeplearning4j_tpu_torch.common.env import Environment, _flag
from deeplearning4j_tpu_torch.monitoring import context, flight
from deeplearning4j_tpu_torch.serving.admission import AdmissionController
from deeplearning4j_tpu_torch.serving.generate import (
    handle_generate, match_generate,
)
from deeplearning4j_tpu_torch.serving.http import (
    HttpError, StreamingResponse, _HttpServerMixin, serve_json,
)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry


def _match_predict(path: str):
    """/v1/<name>/predict -> {"name": name} (None = no match)."""
    parts = path.strip("/").split("/")
    if len(parts) == 3 and parts[0] == "v1" and parts[2] == "predict":
        return {"name": parts[1]}
    return None


def _match_debug_trace(path: str):
    """/debug/trace/<id> -> {"trace_id": id} (None = no match)."""
    parts = path.strip("/").split("/")
    if (len(parts) == 3 and parts[0] == "debug" and parts[1] == "trace"
            and parts[2]):
        return {"trace_id": parts[2]}
    return None


def _sp(trace, name: str, **args):
    """``trace.span(name)`` or a no-op — the tracing None-gate inline, so
    traced and untraced requests share one code path."""
    if trace is None:
        return contextlib.nullcontext()
    return trace.span(name, **args)


class ServingGateway(_HttpServerMixin):
    """Multi-model serving gateway.

        gw = ServingGateway(port=0).start()        # device="cuda"
        gw.register_model("mnist", "v1", model, warmup_shape=(28, 28, 1))
        ... POST http://host:port/v1/mnist/predict {"inputs": [...]}
        gw.stop()          # graceful drain

    ``admin=False`` disables the mutating /models/* routes (predict-only
    data plane); the Python API (register_model/unload_model/set_split)
    always works. ``device``: where models are served (and restored by
    ``/models/load``); a model registered through the Python API must
    live there.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 batch_limit: int = 32, max_queue: int = 128,
                 queue_timeout_s: float = 0.005,
                 default_timeout_s: float = 30.0,
                 retry_after_s: float = 1.0,
                 seed: Optional[int] = None, admin: bool = True,
                 generate_max_queue: int = 64,
                 tenants=None, slo=None, autoscale=None,
                 trace: Optional[bool] = None, failover=None,
                 device: DeviceLike = "cuda"):
        self._host, self._port = host, port
        self.admin = admin
        self.registry = ModelRegistry(
            batch_limit=batch_limit, max_queue=max_queue,
            queue_timeout_s=queue_timeout_s, seed=seed, device=device)
        self.device = self.registry.device
        self.admission = AdmissionController(
            default_timeout_s=default_timeout_s,
            retry_after_s=retry_after_s)
        self.generate_max_queue = generate_max_queue
        # multi-tenant tier: all three stay None unless configured, and
        # every request-path touch point is a single None check — the
        # zero-overhead contract
        self.tenancy = None
        if tenants is not None:
            from deeplearning4j_tpu_torch.serving.tenancy import TenantTable

            self.tenancy = (tenants if isinstance(tenants, TenantTable)
                            else TenantTable(tenants))
        self.slo = None
        if slo is not None:
            from deeplearning4j_tpu_torch.serving.slo import SloTracker

            self.slo = slo if isinstance(slo, SloTracker) else SloTracker(slo)
        self.autoscaler = None
        if autoscale is not None:
            from deeplearning4j_tpu_torch.serving.autoscale import (
                ReplicaAutoscaler,
            )

            self.autoscaler = (autoscale
                               if isinstance(autoscale, ReplicaAutoscaler)
                               else ReplicaAutoscaler(self.registry,
                                                      **autoscale))
        # request tracing follows the same opt-in pattern: built only for
        # trace=True (or DL4J_TORCH_TRACING in the environment, read live so
        # tests can monkeypatch it); otherwise ``tracer is None`` and the
        # request path performs zero tracer calls
        self.tracer = None
        if trace or (trace is None and _flag(Environment.TRACING)):
            self.tracer = monitoring.RequestTracer()
        # failover tier (opt-in, same contract): per-replica circuit
        # breakers + idempotency-keyed cross-replica retry of non-streaming
        # predicts. None = the predict path does zero breaker/cache work.
        self.failover = None
        if failover is not None:
            from deeplearning4j_tpu_torch.serving.failover import (
                GatewayFailover,
            )

            self.failover = (failover
                             if isinstance(failover, GatewayFailover)
                             else GatewayFailover(**failover))
        self._generators: dict = {}
        # per-generator session journals (crash-recoverable generation);
        # empty dict on an unconfigured gateway — the generate path checks
        # truthiness once and performs zero journal calls
        self._sessions: dict = {}
        self._draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Condition(self._inflight_lock)

    # ------------------------------------------------------- python API
    def register_model(self, name: str, version: str, model, *,
                       weight: Optional[float] = None,
                       warmup_shape: Optional[Sequence[int]] = None,
                       warmup: bool = True,
                       batch_limit: Optional[int] = None,
                       max_queue: Optional[int] = None):
        """Load (or hot-reload) a servable version; warmed before it takes
        traffic. See :meth:`ModelRegistry.load`."""
        return self.registry.load(
            name, version, model, weight=weight, warmup_shape=warmup_shape,
            warmup=warmup, batch_limit=batch_limit, max_queue=max_queue)

    def unload_model(self, name: str, version: Optional[str] = None):
        return self.registry.unload(name, version)

    def set_split(self, name: str, weights):
        return self.registry.set_split(name, weights)

    def register_generator(self, name: str, engine, *, sessions=None,
                           resume: bool = True):
        """Attach a started :class:`GenerationEngine` under
        ``POST /v1/<name>/generate`` (streaming). The engine's background
        step loop is started here if it isn't running yet.

        ``sessions`` (a journal path or a
        :class:`~deeplearning4j_tpu_torch.generation.sessions.SessionJournal`)
        arms crash-recoverable sessions: requests carrying an
        ``X-Request-Id`` become durable, clients reconnect with
        ``last_seq``, and — with ``resume=True`` — sessions interrupted by
        a previous process's preemption are re-submitted into this engine
        BEFORE it takes new traffic (register, then ``start()`` the
        gateway)."""
        if sessions is not None:
            from deeplearning4j_tpu_torch.generation.sessions import (
                SessionJournal,
            )

            journal = (sessions if isinstance(sessions, SessionJournal)
                       else SessionJournal(sessions))
            engine.attach_journal(journal)
            self._sessions[name] = journal
        self._generators[name] = engine.start()
        if sessions is not None and resume:
            self._sessions[name].resume_into(engine)
        return engine

    def unregister_generator(self, name: str, *, timeout: float = 10.0):
        eng = self._generators.pop(name)
        eng.shutdown(timeout=timeout)
        return eng

    # --------------------------------------------------------- handlers
    def _track(self, delta: int):
        with self._inflight_lock:
            self._inflight += delta
            if self._inflight == 0:
                self._idle.notify_all()

    def _admit_tenant(self, name: str, body: dict, headers, cost: int,
                      trace=None):
        """The multi-tenant admission prelude shared by predict and
        generate: authorize the API key, shed if a higher-priority class
        is burning its SLO budget, then charge the quota. Returns the
        tenant's priority class (None when tenancy is off — the
        zero-overhead path does none of this)."""
        tenant = klass = None
        if self.tenancy is not None:
            tenant = self.tenancy.authorize(body, headers)
            klass = tenant.klass
        if self.slo is not None and self.slo.should_shed(klass):
            self.admission._shed(name, "slo", klass=klass, trace=trace)
            raise HttpError(
                429, f"shedding {klass or 'default'} traffic: a higher-"
                "priority class is over its latency objective",
                headers=self.admission._retry_headers())
        if tenant is not None:
            try:
                self.tenancy.admit(tenant, tokens=cost)
            except HttpError:
                self.admission._shed(name, "quota", klass=klass, trace=trace)
                raise
        return klass

    def _begin_trace(self, route: str, params, model: str):
        """Mint a trace (tracer configured) and flight-record the admit
        (recorder armed); both are None-gated no-ops otherwise."""
        trace = None
        if self.tracer is not None:
            trace = self.tracer.begin(route, headers=params.get("_headers"),
                                      model=model)
        rec = flight.recorder()
        if rec is not None:
            rec.record("admit", route=route, model=model, trace=trace)
        return trace

    def _finish_trace(self, trace, exc: Optional[BaseException]) -> None:
        """Close a trace with the request's disposition: backpressure codes
        are ``shed`` (the reason says why), everything else that raised is
        ``error``, a clean return is ``served``."""
        if trace is None:
            return
        if exc is None:
            self.tracer.finish(trace, "served", code=200)
        elif isinstance(exc, HttpError):
            disp = "shed" if exc.code in (429, 503, 504) else "error"
            self.tracer.finish(trace, disp, code=exc.code,
                               reason=exc.message)
        else:
            self.tracer.finish(trace, "error", code=400, reason=str(exc))

    def _predict(self, params, body):
        if self._draining:
            raise HttpError(503, "gateway is draining",
                            headers=self.admission._retry_headers())
        name = params["name"]
        trace = self._begin_trace("/v1/*/predict", params, name)
        self._track(+1)
        try:
            with context.bind(trace):
                payload = self._predict_inner(name, body,
                                              params.get("_headers"),
                                              trace=trace)
            self._finish_trace(trace, None)
            return payload
        except BaseException as e:
            self._finish_trace(trace, e)
            raise
        finally:
            self._track(-1)

    def _generate(self, params, body):
        if self._draining:
            raise HttpError(503, "gateway is draining",
                            headers=self.admission._retry_headers())
        name = params["name"]
        engine = self._generators.get(name)
        if engine is None:
            raise HttpError(404, f"generator {name!r} is not registered")
        trace = self._begin_trace("/v1/*/generate", params, name)
        try:
            with context.bind(trace):
                with _sp(trace, "quota_check"):
                    klass = self._admit_tenant(
                        name, body, params.get("_headers"),
                        cost=int(body.get("max_new_tokens", 64)),
                        trace=trace)
                payload = handle_generate(self, engine, name, body,
                                          klass=klass, trace=trace,
                                          headers=params.get("_headers"))
        except BaseException as e:
            self._finish_trace(trace, e)
            raise
        if not isinstance(payload, StreamingResponse):
            # streams finish their trace in on_finish, at last-token time
            self._finish_trace(trace, None)
        return payload

    def _predict_inner(self, name: str, body: dict, headers=None,
                       trace=None):
        fo = self.failover
        if fo is None:
            return self._predict_attempt(name, body, headers, trace)
        from deeplearning4j_tpu_torch.serving.failover import ReplicaFailed

        idem = fo.idempotency_key(body, headers)
        if idem is not None:
            cached = fo.idempotency.get(idem)
            if cached is not None:
                # exactly-once from the client's view: replay the stored
                # response instead of re-running the forward
                if trace is not None:
                    trace.event("idempotent_replay")
                return cached
        failed: set = set()

        def attempt():
            payload = self._predict_attempt(
                name, body, headers, trace,
                exclude=fo.excluded(name) | failed, failover=fo,
                failed=failed)
            if idem is not None:
                fo.idempotency.put(idem, payload)
            return payload

        try:
            # the shared RetryPolicy owns backoff + attempt accounting:
            # dl4j_retry_attempts_total{component="gateway"} and
            # dl4j_recovery_total{component="gateway",outcome="retried_ok"}
            return fo.retry_policy.call(attempt, component="gateway")
        except ReplicaFailed as e:
            raise e.error

    def _predict_attempt(self, name: str, body: dict, headers=None,
                         trace=None, exclude=(), failover=None,
                         failed=None):
        try:
            mv = self.registry.route(name, exclude=exclude)
        except KeyError:
            raise HttpError(404, f"model {name!r} is not registered") from None
        xs = np.asarray(body["inputs"], np.float32)
        if xs.ndim < 1 or xs.shape[0] == 0:
            raise HttpError(400, "inputs must be a non-empty batch")
        with _sp(trace, "quota_check"):
            klass = self._admit_tenant(name, body, headers, cost=len(xs),
                                       trace=trace)
        timeout = self.admission.timeout_for(body)
        deadline = time.monotonic() + timeout
        t0 = time.perf_counter()
        code = 200
        try:
            with _sp(trace, "submit", rows=len(xs)):
                try:
                    queues = self.admission.submit(mv, xs, deadline,
                                                   klass=klass, trace=trace)
                except HttpError as e:
                    if e.code != 503:
                        raise
                    # the routed version started draining under us (hot
                    # reload / unload race): re-route once — the registry
                    # swap is atomic, so the retry sees the replacement.
                    # This is what makes hot reload zero-drop.
                    mv = self.registry.route(name, exclude=exclude)
                    queues = self.admission.submit(mv, xs, deadline,
                                                   klass=klass, trace=trace)
            with _sp(trace, "gather"):
                outs = self.admission.gather(mv, queues, deadline,
                                             klass=klass, trace=trace)
            if failover is not None:
                failover.record(name, mv.version, ok=True, trace=trace)
            with _sp(trace, "serialize"):
                return {"outputs": [y.tolist() for y in outs],
                        "model": mv.name, "version": mv.version}
        except HttpError as e:
            code = e.code
            if e.code == 500 and failover is not None:
                # the replica's forward failed: feed its breaker, and if a
                # healthy sibling exists hand the request to it via the
                # retry policy (ReplicaFailed is the retryable wrapper)
                failover.record(name, mv.version, ok=False, trace=trace)
                if failed is not None:
                    failed.add(mv.version)
                siblings = [v for v in self.registry.versions(name)
                            if failed is None or v not in failed]
                if siblings:
                    from deeplearning4j_tpu_torch.serving.failover import (
                        ReplicaFailed)

                    if trace is not None:
                        trace.event("failover", model=name,
                                    version=mv.version)
                    raise ReplicaFailed(e) from e
            raise
        except Exception:
            code = 400
            raise
        finally:
            elapsed = time.perf_counter() - t0
            mon = monitoring.serving_monitor()
            if mon is not None:
                mon.model_request_seconds.labels(
                    model=name, version=mv.version, code=code).observe(
                    elapsed,
                    exemplar=({"trace_id": trace.trace_id}
                              if trace is not None else None))
            if self.slo is not None and code != 429:
                # sheds don't spend latency budget; served outcomes —
                # including 504s, which ARE objective misses — do
                self.slo.observe(klass, elapsed)

    # ----------------------------------------------------- admin routes
    def _require(self, body: dict, *keys):
        missing = [k for k in keys if not body.get(k)]
        if missing:
            raise HttpError(400, f"missing field(s): {', '.join(missing)}")

    def _load_route(self, body: dict):
        self._require(body, "name", "version", "path")
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        model = restore_model(body["path"], device=self.device,
                              load_updater=False)
        q = body.get("quantize")
        if q is not None:
            if q != "int8":
                raise HttpError(400, f"unsupported quantize dtype {q!r} "
                                     "(only 'int8')")
            model = model.quantize(q)
        shape = body.get("warmup_shape")
        mv = self.registry.load(
            body["name"], body["version"], model,
            weight=body.get("weight"),
            warmup_shape=None if shape is None else tuple(shape),
            warmup=bool(body.get("warmup", True)),
            batch_limit=body.get("batch_limit"),
            max_queue=body.get("max_queue"))
        return {"loaded": mv.describe()}

    def _unload_route(self, body: dict):
        self._require(body, "name")
        try:
            removed = self.registry.unload(body["name"], body.get("version"))
        except KeyError as e:
            raise HttpError(404, str(e)) from None
        return {"unloaded": [mv.describe() for mv in removed]}

    def _split_route(self, body: dict):
        self._require(body, "name", "split")
        try:
            split = self.registry.set_split(body["name"], body["split"])
        except KeyError as e:
            raise HttpError(404, str(e)) from None
        return {"split": split}

    def _readyz(self, _body):
        if self._draining:
            raise HttpError(503, "draining")
        if not self.registry.ready():
            raise HttpError(503, "no model loaded")
        return {"ready": True, "models": self.registry.names()}

    def _slo_route(self, _body):
        """Per-class SLO status: objective, burn rate, shed state — the
        operator's 'is batch being sacrificed right now, and why' view."""
        if self.slo is None:
            return {"enabled": False}
        return dict(self.slo.status(), enabled=True)

    def _failover_route(self, _body):
        """Per-replica breaker states + idempotency stats, or
        ``{"enabled": false}`` on a gateway without failover config."""
        if self.failover is None:
            return {"enabled": False}
        return dict(self.failover.describe(), enabled=True)

    def _debug_requests(self, _body):
        """In-flight + recently completed request traces (the tracer's
        table), or ``{"enabled": false}`` on an untraced gateway."""
        if self.tracer is None:
            return {"enabled": False}
        return dict(self.tracer.describe(), enabled=True)

    def _debug_flight(self, _body):
        """The flight recorder's recent-incident tail (process-wide), or
        ``{"enabled": false}`` when no recorder is armed."""
        rec = flight.recorder()
        if rec is None:
            return {"enabled": False}
        return dict(rec.describe(), enabled=True)

    def _debug_trace(self, params, _body):
        """One request's Chrome trace-event JSON by trace id."""
        if self.tracer is None:
            raise HttpError(404, "tracing is not enabled on this gateway")
        trace = self.tracer.get(params["trace_id"])
        if trace is None:
            raise HttpError(
                404, f"unknown trace id {params['trace_id']!r} (in-flight "
                "table and completed ring were checked)")
        return trace.to_chrome()

    def _healthz(self, _body):
        """Liveness stays 200 (the process is up — restart-level health is
        the balancer's /readyz call), but the body surfaces self-healing
        state: any model worker currently dead, or revived since load, is
        listed so operators see degradation before it becomes an outage."""
        health = self.registry.health()
        degraded = sorted(k for k, h in health.items()
                          if not h["healthy"] or h["worker_restarts"] > 0)
        return {"status": "degraded" if degraded else "alive",
                "degraded": degraded, "workers": health}

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ServingGateway":
        self._draining = False
        post_routes = {}
        if self.admin:
            post_routes.update({
                "/models/load": self._load_route,
                "/models/reload": self._load_route,
                "/models/unload": self._unload_route,
                "/models/split": self._split_route,
            })
        self._httpd, self._thread = serve_json(
            self._host, self._port,
            post_routes=post_routes,
            get_routes={
                "/healthz": self._healthz,
                "/readyz": self._readyz,
                "/slo": self._slo_route,
                "/failover": self._failover_route,
                "/models": lambda _: {"models": self.registry.describe()},
                "/debug/requests": self._debug_requests,
                "/debug/flight": self._debug_flight,
            },
            dynamic_post=[
                ("/v1/*/predict", _match_predict, self._predict),
                ("/v1/*/generate", match_generate, self._generate),
            ],
            dynamic_get=[
                ("/debug/trace/*", _match_debug_trace, self._debug_trace),
            ])
        if self.autoscaler is not None:
            self.autoscaler.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Graceful drain: stop admitting (new predicts AND generates get
        503, /readyz flips), wait for in-flight work — one-shot requests
        and open generate streams alike, since a stream holds its in-flight
        slot until its last token is written — then shut down. Streams
        still open at the deadline are cancelled at their engine (the
        terminal ndjson line says ``finish_reason: "cancelled"``), never
        left to run headless. ``drain=False`` hard-stops."""
        self._draining = True
        if self.autoscaler is not None:
            # no replica churn while the workers are flushing their lanes
            self.autoscaler.stop()
        end = time.monotonic() + timeout
        if drain:
            with self._inflight_lock:
                while self._inflight > 0:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._idle.wait(timeout=remaining)
        for eng in self._generators.values():
            # drain already waited on open streams; this stops the step
            # loop and cancels anything past the deadline
            eng.shutdown(timeout=max(0.0, end - time.monotonic())
                         if drain else 0.0)
        if drain:
            # cancelled streams flush their terminal line before the
            # listener goes away
            with self._inflight_lock:
                while self._inflight > 0:
                    remaining = end + 1.0 - time.monotonic()
                    if remaining <= 0:
                        break
                    self._idle.wait(timeout=remaining)
        self._stop_httpd()
        self.registry.shutdown(drain=drain)
