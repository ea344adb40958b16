"""The serving tier (counterpart of ``deeplearning4j_tpu/serving``).

- :mod:`.gateway`: :class:`ServingGateway`, the multi-model HTTP front:
  ``POST /v1/<name>/predict`` and ``/v1/<name>/generate``, the admin
  ``POST /models/*`` routes, ``/healthz``, ``/readyz``, ``/slo``,
  ``/failover``, graceful drain;
- :mod:`.registry`: named, versioned models, hot load/unload/reload,
  weighted canary splits;
- :mod:`.admission`: bounded queues, deadlines, 429/503/504 backpressure;
- :mod:`.warmup`: the pow2 batch buckets, each run once at model load;
- :mod:`.http`: stdlib JSON-over-HTTP scaffolding (and ``GET /metrics``);
- :mod:`.tenancy`: API keys, priority classes, sliding-window quotas;
- :mod:`.slo`: per-class latency objectives, burn rate, shed order;
- :mod:`.autoscale`: backlog-driven replicas of each model's workers;
- :mod:`.lifecycle`: the preemption drain (journal sessions, checkpoint,
  exit 0);
- :mod:`.failover`: per-replica circuit breakers and idempotency-keyed
  retry;
- :mod:`.generate`: the streaming generate route over a
  ``GenerationEngine``;
- :mod:`.legacy`: the single-model ``ModelServer`` and the
  nearest-neighbors ``KNNServer`` over ``neighbors/``.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""

# Lazy re-exports (PEP 562): the generation engine imports warmup's bucket
# helpers, and importing the whole HTTP gateway stack beside them would
# drag threading servers into every `import deeplearning4j_tpu_torch.
# generation` (tests/test_torch_serving_gateway.py's import-graph test).
_EXPORTS = {
    "AdmissionController": "deeplearning4j_tpu_torch.serving.admission",
    "ServingGateway": "deeplearning4j_tpu_torch.serving.gateway",
    "Tenant": "deeplearning4j_tpu_torch.serving.tenancy",
    "TenantTable": "deeplearning4j_tpu_torch.serving.tenancy",
    "QuotaExceeded": "deeplearning4j_tpu_torch.serving.tenancy",
    "PRIORITY_CLASSES": "deeplearning4j_tpu_torch.serving.tenancy",
    "SloTracker": "deeplearning4j_tpu_torch.serving.slo",
    "ReplicaAutoscaler": "deeplearning4j_tpu_torch.serving.autoscale",
    "HttpError": "deeplearning4j_tpu_torch.serving.http",
    "serve_json": "deeplearning4j_tpu_torch.serving.http",
    "_serve_json": "deeplearning4j_tpu_torch.serving.http",
    "_HttpServerMixin": "deeplearning4j_tpu_torch.serving.http",
    "KNNServer": "deeplearning4j_tpu_torch.serving.legacy",
    "ModelServer": "deeplearning4j_tpu_torch.serving.legacy",
    "ModelRegistry": "deeplearning4j_tpu_torch.serving.registry",
    "ModelVersion": "deeplearning4j_tpu_torch.serving.registry",
    "bucket_for": "deeplearning4j_tpu_torch.serving.warmup",
    "pow2_buckets": "deeplearning4j_tpu_torch.serving.warmup",
    "warmup_model": "deeplearning4j_tpu_torch.serving.warmup",
    "LifecycleManager": "deeplearning4j_tpu_torch.serving.lifecycle",
    "CircuitBreaker": "deeplearning4j_tpu_torch.serving.failover",
    "GatewayFailover": "deeplearning4j_tpu_torch.serving.failover",
    "IdempotencyCache": "deeplearning4j_tpu_torch.serving.failover",
    "ReplicaFailed": "deeplearning4j_tpu_torch.serving.failover",
}

__all__ = [
    "ServingGateway", "ModelRegistry", "ModelVersion",
    "AdmissionController", "HttpError", "serve_json",
    "Tenant", "TenantTable", "QuotaExceeded", "PRIORITY_CLASSES",
    "SloTracker", "ReplicaAutoscaler",
    "ModelServer", "KNNServer",
    "pow2_buckets", "bucket_for", "warmup_model",
    "LifecycleManager", "CircuitBreaker", "GatewayFailover",
    "IdempotencyCache", "ReplicaFailed",
]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
