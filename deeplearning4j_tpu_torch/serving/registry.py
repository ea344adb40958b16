"""Model registry: named, versioned models with hot load/unload/reload and
weighted traffic splitting.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``, copied; the
workers stage batches on the registry's ``device`` (the card unless the
caller asks for the CPU), and warm-up runs each pow2 bucket through
``serving/warmup.py``, which here builds the kernels and fills the op
registry's and the recurrent launchers' plan caches for exactly the
shapes the padded workers dispatch.

Reference analog: the reference's model-server tier keeps one model per
process; a production gateway multiplexes — each (name, version) gets its
own ParallelInference worker (bounded queue, pad-to-bucket batching) and is
warmed at its batch-shape buckets before it takes traffic. Traffic within a
name is split by per-version weights (the canary pattern: 90/10 between
stable and candidate), and a reload builds + warms the replacement fully
off the request path before an atomic swap, then drains the old worker so
already-admitted requests still complete — zero-drop hot swap.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.serving.warmup import pow2_buckets, warmup_model


class ModelVersion:
    """One servable (name, version): the model, its batching worker, and
    its warmed bucket set."""

    def __init__(self, name: str, version: str, model,
                 pi: ParallelInference, buckets: Tuple[int, ...],
                 warmup_timings: Optional[Dict[int, float]] = None):
        self.name = name
        self.version = version
        self.model = model
        self.pi = pi
        self.buckets = buckets
        self.warmup_timings = dict(warmup_timings or {})
        self.loaded_at = time.time()

    def describe(self) -> dict:
        return {"name": self.name, "version": self.version,
                "buckets": list(self.buckets),
                "warmed": sorted(self.warmup_timings),
                "backlog": self.pi.backlog(),
                "healthy": self.pi.healthy(),
                "worker_restarts": self.pi.restarts,
                "quantized": bool(getattr(self.model, "_quantized", False)),
                "loaded_at": self.loaded_at}


class ModelRegistry:
    """Thread-safe name -> {version -> ModelVersion} map with per-name
    traffic splits. ``seed`` pins the weighted-routing RNG (tests);
    ``device`` is where every version's worker stages its batches."""

    def __init__(self, batch_limit: int = 32, max_queue: int = 128,
                 queue_timeout_s: float = 0.005,
                 seed: Optional[int] = None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.batch_limit = batch_limit
        self.max_queue = max_queue
        self.queue_timeout_s = queue_timeout_s
        self._lock = threading.RLock()
        self._models: Dict[str, Dict[str, ModelVersion]] = {}
        self._splits: Dict[str, Dict[str, float]] = {}
        self._rng = random.Random(seed)

    # ------------------------------------------------------------- loading
    def _build(self, name: str, version: str, model, warmup_shape,
               warmup: bool, batch_limit: Optional[int],
               max_queue: Optional[int]) -> ModelVersion:
        """Construct + warm a ModelVersion WITHOUT touching the routing
        table — all first-call cost (kernel builds, plan caches) happens
        off the request path."""
        limit = batch_limit or self.batch_limit
        mon = monitoring.serving_monitor()

        def on_shed(n, klass=None):
            m = monitoring.serving_monitor()
            if m is not None:
                m.shed_total.labels(model=name, reason="deadline",
                                    **{"class": klass or "default"}).inc(n)

        def on_depth(backlog):
            # fires on EVERY dequeue path — normal dispatch and deadline
            # sheds alike — so the per-model queue-depth gauge decays when
            # expired requests are dropped instead of freezing at its last
            # submit-time value (the gauge-leak fix)
            m = monitoring.serving_monitor()
            if m is not None:
                m.model_queue_depth.labels(model=name,
                                           version=version).set(backlog)

        pi = ParallelInference(
            model, batch_limit=limit, queue_timeout_s=self.queue_timeout_s,
            max_queue=self.max_queue if max_queue is None else max_queue,
            on_shed=on_shed, on_depth=on_depth,
            name=f"pi-{name}-{version}", device=self.device).start()
        buckets = pow2_buckets(limit)
        timings: Dict[int, float] = {}
        if warmup and warmup_shape is not None:
            timings = warmup_model(model, warmup_shape, buckets,
                                   labels=(name, version))
        if mon is not None:
            mon.model_loaded.labels(model=name, version=version).set(1)
            mon.replicas.labels(model=name, version=version).set(
                pi.replicas())
        return ModelVersion(name, version, model, pi, buckets, timings)

    def load(self, name: str, version: str, model, *,
             weight: Optional[float] = None,
             warmup_shape: Optional[Sequence[int]] = None,
             warmup: bool = True, batch_limit: Optional[int] = None,
             max_queue: Optional[int] = None) -> ModelVersion:
        """Register (or hot-reload) a version. New names/versions default to
        weight 1.0 when first for the name, else 0.0 (explicit canary
        opt-in via ``weight`` or ``set_split``). Re-loading an existing
        (name, version) is a hot swap: the replacement is warmed first,
        swapped atomically, and the old worker drained."""
        mv = self._build(name, version, model, warmup_shape, warmup,
                         batch_limit, max_queue)
        with self._lock:
            versions = self._models.setdefault(name, {})
            old = versions.get(version)
            versions[version] = mv
            split = self._splits.setdefault(name, {})
            if weight is not None:
                split[version] = float(weight)
            elif version not in split:
                split[version] = 1.0 if len(versions) == 1 else 0.0
        if old is not None:
            old.pi.drain()
        return mv

    def reload(self, name: str, version: str, model, **kw) -> ModelVersion:
        """Alias of :meth:`load` for an existing (name, version): build +
        warm the replacement off-path, atomic swap, drain the old worker —
        in-flight requests against the old instance still complete."""
        return self.load(name, version, model, **kw)

    def unload(self, name: str, version: Optional[str] = None,
               drain: bool = True) -> List[ModelVersion]:
        """Remove one version (or every version of a name). Removed workers
        are drained by default: already-admitted requests complete."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"model {name!r} is not registered")
            if version is None:
                removed = list(versions.values())
                del self._models[name]
                self._splits.pop(name, None)
            else:
                if version not in versions:
                    raise KeyError(f"model {name!r} has no version "
                                   f"{version!r}")
                removed = [versions.pop(version)]
                self._splits.get(name, {}).pop(version, None)
                if not versions:
                    del self._models[name]
                    self._splits.pop(name, None)
        mon = monitoring.serving_monitor()
        for mv in removed:
            if mon is not None:
                mon.model_loaded.labels(model=mv.name,
                                        version=mv.version).set(0)
            if drain:
                mv.pi.drain()
            else:
                mv.pi.stop()
        return removed

    # ------------------------------------------------------------- routing
    def set_split(self, name: str,
                  weights: Dict[str, float]) -> Dict[str, float]:
        """Replace the name's traffic split; weights need not sum to 1
        (normalized at routing time) but must be >= 0, and every keyed
        version must exist."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"model {name!r} is not registered")
            unknown = set(weights) - set(versions)
            if unknown:
                raise KeyError(f"model {name!r} has no version(s) "
                               f"{sorted(unknown)}")
            if any(w < 0 for w in weights.values()):
                raise ValueError("split weights must be >= 0")
            if not any(w > 0 for w in weights.values()):
                raise ValueError("at least one split weight must be > 0")
            self._splits[name] = {v: float(w) for v, w in weights.items()}
            return dict(self._splits[name])

    def route(self, name: str, exclude=()) -> ModelVersion:
        """Pick a version by weighted random choice over the name's split.
        ``exclude`` (circuit-broken replicas, already-failed attempts)
        filters the candidates; when it would empty the set it is ignored
        — routing somewhere honest beats fabricating a 404."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"model {name!r} is not registered")
            split = self._splits.get(name, {})
            weighted = [(versions[v], w) for v, w in split.items()
                        if w > 0 and v in versions]
            if not weighted:
                weighted = [(mv, 1.0) for mv in versions.values()]
            if exclude:
                kept = [(mv, w) for mv, w in weighted
                        if mv.version not in exclude]
                if kept:
                    weighted = kept
            total = sum(w for _, w in weighted)
            r = self._rng.random() * total
            for mv, w in weighted:
                r -= w
                if r <= 0:
                    return mv
            return weighted[-1][0]

    def get(self, name: str, version: str) -> Optional[ModelVersion]:
        with self._lock:
            return self._models.get(name, {}).get(version)

    def versions(self, name: str) -> List[str]:
        """Registered version ids for a name (empty when unknown)."""
        with self._lock:
            return sorted(self._models.get(name, {}))

    # -------------------------------------------------------------- status
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def ready(self) -> bool:
        """At least one servable version registered."""
        with self._lock:
            return any(self._models.values())

    def health(self) -> dict:
        """Per-(name, version) worker health: ``healthy`` is False only in
        the window between a worker-thread death and its revival;
        ``worker_restarts`` counts every self-healing event so far."""
        with self._lock:
            all_versions = [mv for versions in self._models.values()
                            for mv in versions.values()]
        return {
            f"{mv.name}/{mv.version}": {
                "healthy": mv.pi.healthy(),
                "worker_restarts": mv.pi.restarts,
                "backlog": mv.pi.backlog(),
            }
            for mv in all_versions
        }

    def describe(self) -> dict:
        with self._lock:
            return {
                name: {
                    "versions": {v: mv.describe()
                                 for v, mv in versions.items()},
                    "split": dict(self._splits.get(name, {})),
                }
                for name, versions in self._models.items()
            }

    def shutdown(self, drain: bool = True):
        """Drain (or hard-stop) every registered worker."""
        with self._lock:
            all_versions = [mv for versions in self._models.values()
                            for mv in versions.values()]
            self._models.clear()
            self._splits.clear()
        for mv in all_versions:
            if drain:
                mv.pi.drain()
            else:
                mv.pi.stop()
