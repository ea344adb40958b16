"""Replica autoscaling of ParallelInference workers from serving signals.

Counterpart of ``deeplearning4j_tpu/serving/autoscale.py``, copied: the
module has no framework in it.

The actuator is :meth:`ParallelInference.set_replicas` (worker threads
sharing one lane pair — growth spawns immediately, shrink retires workers
at their next loop check); the sensor is the same backlog that feeds
``dl4j_serving_model_queue_depth``. Policy is deliberately boring:

- scale UP one replica when backlog-per-replica has exceeded
  ``high_backlog`` for ``scale_up_after`` consecutive ticks;
- scale DOWN one replica when it has stayed below ``low_backlog`` for
  ``scale_down_after`` consecutive ticks (down is slower than up — the
  classic hysteresis asymmetry that prevents flapping on bursty load);
- never below ``min_replicas``, never above ``max_replicas``.

Every change moves by ONE replica and resets the streak, so a spike ramps
up over a few ticks instead of slamming to the max, and the decision trail
is legible in ``dl4j_serving_autoscale_total{direction=...}`` +
``dl4j_serving_replicas``.

Drive it manually (``tick()`` from tests/bench) or start the background
thread (``start()``/``stop()``) — the gateway wires the latter into its
lifecycle when constructed with ``autoscale=``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.monitoring import flight


class ReplicaAutoscaler:
    """Backlog-driven worker autoscaling over every model in a registry."""

    def __init__(self, registry, *, min_replicas: int = 1,
                 max_replicas: int = 4, high_backlog: float = 8.0,
                 low_backlog: float = 1.0, scale_up_after: int = 2,
                 scale_down_after: int = 5, interval_s: float = 0.25):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.registry = registry
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_backlog = float(high_backlog)
        self.low_backlog = float(low_backlog)
        self.scale_up_after = int(scale_up_after)
        self.scale_down_after = int(scale_down_after)
        self.interval_s = float(interval_s)
        self._streaks: Dict[str, int] = {}   # key -> +up / -down streak
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---------------------------------------------------------------- tick
    def tick(self) -> Dict[str, dict]:
        """One evaluation pass over every registered (name, version).
        Returns the per-model decision trail (tests and /models debugging).
        """
        decisions: Dict[str, dict] = {}
        with self.registry._lock:
            all_versions = [mv for versions in self.registry._models.values()
                            for mv in versions.values()]
        seen = set()
        mon = monitoring.serving_monitor()
        for mv in all_versions:
            key = f"{mv.name}/{mv.version}"
            seen.add(key)
            replicas = max(1, mv.pi.replicas())
            per_replica = mv.pi.backlog() / replicas
            streak = self._streaks.get(key, 0)
            if per_replica > self.high_backlog:
                streak = streak + 1 if streak > 0 else 1
            elif per_replica < self.low_backlog:
                streak = streak - 1 if streak < 0 else -1
            else:
                streak = 0
            direction = None
            if streak >= self.scale_up_after and replicas < self.max_replicas:
                mv.pi.set_replicas(replicas + 1)
                direction, streak = "up", 0
            elif (streak <= -self.scale_down_after
                    and replicas > self.min_replicas):
                mv.pi.set_replicas(replicas - 1)
                direction, streak = "down", 0
            self._streaks[key] = streak
            target = mv.pi._target
            if direction is not None:
                rec = flight.recorder()
                if rec is not None:
                    rec.record("autoscale", model=mv.name,
                               version=mv.version, direction=direction,
                               replicas=target,
                               backlog_per_replica=round(per_replica, 3))
            if mon is not None:
                mon.replicas.labels(model=mv.name,
                                    version=mv.version).set(target)
                if direction is not None:
                    mon.autoscale_total.labels(
                        model=mv.name, version=mv.version,
                        direction=direction).inc()
            decisions[key] = {"backlog_per_replica": per_replica,
                              "replicas": target, "streak": streak,
                              "scaled": direction}
        # forget models that were unloaded
        for key in list(self._streaks):
            if key not in seen:
                del self._streaks[key]
        return decisions

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ReplicaAutoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="dl4j-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def describe(self) -> dict:
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "high_backlog": self.high_backlog,
                "low_backlog": self.low_backlog,
                "scale_up_after": self.scale_up_after,
                "scale_down_after": self.scale_down_after,
                "streaks": dict(self._streaks)}
