"""The SLO layer: per-class latency objectives, burn rate, shed order.

Counterpart of ``deeplearning4j_tpu/serving/slo.py``, copied: the
module has no framework in it.

An SLO here is "fraction ``target`` of a class's requests finish within
``objective_ms``". The tracker keeps a sliding window of recent latencies
per priority class and derives the **burn rate** — observed violation
fraction divided by the error budget ``(1 - target)``. Burn rate 1.0 means
the budget is being spent exactly as fast as the objective allows; above
1.0 the class is missing its SLO.

Overload policy is **shed lowest class first**: when a class is burning
(rate > ``shed_threshold``), every *strictly lower* class sheds at
admission (429, ``dl4j_serving_shed_total{reason="slo"}``) until the
burning class recovers — batch traffic is sacrificed to keep interactive
p99 inside its objective, never the reverse. A burning class itself is
NOT shed (shedding it wouldn't return its already-spent budget and would
turn a latency miss into an availability miss).

``GET /slo`` on the gateway reports the whole picture per class:
objective, window count, violation fraction, burn rate, and whether
traffic of that class is currently being shed.

Zero-overhead contract: a gateway without ``slo=`` config never builds a
tracker — no deques, no burn-rate math, no extra metrics on the request
path (spy-guarded in tests/test_torch_serving_gateway.py).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.monitoring import flight
from deeplearning4j_tpu_torch.serving.tenancy import (
    PRIORITY_CLASSES, class_rank,
)


class SloTracker:
    """Sliding-window latency objectives per priority class.

    ``objectives`` maps class -> ``{"objective_ms": float, "target": float}``
    (target defaults to 0.99; a bare number is shorthand for the
    objective). Classes without an objective are tracked for /slo but never
    burn, and never cause shedding. ``window`` is the per-class sample
    count the burn rate is computed over; ``min_samples`` keeps one
    unlucky cold-start request from tripping the shed policy.
    """

    def __init__(self, objectives: Dict[str, object], *, window: int = 256,
                 min_samples: int = 8, shed_threshold: float = 1.0):
        self.objectives: Dict[str, Dict[str, float]] = {}
        for klass, obj in dict(objectives).items():
            if not isinstance(obj, dict):
                obj = {"objective_ms": float(obj)}
            if "objective_ms" not in obj:
                raise ValueError(f"SLO for class {klass!r} needs "
                                 "'objective_ms'")
            target = float(obj.get("target", 0.99))
            if not 0.0 < target < 1.0:
                raise ValueError(f"SLO target for {klass!r} must be in "
                                 f"(0, 1), got {target}")
            self.objectives[klass] = {
                "objective_s": float(obj["objective_ms"]) / 1000.0,
                "target": target}
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.shed_threshold = float(shed_threshold)
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {}     # klass -> deque[bool ok]
        self._burning: set = set()   # classes past shed_threshold (edges)
        mon = monitoring.slo_monitor()
        if mon is not None:
            for klass, obj in self.objectives.items():
                mon.objective_seconds.labels(**{"class": klass}).set(
                    obj["objective_s"])

    # ------------------------------------------------------------- observe
    def observe(self, klass: Optional[str], seconds: float) -> None:
        """Record one served request's latency under its class."""
        klass = klass or "default"
        obj = self.objectives.get(klass)
        ok = obj is None or seconds <= obj["objective_s"]
        with self._lock:
            samples = self._samples.setdefault(klass,
                                               deque(maxlen=self.window))
            samples.append(ok)
            burn = self._burn_locked(klass)
            # edge-detect shed-threshold crossings for the flight recorder:
            # one event per transition, not one per observation
            crossed = None
            if burn is not None:
                if burn > self.shed_threshold and klass not in self._burning:
                    self._burning.add(klass)
                    crossed = "slo_burn"
                elif burn <= self.shed_threshold and klass in self._burning:
                    self._burning.discard(klass)
                    crossed = "slo_recover"
        if crossed is not None:
            rec = flight.recorder()
            if rec is not None:
                rec.record(crossed,
                           severity="warn" if crossed == "slo_burn"
                           else "info",
                           klass=klass, burn_rate=round(burn, 4),
                           threshold=self.shed_threshold)
        mon = monitoring.slo_monitor()
        if mon is not None:
            mon.latency_seconds.labels(**{"class": klass}).observe(seconds)
            if not ok:
                mon.violations_total.labels(**{"class": klass}).inc()
            if burn is not None:
                mon.burn_rate.labels(**{"class": klass}).set(burn)

    def _burn_locked(self, klass: str) -> Optional[float]:
        """Violation fraction / error budget over the window; None when the
        class has no objective or too few samples to judge."""
        obj = self.objectives.get(klass)
        samples = self._samples.get(klass)
        if obj is None or not samples or len(samples) < self.min_samples:
            return None
        bad = sum(1 for ok in samples if not ok)
        return (bad / len(samples)) / (1.0 - obj["target"])

    def burn_rate(self, klass: str) -> Optional[float]:
        with self._lock:
            return self._burn_locked(klass)

    # ---------------------------------------------------------- shed policy
    def should_shed(self, klass: Optional[str]) -> bool:
        """True when some strictly higher-priority class is burning — this
        (lower) class gives up its admission so the burning class's
        objective recovers. Lowest classes shed first by construction:
        batch sheds while default/interactive still admit."""
        rank = class_rank(klass)
        if rank == 0:
            return False        # nothing outranks the top class
        with self._lock:
            for other in self.objectives:
                if class_rank(other) >= rank:
                    continue
                burn = self._burn_locked(other)
                if burn is not None and burn > self.shed_threshold:
                    return True
        return False

    # --------------------------------------------------------------- status
    def status(self) -> dict:
        """The ``GET /slo`` payload: per-class objective/burn/shed state."""
        with self._lock:
            classes = {}
            known = set(self.objectives) | set(self._samples)
            for klass in sorted(known, key=class_rank):
                obj = self.objectives.get(klass)
                samples = self._samples.get(klass, ())
                bad = sum(1 for ok in samples if not ok)
                classes[klass] = {
                    "objective_ms": (None if obj is None
                                     else obj["objective_s"] * 1000.0),
                    "target": None if obj is None else obj["target"],
                    "window_count": len(samples),
                    "violations": bad,
                    "burn_rate": self._burn_locked(klass),
                }
        for klass, st in classes.items():
            st["shedding"] = self.should_shed(klass)
        return {"classes": classes,
                "priority_order": list(PRIORITY_CLASSES),
                "shed_threshold": self.shed_threshold}
