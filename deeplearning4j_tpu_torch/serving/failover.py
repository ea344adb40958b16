"""Gateway failover: per-replica circuit breakers + idempotency-keyed retry.

Counterpart of ``deeplearning4j_tpu/serving/failover.py``, copied: the
module has no framework in it.

A replica (one registered (model, version)) that starts failing its
forwards should stop receiving traffic BEFORE clients notice; a request
that hit the failing replica should be retried once on a healthy sibling
— without ever executing twice from the client's point of view.

Circuit breaker (closed -> open -> half-open, per replica):

- ``closed``   normal; errors are counted over a sliding outcome window.
  Trips open on ``consecutive_errors`` in a row OR a windowed error rate
  >= ``error_rate`` (with at least ``window`` outcomes observed).
- ``open``     the router excludes the replica; after ``cooldown_s`` one
  probe request is let through (half-open).
- ``half_open`` the probe's outcome decides: success -> closed (fresh
  window), failure -> open again (new cooldown).

Transitions land in ``dl4j_recovery_total{component="gateway",
outcome="breaker_open"|"breaker_closed"}`` and the flight recorder
(``breaker_open`` events), so a postmortem shows exactly when a replica
was ejected and readmitted.

Idempotency: a non-streaming predict carrying ``Idempotency-Key`` (header)
or ``idempotency_key`` (body) has its successful response cached for
``ttl_s``; a client retry with the same key replays the stored response
byte-for-byte instead of re-running the forward — the retry loop in
``ServingGateway._predict_inner`` (driven by the shared
:class:`~deeplearning4j_tpu_torch.faults.retry.RetryPolicy`) is therefore safe
to be aggressive.

Configured via ``ServingGateway(failover={...})``; an unconfigured gateway
holds ``failover=None`` and the request path does ZERO breaker/cache work
(the spy-guarded zero-overhead contract, same as tenancy/SLO/tracing).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.faults.retry import RetryPolicy
from deeplearning4j_tpu_torch.monitoring import flight


class CircuitBreaker:
    """One replica's health automaton. Thread-safe; time injectable."""

    def __init__(self, consecutive_errors: int = 3, error_rate: float = 0.5,
                 window: int = 16, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.consecutive_errors = int(consecutive_errors)
        self.error_rate = float(error_rate)
        self.window = int(window)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self._outcomes: "deque[bool]" = deque(maxlen=self.window)
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.opened_total = 0

    def allow(self) -> bool:
        """May a request be routed to this replica right now? An open
        breaker admits exactly one probe once the cooldown elapses."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    self._probing = True
                    return True
                return False
            # half_open: one probe in flight at a time
            if not self._probing:
                self._probing = True
                return True
            return False

    def _trip(self) -> bool:
        self.state = "open"
        self._opened_at = self._clock()
        self._consecutive = 0
        self._outcomes.clear()
        self.opened_total += 1
        return True

    def record(self, ok: bool) -> Optional[str]:
        """Feed one outcome; returns "opened"/"closed" on a state change
        (the caller emits metrics/flight events — the breaker stays pure).
        """
        with self._lock:
            if self.state == "half_open":
                self._probing = False
                if ok:
                    self.state = "closed"
                    self._outcomes.clear()
                    self._consecutive = 0
                    return "closed"
                self._trip()
                return "opened"
            if self.state == "open":
                return None  # late result from before the trip
            self._outcomes.append(ok)
            self._consecutive = 0 if ok else self._consecutive + 1
            if not ok:
                errs = sum(1 for o in self._outcomes if not o)
                if (self._consecutive >= self.consecutive_errors
                        or (len(self._outcomes) >= self.window
                            and errs / len(self._outcomes)
                            >= self.error_rate)):
                    self._trip()
                    return "opened"
            return None

    def describe(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "consecutive_errors": self._consecutive,
                    "window": list(self._outcomes),
                    "opened_total": self.opened_total}


class IdempotencyCache:
    """Bounded TTL map: idempotency key -> stored response payload."""

    def __init__(self, ttl_s: float = 120.0, capacity: int = 1024,
                 clock=time.monotonic):
        self.ttl_s = float(ttl_s)
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._d: "OrderedDict[str, Tuple[float, dict]]" = OrderedDict()
        self.replays = 0

    def get(self, key: str) -> Optional[dict]:
        now = self._clock()
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                return None
            at, payload = hit
            if now - at > self.ttl_s:
                del self._d[key]
                return None
            self.replays += 1
            return payload

    def put(self, key: str, payload: dict) -> None:
        with self._lock:
            self._d[key] = (self._clock(), payload)
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)


class GatewayFailover:
    """The gateway's failover brain: breakers per replica, the idempotency
    cache, and the retry policy the predict path runs failed attempts
    under. Built only when ``ServingGateway(failover=...)`` is configured.
    """

    def __init__(self, consecutive_errors: int = 3, error_rate: float = 0.5,
                 window: int = 16, cooldown_s: float = 5.0,
                 retries: int = 1, retry_base_delay_s: float = 0.01,
                 idempotency_ttl_s: float = 120.0,
                 idempotency_capacity: int = 1024,
                 clock=time.monotonic):
        self._breaker_kw = dict(consecutive_errors=consecutive_errors,
                                error_rate=error_rate, window=window,
                                cooldown_s=cooldown_s, clock=clock)
        self.retries = int(retries)
        self.idempotency = IdempotencyCache(ttl_s=idempotency_ttl_s,
                                            capacity=idempotency_capacity,
                                            clock=clock)
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple[str, str], CircuitBreaker] = {}
        # the shared RetryPolicy drives the cross-replica retry: attempts
        # land in dl4j_retry_attempts_total{component="gateway"} and the
        # eventual outcome in dl4j_recovery_total{component="gateway"}
        self.retry_policy = RetryPolicy(
            max_attempts=self.retries + 1, base_delay_s=retry_base_delay_s,
            max_delay_s=0.25, deadline_s=30.0, retry_on=(ReplicaFailed,),
            seed=0)

    def breaker(self, name: str, version: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get((name, version))
            if b is None:
                b = self._breakers[(name, version)] = CircuitBreaker(
                    **self._breaker_kw)
            return b

    def excluded(self, name: str) -> set:
        """Versions of ``name`` the router should avoid right now (their
        breaker is open and still cooling down)."""
        with self._lock:
            items = [(k[1], b) for k, b in self._breakers.items()
                     if k[0] == name]
        return {v for v, b in items if not b.allow()}

    def record(self, name: str, version: str, ok: bool, trace=None) -> None:
        """Feed a replica outcome; emits the transition's metric + flight
        event when the breaker changes state."""
        change = self.breaker(name, version).record(ok)
        if change is None:
            return
        mon = monitoring.recovery_monitor()
        if mon is not None:
            mon.recovery_total.labels(
                component="gateway",
                outcome=f"breaker_{change}").inc()
        rec = flight.recorder()
        if rec is not None:
            rec.record(f"breaker_{change}",
                       severity="warn" if change == "opened" else "info",
                       model=name, version=version, trace=trace)
        if trace is not None:
            trace.event(f"breaker_{change}", model=name, version=version)

    def idempotency_key(self, body: dict, headers=None) -> Optional[str]:
        key = None
        if headers is not None:
            key = headers.get("Idempotency-Key")
        if key is None:
            key = body.get("idempotency_key")
        return key

    def describe(self) -> dict:
        with self._lock:
            breakers = {f"{n}/{v}": b.describe()
                        for (n, v), b in self._breakers.items()}
        return {"breakers": breakers,
                "idempotency_replays": self.idempotency.replays,
                "retries": self.retries}


class ReplicaFailed(Exception):
    """Retryable wrapper: a routed replica 500'd and a sibling is worth
    trying. ``error`` carries the original HttpError for the case where
    every attempt fails."""

    def __init__(self, error):
        super().__init__(str(error))
        self.error = error


__all__ = ["CircuitBreaker", "GatewayFailover", "IdempotencyCache",
           "ReplicaFailed"]
