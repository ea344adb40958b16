"""Admission control: bounded queues, deadlines, and load shedding.

Counterpart of ``deeplearning4j_tpu/serving/admission.py``, copied: the
module has no framework in it.

The failure mode this kills: an overloaded single-queue server accepts every
request, the queue grows without bound, every response is late, and nothing
in /metrics says why. Here admission is explicit — each model's worker queue
is bounded, a request that can't be admitted is REJECTED NOW (HTTP 429 with
``Retry-After``) instead of piling up, every admitted request carries a
deadline (expired ones are shed at dispatch and answered 504), and every
shed increments a per-model, per-reason, per-priority-class counter so
overload is visible — and attributable — the moment it starts.

``Retry-After`` is drain-aware: the controller keeps an EWMA of observed
per-request service time, and a 429's hint is ``EWMA × queue position``
clamped to [1, 30]s — a client behind a deep queue on a slow model backs
off longer than one behind a shallow queue on a fast one, instead of every
rejected client hammering back after the same constant second.

Priority classes ride through ``submit(..., klass=...)`` into the worker's
two-lane queue: ``batch`` requests wait in the low-priority lane that only
drains when no interactive/default work is queued.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.monitoring import flight
from deeplearning4j_tpu_torch.parallel.inference import DeadlineExceeded
from deeplearning4j_tpu_torch.serving.http import HttpError
from deeplearning4j_tpu_torch.serving.registry import ModelVersion


class AdmissionController:
    """Per-request admission policy for the gateway.

    default_timeout_s / max_timeout_s: request deadline bounds (requests may
    pass ``timeout_ms`` in the body, clamped to the max);
    retry_after_s: the backpressure hint on 429 responses before any
    service-time observations exist (the EWMA takes over after warmup).
    """

    #: EWMA smoothing for observed per-request service time
    EWMA_ALPHA = 0.2

    def __init__(self, default_timeout_s: float = 30.0,
                 max_timeout_s: float = 300.0,
                 retry_after_s: float = 1.0):
        self.default_timeout_s = default_timeout_s
        self.max_timeout_s = max_timeout_s
        self.retry_after_s = retry_after_s
        self._ewma_service_s: Optional[float] = None
        self._ewma_lock = threading.Lock()

    # ------------------------------------------------------------ deadline
    def timeout_for(self, body: dict) -> float:
        """The request's timeout budget in seconds (body ``timeout_ms``
        overrides the default, clamped to [1 ms, max])."""
        ms = body.get("timeout_ms")
        if ms is None:
            return self.default_timeout_s
        return min(max(float(ms) / 1000.0, 0.001), self.max_timeout_s)

    def _shed(self, model: str, reason: str, n: int = 1,
              klass: Optional[str] = None, trace=None):
        mon = monitoring.serving_monitor()
        if mon is not None:
            mon.shed_total.labels(model=model, reason=reason,
                                  **{"class": klass or "default"}).inc(n)
        rec = flight.recorder()
        if rec is not None:
            # SLO-driven sheds are a trigger kind: the recorder dumps a
            # postmortem bundle carrying this request's trace
            rec.record("slo_shed" if reason == "slo" else "shed",
                       severity="warn", model=model, reason=reason,
                       klass=klass or "default", n=n, trace=trace)
        if trace is not None:
            trace.event("shed", reason=reason, model=model)

    # ---------------------------------------------------------- backoff hint
    def observe_service(self, seconds_per_request: float) -> None:
        """Feed one observed per-request service time into the EWMA the
        Retry-After hint is computed from."""
        with self._ewma_lock:
            if self._ewma_service_s is None:
                self._ewma_service_s = seconds_per_request
            else:
                self._ewma_service_s += self.EWMA_ALPHA * (
                    seconds_per_request - self._ewma_service_s)

    def retry_after_for(self, position: Optional[int] = None) -> int:
        """Seconds a rejected client should back off: EWMA service time ×
        its queue position, clamped to [1, 30]. Falls back to the
        configured constant before any service time has been observed."""
        with self._ewma_lock:
            ewma = self._ewma_service_s
        if position is None or ewma is None:
            return max(1, math.ceil(self.retry_after_s))
        return min(max(math.ceil(ewma * max(position, 1)), 1), 30)

    def _retry_headers(self, position: Optional[int] = None) -> dict:
        return {"Retry-After": str(self.retry_after_for(position))}

    # -------------------------------------------------------------- submit
    def submit(self, mv: ModelVersion, xs: np.ndarray, deadline: float,
               klass: Optional[str] = None, trace=None) -> List["queue.Queue"]:
        """Admit every row of ``xs`` to ``mv``'s worker, or reject with a
        429 (queue full) / 503 (worker draining). Capacity for the WHOLE
        request is checked up front so a rejected multi-row request does
        not half-admit; rows that slip through the precheck race keep
        their deadline, so the worker eventually sheds them rather than
        holding them forever. ``klass`` routes ``batch`` to the worker's
        low-priority lane; ``trace`` rides into the lane so the worker
        records this request's queue-wait and dispatch spans."""
        cap = mv.pi.max_queue
        if cap and mv.pi.lane_backlog(klass) + len(xs) > cap:
            # per-LANE capacity: a saturated batch lane must not starve
            # interactive admission
            self._shed(mv.name, "queue_full", klass=klass, trace=trace)
            raise HttpError(
                429, f"model {mv.name!r} queue is full ({cap} pending); "
                "retry later",
                headers=self._retry_headers(mv.pi.backlog()))
        queues = []
        for x in xs:
            try:
                queues.append(mv.pi.submit(x, deadline=deadline, klass=klass,
                                           trace=trace))
            except queue.Full:
                self._shed(mv.name, "queue_full", klass=klass, trace=trace)
                raise HttpError(
                    429, f"model {mv.name!r} queue is full "
                    f"({mv.pi.max_queue} pending); retry later",
                    headers=self._retry_headers(mv.pi.backlog())) from None
            except RuntimeError:
                # worker draining (hot reload / shutdown race)
                self._shed(mv.name, "draining", klass=klass, trace=trace)
                raise HttpError(
                    503, f"model {mv.name!r} version {mv.version!r} is "
                    "draining; retry", headers=self._retry_headers()) from None
        mon = monitoring.serving_monitor()
        if mon is not None:
            mon.model_queue_depth.labels(
                model=mv.name, version=mv.version).set(mv.pi.backlog())
        return queues

    # -------------------------------------------------------------- gather
    def gather(self, mv: ModelVersion, queues: List["queue.Queue"],
               deadline: float, klass: Optional[str] = None, trace=None
               ) -> List[np.ndarray]:
        """Collect every result before the deadline; a timeout or a
        deadline-shed result is a 504 (the remaining siblings carry the
        same deadline — the worker cancels them, nothing is orphaned).
        Completed gathers feed the service-time EWMA behind Retry-After."""
        outs = []
        t0 = time.monotonic()
        for q in queues:
            remaining = deadline - time.monotonic()
            try:
                r = q.get(timeout=max(remaining, 0.001))
            except queue.Empty:
                self._shed(mv.name, "deadline", klass=klass, trace=trace)
                raise HttpError(
                    504, f"model {mv.name!r} deadline exceeded "
                    "waiting for result") from None
            if isinstance(r, DeadlineExceeded):
                # worker-side shed already counted via on_shed
                raise HttpError(
                    504, f"model {mv.name!r} deadline exceeded "
                    "before dispatch") from None
            if isinstance(r, BaseException):
                raise HttpError(500, f"model {mv.name!r} forward pass "
                                f"failed: {r}") from None
            outs.append(np.asarray(r))
        self.observe_service((time.monotonic() - t0) / max(len(queues), 1))
        return outs
