"""Request-scoped trace context: one trace id per request, spans per hop.

Counterpart of ``deeplearning4j_tpu/monitoring/context.py``, copied. A
:class:`RequestTrace` is minted for a request (or adopted from an inbound
``X-Trace-Id`` header) and handed down every layer it crosses: here the
``GenerationEngine`` slot lifetime (``queue_wait``, ``prefill``,
``decode`` spans, ``admit`` / ``retire`` events) and the async-dispatch
training window. Span timestamps are monotonic offsets from the trace's
birth, so :meth:`RequestTrace.to_chrome` reconstructs where that one
request's time went, Perfetto-loadable.

:class:`RequestTracer` owns the traces: an in-flight table plus a bounded
ring of recently completed requests. A path built without a tracer makes
no tracer call.

Thread-local binding (:func:`bind` / :func:`current` /
:func:`current_trace_id`) carries the ambient trace across layers that do
not thread it: the async-dispatch window stamps each in-flight step with
``current_trace_id()``, so a deferred ``AsyncStepError`` names the trace
that dispatched it. With the process-wide span tracer armed
(``monitoring.start_tracing()``), request spans are mirrored into it as
"X" complete events.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch import monitoring

#: Inbound X-Trace-Id values outside this shape are replaced with a minted
#: id — header text must not be able to corrupt expositions or dump paths.
_SAFE_ID = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

_TLS = threading.local()


def _mint_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """The spans, events, and disposition of ONE request.

    Span timestamps are ``time.monotonic()`` offsets from the trace's
    birth; ``started_at`` anchors them to the wall clock. ``add_span`` /
    ``span`` / ``event`` are thread-safe — gateway handler threads,
    inference workers, and the engine loop all write into the same trace.
    """

    def __init__(self, trace_id: str, request_id: str, route: str,
                 **meta):
        self.trace_id = trace_id
        self.request_id = request_id
        self.route = route
        self.meta = {k: v for k, v in meta.items() if v is not None}
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.finished_dur: Optional[float] = None
        self.disposition: Optional[str] = None   # served / shed / error
        self.code: Optional[int] = None
        self.reason: Optional[str] = None
        self._lock = threading.Lock()
        self._spans: List[Dict] = []
        self._events: List[Dict] = []

    # ------------------------------------------------------------ recording
    def add_span(self, name: str, t0: float, t1: float, **args) -> None:
        """Record one completed stage: ``t0``/``t1`` are
        ``time.monotonic()`` instants (so retroactive spans — e.g. the
        queue wait measured at dequeue — are exact)."""
        rec = {"name": name, "t0": max(0.0, t0 - self._t0),
               "dur": max(0.0, t1 - t0), "tid": threading.get_ident(),
               "thread": threading.current_thread().name}
        if args:
            rec["args"] = {k: v for k, v in args.items() if v is not None}
        with self._lock:
            self._spans.append(rec)
        tracer = monitoring.tracer()
        if tracer is not None:
            tracer.complete(name, rec["dur"], trace_id=self.trace_id, **args)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self.add_span(name, t0, time.monotonic(), **args)

    def event(self, name: str, **args) -> None:
        """A zero-duration marker (e.g. ``retire``, ``shed``)."""
        rec = {"name": name, "t": max(0.0, time.monotonic() - self._t0),
               "tid": threading.get_ident(),
               "thread": threading.current_thread().name}
        if args:
            rec["args"] = {k: v for k, v in args.items() if v is not None}
        with self._lock:
            self._events.append(rec)
        tracer = monitoring.tracer()
        if tracer is not None:
            tracer.instant(name, trace_id=self.trace_id, **args)

    def finish(self, disposition: str, code: Optional[int] = None,
               reason: Optional[str] = None) -> None:
        self.disposition = disposition
        self.code = code
        self.reason = reason
        self.finished_dur = time.monotonic() - self._t0

    # ----------------------------------------------------------- reporting
    @property
    def done(self) -> bool:
        return self.finished_dur is not None

    def duration_s(self) -> float:
        return (self.finished_dur if self.finished_dur is not None
                else time.monotonic() - self._t0)

    def summary(self) -> Dict:
        """One row of ``GET /debug/requests``: identity, disposition, and
        the per-stage timing split."""
        with self._lock:
            stages: Dict[str, Dict] = {}
            for s in self._spans:
                agg = stages.setdefault(s["name"], {"seconds": 0.0,
                                                    "count": 0})
                agg["seconds"] += s["dur"]
                agg["count"] += 1
            events = [e["name"] for e in self._events]
        return {"trace_id": self.trace_id, "request_id": self.request_id,
                "route": self.route, "meta": dict(self.meta),
                "started_at": self.started_at,
                "duration_s": self.duration_s(), "done": self.done,
                "disposition": self.disposition, "code": self.code,
                "reason": self.reason, "stages": stages, "events": events}

    def to_chrome(self) -> Dict:
        """This request as a standalone Chrome trace-event JSON document
        (Perfetto-loadable): thread-named tracks, one enclosing
        ``request`` span, an "X" event per stage, an "i" per marker."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
        pid = 1
        out: List[Dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"request {self.trace_id} ({self.route})"}}]
        named = {}
        for rec in spans + events:
            if rec["tid"] not in named:
                named[rec["tid"]] = rec["thread"]
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": rec["tid"],
                            "args": {"name": rec["thread"]}})
        req_args = {"trace_id": self.trace_id,
                    "request_id": self.request_id, **self.meta}
        if self.disposition is not None:
            req_args.update(disposition=self.disposition, code=self.code,
                            reason=self.reason)
        out.append({"name": f"request {self.route}", "ph": "X", "ts": 0.0,
                    "dur": self.duration_s() * 1e6, "pid": pid, "tid": 0,
                    "args": req_args})
        for s in spans:
            ev = {"name": s["name"], "ph": "X", "ts": s["t0"] * 1e6,
                  "dur": s["dur"] * 1e6, "pid": pid, "tid": s["tid"]}
            if "args" in s:
                ev["args"] = s["args"]
            out.append(ev)
        for e in events:
            ev = {"name": e["name"], "ph": "i", "s": "t",
                  "ts": e["t"] * 1e6, "pid": pid, "tid": e["tid"]}
            if "args" in e:
                ev["args"] = e["args"]
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}


class RequestTracer:
    """Bounded request-trace store: the gateway's in-flight table plus a
    ring of the ``capacity`` most recently completed traces. Lookup by
    trace id serves ``GET /debug/trace/<id>``."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._inflight: Dict[str, RequestTrace] = {}
        self._completed: "deque[RequestTrace]" = deque()
        self._index: Dict[str, RequestTrace] = {}

    def begin(self, route: str, headers=None, **meta) -> RequestTrace:
        """Mint (or adopt from ``X-Trace-Id``) a trace for one request."""
        trace_id = None
        if headers is not None:
            try:
                trace_id = headers.get("X-Trace-Id")
            except AttributeError:
                trace_id = None
        if not (trace_id and _SAFE_ID.match(trace_id)):
            trace_id = _mint_id()
        trace = RequestTrace(trace_id, _mint_id(), route, **meta)
        with self._lock:
            self._inflight[trace.trace_id] = trace
        return trace

    def finish(self, trace: RequestTrace, disposition: str,
               code: Optional[int] = None,
               reason: Optional[str] = None) -> None:
        """Close the trace and move it to the completed ring."""
        trace.finish(disposition, code=code, reason=reason)
        with self._lock:
            self._inflight.pop(trace.trace_id, None)
            while len(self._completed) >= self.capacity:
                old = self._completed.popleft()
                if self._index.get(old.trace_id) is old:
                    del self._index[old.trace_id]
            self._completed.append(trace)
            self._index[trace.trace_id] = trace

    def get(self, trace_id: str) -> Optional[RequestTrace]:
        with self._lock:
            return self._inflight.get(trace_id) or self._index.get(trace_id)

    def inflight(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._inflight.values())

    def completed(self, n: Optional[int] = None) -> List[RequestTrace]:
        with self._lock:
            items = list(self._completed)
        return items if n is None else items[-n:]

    def describe(self, recent: int = 32) -> Dict:
        """The ``GET /debug/requests`` payload."""
        return {
            "in_flight": [t.summary() for t in self.inflight()],
            "completed": [t.summary()
                          for t in reversed(self.completed(recent))],
            "capacity": self.capacity,
        }


# ---- thread-local ambient trace ------------------------------------------
@contextlib.contextmanager
def bind(trace: Optional[RequestTrace]):
    """Install ``trace`` as this thread's ambient trace for the block —
    layers that can't thread it explicitly (async-dispatch, deep call
    stacks) read it back with :func:`current`. ``bind(None)`` is a
    transparent no-op."""
    if trace is None:
        yield None
        return
    prev = getattr(_TLS, "trace", None)
    _TLS.trace = trace
    try:
        yield trace
    finally:
        _TLS.trace = prev


def current() -> Optional[RequestTrace]:
    """The trace bound to this thread, if any."""
    return getattr(_TLS, "trace", None)


def current_trace_id() -> Optional[str]:
    trace = getattr(_TLS, "trace", None)
    return None if trace is None else trace.trace_id
