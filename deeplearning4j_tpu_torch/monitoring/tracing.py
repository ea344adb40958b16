"""Host-side span tracer emitting Chrome trace-event JSON.

Counterpart of ``deeplearning4j_tpu/monitoring/tracing.py``, copied. It is
the HOST timeline beside ``profiler.trace()``'s device timeline: where a
training step's wall time goes between data wait, the dispatched device
step and listener callbacks. Spans are nestable context managers and
thread-aware (each span records the emitting thread's id).

The output is the Chrome trace-event format (begin/end "B"/"E" pairs, "X"
complete events, "M" metadata under ``{"traceEvents": [...]}``), which
Perfetto and chrome://tracing load. Timestamps are microseconds from
tracer start (``perf_counter``).

The event buffer is a ring: past ``max_events`` (constructor argument,
else ``DL4J_TORCH_TRACE_MAX_EVENTS``, default 100k) the oldest events drop
and are counted, in ``.dropped`` and, with monitoring on, in
``dl4j_trace_events_dropped_total``. Metadata events (process_name, and a
``thread_name`` the first time each thread records) live outside the
ring.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional

from deeplearning4j_tpu_torch.common.env import env


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class SpanTracer:
    """Collects nested, thread-aware spans as Chrome trace events.

    Usage::

        tracer = SpanTracer()
        with tracer.span("fit.iteration", step=3):
            with tracer.span("fit.device_step"):
                ...
        tracer.save("trace.json")   # open in Perfetto
    """

    def __init__(self, process_name: str = "deeplearning4j_tpu_torch",
                 max_events: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._cap = max(1, int(max_events if max_events is not None
                               else env.trace_max_events))
        self._events: Deque[Dict] = collections.deque()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._named_tids: set = set()
        self._meta: List[Dict] = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": process_name}}]
        self.dropped = 0

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _append(self, ev: Dict) -> None:
        """Ring append: names the emitting thread on first sight, evicts
        (and counts) the oldest event at capacity."""
        tid = ev.get("tid")
        overflowed = False
        with self._lock:
            if tid and tid not in self._named_tids:
                self._named_tids.add(tid)
                self._meta.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
            if len(self._events) >= self._cap:
                self._events.popleft()
                self.dropped += 1
                overflowed = True
            self._events.append(ev)
        if overflowed:
            from deeplearning4j_tpu_torch import monitoring

            if monitoring.enabled():
                monitoring.registry().counter(
                    "dl4j_trace_events_dropped_total",
                    "Span-tracer ring-buffer events dropped at capacity",
                ).inc()

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a section as a begin/end event pair on this thread."""
        tid = threading.get_ident()
        begin: Dict = {"name": name, "ph": "B", "ts": self._now_us(),
                       "pid": self._pid, "tid": tid}
        if args:
            begin["args"] = {k: _json_safe(v) for k, v in args.items()}
        self._append(begin)
        try:
            yield self
        finally:
            self._append({"name": name, "ph": "E", "ts": self._now_us(),
                          "pid": self._pid, "tid": tid})

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (thread-scoped)."""
        ev: Dict = {"name": name, "ph": "i", "s": "t",
                    "ts": self._now_us(), "pid": self._pid,
                    "tid": threading.get_ident()}
        if args:
            ev["args"] = {k: _json_safe(v) for k, v in args.items()}
        self._append(ev)

    def complete(self, name: str, dur_s: float, **args) -> None:
        """Record an already-measured span (ended ~now, ``dur_s`` long) as
        an "X" complete event — how request-trace spans
        (monitoring/context.py) mirror into the process timeline without
        holding the tracer lock for their whole duration."""
        dur_us = max(0.0, float(dur_s)) * 1e6
        ev: Dict = {"name": name, "ph": "X",
                    "ts": max(0.0, self._now_us() - dur_us), "dur": dur_us,
                    "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = {k: _json_safe(v) for k, v in args.items()}
        self._append(ev)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._meta) + list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_dict(self) -> Dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write the Perfetto/chrome://tracing-loadable JSON file."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)
        return str(path)


def validate_nesting(events: List[Dict]) -> None:
    """Raise ValueError unless every thread's B/E events form balanced,
    properly nested pairs (the invariant trace viewers rely on). Used by
    tests; cheap enough to run on any saved trace."""
    stacks: Dict[int, List[str]] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("B", "E"):
            continue
        stack = stacks.setdefault(ev["tid"], [])
        if ph == "B":
            stack.append(ev["name"])
        else:
            if not stack or stack[-1] != ev["name"]:
                raise ValueError(
                    f"unbalanced trace: E {ev['name']!r} closes "
                    f"{stack[-1] if stack else None!r} on tid {ev['tid']}")
            stack.pop()
    leftover = {tid: s for tid, s in stacks.items() if s}
    if leftover:
        raise ValueError(f"unclosed spans at end of trace: {leftover}")
