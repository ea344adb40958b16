"""Black-box flight recorder: a bounded ring of serving/training incidents.

Counterpart of ``deeplearning4j_tpu/monitoring/flight.py``, copied. The
recorder is cheap enough to leave armed (append a dict into a deque under
a lock), remembers the last ``capacity`` structured events (fault
injections, recoveries, numeric trips, session resumes) and on a TRIGGER
kind dumps a postmortem bundle to a configured directory: the recent event
tail, a full metrics snapshot, and the triggering request's Chrome trace
when one is attached.

Zero-overhead contract: :func:`recorder` returns ``None`` until the
process opts in (``DL4J_TORCH_FLIGHT=1``, ``DL4J_TORCH_FLIGHT_DIR`` for
dumps, ``DL4J_TORCH_FLIGHT_CAP`` for the ring size, read at import, or
:func:`configure` at runtime), and every instrumentation point is a single
``is None`` check.

Dumps are rate-limited (``min_dump_interval_s``); :meth:`FlightRecorder.dump`
with ``force=True`` bypasses the limiter.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.common.env import env

#: Event kinds that auto-dump a postmortem bundle when a dump dir is set.
TRIGGER_KINDS = frozenset(
    {"worker_crash", "gateway_error", "slo_burn", "slo_shed", "preempt",
     "numeric_trip"})


class FlightRecorder:
    """The bounded incident ring + postmortem dump machinery."""

    def __init__(self, capacity: int = 512, dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = 5.0,
                 triggers=TRIGGER_KINDS):
        self.capacity = max(1, int(capacity))
        self.dump_dir = dump_dir
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.triggers = frozenset(triggers)
        self._lock = threading.Lock()
        self._events: "deque[Dict]" = deque(maxlen=self.capacity)
        self._seq = 0
        self._dump_seq = 0
        self._last_dump = float("-inf")
        self.dropped = 0
        self.dumps: List[str] = []

    # ------------------------------------------------------------ recording
    def record(self, kind: str, severity: str = "info",
               trace=None, **fields) -> Dict:
        """Append one structured event; auto-dumps on trigger kinds.
        ``trace`` (a RequestTrace) stamps the event with its trace id AND
        rides into the bundle as the triggering request's full trace."""
        ev: Dict = {"t": time.time(), "kind": kind, "severity": severity}
        if trace is not None:
            ev["trace_id"] = trace.trace_id
        ev.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
        if kind in self.triggers and self.dump_dir is not None:
            self.dump(reason=kind, trace=trace)
        return ev

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            events = list(self._events)
        return events if n is None else events[-n:]

    # ------------------------------------------------------------- dumping
    def dump(self, reason: str, trace=None, force: bool = False,
             path: Optional[str] = None) -> Optional[str]:
        """Write a postmortem bundle; returns its path (None when
        rate-limited or no directory is configured). ``path`` overrides
        the auto-generated ``flight_<n>_<reason>.json`` name (the bench
        hook pins a deterministic artifact name)."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_dump < self.min_dump_interval_s:
                return None
            self._last_dump = now
            self._dump_seq += 1
            seq = self._dump_seq
        if path is None:
            if self.dump_dir is None:
                return None
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"flight_{seq:04d}_{reason}.json")
        from deeplearning4j_tpu_torch import monitoring

        bundle: Dict = {
            "reason": reason,
            "dumped_at": time.time(),
            "events": self.tail(),
            "dropped": self.dropped,
            "metrics": monitoring.metrics_text(),
        }
        if trace is not None:
            bundle["trace"] = {"summary": trace.summary(),
                               "chrome": trace.to_chrome()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1)
        with self._lock:
            self.dumps.append(path)
        return path

    def describe(self, tail: int = 64) -> Dict:
        """The ``GET /debug/flight`` payload."""
        with self._lock:
            seq, dropped = self._seq, self.dropped
            dumps = list(self.dumps)
        return {"events": self.tail(tail), "recorded_total": seq,
                "dropped": dropped, "capacity": self.capacity,
                "dump_dir": self.dump_dir, "dumps": dumps}


# ---- process-wide recorder (faults-style lifecycle) ----------------------
_RECORDER: Optional[FlightRecorder] = None


def recorder() -> Optional[FlightRecorder]:
    """The armed recorder, or None — callers do exactly one None check."""
    return _RECORDER


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None,
              dump_dir: Optional[str] = None,
              min_dump_interval_s: Optional[float] = None
              ) -> Optional[FlightRecorder]:
    """Install (or tear down) the process recorder. With no arguments the
    env vars decide, so ``configure()`` == process-start state."""
    global _RECORDER
    # read the env directly (not via env.reload(), which would clobber
    # attributes tests monkeypatch on the shared Environment singleton)
    env_flag = (os.environ.get(env.FLIGHT) or "").strip().lower() not in (
        "", "0", "false", "off", "no")
    env_dir = (os.environ.get(env.FLIGHT_DIR) or "").strip() or None
    try:
        env_cap = max(1, int((os.environ.get(env.FLIGHT_CAP) or "").strip()))
    except ValueError:
        env_cap = 512
    if enabled is None:
        enabled = env_flag or bool(dump_dir or env_dir)
    if not enabled:
        _RECORDER = None
        return None
    _RECORDER = FlightRecorder(
        capacity=capacity if capacity is not None else env_cap,
        dump_dir=dump_dir if dump_dir is not None else env_dir,
        min_dump_interval_s=(min_dump_interval_s
                             if min_dump_interval_s is not None else 5.0))
    return _RECORDER


def reset() -> Optional[FlightRecorder]:
    """Back to the env-var state (test isolation hook)."""
    return configure()


# Arm from the environment at import, like faults.configure().
reset()
