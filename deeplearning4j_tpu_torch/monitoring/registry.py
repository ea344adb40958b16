"""Thread-safe labeled metrics registry with Prometheus text exposition.

Counterpart of ``deeplearning4j_tpu/monitoring/registry.py``, copied: a
process-wide registry of named instruments (Counter / Gauge / Histogram,
optionally labeled, histograms with OpenMetrics exemplars) that any
subsystem writes into and a scrape reads out in the Prometheus text
format. The exposition is the JAX package's byte for byte for the same
calls (``tests/test_torch_monitoring.py``), so one dashboard reads both.

Everything is stdlib: instruments guard their state with a lock, and
exposition renders the standard text format (``# HELP`` / ``# TYPE``
headers, cumulative ``_bucket{le=...}`` histogram lines with ``_sum`` /
``_count``).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Latency-shaped default buckets (seconds), prometheus-client's defaults.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Power-of-two size buckets (batch sizes, queue depths, byte-ish counts).
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    # HELP text escaping per the text format: backslash and newline only
    # (quotes are legal there). User-supplied strings otherwise corrupt
    # the exposition into unparseable extra lines.
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonically increasing value (one labeled child)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable value that can go up and down (one labeled child)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (one labeled child).

    Buckets are upper bounds; an implicit +Inf bucket always exists.
    ``snapshot()`` returns CUMULATIVE counts in exposition order.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)  # per-bucket, last = +Inf
        self._sum = 0.0
        self._count = 0
        # OpenMetrics exemplars: bucket index -> (labels, value, wall ts).
        # Only the LAST exemplar per bucket is kept — exactly enough to
        # link a latency bucket back to a recent trace id.
        self._exemplars: Dict[int, Tuple[Dict[str, str], float, float]] = {}

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar:
                self._exemplars[i] = (dict(exemplar), v, time.time())

    def exemplars(self) -> Dict[int, Tuple[Dict[str, str], float, float]]:
        """Per-bucket-index exemplars (non-cumulative indexing, last index
        = +Inf), as rendered by ``exposition(exemplars=True)``."""
        with self._lock:
            return dict(self._exemplars)

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, running = [], 0
        for n in counts:
            running += n
            cum.append(running)
        return cum, s, c

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """A named metric plus its labeled children.

    With no label names the family owns exactly one (eagerly created)
    child and proxies its methods, so ``registry.counter("x").inc()``
    works directly; with labels, ``family.labels(route="/predict")``
    returns (creating on first use) the child for those label values.
    """

    def __init__(self, name: str, help_text: str, kind: str,
                 label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.label_names:
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self._buckets or DEFAULT_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **label_values):
        if set(label_values) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {list(self.label_names)}, "
                f"got {sorted(label_values)}")
        key = tuple(str(label_values[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # ---- no-label proxies ------------------------------------------------
    def _only(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled "
                             f"{list(self.label_names)}; call .labels(...)")
        return self._children[()]

    def inc(self, amount: float = 1.0):
        self._only().inc(amount)

    def dec(self, amount: float = 1.0):
        self._only().dec(amount)

    def set(self, value: float):
        self._only().set(value)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None):
        self._only().observe(value, exemplar=exemplar)

    @property
    def value(self) -> float:
        return self._only().value

    @property
    def count(self) -> int:
        return self._only().count

    @property
    def sum(self) -> float:
        return self._only().sum


class MetricsRegistry:
    """Process-wide instrument registry.

    Registration is idempotent: asking for an existing (name, kind) returns
    the existing family (so modules can look instruments up lazily without
    coordinating creation order); re-registering a name as a different kind
    or with different labels raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _register(self, name: str, help_text: str, kind: str,
                  labels: Sequence[str], buckets=None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {list(fam.label_names)}")
                return fam
            fam = MetricFamily(name, help_text, kind, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help_text, "counter", labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help_text, "gauge", labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> MetricFamily:
        return self._register(name, help_text, "histogram", labels, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # ---- exposition ------------------------------------------------------
    def exposition(self, exemplars: bool = False) -> str:
        """The whole registry in the Prometheus text format (0.0.4).

        ``exemplars=True`` appends OpenMetrics-style exemplars to histogram
        bucket lines (``... 7 # {trace_id="ab12"} 0.031 1712345678.9``) —
        only valid under the OpenMetrics content type, so the gateway gates
        it behind ``GET /metrics?exemplars=1`` and the default scrape stays
        plain 0.0.4.
        """
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children():
                pairs = [f'{n}="{_escape_label(v)}"'
                         for n, v in zip(fam.label_names, key)]
                if fam.kind == "histogram":
                    cum, s, c = child.snapshot()
                    ex = child.exemplars() if exemplars else {}
                    bounds = [_fmt(b) for b in child.buckets] + ["+Inf"]
                    for i, (bound, n) in enumerate(zip(bounds, cum)):
                        lbl = ",".join(pairs + [f'le="{bound}"'])
                        line = f"{fam.name}_bucket{{{lbl}}} {n}"
                        if i in ex:
                            elabels, ev, ets = ex[i]
                            epairs = ",".join(
                                f'{k}="{_escape_label(v)}"'
                                for k, v in sorted(elabels.items()))
                            line += (f" # {{{epairs}}} {_fmt(ev)} "
                                     f"{ets:.3f}")
                        out.append(line)
                    suffix = "{" + ",".join(pairs) + "}" if pairs else ""
                    out.append(f"{fam.name}_sum{suffix} {_fmt(s)}")
                    out.append(f"{fam.name}_count{suffix} {c}")
                else:
                    suffix = "{" + ",".join(pairs) + "}" if pairs else ""
                    out.append(f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(out) + "\n"
