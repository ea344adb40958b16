"""Deterministic fault injection: failure as a seeded, testable input.

Counterpart of ``deeplearning4j_tpu/faults/__init__.py``, copied: the same
classes, spec grammar, seeded firing and batch poisoning, so a plan with
the same spec and seed fires at the same calls and poisons the same bytes
in both packages. The port's injection points: ``ckpt_io`` and
``ckpt_corrupt`` (``util/checkpoints.py``), ``data_io`` (the dataset
iterators and the MNIST reader) and ``nan_grad`` / ``loss_spike`` /
``data_corrupt`` (``fit_batch``'s input path, :func:`poison_batch`),
``infer_crash`` / ``worker_crash`` / ``slow_worker`` (the serving tier's
``ParallelInference`` workers), ``preempt`` (``GenerationEngine.step`` and
``FaultTolerantTrainer.fit_batch``, handed to ``serving/lifecycle.py``),
``coord_connect`` (``parallel.initialize_distributed``) and
``worker_crash`` / ``collective_delay`` (the local-SGD rounds'
``parallel.spark.RoundSupervisor``). ``traffic_spike`` parses and fires as
in the JAX package.

Spec grammar (``DL4J_TORCH_FAULTS`` or :func:`configure`)::

    spec     := entry (";" entry)*
    entry    := class ":" rate ["@" predicate]
    rate     := float in (0,1)  -> per-call probability (seeded RNG)
              | int >= 1        -> fire on the first N matching calls
    predicate:= var op number   with op in  == != >= <= > <

``DL4J_TORCH_FAULTS_SEED`` (default 0) seeds the probability draws;
``DL4J_TORCH_FAULTS_DELAY_S`` (default 0.05) is the simulated straggler
delay. With no spec, :func:`active` returns None and every injection point
is a single None check. Each injected fault counts in
``dl4j_faults_injected_total{cls}`` (monitoring on) and is recorded as a
``fault_injected`` flight-recorder event (recorder armed).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
from collections import Counter as _Counter
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.faults.retry import RetryPolicy  # noqa: F401 (re-export)

CLASSES = ("ckpt_io", "ckpt_corrupt", "coord_connect", "collective_delay",
           "worker_crash", "data_io", "infer_crash", "slow_worker",
           "traffic_spike", "preempt", "nan_grad", "loss_spike",
           "data_corrupt")

ENV_SPEC = "DL4J_TORCH_FAULTS"
ENV_SEED = "DL4J_TORCH_FAULTS_SEED"
ENV_DELAY = "DL4J_TORCH_FAULTS_DELAY_S"


class InjectedFault(Exception):
    """Marker base: every exception raised by an injection point derives
    from it, so tests (and retry policies) can tell injected failures from
    organic ones."""


class CheckpointIOFault(InjectedFault, OSError):
    """Injected checkpoint save/restore I/O failure (``ckpt_io``)."""


class DataReadFault(InjectedFault, OSError):
    """Injected dataset read failure (``data_io``)."""


class CoordinatorConnectFault(InjectedFault, ConnectionRefusedError):
    """Injected coordinator connection refusal (``coord_connect``)."""


class InferenceWorkerCrash(InjectedFault, RuntimeError):
    """Injected inference-worker crash (``infer_crash``)."""


class PreemptionFault(InjectedFault, RuntimeError):
    """Injected preemption (``preempt``) with no lifecycle manager to
    deliver it to — the raising driver is expected to die (or self-preempt)
    exactly as a SIGTERM'd process would."""


_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
}


@dataclasses.dataclass
class FaultRule:
    """One parsed spec entry. ``rate`` < 1 is a per-call probability;
    >= 1 is an absolute fire budget over matching calls."""

    cls: str
    rate: float
    var: Optional[str] = None
    op: Optional[str] = None
    value: float = 0.0
    fired: int = 0
    calls: int = 0

    def matches(self, ctx: Dict[str, float]) -> bool:
        if self.var is None:
            return True
        v = ctx.get(self.var)
        if v is None:
            return False
        return _OPS[self.op](float(v), self.value)


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse the ``cls:rate[@cond]`` grammar; raises ValueError with the
    offending entry on any malformed input."""
    rules: List[FaultRule] = []
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if "@" in entry:
            head, cond = entry.split("@", 1)
        else:
            head, cond = entry, None
        try:
            cls, rate_s = head.split(":", 1)
        except ValueError:
            raise ValueError(f"fault spec entry {entry!r}: expected "
                             f"'class:rate[@cond]'") from None
        cls = cls.strip()
        if cls not in CLASSES:
            raise ValueError(f"fault spec entry {entry!r}: unknown class "
                             f"{cls!r} (known: {', '.join(CLASSES)})")
        try:
            rate = float(rate_s)
        except ValueError:
            raise ValueError(f"fault spec entry {entry!r}: rate {rate_s!r} "
                             f"is not a number") from None
        if rate <= 0:
            raise ValueError(f"fault spec entry {entry!r}: rate must be > 0")
        rule = FaultRule(cls=cls, rate=rate)
        if cond is not None:
            cond = cond.strip()
            for op in ("==", "!=", ">=", "<=", ">", "<"):  # longest first
                if op in cond:
                    var, val = cond.split(op, 1)
                    rule.var, rule.op = var.strip(), op
                    try:
                        rule.value = float(val)
                    except ValueError:
                        raise ValueError(
                            f"fault spec entry {entry!r}: predicate value "
                            f"{val.strip()!r} is not a number") from None
                    break
            else:
                raise ValueError(f"fault spec entry {entry!r}: predicate "
                                 f"{cond!r} has no comparison operator")
        rules.append(rule)
    return rules


class FaultPlan:
    """A configured, seeded set of fault rules. Thread-safe: injection
    points fire from worker threads (serving) and the main loop alike."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 delay_s: float = 0.05):
        self.rules = list(rules)
        self.seed = int(seed)
        self.delay_s = float(delay_s)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.injected: _Counter = _Counter()   # fired count per class

    def fires(self, cls: str, **ctx) -> bool:
        """Decide (and consume budget) for one call at injection point
        ``cls``. Context vars feed the rule predicates; an auto ``call``
        var counts matching calls per rule (1-based)."""
        with self._lock:
            hit = False
            for rule in self.rules:
                if rule.cls != cls:
                    continue
                rule.calls += 1
                if "call" not in ctx:
                    ctx = dict(ctx, call=rule.calls)
                if not rule.matches(ctx):
                    continue
                if rule.rate < 1.0:
                    if self._rng.random() < rule.rate:
                        rule.fired += 1
                        hit = True
                        break
                elif rule.fired < int(rule.rate):
                    rule.fired += 1
                    hit = True
                    break
            if hit:
                self.injected[cls] += 1
        if hit:
            from deeplearning4j_tpu_torch import monitoring

            mon = monitoring.recovery_monitor()
            if mon is not None:
                mon.faults_injected.labels(cls=cls).inc()
            rec = monitoring.flight.recorder()
            if rec is not None:
                rec.record("fault_injected", cls=cls,
                           **{k: v for k, v in ctx.items()
                              if isinstance(v, (int, float, str))})
        return hit

    def describe(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "delay_s": self.delay_s,
                "rules": [dataclasses.asdict(r) for r in self.rules],
                "injected": dict(self.injected),
            }


_PLAN: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    """The installed plan, or None when fault injection is off — callers
    skip ALL injection work on None (the zero-overhead contract)."""
    return _PLAN


def configure(spec: Optional[str] = None, seed: Optional[int] = None,
              delay_s: Optional[float] = None) -> Optional[FaultPlan]:
    """Install a fault plan from a spec string (or the environment when
    ``spec`` is None). An empty/absent spec uninstalls. Returns the plan."""
    global _PLAN
    if spec is None:
        spec = os.environ.get(ENV_SPEC, "")
    if seed is None:
        seed = int(os.environ.get(ENV_SEED, "0") or 0)
    if delay_s is None:
        delay_s = float(os.environ.get(ENV_DELAY, "0.05") or 0.05)
    rules = parse_spec(spec) if spec else []
    _PLAN = FaultPlan(rules, seed=seed, delay_s=delay_s) if rules else None
    return _PLAN


def reset() -> None:
    """Back to the environment configuration (test isolation hook)."""
    configure(None)


def _poison_features(x, mode: str):
    """Return a poisoned copy of a features entry (host numpy). Multi-input
    lists/dicts (the ComputationGraph shape) poison their first float
    entry; integer features (token ids) are left alone — there is nothing
    numeric to corrupt before the embedding lookup."""
    import numpy as np

    if isinstance(x, dict):
        for k, v in x.items():
            p = _poison_features(v, mode)
            if p is not v:
                return {**x, k: p}
        return x
    if isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            p = _poison_features(v, mode)
            if p is not v:
                out = list(x)
                out[i] = p
                return out
        return x
    a = np.array(x, copy=True)
    if not np.issubdtype(a.dtype, np.floating) or a.size == 0:
        return x
    flat = a.reshape(-1)
    if mode == "nan_grad":
        flat[:: max(1, a.size // 4)] = np.nan
    elif mode == "loss_spike":
        flat *= 1e4
    else:  # data_corrupt: large, structured, FINITE garbage
        flat[:] = np.sign(flat + 0.5) * (np.abs(flat) * 97.0 + 31.0)
    return a


def poison_batch(plan: FaultPlan, x, y, step: int):
    """Train-step input-path injection for the numeric fault classes
    (``nan_grad`` / ``loss_spike`` / ``data_corrupt``). Called by the fit
    loops right after unpacking a batch, BEFORE the guardrail's replay
    ring records it — so a rollback replays the poisoned bytes exactly
    and the bisection can name them. Returns (x, y)."""
    for cls in ("nan_grad", "loss_spike", "data_corrupt"):
        if plan.fires(cls, step=step):
            x = _poison_features(x, cls)
    return x, y


@contextlib.contextmanager
def injected(spec: str, seed: int = 0, delay_s: float = 0.05):
    """Scoped programmatic injection::

        with faults.injected("ckpt_io:2") as plan:
            ...                       # first two checkpoint I/Os fail
        assert plan.injected["ckpt_io"] == 2
    """
    global _PLAN
    prev = _PLAN
    plan = FaultPlan(parse_spec(spec), seed=seed, delay_s=delay_s)
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = prev


# install from the environment at import (mirrors monitoring's env flag)
configure(None)

__all__ = [
    "CLASSES", "FaultPlan", "FaultRule", "RetryPolicy",
    "InjectedFault", "CheckpointIOFault", "DataReadFault",
    "CoordinatorConnectFault", "InferenceWorkerCrash", "PreemptionFault",
    "active", "configure", "injected", "parse_spec", "poison_batch",
    "reset",
]
