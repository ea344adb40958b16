"""Preemption-aware serving lifecycle: SIGTERM -> drain -> journal -> exit 0.

Counterpart of ``deeplearning4j_tpu/serving/lifecycle.py``, copied. The
engine's preempt point (``GenerationEngine.step``: the ``faults`` class
``preempt`` calls :func:`deliver_preemption`) is the port's too.

A cluster scheduler preempts with a SIGTERM and a grace window; a
process that uses the window well loses NOTHING: in-flight generation
sessions are journaled (generation/sessions.py) for resume-on-restart,
training state gets an emergency checkpoint, and the process exits 0 so the
supervisor restarts it cleanly instead of backing off a "crash".

    manager = (LifecycleManager(grace_s=20.0)
               .register_gateway(gw)
               .register_checkpoint(trainer_save_fn)
               .install())                    # SIGTERM handler
    ...
    # on SIGTERM (or faults class ``preempt``): drain, journal, checkpoint

The drain sequence inside the grace budget:

1. every registered gateway stops admitting (``/readyz`` flips to 503 so
   balancers eject the instance);
2. every generation engine is shut down with ``reason="preempted"`` —
   open streams get a terminal ``finish_reason: "preempted"`` line and
   their session journal records stay OPEN on disk;
3. session journals are fsync'd;
4. gateways finish their graceful stop with whatever budget remains;
5. emergency-checkpoint callbacks run (the trainer hook);
6. ``exit_fn(0)`` if one was configured (``sys.exit`` in production;
   tests leave it None and assert on state instead).

The whole sequence runs on a dedicated ``dl4j-preempt`` thread — the
trigger may be a signal handler or a fault injected INSIDE an engine's own
step loop (faults class ``preempt``), neither of which may block on the
drain. :func:`deliver_preemption` is that injection point's entry: with an
installed manager it starts the drain; unmanaged it raises
:class:`~deeplearning4j_tpu_torch.faults.PreemptionFault` so the engine
loop dies mid-decode exactly like an unhandled SIGTERM.

Fast restart: re-create the journal, resume before traffic —
``gateway.register_generator(name, engine, sessions=path)`` replays the
journal into the fresh engine (see docs/fault_tolerance.md).
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch import faults, monitoring
from deeplearning4j_tpu_torch.monitoring import flight


class LifecycleManager:
    """Owns the preemption grace budget and the drain choreography."""

    def __init__(self, grace_s: float = 20.0,
                 exit_fn: Optional[Callable[[int], None]] = None):
        self.grace_s = float(grace_s)
        self.exit_fn = exit_fn
        self._gateways: List = []
        self._engines: List = []
        self._journals: List = []
        self._checkpoints: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.preempted = threading.Event()
        self.reason: Optional[str] = None
        self.errors: List[str] = []
        self._installed_signals: List[int] = []

    # ------------------------------------------------------- registration
    def register_gateway(self, gateway) -> "LifecycleManager":
        """Drain this gateway (admission off, engines preempted, session
        journals synced) inside the grace budget."""
        self._gateways.append(gateway)
        return self

    def register_engine(self, engine) -> "LifecycleManager":
        """A bare GenerationEngine (no gateway in front of it)."""
        self._engines.append(engine)
        return self

    def register_journal(self, journal) -> "LifecycleManager":
        self._journals.append(journal)
        return self

    def register_checkpoint(self, fn: Callable[[], None]
                            ) -> "LifecycleManager":
        """Emergency-checkpoint callback (e.g. a trainer save); runs after
        the serving drain, still inside the grace budget."""
        self._checkpoints.append(fn)
        return self

    # ------------------------------------------------------------ install
    def install(self, signals=(signal.SIGTERM,)) -> "LifecycleManager":
        """Install as the process preemption handler: the given signals
        (and the faults ``preempt`` class via :func:`deliver_preemption`)
        trigger :meth:`preempt`. No-op for the signal part when not on the
        main thread (tests installing from workers still get the faults
        path)."""
        global _MANAGER
        for s in signals:
            try:
                signal.signal(s, self._on_signal)
                self._installed_signals.append(int(s))
            except ValueError:
                pass  # not the main thread: faults delivery still works
        _MANAGER = self
        return self

    def uninstall(self) -> None:
        global _MANAGER
        for s in self._installed_signals:
            try:
                signal.signal(s, signal.SIG_DFL)
            except ValueError:
                pass
        self._installed_signals = []
        if _MANAGER is self:
            _MANAGER = None

    def _on_signal(self, signum, frame) -> None:
        del frame
        self.preempt(reason=f"signal:{signum}")

    # ------------------------------------------------------------ preempt
    def preempt(self, reason: str = "preempt", wait: bool = False,
                **ctx) -> "LifecycleManager":
        """Begin (or join) the grace-budgeted drain. Idempotent: a second
        trigger while draining just observes the first. ``wait=True``
        blocks until the drain completes (tests; signal handlers and
        injection points leave it False)."""
        with self._lock:
            if self._thread is None:
                self.reason = reason
                rec = flight.recorder()
                if rec is not None:
                    rec.record("preempt", severity="warn", reason=reason,
                               grace_s=self.grace_s,
                               **{k: v for k, v in ctx.items()
                                  if isinstance(v, (int, float, str))})
                mon = monitoring.recovery_monitor()
                if mon is not None:
                    mon.recovery_total.labels(component="lifecycle",
                                              outcome="preempted").inc()
                self._thread = threading.Thread(
                    target=self._drain, name="dl4j-preempt", daemon=True)
                self._thread.start()
        if wait:
            self.preempted.wait()
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.preempted.wait(timeout)

    def _note(self, err: BaseException) -> None:
        self.errors.append(f"{type(err).__name__}: {err}")

    def _drain(self) -> None:
        deadline = time.monotonic() + self.grace_s

        def remaining() -> float:
            return max(0.0, deadline - time.monotonic())

        # 1. stop admitting everywhere first — the budget pays down
        #    in-flight work, not new arrivals
        for gw in self._gateways:
            gw._draining = True
        # 2. preempt every engine: open streams end "preempted", session
        #    journal records stay open for the restart to resume
        engines = list(self._engines)
        for gw in self._gateways:
            engines.extend(gw._generators.values())
        for eng in engines:
            try:
                eng.shutdown(timeout=remaining(), reason="preempted")
            except Exception as e:  # keep draining the rest of the fleet
                self._note(e)
        # 3. everything journaled so far becomes durable
        journals = list(self._journals)
        for gw in self._gateways:
            journals.extend(getattr(gw, "_sessions", {}).values())
        for eng in engines:
            if getattr(eng, "journal", None) is not None:
                journals.append(eng.journal)
        seen = set()
        for j in journals:
            if id(j) in seen:
                continue
            seen.add(id(j))
            try:
                j.sync()
            except Exception as e:
                self._note(e)
        # 4. finish the gateway stop with whatever budget remains
        for gw in self._gateways:
            try:
                gw.stop(drain=True, timeout=remaining())
            except Exception as e:
                self._note(e)
        # 5. emergency checkpoints (trainer hook)
        for fn in self._checkpoints:
            try:
                fn()
            except Exception as e:
                self._note(e)
        rec = flight.recorder()
        if rec is not None:
            rec.record("preempt_drained", reason=self.reason,
                       errors=len(self.errors))
        self.preempted.set()
        # 6. exit 0: a preemption is not a crash
        if self.exit_fn is not None:
            self.exit_fn(0)

    def describe(self) -> dict:
        return {"grace_s": self.grace_s,
                "preempted": self.preempted.is_set(),
                "reason": self.reason,
                "gateways": len(self._gateways),
                "engines": len(self._engines),
                "checkpoints": len(self._checkpoints),
                "errors": list(self.errors)}


_MANAGER: Optional[LifecycleManager] = None


def manager() -> Optional[LifecycleManager]:
    """The installed manager, or None — injection points do exactly one
    None check (the zero-overhead contract's lifecycle edition)."""
    return _MANAGER


def deliver_preemption(source: str = "", **ctx):
    """The faults ``preempt`` class lands here (engine step loop, trainer
    fit loop). With a manager installed the grace-budgeted drain starts on
    its own thread and the caller keeps stepping until the drain cancels
    it; unmanaged, raise — the engine loop dies mid-decode like a process
    that never handled SIGTERM."""
    mgr = _MANAGER
    if mgr is None:
        rec = flight.recorder()
        if rec is not None:
            rec.record("preempt", severity="warn", source=source,
                       reason="injected:unmanaged",
                       **{k: v for k, v in ctx.items()
                          if isinstance(v, (int, float, str))})
        raise faults.PreemptionFault(
            f"injected preemption at {source or 'unknown'} "
            f"({', '.join(f'{k}={v}' for k, v in ctx.items())})")
    return mgr.preempt(reason=f"injected:{source or 'fault'}", **ctx)


def reset() -> None:
    """Drop the installed manager (test isolation hook)."""
    global _MANAGER
    if _MANAGER is not None:
        _MANAGER.uninstall()
    _MANAGER = None


__all__ = ["LifecycleManager", "deliver_preemption", "manager", "reset"]
