"""Training listeners — the metrics/observability bus.

Reference analog: org.deeplearning4j.optimize.api.TrainingListener and
org.deeplearning4j.optimize.listeners.{ScoreIterationListener,
PerformanceListener, CheckpointListener, CollectScoresIterationListener,
EvaluativeListener}. Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``:
the same hook points, host-side only; they observe the step's score, never
reach inside the step.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional


class TrainingListener:
    # Async dispatch (optimize/async_dispatch) defers iteration_done to
    # drain time so the fit loop never blocks on the score. A listener that
    # acts on CURRENT model state per iteration (evaluation, checkpointing)
    # sets this True: its presence forces fit_batch onto the eager (sync)
    # path, so iteration_done fires with the model exactly at that step.
    needs_eager_score = False

    def iteration_done(self, model, iteration: int, epoch: int, score: float):
        pass

    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def on_fit_end(self, model):
        """Called once when a fit() call completes (all epochs done) —
        the hook checkpoint/flush listeners use to capture final state."""
        pass


class ScoreIterationListener(TrainingListener):
    """Print score every N iterations (ScoreIterationListener)."""

    def __init__(self, print_every: int = 10, log: Callable[[str], None] = print):
        self.print_every = max(1, print_every)
        self.log = log

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_every == 0:
            self.log(f"Score at iteration {iteration} (epoch {epoch}): {float(score):.6f}")


class CollectScoresListener(TrainingListener):
    """Collect (iteration, score) pairs (CollectScoresIterationListener)."""

    def __init__(self):
        self.scores: list[tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append((iteration, float(score)))


class PerformanceListener(TrainingListener):
    """Iterations/sec + samples/sec + system metrics (PerformanceListener —
    the reference reports iter/sec alongside JVM/GC memory; here the
    analogs are host RSS and the memory PyTorch holds on the card)."""

    def __init__(self, frequency: int = 10, log: Callable[[str], None] = print,
                 report_system: bool = True):
        self.frequency = max(1, frequency)
        self.log = log
        self.report_system = report_system
        self._t0: Optional[float] = None
        self._iters = 0
        self.batch_size = 0
        self.last_iters_per_sec = 0.0
        self.last_samples_per_sec = 0.0
        self.last_system: dict = {}

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._iters = 0
            return
        self._iters += 1
        if self._iters % self.frequency == 0:
            dt = now - self._t0
            self.last_iters_per_sec = self._iters / dt
            self.last_samples_per_sec = self.last_iters_per_sec * self.batch_size
            msg = (
                f"iter {iteration}: {self.last_iters_per_sec:.2f} it/s"
                + (f", {self.last_samples_per_sec:.1f} samples/s" if self.batch_size else "")
            )
            if self.report_system:
                self.last_system = _system_metrics(model)
                msg += f", rss {self.last_system.get('host_rss_mb', 0):.0f}MB"
                dev = self.last_system.get("device_mem_in_use_mb")
                if dev is not None:
                    msg += f", device {dev:.0f}MB"
            self.log(msg)
            self._t0 = now
            self._iters = 0


class EvaluativeListener(TrainingListener):
    """Run evaluation every N iterations (EvaluativeListener)."""

    needs_eager_score = True  # evaluates the model AT each iteration

    def __init__(self, iterator_factory, frequency: int = 100, evaluator_factory=None,
                 log: Callable[[str], None] = print):
        self.iterator_factory = iterator_factory
        self.frequency = max(1, frequency)
        self.evaluator_factory = evaluator_factory
        self.log = log
        self.results: list[Any] = []

    def iteration_done(self, model, iteration, epoch, score):
        if iteration == 0 or iteration % self.frequency != 0:
            return
        it = self.iterator_factory() if callable(self.iterator_factory) else self.iterator_factory
        ev = model.evaluate(it, evaluation=self.evaluator_factory() if self.evaluator_factory else None)
        self.results.append((iteration, ev))
        self.log(f"eval @ iter {iteration}: accuracy={ev.accuracy():.4f}")


class CheckpointListener(TrainingListener):
    """Periodic model saves with keep-last-N (CheckpointListener)."""

    needs_eager_score = True  # saves the model AT each checkpoint iteration

    def __init__(self, directory: str, save_every_n_iterations: int = 1000,
                 keep_last: int = 3):
        import os

        self.directory = directory
        self.every = save_every_n_iterations
        self.keep_last = keep_last
        self.saved: list[str] = []
        os.makedirs(directory, exist_ok=True)

    def iteration_done(self, model, iteration, epoch, score):
        import os

        if iteration == 0 or iteration % self.every != 0:
            return
        path = os.path.join(self.directory, f"checkpoint_iter_{iteration}.zip")
        model.save(path)
        self.saved.append(path)
        while len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            if os.path.exists(old):
                os.remove(old)


def _system_metrics(model) -> dict:
    """``common/sysmetrics.system_metrics`` of the model's device: host
    RSS, and for a model on the card the memory PyTorch has allocated
    there, its peak and the card's total."""
    from deeplearning4j_tpu_torch.common.sysmetrics import system_metrics

    dev = getattr(model, "device", None)
    return system_metrics(dev if dev is not None else "cpu")
