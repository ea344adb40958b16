"""MetricsListener — bridges the listener bus into the metrics registry.

Counterpart of ``deeplearning4j_tpu/monitoring/listener.py``: the
per-iteration observations of StatsListener and PerformanceListener (score,
iteration wall time, host RSS, device memory) land in the metrics
registry, so a scrape and a bench readout read one source of truth.

Attaching this listener is itself the opt-in: it records whatever
``DL4J_TORCH_MONITORING`` says (that flag gates only the implicit fit-loop
hooks). It does NOT touch ``dl4j_train_iterations_total`` /
``dl4j_train_device_step_seconds``: those belong to the fit-loop monitor,
and counting them twice when both are active would corrupt rates.
"""

from __future__ import annotations

import time
from typing import Optional

import deeplearning4j_tpu_torch.monitoring as monitoring
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class MetricsListener(TrainingListener):
    """Score / throughput / system metrics into a MetricsRegistry.

    ``sysmetrics_every``: sample host RSS and the model's device memory
    every N iterations (a /proc read and an allocator query).
    """

    def __init__(self, registry=None, sysmetrics_every: int = 10):
        self._registry = registry
        self.sysmetrics_every = max(1, sysmetrics_every)
        self._last_time: Optional[float] = None
        self._inst = None

    def _instruments(self):
        reg = self._registry or monitoring.registry()
        if self._inst is None or self._inst["reg"] is not reg:
            # the JAX package's families and help texts, word for word
            self._inst = {
                "reg": reg,
                "score": reg.gauge(
                    "dl4j_train_score",
                    "Training loss/score of the latest iteration"),
                "iter_seconds": reg.histogram(
                    "dl4j_train_iteration_seconds",
                    "Wall time between successive iteration_done callbacks"),
                "epochs": reg.counter(
                    "dl4j_train_epochs_total", "Completed training epochs"),
                "rss": reg.gauge(
                    "dl4j_host_rss_mb", "Host resident set size (MiB)"),
                "dev_mem": reg.gauge(
                    "dl4j_device_mem_in_use_mb",
                    "PJRT device memory in use (MiB), when exposed"),
            }
        return self._inst

    def iteration_done(self, model, iteration: int, epoch: int, score: float):
        inst = self._instruments()
        inst["score"].set(float(score))
        now = time.perf_counter()
        if self._last_time is not None:
            inst["iter_seconds"].observe(now - self._last_time)
        self._last_time = now
        if iteration % self.sysmetrics_every == 0:
            from deeplearning4j_tpu_torch.common.sysmetrics import (
                system_metrics,
            )

            dev = getattr(model, "device", None)
            sm = system_metrics(dev if dev is not None else "cpu")
            inst["rss"].set(sm.get("host_rss_mb", 0.0))
            if "device_mem_in_use_mb" in sm:
                inst["dev_mem"].set(sm["device_mem_in_use_mb"])

    def on_epoch_end(self, model, epoch: int):
        self._instruments()["epochs"].inc()
        self._last_time = None  # epoch boundary: don't count eval/reset gaps
