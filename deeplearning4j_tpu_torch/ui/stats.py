"""StatsListener — the dashboard's data producer.

Counterpart of ``deeplearning4j_tpu/ui/stats.py``. The records are the JAX
package's, key for key: the same scores, the same sampled iterations, the
same histogram bins over the same layer names. A sampled iteration brings
the parameters to the host in one device-to-host copy (every leaf flattened
and joined on the device first), not one copy (and one sync) a leaf, and
reads the f32 parameters the step updates, not a compute-type copy. Leaves
are read in ``jax.tree_util.tree_leaves``' order (dict keys sorted), so
``params_mean_magnitude`` adds its per-leaf sums in the JAX package's order.

Reference analog: org.deeplearning4j.ui.stats.StatsListener — per-iteration
score, timing, parameter/gradient/update statistics (mean magnitude,
histograms), and system/memory info pushed into a StatsStorage.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.storage import StatsStorage


def _leaves(tree) -> list:
    """The leaves in ``jax.tree_util.tree_leaves``' order: dict keys sorted,
    None dropped, a ``tree_flatten`` node's children in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    if hasattr(tree, "tree_flatten"):
        return _leaves(list(tree.tree_flatten()[0]))
    return [tree]


def _named_layers(model):
    """[(name, key into ``model.params``)] for MLN (indexed) or
    ComputationGraph (named), the JAX package's names and order."""
    params = model.params
    if isinstance(params, dict):
        return [(k, k) for k, v in params.items() if v]
    return [(f"{i}_{type(l).__name__}", i)
            for i, (l, p) in enumerate(zip(model.layers, params)) if p]


def _host_params(model) -> Tuple[List[np.ndarray], Dict]:
    """(every leaf of ``model.params`` as a host f32 array, in JAX's leaf
    order; {key into ``model.params``: its leaves joined}) from one
    device-to-host copy. The arrays are views of one host buffer."""
    params = model.params
    keys = sorted(params) if isinstance(params, dict) else range(len(params))
    per_key = [[a.detach().reshape(-1).float() for a in _leaves(params[k])]
               for k in keys]
    flat = [a for ls in per_key for a in ls]
    if not flat:
        return [], {}
    host = torch.cat(flat).cpu().numpy()
    leaves, by_key, off = [], {}, 0
    for k, ls in zip(keys, per_key):
        start = off
        for a in ls:
            leaves.append(host[off:off + a.numel()])
            off += a.numel()
        by_key[k] = host[start:off]
    return leaves, by_key


def _tree_stats(leaves: List[np.ndarray], prefix: str) -> Dict[str, float]:
    out = {}
    if not leaves:
        return out
    total, count = 0.0, 0
    for a in leaves:
        total += float(np.abs(a).sum())
        count += a.size
    out[f"{prefix}_mean_magnitude"] = total / max(count, 1)
    return out


def _histogram(a: np.ndarray, bins: int = 40):
    # drop non-finite entries: a diverged model (NaN/inf weights) must not
    # crash the monitoring listener (np.histogram raises on non-finite range)
    a = a[np.isfinite(a)]
    if a.size == 0:
        return None
    lo, hi = float(a.min()), float(a.max())
    if hi <= lo:
        hi = lo + 1e-12
    counts, _ = np.histogram(a, bins=bins, range=(lo, hi))
    return {"min": lo, "max": hi, "counts": counts.tolist()}


class StatsListener(TrainingListener):
    """Collects per-iteration stats into a StatsStorage.

    ``update_frequency`` mirrors the reference's listenerFrequency: array
    statistics (param magnitudes) are sampled every N iterations; score and
    timing are recorded every iteration.
    """

    # samples param stats AT each iteration (deferred delivery would read
    # later weights), and its iteration timing assumes per-step callbacks
    needs_eager_score = True

    def __init__(self, storage: StatsStorage, session_id: str = "default",
                 update_frequency: int = 10, collect_param_stats: bool = True,
                 collect_histograms: bool = True,
                 collect_system_stats: bool = True):
        self.storage = storage
        self.session_id = session_id
        self.update_frequency = max(1, update_frequency)
        self.collect_param_stats = collect_param_stats
        # host RSS + device memory scalar series (the reference UI's
        # system page)
        self.collect_system_stats = collect_system_stats
        # per-layer weight + update histograms (the reference UI's model
        # page): updates are param DELTAS between successive samples — the
        # same quantity the reference charts as "updates" (lr*gradient
        # accumulated over the sampling window), computed host-side so the
        # train step is untouched
        self.collect_histograms = collect_histograms
        self._last_time: Optional[float] = None
        self._prev_flat: Dict[str, np.ndarray] = {}

    def iteration_done(self, model, iteration: int, epoch: int, score: float):
        now = time.perf_counter()
        rec: Dict = {
            "session": self.session_id,
            "iteration": int(iteration),
            "epoch": int(epoch),
            "score": float(score),
            "timestamp": time.time(),
        }
        if self._last_time is not None:
            dt = now - self._last_time
            rec["iteration_time_ms"] = dt * 1e3
            if dt > 0:
                rec["iterations_per_sec"] = 1.0 / dt
        self._last_time = now
        if iteration % self.update_frequency == 0:
            if self.collect_system_stats:
                from deeplearning4j_tpu_torch.common.sysmetrics import (
                    system_metrics)

                rec.update(system_metrics(getattr(model, "device", None)))
            if self.collect_param_stats or self.collect_histograms:
                leaves, by_key = _host_params(model)
            if self.collect_param_stats:
                rec.update(_tree_stats(leaves, "params"))
            if self.collect_histograms:
                hists: Dict = {}
                for name, key in _named_layers(model):
                    flat = by_key[key]
                    entry = {"w": _histogram(flat)}
                    prev = self._prev_flat.get(name)
                    if prev is not None and prev.shape == flat.shape:
                        entry["u"] = _histogram(flat - prev)
                    self._prev_flat[name] = flat
                    hists[name] = entry
                rec["histograms"] = hists
        self.storage.put(rec)

    def on_epoch_end(self, model, epoch: int):
        self.storage.put({"session": self.session_id, "epoch_end": int(epoch),
                          "iteration": -1, "timestamp": time.time()})
