"""OpProfiler analog, numerics checks, NaN panic and the torch.profiler
trace.

Counterpart of ``deeplearning4j_tpu/profiler/profiler.py``. Where the JAX
package blocks on ``jax.block_until_ready``, :meth:`OpProfiler.time_fn`
synchronizes the card (``torch.cuda.synchronize``) so a section times the
device work it queued; ``trace`` records the device timeline with
``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ProfilerConfig:
    """org.nd4j.linalg.profiler.ProfilerConfig analog."""

    check_for_nan: bool = False
    check_for_inf: bool = False
    stack_trace: bool = False  # accepted for parity; python tb is implicit


def _sync(tree) -> None:
    """Wait for the card if any tensor of ``tree`` lies on it."""
    for _, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class OpProfiler:
    """Aggregated timing per labeled section (OpProfiler.getInstance()).

    Usage::

        prof = OpProfiler()
        loss = prof.time_fn("train_step", step, batch)   # synced
        prof.summary()

    Timings are host wall clock around device work, synchronized; for the
    device timeline use :func:`trace`.
    """

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.invocations: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)
            self.invocations[name] += 1

    def time_fn(self, name: str, fn, *args, sync: bool = True, **kwargs):
        with self.section(name):
            out = fn(*args, **kwargs)
            if sync:
                _sync(out)
        if self.config.check_for_nan or self.config.check_for_inf:
            check_numerics(out, name=name, inf=self.config.check_for_inf)
        return out

    def stats(self, name: str) -> Dict[str, float]:
        ts = np.asarray(self.times[name])
        if ts.size == 0:
            return {}
        return {"count": int(ts.size), "total_s": float(ts.sum()),
                "mean_ms": float(ts.mean() * 1e3),
                "p50_ms": float(np.percentile(ts, 50) * 1e3),
                "p99_ms": float(np.percentile(ts, 99) * 1e3)}

    def summary(self) -> str:
        lines = [f"{'section':<30}{'count':>8}{'mean ms':>12}{'total s':>10}"]
        for name in sorted(self.times, key=lambda n: -sum(self.times[n])):
            s = self.stats(name)
            lines.append(f"{name:<30}{s['count']:>8}{s['mean_ms']:>12.3f}"
                         f"{s['total_s']:>10.3f}")
        return "\n".join(lines)

    def reset(self):
        self.times.clear()
        self.invocations.clear()


def _leaves_with_path(tree, path: str = ""):
    """(path, leaf) pairs of nested dicts, lists and tuples, the path
    spelled as ``jax.tree_util.keystr`` spells it (``[0]['W']``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_numerics(tree, name: str = "value", inf: bool = True):
    """Raise FloatingPointError on NaN (and optionally Inf) anywhere in a
    tree of tensors or arrays, naming the leaf path: the OpProfiler PANIC
    mode, applied at step boundaries. Reads each leaf on the host."""
    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad_nan = bool(torch.isnan(leaf).any())
            bad_inf = bool(torch.isinf(leaf).any())
        else:
            a = np.asarray(leaf)
            if not np.issubdtype(a.dtype, np.floating):
                continue
            bad_nan, bad_inf = bool(np.isnan(a).any()), bool(np.isinf(a).any())
        if bad_nan:
            raise FloatingPointError(f"NaN detected in {name} at {path}")
        if inf and bad_inf:
            raise FloatingPointError(f"Inf detected in {name} at {path}")
    return tree


@contextlib.contextmanager
def nan_panic():
    """Scoped ``torch.autograd.set_detect_anomaly(True, check_nan=True)``:
    a backward op that returns NaN raises, with the forward op that made
    it in the traceback. The limit: anomaly mode checks what autograd's
    backward functions return, so a NaN is reported at the first backward
    op that produces it, not where a forward op first computes it (the JAX
    package's ``jax_debug_nans`` re-runs the forward primitive); a forward
    without a backward is not checked. It also slows every backward."""
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        yield


@contextlib.contextmanager
def trace(logdir: str):
    """The device timeline of the block via ``torch.profiler`` (CPU and,
    where there is a card, CUDA activities), written as a Chrome trace to
    ``<logdir>/trace.json`` (Perfetto-loadable). The profile object is
    yielded; its ``trace_path`` names the file."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    prof.trace_path = path
