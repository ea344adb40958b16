"""Candidate generators + optimization runner.

Counterpart of ``deeplearning4j_tpu/arbiter/runner.py``, copied (host numpy, no
framework): the same seeds give the same draws.

Reference analog: org.deeplearning4j.arbiter.optimize.runner.
LocalOptimizationRunner with RandomSearchGenerator /
GridSearchCandidateGenerator, ScoreFunction, and TerminationCondition
(MaxCandidatesCondition, MaxTimeCondition). The runner is model-agnostic:
``build_fn(hyperparams) -> model`` and ``score_fn(model) -> float`` — the
arbiter DL4J couples to MultiLayerConfiguration via its own layer spaces;
here any model/config factory composes.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class RandomSearchGenerator:
    def __init__(self, spaces: Dict[str, object], seed: int = 0):
        self.spaces = spaces
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            yield {k: s.sample(self._rng) for k, s in self.spaces.items()}


class GridSearchGenerator:
    """Cartesian product over per-space grids (discretization_count for
    continuous spaces, as in GridSearchCandidateGenerator)."""

    def __init__(self, spaces: Dict[str, object], discretization_count: int = 5):
        self.spaces = spaces
        self.n = discretization_count

    def __iter__(self):
        keys = list(self.spaces)
        grids = [self.spaces[k].grid(self.n) for k in keys]
        for combo in itertools.product(*grids):
            yield dict(zip(keys, combo))


@dataclasses.dataclass
class MaxCandidatesCondition:
    max_candidates: int

    def done(self, n_done: int, t_start: float) -> bool:
        return n_done >= self.max_candidates


@dataclasses.dataclass
class MaxTimeCondition:
    seconds: float

    def done(self, n_done: int, t_start: float) -> bool:
        return time.monotonic() - t_start >= self.seconds


@dataclasses.dataclass
class OptimizationResult:
    hyperparams: Dict
    score: float
    model: object
    index: int


class OptimizationRunner:
    """Sequential candidate evaluation with best-tracking.

    minimize=True treats score as loss (the reference's ScoreFunction
    minimizeScore flag).
    """

    def __init__(self, generator, build_fn: Callable[[Dict], object],
                 score_fn: Callable[[object], float],
                 termination_conditions: Optional[List] = None,
                 minimize: bool = True,
                 listeners: Optional[List[Callable]] = None):
        self.generator = generator
        self.build_fn = build_fn
        self.score_fn = score_fn
        self.conditions = termination_conditions or [MaxCandidatesCondition(10)]
        self.minimize = minimize
        self.listeners = listeners or []
        self.results: List[OptimizationResult] = []

    def execute(self) -> OptimizationResult:
        t0 = time.monotonic()
        best: Optional[OptimizationResult] = None
        for i, hp in enumerate(self.generator):
            if any(c.done(i, t0) for c in self.conditions):
                break
            model = self.build_fn(hp)
            score = float(self.score_fn(model))
            res = OptimizationResult(hp, score, model, i)
            self.results.append(res)
            for lst in self.listeners:
                lst(res)
            better = (best is None or
                      (score < best.score if self.minimize else score > best.score))
            if np.isfinite(score) and better:
                best = res
        if best is None:
            if self.results:
                raise RuntimeError(
                    f"all {len(self.results)} candidate scores were non-finite")
            raise RuntimeError("no candidates evaluated")
        return best

    def best(self) -> OptimizationResult:
        finite = [r for r in self.results if np.isfinite(r.score)]
        if not finite:
            raise RuntimeError("no finite-scored candidates")
        key = (lambda r: r.score) if self.minimize else (lambda r: -r.score)
        return min(finite, key=key)
