"""Parameter spaces.

Counterpart of ``deeplearning4j_tpu/arbiter/spaces.py``, copied (host numpy, no
framework): the same seeds give the same draws.

Reference analog: org.deeplearning4j.arbiter.optimize.parameter.
{continuous.ContinuousParameterSpace, discrete.DiscreteParameterSpace,
integer.IntegerParameterSpace}.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class ContinuousParameterSpace:
    lo: float
    hi: float
    log_scale: bool = False

    def sample(self, rng) -> float:
        if self.log_scale:
            return float(math.exp(rng.uniform(math.log(self.lo),
                                              math.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))

    def grid(self, n: int) -> List[float]:
        if n == 1:
            return [(self.lo + self.hi) / 2]
        if self.log_scale:
            lo, hi = math.log(self.lo), math.log(self.hi)
            return [math.exp(lo + i * (hi - lo) / (n - 1)) for i in range(n)]
        return [self.lo + i * (self.hi - self.lo) / (n - 1) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DiscreteParameterSpace:
    values: Sequence

    def sample(self, rng):
        return self.values[rng.integers(len(self.values))]

    def grid(self, n: int = 0) -> List:
        return list(self.values)


@dataclasses.dataclass(frozen=True)
class IntegerParameterSpace:
    lo: int
    hi: int  # inclusive

    def sample(self, rng) -> int:
        return int(rng.integers(self.lo, self.hi + 1))

    def grid(self, n: int) -> List[int]:
        span = self.hi - self.lo
        if n >= span + 1:
            return list(range(self.lo, self.hi + 1))
        return sorted({self.lo + round(i * span / max(n - 1, 1))
                       for i in range(n)})
