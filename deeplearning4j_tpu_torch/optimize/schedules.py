"""Learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/optimize/schedules.py``: the same
classes, fields, JSON and formulas. Each is a function of the integer step
counter. The JAX package evaluates them on the device inside the jitted
step; PyTorch runs eagerly, so here they are evaluated on the host as
Python floats and the step launches nothing for them.
"""

from __future__ import annotations

import dataclasses
import math

SCHEDULE_REGISTRY: dict[str, type] = {}


def _register(cls):
    SCHEDULE_REGISTRY[cls.__name__] = cls
    return cls


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


@dataclasses.dataclass(frozen=True)
class Schedule:
    def __call__(self, step: int) -> float:
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        return SCHEDULE_REGISTRY[d.pop("@type")](**d)


@_register
@dataclasses.dataclass(frozen=True)
class ConstantSchedule(Schedule):
    value: float = 1e-3

    def __call__(self, step):
        return self.value


@_register
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.99

    def __call__(self, step):
        return self.initial_value * self.gamma ** step


@_register
@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.1
    power: float = 1.0

    def __call__(self, step):
        return self.initial_value / (1.0 + self.gamma * step) ** self.power


@_register
@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, step):
        return self.initial_value * (1.0 - _clip01(step / self.max_iter)) ** self.power


@_register
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.1
    step_size: int = 1000

    def __call__(self, step):
        return self.initial_value / (1.0 + math.exp(self.gamma * (step - self.step_size)))


@_register
@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    initial_value: float = 1e-3
    decay_rate: float = 0.5
    step_size: int = 1000

    def __call__(self, step):
        return self.initial_value * self.decay_rate ** math.floor(step / self.step_size)


@_register
@dataclasses.dataclass(frozen=True)
class MapSchedule(Schedule):
    """Piecewise-constant LR keyed by step (sorted (step, lr) pairs)."""

    values: tuple = ((0, 1e-3),)

    def __call__(self, step):
        lr = self.values[0][1]
        for s, v in self.values:
            if step >= s:
                lr = v
        return lr


@_register
@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay."""

    peak_value: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 100000
    end_value: float = 0.0

    def __call__(self, step):
        if step < self.warmup_steps:
            return self.peak_value * step / max(self.warmup_steps, 1)
        frac = _clip01((step - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1))
        return self.end_value + 0.5 * (self.peak_value - self.end_value) * (
            1.0 + math.cos(math.pi * frac))


def resolve_schedule(lr) -> Schedule:
    """Accept a float (constant) or a Schedule."""
    if isinstance(lr, Schedule):
        return lr
    return ConstantSchedule(float(lr))
