"""Updater (optimizer) zoo.

Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``: the same
classes, fields, defaults and JSON, and the same math (Nesterovs' momentum
form, RMSProp's epsilon inside the square root), so a configuration, its
optimizer state and its learning curve carry across the packages.

Each updater is a frozen dataclass with ``init_state(params)`` and
``update(grads, state, params, step)`` returning (updates to subtract, new
state), over nested dicts of tensors. ``step`` is the integer step counter;
the learning rate may be a Schedule (``optimize/schedules.py``), evaluated
on the host. The updates are eager elementwise PyTorch ops, the job the
fused XLA region does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.optimize.schedules import Schedule, resolve_schedule

UPDATER_REGISTRY: dict[str, type] = {}


def _register(cls):
    UPDATER_REGISTRY[cls.__name__] = cls
    return cls


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


@dataclasses.dataclass(frozen=True)
class Updater:
    """IUpdater analog. ``lr`` may be a float or a Schedule.

    ``clipnorm`` > 0 clips the gradient tree to that global L2 norm before
    this updater's math runs; keyword-only so subclass positional
    signatures stay stable."""

    lr: object = 1e-3
    clipnorm: float = dataclasses.field(default=0.0, kw_only=True)

    def _lr(self, step):
        return resolve_schedule(self.lr)(step)

    def init_state(self, params):
        return {}

    def update(self, grads, state, params, step):
        """Returns (updates_to_subtract, new_state)."""
        raise NotImplementedError

    def to_dict(self):
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.to_dict() if isinstance(v, Schedule) else v
        d["@type"] = type(self).__name__
        return d


def updater_from_dict(d: dict) -> Updater:
    d = dict(d)
    kind = d.pop("@type")
    if kind not in UPDATER_REGISTRY:
        raise ValueError(f"unknown updater '{kind}'")
    if isinstance(d.get("lr"), dict):
        d["lr"] = Schedule.from_dict(d["lr"])
    return UPDATER_REGISTRY[kind](**d)


@_register
@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen params."""

    def update(self, grads, state, params, step):
        return tree_map(torch.zeros_like, grads), state


@_register
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    lr: object = 0.1

    def update(self, grads, state, params, step):
        lr = self._lr(step)
        return tree_map(lambda g: lr * g, grads), state


@_register
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    """DL4J NesterovsUpdater: v_new = mu*v - lr*g; the update subtracted is
    -(mu*v_new - lr*g)."""

    lr: object = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return {"v": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr, mu = self._lr(step), self.momentum
        v_new = tree_map(lambda v, g: mu * v - lr * g, state["v"], grads)
        upd = tree_map(lambda vn, g: -(mu * vn - lr * g), v_new, grads)
        return upd, {"v": v_new}


def _moments(b1, b2, state, grads):
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
    return m, v


@_register
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    lr: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr, t = self._lr(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m, v = _moments(b1, b2, state, grads)
        a = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        upd = tree_map(lambda m, v: a * m / (v.sqrt() + self.eps), m, v)
        return upd, {"m": m, "v": v}


@_register
@dataclasses.dataclass(frozen=True)
class AdamW(Adam):
    """Adam + decoupled weight decay."""

    weight_decay: float = 0.01

    def update(self, grads, state, params, step):
        upd, st = super().update(grads, state, params, step)
        wd = self._lr(step) * self.weight_decay
        return tree_map(lambda u, p: u + wd * p, upd, params), st


@_register
@dataclasses.dataclass(frozen=True)
class AMSGrad(Adam):
    def init_state(self, params):
        s = super().init_state(params)
        s["vhat"] = _zeros_like(params)
        return s

    def update(self, grads, state, params, step):
        lr, t = self._lr(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m, v = _moments(b1, b2, state, grads)
        vhat = tree_map(torch.maximum, state["vhat"], v)
        a = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        upd = tree_map(lambda m, vh: a * m / (vh.sqrt() + self.eps), m, vhat)
        return upd, {"m": m, "v": v, "vhat": vhat}


@_register
@dataclasses.dataclass(frozen=True)
class AdaMax(Adam):
    def update(self, grads, state, params, step):
        lr, t = self._lr(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda v, g: torch.maximum(b2 * v, g.abs()),
                     state["v"], grads)
        a = lr / (1 - b1 ** t)
        upd = tree_map(lambda m, u: a * m / (u + self.eps), m, u)
        return upd, {"m": m, "v": u}


@_register
@dataclasses.dataclass(frozen=True)
class Nadam(Adam):
    def update(self, grads, state, params, step):
        lr, t = self._lr(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m, v = _moments(b1, b2, state, grads)
        mhat = tree_map(lambda m, g: b1 * m / (1 - b1 ** (t + 1))
                        + (1 - b1) * g / (1 - b1 ** t), m, grads)
        upd = tree_map(lambda mh, v: lr * mh / ((v / (1 - b2 ** t)).sqrt()
                                                + self.eps), mhat, v)
        return upd, {"m": m, "v": v}


@_register
@dataclasses.dataclass(frozen=True)
class RMSProp(Updater):
    """org.nd4j.linalg.learning.RmsPropUpdater: eps inside the sqrt."""

    lr: object = 1e-3
    decay: float = 0.95
    eps: float = 1e-8

    def init_state(self, params):
        return {"g2": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr, d = self._lr(step), self.decay
        g2 = tree_map(lambda a, g: d * a + (1 - d) * g * g, state["g2"], grads)
        upd = tree_map(lambda g, a: lr * g / (a + self.eps).sqrt(), grads, g2)
        return upd, {"g2": g2}


@_register
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    lr: object = 1e-1
    eps: float = 1e-6

    def init_state(self, params):
        return {"g2": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr = self._lr(step)
        g2 = tree_map(lambda a, g: a + g * g, state["g2"], grads)
        upd = tree_map(lambda g, a: lr * g / (a.sqrt() + self.eps), grads, g2)
        return upd, {"g2": g2}


@_register
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    """No learning rate (org.nd4j.linalg.learning.AdaDeltaUpdater)."""

    lr: object = 1.0  # unused, kept for interface parity
    rho: float = 0.95
    eps: float = 1e-6

    def init_state(self, params):
        return {"g2": _zeros_like(params), "dx2": _zeros_like(params)}

    def update(self, grads, state, params, step):
        rho, eps = self.rho, self.eps
        g2 = tree_map(lambda a, g: rho * a + (1 - rho) * g * g,
                      state["g2"], grads)
        upd = tree_map(lambda g, a, d: g * (d + eps).sqrt() / (a + eps).sqrt(),
                       grads, g2, state["dx2"])
        dx2 = tree_map(lambda d, u: rho * d + (1 - rho) * u * u,
                       state["dx2"], upd)
        return upd, {"g2": g2, "dx2": dx2}


_ALIASES = {
    "sgd": Sgd, "adam": Adam, "adamw": AdamW, "adamax": AdaMax,
    "nadam": Nadam, "nesterovs": Nesterovs, "nesterov": Nesterovs,
    "rmsprop": RMSProp, "adagrad": AdaGrad, "adadelta": AdaDelta,
    "amsgrad": AMSGrad, "noop": NoOp, "none": NoOp,
}


def get_updater(spec) -> Updater:
    """Accept an Updater or a name string."""
    if isinstance(spec, Updater):
        return spec
    if isinstance(spec, str):
        name = spec.lower()
        if name not in _ALIASES:
            raise ValueError(f"unknown updater '{spec}'")
        return _ALIASES[name]()
    raise TypeError(f"cannot interpret updater spec {spec!r}")
