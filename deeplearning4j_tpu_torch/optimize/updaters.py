"""Updater (optimizer) configuration records.

Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``, records only:
the same classes, fields and defaults, so a configuration's JSON with any
updater loads and writes back unchanged. The update math comes with the
training slice. A learning-rate schedule (``lr`` given as a dict) is kept
as that dict.
"""

from __future__ import annotations

import dataclasses

UPDATER_REGISTRY: dict[str, type] = {}


def _register(cls):
    UPDATER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class Updater:
    """IUpdater record. ``lr`` is a float or a schedule dict."""

    lr: object = 1e-3
    clipnorm: float = dataclasses.field(default=0.0, kw_only=True)

    def to_dict(self):
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["@type"] = type(self).__name__
        return d


def updater_from_dict(d: dict) -> Updater:
    d = dict(d)
    kind = d.pop("@type")
    if kind not in UPDATER_REGISTRY:
        raise ValueError(f"unknown updater '{kind}'")
    return UPDATER_REGISTRY[kind](**d)


@_register
@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    pass


@_register
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    lr: object = 0.1


@_register
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    lr: object = 0.1
    momentum: float = 0.9


@_register
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    lr: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


@_register
@dataclasses.dataclass(frozen=True)
class AdamW(Adam):
    weight_decay: float = 0.01


@_register
@dataclasses.dataclass(frozen=True)
class AMSGrad(Adam):
    pass


@_register
@dataclasses.dataclass(frozen=True)
class AdaMax(Adam):
    pass


@_register
@dataclasses.dataclass(frozen=True)
class Nadam(Adam):
    pass


@_register
@dataclasses.dataclass(frozen=True)
class RMSProp(Updater):
    lr: object = 1e-3
    decay: float = 0.95
    eps: float = 1e-8


@_register
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    lr: object = 1e-1
    eps: float = 1e-6


@_register
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    lr: object = 1.0  # unused, kept for interface parity
    rho: float = 0.95
    eps: float = 1e-6


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
