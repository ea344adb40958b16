"""Layer base class + registry.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. A layer is a frozen
dataclass whose fields are its JSON-serializable hyperparameters, with the
same field names and defaults as the JAX package, so the same configuration
JSON loads in both. Its methods are plain functions on tensors:

    params, state = layer.init(generator, input_type, device)
    y, new_state  = layer.apply(params, state, x, train=..., rng=..., mask=...)

``params`` keep the DL4J param-table keys ("W", "b", "RW", "pW"). Dropout
applies to a layer's input when training, drawing its mask from ``rng``, a
``torch.Generator`` on the input's device (the JAX package passes a key).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from deeplearning4j_tpu_torch.common.trees import tree_leaves
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import init_weight
from deeplearning4j_tpu_torch.ops.activations import get_activation

LAYER_REGISTRY: dict[str, type] = {}


def register_layer(cls):
    """Class decorator: make a layer JSON round-trippable by class name."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass(frozen=True, kw_only=True)
class Layer:
    """Base config+impl for all layers (fields mirror the JAX package)."""

    name: Optional[str] = None
    dropout: float = 0.0  # applied to the layer input when training
    weight_init: str = "xavier"
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[Any] = None  # per-layer updater record
    trainable: bool = True

    # ---- to be overridden ----
    def output_type(self, itype: InputType) -> InputType:
        return itype

    def init(self, generator: torch.Generator, itype: InputType, device):
        return {}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        raise NotImplementedError

    def feed_forward_mask(self, mask, itype: InputType):
        """How this layer transforms the time/feature mask."""
        return mask

    # ---- shared helpers ----
    def _maybe_dropout(self, x, train, rng):
        """Inverted dropout on the layer input (DL4J: ``dropout`` is the
        drop probability); ``rng`` a torch.Generator on x's device."""
        if not train or self.dropout <= 0.0:
            return x
        if rng is None:
            raise ValueError(f"layer {self.name or type(self).__name__}: "
                             "dropout needs a generator")
        return dropout(x, self.dropout, rng)

    def regularization(self, params):
        """l1/l2 penalty of this layer's params (DL4J
        calcRegularizationScore): none on "b", "beta" or "gamma"."""
        if (self.l1 == 0.0 and self.l2 == 0.0) or not params:
            return 0.0
        s = 0.0
        for k, v in params.items():
            if k in ("b", "beta", "gamma"):
                continue
            if getattr(v, "is_quantized", False):
                # quantized inference view: frozen weights, no penalty
                continue
            for a in tree_leaves(v):
                s = s + self.l1 * a.abs().sum() + self.l2 * 0.5 * (a * a).sum()
        return s

    def _w(self, generator, shape, device, fan_in=None, fan_out=None):
        return init_weight(generator, shape, self.weight_init, device=device,
                           fan_in=fan_in, fan_out=fan_out)

    def _b(self, shape, device):
        return torch.full(shape, float(self.bias_init), dtype=torch.float32,
                          device=device)

    # ---- serde ----
    def to_dict(self) -> dict:
        d = {"@layer": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or v == f.default:
                continue
            d[f.name] = _ser(v)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Layer":
        d = dict(d)
        kind = d.pop("@layer")
        if kind not in LAYER_REGISTRY:
            raise ValueError(f"layer '{kind}' is not ported yet; ported: "
                             f"{sorted(LAYER_REGISTRY)}")
        cls = LAYER_REGISTRY[kind]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                kwargs[f.name] = _deser(d[f.name])
        return cls(**kwargs)


def dropout(x, rate: float, rng: torch.Generator):
    """Inverted dropout: each entry kept with probability 1 - ``rate`` and
    scaled by 1 / (1 - rate), the mask drawn from ``rng``."""
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def _ser(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if isinstance(v, Layer):
            return v.to_dict()
        d = dataclasses.asdict(v)
        d["@type"] = type(v).__name__
        return d
    if hasattr(v, "to_dict"):
        return v.to_dict()
    if isinstance(v, tuple):
        return list(v)
    return v


def _deser(v):
    if isinstance(v, dict) and "@layer" in v:
        return Layer.from_dict(v)
    if isinstance(v, list):
        return tuple(v)
    if isinstance(v, dict) and "@type" in v:
        from deeplearning4j_tpu_torch.optimize.updaters import (
            UPDATER_REGISTRY, updater_from_dict,
        )

        if v["@type"] in UPDATER_REGISTRY:
            return updater_from_dict(v)
    return v


def resolve_activation(act) -> Callable:
    return get_activation(act)
