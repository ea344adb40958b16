"""Activation catalog, name-addressable.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: activations are
strings in layer JSON, resolved by the same 23 names, and the four
parametric ``"name:arg"`` forms (``"leakyrelu:0.3"``, ``"elu:0.5"``,
``"relumax:6"``, ``"thresholdedrelu:0.5"``). Each is the JAX package's
formula in plain PyTorch:

- ``gelu`` is the tanh approximation, the default of ``jax.nn.gelu``
  (exact erf-gelu differs by about 1e-3);
- ``leakyrelu`` has slope 0.01 (``jax.nn.leaky_relu``'s), not Darknet's
  0.1;
- ``hardsigmoid`` is ``relu6(x + 3) / 6`` (``jax.nn.hard_sigmoid``);
- ``rationaltanh`` is the JAX package's own rational approximation of
  1.7159 tanh(2x/3), not ``tanh``;
- ``softmax`` and ``logsoftmax`` run over the last axis.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _rational_tanh(x):
    # DL4J ActivationRationalTanh: 1.7159 * tanh_approx(2x/3), the
    # rational form and constants of the JAX package
    a = 1.7159
    y = (2.0 / 3.0) * x
    yabs = y.abs()
    approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + yabs + y * y
                                           + 1.41645 * y ** 4))
    return a * approx


def _rectified_tanh(x):
    return torch.tanh(x).clamp_min(0.0)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _thresholded(a):
    return lambda x: torch.where(x > a, x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


ACTIVATIONS: dict[str, Callable] = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
    "tanh": torch.tanh,
    "hardtanh": F.hardtanh,
    "rationaltanh": _rational_tanh,
    "rectifiedtanh": _rectified_tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": _softplus,
    "softsign": F.softsign,
    "cube": lambda x: x ** 3,
    "thresholdedrelu": _thresholded(1.0),
}

_PARAMETRIC = {
    "leakyrelu": lambda a: lambda x: F.leaky_relu(x, a),
    "elu": lambda a: lambda x: F.elu(x, alpha=a),
    "relumax": lambda a: lambda x: x.clamp(0.0, a),
    "thresholdedrelu": _thresholded,
}


def get_activation(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("_", "")
    if ":" in key:
        base, _, arg = key.partition(":")
        if base not in _PARAMETRIC:
            raise ValueError(f"activation '{base}' does not take a parameter")
        return _PARAMETRIC[base](float(arg))
    if key not in ACTIVATIONS:
        raise ValueError(f"unknown activation '{name_or_fn}'; "
                         f"known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


def activation_name(fn_or_name) -> str:
    """The JSON name of an activation: a string normalized, a catalog
    function by its entry."""
    if isinstance(fn_or_name, str):
        return fn_or_name.lower().replace("_", "")
    for k, v in ACTIVATIONS.items():
        if v is fn_or_name:
            return k
    raise ValueError("cannot serialize custom activation function to JSON")
