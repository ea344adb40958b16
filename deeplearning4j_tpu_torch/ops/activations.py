"""Activation catalog, name-addressable.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: activations are
strings in layer JSON, resolved by the same names. The port carries the
ones its layers use; the rest of the catalog comes with the layers that
need them. ``gelu`` is the tanh approximation, the default of the JAX
package's ``jax.nn.gelu``: exact erf-gelu differs by about 1e-3.
"""

from __future__ import annotations

from typing import Callable

import torch

ACTIVATIONS: dict[str, Callable] = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get_activation(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("_", "")
    if key not in ACTIVATIONS:
        raise ValueError(f"activation '{name_or_fn}' is not ported yet; "
                         f"known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
