"""Core feed-forward layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/core.py``; this slice ports
``DenseLayer``, the base of the output layers. W stays [in, out].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, register_layer, resolve_activation,
)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class DenseLayer(Layer):
    """Fully connected layer: act(x @ W + b)."""

    n_out: int
    n_in: Optional[int] = None
    activation: str = "sigmoid"  # DL4J historical default
    has_bias: bool = True

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        nin = self.n_in or itype.size
        p = {"W": self._w(generator, (nin, self.n_out), device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state
