"""Output layers: a dense transform (``preout``) plus the activation.

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py`` for
``OutputLayer`` and ``RnnOutputLayer``. The ``loss`` field is kept so the
configuration JSON round-trips; loss functions come with the training
slice.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import register_layer, resolve_activation
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class OutputLayer(DenseLayer):
    """Dense + activation (+ loss, when training is ported)."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def preout(self, params, x):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, mask=None):
        return resolve_activation(self.activation)(self.preout(params, x)), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep output layer; input/output [batch, time, features]."""

    def output_type(self, itype):
        t = itype.shape[0] if itype.kind == "rnn" else None
        return InputType.recurrent(self.n_out, t)

    def preout(self, params, x):
        y = x @ params["W"]  # [B, T, nout]
        if self.has_bias:
            y = y + params["b"]
        return y
