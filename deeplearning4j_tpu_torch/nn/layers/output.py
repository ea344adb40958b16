"""Output layers: a dense transform (``preout``), the activation and the loss.

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py`` for
``OutputLayer`` and ``RnnOutputLayer``. ``score_from_preout`` returns
per-example losses so that masking composes upstream. When the activation
is softmax and the loss cross entropy (or sigmoid and binary cross
entropy), the loss takes the logits (``from_logits=True``): the stable
log-softmax path of the JAX package.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.common.dtypes import matmul
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import register_layer, resolve_activation
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
from deeplearning4j_tpu_torch.ops.losses import get_loss


def _fused(activation: str, loss: str) -> bool:
    a = activation.lower().replace("_", "")
    l = loss.lower().replace("_", "")
    return (a == "softmax" and l in ("mcxent", "negativeloglikelihood",
                                     "sparsemcxent")) or (
        a == "sigmoid" and l == "xent")


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class OutputLayer(DenseLayer):
    """Dense + activation + loss."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def preout(self, params, x):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        return resolve_activation(self.activation)(self.preout(params, x)), state

    def score_from_preout(self, labels, preout, mask=None):
        """Per-example loss given the pre-activation output."""
        fn = get_loss(self.loss)
        if _fused(self.activation, self.loss):
            return fn(labels, preout, mask, from_logits=True)
        return fn(labels, resolve_activation(self.activation)(preout), mask)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep output layer; input/output [batch, time, features]. The
    loss is taken per timestep, masked, and summed over time."""

    def output_type(self, itype):
        t = itype.shape[0] if itype.kind == "rnn" else None
        return InputType.recurrent(self.n_out, t)

    def preout(self, params, x):
        y = matmul(x, params["W"])  # [B, T, nout]
        if self.has_bias:
            y = y + params["b"]
        return y

    def score_from_preout(self, labels, preout, mask=None):
        fn = get_loss(self.loss)
        b, t = preout.shape[0], preout.shape[1]
        p2 = preout.reshape(b * t, -1)
        l2 = labels.reshape(b * t, -1)
        m2 = mask.reshape(b * t) if mask is not None else None
        if _fused(self.activation, self.loss):
            per = fn(l2, p2, m2, from_logits=True)
        else:
            per = fn(l2, resolve_activation(self.activation)(p2), m2)
        # sum over time -> per-example score; the model normalizes by the
        # mask's sum
        return per.reshape(b, t).sum(1)
