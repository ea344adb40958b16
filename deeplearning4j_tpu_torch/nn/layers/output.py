"""Output layers: a dense transform (``preout``), the activation and the loss.

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py``: ``OutputLayer``,
``RnnOutputLayer``, ``LossLayer`` (``output.py:100``, no params),
``CenterLossOutputLayer`` (``:121``) and ``CnnLossLayer`` (``:158``, a
per-pixel loss summed per example). ``score_from_preout`` returns
per-example losses so that masking composes upstream.

``CenterLossOutputLayer`` keeps its per-class feature centers as layer
state (``centers`` [n_out, n_in]); the network's train step adds
``center_score_and_state``'s term to the loss and stores the moved
centers, as the JAX train step does. When the activation
is softmax and the loss cross entropy (or sigmoid and binary cross
entropy), the loss takes the logits (``from_logits=True``): the stable
log-softmax path of the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.common.dtypes import matmul
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, register_layer, resolve_activation,
)
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
from deeplearning4j_tpu_torch.ops.losses import get_loss


def _fused(activation: str, loss: str) -> bool:
    a = activation.lower().replace("_", "")
    l = loss.lower().replace("_", "")
    return (a == "softmax" and l in ("mcxent", "negativeloglikelihood",
                                     "sparsemcxent")) or (
        a == "sigmoid" and l == "xent")


def _score(layer, labels, preout, mask):
    """The loss of ``layer`` on 2-D ``preout``, through the logits where
    the activation and loss fuse."""
    fn = get_loss(layer.loss)
    if _fused(layer.activation, layer.loss):
        return fn(labels, preout, mask, from_logits=True)
    return fn(labels, resolve_activation(layer.activation)(preout), mask)


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
        return _score(self, labels, preout, mask)


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
        b, t = preout.shape[0], preout.shape[1]
        p2 = preout.reshape(b * t, -1)
        l2 = labels.reshape(b * t, -1)
        m2 = mask.reshape(b * t) if mask is not None else None
        per = _score(self, l2, p2, m2)
        # sum over time -> per-example score; the model normalizes by the
        # mask's sum
        return per.reshape(b, t).sum(1)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class LossLayer(Layer):
    """Activation and loss without parameters
    (org.deeplearning4j.nn.conf.layers.LossLayer)."""

    loss: str = "mcxent"
    activation: str = "identity"

    def preout(self, params, x):
        return x

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return resolve_activation(self.activation)(x), state

    def score_from_preout(self, labels, preout, mask=None):
        return _score(self, labels, preout, mask)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss
    (org.deeplearning4j.nn.conf.layers.CenterLossOutputLayer): loss = CE +
    alpha/2 * ||f - c_y||^2, the centers moved at rate ``lambda_`` toward
    their classes' features."""

    alpha: float = 0.05
    lambda_: float = 0.5  # DL4J 'lambda'
    gradient_check: bool = False

    def init(self, generator, itype, device):
        p, _ = super().init(generator, itype, device)
        nin = self.n_in or itype.size
        return p, {"centers": torch.zeros((self.n_out, nin), device=device)}

    def center_score_and_state(self, params, state, features, labels,
                               mask=None):
        """(the per-example center term, the moved centers). ``mask``:
        optional per-example [B] weights; a masked-out example adds to
        neither. The centers carry no gradient."""
        centers = state["centers"]
        cls = labels.argmax(-1)
        diff = features - centers[cls]
        score = 0.5 * self.alpha * (diff * diff).sum(-1)
        lw = labels if mask is None else labels * mask[:, None]
        if mask is not None:
            score = score * mask
        with torch.no_grad():
            # c_j += lambda * (sum_{y_i = j} f_i - n_j c_j) / (n_j + 1)
            dt = torch.promote_types(lw.dtype, features.dtype)
            lw = lw.to(dt)
            counts = lw.sum(0)[:, None] + 1.0
            delta = (lw.T @ features.detach().to(dt) - counts * centers
                     + centers) / counts
            new_centers = centers + self.lambda_ * delta
        return score, {"centers": new_centers}


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class CnnLossLayer(Layer):
    """Per-pixel loss over [B, H, W, C] activations, summed per example
    (org.deeplearning4j.nn.conf.layers.CnnLossLayer; UNet's head)."""

    loss: str = "xent"
    activation: str = "sigmoid"

    def preout(self, params, x):
        return x

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return resolve_activation(self.activation)(x), state

    def score_from_preout(self, labels, preout, mask=None):
        b = preout.shape[0]
        p2 = preout.reshape(-1, preout.shape[-1])
        l2 = labels.reshape(-1, labels.shape[-1])
        m2 = mask.reshape(-1) if mask is not None else None
        return _score(self, l2, p2, m2).reshape(b, -1).sum(1)
