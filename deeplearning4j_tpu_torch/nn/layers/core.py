"""Core feed-forward layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/core.py``: ``DenseLayer``,
the base of the output layers, ``ActivationLayer`` (``core.py:56``),
``DropoutLayer`` (``:67``), the two embedding lookups and
``ElementWiseMultiplicationLayer`` (``:160``). W stays [in, out] ([vocab,
n_out] for an embedding). ``DropoutLayer`` draws its mask from the
network's generator (``rng``) and is the identity in eval.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.common.dtypes import matmul
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, dropout, register_layer, resolve_activation,
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
        y = matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class ActivationLayer(Layer):
    """Applies an activation only (org.deeplearning4j.nn.conf.layers
    .ActivationLayer)."""

    activation: str = "relu"

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return resolve_activation(self.activation)(x), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class DropoutLayer(Layer):
    """Standalone inverted dropout (org.deeplearning4j.nn.conf.layers
    .DropoutLayer); ``rate`` is the drop probability, as in the JAX
    package."""

    rate: float = 0.5

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if not train or self.rate <= 0.0:
            return x, state
        if rng is None:
            raise ValueError("DropoutLayer needs a generator during training")
        return dropout(x, self.rate, rng), state


def _lookup(layer, params, idx):
    """act(W[idx] (+ b)) for an integer index tensor."""
    y = params["W"][idx.to(torch.long)]
    if layer.has_bias:
        y = y + params["b"]
    return resolve_activation(layer.activation)(y)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class EmbeddingLayer(Layer):
    """Index -> vector lookup, one index per example: input [B] or [B, 1]
    integer indices, output [B, n_out]."""

    n_out: int
    n_in: Optional[int] = None  # vocab size
    activation: str = "identity"
    has_bias: bool = False

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        vocab = self.n_in or itype.size
        p = {"W": self._w(generator, (vocab, self.n_out), device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.dim() == 2 and x.shape[-1] == 1:
            x = x[:, 0]
        return _lookup(self, params, x), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class EmbeddingSequenceLayer(Layer):
    """Sequence of indices -> sequence of vectors: input [B, T] or
    [B, T, 1] integer indices, output [B, T, n_out]."""

    n_out: int
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = False
    inference_max_len: Optional[int] = None

    def output_type(self, itype):
        t = itype.shape[0] if itype.kind == "rnn" else None
        return InputType.recurrent(self.n_out, t)

    def init(self, generator, itype, device):
        vocab = self.n_in or (itype.size if itype.kind != "rnn"
                              else itype.shape[1])
        p = {"W": self._w(generator, (vocab, self.n_out), device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.dim() == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        return _lookup(self, params, x), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class ElementWiseMultiplicationLayer(Layer):
    """out = act(x * W + b), a learned per-feature scale
    (org.deeplearning4j.nn.conf.layers.misc.ElementWiseMultiplicationLayer);
    W starts at ones."""

    n_out: Optional[int] = None
    activation: str = "identity"

    def init(self, generator, itype, device):
        n = self.n_out or itype.size
        return {"W": torch.ones((n,), device=device),
                "b": self._b((n,), device)}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = x * params["W"] + params["b"]
        return resolve_activation(self.activation)(y), state
