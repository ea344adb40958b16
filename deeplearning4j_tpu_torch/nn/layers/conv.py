"""Convolutional-family layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/conv.py`` for the layers of
LeNet, AlexNet and ResNet-50: ``ConvolutionLayer`` (``conv.py:35``),
``SubsamplingLayer`` (``:308``), ``ZeroPadding2DLayer`` (``:410``),
``LocalResponseNormalizationLayer`` (``:488``), and ``GlobalPoolingLayer``
(``:446``), which BERT's classifier head uses over time. Same DL4J names, fields and defaults, so a
JAX-written ``configuration.json`` loads. Activations are NHWC and conv
kernels HWIO ([kh, kw, cin / groups, cout]), as in the JAX package, so
params and zips cross unchanged. The convolution and the pools run the
plain lowerings of ``ops/convolution.py`` (cuDNN on the card); the LRN
layer runs the LRN kernels there (``ops/cuda/lrn.py``).

The JAX ``ConvolutionLayer`` also convolves an int8-quantized kernel; the
port has no quantized params (quantized zips are refused on load).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, register_layer, resolve_activation,
)
from deeplearning4j_tpu_torch.ops.convolution import conv_out_len
from deeplearning4j_tpu_torch.ops.registry import op


def _t2(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(padding):
    """(rows, cols) padding for conv_out_len: the mode string for both, or
    the explicit pad of each axis."""
    if isinstance(padding, str):
        return padding, padding
    return _t2(padding)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class ConvolutionLayer(Layer):
    """2D convolution (org.deeplearning4j.nn.conf.layers.ConvolutionLayer)."""

    n_out: int
    kernel: tuple = (3, 3)
    strides: tuple = (1, 1)
    padding: object = "same"  # "same" | "truncate" | (ph, pw) explicit
    dilation: tuple = (1, 1)
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = True
    groups: int = 1
    weight_init: str = "relu"

    def output_type(self, itype):
        h, w, _ = itype.shape
        kh, kw = _t2(self.kernel)
        sh, sw = _t2(self.strides)
        dh, dw = _t2(self.dilation)
        ph, pw = _pads(self.padding)
        return InputType.convolutional(
            conv_out_len(h, kh, sh, ph, dh), conv_out_len(w, kw, sw, pw, dw),
            self.n_out)

    def init(self, generator, itype, device):
        cin = self.n_in or itype.channels
        kh, kw = _t2(self.kernel)
        p = {"W": self._w(generator, (kh, kw, cin // self.groups, self.n_out),
                          device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        y = op("conv2d")(x, params["W"], strides=_t2(self.strides),
                         padding=self.padding, dilation=_t2(self.dilation),
                         groups=self.groups)
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class SubsamplingLayer(Layer):
    """2D pooling (org.deeplearning4j.nn.conf.layers.SubsamplingLayer).

    pooling_type: "max" | "avg" | "pnorm"."""

    kernel: tuple = (2, 2)
    strides: Optional[tuple] = None
    padding: object = "valid"
    pooling_type: str = "max"
    pnorm: int = 2

    def output_type(self, itype):
        h, w, c = itype.shape
        kh, kw = _t2(self.kernel)
        sh, sw = _t2(self.strides or self.kernel)
        ph, pw = _pads(self.padding)
        return InputType.convolutional(conv_out_len(h, kh, sh, ph),
                                       conv_out_len(w, kw, sw, pw), c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k = _t2(self.kernel)
        s = _t2(self.strides or self.kernel)
        pt = self.pooling_type.lower()
        if pt == "max":
            return op("maxpool2d")(x, kernel=k, strides=s,
                                   padding=self.padding), state
        if pt in ("avg", "average"):
            return op("avgpool2d")(x, kernel=k, strides=s,
                                   padding=self.padding), state
        if pt == "pnorm":
            return op("pnormpool2d")(x, kernel=k, strides=s,
                                     padding=self.padding,
                                     pnorm=self.pnorm), state
        raise ValueError(f"unknown pooling type {self.pooling_type}")


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class ZeroPadding2DLayer(Layer):
    """Zero padding of the spatial axes of an NHWC tensor
    (org.deeplearning4j.nn.conf.layers.ZeroPaddingLayer): ``pad`` is
    ((top, bottom), (left, right)), (rows, cols) or (top, bottom, left,
    right)."""

    pad: tuple = ((1, 1), (1, 1))

    def _norm(self):
        p = self.pad
        if isinstance(p[0], int):
            p = (((p[0], p[0]), (p[1], p[1])) if len(p) == 2
                 else ((p[0], p[1]), (p[2], p[3])))
        return p

    def output_type(self, itype):
        h, w, c = itype.shape
        (t, b), (l, r) = self._norm()
        return InputType.convolutional(None if h is None else h + t + b,
                                       None if w is None else w + l + r, c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        (t, b), (l, r) = self._norm()
        return torch.nn.functional.pad(x, (0, 0, l, r, t, b)), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class LocalResponseNormalizationLayer(Layer):
    """LRN across channels
    (org.deeplearning4j.nn.conf.layers.LocalResponseNormalization)."""

    depth: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    k: float = 2.0

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return op("lrn")(x, depth=self.depth, alpha=self.alpha,
                         beta=self.beta, k=self.k), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial or time axes: CNN [B, H, W, C] ->
    [B, C], RNN [B, T, F] -> [B, F]. An RNN input's [B, T] mask makes the
    max, average and sum masked (DL4J's masked pooling)."""

    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, itype):
        if itype.kind == "rnn":
            return InputType.feed_forward(itype.shape[1])
        return InputType.feed_forward(itype.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        axes = tuple(range(1, x.dim() - 1))
        pt = self.pooling_type.lower()
        if mask is not None and x.dim() == 3:  # RNN masked pooling
            m = mask[..., None].to(x.dtype)
            if pt in ("avg", "average"):
                return (x * m).sum(axes) / m.sum(axes).clamp_min(1.0), state
            if pt == "sum":
                return (x * m).sum(axes), state
            if pt == "max":
                neg = torch.finfo(x.dtype).min
                return x.masked_fill(m <= 0, neg).amax(axes), state
        if pt == "max":
            return x.amax(axes), state
        if pt in ("avg", "average"):
            return x.mean(axes), state
        if pt == "sum":
            return x.sum(axes), state
        if pt == "pnorm":
            return (x.abs() ** self.pnorm).sum(axes) ** (1.0 / self.pnorm), state
        raise ValueError(f"unknown pooling type {self.pooling_type}")

    def feed_forward_mask(self, mask, itype):
        return None
