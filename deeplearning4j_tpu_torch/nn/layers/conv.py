"""Convolutional-family layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/conv.py``, every layer of
it: ``ConvolutionLayer`` (``conv.py:35``), ``Convolution1DLayer``
(``:94``), ``Convolution3DLayer`` (``:133``), ``Deconvolution2DLayer``
(``:178``), ``SeparableConvolution2DLayer`` (``:219``; params ``dW``,
``pW``, ``b``), ``DepthwiseConvolution2DLayer`` (``:268``),
``SubsamplingLayer`` (``:308``), ``Subsampling1DLayer`` (``:346``),
``Upsampling2DLayer`` (``:371``), ``Cropping2DLayer`` (``:386``),
``ZeroPadding2DLayer`` (``:410``), ``SpaceToDepthLayer`` (``:432``),
``GlobalPoolingLayer`` (``:446``), which BERT's classifier head uses over
time, and ``LocalResponseNormalizationLayer`` (``:488``). Same DL4J
names, fields and defaults, so a JAX-written ``configuration.json``
loads. Activations are NWC / NHWC / NDHWC and conv kernels WIO / HWIO /
DHWIO ([kh, kw, cin / groups, cout]; depthwise [kh, kw, C, mult]), as in
the JAX package, so params and zips cross unchanged. The convolutions and
the pools run the plain lowerings of ``ops/convolution.py`` (cuDNN on the
card); the LRN layer runs the LRN kernels there (``ops/cuda/lrn.py``).

``Deconvolution2DLayer.output_type`` keeps the JAX layer's DL4J formula
s(h-1) + k - 2p for VALID and explicit padding, while ``apply`` gives
lax.conv_transpose's size (VALID (h-1)s + max(k, s), explicit s(h-1) +
2p - k + 2): the two agree only where k = 2p + 1 (VALID: k >= s and
k = 1). Both are the JAX package's as they are.

``ConvolutionLayer`` also convolves an int8-quantized kernel
(``net.quantize()``), as the JAX layer does (``conv.py:73-81``).
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


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


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
        W = params["W"]
        if getattr(W, "is_quantized", False):
            # int8 view: convolve the int8 kernel cast to x's type and
            # scale the output per channel (the kernel's output-channel
            # axis is last, as the result's), never the kernel itself
            y = op("conv2d")(x, W.q.to(x.dtype), strides=_t2(self.strides),
                             padding=self.padding,
                             dilation=_t2(self.dilation),
                             groups=self.groups) * W.scale.to(x.dtype)
        else:
            y = op("conv2d")(x, W, strides=_t2(self.strides),
                             padding=self.padding,
                             dilation=_t2(self.dilation), groups=self.groups)
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class Convolution1DLayer(Layer):
    """1D conv over [batch, time, features]
    (org.deeplearning4j.nn.conf.layers.Convolution1DLayer); W [k, in,
    out]."""

    n_out: int
    kernel: int = 3
    strides: int = 1
    padding: object = "same"
    dilation: int = 1
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = True
    weight_init: str = "relu"

    def output_type(self, itype):
        t = itype.shape[0]
        pad = self.padding if isinstance(self.padding, str) else int(self.padding)
        return InputType.recurrent(
            self.n_out, conv_out_len(t, self.kernel, self.strides, pad,
                                     self.dilation))

    def init(self, generator, itype, device):
        cin = self.n_in or itype.shape[1]
        p = {"W": self._w(generator, (self.kernel, cin, self.n_out), device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        pad = self.padding if isinstance(self.padding, str) else (self.padding,)
        y = op("conv1d")(x, params["W"], strides=self.strides, padding=pad,
                         dilation=self.dilation)
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class Convolution3DLayer(Layer):
    """3D conv over NDHWC (org.deeplearning4j.nn.conf.layers.Convolution3D);
    W [kd, kh, kw, in, out]."""

    n_out: int
    kernel: tuple = (3, 3, 3)
    strides: tuple = (1, 1, 1)
    padding: object = "same"
    dilation: tuple = (1, 1, 1)
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = True
    weight_init: str = "relu"

    def output_type(self, itype):
        d, h, w, _ = itype.shape
        kd, kh, kw = _t3(self.kernel)
        sd, sh, sw = _t3(self.strides)
        dd, dh, dw = _t3(self.dilation)
        if isinstance(self.padding, str):
            pd = ph = pw = self.padding
        else:
            pd, ph, pw = _t3(self.padding)
        return InputType.convolutional3d(
            conv_out_len(d, kd, sd, pd, dd), conv_out_len(h, kh, sh, ph, dh),
            conv_out_len(w, kw, sw, pw, dw), self.n_out)

    def init(self, generator, itype, device):
        cin = self.n_in or itype.channels
        kd, kh, kw = _t3(self.kernel)
        p = {"W": self._w(generator, (kd, kh, kw, cin, self.n_out), device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = op("conv3d")(x, params["W"], strides=_t3(self.strides),
                         padding=self.padding, dilation=_t3(self.dilation))
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class Deconvolution2DLayer(Layer):
    """Transposed conv (org.deeplearning4j.nn.conf.layers.Deconvolution2D);
    W [kh, kw, in, out]. ``output_type`` and ``apply`` differ off k = 2p +
    1 (module docstring), as in the JAX package."""

    n_out: int
    kernel: tuple = (2, 2)
    strides: tuple = (2, 2)
    padding: object = "same"
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = True
    weight_init: str = "relu"

    def output_type(self, itype):
        h, w, _ = itype.shape
        kh, kw = _t2(self.kernel)
        sh, sw = _t2(self.strides)
        if isinstance(self.padding, str) and self.padding.lower() == "same":
            oh = None if h is None else h * sh
            ow = None if w is None else w * sw
        else:
            p = (0, 0) if isinstance(self.padding, str) else _t2(self.padding)
            oh = None if h is None else sh * (h - 1) + kh - 2 * p[0]
            ow = None if w is None else sw * (w - 1) + kw - 2 * p[1]
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, generator, itype, device):
        cin = self.n_in or itype.channels
        kh, kw = _t2(self.kernel)
        p = {"W": self._w(generator, (kh, kw, cin, self.n_out), device)}
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = op("deconv2d")(x, params["W"], strides=_t2(self.strides),
                           padding=self.padding)
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


def _conv2d_output_type(layer, itype, channels):
    h, w, _ = itype.shape
    kh, kw = _t2(layer.kernel)
    sh, sw = _t2(layer.strides)
    ph, pw = _pads(layer.padding)
    return InputType.convolutional(conv_out_len(h, kh, sh, ph),
                                   conv_out_len(w, kw, sw, pw), channels)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class SeparableConvolution2DLayer(Layer):
    """Depthwise then pointwise conv
    (org.deeplearning4j.nn.conf.layers.SeparableConvolution2D): ``dW``
    [kh, kw, in, mult], ``pW`` [1, 1, in * mult, out], ``b``."""

    n_out: int
    kernel: tuple = (3, 3)
    strides: tuple = (1, 1)
    padding: object = "same"
    depth_multiplier: int = 1
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = True
    weight_init: str = "relu"

    def output_type(self, itype):
        return _conv2d_output_type(self, itype, self.n_out)

    def init(self, generator, itype, device):
        cin = self.n_in or itype.channels
        kh, kw = _t2(self.kernel)
        m = self.depth_multiplier
        p = {
            "dW": self._w(generator, (kh, kw, cin, m), device,
                          fan_in=kh * kw * cin, fan_out=kh * kw * m),
            "pW": self._w(generator, (1, 1, cin * m, self.n_out), device),
        }
        if self.has_bias:
            p["b"] = self._b((self.n_out,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = op("depthwise_conv2d")(x, params["dW"], strides=_t2(self.strides),
                                   padding=self.padding)
        y = op("conv2d")(y, params["pW"], strides=(1, 1), padding="same")
        if self.has_bias:
            y = y + params["b"]
        return resolve_activation(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class DepthwiseConvolution2DLayer(Layer):
    """Depthwise conv only
    (org.deeplearning4j.nn.conf.layers.DepthwiseConvolution2D): W [kh, kw,
    C, mult], C * mult outputs."""

    kernel: tuple = (3, 3)
    strides: tuple = (1, 1)
    padding: object = "same"
    depth_multiplier: int = 1
    n_in: Optional[int] = None
    activation: str = "identity"
    has_bias: bool = True
    weight_init: str = "relu"

    def output_type(self, itype):
        return _conv2d_output_type(self, itype,
                                   itype.shape[2] * self.depth_multiplier)

    def init(self, generator, itype, device):
        cin = self.n_in or itype.channels
        kh, kw = _t2(self.kernel)
        m = self.depth_multiplier
        p = {"W": self._w(generator, (kh, kw, cin, m), device,
                          fan_in=kh * kw, fan_out=kh * kw * m)}
        if self.has_bias:
            p["b"] = self._b((cin * m,), device)
        return p, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = op("depthwise_conv2d")(x, params["W"], strides=_t2(self.strides),
                                   padding=self.padding)
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
class Subsampling1DLayer(Layer):
    """1D max or average pooling over [batch, time, features], as a 2-D
    pool over [B, T, 1, F]."""

    kernel: int = 2
    strides: Optional[int] = None
    padding: object = "valid"
    pooling_type: str = "max"

    def output_type(self, itype):
        t, f = itype.shape
        s = self.strides or self.kernel
        pad = self.padding if isinstance(self.padding, str) else int(self.padding)
        return InputType.recurrent(f, conv_out_len(t, self.kernel, s, pad))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k = (self.kernel, 1)
        s = (self.strides or self.kernel, 1)
        name = "maxpool2d" if self.pooling_type.lower() == "max" else "avgpool2d"
        y = op(name)(x[:, :, None, :], kernel=k, strides=s,
                     padding=self.padding)
        return y[:, :, 0, :], state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class Upsampling2DLayer(Layer):
    """Nearest upsampling by ``size`` (org.deeplearning4j.nn.conf.layers
    .Upsampling2D)."""

    size: tuple = (2, 2)

    def output_type(self, itype):
        h, w, c = itype.shape
        sh, sw = _t2(self.size)
        return InputType.convolutional(None if h is None else h * sh,
                                       None if w is None else w * sw, c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return op("upsampling2d")(x, size=_t2(self.size)), state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class Cropping2DLayer(Layer):
    """Crop ((top, bottom), (left, right)), (rows, cols) or (top, bottom,
    left, right) (org.deeplearning4j.nn.conf.layers.convolutional
    .Cropping2D)."""

    crop: tuple = ((0, 0), (0, 0))

    def _norm(self):
        c = self.crop
        if isinstance(c[0], int):
            c = (((c[0], c[0]), (c[1], c[1])) if len(c) == 2
                 else ((c[0], c[1]), (c[2], c[3])))
        return c

    def output_type(self, itype):
        h, w, c = itype.shape
        (t, b), (l, r) = self._norm()
        return InputType.convolutional(None if h is None else h - t - b,
                                       None if w is None else w - l - r, c)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        (t, b), (l, r) = self._norm()
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :], state


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
class SpaceToDepthLayer(Layer):
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C] (YOLOv2's reorg); the channel
    order of ``space_to_depth``."""

    block: int = 2

    def output_type(self, itype):
        h, w, c = itype.shape
        return InputType.convolutional(h // self.block, w // self.block,
                                       c * self.block * self.block)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return op("space_to_depth")(x, block=self.block), state


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
