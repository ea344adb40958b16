"""Convolution and pooling ops: plain PyTorch lowerings under the JAX
package's op names.

Counterpart of ``deeplearning4j_tpu/ops/convolution.py`` for the ops the
conv stack of LeNet and AlexNet runs: ``conv2d``, ``maxpool2d``,
``avgpool2d``, ``pnormpool2d`` and ``lrn``, with ``conv_out_len``. As in
the JAX package, activations are channels-last (NHWC) and conv kernels
HWIO, at every public function.

The convolution itself is ``torch.nn.functional.conv2d`` (cuDNN on the
card), as the JAX package leaves it to XLA outside any Pallas kernel. The
NHWC activation enters as a channels_last NCHW view and the HWIO kernel as
an OIHW tensor in channels_last memory, so cuDNN returns channels_last
and the permute back to NHWC is contiguous: the next layer (the LRN
kernel's contiguity check, a dense layer's flatten) takes it without a
copy.

Padding follows XLA: "same" pads ``max((ceil(n/s)-1)*s + eff - n, 0)``
in all, the extra one at the end (asymmetric when odd, e.g. with stride
> 1); "valid"/"truncate"/"strict" pad nothing; a tuple pads each side of
each spatial axis by its entry. A max pool pads with -inf, an avg pool
with 0 and, under "same", divides by the real window count (DL4J's
count_include_pad=False).

The ``lrn`` lowering is the XLA one: the channel window sum over offsets
[-depth//2, depth-1-depth//2], computed in the input's type. The LRN
kernels (``ops/cuda/lrn.py``) register over it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.registry import register_op


def _t2(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def _same_pads(n, k, s, d=1):
    """XLA's SAME padding of one spatial axis: (before, after)."""
    eff = (k - 1) * d + 1
    total = max((-(-n // s) - 1) * s + eff - n, 0)
    return total // 2, total - total // 2


def _pad2(padding, spatial, kernel, strides, dilation=(1, 1)):
    """DL4J ConvolutionMode -> ((top, bottom), (left, right)) pads for the
    spatial sizes ``spatial`` (H, W)."""
    if isinstance(padding, str):
        p = padding.lower()
        if p == "same":
            return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                         zip(spatial, kernel, strides, dilation))
        if p in ("valid", "truncate", "strict"):
            return ((0, 0), (0, 0))
        raise ValueError(f"unknown padding '{padding}'")
    return tuple((int(p), int(p)) for p in padding)


def _pool_pad(padding, spatial, kernel, strides):
    """Pool padding: "same" as XLA's SAME, any other string VALID, a tuple
    explicit; returns (pads, is_same)."""
    if isinstance(padding, str):
        if padding.lower() == "same":
            return _pad2("same", spatial, kernel, strides), True
        return ((0, 0), (0, 0)), False
    return tuple((int(p), int(p)) for p in padding), False


def _nchw(x):
    """NHWC tensor -> its channels_last NCHW view (no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    """NCHW result -> NHWC (contiguous when ``y`` is channels_last)."""
    return y.permute(0, 2, 3, 1)


def _pad_nchw(x, pads, value=0.0):
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


@register_op("conv2d")
def conv2d(x, w, *, strides=(1, 1), padding="same", dilation=(1, 1), groups=1):
    """NHWC x HWIO -> NHWC convolution."""
    strides, dilation = _t2(strides), _t2(dilation)
    kernel = tuple(w.shape[:2])
    pads = _pad2(padding, tuple(x.shape[1:3]), kernel, strides, dilation)
    xc = _nchw(x)
    (t, b), (l, r) = pads
    if t == b and l == r:
        conv_pad = (t, l)
    else:  # XLA's asymmetric SAME: pad explicitly first
        xc = _pad_nchw(xc, pads)
        conv_pad = (0, 0)
    wc = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(xc, wc, stride=strides, padding=conv_pad, dilation=dilation,
                 groups=groups)
    return _nhwc(y)


def _window_sums(x, kernel, strides, pads):
    """Sum of each pool window of an NHWC tensor padded with zeros."""
    xp = _pad_nchw(_nchw(x), pads)
    return _nhwc(F.avg_pool2d(xp, kernel, strides, divisor_override=1))


@register_op("maxpool2d")
def maxpool2d(x, *, kernel=(2, 2), strides=None, padding="valid"):
    kernel = _t2(kernel)
    strides = _t2(strides or kernel)
    pads, _ = _pool_pad(padding, tuple(x.shape[1:3]), kernel, strides)
    xp = _pad_nchw(_nchw(x), pads, value=-math.inf)
    return _nhwc(F.max_pool2d(xp, kernel, strides))


@register_op("avgpool2d")
def avgpool2d(x, *, kernel=(2, 2), strides=None, padding="valid"):
    kernel = _t2(kernel)
    strides = _t2(strides or kernel)
    pads, same = _pool_pad(padding, tuple(x.shape[1:3]), kernel, strides)
    s = _window_sums(x, kernel, strides, pads)
    if same:
        # divide by the real window size (count_include_pad=False)
        ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype,
                          device=x.device)
        return s / _window_sums(ones, kernel, strides, pads)
    return s / (kernel[0] * kernel[1])


@register_op("pnormpool2d")
def pnormpool2d(x, *, kernel=(2, 2), strides=None, padding="valid", pnorm=2):
    kernel = _t2(kernel)
    strides = _t2(strides or kernel)
    pads, _ = _pool_pad(padding, tuple(x.shape[1:3]), kernel, strides)
    s = _window_sums(x.abs() ** pnorm, kernel, strides, pads)
    return s ** (1.0 / pnorm)


def window_sum(a, lo: int, hi: int):
    """Sum over the last axis of ``a`` of the entries at offsets [lo, hi]
    from each channel (lo <= 0 <= hi), zero past either end."""
    C = a.shape[-1]
    pad = F.pad(a, (-lo, hi))
    out = pad[..., 0:C]
    for i in range(1, hi - lo + 1):
        out = out + pad[..., i:i + C]
    return out


@register_op("lrn")
def lrn(x, *, depth=5, alpha=1e-4, beta=0.75, k=2.0):
    """Local response normalization across channels (NHWC), in ``x``'s
    type: y = x / (k + alpha * sum of x^2 over the window)^beta."""
    half = depth // 2
    ssum = window_sum(x * x, -half, depth - 1 - half)
    return x / (k + alpha * ssum) ** beta


def conv_out_len(n, k, s, pad, dilation=1):
    """Output spatial length (DL4J ConvolutionUtils.getOutputSize semantics)."""
    if n is None:
        return None
    eff = (k - 1) * dilation + 1
    if isinstance(pad, str) and pad.lower() == "same":
        return -(-n // s)
    p = 0 if isinstance(pad, str) else int(pad)
    return (n + 2 * p - eff) // s + 1
