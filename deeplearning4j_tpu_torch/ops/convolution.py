"""Convolution and pooling ops: plain PyTorch lowerings under the JAX
package's op names.

Counterpart of ``deeplearning4j_tpu/ops/convolution.py``, every op of it
under the same name: ``conv2d``, ``conv1d``, ``conv3d``, ``deconv2d``,
``depthwise_conv2d``, the pools (``maxpool2d``, ``avgpool2d``,
``pnormpool2d``, ``maxpool3d``, ``avgpool3d``), ``lrn``,
``upsampling2d``, ``space_to_depth`` and ``depth_to_space``, with
``conv_out_len``. As in the JAX package, activations are channels-last
(NWC, NHWC, NDHWC) and conv kernels WIO / HWIO / DHWIO, at every public
function; each op converts at the call into ``torch.nn.functional``.

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

``deconv2d`` is ``lax.conv_transpose`` with ``transpose_kernel=False``:
the kernel is not flipped, so ``F.conv_transpose2d`` (the gradient form)
takes it flipped in space, at padding 0 (lax's VALID size, (h-1)s + k),
and the result is cropped or zero-padded on each side to lax's size
(SAME h*s; VALID (h-1)s + max(k, s); explicit (p, p) s(h-1) + 2p - k + 2).
``avgpool3d`` divides by the full window volume even under "same" (the
2-D pool divides by the real count), and ``maxpool3d``/``avgpool3d`` take
any padding other than "same" as VALID, as the JAX ops do.
``space_to_depth`` orders its channels (bh * block + bw) * C + c, which
is not ``F.pixel_unshuffle``'s c * block^2 + bh * block + bw.

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


def _spatial_pads(padding, spatial, kernel, strides, dilation=None):
    """DL4J ConvolutionMode -> ((before, after), ...) pads, one pair for
    each of the spatial sizes ``spatial`` (H, W for a 2-D op)."""
    if dilation is None:
        dilation = (1,) * len(spatial)
    if isinstance(padding, str):
        p = padding.lower()
        if p == "same":
            return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                         zip(spatial, kernel, strides, dilation))
        if p in ("valid", "truncate", "strict"):
            return ((0, 0),) * len(spatial)
        raise ValueError(f"unknown padding '{padding}'")
    return tuple((int(p), int(p)) for p in padding)


def _pool_pad(padding, spatial, kernel, strides):
    """Pool padding: "same" as XLA's SAME, any other string VALID, a tuple
    explicit; returns (pads, is_same)."""
    if isinstance(padding, str):
        if padding.lower() == "same":
            return _spatial_pads("same", spatial, kernel, strides), True
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
    pads = _spatial_pads(padding, tuple(x.shape[1:3]), kernel, strides,
                         dilation)
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


def _tn(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(a) for a in v)


def _flat_pads(pads, value=None):
    """[(before, after)] per spatial axis, first axis first -> F.pad's
    flat list, last axis first."""
    out = []
    for b, a in reversed(pads):
        out += [b, a]
    return out


def _conv_nd(x, w, strides, padding, dilation, groups, conv):
    """Channels-last x [B, *S, C] and kernel [*K, I, O] through ``conv``
    (F.conv1d / F.conv3d) on the channels-first view."""
    nd = x.dim() - 2
    kernel = tuple(w.shape[:nd])
    pads = _spatial_pads(padding, tuple(x.shape[1:-1]), kernel, strides,
                         dilation)
    xc = x.movedim(-1, 1)
    if all(b == a for b, a in pads):
        conv_pad = tuple(b for b, _ in pads)
    else:  # XLA's asymmetric SAME: pad explicitly first
        xc = F.pad(xc, _flat_pads(pads))
        conv_pad = (0,) * nd
    wc = w.to(x.dtype).movedim(-1, 0).movedim(-1, 1)
    y = conv(xc, wc, stride=strides, padding=conv_pad, dilation=dilation,
             groups=groups)
    return y.movedim(1, -1)


@register_op("conv1d")
def conv1d(x, w, *, strides=1, padding="same", dilation=1):
    """NWC x WIO -> NWC."""
    return _conv_nd(x, w, _tn(strides, 1), padding, _tn(dilation, 1), 1,
                    F.conv1d)


@register_op("conv3d")
def conv3d(x, w, *, strides=(1, 1, 1), padding="same", dilation=(1, 1, 1)):
    """NDHWC x DHWIO -> NDHWC."""
    return _conv_nd(x, w, _tn(strides, 3), padding, _tn(dilation, 3), 1,
                    F.conv3d)


def _transpose_pads(k, s, padding):
    """lax.conv_transpose's (before, after) padding of the dilated input
    along one axis (``_conv_transpose_padding``, or the explicit pad)."""
    if isinstance(padding, str):
        if padding.lower() == "same":
            pad_len = k + s - 2
            before = k - 1 if s > k - 1 else -(-pad_len // 2)
        else:
            pad_len = k + s - 2 + max(k - s, 0)
            before = k - 1
        return before, pad_len - before
    return int(padding), int(padding)


@register_op("deconv2d")
def deconv2d(x, w, *, strides=(1, 1), padding="same"):
    """Transposed conv, NHWC x HWIO(out=last) -> NHWC: lax.conv_transpose
    (kernel not flipped). F.conv_transpose2d at padding 0 gives the full
    (h-1)s + k rows; lax's output starts k-1-before rows into them and
    ends k-1-after rows before their end (a negative count pads zeros)."""
    strides = _t2(strides)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    pads = (padding, padding) if isinstance(padding, str) else padding
    (th, bh), (tw, bw) = (_transpose_pads(k, s, p) for k, s, p in
                          zip((kh, kw), strides, pads))
    wc = w.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)  # [I, O, kh, kw]
    y = F.conv_transpose2d(_nchw(x), wc, stride=strides)
    y = F.pad(y, (tw - kw + 1, bw - kw + 1, th - kh + 1, bh - kh + 1))
    return _nhwc(y)


@register_op("depthwise_conv2d")
def depthwise_conv2d(x, w, *, strides=(1, 1), padding="same",
                     dilation=(1, 1)):
    """Depthwise conv: w [kh, kw, C, mult] as HWIO [kh, kw, 1, C * mult]
    with C groups, so output channel c * mult + m is channel c's m-th
    filter."""
    c = x.shape[-1]
    kh, kw, cin, mult = w.shape
    if cin != c:
        raise ValueError(f"depthwise weight channel dim {cin} != input "
                         f"channels {c}")
    return conv2d(x, w.reshape(kh, kw, 1, c * mult), strides=strides,
                  padding=padding, dilation=dilation, groups=c)


def _pool3d_pads(x, kernel, strides, padding):
    """The 3-D pools' padding: XLA's SAME for "same", VALID for anything
    else (a tuple too), as the JAX ops pass it."""
    if isinstance(padding, str) and padding.lower() == "same":
        return _spatial_pads("same", tuple(x.shape[1:4]), kernel, strides)
    return ((0, 0),) * 3


@register_op("maxpool3d")
def maxpool3d(x, *, kernel=(2, 2, 2), strides=None, padding="valid"):
    kernel = _tn(kernel, 3)
    strides = _tn(strides or kernel, 3)
    pads = _pool3d_pads(x, kernel, strides, padding)
    xc = F.pad(x.movedim(-1, 1), _flat_pads(pads), value=-math.inf)
    return F.max_pool3d(xc, kernel, strides).movedim(1, -1)


@register_op("avgpool3d")
def avgpool3d(x, *, kernel=(2, 2, 2), strides=None, padding="valid"):
    """Window sums over the full kernel volume, under "same" too (the JAX
    op's divisor)."""
    kernel = _tn(kernel, 3)
    strides = _tn(strides or kernel, 3)
    pads = _pool3d_pads(x, kernel, strides, padding)
    xc = F.pad(x.movedim(-1, 1), _flat_pads(pads))
    s = F.avg_pool3d(xc, kernel, strides, divisor_override=1)
    return s.movedim(1, -1) / (kernel[0] * kernel[1] * kernel[2])


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


@register_op("upsampling2d")
def upsampling2d(x, *, size=(2, 2)):
    """Nearest upsampling: each pixel repeated size[0] x size[1]."""
    size = _t2(size)
    return x.repeat_interleave(size[0], dim=1).repeat_interleave(size[1],
                                                                  dim=2)


@register_op("space_to_depth")
def space_to_depth(x, *, block=2):
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C], channel (bh * b + bw) * C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               c * block * block)


@register_op("depth_to_space")
def depth_to_space(x, *, block=2):
    """The inverse of ``space_to_depth``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, block, block, c // (block * block))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * block, w * block,
                                               c // (block * block))


def conv_out_len(n, k, s, pad, dilation=1):
    """Output spatial length (DL4J ConvolutionUtils.getOutputSize semantics)."""
    if n is None:
        return None
    eff = (k - 1) * dilation + 1
    if isinstance(pad, str) and pad.lower() == "same":
        return -(-n // s)
    p = 0 if isinstance(pad, str) else int(pad)
    return (n + 2 * p - eff) // s + 1
