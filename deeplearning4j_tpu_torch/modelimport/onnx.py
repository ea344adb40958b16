"""ONNX model import.

Counterpart of ``deeplearning4j_tpu/modelimport/onnx.py``. Reuses the
protobuf wire reader of ``modelimport.tensorflow`` for the ModelProto,
GraphProto, NodeProto and TensorProto subset, and its value layer:
initializers stay numpy on the host, go to the graph's device once at
import, and host-only nodes (shape arithmetic) are evaluated on the host.
ONNX convolutions and pools are NCHW with OIHW kernels, which PyTorch
takes as they are, so their outputs keep the JAX package's NCHW layout.
"""

from __future__ import annotations

import logging
import struct
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.device import resolve_device
from deeplearning4j_tpu_torch.modelimport.tensorflow import (
    CAST_FLOAT_OVERRIDE, _float_in, _int, _ints, _np, _read_varint,
    _shape_of, _t, _amax, _amin, _mean, _prod, _sum, apply_mapper, cast_dest, cast_frozen,
    feed, one_hot, output_value, pad_index, pad_pairs, parse_message, place,
    promote, reduce_axes, running, slice_axes, take, to_torch,
)

# ------------------------------------------------------------- ONNX schema

_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                7: np.int64, 9: bool, 10: np.float16, 11: np.float64}
_TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                 6: torch.int32, 7: torch.int64, 9: torch.bool,
                 10: torch.float16, 11: torch.float64}


def _varints(raws) -> List[int]:
    out = []
    for raw in raws:
        if isinstance(raw, int):
            out.append(raw)
        else:
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                out.append(v)
    return [v - (1 << 64) if v >= (1 << 63) else v for v in out]


def _parse_onnx_tensor(buf: bytes) -> tuple:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9. Returns (name, ndarray)."""
    f = parse_message(buf)
    dims = _varints(f.get(1, []))
    dtype = _ONNX_DTYPES.get(f.get(2, [1])[0], np.float32)
    name = f[8][0].decode() if 8 in f else ""
    if 9 in f and f[9][0]:
        arr = np.frombuffer(f[9][0], dtype=dtype)
    elif 4 in f:
        vals = []
        for raw in f[4]:
            if isinstance(raw, bytes):
                vals.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
            else:
                vals.append(raw)
        arr = np.asarray(vals, np.float32)
    elif 7 in f:
        arr = np.asarray(_varints(f[7]), np.int64)
    elif 5 in f:
        arr = np.asarray(_varints(f[5]), np.int32)
    else:
        arr = np.zeros(dims, dtype)
    # dims == [] is a RANK-0 tensor (TensorProto omits the dims field for
    # scalars); reshape(()) matters — Gather with a scalar index drops the
    # axis, with a [1]-shaped index it keeps it
    return name, arr.reshape(dims) if (dims or arr.size == 1) else arr


class OnnxAttr:
    """AttributeProto: name=1, f=2 (fixed32 float), i=3, s=4, t=5,
    floats=7, ints=8, type=20.

    proto3 omits zero-valued singular fields from the wire, so an explicit
    ``axis = 0`` arrives with no ``i`` field at all — only the declared
    ``type`` reveals it. When the type says INT/FLOAT/STRING and the value
    field is absent, the value IS the proto3 default (0 / 0.0 / "")."""

    _FLOAT, _INT, _STRING = 1, 2, 3

    def __init__(self, buf: bytes):
        f = parse_message(buf)
        self.name = f[1][0].decode()
        self.type = f[20][0] if 20 in f else None
        self.f = struct.unpack("<f", f[2][0])[0] if 2 in f else (
            0.0 if self.type == self._FLOAT else None)
        self.i = _varints(f[3])[0] if 3 in f else (
            0 if self.type == self._INT else None)
        self.s = f[4][0].decode() if 4 in f else (
            "" if self.type == self._STRING else None)
        self.t = _parse_onnx_tensor(f[5][0])[1] if 5 in f else None
        self.ints = _varints(f.get(8, []))


class OnnxNode:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""

    def __init__(self, buf: bytes):
        f = parse_message(buf)
        self.inputs = [b.decode() for b in f.get(1, [])]
        self.outputs = [b.decode() for b in f.get(2, [])]
        self.name = f[3][0].decode() if 3 in f else (self.outputs[0]
                                                     if self.outputs else "")
        self.op = f[4][0].decode()
        self.attrs: Dict[str, OnnxAttr] = {}
        for ab in f.get(5, []):
            a = OnnxAttr(ab)
            self.attrs[a.name] = a

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def ints(self, name, default=()):
        a = self.attrs.get(name)
        return list(a.ints) if a and a.ints else list(default)


# --------------------------------------------------------------- op mapping

ONNX_OP_REGISTRY: Dict[str, Callable] = {}


def onnx_op(*names):
    def deco(fn):
        for n in names:
            ONNX_OP_REGISTRY[n] = fn
        return fn
    return deco


def _same_pads(spatial_in, spatial_kernel, strides, extra_at_start):
    pads = []
    for dim, k, s in zip(spatial_in, spatial_kernel, strides):
        out = -(-dim // s)
        total = max((out - 1) * s + k - dim, 0)
        pads.append((total - total // 2, total // 2) if extra_at_start
                    else (total // 2, total - total // 2))
    return pads


def _auto_pad(node, spatial_kernel, spatial_in, strides, dilations=None):
    """Explicit (before, after) pads of each spatial axis: SAME_UPPER as
    XLA's SAME (the odd pad at the end), SAME_LOWER with it at the start,
    else the node's ``pads`` (VALID when none)."""
    ap = node.attr("auto_pad")
    eff = [(k - 1) * d + 1 for k, d in
           zip(spatial_kernel, dilations or [1] * len(spatial_kernel))]
    if ap and ap.s in ("SAME_UPPER", "SAME_LOWER"):
        return _same_pads(spatial_in, eff, strides, ap.s == "SAME_LOWER")
    pads = node.ints("pads")
    n = len(spatial_kernel)
    if pads and any(pads):
        return [(pads[i], pads[i + n]) for i in range(n)]
    return [(0, 0)] * n


@onnx_op("Add")
def _add(node, xs):
    return _t(xs[0]) + _t(xs[1])


@onnx_op("Sub")
def _sub(node, xs):
    return _t(xs[0]) - _t(xs[1])


@onnx_op("Mul")
def _mul(node, xs):
    return _t(xs[0]) * _t(xs[1])


@onnx_op("Div")
def _div(node, xs):
    return _t(xs[0]) / _t(xs[1])


@onnx_op("MatMul")
def _matmul(node, xs):
    a, b = promote(xs[0], xs[1])
    return torch.matmul(a, b)


@onnx_op("Gemm")
def _gemm(node, xs):
    a, b = promote(xs[0], xs[1])
    alpha = node.attr("alpha")
    beta = node.attr("beta")
    ta, tb = node.attr("transA"), node.attr("transB")
    if ta and ta.i:
        a = a.transpose(-1, -2)
    if tb and tb.i:
        b = b.transpose(-1, -2)
    y = (alpha.f if alpha and alpha.f is not None else 1.0) * (a @ b)
    c = _opt(xs, 2)
    if c is not None:
        y = y + (beta.f if beta and beta.f is not None else 1.0) * _t(c)
    return y


@onnx_op("Relu")
def _relu(node, xs):
    return torch.relu(_t(xs[0]))


@onnx_op("LeakyRelu")
def _leaky(node, xs):
    a = node.attr("alpha")
    return F.leaky_relu(_t(xs[0]), a.f if a and a.f is not None else 0.01)


@onnx_op("Sigmoid")
def _sigmoid(node, xs):
    return torch.sigmoid(_t(xs[0]))


@onnx_op("Tanh")
def _tanh(node, xs):
    return torch.tanh(_t(xs[0]))


@onnx_op("Softmax")
def _softmax(node, xs):
    ax = node.attr("axis")
    return torch.softmax(_t(xs[0]),
                         dim=ax.i if ax and ax.i is not None else -1)


@onnx_op("Identity", "Dropout")
def _identity(node, xs):
    return xs[0]


@onnx_op("Flatten")
def _flatten(node, xs):
    ax = node.attr("axis")
    axis = ax.i if ax and ax.i is not None else 1
    x = _t(xs[0])
    lead = int(np.prod(tuple(x.shape[:axis]))) if axis else 1
    return x.reshape(lead, -1)


@onnx_op("Reshape")
def _reshape(node, xs):
    # ONNX: a 0 in shape copies the corresponding input dimension
    # (allowzero=0 default)
    x = _t(xs[0])
    shape = [x.shape[i] if d == 0 and i < x.dim() else d
             for i, d in enumerate(_ints(xs[1]))]
    return x.reshape(shape)


@onnx_op("Concat")
def _concat(node, xs):
    ax = node.attr("axis")
    axis = ax.i if ax is not None and ax.i is not None else 1
    return torch.cat([_t(x) for x in xs], dim=axis)


@onnx_op("Transpose")
def _transpose(node, xs):
    x = _t(xs[0])
    perm = node.ints("perm")
    return x.permute(perm or list(reversed(range(x.dim()))))


def _opt(xs, i):
    """Positional optional input: None when absent or empty-named."""
    return xs[i] if len(xs) > i and xs[i] is not None else None


def _const_ints(node, xs, attr_name, input_idx):
    """Int list from an attribute (older opsets) or a constant input tensor
    (newer opsets); None if neither present."""
    vals = node.ints(attr_name)
    if vals:
        return vals
    t = _opt(xs, input_idx)
    if t is None:
        return None
    return _ints(t)


@onnx_op("Gather")
def _gather(node, xs):
    a = node.attr("axis")
    return take(xs[0], xs[1], a.i if a is not None and a.i is not None else 0)


@onnx_op("Squeeze")
def _squeeze(node, xs):
    axes = _const_ints(node, xs, "axes", 1)
    x = _t(xs[0])
    return x.squeeze(tuple(axes)) if axes else x.squeeze()


@onnx_op("Unsqueeze")
def _unsqueeze(node, xs):
    axes = _const_ints(node, xs, "axes", 1)
    out = _t(xs[0])
    out_rank = out.dim() + len(axes)
    # axes are positions in the OUTPUT tensor, possibly negative
    for ax in sorted(a % out_rank for a in axes):
        out = out.unsqueeze(ax)
    return out


def _keepdims(node, default=True):
    kd = node.attr("keepdims")
    return bool(kd.i) if kd is not None else default


@onnx_op("ReduceMean")
def _reduce_mean(node, xs):
    axes = _const_ints(node, xs, "axes", 1)
    return reduce_axes(_mean, xs[0], tuple(axes) if axes else None,
                       _keepdims(node))


@onnx_op("ReduceSum")
def _reduce_sum(node, xs):
    axes = _const_ints(node, xs, "axes", 1)
    return reduce_axes(_sum, xs[0], tuple(axes) if axes else None,
                       _keepdims(node))


@onnx_op("Pow")
def _pow(node, xs):
    return torch.pow(_t(xs[0]), _t(xs[1]))


@onnx_op("Sqrt")
def _sqrt(node, xs):
    return torch.sqrt(_float_in(xs[0]))


@onnx_op("Erf")
def _erf(node, xs):
    return torch.special.erf(_float_in(xs[0]))


@onnx_op("Neg")
def _neg(node, xs):
    return -_t(xs[0])


@onnx_op("Exp")
def _exp(node, xs):
    return torch.exp(_float_in(xs[0]))


@onnx_op("Log")
def _log(node, xs):
    return torch.log(_float_in(xs[0]))


@onnx_op("Clip")
def _clip(node, xs):
    lo = node.attr("min")
    hi = node.attr("max")
    x = _t(xs[0])
    # jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi); a bound from an
    # attribute or an input tensor, either may be absent
    for attr, t, bound in ((lo, _opt(xs, 1), torch.maximum),
                           (hi, _opt(xs, 2), torch.minimum)):
        v = np.float32(attr.f) if attr is not None else t
        if v is not None:
            x = bound(x, _t(v).to(x.dtype))
    return x


@onnx_op("Where")
def _where(node, xs):
    a, b = promote(xs[1], xs[2])
    return torch.where(_t(xs[0]).bool(), a, b)


@onnx_op("Equal")
def _equal(node, xs):
    return torch.eq(_t(xs[0]), _t(xs[1]))


@onnx_op("Expand")
def _expand(node, xs):
    x = _t(xs[0])
    shape = torch.broadcast_shapes(tuple(x.shape), tuple(_ints(xs[1])))
    return torch.broadcast_to(x, shape)


@onnx_op("Gelu")
def _gelu(node, xs):
    approx = node.attr("approximate")
    tanh_approx = approx is not None and approx.s == "tanh"
    return F.gelu(_t(xs[0]), approximate="tanh" if tanh_approx else "none")


def _norm_over(x, axes, eps):
    mu = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps)


@onnx_op("LayerNormalization")
def _layer_norm(node, xs):
    eps = node.attr("epsilon")
    eps_v = eps.f if eps is not None else 1e-5
    ax = node.attr("axis")
    axis = ax.i if ax is not None and ax.i is not None else -1
    x = _t(xs[0])
    # ONNX normalizes over ALL trailing dims starting at `axis`
    out = _norm_over(x, tuple(range(axis % x.dim(), x.dim())), eps_v)
    scale_t = _opt(xs, 1)
    if scale_t is not None:
        out = out * _t(scale_t)
    bias_t = _opt(xs, 2)
    if bias_t is not None:
        out = out + _t(bias_t)
    return out


@onnx_op("Split")
def _split(node, xs):
    ax = node.attr("axis")
    axis = ax.i if ax is not None and ax.i is not None else 0
    n = node.attr("num_outputs")
    splits = _const_ints(node, xs, "split", 1)
    x = _t(xs[0])
    if splits:
        idx = np.cumsum(splits)[:-1].tolist()
        return tuple(torch.tensor_split(x, idx, dim=axis))
    # default: equal split into the node's output count (opset < 18)
    parts = n.i if n is not None else len(node.outputs)
    return tuple(torch.split(x, x.shape[axis] // parts, dim=axis))


@onnx_op("Pad")
def _pad(node, xs):
    mode = node.attr("mode")
    mode_s = mode.s if mode is not None else "constant"
    if mode_s not in ("constant", "reflect", "edge"):
        raise NotImplementedError(f"Pad mode {mode_s!r} is not supported")
    if _opt(xs, 3) is not None:
        raise NotImplementedError("Pad with an explicit axes input (opset 18) "
                                  "is not supported")
    pads = _const_ints(node, xs, "pads", 1)
    x = _t(xs[0])
    rank = x.dim()
    pairs = [(pads[i], pads[i + rank]) for i in range(rank)]
    if mode_s == "constant":
        cv = _opt(xs, 2)
        const = float(_np(cv).ravel()[0]) if cv is not None else 0.0
        return pad_pairs(x, pairs, value=const)
    return pad_index(x, pairs, mode_s)


@onnx_op("Conv")
def _conv(node, xs):
    x, w = promote(xs[0], xs[1])  # x NCHW, w OIHW
    strides = node.ints("strides", (1, 1))
    dil = node.ints("dilations", (1, 1))
    group = node.attr("group")
    pads = _auto_pad(node, tuple(w.shape[2:]), tuple(x.shape[2:]), strides,
                     dil)
    x = pad_pairs(x, [(0, 0), (0, 0)] + list(pads))
    b = _opt(xs, 2)
    return F.conv2d(x, w, None if b is None else _t(b).to(x.dtype),
                    stride=tuple(strides), dilation=tuple(dil),
                    groups=group.i if group and group.i else 1)


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, k, s):
    if len(k) == 1:  # avg_pool1d has no divisor_override
        return F.avg_pool1d(x, k, s) * k[0]
    return _AVGPOOL[len(k)](x, k, s, divisor_override=1)


@onnx_op("MaxPool")
def _maxpool(node, xs):
    k = node.ints("kernel_shape")
    s = node.ints("strides", k)
    x = _t(xs[0])
    pad = _auto_pad(node, k, tuple(x.shape[2:]), s)
    x = pad_pairs(x, [(0, 0), (0, 0)] + pad, value=-float("inf"))
    return _MAXPOOL[len(k)](x, k, s)


@onnx_op("AveragePool")
def _avgpool(node, xs):
    k = node.ints("kernel_shape")
    s = node.ints("strides", k)
    x = _t(xs[0])
    pad = _auto_pad(node, k, tuple(x.shape[2:]), s)
    full = [(0, 0), (0, 0)] + pad
    y = _window_sum(pad_pairs(x, full), k, s)
    cip = node.attr("count_include_pad")
    if not any(a or b for a, b in pad) or (cip and cip.i):
        return y / float(np.prod(k))
    # default count_include_pad=0: divide by the number of NON-pad cells
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return y / _window_sum(pad_pairs(ones, full), k, s)


@onnx_op("GlobalAveragePool")
def _gap(node, xs):
    return _t(xs[0]).mean(dim=(2, 3), keepdim=True)


@onnx_op("BatchNormalization")
def _bn(node, xs):
    x, scale, bias, mean, var = (_t(v) for v in xs[:5])
    eps = node.attr("epsilon")
    eps = eps.f if eps and eps.f is not None else 1e-5
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = (scale / torch.sqrt(var + eps)).reshape(shape)
    return x * inv + (bias - mean * scale / torch.sqrt(var + eps)
                      ).reshape(shape)


# ---- torch-exporter op families (real-framework graphs: BERT/ResNet via
# torch.onnx.export) + general breadth: constants, shapes, slicing, casts,
# comparisons, reductions, norms, scatter/gather, resize, topk ----

@onnx_op("Constant")
def _constant(node, xs):
    a = node.attr("value")
    if a is not None and a.t is not None:
        return np.asarray(a.t)  # host: downstream static reads stay free
    for nm in ("value_float", "value_int"):
        v = node.attr(nm)
        if v is not None:
            return np.asarray(v.f if nm == "value_float" else v.i)
    ints = node.ints("value_ints")
    if ints:
        return np.asarray(ints, np.int64)
    raise NotImplementedError("Constant node without a supported value attr")


@onnx_op("ConstantOfShape")
def _constant_of_shape(node, xs):
    shape = _ints(xs[0])
    a = node.attr("value")
    fill = np.asarray(a.t) if a is not None and a.t is not None \
        else np.zeros(1, np.float32)
    return np.full(shape, fill.ravel()[0], fill.dtype)


@onnx_op("Shape")
def _shape(node, xs):
    # a host array: shapes feed Reshape/Expand/Slice as static arguments
    return np.asarray(_shape_of(xs[0]), np.int64)


@onnx_op("Size")
def _size(node, xs):
    return np.asarray(int(np.prod(_shape_of(xs[0]))), np.int64)


@onnx_op("Cast")
def _cast(node, xs):
    """Mixed-precision fine-tuning: under as_trainable's compute_dtype every
    Cast to FLOAT/DOUBLE gives the compute dtype, integer-sourced casts
    (the exporter's int64 attention-mask path) included, so a bf16 graph is
    never promoted back to f32 at the first mask add. This is the
    torch-autocast contract: integer values outside the compute dtype's
    exact range (> 256 for bf16) round. fp16 destinations are untouched."""
    to = node.attr("to")
    dt = _TORCH_DTYPES.get(to.i if to is not None else 1, torch.float32)
    return _t(xs[0]).to(cast_dest(dt))


@onnx_op("Slice")
def _slice(node, xs):
    x = _t(xs[0])
    starts = _const_ints(node, xs, "starts", 1)
    ends = _const_ints(node, xs, "ends", 2)
    axes = _const_ints(node, xs, "axes", 3)
    steps = _const_ints(node, xs, "steps", 4)
    axes = axes if axes is not None else list(range(len(starts)))
    steps = steps if steps is not None else [1] * len(starts)
    sl = [slice(None)] * x.dim()
    INT64_MAX = (1 << 63) - 1
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        en_v = None if en >= INT64_MAX // 2 else en
        st_v = None if (sp < 0 and st >= INT64_MAX // 2) else st
        sl[ax % x.dim()] = slice(st_v, en_v, sp)
    return slice_axes(x, sl)


def _variadic(f):
    def fn(node, xs):
        out = _t(xs[0])
        for x in xs[1:]:
            out = f(*promote(out, x))
        return out
    return fn


ONNX_OP_REGISTRY["Min"] = _variadic(torch.minimum)
ONNX_OP_REGISTRY["Max"] = _variadic(torch.maximum)
ONNX_OP_REGISTRY["Sum"] = _variadic(torch.add)


@onnx_op("Mean")
def _mean_v(node, xs):
    return ONNX_OP_REGISTRY["Sum"](node, xs) / len(xs)


@onnx_op("Mod")
def _mod(node, xs):
    fm = node.attr("fmod")
    a, b = _t(xs[0]), _t(xs[1])
    return torch.fmod(a, b) if fm is not None and fm.i else \
        torch.remainder(a, b)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


for _nm, _fn in [
        ("Floor", torch.floor), ("Ceil", torch.ceil), ("Round", torch.round),
        ("Reciprocal", torch.reciprocal), ("Sign", torch.sign),
        ("Abs", torch.abs), ("IsNaN", torch.isnan),
        ("Not", torch.logical_not)]:
    ONNX_OP_REGISTRY[_nm] = (lambda _f: lambda node, xs: _f(_t(xs[0])))(_fn)

for _nm, _fn in [
        ("Cos", torch.cos), ("Sin", torch.sin), ("Tan", torch.tan),
        ("Acos", torch.acos), ("Asin", torch.asin), ("Atan", torch.atan),
        ("Cosh", torch.cosh), ("Sinh", torch.sinh), ("Atanh", torch.atanh),
        ("Asinh", torch.asinh), ("Acosh", torch.acosh),
        ("Softsign", F.softsign), ("Mish", _mish)]:
    ONNX_OP_REGISTRY[_nm] = (
        lambda _f: lambda node, xs: _f(_float_in(xs[0])))(_fn)

for _nm, _fn in [("Greater", torch.gt), ("Less", torch.lt),
                 ("GreaterOrEqual", torch.ge), ("LessOrEqual", torch.le),
                 ("And", torch.logical_and), ("Or", torch.logical_or),
                 ("Xor", torch.logical_xor)]:
    ONNX_OP_REGISTRY[_nm] = (
        lambda _f: lambda node, xs: _f(_t(xs[0]), _t(xs[1])))(_fn)


def _reduce_generic(rfn, default_keepdims=True):
    def fn(node, xs):
        axes = _const_ints(node, xs, "axes", 1)
        noop = node.attr("noop_with_empty_axes")
        if not axes and noop is not None and noop.i:
            return xs[0]
        return reduce_axes(rfn, xs[0], tuple(axes) if axes else None,
                           _keepdims(node, default_keepdims))
    return fn


ONNX_OP_REGISTRY["ReduceMax"] = _reduce_generic(_amax)
ONNX_OP_REGISTRY["ReduceMin"] = _reduce_generic(_amin)
ONNX_OP_REGISTRY["ReduceProd"] = _reduce_generic(_prod)
ONNX_OP_REGISTRY["ReduceL1"] = _reduce_generic(
    lambda a, axes, kd: torch.sum(torch.abs(a), dim=axes, keepdim=kd))
ONNX_OP_REGISTRY["ReduceL2"] = _reduce_generic(
    lambda a, axes, kd: torch.sqrt(torch.sum(a * a, dim=axes, keepdim=kd)))
ONNX_OP_REGISTRY["ReduceLogSumExp"] = _reduce_generic(
    lambda a, axes, kd: torch.logsumexp(a, dim=axes, keepdim=kd))
ONNX_OP_REGISTRY["ReduceSumSquare"] = _reduce_generic(
    lambda a, axes, kd: torch.sum(a * a, dim=axes, keepdim=kd))


def _arg_reduce(f):
    def fn(node, xs):
        ax = node.attr("axis")
        axis = ax.i if ax is not None else 0
        out = f(_t(xs[0]), dim=axis)
        kd = node.attr("keepdims")
        if kd is None or kd.i:
            out = out.unsqueeze(axis)
        return out
    return fn


ONNX_OP_REGISTRY["ArgMax"] = _arg_reduce(torch.argmax)
ONNX_OP_REGISTRY["ArgMin"] = _arg_reduce(torch.argmin)


@onnx_op("LogSoftmax")
def _log_softmax(node, xs):
    ax = node.attr("axis")
    return torch.log_softmax(_t(xs[0]), dim=ax.i if ax is not None else -1)


@onnx_op("Elu")
def _elu(node, xs):
    a = node.attr("alpha")
    return F.elu(_float_in(xs[0]), a.f if a is not None else 1.0)


@onnx_op("Selu")
def _selu(node, xs):
    return F.selu(_float_in(xs[0]))


@onnx_op("Celu")
def _celu(node, xs):
    a = node.attr("alpha")
    return F.celu(_float_in(xs[0]), a.f if a is not None else 1.0)


@onnx_op("HardSigmoid")
def _hard_sigmoid(node, xs):
    a = node.attr("alpha")
    b = node.attr("beta")
    return torch.clamp((a.f if a is not None else 0.2) * _t(xs[0])
                       + (b.f if b is not None else 0.5), 0.0, 1.0)


@onnx_op("HardSwish")
def _hard_swish(node, xs):
    return F.hardswish(_float_in(xs[0]))


@onnx_op("PRelu")
def _prelu(node, xs):
    x, slope = _t(xs[0]), _t(xs[1])
    return torch.where(x >= 0, x, slope * x)


@onnx_op("Softplus")
def _softplus_onnx(node, xs):
    x = _float_in(xs[0])
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


@onnx_op("Tile")
def _tile_onnx(node, xs):
    return torch.tile(_t(xs[0]), _ints(xs[1]))


@onnx_op("Range")
def _range(node, xs):
    start, limit, delta = (_np(v).item() for v in xs[:3])
    return np.arange(start, limit, delta)


@onnx_op("CumSum")
def _cumsum(node, xs):
    return torch.cumsum(_t(xs[0]), dim=_int(xs[1]))


@onnx_op("OneHot")
def _one_hot(node, xs):
    depth = _int(xs[1])
    values = _np(xs[2]).ravel()  # [off, on]
    ax = node.attr("axis")
    axis = ax.i if ax is not None and ax.i is not None else -1
    oh = one_hot(xs[0], depth, axis)
    return oh * float(values[1] - values[0]) + float(values[0])


@onnx_op("TopK")
def _topk(node, xs):
    k = _int(xs[1]) if len(xs) > 1 else node.attr("k").i
    ax = node.attr("axis")
    axis = ax.i if ax is not None and ax.i is not None else -1
    lg = node.attr("largest")
    largest = bool(lg.i) if lg is not None and lg.i is not None else True
    v, i = torch.topk(_t(xs[0]), k, dim=axis, largest=largest)
    return v, i.long()


@onnx_op("Einsum")
def _einsum(node, xs):
    eq = node.attr("equation").s
    return torch.einsum(eq, *promote(*xs))


@onnx_op("Trilu")
def _trilu(node, xs):
    upper = node.attr("upper")
    k = _int(xs[1]) if _opt(xs, 1) is not None else 0
    x = _t(xs[0])
    if upper is None or upper.i:
        return torch.triu(x, k)
    return torch.tril(x, k)


@onnx_op("GatherElements")
def _gather_elements(node, xs):
    ax = node.attr("axis")
    x, idx = _t(xs[0]), _t(xs[1]).long()
    axis = (ax.i if ax is not None else 0) % x.dim()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return torch.gather(x, axis, idx)


@onnx_op("GatherND")
def _gather_nd(node, xs):
    idx = _t(xs[1]).long()
    return _t(xs[0])[tuple(torch.movedim(idx, -1, 0))]


@onnx_op("ScatterND")
def _scatter_nd(node, xs):
    data, idx, upd = _t(xs[0]), _t(xs[1]).long(), _t(xs[2])
    return data.index_put(tuple(torch.movedim(idx, -1, 0)), upd.to(data.dtype))


_SCATTER_REDUCE = {"mul": "prod", "max": "amax", "min": "amin"}


@onnx_op("ScatterElements")
def _scatter_elements(node, xs):
    data, idx, upd = _t(xs[0]), _t(xs[1]).long(), _t(xs[2])
    ax = node.attr("axis")
    axis = (ax.i if ax is not None else 0) % data.dim()
    red = node.attr("reduction")
    red = red.s if red is not None else "none"
    upd = upd.to(data.dtype)
    if red == "add":
        return data.scatter_add(axis, idx, upd)
    if red in _SCATTER_REDUCE:
        return data.scatter_reduce(axis, idx, upd, _SCATTER_REDUCE[red])
    return data.scatter(axis, idx, upd)


@onnx_op("InstanceNormalization")
def _instance_norm(node, xs):
    eps = node.attr("epsilon")
    eps_v = eps.f if eps is not None else 1e-5
    x, scale, bias = _t(xs[0]), _t(xs[1]), _t(xs[2])  # NCHW: spatial stats
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return _norm_over(x, tuple(range(2, x.dim())), eps_v) \
        * scale.reshape(shape) + bias.reshape(shape)


@onnx_op("GroupNormalization")
def _group_norm_onnx(node, xs):
    eps = node.attr("epsilon")
    eps_v = eps.f if eps is not None else 1e-5
    groups = node.attr("num_groups").i
    x, scale, bias = _t(xs[0]), _t(xs[1]), _t(xs[2])  # NCHW
    B, C = x.shape[0], x.shape[1]
    xg = x.reshape((B, groups, C // groups) + tuple(x.shape[2:]))
    xg = _norm_over(xg, tuple(range(2, xg.dim())), eps_v)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return xg.reshape(x.shape) * scale.reshape(shape) + bias.reshape(shape)


_RESIZE_MODES = {"nearest": "nearest-exact", "linear": "linear"}


@onnx_op("Resize")
def _resize(node, xs):
    """jax.image.resize over the trailing spatial axes (leading N and C
    unchanged): half-pixel nearest, or linear with an antialiasing filter
    when shrinking. Cubic (jax's Keys a = -0.5) has no PyTorch
    counterpart and raises."""
    mode = node.attr("mode")
    mode_s = mode.s if mode is not None else "nearest"
    if mode_s not in _RESIZE_MODES:
        raise NotImplementedError(f"Resize mode {mode_s!r} is not supported")
    x = _t(xs[0])
    sizes = _opt(xs, 3)
    if sizes is not None:
        out_shape = tuple(_ints(sizes))
    else:
        scales = _np(_opt(xs, 2)).ravel()
        out_shape = tuple(int(round(d * sc))
                          for d, sc in zip(x.shape, scales))
    if tuple(out_shape[:2]) != tuple(x.shape[:2]) or x.dim() not in (3, 4, 5):
        raise NotImplementedError("Resize of the batch or channel axis")
    spatial = out_shape[2:]
    m = _RESIZE_MODES[mode_s]
    if m == "linear":
        m = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(spatial)]
        shrink = any(o < i for o, i in zip(spatial, x.shape[2:]))
        return F.interpolate(x, size=spatial, mode=m, align_corners=False,
                             antialias=shrink and len(spatial) == 2)
    return F.interpolate(x, size=spatial, mode=m)


@onnx_op("GlobalMaxPool")
def _gmp(node, xs):
    x = _t(xs[0])
    return x.amax(dim=tuple(range(2, x.dim())), keepdim=True)


class OnnxImportedGraph:
    def __init__(self, nodes: List[OnnxNode], initializers: Dict[str, np.ndarray],
                 inputs: List[str], outputs: List[str],
                 input_info: Optional[Dict[str, tuple]] = None,
                 device="cpu"):
        self.nodes = nodes
        self.initializers = initializers
        self.graph_inputs = [i for i in inputs if i not in initializers]
        self.graph_outputs = outputs
        # (np dtype | None, static shape tuple | None) per declared input —
        # seeds the import-graph optimizer's shape-inference env
        self.input_info = dict(input_info or {})
        # import-graph optimizer state: values folded to constants at
        # import time (never trainable), removed-value aliases, and the
        # per-rule rewrite counts
        self._folded: Dict[str, np.ndarray] = {}
        self._aliases: Dict[str, str] = {}
        self._removed: set = set()
        self.import_opt_stats: Optional[Dict[str, int]] = None
        self.device = torch.device(device)
        self._device_cache: Dict[int, tuple] = {}

    def to_device(self):
        """Put every initializer and folded value on the graph's device
        (once; ``import_model`` calls it)."""
        self._device_cache = place(
            list(self.initializers.values()) + list(self._folded.values()),
            self.device)
        return self

    def output(self, feeds: Dict[str, object],
               outputs: Optional[List[str]] = None):
        """Run the graph. Feeds go to the graph's device; outputs are torch
        tensors there."""
        acts: Dict[str, object] = dict(self.initializers)
        acts.update(self._folded)
        for k, v in feeds.items():
            acts[k] = feed(v, self.device)
        with running(self.device, self._device_cache):
            return self._run(acts, outputs)

    def _run(self, acts: Dict[str, object],
             outputs: Optional[List[str]] = None):
        for node in self.nodes:
            node_outs = node.outputs or [node.name]
            if all(o in acts for o in node_outs):
                continue  # pre-folded constant (as_trainable bakes these)
            fn = ONNX_OP_REGISTRY.get(node.op)
            if fn is None:
                raise NotImplementedError(
                    f"ONNX op '{node.op}' (node {node.name}) has no mapper; "
                    f"register one with @onnx_op('{node.op}')")
            # empty names mark omitted optional inputs; keep positions
            xs = [acts[i] if i else None for i in node.inputs]
            y = apply_mapper(fn, node, xs)
            outs = node.outputs or [node.name]
            if isinstance(y, (list, tuple)):
                for o, v in zip(outs, y):
                    acts[o] = v
            else:
                acts[outs[0]] = y
        from deeplearning4j_tpu_torch.modelimport.optimizer import resolve_alias

        names = outputs or self.graph_outputs
        res = []
        for n in names:
            key = resolve_alias(self._aliases, n)
            if key not in acts and n in self._removed:
                raise KeyError(
                    f"{n!r} was removed by the import-graph optimizer; "
                    f"re-import with DL4J_TORCH_IMPORT_OPT=0 (or "
                    f"optimize=False) to probe it")
            res.append(output_value(acts[key], self.device))
        return res[0] if len(res) == 1 else res

    def as_function(self, outputs: Optional[List[str]] = None) -> Callable:
        def fn(**feeds):
            return self.output(feeds, outputs)

        return fn

    def fold_constants(self, exclude=()):
        """Evaluate every node reachable from Constants/initializers alone
        (none of the graph inputs, none of ``exclude``) on the host,
        returning {output_name: numpy value}: the exporter-emitted shape
        arithmetic (Shape->Mul->Equal->Where feeding Expand/Reshape static
        arguments) is folded once instead of at every call."""
        known: Dict[str, object] = {k: v for k, v in self.initializers.items()
                                    if k not in exclude}
        known.update({k: v for k, v in self._folded.items()
                      if k not in exclude})
        folded: Dict[str, object] = {}
        avail = set(known)
        for node in self.nodes:
            ins = [i for i in node.inputs if i]
            fn = ONNX_OP_REGISTRY.get(node.op)
            if fn is None or not all(i in avail for i in ins):
                continue
            xs = [(folded.get(i, known.get(i)) if i else None)
                  for i in node.inputs]
            try:
                y = apply_mapper(fn, node, xs)
            except Exception as e:
                # Expected for ops whose mapper needs runtime feeds; logged
                # so a genuine mapper bug is not silently deferred into a
                # confusing error later.
                logging.getLogger(__name__).debug(
                    "fold_constants: deferring %s node %r to runtime (%s: %s)",
                    node.op, node.name, type(e).__name__, e)
                continue
            outs = node.outputs or [node.name]
            vals = y if isinstance(y, (list, tuple)) else [y]
            for o, v in zip(outs, vals):
                folded[o] = np.asarray(v)
                avail.add(o)
        return folded

    # input positions read as STATIC arguments (host reads in the mapper):
    # initializers consumed here must stay host values, never parameters
    _STATIC_ARG_POS = {
        "Reshape": {1}, "Expand": {1}, "Slice": {1, 2, 3, 4},
        "Squeeze": {1}, "Unsqueeze": {1}, "Tile": {1}, "TopK": {1},
        "Pad": {1, 2, 3}, "ConstantOfShape": {0}, "Range": {0, 1, 2},
        "OneHot": {1, 2}, "CumSum": {1}, "Split": {1}, "Trilu": {1},
        "Resize": {1, 2, 3}, "ReduceMean": {1}, "ReduceSum": {1},
        "ReduceMax": {1}, "ReduceMin": {1}, "ReduceProd": {1},
        "ReduceL1": {1}, "ReduceL2": {1}, "ReduceLogSumExp": {1},
        "ReduceSumSquare": {1},
    }

    def _static_arg_names(self):
        out = set()
        for node in self.nodes:
            pos = self._STATIC_ARG_POS.get(node.op)
            if not pos:
                continue
            for i, name in enumerate(node.inputs):
                if i in pos and name:
                    out.add(name)
        return out

    def as_trainable(self, outputs: Optional[List[str]] = None,
                     trainable: Optional[List[str]] = None,
                     compute_dtype=None):
        """(fn, params) for FINE-TUNING the imported model.

        The initializers become function ARGUMENTS instead of baked
        constants: ``fn(params, feeds) -> outputs`` is differentiable
        (autograd, torch.func) with respect to ``params``, fresh tensors on
        the graph's device. ``trainable`` restricts which initializers move
        (the rest stay frozen constants); default: every float initializer
        of rank >= 1 not read as a static argument.

        ``compute_dtype``: mixed-precision fine-tuning with torch-autocast
        semantics. Float FROZEN constants (folded subgraphs, scalar
        eps/scale consts) are cast to it once, and while ``fn`` runs every
        Cast to FLOAT/DOUBLE gives it — integer-sourced casts (attention
        masks, position ids) included — so params cast to it are never
        promoted back to f32 mid-graph. Integer-derived float values
        outside its exact range (> 256 for bf16) round. Integer/bool
        constants keep their types. None keeps the exported types.
        """
        if trainable is not None:
            names = trainable
        else:
            static = self._static_arg_names()
            names = [k for k, v in self.initializers.items()
                     if np.issubdtype(np.asarray(v).dtype, np.floating)
                     and np.ndim(v) >= 1 and k not in static]
        params = {k: to_torch(self.initializers[k], self.device)
                  for k in names}
        baked = self.fold_constants(exclude=set(names))
        consts: Dict[str, object] = dict(self.initializers)
        consts.update(self._folded)
        consts.update(baked)
        # the baked values go to the device once, here
        cache = dict(self._device_cache)
        cache.update(place(baked.values(), self.device))
        if compute_dtype is not None:
            consts, cache = cast_frozen(consts, set(), compute_dtype,
                                        self.device, cache)

        def fn(params, feeds):
            acts = dict(consts)
            acts.update(params)
            for k, v in feeds.items():
                acts[k] = feed(v, self.device)
            token = CAST_FLOAT_OVERRIDE.set(compute_dtype)
            try:
                with running(self.device, cache):
                    return self._run(acts, outputs)
            finally:
                CAST_FLOAT_OVERRIDE.reset(token)

        return fn, params


def _parse_value_info(buf: bytes):
    """ValueInfoProto -> (name, (np dtype | None, static shape | None)).
    TypeProto.tensor_type(1): elem_type=1, shape=2 (TensorShapeProto.dim=1,
    each dim_value=1 / dim_param=2 — symbolic dims become None)."""
    f = parse_message(buf)
    name = f[1][0].decode()
    dtype, shape = None, None
    if 2 in f:
        tp = parse_message(f[2][0])
        if 1 in tp:
            tt = parse_message(tp[1][0])
            if 1 in tt:
                dtype = _ONNX_DTYPES.get(tt[1][0])
                dtype = np.dtype(dtype) if dtype is not None else None
            if 2 in tt:
                dims = []
                for db in parse_message(tt[2][0]).get(1, []):
                    d = parse_message(db)
                    dims.append(int(d[1][0]) if 1 in d else None)
                shape = tuple(dims)
    return name, (dtype, shape)


class OnnxModelImport:
    """importModel entry point (the ONNX analog of KerasModelImport)."""

    @staticmethod
    def import_model(path_or_bytes, optimize: Optional[bool] = None,
                     device="cuda") -> OnnxImportedGraph:
        """Import an ONNX model (a path or its bytes) onto ``device`` (the
        card unless the caller asks for "cpu")."""
        dev = resolve_device(device)
        if isinstance(path_or_bytes, (bytes, bytearray)):
            buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
        model = parse_message(buf)            # ModelProto: graph = 7
        graph = parse_message(model[7][0])    # GraphProto
        nodes = [OnnxNode(b) for b in graph.get(1, [])]
        inits = dict(_parse_onnx_tensor(b) for b in graph.get(5, []))
        in_infos = dict(_parse_value_info(b) for b in graph.get(11, []))
        outputs = [parse_message(b)[1][0].decode() for b in graph.get(12, [])]
        imp = OnnxImportedGraph(nodes, inits, list(in_infos), outputs,
                                input_info=in_infos, device=dev)
        from deeplearning4j_tpu_torch.modelimport import optimizer as graph_opt

        if optimize if optimize is not None else graph_opt.import_opt_enabled():
            graph_opt.optimize_onnx(imp)
        return imp.to_device()
