"""TensorFlow frozen-graph (GraphDef) and SavedModel import.

Counterpart of ``deeplearning4j_tpu/modelimport/tensorflow.py``
(TFGraphMapper): a protobuf wire-format reader for the GraphDef, NodeDef,
AttrValue and TensorProto subset a frozen graph needs (no tensorflow, no
generated classes), then each node mapped onto PyTorch ops.

Where values live. As in the JAX package, a graph's constants stay numpy
on the host, so that static arguments (reshape targets, axes, sizes, slice
bounds) are read without touching the card. Each import puts every constant
on its device once (``device="cuda"`` by default): a node that computes
with one takes that copy. A node whose inputs are all host values (the
exporter's shape arithmetic: Shape, Size, Range, their casts and slices)
is evaluated on the host and gives numpy again, the counterpart of jnp
folding concrete values eagerly. Every other node runs on the graph's
device and gives a torch tensor there. Host arrays enter PyTorch with the
JAX package's 32-bit float type (float64 becomes float32); integer types
are kept (int64 index tensors stay int64 where the JAX package has int32).

The section "values" below is shared with the ONNX frontend.
"""

from __future__ import annotations

import contextlib
import contextvars
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.sd_ops import fake_quant
from deeplearning4j_tpu_torch.common.device import resolve_device

# ------------------------------------------------------------ wire format


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, list]:
    """Parse one protobuf message into {field_number: [raw values]}.
    wire type 0 -> int, 1 -> 8 bytes, 2 -> bytes, 5 -> 4 bytes."""
    fields: Dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {field})")
        fields.setdefault(field, []).append(val)
    return fields


def _zigzag_ok_int64(v: int) -> int:
    # protobuf int64 comes as two's complement in a 64-bit varint
    return v - (1 << 64) if v >= (1 << 63) else v


# ------------------------------------------------------ GraphDef subschema

_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           6: np.int8, 7: object, 9: np.int64, 10: bool}


def _parse_shape(buf: bytes) -> List[int]:
    fields = parse_message(buf)
    dims = []
    for dim_buf in fields.get(2, []):
        d = parse_message(dim_buf)
        size = _zigzag_ok_int64(d.get(1, [0])[0])
        dims.append(int(size))
    return dims


def _parse_tensor(buf: bytes) -> np.ndarray:
    """TensorProto per TF's tensor.proto field numbering:
    dtype=1, tensor_shape=2, tensor_content=4, float_val=5, double_val=6,
    int_val=7, string_val=8, int64_val=10, bool_val=11."""
    f = parse_message(buf)
    dtype_enum = f.get(1, [1])[0]
    dtype = _DTYPES.get(dtype_enum, np.float32)
    shape = _parse_shape(f[2][0]) if 2 in f else []
    if 4 in f and f[4][0]:  # tensor_content: raw bytes, one view
        arr = np.frombuffer(f[4][0], dtype=dtype)
        # shape == [] is a RANK-0 tensor; the reshape matters for control
        # flow (a scalar loop counter must stay int32[], not int32[1])
        return arr.reshape(shape) if (shape or arr.size == 1) else arr

    def fixed_vals(raws, fmt, width):
        # a raw entry is either one unpacked fixed value (wire type 5/1,
        # `width` bytes) or a packed run (wire type 2) — both decode as a
        # stream of `width`-byte values
        out = []
        for raw in raws:
            out.extend(struct.unpack(fmt, raw[i:i + width])[0]
                       for i in range(0, len(raw), width))
        return out

    def varint_vals(raws):
        out = []
        for raw in raws:
            if isinstance(raw, int):           # unpacked varint
                out.append(_zigzag_ok_int64(raw))
            else:                               # packed varint run
                pos = 0
                while pos < len(raw):
                    v, pos = _read_varint(raw, pos)
                    out.append(_zigzag_ok_int64(v))
        return out

    for field, dt, decode in (
            (5, np.float32, lambda r: fixed_vals(r, "<f", 4)),
            (6, np.float64, lambda r: fixed_vals(r, "<d", 8)),
            (7, np.int32, varint_vals),
            (10, np.int64, varint_vals),
            (11, bool, varint_vals)):
        if field in f:
            arr = np.asarray(decode(f[field]), dtype=dt)
            n = int(np.prod(shape)) if shape else len(arr)
            if len(arr) == 1 and n > 1:  # single-value splat convention
                arr = np.full(n, arr[0], dt)
            return arr.reshape(shape) if (shape or arr.size == 1) else arr
    return np.zeros(shape, dtype)


class AttrValue:
    def __init__(self, buf: bytes):
        f = parse_message(buf)
        # `s` attrs are usually ASCII (padding/data_format/shared_name) but
        # TF2 graphs also stash serialized protos in string attrs — keep
        # those as raw bytes (no consumer compares them against str)
        self.s = None
        if 2 in f:
            try:
                self.s = f[2][0].decode()
            except UnicodeDecodeError:
                self.s = f[2][0]
        self.i = _zigzag_ok_int64(f[3][0]) if 3 in f else None
        self.f = struct.unpack("<f", f[4][0])[0] if 4 in f else None
        self.b = bool(f[5][0]) if 5 in f else None
        self.type = f[6][0] if 6 in f else None
        self.shape = _parse_shape(f[7][0]) if 7 in f else None
        self.tensor = _parse_tensor(f[8][0]) if 8 in f else None
        # field 10: NameAttrList func (If/While branch and body references)
        self.func_name = None
        if 10 in f:
            nf = parse_message(f[10][0])
            if 1 in nf:
                self.func_name = nf[1][0].decode()
        self.list_i: List[int] = []
        self.list_s: List[str] = []
        if 1 in f:  # ListValue
            lf = parse_message(f[1][0])
            for raw in lf.get(3, []):   # repeated int64 (possibly packed)
                if isinstance(raw, int):
                    self.list_i.append(_zigzag_ok_int64(raw))
                else:
                    pos = 0
                    while pos < len(raw):
                        v, pos = _read_varint(raw, pos)
                        self.list_i.append(_zigzag_ok_int64(v))
            self.list_s = [b.decode() for b in lf.get(2, [])]


class NodeDef:
    def __init__(self, buf: bytes):
        f = parse_message(buf)
        self.name = f[1][0].decode()
        self.op = f[2][0].decode()
        self.inputs = [b.decode() for b in f.get(3, [])]
        self.attrs: Dict[str, AttrValue] = {}
        for entry in f.get(5, []):
            ef = parse_message(entry)
            key = ef[1][0].decode()
            self.attrs[key] = AttrValue(ef[2][0])

    def attr(self, key, default=None):
        return self.attrs.get(key, default)


class TFFunction:
    """FunctionDef: signature(OpDef)=1, node_def=3, ret=4. TF2 control flow
    (If/While/PartitionedCall) keeps branch and body graphs as functions in
    GraphDef.library; each runs through the same node loop."""

    def __init__(self, fbuf: bytes):
        f = parse_message(fbuf)
        sig = parse_message(f[1][0])
        self.name = sig[1][0].decode()
        self.in_args = [parse_message(b)[1][0].decode()
                        for b in sig.get(2, [])]
        self.out_args = [parse_message(b)[1][0].decode()
                         for b in sig.get(3, [])]
        self.nodes = [NodeDef(b) for b in f.get(3, [])]
        self.ret: Dict[str, str] = {}
        for entry in f.get(4, []):
            ef = parse_message(entry)
            self.ret[ef[1][0].decode()] = ef[2][0].decode()


def parse_graph_def(buf: bytes) -> List[NodeDef]:
    fields = parse_message(buf)
    return [NodeDef(b) for b in fields.get(1, [])]


def parse_graph(buf: bytes):
    """(nodes, functions) — GraphDef field 1 = node, field 2 = library."""
    fields = parse_message(buf)
    nodes = [NodeDef(b) for b in fields.get(1, [])]
    functions: Dict[str, TFFunction] = {}
    if 2 in fields:
        lib = parse_message(fields[2][0])
        for fb in lib.get(1, []):
            fn = TFFunction(fb)
            functions[fn.name] = fn
    return nodes, functions


# ----------------------------------------------------------------- values


class _Run:
    """One execution of an imported graph: its device, the device copies of
    its constants ({id(array): (array, tensor)}) and whether the node now
    being evaluated runs on the host."""

    __slots__ = ("device", "cache", "host")

    def __init__(self, device, cache):
        self.device = device
        self.cache = cache
        self.host = True


_RUN: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_torch_import_run", default=None)


@contextlib.contextmanager
def running(device, cache):
    """Make (device, cache) the current run for the mappers."""
    token = _RUN.set(_Run(device, cache))
    try:
        yield
    finally:
        _RUN.reset(token)


def _host_array(x) -> np.ndarray:
    """A host value as numpy in the type PyTorch computes it in: float64
    becomes float32, as in the JAX package (64-bit types off)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return a


def to_torch(x, device=None) -> torch.Tensor:
    """A host value as a torch tensor (on ``device``, default the CPU)."""
    a = _host_array(x)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")  # a copy; keeps rank 0
    t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def place(values, device) -> Dict[int, tuple]:
    """Device copies of a graph's constants, made once: {id(array): (array,
    tensor)}. Arrays PyTorch cannot hold (strings) are left on the host."""
    cache = {}
    for v in values:
        if isinstance(v, np.ndarray) and v.dtype != object \
                and id(v) not in cache:
            cache[id(v)] = (v, to_torch(v, device))
    return cache


def _t(x) -> torch.Tensor:
    """A data operand as a torch tensor where the current node runs: on the
    host (CPU) for a host node, else on the run's device (a constant's
    device copy when it has one)."""
    run = _RUN.get()
    if isinstance(x, torch.Tensor):
        if run is not None and not run.host and x.device != run.device:
            return x.to(run.device)
        return x
    if run is None or run.host:
        return to_torch(x)
    hit = run.cache.get(id(x))
    if hit is not None and hit[0] is x:
        return hit[1]
    return to_torch(x, run.device)


def _np(x) -> np.ndarray:
    """A static argument (shape, axes, sizes, bounds) as a host array. Host
    values and constants cast by ``cast_frozen`` are read for free; any
    other device tensor costs a copy to the host (a sync), and a tensor
    under a torch.func transform cannot be read."""
    if isinstance(x, torch.Tensor):
        run = _RUN.get()
        hit = run.cache.get(id(x)) if run is not None else None
        if hit is not None and hit[0] is x:
            return hit[1]
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def cast_frozen(acts, skip, dtype, device, cache):
    """compute_dtype's frozen constants: every float host value of ``acts``
    not named in ``skip`` becomes a ``dtype`` tensor on ``device``, once.
    Returns the new acts and a cache that also maps each such tensor back
    to its host value, so that a static read of one stays free."""
    acts, cache = dict(acts), dict(cache)
    for k, v in acts.items():
        if k in skip or not isinstance(v, np.ndarray) \
                or not np.issubdtype(v.dtype, np.floating):
            continue
        t = to_torch(v, device).to(dtype)
        acts[k] = t
        cache[id(t)] = (t, _host_array(v))
    return acts, cache


def _to_host(y):
    if isinstance(y, torch.Tensor):
        try:
            return y.numpy()
        except TypeError:          # no numpy type (bfloat16): stays torch
            return y
    if isinstance(y, tuple):
        return tuple(_to_host(v) for v in y)
    if isinstance(y, list):
        return [_to_host(v) for v in y]
    return y


def _is_device_value(x, run) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    if run is None or not isinstance(x, np.ndarray):
        return False
    hit = run.cache.get(id(x))
    # a float constant with more than one element (a weight) is computed
    # with on the device; small constants and integers stay host values
    return (hit is not None and hit[0] is x and x.ndim >= 1 and x.size > 1
            and np.issubdtype(x.dtype, np.floating))


def apply_mapper(fn, node, xs):
    """Evaluate one mapper: on the host when no input is a device value
    (the result is numpy), else on the run's device."""
    run = _RUN.get()
    host = not any(_is_device_value(x, run) for x in xs)
    if run is None:
        return _to_host(fn(node, xs)) if host else fn(node, xs)
    prev = run.host
    run.host = host
    try:
        y = fn(node, xs)
    finally:
        run.host = prev
    return _to_host(y) if host else y


def feed(v, device) -> torch.Tensor:
    """A caller's feed as a tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v if v.device == device else v.to(device)
    return to_torch(v, device)


def output_value(v, device):
    """What an entry point returns for one output: a torch tensor on the
    graph's device (host values are moved there)."""
    if isinstance(v, torch.Tensor):
        return v if v.device == device else v.to(device)
    if isinstance(v, np.ndarray) and v.dtype != object:
        return to_torch(v, device)
    if isinstance(v, tuple):
        return tuple(output_value(a, device) for a in v)
    return v


# compute_dtype of as_trainable (torch-autocast semantics): while set, every
# Cast to a 32/64-bit float, and the TF OneHot, give this type. A
# ContextVar, so concurrent runs of other graphs are never redirected.
CAST_FLOAT_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_torch_cast_float_override", default=None)

_FLOAT_DESTS = (torch.float32, torch.float64)


def cast_dest(dt: torch.dtype) -> torch.dtype:
    """The type a Cast to ``dt`` gives: float64 computes as float32 (as in
    the JAX package), and a float destination takes the compute dtype
    override when one is set."""
    override = CAST_FLOAT_OVERRIDE.get()
    if override is not None and dt in _FLOAT_DESTS:
        return override
    return torch.float32 if dt == torch.float64 else dt


def promote(*xs):
    """Operands of one product in one floating type (torch's matmul needs
    it; jnp promotes)."""
    ts = [_t(x) for x in xs]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def _ints(x) -> List[int]:
    return [int(v) for v in _np(x).ravel()]


def _int(x) -> int:
    return int(_np(x).ravel()[0])


def take(x, idx, axis: int):
    """jnp.take: x's axis indexed by an index tensor of any shape (negative
    indices count from the end)."""
    x, idx = _t(x), _t(idx).long()
    axis = axis % x.dim()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return x[(slice(None),) * axis + (idx,)]


def reduce_axes(fn, x, axes, keepdims):
    """A reduction over a tuple of axes. ``axes == ()`` is the identity
    (TF's reduce over no axis), None reduces everything."""
    x = _t(x)
    if axes is None:
        axes = tuple(range(x.dim()))
    axes = tuple(sorted({a % x.dim() for a in axes})) if x.dim() else ()
    if not axes:
        return x
    return fn(x, axes, keepdims)


def _mean(x, axes, kd):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    return x.mean(dim=axes, keepdim=kd)


def _single_axis(reduce1):
    """A reduction PyTorch takes over one axis at a time, over several."""
    def fn(x, axes, kd):
        for a in sorted(axes, reverse=True):
            x = reduce1(x, a, kd)
        return x
    return fn


def _sum(x, axes, kd):
    return x.sum(dim=axes, keepdim=kd)


def _amax(x, axes, kd):
    return x.amax(dim=axes, keepdim=kd)


def _amin(x, axes, kd):
    return x.amin(dim=axes, keepdim=kd)


_prod = _single_axis(lambda x, a, kd: x.prod(dim=a, keepdim=kd))
_all = _single_axis(lambda x, a, kd: x.bool().all(dim=a, keepdim=kd))
_any = _single_axis(lambda x, a, kd: x.bool().any(dim=a, keepdim=kd))


def pad_pairs(x, pairs, value=0.0):
    """jnp.pad with a constant: ``pairs`` [(before, after)] per axis."""
    flat = []
    for a, b in reversed(list(pairs)):
        flat += [int(a), int(b)]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def pad_index(x, pairs, mode: str):
    """jnp.pad in "reflect", "symmetric" or "edge" mode, by gathering each
    axis through numpy's own padded index."""
    for axis, (a, b) in enumerate(pairs):
        if a or b:
            idx = np.pad(np.arange(x.shape[axis]), (int(a), int(b)),
                         mode=mode)
            x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return x


def slice_axes(x, items):
    """x[items] for a list of slices and integers, one per leading axis;
    a negative step reverses (PyTorch's basic indexing has none)."""
    for axis in reversed(range(len(items))):
        s = items[axis]
        if isinstance(s, slice):
            if s == slice(None):
                continue
            if s.step is not None and s.step < 0:
                idx = range(*s.indices(x.shape[axis]))
                x = x.index_select(axis, torch.as_tensor(
                    list(idx), dtype=torch.long, device=x.device))
            else:
                x = x[(slice(None),) * axis + (s,)]
        else:
            x = x.select(axis, int(s))
    return x


def one_hot(idx, depth: int, axis: int = -1, dtype=torch.float32):
    """jax.nn.one_hot: rows of zeros for indices outside [0, depth)."""
    idx = _t(idx).long()
    oh = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
    oh = oh.to(dtype)
    return oh if axis in (-1, oh.dim() - 1) else oh.movedim(-1, axis)


# --------------------------------------------------------------- op mapping

TF_OP_REGISTRY: Dict[str, Callable] = {}


def tf_op(*names):
    def deco(fn):
        for n in names:
            TF_OP_REGISTRY[n] = fn
        return fn
    return deco


def _pad_mode(node):
    a = node.attr("padding")
    return (a.s if a and a.s else "SAME").upper()


@tf_op("Add", "AddV2")
def _add(node, xs):
    return _t(xs[0]) + _t(xs[1])


@tf_op("Sub")
def _sub(node, xs):
    return _t(xs[0]) - _t(xs[1])


@tf_op("Mul")
def _mul(node, xs):
    return _t(xs[0]) * _t(xs[1])


@tf_op("RealDiv", "Div")
def _div(node, xs):
    return _t(xs[0]) / _t(xs[1])


@tf_op("MatMul")
def _matmul(node, xs):
    a, b = promote(xs[0], xs[1])
    ta, tb = node.attr("transpose_a"), node.attr("transpose_b")
    if ta and ta.b:
        a = a.transpose(-1, -2)
    if tb and tb.b:
        b = b.transpose(-1, -2)
    return a @ b


@tf_op("BiasAdd")
def _bias_add(node, xs):
    return _t(xs[0]) + _t(xs[1])


@tf_op("Relu")
def _relu(node, xs):
    return torch.relu(_t(xs[0]))


@tf_op("Relu6")
def _relu6(node, xs):
    return torch.clamp(_t(xs[0]), 0, 6)


@tf_op("Sigmoid")
def _sigmoid(node, xs):
    return torch.sigmoid(_t(xs[0]))


@tf_op("Tanh")
def _tanh(node, xs):
    return torch.tanh(_t(xs[0]))


@tf_op("Softmax")
def _softmax(node, xs):
    return torch.softmax(_t(xs[0]), dim=-1)


@tf_op("Identity", "StopGradient", "NoOp", "PreventGradient")
def _identity(node, xs):
    return xs[0] if xs else None


def _fq_attrs(node):
    nb = node.attr("num_bits")
    nr = node.attr("narrow_range")
    return (int(nb.i) if nb and nb.i is not None else 8,
            bool(nr.b) if nr and nr.b is not None else False)


@tf_op("FakeQuantWithMinMaxArgs")
def _tf_fake_quant_args(node, xs):
    nb, nr = _fq_attrs(node)
    mn = node.attr("min")
    mx = node.attr("max")
    return fake_quant(
        _t(xs[0]), _t(np.float32(mn.f if mn and mn.f is not None else -6.0)),
        _t(np.float32(mx.f if mx and mx.f is not None else 6.0)), nb, nr)


@tf_op("FakeQuantWithMinMaxVars", "FakeQuantWithMinMaxVarsPerChannel")
def _tf_fake_quant_vars(node, xs):
    nb, nr = _fq_attrs(node)
    return fake_quant(_t(xs[0]), _t(xs[1]), _t(xs[2]), nb, nr)


@tf_op("ReadVariableOp")
def _read_variable(node, xs):
    # the resource input already carries the checkpoint value (seeded by
    # import_saved_model), so a read is an identity
    return xs[0]


@tf_op("VarIsInitializedOp")
def _var_is_initialized(node, xs):
    return np.asarray(True)


@tf_op("Reshape")
def _reshape(node, xs):
    return _t(xs[0]).reshape(_ints(xs[1]))


@tf_op("Squeeze")
def _squeeze(node, xs):
    dims = node.attr("squeeze_dims") or node.attr("axis")
    x = _t(xs[0])
    if dims and dims.list_i:
        return x.squeeze(tuple(dims.list_i))
    return x.squeeze()


@tf_op("ExpandDims")
def _expand(node, xs):
    x = _t(xs[0])
    ax = _int(xs[1])
    return x.unsqueeze(ax if ax >= 0 else ax + x.dim() + 1)


def _keep_dims(node):
    keep = node.attr("keep_dims")
    return bool(keep.b) if keep else False


@tf_op("Mean")
def _mean_tf(node, xs):
    return reduce_axes(_mean, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("Max")
def _max(node, xs):
    return reduce_axes(_amax, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("ConcatV2")
def _concat(node, xs):
    return torch.cat([_t(x) for x in xs[:-1]], dim=_int(xs[-1]))


@tf_op("Conv2D")
def _conv2d(node, xs):
    from deeplearning4j_tpu_torch.ops.convolution import conv2d

    x, w = promote(xs[0], xs[1])  # NHWC, HWIO
    strides = node.attr("strides").list_i or [1, 1, 1, 1]
    return conv2d(x, w, strides=tuple(strides[1:3]),
                  padding=_pad_mode(node).lower())


@tf_op("DepthwiseConv2dNative")
def _dwconv(node, xs):
    from deeplearning4j_tpu_torch.ops.convolution import conv2d

    x, w = promote(xs[0], xs[1])  # w: [H, W, C, M]
    strides = node.attr("strides").list_i or [1, 1, 1, 1]
    h, wd, c, m = w.shape
    return conv2d(x, w.reshape(h, wd, 1, c * m), strides=tuple(strides[1:3]),
                  padding=_pad_mode(node).lower(), groups=c)


@tf_op("MaxPool")
def _maxpool(node, xs):
    from deeplearning4j_tpu_torch.ops.convolution import maxpool2d

    k = node.attr("ksize").list_i
    s = node.attr("strides").list_i
    return maxpool2d(_t(xs[0]), kernel=tuple(k[1:3]), strides=tuple(s[1:3]),
                     padding=_pad_mode(node).lower())


@tf_op("AvgPool")
def _avgpool(node, xs):
    from deeplearning4j_tpu_torch.ops.convolution import avgpool2d

    k = node.attr("ksize").list_i
    s = node.attr("strides").list_i
    # SAME divides by the real window count, VALID by the window size
    return avgpool2d(_t(xs[0]), kernel=tuple(k[1:3]), strides=tuple(s[1:3]),
                     padding=_pad_mode(node).lower())


@tf_op("Pad")
def _pad_op(node, xs):
    pads = _np(xs[1]).reshape(-1, 2)
    return pad_pairs(_t(xs[0]), [(int(a), int(b)) for a, b in pads])


@tf_op("GatherV2", "Gather")
def _gather(node, xs):
    bd = node.attr("batch_dims")
    if bd and bd.i:
        raise NotImplementedError("GatherV2 batch_dims > 0 is not supported")
    axis = _int(xs[2]) if len(xs) > 2 else 0
    return take(xs[0], xs[1], axis)


@tf_op("BatchMatMul", "BatchMatMulV2")
def _batch_matmul(node, xs):
    a, b = promote(xs[0], xs[1])
    adj_x, adj_y = node.attr("adj_x"), node.attr("adj_y")
    if adj_x and adj_x.b:
        a = a.transpose(-1, -2)
    if adj_y and adj_y.b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@tf_op("Transpose")
def _transpose(node, xs):
    return _t(xs[0]).permute(_ints(xs[1]))


def _float_in(x):
    """An operand of a float-valued function, integers widened to float32
    as jnp does."""
    x = _t(x)
    return x if x.is_floating_point() else x.float()


@tf_op("Erf")
def _erf(node, xs):
    return torch.special.erf(_float_in(xs[0]))


@tf_op("Pow")
def _pow(node, xs):
    return torch.pow(_t(xs[0]), _t(xs[1]))


@tf_op("Rsqrt")
def _rsqrt(node, xs):
    return 1.0 / torch.sqrt(_float_in(xs[0]))


@tf_op("Sqrt")
def _sqrt(node, xs):
    return torch.sqrt(_float_in(xs[0]))


@tf_op("Square")
def _square(node, xs):
    return torch.square(_t(xs[0]))


@tf_op("SquaredDifference")
def _sqdiff(node, xs):
    d = _t(xs[0]) - _t(xs[1])
    return d * d


@tf_op("Neg")
def _neg(node, xs):
    return -_t(xs[0])


@tf_op("Exp")
def _exp(node, xs):
    return torch.exp(_float_in(xs[0]))


@tf_op("Log")
def _log(node, xs):
    return torch.log(_float_in(xs[0]))


@tf_op("Abs")
def _abs(node, xs):
    return torch.abs(_t(xs[0]))


@tf_op("Maximum")
def _maximum(node, xs):
    a, b = promote(xs[0], xs[1])
    return torch.maximum(a, b)


@tf_op("Minimum")
def _minimum(node, xs):
    a, b = promote(xs[0], xs[1])
    return torch.minimum(a, b)


@tf_op("AddN")
def _add_n(node, xs):
    out = _t(xs[0])
    for x in xs[1:]:
        out = out + _t(x)
    return out


@tf_op("LeakyRelu")
def _leaky_relu(node, xs):
    a = node.attr("alpha")
    return F.leaky_relu(_t(xs[0]), a.f if a and a.f is not None else 0.2)


@tf_op("Softplus")
def _softplus(node, xs):
    x = _float_in(xs[0])
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


_TF_CAST_DTYPES = {1: torch.float32, 2: torch.float64, 3: torch.int32,
                   4: torch.uint8, 5: torch.int16, 6: torch.int8,
                   9: torch.int64, 10: torch.bool, 14: torch.bfloat16,
                   17: torch.uint16, 19: torch.float16, 22: torch.uint32,
                   23: torch.uint64}
# the same codes as numpy types, for the optimizer's shape inference
# (bfloat16, which numpy lacks, is left out: an unknown type there)
TF_NP_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
                5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
                17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64}


@tf_op("Cast")
def _cast(node, xs):
    dst = node.attr("DstT")
    code = dst.type if dst else 1
    if code not in _TF_CAST_DTYPES:
        raise NotImplementedError(f"Cast to TF dtype enum {code} is not supported")
    return _t(xs[0]).to(cast_dest(_TF_CAST_DTYPES[code]))


@tf_op("OneHot")
def _one_hot(node, xs):
    ax = node.attr("axis")
    if ax and ax.i is not None and ax.i not in (-1,):
        raise NotImplementedError("OneHot axis != -1 is not supported")
    depth = _int(xs[1])
    on = float(_np(xs[2]).ravel()[0]) if len(xs) > 2 else 1.0
    off = float(_np(xs[3]).ravel()[0]) if len(xs) > 3 else 0.0
    oh = one_hot(xs[0], depth, dtype=cast_dest(torch.float32))
    return oh * (on - off) + off


@tf_op("Sum")
def _sum_tf(node, xs):
    return reduce_axes(_sum, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("Slice")
def _slice_op(node, xs):
    x = _t(xs[0])
    begin = _ints(xs[1])
    size = _ints(xs[2])
    size = [n - b if s == -1 else s for b, s, n in zip(begin, size, x.shape)]
    # lax.dynamic_slice clamps the start so the slice fits
    items = [slice(min(max(b, 0), n - s), min(max(b, 0), n - s) + s)
             for b, s, n in zip(begin, size, x.shape)]
    return slice_axes(x, items)


@tf_op("StridedSlice")
def _strided_slice_op(node, xs):
    # begin/end/shrink-axis masks supported; ellipsis/new-axis raise rather
    # than silently mis-slicing (the importer's fail-loud convention)
    for unsupported in ("ellipsis_mask", "new_axis_mask"):
        a = node.attr(unsupported)
        if a and a.i:
            raise NotImplementedError(f"StridedSlice {unsupported} is not supported")
    begin, end, strides = _ints(xs[1]), _ints(xs[2]), _ints(xs[3])
    bm = node.attr("begin_mask")
    em = node.attr("end_mask")
    sm = node.attr("shrink_axis_mask")
    bm = bm.i if bm and bm.i else 0
    em = em.i if em and em.i else 0
    sm = sm.i if sm and sm.i else 0
    sl = []
    for i, (b, e, s) in enumerate(zip(begin, end, strides)):
        if sm & (1 << i):
            sl.append(b)  # integer index performs the shrink
        else:
            sl.append(slice(None if bm & (1 << i) else b,
                            None if em & (1 << i) else e, s))
    return slice_axes(_t(xs[0]), sl)


@tf_op("Tile")
def _tile(node, xs):
    return torch.tile(_t(xs[0]), _ints(xs[1]))


@tf_op("FusedBatchNorm", "FusedBatchNormV3")
def _fused_bn(node, xs):
    x, scale, offset, mean, var = (_t(v) for v in xs[:5])
    eps = node.attr("epsilon")
    eps = eps.f if eps and eps.f is not None else 1e-4  # TF op default
    inv = scale / torch.sqrt(var + eps)
    return x * inv + (offset - mean * inv)


# ---- breadth families: comparisons/selects, shape/packing, image resize,
# indexed ops, reductions — the EfficientNet/MobileNet/BERT-era frozen-graph
# vocabulary beyond the core CNN set ----

def _binary(f):
    def fn(node, xs):
        return f(_t(xs[0]), _t(xs[1]))
    return fn


def _unary(f):
    def fn(node, xs):
        return f(_t(xs[0]))
    return fn


def _float_unary(f):
    def fn(node, xs):
        return f(_float_in(xs[0]))
    return fn


for _nm, _f in [("Greater", torch.gt), ("GreaterEqual", torch.ge),
                ("Less", torch.lt), ("LessEqual", torch.le),
                ("Equal", torch.eq), ("NotEqual", torch.ne),
                ("LogicalAnd", torch.logical_and),
                ("LogicalOr", torch.logical_or),
                ("FloorDiv", torch.floor_divide), ("FloorMod", torch.remainder),
                ("Atan2", torch.atan2), ("Mod", torch.remainder)]:
    TF_OP_REGISTRY[_nm] = _binary(_f)

for _nm, _f in [("LogicalNot", torch.logical_not), ("Floor", torch.floor),
                ("Ceil", torch.ceil), ("Round", torch.round),
                ("Rint", torch.round), ("Sign", torch.sign),
                ("Reciprocal", torch.reciprocal), ("IsNan", torch.isnan),
                ("IsInf", torch.isinf), ("IsFinite", torch.isfinite),
                ("ZerosLike", torch.zeros_like), ("OnesLike", torch.ones_like),
                ("Snapshot", lambda x: x)]:
    TF_OP_REGISTRY[_nm] = _unary(_f)

for _nm, _f in [("Log1p", torch.log1p), ("Expm1", torch.expm1),
                ("Sin", torch.sin), ("Cos", torch.cos), ("Tan", torch.tan),
                ("Asin", torch.asin), ("Acos", torch.acos),
                ("Atan", torch.atan), ("Sinh", torch.sinh),
                ("Cosh", torch.cosh), ("Asinh", torch.asinh),
                ("Acosh", torch.acosh), ("Atanh", torch.atanh),
                ("Elu", F.elu), ("Selu", F.selu), ("Swish", F.silu),
                ("SiLU", F.silu), ("Softsign", F.softsign)]:
    TF_OP_REGISTRY[_nm] = _float_unary(_f)


@tf_op("Select", "SelectV2")
def _select(node, xs):
    a, b = promote(xs[1], xs[2])
    return torch.where(_t(xs[0]).bool(), a, b)


def _shape_of(x) -> tuple:
    return tuple(int(d) for d in (x.shape if hasattr(x, "shape")
                                  else np.shape(x)))


@tf_op("Shape")
def _shape_tf(node, xs):
    # a host array: downstream Reshape/Fill/StridedSlice stay static
    return np.asarray(_shape_of(xs[0]), np.int64)


@tf_op("ShapeN")
def _shape_n(node, xs):
    return tuple(np.asarray(_shape_of(x), np.int64) for x in xs)


@tf_op("Size")
def _size_tf(node, xs):
    return np.asarray(int(np.prod(_shape_of(xs[0]))), np.int64)


@tf_op("Rank")
def _rank_tf(node, xs):
    return np.asarray(len(_shape_of(xs[0])), np.int32)


@tf_op("Fill")
def _fill(node, xs):
    v = _t(xs[1]).reshape(())
    return torch.broadcast_to(v, _ints(xs[0])).clone()


@tf_op("Range")
def _range_tf(node, xs):
    start, limit, delta = (_np(v).item() for v in xs[:3])
    return np.arange(start, limit, delta)


@tf_op("Pack")
def _pack(node, xs):
    a = node.attr("axis")
    return torch.stack([_t(x) for x in xs],
                       dim=a.i if a is not None and a.i is not None else 0)


@tf_op("Unpack")
def _unpack(node, xs):
    a = node.attr("axis")
    axis = a.i if a is not None and a.i is not None else 0
    return tuple(torch.unbind(_t(xs[0]), dim=axis))


@tf_op("Split")
def _split_tf(node, xs):
    axis = _int(xs[0])
    n = node.attr("num_split").i
    x = _t(xs[1])
    return tuple(torch.split(x, x.shape[axis] // n, dim=axis))


@tf_op("SplitV")
def _split_v(node, xs):
    sizes = _ints(xs[1])
    axis = _int(xs[2])
    idx = np.cumsum(sizes)[:-1].tolist()
    return tuple(torch.tensor_split(_t(xs[0]), idx, dim=axis))


def _tf_resize_coords(node, out_size, in_size, device):
    """TF coordinate mapping: default is the ASYMMETRIC map src = dst*scale
    (neither half-pixel nor align-corners)."""
    ac = node.attr("align_corners")
    hp = node.attr("half_pixel_centers")
    out = torch.arange(out_size, dtype=torch.float32, device=device)
    if hp is not None and hp.b:
        return (out + 0.5) * (in_size / out_size) - 0.5
    if ac is not None and ac.b and out_size > 1:
        return out * ((in_size - 1) / (out_size - 1))
    return out * (in_size / out_size)


@tf_op("ResizeBilinear")
def _resize_bilinear_tf(node, xs):
    h, w = _ints(xs[1])
    x = _t(xs[0])

    def lerp_axis(x, coords, axis):
        n = x.shape[axis]
        lo = torch.clamp(torch.floor(coords), 0, n - 1).long()
        hi = torch.clamp(lo + 1, 0, n - 1)
        t = torch.clamp(coords - lo, 0.0, 1.0)
        shape = [1] * x.dim()
        shape[axis] = -1
        a = x.index_select(axis, lo)
        b = x.index_select(axis, hi)
        return a + (b - a) * t.reshape(shape)

    x = lerp_axis(x, _tf_resize_coords(node, h, x.shape[1], x.device), 1)
    return lerp_axis(x, _tf_resize_coords(node, w, x.shape[2], x.device), 2)


@tf_op("ResizeNearestNeighbor")
def _resize_nearest_tf(node, xs):
    h, w = _ints(xs[1])
    x = _t(xs[0])
    ac = node.attr("align_corners")
    hp = node.attr("half_pixel_centers")

    def pick(out_size, in_size):
        c = _tf_resize_coords(node, out_size, in_size, x.device)
        if hp is not None and hp.b:
            idx = torch.floor(c + 0.5)  # TF half-pixel nearest: floor(x+0.5)
        elif ac is not None and ac.b:
            idx = torch.round(c)
        else:
            idx = torch.floor(c)
        return torch.clamp(idx, 0, in_size - 1).long()

    x = x.index_select(1, pick(h, x.shape[1]))
    return x.index_select(2, pick(w, x.shape[2]))


@tf_op("MirrorPad")
def _mirror_pad(node, xs):
    mode = node.attr("mode")
    m = (mode.s if mode is not None and mode.s else "REFLECT").lower()
    pads = [tuple(int(v) for v in p) for p in _np(xs[1])]
    return pad_index(_t(xs[0]), pads,
                     "reflect" if m == "reflect" else "symmetric")


@tf_op("SpaceToDepth")
def _space_to_depth_tf(node, xs):
    bs = node.attr("block_size").i
    x = _t(xs[0])
    B, H, W, C = x.shape
    x = x.reshape(B, H // bs, bs, W // bs, bs, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // bs, W // bs,
                                               bs * bs * C)


@tf_op("DepthToSpace")
def _depth_to_space_tf(node, xs):
    bs = node.attr("block_size").i
    x = _t(xs[0])
    B, H, W, C = x.shape
    x = x.reshape(B, H, W, bs, bs, C // (bs * bs))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H * bs, W * bs,
                                               C // (bs * bs))


@tf_op("ArgMax")
def _argmax_tf(node, xs):
    axis = _int(xs[1]) if len(xs) > 1 else 0
    return torch.argmax(_t(xs[0]), dim=axis)


@tf_op("ArgMin")
def _argmin_tf(node, xs):
    axis = _int(xs[1]) if len(xs) > 1 else 0
    return torch.argmin(_t(xs[0]), dim=axis)


@tf_op("Cumsum")
def _cumsum_tf(node, xs):
    x = _t(xs[0])
    axis = _int(xs[1]) % x.dim()
    rev = node.attr("reverse")
    ex = node.attr("exclusive")
    if rev is not None and rev.b:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if ex is not None and ex.b:
        n = out.shape[axis]
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, n - 1)], dim=axis)
    if rev is not None and rev.b:
        out = torch.flip(out, (axis,))
    return out


@tf_op("TopKV2")
def _topk_tf(node, xs):
    k = _int(xs[1])
    v, i = torch.topk(_t(xs[0]), k, dim=-1)
    return v, i.int()


@tf_op("Einsum")
def _einsum_tf(node, xs):
    eq = node.attr("equation").s
    return torch.einsum(eq, *promote(*xs))


@tf_op("Prod")
def _prod_tf(node, xs):
    # axis=() is the TF identity-reduce, NOT reduce-all
    return reduce_axes(_prod, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("Min")
def _min_tf(node, xs):
    return reduce_axes(_amin, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("All")
def _all_tf(node, xs):
    return reduce_axes(_all, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("Any")
def _any_tf(node, xs):
    return reduce_axes(_any, xs[0], tuple(_ints(xs[1])), _keep_dims(node))


@tf_op("L2Loss")
def _l2_loss_tf(node, xs):
    x = _t(xs[0])
    return 0.5 * torch.sum(x * x)


@tf_op("LRN")
def _lrn_tf(node, xs):
    """TF's LRN: x / (bias + alpha * sum of x^2 over [c - r, c + r])^beta,
    through the registry's ``lrn`` op (window depth 2r + 1, k = bias; TF's
    alpha multiplies the window sum directly, as the op's does), so the
    card takes the LRN kernels."""
    from deeplearning4j_tpu_torch.ops.registry import op as _rop

    dr = node.attr("depth_radius")
    bias = node.attr("bias")
    alpha = node.attr("alpha")
    beta = node.attr("beta")
    depth = (dr.i if dr is not None else 5) * 2 + 1
    return _rop("lrn")(_t(xs[0]), depth=depth,
                       k=bias.f if bias is not None else 1.0,
                       alpha=alpha.f if alpha is not None else 1.0,
                       beta=beta.f if beta is not None else 0.5)


@tf_op("BatchToSpaceND")
def _batch_to_space(node, xs):
    x, block, crops = _t(xs[0]), _np(xs[1]).ravel(), _np(xs[2])
    B = x.shape[0]
    nb = int(np.prod(block))
    spatial = tuple(x.shape[1:1 + len(block)])
    rest = tuple(x.shape[1 + len(block):])
    x = x.reshape(tuple(int(b) for b in block) + (B // nb,) + spatial + rest)
    nd = len(block)
    perm = [nd]
    for i in range(nd):
        perm.extend([nd + 1 + i, i])
    perm.extend(range(1 + 2 * nd, x.dim()))
    x = x.permute(perm)
    newsp = tuple(spatial[i] * int(block[i]) for i in range(nd))
    x = x.reshape((B // nb,) + newsp + rest)
    sl = [slice(None)]
    for i in range(nd):
        c0, c1 = int(crops[i][0]), int(crops[i][1])
        sl.append(slice(c0, newsp[i] - c1))
    return x[tuple(sl)]


@tf_op("SpaceToBatchND")
def _space_to_batch(node, xs):
    x, block, pads = _t(xs[0]), _np(xs[1]).ravel(), _np(xs[2])
    nd = len(block)
    pad_spec = [(0, 0)] + [tuple(int(v) for v in p) for p in pads] \
        + [(0, 0)] * (x.dim() - 1 - nd)
    x = pad_pairs(x, pad_spec)
    B = x.shape[0]
    spatial = tuple(x.shape[1:1 + nd])
    rest = tuple(x.shape[1 + nd:])
    shape = (B,)
    for i in range(nd):
        shape += (spatial[i] // int(block[i]), int(block[i]))
    shape += rest
    x = x.reshape(shape)
    perm = []
    for i in range(nd):
        perm.append(2 + 2 * i)
    perm.append(0)
    for i in range(nd):
        perm.append(1 + 2 * i)
    perm.extend(range(1 + 2 * nd, x.dim()))
    x = x.permute(perm)
    return x.reshape((B * int(np.prod(block)),)
                     + tuple(spatial[i] // int(block[i]) for i in range(nd))
                     + rest)


# ------------------------------------------------------------- the importer


# deadness sentinel for TF1 control flow: Switch kills one branch, Merge
# revives the surviving one; every other op propagates deadness (the same
# semantics the TF executor implements with "dead" tensors)
DEAD = object()

# output-arg name -> tuple position, for function-body refs "node:arg:idx".
# Ops with ONE (possibly list-typed) output arg resolve by idx alone.
_MULTI_OUT_ARGS = {
    "Switch": ["output_false", "output_true"],
    "Merge": ["output", "value_index"],
    "TopKV2": ["values", "indices"],
    "FusedBatchNorm": ["y", "batch_mean", "batch_variance",
                       "reserve_space_1", "reserve_space_2"],
    "FusedBatchNormV3": ["y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2",
                         "reserve_space_3"],
}

_CONTROL_OPS = ("Switch", "Merge", "If", "StatelessIf", "While",
                "StatelessWhile", "PartitionedCall",
                "StatefulPartitionedCall")

def _predicate(node, pred) -> bool:
    """A control-flow predicate read on the host. Under a torch.func
    transform it has no concrete value: raise, naming the node."""
    func = getattr(torch._C, "_functorch", None)
    if isinstance(pred, torch.Tensor) and func is not None \
            and func.is_functorch_wrapped_tensor(pred):
        raise NotImplementedError(
            f"{node.op} node {node.name!r}: the predicate is a value under a "
            "torch.func transform; control flow runs eagerly and reads a "
            "concrete predicate on the host")
    return bool(_np(pred).reshape(()))


class TFImportedGraph:
    """Executable imported graph: call .output(feeds) or use .as_function()."""

    def __init__(self, nodes: List[NodeDef],
                 functions: Optional[Dict[str, "TFFunction"]] = None,
                 device="cpu"):
        self.nodes = {n.name: n for n in nodes}
        self.order = [n.name for n in nodes]  # GraphDefs are topo-sorted
        # the default output is the LAST PARSED node — pinned here so
        # graph rewrites (which may remove or reorder trailing nodes,
        # leaving aliases/folded values behind) can't change it
        self.default_output = self.order[-1] if self.order else None
        self.functions = functions or {}
        self.constants: Dict[str, np.ndarray] = {}
        self.placeholders: List[str] = []
        # SavedModel support: checkpoint-restored values keyed by the
        # VarHandleOp/VariableV2 node name (seeded into acts like
        # constants), and the chosen SignatureDef {inputs, outputs}
        self.variables: Dict[str, np.ndarray] = {}
        self.signature: Optional[Dict[str, Dict[str, str]]] = None
        # import-graph optimizer state: import-time folded constants (never
        # trainable), removed-value aliases, and per-rule rewrite counts
        self.folded: Dict[str, np.ndarray] = {}
        self.aliases: Dict[str, str] = {}
        self.removed: set = set()
        self.import_opt_stats: Optional[Dict[str, int]] = None
        self.device = torch.device(device)
        self._device_cache: Dict[int, tuple] = {}
        for n in nodes:
            if n.op == "Const":
                self.constants[n.name] = n.attr("value").tensor
            elif n.op == "Placeholder":
                self.placeholders.append(n.name)

    def to_device(self):
        """Put every constant, folded value and variable on the graph's
        device (once; entry points call it at import)."""
        self._device_cache = place(
            list(self.constants.values()) + list(self.folded.values())
            + list(self.variables.values()), self.device)
        return self

    @staticmethod
    def _ref(name: str) -> str:
        name = name.split(":")[0]
        return name[1:] if name.startswith("^") else name

    def _resolve(self, acts, ref, op_of: Dict[str, str]):
        """Resolve an input ref — "name", "name:N" (graph style) or
        "name:out_arg:N" (function-body style) — against produced values."""
        parts = ref.split(":")
        name = parts[0]
        if name not in acts:
            alias = self.aliases.get(name)
            if alias is not None:
                v = self._resolve(acts, alias, op_of)
                if len(parts) > 1 and isinstance(v, tuple):
                    v = v[int(parts[-1])]
                return v
            if name in self.removed:
                raise KeyError(
                    f"{name!r} was removed by the import-graph optimizer; "
                    f"re-import with DL4J_TORCH_IMPORT_OPT=0 (or "
                    f"optimize=False) to probe it")
        v = acts[name]
        if not isinstance(v, tuple):
            return v
        if len(parts) == 1:
            return v[0]
        if len(parts) == 2:
            return v[int(parts[1])]
        arg, idx = parts[1], int(parts[2])
        args = _MULTI_OUT_ARGS.get(op_of.get(name, ""), None)
        if args and arg in args:
            return v[args.index(arg) + idx]
        return v[idx]  # single (list-typed) output arg: idx indexes the list

    def _call_function(self, fname: str, args: list):
        fn = self.functions.get(fname)
        if fn is None:
            raise NotImplementedError(
                f"graph references function '{fname}' but the GraphDef "
                f"library does not define it")
        env = dict(zip(fn.in_args, args))
        self._exec_nodes(fn.nodes, env)
        outs = [self._resolve(env, fn.ret.get(o, o),
                              {n.name: n.op for n in fn.nodes})
                for o in fn.out_args]
        return outs

    def _exec_nodes(self, nodes, acts):
        """The topological node loop (shared by the main graph and function
        bodies). Mutates ``acts``."""
        op_of = {n.name: n.op for n in nodes}
        op_of.update({k: n.op for k, n in self.nodes.items()})
        for node in nodes:
            name = node.name
            if node.op == "Const":
                acts[name] = node.attr("value").tensor
                continue
            if node.op in ("Placeholder", "Arg", "_Arg"):
                continue  # fed externally
            if node.op in ("VarHandleOp", "VariableV2", "Variable"):
                if name not in acts:
                    raise NotImplementedError(
                        f"variable node '{name}' has no checkpoint value — "
                        "was this graph imported without its SavedModel "
                        "variables bundle (or with TF2 object-graph keys)?")
                continue  # value seeded from the variables bundle
            if node.op in ("_Retval", "NoOp"):
                if node.op == "_Retval" and node.inputs:
                    acts[name] = self._resolve(acts, node.inputs[0], op_of)
                continue
            ins = [i for i in node.inputs if not i.startswith("^")]
            xs = [self._resolve(acts, i, op_of) for i in ins]
            # deadness propagation (Merge alone consumes dead inputs)
            if node.op != "Merge" and any(x is DEAD for x in xs):
                acts[name] = DEAD
                continue
            if node.op in _CONTROL_OPS:
                acts[name] = self._exec_control(node, xs)
                continue
            fn = TF_OP_REGISTRY.get(node.op)
            if fn is None:
                raise NotImplementedError(
                    f"TF op '{node.op}' (node {name}) has no mapper; "
                    f"register one with @tf_op('{node.op}')")
            acts[name] = apply_mapper(fn, node, xs)

    def _exec_control(self, node, xs):
        """Control flow, eagerly: Switch, If and While read their predicate
        on the host; While loops in Python."""
        op = node.op
        if op == "Switch":
            data, pred = xs
            return (DEAD, data) if _predicate(node, pred) else (data, DEAD)
        if op == "Merge":
            idx = next((i for i, x in enumerate(xs) if x is not DEAD), None)
            if idx is None:  # fully-dead Merge outputs dead (TF semantics)
                return (DEAD, DEAD)
            return (xs[idx], np.asarray(idx, np.int32))
        if op in ("If", "StatelessIf"):
            pred, args = xs[0], xs[1:]
            branch = node.attr("then_branch" if _predicate(node, pred)
                               else "else_branch").func_name
            return tuple(self._call_function(branch, args))
        if op in ("While", "StatelessWhile"):
            cond_f = node.attr("cond").func_name
            body_f = node.attr("body").func_name
            carry = list(xs)
            while _predicate(node, self._call_function(cond_f, carry)[0]):
                carry = self._call_function(body_f, carry)
            return tuple(carry)
        # PartitionedCall / StatefulPartitionedCall
        f = node.attr("f").func_name
        return tuple(self._call_function(f, xs))

    def _execute(self, acts: Dict[str, object],
                 outputs: Optional[List[str]] = None, cache=None):
        """Shared execution tail: run non-Const nodes over ``acts`` (with
        the device copies ``cache``, default the graph's constants') and
        resolve the requested outputs."""
        with running(self.device,
                     self._device_cache if cache is None else cache):
            self._exec_nodes([self.nodes[n] for n in self.order
                              if self.nodes[n].op != "Const"], acts)
        op_of = {k: n.op for k, n in self.nodes.items()}
        res = [output_value(self._resolve(acts, o, op_of), self.device)
               for o in (outputs or [self.default_output or self.order[-1]])]
        return res[0] if len(res) == 1 else res

    def _base_acts(self) -> Dict[str, object]:
        acts: Dict[str, object] = dict(self.constants)
        acts.update(self.folded)
        acts.update(self.variables)
        return acts

    def output(self, feeds: Dict[str, object],
               outputs: Optional[List[str]] = None):
        """Execute the graph (InferenceSession.output analog). Feeds go to
        the graph's device; outputs are torch tensors there."""
        acts = self._base_acts()
        for name, val in feeds.items():
            acts[name] = feed(val, self.device)
        return self._execute(acts, outputs)

    def run_signature(self, feeds: Dict[str, object],
                      signature_outputs: Optional[List[str]] = None):
        """Execute via SignatureDef names (SavedModel serving contract):
        ``feeds`` keyed by signature INPUT names; returns a dict keyed by
        signature OUTPUT names."""
        if not self.signature:
            raise ValueError("graph has no SignatureDef (not a SavedModel?)")
        # inputs: strip ':0' to the placeholder NODE name; outputs: keep the
        # full 'name:N' ref — _resolve understands it, and stripping would
        # silently return output 0 of a multi-output node
        node_feeds = {self.signature["inputs"][k].split(":")[0]: v
                      for k, v in feeds.items()}
        keys = signature_outputs or sorted(self.signature["outputs"])
        vals = self.output(node_feeds,
                           [self.signature["outputs"][k] for k in keys])
        if len(keys) == 1:
            vals = [vals]
        return dict(zip(keys, vals))

    def as_function(self, outputs: Optional[List[str]] = None) -> Callable:
        """Closure over the constants: fn(**feeds) -> outputs."""

        def fn(**feeds):
            return self.output(feeds, outputs)

        return fn

    def as_trainable(self, outputs: Optional[List[str]] = None,
                     trainable: Optional[List[str]] = None,
                     compute_dtype=None):
        """(fn, params) for FINE-TUNING the imported frozen graph.

        Weight Consts become function ARGUMENTS: ``fn(params, feeds) ->
        outputs`` is differentiable (autograd, torch.func) with respect to
        ``params``, fresh tensors on the graph's device. Default trainable
        set: every float Const with rank >= 1 (weights/biases) and every
        SavedModel variable; scalars (eps, scales) and integer consts
        (shapes, axes — static-argument reads) stay frozen host values.

        ``compute_dtype`` (the port's own; the ONNX frontend's semantics):
        frozen float constants are cast to it once, and while ``fn`` runs
        every Cast to a 32/64-bit float and every OneHot gives it, so that
        params cast to it compute in it end to end. None keeps the
        exported types.
        """
        pool = dict(self.constants)
        pool.update(self.variables)       # SavedModel weights fine-tune too
        names = trainable if trainable is not None else [
            k for k, v in pool.items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)
            and np.ndim(v) >= 1]
        params = {k: to_torch(pool[k], self.device) for k in names}
        base = self._base_acts()
        cache = self._device_cache
        if compute_dtype is not None:
            base, cache = cast_frozen(base, set(params), compute_dtype,
                                      self.device, cache)

        def fn(params, feeds):
            acts = dict(base)
            acts.update(params)
            for name, val in feeds.items():
                acts[name] = feed(val, self.device)
            token = CAST_FLOAT_OVERRIDE.set(compute_dtype)
            try:
                return self._execute(acts, outputs, cache)
            finally:
                CAST_FLOAT_OVERRIDE.reset(token)

        return fn, params

    def to_samediff(self):
        """Build a SameDiff graph from the imported GraphDef.

        Reference analog: TFGraphMapper.importGraph returns a SameDiff — the
        imported model is a *graph object* (inspectable, trainable,
        serializable), not just a closure. Shape/axis argument nodes are
        baked from Consts into op attrs (the reference does the same when
        mapping TF's tensor-args onto libnd4j iArgs). The JAX package's
        mapping op for op (36 TF op types), on the import's device.
        """
        from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

        sd = SameDiff.create(device=self.device)
        handles = {}  # tf node name -> SDVariable

        def const_val(name):
            ref = self._ref(name)
            if ref in self.constants:
                return np.asarray(self.constants[ref])
            if ref in self.folded:
                return np.asarray(self.folded[ref])
            raise NotImplementedError(
                f"to_samediff: node input '{ref}' must be a Const")

        for name in self.order:
            node = self.nodes[name]
            ins = [i for i in node.inputs if not i.startswith("^")]

            def x(i):
                ref = self._ref(ins[i])
                if ref not in handles and ref in self.folded:
                    # import-time folded value: materialize as a constant
                    handles[ref] = sd.constant(self.folded[ref], name=ref)
                return handles[ref]

            if node.op == "Const":
                handles[name] = sd.constant(self.constants[name], name=name)
            elif node.op == "Placeholder":
                handles[name] = sd.placeholder(name)
            elif node.op in ("Add", "AddV2", "BiasAdd"):
                handles[name] = sd.add(x(0), x(1), name=name)
            elif node.op == "Sub":
                handles[name] = sd.sub(x(0), x(1), name=name)
            elif node.op == "Mul":
                handles[name] = sd.mul(x(0), x(1), name=name)
            elif node.op in ("RealDiv", "Div"):
                handles[name] = sd.div(x(0), x(1), name=name)
            elif node.op == "MatMul":
                a, b = x(0), x(1)
                ta, tb = node.attr("transpose_a"), node.attr("transpose_b")
                if ta and ta.b:
                    a = sd.transpose_(a, [1, 0])
                if tb and tb.b:
                    b = sd.transpose_(b, [1, 0])
                handles[name] = sd.mmul(a, b, name=name)
            elif node.op == "Relu":
                handles[name] = sd.relu(x(0), name=name)
            elif node.op == "Relu6":
                handles[name] = sd._op("relu6", x(0), name=name)
            elif node.op == "Sigmoid":
                handles[name] = sd.sigmoid(x(0), name=name)
            elif node.op == "Tanh":
                handles[name] = sd.tanh(x(0), name=name)
            elif node.op == "Softmax":
                handles[name] = sd.softmax(x(0), name=name)
            elif node.op == "FakeQuantWithMinMaxArgs":
                nb, nr = _fq_attrs(node)
                mn = node.attr("min")
                mx = node.attr("max")
                handles[name] = sd._op(
                    "fake_quant_with_min_max_args", x(0),
                    attrs={"min": mn.f if mn and mn.f is not None else -6.0,
                           "max": mx.f if mx and mx.f is not None else 6.0,
                           "num_bits": nb, "narrow_range": nr}, name=name)
            elif node.op in ("FakeQuantWithMinMaxVars",
                             "FakeQuantWithMinMaxVarsPerChannel"):
                nb, nr = _fq_attrs(node)
                opname = ("fake_quant_with_min_max_vars_per_channel"
                          if node.op.endswith("PerChannel")
                          else "fake_quant_with_min_max_vars")
                handles[name] = sd._op(
                    opname, x(0), x(1), x(2),
                    attrs={"num_bits": nb, "narrow_range": nr}, name=name)
            elif node.op in ("Identity", "StopGradient", "PreventGradient"):
                handles[name] = sd.identity(x(0), name=name)
            elif node.op == "NoOp":
                continue                    # control-dependency anchor only
            elif node.op == "Reshape":
                shape = [int(d) for d in const_val(ins[1]).ravel()]
                handles[name] = sd.reshape(x(0), shape, name=name)
            elif node.op == "Squeeze":
                dims = node.attr("squeeze_dims") or node.attr("axis")
                axis = list(dims.list_i) if dims and dims.list_i else None
                handles[name] = sd.squeeze(x(0), axis=axis, name=name)
            elif node.op == "ExpandDims":
                handles[name] = sd.expand_dims(
                    x(0), int(const_val(ins[1]).ravel()[0]), name=name)
            elif node.op in ("Mean", "Max"):
                axes = [int(a) for a in const_val(ins[1]).ravel()]
                keep = node.attr("keep_dims")
                kd = bool(keep.b) if keep else False
                fn = sd.mean if node.op == "Mean" else sd.max
                handles[name] = fn(x(0), axis=axes, keepdims=kd, name=name)
            elif node.op == "ConcatV2":
                axis = int(const_val(ins[-1]).ravel()[0])
                handles[name] = sd.concat([x(i) for i in range(len(ins) - 1)],
                                          axis=axis, name=name)
            elif node.op == "Conv2D":
                strides = node.attr("strides").list_i or [1, 1, 1, 1]
                pad = _pad_mode(node).lower()
                handles[name] = sd.conv2d(x(0), x(1),
                                          strides=tuple(strides[1:3]),
                                          padding=pad, name=name)
            elif node.op in ("MaxPool", "AvgPool"):
                k = node.attr("ksize").list_i
                s = node.attr("strides").list_i
                pad = _pad_mode(node).lower()
                fn = sd.max_pool2d if node.op == "MaxPool" else sd.avg_pool2d
                handles[name] = fn(x(0), kernel=tuple(k[1:3]),
                                   strides=tuple(s[1:3]), padding=pad, name=name)
            elif node.op in ("FusedBatchNorm", "FusedBatchNormV3"):
                eps = node.attr("epsilon")
                eps = eps.f if eps and eps.f is not None else 1e-4  # TF op default
                # TF input order (x, scale, offset, mean, var) -> ours
                handles[name] = sd.batch_norm(x(0), x(3), x(4), x(1), x(2),
                                              eps=float(eps), name=name)
            elif node.op == "Pad":
                pads = const_val(ins[1]).reshape(-1, 2)
                handles[name] = sd.pad(x(0), [(int(a), int(b)) for a, b in pads],
                                       name=name)
            elif node.op == "Rsqrt":
                # decomposed batchnorm graphs (keras export without fused
                # BN) carry 1/sqrt(var+eps) as an explicit Rsqrt node
                handles[name] = sd.rsqrt(x(0), name=name)
            elif node.op == "DepthwiseConv2dNative":
                strides = node.attr("strides").list_i or [1, 1, 1, 1]
                handles[name] = sd.depthwise_conv2d(
                    x(0), x(1), strides=tuple(strides[1:3]),
                    padding=_pad_mode(node).lower(), name=name)
            else:
                raise NotImplementedError(
                    f"to_samediff: no SameDiff mapping for TF op '{node.op}' "
                    f"(node {name})")
        return sd



def _parse_signatures(meta_graph: Dict[int, list]) -> Dict[str, dict]:
    """MetaGraphDef.signature_def (field 5): map<string, SignatureDef>;
    SignatureDef: inputs(1)/outputs(2) are map<string, TensorInfo>,
    TensorInfo.name(1) is the "node:out" ref."""
    sigs: Dict[str, dict] = {}
    for ent in meta_graph.get(5, []):
        e = parse_message(ent)
        sd = parse_message(e[2][0])

        def tensors(field):
            out = {}
            for m in sd.get(field, []):
                me = parse_message(m)
                ti = parse_message(me[2][0])
                if 1 in ti:
                    out[me[1][0].decode()] = ti[1][0].decode()
            return out

        sigs[e[1][0].decode()] = {"inputs": tensors(1),
                                  "outputs": tensors(2)}
    return sigs


def _tf2_variable_keys(meta_graph: Dict[int, list],
                       object_graph_raw: Optional[bytes]) -> Dict[str, str]:
    """{SavedVariable.name: checkpoint_key} for TF2 SavedModels.

    The SavedObjectGraph (MetaGraphDef.object_graph_def, field 7) and the
    checkpoint's _CHECKPOINTABLE_OBJECT_GRAPH (a TrackableObjectGraph proto
    stored as a DT_STRING tensor) index their nodes IDENTICALLY: node i
    holding SavedVariable(name=6) corresponds to TrackableObject i whose
    attributes (field 2) carry {name(1)="VARIABLE_VALUE",
    checkpoint_key(3)}."""
    if 7 not in meta_graph or not object_graph_raw:
        return {}
    from deeplearning4j_tpu_torch.modelimport.tf_bundle import \
        string_tensor_elements

    try:
        proto = string_tensor_elements(object_graph_raw, 1)[0]
        track_nodes = parse_message(proto).get(1, [])
        saved_nodes = parse_message(meta_graph[7][0]).get(1, [])
        out: Dict[str, str] = {}
        for i, so_buf in enumerate(saved_nodes):
            so = parse_message(so_buf)
            if 7 not in so or i >= len(track_nodes):   # not a variable
                continue
            name_f = parse_message(so[7][0]).get(6)
            if not name_f:
                continue
            name = name_f[0].decode()
            for attr in parse_message(track_nodes[i]).get(2, []):
                a = parse_message(attr)
                if a.get(1, [b""])[0] == b"VARIABLE_VALUE" and 3 in a:
                    out.setdefault(name, a[3][0].decode())
        return out
    except Exception:
        return {}        # malformed object graph: fall back to name match


def _prune_to(nodes: List[NodeDef], roots: List[str]) -> List[NodeDef]:
    """Subgraph reachable from ``roots`` (drops the saver/initializer
    machinery a SavedModel graph carries alongside inference), preserving
    the original (topological) order."""
    by_name = {n.name: n for n in nodes}
    keep = set()
    stack = [r.split(":")[0].lstrip("^") for r in roots]
    while stack:
        name = stack.pop()
        if name in keep or name not in by_name:
            continue
        keep.add(name)
        stack.extend(i.split(":")[0].lstrip("^")
                     for i in by_name[name].inputs)
    return [n for n in nodes if n.name in keep]


class TFGraphMapper:
    """importGraph entry point (TFGraphMapper.importGraph analog)."""

    @staticmethod
    def import_graph(path_or_bytes, optimize: Optional[bool] = None,
                     device="cuda") -> TFImportedGraph:
        """Import a frozen GraphDef (a path or its bytes) onto ``device``
        (the card unless the caller asks for "cpu")."""
        dev = resolve_device(device)
        if isinstance(path_or_bytes, (bytes, bytearray)):
            buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
        nodes, functions = parse_graph(buf)
        g = TFImportedGraph(nodes, functions, device=dev)
        from deeplearning4j_tpu_torch.modelimport import optimizer as graph_opt

        if optimize if optimize is not None else graph_opt.import_opt_enabled():
            # no DCE roots: a bare frozen GraphDef's outputs are chosen by
            # the caller, so every node stays probe-able
            graph_opt.optimize_tf(g)
        return g.to_device()

    @staticmethod
    def import_saved_model(path, signature: str = "serving_default",
                           optimize: Optional[bool] = None,
                           device="cuda") -> TFImportedGraph:
        """Import a SavedModel DIRECTORY (saved_model.pb + variables/).

        saved_model.pb wraps MetaGraphDef(s) (field 2) -> GraphDef (field
        2) + function library; weights come from the tensor-bundle
        checkpoint under variables/ and are seeded onto the graph's
        VarHandleOp/VariableV2 nodes. TF1-convention checkpoints resolve
        by node name (shared_name attr as fallback); TF2 object-graph
        checkpoints are resolved through the SavedObjectGraph + the
        checkpoint's _CHECKPOINTABLE_OBJECT_GRAPH proto. The graph is
        pruned to what the chosen signature's outputs reach."""
        from pathlib import Path as _Path

        from deeplearning4j_tpu_torch.modelimport.tf_bundle import \
            read_variables

        dev = resolve_device(device)
        d = _Path(path)
        sm = parse_message((d / "saved_model.pb").read_bytes())
        if 2 not in sm:
            raise ValueError(f"{path}: no MetaGraphDef in saved_model.pb")
        mg = parse_message(sm[2][0])
        nodes, functions = parse_graph(mg[2][0])
        sigs = _parse_signatures(mg)
        if sigs and signature not in sigs:
            # never substitute silently: the graph is pruned to the chosen
            # signature's outputs, so a wrong pick corrupts the import
            raise KeyError(
                f"SavedModel has no signature {signature!r}; available: "
                f"{sorted(sigs)}")
        sig = sigs.get(signature)
        if sig and sig["outputs"]:
            nodes = _prune_to(nodes, list(sig["outputs"].values()))
        g = TFImportedGraph(nodes, functions, device=dev)
        g.signature = sig

        index = d / "variables" / "variables.index"
        raw_entries: Dict[str, bytes] = {}
        ckpt = read_variables(d / "variables" / "variables",
                              raw=raw_entries) if index.exists() else {}
        name_to_key = _tf2_variable_keys(
            mg, raw_entries.get("_CHECKPOINTABLE_OBJECT_GRAPH"))
        missing = []
        for n in nodes:
            if n.op not in ("VarHandleOp", "VariableV2", "Variable"):
                continue
            shared = n.attr("shared_name")
            cands = [n.name] + ([shared.s] if shared and shared.s else [])
            cands += [name_to_key[c] for c in list(cands)
                      if c in name_to_key]
            val = next((ckpt[c] for c in cands if c in ckpt), None)
            if val is None:
                missing.append(n.name)
            else:
                g.variables[n.name] = val
        if missing:
            og_hint = ""
            if any("/.ATTRIBUTES/" in k for k in ckpt) and not name_to_key:
                og_hint = (" — the checkpoint uses TF2 object-graph keys "
                           "but the SavedObjectGraph could not be resolved "
                           "(unrecognized proto layout?)")
            raise NotImplementedError(
                f"no checkpoint value for variable nodes {missing} "
                f"(checkpoint has {sorted(ckpt)[:8]}...){og_hint}")
        from deeplearning4j_tpu_torch.modelimport import optimizer as graph_opt

        if optimize if optimize is not None else graph_opt.import_opt_enabled():
            roots = (list(sig["outputs"].values())
                     if sig and sig["outputs"] else None)
            graph_opt.optimize_tf(g, roots=roots)
        return g.to_device()
