"""SameDiff: define-then-run autodiff graphs.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``
(org.nd4j.autodiff.samediff.SameDiff / SDVariable): the user builds the
same symbolic graph (placeholders, variables, op calls returning
SDVariable), every op node holds a name from the op table plus JSON-able
attributes, and ``save``/``load`` write and read the same ``.sdz`` zip
(``graph.json`` + ``arrays.npz``), so a graph crosses between the packages
both ways.

The JAX package traces the whole graph into one jitted program and takes
gradients from ``jax.grad``. PyTorch runs eagerly, so the port executes the
graph node by node in topological order and takes gradients from
``torch.autograd`` over that execution. Each target list's order and op
callables are built once and cached, as the JAX package caches its jitted
function; adding a node clears the cache. Three ops of the catalog
(``dot_product_attention``, ``lstm_layer``, ``lrn``) call the op registry,
so a graph on the card runs the hand-written kernels.

A graph lives on one device (``device="cuda"`` by default; asking for the
card where there is none raises). Variables and constants are held there
and placeholders are moved there at each call. As in the JAX package
without x64, a float64 numpy array becomes float32; integer arrays keep
their type.

Control flow runs on the host: ``cond`` reads its predicate (a sync) and
runs one branch, ``while_loop`` is a Python loop over the carries and
``scan`` loops over the leading axis and stacks the per-step outputs;
autograd runs through all three. Their bodies are sub-graphs, serialized
recursively.
"""

from __future__ import annotations

import contextvars
import dataclasses
import io
import json
import zipfile
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.device import resolve_device

# --------------------------------------------------------------------------
# Op table: name -> builder(attrs) -> callable(*inputs). Graph nodes name
# their op, so graphs serialize without code.
# --------------------------------------------------------------------------

_OP_IMPLS: dict[str, Callable[[dict], Callable]] = {}

# the device of the graph being executed: ops without tensor inputs
# (range, eye, the random draws) create their result there
_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "samediff_device", default=torch.device("cpu"))

#: attribute dtype names (numpy's) -> torch dtypes
DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of an attribute's dtype name."""
    return DTYPES[str(name)]


def dtype_name(dtype) -> str:
    """A numpy dtype name for a numpy, torch or string dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def current_device() -> torch.device:
    return _DEVICE.get()


def as_tensor(value, device) -> torch.Tensor:
    """``value`` as a tensor on ``device``: a numpy array or scalar as
    jnp.asarray types it without x64 (float64 -> float32), a tensor as it
    is."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)


def register_sd_op(name: str):
    """Register a SameDiff graph op builder (attrs -> callable).

    Distinct from ``ops.registry.register_op``, which registers runtime
    implementations with kernel selection; this table maps serialized
    graph-node names onto callables."""
    def deco(builder):
        _OP_IMPLS[name] = builder
        return builder
    return deco


def _simple(name: str, fn: Callable):
    _OP_IMPLS[name] = lambda attrs, _f=fn: _f


def dims(axis, ndim):
    """An attribute's axis (None, an int or a list) as a tuple of dims;
    None is every dim."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _floating(a):
    """jnp's reductions give a float for an integer input."""
    return a if a.is_floating_point() else a.to(torch.float32)


def reduce_over(fn, a, axis, keepdims):
    """``fn(t)`` over the last axis of ``a`` with ``axis``'s dims moved last
    and flattened into one, for reductions torch takes one dim at a time
    (prod, median, quantiles)."""
    ds = sorted(d % a.dim() for d in dims(axis, a.dim())) if a.dim() else []
    keep = [d for d in range(a.dim()) if d not in ds]
    t = a.permute(*keep, *ds).reshape(*[a.shape[d] for d in keep], -1)
    out = fn(t)
    if keepdims:
        out = out.reshape([1 if d in ds else a.shape[d]
                           for d in range(a.dim())])
    return out


# elementwise / binary
_simple("add", torch.add)
_simple("sub", torch.sub)
_simple("rsub", lambda a, b: b - a)
_simple("mul", torch.mul)
_simple("div", torch.true_divide)
_simple("rdiv", lambda a, b: b / a)
_simple("pow", torch.pow)
_simple("mod", torch.remainder)          # jnp.mod: the divisor's sign
_simple("floordiv", torch.floor_divide)
_simple("maximum", torch.maximum)
_simple("minimum", torch.minimum)
_simple("neg", torch.neg)
_simple("exp", torch.exp)
_simple("log", torch.log)
_simple("log1p", torch.log1p)
_simple("expm1", torch.expm1)
_simple("sqrt", torch.sqrt)
_simple("rsqrt", lambda a: 1.0 / torch.sqrt(a))
_simple("square", torch.square)
_simple("abs", torch.abs)
_simple("sign", torch.sign)
_simple("floor", torch.floor)
_simple("ceil", torch.ceil)
_simple("round", torch.round)            # half to even, as jnp.round
_simple("reciprocal", torch.reciprocal)
_simple("sin", torch.sin)
_simple("cos", torch.cos)
_simple("tan", torch.tan)
_simple("asin", torch.asin)
_simple("acos", torch.acos)
_simple("atan", torch.atan)
_simple("sinh", torch.sinh)
_simple("cosh", torch.cosh)
_simple("tanh", torch.tanh)
_simple("erf", torch.erf)
_simple("sigmoid", torch.sigmoid)
_simple("relu", torch.relu)
_simple("relu6", F.relu6)
_simple("elu", F.elu)
# jax.nn.gelu's default is the tanh form, not F.gelu's exact erf form
_simple("gelu", lambda a: F.gelu(a, approximate="tanh"))
_simple("softplus", lambda a: torch.logaddexp(a, torch.zeros_like(a)))
_simple("softsign", lambda a: a / (torch.abs(a) + 1))
_simple("silu", F.silu)
_simple("hardswish", F.hardswish)
_simple("mmul", torch.matmul)
_simple("bmm", torch.matmul)
_simple("where", lambda c, a, b: torch.where(c.to(torch.bool), a, b))
# comparisons (emit bool; cast as needed)
_simple("eq", torch.eq)
_simple("neq", torch.ne)
_simple("gt", torch.gt)
_simple("gte", torch.ge)
_simple("lt", torch.lt)
_simple("lte", torch.le)
_simple("logical_and", torch.logical_and)
_simple("logical_or", torch.logical_or)
_simple("logical_not", torch.logical_not)


@register_sd_op("leakyrelu")
def _b_leakyrelu(attrs):
    alpha = attrs.get("alpha", 0.01)
    return lambda a: torch.where(a >= 0, a, alpha * a)


@register_sd_op("softmax")
def _b_softmax(attrs):
    axis = attrs.get("axis", -1)
    return lambda a: torch.softmax(a, dim=axis)


@register_sd_op("log_softmax")
def _b_log_softmax(attrs):
    axis = attrs.get("axis", -1)
    return lambda a: torch.log_softmax(a, dim=axis)


def _prod(a, axis, keepdims):
    return reduce_over(lambda t: t.prod(-1), a, axis, keepdims)


_REDUCERS = {
    "sum": lambda a, ax, kd: torch.sum(a, dim=dims(ax, a.dim()), keepdim=kd),
    "mean": lambda a, ax, kd: torch.mean(_floating(a), dim=dims(ax, a.dim()),
                                         keepdim=kd),
    "max": lambda a, ax, kd: torch.amax(a, dim=dims(ax, a.dim()), keepdim=kd),
    "min": lambda a, ax, kd: torch.amin(a, dim=dims(ax, a.dim()), keepdim=kd),
    "prod": _prod,
    # jnp.std / jnp.var divide by N (ddof 0)
    "std": lambda a, ax, kd: torch.std(_floating(a), dim=dims(ax, a.dim()),
                                       correction=0, keepdim=kd),
    "var": lambda a, ax, kd: torch.var(_floating(a), dim=dims(ax, a.dim()),
                                       correction=0, keepdim=kd),
    "any": lambda a, ax, kd: torch.any(a.to(torch.bool), dim=dims(ax, a.dim()),
                                       keepdim=kd),
    "all": lambda a, ax, kd: torch.all(a.to(torch.bool), dim=dims(ax, a.dim()),
                                       keepdim=kd),
}


def _reduce(name):
    @register_sd_op(name)
    def _b(attrs, _fn=_REDUCERS[name]):
        axis = attrs.get("axis")
        keepdims = attrs.get("keepdims", False)
        return lambda a: _fn(a, axis, keepdims)


for _name in _REDUCERS:
    _reduce(_name)


@register_sd_op("norm1")
def _b_norm1(attrs):
    axis, keepdims = attrs.get("axis"), attrs.get("keepdims", False)
    return lambda a: torch.sum(torch.abs(a), dim=dims(axis, a.dim()),
                               keepdim=keepdims)


@register_sd_op("norm2")
def _b_norm2(attrs):
    axis, keepdims = attrs.get("axis"), attrs.get("keepdims", False)
    return lambda a: torch.sqrt(torch.sum(a * a, dim=dims(axis, a.dim()),
                                          keepdim=keepdims))


@register_sd_op("normmax")
def _b_normmax(attrs):
    axis, keepdims = attrs.get("axis"), attrs.get("keepdims", False)
    return lambda a: torch.amax(torch.abs(a), dim=dims(axis, a.dim()),
                                keepdim=keepdims)


@register_sd_op("argmax")
def _b_argmax(attrs):
    return lambda a: torch.argmax(a, dim=attrs.get("axis", -1))


@register_sd_op("argmin")
def _b_argmin(attrs):
    return lambda a: torch.argmin(a, dim=attrs.get("axis", -1))


@register_sd_op("cumsum")
def _b_cumsum(attrs):
    return lambda a: torch.cumsum(a, dim=attrs.get("axis", -1))


@register_sd_op("cumprod")
def _b_cumprod(attrs):
    return lambda a: torch.cumprod(a, dim=attrs.get("axis", -1))


@register_sd_op("reshape")
def _b_reshape(attrs):
    shape = tuple(attrs["shape"])
    return lambda a: torch.reshape(a, shape)


@register_sd_op("transpose")
def _b_transpose(attrs):
    axes = attrs.get("axes")
    return lambda a: a.permute(*(axes if axes else reversed(range(a.dim()))))


@register_sd_op("squeeze")
def _b_squeeze(attrs):
    axis = attrs.get("axis")
    return lambda a: (torch.squeeze(a) if axis is None
                      else torch.squeeze(a, tuple(axis)))


@register_sd_op("expand_dims")
def _b_expand_dims(attrs):
    return lambda a: torch.unsqueeze(a, attrs["axis"])


@register_sd_op("tile")
def _b_tile(attrs):
    return lambda a: torch.tile(a, tuple(attrs["reps"]))


@register_sd_op("slice")
def _b_slice(attrs):
    begin, size = attrs["begin"], attrs["size"]

    def fn(a):
        # lax.dynamic_slice counts a negative start from the end, then
        # clamps each start so that the slice fits
        for d, (b, s) in enumerate(zip(begin, size)):
            b = int(b) + (a.shape[d] if int(b) < 0 else 0)
            b = min(max(b, 0), a.shape[d] - int(s))
            a = a.narrow(d, b, int(s))
        return a
    return fn


def strided(a, d, start, stop, step):
    """``a[..., start:stop:step, ...]`` on dim ``d``, numpy's semantics,
    negative steps included (torch refuses them: flip, then slice with the
    positive step)."""
    n = a.shape[d]
    idx = range(*slice(start, stop, step).indices(n))
    lead = (slice(None),) * d
    if step > 0:
        return a[lead + (slice(idx.start, idx.start + len(idx) * step, step),)]
    first = n - 1 - idx.start if len(idx) else 0
    return a.flip(d)[lead + (slice(first, first + len(idx) * -step, -step),)]


@register_sd_op("strided_slice")
def _b_strided_slice(attrs):
    spec = list(zip(attrs["begin"], attrs["end"], attrs["strides"]))

    def fn(a):  # end None means "to the end" (JSON null)
        for d, (b, e, s) in enumerate(spec):
            a = strided(a, d, b, e, int(s))
        return a
    return fn


def take(a, idx, axis):
    """jnp.take(a, idx, axis): ``a.shape[:axis] + idx.shape +
    a.shape[axis + 1:]``."""
    axis = axis % a.dim()
    flat = torch.index_select(a, axis, idx.reshape(-1).long())
    return flat.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register_sd_op("gather")
def _b_gather(attrs):
    axis = attrs.get("axis", 0)
    return lambda a, idx: take(a, idx, axis)


def scatter_rows(a, idx, upd):
    """``a.at[idx]``'s operands as index_put / index_reduce take them:
    the flat, non-negative row indices and the updates one row each."""
    idx = idx.long()
    upd = torch.broadcast_to(upd.to(a.dtype), idx.shape + a.shape[1:])
    idx = idx.reshape(-1)
    return (torch.where(idx < 0, idx + a.shape[0], idx),
            upd.reshape((-1,) + a.shape[1:]))


@register_sd_op("scatter_update")
def _b_scatter_update(attrs):
    def fn(a, idx, upd):
        i, u = scatter_rows(a, idx, upd)
        return a.index_put((i,), u)
    return fn


@register_sd_op("scatter_add")
def _b_scatter_add(attrs):
    def fn(a, idx, upd):
        i, u = scatter_rows(a, idx, upd)
        return a.index_put((i,), u, accumulate=True)
    return fn


@register_sd_op("one_hot")
def _b_one_hot(attrs):
    depth = attrs["depth"]
    # jax.nn.one_hot: float32, a comparison (an id out of range is all 0)
    return lambda a: (a.long()[..., None] == torch.arange(
        depth, device=a.device)).to(torch.float32)


@register_sd_op("cast")
def _b_cast(attrs):
    dtype = torch_dtype(attrs["dtype"])
    return lambda a: a.to(dtype)


@register_sd_op("clip_by_value")
def _b_clip(attrs):
    lo, hi = attrs["min"], attrs["max"]
    return lambda a: torch.clamp(a, lo, hi)


@register_sd_op("concat")
def _b_concat(attrs):
    axis = attrs.get("axis", -1)
    return lambda *xs: torch.cat(xs, dim=axis)


@register_sd_op("stack")
def _b_stack(attrs):
    axis = attrs.get("axis", 0)
    return lambda *xs: torch.stack(xs, dim=axis)


@register_sd_op("unstack")
def _b_unstack(attrs):
    axis, index = attrs.get("axis", 0), attrs["index"]
    return lambda a: torch.select(a, axis, index)


@register_sd_op("split")
def _b_split(attrs):
    n, axis, index = attrs["num"], attrs.get("axis", 0), attrs["index"]
    return lambda a: torch.tensor_split(a, n, dim=axis)[index]


@register_sd_op("conv2d")
def _b_conv2d(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import conv2d as _c
    strides = tuple(attrs.get("strides", (1, 1)))
    padding = attrs.get("padding", "same")
    return lambda x, w: _c(x, w, strides=strides, padding=padding)


@register_sd_op("max_pool2d")
def _b_maxpool(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import maxpool2d
    k = tuple(attrs.get("kernel", (2, 2)))
    s = tuple(attrs.get("strides", k))
    pad = attrs.get("padding", "valid")
    return lambda x: maxpool2d(x, kernel=k, strides=s, padding=pad)


@register_sd_op("avg_pool2d")
def _b_avgpool(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import avgpool2d
    k = tuple(attrs.get("kernel", (2, 2)))
    s = tuple(attrs.get("strides", k))
    pad = attrs.get("padding", "valid")
    return lambda x: avgpool2d(x, kernel=k, strides=s, padding=pad)


@register_sd_op("layer_norm")
def _b_layernorm(attrs):
    eps = attrs.get("eps", 1e-5)

    def fn(x, gain, bias):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        return (x - mu) / torch.sqrt(var + eps) * gain + bias
    return fn


@register_sd_op("batch_norm")
def _b_batchnorm(attrs):
    eps = attrs.get("eps", 1e-5)

    def fn(x, mean, var, gamma, beta):
        return (x - mean) / torch.sqrt(var + eps) * gamma + beta
    return fn


@register_sd_op("embedding_lookup")
def _b_embed(attrs):
    return lambda table, ids: take(table, ids, 0)


@register_sd_op("softmax_ce")
def _b_softmax_ce(attrs):
    def ce(y, z):
        return -(y * torch.log_softmax(z, -1)).sum(-1).mean()
    return ce


@register_sd_op("sigmoid_ce")
def _b_sigmoid_ce(attrs):
    def ce(y, z):
        return torch.mean(torch.clamp(z, min=0) - z * y
                          + torch.log1p(torch.exp(-torch.abs(z))))
    return ce


@register_sd_op("mse")
def _b_mse(attrs):
    return lambda y, p: ((y - p) ** 2).mean()


@register_sd_op("l1_loss")
def _b_l1(attrs):
    return lambda y, p: torch.abs(y - p).mean()


@register_sd_op("l2_loss")
def _b_l2(attrs):
    return lambda a: 0.5 * torch.sum(a * a)


@register_sd_op("huber_loss")
def _b_huber(attrs):
    delta = attrs.get("delta", 1.0)

    def fn(y, p):
        err = torch.abs(y - p)
        return torch.mean(torch.where(err <= delta, 0.5 * err * err,
                                      delta * (err - 0.5 * delta)))
    return fn


@register_sd_op("identity")
def _b_identity(attrs):
    return lambda a: a


@register_sd_op("tuple_get")
def _b_tuple_get(attrs):
    i = attrs["index"]
    return lambda t: t[i]


def pad(a, pads, mode="constant"):
    """jnp.pad: constant through F.pad, every other mode by gathering each
    dim through the source index ``np.pad`` gives ``arange(n)``."""
    pads = [tuple(int(v) for v in p) for p in pads]
    if mode == "constant":
        flat = [v for p in reversed(pads) for v in p]
        return F.pad(a, flat)
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            src = np.pad(np.arange(a.shape[d]), (lo, hi), mode=mode)
            a = a.index_select(d, torch.as_tensor(src, device=a.device))
    return a


@register_sd_op("pad")
def _b_pad(attrs):
    pads, mode = attrs["paddings"], attrs.get("mode", "constant")
    return lambda a: pad(a, pads, mode)


@dataclasses.dataclass(frozen=True)
class SDVariable:
    """Symbolic handle into a SameDiff graph (SDVariable)."""

    sd: "SameDiff"
    name: str

    # -- operator sugar; every op routes through sd._op --
    def __add__(self, o):
        return self.sd._op("add", self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self.sd._op("sub", self, o)

    def __rsub__(self, o):
        return self.sd._op("rsub", self, o)

    def __mul__(self, o):
        return self.sd._op("mul", self, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self.sd._op("div", self, o)

    def __rtruediv__(self, o):
        return self.sd._op("rdiv", self, o)

    def __pow__(self, o):
        return self.sd._op("pow", self, o)

    def __neg__(self):
        return self.sd._op("neg", self)

    def __matmul__(self, o):
        return self.sd.mmul(self, o)

    def __getitem__(self, item):
        if not isinstance(item, tuple):
            item = (item,)
        begin, end, strides, int_dims = [], [], [], []
        for d, s in enumerate(item):
            if isinstance(s, slice):
                # keep None for open ends so negative steps (::-1) work
                begin.append(s.start)
                end.append(s.stop)
                strides.append(1 if s.step is None else s.step)
            else:
                # integer index: slice [s, s+1) (end None when s == -1 so
                # the slice isn't empty), then squeeze the dim as numpy does
                begin.append(s)
                end.append(s + 1 if s != -1 else None)
                strides.append(1)
                int_dims.append(d)
        out = self.sd._op("strided_slice", self,
                          attrs={"begin": begin, "end": end, "strides": strides})
        if int_dims:
            out = self.sd.squeeze(out, axis=int_dims)
        return out

    # common shortcuts
    def sum(self, axis=None, keepdims=False):
        return self.sd.sum(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self.sd.mean(self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, keepdims=False):
        return self.sd._op("std", self, attrs={"axis": _axlist(axis),
                                               "keepdims": keepdims})

    def reshape(self, *shape):
        return self.sd._op("reshape", self, attrs={"shape": list(shape)})

    def transpose(self, *axes):
        return self.sd._op("transpose", self,
                           attrs={"axes": list(axes) if axes else None})

    def eval(self, **placeholders):
        return self.sd.output(self.name, **placeholders)

    @property
    def shape(self):
        node = self.sd._nodes[self.name]
        if node.value is not None:
            return tuple(node.value.shape)
        return tuple(node.shape) if node.shape else None


def _axlist(axis):
    if axis is None:
        return None
    if isinstance(axis, (int, np.integer)):
        return [int(axis)]
    return [int(a) for a in axis]


@dataclasses.dataclass
class _Node:
    name: str
    kind: str  # "placeholder" | "variable" | "constant" | "op" | "control"
    op: Optional[str] = None          # op table name (kind == "op")
    attrs: dict = dataclasses.field(default_factory=dict)
    inputs: tuple = ()
    value: Any = None  # for variable/constant: a tensor on the graph's device
    shape: Optional[tuple] = None
    subgraphs: dict = dataclasses.field(default_factory=dict)  # name -> SameDiff


class SameDiff:
    """The graph container (SameDiff.create()), on one device."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self._nodes: dict[str, _Node] = {}
        self._counter = 0
        # var() draws its weight-init schemes from here, on the host, so a
        # seed gives the same weights on every device
        self._generator = torch.Generator().manual_seed(int(seed))
        self.loss_name: Optional[str] = None
        self._fn_cache: dict = {}

    @staticmethod
    def create(seed: int = 0, device="cuda") -> "SameDiff":
        return SameDiff(seed, device=device)

    # ------------------------------------------------------------- builders
    def _fresh(self, base: str) -> str:
        self._counter += 1
        return f"{base}_{self._counter}"

    def _add(self, node: _Node) -> SDVariable:
        self._nodes[node.name] = node
        self._fn_cache.clear()
        return SDVariable(self, node.name)

    def placeholder(self, name: str, shape=None, dtype=torch.float32) -> SDVariable:
        return self._add(_Node(name, "placeholder", shape=shape))

    def var(self, name: str, init, shape=None) -> SDVariable:
        """Trainable variable: init = array, or a weight-init scheme name."""
        if isinstance(init, str):
            from deeplearning4j_tpu_torch.nn.weights import init_weight

            value = init_weight(self._generator, shape, init,
                                device=self.device)
        else:
            value = as_tensor(init, self.device)
        return self._add(_Node(name, "variable", value=value))

    def constant(self, value, name: Optional[str] = None) -> SDVariable:
        name = name or self._fresh("const")
        return self._add(_Node(name, "constant",
                               value=as_tensor(value, self.device)))

    def _op(self, op: str, *args, attrs: Optional[dict] = None,
            name: Optional[str] = None) -> SDVariable:
        if op not in _OP_IMPLS:
            raise KeyError(f"unknown SameDiff op {op!r}")
        inputs = []
        for a in args:
            if isinstance(a, SDVariable):
                inputs.append(a.name)
            else:
                inputs.append(self.constant(a).name)
        name = name or self._fresh(op)
        return self._add(_Node(name, "op", op=op, attrs=dict(attrs or {}),
                               inputs=tuple(inputs)))

    def getVariable(self, name: str) -> SDVariable:
        if name not in self._nodes:
            raise KeyError(name)
        return SDVariable(self, name)

    # ---------------------------------------------------------- op catalog
    # (the SDBaseOps/SDNN/SDMath/SDLoss method surface; each op is a table
    # name so the graph serializes: no closures)
    def mmul(self, a, b, name=None):
        return self._op("mmul", a, b, name=name)

    def add(self, a, b, name=None):
        return self._op("add", a, b, name=name)

    def sub(self, a, b, name=None):
        return self._op("sub", a, b, name=name)

    def mul(self, a, b, name=None):
        return self._op("mul", a, b, name=name)

    def div(self, a, b, name=None):
        return self._op("div", a, b, name=name)

    def pow(self, a, b, name=None):
        return self._op("pow", a, b, name=name)

    def exp(self, a, name=None):
        return self._op("exp", a, name=name)

    def log(self, a, name=None):
        return self._op("log", a, name=name)

    def sqrt(self, a, name=None):
        return self._op("sqrt", a, name=name)

    def rsqrt(self, a, name=None):
        return self._op("rsqrt", a, name=name)

    def square(self, a, name=None):
        return self._op("square", a, name=name)

    def abs(self, a, name=None):
        return self._op("abs", a, name=name)

    def sin(self, a, name=None):
        return self._op("sin", a, name=name)

    def cos(self, a, name=None):
        return self._op("cos", a, name=name)

    def tanh(self, a, name=None):
        return self._op("tanh", a, name=name)

    def erf(self, a, name=None):
        return self._op("erf", a, name=name)

    def sigmoid(self, a, name=None):
        return self._op("sigmoid", a, name=name)

    def relu(self, a, name=None):
        return self._op("relu", a, name=name)

    def gelu(self, a, name=None):
        return self._op("gelu", a, name=name)

    def elu(self, a, name=None):
        return self._op("elu", a, name=name)

    def leakyrelu(self, a, alpha=0.01, name=None):
        return self._op("leakyrelu", a, attrs={"alpha": alpha}, name=name)

    def softmax(self, a, axis=-1, name=None):
        return self._op("softmax", a, attrs={"axis": axis}, name=name)

    def log_softmax(self, a, axis=-1, name=None):
        return self._op("log_softmax", a, attrs={"axis": axis}, name=name)

    def conv2d(self, x, w, strides=(1, 1), padding="same", name=None):
        return self._op("conv2d", x, w,
                        attrs={"strides": list(strides), "padding": padding},
                        name=name)

    def depthwise_conv2d(self, x, w, strides=(1, 1), padding="same",
                         name=None):
        return self._op("depthwise_conv2d", x, w,
                        attrs={"strides": list(strides),
                               "padding": padding}, name=name)

    def max_pool2d(self, x, kernel=(2, 2), strides=None, padding="valid",
                   name=None):
        return self._op("max_pool2d", x, attrs={
            "kernel": list(kernel), "strides": list(strides or kernel),
            "padding": padding}, name=name)

    def avg_pool2d(self, x, kernel=(2, 2), strides=None, padding="valid",
                   name=None):
        return self._op("avg_pool2d", x, attrs={
            "kernel": list(kernel), "strides": list(strides or kernel),
            "padding": padding}, name=name)

    def layer_norm(self, x, gain, bias, eps=1e-5, name=None):
        return self._op("layer_norm", x, gain, bias, attrs={"eps": eps},
                        name=name)

    def batch_norm(self, x, mean, var, gamma, beta, eps=1e-5, name=None):
        return self._op("batch_norm", x, mean, var, gamma, beta,
                        attrs={"eps": eps}, name=name)

    def embedding_lookup(self, table, ids, name=None):
        return self._op("embedding_lookup", table, ids, name=name)

    def batch_matmul(self, a, b, name=None):
        return self._op("bmm", a, b, name=name)

    def matmul(self, a, b, name=None):
        return self._op("mmul", a, b, name=name)

    def _reduction(self, op, a, axis, keepdims, name):
        return self._op(op, a, attrs={"axis": _axlist(axis),
                                      "keepdims": keepdims}, name=name)

    def sum(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("sum", a, axis, keepdims, name)

    def mean(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("mean", a, axis, keepdims, name)

    def max(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("max", a, axis, keepdims, name)

    def min(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("min", a, axis, keepdims, name)

    def prod(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("prod", a, axis, keepdims, name)

    def std(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("std", a, axis, keepdims, name)

    def var_reduce(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("var", a, axis, keepdims, name)

    def norm1(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("norm1", a, axis, keepdims, name)

    def norm2(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("norm2", a, axis, keepdims, name)

    def normmax(self, a, axis=None, keepdims=False, name=None):
        return self._reduction("normmax", a, axis, keepdims, name)

    def argmax(self, a, axis=-1, name=None):
        return self._op("argmax", a, attrs={"axis": axis}, name=name)

    def argmin(self, a, axis=-1, name=None):
        return self._op("argmin", a, attrs={"axis": axis}, name=name)

    def cumsum(self, a, axis=-1, name=None):
        return self._op("cumsum", a, attrs={"axis": axis}, name=name)

    def concat(self, vars, axis=-1, name=None):
        return self._op("concat", *vars, attrs={"axis": axis}, name=name)

    def stack(self, vars, axis=0, name=None):
        return self._op("stack", *vars, attrs={"axis": axis}, name=name)

    def unstack(self, a, num, axis=0):
        return [self._op("unstack", a, attrs={"axis": axis, "index": i})
                for i in range(num)]

    def split(self, a, num, axis=0):
        return [self._op("split", a, attrs={"num": num, "axis": axis,
                                            "index": i})
                for i in range(num)]

    def gather(self, a, indices, axis=0, name=None):
        return self._op("gather", a, indices, attrs={"axis": axis}, name=name)

    def scatter_update(self, a, indices, updates, name=None):
        return self._op("scatter_update", a, indices, updates, name=name)

    def scatter_add(self, a, indices, updates, name=None):
        return self._op("scatter_add", a, indices, updates, name=name)

    def one_hot(self, a, depth, name=None):
        return self._op("one_hot", a, attrs={"depth": depth}, name=name)

    def cast(self, a, dtype, name=None):
        return self._op("cast", a, attrs={"dtype": dtype_name(dtype)},
                        name=name)

    def clip_by_value(self, a, lo, hi, name=None):
        return self._op("clip_by_value", a, attrs={"min": lo, "max": hi},
                        name=name)

    def reshape(self, a, shape, name=None):
        return self._op("reshape", a, attrs={"shape": list(shape)}, name=name)

    def transpose_(self, a, axes=None, name=None):
        return self._op("transpose", a,
                        attrs={"axes": list(axes) if axes else None},
                        name=name)

    def squeeze(self, a, axis=None, name=None):
        return self._op("squeeze", a, attrs={"axis": _axlist(axis)},
                        name=name)

    def expand_dims(self, a, axis, name=None):
        return self._op("expand_dims", a, attrs={"axis": axis}, name=name)

    def tile(self, a, reps, name=None):
        return self._op("tile", a, attrs={"reps": list(reps)}, name=name)

    def slice(self, a, begin, size, name=None):
        return self._op("slice", a, attrs={"begin": list(begin),
                                           "size": list(size)}, name=name)

    def eq(self, a, b, name=None):
        return self._op("eq", a, b, name=name)

    def gt(self, a, b, name=None):
        return self._op("gt", a, b, name=name)

    def lt(self, a, b, name=None):
        return self._op("lt", a, b, name=name)

    def where(self, cond, a, b, name=None):
        return self._op("where", cond, a, b, name=name)

    def identity(self, a, name=None):
        return self._op("identity", a, name=name)

    def pad(self, a, paddings, mode="constant", name=None):
        return self._op("pad", a, attrs={"paddings": [list(p) for p in paddings],
                                         "mode": mode}, name=name)

    # losses (SDLoss surface)
    def cross_entropy(self, labels, logits, name=None):
        return self._op("softmax_ce", labels, logits, name=name)

    def sigmoid_cross_entropy(self, labels, logits, name=None):
        return self._op("sigmoid_ce", labels, logits, name=name)

    def mse(self, labels, pred, name=None):
        return self._op("mse", labels, pred, name=name)

    def l1_loss(self, labels, pred, name=None):
        return self._op("l1_loss", labels, pred, name=name)

    def l2_loss(self, a, name=None):
        return self._op("l2_loss", a, name=name)

    def huber_loss(self, labels, pred, delta=1.0, name=None):
        return self._op("huber_loss", labels, pred, attrs={"delta": delta},
                        name=name)

    # ------------------------------------------------------- control flow
    # SameDiff If/While scopes. Branch bodies are sub-SameDiff graphs so the
    # whole thing serializes; they run on the host's control flow.
    def cond(self, pred: SDVariable, true_graph: "SameDiff",
             false_graph: "SameDiff", inputs: Sequence[SDVariable],
             name: Optional[str] = None) -> SDVariable:
        """If over two single-output sub-graphs.

        Each sub-graph must have placeholders named arg0..argN matching
        ``inputs`` and exactly one terminal op named 'out'."""
        name = name or self._fresh("cond")
        node = _Node(name, "control", op="cond",
                     inputs=(pred.name,) + tuple(i.name for i in inputs),
                     subgraphs={"true": true_graph, "false": false_graph})
        return self._add(node)

    def while_loop(self, cond_graph: "SameDiff", body_graph: "SameDiff",
                   inputs: Sequence[SDVariable], name: Optional[str] = None):
        """While: cond_graph -> scalar bool 'out'; body_graph maps
        arg0..argN -> out0..outN (or a single 'out' for 1-carry loops).

        Returns one SDVariable for a single carry, else a list of
        SDVariables, one per carry (tuple_get selector nodes)."""
        name = name or self._fresh("while")
        node = _Node(name, "control", op="while",
                     inputs=tuple(i.name for i in inputs),
                     subgraphs={"cond": cond_graph, "body": body_graph})
        var = self._add(node)
        if len(inputs) == 1:
            return var
        return [self._op("tuple_get", var, attrs={"index": i},
                         name=f"{name}_out{i}")
                for i in range(len(inputs))]

    def scan(self, body_graph: "SameDiff", init: SDVariable, xs: SDVariable,
             consts: Sequence[SDVariable] = (), name: Optional[str] = None):
        """Scan over the leading axis of ``xs``.

        body_graph: placeholders ``carry`` and ``x`` (plus ``const0..N``
        when ``consts`` are given) -> ops named ``carry_out`` (next carry)
        and optionally an op named ``y`` (per-step output; defaults to the
        carry). Returns (final_carry, stacked_ys).

        Trainable weights belong in the OUTER graph, passed via ``consts``
        so they flow through the graph and receive gradients; var()s defined
        inside the body are baked-in constants (as in cond/while bodies)."""
        name = name or self._fresh("scan")
        node = _Node(name, "control", op="scan",
                     inputs=(init.name, xs.name) + tuple(c.name for c in consts),
                     subgraphs={"body": body_graph})
        var = self._add(node)
        final = self._op("tuple_get", var, attrs={"index": 0},
                         name=f"{name}_carry")
        ys = self._op("tuple_get", var, attrs={"index": 1}, name=f"{name}_ys")
        return final, ys

    @staticmethod
    def _subgraph_fn(sub: "SameDiff", outputs: Optional[list] = None,
                     arg_names: Optional[list] = None):
        """Callable over a sub-graph: args bind to ``arg_names`` placeholders
        (default arg0..argN), outputs default to the single op 'out'."""
        outputs = outputs or ["out"]
        fn = sub._build_fn(outputs)
        svars = sub.variables()

        def call(*args):
            names = arg_names or [f"arg{i}" for i in range(len(args))]
            outs = fn(svars, dict(zip(names, args)))
            return outs[0] if len(outs) == 1 else tuple(outs)
        return call

    # ------------------------------------------------------------ execution
    def _topo(self, targets: list[str]) -> list[str]:
        order, seen = [], set()

        def visit(n):
            if n in seen:
                return
            seen.add(n)
            for d in self._nodes[n].inputs:
                visit(d)
            order.append(n)

        for t in targets:
            visit(t)
        return order

    def _node_fn(self, node: _Node) -> Callable:
        if node.kind == "op":
            return _OP_IMPLS[node.op](node.attrs)
        # control nodes
        if node.op == "cond":
            tfn = self._subgraph_fn(node.subgraphs["true"])
            ffn = self._subgraph_fn(node.subgraphs["false"])
            # the branch is chosen on the host: reading the predicate syncs
            return lambda pred, *args: (
                tfn if bool(pred.reshape(())) else ffn)(*args)
        if node.op == "while":
            n = len(node.inputs)
            outs = [f"out{i}" for i in range(n)] if n > 1 else ["out"]
            body_outs = outs if all(o in node.subgraphs["body"]._nodes
                                    for o in outs) else ["out"]
            cfn = self._subgraph_fn(node.subgraphs["cond"])
            bfn = self._subgraph_fn(node.subgraphs["body"], body_outs)

            def run(*args):
                carry = tuple(args)
                while bool(cfn(*carry).reshape(())):  # a sync a trip
                    r = bfn(*carry)
                    carry = r if isinstance(r, tuple) else (r,)
                return carry[0] if len(carry) == 1 else carry
            return run
        if node.op == "scan":
            body = node.subgraphs["body"]
            has_y = "y" in body._nodes and body._nodes["y"].kind == "op"
            outs = ["carry_out", "y"] if has_y else ["carry_out"]
            n_consts = len(node.inputs) - 2
            arg_names = ["carry", "x"] + [f"const{i}" for i in range(n_consts)]
            bfn = self._subgraph_fn(body, outs, arg_names)

            def run(init, xs, *cs):
                carry, ys = init, []
                for t in range(xs.shape[0]):
                    r = bfn(carry, xs[t], *cs)
                    carry, y = (r[0], r[1]) if isinstance(r, tuple) else (r, r)
                    ys.append(y)
                return carry, torch.stack(ys)
            return run
        raise ValueError(f"unknown control op {node.op}")

    def _build_fn(self, targets: list[str]):
        """The graph as fn(variables_dict, placeholders_dict) -> outputs,
        built once per target list (the order and each node's callable)."""
        key = tuple(targets)
        if key in self._fn_cache:
            return self._fn_cache[key]
        order = self._topo(targets)
        nodes = [self._nodes[n] for n in order]
        fns = {nd.name: self._node_fn(nd) for nd in nodes
               if nd.kind in ("op", "control")}

        def fn(variables, placeholders):
            token = _DEVICE.set(self.device)
            try:
                env = {}
                for node in nodes:
                    n = node.name
                    if node.kind == "placeholder":
                        env[n] = placeholders[n]
                    elif node.kind == "variable":
                        env[n] = variables[n]
                    elif node.kind == "constant":
                        env[n] = node.value
                    else:
                        env[n] = fns[n](*[env[i] for i in node.inputs])
                return [env[t] for t in targets]
            finally:
                _DEVICE.reset(token)

        self._fn_cache[key] = fn
        return fn

    def variables(self) -> dict:
        return {n: nd.value for n, nd in self._nodes.items()
                if nd.kind == "variable"}

    def set_variables(self, values: dict):
        """Set variables from tensors or numpy arrays (moved to the graph's
        device)."""
        for n, v in values.items():
            self._nodes[n].value = as_tensor(v, self.device)

    def _placeholders(self, placeholders) -> dict:
        return {k: as_tensor(v, self.device) for k, v in placeholders.items()}

    def output(self, *targets: str, **placeholders):
        """Execute (InferenceSession.output): no autograd graph is kept."""
        targets = [t.name if isinstance(t, SDVariable) else t for t in targets]
        fn = self._build_fn(list(targets))
        with torch.no_grad():
            outs = fn(self.variables(), self._placeholders(placeholders))
        return outs[0] if len(outs) == 1 else outs

    def _value_and_grad(self, fn, variables, ph):
        """The loss and its gradient for each floating variable (zeros for
        one the loss does not reach)."""
        leaves = {n: v.detach().requires_grad_()
                  for n, v in variables.items() if v.is_floating_point()}
        with torch.enable_grad():
            loss = fn({**variables, **leaves}, ph)[0]
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(v) if g is None else g
                               for (n, v), g in zip(leaves.items(), grads)}

    def grad(self, loss, wrt: Optional[list] = None, **placeholders):
        """Gradients of a scalar loss node wrt the variables
        (createGradFunction)."""
        loss = loss.name if isinstance(loss, SDVariable) else loss
        _, g = self._value_and_grad(self._build_fn([loss]), self.variables(),
                                    self._placeholders(placeholders))
        if wrt is not None:
            wrt = [w.name if isinstance(w, SDVariable) else w for w in wrt]
            return {n: g[n] for n in wrt}
        return g

    calculateGradients = grad

    # ------------------------------------------------------------- training
    def set_loss(self, loss):
        self.loss_name = loss.name if isinstance(loss, SDVariable) else loss
        return self

    def _step(self, updater, variables, opt_state, i, ph):
        """One step: the loss and its gradients, the updater, v - d."""
        loss, grads = self._value_and_grad(
            self._build_fn([self.loss_name]), variables, ph)
        with torch.no_grad():
            upd, opt_state = updater.update(grads, opt_state,
                                            {n: variables[n] for n in grads}, i)
            new_vars = dict(variables)
            new_vars.update({n: variables[n] - d for n, d in upd.items()})
        return new_vars, opt_state, loss

    def _trainer(self, updater):
        from deeplearning4j_tpu_torch.optimize.updaters import Sgd, get_updater

        if self.loss_name is None:
            raise ValueError("call set_loss() first")
        updater = get_updater(updater) if updater is not None else Sgd(lr=1e-2)
        variables = self.variables()
        opt_state = updater.init_state(
            {n: v for n, v in variables.items() if v.is_floating_point()})
        return updater, variables, opt_state

    def fit(self, updater=None, steps: int = 1, listeners=(),
            **placeholders) -> float:
        """TrainingSession: ``steps`` steps of loss, gradients and updater
        on one batch of placeholders."""
        updater, variables, opt_state = self._trainer(updater)
        ph = self._placeholders(placeholders)
        loss = torch.tensor(np.nan)
        for i in range(steps):
            variables, opt_state, loss = self._step(updater, variables,
                                                    opt_state, i, ph)
            for lst in listeners:
                lst.iteration_done(self, i, 0, float(loss))
        self.set_variables(variables)
        return float(loss)

    def fit_iterator(self, iterator, feature_ph: str, label_ph: str,
                     updater=None, epochs: int = 1, listeners=()) -> float:
        """SameDiff.fit(DataSetIterator): the updater state persists across
        batches and epochs."""
        updater, variables, opt_state = self._trainer(updater)
        loss, i = torch.tensor(np.nan), 0
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                feats, labels = ((ds.features, ds.labels)
                                 if hasattr(ds, "features") else ds)
                ph = self._placeholders({feature_ph: feats, label_ph: labels})
                variables, opt_state, loss = self._step(updater, variables,
                                                        opt_state, i, ph)
                for lst in listeners:
                    lst.iteration_done(self, i, 0, float(loss))
                i += 1
        self.set_variables(variables)
        return float(loss)

    def summary(self) -> str:
        """SameDiff.summary()."""
        lines = [f"{'name':<24}{'kind':<12}{'op':<16}inputs"]
        for n, d in self._nodes.items():
            lines.append(f"{n:<24}{d.kind:<12}{d.op or '-':<16}"
                         f"{','.join(d.inputs)}")
        return "\n".join(lines)

    # ---------------------------------------------------------------- serde
    # Arrays (variables AND constants, at every nesting level) all live in
    # one npz keyed "<prefix><kind>:<name>", where control-flow sub-graphs
    # extend the prefix with "<node>/<branch>/": dtype-exact, no JSON round
    # trip. numpy has no bfloat16: a bf16 array is stored as its uint16 bits
    # and its key listed under "bfloat16" in graph.json.
    def _meta(self) -> dict:
        meta = {}
        for n, d in self._nodes.items():
            ent = {"kind": d.kind, "inputs": list(d.inputs)}
            if d.kind in ("op", "control"):
                ent["op"] = d.op
                ent["attrs"] = d.attrs
            if d.kind == "placeholder" and d.shape:
                ent["shape"] = list(d.shape)
            if d.subgraphs:
                ent["subgraphs"] = {k: g._meta() for k, g in d.subgraphs.items()}
            meta[n] = ent
        return meta

    def _collect_arrays(self, prefix: str, out: dict, bf16: list):
        for n, d in self._nodes.items():
            if d.kind in ("variable", "constant") and d.value is not None:
                key = f"{prefix}{d.kind}:{n}"
                v = d.value.detach().cpu()
                if v.dtype == torch.bfloat16:
                    bf16.append(key)
                    v = v.view(torch.int16)
                    out[key] = v.numpy().view(np.uint16)
                else:
                    out[key] = v.numpy()
            for k, g in d.subgraphs.items():
                g._collect_arrays(f"{prefix}{n}/{k}/", out, bf16)

    def save(self, path: str):
        """The .sdz zip: graph JSON + arrays npz, reloadable by either
        package's SameDiff.load (ops referenced by table name)."""
        arrays: dict = {}
        bf16: list = []
        self._collect_arrays("", arrays, bf16)
        meta = {"nodes": self._meta(), "loss": self.loss_name,
                "counter": self._counter}
        if bf16:
            meta["bfloat16"] = bf16
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("graph.json", json.dumps(meta))
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            z.writestr("arrays.npz", buf.getvalue())

    @staticmethod
    def _from_meta(meta: dict, arrays: dict, device, prefix: str = "") -> "SameDiff":
        sd = SameDiff(device=device)
        for n, ent in meta.items():
            kind = ent["kind"]
            node = _Node(n, kind, inputs=tuple(ent.get("inputs", ())))
            if kind in ("op", "control"):
                node.op = ent["op"]
                node.attrs = ent.get("attrs", {})
            if kind in ("variable", "constant"):
                node.value = arrays[f"{prefix}{kind}:{n}"].to(sd.device)
            if ent.get("shape"):
                node.shape = tuple(ent["shape"])
            for k, sg_meta in ent.get("subgraphs", {}).items():
                node.subgraphs[k] = SameDiff._from_meta(
                    sg_meta, arrays, sd.device, prefix=f"{prefix}{n}/{k}/")
            sd._nodes[n] = node
        return sd

    @staticmethod
    def load(path: str, device="cuda") -> "SameDiff":
        """Reload a graph saved by either package's save() onto
        ``device``."""
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("graph.json"))
            with np.load(io.BytesIO(z.read("arrays.npz"))) as npz:
                raw = {k: npz[k] for k in npz.files}
        bf16 = set(meta.get("bfloat16", ()))
        arrays = {k: (torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16) if k in bf16 else as_tensor(a, "cpu"))
            for k, a in raw.items()}
        sd = SameDiff._from_meta(meta["nodes"], arrays, device)
        sd.loss_name = meta.get("loss")
        sd._counter = meta.get("counter", len(meta["nodes"]))
        return sd


# The extended op families (linalg, random, segment, image, sort, bitwise,
# distances, NN, losses) and the sd.math / sd.nn / ... namespaces. Imported
# last so the table and SameDiff exist; the import completes the catalog.
from deeplearning4j_tpu_torch.autodiff import sd_ops as _sd_ops  # noqa: E402,F401
