"""The extended SameDiff op catalog: the declarable-op families beyond the
core.

Counterpart of ``deeplearning4j_tpu/autodiff/sd_ops.py`` (libnd4j's
declarable custom ops and the ND4J SDMath / SDNN / SDLinalg / SDRandom /
SDImage / SDLoss / SDBitwise namespaces), op for op under the same names and
attributes, each a PyTorch lowering with the jnp function's semantics:
ddof 0 moments, ``jnp.median``'s mean of the two middle values, stable
sorts and top-k ties in index order, ``jax.image.resize``'s half-pixel
weights with antialiasing, the segment reductions' identities for empty
segments, optax's CTC loss.

Random ops keep the JAX package's contract, not its stream (threefry is
not torch's generator): each node's draw is fixed by its ``seed`` and
``salt`` attributes, the same on every run, on every device and after
save/load, and another ``seed`` draws anew. The draws come from a CPU
``torch.Generator`` seeded from (seed, salt) and move to the graph's
device. Dropout follows the same rule.

Three ops call the op registry, so a graph on the card reaches the
hand-written kernels: ``dot_product_attention`` (flash forward, dq, dk/dv),
``lstm_layer`` (the fused LSTM forward and backward) and ``lrn`` (the LRN
forward and backward). ``gru_layer`` calls the plain GRU lowering, as the
JAX op calls its scan and never the registry.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.topk import top_k
from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff, _OP_IMPLS, _axlist, _simple, current_device, dims, reduce_over,
    register_sd_op, scatter_rows, torch_dtype,
)

# --------------------------------------------------------------------------
# elementwise transforms (libnd4j transforms/*.cpp families)
# --------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


_simple("atan2", torch.atan2)
_simple("hypot", torch.hypot)
_simple("logaddexp", torch.logaddexp)
_simple("exp2", torch.exp2)
_simple("log2", torch.log2)
_simple("log10", torch.log10)
_simple("cbrt", lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0))
_simple("rint", torch.round)
_simple("trunc", torch.trunc)
_simple("fmod", torch.fmod)
_simple("remainder", torch.remainder)
_simple("copysign", torch.copysign)
_simple("asinh", torch.asinh)
_simple("acosh", torch.acosh)
_simple("atanh", torch.atanh)
_simple("erfc", torch.special.erfc)
_simple("erfinv", torch.special.erfinv)
_simple("lgamma", torch.lgamma)
_simple("digamma", torch.digamma)
_simple("sinc", torch.sinc)
_simple("isnan", torch.isnan)
_simple("isinf", torch.isinf)
_simple("isfinite", torch.isfinite)
_simple("mish", lambda x: x * torch.tanh(_softplus(x)))
_simple("selu", F.selu)
_simple("celu", F.celu)
_simple("swish", F.silu)
_simple("hardsigmoid", F.hardsigmoid)
_simple("hardtanh", lambda x: torch.clamp(x, -1.0, 1.0))
_simple("logsigmoid", F.logsigmoid)
_simple("cube", lambda x: x * x * x)
_simple("step", lambda x: (x > 0).to(x.dtype))
_simple("gaussian", lambda x: torch.exp(-x * x))
_simple("rectified_tanh", lambda x: torch.clamp(torch.tanh(x), min=0.0))
_simple("xlogx", lambda x: torch.where(
    x > 0, x * torch.log(torch.clamp(x, min=1e-38)), torch.zeros_like(x)))
_simple("prelu", lambda x, alpha: torch.where(x >= 0, x, alpha * x))
_simple("bias_add", lambda x, b: x + b)
_simple("linear", lambda x, w, b: x @ w + b)
_simple("relu_layer", lambda x, w, b: torch.relu(x @ w + b))
_simple("squared_difference", lambda a, b: (a - b) ** 2)


@register_sd_op("rational_tanh")
def _b_rational_tanh(attrs):
    # libnd4j RationalTanh: clipped rational approximation of tanh
    def fn(x):
        ax = torch.abs(x)
        approx = torch.sign(x) * (1.0 - 1.0 / (1.0 + ax + x * x
                                               + 1.41645 * (ax ** 4)))
        return torch.clamp(approx, -1.0, 1.0)
    return fn


@register_sd_op("thresholdedrelu")
def _b_thresholdedrelu(attrs):
    theta = attrs.get("theta", 1.0)
    return lambda x: torch.where(x > theta, x, torch.zeros_like(x))


@register_sd_op("glu")
def _b_glu(attrs):
    axis = attrs.get("axis", -1)
    return lambda x: F.glu(x, dim=axis)


# --------------------------------------------------------------------------
# bitwise (libnd4j ops/declarable/generic/bitwise)
# --------------------------------------------------------------------------


def _popcount32(x):
    """Set bits of x's 32-bit pattern (x as uint32), as int32."""
    v = x.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


_simple("bitwise_and", torch.bitwise_and)
_simple("bitwise_or", torch.bitwise_or)
_simple("bitwise_xor", torch.bitwise_xor)
_simple("bitwise_not", torch.bitwise_not)
_simple("left_shift", torch.bitwise_left_shift)
_simple("right_shift", torch.bitwise_right_shift)
_simple("population_count", _popcount32)


# --------------------------------------------------------------------------
# reductions beyond the core (entropy/zeroFraction/countNonZero analogs)
# --------------------------------------------------------------------------

def _axis_reduce(name, fn):
    @register_sd_op(name)
    def _b(attrs, _fn=fn):
        axis = attrs.get("axis")
        keepdims = attrs.get("keepdims", False)
        return lambda a: _fn(a, axis, keepdims)


def _nanext(a, ax, kd, fill, reduce):
    """jnp.nanmax / nanmin: NaNs ignored, NaN where a slice is all NaN."""
    ds = dims(ax, a.dim())
    nan = torch.isnan(a)
    out = reduce(torch.where(nan, torch.full_like(a, fill), a), dim=ds,
                 keepdim=kd)
    return torch.where(nan.all(dim=ds, keepdim=kd),
                       torch.full_like(out, float("nan")), out)


def _quantile(a, q, ax, kd):
    """jnp.quantile's default linear interpolation (jnp.median at 0.5: the
    mean of the two middle values, where torch.median takes the lower)."""
    a = a if a.is_floating_point() else a.to(torch.float32)
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    out = reduce_over(lambda t: torch.quantile(t, qt, dim=-1), a, ax, False)
    if kd:
        ds = {d % a.dim() for d in dims(ax, a.dim())}
        kept = [1 if d in ds else a.shape[d] for d in range(a.dim())]
        out = out.reshape(tuple(qt.shape) + tuple(kept))
    return out


_axis_reduce("logsumexp", lambda a, ax, kd: torch.logsumexp(
    a, dim=dims(ax, a.dim()), keepdim=kd))
_axis_reduce("count_nonzero", lambda a, ax, kd: (a != 0).sum(
    dim=dims(ax, a.dim()), keepdim=kd))
_axis_reduce("zero_fraction", lambda a, ax, kd: (a == 0).to(torch.float32).mean(
    dim=dims(ax, a.dim()), keepdim=kd))
_axis_reduce("entropy", lambda a, ax, kd: -torch.sum(
    a * torch.log(torch.clamp(a, min=1e-38)), dim=dims(ax, a.dim()),
    keepdim=kd))
_axis_reduce("shannon_entropy", lambda a, ax, kd: -torch.sum(
    a * torch.log2(torch.clamp(a, min=1e-38)), dim=dims(ax, a.dim()),
    keepdim=kd))
_axis_reduce("sq_norm", lambda a, ax, kd: torch.sum(
    a * a, dim=dims(ax, a.dim()), keepdim=kd))
_axis_reduce("median", lambda a, ax, kd: _quantile(a, 0.5, ax, kd))
_axis_reduce("nansum", lambda a, ax, kd: torch.nansum(
    a, dim=dims(ax, a.dim()), keepdim=kd))
_axis_reduce("nanmean", lambda a, ax, kd: torch.nanmean(
    a, dim=dims(ax, a.dim()), keepdim=kd))
_axis_reduce("nanmax", lambda a, ax, kd: _nanext(a, ax, kd, -math.inf,
                                                 torch.amax))
_axis_reduce("nanmin", lambda a, ax, kd: _nanext(a, ax, kd, math.inf,
                                                 torch.amin))


@register_sd_op("percentile")
def _b_percentile(attrs):
    q = attrs["q"]
    axis = attrs.get("axis")
    keepdims = attrs.get("keepdims", False)
    qs = np.asarray(q, np.float64) / 100.0
    return lambda a: _quantile(a, qs.tolist(), axis, keepdims)


@register_sd_op("moments")
def _b_moments(attrs):
    axis = attrs.get("axis")
    keepdims = attrs.get("keepdims", False)
    return lambda a: (torch.mean(a, dim=dims(axis, a.dim()), keepdim=keepdims),
                      torch.var(a, dim=dims(axis, a.dim()), correction=0,
                                keepdim=keepdims))


@register_sd_op("standardize")
def _b_standardize(attrs):
    axis = attrs.get("axis", -1)
    eps = attrs.get("eps", 1e-5)

    def fn(x):
        ds = dims(axis, x.dim())
        m = x.mean(dim=ds, keepdim=True)
        v = x.var(dim=ds, keepdim=True, correction=0)
        return (x - m) * torch.rsqrt(v + eps)
    return fn


# --------------------------------------------------------------------------
# reduce3 pairwise distances (libnd4j reduce3: cosine/euclidean/manhattan/
# hamming/jaccard)
# --------------------------------------------------------------------------

def _reduce3(name, fn):
    @register_sd_op(name)
    def _b(attrs, _fn=fn):
        axis = attrs.get("axis")
        keepdims = attrs.get("keepdims", False)
        return lambda a, b: _fn(a, b, axis, keepdims)


def _sum(a, ax, kd):
    return torch.sum(a, dim=dims(ax, a.dim()), keepdim=kd)


def _cos_sim(a, b, ax, kd):
    num = _sum(a * b, ax, kd)
    den = torch.sqrt(_sum(a * a, ax, kd) * _sum(b * b, ax, kd))
    return num / torch.clamp(den, min=1e-12)


_reduce3("cosine_similarity", _cos_sim)
_reduce3("cosine_distance", lambda a, b, ax, kd: 1.0 - _cos_sim(a, b, ax, kd))
_reduce3("euclidean_distance", lambda a, b, ax, kd: torch.sqrt(
    torch.clamp(_sum((a - b) ** 2, ax, kd), min=1e-30)))
_reduce3("manhattan_distance", lambda a, b, ax, kd: _sum(
    torch.abs(a - b), ax, kd))
_reduce3("hamming_distance", lambda a, b, ax, kd: _sum(
    (a != b).to(torch.float32), ax, kd))
_reduce3("jaccard_distance", lambda a, b, ax, kd: 1.0 - (
    _sum(torch.minimum(a, b), ax, kd)
    / torch.clamp(_sum(torch.maximum(a, b), ax, kd), min=1e-12)))
_reduce3("dot", lambda a, b, ax, kd: _sum(a * b, ax, kd))


# --------------------------------------------------------------------------
# shape / manipulation
# --------------------------------------------------------------------------


def _eye_like(n, m, k, dtype, device):
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(m, device=device)[None, :]
    return (j - i == k).to(dtype)


_simple("flatten", lambda a: a.reshape(a.shape[0], -1))
_simple("ravel", lambda a: a.reshape(-1))
_simple("size", lambda a: torch.tensor(a.numel(), dtype=torch.int64,
                                       device=a.device))
_simple("rank", lambda a: torch.tensor(a.dim(), dtype=torch.int32,
                                       device=a.device))
_simple("shape_of", lambda a: torch.tensor(tuple(a.shape), dtype=torch.int64,
                                           device=a.device))
_simple("zeros_like", torch.zeros_like)
_simple("ones_like", torch.ones_like)
_simple("invert_permutation", lambda p: torch.argsort(p, stable=True))
_simple("trace", lambda a: torch.diagonal(a, dim1=-2, dim2=-1).sum(-1))
_simple("diag_part", lambda a: torch.diagonal(a, dim1=-2, dim2=-1))
_simple("matrix_diag", lambda v: v[..., None] * _eye_like(
    v.shape[-1], v.shape[-1], 0, v.dtype, v.device))
_simple("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))
_simple("kron", torch.kron)
_simple("cross", lambda a, b: torch.linalg.cross(a, b, dim=-1))


@register_sd_op("roll")
def _b_roll(attrs):
    shift = attrs["shift"]
    axis = attrs.get("axis")
    if axis is None:
        return lambda a: torch.roll(a, shift)
    ax = dims(axis, 0)
    sh = tuple(shift) if isinstance(shift, list) else (shift,) * len(ax)
    return lambda a: torch.roll(a, sh, ax)


@register_sd_op("reverse")
def _b_reverse(attrs):
    axis = attrs.get("axis")
    return lambda a: torch.flip(a, dims(axis, a.dim()))


@register_sd_op("repeat")
def _b_repeat(attrs):
    repeats, axis = attrs["repeats"], attrs.get("axis")

    def fn(a):
        r = (torch.as_tensor(repeats, device=a.device)
             if isinstance(repeats, list) else repeats)
        return torch.repeat_interleave(a, r, dim=axis)
    return fn


@register_sd_op("broadcast_to")
def _b_broadcast_to(attrs):
    shape = tuple(attrs["shape"])
    return lambda a: torch.broadcast_to(a, shape)


@register_sd_op("moveaxis")
def _b_moveaxis(attrs):
    return lambda a: torch.movedim(a, attrs["source"], attrs["destination"])


@register_sd_op("swapaxes")
def _b_swapaxes(attrs):
    return lambda a: torch.swapaxes(a, attrs["axis1"], attrs["axis2"])


@register_sd_op("full_like")
def _b_full_like(attrs):
    return lambda a: torch.full_like(a, attrs["value"])


@register_sd_op("linspace")
def _b_linspace(attrs):
    return lambda: torch.linspace(attrs["start"], attrs["stop"], attrs["num"],
                                  dtype=torch.float32,
                                  device=current_device())


@register_sd_op("range")
def _b_range(attrs):
    def fn():
        dt = torch_dtype(attrs.get("dtype", "float32"))
        start, stop = attrs["start"], attrs.get("stop")
        if stop is None:
            start, stop = 0, start
        return torch.arange(start, stop, attrs.get("step", 1), dtype=dt,
                            device=current_device())
    return fn


@register_sd_op("eye")
def _b_eye(attrs):
    n = attrs["n"]
    m = attrs.get("m") or n
    return lambda: _eye_like(n, m, attrs.get("k", 0),
                             torch_dtype(attrs.get("dtype", "float32")),
                             current_device())


@register_sd_op("tril")
def _b_tril(attrs):
    k = attrs.get("k", 0)
    return lambda a: torch.tril(a, k)


@register_sd_op("triu")
def _b_triu(attrs):
    k = attrs.get("k", 0)
    return lambda a: torch.triu(a, k)


@register_sd_op("diag")
def _b_diag(attrs):
    k = attrs.get("k", 0)
    return lambda a: torch.diag(a, k)


@register_sd_op("space_to_depth")
def _b_space_to_depth(attrs):
    bs = attrs["block_size"]

    def fn(x):  # NHWC
        B, H, W, C = x.shape
        x = x.reshape(B, H // bs, bs, W // bs, bs, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // bs, W // bs,
                                                   bs * bs * C)
    return fn


@register_sd_op("depth_to_space")
def _b_depth_to_space(attrs):
    bs = attrs["block_size"]

    def fn(x):  # NHWC
        B, H, W, C = x.shape
        x = x.reshape(B, H, W, bs, bs, C // (bs * bs))
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H * bs, W * bs,
                                                   C // (bs * bs))
    return fn


@register_sd_op("reverse_sequence")
def _b_reverse_sequence(attrs):
    seq_axis = attrs.get("seq_axis", 1)
    batch_axis = attrs.get("batch_axis", 0)

    def fn(x, lengths):
        xm = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
        B, T = xm.shape[0], xm.shape[1]
        t = torch.arange(T, device=x.device)[None, :]          # [1, T]
        L = lengths.long().reshape(B, 1)                      # [B, 1]
        idx = torch.where(t < L, L - 1 - t, t)                # [B, T]
        idx = idx.reshape((B, T) + (1,) * (xm.dim() - 2))
        out = torch.take_along_dim(xm, idx.expand(xm.shape), dim=1)
        return torch.movedim(out, (0, 1), (batch_axis, seq_axis))
    return fn


@register_sd_op("take_along_axis")
def _b_take_along_axis(attrs):
    axis = attrs.get("axis", -1)
    return lambda a, idx: torch.take_along_dim(a, idx.long(), dim=axis)


def _nd_index(idx):
    idx = idx.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


@register_sd_op("gather_nd")
def _b_gather_nd(attrs):
    return lambda a, idx: a[_nd_index(idx)]


@register_sd_op("scatter_nd")
def _b_scatter_nd(attrs):
    shape = tuple(attrs["shape"])

    def fn(idx, updates):
        out = torch.zeros(shape, dtype=updates.dtype, device=updates.device)
        return out.index_put(_nd_index(idx), updates, accumulate=True)
    return fn


def _scatter(name, fn):
    @register_sd_op(name)
    def _b(attrs, _fn=fn):
        def call(a, idx, upd):
            i, u = scatter_rows(a, idx, upd)
            return _fn(a, i, u)
        return call


_scatter("scatter_sub", lambda a, i, u: a.index_put((i,), -u, accumulate=True))
_scatter("scatter_mul", lambda a, i, u: a.index_reduce(0, i, u, "prod"))
_scatter("scatter_div", lambda a, i, u: a.index_reduce(0, i, 1.0 / u, "prod"))
_scatter("scatter_max", lambda a, i, u: a.index_reduce(0, i, u, "amax"))
_scatter("scatter_min", lambda a, i, u: a.index_reduce(0, i, u, "amin"))


# --------------------------------------------------------------------------
# segment reductions (libnd4j segment_*/unsorted_segment_*). An empty
# segment holds the reduction's identity, as jax.ops' do: 0 for sum, -inf /
# +inf for max / min (the type's least / largest integer), 1 for prod.
# Ids outside [0, n) are dropped (they land in a spare row n).
# --------------------------------------------------------------------------

def _identity(dtype, kind):
    if kind == "sum":
        return 0
    if kind == "prod":
        return 1
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    if kind == "amax":
        return -math.inf if dtype.is_floating_point else info.min
    return math.inf if dtype.is_floating_point else info.max


def segment_reduce(a, ids, n, kind):
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    out = torch.full((n + 1,) + tuple(a.shape[1:]), _identity(a.dtype, kind),
                     dtype=a.dtype, device=a.device)
    if kind == "sum":
        out = out.index_add(0, ids, a)
    else:
        out = out.index_reduce(0, ids, a, kind)
    return out[:n]


def _segment_count(a, ids, n):
    return segment_reduce(torch.ones_like(a), ids, n, "sum")


def _segment(name, fn):
    @register_sd_op(name)
    def _b(attrs, _f=fn):
        num = attrs["num_segments"]
        return lambda a, ids: _f(a, ids, num)


for _prefix in ("", "unsorted_"):
    # the unsorted_* variants are the same lowering (scatter-reduce); kept
    # as distinct names for import parity
    _segment(f"{_prefix}segment_sum",
             lambda a, i, n: segment_reduce(a, i, n, "sum"))
    _segment(f"{_prefix}segment_max",
             lambda a, i, n: segment_reduce(a, i, n, "amax"))
    _segment(f"{_prefix}segment_min",
             lambda a, i, n: segment_reduce(a, i, n, "amin"))
    _segment(f"{_prefix}segment_prod",
             lambda a, i, n: segment_reduce(a, i, n, "prod"))
    _segment(f"{_prefix}segment_mean",
             lambda a, i, n: segment_reduce(a, i, n, "sum")
             / torch.clamp(_segment_count(a, i, n), min=1.0))
_segment("unsorted_segment_sqrt_n", lambda a, i, n: segment_reduce(
    a, i, n, "sum") / torch.sqrt(torch.clamp(_segment_count(a, i, n),
                                             min=1.0)))


# --------------------------------------------------------------------------
# sort / topk / search. jnp.sort and jnp.argsort are stable over values
# (-0.0 equals +0.0, NaNs last); lax.top_k ranks floats in their total
# order (+0.0 above -0.0, a NaN first) and puts the lower index first among
# equal keys, so the port ranks top-k on an integer key with that order
# (common/topk.py, shared with neighbors.knn_search).
# --------------------------------------------------------------------------

@register_sd_op("sort")
def _b_sort(attrs):
    axis = attrs.get("axis", -1)
    desc = attrs.get("descending", False)

    def fn(a):
        s = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(s, (axis,)) if desc else s
    return fn


@register_sd_op("argsort")
def _b_argsort(attrs):
    axis = attrs.get("axis", -1)
    desc = attrs.get("descending", False)

    def fn(a):
        s = torch.argsort(a, dim=axis, stable=True)
        return torch.flip(s, (axis,)) if desc else s
    return fn


@register_sd_op("top_k")
def _b_top_k(attrs):
    k = attrs["k"]

    def fn(a):  # (values, indices)
        return top_k(a, k)
    return fn


@register_sd_op("in_top_k")
def _b_in_top_k(attrs):
    k = attrs["k"]

    def fn(predictions, targets):
        t = targets.long()
        target_scores = torch.take_along_dim(predictions, t[:, None], dim=-1)
        rank = torch.sum(predictions > target_scores, dim=-1)
        return rank < k
    return fn


@register_sd_op("searchsorted")
def _b_searchsorted(attrs):
    side = attrs.get("side", "left")
    return lambda sorted_seq, values: torch.searchsorted(
        sorted_seq, values.to(sorted_seq.dtype), side=side)


# --------------------------------------------------------------------------
# linear algebra (libnd4j generic/linalg; SDLinalg surface)
# --------------------------------------------------------------------------

def _sym(a):
    """jnp.linalg.eigh symmetrizes its input; torch reads the lower
    triangle."""
    return (a + a.mT) / 2


_simple("cholesky", torch.linalg.cholesky)
_simple("matrix_inverse", torch.linalg.inv)
_simple("pinv", torch.linalg.pinv)
_simple("matrix_determinant", torch.linalg.det)
_simple("solve", torch.linalg.solve)
_simple("expm", torch.linalg.matrix_exp)
_simple("slogdet", lambda a: tuple(torch.linalg.slogdet(a)))  # (sign, logabsdet)
_simple("eigh", lambda a: tuple(torch.linalg.eigh(_sym(a))))  # (w, v)
_simple("lstsq", lambda a, b: torch.linalg.lstsq(a, b).solution)


@register_sd_op("log_matrix_determinant")
def _b_logdet(attrs):
    return lambda a: torch.linalg.slogdet(a)[1]


@register_sd_op("qr")
def _b_qr(attrs):
    mode = attrs.get("mode", "reduced")

    def fn(a):  # (q, r); r alone for mode "r"
        q, r = torch.linalg.qr(a, mode=mode)
        return r if mode == "r" else (q, r)
    return fn


@register_sd_op("svd")
def _b_svd(attrs):
    full = attrs.get("full_matrices", False)
    return lambda a: tuple(torch.linalg.svd(a, full_matrices=full))  # (u, s, vT)


@register_sd_op("lu")
def _b_lu(attrs):
    return lambda a: tuple(torch.linalg.lu(a))  # (p, l, u), a = p l u


@register_sd_op("triangular_solve")
def _b_triangular_solve(attrs):
    lower = attrs.get("lower", True)
    trans = attrs.get("trans", 0)

    def fn(a, b):
        if trans in (1, 2, "T", "C"):
            a, lower_ = a.mT, not lower
        else:
            lower_ = lower
        vec = b.dim() == a.dim() - 1
        x = torch.linalg.solve_triangular(a, b[..., None] if vec else b,
                                          upper=not lower_)
        return x[..., 0] if vec else x
    return fn


@register_sd_op("matrix_power")
def _b_matrix_power(attrs):
    n = attrs["n"]
    return lambda a: torch.linalg.matrix_power(a, n)


@register_sd_op("matrix_rank")
def _b_matrix_rank(attrs):
    tol = attrs.get("tol")
    return lambda a: torch.linalg.matrix_rank(a, rtol=tol)


@register_sd_op("tensordot")
def _b_tensordot(attrs):
    axes = attrs.get("axes", 2)
    if isinstance(axes, list):
        axes = tuple(tuple(x) for x in axes)
    return lambda a, b: torch.tensordot(a, b, dims=axes)


@register_sd_op("einsum")
def _b_einsum(attrs):
    eq = attrs["equation"]
    return lambda *ops: torch.einsum(eq, *ops)


@register_sd_op("matrix_transpose")
def _b_matrix_transpose(attrs):
    return lambda a: torch.swapaxes(a, -1, -2)


# --------------------------------------------------------------------------
# random distributions (libnd4j generic/random + legacy random loops).
# Deterministic per node: the generator is seeded from (seed, salt), the
# salt fixed at node creation, so saved graphs replay identically.
# --------------------------------------------------------------------------

def _splitmix64(v: int) -> int:
    v = (v + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return v ^ (v >> 31)


def rng_for(attrs) -> torch.Generator:
    """The node's CPU generator, seeded from its (seed, salt) pair mixed
    into the 32 bits the CPU generator's Mersenne twister keeps."""
    seed = int(attrs.get("seed", 0)) & 0xFFFFFFFF
    salt = int(attrs.get("salt", 0)) & 0xFFFFFFFF
    return torch.Generator().manual_seed(
        _splitmix64((seed << 32) | salt) & 0xFFFFFFFF)


def _uniform(g, shape, lo=0.0, hi=1.0):
    """Uniform in [lo, hi) on the host, float64 (the samplers transform it
    before rounding to the node's type)."""
    return torch.rand(shape, generator=g, dtype=torch.float64) * (hi - lo) + lo


def _open_uniform(g, shape):
    """Uniform in (0, 1): the logs and inverse CDFs stay finite."""
    tiny = float(np.finfo(np.float64).tiny)
    return torch.clamp(_uniform(g, shape), min=tiny)


def _std_normal(g, shape):
    return torch.randn(shape, generator=g, dtype=torch.float64)


def _gamma(g, alpha, shape):
    return torch._standard_gamma(torch.full(shape, float(alpha),
                                            dtype=torch.float64), generator=g)


def _truncated_normal(g, shape):
    """N(0, 1) conditioned on [-2, 2], by the inverse CDF."""
    cdf = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = _uniform(g, shape, cdf, 1.0 - cdf)
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


_SAMPLERS = {
    "random_normal": lambda g, s, a: a.get("mean", 0.0)
    + a.get("stddev", 1.0) * _std_normal(g, s),
    "random_uniform": lambda g, s, a: _uniform(g, s, a.get("min", 0.0),
                                               a.get("max", 1.0)),
    "random_bernoulli": lambda g, s, a: (_uniform(g, s) < a.get("p", 0.5)),
    "random_exponential": lambda g, s, a: -torch.log(_open_uniform(g, s))
    / a.get("rate", 1.0),
    "random_gamma": lambda g, s, a: _gamma(g, a.get("alpha", 1.0), s)
    / a.get("beta", 1.0),
    "random_poisson": lambda g, s, a: torch.poisson(
        torch.full(s, float(a.get("rate", 1.0)), dtype=torch.float64),
        generator=g),
    "random_truncated_normal": lambda g, s, a: a.get("mean", 0.0)
    + a.get("stddev", 1.0) * _truncated_normal(g, s),
    "random_laplace": lambda g, s, a: a.get("mean", 0.0) + a.get("scale", 1.0)
    * _laplace(_uniform(g, s, -0.5, 0.5)),
    "random_cauchy": lambda g, s, a: a.get("median", 0.0) + a.get("scale", 1.0)
    * torch.tan(math.pi * (_open_uniform(g, s) - 0.5)),
    "random_gumbel": lambda g, s, a: -torch.log(-torch.log(
        _open_uniform(g, s))),
    "random_beta": lambda g, s, a: _beta(g, a.get("alpha", 1.0),
                                         a.get("beta", 1.0), s),
    "random_randint": lambda g, s, a: torch.randint(
        a.get("min", 0), a["max"], s, generator=g),
}


def _laplace(u):
    return -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


def _beta(g, alpha, beta, shape):
    x = _gamma(g, alpha, shape)
    return x / (x + _gamma(g, beta, shape))


def _random(name):
    @register_sd_op(name)
    def _b(attrs, _s=_SAMPLERS[name]):
        shape = tuple(attrs["shape"])
        default = "int32" if name == "random_randint" else "float32"
        dtype = torch_dtype(attrs.get("dtype", default))
        return lambda: _s(rng_for(attrs), shape, attrs).to(
            dtype=dtype, device=current_device())


for _name in _SAMPLERS:
    _random(_name)


@register_sd_op("random_categorical")
def _b_random_categorical(attrs):
    n = attrs["num_samples"]

    def fn(logits):  # the Gumbel-max draw, as jax.random.categorical's
        B, C = logits.shape[0], logits.shape[-1]
        gum = -torch.log(-torch.log(_open_uniform(rng_for(attrs), (B, n, C))))
        return torch.argmax(logits[:, None, :] + gum.to(logits.device,
                                                        logits.dtype), dim=-1)
    return fn


@register_sd_op("random_shuffle")
def _b_random_shuffle(attrs):
    axis = attrs.get("axis", 0)

    def fn(a):
        perm = torch.randperm(a.shape[axis], generator=rng_for(attrs))
        return a.index_select(axis, perm.to(a.device))
    return fn


@register_sd_op("dropout")
def _b_dropout(attrs):
    rate = attrs.get("rate", 0.5)

    def fn(x):
        keep = (_uniform(rng_for(attrs), tuple(x.shape)) < 1.0 - rate).to(
            x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    return fn


# --------------------------------------------------------------------------
# image ops (libnd4j generic/images + parity_ops resize/crop)
# --------------------------------------------------------------------------

def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius):
    def k(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(
            x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x)),
            torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return k


_RESIZE_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
                   "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def resize_weights(n_in, n_out, kernel, device):
    """jax.image.resize's [n_in, n_out] weights for one axis (its
    ``compute_weight_mat`` at translation 0 with antialiasing): half-pixel
    sample points, the kernel widened by the downscale factor when
    downsampling, columns normalized, samples outside the input zeroed.
    Computed in float32, as jax does."""
    f32 = torch.float32
    inv_scale = float(np.float32(1.0) / np.float32(n_out / n_in))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=f32, device=device)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x, h, w, method):
    """jax.image.resize of [B, H, W, C] to [B, h, w, C]."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if method == "nearest":
        for d, n in ((1, h), (2, w)):
            m = x.shape[d]
            if m != n:
                off = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                                  * m / n).long()
                x = x.index_select(d, off.to(x.device))
        return x
    kernel = _RESIZE_KERNELS[method]
    # one contraction a resized axis (an axis of equal size is left as is)
    if x.shape[1] != h:
        x = torch.einsum("bhwc,hk->bkwc", x, resize_weights(
            x.shape[1], h, kernel, x.device).to(x.dtype))
    if x.shape[2] != w:
        x = torch.einsum("bhwc,wk->bhkc", x, resize_weights(
            x.shape[2], w, kernel, x.device).to(x.dtype))
    return x


@register_sd_op("image_resize")
def _b_image_resize(attrs):
    h, w = attrs["height"], attrs["width"]
    method = attrs.get("method", "bilinear")
    tmethod = {"bilinear": "linear", "nearest": "nearest", "bicubic": "cubic",
               "lanczos3": "lanczos3", "lanczos5": "lanczos5"}[method]
    return lambda x: image_resize(x, h, w, tmethod)


@register_sd_op("resize_bilinear")
def _b_resize_bilinear(attrs):
    return _b_image_resize({**attrs, "method": "bilinear"})


@register_sd_op("resize_nearest")
def _b_resize_nearest(attrs):
    return _b_image_resize({**attrs, "method": "nearest"})


_simple("flip_left_right", lambda x: torch.flip(x, (-2,)))
_simple("flip_up_down", lambda x: torch.flip(x, (-3,)))


@register_sd_op("rot90")
def _b_rot90(attrs):
    k = attrs.get("k", 1)
    return lambda x: torch.rot90(x, k, (x.dim() - 3, x.dim() - 2))


@register_sd_op("adjust_contrast")
def _b_adjust_contrast(attrs):
    factor = attrs["factor"]

    def fn(x):
        mean = x.mean(dim=(-3, -2), keepdim=True)
        return (x - mean) * factor + mean
    return fn


@register_sd_op("adjust_brightness")
def _b_adjust_brightness(attrs):
    return lambda x: x + attrs["delta"]


_simple("rgb_to_grayscale", lambda x: (x[..., :1] * 0.2989 + x[..., 1:2] * 0.587
                                       + x[..., 2:3] * 0.114))


@register_sd_op("rgb_to_hsv")
def _b_rgb_to_hsv(attrs):
    def fn(x):
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        mx = torch.maximum(torch.maximum(r, g), b)
        mn = torch.minimum(torch.minimum(r, g), b)
        d = mx - mn
        zero, one = torch.zeros_like(d), torch.ones_like(d)
        safe = torch.where(d > 0, d, one)
        h = torch.where(
            d == 0, zero,
            torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                        torch.where(mx == g, (b - r) / safe + 2.0,
                                    (r - g) / safe + 4.0))) / 6.0
        s = torch.where(mx > 0, d / torch.where(mx > 0, mx, one), zero)
        return torch.stack([h, s, mx], dim=-1)
    return fn


@register_sd_op("hsv_to_rgb")
def _b_hsv_to_rgb(attrs):
    def fn(x):
        h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
        i = torch.floor(h)
        f = h - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = torch.remainder(i.to(torch.int32), 6).long()[..., None]

        def choose(*opts):  # jnp.choose(i, opts, mode="clip")
            return torch.take_along_dim(torch.stack(opts, -1), i, -1)[..., 0]
        return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                            choose(p, p, t, v, v, q)], dim=-1)
    return fn


@register_sd_op("central_crop")
def _b_central_crop(attrs):
    frac = attrs["fraction"]

    def fn(x):  # [B, H, W, C]
        H, W = x.shape[-3], x.shape[-2]
        ch, cw = int(H * frac), int(W * frac)
        top, left = (H - ch) // 2, (W - cw) // 2
        return x[..., top:top + ch, left:left + cw, :]
    return fn


@register_sd_op("extract_image_patches")
def _b_extract_patches(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import _spatial_pads

    k = tuple(attrs["kernel"])
    s = tuple(attrs.get("strides", k))
    padding = attrs.get("padding", "valid").lower()

    def fn(x):  # NHWC -> [B, H', W', C*kh*kw], feature (c, i, j)
        B = x.shape[0]
        (t, b), (l, r) = _spatial_pads(padding, tuple(x.shape[1:3]), k, s)
        xc = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b))
        cols = F.unfold(xc, k, stride=s)
        Ho = (xc.shape[2] - k[0]) // s[0] + 1
        Wo = (xc.shape[3] - k[1]) // s[1] + 1
        return cols.reshape(B, -1, Ho, Wo).permute(0, 2, 3, 1)
    return fn


# --------------------------------------------------------------------------
# NN extras: conv variants, pooling variants, norms, attention, recurrent
# --------------------------------------------------------------------------

@register_sd_op("conv1d")
def _b_conv1d(attrs):
    stride = attrs.get("stride", 1)
    padding = attrs.get("padding", "same")

    def fn(x, w):  # x [B, T, C], w [K, C, O]
        from deeplearning4j_tpu_torch.ops.convolution import conv2d as _c
        y = _c(x[:, :, None, :], w[:, None, :, :], strides=(stride, 1),
               padding=padding)
        return y[:, :, 0, :]
    return fn


@register_sd_op("conv3d")
def _b_conv3d(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import conv3d
    strides = tuple(attrs.get("strides", (1, 1, 1)))
    padding = attrs.get("padding", "same").lower()
    return lambda x, w: conv3d(x, w, strides=strides, padding=padding)


@register_sd_op("deconv2d")
def _b_deconv2d(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import deconv2d
    strides = tuple(attrs.get("strides", (1, 1)))
    padding = attrs.get("padding", "same").lower()
    return lambda x, w: deconv2d(x, w, strides=strides, padding=padding)


@register_sd_op("depthwise_conv2d")
def _b_depthwise_conv2d(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import depthwise_conv2d
    strides = tuple(attrs.get("strides", (1, 1)))
    padding = attrs.get("padding", "same").lower()
    return lambda x, w: depthwise_conv2d(x, w, strides=strides,
                                         padding=padding)


@register_sd_op("separable_conv2d")
def _b_separable_conv2d(attrs):
    from deeplearning4j_tpu_torch.ops.convolution import conv2d
    dw = _b_depthwise_conv2d(attrs)
    return lambda x, w_depth, w_point: conv2d(dw(x, w_depth), w_point,
                                              strides=(1, 1), padding="same")


def _window(x, k, s, padding, op):
    """lax.reduce_window over the spatial dims of [B, *spatial, C] (1 to 3
    of them): max pads with -inf; avg divides each window's sum by its
    count of input (not padding) elements."""
    from deeplearning4j_tpu_torch.ops.convolution import _same_pads

    nd = len(k)
    if nd == 1:  # one spatial dim: the 2-D pools over [B, T, 1, C]
        out = _window(x[:, :, None, :], k + (1,), s + (1,), padding, op)
        return out[:, :, 0, :]
    spatial = tuple(x.shape[1:1 + nd])
    pads = ([_same_pads(n, kk, ss) for n, kk, ss in zip(spatial, k, s)]
            if padding == "same" else [(0, 0)] * nd)
    flat = [v for p in reversed(pads) for v in p]
    xc = x.movedim(-1, 1)
    pool = {2: (F.max_pool2d, F.avg_pool2d), 3: (F.max_pool3d, F.avg_pool3d)}
    mx, avg = pool[nd]
    if op == "max":
        out = mx(F.pad(xc, flat, value=-math.inf), k, s)
    else:
        sums = avg(F.pad(xc, flat), k, s, divisor_override=1)
        cnt = avg(F.pad(torch.ones_like(xc[:1, :1]), flat), k, s,
                  divisor_override=1)
        out = sums / cnt
    return out.movedim(1, -1)


def _pool_nd(name, op, spatial):
    @register_sd_op(name)
    def _b(attrs, _op=op, _nd=spatial):
        k = tuple(attrs.get("kernel", (2,) * _nd))
        s = tuple(attrs.get("strides", k))
        pad_ = attrs.get("padding", "valid").lower()
        return lambda x: _window(x, k, s, pad_, _op)


_pool_nd("max_pool1d", "max", 1)
_pool_nd("avg_pool1d", "avg", 1)
_pool_nd("max_pool3d", "max", 3)
_pool_nd("avg_pool3d", "avg", 3)


@register_sd_op("upsampling2d")
def _b_upsampling2d(attrs):
    s = attrs.get("scale", 2)
    return lambda x: torch.repeat_interleave(
        torch.repeat_interleave(x, s, dim=-3), s, dim=-2)


@register_sd_op("lrn")
def _b_lrn(attrs):
    from deeplearning4j_tpu_torch.ops.registry import op as _rop
    depth = attrs.get("depth", 5)
    bias = attrs.get("bias", 1.0)
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 0.5)
    # the registry's lrn names the bias k (the JAX op passes bias=, which
    # its lrn lowering refuses); a contiguous x is what the LRN kernels take
    return lambda x: _rop("lrn")(x.contiguous(), depth=depth, k=bias,
                                 alpha=alpha, beta=beta)


@register_sd_op("instance_norm")
def _b_instance_norm(attrs):
    eps = attrs.get("eps", 1e-5)

    def fn(x, gamma, beta):  # [B, ..., C]; normalize over spatial dims
        axes = tuple(range(1, x.dim() - 1))
        m = x.mean(dim=axes, keepdim=True)
        v = x.var(dim=axes, keepdim=True, correction=0)
        return (x - m) * torch.rsqrt(v + eps) * gamma + beta
    return fn


@register_sd_op("group_norm")
def _b_group_norm(attrs):
    groups = attrs["groups"]
    eps = attrs.get("eps", 1e-5)

    def fn(x, gamma, beta):  # [..., C]
        C = x.shape[-1]
        xg = x.reshape(tuple(x.shape[:-1]) + (groups, C // groups))
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        m = xg.mean(dim=axes, keepdim=True)
        v = xg.var(dim=axes, keepdim=True, correction=0)
        xg = (xg - m) * torch.rsqrt(v + eps)
        return xg.reshape(x.shape) * gamma + beta
    return fn


@register_sd_op("rms_norm")
def _b_rms_norm(attrs):
    eps = attrs.get("eps", 1e-6)

    def fn(x, gamma):
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + eps) * gamma
    return fn


@register_sd_op("dot_product_attention")
def _b_sd_attention(attrs):
    from deeplearning4j_tpu_torch.ops.registry import op as _rop
    causal = attrs.get("causal", False)
    scale = attrs.get("scale")
    # through the registry, so the flash kernels (forward AND backward) are
    # reachable from SameDiff graphs; they take a strided view as it is
    return lambda q, k, v: _rop("dot_product_attention")(q, k, v, scale=scale,
                                                         causal=causal)


@register_sd_op("lstm_layer")
def _b_sd_lstm(attrs):
    from deeplearning4j_tpu_torch.ops.registry import op as _rop
    reverse = attrs.get("reverse", False)

    def fn(x, h0, c0, W, R, b):
        out, (hT, cT) = _rop("lstm_layer")(x, h0, c0, W, R, b, reverse=reverse)
        return out, hT, cT
    return fn


@register_sd_op("gru_layer")
def _b_sd_gru(attrs):
    from deeplearning4j_tpu_torch.ops.recurrent import gru_layer as _gru

    def fn(x, h0, W, R, b):
        out, hT = _gru(x, h0, W, R, b)
        return out, hT
    return fn


# --------------------------------------------------------------------------
# losses (SDLoss surface: hinge, KLD, poisson, log_loss, cosine, sparse CE,
# CTC)
# --------------------------------------------------------------------------

def _clog(a, lo=1e-7):
    return torch.log(torch.clamp(a, min=lo))


_simple("hinge_loss", lambda y, p: torch.mean(torch.clamp(1.0 - y * p, min=0.0)))
_simple("squared_hinge_loss",
        lambda y, p: torch.mean(torch.clamp(1.0 - y * p, min=0.0) ** 2))
_simple("kld_loss", lambda y, p: torch.mean(torch.sum(
    y * (_clog(y) - _clog(p)), -1)))
_simple("poisson_loss", lambda y, p: torch.mean(p - y * _clog(p)))
_simple("log_loss", lambda y, p: -torch.mean(
    y * _clog(p) + (1 - y) * _clog(1 - p)))
_simple("cosine_distance_loss", lambda y, p: torch.mean(
    1.0 - _cos_sim(y, p, -1, False)))


@register_sd_op("sparse_softmax_ce")
def _b_sparse_softmax_ce(attrs):
    def fn(labels, logits):
        ll = torch.log_softmax(logits, -1)
        picked = torch.take_along_dim(ll, labels.long()[..., None], dim=-1)
        return -picked.mean()
    return fn


@register_sd_op("ctc_loss")
def _b_ctc_loss(attrs):
    blank = attrs.get("blank_id", 0)

    def fn(logits, logit_lengths, labels, label_lengths):
        # optax.ctc_loss on [B, T, K] logits, averaged over the batch:
        # F.ctc_loss takes [T, B, K] log-probs and lengths; its "mean"
        # divides by the target lengths, so per-sequence losses are meaned
        logp = torch.log_softmax(logits.float(), -1).transpose(0, 1)
        per = F.ctc_loss(logp, labels.long(), logit_lengths.long(),
                         label_lengths.long(), blank=blank, reduction="none")
        return per.mean().to(logits.dtype)
    return fn


# --------------------------------------------------------------------------
# quantization (libnd4j's fake_quant_with_min_max_* family): TF's nudged
# quantize-dequantize with its straight-through gradient, the one copy in
# the port (the TF importer's FakeQuant nodes call it too)
# --------------------------------------------------------------------------

def _fq_nudged(mn, mx, num_bits, narrow):
    """TF-semantics nudged quantization range: [min, max] adjusted so an
    exact integer zero-point exists (FakeQuantWithMinMaxVars kernel)."""
    qmin = 1.0 if narrow else 0.0
    qmax = float((1 << num_bits) - 1)
    scale = (mx - mn) / (qmax - qmin)
    zp_from_min = qmin - mn / scale
    # TF kernels round half UP (floor(v + 0.5)), not round-half-to-even —
    # midpoint inputs must land on the same level
    nudged_zp = torch.where(zp_from_min < qmin, torch.full_like(
        zp_from_min, qmin), torch.where(
            zp_from_min > qmax, torch.full_like(zp_from_min, qmax),
            torch.floor(zp_from_min + 0.5)))
    return (qmin - nudged_zp) * scale, (qmax - nudged_zp) * scale, scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize with TF's straight-through gradient (the JAX
    package's ``fake_quant`` custom_vjp)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, mn, mx, num_bits, narrow_range):
        nmin, nmax, scale = _fq_nudged(mn, mx, num_bits, narrow_range)
        clamped = torch.minimum(torch.maximum(x, nmin), nmax)
        return torch.floor((clamped - nmin) / scale + 0.5) * scale + nmin

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mn, mx, num_bits, narrow_range = inputs
        ctx.save_for_backward(x, mn, mx)
        ctx.num_bits, ctx.narrow_range = num_bits, narrow_range

    @staticmethod
    def backward(ctx, g):
        x, mn, mx = ctx.saved_tensors
        nmin, nmax, _ = _fq_nudged(mn, mx, ctx.num_bits, ctx.narrow_range)
        below, above = x < nmin, x > nmax
        zero = torch.zeros_like(g)
        dx = torch.where(below | above, zero, g)
        axes = (tuple(range(g.dim())) if mn.dim() == 0
                else tuple(range(g.dim() - 1)))
        dmn = torch.where(below, g, zero).sum(axes).reshape(mn.shape)
        dmx = torch.where(above, g, zero).sum(axes).reshape(mx.shape)
        return dx, dmn, dmx, None, None


def fake_quant(x, mn, mx, num_bits=8, narrow_range=False):
    """Quantize-dequantize x to num_bits levels over the nudged [mn, mx]
    range. mn/mx: scalars (per-tensor) or [C] vectors broadcast over the
    LAST axis (per-channel). Gradient is TF's straight-through estimator:
    dx passes inside the nudged range and is 0 outside; d(mn)/d(mx) collect
    the out-of-range cotangents."""
    x = torch.as_tensor(x)
    mn = torch.as_tensor(mn).to(x.device, x.dtype)
    mx = torch.as_tensor(mx).to(x.device, x.dtype)
    return _FakeQuant.apply(x, mn, mx, int(num_bits), bool(narrow_range))


@register_sd_op("fake_quant_with_min_max_vars")
def _b_fq_vars(attrs):
    nb = int(attrs.get("num_bits", 8))
    nr = bool(attrs.get("narrow_range", False))
    return lambda x, mn, mx: fake_quant(x, mn, mx, nb, nr)


# same impl, the per-channel contract is carried by mn/mx being [C]
register_sd_op("fake_quant_with_min_max_vars_per_channel")(_b_fq_vars)


@register_sd_op("fake_quant_with_min_max_args")
def _b_fq_args(attrs):
    nb = int(attrs.get("num_bits", 8))
    nr = bool(attrs.get("narrow_range", False))
    mn = np.float32(attrs.get("min", -6.0))
    mx = np.float32(attrs.get("max", 6.0))
    return lambda x: fake_quant(x, mn, mx, nb, nr)


# --------------------------------------------------------------------------
# namespaces: sd.math / sd.nn / sd.linalg / sd.random / sd.image / sd.loss /
# sd.bitwise. Methods map 1:1 onto table names; tensor args are inputs,
# keyword args become serialized attrs.
# --------------------------------------------------------------------------

class _Namespace:
    """ns.opname(*tensors, **attrs) -> sd._op(opname, ...).

    Multi-output ops get explicit wrappers below so callers receive unpacked
    SDVariable tuples (tuple_get selector nodes)."""

    _ALIASES: dict[str, str] = {}

    def __init__(self, sd: SameDiff, prefix: str = ""):
        self._sd = sd
        self._prefix = prefix

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        opname = self._ALIASES.get(item, self._prefix + item)
        if opname not in _OP_IMPLS:
            opname = self._ALIASES.get(item, item)
        if opname not in _OP_IMPLS:
            raise AttributeError(f"no SameDiff op {item!r}")

        def call(*args, name=None, **attrs):
            return self._sd._op(opname, *args, attrs=attrs, name=name)

        return call


class SDMathNS(_Namespace):
    _ALIASES = {"log_det": "log_matrix_determinant"}


class SDRandomNS(_Namespace):
    """sd.random.normal(shape=[...], seed=...) etc."""

    _ALIASES = {
        "normal": "random_normal", "uniform": "random_uniform",
        "bernoulli": "random_bernoulli", "gamma": "random_gamma",
        "poisson": "random_poisson", "exponential": "random_exponential",
        "truncated_normal": "random_truncated_normal",
        "laplace": "random_laplace", "cauchy": "random_cauchy",
        "gumbel": "random_gumbel", "beta": "random_beta",
        "randint": "random_randint", "categorical": "random_categorical",
        "shuffle": "random_shuffle",
    }

    def __getattr__(self, item):
        call = super().__getattr__(item)

        def salted(*args, name=None, **attrs):
            attrs.setdefault("salt", self._sd._counter + 1)
            return call(*args, name=name, **attrs)

        return salted


class SDImageNS(_Namespace):
    _ALIASES = {"resize": "image_resize"}


class SDLinalgNS(_Namespace):
    _ALIASES = {"inverse": "matrix_inverse", "det": "matrix_determinant",
                "inv": "matrix_inverse", "logdet": "log_matrix_determinant",
                "transpose": "matrix_transpose"}

    def qr(self, a, mode="reduced", name=None):
        return self._sd.multi_op("qr", 2, a, attrs={"mode": mode}, name=name)

    def svd(self, a, full_matrices=False, name=None):
        return self._sd.multi_op("svd", 3, a,
                                 attrs={"full_matrices": full_matrices},
                                 name=name)

    def eigh(self, a, name=None):
        return self._sd.multi_op("eigh", 2, a, name=name)

    def lu(self, a, name=None):
        return self._sd.multi_op("lu", 3, a, name=name)

    def slogdet(self, a, name=None):
        return self._sd.multi_op("slogdet", 2, a, name=name)


class SDNNNS(_Namespace):
    def top_k(self, a, k, name=None):
        return self._sd.multi_op("top_k", 2, a, attrs={"k": k}, name=name)

    def moments(self, a, axis=None, keepdims=False, name=None):
        return self._sd.multi_op("moments", 2, a,
                                 attrs={"axis": _axlist(axis),
                                        "keepdims": keepdims}, name=name)

    def lstm_layer(self, x, h0, c0, W, R, b, reverse=False, name=None):
        return self._sd.multi_op("lstm_layer", 3, x, h0, c0, W, R, b,
                                 attrs={"reverse": reverse}, name=name)

    def gru_layer(self, x, h0, W, R, b, name=None):
        return self._sd.multi_op("gru_layer", 2, x, h0, W, R, b, name=name)


class SDLossNS(_Namespace):
    _ALIASES = {"hinge": "hinge_loss", "squared_hinge": "squared_hinge_loss",
                "kld": "kld_loss", "poisson": "poisson_loss",
                "log": "log_loss", "cosine_distance": "cosine_distance_loss",
                "ctc": "ctc_loss", "mse": "mse", "l1": "l1_loss",
                "l2": "l2_loss", "huber": "huber_loss"}


class SDBitwiseNS(_Namespace):
    _ALIASES = {"and_": "bitwise_and", "or_": "bitwise_or",
                "xor": "bitwise_xor", "not_": "bitwise_not",
                "left_shift": "left_shift", "right_shift": "right_shift",
                "population_count": "population_count"}


def _multi_op(self, opname, n_out, *args, attrs=None, name=None):
    """Op whose impl returns an n-tuple; yields n tuple_get SDVariables."""
    base = self._op(opname, *args, attrs=attrs, name=name)
    return tuple(self._op("tuple_get", base, attrs={"index": i},
                          name=f"{base.name}_out{i}") for i in range(n_out))


# attach the namespaces + helper onto SameDiff (here, so the core module
# stays on graph mechanics; importing this module completes the op surface)
SameDiff.multi_op = _multi_op
SameDiff.math = property(lambda self: SDMathNS(self))
SameDiff.nn = property(lambda self: SDNNNS(self))
SameDiff.linalg = property(lambda self: SDLinalgNS(self))
SameDiff.random = property(lambda self: SDRandomNS(self))
SameDiff.image = property(lambda self: SDImageNS(self))
SameDiff.loss = property(lambda self: SDLossNS(self))
SameDiff.bitwise = property(lambda self: SDBitwiseNS(self))


def op_count() -> int:
    return len(_OP_IMPLS)
