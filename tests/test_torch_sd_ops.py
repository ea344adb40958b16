"""The port's SameDiff op catalog (``deeplearning4j_tpu_torch/autodiff/
sd_ops.py`` and the core table of ``samediff.py``) against the JAX
package's, on the CPU.

- The port's op table holds exactly the JAX ``_OP_IMPLS`` names (307).
- Every deterministic op runs forward on the same seeded inputs in both
  packages, one case an op, within 1e-5 (f32) unless the case states
  otherwise: the decompositions whose signs are not unique (qr, svd, eigh)
  are compared on their reconstructions and absolute values, ``lrn`` on the
  JAX runtime ``lrn`` (the JAX SameDiff op passes ``bias=`` to an op that
  takes ``k=`` and raises).
- Every test of ``tests/test_sd_ops_ext.py`` runs in both packages (the
  live-TensorFlow gradient test is left out: TensorFlow is not installed).
- A named test for each place where PyTorch's default is not jnp's: gelu's
  tanh form, ddof 0, the median, negative-step slices, the dynamic-slice
  clamp, mod's sign, one-hot's type, f64 placeholders, empty segments,
  downsampling resize with every method, ties in sort and top-k, CTC
  against optax.
- The random ops' contract (fixed by seed and salt, the same after
  save/load, another seed draws anew, the distributions' moments).
- The three registry-routed ops against their runtime ops; ``cuda`` cases
  (skipped here) hold them on the card to their kernels' launches.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.autodiff.samediff import (
    SameDiff as JaxSameDiff, _OP_IMPLS as JAX_OPS,
)
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, _OP_IMPLS

TOL = dict(rtol=1e-5, atol=1e-5)
RANDOM_OPS = {n for n in JAX_OPS if n.startswith("random_")} | {"dropout"}


def new(pkg):
    return (SameDiff.create(device="cpu") if pkg == "port"
            else JaxSameDiff.create())


def load(pkg, path):
    return (SameDiff.load(path, device="cpu") if pkg == "port"
            else JaxSameDiff.load(path))


def host(v):
    if isinstance(v, dict):
        return {k: host(a) for k, a in v.items()}
    if isinstance(v, (list, tuple)):
        return [host(a) for a in v]
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def close(a, b, rtol=1e-5, atol=1e-5):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y, rtol, atol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or b.dtype == bool:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=rtol, atol=atol)


def both(build, **tol):
    """``build(sd, pkg)`` -> an SDVariable, evaluated in both packages; the
    port's value within ``tol`` of the JAX package's. Returns the port's
    value as numpy."""
    got = host(build(new("port"), "port").eval())
    want = host(build(new("jax"), "jax").eval())
    close(got, want, **(tol or TOL))
    return got


class TestCatalogSize:
    def test_at_least_250_ops(self):
        assert len(_OP_IMPLS) >= 250

    def test_same_names_as_the_jax_table(self):
        assert set(_OP_IMPLS) == set(JAX_OPS)
        assert len(_OP_IMPLS) == len(JAX_OPS) == 307


# --------------------------------------------------------------------------
# one forward case an op
# --------------------------------------------------------------------------

def _f(rng, *shape, lo=None, hi=None, scale=1.0):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _spd(rng, n=4):
    a = _f(rng, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


UNARY = {  # name -> input range (None: N(0, 1))
    **{n: None for n in (
        "neg", "exp", "expm1", "square", "abs", "sign", "floor", "ceil",
        "round", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "erf",
        "sigmoid", "relu", "relu6", "elu", "gelu", "softplus", "softsign",
        "silu", "hardswish", "identity", "exp2", "cbrt", "rint", "trunc",
        "asinh", "erfc", "sinc", "mish", "selu", "celu", "swish",
        "hardsigmoid", "hardtanh", "logsigmoid", "cube", "step", "gaussian",
        "rectified_tanh", "rational_tanh", "zeros_like", "ones_like",
        "flatten", "ravel", "size", "rank", "shape_of", "matrix_transpose",
        "flip_left_right", "flip_up_down", "rgb_to_grayscale", "l2_loss")},
    **{n: (0.1, 3.0) for n in ("log", "sqrt", "rsqrt", "reciprocal", "log2",
                               "log10", "lgamma", "digamma", "xlogx")},
    "log1p": (-0.5, 3.0), "asin": (-0.9, 0.9), "acos": (-0.9, 0.9),
    "atanh": (-0.9, 0.9), "erfinv": (-0.9, 0.9), "acosh": (1.1, 4.0),
}
BINARY = {  # name -> (first range, second range)
    **{n: (None, None) for n in (
        "add", "sub", "rsub", "mul", "maximum", "minimum", "mmul", "bmm",
        "atan2", "hypot", "logaddexp", "copysign", "squared_difference",
        "prelu", "bias_add")},
    "div": (None, (0.5, 2.0)), "rdiv": ((0.5, 2.0), None),
    "pow": ((0.5, 2.0), None), "mod": (None, (0.5, 2.0)),
    "floordiv": (None, (0.5, 2.0)), "fmod": (None, (0.5, 2.0)),
    "remainder": (None, (-2.0, -0.5)),
}
COMPARE = ("eq", "neq", "gt", "gte", "lt", "lte")
REDUCE = ("sum", "mean", "max", "min", "prod", "std", "var", "norm1",
          "norm2", "normmax", "logsumexp", "count_nonzero", "zero_fraction",
          "sq_norm", "median", "nansum", "nanmean", "nanmax", "nanmin")
REDUCE3 = ("cosine_similarity", "cosine_distance", "euclidean_distance",
           "manhattan_distance", "hamming_distance", "jaccard_distance", "dot")
SEGMENT = ("segment_sum", "segment_max", "segment_min", "segment_prod",
           "segment_mean", "unsorted_segment_sum", "unsorted_segment_max",
           "unsorted_segment_min", "unsorted_segment_prod",
           "unsorted_segment_mean", "unsorted_segment_sqrt_n")
LOSS2 = ("softmax_ce", "sigmoid_ce", "mse", "l1_loss", "huber_loss",
         "hinge_loss", "squared_hinge_loss", "cosine_distance_loss")
POS_LOSS2 = ("kld_loss", "poisson_loss", "log_loss")


def _case(name, rng):
    """((inputs, attrs), compare(got, want)) for one op."""
    op = lambda *arrays, attrs=None: (arrays, attrs or {})  # noqa: E731
    x34 = _f(rng, 3, 4)
    if name in UNARY:
        r = UNARY[name]
        a = _f(rng, 3, 4) if r is None else _f(rng, 3, 4, lo=r[0], hi=r[1])
        if name in ("rgb_to_grayscale",):
            a = _f(rng, 2, 3, 4, 3, lo=0.0, hi=1.0)
        if name in ("flip_left_right", "flip_up_down"):
            a = _f(rng, 2, 3, 4, 2)
        if name in ("round", "rint"):
            a = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.3, 2.7], np.float32)
        return op(a), None
    if name in BINARY:
        ra, rb = BINARY[name]
        shape_b = (3, 4)
        if name in ("mmul",):
            shape_b = (4, 5)
        a = _f(rng, 3, 4) if ra is None else _f(rng, 3, 4, lo=ra[0], hi=ra[1])
        if name == "bmm":
            a, shape_b = _f(rng, 2, 3, 4), (2, 4, 5)
        if name == "bias_add":
            shape_b = (4,)
        b = _f(rng, *shape_b) if rb is None else _f(rng, *shape_b, lo=rb[0],
                                                    hi=rb[1])
        return op(a, b), None
    if name in COMPARE:
        return op(np.round(_f(rng, 4, 4)), np.round(_f(rng, 4, 4))), None
    if name in ("logical_and", "logical_or", "bitwise_and", "bitwise_or",
                "bitwise_xor"):
        if name.startswith("bitwise"):
            return op(rng.integers(-50, 50, 8).astype(np.int32),
                      rng.integers(-50, 50, 8).astype(np.int32)), None
        return op(rng.random(8) > 0.5, rng.random(8) > 0.5), None
    if name == "logical_not":
        return op(rng.random(8) > 0.5), None
    if name == "bitwise_not":
        return op(rng.integers(-50, 50, 8).astype(np.int32)), None
    if name in ("left_shift", "right_shift"):
        return op(rng.integers(-50, 50, 8).astype(np.int32),
                  rng.integers(0, 5, 8).astype(np.int32)), None
    if name == "population_count":
        return op(np.array([0, 1, 7, 255, -1, -2, 2 ** 30], np.int32)), None
    if name == "where":
        return op(rng.random((3, 4)) > 0.5, x34, _f(rng, 3, 4)), None
    if name == "leakyrelu":
        return op(x34, attrs={"alpha": 0.2}), None
    if name in ("softmax", "log_softmax", "cumsum", "cumprod", "argmax",
                "argmin"):
        return op(_f(rng, 3, 4, 5), attrs={"axis": 1}), None
    if name in ("glu",):
        return op(_f(rng, 3, 6), attrs={"axis": -1}), None
    if name == "thresholdedrelu":
        return op(x34 * 2, attrs={"theta": 0.5}), None
    if name in REDUCE:
        a = _f(rng, 3, 4, 5)
        if name.startswith("nan"):
            a[0, 1, 2] = a[2, 3, 0] = np.nan
            a[1, :, 4] = np.nan
        if name == "count_nonzero" or name == "zero_fraction":
            a = np.round(a)
        return op(a, attrs={"axis": [0, 2], "keepdims": name == "median"}), None
    if name in ("any", "all"):
        return op(rng.random((3, 4)) > 0.3, attrs={"axis": [1]}), None
    if name in ("entropy", "shannon_entropy"):
        return op(_f(rng, 3, 4, lo=0.0, hi=1.0), attrs={"axis": [1]}), None
    if name == "percentile":
        return op(_f(rng, 3, 8), attrs={"q": 95.0,
                                        "axis": [1]}), None
    if name == "moments":
        return op(_f(rng, 3, 4, 5), attrs={"axis": [0, 1]}), None
    if name == "standardize":
        return op(_f(rng, 3, 8), attrs={"axis": -1}), None
    if name in REDUCE3:
        a, b = _f(rng, 3, 5), _f(rng, 3, 5)
        if name == "hamming_distance":
            a, b = np.round(a), np.round(b)
        if name == "jaccard_distance":
            a, b = np.abs(a), np.abs(b)
        return op(a, b, attrs={"axis": [1]}), None
    if name == "reshape":
        return op(x34, attrs={"shape": [2, -1]}), None
    if name == "transpose":
        return op(_f(rng, 2, 3, 4), attrs={"axes": [2, 0, 1]}), None
    if name == "squeeze":
        return op(_f(rng, 3, 1, 4, 1), attrs={"axis": [1]}), None
    if name == "expand_dims":
        return op(x34, attrs={"axis": -1}), None
    if name == "tile":
        return op(x34, attrs={"reps": [2, 1, 3]}), None
    if name == "slice":
        return op(_f(rng, 5, 6), attrs={"begin": [1, 4], "size": [3, 4]}), None
    if name == "strided_slice":
        return op(_f(rng, 5, 6), attrs={"begin": [4, None], "end": [0, None],
                                        "strides": [-2, 3]}), None
    if name == "gather":
        return op(x34, np.array([[2, 0], [1, 1]], np.int32),
                  attrs={"axis": 1}), None
    if name in ("scatter_update", "scatter_add", "scatter_sub", "scatter_mul",
                "scatter_div", "scatter_max", "scatter_min"):
        upd = _f(rng, 2, 4, lo=0.5, hi=2.0)
        return op(_f(rng, 5, 4, lo=0.5, hi=2.0),
                  np.array([3, 1], np.int32), upd), None
    if name == "one_hot":
        return op(np.array([0, 3, 1, 5], np.int32), attrs={"depth": 4}), None
    if name == "cast":
        return op(x34 * 3, attrs={"dtype": "int32"}), None
    if name == "clip_by_value":
        return op(x34, attrs={"min": -0.5, "max": 0.3}), None
    if name in ("concat", "stack"):
        return op(x34, _f(rng, 3, 4), attrs={"axis": 0}), None
    if name == "unstack":
        return op(_f(rng, 3, 4), attrs={"axis": 1, "index": 2}), None
    if name == "split":
        return op(_f(rng, 6, 4), attrs={"num": 3, "axis": 0, "index": 1}), None
    if name == "conv2d":
        return op(_f(rng, 2, 7, 7, 3), _f(rng, 3, 3, 3, 4),
                  attrs={"strides": [2, 2], "padding": "same"}), None
    if name in ("max_pool2d", "avg_pool2d"):
        return op(_f(rng, 2, 7, 7, 3), attrs={"kernel": [3, 3],
                                              "strides": [2, 2],
                                              "padding": "same"}), None
    if name == "layer_norm":
        return op(_f(rng, 2, 3, 8), _f(rng, 8), _f(rng, 8)), None
    if name == "batch_norm":
        return op(_f(rng, 4, 6), _f(rng, 6), _f(rng, 6, lo=0.5, hi=2.0),
                  _f(rng, 6), _f(rng, 6)), None
    if name == "embedding_lookup":
        return op(_f(rng, 7, 3), np.array([[1, 6], [0, 0]], np.int32)), None
    if name in LOSS2:
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 3)]
        if name in ("hinge_loss", "squared_hinge_loss"):
            y = 2 * y - 1
        if name in ("mse", "l1_loss", "huber_loss", "cosine_distance_loss"):
            y = _f(rng, 3, 4)
        return op(y, _f(rng, 3, 4)), None
    if name in POS_LOSS2:
        y = _f(rng, 3, 4, lo=0.05, hi=0.95)
        return op(y, _f(rng, 3, 4, lo=0.05, hi=0.95)), None
    if name == "tuple_get":
        return op((x34, _f(rng, 2)), attrs={"index": 1}), None
    if name == "pad":
        return op(x34, attrs={"paddings": [[1, 2], [0, 3]],
                              "mode": "reflect"}), None
    if name == "trace" or name == "diag_part":
        return op(_f(rng, 2, 4, 4)), None
    if name == "matrix_diag":
        return op(x34), None
    if name == "outer":
        return op(_f(rng, 3), _f(rng, 4)), None
    if name == "kron":
        return op(_f(rng, 2, 2), _f(rng, 2, 3)), None
    if name == "cross":
        return op(_f(rng, 4, 3), _f(rng, 4, 3)), None
    if name == "invert_permutation":
        return op(rng.permutation(6).astype(np.int32)), None
    if name == "roll":
        return op(_f(rng, 3, 4, 5), attrs={"shift": [1, -2],
                                           "axis": [0, 2]}), None
    if name == "reverse":
        return op(_f(rng, 3, 4, 5), attrs={"axis": [0, 2]}), None
    if name == "repeat":
        return op(x34, attrs={"repeats": 2, "axis": 1}), None
    if name == "broadcast_to":
        return op(_f(rng, 1, 4), attrs={"shape": [3, 4]}), None
    if name == "moveaxis":
        return op(_f(rng, 2, 3, 4), attrs={"source": 0,
                                           "destination": -1}), None
    if name == "swapaxes":
        return op(_f(rng, 2, 3, 4), attrs={"axis1": 0, "axis2": 2}), None
    if name == "full_like":
        return op(x34, attrs={"value": 2.5}), None
    if name == "linspace":
        return op(attrs={"start": -1.0, "stop": 2.0, "num": 7}), None
    if name == "range":
        return op(attrs={"start": 1, "stop": 11, "step": 3,
                         "dtype": "int32"}), None
    if name == "eye":
        return op(attrs={"n": 3, "m": 5, "k": 1}), None
    if name in ("tril", "triu"):
        return op(_f(rng, 4, 5), attrs={"k": -1}), None
    if name == "diag":
        return op(_f(rng, 4, 4), attrs={"k": 1}), None
    if name in ("space_to_depth", "depth_to_space"):
        c = 2 if name == "space_to_depth" else 8
        return op(_f(rng, 1, 4, 4, c), attrs={"block_size": 2}), None
    if name == "reverse_sequence":
        return op(_f(rng, 2, 5, 3), np.array([3, 5], np.int32)), None
    if name == "take_along_axis":
        return op(x34, rng.integers(0, 4, (3, 2)).astype(np.int32),
                  attrs={"axis": 1}), None
    if name == "gather_nd":
        return op(_f(rng, 3, 4, 2), np.array([[0, 1], [2, 3]], np.int32)), None
    if name == "scatter_nd":
        return op(np.array([[0], [2], [0]], np.int32), _f(rng, 3, 2),
                  attrs={"shape": [4, 2]}), None
    if name in SEGMENT:
        return op(_f(rng, 5, 2, lo=0.5, hi=2.0),
                  np.array([0, 0, 2, 2, 3], np.int32),
                  attrs={"num_segments": 5}), None
    if name in ("sort", "argsort"):
        a = np.round(_f(rng, 3, 8))   # ties
        return op(a, attrs={"descending": True}), None
    if name == "top_k":
        return op(np.round(_f(rng, 3, 8)), attrs={"k": 3}), None
    if name == "in_top_k":
        return op(_f(rng, 4, 5), np.array([0, 4, 2, 1], np.int32),
                  attrs={"k": 2}), None
    if name == "searchsorted":
        return op(np.sort(_f(rng, 8)), _f(rng, 5), attrs={"side": "right"}), None
    if name in ("cholesky", "matrix_inverse", "pinv", "matrix_determinant",
                "expm", "slogdet", "log_matrix_determinant", "matrix_rank"):
        a = _spd(rng) / (4.0 if name == "expm" else 1.0)
        return op(a), None
    if name == "solve" or name == "lstsq":
        return op(_spd(rng), _f(rng, 4, 2)), None
    if name == "triangular_solve":
        a = np.tril(_spd(rng))
        return op(a, _f(rng, 4, 2), attrs={"lower": True, "trans": 1}), None
    if name == "matrix_power":
        return op(_spd(rng) / 4, attrs={"n": 3}), None
    if name == "tensordot":
        return op(_f(rng, 2, 3, 4), _f(rng, 4, 3, 5),
                  attrs={"axes": [[1, 2], [1, 0]]}), None
    if name == "einsum":
        return op(_f(rng, 2, 3, 4), _f(rng, 4, 5),
                  attrs={"equation": "ijk,kl->ilj"}), None
    if name == "lu":
        return op(_f(rng, 4, 4)), None
    if name == "qr":
        def cmp_qr(got, want):
            for g in (got, want):
                g.append(g[0] @ g[1])
            close([np.abs(got[1]), got[2]], [np.abs(want[1]), want[2]])
        return op(_f(rng, 5, 3)), cmp_qr
    if name == "svd":
        def cmp_svd(got, want):
            close([np.abs(got[0]), got[1], np.abs(got[2]),
                   (got[0] * got[1]) @ got[2]],
                  [np.abs(want[0]), want[1], np.abs(want[2]),
                   (want[0] * want[1]) @ want[2]])
        return op(_f(rng, 5, 3)), cmp_svd
    if name == "eigh":
        def cmp_eigh(got, want):
            close([got[0], np.abs(got[1])], [want[0], np.abs(want[1])])
        return op(_spd(rng)), cmp_eigh
    if name in ("image_resize", "resize_bilinear", "resize_nearest"):
        return op(_f(rng, 2, 6, 8, 3), attrs={"height": 4, "width": 11}), None
    if name == "rot90":
        return op(_f(rng, 2, 3, 4, 2), attrs={"k": 3}), None
    if name == "adjust_contrast":
        return op(_f(rng, 2, 3, 4, 3), attrs={"factor": 1.7}), None
    if name == "adjust_brightness":
        return op(_f(rng, 2, 3, 4, 3), attrs={"delta": -0.3}), None
    if name in ("rgb_to_hsv", "hsv_to_rgb"):
        return op(_f(rng, 2, 5, 3, lo=0.0, hi=1.0)), None
    if name == "central_crop":
        return op(_f(rng, 2, 7, 9, 3), attrs={"fraction": 0.6}), None
    if name == "extract_image_patches":
        return op(_f(rng, 2, 7, 6, 3), attrs={"kernel": [3, 2],
                                              "strides": [2, 2],
                                              "padding": "same"}), None
    if name == "isnan" or name == "isinf" or name == "isfinite":
        return op(np.array([0.0, np.nan, np.inf, -np.inf, 1.5],
                           np.float32)), None
    if name == "linear" or name == "relu_layer":
        return op(x34, _f(rng, 4, 5), _f(rng, 5)), None
    if name == "conv1d":
        return op(_f(rng, 2, 9, 3), _f(rng, 3, 3, 4),
                  attrs={"stride": 2, "padding": "same"}), None
    if name == "conv3d":
        return op(_f(rng, 2, 5, 5, 5, 2), _f(rng, 2, 2, 2, 2, 3),
                  attrs={"strides": [2, 1, 1], "padding": "same"}), None
    if name == "deconv2d":
        return op(_f(rng, 2, 4, 4, 3), _f(rng, 3, 3, 3, 2),
                  attrs={"strides": [2, 2], "padding": "same"}), None
    if name == "depthwise_conv2d":
        return op(_f(rng, 2, 6, 6, 3), _f(rng, 3, 3, 3, 2),
                  attrs={"strides": [1, 1], "padding": "valid"}), None
    if name == "separable_conv2d":
        return op(_f(rng, 2, 6, 6, 3), _f(rng, 3, 3, 3, 2),
                  _f(rng, 1, 1, 6, 4), attrs={"strides": [2, 2],
                                              "padding": "same"}), None
    if name in ("max_pool1d", "avg_pool1d"):
        return op(_f(rng, 2, 9, 3), attrs={"kernel": [3], "strides": [2],
                                           "padding": "same"}), None
    if name in ("max_pool3d", "avg_pool3d"):
        return op(_f(rng, 2, 5, 5, 4, 2), attrs={"kernel": [2, 3, 2],
                                                 "strides": [2, 2, 1],
                                                 "padding": "same"}), None
    if name == "upsampling2d":
        return op(_f(rng, 2, 3, 4, 2), attrs={"scale": 3}), None
    if name == "lrn":
        x = _f(rng, 2, 3, 3, 8)
        return op(x, attrs={"depth": 5, "bias": 2.0, "alpha": 1e-2,
                            "beta": 0.75}), ("lrn", x)
    if name == "instance_norm":
        return op(_f(rng, 2, 4, 4, 3), _f(rng, 3), _f(rng, 3)), None
    if name == "group_norm":
        return op(_f(rng, 2, 4, 6), _f(rng, 6), _f(rng, 6),
                  attrs={"groups": 3}), None
    if name == "rms_norm":
        return op(_f(rng, 2, 4, 6), _f(rng, 6)), None
    if name == "dot_product_attention":
        return op(_f(rng, 2, 3, 5, 4), _f(rng, 2, 3, 5, 4), _f(rng, 2, 3, 5, 4),
                  attrs={"causal": True}), None
    if name == "lstm_layer":
        return op(_f(rng, 2, 5, 3), _f(rng, 2, 4), _f(rng, 2, 4),
                  _f(rng, 3, 16, scale=0.3), _f(rng, 4, 16, scale=0.3),
                  _f(rng, 16), attrs={"reverse": True}), None
    if name == "gru_layer":
        return op(_f(rng, 2, 5, 3), _f(rng, 2, 4), _f(rng, 3, 12, scale=0.3),
                  _f(rng, 4, 12, scale=0.3), _f(rng, 12)), None
    if name == "sparse_softmax_ce":
        return op(np.array([0, 3, 1], np.int32), _f(rng, 3, 4)), None
    if name == "ctc_loss":
        return op(_f(rng, 2, 8, 5), np.array([8, 6], np.int32),
                  np.array([[1, 2, 3], [2, 4, 0]], np.int32),
                  np.array([3, 2], np.int32)), None
    if name in ("fake_quant_with_min_max_vars",
                "fake_quant_with_min_max_vars_per_channel"):
        if name.endswith("channel"):
            return op(_f(rng, 4, 3, scale=3), np.array([-1, -2, -3], np.float32),
                      np.array([1, 2, 2.5], np.float32),
                      attrs={"num_bits": 6}), None
        return op(_f(rng, 4, 3, scale=3), np.float32(-2.0), np.float32(1.5),
                  attrs={"num_bits": 8, "narrow_range": True}), None
    if name == "fake_quant_with_min_max_args":
        return op(_f(rng, 4, 3, scale=3), attrs={"min": -2.5, "max": 3.0}), None
    raise KeyError(name)


DETERMINISTIC = sorted(n for n in JAX_OPS if n not in RANDOM_OPS)


def _inputs(arrays, to):
    return [tuple(to(b) for b in a) if isinstance(a, tuple) else to(a)
            for a in arrays]


def _run(pkg, name, arrays, attrs):
    """One node of op ``name`` over constants, evaluated (a tuple input,
    tuple_get's, goes to the table's callable directly)."""
    if any(isinstance(a, tuple) for a in arrays):
        table, to = ((_OP_IMPLS, lambda a: torch.as_tensor(np.asarray(a)))
                     if pkg == "port" else (JAX_OPS, jnp.asarray))
        return host(table[name](attrs)(*_inputs(arrays, to)))
    sd = new(pkg)
    return host(sd._op(name, *(sd.constant(a) for a in arrays),
                       attrs=attrs).eval())


def _op_case(name):
    """The inputs, attributes and comparison of ``name``'s case, from a
    seed of its own."""
    return _case(name, np.random.default_rng(sorted(JAX_OPS).index(name)))


@functools.lru_cache(maxsize=None)
def _jax_values():
    """Every deterministic op's JAX value, each op one node over its own
    constants in one JAX graph: one jit compile for all the cases (one a
    case took twice as long). Tuple inputs (tuple_get's) and the lrn case
    are left to their tests."""
    sd = new("jax")
    names = {}
    for name in DETERMINISTIC:
        (arrays, attrs), cmp = _op_case(name)
        if not isinstance(cmp, tuple) and \
                not any(isinstance(a, tuple) for a in arrays):
            names[name] = sd._op(name, *(sd.constant(a) for a in arrays),
                                 attrs=attrs).name
    return dict(zip(names, (host(v) for v in sd.output(*names.values()))))


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_op_forward_matches_jax(name):
    (arrays, attrs), cmp = _op_case(name)
    got = _run("port", name, arrays, attrs)
    if isinstance(cmp, tuple):
        # the JAX SameDiff lrn cannot run (bias= to an op that takes k=);
        # hold the port to the JAX runtime lrn with k = bias
        from deeplearning4j_tpu.ops.convolution import lrn as jax_lrn

        close(got, np.asarray(jax_lrn(jnp.asarray(cmp[1]), depth=5, k=2.0,
                                      alpha=1e-2, beta=0.75)))
        return
    want = _jax_values().get(name)
    if want is None:
        want = _run("jax", name, arrays, attrs)
    if cmp is None:
        close(got, want)
    else:
        cmp(got, want)


# --------------------------------------------------------------------------
# tests/test_sd_ops_ext.py in both packages
# --------------------------------------------------------------------------

def _sd_with(pkg, x):
    sd = new(pkg)
    return sd, sd.var("x", x)


def _numgrad(f, x, eps=1e-3):
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp = x.copy()
        xp[i] += eps
        xm = x.copy()
        xm[i] -= eps
        g[i] = (f(xp) - f(xm)) / (2 * eps)
        it.iternext()
    return g


class TestForwardParity:
    def test_elementwise_family(self, rng):
        x = rng.normal(size=(3, 4)).astype(np.float32)
        cases = {
            "atan2": (lambda sd, v: sd.math.atan2(v, v * 0.5 + 2.0),
                      np.arctan2(x, x * 0.5 + 2.0)),
            "mish": (lambda sd, v: sd.math.mish(v),
                     x * np.tanh(np.log1p(np.exp(x)))),
            "cube": (lambda sd, v: sd.math.cube(v), x ** 3),
            "step": (lambda sd, v: sd.math.step(v), (x > 0).astype(np.float32)),
            "logsumexp": (lambda sd, v: sd.math.logsumexp(v, axis=[1]),
                          np.log(np.exp(x).sum(1))),
        }
        for name, (build, want) in cases.items():
            got = both(lambda sd, pkg: build(sd, sd.var("x", x)))
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5,
                                       err_msg=name)

    def test_rational_tanh_bounded_and_odd(self, rng):
        x = rng.normal(size=(64,)).astype(np.float32) * 3
        y = both(lambda sd, pkg: sd.math.rational_tanh(sd.var("x", x)))
        assert (np.abs(y) <= 1.0 + 1e-6).all()
        y2 = both(lambda sd, pkg: sd.math.rational_tanh(sd.var("x", -x)))
        np.testing.assert_allclose(y2, -y, atol=1e-6)

    def test_linalg_family(self, rng):
        a = rng.normal(size=(4, 4)).astype(np.float32)
        spd = a @ a.T + 4 * np.eye(4, dtype=np.float32)
        b = rng.normal(size=(4, 2)).astype(np.float32)

        def run(pkg):
            sd = new(pkg)
            vs = sd.var("s", spd)
            q, r = sd.linalg.qr(vs)
            u, s, vt = sd.linalg.svd(vs)
            w, _ = sd.linalg.eigh(vs)
            return host([sd.math.cholesky(vs).eval(),
                         sd.linalg.inverse(vs).eval(),
                         sd.linalg.det(vs).eval(), q.eval(), r.eval(),
                         u.eval(), s.eval(), vt.eval(), w.eval(),
                         sd.math.solve(vs, sd.constant(b)).eval()])

        got, want = run("port"), run("jax")
        chol, inv, det, q, r, u, s, vt, w, sol = got
        np.testing.assert_allclose(chol @ chol.T, spd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(inv @ spd, np.eye(4), atol=1e-4)
        np.testing.assert_allclose(det, np.linalg.det(spd), rtol=1e-4)
        np.testing.assert_allclose(q @ r, spd, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(u * s @ vt, spd, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(np.sort(w), np.sort(np.linalg.eigvalsh(spd)),
                                   rtol=1e-4)
        np.testing.assert_allclose(spd @ sol, b, atol=1e-3)
        # unique parts against the JAX package
        close([chol, inv, s, w, sol, np.abs(r)],
              [want[0], want[1], want[6], want[8], want[9], np.abs(want[4])],
              rtol=1e-4, atol=1e-5)
        close(det, want[2], rtol=1e-5, atol=1e-3)

    def test_einsum_and_tensordot(self, rng):
        a = rng.normal(size=(2, 3, 4)).astype(np.float32)
        b = rng.normal(size=(4, 5)).astype(np.float32)
        got = both(lambda sd, pkg: sd._op("einsum", sd.var("a", a),
                                          sd.var("b", b),
                                          attrs={"equation": "ijk,kl->ijl"}))
        np.testing.assert_allclose(got, np.einsum("ijk,kl->ijl", a, b),
                                   rtol=2e-4, atol=1e-5)
        got2 = both(lambda sd, pkg: sd._op("tensordot", sd.var("a", a),
                                           sd.var("b", b),
                                           attrs={"axes": [[2], [0]]}))
        np.testing.assert_allclose(got2, np.tensordot(a, b, axes=([2], [0])),
                                   rtol=2e-4, atol=1e-5)

    def test_segment_family(self):
        data = np.array([[1., 2.], [3., 4.], [5., 6.], [7., 8.]], np.float32)
        ids = np.array([0, 0, 1, 2])

        def seg(name):
            return both(lambda sd, pkg: sd._op(
                name, sd.var("d", data), sd.constant(ids),
                attrs={"num_segments": 3}))

        np.testing.assert_allclose(seg("segment_sum"), [[4, 6], [5, 6], [7, 8]])
        np.testing.assert_allclose(seg("segment_mean"),
                                   [[2, 3], [5, 6], [7, 8]])
        np.testing.assert_allclose(seg("unsorted_segment_max"),
                                   [[3, 4], [5, 6], [7, 8]])

    def test_scatter_family(self):
        got = both(lambda sd, pkg: sd._op(
            "scatter_mul", sd.var("b", np.ones((4, 2), np.float32)),
            sd.constant(np.array([1, 3])),
            sd.constant(np.array([[2., 2.], [3., 3.]], np.float32))))
        np.testing.assert_allclose(got, [[1, 1], [2, 2], [1, 1], [3, 3]])
        got2 = both(lambda sd, pkg: sd._op(
            "scatter_nd", sd.constant(np.array([[0], [2]])),
            sd.constant(np.array([[5., 5.], [7., 7.]], np.float32)),
            attrs={"shape": [3, 2]}))
        np.testing.assert_allclose(got2, [[5, 5], [0, 0], [7, 7]])

    def test_sort_topk_search(self, rng):
        x = rng.normal(size=(3, 8)).astype(np.float32)
        got = both(lambda sd, pkg: sd._op("sort", sd.var("x", x),
                                          attrs={"descending": True}))
        np.testing.assert_allclose(got, -np.sort(-x, axis=-1))
        vals = both(lambda sd, pkg: sd.nn.top_k(sd.var("x", x), 3)[0])
        np.testing.assert_allclose(vals, -np.sort(-x, axis=-1)[:, :3])
        preds = np.asarray([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], np.float32)
        r = both(lambda sd, pkg: sd._op("in_top_k", sd.constant(preds),
                                        sd.constant(np.array([1, 2])),
                                        attrs={"k": 1}))
        np.testing.assert_array_equal(r, [True, False])

    def test_image_family(self, rng):
        img = rng.uniform(size=(2, 4, 6, 3)).astype(np.float32)
        rz = both(lambda sd, pkg: sd.image.resize(
            sd.var("img", img), height=8, width=12, method="nearest"))
        assert rz.shape == (2, 8, 12, 3)
        np.testing.assert_allclose(rz[:, ::2, ::2], img, atol=1e-6)
        flipped = both(lambda sd, pkg: sd.image.flip_left_right(
            sd.var("img", img)))
        np.testing.assert_allclose(flipped, img[:, :, ::-1])
        gray = both(lambda sd, pkg: sd.image.rgb_to_grayscale(
            sd.var("img", img)))
        assert gray.shape == (2, 4, 6, 1)
        back = both(lambda sd, pkg: sd.image.hsv_to_rgb(
            sd.image.rgb_to_hsv(sd.var("img", img))))
        np.testing.assert_allclose(back, img, atol=1e-5)
        patches = both(lambda sd, pkg: sd._op(
            "extract_image_patches", sd.var("img", img),
            attrs={"kernel": [2, 2]}))
        assert patches.shape == (2, 2, 3, 12)

    def test_random_family_statistics(self):
        sd = new("port")
        arr = host(sd.random.normal(shape=[2000], seed=1, mean=2.0,
                                    stddev=0.5).eval())
        assert abs(arr.mean() - 2.0) < 0.1 and abs(arr.std() - 0.5) < 0.05
        au = host(sd.random.uniform(shape=[1000], seed=2, min=-1.0,
                                    max=1.0).eval())
        assert au.min() >= -1 and au.max() <= 1 and abs(au.mean()) < 0.15
        brn = host(sd.random.bernoulli(shape=[1000], seed=3, p=0.3).eval())
        assert abs(brn.mean() - 0.3) < 0.1
        # distinct nodes sample independently (salt differs)
        a = host(sd.random.normal(shape=[10], seed=7).eval())
        b = host(sd.random.normal(shape=[10], seed=7).eval())
        assert not np.allclose(a, b)

    def test_bitwise_family(self):
        a = np.array([0b1100, 0b1010], np.int32)
        b = np.array([0b1010, 0b0110], np.int32)
        got = both(lambda sd, pkg: sd.bitwise.and_(sd.constant(a),
                                                   sd.constant(b)))
        np.testing.assert_array_equal(got, [0b1000, 0b0010])
        got = both(lambda sd, pkg: sd.bitwise.xor(sd.constant(a),
                                                  sd.constant(b)))
        np.testing.assert_array_equal(got, [0b0110, 0b1100])
        got = both(lambda sd, pkg: sd.bitwise.population_count(
            sd.constant(a)))
        np.testing.assert_array_equal(got, [2, 2])

    def test_distance_family(self, rng):
        a = rng.normal(size=(3, 5)).astype(np.float32)
        b = rng.normal(size=(3, 5)).astype(np.float32)
        cos = both(lambda sd, pkg: sd._op("cosine_similarity", sd.var("a", a),
                                          sd.var("b", b), attrs={"axis": [1]}))
        want = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                 * np.linalg.norm(b, axis=1))
        np.testing.assert_allclose(cos, want, rtol=1e-4)
        eu = both(lambda sd, pkg: sd._op("euclidean_distance", sd.var("a", a),
                                         sd.var("b", b), attrs={"axis": [1]}))
        np.testing.assert_allclose(eu, np.linalg.norm(a - b, axis=1),
                                   rtol=1e-4)

    def test_shape_family(self, rng):
        x = rng.normal(size=(2, 3, 4)).astype(np.float32)
        got = both(lambda sd, pkg: sd._op("roll", sd.var("x", x),
                                          attrs={"shift": 1, "axis": [1]}))
        np.testing.assert_allclose(got, np.roll(x, 1, axis=1))
        got = both(lambda sd, pkg: sd._op("reverse", sd.var("x", x),
                                          attrs={"axis": [2]}))
        np.testing.assert_allclose(got, x[:, :, ::-1])
        img = rng.normal(size=(1, 4, 4, 2)).astype(np.float32)
        s2d = both(lambda sd, pkg: sd._op("space_to_depth", sd.var("img", img),
                                          attrs={"block_size": 2}))
        assert s2d.shape == (1, 2, 2, 8)
        revseq = both(lambda sd, pkg: sd._op(
            "reverse_sequence",
            sd.var("seq", np.arange(8, dtype=np.float32).reshape(2, 4)),
            sd.constant(np.array([2, 4]))))
        np.testing.assert_allclose(revseq, [[1, 0, 2, 3], [7, 6, 5, 4]])

    def test_loss_family(self, rng):
        y = np.array([1., -1., 1.], np.float32)
        p = np.array([0.8, 0.3, -0.2], np.float32)
        hinge = both(lambda sd, pkg: sd.loss.hinge(sd.constant(y),
                                                   sd.constant(p)))
        np.testing.assert_allclose(hinge, np.maximum(0, 1 - y * p).mean(),
                                   rtol=1e-5)
        z = rng.normal(size=(2, 3)).astype(np.float32)
        ce = both(lambda sd, pkg: sd._op("sparse_softmax_ce",
                                         sd.constant(np.array([0, 2])),
                                         sd.var("z", z)))
        assert np.isfinite(ce) and ce > 0

    def test_ctc_loss_runs_and_differentiates(self, rng):
        logits = rng.normal(size=(2, 8, 5)).astype(np.float32)

        def run(pkg):
            sd = new(pkg)
            loss = sd._op("ctc_loss", sd.var("z", logits),
                          sd.constant(np.array([8, 6])),
                          sd.constant(np.array([[1, 2, 3], [2, 4, 0]])),
                          sd.constant(np.array([3, 2])))
            return host([loss.eval(), sd.grad(loss, wrt=["z"])["z"]])

        (val, g), want = run("port"), run("jax")
        assert np.isfinite(val) and val > 0 and np.isfinite(g).all()
        close([val, g], want)

    def test_nn_extras(self, rng):
        x = rng.normal(size=(1, 5, 5, 2)).astype(np.float32)
        w = rng.normal(size=(3, 3, 2, 1)).astype(np.float32)
        got = both(lambda sd, pkg: sd._op("depthwise_conv2d", sd.var("x", x),
                                          sd.var("w", w)))
        assert got.shape == (1, 5, 5, 2)
        h = rng.normal(size=(2, 4, 8)).astype(np.float32)
        ones, zeros = np.ones(8, np.float32), np.zeros(8, np.float32)
        gn = both(lambda sd, pkg: sd._op(
            "group_norm", sd.var("h", h), sd.constant(ones),
            sd.constant(zeros), attrs={"groups": 2}))
        assert np.abs(gn.reshape(2, 4, 2, 4).mean(axis=(1, 3))).max() < 1e-4
        rms = both(lambda sd, pkg: sd._op("rms_norm", sd.var("h", h),
                                          sd.constant(ones)))
        ms = (rms ** 2).mean(-1)
        np.testing.assert_allclose(ms, np.ones_like(ms), rtol=1e-3)

    def test_sd_lstm_layer_matches_runtime_op(self, rng):
        from deeplearning4j_tpu.ops.recurrent import lstm_layer as jax_lstm
        from deeplearning4j_tpu_torch.ops.recurrent import lstm_layer

        B, T, F, H = 2, 4, 3, 5
        x = rng.normal(size=(B, T, F)).astype(np.float32)
        W = rng.normal(size=(F, 4 * H)).astype(np.float32) * 0.1
        R = rng.normal(size=(H, 4 * H)).astype(np.float32) * 0.1
        b = np.zeros(4 * H, np.float32)
        h0 = c0 = np.zeros((B, H), np.float32)

        def run(pkg):
            sd = new(pkg)
            out, hT, _ = sd.nn.lstm_layer(sd.var("x", x), sd.constant(h0),
                                          sd.constant(c0), sd.var("W", W),
                                          sd.var("R", R), sd.var("b", b))
            return host([out.eval(), hT.eval()])

        got, want = run("port"), run("jax")
        close(got, want)
        rt, (rh, _) = lstm_layer(*(torch.from_numpy(a)
                                   for a in (x, h0, c0, W, R, b)))
        close(got, host([rt, rh]))
        jt, (jh, _) = jax_lstm(*(jnp.asarray(a) for a in (x, h0, c0, W, R, b)))
        close(got, host([jt, jh]), rtol=2e-4)


class TestGradients:
    """Numeric against autograd over the differentiable additions (the JAX
    file's f32 check at its tolerance), and the port's gradient against the
    JAX package's within 1e-5."""

    @pytest.mark.parametrize("opname,attrs,shape", [
        ("atan2_pair", None, (3, 3)),
        ("mish", {}, (3, 3)),
        ("selu", {}, (3, 3)),
        ("logsigmoid", {}, (3, 3)),
        ("cube", {}, (3, 3)),
        ("rational_tanh", {}, (3, 3)),
        ("logsumexp", {"axis": [1]}, (3, 4)),
        ("entropy_pos", None, (3, 4)),
        ("standardize", {"axis": -1}, (3, 8)),
        ("matrix_inverse_spd", None, (3, 3)),
        ("cholesky_spd", None, (3, 3)),
        ("sort", {"axis": -1}, (2, 5)),
        ("image_resize", {"height": 6, "width": 6}, (1, 3, 3, 2)),
        ("rms_norm_g", None, (2, 6)),
    ])
    def test_numeric_gradcheck(self, rng, opname, attrs, shape):
        x = rng.normal(size=shape).astype(np.float32)

        def build(sd, v):
            if opname == "atan2_pair":
                return sd.math.atan2(v, v * 0.3 + 2.0)
            if opname == "entropy_pos":
                return sd._op("entropy", sd.softmax(v, axis=-1),
                              attrs={"axis": [1]})
            if opname in ("matrix_inverse_spd", "cholesky_spd"):
                s = sd.mmul(v, sd._op("matrix_transpose", v)) + \
                    sd.constant(4 * np.eye(shape[0], dtype=np.float32))
                return (sd.linalg.inverse(s) if opname.startswith("matrix")
                        else sd.math.cholesky(s))
            if opname == "rms_norm_g":
                return sd._op("rms_norm", v,
                              sd.constant(np.ones(shape[-1], np.float32)))
            return sd._op(opname, v, attrs=attrs or {})

        def grad(pkg, xv):
            sd, v = _sd_with(pkg, xv)
            out = build(sd, v)
            return host(sd.grad((out * out).sum(), wrt=["x"])["x"])

        sd_np, v_np = _sd_with("port", x)
        loss_node = (lambda o: (o * o).sum())(build(sd_np, v_np))

        def loss_np(xv):
            sd_np.set_variables({"x": xv.astype(np.float32)})
            return float(host(loss_node.eval()))

        g = grad("port", x)
        num = _numgrad(loss_np, x.astype(np.float64).astype(np.float32))
        np.testing.assert_allclose(g, num, rtol=2e-2, atol=2e-2,
                                   err_msg=opname)
        close(g, grad("jax", x), rtol=1e-4, atol=1e-5)

    def test_segment_sum_grad(self, rng):
        x = rng.normal(size=(4, 2)).astype(np.float32)
        ids = np.array([0, 1, 0, 1])

        def grad(pkg):
            sd, v = _sd_with(pkg, x)
            seg = sd._op("segment_sum", v, sd.constant(ids),
                         attrs={"num_segments": 2})
            return host(sd.grad((seg * seg).sum(), wrt=["x"])["x"])

        def f(xv):
            s = np.zeros((2, 2), np.float32)
            for i, sid in enumerate(ids):
                s[sid] += xv[i]
            return float((s * s).sum())

        g = grad("port")
        np.testing.assert_allclose(g, _numgrad(f, x), rtol=1e-2, atol=1e-2)
        close(g, grad("jax"))


class TestSerialization:
    def test_roundtrip_mixed_graph(self, tmp_path, rng):
        x = rng.normal(size=(2, 3, 4)).astype(np.float32)
        w = rng.normal(size=(4, 5)).astype(np.float32)
        for pkg in ("port", "jax"):
            sd = new(pkg)
            v = sd.var("x", x)
            r = sd.random.normal(shape=[2, 3, 4], seed=11)
            y = sd.math.mish(v) + r * 0.1
            z = sd._op("einsum", y, sd.var("w", w),
                       attrs={"equation": "btk,kl->btl"})
            out = sd._op("logsumexp", z, attrs={"axis": [2]}, name="final")
            want = host(out.eval())
            path = str(tmp_path / f"g_{pkg}.sdz")
            sd.save(path)
            # a random op replays its draw in the package that drew it
            # (threefry is not torch's generator)
            got = host(load(pkg, path).output("final"))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_roundtrip_multi_output(self, tmp_path, rng):
        a = rng.normal(size=(4, 4)).astype(np.float32)
        for pkg in ("port", "jax"):
            sd = new(pkg)
            q, r = sd.linalg.qr(sd.var("a", a))
            want = host(sd.mmul(q, r, name="prod").eval())
            path = str(tmp_path / f"qr_{pkg}.sdz")
            sd.save(path)
            for other in ("port", "jax"):
                got = host(load(other, path).output("prod"))
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestFakeQuant:
    @staticmethod
    def _fq(pkg):
        if pkg == "port":
            from deeplearning4j_tpu_torch.autodiff.sd_ops import fake_quant

            return lambda x, mn, mx, nb, nr: fake_quant(
                torch.as_tensor(x), torch.as_tensor(mn), torch.as_tensor(mx),
                nb, nr)
        from deeplearning4j_tpu.autodiff.sd_ops import fake_quant

        return lambda x, mn, mx, nb, nr: fake_quant(
            jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx), nb, nr)

    def test_forward_nudging_and_levels(self, rng):
        x = rng.normal(size=(5, 7)).astype(np.float32) * 3
        out = host(self._fq("port")(x, np.float32(-2.0), np.float32(2.0), 8,
                                    False))
        assert len(np.unique(out)) <= 256
        assert out.min() >= -2.01 and out.max() <= 2.01
        step = 4.0 / 255
        inside = np.abs(x) < 1.9
        np.testing.assert_allclose(out[inside], x[inside],
                                   atol=step / 2 + 1e-6)
        close(out, host(self._fq("jax")(x, np.float32(-2.0), np.float32(2.0),
                                        8, False)))

    def test_straight_through_gradient(self):
        x = torch.tensor([-5.0, -1.0, 0.3, 1.7, 9.0], requires_grad=True)
        mn = torch.tensor(-2.0, requires_grad=True)
        mx = torch.tensor(2.0, requires_grad=True)
        from deeplearning4j_tpu_torch.autodiff.sd_ops import fake_quant

        dx, dmn, dmx = torch.autograd.grad(fake_quant(x, mn, mx).sum(),
                                           [x, mn, mx])
        np.testing.assert_array_equal(dx.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])
        assert float(dmn) == 1.0 and float(dmx) == 1.0

    def test_per_channel(self, rng):
        from deeplearning4j_tpu.autodiff.sd_ops import fake_quant as jfq
        from deeplearning4j_tpu_torch.autodiff.sd_ops import fake_quant

        x = rng.normal(size=(8, 3)).astype(np.float32) * 4
        mn = np.array([-1.0, -2.0, -4.0], np.float32)
        mx = np.array([1.0, 2.0, 4.0], np.float32)
        out = host(self._fq("port")(x, mn, mx, 8, False))
        for c in range(3):
            step = (mx[c] - mn[c]) / 255
            assert out[:, c].min() >= mn[c] - step - 1e-5
            assert out[:, c].max() <= mx[c] + step + 1e-5
        close(out, host(self._fq("jax")(x, mn, mx, 8, False)))
        tmn = torch.tensor(mn, requires_grad=True)
        (dmn,) = torch.autograd.grad(
            fake_quant(torch.tensor(x), tmn, torch.tensor(mx)).sum(), [tmn])
        assert dmn.shape == (3,)
        want = jax.grad(lambda m: jfq(jnp.asarray(x), m, jnp.asarray(mx), 8,
                                      False).sum())(jnp.asarray(mn))
        close(host(dmn), host(want))

    def test_sd_graph_and_serialization(self, rng, tmp_path):
        x = rng.normal(size=(4, 6)).astype(np.float32) * 3
        outs = {}
        for pkg in ("port", "jax"):
            sd = new(pkg)
            out = sd.math.fake_quant_with_min_max_vars(
                sd.var("x", x), sd.var("mn", np.float32(-2.0)),
                sd.var("mx", np.float32(2.0)), num_bits=8, narrow_range=False)
            want = host(out.eval())
            path = str(tmp_path / f"fq_{pkg}.zip")
            sd.save(path)
            np.testing.assert_allclose(
                host(load(pkg, path).getVariable(out.name).eval()), want)
            other = "jax" if pkg == "port" else "port"
            close(host(load(other, path).getVariable(out.name).eval()), want)
            outs[pkg] = want
        close(outs["port"], outs["jax"])


# --------------------------------------------------------------------------
# where PyTorch's default is not jnp's
# --------------------------------------------------------------------------

def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 41).astype(np.float32)
    got = both(lambda sd, pkg: sd.gelu(sd.constant(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4     # not F.gelu's default
    np.testing.assert_allclose(got, torch.nn.functional.gelu(
        torch.from_numpy(x), approximate="tanh").numpy(), rtol=1e-6)


@pytest.mark.parametrize("op", ["std", "var", "moments", "standardize",
                                "layer_norm", "instance_norm", "group_norm"])
def test_moments_divide_by_n(op, rng):
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    g, b = np.ones(6, np.float32), np.zeros(6, np.float32)

    def build(sd, pkg):
        v = sd.constant(x)
        if op in ("std", "var"):
            return sd._op(op, v, attrs={"axis": [2]})
        if op == "moments":
            return sd._op(op, v, attrs={"axis": [2]})
        if op == "standardize":
            return sd._op(op, v, attrs={"axis": -1})
        if op == "group_norm":
            return sd._op(op, v, sd.constant(g), sd.constant(b),
                          attrs={"groups": 2})
        return sd._op(op, v, sd.constant(g), sd.constant(b))

    got = both(build)
    if op in ("std", "var"):
        np.testing.assert_allclose(got, getattr(np, op)(x, axis=2, ddof=0),
                                   rtol=1e-5)
    if op == "moments":
        np.testing.assert_allclose(got[1], x.var(axis=2), rtol=1e-5)


@pytest.mark.parametrize("n", [4, 5])
def test_median_is_jnp_median(n, rng):
    x = rng.normal(size=(3, n)).astype(np.float32)
    got = both(lambda sd, pkg: sd._op("median", sd.constant(x),
                                      attrs={"axis": [1]}))
    np.testing.assert_allclose(got, np.median(x, axis=1), rtol=1e-6)
    if n % 2 == 0:  # the mean of the two middle values, not the lower one
        lower = torch.median(torch.from_numpy(x), dim=1).values.numpy()
        assert np.abs(got - lower).max() > 1e-3


def test_percentile_interpolates_linearly(rng):
    x = rng.normal(size=(2, 7)).astype(np.float32)
    got = both(lambda sd, pkg: sd._op("percentile", sd.constant(x),
                                      attrs={"q": 37.0, "axis": [1],
                                             "keepdims": True}))
    np.testing.assert_allclose(got, np.percentile(x, 37.0, axis=1,
                                                  keepdims=True), rtol=1e-5)


@pytest.mark.parametrize("sl", [(slice(None, None, -1),),
                                (slice(4, 0, -2), slice(None, None, -3)),
                                (slice(-2, None, -1), slice(1, 5, 2)),
                                (slice(0, 3, -1),), (2, slice(None, None, -2))])
def test_negative_step_slices(sl):
    x = np.arange(42, dtype=np.float32).reshape(6, 7)
    got = both(lambda sd, pkg: sd.constant(x)[sl])
    np.testing.assert_array_equal(got, x[sl])


def test_dynamic_slice_clamps_begin():
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    # a negative start counts from the end (-2 -> 4), then each start is
    # clamped so that the slice fits (4 -> 2 on both axes)
    got = both(lambda sd, pkg: sd.slice(sd.constant(x), [4, -2], [3, 4]))
    np.testing.assert_array_equal(got, x[2:5, 2:6])


def test_mod_takes_the_divisor_sign_fmod_the_dividend():
    a = np.array([5.5, -5.5, 5.5, -5.5], np.float32)
    b = np.array([2.0, 2.0, -2.0, -2.0], np.float32)
    for op, want in (("mod", np.mod(a, b)), ("remainder", np.remainder(a, b)),
                     ("fmod", np.fmod(a, b)),
                     ("floordiv", np.floor_divide(a, b))):
        got = both(lambda sd, pkg: sd._op(op, sd.constant(a), sd.constant(b)))
        np.testing.assert_array_equal(got, want)


def test_one_hot_is_float32_and_zero_out_of_range():
    ids = np.array([2, -1, 7, 0], np.int32)
    got = both(lambda sd, pkg: sd.one_hot(sd.constant(ids), 4))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.array(
        [[0, 0, 1, 0], [0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0]], np.float32))


def test_f64_placeholders_become_f32():
    sd = new("port")
    w = sd.var("w", np.ones((3, 2), np.float32))
    out = sd.mmul(sd.placeholder("x"), w)
    x64 = np.arange(6, dtype=np.float64).reshape(2, 3)
    got = out.eval(x=x64)
    assert got.dtype == torch.float32
    assert sd.constant(np.float64(1.5)).eval().dtype == torch.float32
    jsd = new("jax")
    jout = jsd.mmul(jsd.placeholder("x"),
                    jsd.var("w", np.ones((3, 2), np.float32)))
    close(host(got), host(jout.eval(x=x64)))


@pytest.mark.parametrize("op", ["segment_max", "segment_min", "segment_prod",
                                "segment_sum", "segment_mean",
                                "unsorted_segment_sqrt_n"])
def test_empty_segments_hold_the_identity(op):
    data = np.array([[1., 2.], [3., 4.], [5., 6.]], np.float32)
    ids = np.array([0, 0, 3])
    got = both(lambda sd, pkg: sd._op(op, sd.constant(data), sd.constant(ids),
                                      attrs={"num_segments": 4}))
    empty = {"segment_max": -np.inf, "segment_min": np.inf,
             "segment_prod": 1.0}.get(op, 0.0)
    assert (got[1:3] == empty).all()


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic",
                                    "lanczos3", "lanczos5"])
@pytest.mark.parametrize("size", [(3, 5), (13, 9)])
def test_image_resize_every_method(method, size, rng):
    """Downsampling (antialiased, as jax.image.resize) and upsampling."""
    img = rng.uniform(size=(2, 8, 12, 3)).astype(np.float32)
    got = both(lambda sd, pkg: sd.image.resize(
        sd.constant(img), height=size[0], width=size[1], method=method))
    assert got.shape == (2,) + size + (3,)
    if method == "bilinear" and size == (3, 5):  # not F.interpolate's
        f = torch.nn.functional.interpolate(
            torch.from_numpy(img).permute(0, 3, 1, 2), size=size,
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(got - f).max() > 1e-3


def test_sort_and_top_k_ties_in_jax_order():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]], np.float32)
    for op, attrs in (("argsort", {}), ("argsort", {"descending": True}),
                      ("sort", {"descending": True})):
        got = both(lambda sd, pkg: sd._op(op, sd.constant(x), attrs=attrs))
        if op == "argsort" and not attrs:
            np.testing.assert_array_equal(got, [[3, 0, 5, 1, 2, 4]])
    vals, idx = both(lambda sd, pkg: sd._op("top_k", sd.constant(x),
                                            attrs={"k": 4}))
    np.testing.assert_array_equal(idx, [[1, 2, 4, 0]])
    # argsort holds -0.0 equal to +0.0; top_k ranks +0.0 above -0.0 (and
    # a NaN above all)
    z = np.array([[0.0, -0.0, 1.0, -0.0, 0.0]], np.float32)
    got = both(lambda sd, pkg: sd._op("argsort", sd.constant(z)))
    np.testing.assert_array_equal(got, [[0, 1, 3, 4, 2]])
    _, idx = both(lambda sd, pkg: sd._op("top_k", sd.constant(z),
                                         attrs={"k": 5}))
    np.testing.assert_array_equal(idx, [[2, 0, 4, 1, 3]])
    n = np.array([[1.0, np.nan, 2.0]], np.float32)
    _, idx = both(lambda sd, pkg: sd._op("top_k", sd.constant(n),
                                         attrs={"k": 3}))
    np.testing.assert_array_equal(idx, [[1, 2, 0]])


def test_ctc_matches_optax(rng):
    import optax

    from deeplearning4j_tpu_torch.autodiff.samediff import _OP_IMPLS as T

    B, T_, K, N = 3, 10, 6, 4
    logits = rng.normal(size=(B, T_, K)).astype(np.float32)
    ll = np.array([10, 7, 9])
    labels = np.array([[1, 2, 2, 3], [4, 1, 0, 0], [5, 5, 5, 1]])
    lab_len = np.array([4, 2, 3])
    got = T["ctc_loss"]({})(torch.from_numpy(logits), torch.from_numpy(ll),
                            torch.from_numpy(labels),
                            torch.from_numpy(lab_len))
    lp = (np.arange(T_)[None] >= ll[:, None]).astype(np.float32)
    lbp = (np.arange(N)[None] >= lab_len[:, None]).astype(np.float32)
    want = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(lp),
                          jnp.asarray(labels), jnp.asarray(lbp)).mean()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the random ops' contract
# --------------------------------------------------------------------------

SAMPLER_STATS = {  # op -> (attrs, mean, std) of the distribution
    "random_normal": ({"mean": 1.0, "stddev": 2.0}, 1.0, 2.0),
    "random_uniform": ({"min": -1.0, "max": 3.0}, 1.0, 4 / math.sqrt(12)),
    "random_bernoulli": ({"p": 0.3}, 0.3, math.sqrt(0.21)),
    "random_exponential": ({"rate": 2.0}, 0.5, 0.5),
    "random_gamma": ({"alpha": 3.0, "beta": 2.0}, 1.5, math.sqrt(3) / 2),
    "random_poisson": ({"rate": 4.0}, 4.0, 2.0),
    "random_truncated_normal": ({}, 0.0, 0.8796),
    "random_laplace": ({"scale": 0.5}, 0.0, 0.5 * math.sqrt(2)),
    "random_gumbel": ({}, 0.5772, math.pi / math.sqrt(6)),
    "random_beta": ({"alpha": 2.0, "beta": 5.0}, 2 / 7,
                    math.sqrt(10 / (49 * 8))),
    "random_randint": ({"min": 3, "max": 9}, 5.5, math.sqrt(35 / 12)),
}


@pytest.mark.parametrize("op", sorted(SAMPLER_STATS) + ["random_cauchy"])
def test_random_op_contract(op, tmp_path):
    attrs, mean, std = SAMPLER_STATS.get(op, ({}, None, None))
    sd = new("port")
    a = sd._op(op, attrs={"shape": [20000], "seed": 5, "salt": 1, **attrs},
               name="a")
    b = sd._op(op, attrs={"shape": [20000], "seed": 6, "salt": 1, **attrs},
               name="b")
    va, vb = host(a.eval()), host(b.eval())
    np.testing.assert_array_equal(va, host(a.eval()))       # fixed draw
    assert not np.array_equal(va, vb)                       # another seed
    path = str(tmp_path / "r.sdz")
    sd.save(path)
    np.testing.assert_array_equal(host(load("port", path).output("a")), va)
    if op == "random_cauchy":
        assert abs(np.median(va)) < 0.05
        return
    assert abs(va.mean() - mean) < 0.05 * max(std, 1.0)
    assert abs(va.std() - std) < 0.05 * std
    if op == "random_truncated_normal":
        assert np.abs(va).max() <= 2.0
    jsd = new("jax")
    jv = host(jsd._op(op, attrs={"shape": [20000], "seed": 5, "salt": 1,
                                 **attrs}).eval())
    assert abs(jv.mean() - mean) < 0.05 * max(std, 1.0)    # the same law


def test_random_categorical_and_shuffle_contract():
    sd = new("port")
    logits = np.log(np.array([[0.7, 0.2, 0.1]], np.float32))
    c = sd._op("random_categorical", sd.constant(logits),
               attrs={"num_samples": 20000, "seed": 1})
    draws = host(c.eval())
    np.testing.assert_array_equal(draws, host(c.eval()))
    np.testing.assert_allclose(np.bincount(draws[0], minlength=3) / 20000,
                               [0.7, 0.2, 0.1], atol=0.02)
    s = sd._op("random_shuffle", sd.constant(np.arange(10, dtype=np.float32)),
               attrs={"seed": 3})
    perm = host(s.eval())
    assert sorted(perm) == list(range(10)) and perm.tolist() != list(range(10))
    np.testing.assert_array_equal(perm, host(s.eval()))


def test_dropout_contract():
    sd = new("port")
    x = np.ones((100, 100), np.float32)
    d = sd._op("dropout", sd.constant(x), attrs={"rate": 0.25, "seed": 2})
    y = host(d.eval())
    np.testing.assert_array_equal(y, host(d.eval()))
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.02
    d2 = sd._op("dropout", sd.constant(x), attrs={"rate": 0.25, "seed": 3})
    assert not np.array_equal(y, host(d2.eval()))


def test_random_namespace_salts_each_node():
    for pkg in ("port", "jax"):
        sd = new(pkg)
        a = sd.random.uniform(shape=[5], seed=1)
        b = sd.random.uniform(shape=[5], seed=1)
        assert sd._nodes[a.name].attrs["salt"] != sd._nodes[b.name].attrs["salt"]


# --------------------------------------------------------------------------
# the registry-routed ops
# --------------------------------------------------------------------------

def test_sd_attention_is_the_runtime_op(rng):
    from deeplearning4j_tpu.ops.registry import op as jax_op
    from deeplearning4j_tpu_torch.ops.registry import op

    q, k, v = (rng.normal(size=(2, 3, 6, 4)).astype(np.float32)
               for _ in range(3))
    got = both(lambda sd, pkg: sd._op("dot_product_attention",
                                      *(sd.constant(a) for a in (q, k, v)),
                                      attrs={"scale": 0.3}))
    close(got, host(op("dot_product_attention")(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=0.3)))
    close(got, host(jax_op("dot_product_attention")(
        *(jnp.asarray(a) for a in (q, k, v)), scale=0.3)))


def test_sd_lstm_is_the_runtime_op(rng):
    from deeplearning4j_tpu_torch.ops.registry import op

    args = [rng.normal(size=s).astype(np.float32) * 0.5
            for s in ((3, 4, 2), (3, 5), (3, 5), (2, 20), (5, 20), (20,))]
    got = both(lambda sd, pkg: sd.nn.lstm_layer(
        *(sd.constant(a) for a in args), reverse=True)[1])
    _, (hT, _) = op("lstm_layer")(*(torch.from_numpy(a) for a in args),
                                  reverse=True)
    close(got, host(hT))


def test_sd_lrn_is_the_runtime_op_with_k_from_bias(rng):
    from deeplearning4j_tpu.ops.convolution import lrn as jax_lrn
    from deeplearning4j_tpu_torch.ops.registry import op

    x = rng.normal(size=(2, 3, 3, 7)).astype(np.float32)
    attrs = {"depth": 3, "bias": 1.5, "alpha": 0.1, "beta": 0.6}
    sd = new("port")
    got = host(sd._op("lrn", sd.constant(x), attrs=attrs).eval())
    want = op("lrn")(torch.from_numpy(x), depth=3, k=1.5, alpha=0.1, beta=0.6)
    np.testing.assert_array_equal(got, host(want))
    close(got, host(jax_lrn(jnp.asarray(x), depth=3, k=1.5, alpha=0.1,
                            beta=0.6)))
    # the JAX SameDiff op passes bias= to an lrn that takes k=
    jsd = new("jax")
    with pytest.raises(TypeError, match="bias"):
        jsd._op("lrn", jsd.constant(x), attrs=attrs).eval()


def test_sd_gru_is_the_plain_lowering(rng):
    from deeplearning4j_tpu.ops.recurrent import gru_layer as jax_gru
    from deeplearning4j_tpu_torch.ops.recurrent import gru_layer

    args = [rng.normal(size=s).astype(np.float32) * 0.5
            for s in ((8, 4, 2), (8, 5), (2, 15), (5, 15), (15,))]
    got = both(lambda sd, pkg: sd.nn.gru_layer(
        *(sd.constant(a) for a in args))[0])
    close(got, host(gru_layer(*(torch.from_numpy(a) for a in args))[0]))
    close(got, host(jax_gru(*(jnp.asarray(a) for a in args))[0]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


def _card_graph(build):
    sd = SameDiff.create(device="cuda")
    return sd, build(sd)


def _launched(fn):
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    for k in KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in KERNELS if k.launches}


def _plain(fn):
    from deeplearning4j_tpu_torch.common.env import env

    env.disable_kernels = True
    try:
        return fn()
    finally:
        env.reload()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sd_attention_launches_flash_on_card(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 64, 32, generator=g).to(cuda_device, dtype)
               for _ in range(3))
    sd = SameDiff.create(device="cuda")
    vs = [sd.var(n, t) for n, t in zip("qkv", (q, k, v))]
    # a reshape view and a transpose_ view, as a SameDiff BERT hands them
    qt = sd.transpose_(sd.reshape(sd.transpose_(vs[0], [0, 2, 1, 3]),
                                  [2, 64, 4, 32]), [0, 2, 1, 3])
    out = sd.sum(sd.square(sd.nn.dot_product_attention(qt, vs[1], vs[2])),
                 name="loss")
    y, n = _launched(lambda: sd.output("loss"))
    assert n == {"flash_attention_fwd": 1}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(float(y) - float(_plain(lambda: sd.output("loss")))) <= \
        tol * abs(float(y))
    _, n = _launched(lambda: sd.grad("loss"))
    assert n == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                 "flash_attention_dkv": 1}
    del out


@pytest.mark.cuda
def test_sd_lstm_launches_fused_lstm_on_card(cuda_device):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=s).astype(np.float32) * 0.3
            for s in ((8, 16, 32), (8, 64), (8, 64), (32, 256), (64, 256),
                      (256,))]
    sd = SameDiff.create(device="cuda")
    out, _, _ = sd.nn.lstm_layer(*(sd.var(f"a{i}", a)
                                   for i, a in enumerate(args)))
    sd.sum(sd.square(out), name="loss")
    y, n = _launched(lambda: sd.output("loss"))
    assert n == {"fused_lstm_fwd": 1}
    np.testing.assert_allclose(float(y), float(_plain(lambda: sd.output(
        "loss"))), rtol=1e-4)
    _, n = _launched(lambda: sd.grad("loss"))
    assert n == {"fused_lstm_fwd": 1, "fused_lstm_bwd": 1}


@pytest.mark.cuda
def test_sd_lrn_launches_lrn_kernels_on_card(cuda_device):
    x = np.random.default_rng(1).normal(size=(4, 9, 9, 96)).astype(np.float32)
    sd = SameDiff.create(device="cuda")
    h = sd.relu(sd.var("x", x))
    sd.sum(sd.square(sd._op("lrn", h, attrs={"depth": 5, "bias": 2.0,
                                             "alpha": 1e-4, "beta": 0.75})),
           name="loss")
    y, n = _launched(lambda: sd.output("loss"))
    assert n == {"lrn_fwd": 1}
    np.testing.assert_allclose(float(y), float(_plain(lambda: sd.output(
        "loss"))), rtol=1e-5)
    _, n = _launched(lambda: sd.grad("loss"))
    assert n == {"lrn_fwd": 1, "lrn_bwd": 1}
