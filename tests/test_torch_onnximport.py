"""The port's ONNX import (``deeplearning4j_tpu_torch/modelimport/onnx.py``)
against the JAX package's, on the same model bytes.

Each case of ``tests/test_onnximport.py`` (MLP, conv/BN/pool/GAP, the
transformer ops, omitted optional inputs, proto3 zero attributes, an
unknown op) is built with that file's protobuf writer and imported by both
packages on the CPU; the outputs agree within 1e-5 (f32; only the order of
f32 sums differs) and with the numpy references the JAX tests use. Then
one-node models of the rest of the mapper catalog (elementwise, reductions,
shape and index ops, norms, pools, casts) in both packages. Index outputs
are compared by value: the port keeps ONNX's int64 where the JAX package
(64-bit types off) has int32.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport.onnx import OnnxModelImport as JaxOnnx
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxModelImport
from test_onnximport import onnx_attr, onnx_model, onnx_node, onnx_tensor

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(model, feeds, outputs=None):
    """(port outputs, JAX outputs) as lists of numpy arrays."""
    port = OnnxModelImport.import_model(model, device="cpu")
    jax_imp = JaxOnnx.import_model(model)
    a = port.output(feeds, outputs)
    b = jax_imp.output(feeds, outputs)
    if not isinstance(a, (list, tuple)):
        a, b = [a], [b]
    for t in a:
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    return [t.numpy() for t in a], [np.asarray(t) for t in b]


def _assert_parity(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64),
                                   **TOL)


def test_gemm_relu_softmax(rng):
    W = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Gemm", ["x", "W", "b"], ["h"],
                         onnx_attr("alpha", f=1.0), onnx_attr("beta", f=1.0)),
               onnx_node("Relu", ["h"], ["r"]),
               onnx_node("Softmax", ["r"], ["y"], onnx_attr("axis", i=-1))],
        initializers=[onnx_tensor("W", W), onnx_tensor("b", b)],
        inputs=["x", "W", "b"], outputs=["y"])
    assert OnnxModelImport.import_model(model, device="cpu").graph_inputs \
        == ["x"]
    x = rng.normal(size=(5, 4)).astype(np.float32)
    a, b_ = _both(model, {"x": x})
    _assert_parity(a, b_)
    h = np.maximum(x @ W + b, 0)
    e = np.exp(h - h.max(-1, keepdims=True))
    np.testing.assert_allclose(a[0], e / e.sum(-1, keepdims=True), **TOL)


def test_conv_bn_pool_gap(rng):
    K = rng.normal(size=(4, 2, 3, 3)).astype(np.float32)
    scale = rng.random(4).astype(np.float32) + 0.5
    bias = rng.normal(size=4).astype(np.float32)
    mean = rng.normal(size=4).astype(np.float32)
    var = rng.random(4).astype(np.float32) + 0.5
    model = onnx_model(
        nodes=[onnx_node("Conv", ["x", "K"], ["c"],
                         onnx_attr("strides", ints=[1, 1]),
                         onnx_attr("auto_pad", s="SAME_UPPER"),
                         onnx_attr("kernel_shape", ints=[3, 3])),
               onnx_node("BatchNormalization", ["c", "s", "b", "m", "v"],
                         ["bn"], onnx_attr("epsilon", f=1e-5)),
               onnx_node("Relu", ["bn"], ["r"]),
               onnx_node("MaxPool", ["r"], ["p"],
                         onnx_attr("kernel_shape", ints=[2, 2]),
                         onnx_attr("strides", ints=[2, 2])),
               onnx_node("GlobalAveragePool", ["p"], ["g"]),
               onnx_node("Flatten", ["g"], ["y"], onnx_attr("axis", i=1))],
        initializers=[onnx_tensor("K", K), onnx_tensor("s", scale),
                      onnx_tensor("b", bias), onnx_tensor("m", mean),
                      onnx_tensor("v", var)],
        inputs=["x"], outputs=["y"])
    x = rng.normal(size=(2, 2, 8, 8)).astype(np.float32)
    a, b_ = _both(model, {"x": x})
    assert a[0].shape == (2, 4)
    _assert_parity(a, b_)


def test_unknown_op_raises_in_both():
    model = onnx_model(nodes=[onnx_node("FancyOp", ["x"], ["y"])],
                       initializers=[], inputs=["x"], outputs=["y"])
    for imp in (OnnxModelImport.import_model(model, device="cpu"),
                JaxOnnx.import_model(model)):
        with pytest.raises(NotImplementedError, match="FancyOp"):
            imp.output({"x": np.zeros((1,), np.float32)})


def test_gather_layernorm_gelu(rng):
    V, D, T = 9, 6, 4
    table = rng.normal(size=(V, D)).astype(np.float32)
    gamma = (rng.random(D) + 0.5).astype(np.float32)
    beta = rng.normal(size=D).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Gather", ["table", "ids"], ["emb"],
                         onnx_attr("axis", i=0)),
               onnx_node("LayerNormalization", ["emb", "gamma", "beta"],
                         ["ln"], onnx_attr("epsilon", f=1e-5)),
               onnx_node("Gelu", ["ln"], ["gelu"])],
        initializers=[onnx_tensor("table", table), onnx_tensor("gamma", gamma),
                      onnx_tensor("beta", beta)],
        inputs=["ids"], outputs=["gelu"])
    ids = rng.integers(0, V, (2, T)).astype(np.int64)
    a, b = _both(model, {"ids": ids}, ["gelu"])
    _assert_parity(a, b)
    from scipy.special import erf

    emb = table[ids]
    ln = (emb - emb.mean(-1, keepdims=True)) / np.sqrt(
        emb.var(-1, keepdims=True) + 1e-5) * gamma + beta
    np.testing.assert_allclose(a[0], 0.5 * ln * (1 + erf(ln / np.sqrt(2))),
                               rtol=1e-4, atol=1e-5)


def test_reduce_clip_where_split(rng):
    x = rng.normal(size=(2, 6)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("ReduceMean", ["x"], ["m"],
                         onnx_attr("axes", ints=[1]),
                         onnx_attr("keepdims", i=1)),
               onnx_node("Clip", ["x"], ["c"],
                         onnx_attr("min", f=-0.5), onnx_attr("max", f=0.5)),
               onnx_node("Equal", ["x", "x"], ["e"]),
               onnx_node("Where", ["e", "c", "m"], ["w"]),
               onnx_node("Split", ["w"], ["s0", "s1"],
                         onnx_attr("axis", i=1),
                         onnx_attr("split", ints=[2, 4]))],
        initializers=[], inputs=["x"], outputs=["s0", "s1"])
    a, b = _both(model, {"x": x}, ["s0", "s1"])
    _assert_parity(a, b)
    np.testing.assert_allclose(a[1], np.clip(x, -0.5, 0.5)[:, 2:], **TOL)


def test_unsqueeze_pow_sqrt_as_function(rng):
    x = rng.normal(size=(3, 4)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Pow", ["x", "two"], ["sq"]),
               onnx_node("ReduceSum", ["sq"], ["ss"],
                         onnx_attr("axes", ints=[1]),
                         onnx_attr("keepdims", i=1)),
               onnx_node("Sqrt", ["ss"], ["n"]),
               onnx_node("Unsqueeze", ["n"], ["u"],
                         onnx_attr("axes", ints=[0]))],
        initializers=[onnx_tensor("two", np.asarray([2.0], np.float32))],
        inputs=["x"], outputs=["u"])
    fn = OnnxModelImport.import_model(model, device="cpu").as_function(["u"])
    got = fn(x=torch.as_tensor(x)).numpy()
    want = np.asarray(JaxOnnx.import_model(model).as_function(["u"])(x=x))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.sqrt((x ** 2).sum(1, keepdims=True))[None],
                               **TOL)


def test_clip_with_omitted_min(rng):
    x = rng.normal(size=(2, 4)).astype(np.float32) * 3
    model = onnx_model(
        nodes=[onnx_node("Clip", ["x", "", "hi"], ["y"])],
        initializers=[onnx_tensor("hi", np.asarray([1.0], np.float32))],
        inputs=["x"], outputs=["y"])
    a, b = _both(model, {"x": x}, ["y"])
    _assert_parity(a, b)
    np.testing.assert_allclose(a[0], np.minimum(x, 1.0), rtol=1e-6)


def test_split_equal_default_three_outputs(rng):
    x = rng.normal(size=(2, 9)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Split", ["x"], ["a", "b", "c"],
                         onnx_attr("axis", i=1))],
        initializers=[], inputs=["x"], outputs=["a", "b", "c"])
    a, b = _both(model, {"x": x}, ["a", "b", "c"])
    _assert_parity(a, b)
    np.testing.assert_allclose(a[2], x[:, 6:], rtol=1e-6)


def test_layernorm_multi_axis(rng):
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("LayerNormalization", ["x"], ["y"],
                         onnx_attr("axis", i=1))],
        initializers=[], inputs=["x"], outputs=["y"])
    a, b = _both(model, {"x": x}, ["y"])
    _assert_parity(a, b)


def test_explicit_axis_zero_omitted_on_wire(rng):
    table = rng.normal(size=(5, 3)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Gather", ["t", "ids"], ["e"],
                         onnx_attr("axis", type_=2))],  # INT, value omitted
        initializers=[onnx_tensor("t", table)],
        inputs=["ids"], outputs=["e"])
    a, b = _both(model, {"ids": np.array([2, 0], np.int64)}, ["e"])
    _assert_parity(a, b)
    np.testing.assert_allclose(a[0], table[[2, 0]], rtol=1e-6)


def test_gemm_omitted_optional_input(rng):
    A = rng.normal(size=(3, 4)).astype(np.float32)
    B = rng.normal(size=(4, 2)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Gemm", ["a", "b", ""], ["y"])],
        initializers=[onnx_tensor("b", B)], inputs=["a"], outputs=["y"])
    a, b = _both(model, {"a": A}, ["y"])
    _assert_parity(a, b)


def test_conv_omitted_bias(rng):
    K = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    model = onnx_model(
        nodes=[onnx_node("Conv", ["x", "K", ""], ["y"],
                         onnx_attr("strides", ints=[1, 1]),
                         onnx_attr("auto_pad", s="SAME_UPPER"),
                         onnx_attr("kernel_shape", ints=[3, 3]))],
        initializers=[onnx_tensor("K", K)], inputs=["x"], outputs=["y"])
    x = rng.normal(size=(1, 2, 6, 6)).astype(np.float32)
    a, b = _both(model, {"x": x}, ["y"])
    assert a[0].shape == (1, 3, 6, 6)
    _assert_parity(a, b)


# ------------------------------------------------ the rest of the catalog

def _x(shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


_UNARY = ["Relu", "Sigmoid", "Tanh", "Neg", "Abs", "Floor", "Ceil", "Round",
          "Sign", "Cos", "Sin", "Tan", "Atan", "Sinh", "Cosh", "Asinh",
          "Softsign", "Mish", "Exp", "Erf", "Selu", "Elu", "Celu",
          "HardSigmoid", "HardSwish", "Softplus", "LeakyRelu", "Not",
          "IsNaN"]


@pytest.mark.parametrize("op", _UNARY)
def test_unary_mapper(op):
    x = _x((3, 5))
    if op == "Not":
        model = onnx_model([onnx_node("Greater", ["x", "z"], ["b"]),
                            onnx_node(op, ["b"], ["y"])],
                           [onnx_tensor("z", np.zeros(1, np.float32))],
                           ["x"], ["y"])
    else:
        model = onnx_model([onnx_node(op, ["x"], ["y"])], [], ["x"], ["y"])
    _assert_parity(*_both(model, {"x": x}))


@pytest.mark.parametrize("op,lo,hi", [
    ("Sqrt", 0.1, 3.0), ("Log", 0.1, 3.0), ("Reciprocal", 0.5, 3.0),
    ("Acos", -0.9, 0.9), ("Asin", -0.9, 0.9), ("Atanh", -0.9, 0.9),
    ("Acosh", 1.1, 3.0)])
def test_unary_mapper_on_its_domain(op, lo, hi):
    model = onnx_model([onnx_node(op, ["x"], ["y"])], [], ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 5), lo, hi)}))


_BINARY = ["Add", "Sub", "Mul", "Div", "Greater", "Less", "GreaterOrEqual",
           "LessOrEqual", "Equal", "Min", "Max", "Sum", "Mean", "PRelu"]


@pytest.mark.parametrize("op", _BINARY)
def test_binary_mapper_broadcasts(op):
    model = onnx_model([onnx_node(op, ["x", "w"], ["y"])],
                       [onnx_tensor("w", _x((5,), 0.5, 2.0, seed=1))],
                       ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 5))}))


@pytest.mark.parametrize("op", ["And", "Or", "Xor"])
def test_logical_mapper(op):
    model = onnx_model([onnx_node("Greater", ["x", "z"], ["a"]),
                        onnx_node("Less", ["x", "h"], ["b"]),
                        onnx_node(op, ["a", "b"], ["y"])],
                       [onnx_tensor("z", np.zeros(1, np.float32)),
                        onnx_tensor("h", np.ones(1, np.float32))],
                       ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((4, 4))}))


@pytest.mark.parametrize("fmod", [0, 1])
def test_mod(fmod):
    model = onnx_model([onnx_node("Mod", ["x", "w"], ["y"],
                                  onnx_attr("fmod", i=fmod))],
                       [onnx_tensor("w", np.asarray([0.7], np.float32))],
                       ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 4), -3, 3)}))


def test_pow_with_tensor_exponent():
    model = onnx_model([onnx_node("Pow", ["x", "e"], ["y"])],
                       [onnx_tensor("e", _x((4,), 0.5, 2.5, seed=3))],
                       ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 4), 0.2, 2.0)}))


@pytest.mark.parametrize("op", ["ReduceMax", "ReduceMin", "ReduceProd",
                                "ReduceL1", "ReduceL2", "ReduceLogSumExp",
                                "ReduceSumSquare", "ReduceMean", "ReduceSum"])
@pytest.mark.parametrize("keepdims", [0, 1])
def test_reductions(op, keepdims):
    model = onnx_model([onnx_node(op, ["x"], ["y"],
                                  onnx_attr("axes", ints=[0, 2]),
                                  onnx_attr("keepdims", i=keepdims))],
                       [], ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 4, 5), 0.5, 1.5)}))


def test_reduce_over_every_axis_by_default():
    model = onnx_model([onnx_node("ReduceMax", ["x"], ["y"])], [], ["x"],
                       ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 4))}))


@pytest.mark.parametrize("op", ["ArgMax", "ArgMin"])
@pytest.mark.parametrize("keepdims", [0, 1])
def test_arg_reductions(op, keepdims):
    model = onnx_model([onnx_node(op, ["x"], ["y"], onnx_attr("axis", i=1),
                                  onnx_attr("keepdims", i=keepdims))],
                       [], ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((3, 7))}))


def _int64(v):
    return np.asarray(v, np.int64)


_SHAPE_CASES = {
    "slice_negative_step": (
        [onnx_node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
        [onnx_tensor("st", _int64([-1, 4])), onnx_tensor("en", _int64(
            [-(1 << 63), 0])), onnx_tensor("ax", _int64([0, 1])),
         onnx_tensor("sp", _int64([-1, -2]))]),
    "slice_open_end": (
        [onnx_node("Slice", ["x", "st", "en"], ["y"])],
        [onnx_tensor("st", _int64([1])), onnx_tensor("en", _int64(
            [(1 << 63) - 1]))]),
    "pad_reflect": (
        [onnx_node("Pad", ["x", "p"], ["y"], onnx_attr("mode", s="reflect"))],
        [onnx_tensor("p", _int64([1, 2, 2, 1]))]),
    "pad_edge": (
        [onnx_node("Pad", ["x", "p"], ["y"], onnx_attr("mode", s="edge"))],
        [onnx_tensor("p", _int64([0, 1, 2, 0]))]),
    "pad_constant": (
        [onnx_node("Pad", ["x", "p", "c"], ["y"])],
        [onnx_tensor("p", _int64([1, 0, 0, 3])),
         onnx_tensor("c", np.asarray([1.5], np.float32))]),
    "tile": ([onnx_node("Tile", ["x", "r"], ["y"])],
             [onnx_tensor("r", _int64([2, 3]))]),
    "expand": ([onnx_node("Expand", ["x", "s"], ["y"])],
               [onnx_tensor("s", _int64([2, 1, 6]))]),
    "transpose_default": ([onnx_node("Transpose", ["x"], ["y"])], []),
    "flatten_axis0": ([onnx_node("Flatten", ["x"], ["y"],
                                 onnx_attr("axis", i=0))], []),
    "concat_axis0": ([onnx_node("Concat", ["x", "x"], ["y"],
                                onnx_attr("axis", i=0))], []),
    "reshape_copy_dim": ([onnx_node("Reshape", ["x", "s"], ["y"])],
                         [onnx_tensor("s", _int64([0, 3, -1]))]),
    "squeeze_unsqueeze": (
        [onnx_node("Unsqueeze", ["x", "a"], ["u"]),
         onnx_node("Squeeze", ["u"], ["y"], onnx_attr("axes", ints=[-1]))],
        [onnx_tensor("a", _int64([-1]))]),
    "gather_negative_index": (
        [onnx_node("Gather", ["x", "i"], ["y"], onnx_attr("axis", i=1))],
        [onnx_tensor("i", _int64([[-1, 0], [2, -3]]))]),
    "gather_elements": (
        [onnx_node("GatherElements", ["x", "i"], ["y"],
                   onnx_attr("axis", i=1))],
        [onnx_tensor("i", _int64([[5, 0, 1], [2, 2, 4], [0, 1, 3],
                                  [4, 4, 4]]))]),
    "gather_nd": ([onnx_node("GatherND", ["x", "i"], ["y"])],
                  [onnx_tensor("i", _int64([[0, 1], [3, 5]]))]),
    "scatter_nd": ([onnx_node("ScatterND", ["x", "i", "u"], ["y"])],
                   [onnx_tensor("i", _int64([[1], [3]])),
                    onnx_tensor("u", np.ones((2, 6), np.float32))]),
    "scatter_elements_add": (
        [onnx_node("ScatterElements", ["x", "i", "u"], ["y"],
                   onnx_attr("axis", i=1), onnx_attr("reduction", s="add"))],
        [onnx_tensor("i", _int64([[0, 0], [1, 5], [2, 2], [3, 4]])),
         onnx_tensor("u", np.ones((4, 2), np.float32))]),
    "scatter_elements_max": (
        [onnx_node("ScatterElements", ["x", "i", "u"], ["y"],
                   onnx_attr("axis", i=0), onnx_attr("reduction", s="max"))],
        [onnx_tensor("i", _int64([[1, 0, 3]])),
         onnx_tensor("u", np.full((1, 3), 0.25, np.float32))]),
    "trilu_lower": ([onnx_node("Trilu", ["x", "k"], ["y"],
                               onnx_attr("upper", i=0))],
                    [onnx_tensor("k", np.asarray(1, np.int64))]),
    "trilu_upper": ([onnx_node("Trilu", ["x"], ["y"])], []),
    "cumsum": ([onnx_node("CumSum", ["x", "a"], ["y"])],
               [onnx_tensor("a", np.asarray(1, np.int64))]),
    "topk_largest": ([onnx_node("TopK", ["x", "k"], ["y", "i"])],
                     [onnx_tensor("k", _int64([3]))]),
    "topk_smallest": ([onnx_node("TopK", ["x", "k"], ["y", "i"],
                                 onnx_attr("largest", i=0))],
                      [onnx_tensor("k", _int64([2]))]),
    "einsum": ([onnx_node("Einsum", ["x", "x"], ["y"],
                          onnx_attr("equation", s="ij,kj->ik"))], []),
    "log_softmax": ([onnx_node("LogSoftmax", ["x"], ["y"],
                               onnx_attr("axis", i=0))], []),
    "softmax_axis0": ([onnx_node("Softmax", ["x"], ["y"],
                                 onnx_attr("axis", i=0))], []),
    "cast_int_and_back": (
        [onnx_node("Cast", ["x"], ["c"], onnx_attr("to", i=6)),
         onnx_node("Cast", ["c"], ["y"], onnx_attr("to", i=1))], []),
    "shape_size": ([onnx_node("Shape", ["x"], ["y"]),
                    onnx_node("Size", ["x"], ["i"])], []),
    "gemm_transposed": (
        [onnx_node("Gemm", ["x", "w", "c"], ["y"], onnx_attr("transA", i=1),
                   onnx_attr("transB", i=1), onnx_attr("alpha", f=0.5),
                   onnx_attr("beta", f=2.0))],
        [onnx_tensor("w", _x((5, 4), seed=4)),
         onnx_tensor("c", _x((5,), seed=5))]),
}


# cases with a second output "i"
_TWO_OUTPUTS = ("topk_largest", "topk_smallest", "shape_size")


@pytest.mark.parametrize("case", sorted(_SHAPE_CASES))
def test_shape_and_index_mappers(case):
    nodes, inits = _SHAPE_CASES[case]
    outs = ["y", "i"] if case in _TWO_OUTPUTS else ["y"]
    model = onnx_model(nodes, inits, ["x"], outs)
    _assert_parity(*_both(model, {"x": _x((4, 6), seed=2)}, outs))


def test_range_onehot_constant_of_shape():
    model = onnx_model(
        [onnx_node("Range", ["s", "l", "d"], ["r"]),
         onnx_node("OneHot", ["idx", "depth", "vals"], ["oh"],
                   onnx_attr("axis", i=1)),
         onnx_node("ConstantOfShape", ["shp"], ["c"]),
         onnx_node("Add", ["oh", "c"], ["y"])],
        [onnx_tensor("s", np.asarray(1, np.int64)),
         onnx_tensor("l", np.asarray(9, np.int64)),
         onnx_tensor("d", np.asarray(3, np.int64)),
         onnx_tensor("depth", np.asarray(5, np.int64)),
         onnx_tensor("vals", np.asarray([-1.0, 2.0], np.float32)),
         onnx_tensor("shp", _int64([3, 5, 1]))],
        ["idx"], ["r", "y"])
    _assert_parity(*_both(model, {"idx": _int64([[0, 4, 9]])}, ["r", "y"]))


@pytest.mark.parametrize("op", ["InstanceNormalization", "GroupNormalization",
                                "BatchNormalization"])
def test_norms(op):
    C = 4
    inits = [onnx_tensor("s", _x((C,), 0.5, 1.5, seed=6)),
             onnx_tensor("b", _x((C,), seed=7))]
    ins = ["x", "s", "b"]
    attrs = [onnx_attr("epsilon", f=1e-4)]
    if op == "GroupNormalization":
        attrs.append(onnx_attr("num_groups", i=2))
    if op == "BatchNormalization":
        inits += [onnx_tensor("m", _x((C,), seed=8)),
                  onnx_tensor("v", _x((C,), 0.5, 1.5, seed=9))]
        ins += ["m", "v"]
    model = onnx_model([onnx_node(op, ins, ["y"], *attrs)], inits, ["x"],
                       ["y"])
    _assert_parity(*_both(model, {"x": _x((2, C, 5, 3))}))


_POOLS = {
    "avg_same_lower": [onnx_attr("auto_pad", s="SAME_LOWER"),
                       onnx_attr("kernel_shape", ints=[3, 2]),
                       onnx_attr("strides", ints=[2, 2])],
    "avg_pads_exclude": [onnx_attr("pads", ints=[1, 0, 1, 1]),
                         onnx_attr("kernel_shape", ints=[3, 3])],
    "avg_pads_include": [onnx_attr("pads", ints=[1, 0, 1, 1]),
                         onnx_attr("kernel_shape", ints=[3, 3]),
                         onnx_attr("count_include_pad", i=1)],
    "max_pads": [onnx_attr("pads", ints=[1, 1, 0, 1]),
                 onnx_attr("kernel_shape", ints=[2, 3]),
                 onnx_attr("strides", ints=[1, 2])],
    "max_same_upper": [onnx_attr("auto_pad", s="SAME_UPPER"),
                       onnx_attr("kernel_shape", ints=[2, 2]),
                       onnx_attr("strides", ints=[2, 2])],
}


@pytest.mark.parametrize("case", sorted(_POOLS))
def test_pools(case):
    op = "AveragePool" if case.startswith("avg") else "MaxPool"
    model = onnx_model([onnx_node(op, ["x"], ["y"], *_POOLS[case])], [],
                       ["x"], ["y"])
    _assert_parity(*_both(model, {"x": _x((2, 3, 7, 6))}))


def test_global_pools_and_grouped_dilated_conv():
    K = _x((4, 2, 3, 3), seed=11)
    model = onnx_model(
        [onnx_node("Conv", ["x", "K", "b"], ["c"],
                   onnx_attr("group", i=2), onnx_attr("dilations",
                                                      ints=[2, 1]),
                   onnx_attr("pads", ints=[2, 1, 1, 0]),
                   onnx_attr("strides", ints=[1, 2])),
         onnx_node("GlobalMaxPool", ["c"], ["y"]),
         onnx_node("GlobalAveragePool", ["c"], ["i"])],
        [onnx_tensor("K", K), onnx_tensor("b", _x((4,), seed=12))],
        ["x"], ["c", "y", "i"])
    _assert_parity(*_both(model, {"x": _x((2, 4, 9, 8))}, ["c", "y", "i"]))
