"""The port's TF frozen-graph import (``deeplearning4j_tpu_torch/
modelimport/tensorflow.py``) against the JAX package's, on the same
GraphDef bytes.

The cases of ``tests/test_tfimport.py`` (wire format, MLP, conv, scalar-
field tensors, the BERT-class ops, the mini BERT) are built with that
file's protobuf writer and imported by both packages on the CPU: outputs
within 1e-5 (f32; only the order of f32 sums differs). ``to_samediff``
is held against the JAX package's on the MLP, conv and fake-quant
fixtures, and raises the JAX message at an unmapped op (GatherV2) in both
packages. ``chip_smoke.bert_graph_def`` (the
BERT-base GraphDef of the chip run, here at 2 layers x 64, 2 heads, vocab
100, T 16) goes through both packages' import: outputs within 1e-5, and 3
Adam steps of ``as_trainable`` on the same batch leave params within 1e-5.
Then one-node graphs of the rest of the mapper catalog in both packages.

TF's LRN has no JAX counterpart to hold against: the JAX mapper passes
``bias=`` to a registry op that takes ``k=`` and raises TypeError (ROADMAP
C). The port's mapper is held against TF's formula in numpy.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.modelimport.tensorflow import TFGraphMapper as JaxTF
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.modelimport.tensorflow import TFGraphMapper
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from test_tfimport import (
    _attr, _int_field, _len_field, _shape_proto, graph_def, node,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(g, feeds, outputs):
    port = TFGraphMapper.import_graph(g, device="cpu")
    jax_imp = JaxTF.import_graph(g)
    a = port.output(feeds, outputs)
    b = jax_imp.output(feeds, outputs)
    if len(outputs) == 1:
        a, b = [a], [b]
    for t in a:
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    return [t.numpy() for t in a], [np.asarray(t) for t in b]


def _assert_parity(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64),
                                   **TOL)


def _const(name, arr):
    return node(name, "Const", value=_attr("value", t=np.asarray(arr)))


def test_const_round_trip():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    imp = TFGraphMapper.import_graph(graph_def(_const("w", w)), device="cpu")
    np.testing.assert_array_equal(imp.constants["w"], w)


def test_matmul_bias_relu_softmax(rng):
    W = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    g = graph_def(node("x", "Placeholder"), _const("W", W), _const("b", b),
                  node("mm", "MatMul", ["x", "W"]),
                  node("ba", "BiasAdd", ["mm", "b"]),
                  node("relu", "Relu", ["ba"]),
                  node("probs", "Softmax", ["relu"]))
    assert TFGraphMapper.import_graph(g, device="cpu").placeholders == ["x"]
    x = rng.normal(size=(5, 4)).astype(np.float32)
    a, b_ = _both(g, {"x": x}, ["probs"])
    _assert_parity(a, b_)
    h = np.maximum(x @ W + b, 0)
    e = np.exp(h - h.max(-1, keepdims=True))
    np.testing.assert_allclose(a[0], e / e.sum(-1, keepdims=True), **TOL)


def test_as_function(rng):
    W = rng.normal(size=(4, 2)).astype(np.float32)
    g = graph_def(node("x", "Placeholder"), _const("W", W),
                  node("y", "MatMul", ["x", "W"]))
    fn = TFGraphMapper.import_graph(g, device="cpu").as_function(["y"])
    x = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(fn(x=x).numpy(), x @ W, **TOL)


def test_conv_pool_mean(rng):
    K = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    g = graph_def(
        node("x", "Placeholder"), _const("K", K),
        node("conv", "Conv2D", ["x", "K"],
             strides=_attr("strides", li=[1, 1, 1, 1]),
             padding=_attr("padding", s="SAME")),
        node("relu", "Relu", ["conv"]),
        node("pool", "MaxPool", ["relu"],
             ksize=_attr("ksize", li=[1, 2, 2, 1]),
             strides=_attr("strides", li=[1, 2, 2, 1]),
             padding=_attr("padding", s="VALID")),
        _const("axes", np.asarray([1, 2], np.int32)),
        node("gap", "Mean", ["pool", "axes"]))
    a, b = _both(g, {"x": rng.normal(size=(2, 8, 8, 2)).astype(np.float32)},
                 ["gap"])
    assert a[0].shape == (2, 4)
    _assert_parity(a, b)


def test_fused_batchnorm(rng):
    g = graph_def(
        node("x", "Placeholder"),
        _const("s", rng.normal(size=(3,)).astype(np.float32)),
        _const("o", rng.normal(size=(3,)).astype(np.float32)),
        _const("m", rng.normal(size=(3,)).astype(np.float32)),
        _const("v", rng.random((3,)).astype(np.float32) + 0.5),
        node("bn", "FusedBatchNorm", ["x", "s", "o", "m", "v"],
             epsilon=_attr("epsilon", f=1e-3)))
    _assert_parity(*_both(
        g, {"x": rng.normal(size=(2, 4, 4, 3)).astype(np.float32)}, ["bn"]))


def test_unknown_op_raises_in_both():
    g = graph_def(node("x", "Placeholder"), node("y", "SomeExoticOp", ["x"]))
    for imp in (TFGraphMapper.import_graph(g, device="cpu"),
                JaxTF.import_graph(g)):
        with pytest.raises(NotImplementedError, match="SomeExoticOp"):
            imp.output({"x": np.zeros((1,), np.float32)})


def _scalar_fields(payload, dtype_enum, shape):
    out = _int_field(1, dtype_enum) + _len_field(2, _shape_proto(shape))
    out += payload
    return _len_field(1, _len_field(1, b"c") + _len_field(2, b"Const")
                      + _len_field(5, _len_field(1, b"value")
                                   + _len_field(2, _len_field(8, out))))


@pytest.mark.parametrize("case", ["int_val_unpacked", "float_val_packed",
                                  "single_value_splat"])
def test_scalar_field_tensors(case):
    import struct

    payload, dt, shape = {
        "int_val_unpacked": (_int_field(7, 3) + _int_field(7, 5), 3, [2]),
        "float_val_packed": (_len_field(5, struct.pack("<ff", 1.5, -2.25)),
                             1, [2]),
        "single_value_splat": (_int_field(7, 9), 3, [4]),
    }[case]
    g = _scalar_fields(payload, dt, shape)
    got = TFGraphMapper.import_graph(g, device="cpu").constants["c"]
    want = JaxTF.import_graph(g).constants["c"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_mlp_to_samediff_matches_direct(rng):
    W = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    g = graph_def(
        node("x", "Placeholder"), _const("W", W), _const("b", b),
        node("mm", "MatMul", ["x", "W"]),
        node("ba", "BiasAdd", ["mm", "b"]),
        node("relu", "Relu", ["ba"]),
        node("probs", "Softmax", ["relu"]),
    )
    imported = TFGraphMapper.import_graph(g, device="cpu")
    sd = imported.to_samediff()
    x = rng.normal(size=(5, 4)).astype(np.float32)
    direct = imported.output({"x": x}, ["probs"]).numpy()
    via_sd = sd.output("probs", x=x).numpy()
    np.testing.assert_allclose(via_sd, direct, rtol=1e-5, atol=1e-6)
    jax_sd = JaxTF.import_graph(g).to_samediff()
    assert list(sd._nodes) == list(jax_sd._nodes)
    np.testing.assert_allclose(via_sd, np.asarray(jax_sd.output("probs", x=x)),
                               **TOL)


def test_conv_graph_to_samediff_and_save(rng, tmp_path):
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JaxSameDiff
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

    K = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    g = graph_def(
        node("x", "Placeholder"), _const("K", K),
        node("conv", "Conv2D", ["x", "K"],
             strides=_attr("strides", li=[1, 1, 1, 1]),
             padding=_attr("padding", s="SAME")),
        node("relu", "Relu", ["conv"]),
        node("pool", "MaxPool", ["relu"],
             ksize=_attr("ksize", li=[1, 2, 2, 1]),
             strides=_attr("strides", li=[1, 2, 2, 1]),
             padding=_attr("padding", s="VALID")),
    )
    imported = TFGraphMapper.import_graph(g, device="cpu")
    sd = imported.to_samediff()
    x = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    want = imported.output({"x": x}, ["pool"]).numpy()
    np.testing.assert_allclose(sd.output("pool", x=x).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    jax_want = np.asarray(JaxTF.import_graph(g).to_samediff().output(
        "pool", x=x))
    np.testing.assert_allclose(sd.output("pool", x=x).numpy(), jax_want,
                               **TOL)
    # the imported graph serializes like any other SameDiff, and crosses
    p = str(tmp_path / "imported.sdz")
    sd.save(p)
    sd2 = SameDiff.load(p, device="cpu")
    np.testing.assert_allclose(sd2.output("pool", x=x).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(JaxSameDiff.load(p).output("pool", x=x)), jax_want,
        **TOL)


def test_quant_graph_to_samediff_parity():
    """The QAT fixture through to_samediff, against its committed golden
    and the JAX package's to_samediff (test_sd_ops_ext.py's
    TestFakeQuantToSameDiff)."""
    import os

    fx = os.path.join(os.path.dirname(__file__), "fixtures")
    gold = np.load(os.path.join(fx, "quant_golden.npz"))
    path = os.path.join(fx, "quant_graph.pb")
    sd = TFGraphMapper.import_graph(path, device="cpu").to_samediff()
    out = sd.output("output", input=gold["x"]).numpy()
    np.testing.assert_allclose(out, gold["out"], rtol=1e-5, atol=1e-6)
    jax_out = np.asarray(JaxTF.import_graph(path).to_samediff().output(
        "output", input=gold["x"]))
    np.testing.assert_allclose(out, jax_out, **TOL)


def test_to_samediff_unmapped_op_raises_the_jax_message():
    """GatherV2 (BERT's embedding lookup) has no SameDiff mapping in the
    JAX package; the port adds none, and raises the same message."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    g = graph_def(
        node("ids", "Placeholder"), _const("table", table),
        _const("axis", np.array(0, np.int32)),
        node("emb", "GatherV2", ["table", "ids", "axis"]),
    )
    msgs = []
    for imp in (TFGraphMapper.import_graph(g, device="cpu"),
                JaxTF.import_graph(g)):
        with pytest.raises(NotImplementedError) as err:
            imp.to_samediff()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "no SameDiff mapping for TF op 'GatherV2' (node emb)" in msgs[0]


def test_embedding_attention_block(rng):
    V, D, T = 11, 4, 3
    g = graph_def(
        node("ids", "Placeholder"),
        _const("table", rng.normal(size=(V, D)).astype(np.float32)),
        _const("axis0", np.asarray([0], np.int32)),
        node("emb", "GatherV2", ["table", "ids", "axis0"]),
        node("scores", "BatchMatMulV2", ["emb", "emb"],
             adj_y=_attr("adj_y", b=True)),
        node("probs", "Softmax", ["scores"]),
        node("ctx", "BatchMatMulV2", ["probs", "emb"]))
    ids = rng.integers(0, V, (2, T)).astype(np.int32)
    _assert_parity(*_both(g, {"ids": ids}, ["ctx"]))


def test_decomposed_layernorm_and_gelu(rng):
    D = 6
    g = graph_def(
        node("x", "Placeholder"),
        _const("gamma", (rng.random(D) + 0.5).astype(np.float32)),
        _const("beta", rng.normal(size=D).astype(np.float32)),
        _const("axes", np.asarray([1], np.int32)),
        node("mu", "Mean", ["x", "axes"], keep_dims=_attr("keep_dims", b=True)),
        node("sqd", "SquaredDifference", ["x", "mu"]),
        node("var", "Mean", ["sqd", "axes"],
             keep_dims=_attr("keep_dims", b=True)),
        _const("eps", np.asarray([1e-6], np.float32)),
        node("vare", "Add", ["var", "eps"]), node("inv", "Rsqrt", ["vare"]),
        node("xmu", "Sub", ["x", "mu"]), node("norm", "Mul", ["xmu", "inv"]),
        node("scaled", "Mul", ["norm", "gamma"]),
        node("ln", "Add", ["scaled", "beta"]),
        _const("rt2", np.asarray([1.4142135], np.float32)),
        node("div", "RealDiv", ["ln", "rt2"]), node("erf", "Erf", ["div"]),
        _const("one", np.asarray([1.0], np.float32)),
        node("erf1", "Add", ["erf", "one"]),
        _const("half", np.asarray([0.5], np.float32)),
        node("xh", "Mul", ["ln", "half"]), node("gelu", "Mul", ["xh", "erf1"]))
    _assert_parity(*_both(
        g, {"x": rng.normal(size=(3, D)).astype(np.float32)}, ["gelu"]))


def test_strided_slice_and_cast(rng):
    x = rng.normal(size=(4, 6)).astype(np.float32)
    g = graph_def(
        node("x", "Placeholder"), _const("b", np.asarray([1, 0], np.int32)),
        _const("e", np.asarray([3, 6], np.int32)),
        _const("s", np.asarray([1, 2], np.int32)),
        node("sl", "StridedSlice", ["x", "b", "e", "s"]),
        node("c", "Cast", ["sl"], DstT=_attr("DstT", type_=3)))
    a, b = _both(g, {"x": x}, ["c"])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[0], x[1:3, ::2].astype(np.int32))


def test_mini_bert_graph(rng):
    """tests/test_tfimport.py's mini BERT (embedding gather, BatchMatMul
    attention, residual + decomposed LayerNorm, [CLS] pooler by
    StridedSlice shrink, tanh pooler, classifier)."""
    V, D, T, C = 13, 8, 5, 3
    c = {
        "table": (rng.normal(size=(V, D)) * 0.5).astype(np.float32),
        "pos": (rng.normal(size=(1, T, D)) * 0.1).astype(np.float32),
        "Wq": rng.normal(size=(1, D, D)).astype(np.float32) * 0.4,
        "Wk": rng.normal(size=(1, D, D)).astype(np.float32) * 0.4,
        "Wv": rng.normal(size=(1, D, D)).astype(np.float32) * 0.4,
        "gamma": (rng.random(D) + 0.5).astype(np.float32),
        "beta": rng.normal(size=D).astype(np.float32),
        "Wp": rng.normal(size=(D, D)).astype(np.float32) * 0.4,
        "Wc": rng.normal(size=(D, C)).astype(np.float32) * 0.4,
        "scale": np.asarray([1.0 / np.sqrt(D)], np.float32),
        "ax0": np.asarray([0], np.int32), "axes": np.asarray([2], np.int32),
        "eps": np.asarray([1e-6], np.float32),
        "sb": np.asarray([0, 0], np.int32), "se": np.asarray([0, 1], np.int32),
        "ss": np.asarray([1, 1], np.int32),
    }
    kd = dict(keep_dims=_attr("keep_dims", b=True))
    g = graph_def(
        node("ids", "Placeholder"), *[_const(k, v) for k, v in c.items()],
        node("emb0", "GatherV2", ["table", "ids", "ax0"]),
        node("emb", "Add", ["emb0", "pos"]),
        node("q", "BatchMatMulV2", ["emb", "Wq"]),
        node("k", "BatchMatMulV2", ["emb", "Wk"]),
        node("v", "BatchMatMulV2", ["emb", "Wv"]),
        node("scores0", "BatchMatMulV2", ["q", "k"],
             adj_y=_attr("adj_y", b=True)),
        node("scores", "Mul", ["scores0", "scale"]),
        node("probs", "Softmax", ["scores"]),
        node("ctx", "BatchMatMulV2", ["probs", "v"]),
        node("res", "Add", ["emb", "ctx"]),
        node("mu", "Mean", ["res", "axes"], **kd),
        node("sqd", "SquaredDifference", ["res", "mu"]),
        node("var", "Mean", ["sqd", "axes"], **kd),
        node("vare", "Add", ["var", "eps"]), node("inv", "Rsqrt", ["vare"]),
        node("xmu", "Sub", ["res", "mu"]), node("norm", "Mul", ["xmu", "inv"]),
        node("scaled", "Mul", ["norm", "gamma"]),
        node("ln", "Add", ["scaled", "beta"]),
        node("cls", "StridedSlice", ["ln", "sb", "se", "ss"],
             begin_mask=_attr("begin_mask", i=1),
             end_mask=_attr("end_mask", i=1),
             shrink_axis_mask=_attr("shrink_axis_mask", i=2)),
        node("pooled0", "MatMul", ["cls", "Wp"]),
        node("pooled", "Tanh", ["pooled0"]),
        node("logits", "MatMul", ["pooled", "Wc"]),
        node("out", "Softmax", ["logits"]))
    ids = rng.integers(0, V, (2, T)).astype(np.int32)
    a, b = _both(g, {"ids": ids}, ["out"])
    _assert_parity(a, b)
    assert a[0].shape == (2, C)


# ------------------------------------------------- chip_smoke's BERT graph

SMALL = dict(layers=2, hidden=64, heads=2, intermediate=128, vocab=100,
             batch=2, seq=16)


def _bert_feeds(seed=3, B=2, T=16, V=100):
    rng = np.random.default_rng(seed)
    lens = np.array([T, T // 2 + 1])
    return {"input_ids": rng.integers(0, V, (B, T)).astype(np.int32),
            "input_mask": (np.arange(T)[None] < lens[:, None]).astype(
                np.int32),
            "segment_ids": (np.arange(T)[None] >= lens[:, None] // 2
                            ).astype(np.int32)}


@pytest.fixture(scope="module")
def small_bert():
    return chip_smoke.bert_graph_def(**SMALL)


def test_bert_graph_def_outputs_match(small_bert):
    outs = ["logits", chip_smoke.BERT_POOLED, "bert/encoder/Reshape_last"]
    port = TFGraphMapper.import_graph(small_bert, device="cpu")
    jax_imp = JaxTF.import_graph(small_bert)
    assert port.import_opt_stats == jax_imp.import_opt_stats
    assert port.import_opt_stats["fuse_attention"] == SMALL["layers"]
    feeds = _bert_feeds()
    a = [t.numpy() for t in port.output(feeds, outs)]
    b = [np.asarray(t) for t in jax_imp.output(feeds, outs)]
    _assert_parity(a, b)
    assert a[0].shape == (2, 2) and a[2].shape == (2, 16, 64)


def test_bert_graph_def_adam_steps_match(small_bert):
    """3 Adam steps of as_trainable (f32, cross-entropy on the logits) in
    both packages from the same imported weights."""
    import jax

    feeds = _bert_feeds(seed=4)
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    lr = 1e-3

    port = TFGraphMapper.import_graph(small_bert, device="cpu")
    fn, params = port.as_trainable(outputs=["logits"])
    upd = Adam(lr=lr)
    state = upd.init_state(params)
    yt = torch.as_tensor(y)
    losses = []
    for i in range(3):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = -(yt * torch.log_softmax(fn(p, feeds), -1)).sum(-1).mean()
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            u, state = upd.update(g, state, params, i)
            params = {k: params[k] - u[k] for k in params}
        losses.append(float(loss.detach()))

    jimp = JaxTF.import_graph(small_bert)
    jfn, jparams = jimp.as_trainable(outputs=["logits"])
    assert set(jparams) == set(params)
    jupd = JaxAdam(lr=lr)
    jstate = jupd.init_state(jparams)

    def jloss(p):
        return -(y * jax.nn.log_softmax(jfn(p, feeds))).sum(-1).mean()

    jlosses = []
    step = jax.jit(jax.value_and_grad(jloss))
    for i in range(3):
        loss, g = step(jparams)
        u, jstate = jupd.update(g, jstate, jparams, i)
        jparams = jax.tree_util.tree_map(lambda a, b: a - b, jparams, u)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k in params:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jparams[k], np.float32),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_bert_graph_def_bf16_compute(small_bert):
    """as_trainable(compute_dtype=bfloat16) (the port's own; the ONNX
    frontend's semantics): every op after the bf16 params stays bf16,
    OneHot and the mask Cast included, and the logits track f32."""
    port = TFGraphMapper.import_graph(small_bert, device="cpu")
    feeds = _bert_feeds()
    fn, params = port.as_trainable(outputs=["logits", chip_smoke.BERT_POOLED],
                                   compute_dtype=torch.bfloat16)
    bf = {k: v.to(torch.bfloat16) for k, v in params.items()}
    logits, pooled = fn(bf, feeds)
    assert logits.dtype == torch.bfloat16 and pooled.dtype == torch.bfloat16
    want = port.output(feeds, [chip_smoke.BERT_POOLED])
    np.testing.assert_allclose(pooled.float().numpy(), want.numpy(),
                               atol=2e-2)


def test_lrn_mapper_is_tf_lrn(rng):
    """TF's LRN: x / (bias + alpha * sum_{|d| <= r} x^2)^beta, through the
    registry's lrn op (the LRN kernels on the card)."""
    shape = (2, 5, 5, 16)
    g = chip_smoke.lrn_graph_def(shape, depth_radius=2, bias=1.5, alpha=0.2,
                                 beta=0.6)
    x = rng.normal(size=shape).astype(np.float32) * 2
    got = TFGraphMapper.import_graph(g, device="cpu").output(
        {"x": x}, ["lrn"]).numpy()
    sq = np.pad(x * x, [(0, 0)] * 3 + [(2, 2)])
    want = x / (1.5 + 0.2 * sum(sq[..., i:i + 16] for i in range(5))) ** 0.6
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    with pytest.raises(TypeError, match="bias"):
        JaxTF.import_graph(g).output({"x": x}, ["lrn"])


# ------------------------------------------------ the rest of the catalog

def _x(shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


_UNARY = ["Relu", "Relu6", "Sigmoid", "Tanh", "Softmax", "Neg", "Exp", "Abs",
          "Square", "Erf", "LeakyRelu", "Softplus", "Floor", "Ceil", "Round",
          "Rint", "Sign", "Sin", "Cos", "Tan", "Atan", "Sinh", "Cosh",
          "Asinh", "Elu", "Selu", "Swish", "Softsign", "ZerosLike",
          "OnesLike", "Snapshot", "IsNan", "IsInf", "IsFinite", "Expm1",
          "L2Loss"]


@pytest.mark.parametrize("op", _UNARY)
def test_unary_mapper(op):
    g = graph_def(node("x", "Placeholder"), node("y", op, ["x"]))
    _assert_parity(*_both(g, {"x": _x((3, 5))}, ["y"]))


@pytest.mark.parametrize("op,lo,hi", [
    ("Sqrt", 0.1, 3.0), ("Rsqrt", 0.1, 3.0), ("Log", 0.1, 3.0),
    ("Log1p", 0.1, 3.0), ("Reciprocal", 0.5, 3.0), ("Asin", -0.9, 0.9),
    ("Acos", -0.9, 0.9), ("Atanh", -0.9, 0.9), ("Acosh", 1.1, 3.0)])
def test_unary_mapper_on_its_domain(op, lo, hi):
    g = graph_def(node("x", "Placeholder"), node("y", op, ["x"]))
    _assert_parity(*_both(g, {"x": _x((3, 5), lo, hi)}, ["y"]))


_BINARY = ["Add", "AddV2", "Sub", "Mul", "RealDiv", "Div", "Maximum",
           "Minimum", "SquaredDifference", "FloorDiv", "FloorMod", "Mod",
           "Atan2", "Greater", "GreaterEqual", "Less", "LessEqual", "Equal",
           "NotEqual", "Pow", "BiasAdd"]


@pytest.mark.parametrize("op", _BINARY)
def test_binary_mapper(op):
    g = graph_def(node("x", "Placeholder"),
                  _const("w", _x((5,), 0.5, 2.0, seed=1)),
                  node("y", op, ["x", "w"]))
    lo = 0.2 if op == "Pow" else -2.0
    _assert_parity(*_both(g, {"x": _x((3, 5), lo)}, ["y"]))


def _ints(v):
    return np.asarray(v, np.int32)


_CASES = {
    "reshape": ([_const("s", _ints([3, -1])),
                 node("y", "Reshape", ["x", "s"])]),
    "squeeze_expand": ([_const("a", _ints(1)),
                        node("e", "ExpandDims", ["x", "a"]),
                        node("y", "Squeeze", ["e"],
                             squeeze_dims=_attr("squeeze_dims", li=[1]))]),
    "concat": ([_const("a", _ints(0)), node("y", "ConcatV2", ["x", "x", "a"])]),
    "transpose": ([_const("p", _ints([1, 0])),
                   node("y", "Transpose", ["x", "p"])]),
    "pad": ([_const("p", _ints([[1, 0], [0, 2]])),
             node("y", "Pad", ["x", "p"])]),
    "mirror_pad_reflect": ([_const("p", _ints([[1, 1], [2, 0]])),
                            node("y", "MirrorPad", ["x", "p"],
                                 mode=_attr("mode", s="REFLECT"))]),
    "mirror_pad_symmetric": ([_const("p", _ints([[0, 2], [1, 1]])),
                              node("y", "MirrorPad", ["x", "p"],
                                   mode=_attr("mode", s="SYMMETRIC"))]),
    "gather_axis1": ([_const("i", _ints([[2, 0], [5, 1]])),
                      _const("a", _ints(1)),
                      node("y", "GatherV2", ["x", "i", "a"])]),
    "slice": ([_const("b", _ints([1, 2])), _const("s", _ints([2, -1])),
               node("y", "Slice", ["x", "b", "s"])]),
    "strided_slice_reverse": ([_const("b", _ints([-1, 0])),
                               _const("e", _ints([0, 6])),
                               _const("s", _ints([-1, 2])),
                               node("y", "StridedSlice", ["x", "b", "e", "s"],
                                    end_mask=_attr("end_mask", i=1))]),
    "tile": ([_const("r", _ints([2, 1])), node("y", "Tile", ["x", "r"])]),
    "sum_keep": ([_const("a", _ints([1])),
                  node("y", "Sum", ["x", "a"],
                       keep_dims=_attr("keep_dims", b=True))]),
    "prod": ([_const("a", _ints([0])), node("y", "Prod", ["x", "a"])]),
    "min": ([_const("a", _ints([1])), node("y", "Min", ["x", "a"])]),
    "max_empty_axes": ([_const("a", np.zeros(0, np.int32)),
                        node("y", "Max", ["x", "a"])]),
    "all_any": ([_const("z", np.zeros(1, np.float32)),
                 _const("a", _ints([1])),
                 node("b", "Greater", ["x", "z"]),
                 node("y", "Any", ["b", "a"]),
                 node("i", "All", ["b", "a"])]),
    "argmax_argmin": ([_const("a", _ints(1)),
                       node("y", "ArgMax", ["x", "a"]),
                       node("i", "ArgMin", ["x", "a"])]),
    "cumsum_exclusive_reverse": ([_const("a", _ints(1)),
                                  node("y", "Cumsum", ["x", "a"],
                                       exclusive=_attr("exclusive", b=True),
                                       reverse=_attr("reverse", b=True))]),
    "topk": ([_const("k", _ints(3)), node("t", "TopKV2", ["x", "k"]),
              node("y", "Identity", ["t:0"]), node("i", "Identity", ["t:1"])]),
    "pack_unpack": ([node("p", "Pack", ["x", "x"], axis=_attr("axis", i=1)),
                     node("u", "Unpack", ["p"], num=_attr("num", i=2),
                          axis=_attr("axis", i=1)),
                     node("y", "Identity", ["u:1"])]),
    "split_splitv": ([_const("a", _ints(1)),
                      node("s", "Split", ["a", "x"],
                           num_split=_attr("num_split", i=2)),
                      _const("sz", _ints([1, 5])),
                      node("v", "SplitV", ["x", "sz", "a"],
                           num_split=_attr("num_split", i=2)),
                      node("y", "Identity", ["s:1"]),
                      node("i", "Identity", ["v:1"])]),
    "shape_size_rank_fill": ([node("s", "Shape", ["x"]),
                              node("n", "Size", ["x"]),
                              node("r", "Rank", ["x"]),
                              _const("v", np.asarray(1.5, np.float32)),
                              node("y", "Fill", ["s", "v"]),
                              node("i", "Pack", ["n"])]),
    "select": ([_const("z", np.zeros(1, np.float32)),
                node("c", "Greater", ["x", "z"]),
                node("n", "Neg", ["x"]),
                node("y", "SelectV2", ["c", "x", "n"])]),
    "onehot_range": ([_const("s", _ints(0)), _const("l", _ints(4)),
                      _const("d", _ints(1)), node("r", "Range", ["s", "l", "d"]),
                      _const("depth", _ints(5)),
                      _const("on", np.asarray(2.0, np.float32)),
                      _const("off", np.asarray(-1.0, np.float32)),
                      node("y", "OneHot", ["r", "depth", "on", "off"])]),
    "einsum_addn": ([node("e", "Einsum", ["x", "x"],
                          equation=_attr("equation", s="ij,kj->ik")),
                     node("y", "AddN", ["e", "e", "e"])]),
    "cast_bool_int": ([_const("z", np.zeros(1, np.float32)),
                       node("b", "Greater", ["x", "z"]),
                       node("y", "Cast", ["b"], DstT=_attr("DstT", type_=3))]),
}
_TWO = ("all_any", "argmax_argmin", "topk", "split_splitv",
        "shape_size_rank_fill")


@pytest.mark.parametrize("case", sorted(_CASES))
def test_shape_index_and_reduction_mappers(case):
    outs = ["y", "i"] if case in _TWO else ["y"]
    g = graph_def(node("x", "Placeholder"), *_CASES[case])
    _assert_parity(*_both(g, {"x": _x((4, 6), seed=2)}, outs))


_IMAGE = {
    "depthwise": [_const("w", _x((3, 3, 4, 2), seed=5)),
                  node("y", "DepthwiseConv2dNative", ["x", "w"],
                       strides=_attr("strides", li=[1, 2, 2, 1]),
                       padding=_attr("padding", s="SAME"))],
    "conv_valid_strided": [_const("w", _x((2, 3, 4, 3), seed=6)),
                           node("y", "Conv2D", ["x", "w"],
                                strides=_attr("strides", li=[1, 2, 1, 1]),
                                padding=_attr("padding", s="VALID"))],
    "avgpool_same": [node("y", "AvgPool", ["x"],
                          ksize=_attr("ksize", li=[1, 3, 3, 1]),
                          strides=_attr("strides", li=[1, 2, 2, 1]),
                          padding=_attr("padding", s="SAME"))],
    "maxpool_same": [node("y", "MaxPool", ["x"],
                          ksize=_attr("ksize", li=[1, 2, 3, 1]),
                          strides=_attr("strides", li=[1, 2, 2, 1]),
                          padding=_attr("padding", s="SAME"))],
    "resize_bilinear_half_pixel": [
        _const("s", _ints([9, 4])),
        node("y", "ResizeBilinear", ["x", "s"],
             half_pixel_centers=_attr("half_pixel_centers", b=True))],
    "resize_bilinear_align": [
        _const("s", _ints([11, 9])),
        node("y", "ResizeBilinear", ["x", "s"],
             align_corners=_attr("align_corners", b=True))],
    "resize_nearest": [_const("s", _ints([14, 3])),
                       node("y", "ResizeNearestNeighbor", ["x", "s"])],
    "space_depth_round_trip": [
        node("d", "SpaceToDepth", ["x"], block_size=_attr("block_size", i=2)),
        node("y", "DepthToSpace", ["d"], block_size=_attr("block_size", i=2))],
    "space_to_batch_round_trip": [
        _const("b", _ints([2, 2])), _const("p", _ints([[1, 1], [0, 2]])),
        node("s", "SpaceToBatchND", ["x", "b", "p"]),
        node("y", "BatchToSpaceND", ["s", "b", "p"])],
    "fake_quant_args": [node("y", "FakeQuantWithMinMaxArgs", ["x"],
                             min=_attr("min", f=-1.0), max=_attr("max", f=1.5),
                             num_bits=_attr("num_bits", i=4))],
}


@pytest.mark.parametrize("case", sorted(_IMAGE))
def test_image_mappers(case):
    g = graph_def(node("x", "Placeholder"), *_IMAGE[case])
    _assert_parity(*_both(g, {"x": _x((2, 6, 8, 4), seed=3)}, ["y"]))
