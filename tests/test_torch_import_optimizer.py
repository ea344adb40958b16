"""The port's import-graph optimizer (``deeplearning4j_tpu_torch/
modelimport/optimizer.py``) against the JAX package's.

The graph logic is the JAX package's, numpy for numpy, so both packages
rewrite a graph identically. For each rule case of
``tests/test_import_optimizer.py`` (ONNX and TF) and for every committed
import fixture, the port's per-rule counts (``import_opt_stats``) equal the
JAX package's exactly, and so does ``graph_signature`` (node count and a
hash of ops, names and edges), raw and optimized; the optimized graph's
outputs equal the raw graph's. ``bert_tiny.onnx`` goes 215 -> 115 nodes.
The fused attention runs through the port's registry
``dot_product_attention`` with the exporter's mask as ``bias``, which the
flash kernels refuse. The escape hatch (``optimize=False``,
``DL4J_TORCH_IMPORT_OPT=0``) restores the raw parse. The port counts the
rewrites on ``import_opt_stats`` and, with monitoring on, in
``dl4j_import_opt_rewrites_total`` (``tests/test_torch_monitoring.py``).
``prune_keras_layers``, the Keras frontend's layer pass, is
held against the JAX function on its own (Keras import waits for A3).
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import optimizer as jax_opt
from deeplearning4j_tpu.modelimport.onnx import OnnxModelImport as JaxOnnx
from deeplearning4j_tpu.modelimport.tensorflow import TFGraphMapper as JaxTF
from deeplearning4j_tpu_torch.modelimport import optimizer as graph_opt
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxModelImport
from deeplearning4j_tpu_torch.modelimport.tensorflow import TFGraphMapper
from test_import_optimizer import _shape_attr, _tf_bert_block
from test_onnximport import onnx_attr, onnx_model, onnx_node, onnx_tensor
from test_tfimport import _attr, graph_def, node

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = dict(rtol=1e-5, atol=1e-6)


def _fx(name):
    return os.path.join(FIXTURES, name)


def _onnx_pair(model, optimize=True):
    port = OnnxModelImport.import_model(model, optimize=optimize,
                                        device="cpu")
    return port, JaxOnnx.import_model(model, optimize=optimize)


def _tf_pair(g, optimize=True):
    return (TFGraphMapper.import_graph(g, optimize=optimize, device="cpu"),
            JaxTF.import_graph(g, optimize=optimize))


def _tf_rewrites_match(g):
    """The optimized pair, after checking that both packages rewrite ``g``
    alike and parse it alike raw."""
    _same_rewrite(*_tf_pair(g, optimize=False))
    port, jimp = _tf_pair(g)
    _same_rewrite(port, jimp)
    return port, jimp


def _same_rewrite(port, jax_imp):
    assert port.import_opt_stats == jax_imp.import_opt_stats
    assert graph_opt.graph_signature(port) == \
        jax_opt.graph_signature(jax_imp)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ----------------------------------------------------------- ONNX rules

def _rule_identity(rng):
    return onnx_model([onnx_node("Identity", ["x"], ["a"]),
                       onnx_node("Identity", ["a"], ["b"]),
                       onnx_node("Relu", ["b"], ["y"])], [], ["x"], ["y"])


def _rule_fold(rng):
    return onnx_model([onnx_node("Add", ["c1", "c1"], ["c2"]),
                       onnx_node("Mul", ["w", "w"], ["w2"]),
                       onnx_node("Relu", ["x"], ["y"])],
                      [onnx_tensor("c1", np.asarray([2], np.int64)),
                       onnx_tensor("w", rng.normal(size=(3, 3)).astype(
                           np.float32))], ["x"], ["y", "c2", "w2"])


def _rule_transpose(perm1, perm2):
    def build(rng):
        return onnx_model([onnx_node("Transpose", ["x"], ["t1"],
                                     onnx_attr("perm", ints=perm1)),
                           onnx_node("Transpose", ["t1"], ["t2"],
                                     onnx_attr("perm", ints=perm2)),
                           onnx_node("Relu", ["t2"], ["y"])], [], ["x"], ["y"])
    return build


def _rule_reshape(rng):
    return onnx_model([onnx_node("Reshape", ["x", "s1"], ["r1"]),
                       onnx_node("Reshape", ["r1", "s2"], ["r2"]),
                       onnx_node("Relu", ["r2"], ["y"])],
                      [onnx_tensor("s1", np.asarray([3, 4], np.int64)),
                       onnx_tensor("s2", np.asarray([4, 3], np.int64))],
                      ["x"], ["y"])


def _rule_unsqueeze(rng):
    return onnx_model([onnx_node("Unsqueeze", ["x", "ax"], ["u"]),
                       onnx_node("Squeeze", ["u", "ax"], ["s"]),
                       onnx_node("Relu", ["s"], ["y"])],
                      [onnx_tensor("ax", np.asarray([1], np.int64))],
                      ["x"], ["y"])


def _rule_cast(rng):
    return onnx_model([onnx_node("Greater", ["x", "x"], ["g"]),
                       onnx_node("Cast", ["g"], ["c1"], onnx_attr("to", i=9)),
                       onnx_node("Cast", ["c1"], ["c2"], onnx_attr("to", i=1)),
                       onnx_node("Cast", ["c2"], ["c3"],
                                 onnx_attr("to", i=1))], [], ["x"], ["c3"])


def _rule_dce(rng):
    return onnx_model([onnx_node("Relu", ["x"], ["y"]),
                       onnx_node("Sigmoid", ["x"], ["dead1"]),
                       onnx_node("Tanh", ["dead1"], ["dead2"])],
                      [], ["x"], ["y"])


# name: (builder, x shape, the rule it exercises, its count)
ONNX_RULES = {
    "identity_chain": (_rule_identity, (2, 3), "identity", 2),
    "constant_folding_keeps_params": (_rule_fold, (2, 3), "fold_constants",
                                      1),
    "transpose_pair_cancels": (_rule_transpose([2, 0, 1], [1, 2, 0]),
                               (2, 3, 4), "transpose_pairs", 1),
    "transpose_pair_composes": (_rule_transpose([1, 0, 2], [0, 2, 1]),
                                (2, 3, 4), "transpose_pairs", 1),
    "reshape_chain": (_rule_reshape, (2, 6), "reshape_chains", 1),
    "unsqueeze_squeeze": (_rule_unsqueeze, (2, 3), "expand_squeeze", 1),
    "noop_cast": (_rule_cast, (2, 3), "noop_cast", 1),
    "dce": (_rule_dce, (2, 3), "dce", 2),
}


@pytest.mark.parametrize("case", sorted(ONNX_RULES))
def test_onnx_rule_matches_jax(case, rng):
    build, shape, rule, count = ONNX_RULES[case]
    model = build(rng)
    port, jimp = _onnx_pair(model)
    _same_rewrite(port, jimp)
    assert port.import_opt_stats[rule] == count
    raw, jraw = _onnx_pair(model, optimize=False)
    _same_rewrite(raw, jraw)
    assert [n.op for n in port.nodes] == [n.op for n in jimp.nodes]
    x = rng.normal(size=shape).astype(np.float32)
    for o in port.graph_outputs:
        a, b, c = (_np(g.output({"x": x}, [o])) for g in (port, raw, jimp))
        np.testing.assert_allclose(a, c, **TOL)
        np.testing.assert_allclose(a, b, **TOL)


def test_onnx_eliminated_names_stay_probeable(rng):
    port = OnnxModelImport.import_model(_rule_identity(rng), device="cpu")
    x = rng.normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_allclose(port.output({"x": x}, outputs=["a"]).numpy(), x)
    dce = OnnxModelImport.import_model(_rule_dce(rng), device="cpu")
    with pytest.raises(KeyError, match="DL4J_TORCH_IMPORT_OPT"):
        dce.output({"x": x}, outputs=["dead2"])


def test_onnx_folding_keeps_float_params(rng):
    port = OnnxModelImport.import_model(_rule_fold(rng), device="cpu")
    np.testing.assert_array_equal(port._folded["c2"], [4])
    assert any(n.op == "Mul" for n in port.nodes)


# ------------------------------------------------------------- TF rules

def test_tf_identity_and_alias(rng):
    g = graph_def(node("x", "Placeholder"), node("i1", "Identity", ["x"]),
                  node("i2", "StopGradient", ["i1"]),
                  node("y", "Relu", ["i2"]))
    port, jimp = _tf_rewrites_match(g)
    assert port.import_opt_stats["identity"] == 2
    assert "i1" not in port.nodes and "i2" not in port.nodes
    x = rng.normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_allclose(port.output({"x": x}, ["y"]).numpy(),
                               np.maximum(x, 0))
    np.testing.assert_allclose(port.output({"x": x}, ["i2"]).numpy(), x)


@pytest.mark.parametrize("with_shape", [True, False])
def test_tf_fuse_attention_rank4(rng, with_shape):
    g, q, _, _ = _tf_bert_block(rng, with_shape=with_shape)
    port, jimp = _tf_rewrites_match(g)
    assert port.import_opt_stats["fuse_attention"] == int(with_shape)
    raw = TFGraphMapper.import_graph(g, optimize=False, device="cpu")
    feeds = {"q": q, "k": q + 0.1, "v": q - 0.1}
    got = port.output(feeds, ["ctx"]).numpy()
    np.testing.assert_allclose(got, raw.output(feeds, ["ctx"]).numpy(),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(jimp.output(feeds, ["ctx"])),
                               **TOL)


def test_tf_no_dce_without_known_outputs(rng):
    g = graph_def(node("x", "Placeholder"), node("branch", "Sigmoid", ["x"]),
                  node("y", "Relu", ["x"]))
    port, jimp = _tf_rewrites_match(g)
    assert port.import_opt_stats["dce"] == 0
    x = rng.normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_allclose(port.output({"x": x}, ["branch"]).numpy(),
                               1.0 / (1.0 + np.exp(-x)), rtol=1e-6)


def test_tf_shape_arithmetic_folds(rng):
    """Shape of a statically shaped placeholder folds, and the arithmetic
    over it with it (the exporter's scale chains)."""
    g = graph_def(
        node("x", "Placeholder", shape=_shape_attr("shape", (2, 3, 16))),
        node("s", "Shape", ["x"]),
        node("b", "Const", value=_attr("value", t=np.asarray([2], np.int32))),
        node("e", "Const", value=_attr("value", t=np.asarray([3], np.int32))),
        node("one", "Const", value=_attr("value",
                                         t=np.asarray([1], np.int32))),
        node("d", "StridedSlice", ["s", "b", "e", "one"]),
        node("df", "Cast", ["d"], DstT=_attr("DstT", type_=1)),
        node("r", "Sqrt", ["df"]),
        node("y", "RealDiv", ["x", "r"]))
    port, jimp = _tf_rewrites_match(g)
    assert port.import_opt_stats["fold_constants"] >= 4
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(port.output({"x": x}, ["y"]).numpy(), x / 4,
                               **TOL)


# ---------------------------------------------------- every import fixture

def _load(kind, name, optimize):
    if kind == "onnx":
        return (OnnxModelImport.import_model(_fx(name), optimize=optimize,
                                             device="cpu"),
                JaxOnnx.import_model(_fx(name), optimize=optimize))
    if kind == "saved_model":
        return (TFGraphMapper.import_saved_model(_fx(name), optimize=optimize,
                                                 device="cpu"),
                JaxTF.import_saved_model(_fx(name), optimize=optimize))
    return (TFGraphMapper.import_graph(_fx(name), optimize=optimize,
                                       device="cpu"),
            JaxTF.import_graph(_fx(name), optimize=optimize))


FIXTURE_GRAPHS = [("onnx", "bert_tiny.onnx"), ("tf", "tf_small_cnn.pb"),
                  ("tf", "ctrl_flow_v2.pb"), ("tf", "switch_merge.pb"),
                  ("tf", "quant_graph.pb"), ("saved_model", "saved_model_cnn")]


@pytest.mark.parametrize("kind,name", FIXTURE_GRAPHS)
@pytest.mark.parametrize("optimize", [True, False])
def test_fixture_rewrites_match_jax(kind, name, optimize):
    port, jimp = _load(kind, name, optimize)
    _same_rewrite(port, jimp)
    if not optimize:
        assert port.import_opt_stats is None


def test_bert_tiny_rewrite_counts():
    port = OnnxModelImport.import_model(_fx("bert_tiny.onnx"), device="cpu")
    raw = OnnxModelImport.import_model(_fx("bert_tiny.onnx"), optimize=False,
                                       device="cpu")
    assert graph_opt.graph_signature(raw)[0] == 215
    assert graph_opt.graph_signature(port)[0] == 115
    assert {k: v for k, v in port.import_opt_stats.items() if v} == {
        "fold_constants": 68, "identity": 20, "noop_cast": 1,
        "fuse_attention": 2, "drop_broadcast": 1, "dce": 12}


# ---------------------------------------------- on/off golden equivalence

def test_onnx_bert_on_off():
    g = np.load(_fx("bert_golden.npz"))
    feeds = {"input_ids": g["ids"], "attention_mask": g["mask"]}
    outs = ["last_hidden_state", "pooler_output"]
    on = OnnxModelImport.import_model(_fx("bert_tiny.onnx"), device="cpu")
    off = OnnxModelImport.import_model(_fx("bert_tiny.onnx"), optimize=False,
                                       device="cpu")
    for a, b in zip(on.output(feeds, outs), off.output(feeds, outs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_tf_fixtures_on_off():
    g = np.load(_fx("tf_small_cnn_golden.npz"))
    probe = [str(p) for p in g["probe"]]
    feeds = {str(g["placeholder"]): g["x"]}
    on, off = (TFGraphMapper.import_graph(_fx("tf_small_cnn.pb"),
                                          optimize=o, device="cpu")
               for o in (True, False))
    for a, b in zip(on.output(feeds, probe), off.output(feeds, probe)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    c = np.load(_fx("ctrl_golden.npz"))
    on, off = (TFGraphMapper.import_graph(_fx("ctrl_flow_v2.pb"), optimize=o,
                                          device="cpu") for o in (True, False))
    ph = on.placeholders[0]
    for sign in (1, -1):
        x = sign * np.abs(c["x"])
        np.testing.assert_allclose(on.output({ph: x}).numpy(),
                                   off.output({ph: x}).numpy(), rtol=1e-6,
                                   atol=1e-6)
    s = np.load(_fx("saved_model_cnn_golden.npz"))
    on, off = (TFGraphMapper.import_saved_model(_fx("saved_model_cnn"),
                                                optimize=o, device="cpu")
               for o in (True, False))
    np.testing.assert_allclose(
        on.run_signature({"input": s["x"]})["output"].numpy(),
        off.run_signature({"input": s["x"]})["output"].numpy(),
        rtol=1e-6, atol=1e-6)


def test_bert_as_trainable_on_off():
    """Import-then-train keeps the same parameter set, outputs and
    gradients with the pass on or off."""
    g = np.load(_fx("bert_golden.npz"))
    feeds = {"input_ids": g["ids"], "attention_mask": g["mask"]}
    grads, outs = [], []
    for opt in (True, False):
        imp = OnnxModelImport.import_model(_fx("bert_tiny.onnx"),
                                           optimize=opt, device="cpu")
        fn, params = imp.as_trainable(outputs=["pooler_output"])
        p = {k: v.requires_grad_() for k, v in params.items()}
        out = fn(p, feeds)
        outs.append(out.detach().numpy())
        grads.append(dict(zip(p, torch.autograd.grad(out.sum(),
                                                     list(p.values())))))
    assert set(grads[0]) == set(grads[1])
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
    for k in grads[0]:
        np.testing.assert_allclose(grads[0][k].numpy(), grads[1][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------ the attention's route

def test_bert_routes_through_registry_attention():
    """The fused nodes carry q/k/v, the mask and the peeled 1/sqrt(16)
    scale, and executing them calls the registry's dot_product_attention
    (its plain lowering on the CPU) once per layer at [2, 4, 16, 16]."""
    from deeplearning4j_tpu_torch.ops.registry import get_op

    g = np.load(_fx("bert_golden.npz"))
    imp = OnnxModelImport.import_model(_fx("bert_tiny.onnx"), device="cpu")
    fused = [n for n in imp.nodes if n.op == graph_opt.FUSED_ATTENTION_OP]
    assert len(fused) == 2
    for n in fused:
        assert len(n.inputs) == 4 and abs(n.scale - 0.25) < 1e-6
    impl = get_op("dot_product_attention").plain
    calls, orig = [], impl.fn

    def spy(*a, **kw):
        calls.append((tuple(tuple(x.shape) for x in a[:3]),
                      kw.get("bias") is not None))
        return orig(*a, **kw)

    impl.fn = spy
    try:
        imp.output({"input_ids": g["ids"], "attention_mask": g["mask"]},
                   outputs=["pooler_output"])
    finally:
        impl.fn = orig
    assert calls == [(((2, 4, 16, 16),) * 3, True)] * 2


class _OnCard(torch.Tensor):
    """A meta tensor that reports itself on the card."""

    @property
    def is_cuda(self):
        return True


def test_bias_call_takes_the_plain_lowering_on_the_card():
    """The flash kernels refuse an additive bias, so the registry sends the
    fused attention of an imported graph to the plain lowering on the card
    too (the JAX package sends it to XLA)."""
    from deeplearning4j_tpu_torch.ops.cuda import flash_attention as fa

    def card(*shape):
        return torch.empty(shape, device="meta").as_subclass(_OnCard)

    q, bias = card(1, 1, 2048, 64), card(1, 1, 1, 2048)
    assert fa._cuda_requires(q, q, q)
    assert not fa._cuda_requires(q, q, q, bias=bias)


def test_fused_bias_numerics(rng):
    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention

    B, H, T, D = 2, 2, 5, 4
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    bias = np.where(rng.random((B, 1, 1, T)) < 0.3, -1e9, 0.0
                    ).astype(np.float32)
    got = dot_product_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                                bias=torch.as_tensor(bias), scale=0.5).numpy()
    logits = (q @ np.swapaxes(k, -1, -2)) * 0.5 + bias
    e = np.exp(logits - logits.max(-1, keepdims=True))
    np.testing.assert_allclose(got, (e / e.sum(-1, keepdims=True)) @ v,
                               **TOL)


# --------------------------------------------------------- escape hatch

def test_env_flag_off_is_raw_parse_onnx(monkeypatch):
    from deeplearning4j_tpu_torch.common.env import env

    explicit = OnnxModelImport.import_model(_fx("bert_tiny.onnx"),
                                            optimize=False, device="cpu")
    monkeypatch.setattr(env, "import_opt", False)
    via_env = OnnxModelImport.import_model(_fx("bert_tiny.onnx"),
                                           device="cpu")
    assert graph_opt.graph_signature(via_env) == \
        graph_opt.graph_signature(explicit)
    assert via_env.import_opt_stats is None
    assert not via_env._folded and not via_env._aliases
    monkeypatch.setattr(env, "import_opt", True)
    on = OnnxModelImport.import_model(_fx("bert_tiny.onnx"), device="cpu")
    assert graph_opt.graph_signature(on)[0] < \
        graph_opt.graph_signature(explicit)[0]


def test_env_flag_off_is_raw_parse_tf(monkeypatch):
    from deeplearning4j_tpu_torch.common.env import env

    explicit = TFGraphMapper.import_graph(_fx("tf_small_cnn.pb"),
                                          optimize=False, device="cpu")
    monkeypatch.setattr(env, "import_opt", False)
    via_env = TFGraphMapper.import_graph(_fx("tf_small_cnn.pb"), device="cpu")
    assert graph_opt.graph_signature(via_env) == \
        graph_opt.graph_signature(explicit)
    assert not via_env.folded and not via_env.aliases


def test_env_var_reaches_the_flag(monkeypatch):
    from deeplearning4j_tpu_torch.common.env import Environment

    monkeypatch.setenv("DL4J_TORCH_IMPORT_OPT", "0")
    assert Environment().import_opt is False
    monkeypatch.delenv("DL4J_TORCH_IMPORT_OPT")
    assert Environment().import_opt is True


# ------------------------------------------------------ keras layer pass

def _keras_layers():
    return [
        {"class_name": "InputLayer", "name": "in",
         "config": {"name": "in", "batch_input_shape": [None, 6]},
         "inbound_nodes": []},
        {"class_name": "Dense", "config": {"name": "dense", "units": 8},
         "inbound_nodes": [[["in", 0, 0, {}]]]},
        {"class_name": "Dropout", "config": {"name": "drop", "rate": 0.0},
         "inbound_nodes": [[["dense", 0, 0, {}]]]},
        {"class_name": "Activation",
         "config": {"name": "act", "activation": "linear"},
         "inbound_nodes": [[["drop", 0, 0, {}]]]},
        {"class_name": "Dropout", "config": {"name": "drop2", "rate": 0.5},
         "inbound_nodes": [[["act", 0, 0, {}]]]},
        {"class_name": "SpatialDropout2D",
         "config": {"name": "sdrop", "rate": 0.0},
         "inbound_nodes": [[["drop2", 0, 0, {}]]]},
        {"class_name": "Dense", "config": {"name": "out", "units": 3},
         "inbound_nodes": [[["sdrop", 0, 0, {}]]]},
        {"class_name": "Activation",
         "config": {"name": "final", "activation": "linear"},
         "inbound_nodes": [[["out", 0, 0, {}]]]},
    ]


@pytest.mark.parametrize("graph", [True, False])
def test_prune_keras_layers_matches_jax(graph):
    kept, stats = graph_opt.prune_keras_layers(_keras_layers(), graph=graph,
                                               outputs=["final"])
    jkept, jstats = jax_opt.prune_keras_layers(_keras_layers(), graph=graph,
                                               outputs=["final"])
    assert kept == jkept and stats == jstats
    assert stats == {"noop_dropout": 2, "identity_layer": 1}
    names = [lc["config"]["name"] for lc in kept]
    assert names == ["in", "dense", "drop2", "out", "final"]
    if graph:   # consumers rewired past the dropped layers
        assert kept[2]["inbound_nodes"][0][0][0] == "dense"
        assert kept[3]["inbound_nodes"][0][0][0] == "drop2"
