"""The port's ComputationGraph (``nn/graph.py``), its vertices and builder
(``nn/conf/graph.py``), the graph half of the configuration builders and the
graph zip, against the JAX package, on shared numpy inputs.

- Each of the eleven vertex kinds (every ``ElementWiseVertex`` op) applies
  to the same inputs as the JAX vertex, with the same output type.
- A graph configuration's JSON reads and writes the same string in both
  packages, either way round.
- A two-input, two-output graph (``MergeVertex``, two ``OutputLayer``s)
  gives the JAX graph's ``output`` and ``score``, with per-output labels
  masks (a list, a dict, one array for every output).
- A small residual graph (16 x 16 x 3, widths 8, BatchNormalization,
  ``ElementWiseVertex(add)``) gives the JAX graph's ``output``, and three
  ``fit_batch`` steps with Nesterovs its params, BN state and updater
  state; the trained graph crosses the zip both ways.

Weights cross from the JAX graph through ``load_jax_params`` and
``load_jax_opt_state``, or the zip. Tolerance 1e-5 (f32, TF32 off; only
the order of f32 sums differs), as the MultiLayerNetwork parity tests.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import ActivationLayer as JaxActivation
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JaxBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JaxGlobalPool
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import ZeroPadding2DLayer as JaxZeroPad
from deeplearning4j_tpu.optimize.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.util.serialization import (
    restore_computation_graph as jax_restore,
)
from deeplearning4j_tpu.util.serialization import write_model as jax_write
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.nn.conf import preprocessors as ppre
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, ZeroPadding2DLayer,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.util.serialization import (
    restore_computation_graph, restore_model,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, **tol):
    """``port`` (tensors) against ``ref`` (arrays), same nesting."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _close(port[k], ref[k], **tol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b, **tol)
    else:
        np.testing.assert_allclose(port.detach().cpu().numpy(),
                                   np.asarray(ref), **(tol or TOL))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _port_of(jnet):
    """The port's graph from the JAX graph's JSON, params, state and
    updater state."""
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    assert conf.to_json() == jnet.conf.to_json()
    net = ComputationGraph(conf).init(device="cpu")
    load_jax_params(net, _np(jnet.params), _np(jnet.state))
    return load_jax_opt_state(net, _np(jnet.opt_state), jnet.step_count)


# ---------------------------------------------------------------- vertices

# (name, JAX vertex, port vertex, input shapes); one case per
# ElementWiseVertex op
VERTICES = [
    (f"elementwise_{op}", jgraph.ElementWiseVertex(op=op),
     pgraph.ElementWiseVertex(op=op), [(3, 4, 4, 5)] * 3)
    for op in ("add", "product", "mul", "average", "avg", "max")
] + [
    ("elementwise_subtract", jgraph.ElementWiseVertex(op="subtract"),
     pgraph.ElementWiseVertex(op="subtract"), [(3, 7)] * 2),
    ("merge", jgraph.MergeVertex(), pgraph.MergeVertex(),
     [(3, 4, 4, 5), (3, 4, 4, 2)]),
    ("subset", jgraph.SubsetVertex(from_idx=2, to_idx=5),
     pgraph.SubsetVertex(from_idx=2, to_idx=5), [(3, 9)]),
    ("scale", jgraph.ScaleVertex(scale=-2.5), pgraph.ScaleVertex(scale=-2.5),
     [(3, 6)]),
    ("shift", jgraph.ShiftVertex(shift=0.75), pgraph.ShiftVertex(shift=0.75),
     [(3, 6)]),
    ("stack", jgraph.StackVertex(), pgraph.StackVertex(), [(2, 6)] * 3),
    ("unstack", jgraph.UnstackVertex(from_idx=1, stack_size=3),
     pgraph.UnstackVertex(from_idx=1, stack_size=3), [(6, 5)]),
    ("l2_normalize", jgraph.L2NormalizeVertex(),
     pgraph.L2NormalizeVertex(), [(3, 8)]),
    ("reshape", jgraph.ReshapeVertex(shape=(2, 3, 4)),
     pgraph.ReshapeVertex(shape=(2, 3, 4)), [(5, 24)]),
    ("preprocessor",
     jgraph.PreprocessorVertex(preprocessor=jpre.CnnToRnnPreProcessor()),
     pgraph.PreprocessorVertex(preprocessor=ppre.CnnToRnnPreProcessor()),
     [(3, 4, 2, 5)]),
    ("layer", jgraph.LayerVertex(layer=JaxDense(n_out=5, activation="tanh")),
     pgraph.LayerVertex(layer=DenseLayer(n_out=5, activation="tanh")),
     [(3, 7)]),
]


def _itype(shape):
    if len(shape) == 4:
        return InputType.convolutional(*shape[1:]), \
            JaxInputType.convolutional(*shape[1:])
    if len(shape) == 3:
        return InputType.recurrent(shape[2], shape[1]), \
            JaxInputType.recurrent(shape[2], shape[1])
    return InputType.feed_forward(shape[1]), \
        JaxInputType.feed_forward(shape[1])


@pytest.mark.parametrize("name,jv,pv,shapes", VERTICES,
                         ids=[v[0] for v in VERTICES])
def test_vertex_matches_jax(name, jv, pv, shapes):
    xs = [_x(s, 10 + i) for i, s in enumerate(shapes)]
    ptypes, jtypes = zip(*(_itype(s) for s in shapes))
    jp, js = jv.init(jax.random.key(3), list(jtypes))
    want, _ = jv.apply(jp, js, [jax.numpy.asarray(x) for x in xs])
    pp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    got, _ = pv.apply(pp, {}, [torch.tensor(x) for x in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if name not in ("stack", "unstack"):  # batch-axis vertices keep types
        assert pv.output_type(list(ptypes)).to_dict() == \
            jv.output_type(list(jtypes)).to_dict()
    assert pgraph.vertex_to_dict(pv) == jgraph.vertex_to_dict(jv)
    assert pgraph.vertex_from_dict(jgraph.vertex_to_dict(jv)) == pv


def test_unknown_vertex_and_op_are_refused():
    with pytest.raises(ValueError, match="not ported"):
        pgraph.vertex_from_dict({"@vertex": "FrozenVertex"})
    with pytest.raises(ValueError, match="unknown ElementWiseVertex op"):
        pgraph.ElementWiseVertex(op="pow").apply({}, {}, [torch.ones(2)])


# ------------------------------------------------------- the configuration

def _two_io_builder(nnc, inputs, layers, vertices):
    """Two inputs (a and b), MergeVertex, two outputs (cls: softmax over 4,
    reg: identity MSE over 3), through either package's builder."""
    Dense, Output = layers
    Merge, Scale = vertices
    g = (nnc.builder().seed(5).updater(inputs["updater"])
         .graph_builder().add_inputs("a", "b")
         .set_input_types(a=inputs["ff"](6), b=inputs["ff"](5)))
    g.add_layer("da", Dense(n_out=8, activation="relu"), "a")
    g.add_layer("db", Dense(n_out=4, activation="tanh"), "b")
    g.add_vertex("merge", Merge(), "da", "db")
    g.add_vertex("scaled", Scale(scale=0.5), "merge")
    g.add_layer("cls", Output(n_out=4, activation="softmax", loss="mcxent"),
                "merge")
    g.add_layer("reg", Output(n_out=3, activation="identity", loss="mse"),
                "scaled")
    return g.set_outputs("cls", "reg").build()


def _jax_two_io():
    return _two_io_builder(
        JaxNNC, {"updater": JaxNesterovs(lr=1e-2, momentum=0.9),
                 "ff": JaxInputType.feed_forward},
        (JaxDense, JaxOutput), (jgraph.MergeVertex, jgraph.ScaleVertex))


def _port_two_io():
    return _two_io_builder(
        NeuralNetConfiguration, {"updater": Nesterovs(lr=1e-2, momentum=0.9),
                                 "ff": InputType.feed_forward},
        (DenseLayer, OutputLayer), (pgraph.MergeVertex, pgraph.ScaleVertex))


def _residual_builder(nnc, updater, itype, L, EW):
    """16 x 16 x 3, widths 8: conv-bn-relu stem, a zero pad and a valid
    conv, a residual block (conv-bn-relu, conv-bn, add, relu), global
    average pooling, softmax over 5."""
    Conv, BN, Act, Pad, Pool, Output = L
    g = (nnc.builder().seed(7).updater(updater).graph_builder()
         .add_inputs("in").set_input_types(**{"in": itype(16, 16, 3)}))
    g.add_layer("c0", Conv(n_out=8, kernel=(3, 3), strides=(2, 2),
                           padding="same", has_bias=False), "in")
    g.add_layer("bn0", BN(), "c0")
    g.add_layer("r0", Act(activation="relu"), "bn0")
    g.add_layer("pad", Pad(pad=(1, 1)), "r0")
    g.add_layer("c1", Conv(n_out=8, kernel=(3, 3), padding="truncate",
                           has_bias=False), "pad")
    g.add_layer("bn1", BN(), "c1")
    g.add_layer("r1", Act(activation="relu"), "bn1")
    g.add_layer("c2", Conv(n_out=8, kernel=(3, 3), padding="same",
                           has_bias=False), "r1")
    g.add_layer("bn2", BN(decay=0.8), "c2")
    g.add_vertex("add", EW(op="add"), "bn2", "r0")
    g.add_layer("r2", Act(activation="relu"), "add")
    g.add_layer("pool", Pool(pooling_type="avg"), "r2")
    g.add_layer("out", Output(n_out=5, activation="softmax", loss="mcxent"),
                "pool")
    return g.set_outputs("out").build()


def _jax_residual():
    return _residual_builder(
        JaxNNC, JaxNesterovs(lr=1e-2, momentum=0.9),
        JaxInputType.convolutional,
        (JaxConv, JaxBN, JaxActivation, JaxZeroPad, JaxGlobalPool, JaxOutput),
        jgraph.ElementWiseVertex)


def _port_residual():
    return _residual_builder(
        NeuralNetConfiguration, Nesterovs(lr=1e-2, momentum=0.9),
        InputType.convolutional,
        (ConvolutionLayer, BatchNormalizationLayer, ActivationLayer,
         ZeroPadding2DLayer, GlobalPoolingLayer, OutputLayer),
        pgraph.ElementWiseVertex)


@pytest.mark.parametrize("make", ["two_io", "residual"])
def test_config_json_reads_and_writes_as_jax(make):
    jconf, pconf = {"two_io": (_jax_two_io, _port_two_io),
                    "residual": (_jax_residual, _port_residual)}[make]
    jconf, pconf = jconf(), pconf()
    s = jconf.to_json()
    # the port's builder writes the JAX builder's JSON
    assert pconf.to_json() == s
    # JAX writes, the port reads and writes the same string, and back
    back = ComputationGraphConfiguration.from_json(s)
    assert back.to_json() == s
    assert type(jconf).from_json(back.to_json()).to_json() == s
    assert back.topological_order == jconf.topological_order
    assert {k: v.to_dict() for k, v in back.vertex_output_types.items()} == \
        {k: v.to_dict() for k, v in jconf.vertex_output_types.items()}


def test_resolve_refuses_a_cycle():
    g = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(**{"in": InputType.feed_forward(3)}))
    g.add_layer("a", DenseLayer(n_out=3), "in", "b")
    g.add_layer("b", DenseLayer(n_out=3), "a")
    g.set_outputs("b")
    with pytest.raises(ValueError, match="cycle"):
        g.build()


def test_resolve_inserts_the_preprocessor_a_layer_needs():
    """A dense layer after a conv layer gets the JAX package's automatic
    flatten, recorded in the JSON."""
    def conf(nnc, itype, Conv, Dense, Output):
        g = (nnc.builder().graph_builder().add_inputs("in")
             .set_input_types(**{"in": itype(4, 4, 2)}))
        g.add_layer("c", Conv(n_out=3, kernel=(3, 3)), "in")
        g.add_layer("d", Dense(n_out=4), "c")
        g.add_layer("o", Output(n_out=2), "d")
        return g.set_outputs("o").build()

    p = conf(NeuralNetConfiguration, InputType.convolutional,
             ConvolutionLayer, DenseLayer, OutputLayer)
    j = conf(JaxNNC, JaxInputType.convolutional, JaxConv, JaxDense,
             JaxOutput)
    assert "d" in p.preprocessors and p.to_json() == j.to_json()
    jn = JaxGraph(j).init()
    net = _port_of(jn)
    x = _x((3, 4, 4, 2), 1)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jn.output(x)), **TOL)


# ------------------------------------------------ two inputs, two outputs

def _two_io_batch(seed, B=6):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, 6)).astype(np.float32)
    b = rng.normal(size=(B, 5)).astype(np.float32)
    cls = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    reg = rng.normal(size=(B, 3)).astype(np.float32)
    return a, b, cls, reg


def test_two_inputs_two_outputs_output_matches_jax():
    jn = JaxGraph(_jax_two_io()).init()
    net = _port_of(jn)
    a, b, _, _ = _two_io_batch(0)
    jc, jr = jn.output(a, b)
    pc, pr = net.output(a, b)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **TOL)
    # a dict of inputs by name is the same call
    pd = net.output({"a": a, "b": b})
    assert torch.equal(pd[0], pc) and torch.equal(pd[1], pr)


LABEL_MASKS = {
    "none": None,
    "list": lambda m: [m[0], m[1]],
    "dict_one_output": lambda m: {"reg": m[1]},
    "one_array": lambda m: m[0],
}


@pytest.mark.parametrize("case", list(LABEL_MASKS))
def test_two_outputs_score_with_label_masks_matches_jax(case):
    jn = JaxGraph(_jax_two_io()).init()
    net = _port_of(jn)
    a, b, cls, reg = _two_io_batch(1)
    masks = (np.array([1, 1, 0, 1, 0, 1], np.float32),
             np.array([[1], [0], [1], [1], [1], [0]], np.float32))
    lm = LABEL_MASKS[case]
    lm = None if lm is None else lm(masks)
    ds = ([a, b], [cls, reg], None, lm)
    np.testing.assert_allclose(net.score(ds), float(jn.score(ds)), **TOL)


def test_label_masks_are_checked():
    net = ComputationGraph(_port_two_io()).init(device="cpu")
    a, b, cls, reg = _two_io_batch(2)
    with pytest.raises(ValueError, match="not network outputs"):
        net.score(([a, b], [cls, reg], None, {"nope": np.ones(6)}))
    with pytest.raises(ValueError, match="entries for 2 network outputs"):
        net.score(([a, b], [cls, reg], None, [np.ones(6)]))
    with pytest.raises(ValueError, match="not per-example"):
        net.score(([a, b], [cls, reg], None, {"cls": np.ones((6, 2))}))


def test_two_outputs_fit_batch_matches_jax():
    jn = JaxGraph(_jax_two_io()).init()
    net = _port_of(jn)
    for seed in range(3):
        a, b, cls, reg = _two_io_batch(10 + seed)
        lj = jn.fit_batch(([a, b], {"cls": cls, "reg": reg}))
        lp = net.fit_batch(([a, b], {"cls": cls, "reg": reg}))
        np.testing.assert_allclose(lp, float(lj), **TOL)
    _close(net.params, _np(jn.params))
    _close(net.opt_state, _np(jn.opt_state))


# ------------------------------------------------------ the residual graph

def _images(seed, B=4, classes=5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, 16, 16, 3)) * 2.0 + 0.5).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)]
    return x, y


def test_residual_graph_output_matches_jax():
    jn = JaxGraph(_jax_residual()).init()
    net = _port_of(jn)
    x, _ = _images(0)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jn.output(x)), **TOL)


@pytest.fixture
def trained():
    """The residual graph after three fit_batch steps in both packages."""
    jn = JaxGraph(_jax_residual()).init()
    net = _port_of(jn)
    before = {k: {s: v.clone() for s, v in d.items()}
              for k, d in net.state.items()}
    losses = []
    for seed in range(3):
        x, y = _images(20 + seed)
        losses.append((float(jn.fit_batch((x, y))), net.fit_batch((x, y))))
    return jn, net, before, losses


def test_residual_graph_three_steps_match_jax(trained):
    jn, net, before, losses = trained
    for lj, lp in losses:
        np.testing.assert_allclose(lp, lj, **TOL)
    _close(net.params, _np(jn.params))
    _close(net.state, _np(jn.state))
    _close(net.opt_state, _np(jn.opt_state))
    assert net.step_count == jn.step_count == 3
    # the running statistics of every BN vertex moved, and carry no graph
    assert set(net.state) == {"bn0", "bn1", "bn2"}
    for k, s in net.state.items():
        assert not torch.equal(s["mean"], before[k]["mean"])
        assert not s["var"].requires_grad
    x, _ = _images(7)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jn.output(x)), **TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_residual_graph_crosses_the_zip(trained, tmp_path, writer):
    jn, net, _, _ = trained
    path = str(tmp_path / "graph.zip")
    x, y = _images(8)
    if writer == "jax":
        jax_write(jn, path)
        back = restore_computation_graph(path, device="cpu")
        assert isinstance(restore_model(path, device="cpu"), ComputationGraph)
        _close(back.params, _np(jn.params))
        _close(back.state, _np(jn.state))
        _close(back.opt_state, _np(jn.opt_state))
        assert back.step_count == 3
        # training goes on where the JAX graph stopped
        np.testing.assert_allclose(back.fit_batch((x, y)),
                                   float(jn.fit_batch((x, y))), **TOL)
        _close(back.params, _np(jn.params))
    else:
        net.save(path)
        back = jax_restore(path)
        _close(net.params, _np(back.params))
        _close(net.state, _np(back.state))
        _close(net.opt_state, _np(back.opt_state))
        assert back.step_count == 3
        np.testing.assert_allclose(
            np.asarray(back.output(x)), net.output(x).numpy(), **TOL)


def test_restore_refuses_the_other_model_class(tmp_path):
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_multi_layer_network,
    )

    net = ComputationGraph(_port_residual()).init(device="cpu")
    path = str(tmp_path / "g.zip")
    net.save(path)
    with pytest.raises(ValueError, match="not a MultiLayerNetwork"):
        restore_multi_layer_network(path, device="cpu")
    back = ComputationGraph.load(path, device="cpu")
    _close(back.params, {k: {s: v.numpy() for s, v in d.items()}
                         for k, d in net.params.items()})


def test_frozen_vertex_keeps_its_params():
    """A vertex whose layer is not trainable takes NoOp, as in the JAX
    graph; the rest train."""
    conf = _port_residual()
    conf.vertices["c2"] = pgraph.LayerVertex(
        layer=dataclasses.replace(conf.vertices["c2"].layer, trainable=False))
    net = ComputationGraph(conf).init(device="cpu")
    w, w0 = net.params["c2"]["W"].clone(), net.params["c0"]["W"].clone()
    net.fit_batch(_images(3))
    assert torch.equal(net.params["c2"]["W"], w)
    assert not torch.equal(net.params["c0"]["W"], w0)


def test_graph_entry_points_run_on_the_card_by_default():
    net = ComputationGraph(_port_residual())
    if torch.cuda.is_available():
        pytest.skip("the card is present: init() takes it")
    with pytest.raises(RuntimeError):
        net.init()
