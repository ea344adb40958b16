"""The port's CNN zoo against the JAX package's.

- Every model of the slice (SimpleCNN, VGG16, VGG19, Darknet19, TinyYOLO,
  YOLO2, SqueezeNet, Xception, UNet, InceptionResNetV1, NASNet) at its
  full-width defaults writes the JAX package's configuration JSON, which
  reads back to the same string; no weights are built.
- Each at a tiny size (a small image, narrow or shallow where the model
  has the knob; dropout off so the two packages' masks do not differ),
  f32, on the JAX net's weights through ``load_jax_params``:
  ``output()`` at B = 2 within 1e-5 of the largest output, and one
  ``fit_batch`` step's loss within 1e-4 (relative; the step's
  training-mode BatchNormalizations normalize by a few values a channel
  at these sizes, which amplifies f32 rounding). InceptionResNetV1 trains
  its center-loss head, centers included; the centers after the step are
  held within 1e-5.
- ``ZooModel.init`` builds each on the CPU and its zip restores.
- ``chip_smoke.forward_flops``, the graph counter of phases 21 and 27,
  gives ResNet-50 the earlier counter's count and YOLO2 its 62.94 GFLOP
  an image, and counts each conv kind by hand on a small net.

YOLO2 at full depth is held in ``test_torch_objdetect.py``.
"""

import json

import chip_smoke
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.zoo as jax_zoo
from deeplearning4j_tpu.nn.conf.builders import (
    ComputationGraphConfiguration as JaxCGConf,
    MultiLayerConfiguration as JaxMLConf,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
import deeplearning4j_tpu_torch.zoo as port_zoo
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    Convolution1DLayer, Convolution3DLayer, Deconvolution2DLayer,
    DepthwiseConvolution2DLayer, OutputLayer, SeparableConvolution2DLayer,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)

TOL_OUT = 1e-5    # of the largest output
TOL_LOSS = 1e-4   # relative
TOL_STATE = dict(atol=1e-5, rtol=1e-5)

MODELS = ["SimpleCNN", "VGG16", "VGG19", "Darknet19", "TinyYOLO", "YOLO2",
          "SqueezeNet", "Xception", "UNet", "InceptionResNetV1", "NASNet"]

# tiny configurations, f32
TINY = {
    "SimpleCNN": dict(height=16, width=16, num_classes=4),
    "VGG16": dict(height=32, width=32, num_classes=4),
    "VGG19": dict(height=32, width=32, num_classes=3),
    "Darknet19": dict(height=64, width=64, num_classes=8, dtype="float32"),
    "TinyYOLO": dict(height=64, width=64, n_classes=3, dtype="float32"),
    "SqueezeNet": dict(height=48, width=48, num_classes=5, dtype="float32"),
    "Xception": dict(height=64, width=64, num_classes=4, middle_blocks=2,
                     dtype="float32"),
    "UNet": dict(height=32, width=32, base_filters=8, depth=2,
                 dtype="float32"),
    "InceptionResNetV1": dict(height=64, width=64, num_classes=6,
                              embedding_size=16, blocks_a=1, blocks_b=1,
                              blocks_c=1, dtype="float32", lr=0.01),
    "NASNet": dict(height=32, width=32, num_classes=3, n_cells=1,
                   penultimate_filters=96, dtype="float32"),
}


@pytest.mark.parametrize("name", MODELS)
def test_full_width_conf_json_matches_jax(name):
    s = getattr(jax_zoo, name)().conf().to_json()
    conf = getattr(port_zoo, name)().conf()
    assert conf.to_json() == s
    parse = (ComputationGraphConfiguration
             if isinstance(conf, ComputationGraphConfiguration)
             else MultiLayerConfiguration)
    assert parse.from_json(s).to_json() == s


def test_yolo2_full_width_shapes():
    conf = port_zoo.YOLO2().conf()
    t = conf.vertex_output_types
    assert conf.dtype == "bf16" and conf.updater.lr == 1e-3
    assert t["dn16_act"].shape == (38, 38, 512)
    assert t["reorg"].shape == (19, 19, 256)
    assert t["merge"].shape == (19, 19, 1280)
    assert t["output"].shape == (19, 19, 425)
    layer = conf.vertices["output"].layer
    assert layer.n_classes == 80 and len(layer.anchors) == 5


def _no_dropout(s: str) -> str:
    """A configuration JSON with every dropout off: the packages draw
    different masks from one seed."""
    d = json.loads(s)

    def walk(o):
        if isinstance(o, dict):
            if "@layer" in o:
                o.pop("dropout", None)
                if o["@layer"] == "DropoutLayer":
                    o["rate"] = 0.0
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(d)
    return json.dumps(d)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _labels(name, rng, out):
    if name == "TinyYOLO":
        y = np.zeros(out.shape[:3] + (8,), np.float32)
        y[:, 0, 1, :] = [0.5, 0.5, 1.0, 1.5, 1.0, 0, 1, 0]
        y[1, 1, 0, :] = [0.2, 0.9, 3.0, 2.0, 1.0, 1, 0, 0]
        return y
    if name == "UNet":
        return (rng.random(out.shape) > 0.5).astype(np.float32)
    n = out.shape[-1]
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, out.shape[0])]


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_output_and_step_match_jax(name):
    conf = getattr(jax_zoo, name)(**TINY[name]).conf()
    graph = isinstance(conf, JaxCGConf)
    s = _no_dropout(conf.to_json())
    jn = (JaxGraph(JaxCGConf.from_json(s)) if graph
          else JaxNet(JaxMLConf.from_json(s))).init(7)
    net = (ComputationGraph(ComputationGraphConfiguration.from_json(s))
           if graph else MultiLayerNetwork(MultiLayerConfiguration.from_json(s)))
    net.init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    load_jax_opt_state(net, _np(jn.opt_state))
    assert net.num_params() == jn.num_params()
    rng = np.random.default_rng(0)
    H = TINY[name]["height"]
    x = rng.normal(size=(2, H, H, 3)).astype(np.float32)
    want = np.asarray(jn.output(x))
    got = net.output(x)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy() / np.abs(want).max(),
                               want / np.abs(want).max(), atol=TOL_OUT,
                               rtol=0)
    y = _labels(name, rng, want)
    lj = float(jn.fit_batch((x, y)))
    lp = net.fit_batch((x, y))
    np.testing.assert_allclose(lp, lj, rtol=TOL_LOSS)
    if name == "InceptionResNetV1":
        np.testing.assert_allclose(net.state["output"]["centers"].numpy(),
                                   np.asarray(jn.state["output"]["centers"]),
                                   **TOL_STATE)
        assert float(net.state["output"]["centers"].abs().sum()) > 0


@pytest.mark.parametrize("name", ["SimpleCNN", "UNet", "NASNet"])
def test_zoo_init_builds_on_the_cpu_and_restores(name, tmp_path):
    net = getattr(port_zoo, name)(seed=3, **TINY[name]).init(device="cpu")
    model = (ComputationGraph
             if isinstance(net.conf, ComputationGraphConfiguration)
             else MultiLayerNetwork)
    assert isinstance(net, model)
    path = str(tmp_path / f"{name}.zip")
    net.save(path)
    back = getattr(port_zoo, name)(**TINY[name]).init_pretrained(
        path, device="cpu")
    x = np.random.default_rng(4).normal(
        size=(2, TINY[name]["height"], TINY[name]["width"], 3)).astype(
            np.float32)
    assert torch.equal(back.output(x), net.output(x))


def test_forward_flops_keeps_resnet50_and_counts_yolo2():
    resnet = ComputationGraph(port_zoo.ResNet50().conf())
    assert chip_smoke.forward_flops(resnet, 3) == \
        3 * chip_smoke.RESNET50_FORWARD_FLOPS
    yolo2 = ComputationGraph(port_zoo.YOLO2().conf())
    assert chip_smoke.forward_flops(yolo2, 1) == 62_938_253_312


def test_forward_flops_counts_every_conv_kind():
    """2 x multiply-adds by hand: depthwise, separable and deconv on a
    graph; a 1-D conv, and a 3-D conv under a dense head, on sequential
    nets."""
    g = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(8, 6, 3)}))
    g.add_layer("dw", DepthwiseConvolution2DLayer(depth_multiplier=2,
                                                  strides=(2, 2)), "in")
    g.add_layer("sep", SeparableConvolution2DLayer(n_out=5, kernel=(3, 3)),
                "dw")
    g.add_layer("de", Deconvolution2DLayer(n_out=4, kernel=(2, 2)), "sep")
    g.set_outputs("de")
    net = ComputationGraph(g.build())
    dw = 4 * 3 * 6 * 9            # out 4 x 3 x 6 channels, 3 x 3 kernel
    sep = 4 * 3 * 6 * (9 + 5)     # depthwise on 6, then 1x1 6 -> 5
    de = 4 * 3 * 4 * 5 * 4        # input pixels x 2 x 2 x 5 x 4
    assert chip_smoke.forward_flops(net, 2) == 2 * 2 * (dw + sep + de)
    seq = (NeuralNetConfiguration.builder().list()
           .layer(Convolution1DLayer(n_out=6, kernel=3, strides=2))
           .set_input_type(InputType.recurrent(4, 9)).build())
    # 5 steps out x 6 channels x kernel 3 x 4 in
    assert chip_smoke.forward_flops(MultiLayerNetwork(seq), 1) == \
        2 * 5 * 6 * 3 * 4
    vol = (NeuralNetConfiguration.builder().list()
           .layer(Convolution3DLayer(n_out=2, kernel=(1, 2, 3)))
           .layer(OutputLayer(n_out=2))
           .set_input_type(InputType.convolutional3d(2, 3, 4, 5)).build())
    # 2 x 3 x 4 x 2 outputs x kernel 6 x 5 in; the head 48 -> 2
    assert chip_smoke.forward_flops(MultiLayerNetwork(vol), 1) == \
        2 * (2 * 3 * 4 * 2 * 6 * 5 + 48 * 2)
