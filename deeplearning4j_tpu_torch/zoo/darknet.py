"""Darknet19, TinyYOLO, YOLO2.

Counterpart of ``deeplearning4j_tpu/zoo/darknet.py``
(org.deeplearning4j.zoo.model.{Darknet19, TinyYOLO, YOLO2}): conv / BN /
leaky-ReLU trunks on ``_blocks.cbr``. YOLO2 adds the passthrough route (a
1x1 conv on the 38 x 38 map before the last pool, SpaceToDepth, a channel
MergeVertex with the deep path) and the detection head ending in
``Yolo2OutputLayer`` with the five priors. The same builder calls, vertex
names and defaults, so each configuration JSON is the JAX package's. On
the card the convolutions and pools run on cuDNN through
``torch.nn.functional`` with NHWC activations as channels_last views; no
hand-written kernel is on their path. ``leakyrelu`` is the catalog's,
slope 0.01, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, GlobalPoolingLayer, LossLayer, SpaceToDepthLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.zoo._blocks import cbr
from deeplearning4j_tpu_torch.zoo.base import ZooModel

# Darknet-19 conv plan: (filters, kernel) per block, "M" = 2x2/2 maxpool
_DARKNET19 = [
    (32, 3), "M", (64, 3), "M",
    (128, 3), (64, 1), (128, 3), "M",
    (256, 3), (128, 1), (256, 3), "M",
    (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
    (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3),
]


def _darknet_trunk(g, inp, plan, prefix="dn"):
    prev, idx = inp, 0
    taps = {}
    for item in plan:
        if item == "M":
            g.add_layer(f"{prefix}_pool{idx}",
                        SubsamplingLayer(kernel=(2, 2), strides=(2, 2),
                                         padding="same", pooling_type="max"), prev)
            prev = f"{prefix}_pool{idx}"
        else:
            f, k = item
            prev = cbr(g, f"{prefix}{idx}", prev, f, (k, k), activation="leakyrelu")
        taps[idx] = prev
        idx += 1
    return prev, taps


@dataclasses.dataclass
class Darknet19(ZooModel):
    """org.deeplearning4j.zoo.model.Darknet19 — ImageNet classifier."""

    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    lr: float = 0.001
    dtype: str = "bf16"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(lr=self.lr, momentum=0.9))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        prev, _ = _darknet_trunk(g, "input", _DARKNET19)
        g.add_layer("head_conv",
                    ConvolutionLayer(n_out=self.num_classes, kernel=(1, 1),
                                     activation="identity"), prev)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "head_conv")
        g.add_layer("output", LossLayer(activation="softmax", loss="mcxent"), "gap")
        g.set_outputs("output")
        return g.build()


# TinyYOLO default priors (PASCAL VOC, grid units) — matches the reference's
# TinyYOLO.DEFAULT_PRIOR_BOXES
_TINY_PRIORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
                (16.62, 10.52))
_YOLO2_PRIORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                 (7.88282, 3.52778), (9.77052, 9.16828))


@dataclasses.dataclass
class TinyYOLO(ZooModel):
    """org.deeplearning4j.zoo.model.TinyYOLO — tiny-yolov2 detector."""

    height: int = 416
    width: int = 416
    channels: int = 3
    n_classes: int = 20
    anchors: tuple = _TINY_PRIORS
    lr: float = 1e-3
    dtype: str = "bf16"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(lr=self.lr))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        prev = "input"
        for i, f in enumerate([16, 32, 64, 128, 256]):
            prev = cbr(g, f"c{i}", prev, f, (3, 3), activation="leakyrelu")
            g.add_layer(f"p{i}", SubsamplingLayer(kernel=(2, 2), strides=(2, 2),
                                                  padding="same",
                                                  pooling_type="max"), prev)
            prev = f"p{i}"
        prev = cbr(g, "c5", prev, 512, (3, 3), activation="leakyrelu")
        prev = cbr(g, "c6", prev, 1024, (3, 3), activation="leakyrelu")
        prev = cbr(g, "c7", prev, 1024, (3, 3), activation="leakyrelu")
        n_filters = len(self.anchors) * (5 + self.n_classes)
        g.add_layer("det", ConvolutionLayer(n_out=n_filters, kernel=(1, 1),
                                            activation="identity"), prev)
        g.add_layer("output", Yolo2OutputLayer(anchors=tuple(self.anchors),
                                               n_classes=self.n_classes), "det")
        g.set_outputs("output")
        return g.build()


@dataclasses.dataclass
class YOLO2(ZooModel):
    """org.deeplearning4j.zoo.model.YOLO2 — Darknet19 trunk + passthrough."""

    height: int = 608
    width: int = 608
    channels: int = 3
    n_classes: int = 80
    anchors: tuple = _YOLO2_PRIORS
    lr: float = 1e-3
    dtype: str = "bf16"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(lr=self.lr))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        prev, taps = _darknet_trunk(g, "input", _DARKNET19)
        # deep path: two more 3x3x1024 convs
        d = cbr(g, "e0", prev, 1024, (3, 3), activation="leakyrelu")
        d = cbr(g, "e1", d, 1024, (3, 3), activation="leakyrelu")
        # passthrough from the last 512-channel map before the final maxpool
        # (plan index 16 = conv output at 2x spatial resolution)
        pass_src = taps[16]
        pt = cbr(g, "pt", pass_src, 64, (1, 1), activation="leakyrelu")
        g.add_layer("reorg", SpaceToDepthLayer(block=2), pt)
        g.add_vertex("merge", MergeVertex(), "reorg", d)
        h = cbr(g, "e2", "merge", 1024, (3, 3), activation="leakyrelu")
        n_filters = len(self.anchors) * (5 + self.n_classes)
        g.add_layer("det", ConvolutionLayer(n_out=n_filters, kernel=(1, 1),
                                            activation="identity"), h)
        g.add_layer("output", Yolo2OutputLayer(anchors=tuple(self.anchors),
                                               n_classes=self.n_classes), "det")
        g.set_outputs("output")
        return g.build()
