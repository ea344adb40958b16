"""Inception-ResNet v1 (FaceNet-style).

Counterpart of ``deeplearning4j_tpu/zoo/inception_resnet.py``
(org.deeplearning4j.zoo.model.InceptionResNetV1): the stem, the
Inception-ResNet-A/B/C blocks (branches merged on channels, a 1x1 linear
projection, a ScaleVertex and an ElementWiseVertex add), Reduction-A/B,
global average pooling, a 128-wide embedding and a center-loss softmax
head (``CenterLossOutputLayer``, whose centers train with the net). The
same configuration JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex, ScaleVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, CenterLossOutputLayer, ConvolutionLayer, DenseLayer,
    GlobalPoolingLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import RMSProp
from deeplearning4j_tpu_torch.zoo._blocks import cbr
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class InceptionResNetV1(ZooModel):
    height: int = 160
    width: int = 160
    channels: int = 3
    num_classes: int = 1001
    embedding_size: int = 128
    blocks_a: int = 5
    blocks_b: int = 10
    blocks_c: int = 5
    lr: float = 0.1
    dtype: str = "bf16"

    # ------------------------------------------------------------- blocks
    def _residual(self, g, name, inp, branches, proj_filters, scale):
        """Merge branches -> 1x1 linear conv -> scale -> add -> relu."""
        g.add_vertex(f"{name}_cat", MergeVertex(), *branches)
        g.add_layer(f"{name}_proj",
                    ConvolutionLayer(n_out=proj_filters, kernel=(1, 1),
                                     activation="identity"), f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_proj")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_relu"

    def _block_a(self, g, name, inp):  # input 256 ch
        b1 = cbr(g, f"{name}_b1", inp, 32, (1, 1))
        b2 = cbr(g, f"{name}_b2a", inp, 32, (1, 1))
        b2 = cbr(g, f"{name}_b2b", b2, 32, (3, 3))
        b3 = cbr(g, f"{name}_b3a", inp, 32, (1, 1))
        b3 = cbr(g, f"{name}_b3b", b3, 32, (3, 3))
        b3 = cbr(g, f"{name}_b3c", b3, 32, (3, 3))
        return self._residual(g, name, inp, [b1, b2, b3], 256, 0.17)

    def _block_b(self, g, name, inp):  # input 896 ch
        b1 = cbr(g, f"{name}_b1", inp, 128, (1, 1))
        b2 = cbr(g, f"{name}_b2a", inp, 128, (1, 1))
        b2 = cbr(g, f"{name}_b2b", b2, 128, (1, 7))
        b2 = cbr(g, f"{name}_b2c", b2, 128, (7, 1))
        return self._residual(g, name, inp, [b1, b2], 896, 0.10)

    def _block_c(self, g, name, inp):  # input 1792 ch
        b1 = cbr(g, f"{name}_b1", inp, 192, (1, 1))
        b2 = cbr(g, f"{name}_b2a", inp, 192, (1, 1))
        b2 = cbr(g, f"{name}_b2b", b2, 192, (1, 3))
        b2 = cbr(g, f"{name}_b2c", b2, 192, (3, 1))
        return self._residual(g, name, inp, [b1, b2], 1792, 0.20)

    def _reduction_a(self, g, name, inp):  # 256 -> 896
        g.add_layer(f"{name}_pool", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                                     padding="same",
                                                     pooling_type="max"), inp)
        b2 = cbr(g, f"{name}_b2", inp, 384, (3, 3), strides=(2, 2))
        b3 = cbr(g, f"{name}_b3a", inp, 192, (1, 1))
        b3 = cbr(g, f"{name}_b3b", b3, 192, (3, 3))
        b3 = cbr(g, f"{name}_b3c", b3, 256, (3, 3), strides=(2, 2))
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_pool", b2, b3)
        return f"{name}_cat"

    def _reduction_b(self, g, name, inp):  # 896 -> 1792
        g.add_layer(f"{name}_pool", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                                     padding="same",
                                                     pooling_type="max"), inp)
        b2 = cbr(g, f"{name}_b2a", inp, 256, (1, 1))
        b2 = cbr(g, f"{name}_b2b", b2, 384, (3, 3), strides=(2, 2))
        b3 = cbr(g, f"{name}_b3a", inp, 256, (1, 1))
        b3 = cbr(g, f"{name}_b3b", b3, 256, (3, 3), strides=(2, 2))
        b4 = cbr(g, f"{name}_b4a", inp, 256, (1, 1))
        b4 = cbr(g, f"{name}_b4b", b4, 256, (3, 3))
        b4 = cbr(g, f"{name}_b4c", b4, 256, (3, 3), strides=(2, 2))
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_pool", b2, b3, b4)
        return f"{name}_cat"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(RMSProp(lr=self.lr))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        # stem: 3x conv, maxpool, 2x conv, conv stride 2 -> 256 ch
        prev = cbr(g, "stem1", "input", 32, (3, 3), strides=(2, 2))
        prev = cbr(g, "stem2", prev, 32, (3, 3))
        prev = cbr(g, "stem3", prev, 64, (3, 3))
        g.add_layer("stem_pool", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                                  padding="same",
                                                  pooling_type="max"), prev)
        prev = cbr(g, "stem4", "stem_pool", 80, (1, 1))
        prev = cbr(g, "stem5", prev, 192, (3, 3))
        prev = cbr(g, "stem6", prev, 256, (3, 3), strides=(2, 2))
        for i in range(self.blocks_a):
            prev = self._block_a(g, f"a{i}", prev)
        prev = self._reduction_a(g, "ra", prev)
        for i in range(self.blocks_b):
            prev = self._block_b(g, f"b{i}", prev)
        prev = self._reduction_b(g, "rb", prev)
        for i in range(self.blocks_c):
            prev = self._block_c(g, f"c{i}", prev)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), prev)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"), "gap")
        g.add_layer("output",
                    CenterLossOutputLayer(n_out=self.num_classes,
                                          activation="softmax", loss="mcxent",
                                          alpha=0.9, lambda_=2e-4), "bottleneck")
        g.set_outputs("output")
        return g.build()
