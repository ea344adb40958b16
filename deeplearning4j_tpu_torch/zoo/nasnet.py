"""NASNet-A (mobile-scale).

Counterpart of ``deeplearning4j_tpu/zoo/nasnet.py``: the JAX package's
compact NASNet-A, Normal and Reduction cells of separable-conv and pooling
branches joined by adds and a channel concat, with 1x1 "fit" convs keeping
the branches' channel counts equal. The same configuration JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    GlobalPoolingLayer, OutputLayer, SeparableConvolution2DLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import RMSProp
from deeplearning4j_tpu_torch.zoo._blocks import cbr
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class NASNet(ZooModel):
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    penultimate_filters: int = 1056
    n_cells: int = 4  # normal cells per stack (NASNet-A mobile: 4)
    lr: float = 0.04
    dtype: str = "bf16"

    def _sep(self, g, name, inp, f, kernel, strides=(1, 1)):
        g.add_layer(name, SeparableConvolution2DLayer(
            n_out=f, kernel=kernel, strides=strides, activation="relu",
            has_bias=False), inp)
        return name

    def _fit(self, g, name, inp, f, strides=(1, 1)):
        return cbr(g, name, inp, f, (1, 1), strides=strides)

    def _normal_cell(self, g, name, x, f):
        """NASNet-A normal cell (compact): 4 combined branches, concat."""
        h = self._fit(g, f"{name}_h", x, f)
        b1a = self._sep(g, f"{name}_b1a", h, f, (3, 3))
        g.add_vertex(f"{name}_add1", ElementWiseVertex(op="add"), b1a, h)
        b2a = self._sep(g, f"{name}_b2a", h, f, (5, 5))
        b2b = self._sep(g, f"{name}_b2b", h, f, (3, 3))
        g.add_vertex(f"{name}_add2", ElementWiseVertex(op="add"), b2a, b2b)
        g.add_layer(f"{name}_avg", SubsamplingLayer(
            kernel=(3, 3), strides=(1, 1), padding="same",
            pooling_type="avg"), h)
        g.add_vertex(f"{name}_add3", ElementWiseVertex(op="add"),
                     f"{name}_avg", h)
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_add1",
                     f"{name}_add2", f"{name}_add3")
        return f"{name}_cat"

    def _reduction_cell(self, g, name, x, f):
        h = self._fit(g, f"{name}_h", x, f)
        b1 = self._sep(g, f"{name}_b1", h, f, (5, 5), strides=(2, 2))
        b2 = self._sep(g, f"{name}_b2", h, f, (7, 7), strides=(2, 2))
        g.add_vertex(f"{name}_add1", ElementWiseVertex(op="add"), b1, b2)
        g.add_layer(f"{name}_maxp", SubsamplingLayer(
            kernel=(3, 3), strides=(2, 2), padding="same",
            pooling_type="max"), h)
        b3 = self._sep(g, f"{name}_b3", h, f, (3, 3), strides=(2, 2))
        g.add_vertex(f"{name}_add2", ElementWiseVertex(op="add"),
                     f"{name}_maxp", b3)
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_add1",
                     f"{name}_add2")
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
        f = self.penultimate_filters // 24  # NASNet convention
        prev = cbr(g, "stem", "input", 32, (3, 3), strides=(2, 2))
        prev = self._reduction_cell(g, "stem_r1", prev, f)
        prev = self._reduction_cell(g, "stem_r2", prev, f * 2)
        for i in range(self.n_cells):
            prev = self._normal_cell(g, f"n1_{i}", prev, f * 2)
        prev = self._reduction_cell(g, "r1", prev, f * 4)
        for i in range(self.n_cells):
            prev = self._normal_cell(g, f"n2_{i}", prev, f * 4)
        prev = self._reduction_cell(g, "r2", prev, f * 8)
        for i in range(self.n_cells):
            prev = self._normal_cell(g, f"n3_{i}", prev, f * 8)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), prev)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax", loss="mcxent"),
                    "gap")
        g.set_outputs("output")
        return g.build()
