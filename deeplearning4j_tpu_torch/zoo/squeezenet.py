"""SqueezeNet v1.1.

Counterpart of ``deeplearning4j_tpu/zoo/squeezenet.py``
(org.deeplearning4j.zoo.model.SqueezeNet): fire modules (a 1x1 squeeze,
then 1x1 and 3x3 expands joined on channels by a MergeVertex); the head is
dropout, a 1x1 conv to the classes, global average pooling and softmax.
The same configuration JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DropoutLayer, GlobalPoolingLayer, LossLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class SqueezeNet(ZooModel):
    height: int = 227
    width: int = 227
    channels: int = 3
    num_classes: int = 1000
    lr: float = 1e-3
    dtype: str = "bf16"

    def _fire(self, g, name, inp, squeeze, expand):
        g.add_layer(f"{name}_sq",
                    ConvolutionLayer(n_out=squeeze, kernel=(1, 1),
                                     activation="relu"), inp)
        g.add_layer(f"{name}_e1",
                    ConvolutionLayer(n_out=expand, kernel=(1, 1),
                                     activation="relu"), f"{name}_sq")
        g.add_layer(f"{name}_e3",
                    ConvolutionLayer(n_out=expand, kernel=(3, 3),
                                     activation="relu"), f"{name}_sq")
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_cat"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(lr=self.lr))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        g.add_layer("conv1", ConvolutionLayer(n_out=64, kernel=(3, 3),
                                              strides=(2, 2), activation="relu"),
                    "input")
        g.add_layer("pool1", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                              padding="same",
                                              pooling_type="max"), "conv1")
        prev = self._fire(g, "fire2", "pool1", 16, 64)
        prev = self._fire(g, "fire3", prev, 16, 64)
        g.add_layer("pool3", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                              padding="same",
                                              pooling_type="max"), prev)
        prev = self._fire(g, "fire4", "pool3", 32, 128)
        prev = self._fire(g, "fire5", prev, 32, 128)
        g.add_layer("pool5", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                              padding="same",
                                              pooling_type="max"), prev)
        prev = self._fire(g, "fire6", "pool5", 48, 192)
        prev = self._fire(g, "fire7", prev, 48, 192)
        prev = self._fire(g, "fire8", prev, 64, 256)
        prev = self._fire(g, "fire9", prev, 64, 256)
        g.add_layer("drop", DropoutLayer(rate=0.5), prev)
        g.add_layer("conv10", ConvolutionLayer(n_out=self.num_classes,
                                               kernel=(1, 1),
                                               activation="relu"), "drop")
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "conv10")
        g.add_layer("output", LossLayer(activation="softmax", loss="mcxent"), "gap")
        g.set_outputs("output")
        return g.build()
