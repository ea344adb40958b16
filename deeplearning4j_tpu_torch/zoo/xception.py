"""Xception.

Counterpart of ``deeplearning4j_tpu/zoo/xception.py``
(org.deeplearning4j.zoo.model.Xception): depthwise-separable convs
(``SeparableConvolution2DLayer``); entry flow (conv stem and three strided
residual blocks), middle flow (eight residual blocks at 728 channels), exit
flow (1024 / 1536 / 2048, global pooling, softmax); the shortcuts are
strided 1x1 convs joined by ElementWiseVertex adds. The same configuration
JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, SeparableConvolution2DLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo._blocks import cbr
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class Xception(ZooModel):
    height: int = 299
    width: int = 299
    channels: int = 3
    num_classes: int = 1000
    middle_blocks: int = 8
    lr: float = 0.045
    dtype: str = "bf16"

    def _sep_bn(self, g, name, inp, n_out, pre_relu=True):
        prev = inp
        if pre_relu:
            g.add_layer(f"{name}_prerelu", ActivationLayer(activation="relu"), prev)
            prev = f"{name}_prerelu"
        g.add_layer(f"{name}_sep",
                    SeparableConvolution2DLayer(n_out=n_out, kernel=(3, 3),
                                                activation="identity",
                                                has_bias=False), prev)
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), f"{name}_sep")
        return f"{name}_bn"

    def _entry_block(self, g, name, inp, n_out, first_relu=True):
        """Two sepconv-bn + strided maxpool, with strided 1x1 conv shortcut."""
        a = self._sep_bn(g, f"{name}_s1", inp, n_out, pre_relu=first_relu)
        b = self._sep_bn(g, f"{name}_s2", a, n_out)
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                     padding="same", pooling_type="max"), b)
        g.add_layer(f"{name}_short",
                    ConvolutionLayer(n_out=n_out, kernel=(1, 1), strides=(2, 2),
                                     activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_shortbn", BatchNormalizationLayer(), f"{name}_short")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                     f"{name}_pool", f"{name}_shortbn")
        return f"{name}_add"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(lr=self.lr, momentum=0.9))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        prev = cbr(g, "stem1", "input", 32, (3, 3), strides=(2, 2))
        prev = cbr(g, "stem2", prev, 64, (3, 3))
        prev = self._entry_block(g, "entry1", prev, 128, first_relu=False)
        prev = self._entry_block(g, "entry2", prev, 256)
        prev = self._entry_block(g, "entry3", prev, 728)
        for i in range(self.middle_blocks):
            a = self._sep_bn(g, f"mid{i}_1", prev, 728)
            b = self._sep_bn(g, f"mid{i}_2", a, 728)
            c = self._sep_bn(g, f"mid{i}_3", b, 728)
            g.add_vertex(f"mid{i}_add", ElementWiseVertex(op="add"), c, prev)
            prev = f"mid{i}_add"
        # exit flow
        a = self._sep_bn(g, "exit_s1", prev, 728)
        b = self._sep_bn(g, "exit_s2", a, 1024)
        g.add_layer("exit_pool",
                    SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                     padding="same", pooling_type="max"), b)
        g.add_layer("exit_short",
                    ConvolutionLayer(n_out=1024, kernel=(1, 1), strides=(2, 2),
                                     activation="identity", has_bias=False), prev)
        g.add_layer("exit_shortbn", BatchNormalizationLayer(), "exit_short")
        g.add_vertex("exit_add", ElementWiseVertex(op="add"),
                     "exit_pool", "exit_shortbn")
        c = self._sep_bn(g, "exit_s3", "exit_add", 1536)
        g.add_layer("exit_r3", ActivationLayer(activation="relu"), c)
        d = self._sep_bn(g, "exit_s4", "exit_r3", 2048, pre_relu=False)
        g.add_layer("exit_r4", ActivationLayer(activation="relu"), d)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "exit_r4")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax", loss="mcxent"),
                    "gap")
        g.set_outputs("output")
        return g.build()
