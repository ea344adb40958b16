"""ResNet-50 (org.deeplearning4j.zoo.model.ResNet50), BASELINE.json config
#2.

Counterpart of ``deeplearning4j_tpu/zoo/resnet.py``: a ComputationGraph of
bottleneck residual blocks (a projection or identity shortcut joined by
``ElementWiseVertex(op="add")``), conv1 7x7/2 and a 3x3/2 max pool, stages
[3, 4, 6, 3], global average pooling and softmax over 1000 classes, bf16
compute, Nesterovs 0.1 with momentum 0.9. The same builder calls, vertex
names and defaults, so the configuration JSON is the JAX package's. On
the card the convolutions run on cuDNN through ``torch.nn.functional``
with NHWC activations as channels_last views; no hand-written kernel is on
its path. ``resnet50_pipeline_plan`` is not ported yet.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class ResNet50(ZooModel):
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    lr: float = 0.1
    dtype: str = "bf16"

    def conf(self):
        g = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Nesterovs(lr=self.lr, momentum=0.9))
            .data_type(self.dtype)
            .graph_builder()
            .add_inputs("input")
            .set_input_types(input=InputType.convolutional(
                self.height, self.width, self.channels))
        )
        # stem
        g.add_layer("conv1", ConvolutionLayer(n_out=64, kernel=(7, 7),
                                              strides=(2, 2), padding="same",
                                              activation="identity",
                                              has_bias=False), "input")
        g.add_layer("bn1", BatchNormalizationLayer(), "conv1")
        g.add_layer("relu1", ActivationLayer(activation="relu"), "bn1")
        g.add_layer("pool1", SubsamplingLayer(kernel=(3, 3), strides=(2, 2),
                                              padding="same",
                                              pooling_type="max"), "relu1")

        prev = "pool1"
        stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
        for si, (width, blocks, first_stride) in enumerate(stages):
            for bi in range(blocks):
                stride = first_stride if bi == 0 else 1
                prev = self._bottleneck(g, prev, f"s{si}b{bi}", width, stride,
                                        project=(bi == 0))
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), prev)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          loss="mcxent"), "avgpool")
        g.set_outputs("output")
        return g.build()

    def _bottleneck(self, g, prev, name, width, stride, project):
        """1x1 reduce -> 3x3 -> 1x1 expand (4 width), shortcut add, relu."""

        def cbr(suffix, inp, n_out, kernel, strides, act="relu"):
            g.add_layer(f"{name}_conv{suffix}",
                        ConvolutionLayer(n_out=n_out, kernel=kernel,
                                         strides=strides, padding="same",
                                         activation="identity",
                                         has_bias=False), inp)
            g.add_layer(f"{name}_bn{suffix}", BatchNormalizationLayer(),
                        f"{name}_conv{suffix}")
            if act:
                g.add_layer(f"{name}_relu{suffix}",
                            ActivationLayer(activation=act),
                            f"{name}_bn{suffix}")
                return f"{name}_relu{suffix}"
            return f"{name}_bn{suffix}"

        a = cbr("a", prev, width, (1, 1), (stride, stride))
        b = cbr("b", a, width, (3, 3), (1, 1))
        c = cbr("c", b, width * 4, (1, 1), (1, 1), act=None)

        if project:
            g.add_layer(f"{name}_proj",
                        ConvolutionLayer(n_out=width * 4, kernel=(1, 1),
                                         strides=(stride, stride),
                                         padding="same",
                                         activation="identity",
                                         has_bias=False), prev)
            g.add_layer(f"{name}_projbn", BatchNormalizationLayer(),
                        f"{name}_proj")
            shortcut = f"{name}_projbn"
        else:
            shortcut = prev
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, shortcut)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"
