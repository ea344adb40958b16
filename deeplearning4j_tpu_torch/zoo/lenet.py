"""LeNet — the BASELINE.json config-#1 model.

Counterpart of ``deeplearning4j_tpu/zoo/lenet.py`` (the dl4j-examples
LenetMnistExample topology): conv5x5(20) -> maxpool2 -> conv5x5(50) ->
maxpool2 -> dense(500, relu) -> softmax(10), Adam, on a flat 28 x 28 x 1
input that ``ReshapeToCnnPreProcessor`` turns NHWC. It runs no
hand-written kernel: conv and pooling are cuDNN on the card.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class LeNet(ZooModel):
    height: int = 28
    width: int = 28
    channels: int = 1
    num_classes: int = 10
    lr: float = 1e-3
    dtype: str = "float32"

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(lr=self.lr))
            .data_type(self.dtype)
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5), padding="same",
                                    activation="identity"))
            .layer(SubsamplingLayer(kernel=(2, 2), strides=(2, 2), pooling_type="max"))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5), padding="same",
                                    activation="identity"))
            .layer(SubsamplingLayer(kernel=(2, 2), strides=(2, 2), pooling_type="max"))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(self.height, self.width,
                                                         self.channels))
            .build()
        )
