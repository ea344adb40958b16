"""SimpleCNN (org.deeplearning4j.zoo.model.SimpleCNN).

Counterpart of ``deeplearning4j_tpu/zoo/simplecnn.py``: three conv / BN /
conv / max-pool blocks, dropout, a dense layer and softmax, AdaDelta, f32;
the same configuration JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalizationLayer, ConvolutionLayer, DenseLayer, DropoutLayer,
    OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import AdaDelta
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class SimpleCNN(ZooModel):
    height: int = 48
    width: int = 48
    channels: int = 3
    num_classes: int = 10
    dtype: str = "float32"

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(AdaDelta())
            .data_type(self.dtype)
            .list()
        )
        for width in (16, 32, 64):
            b = (
                b.layer(ConvolutionLayer(n_out=width, kernel=(3, 3), activation="identity"))
                .layer(BatchNormalizationLayer())
                .layer(ConvolutionLayer(n_out=width, kernel=(3, 3), activation="relu"))
                .layer(SubsamplingLayer(kernel=(2, 2), strides=(2, 2), pooling_type="max"))
            )
        return (
            b.layer(DropoutLayer(rate=0.5))
            .layer(DenseLayer(n_out=256, activation="relu"))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
