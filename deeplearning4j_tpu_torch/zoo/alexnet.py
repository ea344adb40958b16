"""AlexNet (org.deeplearning4j.zoo.model.AlexNet, the one-tower variant).

Counterpart of ``deeplearning4j_tpu/zoo/alexnet.py``: 224 x 224 x 3,
conv 96-256-384-384-256 with an LRN layer after each of the first two,
max pools 3/2, dense 4096-4096 with dropout 0.5, softmax over 1000
classes, Nesterovs 1e-2 with momentum 0.9. On the card both LRN layers run
the hand-written LRN kernels (``ops/cuda/lrn.py``), forward and backward;
conv and pooling are cuDNN.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, LocalResponseNormalizationLayer, OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class AlexNet(ZooModel):
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    lr: float = 1e-2
    dtype: str = "float32"

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Nesterovs(lr=self.lr, momentum=0.9))
            .data_type(self.dtype)
            .list()
            .layer(ConvolutionLayer(n_out=96, kernel=(11, 11), strides=(4, 4),
                                    padding="truncate", activation="relu"))
            .layer(LocalResponseNormalizationLayer())
            .layer(SubsamplingLayer(kernel=(3, 3), strides=(2, 2), pooling_type="max"))
            .layer(ConvolutionLayer(n_out=256, kernel=(5, 5), padding="same",
                                    activation="relu"))
            .layer(LocalResponseNormalizationLayer())
            .layer(SubsamplingLayer(kernel=(3, 3), strides=(2, 2), pooling_type="max"))
            .layer(ConvolutionLayer(n_out=384, kernel=(3, 3), activation="relu"))
            .layer(ConvolutionLayer(n_out=384, kernel=(3, 3), activation="relu"))
            .layer(ConvolutionLayer(n_out=256, kernel=(3, 3), activation="relu"))
            .layer(SubsamplingLayer(kernel=(3, 3), strides=(2, 2), pooling_type="max"))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
