"""VGG16 / VGG19 (org.deeplearning4j.zoo.model.VGG16 / VGG19).

Counterpart of ``deeplearning4j_tpu/zoo/vgg.py``: 3x3 conv blocks and 2x2
max pools, two 4096-wide dense layers with dropout 0.5, softmax over 1000
classes, Nesterovs, f32; the same configuration JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel

_VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG19_BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


@dataclasses.dataclass
class VGG16(ZooModel):
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    lr: float = 1e-2
    dtype: str = "float32"

    _blocks = _VGG16_BLOCKS

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Nesterovs(lr=self.lr, momentum=0.9))
            .data_type(self.dtype)
            .list()
        )
        for width, reps in self._blocks:
            for _ in range(reps):
                b = b.layer(ConvolutionLayer(n_out=width, kernel=(3, 3), padding="same",
                                             activation="relu"))
            b = b.layer(SubsamplingLayer(kernel=(2, 2), strides=(2, 2), pooling_type="max"))
        return (
            b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )


@dataclasses.dataclass
class VGG19(VGG16):
    _blocks = _VGG19_BLOCKS
