"""U-Net.

Counterpart of ``deeplearning4j_tpu/zoo/unet.py``
(org.deeplearning4j.zoo.model.UNet): double-conv blocks, 2x2 max pools
down, nearest 2x upsampling and a 2x2 conv up, a MergeVertex with the
mirrored encoder block, and a 1x1 conv to a sigmoid map trained with
per-pixel XENT (``CnnLossLayer``). The same configuration JSON.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    CnnLossLayer, ConvolutionLayer, SubsamplingLayer, Upsampling2DLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class UNet(ZooModel):
    height: int = 512
    width: int = 512
    channels: int = 3
    out_channels: int = 1  # segmentation classes (1 = binary sigmoid map)
    base_filters: int = 64
    depth: int = 4
    lr: float = 1e-4
    dtype: str = "bf16"

    def _double_conv(self, g, name, inp, filters):
        g.add_layer(f"{name}_c1", ConvolutionLayer(n_out=filters, kernel=(3, 3),
                                                   activation="relu"), inp)
        g.add_layer(f"{name}_c2", ConvolutionLayer(n_out=filters, kernel=(3, 3),
                                                   activation="relu"), f"{name}_c1")
        return f"{name}_c2"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(lr=self.lr))
             .data_type(self.dtype)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(input=InputType.convolutional(
                 self.height, self.width, self.channels)))
        skips = []
        prev = "input"
        f = self.base_filters
        for d in range(self.depth):
            prev = self._double_conv(g, f"enc{d}", prev, f * (2 ** d))
            skips.append(prev)
            g.add_layer(f"down{d}", SubsamplingLayer(kernel=(2, 2), strides=(2, 2),
                                                     padding="same",
                                                     pooling_type="max"), prev)
            prev = f"down{d}"
        prev = self._double_conv(g, "bottleneck", prev, f * (2 ** self.depth))
        for d in reversed(range(self.depth)):
            g.add_layer(f"up{d}", Upsampling2DLayer(size=(2, 2)), prev)
            g.add_layer(f"upc{d}", ConvolutionLayer(n_out=f * (2 ** d), kernel=(2, 2),
                                                    activation="relu"), f"up{d}")
            g.add_vertex(f"cat{d}", MergeVertex(), skips[d], f"upc{d}")
            prev = self._double_conv(g, f"dec{d}", f"cat{d}", f * (2 ** d))
        g.add_layer("head", ConvolutionLayer(n_out=self.out_channels, kernel=(1, 1),
                                             activation="identity"), prev)
        g.add_layer("output", CnnLossLayer(activation="sigmoid", loss="xent"), "head")
        g.set_outputs("output")
        return g.build()
