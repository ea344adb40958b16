"""Character-RNN LSTM models.

Counterpart of ``deeplearning4j_tpu/zoo/textgen.py``: TextGenerationLSTM,
LSTM(256) x 2 + RnnOutputLayer over a 77-character vocabulary, and
BidirectionalGravesLSTMCharRnn, 2 x GravesBidirectionalLSTM(200) with Adam
(BASELINE.json config #3). Their LSTM layers run on the fused-LSTM kernels
on the card, forward and backward.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    GravesBidirectionalLSTMLayer, LSTMLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam, RMSProp
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class TextGenerationLSTM(ZooModel):
    """org.deeplearning4j.zoo.model.TextGenerationLSTM: LSTM(256)x2 + RnnOutput."""

    vocab_size: int = 77
    units: int = 256
    timesteps: int = 64
    lr: float = 1e-3
    dtype: str = "float32"

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(RMSProp(lr=self.lr))
            .data_type(self.dtype)
            .gradient_clipping(5.0)
            .list()
            .layer(LSTMLayer(n_out=self.units))
            .layer(LSTMLayer(n_out=self.units))
            .layer(RnnOutputLayer(n_out=self.vocab_size, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(self.vocab_size, self.timesteps))
            .build()
        )


@dataclasses.dataclass
class BidirectionalGravesLSTMCharRnn(ZooModel):
    """Bidirectional Graves (peephole) LSTM stack + per-timestep softmax,
    one-hot char input (BASELINE.json config #3)."""

    vocab_size: int = 77
    units: int = 200
    timesteps: int = 64
    layers: int = 2
    lr: float = 1e-3
    dtype: str = "float32"

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(lr=self.lr))
            .data_type(self.dtype)
            .gradient_clipping(5.0)
            .list()
        )
        for _ in range(self.layers):
            b = b.layer(GravesBidirectionalLSTMLayer(n_out=self.units))
        return (
            b.layer(RnnOutputLayer(n_out=self.vocab_size, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.recurrent(self.vocab_size, self.timesteps))
            .build()
        )
