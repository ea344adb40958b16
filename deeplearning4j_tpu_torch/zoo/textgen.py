"""Character-RNN LSTM model.

Counterpart of ``deeplearning4j_tpu/zoo/textgen.py:24``: TextGenerationLSTM,
LSTM(256) x 2 + RnnOutputLayer over a 77-character vocabulary. Its LSTM
layers run on the fused-LSTM kernel on the card.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.optimize.updaters import RMSProp
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
