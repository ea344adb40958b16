"""BERT for sequence classification (BASELINE.json config #4).

Counterpart of ``deeplearning4j_tpu/zoo/bert.py``: token embedding +
learned positions + LayerNorm + N transformer encoder blocks + LayerNorm +
masked average pooling + softmax classifier, with AdamW on a warmup-cosine
schedule and global-norm clipping 1.0, in bf16 by default. On the card each
block's attention runs the flash-attention kernels, forward and backward.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequenceLayer, GlobalPoolingLayer, LayerNormalizationLayer,
    OutputLayer, PositionalEmbeddingLayer, TransformerEncoderLayer,
)
from deeplearning4j_tpu_torch.optimize.schedules import WarmupCosineSchedule
from deeplearning4j_tpu_torch.optimize.updaters import AdamW
from deeplearning4j_tpu_torch.zoo.base import ZooModel


@dataclasses.dataclass
class Bert(ZooModel):
    """Configurable BERT encoder for sequence classification fine-tuning."""

    vocab_size: int = 30522
    max_len: int = 128
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 2
    dropout: float = 0.1
    lr: float = 2e-5
    warmup: int = 1000
    total_steps: int = 100000
    dtype: str = "bf16"

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(AdamW(lr=WarmupCosineSchedule(
                peak_value=self.lr, warmup_steps=self.warmup,
                total_steps=self.total_steps)))
            .data_type(self.dtype)
            .gradient_clipping(1.0)
            .list()
            .layer(EmbeddingSequenceLayer(n_in=self.vocab_size,
                                          n_out=self.d_model))
            .layer(PositionalEmbeddingLayer(max_len=self.max_len))
            .layer(LayerNormalizationLayer())
        )
        for _ in range(self.n_layers):
            b = b.layer(TransformerEncoderLayer(
                d_model=self.d_model, n_heads=self.n_heads, d_ff=self.d_ff,
                dropout_rate=self.dropout))
        return (
            b.layer(LayerNormalizationLayer())
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.recurrent(self.vocab_size, self.max_len))
            .build()
        )


@dataclasses.dataclass
class BertBase(Bert):
    """BERT-base hyperparameters (12 x 768, 12 heads of 64, d_ff 3072)."""
