"""Layer catalog (config+impl unified, JSON round-trippable).

Counterpart of ``deeplearning4j_tpu/nn/layers``: the layers the port has so
far. A configuration naming any other layer fails to load with an error
that names it.
"""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    LearnedSelfAttentionLayer, PositionalEmbeddingLayer, SelfAttentionLayer,
    TransformerEncoderLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.conv import (
    ConvolutionLayer, GlobalPoolingLayer, LocalResponseNormalizationLayer,
    SubsamplingLayer, ZeroPadding2DLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer, DenseLayer, EmbeddingLayer, EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.nn.layers.norm import (
    BatchNormalizationLayer, LayerNormalizationLayer,
)
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BidirectionalLayer, GravesBidirectionalLSTMLayer, GravesLSTMLayer, GRULayer,
    LastTimeStepLayer, LSTMLayer, MaskZeroLayer, SimpleRnnLayer,
    TimeDistributedLayer,
)

__all__ = ["Layer", "register_layer", "DenseLayer", "ActivationLayer",
           "EmbeddingLayer",
           "EmbeddingSequenceLayer", "OutputLayer", "RnnOutputLayer",
           "LSTMLayer", "GravesLSTMLayer", "GRULayer", "SimpleRnnLayer",
           "BidirectionalLayer", "GravesBidirectionalLSTMLayer",
           "LastTimeStepLayer", "MaskZeroLayer", "TimeDistributedLayer",
           "BatchNormalizationLayer", "LayerNormalizationLayer",
           "GlobalPoolingLayer", "ConvolutionLayer", "SubsamplingLayer",
           "LocalResponseNormalizationLayer", "ZeroPadding2DLayer",
           "SelfAttentionLayer",
           "LearnedSelfAttentionLayer", "PositionalEmbeddingLayer",
           "TransformerEncoderLayer"]
