"""Layer catalog (config+impl unified, JSON round-trippable).

Counterpart of ``deeplearning4j_tpu/nn/layers``: every layer of its
``__all__``, the pretrain tier's ``AutoEncoderLayer`` and
``VariationalAutoencoderLayer`` included, plus the port's
``PositionalEmbeddingLayer``. A configuration naming any other layer fails
to load with an error that names it.
"""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    LearnedSelfAttentionLayer, PositionalEmbeddingLayer, SelfAttentionLayer,
    TransformerEncoderLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.conv import (
    Convolution1DLayer, Convolution3DLayer, ConvolutionLayer, Cropping2DLayer,
    Deconvolution2DLayer, DepthwiseConvolution2DLayer, GlobalPoolingLayer,
    LocalResponseNormalizationLayer, SeparableConvolution2DLayer,
    SpaceToDepthLayer, Subsampling1DLayer, SubsamplingLayer,
    Upsampling2DLayer, ZeroPadding2DLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer, DenseLayer, DropoutLayer, ElementWiseMultiplicationLayer,
    EmbeddingLayer, EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.nn.layers.norm import (
    BatchNormalizationLayer, LayerNormalizationLayer, RMSNormLayer,
)
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.layers.output import (
    CenterLossOutputLayer, CnnLossLayer, LossLayer, OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BidirectionalLayer, GravesBidirectionalLSTMLayer, GravesLSTMLayer, GRULayer,
    LastTimeStepLayer, LSTMLayer, MaskZeroLayer, SimpleRnnLayer,
    TimeDistributedLayer,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (
    AutoEncoderLayer, VariationalAutoencoderLayer,
)

__all__ = [
    "Layer", "register_layer",
    "DenseLayer", "ActivationLayer", "DropoutLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer", "ElementWiseMultiplicationLayer",
    "OutputLayer", "RnnOutputLayer", "LossLayer", "CenterLossOutputLayer",
    "CnnLossLayer",
    "ConvolutionLayer", "Convolution1DLayer", "Convolution3DLayer",
    "Deconvolution2DLayer", "SeparableConvolution2DLayer",
    "DepthwiseConvolution2DLayer", "SubsamplingLayer", "Subsampling1DLayer",
    "Upsampling2DLayer", "Cropping2DLayer", "ZeroPadding2DLayer",
    "SpaceToDepthLayer", "GlobalPoolingLayer",
    "LocalResponseNormalizationLayer",
    "BatchNormalizationLayer", "LayerNormalizationLayer", "RMSNormLayer",
    "LSTMLayer", "GravesLSTMLayer", "GRULayer", "SimpleRnnLayer",
    "BidirectionalLayer", "GravesBidirectionalLSTMLayer", "LastTimeStepLayer",
    "MaskZeroLayer", "TimeDistributedLayer",
    "SelfAttentionLayer", "LearnedSelfAttentionLayer",
    "TransformerEncoderLayer", "PositionalEmbeddingLayer",
    "Yolo2OutputLayer",
    "AutoEncoderLayer", "VariationalAutoencoderLayer",
]
