"""Input preprocessors — reshape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: the
(de)serializable base, the five preprocessors and ``auto_preprocessor``,
which ``MultiLayerConfiguration.resolve()`` calls between layers. Layer
families the port has not taken over yet (Deconvolution2D, Upsampling2D,
GRU, ...) are not in its tables; a configuration naming them fails to load
first.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

PREPROC_REGISTRY: dict[str, type] = {}


def _register(cls):
    PREPROC_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class InputPreProcessor:
    def __call__(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, itype: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        kind = d.pop("@type")
        if kind not in PREPROC_REGISTRY:
            raise ValueError(f"preprocessor '{kind}' is not ported yet")
        cls = PREPROC_REGISTRY[kind]
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})


@_register
@dataclasses.dataclass(frozen=True)
class FlattenPreProcessor(InputPreProcessor):
    """CNN [B,H,W,C] (or any rank) -> FF [B, H*W*C]."""

    def __call__(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, itype):
        return InputType.feed_forward(itype.size)


@_register
@dataclasses.dataclass(frozen=True)
class ReshapeToCnnPreProcessor(InputPreProcessor):
    """FF [B, H*W*C] -> CNN [B, H, W, C] NHWC (FeedForwardToCnnPreProcessor).

    Also takes an NCHW [B, C, H, W] tensor and transposes it: the
    DL4J-data boundary, once, at the model's input."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, mask=None):
        if x.dim() == 4:
            if tuple(x.shape[1:]) == (self.height, self.width, self.channels):
                return x
            if tuple(x.shape[1:]) == (self.channels, self.height, self.width):
                return x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width, self.channels)


@_register
@dataclasses.dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, F] -> [B*T, F]."""

    def __call__(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, itype):
        return InputType.feed_forward(itype.shape[1])


@_register
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] -> [B, T, F]; the timesteps are part of the config."""

    timesteps: int = 0

    def __call__(self, x, mask=None):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, itype):
        return InputType.recurrent(itype.size, self.timesteps)


@_register
@dataclasses.dataclass(frozen=True)
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B,H,W,C] -> [B, H, W*C] treating height as time."""

    def __call__(self, x, mask=None):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)

    def output_type(self, itype):
        h, w, c = itype.shape
        return InputType.recurrent(w * c, h)


def auto_preprocessor(prev: InputType, layer) -> InputPreProcessor | None:
    """The DL4J-standard preprocessor between ``prev`` and ``layer``. As in
    the JAX package, a CNN activation reaching a 1-D conv or pool gets
    none."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer, TransformerEncoderLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers import conv as convmod
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        BidirectionalLayer, GRULayer, LastTimeStepLayer, LSTMLayer,
        MaskZeroLayer, SimpleRnnLayer, TimeDistributedLayer,
    )

    cnn_layers = (convmod.ConvolutionLayer, convmod.SubsamplingLayer,
                  convmod.Deconvolution2DLayer,
                  convmod.SeparableConvolution2DLayer,
                  convmod.DepthwiseConvolution2DLayer,
                  convmod.Upsampling2DLayer, convmod.Cropping2DLayer,
                  convmod.ZeroPadding2DLayer, convmod.SpaceToDepthLayer,
                  convmod.LocalResponseNormalizationLayer)
    rnn_layers = (LSTMLayer, GRULayer, SimpleRnnLayer, BidirectionalLayer,
                  LastTimeStepLayer, MaskZeroLayer, TimeDistributedLayer,
                  SelfAttentionLayer, TransformerEncoderLayer, RnnOutputLayer)
    if prev.kind == "cnn_flat" and isinstance(layer, cnn_layers):
        h, w, c = prev.shape
        return ReshapeToCnnPreProcessor(h, w, c)
    if prev.kind in ("cnn", "cnn3d") and isinstance(layer, DenseLayer) \
            and not isinstance(layer, RnnOutputLayer):
        return FlattenPreProcessor()
    if prev.kind == "cnn" and isinstance(layer, rnn_layers):
        return CnnToRnnPreProcessor()
    if prev.kind == "ff" and isinstance(layer, cnn_layers):
        raise ValueError(
            "feed-forward -> CNN needs an explicit ReshapeToCnnPreProcessor(h, w, c)"
        )
    return None
