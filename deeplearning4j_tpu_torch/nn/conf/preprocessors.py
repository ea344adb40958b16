"""Input preprocessors — reshape adapters between layer families.

Counterpart of the part of ``deeplearning4j_tpu/nn/conf/preprocessors.py``
that ``MultiLayerConfiguration.resolve()`` needs for the ported layers: the
(de)serializable base, ``auto_preprocessor`` and the two preprocessors it
can insert in front of a dense or recurrent layer.
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
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B,H,W,C] -> [B, H, W*C] treating height as time."""

    def __call__(self, x, mask=None):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)

    def output_type(self, itype):
        h, w, c = itype.shape
        return InputType.recurrent(w * c, h)


def auto_preprocessor(prev: InputType, layer) -> InputPreProcessor | None:
    """The DL4J-standard preprocessor between ``prev`` and ``layer``."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer, TransformerEncoderLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        BidirectionalLayer, LSTMLayer,
    )

    rnn_layers = (LSTMLayer, BidirectionalLayer, SelfAttentionLayer,
                  TransformerEncoderLayer, RnnOutputLayer)
    if prev.kind in ("cnn", "cnn3d") and isinstance(layer, DenseLayer) \
            and not isinstance(layer, RnnOutputLayer):
        return FlattenPreProcessor()
    if prev.kind == "cnn" and isinstance(layer, rnn_layers):
        return CnnToRnnPreProcessor()
    return None
