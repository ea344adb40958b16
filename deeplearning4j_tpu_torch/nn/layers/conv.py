"""Convolutional-family layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/conv.py``; this slice ports
``GlobalPoolingLayer`` (``conv.py:446``), which BERT's classifier head uses
over time. The convolution and subsampling layers come with LeNet.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial or time axes: CNN [B, H, W, C] ->
    [B, C], RNN [B, T, F] -> [B, F]. An RNN input's [B, T] mask makes the
    max, average and sum masked (DL4J's masked pooling)."""

    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, itype):
        if itype.kind == "rnn":
            return InputType.feed_forward(itype.shape[1])
        return InputType.feed_forward(itype.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        axes = tuple(range(1, x.dim() - 1))
        pt = self.pooling_type.lower()
        if mask is not None and x.dim() == 3:  # RNN masked pooling
            m = mask[..., None].to(x.dtype)
            if pt in ("avg", "average"):
                return (x * m).sum(axes) / m.sum(axes).clamp_min(1.0), state
            if pt == "sum":
                return (x * m).sum(axes), state
            if pt == "max":
                neg = torch.finfo(x.dtype).min
                return x.masked_fill(m <= 0, neg).amax(axes), state
        if pt == "max":
            return x.amax(axes), state
        if pt in ("avg", "average"):
            return x.mean(axes), state
        if pt == "sum":
            return x.sum(axes), state
        if pt == "pnorm":
            return (x.abs() ** self.pnorm).sum(axes) ** (1.0 / self.pnorm), state
        raise ValueError(f"unknown pooling type {self.pooling_type}")

    def feed_forward_mask(self, mask, itype):
        return None
