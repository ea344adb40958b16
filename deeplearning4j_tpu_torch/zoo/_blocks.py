"""Shared building blocks for zoo architectures (conv-bn-act stacks).

Counterpart of ``deeplearning4j_tpu/zoo/_blocks.py``.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
)


def cbr(g, name, inp, n_out, kernel, strides=(1, 1), activation="relu",
        batch_norm=True, padding="same"):
    """conv -> [bn] -> activation on a graph builder; returns the output
    vertex's name."""
    g.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel=kernel, strides=strides,
                                 padding=padding, activation="identity",
                                 has_bias=not batch_norm), inp)
    prev = f"{name}_conv"
    if batch_norm:
        g.add_layer(f"{name}_bn", BatchNormalizationLayer(), prev)
        prev = f"{name}_bn"
    if activation and activation != "identity":
        g.add_layer(f"{name}_act", ActivationLayer(activation=activation), prev)
        prev = f"{name}_act"
    return prev
