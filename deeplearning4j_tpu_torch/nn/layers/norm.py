"""Normalization layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/norm.py``; this slice ports
``LayerNormalizationLayer`` (``norm.py:77``), the transformer's. Batch
normalization and RMSNorm come with the models that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


def layer_norm(x, gamma, beta, eps):
    """Over the last axis: population variance, ``(x - mean) * 1/sqrt(var +
    eps)``, then the affine map when ``gamma`` is given."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    xhat = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        xhat = xhat * gamma + beta
    return xhat.to(x.dtype)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class LayerNormalizationLayer(Layer):
    """Layer norm over the feature (last) axis; output in the input's
    dtype."""

    n_out: Optional[int] = None
    eps: float = 1e-5
    elementwise_affine: bool = True

    def init(self, generator, itype, device):
        n = self.n_out or (itype.shape[-1] if itype.kind != "ff"
                           else itype.size)
        if not self.elementwise_affine:
            return {}, {}
        return {"gamma": torch.ones((n,), device=device),
                "beta": torch.zeros((n,), device=device)}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return layer_norm(x, params.get("gamma"), params.get("beta"),
                          self.eps), state
