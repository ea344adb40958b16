"""Normalization layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/norm.py``:
``BatchNormalizationLayer`` (``norm.py:22``), whose running statistics live
in the network's ``state`` and move with every training step, and
``LayerNormalizationLayer`` (``norm.py:77``), the transformer's, and
``RMSNormLayer`` (``norm.py:101``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import replicas
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class BatchNormalizationLayer(Layer):
    """Batch norm over the channel/feature (last) axis: NHWC activations
    normalize per channel, [B, F] ones per feature.

    DL4J semantics, as the JAX layer keeps them: ``decay`` is the running
    average's retention (mean = decay * mean + (1 - decay) * batch mean,
    the same for var), eps 1e-5, ``lock_gamma_beta`` drops the affine
    params, ``use_mean_var_from_state`` normalizes with the running
    statistics even in training. Params ``gamma``, ``beta``; state ``mean``,
    ``var``, all f32. Under a data-parallel trainer (``nn/replicas.py``) the
    training statistics are averaged over the replicas, so every rank
    normalizes with, and moves its running statistics by, the whole
    batch's."""

    n_out: Optional[int] = None  # inferred
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    use_mean_var_from_state: bool = False

    def _n(self, itype):
        if self.n_out:
            return self.n_out
        if itype.kind in ("cnn", "cnn3d"):
            return itype.channels
        return itype.shape[1] if itype.kind == "rnn" else itype.size

    def init(self, generator, itype, device):
        n = self._n(itype)
        p = {} if self.lock_gamma_beta else {
            "gamma": torch.ones((n,), device=device),
            "beta": torch.zeros((n,), device=device)}
        s = {"mean": torch.zeros((n,), device=device),
             "var": torch.ones((n,), device=device)}
        return p, s

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        axes = tuple(range(x.dim() - 1))
        if train and not self.use_mean_var_from_state:
            # one-pass statistics, E[x^2] - E[x]^2 clamped at 0, summed in
            # f32 for bf16 activations (the JAX layer's, not F.batch_norm's
            # two-pass variance); the running update carries no gradient
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean, msq = xf.mean(axes), (xf * xf).mean(axes)
            rep = replicas.active()
            if rep is not None:
                # under data parallelism the statistics are the whole
                # batch's, as the JAX layer's are under SPMD: the replicas'
                # equal slices average, with a gradient through the sum
                mean, msq = rep.stats(torch.cat([mean, msq])).chunk(2)
            var = (msq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                new_state = {
                    "mean": self.decay * state["mean"]
                    + (1 - self.decay) * mean.detach(),
                    "var": self.decay * state["var"]
                    + (1 - self.decay) * var.detach(),
                }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        # normalize in the activation's type: the statistics are f32, but
        # the activation-sized tensors (and their gradients) stay narrow
        inv = torch.reciprocal(torch.sqrt(var + self.eps)).to(x.dtype)
        xhat = (x - mean.to(x.dtype)) * inv
        if not self.lock_gamma_beta:
            xhat = xhat * params["gamma"] + params["beta"]
        return xhat.to(x.dtype), new_state


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


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class RMSNormLayer(Layer):
    """RMSNorm over the last axis: x / sqrt(mean(x^2) + eps) * gamma, in
    the input's dtype (no DL4J analog)."""

    n_out: Optional[int] = None
    eps: float = 1e-6

    def init(self, generator, itype, device):
        n = self.n_out or itype.shape[-1]
        return {"gamma": torch.ones((n,), device=device)}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        ms = (x * x).mean(-1, keepdim=True)
        y = x * torch.reciprocal(torch.sqrt(ms + self.eps)) * params["gamma"]
        return y.to(x.dtype), state
