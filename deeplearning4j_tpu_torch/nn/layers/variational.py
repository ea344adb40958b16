"""Autoencoder and variational autoencoder layers: the pretrain tier.

Counterpart of ``deeplearning4j_tpu/nn/layers/variational.py``:
``AutoEncoderLayer`` (``:27-83``, DL4J's denoising AutoEncoder) and
``VariationalAutoencoderLayer`` (``:86-182``, DL4J's
VariationalAutoencoder with a gaussian or bernoulli reconstruction
distribution). Each carries its own encoder and decoder params and is
trained layer-wise by ``MultiLayerNetwork.pretrain``; the supervised
forward (``apply``) runs the encoder half only. Same fields, defaults and
param keys as the JAX layers, so a configuration JSON and params cross.

The noise of a pretrain step (the corruption mask, the reparameterization
draws) comes from a ``torch.Generator`` in one function,
``pretrain_noise``, apart from the loss given that noise
(``pretrain_loss(..., noise=)``): threefry is not torch's generator, so
parity with the JAX package holds the loss given the noise JAX drew.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.common.dtypes import matmul
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, register_layer, resolve_activation,
)


def _flat(x):
    return x.reshape(x.shape[0], -1) if x.dim() > 2 else x


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class AutoEncoderLayer(Layer):
    """Denoising autoencoder (org.deeplearning4j.nn.conf.layers.AutoEncoder).

    corruption_level: the probability of zeroing each input in pretraining
    (the reference's corruptionLevel). The decoder ties its weights to the
    encoder's (``W`` transposed) and has its own visible bias ``vb``."""

    n_out: int
    n_in: Optional[int] = None
    activation: str = "sigmoid"
    corruption_level: float = 0.3
    loss: str = "mse"  # reconstruction loss: mse | xent

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        nin = self.n_in or itype.size
        p = {"W": self._w(generator, (nin, self.n_out), device),
             "b": self._b((self.n_out,), device),
             "vb": torch.zeros((nin,), device=device)}
        return p, {}

    def _encode(self, params, x):
        return resolve_activation(self.activation)(
            matmul(x, params["W"]) + params["b"])

    def _decode(self, params, h):
        return resolve_activation(self.activation)(
            matmul(h, params["W"].T) + params["vb"])

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = _flat(self._maybe_dropout(x, train, rng))
        return self._encode(params, x), state

    def pretrain_noise(self, x, rng):
        """The corruption mask of one step: True where an input is kept
        (probability 1 - corruption_level); None without corruption or
        without a generator."""
        if self.corruption_level <= 0 or rng is None:
            return None
        x = _flat(x)
        return torch.rand(x.shape, generator=rng, device=x.device) < (
            1.0 - self.corruption_level)

    def pretrain_loss(self, params, x, rng=None, *, noise=None):
        """Reconstruction loss of the corrupted input (a batch scalar): the
        mask is ``noise`` if given, else drawn from ``rng``."""
        x = _flat(x)
        keep = self.pretrain_noise(x, rng) if noise is None else noise
        corrupted = x if keep is None else torch.where(
            keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        recon = self._decode(params, self._encode(params, corrupted))
        if self.loss == "xent":
            eps = 1e-7
            r = torch.clamp(recon, eps, 1 - eps)
            return -(x * torch.log(r) + (1 - x) * torch.log(1 - r)).sum(
                -1).mean()
        return ((recon - x) ** 2).sum(-1).mean()


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class VariationalAutoencoderLayer(Layer):
    """VAE (org.deeplearning4j.nn.conf.layers.variational
    .VariationalAutoencoder).

    Gaussian posterior q(z|x) = N(mu(x), exp(logvar(x))); the pretrain loss
    is the negative ELBO with a gaussian or bernoulli reconstruction
    distribution, averaged over ``num_samples`` draws. The supervised
    forward outputs the posterior mean."""

    n_out: int  # latent size
    encoder_layer_sizes: tuple = (256,)
    decoder_layer_sizes: tuple = (256,)
    n_in: Optional[int] = None
    activation: str = "relu"
    reconstruction_distribution: str = "gaussian"  # gaussian | bernoulli
    num_samples: int = 1

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        nin = self.n_in or itype.size
        p = {"enc": [], "dec": []}
        prev = nin
        for h in self.encoder_layer_sizes:
            p["enc"].append({"W": self._w(generator, (prev, h), device),
                             "b": torch.zeros((h,), device=device)})
            prev = h
        p["mu_W"] = self._w(generator, (prev, self.n_out), device)
        p["mu_b"] = torch.zeros((self.n_out,), device=device)
        p["lv_W"] = self._w(generator, (prev, self.n_out), device)
        p["lv_b"] = torch.zeros((self.n_out,), device=device)
        prev = self.n_out
        for h in self.decoder_layer_sizes:
            p["dec"].append({"W": self._w(generator, (prev, h), device),
                             "b": torch.zeros((h,), device=device)})
            prev = h
        out_mult = 2 if self.reconstruction_distribution == "gaussian" else 1
        p["out_W"] = self._w(generator, (prev, nin * out_mult), device)
        p["out_b"] = torch.zeros((nin * out_mult,), device=device)
        return p, {}

    def _mlp(self, layers, x):
        act = resolve_activation(self.activation)
        for l in layers:
            x = act(matmul(x, l["W"]) + l["b"])
        return x

    def encode(self, params, x):
        h = self._mlp(params["enc"], x)
        mu = matmul(h, params["mu_W"]) + params["mu_b"]
        logvar = matmul(h, params["lv_W"]) + params["lv_b"]
        return mu, logvar

    def decode(self, params, z):
        h = self._mlp(params["dec"], z)
        return matmul(h, params["out_W"]) + params["out_b"]

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = _flat(self._maybe_dropout(x, train, rng))
        mu, _ = self.encode(params, x)
        return mu, state

    def pretrain_noise(self, x, rng):
        """The reparameterization draws of one step: eps [num_samples, B,
        n_out] from N(0, 1)."""
        if rng is None:
            raise ValueError("VariationalAutoencoderLayer: pretraining draws "
                             "its samples from a generator")
        x = _flat(x)
        return torch.randn((self.num_samples, x.shape[0], self.n_out),
                           generator=rng, device=x.device)

    def pretrain_loss(self, params, x, rng=None, *, noise=None):
        """Negative ELBO (reconstruction + KL), a batch scalar; sample ``s``
        is z = mu + exp(logvar / 2) * eps[s], eps ``noise`` if given, else
        drawn from ``rng``."""
        x = _flat(x)
        eps = self.pretrain_noise(x, rng) if noise is None else noise
        mu, logvar = self.encode(params, x)
        kl = 0.5 * (torch.exp(logvar) + mu ** 2 - 1.0 - logvar).sum(-1)
        rec = 0.0
        for s in range(self.num_samples):
            z = mu + torch.exp(0.5 * logvar) * eps[s]
            out = self.decode(params, z)
            if self.reconstruction_distribution == "bernoulli":
                p = torch.clamp(torch.sigmoid(out), 1e-7, 1 - 1e-7)
                rec = rec - (x * torch.log(p)
                             + (1 - x) * torch.log(1 - p)).sum(-1)
            else:
                xm, xlv = torch.chunk(out, 2, dim=-1)
                rec = rec + 0.5 * (((x - xm) ** 2) * torch.exp(-xlv) + xlv
                                   + math.log(2 * math.pi)).sum(-1)
        rec = rec / self.num_samples
        return (rec + kl).mean()

    def reconstruct(self, params, x, rng=None):
        """Posterior-mean reconstruction (generateAtMeanGivenZ analog)."""
        x = _flat(x)
        mu, _ = self.encode(params, x)
        out = self.decode(params, mu)
        if self.reconstruction_distribution == "bernoulli":
            return torch.sigmoid(out)
        return torch.chunk(out, 2, dim=-1)[0]
