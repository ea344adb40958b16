"""Attention layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``:
``SelfAttentionLayer``, ``LearnedSelfAttentionLayer``,
``PositionalEmbeddingLayer`` and ``TransformerEncoderLayer`` (BERT's block),
all on the ``multi_head_attention`` op, whose ``dot_product_attention``
takes the flash-attention kernels for CUDA tensors. A [B, T] padding mask
becomes a [B, 1, 1, T] key mask (``_attn_mask``), which the kernels take
as key padding.

Dropout in the encoder draws its masks from the network's
``torch.Generator`` (the JAX package splits a key): the two packages agree
with dropout off.

The encoder's KV-cache decode path (``init_cache``, ``apply_step``,
``apply_prefill``) serves a causal stack token by token. ``apply_step``
writes the step's K/V into the ring tensors it is given, in place, so a
captured CUDA graph keeps their addresses; ``apply_prefill`` runs the
causal ``dot_product_attention``, which takes the flash forward kernel on
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, register_layer, resolve_activation,
)
from deeplearning4j_tpu_torch.nn.layers.norm import layer_norm
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.quantize.kvcache import ring_write_quantized
import deeplearning4j_tpu_torch.ops  # noqa: F401  (register ops and kernels)


def _attn_mask(mask, Tq, Tk):
    """[B, Tk] padding mask -> [B, 1, 1, Tk] bool key mask, or None."""
    if mask is None:
        return None
    return mask[:, None, None, :].to(torch.bool)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over [B, T, F]."""

    n_out: int
    n_heads: int = 1
    head_size: Optional[int] = None
    n_in: Optional[int] = None
    project_input: bool = True

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init(self, generator, itype, device):
        nin = self.n_in or itype.shape[1]
        D = (self.head_size or self.n_out // self.n_heads) * self.n_heads
        return {
            "Wq": self._w(generator, (nin, D), device),
            "Wk": self._w(generator, (nin, D), device),
            "Wv": self._w(generator, (nin, D), device),
            "Wo": self._w(generator, (D, self.n_out), device),
        }, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y = op("multi_head_attention")(
            x, x, params["Wq"], params["Wk"], params["Wv"], params["Wo"],
            n_heads=self.n_heads,
            mask=_attn_mask(mask, x.shape[1], x.shape[1]))
        return y, state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """Attention with ``n_queries`` learned query vectors: output
    [B, n_queries, n_out], a fixed-size summary of a variable sequence."""

    n_queries: int = 1

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, self.n_queries)

    def init(self, generator, itype, device):
        p, s = super().init(generator, itype, device)
        nin = self.n_in or itype.shape[1]
        p["Q"] = self._w(generator, (self.n_queries, nin), device)
        return p, s

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        q = params["Q"].expand((x.shape[0],) + tuple(params["Q"].shape))
        y = op("multi_head_attention")(
            q, x, params["Wq"], params["Wk"], params["Wv"], params["Wo"],
            n_heads=self.n_heads,
            mask=_attn_mask(mask, self.n_queries, x.shape[1]))
        return y, state

    def feed_forward_mask(self, mask, itype):
        return None


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class PositionalEmbeddingLayer(Layer):
    """Adds learned positional embeddings P [max_len, F] to [B, T, F]."""

    max_len: int = 512
    n_out: Optional[int] = None

    def init(self, generator, itype, device):
        d = self.n_out or itype.shape[1]
        P = 0.02 * torch.randn((self.max_len, d), generator=generator)
        return {"P": P.to(device)}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x + params["P"][:x.shape[1]], state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class TransformerEncoderLayer(Layer):
    """Transformer encoder block: MHA + residual + LN, then MLP + residual +
    LN; ``pre_norm`` normalizes each half's input instead of its output."""

    d_model: int
    n_heads: int = 8
    d_ff: Optional[int] = None
    activation: str = "gelu"
    dropout_rate: float = 0.0
    causal: bool = False
    pre_norm: bool = True

    def output_type(self, itype):
        return InputType.recurrent(self.d_model, itype.shape[0])

    def init(self, generator, itype, device):
        D = self.d_model
        dff = self.d_ff or 4 * D
        p = {name: self._w(generator, shape, device) for name, shape in (
            ("Wq", (D, D)), ("Wk", (D, D)), ("Wv", (D, D)), ("Wo", (D, D)),
            ("W1", (D, dff)), ("W2", (dff, D)))}
        for name, n in (("bq", D), ("bk", D), ("bv", D), ("bo", D),
                        ("b1", dff), ("b2", D), ("ln1_b", D), ("ln2_b", D)):
            p[name] = torch.zeros((n,), device=device)
        p["ln1_g"] = torch.ones((D,), device=device)
        p["ln2_g"] = torch.ones((D,), device=device)
        return p, {}

    @staticmethod
    def _ln(x, params, i):
        return layer_norm(x, params[f"ln{i}_g"], params[f"ln{i}_b"], 1e-5)

    def _drop(self, x, train, rng):
        if not train or self.dropout_rate <= 0 or rng is None:
            return x
        keep = 1.0 - self.dropout_rate
        m = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        am = _attn_mask(mask, x.shape[1], x.shape[1])
        h = self._ln(x, params, 1) if self.pre_norm else x
        a = op("multi_head_attention")(
            h, h, params["Wq"], params["Wk"], params["Wv"], params["Wo"],
            n_heads=self.n_heads, mask=am, causal=self.causal,
            bq=params["bq"], bk=params["bk"], bv=params["bv"],
            bo=params["bo"])
        x = x + self._drop(a, train, rng)
        if not self.pre_norm:
            x = self._ln(x, params, 1)

        h = self._ln(x, params, 2) if self.pre_norm else x
        m = resolve_activation(self.activation)(h @ params["W1"] + params["b1"])
        m = m @ params["W2"] + params["b2"]
        x = x + self._drop(m, train, rng)
        if not self.pre_norm:
            x = self._ln(x, params, 2)
        return x, state

    # ---------------------------------------------- decode (KV-cache) path
    def _split_heads(self, t):
        """[B, D] -> [B, N, Dh]; [B, T, D] -> [B, N, T, Dh]."""
        B, N = t.shape[0], self.n_heads
        Dh = self.d_model // N
        if t.dim() == 2:
            return t.reshape(B, N, Dh)
        return t.reshape(B, t.shape[1], N, Dh).transpose(1, 2)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   kv_dtype=None, device=None):
        """Zeroed KV rings for cached decode: (k, v), each [batch, n_heads,
        max_len, head_dim] of ``dtype``; with ``kv_dtype="int8"`` the
        4-tuple (k, v, k_scale, v_scale) of int8 rings and per-(row, head)
        f32 running absmax scales."""
        Dh = self.d_model // self.n_heads
        shape = (batch, self.n_heads, max_len, Dh)
        if kv_dtype == "int8":
            scale = (batch, self.n_heads)
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(scale, device=device),
                    torch.zeros(scale, device=device))
        if kv_dtype is not None:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _mlp_half(self, x, params):
        h = self._ln(x, params, 2) if self.pre_norm else x
        m = resolve_activation(self.activation)(h @ params["W1"] + params["b1"])
        x = x + (m @ params["W2"] + params["b2"])
        if not self.pre_norm:
            x = self._ln(x, params, 2)
        return x

    def _qkv(self, x, params):
        h = self._ln(x, params, 1) if self.pre_norm else x
        return tuple(self._split_heads(h @ params[f"W{n}"] + params[f"b{n}"])
                     for n in "qkv")

    def _attn_half(self, x, o, params):
        x = x + (o @ params["Wo"] + params["bo"])
        return self._ln(x, params, 1) if not self.pre_norm else x

    def apply_step(self, params, x, cache, pos):
        """One decode step from the KV ring: x [B, D] (the current token's
        activations), cache (k, v) [B, N, L, Dh] or the int8 4-tuple of
        ``init_cache``, pos [B] absolute positions (the write slot is
        ``pos % L``). Writes the step's K/V into the ring in place (the
        int8 ring requantizes in place too) and returns (y [B, D], cache).
        Equals ``apply`` with ``causal=True`` over the whole prefix."""
        k_cache, v_cache = cache[0], cache[1]
        L = k_cache.shape[2]
        B = x.shape[0]
        q, k, v = self._qkv(x, params)                       # [B, N, Dh]
        slot = pos % L
        rows = torch.arange(B, device=x.device)
        if len(cache) == 4:
            _, _, k_sc, v_sc = cache
            ring_write_quantized(k_cache, k_sc, k, rows, slot)
            ring_write_quantized(v_cache, v_sc, v, rows, slot)
            scales = dict(k_scale=k_sc, v_scale=v_sc)
        else:
            k_cache[rows, :, slot] = k.to(k_cache.dtype)
            v_cache[rows, :, slot] = v.to(v_cache.dtype)
            scales = {}
        o = op("cached_dot_product_attention")(
            q[:, :, None, :], k_cache, v_cache, pos, **scales)  # [B,N,1,Dh]
        x = self._attn_half(x, o[:, :, 0, :].reshape(B, -1), params)
        return self._mlp_half(x, params), cache

    def apply_prefill(self, params, x, *, mask=None):
        """Causal forward over the whole prompt x [B, T, D] that also
        returns the K/V heads ([B, N, T, Dh] each), to seed a ring in one
        pass. Right padding is safe: under the causal mask position i sees
        only j <= i."""
        am = _attn_mask(mask, x.shape[1], x.shape[1])
        q, k, v = self._qkv(x, params)
        o = op("dot_product_attention")(q, k, v, mask=am, causal=True)
        B, T = x.shape[0], x.shape[1]
        x = self._attn_half(x, o.transpose(1, 2).reshape(B, T, -1), params)
        return self._mlp_half(x, params), (k, v)
