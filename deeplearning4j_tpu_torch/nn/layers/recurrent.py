"""Recurrent layers: LSTM, GravesLSTM, GRU, SimpleRnn, the Bidirectional
wrappers, LastTimeStep, MaskZero and TimeDistributed.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``. Sequence
layout is [batch, time, features]. Param keys mirror DL4J: "W" (input
weights [in, G*H]), "RW" (recurrent weights [H, G*H]), "b" [G*H], with G
= 4 for the LSTMs, 3 for the GRU and 1 for SimpleRnn; GravesLSTM adds "pW"
[3H] (peepholes); a Bidirectional layer holds {"fwd": {...}, "bwd":
{...}}. Every LSTM forward goes through the ``lstm_layer`` op and every
GRU forward through ``gru_layer``, which take the fused-LSTM and fused-GRU
kernels for CUDA tensors; SimpleRnn's ``simple_rnn_layer`` has no kernel
(the JAX package has none either). A layer's carry is a tuple: (h, c) for
the LSTMs, the one-tuple (h,) for the GRU and SimpleRnn.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, register_layer, resolve_activation,
)
from deeplearning4j_tpu_torch.ops.registry import op
import deeplearning4j_tpu_torch.ops  # noqa: F401  (register ops and kernels)


def _mask_outputs(ys, mask):
    if mask is None:
        return ys
    return ys * mask[..., None].to(ys.dtype)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class LSTMLayer(Layer):
    """Standard LSTM (no peepholes)."""

    n_out: int
    n_in: Optional[int] = None
    activation: str = "tanh"  # cell candidate activation
    forget_gate_bias_init: float = 1.0
    weight_init: str = "xavier"

    peephole = False

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init(self, generator, itype, device):
        nin = self.n_in or itype.shape[1]
        H = self.n_out
        b = torch.zeros((4 * H,), dtype=torch.float32, device=device)
        b[H:2 * H] = self.forget_gate_bias_init
        p = {
            "W": self._w(generator, (nin, 4 * H), device, fan_in=nin, fan_out=H),
            "RW": self._w(generator, (H, 4 * H), device, fan_in=H, fan_out=H),
            "b": b,
        }
        if self.peephole:
            p["pW"] = torch.zeros((3 * H,), dtype=torch.float32, device=device)
        return p, {}

    def _run(self, params, x, h0, c0, reverse=False):
        return op("lstm_layer")(x, h0, c0, params["W"], params["RW"],
                                params["b"], peephole=params.get("pW"),
                                reverse=reverse)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None,
              reverse=False):
        """Full sequence from a zero carry; ``reverse`` runs it over
        reversed time and returns the outputs in natural order."""
        x = self._maybe_dropout(x, train, rng)
        h0, c0 = self.initial_carry(x.shape[0], x.dtype, x.device)
        ys, _ = self._run(params, x, h0, c0, reverse)
        return _mask_outputs(ys, mask), state

    def step(self, params, carry, x_t):
        """Single-timestep advance. carry=(h,c), x_t [B,F]."""
        ys, (h, c) = self._run(params, x_t[:, None, :], carry[0], carry[1])
        return (h, c), ys[:, 0]

    def apply_with_carry(self, params, x, carry, *, mask=None):
        """Sequence forward from an explicit carry. Returns
        (outputs [B,T,H], new_carry)."""
        ys, (h, c) = self._run(params, x, carry[0], carry[1])
        return _mask_outputs(ys, mask), (h, c)

    def initial_carry(self, batch, dtype=torch.float32, device="cpu"):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class GravesLSTMLayer(LSTMLayer):
    """LSTM with peephole connections (i, f read c_{t-1}; o reads c_t)."""

    peephole = True


class _HCarryLayer(Layer):
    """A recurrent layer whose carry is h alone; ``_run`` calls its op."""

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.shape[0])

    def _run(self, params, x, h0, reverse=False):
        raise NotImplementedError

    def apply(self, params, state, x, *, train=False, rng=None, mask=None,
              reverse=False):
        """Full sequence from a zero carry; ``reverse`` runs it over
        reversed time and returns the outputs in natural order."""
        x = self._maybe_dropout(x, train, rng)
        (h0,) = self.initial_carry(x.shape[0], x.dtype, x.device)
        ys, _ = self._run(params, x, h0, reverse)
        return _mask_outputs(ys, mask), state

    def step(self, params, carry, x_t):
        """Single-timestep advance. carry=(h,), x_t [B,F]."""
        ys, h = self._run(params, x_t[:, None, :], carry[0])
        return (h,), ys[:, 0]

    def apply_with_carry(self, params, x, carry, *, mask=None):
        """Sequence forward from an explicit carry. Returns
        (outputs [B,T,H], new_carry)."""
        ys, h = self._run(params, x, carry[0])
        return _mask_outputs(ys, mask), (h,)

    def initial_carry(self, batch, dtype=torch.float32, device="cpu"):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class GRULayer(_HCarryLayer):
    """GRU, gate order r, z, n, linear before reset (libnd4j gruCell)."""

    n_out: int
    n_in: Optional[int] = None
    weight_init: str = "xavier"

    def init(self, generator, itype, device):
        nin = self.n_in or itype.shape[1]
        H = self.n_out
        return {
            "W": self._w(generator, (nin, 3 * H), device, fan_in=nin, fan_out=H),
            "RW": self._w(generator, (H, 3 * H), device, fan_in=H, fan_out=H),
            "b": torch.zeros((3 * H,), dtype=torch.float32, device=device),
        }, {}

    def _run(self, params, x, h0, reverse=False):
        return op("gru_layer")(x, h0, params["W"], params["RW"], params["b"],
                               reverse=reverse)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class SimpleRnnLayer(_HCarryLayer):
    """Elman RNN (org.deeplearning4j.nn.conf.layers.recurrent.SimpleRnn)."""

    n_out: int
    n_in: Optional[int] = None
    activation: str = "tanh"
    weight_init: str = "xavier"

    def init(self, generator, itype, device):
        nin = self.n_in or itype.shape[1]
        return {
            "W": self._w(generator, (nin, self.n_out), device),
            "RW": self._w(generator, (self.n_out, self.n_out), device),
            "b": torch.zeros((self.n_out,), dtype=torch.float32,
                             device=device),
        }, {}

    def _run(self, params, x, h0, reverse=False):
        return op("simple_rnn_layer")(
            x, h0, params["W"], params["RW"], params["b"],
            activation=resolve_activation(self.activation), reverse=reverse)


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class BidirectionalLayer(Layer):
    """Wraps a recurrent layer forward and backward in time (DL4J
    Bidirectional); mode: concat | add | mul | average.

    The JAX package runs the backward direction on the time-flipped input
    and flips its outputs back. Here the wrapped layer runs it with
    ``reverse=True``: its op (``lstm_layer``, ``gru_layer`` or
    ``simple_rnn_layer``) flips the projected gates after the input
    projection and its outputs back, the same function, and the fused
    kernels walk reversed time in their own domain."""

    fwd: Layer = None
    mode: str = "concat"

    def output_type(self, itype):
        ot = self.fwd.output_type(itype)
        if self.mode == "concat":
            return InputType.recurrent(ot.shape[1] * 2, ot.shape[0])
        return ot

    def init(self, generator, itype, device):
        pf, _ = self.fwd.init(generator, itype, device)
        pb, _ = self.fwd.init(generator, itype, device)
        return {"fwd": pf, "bwd": pb}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        yf, _ = self.fwd.apply(params["fwd"], {}, x, train=train, rng=rng,
                               mask=mask)
        yb, _ = self.fwd.apply(params["bwd"], {}, x, train=train, rng=rng,
                               mask=mask, reverse=True)
        m = self.mode.lower()
        if m == "concat":
            return torch.cat([yf, yb], -1), state
        if m == "add":
            return yf + yb, state
        if m == "mul":
            return yf * yb, state
        if m in ("average", "avg"):
            return 0.5 * (yf + yb), state
        raise ValueError(f"unknown Bidirectional mode {self.mode}")


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class GravesBidirectionalLSTMLayer(BidirectionalLayer):
    """DL4J GravesBidirectionalLSTM == Bidirectional(GravesLSTM)."""

    n_out: int = 0
    n_in: Optional[int] = None
    fwd: Layer = None

    def __post_init__(self):
        if self.fwd is None:
            object.__setattr__(
                self, "fwd", GravesLSTMLayer(n_out=self.n_out, n_in=self.n_in))


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class LastTimeStepLayer(Layer):
    """[B,T,F] -> [B,F], taking the last *unmasked* step
    (org.deeplearning4j.nn.conf.layers.recurrent.LastTimeStep)."""

    underlying: Optional[Layer] = None

    def output_type(self, itype):
        it = self.underlying.output_type(itype) if self.underlying else itype
        return InputType.feed_forward(it.shape[1])

    def init(self, generator, itype, device):
        if self.underlying:
            return self.underlying.init(generator, itype, device)
        return {}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if self.underlying:
            x, state = self.underlying.apply(params, state, x, train=train,
                                             rng=rng, mask=mask)
        if mask is None:
            return x[:, -1, :], state
        idx = torch.clamp(mask.sum(1).long() - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx], state

    def feed_forward_mask(self, mask, itype):
        return None


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class MaskZeroLayer(Layer):
    """Masks the steps whose input is all ``mask_value`` for the wrapped
    layer (org.deeplearning4j.nn.conf.layers.util.MaskZeroLayer)."""

    underlying: Optional[Layer] = None
    mask_value: float = 0.0

    def output_type(self, itype):
        return self.underlying.output_type(itype) if self.underlying else itype

    def init(self, generator, itype, device):
        if self.underlying:
            return self.underlying.init(generator, itype, device)
        return {}, {}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        computed = (x != self.mask_value).any(-1).float()
        if self.underlying:
            return self.underlying.apply(params, state, x, train=train,
                                         rng=rng, mask=computed)
        return x, state


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class TimeDistributedLayer(Layer):
    """Applies a feed-forward layer to every timestep
    (org.deeplearning4j.nn.conf.layers.recurrent.TimeDistributed)."""

    underlying: Layer = None

    def output_type(self, itype):
        inner = self.underlying.output_type(
            InputType.feed_forward(itype.shape[1]))
        return InputType.recurrent(inner.size, itype.shape[0])

    def init(self, generator, itype, device):
        return self.underlying.init(
            generator, InputType.feed_forward(itype.shape[1]), device)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b, t = x.shape[0], x.shape[1]
        y, state = self.underlying.apply(params, state, x.reshape(b * t, -1),
                                         train=train, rng=rng)
        return y.reshape(b, t, -1), state
