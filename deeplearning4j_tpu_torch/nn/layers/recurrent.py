"""Recurrent layers: LSTM, GravesLSTM and their Bidirectional wrappers.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py:36-100`` and
``:180-235``. Sequence layout is [batch, time, features]. Param keys mirror
DL4J: "W" (input weights [in, 4H]), "RW" (recurrent weights [H, 4H]), "b"
[4H]; GravesLSTM adds "pW" [3H] (peepholes); a Bidirectional layer holds
{"fwd": {...}, "bwd": {...}}. Every forward goes through the
``lstm_layer`` op, which takes the fused-LSTM kernels for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
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


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class BidirectionalLayer(Layer):
    """Wraps a recurrent layer forward and backward in time (DL4J
    Bidirectional); mode: concat | add | mul | average.

    The JAX package runs the backward direction on the time-flipped input
    and flips its outputs back. Here the wrapped layer runs it with
    ``reverse=True``: the ``lstm_layer`` op flips the projected gates after
    the input projection and its outputs back, the same function, and the
    fused-LSTM kernels walk reversed time in their own domain."""

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
