"""Recurrent layers: LSTM and GravesLSTM.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py:36-100``.
Sequence layout is [batch, time, features]. Param keys mirror DL4J: "W"
(input weights [in, 4H]), "RW" (recurrent weights [H, 4H]), "b" [4H];
GravesLSTM adds "pW" [3H] (peepholes). Every forward goes through the
``lstm_layer`` op, which takes the fused-LSTM kernel for CUDA tensors.
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

    def _run(self, params, x, h0, c0):
        return op("lstm_layer")(x, h0, c0, params["W"], params["RW"],
                                params["b"], peephole=params.get("pW"))

    def apply(self, params, state, x, *, mask=None):
        h0, c0 = self.initial_carry(x.shape[0], x.dtype, x.device)
        ys, _ = self._run(params, x, h0, c0)
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
