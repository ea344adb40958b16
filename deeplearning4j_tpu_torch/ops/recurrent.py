"""Recurrent ops: the plain PyTorch lowering of ``lstm_layer``.

Counterpart of ``deeplearning4j_tpu/ops/recurrent.py:26-64``. The input
projection ``x @ W + b`` for all timesteps is one large matmul; only the
sequential ``h @ R`` recurrence loops over time. Gate order is IFOG (input,
forget, output, cell candidate) with one bias ``b[4H]``; GravesLSTM
peepholes let i and f read c_{t-1} and o read c_t. This is not
``torch.nn.LSTM``, whose gate order (IFGO) and two biases differ.

Layouts: x [B, T, F] (time axis 1), h/c [B, H].
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import register_op


def project_gates(x, W, b, forget_gate_bias=0.0, reverse=False):
    """The non-sequential input projection, time-major: xg [T, B, 4H]."""
    H = W.shape[1] // 4
    xg = torch.matmul(x, W) + b
    if forget_gate_bias:
        xg[..., H:2 * H] += forget_gate_bias
    xg = xg.transpose(0, 1)
    if reverse:
        xg = xg.flip(0)
    return xg.contiguous()


def lstm_recurrence(xg, R, h0, c0, peephole=None):
    """The sequential part over time-major gates xg [T, B, 4H].

    Returns (outputs [T, B, H], hT, cT). This is the plain version of the
    fused-LSTM kernel (``ops/cuda/fused_lstm.py``). Whatever the inputs'
    type, the sums, the gates and the cell state are f32; h_{t-1} enters the
    product rounded to R's type, and the results return in the inputs' type
    (the JAX package's Pallas kernel does the same for bf16). In f32 every
    cast is a no-op."""
    H = R.shape[0]
    f32 = torch.float32
    Rf = R.to(f32)
    if peephole is not None:
        pf = peephole.to(f32)
        p_i, p_f, p_o = pf[:H], pf[H:2 * H], pf[2 * H:]
    h, c = h0.to(f32), c0.to(f32)
    outs = []
    for t in range(xg.shape[0]):
        g = xg[t].to(f32) + h.to(R.dtype).to(f32) @ Rf
        i, f, o, z = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        if peephole is not None:
            i = i + c * p_i
            f = f + c * p_f
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        z = torch.tanh(z)
        c = f * c + i * z
        if peephole is not None:
            o = o + c * p_o
        o = torch.sigmoid(o)
        h = o * torch.tanh(c)
        outs.append(h)
    if not outs:
        return xg.new_empty((0,) + tuple(h0.shape)), h0, c0
    return torch.stack(outs).to(xg.dtype), h.to(h0.dtype), c.to(c0.dtype)


def finish_layer(out, hT, cT, reverse):
    """Kernel time domain [T, B, H] back to the layer's [B, T, H]."""
    if reverse:
        out = out.flip(0)
    return out.transpose(0, 1), (hT, cT)


@register_op("lstm_layer")
def lstm_layer(x, h0, c0, W, R, b, *, peephole=None, forget_gate_bias=0.0,
               reverse=False):
    """Full-sequence LSTM.

    x [B,T,F], W [F,4H], R [H,4H], b [4H], peephole None or [3H] (i,f,o).
    Returns (outputs [B,T,H], (hT, cT))."""
    xg = project_gates(x, W, b, forget_gate_bias, reverse)
    out, hT, cT = lstm_recurrence(xg, R, h0, c0, peephole)
    return finish_layer(out, hT, cT, reverse)
