"""Recurrent ops: the plain PyTorch lowering of ``lstm_layer``.

Counterpart of ``deeplearning4j_tpu/ops/recurrent.py:26-64``, plus the plain
versions of the fused-LSTM kernels' arithmetic (``lstm_recurrence`` with its
training reserve, and ``lstm_bwd_recurrence``), which the kernels are held
against. The input
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


def lstm_recurrence(xg, R, h0, c0, peephole=None, save_residuals=False):
    """The sequential part over time-major gates xg [T, B, 4H].

    Returns (outputs [T, B, H], hT, cT), and with ``save_residuals`` also the
    training reserve [5, T, B, H] float32: the cell state c_t and the
    post-activation gates i, f, o, z, in kernel time order (what the Pallas
    ``_lstm_kernel`` saves for its backward). This is the plain version of
    the fused-LSTM forward kernel (``ops/cuda/fused_lstm.py``). Whatever the
    inputs' type, the sums, the gates and the cell state are f32; h_{t-1}
    enters the product rounded to R's type, and the results return in the
    inputs' type (the JAX package's Pallas kernel does the same for bf16).
    In f32 every cast is a no-op."""
    H = R.shape[0]
    f32 = torch.float32
    Rf = R.to(f32)
    if peephole is not None:
        pf = peephole.to(f32)
        p_i, p_f, p_o = pf[:H], pf[H:2 * H], pf[2 * H:]
    h, c = h0.to(f32), c0.to(f32)
    outs, saved = [], []
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
        if save_residuals:
            saved.append(torch.stack((c, i, f, o, z)))
    if not outs:
        res = (xg.new_empty((0,) + tuple(h0.shape)), h0, c0)
    else:
        res = (torch.stack(outs).to(xg.dtype), h.to(h0.dtype), c.to(c0.dtype))
    if not save_residuals:
        return res
    return res + (torch.stack(saved, 1),)


def lstm_bwd_recurrence(reserve, R, c0, dout, dcT=None, peephole=None):
    """The reverse-time walk over the forward's reserve [5, T, B, H].

    ``dout`` [T, B, H] is the gradient of the outputs in kernel time order,
    with the gradient of hT already added at the last step; ``dcT`` the
    gradient of cT (None: zero). Returns (dg [T, B, 4H] float32, the
    pre-activation gate gradients [dgi dgf dgo dgz], and dc0 [B, H] float32).
    This is the plain version of the fused-LSTM backward kernel
    (``csrc/fused_lstm_bwd.cu``), step by step. The carries dh_rec and dc
    are f32; dg enters the product dg @ R^T rounded to R's type, as in the
    Pallas ``_lstm_bwd_kernel``. In f32 every cast is a no-op."""
    f32 = torch.float32
    T, B, H = reserve.shape[1:]
    Rt = R.to(f32).t()
    cseq, gi, gf, go, gz = reserve
    dh_rec = reserve.new_zeros((B, H))
    dc = reserve.new_zeros((B, H)) if dcT is None else dcT.to(f32)
    if peephole is not None:
        pf = peephole.to(f32)
        p_i, p_f, p_o = pf[:H], pf[H:2 * H], pf[2 * H:]
    dg = reserve.new_empty((T, B, 4 * H))
    for t in range(T - 1, -1, -1):
        i, f, o, z, c = gi[t], gf[t], go[t], gz[t], cseq[t]
        c_prev = cseq[t - 1] if t > 0 else c0.to(f32)
        dh = dout[t].to(f32) + dh_rec
        th = torch.tanh(c)
        dgo = (dh * th) * o * (1.0 - o)
        d = dc + dh * o * (1.0 - th * th)
        if peephole is not None:
            d = d + dgo * p_o
        dgi = (d * z) * i * (1.0 - i)
        dgf = (d * c_prev) * f * (1.0 - f)
        dgz = (d * i) * (1.0 - z * z)
        dc = d * f
        if peephole is not None:
            dc = dc + dgi * p_i + dgf * p_f
        dg_t = torch.cat((dgi, dgf, dgo, dgz), 1)
        dg[t] = dg_t
        if t > 0:
            dh_rec = dg_t.to(R.dtype).to(f32) @ Rt
    return dg, dc


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
