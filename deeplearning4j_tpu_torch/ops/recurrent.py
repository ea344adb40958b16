"""Recurrent ops: the plain PyTorch lowerings of ``lstm_layer``,
``gru_layer`` and ``simple_rnn_layer``.

Counterpart of ``deeplearning4j_tpu/ops/recurrent.py``, plus the plain
versions of the fused-LSTM and fused-GRU kernels' arithmetic
(``lstm_recurrence`` and ``gru_recurrence`` with their training reserves,
``lstm_bwd_recurrence`` and ``gru_bwd_recurrence``), which the kernels are
held against. The input projection ``x @ W + b`` for all timesteps is one
large matmul; only the sequential ``h @ R`` recurrence loops over time.

LSTM gate order is IFOG (input, forget, output, cell candidate) with one
bias ``b[4H]``; GravesLSTM peepholes let i and f read c_{t-1} and o read
c_t. This is not ``torch.nn.LSTM``, whose gate order (IFGO) and two biases
differ. GRU gate order is r, z, n, linear before reset (n = tanh(x_n +
r * (h @ R_n))), with one bias ``b[3H]`` in the input projection and none
inside r * (...): ``torch.nn.GRU`` with its ``bias_hh`` zero computes the
same function, but the port never calls it.

Layouts: x [B, T, F] (time axis 1), h/c [B, H].
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common.dtypes import widen
from deeplearning4j_tpu_torch.ops.registry import register_op


def carry_dtype(dtype):
    """The type the recurrences sum and carry in: f32 for bf16 and f32 (the
    Pallas kernels' and the port's kernels' carries), f64 for an f64 input
    (the XLA lowering's own type; no kernel takes f64)."""
    return torch.promote_types(dtype, torch.float32)


def project_gates(x, W, b, forget_gate_bias=0.0, reverse=False):
    """The non-sequential input projection, time-major: xg [T, B, G] for
    any gate count G = W.shape[1]. ``forget_gate_bias`` is the LSTM's: it
    is added to the second of four gate blocks."""
    xg = torch.matmul(x, W) + b
    if forget_gate_bias:
        H = W.shape[1] // 4
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
    ``_lstm_kernel`` saves for its backward). This is the plain version of the
    fused-LSTM forward kernel (``ops/cuda/fused_lstm.py``). Whatever the
    inputs' type, the sums, the gates and the cell state are f32 (f64 for f64
    inputs); h_{t-1} enters the product rounded to R's type, and the results
    return in the inputs' type (the JAX package's Pallas kernel does the same
    for bf16). In f32 every cast is a no-op."""
    H = R.shape[0]
    acc = carry_dtype(xg.dtype)
    Rf = R.to(acc)
    if peephole is not None:
        pf = peephole.to(acc)
        p_i, p_f, p_o = pf[:H], pf[H:2 * H], pf[2 * H:]
    h, c = h0.to(acc), c0.to(acc)
    outs, saved = [], []
    for t in range(xg.shape[0]):
        g = xg[t].to(acc) + h.to(R.dtype).to(acc) @ Rf
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
    (``csrc/fused_lstm_bwd.cu``), step by step. The carries dh_rec and dc are
    f32 (f64 for f64 inputs); dg enters the product dg @ R^T rounded to R's
    type, as in the Pallas ``_lstm_bwd_kernel``. In f32 every cast is a
    no-op."""
    acc = carry_dtype(R.dtype)
    T, B, H = reserve.shape[1:]
    Rt = R.to(acc).t()
    cseq, gi, gf, go, gz = reserve
    dh_rec = reserve.new_zeros((B, H))
    dc = reserve.new_zeros((B, H)) if dcT is None else dcT.to(acc)
    if peephole is not None:
        pf = peephole.to(acc)
        p_i, p_f, p_o = pf[:H], pf[H:2 * H], pf[2 * H:]
    dg = reserve.new_empty((T, B, 4 * H))
    for t in range(T - 1, -1, -1):
        i, f, o, z, c = gi[t], gf[t], go[t], gz[t], cseq[t]
        c_prev = cseq[t - 1] if t > 0 else c0.to(acc)
        dh = dout[t].to(acc) + dh_rec
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
            dh_rec = dg_t.to(R.dtype).to(acc) @ Rt
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
    Returns (outputs [B,T,H], (hT, cT)). Mixed operand types promote as
    jnp's do, operation by operation (``widen``): the projection over x, W
    and b, the recurrence over its gates, R and the carries."""
    xg = project_gates(*widen(x, W, b), forget_gate_bias, reverse)
    out, hT, cT = lstm_recurrence(*widen(xg, R, h0, c0, peephole))
    return finish_layer(out, hT, cT, reverse)


def gru_recurrence(xg, R, h0, save_residuals=False):
    """The sequential part of the GRU over time-major gates xg [T, B, 3H]
    (r, z, n; the input projection and bias already in them).

    Returns (outputs [T, B, H], hT), and with ``save_residuals`` also the
    training reserve [4, T, B, H] float32: the post-activation r, z, n and the
    raw recurrent candidate projection hg_n = (h_{t-1} @ R)_n, in kernel time
    order (what the Pallas ``_gru_kernel`` saves for its backward). This is the
    plain version of the fused-GRU forward kernel (``csrc/fused_gru.cu``).
    Whatever the inputs' type, the sums, the gates and the carry h are f32 (f64
    for f64 inputs); h_{t-1} enters the product rounded to R's type, and the
    results return in the inputs' type (the JAX package's Pallas kernel does
    the same for bf16). In f32 every cast is a no-op."""
    H = R.shape[0]
    acc = carry_dtype(xg.dtype)
    Rf = R.to(acc)
    h = h0.to(acc)
    outs, saved = [], []
    for t in range(xg.shape[0]):
        g = xg[t].to(acc)
        hg = h.to(R.dtype).to(acc) @ Rf
        r = torch.sigmoid(g[:, :H] + hg[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + hg[:, H:2 * H])
        hgn = hg[:, 2 * H:]
        n = torch.tanh(g[:, 2 * H:] + r * hgn)
        h = (1.0 - z) * n + z * h
        outs.append(h)
        if save_residuals:
            saved.append(torch.stack((r, z, n, hgn)))
    if not outs:
        res = (xg.new_empty((0,) + tuple(h0.shape)), h0)
    else:
        res = (torch.stack(outs).to(xg.dtype), h.to(h0.dtype))
    if not save_residuals:
        return res
    return res + (torch.stack(saved, 1) if saved
                  else xg.new_empty((4, 0) + tuple(h0.shape), dtype=acc),)


def gru_bwd_recurrence(reserve, R, h0, out, dout):
    """The reverse-time walk over the GRU forward's reserve [4, T, B, H].

    ``out`` [T, B, H] holds the forward's outputs (h_{t-1} is h0 at the
    first kernel step and out[t-1] after it, in the outputs' type);
    ``dout`` [T, B, H] the gradient of the outputs in kernel time order,
    with the gradient of hT already added at the last step. Returns (dg
    [T, B, 3H] float32, the pre-activation gate gradients [ga_r ga_z ga_n],
    and dh0 [B, H] float32, the final carry). Per reverse step:

        dh = dout[t] + carry
        ga_n = dh * (1 - z) * (1 - n^2)
        ga_z = dh * (h_{t-1} - n) * z * (1 - z)
        ga_r = ga_n * hg_n * r * (1 - r)
        carry = z * dh + [ga_r, ga_z, r * ga_n] @ R^T

    This is the plain version of the fused-GRU backward kernel
    (``csrc/fused_gru_bwd.cu``), step by step. The carry is f32 (f64 for f64
    inputs); [ga_r, ga_z, r * ga_n] enters the product rounded to R's type, as
    in the Pallas ``_gru_bwd_kernel``. In f32 every cast is a no-op."""
    acc = carry_dtype(R.dtype)
    T, B, H = reserve.shape[1:]
    Rt = R.to(acc).t()
    rr, rz, rn, rhgn = reserve
    carry = reserve.new_zeros((B, H))
    dg = reserve.new_empty((T, B, 3 * H))
    for t in range(T - 1, -1, -1):
        r, z, n = rr[t], rz[t], rn[t]
        h_prev = (out[t - 1] if t > 0 else h0.to(out.dtype)).to(acc)
        dh = dout[t].to(acc) + carry
        ga_n = dh * (1.0 - z) * (1.0 - n * n)
        ga_z = dh * (h_prev - n) * z * (1.0 - z)
        ga_r = ga_n * rhgn[t] * r * (1.0 - r)
        dg[t] = torch.cat((ga_r, ga_z, ga_n), 1)
        gh = torch.cat((ga_r, ga_z, r * ga_n), 1)
        carry = z * dh + gh.to(R.dtype).to(acc) @ Rt
    return dg, carry


def finish_h(out, hT, reverse):
    """Kernel time domain [T, B, H] back to the layer's [B, T, H], for the
    layers whose carry is h alone (GRU, SimpleRnn)."""
    if reverse:
        out = out.flip(0)
    return out.transpose(0, 1), hT


@register_op("gru_layer")
def gru_layer(x, h0, W, R, b, *, reverse=False):
    """Full-sequence GRU. x [B,T,F], W [F,3H], R [H,3H], b [3H]; gate order
    r, z, n. Returns (outputs [B,T,H], hT). Mixed operand types promote as
    jnp's do, operation by operation (``widen``): the projection over x, W
    and b, the recurrence over its gates, R and h0."""
    xg = project_gates(*widen(x, W, b), reverse=reverse)
    out, hT = gru_recurrence(*widen(xg, R, h0))
    return finish_h(out, hT, reverse)


@register_op("simple_rnn_layer")
def simple_rnn_layer(x, h0, W, R, b, *, activation=torch.tanh, reverse=False):
    """Elman RNN: h_t = act(x_t @ W + h_{t-1} @ R + b). Returns (outputs
    [B,T,H], hT). No kernel: the JAX package has none either. Mixed
    operand types promote operation by operation, as jnp's do."""
    xg = project_gates(*widen(x, W, b), reverse=reverse)
    xg, h0, R = widen(xg, h0, R)
    h, outs = h0, []
    for t in range(xg.shape[0]):
        h = activation(xg[t] + h @ R)
        outs.append(h)
    out = torch.stack(outs) if outs else xg.new_empty((0,) + tuple(h0.shape))
    return finish_h(out, h, reverse)
