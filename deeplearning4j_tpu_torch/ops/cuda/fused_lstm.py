"""Fused LSTM forward: the hand-written CUDA kernel behind ``lstm_layer``.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_lstm.py``. The kernel,
``csrc/fused_lstm.cu``, replaces ``_lstm_kernel`` (launched by
``_fused_recurrence`` through ``pl.pallas_call``): the time-major
recurrence over pre-projected gates, IFOG, with GravesLSTM peepholes. The
input projection, forget-gate bias and reverse flip stay outside it, as in
the JAX package's ``_project_gates``; the projection is one large
``torch.matmul``.

What bounds it on the H100, and what the design does about it, is written
at the top of the CUDA source: each step reads R [H, 4H] to do 2*B*H*4H
flops, so at serving batch sizes it is memory-bound, and at decode (T=1) the
launch latency dominates. None of the TPU machinery is carried over
(``lstm_tile``, ``lstm_plan``, ``_pad_to_lanes``, ``_panel_dtype``): the
kernel takes any H, including the 200 of the GravesLSTM char-RNN.

The kernel takes float32 or bfloat16 (all tensors of one type). In bf16 it
does what the Pallas kernel does: sums, gates and the cell state in f32,
h_{t-1} rounded to bf16 for the product, outputs rounded to bf16; the plain
version computes the same way.

:func:`fused_lstm_recurrence` is the kernel's wrapper. It takes the plain
version (``ops/recurrent.lstm_recurrence``) only for CPU tensors; for CUDA
tensors it launches the kernel or raises. The registry sends every
all-CUDA ``lstm_layer`` call here, whatever its dtype, so a type the kernel
has no code for raises instead of running the plain version on the card.
``FUSED_LSTM.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops.cuda.build import (
    CudaLibrary, c_args, check_status, pointer,
)
from deeplearning4j_tpu_torch.ops.recurrent import (
    finish_layer, lstm_recurrence, project_gates,
)
from deeplearning4j_tpu_torch.ops.registry import register_impl

#: the plain version the kernel is held against
plain_recurrence = lstm_recurrence


class FusedLSTMKernel:
    """The built library plus the launch count of ``dl4j_lstm_fwd``."""

    name = "fused_lstm_fwd"
    source = "deeplearning4j_tpu_torch/csrc/fused_lstm.cu"
    replaces = "deeplearning4j_tpu/ops/pallas/fused_lstm.py:83 (_lstm_kernel)"

    def __init__(self):
        self.library = CudaLibrary("fused_lstm.cu", {
            "dl4j_lstm_fwd": (c_args("ppppppppiiip"), ctypes.c_int),
            "dl4j_lstm_fwd_bf16": (c_args("ppppppppiiip"), ctypes.c_int),
            "dl4j_cuda_error_string": (c_args("i"), ctypes.c_char_p),
        })
        self.launches = 0


FUSED_LSTM = FusedLSTMKernel()

#: the C launcher for each element type the kernel takes
_SYMBOLS = {torch.float32: "dl4j_lstm_fwd",
            torch.bfloat16: "dl4j_lstm_fwd_bf16"}


def _check_inputs(xg, R, h0, c0, peephole):
    tensors = {"xg": xg, "R": R, "h0": h0, "c0": c0}
    if peephole is not None:
        tensors["peephole"] = peephole
    if xg.dtype not in _SYMBOLS:
        raise TypeError(f"fused_lstm: xg is {xg.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name, t in tensors.items():
        if t.device != xg.device:
            raise ValueError(f"fused_lstm: {name} is on {t.device}, "
                             f"xg on {xg.device}")
        if t.dtype != xg.dtype:
            raise TypeError(f"fused_lstm: {name} is {t.dtype}, xg "
                            f"{xg.dtype}; the kernel takes one type")
        if not t.is_contiguous():
            raise ValueError(f"fused_lstm: {name} is not contiguous")
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError(f"fused_lstm: xg must be [T, B, 4H], got "
                         f"{tuple(xg.shape)}")
    T, B, G = xg.shape
    H = G // 4
    if tuple(R.shape) != (H, G):
        raise ValueError(f"fused_lstm: R must be [{H}, {G}], got "
                         f"{tuple(R.shape)}")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (B, H):
            raise ValueError(f"fused_lstm: {name} must be [{B}, {H}], got "
                             f"{tuple(t.shape)}")
    if peephole is not None and tuple(peephole.shape) != (3 * H,):
        raise ValueError(f"fused_lstm: peephole must be [{3 * H}], got "
                         f"{tuple(peephole.shape)}")
    return T, B, H


def fused_lstm_recurrence(xg, R, h0, c0, peephole=None):
    """xg [T, B, 4H] time-major gates -> (outputs [T, B, H], hT, cT).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if xg.device.type == "cpu":
        return plain_recurrence(xg, R, h0, c0, peephole)
    if xg.device.type != "cuda":
        raise ValueError(f"fused_lstm: unsupported device {xg.device}")
    T, B, H = _check_inputs(xg, R, h0, c0, peephole)
    if T == 0:
        return xg.new_empty((0, B, H)), h0, c0
    lib = FUSED_LSTM.library.load(xg.device)
    launch = getattr(lib, _SYMBOLS[xg.dtype])
    out = xg.new_empty((T, B, H))
    hT = xg.new_empty((B, H))
    cT = xg.new_empty((B, H))
    args = (pointer(xg), pointer(R), pointer(h0), pointer(c0),
            pointer(peephole), pointer(out), pointer(hT), pointer(cT), T, B, H)
    if xg.device.index == torch.cuda.current_device():
        status = launch(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the C launcher uses the calling thread's current device
        with torch.cuda.device(xg.device):
            status = launch(*args, torch.cuda.current_stream().cuda_stream)
    check_status(lib, status, _SYMBOLS[xg.dtype])
    FUSED_LSTM.launches += 1
    return out, hT, cT


def fused_lstm_layer(x, h0, c0, W, R, b, *, peephole=None,
                     forget_gate_bias=0.0, reverse=False):
    """Kernel implementation of the ``lstm_layer`` op (same signature)."""
    xg = project_gates(x, W, b, forget_gate_bias, reverse)
    out, hT, cT = fused_lstm_recurrence(
        xg, R.contiguous(), h0.contiguous(), c0.contiguous(),
        None if peephole is None else peephole.contiguous())
    return finish_layer(out, hT, cT, reverse)


def _lstm_requires(x, h0, c0, W, R, b, *, peephole=None, **kw):
    """Structural: every tensor on the card. The dtype is the wrapper's
    to check: it launches the kernel or raises."""
    ts = [x, h0, c0, W, R, b] + ([] if peephole is None else [peephole])
    return all(t.is_cuda for t in ts)


register_impl("lstm_layer", platform="cuda", requires=_lstm_requires,
              priority=1)(fused_lstm_layer)
