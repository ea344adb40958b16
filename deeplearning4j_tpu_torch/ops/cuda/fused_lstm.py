"""Fused LSTM: the hand-written CUDA kernels behind ``lstm_layer``.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_lstm.py``. Two kernels:

- ``csrc/fused_lstm.cu`` replaces ``_lstm_kernel`` (launched by
  ``_fused_recurrence``): the time-major recurrence over pre-projected
  gates, IFOG, with GravesLSTM peepholes; when training it also saves the
  reserve (c_t and the post-activation gates, [5, T, B, H] f32).
- ``csrc/fused_lstm_bwd.cu`` replaces ``_lstm_bwd_kernel`` (launched by
  ``_bwd_recurrence``): the reverse-time walk over that reserve, giving the
  pre-activation gate gradients dg [T, B, 4H] f32 and dc0.

The input projection, forget-gate bias and reverse flip stay outside the
forward, as in the JAX package's ``_project_gates``; everything of the
backward that is not sequential (dx, dh0, dW, dR, db, the peephole sums)
is formed outside the backward kernel by ``torch.matmul``, as
``_fused_bwd`` forms it. :class:`FusedLSTMFunction` ties the two together
for autograd, the counterpart of the ``jax.custom_vjp`` ``_fused``.

What bounds the kernels on the H100, and what their design does about it,
is written at the top of each CUDA source. None of the TPU machinery of
the JAX package is carried over (``lstm_tile``, ``lstm_plan``,
``lstm_bwd_tile``, its ``_bwd_plan``, ``_pad_to_lanes``, ``_panel_dtype``):
the kernels take any H, including the 200 of the GravesLSTM char-RNN.

The kernels take float32 or bfloat16 (all tensors of one type, the reserve
and the gate gradients f32). In bf16 they do what the Pallas kernels do:
sums, gates, cell state and the backward's carries in f32, h_{t-1} and dg
rounded to bf16 for their products; the plain versions compute the same
way. A call that mixes f32 and bf16 (an f32 carry beside bf16 weights, as
``rnn_time_step`` passes) computes in f32, as jnp's promotion does: the
wrappers widen the narrower operands before launching (``widen``; widening
is exact).

Each kernel has three designs (``csrc/fused_lstm.cu``,
``fused_lstm_bwd.cu``): at T > 1, where a thread-block cluster can hold R
in shared memory (f32 to H = 436 forward and 440 backward, bf16 to 512),
the cluster kernel, on the cluster layer of ``csrc/recurrent_cluster.cuh``;
at T > 1 past that width, where the whole card holds R, the grid kernel,
on the grid layer of ``csrc/recurrent_grid.cuh`` at its LSTM slot count
(R split across row groups of CTAs, 128 a group in f32 at H = 1024, one
barrier a step over a group, h or the partial carries through L2, the
bf16 step products on the tensor cores; the wrapper allocates the
workspace the launcher's plan asks for); at T == 1 (decode) and for any R
the card cannot hold, the stream kernel, which reads R (the backward:
R^T, formed by the wrapper for that design alone) from L2 every step. The
C launchers choose; :func:`fwd_design` and :func:`bwd_design` repeat their
choices, and ``FWD_KERNEL_NAMES`` and ``BWD_KERNEL_NAMES`` name each
design's device function.

A stream block keeps all of h in shared memory, under the launchers' cap,
so H has a limit: :func:`kernel_admits` repeats the launchers' arithmetic
(the cluster and grid designs take only shapes the stream design also
takes).
The registry sends an all-CUDA ``lstm_layer`` call here when
:func:`kernel_admits` takes it (f32 or bf16, H under the limit of the
kernels the call will run); any other call takes the plain lowering, as
the JAX package sends it to XLA. A call sent here launches the kernel or
raises. The wrappers take the plain versions (``ops/recurrent.py``) only
for CPU tensors. ``FUSED_LSTM.launches`` and ``FUSED_LSTM_BWD.launches``
count launches; ``FUSED_LSTM.reserves`` counts the forward launches that
saved the reserve.
"""

from __future__ import annotations

import functools

import torch

from deeplearning4j_tpu_torch.common.dtypes import widen
from deeplearning4j_tpu_torch.ops.cuda import recurrent_cluster as rc
from deeplearning4j_tpu_torch.ops.cuda import recurrent_grid as rg
from deeplearning4j_tpu_torch.ops.cuda.build import CudaKernel, launch, pointer
from deeplearning4j_tpu_torch.ops.cuda.recurrent_cluster import (
    Design, plan_cluster, rows_max,
)
from deeplearning4j_tpu_torch.ops.recurrent import (
    finish_layer, lstm_bwd_recurrence, lstm_recurrence, project_gates,
)
from deeplearning4j_tpu_torch.ops.registry import register_impl

#: the plain versions the kernels are held against
plain_recurrence = lstm_recurrence
plain_bwd_recurrence = lstm_bwd_recurrence


class RecurrentKernel(CudaKernel):
    """A fused recurrent (LSTM or GRU) kernel; ``reserves`` counts the
    forward launches that saved the training reserve."""

    def __init__(self, *args):
        super().__init__(*args)
        self.reserves = 0


#: the C launcher for each element type the kernels take
_FWD_SYMBOLS = {torch.float32: "dl4j_lstm_fwd",
                torch.bfloat16: "dl4j_lstm_fwd_bf16"}
_BWD_SYMBOLS = {torch.float32: "dl4j_lstm_bwd",
                torch.bfloat16: "dl4j_lstm_bwd_bf16"}

#: the device function of each design, for profiles
FWD_KERNEL_NAMES = {"cluster": "lstm_fwd_cluster_kernel",
                    "grid": "lstm_fwd_grid_kernel",
                    "stream": "lstm_fwd_kernel"}
BWD_KERNEL_NAMES = {"cluster": "lstm_bwd_cluster_kernel",
                    "grid": "lstm_bwd_grid_kernel",
                    "stream": "lstm_bwd_kernel"}

FUSED_LSTM = RecurrentKernel(
    "fused_lstm_fwd", "fused_lstm.cu",
    "deeplearning4j_tpu/ops/pallas/fused_lstm.py:83 (_lstm_kernel)",
    {**{sym: "ppppppppppliiip" for sym in _FWD_SYMBOLS.values()},
     "dl4j_lstm_fwd_plan": "iiiip", "dl4j_lstm_active_clusters": "iiiip",
     "dl4j_lstm_grid_resident": "iiip"})
FUSED_LSTM_BWD = RecurrentKernel(
    "fused_lstm_bwd", "fused_lstm_bwd.cu",
    "deeplearning4j_tpu/ops/pallas/fused_lstm.py:386 (_lstm_bwd_kernel)",
    {**{sym: "ppppppppppliiip" for sym in _BWD_SYMBOLS.values()},
     "dl4j_lstm_bwd_plan": "iiiip", "dl4j_lstm_bwd_active_clusters": "iiiip",
     "dl4j_lstm_bwd_grid_resident": "iiip"})


def _check_tensors(what, dtype, device, tensors):
    if dtype not in _FWD_SYMBOLS:
        raise TypeError(f"{what}: the tensors are {dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name, (t, want) in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != (want or dtype):
            raise TypeError(f"{what}: {name} is {t.dtype}, not "
                            f"{want or dtype}; the kernel takes one type")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check_shapes(what, tensors):
    for name, (t, shape) in tensors.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")


def fused_lstm_recurrence(xg, R, h0, c0, peephole=None, save_residuals=False):
    """xg [T, B, 4H] time-major gates -> (outputs [T, B, H], hT, cT), and
    with ``save_residuals`` the reserve [5, T, B, H] f32 too.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Mixed f32/bf16 operands compute in f32."""
    xg, R, h0, c0, peephole = widen(xg, R, h0, c0, peephole)
    if xg.device.type == "cpu":
        return plain_recurrence(xg, R, h0, c0, peephole, save_residuals)
    if xg.device.type != "cuda":
        raise ValueError(f"fused_lstm: unsupported device {xg.device}")
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError(f"fused_lstm: xg must be [T, B, 4H], got "
                         f"{list(xg.shape)}")
    T, B, G = xg.shape
    H = G // 4
    _check_tensors("fused_lstm", xg.dtype, xg.device, {
        "xg": (xg, None), "R": (R, None), "h0": (h0, None), "c0": (c0, None),
        "peephole": (peephole, None)})
    _check_shapes("fused_lstm", {"R": (R, (H, G)), "h0": (h0, (B, H)),
                                 "c0": (c0, (B, H)),
                                 "peephole": (peephole, (3 * H,))})
    reserve = (xg.new_empty((5, T, B, H), dtype=torch.float32)
               if save_residuals else None)
    if T == 0:
        res = (xg.new_empty((0, B, H)), h0, c0)
        return res + (reserve,) if save_residuals else res
    out = xg.new_empty((T, B, H))
    hT = xg.new_empty((B, H))
    cT = xg.new_empty((B, H))
    # decode (T == 1) always takes the stream design, which needs no
    # workspace: only longer calls ask the launcher's plan
    work = (rg.workspace(_fwd_plan(T, B, H, xg.dtype, xg.device)[1], xg)
            if T > 1 else None)
    launch(FUSED_LSTM, _FWD_SYMBOLS[xg.dtype], xg.device, (
        pointer(xg), pointer(R), pointer(h0), pointer(c0), pointer(peephole),
        pointer(out), pointer(hT), pointer(cT), pointer(reserve),
        pointer(work), rg.nbytes(work), T, B, H))
    if save_residuals:
        FUSED_LSTM.reserves += 1
    return (out, hT, cT, reserve) if save_residuals else (out, hT, cT)


def fused_lstm_bwd_recurrence(reserve, R, c0, dout, dcT=None, peephole=None):
    """The reverse-time walk: (dg [T, B, 4H] f32, dc0 [B, H] f32) from the
    forward's reserve, ``dout`` [T, B, H] (kernel time order, the gradient
    of hT joined at the last step) and ``dcT`` (or None).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Mixed f32/bf16 operands (the reserve aside) compute in f32."""
    R, c0, dout, dcT, peephole = widen(R, c0, dout, dcT, peephole)
    if reserve.device.type == "cpu":
        return plain_bwd_recurrence(reserve, R, c0, dout, dcT, peephole)
    if reserve.device.type != "cuda":
        raise ValueError(f"fused_lstm_bwd: unsupported device {reserve.device}")
    if reserve.dim() != 4 or reserve.shape[0] != 5:
        raise ValueError(f"fused_lstm_bwd: reserve must be [5, T, B, H], "
                         f"got {list(reserve.shape)}")
    T, B, H = reserve.shape[1:]
    dt, dev = R.dtype, reserve.device
    _check_tensors("fused_lstm_bwd", dt, dev, {
        "reserve": (reserve, torch.float32), "R": (R, None),
        "c0": (c0, None), "dout": (dout, None), "dcT": (dcT, None),
        "peephole": (peephole, None)})
    _check_shapes("fused_lstm_bwd", {
        "R": (R, (H, 4 * H)), "c0": (c0, (B, H)), "dout": (dout, (T, B, H)),
        "dcT": (dcT, (B, H)), "peephole": (peephole, (3 * H,))})
    # the stream design reads R^T; the cluster and grid designs read R
    # itself, the grid design with its workspace
    design, nbytes = _bwd_plan(T, B, H, dt, dev)
    Rt = R.t().contiguous() if design.kind == "stream" else None
    work = rg.workspace(nbytes, reserve)
    dg = reserve.new_empty((T, B, 4 * H))
    dc0 = reserve.new_empty((B, H))
    launch(FUSED_LSTM_BWD, _BWD_SYMBOLS[dt], dev, (
        pointer(reserve), pointer(R), pointer(Rt), pointer(c0),
        pointer(dout), pointer(dcT), pointer(peephole), pointer(dg),
        pointer(dc0), pointer(work), rg.nbytes(work), T, B, H))
    return dg, dc0


def _contiguous(t):
    return None if t is None else t.contiguous()


class FusedLSTMFunction(torch.autograd.Function):
    """``lstm_layer`` through the two kernels, differentiable.

    The counterpart of the JAX package's ``_fused`` / ``_fused_fwd`` /
    ``_fused_bwd``. The forward launches the forward kernel with the
    reserve; the backward launches the backward kernel, then forms dx, dh0,
    dW, dR, db and the peephole sums as plain products, each cast to its
    input's dtype. CPU tensors take both kernels' plain versions, so the
    CPU tests run the same assembly code as the card."""

    @staticmethod
    def forward(ctx, x, h0, c0, W, R, b, peephole, forget_gate_bias,
                reverse):
        xg = project_gates(x, W, b, forget_gate_bias, reverse)
        out, hT, cT, reserve = fused_lstm_recurrence(
            xg, R, h0, c0, peephole, save_residuals=True)
        # the reserve, outputs and dg stay in kernel time order (flipped
        # when reverse), the domain the backward kernel walks
        ctx.save_for_backward(x, h0, c0, W, R, peephole, out, reserve)
        ctx.reverse = reverse
        ctx.b_dtype = b.dtype
        ys, (hT, cT) = finish_layer(out, hT, cT, reverse)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, g_out, g_hT, g_cT):
        x, h0, c0, W, R, peephole, out, reserve = ctx.saved_tensors
        need = ctx.needs_input_grad
        f32 = torch.float32
        T, B, H = out.shape
        G = 4 * H
        if g_out is None:
            dout = torch.zeros_like(out)
        else:  # a fresh buffer in kernel time order: g_out stays as it is
            dout = torch.empty_like(out)
            g = g_out.transpose(0, 1)
            dout.copy_(g.flip(0) if ctx.reverse else g)
        if g_hT is not None:  # hT aliases the last kernel step's output
            dout[T - 1] += g_hT.to(out.dtype)
        dg, dc0 = fused_lstm_bwd_recurrence(
            reserve, R, c0, dout, _contiguous(g_cT), peephole)

        # everything that is not sequential: plain products in f32, each
        # cast to its input's dtype
        dx = dh0 = dW = dR = db = dp = None
        dg_nat = dg.flip(0) if ctx.reverse else dg     # natural time order
        if need[0]:
            dx = (dg_nat.reshape(T * B, G) @ W.to(f32).t()).reshape(T, B, -1)
            dx = dx.transpose(0, 1).to(x.dtype)
        if need[1]:
            dh0 = (dg[0] @ R.to(f32).t()).to(h0.dtype)
        if need[3]:
            xt = x.transpose(0, 1).reshape(T * B, -1).to(f32)
            dW = (xt.t() @ dg_nat.reshape(T * B, G)).to(W.dtype)
        if need[4]:  # h_prev is h0 at the first kernel step, out after it
            dR = h0.to(f32).t() @ dg[0]
            if T > 1:
                dR += out[:-1].reshape(-1, H).to(f32).t() @ dg[1:].reshape(-1, G)
            dR = dR.to(R.dtype)
        if need[5]:
            db = dg.reshape(T * B, G).sum(0).to(ctx.b_dtype)
        if peephole is not None and need[6]:
            cseq, c0f = reserve[0], c0.to(f32)
            dgi, dgf, dgo = dg[..., :H], dg[..., H:2 * H], dg[..., 2 * H:3 * H]
            dp_i = (dgi[0] * c0f).sum(0) + (dgi[1:] * cseq[:-1]).sum((0, 1))
            dp_f = (dgf[0] * c0f).sum(0) + (dgf[1:] * cseq[:-1]).sum((0, 1))
            dp_o = (dgo * cseq).sum((0, 1))
            dp = torch.cat((dp_i, dp_f, dp_o)).to(peephole.dtype)
        # a carry that needs no gradient (a tBPTT chunk's detached h0, c0)
        # gets None, as autograd expects
        return (dx, dh0, dc0.to(c0.dtype) if need[2] else None, dW, dR, db,
                dp, None, None)


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_lstm_layer(x, h0, c0, W, R, b, *, peephole=None,
                     forget_gate_bias=0.0, reverse=False):
    """Kernel implementation of the ``lstm_layer`` op (same signature).

    When autograd will need the layer's gradients (grad mode on and some
    input requires grad), the call goes through :class:`FusedLSTMFunction`,
    whose forward saves the reserve for the backward kernel: the
    counterpart of ``_kernel_bwd_enabled``. Otherwise (serving, under
    ``torch.no_grad``) the forward kernel runs alone and saves nothing. The
    choice is made on every call. Mixed operand types promote as jnp's
    do, operation by operation: the projection over x, W and b, the
    recurrence over its gates, R and the carries."""
    x, W, b = widen(x, W, b)
    R, h0, c0, peephole = (R.contiguous(), h0.contiguous(), c0.contiguous(),
                           _contiguous(peephole))
    if x.shape[1] and _needs_grad((x, h0, c0, W, R, b, peephole)):
        ys, hT, cT = FusedLSTMFunction.apply(
            x, h0, c0, W, R, b, peephole, float(forget_gate_bias),
            bool(reverse))
        return ys, (hT, cT)
    xg = project_gates(x, W, b, forget_gate_bias, reverse)
    out, hT, cT = fused_lstm_recurrence(xg, R, h0, c0, peephole)
    return finish_layer(out, hT, cT, reverse)


# ------------------------------------------------- what the kernels take

#: csrc/fused_lstm.cu and csrc/fused_lstm_bwd.cu (kTile, kSmemCap): hidden
#: units per work item of a stream block, and the shared memory it may use
SMEM_TILE = 32
SMEM_CAP = 200 * 1024
#: csrc/fused_lstm.cu (kDecodeUnits, kMaxSlices, kWarps): units a stream
#: block at T == 1, k-slices a unit tile at most, warps of a stream block
DECODE_UNITS = 8
MAX_SLICES = 16
STREAM_WARPS = 16


def stream_slices(tiles: int, reduce: int, smem) -> int:
    """A stream block's k-slices (the recurrent launchers' ``slices``):
    doubled while its warps would idle on ``tiles`` unit tiles, each slice
    at least 16 long (``reduce`` the reduction's length) and
    ``smem(slices)`` under the cap."""
    slices = 1
    while (slices < MAX_SLICES and tiles * slices < STREAM_WARPS
           and reduce >= 32 * slices and smem(2 * slices) <= SMEM_CAP):
        slices *= 2
    return slices


def stream_smem_bytes(rb: int, H: int, upb: int, slices: int = 1) -> int:
    """A forward stream block's shared memory (csrc/fused_lstm.cu
    ``smem_bytes``): h [RB][H], c [RB][upb] and the k-slices' partial
    sums."""
    tiles = -(-upb // SMEM_TILE)
    return 4 * (rb * H + rb * upb + slices * tiles * 4 * rb * SMEM_TILE)


def fwd_smem_bytes(T: int, H: int) -> int:
    """The forward stream launcher's least shared memory for a [T, *, H]
    call: one batch row a block and one k-slice, and upb as the launcher
    sets it (all of H when T > 1, DECODE_UNITS units when T == 1). The
    launcher refuses the call when this exceeds the cap (``plan_fwd``)."""
    return stream_smem_bytes(1, H, min(H, DECODE_UNITS) if T == 1 else H)


def bwd_stream_smem_bytes(rb: int, H: int, slices: int = 1) -> int:
    """A backward stream block's shared memory (csrc/fused_lstm_bwd.cu
    ``smem_bytes``): this step's dg [RB][4H], the dc carry [RB][H] and the
    slices' partial sums."""
    return 4 * (rb * 4 * H + rb * H + slices * -(-H // SMEM_TILE) * rb
                * SMEM_TILE)


def bwd_smem_bytes(H: int) -> int:
    """The backward stream launcher's least shared memory, one row a block
    and one slice; the launcher refuses the call above the cap
    (``plan_bwd``)."""
    return bwd_stream_smem_bytes(1, H)


def cluster_smem_bytes(rb: int, H: int, e: int) -> int:
    """A cluster CTA's shared memory for RB rows and elements of ``e``
    bytes: ``fwd_cluster_smem_bytes`` with four gates."""
    return rc.fwd_cluster_smem_bytes(rb, H, 4, e)


def grid_smem_bytes(H: int) -> int:
    """A forward grid CTA's shared memory (csrc/fused_lstm.cu
    ``lstm_fwd_grid_smem_bytes``): ``fwd_grid_smem_bytes`` with four
    gates at the LSTM's slots, stages for its most rows."""
    return rg.fwd_grid_smem_bytes(H, 4, rg.LSTM_GRID_SLOTS,
                                  max(rg.LSTM_GRID_ROWS))


def bwd_grid_smem_bytes(rb: int, H: int, e: int) -> int:
    """A backward grid CTA's shared memory for RB rows and elements of
    ``e`` bytes: ``bwd_grid_smem_bytes`` with four gates at the LSTM's
    slots."""
    return rg.bwd_grid_smem_bytes(rb, H, 4, e, rg.LSTM_GRID_SLOTS)


def fwd_design(T: int, B: int, H: int, dtype: torch.dtype,
               active_clusters=None, co_resident=None) -> Design:
    """The forward launcher's choice for a [T, B, *, H] call
    (csrc/fused_lstm.cu ``plan_fwd``). ``active_clusters(C, rows, smem)``
    is the card's ``cudaOccupancyMaxActiveClusters`` for clusters of C CTAs
    of the cluster kernel for ``rows`` rows with ``smem`` bytes each;
    ``co_resident(rows, smem)`` the CTAs of the grid kernel for ``rows``
    rows the card holds at once; None asks the card
    (:func:`card_active_clusters`, :func:`card_co_resident`).

    T > 1 takes the cluster design where ``plan_cluster`` finds one (in
    f32 a cluster of 16 holds R [H, 4H] up to H = 436, in bf16 up to 512),
    else the grid design where ``plan_grid`` finds one at the LSTM's slots
    and rows (a CTA holds its R to H = 1472; on the H100 an f32 row group
    of 8-unit CTAs fits to H = 1056). Everything else takes the stream
    design: rows
    halved while over the cap, then more k-slices while warps would idle,
    each at least 16 long (decode: DECODE_UNITS units a block)."""
    e = 2 if dtype == torch.bfloat16 else 4
    if T > 1:
        d = plan_cluster(B, H, lambda rb, C: cluster_smem_bytes(rb, H, e),
                         active_clusters or card_active_clusters(dtype))
        if d is not None:
            return d
        d = rg.plan_grid(B, H, e, lambda rb: grid_smem_bytes(H),
                         co_resident or card_co_resident(dtype),
                         rg.LSTM_GRID_SLOTS, rg.LSTM_GRID_ROWS)
        if d is not None:
            return d
    upb = min(H, DECODE_UNITS) if T == 1 else H
    tiles = -(-upb // SMEM_TILE)
    rb = rows_max(B)
    while rb > 1 and stream_smem_bytes(rb, H, upb) > SMEM_CAP:
        rb //= 2
    slices = stream_slices(tiles, H,
                           lambda s: stream_smem_bytes(rb, H, upb, s))
    return Design("stream", None, rb, stream_smem_bytes(rb, H, upb, slices))


def bwd_cluster_smem_bytes(rb: int, H: int, C: int, e: int) -> int:
    """A backward cluster CTA's shared memory for RB rows, a cluster of C
    and elements of ``e`` bytes: ``bwd_cluster_smem_bytes`` with four
    gates."""
    return rc.bwd_cluster_smem_bytes(rb, H, C, 4, e)


def bwd_design(T: int, B: int, H: int, dtype: torch.dtype,
               active_clusters=None, co_resident=None) -> Design:
    """The backward launcher's choice for a [T, B, *, H] call
    (csrc/fused_lstm_bwd.cu ``plan_bwd``), as :func:`fwd_design` for the
    forward: the cluster design at T > 1 where ``plan_cluster`` finds one
    (a CTA's shared memory grows with the cluster, by its receive slots;
    in f32 a cluster of 16 holds R [H, 4H] up to H = 440, in bf16 up to
    512); else the grid design where ``plan_grid`` finds one at the
    LSTM's slots and the GRU's rows, up to 32 a group (a CTA's shared
    memory grows with its rows, by the product operands; a CTA
    holds its R to H = 1744 in f32, 1584 in bf16, and on the H100 an f32
    row group fits to H = 1056); else the stream design, rows halved while
    over the cap, then more slices of the 4H reduction while warps would
    idle, each at least 16 long. ``active_clusters`` and ``co_resident``
    None ask the card (:func:`card_bwd_active_clusters`,
    :func:`card_bwd_co_resident`)."""
    e = 2 if dtype == torch.bfloat16 else 4
    if T > 1:
        d = plan_cluster(B, H,
                         lambda rb, C: bwd_cluster_smem_bytes(rb, H, C, e),
                         active_clusters or card_bwd_active_clusters(dtype))
        if d is not None:
            return d
        d = rg.plan_grid(B, H, e, lambda rb: bwd_grid_smem_bytes(rb, H, e),
                         co_resident or card_bwd_co_resident(dtype),
                         rg.LSTM_GRID_SLOTS)
        if d is not None:
            return d
    rb = rows_max(B)
    while rb > 1 and bwd_stream_smem_bytes(rb, H) > SMEM_CAP:
        rb //= 2
    slices = stream_slices(-(-H // SMEM_TILE), 4 * H,
                           lambda s: bwd_stream_smem_bytes(rb, H, s))
    return Design("stream", None, rb, bwd_stream_smem_bytes(rb, H, slices))


def card_active_clusters(dtype: torch.dtype, device=None):
    """``active_clusters`` for :func:`fwd_design` from the card."""
    return rc.card_active_clusters(FUSED_LSTM, "dl4j_lstm_active_clusters",
                                   dtype, device)


def card_bwd_active_clusters(dtype: torch.dtype, device=None):
    """``active_clusters`` for :func:`bwd_design` from the card."""
    return rc.card_active_clusters(FUSED_LSTM_BWD,
                                   "dl4j_lstm_bwd_active_clusters", dtype,
                                   device)


def card_co_resident(dtype: torch.dtype, device=None):
    """``co_resident`` for :func:`fwd_design` from the card."""
    return rg.card_co_resident(FUSED_LSTM, "dl4j_lstm_grid_resident", dtype,
                               device)


def card_bwd_co_resident(dtype: torch.dtype, device=None):
    """``co_resident`` for :func:`bwd_design` from the card."""
    return rg.card_co_resident(FUSED_LSTM_BWD, "dl4j_lstm_bwd_grid_resident",
                               dtype, device)


def launcher_design(T: int, B: int, H: int, dtype: torch.dtype,
                    device=None) -> Design:
    """The forward C launcher's own choice (``dl4j_lstm_fwd_plan``)."""
    return rg.launcher_plan(FUSED_LSTM, "dl4j_lstm_fwd_plan", T, B, H, dtype,
                            device)[0]


def launcher_bwd_design(T: int, B: int, H: int, dtype: torch.dtype,
                        device=None) -> Design:
    """The backward C launcher's own choice (``dl4j_lstm_bwd_plan``)."""
    return rg.launcher_plan(FUSED_LSTM_BWD, "dl4j_lstm_bwd_plan", T, B, H,
                            dtype, device)[0]


#: the launchers' plans by call, asked once: the wrappers allocate the
#: workspace a plan asks for, and form R^T only for the backward's stream
#: design
_fwd_plan = functools.lru_cache(maxsize=256)(
    functools.partial(rg.launcher_plan, FUSED_LSTM, "dl4j_lstm_fwd_plan"))
_bwd_plan = functools.lru_cache(maxsize=256)(
    functools.partial(rg.launcher_plan, FUSED_LSTM_BWD, "dl4j_lstm_bwd_plan"))


def kernel_admits(T: int, H: int, dtype: torch.dtype,
                  backward: bool) -> bool:
    """Can the kernels compute a call of this length, width and (promoted)
    type: f32 or bf16, and the shared memory of the forward, and of the
    backward when autograd will run it, under the cap. The cluster and
    grid designs widen nothing: they take only shapes that the stream
    launchers take too."""
    return (dtype in _FWD_SYMBOLS and fwd_smem_bytes(T, H) <= SMEM_CAP
            and (not backward or bwd_smem_bytes(H) <= SMEM_CAP))


def _promoted(tensors) -> torch.dtype:
    """The type the recurrence of a call with these operands runs in."""
    return widen(*tensors)[0].dtype


def _lstm_requires(x, h0, c0, W, R, b, *, peephole=None, **kw):
    """Every tensor on the card, and :func:`kernel_admits` for the call's
    promoted type, T, H and whether autograd will run the backward."""
    ts = [x, h0, c0, W, R, b] + ([] if peephole is None else [peephole])
    return all(t.is_cuda for t in ts) and kernel_admits(
        x.shape[1], R.shape[0], _promoted(ts),
        bool(x.shape[1]) and _needs_grad(ts))


register_impl("lstm_layer", platform="cuda", requires=_lstm_requires,
              priority=1)(fused_lstm_layer)
