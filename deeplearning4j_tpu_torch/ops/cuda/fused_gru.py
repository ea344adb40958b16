"""Fused GRU: the hand-written CUDA kernels behind ``gru_layer``.

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_gru.py``. Two kernels:

- ``csrc/fused_gru.cu`` replaces ``_gru_kernel`` (launched by
  ``_fused_gru_recurrence``): the time-major recurrence over pre-projected
  gates, r, z, n, linear before reset, with the recurrent projection kept
  apart from the input one; when training it also saves the reserve (the
  post-activation r, z, n and the raw hg_n, [4, T, B, H] f32).
- ``csrc/fused_gru_bwd.cu`` replaces ``_gru_bwd_kernel`` (launched by
  ``_bwd_recurrence``): the reverse-time walk over that reserve, giving the
  pre-activation gate gradients dg [T, B, 3H] f32 (ga_r, ga_z, ga_n) and
  dh0, the walk's final carry.

The input projection and the reverse flip stay outside the forward, as in
the JAX package's ``_project_gates``; everything of the backward that is
not sequential (dx, dW, dR, db) is formed outside the backward kernel by
``torch.matmul``, as ``_fused_bwd`` forms it. dR takes (ga_r, ga_z,
r * ga_n) against h_{t-1}; dW, db and dx take (ga_r, ga_z, ga_n).
:class:`FusedGRUFunction` ties the two kernels together for autograd, the
counterpart of the ``jax.custom_vjp`` ``_fused``.

What bounds the kernels on the H100, and what their design does about it,
is written at the top of each CUDA source. None of the TPU machinery is
carried over (``gru_tile``, ``gru_plan``, ``gru_bwd_plan``, the VMEM
budgets, ``_pad_to_lanes``, ``_panel_dtype``, the ``B % 8`` predicate of
``_gru_applicable``): the kernels take any B and any H, 200 included.

The kernels take float32 or bfloat16 (all tensors of one type, the reserve
and the gate gradients f32). In bf16 they do what the Pallas kernels do:
sums, gates and carries in f32, h_{t-1} and the backward's product
operands rounded to bf16 for their products; the plain versions compute
the same way.

A call that mixes f32 and bf16 computes in f32, as jnp's promotion does:
the wrappers widen the narrower operands before launching (``widen``;
widening is exact).

Each kernel has three designs (``csrc/fused_gru.cu``,
``fused_gru_bwd.cu``): at T > 1, where a thread-block cluster can hold R in
shared memory (H <= 512), the cluster kernel, on the cluster layer of
``csrc/recurrent_cluster.cuh``; at T > 1 past that width, where the whole
card holds R, the grid kernel, on the grid layer of
``csrc/recurrent_grid.cuh`` (R split across row groups of CTAs, 64 a
group in f32 at H = 1024, one barrier a step over a group, h or the
partial carries through L2, the bf16 step products on the tensor cores;
the wrapper allocates the workspace the launcher's plan asks for); at T ==
1 and for any R the card cannot hold, the stream kernel, which reads R
(the backward: R^T, formed by the wrapper for that design alone) from L2
every step. The C launchers choose;
:func:`fwd_design` and :func:`bwd_design` repeat their choices, and
``FWD_KERNEL_NAMES`` and ``BWD_KERNEL_NAMES`` name each design's device
function.

A stream block keeps all of h in shared memory, under the launchers' cap,
so H has a limit: :func:`kernel_admits` repeats the launchers' arithmetic
(the cluster and grid designs take only shapes the stream design also
takes). The
registry sends an all-CUDA ``gru_layer`` call here when
:func:`kernel_admits` takes it (f32 or bf16, H under the limit of the
kernels the call will run); any other call takes the plain lowering, as
the JAX package sends it to XLA. A call sent here launches the kernel or
raises. The wrappers take the plain versions (``ops/recurrent.py``) only
for CPU tensors. ``FUSED_GRU.launches`` and ``FUSED_GRU_BWD.launches``
count launches; ``FUSED_GRU.reserves`` counts the forward launches that
saved the reserve.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearning4j_tpu_torch.common.dtypes import widen
from deeplearning4j_tpu_torch.ops.cuda.build import launch, pointer
from deeplearning4j_tpu_torch.ops.cuda import recurrent_cluster as rc
from deeplearning4j_tpu_torch.ops.cuda import recurrent_grid as rg
from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import (
    RecurrentKernel, _check_shapes, _check_tensors, _needs_grad, _promoted,
    stream_slices,
)
from deeplearning4j_tpu_torch.ops.cuda.recurrent_cluster import (
    Design, plan_cluster, rows_max,
)
from deeplearning4j_tpu_torch.ops.recurrent import (
    finish_h, gru_bwd_recurrence, gru_recurrence, project_gates,
)
from deeplearning4j_tpu_torch.ops.registry import register_impl

#: the plain versions the kernels are held against
plain_recurrence = gru_recurrence
plain_bwd_recurrence = gru_bwd_recurrence

#: the C launcher for each element type the kernels take
_FWD_SYMBOLS = {torch.float32: "dl4j_gru_fwd",
                torch.bfloat16: "dl4j_gru_fwd_bf16"}
_BWD_SYMBOLS = {torch.float32: "dl4j_gru_bwd",
                torch.bfloat16: "dl4j_gru_bwd_bf16"}

#: the device function of each design, for profiles
FWD_KERNEL_NAMES = {"cluster": "gru_fwd_cluster_kernel",
                    "grid": "gru_fwd_grid_kernel",
                    "stream": "gru_fwd_kernel"}
BWD_KERNEL_NAMES = {"cluster": "gru_bwd_cluster_kernel",
                    "grid": "gru_bwd_grid_kernel",
                    "stream": "gru_bwd_kernel"}

FUSED_GRU = RecurrentKernel(
    "fused_gru_fwd", "fused_gru.cu",
    "deeplearning4j_tpu/ops/pallas/fused_gru.py:45 (_gru_kernel)",
    {**{sym: "pppppppliiip" for sym in _FWD_SYMBOLS.values()},
     "dl4j_gru_fwd_plan": "iiiip", "dl4j_gru_active_clusters": "iiiip",
     "dl4j_gru_grid_resident": "iiip"})
FUSED_GRU_BWD = RecurrentKernel(
    "fused_gru_bwd", "fused_gru_bwd.cu",
    "deeplearning4j_tpu/ops/pallas/fused_gru.py:237 (_gru_bwd_kernel)",
    {**{sym: "pppppppppliiip" for sym in _BWD_SYMBOLS.values()},
     "dl4j_gru_bwd_plan": "iiiip", "dl4j_gru_bwd_active_clusters": "iiiip",
     "dl4j_gru_bwd_grid_resident": "iiip"})


def fused_gru_recurrence(xg, R, h0, save_residuals=False):
    """xg [T, B, 3H] time-major gates -> (outputs [T, B, H], hT), and with
    ``save_residuals`` the reserve [4, T, B, H] f32 too.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Mixed f32/bf16 operands compute in f32."""
    xg, R, h0 = widen(xg, R, h0)
    if xg.device.type == "cpu":
        return plain_recurrence(xg, R, h0, save_residuals)
    if xg.device.type != "cuda":
        raise ValueError(f"fused_gru: unsupported device {xg.device}")
    if xg.dim() != 3 or xg.shape[2] % 3:
        raise ValueError(f"fused_gru: xg must be [T, B, 3H], got "
                         f"{list(xg.shape)}")
    T, B, G = xg.shape
    H = G // 3
    _check_tensors("fused_gru", xg.dtype, xg.device, {
        "xg": (xg, None), "R": (R, None), "h0": (h0, None)})
    _check_shapes("fused_gru", {"R": (R, (H, G)), "h0": (h0, (B, H))})
    reserve = (xg.new_empty((4, T, B, H), dtype=torch.float32)
               if save_residuals else None)
    if T == 0:
        res = (xg.new_empty((0, B, H)), h0)
        return res + (reserve,) if save_residuals else res
    out = xg.new_empty((T, B, H))
    hT = xg.new_empty((B, H))
    # decode (T == 1) always takes the stream design, which needs no
    # workspace: only longer calls ask the launcher's plan
    work = (_workspace(_fwd_plan(T, B, H, xg.dtype, xg.device)[1], xg)
            if T > 1 else None)
    launch(FUSED_GRU, _FWD_SYMBOLS[xg.dtype], xg.device, (
        pointer(xg), pointer(R), pointer(h0), pointer(out), pointer(hT),
        pointer(reserve), pointer(work), _nbytes(work), T, B, H))
    if save_residuals:
        FUSED_GRU.reserves += 1
    return (out, hT, reserve) if save_residuals else (out, hT)


def fused_gru_bwd_recurrence(reserve, R, h0, out, dout):
    """The reverse-time walk: (dg [T, B, 3H] f32, dh0 [B, H] f32) from the
    forward's reserve, its outputs ``out`` [T, B, H] (h_{t-1} after the
    first step) and ``dout`` [T, B, H] (kernel time order, the gradient of
    hT joined at the last step).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Mixed f32/bf16 operands (the reserve aside) compute in f32."""
    R, h0, out, dout = widen(R, h0, out, dout)
    if reserve.device.type == "cpu":
        return plain_bwd_recurrence(reserve, R, h0, out, dout)
    if reserve.device.type != "cuda":
        raise ValueError(f"fused_gru_bwd: unsupported device {reserve.device}")
    if reserve.dim() != 4 or reserve.shape[0] != 4:
        raise ValueError(f"fused_gru_bwd: reserve must be [4, T, B, H], "
                         f"got {list(reserve.shape)}")
    T, B, H = reserve.shape[1:]
    dt, dev = R.dtype, reserve.device
    _check_tensors("fused_gru_bwd", dt, dev, {
        "reserve": (reserve, torch.float32), "R": (R, None),
        "h0": (h0, None), "out": (out, None), "dout": (dout, None)})
    _check_shapes("fused_gru_bwd", {
        "R": (R, (H, 3 * H)), "h0": (h0, (B, H)), "out": (out, (T, B, H)),
        "dout": (dout, (T, B, H))})
    # the stream design reads R^T; the cluster and grid designs read R
    # itself, the grid design with its workspace
    design, nbytes = _bwd_plan(T, B, H, dt, dev)
    Rt = R.t().contiguous() if design.kind == "stream" else None
    work = _workspace(nbytes, reserve)
    dg = reserve.new_empty((T, B, 3 * H))
    dh0 = reserve.new_empty((B, H))
    launch(FUSED_GRU_BWD, _BWD_SYMBOLS[dt], dev, (
        pointer(reserve), pointer(R), pointer(Rt), pointer(h0), pointer(out),
        pointer(dout), pointer(dg), pointer(dh0), pointer(work),
        _nbytes(work), T, B, H))
    return dg, dh0


def _workspace(nbytes: int, like: torch.Tensor):
    """The workspace a launcher's plan asks for (``nbytes`` bytes on
    ``like``'s device; the grid design's), or None where it asks for
    none."""
    return like.new_empty(nbytes, dtype=torch.uint8) if nbytes else None


def _nbytes(work) -> int:
    """The bytes of a workspace from :func:`_workspace` (0 for None)."""
    return 0 if work is None else work.numel()


class FusedGRUFunction(torch.autograd.Function):
    """``gru_layer`` through the two kernels, differentiable.

    The counterpart of the JAX package's ``_fused`` / ``_fused_fwd`` /
    ``_fused_bwd``. The forward launches the forward kernel with the
    reserve; the backward launches the backward kernel, which also gives
    dh0, then forms dx, dW, dR and db as plain products, each cast to its
    input's dtype. CPU tensors take both kernels' plain versions, so the
    CPU tests run the same assembly code as the card."""

    @staticmethod
    def forward(ctx, x, h0, W, R, b, reverse):
        xg = project_gates(x, W, b, reverse=reverse)
        out, hT, reserve = fused_gru_recurrence(xg, R, h0,
                                                save_residuals=True)
        # the reserve, outputs and dg stay in kernel time order (flipped
        # when reverse), the domain the backward kernel walks
        ctx.save_for_backward(x, h0, W, R, out, reserve)
        ctx.reverse = reverse
        ctx.b_dtype = b.dtype
        return finish_h(out, hT, reverse)

    @staticmethod
    def backward(ctx, g_out, g_hT):
        x, h0, W, R, out, reserve = ctx.saved_tensors
        need = ctx.needs_input_grad
        f32 = torch.float32
        T, B, H = out.shape
        G = 3 * H
        if g_out is None:
            dout = torch.zeros_like(out)
        else:  # a fresh buffer in kernel time order: g_out stays as it is
            dout = torch.empty_like(out)
            g = g_out.transpose(0, 1)
            dout.copy_(g.flip(0) if ctx.reverse else g)
        if g_hT is not None:  # hT aliases the last kernel step's output
            dout[T - 1] += g_hT.to(out.dtype)
        dg, dh0 = fused_gru_bwd_recurrence(reserve, R, h0, out, dout)

        # everything that is not sequential: plain products in f32, each
        # cast to its input's dtype
        dx = dW = dR = db = None
        dg_nat = dg.flip(0) if ctx.reverse else dg     # natural time order
        if need[0]:
            dx = (dg_nat.reshape(T * B, G) @ W.to(f32).t()).reshape(T, B, -1)
            dx = dx.transpose(0, 1).to(x.dtype)
        if need[2]:
            xt = x.transpose(0, 1).reshape(T * B, -1).to(f32)
            dW = (xt.t() @ dg_nat.reshape(T * B, G)).to(W.dtype)
        if need[3]:
            # the h path's gate gradients: hg_n enters n through r
            dgh = dg.clone()
            dgh[..., 2 * H:] *= reserve[0]
            # h_prev is h0 at the first kernel step, out after it
            dR = h0.to(out.dtype).to(f32).t() @ dgh[0]
            if T > 1:
                dR += out[:-1].reshape(-1, H).to(f32).t() @ dgh[1:].reshape(-1, G)
            dR = dR.to(R.dtype)
        if need[4]:
            db = dg.reshape(T * B, G).sum(0).to(ctx.b_dtype)
        # a carry that needs no gradient (a tBPTT chunk's detached h0) gets
        # None, as autograd expects
        return (dx, dh0.to(h0.dtype) if need[1] else None, dW, dR, db,
                None)


def fused_gru_layer(x, h0, W, R, b, *, reverse=False):
    """Kernel implementation of the ``gru_layer`` op (same signature).

    When autograd will need the layer's gradients (grad mode on and some
    input requires grad), the call goes through :class:`FusedGRUFunction`,
    whose forward saves the reserve for the backward kernel. Otherwise
    (serving, under ``torch.no_grad``) the forward kernel runs alone and
    saves nothing. The choice is made on every call. Mixed operand types
    promote as jnp's do, operation by operation: the projection over x, W
    and b, the recurrence over its gates, R and h0."""
    x, W, b = widen(x, W, b)
    R, h0 = R.contiguous(), h0.contiguous()
    if x.shape[1] and _needs_grad((x, h0, W, R, b)):
        return FusedGRUFunction.apply(x, h0, W, R, b, bool(reverse))
    xg = project_gates(x, W, b, reverse=reverse)
    out, hT = fused_gru_recurrence(xg, R, h0)
    return finish_h(out, hT, reverse)


# ------------------------------------------------- what the kernels take

#: csrc/fused_gru.cu and csrc/fused_gru_bwd.cu (kTile, kSmemCap): hidden
#: units per work item of a stream block, and the shared memory it may use
SMEM_TILE = 32
SMEM_CAP = 200 * 1024


def stream_smem_bytes(rb: int, H: int, upb: int, slices: int = 1) -> int:
    """A stream block's shared memory (csrc/fused_gru.cu ``smem_bytes``):
    h [RB][H], the carry [RB][upb] and the k-slices' partial sums."""
    tiles = -(-upb // SMEM_TILE)
    return 4 * (rb * H + rb * upb + slices * tiles * 3 * rb * SMEM_TILE)


def fwd_smem_bytes(T: int, H: int) -> int:
    """The stream launcher's least shared memory for a [T, *, H] call:
    one batch row a block and one k-slice, and upb as the launcher sets it
    (all of H when T > 1, one tile of units when T == 1). The launcher
    refuses the call when this exceeds the cap (``plan_fwd``)."""
    return stream_smem_bytes(1, H, min(H, SMEM_TILE) if T == 1 else H)


def bwd_smem_bytes(H: int) -> int:
    """The backward stream launcher's least shared memory, one row a block
    and one slice; the launcher refuses the call above the cap
    (``plan_bwd``)."""
    return bwd_stream_smem_bytes(1, H)


#: csrc/fused_gru.cu (kMaxSlices, kWarps): k-slices a unit tile at most,
#: and the warps of a stream block
MAX_SLICES = 16
STREAM_WARPS = 16


def cluster_smem_bytes(rb: int, H: int, e: int) -> int:
    """A forward cluster CTA's shared memory for RB rows and elements of
    ``e`` bytes: ``fwd_cluster_smem_bytes`` with three gates."""
    return rc.fwd_cluster_smem_bytes(rb, H, 3, e)


def bwd_cluster_smem_bytes(rb: int, H: int, C: int, e: int) -> int:
    """A backward cluster CTA's shared memory for RB rows, a cluster of C
    and elements of ``e`` bytes: ``bwd_cluster_smem_bytes`` with three
    gates."""
    return rc.bwd_cluster_smem_bytes(rb, H, C, 3, e)


def fwd_design(T: int, B: int, H: int, dtype: torch.dtype,
               active_clusters=None, co_resident=None) -> Design:
    """The forward launcher's choice for a [T, B, *, H] call
    (csrc/fused_gru.cu ``plan_fwd``). ``active_clusters(C, rows, smem)`` is
    the card's ``cudaOccupancyMaxActiveClusters`` for clusters of C CTAs of
    the kernel for ``rows`` rows with ``smem`` bytes each;
    ``co_resident(rows, smem)`` the CTAs of the grid kernel for ``rows``
    rows the card holds at once; None asks the card
    (:func:`card_active_clusters`, :func:`card_co_resident`).

    T > 1 takes the cluster design where ``plan_cluster`` finds one, else
    the grid design where ``plan_grid`` finds one. Everything else takes
    the stream
    design (whose launcher refuses what :func:`kernel_admits` refuses):
    rows halved while over the cap, then more k-slices while warps would
    idle."""
    e = 2 if dtype == torch.bfloat16 else 4
    if T > 1:
        d = plan_cluster(B, H, lambda rb, C: cluster_smem_bytes(rb, H, e),
                         active_clusters or card_active_clusters(dtype))
        if d is not None:
            return d
        d = rg.plan_grid(B, H, e, lambda rb: rg.fwd_grid_smem_bytes(H, 3),
                         co_resident or card_co_resident(dtype))
        if d is not None:
            return d
    upb = min(H, SMEM_TILE) if T == 1 else H
    tiles = -(-upb // SMEM_TILE)
    rb = rows_max(B)
    while rb > 1 and stream_smem_bytes(rb, H, upb) > SMEM_CAP:
        rb //= 2
    slices = stream_slices(tiles, H,
                           lambda s: stream_smem_bytes(rb, H, upb, s))
    return Design("stream", None, rb, stream_smem_bytes(rb, H, upb, slices))


def bwd_stream_smem_bytes(rb: int, H: int, slices: int = 1) -> int:
    """A backward stream block's shared memory (csrc/fused_gru_bwd.cu
    ``smem_bytes``): the product operands [RB][3H], the direct term [RB][H]
    and the slices' partial sums."""
    return 4 * (rb * 3 * H + rb * H + slices * -(-H // SMEM_TILE) * rb
                * SMEM_TILE)


def bwd_design(T: int, B: int, H: int, dtype: torch.dtype,
               active_clusters=None, co_resident=None) -> Design:
    """The backward launcher's choice for a [T, B, *, H] call
    (csrc/fused_gru_bwd.cu ``plan_bwd``), as :func:`fwd_design` for the
    forward: the cluster design at T > 1 where ``plan_cluster`` finds one
    (a CTA's shared memory grows with the cluster, by its receive slots);
    else the grid design where ``plan_grid`` finds one (a CTA's shared
    memory grows with its rows, by the product operands); else the stream
    design, rows halved while over the cap, then more slices of the 3H
    reduction while warps would idle. ``active_clusters`` and
    ``co_resident`` None ask the card (:func:`card_bwd_active_clusters`,
    :func:`card_bwd_co_resident`)."""
    e = 2 if dtype == torch.bfloat16 else 4
    if T > 1:
        d = plan_cluster(B, H,
                         lambda rb, C: bwd_cluster_smem_bytes(rb, H, C, e),
                         active_clusters or card_bwd_active_clusters(dtype))
        if d is not None:
            return d
        d = rg.plan_grid(B, H, e,
                         lambda rb: rg.bwd_grid_smem_bytes(rb, H, 3, e),
                         co_resident or card_bwd_co_resident(dtype))
        if d is not None:
            return d
    rb = rows_max(B)
    while rb > 1 and bwd_stream_smem_bytes(rb, H) > SMEM_CAP:
        rb //= 2
    slices = stream_slices(-(-H // SMEM_TILE), 3 * H,
                           lambda s: bwd_stream_smem_bytes(rb, H, s))
    return Design("stream", None, rb, bwd_stream_smem_bytes(rb, H, slices))


def card_active_clusters(dtype: torch.dtype, device=None):
    """``active_clusters`` for :func:`fwd_design` from the card."""
    return rc.card_active_clusters(FUSED_GRU, "dl4j_gru_active_clusters",
                                   dtype, device)


def card_bwd_active_clusters(dtype: torch.dtype, device=None):
    """``active_clusters`` for :func:`bwd_design` from the card."""
    return rc.card_active_clusters(FUSED_GRU_BWD,
                                   "dl4j_gru_bwd_active_clusters", dtype,
                                   device)


def card_co_resident(dtype: torch.dtype, device=None):
    """``co_resident`` for :func:`fwd_design` from the card."""
    return rg.card_co_resident(FUSED_GRU, "dl4j_gru_grid_resident", dtype,
                               device)


def card_bwd_co_resident(dtype: torch.dtype, device=None):
    """``co_resident`` for :func:`bwd_design` from the card."""
    return rg.card_co_resident(FUSED_GRU_BWD, "dl4j_gru_bwd_grid_resident",
                               dtype, device)


def launcher_plan(kernel, symbol: str, T: int, B: int, H: int,
                  dtype: torch.dtype, device=None) -> tuple[Design, int]:
    """A C launcher's own plan (``symbol``, a ``dl4j_gru_*_plan``) on the
    card: its :class:`Design` and the workspace bytes a call must pass (0
    unless grid)."""
    kind, C, rb, smem, units, ctas, groups, work = rc.query(
        kernel, symbol, 8, device, T, B, H, int(dtype == torch.bfloat16),
        ctype=ctypes.c_longlong)
    if kind == 2:
        return Design("grid", None, rb, smem, units, ctas, groups), work
    return Design("cluster" if kind else "stream", C or None, rb, smem), 0


def launcher_design(T: int, B: int, H: int, dtype: torch.dtype,
                    device=None) -> Design:
    """The forward C launcher's own choice (``dl4j_gru_fwd_plan``)."""
    return launcher_plan(FUSED_GRU, "dl4j_gru_fwd_plan", T, B, H, dtype,
                         device)[0]


def launcher_bwd_design(T: int, B: int, H: int, dtype: torch.dtype,
                        device=None) -> Design:
    """The backward C launcher's own choice (``dl4j_gru_bwd_plan``)."""
    return launcher_plan(FUSED_GRU_BWD, "dl4j_gru_bwd_plan", T, B, H, dtype,
                         device)[0]


#: the launchers' plans by call, asked once: the wrappers allocate the
#: workspace a plan asks for, and form R^T only for the backward's stream
#: design
_fwd_plan = functools.lru_cache(maxsize=256)(
    functools.partial(launcher_plan, FUSED_GRU, "dl4j_gru_fwd_plan"))
_bwd_plan = functools.lru_cache(maxsize=256)(
    functools.partial(launcher_plan, FUSED_GRU_BWD, "dl4j_gru_bwd_plan"))


def kernel_admits(T: int, H: int, dtype: torch.dtype,
                  backward: bool) -> bool:
    """Can the kernels compute a call of this length, width and (promoted)
    type: f32 or bf16, and the shared memory of the forward, and of the
    backward when autograd will run it, under the cap. The cluster and
    grid designs widen nothing: they take only shapes that the stream
    launchers take too."""
    return (dtype in _FWD_SYMBOLS and fwd_smem_bytes(T, H) <= SMEM_CAP
            and (not backward or bwd_smem_bytes(H) <= SMEM_CAP))


def _gru_requires(x, h0, W, R, b, **kw):
    """Every tensor on the card, and :func:`kernel_admits` for the call's
    promoted type, T, H and whether autograd will run the backward."""
    ts = (x, h0, W, R, b)
    return all(t.is_cuda for t in ts) and kernel_admits(
        x.shape[1], R.shape[0], _promoted(ts),
        bool(x.shape[1]) and _needs_grad(ts))


register_impl("gru_layer", platform="cuda", requires=_gru_requires,
              priority=1)(fused_gru_layer)
