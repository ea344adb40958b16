"""Local response normalization: the hand-written CUDA kernels behind
``lrn``.

Counterpart of ``deeplearning4j_tpu/ops/pallas/lrn.py``. Two kernels, on
the [R, C] row view of a channels-last tensor (R pixels, C channels):

- ``csrc/lrn_fwd.cu`` replaces ``_lrn_kernel`` (launched by
  ``_lrn_forward``): y = x / (k + alpha * ssum)^beta, ssum the sum of x^2
  over the channel window [c - depth//2, c + depth - 1 - depth//2];
- ``csrc/lrn_bwd.cu`` replaces ``_lrn_bwd_kernel`` (launched by
  ``_lrn_backward``): the closed form
  dx = g d^-beta - 2 alpha beta x ((g x d^(-beta-1)) summed over the
  mirrored window), recomputing d from x; nothing but x is saved.

:class:`LRNFunction` ties them together for autograd, the counterpart of
the ``jax.custom_vjp`` ``_lrn``. Both kernels take f32 or bf16, compute in
f32 and store in the input's type, as the Pallas kernels do, so in bf16
they differ from the registered plain lowering (``ops/convolution.py``),
which computes in bf16 as the XLA lowering does. They take any depth and a
C of at most :data:`MAX_CHANNELS` (a block stages its rows' squares in
shared memory).

Both kernels share one layout (``csrc/lrn_common.cuh``): 8 channels a
thread, moved as 16-byte vectors where the pointers are aligned and C is a
multiple of the vector, whole rows a block. :func:`fwd_design` repeats the
forward launcher's choice, and :func:`launcher_design` asks the launcher
itself (``dl4j_lrn_fwd_plan``).

The wrappers take the plain versions (:func:`lrn_fwd_plain`,
:func:`lrn_bwd_plain`) only for CPU tensors; for CUDA tensors they launch
the kernels or raise. ``LRN_FWD.launches`` and ``LRN_BWD.launches`` count
launches. The registry sends every CUDA ``lrn`` call that
:func:`lrn_requires` admits here. No predicate is carried over from the
TPU: ``_lrn_requires`` (at least 2048 pixels, 32 <= C <= 1024) is a VMEM
bound of the Pallas kernel, and no threshold has been measured on this
card.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.convolution import window_sum
from deeplearning4j_tpu_torch.ops.cuda import recurrent_cluster as rc
from deeplearning4j_tpu_torch.ops.cuda.build import CudaKernel, launch, pointer
from deeplearning4j_tpu_torch.ops.registry import register_impl

#: the largest channel count the kernels take (a row in one block)
MAX_CHANNELS = 4096
#: the layout's constants (csrc/lrn_common.cuh): channels a thread, threads
#: a block of several rows
SEG = 8
THREADS = 256
_PALLAS = "deeplearning4j_tpu/ops/pallas/lrn.py"

#: the C launcher of each kernel for each element type it takes
_FWD_SYMBOLS = {torch.float32: "dl4j_lrn_fwd",
                torch.bfloat16: "dl4j_lrn_fwd_bf16"}
_BWD_SYMBOLS = {torch.float32: "dl4j_lrn_bwd",
                torch.bfloat16: "dl4j_lrn_bwd_bf16"}

LRN_FWD = CudaKernel("lrn_fwd", "lrn_fwd.cu", f"{_PALLAS}:31 (_lrn_kernel)",
                     {**{sym: "ppliifffp" for sym in _FWD_SYMBOLS.values()},
                      "dl4j_lrn_fwd_plan": "iiip"})
LRN_BWD = CudaKernel("lrn_bwd", "lrn_bwd.cu",
                     f"{_PALLAS}:84 (_lrn_bwd_kernel)",
                     {sym: "pppliifffp" for sym in _BWD_SYMBOLS.values()})


def _windows(depth):
    """(before, after): the forward window's reach below and above c."""
    half = depth // 2
    return half, depth - 1 - half


def fwd_design(C: int, aligned: bool, dtype: torch.dtype = torch.float32):
    """The forward launcher's design for C channels, x and y 16-byte
    aligned or not: (path, rows_per_block, threads_per_row), path "vector"
    (16-byte loads and stores) or "element". Mirrors ``lrn::layout`` and
    ``lrn::vector_path`` of csrc/lrn_common.cuh."""
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"C = {C} outside the kernel's 1 to {MAX_CHANNELS}")
    tpr = -(-C // SEG)
    rows = THREADS // tpr if tpr <= THREADS else 1
    vector = aligned and C % (16 // dtype.itemsize) == 0
    return ("vector" if vector else "element"), rows, tpr


def launcher_design(C: int, aligned: bool, dtype: torch.dtype = torch.float32,
                    device=None):
    """The forward C launcher's own design (``dl4j_lrn_fwd_plan``) on the
    card, as :func:`fwd_design` gives it."""
    vec, rows, tpr = rc.query(LRN_FWD, "dl4j_lrn_fwd_plan", 3, device, int(C),
                              int(bool(aligned)),
                              int(dtype == torch.bfloat16))
    return ("vector" if vec else "element"), rows, tpr


# ----------------------------------------------------------- plain versions

def lrn_fwd_plain(x, *, depth=5, alpha=1e-4, beta=0.75, k=2.0):
    """The forward kernel's function in plain PyTorch: f32 inside, stored
    in x's type; channels on the last axis."""
    before, after = _windows(depth)
    xf = x.float()
    d = k + alpha * window_sum(xf * xf, -before, after)
    return (xf / d ** beta).to(x.dtype)


def lrn_bwd_plain(x, g, *, depth=5, alpha=1e-4, beta=0.75, k=2.0):
    """The backward kernel's function in plain PyTorch (``lrn.py:88-97``):
    dx in x's type, f32 inside."""
    before, after = _windows(depth)
    xf, gf = x.float(), g.float()
    d = k + alpha * window_sum(xf * xf, -before, after)
    dpow = d ** (-beta)
    u = gf * xf * dpow / d  # g x d^(-beta-1)
    t = window_sum(u, -after, before)  # the mirrored window
    return (gf * dpow - 2.0 * alpha * beta * xf * t).to(x.dtype)


# ----------------------------------------------------------------- wrappers

def _check(what, x, depth, g=None):
    """Device, type, contiguity and the kernel's limits; returns (R, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _FWD_SYMBOLS:
        raise TypeError(f"{what}: x is {x.dtype}; the kernel takes float32 "
                        "or bfloat16")
    if x.dim() < 1 or not 1 <= x.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"{what}: channel axis of {list(x.shape)} must hold "
                         f"1 to {MAX_CHANNELS} channels (the kernel's limit)")
    if int(depth) < 1:
        raise ValueError(f"{what}: depth {depth} < 1")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x is not contiguous (the kernel reads the "
                         "[R, C] row view)")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype
                          or g.device != x.device or not g.is_contiguous()):
        raise ValueError(f"{what}: g must be a contiguous {x.dtype} "
                         f"{list(x.shape)} on {x.device}, got {g.dtype} "
                         f"{list(g.shape)} on {g.device}")
    C = x.shape[-1]
    return x.numel() // C, C


def lrn_forward(x, *, depth=5, alpha=1e-4, beta=0.75, k=2.0):
    """y in x's type. CPU tensors take the plain version; CUDA tensors
    launch the forward kernel."""
    if x.device.type == "cpu":
        return lrn_fwd_plain(x, depth=depth, alpha=alpha, beta=beta, k=k)
    R, C = _check("lrn_forward", x, depth)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    launch(LRN_FWD, _FWD_SYMBOLS[x.dtype], x.device, (
        pointer(x), pointer(y), R, C, int(depth), float(alpha), float(beta),
        float(k)))
    return y


def lrn_backward(x, g, *, depth=5, alpha=1e-4, beta=0.75, k=2.0):
    """dx in x's type from x and the output's gradient g (same type and
    shape, contiguous). CPU tensors take the plain version; CUDA tensors
    launch the backward kernel."""
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, g, depth=depth, alpha=alpha, beta=beta, k=k)
    R, C = _check("lrn_backward", x, depth, g)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if R == 0:
        return dx
    launch(LRN_BWD, _BWD_SYMBOLS[x.dtype], x.device, (
        pointer(x), pointer(g), pointer(dx), R, C, int(depth), float(alpha),
        float(beta), float(k)))
    return dx


class LRNFunction(torch.autograd.Function):
    """LRN, differentiable: the forward kernel, which saves x, and the
    backward kernel, which recomputes d from it. CPU tensors take the plain
    versions, so the CPU tests run the same assembly code as the card."""

    @staticmethod
    def forward(ctx, x, depth, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hp = dict(depth=depth, alpha=alpha, beta=beta, k=k)
        return lrn_forward(x, **ctx.hp)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx = lrn_backward(x, g.to(x.dtype).contiguous(), **ctx.hp)
        return dx, None, None, None, None


# ----------------------------------------------------------- op-level entry

def lrn_kernel(x, *, depth=5, alpha=1e-4, beta=0.75, k=2.0):
    """Kernel implementation of ``lrn`` (same signature). When autograd will
    need the gradient, the call goes through :class:`LRNFunction`;
    otherwise the forward kernel runs alone and nothing is saved."""
    hp = dict(depth=int(depth), alpha=float(alpha), beta=float(beta),
              k=float(k))
    if torch.is_grad_enabled() and x.requires_grad:
        return LRNFunction.apply(x, *hp.values())
    return lrn_forward(x, **hp)


def lrn_requires(x, *, depth=5, **kw):
    """Structural: what the kernels compute. f32 or bf16, x contiguous (a
    contiguous channel axis and the [R, C] row view), 1 <= C <=
    MAX_CHANNELS, depth >= 1."""
    return (x.dtype in _FWD_SYMBOLS and x.dim() >= 1 and x.is_contiguous()
            and 1 <= x.shape[-1] <= MAX_CHANNELS and int(depth) >= 1)


def _cuda_requires(x, **kw):
    return x.is_cuda and lrn_requires(x, **kw)


register_impl("lrn", platform="cuda", requires=_cuda_requires,
              priority=1)(lrn_kernel)
