"""Flash attention: the hand-written CUDA kernels behind
``dot_product_attention``.

Counterpart of ``deeplearning4j_tpu/ops/pallas/flash_attention.py``. Three
kernels:

- ``csrc/flash_attention_fwd.cu`` replaces ``_flash_kernel`` (launched by
  ``_flash_forward``): the blocked online softmax, giving o and the row
  logsumexp ``lse`` [B, N, Tq, 1] f32;
- ``csrc/flash_attention_dq.cu`` replaces ``_flash_dq_kernel`` and
  ``csrc/flash_attention_dkv.cu`` replaces ``_flash_dkv_kernel`` (both
  launched by ``_flash_backward``): dq, dk and dv in f32, recomputing each
  probability tile as exp(s - lse).

``delta = rowsum(do * o)`` is formed outside the kernels in f32, as
``_flash_bwd`` forms it, and the backward kernels take ``lse`` and
``delta`` as inputs, so :func:`flash_block_bwd` can be given a global lse.
:class:`FlashAttentionFunction` ties forward and backward together for
autograd, the counterpart of the ``jax.custom_vjp`` ``_flash``.

Semantics kept from the Pallas kernels: a key is masked past Tk, where the
key-padding mask ``kmask`` [B, Tk] (indexed per batch, never per head) is
not > 0, and, when causal, after the query (start-aligned ``qpos >= kpos``);
a row that sees no key gives o = 0 and lse = +inf. The XLA lowering gives
the mean of v there instead (``ops/attention.py``). In bf16, products take
the input type's values with f32 sums, the scale multiplies the f32
product, p is rounded to v's (do's) type and ds to k's (q's) type before
their products, and o is stored in the input type. The kernels take f32 or
bf16 and any head dim up to 128. The bf16 kernels run on the tensor cores
(wgmma; ``FWD_KERNEL_NAMES``, ``DQ_KERNEL_NAMES``, ``DKV_KERNEL_NAMES``
name each type's device function). The f32 dq and dk/dv run on the tensor
cores too, in three TF32 passes a product (each operand split into tf32
hi and lo parts, a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, on mma.sync):
within 3 * 2^-22 |a| |b| of the f32 product, so f32 accuracy at up to
2.5x the CUDA cores' f32 rate (``csrc/flash_common.cuh``, flash::tf32).
The f32 forward runs on the CUDA cores. None of the TPU machinery is
carried over (``bwd_tiles``, the v5e tile defaults): the kernels tile by
64 rows.

The wrappers take the plain versions (:func:`flash_forward_plain`,
:func:`flash_backward_plain`) only for CPU tensors; for CUDA tensors they
launch the kernels or raise. ``FLASH_FWD.launches``, ``FLASH_DQ.launches``
and ``FLASH_DKV.launches`` count launches. The registry sends every
all-CUDA ``dot_product_attention`` call that :func:`kernel_admits` admits
here (f32 or bf16, and :func:`flash_requires`); others take the plain
lowering; no predicate is carried over from the TPU (the JAX package's
T >= 2048 was measured on a v5e).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops.cuda.build import CudaKernel, launch, pointer
from deeplearning4j_tpu_torch.ops.registry import register_impl

MAX_HEAD_DIM = 128
_PALLAS = "deeplearning4j_tpu/ops/pallas/flash_attention.py"

#: the C launcher of each kernel for each element type it takes
_FWD_SYMBOLS = {torch.float32: "dl4j_flash_fwd",
                torch.bfloat16: "dl4j_flash_fwd_bf16"}
_DQ_SYMBOLS = {torch.float32: "dl4j_flash_dq",
               torch.bfloat16: "dl4j_flash_dq_bf16"}
_DKV_SYMBOLS = {torch.float32: "dl4j_flash_dkv",
                torch.bfloat16: "dl4j_flash_dkv_bf16"}

#: the device function each launcher runs, for profiles: the bf16 kernels
#: are the tensor-core (wgmma) designs, the f32 dq and dk/dv the three-pass
#: TF32 ones (mma.sync), the f32 forward runs on the CUDA cores
FWD_KERNEL_NAMES = {torch.float32: "flash_fwd_kernel",
                    torch.bfloat16: "flash_fwd_wgmma_kernel"}
DQ_KERNEL_NAMES = {torch.float32: "flash_dq_tf32x3_kernel",
                   torch.bfloat16: "flash_dq_wgmma_kernel"}
DKV_KERNEL_NAMES = {torch.float32: "flash_dkv_tf32x3_kernel",
                    torch.bfloat16: "flash_dkv_wgmma_kernel"}

FLASH_FWD = CudaKernel(
    "flash_attention_fwd", "flash_attention_fwd.cu",
    f"{_PALLAS}:56 (_flash_kernel)",
    {**{sym: "ppppppiiiiifip" for sym in _FWD_SYMBOLS.values()},
     "dl4j_flash_tile_check": "ppppp"})
FLASH_DQ = CudaKernel(
    "flash_attention_dq", "flash_attention_dq.cu",
    f"{_PALLAS}:210 (_flash_dq_kernel)",
    {sym: "ppppppppiiiiifip" for sym in _DQ_SYMBOLS.values()})
FLASH_DKV = CudaKernel(
    "flash_attention_dkv", "flash_attention_dkv.cu",
    f"{_PALLAS}:248 (_flash_dkv_kernel)",
    {sym: "pppppppppiiiiifip" for sym in _DKV_SYMBOLS.values()})


# ----------------------------------------------------------- plain versions

def _valid(Tq, Tk, kmask, causal, device):
    """Which (query, key) pairs count: [B or 1, 1, Tq, Tk] bool."""
    valid = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        valid = valid.tril()
    if kmask is not None:
        valid = valid & (kmask > 0)[:, None, None, :]
    return valid


def flash_forward_plain(q, k, v, *, scale, causal=False, kmask=None):
    """The forward kernel's function in plain PyTorch: (o [B, N, Tq, D] in
    q's type, lse [B, N, Tq, 1] f32), with the kernel's masking and its
    o = 0, lse = +inf on a row that sees no key."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    valid = _valid(q.shape[2], k.shape[2], kmask, causal, q.device)
    s = s.masked_fill(~valid, -math.inf)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    denom = l.clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).to(f32), v.to(f32)) / denom
    lse = torch.where(l > 0, m_safe + torch.log(denom),
                      torch.full_like(l, math.inf))
    return o.to(q.dtype), lse


def flash_backward_plain(q, k, v, do, lse, delta, *, scale, causal=False,
                         kmask=None):
    """The two backward kernels' function in plain PyTorch: (dq, dk, dv),
    f32, from the row logsumexp ``lse`` and ``delta = rowsum(do * o)``
    ([B, N, Tq, 1] f32 each)."""
    f32 = torch.float32
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    valid = _valid(q.shape[2], k.shape[2], kmask, causal, q.device)
    p = torch.exp(s - lse).masked_fill(~valid, 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta)).masked_fill(~valid, 0.0)
    dq = scale * torch.matmul(ds.to(k.dtype).to(f32), kf)
    dk = scale * torch.matmul(ds.to(q.dtype).to(f32).transpose(-1, -2), qf)
    dv = torch.matmul(p.to(do.dtype).to(f32).transpose(-1, -2), dof)
    return dq, dk, dv


# ----------------------------------------------------------------- wrappers

def tile_check(a, b):
    """One product of each kind that the bf16 kernels' tensor-core tile
    layer makes (``flash_tile_check_kernel``): (ss [64, 64] = a b^T,
    rs [64, 128] = a[:, :64] b), f32, for a and b contiguous bf16
    [64, 128] on the card. Not a launch of the forward, so not counted."""
    from deeplearning4j_tpu_torch.ops.cuda.build import check_status

    for t in (a, b):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (64, 128)
                or not t.is_cuda or not t.is_contiguous()):
            raise ValueError("tile_check takes contiguous bf16 [64, 128] "
                             "tensors on the card")
    ss = a.new_empty((64, 64), dtype=torch.float32)
    rs = a.new_empty((64, 128), dtype=torch.float32)
    lib = FLASH_FWD.library.load(a.device)
    with torch.cuda.device(a.device):
        check_status(lib, lib.dl4j_flash_tile_check(
            pointer(a), pointer(b), pointer(ss), pointer(rs),
            torch.cuda.current_stream().cuda_stream), "dl4j_flash_tile_check")
    return ss, rs


def _check(what, q, k, v, kmask, rows=()):
    """Device, type, shape and contiguity of a kernel call's tensors; returns
    (B, N, Tq, Tk, D). ``rows`` are extra [B, N, Tq, ...] tensors of q's
    type (do)."""
    if q.dtype not in _FWD_SYMBOLS:
        raise TypeError(f"{what}: the tensors are {q.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B, N, Tq, D], got "
                         f"{list(q.shape)}")
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} > {MAX_HEAD_DIM}, the "
                         "kernel's limit")
    want = {"k": (k, (B, N, Tk, D)), "v": (v, (B, N, Tk, D)),
            **{name: (t, (B, N, Tq, D)) for name, t in rows}}
    for name, (t, shape) in {"q": (q, (B, N, Tq, D)), **want}.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}; the "
                            f"kernel takes one type ({q.dtype} on {q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if kmask is not None:
        _check_f32(what, "kmask", kmask, (B, Tk), q.device)
    return B, N, Tq, Tk, D


def _check_f32(what, name, t, shape, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous float32 "
                         f"{list(shape)} on {device}, got {t.dtype} "
                         f"{list(t.shape)} on {t.device}")


def _cuda_only(what, t):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def flash_forward(q, k, v, *, scale, causal=False, kmask=None):
    """(o [B, N, Tq, D] in q's type, lse [B, N, Tq, 1] f32). q, k, v
    contiguous, one type; ``kmask`` None or contiguous f32 [B, Tk].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, scale=scale, causal=causal,
                                   kmask=kmask)
    _cuda_only("flash_forward", q)
    B, N, Tq, Tk, D = _check("flash_forward", q, k, v, kmask)
    o = torch.empty_like(q)
    lse = q.new_empty((B, N, Tq, 1), dtype=torch.float32)
    if q.numel() == 0:
        return o, lse
    if Tk == 0:  # no key at all: every row is fully masked
        return o.zero_(), lse.fill_(math.inf)
    launch(FLASH_FWD, _FWD_SYMBOLS[q.dtype], q.device, (
        pointer(q), pointer(k), pointer(v), pointer(kmask), pointer(o),
        pointer(lse), B * N, N, Tq, Tk, D, float(scale), int(bool(causal))))
    return o, lse


def flash_backward(q, k, v, do, lse, delta, *, scale, causal=False,
                   kmask=None):
    """(dq, dk, dv), f32, from ``lse`` and ``delta = rowsum(do * o)``
    ([B, N, Tq, 1] f32 each, contiguous). Launches the dq kernel, then the
    dk/dv kernel.

    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, do, lse, delta, scale=scale,
                                    causal=causal, kmask=kmask)
    _cuda_only("flash_backward", q)
    B, N, Tq, Tk, D = _check("flash_backward", q, k, v, kmask,
                             rows=(("do", do),))
    for name, t in (("lse", lse), ("delta", delta)):
        _check_f32("flash_backward", name, t, (B, N, Tq, 1), q.device)
    f32 = dict(dtype=torch.float32)
    dq = q.new_empty((B, N, Tq, D), **f32)
    dk = q.new_empty((B, N, Tk, D), **f32)
    dv = q.new_empty((B, N, Tk, D), **f32)
    if q.numel() == 0 or Tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    common = (B * N, N, Tq, Tk, D, float(scale), int(bool(causal)))
    ins = (pointer(q), pointer(k), pointer(v), pointer(do), pointer(lse),
           pointer(delta), pointer(kmask))
    launch(FLASH_DQ, _DQ_SYMBOLS[q.dtype], q.device,
           ins + (pointer(dq),) + common)
    launch(FLASH_DKV, _DKV_SYMBOLS[q.dtype], q.device,
           ins + (pointer(dk), pointer(dv)) + common)
    return dq, dk, dv


def flash_block_fwd(q, k, v, *, causal, scale, kmask=None):
    """(o, lse) for one attention block pair, lse [B, N, Tq, 1] f32: the
    block primitive ring attention merges online (``flash_block_fwd`` of
    the JAX package, without its TPU tile sizes)."""
    return flash_forward(q, k, v, scale=scale, causal=causal, kmask=kmask)


def flash_block_bwd(q, k, v, do, lse, delta, *, causal, scale, kmask=None):
    """(dq, dk, dv) f32 given the (possibly global) ``lse`` and
    ``delta = rowsum(do * o)``."""
    return flash_backward(q, k, v, do, lse, delta, scale=scale,
                          causal=causal, kmask=kmask)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention, differentiable: the forward kernel, whose o and lse
    are saved with q, k, v and the key mask, and the two backward kernels.
    The gradients come out of the kernels in f32 and are cast to the inputs'
    types (``_flash_bwd``). CPU tensors take the plain versions, so the CPU
    tests run the same assembly code as the card."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal, scale):
        o, lse = flash_forward(q, k, v, scale=scale, causal=causal,
                               kmask=kmask)
        ctx.save_for_backward(q, k, v, o, lse, kmask)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, kmask = ctx.saved_tensors
        f32 = torch.float32
        delta = (g.to(f32) * o.to(f32)).sum(-1, keepdim=True)
        dq, dk, dv = flash_backward(
            q, k, v, g.to(q.dtype).contiguous(), lse, delta,
            scale=ctx.scale, causal=ctx.causal, kmask=kmask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


# ----------------------------------------------------------- op-level entry

def as_key_padding(mask, batch, seq_k):
    """A mask broadcastable to [B, N, Tq, Tk] as a contiguous f32 [B, Tk]
    key-padding mask, or None; raises for a mask that is not one
    (``_as_key_padding``)."""
    if mask is None:
        return None
    m = torch.as_tensor(mask)
    if m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1:
        m = m[:, 0, 0, :]
    elif m.dim() != 2:
        raise ValueError(
            f"flash_attention supports key-padding masks ([B, Tk] or "
            f"[B, 1, 1, Tk]); got mask shape {tuple(m.shape)}")
    if m.shape[-1] != seq_k:
        raise ValueError(f"mask key axis {m.shape[-1]} != Tk {seq_k}")
    return m.to(torch.float32).expand(batch, seq_k).contiguous()


def is_key_padding(mask, q, k) -> bool:
    """Does ``mask`` reduce to a [B, Tk] key-padding mask
    (``_is_key_padding``)."""
    if mask is None:
        return True
    shp = tuple(mask.shape)
    if len(shp) == 4:
        return (shp[1] == 1 and shp[2] == 1 and shp[3] == k.shape[-2]
                and shp[0] in (1, q.shape[0]))
    return (len(shp) == 2 and shp[1] == k.shape[-2]
            and shp[0] in (1, q.shape[0]))


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, mask=None, bias=None, scale=None,
                    causal=False):
    """Kernel implementation of ``dot_product_attention`` (same signature).

    ``mask`` must reduce to key padding ([B, Tk] or [B, 1, 1, Tk]); ``bias``
    is refused. When autograd will need the gradients (grad mode on and an
    input requires grad), the call goes through
    :class:`FlashAttentionFunction`; otherwise the forward kernel runs alone
    and nothing is saved. The choice is made on every call."""
    if bias is not None:
        raise ValueError("flash_attention does not support additive logit "
                         "biases; the registry sends them to the plain "
                         "lowering")
    km = as_key_padding(mask, q.shape[0], k.shape[-2])
    if km is not None:
        km = km.to(q.device)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad((q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, km, bool(causal), scale)
    return flash_forward(q, k, v, scale=scale, causal=causal, kmask=km)[0]


def flash_requires(q, k, v, *, mask=None, scale=None, causal=False, **kw):
    """Structural (``_flash_requires``): no bias, a mask that reduces to
    key padding, causal only when Tq == Tk (the kernels are start-aligned,
    the plain lowering end-aligned), and a head dim of at most 128."""
    return (kw.get("bias") is None
            and is_key_padding(mask, q, k)
            and (not causal or q.shape[-2] == k.shape[-2])
            and q.shape[-1] <= MAX_HEAD_DIM)


def kernel_admits(q, k, v, *, mask=None, **kw):
    """What the kernels can compute, from shapes and dtypes alone:
    :func:`flash_requires`, and q, k and v of one type that a kernel takes
    (f32 or bf16). Anything else (f16, f64, mixed types) goes to the plain
    lowering, as the JAX package sends it to XLA."""
    return (q.dtype in _FWD_SYMBOLS and k.dtype == q.dtype
            and v.dtype == q.dtype
            and flash_requires(q, k, v, mask=mask, **kw))


def _cuda_requires(q, k, v, *, mask=None, **kw):
    """Every tensor on the card, and :func:`kernel_admits`. A call it admits
    launches the kernels or raises."""
    on_card = all(t.is_cuda for t in (q, k, v)) and (
        not isinstance(mask, torch.Tensor) or mask.is_cuda)
    return on_card and kernel_admits(q, k, v, mask=mask, **kw)


register_impl("dot_product_attention", platform="cuda",
              requires=_cuda_requires, priority=1)(flash_attention)
