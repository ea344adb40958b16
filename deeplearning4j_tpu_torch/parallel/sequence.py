"""Sequence / context parallelism: ring, zig-zag and Ulysses attention.

Counterpart of ``deeplearning4j_tpu/parallel/sequence.py``. The sequence
axis is split over a mesh axis ("seq"): each rank holds a query block and
the K/V blocks travel the ring (``collectives.rotate``) while attention
accumulates online, so a rank holds O(T/n) keys. The JAX functions take the
global arrays and let ``shard_map`` split them; so do these (each rank
passes the same tensors, takes its slice with ``collectives.shard`` and
gathers the result), and ``local=True`` takes and returns this rank's
slices instead.

Two local cores for the contiguous ring:

- the flash core (:class:`_RingFlash`): each ring step runs the flash
  forward kernel on the block it holds (:func:`ring_flash_fwd_step`, through
  ``flash_block_fwd``) and merges (o, lse) pairs (:func:`merge_lse`); the
  backward re-rotates K/V with each block's dk/dv partial travelling with
  it and taking one last hop home (:func:`ring_flash_bwd_step`, through
  ``flash_block_bwd`` with the ring's global lse and ``delta`` of the
  merged o). A causal ring launches nothing for a block from a later rank.
  Each step is a function of what the rank holds at that step, so
  :func:`replay_ring_flash` replays every rank of a ring on one device;
- the einsum core (:func:`_einsum_ring_local`): plain PyTorch with the
  local [Tq, Tk] tile each step, differentiated through the rotations.

``impl=None`` picks the flash core for CUDA tensors the flash kernels admit
(``ops/cuda/flash_attention.py`` ``kernel_admits``: head dim <= 128, q, k,
v of one type, f32 or bf16), the einsum core otherwise; ``impl="flash"``
raises for a block the kernels cannot take (on CPU tensors it runs the
kernels' plain versions). The JAX guard (head dim % 128, T_local % 8) is a
TPU tiling rule and is not carried.

Also: Ulysses attention (all-to-all from sequence to heads, the
full-sequence attention op on the local heads, and back), the
sequence-parallel encoder block, and the load-balanced causal zig-zag ring.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.layers.norm import layer_norm
from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
    flash_block_bwd, flash_block_fwd, kernel_admits,
)
from deeplearning4j_tpu_torch.parallel.collectives import (
    all_gather, all_to_all, axis_group, replicate_grad, rotate, shard,
)

_NEG = torch.finfo(torch.float32).min


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _key_mask(mask, q, k):
    """A [B, T] key-padding mask as contiguous f32 on q's device."""
    if mask is None:
        return None
    m = torch.as_tensor(mask)
    if tuple(m.shape) != (q.shape[0], k.shape[2]):
        raise ValueError(f"ring_attention mask must be a key-padding mask "
                         f"[B, T] = {(q.shape[0], k.shape[2])}; got "
                         f"{tuple(m.shape)}")
    return m.to(device=q.device, dtype=torch.float32).contiguous()


def _rotate_all(group, *ts):
    """Rotate the non-None tensors one hop, those of one shape and type
    as one message (K with V, dk with dv)."""
    out = list(ts)
    kinds: dict = {}
    for i, t in enumerate(ts):
        if t is not None:
            kinds.setdefault((t.dtype, tuple(t.shape)), []).append(i)
    for idx in kinds.values():
        if len(idx) == 1:
            out[idx[0]] = rotate(ts[idx[0]], group)
        else:
            moved = rotate(torch.stack([ts[i] for i in idx]), group)
            for i, m in zip(idx, moved.unbind(0)):
                out[i] = m
    return tuple(out)


# ------------------------------------------------------------ einsum core

def _einsum_ring_local(q, k, v, kmask, group, causal, scale):
    """The plain ring over this rank's blocks q/k/v [B, H, T_l, D] and key
    mask shard [B, T_l]; masked logits take float32's min, so a row whose
    keys are all masked attends uniformly (the XLA lowering's rows)."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    q32 = q.float() * scale
    m = q.new_full((B, H, Tq, 1), _NEG, dtype=torch.float32)
    l = q.new_zeros((B, H, Tq, 1), dtype=torch.float32)
    o = q.new_zeros((B, H, Tq, D), dtype=torch.float32)
    qpos = my * Tq + torch.arange(Tq, device=q.device)
    for i in range(n):
        src = (my - i) % n
        logits = torch.einsum("bhqd,bhkd->bhqk", q32, k.float())
        if causal:
            kpos = src * Tk + torch.arange(Tk, device=q.device)
            logits = torch.where(qpos[:, None] >= kpos[None, :], logits,
                                 _NEG)
        if kmask is not None:
            logits = torch.where(kmask[:, None, None, :] > 0, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
        m = m_new
        if i < n - 1:
            k, v, kmask = _rotate_all(group, k, v, kmask)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


# ------------------------------------------------------------- flash core

def merge_lse(o, lse, o_i, lse_i):
    """Two softmax partial results, each normalized by its own lse, as one
    (o f32, lse). The forward kernel's lse = +inf of a row that saw no key
    means "contributes nothing" here, not the logaddexp poison it would
    be (``_merge_lse``)."""
    inf = torch.full_like(lse, math.inf)
    lse = torch.where(torch.isposinf(lse), -inf, lse)
    lse_i = torch.where(torch.isposinf(lse_i), -inf, lse_i)
    lse_new = torch.logaddexp(lse, lse_i)
    zero = torch.zeros_like(lse)
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - lse_new), zero)
    w_new = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - lse_new),
                        zero)
    return o * w_old + o_i.float() * w_new, lse_new


def _skipped(step, rank, size, causal) -> bool:
    """A causal ring's step whose block comes from a later rank sees no
    key: nothing is launched for it (JAX's ``lax.cond``)."""
    return causal and (rank - step) % size > rank


def ring_flash_fwd_step(q, k, v, kmask, o, lse, *, step, rank, size, causal,
                        scale):
    """Rank ``rank``'s ``step`` of the flash ring's forward: the block it
    holds (K/V and key-mask shard of rank ``(rank - step) % size``) through
    the forward kernel, merged into the running (o f32, lse). Step 0 is
    the diagonal block, where the kernel's start-aligned causal mask is
    exact; a later block is either all visible or skipped."""
    if _skipped(step, rank, size, causal):
        return o, lse
    o_i, lse_i = flash_block_fwd(q, k, v, causal=causal and step == 0,
                                 scale=scale, kmask=kmask)
    return merge_lse(o, lse, o_i, lse_i)


def ring_flash_bwd_step(q, k, v, kmask, do, lse, delta, dq, dk, dv, *, step,
                        rank, size, causal, scale):
    """Rank ``rank``'s ``step`` of the ring's backward: the two backward
    kernels on the block it holds, from the ring's global ``lse`` and
    ``delta = rowsum(do * o)`` of the merged o; returns (dq, and the dk / dv
    carries travelling with the block) with this step's partials added."""
    if _skipped(step, rank, size, causal):
        return dq, dk, dv
    dq_i, dk_i, dv_i = flash_block_bwd(q, k, v, do, lse, delta,
                                       causal=causal and step == 0,
                                       scale=scale, kmask=kmask)
    return dq + dq_i, dk + dk_i, dv + dv_i


def _bwd_lse(lse):
    """The merged lse as the backward kernels take it: a row that saw no
    key (-inf after the merges) as +inf, so exp(s - lse) is 0 there."""
    return torch.where(torch.isneginf(lse), torch.full_like(lse, math.inf),
                       lse).contiguous()


def _delta(do, o):
    return (do.float() * o.float()).sum(-1, keepdim=True).contiguous()


class _RingFlash(torch.autograd.Function):
    """The flash ring over a group; q/k/v this rank's contiguous blocks."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, group, causal, scale):
        n, my = dist.get_world_size(group), dist.get_rank(group)
        B, H, Tq, D = q.shape
        o = q.new_zeros((B, H, Tq, D), dtype=torch.float32)
        lse = q.new_full((B, H, Tq, 1), -math.inf, dtype=torch.float32)
        kc, vc, kmc = k, v, kmask
        for i in range(n):
            o, lse = ring_flash_fwd_step(q, kc, vc, kmc, o, lse, step=i,
                                         rank=my, size=n, causal=causal,
                                         scale=scale)
            if i < n - 1:
                kc, vc, kmc = _rotate_all(group, kc, vc, kmc)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, kmask, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kmask, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.args
        n, my = dist.get_world_size(group), dist.get_rank(group)
        do = do.to(q.dtype).contiguous()
        delta, lse_b = _delta(do, out), _bwd_lse(lse)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc, kmc = k, v, kmask
        for i in range(n):
            dq, dk, dv = ring_flash_bwd_step(
                q, kc, vc, kmc, do, lse_b, delta, dq, dk, dv, step=i,
                rank=my, size=n, causal=causal, scale=scale)
            if i < n - 1:
                kc, vc, kmc = _rotate_all(group, kc, vc, kmc)
            # the carries hop every step, the last included: after n hops
            # each block's gradient is home
            dk, dv = _rotate_all(group, dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def replay_ring_flash(q, k, v, *, size, causal, scale=None, kmask=None,
                      do=None):
    """Every rank of a flash ring of ``size`` replayed on one device, step
    by step in the ring's order (at step i rank r holds block
    (r - i) % size, and each dk/dv carry sums its partials in the order the
    ring's carry does). q/k/v [B, H, T, D] global, ``kmask`` [B, T].
    Returns (o, lse), and with ``do`` (o, lse, dq, dk, dv), the gradients
    f32."""
    scale = _scale(q, scale)
    qs, ks, vs = ([t.contiguous() for t in x.chunk(size, 2)]
                  for x in (q, k, v))
    ms = ([None] * size if kmask is None
          else [m.contiguous() for m in kmask.float().chunk(size, 1)])
    B, H, Tl, D = qs[0].shape
    os_ = [q.new_zeros((B, H, Tl, D), dtype=torch.float32)
           for _ in range(size)]
    lses = [q.new_full((B, H, Tl, 1), -math.inf, dtype=torch.float32)
            for _ in range(size)]
    for i in range(size):
        for r in range(size):
            s = (r - i) % size
            os_[r], lses[r] = ring_flash_fwd_step(
                qs[r], ks[s], vs[s], ms[s], os_[r], lses[r], step=i, rank=r,
                size=size, causal=causal, scale=scale)
    outs = [o.to(q.dtype) for o in os_]
    o, lse = torch.cat(outs, 2), torch.cat(lses, 2)
    if do is None:
        return o, lse
    dos = [t.to(q.dtype).contiguous() for t in do.chunk(size, 2)]
    deltas = [_delta(d, o_r) for d, o_r in zip(dos, outs)]
    lse_bs = [_bwd_lse(x) for x in lses]
    dqs = [torch.zeros_like(x, dtype=torch.float32) for x in qs]
    dks = [torch.zeros_like(x, dtype=torch.float32) for x in ks]
    dvs = [torch.zeros_like(x, dtype=torch.float32) for x in vs]
    for i in range(size):
        for r in range(size):
            s = (r - i) % size
            dqs[r], dks[s], dvs[s] = ring_flash_bwd_step(
                qs[r], ks[s], vs[s], ms[s], dos[r], lse_bs[r], deltas[r],
                dqs[r], dks[s], dvs[s], step=i, rank=r, size=size,
                causal=causal, scale=scale)
    return (o, lse, torch.cat(dqs, 2), torch.cat(dks, 2),
            torch.cat(dvs, 2))


def _ring_local(q, k, v, kmask, group, causal, scale, flash):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if flash:
        return _RingFlash.apply(q, k, v, kmask, group, causal, scale)
    return _einsum_ring_local(q, k, v, kmask, group, causal, scale)


def _use_flash(q, k, v, impl) -> bool:
    if impl is None:
        return q.is_cuda and kernel_admits(q, k, v)
    if impl == "flash":
        if not kernel_admits(q, k, v):
            raise ValueError(
                "ring_attention(impl='flash') needs blocks the flash kernels "
                "take: head_dim <= 128 and q, k, v of one type, float32 or "
                f"bfloat16; got head_dim={q.shape[-1]}, {q.dtype}, "
                f"{k.dtype}, {v.dtype}: use impl='einsum'")
        return True
    if impl == "einsum":
        return False
    raise ValueError(f"impl must be None, 'flash' or 'einsum', got {impl!r}")


def ring_attention(q, k, v, mesh, *, axis: str = "seq", causal: bool = False,
                   scale: float | None = None, impl: str | None = None,
                   mask=None, local: bool = False):
    """Ring attention over a mesh axis.

    q/k/v: [B, H, T, D], the whole sequence on every rank (``local=True``:
    this rank's [B, H, T/n, D] slice). Returns the same. ``mask``: a [B, T]
    key-padding mask (> 0 = visible; with ``local``, this rank's [B, T/n]
    shard), whose shards travel the ring with their K/V blocks. A row whose
    keys are all masked gives zeros on the flash core and uniform attention
    on the einsum core, as in the JAX package."""
    group = axis_group(mesh, axis)
    scale = _scale(q, scale)
    flash = _use_flash(q, k, v, impl)
    kmask = _key_mask(mask, q, k)
    if not local:
        q, k, v = (shard(t, group, 2) for t in (q, k, v))
        if kmask is not None:
            kmask = shard(kmask, group, 1)
    out = _ring_local(q, k, v, kmask, group, causal, scale, flash)
    return out if local else all_gather(out, group, 2)


# ---------------------------------------------------------------- Ulysses

def _ulysses_guard(n_heads, group, axis):
    size = dist.get_world_size(group)
    if n_heads % size:
        raise ValueError(f"ulysses needs n_heads ({n_heads}) divisible by "
                         f"mesh axis '{axis}' size ({size})")


def _ulysses_local(q, k, v, group, causal, scale):
    """Sequence-split [B, H, T_l, D] to head-split [B, H_l, T, D] by
    all-to-all, the full-sequence attention op on the local heads (the
    flash kernels on the card), and back."""
    from deeplearning4j_tpu_torch.ops.registry import op

    q, k, v = (all_to_all(t, group, 1, 2).contiguous() for t in (q, k, v))
    o = op("dot_product_attention")(q, k, v, scale=scale, causal=causal)
    return all_to_all(o.to(q.dtype), group, 2, 1)


def ulysses_attention(q, k, v, mesh, *, axis: str = "seq",
                      causal: bool = False, scale: float | None = None,
                      local: bool = False):
    """Ulysses-style sequence parallelism (head all-to-all). Requires
    n_heads % axis size == 0. Inputs and output as :func:`ring_attention`'s.
    """
    group = axis_group(mesh, axis)
    _ulysses_guard(q.shape[1], group, axis)
    scale = _scale(q, scale)
    if not local:
        q, k, v = (shard(t, group, 2) for t in (q, k, v))
    out = _ulysses_local(q, k, v, group, causal, scale)
    return out if local else all_gather(out, group, 2)


# ---------------------------------------------------------------- encoder

def sequence_parallel_encoder(params, x, mesh, *, n_heads: int,
                              axis: str = "seq", causal: bool = False,
                              impl: str = "ring", activation: str = "gelu",
                              local: bool = False):
    """The pre-norm ``TransformerEncoderLayer`` forward with the activations
    split [B, T/n, D] over ``axis``: LN, the projections and the MLP are
    per token, and only the attention core communicates (``impl`` "ring",
    "ulysses", or "zigzag": the causal zig-zag ring on x already permuted by
    :func:`zigzag_shard`, the output permuted too). Takes the layer's param
    dict; x [B, T, D] (``local``: this rank's slice). The params' gradients
    sum the ranks' parts."""
    from deeplearning4j_tpu_torch.nn.layers.base import resolve_activation

    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    T = x.shape[1] * (n if local else 1)
    if impl == "ulysses":
        _ulysses_guard(n_heads, group, axis)
    elif impl == "zigzag":
        if not causal:
            raise ValueError("impl='zigzag' is the load-balanced CAUSAL "
                             "ring; use impl='ring' for non-causal")
    elif impl != "ring":
        raise ValueError(
            f"impl must be 'ring', 'zigzag' or 'ulysses', got {impl!r}")
    act = resolve_activation(activation)
    p = {k: replicate_grad(t, group) for k, t in params.items()}
    xl = x if local else shard(x, group, 1)
    B, Tl, D = xl.shape
    dh = D // n_heads
    scale = 1.0 / math.sqrt(dh)

    h = layer_norm(xl, p["ln1_g"], p["ln1_b"], 1e-5)

    def heads(w, b):
        return (h @ w + b).reshape(B, Tl, n_heads, dh).transpose(1, 2)

    q, k, v = heads(p["Wq"], p["bq"]), heads(p["Wk"], p["bk"]), heads(
        p["Wv"], p["bv"])
    if impl == "ulysses":
        a = _ulysses_local(q, k, v, group, causal, scale)
    elif impl == "zigzag":
        _zigzag_guard(T, n, q, k, v)
        a = _zigzag_local(q, k, v, group, scale)
    else:
        a = _ring_local(q, k, v, None, group, causal, scale,
                        _use_flash(q, k, v, None))
    a = a.transpose(1, 2).reshape(B, Tl, D) @ p["Wo"] + p["bo"]
    xl = xl + a
    h = layer_norm(xl, p["ln2_g"], p["ln2_b"], 1e-5)
    xl = xl + act(h @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"]
    return xl if local else all_gather(xl, group, 1)


# ------------------------------------------------------------------ zigzag
#
# With contiguous blocks a causal ring is triangular: rank n-1 attends n
# blocks while rank 0 attends one. Zig-zag sharding gives rank i the
# stripes i and 2n-1-i of 2n, so at step 0 each rank runs two diagonal
# tiles and one full tile, and at every later step exactly two full tiles:
# (b_i, a_s) always, and one of (a_i, a_s) / (b_i, b_s) by the sign of
# i - s.

def zigzag_permutation(T: int, n: int):
    """(perm, inverse): the sequence permutation placing stripes
    [i, 2n-1-i] on rank i. T must divide into 2n stripes."""
    if T % (2 * n):
        raise ValueError(f"zigzag needs T ({T}) divisible by 2*{n} stripes")
    S = T // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * S, (i + 1) * S))
        order.extend(range((2 * n - 1 - i) * S, (2 * n - i) * S))
    perm = np.asarray(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    return perm, inv


def _take(x, idx, dim):
    return x.index_select(dim, torch.as_tensor(idx, device=x.device))


def zigzag_shard(x, mesh, *, seq_axis: int, axis: str = "seq"):
    """The zig-zag stripe permutation along ``seq_axis``, applied once (2
    for q/k/v, 1 for encoder inputs: required, since a wrong axis whose
    length happens to divide would permute silently). Everything
    position-wise (LN, projections, MLP, per-token losses) runs in the
    permuted order unchanged."""
    n = dist.get_world_size(axis_group(mesh, axis))
    perm, _ = zigzag_permutation(x.shape[seq_axis], n)
    return _take(x, perm, seq_axis)


def zigzag_unshard(x, mesh, *, seq_axis: int, axis: str = "seq"):
    """Inverse of :func:`zigzag_shard`."""
    n = dist.get_world_size(axis_group(mesh, axis))
    _, inv = zigzag_permutation(x.shape[seq_axis], n)
    return _take(x, inv, seq_axis)


def _zigzag_guard(T, n, q, k, v):
    if T % (2 * n):
        raise ValueError(f"zigzag needs T ({T}) divisible by 2*{n} stripes")
    if not kernel_admits(q, k, v):
        raise ValueError(
            "zigzag ring runs on the flash core: needs head_dim <= 128 and "
            "q, k, v of one type, float32 or bfloat16")


def _halves(t):
    S = t.shape[2] // 2
    return t[:, :, :S].contiguous(), t[:, :, S:].contiguous()


def _none_pair(q):
    B, H, S, D = q.shape
    return (q.new_zeros((B, H, S, D), dtype=torch.float32),
            q.new_full((B, H, S, 1), -math.inf, dtype=torch.float32))


class _RingZigzag(torch.autograd.Function):
    """The zig-zag ring; q/k/v this rank's two stripes [B, H, 2S, D]."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n, my = dist.get_world_size(group), dist.get_rank(group)
        blk = lambda q_, k_, v_, c: flash_block_fwd(  # noqa: E731
            q_, k_, v_, causal=c, scale=scale)
        qa, qb = _halves(q)
        ka, kb = _halves(k)
        va, vb = _halves(v)
        oa, la = merge_lse(*_none_pair(qa), *blk(qa, ka, va, True))
        ob, lb = merge_lse(*_none_pair(qb), *blk(qb, kb, vb, True))
        ob, lb = merge_lse(ob, lb, *blk(qb, ka, va, False))
        kc, vc = k, v
        for t in range(1, n):
            kc, vc = _rotate_all(group, kc, vc)
            kac, kbc = _halves(kc)
            vac, vbc = _halves(vc)
            s = (my - t) % n
            ob, lb = merge_lse(ob, lb, *blk(qb, kac, vac, False))
            if my > s:
                oa, la = merge_lse(oa, la, *blk(qa, kac, vac, False))
            else:
                ob, lb = merge_lse(ob, lb, *blk(qb, kbc, vbc, False))
        out = torch.cat([oa, ob], 2).to(q.dtype)
        lse = torch.cat([la, lb], 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.args
        n, my = dist.get_world_size(group), dist.get_rank(group)
        do = do.to(q.dtype).contiguous()
        delta, lse = _delta(do, out), _bwd_lse(lse)
        qa, qb = _halves(q)
        doa, dob = _halves(do)
        la, lb = _halves(lse)
        da, db = _halves(delta)

        def blk(q_, k_, v_, do_, l_, d_, c):
            return flash_block_bwd(q_, k_, v_, do_, l_, d_, causal=c,
                                   scale=scale)

        dqa = torch.zeros(qa.shape, dtype=torch.float32, device=q.device)
        dqb = torch.zeros_like(dqa)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc = k, v
        for t in range(n):
            kac, kbc = _halves(kc)
            vac, vbc = _halves(vc)
            dka, dkb = torch.zeros_like(dqa), torch.zeros_like(dqa)
            dva, dvb = torch.zeros_like(dqa), torch.zeros_like(dqa)
            if t == 0:
                g = blk(qa, kac, vac, doa, la, da, True)
                dqa, dka, dva = dqa + g[0], dka + g[1], dva + g[2]
                g = blk(qb, kbc, vbc, dob, lb, db, True)
                dqb, dkb, dvb = dqb + g[0], dkb + g[1], dvb + g[2]
                g = blk(qb, kac, vac, dob, lb, db, False)
                dqb, dka, dva = dqb + g[0], dka + g[1], dva + g[2]
            else:
                s = (my - t) % n
                g = blk(qb, kac, vac, dob, lb, db, False)
                dqb, dka, dva = dqb + g[0], dka + g[1], dva + g[2]
                if my > s:
                    g = blk(qa, kac, vac, doa, la, da, False)
                    dqa, dka, dva = dqa + g[0], dka + g[1], dva + g[2]
                else:
                    g = blk(qb, kbc, vbc, dob, lb, db, False)
                    dqb, dkb, dvb = dqb + g[0], dkb + g[1], dvb + g[2]
            dk = dk + torch.cat([dka, dkb], 2)
            dv = dv + torch.cat([dva, dvb], 2)
            if t < n - 1:
                kc, vc = _rotate_all(group, kc, vc)
            dk, dv = _rotate_all(group, dk, dv)
        dq = torch.cat([dqa, dqb], 2)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _zigzag_local(q, k, v, group, scale):
    return _RingZigzag.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             group, scale)


def ring_attention_zigzag(q, k, v, mesh, *, axis: str = "seq",
                          scale: float | None = None,
                          pre_permuted: bool = False, local: bool = False):
    """Load-balanced CAUSAL ring attention (zig-zag stripe sharding) on the
    flash core. Takes and returns the natural sequence order, permuting
    inside; with ``pre_permuted`` the inputs come, and the output goes, in
    zig-zag order (:func:`zigzag_shard` once a run). ``local``: this
    rank's two stripes in and out. Requires T % (2 * axis size) == 0 and
    blocks the flash kernels take."""
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    T = q.shape[2] * (n if local else 1)
    _zigzag_guard(T, n, q, k, v)
    scale = _scale(q, scale)
    if local:
        return _zigzag_local(q, k, v, group, scale)
    perm, inv = zigzag_permutation(T, n)
    if not pre_permuted:
        q, k, v = (_take(t, perm, 2) for t in (q, k, v))
    q, k, v = (shard(t, group, 2) for t in (q, k, v))
    out = all_gather(_zigzag_local(q, k, v, group, scale), group, 2)
    return out if pre_permuted else _take(out, inv, 2)
