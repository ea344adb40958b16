"""Attention ops: the plain PyTorch lowerings.

Counterpart of ``deeplearning4j_tpu/ops/attention.py:22-47,93-112``.
``dot_product_attention`` keeps the XLA lowering's semantics: scale
``1/sqrt(d)`` computed in the input's dtype, an optional additive ``bias``,
an end-aligned causal mask ``tril(k=tk-tq)``, and masked logits filled with
``finfo.min`` (not -inf), so a row whose keys are all masked returns the
mean of v. The flash-attention kernels (``ops/cuda/flash_attention.py``)
register over the same name; they return 0 for such a row, as the JAX
package's Pallas kernel does.

``multi_head_attention`` projects, splits heads, attends through the
registry (so the kernel is reachable) and merges.
``cached_dot_product_attention`` is the single-query decode step over a
KV ring (``ops/attention.py:50-84`` of the JAX package). It has a plain
lowering only, as in the JAX package: no kernel registers over it.

Layouts: q/k/v [B, N, T, Dh] (batch, heads, time, head dim); W* [in, out].
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import op, register_op


def default_scale(d: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(d)`` rounded through ``dtype``, as the XLA lowering forms
    it (``1.0 / jnp.sqrt(jnp.asarray(d, q.dtype))``)."""
    return float(torch.tensor(float(d), dtype=dtype).sqrt().reciprocal())


@register_op("dot_product_attention")
def dot_product_attention(q, k, v, *, mask=None, bias=None, scale=None,
                          causal=False):
    """softmax(q k^T * scale + bias) v.

    mask: broadcastable to [B, N, Tq, Tk], nonzero = keep. bias:
    broadcastable to [B, N, Tq, Tk], added to the scaled logits."""
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    logits = torch.einsum("bntd,bnsd->bnts", q, k) * scale
    if bias is not None:
        logits = logits + bias
    neg = torch.finfo(logits.dtype).min
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = logits.masked_fill(~cm, neg)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(torch.bool), neg)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bnts,bnsd->bntd", w, v)


@register_op("cached_dot_product_attention")
def cached_dot_product_attention(q, k_cache, v_cache, pos, *, scale=None,
                                 k_scale=None, v_scale=None):
    """Single-query decode attention over a KV ring buffer.

    q [B, N, 1, Dh]; k_cache/v_cache [B, N, L, Dh]; pos [B], the absolute
    position of the query token (its k/v already written at ``pos % L``).
    Ring index c is valid where c <= pos, or everywhere once pos >= L (the
    ring then holds the L most recent positions; the positional signal was
    added at the embedding, so their order does not matter).

    Int8 rings pass per-(row, head) scales ``k_scale`` / ``v_scale`` [B, N]:
    a scale is constant over the ring axis and the head dim, so it
    commutes out of both contractions and multiplies the logits and the
    output, and the dequantized ring is never formed. Every operation
    runs on the device, with no host sync, so a CUDA graph can hold it."""
    L = k_cache.shape[2]
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    logits = torch.einsum("bntd,bnsd->bnts", q, k_cache.to(q.dtype)) * scale
    if k_scale is not None:
        logits = logits * k_scale.to(q.dtype)[:, :, None, None]
    c = torch.arange(L, device=pos.device)
    valid = (c[None, :] <= pos[:, None]) | (pos[:, None] >= L)
    logits = logits.masked_fill(~valid[:, None, None, :],
                                torch.finfo(logits.dtype).min)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bnsd->bntd", w, v_cache.to(q.dtype))
    if v_scale is not None:
        out = out * v_scale.to(q.dtype)[:, :, None, None]
    return out


@register_op("multi_head_attention")
def multi_head_attention(x_q, x_kv, Wq, Wk, Wv, Wo, *, n_heads, mask=None,
                         causal=False, bq=None, bk=None, bv=None, bo=None):
    """Full MHA: project, attend, merge. x [B, T, F]; W* [F, D];
    Wo [D, F_out]."""
    B, Tq, _ = x_q.shape
    Tk = x_kv.shape[1]
    q = x_q @ Wq if bq is None else x_q @ Wq + bq
    k = x_kv @ Wk if bk is None else x_kv @ Wk + bk
    v = x_kv @ Wv if bv is None else x_kv @ Wv + bv
    Dh = q.shape[-1] // n_heads

    def split(t, T):
        return t.reshape(B, T, n_heads, Dh).transpose(1, 2)

    # through the registry so the flash kernels are reachable; their
    # `requires` sends biased and general-mask calls to the plain lowering
    o = op("dot_product_attention")(split(q, Tq), split(k, Tk), split(v, Tk),
                                    mask=mask, causal=causal)
    o = o.transpose(1, 2).reshape(B, Tq, n_heads * Dh)
    return o @ Wo if bo is None else o @ Wo + bo
