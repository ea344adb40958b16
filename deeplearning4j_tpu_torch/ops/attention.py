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
registry (so the kernel is reachable) and merges. The decode op
``cached_dot_product_attention`` comes with the decode slice.

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
