"""Int8 KV rings for cached decode.

Counterpart of ``deeplearning4j_tpu/quantize/kvcache.py``. An int8 ring
holds each layer's K (or V) as int8 with one running absmax scale per
(batch row, head): the scale is constant over the ring axis and the head
dim, so ``cached_dot_product_attention`` applies ``k_scale`` to the logits
and ``v_scale`` to the output and never forms a dequantized ring.

The scale only grows. When a step's vector raises it, the rows already
written are requantized by the ratio ``old / new``. The JAX package skips
that pass with ``lax.cond`` when no scale grew; a data-dependent branch
needs a host sync, which a captured CUDA graph cannot hold, so here the
pass runs every step. Where no scale grew the ratio is exactly 1.0 and
``round(c * 1.0)`` returns ``c`` bit for bit, so the values are those of
the JAX package; the cost is one pass over the ring a step.

``torch.round`` and ``jnp.round`` both round half to even, so the int8
values are the JAX package's bit for bit. :func:`ring_write_quantized`
writes in place into the ring and scale it is given, so a captured graph
keeps their addresses.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp_(-127, 127).to(torch.int8)


def quantize_cache(cache: torch.Tensor, pos_axis: int = 2):
    """A filled f32/bf16 ring [B, N, L, Dh] -> (int8 ring, scale [B, N]
    f32). Used at prefill, when the whole prefix is at hand."""
    c = cache.to(torch.float32)
    absmax = c.abs().amax(dim=(pos_axis, cache.dim() - 1))
    scale = torch.clamp(absmax / 127.0, min=_EPS)
    return _to_int8(c / scale[:, :, None, None]), scale


def ring_write_quantized(cache_q: torch.Tensor, scale: torch.Tensor,
                         new: torch.Tensor, rows: torch.Tensor,
                         slot: torch.Tensor):
    """One decode step's write into an int8 ring, in place.

    cache_q [B, N, L, Dh] int8; scale [B, N] f32 (running absmax / 127);
    new [B, N, Dh], the step's K or V vectors; rows [B] batch indices;
    slot [B] ring slots (``pos % L``). Requantizes ``cache_q`` by
    ``scale / new_scale``, writes the quantized ``new`` at ``[rows, :,
    slot]``, moves ``scale`` to the new scale and returns (cache_q,
    scale)."""
    new = new.to(torch.float32)
    step_max = new.abs().amax(dim=-1)
    new_scale = torch.maximum(scale, torch.clamp(step_max / 127.0, min=_EPS))
    ratio = (scale / new_scale)[:, :, None, None]
    cache_q.copy_(_to_int8(cache_q * ratio))
    cache_q[rows, :, slot] = _to_int8(new / new_scale[:, :, None])
    scale.copy_(new_scale)
    return cache_q, scale
