"""Top-k ranked as ``lax.top_k`` ranks.

``lax.top_k`` orders floats in XLA's total order (+0.0 above -0.0, a NaN
first) and puts the lower index first among equal keys. ``torch.topk``
promises no order among ties on CUDA, so the port ranks on an integer key
with XLA's order. Shared by the SameDiff ``top_k`` op and
``neighbors.knn_search``.
"""

from __future__ import annotations

import torch

_INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32,
           torch.bfloat16: torch.int16, torch.float16: torch.int16}
_NARROW = (torch.int8, torch.int16, torch.int32, torch.uint8, torch.bool)


def total_order_key(a):
    """An integer tensor ordered as XLA orders ``a``'s floats (the sign
    bit flips the rest of a negative number's bits); ``a`` itself if it is
    not floating."""
    if not a.is_floating_point():
        return a
    it = _INT_OF[a.dtype]
    i = a.contiguous().view(it)
    bits = torch.iinfo(it).bits
    return i ^ ((i >> (bits - 1)) & torch.iinfo(it).max)


def top_k(a, k: int):
    """(values, indices) of the ``k`` largest entries of ``a``'s last axis,
    as ``lax.top_k`` returns them. A key of at most 32 bits and the index
    pack into one unique int64 (key high, reversed index low), so one
    ``torch.topk`` ranks them with no tie left; wider keys sort stably."""
    key = total_order_key(a)
    n = a.shape[-1]
    if key.dtype in _NARROW and n < 2 ** 32:
        packed = key.to(torch.int64).bitwise_left_shift_(32)
        packed.bitwise_or_((2 ** 32 - 1) - torch.arange(
            n, device=a.device, dtype=torch.int64))
        packed = torch.topk(packed, k, dim=-1, sorted=True).values
        idx = (2 ** 32 - 1) - (packed & (2 ** 32 - 1))
    else:
        idx = torch.argsort(key, dim=-1, descending=True, stable=True)[
            ..., :k]
    return torch.take_along_dim(a, idx, dim=-1), idx
