"""Brute-force k-NN on the card.

Counterpart of ``deeplearning4j_tpu/neighbors/knn.py``: one [Q, D] x [D, N]
product and a top-k, as tensor code on an explicit device. Cosine and
euclidean are one product each, computed with TF32 off. Euclidean keeps the
JAX package's formula, ``sqrt(max(qq - 2 q.p + pp, 0))``, so that
near-zero distances round alike; manhattan is the [Q, N, D] broadcast, as
in JAX. Ties rank as ``lax.top_k`` ranks them (``common/topk.py``).

Reference analog: the nearest-neighbors server's exhaustive path
(deeplearning4j-nearestneighbors-server).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.common.topk import top_k


@contextlib.contextmanager
def _full_f32_products():
    """Products in full f32 (TF32 off) for the duration, then as before."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def knn_distances(points, queries, metric: str):
    """The [Q, N] distances of ``metric`` between f32 tensors on one
    device."""
    if metric == "cosine":
        p = points / torch.clamp(torch.linalg.norm(points, dim=1,
                                                   keepdim=True), min=1e-12)
        q = queries / torch.clamp(torch.linalg.norm(queries, dim=1,
                                                    keepdim=True), min=1e-12)
        with _full_f32_products():
            d = q @ p.T
        return d.neg_().add_(1.0)
    if metric == "euclidean":
        qq = (queries * queries).sum(1, keepdim=True)
        pp = (points * points).sum(1)
        with _full_f32_products():
            d = (2.0 * queries) @ points.T
        # qq - 2 q.p + pp in the JAX package's order, in place
        return d.neg_().add_(qq).add_(pp).clamp_(min=0.0).sqrt_()
    if metric == "manhattan":
        return (queries[:, None, :] - points[None, :, :]).abs_().sum(-1)
    raise ValueError(f"unknown metric {metric}")


def knn_tensors(points, queries, k: int, metric: str = "euclidean"):
    """(indices [Q, k] int64, distances [Q, k]) for f32 tensors on one
    device, nearest first, ties in index order."""
    neg, idx = top_k(knn_distances(points, queries, metric).neg_(), k)
    return idx, neg.neg_()


def knn_search(points, queries, k: int = 1, metric: str = "euclidean",
               device: DeviceLike = None):
    """Returns (indices [Q, k], distances [Q, k]) as numpy, nearest first.

    ``points`` and ``queries`` are arrays or tensors; the search runs on
    ``device``: the card when it is None (raising without one), the CPU
    only when asked."""
    dev = resolve_device("cuda" if device is None else device)
    points = to_device(_f32(points), dev)
    queries = to_device(_f32(queries), dev)
    if queries.ndim == 1:
        queries = queries[None]
    idx, d = knn_tensors(points, queries, k, metric)
    return idx.cpu().numpy().astype(np.int32), d.cpu().numpy()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float()
    return np.asarray(a, np.float32)
