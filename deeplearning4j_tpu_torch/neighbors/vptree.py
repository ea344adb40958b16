"""Vantage-point tree.

Counterpart of ``deeplearning4j_tpu/neighbors/vptree.py``, copied (host
numpy, no framework).

Reference analog: org.deeplearning4j.clustering.vptree.VPTree — metric-tree
k-NN used by BarnesHutTsne and the nearest-neighbors server. Host-side numpy
(tree search is pointer-chasing, not MXU work); distance options match the
reference ("euclidean", "cosine", "manhattan").
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

# "cosine" is accepted but handled by normalizing + euclidean search in the
# constructor (cosine itself breaks the triangle inequality VP pruning needs)
_DISTANCES = {
    "euclidean": lambda a, b: np.linalg.norm(a - b, axis=-1),
    "manhattan": lambda a, b: np.abs(a - b).sum(axis=-1),
    "cosine": None,
}


class _Node:
    __slots__ = ("index", "radius", "inside", "outside")

    def __init__(self, index, radius=0.0, inside=None, outside=None):
        self.index = index
        self.radius = radius
        self.inside = inside
        self.outside = outside


class VPTree:
    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 seed: int = 0):
        self.points = np.asarray(points, np.float64)
        if distance not in _DISTANCES:
            raise ValueError(f"unknown distance {distance}")
        self.distance_name = distance
        # cosine distance breaks the triangle inequality VP pruning relies
        # on; search in euclidean space over normalized vectors instead
        # (||a-b||^2 = 2(1 - cos)) and convert distances back on return.
        if distance == "cosine":
            norms = np.maximum(np.linalg.norm(self.points, axis=1,
                                              keepdims=True), 1e-12)
            self.points = self.points / norms
            self._dist = _DISTANCES["euclidean"]
        else:
            self._dist = _DISTANCES[distance]
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.points))))

    def _build(self, idx: List[int]) -> Optional[_Node]:
        if not idx:
            return None
        if len(idx) == 1:
            return _Node(idx[0])
        vp = idx[self._rng.integers(len(idx))]
        rest = [i for i in idx if i != vp]
        d = self._dist(self.points[rest], self.points[vp])
        median = float(np.median(d))
        inside = [i for i, di in zip(rest, d) if di <= median]
        outside = [i for i, di in zip(rest, d) if di > median]
        return _Node(vp, median, self._build(inside), self._build(outside))

    def knn(self, query: np.ndarray, k: int = 1) -> Tuple[List[int], List[float]]:
        """k nearest neighbors: (indices, distances), nearest first
        (VPTree.search analog)."""
        query = np.asarray(query, np.float64)
        if self.distance_name == "cosine":
            query = query / max(np.linalg.norm(query), 1e-12)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        tau = [np.inf]

        def search(node: Optional[_Node]):
            if node is None:
                return
            d = float(self._dist(self.points[node.index], query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.radius:
                search(node.inside)
                if d + tau[0] > node.radius:
                    search(node.outside)
            else:
                search(node.outside)
                if d - tau[0] <= node.radius:
                    search(node.inside)

        search(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        if self.distance_name == "cosine":
            return [i for _, i in out], [d * d / 2.0 for d, _ in out]
        return [i for _, i in out], [d for d, _ in out]
