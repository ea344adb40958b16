"""k-d tree.

Counterpart of ``deeplearning4j_tpu/neighbors/kdtree.py``, copied (host
numpy, no framework).

Reference analog: org.deeplearning4j.clustering.kdtree.KDTree (insert/
nearest/knn over axis-aligned splits, euclidean metric).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index, axis, left=None, right=None):
        self.index = index
        self.axis = axis
        self.left = left
        self.right = right


class KDTree:
    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        self.root = self._build(list(range(len(self.points))), 0)

    def _build(self, idx: List[int], depth: int) -> Optional[_KDNode]:
        if not idx:
            return None
        axis = depth % self.dims
        idx = sorted(idx, key=lambda i: self.points[i, axis])
        mid = len(idx) // 2
        return _KDNode(idx[mid], axis,
                       self._build(idx[:mid], depth + 1),
                       self._build(idx[mid + 1:], depth + 1))

    def nearest(self, query: np.ndarray) -> Tuple[int, float]:
        idx, dist = self.knn(query, 1)
        return idx[0], dist[0]

    def knn(self, query: np.ndarray, k: int = 1) -> Tuple[List[int], List[float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def search(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = query[node.axis] - self.points[node.index, node.axis]
            near, far = (node.left, node.right) if diff <= 0 else (node.right, node.left)
            search(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                search(far)

        search(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in out], [d for d, _ in out]
