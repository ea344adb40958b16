"""Adjacency-list graph + random walks.

Counterpart of ``deeplearning4j_tpu/graphlearn/graph.py``, copied (host numpy, no
framework): the same seeds give the same draws.

Reference analog: org.deeplearning4j.graph.graph.Graph and
org.deeplearning4j.graph.iterator.RandomWalkIterator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Graph:
    def __init__(self, n_vertices: int, directed: bool = False):
        self.n = n_vertices
        self.directed = directed
        self.adj: List[List[int]] = [[] for _ in range(n_vertices)]

    @classmethod
    def from_edges(cls, edges: Sequence[Tuple[int, int]],
                   n_vertices: Optional[int] = None,
                   directed: bool = False) -> "Graph":
        n = n_vertices or (max(max(a, b) for a, b in edges) + 1)
        g = cls(n, directed)
        for a, b in edges:
            g.add_edge(a, b)
        return g

    def add_edge(self, a: int, b: int):
        self.adj[a].append(b)
        if not self.directed:
            self.adj[b].append(a)

    def degree(self, v: int) -> int:
        return len(self.adj[v])

    def random_walks(self, walk_length: int, walks_per_vertex: int = 1,
                     seed: int = 0) -> List[List[int]]:
        """Uniform random walks from every vertex
        (RandomWalkIterator semantics; walks stop early at sinks)."""
        rng = np.random.default_rng(seed)
        walks = []
        for _ in range(walks_per_vertex):
            order = rng.permutation(self.n)
            for start in order:
                walk = [int(start)]
                v = int(start)
                for _ in range(walk_length - 1):
                    nbrs = self.adj[v]
                    if not nbrs:
                        break
                    v = int(nbrs[rng.integers(len(nbrs))])
                    walk.append(v)
                walks.append(walk)
        return walks
