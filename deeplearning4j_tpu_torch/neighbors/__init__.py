"""Nearest-neighbor search.

Counterpart of ``deeplearning4j_tpu/neighbors/``: the VP tree and the k-d
tree are host numpy, copied; ``knn_search`` is the brute-force search as
tensor code on the card (one [Q, N] distance product and a top-k).

Reference analog: deeplearning4j-nearestneighbors-parent —
org.deeplearning4j.clustering.vptree.VPTree, org.deeplearning4j.clustering.
kdtree.KDTree, and the brute-force path used by the k-NN server.
"""

from deeplearning4j_tpu_torch.neighbors.vptree import VPTree
from deeplearning4j_tpu_torch.neighbors.kdtree import KDTree
from deeplearning4j_tpu_torch.neighbors.knn import knn_search

__all__ = ["VPTree", "KDTree", "knn_search"]
