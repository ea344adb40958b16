"""Visualization/embedding tools.

Counterpart of ``deeplearning4j_tpu/plot/``, exporting its ``__all__``
whole: ``BarnesHutTsne``, the exact t-SNE gradient as tensor code on the
card.

Reference analog: org.deeplearning4j.plot — BarnesHutTsne (t-SNE over a
VPTree for the Barnes-Hut approximation).
"""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne

__all__ = ["BarnesHutTsne"]
