"""Graph (network) representation learning.

Counterpart of ``deeplearning4j_tpu/graphlearn/``, exporting its
``__all__`` whole: the graph and its random walks are host numpy, copied;
DeepWalk trains the port's ``nlp.Word2Vec`` on the walks.

Reference analog: deeplearning4j-graph — org.deeplearning4j.graph.models.
deepwalk.DeepWalk, org.deeplearning4j.graph.graph.Graph, random-walk
iterators. ("graphlearn" to avoid clashing with nn.graph, the
ComputationGraph module.)
"""

from deeplearning4j_tpu_torch.graphlearn.graph import Graph
from deeplearning4j_tpu_torch.graphlearn.deepwalk import DeepWalk

__all__ = ["Graph", "DeepWalk"]
