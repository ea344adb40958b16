"""DeepWalk — node embeddings from truncated random walks.

Counterpart of ``deeplearning4j_tpu/graphlearn/deepwalk.py``: the same
walks (``Graph.random_walks``, host numpy, from ``seed``) as string
sentences into the port's ``nlp.Word2Vec`` with the JAX package's
arguments (negative sampling, ``batch_size=256``), its Python front: the
seed-reproducible stream. ``device`` goes to the Word2Vec: the card when
None (raising without one), the CPU only when asked. State crosses from
the JAX package's model through ``nlp.load_jax_state`` on ``w2v``.

Reference analog: org.deeplearning4j.graph.models.deepwalk.DeepWalk —
random walks fed into skip-gram (the reference uses hierarchical softmax;
here negative sampling, the batched variant of the same objective).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.graphlearn.graph import Graph
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class DeepWalk:
    def __init__(self, vector_size: int = 64, window: int = 5,
                 walk_length: int = 20, walks_per_vertex: int = 10,
                 negative: int = 5, epochs: int = 3,
                 learning_rate: float = 0.01, seed: int = 42,
                 device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self.vector_size = vector_size
        self.window = window
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.negative = negative
        self.epochs = epochs
        self.lr = learning_rate
        self.seed = seed
        self._w2v: Optional[Word2Vec] = None
        self.n_vertices = 0

    @property
    def w2v(self) -> Optional[Word2Vec]:
        """The Word2Vec trained on the walks (None before ``fit``)."""
        return self._w2v

    def walks(self, graph: Graph):
        """The walks ``fit`` trains on, as string sentences."""
        walks = graph.random_walks(self.walk_length, self.walks_per_vertex,
                                   seed=self.seed)
        return [[str(v) for v in walk] for walk in walks]

    def fit(self, graph: Graph) -> "DeepWalk":
        sentences = self.walks(graph)
        self._w2v = Word2Vec(vector_size=self.vector_size, window=self.window,
                             negative=self.negative, epochs=self.epochs,
                             learning_rate=self.lr, batch_size=256,
                             seed=self.seed, device=self.device)
        # walks are already token lists; Word2Vec passes lists through untokenized
        self._w2v.fit(sentences)
        self.n_vertices = graph.n
        return self

    def get_vertex_vector(self, v: int) -> Optional[np.ndarray]:
        return self._w2v.get_word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._w2v.similarity(str(a), str(b))

    def vertices_nearest(self, v: int, top: int = 10):
        return [int(w) for w in self._w2v.words_nearest(str(v), top)]
