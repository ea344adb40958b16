"""GloVe — global word-vector training on co-occurrence statistics.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py``. The co-occurrence table
is built host-side once (the JAX package's code and order); the weighted
least-squares objective is minimized with full-batch AdaGrad steps over
the flattened co-occurrence entries, on the model's device (the card
unless the caller passes ``device="cpu"``). ``_glove_step`` computes the
gradients explicitly and scatters them with ``index_add_``: a row no entry
touches keeps its bits, as under the JAX package's dense update.

Reference analog: org.deeplearning4j.models.glove.Glove (+ builder).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.tokenizers import (
    CommonPreprocessor, DefaultTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, cosine_similarity
from deeplearning4j_tpu_torch.nlp.word2vec import _adagrad, _scatter


def _glove_step(params, rows, cols, logx, weight, lr):
    """AdaGrad step on J = sum f(X_ij) (w_i.c_j + b_i + bc_j - log X_ij)^2.
    ``params`` holds W, C, bw, bc and their ``acc_`` accumulators; it is
    updated in place and returned with the loss."""
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    W, C, bw, bc = (params[k] for k in ("W", "C", "bw", "bc"))
    wr, cc = W[rows], C[cols]
    diff = (wr * cc).sum(1) + bw[rows] + bc[cols] - logx
    loss = (weight * diff ** 2).sum()
    g = 2.0 * weight * diff
    grads = {"W": _scatter(W, rows, g[:, None] * cc),
             "C": _scatter(C, cols, g[:, None] * wr),
             "bw": _scatter(bw, rows, g), "bc": _scatter(bc, cols, g)}
    for k, grad in grads.items():
        _adagrad(params[k], params["acc_" + k], grad, lr)
    return params, loss


class Glove:
    def __init__(self, vector_size: int = 100, window: int = 5,
                 min_count: int = 1, epochs: int = 25, learning_rate: float = 0.05,
                 x_max: float = 100.0, alpha: float = 0.75, seed: int = 42,
                 device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self.vector_size = vector_size
        self.window = window
        self.epochs = epochs
        self.lr = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.seed = seed
        self.vocab = VocabCache(min_count=min_count)
        self.tokenizer = DefaultTokenizerFactory(CommonPreprocessor())
        self.W: Optional[np.ndarray] = None
        self.train_state: dict = {}           # see nlp.load_jax_state

    def _cooccurrences(self, encoded):
        cooc: Counter = Counter()
        for sent in encoded:
            n = len(sent)
            for i in range(n):
                for j in range(max(0, i - self.window), min(n, i + self.window + 1)):
                    if i == j:
                        continue
                    cooc[(int(sent[i]), int(sent[j]))] += 1.0 / abs(i - j)
        return cooc

    def fit(self, corpus) -> "Glove":
        if isinstance(corpus, str):
            corpus = corpus.splitlines()
        sents = [self.tokenizer.tokenize(l) if isinstance(l, str) else l
                 for l in corpus]
        self.vocab.fit(sents)
        V, D = len(self.vocab), self.vector_size
        rng = np.random.default_rng(self.seed)
        encoded = [self.vocab.encode(s) for s in sents]
        cooc = self._cooccurrences(encoded)
        if not cooc:
            raise ValueError("no co-occurrences (corpus too small?)")
        rows = np.asarray([k[0] for k in cooc], np.int32)
        cols = np.asarray([k[1] for k in cooc], np.int32)
        x = np.asarray(list(cooc.values()), np.float32)
        logx = np.log(x)
        weight = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(np.float32)

        dev = self.device
        params = {
            "W": (rng.random((V, D), np.float32) - 0.5) / D,
            "C": (rng.random((V, D), np.float32) - 0.5) / D,
            "bw": np.zeros(V, np.float32), "bc": np.zeros(V, np.float32),
        }
        params = {k: torch.tensor(v, device=dev) for k, v in params.items()}
        for k in ("W", "C", "bw", "bc"):
            params["acc_" + k] = torch.zeros_like(params[k])
        r, c, lx, wt = (torch.tensor(a, device=dev)
                        for a in (rows, cols, logx, weight))
        for _ in range(self.epochs):
            params, _ = _glove_step(params, r, c, lx, wt, lr=self.lr)
        self.W = (params["W"] + params["C"]).cpu().numpy()  # GloVe sums
        return self

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.W[i]

    def similarity(self, a: str, b: str) -> float:
        return cosine_similarity(self.get_word_vector(a), self.get_word_vector(b))

    def words_nearest(self, word=None, top: int = 10, positive=None,
                      negative=None):
        """wordsNearest over the summed W+C GloVe vectors (single-word and
        analogy forms, shared engine with Word2Vec)."""
        from deeplearning4j_tpu_torch.nlp.vocab import nearest_neighbors

        return nearest_neighbors(self.vocab.words, self.vocab.index, self.W,
                                 word=word, top=top, positive=positive,
                                 negative=negative)
