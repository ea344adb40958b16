"""ParagraphVectors (doc2vec).

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``: PV-DM
document embeddings with Word2Vec-style negative sampling. Examples and
negatives are drawn on the host in the JAX package's order; ``_pvdm_step``
computes its gradients explicitly and scatters them with ``index_add_``
on the model's device (the card unless the caller passes
``device="cpu"``).

Reference analog: org.deeplearning4j.models.paragraphvectors.ParagraphVectors
— PV-DM document embeddings trained jointly with word vectors, plus
inferVector for unseen documents.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.nlp.tokenizers import (
    CommonPreprocessor, DefaultTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    NegativeSampler, VocabCache, cosine_similarity,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (
    _ids, _neg_sampling_grads, _scatter, cbow_windows,
)


def _pvdm_step(Dv, W, C, doc_ids, ctx, center, negatives, lr,
               train_words=True):
    """PV-DM: (doc vector + context mean)/2 predicts the center word.
    Updates Dv, C (and W when ``train_words``) in place."""
    doc, ctx = _ids(doc_ids), _ids(ctx)
    h = (Dv[doc] + W[ctx].mean(dim=1)) / 2.0
    loss, gh, gC = _neg_sampling_grads(h, C, _ids(center), _ids(negatives))
    gh = gh / 2.0
    Dv.add_(_scatter(Dv, doc, gh), alpha=-lr)
    if train_words:
        n = ctx.shape[1]
        W.add_(_scatter(W, ctx, (gh / n).unsqueeze(1).expand(-1, n, -1)),
               alpha=-lr)
    C.add_(gC, alpha=-lr)
    return Dv, W, C, loss


class ParagraphVectors:
    """PV-DM doc embeddings with Word2Vec-style negative sampling."""

    def __init__(self, vector_size: int = 100, window: int = 4,
                 min_count: int = 1, negative: int = 5, epochs: int = 5,
                 learning_rate: float = 0.05, batch_size: int = 512,
                 seed: int = 42, device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self.vector_size = vector_size
        self.window = window
        self.negative = negative
        self.epochs = epochs
        self.lr = learning_rate
        self.batch_size = batch_size
        self.seed = seed
        self.vocab = VocabCache(min_count=min_count)
        self.tokenizer = DefaultTokenizerFactory(CommonPreprocessor())
        self.doc_vectors: Optional[np.ndarray] = None
        self.labels: List[str] = []
        self.W: Optional[np.ndarray] = None
        self.C: Optional[np.ndarray] = None
        self.train_state: dict = {}           # see nlp.load_jax_state

    def _examples(self, encoded):
        docs, all_centers, all_ctxs = [], [], []
        for d, sent in enumerate(encoded):
            centers, ctxs = cbow_windows([sent], self.window)
            docs.extend([d] * len(centers))
            all_centers.append(centers)
            all_ctxs.append(ctxs)
        centers = (np.concatenate(all_centers) if all_centers
                   else np.zeros(0, np.int32))
        ctxs = (np.concatenate(all_ctxs) if all_ctxs
                else np.zeros((0, 2 * self.window), np.int32))
        return (np.asarray(docs, np.int32), ctxs.astype(np.int32),
                centers.astype(np.int32))

    def fit(self, documents: Sequence[str], labels: Optional[Sequence[str]] = None
            ) -> "ParagraphVectors":
        rng = np.random.default_rng(self.seed)
        documents = list(documents)
        # label-aware document streams (nlp.corpus.FileLabelAwareIterator /
        # LabelledDocument) carry their own labels
        if documents and hasattr(documents[0], "content"):
            if labels is None:
                labels = [d.label for d in documents]
            documents = [d.content for d in documents]
        sents = [self.tokenizer.tokenize(d) for d in documents]
        self.labels = list(labels) if labels is not None else [
            f"DOC_{i}" for i in range(len(documents))]
        self.vocab.fit(sents)
        V, D, N = len(self.vocab), self.vector_size, len(documents)
        encoded = [self.vocab.encode(s) for s in sents]
        sampler = NegativeSampler(self.vocab.unigram_table_probs())

        dev = self.device
        Dv = torch.tensor((rng.random((N, D), np.float32) - 0.5) / D,
                          device=dev)
        W = torch.tensor((rng.random((V, D), np.float32) - 0.5) / D,
                         device=dev)
        C = torch.zeros((V, D), dtype=torch.float32, device=dev)
        docs, ctxs, centers = self._examples(encoded)
        if len(docs) == 0:
            raise ValueError("no context windows — every document is empty "
                             "or a single token after tokenization")
        docs_d, ctxs_d, centers_d = (_ids(to_device(a, dev))
                                     for a in (docs, ctxs, centers))
        for _ in range(self.epochs):
            order = rng.permutation(len(docs))
            B = min(self.batch_size, len(docs))
            nb = len(docs) // B
            negs = np.stack([sampler.sample(rng, (B, self.negative))
                             for _ in range(nb)])
            order_d = to_device(order[:nb * B].astype(np.int64), dev)
            negs_d = to_device(negs, dev)
            for i in range(nb):
                sl = order_d[i * B:(i + 1) * B]
                Dv, W, C, _ = _pvdm_step(Dv, W, C, docs_d[sl], ctxs_d[sl],
                                         centers_d[sl], negs_d[i],
                                         lr=self.lr)
        self.doc_vectors, self.W, self.C = (Dv.cpu().numpy(),
                                            W.cpu().numpy(), C.cpu().numpy())
        return self

    # ----------------------------------------------------------------- query
    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        try:
            return self.doc_vectors[self.labels.index(label)]
        except ValueError:
            return None

    def infer_vector(self, text: str, steps: int = 20) -> np.ndarray:
        """inferVector — gradient steps on a fresh doc vector, words frozen."""
        rng = np.random.default_rng(self.seed)
        toks = self.vocab.encode(self.tokenizer.tokenize(text))
        D = self.vector_size
        if len(toks) == 0:
            return np.zeros(D, np.float32)
        docs, ctxs, centers = self._examples([toks])
        if len(docs) == 0:
            return np.zeros(D, np.float32)
        sampler = NegativeSampler(self.vocab.unigram_table_probs())
        dev = self.device
        Dv = torch.tensor((rng.random((1, D), np.float32) - 0.5) / D,
                          device=dev)
        W, C = (torch.tensor(a, device=dev) for a in (self.W, self.C))
        args = [to_device(a, dev) for a in (docs, ctxs, centers)]
        B = len(docs)
        for _ in range(steps):
            negs = sampler.sample(rng, (B, self.negative))
            Dv, W, C, _ = _pvdm_step(Dv, W, C, *args, to_device(negs, dev),
                                     lr=self.lr, train_words=False)
        return Dv[0].cpu().numpy()

    def similarity(self, a: str, b: str) -> float:
        return cosine_similarity(self.get_doc_vector(a), self.get_doc_vector(b))

    def nearest_labels(self, text: str, top: int = 10):
        """nearestLabels — infer a vector for raw text and return the
        closest trained document labels by cosine (the reference's
        ParagraphVectors.nearestLabels(rawText, topN))."""
        v = self.infer_vector(text)
        n = np.linalg.norm(v)
        if n == 0 or len(self.labels) == 0:
            return []
        Dn = self.doc_vectors / np.maximum(
            np.linalg.norm(self.doc_vectors, axis=1, keepdims=True), 1e-12)
        sims = Dn @ (v / n)
        return [self.labels[j] for j in np.argsort(-sims)][:top]
