"""Vocabulary cache.

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py``, copied (host numpy).

Reference analog: org.deeplearning4j.models.word2vec.wordstore.inmemory.
AbstractCache (VocabCache interface): word frequencies, min-count pruning,
index assignment, and the unigram^0.75 negative-sampling table.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional

import numpy as np


class VocabCache:
    def __init__(self, min_count: int = 1):
        self.min_count = min_count
        self.counts: Counter = Counter()
        self.index: dict[str, int] = {}
        self.words: List[str] = []
        self._total = 0

    # ------------------------------------------------------------------ build
    def fit(self, sentences: Iterable[List[str]]) -> "VocabCache":
        for s in sentences:
            self.counts.update(s)
        kept = [(w, c) for w, c in self.counts.most_common()
                if c >= self.min_count]
        self.words = [w for w, _ in kept]
        self.index = {w: i for i, w in enumerate(self.words)}
        self._total = sum(c for _, c in kept)
        return self

    def fit_from_counts(self, counts) -> "VocabCache":
        """Build from a precomputed word->count mapping (the native
        concurrent counting pass, nlp.native_text.native_word_counts).
        Ties order by word so the index assignment is deterministic even
        though concurrent counting loses first-seen order."""
        self.counts = Counter(counts)
        kept = sorted(((w, c) for w, c in self.counts.items()
                       if c >= self.min_count),
                      key=lambda wc: (-wc[1], wc[0]))
        self.words = [w for w, _ in kept]
        self.index = {w: i for i, w in enumerate(self.words)}
        self._total = sum(c for _, c in kept)
        return self

    def __len__(self):
        return len(self.words)

    def __contains__(self, w):
        return w in self.index

    def word_frequency(self, w: str) -> int:
        return self.counts.get(w, 0)

    def index_of(self, w: str) -> int:
        return self.index.get(w, -1)

    def encode(self, tokens: List[str]) -> np.ndarray:
        """Token list -> index array, dropping OOV (reference drops unknowns)."""
        return np.asarray([self.index[t] for t in tokens if t in self.index],
                          np.int32)

    # --------------------------------------------------- negative sampling
    def unigram_table_probs(self, power: float = 0.75) -> np.ndarray:
        """P(w) ∝ count^0.75 — the word2vec negative-sampling distribution."""
        freqs = np.asarray([self.counts[w] for w in self.words], np.float64)
        p = freqs ** power
        return (p / p.sum()).astype(np.float32)

    def subsample_keep_probs(self, t: float = 1e-3) -> np.ndarray:
        """Mikolov frequent-word subsampling keep probability."""
        f = np.asarray([self.counts[w] for w in self.words], np.float64)
        f = f / max(self._total, 1)
        keep = np.minimum(1.0, np.sqrt(t / np.maximum(f, 1e-12)) + t / np.maximum(f, 1e-12))
        return keep.astype(np.float32)


def build_alias_table(probs: np.ndarray):
    """Vose alias table (prob [V] f32, alias [V] i32) for O(1) categorical
    sampling: draw k uniform, return k if u < prob[k] else alias[k].
    Device-resident twin of the native AliasTable — the scanned Word2Vec
    steps sample negatives ON the card so the host ships only (center,
    context) pairs."""
    p = np.asarray(probs, np.float64)
    n = len(p)
    scaled = p / p.sum() * n
    alias = np.zeros(n, np.int32)
    prob = np.ones(n, np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] += scaled[s] - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


class NegativeSampler:
    """Precomputed-CDF sampler for the unigram^0.75 distribution.

    ``rng.choice(V, p=probs)`` rebuilds an O(V) CDF per call; for real
    vocabularies that would dominate each training batch. Build the CDF once
    and sample with searchsorted.
    """

    def __init__(self, probs: np.ndarray):
        self._cdf = np.cumsum(np.asarray(probs, np.float64))
        self._cdf[-1] = 1.0

    def sample(self, rng, size) -> np.ndarray:
        return np.searchsorted(self._cdf, rng.random(size)).astype(np.int32)


def nearest_neighbors(words: List[str], index: dict, W: np.ndarray,
                      word: Optional[str] = None, top: int = 10,
                      positive=None, negative=None) -> List[str]:
    """Shared wordsNearest engine (Word2Vec/GloVe; reference:
    wordsNearest(word | positive, negative, top)): cosine neighbors of a
    word or of a mean(positive) - mean(negative) analogy query, excluding
    the query words. [] on any OOV query word."""
    positive = list(positive or ([] if word is None else [word]))
    negative = list(negative or [])
    if word is not None and positive and word not in positive:
        positive = [word] + positive
    if not positive:      # negatives alone have no defined query direction
        return []
    idx = [index.get(w, -1) for w in positive + negative]
    if any(i < 0 for i in idx):
        return []
    Wn = W / np.maximum(np.linalg.norm(W, axis=1, keepdims=True), 1e-12)
    n_pos = len(positive)
    q = Wn[idx[:n_pos]].mean(axis=0)
    if negative:
        q = q - Wn[idx[n_pos:]].mean(axis=0)
    sims = Wn @ (q / max(np.linalg.norm(q), 1e-12))
    exclude = set(idx)
    return [words[j] for j in np.argsort(-sims) if j not in exclude][:top]


def cosine_similarity(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> float:
    """Shared cosine helper (Word2Vec/Glove/ParagraphVectors .similarity)."""
    if a is None or b is None:
        return float("nan")
    denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1e-12
    return float(a @ b / denom)
