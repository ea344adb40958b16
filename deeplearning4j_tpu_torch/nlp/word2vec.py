"""Word2Vec — skip-gram / CBOW with negative sampling or hierarchical softmax.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``. Pair generation is
host numpy, drawn in the same order from the same generator as in the JAX
package, so a seed gives the same pairs and host negatives. The update
steps are plain functions on tensors: each computes the loss's gradient
with respect to the gathered rows explicitly and scatters it back with
``index_add_``, so duplicate ids in a batch sum (the transpose of a
gather) and a row no batch touches stays bit-equal. Each step updates its
tables in place and returns them. The tables stay on the model's device
through ``fit`` (the card unless the caller passes ``device="cpu"``); ``W``
and ``C`` are numpy afterwards, as in the JAX package.

The scanned steps (``_sg_neg_steps_devneg``, ``_sg_hs_steps``) loop over S
batches on the device after one host-to-device copy of the [S, B] pairs.
Device negatives come from a ``torch.Generator`` on the tables' device,
seeded from ``seed``, by the same alias method as the JAX package's
threefry draws (a different stream).

Reference analog: org.deeplearning4j.models.word2vec.Word2Vec (+ Builder) on
top of SequenceVectors/AbstractCache; the reference trains with per-thread
Hogwild updates over individual pairs.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.nlp.tokenizers import (
    CommonPreprocessor, DefaultTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    NegativeSampler, VocabCache, build_alias_table, cosine_similarity,
)


def cbow_windows(encoded, window: int):
    """(center [N], context-window [N, 2*window]) arrays over encoded
    sentences; short windows are padded by cycling the available context
    words. Shared by Word2Vec (CBOW) and ParagraphVectors (PV-DM)."""
    centers, ctxs = [], []
    for sent in encoded:
        n = len(sent)
        for i in range(n):
            ctx = [int(sent[j]) for j in range(max(0, i - window),
                                               min(n, i + window + 1)) if j != i]
            if not ctx:
                continue
            centers.append(int(sent[i]))
            ctxs.append([ctx[k % len(ctx)] for k in range(2 * window)])
    return (np.asarray(centers, np.int32),
            np.asarray(ctxs, np.int32).reshape(-1, 2 * window))


# ------------------------------------------------------------- step pieces

def _ids(t):
    """Row ids as int64 (int64 ids pass as they are): uint16 ids travel as
    int16 (few PyTorch ops take torch.uint16) and widen here, on the ids'
    device."""
    if t.dtype == torch.int16:
        return t.to(torch.int64).bitwise_and_(0xFFFF)
    return t.to(torch.int64)


def _scatter(table, ids, rows):
    """The dense gradient of a gather: ``rows`` summed into a zero tensor
    like ``table`` at ``ids`` (duplicates sum)."""
    return torch.zeros_like(table).index_add_(
        0, ids.reshape(-1), rows.reshape(-1, *table.shape[1:]))


def _neg_sampling_grads(h, C, pos_ids, neg_ids):
    """Loss -log s(h.c) - sum log s(-h.n) of hidden rows ``h`` [B, D]
    against output rows C[pos_ids] [B] and C[neg_ids] [B, K]: (loss, dL/dh
    [B, D], dL/dC dense)."""
    c = C[pos_ids]
    n = C[neg_ids]
    pos = (h * c).sum(1)
    neg = torch.bmm(n, h.unsqueeze(2)).squeeze(2)
    # -log s(x) = softplus(-x)
    loss = F.softplus(-pos).sum() + F.softplus(neg).sum()
    gpos = torch.sigmoid(-pos).neg_()    # d(-log s(x))/dx
    gneg = torch.sigmoid(neg)            # d(-log s(-x))/dx
    gh = torch.addcmul(torch.bmm(gneg.unsqueeze(1), n).squeeze(1),
                       gpos.unsqueeze(1), c)
    gC = _scatter(C, pos_ids, gpos.unsqueeze(1) * h)
    gC.index_add_(0, neg_ids.reshape(-1),
                  (gneg.unsqueeze(2) * h.unsqueeze(1)).reshape(-1, h.shape[1]))
    return loss, gh, gC


def _sg_neg_step(W, C, center, context, negatives, lr):
    """One negative-sampling SGD step.

    W [V, D] input vectors, C [V, D] output vectors; center [B], context [B],
    negatives [B, K]. Loss = -log s(w.c) - sum log s(-w.n)."""
    center = _ids(center)
    loss, gw, gC = _neg_sampling_grads(W[center], C, _ids(context),
                                       _ids(negatives))
    W.add_(_scatter(W, center, gw), alpha=-lr)
    C.add_(gC, alpha=-lr)
    return W, C, loss


def alias_negatives(gen, aprob, aalias, shape):
    """Draws from a Vose alias table on its device: index k uniform, kept
    if u < prob[k], else alias[k]."""
    V = aprob.shape[0]
    idx = torch.randint(0, V, shape, generator=gen, device=aprob.device)
    u = torch.rand(shape, generator=gen, device=aprob.device)
    return torch.where(u < aprob[idx], idx, aalias[idx].to(torch.int64))


def _sg_neg_steps_devneg(W, C, gen, centers, contexts, aprob, aalias, lr,
                         k):
    """S sequential negative-sampling steps over centers [S, B] and
    contexts [S, B], already on the device: the ids widen once, and the
    S steps' negatives [S, B, k] are drawn there in one call from the
    alias table (aprob [V] f32, aalias [V]) with ``gen``. Returns (W, C,
    summed loss)."""
    centers, contexts = _ids(centers), _ids(contexts)
    negs = alias_negatives(gen, aprob, aalias, tuple(centers.shape) + (k,))
    total = 0.0
    for s in range(centers.shape[0]):
        W, C, loss = _sg_neg_step(W, C, centers[s], contexts[s], negs[s], lr)
        total = total + loss
    return W, C, total


def _cbow_neg_step(W, C, context_win, center, negatives, lr):
    """CBOW: mean of context window vectors predicts the center word.
    context_win [B, 2w] (padded with center index where window clipped)."""
    ctx = _ids(context_win)
    h = W[ctx].mean(dim=1)
    loss, gh, gC = _neg_sampling_grads(h, C, _ids(center), _ids(negatives))
    n = ctx.shape[1]
    W.add_(_scatter(W, ctx, (gh / n).unsqueeze(1).expand(-1, n, -1)),
           alpha=-lr)
    C.add_(gC, alpha=-lr)
    return W, C, loss


def build_huffman(freqs) -> tuple:
    """Huffman coding over word frequencies (the reference's Huffman class in
    deeplearning4j-nlp, used by its default hierarchical softmax).

    Returns (codes [V, L] int8 0/1, points [V, L] int32 inner-node ids,
    mask [V, L] float32) padded to the longest code length L."""
    import heapq

    V = len(freqs)
    if V == 1:
        return (np.zeros((1, 1), np.int8), np.zeros((1, 1), np.int32),
                np.ones((1, 1), np.float32))
    heap = [(int(f), i, None, None) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    next_id = V
    nodes = {}
    while len(heap) > 1:
        f1, id1, l1, r1 = heapq.heappop(heap)
        f2, id2, l2, r2 = heapq.heappop(heap)
        nodes[next_id] = (id1, id2)
        heapq.heappush(heap, (f1 + f2, next_id, id1, id2))
        next_id += 1
    root = heap[0][1]

    codes: list = [None] * V
    points: list = [None] * V

    def walk(node, code, path):
        if node < V:
            codes[node] = code
            points[node] = path
            return
        left, right = nodes[node]
        # inner-node parameter index: node - V (V-1 inner nodes total)
        walk(left, code + [0], path + [node - V])
        walk(right, code + [1], path + [node - V])

    walk(root, [], [])
    L = max(len(c) for c in codes)
    code_m = np.zeros((V, L), np.int8)
    point_m = np.zeros((V, L), np.int32)
    mask_m = np.zeros((V, L), np.float32)
    for i in range(V):
        n = len(codes[i])
        code_m[i, :n] = codes[i]
        point_m[i, :n] = points[i]
        mask_m[i, :n] = 1.0
    return code_m, point_m, mask_m


def _adagrad(param, acc, grad, lr):
    """acc += g^2; param -= lr g / sqrt(acc + 1e-8), in place. A row whose
    gradient is 0 keeps its bits."""
    acc.addcmul_(grad, grad)
    param.addcdiv_(grad, torch.sqrt(acc + 1e-8), value=-lr)


def _sg_hs_step(W, Theta, accW, accT, center, context, codes, points, mask,
                lr):
    """Hierarchical-softmax skip-gram step with Adagrad scaling.

    For a (center, context) pair the loss walks the CONTEXT word's Huffman
    path with the center's input vector:
    loss = -sum_l mask * log sigma((1-2*code_l) * w . theta_l);
    Theta holds one vector per inner node ([V-1, D]). The update is
    Adagrad-normalized per parameter (accW/accT carry the squared-gradient
    accumulators across batches), as in the JAX package."""
    center, context = _ids(center), _ids(context)
    w = W[center]                                   # [B, D]
    pts = points[context].to(torch.int64)           # [B, L]
    th = Theta[pts]                                 # [B, L, D]
    sign = 1.0 - 2.0 * codes[context].to(torch.float32)
    m = mask[context]
    logits = sign * torch.bmm(th, w.unsqueeze(2)).squeeze(2)
    loss = -(F.logsigmoid(logits) * m).sum()
    gdot = -m * torch.sigmoid(-logits) * sign
    gW = _scatter(W, center, torch.bmm(gdot.unsqueeze(1), th).squeeze(1))
    gT = _scatter(Theta, pts, gdot[:, :, None] * w[:, None, :])
    _adagrad(W, accW, gW, lr)
    _adagrad(Theta, accT, gT, lr)
    return W, Theta, accW, accT, loss


def _sg_hs_steps(W, Theta, accW, accT, centers, contexts, codes, points,
                 mask, lr):
    """S sequential hierarchical-softmax steps over centers/contexts
    [S, B], already on the device (the ids widen once); the Huffman tables
    are shared."""
    centers, contexts = _ids(centers), _ids(contexts)
    total = 0.0
    for s in range(centers.shape[0]):
        W, Theta, accW, accT, loss = _sg_hs_step(
            W, Theta, accW, accT, centers[s], contexts[s], codes, points,
            mask, lr)
        total = total + loss
    return W, Theta, accW, accT, total


class Word2Vec:
    """Builder-style Word2Vec (reference: Word2Vec.Builder()...build().fit()).

    ``hs=True`` selects hierarchical softmax over a Huffman tree (the
    reference's default); otherwise negative sampling with ``negative``
    noise words. ``device``: the card when None (raising without one), the
    CPU only when asked."""

    def __init__(self, vector_size: int = 100, window: int = 5,
                 min_count: int = 1, negative: int = 5, epochs: int = 1,
                 learning_rate: float = 0.025, cbow: bool = False,
                 subsample: float = 0.0, batch_size: int = 512, seed: int = 42,
                 hs: bool = False, workers: int = 0,
                 min_learning_rate: Optional[float] = None,
                 device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self.vector_size = vector_size
        # linear lr decay over the run's words, floored here (reference:
        # Word2Vec.Builder().minLearningRate). None keeps the fixed lr.
        self.min_lr = min_learning_rate
        self.window = window
        self.negative = negative
        self.hs = hs
        # host-side worker threads for the native concurrent front
        # (reference: Word2Vec.Builder().workers(n)); 0 = auto
        self.workers = workers if workers > 0 else min(8, os.cpu_count() or 4)
        self.epochs = epochs
        self.lr = learning_rate
        self.cbow = cbow
        self.subsample = subsample
        self.batch_size = batch_size
        self.seed = seed
        self.vocab = VocabCache(min_count=min_count)
        self.tokenizer = DefaultTokenizerFactory(CommonPreprocessor())
        self.W: Optional[np.ndarray] = None   # input vectors (the embeddings)
        self.C: Optional[np.ndarray] = None   # output vectors
        self.train_state: dict = {}           # see nlp.load_jax_state

    # ------------------------------------------------------------------- fit
    def _iter_token_sents(self, corpus):
        """Streaming tokenized-sentence view of ``corpus``: a string (split
        on lines), any iterable of strings/token-lists, or a
        nlp.corpus.SentenceIterator — nothing is materialized. For
        epochs > 1 the corpus must be re-iterable."""
        if isinstance(corpus, str):
            corpus = corpus.splitlines()
        for line in corpus:
            toks = (self.tokenizer.tokenize(line) if isinstance(line, str)
                    else list(line))
            if toks:
                yield toks

    def _pairs(self, encoded: List[np.ndarray], rng) -> np.ndarray:
        """All (center, context) skip-gram pairs with random window shrink,
        vectorized over the chunk: one uniform shrink b per center, both
        directions share it (the JAX package's draws and order)."""
        lens = np.asarray([len(s) for s in encoded], np.int64)
        total = int(lens.sum())
        if total == 0:
            return np.zeros((0, 2), np.int32)
        flat = np.concatenate([np.asarray(s, np.int32) for s in encoded])
        starts = np.repeat(np.cumsum(lens) - lens, lens)
        pos = np.arange(total) - starts          # position within sentence
        slen = np.repeat(lens, lens)
        b = rng.integers(1, self.window + 1, total)
        cs, xs = [], []
        for d in range(1, self.window + 1):
            reach = b >= d
            right = reach & (pos + d < slen)
            left = reach & (pos >= d)
            ri = np.nonzero(right)[0]
            li = np.nonzero(left)[0]
            cs.append(flat[ri])
            xs.append(flat[ri + d])
            cs.append(flat[li])
            xs.append(flat[li - d])
        return np.stack([np.concatenate(cs), np.concatenate(xs)],
                        axis=1).astype(np.int32)

    # ------------------------------------------------- native concurrent front
    def _native_corpus_path(self, corpus) -> Optional[str]:
        """File path when ``corpus`` qualifies for the native concurrent
        front (see _fit_native), else None."""
        from deeplearning4j_tpu_torch.native.lib import native_available
        from deeplearning4j_tpu_torch.nlp.corpus import LineSentenceIterator

        if (type(corpus) is LineSentenceIterator
                and corpus.preprocessor is None
                and corpus.encoding.lower().replace("-", "") == "utf8"
                and not self.cbow
                and type(self.tokenizer) is DefaultTokenizerFactory
                and type(self.tokenizer.preprocessor) is CommonPreprocessor
                and os.path.isfile(corpus.path)
                and native_available()):
            return corpus.path
        return None

    @staticmethod
    def _ascii_sample(path: str, limit: int = 1 << 20) -> bool:
        """True when ``limit`` bytes sampled at the file's head, middle,
        and tail are pure ASCII. The native tokenizer only matches the
        Python one (lowercase + [^\\w\\s] strip) for ASCII text, so AUTO
        selection requires ASCII samples; ``native_front=True`` overrides
        (byte-level semantics, documented in nlp.native_text)."""
        size = os.path.getsize(path)
        if size <= limit:
            offsets, chunk = [0], limit
        else:
            chunk = limit // 3
            offsets = [0, max(0, size // 2 - chunk // 2), size - chunk]
        with open(path, "rb") as f:
            for off in offsets:
                f.seek(off)
                sample = f.read(chunk)
                if sample and max(sample) >= 0x80:
                    return False
        return True

    def _lr_at(self, words_done: int, total_words: int) -> float:
        """Linear lr decay over the run's in-vocab words (the reference's
        alpha schedule), floored at min_learning_rate; fixed lr when the
        floor is unset."""
        if self.min_lr is None:
            return self.lr
        frac = min(1.0, words_done / max(1, total_words))
        return max(self.min_lr, self.lr * (1.0 - frac))

    def _init_tables(self, rng):
        V, D = len(self.vocab), self.vector_size
        if V == 0:
            raise ValueError("empty vocabulary")
        self.W = ((rng.random((V, D), np.float32) - 0.5) / D)
        self.C = np.zeros((V, D), np.float32)
        return (torch.tensor(self.W, device=self.device),
                torch.tensor(self.C, device=self.device))

    def _huffman_tables(self):
        freqs = [self.vocab.counts[w_] for w_ in self.vocab.words]
        return tuple(torch.tensor(a, device=self.device)
                     for a in build_huffman(freqs))

    def _fit_native(self, path: str, rng) -> Optional["Word2Vec"]:
        """Train over the native concurrent text front: N C++ threads
        tokenize/encode/subsample/window line-chunks in parallel
        (native/dl4jtpu_native.cpp) while this thread runs the device
        steps. Batch arrival order is nondeterministic run-to-run, like the
        reference's threaded trainer; ``native_front=False`` gives the
        deterministic Python stream. None = native pass unavailable."""
        from deeplearning4j_tpu_torch.nlp.native_text import (
            NativeSkipGramStream, native_word_counts,
        )

        counts = native_word_counts(path, self.workers)
        if counts is None:
            return None
        self.vocab.fit_from_counts(counts)
        W, C = self._init_tables(rng)
        V, dev = W.shape[0], self.device
        keep = (self.vocab.subsample_keep_probs(self.subsample)
                if self.subsample > 0 else None)
        if self.hs:
            codes_m, points_m, mask_m = self._huffman_tables()
            C = torch.zeros((max(V - 1, 1), W.shape[1]), device=dev)
            accW, accT = torch.zeros_like(W), torch.zeros_like(C)
        else:
            probs = self.vocab.unigram_table_probs()
            aprob, aalias = (torch.tensor(a, device=dev)
                             for a in build_alias_table(probs))
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            tail_sampler = NegativeSampler(probs)
        # the C++ side ships ONLY (center, context) pairs — negatives are
        # drawn on the device from the alias table — and pair ids travel
        # as uint16 when the vocab fits (widened on the device)
        total_words = self.vocab._total * self.epochs
        stream = NativeSkipGramStream(
            path, self.vocab.words, None, keep, self.window, 0,
            self.batch_size, seed=self.seed, n_threads=self.workers)
        # S batches a dispatch: one host-to-device copy covers S steps; the
        # tail shorter than S runs on the per-batch step with host-sampled
        # negatives
        S, B = 32, self.batch_size
        pair_dt = np.uint16 if V <= 0xFFFF else np.int32
        cs = np.empty((S, B), pair_dt)
        xs = np.empty((S, B), pair_dt)

        def on_device(a):
            return to_device(a.view(np.int16) if a.dtype == np.uint16 else a,
                             dev)

        try:
            for epoch in range(self.epochs):
                if epoch:
                    stream.reset()
                k = 0
                for c, x, _ in stream:
                    cs[k], xs[k] = c, x
                    k += 1
                    if k == S:
                        # producer-side schedule, like the reference: alpha
                        # decays by words READ, the counter the C++ workers
                        # publish
                        lr_now = self._lr_at(stream.words_seen, total_words)
                        if self.hs:
                            W, C, accW, accT, _ = _sg_hs_steps(
                                W, C, accW, accT, on_device(cs),
                                on_device(xs), codes_m, points_m, mask_m,
                                lr=lr_now)
                        else:
                            W, C, _ = _sg_neg_steps_devneg(
                                W, C, gen, on_device(cs), on_device(xs),
                                aprob, aalias, lr=lr_now, k=self.negative)
                        k = 0
                rng_tail = np.random.default_rng(self.seed + 31 * epoch)
                lr_now = self._lr_at(stream.words_seen, total_words)
                for i in range(k):
                    ci = on_device(cs[i].astype(np.int32))
                    xi = on_device(xs[i].astype(np.int32))
                    if self.hs:
                        W, C, accW, accT, _ = _sg_hs_step(
                            W, C, accW, accT, ci, xi, codes_m, points_m,
                            mask_m, lr=lr_now)
                    else:
                        negs = tail_sampler.sample(rng_tail,
                                                   (B, self.negative))
                        W, C, _ = _sg_neg_step(W, C, ci, xi,
                                               on_device(negs), lr=lr_now)
        finally:
            stream.close()
        self.W, self.C = W.cpu().numpy(), C.cpu().numpy()
        return self

    def fit(self, corpus, chunk_sentences: int = 4096,
            native_front: Optional[bool] = None) -> "Word2Vec":
        """Fit on a sentence corpus.

        **Determinism note:** eligible runs (file-backed ASCII
        LineSentenceIterator corpus, skip-gram config, default tokenizer,
        loadable native lib) AUTO-ROUTE to the native concurrent front,
        whose multi-threaded batch arrival order is NONDETERMINISTIC
        run-to-run. Pass ``native_front=False`` to force the deterministic
        (seed-reproducible) Python stream, or ``True`` to require the
        native path.

        The Python stream makes one vocabulary pass and one pass per epoch
        over ``corpus``, encoding + subsampling on the fly and training in
        chunks of ``chunk_sentences``; each chunk's pairs and negatives go
        to the device in one copy."""
        rng = np.random.default_rng(self.seed)
        if self.hs and self.cbow:
            raise ValueError("cbow=True with hs=True is not supported; use "
                             "negative sampling for CBOW")
        path = (None if native_front is False
                else self._native_corpus_path(corpus))
        if native_front is True and path is None:
            raise ValueError(
                "native_front=True requires a file-backed "
                "LineSentenceIterator (no preprocessor, utf-8), a skip-gram "
                "config with the default tokenizer, and a loadable native "
                "library")
        if (native_front is None and path is not None
                and not self._ascii_sample(path)):
            path = None
        if path is not None:
            out = self._fit_native(path, rng)
            if out is not None:
                return out
        self.vocab.fit(self._iter_token_sents(corpus))
        W, C = self._init_tables(rng)
        V, dev = W.shape[0], self.device
        sampler = NegativeSampler(self.vocab.unigram_table_probs())
        keep = (self.vocab.subsample_keep_probs(self.subsample)
                if self.subsample > 0 else None)
        huffman = None
        accW = accT = None
        if self.hs and not self.cbow:
            # per-fit: the tree depends on THIS corpus's vocabulary
            huffman = self._huffman_tables()
            C = torch.zeros((max(V - 1, 1), W.shape[1]), device=dev)
            accW = torch.zeros_like(W)
            accT = torch.zeros_like(C)

        def train_chunk(encoded, lr):
            nonlocal W, C, accW, accT
            if self.cbow:
                centers, ctxs = cbow_windows(encoded, self.window)
                if len(centers) == 0:
                    return
                order = rng.permutation(len(centers))
                centers, ctxs = centers[order], ctxs[order]
                B = min(self.batch_size, len(centers))
                nb = len(centers) // B
                negs = np.stack([sampler.sample(rng, (B, self.negative))
                                 for _ in range(nb)])
                centers_d, ctxs_d, negs_d = (_ids(to_device(a, dev)) for a in (
                    centers[:nb * B], ctxs[:nb * B], negs))
                for i in range(nb):
                    s = i * B
                    W, C, _ = _cbow_neg_step(W, C, ctxs_d[s:s + B],
                                             centers_d[s:s + B], negs_d[i],
                                             lr=lr)
            elif self.hs:
                pairs = self._pairs(encoded, rng)
                if len(pairs) == 0:
                    return
                codes_m, points_m, mask_m = huffman
                pairs = pairs[rng.permutation(len(pairs))]
                B = min(self.batch_size, len(pairs))
                nb = len(pairs) // B
                pairs_d = _ids(to_device(pairs[:nb * B], dev))
                for i in range(nb):
                    batch = pairs_d[i * B:(i + 1) * B]
                    W, C, accW, accT, _ = _sg_hs_step(
                        W, C, accW, accT, batch[:, 0], batch[:, 1],
                        codes_m, points_m, mask_m, lr=lr)
            else:
                pairs = self._pairs(encoded, rng)
                if len(pairs) == 0:
                    return
                pairs = pairs[rng.permutation(len(pairs))]
                # negatives for the WHOLE chunk come from one sampler call
                B = min(self.batch_size, len(pairs))
                nb = len(pairs) // B
                negs_all = sampler.sample(rng, (nb, B, self.negative))
                pairs_d = _ids(to_device(pairs[:nb * B], dev))
                negs_d = _ids(to_device(negs_all, dev))
                for i in range(nb):
                    batch = pairs_d[i * B:(i + 1) * B]
                    W, C, _ = _sg_neg_step(W, C, batch[:, 0], batch[:, 1],
                                           negs_d[i], lr=lr)

        total_words = self.vocab._total * self.epochs
        words_done = 0
        for epoch in range(self.epochs):
            if hasattr(corpus, "reset"):
                corpus.reset()
            buf = []
            seen = 0
            for toks in self._iter_token_sents(corpus):
                seen += 1
                enc = self.vocab.encode(toks)
                words_done += len(enc)
                if keep is not None and len(enc):
                    enc = enc[rng.random(len(enc)) < keep[enc]]
                if len(enc):
                    buf.append(enc)
                if len(buf) >= chunk_sentences:
                    train_chunk(buf, self._lr_at(words_done, total_words))
                    buf = []
            if buf:
                train_chunk(buf, self._lr_at(words_done, total_words))
            if seen == 0 and epoch == 0:
                # a single-pass generator was exhausted by the vocabulary
                # pass — fail loud instead of returning random embeddings
                raise ValueError(
                    "corpus yielded no sentences on the training pass; "
                    "fit() makes one vocabulary pass plus one pass per "
                    "epoch, so pass a re-iterable (list, str, or a "
                    "nlp.corpus SentenceIterator), not a generator")
        self.W, self.C = W.cpu().numpy(), C.cpu().numpy()
        return self

    # ----------------------------------------------------------------- query
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.W[i]

    def similarity(self, a: str, b: str) -> float:
        return cosine_similarity(self.get_word_vector(a), self.get_word_vector(b))

    def words_nearest(self, word=None, top: int = 10, positive=None,
                      negative=None) -> List[str]:
        """wordsNearest — cosine neighbors of a word, or of an analogy
        query (reference: wordsNearest(positive, negative, top), the
        king - man + woman form)."""
        from deeplearning4j_tpu_torch.nlp.vocab import nearest_neighbors

        return nearest_neighbors(self.vocab.words, self.vocab.index, self.W,
                                 word=word, top=top, positive=positive,
                                 negative=negative)

    # ----------------------------------------------------------------- serde
    def save(self, path: str):
        np.savez(path, W=self.W, C=self.C,
                 words=np.asarray(self.vocab.words, dtype=object))

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "Word2Vec":
        data = np.load(path if path.endswith(".npz") else path + ".npz",
                       allow_pickle=True)
        m = cls(vector_size=data["W"].shape[1], device=device)
        m.W, m.C = data["W"], data["C"]
        words = [str(w) for w in data["words"]]
        m.vocab.words = words
        m.vocab.index = {w: i for i, w in enumerate(words)}
        return m


def load_jax_state(model, words, arrays, counts=None, labels=None):
    """Give ``model`` (a Word2Vec, Glove or ParagraphVectors) the state of
    the JAX package's model: its vocabulary ``words`` (with ``counts``, a
    word -> count mapping, where known), its document ``labels``, and
    ``arrays``, numpy by name. The tables the JAX model keeps ("W", "C" —
    Theta under hierarchical softmax — and "doc_vectors") become the
    model's numpy tables; the training state the step functions carry
    (AdaGrad accumulators "accW" / "accT", GloVe's biases "bw" / "bc" and
    their "acc_*") goes to ``model.train_state`` as f32 tensors on the
    model's device. The counterpart of ``nn.multilayer.load_jax_params``."""
    from collections import Counter

    words = [str(w) for w in words]
    model.vocab.words = words
    model.vocab.index = {w: i for i, w in enumerate(words)}
    if counts is not None:
        model.vocab.counts = Counter(counts)
        model.vocab._total = sum(model.vocab.counts[w] for w in words)
    if labels is not None:
        model.labels = list(labels)
    for name, value in arrays.items():
        a = np.array(value, np.float32)
        if name == "W" and a.shape[0] != len(words):
            raise ValueError(f"W has {a.shape[0]} rows for {len(words)} "
                             f"words")
        if name in ("W", "C", "doc_vectors") and hasattr(model, name):
            setattr(model, name, a)
        else:
            model.train_state[name] = torch.tensor(a, device=model.device)
    return model
