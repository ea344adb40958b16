"""BERT text front: WordPiece tokenization + batch iterator.

Reference analog: org.deeplearning4j.text.tokenization.tokenizer.
BertWordPieceTokenizer (greedy longest-match-first subword split against a
BERT vocab, "##" continuation prefix, [UNK] fallback) and
org.deeplearning4j.iterator.BertIterator (sentence provider -> padded
[ids, mask] feature arrays for SEQ_CLASSIFICATION, or masked-LM batches
for UNSUPERVISED pretraining: 15% of positions selected, 80% -> [MASK],
10% -> random token, 10% kept, with a label mask over just the selected
positions).

Counterpart of ``deeplearning4j_tpu/nlp/bert.py``, copied (numpy only):
batches come out as fixed-shape int32/float32 arrays (pad to ``max_len``
AND to ``batch_size``) in the port's ``DataSet``, drawn from the same numpy
generator, so both packages give the same batches under one seed.
Masked-LM labels are int ids with a labels_mask over the
selected positions; ``BertIterator.one_hot`` converts a batch for the
mcxent output tier (practical for small/custom vocabularies).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class BertWordPieceTokenizer:
    """Greedy longest-match-first WordPiece (BertWordPieceTokenizer).

    ``vocab``: iterable of wordpieces (continuations prefixed "##") or a
    path to a BERT vocab.txt (one token per line). Basic tokenization
    (lowercase + punctuation split) mirrors the reference's
    BertWordPiecePreProcessor defaults."""

    def __init__(self, vocab, lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        if isinstance(vocab, str):
            with open(vocab, "r", encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self.vocab = list(vocab)
        self.index = {w: i for i, w in enumerate(self.vocab)}
        self.lower_case = lower_case
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word

    # ------------------------------------------------------------ tokenize
    def _basic_split(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
        out, word = [], []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif not (ch.isalnum() or ch == "_"):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)               # punctuation is its own token
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.index:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]      # whole word becomes [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic_split(text):
            out.extend(self._wordpiece(word))
        return out

    create = tokenize  # reference naming parity with the other factories

    def encode(self, text: str) -> List[int]:
        unk = self.index.get(self.unk_token, 0)
        return [self.index.get(t, unk) for t in self.tokenize(text)]


class BertIterator:
    """Sentence provider -> fixed-shape BERT batches (BertIterator).

    ``task``: "seq_classification" (features = [ids, mask]; labels =
    one-hot from the provider's labels) or "unsupervised" (masked LM:
    labels are the ORIGINAL ids, labels_mask marks the selected
    positions). Batches always pad/truncate to ``max_len``: fixed shapes.

    ``sentences``: iterable of str (unsupervised) or (str, label) pairs
    (classification); re-iterated per epoch via reset().

    ``pad_minibatches`` (default True, the reference's padMinibatches):
    the trailing partial batch pads to ``batch_size`` with all-zero-mask
    rows (zero label vectors / zero labels_mask — they contribute nothing
    to the loss), so EVERY batch has the same shape.

    Masked-LM labels are emitted as int32 ids (one-hot [B, L, V] for a
    real 30k vocab is gigabytes); ``one_hot(ds)`` converts a batch for
    the mcxent output tier directly — practical for the small/custom
    vocabs this front targets."""

    MASK_TOKEN = "[MASK]"
    CLS_TOKEN = "[CLS]"
    SEP_TOKEN = "[SEP]"
    PAD_TOKEN = "[PAD]"

    def __init__(self, tokenizer: BertWordPieceTokenizer, sentences,
                 batch_size: int = 32, max_len: int = 128,
                 task: str = "seq_classification",
                 labels: Optional[Sequence[str]] = None,
                 mask_prob: float = 0.15, seed: int = 0,
                 append_special: bool = True, pad_minibatches: bool = True):
        if task not in ("seq_classification", "unsupervised"):
            raise ValueError(f"unknown task {task!r}")
        self.tok = tokenizer
        self.sentences = sentences
        self.batch_size = batch_size
        self.max_len = max_len
        self.task = task
        self.mask_prob = mask_prob
        self.pad_minibatches = pad_minibatches
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        idx = tokenizer.index
        self.pad_id = idx.get(self.PAD_TOKEN, 0)
        self.mask_id = idx.get(self.MASK_TOKEN)
        self.cls_id = idx.get(self.CLS_TOKEN)
        self.sep_id = idx.get(self.SEP_TOKEN)
        if task == "unsupervised" and self.mask_id is None:
            raise ValueError("unsupervised (masked LM) task needs a "
                             "[MASK] token in the vocabulary")
        if append_special and (self.cls_id is None) != (self.sep_id is None):
            raise ValueError(
                "append_special needs [CLS] and [SEP] together in the "
                "vocabulary (or neither); got exactly one of them")
        # one place decides the [CLS] ... [SEP] framing
        self._frame = bool(append_special and self.cls_id is not None)
        self.labels = list(labels) if labels is not None else None

    def reset(self):
        if hasattr(self.sentences, "reset"):
            self.sentences.reset()
        self._rng = np.random.default_rng(self._seed)

    # ------------------------------------------------------------- batching
    def _encode_one(self, text: str) -> List[int]:
        ids = self.tok.encode(text)
        ids = ids[:self.max_len - (2 if self._frame else 0)]
        if self._frame:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def _emit(self, rows, labs):
        # pad the trailing partial batch to batch_size with zero-mask rows
        # so every batch has ONE shape (padMinibatches); padded rows carry
        # zero label vectors / zero labels_mask — no loss contribution
        n_real = len(rows)
        B = self.batch_size if self.pad_minibatches else n_real
        L = self.max_len
        ids = np.full((B, L), self.pad_id, np.int32)
        mask = np.zeros((B, L), np.float32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1.0
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        if self.task == "seq_classification":
            if self.labels is None:
                raise ValueError("seq_classification needs the label list")
            y = np.zeros((B, len(self.labels)), np.float32)
            for i, l in enumerate(labs):
                y[i, self.labels.index(l)] = 1.0
            return DataSet(ids, y, mask)

        # masked LM: select ~mask_prob of REAL (non-special) positions;
        # 80% -> [MASK], 10% -> random vocab id, 10% unchanged
        V = len(self.tok.vocab)
        labels = ids.copy()
        lmask = np.zeros((B, L), np.float32)
        corrupted = ids.copy()
        edge = 1 if self._frame else 0
        for i, r in enumerate(rows):
            cand = np.arange(edge, len(r) - edge)
            if len(cand) == 0 or self.mask_prob <= 0.0:
                continue
            n_sel = max(1, int(round(self.mask_prob * len(cand))))
            sel = self._rng.choice(cand, size=min(n_sel, len(cand)),
                                   replace=False)
            lmask[i, sel] = 1.0
            for j in sel:
                roll = self._rng.random()
                if roll < 0.8:
                    corrupted[i, j] = self.mask_id
                elif roll < 0.9:
                    corrupted[i, j] = int(self._rng.integers(0, V))
                # else: keep the original token
        return DataSet(corrupted, labels, mask, lmask)

    def one_hot(self, ds):
        """Masked-LM batch -> (features, one-hot labels [B, L, V],
        labels_mask) ready for an mcxent RnnOutputLayer head. Intended for
        the small/custom vocabularies this front targets (a 30k vocab
        one-hot is gigabytes — use a sampled/softmax-sparse head there)."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        V = len(self.tok.vocab)
        y = np.eye(V, dtype=np.float32)[ds.labels]
        return DataSet(ds.features, y, ds.features_mask, ds.labels_mask)

    def __iter__(self):
        rows, labs = [], []
        yielded = 0
        for item in self.sentences:
            if isinstance(item, tuple):
                text, lab = item
            elif hasattr(item, "content"):
                text, lab = item.content, item.label
            else:
                text, lab = item, None
            rows.append(self._encode_one(text))
            labs.append(lab)
            if len(rows) == self.batch_size:
                # arm the exhaustion guard BEFORE yielding: a consumer that
                # breaks out mid-epoch (the steps-bounded pattern) closes
                # this generator at the yield and the epilogue never runs
                self._ever_yielded = True
                yielded += 1
                yield self._emit(rows, labs)
                rows, labs = [], []
        if rows:
            self._ever_yielded = True
            yielded += 1
            yield self._emit(rows, labs)
        if yielded == 0 and getattr(self, "_ever_yielded", False):
            # a single-pass generator was exhausted on an earlier epoch —
            # fail loud instead of letting a multi-epoch loop spin forever
            raise ValueError(
                "sentence provider yielded nothing after a non-empty "
                "earlier pass; pass a list or a resettable iterator "
                "(nlp.corpus) for multi-epoch training, not a generator")
