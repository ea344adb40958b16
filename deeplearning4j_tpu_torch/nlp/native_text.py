"""Native concurrent text front for Word2Vec.

Counterpart of ``deeplearning4j_tpu/nlp/native_text.py``, copied over the
port's native library.

Reference analog (SURVEY.md §2.3 NLP row): the reference's Word2Vec trains
with PER-THREAD Hogwild workers over the corpus — the host side of
`org.deeplearning4j.models.word2vec.Word2Vec` (via SequenceVectors) is
inherently concurrent. The split here keeps the device update as batched
tensor steps (nlp/word2vec.py) and makes the HOST side concurrent:
N native threads tokenize, encode, subsample, window and negative-sample
line-chunks of a corpus file in parallel (native/dl4jtpu_native.cpp text
front), delivering fixed-shape int32 batches that feed the device step.

Like the reference's Hogwild workers, batch arrival order is
nondeterministic run-to-run; the pure-Python front in word2vec.py remains
the deterministic path. Tokenizer semantics match DefaultTokenizerFactory +
CommonPreprocessor for ASCII text; non-ASCII bytes pass through as word
characters WITHOUT lowercasing or unicode-punctuation stripping, so
Word2Vec only auto-selects this front for ASCII corpora (sampled gate in
Word2Vec._ascii_sample) — ``native_front=True`` forces byte-level
semantics on any corpus. Caveat for forced non-UTF-8 corpora:
native_word_counts decodes words with errors="replace", so byte sequences
that are invalid UTF-8 can collapse onto replacement-character vocab keys
that the raw byte stream then never matches (collided counts SUM onto the
shared key; such words count toward the vocabulary but produce no
training pairs).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.native.lib import load_native_lib

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def native_word_counts(path: str, n_threads: int = 4) -> Optional[Dict[str, int]]:
    """Multithreaded word-count pass over a text file — the vocabulary-build
    half of Word2Vec.fit. None if the native lib is unavailable or the file
    can't be read (caller falls back to the Python Counter pass)."""
    lib = load_native_lib()
    if lib is None:
        return None
    h = lib.dl4j_wc_create(str(path).encode(), int(n_threads))
    if not h:
        return None
    try:
        buf = ctypes.create_string_buffer(lib.dl4j_wc_bytes(h))
        lib.dl4j_wc_dump(h, buf)
        counts: Dict[str, int] = {}
        for line in buf.value.decode("utf-8", errors="replace").splitlines():
            word, _, n = line.rpartition(" ")
            # errors="replace" can collapse distinct invalid-UTF-8 byte
            # sequences onto one replacement-character key: sum, don't
            # overwrite (ADVICE r5)
            counts[word] = counts.get(word, 0) + int(n)
        return counts
    finally:
        lib.dl4j_wc_destroy(h)


class NativeSkipGramStream:
    """Iterator of (center[B], context[B], negatives[B, K]) int32 batches
    from the native concurrent pipeline. K == 0 (hierarchical softmax)
    yields (center, context, None). ``reset()`` rewinds for the next epoch
    with fresh window-shrink/negative draws.

    ``words_seen`` / ``pairs_emitted`` read the native counters: in-vocab
    tokens consumed (pre-subsample) and full batches' pairs delivered.
    """

    def __init__(self, path: str, words, probs: Optional[np.ndarray],
                 keep: Optional[np.ndarray], window: int, negative: int,
                 batch: int, seed: int = 0, n_threads: int = 4,
                 queue_cap: int = 8):
        lib = load_native_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.batch = int(batch)
        self.negative = int(negative)
        blob = "\n".join(words).encode("utf-8")
        probs_arr = (np.ascontiguousarray(probs, np.float32)
                     if negative > 0 else np.zeros(len(words), np.float32))
        self._probs = probs_arr                    # keepalive for the C call
        keep_arr = (np.ascontiguousarray(keep, np.float32)
                    if keep is not None else None)
        self._keep = keep_arr
        self._h = lib.dl4j_w2v_create(
            str(path).encode(), blob, len(words),
            probs_arr.ctypes.data_as(_F32P),
            keep_arr.ctypes.data_as(_F32P) if keep_arr is not None else None,
            int(window), int(negative), int(batch), int(seed) & 0xFFFFFFFF,
            int(n_threads), int(queue_cap))
        if not self._h:
            raise RuntimeError(f"dl4j_w2v_create failed for {path!r}")
        # reused delivery buffers; consumers must copy if they hold on
        self._c = np.empty(batch, np.int32)
        self._x = np.empty(batch, np.int32)
        self._n = np.empty((batch, max(negative, 1)), np.int32)

    def _handle(self):
        if not self._h:   # NULL through ctypes would segfault the C side
            raise RuntimeError("NativeSkipGramStream is closed")
        return self._h

    def __iter__(self):
        cp = self._c.ctypes.data_as(_I32P)
        xp = self._x.ctypes.data_as(_I32P)
        np_ = self._n.ctypes.data_as(_I32P)
        # re-read the handle every iteration: close() between next() calls
        # must raise, not hand a freed pointer to the C side
        while self._lib.dl4j_w2v_next(self._handle(), cp, xp, np_) == 0:
            yield (self._c, self._x,
                   self._n if self.negative > 0 else None)

    def reset(self):
        self._lib.dl4j_w2v_reset(self._handle())

    @property
    def words_seen(self) -> int:
        return int(self._lib.dl4j_w2v_words(self._handle()))

    @property
    def pairs_emitted(self) -> int:
        return int(self._lib.dl4j_w2v_pairs(self._handle()))

    def close(self):
        if self._h:
            self._lib.dl4j_w2v_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
