"""Streaming corpus front for the NLP models.

Counterpart of ``deeplearning4j_tpu/nlp/corpus.py``, copied (host Python).

Reference analog: org.deeplearning4j.text.sentenceiterator.
{SentenceIterator, BasicLineIterator, LineSentenceIterator,
FileSentenceIterator, CollectionSentenceIterator, SentencePreProcessor} and
org.deeplearning4j.text.documentiterator.FileLabelAwareIterator — the
surface that makes Word2Vec/ParagraphVectors usable on real corpora: text
streams from FILES, sentence by sentence, with a reset() for multi-epoch
passes; nothing is materialized beyond the current line. Phrase detection
is the word2phrase algorithm of Mikolov et al. (the reference exposes it as
the n-gram/phrase pipeline in deeplearning4j-nlp).

Device relevance: the host-side corpus stream is the input pipeline for
the embedding steps in word2vec.py — iterators here feed the chunked
pair/window generators so vocabulary building and training are one pass
each over arbitrarily large files.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Callable, Iterable, Iterator, List, Optional


class SentencePreProcessor:
    """Lowercase pre-processor (sentenceiterator.SentencePreProcessor)."""

    def __call__(self, sentence: str) -> str:
        return sentence.lower()


class BaseSentenceIterator:
    """Iterable-of-strings with reset() — the SentenceIterator contract.

    Subclasses implement _lines(); the optional ``preprocessor`` maps each
    raw sentence string (the reference's setPreProcessor)."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def _lines(self) -> Iterator[str]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        for line in self._lines():
            line = line.strip()
            if not line:
                continue
            yield self.preprocessor(line) if self.preprocessor else line

    def reset(self):
        """Iterators here are pull-based generators; reset is a no-op hook
        kept for the reference contract (file handles reopen per pass)."""


class LineSentenceIterator(BaseSentenceIterator):
    """One sentence per line from a single file (LineSentenceIterator /
    BasicLineIterator). The file is re-opened on every pass, so multi-epoch
    training never holds the corpus in memory."""

    def __init__(self, path: str,
                 preprocessor: Optional[Callable[[str], str]] = None,
                 encoding: str = "utf-8"):
        super().__init__(preprocessor)
        self.path = path
        self.encoding = encoding

    def _lines(self) -> Iterator[str]:
        with open(self.path, "r", encoding=self.encoding,
                  errors="replace") as f:
            yield from f


BasicLineIterator = LineSentenceIterator


class FileSentenceIterator(BaseSentenceIterator):
    """Every file under a directory, one sentence per line
    (FileSentenceIterator). Files stream in sorted order for
    reproducibility."""

    def __init__(self, directory: str,
                 preprocessor: Optional[Callable[[str], str]] = None,
                 encoding: str = "utf-8"):
        super().__init__(preprocessor)
        self.directory = directory
        self.encoding = encoding

    def _paths(self) -> List[str]:
        out = []
        for root, _, files in os.walk(self.directory):
            out.extend(os.path.join(root, f) for f in files)
        return sorted(out)

    def _lines(self) -> Iterator[str]:
        for p in self._paths():
            with open(p, "r", encoding=self.encoding, errors="replace") as f:
                yield from f


class CollectionSentenceIterator(BaseSentenceIterator):
    """In-memory list of sentences (CollectionSentenceIterator)."""

    def __init__(self, sentences: Iterable[str],
                 preprocessor: Optional[Callable[[str], str]] = None):
        super().__init__(preprocessor)
        self._sentences = list(sentences)

    def _lines(self) -> Iterator[str]:
        return iter(self._sentences)


class LabelledDocument:
    """documentiterator.LabelledDocument: content + label."""

    def __init__(self, content: str, label: str):
        self.content = content
        self.label = label


class FileLabelAwareIterator:
    """Directory-of-directories corpus: each subdirectory is a label, each
    file a document (documentiterator.FileLabelAwareIterator). Streams
    LabelledDocument objects; reset() restarts the walk."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        self.root = root
        self.encoding = encoding

    def __iter__(self) -> Iterator[LabelledDocument]:
        for label in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, label)
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                p = os.path.join(d, fname)
                if not os.path.isfile(p):
                    continue
                with open(p, "r", encoding=self.encoding,
                          errors="replace") as f:
                    yield LabelledDocument(f.read(), label)

    def reset(self):
        pass


class PhraseDetector:
    """word2phrase bigram collocation detection (Mikolov et al. 2013).

    score(a, b) = (count(ab) - delta) * N / (count(a) * count(b)); bigrams
    scoring above ``threshold`` merge into single ``a_b`` tokens. Run
    ``fit`` over tokenized sentences once, then ``transform`` token lists
    (or ``wrap`` a tokenized-sentence iterable); apply twice for trigrams+,
    exactly like chained word2phrase passes.
    """

    def __init__(self, min_count: int = 5, threshold: float = 10.0,
                 delimiter: str = "_"):
        self.min_count = min_count
        self.threshold = threshold
        self.delimiter = delimiter
        self.unigrams: Counter = Counter()
        self.bigrams: Counter = Counter()
        self.phrases: dict[tuple, str] = {}

    def fit(self, sentences: Iterable[List[str]]) -> "PhraseDetector":
        self.unigrams = Counter()           # refit replaces, never merges
        self.bigrams = Counter()
        for toks in sentences:
            self.unigrams.update(toks)
            self.bigrams.update(zip(toks, toks[1:]))
        total = sum(self.unigrams.values())
        delta = float(self.min_count)
        self.phrases = {}
        for (a, b), cab in self.bigrams.items():
            ca, cb = self.unigrams[a], self.unigrams[b]
            if cab < self.min_count:
                continue
            score = (cab - delta) * total / (ca * cb)
            if score > self.threshold:
                self.phrases[(a, b)] = f"{a}{self.delimiter}{b}"
        return self

    def score(self, a: str, b: str) -> float:
        total = sum(self.unigrams.values())
        ca, cb = self.unigrams.get(a, 0), self.unigrams.get(b, 0)
        cab = self.bigrams.get((a, b), 0)
        if not (ca and cb):
            return 0.0
        return (cab - float(self.min_count)) * total / (ca * cb)

    def transform(self, tokens: List[str]) -> List[str]:
        """Greedy left-to-right merge (word2phrase's output pass)."""
        out = []
        i = 0
        n = len(tokens)
        while i < n:
            if i + 1 < n and (tokens[i], tokens[i + 1]) in self.phrases:
                out.append(self.phrases[(tokens[i], tokens[i + 1])])
                i += 2
            else:
                out.append(tokens[i])
                i += 1
        return out

    def wrap(self, sentences: Iterable[List[str]]):
        """Lazily phrase-merge a tokenized-sentence stream (re-iterable if
        the source is)."""
        detector = self

        class _Wrapped:
            def __iter__(self):
                for toks in sentences:
                    yield detector.transform(toks)

            def reset(self):
                if hasattr(sentences, "reset"):
                    sentences.reset()

        return _Wrapped()
