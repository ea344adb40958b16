"""Tokenizer factories.

Counterpart of ``deeplearning4j_tpu/nlp/tokenizers.py``, copied (it uses no
framework). Reference analog: org.deeplearning4j.text.tokenization.tokenizerfactory.
{DefaultTokenizerFactory, NGramTokenizerFactory} and the TokenPreProcess
chain (CommonPreprocessor lowercases + strips punctuation).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional


class CommonPreprocessor:
    """Lowercase + strip punctuation (org.deeplearning4j...CommonPreprocessor)."""

    _punct = re.compile(r"[^\w\s]", re.UNICODE)

    def __call__(self, token: str) -> str:
        return self._punct.sub("", token.lower())


class DefaultTokenizerFactory:
    """Whitespace/word tokenizer (DefaultTokenizerFactory + DefaultTokenizer)."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def tokenize(self, text: str) -> List[str]:
        if type(self.preprocessor) is CommonPreprocessor:
            # line-level fast path (r5): one lowercase + one regex pass
            # over the whole line, then split — equivalent to the
            # per-token chain ([^\w\s] never touches whitespace, and
            # punctuation-only tokens vanish either way) but ~6x faster
            # on the streaming Word2Vec front, where tokenize dominated
            # the host profile
            return self.preprocessor(text).split()
        toks = text.split()
        if self.preprocessor:
            toks = [self.preprocessor(t) for t in toks]
        return [t for t in toks if t]

    create = tokenize  # reference naming: factory.create(text).getTokens()


class NGramTokenizerFactory(DefaultTokenizerFactory):
    """Word n-grams (NGramTokenizerFactory)."""

    def __init__(self, n_min: int = 1, n_max: int = 2,
                 preprocessor: Optional[Callable[[str], str]] = None):
        super().__init__(preprocessor)
        self.n_min, self.n_max = n_min, n_max

    def tokenize(self, text: str) -> List[str]:
        words = super().tokenize(text)
        out = []
        for n in range(self.n_min, self.n_max + 1):
            out.extend(" ".join(words[i:i + n])
                       for i in range(len(words) - n + 1))
        return out

    create = tokenize
