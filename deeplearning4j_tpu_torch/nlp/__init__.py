"""NLP tooling: the tokenizer factories and the BERT text front.

Counterpart of the part of ``deeplearning4j_tpu/nlp/`` that the port holds
so far (deeplearning4j-nlp's tokenization and BertIterator): numpy-only,
copied. Word2Vec, GloVe, ParagraphVectors and the corpus, vocabulary and
serializer modules are still to port.
"""

from deeplearning4j_tpu_torch.nlp.bert import BertIterator, BertWordPieceTokenizer
from deeplearning4j_tpu_torch.nlp.tokenizers import (
    CommonPreprocessor, DefaultTokenizerFactory, NGramTokenizerFactory,
)

__all__ = ["BertIterator", "BertWordPieceTokenizer", "CommonPreprocessor",
           "DefaultTokenizerFactory", "NGramTokenizerFactory"]
