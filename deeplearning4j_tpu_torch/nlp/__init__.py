"""NLP tooling.

Counterpart of ``deeplearning4j_tpu/nlp/`` (deeplearning4j-nlp): the
tokenizer factories, the BERT text front, the corpus iterators, the
vocabulary, the word2vec interchange formats and the native text front
are host code, copied; Word2Vec, GloVe and ParagraphVectors train with
tensor steps on the card (``device="cpu"`` when asked). Every name of the
JAX package's ``__all__`` is here, and ``CommonPreprocessor`` besides.
"""

from deeplearning4j_tpu_torch.nlp.bert import BertIterator, BertWordPieceTokenizer
from deeplearning4j_tpu_torch.nlp.corpus import (
    BasicLineIterator, CollectionSentenceIterator, FileLabelAwareIterator,
    FileSentenceIterator, LabelledDocument, LineSentenceIterator,
    PhraseDetector, SentencePreProcessor,
)
from deeplearning4j_tpu_torch.nlp.tokenizers import (
    CommonPreprocessor, DefaultTokenizerFactory, NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, load_jax_state
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.serializer import (
    load_word2vec, read_word_vectors, save_word2vec, write_word_vectors,
)

__all__ = ["DefaultTokenizerFactory", "NGramTokenizerFactory", "VocabCache",
           "Word2Vec", "Glove", "ParagraphVectors",
           "BasicLineIterator", "CollectionSentenceIterator",
           "FileLabelAwareIterator", "FileSentenceIterator",
           "LabelledDocument", "LineSentenceIterator", "PhraseDetector",
           "SentencePreProcessor", "BertIterator", "BertWordPieceTokenizer",
           "write_word_vectors", "read_word_vectors", "save_word2vec",
           "load_word2vec", "CommonPreprocessor", "load_jax_state"]
