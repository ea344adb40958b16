"""The port's BERT text front and tokenizer factories
(``deeplearning4j_tpu_torch/nlp/``) against the JAX package's, on the CPU.

``tests/test_nlp.py``'s ``TestTokenizers`` and ``TestBertFront`` run here
on the port's classes, and every tokenization and batch is held equal to
the JAX package's: both iterators draw their masked-LM selections from
numpy's generator, so under one seed the batches are equal bit for bit.
The two masked-LM training tests train the port's nets.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import BertIterator as JaxBertIterator
from deeplearning4j_tpu.nlp import BertWordPieceTokenizer as JaxTokenizer
from deeplearning4j_tpu.nlp import (
    DefaultTokenizerFactory as JaxDefault, NGramTokenizerFactory as JaxNGram,
)
from deeplearning4j_tpu.nlp.tokenizers import (
    CommonPreprocessor as JaxCommonPreprocessor,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp import (
    BertIterator, BertWordPieceTokenizer, CommonPreprocessor,
    DefaultTokenizerFactory, NGramTokenizerFactory,
)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "cat", "sat", "mat", "un", "##aff", "##able",
         "##s", "run", "##ning", ",", "."]


def _same_batches(port_it, jax_it):
    """Both iterators' batches, field by field, bit for bit; the port's."""
    port, jax = list(port_it), list(jax_it)
    assert len(port) == len(jax)
    for a, b in zip(port, jax):
        assert isinstance(a, DataSet)
        for f in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
    return port


class TestTokenizers:
    def test_default(self):
        tf = DefaultTokenizerFactory(CommonPreprocessor())
        assert tf.tokenize("Hello, World!") == ["hello", "world"]
        text = "It's a Test -- of the 3rd, TOKENIZER; ok?"
        assert tf.tokenize(text) == JaxDefault(
            JaxCommonPreprocessor()).tokenize(text)
        assert (DefaultTokenizerFactory(str.upper).tokenize(text)
                == JaxDefault(str.upper).tokenize(text))

    def test_ngram(self):
        tf = NGramTokenizerFactory(1, 2)
        toks = tf.tokenize("a b c")
        assert "a" in toks and "a b" in toks and "b c" in toks
        assert NGramTokenizerFactory(2, 3).tokenize("a b c d") == \
            JaxNGram(2, 3).tokenize("a b c d")


class TestBertFront:
    def _tok(self):
        return BertWordPieceTokenizer(VOCAB)

    def test_wordpiece_longest_match(self):
        tok = self._tok()
        assert tok.tokenize("unaffable") == ["un", "##aff", "##able"]
        assert tok.tokenize("running") == ["run", "##ning"]
        assert tok.tokenize("cats") == ["cat", "##s"]
        assert tok.tokenize("The cat, zzz.") == [
            "the", "cat", ",", "[UNK]", "."]
        text = "The unaffable cats, running. Sat mats zzz" + "x" * 120
        assert tok.tokenize(text) == JaxTokenizer(VOCAB).tokenize(text)
        assert tok.encode(text) == JaxTokenizer(VOCAB).encode(text)

    def test_vocab_file_round_trip(self, tmp_path):
        p = tmp_path / "vocab.txt"
        p.write_text("\n".join(VOCAB))
        tok = BertWordPieceTokenizer(str(p))
        assert tok.encode("the mat") == [5, 8]
        assert tok.vocab == JaxTokenizer(str(p)).vocab

    def test_seq_classification_batches(self):
        sents = [("the cat sat", "A"), ("the mat", "B"), ("cat cat cat", "A")]
        kw = dict(batch_size=2, max_len=8, task="seq_classification",
                  labels=["A", "B"])
        batches = _same_batches(BertIterator(self._tok(), sents, **kw),
                                JaxBertIterator(JaxTokenizer(VOCAB), sents,
                                                **kw))
        assert len(batches) == 2
        ds = batches[0]
        assert ds.features.shape == (2, 8) and ds.features.dtype == np.int32
        assert ds.features[0, 0] == 2            # [CLS]
        n_real = int(ds.features_mask[0].sum())
        assert ds.features[0, n_real - 1] == 3   # [SEP]
        assert (ds.features[0, n_real:] == 0).all()
        assert ds.labels.shape == (2, 2)
        assert ds.labels[0].argmax() == 0 and ds.labels[1].argmax() == 1

    @pytest.mark.parametrize("pad", [True, False])
    def test_trailing_batch_padded_to_fixed_shape(self, pad):
        sents = [("the cat", "A")] * 5          # 5 rows, batch 2 -> 2, 2, 1
        kw = dict(batch_size=2, max_len=8, task="seq_classification",
                  labels=["A", "B"], pad_minibatches=pad)
        batches = _same_batches(BertIterator(self._tok(), sents, **kw),
                                JaxBertIterator(JaxTokenizer(VOCAB), sents,
                                                **kw))
        assert [b.features.shape[0] for b in batches] == (
            [2, 2, 2] if pad else [2, 2, 1])
        if pad:
            tail = batches[-1]
            assert tail.features_mask[1].sum() == 0
            assert tail.labels[1].sum() == 0

    def test_mask_prob_zero_is_passthrough(self):
        kw = dict(batch_size=2, max_len=8, task="unsupervised", mask_prob=0.0)
        (ds,) = _same_batches(
            BertIterator(self._tok(), ["the cat sat"] * 2, **kw),
            JaxBertIterator(JaxTokenizer(VOCAB), ["the cat sat"] * 2, **kw))
        assert (ds.features == ds.labels).all()
        assert ds.labels_mask.sum() == 0

    def test_cls_without_sep_rejected(self):
        tok = BertWordPieceTokenizer(["[PAD]", "[UNK]", "[CLS]", "the"])
        with pytest.raises(ValueError, match="SEP"):
            BertIterator(tok, ["the"], task="seq_classification",
                         labels=["A"])

    @pytest.mark.parametrize("seed", [5, 11])
    def test_masked_lm_batches(self, seed):
        sents = ["the cat sat the mat the cat sat"] * 4 + ["un run , ."] * 3
        kw = dict(batch_size=4, max_len=16, task="unsupervised",
                  mask_prob=0.3, seed=seed)
        it = BertIterator(self._tok(), sents, **kw)
        jit = JaxBertIterator(JaxTokenizer(VOCAB), sents, **kw)
        ds = _same_batches(it, jit)[0]
        assert ds.labels_mask is not None and ds.labels_mask.sum() > 0
        sel = ds.labels_mask.astype(bool)
        assert (ds.labels[~sel] == ds.features[~sel]).all()
        assert (ds.features[sel] != ds.labels[sel]).mean() > 0.5
        assert not sel[:, 0].any()
        # deterministic under reset, and still equal to the JAX package's
        it.reset()
        assert (next(iter(it)).features == ds.features).all()
        it.reset()
        jit.reset()
        _same_batches(it, jit)

    def test_one_hot_batch(self):
        kw = dict(batch_size=3, max_len=8, task="unsupervised", seed=4)
        sents = ["the cat sat", "the mat", "cat sat mat"]
        it = BertIterator(self._tok(), sents, **kw)
        jit = JaxBertIterator(JaxTokenizer(VOCAB), sents, **kw)
        a = it.one_hot(next(iter(it)))
        b = jit.one_hot(next(iter(jit)))
        assert isinstance(a, DataSet) and a.labels.shape == (3, 8, len(VOCAB))
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))

    def test_generator_exhaustion_fails_loud(self):
        tok = BertWordPieceTokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                      "[MASK]", "the", "cat"])
        it = BertIterator(tok, (s for s in ["the cat"] * 3), batch_size=2,
                          max_len=8, task="unsupervised")
        assert len(list(it)) == 2
        with pytest.raises(ValueError, match="exhausted|resettable"):
            list(it)

    def _mlm_net(self, loss, seed):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.layers import (
            EmbeddingSequenceLayer, RnnOutputLayer,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.optimize.updaters import Adam

        V = len(VOCAB)
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Adam(lr=5e-3)).list()
                .layer(EmbeddingSequenceLayer(n_in=V, n_out=16))
                .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                      loss=loss))
                .set_input_type(InputType.recurrent(V, 16)).build())
        return MultiLayerNetwork(conf).init(device="cpu")

    def test_mlm_trains_with_sparse_labels(self):
        """sparse_mcxent takes the iterator's int-id labels directly."""
        net = self._mlm_net("sparse_mcxent", 4)
        it = BertIterator(self._tok(), ["the cat sat the mat",
                                        "the mat the cat"] * 6,
                          batch_size=12, max_len=16, task="unsupervised",
                          seed=2)
        ds = next(iter(it))
        s0 = float(net.score(ds))
        for _ in range(20):
            net.fit_batch(ds)
        s1 = float(net.score(ds))
        assert np.isfinite(s1) and s1 < s0, (s0, s1)

    def test_mlm_trains_through_graph_tier(self):
        """Masked-LM batches through one_hot into an mcxent head; the loss
        is masked by labels_mask."""
        net = self._mlm_net("mcxent", 3)
        it = BertIterator(self._tok(), ["the cat sat the mat",
                                        "the mat the cat",
                                        "cat sat mat"] * 4,
                          batch_size=12, max_len=16, task="unsupervised",
                          seed=1)
        ds = it.one_hot(next(iter(it)))
        s0 = float(net.score(ds))
        for _ in range(20):
            net.fit_batch(ds)
        s1 = float(net.score(ds))
        assert np.isfinite(s1) and s1 < s0, (s0, s1)


def test_nlp_exports_only_the_ported_modules():
    """Every module of the JAX package's nlp/ is ported: the port exports
    its whole ``__all__``, and besides it only CommonPreprocessor and the
    weights-across function."""
    import deeplearning4j_tpu.nlp as jax_nlp
    import deeplearning4j_tpu_torch.nlp as nlp

    assert sorted(nlp.__all__) == sorted(
        list(jax_nlp.__all__) + ["CommonPreprocessor", "load_jax_state"])
    for name in nlp.__all__:
        assert hasattr(nlp, name), name
