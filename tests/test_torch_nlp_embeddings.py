"""The port's embedding tier (``deeplearning4j_tpu_torch/nlp/``: Word2Vec,
GloVe, ParagraphVectors, the vocabulary, the corpus iterators, the
serializer and the native text front) against the JAX package's, on the
CPU.

Each update step is given the JAX step's inputs and held to its outputs
within ``TOL_STEP`` (f32, relative to the largest entry). Short
Python-front fits draw the same pairs and host negatives from one seed in
both packages and are held to ``TOL_FIT`` (``TOL_FIT_HS`` under
hierarchical softmax, whose AdaGrad steps divide by accumulators near 0
and so carry a step's rounding further: 6e-5 read after 3 epochs of the
CORPUS below). The device negatives' stream differs from the JAX
package's by design; they are held to the JAX draws replayed through the
port's single step, to their own replay bit for bit, and to
unigram^0.75 by a chi-square bound. ``tests/test_nlp.py``'s non-BERT
cases run here on the port's classes with ``device="cpu"``.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as jax_nlp
import deeplearning4j_tpu.nlp.glove as jax_glove
import deeplearning4j_tpu.nlp.paragraph_vectors as jax_pv
import deeplearning4j_tpu.nlp.word2vec as jax_w2v
import deeplearning4j_tpu_torch.nlp as nlp
import deeplearning4j_tpu_torch.nlp.glove as port_glove
import deeplearning4j_tpu_torch.nlp.paragraph_vectors as port_pv
import deeplearning4j_tpu_torch.nlp.word2vec as port_w2v
from deeplearning4j_tpu_torch.nlp import (
    DefaultTokenizerFactory, VocabCache, load_jax_state,
)
from deeplearning4j_tpu_torch.nlp.tokenizers import CommonPreprocessor
from test_nlp import CORPUS, _stdlib_corpus_lines

TOL_STEP = 1e-6      # one step, relative to the largest |entry|
TOL_FIT = 1e-5       # a short fit, relative to the largest |entry|
TOL_FIT_HS = 1e-4
TOL_HS_COLD = 2e-5   # read 5.4e-6 (see test_hs_steps_against_jax)

Word2Vec = functools.partial(nlp.Word2Vec, device="cpu")
Glove = functools.partial(nlp.Glove, device="cpu")
ParagraphVectors = functools.partial(nlp.ParagraphVectors, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread for this file's tests: tier-1 runs six
    workers over the machine's cores, and at the default pool size their
    OpenMP threads oversubscribe them (``test_words_nearest_analogy_form``
    took 379 s there against 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.tensor(np.asarray(a))


def _tables(V=60, D=8, seed=0):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    return rng, W, C


# ------------------------------------------------------------- the steps

def test_exports_equal_the_jax_all():
    assert set(jax_nlp.__all__) <= set(nlp.__all__)
    assert set(nlp.__all__) - set(jax_nlp.__all__) == {
        "CommonPreprocessor", "load_jax_state"}


def test_sg_neg_step_against_jax_and_untouched_rows_keep_their_bits():
    rng, W, C = _tables()
    V, B, K = W.shape[0], 32, 4
    # ids in the first half only, with duplicates: the second half is
    # never touched
    c, x = rng.integers(0, V // 2, (2, B)).astype(np.int32)
    n = rng.integers(0, V // 2, (B, K)).astype(np.int32)
    jw, jc, jl = jax_w2v._sg_neg_step(jnp.asarray(W), jnp.asarray(C), c, x,
                                      n, 0.05)
    pw, pc, pl = port_w2v._sg_neg_step(_t(W), _t(C), _t(c), _t(x), _t(n),
                                       0.05)
    assert rel(pw, jw) < TOL_STEP and rel(pc, jc) < TOL_STEP
    assert rel(pl, jl) < TOL_STEP
    np.testing.assert_array_equal(pw.numpy()[V // 2:], W[V // 2:])
    np.testing.assert_array_equal(pc.numpy()[V // 2:], C[V // 2:])


def test_cbow_neg_step_against_jax():
    rng, W, C = _tables(seed=1)
    V, B, K = W.shape[0], 32, 4
    ctx = rng.integers(0, V, (B, 6)).astype(np.int32)
    c = rng.integers(0, V, B).astype(np.int32)
    n = rng.integers(0, V, (B, K)).astype(np.int32)
    want = jax_w2v._cbow_neg_step(jnp.asarray(W), jnp.asarray(C), ctx, c, n,
                                  0.05)
    got = port_w2v._cbow_neg_step(_t(W), _t(C), _t(ctx), _t(c), _t(n), 0.05)
    for g, w in zip(got, want):
        assert rel(g, w) < TOL_STEP


def _huffman_inputs(seed=2, steps=None):
    rng, W, _ = _tables(seed=seed)
    V, B = W.shape[0], 32
    codes, points, mask = jax_w2v.build_huffman(rng.integers(1, 100, V))
    Th = (rng.normal(size=(V - 1, W.shape[1])) * 0.3).astype(np.float32)
    shape = (B,) if steps is None else (steps, B)
    c, x = rng.integers(0, V, (2,) + shape).astype(np.int32)
    return W, Th, c, x, codes, points, mask


@pytest.mark.parametrize("acc", ["warm", "zero"])
@pytest.mark.parametrize("steps", [None, 3])
def test_hs_steps_against_jax(steps, acc):
    """From warm accumulators within TOL_STEP. From zero ones the first
    update is lr g / sqrt(g^2 + 1e-8), whose slope at g = 0 is 1e4 lr: a
    gradient whose terms nearly cancel carries the summation order's
    rounding (1e-7 of the terms) up to 1e4 lr-fold, so that case is held
    to TOL_HS_COLD."""
    W, Th, c, x, codes, points, mask = _huffman_inputs(steps=steps)
    aW, aT = np.zeros_like(W), np.zeros_like(Th)
    if acc == "warm":
        rng = np.random.default_rng(8)
        aW, aT = (rng.random(a.shape).astype(np.float32) for a in (aW, aT))
    jfn = jax_w2v._sg_hs_step if steps is None else jax_w2v._sg_hs_steps
    pfn = port_w2v._sg_hs_step if steps is None else port_w2v._sg_hs_steps
    want = jfn(jnp.asarray(W), jnp.asarray(Th), jnp.asarray(aW),
               jnp.asarray(aT), c, x, codes, points, mask, 0.05)
    got = pfn(_t(W), _t(Th), _t(aW), _t(aT), _t(c), _t(x), _t(codes),
              _t(points), _t(mask), 0.05)
    for g, w in zip(got, want):
        assert rel(g, w) < (TOL_STEP if acc == "warm" else TOL_HS_COLD)


def test_glove_step_against_jax_with_biases_and_accumulators():
    rng, W, C = _tables(seed=3)
    V, E = W.shape[0], 50
    rows, cols = rng.integers(0, V // 2, (2, E)).astype(np.int32)
    logx = rng.normal(size=E).astype(np.float32)
    wt = rng.random(E).astype(np.float32)
    params = {"W": W, "C": C, "bw": rng.normal(size=V).astype(np.float32),
              "bc": rng.normal(size=V).astype(np.float32)}
    for k in ("W", "C", "bw", "bc"):
        params["acc_" + k] = rng.random(params[k].shape).astype(np.float32)
    want, wl = jax_glove._glove_step(
        {k: jnp.asarray(v) for k, v in params.items()}, rows, cols, logx,
        wt, lr=0.05)
    got, gl = port_glove._glove_step({k: _t(v) for k, v in params.items()},
                                     _t(rows), _t(cols), _t(logx), _t(wt),
                                     0.05)
    assert rel(gl, wl) < TOL_STEP
    for k in want:
        assert rel(got[k], want[k]) < TOL_STEP, k
        # AdaGrad over a zero gradient: untouched rows keep their bits
        np.testing.assert_array_equal(got[k].numpy()[V // 2:],
                                      params[k][V // 2:])


@pytest.mark.parametrize("train_words", [True, False])
def test_pvdm_step_against_jax(train_words):
    rng, W, C = _tables(seed=4)
    V, B, K = W.shape[0], 32, 4
    Dv = (rng.normal(size=(10, W.shape[1])) * 0.3).astype(np.float32)
    doc = rng.integers(0, 10, B).astype(np.int32)
    ctx = rng.integers(0, V, (B, 6)).astype(np.int32)
    c = rng.integers(0, V, B).astype(np.int32)
    n = rng.integers(0, V, (B, K)).astype(np.int32)
    want = jax_pv._pvdm_step(jnp.asarray(Dv), jnp.asarray(W), jnp.asarray(C),
                             doc, ctx, c, n, lr=0.05,
                             train_words=train_words)
    got = port_pv._pvdm_step(_t(Dv), _t(W), _t(C), _t(doc), _t(ctx), _t(c),
                             _t(n), 0.05, train_words=train_words)
    for g, w in zip(got, want):
        assert rel(g, w) < TOL_STEP
    if not train_words:
        np.testing.assert_array_equal(got[1].numpy(), W)


def _alias(V=40, seed=5):
    probs = VocabCache().fit(
        [[f"w{i}"] * int(c) for i, c in enumerate(
            np.random.default_rng(seed).integers(1, 50, V))]
    ).unigram_table_probs()
    return probs, nlp.vocab.build_alias_table(probs)


def test_devneg_steps_replay_jax_draws_and_their_own():
    """The JAX scan with its threefry negatives equals the port's single
    step fed those negatives; the port's scan, which draws its S steps'
    negatives in one call, equals its single step fed the same draws, bit
    for bit."""
    rng, W, C = _tables(V=40, seed=6)
    S, B, K = 3, 16, 4
    cs, xs = rng.integers(0, 40, (2, S, B)).astype(np.int32)
    _, (aprob, aalias) = _alias()
    key = jax.random.PRNGKey(3)
    jw, jc, jl = jax_w2v._sg_neg_steps_devneg(
        jnp.asarray(W), jnp.asarray(C), key, cs, xs, aprob, aalias, 0.05,
        k=K)
    pw, pc, total = _t(W), _t(C), 0.0
    for s in range(S):   # the scan body's draws, replayed
        key, k1, k2 = jax.random.split(key, 3)
        idx = jax.random.randint(k1, (B, K), 0, 40)
        u = jax.random.uniform(k2, (B, K))
        negs = np.asarray(jnp.where(u < aprob[idx], idx, aalias[idx]))
        pw, pc, loss = port_w2v._sg_neg_step(pw, pc, _t(cs[s]), _t(xs[s]),
                                             _t(negs), 0.05)
        total = total + loss
    assert rel(pw, jw) < TOL_STEP and rel(pc, jc) < TOL_STEP
    assert rel(total, jl) < TOL_STEP

    ta, tb = _t(aprob), _t(aalias)
    got = port_w2v._sg_neg_steps_devneg(
        _t(W), _t(C), torch.Generator().manual_seed(9), _t(cs), _t(xs), ta,
        tb, 0.05, K)
    negs = port_w2v.alias_negatives(torch.Generator().manual_seed(9), ta,
                                    tb, (S, B, K))
    rw, rc = _t(W), _t(C)
    for s in range(S):
        rw, rc, _ = port_w2v._sg_neg_step(rw, rc, _t(cs[s]), _t(xs[s]),
                                          negs[s], 0.05)
    assert torch.equal(got[0], rw) and torch.equal(got[1], rc)


def test_uint16_ids_widen_on_the_device():
    ids = np.array([0, 1, 40000, 65535], np.uint16)
    t = port_w2v._ids(torch.from_numpy(ids.view(np.int16)))
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), ids.astype(np.int64))


def test_alias_sampler_distribution_chi_square():
    """200,000 device-path draws against unigram^0.75: chi-square with 39
    degrees of freedom below 72.1 (p = 0.001)."""
    probs, (aprob, aalias) = _alias()
    n = 200_000
    draws = port_w2v.alias_negatives(torch.Generator().manual_seed(0),
                                     _t(aprob), _t(aalias), (n,))
    seen = np.bincount(draws.numpy(), minlength=len(probs))
    expected = probs.astype(np.float64) * n
    chi2 = float(((seen - expected) ** 2 / expected).sum())
    assert chi2 < 72.1, chi2


# -------------------------------------------------------------- the fits

@pytest.mark.parametrize("kw,tol", [
    (dict(), TOL_FIT),
    (dict(hs=True), TOL_FIT_HS),
    (dict(cbow=True), TOL_FIT),
    (dict(subsample=1e-2, min_learning_rate=0.001), TOL_FIT),
], ids=["sg_neg", "sg_hs", "cbow", "subsample_decay"])
def test_python_front_fit_against_jax(kw, tol):
    args = dict(vector_size=16, window=3, negative=4, epochs=3,
                learning_rate=0.02, batch_size=32, seed=7, **kw)
    want = jax_nlp.Word2Vec(**args).fit(CORPUS, chunk_sentences=16)
    got = Word2Vec(**args).fit(CORPUS, chunk_sentences=16)
    assert got.vocab.words == want.vocab.words
    assert isinstance(got.W, np.ndarray) and isinstance(got.C, np.ndarray)
    assert got.C.shape == want.C.shape
    assert rel(got.W, want.W) < tol and rel(got.C, want.C) < tol


def test_glove_fit_against_jax():
    args = dict(vector_size=16, window=3, epochs=30, x_max=10, seed=5)
    want = jax_nlp.Glove(**args).fit(CORPUS)
    got = Glove(**args).fit(CORPUS)
    assert rel(got.W, want.W) < TOL_FIT


def test_paragraph_vectors_fit_and_infer_against_jax():
    docs = (["the cat sat with the dog on the mat",
             "a dog and a cat played with the fish"] * 4
            + ["stocks rallied as the market closed higher",
               "investors bought stocks in heavy market trading"] * 4)
    args = dict(vector_size=16, window=3, negative=4, epochs=5,
                batch_size=32, seed=11)
    want = jax_nlp.ParagraphVectors(**args).fit(docs)
    got = ParagraphVectors(**args).fit(docs)
    for name in ("doc_vectors", "W", "C"):
        assert rel(getattr(got, name), getattr(want, name)) < TOL_FIT, name
    assert rel(got.infer_vector("the cat sat"),
               want.infer_vector("the cat sat")) < TOL_FIT


def test_load_jax_state_gives_the_same_models():
    j = jax_nlp.Word2Vec(vector_size=12, window=2, epochs=2, batch_size=64,
                         seed=3).fit(CORPUS)
    p = load_jax_state(Word2Vec(vector_size=12), j.vocab.words,
                       {"W": j.W, "C": j.C, "accW": np.ones_like(j.W)},
                       counts=j.vocab.counts)
    np.testing.assert_array_equal(p.W, j.W)
    assert p.words_nearest("cat", top=4) == j.words_nearest("cat", top=4)
    assert p.similarity("cat", "dog") == j.similarity("cat", "dog")
    assert p.vocab.counts == j.vocab.counts
    assert p.train_state["accW"].dtype == torch.float32

    g = jax_nlp.Glove(vector_size=8, window=2, epochs=5, seed=1).fit(CORPUS)
    pg = load_jax_state(Glove(vector_size=8), g.vocab.words,
                        {"W": g.W, "bw": np.zeros(len(g.vocab))})
    assert pg.words_nearest("stocks", top=3) == g.words_nearest("stocks",
                                                                top=3)
    assert set(pg.train_state) == {"bw"}

    docs = ["the cat sat on the mat"] * 4 + ["the market closed higher"] * 4
    pv = jax_nlp.ParagraphVectors(vector_size=8, window=2, epochs=3,
                                  seed=2).fit(docs)
    pp = load_jax_state(ParagraphVectors(vector_size=8, window=2, seed=2),
                        pv.vocab.words,
                        {"W": pv.W, "C": pv.C,
                         "doc_vectors": pv.doc_vectors},
                        counts=pv.vocab.counts, labels=pv.labels)
    assert pp.similarity("DOC_0", "DOC_5") == pv.similarity("DOC_0",
                                                            "DOC_5")
    assert rel(pp.infer_vector("the cat sat"),
               pv.infer_vector("the cat sat")) < TOL_FIT
    with pytest.raises(ValueError, match="rows"):
        load_jax_state(Word2Vec(), ["a"], {"W": np.zeros((2, 3))})


@pytest.mark.parametrize("binary", [False, True])
def test_word_vectors_cross_the_formats_both_ways(tmp_path, binary):
    port = Word2Vec(vector_size=12, window=2, epochs=2, batch_size=64,
                    seed=3).fit(CORPUS)
    jax_model = jax_nlp.Word2Vec(vector_size=12, window=2, epochs=2,
                                 batch_size=64, seed=4).fit(CORPUS)
    a, b = str(tmp_path / "port.vec"), str(tmp_path / "jax.vec")
    nlp.save_word2vec(port, a, binary=binary)
    jax_nlp.save_word2vec(jax_model, b, binary=binary)
    read_j = jax_nlp.load_word2vec(a, binary=binary)
    read_p = nlp.load_word2vec(b, binary=binary, device="cpu")
    assert read_j.vocab.words == port.vocab.words
    assert read_p.vocab.words == jax_model.vocab.words
    if binary:   # f32 bit-exact
        np.testing.assert_array_equal(read_j.W, port.W)
        np.testing.assert_array_equal(read_p.W, jax_model.W)
        assert read_p.words_nearest("cat", top=3) == \
            jax_model.words_nearest("cat", top=3)
    else:        # %.6g text
        np.testing.assert_allclose(read_j.W, port.W, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(read_p.W, jax_model.W, rtol=1e-4,
                                   atol=1e-5)


def test_entry_points_take_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for build in (nlp.Word2Vec, nlp.Glove, nlp.ParagraphVectors):
        with pytest.raises(RuntimeError, match="cuda"):
            build()


# ------------------------------------------ tests/test_nlp.py, on the port

class TestVocab:
    def test_fit_and_prune(self):
        v = VocabCache(min_count=2)
        v.fit([["a", "a", "b"], ["a", "b", "c"]])
        assert "a" in v and "b" in v and "c" not in v
        assert v.word_frequency("a") == 3
        assert v.words[0] == "a"

    def test_unigram_table(self):
        v = VocabCache().fit([["x", "x", "x", "y"]])
        p = v.unigram_table_probs()
        assert p.shape == (2,) and abs(p.sum() - 1) < 1e-6
        assert p[v.index_of("x")] > p[v.index_of("y")]


class TestWord2Vec:
    def test_skipgram_structure(self):
        w2v = Word2Vec(vector_size=32, window=3, negative=4, epochs=15,
                       learning_rate=0.01, batch_size=128, seed=7).fit(CORPUS)
        assert w2v.get_word_vector("cat").shape == (32,)
        assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "market")
        near = w2v.words_nearest("stocks", top=4)
        assert any(w in near for w in ("market", "investors", "trading",
                                       "rallied"))

    def test_cbow_runs(self):
        w2v = Word2Vec(vector_size=16, window=2, negative=3, epochs=3,
                       cbow=True, seed=3).fit(CORPUS)
        assert w2v.get_word_vector("dog") is not None
        assert np.isfinite(w2v.W).all()

    def test_save_load(self, tmp_path):
        w2v = Word2Vec(vector_size=8, epochs=1, seed=1).fit(CORPUS[:8])
        p = str(tmp_path / "w2v")
        w2v.save(p)
        loaded = nlp.Word2Vec.load(p, device="cpu")
        np.testing.assert_array_equal(loaded.W, w2v.W)
        assert loaded.vocab.index == w2v.vocab.index
        # and the JAX package reads the port's file
        np.testing.assert_array_equal(jax_nlp.Word2Vec.load(p).W, w2v.W)


class TestGlove:
    def test_structure(self):
        gl = Glove(vector_size=24, window=4, epochs=300, learning_rate=0.05,
                   x_max=10, seed=5).fit(CORPUS)
        assert gl.get_word_vector("cat").shape == (24,)
        assert gl.similarity("stocks", "market") > gl.similarity("stocks",
                                                                 "cat")
        assert gl.similarity("dog", "cat") > gl.similarity("dog", "trading")


class TestParagraphVectors:
    def test_doc_similarity(self):
        docs = (["the cat sat with the dog on the mat",
                 "a dog and a cat played with the fish"] * 4
                + ["stocks rallied as the market closed higher",
                   "investors bought stocks in heavy market trading"] * 4)
        labels = [f"animal_{i}" if i < 8 else f"fin_{i}"
                  for i in range(len(docs))]
        pv = ParagraphVectors(vector_size=24, window=3, negative=4,
                              epochs=30, learning_rate=0.08,
                              seed=11).fit(docs, labels)
        assert pv.get_doc_vector("animal_0").shape == (24,)
        assert (pv.similarity("animal_0", "animal_2")
                > pv.similarity("animal_0", "fin_8"))

    def test_infer_vector(self):
        docs = ["the cat sat on the mat"] * 4 + ["the market closed higher"] * 4
        pv = ParagraphVectors(vector_size=16, window=2, epochs=10,
                              seed=2).fit(docs)
        v = pv.infer_vector("the cat sat")
        assert v.shape == (16,) and np.isfinite(v).all()


class TestHierarchicalSoftmax:
    def test_huffman_codes_prefix_free_and_frequency_ordered(self):
        freqs = [50, 20, 10, 5, 5, 2]
        codes, points, mask = port_w2v.build_huffman(freqs)
        for got, want in zip((codes, points, mask),
                             jax_w2v.build_huffman(freqs)):
            np.testing.assert_array_equal(got, want)
        lens = mask.sum(1).astype(int)
        assert lens[0] == lens.min()
        assert lens[5] == lens.max()
        strs = ["".join(str(b) for b in codes[i, :lens[i]])
                for i in range(len(freqs))]
        for i in range(len(strs)):
            for j in range(len(strs)):
                if i != j:
                    assert not strs[j].startswith(strs[i])
        assert points.max() < len(freqs) - 1

    def test_hs_training_learns_cooccurrence(self):
        corpus = ["the cat sat on the mat", "the dog sat on the rug",
                  "cats and dogs and cats"] * 30
        w2v = Word2Vec(vector_size=16, window=2, min_count=1, epochs=8,
                       learning_rate=0.025, hs=True, seed=1).fit(corpus)
        v = w2v.get_word_vector("sat")
        assert v is not None and np.isfinite(v).all() and np.abs(v).sum() > 0
        assert w2v.similarity("sat", "on") > w2v.similarity("sat", "cats")


def test_cbow_hs_rejected():
    with pytest.raises(ValueError, match="cbow"):
        Word2Vec(cbow=True, hs=True).fit(["a b c a b c"])


def test_refit_rebuilds_huffman():
    w2v = Word2Vec(vector_size=8, window=2, epochs=2, hs=True, seed=0)
    w2v.fit(["a b c a b", "b c a"] * 10)
    w2v.fit(["p q r s t u v w x y z p q r"] * 10)
    v = w2v.get_word_vector("q")
    assert v is not None and np.isfinite(v).all()


def test_hs_default_lr_stays_bounded():
    corpus = ["the cat sat on the mat", "the dog sat on the rug"] * 40
    w2v = Word2Vec(vector_size=16, window=2, epochs=8, hs=True,
                   seed=3).fit(corpus)
    norms = np.linalg.norm(w2v.W, axis=1)
    assert np.isfinite(norms).all() and norms.max() < 10.0, norms.max()


class TestCorpusStreaming:
    def test_line_iterator_streams_and_resets(self, tmp_path):
        p = tmp_path / "corpus.txt"
        p.write_text("The CAT sat\n\nthe dog RAN\n")
        it = nlp.LineSentenceIterator(
            str(p), preprocessor=nlp.SentencePreProcessor())
        assert list(it) == ["the cat sat", "the dog ran"]
        assert list(it) == ["the cat sat", "the dog ran"]

    def test_file_sentence_iterator_walks_directory(self, tmp_path):
        (tmp_path / "b.txt").write_text("second file line\n")
        (tmp_path / "a.txt").write_text("first file line\n")
        it = nlp.FileSentenceIterator(str(tmp_path))
        assert list(it) == ["first file line", "second file line"]

    def test_phrase_detector_merges_collocations(self):
        sents = ([["flights", "to", "new", "york", "leave", "daily"],
                  ["the", "new", "york", "office", "opened"],
                  ["she", "moved", "to", "new", "york", "last", "year"],
                  ["the", "office", "opened", "early"],
                  ["flights", "leave", "the", "airport", "daily"]] * 4)
        det = nlp.PhraseDetector(min_count=5, threshold=5.0).fit(sents)
        assert det.phrases == jax_nlp.PhraseDetector(
            min_count=5, threshold=5.0).fit(sents).phrases
        assert ("new", "york") in det.phrases
        assert ("the", "new") not in det.phrases
        merged = det.transform(["flights", "to", "new", "york", "daily"])
        assert merged == ["flights", "to", "new_york", "daily"]
        w2v = Word2Vec(vector_size=16, window=2, min_count=2, epochs=1,
                       seed=1).fit(det.wrap(sents))
        assert "new_york" in w2v.vocab

    def test_subsample_keep_probs_monotone(self):
        v = VocabCache(min_count=1)
        v.fit([["a"] * 100 + ["b"] * 10 + ["c"]])
        keep = v.subsample_keep_probs(1e-2)
        ia, ib, ic = v.index_of("a"), v.index_of("b"), v.index_of("c")
        assert keep[ia] < keep[ib] <= keep[ic]

    def test_word2vec_trains_from_real_files(self, tmp_path):
        """Real text from files with subsampling: co-occurring words end
        up closer than random pairs, on mean-centered vectors (as the JAX
        test measures it)."""
        lines = _stdlib_corpus_lines(3000)
        assert len(lines) >= 1500
        third = len(lines) // 3
        for i in range(3):
            (tmp_path / f"part{i}.txt").write_text(
                "\n".join(lines[i * third:(i + 1) * third]))
        it = nlp.FileSentenceIterator(str(tmp_path))
        w2v = Word2Vec(vector_size=48, window=5, min_count=8, negative=5,
                       epochs=6, subsample=1e-3, seed=7)
        w2v.fit(it)
        assert len(w2v.vocab) > 150
        Wc = w2v.W - w2v.W.mean(0)
        Wn = Wc / np.maximum(np.linalg.norm(Wc, axis=1, keepdims=True),
                             1e-12)

        def sim(a, b):
            return float(Wn[w2v.vocab.index_of(a)]
                         @ Wn[w2v.vocab.index_of(b)])

        det = nlp.PhraseDetector(min_count=1, threshold=0.0)
        det.fit(w2v.tokenizer.tokenize(l) for l in lines)
        rng = np.random.default_rng(0)
        co = [(a, b) for (a, b), c in det.bigrams.most_common(300)
              if a != b and a in w2v.vocab and b in w2v.vocab][:40]
        assert len(co) >= 20
        words = w2v.vocab.words
        rand_sims = [sim(words[rng.integers(len(words))],
                         words[rng.integers(len(words))])
                     for _ in range(400)]
        assert (np.mean([sim(a, b) for a, b in co])
                > np.mean(rand_sims) + 0.1)

    def test_paragraph_vectors_from_label_aware_iterator(self, tmp_path):
        (tmp_path / "animals").mkdir()
        (tmp_path / "finance").mkdir()
        for i in range(3):
            (tmp_path / "animals" / f"d{i}.txt").write_text(
                "the cat and the dog played in the garden all day")
            (tmp_path / "finance" / f"d{i}.txt").write_text(
                "stocks rallied and the market closed higher on trading")
        it = nlp.FileLabelAwareIterator(str(tmp_path))
        pv = ParagraphVectors(vector_size=24, window=2, min_count=1,
                              epochs=20, seed=3).fit(it)
        assert sorted(set(pv.labels)) == ["animals", "finance"]
        assert pv.doc_vectors.shape == (6, 24)
        assert np.isfinite(pv.doc_vectors).all()


class TestNativeTextFront:
    """The native concurrent front over the port's build of
    native/dl4jtpu_native.cpp, feeding the port's device steps."""

    @pytest.fixture(autouse=True)
    def _require_native(self):
        from deeplearning4j_tpu_torch.native.lib import native_available

        assert native_available(), "g++ build of the native library failed"

    def test_stream_pairs_respect_window_and_counters(self, tmp_path):
        from deeplearning4j_tpu_torch.nlp.native_text import (
            NativeSkipGramStream,
        )

        rng = np.random.default_rng(0)
        words = [f"w{i}" for i in range(40)]
        lines = [" ".join(rng.choice(words, rng.integers(3, 12)))
                 for _ in range(200)]
        p = tmp_path / "c.txt"
        p.write_text("\n".join(lines))
        idx = {w: i for i, w in enumerate(words)}
        tok = DefaultTokenizerFactory(CommonPreprocessor())
        sents = [[idx[t] for t in tok.tokenize(l)] for l in lines]
        window, B, K = 3, 32, 4
        valid = set()
        for ids in sents:
            for i in range(len(ids)):
                for d in range(1, window + 1):
                    if i + d < len(ids):
                        valid.add((ids[i], ids[i + d]))
                        valid.add((ids[i + d], ids[i]))
        probs = np.ones(len(words), np.float32) / len(words)
        s = NativeSkipGramStream(str(p), words, probs, None, window=window,
                                 negative=K, batch=B, seed=7, n_threads=3)
        n_pairs = 0
        for c, x, neg in s:
            assert c.shape == (B,) and x.shape == (B,)
            assert neg.shape == (B, K)
            assert ((neg >= 0) & (neg < len(words))).all()
            for a, b in zip(c.tolist(), x.tolist()):
                assert (a, b) in valid
            n_pairs += B
        assert s.pairs_emitted == n_pairs
        assert s.words_seen == sum(len(ids) for ids in sents)
        s.reset()
        assert sum(1 for _ in s) > 0
        s.close()

    def test_fit_native_front_learns_and_matches_vocab(self, tmp_path):
        """Quality at one worker thread: the native front's batch order is
        then the seed's alone (at more threads it depends on the run)."""
        p = tmp_path / "corpus.txt"
        p.write_text("\n".join(CORPUS))
        w2v = Word2Vec(vector_size=32, window=3, negative=4, epochs=15,
                       learning_rate=0.01, batch_size=128, seed=7, workers=1)
        w2v.fit(nlp.LineSentenceIterator(str(p)), native_front=True)
        ref = VocabCache(min_count=1)
        ref.fit(w2v._iter_token_sents(CORPUS))
        assert set(w2v.vocab.words) == set(ref.words)
        assert {w: w2v.vocab.counts[w] for w in ref.words} == dict(ref.counts)
        Wc = w2v.W - w2v.W.mean(0)
        Wn = Wc / np.maximum(np.linalg.norm(Wc, axis=1, keepdims=True), 1e-12)

        def sim(a, b):
            return float(Wn[w2v.vocab.index_of(a)] @ Wn[w2v.vocab.index_of(b)])

        assert sim("cat", "dog") > sim("cat", "market") + 0.1

    def test_fit_native_front_multithread_matches_vocab(self, tmp_path):
        """At four worker threads (a run-dependent batch order) what holds
        in any order: the vocabulary, its counts, finite vectors."""
        p = tmp_path / "corpus.txt"
        p.write_text("\n".join(CORPUS))
        w2v = Word2Vec(vector_size=16, window=3, negative=4, epochs=2,
                       batch_size=128, seed=7, workers=4)
        w2v.fit(nlp.LineSentenceIterator(str(p)), native_front=True)
        ref = VocabCache(min_count=1)
        ref.fit(w2v._iter_token_sents(CORPUS))
        assert set(w2v.vocab.words) == set(ref.words)
        assert {w: w2v.vocab.counts[w] for w in ref.words} == dict(ref.counts)
        assert np.isfinite(w2v.W).all()

    def test_fit_native_front_hierarchical_softmax(self, tmp_path):
        p = tmp_path / "corpus.txt"
        p.write_text("\n".join(CORPUS))
        w2v = Word2Vec(vector_size=32, window=3, hs=True, negative=0,
                       epochs=15, batch_size=128, seed=3, workers=1)
        w2v.fit(nlp.LineSentenceIterator(str(p)), native_front=True)
        assert np.isfinite(w2v.W).all()
        assert (w2v.similarity("cat", "dog")
                > w2v.similarity("cat", "market") + 0.2)

    def test_native_front_true_raises_without_file_corpus(self):
        with pytest.raises(ValueError, match="native_front=True"):
            Word2Vec(vector_size=8).fit(CORPUS, native_front=True)

    def test_native_front_with_lr_decay(self, tmp_path):
        p = tmp_path / "corpus.txt"
        p.write_text("\n".join(CORPUS))
        w2v = Word2Vec(vector_size=16, window=3, negative=4, epochs=6,
                       batch_size=64, learning_rate=0.02,
                       min_learning_rate=0.001, seed=7)
        w2v.fit(nlp.LineSentenceIterator(str(p)), native_front=True)
        assert np.isfinite(w2v.W).all()
        assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "market")

    def test_python_fallback_forced_and_deterministic(self, tmp_path):
        p = tmp_path / "corpus.txt"
        p.write_text("\n".join(CORPUS[:16]))
        fits = [Word2Vec(vector_size=8, window=2, epochs=2, batch_size=64,
                         seed=5).fit(nlp.LineSentenceIterator(str(p)),
                                     native_front=False)
                for _ in range(2)]
        np.testing.assert_array_equal(fits[0].W, fits[1].W)

    def test_non_ascii_corpus_auto_falls_back_to_python(self, tmp_path):
        p = tmp_path / "corpus.txt"
        p.write_text("the café sat on the mat\n" * 20, encoding="utf-8")
        w2v = Word2Vec(vector_size=8, window=2, epochs=1, batch_size=32,
                       seed=1)
        w2v.fit(nlp.LineSentenceIterator(str(p)))
        assert "café" in w2v.vocab.index

    def test_late_non_ascii_detected_by_sampling(self, tmp_path):
        p = tmp_path / "corpus.txt"
        ascii_mb = ("the cat sat on the mat " * 64 + "\n").encode()
        with open(p, "wb") as f:
            for _ in range(1600):
                f.write(ascii_mb)
            f.write("the café sat on the mat\n".encode("utf-8") * 50)
        assert not nlp.Word2Vec._ascii_sample(str(p))
        p2 = tmp_path / "corpus2.txt"
        with open(p2, "wb") as f:
            for _ in range(800):
                f.write(ascii_mb)
            f.write("naïve déjà vu\n".encode("utf-8") * 50)
            for _ in range(800):
                f.write(ascii_mb)
        assert not nlp.Word2Vec._ascii_sample(str(p2))
        p3 = tmp_path / "corpus3.txt"
        with open(p3, "wb") as f:
            for _ in range(1600):
                f.write(ascii_mb)
        assert nlp.Word2Vec._ascii_sample(str(p3))

    def test_closed_stream_raises_instead_of_segfaulting(self, tmp_path):
        from deeplearning4j_tpu_torch.nlp.native_text import (
            NativeSkipGramStream,
        )

        p = tmp_path / "c.txt"
        p.write_text("a b c d e\n" * 5)
        s = NativeSkipGramStream(str(p), ["a", "b", "c", "d", "e"],
                                 np.ones(5, np.float32) / 5, None,
                                 window=2, negative=2, batch=4, seed=1,
                                 n_threads=2)
        s.close()
        s.close()
        for read in (s.reset, lambda: s.words_seen,
                     lambda: next(iter(s))):
            with pytest.raises(RuntimeError, match="closed"):
                read()

    def test_close_during_iteration_raises(self, tmp_path):
        from deeplearning4j_tpu_torch.nlp.native_text import (
            NativeSkipGramStream,
        )

        p = tmp_path / "c.txt"
        p.write_text("a b c d e f g h\n" * 400)
        s = NativeSkipGramStream(str(p), list("abcdefgh"),
                                 np.ones(8, np.float32) / 8, None,
                                 window=2, negative=2, batch=16, seed=1,
                                 n_threads=2)
        it = iter(s)
        next(it)
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            next(it)

    def test_words_seen_advances_mid_epoch(self, tmp_path):
        from deeplearning4j_tpu_torch.nlp.native_text import (
            NativeSkipGramStream,
        )

        p = tmp_path / "c.txt"
        p.write_text("a b c d e f g h\n" * 2000)
        s = NativeSkipGramStream(str(p), list("abcdefgh"),
                                 np.ones(8, np.float32) / 8, None,
                                 window=2, negative=2, batch=64, seed=1,
                                 n_threads=2, queue_cap=2)
        it = iter(s)
        for _ in range(3):
            next(it)
        assert s.words_seen > 0
        assert sum(1 for _ in it) > 0
        assert s.words_seen == 16000
        s.close()


class TestWordVectorSerializer:
    def _fitted(self):
        return Word2Vec(vector_size=12, window=2, epochs=2, batch_size=64,
                        seed=3).fit(CORPUS)

    def test_text_round_trip(self, tmp_path):
        w2v = self._fitted()
        p = str(tmp_path / "vecs.txt")
        nlp.save_word2vec(w2v, p)
        lines = open(p).read().splitlines()
        assert lines[0] == f"{len(w2v.vocab)} 12"
        back = nlp.load_word2vec(p, device="cpu")
        assert back.vocab.words == w2v.vocab.words
        np.testing.assert_allclose(back.W, w2v.W, rtol=1e-4, atol=1e-5)
        assert back.words_nearest("cat", top=3) == w2v.words_nearest(
            "cat", top=3)

    def test_binary_round_trip_exact(self, tmp_path):
        w2v = self._fitted()
        p = str(tmp_path / "vecs.bin")
        nlp.save_word2vec(w2v, p, binary=True)
        back = nlp.load_word2vec(p, binary=True, device="cpu")
        assert back.vocab.words == w2v.vocab.words
        np.testing.assert_array_equal(back.W, w2v.W)

    def test_headerless_text_tolerated(self, tmp_path):
        p = tmp_path / "noheader.txt"
        p.write_text("alpha 1 2 3\nbeta 4 5 6\n")
        words, W = nlp.read_word_vectors(str(p))
        assert words == ["alpha", "beta"]
        np.testing.assert_array_equal(W, [[1, 2, 3], [4, 5, 6]])

    def test_headerless_first_word_with_space(self, tmp_path):
        p = tmp_path / "multi.txt"
        p.write_text("new york 1 2 3\nparis 4 5 6\n")
        words, W = nlp.read_word_vectors(str(p))
        assert words == ["new york", "paris"]
        np.testing.assert_array_equal(W, [[1, 2, 3], [4, 5, 6]])
        bad = tmp_path / "nofloats.txt"
        bad.write_text("just words here\n")
        with pytest.raises(ValueError, match="no trailing float"):
            nlp.read_word_vectors(str(bad))

    def test_text_reader_fails_loud_on_malformed_input(self, tmp_path):
        p = tmp_path / "messy.txt"
        p.write_text("\n\n2 3\nalpha\t1 2  3\nbeta 4 5 6\n")
        words, _ = nlp.read_word_vectors(str(p))
        assert words == ["alpha", "beta"]
        cases = {"bad.txt": ("3 3\nalpha 1 2 3\n", "declares 3"),
                 "short.txt": ("2 3\nalpha 1 2 3\nbeta 4 5\n",
                               "short.txt:3"),
                 "empty.txt": ("\n", "empty"),
                 "nf.txt": ("1 3\nnew york 1 2\n", "nf.txt:2.*floats"),
                 "lb.txt": ("\n\n2 3\nalpha 1 2 3\nbeta 4 5\n", "lb.txt:5")}
        for name, (text, match) in cases.items():
            f = tmp_path / name
            f.write_text(text)
            with pytest.raises(ValueError, match=match):
                nlp.read_word_vectors(str(f))


def test_words_nearest_analogy_form():
    lines = []
    for _ in range(300):
        lines.append("paris is the capital of france")
        lines.append("rome is the capital of italy")
        lines.append("cats and dogs play in gardens")
    w2v = Word2Vec(vector_size=24, window=3, negative=4, epochs=10,
                   learning_rate=0.01, batch_size=128, seed=2).fit(lines)
    near = w2v.words_nearest(positive=["france", "rome"],
                             negative=["paris"], top=3)
    assert "italy" in near, near
    assert w2v.words_nearest("paris", top=5)
    assert w2v.words_nearest(positive=["nosuchword"]) == []
    assert w2v.words_nearest(negative=["paris"]) == []


def test_glove_words_nearest_and_pv_nearest_labels():
    gl = Glove(vector_size=16, window=3, epochs=150, learning_rate=0.05,
               x_max=10, seed=5).fit(CORPUS)
    near = gl.words_nearest("stocks", top=4)
    assert len(near) == 4 and "stocks" not in near
    assert gl.words_nearest(positive=["nosuchword"]) == []
    docs = (["the cat sat with the dog on the mat"] * 4
            + ["stocks rallied as the market closed higher"] * 4)
    labels = [f"animal_{i}" if i < 4 else f"fin_{i}" for i in range(8)]
    pv = ParagraphVectors(vector_size=24, window=3, negative=4, epochs=30,
                          learning_rate=0.08, seed=11).fit(docs, labels)
    near = pv.nearest_labels("the cat and the dog played", top=3)
    assert len(near) == 3
    assert near[0].startswith("animal"), near


def test_min_learning_rate_linear_decay():
    w2v = Word2Vec(vector_size=8, learning_rate=0.02,
                   min_learning_rate=0.005)
    w2v.vocab._total = 1000
    w2v.epochs = 1
    assert w2v._lr_at(0, 1000) == pytest.approx(0.02)
    assert w2v._lr_at(500, 1000) == pytest.approx(0.01)
    assert w2v._lr_at(950, 1000) == pytest.approx(0.005)
    assert w2v._lr_at(2000, 1000) == pytest.approx(0.005)
    fixed = Word2Vec(vector_size=8, learning_rate=0.02)
    assert fixed._lr_at(500, 1000) == 0.02
    m = Word2Vec(vector_size=16, window=2, epochs=4, batch_size=64, seed=7,
                 learning_rate=0.02, min_learning_rate=0.001).fit(CORPUS)
    assert np.isfinite(m.W).all()
    assert m.similarity("cat", "dog") > m.similarity("cat", "market")


@pytest.mark.cuda
def test_steps_on_the_card_against_the_cpu():
    """Each step on the card against the same step on the CPU, TF32 off,
    deterministic index_add_: within TOL_STEP."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    try:
        rng, W, C = _tables()
        V, B, K = W.shape[0], 64, 5
        c, x = rng.integers(0, V, (2, B)).astype(np.int32)
        n = rng.integers(0, V, (B, K)).astype(np.int32)
        want = port_w2v._sg_neg_step(_t(W), _t(C), _t(c), _t(x), _t(n), 0.05)
        got = port_w2v._sg_neg_step(*(_t(a).cuda() for a in (W, C, c, x, n)),
                                    0.05)
        for g, w in zip(got, want):
            assert rel(g.cpu(), w) < TOL_STEP
    finally:
        torch.use_deterministic_algorithms(False)
