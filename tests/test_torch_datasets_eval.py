"""The port's datasets and evaluation against the JAX package.

Both are host numpy, so the port copies them: the synthetic MNIST and
CIFAR / SVHN stand-ins come out as the same bytes from the same seeds,
the iterators give the same batches (shuffled with the same generator),
the normalizers the same statistics, and Evaluation, EvaluationBinary,
EvaluationCalibration, RegressionEvaluation, ROC and ROCMultiClass the same
numbers on the same predictions. The prefetching iterator stages batches
as tensors on the device it is given.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import datasets as jds
from deeplearning4j_tpu import eval as jev
from deeplearning4j_tpu.datasets import cifar as jax_cifar, mnist as jax_mnist
from deeplearning4j_tpu_torch import datasets as pds
from deeplearning4j_tpu_torch import eval as pev
from deeplearning4j_tpu_torch.datasets import cifar, mnist


def _batches(it):
    return [(b.features, b.labels) for b in it]


def _same_batches(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        assert fa.tobytes() == np.asarray(fb).tobytes()
        assert la.tobytes() == np.asarray(lb).tobytes()


@pytest.fixture(autouse=True)
def _no_data_dirs(monkeypatch, tmp_path):
    """Both packages fall back to their synthetic stand-ins."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mnist, "_SEARCH_DIRS", [str(tmp_path / "none")])
    monkeypatch.setattr(jax_mnist, "_SEARCH_DIRS", [str(tmp_path / "none")])


@pytest.mark.parametrize("n,seed", [(37, 0), (64, 123), (5, 9)])
def test_synthetic_mnist_bit_identical(n, seed):
    x, y = mnist._synthetic_mnist(n, seed)
    jx, jy = jax_mnist._synthetic_mnist(n, seed)
    assert x.dtype == jx.dtype and x.shape == (n, 28, 28, 1)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


@pytest.mark.parametrize("n,classes,seed,size", [(21, 10, 0, 32),
                                                 (8, 4, 5, 16)])
def test_synthetic_images_bit_identical(n, classes, seed, size):
    x, y = cifar._synthetic_images(n, classes, seed, size)
    jx, jy = jax_cifar._synthetic_images(n, classes, seed, size)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


@pytest.mark.parametrize("kind", ["mnist", "emnist", "cifar", "svhn"])
@pytest.mark.parametrize("train", [True, False])
def test_iterators_give_the_jax_batches(kind, train):
    cls = {"mnist": "MnistDataSetIterator", "emnist": "EmnistDataSetIterator",
           "cifar": "Cifar10DataSetIterator",
           "svhn": "SvhnDataSetIterator"}[kind]
    it = getattr(pds, cls)(16, train=train, seed=4, n_examples=40)
    jit = getattr(jds, cls)(16, train=train, seed=4, n_examples=40)
    assert it.synthetic and jit.synthetic
    for _ in range(2):  # a second epoch reshuffles alike
        _same_batches(_batches(it), _batches(jit))
        it.reset()
        jit.reset()


def test_array_list_iterators_and_dataset_ops():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 10)]
    for kw in ({}, {"shuffle": True, "seed": 3}, {"drop_last": True}):
        _same_batches(_batches(pds.ArrayDataSetIterator(x, y, 4, **kw)),
                      _batches(jds.ArrayDataSetIterator(x, y, 4, **kw)))
    ds, jd = pds.DataSet(x, y), jds.DataSet(x, y)
    _same_batches([(d.features, d.labels) for d in ds.batch_by(3)],
                  [(d.features, d.labels) for d in jd.batch_by(3)])
    s, js = ds.shuffle(5), jd.shuffle(5)
    assert s.features.tobytes() == js.features.tobytes()
    tr, te = ds.split_test_and_train(7)
    assert tr.num_examples() == 7 and te.num_examples() == 3
    lst = pds.ListDataSetIterator(ds.batch_by(4))
    assert lst.batch == 4 and len(list(lst)) == 3
    m = pds.MultiDataSet([x, x], {"o": y}, labels_mask=[None])
    jm = jds.MultiDataSet([x, x], {"o": y}, labels_mask=[None])
    for a, b in zip(m.shuffle(2).batches(4), jm.shuffle(2).batches(4)):
        assert a.features[1].tobytes() == b.features[1].tobytes()
        assert a.labels["o"].tobytes() == b.labels["o"].tobytes()


def test_dataset_save_load(tmp_path):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    pds.DataSet(x, y, labels_mask=np.ones((4,), np.float32)).save(
        str(tmp_path / "d.npz"))
    back = jds.DataSet.load(str(tmp_path / "d.npz"))
    np.testing.assert_array_equal(back.features, x)
    assert back.labels_mask is not None


@pytest.mark.parametrize("norm", ["NormalizerStandardize",
                                  "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler"])
def test_normalizers_match_jax(norm):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(12, 2, 3)) * 40 + 100).astype(np.float32)
    y = np.zeros((12, 1), np.float32)
    n = getattr(pds, norm)().fit(pds.ArrayDataSetIterator(x, y, 5))
    jn = getattr(jds, norm)().fit(jds.ArrayDataSetIterator(x, y, 5))
    a = n.transform(pds.DataSet(x.copy(), y))
    b = jn.transform(jds.DataSet(x.copy(), y))
    assert a.features.tobytes() == b.features.tobytes()
    np.testing.assert_allclose(n.revert(a).features, jn.revert(b).features)


def test_iterator_preprocessor_applies():
    x = np.full((4, 2), 255.0, np.float32)
    it = pds.ArrayDataSetIterator(x, np.zeros((4, 1), np.float32), 2)
    it.set_preprocessor(pds.ImagePreProcessingScaler())
    assert all(np.all(b.features == 1.0) for b in it)


def test_prefetch_iterator_stages_tensors_and_propagates_errors():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    y = np.eye(3, dtype=np.float32)[np.arange(12) % 3]
    it = pds.AsyncPrefetchIterator(pds.ArrayDataSetIterator(x, y, 5),
                                   device="cpu")
    got = list(it)
    assert [type(b.features) for b in got] == [torch.Tensor] * 3
    np.testing.assert_array_equal(torch.cat([b.features for b in got]), x)
    raw = list(pds.AsyncPrefetchIterator(pds.ArrayDataSetIterator(x, y, 5),
                                         device_put=False))
    assert isinstance(raw[0].features, np.ndarray)

    class Broken(pds.DataSetIterator):
        def _produce(self):
            yield pds.DataSet(x[:2], y[:2])
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(pds.AsyncPrefetchIterator(Broken(2), device="cpu"))


def test_real_iterators_match_jax():
    pytest.importorskip("sklearn")
    _same_batches(_batches(pds.DigitsDataSetIterator(64, train=False)),
                  _batches(jds.DigitsDataSetIterator(64, train=False)))
    a = pds.TabularDataSetIterator("wine", 32, train=True)
    b = jds.TabularDataSetIterator("wine", 32, train=True)
    _same_batches(_batches(a), _batches(b))
    assert (a.n_classes, a.n_features) == (b.n_classes, b.n_features)


# --------------------------------------------------------------- eval
def _preds(rng, shape, classes):
    p = rng.random(shape + (classes,)).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("case", ["onehot", "sparse", "sequence_masked"])
def test_evaluation_matches_jax(case):
    rng = np.random.default_rng(4)
    if case == "sequence_masked":
        labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (5, 6))]
        preds, mask = _preds(rng, (5, 6), 4), rng.random((5, 6)) > 0.3
    else:
        ids = rng.integers(0, 4, 30)
        labels = ids if case == "sparse" else np.eye(4, dtype=np.float32)[ids]
        preds, mask = _preds(rng, (30,), 4), None
    e, je = pev.Evaluation(), jev.Evaluation()
    for ev in (e, je):
        ev.eval(labels, preds, mask=mask)
        ev.eval(labels, preds, mask=mask)
    np.testing.assert_array_equal(e.cm.matrix, je.cm.matrix)
    for name in ("accuracy", "precision", "recall", "f1", "top_n_accuracy",
                 "num_examples"):
        assert getattr(e, name)() == getattr(je, name)()
    assert [e.matthews_correlation(c) for c in range(4)] == [
        je.matthews_correlation(c) for c in range(4)]
    assert e.stats() == je.stats()


def test_binary_calibration_regression_roc_match_jax():
    rng = np.random.default_rng(5)
    lab = (rng.random((40, 3)) > 0.5).astype(np.float32)
    pred = rng.random((40, 3)).astype(np.float32)
    b, jb = pev.EvaluationBinary(), jev.EvaluationBinary()
    c, jc = pev.EvaluationCalibration(), jev.EvaluationCalibration()
    r, jr = pev.RegressionEvaluation(), jev.RegressionEvaluation()
    roc, jroc = pev.ROC(50), jev.ROC(50)
    mc, jmc = pev.ROCMultiClass(50), jev.ROCMultiClass(50)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]
    probs = _preds(rng, (40,), 3)
    for mine, theirs, args in (
            (b, jb, (lab, pred)), (c, jc, (onehot, probs)),
            (r, jr, (lab, pred)), (roc, jroc, (lab[:, 0], pred[:, 0])),
            (mc, jmc, (onehot, probs))):
        mine.eval(*args)
        theirs.eval(*args)
    assert [b.f1(i) for i in range(3)] == [jb.f1(i) for i in range(3)]
    assert [b.accuracy(i) for i in range(3)] == [jb.accuracy(i)
                                                 for i in range(3)]
    assert c.expected_calibration_error() == jc.expected_calibration_error()
    for col in range(3):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "relative_squared_error",
                     "pearson_correlation", "r_squared"):
            assert getattr(r, name)(col) == getattr(jr, name)(col)
    assert r.stats() == jr.stats()
    assert roc.calculate_auc() == jroc.calculate_auc()
    assert roc.calculate_auprc() == jroc.calculate_auprc()
    assert mc.calculate_average_auc() == jmc.calculate_average_auc()
