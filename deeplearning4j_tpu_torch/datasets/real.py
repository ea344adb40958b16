"""Real-data iterators from datasets bundled in the environment.

Counterpart of ``deeplearning4j_tpu/datasets/real.py``, copied.
scikit-learn ships real datasets inside its wheel: the UCI Optical
Recognition of Handwritten Digits corpus (1797 8x8 scans) and the UCI
tabular sets (iris, wine, breast cancer). Without scikit-learn these
iterators raise ImportError, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator


def _require_sklearn():
    try:
        import sklearn.datasets as skd
    except ImportError as e:
        raise ImportError(
            "real-data iterators need scikit-learn (bundles the UCI "
            "corpora); install it or use the synthetic iterators") from e
    return skd


class DigitsDataSetIterator(ArrayDataSetIterator):
    """REAL handwritten digits (UCI optdigits via sklearn): features
    [B, 8, 8, 1] float32 scaled to [0, 1], labels one-hot [B, 10].

    train=True takes the first 80% (1437 samples), train=False the held-out
    20% (360) — a fixed split so train/eval never overlap."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 shuffle: bool = True):
        skd = _require_sklearn()
        dig = skd.load_digits()
        images = dig.images.astype(np.float32) / 16.0   # pixel range 0..16
        labels = np.eye(10, dtype=np.float32)[dig.target]
        split = int(0.8 * len(images))
        sl = slice(0, split) if train else slice(split, None)
        super().__init__(images[sl][..., None], labels[sl], batch_size,
                         shuffle=shuffle, seed=seed)
        self.synthetic = False


class TabularDataSetIterator(ArrayDataSetIterator):
    """Real UCI tabular classification sets: "iris", "wine",
    "breast_cancer". Labels one-hot; features standardized with
    NormalizerStandardize statistics FIT ON THE TRAIN SPLIT only (the
    normalizer must never see held-out rows). train=True serves a fixed
    interleaved 80% (every 5th row held out), train=False the other 20%
    — interleaved because the UCI files are grouped by class, so a prefix
    split would drop whole classes from one side."""

    def __init__(self, name: str, batch_size: int, train: bool = True,
                 seed: int = 123, shuffle: bool = True):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            NormalizerStandardize,
        )

        skd = _require_sklearn()
        loaders = {"iris": skd.load_iris, "wine": skd.load_wine,
                   "breast_cancer": skd.load_breast_cancer}
        if name not in loaders:
            raise ValueError(f"unknown dataset {name!r}; "
                             f"options: {sorted(loaders)}")
        raw = loaders[name]()
        x = raw.data.astype(np.float32)
        n_classes = int(raw.target.max()) + 1
        y = np.eye(n_classes, dtype=np.float32)[raw.target]
        test_mask = np.arange(len(x)) % 5 == 4
        sel = ~test_mask if train else test_mask
        norm = NormalizerStandardize().fit(
            ArrayDataSetIterator(x[~test_mask], y[~test_mask],
                                 batch_size=256))
        split = norm.transform(DataSet(x[sel].copy(), y[sel]))
        super().__init__(split.features, split.labels, batch_size,
                         shuffle=shuffle, seed=seed)
        self.normalizer = norm
        self.n_classes = n_classes
        self.n_features = x.shape[1]
        self.synthetic = False
