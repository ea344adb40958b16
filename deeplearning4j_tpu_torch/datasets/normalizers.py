"""Data normalizers.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py``, copied:
NormalizerStandardize (fit mean/std then transform), NormalizerMinMaxScaler,
ImagePreProcessingScaler (0..255 -> [0,1]), with revert support, on host
numpy.
"""

from __future__ import annotations

import numpy as np


class Normalizer:
    def fit(self, iterator):
        raise NotImplementedError

    def transform(self, ds):
        raise NotImplementedError

    def revert(self, ds):
        raise NotImplementedError


class NormalizerStandardize(Normalizer):
    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, iterator):
        n, s, s2 = 0, 0.0, 0.0
        for ds in iterator:
            f = ds.features.reshape(ds.features.shape[0], -1).astype(np.float64)
            n += f.shape[0]
            s = s + f.sum(axis=0)
            s2 = s2 + (f * f).sum(axis=0)
        if hasattr(iterator, "reset"):
            iterator.reset()
        self.mean = (s / n).astype(np.float32)
        var = s2 / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return self

    def transform(self, ds):
        shape = ds.features.shape
        f = ds.features.reshape(shape[0], -1)
        ds.features = ((f - self.mean) / self.std).reshape(shape).astype(np.float32)
        return ds

    def revert(self, ds):
        shape = ds.features.shape
        f = ds.features.reshape(shape[0], -1)
        ds.features = (f * self.std + self.mean).reshape(shape)
        return ds


class NormalizerMinMaxScaler(Normalizer):
    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min = None
        self.data_max = None

    def fit(self, iterator):
        lo, hi = None, None
        for ds in iterator:
            f = ds.features.reshape(ds.features.shape[0], -1)
            bmin, bmax = f.min(axis=0), f.max(axis=0)
            lo = bmin if lo is None else np.minimum(lo, bmin)
            hi = bmax if hi is None else np.maximum(hi, bmax)
        if hasattr(iterator, "reset"):
            iterator.reset()
        self.data_min, self.data_max = lo, hi
        return self

    def transform(self, ds):
        shape = ds.features.shape
        f = ds.features.reshape(shape[0], -1)
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        scaled = (f - self.data_min) / rng
        ds.features = (scaled * (self.max_range - self.min_range) + self.min_range).reshape(
            shape).astype(np.float32)
        return ds

    def revert(self, ds):
        shape = ds.features.shape
        f = (ds.features.reshape(shape[0], -1) - self.min_range) / (
            self.max_range - self.min_range)
        ds.features = (f * (self.data_max - self.data_min) + self.data_min).reshape(shape)
        return ds


class ImagePreProcessingScaler(Normalizer):
    """0..255 pixels -> [min, max] (org.nd4j...ImagePreProcessingScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range

    def fit(self, iterator):
        return self

    def transform(self, ds):
        ds.features = (ds.features.astype(np.float32) / 255.0) * (
            self.max_range - self.min_range) + self.min_range
        return ds

    def revert(self, ds):
        ds.features = (ds.features - self.min_range) / (
            self.max_range - self.min_range) * 255.0
        return ds
