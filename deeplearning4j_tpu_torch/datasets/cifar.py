"""CIFAR-10 / SVHN dataset iterators.

Counterpart of ``deeplearning4j_tpu/datasets/cifar.py``, copied, with the
data directory under ``DL4J_TORCH_DATA_DIR``. Resolution order mirrors
MnistDataSetIterator:
1. real files — CIFAR-10 binary batches (data_batch_*.bin / test_batch.bin)
   under $DL4J_TORCH_DATA_DIR/cifar10, ~/.dl4j_tpu/cifar10 or ./data/cifar10;
   SVHN as cropped-digit .npz {X: [N,32,32,3], y: [N]} under .../svhn;
2. deterministic synthetic stand-ins (class-colored textured patches),
   flagged via ``.synthetic``, learnable by a small CNN.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator


def _search_dirs(name: str):
    return [Path(os.environ.get("DL4J_TORCH_DATA_DIR", "")) / name,
            Path(os.path.expanduser("~/.dl4j_tpu")) / name,
            Path("./data") / name]


def _synthetic_images(n: int, n_classes: int, seed: int,
                      size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent color + stripe frequency + noise; separable but not
    trivial (same role as the MNIST glyph generator)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    feats = np.empty((n, size, size, 3), np.float32)
    for i, c in enumerate(labels):
        hue = c / n_classes
        base = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (hue + xx * (1 + c % 3))),
            0.5 + 0.5 * np.cos(2 * np.pi * (hue + yy * (1 + c % 2))),
            np.full_like(xx, hue),
        ], axis=-1)
        shift = rng.uniform(-0.04, 0.04)
        noise = rng.normal(0, 0.15, base.shape)
        feats[i] = np.clip(base + shift + noise, 0, 1)
    onehot = np.eye(n_classes, dtype=np.float32)[labels]
    return feats, onehot


def _load_cifar_binaries(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    for d in _search_dirs("cifar10"):
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [d / n for n in names]
        if not all(p.exists() for p in paths):
            # also accept the cifar-10-batches-bin subdir layout
            paths = [d / "cifar-10-batches-bin" / n for n in names]
            if not all(p.exists() for p in paths):
                continue
        xs, ys = [], []
        for p in paths:
            raw = np.frombuffer(p.read_bytes(), np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0])
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
        return x, y
    return None


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """NHWC float32 in [0,1], one-hot 10-class labels."""

    n_classes = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 n_examples: Optional[int] = None, shuffle: bool = True):
        loaded = _load_cifar_binaries(train)
        if loaded is not None:
            feats, labels = loaded
            self.synthetic = False
        else:
            n = n_examples or (4096 if train else 1024)
            feats, labels = _synthetic_images(n, 10, seed + (0 if train else 1))
            self.synthetic = True
        if n_examples is not None:
            feats, labels = feats[:n_examples], labels[:n_examples]
        super().__init__(feats, labels, batch_size, shuffle=shuffle, seed=seed)


def _load_svhn_npz(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    for d in _search_dirs("svhn"):
        p = d / ("train_32x32.npz" if train else "test_32x32.npz")
        if not p.exists():
            continue
        data = np.load(p)
        x = np.asarray(data["X"], np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        if x.shape[-1] != 3 and x.shape[0] == 32:  # matlab [32,32,3,N] layout
            x = x.transpose(3, 0, 1, 2)
        y = np.asarray(data["y"]).ravel() % 10  # SVHN labels digit 10 == 0
        return x, np.eye(10, dtype=np.float32)[y]
    return None


class SvhnDataSetIterator(ArrayDataSetIterator):
    """Street View House Numbers, cropped-digit format."""

    n_classes = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 n_examples: Optional[int] = None, shuffle: bool = True):
        loaded = _load_svhn_npz(train)
        if loaded is not None:
            feats, labels = loaded
            self.synthetic = False
        else:
            n = n_examples or (4096 if train else 1024)
            feats, labels = _synthetic_images(n, 10, seed + 77 + (0 if train else 1))
            self.synthetic = True
        if n_examples is not None:
            feats, labels = feats[:n_examples], labels[:n_examples]
        super().__init__(feats, labels, batch_size, shuffle=shuffle, seed=seed)
