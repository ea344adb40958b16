"""DataSet — a (features, labels, masks) batch.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``, copied: DataSet
and MultiDataSet (org.nd4j.linalg.dataset). Host-side numpy; a network
moves a batch to its device when it takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx],
        )

    def split_test_and_train(self, n_train: int):
        """Returns (train, test) (DataSet.splitTestAndTrain)."""
        tr = DataSet(
            self.features[:n_train], self.labels[:n_train],
            None if self.features_mask is None else self.features_mask[:n_train],
            None if self.labels_mask is None else self.labels_mask[:n_train],
        )
        te = DataSet(
            self.features[n_train:], self.labels[n_train:],
            None if self.features_mask is None else self.features_mask[n_train:],
            None if self.labels_mask is None else self.labels_mask[n_train:],
        )
        return tr, te

    def batch_by(self, batch_size: int) -> list["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            out.append(DataSet(
                self.features[i : i + batch_size], self.labels[i : i + batch_size],
                None if self.features_mask is None else self.features_mask[i : i + batch_size],
                None if self.labels_mask is None else self.labels_mask[i : i + batch_size],
            ))
        return out

    def save(self, path: str):
        arrays = {"features": self.features, "labels": self.labels}
        if self.features_mask is not None:
            arrays["features_mask"] = self.features_mask
        if self.labels_mask is not None:
            arrays["labels_mask"] = self.labels_mask
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "DataSet":
        d = np.load(path)
        return DataSet(d["features"], d["labels"],
                       d.get("features_mask"), d.get("labels_mask"))

    @staticmethod
    def merge(datasets: list["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
        )


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input / multi-output batch for ComputationGraph training.

    Reference analog: org.nd4j.linalg.dataset.MultiDataSet (features[],
    labels[], per-array masks). ``features``/``labels`` are lists ordered
    like the graph's network_inputs/network_outputs (or dicts keyed by
    name). Sequence masks: the graph threads ONE shared [B, T] features
    mask through every vertex (the common case — all sequence inputs share
    timing). ``labels_mask`` may be a single [B, T] array (applied to every
    output's loss), or a per-output list/dict (r5) — the graph routes each
    output's loss through its own labels mask while the forward sees the
    features mask (DL4J's labelsMaskArrays semantics).
    """

    features: "list | dict"
    labels: "list | dict"
    features_mask: Optional[np.ndarray] = None
    labels_mask: "Optional[np.ndarray | list | dict]" = None

    def _arrays(self, x):
        return list(x.values()) if isinstance(x, dict) else list(x)

    def num_examples(self) -> int:
        return int(self._arrays(self.features)[0].shape[0])

    @staticmethod
    def _take_mask(m, idx):
        if m is None:
            return None
        if isinstance(m, dict):
            return {k: (None if v is None else v[idx]) for k, v in m.items()}
        if isinstance(m, (list, tuple)):
            return [None if v is None else v[idx] for v in m]
        return m[idx]

    def shuffle(self, seed: Optional[int] = None) -> "MultiDataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())

        def take(x):
            if isinstance(x, dict):
                return {k: v[idx] for k, v in x.items()}
            return [v[idx] for v in x]

        return MultiDataSet(
            take(self.features), take(self.labels),
            None if self.features_mask is None else self.features_mask[idx],
            self._take_mask(self.labels_mask, idx))

    def batches(self, batch_size: int):
        """Iterate MultiDataSet minibatches (MultiDataSetIterator analog)."""
        n = self.num_examples()
        for i in range(0, n, batch_size):
            sl = slice(i, i + batch_size)

            def take(x):
                if isinstance(x, dict):
                    return {k: v[sl] for k, v in x.items()}
                return [v[sl] for v in x]

            yield MultiDataSet(
                take(self.features), take(self.labels),
                None if self.features_mask is None else self.features_mask[sl],
                self._take_mask(self.labels_mask, sl))
