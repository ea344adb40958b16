"""Classification evaluation.

Reference analog: org.nd4j.evaluation.classification.Evaluation — accuracy,
per-class precision/recall/F1 (+ macro/micro averages), confusion matrix,
top-N accuracy, Matthews correlation; org.nd4j.evaluation.classification.
EvaluationBinary for per-output binary metrics.

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``, copied: numpy on
the host, streaming (eval(labels, predictions) per batch) like the
reference. The networks' ``evaluate`` hands it host arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ConfusionMatrix:
    """org.nd4j.evaluation.classification.ConfusionMatrix analog."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def add_matrix(self, m):
        self.matrix += np.asarray(m, dtype=np.int64)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def __str__(self):
        return str(self.matrix)


def _to_class_indices(a, n_classes=None):
    a = np.asarray(a)
    if a.ndim >= 2 and a.shape[-1] > 1:
        return np.argmax(a, axis=-1).reshape(-1)
    flat = a.reshape(-1)
    if np.issubdtype(flat.dtype, np.floating) and flat.size \
            and not np.all(flat == np.round(flat)):
        # single-column PROBABILITIES (a sigmoid head): threshold at 0.5
        # — int-casting would floor every p < 1.0 to class 0
        return (flat >= 0.5).astype(np.int64)
    return flat.astype(np.int64)


class Evaluation:
    """Streaming multi-class evaluation (org.nd4j.evaluation.classification.Evaluation)."""

    def __init__(self, n_classes: Optional[int] = None, labels: Optional[list] = None):
        self.labels = labels
        self.n_classes = n_classes or (len(labels) if labels else None)
        self.cm: Optional[ConfusionMatrix] = None
        self._topn_correct = 0
        self._topn_total = 0
        self.top_n = 1

    def _ensure(self, n):
        if self.cm is None:
            self.n_classes = self.n_classes or n
            self.cm = ConfusionMatrix(self.n_classes)
        elif n > self.n_classes:
            # sparse-label streams can reveal a larger id in a LATER batch
            # (e.g. a [B,1] head whose first batch held only class 0):
            # grow the matrix instead of crashing np.add.at
            grown = ConfusionMatrix(n)
            grown.matrix[:self.n_classes, :self.n_classes] = self.cm.matrix
            self.cm = grown
            self.n_classes = n

    def eval(self, labels, predictions, mask=None):
        """Accumulate a batch. labels: one-hot [B, C] (or [B, T, C]) OR
        integer class ids [B] / [B, T] (the sparse_mcxent convention, r4);
        predictions: probabilities with a trailing class axis; sequence
        shapes flatten with the optional mask."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        # sparse (integer-id) labels: one fewer dim than the predictions
        sparse = (predictions.ndim >= 2
                  and labels.ndim == predictions.ndim - 1)
        if predictions.ndim == 3:  # time series: flatten with mask
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
            else:
                m = np.ones(predictions.shape[0] * predictions.shape[1],
                            dtype=bool)
            if sparse:
                labels = labels.reshape(-1)[m]
            else:
                labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        if sparse:
            # size by the prediction head, but never smaller than the ids
            # actually seen (a [B, 1] single-output head with 0/1 ids, or
            # an off-by-one vocab, must not crash the confusion matrix)
            n = int(max(predictions.shape[-1],
                        labels.max() + 1 if labels.size else 1))
        elif labels.ndim >= 2:
            n = labels.shape[-1]
        else:
            n = int(max(labels.max(), predictions.max()) + 1)
        self._ensure(n)
        actual = (labels.astype(np.int64) if sparse
                  else _to_class_indices(labels))
        # top-N bookkeeping needs the probability matrix
        if predictions.ndim >= 2 and predictions.shape[-1] > 1 and self.top_n > 1:
            order = np.argsort(-predictions, axis=-1)[:, : self.top_n]
            self._topn_correct += int((order == actual[:, None]).any(axis=1).sum())
            self._topn_total += len(actual)
        pred = _to_class_indices(predictions)
        np.add.at(self.cm.matrix, (actual, pred), 1)

    # ---- metrics ----
    @property
    def _m(self):
        if self.cm is None:
            raise ValueError("no batches evaluated")
        return self.cm.matrix

    def num_examples(self) -> int:
        return int(self._m.sum())

    def accuracy(self) -> float:
        m = self._m
        tot = m.sum()
        return float(np.trace(m) / tot) if tot else 0.0

    def top_n_accuracy(self) -> float:
        return self._topn_correct / self._topn_total if self._topn_total else 0.0

    def true_positives(self, c: int) -> int:
        return int(self._m[c, c])

    def false_positives(self, c: int) -> int:
        return int(self._m[:, c].sum() - self._m[c, c])

    def false_negatives(self, c: int) -> int:
        return int(self._m[c, :].sum() - self._m[c, c])

    def precision(self, c: Optional[int] = None) -> float:
        if c is not None:
            tp, fp = self.true_positives(c), self.false_positives(c)
            return tp / (tp + fp) if tp + fp else 0.0
        vals = [self.precision(i) for i in range(self.n_classes)
                if self._m[:, i].sum() + self._m[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: Optional[int] = None) -> float:
        if c is not None:
            tp, fn = self.true_positives(c), self.false_negatives(c)
            return tp / (tp + fn) if tp + fn else 0.0
        vals = [self.recall(i) for i in range(self.n_classes)
                if self._m[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c: Optional[int] = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if p + r else 0.0

    def matthews_correlation(self, c: int) -> float:
        tp = self.true_positives(c)
        fp = self.false_positives(c)
        fn = self.false_negatives(c)
        tn = self.num_examples() - tp - fp - fn
        denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        lines = [
            f"# of classes: {self.n_classes}",
            f"Examples: {self.num_examples()}",
            f"Accuracy: {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall: {self.recall():.4f}",
            f"F1: {self.f1():.4f}",
            "",
            "Confusion matrix (rows=actual, cols=predicted):",
            str(self.cm),
        ]
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary metrics (org.nd4j.evaluation.classification.EvaluationBinary)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        preds = (np.asarray(predictions).reshape(labels.shape) >= self.threshold)
        lab = labels >= 0.5
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        self.tp += (preds & lab).sum(0)
        self.fp += (preds & ~lab).sum(0)
        self.tn += (~preds & ~lab).sum(0)
        self.fn += (~preds & lab).sum(0)

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if p + r else 0.0


class EvaluationCalibration:
    """Reliability / calibration evaluation
    (org.nd4j.evaluation.classification.EvaluationCalibration): bins
    predicted probability for the positive/argmax class against observed
    accuracy, plus residual histograms."""

    def __init__(self, n_bins: int = 10):
        self.n_bins = n_bins
        self._conf_sum = np.zeros(n_bins)
        self._acc_sum = np.zeros(n_bins)
        self._counts = np.zeros(n_bins, dtype=np.int64)
        self._residual_counts = np.zeros(n_bins, dtype=np.int64)

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        conf = preds.max(axis=-1)
        correct = (preds.argmax(-1) == labels.argmax(-1)).astype(np.float64)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            conf, correct = conf.reshape(-1)[m], correct.reshape(-1)[m]
        bins = np.clip((conf * self.n_bins).astype(int), 0, self.n_bins - 1)
        np.add.at(self._conf_sum, bins, conf)
        np.add.at(self._acc_sum, bins, correct)
        np.add.at(self._counts, bins, 1)
        # residual plot: |label - p| averaged over classes per example
        resid = np.abs(labels.reshape(-1, labels.shape[-1])
                       - preds.reshape(-1, preds.shape[-1])).mean(-1)
        if mask is not None:
            resid = resid[np.asarray(mask).reshape(-1).astype(bool)]
        rbins = np.clip((resid * self.n_bins).astype(int), 0, self.n_bins - 1)
        np.add.at(self._residual_counts, rbins, 1)
        return self

    def reliability_curve(self):
        """(mean_confidence[b], accuracy[b], count[b]) per non-empty bin."""
        nz = self._counts > 0
        return (self._conf_sum[nz] / self._counts[nz],
                self._acc_sum[nz] / self._counts[nz], self._counts[nz])

    def residual_plot(self):
        """Histogram counts of mean-absolute residual |label - p| per
        example, binned over [0, 1] (getResidualPlot analog)."""
        edges = np.linspace(0.0, 1.0, self.n_bins + 1)
        return edges, self._residual_counts.copy()

    def expected_calibration_error(self) -> float:
        conf, acc, counts = self.reliability_curve()
        if counts.sum() == 0:
            return float("nan")
        w = counts / counts.sum()
        return float((w * np.abs(conf - acc)).sum())
