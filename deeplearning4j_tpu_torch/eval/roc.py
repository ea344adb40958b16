"""ROC / AUC evaluation.

Reference analog: org.nd4j.evaluation.classification.ROC (thresholded
streaming mode with ``thresholdSteps``, exact mode when 0) and ROCMultiClass.
We implement the thresholded streaming mode: per-threshold TP/FP/TN/FN
counters accumulated per batch, AUROC via trapezoid on the resulting curve —
identical methodology, bounded memory. Counterpart of
``deeplearning4j_tpu/eval/roc.py``, copied (numpy).
"""

from __future__ import annotations

import numpy as np


class ROC:
    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, np.int64)
        self.fp = np.zeros(threshold_steps + 1, np.int64)
        self.pos = 0
        self.neg = 0

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [B] or [B,1] or two-column one-hot (class 1 = positive)."""
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        if labels.ndim >= 2 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            preds = preds[..., 1]
        labels = labels.reshape(-1) >= 0.5
        preds = preds.reshape(-1)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        self.pos += int(labels.sum())
        self.neg += int((~labels).sum())
        # predictions >= threshold -> predicted positive
        pred_pos = preds[None, :] >= self.thresholds[:, None]
        self.tp += (pred_pos & labels[None, :]).sum(axis=1)
        self.fp += (pred_pos & ~labels[None, :]).sum(axis=1)

    def get_roc_curve(self):
        tpr = self.tp / max(self.pos, 1)
        fpr = self.fp / max(self.neg, 1)
        return fpr, tpr

    def calculate_auc(self) -> float:
        fpr, tpr = self.get_roc_curve()
        order = np.argsort(fpr)
        return float(np.trapezoid(tpr[order], fpr[order]))

    def calculate_auprc(self) -> float:
        prec = self.tp / np.maximum(self.tp + self.fp, 1)
        rec = self.tp / max(self.pos, 1)
        order = np.argsort(rec)
        return float(np.trapezoid(prec[order], rec[order]))


class ROCMultiClass:
    """One-vs-all ROC per class (org.nd4j.evaluation.classification.ROCMultiClass)."""

    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        self.rocs: list[ROC] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        preds = np.asarray(predictions).reshape(labels.shape)
        if not self.rocs:
            self.rocs = [ROC(self.steps) for _ in range(labels.shape[-1])]
        for c, roc in enumerate(self.rocs):
            roc.pos += int((labels[:, c] >= 0.5).sum())
            roc.neg += int((labels[:, c] < 0.5).sum())
            lab = labels[:, c] >= 0.5
            pred_pos = preds[:, c][None, :] >= roc.thresholds[:, None]
            roc.tp += (pred_pos & lab[None, :]).sum(axis=1)
            roc.fp += (pred_pos & ~lab[None, :]).sum(axis=1)

    def calculate_auc(self, c: int) -> float:
        return self.rocs[c].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs]))
