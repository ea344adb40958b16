"""Regression evaluation.

Reference analog: org.nd4j.evaluation.regression.RegressionEvaluation —
per-column MSE, MAE, RMSE, RSE, PC (Pearson), R^2. Counterpart of
``deeplearning4j_tpu/eval/regression.py``, copied (numpy).
"""

from __future__ import annotations

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns: int | None = None):
        self.n = 0
        self.sum_err2 = None
        self.sum_abs = None
        self.sum_label = None
        self.sum_label2 = None
        self.sum_pred = None
        self.sum_pred2 = None
        self.sum_lp = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        preds = np.asarray(predictions, dtype=np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        if self.sum_err2 is None:
            c = labels.shape[-1]
            z = lambda: np.zeros(c, np.float64)
            self.sum_err2, self.sum_abs = z(), z()
            self.sum_label, self.sum_label2 = z(), z()
            self.sum_pred, self.sum_pred2, self.sum_lp = z(), z(), z()
        e = preds - labels
        self.n += labels.shape[0]
        self.sum_err2 += (e * e).sum(0)
        self.sum_abs += np.abs(e).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label2 += (labels * labels).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred2 += (preds * preds).sum(0)
        self.sum_lp += (labels * preds).sum(0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.sum_err2[col] / self.n))

    def relative_squared_error(self, col: int = 0) -> float:
        mean_label = self.sum_label[col] / self.n
        ss_tot = self.sum_label2[col] - self.n * mean_label**2
        return float(self.sum_err2[col] / ss_tot) if ss_tot else float("inf")

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        num = n * self.sum_lp[col] - self.sum_label[col] * self.sum_pred[col]
        d1 = n * self.sum_label2[col] - self.sum_label[col] ** 2
        d2 = n * self.sum_pred2[col] - self.sum_pred[col] ** 2
        den = np.sqrt(d1 * d2)
        return float(num / den) if den else 0.0

    def r_squared(self, col: int = 0) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err2 / self.n))

    def stats(self) -> str:
        cols = len(self.sum_err2)
        lines = [f"Columns: {cols}, examples: {self.n}"]
        for c in range(cols):
            lines.append(
                f"col {c}: MSE={self.mean_squared_error(c):.6f} "
                f"MAE={self.mean_absolute_error(c):.6f} "
                f"RMSE={self.root_mean_squared_error(c):.6f} "
                f"R2={self.r_squared(c):.4f}"
            )
        return "\n".join(lines)
