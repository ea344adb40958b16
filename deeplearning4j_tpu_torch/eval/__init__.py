"""Evaluation metrics.

Reference analog: org.nd4j.evaluation — Evaluation (classification), ROC /
ROCMultiClass / ROCBinary, RegressionEvaluation, EvaluationBinary,
ConfusionMatrix. Counterpart of ``deeplearning4j_tpu/eval``: numpy on the
host, so copied.
"""

from deeplearning4j_tpu_torch.eval.evaluation import (Evaluation, ConfusionMatrix,
    EvaluationBinary, EvaluationCalibration)
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass

__all__ = [
    "Evaluation", "ConfusionMatrix", "EvaluationBinary", "EvaluationCalibration",
    "RegressionEvaluation", "ROC", "ROCMultiClass",
]
