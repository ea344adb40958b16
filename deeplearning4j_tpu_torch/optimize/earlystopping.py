"""Early stopping.

Reference analog: org.deeplearning4j.earlystopping —
EarlyStoppingConfiguration, EarlyStoppingTrainer, termination conditions
(MaxEpochsTerminationCondition, ScoreImprovementEpochTerminationCondition,
MaxTimeIterationTerminationCondition, MaxScoreIterationTerminationCondition),
score calculators (DataSetLossCalculator analog), best-model saving.
Counterpart of ``deeplearning4j_tpu/optimize/earlystopping.py``, copied: the
trainer reads each step's score as a float (a drain of the async window)
for its iteration conditions, and keeps a copy of the best epoch's
parameters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float, best_score: float, best_epoch: int) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, score: float, elapsed_s: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, best_score, best_epoch):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def terminate(self, epoch, score, best_score, best_epoch):
        return (epoch - best_epoch) > self.patience


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score, elapsed_s):
        return score > self.max_score


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds

    def terminate(self, score, elapsed_s):
        return elapsed_s > self.max_seconds


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: list = dataclasses.field(default_factory=list)
    iteration_termination_conditions: list = dataclasses.field(default_factory=list)
    score_calculator: Optional[Callable[[Any], float]] = None  # model -> score (lower better)
    evaluate_every_n_epochs: int = 1
    save_best_model_path: Optional[str] = None


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    best_epoch: int
    best_score: float
    total_epochs: int
    score_vs_epoch: dict
    best_params: Any = None


class EarlyStoppingTrainer:
    """Reference: org.deeplearning4j.earlystopping.trainer.EarlyStoppingTrainer."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        import copy

        cfg = self.config
        best_score = float("inf")
        best_epoch = -1
        best_params = None
        scores = {}
        t0 = time.perf_counter()
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            stop_iter = False
            for ds in self.train_iterator:
                score = self.model.fit_batch(ds)
                elapsed = time.perf_counter() - t0
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(float(score), elapsed):
                        stop_iter = True
                        reason, details = "IterationTermination", type(c).__name__
                        break
                if stop_iter:
                    break
            if hasattr(self.train_iterator, "reset"):
                self.train_iterator.reset()
            if stop_iter:
                break

            if epoch % cfg.evaluate_every_n_epochs == 0:
                s = (cfg.score_calculator(self.model) if cfg.score_calculator
                     else float(self.model.score_value))
                scores[epoch] = s
                if s < best_score:
                    best_score, best_epoch = s, epoch
                    best_params = copy.deepcopy(self.model.params)
                    if cfg.save_best_model_path:
                        self.model.save(cfg.save_best_model_path)

            stop_epoch = False
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, scores.get(epoch, best_score), best_score, best_epoch):
                    stop_epoch = True
                    reason, details = "EpochTermination", type(c).__name__
                    break
            epoch += 1
            if stop_epoch:
                break

        if best_params is not None:
            self.model.params = best_params
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            best_epoch=best_epoch,
            best_score=best_score,
            total_epochs=epoch,
            score_vs_epoch=scores,
        )
