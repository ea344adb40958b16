"""Hyperparameter optimization (Arbiter).

Reference analog: the `arbiter/` module — org.deeplearning4j.arbiter.
optimize.api.ParameterSpace, CandidateGenerator (RandomSearchGenerator,
GridSearchCandidateGenerator), OptimizationRunner with score functions and
termination conditions (SURVEY.md §2.3 "Tooling" / §7 step 8).

Counterpart of ``deeplearning4j_tpu/arbiter/``, exporting its ``__all__``
whole: the spaces and the runner are host Python, copied; the network
spaces build the port's configurations. Candidates train where their
``build_fn`` puts them (``MultiLayerNetwork(conf).init(device=...)``).
"""

from deeplearning4j_tpu_torch.arbiter.spaces import (
    ContinuousParameterSpace, DiscreteParameterSpace, IntegerParameterSpace,
)
from deeplearning4j_tpu_torch.arbiter.spaces_net import (ComputationGraphSpace,
                                                         MultiLayerSpace)
from deeplearning4j_tpu_torch.arbiter.runner import (
    GridSearchGenerator, MaxCandidatesCondition, MaxTimeCondition,
    OptimizationResult, OptimizationRunner, RandomSearchGenerator,
)

__all__ = [
    "ContinuousParameterSpace", "DiscreteParameterSpace",
    "IntegerParameterSpace", "MultiLayerSpace", "ComputationGraphSpace", "RandomSearchGenerator", "GridSearchGenerator",
    "OptimizationRunner", "OptimizationResult", "MaxCandidatesCondition",
    "MaxTimeCondition",
]
