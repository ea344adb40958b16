"""Continuous-batching text generation (counterpart of ``generation``).

A fixed-capacity slot pool of per-sequence recurrent carries on the card,
one decode step for the whole pool per call, continuous admission and
retirement, and a seeded per-row sampler.
"""

from deeplearning4j_tpu_torch.generation.codec import CharCodec
from deeplearning4j_tpu_torch.generation.engine import (
    GenerationEngine, GenerationRequest, GenerationStream,
    RecurrentDecodeAdapter,
)
from deeplearning4j_tpu_torch.generation.sampler import (
    row_seed, sample_logits, sample_row,
)
from deeplearning4j_tpu_torch.generation.slots import SlotPool

__all__ = [
    "CharCodec", "GenerationEngine", "GenerationRequest", "GenerationStream",
    "RecurrentDecodeAdapter", "SlotPool", "row_seed", "sample_logits",
    "sample_row",
]
