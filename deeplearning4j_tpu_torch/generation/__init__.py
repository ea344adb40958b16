"""Continuous-batching text generation (counterpart of ``generation``).

A fixed-capacity slot pool of per-sequence decode state on the card
(recurrent carries, or KV rings for a causal transformer), one decode step
for the whole pool per call (a replayed CUDA graph on the card),
continuous admission and retirement, pow2-bucketed attention prefill, a
seeded per-row sampler and the durable session journal.
"""

from deeplearning4j_tpu_torch.generation.codec import CharCodec
from deeplearning4j_tpu_torch.generation.engine import (
    AttentionDecodeAdapter, GenerationEngine, GenerationRequest,
    GenerationStream, RecurrentDecodeAdapter,
)
from deeplearning4j_tpu_torch.generation.sampler import (
    row_seed, sample_logits, sample_row,
)
from deeplearning4j_tpu_torch.generation.sessions import (
    SessionJournal, SessionRecord,
)
from deeplearning4j_tpu_torch.generation.slots import SlotPool

__all__ = [
    "AttentionDecodeAdapter", "CharCodec", "GenerationEngine",
    "GenerationRequest", "GenerationStream", "RecurrentDecodeAdapter",
    "SessionJournal", "SessionRecord", "SlotPool", "row_seed",
    "sample_logits", "sample_row",
]
