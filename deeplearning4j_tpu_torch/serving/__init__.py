"""Serving (counterpart of ``deeplearning4j_tpu/serving``).

Only the prompt and batch buckets of :mod:`.warmup` are here; the gateway,
admission, the HTTP layer and the rest are still to port.
"""

from deeplearning4j_tpu_torch.serving.warmup import (
    bucket_for, pow2_buckets, warmup_model,
)

__all__ = ["bucket_for", "pow2_buckets", "warmup_model"]
