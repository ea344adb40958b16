"""Parallelism (counterpart of ``deeplearning4j_tpu/parallel``).

Only :mod:`.inference` is here: the request-batching queue in front of a
model's ``output()`` that the serving tier runs. The mesh, data, tensor,
pipeline and sequence parallelism are still to port.
"""

from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded, ParallelInference, resolve,
)

__all__ = ["DeadlineExceeded", "ParallelInference", "resolve"]
