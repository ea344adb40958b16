"""Named-op layer: registry, plain PyTorch lowerings, hand-written kernels.

Counterpart of ``deeplearning4j_tpu/ops``. Every op has a plain PyTorch
lowering; hand-written CUDA kernels register over the same names and are
chosen for CUDA tensors. The plain lowerings load before the kernels, so
every kernel has its reference.
"""

from deeplearning4j_tpu_torch.ops.registry import (
    OpImpl, get_op, op, register_impl, register_op,
)
from deeplearning4j_tpu_torch.ops import (  # noqa: F401
    activations, attention, convolution, quantized, recurrent,
)
from deeplearning4j_tpu_torch.ops import cuda  # noqa: F401  (register kernels)

__all__ = ["OpImpl", "get_op", "op", "register_impl", "register_op"]
