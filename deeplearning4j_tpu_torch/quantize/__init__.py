"""Int8 quantization (counterpart of ``deeplearning4j_tpu/quantize``).

Two levers, as in the JAX package:

- weight-only int8 (``quantize_network`` / ``net.quantize()``): a
  post-training pass replaces dense, conv and attention projection weights
  by :class:`QuantizedTensor` (int8 payload + per-output-channel absmax
  scales); their products run through the ``quantized_matmul`` op (and the
  conv layer's int8 branch), which scale the accumulator, so no full-size
  dequantized weight is ever formed (``witness`` checks it);
- the int8 KV ring of cached decode (:mod:`.kvcache`,
  ``GenerationEngine(..., kv_dtype="int8")``).
"""

from deeplearning4j_tpu_torch.quantize.tensor import (
    QuantizedTensor, dequantize_tensor, quantize_tensor,
)
from deeplearning4j_tpu_torch.quantize.passes import (
    QUANT_RULES, quantize_network, quantize_params,
)
from deeplearning4j_tpu_torch.quantize.kvcache import (
    quantize_cache, ring_write_quantized,
)
from deeplearning4j_tpu_torch.quantize.witness import (
    assert_no_dequantized_weights, find_dequantized_weights,
)

__all__ = [
    "QuantizedTensor", "quantize_tensor", "dequantize_tensor",
    "QUANT_RULES", "quantize_params", "quantize_network",
    "quantize_cache", "ring_write_quantized",
    "assert_no_dequantized_weights", "find_dequantized_weights",
]
