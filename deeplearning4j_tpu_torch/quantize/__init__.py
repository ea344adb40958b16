"""Quantization (counterpart of ``deeplearning4j_tpu/quantize``).

Only the int8 KV ring of cached decode is here (:mod:`.kvcache`); the
weight-only int8 pass, its ops and ``MultiLayerNetwork.quantize`` are
still to port.
"""

from deeplearning4j_tpu_torch.quantize.kvcache import (
    quantize_cache, ring_write_quantized,
)

__all__ = ["quantize_cache", "ring_write_quantized"]
