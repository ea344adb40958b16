"""Registry ops for int8 weight-only products.

Counterpart of ``deeplearning4j_tpu/ops/quantized.py:24-54``. Both ops
take the activation ``x`` and the decomposed quantized weight (``q`` int8,
``scale`` per output channel), so the registry sees plain tensors.

The int8 payload is the only full-size weight buffer: ``q.to(x.dtype)`` is
a bare cast feeding the product, and the scale multiplies the accumulator
(activation-sized), never the weight. ``quantize.witness`` checks exactly
that: no ``mul`` may produce a floating tensor of a weight's full shape.
The JAX package computes both with ``jnp.matmul``/``jnp.einsum`` outside
any Pallas kernel, so both are plain PyTorch here, with no kernel over
them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("quantized_matmul")
def quantized_matmul(x, q, scale):
    """``x @ (q * scale)`` computed as ``(x @ q) * scale``.

    x: [..., K] activation (f32/bf16); q: [K, N] int8; scale: [N]. Exact
    against the dequantized weight: the scale is constant along the
    contracted axis, so it commutes out of the product."""
    acc = x @ q.to(x.dtype)
    return acc * scale.to(x.dtype)


@register_op("quantized_einsum")
def quantized_einsum(spec, x, q, scale):
    """Einsum with an int8 weight (the second operand) whose quantized
    axis is the last axis of both ``q`` and the result, so the [N] scale
    broadcasts onto the accumulator. A contracted scale axis is refused:
    pulling the scale out of the contraction is exact only where it is
    not summed over."""
    out_sub = spec.split("->")[-1].strip()
    w_sub = spec.split("->")[0].split(",")[1].strip()
    if not out_sub or w_sub[-1] != out_sub[-1]:
        raise ValueError(
            f"quantized_einsum needs the weight's last axis to be the "
            f"result's last axis (got spec {spec!r})")
    acc = torch.einsum(spec, x, q.to(x.dtype))
    return acc * scale.to(x.dtype)
