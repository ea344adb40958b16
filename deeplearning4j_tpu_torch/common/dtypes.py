"""Dtype policies: params in f32, compute in f32 or bf16.

Counterpart of ``deeplearning4j_tpu/common/dtypes.py`` with torch dtypes.
There is no process-wide policy here: a network picks its policy from its
configuration's ``dtype`` string.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """What dtype each tensor class uses.

    param_dtype:   master copy of trainable parameters.
    compute_dtype: activations / matmul inputs.
    output_dtype:  dtype returned to the user from ``output()`` etc.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


FLOAT32 = DtypePolicy()
BF16 = DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested list/dict/tuple. A quantized
    weight (``quantize.QuantizedTensor``) keeps its int8 payload and casts
    its scale, as the JAX package's per-leaf cast leaves it."""
    if getattr(tree, "is_quantized", False):
        return tree.astype(dtype)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floating(v, dtype) for v in tree]
    if isinstance(tree, tuple):
        return tuple(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def widen(*tensors):
    """Operands of one operation whose floating types differ, each widened
    to the widest of them, as jnp's promotion computes the operation (bf16
    with f32 gives f32); widening is exact. None and non-floating tensors
    pass as they are. Returns the operands in order."""
    dts = {t.dtype for t in tensors
           if t is not None and t.is_floating_point()}
    if len(dts) < 2:
        return tensors
    dt = functools.reduce(torch.promote_types, dts)
    return tuple(t.to(dt) if t is not None and t.is_floating_point() else t
                 for t in tensors)


def matmul(x, w):
    """``x @ w`` over the two operands' promoted type (:func:`widen`):
    torch's matmul refuses mixed types, where jnp's promotes. A quantized
    ``w`` takes the product through its ``__rmatmul__`` (the
    ``quantized_matmul`` op) in ``x``'s type."""
    if getattr(w, "is_quantized", False):
        return x @ w
    x, w = widen(x, w)
    return x @ w
