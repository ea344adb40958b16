"""Dtype policies: params in f32, compute in f32 or bf16.

Counterpart of ``deeplearning4j_tpu/common/dtypes.py`` with torch dtypes.
There is no process-wide policy here: a network picks its policy from its
configuration's ``dtype`` string.
"""

from __future__ import annotations

import dataclasses

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
    """Cast every floating tensor of a nested list/dict/tuple."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floating(v, dtype) for v in tree]
    if isinstance(tree, tuple):
        return tuple(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
