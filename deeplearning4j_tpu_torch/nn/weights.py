"""Weight initialization schemes, drawn from a ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/nn/weights.py`` for the schemes this
slice's layers use (XAVIER and ZERO). Fans are computed from the
weight shape the same way. Samples come from a CPU generator, so a seed
gives the same weights on every device; they are then moved to ``device``.
The values differ from the JAX package's (threefry is not torch's
generator): weights cross between the packages through the model zip.
"""

from __future__ import annotations

import math

import torch


def _fans(shape, fan_in=None, fan_out=None):
    if fan_in is not None and fan_out is not None:
        return fan_in, fan_out
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return receptive * shape[-2], receptive * shape[-1]


def init_weight(generator: torch.Generator, shape, scheme="xavier", *,
                device="cpu", dtype=torch.float32, fan_in=None, fan_out=None):
    """Sample a weight tensor for the named scheme (DL4J WeightInit names)."""
    scheme = str(scheme).lower()
    shape = tuple(int(d) for d in shape)
    if scheme in ("zero", "zeros"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme == "xavier":
        fi, fo = _fans(shape, fan_in, fan_out)
        std = math.sqrt(2.0 / (fi + fo))
        w = torch.randn(shape, generator=generator, dtype=dtype) * std
        return w.to(device)
    raise ValueError(f"weight init scheme '{scheme}' is not ported yet")
