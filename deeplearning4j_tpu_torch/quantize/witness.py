"""Witness: prove no full-size dequantized weight is materialized.

Counterpart of ``deeplearning4j_tpu/quantize/witness.py``, with the same
contract. Weight-only int8 saves bandwidth only if the int8 payload is the
only full-size weight buffer. The failure is ``q.float() * scale`` at the
weight's shape, a scaled float copy the memory system must stream, where
the scale belongs on the accumulator. So any ``mul`` whose floating output
has exactly a quantized weight's shape is flagged; a bare cast at that
shape is allowed (it feeds the product).

The JAX package walks a jaxpr. PyTorch runs eagerly, so this runs the
function once under a ``TorchDispatchMode`` that records every aten op
below autograd, with its outputs' shapes and dtypes. A hand-written
kernel launched through its C launcher runs no aten op and is not seen,
as a Pallas call's body is opaque to the jaxpr walk.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu_torch.common.trees import tree_leaves

_MUL = ("mul", "mul_")


class _Recorder(TorchDispatchMode):
    """Keeps (op name, [(shape, dtype)] of its tensor outputs) of every
    aten op run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((func.overloadpacket.__name__, [
            (tuple(o.shape), o.dtype) for o in outs
            if isinstance(o, torch.Tensor)]))
        return out


def find_dequantized_weights(fn, *args, weight_shapes=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return the offending ops, as
    ``(op name, output shape, dtype)``: every ``mul`` whose floating output
    has exactly the shape of a quantized weight.

    weight_shapes: the shapes to screen for. Defaults to the shape of
    every int8 tensor of two or more dims among the arguments: the
    payloads of every QuantizedTensor in the params passed."""
    if weight_shapes is None:
        weight_shapes = {
            tuple(t.shape) for t in tree_leaves((list(args), kwargs))
            if isinstance(t, torch.Tensor) and t.dtype == torch.int8
            and t.dim() >= 2}
    shapes = {tuple(s) for s in weight_shapes}
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    bad = []
    for name, outs in rec.ops:
        if name not in _MUL:
            continue
        for shape, dtype in outs:
            if shape in shapes and dtype.is_floating_point:
                bad.append((name, shape, dtype))
                break
    return bad


def assert_no_dequantized_weights(fn, *args, weight_shapes=None, **kwargs):
    bad = find_dequantized_weights(fn, *args, weight_shapes=weight_shapes,
                                   **kwargs)
    if bad:
        lines = "\n  ".join(str(e)[:200] for e in bad[:5])
        raise AssertionError(
            f"quantized path materializes {len(bad)} full-size dequantized "
            f"weight buffer(s):\n  {lines}")
