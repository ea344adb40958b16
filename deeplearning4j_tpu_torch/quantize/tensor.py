"""QuantizedTensor: int8 payload + per-output-channel absmax scales.

Counterpart of ``deeplearning4j_tpu/quantize/tensor.py``. A quantized
weight lives where the f32 weight lived, inside ``net.params``, and the
port's tree functions (``common/trees.py``) treat it as the JAX package's
pytree node: its children are ``q`` and ``scale``, its static data the
axis. ``tree_leaves`` sees both children; ``cast_floating`` (a cast to the
compute type) moves only the scale; a move to the card moves both.

Layers keep their ``x @ params["W"]`` spelling: a tensor's ``@`` hands an
operand it does not know to ``__rmatmul__``, which routes the product
through the ``quantized_matmul`` op, so the int8 payload stays the only
full-size weight buffer. ``torch.matmul``, ``F.linear`` and
``torch.einsum`` do not defer that way: a weight site spells the product
with ``@`` or calls the op.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.registry import op
import deeplearning4j_tpu_torch.ops.quantized  # noqa: F401  (registers the ops)


class QuantizedTensor:
    """A weight stored as ``q`` (int8) with ``scale`` (float) per slice of
    ``axis``, symmetric absmax: ``w ≈ q * scale`` broadcast over ``axis``.
    ``axis`` names the weight's output-channel axis, which a consumer keeps
    trailing in its result so the scale applies to the accumulator."""

    __slots__ = ("q", "scale", "axis")
    is_quantized = True

    def __init__(self, q, scale, axis: int = -1):
        self.q = q
        self.scale = scale
        self.axis = int(axis)

    # ------------------------------------------------------- tree node
    def tree_flatten(self):
        return (self.q, self.scale), self.axis

    @classmethod
    def tree_unflatten(cls, axis, children):
        q, scale = children
        return cls(q, scale, axis)

    # --------------------------------------------------- tensor surface
    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def dtype(self):
        """The logical dtype: what a consumer gets back out."""
        return self.scale.dtype

    @property
    def device(self):
        return self.q.device

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"axis={self.axis}, scale_shape={tuple(self.scale.shape)})")

    # -------------------------------------------------------- consumers
    def __rmatmul__(self, x):
        """``x @ qw``: the dense spelling. The quantized axis must be the
        weight's last (output channels)."""
        if self.axis not in (-1, self.q.dim() - 1):
            raise ValueError(
                f"matmul needs the quantized axis last (axis={self.axis})")
        return op("quantized_matmul")(x, self.q, self.scale)

    def __getitem__(self, idx):
        """Row gather (the embedding spelling): dequantizes only the
        gathered rows, activation-sized, never the whole table."""
        rows = self.q[idx]
        return rows.to(self.scale.dtype) * self.scale

    def astype(self, dtype):
        """A dtype cast keeps the int8 payload; only the scale moves."""
        return QuantizedTensor(self.q, self.scale.to(dtype), self.axis)

    def to(self, *args, **kwargs):
        """``to(dtype)`` casts the scale alone (as :meth:`astype`);
        ``to(device)`` moves both the payload and the scale."""
        dtype, device = kwargs.pop("dtype", None), kwargs.pop("device", None)
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            else:
                device = a
        q, scale = self.q, self.scale
        if device is not None:
            q, scale = q.to(device, **kwargs), scale.to(device, **kwargs)
        if dtype is not None:
            scale = scale.to(dtype)
        return QuantizedTensor(q, scale, self.axis)

    def dequantize(self):
        """The float weight, materialized: for tests only. No inference
        path may call this; the witness (``quantize.witness``) checks."""
        scale = self.scale.reshape(_scale_shape(self.q.dim(), self.axis,
                                                self.scale.numel()))
        return self.q.to(self.scale.dtype) * scale

    def nbytes(self) -> int:
        return int(self.q.numel()) + int(
            self.scale.numel()) * self.scale.element_size()


def _reduce_axes(ndim: int, axis: int):
    axis = axis % ndim
    return tuple(a for a in range(ndim) if a != axis)


def _scale_shape(ndim: int, axis: int, n: int):
    """The scale's shape broadcast against the weight: ``n`` on ``axis``,
    1 elsewhere."""
    shape = [1] * ndim
    shape[axis % ndim] = n
    return shape


def quantize_tensor(w, axis: int = -1, dtype: str = "int8") -> QuantizedTensor:
    """Symmetric absmax int8 quantization of ``w`` per slice of ``axis``
    (the output-channel axis): ``scale = absmax / 127``, ``q = rint(w /
    scale)`` clipped to [-127, 127]. On the host in numpy, as the JAX
    package computes it (a post-training pass), so the payload and the
    scales are its bit for bit; the result lies on ``w``'s device."""
    if dtype != "int8":
        raise ValueError(f"unsupported quantization dtype {dtype!r}")
    device = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    axis = axis % w.ndim
    red = _reduce_axes(w.ndim, axis)
    absmax = np.abs(w).max(axis=red) if red else np.abs(w)
    scale = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / np.expand_dims(scale, red)), -127,
                127).astype(np.int8)
    return QuantizedTensor(torch.from_numpy(q).to(device),
                           torch.from_numpy(scale).to(device), axis)


def dequantize_tensor(t: QuantizedTensor):
    return t.dequantize()
