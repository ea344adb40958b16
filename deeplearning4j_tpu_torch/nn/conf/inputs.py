"""Input-type shape inference.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py`` (a copy: the module
is framework-free). The convolutional layout is NHWC, as in the JAX package;
shapes exclude the batch dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnn_flat" | "cnn3d"
    shape: tuple  # without batch dim; cnn = (h, w, c) NHWC; rnn = (t, f)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", (int(size),))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", (timesteps, int(size)))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", (int(height), int(width), int(channels)))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn_flat", (int(height), int(width), int(channels)))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn3d", (int(depth), int(height), int(width), int(channels)))

    @property
    def size(self) -> int:
        """Flat feature count (nIn for a Dense layer fed this input)."""
        if self.kind == "ff":
            return self.shape[0]
        if self.kind == "rnn":
            return self.shape[1]
        n = 1
        for d in self.shape:
            if d is None:
                raise ValueError(f"cannot flatten input type with unknown dim: {self}")
            n *= d
        return n

    @property
    def channels(self) -> int:
        if self.kind not in ("cnn", "cnn_flat", "cnn3d"):
            raise ValueError(f"not a convolutional input: {self}")
        return self.shape[-1]

    def array_shape(self, batch: int | None = None) -> tuple:
        """Concrete array shape (NHWC / NTF), batch-first if batch given."""
        s = self.shape if self.kind != "cnn_flat" else (self.size,)
        return s if batch is None else (batch,) + s

    def to_dict(self):
        return {"kind": self.kind, "shape": list(self.shape)}

    @staticmethod
    def from_dict(d):
        return InputType(d["kind"], tuple(d["shape"]))
