"""HistoryProcessor — frame rescale/crop/stack for pixel RL.

Counterpart of ``deeplearning4j_tpu/rl/history.py``, copied (host numpy, no
framework): the same seeds give the same draws.

Reference analog: org.deeplearning4j.rl4j.learning.HistoryProcessor +
IHistoryProcessor.Configuration (historyLength, rescaledWidth/Height,
croppingWidth/Height, skipFrame). Host-side numpy: the device only ever
sees the stacked [H, W, history] tensor.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HistoryConfiguration:
    """IHistoryProcessor.Configuration analog."""
    history_length: int = 4
    rescaled_height: Optional[int] = None
    rescaled_width: Optional[int] = None
    crop_top: int = 0
    crop_bottom: int = 0
    crop_left: int = 0
    crop_right: int = 0
    # the reference Configuration also carries skipFrame; action repeat is
    # an environment-loop concern here — use rl.env.FrameSkipWrapper


class HistoryProcessor:
    """Crop -> rescale -> grayscale -> stack last `history_length` frames.

    ``observe(frame)`` ingests a raw frame ([H, W] or [H, W, C]) and returns
    the current stacked observation [h, w, history_length] (most recent
    frame last). Before the stack fills, the earliest frame is repeated,
    matching the reference's startup padding.
    """

    def __init__(self, config: HistoryConfiguration = None, **kwargs):
        self.config = config or HistoryConfiguration(**kwargs)
        if self.config.history_length < 1:
            raise ValueError("history_length must be >= 1")
        self._frames: deque = deque(maxlen=self.config.history_length)
        self._shape: Optional[Tuple[int, int]] = None

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        if self._shape is None:
            raise ValueError("output_shape unknown until the first observe() "
                             "or set_input_shape() call")
        return (*self._shape, self.config.history_length)

    def set_input_shape(self, height: int, width: int) -> "HistoryProcessor":
        """Declare the raw frame size up front so output_shape is available
        before the first frame (needed to build the Q-net)."""
        self._shape = self._processed_shape(height, width)
        return self

    def _processed_shape(self, h: int, w: int) -> Tuple[int, int]:
        c = self.config
        h = h - c.crop_top - c.crop_bottom
        w = w - c.crop_left - c.crop_right
        if h <= 0 or w <= 0:
            raise ValueError("cropping removes the whole frame")
        return (c.rescaled_height or h, c.rescaled_width or w)

    def _process(self, frame: np.ndarray) -> np.ndarray:
        c = self.config
        f = np.asarray(frame, np.float32)
        if f.ndim == 3:  # grayscale via channel mean (reference: RGB->gray)
            f = f.mean(axis=-1)
        h, w = f.shape
        f = f[c.crop_top:h - c.crop_bottom or None,
              c.crop_left:w - c.crop_right or None]
        th, tw = self._processed_shape(h, w)
        if f.shape != (th, tw):
            # nearest-neighbour rescale: index sampling keeps this pure numpy
            ri = (np.arange(th) * f.shape[0] / th).astype(np.int64)
            ci = (np.arange(tw) * f.shape[1] / tw).astype(np.int64)
            f = f[ri][:, ci]
        return f

    def reset(self):
        self._frames.clear()

    def observe(self, frame: np.ndarray) -> np.ndarray:
        f = self._process(frame)
        if self._shape is None:
            self._shape = f.shape
        if not self._frames:
            for _ in range(self.config.history_length):
                self._frames.append(f)
        else:
            self._frames.append(f)
        return np.stack(self._frames, axis=-1)
