"""Workspace — scoped arena memory.

Counterpart of ``deeplearning4j_tpu/native/workspace.py``, copied over the
port's native library.

Reference analog: org.nd4j.linalg.api.memory.MemoryWorkspace /
libnd4j memory::Workspace — scoped bump allocation with reset, peak
tracking, and heap spill when the arena is exhausted. On the card the
DEVICE side of workspaces is PyTorch's caching allocator; this arena covers
the host-staging role (batch assembly, serialization buffers).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.native.lib import load_native_lib


class Workspace:
    """Context-managed arena: numpy views into native memory.

        with Workspace(16 << 20) as ws:
            a = ws.alloc((1024, 1024), np.float32)
            ...
        # exit resets the arena (use-after-scope = reading stale data,
        # exactly the hazard the reference's debug mode traps)
    """

    def __init__(self, size_bytes: int):
        self._lib = load_native_lib()
        self.size = size_bytes
        self._handle: Optional[int] = None
        self._py_buffers = []  # python fallback
        if self._lib is not None:
            self._handle = self._lib.dl4j_ws_create(size_bytes)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def alloc(self, shape, dtype=np.float32) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self._handle is not None:
            ptr = self._lib.dl4j_ws_alloc(self._handle, nbytes, 64)
            if not ptr:
                raise MemoryError("workspace allocation failed")
            buf = (ctypes.c_char * nbytes).from_address(ptr)
            return np.frombuffer(buf, dtype=dtype).reshape(shape)
        a = np.empty(shape, dtype)
        self._py_buffers.append(a)
        return a

    def used(self) -> int:
        if self._handle is not None:
            return int(self._lib.dl4j_ws_used(self._handle))
        return sum(a.nbytes for a in self._py_buffers)

    def peak(self) -> int:
        if self._handle is not None:
            return int(self._lib.dl4j_ws_peak(self._handle))
        return self.used()

    def spilled(self) -> int:
        if self._handle is not None:
            return int(self._lib.dl4j_ws_spilled(self._handle))
        return 0

    def reset(self):
        if self._handle is not None:
            self._lib.dl4j_ws_reset(self._handle)
        self._py_buffers.clear()

    def destroy(self):
        if self._handle is not None:
            self._lib.dl4j_ws_destroy(self._handle)
            self._handle = None
        self._py_buffers.clear()

    def __enter__(self) -> "Workspace":
        return self

    def __exit__(self, *exc):
        self.reset()

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
