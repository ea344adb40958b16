"""Fixed-capacity slot pool: per-sequence decode state on the device.

Counterpart of ``deeplearning4j_tpu/generation/slots.py``. The pool is one
state tree whose every tensor has a leading ``[n_slots, ...]`` axis (the
per-layer carry tuples of a recurrent net: (h, c) for an LSTM, (h,) for a
GRU; the KV rings of a transformer) plus small host-side numpy arrays
(next token, absolute position, sampler knobs). Every decode step runs the
whole pool, so the kernels always see the same batch shape.

The pool's tensors are allocated once and never rebound: admission copies
the newcomer's prefill result into its slot's ENTIRE state row, in place,
so nothing a retired sequence left behind can leak into it and a captured
CUDA graph that reads the pool keeps its addresses. Eviction is host-side
only: the stale row is dead weight until the next admission overwrites it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np


class SlotPool:
    """``n_slots`` sequence slots: device state tree + host scheduling arrays."""

    def __init__(self, n_slots: int, init_state: Callable[[int], Any]):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.state = init_state(n_slots)
        self.tokens = np.zeros((n_slots,), np.int64)
        self.pos = np.zeros((n_slots,), np.int64)
        self.active = np.zeros((n_slots,), bool)
        self.seeds = np.zeros((n_slots,), np.uint32)
        self.temps = np.zeros((n_slots,), np.float32)
        self.top_k = np.zeros((n_slots,), np.int32)
        self.top_p = np.ones((n_slots,), np.float32)
        self.meta: List[Optional[Any]] = [None] * n_slots

    def free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if not self.active[i]]

    def active_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if self.active[i]]

    def occupancy(self) -> int:
        return int(self.active.sum())

    def admit(self, slot: int, sub_state: Any, *, token: int, pos: int,
              seed: int, temperature: float, top_k: int, top_p: float,
              meta: Any = None) -> None:
        """Claim ``slot``: copy ``sub_state`` ({layer: tuple of tensors
        [1, ...]}, the pool's structure) into its whole state row, in
        place, and set its host scheduling entries."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        for layer, rows in self.state.items():
            for dst, src in zip(rows, sub_state[layer]):
                dst[slot].copy_(src[0])
        self.tokens[slot] = token
        self.pos[slot] = pos
        self.seeds[slot] = np.uint32(seed)
        self.temps[slot] = temperature
        self.top_k[slot] = top_k
        self.top_p[slot] = top_p
        self.meta[slot] = meta
        self.active[slot] = True

    def retire(self, slot: int) -> Any:
        """Release ``slot`` (host-side only); returns the slot's meta."""
        meta, self.meta[slot] = self.meta[slot], None
        self.active[slot] = False
        return meta
