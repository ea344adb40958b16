"""The grid-resident layer of the recurrent kernels, as their launchers see
it: the Python mirror of ``csrc/recurrent_grid.cuh``.

Past the width a thread-block cluster holds, R is split across more CTAs
than a cluster has: CTA c of a row group of n keeps its units' gate
columns of R in shared memory for all T steps, and a group's CTAs share
each step's h (or partial carries) through L2 with one barrier a step. The
C launchers take this design at T > 1 where no cluster holds R and the
card holds a row group (``plan_grid``); :func:`plan_grid` repeats that
choice here, so that the CPU tests can hold it at its boundaries without
a card. The launchers' plan queries also report the workspace a call must
pass, which the wrappers allocate (:func:`launcher_plan`,
:func:`workspace`).

The unit slots of a CTA are the layer's parameter: the GRU's kernels take
``GRID_SLOTS`` (16), the LSTM's ``LSTM_GRID_SLOTS`` (8), so that an LSTM
CTA's four gate columns of R still fit at H = 1024, and the LSTM
forward's row groups may take ``LSTM_GRID_ROWS`` (up to 64 rows).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.ops.cuda import recurrent_cluster as rc
from deeplearning4j_tpu_torch.ops.cuda.recurrent_cluster import Design

#: csrc/recurrent_grid.cuh (kGridWarps, kGridSlots, kLstmGridSlots,
#: kGridStage, kGridStagePad, kGridOperandPad, kGridRows, kLstmGridRows,
#: kGridSmemCap): the warps of a grid CTA, the unit slots of a CTA (a slot
#: holds one f32 unit or a bf16 pair) of the GRU's kernels and of the
#: LSTM's, the floats of h a stage holds and the padding after each staged
#: row and each backward operand row, the rows a group in order of choice
#: (the GRU's and the LSTM backward's, the LSTM forward's), and the shared
#: memory a block may use
GRID_WARPS = 8
GRID_SLOTS = 16
LSTM_GRID_SLOTS = 8
GRID_STAGE = 2048
GRID_STAGE_PAD = 8
GRID_OPERAND_PAD = 8
GRID_ROWS = (8, 16, 32)
LSTM_GRID_ROWS = (8, 16, 32, 64)
GRID_SMEM_CAP = 227 * 1024

#: ``co_resident(rows, smem)``: how many CTAs of a grid kernel's instance
#: for ``rows`` rows, ``smem`` bytes each, the card holds at once
CoResident = Callable[[int, int], int]


def grid_units(e: int, slots: int = GRID_SLOTS) -> int:
    """Hidden units a CTA owns at most for elements of ``e`` bytes and
    ``slots`` unit slots (``grid_units``): at the GRU's 16, 16 in f32 and
    32 in bf16."""
    return slots * 4 // e


def grid_hp(H: int) -> int:
    """H rounded up to 16 (``grid_hp``)."""
    return (H + 15) & ~15


def grid_stage_floats(rows: int) -> int:
    """Floats of one h stage buffer for up to ``rows`` rows, each padded
    (``grid_stage_floats``)."""
    return GRID_STAGE + GRID_STAGE_PAD * rows


#: floats of one h stage buffer of the GRU's kernels (``kGridStageFloats``)
GRID_STAGE_FLOATS = grid_stage_floats(32)


def fwd_grid_smem_bytes(H: int, gates: int, slots: int = GRID_SLOTS,
                        rows: int = 32) -> int:
    """A forward grid CTA's shared memory (``fwd_grid_smem_bytes``): its R
    columns [HP][gates x slots + 4 words of padding] and two h stages for
    up to ``rows`` rows."""
    return grid_hp(H) * (gates * slots + 4) * 4 + 2 * 4 * \
        grid_stage_floats(rows)


def bwd_grid_row(gates: int, e: int, slots: int = GRID_SLOTS) -> int:
    """Words of a backward grid CTA's resident row (``bwd_grid_row``): the
    gates' slots and one word of padding in f32, four in bf16."""
    return gates * slots + (4 if e == 2 else 1)


def bwd_grid_smem_bytes(rb: int, H: int, gates: int, e: int,
                        slots: int = GRID_SLOTS) -> int:
    """A backward grid CTA's shared memory (``bwd_grid_smem_bytes``): its R
    columns [HP][:func:`bwd_grid_row`] and the product operands [RB][gates
    x units + GRID_OPERAND_PAD] f32."""
    return grid_hp(H) * bwd_grid_row(gates, e, slots) * 4 + 4 * rb * (
        gates * grid_units(e, slots) + GRID_OPERAND_PAD)


def plan_grid(B: int, H: int, e: int, smem_of: Callable[[int], int],
              co_resident: CoResident, slots: int = GRID_SLOTS,
              rows=GRID_ROWS) -> Optional[Design]:
    """The grid a [T > 1, B, *, H] call takes (``plan_grid``), or None: H
    split evenly over the fewest CTAs of at most :func:`grid_units` units
    (for ``slots`` slots); rows a group the fewest of ``rows`` whose
    ceil(B / rows) groups the card holds at once, else the most rows that
    fit in as many groups as it holds (each group then takes several
    passes over B). None where ``smem_of(rows)`` is over the cap or the
    card holds no row group."""
    ul = grid_units(e, slots)
    n0 = -(-H // ul)
    U = -(-H // n0)
    n = -(-H // U)
    plan = None
    for rb in rows:
        smem = smem_of(rb)
        if smem > GRID_SMEM_CAP:
            break
        most = co_resident(rb, smem) // n
        if most < 1:
            continue
        need = -(-B // rb)
        plan = Design("grid", None, rb, smem, U, n, min(need, most))
        if need <= most:
            break
    return plan


def card_co_resident(kernel, symbol: str, dtype: torch.dtype,
                     device=None) -> CoResident:
    """``co_resident`` from the card: ``symbol`` of ``kernel``'s library
    (blocks an SM of its grid kernel's instance for that many rows, times
    the SMs). Nothing is asked until it is called."""
    bf16 = int(dtype == torch.bfloat16)
    return lambda rows, smem: rc.query(kernel, symbol, 1, device, bf16, rows,
                                       int(smem))[0]


def launcher_plan(kernel, symbol: str, T: int, B: int, H: int,
                  dtype: torch.dtype, device=None) -> tuple[Design, int]:
    """A C launcher's own plan (``symbol``, a ``dl4j_*_plan`` of a kernel
    with a grid design) on the card: its :class:`Design` and the workspace
    bytes a call must pass (0 unless grid)."""
    kind, C, rb, smem, units, ctas, groups, work = rc.query(
        kernel, symbol, 8, device, T, B, H, int(dtype == torch.bfloat16),
        ctype=ctypes.c_longlong)
    if kind == 2:
        return Design("grid", None, rb, smem, units, ctas, groups), work
    return Design("cluster" if kind else "stream", C or None, rb, smem), 0


def workspace(nbytes: int, like: torch.Tensor):
    """The workspace a launcher's plan asks for (``nbytes`` bytes on
    ``like``'s device; the grid design's), or None where it asks for
    none."""
    return like.new_empty(nbytes, dtype=torch.uint8) if nbytes else None


def nbytes(work) -> int:
    """The bytes of a workspace from :func:`workspace` (0 for None)."""
    return 0 if work is None else work.numel()
