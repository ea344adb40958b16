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
pass, which the wrappers allocate.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.ops.cuda.recurrent_cluster import Design, query

#: csrc/recurrent_grid.cuh (kGridWarps, kGridSlots, kGridStage,
#: kGridStagePad, kGridOperandPad, kGridRows, kGridSmemCap): the warps of a
#: grid CTA, the unit slots of a half-warp (a slot holds one f32 unit or a
#: bf16 pair), the floats of h a stage holds and the padding after each
#: staged row and each backward operand row, the rows a group in order of
#: choice, and the shared memory a block may use
GRID_WARPS = 8
GRID_SLOTS = 16
GRID_STAGE = 2048
GRID_STAGE_PAD = 8
GRID_OPERAND_PAD = 8
GRID_ROWS = (8, 16, 32)
GRID_SMEM_CAP = 227 * 1024

#: ``co_resident(rows, smem)``: how many CTAs of a grid kernel's instance
#: for ``rows`` rows, ``smem`` bytes each, the card holds at once
CoResident = Callable[[int, int], int]


def grid_units(e: int) -> int:
    """Hidden units a CTA owns at most for elements of ``e`` bytes
    (``grid_units``): 16 in f32, 32 in bf16."""
    return GRID_SLOTS * 4 // e


def grid_hp(H: int) -> int:
    """H rounded up to 16 (``grid_hp``)."""
    return (H + 15) & ~15


#: floats of one h stage buffer, its rows padded (``kGridStageFloats``)
GRID_STAGE_FLOATS = GRID_STAGE + GRID_STAGE_PAD * 32


def fwd_grid_smem_bytes(H: int, gates: int) -> int:
    """A forward grid CTA's shared memory (``fwd_grid_smem_bytes``): its R
    columns [HP][gates x 16 + 4 words of padding] and two h stages."""
    return grid_hp(H) * (gates * GRID_SLOTS + 4) * 4 + 2 * 4 * \
        GRID_STAGE_FLOATS


def bwd_grid_row(gates: int, e: int) -> int:
    """Words of a backward grid CTA's resident row (``bwd_grid_row``): the
    gates' 16 slots and one word of padding in f32, four in bf16."""
    return gates * GRID_SLOTS + (4 if e == 2 else 1)


def bwd_grid_smem_bytes(rb: int, H: int, gates: int, e: int) -> int:
    """A backward grid CTA's shared memory (``bwd_grid_smem_bytes``): its R
    columns [HP][:func:`bwd_grid_row`] and the product operands [RB][gates
    x units + GRID_OPERAND_PAD] f32."""
    return grid_hp(H) * bwd_grid_row(gates, e) * 4 + 4 * rb * (
        gates * grid_units(e) + GRID_OPERAND_PAD)


def plan_grid(B: int, H: int, e: int, smem_of: Callable[[int], int],
              co_resident: CoResident) -> Optional[Design]:
    """The grid a [T > 1, B, *, H] call takes (``plan_grid``), or None: H
    split evenly over the fewest CTAs of at most :func:`grid_units` units;
    rows a group the fewest of ``GRID_ROWS`` whose ceil(B / rows) groups
    the card holds at once, else the most rows that fit in as many groups
    as it holds (each group then takes several passes over B). None where
    ``smem_of(rows)`` is over the cap or the card holds no row group."""
    ul = grid_units(e)
    n0 = -(-H // ul)
    U = -(-H // n0)
    n = -(-H // U)
    plan = None
    for rb in GRID_ROWS:
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
    return lambda rows, smem: query(kernel, symbol, 1, device, bf16, rows,
                                    int(smem))[0]
