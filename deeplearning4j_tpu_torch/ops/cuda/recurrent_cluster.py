"""The thread-block-cluster layer of the recurrent kernels, as their
launchers see it: the Python mirror of ``csrc/recurrent_cluster.cuh``.

The GRU and LSTM forwards and backwards each have two designs:
at T > 1, where a thread-block cluster can hold R in shared memory, a
cluster kernel; elsewhere a stream kernel that reads R from L2 every step.
The GRU's have a third past the cluster's width, on the grid layer
(``recurrent_grid.py``).
The C launchers choose by shape and by what the card can co-schedule
(``plan_cluster``), never by a failed launch. Each family's ``fwd_design``
/ ``bwd_design`` repeats that choice here, so that the CPU tests can hold
it at its boundaries and ``chip_smoke.py`` can hold each launcher to it;
:func:`launcher_design` asks the C launcher itself.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

#: csrc/recurrent_cluster.cuh (kClusterWarps, kClusterUnits, kClusterSizes,
#: kClusterSmemCap): the warps of a cluster CTA (the forwards' k-slices a
#: step), the hidden units a CTA owns at most (one a lane), the cluster
#: sizes in order of choice, and the shared memory a block may use
CLUSTER_WARPS = 8
CLUSTER_UNITS = 32
CLUSTER_SIZES = (8, 16)
CLUSTER_SMEM_CAP = 227 * 1024

#: ``active_clusters(C, rows, smem)``: how many clusters of C CTAs of a
#: kernel's instance for ``rows`` rows, ``smem`` bytes each, the card holds
ActiveClusters = Callable[[int, int, int], int]


class Design(NamedTuple):
    """What a launcher runs: ``kind`` "cluster", "grid" or "stream",
    ``cluster`` CTAs a cluster (None unless cluster), ``rows`` batch rows a
    cluster (a grid row group, a stream block), ``smem`` dynamic shared
    memory bytes of a block; for the grid design alone (None otherwise)
    ``units`` hidden units a CTA, ``ctas`` CTAs a row group and ``groups``
    the groups launched together (``recurrent_grid.py``)."""
    kind: str
    cluster: Optional[int]
    rows: int
    smem: int
    units: Optional[int] = None
    ctas: Optional[int] = None
    groups: Optional[int] = None


def rows_max(B: int) -> int:
    """The most rows a cluster or stream block takes: B rounded up to a
    power of two, at most 8."""
    rb = 1
    while rb < 8 and rb < B:
        rb *= 2
    return rb


def cluster_units(H: int, C: int) -> int:
    """Hidden units a CTA owns in a cluster of C: ceil(H / C), rounded up
    to even (``cluster_units``)."""
    return (-(-H // C) + 1) & ~1


def fwd_cluster_smem_bytes(rb: int, H: int, gates: int, e: int) -> int:
    """A forward cluster CTA's shared memory for RB rows, ``gates`` gates
    and elements of ``e`` bytes (``fwd_cluster_smem_bytes``): its R columns
    [HP][gates][32], h by step parity [2][RB][HP] f32 and the k-slices'
    partial sums."""
    hp = (H + 3) & ~3
    return hp * gates * CLUSTER_UNITS * e + 4 * (
        2 * rb * hp + CLUSTER_WARPS * gates * rb * 32)


def bwd_cluster_smem_bytes(rb: int, H: int, C: int, gates: int,
                           e: int) -> int:
    """A backward cluster CTA's shared memory for RB rows, a cluster of C,
    ``gates`` gates and elements of ``e`` bytes
    (``bwd_cluster_smem_bytes``): its R columns [HP][gates x 32 + one word
    of padding], the product operands [RB][gates][32] f32 and the receive
    slots [2][C][RB][32] f32."""
    hp = (H + 3) & ~3
    return hp * (gates * CLUSTER_UNITS + 4 // e) * e + 4 * (
        rb * gates * 32 + 2 * C * rb * 32)


def plan_cluster(B: int, H: int, smem_of: Callable[[int, int], int],
                 active_clusters: ActiveClusters) -> Optional[Design]:
    """The cluster a [T > 1, B, *, H] call takes (``plan_cluster``), or
    None: the first cluster size that gives a CTA at most 32 units; rows a
    cluster the fewest (a power of two, up to 8) that let every cluster be
    resident at one CTA an SM, halved while ``smem_of(rows, C)`` exceeds
    the cap; and the card must hold one such cluster."""
    C = next((c for c in CLUSTER_SIZES
              if cluster_units(H, c) <= CLUSTER_UNITS), None)
    if C is None:
        return None
    slots = active_clusters(C, 1, CLUSTER_SMEM_CAP)
    rb, top = 1, rows_max(B)
    while rb < top and -(-B // rb) > slots:
        rb *= 2
    while rb > 1 and smem_of(rb, C) > CLUSTER_SMEM_CAP:
        rb //= 2
    smem = smem_of(rb, C)
    if smem <= CLUSTER_SMEM_CAP and active_clusters(C, rb, smem) >= 1:
        return Design("cluster", C, rb, smem)
    return None


def query(kernel, symbol: str, n_out: int, device, *args,
          ctype=ctypes.c_int) -> list:
    """Call one of ``kernel``'s query functions on ``device`` (None: the
    current card); returns its ``n_out`` outputs of C type ``ctype``."""
    from deeplearning4j_tpu_torch.ops.cuda.build import check_status

    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    out = (ctype * n_out)()
    lib = kernel.library.load(device)
    with torch.cuda.device(device):
        check_status(lib, getattr(lib, symbol)(*args, out), symbol)
    return list(out)


def card_active_clusters(kernel, symbol: str, dtype: torch.dtype,
                         device=None) -> ActiveClusters:
    """``active_clusters`` from the card: ``symbol`` of ``kernel``'s library
    (``cudaOccupancyMaxActiveClusters`` of its cluster kernel's instance for
    that many rows). Nothing is asked until it is called."""
    bf16 = int(dtype == torch.bfloat16)
    return lambda C, rows, smem: query(kernel, symbol, 1, device, bf16, rows,
                                       C, int(smem))[0]


def launcher_design(kernel, symbol: str, T: int, B: int, H: int,
                    dtype: torch.dtype, device=None) -> Design:
    """The C launcher's own choice (``symbol``, a ``dl4j_*_plan``) on the
    card."""
    cluster, C, rb, smem = query(kernel, symbol, 4, device, T, B, H,
                                 int(dtype == torch.bfloat16))
    return Design("cluster" if cluster else "stream", C or None, rb, smem)
