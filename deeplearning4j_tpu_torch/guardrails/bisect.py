"""Deterministic bad-batch bisection.

Counterpart of ``deeplearning4j_tpu/guardrails/bisect.py``, copied. After a
rollback the guardrail knows the trip reproduces somewhere in the replayed
window (data order is seeded, so replay is exact) but not which batch
planted it: under async dispatch the trip is only discovered at drain,
steps after the culprit was applied, and a corruption that stays finite
can pass its own screens and only derail later steps. Bisection finds the
first batch whose application makes the window unhealthy in O(log n)
rounds of replay instead of O(n).
"""

from __future__ import annotations


def bisect_culprit(n, run_range, snapshot, restore):
    """Index of the first batch whose application trips the window.

    ``run_range(i, j)`` applies batches ``[i, j)`` to the live model state
    and returns True when the range tripped (it may stop early at the
    trip); ``snapshot()`` / ``restore(s)`` save and restore the live
    state around a probe. Loop invariant: entering each round, batches
    ``[0, lo)`` are applied and the trip reproduces in ``[lo, hi)``.

    Returns ``(culprit_index, rounds)`` — a window of 1 needs 0 rounds.
    The caller is responsible for restoring the state it wants afterwards;
    on return the live state has ``[0, culprit_index)`` applied.
    """
    if n <= 0:
        raise ValueError("empty replay window")
    lo, hi = 0, n
    rounds = 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        rounds += 1
        snap = snapshot()
        if run_range(lo, mid):
            hi = mid
            restore(snap)
        else:
            lo = mid
    return lo, rounds
