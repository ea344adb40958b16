"""Power-of-two shape buckets, and a warm-up pass over them.

Counterpart of ``deeplearning4j_tpu/serving/warmup.py``. A server that pads
every batch (or prompt) to a bucket sees only the bucket shapes, so it can
run each once at load: here that builds the kernels, fills the op
registry's choice cache and the recurrent launchers' plan caches, and
warms PyTorch's allocator, before any request waits on them. The
generation engine pads attention prompts to these buckets
(``bucket_for(n - 1, pow2_buckets(max_len - 1))``). With monitoring on and
a (model, version) label pair, each bucket's warm-up lands in
``dl4j_serving_warmup_seconds``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def pow2_buckets(batch_limit: int) -> Tuple[int, ...]:
    """The sizes a pad-to-bucket server dispatches: powers of two clamped
    to the limit, plus the limit itself (a limit that is no power of
    two)."""
    if batch_limit < 1:
        raise ValueError("batch_limit must be >= 1")
    return tuple(sorted({min(1 << i, batch_limit)
                         for i in range(batch_limit.bit_length() + 1)}))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n (the shape a size-n batch pads to); the
    largest bucket when n exceeds them all (the dispatcher splits)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def warmup_model(model, example_shape: Sequence[int],
                 buckets: Sequence[int],
                 dtype=np.float32,
                 labels: Optional[Tuple[str, str]] = None) -> Dict[int, float]:
    """``model.output`` once per bucket on zeros of ``(bucket,
    *example_shape)``; returns {bucket: seconds}, each synced to the
    device. ``labels``: an optional (model, version) pair for the
    warm-up duration histogram."""
    from deeplearning4j_tpu_torch import monitoring

    timings: Dict[int, float] = {}
    shape = tuple(int(d) for d in example_shape)
    for b in sorted(set(int(b) for b in buckets)):
        x = np.zeros((b,) + shape, dtype)
        t0 = time.perf_counter()
        out = model.output(x)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
        timings[b] = time.perf_counter() - t0
    mon = monitoring.serving_monitor()
    if mon is not None and labels is not None:
        for dt in timings.values():
            mon.warmup_seconds.labels(model=labels[0],
                                      version=labels[1]).observe(dt)
    return timings
