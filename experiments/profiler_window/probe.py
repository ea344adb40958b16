"""How many of a short window's kernel launches the profiler records, on the
card, in a process that runs nothing else.

``chip_smoke.py`` phase 25 profiles a window of 10 ``output()`` calls of an
imported TF graph (Placeholder [128, 54, 54, 96] -> LRN) and counts the
LRN forward kernel's device records. This script profiles the same window,
alone: 1, 10 and 50 calls, four times each, with the device activity alone
and with the host's beside it; then a window of 6,000 small kernels; then
the same windows again. Each entry is [records of lrn_fwd_kernel, device
records in all] for one window.

Run from the root of a checkout, on the card:

    python3 experiments/profiler_window/probe.py

It prints the card's name and power limit and, last, one JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import TFGraphMapper  # noqa: E402
from deeplearning4j_tpu_torch.ops.cuda import LRN_FWD  # noqa: E402

SHAPE = (128, 54, 54, 96)
ACTIVITIES = {"cuda": [ProfilerActivity.CUDA],
              "cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}


def records(fn, calls, activities):
    """[lrn_fwd_kernel records, all device records] of one profiled window
    of ``calls`` calls of ``fn`` (after one call outside it)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    lrn = total = 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total += e.count
            if "lrn_fwd_kernel" in e.key:
                lrn += e.count
    return [lrn, total]


def sweep(fn, tag):
    return {f"{tag}/{name}/{calls}_calls": [records(fn, calls, acts)
                                            for _ in range(4)]
            for name, acts in ACTIVITIES.items() for calls in (1, 10, 50)}


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this probe needs the "
                "card")
    print(cs.card_line(), flush=True)
    LRN_FWD.library.load()
    x = torch.randn(SHAPE, device="cuda")
    imp = TFGraphMapper.import_graph(cs.lrn_graph_def(SHAPE))

    def call():
        return imp.output({"x": x}, ["lrn"])

    out = sweep(call, "fresh")
    a = torch.randn(256, 256, device="cuda")

    def many():
        for _ in range(6000):
            torch.relu(a)

    big, _ = cs.profile_device(torch, many, 1)
    out["large_window_records"] = sum(c for _, c in big.values())
    out.update(sweep(call, "after_large_window"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
