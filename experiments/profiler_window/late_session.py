"""Which device records a profiler session loses late in a long process,
on the card.

Runs ``chip_smoke.main()`` whole, with two changes: a failed check is
printed and the run goes on, and each window that phases 32 and 35 count
(``chip_smoke.profiled_launches``) is profiled without the lead-in of
spin kernels. A window whose device records differ from the host's
launches is profiled again three ways: the same, with the host's
activity beside the device's, and behind a synced sleep kernel at each
end. Every window's records are written to
``chiprun_out/late_session_<kernels>_<time>_<way>.json`` and summed up
on a ``DIAG`` line: device records, host launch calls, the launch calls
that have no device record (their offset in the window, and the device
records next to them by correlation id), and the records of each kernel
of the window. Then a fresh process profiles the same tBPTT window twice
(``--fresh``) for comparison.

Run from the root of a checkout, on the card (about 6 minutes):

    python3 experiments/profiler_window/late_session.py

It prints the smoke's own lines, the ``DIAG`` lines, the fresh process's
lines and, last, the failed checks as one JSON list.
"""

from __future__ import annotations

import bisect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "chiprun_out"
FAILS = []


def soft_fail(msg):
    print(f"chip_smoke: FAIL (continuing): {msg}", file=sys.stderr,
          flush=True)
    FAILS.append(msg)


def dump_events(prof, tag):
    """Every kineto record of ``prof`` as a dict, written to OUT."""
    rows = []
    for e in prof.profiler.kineto_results.events():
        r = {}
        for k in ("name", "device_type", "start_ns", "duration_ns",
                  "correlation_id", "linked_correlation_id",
                  "activity_type", "device_index", "device_resource_id",
                  "start_thread_id"):
            try:
                v = getattr(e, k)()
                r[k] = v if isinstance(v, (int, float, str)) else str(v)
            except Exception as ex:
                r[k] = f"?{ex.__class__.__name__}"
        rows.append(r)
    OUT.mkdir(exist_ok=True)
    with open(OUT / f"late_session_{tag}.json", "w") as f:
        json.dump(rows, f)
    return rows


def analyse(rows, pats, tag):
    """The window's records summed up (see the module docstring)."""
    dev = [r for r in rows if str(r["device_type"]).endswith("CUDA")]
    cpu = [r for r in rows if not str(r["device_type"]).endswith("CUDA")]
    launch = [r for r in cpu if "aunch" in str(r["name"])]
    dev_by_corr = {}
    for r in dev:
        dev_by_corr.setdefault(r["linked_correlation_id"], []).append(r)
        dev_by_corr.setdefault(r["correlation_id"], []).append(r)
    unmatched = [r for r in launch if r["correlation_id"] not in dev_by_corr]
    t0 = min(r["start_ns"] for r in rows) if rows else 0
    hits = {n: sorted((r["start_ns"] - t0) for r in dev if n in str(r["name"]))
            for n in pats}
    names = {}
    for r in dev:
        names[r["name"]] = names.get(r["name"], 0) + 1
    info = {
        "tag": tag, "events": len(rows), "device_events": len(dev),
        "launch_events": len(launch),
        "unmatched_launches": [
            {k: u[k] for k in ("name", "start_ns", "correlation_id")}
            | {"at_us": (u["start_ns"] - t0) / 1e3} for u in unmatched[:10]],
        "n_unmatched": len(unmatched),
        "hits": {n: len(v) for n, v in hits.items()},
        "first_hits_us": {n: [x / 1e3 for x in v[:3]]
                          for n, v in hits.items()},
        "last_hits_us": {n: [x / 1e3 for x in v[-3:]]
                         for n, v in hits.items()},
        "first_device_us": sorted((r["start_ns"] - t0) / 1e3
                                  for r in dev)[:3],
        "names_with_lstm": {k: v for k, v in names.items()
                            if "lstm" in k.lower() or "flash" in k.lower()},
        "mangled_like": [k for k in names if k.startswith("_Z")][:10]}
    by_corr = sorted(dev, key=lambda r: (r["linked_correlation_id"]
                                         or r["correlation_id"]))
    ids = [r["linked_correlation_id"] or r["correlation_id"] for r in by_corr]
    info["unmatched_neighbours"] = [
        [str(by_corr[j]["name"])[:70]
         for j in range(max(0, i - 2), min(len(ids), i + 2))]
        for i in (bisect.bisect(ids, u["correlation_id"])
                  for u in unmatched[:5])]
    return info


def diag_profiled_launches(torch, kernels, fn, tries=3):
    """``chip_smoke.profiled_launches`` without its lead-in, every window
    dumped, a window that falls short profiled again three ways."""
    from torch.profiler import ProfilerActivity, profile

    names = cs.device_functions()
    pats = [f for k in kernels for f in names[k.name]]
    tag = "_".join(k.name for k in kernels) + f"_{int(time.time())}"
    result = None
    ways = [("cuda", [ProfilerActivity.CUDA], False),
            ("cuda_again", [ProfilerActivity.CUDA], False),
            ("cpu_cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA],
             False),
            ("cuda_fenced", [ProfilerActivity.CUDA], True)]
    for i, (way, acts, fenced) in enumerate(ways):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if fenced:
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            if fenced:
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        host = {k.name: k.launches for k in kernels}
        by_kernel = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA") \
                    and cs._device_us(e) > 0:
                by_kernel[e.key] = (cs._device_us(e) / 1e3, e.count)
        device = cs._device_launches(by_kernel, kernels)
        if result is None:
            result = (host, device, by_kernel, wall_ms, 0)
        info = analyse(dump_events(prof, f"{tag}_{way}"), pats,
                       f"{tag}_{way}")
        info.update(host=host, device=device)
        print("DIAG " + json.dumps(info), flush=True)
        if i == 0 and device == host:
            break
    return result


def fresh():
    """A fresh process: one tBPTT call of phase 32, profiled twice."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops.cuda import (
        FUSED_LSTM, FUSED_LSTM_BWD, KERNELS,
    )
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in KERNELS:
        k.library.load()
    net = cs._tbptt_net(torch)
    batches = cs._tbptt_batches(np, cs.SEED + 20, 3, net.layers[-1].n_out)
    for b in batches[:2]:
        net.fit_batch(b)
    drain_scores(net)
    for _ in range(2):
        host, device = diag_profiled_launches(
            torch, [FUSED_LSTM, FUSED_LSTM_BWD],
            lambda: (net.fit_batch(batches[2]), drain_scores(net)))[:2]
        print("fresh", host, device, flush=True)


def main():
    cs.fail = soft_fail
    cs.profiled_launches = diag_profiled_launches
    t0 = time.perf_counter()
    try:
        cs.main()
    except Exception as e:  # the fresh process still runs
        import traceback

        traceback.print_exc()
        FAILS.append(f"exception: {e!r}")
    print(f"main done in {time.perf_counter() - t0:.1f} s", flush=True)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--fresh"], capture_output=True, text=True,
                          timeout=600)
    print("FRESH rc", proc.returncode, proc.stdout[-6000:],
          proc.stderr[-3000:], flush=True)
    print(json.dumps(FAILS), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fresh"]:
        fresh()
    else:
        main()
