"""What NCCL does on a machine with one card, for the parallel slice.

Run from the root of a checkout on the card:

    python3 experiments/nccl_one_card/probe.py

1. A group of one rank (``parallel.launch.local_group("cuda")``): one
   all-reduce of 4 floats and one of 25.6M floats (a ResNet-50 gradient
   buffer) under torch.profiler, CPU and CUDA activities: the records whose
   names hold "nccl", their counts and device ms.
2. Two ranks on the one card: two spawned processes, both on cuda:0, join
   an NCCL group and all-reduce; each prints what it got (NCCL is expected
   to refuse two ranks on one device). The ranks are killed after 90 s.
3. The host's cost of a collective at one rank: the mean host ms of 500
   all-reduces of 128 floats issued back to back (one sync at the end),
   by ``dist.all_reduce`` on the default group and on a mesh axis's
   group, and by ``collectives.psum`` (an autograd Function) forward and
   backward, forward alone, and with the backward's collective left out
   (``psum_replicated``); beside a plain forward and backward and 500
   additions of the same tensor.

Prints one JSON object a part.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.getcwd())


def _nccl_records(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "nccl" in e.key.lower() or "all_reduce" in e.key.lower():
            out[e.key] = {"count": e.count,
                          "device_ms": float(getattr(
                              e, "device_time_total", 0.0)) / 1e3,
                          "device_type": str(getattr(e, "device_type", ""))}
    return out


def part_one_rank():
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import DeviceMesh, launch

    with launch.local_group("cuda"):
        mesh = DeviceMesh(data=1)
        g = mesh.group("data")
        small = torch.ones(4, device="cuda")
        big = torch.ones(25_600_000, device="cuda")
        return {"backend": str(dist.get_backend()),
                "group_size": dist.get_world_size(g),
                "small": _nccl_records(
                    torch, lambda: dist.all_reduce(small, group=g)),
                "big": _nccl_records(
                    torch, lambda: dist.all_reduce(big, group=g)),
                "big_value": float(big[0])}


def _two_rank_body(rank, store_path, q):
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store_path, 2),
                                rank=rank, world_size=2,
                                device_id=torch.device("cuda", 0))
        t = torch.ones(4, device="cuda") * (rank + 1)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, "ok", t.tolist()))
        dist.destroy_process_group()
    except BaseException as e:  # reported to the parent
        q.put((rank, type(e).__name__, str(e)[:2000],
               traceback.format_exc()[-2000:]))


def part_two_ranks_one_card(limit=90.0):
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp()
    q = ctx.Queue()
    procs = [ctx.Process(target=_two_rank_body,
                         args=(r, os.path.join(tmp, "store"), q))
             for r in range(2)]
    t0 = time.time()
    for p in procs:
        p.start()
    got = []
    while len(got) < 2 and time.time() - t0 < limit:
        try:
            got.append(q.get(timeout=1.0))
        except Exception:
            pass
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)
    return {"seconds": time.time() - t0, "reports": got,
            "exit_codes": [p.exitcode for p in procs],
            "timed_out": len(got) < 2}


def _host_ms(torch, fn, n=500):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return host


def part_host_cost():
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import DeviceMesh, launch
    from deeplearning4j_tpu_torch.parallel.collectives import (
        psum, psum_replicated,
    )

    with launch.local_group("cuda"):
        g = DeviceMesh(data=1).group("data")
        t = torch.ones(128, device="cuda")
        x = torch.ones(128, device="cuda", requires_grad=True)

        def fwd_bwd():
            psum(x * 2, g).sum().backward()

        def plain_bwd():
            (x * 2).sum().backward()

        def fwd_only():
            with torch.no_grad():
                psum(x * 2, g)

        def replicated_bwd():
            psum_replicated(x * 2, g).sum().backward()

        return {"add_ms": _host_ms(torch, lambda: t.add_(0.0)),
                "plain_forward_backward_ms": _host_ms(torch, plain_bwd),
                "psum_forward_ms": _host_ms(torch, fwd_only),
                "psum_replicated_forward_backward_ms": _host_ms(
                    torch, replicated_bwd),
                "all_reduce_default_ms": _host_ms(
                    torch, lambda: dist.all_reduce(t)),
                "all_reduce_axis_group_ms": _host_ms(
                    torch, lambda: dist.all_reduce(t, group=g)),
                "psum_forward_backward_ms": _host_ms(torch, fwd_bwd)}


def main():
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))}),
          flush=True)
    print(json.dumps({"one_rank": part_one_rank()}), flush=True)
    print(json.dumps({"two_ranks_one_card": part_two_ranks_one_card()}),
          flush=True)
    print(json.dumps({"host_cost_one_rank": part_host_cost()}), flush=True)


if __name__ == "__main__":
    main()
