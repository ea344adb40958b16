"""Rows a group for the LSTM's grid kernels at [B=64, T=64, H=1024] f32,
one group of 128 CTAs of 8 units: the launchers' plans ("planner": the
forward one pass of 64 rows, kLstmGridRows; the backward two passes of
32, kGridRows) against the other choice for each ("other": copies of
csrc/ whose forward ends its rows at 32 and whose backward takes
kLstmGridRows). Builds the copies' fused_lstm.cu and fused_lstm_bwd.cu
with the port's nvcc flags, calls both libraries' C launchers through
ctypes on the same inputs, holds each against the plain versions (f32
1e-4), and times each launcher with CUDA events over 20 calls, in the
order planner, other, other, planner.

Run on the machine with the card:

    python3 experiments/lstm_grid/rows_ab.py

Prints one JSON object last on stdout: each variant's plans (the plan
queries' eight outputs: kind, C, rows, shared memory, units, CTAs,
groups, workspace bytes) and ms a call (forward with its reserve,
backward), and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from deeplearning4j_tpu_torch.ops.cuda import build, fused_lstm  # noqa: E402
from deeplearning4j_tpu_torch.ops.cuda.build import c_args, pointer  # noqa: E402

B, T, H = 64, 64, 1024
SIG = "ppppppppppliiip"


def edit(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert old in text, (path.name, old)
    path.write_text(text.replace(old, new))


def variant(tmp: Path) -> dict:
    """The two LSTM libraries with the other rows: {"fwd": CDLL, "bwd":
    CDLL}, each built from its own copy of csrc/."""
    libs = {}
    for key, source in (("fwd", "fused_lstm.cu"), ("bwd", "fused_lstm_bwd.cu")):
        csrc = tmp / f"csrc_{key}"
        shutil.copytree(build.CSRC_DIR, csrc)
        if key == "fwd":  # rows end at 32
            edit(csrc / "recurrent_grid.cuh",
                 "constexpr int kLstmGridRows[] = {8, 16, 32, 64};",
                 "constexpr int kLstmGridRows[] = {8, 16, 32};")
        else:  # rows to 64
            bwd = csrc / source
            edit(bwd, "&gp, kLstmGridSlots);",
                 "&gp, kLstmGridSlots, kLstmGridRows);")
            text = bwd.read_text()
            bwd.write_text(text.replace("by_grid_rows(", "by_lstm_grid_rows("))
        out = tmp / f"{key}.so"
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                               str(out), str(csrc / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(out))
        for sym in ("dl4j_lstm_fwd", "dl4j_lstm_bwd"):
            if hasattr(lib, sym):
                getattr(lib, sym).argtypes = list(c_args(SIG))
        plan = f"dl4j_lstm_{key}_plan"
        getattr(lib, plan).argtypes = list(c_args("iiiip"))
        libs[key] = lib
    return libs


def plan_of(lib, key):
    out = (ctypes.c_longlong * 8)()
    assert getattr(lib, f"dl4j_lstm_{key}_plan")(T, B, H, 0, out) == 0
    return list(out)


def main() -> None:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, k=1.0: torch.randn(*s, device=dev, generator=g) * k  # noqa
    xg, R = rnd(T, B, 4 * H, k=0.3), rnd(H, 4 * H, k=0.03)
    h0, c0, dout, dcT = rnd(B, H, k=0.5), rnd(B, H, k=0.5), rnd(T, B, H), \
        rnd(B, H)
    own = {"fwd": fused_lstm.FUSED_LSTM.library.load(dev),
           "bwd": fused_lstm.FUSED_LSTM_BWD.library.load(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"planner": own, "other": variant(Path(tmp))}
        want_out, _, _, want_res = fused_lstm.plain_recurrence(
            xg, R, h0, c0, None, True)
        runs, checks, plans = {}, {}, {}
        for name, lib in libs.items():
            fp, bp = plan_of(lib["fwd"], "fwd"), plan_of(lib["bwd"], "bwd")
            plans[name] = {"fwd": fp, "bwd": bp}
            fw = torch.empty(fp[7], dtype=torch.uint8, device=dev)
            bw = torch.empty(bp[7], dtype=torch.uint8, device=dev)
            out, hT, cT = (torch.empty(T, B, H, device=dev),
                           torch.empty(B, H, device=dev),
                           torch.empty(B, H, device=dev))
            res = torch.empty(5, T, B, H, device=dev)
            dg, dc0 = torch.empty(T, B, 4 * H, device=dev), \
                torch.empty(B, H, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def fwd(lib=lib, fw=fw, out=out, hT=hT, cT=cT, res=res):
                assert lib["fwd"].dl4j_lstm_fwd(
                    pointer(xg), pointer(R), pointer(h0), pointer(c0), None,
                    pointer(out), pointer(hT), pointer(cT), pointer(res),
                    pointer(fw), fw.numel(), T, B, H, stream) == 0

            def bwd(lib=lib, bw=bw, res=res, dg=dg, dc0=dc0):
                assert lib["bwd"].dl4j_lstm_bwd(
                    pointer(res), pointer(R), None, pointer(c0),
                    pointer(dout), pointer(dcT), None, pointer(dg),
                    pointer(dc0), pointer(bw), bw.numel(), T, B, H,
                    stream) == 0

            fwd()
            bwd()
            torch.cuda.synchronize()
            p_dg, p_dc0 = fused_lstm.plain_bwd_recurrence(res, R, c0, dout,
                                                          dcT)
            checks[name] = max(float((a - b).abs().max()) for a, b in (
                (out, want_out), (res, want_res), (dg, p_dg), (dc0, p_dc0)))
            if checks[name] > 1e-4:
                raise SystemExit(f"{name} disagrees with plain: "
                                 f"{checks[name]}")
            runs[name] = (fwd, bwd)

        def ms(fn, iters=20):
            fn()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / iters

        times = {name: {"fwd_ms": [], "bwd_ms": []} for name in libs}
        for name in ("planner", "other", "other", "planner"):
            fwd, bwd = runs[name]
            times[name]["fwd_ms"].append(ms(fwd))
            times[name]["bwd_ms"].append(ms(bwd))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"shape": [B, T, H], "dtype": "float32", "card": card,
                      "plans": plans, "max_abs_err_vs_plain": checks,
                      "times": times}))


if __name__ == "__main__":
    main()
