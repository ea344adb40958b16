"""A/B of the two exchanges of the GRU backward's grid design, on the card.

A: the port's ``gru_bwd_grid_kernel`` (``csrc/fused_gru_bwd.cu``): each
CTA keeps R's columns of its units and reduce-scatters RB x H f32 partial
carries through L2 a step. B: ``gru_bwd_gather_kernel``
(``gru_bwd_gather.cu`` beside this script): each CTA keeps R's rows of its
units and reads the group's whole product operand [RB, 3H] back from L2 a
step (an all-gather). Both run on the port's forward reserve at [B=64,
T=64, H=1024] (the GRU(1024) x 2 char-RNN's shape) in f32 and bf16, and at
T = 8 for the time a step ((T64 - T8) / 56). B is held against the plain
backward (the card tests' tolerances) and must be bit-equal from run to
run; each is timed as its kernel's device time under the profiler, in the
order A, B, B, A.

Run from the root of a checkout, on the card:

    python3 experiments/gru_bwd_allgather/ab.py

It prints the card's name and power limit, a JSON line for each element
type and, last, one JSON object of both.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.ops.cuda import build  # noqa: E402
from deeplearning4j_tpu_torch.ops.cuda import fused_gru as fg  # noqa: E402
from deeplearning4j_tpu_torch.ops.recurrent import project_gates  # noqa: E402

SHAPE = (64, 64, 1024)       # B, T, H
T_SHORT = 8
ITERS = 20


def build_gather() -> ctypes.CDLL:
    """nvcc the candidate with the port's flags into the port's build
    directory (named by a hash of its source and the shared headers)."""
    src = HERE / "gru_bwd_gather.cu"
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(build.CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    build.BUILD_DIR.mkdir(exist_ok=True)
    lib = build.BUILD_DIR / f"ab_gru_bwd_gather-{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        t0 = time.perf_counter()
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                               str(lib), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on {src.name}:\n{proc.stderr}")
        print(f"build {src.name}: {time.perf_counter() - t0:.2f} s",
              flush=True)
        print(proc.stderr.strip(), flush=True)
    out = ctypes.CDLL(str(lib))
    out.ab_gru_bwd_gather.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out.ab_gru_bwd_gather.restype = ctypes.c_int
    out.ab_gru_bwd_gather_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    out.ab_cuda_error_string.restype = ctypes.c_char_p
    return out


def check(lib, status, what):
    if status != 0:
        cs.fail(f"{what}: {lib.ab_cuda_error_string(status).decode()}")


def gather_plan(lib, B, H, bf16):
    out = (ctypes.c_longlong * 6)()
    check(lib, lib.ab_gru_bwd_gather_plan(B, H, int(bf16), out), "plan")
    return dict(zip(("units", "ctas", "rows", "groups", "smem", "work"),
                    out))


def gather_bwd(lib, plan, reserve, R, h0, out, dout):
    """Candidate B: (dg, dh0) on the current stream."""
    T, B, H = reserve.shape[1:]
    dg = reserve.new_empty((T, B, 3 * H))
    dh0 = reserve.new_empty((B, H))
    work = reserve.new_empty(plan["work"], dtype=torch.uint8)
    p = build.pointer
    check(lib, lib.ab_gru_bwd_gather(
        p(reserve), p(R), p(h0), p(out), p(dout), p(dg), p(dh0), p(work),
        plan["work"], T, B, H, int(R.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream), "launch")
    return dg, dh0


def case(lib, dt, T):
    """Inputs of one [B, T, H] call made as chip_smoke's phase 16 makes
    them, the port's forward reserve, and both backwards as closures."""
    B, _, H = SHAPE
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).to(dt)

    F = 256
    x, W, R, b = (rnd(B, T, F), rnd(F, 3 * H, scale=F ** -0.5),
                  rnd(H, 3 * H, scale=H ** -0.5), rnd(3 * H, scale=0.1))
    h0, dout = rnd(B, H, scale=0.5), rnd(T, B, H)
    xg = project_gates(x, W, b)
    out, _, reserve = fg.fused_gru_recurrence(xg, R, h0, save_residuals=True)
    plan = gather_plan(lib, B, H, dt == torch.bfloat16)
    a = lambda: fg.fused_gru_bwd_recurrence(reserve, R, h0, out,  # noqa
                                            dout)
    bb = lambda: gather_bwd(lib, plan, reserve, R, h0, out, dout)  # noqa
    return a, bb, plan, (reserve, R, h0, out, dout)


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs the "
                "card")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build_gather()
    names = {"A": fg.BWD_KERNEL_NAMES["grid"], "B": "gru_bwd_gather_kernel"}
    result = {"card": card, "shape": {"B": SHAPE[0], "T": SHAPE[1],
                                      "H": SHAPE[2]}, "rows": []}
    for dt in (torch.float32, torch.bfloat16):
        B, T, H = SHAPE
        a, bb, plan, args = case(lib, dt, T)
        design = fg.launcher_bwd_design(T, B, H, dt)
        if design.kind != "grid":
            cs.fail(f"the port's backward takes {design.kind} at {SHAPE}")
        # B against the plain backward on the same reserve, bit-equal
        # from run to run; A as the port's card tests hold it
        (dg, dh0), (dg2, dh02) = bb(), bb()
        (adg, adh0) = a()
        torch.cuda.synchronize()
        pdg, pdh0 = fg.plain_bwd_recurrence(*args)
        errs = {}
        for name, got, want in (("B_dg", dg, pdg), ("B_dh0", dh0, pdh0),
                                ("A_dg", adg, pdg), ("A_dh0", adh0, pdh0)):
            err, ok = cs._gru_within(torch, got, want, dt)
            errs[f"{name}_max_abs_err"] = err
            if not ok:
                cs.fail(f"{name} disagrees with plain ({dt}): {err}")
        if not (torch.equal(dg, dg2) and torch.equal(dh0, dh02)):
            cs.fail(f"B is not bit-equal from run to run ({dt})")
        a8, b8, _, _ = case(lib, dt, T_SHORT)
        times = {}
        for label, fn, fn8 in (("A", a, a8), ("B", bb, b8), ("B", bb, b8),
                               ("A", a, a8)):
            t64 = cs.kernel_device_ms(torch, fn, ITERS, names[label])
            t8 = cs.kernel_device_ms(torch, fn8, ITERS, names[label])
            if t64 is None or t8 is None:
                cs.fail(f"the profile shows no {names[label]} ({dt})")
            times.setdefault(label, []).append(
                {"device_ms": t64, f"T{T_SHORT}_device_ms": t8,
                 "us_per_step": 1e3 * (t64 - t8) / (T - T_SHORT)})
        row = {"dtype": str(dt).replace("torch.", ""),
               "A_design": design._asdict(), "B_plan": plan,
               "A": times["A"], "B": times["B"], **errs}
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
