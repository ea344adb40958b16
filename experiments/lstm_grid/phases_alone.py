"""chip_smoke.py's LSTM kernel phases and phase 47 alone: builds the
kernels (one nvcc a source, all started together), then runs phase 3
(the forward against its plain version), phase 6 (the forward with its
reserve and the backward, the layer's gradients, cuDNN's pair) and phase
47 (TextGenerationLSTM(units=1024) served and trained on the grid
kernels), with TF32 off, as ``chip_smoke.main`` runs them.

Run on the machine with the card, from the root of a checkout:

    python3 experiments/lstm_grid/phases_alone.py [out.json]

Writes the rows at H >= 448, the kernels line's LSTM grid shapes and
phase 47's records to ``out.json`` (default ``lstm_grid_phases.json``)
and prints a line a row. A failed check ends the run as in
chip_smoke.py.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    path = Path(sys.argv[1] if len(sys.argv) > 1
                else "lstm_grid_phases.json")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda k: k.library.load(), KERNELS))
    out = {"card": cs.card_line(), "build_s": time.perf_counter() - t0}
    out["lstm_grid_tensor_cores"] = cs.grid_tensor_cores("lstm")
    t0 = time.perf_counter()
    rows, _, _ = cs.phase_kernels(torch)
    bwd_rows, _, _ = cs.phase_bwd_kernels(torch)
    out["phases_3_6_s"] = time.perf_counter() - t0
    out["kernel_shapes"] = [r for r in rows if r["H"] >= 448]
    out["bwd_kernel_shapes"] = [r for r in bwd_rows if r["H"] >= 448]
    out["grid_shapes"] = {k: cs.lstm_grid_shapes(
        rows, bwd_rows, k, out["lstm_grid_tensor_cores"])
        for k in ("fwd", "bwd")}
    t0 = time.perf_counter()
    out["wide_serving"] = cs.phase_wide_lstm_serving(torch, np)
    out["wide_training"] = cs.phase_wide_lstm_training(torch, np)
    out["phase_47_s"] = time.perf_counter() - t0
    os.makedirs(path.parent, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    for r in out["kernel_shapes"]:
        print("phase 3", r["shape"], r["design"]["kind"], "device ms",
              r["kernel_device_ms"], "cuDNN", r["library_device_ms"])
    for r in out["bwd_kernel_shapes"]:
        print("phase 6", r["shape"], r["fwd_design"]["kind"],
              r["bwd_design"]["kind"], "fwd+reserve",
              r["fwd_reserve_device_ms"], "bwd", r["kernel_device_ms"],
              "pair", r["layer_pair_device_ms"], "cuDNN pair",
              r["library_pair_device_ms"])
    s, t = out["wide_serving"], out["wide_training"]
    print("phase 47 serving", s["tokens_per_s"], "tokens/s,",
          s["launches_per_decode_step"], "launches a decode step, prefill "
          "carries", s["prefill_carries_max_abs_err_kernel_vs_plain"],
          "from plain")
    print("phase 47 training", t["step_wall_ms"], "ms a step, losses",
          t["losses"][0], "->", t["losses"][-1])
    print(json.dumps({"ok": True, "card": out["card"]}))


if __name__ == "__main__":
    main()
