"""chip_smoke.py's phase 41(a) (SameDiff's BertBase at full width, f32 and
bf16) and phase 42's flash ring replay ([1, 4, 8192, 128], f32 and bf16,
causal and not) alone, from the checkout ``--root`` names (default this
one), so that a parent (``git archive`` unpacked under ``_proof/``) and a
change run in one call and on one card:

    python3 experiments/flash_f32_bwd/phases_alone.py --root _proof/parent_tree --out chiprun_out/parent_1.json

Builds that checkout's three flash kernels (one nvcc a source, started
together), then runs the two phases as ``chip_smoke.main`` runs them, TF32
off, with their checks. Writes their records to ``--out`` and prints one
JSON line: each SameDiff BERT step's and call's device ms and the phase's
flash launches, and the ring replay's device ms and launches by dtype and
causal.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--out", type=Path, default=Path("flash_phases.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    t0 = time.perf_counter()
    flash = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    with ThreadPoolExecutor(len(flash)) as pool:
        list(pool.map(lambda k: k.library.load(), flash))
    out = {"root": str(args.root), "card": cs.card_line(),
           "build_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    bert, _, _ = cs._sd_bert(torch, np, KERNELS)
    out["phase_41_bert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring = cs.phase_ring_replay(torch, np)
    out["phase_42_ring_s"] = time.perf_counter() - t0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({**out, "bert": bert, "ring": ring},
                                   indent=1, default=str))
    out["samediff_bert"] = {
        name: {k: bert[name][k] for k in ("step_device_ms", "step_ms",
                                          "output_device_ms")}
        for name in ("f32", "bf16")}
    out["samediff_bert_launches"] = bert["launches"]
    out["ring_replay"] = [
        {k: r[k] for k in ("dtype", "causal", "launches", "replay_device_ms",
                           "one_call_device_ms")} for r in ring["rows"]]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
