"""Phase 46 of chip_smoke.py (datavec and the dashboard) alone on the card,
with every check read in one run: ``chip_smoke.fail`` records its message
instead of exiting, and the run exits 1 at the end if any check failed.
Run from the root of a checkout on a machine with the card:

    python3 experiments/datavec_ui/phase46_alone.py

It builds the fused-LSTM kernels (config #3's path), prints the card line,
the checks, the launches, the parts' walls and the measured rates (one
JSON line each) and writes the phase's whole record to
``chiprun_out/phase46.json``. Phase 44's native-pipeline rate, which the
whole script prints beside the reader's, is not measured here.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("phase 46 needs the card")
    failures = []
    cs.fail = lambda msg: (failures.append(msg),
                           print("FAIL:", msg, flush=True))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print("card:", card, flush=True)
    from deeplearning4j_tpu_torch.ops.cuda import FUSED_LSTM, FUSED_LSTM_BWD

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda k: k.library.load(),
                      (FUSED_LSTM, FUSED_LSTM_BWD)))
    print(f"build {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    out = cs.phase_datavec_ui(torch, np)
    out.update(failures=failures, card=card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "phase46.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: out[k] for k in ("checks", "launches",
                                          "wall_s_parts", "wall_s_phase",
                                          "failures")}, default=str),
          flush=True)
    for part in ("imagenet_resnet50", "csv_config3", "csv_higgs"):
        rec = {k: v for k, v in out[part].items()
               if k not in ("scores", "profile")}
        rec["profile"] = {k: v for k, v in out[part].get(
            "profile", {}).items() if not k.startswith("top_")}
        print(json.dumps({part: rec}, default=str), flush=True)
    print(f"wall {time.time() - t0:.1f} s", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
