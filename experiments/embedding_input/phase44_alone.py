"""Phase 44 of chip_smoke.py (the embedding and input tier) alone on the
card, with every check read in one run: ``chip_smoke.fail`` records its
message instead of exiting, and the run exits 1 at the end if any check
failed. Run from the root of a checkout on a machine with the card:

    python3 experiments/embedding_input/phase44_alone.py

It prints the card line, the checks, the parts' walls and the measured
rates (one JSON line each) and writes the phase's whole record to
``chiprun_out/phase44.json``. Nothing needs building first: no path of the
phase launches a kernel of ``csrc/``; the native library builds itself.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("phase 44 needs the card")
    failures = []
    cs.fail = lambda msg: (failures.append(msg),
                           print("FAIL:", msg, flush=True))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    out = cs.phase_embedding_input(torch, np)
    out.update(failures=failures, card=card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "phase44.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: out[k] for k in ("checks", "wall_s_parts",
                                          "wall_s_phase", "failures")},
                     default=str), flush=True)
    w = out["word2vec"]
    print(json.dumps({
        "card": card,
        "w2v": {n: w[n] for n in ("w2v_native", "w2v_python", "w2v_hs",
                                  "w2v_cbow", "native_host_drain",
                                  "device_only", "glove",
                                  "paragraph_vectors")},
        "knn": out["knn"], "server": out["knn_server"],
        "pipe": {n: v for n, v in out["pipeline"].items() if n != "losses"},
    }, default=str), flush=True)
    print(f"wall {time.time() - t0:.1f} s", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
