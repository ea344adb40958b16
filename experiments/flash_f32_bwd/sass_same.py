"""The flash kernels this redesign leaves alone, before and after: builds
csrc/flash_attention_fwd.cu, flash_attention_dq.cu and
flash_attention_dkv.cu from this checkout and from another copy of csrc/
(``--parent``, e.g. ``git archive <commit> deeplearning4j_tpu_torch/csrc``
unpacked under ``_proof/``) with the port's nvcc flags, and compares the
``cuobjdump -sass`` of every device function of the forward (the f32
CUDA-core forward, the bf16 wgmma forward, the tile check) and of the bf16
dq and dk/dv (``*_wgmma_kernel``) line by line, with
``experiments/lstm_grid/gru_sass_same.py``'s ``sass``. It also lists the
f32 backward's device functions on each side, which are meant to differ.

Run on the machine with the card (nvcc and cuobjdump from the toolkit):

    python3 experiments/flash_f32_bwd/sass_same.py --parent _proof/parent/deeplearning4j_tpu_torch/csrc

Prints one JSON object last on stdout; exits 1 if any compared function
differs or is missing on one side.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "experiments" / "lstm_grid"))

from gru_sass_same import sass  # noqa: E402

from deeplearning4j_tpu_torch.ops.cuda import build  # noqa: E402

#: source -> which of its device functions must keep the parent's code
KEPT = {"flash_attention_fwd.cu": lambda name: True,
        "flash_attention_dq.cu": lambda name: "wgmma" in name,
        "flash_attention_dkv.cu": lambda name: "wgmma" in name}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path,
                    help="a copy of csrc/ to compare this checkout's with")
    args = ap.parse_args()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for source, kept in KEPT.items():
            old_dir, new_dir = Path(tmp, "old"), Path(tmp, "new")
            old_dir.mkdir(exist_ok=True)
            new_dir.mkdir(exist_ok=True)
            old = sass(args.parent, source, old_dir)
            new = sass(build.CSRC_DIR, source, new_dir)
            compared = sorted(n for n in set(old) | set(new) if kept(n))
            result[source] = {
                "compared": compared,
                "differ": [n for n in compared if old.get(n) != new.get(n)],
                "sass_lines": sum(len(new.get(n, [])) for n in compared),
                "parent_only": sorted(n for n in old if not kept(n)),
                "new_only": sorted(n for n in new if not kept(n))}
    ok = all(r["compared"] and not r["differ"] for r in result.values())
    print(json.dumps({"flash_sass_identical": ok, "sources": result}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
