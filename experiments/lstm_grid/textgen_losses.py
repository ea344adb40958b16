"""TextGenerationLSTM's loss over its first fit_batch steps on one repeated
batch (B = 64, T = 64, one-hot random characters, next-character labels;
RMSProp 1e-3, clipping 5.0, f32), at units 256 and 1024: the kernel path
on the card beside a copy on the kernel-disabled plain path on the card,
step by step. At units = 1024 the LSTM layers run the grid kernels.

Run on the machine with the card:

    python3 experiments/lstm_grid/textgen_losses.py [--steps 30]

Prints one JSON object last on stdout: each width's two loss
trajectories, their largest relative difference, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deeplearning4j_tpu_torch.common.env import env  # noqa: E402
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM  # noqa: E402


def batch(seed, V=77, B=64, T=64):
    ids = np.random.default_rng(seed).integers(0, V, (B, T))
    return (np.eye(V, dtype=np.float32)[ids],
            np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=25)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = batch(args.seed)
    out = {}
    for units in (256, 1024):
        net = TextGenerationLSTM(seed=0, units=units).init(device="cuda")
        plain = copy.deepcopy(net)
        kernel = [float(net.fit_batch((x, y))) for _ in range(args.steps)]
        env.disable_kernels = True
        try:
            ref = [float(plain.fit_batch((x, y))) for _ in range(args.steps)]
        finally:
            env.reload()
        out[f"units_{units}"] = {
            "kernel_losses": kernel, "plain_losses": ref,
            "max_rel_diff": max(abs(a - b) / abs(b)
                                for a, b in zip(kernel, ref)),
            "lowest_step": int(np.argmin(kernel))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"steps": args.steps, "batch_seed": args.seed,
                      "card": card, **out}))


if __name__ == "__main__":
    main()
