"""Phase 41 of ``chip_smoke.py`` (SameDiff) alone, on the card, with every
failed check recorded instead of ending the run, then a control of the
BERT gradient check: the f32 SameDiff BERT-base's gradients with the flash
dq kernel's output scaled by 1.01, against the plain lowering, must fail
``TOL_SD_BERT_GRAD["f32"]`` (its record's ``failed``).

Run from the root of a checkout, on the card:

    python3 experiments/samediff_checks/control.py

It writes the phase's record with ``control_dq_scaled`` to
``chiprun_out/samediff_control.json`` and prints the failed checks (none
expected) and the phase's wall seconds.
"""
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import numpy as np
import torch

import chip_smoke
from deeplearning4j_tpu_torch.ops.cuda import KERNELS

FAILS = []
chip_smoke.fail = lambda msg: (FAILS.append(msg),
                               print("FAIL:", msg, flush=True))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = chip_smoke.card_line()
print("card:", card, flush=True)
t0 = time.perf_counter()
with ThreadPoolExecutor(len(KERNELS)) as pool:
    list(pool.map(lambda k: k.library.load(), KERNELS))
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
rec = chip_smoke.phase_samediff(torch, np)
os.makedirs("chiprun_out", exist_ok=True)

# control: dq off by 1 %
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.ops.cuda import flash_attention as fa
from deeplearning4j_tpu_torch.zoo import BertBase

model = BertBase(seed=chip_smoke.SEED, max_len=chip_smoke.SD_BERT_T,
                 dtype="float32", dropout=0.0)
net = model.init(device="cuda")
ds, _ = chip_smoke._bert_text_batch(np)
feeds = {"ids": torch.as_tensor(ds.features.astype(np.int64), device="cuda"),
         "labels": torch.as_tensor(ds.labels, device="cuda")}
sd = chip_smoke.samediff_bert(SameDiff.create(chip_smoke.SEED, device="cuda"),
                              [{k: t.detach().clone() for k, t in p.items()}
                               for p in net.params], heads=model.n_heads)
good = fa.flash_backward


def scaled(*a, **k):
    dq, dk, dv = good(*a, **k)
    return dq * 1.01, dk, dv


fa.flash_backward = scaled
n_fail = len(FAILS)
ctl = chip_smoke._grads_against_plain(
    sd, feeds, chip_smoke.TOL_SD_BERT_GRAD["f32"], "control: dq x 1.01")
fa.flash_backward = good
rec["control_dq_scaled"] = {**ctl, "failed": len(FAILS) > n_fail}
del FAILS[n_fail:]
with open("chiprun_out/samediff_control.json", "w") as f:
    json.dump(rec, f, indent=1)
print("FAILS", json.dumps(FAILS), flush=True)
print("phase 41 wall", rec["wall_s_phase"], flush=True)
