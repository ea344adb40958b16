"""The SameDiff BERT-base's 3 Adam steps through the kernels against the
plain lowering on the card (``chip_smoke._sd_against_plain``, every limit
open) at several rates: bf16 at 1e-4, 2e-4 and 5e-4, f32 at 1e-4. Each
line gives the losses of both runs, the variables' max abs difference,
the steps' updates ``||dA - dB|| / ||dB||`` and the share of elements the
plain run moved: what phase 41's rates and limits were chosen from.

Run from the root of a checkout, on the card:

    python3 experiments/samediff_checks/rates.py

It prints the card's name and power limit and one line a rate, and
writes them to ``chiprun_out/samediff_rates.json``.
"""
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import numpy as np
import torch

import chip_smoke
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.ops.cuda import KERNELS
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.zoo import BertBase

chip_smoke.fail = lambda msg: print("FAIL:", msg, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print("card:", chip_smoke.card_line(), flush=True)
with ThreadPoolExecutor(len(KERNELS)) as pool:
    list(pool.map(lambda k: k.library.load(), KERNELS))
model = BertBase(seed=chip_smoke.SEED, max_len=chip_smoke.SD_BERT_T,
                 dtype="float32", dropout=0.0)
net = model.init(device="cuda")
ds, _ = chip_smoke._bert_text_batch(np)
feeds = {"ids": torch.as_tensor(ds.features.astype(np.int64), device="cuda"),
         "labels": torch.as_tensor(ds.labels, device="cuda")}


def make(dt):
    sd = chip_smoke.samediff_bert(
        SameDiff.create(chip_smoke.SEED, device="cuda"),
        [{k: t.detach().clone() for k, t in p.items()} for p in net.params],
        heads=model.n_heads)
    if dt != torch.float32:
        sd.set_variables({k: t.to(dt) for k, t in sd.variables().items()})
    return sd


out = {}
for dt, lrs in ((torch.bfloat16, (1e-4, 2e-4, 5e-4)),
                (torch.float32, (1e-4,))):
    for lr in lrs:
        r = chip_smoke._sd_against_plain(
            torch, lambda: make(dt), lambda: Adam(lr=lr), feeds, 3, 1.0, 1.0,
            f"{dt} lr {lr}", update_tol=1.0)
        out[f"{dt} {lr}"] = r
        print(dt, lr, json.dumps(r), flush=True)
os.makedirs("chiprun_out", exist_ok=True)
json.dump(out, open("chiprun_out/samediff_rates.json", "w"), indent=1)
