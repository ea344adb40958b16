"""How far the replayed flash ring lies from one flash call, by four error
measures, beside the two planted faults that phase 42 must catch.

Run from the root of a checkout on the card:

    python3 experiments/ring_replay_metrics/probe.py

For the ring of 4 replayed on the card (``replay_ring_flash``) at
chip_smoke.py's long-context shape [1, 4, 8192, 128] (keys past 6000
padded) and at the cuda tests' [1, 2, 512, 128] (keys past 400 padded),
f32 and bf16, causal and not: o, lse, dq, dk and dv of the ring, of one
flash call over the whole sequence and of the plain versions, and of the
ring with each of chip_smoke.py's ``SEQ_CONTROLS`` planted in place of
its ``flash_block_bwd`` (the block's own lse, or delta of the block's own
o). Each pair is measured four ways: ``max_rel`` (max |a - b| over max
|b|), ``row_rel`` (the largest ||a - b|| of a row over that row's ||b||),
``row_rel_floored`` (chip_smoke.py's ``_row_rel``: the same, a row's
||b|| taken no smaller than 1e-3 of the largest row's) and ``old`` (max
|a - b| / (1 + |b|)). Writes every reading to
``chiprun_out/ring_replay_metrics.json`` and prints, a case and a pair,
the largest of o, dq, dk and dv under each measure.
"""

from __future__ import annotations

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (  # noqa: E402
    flash_backward, flash_backward_plain, flash_forward, flash_forward_plain,
)
from deeplearning4j_tpu_torch.parallel import sequence  # noqa: E402
from deeplearning4j_tpu_torch.parallel.sequence import (  # noqa: E402
    replay_ring_flash,
)

NAMES = ("o", "lse", "dq", "dk", "dv")


def max_rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def row_rel(a, b):
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1)
                  / b.norm(dim=-1).clamp_min(1e-30)).max())


def old(a, b):
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1 + b.abs())).max())


def measures(got, want):
    fns = {"max_rel": max_rel, "row_rel": row_rel,
           "row_rel_floored": cs._row_rel, "old": old}
    return {name: {n: m(a, b) for n, a, b in zip(NAMES, got, want)}
            for name, m in fns.items()}


def with_delta(do, o):
    return (do.float() * o.float()).sum(-1, keepdim=True)


def cases(shape, mask_from):
    out = {}
    scale = 1 / math.sqrt(shape[3])
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 420)
        q, k, v, do = [torch.randn(shape, device="cuda", generator=g)
                       .to(dtype) for _ in range(4)]
        km = torch.ones(shape[0], shape[2], device="cuda")
        km[:, mask_from:] = 0
        for causal in (False, True):
            kw = dict(scale=scale, causal=causal, kmask=km)

            def ring():
                return replay_ring_flash(q, k, v, size=4, kmask=km, do=do,
                                         causal=causal, scale=scale)

            o, lse = flash_forward(q, k, v, **kw)
            one = (o, lse) + flash_backward(q, k, v, do, lse,
                                            with_delta(do, o), **kw)
            po, plse = flash_forward_plain(q, k, v, **kw)
            plain = (po, plse) + flash_backward_plain(
                q, k, v, do, plse, with_delta(do, po), **kw)
            got = ring()
            r = {"ring_vs_one": measures(got, one),
                 "ring_vs_plain": measures(got, plain),
                 "one_vs_plain": measures(one, plain)}
            keep = sequence.flash_block_bwd
            for fault, bwd in cs.SEQ_CONTROLS.items():
                sequence.flash_block_bwd = bwd
                try:
                    bad = ring()
                finally:
                    sequence.flash_block_bwd = keep
                r[f"{fault}_vs_one"] = measures(bad, one)
                r[f"{fault}_vs_plain"] = measures(bad, plain)
            out[f"{str(dtype).split('.')[-1]}_causal_{causal}"] = r
            del plain, po, plse
            torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    res = {"full": cases(cs.SEQ_SHAPE, cs.SEQ_MASK_FROM),
           "small": cases((1, 2, 512, 128), 400)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ring_replay_metrics.json", "w") as f:
        json.dump(res, f, indent=1)
    for size, rows in res.items():
        for case, r in rows.items():
            for pair, ms in r.items():
                print(json.dumps({"size": size, "case": case, "pair": pair,
                                  **{m: max(v[t] for t in NAMES if t != "lse")
                                     for m, v in ms.items()}}), flush=True)


if __name__ == "__main__":
    main()
