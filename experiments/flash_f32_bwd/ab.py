"""A/B of the f32 flash backward on the card, in one process.

A: PR 3's CUDA-core pair (``flash_dq_kernel``, ``flash_dkv_kernel``),
built from the copies of its two sources and their header under ``pr3/``
beside this script. B: the port's three-pass TF32 pair
(``flash_dq_tf32x3_kernel``, ``flash_dkv_tf32x3_kernel``,
``csrc/flash_attention_dq.cu`` and ``csrc/flash_attention_dkv.cu``). Both
take the same C arguments. At BERT-base's [32, 12, 128, 64] with a
key-padding mask, and at the long-context shape [1, 4, 8192, 128] causal
and not (f32, TF32 off for every PyTorch product):

- both pairs against ``flash_backward_plain`` on the kernels' own lse and
  delta (max abs error; the card tests' 1e-4), and at BERT-base's shape
  with q and k scaled by 8 (max abs error over the output's max |ref|);
- each kernel's device time under the profiler, in the order A, B, B, A;
- ``scaled_dot_product_attention``'s backward alone on a retained graph
  (device time, and the device kernels it ran: the yardstick's backend);
- ``chip_smoke.flash_bound`` of dq and dk/dv.

Run from the root of a checkout, on the card:

    python3 experiments/flash_f32_bwd/ab.py

It prints the card's name and power limit, a JSON line a shape and, last,
one JSON object of all of them.
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
from deeplearning4j_tpu_torch.ops.cuda import flash_attention as fa  # noqa

SHAPES = (("bert_masked", 32, 12, 128, 64, True, False),
          ("long", 1, 4, 8192, 128, False, False),
          ("long_causal", 1, 4, 8192, 128, False, True))
ITERS = {128: 20, 8192: 4}
OLD = {"dq": "flash_dq_kernel", "dkv": "flash_dkv_kernel"}
NEW = {"dq": fa.DQ_KERNEL_NAMES[torch.float32],
       "dkv": fa.DKV_KERNEL_NAMES[torch.float32]}


def build_old() -> dict:
    """nvcc PR 3's two sources with the port's flags into the port's build
    directory (named by a hash of the sources and their header)."""
    libs = {}
    for kind, sig in (("dq", "ppppppppiiiiifip"), ("dkv", "pppppppppiiiiifip")):
        src = HERE / "pr3" / f"flash_attention_{kind}.cu"
        digest = hashlib.sha1(src.read_bytes())
        digest.update((HERE / "pr3" / "flash_common.cuh").read_bytes())
        digest.update(" ".join(build.NVCC_FLAGS).encode())
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib = build.BUILD_DIR / f"ab_pr3_{kind}-{digest.hexdigest()[:12]}.so"
        if not lib.exists():
            t0 = time.perf_counter()
            proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                                   str(lib), str(src)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                cs.fail(f"nvcc failed on {src}:\n{proc.stderr}")
            print(f"build pr3/{src.name}: {time.perf_counter() - t0:.2f} s",
                  flush=True)
        out = ctypes.CDLL(str(lib))
        fn = getattr(out, f"dl4j_flash_{kind}")
        fn.argtypes = build.c_args(sig)
        fn.restype = ctypes.c_int
        out.dl4j_cuda_error_string.argtypes = build.c_args("i")
        out.dl4j_cuda_error_string.restype = ctypes.c_char_p
        libs[kind] = out
    return libs


def old_backward(libs, q, k, v, do, lse, delta, *, scale, causal, kmask):
    """PR 3's pair on the current stream: (dq, dk, dv)."""
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    dq = torch.empty((B, N, Tq, D), device="cuda")
    dk, dv = (torch.empty((B, N, Tk, D), device="cuda") for _ in range(2))
    p = build.pointer
    ins = tuple(p(t) for t in (q, k, v, do, lse, delta, kmask))
    common = (B * N, N, Tq, Tk, D, float(scale), int(causal),
              torch.cuda.current_stream().cuda_stream)
    build.check_status(libs["dq"], libs["dq"].dl4j_flash_dq(
        *ins, p(dq), *common), "pr3 dq")
    build.check_status(libs["dkv"], libs["dkv"].dl4j_flash_dkv(
        *ins, p(dk), p(dv), *common), "pr3 dkv")
    return dq, dk, dv


def kernel_ms(fn, iters, names):
    """{kind: mean device ms a launch} of the kernels named in ``names``,
    from one profiled window (profiled again while a kernel is missing)."""
    for _ in range(3):
        by_kernel, _, _ = cs.profile_device(torch, fn, iters)
        out = {}
        for kind, name in names.items():
            hits = [(t, n) for key, (t, n) in by_kernel.items() if name in key]
            count = sum(n for _, n in hits)
            out[kind] = sum(t for t, _ in hits) / count if count else None
        if all(v is not None for v in out.values()):
            return out
    cs.fail(f"the profile shows none of {names}")


def errors(got, want):
    """Max abs error of each gradient, and over the output's max |ref|."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max())
        out[f"{name}_max_abs_err"] = err
        out[f"{name}_err_over_scale"] = err / max(1.0, float(b.abs().max()))
    return out


def shape_row(libs, g, name, B, N, T, D, masked, causal):
    f32 = torch.float32
    q, k, v, do, kmask = cs._attn_inputs(torch, g, B, N, T, D, f32, masked)
    kw = dict(scale=1.0 / D ** 0.5, causal=causal, kmask=kmask)
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (do * o).sum(-1, keepdim=True)
    new = lambda: fa.flash_backward(q, k, v, do, lse, delta, **kw)  # noqa
    old = lambda: old_backward(libs, q, k, v, do, lse, delta, **kw)  # noqa
    want = fa.flash_backward_plain(q, k, v, do, lse, delta, **kw)
    row = {"shape": name, "B": B, "N": N, "T": T, "D": D, "masked": masked,
           "causal": causal, "errors": {"A": errors(old(), want),
                                        "B": errors(new(), want)}}
    del want
    if max(row["errors"]["B"][f"{n}_max_abs_err"]
           for n in ("dq", "dk", "dv")) > cs.TOL:
        cs.fail(f"{name}: the three-pass pair disagrees with plain: "
                f"{row['errors']['B']}")
    if name == "bert_masked":  # q and k scaled by 8: large logits
        q8, k8 = q * 8, k * 8
        o8, lse8 = fa.flash_forward(q8, k8, v, **kw)
        d8 = (do * o8).sum(-1, keepdim=True)
        want8 = fa.flash_backward_plain(q8, k8, v, do, lse8, d8, **kw)
        row["errors_qk_x8"] = {
            "A": errors(old_backward(libs, q8, k8, v, do, lse8, d8, **kw),
                        want8),
            "B": errors(fa.flash_backward(q8, k8, v, do, lse8, d8, **kw),
                        want8)}
    iters = ITERS[T if T in ITERS else 128]
    times = {"A": [], "B": []}
    for label in ("A", "B", "B", "A"):
        fn, names = (old, OLD) if label == "A" else (new, NEW)
        ms = kernel_ms(fn, iters, names)
        times[label].append({**ms, "pair": ms["dq"] + ms["dkv"]})
    row["device_ms"] = times
    # the yardstick: SDPA's backward alone, on a retained graph
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    if masked:
        lib_out = sdpa(lq, lk, lv, attn_mask=kmask[:, None, None, :] > 0)
    else:
        lib_out = sdpa(lq, lk, lv, is_causal=causal)
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (lq, lk, lv), do, retain_graph=True)
    by_kernel, _, _ = cs.profile_device(torch, lib_bwd, iters)
    row["library_bwd_device_ms"] = (
        sum(t for t, _ in by_kernel.values()) / iters if by_kernel else None)
    row["library_bwd_kernels"] = {
        key: t / iters for key, (t, _) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][0])}
    for kind in ("dq", "dkv"):
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = cs.flash_bound(
            torch, kind, q, k, kmask, causal)
    del lib_out, lq, lk, lv
    torch.cuda.empty_cache()
    return row


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs the "
                "card")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_old()
    for kern in (fa.FLASH_DQ, fa.FLASH_DKV):
        kern.library.load()
        print(f"build {kern.name}: {kern.library.build_seconds:.2f} s\n"
              f"{kern.library.build_log.strip()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
    rows = []
    for shape in SHAPES:
        rows.append(shape_row(libs, g, *shape))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "A": OLD, "B": NEW, "rows": rows}))


if __name__ == "__main__":
    main()
