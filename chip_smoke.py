#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as nvidia-smi reports them.
2. Build: compiles every hand-written kernel from ``csrc/`` with nvcc.
3. Kernel against plain: each kernel against its plain PyTorch version on
   the card in float32 with TF32 off, at the shapes the main path gives it
   and at the GravesLSTM char-RNN width, and in bfloat16 at the decode and
   GravesLSTM shapes; each row names the forward design the launcher chose
   (held against its Python mirror ``fwd_design``): the cluster kernel, R
   resident across a thread-block cluster, at every T > 1 shape, the
   stream kernel at decode; times the kernel (profiled under its design's
   device function), the plain version and, as a yardstick the port never
   calls, ``torch.nn.LSTM`` (cuDNN) on the same layer with its gates
   reordered (on CUDA events and as the device time of its kernels); and
   the stream kernel at [64, 64, 1024] in f32 and bf16, past the width a
   cluster holds, beside cuDNN's LSTM there.
4. Main path: TextGenerationLSTM at its published width (LSTM 256 x 2,
   vocabulary 77, random weights from a seed) served by
   ``GenerationEngine(slots=8, max_len=256)``: 16 requests, greedy and
   sampled, drained to completion. Launch counts are zeroed just before and
   read just after. Greedy streams are held against the port's plain path
   on the CPU, teacher-forced, on the same weights. A steady window of
   decode steps is profiled and its host time split into the network's
   forward and the sampler.
5. bf16 net: the same model with ``dtype="bf16"`` generates on the card;
   every decode step must launch the kernel (the carries start in f32, as
   in the JAX package, so the recurrence runs the f32 kernel over the bf16
   weights), and its teacher-forced logits are held against the plain
   path on the card.
6. Backward kernel against plain: the training forward's reserve and the
   backward kernel against their plain versions at the training shapes
   (B=64, T=64; H=200 with peepholes, reversed; H=256 without), in f32 and
   bf16, both kernels on their cluster designs (R resident across a
   thread-block cluster), and at [64, 16, 448] and [64, 64, 1024] (f32
   and bf16), past the width a cluster holds, on both stream designs;
   each row names the designs the
   launchers chose (held against their Python mirrors ``fwd_design`` and
   ``bwd_design``) and is profiled under each design's kernel; each
   layer's seven gradients
   through the kernels against torch autograd through the plain lowering
   on the card; times of the kernels, the plain versions and, where a
   library call computes the same layer (H=256, no peepholes),
   ``torch.nn.LSTM`` (cuDNN): its forward in training mode and its forward
   + backward, on the device clock beside the kernel pair with the
   wrapper's GEMMs.
7. Training main path: BidirectionalGravesLSTMCharRnn at its published
   width (2 x GravesBidirectionalLSTM(200), vocabulary 77, Adam, clipping
   5.0) on batch 64 x T 64 of one-hot data from the seed. Two steps agree
   with a copy trained on the CPU's plain path; then, with the launch
   counts zeroed just before and read just after, N steps on a repeated
   batch, each launching 4 forward (with reserve) and 4 backward kernels,
   with finite and falling losses; a steady window is profiled and must
   show the forward's and the backward's cluster kernels, 4 of each a
   step.
8. TextGenerationLSTM training (RMSProp, 2 + 2 launches a step) and the
   bf16 char-RNN training: a few steps each, every step through both
   kernels.
9. Flash kernels against plain. First the tensor cores: the bf16 forward,
   dq and dk/dv kernels' machine code (``cuobjdump -sass``) must hold HGMMA
   or HMMA instructions and the f32 kernels none, and the tile layer's two
   products are held against the same product on the card. Then the
   forward, dq and dk/dv kernels against
   their plain versions (o, lse, dq, dk, dv) at BERT-base's attention shape
   [32, 12, 128, 64] in f32 (TF32 off) and bf16, without and with a
   key-padding mask, causal off and on, and at a ragged [4, 4, 77, 64] and a
   [2, 2, 300, 128]; ``FlashAttentionFunction``'s gradients against autograd
   through the plain lowering on the card; times of each kernel, its plain
   version and, as a yardstick the port never calls,
   ``scaled_dot_product_attention`` (forward, and backward), the library's
   both on the host's clock and as the device time of its kernels.
10. BERT-base inference: ``BertBase(max_len=128)`` at its published width
    (12 x 768, 12 heads, d_ff 3072, vocabulary 30522, bf16, random weights
    from the seed) runs ``output()`` on [32, 128] token ids with a padding
    mask: 12 forward launches a call and no backward; an f32 copy on the
    same weights agrees with the plain path on the card.
11. BERT-base fine-tuning: ``fit_batch`` at B=32, T=128, bf16, AdamW on a
    warmup-cosine schedule, clipping 1.0, dropout 0.1, on a repeated batch,
    each step launching 12 forward, 12 dq and 12 dk/dv kernels; a steady
    window is profiled. An f32 dropout-0 copy trains 2 steps against the
    plain path on the card from the same weights, and its gradients are
    held against the plain path's.
12. LRN kernels against plain: the forward and backward LRN kernels
    against their plain versions at AlexNet's two LRN shapes,
    [128, 54, 54, 96] and [128, 26, 26, 256], and at a ragged
    [3, 7, 5, 77] with even depth 4 and a [4, 3, 3, 3] with C below the
    depth, in f32 and bf16; ``LRNFunction``'s gradient against autograd
    through the plain lowering on the card; times of each kernel, its plain
    version and, as a yardstick the port never calls,
    ``torch.nn.functional.local_response_norm`` (forward, and its autograd
    backward) at AlexNet's shapes, on CUDA events and as the device time of
    its kernels, and the backward kernel's element-by-element path there
    (data one element past a 16-byte boundary).
13. AlexNet inference: ``AlexNet()`` at its published width (224 x 224 x
    3, conv 96-256-384-384-256, two LRN layers, dense 4096-4096, 1000
    classes, f32, random weights from the seed) runs ``output()`` on 128
    random images: 2 LRN forward launches a call and no backward; its
    logits agree with the plain path on the card; a call is profiled.
14. AlexNet training: ``fit_batch`` at B=128, Nesterovs 1e-2 momentum
    0.9, dropout 0.5, on a repeated batch, each step launching 2 LRN
    forward and 2 LRN backward kernels, losses finite and falling; a
    steady window is profiled. A dropout-0 copy trains 2 steps against the
    plain path on the card, both from the seed's untrained weights.
15. LeNet training (BASELINE.json config #1): ``LeNet()`` (flat 28 x 28 x 1
    through ``ReshapeToCnnPreProcessor``, Adam 1e-3) trains at B=64 on
    seeded random images, launching none of the port's kernels.
16. GRU kernels against plain: the fused-GRU forward kernel (with and
    without its reserve) and backward kernel against their plain versions
    at the GRU paths' shapes (decode [8, 1, 256], prefill [1, 47, 256],
    training [64, 64, 256], Bidirectional(GRU(200))'s reversed [64, 64,
    200]), past the width a cluster holds ([64, 64, 1024] in f32 and
    bf16, [64, 64, 768], a ragged reversed [3, 5, 640]), past the width
    the grid holds ([64, 8, 1200] in f32 and bf16), a ragged reversed
    [3, 5, 200] in f32 and bf16, and training at decode's [8, 1, 256].
    Each row names the forward and backward designs the launchers chose
    (the cluster kernels, R resident across a thread-block cluster; the
    grid kernels, R resident across the card; or the stream kernels), held
    against their Python mirrors; the cluster designs must run at every
    T > 1 shape of the main path, the grid designs past H = 512, and the
    stream designs at T = 1 and at H = 1200 (both directions), as the
    profile of each row shows. A grid row records its plan and its time a
    step (T = 64 against T = 8), and at T = 64 must beat the plain
    versions on the device; the bf16 grid kernels' machine code must hold
    tensor-core (HMMA) instructions and the f32 ones none. Times of each
    kernel, its plain version and, as a
    yardstick the port never calls, ``torch.nn.GRU`` (cuDNN) with its
    recurrent bias zeroed, the same function (forward, and its autograd
    backward), on the host's clock and as the device time of its kernels.
17. GRU char-RNN serving: TextGenerationLSTM's topology with GRULayer(256)
    x 2 (vocabulary 77, random weights from the seed, built from the
    configuration builder as the JAX package would) served by
    ``GenerationEngine(slots=8, max_len=256)`` with phase 4's 16 requests:
    exactly 2 GRU forward launches a decode step and a prefill and no other
    kernel; decode-step logits against the kernel-disabled plain path on
    the card; greedy tokens against the teacher-forced argmax.
18. GRU char-RNN training (RMSProp 1e-3, clipping 5.0) at B=64, T=64: 2
    steps against a copy on the kernel-disabled plain path on the card,
    then 10 timed steps, each launching exactly 2 forwards (with reserve)
    and 2 backwards, losses falling; a steady window is profiled and must
    show both cluster kernels, 2 launches each a step. Then the same
    net widened to GRULayer(1024) x 2: 2 steps against the plain path, 5
    timed steps of 2 + 2 launches, and a profiled window that must show
    both grid kernels, 2 launches each a step.
19. Bidirectional(GRULayer(200)) x 2 with Adam (config #3's shape with GRU
    cells: reversed time and an H that is not a multiple of 32): the same
    checks, 3 timed steps of 4 + 4 launches, 4 + 4 cluster launches a
    profiled step.
20. Prints the kernels line (all nine kernels), the card line and, last,
    the result line ``{"ok": true, "device": {...}}``.

Every phase runs f32 work with TF32 off (``torch.backends.cuda.matmul``
and ``torch.backends.cudnn`` ``allow_tf32`` False), the timed ones too.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

TOL = 1e-4      # f32; kernel and plain version sum h @ R in different orders
# bf16 outputs: |kernel - plain| <= TOL_BF16 * (1 + |plain|). The sums are
# f32 in both, in different orders, so a stored value may round to the
# neighbouring bf16 number (a step of 2^-8 to 2^-7 of its size), and the
# rounded h feeds the later steps.
TOL_BF16 = 1e-2
# bf16 net, teacher-forced logits, kernel path vs plain path on the card:
# the recurrence's bf16 rounding differences above, through two layers and
# the bf16 output layer (random weights give logits of about 0.4).
TOL_BF16_LOGITS = 2e-2
# layer gradients through the kernels vs autograd through the plain
# lowering, f32: |a - b| <= TOL_GRAD * max(1, max |b|) per gradient (sums
# over T*B in other orders; dW and db are sums of 4096 terms)
TOL_GRAD = 1e-4
# training on the card vs a copy on the CPU's plain path, after 2 steps
TOL_TRAIN_LOSS = 1e-5   # relative
TOL_TRAIN_PARAM = 1e-4  # absolute
SEED = 0
N_REQUESTS = 16
N_TRAIN_STEPS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def profile_device(torch, fn, iters: int):
    """``iters`` calls of ``fn`` under torch.profiler. Returns the device
    time by kernel name, {name: (total_ms, count)} (empty if the profiler
    saw no device activity), and the wall ms of the profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and _device_us(e) > 0:
            out[e.key] = (_device_us(e) / 1e3, e.count)
    return out, wall_ms


def kernel_device_ms(torch, fn, iters: int, symbol: str, tries: int = 3):
    """Mean device time of one launch of the kernel named ``symbol``. The
    profiler now and then keeps no device record of a window (on the H100,
    in a window of 2 ms as well as in shorter ones), so a window without
    the kernel is profiled again, at twice the calls, up to ``tries``
    times; None if none shows it."""
    for _ in range(tries):
        by_kernel, _ = profile_device(torch, fn, iters)
        hits = [(t, n) for k, (t, n) in by_kernel.items() if symbol in k]
        total, count = sum(t for t, _ in hits), sum(n for _, n in hits)
        if count:
            return total / count
        iters *= 2
    return None


def profile_showing(torch, fn, calls: int, want: dict, tries: int = 3):
    """``profile_device`` over ``calls`` calls of ``fn``, profiled again (up
    to ``tries`` times) while its device records fall short of ``want``
    ({kernel name: launches a call}), as the profiler now and then drops a
    window's records. Returns (by_kernel, wall ms, {name: launches
    seen})."""
    for _ in range(tries):
        by_kernel, wall_ms = profile_device(torch, fn, calls)
        seen = {name: sum(c for key, (_, c) in by_kernel.items()
                          if name in key) for name in want}
        if all(seen[k] == n * calls for k, n in want.items()):
            break
    return by_kernel, wall_ms, seen


def call_device_ms(torch, fn, iters: int):
    """Device time of one call of ``fn``: the sum of every kernel it runs
    (a library call's yardstick, free of the host's clock)."""
    by_kernel, _ = profile_device(torch, fn, iters)
    return (sum(t for t, _ in by_kernel.values()) / iters
            if by_kernel else None)


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) flop/s
# and bf16 dense tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def lstm_bound(T: int, B: int, H: int, peephole: bool, bf16: bool = False):
    """Least time for the recurrence: each input read once, each output
    written once, against the flops of h@R (at the peak for the inputs'
    type) plus ~15 f32 flops per cell update."""
    n_in = T * B * 4 * H + H * 4 * H + 2 * B * H + (3 * H if peephole else 0)
    n_out = T * B * H + 2 * B * H
    t_bytes = (2.0 if bf16 else 4.0) * (n_in + n_out) / HBM_BYTES_PER_S
    t_ops = (T * B * H * 8.0 * H / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
             + T * B * H * 15.0 / F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def lstm_fwd_train_bound(T, B, H, peephole, bf16=False):
    """lstm_bound plus the reserve written once ([5, T, B, H] f32)."""
    ms, _ = lstm_bound(T, B, H, peephole, bf16)
    e = 2.0 if bf16 else 4.0
    n_in = T * B * 4 * H + H * 4 * H + 2 * B * H + (3 * H if peephole else 0)
    n_out = T * B * H + 2 * B * H
    t_bytes = (e * (n_in + n_out) + 4.0 * 5 * T * B * H) / HBM_BYTES_PER_S
    t_ops = (T * B * H * 8.0 * H / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
             + T * B * H * 15.0 / F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lstm_bwd_bound(T, B, H, peephole, bf16=False):
    """Least time for the backward walk: the reserve, R^T, c0, dout, dcT
    and the peepholes read once, dg and dc0 written once, against the flops
    of dg @ R^T (T-1 steps: the last step needs none, at the peak for the
    inputs' type) plus ~25 f32 flops per gate-gradient cell."""
    e = 2.0 if bf16 else 4.0
    t_bytes = (4.0 * 5 * T * B * H + e * (4 * H * H + 2 * B * H + T * B * H
                                          + (3 * H if peephole else 0))
               + 4.0 * (T * B * 4 * H + B * H)) / HBM_BYTES_PER_S
    t_ops = (2.0 * (T - 1) * B * 4 * H * H
             / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
             + T * B * H * 25.0 / F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_lstm(torch, W, R, b, forget_gate_bias, dtype):
    """torch.nn.LSTM holding the same layer: IFOG -> torch's IFGO, one bias,
    its weights in ``dtype`` and compacted into cuDNN's one chunk."""
    F, G = W.shape
    H = G // 4
    perm = torch.cat([torch.arange(0, H), torch.arange(H, 2 * H),
                      torch.arange(3 * H, 4 * H), torch.arange(2 * H, 3 * H)])
    perm = perm.to(W.device)
    lstm = torch.nn.LSTM(F, H).to(W.device)
    bias = b.clone()
    bias[H:2 * H] += forget_gate_bias
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W[:, perm].t())
        lstm.weight_hh_l0.copy_(R[:, perm].t())
        lstm.bias_ih_l0.copy_(bias[perm])
        lstm.bias_hh_l0.zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


# the LSTM forward design each shape of phases 3 and 6 must run: the
# cluster kernel (R resident across a thread-block cluster) at every T > 1
# shape of the main path, the stream kernel at decode
LSTM_DESIGNS = {"decode_layer1": "stream", "decode_layer2": "stream",
                "decode_layer1_bf16": "stream", "prefill_layer1": "cluster",
                "graves_charrnn": "cluster", "graves_charrnn_bf16": "cluster",
                "h1024": "stream", "h1024_bf16": "stream"}


def lstm_r_scale(H):
    """The scale of the LSTM phases' random R: 0.06 (a recurrent gain near
    1 at H = 256), cut by sqrt(256 / H) past H = 512 so that the gain stays
    near 1 at H = 1024."""
    return 0.06 if H <= 512 else 0.06 * (256 / H) ** 0.5


def lstm_design(name, T, B, H, dt, want, backward=False):
    """The LSTM forward (or backward) design the launcher chose for this
    call, held against its Python mirror (``fwd_design`` or
    ``bwd_design``) and against ``want`` (None: any); returns (the design,
    its kernel's device function name)."""
    from deeplearning4j_tpu_torch.ops.cuda import fused_lstm

    if backward:
        what, launcher, mirror, names = (
            "backward", fused_lstm.launcher_bwd_design, fused_lstm.bwd_design,
            fused_lstm.BWD_KERNEL_NAMES)
    else:
        what, launcher, mirror, names = (
            "forward", fused_lstm.launcher_design, fused_lstm.fwd_design,
            fused_lstm.FWD_KERNEL_NAMES)
    design = launcher(T, B, H, dt)
    if mirror(T, B, H, dt) != design:
        fail(f"LSTM {what} at {name}: the launcher chose {design}, its "
             f"Python mirror {mirror(T, B, H, dt)}")
    if want not in (None, design.kind):
        fail(f"LSTM {what} at {name} runs the {design.kind} design; want "
             f"{want}")
    return design, names[design.kind]


# the LSTM forward and backward designs each row of phase 6 must run: the
# cluster kernels at every training shape of the main path; the stream
# kernels one unit tile past the width a cluster of 16 holds in f32 (the
# forward's limit is H = 436, the backward's 440)
LSTM_TRAIN_DESIGNS = {"graves_layer1": ("cluster", "cluster"),
                      "graves_layer2": ("cluster", "cluster"),
                      "textgen_layer1": ("cluster", "cluster"),
                      "textgen_layer2": ("cluster", "cluster"),
                      "graves_layer1_bf16": ("cluster", "cluster"),
                      "textgen_layer1_bf16": ("cluster", "cluster"),
                      "textgen_layer2_bf16": ("cluster", "cluster"),
                      "stream_h448": ("stream", "stream"),
                      "h1024": ("stream", "stream"),
                      "h1024_bf16": ("stream", "stream")}


def phase_kernels(torch):
    """Kernel against plain at the main path's shapes and the GravesLSTM
    char-RNN width; each row names the forward design the launcher chose
    (LSTM_DESIGNS) and is profiled under its kernel's name. Returns (rows,
    f32 max_abs_err, bf16 max_abs_err)."""
    from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import (
        fused_lstm_layer, fused_lstm_recurrence, plain_recurrence,
    )
    from deeplearning4j_tpu_torch.ops.recurrent import lstm_layer, project_gates

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [  # name, B, T, F, H, peephole, reverse, forget_gate_bias, dtype
        ("decode_layer1", 8, 1, 77, 256, False, False, 0.0, f32),
        ("decode_layer2", 8, 1, 256, 256, False, False, 0.0, f32),
        ("prefill_layer1", 1, 47, 77, 256, False, False, 0.0, f32),
        ("graves_charrnn", 32, 64, 77, 200, True, True, 1.0, f32),
        ("decode_layer1_bf16", 8, 1, 77, 256, False, False, 0.0, bf16),
        ("graves_charrnn_bf16", 32, 64, 77, 200, True, True, 1.0, bf16),
        # past the width a cluster holds (the stream kernels), timed beside
        # cuDNN's LSTM so that the grid layer's next family can be ranked
        ("h1024", 64, 64, 256, 1024, False, False, 0.0, f32),
        ("h1024_bf16", 64, 64, 256, 1024, False, False, 0.0, bf16),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows, worst = [], {f32: 0.0, bf16: 0.0}
    for name, B, T, F, H, peep, rev, fgb, dt in shapes:
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=g)
                    * scale).to(dt)
        x, W, R, b = (rnd(B, T, F), rnd(F, 4 * H, scale=0.1),
                      rnd(H, 4 * H, scale=lstm_r_scale(H)),
                      rnd(4 * H, scale=0.1))
        h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
        p = rnd(3 * H, scale=0.1) if peep else None
        xg = project_gates(x, W, b, fgb, rev)
        ko, kh, kc = fused_lstm_recurrence(xg, R, h0, c0, p)
        torch.cuda.synchronize()
        po, ph, pc = plain_recurrence(xg, R, h0, c0, p)
        pairs = [(a.float(), r.float()) for a, r in
                 ((ko, po), (kh, ph), (kc, pc))]
        err = max(float((a - r).abs().max()) for a, r in pairs)
        finite = all(bool(torch.isfinite(a).all()) for a in (ko, kh, kc))
        if dt == f32:
            tol, ok = TOL, err <= TOL
        else:
            tol = TOL_BF16
            ok = all(bool(((a - r).abs() <= tol * (1 + r.abs())).all())
                     for a, r in pairs)
        if not finite or not ok or ko.dtype != dt:
            fail(f"kernel disagrees with plain at {name}: max_abs_err {err} "
                 f"(finite={finite}, dtype={ko.dtype}, tolerance {tol})")
        worst[dt] = max(worst[dt], err)
        design, fwd_kernel = lstm_design(name, T, B, H, dt,
                                         LSTM_DESIGNS[name])
        iters = 200 if T == 1 else 20
        kw = dict(peephole=p, forget_gate_bias=fgb, reverse=rev)
        row = {
            "shape": name, "B": B, "T": T, "F": F, "H": H, "peephole": peep,
            "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
            "design": design._asdict(), "fwd_kernel": fwd_kernel,
            "kernel_ms": cuda_ms(torch, lambda: fused_lstm_recurrence(
                xg, R, h0, c0, p), iters),
            "plain_ms": cuda_ms(torch, lambda: plain_recurrence(
                xg, R, h0, c0, p), iters),
            "layer_kernel_ms": cuda_ms(torch, lambda: fused_lstm_layer(
                x, h0, c0, W, R, b, **kw), iters),
            "layer_plain_ms": cuda_ms(torch, lambda: lstm_layer(
                x, h0, c0, W, R, b, **kw), iters),
            "library_ms": None, "library_device_ms": None,
            "library_max_abs_err": None,
        }
        row["kernel_device_ms"] = kernel_device_ms(
            torch, lambda: fused_lstm_recurrence(xg, R, h0, c0, p), iters,
            fwd_kernel)
        if row["kernel_device_ms"] is None:
            fail(f"LSTM forward at {name}: the profile shows no "
                 f"{fwd_kernel}, the {design.kind} design's kernel")
        row["bound_ms"], row["bound_by"] = lstm_bound(T, B, H, peep,
                                                      bf16=dt == bf16)
        if not peep and not rev:
            lstm = cudnn_lstm(torch, W.float(), R.float(), b.float(), fgb,
                              dt)
            xt = x.transpose(0, 1).contiguous()
            state = (h0[None].contiguous(), c0[None].contiguous())
            with torch.no_grad():
                lo, _ = lstm(xt, state)
                ref, _ = lstm_layer(x, h0, c0, W, R, b, **kw)
                row["library_max_abs_err"] = float(
                    (lo.transpose(0, 1) - ref).abs().max().float())
                row["library_ms"] = cuda_ms(torch, lambda: lstm(xt, state),
                                            iters)
                row["library_device_ms"] = call_device_ms(
                    torch, lambda: lstm(xt, state), iters)
        rows.append(row)
    return rows, worst[f32], worst[bf16]


def phase_main_path(torch, np):
    """Serve TextGenerationLSTM through the engine; returns a summary."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(seed=SEED).init(device="cuda")
    vocab = net.layers[-1].n_out
    eng = GenerationEngine(net, slots=8, max_len=256, device="cuda")
    eng.generate([1, 2, 3, 4], max_new_tokens=2)  # warm-up, not counted

    rng = np.random.default_rng(SEED)
    lens = rng.integers(4, 49, N_REQUESTS)
    news = rng.integers(8, 65, N_REQUESTS)
    reqs = [dict(prompt=rng.integers(0, vocab, int(n)).tolist(),
                 max_new_tokens=int(m),
                 **({} if i % 2 == 0 else
                    dict(temperature=0.8, top_k=40, seed=1000 + i)))
            for i, (n, m) in enumerate(zip(lens, news))]

    steps0 = eng.steps_run

    def serve():
        out = [eng.submit(r.pop("prompt"), **r) for r in
               [dict(q) for q in reqs]]
        eng.drain()
        return out

    streams, launches, reserves, wall = _count_launches(torch, KERNELS, serve)
    decode_steps = eng.steps_run - steps0
    if any(reserves.values()) or launches["fused_lstm_bwd"]:
        fail(f"serving saved {reserves} reserves and launched the backward "
             f"{launches['fused_lstm_bwd']} times (it runs under no_grad)")

    for i, (s, r) in enumerate(zip(streams, reqs)):
        if s.finish_reason != "length" or len(s.tokens) != r["max_new_tokens"]:
            fail(f"request {i} finished {s.finish_reason} with "
                 f"{len(s.tokens)}/{r['max_new_tokens']} tokens")
        if not all(0 <= t < vocab for t in s.tokens):
            fail(f"request {i} emitted a token outside the vocabulary")
    n_prefill = sum(1 for r in reqs if len(r["prompt"]) > 1)
    expected = 2 * decode_steps + 2 * n_prefill
    if launches["fused_lstm_fwd"] < 2 * decode_steps:
        fail(f"fused_lstm_fwd launched {launches['fused_lstm_fwd']} times "
             f"in {decode_steps} decode steps (2 LSTM layers each)")

    # greedy streams, teacher-forced: card (kernel) vs CPU (plain path)
    cpu_net = copy.deepcopy(net).to("cpu")
    worst = 0.0
    for s, r in zip(streams, reqs):
        if "temperature" in r:
            continue
        seq = list(r["prompt"]) + s.tokens
        first = len(r["prompt"]) - 1
        logits = []
        for m in (net, cpu_net):
            x = torch.nn.functional.one_hot(
                torch.as_tensor([seq[:-1]], device=m.device), vocab).float()
            with torch.no_grad():
                pre, _, _ = m._forward_carry(m.params, m.state, x,
                                             m._init_carries(1))
            logits.append(pre[0, first:].float().cpu())
        err = float((logits[0] - logits[1]).abs().max())
        worst = max(worst, err)
        if not bool(torch.isfinite(logits[0]).all()) or err > TOL:
            fail(f"teacher-forced logits card vs CPU plain: {err} > {TOL}")
        for lg in logits:
            top2 = lg.topk(2, dim=-1).values
            agree = lg.argmax(-1).tolist() == s.tokens
            if not agree and float((top2[:, 0] - top2[:, 1]).min()) > TOL:
                fail("greedy tokens differ from the teacher-forced argmax")

    n_tokens = sum(len(s.tokens) for s in streams)
    ttft = sorted(s.first_token_at - s.submitted_at for s in streams)
    profile = profile_decode(torch, eng, reqs)
    return {
        "model": "TextGenerationLSTM(units=256, layers=2, vocab=77)",
        "slots": 8, "max_len": 256, "requests": N_REQUESTS,
        "tokens": n_tokens, "decode_steps": decode_steps,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "launches": launches,
        "reserve_launches": reserves["fused_lstm_fwd"],
        "expected_launches": expected,
        "launches_per_decode_step": (launches["fused_lstm_fwd"]
                                     - 2 * n_prefill) / decode_steps,
        "greedy_logits_max_abs_err_vs_cpu": worst,
        "decode_profile": profile,
    }


def host_ms(torch, fn, iters: int) -> float:
    """Mean wall ms of ``fn`` followed by a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_decode(torch, eng, reqs, steps: int = 20):
    """A steady window of full-pool decode steps (the workload's mix of
    greedy and sampled knobs) under torch.profiler: host ms per step,
    device busy share, device time by kernel; then, on the same full pool,
    the wall ms of the network's forward alone and of the sampler alone."""
    from deeplearning4j_tpu_torch.generation import sample_logits

    for r in reqs[:eng.pool.n_slots]:
        eng.submit(**dict(r, max_new_tokens=steps + 40))
    # the warm-up call inside profile_device admits (prefills) all slots
    by_kernel, wall_ms = profile_device(torch, eng.step, steps)
    pool = eng.pool
    act = pool.active_slots()
    tokens = torch.as_tensor(pool.tokens, dtype=torch.long, device="cuda")
    logits = eng.adapter.decode(pool.state, tokens)[0]
    forward_ms = host_ms(
        torch, lambda: eng.adapter.decode(pool.state, tokens), steps)
    sample_ms = host_ms(torch, lambda: sample_logits(
        logits, seeds=pool.seeds, pos=pool.pos, temperature=pool.temps,
        top_k=pool.top_k, top_p=pool.top_p, rows=act), steps)
    step_ms = host_ms(torch, eng.step, steps)
    eng.drain()
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy / steps,
        "device_busy_share": busy / wall_ms if by_kernel else None,
        "top_kernels_ms_per_step": {k[:60]: t / steps
                                    for k, (t, _) in top},
        "active_slots": len(act),
        "sampled_slots": int(sum(pool.temps[s] > 0 for s in act)),
        "unprofiled_step_ms": step_ms, "forward_ms": forward_ms,
        "sample_ms": sample_ms,
    }


def phase_bf16_net(torch, np):
    """The model in bf16 on the card: the registry must send its LSTM
    work to the kernel, and the kernel path must agree with the plain path
    on the card, teacher-forced."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.ops.cuda import FUSED_LSTM
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(seed=SEED, dtype="bf16").init(device="cuda")
    vocab = net.layers[-1].n_out
    eng = GenerationEngine(net, slots=8, max_len=256, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(4, 49, 8)]
    FUSED_LSTM.launches = 0
    streams = [eng.submit(p, max_new_tokens=16) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    launches, steps = FUSED_LSTM.launches, eng.steps_run
    if any(len(s.tokens) != 16 for s in streams):
        fail("bf16 net: a request did not emit its 16 tokens")
    if launches < 2 * steps:
        fail(f"bf16 net: fused_lstm_fwd launched {launches} times in "
             f"{steps} decode steps")
    seq = prompts[0] + streams[0].tokens
    x = torch.nn.functional.one_hot(
        torch.as_tensor([seq[:-1]], device="cuda"), vocab).to(torch.bfloat16)
    logits = []
    for disable in (False, True):
        env.disable_kernels = disable
        try:
            with torch.no_grad():
                pre, _, _ = net._forward_carry(
                    net._compute_params(), net.state, x,
                    net._init_carries(1))
        finally:
            env.reload()
        logits.append(pre[0].float())
    err = float((logits[0] - logits[1]).abs().max())
    if not bool(torch.isfinite(logits[0]).all()) or err > TOL_BF16_LOGITS:
        fail(f"bf16 net: kernel vs plain logits {err} > {TOL_BF16_LOGITS}")
    return {"decode_steps": steps, "launches": launches,
            "logits_max_abs_err_kernel_vs_plain": err,
            "logit_max_abs": float(logits[1].abs().max())}


def _within(torch, got, want, dtype):
    """The stated tolerance: TOL abs in f32, TOL_BF16 (1 + |b|) in bf16."""
    if dtype == torch.float32:
        return bool(((got - want).abs() <= TOL).all())
    return bool(((got - want).abs() <= TOL_BF16 * (1 + want.abs())).all())


def phase_bwd_kernels(torch):
    """The training forward's reserve and the backward kernel against their
    plain versions, and each layer's gradients through the kernels against
    autograd through the plain lowering, at the training main paths'
    shapes; returns (rows, f32 max_abs_err, bf16 max_abs_err)."""
    from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import (
        fused_lstm_bwd_recurrence, fused_lstm_layer, fused_lstm_recurrence,
        plain_bwd_recurrence, plain_recurrence,
    )
    from deeplearning4j_tpu_torch.ops.recurrent import lstm_layer, project_gates

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [  # name, B, T, F, H, peephole, reverse, forget_gate_bias, dtype
        ("graves_layer1", 64, 64, 77, 200, True, True, 1.0, f32),
        ("graves_layer2", 64, 64, 400, 200, True, True, 1.0, f32),
        ("textgen_layer1", 64, 64, 77, 256, False, False, 0.0, f32),
        ("textgen_layer2", 64, 64, 256, 256, False, False, 0.0, f32),
        ("graves_layer1_bf16", 64, 64, 77, 200, True, True, 1.0, bf16),
        ("textgen_layer1_bf16", 64, 64, 77, 256, False, False, 0.0, bf16),
        ("textgen_layer2_bf16", 64, 64, 256, 256, False, False, 0.0, bf16),
        ("stream_h448", 64, 16, 77, 448, True, True, 1.0, f32),
        # past the width a cluster holds, beside cuDNN's LSTM pair
        ("h1024", 64, 64, 256, 1024, False, False, 0.0, f32),
        ("h1024_bf16", 64, 64, 256, 1024, False, False, 0.0, bf16),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows, worst = [], {f32: 0.0, bf16: 0.0}
    for name, B, T, F, H, peep, rev, fgb, dt in shapes:
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=g)
                    * scale).to(dt)
        x, W, R, b = (rnd(B, T, F), rnd(F, 4 * H, scale=0.1),
                      rnd(H, 4 * H, scale=lstm_r_scale(H)),
                      rnd(4 * H, scale=0.1))
        h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
        p = rnd(3 * H, scale=0.1) if peep else None
        g_out, g_h, g_c = rnd(B, T, H), rnd(B, H), rnd(B, H)
        xg = project_gates(x, W, b, fgb, rev)
        _, _, _, reserve = fused_lstm_recurrence(xg, R, h0, c0, p,
                                                 save_residuals=True)
        dout = g_out.transpose(0, 1)
        dout = (dout.flip(0) if rev else dout).contiguous()
        dg, dc0 = fused_lstm_bwd_recurrence(reserve, R, c0, dout, g_c, p)
        torch.cuda.synchronize()
        _, _, _, p_reserve = plain_recurrence(xg, R, h0, c0, p,
                                              save_residuals=True)
        # the backward is held on the kernel's own reserve, so that its
        # check does not carry the forward's rounding differences
        p_dg, p_dc0 = plain_bwd_recurrence(reserve, R, c0, dout, g_c, p)
        pairs = ((reserve, p_reserve), (dg, p_dg), (dc0, p_dc0))
        err = max(float((a - r).abs().max()) for a, r in pairs)
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
        if not finite or not all(_within(torch, a, r, dt) for a, r in pairs):
            fail(f"backward kernel disagrees with plain at {name}: "
                 f"max_abs_err {err} (finite={finite})")
        worst[dt] = max(worst[dt], err)
        want_fwd, want_bwd = LSTM_TRAIN_DESIGNS[name]
        design, fwd_kernel = lstm_design(name, T, B, H, dt, want_fwd)
        b_design, bwd_kernel = lstm_design(name, T, B, H, dt, want_bwd,
                                           backward=True)
        row = {"shape": name, "B": B, "T": T, "F": F, "H": H,
               "peephole": peep, "reverse": rev,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "fwd_design": design._asdict(), "fwd_kernel": fwd_kernel,
               "bwd_design": b_design._asdict(), "bwd_kernel": bwd_kernel}

        # the layer's gradients: kernels vs autograd through plain (f32;
        # in bf16 autograd rounds other intermediates than the kernels)
        leaves = [t.clone().requires_grad_() for t in (x, h0, c0, W, R, b)]
        lp = p.clone().requires_grad_() if peep else None
        all_leaves = leaves + ([lp] if peep else [])
        kw = dict(peephole=lp, forget_gate_bias=fgb, reverse=rev)

        def grads(fn):
            ys, (h, c) = fn(*leaves, **kw)
            return torch.autograd.grad((ys, h, c), all_leaves,
                                       (g_out, g_h, g_c))

        if dt == f32:
            got, want = grads(fused_lstm_layer), grads(lstm_layer)
            rel = max(float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
                      for a, w in zip(got, want))
            if rel > TOL_GRAD:
                fail(f"layer gradients through the kernels disagree with "
                     f"the plain path at {name}: {rel} > {TOL_GRAD}")
            row["layer_grad_max_rel_err"] = rel

        iters = 10
        row["kernel_ms"] = cuda_ms(torch, lambda: fused_lstm_bwd_recurrence(
            reserve, R, c0, dout, g_c, p), iters)
        row["kernel_device_ms"] = kernel_device_ms(
            torch, lambda: fused_lstm_bwd_recurrence(reserve, R, c0, dout,
                                                     g_c, p),
            iters, bwd_kernel)
        if row["kernel_device_ms"] is None:
            fail(f"LSTM backward at {name}: the profile shows no "
                 f"{bwd_kernel}, the {b_design.kind} design's kernel")
        row["plain_ms"] = cuda_ms(torch, lambda: plain_bwd_recurrence(
            reserve, R, c0, dout, g_c, p), 3)
        row["bound_ms"], row["bound_by"] = lstm_bwd_bound(T, B, H, peep,
                                                          dt == bf16)
        fwd = lambda: fused_lstm_recurrence(xg, R, h0, c0, p,
                                            save_residuals=True)
        row["fwd_reserve_kernel_ms"] = cuda_ms(torch, fwd, iters)
        row["fwd_reserve_device_ms"] = kernel_device_ms(torch, fwd, iters,
                                                        fwd_kernel)
        if row["fwd_reserve_device_ms"] is None:
            fail(f"LSTM forward at {name}: the profile shows no "
                 f"{fwd_kernel}, the {design.kind} design's kernel")
        row["fwd_reserve_plain_ms"] = cuda_ms(torch, lambda: plain_recurrence(
            xg, R, h0, c0, p, save_residuals=True), 3)
        row["fwd_reserve_bound_ms"], row["fwd_reserve_bound_by"] = \
            lstm_fwd_train_bound(T, B, H, peep, dt == bf16)
        row["layer_pair_ms"] = cuda_ms(torch, lambda: grads(fused_lstm_layer),
                                       iters)
        # the kernel pair plus the wrapper's projection and gradient GEMMs,
        # on the device clock: what cuDNN's forward + backward computes
        row["layer_pair_device_ms"] = call_device_ms(
            torch, lambda: grads(fused_lstm_layer), iters)
        row["layer_pair_plain_ms"] = cuda_ms(torch, lambda: grads(lstm_layer),
                                             3)
        # no library LSTM has peepholes: cuDNN's only at the shapes without
        row["library_pair_ms"] = row["library_pair_device_ms"] = None
        row["library_fwd_device_ms"] = None
        if not peep and not rev:
            lstm = cudnn_lstm(torch, W.float(), R.float(), b.float(), fgb,
                              dt)
            xt = x.transpose(0, 1).contiguous().requires_grad_()
            state = (h0[None].contiguous(), c0[None].contiguous())
            lib_leaves = [xt] + list(lstm.parameters())
            g_lib = (g_out.transpose(0, 1), g_h[None], g_c[None])

            def lib_pair():
                lo, (hn, cn) = lstm(xt, state)
                return torch.autograd.grad((lo, hn, cn), lib_leaves, g_lib)

            row["library_pair_ms"] = cuda_ms(torch, lib_pair, iters)
            row["library_pair_device_ms"] = call_device_ms(torch, lib_pair,
                                                           iters)
            row["library_fwd_ms"] = cuda_ms(torch, lambda: lstm(xt, state),
                                            iters)
            # its forward in training mode (it saves its own reserve),
            # against the kernel's forward with reserve; its input
            # projection included
            row["library_fwd_device_ms"] = call_device_ms(
                torch, lambda: lstm(xt, state), iters)
        rows.append(row)
    return rows, worst[f32], worst[bf16]


def _char_batch(np, rng, V, B, T):
    """One-hot chars and next-char labels, as the JAX package's bench.py
    builds the char-RNN batch."""
    ids = rng.integers(0, V, (B, T))
    return (np.eye(V, dtype=np.float32)[ids],
            np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)])


def _count_launches(torch, kernels, fn):
    """Zero every kernel's launch and reserve counts, run ``fn``, read the
    counts after a sync. Returns (fn's result, {name: launches}, {name:
    reserve launches} of the kernels that save a reserve, wall s)."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "reserves"):
            k.reserves = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, {k.name: k.launches for k in kernels},
            {k.name: k.reserves for k in kernels if hasattr(k, "reserves")},
            wall)


def _only(kernels, **counts):
    """The counts of a path that runs the named kernels ``counts`` times
    and no other kernel (every other name 0)."""
    want = {k.name: 0 for k in kernels}
    want.update(counts)
    return want


def _reserves_only(kernels, **counts):
    """_only over the kernels that count reserve launches."""
    return _only([k for k in kernels if hasattr(k, "reserves")], **counts)


def phase_training(torch, np):
    """Train BidirectionalGravesLSTMCharRnn at its published width."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import BidirectionalGravesLSTMCharRnn

    model = BidirectionalGravesLSTMCharRnn(seed=SEED)
    net = model.init(device="cuda")
    V, B, T = model.vocab_size, 64, model.timesteps
    n_lstm = 2 * model.layers  # two directions per bidirectional layer
    cpu_net = copy.deepcopy(net).to("cpu")
    x, y = _char_batch(np, np.random.default_rng(SEED), V, B, T)

    # two steps on the card (also its warm-up) against the CPU plain path
    card = [net.fit_batch((x, y)) for _ in range(2)]
    cpu = [cpu_net.fit_batch((x, y)) for _ in range(2)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(net.params), tree_leaves(cpu_net.params)))
    if loss_err > TOL_TRAIN_LOSS or param_err > TOL_TRAIN_PARAM:
        fail(f"2 training steps on the card vs the CPU plain path: loss "
             f"rel err {loss_err} (tol {TOL_TRAIN_LOSS}), param abs err "
             f"{param_err} (tol {TOL_TRAIN_PARAM})")

    losses, launches, reserves, wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y)) for _ in range(N_TRAIN_STEPS)])
    if not all(np.isfinite(losses)):
        fail(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss on a repeated batch did not fall: {losses}")
    want = n_lstm * N_TRAIN_STEPS
    if (launches != _only(KERNELS, fused_lstm_fwd=want, fused_lstm_bwd=want)
            or reserves != _reserves_only(KERNELS, fused_lstm_fwd=want)):
        fail(f"{N_TRAIN_STEPS} steps launched {launches} ({reserves} with "
             f"reserve); want {n_lstm} of each kernel per step")

    steps = 5
    # the forward's and the backward's cluster designs, n_lstm launches of
    # each a step
    design, fwd_kernel = lstm_design("char-RNN training", T, B,
                                     model.units, torch.float32, "cluster")
    b_design, bwd_kernel = lstm_design("char-RNN training", T, B,
                                       model.units, torch.float32, "cluster",
                                       backward=True)
    want_seen = {fwd_kernel: n_lstm, bwd_kernel: n_lstm}
    by_kernel, prof_wall_ms, seen = profile_showing(
        torch, lambda: net.fit_batch((x, y)), steps, want_seen)
    if any(seen[k] != n * steps for k, n in want_seen.items()):
        fail(f"{steps} profiled training steps show {seen} launches; want "
             f"{n_lstm} of {fwd_kernel} and of {bwd_kernel} a step")
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    step_ms = host_ms(torch, lambda: net.fit_batch((x, y)), 5)
    xd, yd = (torch.as_tensor(a, device="cuda") for a in (x, y))
    step_ms_on_card = host_ms(torch, lambda: net.fit_batch((xd, yd)), 5)
    return {
        "model": "BidirectionalGravesLSTMCharRnn(units=200, layers=2, "
                 "vocab=77), Adam 1e-3, clipping 5.0",
        "batch": B, "timesteps": T, "params": net.num_params(),
        "cpu_agreement": {"card_losses": card, "cpu_losses": cpu,
                          "loss_max_rel_err": loss_err,
                          "param_max_abs_err": param_err},
        "steps": N_TRAIN_STEPS, "losses": losses, "launches": launches,
        "reserve_launches": reserves["fused_lstm_fwd"],
        "launches_per_step": {k: v / N_TRAIN_STEPS
                              for k, v in launches.items()},
        "wall_s": wall, "step_wall_ms": 1e3 * wall / N_TRAIN_STEPS,
        "samples_per_s": B * N_TRAIN_STEPS / wall,
        "synced_step_ms": step_ms,
        "synced_step_ms_batch_on_card": step_ms_on_card,
        "fwd_design": design._asdict(), "bwd_design": b_design._asdict(),
        "profile": {
            "steps": steps, "wall_ms_per_step": prof_wall_ms / steps,
            "launches_per_step": {k: v / steps for k, v in seen.items()},
            "device_ms_per_step": busy / steps,
            "device_busy_share": busy / prof_wall_ms if by_kernel else None,
            "top_kernels_ms_per_step": {k[:60]: t / steps
                                        for k, (t, _) in top},
        },
    }


def phase_short_training(torch, np, model, per_step, steps=3):
    """A few fit_batch steps of ``model`` on the card at batch 64 x T 64:
    finite losses, ``per_step`` launches of each kernel every step."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    net = model.init(device="cuda")
    x, y = _char_batch(np, np.random.default_rng(SEED + 3),
                       model.vocab_size, 64, model.timesteps)
    net.fit_batch((x, y))  # warm-up, not counted
    losses, launches, reserves, wall = _count_launches(
        torch, KERNELS, lambda: [net.fit_batch((x, y)) for _ in range(steps)])
    name = type(model).__name__
    if not all(np.isfinite(losses)):
        fail(f"{name} ({model.dtype}) training losses not finite: {losses}")
    want = per_step * steps
    if (launches != _only(KERNELS, fused_lstm_fwd=want, fused_lstm_bwd=want)
            or reserves != _reserves_only(KERNELS, fused_lstm_fwd=want)):
        fail(f"{name} ({model.dtype}): {steps} steps launched {launches} "
             f"({reserves} with reserve); want {per_step} of each per step")
    return {"model": name, "dtype": model.dtype, "steps": steps,
            "losses": losses, "launches": launches,
            "step_wall_ms": 1e3 * wall / steps}


# ----------------------------------------------------------------- BERT slice

N_BERT_STEPS = 10
# BERT-base inference, f32 copy: kernel path vs plain path on the card
TOL_BERT_OUT = 1e-4
# gradients of the f32 BERT through the kernels vs the plain path on the
# card, per leaf: |a - b| <= TOL_BERT_GRAD * max |b| (f32 sums in other
# orders through 12 layers; the floor of max |b| is in phase_bert_training)
TOL_BERT_GRAD = 1e-3


def flash_bound(torch, kind, q, k, kmask, causal):
    """Least time of one flash kernel call: each input read once, each output
    written once, at 3.35 TB/s, against the products over the (query, key)
    pairs this call's mask leaves visible, at the peak for the inputs' type
    (bf16 tensor cores, or f32 off them). Forward: 4 D flops a pair (q k^T,
    p v); dq: 6 (q k^T, do v^T, ds k); dk/dv: 8 (and p^T do, ds^T q)."""
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import _valid

    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    e = 2.0 if bf16 else 4.0
    valid = _valid(Tq, Tk, kmask, causal, q.device)
    pairs = float(valid.sum()) * N * (B if kmask is None else 1)
    rows_q, rows_k = B * N * Tq * D, B * N * Tk * D
    mask_bytes = 4.0 * B * Tk if kmask is not None else 0.0
    if kind == "fwd":
        nbytes = e * (2 * rows_q + 2 * rows_k) + 4.0 * B * N * Tq + mask_bytes
        flops = 4.0 * D * pairs
    elif kind == "dq":
        nbytes = (e * (2 * rows_q + 2 * rows_k) + 8.0 * B * N * Tq
                  + mask_bytes + 4.0 * rows_q)
        flops = 6.0 * D * pairs
    else:
        nbytes = (e * (2 * rows_q + 2 * rows_k) + 8.0 * B * N * Tq
                  + mask_bytes + 8.0 * rows_k)
        flops = 8.0 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _attn_inputs(torch, g, B, N, T, D, dtype, masked):
    """q, k, v, do on the card and a [B, T] f32 key mask whose lengths are
    drawn from 1..T (every row sees at least one key)."""
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    q, k, v, do = rnd(B, N, T, D), rnd(B, N, T, D), rnd(B, N, T, D), \
        rnd(B, N, T, D)
    kmask = None
    if masked:
        lens = torch.randint(1, T + 1, (B,), device="cuda", generator=g)
        kmask = (torch.arange(T, device="cuda")[None, :]
                 < lens[:, None]).float()
    return q, k, v, do, kmask


def _err_within(torch, got, want, dtype):
    """(max abs error over finite entries, whether within the stated
    tolerance); infinities must sit at the same places."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or \
            not bool((got[~fin] == want[~fin]).all()):
        return float("inf"), False
    a, b = got[fin], want[fin]
    err = float((a - b).abs().max()) if a.numel() else 0.0
    return err, _within(torch, a, b, dtype)


def flash_tensor_cores(torch):
    """The bf16 flash forward, dq and dk/dv run on the tensor cores: their
    machine code (``cuobjdump -sass`` of the built libraries) holds HGMMA
    (wgmma) or HMMA (mma.sync) instructions, and the f32 kernels hold none;
    and the
    tile layer's two products (``tile_check``) agree with the same product
    on the card in f32 (TF32 off; only the order of f32 sums differs:
    1e-4 (1 + |ref|)). Returns the counts by kernel and the products'
    errors."""
    from deeplearning4j_tpu_torch.ops.cuda.build import tensor_core_ops
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        DKV_KERNEL_NAMES, DQ_KERNEL_NAMES, FLASH_DKV, FLASH_DQ, FLASH_FWD,
        FWD_KERNEL_NAMES, tile_check,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    out = {"sass": {}}
    for kern, names in ((FLASH_FWD, FWD_KERNEL_NAMES),
                        (FLASH_DQ, DQ_KERNEL_NAMES),
                        (FLASH_DKV, DKV_KERNEL_NAMES)):
        for dt in (bf16, f32):
            out["sass"][names[dt]] = tensor_core_ops(kern.library, names[dt])
        tc = out["sass"][names[bf16]]
        if tc["HGMMA"] + tc["HMMA"] == 0:
            fail(f"{names[bf16]} compiled to no tensor-core instruction "
                 f"(HGMMA/HMMA): {tc}")
        if sum(out["sass"][names[f32]].values()):
            fail(f"{names[f32]} holds tensor-core instructions: "
                 f"{out['sass'][names[f32]]}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    a, b = (torch.randn(64, 128, device="cuda", generator=g).to(bf16)
            for _ in range(2))
    ss, rs = tile_check(a, b)
    torch.cuda.synchronize()
    for name, got, want in (("ss", ss, a.float() @ b.float().T),
                            ("rs", rs, a[:, :64].float() @ b.float())):
        err = (got - want).abs()
        out[f"tile_{name}_max_abs_err"] = float(err.max())
        if not bool((err <= 1e-4 * (1 + want.abs())).all()):
            fail(f"tensor-core tile layer, {name} product: max abs err "
                 f"{float(err.max())}")
    return out


def phase_flash_kernels(torch):
    """The three flash kernels against their plain versions, the autograd
    Function against the plain lowering, and times at BERT-base's shape;
    returns (rows, timings {dtype: {...}}, f32 and bf16 max_abs_err)."""
    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_backward, flash_backward_plain, flash_forward,
        flash_forward_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(f"bert_{'bf16' if dt == bf16 else 'f32'}"
               f"{'_masked' if m else ''}{'_causal' if c else ''}",
               32, 12, 128, 64, dt, m, c)
              for dt in (f32, bf16) for m in (False, True)
              for c in (False, True)]
    shapes += [("ragged_f32_masked", 4, 4, 77, 64, f32, True, False),
               ("ragged_bf16_masked_causal", 4, 4, 77, 64, bf16, True, True),
               ("t300_d128_f32_masked_causal", 2, 2, 300, 128, f32, True, True),
               ("t300_d128_bf16", 2, 2, 300, 128, bf16, False, False)]
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows, worst = [], {f32: 0.0, bf16: 0.0}
    for name, B, N, T, D, dt, masked, causal in shapes:
        q, k, v, do, kmask = _attn_inputs(torch, g, B, N, T, D, dt, masked)
        kw = dict(scale=1.0 / D ** 0.5, causal=causal, kmask=kmask)
        o, lse = flash_forward(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        grads = flash_backward(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        po, plse = flash_forward_plain(q, k, v, **kw)
        # the backward is held on the kernel's own lse and delta, so that
        # its check does not carry the forward's rounding differences
        pgrads = flash_backward_plain(q, k, v, do, lse, delta, **kw)
        row = {"shape": name, "B": B, "N": N, "T": T, "D": D,
               "dtype": str(dt).replace("torch.", ""), "masked": masked,
               "causal": causal}
        for what, a, b, t in [("o", o, po, dt), ("lse", lse, plse, f32)] + [
                (n, a, b, dt) for n, a, b in zip(("dq", "dk", "dv"), grads,
                                                 pgrads)]:
            err, ok = _err_within(torch, a, b, t)
            if not ok or a.dtype != (b.dtype if what != "o" else dt):
                fail(f"flash kernel disagrees with plain at {name}: {what} "
                     f"max_abs_err {err} (dtype {a.dtype})")
            row[f"{what}_max_abs_err"] = err
            worst[dt] = max(worst[dt], err)
        rows.append(row)

    # gradients through the Function against autograd through the plain
    # lowering (f32, key padding as the layers pass it)
    q, k, v, do, kmask = _attn_inputs(torch, g, 32, 12, 128, 64, f32, True)
    bm = kmask[:, None, None, :] > 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, mask=bm), leaves, do)
    want = torch.autograd.grad(dot_product_attention(*leaves, mask=bm),
                               leaves, do)
    grad_rel = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip(got, want))
    if grad_rel > TOL_GRAD:
        fail(f"FlashAttentionFunction gradients disagree with autograd "
             f"through the plain lowering: {grad_rel} > {TOL_GRAD}")

    timings = {}
    for dt in (f32, bf16):
        timings[str(dt).replace("torch.", "")] = time_flash(
            torch, g, dt, flash_forward, flash_backward, flash_forward_plain,
            flash_backward_plain)
    return rows, timings, grad_rel, worst[f32], worst[bf16]


def time_flash(torch, g, dt, fwd, bwd, fwd_plain, bwd_plain):
    """Times at the BERT main path's shape, [32, 12, 128, 64] with a
    key-padding mask: each kernel (CUDA events around the wrapper, and the
    profiler's device time), its plain version, and
    scaled_dot_product_attention with the same boolean mask (forward, and
    backward alone on a retained graph); the bounds."""
    from deeplearning4j_tpu_torch.ops.cuda.build import launch, pointer
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        DKV_KERNEL_NAMES, DQ_KERNEL_NAMES, FLASH_DKV, FLASH_DQ,
        FWD_KERNEL_NAMES, _DKV_SYMBOLS, _DQ_SYMBOLS,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do, kmask = _attn_inputs(torch, g, 32, 12, 128, 64, dt, True)
    kw = dict(scale=0.125, causal=False, kmask=kmask)
    o, lse = fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    B, N, T, D = q.shape
    dq = torch.empty((B, N, T, D), device="cuda")
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    common = (B * N, N, T, T, D, 0.125, 0)
    ins = tuple(pointer(t) for t in (q, k, v, do, lse, delta, kmask))

    def dq_only():
        launch(FLASH_DQ, _DQ_SYMBOLS[dt], q.device, ins + (pointer(dq),)
               + common)

    def dkv_only():
        launch(FLASH_DKV, _DKV_SYMBOLS[dt], q.device,
               ins + (pointer(dk), pointer(dv)) + common)

    bm = kmask[:, None, None, :] > 0
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(lq, lk, lv, attn_mask=bm)
    lib_fwd = lambda: sdpa(q, k, v, attn_mask=bm)  # noqa: E731
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (lq, lk, lv), do, retain_graph=True)
    iters = 20
    out = {
        "shape": "[32, 12, 128, 64], key-padding mask",
        "fwd_ms": cuda_ms(torch, lambda: fwd(q, k, v, **kw), iters),
        "fwd_device_ms": kernel_device_ms(torch, lambda: fwd(q, k, v, **kw),
                                          iters, FWD_KERNEL_NAMES[dt]),
        "fwd_plain_ms": cuda_ms(torch, lambda: fwd_plain(q, k, v, **kw),
                                iters),
        "dq_ms": cuda_ms(torch, dq_only, iters),
        "dq_device_ms": kernel_device_ms(torch, dq_only, iters,
                                         DQ_KERNEL_NAMES[dt]),
        "dkv_ms": cuda_ms(torch, dkv_only, iters),
        "dkv_device_ms": kernel_device_ms(torch, dkv_only, iters,
                                          DKV_KERNEL_NAMES[dt]),
        "bwd_ms": cuda_ms(torch, lambda: bwd(q, k, v, do, lse, delta, **kw),
                          iters),
        "bwd_plain_ms": cuda_ms(torch, lambda: bwd_plain(
            q, k, v, do, lse, delta, **kw), iters),
        "library_fwd_ms": cuda_ms(torch, lib_fwd, iters),
        "library_bwd_ms": cuda_ms(torch, lib_bwd, iters),
        "library_fwd_device_ms": call_device_ms(torch, lib_fwd, iters),
        "library_bwd_device_ms": call_device_ms(torch, lib_bwd, iters),
    }
    for kind in ("fwd", "dq", "dkv"):
        out[f"{kind}_bound_ms"], out[f"{kind}_bound_by"] = flash_bound(
            torch, kind, q, k, kmask, False)
    # the launches above were for timing: they are not the main path's
    return out


def phase_bert_inference(torch, np):
    """BertBase at its published width answering output() calls on the
    card; returns a summary."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import BertBase

    model = BertBase(seed=SEED, max_len=128)
    net = model.init(device="cuda")
    B, T = 32, model.max_len
    rng = np.random.default_rng(SEED + 5)
    x = rng.integers(0, model.vocab_size, (B, T)).astype(np.int64)
    lens = rng.integers(1, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    net.output(x, mask=mask)  # warm-up, not counted
    calls = 5
    outs, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: [net.output(x, mask=mask)
                                 for _ in range(calls)])
    want = _only(KERNELS, flash_attention_fwd=model.n_layers * calls)
    if launches != want:
        fail(f"BERT-base output(): {calls} calls launched {launches}; want "
             f"{model.n_layers} flash forwards a call and nothing else")
    out = outs[-1]
    if (tuple(out.shape) != (B, model.num_classes) or out.grad_fn is not None
            or not bool(torch.isfinite(out).all())
            # bf16 softmax: each probability rounded to bf16 (2^-9 relative)
            or float((out.sum(-1) - 1).abs().max()) > 1e-2):
        fail(f"BERT-base output() gave {tuple(out.shape)}, grad_fn "
             f"{out.grad_fn}, finite {bool(torch.isfinite(out).all())}")

    # an f32 copy on the same weights: kernel path vs plain path on the card
    net32 = BertBase(seed=SEED, max_len=128, dtype="float32").init(
        device="cuda")
    net32.params = [{n: a.clone() for n, a in p.items()} for p in net.params]
    o_kernel = net32.output(x, mask=mask)
    env.disable_kernels = True
    try:
        o_plain = net32.output(x, mask=mask)
    finally:
        env.reload()
    err = float((o_kernel - o_plain).abs().max())
    if err > TOL_BERT_OUT:
        fail(f"BERT-base f32 output(), kernels vs plain on the card: {err} "
             f"> {TOL_BERT_OUT}")
    del net32

    by_kernel, prof_wall = profile_device(
        torch, lambda: net.output(x, mask=mask), calls)
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "model": "BertBase(12 x 768, 12 heads, d_ff 3072, vocab 30522, "
                 "max_len 128), bf16",
        "batch": B, "timesteps": T, "params": net.num_params(),
        "calls": calls, "launches": launches,
        "launches_per_call": launches["flash_attention_fwd"] / calls,
        "wall_ms_per_call": 1e3 * wall / calls,
        "sequences_per_s": B * calls / wall,
        "synced_ms_per_call": host_ms(torch, lambda: net.output(x, mask=mask),
                                      calls),
        "f32_copy_max_abs_err_kernel_vs_plain": err,
        "profile": {
            "calls": calls, "wall_ms_per_call": prof_wall / calls,
            "device_ms_per_call": busy / calls,
            "device_busy_share": busy / prof_wall if by_kernel else None,
            "device_kernels_per_call": sum(n for _, n in by_kernel.values())
            / calls,
            "top_kernels_ms_per_call": {k[:60]: t / calls
                                        for k, (t, _) in top},
        },
    }, net


def _bert_batch(np, seed, B=32, T=128, V=30522):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (B, T)).astype(np.int64)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    lens = rng.integers(1, T + 1, B)
    return x, y, (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _bert_grads(torch, net, x, y, m):
    """Gradient leaves of one batch's loss (eval mode: no dropout)."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().requires_grad_(), net.params)
    leaves = tree_leaves(params)
    loss, _ = net._loss_terms(params, net._input(x), net._labels(y),
                              net._mask(m), None, train=False)
    return torch.autograd.grad(loss, leaves)


def split_step_ms(torch, net, x, y, m, steps=3):
    """Host ms of the three parts of a train step, each ended by a sync:
    forward + loss, autograd backward, clipping + updaters (the same calls
    as ``_train_step``; the update's result is dropped)."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating
    from deeplearning4j_tpu_torch.common.trees import (
        tree_leaves, tree_map, tree_unflatten,
    )

    xi, yl, mk = net._input(x), net._labels(y), net._mask(m)
    parts = {"forward_loss": 0.0, "backward": 0.0, "clip_update": 0.0}
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tree_map(lambda p: p.detach().requires_grad_(), net.params)
        loss = net._loss_terms(
            cast_floating(params, net._policy.compute_dtype), xi, yl, mk,
            None, train=True, rng=net._generator())[0].float()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            net._apply_updaters(tree_unflatten(net.params, list(grads)),
                                net.params, net.opt_state, net.step_count)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k] += 1e3 * dt / steps
    return parts


def phase_bert_training(torch, np, net):
    """BertBase fine-tuning on the card: the main path's steps, then an f32
    copy against the plain path; returns a summary."""
    import copy as _copy

    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import BertBase

    x, y, m = _bert_batch(np, SEED + 6)
    B = x.shape[0]
    for _ in range(2):  # warm-up, not counted
        net.fit_batch((x, y, m))
    losses, launches, _, wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y, m)) for _ in range(N_BERT_STEPS)])
    if not all(np.isfinite(losses)):
        fail(f"BERT-base training losses not finite: {losses}")
    per = 12 * N_BERT_STEPS
    want = _only(KERNELS, flash_attention_fwd=per, flash_attention_dq=per,
                 flash_attention_dkv=per)
    if launches != want:
        fail(f"BERT-base: {N_BERT_STEPS} steps launched {launches}; want 12 "
             f"forward, 12 dq and 12 dk/dv a step")
    steps = 3
    by_kernel, prof_wall = profile_device(
        torch, lambda: net.fit_batch((x, y, m)), steps)
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    step_ms = host_ms(torch, lambda: net.fit_batch((x, y, m)), 3)
    split = split_step_ms(torch, net, x, y, m)

    # f32, dropout 0: 2 steps and the gradients, kernels vs plain on the card
    a = BertBase(seed=SEED, max_len=128, dtype="float32", dropout=0.0).init(
        device="cuda")
    b = _copy.deepcopy(a)
    ga = _bert_grads(torch, a, x, y, m)
    env.disable_kernels = True
    try:
        gb = _bert_grads(torch, b, x, y, m)
    finally:
        env.reload()
    # each leaf's error over its largest gradient, floored at 1e-3 of the
    # largest of all: bk's gradient is 0 in exact arithmetic (the softmax
    # ignores a shift of a query's logits) and its float value is noise
    floor = 1e-3 * max(float(q.abs().max()) for q in gb)
    grad_rel = max(float((p - q).abs().max()) / max(float(q.abs().max()),
                                                    floor)
                   for p, q in zip(ga, gb))
    if grad_rel > TOL_BERT_GRAD:
        fail(f"f32 BERT-base gradients, kernels vs plain on the card: "
             f"{grad_rel} > {TOL_BERT_GRAD}")
    la = [a.fit_batch((x, y, m)) for _ in range(2)]
    env.disable_kernels = True
    try:
        lb = [b.fit_batch((x, y, m)) for _ in range(2)]
    finally:
        env.reload()
    loss_err = max(abs(p - q) / abs(q) for p, q in zip(la, lb))
    param_err = max(float((p - q).abs().max()) for p, q in zip(
        tree_leaves(a.params), tree_leaves(b.params)))
    if loss_err > TOL_TRAIN_LOSS or param_err > TOL_TRAIN_PARAM:
        fail(f"f32 BERT-base, 2 steps, kernels vs plain on the card: loss "
             f"rel err {loss_err} (tol {TOL_TRAIN_LOSS}), param abs err "
             f"{param_err} (tol {TOL_TRAIN_PARAM})")
    del a, b
    return {
        "model": "BertBase(12 x 768, 12 heads, d_ff 3072, vocab 30522, "
                 "max_len 128), bf16, AdamW 2e-5 warmup-cosine, clip 1.0, "
                 "dropout 0.1",
        "batch": B, "timesteps": x.shape[1], "steps": N_BERT_STEPS,
        "losses": losses, "launches": launches,
        "launches_per_step": {k: v / N_BERT_STEPS
                              for k, v in launches.items() if v},
        "wall_s": wall, "step_wall_ms": 1e3 * wall / N_BERT_STEPS,
        "samples_per_s": B * N_BERT_STEPS / wall,
        "synced_step_ms": step_ms, "synced_step_split_ms": split,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "f32_copy": {"card_kernel_losses": la, "card_plain_losses": lb,
                     "loss_max_rel_err": loss_err,
                     "param_max_abs_err": param_err,
                     "grad_max_rel_err": grad_rel},
        "profile": {
            "steps": steps, "wall_ms_per_step": prof_wall / steps,
            "device_ms_per_step": busy / steps,
            "device_busy_share": busy / prof_wall if by_kernel else None,
            "device_kernels_per_step": sum(n for _, n in by_kernel.values())
            / steps,
            # the three flash kernels' share of the step's device time
            "flash_device_ms_per_step": sum(
                t for k, (t, _) in by_kernel.items() if "flash_" in k) / steps,
            "top_kernels_ms_per_step": {k[:60]: t / steps
                                        for k, (t, _) in top},
        },
    }


# ----------------------------------------------------------- AlexNet slice

# LRN kernels against their plain versions (the JAX package's own
# tolerances for its Pallas kernel against the XLA lowering): f32 forward
# |k - p| <= 2e-6 + 2e-5 |p|, backward 2e-6 + 2e-4 |p|; bf16 TOL_BF16
TOL_LRN_FWD = (2e-6, 2e-5)
TOL_LRN_BWD = (2e-6, 2e-4)
# AlexNet f32 output() logits, kernels vs plain on the card, relative to
# the largest logit (the LRN kernel and the plain lowering differ by f32
# rounding, carried through three convs and three dense layers)
TOL_ALEXNET_LOGITS = 1e-4
N_ALEXNET_STEPS = 10
N_LENET_STEPS = 20
ALEXNET_BATCH = 128  # the AlexNet paper's batch
LENET_BATCH = 64


def lrn_bound(shape, dtype_bytes: int, backward: bool, depth: int = 5):
    """Least time of one LRN kernel call: x read and y written once (plus g
    for the backward) at 3.35 TB/s, against its f32 flops (forward about
    depth + 5 an element, backward about 2 depth + 10) at 67 TFLOP/s."""
    n = 1
    for d in shape:
        n *= d
    t_bytes = dtype_bytes * n * (3 if backward else 2) / HBM_BYTES_PER_S
    flops = n * ((2 * depth + 10) if backward else (depth + 5))
    t_ops = flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _lrn_within(torch, got, want, dtype, tol):
    """(max abs error, whether within the stated tolerance)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if dtype == torch.float32:
        atol, rtol = tol
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    else:
        ok = bool(((got - want).abs() <= TOL_BF16 * (1 + want.abs())).all())
    return err, ok and bool(torch.isfinite(got).all())


def phase_lrn_kernels(torch):
    """The LRN kernels against their plain versions at AlexNet's two LRN
    shapes and two ragged ones, f32 and bf16; LRNFunction's gradient
    against autograd through the plain lowering; times at AlexNet's shapes
    in f32. Returns (rows, times, grad rel err, f32 and bf16 worst)."""
    from deeplearning4j_tpu_torch.ops.convolution import lrn as plain_lrn
    from deeplearning4j_tpu_torch.ops.cuda.lrn import (
        lrn_backward, lrn_bwd_plain, lrn_forward, lrn_fwd_plain, lrn_kernel,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    alex = dict(alpha=1e-4, beta=0.75, k=2.0)  # DL4J's defaults, AlexNet's
    strong = dict(alpha=0.5, beta=0.6, k=1.0)  # the window moves the result
    shapes = [  # name, shape, depth, hparams
        ("alexnet_conv1", (ALEXNET_BATCH, 54, 54, 96), 5, alex),
        ("alexnet_conv2", (ALEXNET_BATCH, 26, 26, 256), 5, alex),
        ("ragged_even_depth", (3, 7, 5, 77), 4, strong),
        ("c_below_depth", (4, 3, 3, 3), 5, strong),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, worst = [], {f32: 0.0, bf16: 0.0}
    for name, shape, depth, hp in shapes:
        for dt in (f32, bf16):
            x = (2.0 * torch.randn(shape, device="cuda", generator=g)).to(dt)
            gy = torch.randn(shape, device="cuda", generator=g).to(dt)
            kw = dict(depth=depth, **hp)
            y = lrn_forward(x, **kw)
            dx = lrn_backward(x, gy, **kw)
            torch.cuda.synchronize()
            ef, okf = _lrn_within(torch, y, lrn_fwd_plain(x, **kw), dt,
                                  TOL_LRN_FWD)
            eb, okb = _lrn_within(torch, dx, lrn_bwd_plain(x, gy, **kw), dt,
                                  TOL_LRN_BWD)
            if not (okf and okb) or y.dtype != dt or dx.dtype != dt:
                fail(f"LRN kernels disagree with plain at {name} {dt}: "
                     f"forward {ef}, backward {eb}")
            worst[dt] = max(worst[dt], ef, eb)
            rows.append({"shape": name, "dims": list(shape), "depth": depth,
                         "dtype": str(dt).replace("torch.", ""),
                         "fwd_max_abs_err": ef, "bwd_max_abs_err": eb})

    # LRNFunction against autograd through the plain lowering (f32)
    x = 2.0 * torch.randn((16, 26, 26, 256), device="cuda", generator=g)
    gy = torch.randn(x.shape, device="cuda", generator=g)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (ga,) = torch.autograd.grad(lrn_kernel(a, depth=5, **strong), a, gy)
    (gb,) = torch.autograd.grad(plain_lrn(b, depth=5, **strong), b, gy)
    grad_rel = float((ga - gb).abs().max()) / float(gb.abs().max())
    if grad_rel > TOL_GRAD:
        fail(f"LRNFunction's gradient disagrees with autograd through the "
             f"plain lowering: {grad_rel} > {TOL_GRAD}")

    times = {}
    for name, shape, _, _ in shapes[:2]:  # AlexNet's two LRN layers
        for dt in (f32, bf16):
            key = f"{name}_{str(dt).replace('torch.', '')}"
            times[key] = time_lrn(torch, g, shape, dt)
    return rows, times, grad_rel, worst[f32], worst[bf16]


def time_lrn(torch, g, shape, dt, depth=5):
    """Times of both LRN kernels at one of the main path's shapes: the
    wrapper (CUDA events) and the profiler's device time, the plain
    versions, and as a yardstick the port never calls,
    torch.nn.functional.local_response_norm on a contiguous NCHW copy
    (size=depth, alpha*depth: PyTorch averages over the window) forward
    and its autograd backward on a retained graph, on CUDA events and as
    the device time of its kernels; the backward's element-by-element path
    on a copy that is not 16-byte aligned; the bounds."""
    from deeplearning4j_tpu_torch.ops.cuda.lrn import (
        lrn_backward, lrn_bwd_plain, lrn_forward, lrn_fwd_plain,
    )

    F = torch.nn.functional
    hp = dict(depth=depth, alpha=1e-4, beta=0.75, k=2.0)
    x = (2.0 * torch.randn(shape, device="cuda", generator=g)).to(dt)
    gy = torch.randn(shape, device="cuda", generator=g).to(dt)
    xl = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
    gl = gy.permute(0, 3, 1, 2).contiguous()
    lib = lambda t: F.local_response_norm(  # noqa: E731
        t, size=depth, alpha=hp["alpha"] * depth, beta=hp["beta"], k=hp["k"])
    lib_out = lib(xl)
    lib_err = float((lib_out.detach().permute(0, 2, 3, 1).float()
                     - lrn_fwd_plain(x, **hp).float()).abs().max())
    iters = 20
    e = 2 if dt == torch.bfloat16 else 4
    out = {
        "shape": list(shape), "dtype": str(dt).replace("torch.", ""),
        "tf32": False,
        "fwd_ms": cuda_ms(torch, lambda: lrn_forward(x, **hp), iters),
        "fwd_device_ms": kernel_device_ms(
            torch, lambda: lrn_forward(x, **hp), iters, "lrn_fwd_kernel"),
        "fwd_plain_ms": cuda_ms(torch, lambda: lrn_fwd_plain(x, **hp), iters),
        "bwd_ms": cuda_ms(torch, lambda: lrn_backward(x, gy, **hp), iters),
        "bwd_device_ms": kernel_device_ms(
            torch, lambda: lrn_backward(x, gy, **hp), iters,
            "lrn_bwd_kernel"),
        "bwd_plain_ms": cuda_ms(torch, lambda: lrn_bwd_plain(x, gy, **hp),
                                iters),
        "library_fwd_ms": cuda_ms(torch, lambda: lib(xl.detach()), iters),
        "library_bwd_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            lib_out, xl, gl, retain_graph=True), iters),
        "library_fwd_device_ms": call_device_ms(
            torch, lambda: lib(xl.detach()), iters),
        "library_bwd_device_ms": call_device_ms(
            torch, lambda: torch.autograd.grad(lib_out, xl, gl,
                                               retain_graph=True), iters),
        "library_max_abs_err_vs_plain": lib_err,
    }
    # the backward's element-by-element path (no 16-byte loads): the same
    # data one element past a 16-byte boundary
    xm, gm = (torch.empty(t.numel() + 1, device="cuda", dtype=dt)[1:]
              .view(shape).copy_(t) for t in (x, gy))
    if xm.data_ptr() % 16 == 0:
        fail("the element path's copy of x is 16-byte aligned")
    out["bwd_element_path_device_ms"] = kernel_device_ms(
        torch, lambda: lrn_backward(xm, gm, **hp), iters, "lrn_bwd_kernel")
    out["fwd_bound_ms"], out["fwd_bound_by"] = lrn_bound(shape, e, False,
                                                        depth)
    out["bwd_bound_ms"], out["bwd_bound_by"] = lrn_bound(shape, e, True,
                                                        depth)
    # the launches above were for timing: they are not the main path's
    return out


def _profile_summary(by_kernel, wall_ms, n, unit, top_n=8):
    """A profiled window of ``n`` calls or steps (``unit``): wall and device
    ms each, device busy share, device kernels each, top kernels."""
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {
        f"{unit}s": n, f"wall_ms_per_{unit}": wall_ms / n,
        f"device_ms_per_{unit}": busy / n,
        "device_busy_share": busy / wall_ms if by_kernel else None,
        f"device_kernels_per_{unit}": sum(c for _, c in by_kernel.values()) / n,
        f"top_kernels_ms_per_{unit}": {k[:60]: t / n for k, (t, _) in top},
    }


def _alexnet_images(torch, seed, B, H=224, W=224, C=3, classes=1000):
    """Random images in [0, 1) and one-hot labels, made on the card from
    the seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((B, H, W, C), device="cuda", generator=g)
    y = torch.nn.functional.one_hot(
        torch.randint(0, classes, (B,), device="cuda", generator=g),
        classes).float()
    return x, y


def phase_alexnet_inference(torch, np):
    """AlexNet at its published width answering output() calls on the
    card; returns (summary, net)."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import AlexNet

    net = AlexNet(seed=SEED).init(device="cuda")
    x, _ = _alexnet_images(torch, SEED + 8, ALEXNET_BATCH)
    net.output(x)  # warm-up, not counted
    calls = 5
    outs, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: [net.output(x) for _ in range(calls)])
    if launches != _only(KERNELS, lrn_fwd=2 * calls):
        fail(f"AlexNet output(): {calls} calls launched {launches}; want 2 "
             f"LRN forwards a call and nothing else")
    out = outs[-1]
    if (tuple(out.shape) != (ALEXNET_BATCH, 1000) or out.grad_fn is not None
            or not bool(torch.isfinite(out).all())
            or float((out.sum(-1) - 1).abs().max()) > 1e-4):
        fail(f"AlexNet output() gave {tuple(out.shape)}, grad_fn "
             f"{out.grad_fn}, finite {bool(torch.isfinite(out).all())}")

    # the same f32 net (TF32 off): kernel path vs plain path on the card
    def logits():
        with torch.no_grad():
            return net._forward(net.params, net.state, x, None)[0]

    k_logits = logits()
    env.disable_kernels = True
    try:
        p_logits = logits()
    finally:
        env.reload()
    err = float((k_logits - p_logits).abs().max()) / float(
        p_logits.abs().max())
    if err > TOL_ALEXNET_LOGITS:
        fail(f"AlexNet f32 logits, kernels vs plain on the card: {err} > "
             f"{TOL_ALEXNET_LOGITS} (relative)")

    by_kernel, prof_wall = profile_device(torch, lambda: net.output(x), calls)
    # PyTorch's copy kernels in a call: the conv weights' channels_last
    # copies (one a conv layer); an activation copied before the LRN
    # kernel or a pool would add more
    copies = [(t, n) for k, (t, n) in by_kernel.items() if "copy" in k.lower()]
    return {
        "model": "AlexNet(224 x 224 x 3, conv 96-256-384-384-256, 2 LRN, "
                 "dense 4096-4096, 1000 classes), f32",
        "tf32": False, "batch": ALEXNET_BATCH, "params": net.num_params(),
        "calls": calls, "launches": launches,
        "launches_per_call": {k: v / calls for k, v in launches.items() if v},
        "wall_ms_per_call": 1e3 * wall / calls,
        "images_per_s": ALEXNET_BATCH * calls / wall,
        "synced_ms_per_call": host_ms(torch, lambda: net.output(x), calls),
        "logits_max_rel_err_kernel_vs_plain": err,
        "copy_kernels_per_call": sum(n for _, n in copies) / calls,
        "copy_device_ms_per_call": sum(t for t, _ in copies) / calls,
        "profile": _profile_summary(by_kernel, prof_wall, calls, "call"),
    }, net


def _without_dropout(conf):
    """A copy of ``conf`` with every layer's dropout set to 0."""
    import dataclasses as dc

    conf = copy.deepcopy(conf)
    conf.layers = [dc.replace(l, dropout=0.0) for l in conf.layers]
    return conf


def phase_alexnet_training(torch, np, net):
    """AlexNet fit_batch at B=128 on the card: the main path's steps, a
    profiled window, then a dropout-0 copy against the plain path."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    x, y = _alexnet_images(torch, SEED + 9, ALEXNET_BATCH)
    torch.cuda.reset_peak_memory_stats()
    net.fit_batch((x, y))  # warm-up, not counted
    losses, launches, _, wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y)) for _ in range(N_ALEXNET_STEPS)])
    if not all(np.isfinite(losses)):
        fail(f"AlexNet training losses not finite: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"AlexNet loss on a repeated batch did not fall: {losses}")
    n = 2 * N_ALEXNET_STEPS
    if launches != _only(KERNELS, lrn_fwd=n, lrn_bwd=n):
        fail(f"AlexNet: {N_ALEXNET_STEPS} steps launched {launches}; want 2 "
             f"LRN forward and 2 LRN backward a step and nothing else")
    steps = 3
    by_kernel, prof_wall = profile_device(
        torch, lambda: net.fit_batch((x, y)), steps)
    step_ms = host_ms(torch, lambda: net.fit_batch((x, y)), 3)
    split = split_step_ms(torch, net, x, y, None)
    peak = torch.cuda.max_memory_allocated() / 1e9

    # dropout 0, f32: 2 steps, kernels vs plain on the card, both from the
    # seed's untrained weights
    a = MultiLayerNetwork(_without_dropout(net.conf)).init(device="cuda")
    b = copy.deepcopy(a)
    la = [a.fit_batch((x, y)) for _ in range(2)]
    env.disable_kernels = True
    try:
        lb = [b.fit_batch((x, y)) for _ in range(2)]
    finally:
        env.reload()
    loss_err = max(abs(p - q) / abs(q) for p, q in zip(la, lb))
    param_err = max(float((p - q).abs().max()) for p, q in zip(
        tree_leaves(a.params), tree_leaves(b.params)))
    if loss_err > TOL_TRAIN_LOSS or param_err > TOL_TRAIN_PARAM:
        fail(f"f32 dropout-0 AlexNet, 2 steps, kernels vs plain on the card: "
             f"loss rel err {loss_err} (tol {TOL_TRAIN_LOSS}), param abs err "
             f"{param_err} (tol {TOL_TRAIN_PARAM})")
    del a, b
    return {
        "model": "AlexNet, f32, Nesterovs 1e-2 momentum 0.9, dropout 0.5",
        "tf32": False, "batch": ALEXNET_BATCH, "steps": N_ALEXNET_STEPS,
        "losses": losses, "launches": launches,
        "launches_per_step": {k: v / N_ALEXNET_STEPS
                              for k, v in launches.items() if v},
        "wall_s": wall, "step_wall_ms": 1e3 * wall / N_ALEXNET_STEPS,
        "samples_per_s": ALEXNET_BATCH * N_ALEXNET_STEPS / wall,
        "synced_step_ms": step_ms, "synced_step_split_ms": split,
        "peak_memory_gb": peak,
        "dropout0_copy": {"card_kernel_losses": la, "card_plain_losses": lb,
                          "loss_max_rel_err": loss_err,
                          "param_max_abs_err": param_err},
        "profile": _profile_summary(by_kernel, prof_wall, steps, "step",
                                    top_n=10),
    }


def phase_lenet_training(torch, np):
    """LeNet (BASELINE.json config #1) trained on the card at B=64 on
    seeded random images: no kernel of the port on its path."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import LeNet

    net = LeNet(seed=SEED).init(device="cuda")
    rng = np.random.default_rng(SEED + 10)
    x = rng.random((LENET_BATCH, 784), dtype=np.float32)  # flat 28 x 28 x 1
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, LENET_BATCH)]
    net.fit_batch((x, y))  # warm-up, not counted
    losses, launches, _, wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y)) for _ in range(N_LENET_STEPS)])
    if not all(np.isfinite(losses)):
        fail(f"LeNet training losses not finite: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"LeNet loss on a repeated batch did not fall: {losses}")
    if any(launches.values()):
        fail(f"LeNet launched {launches}; its path runs none of the port's "
             f"kernels")
    steps = 5
    by_kernel, prof_wall = profile_device(
        torch, lambda: net.fit_batch((x, y)), steps)
    return {
        "model": "LeNet(28 x 28 x 1 flat, conv 20-50, dense 500, 10 "
                 "classes), f32, Adam 1e-3",
        "tf32": False, "batch": LENET_BATCH, "params": net.num_params(),
        "steps": N_LENET_STEPS, "losses": losses, "launches": launches,
        "wall_s": wall, "step_wall_ms": 1e3 * wall / N_LENET_STEPS,
        "samples_per_s": LENET_BATCH * N_LENET_STEPS / wall,
        "profile": _profile_summary(by_kernel, prof_wall, steps, "step"),
    }


# --------------------------------------------------------------- GRU slice

N_GRU_STEPS = 10
N_BIDI_GRU_STEPS = 3
N_WIDE_GRU_STEPS = 5   # the GRU(1024) x 2 char-RNN's timed steps
WIDE_GRU_UNITS = 1024
# GRU kernels against their plain versions: f32 |k - p| <= 1e-5 max |p|
# (the sums of h @ R in other orders); bf16 one bf16 step,
# |k - p| <= 2^-7 (1 + |p|) (a stored value rounded to its neighbour)
TOL_GRU_REL = 1e-5
TOL_GRU_BF16 = 2 ** -7
GRU_UNITS = 256
GRU_VOCAB = 77
GRU_TIMESTEPS = 64


def gru_bound(T, B, H, bf16=False, reserve=False):
    """Least time of the GRU forward: xg, R and h0 read once, out and hT
    (and the [4, T, B, H] f32 reserve) written once, at 3.35 TB/s, against
    the 2 T B H 3H flops of h @ R at the peak for the inputs' type plus
    ~12 f32 flops per cell for the gates."""
    e = 2.0 if bf16 else 4.0
    n_in = T * B * 3 * H + H * 3 * H + B * H
    n_out = T * B * H + B * H
    t_bytes = (e * (n_in + n_out)
               + (16.0 * T * B * H if reserve else 0.0)) / HBM_BYTES_PER_S
    t_ops = (2.0 * T * B * H * 3 * H
             / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
             + 12.0 * T * B * H / F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gru_bwd_bound(T, B, H, bf16=False):
    """Least time of the GRU backward walk: the reserve, R^T, h0, out and
    dout read once, dg and dh0 written once, at 3.35 TB/s, against the
    2 T B 3H H flops of [ga_r ga_z r ga_n] @ R^T (every step: step 0's
    gives dh0) at the peak for the inputs' type plus ~15 f32 flops a cell."""
    e = 2.0 if bf16 else 4.0
    t_bytes = (16.0 * T * B * H + e * (3 * H * H + B * H + 2 * T * B * H)
               + 4.0 * (T * B * 3 * H + B * H)) / HBM_BYTES_PER_S
    t_ops = (2.0 * T * B * 3 * H * H
             / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
             + 15.0 * T * B * H / F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_gru(torch, W, R, b, dtype):
    """torch.nn.GRU holding the same layer: the same gate order (r, z, n,
    linear before reset), its input bias b and its recurrent bias zero,
    its weights in ``dtype`` and compacted into cuDNN's one chunk. A
    yardstick only: the port never calls it."""
    F, G = W.shape
    gru = torch.nn.GRU(F, G // 3).to(W.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(W.t())
        gru.weight_hh_l0.copy_(R.t())
        gru.bias_ih_l0.copy_(b)
        gru.bias_hh_l0.zero_()
    gru = gru.to(dtype)
    gru.flatten_parameters()
    return gru


def _gru_within(torch, got, want, dtype):
    """(max abs error, whether within the GRU kernels' stated tolerance)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if dtype == torch.float32:
        ok = err <= TOL_GRU_REL * max(1.0, float(want.abs().max()))
    else:
        ok = bool(((got - want).abs() <= TOL_GRU_BF16 * (1 + want.abs())).all())
    return err, ok and bool(torch.isfinite(got).all())


# the forward design each GRU path's shape must run: the cluster kernel
# (R resident across a thread-block cluster) at every T > 1 shape of the
# main path, the grid kernel (R resident across the card) at T > 1 past
# the width a cluster holds, the stream kernel at decode and past the
# width the grid holds (H = 1200: 1024 forward, 1168 / 1088 backward)
GRU_DESIGNS = {"prefill": "cluster", "train": "cluster",
               "train_bf16": "cluster", "bidi_h200_rev": "cluster",
               "decode": "stream", "decode_train": "stream",
               "h1024": "grid", "h1024_bf16": "grid", "h768": "grid",
               "h640_rev": "grid", "h1200": "stream", "h1200_bf16": "stream"}
# and the backward design at the shapes that run the backward: the stream
# kernel at T = 1 and past the width the grid holds
GRU_BWD_DESIGNS = {"train": "cluster", "train_bf16": "cluster",
                   "bidi_h200_rev": "cluster", "decode_train": "stream",
                   "h1024": "grid", "h1024_bf16": "grid", "h768": "grid",
                   "h640_rev": "grid", "h1200": "stream",
                   "h1200_bf16": "stream"}
# the grid rows' per-step time: their T = 64 time against T = 8's
GRU_STEP_PAIR = (64, 8)


def phase_gru_kernels(torch):
    """The GRU forward kernel (with and without the reserve) and the
    backward kernel against their plain versions at the GRU paths' shapes,
    past the width a cluster holds (H = 1024, 768 and a ragged reversed
    640) and past the width the grid holds (H = 1200), f32 and bf16, and
    the backward at T = 1; times of each kernel, its plain version
    and cuDNN's GRU. Each row names the forward (and the backward) design
    the launcher chose (held against ``fwd_design`` and ``bwd_design``,
    their Python mirrors) and is timed by that design's device function;
    the designs of GRU_DESIGNS and GRU_BWD_DESIGNS are required, and their
    profiles must show that function. A grid row records its plan (units
    a CTA, CTAs and rows a row group, groups), the CTAs the card holds at
    once, and its time a step from the T = 64 / T = 8 pair; at T = 64 its
    kernels must beat their plain versions. Returns (rows, f32 and bf16
    worst)."""
    from deeplearning4j_tpu_torch.ops.cuda.fused_gru import (
        BWD_KERNEL_NAMES, FWD_KERNEL_NAMES, bwd_design,
        card_active_clusters, card_bwd_active_clusters,
        card_bwd_co_resident, card_co_resident, fused_gru_bwd_recurrence,
        fused_gru_layer, fused_gru_recurrence, fwd_design,
        launcher_bwd_design, launcher_design, plain_bwd_recurrence,
        plain_recurrence,
    )
    from deeplearning4j_tpu_torch.ops.cuda.recurrent_cluster import (
        CLUSTER_SMEM_CAP,
    )
    from deeplearning4j_tpu_torch.ops.recurrent import gru_layer, project_gates

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [  # name, B, T, F, H, reverse, reserve + backward, dtype
        ("decode", 8, 1, GRU_VOCAB, 256, False, False, f32),
        ("prefill", 1, 47, GRU_VOCAB, 256, False, False, f32),
        ("train", 64, 64, 256, 256, False, True, f32),
        ("h1024", 64, 64, 256, 1024, False, True, f32),
        ("h768", 64, 64, 256, 768, False, True, f32),
        ("h640_rev", 3, 5, 77, 640, True, True, f32),
        ("ragged_h200_rev", 3, 5, 77, 200, True, True, f32),
        ("decode_train", 8, 1, GRU_VOCAB, 256, False, True, f32),
        ("h1200", 64, 8, 256, 1200, False, True, f32),
        ("bidi_h200_rev", 64, GRU_TIMESTEPS, GRU_VOCAB, 200, True, True,
         f32),
        ("decode_bf16", 8, 1, GRU_VOCAB, 256, False, False, bf16),
        ("prefill_bf16", 1, 47, GRU_VOCAB, 256, False, False, bf16),
        ("train_bf16", 64, 64, 256, 256, False, True, bf16),
        ("h1024_bf16", 64, 64, 256, 1024, False, True, bf16),
        ("ragged_h200_rev_bf16", 3, 5, 77, 200, True, True, bf16),
        ("h1200_bf16", 64, 8, 256, 1200, False, True, bf16),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows, worst = [], {f32: 0.0, bf16: 0.0}
    for name, B, T, F, H, rev, train, dt in shapes:
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=g)
                    * scale).to(dt)
        x, W, R, b = (rnd(B, T, F), rnd(F, 3 * H, scale=F ** -0.5),
                      rnd(H, 3 * H, scale=H ** -0.5), rnd(3 * H, scale=0.1))
        h0, dout = rnd(B, H, scale=0.5), rnd(T, B, H)
        xg = project_gates(x, W, b, reverse=rev)
        out, hT, reserve = fused_gru_recurrence(xg, R, h0,
                                                save_residuals=True)
        k_out, k_hT = fused_gru_recurrence(xg, R, h0)
        dg, dh0 = fused_gru_bwd_recurrence(reserve, R, h0, out, dout)
        torch.cuda.synchronize()
        p_out, p_hT, p_res = plain_recurrence(xg, R, h0, save_residuals=True)
        # the backward is held on the kernel's own reserve and outputs, so
        # that its check does not carry the forward's rounding differences
        p_dg, p_dh0 = plain_bwd_recurrence(reserve, R, h0, out, dout)
        design = launcher_design(T, B, H, dt)
        if fwd_design(T, B, H, dt) != design:
            fail(f"GRU forward at {name}: the launcher chose {design}, its "
                 f"Python mirror {fwd_design(T, B, H, dt)}")
        if GRU_DESIGNS.get(name, design.kind) != design.kind:
            fail(f"GRU forward at {name} runs the {design.kind} design; "
                 f"want {GRU_DESIGNS[name]}")
        fwd_kernel = FWD_KERNEL_NAMES[design.kind]
        row = {"shape": name, "B": B, "T": T, "F": F, "H": H, "reverse": rev,
               "dtype": str(dt).replace("torch.", ""),
               "design": design._asdict(), "fwd_kernel": fwd_kernel}
        if design.kind == "cluster":  # clusters the card holds, 1 CTA an SM
            row["cluster_slots"] = card_active_clusters(dt)(
                design.cluster, 1, CLUSTER_SMEM_CAP)
        if design.kind == "grid":  # the grid CTAs the card holds at once
            row["grid_resident_ctas"] = card_co_resident(dt)(design.rows,
                                                            design.smem)
        if train:
            b_design = launcher_bwd_design(T, B, H, dt)
            if bwd_design(T, B, H, dt) != b_design:
                fail(f"GRU backward at {name}: the launcher chose "
                     f"{b_design}, its Python mirror "
                     f"{bwd_design(T, B, H, dt)}")
            if GRU_BWD_DESIGNS.get(name, b_design.kind) != b_design.kind:
                fail(f"GRU backward at {name} runs the {b_design.kind} "
                     f"design; want {GRU_BWD_DESIGNS[name]}")
            bwd_kernel = BWD_KERNEL_NAMES[b_design.kind]
            row.update(bwd_design=b_design._asdict(), bwd_kernel=bwd_kernel)
            if b_design.kind == "cluster":
                row["bwd_cluster_slots"] = card_bwd_active_clusters(dt)(
                    b_design.cluster, 1, CLUSTER_SMEM_CAP)
            if b_design.kind == "grid":
                row["bwd_grid_resident_ctas"] = card_bwd_co_resident(dt)(
                    b_design.rows, b_design.smem)
        checks = [("out", k_out, p_out), ("hT", k_hT, p_hT),
                  ("out_with_reserve", out, p_out), ("reserve", reserve, p_res),
                  ("dg", dg, p_dg), ("dh0", dh0, p_dh0)]
        for what, got, want in checks:
            err, ok = _gru_within(torch, got, want, dt)
            if not ok or (what in ("out", "hT") and got.dtype != dt):
                fail(f"GRU kernel disagrees with plain at {name}: {what} "
                     f"max_abs_err {err} (dtype {got.dtype})")
            row[f"{what}_max_abs_err"] = err
            worst[dt] = max(worst[dt], err)
        if not torch.equal(k_out, out):
            fail(f"GRU forward at {name}: saving the reserve changed out")

        iters = 200 if T == 1 else 10
        fwd = lambda: fused_gru_recurrence(xg, R, h0)  # noqa: E731
        row["fwd_ms"] = cuda_ms(torch, fwd, iters)
        row["fwd_device_ms"] = kernel_device_ms(torch, fwd, iters,
                                                fwd_kernel)
        row["fwd_plain_ms"] = cuda_ms(
            torch, lambda: plain_recurrence(xg, R, h0), max(3, iters // 10))
        row["fwd_bound_ms"], row["fwd_bound_by"] = gru_bound(T, B, H,
                                                             dt == bf16)
        row["layer_fwd_ms"] = cuda_ms(torch, lambda: fused_gru_layer(
            x, h0, W, R, b, reverse=rev), iters)
        row["layer_fwd_plain_ms"] = cuda_ms(torch, lambda: gru_layer(
            x, h0, W, R, b, reverse=rev), max(3, iters // 10))
        if train:
            fwd_r = lambda: fused_gru_recurrence(  # noqa: E731
                xg, R, h0, save_residuals=True)
            bwd = lambda: fused_gru_bwd_recurrence(  # noqa: E731
                reserve, R, h0, out, dout)
            row["fwd_reserve_ms"] = cuda_ms(torch, fwd_r, iters)
            row["fwd_reserve_device_ms"] = kernel_device_ms(
                torch, fwd_r, iters, fwd_kernel)
            row["fwd_reserve_plain_ms"] = cuda_ms(torch, lambda: (
                plain_recurrence(xg, R, h0, save_residuals=True)), 3)
            row["fwd_reserve_bound_ms"], row["fwd_reserve_bound_by"] = \
                gru_bound(T, B, H, dt == bf16, reserve=True)
            row["bwd_ms"] = cuda_ms(torch, bwd, iters)
            row["bwd_device_ms"] = kernel_device_ms(torch, bwd, iters,
                                                    bwd_kernel)
            row["bwd_plain_ms"] = cuda_ms(torch, lambda: plain_bwd_recurrence(
                reserve, R, h0, out, dout), 3)
            row["bwd_bound_ms"], row["bwd_bound_by"] = gru_bwd_bound(
                T, B, H, dt == bf16)
        if not rev:
            # cuDNN's GRU on the same layer (its input projection included,
            # as in layer_fwd_ms); a sanity line: its error against plain
            gru = cudnn_gru(torch, W.float(), R.float(), b.float(), dt)
            xt = x.transpose(0, 1).contiguous()
            with torch.no_grad():
                lo, _ = gru(xt, h0[None].contiguous())
                ref, _ = gru_layer(x, h0, W, R, b)
            row["library_max_abs_err_vs_plain"] = float(
                (lo.transpose(0, 1).float() - ref.float()).abs().max())
            with torch.no_grad():
                row["library_fwd_ms"] = cuda_ms(
                    torch, lambda: gru(xt, h0[None].contiguous()), iters)
                row["library_fwd_device_ms"] = call_device_ms(
                    torch, lambda: gru(xt, h0[None].contiguous()), iters)
            if train:
                xl = xt.clone().requires_grad_()
                lib_out, lib_h = gru(xl, h0[None].contiguous())
                leaves = [xl] + list(gru.parameters())
                g_lib = (dout, torch.zeros_like(lib_h))
                lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                    (lib_out, lib_h), leaves, g_lib, retain_graph=True)
                row["library_bwd_ms"] = cuda_ms(torch, lib_bwd, iters)
                row["library_bwd_device_ms"] = call_device_ms(
                    torch, lib_bwd, iters)
        # the designs GRU_DESIGNS requires are shown by the device's own
        # record (their windows run 10 calls or more; the profiler can drop
        # the records of a window much shorter than a millisecond)
        if name in GRU_DESIGNS and (row["fwd_device_ms"] is None or (
                train and row["fwd_reserve_device_ms"] is None)):
            fail(f"GRU forward at {name}: the profile shows no "
                 f"{fwd_kernel}, the {design.kind} design's kernel")
        if name in GRU_BWD_DESIGNS and row["bwd_device_ms"] is None:
            fail(f"GRU backward at {name}: the profile shows no "
                 f"{bwd_kernel}, the {b_design.kind} design's kernel")
        if design.kind == "grid" and T == GRU_STEP_PAIR[0]:
            row["grid_step"] = gru_grid_step(torch, row, xg, R, h0, dout,
                                             fwd_kernel, bwd_kernel)
            for k in ("fwd", "bwd"):
                if not row[f"{k}_device_ms"] < row[f"{k}_plain_ms"]:
                    fail(f"GRU grid {k} at {name}: {row[f'{k}_device_ms']} "
                         f"ms on the device, its plain version "
                         f"{row[f'{k}_plain_ms']} ms")
        rows.append(row)
    # the launches above were for checks and timing: not the main path's
    return rows, worst[f32], worst[bf16]


#: the grid kernels' instances by element type, as mangled device names
#: hold them (``cuobjdump -sass``)
GRU_GRID_INSTANCES = {"bfloat16": "grid_kernelI13__nv_bfloat16",
                      "float32": "grid_kernelIf"}


def gru_grid_tensor_cores():
    """The bf16 grid kernels' step products run on the tensor cores: their
    machine code holds HMMA (mma.sync) instructions, the f32 instances'
    none. Returns the counts by kernel and type."""
    from deeplearning4j_tpu_torch.ops.cuda.build import tensor_core_ops
    from deeplearning4j_tpu_torch.ops.cuda.fused_gru import (
        FUSED_GRU, FUSED_GRU_BWD,
    )

    out = {}
    for kern, stem in ((FUSED_GRU, "gru_fwd_"), (FUSED_GRU_BWD, "gru_bwd_")):
        for dt, inst in GRU_GRID_INSTANCES.items():
            ops = tensor_core_ops(kern.library, stem + inst)
            out[f"{stem}grid_kernel_{dt}"] = ops
            if (ops["HMMA"] == 0) == (dt == "bfloat16"):
                fail(f"{stem}grid_kernel ({dt}) holds {ops['HMMA']} HMMA; "
                     f"want some in bf16 and none in f32")
    return out


def gru_grid_step(torch, row, xg, R, h0, dout, fwd_kernel, bwd_kernel):
    """A grid row's time a step: its device time at T = 64 against the
    same call cut to its first 8 steps, the difference over the 56 steps
    between (the launch, the resident R's load and the set-up cancel)."""
    from deeplearning4j_tpu_torch.ops.cuda.fused_gru import (
        fused_gru_bwd_recurrence, fused_gru_recurrence,
    )

    T, t = GRU_STEP_PAIR
    xs, ds = xg[:t], dout[:t]
    out, _, res = fused_gru_recurrence(xs, R, h0, save_residuals=True)
    fwd_t = kernel_device_ms(torch, lambda: fused_gru_recurrence(xs, R, h0),
                             20, fwd_kernel)
    bwd_t = kernel_device_ms(torch, lambda: fused_gru_bwd_recurrence(
        res, R, h0, out, ds), 20, bwd_kernel)
    if fwd_t is None or bwd_t is None:
        fail(f"GRU grid at {row['shape']}: the profile shows no kernel at "
             f"T = {t}")
    return {f"fwd_T{t}_device_ms": fwd_t, f"bwd_T{t}_device_ms": bwd_t,
            "fwd_us_per_step": 1e3 * (row["fwd_device_ms"] - fwd_t) / (T - t),
            "bwd_us_per_step": 1e3 * (row["bwd_device_ms"] - bwd_t) / (T - t)}


def gru_charrnn_conf(bidi=False, units=GRU_UNITS):
    """The GRU char-RNN: TextGenerationLSTM's topology with both LSTM
    layers replaced by GRULayer(``units``, 256 unless widened) (RnnOutput
    77 softmax mcxent, one-hot input, T=64, RMSProp 1e-3, clipping 5.0);
    with ``bidi``,
    Bidirectional(GRULayer(200)) x 2 with Adam 1e-3 (config #3's shape with
    GRU cells). The JAX package has no zoo class for it; it crosses
    between the packages as this configuration's JSON."""
    from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BidirectionalLayer, GRULayer, RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.optimize.updaters import Adam, RMSProp

    b = (NeuralNetConfiguration.builder().seed(SEED)
         .updater(Adam(lr=1e-3) if bidi else RMSProp(lr=1e-3))
         .gradient_clipping(5.0).list())
    for _ in range(2):
        b = b.layer(BidirectionalLayer(fwd=GRULayer(n_out=200)) if bidi
                    else GRULayer(n_out=units))
    return (b.layer(RnnOutputLayer(n_out=GRU_VOCAB, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.recurrent(GRU_VOCAB, GRU_TIMESTEPS))
            .build())


def phase_gru_serving(torch, np):
    """Serve the GRU char-RNN through GenerationEngine(slots=8,
    max_len=256) with phase 4's 16-request mix: exactly 2 GRU forward
    launches a decode step and a prefill, no other kernel; decode logits
    against the kernel-disabled plain path on the card."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    net = MultiLayerNetwork(gru_charrnn_conf()).init(device="cuda")
    vocab = GRU_VOCAB
    eng = GenerationEngine(net, slots=8, max_len=256, device="cuda")
    eng.generate([1, 2, 3, 4], max_new_tokens=2)  # warm-up, not counted

    rng = np.random.default_rng(SEED)  # phase 4's request mix
    lens = rng.integers(4, 49, N_REQUESTS)
    news = rng.integers(8, 65, N_REQUESTS)
    reqs = [dict(prompt=rng.integers(0, vocab, int(n)).tolist(),
                 max_new_tokens=int(m),
                 **({} if i % 2 == 0 else
                    dict(temperature=0.8, top_k=40, seed=1000 + i)))
            for i, (n, m) in enumerate(zip(lens, news))]
    steps0 = eng.steps_run

    def serve():
        out = [eng.submit(r.pop("prompt"), **r) for r in
               [dict(q) for q in reqs]]
        eng.drain()
        return out

    streams, launches, reserves, wall = _count_launches(torch, KERNELS, serve)
    decode_steps = eng.steps_run - steps0
    n_prefill = sum(1 for r in reqs if len(r["prompt"]) > 1)
    want = _only(KERNELS, fused_gru_fwd=2 * decode_steps + 2 * n_prefill)
    if launches != want or any(reserves.values()):
        fail(f"GRU serving launched {launches} ({reserves} with reserve) in "
             f"{decode_steps} decode steps and {n_prefill} prefills; want "
             f"{want} and no reserve")
    for i, (s, r) in enumerate(zip(streams, reqs)):
        if s.finish_reason != "length" or len(s.tokens) != r["max_new_tokens"]:
            fail(f"GRU request {i} finished {s.finish_reason} with "
                 f"{len(s.tokens)}/{r['max_new_tokens']} tokens")
        if not all(0 <= t < vocab for t in s.tokens):
            fail(f"GRU request {i} emitted a token outside the vocabulary")

    # the first decode steps of a full pool, kernel vs kernel-disabled plain
    # path on the card, from the same carries and tokens
    greedy = [(r, s) for r, s in zip(reqs, streams) if "temperature" not in r]
    n_check = 8
    toks = torch.as_tensor([[s.tokens[j % len(s.tokens)]
                             for _, s in greedy[:8]] for j in range(n_check)],
                           device="cuda")
    worst, logit_max = 0.0, 0.0
    carries = {False: eng.adapter.init_state(8), True: eng.adapter.init_state(8)}
    for j in range(n_check):
        logits = {}
        for disable in (False, True):
            env.disable_kernels = disable
            try:
                logits[disable], carries[disable] = eng.adapter.decode(
                    carries[disable], toks[j])
            finally:
                env.reload()
        err = float((logits[False] - logits[True]).abs().max())
        worst = max(worst, err)
        logit_max = max(logit_max, float(logits[True].abs().max()))
        if not bool(torch.isfinite(logits[False]).all()) or err > TOL:
            fail(f"GRU decode step {j} logits, kernel vs plain on the card: "
                 f"{err} > {TOL}")
    # greedy streams, teacher-forced on the plain path on the card
    for r, s in greedy:
        seq = list(r["prompt"]) + s.tokens
        x = torch.nn.functional.one_hot(
            torch.as_tensor([seq[:-1]], device="cuda"), vocab).float()
        env.disable_kernels = True
        try:
            with torch.no_grad():
                pre, _, _ = net._forward_carry(net.params, net.state, x,
                                               net._init_carries(1))
        finally:
            env.reload()
        lg = pre[0, len(r["prompt"]) - 1:]
        top2 = lg.topk(2, dim=-1).values
        if lg.argmax(-1).tolist() != s.tokens and \
                float((top2[:, 0] - top2[:, 1]).min()) > TOL:
            fail("GRU greedy tokens differ from the teacher-forced argmax")

    n_tokens = sum(len(s.tokens) for s in streams)
    ttft = sorted(s.first_token_at - s.submitted_at for s in streams)
    return {
        "model": "GRU char-RNN (GRULayer(256) x 2, vocab 77; "
                 "TextGenerationLSTM's topology with GRU cells)",
        "slots": 8, "max_len": 256, "requests": N_REQUESTS,
        "tokens": n_tokens, "decode_steps": decode_steps,
        "prefills": n_prefill, "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "launches": launches,
        "launches_per_decode_step": (launches["fused_gru_fwd"]
                                     - 2 * n_prefill) / decode_steps,
        "decode_logits_max_abs_err_kernel_vs_plain": worst,
        "decode_logit_max_abs": logit_max,
        "decode_profile": profile_decode(torch, eng, reqs),
    }


def phase_gru_training(torch, np, bidi=False, units=GRU_UNITS):
    """Train the GRU char-RNN (GRULayer(``units``) x 2; or the
    Bidirectional(GRU(200)) x 2 net) on the card at B=64, T=64: 2 steps
    against a copy on the kernel-disabled plain path, then timed steps
    that must launch exactly 2 forwards (with reserve) and 2 backwards a
    step per GRU direction; losses fall. A profiled window names the
    designs the launchers chose and must show each kernel of the design
    the width takes (cluster to H = 512, grid past it), one launch a GRU
    direction a step."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.ops.cuda.fused_gru import (
        BWD_KERNEL_NAMES, FWD_KERNEL_NAMES, launcher_bwd_design,
        launcher_design,
    )

    net = MultiLayerNetwork(gru_charrnn_conf(bidi, units)).init(
        device="cuda")
    plain = copy.deepcopy(net)
    B, T = 64, GRU_TIMESTEPS
    x, y = _char_batch(np, np.random.default_rng(SEED + 12), GRU_VOCAB, B, T)
    card = [net.fit_batch((x, y)) for _ in range(2)]  # also the warm-up
    env.disable_kernels = True
    try:
        ref = [plain.fit_batch((x, y)) for _ in range(2)]
    finally:
        env.reload()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card, ref))
    param_err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(net.params), tree_leaves(plain.params)))
    name = ("Bidirectional(GRU(200)) x 2" if bidi else "GRU char-RNN"
            if units == GRU_UNITS else f"GRU({units}) x 2 char-RNN")
    if loss_err > TOL_TRAIN_LOSS or param_err > TOL_TRAIN_PARAM:
        fail(f"{name}, 2 steps, kernels vs plain on the card: loss rel err "
             f"{loss_err} (tol {TOL_TRAIN_LOSS}), param abs err {param_err} "
             f"(tol {TOL_TRAIN_PARAM})")
    del plain

    n = 4 if bidi else 2   # GRU directions in the net
    steps = (N_BIDI_GRU_STEPS if bidi else N_GRU_STEPS
             if units == GRU_UNITS else N_WIDE_GRU_STEPS)
    losses, launches, reserves, wall = _count_launches(
        torch, KERNELS, lambda: [net.fit_batch((x, y)) for _ in range(steps)])
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{name} losses on a repeated batch did not fall: {losses}")
    want = n * steps
    if (launches != _only(KERNELS, fused_gru_fwd=want, fused_gru_bwd=want)
            or reserves != _reserves_only(KERNELS, fused_gru_fwd=want)):
        fail(f"{name}: {steps} steps launched {launches} ({reserves} with "
             f"reserve); want {n} GRU forwards with reserve and {n} "
             f"backwards a step, nothing else")
    out = {
        "model": (name + (", Adam 1e-3" if bidi else ", RMSProp 1e-3")
                  + ", clipping 5.0, vocab 77"),
        "batch": B, "timesteps": T, "params": net.num_params(),
        "plain_copy": {"card_kernel_losses": card, "card_plain_losses": ref,
                       "loss_max_rel_err": loss_err,
                       "param_max_abs_err": param_err},
        "steps": steps, "losses": losses, "launches": launches,
        "reserve_launches": reserves["fused_gru_fwd"],
        "launches_per_step": {k: v / steps for k, v in launches.items() if v},
        "wall_s": wall, "step_wall_ms": 1e3 * wall / steps,
        "samples_per_s": B * steps / wall,
    }
    # the designs the launchers chose at the net's shape, and a profiled
    # window that shows each design's kernel, n launches a step
    H = 200 if bidi else units
    want = "cluster" if H <= 512 else "grid"
    designs = {"fwd": launcher_design(T, B, H, torch.float32),
               "bwd": launcher_bwd_design(T, B, H, torch.float32)}
    names = {"fwd": FWD_KERNEL_NAMES[designs["fwd"].kind],
             "bwd": BWD_KERNEL_NAMES[designs["bwd"].kind]}
    out["designs"] = {k: d._asdict() for k, d in designs.items()}
    n_prof = 3 if bidi else 5
    by_kernel, prof_wall, seen = profile_showing(
        torch, lambda: net.fit_batch((x, y)), n_prof,
        {kname: n for kname in names.values()})
    for k, kname in names.items():
        if designs[k].kind != want or seen[kname] != n * n_prof:
            fail(f"{name}: {n_prof} profiled steps show {seen[kname]} "
                 f"launches of {kname} ({designs[k].kind} design); want {n} "
                 f"a step of the {want} design")
    out["profile"] = _profile_summary(by_kernel, prof_wall, n_prof, "step")
    if not bidi:
        out["synced_step_ms"] = host_ms(torch, lambda: net.fit_batch((x, y)),
                                        5)
    return out


def _grid_shapes(rows, kind, sass):
    """The grid rows at H = 1024 for the kernels line: the forward (``kind``
    "fwd", with and without the reserve) or the backward, f32 and bf16,
    with their plans, times a step and tensor-core instruction counts."""
    out = []
    for r in rows:
        if r["shape"] not in ("h1024", "h1024_bf16"):
            continue
        d = r["design"] if kind == "fwd" else r["bwd_design"]
        e = {"shape": f"[B=64, T=64, H=1024] {r['dtype']}", "design": d,
             "ms": r[f"{kind}_ms"], "device_ms": r[f"{kind}_device_ms"],
             "plain_ms": r[f"{kind}_plain_ms"],
             "bound_ms": r[f"{kind}_bound_ms"],
             "bound_by": r[f"{kind}_bound_by"],
             "library_ms": r[f"library_{kind}_ms"],
             "library_device_ms": r[f"library_{kind}_device_ms"],
             "us_per_step": r["grid_step"][f"{kind}_us_per_step"],
             "tensor_core_ops": sass[f"gru_{kind}_grid_kernel_{r['dtype']}"]}
        if kind == "fwd":
            e.update(reserve_ms=r["fwd_reserve_ms"],
                     reserve_device_ms=r["fwd_reserve_device_ms"],
                     reserve_plain_ms=r["fwd_reserve_plain_ms"],
                     reserve_bound_ms=r["fwd_reserve_bound_ms"])
        out.append(e)
    return out


def gru_kernel_entries(by_name, rows, worst, worst_bf16, serve, train, wide,
                       bidi, sass):
    """The kernels line's two GRU entries. The kernels at the GRU char-RNN's
    shapes, f32: the forward at decode [8, 1, 256] (the serving path), with
    its training shape beside it; the backward at the training shape
    [64, 64, 256]. Beside them the grid design at [64, 64, 1024] (the
    GRU(1024) x 2 char-RNN's shape)."""
    g_dec, g_train = rows[0], rows[2]
    gfwd, gbwd = by_name["fused_gru_fwd"], by_name["fused_gru_bwd"]
    gs, gt, gw, gb = (p["launches"] for p in (serve, train, wide, bidi))
    return [{
        "name": gfwd.name, "route": "cuda", "source": gfwd.source,
        "replaces": gfwd.replaces,
        "launches": (gs[gfwd.name] + gt[gfwd.name] + gw[gfwd.name]
                     + gb[gfwd.name]),
        "launches_by_path": {"gru_serving": gs[gfwd.name],
                             "gru_training": gt[gfwd.name],
                             "gru1024_training": gw[gfwd.name],
                             "bidi_gru_training": gb[gfwd.name]},
        "max_abs_err": worst, "max_abs_err_bf16": worst_bf16,
        "ms": g_dec["fwd_ms"], "device_ms": g_dec["fwd_device_ms"],
        "plain_ms": g_dec["fwd_plain_ms"], "bound_ms": g_dec["fwd_bound_ms"],
        "bound_by": g_dec["fwd_bound_by"],
        # cuDNN's GRU computes the whole layer, its input projection too
        "library_ms": g_dec["library_fwd_ms"],
        "library_device_ms": g_dec["library_fwd_device_ms"],
        "shape": "decode [B=8, T=1, H=256] f32",
        "design": g_dec["design"]["kind"],
        "training_shape": {
            "shape": "[B=64, T=64, H=256] f32, with reserve",
            "design": g_train["design"]["kind"],
            "ms": g_train["fwd_reserve_ms"],
            "device_ms": g_train["fwd_reserve_device_ms"],
            "plain_ms": g_train["fwd_reserve_plain_ms"],
            "bound_ms": g_train["fwd_reserve_bound_ms"],
            "bound_by": g_train["fwd_reserve_bound_by"],
            "library_ms": g_train["library_fwd_ms"],
            "library_device_ms": g_train["library_fwd_device_ms"]},
        "grid_shapes": _grid_shapes(rows, "fwd", sass),
    }, {
        "name": gbwd.name, "route": "cuda", "source": gbwd.source,
        "replaces": gbwd.replaces,
        "launches": (gs[gbwd.name] + gt[gbwd.name] + gw[gbwd.name]
                     + gb[gbwd.name]),
        "launches_by_path": {"gru_serving": gs[gbwd.name],
                             "gru_training": gt[gbwd.name],
                             "gru1024_training": gw[gbwd.name],
                             "bidi_gru_training": gb[gbwd.name]},
        "max_abs_err": worst, "max_abs_err_bf16": worst_bf16,
        "ms": g_train["bwd_ms"], "device_ms": g_train["bwd_device_ms"],
        "plain_ms": g_train["bwd_plain_ms"],
        "bound_ms": g_train["bwd_bound_ms"],
        "bound_by": g_train["bwd_bound_by"],
        # cuDNN's GRU autograd backward (its weight gradients included)
        "library_ms": g_train["library_bwd_ms"],
        "library_device_ms": g_train["library_bwd_device_ms"],
        "shape": "[B=64, T=64, H=256] f32",
        "design": g_train["bwd_design"]["kind"],
        "grid_shapes": _grid_shapes(rows, "bwd", sass),
    }]


def main() -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deeplearning4j_tpu_torch")):
        fail("deeplearning4j_tpu_torch/ is not beside this script; run it "
             "from the root of a checkout")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs the card")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build, one nvcc per source, all started together
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda k: k.library.load(), KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    for k in KERNELS:
        print(f"build {k.name}: {k.library.build_seconds:.2f} s", flush=True)
        print(k.library.build_log.strip(), flush=True)

    # phase 3: forward kernel against plain
    rows, worst, worst_bf16 = phase_kernels(torch)
    print(json.dumps({"kernel_shapes": rows}), flush=True)

    # phase 4: serving main path
    main_path = phase_main_path(torch, np)
    print(json.dumps({"main_path": main_path, "card": card}), flush=True)
    print(f"main path on {card}: {main_path['tokens_per_s']:.1f} tokens/s, "
          f"TTFT p50 {main_path['ttft_p50_ms']:.2f} ms", flush=True)

    # phase 5: the bf16 net
    print(json.dumps({"bf16_net": phase_bf16_net(torch, np)}), flush=True)

    # phase 6: backward kernel against plain
    bwd_rows, bwd_worst, bwd_worst_bf16 = phase_bwd_kernels(torch)
    print(json.dumps({"bwd_kernel_shapes": bwd_rows}), flush=True)

    # phase 7: training main path
    train = phase_training(torch, np)
    print(json.dumps({"training": train, "card": card}), flush=True)
    print(f"training on {card}: {train['step_wall_ms']:.2f} ms a step, "
          f"{train['samples_per_s']:.1f} samples/s", flush=True)

    # phase 8: TextGenerationLSTM and bf16 char-RNN training
    from deeplearning4j_tpu_torch.zoo import (
        BidirectionalGravesLSTMCharRnn, TextGenerationLSTM,
    )

    short = [phase_short_training(torch, np, TextGenerationLSTM(seed=SEED), 2),
             phase_short_training(torch, np, BidirectionalGravesLSTMCharRnn(
                 seed=SEED, dtype="bf16"), 4)]
    print(json.dumps({"short_training": short}), flush=True)

    # phase 9: flash kernels against plain, the bf16 ones on tensor cores
    tensor_cores = flash_tensor_cores(torch)
    print(json.dumps({"flash_tensor_cores": tensor_cores}), flush=True)
    print("tensor-core instructions: " + ", ".join(
        f"{k} {v}" for k, v in tensor_cores["sass"].items()), flush=True)
    flash_rows, flash_times, flash_grad_rel, flash_worst, flash_worst_bf16 = \
        phase_flash_kernels(torch)
    print(json.dumps({"flash_kernel_shapes": flash_rows,
                      "flash_function_grad_max_rel_err": flash_grad_rel,
                      "flash_times": flash_times, "card": card}), flush=True)

    # phase 10: BERT-base inference
    bert_out, bert_net = phase_bert_inference(torch, np)
    print(json.dumps({"bert_inference": bert_out, "card": card}), flush=True)
    print(f"BERT-base output() on {card}: "
          f"{bert_out['wall_ms_per_call']:.2f} ms a call of 32 x 128, "
          f"device busy {bert_out['profile']['device_busy_share']}",
          flush=True)

    # phase 11: BERT-base fine-tuning
    bert_train = phase_bert_training(torch, np, bert_net)
    del bert_net
    print(json.dumps({"bert_training": bert_train, "card": card}), flush=True)
    print(f"BERT-base fine-tuning on {card}: "
          f"{bert_train['step_wall_ms']:.2f} ms a step, "
          f"{bert_train['samples_per_s']:.1f} samples/s", flush=True)

    # phase 12: LRN kernels against plain
    lrn_rows, lrn_times, lrn_grad_rel, lrn_worst, lrn_worst_bf16 = \
        phase_lrn_kernels(torch)
    print(json.dumps({"lrn_kernel_shapes": lrn_rows,
                      "lrn_function_grad_max_rel_err": lrn_grad_rel,
                      "lrn_times": lrn_times, "card": card}), flush=True)

    # phase 13: AlexNet inference
    alex_out, alex_net = phase_alexnet_inference(torch, np)
    print(json.dumps({"alexnet_inference": alex_out, "card": card}),
          flush=True)
    print(f"AlexNet output() on {card}: {alex_out['wall_ms_per_call']:.2f} "
          f"ms a call of {ALEXNET_BATCH} images, device busy "
          f"{alex_out['profile']['device_busy_share']}", flush=True)

    # phase 14: AlexNet training
    alex_train = phase_alexnet_training(torch, np, alex_net)
    del alex_net
    print(json.dumps({"alexnet_training": alex_train, "card": card}),
          flush=True)
    print(f"AlexNet training on {card}: {alex_train['step_wall_ms']:.2f} ms "
          f"a step, {alex_train['samples_per_s']:.1f} samples/s", flush=True)

    # phase 15: LeNet training
    lenet = phase_lenet_training(torch, np)
    print(json.dumps({"lenet_training": lenet, "card": card}), flush=True)
    print(f"LeNet training on {card}: {lenet['step_wall_ms']:.2f} ms a "
          f"step, {lenet['samples_per_s']:.1f} samples/s", flush=True)

    # phase 16: GRU kernels against plain, the bf16 grid products on the
    # tensor cores
    gru_sass = gru_grid_tensor_cores()
    print(json.dumps({"gru_grid_tensor_cores": gru_sass}), flush=True)
    gru_rows, gru_worst, gru_worst_bf16 = phase_gru_kernels(torch)
    print(json.dumps({"gru_kernel_shapes": gru_rows, "card": card}),
          flush=True)

    # phase 17: GRU char-RNN serving
    gru_serve = phase_gru_serving(torch, np)
    print(json.dumps({"gru_serving": gru_serve, "card": card}), flush=True)
    print(f"GRU char-RNN serving on {card}: "
          f"{gru_serve['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{gru_serve['ttft_p50_ms']:.2f} ms, device busy "
          f"{gru_serve['decode_profile']['device_busy_share']}", flush=True)

    # phase 18: GRU char-RNN training, GRULayer(256) x 2 (the cluster
    # kernels) and GRULayer(1024) x 2 (the grid kernels)
    gru_train = phase_gru_training(torch, np)
    print(json.dumps({"gru_training": gru_train, "card": card}), flush=True)
    wide_gru = phase_gru_training(torch, np, units=WIDE_GRU_UNITS)
    print(json.dumps({"gru1024_training": wide_gru, "card": card}),
          flush=True)
    for what, run in (("GRU char-RNN", gru_train),
                      ("GRU(1024) x 2 char-RNN", wide_gru)):
        print(f"{what} training on {card}: {run['step_wall_ms']:.2f} ms a "
              f"step, {run['samples_per_s']:.1f} samples/s, device "
              f"{run['profile']['device_ms_per_step']:.3f} ms a step, busy "
              f"{run['profile']['device_busy_share']}", flush=True)

    # phase 19: Bidirectional(GRU(200)) x 2 training
    bidi_gru = phase_gru_training(torch, np, bidi=True)
    print(json.dumps({"bidi_gru_training": bidi_gru, "card": card}),
          flush=True)

    # phase 20: kernels line, card line, result line
    decode = rows[0]  # the serving path's decode shape [8, 1, 256]
    graves = bwd_rows[0]  # the training path's first layer [64, 64, 200]
    # TextGenerationLSTM's second layer [64, 64, 256], no peepholes: where
    # cuDNN's LSTM computes the same function at T > 1
    textgen = next(r for r in bwd_rows if r["shape"] == "textgen_layer2")
    by_name = {k.name: k for k in KERNELS}
    fwd, bwd = by_name["fused_lstm_fwd"], by_name["fused_lstm_bwd"]
    ffwd, fdq, fdkv = (by_name[f"flash_attention_{n}"]
                       for n in ("fwd", "dq", "dkv"))
    lfwd, lbwd = by_name["lrn_fwd"], by_name["lrn_bwd"]
    serve_n = main_path["launches"][fwd.name]
    train_n = train["launches"]
    entries = [{
        "name": fwd.name, "route": "cuda", "source": fwd.source,
        "replaces": fwd.replaces,
        "launches": serve_n + train_n[fwd.name],
        "launches_by_path": {"serving": serve_n,
                             "training": train_n[fwd.name]},
        "max_abs_err": worst, "max_abs_err_bf16": worst_bf16,
        "ms": decode["kernel_ms"], "kernel_ms": decode["kernel_ms"],
        "device_ms": decode["kernel_device_ms"],
        "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"], "library_ms": decode["library_ms"],
        "library_device_ms": decode["library_device_ms"],
        "shape": "decode [B=8, T=1, H=256]",
        "design": decode["design"]["kind"],
        "training_shape": {
            "shape": "[B=64, T=64, H=200], peephole, reverse, with reserve",
            "design": graves["fwd_design"]["kind"],
            "ms": graves["fwd_reserve_kernel_ms"],
            "device_ms": graves["fwd_reserve_device_ms"],
            "plain_ms": graves["fwd_reserve_plain_ms"],
            "bound_ms": graves["fwd_reserve_bound_ms"],
            "bound_by": graves["fwd_reserve_bound_by"], "library_ms": None,
            "library_device_ms": None},  # no library LSTM has peepholes
        "library_shape": {
            "shape": "[B=64, T=64, H=256] f32, no peepholes, with reserve",
            "design": textgen["fwd_design"]["kind"],
            "device_ms": textgen["fwd_reserve_device_ms"],
            "bound_ms": textgen["fwd_reserve_bound_ms"],
            # cuDNN's forward in training mode, its projection included
            "library_device_ms": textgen["library_fwd_device_ms"]},
    }, {
        "name": bwd.name, "route": "cuda", "source": bwd.source,
        "replaces": bwd.replaces, "launches": train_n[bwd.name],
        "launches_by_path": {"serving": main_path["launches"][bwd.name],
                             "training": train_n[bwd.name]},
        "max_abs_err": bwd_worst, "max_abs_err_bf16": bwd_worst_bf16,
        "ms": graves["kernel_ms"], "kernel_ms": graves["kernel_ms"],
        "device_ms": graves["kernel_device_ms"],
        "plain_ms": graves["plain_ms"], "bound_ms": graves["bound_ms"],
        "bound_by": graves["bound_by"],
        # no library LSTM has peepholes; cuDNN's forward + backward on the
        # no-peephole layers is in library_shape and bwd_kernel_shapes
        "library_ms": None, "library_device_ms": None,
        "shape": "[B=64, T=64, H=200], peephole, reverse",
        "design": graves["bwd_design"]["kind"],
        "library_shape": {
            "shape": "[B=64, T=64, H=256] f32, no peepholes",
            "design": textgen["bwd_design"]["kind"],
            "device_ms": textgen["kernel_device_ms"],
            "bound_ms": textgen["bound_ms"],
            # the kernel pair with the wrapper's projection and gradient
            # GEMMs, against cuDNN's forward + autograd backward, on the
            # device clock and on CUDA events
            "layer_pair_device_ms": textgen["layer_pair_device_ms"],
            "library_pair_device_ms": textgen["library_pair_device_ms"],
            "layer_pair_ms": textgen["layer_pair_ms"],
            "library_pair_ms": textgen["library_pair_ms"]},
    }]
    # the flash kernels at the BERT main path's shape and type (bf16, key
    # padding); the f32 times are in flash_times
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        DKV_KERNEL_NAMES, DQ_KERNEL_NAMES, FWD_KERNEL_NAMES,
    )

    ft = flash_times["bfloat16"]
    infer_n, bert_n = bert_out["launches"], bert_train["launches"]
    for kern, kind, plain_key, library, design in (
            (ffwd, "fwd", "fwd_plain_ms", ft["library_fwd_ms"],
             "wgmma (tensor cores), cp.async ring"),
            # no one library call computes dq or dk/dv alone: SDPA's
            # backward computes both, in library_bwd_ms
            (fdq, "dq", "bwd_plain_ms", None,
             "wgmma (tensor cores), cp.async ring"),
            (fdkv, "dkv", "bwd_plain_ms", None,
             "wgmma (tensor cores), cp.async ring")):
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": infer_n[kern.name] + bert_n[kern.name],
            "launches_by_path": {"bert_inference": infer_n[kern.name],
                                 "bert_training": bert_n[kern.name]},
            "max_abs_err": flash_worst, "max_abs_err_bf16": flash_worst_bf16,
            "ms": ft[f"{kind}_ms"], "device_ms": ft[f"{kind}_device_ms"],
            "plain_ms": ft[plain_key], "bound_ms": ft[f"{kind}_bound_ms"],
            "bound_by": ft[f"{kind}_bound_by"], "library_ms": library,
            "library_device_ms": (ft["library_fwd_device_ms"]
                                  if kind == "fwd" else None),
            "library_bwd_ms": ft["library_bwd_ms"],
            "library_bwd_device_ms": ft["library_bwd_device_ms"],
            "design": design,
            "tensor_core_ops": tensor_cores["sass"][
                {"fwd": FWD_KERNEL_NAMES, "dq": DQ_KERNEL_NAMES,
                 "dkv": DKV_KERNEL_NAMES}[kind][torch.bfloat16]],
            "shape": "[32, 12, 128, 64] bf16, key-padding mask",
        })
    # the LRN kernels at AlexNet's conv1 LRN shape, f32 (the main path's
    # type); conv2's and the bf16 times are in lrn_times
    lt = lrn_times["alexnet_conv1_float32"]
    infer_n, train_n = alex_out["launches"], alex_train["launches"]
    for kern, kind in ((lfwd, "fwd"), (lbwd, "bwd")):
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": infer_n[kern.name] + train_n[kern.name],
            "launches_by_path": {"alexnet_inference": infer_n[kern.name],
                                 "alexnet_training": train_n[kern.name],
                                 "lenet_training": lenet["launches"][
                                     kern.name]},
            "max_abs_err": lrn_worst, "max_abs_err_bf16": lrn_worst_bf16,
            "ms": lt[f"{kind}_ms"], "device_ms": lt[f"{kind}_device_ms"],
            "plain_ms": lt[f"{kind}_plain_ms"],
            "bound_ms": lt[f"{kind}_bound_ms"],
            "bound_by": lt[f"{kind}_bound_by"],
            "library_ms": lt[f"library_{kind}_ms"],
            "library_device_ms": lt[f"library_{kind}_device_ms"],
            "shape": f"[{ALEXNET_BATCH}, 54, 54, 96] f32, depth 5",
        })
    entries += gru_kernel_entries(by_name, gru_rows, gru_worst,
                                  gru_worst_bf16, gru_serve, gru_train,
                                  wide_gru, bidi_gru, gru_sass)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
