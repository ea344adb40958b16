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
   sampled, drained to completion, twice: a timed run (tokens/s, TTFT),
   then the counted run, with every count zeroed just before and read
   just after. The engine replays one captured CUDA graph for every decode
   step, and the wrappers count launches on the host, where a replay calls
   none; so the counted run goes under torch.profiler, and a kernel's
   launches are the profiler's records of its device functions there.
   They must equal the host's account (the prefills' counted launches plus
   ``capture_launches`` times the replays; a run whose records fall short
   is run again, three times at most) and be exactly 2 a decode step and
   2 a prefill.
   Greedy streams are held against the port's plain path on the CPU,
   teacher-forced, on the same weights. A steady window of decode steps is
   profiled (the profiler must name the decode kernel twice a replay) and
   its host time split into a replay, the same step run eagerly and the
   sampler.
5. bf16 net: the same model with ``dtype="bf16"`` generates on the card;
   every decode step must replay the graph and launch the kernel twice
   (counted on the device as in phase 4),
   every prefill twice (the carries start in f32, as in the JAX package,
   so the recurrence runs the f32 kernel over the bf16 weights), and its
   teacher-forced logits are held against the plain path on the card.
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
    depth, in f32 and bf16; each row names the forward's design (16-byte
    vector or element path, rows a block, threads a row) that its
    launcher chose, which must be ``lrn.fwd_design``'s; ``LRNFunction``'s
    gradient against autograd through the plain lowering on the card;
    times of each kernel, its plain version, its bound and, as a
    yardstick the port never calls,
    ``torch.nn.functional.local_response_norm`` (forward, and its autograd
    backward) at AlexNet's shapes, on CUDA events and as the device time of
    its kernels, and both kernels' element-by-element paths there (data
    one element past a 16-byte boundary; the forward held against its
    plain version on that copy too).
13. AlexNet inference: ``AlexNet()`` at its published width (224 x 224 x
    3, conv 96-256-384-384-256, two LRN layers, dense 4096-4096, 1000
    classes, f32, random weights from the seed) runs ``output()`` on 128
    random images: 2 LRN forward launches a call and no backward; its
    logits agree with the plain path on the card; a call is profiled
    (the LRN forward's device time a call among them).
14. AlexNet training: ``fit_batch`` at B=128, Nesterovs 1e-2 momentum
    0.9, dropout 0.5, on a repeated batch, each step launching 2 LRN
    forward and 2 LRN backward kernels, losses finite and falling; a
    steady window is profiled (the LRN kernels' device time a step among
    them). A dropout-0 copy trains 2 steps against the plain path on the
    card, both from the seed's untrained weights.
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
    exactly 2 GRU forward launches a decode step (a graph replay, counted
    on the device as in phase 4) and a prefill and no other kernel; decode-step logits
    against the kernel-disabled plain path on the card; greedy tokens
    against the teacher-forced argmax.
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
20. ResNet-50 inference (BASELINE.json config #2): ``ResNet50()`` at
    its published width (224 x 224 x 3, bottleneck stages [3, 4, 6, 3],
    1000 classes, bf16, random weights from the seed), a
    ComputationGraph, runs 5 ``output()`` calls on [64, 224, 224, 3] bf16
    images, launching none of the port's kernels (convolutions and pools
    on cuDNN); ms a call, images/s, the device busy share, the top
    kernels and the device time by kind of kernel (convolution, matmul,
    reduce, elementwise, pooling) of a profiled window.
21. ResNet-50 training: 2 warm and 10 timed ``fit_batch`` steps at B=64,
    Nesterovs 0.1 momentum 0.9, on a repeated batch: losses finite and
    the last below the first (at this lr the loss climbs for several
    steps before it falls, in the JAX package too), every
    BatchNormalization's running mean moved;
    step wall ms, samples/s, device ms, busy share, kernels a step, the
    top 10 kernels and the device time by kind of a profiled window, and
    MFU, the step's FLOPs (2 x
    the multiply-adds of the graph's own convolution and dense shapes, x 3
    for forward and backward) against 989 TFLOP/s bf16. Then the port's
    own f32 ResNet-50 (TF32 off) on the card against the same graph on the
    CPU at B=2 from shared weights: logits, the step's loss and the BN
    running means within TOL_RESNET_CPU.
22. bert_tiny.onnx (a transformers BertModel, 2 x 64, exported by
    torch.onnx) imported onto the card, with the import-graph optimizer
    on and off: both outputs against the recorded torch outputs within
    rtol = atol = 1e-4; node counts raw and optimized and the rewrites
    per rule (fuse_attention must be 2).
23. bench.py's bert_import lane at its own shape (BASELINE.json config #4
    as written, at the fixture's width): the import's
    ``as_trainable(outputs=["pooler_output"], compute_dtype=bfloat16)``
    under torch.func.vmap over 128 outer x [2, 16] (256 samples a step), a
    64 -> 2 head, cross-entropy and Adam(lr=2e-5) on f32 masters: 2 + 20
    steps with the optimizer on, then off. Losses finite, the first of
    the two runs within 2e-2 relative; no kernel of the port launched
    (the fused attention carries the mask as a bias). Step wall ms,
    samples/s, device ms, busy share, kernels a step.
24. BERT-base through TF import, full width: ``bert_graph_def`` builds a
    frozen GraphDef in google-research/bert modeling.py's op pattern (12
    x 768, 12 heads x 64, 3072, vocab 30522, 512 positions, a 768 -> 2
    classifier; weights N(0, 0.02) from the seed; about 440 MB), timed
    to build, parse and import; fuse_attention must be 12. f32 output()
    at B=2 on the card against the same graph on the CPU and against the
    optimizer off (logits and pooled output within 1e-4 of the largest
    value); 5 output() calls at [32, 128]; then ``as_trainable`` (bf16
    compute, f32 masters, Adam 2e-5) for 2 + 10 steps on seeded ids with
    padded positions, losses finite; ms a call, step wall ms, samples/s,
    device ms, busy share, kernels a step, and the step against phase
    11's zoo BertBase step.
25. The import path reaches a hand kernel: a TF graph Placeholder
    [128, 54, 54, 96] -> LRN (AlexNet's depth 5, k 2, alpha 1e-4, beta
    0.75) imported; output() launches the LRN forward kernel once a call
    (its count; a profiled window of 10 calls names it and no other
    kernel of the port) and equals the plain ``lrn``
    within TOL_LRN_FWD; a variant with a 1x1 Conv2D in front through
    ``as_trainable``: one sum-loss backward launches one LRN forward and
    one backward, its weight gradient against the plain path on the card.
26. YOLO2 inference at full width: ``YOLO2()`` with its defaults (608 x
    608 x 3, 80 classes, the five priors, bf16, random weights from the
    seed; a Darknet-19 trunk, the passthrough route and the 19 x 19 x 425
    head), a ComputationGraph, runs 5 ``output()`` calls on 16 N(0, 1)
    images, launching none of the port's kernels; ms a call, device ms,
    busy share, kernels a call and device time by kind of a profiled
    window. Then ``get_predicted_objects`` (threshold 0.5) and
    ``non_max_suppression`` (IoU 0.45) on the last output, their host ms
    and detection counts. Then the f32 YOLO2 (TF32 off) on the card
    against the same graph on the CPU at B=2, 608 x 608, from shared
    weights: the output, one ``fit_batch`` loss and the BN running means
    after it within TOL_YOLO2_CPU.
27. YOLO2 training at full width: 2 warm and 10 timed ``fit_batch`` steps
    at B=16, bf16, the zoo's Adam 1e-3, on labels [16, 19, 19, 85] made
    from the seed (1-8 object cells an image, cx, cy ~ U[0, 1), w, h ~
    U[0.3, 12] grid units, a one-hot class of 80): every loss finite;
    step wall ms, samples/s, device ms, busy share, kernels a step and the
    device time by kind of a profiled window (which must launch none of
    the nine kernels), peak memory, and MFU (3 x the forward FLOPs of
    ``forward_flops`` over the step wall, against 989 TFLOP/s bf16).
28. The rest of the CNN zoo on the card, each at its default input size
    and dtype (SimpleCNN 48, VGG16 and VGG19 224, SqueezeNet 227,
    Darknet19 224, TinyYOLO 416, Xception 299, UNet 512,
    InceptionResNetV1 160, NASNet 224): one ``output()`` and one
    ``fit_batch`` at B=2 (a finite loss, no kernel of the port launched),
    then its f32 ``output()`` at B=1 on the card against the CPU at full
    depth, the image side cut to ZOO_CHECK_SIDE (SimpleCNN at its own
    48), within TOL_ZOO_CPU of the largest output.
29. Transformer serving at bench.py's decode lane (bench.py:2226-2300):
    a causal LM of 4 layers, d 256, 8 heads, vocabulary 512, max_len 96,
    f32, served at 8 slots with the f32 ring and the int8 ring, 16 sampled
    requests (prompts 4-15, 12-39 new tokens) after an untimed pass:
    tokens/s, one decode program (a graph replayed every step), prefill
    shapes, and exactly 4 flash forwards a prefill and no other kernel
    (counted on the device as in phase 4);
    the lane's accuracy contract (8 rows, 32 teacher-forced steps: top-1
    agreement and the post-softmax difference of the int8 ring within
    1e-2); an f32 copy on the CPU gives the same greedy tokens, and its
    decode logits lie within 1e-5 relative over 16 steps through a ring
    of 8.
30. Transformer serving at full width: a causal LM at zoo BertBase's
    widths (12 x 768, 12 heads, d_ff 3072, vocabulary 30522, 512
    positions, bf16, random weights from the seed) in
    ``GenerationEngine(slots=8, max_len=512)``, with the bf16 ring and the
    int8 ring: 16 requests (prompts 16-380, 32-128 new tokens, half
    greedy, half sampled) with prompts padded to pow2 buckets (at most 6
    shapes), exactly 12 flash forwards a prefill and no other kernel
    (counted on the device as in phase 4), one
    decode program, every stream to its budget; tokens/s and TTFT p50; a
    full pool's decode step (synced wall ms, device ms, busy share,
    kernels a step), a replay alone and the same step run eagerly through
    ``adapter.decode``; ring bytes and peak memory; the replayed graph's
    own logits of the greedy streams, recorded in the counted run with the
    pool's slots live, against the full causal recompute over each stream:
    the share of emitted tokens that are a recompute top-1 (TOP1_FULL: at
    least 0.98 for the bf16 ring) and the largest logit difference
    (TOL_FULL_LOGIT), a gate that a ring left stale in one layer must
    fail (stale_ring_control, teacher-forced eagerly); an f32 2-layer
    copy within 1e-5 relative of its recompute; and the flash forward at
    the prefill shape [1, 12, 256, 64] causal bf16 against its plain
    version, timed beside its bound and scaled_dot_product_attention.
31. Session resume on the card: the phase-29 model cut to 1 layer, f32,
    greedy, a ring of 32 under max_len 96: 4 journaled sessions
    interrupted after 3, 12 and 30 steps (30: past the ring's wrap),
    resumed from a new journal into a new engine and finished; every
    stream equals the uninterrupted run token for token.
32. Truncated BPTT: TextGenerationLSTM at its zoo widths with
    ``tbptt_fwd_length = tbptt_bwd_length = 50`` at DL4J's
    GravesLSTMCharModellingExample settings (minibatch 32, example length
    1000) on a seeded synthetic character stream: one chunk's gradients
    at [32, 50, 256] from the carries the chunk before left, kernels
    against the kernel-disabled plain lowering on the card
    (TOL_TBPTT_CHUNK_GRAD); one ``fit_batch`` against a copy on the plain
    lowering (TOL_TBPTT_LOSS, TOL_TBPTT_PARAM), and a control copy whose
    gradients carry a seeded error of TBPTT_CONTROL_NOISE, which must read
    above the limit; one whose score must be the mean of its 20 chunks
    run by hand; then 10 calls through ``fit`` over a
    ``ListDataSetIterator`` with a ``ScoreIterationListener``, each
    launching exactly 40 LSTM forwards and 40 backwards, and one more
    call under the profiler whose device records of the cluster kernels
    must equal the host's 40 and 40; one call at T = 1010 (a trailing
    chunk of 10: 42 and 42); ms a call, device ms, busy share.
33. The fit loop at config #1: LeNet on ``MnistDataSetIterator(64)``
    (synthetic glyphs while no MNIST files are present) through
    ``EarlyStoppingTrainer`` (at most 3 epochs, score-improvement
    patience 1, the mean test loss of 4 batches as its score) with a
    ``PerformanceListener`` and an ``AsyncCheckpointListener``; then
    ``evaluate`` on the test iterator, which must equal the argmax
    accuracy of ``output()`` over the same batches; a checkpoint restored
    into a fresh net gives the saved step's outputs bit for bit, and one
    truncated by the ``ckpt_corrupt`` fault point is passed over for the
    step before; one dispatched step under
    ``torch.cuda.set_sync_debug_mode("error")`` raises nothing and leaves
    its score in flight; ms a step at ``DL4J_TORCH_ASYNC_STEPS`` 0 and 2
    (twice each, alternating). Phases 32, 34 and 35 hold one dispatched
    step of theirs to the sync debug mode too (``no_host_sync``).
34. Transfer learning at config #2's network: ResNet-50 (bf16, B = 64,
    224 x 224, N(0, 1) images, labels over 10 classes) through
    ``TransferLearningGraphBuilder`` (``set_feature_extractor("avgpool")``,
    the output vertex replaced by a 10-class head, Adam through
    ``FineTuneConfiguration``): 2 + 10 steps through an iterator, then
    ``evaluate``; every frozen parameter bit for bit unmoved, the head
    moved, no kernel of the port launched; ms a step beside phase 21's
    full step, peak memory.
35. Remat at config #4's network: BertBase at [32, 128], bf16, dropout
    0.1, with ``remat`` on and off from the same weights: one step's loss
    and gradients from the same generator state, with remat against
    without (bitwise, or within TOL_REMAT_BF16); 2 + 10 steps each,
    launching 24 flash forwards (12 without remat), 12 dq and 12 dk/dv a
    step, and one more step under the profiler whose device records must
    equal the host's count; peak memory and ms a step of each.
36. Prints the kernels line (all nine kernels; the LRN entries count the
    import path's launches under ``launches_by_path["tf_import"]``, the
    flash forward the serving prefills of phases 29-30 and its prefill
    shape's times, every entry YOLO2's, 0, under ``"yolo2_inference"``
    and ``"yolo2_training"``, and the training runtime's paths of phases
    32-35), the card line and, last, the result line ``{"ok": true,
    "device": {...}}``.

Every phase trains at the fit loop's defaults (``fit_batch`` returns a
lazy score, a window of 2 steps in flight, tail padding on); a phase turns
a score into a float where it stores or prints it.
Every phase runs f32 work with TF32 off (``torch.backends.cuda.matmul``
and ``torch.backends.cudnn`` ``allow_tf32`` False), the timed ones too.
"""

from __future__ import annotations

import copy
import json
import os
import re
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


# short kernels (torch.cuda._sleep's spin_kernel) launched, synced, at the
# start of every profiler session of this script, before what it profiles.
# Late in this long process every profiler session drops the first device
# records of its window, whatever kernels they are (on the H100, the first
# 13 of a tBPTT window in phase 32, PyTorch's and one LSTM forward, and
# every record of phase 25's 10 LRN calls; none in a fresh process;
# PERF.md §7): the lead-in's records take that loss, and the loss is read
# off them
PROFILE_LEAD_IN = 64


def _lead_in(torch) -> None:
    """The PROFILE_LEAD_IN spin kernels that open a profiler session."""
    for _ in range(PROFILE_LEAD_IN):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _device_records(prof):
    """A profile's device records, {record name: (device ms, count)}
    without the lead-in's, and the lead-in records it kept."""
    out, lead_in = {}, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and _device_us(e) > 0:
            if "spin_kernel" in e.key:
                lead_in += e.count
            else:
                out[e.key] = (_device_us(e) / 1e3, e.count)
    return out, lead_in


def profile_device(torch, fn, iters: int):
    """``iters`` calls of ``fn`` under torch.profiler, the session opened
    by the lead-in (_lead_in). Returns the device time by kernel name,
    {name: (total_ms, count)} (empty if the profiler saw no device
    activity), and the wall ms of the profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead_in(torch)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_records(prof)[0], wall_ms


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

    def serve(counted):
        out = [eng.submit(r.pop("prompt"), **r) for r in
               [dict(q) for q in reqs]]
        eng.drain()
        return out

    run = _engine_launches(torch, eng, KERNELS, serve, what="LSTM serving")
    streams, launches, reserves = (run["streams"], run["launches"],
                                   run["reserves"])
    decode_steps, replays = run["steps"], run["replays"]
    _check_replays(eng, decode_steps, "LSTM serving")
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
    if launches != _only(KERNELS, fused_lstm_fwd=expected):
        fail(f"LSTM serving launched {launches} in {decode_steps} decode "
             f"steps ({replays} replays of {eng.capture_launches}) and "
             f"{n_prefill} prefills; want fused_lstm_fwd {expected} alone")

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
    wall = run["wall_s"]
    ttft = sorted(s.first_token_at - s.submitted_at for s in run["timed"])
    from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import FWD_KERNEL_NAMES

    profile = profile_decode(torch, eng, reqs,
                             want={FWD_KERNEL_NAMES["stream"]: 2})
    return {
        "model": "TextGenerationLSTM(units=256, layers=2, vocab=77)",
        "slots": 8, "max_len": 256, "requests": N_REQUESTS,
        "tokens": n_tokens, "decode_steps": decode_steps,
        "replays": replays, "capture_launches": eng.capture_launches,
        "decode_programs": eng.decode_programs,
        "prefill_programs": eng.prefill_programs,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "launches": launches, "host_launches": run["host_launches"],
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


def profile_decode(torch, eng, reqs, want, steps: int = 20):
    """A steady window of full-pool decode steps (the workload's mix of
    greedy and sampled knobs) under torch.profiler: host ms per step,
    device busy share, device time by kernel, and the launches of each
    kernel of ``want`` ({device function: launches a step}) that the
    profiler saw inside the replayed graphs, which must be ``want``'s (the
    window is profiled again while the profiler drops records); then, on
    the same full pool, the wall ms of a replay alone, of the same step run
    eagerly through ``adapter.decode`` (what the graph holds), and of the
    sampler alone."""
    from deeplearning4j_tpu_torch.generation import sample_logits

    for r in reqs[:eng.pool.n_slots]:
        eng.submit(**dict(r, max_new_tokens=4 * steps + 40))
    # the warm-up call inside profile_device admits (prefills) all slots
    by_kernel, wall_ms, seen = profile_showing(torch, eng.step, steps, want)
    if any(seen[k] != n * steps for k, n in want.items()):
        fail(f"the profiler saw {seen} launches in {steps} replayed decode "
             f"steps; want {want} a step")
    pool = eng.pool
    act = pool.active_slots()
    tokens, pos = eng._inputs[0], eng._inputs[1]
    logits = eng.adapter.decode(pool.state, tokens, pos)[0]
    forward_ms = host_ms(
        torch, lambda: eng.adapter.decode(pool.state, tokens, pos), steps)
    replay_ms = host_ms(torch, eng.decode_pool, steps)
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
        "kernels_per_step": sum(n for _, n in by_kernel.values()) / steps,
        "profiled_launches": seen,
        "top_kernels_ms_per_step": {k[:60]: t / steps
                                    for k, (t, _) in top},
        "active_slots": len(act),
        "sampled_slots": int(sum(pool.temps[s] > 0 for s in act)),
        "unprofiled_step_ms": step_ms, "replay_ms": replay_ms,
        "eager_forward_ms": forward_ms, "sample_ms": sample_ms,
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
    eng.generate([1, 2, 3, 4], max_new_tokens=2)  # warm-up, not counted
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(4, 49, 8)]

    def serve(counted):
        out = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.drain()
        return out

    run = _engine_launches(torch, eng, [FUSED_LSTM], serve,
                           what="bf16 LSTM serving")
    streams, replays = run["streams"], run["replays"]
    launches, steps = run["launches"][FUSED_LSTM.name], run["steps"]
    _check_replays(eng, steps, "bf16 LSTM serving")
    if any(len(s.tokens) != 16 for s in streams):
        fail("bf16 net: a request did not emit its 16 tokens")
    if launches != 2 * steps + 2 * len(prompts):
        fail(f"bf16 net: fused_lstm_fwd launched {launches} times in "
             f"{steps} decode steps ({replays} replays of "
             f"{eng.capture_launches}) and {len(prompts)} prefills")
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
            "replays": replays,
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


def device_functions():
    """{kernel name: the device functions its launcher may run}, as the
    profiler names them: a kernel's launches counted on the device."""
    from deeplearning4j_tpu_torch.ops.cuda import (
        FLASH_DKV, FLASH_DQ, FLASH_FWD, FUSED_GRU, FUSED_GRU_BWD, FUSED_LSTM,
        FUSED_LSTM_BWD, LRN_BWD, LRN_FWD, flash_attention, fused_gru,
        fused_lstm,
    )

    return {FUSED_LSTM.name: tuple(fused_lstm.FWD_KERNEL_NAMES.values()),
            FUSED_LSTM_BWD.name: tuple(fused_lstm.BWD_KERNEL_NAMES.values()),
            FUSED_GRU.name: tuple(fused_gru.FWD_KERNEL_NAMES.values()),
            FUSED_GRU_BWD.name: tuple(fused_gru.BWD_KERNEL_NAMES.values()),
            FLASH_FWD.name: tuple(flash_attention.FWD_KERNEL_NAMES.values()),
            FLASH_DQ.name: tuple(flash_attention.DQ_KERNEL_NAMES.values()),
            FLASH_DKV.name: tuple(flash_attention.DKV_KERNEL_NAMES.values()),
            LRN_FWD.name: ("lrn_fwd_kernel",),
            LRN_BWD.name: ("lrn_bwd_kernel",)}


def _device_launches(by_kernel, kernels):
    """{kernel name: device records of its device functions} in a profile
    ``by_kernel`` ({record name: (ms, count)})."""
    names = device_functions()
    out = {}
    for k in kernels:
        pats = [re.compile(rf"(?<!\w){f}(?!\w)") for f in names[k.name]]
        out[k.name] = sum(c for key, (_, c) in by_kernel.items()
                          if any(p.search(key) for p in pats))
    return out


def profiled_launches(torch, kernels, fn, tries: int = 3):
    """One call of ``fn`` under torch.profiler, every kernel's count zeroed
    just before it and read just after: the host's launches and the
    device's records of them, both {kernel name: launches} of that one
    call. The profile opens with PROFILE_LEAD_IN spin kernels, synced,
    before the counts are zeroed, so the records a session loses at its
    start are theirs. A call whose records differ from the host's count,
    or whose lead-in kept no record (the loss may then reach into the
    call), is run and profiled again, up to ``tries`` times. Returns
    (host, device, {record name: (ms, count)} of the call's kernels, wall
    ms, lead-in records lost) of the last call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in(torch)
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        host = {k.name: k.launches for k in kernels}
        by_kernel, lead_in = _device_records(prof)
        device = _device_launches(by_kernel, kernels)
        if device == host and lead_in:
            break
    return host, device, by_kernel, wall_ms, PROFILE_LEAD_IN - lead_in


def _stream_differences(timed, counted, third, limit: int = 4):
    """Where two runs' streams part: for each request whose tokens differ
    (the first ``limit``), its prompt length, whether it samples, both
    runs' lengths and finish reasons, the first position that differs,
    the two tokens there, and which of them a third run agrees with."""
    out = []
    for i, (a, b, c) in enumerate(zip(timed, counted, third)):
        if a.tokens == b.tokens:
            continue
        p = next((j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), min(len(a.tokens), len(b.tokens)))
        req = a.request
        out.append({
            "request": i, "prompt_len": len(req.prompt),
            "sampled": req.temperature > 0,
            "lengths": [len(a.tokens), len(b.tokens)],
            "finish": [a.finish_reason, b.finish_reason],
            "position": p,
            "tokens": [a.tokens[p:p + 1], b.tokens[p:p + 1]],
            "third_run_agrees_with": ("both" if c.tokens == a.tokens
                                      == b.tokens else "timed"
                                      if c.tokens == a.tokens else
                                      "counted" if c.tokens == b.tokens
                                      else "neither")})
        if len(out) == limit:
            break
    return out


def _engine_launches(torch, eng, kernels, fn, tries: int = 3,
                     what: str = "serving"):
    """Drive ``eng`` through ``fn`` twice: a timed run (``fn(counted=
    False)``, synced wall s, no counts read), then the counted run
    (``fn(counted=True)``) with every kernel's counts zeroed just before
    and read just after, under torch.profiler (opened by the lead-in,
    _lead_in). A kernel's launches in the counted run are the profiler's
    records of its device functions, which see the kernels inside a
    replayed graph; the host counters cannot (the wrappers count on the
    host, and a replay calls none). The records are
    held against the host's account: the wrappers' counts (the prefills)
    plus the captured step's launches (``capture_launches``) times the
    run's replays. A counted run whose records fall short of it is run and
    profiled again (the profiler now and then drops a window's records), up
    to ``tries`` times; then the run fails. The graph must have been
    captured before (a warm-up request): a capture inside a run fails it,
    and so do streams (``fn``'s result) that differ between the runs; the
    failure then names ``what`` and says where they part
    (_stream_differences, with a third run to tell which run is odd).
    Returns {"streams": the counted run's streams, "timed": the timed
    run's, "wall_s": the timed run's, "launches": the measured launches,
    "host_launches", "reserves", "steps": decode steps, "replays"} (steps
    and replays of the counted run)."""
    from torch.profiler import ProfilerActivity, profile

    captures0 = eng.captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = fn(counted=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for _ in range(tries):
        replays0, steps0 = eng.replays, eng.steps_run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in(torch)
            out, host, reserves, _ = _count_launches(
                torch, kernels, lambda: fn(counted=True))
        if eng.captures != captures0:
            fail("the engine captured its decode step inside a counted run; "
                 "warm it up first")
        replays = eng.replays - replays0
        launches = _device_launches(_device_records(prof)[0], kernels)
        account = {name: n + eng.capture_launches.get(name, 0) * replays
                   for name, n in host.items()}
        if launches == account:
            break
    else:
        fail(f"the profiler saw {launches} launches in {replays} replays of "
             f"{eng.capture_launches} and the prefills' {host}, "
             f"{tries} times; want {account}")
    if [s.tokens for s in timed] != [s.tokens for s in out]:
        third = fn(counted=False)
        fail(f"{what}: the timed run's streams differ from the counted "
             f"run's: {json.dumps(_stream_differences(timed, out, third))}")
    return {"streams": out, "timed": timed, "wall_s": wall,
            "launches": launches, "host_launches": host,
            "reserves": reserves, "steps": eng.steps_run - steps0,
            "replays": replays}


def _check_replays(eng, decode_steps, what):
    """A CUDA engine replays one captured graph for every decode step."""
    if eng.decode_programs != 1 or eng.captures != 1:
        fail(f"{what}: {eng.decode_programs} decode programs and "
             f"{eng.captures} captures; want one graph, captured once")
    if eng.replays != eng.steps_run or decode_steps == 0:
        fail(f"{what}: {eng.replays} replays in {eng.steps_run} decode "
             "steps; every step must replay the graph")


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
    card = [float(net.fit_batch((x, y))) for _ in range(2)]
    cpu = [float(cpu_net.fit_batch((x, y))) for _ in range(2)]
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
    losses = [float(v) for v in losses]
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
    losses = [float(v) for v in losses]
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
    losses = [float(v) for v in losses]
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
    la = [float(a.fit_batch((x, y, m))) for _ in range(2)]
    env.disable_kernels = True
    try:
        lb = [float(b.fit_batch((x, y, m))) for _ in range(2)]
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
                         "fwd_design": lrn_fwd_design(x, y),
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


def lrn_fwd_design(x, y):
    """The forward launcher's design for x and y ([path, rows a block,
    threads a row]), which must be the one ``fwd_design`` names."""
    from deeplearning4j_tpu_torch.ops.cuda.lrn import (
        fwd_design, launcher_design,
    )

    aligned = (x.data_ptr() | y.data_ptr()) % 16 == 0
    got = launcher_design(x.shape[-1], aligned, x.dtype)
    want = fwd_design(x.shape[-1], aligned, x.dtype)
    if got != want:
        fail(f"LRN forward launcher chose {got} for C = {x.shape[-1]}, "
             f"{x.dtype}, aligned {aligned}; fwd_design names {want}")
    return list(got)


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
    out["fwd_design"] = lrn_fwd_design(x, lrn_forward(x, **hp))
    # the element-by-element paths (no 16-byte loads): the same data one
    # element past a 16-byte boundary, the forward held against its plain
    # version there
    xm, gm = (torch.empty(t.numel() + 1, device="cuda", dtype=dt)[1:]
              .view(shape).copy_(t) for t in (x, gy))
    if xm.data_ptr() % 16 == 0:
        fail("the element path's copy of x is 16-byte aligned")
    ym = lrn_forward(xm, **hp)
    out["fwd_element_path_design"] = lrn_fwd_design(xm, ym)
    err, ok = _lrn_within(torch, ym, lrn_fwd_plain(xm, **hp), dt,
                          TOL_LRN_FWD)
    if not ok or out["fwd_element_path_design"][0] != "element":
        fail(f"LRN forward off a 16-byte boundary at {list(shape)} {dt}: "
             f"design {out['fwd_element_path_design']}, error {err}")
    out["fwd_element_path_max_abs_err"] = err
    out["fwd_element_path_device_ms"] = kernel_device_ms(
        torch, lambda: lrn_forward(xm, **hp), iters, "lrn_fwd_kernel")
    out["bwd_element_path_device_ms"] = kernel_device_ms(
        torch, lambda: lrn_backward(xm, gm, **hp), iters, "lrn_bwd_kernel")
    out["fwd_bound_ms"], out["fwd_bound_by"] = lrn_bound(shape, e, False,
                                                        depth)
    out["bwd_bound_ms"], out["bwd_bound_by"] = lrn_bound(shape, e, True,
                                                        depth)
    # the launches above were for timing: they are not the main path's
    return out


def _symbol_ms(by_kernel, symbol, n):
    """Device ms of the kernels named ``symbol`` in a profiled window of
    ``n`` calls or steps, per call or step."""
    return sum(t for k, (t, _) in by_kernel.items() if symbol in k) / n


def _profile_summary(by_kernel, wall_ms, n, unit, top_n=8):
    """A profiled window of ``n`` calls or steps (``unit``): wall and device
    ms each, device busy share, device kernels each, top kernels (names cut
    to 120 characters, which still tell PyTorch's elementwise kernels
    apart by their functor; kernels whose cut names agree are summed)."""
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    named = {}
    for k, (t, _) in top:
        named[k[:120]] = named.get(k[:120], 0.0) + t / n
    return {
        f"{unit}s": n, f"wall_ms_per_{unit}": wall_ms / n,
        f"device_ms_per_{unit}": busy / n,
        "device_busy_share": busy / wall_ms if by_kernel else None,
        f"device_kernels_per_{unit}": sum(c for _, c in by_kernel.values()) / n,
        f"top_kernels_ms_per_{unit}": named,
    }


# kinds of device kernel by name, first match wins: cuDNN's convolutions
# (its own and CUTLASS kernels, implicit GEMMs for fprop, dgrad, wgrad),
# other matrix products, PyTorch's reductions (the BatchNormalization
# statistics and the loss among them), its elementwise kernels
# (normalization, activations, adds, casts, the updater), pooling
KERNEL_KINDS = (("convolution", ("cudnn", "implicit_gemm", "fprop", "dgrad",
                                 "wgrad", "conv")),
                ("matmul", ("gemm",)),
                ("reduce", ("reduce_kernel",)),
                ("elementwise", ("elementwise",)),
                ("pooling", ("pool",)))


def _ms_by_kind(by_kernel, n):
    """Device ms of a profiled window of ``n`` calls or steps by kind of
    kernel (KERNEL_KINDS; "other" for the rest), per call or step."""
    out = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    out["other"] = 0.0
    for k, (t, _) in by_kernel.items():
        kind = next((kd for kd, pats in KERNEL_KINDS
                     if any(p in k for p in pats)), "other")
        out[kind] += t / n
    return out


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
        "lrn_fwd_device_ms_per_call": _symbol_ms(by_kernel, "lrn_fwd_kernel",
                                                 calls),
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
    losses = [float(v) for v in losses]
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
    la = [float(a.fit_batch((x, y))) for _ in range(2)]
    env.disable_kernels = True
    try:
        lb = [float(b.fit_batch((x, y))) for _ in range(2)]
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
        "lrn_fwd_device_ms_per_step": _symbol_ms(by_kernel, "lrn_fwd_kernel",
                                                 steps),
        "lrn_bwd_device_ms_per_step": _symbol_ms(by_kernel, "lrn_bwd_kernel",
                                                 steps),
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
    losses = [float(v) for v in losses]
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
    from deeplearning4j_tpu_torch.ops.cuda.fused_gru import (
        FWD_KERNEL_NAMES as gru_names,
    )

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

    def serve(counted):
        out = [eng.submit(r.pop("prompt"), **r) for r in
               [dict(q) for q in reqs]]
        eng.drain()
        return out

    run = _engine_launches(torch, eng, KERNELS, serve, what="GRU serving")
    streams, launches, reserves = (run["streams"], run["launches"],
                                   run["reserves"])
    decode_steps, replays = run["steps"], run["replays"]
    _check_replays(eng, decode_steps, "GRU serving")
    n_prefill = sum(1 for r in reqs if len(r["prompt"]) > 1)
    want = _only(KERNELS, fused_gru_fwd=2 * decode_steps + 2 * n_prefill)
    if launches != want or any(reserves.values()):
        fail(f"GRU serving launched {launches} ({reserves} with reserve) in "
             f"{decode_steps} decode steps ({replays} replays of "
             f"{eng.capture_launches}) and {n_prefill} prefills; want "
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
                    carries[disable], toks[j], None)
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
    wall = run["wall_s"]
    ttft = sorted(s.first_token_at - s.submitted_at for s in run["timed"])
    return {
        "model": "GRU char-RNN (GRULayer(256) x 2, vocab 77; "
                 "TextGenerationLSTM's topology with GRU cells)",
        "slots": 8, "max_len": 256, "requests": N_REQUESTS,
        "tokens": n_tokens, "decode_steps": decode_steps,
        "prefills": n_prefill, "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "launches": launches, "host_launches": run["host_launches"],
        "replays": replays, "capture_launches": eng.capture_launches,
        "decode_programs": eng.decode_programs,
        "prefill_programs": eng.prefill_programs,
        "launches_per_decode_step": (launches["fused_gru_fwd"]
                                     - 2 * n_prefill) / decode_steps,
        "decode_logits_max_abs_err_kernel_vs_plain": worst,
        "decode_logit_max_abs": logit_max,
        "decode_profile": profile_decode(
            torch, eng, reqs, want={gru_names["stream"]: 2}),
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
    # also the warm-up
    card = [float(net.fit_batch((x, y))) for _ in range(2)]
    env.disable_kernels = True
    try:
        ref = [float(plain.fit_batch((x, y))) for _ in range(2)]
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
    losses = [float(v) for v in losses]
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


# ------------------------------------------------------ ResNet-50 slice

RESNET_BATCH = 64  # BASELINE.md's ResNet-50 row, bench.py's batch
N_RESNET_CALLS = 5
N_RESNET_WARM = 2
N_RESNET_STEPS = 10
# the port's f32 ResNet-50 on the card (cuDNN, TF32 off) against the same
# graph on the CPU, B = 2, 224 x 224: logits of output() relative to the
# largest, the step's loss relative, the BN running means after the step
# relative to the largest. The convolutions sum in other orders (cuDNN
# may take Winograd or FFT algorithms) through 53 layers, and the step's
# BatchNormalizations normalize by statistics of 2 x 7 x 7 values a
# channel in the last stage. The updated weights are not compared: the
# gradients through 53 training-mode BatchNormalizations amplify f32
# rounding by orders (the port's own f32 and f64 steps on the CPU give
# logits after one step far further apart than before it).
TOL_RESNET_CPU = 1e-4


# ResNet50()'s forward FLOPs an image as the earlier ResNet-only counter
# gave them (2 x its convolutions' and dense layer's multiply-adds), which
# forward_flops must still give
RESNET50_FORWARD_FLOPS = 7_715_946_496


def _prod(v):
    out = 1
    for d in v:
        out *= int(d)
    return out


def layer_macs(layer, itype, otype) -> int:
    """Multiply-adds of one example through ``layer``, from its input and
    output types: conv (1-D, 2-D, 3-D) output positions x C_out x kernel
    volume x C_in / groups; depthwise output positions x kernel area;
    separable its depthwise and its 1x1 pointwise conv; deconv input
    pixels x kernel area x C_in x C_out; dense inputs x outputs (the
    output layers too). Other layers do none."""
    from deeplearning4j_tpu_torch.nn.layers import (
        Convolution1DLayer, Convolution3DLayer, ConvolutionLayer,
        Deconvolution2DLayer, DenseLayer, DepthwiseConvolution2DLayer,
        SeparableConvolution2DLayer,
    )

    if isinstance(layer, ConvolutionLayer):
        h, w, cout = otype.shape
        kh, kw = layer.kernel
        return h * w * cout * kh * kw * itype.channels // layer.groups
    if isinstance(layer, Convolution1DLayer):
        t, cin = itype.shape
        cout, tout = otype.shape[1], otype.shape[0]
        return tout * cout * layer.kernel * cin
    if isinstance(layer, Convolution3DLayer):
        return (_prod(otype.shape) * _prod(layer.kernel)
                * itype.channels)
    if isinstance(layer, DepthwiseConvolution2DLayer):
        return _prod(otype.shape) * _prod(layer.kernel)
    if isinstance(layer, SeparableConvolution2DLayer):
        h, w, cout = otype.shape
        mid = itype.channels * layer.depth_multiplier
        return h * w * mid * (_prod(layer.kernel) + cout)
    if isinstance(layer, Deconvolution2DLayer):
        h, w, cin = itype.shape
        return h * w * _prod(layer.kernel) * cin * layer.n_out
    if isinstance(layer, DenseLayer):
        return itype.size * layer.n_out
    return 0


def forward_flops(net, batch: int) -> int:
    """FLOPs of one forward pass of ``batch`` examples through a
    ComputationGraph or a MultiLayerNetwork: 2 x ``layer_macs`` of every
    layer, from the network's own shapes."""
    conf = net.conf
    if hasattr(conf, "topological_order"):
        pairs = []
        for name in conf.topological_order:
            layer = getattr(conf.vertices[name], "layer", None)
            if layer is not None:
                (itype,) = net._vertex_input_types(name)
                pairs.append((layer, itype, conf.vertex_output_types[name]))
    else:
        pairs = [(layer, itype, layer.output_type(itype))
                 for layer, itype in zip(conf.layers,
                                         conf.layer_input_types)]
    return 2 * batch * sum(layer_macs(*p) for p in pairs)


def _resnet_batch(torch, seed, B, dtype):
    """bench.py's ResNet-50 data (``_batch_pool``): images from N(0, 1) in
    ``dtype`` and one-hot labels over 1000 classes, made on the card from
    the seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, 224, 224, 3), device="cuda", generator=g).to(dtype)
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (B,), device="cuda", generator=g),
        1000).float()
    return x, y


def _resnet_logits(torch, net, x):
    """The output vertex's pre-softmax logits of an inference pass, f32."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating

    with torch.no_grad():
        _, _, pre, _ = net._forward(
            cast_floating(net.params, net._policy.compute_dtype), net.state,
            {"input": x}, False, None, want_preout=True)
    return pre["output"].float()


def phase_resnet_inference(torch, np):
    """ResNet50() at its published width answering output() calls on
    [64, 224, 224, 3] bf16 images; returns (summary, net)."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(seed=SEED).init(device="cuda")
    x, _ = _resnet_batch(torch, SEED + 11, RESNET_BATCH, torch.bfloat16)
    net.output(x)  # warm-up, not counted
    outs, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: [net.output(x) for _ in range(N_RESNET_CALLS)])
    if any(launches.values()):
        fail(f"ResNet-50 output() launched {launches}; its path runs none "
             f"of the port's kernels")
    out = outs[-1]
    if (tuple(out.shape) != (RESNET_BATCH, 1000)
            or out.dtype != torch.float32 or out.grad_fn is not None
            or not bool(torch.isfinite(out).all())
            or float((out.sum(-1) - 1).abs().max()) > 1e-2):
        fail(f"ResNet-50 output() gave {tuple(out.shape)} {out.dtype}, "
             f"finite {bool(torch.isfinite(out).all())}")
    by_kernel, prof_wall = profile_device(torch, lambda: net.output(x),
                                          N_RESNET_CALLS)
    flops = forward_flops(net, RESNET_BATCH)
    if flops != RESNET50_FORWARD_FLOPS * RESNET_BATCH:
        fail(f"forward_flops gives ResNet-50 {flops} FLOPs at B = "
             f"{RESNET_BATCH}, not {RESNET50_FORWARD_FLOPS} an image")
    call_ms = 1e3 * wall / N_RESNET_CALLS
    return {
        "model": "ResNet50(224 x 224 x 3, [3, 4, 6, 3] bottlenecks, 1000 "
                 "classes), bf16, random weights from the seed",
        "batch": RESNET_BATCH, "params": net.num_params(),
        "calls": N_RESNET_CALLS, "launches": launches,
        "wall_ms_per_call": call_ms,
        "images_per_s": RESNET_BATCH * N_RESNET_CALLS / wall,
        "synced_ms_per_call": host_ms(torch, lambda: net.output(x),
                                      N_RESNET_CALLS),
        "forward_gflop_per_call": flops / 1e9,
        "mfu": flops / (call_ms * 1e-3) / BF16_FLOP_PER_S,
        "profile": _profile_summary(by_kernel, prof_wall, N_RESNET_CALLS,
                                    "call", top_n=10),
        "device_ms_per_call_by_kind": _ms_by_kind(by_kernel, N_RESNET_CALLS),
    }, net


def resnet_cpu_check(torch, np):
    """The port's own f32 ResNet-50 (TF32 off) on the card against the same
    graph on the CPU, B = 2 at 224 x 224, from shared weights: logits of
    output(), the loss of one fit_batch step and the BN running means after
    it."""
    from deeplearning4j_tpu_torch.zoo import ResNet50

    card = ResNet50(seed=SEED + 1, dtype="float32").init(device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    x, y = _resnet_batch(torch, SEED + 13, 2, torch.float32)

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / float(b.abs().max())

    err = {"logits": rel(_resnet_logits(torch, card, x),
                         _resnet_logits(torch, cpu, x.cpu()))}
    lc = float(card.fit_batch((x, y)))
    lp = float(cpu.fit_batch((x.cpu(), y.cpu())))
    err["step_loss"] = abs(lc - lp) / abs(lp)
    err["bn_running_mean"] = max(
        rel(card.state[k]["mean"], cpu.state[k]["mean"]) for k in cpu.state)
    if not all(e <= TOL_RESNET_CPU for e in err.values()):
        fail(f"f32 ResNet-50, card against CPU at B = 2: {err} (tolerance "
             f"{TOL_RESNET_CPU}, relative)")
    return {"batch": 2, "tf32": False, "tolerance": TOL_RESNET_CPU,
            "max_rel_err": err, "card_loss": lc, "cpu_loss": lp}


def phase_resnet_training(torch, np, net):
    """ResNet-50 fit_batch at B = 64 on the card: 2 warm steps, 10 timed
    ones on a repeated batch, a profiled window, the FLOPs of a step
    against the bf16 peak, then the f32 card-against-CPU check."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    x, y = _resnet_batch(torch, SEED + 12, RESNET_BATCH, torch.bfloat16)
    means = {k: s["mean"].clone() for k, s in net.state.items()}
    torch.cuda.reset_peak_memory_stats()
    warm = [float(net.fit_batch((x, y))) for _ in range(N_RESNET_WARM)]
    timed, launches, _, wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y)) for _ in range(N_RESNET_STEPS)])
    timed = [float(v) for v in timed]
    losses = warm + timed
    if not all(np.isfinite(losses)):
        fail(f"ResNet-50 training losses not finite: {losses}")
    # from the first step to the last: at the model's lr of 0.1 with
    # momentum 0.9 the loss on a repeated batch first climbs for several
    # steps and then falls (the JAX package's ResNet50 does the same), so
    # the mean of the first three steps, which the other phases compare, is
    # no measure of learning here
    if not losses[-1] < losses[0]:
        fail(f"ResNet-50 loss on a repeated batch did not fall: {losses}")
    if any(launches.values()):
        fail(f"ResNet-50 training launched {launches}; its path runs none "
             f"of the port's kernels")
    still = [k for k, m in means.items()
             if torch.equal(net.state[k]["mean"], m)]
    if len(means) != 53 or still:
        fail(f"ResNet-50: {len(means)} BN states, running means that did "
             f"not move: {still}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = 3
    by_kernel, prof_wall = profile_device(
        torch, lambda: net.fit_batch((x, y)), steps)
    prof = _profile_summary(by_kernel, prof_wall, steps, "step", top_n=10)
    step_ms = 1e3 * wall / N_RESNET_STEPS
    flops = 3 * forward_flops(net, RESNET_BATCH)
    # ms a step at async windows 0 and 2 (at 2 the host may dispatch the
    # next step while the card still runs this one)
    by_window = window_step_ms(torch, net, (x, y), N_RESNET_STEPS)
    return {
        "model": "ResNet50, bf16, Nesterovs 0.1 momentum 0.9",
        "batch": RESNET_BATCH, "warm_steps": N_RESNET_WARM,
        "steps": N_RESNET_STEPS, "losses": losses, "launches": launches,
        "wall_s": wall, "step_wall_ms": step_ms,
        "samples_per_s": RESNET_BATCH * N_RESNET_STEPS / wall,
        "peak_memory_gb": peak,
        # 2 x multiply-adds forward, x 3 for forward + backward
        "step_tflop": flops / 1e12,
        "mfu": flops / (step_ms * 1e-3) / BF16_FLOP_PER_S,
        "mfu_of_device_time": (flops / (prof["device_ms_per_step"] * 1e-3)
                               / BF16_FLOP_PER_S),
        "profile": prof,
        "device_ms_per_step_by_kind": _ms_by_kind(by_kernel, steps),
        "ms_per_step_by_window": by_window,
        "f32_card_vs_cpu": resnet_cpu_check(torch, np),
    }


# ------------------------------------------------------ detection slice

YOLO2_BATCH = 16
N_YOLO2_CALLS = 5
N_YOLO2_WARM = 2
N_YOLO2_STEPS = 10
YOLO2_GRID = 19
YOLO2_CLASSES = 80
YOLO2_THRESHOLD = 0.5
YOLO2_NMS_IOU = 0.45
# the port's f32 YOLO2 on the card (cuDNN, TF32 off) against the same graph
# on the CPU, B = 2 at 608 x 608: the output relative to its largest entry,
# the step's loss relative, the BN running means after the step relative
# to the largest (as TOL_RESNET_CPU: the convolutions sum in other orders
# through 23 layers and 22 training-mode BatchNormalizations)
TOL_YOLO2_CPU = 1e-4
# phase 28: the rest of the zoo at B = 2 on the card, each model's f32
# output() at B = 1 on the card against the CPU at full depth on images cut
# to ZOO_CHECK_SIDE (SimpleCNN at its own 48), relative to the largest
# output
ZOO_BATCH = 2
ZOO_CHECK_SIDE = 128
TOL_ZOO_CPU = 1e-4
# the device functions of the nine kernels (csrc/*.cu), as the profiler
# names them
HAND_KERNEL_NAMES = ("flash_fwd_", "flash_dq_", "flash_dkv_", "gru_fwd_",
                     "gru_bwd_", "lrn_fwd_kernel", "lrn_bwd_kernel",
                     "lstm_fwd_", "lstm_bwd_")
ZOO_MODELS = ("SimpleCNN", "VGG16", "VGG19", "SqueezeNet", "Darknet19",
              "TinyYOLO", "Xception", "UNet", "InceptionResNetV1", "NASNet")


def yolo2_labels(np, seed, B, grid=YOLO2_GRID, classes=YOLO2_CLASSES,
                 cells=(1, 8), wh=(0.3, 12.0)):
    """[B, grid, grid, 5 + classes] YOLOv2 labels from the seed: 1-8 object
    cells an image, cx, cy ~ U[0, 1) in the cell, w, h ~ U[0.3, 12] grid
    units, obj 1, a one-hot class."""
    rng = np.random.default_rng(seed)
    y = np.zeros((B, grid, grid, 5 + classes), np.float32)
    for b in range(B):
        n = min(int(rng.integers(cells[0], cells[1] + 1)), grid * grid)
        for c in rng.choice(grid * grid, size=n, replace=False):
            i, j = divmod(int(c), grid)
            y[b, i, j, 0:2] = rng.random(2)
            y[b, i, j, 2:4] = rng.uniform(*wh, size=2)
            y[b, i, j, 4] = 1.0
            y[b, i, j, 5 + int(rng.integers(0, classes))] = 1.0
    return y


def _images(torch, seed, B, H, W, dtype, device="cuda"):
    """N(0, 1) NHWC images made on ``device`` from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, H, W, 3), device=device, generator=g).to(dtype)


def _max_rel(a, b):
    """Largest |a - b| over the largest |b| (b on the CPU)."""
    return float((a.float().cpu() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def yolo2_cpu_check(torch, np):
    """The port's own f32 YOLO2 (TF32 off) on the card against the same
    graph on the CPU, B = 2 at 608 x 608, from shared weights: output(),
    the loss of one fit_batch step and the BN running means after it."""
    from deeplearning4j_tpu_torch.zoo import YOLO2

    card = YOLO2(seed=SEED + 1, dtype="float32").init(device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    x = _images(torch, SEED + 23, 2, 608, 608, torch.float32)
    y = torch.tensor(yolo2_labels(np, SEED + 24, 2))
    err = {"output": _max_rel(card.output(x), cpu.output(x.cpu()))}
    lc = float(card.fit_batch((x, y.cuda())))
    lp = float(cpu.fit_batch((x.cpu(), y)))
    err["step_loss"] = abs(lc - lp) / abs(lp)
    err["bn_running_mean"] = max(
        _max_rel(card.state[k]["mean"], cpu.state[k]["mean"])
        for k in cpu.state)
    if not all(e <= TOL_YOLO2_CPU for e in err.values()):
        fail(f"f32 YOLO2, card against CPU at B = 2: {err} (tolerance "
             f"{TOL_YOLO2_CPU}, relative)")
    return {"batch": 2, "tf32": False, "tolerance": TOL_YOLO2_CPU,
            "max_rel_err": err, "card_loss": lc, "cpu_loss": lp}


def phase_yolo2_inference(torch, np):
    """YOLO2() at its published width answering output() calls on 16 bf16
    images, then decode and NMS on the host, then the f32 card-against-CPU
    check; returns (summary, net)."""
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        get_predicted_objects, non_max_suppression,
    )
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import YOLO2

    net = YOLO2(seed=SEED).init(device="cuda")
    x = _images(torch, SEED + 21, YOLO2_BATCH, 608, 608, torch.bfloat16)
    net.output(x)  # warm-up, not counted
    outs, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: [net.output(x) for _ in range(N_YOLO2_CALLS)])
    if any(launches.values()):
        fail(f"YOLO2 output() launched {launches}; its path runs none of "
             f"the port's kernels")
    out = outs[-1]
    want = (YOLO2_BATCH, YOLO2_GRID, YOLO2_GRID, 5 * (5 + YOLO2_CLASSES))
    if (tuple(out.shape) != want or out.dtype != torch.float32
            or out.grad_fn is not None
            or not bool(torch.isfinite(out).all())):
        fail(f"YOLO2 output() gave {tuple(out.shape)} {out.dtype}, finite "
             f"{bool(torch.isfinite(out).all())}; want {want} float32")
    by_kernel, prof_wall = profile_device(torch, lambda: net.output(x),
                                          N_YOLO2_CALLS)
    layer = net.conf.vertices["output"].layer
    t0 = time.perf_counter()
    dets = get_predicted_objects(layer, out, threshold=YOLO2_THRESHOLD)
    t1 = time.perf_counter()
    kept = [non_max_suppression(d, YOLO2_NMS_IOU) for d in dets]
    t2 = time.perf_counter()
    if len(dets) != YOLO2_BATCH or not all(
            len(k) <= len(d) and (len(k) > 0) == (len(d) > 0)
            for k, d in zip(kept, dets)):
        fail(f"YOLO2 decode/NMS: {[len(d) for d in dets]} detections, "
             f"{[len(k) for k in kept]} kept")
    flops = forward_flops(net, YOLO2_BATCH)
    call_ms = 1e3 * wall / N_YOLO2_CALLS
    return {
        "model": "YOLO2(608 x 608 x 3, Darknet-19 trunk + passthrough, 80 "
                 "classes, 5 priors), bf16, random weights from the seed",
        "batch": YOLO2_BATCH, "params": net.num_params(),
        "calls": N_YOLO2_CALLS, "launches": launches,
        "wall_ms_per_call": call_ms,
        "images_per_s": YOLO2_BATCH * N_YOLO2_CALLS / wall,
        "synced_ms_per_call": host_ms(torch, lambda: net.output(x),
                                      N_YOLO2_CALLS),
        "forward_gflop_per_call": flops / 1e9,
        "mfu": flops / (call_ms * 1e-3) / BF16_FLOP_PER_S,
        "profile": _profile_summary(by_kernel, prof_wall, N_YOLO2_CALLS,
                                    "call", top_n=10),
        "device_ms_per_call_by_kind": _ms_by_kind(by_kernel, N_YOLO2_CALLS),
        "decode": {"threshold": YOLO2_THRESHOLD, "nms_iou": YOLO2_NMS_IOU,
                   "decode_host_ms": 1e3 * (t1 - t0),
                   "nms_host_ms": 1e3 * (t2 - t1),
                   "detections": sum(len(d) for d in dets),
                   "kept": sum(len(k) for k in kept),
                   "kept_per_image": [len(k) for k in kept]},
        "f32_card_vs_cpu": yolo2_cpu_check(torch, np),
    }, net


def phase_yolo2_training(torch, np, net):
    """YOLO2 fit_batch at B = 16, bf16, Adam 1e-3: 2 warm steps, 10 timed
    ones on a repeated batch, a profiled window that launches none of the
    nine kernels, the FLOPs of a step against the bf16 peak."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    x = _images(torch, SEED + 22, YOLO2_BATCH, 608, 608, torch.bfloat16)
    y = torch.tensor(yolo2_labels(np, SEED + 25, YOLO2_BATCH), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    warm = [float(net.fit_batch((x, y))) for _ in range(N_YOLO2_WARM)]
    timed, launches, _, wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y)) for _ in range(N_YOLO2_STEPS)])
    timed = [float(v) for v in timed]
    losses = warm + timed
    if not all(np.isfinite(losses)):
        fail(f"YOLO2 training losses not finite: {losses}")
    if any(launches.values()):
        fail(f"YOLO2 training launched {launches}; its path runs none of "
             f"the port's kernels")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = 3
    prof_launches = {}

    def window():
        nonlocal prof_launches
        _, prof_launches, _, _ = _count_launches(
            torch, KERNELS, lambda: net.fit_batch((x, y)))

    by_kernel, prof_wall = profile_device(torch, window, steps)
    named = [k for k in by_kernel if any(p in k for p in HAND_KERNEL_NAMES)]
    if any(prof_launches.values()) or named:
        fail(f"YOLO2's profiled steps launched {prof_launches} {named}")
    prof = _profile_summary(by_kernel, prof_wall, steps, "step", top_n=10)
    step_ms = 1e3 * wall / N_YOLO2_STEPS
    flops = 3 * forward_flops(net, YOLO2_BATCH)
    return {
        "model": "YOLO2, bf16, Adam 1e-3",
        "batch": YOLO2_BATCH, "warm_steps": N_YOLO2_WARM,
        "steps": N_YOLO2_STEPS, "losses": losses, "launches": launches,
        "profiled_launches": prof_launches,
        "labels": f"{list(y.shape)}, 1-8 object cells an image",
        "wall_s": wall, "step_wall_ms": step_ms,
        "samples_per_s": YOLO2_BATCH * N_YOLO2_STEPS / wall,
        "peak_memory_gb": peak,
        "step_tflop": flops / 1e12,
        "mfu": flops / (step_ms * 1e-3) / BF16_FLOP_PER_S,
        "mfu_of_device_time": (flops / (prof["device_ms_per_step"] * 1e-3)
                               / BF16_FLOP_PER_S),
        "profile": prof,
        "device_ms_per_step_by_kind": _ms_by_kind(by_kernel, steps),
    }


def _zoo_labels(np, name, model, out_shape, seed):
    """Labels for one zoo model's output shape: YOLO labels for TinyYOLO
    (its grid and classes), a binary map for UNet, one-hot classes for the
    classifiers."""
    rng = np.random.default_rng(seed)
    if name == "TinyYOLO":
        return yolo2_labels(np, seed, out_shape[0], grid=out_shape[1],
                            classes=model.n_classes)
    if name == "UNet":
        return (rng.random(out_shape) > 0.5).astype(np.float32)
    n = out_shape[-1]
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, out_shape[0])]


def phase_zoo(torch, np):
    """Each model of ZOO_MODELS at its default input size and dtype: one
    output() and one fit_batch at B = 2 on the card, then its f32 output()
    at B = 1, card against CPU, at full depth on a cut image side."""
    import deeplearning4j_tpu_torch.zoo as zoo
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    rows = {}
    for i, name in enumerate(ZOO_MODELS):
        cls = getattr(zoo, name)
        model = cls(seed=SEED)
        net = model.init(device="cuda")
        H, W = model.height, model.width
        dt = (torch.bfloat16 if net.conf.dtype in ("bf16", "bfloat16")
              else torch.float32)
        x = _images(torch, SEED + 30 + i, ZOO_BATCH, H, W, dt)
        t0 = time.perf_counter()
        (out, launches_out, _, out_wall) = _count_launches(
            torch, KERNELS, lambda: net.output(x))
        y = torch.tensor(_zoo_labels(np, name, model, tuple(out.shape),
                                     SEED + 40 + i), device="cuda")
        loss, launches_fit, _, fit_wall = _count_launches(
            torch, KERNELS, lambda: net.fit_batch((x, y)))
        loss = float(loss)
        if not (bool(torch.isfinite(out).all()) and np.isfinite(loss)):
            fail(f"{name} on the card: output finite "
                 f"{bool(torch.isfinite(out).all())}, loss {loss}")
        if any(launches_out.values()) or any(launches_fit.values()):
            fail(f"{name} launched {launches_out} {launches_fit}; its path "
                 f"runs none of the port's kernels")
        params, flops = net.num_params(), forward_flops(net, 1)
        del net
        side = H if name == "SimpleCNN" else ZOO_CHECK_SIDE
        small = cls(seed=SEED + 1, height=side, width=side, dtype="float32")
        card = small.init(device="cuda")
        cpu = copy.deepcopy(card).to("cpu")
        xc = _images(torch, SEED + 50 + i, 1, side, side, torch.float32)
        err = _max_rel(card.output(xc), cpu.output(xc.cpu()))
        if not err <= TOL_ZOO_CPU:
            fail(f"f32 {name} at {side} x {side}, card against CPU: "
                 f"{err} (tolerance {TOL_ZOO_CPU}, relative)")
        del card, cpu
        torch.cuda.empty_cache()
        rows[name] = {
            "input": [H, W, 3], "dtype": str(dt).replace("torch.", ""),
            "params": params, "batch": ZOO_BATCH,
            "output_shape": list(out.shape),
            "first_output_ms": 1e3 * out_wall,
            "first_fit_batch_ms": 1e3 * fit_wall, "loss": loss,
            "forward_gflop_per_image": flops / 1e9,
            "f32_check": {"side": side, "batch": 1, "tf32": False,
                          "max_rel_err": err, "tolerance": TOL_ZOO_CPU},
            "wall_s": time.perf_counter() - t0,
        }
    return rows


# ------------------------------------------------------ model-import slice

N_IMPORT_WARM = 2
N_IMPORT_STEPS = 20      # phase 23, bench.py bert_import's lane
N_BERT_TF_CALLS = 5
N_BERT_TF_STEPS = 10     # phase 24
# bert_tiny.onnx against the recorded torch outputs (the JAX test's
# tolerance, tests/test_golden_import.py: rtol = atol = 1e-4)
TOL_GOLDEN = 1e-4
# phase 23: the first bf16 loss of the optimizer-on run against the
# optimizer-off run, relative (both bf16: the rewrite moves the attention
# into one op, so the bf16 roundings fall in other places)
TOL_IMPORT_LOSS = 2e-2
# phase 24: f32 logits and pooled output, card against the CPU and
# optimizer on against off, relative to the largest value
TOL_BERT_TF = 1e-4


def _fixture(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", name)


# A protobuf writer for TF's GraphDef wire format (the subset
# modelimport/tensorflow.py reads): NodeDef name=1 op=2 input=3 attr=5;
# AttrValue list=1 s=2 i=3 f=4 b=5 type=6 shape=7 tensor=8; TensorProto
# dtype=1 tensor_shape=2 tensor_content=4.

def _pb_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_int(field: int, v: int) -> bytes:
    return _pb_varint(field << 3) + _pb_varint(v & ((1 << 64) - 1))


def _pb_shape(dims) -> bytes:
    return b"".join(_pb_len(2, _pb_int(1, int(d))) for d in dims)


_PB_DTYPES = {"float32": 1, "int32": 3, "int64": 9}


def _pb_tensor(arr) -> bytes:
    return (_pb_int(1, _PB_DTYPES[str(arr.dtype)])
            + _pb_len(2, _pb_shape(arr.shape))
            + _pb_len(4, arr.tobytes()))


def _pb_attr(key: str, *, tensor=None, i=None, f=None, b=None, type_=None,
             ints=None, shape=None, s=None) -> bytes:
    val = b""
    if tensor is not None:
        val += _pb_len(8, _pb_tensor(tensor))
    if s is not None:
        val += _pb_len(2, s.encode())
    if i is not None:
        val += _pb_int(3, i)
    if f is not None:
        import struct
        val += _pb_varint((4 << 3) | 5) + struct.pack("<f", f)
    if b is not None:
        val += _pb_int(5, int(b))
    if type_ is not None:
        val += _pb_int(6, type_)
    if shape is not None:
        val += _pb_len(7, _pb_shape(shape))
    if ints is not None:
        val += _pb_len(1, b"".join(_pb_int(3, v) for v in ints))
    return _pb_len(5, _pb_len(1, key.encode()) + _pb_len(2, val))


def _pb_node(name: str, op: str, inputs=(), *attrs) -> bytes:
    return _pb_len(1, _pb_len(1, name.encode()) + _pb_len(2, op.encode())
                   + b"".join(_pb_len(3, i.encode()) for i in inputs)
                   + b"".join(attrs))


def bert_graph_def(layers=12, hidden=768, heads=12, intermediate=3072,
                   vocab=30522, type_vocab=2, max_pos=512, batch=32, seq=128,
                   num_labels=2, seed=SEED) -> bytes:
    """A BERT sequence classifier as a frozen TF GraphDef, in the op
    pattern of google-research/bert ``modeling.py`` (``BertModel``) and
    ``run_classifier.py``'s head: GatherV2 word embeddings, OneHot + MatMul
    token-type embeddings, sliced position embeddings, LayerNorm as
    ``tf.nn.moments`` + ``batch_normalization`` (Mean / StopGradient /
    SquaredDifference / Rsqrt, eps 1e-12), the dense layers on the
    [B*T, hidden] matrix with BiasAdd, heads by Reshape + Transpose, scores
    by BatchMatMulV2(adj_y) x 1/sqrt(head dim) + (1 - mask) * -10000,
    Softmax, GELU in its tanh form, the [CLS] pooler by StridedSlice +
    MatMul + Tanh, and a hidden -> num_labels classifier (MatMul with
    transpose_b, BiasAdd): the output "logits". Placeholders ``input_ids``,
    ``input_mask`` and ``segment_ids`` are int32 [batch, seq] with static
    shapes; the reshapes take -1 for the batch, so one graph runs at any
    batch. Weights N(0, 0.02) from ``seed``, biases 0, LayerNorm gamma 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dh = hidden // heads
    nodes = []

    def const(name, arr):
        nodes.append(_pb_node(name, "Const", (), _pb_attr("value",
                                                          tensor=arr)))
        return name

    def weight(name, shape):
        return const(name, rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(0.02))

    def op(name, kind, inputs, *attrs):
        nodes.append(_pb_node(name, kind, inputs, *attrs))
        return name

    def ints(name, v):
        return const(name, np.asarray(v, np.int32))

    def scalar(name, v):
        return const(name, np.asarray(v, np.float32))

    for name in ("input_ids", "input_mask", "segment_ids"):
        op(name, "Placeholder", (), _pb_attr("dtype", type_=3),
           _pb_attr("shape", shape=(batch, seq)))
    c = "bert/constants/"
    one, half = scalar(c + "one", 1.0), scalar(c + "half", 0.5)
    eps, neg = scalar(c + "eps", 1e-12), scalar(c + "neg", -10000.0)
    three = scalar(c + "three", 3.0)
    gelu_a = scalar(c + "gelu_a", 0.044715)
    gelu_s = scalar(c + "gelu_s", float(np.sqrt(2.0 / np.pi)))
    scale = scalar(c + "scale", 1.0 / float(np.sqrt(dh)))
    flat, axis0 = ints(c + "flat", [-1]), ints(c + "axis0", 0)
    last = ints(c + "last_axis", [-1])
    mat, seq3 = ints(c + "matrix", [-1, hidden]), ints(c + "seq3",
                                                         [-1, seq, hidden])
    split_heads = ints(c + "heads", [-1, seq, heads, dh])
    perm = ints(c + "perm", [0, 2, 1, 3])
    keep = _pb_attr("keep_dims", b=True)

    def layer_norm(x, p):
        gamma = const(p + "/gamma", np.ones(hidden, np.float32))
        beta = const(p + "/beta", np.zeros(hidden, np.float32))
        mean = op(p + "/moments/mean", "Mean", (x, last), keep)
        sg = op(p + "/moments/StopGradient", "StopGradient", (mean,))
        sqd = op(p + "/moments/SquaredDifference", "SquaredDifference",
                 (x, sg))
        var = op(p + "/moments/variance", "Mean", (sqd, last), keep)
        rs = op(p + "/batchnorm/Rsqrt", "Rsqrt",
                (op(p + "/batchnorm/add", "AddV2", (var, eps)),))
        inv = op(p + "/batchnorm/mul", "Mul", (rs, gamma))
        xi = op(p + "/batchnorm/mul_1", "Mul", (x, inv))
        mi = op(p + "/batchnorm/mul_2", "Mul", (mean, inv))
        sub = op(p + "/batchnorm/sub", "Sub", (beta, mi))
        return op(p + "/batchnorm/add_1", "AddV2", (xi, sub))

    def dense(x, p, n_in, n_out):
        w = weight(p + "/kernel", (n_in, n_out))
        b = const(p + "/bias", np.zeros(n_out, np.float32))
        return op(p + "/BiasAdd", "BiasAdd",
                  (op(p + "/MatMul", "MatMul", (x, w)), b))

    # embeddings
    e = "bert/embeddings/"
    table = weight(e + "word_embeddings", (vocab, hidden))
    ids = op(e + "flat_ids", "Reshape", ("input_ids", flat))
    word = op(e + "word", "Reshape", (
        op(e + "GatherV2", "GatherV2", (table, ids, axis0)), seq3))
    tt_table = weight(e + "token_type_embeddings", (type_vocab, hidden))
    tt = op(e + "flat_token_type_ids", "Reshape", ("segment_ids", flat))
    oh = op(e + "one_hot", "OneHot", (tt, ints(e + "depth", type_vocab),
                                      scalar(e + "on", 1.0),
                                      scalar(e + "off", 0.0)),
            _pb_attr("axis", i=-1))
    tte = op(e + "token_type", "Reshape", (
        op(e + "MatMul", "MatMul", (oh, tt_table)), seq3))
    pos = op(e + "Slice", "Slice", (
        weight(e + "position_embeddings", (max_pos, hidden)),
        ints(e + "slice_begin", [0, 0]), ints(e + "slice_size", [seq, -1])))
    pos = op(e + "position", "Reshape", (pos, ints(e + "pos_shape",
                                                   [1, seq, hidden])))
    x = op(e + "add_1", "AddV2", (op(e + "add", "AddV2", (word, tte)), pos))
    x = op("bert/encoder/Reshape", "Reshape",
           (layer_norm(x, e + "LayerNorm"), mat))
    # the attention mask, [B, 1, T] as float (create_attention_mask_from_
    # input_mask without its broadcast over the query axis)
    mask = op("bert/encoder/Cast", "Cast", (
        op("bert/encoder/mask", "Reshape", (
            "input_mask", ints("bert/encoder/mask_shape", [-1, 1, seq]))),),
        _pb_attr("DstT", type_=1))
    for i in range(layers):
        p = f"bert/encoder/layer_{i}"
        a = p + "/attention/self"

        def split(t, n):
            r = op(f"{a}/{n}_reshape", "Reshape", (t, split_heads))
            return op(f"{a}/{n}_transpose", "Transpose", (r, perm))

        q = split(dense(x, a + "/query", hidden, hidden), "q")
        k = split(dense(x, a + "/key", hidden, hidden), "k")
        v = split(dense(x, a + "/value", hidden, hidden), "v")
        scores = op(a + "/MatMul", "BatchMatMulV2", (q, k),
                    _pb_attr("adj_y", b=True))
        scores = op(a + "/Mul", "Mul", (scores, scale))
        m = op(a + "/ExpandDims", "ExpandDims", (
            mask, ints(a + "/expand_axis", 1)))
        adder = op(a + "/mul_1", "Mul", (op(a + "/sub", "Sub", (one, m)),
                                         neg))
        probs = op(a + "/Softmax", "Softmax",
                   (op(a + "/add", "AddV2", (scores, adder)),))
        ctx = op(a + "/MatMul_1", "BatchMatMulV2", (probs, v))
        ctx = op(a + "/context", "Reshape", (
            op(a + "/transpose_3", "Transpose", (ctx, perm)), mat))
        att = dense(ctx, p + "/attention/output/dense", hidden, hidden)
        att = layer_norm(op(p + "/attention/output/add", "AddV2", (att, x)),
                         p + "/attention/output/LayerNorm")
        h = dense(att, p + "/intermediate/dense", hidden, intermediate)
        g = p + "/intermediate/gelu"
        inner = op(g + "/add", "AddV2", (h, op(g + "/mul", "Mul", (
            gelu_a, op(g + "/Pow", "Pow", (h, three))))))
        cdf = op(g + "/mul_2", "Mul", (half, op(g + "/add_1", "AddV2", (
            one, op(g + "/Tanh", "Tanh", (
                op(g + "/mul_1", "Mul", (gelu_s, inner)),))))))
        h = op(g + "/mul_3", "Mul", (h, cdf))
        out = dense(h, p + "/output/dense", intermediate, hidden)
        x = layer_norm(op(p + "/output/add", "AddV2", (out, att)),
                       p + "/output/LayerNorm")
    seq_out = op("bert/encoder/Reshape_last", "Reshape", (x, seq3))
    cls = op("bert/pooler/strided_slice", "StridedSlice", (
        seq_out, ints("bert/pooler/begin", [0, 0]),
        ints("bert/pooler/end", [0, 1]), ints("bert/pooler/strides", [1, 1])),
        _pb_attr("begin_mask", i=1), _pb_attr("end_mask", i=1),
        _pb_attr("shrink_axis_mask", i=2))
    pooled = op("bert/pooler/dense/Tanh", "Tanh",
                (dense(cls, "bert/pooler/dense", hidden, hidden),))
    w = weight("output_weights", (num_labels, hidden))
    b = const("output_bias", np.zeros(num_labels, np.float32))
    op("logits", "BiasAdd", (op("MatMul", "MatMul", (pooled, w),
                                _pb_attr("transpose_b", b=True)), b))
    return b"".join(nodes)


# bert_graph_def's pooled output (the classifier's input)
BERT_POOLED = "bert/pooler/dense/Tanh"


def lrn_graph_def(shape, conv=False, depth_radius=2, bias=2.0, alpha=1e-4,
                  beta=0.75, seed=SEED) -> bytes:
    """Placeholder ``x`` (float32, ``shape``, NHWC) -> [a 1x1 Conv2D, C to
    C, weights N(0, 1/C) from ``seed``] -> TF's LRN, output "lrn". TF's
    alpha multiplies the window sum directly, as the LRN layer's does, so
    AlexNet's LRN (depth 5, k 2, alpha 1e-4, beta 0.75) is depth_radius
    2, bias 2, alpha 1e-4, beta 0.75."""
    import numpy as np

    C = shape[-1]
    nodes = [_pb_node("x", "Placeholder", (), _pb_attr("dtype", type_=1),
                      _pb_attr("shape", shape=shape))]
    x = "x"
    if conv:
        w = np.random.default_rng(seed).standard_normal(
            (1, 1, C, C), dtype=np.float32) / np.float32(np.sqrt(C))
        nodes.append(_pb_node("w", "Const", (), _pb_attr("value", tensor=w)))
        nodes.append(_pb_node("conv", "Conv2D", ("x", "w"),
                              _pb_attr("strides", ints=[1, 1, 1, 1]),
                              _pb_attr("padding", s="SAME")))
        x = "conv"
    nodes.append(_pb_node("lrn", "LRN", (x,),
                          _pb_attr("depth_radius", i=depth_radius),
                          _pb_attr("bias", f=bias), _pb_attr("alpha", f=alpha),
                          _pb_attr("beta", f=beta)))
    return b"".join(nodes)


def _close(torch, got, want, rtol, atol):
    """(max abs error, |got - want| <= atol + rtol |want| everywhere)."""
    got = torch.as_tensor(got).float().cpu()
    want = torch.as_tensor(want).float().cpu()
    err = float((got - want).abs().max())
    return err, bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _rel_err(torch, got, want):
    """max |got - want| over max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / float(want.abs().max())


def phase_onnx_golden(torch, np):
    """bert_tiny.onnx imported onto the card with the import-graph
    optimizer on and off, both outputs against the recorded torch
    outputs."""
    from deeplearning4j_tpu_torch.modelimport import OnnxModelImport
    from deeplearning4j_tpu_torch.modelimport.optimizer import graph_signature

    g = np.load(_fixture("bert_golden.npz"))
    feeds = {"input_ids": g["ids"], "attention_mask": g["mask"]}
    out = {}
    for opt in (True, False):
        t0 = time.perf_counter()
        imp = OnnxModelImport.import_model(_fixture("bert_tiny.onnx"),
                                           optimize=opt)
        import_s = time.perf_counter() - t0
        lh, po = imp.output(feeds, ["last_hidden_state", "pooler_output"])
        if lh.device.type != "cuda" or po.device.type != "cuda":
            fail(f"bert_tiny.onnx output() on {lh.device}, {po.device}; the "
                 f"import's default device is the card")
        el, okl = _close(torch, lh, g["last_hidden"], TOL_GOLDEN, TOL_GOLDEN)
        ep, okp = _close(torch, po, g["pooler"], TOL_GOLDEN, TOL_GOLDEN)
        if not (okl and okp) or tuple(po.shape) != g["pooler"].shape:
            fail(f"bert_tiny.onnx (optimizer {'on' if opt else 'off'}) on "
                 f"the card against the golden: last_hidden {el}, pooler "
                 f"{ep} (rtol = atol = {TOL_GOLDEN}), pooler shape "
                 f"{tuple(po.shape)}")
        out["on" if opt else "off"] = {
            "nodes": graph_signature(imp)[0], "import_s": import_s,
            "rewrites": imp.import_opt_stats,
            "last_hidden_max_abs_err": el, "pooler_max_abs_err": ep}
    stats = out["on"]["rewrites"]
    if stats["fuse_attention"] != 2:
        fail(f"bert_tiny.onnx: the optimizer fused {stats['fuse_attention']} "
             f"attention blocks; want 2")
    return out


def _adam_steps(torch, loss_fn, params, lr, steps):
    """``steps`` Adam steps on the f32 master ``params`` (a tree of card
    tensors); returns (params, [loss tensors])."""
    from deeplearning4j_tpu_torch.common.trees import (
        tree_leaves, tree_map, tree_unflatten,
    )
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    updater = Adam(lr=lr)
    state = updater.init_state(params)
    losses = []
    for i in range(steps):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        with torch.no_grad():
            upd, state = updater.update(tree_unflatten(params, list(grads)),
                                        state, params, i)
            params = tree_map(lambda p, u: p - u, params, upd)
        losses.append(loss.detach())
    return params, losses


def _import_train(torch, np, loss_fn, params, lr, warm, steps, profile=2):
    """``warm`` then ``steps`` timed Adam steps, then a profiled window of
    ``profile`` steps; returns a summary with the losses (floats)."""
    params, warm_losses = _adam_steps(torch, loss_fn, params, lr, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = _adam_steps(torch, loss_fn, params, lr, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_kernel, prof_wall = profile_device(
        torch, lambda: _adam_steps(torch, loss_fn, params, lr, 1), profile)
    losses = [float(v) for v in warm_losses + losses]
    if not all(np.isfinite(losses)):
        fail(f"import fine-tuning losses not finite: {losses}")
    return {"losses": losses, "steps": steps, "wall_s": wall,
            "step_wall_ms": 1e3 * wall / steps,
            "profile": _profile_summary(by_kernel, prof_wall, profile,
                                        "step")}


def phase_bert_import_training(torch, np):
    """bench.py's bert_import lane at its own shape: bert_tiny.onnx's
    ``as_trainable(compute_dtype=bfloat16)`` under torch.func.vmap over 128
    outer x [2, 16] (256 samples a step), a 64 -> 2 head, cross-entropy,
    Adam(lr=2e-5) on f32 masters; 2 + 20 steps with the optimizer on, then
    off."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating
    from deeplearning4j_tpu_torch.modelimport import OnnxModelImport
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    BO, BI, T, V, C = 128, 2, 16, 500, 2   # bench.py:1035-1041
    B = BO * BI
    rng = np.random.default_rng(SEED)
    ids = torch.as_tensor(rng.integers(0, V, (B, T)).astype(np.int32),
                          device="cuda").reshape(BO, BI, T)
    feeds = {"input_ids": ids,
             "attention_mask": torch.ones((BO, BI, T), dtype=torch.int32,
                                          device="cuda")}
    y = torch.as_tensor(np.eye(C, dtype=np.float32)[rng.integers(0, C, B)],
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    head = {"W": torch.randn((64, C), device="cuda", generator=g) * 0.05,
            "b": torch.zeros(C, device="cuda")}
    out = {"shape": f"{BO} outer x [{BI}, {T}] (vmap), {B} samples a step",
           "model": "bert_tiny.onnx (transformers BertModel, 2 x 64, 4 "
                    "heads, vocab 500), bf16 compute, f32 masters, "
                    "Adam 2e-5"}
    for opt in (True, False):
        imp = OnnxModelImport.import_model(_fixture("bert_tiny.onnx"),
                                           optimize=opt)
        fn, bert = imp.as_trainable(outputs=["pooler_output"],
                                    compute_dtype=torch.bfloat16)

        def loss_fn(p, fn=fn):
            cp = cast_floating(p, torch.bfloat16)
            pooled = torch.func.vmap(lambda f: fn(cp["bert"], f))(feeds)
            logits = (pooled.reshape(B, 64) @ cp["head"]["W"]
                      + cp["head"]["b"]).float()
            return -(y * torch.log_softmax(logits, -1)).sum(-1).mean()

        params = {"bert": bert, "head": {k: v.clone()
                                         for k, v in head.items()}}
        run, launches, _, _ = _count_launches(
            torch, KERNELS, lambda: _import_train(
                torch, np, loss_fn, params, 2e-5, N_IMPORT_WARM,
                N_IMPORT_STEPS))
        if any(launches.values()):
            fail(f"bert_tiny fine-tuning launched {launches}; its attention "
                 f"carries the exporter's mask as a bias, which no kernel of "
                 f"the port takes")
        run["samples_per_s"] = B / (run["step_wall_ms"] / 1e3)
        run["nodes"] = len(imp.nodes)
        run["rewrites"] = imp.import_opt_stats
        out["on" if opt else "off"] = run
    a, b = out["on"]["losses"][0], out["off"]["losses"][0]
    if abs(a - b) > TOL_IMPORT_LOSS * abs(b):
        fail(f"bert_import: first loss with the optimizer on {a}, off {b} "
             f"(rel tol {TOL_IMPORT_LOSS})")
    return out


def phase_bert_tf_import(torch, np, zoo_step_ms):
    """BERT-base (12 x 768, 12 heads, 3072, vocab 30522) built as a frozen
    TF GraphDef and imported onto the card: f32 output() at B=2 against
    the same graph on the CPU and against the optimizer off; 5 output()
    calls at [32, 128]; 2 + 10 bf16 fine-tuning steps through
    as_trainable. ``zoo_step_ms`` is phase 11's BertBase step."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating
    from deeplearning4j_tpu_torch.modelimport import TFGraphMapper
    from deeplearning4j_tpu_torch.modelimport.tensorflow import parse_graph
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    B, T = 32, 128
    t0 = time.perf_counter()
    gd = bert_graph_def(batch=B, seq=T)
    build_s = time.perf_counter() - t0
    graph_bytes = len(gd)
    t0 = time.perf_counter()
    nodes_raw = len(parse_graph(gd)[0])
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imp = TFGraphMapper.import_graph(gd)
    import_s = time.perf_counter() - t0
    stats = imp.import_opt_stats
    if stats["fuse_attention"] != 12:
        fail(f"BERT-base GraphDef: the optimizer fused "
             f"{stats['fuse_attention']} attention blocks; want 12")
    n_params = sum(int(np.prod(v.shape)) for v in imp.constants.values()
                   if v.dtype == np.float32 and v.ndim >= 1 and v.size > 1)

    rng = np.random.default_rng(SEED + 13)

    def batch(b):
        lens = rng.integers(T // 2, T + 1, b)
        return {"input_ids": rng.integers(0, 30522, (b, T)).astype(np.int32),
                "input_mask": (np.arange(T)[None, :] < lens[:, None]
                               ).astype(np.int32),
                "segment_ids": (np.arange(T)[None, :] >= lens[:, None] // 2
                                ).astype(np.int32)}

    small = batch(2)
    outs = ["logits", BERT_POOLED]
    card = imp.output(small, outs)
    cpu = TFGraphMapper.import_graph(gd, device="cpu").output(small, outs)
    off = TFGraphMapper.import_graph(gd, optimize=False).output(small, outs)
    errs = {"card_vs_cpu": max(_rel_err(torch, a, b)
                               for a, b in zip(card, cpu)),
            "on_vs_off": max(_rel_err(torch, a, b) for a, b in zip(card, off))}
    if max(errs.values()) > TOL_BERT_TF:
        fail(f"BERT-base GraphDef f32 at B=2: {errs} (relative to the "
             f"largest value, tol {TOL_BERT_TF})")
    del cpu, off, gd

    big = batch(B)
    imp.output(big)  # warm-up, not counted
    calls, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: [imp.output(big) for _ in range(
            N_BERT_TF_CALLS)])
    logits = calls[-1]
    if tuple(logits.shape) != (B, 2) or not bool(torch.isfinite(logits).all()):
        fail(f"BERT-base GraphDef output() gave {tuple(logits.shape)}, "
             f"finite {bool(torch.isfinite(logits).all())}")
    if any(launches.values()):
        fail(f"BERT-base GraphDef output() launched {launches}; its fused "
             f"attention carries the mask as a bias (plain lowering)")
    by_kernel, prof_wall = profile_device(torch, lambda: imp.output(big), 2)
    inference = {"calls": N_BERT_TF_CALLS,
                 "ms_per_call": 1e3 * wall / N_BERT_TF_CALLS,
                 "profile": _profile_summary(by_kernel, prof_wall, 2, "call")}

    fn, params = imp.as_trainable(outputs=["logits"],
                                  compute_dtype=torch.bfloat16)
    y = torch.as_tensor(np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)],
                        device="cuda")
    feeds = {k: torch.as_tensor(v, device="cuda") for k, v in big.items()}

    def loss_fn(p):
        logits = fn(cast_floating(p, torch.bfloat16), feeds).float()
        return -(y * torch.log_softmax(logits, -1)).sum(-1).mean()

    run, launches, _, _ = _count_launches(
        torch, KERNELS, lambda: _import_train(
            torch, np, loss_fn, params, 2e-5, N_IMPORT_WARM,
            N_BERT_TF_STEPS))
    if any(launches.values()):
        fail(f"BERT-base GraphDef fine-tuning launched {launches}")
    run["samples_per_s"] = B / (run["step_wall_ms"] / 1e3)
    run["step_ms_over_zoo_bertbase_step_ms"] = (run["step_wall_ms"]
                                                / zoo_step_ms)
    return {
        "model": "BERT-base as a frozen TF GraphDef (modeling.py's op "
                 "pattern): 12 x 768, 12 heads x 64, 3072, vocab 30522, "
                 "type vocab 2, 512 positions, 768 -> 2 classifier; "
                 "weights N(0, 0.02) from the seed",
        "params": n_params, "graph_bytes": graph_bytes,
        "build_s": build_s, "parse_s": parse_s, "import_s": import_s,
        "nodes_raw": nodes_raw, "nodes": len(imp.order), "rewrites": stats,
        "f32_b2_max_rel_err": errs,
        "inference": inference,
        "training": dict(run, batch=B, timesteps=T,
                         optimizer="Adam 2e-5, f32 masters, bf16 compute"),
        "zoo_bertbase_step_wall_ms": zoo_step_ms,
        "deltas_from_zoo_bertbase": "token-type embeddings (OneHot + "
        "MatMul), tanh pooler + classifier instead of the zoo's pooled "
        "output layer, plain attention (the mask is a bias: no flash "
        "kernel) against flash, Adam against AdamW on a warmup-cosine "
        "schedule with clipping 1.0, no dropout against 0.1",
    }


def phase_tf_import_lrn(torch, np):
    """TF LRN through import: a [128, 54, 54, 96] Placeholder -> LRN graph
    (AlexNet's conv1 LRN) whose output() launches the LRN forward kernel
    once (a profiled window names it) and equals the plain ``lrn``
    lowering; a variant with a 1x1 Conv2D in front, through as_trainable,
    whose sum loss's backward launches the LRN backward kernel once."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.modelimport import TFGraphMapper
    from deeplearning4j_tpu_torch.ops.convolution import lrn as plain_lrn
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    shape = (ALEXNET_BATCH, 54, 54, 96)
    hp = dict(depth=5, k=2.0, alpha=1e-4, beta=0.75)
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x = 2.0 * torch.randn(shape, device="cuda", generator=g)
    imp = TFGraphMapper.import_graph(lrn_graph_def(shape))
    y, fwd_launches, _, _ = _count_launches(
        torch, KERNELS, lambda: imp.output({"x": x}, ["lrn"]))
    if fwd_launches != _only(KERNELS, lrn_fwd=1):
        fail(f"imported TF LRN output() launched {fwd_launches}; want one "
             f"LRN forward")
    # the device's own record: a window of 10 calls must name the LRN
    # forward kernel and no other kernel of the port. Its count is read
    # from the launch counters: at this point of the full run a profiler
    # session drops the first records of its window (7 of 10 kept on an
    # H100, or none; all of them in a process that runs this phase alone),
    # which the lead-in (_lead_in) takes; the window is still profiled
    # again while it falls short, and then taken as it is.
    calls = 10

    def call():
        return imp.output({"x": x}, ["lrn"])

    _, n_launched, _, _ = _count_launches(
        torch, KERNELS, lambda: [call() for _ in range(calls)])
    by_kernel, _, seen = profile_showing(torch, call, calls,
                                         {"lrn_fwd_kernel": 1}, tries=5)
    # the device names of the port's kernels (csrc/*.cu)
    port = sorted(k for k in by_kernel
                  if any(t in k for t in ("lstm_", "gru_", "flash_", "lrn_")))
    err, ok = _lrn_within(torch, y, plain_lrn(x, **hp), torch.float32,
                          TOL_LRN_FWD)
    if (not ok or n_launched != _only(KERNELS, lrn_fwd=calls)
            or not 0 < seen["lrn_fwd_kernel"] <= calls
            or any("lrn_fwd_kernel" not in k for k in port)):
        fail(f"imported TF LRN: error against the plain lrn {err}; {calls} "
             f"calls launched {n_launched}; the profiler saw "
             f"{seen['lrn_fwd_kernel']} lrn_fwd_kernel records and the "
             f"port's kernels {port}")

    conv = TFGraphMapper.import_graph(lrn_graph_def(shape, conv=True))
    fn, params = conv.as_trainable(outputs=["lrn"])

    def grad():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        return torch.autograd.grad(fn(p, {"x": x}).sum(), list(p.values()))

    (gw,), train_launches, _, _ = _count_launches(torch, KERNELS, grad)
    if train_launches != _only(KERNELS, lrn_fwd=1, lrn_bwd=1):
        fail(f"imported conv + LRN, one as_trainable step launched "
             f"{train_launches}; want one LRN forward and one backward")
    env.disable_kernels = True
    try:
        (gp,) = grad()
    finally:
        env.reload()
    grad_rel = _rel_err(torch, gw, gp)
    if grad_rel > TOL_GRAD:
        fail(f"imported conv + LRN: the weight gradient through the kernels "
             f"against the plain path {grad_rel} > {TOL_GRAD}")
    launches = {k: fwd_launches[k] + train_launches[k] for k in fwd_launches}
    return {"shape": list(shape), "lrn": "depth_radius 2, bias 2, alpha 1e-4, "
            "beta 0.75 (AlexNet's)", "output_launches": fwd_launches,
            "train_launches": train_launches, "launches": launches,
            "output_max_abs_err_vs_plain": err,
            "profiled_window": {"calls": calls,
                                "lrn_fwd_kernel_records":
                                    seen["lrn_fwd_kernel"],
                                "port_kernels": port},
            "conv_weight_grad_rel_err_vs_plain": grad_rel}


# ------------------------------------------------ phases 29-31: transformers
# bench.py's decode lane (bench.py:2226-2236): d 256, 8 heads, 4 causal
# layers, vocabulary 512, max_len 96, f32, seed 1
LANE = dict(d=256, heads=8, layers=4, vocab=512, max_len=96)
LANE_SEED = 1
# a causal LM at zoo BertBase's widths (zoo/bert.py:32-38 of the JAX
# package) with BERT's 512-position table, bf16
FULL_LM = dict(d=768, heads=12, layers=12, vocab=30522, max_len=512,
               d_ff=3072)
TOL_LANE_PROB = 1e-2     # bench.py's int8 lane: post-softmax max difference
TOL_LM_CPU_REL = 1e-5    # f32 card against the CPU, and against recompute
# phase 30, the replayed graph's greedy tokens against the full causal
# recompute: the least share that are a top-1 token of the recompute (a
# row whose largest bf16 logit two tokens share exactly has both as its
# top-1; the strict argmax-index agreement is printed beside it). bf16:
# the contract's 0.98; int8: under the 0.975-0.977 read on the H100
TOP1_FULL = {"bf16": 0.98, "int8": 0.96}
# ... and the largest logit difference of the replay from the recompute.
# Read on the H100: 0.031-0.043 where sound, 0.156-0.172 with the middle
# layer's ring left stale (0.30-0.31 the first layer's), which must fail
# it (stale_ring_control)
TOL_FULL_LOGIT = {"bf16": 0.08, "int8": 0.08}
N_LANE_ACC_STEPS = 32    # bench.py: t = 11 .. 42
N_TEACHER_STEPS = 16
N_DECODE_PROFILE = 20
SESSION_RING = 32        # phase 31: the adapter's ring, under max_len 96
SESSION_KILLS = (3, 12, 30)   # 30: every prompt + 30 > 32, past the wrap
SESSION_NEW = 40


def lm_conf(d, heads, layers, vocab, max_len, d_ff=None, dtype="float32",
            seed=SEED):
    """bench.py's decode-lane stack: EmbeddingSequence -> Positional ->
    ``layers`` x causal TransformerEncoder (dropout 0) -> RnnOutput
    softmax."""
    from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        EmbeddingSequenceLayer, RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        PositionalEmbeddingLayer, TransformerEncoderLayer,
    )

    b = (NeuralNetConfiguration.builder().seed(seed).data_type(dtype).list()
         .layer(EmbeddingSequenceLayer(n_out=d, n_in=vocab))
         .layer(PositionalEmbeddingLayer(max_len=max_len)))
    for _ in range(layers):
        b = b.layer(TransformerEncoderLayer(d_model=d, n_heads=heads,
                                            d_ff=d_ff, causal=True))
    return (b.layer(RnnOutputLayer(n_out=vocab, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.recurrent(vocab, 16)).build())


def lm_net(torch, device="cuda", **kw):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(lm_conf(**kw)).init(device=device)


def teacher_forced(torch, ad, net, seq, n0, steps, stale=()):
    """Cached decode against the full causal recompute, teacher-forced:
    prefill ``seq[:n0 - 1]``, then ``steps`` decode steps feeding seq[t] at
    position t from t = n0 - 1. The rings of the layers in ``stale`` are
    put back after each step, as a decode that never kept a step's K/V
    there would leave them (a control the accuracy gates must catch).
    Returns (decode logits, the same rows of the net's full causal forward
    over the sequence), [steps, V] f32."""
    dev = net.device
    caches = ad.prefill(torch.as_tensor([seq[:n0 - 1]], device=dev), n0 - 1)
    got = []
    for t in range(n0 - 1, n0 - 1 + steps):
        kept = {i: [c.clone() for c in caches[i]] for i in stale}
        logits, caches = ad.decode(
            caches, torch.as_tensor([seq[t]], device=dev),
            torch.full((1,), t, dtype=torch.long, device=dev))
        for i, old in kept.items():
            for c, o in zip(caches[i], old):
                c.copy_(o)
        got.append(logits[0])
    x = torch.as_tensor([seq[:n0 - 1 + steps]], device=dev)
    with torch.no_grad():
        pre = net._forward(net._compute_params(), net.state, x, None)[0]
    return torch.stack(got), pre[0, n0 - 1:].float()


def _rel(torch, got, want):
    return float((got - want).abs().max() / want.abs().max())


def _record_greedy(eng, record):
    """A stand-in for ``eng.decode_pool`` that also keeps, for every live
    greedy slot, (its stream, its position, a copy of its logits row): the
    replayed graph's own logits, with the pool's slots live."""
    inner = eng.decode_pool

    def decode_pool():
        logits = inner()
        pool = eng.pool
        rows = [s for s in pool.active_slots() if pool.temps[s] == 0]
        if rows:
            kept = logits[rows].clone()
            record.extend((pool.meta[s], int(pool.pos[s]), kept[j])
                          for j, s in enumerate(rows))
        return logits

    return decode_pool


def _serve_lm(torch, np, eng, reqs, layers, what, record=None):
    """Drive ``reqs`` through a warmed-up attention engine (_engine_launches:
    a timed run, then the counted run); every stream must reach its budget,
    every decode step replay the one graph, and the prefills launch exactly
    one flash forward a layer and no other kernel, as the profiler counts
    them. With a list ``record``, the counted run keeps the greedy slots'
    logits there (_record_greedy). Returns the streams and a summary."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    def serve(counted):
        if counted and record is not None:
            record.clear()
            eng.decode_pool = _record_greedy(eng, record)
        try:
            out = [eng.submit(r.pop("prompt"), **r) for r in
                   [dict(q) for q in reqs]]
            eng.drain()
        finally:
            eng.__dict__.pop("decode_pool", None)
        return out

    run = _engine_launches(torch, eng, KERNELS, serve, what=what)
    streams, launches = run["streams"], run["launches"]
    decode_steps, replays, wall = run["steps"], run["replays"], run["wall_s"]
    _check_replays(eng, decode_steps, what)
    n_prefill = sum(1 for r in reqs if len(r["prompt"]) > 1)
    want = _only(KERNELS, flash_attention_fwd=layers * n_prefill)
    if launches != want:
        fail(f"{what} launched {launches} in {decode_steps} decode steps "
             f"and {n_prefill} prefills; want {want}")
    for i, (s, r) in enumerate(zip(streams, reqs)):
        if s.finish_reason != "length" or len(s.tokens) != r["max_new_tokens"]:
            fail(f"{what}: request {i} finished {s.finish_reason} with "
                 f"{len(s.tokens)}/{r['max_new_tokens']} tokens")
    n_tokens = sum(len(s.tokens) for s in streams)
    ttft = [s.first_token_at - s.submitted_at for s in run["timed"]]
    return streams, {
        "requests": len(reqs), "tokens": n_tokens,
        "decode_steps": decode_steps, "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "decode_programs": eng.decode_programs,
        "prefill_programs": eng.prefill_programs, "replays": replays,
        "capture_launches": eng.capture_launches,
        "flash_fwd_launches": launches["flash_attention_fwd"],
        "prefills": n_prefill, "launches": launches,
        "host_launches": run["host_launches"]}


def phase_lane_serving(torch, np):
    """bench.py's decode lane at its own shape on the card: the f32 ring
    against the int8 ring through the engine (tokens/s), then the lane's
    accuracy contract; then an f32 copy on the CPU (greedy tokens, and
    decode logits through a ring wrap)."""
    from deeplearning4j_tpu_torch.generation import (
        AttentionDecodeAdapter, GenerationEngine,
    )

    net = lm_net(torch, seed=LANE_SEED, **LANE)
    V, L = LANE["vocab"], LANE["max_len"]
    rng = np.random.default_rng(SEED)
    lens, news = rng.integers(4, 16, N_REQUESTS), rng.integers(12, 40,
                                                               N_REQUESTS)
    prompts = [rng.integers(0, V, int(n)).tolist() for n in lens]
    reqs = [dict(prompt=p, max_new_tokens=int(m), temperature=0.8, top_k=40,
                 seed=i) for i, (p, m) in enumerate(zip(prompts, news))]
    out, engines = {"model": f"causal LM d {LANE['d']}, {LANE['layers']} "
                    f"layers, {LANE['heads']} heads, vocab {V}, f32",
                    "slots": 8, "max_len": L}, {}
    for kv in (None, "int8"):
        eng = GenerationEngine(net, slots=8, max_len=L, kv_dtype=kv,
                               device="cuda")
        for p in prompts:   # bench.py's untimed pass: captures the graph
            eng.submit(p, max_new_tokens=2)
        eng.drain()
        _, out[kv or "f32"] = _serve_lm(
            torch, np, eng, reqs, LANE["layers"],
            f"bench-lane serving ({kv or 'f32'} ring)")
        engines[kv] = eng
    out["int8_speedup"] = out["int8"]["tokens_per_s"] / out["f32"][
        "tokens_per_s"]

    # the lane's accuracy contract: 8 rows prefilled with 12 tokens, then
    # 32 steps from t = 11, both rings fed the f32 ring's argmax
    af = AttentionDecodeAdapter(net, L)
    aq = AttentionDecodeAdapter(net, L, kv_dtype="int8")
    pr = torch.as_tensor(rng.integers(0, V, (8, 12)), device="cuda")
    cf, cq = af.prefill(pr, 12), aq.prefill(pr, 12)
    toks = pr[:, -1]
    agree, prob_delta, logit_delta = [], 0.0, 0.0
    for t in range(11, 11 + N_LANE_ACC_STEPS):
        pos = torch.full((8,), t, dtype=torch.long, device="cuda")
        lf, cf = af.decode(cf, toks, pos)
        lq, cq = aq.decode(cq, toks, pos)
        prob_delta = max(prob_delta, float(
            (lf.softmax(-1) - lq.softmax(-1)).abs().max()))
        logit_delta = max(logit_delta, float((lf - lq).abs().max()))
        agree.append(float((lf.argmax(-1) == lq.argmax(-1)).float().mean()))
        toks = lf.argmax(-1)
    if not prob_delta <= TOL_LANE_PROB:
        fail(f"bench lane: int8 ring post-softmax difference {prob_delta} > "
             f"{TOL_LANE_PROB}")
    out["accuracy"] = {"top1_agreement": float(np.mean(agree)),
                       "max_prob_delta": prob_delta,
                       "max_logit_delta": logit_delta,
                       "steps": N_LANE_ACC_STEPS, "rows": 8}

    # an f32 copy on the CPU: the same greedy tokens, and decode logits
    # within 1e-5 relative through a ring wrap (ring 8, as the JAX
    # package's TestRingWraparound)
    cpu = copy.deepcopy(net).to("cpu")
    ceng = GenerationEngine(cpu, slots=8, max_len=L, device="cpu")
    greedy = [dict(prompt=p, max_new_tokens=24) for p in prompts[:8]]
    runs = []
    for eng in (engines[None], ceng):
        streams = [eng.submit(**dict(r)) for r in greedy]
        eng.drain()
        runs.append([s.tokens for s in streams])
    if runs[0] != runs[1]:
        fail(f"bench lane: greedy tokens on the card {runs[0]} differ from "
             f"the CPU copy's {runs[1]}")
    tokens = rng.integers(0, V, (2, 4 + N_TEACHER_STEPS))
    worst = 0.0
    logits = {}
    for m in (net, cpu):
        ad = AttentionDecodeAdapter(m, 8)
        caches = ad.prefill(torch.as_tensor(tokens[:, :4], device=m.device),
                            None)
        logits[m.device.type] = []
        for t in range(3, 3 + N_TEACHER_STEPS):
            lg, caches = ad.decode(
                caches, torch.as_tensor(tokens[:, t], device=m.device),
                torch.full((2,), t, dtype=torch.long, device=m.device))
            logits[m.device.type].append(lg.cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        worst = max(worst, _rel(torch, a, b))
    if not worst <= TOL_LM_CPU_REL:
        fail(f"bench lane: decode logits through a ring wrap, card against "
             f"the CPU: {worst} > {TOL_LM_CPU_REL} relative")
    out["cpu_check"] = {"greedy_streams": len(greedy),
                        "greedy_tokens_equal": True,
                        "wrap_ring": 8, "wrap_steps": N_TEACHER_STEPS,
                        "wrap_logits_max_rel_err": worst}
    return out


def _lm_requests(np, V, max_len):
    """16 requests from the seed: prompts U[16, 380] tokens (buckets
    16-511), U[32, 128] new tokens within ``max_len``, half greedy and half
    sampled (temperature 0.8, top-k 40, seed 1000 + i)."""
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(16, 381))
        m = int(rng.integers(32, min(128, max_len - n) + 1))
        reqs.append(dict(prompt=rng.integers(0, V, n).tolist(),
                         max_new_tokens=m,
                         **({} if i % 2 == 0 else
                            dict(temperature=0.8, top_k=40, seed=1000 + i))))
    return reqs


def _steady_decode(torch, eng, reqs):
    """A full pool in steady decode: the engine step's synced wall ms and
    its profile (device ms, busy share, kernels a step); a replay alone,
    timed and profiled; and the same step run eagerly through
    ``adapter.decode`` on a copy of the pool's state (what the graph
    holds), timed and profiled. The pool is emptied after."""
    from deeplearning4j_tpu_torch.common.trees import tree_map

    for r in reqs[:eng.pool.n_slots]:
        eng.submit(r["prompt"][:64], max_new_tokens=200)
    eng.step()                                   # admit all slots
    n = N_DECODE_PROFILE
    step_prof, step_wall = profile_device(torch, eng.step, n)
    step_ms = host_ms(torch, eng.step, n)
    replay_prof, _ = profile_device(torch, eng.decode_pool, n)
    replay_ms = host_ms(torch, eng.decode_pool, n)
    state = tree_map(lambda t: t.clone(), eng.pool.state)
    tokens, pos = eng._inputs[0].clone(), eng._inputs[1].clone()
    eager = lambda: eng.adapter.decode(state, tokens, pos)  # noqa: E731
    eager_prof, _ = profile_device(torch, eager, n)
    eager_ms = host_ms(torch, eager, n)
    eng.shutdown(timeout=0)

    def summary(prof):
        dev = sum(t for t, _ in prof.values())
        return {"device_ms": dev / n if prof else None,
                "kernels": sum(c for _, c in prof.values()) / n}

    busy = sum(t for t, _ in step_prof.values())
    top = sorted(step_prof.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "slots": eng.pool.n_slots, "steps": n,
        "step_wall_ms": step_ms,
        "step_device_ms": busy / n if step_prof else None,
        "step_busy_share": busy / step_wall if step_prof else None,
        "step_kernels": summary(step_prof)["kernels"],
        "replay_ms": replay_ms, "replay": summary(replay_prof),
        "eager_decode_ms": eager_ms, "eager": summary(eager_prof),
        "top_kernels_ms_per_step": {k[:60]: t / n for k, (t, _) in top},
    }


def prefill_flash_times(torch):
    """The flash forward at one prefill shape of the full-width LM, [1, 12,
    256, 64] causal bf16: against its plain version, the kernel's time (CUDA
    events and the profiler's device time), the plain version's, its bound,
    and scaled_dot_product_attention's on the same inputs (a yardstick the
    port never calls)."""
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        FWD_KERNEL_NAMES, flash_forward, flash_forward_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, _, _ = _attn_inputs(torch, g, 1, 12, 256, 64, torch.bfloat16,
                                 False)
    kw = dict(scale=0.125, causal=True)
    o, _ = flash_forward(q, k, v, **kw)
    po, _ = flash_forward_plain(q, k, v, **kw)
    err, ok = _err_within(torch, o, po, torch.bfloat16)
    if not ok:
        fail(f"flash forward at the prefill shape: {err} against plain")
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        q, k, v, is_causal=True)
    iters = 50
    out = {"shape": "[1, 12, 256, 64] causal bf16", "max_abs_err": err,
           "ms": cuda_ms(torch, lambda: flash_forward(q, k, v, **kw), iters),
           "device_ms": kernel_device_ms(
               torch, lambda: flash_forward(q, k, v, **kw), iters,
               FWD_KERNEL_NAMES[torch.bfloat16]),
           "plain_ms": cuda_ms(torch, lambda: flash_forward_plain(
               q, k, v, **kw), iters),
           "library_ms": cuda_ms(torch, sdpa, iters),
           "library_device_ms": call_device_ms(torch, sdpa, iters)}
    out["bound_ms"], out["bound_by"] = flash_bound(torch, "fwd", q, k, None,
                                                   True)
    return out


def replay_against_recompute(torch, net, reqs, streams, record):
    """The replayed graph's logits of the greedy streams, recorded in the
    counted run with the pool's slots live (_record_greedy), against the
    net's full causal forward over each stream: the largest logit
    difference, and the share of emitted tokens that are a top-1 token of
    the recompute (a row whose largest bf16 logit several tokens share
    exactly has each as its top-1); the strict argmax-index agreement and
    the recompute rows with a tied top-1 beside them."""
    rows = {}
    for st, p, row in record:
        rows.setdefault(id(st), []).append((p, row))
    diff, agree, strict, ties, argmax_emitted = 0.0, [], [], 0, []
    for i, (r, s) in enumerate(zip(reqs, streams)):
        if "temperature" in r:
            continue
        n0, seq = len(r["prompt"]), list(r["prompt"]) + s.tokens
        got = rows.get(id(s), [])
        if [p for p, _ in got] != list(range(n0 - 1, len(seq) - 1)):
            fail(f"request {i}: the replay's logits were recorded at "
                 f"{[p for p, _ in got]}, not at each of its decode steps")
        x = torch.as_tensor([seq[:-1]], device=net.device)
        with torch.no_grad():
            pre = net._forward(net._compute_params(), net.state, x, None)[0]
        want = pre[0, n0 - 1:].float()
        dec = torch.stack([row for _, row in got])
        tok = torch.as_tensor(s.tokens, device=dec.device)
        top = want.max(-1).values
        diff = max(diff, float((dec - want).abs().max()))
        agree += (want.gather(-1, tok[:, None])[:, 0] == top).tolist()
        strict += (want.argmax(-1) == tok).tolist()
        argmax_emitted += (dec.argmax(-1) == tok).tolist()
        ties += int(((want == top[:, None]).sum(-1) > 1).sum())
    return {"max_logit_diff": diff,
            "top1_agreement": float(sum(agree) / len(agree)),
            "argmax_index_agreement": float(sum(strict) / len(strict)),
            "recorded_argmax_is_emitted": float(sum(argmax_emitted)
                                                / len(argmax_emitted)),
            "recompute_rows_with_tied_top1": ties, "steps": len(agree)}


def stale_ring_control(torch, ad, net, reqs, streams):
    """The control of the accuracy gates: the first two greedy streams,
    teacher-forced eagerly through ``ad`` for N_TEACHER_STEPS steps, once
    as served and once with the middle encoder layer's ring left stale
    (each step's K/V put back out of it). Returns both runs' largest logit
    difference from the full recompute and top-1 agreement (as
    replay_against_recompute counts it)."""
    greedy = [(r, s) for r, s in zip(reqs, streams)
              if "temperature" not in r][:2]
    mid = ad._tf_layers[len(ad._tf_layers) // 2]
    out = {"layer": mid, "streams": len(greedy), "steps": N_TEACHER_STEPS}
    for name, stale in (("sound", ()), ("stale", (mid,))):
        diff, agree = 0.0, []
        for r, s in greedy:
            got, want = teacher_forced(torch, ad, net,
                                       list(r["prompt"]) + s.tokens,
                                       len(r["prompt"]), N_TEACHER_STEPS,
                                       stale=stale)
            diff = max(diff, float((got - want).abs().max()))
            top = want.max(-1).values
            agree += (want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
                      == top).tolist()
        key = "" if name == "stale" else "sound_"
        out[f"{key}max_logit_diff"] = diff
        out[f"{key}top1_agreement"] = float(sum(agree) / len(agree))
    return out


def phase_full_width_serving(torch, np):
    """The causal LM at BERT-base width (bf16) served at slots 8, max_len
    512, with the bf16 ring and the int8 ring: 16 requests, exact launch
    counts (12 flash forwards a prefill, the decode on replays), tokens/s,
    TTFT, a steady decode step replayed and eager, memory, and the
    replay's own greedy logits against the full causal recompute, with the
    stale-ring control that the logit gate must catch; then an f32 2-layer
    copy against its recompute, and the prefill shape's flash times."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.generation import (
        AttentionDecodeAdapter, GenerationEngine,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = lm_net(torch, dtype="bf16", **FULL_LM)
    V, L = FULL_LM["vocab"], FULL_LM["max_len"]
    reqs = _lm_requests(np, V, L)
    out = {"model": "causal LM at BertBase width: 12 x 768, 12 heads, d_ff "
                    "3072, vocab 30522, 512 positions, bf16",
           "params": net.num_params(), "slots": 8, "max_len": L}
    for kv in (None, "int8"):
        what = f"full-width serving ({kv or 'bf16'} ring)"
        eng = GenerationEngine(net, slots=8, max_len=L, kv_dtype=kv,
                               device="cuda")
        # warm-up at the first request's bucket: captures the graph
        eng.generate(reqs[0]["prompt"], max_new_tokens=2)
        record = []
        streams, run = _serve_lm(torch, np, eng, reqs, FULL_LM["layers"],
                                 what, record=record)
        if run["prefill_programs"] > len([b for b in eng.buckets
                                          if b >= 16]):
            fail(f"{what}: {run['prefill_programs']} prefill shapes")
        run["kv_ring_bytes"] = sum(t.numel() * t.element_size()
                                   for t in tree_leaves(eng.pool.state))
        run["steady"] = _steady_decode(torch, eng, reqs)
        ring = kv or "bf16"
        run["recompute"] = replay_against_recompute(torch, net, reqs, streams,
                                                    record)
        run["stale_ring_control"] = stale_ring_control(
            torch, eng.adapter, net, reqs, streams)
        rc, ctl = run["recompute"], run["stale_ring_control"]
        if rc["top1_agreement"] < TOP1_FULL[ring]:
            fail(f"{what}: the replayed greedy tokens agree with the full "
                 f"recompute's top-1 at {rc['top1_agreement']} < "
                 f"{TOP1_FULL[ring]}")
        if not rc["max_logit_diff"] <= TOL_FULL_LOGIT[ring]:
            fail(f"{what}: replayed logits {rc['max_logit_diff']} from the "
                 f"full recompute > {TOL_FULL_LOGIT[ring]}")
        if not ctl["max_logit_diff"] > TOL_FULL_LOGIT[ring]:
            fail(f"{what}: a stale ring's logits lie {ctl['max_logit_diff']} "
                 f"from the recompute, within the gate "
                 f"{TOL_FULL_LOGIT[ring]}: the gate cannot see it")
        out[kv or "bf16"] = run
        del eng
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del net
    torch.cuda.empty_cache()

    # an f32 2-layer copy at full width against its own recompute
    net2 = lm_net(torch, **dict(FULL_LM, layers=2))
    seq = np.random.default_rng(SEED + 30).integers(0, V, 96).tolist()
    got, want = teacher_forced(torch, AttentionDecodeAdapter(net2, L), net2,
                               seq, 80, N_TEACHER_STEPS)
    rel = _rel(torch, got, want)
    if not rel <= TOL_LM_CPU_REL:
        fail(f"full width, f32 2 layers: cached decode against the full "
             f"recompute {rel} > {TOL_LM_CPU_REL} relative")
    out["f32_two_layer_recompute_max_rel_err"] = rel
    del net2
    out["prefill_flash"] = prefill_flash_times(torch)
    return out


def phase_session_resume(torch, np):
    """Session resume on the card: the bench-lane model cut to 1 layer
    (f32), greedy, with a ring of 32 under max_len 96. Four journaled
    sessions are interrupted after 3, 12 and 30 decode steps (30: past the
    ring's wrap, so the resume prefill gathers the wrapped ring), resumed
    through a new journal into a new engine, and finished; each
    concatenated stream must equal the uninterrupted run token for
    token."""
    import tempfile

    from deeplearning4j_tpu_torch.generation import (
        AttentionDecodeAdapter, GenerationEngine, SessionJournal,
    )

    net = lm_net(torch, seed=LANE_SEED, **dict(LANE, layers=1))
    V = LANE["vocab"]

    def engine(journal=None):
        return GenerationEngine(
            net, slots=8, max_len=LANE["max_len"], device="cuda",
            journal=journal,
            adapter=AttentionDecodeAdapter(net, max_len=SESSION_RING))

    rng = np.random.default_rng(SEED + 31)
    prompts = [rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(4, 16, 4)]
    ref_eng = engine()
    refs = [ref_eng.submit(p, max_new_tokens=SESSION_NEW) for p in prompts]
    ref_eng.drain()
    refs = [s.tokens for s in refs]
    out = {"sessions": len(prompts), "ring": SESSION_RING,
           "kills": list(SESSION_KILLS), "resumes": []}
    with tempfile.TemporaryDirectory() as tmp:
        for kill in SESSION_KILLS:
            path = os.path.join(tmp, f"journal{kill}.ndjson")
            eng = engine(SessionJournal(path))
            for i, p in enumerate(prompts):
                eng.submit(p, max_new_tokens=SESSION_NEW,
                           request_id=f"s{i}")
            for _ in range(kill):
                eng.step()
            eng.shutdown(timeout=0, reason="preempted")
            eng.journal.close()
            journal = SessionJournal(path)
            eng2 = engine(journal)
            res = journal.resume_into(eng2)
            if res != {"resumed": len(prompts), "lost": 0, "completed": 0}:
                fail(f"session resume after {kill} steps: {res}")
            eng2.drain()
            _check_replays(eng2, eng2.steps_run, "session resume")
            for i, ref in enumerate(refs):
                rec = journal.get(f"s{i}")
                if rec.tokens != ref or rec.finish_reason != "length":
                    fail(f"session s{i} resumed after {kill} steps: "
                         f"{rec.tokens} != {ref}")
            journal.close()
            out["resumes"].append({
                "kill_after": kill,
                "resume_prompt_lens": [len(p) + kill for p in prompts],
                "wrapped": all(len(p) + kill > SESSION_RING
                               for p in prompts)})
    return out


# ---------------------------------------------- the training runtime slice

TBPTT_BATCH = 32      # DL4J's GravesLSTMCharModellingExample: minibatch 32,
TBPTT_T = 1000        # example length 1000,
TBPTT_LEN = 50        # tBPTT length 50
N_TBPTT_WARM = 2
N_TBPTT_STEPS = 10
# one fit_batch at T = 1000 (20 chunks, each an RMSProp step with clipping
# 5.0), kernels against the plain lowering on the card, f32: the score
# relative, the parameters absolute. Read on the H100: score equal,
# parameters 1.9e-7 apart. The parameters move about linearly in a
# gradient error, and the control (TBPTT_CONTROL_NOISE) must read above
# TOL_TBPTT_PARAM; the score barely moves with the gradients, so it is
# held to a few f32 rounding steps
TOL_TBPTT_LOSS = 1e-6
TOL_TBPTT_PARAM = 2e-6
# the control: the plain copy again with every chunk's gradients off by a
# seeded relative error of this size an element (a different draw each
# chunk, so RMSProp's division by the gradient's own scale cannot cancel
# it), against the plain copy
TBPTT_CONTROL_NOISE = 1e-4
# one chunk's gradients at [32, 50, 256] from carried (detached) state,
# kernels against the plain lowering: each leaf's max |k - p| over its
# max |p| (f32 sums in other orders over 50 steps). A gradient off by a
# factor 1 + e reads e here, where RMSProp would hide it
TOL_TBPTT_CHUNK_GRAD = 1e-5
# the score of a tBPTT call against the mean of its chunks run by hand
# from the same state on the same kernels
TOL_TBPTT_MEAN = 1e-6
N_FIT_EPOCHS = 3      # phase 33: LeNet through EarlyStoppingTrainer
N_ASYNC_TIMED = 50    # phase 33: steps timed at each async window
N_TL_WARM = 2         # phase 34: ResNet-50 transfer learning
N_TL_STEPS = 10
TL_CLASSES = 10
N_REMAT_WARM = 2      # phase 35: BertBase with remat on and off
N_REMAT_STEPS = 10
# BertBase bf16, one step's loss and gradients with remat against without
# from the same params, generator state and batch: bitwise where the
# kernels are deterministic, else each leaf within this of its largest
# gradient (floored at 1e-3 of the largest of all)
TOL_REMAT_BF16 = 1e-2
def no_host_sync(torch, fn, what):
    """Run ``fn`` (one dispatched train step) under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing call in it
    (``.item()``, a copy to the host, a pageable copy to the card, a
    stream or device sync) raises, and the phase fails. Returns ``fn``'s
    result."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{what}: a dispatched step synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _char_stream(np, seed, n, V):
    """A seeded synthetic character stream: each character follows from
    the one before by a fixed map, one in eight drawn at random."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, np.int64)
    out[0] = rng.integers(0, V)
    noise = rng.integers(0, V, n)
    jump = rng.random(n) < 0.125
    for i in range(1, n):
        out[i] = noise[i] if jump[i] else (out[i - 1] * 7 + 3) % V
    return out


def _tbptt_batches(np, seed, n, V, T=None):
    """``n`` DataSets of TBPTT_BATCH rows of T + 1 (TBPTT_T + 1)
    consecutive stream characters: one-hot inputs and next-character
    labels."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    B, T = TBPTT_BATCH, T or TBPTT_T
    stream = _char_stream(np, seed, 64 * T, V)
    rng = np.random.default_rng(seed + 1)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        starts = rng.integers(0, len(stream) - T - 1, B)
        rows = np.stack([stream[s:s + T + 1] for s in starts])
        out.append(DataSet(eye[rows[:, :-1]], eye[rows[:, 1:]]))
    return out


def _tbptt_net(torch, device="cuda"):
    import dataclasses

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = dataclasses.replace(TextGenerationLSTM(seed=SEED).conf(),
                               tbptt_fwd_length=TBPTT_LEN,
                               tbptt_bwd_length=TBPTT_LEN)
    return MultiLayerNetwork(conf).init(device=device)


def _tbptt_chunk_grads(torch, net, x, y, carries):
    """One tBPTT chunk's loss and gradients (no update) from ``carries``,
    the dropout generator seeded."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    net._rng = torch.Generator(device="cuda").manual_seed(SEED + 24)
    params = net._differentiable(net.params)
    loss = net._loss_terms(
        cast_floating(params, net._policy.compute_dtype), x, y, None, None,
        train=True, rng=net._rng, carries=carries)[0].float()
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(params))


def _noisy_updates(torch, net, noise, seed):
    """Make ``net``'s updates see every gradient off by a seeded relative
    error of ``noise`` an element, drawn anew each step (the control of
    phase 32's parameter check)."""
    from deeplearning4j_tpu_torch.common.trees import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    apply = net._apply_updaters

    def noisy(grads, params, opt_state, step):
        grads = tree_map(lambda g: g * (1 + noise * torch.randn(
            g.shape, device=g.device, generator=gen)), grads)
        return apply(grads, params, opt_state, step)

    net._apply_updaters = noisy


def phase_tbptt(torch, np):
    """TextGenerationLSTM under truncated BPTT at DL4J's char-modelling
    settings, on the card: launches a fit_batch (the host's and the
    device's), the chunk mean, one chunk's gradients from carried state and
    one call's parameters, kernels against the plain lowering."""
    import copy as _copy

    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.ops.cuda import (
        FUSED_LSTM, FUSED_LSTM_BWD, KERNELS,
    )
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ScoreIterationListener,
    )

    net = _tbptt_net(torch)
    V = net.layers[-1].n_out
    batches = _tbptt_batches(np, SEED + 20, N_TBPTT_WARM + N_TBPTT_STEPS, V)
    chunks = -(-TBPTT_T // TBPTT_LEN)
    per_call = 2 * chunks  # two LSTM layers, one launch each a chunk

    def params_apart(a, b):
        return max(float((p - q).abs().max()) for p, q in zip(
            tree_leaves(a.params), tree_leaves(b.params)))

    # one chunk's gradients from carried (detached) state: the carries
    # chunk 0 leaves, then chunk 1, kernels against the plain lowering
    x, y = net._input(batches[0].features), net._labels(batches[0].labels)
    with torch.no_grad():
        carries = tree_map(lambda c: c.detach(), net._forward_carry(
            net._compute_params(), net.state, x[:, :TBPTT_LEN],
            net._init_carries(TBPTT_BATCH))[2])
    chunk = (x[:, TBPTT_LEN:2 * TBPTT_LEN], y[:, TBPTT_LEN:2 * TBPTT_LEN])
    k_loss, k_grads = _tbptt_chunk_grads(torch, net, *chunk, carries)
    env.disable_kernels = True
    try:
        p_loss, p_grads = _tbptt_chunk_grads(torch, net, *chunk, carries)
    finally:
        env.reload()
    chunk_grad_err = max(float((a - b).abs().max())
                         / (float(b.abs().max()) or 1.0)
                         for a, b in zip(k_grads, p_grads))
    chunk_loss_err = float((k_loss - p_loss).abs() / p_loss.abs())
    if chunk_grad_err > TOL_TBPTT_CHUNK_GRAD or \
            chunk_loss_err > TOL_TBPTT_LOSS:
        fail(f"tBPTT chunk [{TBPTT_BATCH}, {TBPTT_LEN}, 256] from carried "
             f"state, kernels vs plain: gradients rel err {chunk_grad_err} "
             f"(tol {TOL_TBPTT_CHUNK_GRAD}), loss rel err {chunk_loss_err}")
    del k_grads, p_grads

    # the kernels against the plain lowering: one call from the same state,
    # and the control, the plain lowering with noisy gradients
    plain, control = _copy.deepcopy(net), _copy.deepcopy(net)
    _noisy_updates(torch, control, TBPTT_CONTROL_NOISE, SEED + 23)
    first = float(net.fit_batch(batches[0]))
    env.disable_kernels = True
    try:
        first_plain = float(plain.fit_batch(batches[0]))
        first_control = float(control.fit_batch(batches[0]))
    finally:
        env.reload()
    loss_err = abs(first - first_plain) / abs(first_plain)
    param_err = params_apart(net, plain)
    control_loss_err = abs(first_control - first_plain) / abs(first_plain)
    control_param_err = params_apart(control, plain)
    del plain, control
    if loss_err > TOL_TBPTT_LOSS or param_err > TOL_TBPTT_PARAM:
        fail(f"tBPTT fit_batch, kernels vs plain on the card: score rel err "
             f"{loss_err} (tol {TOL_TBPTT_LOSS}), param abs err {param_err} "
             f"(tol {TOL_TBPTT_PARAM})")
    if control_param_err <= TOL_TBPTT_PARAM:
        fail(f"tBPTT: gradients off by {TBPTT_CONTROL_NOISE} an element move "
             f"the parameters {control_param_err}, within the check's "
             f"{TOL_TBPTT_PARAM}: the check cannot see such an error")

    # the score is the mean of the chunk losses: the chunks by hand on a
    # copy, each from the carries the chunk before left, one step index
    ref = _copy.deepcopy(net)
    ds = batches[1]
    got = float(net.fit_batch(ds))
    x, y = ref._input(ds.features), ref._labels(ds.labels)
    carries, total = ref._init_carries(TBPTT_BATCH), 0.0
    for s in range(0, TBPTT_T, TBPTT_LEN):
        loss, carries = ref._train_step(x[:, s:s + TBPTT_LEN],
                                        y[:, s:s + TBPTT_LEN], None, None,
                                        carries)
        total += float(loss)
    mean_err = abs(got - total / chunks) / abs(got)
    if mean_err > TOL_TBPTT_MEAN:
        fail(f"tBPTT score {got} against the mean of its {chunks} chunks "
             f"{total / chunks}: rel err {mean_err}")
    del ref

    # the main path: N fit_batch calls through fit() with a listener
    lines = []
    net.set_listeners(ScoreIterationListener(5, log=lines.append))
    it = ListDataSetIterator(batches[N_TBPTT_WARM:])
    _, launches, reserves, wall = _count_launches(
        torch, KERNELS, lambda: net.fit(it, epochs=1))
    want = per_call * N_TBPTT_STEPS
    if (launches != _only(KERNELS, fused_lstm_fwd=want, fused_lstm_bwd=want)
            or reserves != _reserves_only(KERNELS, fused_lstm_fwd=want)):
        fail(f"tBPTT: {N_TBPTT_STEPS} fit_batch calls launched {launches} "
             f"({reserves} with reserve); want {per_call} forward and "
             f"{per_call} backward a call")
    losses = [float(ln.split(": ")[1]) for ln in lines]
    if len(lines) != 2 or not all(np.isfinite(losses)):
        fail(f"tBPTT listener lines: {lines}")

    # under the profiler: one more call, the host's and the device's count
    design, _ = lstm_design("tBPTT chunk", TBPTT_LEN, TBPTT_BATCH, 256,
                            torch.float32, "cluster")
    b_design, _ = lstm_design("tBPTT chunk", TBPTT_LEN, TBPTT_BATCH, 256,
                              torch.float32, "cluster", backward=True)
    lstm = [FUSED_LSTM, FUSED_LSTM_BWD]
    host, device, by_kernel, prof_wall, lost = profiled_launches(
        torch, lstm, lambda: (net.fit_batch(batches[0]), drain_scores(net)))
    want_call = {FUSED_LSTM.name: per_call, FUSED_LSTM_BWD.name: per_call}
    if host != want_call or device != want_call or lost == PROFILE_LEAD_IN:
        fail(f"tBPTT: a profiled fit_batch call launched {host} and the "
             f"device recorded {device} ({lost} of {PROFILE_LEAD_IN} "
             f"lead-in records lost); want {per_call} of each kernel")
    prof = _profile_summary(by_kernel, prof_wall, 1, "call")

    # a trailing chunk of 10: one call at T = 1010
    longer = _tbptt_batches(np, SEED + 21, 1, V, T=TBPTT_T + 10)[0]
    tail_launches = _count_launches(
        torch, KERNELS, lambda: float(net.fit_batch(longer)))[1]
    want_tail = 2 * (chunks + 1)
    if tail_launches != _only(KERNELS, fused_lstm_fwd=want_tail,
                              fused_lstm_bwd=want_tail):
        fail(f"tBPTT at T = {TBPTT_T + 10}: {tail_launches}; want "
             f"{want_tail} of each")
    # one dispatched call (20 chunks) raises nothing under the sync debug
    # mode, its score left in flight
    drain_scores(net)
    h = no_host_sync(torch, lambda: net.fit_batch(batches[2]), "tBPTT")
    if h.ready():
        fail("the dispatched tBPTT call's score was fetched at dispatch")
    drain_scores(net)
    return {
        "model": "TextGenerationLSTM(LSTM 256 x 2, vocab 77), RMSProp 1e-3, "
                 "clipping 5.0, tBPTT 50 / 50",
        "batch": TBPTT_BATCH, "timesteps": TBPTT_T, "tbptt_length": TBPTT_LEN,
        "chunks_per_call": chunks, "calls": N_TBPTT_STEPS,
        "launches": launches, "launches_per_call": {
            k: v / N_TBPTT_STEPS for k, v in launches.items() if v},
        "listener_lines": lines,
        "wall_s": wall, "ms_per_call": 1e3 * wall / N_TBPTT_STEPS,
        "samples_per_s": TBPTT_BATCH * N_TBPTT_STEPS / wall,
        "chunk_mean_rel_err": mean_err,
        "chunk_check": {"shape": [TBPTT_BATCH, TBPTT_LEN, 256],
                        "grad_max_rel_err": chunk_grad_err,
                        "loss_rel_err": chunk_loss_err},
        "plain_check": {"score": first, "plain_score": first_plain,
                        "score_rel_err": loss_err,
                        "param_max_abs_err": param_err,
                        "control_noise": TBPTT_CONTROL_NOISE,
                        "control_score_rel_err": control_loss_err,
                        "control_param_max_abs_err": control_param_err},
        "fwd_design": design._asdict(), "bwd_design": b_design._asdict(),
        "profile": prof, "host_launches_profiled_call": host,
        "device_launches_per_call": device,
        "profiler_lead_in_records_lost": lost,
        "trailing_chunk": {"timesteps": TBPTT_T + 10,
                           "launches": tail_launches},
    }


def window_step_ms(torch, net, batch, steps):
    """Wall ms a ``fit_batch`` of ``batch`` over ``steps`` steps at
    ``DL4J_TORCH_ASYNC_STEPS`` 0 and 2, twice each, alternating (one
    untimed step first at each): {"async_steps_0": [ms, ms],
    "async_steps_2": [ms, ms]}."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores

    timing = {}
    try:
        for window in (0, 2, 0, 2):
            env.async_steps = window
            net.fit_batch(batch)
            drain_scores(net)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                net.fit_batch(batch)
            drain_scores(net)
            torch.cuda.synchronize()
            timing.setdefault(f"async_steps_{window}", []).append(
                1e3 * (time.perf_counter() - t0) / steps)
    finally:
        env.reload()
    return timing


def _lenet_mnist_score(np, net, it, batches=4):
    """Mean loss of the first ``batches`` test batches (early stopping's
    score, lower is better)."""
    scores = []
    for i, ds in enumerate(it):
        if i == batches:
            break
        scores.append(net.score(ds))
    it.reset()
    return float(np.mean(scores))


def phase_fit_loop(torch, np):
    """LeNet (config #1) through the fit loop on MNIST: early stopping
    with listeners and background checkpoints, evaluate, a restore from
    the checkpoints (a corrupted one passed over), a dispatched step with
    no host sync, and ms a step at async windows 0 and 2."""
    import tempfile

    from deeplearning4j_tpu_torch import faults
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
    from deeplearning4j_tpu_torch.optimize.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingTrainer,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import PerformanceListener
    from deeplearning4j_tpu_torch.util.checkpoints import (
        AsyncCheckpointListener, TrainingCheckpointer,
    )
    from deeplearning4j_tpu_torch.zoo import LeNet

    train = MnistDataSetIterator(LENET_BATCH, train=True, seed=SEED)
    test = MnistDataSetIterator(LENET_BATCH, train=False, seed=SEED,
                                shuffle=False)
    net = LeNet(seed=SEED).init(device="cuda")
    tmp = tempfile.mkdtemp(prefix="dl4j-ckpt-")
    lines = []
    perf = PerformanceListener(frequency=32, log=lines.append)
    perf.batch_size = LENET_BATCH
    ckl = AsyncCheckpointListener(tmp, save_every_n_iterations=100,
                                  keep_last=2)
    net.set_listeners(perf, ckl)
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(N_FIT_EPOCHS),
            ScoreImprovementEpochTerminationCondition(1)],
        score_calculator=lambda m: _lenet_mnist_score(np, m, test))
    t0 = time.perf_counter()
    result, launches, _, _ = _count_launches(
        torch, KERNELS,
        lambda: EarlyStoppingTrainer(cfg, net, train).fit())
    fit_s = time.perf_counter() - t0
    if any(launches.values()):
        fail(f"LeNet's fit loop launched {launches}; its path runs none of "
             f"the port's kernels")
    ckl.checkpointer.wait()
    saved = ckl.checkpointer.all_steps()
    if not saved:
        fail("the checkpoint listener saved no step")

    # evaluate against the argmax of output() over the same batches
    ev = net.evaluate(test)
    hits = n = 0
    for ds in test:
        out = net.output(ds.features)
        hits += int((out.argmax(-1).cpu().numpy()
                     == ds.labels.argmax(-1)).sum())
        n += len(ds.labels)
    test.reset()
    if ev.num_examples() != n or abs(ev.accuracy() - hits / n) > 1e-12:
        fail(f"evaluate: accuracy {ev.accuracy()} over {ev.num_examples()} "
             f"examples; output() argmax {hits / n} over {n}")

    # restore: a clean save, then one the ckpt_corrupt point truncates
    probe = next(iter(test)).features
    test.reset()
    ck = TrainingCheckpointer(tmp + "-restore", keep_last=3)
    s1 = net.step_count
    ck.save(s1, net)
    want = net.output(probe).clone()
    fresh = LeNet(seed=SEED + 1).init(device="cuda")
    if ck.restore_latest(fresh) != s1 or not torch.equal(
            fresh.output(probe), want):
        fail("restore_latest did not give the checkpointed step's outputs "
             "bit for bit")
    net.fit_batch(next(iter(train)))
    train.reset()
    drain_scores(net)
    s2 = net.step_count
    with faults.injected(f"ckpt_corrupt:1@step=={s2}") as plan:
        ck.save(s2, net)
    ck.wait()
    fresh = LeNet(seed=SEED + 2).init(device="cuda")
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ck.restore_latest(fresh)
    if (plan.injected["ckpt_corrupt"] != 1 or got != s1
            or not torch.equal(fresh.output(probe), want)
            or not any("not restorable" in str(w.message) for w in caught)):
        fail(f"a corrupted step {s2} was not passed over: restored {got}, "
             f"want {s1}")
    ck.close()

    # one dispatched step raises nothing under the sync debug mode
    net.set_listeners()
    ds = next(iter(train))
    train.reset()
    x, y = ds.features, ds.labels
    net.fit_batch((x, y))
    drain_scores(net)
    h = no_host_sync(torch, lambda: net.fit_batch((x, y)), "LeNet")
    if h.ready():
        fail("the dispatched step's score was fetched at dispatch")
    drain_scores(net)

    # ms a step at the two windows
    timing = window_step_ms(torch, net, (x, y), N_ASYNC_TIMED)
    return {
        "model": "LeNet(28 x 28 x 1, conv 20-50, dense 500, 10 classes), "
                 "f32, Adam 1e-3",
        "data": "MnistDataSetIterator(64)", "synthetic": train.synthetic,
        "train_examples": int(train.features.shape[0]),
        "test_examples": n, "epochs": result.total_epochs,
        "best_epoch": result.best_epoch, "best_score": result.best_score,
        "termination": f"{result.termination_reason} "
                       f"({result.termination_details})",
        "score_vs_epoch": result.score_vs_epoch,
        "steps": net.step_count, "fit_s": fit_s, "launches": launches,
        "accuracy": ev.accuracy(), "f1": ev.f1(),
        "performance_lines": lines[-3:],
        "iters_per_s": perf.last_iters_per_sec,
        "device_mem_in_use_mb": perf.last_system.get("device_mem_in_use_mb"),
        "checkpoint_steps": saved, "restored_step": s1,
        "corrupted_step_passed_over": s2,
        "ms_per_step": timing,
    }


def phase_transfer_learning(torch, np, full_step_ms):
    """ResNet-50 (config #2's network) cut to a 10-class head on a frozen
    trunk: steps through an iterator, evaluate, frozen params unmoved."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearningGraphBuilder,
    )
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import ResNet50

    base = ResNet50(seed=SEED).init(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    net = (TransferLearningGraphBuilder(base)
           .fine_tune_configuration(FineTuneConfiguration(
               updater=Adam(lr=1e-3)))
           .set_feature_extractor("avgpool")
           .remove_vertex_and_connections("output")
           .add_layer("output", OutputLayer(n_out=TL_CLASSES,
                                            activation="softmax",
                                            loss="mcxent"), "avgpool")
           .set_outputs("output").build())
    del base
    frozen = [n for n, v in net.conf.vertices.items()
              if hasattr(v, "layer") and not v.layer.trainable]
    before = {n: {k: t.clone() for k, t in net.params[n].items()}
              for n in frozen if n in net.params}
    head = {k: t.clone() for k, t in net.params["output"].items()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    sets = []
    for _ in range(3):
        x = torch.randn((RESNET_BATCH, 224, 224, 3), device="cuda",
                        generator=g).to(torch.bfloat16)
        y = torch.nn.functional.one_hot(torch.randint(
            0, TL_CLASSES, (RESNET_BATCH,), device="cuda", generator=g),
            TL_CLASSES).float()
        sets.append(DataSet(x, y))
    net.fit(ListDataSetIterator(sets[:N_TL_WARM]))
    timed = ListDataSetIterator([sets[i % 3] for i in range(N_TL_STEPS)])
    _, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: net.fit(timed))
    if any(launches.values()):
        fail(f"ResNet-50 transfer learning launched {launches}")
    losses = [float(net.score_value)]
    moved = [n for n, p in before.items()
             if not all(torch.equal(p[k], net.params[n][k]) for k in p)]
    if moved or not before:
        fail(f"frozen vertices moved: {moved} (of {len(before)})")
    if all(torch.equal(head[k], net.params["output"][k]) for k in head):
        fail("the new head did not move")
    ev = net.evaluate(ListDataSetIterator(sets))
    peak = torch.cuda.max_memory_allocated() / 1e9
    drain_scores(net)
    no_host_sync(torch, lambda: net.fit_batch(sets[1]), "ResNet-50 transfer")
    drain_scores(net)
    step_ms = 1e3 * wall / N_TL_STEPS
    by_kernel, prof_wall = profile_device(
        torch, lambda: (net.fit_batch(sets[0]), drain_scores(net)), 3)
    return {
        "model": "ResNet50 trunk frozen through avgpool, new 10-class "
                 "output, Adam 1e-3 (FineTuneConfiguration), bf16",
        "batch": RESNET_BATCH, "frozen_vertices": len(frozen),
        "frozen_param_vertices": len(before), "warm_steps": N_TL_WARM,
        "steps": N_TL_STEPS, "last_loss": losses[-1], "launches": launches,
        "wall_s": wall, "step_wall_ms": step_ms,
        "full_step_wall_ms_phase_21": full_step_ms,
        "step_over_full_step": step_ms / full_step_ms,
        "samples_per_s": RESNET_BATCH * N_TL_STEPS / wall,
        "peak_memory_gb": peak, "eval_accuracy": ev.accuracy(),
        "eval_examples": ev.num_examples(),
        "profile": _profile_summary(by_kernel, prof_wall, 3, "step"),
    }


def _step_loss_grads(torch, net, x, y, m, seed):
    """One training forward's loss and its gradients (no update), the
    dropout generator seeded with ``seed``."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating
    from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map

    net._rng = torch.Generator(device="cuda").manual_seed(seed)
    params = tree_map(lambda p: p.detach().requires_grad_(), net.params)
    loss = net._loss_terms(
        cast_floating(params, net._policy.compute_dtype), net._input(x),
        net._labels(y), net._mask(m), None, train=True,
        rng=net._rng)[0].float()
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), grads


def phase_remat(torch, np):
    """BertBase at [32, 128], bf16, dropout 0.1, with remat on and off:
    flash launches a step, one step's loss and gradients with remat
    against without, peak memory and ms a step of each."""
    import dataclasses

    from deeplearning4j_tpu_torch.common.trees import tree_map
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import (
        FLASH_DKV, FLASH_DQ, FLASH_FWD, KERNELS,
    )
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
    from deeplearning4j_tpu_torch.zoo import BertBase

    x, y, m = _bert_batch(np, SEED + 40)
    conf = BertBase(seed=SEED, max_len=128).conf()
    out, params = {}, None
    for remat in (True, False):
        torch.cuda.empty_cache()
        net = MultiLayerNetwork(dataclasses.replace(conf, remat=remat)).init(
            device="cuda")
        if params is None:
            params = net.params
        else:
            net.params = tree_map(lambda t: t.clone(), params)
        # one step's loss and gradients from the shared params and seed
        loss, grads = _step_loss_grads(torch, net, x, y, m, SEED + 41)
        out[remat] = {"loss": loss, "grads": grads}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(N_REMAT_WARM):
            net.fit_batch((x, y, m))
        drain_scores(net)
        _, launches, _, wall = _count_launches(
            torch, KERNELS, lambda: ([net.fit_batch((x, y, m))
                                      for _ in range(N_REMAT_STEPS)],
                                     drain_scores(net)))
        per = 12 * N_REMAT_STEPS
        want = _only(KERNELS, flash_attention_fwd=per * (2 if remat else 1),
                     flash_attention_dq=per, flash_attention_dkv=per)
        if launches != want:
            fail(f"BertBase remat={remat}: {N_REMAT_STEPS} steps launched "
                 f"{launches}; want {want}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        no_host_sync(torch, lambda: net.fit_batch((x, y, m)),
                     f"BertBase remat={remat}")
        drain_scores(net)
        # under the profiler: one more step, the host's and the device's
        # count
        flash = [FLASH_FWD, FLASH_DQ, FLASH_DKV]
        host, device, by_kernel, prof_wall, lost = profiled_launches(
            torch, flash,
            lambda: (net.fit_batch((x, y, m)), drain_scores(net)))
        want_step = {FLASH_FWD.name: 24 if remat else 12, FLASH_DQ.name: 12,
                     FLASH_DKV.name: 12}
        if host != want_step or device != want_step \
                or lost == PROFILE_LEAD_IN:
            fail(f"BertBase remat={remat}: a profiled step launched {host} "
                 f"and the device recorded {device} ({lost} of "
                 f"{PROFILE_LEAD_IN} lead-in records lost); want "
                 f"{want_step}")
        out[remat].update({
            "launches": launches, "launches_per_step": {
                k: v / N_REMAT_STEPS for k, v in launches.items() if v},
            "device_launches_per_step": device,
            "profiler_lead_in_records_lost": lost,
            "wall_s": wall, "step_wall_ms": 1e3 * wall / N_REMAT_STEPS,
            "samples_per_s": 32 * N_REMAT_STEPS / wall,
            "peak_memory_gb": peak,
            "profile": _profile_summary(by_kernel, prof_wall, 1, "step"),
        })
        del net
    on, off = out[True], out[False]
    bitwise = bool(torch.equal(on["loss"], off["loss"])) and all(
        torch.equal(a, b) for a, b in zip(on["grads"], off["grads"]))
    floor = 1e-3 * max(float(b.abs().max()) for b in off["grads"])
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    floor)
                   for a, b in zip(on["grads"], off["grads"]))
    loss_rel = float((on["loss"] - off["loss"]).abs() / off["loss"].abs())
    if not bitwise and (grad_rel > TOL_REMAT_BF16
                        or loss_rel > TOL_REMAT_BF16):
        fail(f"BertBase one step with remat against without: loss rel "
             f"{loss_rel}, gradients rel {grad_rel} (tol {TOL_REMAT_BF16})")
    for d in (on, off):
        d["loss"] = float(d.pop("loss"))
        d.pop("grads")
    return {
        "model": "BertBase(12 x 768, 12 heads, d_ff 3072, vocab 30522, "
                 "max_len 128), bf16, AdamW 2e-5 warmup-cosine, clip 1.0, "
                 "dropout 0.1",
        "batch": 32, "timesteps": 128, "steps": N_REMAT_STEPS,
        "remat": on, "no_remat": off,
        "step_vs_no_remat": {"bitwise": bitwise, "loss_rel_err": loss_rel,
                             "grad_max_rel_err": grad_rel},
        "peak_memory_ratio": on["peak_memory_gb"] / off["peak_memory_gb"],
        "step_ms_ratio": on["step_wall_ms"] / off["step_wall_ms"],
    }


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

    # phase 20: ResNet-50 inference (BASELINE.json config #2)
    rn_out, rn_net = phase_resnet_inference(torch, np)
    print(json.dumps({"resnet50_inference": rn_out, "card": card}),
          flush=True)
    print(f"ResNet-50 output() on {card}: {rn_out['wall_ms_per_call']:.2f} "
          f"ms a call of {RESNET_BATCH} images, device busy "
          f"{rn_out['profile']['device_busy_share']}", flush=True)

    # phase 21: ResNet-50 training
    rn_train = phase_resnet_training(torch, np, rn_net)
    del rn_net
    print(json.dumps({"resnet50_training": rn_train, "card": card}),
          flush=True)
    print(f"ResNet-50 training on {card}: {rn_train['step_wall_ms']:.2f} ms "
          f"a step, {rn_train['samples_per_s']:.1f} samples/s, MFU "
          f"{rn_train['mfu']:.4f}, device busy "
          f"{rn_train['profile']['device_busy_share']}", flush=True)

    # phase 22: bert_tiny.onnx on the card against its golden
    t0 = time.perf_counter()
    golden = phase_onnx_golden(torch, np)
    golden["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"onnx_golden": golden, "card": card}), flush=True)
    print(f"bert_tiny.onnx on {card}: {golden['off']['nodes']} -> "
          f"{golden['on']['nodes']} nodes, rewrites "
          f"{golden['on']['rewrites']}", flush=True)

    # phase 23: bench.py bert_import at its own shape
    t0 = time.perf_counter()
    bert_import = phase_bert_import_training(torch, np)
    bert_import["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"bert_import_training": bert_import, "card": card}),
          flush=True)
    for k in ("on", "off"):
        r = bert_import[k]
        print(f"bert_import (optimizer {k}) on {card}: "
              f"{r['step_wall_ms']:.2f} ms a step, {r['samples_per_s']:.1f} "
              f"samples/s, device {r['profile']['device_ms_per_step']:.3f} "
              f"ms a step, busy {r['profile']['device_busy_share']}",
              flush=True)

    # phase 24: BERT-base through TF import, full width
    t0 = time.perf_counter()
    bert_tf = phase_bert_tf_import(torch, np, bert_train["step_wall_ms"])
    bert_tf["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"bert_tf_import": bert_tf, "card": card}), flush=True)
    tr = bert_tf["training"]
    print(f"BERT-base TF import on {card}: build {bert_tf['build_s']:.1f} s, "
          f"parse {bert_tf['parse_s']:.1f} s, import "
          f"{bert_tf['import_s']:.1f} s; output() "
          f"{bert_tf['inference']['ms_per_call']:.2f} ms a call; "
          f"fine-tuning {tr['step_wall_ms']:.2f} ms a step, "
          f"{tr['samples_per_s']:.1f} samples/s, busy "
          f"{tr['profile']['device_busy_share']}, "
          f"{tr['step_ms_over_zoo_bertbase_step_ms']:.2f}x the zoo BertBase "
          f"step", flush=True)

    # phase 25: the import path reaches the LRN kernels
    t0 = time.perf_counter()
    lrn_import = phase_tf_import_lrn(torch, np)
    lrn_import["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"tf_import_lrn": lrn_import, "card": card}),
          flush=True)

    # phase 26: YOLO2 inference at full width
    t0 = time.perf_counter()
    yolo_out, yolo_net = phase_yolo2_inference(torch, np)
    yolo_out["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"yolo2_inference": yolo_out, "card": card}),
          flush=True)
    dec = yolo_out["decode"]
    print(f"YOLO2 output() on {card}: {yolo_out['wall_ms_per_call']:.2f} ms "
          f"a call of {YOLO2_BATCH} images, device "
          f"{yolo_out['profile']['device_ms_per_call']:.3f} ms, busy "
          f"{yolo_out['profile']['device_busy_share']}; decode "
          f"{dec['decode_host_ms']:.1f} ms, NMS {dec['nms_host_ms']:.1f} ms, "
          f"{dec['detections']} detections, {dec['kept']} kept", flush=True)

    # phase 27: YOLO2 training at full width
    t0 = time.perf_counter()
    yolo_train = phase_yolo2_training(torch, np, yolo_net)
    yolo_train["wall_s_phase"] = time.perf_counter() - t0
    del yolo_net
    print(json.dumps({"yolo2_training": yolo_train, "card": card}),
          flush=True)
    print(f"YOLO2 training on {card}: {yolo_train['step_wall_ms']:.2f} ms a "
          f"step, {yolo_train['samples_per_s']:.1f} samples/s, MFU "
          f"{yolo_train['mfu']:.4f}, device "
          f"{yolo_train['profile']['device_ms_per_step']:.3f} ms a step, busy "
          f"{yolo_train['profile']['device_busy_share']}, peak "
          f"{yolo_train['peak_memory_gb']:.2f} GB", flush=True)

    # phase 28: the rest of the CNN zoo
    t0 = time.perf_counter()
    zoo_rows = phase_zoo(torch, np)
    print(json.dumps({"zoo": zoo_rows, "card": card,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    for zname, r in zoo_rows.items():
        print(f"{zname} on {card}: output() {r['first_output_ms']:.1f} ms, "
              f"fit_batch {r['first_fit_batch_ms']:.1f} ms (first calls, B="
              f"{r['batch']}), loss {r['loss']:.4f}, f32 at "
              f"{r['f32_check']['side']} against the CPU "
              f"{r['f32_check']['max_rel_err']:.2e}", flush=True)

    # phase 29: bench.py's decode lane, transformer serving at its shape
    t0 = time.perf_counter()
    lane = phase_lane_serving(torch, np)
    lane["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"lane_serving": lane, "card": card}), flush=True)
    for kv in ("f32", "int8"):
        r = lane[kv]
        print(f"bench-lane serving ({kv} ring) on {card}: "
              f"{r['tokens_per_s']:.1f} tokens/s, decode programs "
              f"{r['decode_programs']}, prefill programs "
              f"{r['prefill_programs']}, {r['replays']} replays, "
              f"{r['flash_fwd_launches']} flash forwards", flush=True)
    print(f"bench-lane int8 ring: top-1 agreement "
          f"{lane['accuracy']['top1_agreement']:.4f}, post-softmax "
          f"difference {lane['accuracy']['max_prob_delta']:.2e}", flush=True)

    # phase 30: the causal LM at BERT-base width
    t0 = time.perf_counter()
    full = phase_full_width_serving(torch, np)
    full["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"full_width_serving": full, "card": card}), flush=True)
    for kv in ("bf16", "int8"):
        r = full[kv]
        st = r["steady"]
        print(f"full-width LM serving ({kv} ring) on {card}: "
              f"{r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{r['ttft_p50_ms']:.1f} ms; decode step {st['step_wall_ms']:.3f}"
              f" ms wall, device {st['step_device_ms']} ms, busy "
              f"{st['step_busy_share']}; replay {st['replay_ms']:.3f} ms "
              f"against eager {st['eager_decode_ms']:.3f} ms; against the "
              f"recompute top-1 {r['recompute']['top1_agreement']:.4f}, "
              f"logits {r['recompute']['max_logit_diff']:.4f} (a stale ring "
              f"{r['stale_ring_control']['max_logit_diff']:.4f})", flush=True)

    # phase 31: session resume on the card
    t0 = time.perf_counter()
    sessions = phase_session_resume(torch, np)
    sessions["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"session_resume": sessions, "card": card}), flush=True)

    # phase 32: truncated BPTT through the LSTM kernels
    t0 = time.perf_counter()
    tbptt = phase_tbptt(torch, np)
    tbptt["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"tbptt_charrnn": tbptt, "card": card}), flush=True)
    print(f"tBPTT char-RNN on {card}: {tbptt['ms_per_call']:.1f} ms a "
          f"fit_batch of {TBPTT_BATCH} x {TBPTT_T} ({tbptt['chunks_per_call']}"
          f" chunks), device {tbptt['profile']['device_ms_per_call']:.2f} ms, "
          f"busy {tbptt['profile']['device_busy_share']}, "
          f"{tbptt['launches_per_call']} launches a call", flush=True)

    # phase 33: the fit loop at config #1
    t0 = time.perf_counter()
    fit_loop = phase_fit_loop(torch, np)
    fit_loop["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"fit_loop_lenet": fit_loop, "card": card}), flush=True)
    print(f"LeNet fit loop on {card}: MNIST synthetic {fit_loop['synthetic']}"
          f", {fit_loop['epochs']} epochs ({fit_loop['termination']}), "
          f"accuracy {fit_loop['accuracy']:.4f}; ms a step "
          f"{fit_loop['ms_per_step']}", flush=True)

    # phase 34: transfer learning at config #2's network
    t0 = time.perf_counter()
    transfer = phase_transfer_learning(torch, np, rn_train["step_wall_ms"])
    transfer["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"transfer_resnet50": transfer, "card": card}),
          flush=True)
    print(f"ResNet-50 transfer learning on {card}: "
          f"{transfer['step_wall_ms']:.2f} ms a step (the full step "
          f"{rn_train['step_wall_ms']:.2f}), peak "
          f"{transfer['peak_memory_gb']:.2f} GB", flush=True)

    # phase 35: remat at config #4's network
    t0 = time.perf_counter()
    remat = phase_remat(torch, np)
    remat["wall_s_phase"] = time.perf_counter() - t0
    print(json.dumps({"remat_bert": remat, "card": card}), flush=True)
    for k in ("remat", "no_remat"):
        r = remat[k]
        print(f"BertBase {k} on {card}: {r['step_wall_ms']:.2f} ms a step, "
              f"peak {r['peak_memory_gb']:.2f} GB, flash launches a step "
              f"{r['launches_per_step']}", flush=True)

    # phase 36: kernels line, card line, result line
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
    # the transformer-serving prefills (phases 29-30) run the forward alone
    serve_paths = {"lane_serving_f32": lane["f32"]["launches"],
                   "lane_serving_int8": lane["int8"]["launches"],
                   "full_width_serving_bf16": full["bf16"]["launches"],
                   "full_width_serving_int8": full["int8"]["launches"]}
    for kern, kind, plain_key, library, design in (
            (ffwd, "fwd", "fwd_plain_ms", ft["library_fwd_ms"],
             "wgmma (tensor cores), cp.async ring"),
            # no one library call computes dq or dk/dv alone: SDPA's
            # backward computes both, in library_bwd_ms
            (fdq, "dq", "bwd_plain_ms", None,
             "wgmma (tensor cores), cp.async ring"),
            (fdkv, "dkv", "bwd_plain_ms", None,
             "wgmma (tensor cores), cp.async ring")):
        by_path = {"bert_inference": infer_n[kern.name],
                   "bert_training": bert_n[kern.name],
                   **{p: n[kern.name] for p, n in serve_paths.items()}}
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
    # the forward at one prefill shape of the full-width LM (phase 30)
    entries[2]["prefill_shape"] = full["prefill_flash"]
    # the LRN kernels at AlexNet's conv1 LRN shape, f32 (the main path's
    # type); conv2's and the bf16 times are in lrn_times
    lt = lrn_times["alexnet_conv1_float32"]
    infer_n, train_n = alex_out["launches"], alex_train["launches"]
    # the forward's layout (path, rows a block, threads a row); the
    # backward's is the same (csrc/lrn_common.cuh)
    lrn_design = "{}, {} rows x {} threads a block".format(*lt["fwd_design"])
    for kern, kind in ((lfwd, "fwd"), (lbwd, "bwd")):
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": (infer_n[kern.name] + train_n[kern.name]
                         + lrn_import["launches"][kern.name]),
            "launches_by_path": {"alexnet_inference": infer_n[kern.name],
                                 "alexnet_training": train_n[kern.name],
                                 "lenet_training": lenet["launches"][
                                     kern.name],
                                 "tf_import": lrn_import["launches"][
                                     kern.name]},
            "max_abs_err": lrn_worst, "max_abs_err_bf16": lrn_worst_bf16,
            "ms": lt[f"{kind}_ms"], "device_ms": lt[f"{kind}_device_ms"],
            "plain_ms": lt[f"{kind}_plain_ms"],
            "bound_ms": lt[f"{kind}_bound_ms"],
            "bound_by": lt[f"{kind}_bound_by"],
            "library_ms": lt[f"library_{kind}_ms"],
            "library_device_ms": lt[f"library_{kind}_device_ms"],
            "shape": f"[{ALEXNET_BATCH}, 54, 54, 96] f32, depth 5",
            "design": lrn_design,
        })
    entries += gru_kernel_entries(by_name, gru_rows, gru_worst,
                                  gru_worst_bf16, gru_serve, gru_train,
                                  wide_gru, bidi_gru, gru_sass)
    for e in entries:  # YOLO2 runs none of the nine (phases 26-27)
        for path, counts in serve_paths.items():
            e["launches_by_path"].setdefault(path, counts[e["name"]])
        e["launches_by_path"]["yolo2_inference"] = yolo_out["launches"][
            e["name"]]
        e["launches_by_path"]["yolo2_training"] = yolo_train["launches"][
            e["name"]]
    for e in entries:  # the training runtime's paths (phases 32-35)
        paths = {"tbptt_charrnn": tbptt["launches"][e["name"]],
                 "fit_loop_lenet": fit_loop["launches"][e["name"]],
                 "transfer_resnet50": transfer["launches"][e["name"]],
                 "bert_training_remat": remat["remat"]["launches"][e["name"]],
                 "bert_training_no_remat": remat["no_remat"]["launches"][
                     e["name"]]}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
