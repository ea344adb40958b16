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
36. The observability slice. (a) BidirectionalGravesLSTMCharRnn (config
    #3) at B = 64, T = 64 with the guardrails armed from
    ``DL4J_TORCH_GUARDRAILS`` and ``DL4J_TORCH_GUARDRAILS_DIR`` (a temp
    directory): 6 clean armed steps bit for bit (``torch.equal``) the
    unarmed run from the same init, 4 + 4 LSTM launches a guarded step,
    one guarded step dispatched under the sync debug mode; then
    ``nan_grad`` at steps 6 and 7 under a ladder of skip budget 1: step 6
    skipped, step 7 clip-retried (the NaN survives the clip) and rolled
    back, the bisection naming step 7, every parameter finite, the launches
    of 12 steps and the ladder's replays. (b) BertBase at [32, 128] bf16
    armed (no rollback directory) against unarmed on one net, in turns
    unarmed, armed, armed, unarmed: wall ms, device ms and kernels a step,
    12 + 12 + 12 flash launches a step. (c) Phase 4's mix served with
    monitoring on and one ``RequestTrace`` a request, counted as in phase 4:
    the ``dl4j_generate_*`` counts equal to the streams, which equal the
    monitoring-off runs' bit for bit, every trace's spans nested, tokens/s
    on against off. (d) ``profiler.trace`` around two guarded config #3
    steps writes a Chrome trace naming the LSTM kernels;
    ``device_memory_mb`` against ``torch.cuda.memory_allocated``.
37. Keras import: keras.io's "Bidirectional LSTM on IMDB" (Embedding
    20000 x 128, Bidirectional(LSTM(64)) twice, Dense(1, sigmoid); maxlen
    200, batch 32) as a Keras-3 Sequential config written here, with
    random weights from the seed in Keras's layout, imported through the
    config-JSON half (``_build`` and the weight loader's ``reader=`` seam
    over a {name: [arrays]} mapping: the card's machine has no h5py):
    5 ``output()`` calls (4 LSTM forwards a call), 3 ``fit_batch`` steps
    against the port's CPU run of the same import (output and losses
    within TOL_KERAS_CPU relative, params within TOL_TRAIN_PARAM
    absolute), 10 counted steps (4 + 4 a step, losses
    falling) and a profiled call and step whose device records equal the
    host's counts. Then keras.io's "Simple MNIST convnet" at batch 128 on
    synthetic MNIST: a dropout-0 import's ``output()`` and 3 steps
    against the CPU, 3 steps of the import as it is (no kernel of the
    port).
38. The pretrain tier: dl4j-examples' VaeMNIST2dPlots VAE (784 -> 256,
    256 -> 2 -> 256, 256, leakyrelu, Bernoulli, RMSProp 1e-3, l2 1e-4)
    through ``pretrain`` over ``MnistDataSetIterator(128)`` (one epoch,
    at least 50 steps): the ELBO of a held batch under fixed noise
    before and after, and of the first batch's step before and after,
    must fall; no NaN; ms a step (wall over the epoch, device over 10
    steps on one batch); ``reconstruct`` in [0, 1]. Then a stacked
    denoising autoencoder (500, 250, corruption 0.3, xent, a 10-class
    head): ``pretrain``, then 10 ``fit_batch`` steps. No kernel of the
    port runs.
39. Quantized serving: ``net.quantize()`` of phase 30's LM (the pass's
    tensors and weight bytes through the monitoring bundle's
    ``observe_pass``) in ``GenerationEngine(slots=8, max_len=512,
    kv_dtype="int8")`` with phase 30's 16 requests, counted as in phase
    30 (12 flash forwards a prefill, one decode program replayed every
    step); tokens/s, TTFT and a steady decode step beside phase 30's bf16
    and int8 rings; an eager greedy rollout against the unquantized net
    (post-softmax difference, top-1 agreement); the witness over an
    eager prefill and decode step (nothing flagged) and its control (a
    weight dequantized by ``q * scale``, flagged). Then ResNet-50 (f32)
    quantized through ``ComputationGraph.quantize`` (the conv int8
    branch): logits at B = 64 on the card against the same view on the
    CPU within TOL_RESNET_CPU, ms a call beside the f32 graph's.
40. The serving tier over real HTTP on the loopback, one
    ``ServingGateway(device="cuda")``. (a) Config #3
    (``BidirectionalGravesLSTMCharRnn``, f32) written with ``write_model``
    and loaded through ``POST /models/load`` as charrnn/v1 (warm-up at
    the pow2 buckets of batch limit 32, seconds a bucket printed); 8
    client threads send 64 one-hot [64, 77] sequences, one a request,
    through ModelRegistry, AdmissionController and ParallelInference to
    ``net.output()``: timed (requests/s, latency p50 and p99, batch
    sizes), then counted under the profiler (4 LSTM forwards a
    dispatched batch, device records equal to the host's count); every
    response 200 and within TOL_SERVE of ``net.output()``; one batch
    dispatched under the sync debug mode (its host syncs and their call
    sites reported) and the host's JSON work a request, timed alone.
    (b) The zip loaded with ``quantize: "int8"`` as v2 (``/models`` shows
    it quantized; alone, within TOL_SERVE_INT8 of
    ``net.quantize().output()``), a 90/10 split, v1 hot-reloaded under
    load (every response 200 and within its version's tolerance), int4
    refused with 400. (c) Phase 30's full-width LM (bf16 ring, 8 slots)
    registered with a session journal: phase 30's 16 requests as
    concurrent streaming ``POST /v1/lm/generate`` calls, timed (tokens/s,
    TTFT p50, beside the engine driven directly in the same process),
    then counted (12 flash forwards a prefill on the device), every
    ndjson stream equal to the direct engine's token for token. (d)
    Phase 31's 1-layer cut behind a journaled gateway with a
    ``LifecycleManager`` (stub ``exit_fn``): ``preempt`` injected through
    ``faults`` at a decode step drains and journals four durable greedy
    sessions; a second engine and gateway resume them and each client
    reconnects with ``last_seq``: every stream equals the uninterrupted
    run. (e) One gateway serving both models at once: the predicts while
    a fresh engine's thread captures and replays its decode graph, the
    streams and the predicts held as before.
41. SameDiff: (a) config #4's BertBase (12 x 768, 12 heads, d_ff 3072,
    vocab 30522) built with the SameDiff API from a port BertBase's params
    (``samediff_bert``: embedding_lookup, positions, layer_norm, mmul,
    heads by reshape + transpose_ into dot_product_attention, gelu, mean
    pooling, cross_entropy), on a [32, 128] batch from the ported
    BertWordPieceTokenizer + BertIterator over a generated 30,522-piece
    vocabulary (every row full). f32: ``output()`` within TOL_SD_BERT_OUT
    of ``net.output()``; ``sd.grad`` at the start through the kernels
    against the same graph on the plain lowering (TOL_SD_BERT_GRAD), then
    3 Adam ``fit`` steps against it (TOL_SD_BERT_FIT); bf16 (the variables
    cast): ``output()`` (TOL_SD_BF16_PROBS), the gradients and 3 steps at
    an lr that moves bf16 weights, the same way. Each ``output()``
    launches 12 flash forwards and each step 12 forwards, 12 dq and 12
    dk/dv, the device's records equal to the host's. (b)
    TextGenerationLSTM through ``sd.nn.lstm_layer`` at [64, 64]: against
    ``net.output()``, 3 RMSProp steps against the plain lowering, 2 LSTM
    forwards a call and 2 + 2 a step on the cluster kernels. (c) AlexNet's
    conv1 block (B 128, 224 x 224 x 3, conv 11 x 11 / 4 to 96, ReLU,
    ``lrn``, max-pool 3 / 2, mean, dense 1000): against the plain lowering,
    1 LRN forward a call and 1 + 1 a step. (d) A TF GraphDef of (c)'s
    block through ``to_samediff`` on the card against the imported graph
    (TOL_SD_IMPORT), and (a)'s f32 graph saved as an .sdz and loaded on
    the card, its outputs equal bit for bit. Each part times ``output()``
    and a step (wall and device), (a) and (b) beside the net's own.
42. The parallel slice. (a) The flash ring of 4 replayed on the card
    (``replay_ring_flash``: rank r holds block (r - i) mod 4 at step i)
    at bench.py's long-context shape [1, 4, 8192, 128] (T_local 2048),
    forward and backward, causal and not, keys past 6000 padded (block 3
    wholly), f32 and bf16: o, lse, dq, dk, dv against one flash call over
    the whole sequence (each row's error over its norm) and against the
    plain versions (max |a - b| over max |b|) within TOL_SEQ, beside two
    controls that must
    miss it (each backward step given the block's own lse, or delta of the
    block's own o), 10 or 16 launches of each flash kernel, device ms
    against the one call's.
    Then, in an NCCL group of one rank that the phase creates and
    destroys: (b) an all-reduce's NCCL records in the profile; (c)
    BASELINE.json config #5: phase 20's ResNet-50 saved as a zip and
    loaded twice, ``ParallelWrapper(net, DeviceMesh(data=1))`` against the
    plain ``fit_batch``, 2 + 10 bf16 steps at B = 64: losses, params, BN
    state and updater state within TOL_PAR_LOSS / TOL_PAR_PARAM, an f32
    pass of 3 steps within TOL_PAR_PARAM beside a control (gradients
    halved) that must miss it, both passes on cuDNN's deterministic
    algorithms; step wall and device ms against plain on the default
    ones, the
    NCCL kernels of a step (53 BN statistics forward and back, one flat
    gradient buffer) and their device ms; (d) ``ring_attention``,
    ``ring_attention_zigzag`` and ``ulysses_attention`` at the
    long-context shape in bf16 against one ``flash_attention`` call,
    forward and gradients; (e) ``sequence_parallel_encoder`` (BERT-base's
    block, T = 2048), one ``TensorParallel`` step (a 2-layer LM of width
    768) and one ``switch_moe`` step (8 experts, 4096 tokens) against
    their single-device runs (TOL_PAR_MODULE).
43. The parallel slice, second half. Outside any group: (a) GPipe over
    BertBase's encoder (config #4's widths, dropout off), 4 stages of 3
    blocks, 4 microbatches of 8 from [32, 128], every stage's tick
    replayed on the card (``GPipe(mesh=None)``), bf16 and f32: the
    forward against ``sequential_reference`` and the net's own encoder
    output within TOL_PIPE, 3 ``pipeline_train_step`` Sgd steps with a
    [CLS] head against the same steps run sequentially within
    TOL_PIPE_STEP, beside controls that must miss (a stage's output
    dropped at one tick; the stages in the wrong order), 4 x 7 x 3 flash
    forwards (bubble ticks are computed, as in JAX), device ms of the
    replay's forward and forward + backward against the unpipelined
    stack; (b) HeteroPipe over config #2's ResNet-50 from phase 20's zip,
    cut by ``resnet50_pipeline_plan`` + ``graph_stage_fn``, 4
    microbatches of 16, against the net's output() within
    TOL_HETERO_RESNET, bf16 and f32, beside a control; (e) ``initialize_distributed``
    with NUM_PROCESSES=1 and two injected ``coord_connect`` refusals, its
    group on NCCL. In an NCCL group of one rank: (a) one
    ``GPipe(pipe=1)`` step equal to the sequential step bit for bit; (c)
    config #3 through ``SparkDl4jMultiLayer(DeviceMesh(data=1))`` at
    averaging_frequency 1 and 5, 10 steps each from a zip, equal to plain
    ``fit_batch`` bit for bit, beside a control (the average halved), 4 +
    4 LSTM launches a step on each route; (d) ``FaultTolerantTrainer``
    over ``ParallelWrapper(config #3)``, save_every 5, a preempt fault at
    step 7, a new trainer restoring step 5 and running to 10: equal to
    the uninterrupted run bit for bit, beside a control (a relaunch with
    nothing to restore); checkpoint save and restore ms; (f)
    ``ParallelInference(ResNet-50, mesh=DeviceMesh(data=1)).output`` at
    B = 64 equal to ``net.output``. The phase fails past 60 s of wall.
    After it, the three flash kernels (bf16) at the ring's step block
    [1, 4, 8192, 128] (causal) and the pipeline's microbatch
    [8, 12, 128, 64]: times, bounds and SDPA's.
44. Prints the kernels line (all nine kernels; the LRN entries count the
    import path's launches under ``launches_by_path["tf_import"]``, the
    flash forward the serving prefills of phases 29-30 and its prefill
    shape's times, every entry YOLO2's, 0, under ``"yolo2_inference"``
    and ``"yolo2_training"``, the training runtime's paths of phases
    32-35, the observability paths of phase 36, the import, pretrain
    and quantized paths of phases 37-39 and the serving tier's predict
    and generate paths of phase 40, SameDiff's paths of phase 41, the
    parallel paths of phases 42 and 43, and the flash kernels' rows at
    the parallel shapes), the card line and, last, the
    result line ``{"ok": true, "device": {...}}``.

Every phase's JSON record carries
``profiler_lead_in_records_lost_by_window``: for each window it profiled,
how many of the PROFILE_LEAD_IN spin kernels that open the session lost
their device records (a window that kept none is profiled again, up to
its ``tries``).

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


def emit(card: str, record: dict) -> None:
    """Print one phase's JSON record, with the card and the lead-in
    records each of the phase's profiled windows lost
    (take_lead_in_losses)."""
    record = dict(record, card=card,
                  profiler_lead_in_records_lost_by_window=(
                      take_lead_in_losses()))
    print(json.dumps(record), flush=True)


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


# the lead-in records each profiled window lost (PROFILE_LEAD_IN less the
# spin kernels' records it kept), window by window, since the last phase
# record took them (take_lead_in_losses): every phase's JSON record prints
# its windows' losses. A loss of PROFILE_LEAD_IN means the loss may have
# run past the lead-in into the profiled calls.
LEAD_IN_LOSSES: list = []


def take_lead_in_losses() -> list:
    """The lead-in losses logged since the last call, and clear the log."""
    out = list(LEAD_IN_LOSSES)
    LEAD_IN_LOSSES.clear()
    return out


def _device_records(prof):
    """A profile's device records, {record name: (device ms, count)}
    without the lead-in's, and the lead-in records it kept (the window's
    loss is logged in LEAD_IN_LOSSES)."""
    out, lead_in = {}, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and _device_us(e) > 0:
            if "spin_kernel" in e.key:
                lead_in += e.count
            else:
                out[e.key] = (_device_us(e) / 1e3, e.count)
    LEAD_IN_LOSSES.append(PROFILE_LEAD_IN - lead_in)
    return out, lead_in


def profile_device(torch, fn, iters: int, tries: int = 3):
    """``iters`` calls of ``fn`` under torch.profiler, the session opened
    by the lead-in (_lead_in). A window whose lead-in kept no record (its
    loss may then reach into the calls, and its device times be short) is
    profiled again, up to ``tries`` windows. Returns the device time by
    kernel name, {name: (total_ms, count)} (empty if the profiler saw no
    device activity), the wall ms of the profiled calls, and the lead-in
    records the last window lost."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in(torch)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel, lead_in = _device_records(prof)
        if lead_in:
            break
    return by_kernel, wall_ms, PROFILE_LEAD_IN - lead_in


def kernel_device_ms(torch, fn, iters: int, symbol: str, tries: int = 3):
    """Mean device time of one launch of the kernel named ``symbol``. The
    profiler now and then keeps no device record of a window (on the H100,
    in a window of 2 ms as well as in shorter ones), so a window without
    the kernel is profiled again, at twice the calls, up to ``tries``
    times; None if none shows it."""
    for _ in range(tries):
        by_kernel, _, _ = profile_device(torch, fn, iters)
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
        by_kernel, wall_ms, _ = profile_device(torch, fn, calls)
        seen = {name: sum(c for key, (_, c) in by_kernel.items()
                          if name in key) for name in want}
        if all(seen[k] == n * calls for k, n in want.items()):
            break
    return by_kernel, wall_ms, seen


def call_device_ms(torch, fn, iters: int):
    """Device time of one call of ``fn``: the sum of every kernel it runs
    (a library call's yardstick, free of the host's clock)."""
    by_kernel, _, _ = profile_device(torch, fn, iters)
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


def lstm_serving_requests(np, vocab):
    """Phase 4's mix: N_REQUESTS prompts of 4-48 tokens asking 8-64 new
    ones, greedy and sampled (top-k 40) in turn, from SEED."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(4, 49, N_REQUESTS)
    news = rng.integers(8, 65, N_REQUESTS)
    return [dict(prompt=rng.integers(0, vocab, int(n)).tolist(),
                 max_new_tokens=int(m),
                 **({} if i % 2 == 0 else
                    dict(temperature=0.8, top_k=40, seed=1000 + i)))
            for i, (n, m) in enumerate(zip(lens, news))]


def phase_main_path(torch, np):
    """Serve TextGenerationLSTM through the engine; returns a summary."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(seed=SEED).init(device="cuda")
    vocab = net.layers[-1].n_out
    eng = GenerationEngine(net, slots=8, max_len=256, device="cuda")
    eng.generate([1, 2, 3, 4], max_new_tokens=2)  # warm-up, not counted
    reqs = lstm_serving_requests(np, vocab)

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

    by_kernel, prof_wall, _ = profile_device(
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
    by_kernel, prof_wall, _ = profile_device(
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

    by_kernel, prof_wall, _ = profile_device(torch, lambda: net.output(x),
                                             calls)
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
    by_kernel, prof_wall, _ = profile_device(
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
    by_kernel, prof_wall, _ = profile_device(
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
    by_kernel, prof_wall, _ = profile_device(torch, lambda: net.output(x),
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
    by_kernel, prof_wall, _ = profile_device(
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
    """Largest |a - b| over the largest |b|, on b's device."""
    b = b.float()
    return float((a.float().to(b.device) - b).abs().max()) / max(
        float(b.abs().max()), 1e-30)


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
    by_kernel, prof_wall, _ = profile_device(torch, lambda: net.output(x),
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

    by_kernel, prof_wall, _ = profile_device(torch, window, steps)
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
    by_kernel, prof_wall, _ = profile_device(
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
    errs = {"card_vs_cpu": max(_max_rel(a, b)
                               for a, b in zip(card, cpu)),
            "on_vs_off": max(_max_rel(a, b) for a, b in zip(card, off))}
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
    by_kernel, prof_wall, _ = profile_device(torch, lambda: imp.output(big), 2)
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
    grad_rel = _max_rel(gw, gp)
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
        worst = max(worst, _max_rel(a, b))
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
    step_prof, step_wall, _ = profile_device(torch, eng.step, n)
    step_ms = host_ms(torch, eng.step, n)
    replay_prof, _, _ = profile_device(torch, eng.decode_pool, n)
    replay_ms = host_ms(torch, eng.decode_pool, n)
    state = tree_map(lambda t: t.clone(), eng.pool.state)
    tokens, pos = eng._inputs[0].clone(), eng._inputs[1].clone()
    eager = lambda: eng.adapter.decode(state, tokens, pos)  # noqa: E731
    eager_prof, _, _ = profile_device(torch, eager, n)
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
    rel = _max_rel(got, want)
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
    by_kernel, prof_wall, _ = profile_device(
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


# ------------------------------------------------ the observability slice

N_GUARD_STEPS = 6        # phase 36(a): the armed and unarmed clean runs
GUARD_FAULT_STEP = 6     # phase 36(a): nan_grad at this step and the next
N_GUARD_FAULT_STEPS = 12
GUARD_CLIPNORM = 5.0     # the ladder's clip, config #3's own clipping
N_GUARD_COST_STEPS = 5   # phase 36(b): timed BertBase steps a turn
N_GUARD_COST_PROFILED = 2


def _arm_from_env(**values):
    """Set (a string) or clear (None) DL4J_TORCH_<name> variables and
    reload the port's env."""
    from deeplearning4j_tpu_torch.common.env import env

    for k, v in values.items():
        if v is None:
            os.environ.pop(f"DL4J_TORCH_{k}", None)
        else:
            os.environ[f"DL4J_TORCH_{k}"] = v
    env.reload()


def _flight_actions(rec):
    """The numeric_trip incidents the flight recorder holds: [(step,
    action, trip kind, culprit step)]."""
    return [(e["step"], e["action"], e["trip"], e.get("culprit_step"))
            for e in rec.tail() if e["kind"] == "numeric_trip"]


def phase_guardrails(torch, np):
    """36(a): BidirectionalGravesLSTMCharRnn (config #3) at B = 64, T = 64
    with the guardrails armed from DL4J_TORCH_GUARDRAILS(_DIR): a clean
    armed run bit for bit the unarmed run from the same init, 4 + 4 LSTM
    launches a guarded step, one guarded step dispatched with no host
    sync; then nan_grad at steps GUARD_FAULT_STEP and the next under a
    ladder of skip budget 1: the first trip skipped, the second clip-retried
    (the NaN survives the clip) and rolled back, the bisection naming it,
    every parameter finite at the end. Returns the record and the armed
    net (phase 36(d) traces it)."""
    import tempfile

    from deeplearning4j_tpu_torch import faults, guardrails, monitoring
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.guardrails import GuardrailPolicy
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
    from deeplearning4j_tpu_torch.zoo import BidirectionalGravesLSTMCharRnn

    model = BidirectionalGravesLSTMCharRnn(seed=SEED)
    V, B, T = model.vocab_size, 64, model.timesteps
    n_lstm = 2 * model.layers
    rng = np.random.default_rng(SEED + 60)
    batches = [_char_batch(np, rng, V, B, T)
               for _ in range(N_GUARD_FAULT_STEPS)]
    tmp = tempfile.mkdtemp(prefix="dl4j-guard-")

    # the clean runs: unarmed, then armed from the environment
    plain = model.init(device="cuda")
    init = [t.clone() for t in tree_leaves(plain.params)]
    plain_losses = [float(v) for v in
                    [plain.fit_batch(b) for b in batches[:N_GUARD_STEPS]]]
    _arm_from_env(GUARDRAILS="1", GUARDRAILS_DIR=tmp)
    try:
        armed = model.init(device="cuda")
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(armed.params), init)):
            fail("config #3: two inits from one seed differ")
        losses, launches, _, wall = _count_launches(
            torch, KERNELS,
            lambda: [armed.fit_batch(b) for b in batches[:N_GUARD_STEPS]])
        losses = [float(v) for v in losses]
        guard = guardrails.get_guard(armed)
    finally:
        _arm_from_env(GUARDRAILS=None, GUARDRAILS_DIR=None)
    if guard is None or guard.checkpointer is None \
            or guard.checkpointer.directory != tmp:
        fail("DL4J_TORCH_GUARDRAILS(_DIR) did not arm config #3 with its "
             "rollback directory")
    want = n_lstm * N_GUARD_STEPS
    if launches != _only(KERNELS, fused_lstm_fwd=want, fused_lstm_bwd=want):
        fail(f"config #3: {N_GUARD_STEPS} guarded steps launched {launches}"
             f"; want {n_lstm} of each LSTM kernel a step")
    bitwise = losses == plain_losses and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves((armed.params, armed.opt_state, armed.state)),
            tree_leaves((plain.params, plain.opt_state, plain.state))))
    if not bitwise or guard.trips:
        fail(f"config #3: the armed, untripped run ({guard.trips} trips) is "
             f"not the unarmed run bit for bit: losses {losses} against "
             f"{plain_losses}")
    drain_scores(armed)
    h = no_host_sync(torch, lambda: armed.fit_batch(batches[0]),
                     "guarded config #3")
    if h.ready():
        fail("the guarded step's score was fetched at dispatch")
    drain_scores(armed)

    # the ladder: nan_grad at two steps in a row
    net = model.init(device="cuda")
    guard_f = guardrails.arm(net, GuardrailPolicy(
        skip_budget=1, clip_retry=True, clipnorm=GUARD_CLIPNORM,
        checkpoint_every=4, warmup_steps=10_000),
        checkpoint_dir=tempfile.mkdtemp(prefix="dl4j-ladder-"))
    replays = []
    replay_one = guard_f._replay_one

    def counted_replay(model_, entry, clip):
        replays.append((int(entry[0]), float(clip)))
        return replay_one(model_, entry, clip)

    guard_f._replay_one = counted_replay
    rec = monitoring.flight.configure(enabled=True)
    S = GUARD_FAULT_STEP
    try:
        def ladder():
            out = [net.fit_batch(b) for b in batches]
            drain_scores(net)  # the last trips resolve inside the count
            return out

        with faults.injected(f"nan_grad:2@step>={S}"):
            handles, ladder_launches, _, ladder_wall = _count_launches(
                torch, KERNELS, ladder)
        actions = _flight_actions(rec)
    finally:
        monitoring.flight.reset()
    scores = [float(h) for h in handles]
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves((net.params, net.opt_state)))
    want_actions = [(S, "skip", "nonfinite", None),
                    (S + 1, "rollback", "nonfinite", S + 1)]
    bad = [i for i, v in enumerate(scores) if not np.isfinite(v)]
    if (actions != want_actions or guard_f.quarantined != [S, S + 1]
            or guard_f.rollbacks != 1 or not replays
            or replays[0] != (S + 1, GUARD_CLIPNORM) or not finite
            or bad != [S, S + 1]):
        fail(f"config #3 under nan_grad at steps {S} and {S + 1}: actions "
             f"{actions} (want {want_actions}), quarantined "
             f"{guard_f.quarantined}, {guard_f.rollbacks} rollbacks, "
             f"replays {replays}, params finite {finite}, non-finite "
             f"scores at {bad}")
    want_l = n_lstm * (N_GUARD_FAULT_STEPS + len(replays))
    if ladder_launches != _only(KERNELS, fused_lstm_fwd=want_l,
                                fused_lstm_bwd=want_l):
        fail(f"config #3 ladder: {ladder_launches}; want {want_l} of each "
             f"LSTM kernel ({N_GUARD_FAULT_STEPS} steps and "
             f"{len(replays)} replays)")
    return {
        "model": "BidirectionalGravesLSTMCharRnn(units=200, layers=2, "
                 "vocab=77), Adam 1e-3, clipping 5.0",
        "batch": B, "timesteps": T,
        "clean": {"steps": N_GUARD_STEPS, "bitwise_vs_unarmed": bitwise,
                  "losses": losses, "launches": launches,
                  "launches_per_step": {k: v / N_GUARD_STEPS
                                        for k, v in launches.items() if v},
                  "step_wall_ms": 1e3 * wall / N_GUARD_STEPS,
                  "checkpoint_dir_from_env": True,
                  "no_host_sync_step": True},
        "ladder": {"fault": f"nan_grad:2@step>={S}", "steps":
                   N_GUARD_FAULT_STEPS, "actions": actions,
                   "culprit_step": actions[-1][3],
                   "quarantined": guard_f.quarantined,
                   "trips": guard_f.trips, "rollbacks": guard_f.rollbacks,
                   "steps_lost": guard_f.steps_lost,
                   "bisect_probes": guard_f.last_bisect_probes,
                   "replays": replays, "scores": scores,
                   "params_finite": finite, "launches": ladder_launches,
                   "wall_s": ladder_wall},
    }, armed, batches[0]


def phase_guardrail_cost(torch, np):
    """36(b): BertBase at [32, 128] bf16, the guardrails armed (no rollback
    directory) against unarmed on one net, in turns unarmed, armed, armed,
    unarmed: wall ms a step over N_GUARD_COST_STEPS, device ms and kernels
    a step under the profiler, and 12 + 12 + 12 flash launches a step."""
    from deeplearning4j_tpu_torch import guardrails
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores
    from deeplearning4j_tpu_torch.zoo import BertBase

    x, y, m = _bert_batch(np, SEED + 61)
    net = BertBase(seed=SEED, max_len=128).init(device="cuda")

    def steps(n):
        out = [net.fit_batch((x, y, m)) for _ in range(n)]
        drain_scores(net)
        return out

    turns, launches_by = [], {}
    for armed in (False, True, True, False):
        if armed:
            guard = guardrails.arm(net)
        steps(1)  # warm-up, not counted
        out, launches, _, wall = _count_launches(
            torch, KERNELS, lambda: steps(N_GUARD_COST_STEPS))
        per = 12 * N_GUARD_COST_STEPS
        if launches != _only(KERNELS, flash_attention_fwd=per,
                             flash_attention_dq=per,
                             flash_attention_dkv=per):
            fail(f"BertBase armed={armed}: {N_GUARD_COST_STEPS} steps "
                 f"launched {launches}; want 12 of each flash kernel a step")
        if not all(np.isfinite(float(v)) for v in out):
            fail(f"BertBase armed={armed}: losses {out}")
        by_kernel, prof_wall, lost = profile_device(
            torch, lambda: steps(1), N_GUARD_COST_PROFILED)
        key = "armed" if armed else "unarmed"
        for k, v in launches.items():
            launches_by.setdefault(key, {}).setdefault(k, 0)
            launches_by[key][k] += v
        turns.append({"armed": armed,
                      "step_wall_ms": 1e3 * wall / N_GUARD_COST_STEPS,
                      "profile": _profile_summary(
                          by_kernel, prof_wall, N_GUARD_COST_PROFILED,
                          "step"),
                      "lead_in_records_lost": lost})
        if armed:
            if guard.trips:
                fail(f"BertBase: the armed run tripped {guard.trips} times")
            guardrails.disarm(net)

    def mean(key, armed):
        vals = [t["profile"][key] if key in t["profile"] else t[key]
                for t in turns if t["armed"] == armed]
        return sum(vals) / len(vals)

    # the guarded step's two additions alone, on this net's trees: the
    # sentinel's screen of the gradients (the hot variant) and the select
    # of params and Adam moments
    from deeplearning4j_tpu_torch.common.trees import (
        tree_leaves, tree_unflatten,
    )
    from deeplearning4j_tpu_torch.guardrails import sentinel

    grads = tree_unflatten(net.params, list(_bert_grads(torch, net, x, y,
                                                        m)))
    loss = torch.ones((), device="cuda")
    ctrl = torch.tensor([0.0, 0.0, 6.0, 0.0, -1.0], device="cuda")
    ok = torch.ones((), dtype=torch.bool, device="cuda")

    def screen():
        return sentinel.screen(grads, loss, ctrl, with_clip=False)

    def select():
        return (sentinel.tree_select(ok, net.params, net.params),
                sentinel.tree_select(ok, net.opt_state, net.opt_state))

    leaves = len(tree_leaves(net.params))
    parts = {"param_leaves": leaves,
             "param_bytes": sum(t.numel() * t.element_size()
                                for t in tree_leaves(net.params)),
             "screen_host_ms": host_ms(torch, screen, 5),
             "screen_device_ms": call_device_ms(torch, screen, 3),
             "select_host_ms": host_ms(torch, select, 5),
             "select_device_ms": call_device_ms(torch, select, 3)}
    del grads

    summary = {k: {"unarmed": mean(k, False), "armed": mean(k, True)}
               for k in ("step_wall_ms", "device_ms_per_step",
                         "device_kernels_per_step")}
    for v in summary.values():
        v["armed_minus_unarmed"] = v["armed"] - v["unarmed"]
    return {"model": "BertBase(12 x 768, max_len 128), bf16, AdamW",
            "batch": 32, "timesteps": 128, "turns": turns,
            "summary": summary, "parts": parts, "launches": launches_by,
            "flash_launches_per_step": {"fwd": 12, "dq": 12, "dkv": 12}}


def _nested(doc):
    """A request trace's "X" spans as B/E pairs on one track (outer spans
    first, a span that ends where the next begins closed first), for
    validate_nesting: a span that starts inside another and ends after it
    comes out unbalanced. Zero-length spans cannot overlap and are left
    out."""
    # times in whole nanoseconds, the monotonic clock's resolution: a span
    # that ends where the next begins may otherwise end an ulp after it
    def ns(us):
        return round(us * 1e3)

    xs = sorted((e for e in doc["traceEvents"]
                 if e["ph"] == "X" and ns(e["dur"]) > 0),
                key=lambda e: (ns(e["ts"]), -ns(e["dur"])))
    marks = []
    for i, e in enumerate(xs):
        marks.append(((ns(e["ts"]), 1, i), {"ph": "B", "name": e["name"],
                                            "tid": 0}))
        marks.append(((ns(e["ts"] + e["dur"]), 0, -i),
                      {"ph": "E", "name": e["name"], "tid": 0}))
    return [ev for _, ev in sorted(marks, key=lambda m: m[0])]


def phase_monitored_serving(torch, np):
    """36(c): phase 4's mix (TextGenerationLSTM, 8 slots, 16 requests)
    served with monitoring on and one RequestTrace a request, against the
    same engine with monitoring off: the streams bit for bit, the
    dl4j_generate_* counts equal to the streams, every trace's spans
    nested, and tokens/s on against off."""
    from deeplearning4j_tpu_torch import monitoring
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.monitoring import validate_nesting
    from deeplearning4j_tpu_torch.monitoring.context import RequestTracer
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(seed=SEED).init(device="cuda")
    vocab = net.layers[-1].n_out
    eng = GenerationEngine(net, slots=8, max_len=256, device="cuda")
    eng.generate([1, 2, 3, 4], max_new_tokens=2)  # warm-up, the capture
    reqs = lstm_serving_requests(np, vocab)
    traced = {}

    def serve(counted, on=True):
        monitoring.reset()
        if on:
            monitoring.enable()
        tracer = RequestTracer(capacity=2 * N_REQUESTS)
        traces = ([tracer.begin("generate") for _ in reqs] if on
                  else [None] * len(reqs))
        out = [eng.submit(r.pop("prompt"), trace=t, **r)
               for r, t in zip([dict(q) for q in reqs], traces)]
        eng.drain()
        if on:
            for t, st in zip(traces, out):
                tracer.finish(t, "served", reason=st.finish_reason)
            traced["traces"] = traces
        return out

    def timed_off():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(False, on=False)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    off, off_wall = timed_off()
    try:
        run = _engine_launches(torch, eng, KERNELS, serve,
                               what="monitored, traced LSTM serving")
        reg = monitoring.registry()
        fam = {n: reg.get(f"dl4j_generate_{n}") for n in (
            "tokens_total", "requests_total", "ttft_seconds",
            "inter_token_seconds", "decode_steps_total", "prefill_seconds")}
        counts = {
            "tokens_total": fam["tokens_total"].value,
            "requests_total": {k[0]: c.value for k, c in
                               fam["requests_total"].children()},
            "ttft_count": fam["ttft_seconds"].count,
            "inter_token_count": fam["inter_token_seconds"].count,
            "decode_steps_total": fam["decode_steps_total"].value,
            "prefill_count": fam["prefill_seconds"].count}
        exemplars = {e[0]["trace_id"] for e in
                     fam["ttft_seconds"]._only().exemplars().values()}
    finally:
        monitoring.reset()
    off2, off2_wall = timed_off()
    streams, traces = run["streams"], traced["traces"]
    n_tokens = sum(len(st.tokens) for st in streams)
    if [st.tokens for st in streams] != [st.tokens for st in off] \
            or [st.tokens for st in off2] != [st.tokens for st in off]:
        fail("monitored serving: the streams differ from the monitoring-off"
             " run's")
    want = {"tokens_total": n_tokens, "requests_total": {"length": N_REQUESTS},
            "ttft_count": N_REQUESTS,
            "inter_token_count": n_tokens - N_REQUESTS,
            "decode_steps_total": run["steps"],
            "prefill_count": N_REQUESTS}
    ids = {t.trace_id for t in traces}
    if counts != want or not exemplars or not exemplars <= ids:
        fail(f"monitored serving: dl4j_generate_* {counts}; want {want} "
             f"(TTFT exemplars {sorted(exemplars)[:3]})")
    for t in traces:
        summ = t.summary()
        stages = {k: v["count"] for k, v in summ["stages"].items()}
        if stages != {"queue_wait": 1, "prefill": 1, "decode": 1} \
                or summ["events"] != ["admit", "retire"]:
            fail(f"trace {t.trace_id}: stages {stages}, events "
                 f"{summ['events']}")
        try:
            validate_nesting(_nested(t.to_chrome()))
        except ValueError as e:
            fail(f"trace {t.trace_id}: {e}")
    n_prefill = sum(1 for r in reqs if len(r["prompt"]) > 1)
    if run["launches"] != _only(KERNELS, fused_lstm_fwd=(
            2 * run["steps"] + 2 * n_prefill)):
        fail(f"monitored serving launched {run['launches']}")
    tps_on = n_tokens / run["wall_s"]
    tps_off = [n_tokens / w for w in (off_wall, off2_wall)]
    return {
        "model": "TextGenerationLSTM(units=256, layers=2, vocab=77)",
        "slots": 8, "requests": N_REQUESTS, "tokens": n_tokens,
        "decode_steps": run["steps"], "replays": run["replays"],
        "generate_counts": counts, "traces": len(traces),
        "trace_stages": {"queue_wait": 1, "prefill": 1, "decode": 1},
        "streams_equal_monitoring_off": True,
        "tokens_per_s_on": tps_on, "tokens_per_s_off": tps_off,
        "wall_s_on": run["wall_s"], "wall_s_off": [off_wall, off2_wall],
        "launches": run["launches"],
    }


def phase_profiler_sysmetrics(torch, np, net, batch):
    """36(d): ``profiler.trace`` around two guarded config #3 steps writes a
    Chrome trace that names the LSTM forward and backward kernels (the
    session opened by the lead-in, whose kept records are counted); and
    ``device_memory_mb`` reads what torch.cuda.memory_allocated reads."""
    import tempfile

    from deeplearning4j_tpu_torch import profiler
    from deeplearning4j_tpu_torch.common.sysmetrics import device_memory_mb
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS, fused_lstm
    from deeplearning4j_tpu_torch.optimize.async_dispatch import drain_scores

    drain_scores(net)
    logdir = tempfile.mkdtemp(prefix="dl4j-trace-")
    fwd_names = set(fused_lstm.FWD_KERNEL_NAMES.values())
    bwd_names = set(fused_lstm.BWD_KERNEL_NAMES.values())
    for _ in range(3):
        with profiler.trace(logdir) as prof:
            _lead_in(torch)
            _, launches, _, _ = _count_launches(
                torch, KERNELS, lambda: ([net.fit_batch(batch)
                                          for _ in range(2)],
                                         drain_scores(net)))
        doc = json.load(open(prof.trace_path))
        kernels = [e["name"] for e in doc["traceEvents"]
                   if e.get("cat") == "kernel"]
        lead_in = sum("spin_kernel" in k for k in kernels)
        LEAD_IN_LOSSES.append(PROFILE_LEAD_IN - lead_in)
        seen = {"fwd": sum(any(f in k for f in fwd_names) for k in kernels),
                "bwd": sum(any(f in k for f in bwd_names) for k in kernels)}
        if seen["fwd"] == launches["fused_lstm_fwd"] \
                and seen["bwd"] == launches["fused_lstm_bwd"]:
            break
    if not (seen["fwd"] and seen["bwd"]):
        fail(f"the Chrome trace of two guarded steps names no LSTM kernel: "
             f"{sorted(set(kernels))[:8]}")
    dev = torch.device("cuda", torch.cuda.current_device())
    mem = device_memory_mb(dev)
    allocated = torch.cuda.memory_allocated(dev) / (1 << 20)
    if mem.get("device_mem_in_use_mb") != allocated \
            or not mem["device_mem_peak_mb"] >= allocated \
            or not mem["device_mem_limit_mb"] > allocated:
        fail(f"device_memory_mb {mem} against memory_allocated {allocated}")
    return {"trace_bytes": os.path.getsize(prof.trace_path),
            "trace_kernel_events": len(kernels),
            "lstm_kernels_named": seen, "launches": launches,
            "lead_in_records_kept": lead_in,
            "device_memory_mb": mem, "memory_allocated_mb": allocated}


# ------------------------- Keras import, pretrain tier, int8 weights
# phase 37: keras.io's "Bidirectional LSTM on IMDB" (max_features 20000,
# maxlen 200, Embedding 128, two Bidirectional(LSTM(64)), batch 32) and
# "Simple MNIST convnet" (batch 128), imported from Keras-3 config JSON
IMDB_VOCAB, IMDB_MAXLEN, IMDB_BATCH = 20000, 200, 32
IMDB_EMBED, IMDB_UNITS = 128, 64
N_KERAS_CALLS = 5
N_KERAS_STEPS = 10
N_KERAS_CPU_STEPS = 3
MNIST_CNN_BATCH = 128
# the imported nets on the card against the port's CPU run of the same
# import, f32, TF32 off: outputs and losses at the earlier card-against-CPU
# phases' relative limit (max |card - cpu| over max |cpu|); params after
# Adam steps at phase 7's TOL_TRAIN_PARAM (_against_cpu says why)
TOL_KERAS_CPU = 1e-5
# phase 38: dl4j-examples' VaeMNIST2dPlots (784 -> 256, 256 -> 2 -> 256,
# 256, leakyrelu, Bernoulli, RMSProp 1e-3, l2 1e-4, minibatch 128)
VAE_BATCH = 128
N_VAE_MIN_STEPS = 50
N_VAE_DEVICE_STEPS = 10
N_SDA_STEPS = 10
# phase 39: the quantized full-width LM and ResNet-50
N_QUANT_ROLLOUT = 32
QUANT_ROLLOUT_PROMPT = 64
QUANT_RESNET_BATCH = 64


def _glorot(np, rng, shape, fan_in, fan_out):
    """Keras's glorot_uniform."""
    a = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-a, a, shape).astype(np.float32)


def _keras_lstm_weights(np, rng, F, H):
    """One Keras LSTM's variables as Keras lays them out (kernel [F, 4H],
    recurrent kernel [H, 4H], bias [4H]; gates i, f, c, o) at Keras's
    initializers: glorot_uniform, orthogonal, zeros with the forget gate's
    bias at 1 (unit_forget_bias)."""
    q, r = np.linalg.qr(rng.normal(size=(4 * H, H)))
    rec = (q * np.sign(np.diag(r))).T.astype(np.float32)
    bias = np.zeros(4 * H, np.float32)
    bias[H:2 * H] = 1.0
    return [_glorot(np, rng, (F, 4 * H), F, 4 * H), rec, bias]


def imdb_bilstm(np):
    """keras.io's "Bidirectional LSTM on IMDB" as a Keras-3 Sequential
    config, at maxlen 200, and its weights from the seed in Keras's layout
    ({Keras layer name: [arrays]}; a Bidirectional's forward variables,
    then its backward ones)."""
    def bidi(name, inner, seq):
        return {"class_name": "Bidirectional", "config": {
            "name": name, "merge_mode": "concat", "layer": {
                "class_name": "LSTM", "config": {
                    "name": inner, "units": IMDB_UNITS,
                    "activation": "tanh", "recurrent_activation": "sigmoid",
                    "return_sequences": seq}}}}

    cfg = {"class_name": "Sequential", "config": {"name": "sequential",
                                                  "layers": [
        {"class_name": "InputLayer", "config": {
            "name": "input_layer", "batch_shape": [None, IMDB_MAXLEN],
            "dtype": "int32"}},
        {"class_name": "Embedding", "config": {
            "name": "embedding", "input_dim": IMDB_VOCAB,
            "output_dim": IMDB_EMBED}},
        bidi("bidirectional", "forward_lstm", True),
        bidi("bidirectional_1", "forward_lstm_1", False),
        {"class_name": "Dense", "config": {"name": "dense", "units": 1,
                                           "activation": "sigmoid"}}]}}
    rng = np.random.default_rng(SEED)
    H, E = IMDB_UNITS, IMDB_EMBED
    weights = {
        "embedding": [rng.uniform(-0.05, 0.05, (IMDB_VOCAB, E)).astype(
            np.float32)],
        "bidirectional": (_keras_lstm_weights(np, rng, E, H)
                          + _keras_lstm_weights(np, rng, E, H)),
        "bidirectional_1": (_keras_lstm_weights(np, rng, 2 * H, H)
                            + _keras_lstm_weights(np, rng, 2 * H, H)),
        "dense": [_glorot(np, rng, (2 * H, 1), 2 * H, 1),
                  np.zeros(1, np.float32)]}
    return cfg, weights


def mnist_convnet(np, dropout=0.5):
    """keras.io's "Simple MNIST convnet" as a Keras-3 Sequential config and
    its weights from the seed (glorot_uniform kernels, zero biases)."""
    def conv(name, filters):
        return {"class_name": "Conv2D", "config": {
            "name": name, "filters": filters, "kernel_size": [3, 3],
            "activation": "relu", "padding": "valid"}}

    def pool(name):
        return {"class_name": "MaxPooling2D", "config": {
            "name": name, "pool_size": [2, 2]}}

    cfg = {"class_name": "Sequential", "config": {"name": "sequential",
                                                  "layers": [
        {"class_name": "InputLayer", "config": {
            "name": "input_layer", "batch_shape": [None, 28, 28, 1]}},
        conv("conv2d", 32), pool("max_pooling2d"),
        conv("conv2d_1", 64), pool("max_pooling2d_1"),
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        {"class_name": "Dropout", "config": {"name": "dropout",
                                             "rate": dropout}},
        {"class_name": "Dense", "config": {"name": "dense", "units": 10,
                                           "activation": "softmax"}}]}}
    rng = np.random.default_rng(SEED + 1)
    weights = {
        "conv2d": [_glorot(np, rng, (3, 3, 1, 32), 9, 288),
                   np.zeros(32, np.float32)],
        "conv2d_1": [_glorot(np, rng, (3, 3, 32, 64), 288, 576),
                     np.zeros(64, np.float32)],
        "dense": [_glorot(np, rng, (1600, 10), 1600, 10),
                  np.zeros(10, np.float32)]}
    return cfg, weights


def keras_import(cfg, weights, device):
    """The config-JSON half of the Keras importer: ``_build`` on
    ``device``, then the weights through the loader's ``reader=`` seam
    from the {name: [arrays]} mapping (no h5py: the card's machine has
    none)."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport

    net = KerasModelImport._build(cfg, device=device)
    KerasModelImport._load_weights(net, weights, cfg,
                                   reader=lambda w, name: w.get(name, []))
    return net


def _param_diffs(torch, net, cpu):
    """The params of the card's net against the CPU's: the largest
    absolute difference, the same over the tree's largest magnitude, and
    the three leaves of the largest difference with their magnitudes."""
    got, want = net.params_table(), cpu.params_table()
    rows = sorted(((float((got[k].float().cpu() - w.float()).abs().max()),
                    float(w.float().abs().max()), k)
                   for k, w in want.items()), reverse=True)
    top = max(m for _, m, _ in rows)
    return rows[0][0], rows[0][0] / top, [
        {"leaf": k, "max_abs_diff": d, "max_abs": m} for d, m, k in rows[:3]]


def _against_cpu(torch, np, net, cpu, x, y, steps, what):
    """``output()`` and ``steps`` fit_batch steps of the card's import
    against the CPU's: the output and the losses within TOL_KERAS_CPU
    relative, the params within phase 7's TOL_TRAIN_PARAM absolute. Adam's
    update lr * m / (sqrt(v) + eps) turns the rounding of a gradient
    component near eps (a sum that cancels, summed in another order on
    the card) into a difference up to lr / (4 eps) = 2.5e4 times larger:
    the MNIST convnet's dense W read 2.1e-6 apart after 3 steps (3.2e-5
    of that leaf's largest weight) where its outputs and losses agree to
    3e-7."""
    out = _max_rel(net.output(x).cpu(), cpu.output(x))
    card = [float(net.fit_batch((x, y))) for _ in range(steps)]
    host = [float(cpu.fit_batch((x, y))) for _ in range(steps)]
    pabs, prel, worst = _param_diffs(torch, net, cpu)
    err = {"output": out,
           "losses": max(abs(a - b) / abs(b) for a, b in zip(card, host))}
    if not (all(e <= TOL_KERAS_CPU for e in err.values())
            and pabs <= TOL_TRAIN_PARAM):
        fail(f"{what}, card against CPU: {err} relative (tolerance "
             f"{TOL_KERAS_CPU}), params {pabs} absolute (tolerance "
             f"{TOL_TRAIN_PARAM}), worst leaves {worst}")
    return {"max_rel_err": err, "param_max_abs_err": pabs,
            "param_max_err_over_largest_param": prel,
            "worst_param_leaves": worst, "steps": steps,
            "card_losses": card, "cpu_losses": host}


def phase_keras_import(torch, np):
    """The imported IMDB BiLSTM on the card: output() calls and fit_batch
    steps through the LSTM kernels, counted, against the CPU; then the
    imported MNIST convnet against the CPU."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    cfg, weights = imdb_bilstm(np)
    t0 = time.perf_counter()
    net = keras_import(cfg, weights, "cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    kinds = [type(l).__name__ for l in net.layers]
    if kinds != ["EmbeddingSequenceLayer", "BidirectionalLayer",
                 "LastTimeStepLayer", "OutputLayer"] or \
            net.layers[-1].loss != "xent":
        fail(f"the IMDB BiLSTM imported as {kinds}")
    cpu = keras_import(cfg, weights, "cpu")
    rng = np.random.default_rng(SEED + 37)
    x = rng.integers(1, IMDB_VOCAB, (IMDB_BATCH, IMDB_MAXLEN))
    y = rng.integers(0, 2, (IMDB_BATCH, 1)).astype(np.float32)
    n_lstm = 4  # two Bidirectional layers, two directions each

    net.output(x)  # warm-up
    outs, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: [net.output(x) for _ in range(N_KERAS_CALLS)])
    if launches != _only(KERNELS, fused_lstm_fwd=n_lstm * N_KERAS_CALLS):
        fail(f"{N_KERAS_CALLS} imported BiLSTM output() calls launched "
             f"{launches}; want {n_lstm} LSTM forwards a call")
    out = outs[-1]
    if tuple(out.shape) != (IMDB_BATCH, 1) or not bool(
            torch.isfinite(out).all()):
        fail(f"the imported BiLSTM's output() gave {tuple(out.shape)}")
    host, call_device, by_kernel, call_wall, _ = profiled_launches(
        torch, KERNELS, lambda: net.output(x))
    if call_device != host or call_device != _only(KERNELS,
                                                   fused_lstm_fwd=n_lstm):
        fail(f"a profiled output() call: host {host}, device {call_device};"
             f" want {n_lstm} LSTM forwards")
    call_profile = _profile_summary(by_kernel, call_wall, 1, "call")

    cpu_check = _against_cpu(torch, np, net, cpu, x, y, N_KERAS_CPU_STEPS,
                             "the imported BiLSTM")
    losses, step_launches, reserves, step_wall = _count_launches(
        torch, KERNELS,
        lambda: [net.fit_batch((x, y)) for _ in range(N_KERAS_STEPS)])
    losses = [float(v) for v in losses]
    want = n_lstm * N_KERAS_STEPS
    if (step_launches != _only(KERNELS, fused_lstm_fwd=want,
                               fused_lstm_bwd=want)
            or reserves != _reserves_only(KERNELS, fused_lstm_fwd=want)):
        fail(f"{N_KERAS_STEPS} imported BiLSTM steps launched "
             f"{step_launches} ({reserves} with reserve); want {n_lstm} + "
             f"{n_lstm} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"the imported BiLSTM's losses on a repeated batch: {losses}")
    host, device, by_kernel, step_prof_wall, _ = profiled_launches(
        torch, KERNELS, lambda: net.fit_batch((x, y)))
    if device != host or device != _only(KERNELS, fused_lstm_fwd=n_lstm,
                                         fused_lstm_bwd=n_lstm):
        fail(f"a profiled imported BiLSTM step: host {host}, device "
             f"{device}; want {n_lstm} + {n_lstm}")
    bilstm = {
        "model": "keras.io Bidirectional LSTM on IMDB: Embedding(20000, "
                 "128) -> Bidirectional(LSTM(64, return_sequences)) -> "
                 "Bidirectional(LSTM(64)) -> Dense(1, sigmoid); maxlen 200",
        "batch": IMDB_BATCH, "params": net.num_params(),
        "import_s": import_s, "layers": kinds,
        "calls": N_KERAS_CALLS, "launches_output": launches,
        "ms_per_call": 1e3 * wall / N_KERAS_CALLS,
        "call_profile": call_profile, "call_device_launches": call_device,
        "step_device_launches": device,
        "cpu_check": cpu_check, "steps": N_KERAS_STEPS, "losses": losses,
        "launches_fit": step_launches,
        "reserve_launches": reserves["fused_lstm_fwd"],
        "step_wall_ms": 1e3 * step_wall / N_KERAS_STEPS,
        "samples_per_s": IMDB_BATCH * N_KERAS_STEPS / step_wall,
        "step_profile": _profile_summary(by_kernel, step_prof_wall, 1,
                                         "step"),
        "launches": {k: launches[k] + step_launches[k] for k in launches}}

    # the MNIST convnet: output() and 3 steps against the CPU on a dropout-0
    # import of the same weights (the two sides' dropout generators differ),
    # then 3 steps of the import as it is
    ccfg, cweights = mnist_convnet(np)
    it = MnistDataSetIterator(MNIST_CNN_BATCH, seed=SEED)
    ds = next(iter(it))
    xc, yc = ds.features, ds.labels
    cnet = keras_import(ccfg, cweights, "cuda")
    ckinds = [type(l).__name__ for l in cnet.layers]
    cfg0, _ = mnist_convnet(np, dropout=0.0)
    conv_check = _against_cpu(torch, np, keras_import(cfg0, cweights, "cuda"),
                              keras_import(cfg0, cweights, "cpu"), xc, yc,
                              N_KERAS_CPU_STEPS, "the imported MNIST convnet")
    closses, claunches, _, cwall = _count_launches(
        torch, KERNELS, lambda: [cnet.fit_batch((xc, yc))
                                 for _ in range(N_KERAS_CPU_STEPS)])
    closses = [float(v) for v in closses]
    if any(claunches.values()) or not all(np.isfinite(closses)):
        fail(f"the imported MNIST convnet's steps: launches {claunches}, "
             f"losses {closses}")
    convnet = {
        "model": "keras.io Simple MNIST convnet: Conv2D(32, 3x3) -> "
                 "MaxPool 2 -> Conv2D(64, 3x3) -> MaxPool 2 -> Flatten -> "
                 "Dropout(0.5) -> Dense(10, softmax)",
        "batch": MNIST_CNN_BATCH, "layers": ckinds,
        "synthetic_mnist": it.synthetic,
        "cpu_check_dropout_0": conv_check, "losses": closses,
        "launches": claunches,
        "step_wall_ms": 1e3 * cwall / N_KERAS_CPU_STEPS}
    return {"imdb_bilstm": bilstm, "mnist_convnet": convnet,
            "launches": bilstm["launches"]}


def vae_mnist_conf():
    """dl4j-examples' VaeMNIST2dPlots network: one
    VariationalAutoencoderLayer, 784 -> encoder 256, 256 -> latent 2 ->
    decoder 256, 256, leakyrelu, Bernoulli reconstruction, RMSProp 1e-3,
    l2 1e-4, xavier; no output layer (the example pretrains only)."""
    from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import VariationalAutoencoderLayer
    from deeplearning4j_tpu_torch.optimize.updaters import RMSProp

    return (NeuralNetConfiguration.builder().seed(SEED)
            .updater(RMSProp(lr=1e-3)).list()
            .layer(VariationalAutoencoderLayer(
                n_out=2, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), activation="leakyrelu",
                reconstruction_distribution="bernoulli", l2=1e-4))
            .set_input_type(InputType.feed_forward(784)).build())


def sda_conf():
    """A stacked denoising autoencoder on MNIST: AutoEncoderLayer(500) ->
    AutoEncoderLayer(250) (corruption 0.3, xent) -> OutputLayer(10),
    RMSProp 1e-3."""
    from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import AutoEncoderLayer, OutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import RMSProp

    return (NeuralNetConfiguration.builder().seed(SEED)
            .updater(RMSProp(lr=1e-3)).list()
            .layer(AutoEncoderLayer(n_out=500, corruption_level=0.3,
                                    loss="xent"))
            .layer(AutoEncoderLayer(n_out=250, corruption_level=0.3,
                                    loss="xent"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())


def phase_pretrain(torch, np):
    """The pretrain tier on the card: the MNIST VAE through ``pretrain``
    over MnistDataSetIterator(128) (one epoch), its ELBO on a held batch
    before and after under fixed noise, the first and last step's loss on
    one batch, ms a step (wall, device) and ``reconstruct``; then a stacked
    denoising autoencoder pretrained and fine-tuned."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    it = MnistDataSetIterator(VAE_BATCH, seed=SEED)
    n_steps = sum(1 for _ in it)
    it.reset()
    if n_steps < N_VAE_MIN_STEPS:
        fail(f"MnistDataSetIterator({VAE_BATCH}) gives {n_steps} batches "
             f"an epoch; the phase wants {N_VAE_MIN_STEPS}")
    x0 = next(iter(it)).features
    it.reset()
    net = MultiLayerNetwork(vae_mnist_conf()).init(device="cuda")
    layer = net.layers[0]
    held = torch.as_tensor(x0, device="cuda").reshape(VAE_BATCH, -1)
    eps = layer.pretrain_noise(
        held, torch.Generator(device="cuda").manual_seed(SEED))

    def held_elbo():
        with torch.no_grad():
            return float(layer.pretrain_loss(net.params[0], held, noise=eps))

    elbo_before = held_elbo()
    first = net.pretrain_layer(0, x0)          # one step, the first batch
    torch.cuda.synchronize()
    _, launches, _, wall = _count_launches(
        torch, KERNELS, lambda: net.pretrain(it, epochs=1))
    last = net.pretrain_layer(0, x0)           # one more step, same batch
    elbo_after = held_elbo()
    by_kernel, dev_wall, _ = profile_device(
        torch, lambda: net.pretrain_layer(0, held, epochs=N_VAE_DEVICE_STEPS),
        1)
    recon = layer.reconstruct(net.params[0], held)
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(net.params))
    if any(launches.values()):
        fail(f"VAE pretraining launched {launches}; its path runs no kernel "
             "of the port")
    if not (finite and np.isfinite([first, last, elbo_before, elbo_after])
            .all()):
        fail(f"VAE pretraining: NaN (params finite {finite}, losses "
             f"{first}, {last}, held ELBO {elbo_before} -> {elbo_after})")
    if not (elbo_after < elbo_before and last < first):
        fail(f"VAE pretraining: the ELBO did not fall (held batch "
             f"{elbo_before} -> {elbo_after}; first batch {first} -> "
             f"{last})")
    if (tuple(recon.shape) != (VAE_BATCH, 784)
            or not bool(torch.isfinite(recon).all())
            or float(recon.min()) < 0 or float(recon.max()) > 1):
        fail(f"VAE reconstruct gave {tuple(recon.shape)}, range "
             f"[{float(recon.min())}, {float(recon.max())}]")
    vae = {
        "model": "dl4j-examples VaeMNIST2dPlots: VAE 784 -> 256, 256 -> 2 "
                 "-> 256, 256, leakyrelu, Bernoulli, RMSProp 1e-3, l2 1e-4 "
                 "(no l2 term in pretraining, as in the JAX package)",
        "batch": VAE_BATCH, "synthetic_mnist": it.synthetic,
        "params": net.num_params(), "pretrain_steps": n_steps,
        "launches": launches,
        "held_elbo_before": elbo_before, "held_elbo_after": elbo_after,
        "first_step_elbo": first, "last_step_elbo": last,
        "step_wall_ms": 1e3 * wall / n_steps,
        "device_ms_per_step": sum(t for t, _ in by_kernel.values())
        / N_VAE_DEVICE_STEPS if by_kernel else None,
        "device_kernels_per_step": sum(c for _, c in by_kernel.values())
        / N_VAE_DEVICE_STEPS,
        "synced_ms_per_step_batch_on_card": dev_wall / N_VAE_DEVICE_STEPS,
        "reconstruct_range": [float(recon.min()), float(recon.max())]}

    sda = MultiLayerNetwork(sda_conf()).init(device="cuda")
    it.reset()
    t0 = time.perf_counter()
    _, sda_pre, _, _ = _count_launches(torch, KERNELS,
                                       lambda: sda.pretrain(it, epochs=1))
    pre_s = time.perf_counter() - t0
    ds = next(iter(it))
    xs, ys = ds.features, ds.labels
    losses, sda_fit, _, fit_wall = _count_launches(
        torch, KERNELS,
        lambda: [sda.fit_batch((xs, ys)) for _ in range(N_SDA_STEPS)])
    losses = [float(v) for v in losses]
    if any(sda_pre.values()) or any(sda_fit.values()) or not all(
            np.isfinite(losses)):
        fail(f"stacked denoising autoencoder: launches {sda_pre} / "
             f"{sda_fit}, losses {losses}")
    return {"vae": vae, "stacked_denoising": {
        "model": "AutoEncoderLayer(500) -> AutoEncoderLayer(250) "
                 "(corruption 0.3, xent) -> OutputLayer(10), RMSProp 1e-3",
        "batch": VAE_BATCH, "pretrain_steps": 2 * n_steps,
        "pretrain_s": pre_s, "losses": losses,
        "step_wall_ms": 1e3 * fit_wall / N_SDA_STEPS},
        "launches": {k: launches[k] + sda_pre[k] + sda_fit[k]
                     for k in launches}}


def _metric(text, name):
    """The value of an unlabelled metric in a Prometheus exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def quantized_rollout(torch, np, net, qnet):
    """The quantized LM against the unquantized one over one greedy
    rollout, both with the int8 ring and eager: 8 prompts of
    QUANT_ROLLOUT_PROMPT tokens, N_QUANT_ROLLOUT steps, both fed the
    unquantized net's greedy token. The largest post-softmax difference
    and the share of steps whose top-1 tokens agree."""
    from deeplearning4j_tpu_torch.generation import AttentionDecodeAdapter

    L = FULL_LM["max_len"]
    ids = torch.as_tensor(np.random.default_rng(SEED + 39).integers(
        0, FULL_LM["vocab"], (8, QUANT_ROLLOUT_PROMPT)), device="cuda")
    ads = [AttentionDecodeAdapter(m, L, kv_dtype="int8") for m in (net, qnet)]
    with torch.no_grad():
        caches = [ad.prefill(ids, None) for ad in ads]
        tok, delta, agree = ids[:, -1], 0.0, []
        for t in range(QUANT_ROLLOUT_PROMPT - 1,
                       QUANT_ROLLOUT_PROMPT - 1 + N_QUANT_ROLLOUT):
            pos = torch.full((8,), t, dtype=torch.long, device="cuda")
            out = [ad.decode(c, tok, pos) for ad, c in zip(ads, caches)]
            (lf, caches[0]), (lq, caches[1]) = out
            pf, pq = (torch.softmax(v.float(), -1) for v in (lf, lq))
            delta = max(delta, float((pf - pq).abs().max()))
            agree += (lf.argmax(-1) == lq.argmax(-1)).tolist()
            tok = lf.argmax(-1)
    return {"rows": 8, "prompt": QUANT_ROLLOUT_PROMPT,
            "steps": N_QUANT_ROLLOUT, "ring": "int8 (both)",
            "max_prob_delta": delta,
            "top1_agreement": float(sum(agree) / len(agree))}


def quantized_witness(torch, qnet):
    """The witness over one eager prefill and one eager decode step of the
    quantized LM on the card (int8 ring): no mul at a quantized weight's
    shape; and its control, a weight dequantized by ``q * scale``, which
    must be flagged."""
    from deeplearning4j_tpu_torch.generation import AttentionDecodeAdapter
    from deeplearning4j_tpu_torch.quantize import (
        QuantizedTensor, find_dequantized_weights,
    )
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    wshapes = {tuple(v.q.shape) for p in qnet.params for v in p.values()
               if isinstance(v, QuantizedTensor)}
    ad = AttentionDecodeAdapter(qnet, FULL_LM["max_len"], kv_dtype="int8")
    ids = torch.arange(1, 65, device="cuda")[None]
    with torch.no_grad():
        pre = find_dequantized_weights(lambda: ad.prefill(ids, None),
                                       weight_shapes=wshapes)
        caches = ad.prefill(ids, None)
        dec = find_dequantized_weights(
            ad.decode, caches, ids[:, -1],
            torch.full((1,), 64, dtype=torch.long, device="cuda"),
            weight_shapes=wshapes)
        w = qnet.params[2]["W1"]
        x = torch.ones((8, w.shape[0]), dtype=torch.bfloat16, device="cuda")
        control = find_dequantized_weights(
            lambda: x @ (w.q.to(torch.bfloat16) * w.scale.to(torch.bfloat16)),
            weight_shapes=wshapes)
    if pre or dec:
        fail(f"the quantized LM materializes dequantized weights: prefill "
             f"{pre[:3]}, decode {dec[:3]}")
    if not control:
        fail("the witness did not flag its control (q * scale at a weight's "
             "shape)")
    return {"weight_shapes": len(wshapes),
            "quantized_tensors": sum(
                1 for p in qnet.params for v in p.values()
                if isinstance(v, QuantizedTensor)),
            "flagged_prefill": len(pre), "flagged_decode": len(dec),
            "control_flagged": len(control),
            "int8_leaves": sum(1 for t in tree_leaves(qnet.params)
                               if t.dtype == torch.int8)}


def quantized_resnet(torch, np):
    """ResNet-50 (f32) quantized (``ComputationGraph.quantize``, the conv
    int8 branch) on the card against the same quantized view on the CPU
    at B = 64: logits within TOL_RESNET_CPU; ms a call beside the
    unquantized f32 graph's; the witness over a B = 2 call."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.quantize import (
        QuantizedTensor, find_dequantized_weights,
    )
    from deeplearning4j_tpu_torch.zoo import ResNet50

    cpu = ResNet50(seed=SEED + 2, dtype="float32").init(device="cpu")
    t0 = time.perf_counter()
    qcpu = cpu.quantize()
    quantize_s = time.perf_counter() - t0
    qcard = copy.copy(qcpu).to("cuda")
    full = copy.deepcopy(cpu).to("cuda")
    x, _ = _resnet_batch(torch, SEED + 17, QUANT_RESNET_BATCH, torch.float32)
    got = _resnet_logits(torch, qcard, x)
    t0 = time.perf_counter()
    want = _resnet_logits(torch, qcpu, x.cpu())
    cpu_s = time.perf_counter() - t0
    rel = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    if not rel <= TOL_RESNET_CPU:
        fail(f"quantized ResNet-50 at B = {QUANT_RESNET_BATCH}, card against "
             f"CPU: {rel} > {TOL_RESNET_CPU} relative")
    _, launches, _, _ = _count_launches(torch, KERNELS,
                                        lambda: qcard.output(x))
    if any(launches.values()):
        fail(f"quantized ResNet-50 launched {launches}")
    wshapes = {tuple(v.q.shape) for p in qcard.params.values()
               for v in p.values() if isinstance(v, QuantizedTensor)}
    with torch.no_grad():
        bad = find_dequantized_weights(lambda: qcard.output(x[:2]),
                                       weight_shapes=wshapes)
    if bad:
        fail(f"quantized ResNet-50 materializes dequantized kernels: "
             f"{bad[:3]}")
    n = N_RESNET_CALLS
    qdev = call_device_ms(torch, lambda: qcard.output(x), n)
    fdev = call_device_ms(torch, lambda: full.output(x), n)
    return {"model": "ResNet50 f32, weight-only int8 (conv and dense "
                     "kernels), random weights from the seed",
            "batch": QUANT_RESNET_BATCH, "tf32": False,
            "quantized_tensors": sum(
                1 for p in qcard.params.values() for v in p.values()
                if isinstance(v, QuantizedTensor)),
            "quantize_s": quantize_s, "cpu_output_s": cpu_s,
            "logits_max_rel_err_card_vs_cpu": rel,
            "tolerance": TOL_RESNET_CPU, "witness_flagged": len(bad),
            "launches": launches,
            "ms_per_call": host_ms(torch, lambda: qcard.output(x), n),
            "device_ms_per_call": qdev,
            "f32_ms_per_call": host_ms(torch, lambda: full.output(x), n),
            "f32_device_ms_per_call": fdev}


def phase_quantized_serving(torch, np, full):
    """``net.quantize()`` of phase 30's full-width causal LM (bf16) served
    with the int8 ring at slots 8, max_len 512, phase 30's 16 requests,
    through the captured decode graph: exact launch counts (12 flash
    forwards a prefill), one decode program, tokens/s, TTFT and a steady
    decode step beside phase 30's two rings; the pass's weight bytes
    (``observe_pass``); the rollout against the unquantized net; the
    witness and its control; then the quantized ResNet-50."""
    from deeplearning4j_tpu_torch import monitoring
    from deeplearning4j_tpu_torch.generation import GenerationEngine

    torch.cuda.empty_cache()
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    net = lm_net(torch, dtype="bf16", **FULL_LM)
    part("init")
    monitoring.enable()
    try:
        t0 = time.perf_counter()
        qnet = net.quantize()
        quantize_s = time.perf_counter() - t0
        text = monitoring.registry().exposition()
    finally:
        monitoring.disable()
        monitoring.reset()
    part("quantize")
    pass_record = {
        "seconds": quantize_s,
        "tensors": _metric(text, "dl4j_quantize_tensors_total"),
        "bytes_before": _metric(text, "dl4j_quantize_bytes_before"),
        "bytes_after": _metric(text, "dl4j_quantize_bytes_after")}
    if not (pass_record["tensors"] == 6 * FULL_LM["layers"] + 1
            and pass_record["bytes_after"] < pass_record["bytes_before"]):
        fail(f"the quantize pass recorded {pass_record}")
    V, L = FULL_LM["vocab"], FULL_LM["max_len"]
    reqs = _lm_requests(np, V, L)
    what = "quantized full-width serving (int8 weights, int8 ring)"
    eng = GenerationEngine(qnet, slots=8, max_len=L, kv_dtype="int8",
                           device="cuda")
    eng.generate(reqs[0]["prompt"], max_new_tokens=2)  # captures the graph
    part("capture")
    _, run = _serve_lm(torch, np, eng, reqs, FULL_LM["layers"], what)
    part("serve")
    run["steady"] = _steady_decode(torch, eng, reqs)
    part("steady")
    del eng
    rollout = quantized_rollout(torch, np, net, qnet)
    part("rollout")
    witness = quantized_witness(torch, qnet)
    part("witness")
    out = {"model": "phase 30's causal LM (12 x 768, 12 heads, d_ff 3072, "
                    "vocab 30522, bf16), weight-only int8",
           "quantize_pass": pass_record, "serving": run,
           "phase30": {ring: {
               "tokens_per_s": full[ring]["tokens_per_s"],
               "ttft_p50_ms": full[ring]["ttft_p50_ms"],
               "step_wall_ms": full[ring]["steady"]["step_wall_ms"],
               "step_device_ms": full[ring]["steady"]["step_device_ms"]}
               for ring in ("bf16", "int8")},
           "rollout_vs_unquantized": rollout, "witness": witness,
           "launches": run["launches"], "seconds_by_part": parts}
    del net, qnet
    torch.cuda.empty_cache()
    out["resnet50"] = quantized_resnet(torch, np)
    part("resnet50")
    return out


# ---------------------------------------------------------- the serving tier
SERVE_REQUESTS = 64       # phase 40: config #3 predicts, one sequence each
SERVE_CLIENTS = 8
SERVE_BATCH_LIMIT = 32
SERVE_PREEMPT_STEP = 6    # the session's decode step the preempt fires at
# a predict against ``net.output()`` on the same rows on the card: the
# batch composition and the pow2 padding differ from the direct call
TOL_SERVE = 1e-5
# load-time int8 against ``net.quantize().output()``: the JAX package's
# tests/test_quantize.py::TestServingQuantize tolerance (rtol, atol)
TOL_SERVE_INT8 = (1e-4, 1e-5)
ROOT = os.path.dirname(os.path.abspath(__file__))


def _http_json(base, path, payload=None, timeout=300):
    """A GET (no payload) or a JSON POST: (status, parsed body)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _ndjson(port, name, payload, headers=None, timeout=600):
    """One streaming ``POST /v1/<name>/generate``: (status, the parsed
    lines, seconds from the request to its first line)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/v1/{name}/generate",
                     json.dumps(payload).encode(),
                     {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        lines, first = [], None
        for raw in r:
            if raw.strip():
                if first is None:
                    first = time.perf_counter() - t0
                lines.append(json.loads(raw))
        return r.status, lines, first
    finally:
        conn.close()


def _predict_load(base, xs, clients, stop=None):
    """``clients`` threads send ``xs`` one sequence a request to
    ``/v1/charrnn/predict``, each its share in turn (over and over until
    ``stop`` is set, when one is given). Returns ([(row, status, body,
    seconds)], wall s)."""
    import threading

    out, lock = [], threading.Lock()

    def client(k):
        while True:
            for i in range(k, len(xs), clients):
                t0 = time.perf_counter()
                code, body = _http_json(base, "/v1/charrnn/predict",
                                        {"inputs": [xs[i].tolist()]})
                with lock:
                    out.append((i, code, body, time.perf_counter() - t0))
            if stop is None or stop.is_set():
                return

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, time.perf_counter() - t0


def _check_predicts(np, results, refs, what):
    """Every response 200 and within its version's tolerance of that
    version's reference rows; refs: {version: (rows, rtol, atol)}.
    Returns {version: (requests, max abs err)}."""
    seen = {}
    for i, code, body, _ in results:
        if code != 200:
            fail(f"{what}: request {i} answered {code}: {body}")
        ver = body["version"]
        if ver not in refs:
            fail(f"{what}: request {i} was served by version {ver}")
        want, rtol, atol = refs[ver]
        got = np.asarray(body["outputs"][0], np.float32)
        if got.shape != want[i].shape or not np.all(
                np.abs(got - want[i]) <= atol + rtol * np.abs(want[i])):
            fail(f"{what}: request {i} ({ver}) lies "
                 f"{float(np.abs(got - want[i]).max())} from its reference "
                 f"(rtol {rtol}, atol {atol})")
        n, err = seen.get(ver, (0, 0.0))
        seen[ver] = (n + 1, max(err, float(np.abs(got - want[i]).max())))
    return seen


def _latency_summary(np, results, wall):
    lat = [s for _, _, _, s in results]
    return {"requests": len(results), "wall_s": wall,
            "requests_per_s": len(results) / wall,
            "latency_p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "latency_p99_ms": 1e3 * float(np.percentile(lat, 99))}


def _tier_predict(torch, np, gw, tmp):
    """40(a): config #3 written to a zip, loaded through ``/models/load``
    (warm-up at the pow2 buckets), 64 one-hot [64, 77] sequences from 8
    client threads, twice: timed (monitoring on for the batch sizes), then
    counted under the profiler (4 LSTM forwards a dispatched batch); one
    dispatch under the sync debug mode."""
    import warnings

    from deeplearning4j_tpu_torch import monitoring
    from deeplearning4j_tpu_torch.monitoring import SIZE_BUCKETS
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS, fused_lstm
    from deeplearning4j_tpu_torch.util.serialization import write_model
    from deeplearning4j_tpu_torch.zoo import BidirectionalGravesLSTMCharRnn

    base = f"http://127.0.0.1:{gw.port}"
    model = BidirectionalGravesLSTMCharRnn(seed=SEED)
    net = model.init(device="cuda")
    V, T = model.vocab_size, model.timesteps
    path = os.path.join(tmp, "charrnn.zip")
    write_model(net, path)
    rng = np.random.default_rng(SEED + 40)
    xs = np.eye(V, dtype=np.float32)[rng.integers(0, V, (SERVE_REQUESTS, T))]
    ref = net.output(xs).cpu().numpy()
    load = {"name": "charrnn", "path": path, "warmup_shape": [T, V],
            "batch_limit": SERVE_BATCH_LIMIT}
    t0 = time.perf_counter()
    code, body = _http_json(base, "/models/load", dict(load, version="v1"))
    load_s = time.perf_counter() - t0
    if code != 200:
        fail(f"serving tier: /models/load answered {code}: {body}")
    mv = gw.registry.get("charrnn", "v1")
    if mv.model.device != torch.device("cuda", 0):
        fail(f"serving tier: the zip was restored on {mv.model.device}")
    warm = {b: s for b, s in sorted(mv.warmup_timings.items())}
    print("serving tier warm-up s a bucket: " + ", ".join(
        f"{b}: {s:.3f}" for b, s in warm.items()), flush=True)

    monitoring.reset()
    monitoring.enable()
    try:
        b0 = mv.pi.batches
        timed, wall = _predict_load(base, xs, SERVE_CLIENTS)
        timed_batches = mv.pi.batches - b0
        cum, total, n = monitoring.registry().get(
            "dl4j_serving_batch_size")._only().snapshot()
    finally:
        monitoring.reset()
    _check_predicts(np, timed, {"v1": (ref, 0.0, TOL_SERVE)},
                    "config #3 predict (timed)")
    held = {}

    def counted():
        b = mv.pi.batches
        held["results"], held["wall"] = _predict_load(base, xs, SERVE_CLIENTS)
        held["batches"] = mv.pi.batches - b

    host, device, by_kernel, _, lost = profiled_launches(torch, KERNELS,
                                                         counted)
    want = _only(KERNELS, fused_lstm_fwd=4 * held["batches"])
    if host != want or device != want:
        fail(f"config #3 predict: {held['batches']} dispatched batches "
             f"launched {host} on the host, {device} on the device; want "
             f"{want}")
    seen = _check_predicts(np, held["results"],
                           {"v1": (ref, 0.0, TOL_SERVE)},
                           "config #3 predict (counted)")
    names = sorted({k for k in by_kernel for f in
                    fused_lstm.FWD_KERNEL_NAMES.values()
                    if re.search(rf"(?<!\w){f}(?!\w)", k)})

    # one batch of 5 rows padded to 8, dispatched by hand under the sync
    # debug mode: where the host waits for the card in a dispatch
    xb = np.concatenate([xs[:5], np.zeros((3, T, V), np.float32)])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one = mv.pi._forward(xb, 5)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync_sites = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                  for w in caught if "synchroniz" in str(w.message)]
    # the host's own work a request, one thread: the JSON each way and
    # the conversions the gateway and a client make
    t0 = time.perf_counter()
    for i in range(16):
        req = json.loads(json.dumps({"inputs": [xs[i].tolist()]}))
        np.asarray(req["inputs"], np.float32)
        json.loads(json.dumps({"outputs": [ref[i].tolist()]}))
    json_ms = 1e3 * (time.perf_counter() - t0) / 16
    if not np.abs(one - ref[:5]).max() <= TOL_SERVE:
        fail("config #3 predict: a hand-dispatched batch differs from "
             "net.output()")
    rec = {"model": "BidirectionalGravesLSTMCharRnn(units=200, layers=2, "
                    "vocab=77), f32, restored by /models/load",
           "params": net.num_params(), "request_shape": [T, V],
           "batch_limit": SERVE_BATCH_LIMIT, "clients": SERVE_CLIENTS,
           "load_s": load_s, "warmup_s_by_bucket": warm,
           "timed": dict(_latency_summary(np, timed, wall),
                         batches=timed_batches,
                         mean_batch_size=total / n if n else None,
                         batch_size_cumulative={
                             str(b): c for b, c in zip(
                                 list(SIZE_BUCKETS) + ["+Inf"], cum)}),
           "counted": dict(_latency_summary(np, held["results"],
                                            held["wall"]),
                           batches=held["batches"]),
           "max_abs_err": seen["v1"][1], "launches": device,
           "host_launches": host, "lstm_fwd_device_functions": names,
           "host_syncs_in_one_dispatch": len(sync_sites),
           "host_sync_sites": sync_sites,
           "json_host_ms_per_request": json_ms,
           "profiler_lead_in_records_lost": lost}
    return rec, net, xs, ref, load


def _tier_int8_canary(torch, np, gw, net, xs, ref, load):
    """40(b): the same zip loaded with ``quantize: "int8"`` as v2 (served
    alone, against ``net.quantize().output()``), then a 90/10 split and a
    hot reload of v1 under load (nothing but 200s), and int4 refused."""
    import threading

    base = f"http://127.0.0.1:{gw.port}"
    code, body = _http_json(base, "/models/load",
                            dict(load, version="v2", quantize="int8",
                                 weight=0.0))
    if code != 200 or not body["loaded"]["quantized"]:
        fail(f"serving tier: int8 load answered {code}: {body}")
    code, body = _http_json(base, "/models")
    flags = {v: d["quantized"] for v, d in
             body["models"]["charrnn"]["versions"].items()}
    if flags != {"v1": False, "v2": True}:
        fail(f"serving tier: /models shows quantized {flags}")
    qref = net.quantize().output(xs).cpu().numpy()
    refs = {"v1": (ref, 0.0, TOL_SERVE), "v2": (qref,) + TOL_SERVE_INT8}
    _http_json(base, "/models/split",
               {"name": "charrnn", "split": {"v2": 1.0}})
    alone, _ = _predict_load(base, xs[:16], 4)
    v2 = _check_predicts(np, alone, refs, "int8 v2 predict")
    code, body = _http_json(base, "/models/split",
                            {"name": "charrnn",
                             "split": {"v1": 0.9, "v2": 0.1}})
    if code != 200:
        fail(f"serving tier: /models/split answered {code}: {body}")
    old = gw.registry.get("charrnn", "v1")
    stop, held = threading.Event(), {}

    def hammer():
        held["results"], held["wall"] = _predict_load(base, xs,
                                                      SERVE_CLIENTS, stop)

    th = threading.Thread(target=hammer)
    th.start()
    time.sleep(0.3)
    t0 = time.perf_counter()
    code, body = _http_json(base, "/models/reload", dict(load, version="v1"))
    reload_s = time.perf_counter() - t0
    time.sleep(0.3)
    stop.set()
    th.join(timeout=600)
    if code != 200 or gw.registry.get("charrnn", "v1") is old:
        fail(f"serving tier: the hot reload answered {code}: {body}")
    during = _check_predicts(np, held["results"], refs,
                             "predicts across the hot reload")
    bad, _ = _http_json(base, "/models/load",
                        dict(load, version="v3", quantize="int4"))
    if bad != 400:
        fail(f"serving tier: quantize int4 answered {bad}, want 400")
    return {"quantized": flags,
            "int8_alone": {"requests": v2["v2"][0],
                           "max_abs_err_vs_quantize_output": v2["v2"][1],
                           "max_abs_err_vs_f32_output": float(
                               np.abs(qref - ref).max())},
            "hot_reload": {"split": {"v1": 0.9, "v2": 0.1},
                           "reload_s": reload_s,
                           "requests": len(held["results"]),
                           "by_version": {v: n for v, (n, _) in
                                          during.items()},
                           "codes": sorted({c for _, c, _, _ in
                                            held["results"]})},
            "int4_status": bad}


def _lm_http_run(gw_port, name, reqs):
    """``reqs`` as concurrent streaming generates, one thread each:
    ([(status, lines, first-line s)], wall s)."""
    import threading

    out = [None] * len(reqs)

    def client(i):
        r = dict(reqs[i])
        out[i] = _ndjson(gw_port, name, dict(r, prompt_ids=r.pop("prompt")))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, time.perf_counter() - t0


def _check_http_streams(direct, got, what, rerun):
    """Every HTTP stream 200 and equal, token for token, to the same
    request's stream from the engine driven directly; on a difference,
    where they part (_stream_differences, a second direct run third)."""
    from types import SimpleNamespace

    views = []
    for i, (st, lines, _) in enumerate(got):
        if st != 200 or not lines or not lines[-1].get("done"):
            fail(f"{what}: request {i} answered {st}: {lines[-1:]}")
        views.append(SimpleNamespace(
            tokens=[d["token"] for d in lines[:-1]],
            finish_reason=lines[-1]["finish_reason"],
            request=direct[i].request))
    if [v.tokens for v in views] != [s.tokens for s in direct]:
        fail(f"{what}: HTTP streams differ from the direct engine's: "
             f"{json.dumps(_stream_differences(direct, views, rerun()))}")
    return sum(len(v.tokens) for v in views)


def _tier_generate(torch, np, gw, tmp):
    """40(c): phase 30's full-width LM (bf16 ring, 8 slots) behind
    ``/v1/lm/generate`` with a session journal: the 16 requests as
    concurrent streams, timed, then counted under the profiler (12 flash
    forwards a prefill), each stream equal to the engine driven directly
    on the same weights."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    lm = lm_net(torch, dtype="bf16", **FULL_LM)
    V, L = FULL_LM["vocab"], FULL_LM["max_len"]
    reqs = _lm_requests(np, V, L)
    direct = GenerationEngine(lm, slots=8, max_len=L, device="cuda")
    direct.generate(reqs[0]["prompt"], max_new_tokens=2)   # the capture

    def direct_run():
        out = [direct.submit(r.pop("prompt"), **r)
               for r in [dict(q) for q in reqs]]
        direct.drain()
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dstreams = direct_run()
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    eng = GenerationEngine(lm, slots=8, max_len=L, device="cuda")
    eng.generate(reqs[0]["prompt"], max_new_tokens=2)
    gw.register_generator("lm", eng,
                          sessions=os.path.join(tmp, "lm_sessions.ndjson"))
    timed, twall = _lm_http_run(gw.port, "lm", reqs)
    n_tokens = _check_http_streams(dstreams, timed, "generate (timed)",
                                   direct_run)
    held = {}

    def counted():
        held["got"], held["wall"] = _lm_http_run(gw.port, "lm", reqs)

    host, device, _, _, lost = profiled_launches(torch, KERNELS, counted)
    n_prefill = sum(1 for r in reqs if len(r["prompt"]) > 1)
    want = _only(KERNELS, flash_attention_fwd=FULL_LM["layers"] * n_prefill)
    if host != want or device != want:
        fail(f"generate: {n_prefill} prefills launched {host} on the host, "
             f"{device} on the device; want {want}")
    _check_http_streams(dstreams, held["got"], "generate (counted)",
                        direct_run)
    ttft_http = [f for _, _, f in timed]
    ttft_direct = [s.first_token_at - s.submitted_at for s in dstreams]
    rec = {"model": "causal LM at BertBase width: 12 x 768, 12 heads, d_ff "
                    "3072, vocab 30522, 512 positions, bf16, bf16 ring",
           "slots": 8, "requests": len(reqs), "tokens": n_tokens,
           "http": {"wall_s": twall, "tokens_per_s": n_tokens / twall,
                    "ttft_p50_ms": 1e3 * float(np.percentile(ttft_http,
                                                             50))},
           "direct": {"wall_s": dwall, "tokens_per_s": n_tokens / dwall,
                      "ttft_p50_ms": 1e3 * float(np.percentile(ttft_direct,
                                                               50))},
           "streams_equal_direct": True, "prefills": n_prefill,
           "launches": device, "host_launches": host,
           "engine_captures": eng.captures, "engine_replays": eng.replays,
           "profiler_lead_in_records_lost": lost}
    return rec, lm, reqs, dstreams, direct_run


def _tier_preempt(torch, np, tmp):
    """40(d): phase 31's 1-layer cut behind a gateway with a session
    journal and a LifecycleManager over the gateway, the engine and the
    journal (a stub ``exit_fn``). Four greedy durable streams start
    together; ``preempt`` fires at a decode step through ``faults``; the
    drain leaves every session open in the journal. A second engine and
    gateway on the same weights resume them (``resume=True``), and each
    client reconnects with ``last_seq``: every stream, the lines before
    the preemption then the reconnect's, equals the uninterrupted run."""
    import threading

    from deeplearning4j_tpu_torch import faults
    from deeplearning4j_tpu_torch.generation import (
        AttentionDecodeAdapter, GenerationEngine, SessionJournal,
    )
    from deeplearning4j_tpu_torch.serving import (
        LifecycleManager, ServingGateway, lifecycle,
    )

    net = lm_net(torch, seed=LANE_SEED, **dict(LANE, layers=1))

    def engine():
        eng = GenerationEngine(
            net, slots=8, max_len=LANE["max_len"], device="cuda",
            adapter=AttentionDecodeAdapter(net, max_len=SESSION_RING))
        eng.generate([1, 2, 3], max_new_tokens=2)   # the capture
        return eng

    rng = np.random.default_rng(SEED + 40)
    prompts = [rng.integers(0, LANE["vocab"], int(n)).tolist()
               for n in rng.integers(4, 16, 4)]
    ref_eng = engine()
    refs = [ref_eng.submit(p, max_new_tokens=SESSION_NEW) for p in prompts]
    ref_eng.drain()
    refs = [s.tokens for s in refs]
    path = os.path.join(tmp, "preempt_sessions.ndjson")
    eng = engine()
    # hold the loop's first step until all four sessions are queued, so
    # they are admitted together and the fault's step is theirs
    gate, inner = threading.Event(), eng.step
    eng.step = lambda: gate.wait() and inner()
    gw = ServingGateway(port=0, device="cuda").start()
    gw.register_generator("lm1", eng, sessions=path)
    journal = gw._sessions["lm1"]
    exits = []
    mgr = (LifecycleManager(grace_s=0.0, exit_fn=exits.append)
           .register_gateway(gw).register_engine(eng)
           .register_journal(journal).install(signals=()))
    pre = [None] * len(prompts)

    def client(i):
        pre[i] = _ndjson(gw.port, "lm1",
                         {"prompt_ids": prompts[i],
                          "max_new_tokens": SESSION_NEW},
                         headers={"X-Request-Id": f"p{i}"})

    at = eng.steps_run + SERVE_PREEMPT_STEP
    try:
        with faults.injected(f"preempt:1@step>={at}") as plan:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while (eng.pending_count() < len(prompts)
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            gate.set()
            for t in threads:
                t.join(timeout=120)
            if not mgr.wait(120):
                fail("preemption: the drain did not finish")
            fired = plan.injected["preempt"]
    finally:
        gate.set()
        lifecycle.reset()
    journal.close()
    if fired != 1 or exits != [0] or mgr.errors:
        fail(f"preemption: fired {fired}, exit {exits}, errors {mgr.errors}")
    before = []
    for i, (st, lines, _) in enumerate(pre):
        if st != 200 or lines[-1].get("finish_reason") != "preempted":
            fail(f"preemption: stream p{i} answered {st}, ended "
                 f"{lines[-1:]}")
        before.append([d["token"] for d in lines[:-1]])
    j2 = SessionJournal(path)
    open_ids = sorted(r.request_id for r in j2.interrupted())
    if open_ids != [f"p{i}" for i in range(len(prompts))]:
        fail(f"preemption: the journal holds {open_ids} open")
    eng2 = engine()
    gw2 = ServingGateway(port=0, device="cuda").start()
    try:
        gw2.register_generator("lm1", eng2, sessions=j2, resume=True)
        tails = []
        for i, toks in enumerate(before):
            st, lines, _ = _ndjson(gw2.port, "lm1", {"last_seq": len(toks)},
                                   headers={"X-Request-Id": f"p{i}"})
            seqs = [d["seq"] for d in lines[:-1]]
            if st != 200 or seqs != list(range(len(toks) + 1,
                                               len(toks) + 1 + len(seqs))):
                fail(f"preemption: reconnect p{i} answered {st}, seq {seqs}")
            tails.append([d["token"] for d in lines[:-1]])
            if toks + tails[-1] != refs[i]:
                fail(f"preemption: p{i} before + after the restart "
                     f"{toks + tails[-1]} != the uninterrupted {refs[i]}")
    finally:
        gw2.stop(timeout=30)
        j2.close()
    return {"model": "phase 31's 1-layer cut (d 256, 8 heads, vocab 512), "
                     f"ring {SESSION_RING}, greedy",
            "sessions": len(prompts), "preempt_at_step": SERVE_PREEMPT_STEP,
            "tokens_before": [len(t) for t in before],
            "tokens_after": [len(t) for t in tails],
            "exit_codes": exits, "journaled_open": len(open_ids),
            "streams_equal_uninterrupted": True}


def _tier_both_routes(torch, np, gw, lm, reqs, dstreams, direct_run, xs,
                      ref):
    """40(e): one gateway serving both models: config #3 predicts from the
    worker threads while a fresh engine's thread captures its decode
    graph at its first step and replays it."""
    import threading

    from deeplearning4j_tpu_torch.generation import GenerationEngine

    base = f"http://127.0.0.1:{gw.port}"
    gw.unregister_generator("lm")
    eng = GenerationEngine(lm, slots=8, max_len=FULL_LM["max_len"],
                           device="cuda")      # not warmed: captures here
    gw.register_generator("lm", eng)
    _http_json(base, "/models/split",
               {"name": "charrnn", "split": {"v1": 1.0}})
    held = {}

    def predicts():
        held["results"], held["wall"] = _predict_load(base, xs,
                                                      SERVE_CLIENTS)

    th = threading.Thread(target=predicts)
    th.start()
    time.sleep(0.05)
    got, wall = _lm_http_run(gw.port, "lm", reqs)
    th.join(timeout=600)
    _check_http_streams(dstreams, got, "both routes: generate", direct_run)
    seen = _check_predicts(np, held["results"], {"v1": (ref, 0.0, TOL_SERVE)},
                           "both routes: predict")
    _check_replays(eng, eng.steps_run, "both routes")
    return {"predicts": len(held["results"]),
            "predict_max_abs_err": seen["v1"][1],
            "streams_equal_direct": True, "generate_wall_s": wall,
            "predict_wall_s": held["wall"], "captures": eng.captures,
            "replays": eng.replays}


def phase_serving_tier(torch, np):
    """Phase 40: the serving tier over real HTTP on the loopback, config
    #3's char-RNN and the full-width causal LM behind one
    ``ServingGateway``; see the module docstring."""
    import tempfile

    from deeplearning4j_tpu_torch.serving import ServingGateway

    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        gw = ServingGateway(port=0, seed=SEED, batch_limit=SERVE_BATCH_LIMIT,
                            max_queue=4 * SERVE_REQUESTS,
                            device="cuda").start()
        try:
            out["predict"], net, xs, ref, load = _tier_predict(torch, np, gw,
                                                               tmp)
            out["int8_canary"] = _tier_int8_canary(torch, np, gw, net, xs,
                                                   ref, load)
            (out["generate"], lm, reqs, dstreams,
             direct_run) = _tier_generate(torch, np, gw, tmp)
            out["preemption"] = _tier_preempt(torch, np, tmp)
            out["both_routes"] = _tier_both_routes(
                torch, np, gw, lm, reqs, dstreams, direct_run, xs, ref)
        finally:
            gw.stop(timeout=60)
    out["launches"] = {k: out["predict"]["launches"][k]
                       + out["generate"]["launches"][k]
                       for k in out["predict"]["launches"]}
    return out


# ------------------------------------------------------- phase 41: SameDiff
# (a) config #4's BertBase, (b) TextGenerationLSTM and (c) AlexNet's conv1
# block, each built with the SameDiff API from a port net's params or a
# seed, and (d) the TF -> SameDiff import and the .sdz zip on the card
SD_BERT_BATCH = 32
SD_BERT_T = 128
SD_CHAR_BATCH = 64        # TextGenerationLSTM's [64, 64] batch (phase 7)
SD_CHAR_T = 64
SD_ALEX_CLASSES = 1000
N_SD_FIT_STEPS = 3
N_SD_TIMED = 3
# Adam's learning rate for the BERT fit checks. f32: every weight moves by
# about lr a step, so the two runs' variables can part by at most
# 2 x N_SD_FIT_STEPS x lr = 6e-5 (SD_BERT_PARAM_BOUND). bf16: 1e-3 moves
# every weight under 0.5 (a bf16 step is 2^-8 of the weight), so the three
# steps change the whole model but the LayerNorm gains
SD_BERT_LR = {"f32": 1e-5, "bf16": 1e-3}
SD_CHAR_LR = 1e-3         # RMSProp, TextGenerationLSTM's own
SD_ALEX_LR = 1e-2         # Nesterovs, AlexNet's own
# f32 SameDiff BERT output() against net.output(), max abs over the probs
TOL_SD_BERT_OUT = 1e-4
# Kernels against the plain lowering on the card, BERT. The gradients at
# the start (sd.grad): each leaf's max abs difference over that leaf's
# largest |g|, or over 1e-3 of the largest |g| of the whole model where a
# leaf's is smaller (the key bias's gradient is 0 in exact arithmetic and
# rounding noise in both runs). Adam hides a gradient off by a constant
# factor (its step is scale-free); this check does not: with the flash dq
# scaled by 1.01 it read 1.08e-2 on a query weight.
TOL_SD_BERT_GRAD = {"f32": 3e-5, "bf16": 5e-2}  # read 2.9e-6, 2.1e-2
# f32 fit: the variables after the steps, max abs, a tenth of Adam's bound
# (read 6.5e-7)
SD_BERT_PARAM_BOUND = 2 * N_SD_FIT_STEPS * SD_BERT_LR["f32"]
TOL_SD_BERT_PARAM = SD_BERT_PARAM_BOUND / 10
# The steps' updates ||dA - dB|| / ||dB|| over every variable (d: the
# variables after the steps less before, in f32): f32 read 2.0e-5; bf16 read
# 4.9e-2, where small gradients' signs part and Adam steps them apart. The
# bf16 variables' max abs is recorded, not held: it reads 5.2e-3 of the
# 6e-3 that Adam's steps allow
TOL_SD_BERT_UPDATE = {"f32": 2e-4, "bf16": 1e-1}
# The share of the variables' elements the plain run's steps moved (read
# 0.81 in f32, 0.79 in bf16; the embedding rows no token of the batch
# names, a fifth of the model, never move): a check of steps that leave
# the model where it was checks nothing
SD_BERT_MIN_MOVED = 0.5
# bf16: the plain attention rounds its scores and softmax to bf16 where the
# flash kernels hold them in f32, through 12 blocks. probs max abs (read
# 3.9e-3); fit losses relative (read 9.2e-4; Adam's first step at either
# rate throws this random network's loss from 0.80 to 3.0 in f32 and to 16
# in bf16, the same in both runs)
TOL_SD_BF16_PROBS = 1e-2
TOL_SD_BF16_LOSS = 1e-2
# (loss, variables, updates) of the BERT fit checks by type
TOL_SD_BERT_FIT = {"f32": (TOL_TRAIN_LOSS, TOL_SD_BERT_PARAM,
                           TOL_SD_BERT_UPDATE["f32"]),
                   "bf16": (TOL_SD_BF16_LOSS, None,
                            TOL_SD_BERT_UPDATE["bf16"])}
# to_samediff().output() against the imported graph's output() (f32)
TOL_SD_IMPORT = 1e-5


def sd_vars(sd, prefix, p):
    """One SameDiff variable a parameter of ``p``, named prefix_name."""
    return {k: sd.var(f"{prefix}_{k}", v) for k, v in p.items()}


def samediff_bert(sd, params, heads, seq_len=None, eps=1e-5):
    """Config #4's network (the port's ``Bert`` zoo model: token embedding,
    learned positions, LayerNorm, pre-norm encoder blocks, LayerNorm, mean
    pooling, softmax classifier) as a SameDiff graph on ``sd``, from
    ``params``: the net's per-layer params (arrays or tensors) in its
    layer order. Heads are split by ``reshape`` + ``transpose_`` and
    attend through ``dot_product_attention`` (no mask: every row is full).
    Placeholders ``ids`` [B, T] and ``labels`` [B, C]; outputs ``probs``
    and the loss ``loss`` (softmax cross-entropy), set as the graph's
    loss. Only the SameDiff API is used, so either package builds it."""
    emb, pos, ln0 = params[0], params[1], params[2]
    blocks, lnf, out = params[3:-3], params[-3], params[-1]
    D = emb["W"].shape[1]
    Dh = D // heads
    T = seq_len or pos["P"].shape[0]
    ids = sd.placeholder("ids")
    labels = sd.placeholder("labels")

    def split(t):  # [B, T, D] -> [B, N, T, Dh]
        return sd.transpose_(sd.reshape(t, [-1, T, heads, Dh]), [0, 2, 1, 3])

    h = sd.embedding_lookup(sd.var("emb_W", emb["W"]), ids)
    h = h + sd.var("pos_P", pos["P"])[0:T]
    g = sd_vars(sd, "ln0", ln0)
    h = sd.layer_norm(h, g["gamma"], g["beta"], eps=eps)
    for i, p in enumerate(blocks):
        v = sd_vars(sd, f"block{i}", p)
        a = sd.layer_norm(h, v["ln1_g"], v["ln1_b"], eps=eps)
        q, k, vv = (split(sd.mmul(a, v[f"W{n}"]) + v[f"b{n}"])
                    for n in "qkv")
        o = sd.nn.dot_product_attention(q, k, vv)
        o = sd.reshape(sd.transpose_(o, [0, 2, 1, 3]), [-1, T, D])
        h = h + (sd.mmul(o, v["Wo"]) + v["bo"])
        m = sd.layer_norm(h, v["ln2_g"], v["ln2_b"], eps=eps)
        m = sd.gelu(sd.mmul(m, v["W1"]) + v["b1"])
        h = h + (sd.mmul(m, v["W2"]) + v["b2"])
    g = sd_vars(sd, "lnf", lnf)
    h = sd.layer_norm(h, g["gamma"], g["beta"], eps=eps)
    pooled = sd.mean(h, axis=1)
    o = sd_vars(sd, "out", out)
    logits = sd.add(sd.mmul(pooled, o["W"]), o["b"], name="logits")
    sd.softmax(logits, name="probs")
    sd.set_loss(sd.cross_entropy(labels, logits, name="loss"))
    return sd


def samediff_charlstm(sd, params, batch):
    """TextGenerationLSTM (LSTM x 2, RnnOutputLayer softmax) as a SameDiff
    graph from the net's params, through ``sd.nn.lstm_layer`` from zero
    carries (the layers' forget-gate bias is already in b). Placeholders
    ``x`` [B, T, V] one-hot and ``labels``; outputs ``probs`` and the
    per-step softmax cross-entropy ``loss``."""
    import numpy as np

    h = sd.placeholder("x")
    labels = sd.placeholder("labels")
    for i, p in enumerate(params[:-1]):
        H = p["RW"].shape[0]
        zero = sd.constant(np.zeros((batch, H), np.float32), name=f"zero{i}")
        v = sd_vars(sd, f"lstm{i}", p)
        h, _, _ = sd.nn.lstm_layer(h, zero, zero, v["W"], v["RW"], v["b"])
    o = sd_vars(sd, "out", params[-1])
    logits = sd.add(sd.mmul(h, o["W"]), o["b"], name="logits")
    sd.softmax(logits, name="probs")
    sd.set_loss(sd.cross_entropy(labels, logits, name="loss"))
    return sd


def alexnet_conv1_params(seed=SEED, classes=SD_ALEX_CLASSES):
    """AlexNet's conv1 (11 x 11 x 3 -> 96, He-scaled) and a 96 -> classes
    dense layer, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"conv_W": (rng.standard_normal((11, 11, 3, 96), np.float32)
                       * np.float32(np.sqrt(2.0 / 363))),
            "conv_b": np.zeros(96, np.float32),
            "fc_W": (rng.standard_normal((96, classes), np.float32)
                     / np.float32(np.sqrt(96))),
            "fc_b": np.zeros(classes, np.float32)}


def samediff_alexnet_conv1(sd, params):
    """AlexNet's first block at its shapes: conv 11 x 11 / 4 (VALID) to
    96 channels, ReLU, ``lrn`` (depth 5, k 2, alpha 1e-4, beta 0.75), max
    pool 3 / 2, the spatial mean, then the dense classifier. Placeholders
    ``x`` [B, 224, 224, 3] and ``labels``; outputs ``probs``, ``loss``."""
    v = {k: sd.var(k, a) for k, a in params.items()}
    x = sd.placeholder("x")
    labels = sd.placeholder("labels")
    h = sd.relu(sd.add(sd.conv2d(x, v["conv_W"], strides=(4, 4),
                                 padding="valid"), v["conv_b"]))
    h = sd._op("lrn", h, attrs={"depth": 5, "bias": 2.0, "alpha": 1e-4,
                                "beta": 0.75})
    h = sd.max_pool2d(h, kernel=(3, 3), strides=(2, 2), padding="valid")
    h = sd.mean(h, axis=[1, 2])
    logits = sd.add(sd.mmul(h, v["fc_W"]), v["fc_b"], name="logits")
    sd.softmax(logits, name="probs")
    sd.set_loss(sd.cross_entropy(labels, logits, name="loss"))
    return sd


def conv_graph_def(shape, params) -> bytes:
    """Placeholder ``x`` (float32, NHWC ``shape``) -> Conv2D (11 x 11 / 4,
    VALID) + BiasAdd + Relu + MaxPool (3 / 2, VALID) + Mean over H, W +
    MatMul + BiasAdd + Softmax ("probs"): AlexNet's conv1 block with
    ``params`` (``alexnet_conv1_params``) as a TF GraphDef."""
    import numpy as np

    return b"".join([
        _pb_node("x", "Placeholder", (), _pb_attr("dtype", type_=1),
                 _pb_attr("shape", shape=shape)),
        _pb_node("conv_W", "Const", (), _pb_attr("value",
                                                 tensor=params["conv_W"])),
        _pb_node("conv_b", "Const", (), _pb_attr("value",
                                                 tensor=params["conv_b"])),
        _pb_node("conv", "Conv2D", ("x", "conv_W"),
                 _pb_attr("strides", ints=[1, 4, 4, 1]),
                 _pb_attr("padding", s="VALID")),
        _pb_node("conv_bias", "BiasAdd", ("conv", "conv_b")),
        _pb_node("relu", "Relu", ("conv_bias",)),
        _pb_node("pool", "MaxPool", ("relu",),
                 _pb_attr("ksize", ints=[1, 3, 3, 1]),
                 _pb_attr("strides", ints=[1, 2, 2, 1]),
                 _pb_attr("padding", s="VALID")),
        _pb_node("axes", "Const", (), _pb_attr(
            "value", tensor=np.array([1, 2], np.int32))),
        _pb_node("mean", "Mean", ("pool", "axes"), _pb_attr("keep_dims",
                                                            b=False)),
        _pb_node("fc_W", "Const", (), _pb_attr("value", tensor=params["fc_W"])),
        _pb_node("fc_b", "Const", (), _pb_attr("value", tensor=params["fc_b"])),
        _pb_node("fc", "MatMul", ("mean", "fc_W")),
        _pb_node("logits", "BiasAdd", ("fc", "fc_b")),
        _pb_node("probs", "Softmax", ("logits",)),
    ])


def bert_vocab(np, seed=SEED, size=30522, words=20000):
    """A BERT-base-sized WordPiece vocabulary from ``seed``: the five
    specials, ``words`` whole words and ``##`` continuations up to
    ``size``."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def fresh(n, lo, hi, taken):
        out = []
        while len(out) < n:
            w = "".join(rng.choice(letters, rng.integers(lo, hi + 1)))
            if w not in taken:
                taken.add(w)
                out.append(w)
        return out

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    whole = fresh(words, 3, 8, set())
    cont = fresh(size - len(specials) - words, 2, 5, set())
    return specials + whole + ["##" + c for c in cont], whole, cont


def bert_sentences(np, whole, cont, n, seed=SEED, words=140):
    """``n`` (sentence, label) pairs of ``words`` words each: whole words,
    a third of them with a continuation glued on, so every row fills 128
    wordpieces."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        ws = [whole[j] + (cont[c] if c >= 0 else "")
              for j, c in zip(rng.integers(0, len(whole), words),
                              np.where(rng.random(words) < 1 / 3,
                                       rng.integers(0, len(cont), words), -1))]
        out.append((" ".join(ws), "pos" if i % 2 else "neg"))
    return out


def _bert_text_batch(np):
    """Config #4's [32, 128] batch through the ported BERT text front:
    BertWordPieceTokenizer over a generated 30,522-piece vocabulary and a
    seq_classification BertIterator; every row full (mask all ones)."""
    from deeplearning4j_tpu_torch.nlp import (
        BertIterator, BertWordPieceTokenizer,
    )

    vocab, whole, cont = bert_vocab(np)
    tok = BertWordPieceTokenizer(vocab)
    it = BertIterator(tok, bert_sentences(np, whole, cont, SD_BERT_BATCH),
                      batch_size=SD_BERT_BATCH, max_len=SD_BERT_T,
                      task="seq_classification", labels=["neg", "pos"])
    ds = next(iter(it))
    if (ds.features.shape != (SD_BERT_BATCH, SD_BERT_T)
            or not (ds.features_mask == 1).all()):
        fail(f"BERT text front: batch {ds.features.shape}, mask not all "
             f"ones ({ds.features_mask.sum()} of {ds.features_mask.size})")
    pieces = sum(t.startswith("##") for t in tok.tokenize(
        bert_sentences(np, whole, cont, 1)[0][0]))
    return ds, {"vocab": len(vocab), "continuation_pieces_row0": pieces,
                "unk_ids": int((ds.features == tok.index["[UNK]"]).sum())}


class _Losses:
    """A SameDiff listener that keeps each step's loss."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, sd, i, epoch, loss):
        self.losses.append(loss)


def _plain(fn):
    """``fn()`` with the kernels off (DL4J_TORCH_DISABLE_KERNELS: every
    registry op takes its plain lowering)."""
    from deeplearning4j_tpu_torch.common.env import env

    env.disable_kernels = True
    try:
        return fn()
    finally:
        env.reload()


def _sd_fit(sd, updater, steps, feeds):
    """``steps`` fit steps; the losses of every step."""
    rec = _Losses()
    sd.fit(updater=updater, steps=steps, listeners=[rec], **feeds)
    return rec.losses


def _sd_against_plain(torch, make, updater, feeds, steps, loss_tol,
                      param_tol, what, update_tol=None):
    """Two graphs from ``make()``: ``steps`` fit steps through the kernels
    and through the plain lowering, the losses of each step (relative) and
    the variables after (max abs; and, given ``update_tol``, the steps'
    updates ||dA - dB|| / ||dB|| over every variable, and the share of
    elements the steps moved at least SD_BERT_MIN_MOVED) held to the
    tolerances (None: recorded only)."""
    import numpy as np

    a, b = make(), make()
    v0 = {k: t.float() for k, t in b.variables().items()}
    la = _sd_fit(a, updater(), steps, feeds)
    lb = _plain(lambda: _sd_fit(b, updater(), steps, feeds))
    loss_err = max(abs(p - q) / max(abs(q), 1e-12) for p, q in zip(la, lb))
    va, vb = a.variables(), b.variables()
    param_err = max(float((va[k].float() - vb[k].float()).abs().max())
                    for k in va)
    num = sum(float((va[k].float() - vb[k].float()).square().sum())
              for k in va)
    den = sum(float((vb[k].float() - v0[k]).square().sum()) for k in vb)
    moved = sum(int((vb[k].float() != v0[k]).sum()) for k in vb)
    update_err = (num / den) ** 0.5 if den > 0 else float("inf")
    moved_share = moved / sum(t.numel() for t in v0.values())
    if not all(np.isfinite(la)) or loss_err > loss_tol or \
            (param_tol is not None and param_err > param_tol) or \
            (update_tol is not None and (update_err > update_tol or
                                         moved_share < SD_BERT_MIN_MOVED)):
        fail(f"{what}: {steps} fit steps, kernels against the plain "
             f"lowering on the card: losses {la} / {lb} (rel err {loss_err},"
             f" tol {loss_tol}), variables abs err {param_err} (tol "
             f"{param_tol}), updates rel err {update_err} (tol "
             f"{update_tol}), share moved {moved_share} (at least "
             f"{SD_BERT_MIN_MOVED} where the updates are held)")
    return {"kernel_losses": la, "plain_losses": lb,
            "loss_max_rel_err": loss_err, "variables_max_abs_err": param_err,
            "updates_rel_err": update_err,
            "plain_update_norm": den ** 0.5,
            "plain_moved_share": moved_share}


def _grads_against_plain(sd, feeds, tol, what):
    """``sd.grad`` of the loss at the graph's variables, kernels against
    the plain lowering: each leaf's max abs difference over the larger of
    its own largest |g| and 1e-3 of the model's (TOL_SD_BERT_GRAD says
    why), held to ``tol``; the worst leaf and the attention weights'."""
    ga = sd.grad("loss", **feeds)
    gb = _plain(lambda: sd.grad("loss", **feeds))
    top = max(float(g.float().abs().max()) for g in gb.values())
    errs = {k: float((ga[k].float() - gb[k].float()).abs().max())
            / max(float(gb[k].float().abs().max()), 1e-3 * top)
            for k in gb}
    worst = max(errs, key=errs.get)
    if not errs[worst] <= tol:
        fail(f"{what}: gradients, kernels against the plain lowering on "
             f"the card: {worst} {errs[worst]} > {tol}")
    attn = [k for k in errs if k.split("_")[-1] in ("Wq", "Wk", "Wv")]
    return {"max_rel_err": errs[worst], "worst_leaf": worst,
            "attention_weights_max_rel_err": max(errs[k] for k in attn),
            "largest_abs_grad": top}


def _sd_launches(torch, kernels, fn, want, what):
    """One call of ``fn`` profiled: the host's launches and the device's
    records must both equal ``want``."""
    host, device, _, wall_ms, lost = profiled_launches(torch, kernels, fn)
    if host != want or device != host:
        fail(f"{what}: host launches {host}, device records {device}; want "
             f"{ {k: v for k, v in want.items() if v} } and nothing else")
    return {"host": host, "device": device, "wall_ms": wall_ms,
            "profiler_lead_in_records_lost": lost}


def _timed(torch, fn, what):
    """Wall ms (synced) and device ms of one call of ``fn``."""
    return {f"{what}_ms": host_ms(torch, fn, N_SD_TIMED),
            f"{what}_device_ms": call_device_ms(torch, fn, N_SD_TIMED)}


def _sd_bert(torch, np, KERNELS):
    """Phase 41(a): config #4's BertBase at full width through SameDiff."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import BertBase

    model = BertBase(seed=SEED, max_len=SD_BERT_T, dtype="float32",
                     dropout=0.0)
    net = model.init(device="cuda")
    ds, text = _bert_text_batch(np)
    ids = ds.features.astype(np.int64)
    feeds = {"ids": torch.as_tensor(ids, device="cuda"),
             "labels": torch.as_tensor(ds.labels, device="cuda")}

    def make(dtype=torch.float32):
        sd = samediff_bert(SameDiff.create(SEED, device="cuda"),
                           [{k: t.detach().clone() for k, t in p.items()}
                            for p in net.params], heads=model.n_heads)
        if dtype != torch.float32:
            sd.set_variables({k: t.to(dtype)
                              for k, t in sd.variables().items()})
        return sd

    n = model.n_layers
    out_want = _only(KERNELS, flash_attention_fwd=n)
    step_want = _only(KERNELS, flash_attention_fwd=n, flash_attention_dq=n,
                      flash_attention_dkv=n)
    rec, launches = {"model": "BertBase(12 x 768, 12 heads, d_ff 3072, vocab "
                              "30522), SameDiff graph from the net's params",
                     "batch": SD_BERT_BATCH, "timesteps": SD_BERT_T,
                     "text_front": text}, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        sd = make(dt)
        probs, n_out, _, _ = _count_launches(
            torch, KERNELS, lambda: sd.output("probs", **feeds))
        plain = _plain(lambda: sd.output("probs", **feeds))
        r = {"output_max_abs_err_vs_plain": float(
            (probs.float() - plain.float()).abs().max())}
        if name == "f32":
            want = net.output(ids, mask=ds.features_mask)
            r["output_max_abs_err_vs_net"] = float(
                (probs - want).abs().max())
            if r["output_max_abs_err_vs_net"] > TOL_SD_BERT_OUT:
                fail(f"SameDiff BERT f32 output() against net.output(): "
                     f"{r['output_max_abs_err_vs_net']} > {TOL_SD_BERT_OUT}")
        elif r["output_max_abs_err_vs_plain"] > TOL_SD_BF16_PROBS:
            fail(f"SameDiff BERT bf16 output(), kernels against plain: "
                 f"{r['output_max_abs_err_vs_plain']} > {TOL_SD_BF16_PROBS}")
        r["output_launches"] = _sd_launches(
            torch, KERNELS, lambda: sd.output("probs", **feeds), out_want,
            f"SameDiff BERT {name} output()")
        r["grads_against_plain"] = _grads_against_plain(
            sd, feeds, TOL_SD_BERT_GRAD[name], f"SameDiff BERT {name}")
        upd = (lambda: Adam(lr=SD_BERT_LR[name]))
        r["updater"] = f"Adam lr {SD_BERT_LR[name]}"
        tols = TOL_SD_BERT_FIT[name]
        r["fit_against_plain"] = _sd_against_plain(
            torch, lambda: make(dt), upd, feeds, N_SD_FIT_STEPS, tols[0],
            tols[1], f"SameDiff BERT {name}", update_tol=tols[2])
        r["step_launches"] = _sd_launches(
            torch, KERNELS, lambda: sd.fit(updater=upd(), steps=1, **feeds),
            step_want, f"SameDiff BERT {name} fit step")
        _, n_fit, _, _ = _count_launches(
            torch, KERNELS, lambda: sd.fit(updater=upd(), steps=1, **feeds))
        launches[name] = {k: n_out[k] + n_fit[k] for k in n_out}
        r.update(_timed(torch, lambda: sd.output("probs", **feeds),
                        "output"))
        r.update(_timed(torch, lambda: sd.fit(updater=upd(), steps=1,
                                              **feeds), "step"))
        rec[name] = r
        del sd
    # the net's own entry points beside SameDiff's eager graph (f32)
    y, m = ds.labels, ds.features_mask
    rec["net_f32"] = {
        **_timed(torch, lambda: net.output(ids, mask=m), "output"),
        **_timed(torch, lambda: float(net.fit_batch((ids, y, m))), "step"),
        "updater": "AdamW on warmup-cosine, clip 1.0 (the net's own)"}
    rec["launches"] = launches
    return rec, make, feeds


def _sd_charlstm(torch, np, KERNELS):
    """Phase 41(b): TextGenerationLSTM through SameDiff's lstm_layer."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.ops.cuda import fused_lstm
    from deeplearning4j_tpu_torch.optimize.updaters import RMSProp
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    model = TextGenerationLSTM(seed=SEED)
    net = model.init(device="cuda")
    x, y = _char_batch(np, np.random.default_rng(SEED + 41),
                       model.vocab_size, SD_CHAR_BATCH, SD_CHAR_T)
    feeds = {"x": torch.as_tensor(x, device="cuda"),
             "labels": torch.as_tensor(y, device="cuda")}

    def make():
        return samediff_charlstm(
            SameDiff.create(SEED, device="cuda"),
            [{k: t.detach().clone() for k, t in p.items()}
             for p in net.params], SD_CHAR_BATCH)

    sd = make()
    probs, n_out, _, _ = _count_launches(
        torch, KERNELS, lambda: sd.output("probs", **feeds))
    err = float((probs - net.output(x)).abs().max())
    if err > TOL:
        fail(f"SameDiff char-LSTM output() against net.output(): {err} > "
             f"{TOL}")
    rec = {"model": "TextGenerationLSTM (LSTM 256 x 2, vocab 77), SameDiff "
                    "graph from the net's params",
           "batch": SD_CHAR_BATCH, "timesteps": SD_CHAR_T,
           "output_max_abs_err_vs_net": err}
    cluster = {"fused_lstm_fwd": fused_lstm.FWD_KERNEL_NAMES["cluster"],
               "fused_lstm_bwd": fused_lstm.BWD_KERNEL_NAMES["cluster"]}
    rec["output_launches"] = _sd_launches(
        torch, KERNELS, lambda: sd.output("probs", **feeds),
        _only(KERNELS, fused_lstm_fwd=2), "SameDiff char-LSTM output()")
    upd = (lambda: RMSProp(lr=SD_CHAR_LR))
    rec["fit_against_plain"] = _sd_against_plain(
        torch, make, upd, feeds, N_SD_FIT_STEPS, TOL_TRAIN_LOSS,
        TOL_TRAIN_PARAM, "SameDiff char-LSTM")

    def step():
        return sd.fit(updater=upd(), steps=1, **feeds)

    rec["step_launches"] = _sd_launches(
        torch, KERNELS, step, _only(KERNELS, fused_lstm_fwd=2,
                                    fused_lstm_bwd=2),
        "SameDiff char-LSTM fit step")
    by_kernel, _, _ = profile_device(torch, step, 1)
    rec["step_device_functions"] = sorted(
        k for k in by_kernel if "lstm_" in k)
    if not all(any(f in k for k in by_kernel) for f in cluster.values()):
        fail(f"SameDiff char-LSTM step ran {rec['step_device_functions']}; "
             f"want the cluster kernels {sorted(cluster.values())}")
    _, n_fit, _, _ = _count_launches(torch, KERNELS, step)
    rec.update(_timed(torch, lambda: sd.output("probs", **feeds), "output"))
    rec.update(_timed(torch, step, "step"))
    rec["net"] = {**_timed(torch, lambda: net.output(x), "output"),
                  **_timed(torch, lambda: float(net.fit_batch((x, y))),
                           "step"),
                  "updater": "RMSProp 1e-3, clip 5.0 (the net's own)"}
    rec["launches"] = {k: n_out[k] + n_fit[k] for k in n_out}
    return rec


def _sd_alexnet(torch, np, KERNELS):
    """Phase 41(c): AlexNet's conv1 block through SameDiff's lrn."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs

    params = alexnet_conv1_params()
    x, y = _alexnet_images(torch, SEED + 41, ALEXNET_BATCH)
    feeds = {"x": x, "labels": y}

    def make():
        return samediff_alexnet_conv1(SameDiff.create(SEED, device="cuda"),
                                      params)

    sd = make()
    probs, n_out, _, _ = _count_launches(
        torch, KERNELS, lambda: sd.output("probs", **feeds))
    err = float((probs - _plain(lambda: sd.output("probs", **feeds)))
                .abs().max())
    if err > TOL:
        fail(f"SameDiff AlexNet conv1 output(), kernels against plain: {err}"
             f" > {TOL}")
    rec = {"model": "AlexNet conv1 block: conv 11 x 11 / 4 -> 96, ReLU, lrn "
                    "depth 5, max-pool 3 / 2, mean, dense 1000",
           "batch": ALEXNET_BATCH, "output_max_abs_err_vs_plain": err}
    rec["output_launches"] = _sd_launches(
        torch, KERNELS, lambda: sd.output("probs", **feeds),
        _only(KERNELS, lrn_fwd=1), "SameDiff AlexNet conv1 output()")
    upd = (lambda: Nesterovs(lr=SD_ALEX_LR, momentum=0.9))
    rec["fit_against_plain"] = _sd_against_plain(
        torch, make, upd, feeds, N_SD_FIT_STEPS, TOL_TRAIN_LOSS,
        TOL_TRAIN_PARAM, "SameDiff AlexNet conv1")

    def step():
        return sd.fit(updater=upd(), steps=1, **feeds)

    rec["step_launches"] = _sd_launches(
        torch, KERNELS, step, _only(KERNELS, lrn_fwd=1, lrn_bwd=1),
        "SameDiff AlexNet conv1 fit step")
    _, n_fit, _, _ = _count_launches(torch, KERNELS, step)
    rec.update(_timed(torch, lambda: sd.output("probs", **feeds), "output"))
    rec.update(_timed(torch, step, "step"))
    rec["launches"] = {k: n_out[k] + n_fit[k] for k in n_out}
    return rec, params, x


def _sd_import_and_zip(torch, np, params, x, make_bert, bert_feeds):
    """Phase 41(d): a TF GraphDef through to_samediff on the card, and the
    full-width BERT graph through the .sdz zip."""
    import tempfile

    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.modelimport import TFGraphMapper

    imp = TFGraphMapper.import_graph(conv_graph_def(tuple(x.shape), params))
    sd = imp.to_samediff()
    want = imp.output({"x": x}, ["probs"])
    got = sd.output("probs", x=x)
    err = float((got - want).abs().max())
    if got.device.type != "cuda" or err > TOL_SD_IMPORT:
        fail(f"to_samediff on the card: output on {got.device}, against the "
             f"imported graph {err} > {TOL_SD_IMPORT}")
    rec = {"tf_graph": "Conv2D + BiasAdd + Relu + MaxPool + Mean + MatMul + "
                       "BiasAdd + Softmax, [128, 224, 224, 3]",
           "sd_nodes": len(sd._nodes),
           "to_samediff_max_abs_err_vs_import": err}
    bert = make_bert()
    before = bert.output("probs", **bert_feeds)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.sdz")
        t0 = time.perf_counter()
        bert.save(path)
        rec["bert_sdz_save_s"] = time.perf_counter() - t0
        rec["bert_sdz_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        back = SameDiff.load(path, device="cuda")
        rec["bert_sdz_load_s"] = time.perf_counter() - t0
    after = back.output("probs", **bert_feeds)
    if after.device.type != "cuda" or not torch.equal(before, after):
        fail(f"SameDiff BERT through the .sdz: outputs differ by "
             f"{float((before - after).abs().max())} (device {after.device})")
    rec["bert_sdz_bit_equal"] = True
    return rec


def phase_samediff(torch, np):
    """Phase 41: SameDiff on the card (a-d); returns the record."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    t0 = time.perf_counter()
    bert, make_bert, bert_feeds = _sd_bert(torch, np, KERNELS)
    char = _sd_charlstm(torch, np, KERNELS)
    alex, params, x = _sd_alexnet(torch, np, KERNELS)
    zipped = _sd_import_and_zip(torch, np, params, x, make_bert, bert_feeds)
    launches = {"samediff_bert_f32": bert["launches"]["f32"],
                "samediff_bert_bf16": bert["launches"]["bf16"],
                "samediff_charlstm": char["launches"],
                "samediff_alexnet_conv1": alex["launches"]}
    return {"bert": bert, "charlstm": char, "alexnet_conv1": alex,
            "import_and_zip": zipped, "launches_by_path": launches,
            "wall_s_phase": time.perf_counter() - t0}


# ------------------------------------------------------- parallel slice

N_PAR_WARM = 2
N_PAR_STEPS = 10
N_PAR_TIMED = 5
N_PAR_F32 = 3
# config #5 at one rank against the plain fit_batch from the same zip: at
# one rank every all-reduce sums one value and divides by 1, so the two are
# equal bit for bit, and these limits are what a control must miss (the
# wrapper with its averaged gradients halved, as a wrapper dividing by a
# wrong rank count would leave them)
TOL_PAR_LOSS = 1e-6     # relative
TOL_PAR_PARAM = 1e-6    # relative to each leaf's largest |value|
# bench.py's long-context lane (bench.py:398-420): B = 1, H = 4, head dim
# 128, T = 8192, causal, bf16; the ring of 4 replayed on the card
SEQ_SHAPE = (1, 4, 8192, 128)
SEQ_RING = 4
SEQ_MASK_FROM = 6000    # keys at and past it padded: block 3 wholly
N_SEQ_TIMED = 3
# the replayed ring's o, lse, dq, dk and dv against one flash call over the
# whole sequence (_row_rel: a causal tensor's first rows are far larger
# than its last, so a limit over the tensor's largest |value| would not see
# the last rows) and against the plain versions (_max_rel). The ring's p
# are the one call's (the backward takes the global lse), its o merges
# four partial o rounded to the input type. About 3x the largest reading
# on the H100, at this shape and at the cuda tests' [1, 2, 512, 128]; the
# controls below (SEQ_CONTROLS) must miss them
TOL_SEQ = {"float32": 1e-5, "bfloat16": 2e-2}
# the world-1 encoder, TensorParallel and MoE against their single-device
# runs on the card (relative to each tensor's largest |value|)
TOL_PAR_MODULE = 1e-5


def _grads_rel_err(got, want):
    """max |a - b| over every gradient, over the largest |b| of them all (a
    gradient that is 0 in exact arithmetic, as a key bias's, is noise
    against its own size)."""
    scale = max(float(b.float().abs().max()) for b in want.values())
    return max(float((got[k].float() - want[k].float()).abs().max())
               for k in want) / max(scale, 1e-30)


def _tree_rel_err(got, want):
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    return max(_max_rel(a, b) for a, b in zip(tree_leaves(got),
                                              tree_leaves(want)))


def collective_records(torch, fn, steps: int):
    """``steps`` calls of ``fn`` under torch.profiler (CPU and CUDA): the
    collectives' records, {name: [count, device ms] a step}: the host's
    c10d records ("nccl:all_reduce" on an NCCL group) and NCCL's device
    kernels. At one rank NCCL runs no device kernel for an all-reduce
    (experiments/nccl_one_card/probe.py on the H100): the host's records
    show the collectives the step issued."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.count / steps, _device_us(e) / 1e3 / steps]
            for e in prof.key_averages() if "nccl" in e.key.lower()}


def _nccl_kernels(records):
    """The device kernels among ``collective_records``' records."""
    return {k: v for k, v in records.items() if not k.startswith("nccl:")}


def _par_nets(torch, path, n, f32=False):
    """``n`` copies of the zipped ResNet-50 on the card, f32 compute when
    ``f32``."""
    from deeplearning4j_tpu_torch.common.dtypes import FLOAT32
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    nets = [ComputationGraph.load(path, device="cuda") for _ in range(n)]
    if f32:
        for net in nets:
            net._policy = FLOAT32
    return nets


class _HalvedGrads:
    """The control of config #5: the data axis with its averaged gradients
    halved."""

    def __init__(self, axis):
        self.axis = axis

    def reduce_step(self, loss, grads):
        from deeplearning4j_tpu_torch.common.trees import tree_map

        loss, grads = self.axis.reduce_step(loss, grads)
        return loss, tree_map(lambda g: g / 2, grads)

    def __getattr__(self, name):
        return getattr(self.axis, name)


def phase_config5(torch, np, zip_path, zip_save_s):
    """BASELINE.json config #5: ResNet-50 (config #2's net, bf16, Nesterovs
    0.1, B = 64) from phase 20's zip (``zip_path``, written in
    ``zip_save_s``) through ParallelWrapper over an NCCL group of one
    rank, held against the same net's plain fit_batch."""
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ParallelWrapper

    x, y = _resnet_batch(torch, SEED + 42, RESNET_BATCH, torch.bfloat16)
    out = {"model": "ResNet50 (config #2's net) from phase 20's zip, bf16, "
                    "Nesterovs 0.1; ParallelWrapper over DeviceMesh(data=1)"
                    " on NCCL",
           "batch": RESNET_BATCH, "warm_steps": N_PAR_WARM,
           "steps": N_PAR_STEPS, "timed_steps": N_PAR_TIMED,
           "correctness_passes_on": "cudnn.deterministic",
           "zip_save_s": zip_save_s}
    t0 = time.perf_counter()
    plain, wrapped = _par_nets(torch, zip_path, 2)
    p32, w32, c32 = _par_nets(torch, zip_path, 3, f32=True)
    out["zip_load_s_each"] = (time.perf_counter() - t0) / 5
    mesh = DeviceMesh(data=1, device="cuda")
    w = ParallelWrapper(wrapped, mesh)
    steps = {"plain": lambda: plain.fit_batch((x, y)),
             "wrapper": lambda: w.fit_batch((x, y))}
    # both correctness passes, bf16 and f32, run on cuDNN's deterministic
    # algorithms: its weight gradients otherwise sum in a run-dependent
    # order, and this net at lr 0.1 amplifies that past any limit within 3
    # steps. The timed and profiled steps after them take the default ones
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name, step in steps.items():
            warm = [float(step()) for _ in range(N_PAR_WARM)]
            got, launches, _, _ = _count_launches(
                torch, KERNELS, lambda: [step() for _ in range(N_PAR_STEPS)])
            runs[name] = {"losses": warm + [float(v) for v in got],
                          "launches": launches}
        wc = ParallelWrapper(c32, mesh)
        wc.axis = _HalvedGrads(wc.axis)
        w32w = ParallelWrapper(w32, mesh)
        f32 = {name: [float(fn()) for _ in range(N_PAR_F32)]
               for name, fn in (
                   ("plain", lambda: p32.fit_batch((x.float(), y))),
                   ("wrapper", lambda: w32w.fit_batch((x.float(), y))),
                   ("control_halved_grads",
                    lambda: wc.fit_batch((x.float(), y))))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for name in steps:
        if any(runs[name]["launches"].values()):
            fail(f"config #5 {name} launched {runs[name]['launches']}; "
                 f"ResNet-50 runs none of the port's kernels")
        if not np.all(np.isfinite(runs[name]["losses"])):
            fail(f"config #5 {name} losses not finite: "
                 f"{runs[name]['losses']}")
    lp, lw = (np.asarray(runs[k]["losses"]) for k in ("plain", "wrapper"))
    err = {"losses": float(np.max(np.abs(lw - lp) / np.abs(lp))),
           "params": _tree_rel_err(wrapped.params, plain.params),
           "bn_state": _tree_rel_err(wrapped.state, plain.state),
           "updater_state": _tree_rel_err(wrapped.opt_state,
                                          plain.opt_state)}
    if err["losses"] > TOL_PAR_LOSS or max(
            err[k] for k in ("params", "bn_state",
                             "updater_state")) > TOL_PAR_PARAM:
        fail(f"config #5 wrapper against the plain step: {err} (limits "
             f"{TOL_PAR_LOSS} losses, {TOL_PAR_PARAM} trees)")
    # the f32 pass at full width: wrapper, plain, and the control
    f32_err = {"params": _tree_rel_err(w32.params, p32.params),
               "control_params": _tree_rel_err(c32.params,
                                               p32.params)}
    if f32_err["params"] > TOL_PAR_PARAM:
        fail(f"config #5 f32 wrapper params against plain: {f32_err}, "
             f"losses {f32}")
    if f32_err["control_params"] <= TOL_PAR_PARAM:
        fail(f"config #5 control (gradients halved) passed the limit "
             f"{TOL_PAR_PARAM}: {f32_err}; the check cannot tell")
    # wall and device time of a step, and the collectives of the wrapper's
    prof = {}
    for name, fn in steps.items():
        fn()  # the default algorithms' first step picks them
        _, _, _, wall = _count_launches(
            torch, KERNELS, lambda: [fn() for _ in range(N_PAR_TIMED)])
        runs[name]["step_wall_ms"] = 1e3 * wall / N_PAR_TIMED
        by_kernel, wall_ms, _ = profile_device(torch, fn, 3)
        prof[name] = {"device_ms_per_step": sum(
            t for t, _ in by_kernel.values()) / 3,
            "profiled_wall_ms_per_step": wall_ms / 3,
            "collectives_per_step": collective_records(torch, fn, 3)}
    coll = prof["wrapper"]["collectives_per_step"]
    n_coll = coll.get("nccl:all_reduce", [0, 0])[0]
    nccl = _nccl_kernels(coll)
    # 53 BN statistics forward, 53 their gradients, 1 flat gradient buffer
    if n_coll != 2 * 53 + 1 or prof["plain"]["collectives_per_step"]:
        fail(f"config #5: {n_coll} NCCL all-reduces a wrapper step "
             f"({coll}); want 107, and none in the plain step")
    out.update({"runs": runs, "max_rel_err": err,
                "limits": {"losses": TOL_PAR_LOSS, "trees": TOL_PAR_PARAM},
                "f32": {"losses": f32, "max_rel_err": f32_err},
                "profile": prof,
                "nccl_all_reduces_per_step": n_coll,
                "nccl_kernels_per_step": sum(c for c, _ in nccl.values()),
                "nccl_device_ms_per_step": sum(t for _, t in nccl.values()),
                "grad_buffer_mb": 4 * wrapped.num_params() / 1e6})
    return out


def _seq_inputs(torch, dtype, requires_grad=False):
    g = torch.Generator(device="cuda").manual_seed(SEED + 420)
    t = [torch.randn(SEQ_SHAPE, device="cuda", generator=g).to(dtype)
         for _ in range(4)]
    km = torch.ones(SEQ_SHAPE[0], SEQ_SHAPE[2], device="cuda")
    km[:, SEQ_MASK_FROM:] = 0.0
    if requires_grad:
        t[:3] = [a.requires_grad_(True) for a in t[:3]]
    return t, km


def _row_rel(a, b):
    """The largest ||a - b|| of a row (the last dim) over that row's ||b||,
    taken no smaller than 1e-3 of the largest row's (a row that cancels to
    about 0, as a causal dq's first, is held at the tensor's scale)."""
    a, b = a.float(), b.float()
    den = b.norm(dim=-1)
    den = den.clamp_min(max(1e-3 * float(den.max()), 1e-30))
    return float(((a - b).norm(dim=-1) / den).max())


def _seq_errs(torch, got, want, dtype, metric):
    """{name: ``metric`` over the entries finite in both (inf where a
    different set is finite)} and whether every one is within TOL_SEQ."""
    errs = {}
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        fin = torch.isfinite(b)
        errs[name] = (metric(a.float().where(fin, 0), b.float().where(fin, 0))
                      if torch.equal(fin, torch.isfinite(a))
                      else float("inf"))
    return errs, all(e <= TOL_SEQ[str(dtype).split(".")[-1]]
                     for e in errs.values())


def _block_lse_bwd(q, k, v, do, lse, delta, *, causal, scale, kmask=None):
    """A control of TOL_SEQ: ``flash_block_bwd`` given the block's own lse
    in place of the ring's global one."""
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        flash_block_bwd, flash_block_fwd,
    )

    kw = dict(causal=causal, scale=scale, kmask=kmask)
    _, own = flash_block_fwd(q, k, v, **kw)
    return flash_block_bwd(q, k, v, do, own, delta, **kw)


def _block_delta_bwd(q, k, v, do, lse, delta, *, causal, scale,
                     kmask=None):
    """A control of TOL_SEQ: ``flash_block_bwd`` given rowsum(do * o) of
    the block's own o in place of the merged o."""
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        flash_block_bwd, flash_block_fwd,
    )

    kw = dict(causal=causal, scale=scale, kmask=kmask)
    o_i, _ = flash_block_fwd(q, k, v, **kw)
    own = (do.float() * o_i.float()).sum(-1, keepdim=True).contiguous()
    return flash_block_bwd(q, k, v, do, lse, own, **kw)


# each planted in place of the ring's flash_block_bwd for one replay
SEQ_CONTROLS = {"block_lse": _block_lse_bwd, "block_delta": _block_delta_bwd}


def phase_ring_replay(torch, np):
    """The flash ring of 4 replayed on the card at the long-context lane's
    shape (T_local = 2048), forward and backward, causal and not, with a
    key-padding mask, f32 and bf16: against one flash call over the whole
    sequence and against the plain versions; device ms of the replay's
    forward + backward against the one call's."""
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        flash_backward, flash_backward_plain, flash_forward,
        flash_forward_plain,
    )
    from deeplearning4j_tpu_torch.parallel import sequence
    from deeplearning4j_tpu_torch.parallel.sequence import replay_ring_flash

    kernels = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    scale = 1.0 / SEQ_SHAPE[3] ** 0.5
    ring_bwd = sequence.flash_block_bwd
    rows, launches = [], {k.name: 0 for k in kernels}
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v, do), km = _seq_inputs(torch, dtype)
        for causal in (False, True):
            kw = dict(scale=scale, causal=causal, kmask=km)

            def replay():
                return replay_ring_flash(q, k, v, size=SEQ_RING, kmask=km,
                                         do=do, causal=causal, scale=scale)

            def one_call():
                o, lse = flash_forward(q, k, v, **kw)
                delta = (do.float() * o.float()).sum(-1, keepdim=True)
                return (o, lse) + flash_backward(q, k, v, do, lse, delta,
                                                 **kw)

            got, n, _, _ = _count_launches(torch, kernels, replay)
            for name in launches:
                launches[name] += n[name]
            blocks = (SEQ_RING * (SEQ_RING + 1) // 2 if causal
                      else SEQ_RING * SEQ_RING)
            if any(n[kk.name] != blocks for kk in kernels):
                fail(f"ring replay {dtype} causal={causal} launched {n}; "
                     f"want {blocks} of each flash kernel")
            single = one_call()
            po, plse = flash_forward_plain(q, k, v, **kw)
            pdelta = (do.float() * po.float()).sum(-1, keepdim=True)
            plain = (po, plse) + flash_backward_plain(q, k, v, do, plse,
                                                      pdelta, **kw)
            e_one, ok_one = _seq_errs(torch, got, single, dtype, _row_rel)
            e_plain, ok_plain = _seq_errs(torch, got, plain, dtype, _max_rel)
            del plain, po, plse, pdelta
            if not (ok_one and ok_plain):
                fail(f"ring replay {dtype} causal={causal}: against one "
                     f"flash call {e_one}, against plain {e_plain} "
                     f"(tolerance {TOL_SEQ})")
            e_ctl = {}
            for fault, bwd in SEQ_CONTROLS.items():
                sequence.flash_block_bwd = bwd
                try:
                    bad = replay()
                finally:
                    sequence.flash_block_bwd = ring_bwd
                e_ctl[fault], missed = _seq_errs(torch, bad, single, dtype,
                                                 _row_rel)
                del bad
                if missed:
                    fail(f"ring replay {dtype} causal={causal}: the control "
                         f"{fault} is within {TOL_SEQ} of one flash call "
                         f"({e_ctl[fault]}); the check cannot tell")
            rows.append({
                "dtype": str(dtype).split(".")[-1], "causal": causal,
                "masked_from": SEQ_MASK_FROM, "launches": n,
                "max_err_vs_one_call": e_one, "max_err_vs_plain": e_plain,
                "controls_max_err_vs_one_call": e_ctl,
                "replay_device_ms": call_device_ms(torch, replay,
                                                   N_SEQ_TIMED),
                "one_call_device_ms": call_device_ms(torch, one_call,
                                                     N_SEQ_TIMED)})
            torch.cuda.empty_cache()
    return {"shape": list(SEQ_SHAPE), "ring": SEQ_RING,
            "t_local": SEQ_SHAPE[2] // SEQ_RING, "tolerance": TOL_SEQ,
            "rows": rows, "launches": launches}


def phase_sequence_world1(torch, np, mesh):
    """ring_attention, ring_attention_zigzag and ulysses_attention through
    the NCCL group of one rank at the lane's shape (bf16, causal), forward
    and backward, against one flash_attention call."""
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        flash_attention,
    )
    from deeplearning4j_tpu_torch.parallel import (
        ring_attention, ring_attention_zigzag, ulysses_attention,
    )

    kernels = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    (q, k, v, do), _ = _seq_inputs(torch, torch.bfloat16, True)

    def run(fn):
        out = fn(q, k, v)
        grads = torch.autograd.grad((out.float() * do.float()).sum(),
                                    (q, k, v))
        return (out.detach(),) + grads

    want = run(lambda a, b, c: flash_attention(a, b, c, causal=True))
    out = {}
    for name, fn in (
            ("ring", lambda a, b, c: ring_attention(a, b, c, mesh,
                                                    causal=True)),
            ("zigzag", lambda a, b, c: ring_attention_zigzag(a, b, c, mesh)),
            ("ulysses", lambda a, b, c: ulysses_attention(a, b, c, mesh,
                                                          causal=True))):
        got, n, _, wall = _count_launches(torch, kernels, lambda: run(fn))
        errs = {w: _max_rel(a, b) for w, a, b in zip(
            ("o", "dq", "dk", "dv"), got, want)}
        if any(e > TOL_SEQ["bfloat16"] for e in errs.values()):
            fail(f"{name} at one rank against one flash call: {errs}")
        if any(n[kk.name] < 1 for kk in kernels):
            fail(f"{name} launched {n}: its core must run the flash kernels")
        out[name] = {"launches": n, "max_rel_err": errs, "wall_ms": wall * 1e3,
                     "device_ms": call_device_ms(torch, lambda: run(fn), 2)}
    out["one_call_device_ms"] = call_device_ms(
        torch, lambda: run(lambda a, b, c: flash_attention(a, b, c,
                                                           causal=True)), 2)
    out["launches"] = {kk.name: sum(out[p]["launches"][kk.name]
                                    for p in ("ring", "zigzag", "ulysses"))
                       for kk in kernels}
    return out


def phase_modules_world1(torch, np, mesh):
    """sequence_parallel_encoder, one TensorParallel step and one switch_moe
    step at one rank on the card, each against its single-device run."""
    from deeplearning4j_tpu_torch.common.trees import tree_map
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        TransformerEncoderLayer,
    )
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD
    from deeplearning4j_tpu_torch.parallel import (
        TensorParallel, init_moe_params, place_moe_params,
        sequence_parallel_encoder, switch_moe,
    )

    kernels = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    out = {}
    # BERT-base's block (768, 12 heads), B = 2, T = 2048, f32
    layer = TransformerEncoderLayer(d_model=768, n_heads=12, causal=True)
    params, _ = layer.init(torch.Generator().manual_seed(SEED),
                           InputType.recurrent(768, 2048), "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((2, 2048, 768), device="cuda", generator=g)

    def enc(fn):
        p = {kk: vv.clone().requires_grad_(True) for kk, vv in params.items()}
        y = fn(p)
        grads = torch.autograd.grad((y * y).sum(), list(p.values()))
        return y.detach(), dict(zip(p, grads))

    (y1, g1), n, _, _ = _count_launches(torch, kernels, lambda: enc(
        lambda p: sequence_parallel_encoder(p, x, mesh, n_heads=12,
                                            causal=True)))
    y0, g0 = enc(lambda p: layer.apply(p, {}, x)[0])
    errs = {"y": _max_rel(y1, y0), "grads": _grads_rel_err(g1, g0)}
    if max(errs.values()) > TOL_PAR_MODULE or n[FLASH_FWD.name] != 1:
        fail(f"sequence_parallel_encoder at one rank: {errs}, launches {n}")
    out["encoder"] = {"launches": n, "max_rel_err": errs}
    # one TensorParallel step of a BERT-base-width encoder stack against
    # the plain step (no clip: at one rank each reduction divides by 1)
    plain, tp_net = (lm_net(torch, device="cuda", d=768, heads=12,
                            layers=2, vocab=1024, max_len=256)
                     for _ in range(2))
    ids = torch.randint(0, 1024, (8, 256), device="cuda", generator=g)
    yl = torch.nn.functional.one_hot(torch.randint(
        0, 1024, (8, 256), device="cuda", generator=g), 1024).float()
    tp = TensorParallel(tp_net, mesh)
    (lt,), n, _, _ = _count_launches(torch, kernels,
                                     lambda: [float(tp.fit_batch((ids, yl)))])
    lp = float(plain.fit_batch((ids, yl)))
    errs = {"loss": abs(lt - lp) / abs(lp),
            "params": _tree_rel_err(tp_net.params, plain.params)}
    if max(errs.values()) > TOL_PAR_MODULE or n[FLASH_DKV.name] != 2:
        fail(f"TensorParallel step at one rank: {errs}, launches {n}")
    out["tensor_parallel"] = {"launches": n, "max_rel_err": errs,
                              "loss": lt}
    # one switch_moe step, 8 experts of 768 -> 3072, 4096 tokens
    mp = init_moe_params(torch.Generator().manual_seed(SEED + 8), 768, 3072,
                         8, device="cuda")
    xm = torch.randn((4096, 768), device="cuda", generator=g)

    def moe(p, **kw):
        ps = tree_map(lambda a: a.clone().requires_grad_(True), p)
        y, aux = switch_moe(ps, xm, **kw)
        grads = torch.autograd.grad((y * y).mean() + 0.01 * aux,
                                    list(ps.values()))
        return y.detach(), float(aux), dict(zip(ps, grads))

    (y1, a1, g1), n, _, _ = _count_launches(
        torch, kernels, lambda: moe(place_moe_params(mp, mesh), mesh=mesh))
    y0, a0, g0 = moe(mp)
    errs = {"y": _max_rel(y1, y0), "aux": abs(a1 - a0) / abs(a0),
            "grads": _grads_rel_err(g1, g0)}
    if max(errs.values()) > TOL_PAR_MODULE:
        fail(f"switch_moe at one rank: {errs}")
    out["switch_moe"] = {"launches": n, "max_rel_err": errs, "aux": a1}
    out["launches"] = {kk.name: sum(out[p]["launches"][kk.name] for p in (
        "encoder", "tensor_parallel", "switch_moe")) for kk in kernels}
    return out


def nccl_group_records(torch, mesh):
    """The collective records of one all-reduce of 4 floats on the group."""
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    return collective_records(
        torch, lambda: dist.all_reduce(t, group=mesh.group("data")), 3)


def save_resnet_zip(net):
    """Phase 20's ResNet-50 as a zip in a temporary directory, for config
    #5 (phase 42): (the directory, the zip's path, seconds to write)."""
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "resnet50.zip")
    t0 = time.perf_counter()
    net.save(path)
    return tmp, path, time.perf_counter() - t0


def phase_parallel(torch, np, zip_path, zip_save_s):
    """Phase 42: config #5 and the sequence-parallel path. The ring replay
    runs first, outside any group; the rest in an NCCL group of one rank
    that the phase creates and destroys."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, launch

    t0 = time.perf_counter()
    walls = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(torch, np, *args)
        walls[name] = time.perf_counter() - t

    out = {}
    part("ring_replay", phase_ring_replay)
    with launch.local_group("cuda"):
        mesh = DeviceMesh(data=1, device="cuda")
        seq_mesh = DeviceMesh(data=1, seq=1, device="cuda")
        out["nccl_all_reduce"] = nccl_group_records(torch, mesh)
        if out["nccl_all_reduce"].get("nccl:all_reduce", [0])[0] != 1:
            fail(f"an all-reduce on the group left the records "
                 f"{out['nccl_all_reduce']}: the group does not run on NCCL")
        part("config5", phase_config5, zip_path, zip_save_s)
        part("sequence_world1", phase_sequence_world1, seq_mesh)
        part("modules_world1", phase_modules_world1, mesh)
    out["wall_s_parts"] = walls
    out["wall_s_phase"] = time.perf_counter() - t0
    return out


# ------------------------------------------ parallel slice, second half

N_MICRO = 4
N_PIPE_STAGES = 4
N_PIPE_STEPS = 3
PIPE_BATCH, PIPE_T = 32, 128
PIPE_LR = 1e-2
N_PIPE_TIMED = 1
# the replayed pipeline against the unpipelined stack and the net's own
# encoder (max |a - b| over max |b|): bf16 microbatches run GEMMs of other
# shapes (8 rows of sequences, not 32), and 12 bf16 blocks round each
# differently; f32 with TF32 off differs only in the order of f32 sums.
# The steps (Sgd, so that an update is the gradient's image; Adam's
# m / sqrt(v) turns the sign of a near-zero gradient into a full step):
# the losses relative, and the updates over 3 steps against the
# sequential steps' (_grads_rel_err over every leaf). Read on NVIDIA H100
# 80GB HBM3, 700.00 W: the forward bf16 0, f32 8.2e-7; the steps bf16
# 1.7e-3 and 3.7e-3, f32 4.7e-6 and 1.6e-6. The controls (stage 1
# skipped at tick 1, microbatch 0; the stages in the wrong order) must
# miss the limits (read 0.6, and updates 0.99-1.0)
TOL_PIPE = {"bfloat16": 1e-2, "float32": 5e-6}
TOL_PIPE_STEP = {"bfloat16": (5e-3, 1.5e-2), "float32": (2e-5, 1e-5)}
# ResNet-50 cut by resnet50_pipeline_plan, replayed as a HeteroPipe of 4
# microbatches of 16 against the net's output() on the 64 images: the
# softmax, max |a - b| over max |b|. cuDNN picks algorithms by batch, so
# each logit rounds differently through 50 layers; f32 (TF32 off) differs
# in the order of f32 sums. Read on NVIDIA H100 80GB HBM3, 700.00 W: the
# net phase 21 trained bf16 5.5e-2, f32 2.9e-6 (a fresh net 0); the
# control (a microbatch dropped between stages 2 and 3) 0.92-1.0
TOL_HETERO_RESNET = {"bfloat16": 0.2, "float32": 1e-3}
N_SPARK_STEPS = 10
SPARK_BATCH, SPARK_T = 64, 64
N_FT_STEPS, FT_SAVE_EVERY, FT_FAULT_STEP = 10, 5, 7
# the flash kernels at the parallel paths' shapes: the ring's step block
# (phase 42, causal) and the pipeline's microbatch (no mask)
FLASH_PAR_SHAPES = (("ring_step_causal", (1, 4, 8192, 128), True),
                    ("pipeline_microbatch", (8, 12, 128, 64), False))


def _enc_stage(layers, compute):
    """A pipeline stage of ``len(layers)`` encoder blocks: params {"l<i>":
    block params} (f32 masters, cast to the compute type as the net's
    forward casts them), activations in the compute type."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating

    def stage(p, h):
        p = cast_floating(p, compute)
        for i, layer in enumerate(layers):
            h, _ = layer.apply(p[f"l{i}"], {}, h)
        return h

    return stage


def _drop_tick(fn, at):
    """The control of a replay: ``fn`` with its call ``at`` (counted from
    0) lost: answered by its input where the shapes allow (the stage
    skipped at that tick), else by zeros (its output dropped on the way to
    the next stage)."""
    calls = [0]

    def wrapped(p, x):
        calls[0] += 1
        y = fn(p, x)
        if calls[0] != at + 1:
            return y
        return x.to(y.dtype) if x.shape == y.shape else y * 0

    return wrapped


def _bert_pipeline_parts(torch, np, dtype):
    """BertBase (config #4's widths, dropout off) on the card in ``dtype``:
    the embedding output on [32, 128] ids, the 12 encoder blocks, their
    params stacked into 4 stages of 3 (f32 masters), the net's own encoder
    output, a [CLS] head and labels."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        TransformerEncoderLayer,
    )
    from deeplearning4j_tpu_torch.parallel import stack_stage_params
    from deeplearning4j_tpu_torch.zoo import BertBase

    net = BertBase(seed=SEED, max_len=PIPE_T, dropout=0.0,
                   dtype="bf16" if dtype == torch.bfloat16
                   else "float32").init(device="cuda")
    x, y, _ = _bert_batch(np, SEED + 43, B=PIPE_BATCH, T=PIPE_T)
    blocks = [i for i, l in enumerate(net.layers)
              if isinstance(l, TransformerEncoderLayer)]
    per = len(blocks) // N_PIPE_STAGES
    with torch.no_grad():
        params = net._compute_params()
        h = net._input(x)
        for i in range(blocks[0]):
            h, _ = net.layers[i].apply(params[i], net.state[i], h)
        enc = h
        for i in blocks:
            enc, _ = net.layers[i].apply(params[i], net.state[i], enc)
    stages = [{f"l{j}": net.params[blocks[s * per + j]] for j in range(per)}
              for s in range(N_PIPE_STAGES)]
    g = torch.Generator(device="cuda").manual_seed(SEED + 44)
    head = {"W": 0.02 * torch.randn((h.shape[-1], 2), device="cuda",
                                    generator=g),
            "b": torch.zeros(2, device="cuda")}
    layers = [net.layers[i] for i in blocks[:per]]
    return {"h": h.detach(), "enc": enc.detach(),
            "stacked": stack_stage_params(stages), "head": head,
            "y": torch.as_tensor(y, device="cuda").argmax(-1),
            "stage": _enc_stage(layers, net._policy.compute_dtype),
            "whole": _enc_stage([net.layers[i] for i in blocks],
                                net._policy.compute_dtype),
            "blocks": [net.params[i] for i in blocks]}


def _pipe_loss(torch):
    def head_fn(hp, h):
        return h[:, 0, :].float() @ hp["W"] + hp["b"]

    def loss_fn(pred, y):
        return torch.nn.functional.cross_entropy(pred, y)

    return head_fn, loss_fn


def _pipe_steps(torch, pipe, parts, steps=N_PIPE_STEPS):
    """``steps`` pipeline_train_step steps (Sgd) from the parts' params:
    (losses, params)."""
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import pipeline_train_step

    head_fn, loss_fn = _pipe_loss(torch)
    step = pipeline_train_step(pipe, loss_fn, Sgd(lr=PIPE_LR), head_fn)
    params = {"stages": parts["stacked"], "head": parts["head"]}
    opt = Sgd(lr=PIPE_LR).init_state(params)
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, i, parts["h"], parts["y"])
        losses.append(float(loss))
    return losses, params


def _pipe_step_errs(torch, parts, got, want):
    """The losses' relative error, and the updates against the sequential
    updates (max |a - b| over every leaf, over the largest |b| of them
    all: a key bias's gradient is 0 in exact arithmetic)."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    (lg, pg), (lw, pw) = got, want
    p0 = tree_leaves({"stages": parts["stacked"], "head": parts["head"]})
    ug = dict(enumerate(a - z for a, z in zip(tree_leaves(pg), p0)))
    uw = dict(enumerate(b - z for b, z in zip(tree_leaves(pw), p0)))
    return {"losses": max(abs(a - b) / abs(b) for a, b in zip(lg, lw)),
            "updates": _grads_rel_err(ug, uw)}


def phase_pipeline_bert(torch, np):
    """(a), the replay: GPipe over BertBase's encoder, 4 stages of 3
    blocks, 4 microbatches of 8, every stage's tick replayed on the card
    (``GPipe(mesh=None)``), bf16 and f32: the forward against
    ``sequential_reference`` and the net's own encoder output, 3
    ``pipeline_train_step`` steps against the same steps run sequentially,
    the controls, the flash launches, device ms against the unpipelined
    stack."""
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD
    from deeplearning4j_tpu_torch.parallel import GPipe

    from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map

    kernels = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    out = {"model": "BertBase encoder (12 x 768, 12 heads of 64, d_ff "
                    "3072), dropout off; 4 stages of 3 blocks, 4 "
                    "microbatches of 8, replayed on the card",
           "batch": [PIPE_BATCH, PIPE_T], "limits": TOL_PIPE,
           "step_limits": TOL_PIPE_STEP}
    ticks = N_MICRO + N_PIPE_STAGES - 1
    walls = out["wall_s"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        parts = _bert_pipeline_parts(torch, np, dtype)
        walls[f"{name}_init"] = time.perf_counter() - t0
        pipe = GPipe(parts["stage"], None, n_microbatches=N_MICRO)
        h, stacked = parts["h"], parts["stacked"]
        with torch.no_grad():
            y, n_fwd, _, _ = _count_launches(
                torch, kernels, lambda: pipe(stacked, h))
            seq = pipe.sequential_reference(stacked, h)
            errs = {"vs_sequential": _max_rel(y, seq),
                    "vs_net_encoder": _max_rel(y, parts["enc"])}
            # controls: stage 1's output at tick 1 (microbatch 0) dropped;
            # the stages in the wrong order
            dropped = GPipe(_drop_tick(parts["stage"], 1 * N_PIPE_STAGES + 1),
                            None, n_microbatches=N_MICRO)(stacked, h)
            swapped = tree_map(lambda v: v[[0, 2, 1, 3]], stacked)
            ctl = {"dropped_tick": _max_rel(dropped, seq),
                   "stages_swapped": _max_rel(pipe(swapped, h), seq)}
        if max(errs.values()) > TOL_PIPE[name]:
            fail(f"pipeline {name}: {errs} over {TOL_PIPE[name]}")
        if min(ctl.values()) <= TOL_PIPE[name]:
            fail(f"pipeline {name}: a control is within {TOL_PIPE[name]} "
                 f"({ctl}); the check cannot tell")
        want_fwd = N_PIPE_STAGES * ticks * 3
        if n_fwd[FLASH_FWD.name] != want_fwd:
            fail(f"pipeline {name} forward launched {n_fwd}; want "
                 f"{want_fwd} flash forwards (every stage, every tick)")
        walls[f"{name}_forward"] = time.perf_counter() - t0
        (got, n_step, _, wall) = _count_launches(
            torch, kernels, lambda: _pipe_steps(torch, pipe, parts))
        want = _pipe_steps(torch, pipe.sequential_reference, parts)
        serr = _pipe_step_errs(torch, parts, got, want)
        # the control, its first step against the sequential first step
        ctl_step = _pipe_step_errs(torch, parts, _pipe_steps(
            torch, GPipe(_drop_tick(parts["stage"], 1 * N_PIPE_STAGES + 1),
                         None, n_microbatches=N_MICRO), parts, steps=1),
            _pipe_steps(torch, pipe.sequential_reference, parts, steps=1))
        walls[f"{name}_steps"] = time.perf_counter() - t0
        lt, pt = TOL_PIPE_STEP[name]
        if serr["losses"] > lt or serr["updates"] > pt:
            fail(f"pipeline {name} steps against sequential: {serr} "
                 f"(limits {lt}, {pt})")
        if ctl_step["updates"] <= pt:
            fail(f"pipeline {name} step control within {pt}: {ctl_step}")
        if not all(np.isfinite(got[0])):
            fail(f"pipeline {name} losses not finite: {got[0]}")
        row = {"forward_max_rel_err": errs, "controls_max_rel_err": ctl,
               "steps_max_rel_err": serr, "step_control_rel_err": ctl_step,
               "losses": got[0], "sequential_losses": want[0],
               "forward_launches": n_fwd,
               "step_launches": {k: v / N_PIPE_STEPS
                                 for k, v in n_step.items()},
               "step_wall_ms": 1e3 * wall / N_PIPE_STEPS}
        if name == "bfloat16":
            def fwd_bwd(fn):
                def run():
                    s = tree_map(lambda v: v.detach().requires_grad_(True),
                                 stacked)
                    yy = fn(s, h)
                    torch.autograd.grad(yy.float().pow(2).sum(),
                                        tree_leaves(s))
                return run

            with torch.no_grad():
                row["replay_fwd_device_ms"] = call_device_ms(
                    torch, lambda: pipe(stacked, h), N_PIPE_TIMED)
                row["stack_fwd_device_ms"] = call_device_ms(
                    torch, lambda: pipe.sequential_reference(stacked, h),
                    N_PIPE_TIMED)
            row["replay_fwd_bwd_device_ms"] = call_device_ms(
                torch, fwd_bwd(pipe), N_PIPE_TIMED)
            row["stack_fwd_bwd_device_ms"] = call_device_ms(
                torch, fwd_bwd(pipe.sequential_reference), N_PIPE_TIMED)
            _, n_fb, _, _ = _count_launches(torch, kernels, fwd_bwd(pipe))
            row["fwd_bwd_launches"] = n_fb
            walls[f"{name}_timing"] = time.perf_counter() - t0
            out["launches"] = {k: n_step[k] + n_fwd[k] for k in n_step}
            out["bf16_parts"] = parts
        out[name] = row
        torch.cuda.empty_cache()
    return out


def phase_pipeline_world1(torch, np, parts, mesh):
    """(a), at one rank: GPipe(pipe=1), the 12 blocks as one stage, one
    pipeline_train_step step through the NCCL group against the same step
    run sequentially on the same microbatches: equal bit for bit."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD
    from deeplearning4j_tpu_torch.parallel import (
        GPipe, stack_stage_params,
    )

    kernels = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    one = dict(parts, stacked=stack_stage_params(
        [{f"l{j}": p for j, p in enumerate(parts["blocks"])}]))
    pipe = GPipe(parts["whole"], mesh, n_microbatches=N_MICRO)

    def sequential(stacked, x):
        ref = GPipe(parts["whole"], None, n_microbatches=N_MICRO)
        return torch.cat([ref.sequential_reference(stacked, m)
                          for m in x.chunk(N_MICRO)])

    got, n, _, wall = _count_launches(
        torch, kernels, lambda: _pipe_steps(torch, pipe, one, steps=1))
    want = _pipe_steps(torch, sequential, one, steps=1)
    equal = got[0] == want[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(got[1]),
                                          tree_leaves(want[1])))
    if not equal:
        fail(f"GPipe(pipe=1) step over NCCL against the sequential step: "
             f"not equal ({_pipe_step_errs(torch, one, got, want)})")
    return {"launches": n, "loss": got[0], "step_wall_ms": 1e3 * wall,
            "equal_to_sequential": equal}


def _net_images(torch, net, seed):
    """RESNET_BATCH bf16 images (``_images``) at the net's input size."""
    H, W, _ = net.conf.vertex_output_types["input"].shape
    return _images(torch, seed, RESNET_BATCH, H, W, torch.bfloat16)


def phase_hetero_resnet(torch, np, zip_path):
    """(b): config #2's ResNet-50 from phase 20's zip cut by
    ``resnet50_pipeline_plan`` into 4 stages, replayed as a HeteroPipe of
    4 microbatches of 16 on [64, 224, 224, 3] images, the head after it:
    against the net's inference-mode output() within TOL_HETERO_RESNET, in
    bf16 and in f32 (the same net, TF32 off), beside a control (stage 2's
    output at its first microbatch dropped)."""
    from deeplearning4j_tpu_torch.common.dtypes import FLOAT32
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.parallel import (
        HeteroPipe, graph_stage_fn, pack_stage_params,
    )
    from deeplearning4j_tpu_torch.zoo.resnet import resnet50_pipeline_plan

    net = ComputationGraph.load(zip_path, device="cuda")
    x = _net_images(torch, net, SEED + 43)
    stages, head, shapes = resnet50_pipeline_plan(
        net, net.conf.vertex_output_types["input"].shape)
    entries = ["input"] + [s[-1] for s in stages[:-1]]
    packed, metas = pack_stage_params(
        [{n: net.params[n] for n in s if n in net.params} for s in stages])
    head_p = {n: net.params[n] for n in head if n in net.params}
    out = {"stages": [len(s) for s in stages], "head": head,
           "shapes": [list(s) for s in shapes],
           "packed_shape": list(packed.shape), "limits": TOL_HETERO_RESNET}
    for name in ("bfloat16", "float32"):
        if name == "float32":
            net._policy = FLOAT32
            x = x.float()
        fns = [graph_stage_fn(net, s, e) for s, e in zip(stages, entries)]
        head_fn = graph_stage_fn(net, head, stages[-1][-1])

        def run(stage_fns):
            pipe = HeteroPipe(stage_fns, metas, shapes, None,
                              n_microbatches=N_MICRO)
            return head_fn(head_p, pipe(packed, x)).float()

        with torch.no_grad():
            y, n, _, wall = _count_launches(torch, KERNELS,
                                            lambda: run(fns))
            want = net.output(x).float()
            bad = list(fns)
            bad[2] = _drop_tick(fns[2], 2)   # stage 2, tick 2: microbatch 0
            err, ctl = _max_rel(y, want), _max_rel(run(bad), want)
        if err > TOL_HETERO_RESNET[name] or ctl <= TOL_HETERO_RESNET[name]:
            fail(f"HeteroPipe ResNet-50 {name} against output(): {err}, "
                 f"control {ctl} (limit {TOL_HETERO_RESNET[name]})")
        if any(n.values()):
            fail(f"HeteroPipe ResNet-50 launched {n}; it runs none of the "
                 f"port's kernels")
        out[name] = {"max_rel_err": err, "control_max_rel_err": ctl,
                     "wall_ms": 1e3 * wall}
    return out


def _config3_zip(torch):
    """Config #3 (BidirectionalGravesLSTMCharRnn at its published width,
    f32) saved as a zip in a temporary directory."""
    import tempfile

    from deeplearning4j_tpu_torch.zoo import BidirectionalGravesLSTMCharRnn

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "config3.zip")
    BidirectionalGravesLSTMCharRnn(seed=SEED).init(device="cuda").save(path)
    return tmp, path


class _DoubledDivisor:
    """The control of the Spark routes: the round's average divided by
    twice the replica count (an average over a replica that is not
    there)."""

    def __init__(self, module):
        self.module, self.orig = module, module.flat_all_reduce

    def __enter__(self):
        self.module.flat_all_reduce = (
            lambda ts, g, divisor=1.0: self.orig(ts, g, 2 * divisor))

    def __exit__(self, *exc):
        self.module.flat_all_reduce = self.orig


def phase_spark_config3(torch, np, zip_path, mesh):
    """(c): config #3 through SparkDl4jMultiLayer over the NCCL group of
    one rank, averaging_frequency 1 (ParallelWrapper) and 5 (local SGD),
    10 steps at [64, 64] each from the zip, against the plain fit_batch
    from the same zip: equal bit for bit at one replica (params, and the
    updater state at K = 1; K > 1 restarts it, as the reference master
    does), beside a control (the K = 5 average divided by 2)."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ArrayDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.parallel import (
        ParameterAveragingTrainingMaster, SparkDl4jMultiLayer,
        param_averaging,
    )

    V = 77
    rng = np.random.default_rng(SEED + 45)
    xs, ys = zip(*[_char_batch(np, rng, V, SPARK_BATCH, SPARK_T)
                   for _ in range(N_SPARK_STEPS)])
    x, y = np.concatenate(xs), np.concatenate(ys)

    def load():
        return MultiLayerNetwork.load(zip_path, device="cuda")

    def spark(net, k):
        tm = (ParameterAveragingTrainingMaster.Builder()
              .batch_size_per_worker(SPARK_BATCH).averaging_frequency(k)
              .build())
        return lambda: SparkDl4jMultiLayer(mesh, net, tm).fit(
            ArrayDataSetIterator(x, y, batch_size=SPARK_BATCH))

    runs, nets = {}, {}
    for route in ("plain", "k1", "k5"):
        net = nets[route] = load()
        fn = ((lambda n=net: [float(n.fit_batch((a, b)))
                              for a, b in zip(xs, ys)])
              if route == "plain" else spark(net, int(route[1])))
        _, n, _, wall = _count_launches(torch, KERNELS, fn)
        runs[route] = {"launches": {k: v for k, v in n.items() if v},
                       "step_wall_ms": 1e3 * wall / N_SPARK_STEPS}
        if n != _only(KERNELS, fused_lstm_fwd=4 * N_SPARK_STEPS,
                      fused_lstm_bwd=4 * N_SPARK_STEPS):
            fail(f"config #3 {route}: {n}; want 4 + 4 LSTM launches a step")
    plain = nets["plain"]
    eq = lambda a, b: all(torch.equal(p, q) for p, q in zip(  # noqa: E731
        tree_leaves(a), tree_leaves(b)))
    equal = {"k1_params": eq(nets["k1"].params, plain.params),
             "k1_updater_state": eq(nets["k1"].opt_state, plain.opt_state),
             "k5_params": eq(nets["k5"].params, plain.params)}
    ctl_net = load()
    with _DoubledDivisor(param_averaging):
        spark(ctl_net, 5)()
    equal["control_k5_halved_average"] = eq(ctl_net.params, plain.params)
    if not all(v for k, v in equal.items() if not k.startswith("control")):
        fail(f"config #3 Spark routes against plain fit at one replica: "
             f"{equal}; want equal bit for bit")
    if equal["control_k5_halved_average"]:
        fail("config #3: the control (average halved) equals plain fit")
    return {"model": "BidirectionalGravesLSTMCharRnn(units=200, layers=2, "
                     "vocab=77), Adam 1e-3, clipping 5.0, f32, from a zip",
            "batch": [SPARK_BATCH, SPARK_T], "steps": N_SPARK_STEPS,
            "routes": runs, "equal_to_plain": equal}


def phase_fault_tolerant(torch, np, zip_path, mesh):
    """(d): FaultTolerantTrainer over ParallelWrapper(config #3) on the
    NCCL group, save_every 5: 10 uninterrupted steps; 10 steps with a
    preempt fault at step 7 (unmanaged: the process dies there), a new
    trainer restoring step 5 and running to 10: params and updater state
    equal the uninterrupted run's bit for bit, beside a control (the
    relaunch with nothing to restore); checkpoint save and restore ms."""
    import tempfile

    from deeplearning4j_tpu_torch import faults
    from deeplearning4j_tpu_torch.common.trees import tree_leaves
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS
    from deeplearning4j_tpu_torch.parallel import (
        FaultTolerantTrainer, ParallelWrapper,
    )

    V = 77
    rng = np.random.default_rng(SEED + 46)
    batches = [_char_batch(np, rng, V, SPARK_BATCH, SPARK_T)
               for _ in range(N_FT_STEPS)]
    tmp = tempfile.TemporaryDirectory()

    def trainer(name):
        net = MultiLayerNetwork.load(zip_path, device="cuda")
        return FaultTolerantTrainer(ParallelWrapper(net, mesh),
                                    os.path.join(tmp.name, name),
                                    save_every=FT_SAVE_EVERY)

    def run(tr):
        target = tr._target
        while target.step_count < N_FT_STEPS:
            tr.fit_batch(batches[target.step_count])
        tr.checkpointer.wait()
        return target

    with tmp:
        plain, n, _, _ = _count_launches(torch, KERNELS,
                                         lambda: run(trainer("plain")))
        crashed = trainer("crash")
        with faults.injected(f"preempt:1@step=={FT_FAULT_STEP}") as plan:
            try:
                run(crashed)
                fail("the injected preemption did not stop the run")
            except faults.PreemptionFault:
                pass
        crashed.checkpointer.wait()
        fault_step = crashed._target.step_count
        t0 = time.perf_counter()
        resumed_tr = trainer("crash")
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        resumed = run(resumed_tr)
        # the control: a relaunch that restores nothing and runs steps 5
        # to 10 from the zip's params
        ctl_tr = trainer("fresh")
        ctl_tr._target.step_count = FT_SAVE_EVERY
        control = run(ctl_tr)
        t0 = time.perf_counter()
        resumed_tr.checkpointer.save(99, resumed)
        resumed_tr.checkpointer.wait()
        save_ms = 1e3 * (time.perf_counter() - t0)
    eq = lambda a, b: all(torch.equal(p, q) for p, q in zip(  # noqa: E731
        tree_leaves(a), tree_leaves(b)))
    equal = {"params": eq(resumed.params, plain.params),
             "updater_state": eq(resumed.opt_state, plain.opt_state),
             "control_unrestored_params": eq(control.params, plain.params)}
    if (resumed_tr.restored_step != FT_SAVE_EVERY or fault_step
            != FT_FAULT_STEP or plan.injected["preempt"] != 1):
        fail(f"fault-tolerant run: fault at {fault_step}, restored "
             f"{resumed_tr.restored_step}; want {FT_FAULT_STEP} and "
             f"{FT_SAVE_EVERY}")
    if not (equal["params"] and equal["updater_state"]) or equal[
            "control_unrestored_params"]:
        fail(f"resumed config #3 against the uninterrupted run: {equal}")
    return {"restored_step": resumed_tr.restored_step,
            "fault_at_step": fault_step, "equal": equal,
            "launches": n, "checkpoint_save_ms": save_ms,
            "trainer_restore_ms": restore_ms,
            "checkpoint_mb": 4 * plain.num_params() * 3 / 1e6}


def phase_initialize_distributed(torch, np):
    """(e): initialize_distributed with NUM_PROCESSES=1 and two injected
    coord_connect refusals (two retries), the summary, and a group on NCCL
    (an all-reduce's nccl:all_reduce host record); the control: more
    refusals than attempts raises."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import faults
    from deeplearning4j_tpu_torch.parallel import (
        DeviceMesh, initialize_distributed,
    )

    os.environ["NUM_PROCESSES"] = "1"
    try:
        t0 = time.perf_counter()
        with faults.injected("coord_connect:2") as plan:
            info = initialize_distributed()
        connect_s = time.perf_counter() - t0
        try:
            records = nccl_group_records(torch, DeviceMesh(
                data=1, device="cuda"))
            backend = str(dist.get_backend())
        finally:
            dist.destroy_process_group()
        try:
            with faults.injected("coord_connect:9"):
                initialize_distributed(retry=faults.RetryPolicy(
                    max_attempts=2, base_delay_s=0.001))
            dist.destroy_process_group()
            fail("initialize_distributed with every attempt refused "
                 "returned")
        except faults.CoordinatorConnectFault:
            pass
    finally:
        del os.environ["NUM_PROCESSES"]
    want = {"process_index": 0, "process_count": 1, "local_devices": 1,
            "global_devices": 1}
    if (info != want or plan.injected["coord_connect"] != 2
            or records.get("nccl:all_reduce", [0])[0] != 1):
        fail(f"initialize_distributed: {info}, refusals "
             f"{dict(plan.injected)}, records {records}")
    return {"summary": info, "refusals_retried": 2, "connect_s": connect_s,
            "backend": backend, "nccl_all_reduce": records}


class _Logits:
    """A ResNet-50's pre-softmax logits as its ``output`` (its softmax
    over 1000 classes rounds to the same row for every image of a random
    net: a check on it could not tell the rows apart)."""

    def __init__(self, torch, net):
        self.torch, self.net, self.device = torch, net, net.device

    def output(self, x):
        return _resnet_logits(self.torch, self.net, x)


def phase_inference_mesh(torch, np, zip_path, mesh):
    """(f): ParallelInference(ResNet-50, mesh=DeviceMesh(data=1)).output
    at B = 64 against net.output, and through the same path the logits
    against the net's: equal bit for bit; the control (the logits of the
    rows reversed) must differ."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = ComputationGraph.load(zip_path, device="cuda")
    x = _net_images(torch, net, SEED + 47)
    pi = ParallelInference(net, mesh=mesh, device="cuda")
    logits = _Logits(torch, net)
    pl = ParallelInference(logits, mesh=mesh, device="cuda")
    equal = {"output": torch.equal(pi.output(x), net.output(x)),
             "logits": torch.equal(pl.output(x), logits.output(x))}
    ctl = _max_rel(pl.output(x.flip(0)), logits.output(x))
    if not all(equal.values()) or ctl == 0.0:
        fail(f"ParallelInference over the mesh against the net: {equal}; "
             f"control (rows reversed) {ctl}")
    return {"equal": equal, "control_max_rel_err": ctl,
            "ms_per_call": host_ms(torch, lambda: pi.output(x), 3),
            "net_ms_per_call": host_ms(torch, lambda: net.output(x), 3)}


def flash_at_parallel_shapes(torch):
    """The three flash kernels (bf16) at the parallel paths' shapes
    (FLASH_PAR_SHAPES): CUDA-event and device ms of each, the bound of
    each, and scaled_dot_product_attention's forward and forward +
    backward as the library yardstick."""
    from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
        DKV_KERNEL_NAMES, DQ_KERNEL_NAMES, FWD_KERNEL_NAMES, flash_backward,
        flash_forward,
    )

    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 48)
    out = {}
    for name, (B, N, T, D), causal in FLASH_PAR_SHAPES:
        q, k, v, do = (torch.randn((B, N, T, D), device="cuda",
                                   generator=g).to(bf16) for _ in range(4))
        kw = dict(scale=1.0 / D ** 0.5, causal=causal)
        o, lse = flash_forward(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        fwd = lambda: flash_forward(q, k, v, **kw)  # noqa: E731
        bwd = lambda: flash_backward(  # noqa: E731
            q, k, v, do, lse, delta, **kw)
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(lq, lk, lv, is_causal=causal)
        lib_fwd = lambda: sdpa(q, k, v, is_causal=causal)  # noqa: E731
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (lq, lk, lv), do, retain_graph=True)
        row = {"shape": [B, N, T, D], "causal": causal, "dtype": "bfloat16",
               "fwd_ms": cuda_ms(torch, fwd, 10),
               "bwd_ms": cuda_ms(torch, bwd, 10),
               "fwd_device_ms": kernel_device_ms(torch, fwd, 5,
                                                 FWD_KERNEL_NAMES[bf16]),
               "dq_device_ms": kernel_device_ms(torch, bwd, 5,
                                                DQ_KERNEL_NAMES[bf16]),
               "dkv_device_ms": kernel_device_ms(torch, bwd, 5,
                                                 DKV_KERNEL_NAMES[bf16]),
               "library_fwd_ms": cuda_ms(torch, lib_fwd, 10),
               "library_bwd_ms": cuda_ms(torch, lib_bwd, 10),
               "library_fwd_device_ms": call_device_ms(torch, lib_fwd, 5),
               "library_bwd_device_ms": call_device_ms(torch, lib_bwd, 5)}
        for kind in ("fwd", "dq", "dkv"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = flash_bound(
                torch, kind, q, k, None, causal)
        out[name] = row
        del lib_out, lq, lk, lv
        torch.cuda.empty_cache()
    return out


def phase_parallel2(torch, np, resnet_zip):
    """Phase 43: the second half of the parallel slice. The replays and
    the flash kernels at the parallel shapes run outside any group; the
    rest in an NCCL group of one rank that the phase creates and destroys
    (initialize_distributed creates and destroys its own)."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, launch

    t0 = time.perf_counter()
    walls, out = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(torch, np, *args)
        walls[name] = time.perf_counter() - t

    part("pipeline_bert", phase_pipeline_bert)
    parts = out["pipeline_bert"].pop("bf16_parts")
    part("hetero_resnet", phase_hetero_resnet, resnet_zip)
    part("initialize_distributed", phase_initialize_distributed)
    tmp, c3_zip = _config3_zip(torch)
    with tmp, launch.local_group("cuda"):
        mesh = DeviceMesh(data=1, device="cuda")
        part("pipeline_world1", phase_pipeline_world1, parts,
             DeviceMesh(data=1, pipe=1, device="cuda"))
        del parts
        part("spark_config3", phase_spark_config3, c3_zip, mesh)
        part("fault_tolerant_config3", phase_fault_tolerant, c3_zip, mesh)
        part("inference_mesh", phase_inference_mesh, resnet_zip, mesh)
    out["wall_s_parts"] = walls
    out["wall_s_phase"] = time.perf_counter() - t0
    if out["wall_s_phase"] > 60:
        fail(f"phase 43 took {out['wall_s_phase']:.1f} s of wall, over 60")
    t = time.perf_counter()
    out["flash_parallel_shapes"] = flash_at_parallel_shapes(torch)
    out["wall_s_flash_rows"] = time.perf_counter() - t
    return out


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
    emit(card, {"kernel_shapes": rows})

    # phase 4: serving main path
    main_path = phase_main_path(torch, np)
    emit(card, {"main_path": main_path, "card": card})
    print(f"main path on {card}: {main_path['tokens_per_s']:.1f} tokens/s, "
          f"TTFT p50 {main_path['ttft_p50_ms']:.2f} ms", flush=True)

    # phase 5: the bf16 net
    emit(card, {"bf16_net": phase_bf16_net(torch, np)})

    # phase 6: backward kernel against plain
    bwd_rows, bwd_worst, bwd_worst_bf16 = phase_bwd_kernels(torch)
    emit(card, {"bwd_kernel_shapes": bwd_rows})

    # phase 7: training main path
    train = phase_training(torch, np)
    emit(card, {"training": train, "card": card})
    print(f"training on {card}: {train['step_wall_ms']:.2f} ms a step, "
          f"{train['samples_per_s']:.1f} samples/s", flush=True)

    # phase 8: TextGenerationLSTM and bf16 char-RNN training
    from deeplearning4j_tpu_torch.zoo import (
        BidirectionalGravesLSTMCharRnn, TextGenerationLSTM,
    )

    short = [phase_short_training(torch, np, TextGenerationLSTM(seed=SEED), 2),
             phase_short_training(torch, np, BidirectionalGravesLSTMCharRnn(
                 seed=SEED, dtype="bf16"), 4)]
    emit(card, {"short_training": short})

    # phase 9: flash kernels against plain, the bf16 ones on tensor cores
    tensor_cores = flash_tensor_cores(torch)
    emit(card, {"flash_tensor_cores": tensor_cores})
    print("tensor-core instructions: " + ", ".join(
        f"{k} {v}" for k, v in tensor_cores["sass"].items()), flush=True)
    flash_rows, flash_times, flash_grad_rel, flash_worst, flash_worst_bf16 = \
        phase_flash_kernels(torch)
    emit(card, {"flash_kernel_shapes": flash_rows,
                      "flash_function_grad_max_rel_err": flash_grad_rel,
                      "flash_times": flash_times, "card": card})

    # phase 10: BERT-base inference
    bert_out, bert_net = phase_bert_inference(torch, np)
    emit(card, {"bert_inference": bert_out, "card": card})
    print(f"BERT-base output() on {card}: "
          f"{bert_out['wall_ms_per_call']:.2f} ms a call of 32 x 128, "
          f"device busy {bert_out['profile']['device_busy_share']}",
          flush=True)

    # phase 11: BERT-base fine-tuning
    bert_train = phase_bert_training(torch, np, bert_net)
    del bert_net
    emit(card, {"bert_training": bert_train, "card": card})
    print(f"BERT-base fine-tuning on {card}: "
          f"{bert_train['step_wall_ms']:.2f} ms a step, "
          f"{bert_train['samples_per_s']:.1f} samples/s", flush=True)

    # phase 12: LRN kernels against plain
    lrn_rows, lrn_times, lrn_grad_rel, lrn_worst, lrn_worst_bf16 = \
        phase_lrn_kernels(torch)
    emit(card, {"lrn_kernel_shapes": lrn_rows,
                      "lrn_function_grad_max_rel_err": lrn_grad_rel,
                      "lrn_times": lrn_times, "card": card})

    # phase 13: AlexNet inference
    alex_out, alex_net = phase_alexnet_inference(torch, np)
    emit(card, {"alexnet_inference": alex_out, "card": card})
    print(f"AlexNet output() on {card}: {alex_out['wall_ms_per_call']:.2f} "
          f"ms a call of {ALEXNET_BATCH} images, device busy "
          f"{alex_out['profile']['device_busy_share']}", flush=True)

    # phase 14: AlexNet training
    alex_train = phase_alexnet_training(torch, np, alex_net)
    del alex_net
    emit(card, {"alexnet_training": alex_train, "card": card})
    print(f"AlexNet training on {card}: {alex_train['step_wall_ms']:.2f} ms "
          f"a step, {alex_train['samples_per_s']:.1f} samples/s", flush=True)

    # phase 15: LeNet training
    lenet = phase_lenet_training(torch, np)
    emit(card, {"lenet_training": lenet, "card": card})
    print(f"LeNet training on {card}: {lenet['step_wall_ms']:.2f} ms a "
          f"step, {lenet['samples_per_s']:.1f} samples/s", flush=True)

    # phase 16: GRU kernels against plain, the bf16 grid products on the
    # tensor cores
    gru_sass = gru_grid_tensor_cores()
    emit(card, {"gru_grid_tensor_cores": gru_sass})
    gru_rows, gru_worst, gru_worst_bf16 = phase_gru_kernels(torch)
    emit(card, {"gru_kernel_shapes": gru_rows, "card": card})

    # phase 17: GRU char-RNN serving
    gru_serve = phase_gru_serving(torch, np)
    emit(card, {"gru_serving": gru_serve, "card": card})
    print(f"GRU char-RNN serving on {card}: "
          f"{gru_serve['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{gru_serve['ttft_p50_ms']:.2f} ms, device busy "
          f"{gru_serve['decode_profile']['device_busy_share']}", flush=True)

    # phase 18: GRU char-RNN training, GRULayer(256) x 2 (the cluster
    # kernels) and GRULayer(1024) x 2 (the grid kernels)
    gru_train = phase_gru_training(torch, np)
    emit(card, {"gru_training": gru_train, "card": card})
    wide_gru = phase_gru_training(torch, np, units=WIDE_GRU_UNITS)
    emit(card, {"gru1024_training": wide_gru, "card": card})
    for what, run in (("GRU char-RNN", gru_train),
                      ("GRU(1024) x 2 char-RNN", wide_gru)):
        print(f"{what} training on {card}: {run['step_wall_ms']:.2f} ms a "
              f"step, {run['samples_per_s']:.1f} samples/s, device "
              f"{run['profile']['device_ms_per_step']:.3f} ms a step, busy "
              f"{run['profile']['device_busy_share']}", flush=True)

    # phase 19: Bidirectional(GRU(200)) x 2 training
    bidi_gru = phase_gru_training(torch, np, bidi=True)
    emit(card, {"bidi_gru_training": bidi_gru, "card": card})

    # phase 20: ResNet-50 inference (BASELINE.json config #2)
    rn_out, rn_net = phase_resnet_inference(torch, np)
    emit(card, {"resnet50_inference": rn_out, "card": card})
    print(f"ResNet-50 output() on {card}: {rn_out['wall_ms_per_call']:.2f} "
          f"ms a call of {RESNET_BATCH} images, device busy "
          f"{rn_out['profile']['device_busy_share']}", flush=True)

    # phase 21: ResNet-50 training
    rn_train = phase_resnet_training(torch, np, rn_net)
    # config #5 (phase 42) starts from this net's zip
    rn_zip_dir, rn_zip, rn_zip_s = save_resnet_zip(rn_net)
    del rn_net
    emit(card, {"resnet50_training": rn_train, "card": card})
    print(f"ResNet-50 training on {card}: {rn_train['step_wall_ms']:.2f} ms "
          f"a step, {rn_train['samples_per_s']:.1f} samples/s, MFU "
          f"{rn_train['mfu']:.4f}, device busy "
          f"{rn_train['profile']['device_busy_share']}", flush=True)

    # phase 22: bert_tiny.onnx on the card against its golden
    t0 = time.perf_counter()
    golden = phase_onnx_golden(torch, np)
    golden["wall_s"] = time.perf_counter() - t0
    emit(card, {"onnx_golden": golden, "card": card})
    print(f"bert_tiny.onnx on {card}: {golden['off']['nodes']} -> "
          f"{golden['on']['nodes']} nodes, rewrites "
          f"{golden['on']['rewrites']}", flush=True)

    # phase 23: bench.py bert_import at its own shape
    t0 = time.perf_counter()
    bert_import = phase_bert_import_training(torch, np)
    bert_import["wall_s"] = time.perf_counter() - t0
    emit(card, {"bert_import_training": bert_import, "card": card})
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
    emit(card, {"bert_tf_import": bert_tf, "card": card})
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
    emit(card, {"tf_import_lrn": lrn_import, "card": card})

    # phase 26: YOLO2 inference at full width
    t0 = time.perf_counter()
    yolo_out, yolo_net = phase_yolo2_inference(torch, np)
    yolo_out["wall_s"] = time.perf_counter() - t0
    emit(card, {"yolo2_inference": yolo_out, "card": card})
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
    emit(card, {"yolo2_training": yolo_train, "card": card})
    print(f"YOLO2 training on {card}: {yolo_train['step_wall_ms']:.2f} ms a "
          f"step, {yolo_train['samples_per_s']:.1f} samples/s, MFU "
          f"{yolo_train['mfu']:.4f}, device "
          f"{yolo_train['profile']['device_ms_per_step']:.3f} ms a step, busy "
          f"{yolo_train['profile']['device_busy_share']}, peak "
          f"{yolo_train['peak_memory_gb']:.2f} GB", flush=True)

    # phase 28: the rest of the CNN zoo
    t0 = time.perf_counter()
    zoo_rows = phase_zoo(torch, np)
    emit(card, {"zoo": zoo_rows, "card": card,
                      "wall_s": time.perf_counter() - t0})
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
    emit(card, {"lane_serving": lane, "card": card})
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
    emit(card, {"full_width_serving": full, "card": card})
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
    emit(card, {"session_resume": sessions, "card": card})

    # phase 32: truncated BPTT through the LSTM kernels
    t0 = time.perf_counter()
    tbptt = phase_tbptt(torch, np)
    tbptt["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"tbptt_charrnn": tbptt, "card": card})
    print(f"tBPTT char-RNN on {card}: {tbptt['ms_per_call']:.1f} ms a "
          f"fit_batch of {TBPTT_BATCH} x {TBPTT_T} ({tbptt['chunks_per_call']}"
          f" chunks), device {tbptt['profile']['device_ms_per_call']:.2f} ms, "
          f"busy {tbptt['profile']['device_busy_share']}, "
          f"{tbptt['launches_per_call']} launches a call", flush=True)

    # phase 33: the fit loop at config #1
    t0 = time.perf_counter()
    fit_loop = phase_fit_loop(torch, np)
    fit_loop["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"fit_loop_lenet": fit_loop, "card": card})
    print(f"LeNet fit loop on {card}: MNIST synthetic {fit_loop['synthetic']}"
          f", {fit_loop['epochs']} epochs ({fit_loop['termination']}), "
          f"accuracy {fit_loop['accuracy']:.4f}; ms a step "
          f"{fit_loop['ms_per_step']}", flush=True)

    # phase 34: transfer learning at config #2's network
    t0 = time.perf_counter()
    transfer = phase_transfer_learning(torch, np, rn_train["step_wall_ms"])
    transfer["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"transfer_resnet50": transfer, "card": card})
    print(f"ResNet-50 transfer learning on {card}: "
          f"{transfer['step_wall_ms']:.2f} ms a step (the full step "
          f"{rn_train['step_wall_ms']:.2f}), peak "
          f"{transfer['peak_memory_gb']:.2f} GB", flush=True)

    # phase 35: remat at config #4's network
    t0 = time.perf_counter()
    remat = phase_remat(torch, np)
    remat["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"remat_bert": remat, "card": card})
    for k in ("remat", "no_remat"):
        r = remat[k]
        print(f"BertBase {k} on {card}: {r['step_wall_ms']:.2f} ms a step, "
              f"peak {r['peak_memory_gb']:.2f} GB, flash launches a step "
              f"{r['launches_per_step']}", flush=True)

    # phase 36: the observability slice: guardrails on config #3, their
    # cost on BertBase, monitored and traced serving, the profiler
    t0 = time.perf_counter()
    guard_run, guard_net, guard_batch = phase_guardrails(torch, np)
    guard_cost = phase_guardrail_cost(torch, np)
    monitored = phase_monitored_serving(torch, np)
    traced = phase_profiler_sysmetrics(torch, np, guard_net, guard_batch)
    del guard_net
    emit(card, {"observability": {
        "guardrails_config3": guard_run, "guardrail_cost_bert": guard_cost,
        "monitored_serving": monitored, "profiler_sysmetrics": traced,
        "wall_s_phase": time.perf_counter() - t0}})
    ladder = guard_run["ladder"]
    gsum = guard_cost["summary"]
    print(f"guardrails on {card}: config #3 armed = unarmed bit for bit, "
          f"{guard_run['clean']['launches_per_step']} launches a guarded "
          f"step; nan_grad ladder {ladder['actions']}, culprit step "
          f"{ladder['culprit_step']}", flush=True)
    print(f"guardrail cost on {card}: BertBase [32, 128] bf16 step wall "
          f"{gsum['step_wall_ms']['unarmed']:.2f} -> "
          f"{gsum['step_wall_ms']['armed']:.2f} ms, device "
          f"{gsum['device_ms_per_step']['unarmed']:.3f} -> "
          f"{gsum['device_ms_per_step']['armed']:.3f} ms, kernels "
          f"{gsum['device_kernels_per_step']['unarmed']:.0f} -> "
          f"{gsum['device_kernels_per_step']['armed']:.0f} a step", flush=True)
    print(f"monitored serving on {card}: {monitored['generate_counts']}, "
          f"streams equal to monitoring off; tokens/s on "
          f"{monitored['tokens_per_s_on']:.1f}, off "
          f"{monitored['tokens_per_s_off']}", flush=True)
    print(f"profiler trace on {card}: LSTM kernels named "
          f"{traced['lstm_kernels_named']}, device memory "
          f"{traced['device_memory_mb']['device_mem_in_use_mb']:.1f} MB",
          flush=True)

    # phase 37: Keras import, the IMDB BiLSTM through the LSTM kernels
    t0 = time.perf_counter()
    keras = phase_keras_import(torch, np)
    keras["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"keras_import": keras})
    kb, kc = keras["imdb_bilstm"], keras["mnist_convnet"]
    print(f"Keras IMDB BiLSTM on {card}: output() {kb['ms_per_call']:.2f} ms "
          f"a call of {IMDB_BATCH} (device "
          f"{kb['call_profile']['device_ms_per_call']:.3f}), fit_batch "
          f"{kb['step_wall_ms']:.2f} ms a step (device "
          f"{kb['step_profile']['device_ms_per_step']:.3f}), 4 + 4 LSTM "
          f"launches a step; against the CPU "
          f"{kb['cpu_check']['max_rel_err']}; MNIST convnet against the CPU "
          f"{kc['cpu_check_dropout_0']['max_rel_err']}", flush=True)

    # phase 38: the pretrain tier, the MNIST VAE and a stacked denoising AE
    t0 = time.perf_counter()
    pretrain = phase_pretrain(torch, np)
    pretrain["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"pretrain": pretrain})
    v = pretrain["vae"]
    print(f"VAE pretraining on {card}: {v['pretrain_steps']} steps, "
          f"{v['step_wall_ms']:.2f} ms a step (device "
          f"{v['device_ms_per_step']:.3f}), held-batch ELBO "
          f"{v['held_elbo_before']:.2f} -> {v['held_elbo_after']:.2f}",
          flush=True)

    # phase 39: quantized serving of phase 30's LM, quantized ResNet-50
    t0 = time.perf_counter()
    quant = phase_quantized_serving(torch, np, full)
    quant["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"quantized_serving": quant})
    qs, qst = quant["serving"], quant["serving"]["steady"]
    print(f"quantized LM serving (int8 weights, int8 ring) on {card}: "
          f"{qs['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{qs['ttft_p50_ms']:.1f} ms, decode step "
          f"{qst['step_wall_ms']:.3f} ms wall, device "
          f"{qst['step_device_ms']} ms; weights "
          f"{quant['quantize_pass']['bytes_before']:.0f} -> "
          f"{quant['quantize_pass']['bytes_after']:.0f} bytes; against the "
          f"unquantized net top-1 "
          f"{quant['rollout_vs_unquantized']['top1_agreement']:.4f}, "
          f"post-softmax {quant['rollout_vs_unquantized']['max_prob_delta']:.2e}"
          f"; quantized ResNet-50 {quant['resnet50']['ms_per_call']:.2f} ms "
          f"a call of {QUANT_RESNET_BATCH}", flush=True)

    # phase 40: the serving tier over HTTP, config #3 and the full-width LM
    t0 = time.perf_counter()
    tier = phase_serving_tier(torch, np)
    tier["wall_s_phase"] = time.perf_counter() - t0
    emit(card, {"serving_tier": tier})
    tp, tg, tpr = tier["predict"], tier["generate"], tier["preemption"]
    print(f"serving tier on {card}: config #3 predict "
          f"{tp['timed']['requests_per_s']:.1f} requests/s, latency p50 "
          f"{tp['timed']['latency_p50_ms']:.2f} ms, p99 "
          f"{tp['timed']['latency_p99_ms']:.2f} ms, mean batch "
          f"{tp['timed']['mean_batch_size']}, {tp['counted']['batches']} "
          f"batches x 4 LSTM forwards, {tp['host_syncs_in_one_dispatch']} "
          f"host syncs a dispatch, JSON "
          f"{tp['json_host_ms_per_request']:.2f} ms of host a request; LM "
          f"generate over HTTP "
          f"{tg['http']['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{tg['http']['ttft_p50_ms']:.1f} ms (direct "
          f"{tg['direct']['tokens_per_s']:.1f} tokens/s, "
          f"{tg['direct']['ttft_p50_ms']:.1f} ms), "
          f"{tg['launches']['flash_attention_fwd']} flash forwards; "
          f"{tpr['sessions']} sessions preempted and resumed equal",
          flush=True)

    # phase 41: SameDiff on the card: full-width BERT f32 and bf16, the
    # char-LSTM, AlexNet's conv1 block, to_samediff and the .sdz zip
    samediff = phase_samediff(torch, np)
    emit(card, {"samediff": samediff})
    sb, sc, sa = (samediff[k] for k in ("bert", "charlstm", "alexnet_conv1"))
    print(f"SameDiff on {card}: BERT-base f32 output() "
          f"{sb['f32']['output_ms']:.2f} ms (net {sb['net_f32']['output_ms']:.2f}"
          f"), step {sb['f32']['step_ms']:.2f} ms (net "
          f"{sb['net_f32']['step_ms']:.2f}), against net.output() "
          f"{sb['f32']['output_max_abs_err_vs_net']:.2e}; bf16 output() "
          f"{sb['bf16']['output_ms']:.2f} ms, step {sb['bf16']['step_ms']:.2f}"
          f" ms; char-LSTM step {sc['step_ms']:.2f} ms (net "
          f"{sc['net']['step_ms']:.2f}); AlexNet conv1 step "
          f"{sa['step_ms']:.2f} ms; phase {samediff['wall_s_phase']:.1f} s",
          flush=True)

    # phase 42: the parallel slice: config #5 through ParallelWrapper on an
    # NCCL group of one rank, the ring of 4 replayed on the card, and the
    # sequence-parallel, tensor-parallel and MoE paths at one rank
    par = phase_parallel(torch, np, rn_zip, rn_zip_s)
    emit(card, {"parallel": par})
    c5, rr = par["config5"], par["ring_replay"]["rows"]
    bf16_causal = next(r for r in rr if r["dtype"] == "bfloat16"
                       and r["causal"])
    def ms(v):  # a device time the profiler may not have recorded
        return "not measured" if v is None else f"{v:.2f} ms"

    print(f"config #5 on {card}: ParallelWrapper step "
          f"{c5['runs']['wrapper']['step_wall_ms']:.1f} ms wall (plain "
          f"{c5['runs']['plain']['step_wall_ms']:.1f}), device "
          f"{ms(c5['profile']['wrapper']['device_ms_per_step'])} (plain "
          f"{ms(c5['profile']['plain']['device_ms_per_step'])}), "
          f"{c5['nccl_all_reduces_per_step']:.0f} NCCL all-reduces a step "
          f"({c5['nccl_kernels_per_step']:.0f} device kernels, "
          f"{ms(c5['nccl_device_ms_per_step'])}); ring of 4 replayed, "
          f"bf16 causal T = {SEQ_SHAPE[2]}: forward + backward "
          f"{ms(bf16_causal['replay_device_ms'])} device (one flash call "
          f"{ms(bf16_causal['one_call_device_ms'])}); phase "
          f"{par['wall_s_phase']:.1f} s", flush=True)

    # phase 43: the parallel slice's second half: GPipe over BertBase's
    # encoder (replayed, and at one rank on NCCL), HeteroPipe over
    # ResNet-50, the Spark shims and the fault-tolerant trainer on config
    # #3, initialize_distributed, ParallelInference over a mesh
    par2 = phase_parallel2(torch, np, rn_zip)
    rn_zip_dir.cleanup()
    emit(card, {"parallel_second_half": par2})
    pb = par2["pipeline_bert"]["bfloat16"]
    sp = par2["spark_config3"]["routes"]
    ftr = par2["fault_tolerant_config3"]
    print(f"parallel, second half, on {card}: BertBase GPipe replay (4 x 3 "
          f"blocks, 4 microbatches) forward {ms(pb['replay_fwd_device_ms'])}"
          f" device (stack {ms(pb['stack_fwd_device_ms'])}), forward + "
          f"backward {ms(pb['replay_fwd_bwd_device_ms'])} (stack "
          f"{ms(pb['stack_fwd_bwd_device_ms'])}); config #3 Spark step wall "
          f"K=1 {sp['k1']['step_wall_ms']:.2f} ms, K=5 "
          f"{sp['k5']['step_wall_ms']:.2f} ms (plain "
          f"{sp['plain']['step_wall_ms']:.2f}); checkpoint save "
          f"{ftr['checkpoint_save_ms']:.1f} ms, restore "
          f"{ftr['trainer_restore_ms']:.1f} ms; phase "
          f"{par2['wall_s_phase']:.1f} s", flush=True)

    # the kernels line, card line, result line
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
    for e in entries:  # the observability slice's paths (phase 36)
        n = e["name"]
        paths = {
            "guardrails_config3": guard_run["clean"]["launches"][n],
            "guardrails_ladder_config3": ladder["launches"][n],
            "guardrail_cost_bert_armed": guard_cost["launches"]["armed"][n],
            "guardrail_cost_bert_unarmed": guard_cost["launches"][
                "unarmed"][n],
            "monitored_lstm_serving": monitored["launches"][n],
            "profiler_trace_config3": traced["launches"][n]}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    for e in entries:  # the import, pretrain and quantized paths (37-39)
        n = e["name"]
        paths = {"keras_imdb_bilstm": keras["launches"][n],
                 "pretrain_mnist": pretrain["launches"][n],
                 "quantized_lm_serving": quant["launches"][n]}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    for e in entries:  # the serving tier's paths (phase 40)
        n = e["name"]
        paths = {"serving_tier_predict": tp["launches"][n],
                 "serving_tier_generate": tg["launches"][n]}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    for e in entries:  # SameDiff's paths (phase 41)
        paths = {k: v[e["name"]]
                 for k, v in samediff["launches_by_path"].items()}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    for e in entries:  # the parallel slice's paths (phase 42)
        n = e["name"]
        paths = {
            "config5_parallel_wrapper": c5["runs"]["wrapper"]["launches"][n],
            "ring_replay_4": par["ring_replay"]["launches"].get(n, 0),
            "sequence_parallel_world1": par["sequence_world1"][
                "launches"].get(n, 0),
            "encoder_tp_moe_world1": par["modules_world1"]["launches"].get(
                n, 0)}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    for e in entries:  # the second half's paths (phase 43)
        n = e["name"]
        paths = {
            "pipeline_bert_replay": par2["pipeline_bert"]["launches"].get(
                n, 0),
            "pipeline_bert_pipe1_nccl": par2["pipeline_world1"][
                "launches"].get(n, 0),
            "spark_k1_config3": sp["k1"]["launches"].get(n, 0),
            "spark_k5_config3": sp["k5"]["launches"].get(n, 0),
            "fault_tolerant_config3": ftr["launches"].get(n, 0)}
        e["launches_by_path"].update(paths)
        e["launches"] += sum(paths.values())
    # the flash kernels at the parallel paths' shapes (phase 43)
    for e in entries:
        if e["name"].startswith("flash_attention_"):
            e["parallel_shapes"] = par2["flash_parallel_shapes"]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
