"""Port's transformer serving path against the JAX package.

Small causal transformers (D 16-32, 1-2 encoder layers, vocabulary 13-64)
are built from one configuration JSON in both packages and the JAX net's
weights are carried into the port. Held against the JAX package on the
same numpy inputs: ``cached_dot_product_attention`` (f32 and int8, before
and after a ring wrap, 1e-6); ``quantize_cache`` and
``ring_write_quantized`` (int8 values identical, scales within 1e-7,
through a step where a scale grows); ``apply_step`` and ``apply_prefill``
(1e-5, and against the port's own causal ``apply``);
``AttentionDecodeAdapter`` through a ring wrap (2e-5 f32; int8 within the
post-softmax bound of the JAX package's wrap test); greedy engine tokens;
``pow2_buckets`` / ``bucket_for``. Then the port's own contracts: one
decode program under churn, prefill shapes bounded by the buckets, and on
the card (``cuda``) the replayed graph against the eager step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generation import GenerationEngine as JaxEngine
from deeplearning4j_tpu.generation.engine import (
    AttentionDecodeAdapter as JaxAdapter,
)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import EmbeddingSequenceLayer as JaxEmbSeq
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.layers.attention import (
    PositionalEmbeddingLayer as JaxPosEmb,
)
from deeplearning4j_tpu.nn.layers.attention import (
    TransformerEncoderLayer as JaxEncoder,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops.attention import (
    cached_dot_product_attention as jax_cached_attention,
)
from deeplearning4j_tpu.quantize import kvcache as jax_kv
from deeplearning4j_tpu.serving import warmup as jax_warmup
from deeplearning4j_tpu_torch.generation import (
    AttentionDecodeAdapter, GenerationEngine,
)
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import TransformerEncoderLayer
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.quantize import kvcache
from deeplearning4j_tpu_torch.serving import bucket_for, pow2_buckets

V = 13


def _jax_tf_net(D=16, layers=2, heads=2, vocab=V, max_len=32, seed=3,
                pre_norm=True):
    b = (JaxNNC.builder().seed(seed).list()
         .layer(JaxEmbSeq(n_out=D, n_in=vocab))
         .layer(JaxPosEmb(max_len=max_len)))
    for _ in range(layers):
        b = b.layer(JaxEncoder(d_model=D, n_heads=heads, causal=True,
                               pre_norm=pre_norm))
    conf = (b.layer(JaxRnnOut(n_out=vocab, activation="softmax",
                              loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(vocab, 12)).build())
    return JaxNet(conf).init()


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf).init(device="cpu")
    return load_jax_params(net, jax.tree_util.tree_map(np.asarray,
                                                       jnet.params))


@pytest.fixture(scope="module")
def nets():
    """tests/test_generation.py's ``tf_net``: 2 causal layers, D 16."""
    jnet = _jax_tf_net()
    return jnet, _port_of(jnet)


@pytest.fixture(scope="module")
def wrap_nets():
    """tests/test_generation.py's ``TestRingWraparound`` net: 1 layer."""
    jnet = _jax_tf_net(layers=1, max_len=64, seed=11)
    return jnet, _port_of(jnet)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------ the op
@pytest.mark.parametrize("pos", [[3, 5], [9, 21]], ids=["prewrap", "wrapped"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_cached_attention_matches_jax(pos, int8):
    rng = np.random.default_rng(0)
    B, N, L, D = 2, 3, 8, 16
    q = rng.normal(size=(B, N, 1, D)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (B, N, L, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, N, L, D)).astype(np.int8)
        scales = {n: rng.uniform(0.001, 0.02, (B, N)).astype(np.float32)
                  for n in ("k_scale", "v_scale")}
    else:
        k = rng.normal(size=(B, N, L, D)).astype(np.float32)
        v = rng.normal(size=(B, N, L, D)).astype(np.float32)
        scales = {}
    p = np.asarray(pos, np.int32)
    want = jax_cached_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(p),
                                **{n: jnp.asarray(s)
                                   for n, s in scales.items()})
    got = op("cached_dot_product_attention")(
        _t(q), _t(k), _t(v), _t(p, torch.long),
        **{n: _t(s) for n, s in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


# ------------------------------------------------------- the int8 ring
def test_quantize_cache_matches_jax():
    rng = np.random.default_rng(1)
    cache = (rng.normal(size=(2, 3, 8, 16)) *
             rng.uniform(0.1, 5.0, (2, 3, 1, 1))).astype(np.float32)
    wq, ws = jax_kv.quantize_cache(jnp.asarray(cache))
    gq, gs = kvcache.quantize_cache(_t(cache))
    assert gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-7, atol=0)


def test_ring_write_quantized_matches_jax_through_scale_growth():
    """Six writes into an int8 ring; steps 2 and 4 carry vectors 4x and 10x
    larger, so some scales grow and the written rows are requantized."""
    rng = np.random.default_rng(2)
    B, N, L, D = 3, 2, 8, 16
    seed_ring = rng.normal(size=(B, N, L, D)).astype(np.float32)
    jq, js = jax_kv.quantize_cache(jnp.asarray(seed_ring))
    gq, gs = kvcache.quantize_cache(_t(seed_ring))
    rows = np.arange(B)
    grew = False
    for step in range(6):
        mag = {2: 4.0, 4: 10.0}.get(step, 0.5)
        new = (rng.normal(size=(B, N, D)) * mag).astype(np.float32)
        slot = (np.array([3, 7, 10]) + step) % L
        js_before = np.asarray(js)
        jq, js = jax_kv.ring_write_quantized(jq, js, jnp.asarray(new),
                                             jnp.asarray(rows),
                                             jnp.asarray(slot))
        out_q, out_s = kvcache.ring_write_quantized(
            gq, gs, _t(new), _t(rows, torch.long), _t(slot, torch.long))
        assert out_q is gq and out_s is gs          # written in place
        grew |= bool((np.asarray(js) > js_before).any())
        np.testing.assert_array_equal(gq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(gs.numpy(), np.asarray(js), rtol=1e-7,
                                   atol=0)
    assert grew


# ------------------------------------------------------------ the layer
def _layer_pair(pre_norm, D=32, heads=4, seed=4):
    jlayer = JaxEncoder(d_model=D, n_heads=heads, causal=True,
                        pre_norm=pre_norm)
    jp, _ = jlayer.init(jax.random.PRNGKey(seed),
                        JaxInputType.recurrent(D, 8))
    rng = np.random.default_rng(seed)
    # non-trivial biases and norms, so every term of the block matters
    jp = {k: (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
              if k[0] in "bl" else v) for k, v in jp.items()}
    layer = TransformerEncoderLayer(d_model=D, n_heads=heads, causal=True,
                                    pre_norm=pre_norm)
    return jlayer, {k: jnp.asarray(v) for k, v in jp.items()}, layer, \
        {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("pre_norm", [True, False], ids=["pre", "post"])
def test_apply_prefill_matches_jax_and_causal_apply(pre_norm):
    jlayer, jp, layer, p = _layer_pair(pre_norm)
    x = np.random.default_rng(5).normal(size=(2, 7, 32)).astype(np.float32)
    jy, (jk, jv) = jlayer.apply_prefill(jp, jnp.asarray(x))
    y, (k, v) = layer.apply_prefill(p, _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    full, _ = layer.apply(p, {}, _t(x))
    np.testing.assert_allclose(y.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("pre_norm", [True, False], ids=["pre", "post"])
def test_apply_step_matches_jax(pre_norm, kv_dtype):
    """Five steps past a prefilled ring of 8 (wrapping at step 2), in both
    packages from the same ring; y and every ring tensor agree."""
    jlayer, jp, layer, p = _layer_pair(pre_norm)
    rng = np.random.default_rng(6)
    B, L = 2, 8
    ring = [rng.normal(size=(B, 4, L, 8)).astype(np.float32)
            for _ in range(2)]
    if kv_dtype == "int8":
        jc = [jax_kv.quantize_cache(jnp.asarray(r)) for r in ring]
        jcache = (jc[0][0], jc[1][0], jc[0][1], jc[1][1])
        gc = [kvcache.quantize_cache(_t(r)) for r in ring]
        cache = (gc[0][0], gc[1][0], gc[0][1], gc[1][1])
    else:
        jcache = tuple(jnp.asarray(r) for r in ring)
        cache = tuple(_t(r) for r in ring)
    for step in range(5):
        x = rng.normal(size=(B, 32)).astype(np.float32)
        pos = np.array([6, 5]) + step
        jy, jcache = jlayer.apply_step(jp, jnp.asarray(x), jcache,
                                       jnp.asarray(pos, jnp.int32))
        y, cache = layer.apply_step(p, _t(x), cache, _t(pos, torch.long))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
        for a, b in zip(cache, jcache):
            if a.dtype == torch.int8:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-6)


def test_apply_step_equals_causal_apply_over_the_prefix():
    """The port against itself: prefill 3 positions, then 4 steps; each
    step's y equals the causal ``apply``'s row over the whole prefix."""
    _, _, layer, p = _layer_pair(True)
    x = torch.as_tensor(np.random.default_rng(7).normal(
        size=(2, 7, 32)).astype(np.float32))
    full, _ = layer.apply(p, {}, x)
    _, (k, v) = layer.apply_prefill(p, x[:, :3])
    ck, cv = layer.init_cache(2, 16)
    ck[:, :, :3], cv[:, :, :3] = k, v
    cache = (ck, cv)
    for t in range(3, 7):
        y, cache = layer.apply_step(p, x[:, t], cache,
                                    torch.full((2,), t, dtype=torch.long))
        assert cache[0] is ck                 # the ring is written in place
        np.testing.assert_allclose(y.numpy(), full[:, t].numpy(), atol=1e-5)


def test_init_cache_shapes_and_kv_dtype():
    layer = TransformerEncoderLayer(d_model=32, n_heads=4, causal=True)
    k, v = layer.init_cache(3, 10, dtype=torch.bfloat16)
    assert k.shape == (3, 4, 10, 8) and v.dtype == torch.bfloat16
    k, v, ks, vs = layer.init_cache(3, 10, kv_dtype="int8")
    assert k.dtype == torch.int8 and ks.shape == (3, 4)
    assert ks.dtype == torch.float32
    with pytest.raises(ValueError, match="kv_dtype"):
        layer.init_cache(3, 10, kv_dtype="int4")


# ---------------------------------------------------------- the adapter
RING = 8


def _adapter_run(ad, net, tokens, steps, port):
    """Prefill 4 positions of ``tokens`` [B, 4 + steps], then decode
    ``steps`` steps teacher-forced; the logits of each step."""
    B = tokens.shape[0]
    out = []
    if port:
        caches = ad.prefill(torch.as_tensor(tokens[:, :4]), None)
        for t in range(3, 3 + steps):
            logits, caches = ad.decode(
                caches, torch.as_tensor(tokens[:, t]),
                torch.full((B,), t, dtype=torch.long))
            out.append(logits.numpy())
        return out
    caches = ad.prefill(net.params, net.state, jnp.asarray(tokens[:, :4]),
                        None)
    dec = jax.jit(ad.decode)
    for t in range(3, 3 + steps):
        logits, caches = dec(net.params, net.state, caches,
                             jnp.asarray(tokens[:, t]),
                             jnp.full((B,), t, jnp.int32))
        out.append(np.asarray(logits))
    return out


def _softmax(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_adapter_f32_matches_jax_through_wrap(wrap_nets):
    jnet, net = wrap_nets
    tokens = np.random.default_rng(20).integers(0, V, (2, 22))
    want = _adapter_run(JaxAdapter(jnet, RING), jnet, tokens, 18, False)
    got = _adapter_run(AttentionDecodeAdapter(net, RING), net, tokens, 18,
                       True)
    for t, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=2e-5,
                                   err_msg=f"abs pos {3 + t}")


def test_adapter_int8_tracks_jax_and_f32_through_wrap(wrap_nets):
    """The int8 ring against the JAX package's int8 ring and against the
    port's own f32 ring: the post-softmax bound (1e-2) and the wrapped
    steps' top-1 agreement (0.9) of the JAX package's wrap test."""
    jnet, net = wrap_nets
    tokens = np.random.default_rng(21).integers(0, V, (2, 22))
    jq = _adapter_run(JaxAdapter(jnet, RING, kv_dtype="int8"), jnet, tokens,
                      18, False)
    gq = _adapter_run(AttentionDecodeAdapter(net, RING, kv_dtype="int8"),
                      net, tokens, 18, True)
    gf = _adapter_run(AttentionDecodeAdapter(net, RING), net, tokens, 18,
                      True)
    for ref in (jq, gf):
        worst = max(float(np.abs(_softmax(a) - _softmax(b)).max())
                    for a, b in zip(gq, ref))
        assert worst <= 1e-2
        agree = np.mean([(a.argmax(-1) == b.argmax(-1)).mean()
                         for a, b in zip(gq[RING:], ref[RING:])])
        assert agree >= 0.9


def test_adapter_prefill_past_the_ring_matches_sequential_decode(wrap_nets):
    """A prompt longer than the ring (the resume-past-a-wrap case) seeds
    the ring a sequential decode would leave: the next step's logits
    agree, f32 and int8, against JAX's wrapped gather too."""
    jnet, net = wrap_nets
    tokens = np.random.default_rng(22).integers(0, V, (1, 16))
    n = 13                                       # prompt positions 0..12
    padded = np.zeros((1, 16), np.int64)
    padded[0, :n] = tokens[0, :n]
    for kv in (None, "int8"):
        ad = AttentionDecodeAdapter(net, RING, kv_dtype=kv)
        jad = JaxAdapter(jnet, RING, kv_dtype=kv)
        caches = ad.prefill(torch.as_tensor(padded), n)
        jcaches = jad.prefill(jnet.params, jnet.state, jnp.asarray(padded),
                              jnp.int32(n))
        for i in caches:
            for a, b in zip(caches[i], jcaches[i]):
                np.testing.assert_allclose(a.numpy().astype(np.float32),
                                           np.asarray(b, np.float32),
                                           atol=1e-5)
        pos = torch.full((1,), n, dtype=torch.long)
        logits, _ = ad.decode(caches, torch.as_tensor(tokens[:, n]), pos)
        seq = ad.prefill(torch.as_tensor(tokens[:, :4]), None)
        for t in range(3, n + 1):
            ref, seq = ad.decode(seq, torch.as_tensor(tokens[:, t]),
                                 torch.full((1,), t, dtype=torch.long))
        tol = 1e-5 if kv is None else 5e-2
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=tol)


def test_adapter_checks_match_jax(nets):
    jnet, net = nets
    with pytest.raises(ValueError, match="exceeds positional table"):
        AttentionDecodeAdapter(net, 64)
    with pytest.raises(ValueError, match="kv_dtype"):
        AttentionDecodeAdapter(net, 16, kv_dtype="fp8")
    noncausal = _jax_tf_net(layers=1)
    conf = MultiLayerConfiguration.from_json(
        noncausal.conf.to_json().replace('"causal": true',
                                         '"causal": false'))
    plain = MultiLayerNetwork(conf).init(device="cpu")
    with pytest.raises(ValueError, match="not causal"):
        AttentionDecodeAdapter(plain, 16)
    with pytest.raises(ValueError, match="not both"):
        GenerationEngine(net, max_len=16, kv_dtype="int8", device="cpu",
                         adapter=AttentionDecodeAdapter(net, 16))


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("slots", [1, 2])
def test_engine_greedy_tokens_match_jax(nets, slots):
    jnet, net = nets
    prompts = [[1, 2, 3, 4], [5], [7, 7, 0, 12, 3, 9, 1, 2, 11]]
    jeng = JaxEngine(jnet, slots=slots, max_len=32)
    eng = GenerationEngine(net, slots=slots, max_len=32, device="cpu")
    want = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    got = [eng.submit(p, max_new_tokens=8) for p in prompts]
    jeng.drain()
    eng.drain()
    assert [s.tokens for s in got] == [s.tokens for s in want]
    assert all(s.finish_reason == "length" for s in got)


def test_engine_matches_full_recompute(nets):
    """Greedy tokens equal the argmax of the port's own full causal
    ``output()`` over the growing sequence."""
    _, net = nets
    eng = GenerationEngine(net, slots=2, max_len=32, device="cpu")
    got = eng.generate([1, 2, 3, 4], max_new_tokens=6)
    seq = [1, 2, 3, 4]
    for tok in got:
        out = net.output(np.asarray([seq]))
        assert int(out[0, -1].argmax()) == tok
        seq.append(tok)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_one_decode_program_under_churn(nets, kv_dtype):
    """24 mixed-length streams churn through 8 slots: one decode program,
    prefill shapes bounded by the pow2 buckets, every stream to length."""
    _, net = nets
    eng = GenerationEngine(net, slots=8, max_len=32, kv_dtype=kv_dtype,
                           device="cpu")
    rng = np.random.default_rng(0)
    lens, news = rng.integers(1, 20, 24), rng.integers(3, 12, 24)
    streams = [eng.submit(rng.integers(0, V, int(l)).tolist(),
                          max_new_tokens=int(n), temperature=0.9, top_k=5,
                          seed=i)
               for i, (l, n) in enumerate(zip(lens, news))]
    state = eng.pool.state
    peak = 0
    while eng.has_work():
        eng.step()
        peak = max(peak, eng.pool.occupancy())
    assert peak == 8
    assert eng.pool.state is state             # never rebound
    assert all(s.finish_reason == "length" for s in streams)
    assert eng.decode_programs == 1
    assert eng.prefill_programs <= len(eng.buckets)
    assert eng.replays == 0 and eng.captures == 0   # the CPU runs eagerly


def test_prompt_validation_matches_jax(nets):
    _, net = nets
    eng = GenerationEngine(net, slots=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(list(range(10)), max_new_tokens=7)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])


def test_int8_engine_tokens_are_sampled_from_int8_logits(nets):
    """The int8 engine runs to completion and greedy streams stay close to
    the f32 engine's: the same first token for most prompts."""
    _, net = nets
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, int(l)).tolist() for l in (5, 9, 12, 3)]
    runs = {}
    for kv in (None, "int8"):
        eng = GenerationEngine(net, slots=4, max_len=32, kv_dtype=kv,
                               device="cpu")
        streams = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.drain()
        assert all(len(s.tokens) == 6 for s in streams)
        runs[kv] = [s.tokens[0] for s in streams]
    assert np.mean(np.array(runs[None]) == np.array(runs["int8"])) >= 0.75


# ----------------------------------------------------------- the buckets
def test_buckets_match_jax():
    for n in range(1, 601):
        want = jax_warmup.pow2_buckets(n)
        assert pow2_buckets(n) == want
        for m in (1, n // 3 + 1, n, n + 1):
            assert bucket_for(m, pow2_buckets(n)) == \
                jax_warmup.bucket_for(m, want)
    with pytest.raises(ValueError):
        pow2_buckets(0)


def test_warmup_model_runs_each_bucket(nets):
    from deeplearning4j_tpu_torch.serving import warmup_model

    _, net = nets
    t = warmup_model(net, (6,), (1, 2, 4, 2), dtype=np.int64)
    assert sorted(t) == [1, 2, 4] and all(s >= 0 for s in t.values())


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


def _card_copy(net, device, dtype=None):
    conf = MultiLayerConfiguration.from_json(net.conf.to_json())
    if dtype:
        conf.dtype = dtype
    card = MultiLayerNetwork(conf).init(device=device)
    return load_jax_params(card, [{k: a.numpy() for k, a in p.items()}
                                  for p in net.params])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_replay_matches_eager_on_card(nets, cuda_device, kv_dtype):
    """A CUDA engine replays one captured graph; its greedy tokens equal
    the CPU engine's, and a replayed step's logits equal the eager
    ``adapter.decode`` from the same state."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, net = nets
        card = _card_copy(net, cuda_device)
        prompts = [[1, 2, 3, 4], [5], [7, 7, 0, 12, 3, 9, 1, 2, 11]]
        engs = [GenerationEngine(m, slots=2, max_len=32, kv_dtype=kv_dtype,
                                 device=d)
                for m, d in ((net, "cpu"), (card, cuda_device))]
        runs = []
        for eng in engs:
            streams = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.drain()
            runs.append([s.tokens for s in streams])
        assert runs[0] == runs[1]
        eng = engs[1]
        assert eng.decode_programs == 1 and eng.captures == 1
        assert eng.replays == eng.steps_run
        for p in prompts[:2]:
            eng.submit(p, max_new_tokens=20)
        eng.step()
        cache = {i: tuple(t.clone() for t in c)
                 for i, c in eng.pool.state.items()}
        eager, _ = eng.adapter.decode(cache, eng._inputs[0], eng._inputs[1])
        replay = eng.decode_pool()
        torch.testing.assert_close(replay, eager, atol=1e-5, rtol=1e-5)
        for i, c in cache.items():            # the same rings written
            for a, b in zip(eng.pool.state[i], c):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        eng.drain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_bucketed_prefill_runs_the_flash_kernel_on_card(nets, cuda_device):
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_FWD

    _, net = nets
    card = _card_copy(net, cuda_device, dtype="bf16")
    eng = GenerationEngine(card, slots=2, max_len=32, device=cuda_device)
    n = FLASH_FWD.launches
    streams = [eng.submit(p, max_new_tokens=4)
               for p in ([1, 2, 3, 4, 5], [6, 7], [8])]
    eng.drain()
    torch.cuda.synchronize()
    # two encoder layers, one flash forward each, for each prompt > 1 token
    assert FLASH_FWD.launches - n == 2 * 2
    assert all(len(s.tokens) == 4 for s in streams)
    assert eng.prefill_programs == 2 and eng.decode_programs == 1
