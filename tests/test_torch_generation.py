"""Port's char-LSTM serving path against the JAX package.

A small char-LSTM is built from one configuration JSON in both packages and
the JAX net's weights are carried into the port. Then: rnn_time_step
outputs agree at 1e-5; the port's prefill carry (one lstm_layer call over
the true prompt) equals the JAX engine's padded, gated-scan prefill carry;
greedy generation gives identical tokens at slots 1 and 8 (slots=8 sends
the JAX decode through its Pallas kernel, in interpret mode); sampled
streams in the port are a function of (seed, position) only. The rest are
the port's own engine, sampler and slot-pool contracts, on the CPU.
"""

import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generation import GenerationEngine as JaxEngine
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import GravesLSTMLayer as JaxGraves
from deeplearning4j_tpu.nn.layers import LSTMLayer as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.generation import (
    CharCodec, GenerationEngine, SlotPool, row_seed, sample_logits, sample_row,
)
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, extract_carry_rows, load_jax_params, merge_carry_rows,
)

V = 10
UNITS = 12
PROMPTS = [[1, 2, 3], [4], [9, 0, 5, 5, 2, 7, 1], [3, 3, 8, 6, 2]]


def _jax_net(layers=2, graves=False, seed=5):
    lstm = JaxGraves if graves else JaxLSTM
    b = JaxNNC.builder().seed(seed).list()
    for _ in range(layers):
        b = b.layer(lstm(n_out=UNITS))
    conf = (b.layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V, 8)).build())
    return JaxNet(conf).init()


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf).init(device="cpu")
    return load_jax_params(
        net, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params])


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net()
    return jnet, _port_of(jnet)


def _one_hot(ids):
    return np.eye(V, dtype=np.float32)[np.asarray(ids)]


@pytest.mark.parametrize("graves", [False, True], ids=["lstm", "graves"])
def test_rnn_time_step_matches_jax(graves):
    jnet = _jax_net(graves=graves, seed=11)
    if graves:  # peepholes init to zero: give them values so they matter
        rng = np.random.default_rng(0)
        for p in jnet.params[:2]:
            p["pW"] = p["pW"] + rng.normal(size=p["pW"].shape).astype(np.float32) * 0.3
    net = _port_of(jnet)
    rng = np.random.default_rng(1)
    chunks = [_one_hot(rng.integers(0, V, (3, t))) for t in (4, 1, 6)]
    for x in chunks:
        want = np.asarray(jnet.rnn_time_step(x))
        got = net.rnn_time_step(x).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    single = _one_hot(rng.integers(0, V, (3,)))
    np.testing.assert_allclose(net.rnn_time_step(single).numpy(),
                               np.asarray(jnet.rnn_time_step(single)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(net.output(chunks[0]).numpy(),
                               np.asarray(jnet.output(chunks[0])),
                               atol=1e-5, rtol=1e-5)


def test_layer_step_matches_sequence(nets):
    """LSTMLayer.step (one timestep from a carry) == apply_with_carry."""
    _, net = nets
    layer, params = net.layers[0], net.params[0]
    x = torch.as_tensor(_one_hot([[3, 1, 4]]))
    carry = layer.initial_carry(1)
    ys, want = layer.apply_with_carry(params, x, carry)
    for t in range(3):
        carry, y = layer.step(params, carry, x[:, t])
        torch.testing.assert_close(y, ys[:, t], atol=1e-6, rtol=1e-6)
    for a, b in zip(carry, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_rnn_time_step_rejects_batch_change(nets):
    _, net = nets
    net.rnn_clear_previous_state()
    net.rnn_time_step(_one_hot([[1, 2]]))
    with pytest.raises(ValueError, match="batch size changed"):
        net.rnn_time_step(_one_hot([[1], [2]]))
    net.rnn_clear_previous_state()


@pytest.mark.parametrize("prompt", [p for p in PROMPTS if len(p) > 1],
                         ids=lambda p: f"len{len(p)}")
def test_prefill_carry_matches_jax_gated_scan(nets, prompt):
    """One lstm_layer call over the true prompt[:-1] == the JAX engine's
    pow2-padded prefill through a gated scan."""
    jnet, net = nets
    jeng = JaxEngine(jnet, slots=1, max_len=32)
    peng = GenerationEngine(net, slots=1, max_len=32, device="cpu")
    want = jeng._prefill_state(tuple(prompt))
    got = peng.adapter.prefill(prompt[:-1])
    assert set(got) == set(want)
    for i in want:
        for a, b in zip(got[i], want[i]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("slots", [1, 8])
def test_greedy_generation_matches_jax(nets, slots):
    jnet, net = nets
    jeng = JaxEngine(jnet, slots=slots, max_len=32)
    peng = GenerationEngine(net, slots=slots, max_len=32, device="cpu")
    news = [6, 3, 9, 5]
    js = [jeng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, news)]
    ps = [peng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, news)]
    jeng.drain()
    peng.drain()
    for j, p, n in zip(js, ps, news):
        assert p.tokens == j.tokens and len(p.tokens) == n
        assert p.finish_reason == j.finish_reason == "length"


def test_sampled_stream_independent_of_slot_mix(nets):
    """The same sampled request gives the same tokens alone and among
    others, in any slot: a token depends on (seed, position, logits)."""
    _, net = nets
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=5, seed=42)
    alone = GenerationEngine(net, slots=1, max_len=32, device="cpu").generate(
        [2, 4, 6], **kw)
    eng = GenerationEngine(net, slots=4, max_len=32, device="cpu")
    others = [eng.submit(p, max_new_tokens=5, temperature=1.0, seed=i)
              for i, p in enumerate(PROMPTS[:2])]
    mixed = eng.submit([2, 4, 6], **kw)
    eng.drain()
    assert mixed.tokens == alone
    assert all(len(s.tokens) == 5 for s in others)
    other_seed = GenerationEngine(net, slots=1, max_len=32, device="cpu")
    assert other_seed.generate([2, 4, 6], **dict(kw, seed=43)) != alone


def test_static_and_continuous_agree_on_greedy(nets):
    _, net = nets
    out = {}
    for continuous in (True, False):
        eng = GenerationEngine(net, slots=2, max_len=32, device="cpu",
                               continuous=continuous)
        streams = [eng.submit(p, max_new_tokens=n)
                   for p, n in zip(PROMPTS, (2, 8, 2, 8))]
        steps = eng.drain()
        out[continuous] = ([s.tokens for s in streams], steps)
    assert out[True][0] == out[False][0]
    assert out[True][1] < out[False][1]  # continuous refills freed slots


def test_eos_retires_without_emitting(nets):
    jnet, net = nets
    first = GenerationEngine(net, slots=1, max_len=32, device="cpu").generate(
        PROMPTS[0], max_new_tokens=4)
    eng = GenerationEngine(net, slots=1, max_len=32, device="cpu",
                           eos_id=first[0])
    s = eng.submit(PROMPTS[0], max_new_tokens=4)
    eng.drain()
    assert s.tokens == [] and s.finish_reason == "eos"


def test_batch_lane_waits_for_interactive(nets):
    _, net = nets
    eng = GenerationEngine(net, slots=1, max_len=32, device="cpu")
    lo = eng.submit([1, 2], max_new_tokens=2, klass="batch")
    hi = eng.submit([3, 4], max_new_tokens=2)
    eng.step()
    assert eng.pool.meta[0] is hi and eng.pending_count() == 1
    eng.drain()
    assert hi.finished_at <= lo.finished_at and len(lo.tokens) == 2


def test_cancel_and_shutdown(nets):
    _, net = nets
    eng = GenerationEngine(net, slots=1, max_len=32, device="cpu")
    a = eng.submit([1, 2], max_new_tokens=50)
    b = eng.submit([3], max_new_tokens=50)
    eng.step()
    a.cancel()
    eng.step()
    assert a.finish_reason == "cancelled"
    eng.shutdown(timeout=0.0)
    assert b.done and not eng.has_work()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1], max_new_tokens=1)


def test_background_loop_serves_streams(nets):
    _, net = nets
    eng = GenerationEngine(net, slots=2, max_len=32, device="cpu").start()
    try:
        streams = [eng.submit(p, max_new_tokens=3) for p in PROMPTS]
        got = [list(s) for s in streams]
        assert all(len(t) == 3 for t in got)
        assert all(s.wait(timeout=10) for s in streams)
    finally:
        eng.shutdown(timeout=5.0)
    assert eng._thread is None


def test_submit_validation_and_codec(nets):
    _, net = nets
    codec = CharCodec(list("abcdefghij"))
    eng = GenerationEngine(net, slots=1, max_len=4, device="cpu", codec=codec)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit([1] * 5)
    toks = eng.generate("abc", max_new_tokens=3)
    assert len(codec.decode(toks)) == 3
    with pytest.raises(ValueError, match="codec"):
        GenerationEngine(net, slots=1, device="cpu").submit("abc")


def test_engine_requires_net_on_its_device():
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="net lives on"):
        GenerationEngine(elsewhere, slots=1, device="cpu")


class TestSampler:
    def test_greedy_is_argmax(self):
        logits = torch.as_tensor(np.random.default_rng(0).normal(size=(4, V)),
                                 dtype=torch.float32)
        z = np.zeros(4)
        out = sample_logits(logits, seeds=np.arange(4), pos=np.arange(4),
                            temperature=z, top_k=z, top_p=np.ones(4))
        assert out.tolist() == logits.argmax(-1).tolist()

    def test_row_seed_is_pure_and_spreads(self):
        assert row_seed(5, 2) == row_seed(5, 2)
        seeds = {row_seed(s, p) for s in range(8) for p in range(8)}
        assert len(seeds) == 64 and all(0 <= s < 2 ** 63 for s in seeds)

    def test_top_k_support_bound(self):
        logits = torch.as_tensor(np.random.default_rng(2).normal(size=V),
                                 dtype=torch.float32)
        topk = set(torch.topk(logits, 3).indices.tolist())
        for i in range(40):
            assert sample_row(logits, seed=i, pos=i, temperature=1.5,
                              top_k=3, top_p=1.0) in topk

    def test_batch_equals_rows_alone(self):
        """A row's token does not depend on the rows batched with it."""
        rng = np.random.default_rng(4)
        logits = torch.as_tensor(rng.normal(size=(6, V)) * 2,
                                 dtype=torch.float32)
        knobs = dict(seeds=np.arange(6) + 3, pos=np.arange(6) * 7,
                     temperature=np.array([0.0, 0.8, 1.0, 1.5, 0.0, 0.7]),
                     top_k=np.array([0, 3, 0, 5, 2, 0]),
                     top_p=np.array([1.0, 1.0, 0.6, 0.9, 1.0, 1.0]))
        every = sample_logits(logits, **knobs)
        alone = [sample_row(logits[r], seed=int(knobs["seeds"][r]),
                            pos=int(knobs["pos"][r]),
                            temperature=float(knobs["temperature"][r]),
                            top_k=int(knobs["top_k"][r]),
                            top_p=float(knobs["top_p"][r])) for r in range(6)]
        assert every.tolist() == alone
        some = sample_logits(logits, rows=[5, 1], **knobs)
        assert some.tolist() == [0, alone[1], 0, 0, 0, alone[5]]

    def test_sampled_frequencies_follow_softmax(self):
        """Over 4,000 positions the draws follow softmax(logits / T): each
        frequency within 0.03 (about four standard deviations)."""
        n, row = 4000, torch.tensor([1.0, 0.0, -0.5, 2.0])
        out = sample_logits(row.expand(n, 4), seeds=np.full(n, 9),
                            pos=np.arange(n), temperature=np.full(n, 1.3),
                            top_k=np.zeros(n), top_p=np.ones(n))
        freq = np.bincount(out, minlength=4) / n
        np.testing.assert_allclose(freq, torch.softmax(row / 1.3, 0).numpy(),
                                   atol=0.03)

    def test_top_p_nucleus_mass_bound(self):
        logits = torch.as_tensor(np.random.default_rng(3).normal(size=V) * 2,
                                 dtype=torch.float32)
        probs = torch.softmax(logits, -1)
        order = torch.argsort(probs, descending=True)
        csum = torch.cumsum(probs[order], 0)
        n = int(((csum - probs[order]) < 0.7).sum())
        nucleus = set(order[:n].tolist())
        for i in range(60):
            assert sample_row(logits, seed=7, pos=i, temperature=1.0,
                              top_k=0, top_p=0.7) in nucleus


class TestSlots:
    def test_admit_overwrites_whole_row(self, nets):
        _, net = nets
        pool = SlotPool(3, net._init_carries)
        dirty = {i: tuple(torch.full_like(a[:1], 7.0) for a in c)
                 for i, c in pool.state.items()}
        pool.admit(1, dirty, token=2, pos=3, seed=1, temperature=0.0,
                   top_k=0, top_p=1.0, meta="a")
        pool.retire(1)
        fresh = {i: tuple(torch.zeros_like(a[:1]) for a in c)
                 for i, c in pool.state.items()}
        pool.admit(1, fresh, token=5, pos=0, seed=2, temperature=0.0,
                   top_k=0, top_p=1.0, meta="b")
        row = extract_carry_rows(pool.state, 1)
        assert all(float(a.abs().max()) == 0.0 for c in row.values() for a in c)
        assert pool.active_slots() == [1] and pool.free_slots() == [0, 2]
        with pytest.raises(ValueError, match="occupied"):
            pool.admit(1, fresh, token=0, pos=0, seed=0, temperature=0.0,
                       top_k=0, top_p=1.0)

    def test_carry_rows_roundtrip(self, nets):
        _, net = nets
        carries = {0: (torch.arange(12.0).reshape(4, 3),
                       -torch.arange(12.0).reshape(4, 3))}
        sub = extract_carry_rows(carries, [2, 0])
        assert sub[0][0].tolist() == [[6.0, 7.0, 8.0], [0.0, 1.0, 2.0]]
        merged = merge_carry_rows(carries, {0: (sub[0][0] + 100, sub[0][1])},
                                  [2, 0])
        assert merged[0][0][2].tolist() == [106.0, 107.0, 108.0]
        assert carries[0][0][2].tolist() == [6.0, 7.0, 8.0]  # not mutated
