"""The port's GRU path and the rest of the recurrent layer catalog against
the JAX package, on shared numpy inputs.

Layers: GRU, SimpleRnn, LastTimeStep (with a mask), MaskZero,
TimeDistributed and Bidirectional(GRU) in all four modes, each loaded from
the JAX layer's JSON with the JAX params carried across. Then a narrow GRU
char-RNN (GRU 32 x 2, vocabulary 11, RMSProp, clipping 5.0) and a
Bidirectional(GRU) net built from one configuration JSON in both packages:
``output()``, ``rnn_time_step``, three ``fit_batch`` steps, zips written by
one package and restored by the other, the prefill carry and greedy
generation at slots 1 and 8. f32 throughout, TF32 off; tolerance 1e-5
(relative for losses, absolute and relative for activations, params and
updater state): the two packages differ only in the order of their sums.
Batches stay below 8 rows where the JAX registry would otherwise run its
Pallas GRU in interpret mode (slow on the CPU); generation at slots=8 runs
it on purpose, and in f32 the JAX package's two GRU paths agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generation import GenerationEngine as JaxEngine
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    BidirectionalLayer as JaxBidi, ConvolutionLayer as JaxConv,
    DenseLayer as JaxDense, GRULayer as JaxGRU,
    LastTimeStepLayer as JaxLastTimeStep, MaskZeroLayer as JaxMaskZero,
    OutputLayer as JaxOut, RnnOutputLayer as JaxRnnOut,
    SimpleRnnLayer as JaxSimpleRnn, TimeDistributedLayer as JaxTimeDistributed,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu.optimize.updaters import RMSProp as JaxRMSProp
from deeplearning4j_tpu.util.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToRnnPreProcessor
from deeplearning4j_tpu_torch.nn.layers import (
    BidirectionalLayer, GRULayer, LastTimeStepLayer, Layer, MaskZeroLayer,
    SimpleRnnLayer, TimeDistributedLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, extract_carry_rows, load_jax_opt_state,
    load_jax_params, merge_carry_rows,
)

TOL = dict(atol=1e-5, rtol=1e-5)
V = 11
UNITS = 32
PROMPTS = [[1, 2, 3], [4], [9, 0, 5, 5, 2, 7, 1], [3, 3, 8, 6, 10]]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_trees_close(port, ref, **tol):
    """``port`` (tensors) against ``ref`` (arrays), same structure."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_trees_close(port[k], ref[k], **tol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_trees_close(a, b, **tol)
    else:
        np.testing.assert_allclose(port.detach().cpu().numpy(),
                                   np.asarray(ref), **(tol or TOL))


def _jitter(tree, seed, scale=0.3):
    """Move params off their init (zero biases), so every term matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + (rng.normal(size=a.shape) * scale).astype(np.float32),
        tree)


def _port_layer(jl, itype, seed):
    """The JAX layer's port twin (from its JSON), both on the same params."""
    jp, _ = jl.init(jax.random.key(seed), itype)
    jp = _jitter(jp, seed)
    layer = Layer.from_dict(jl.to_dict())
    assert layer.to_dict() == jl.to_dict()
    return jp, layer


def _mask(B, T):
    m = np.ones((B, T), np.float32)
    m[1, T - 2:] = 0
    m[2, 1:] = 0
    return m


# ------------------------------------------------------------------ layers

LAYERS = [
    pytest.param(lambda: JaxGRU(n_out=6), GRULayer, id="gru"),
    pytest.param(lambda: JaxSimpleRnn(n_out=5), SimpleRnnLayer,
                 id="simple_rnn"),
    pytest.param(lambda: JaxSimpleRnn(n_out=5, activation="relu"),
                 SimpleRnnLayer, id="simple_rnn_relu"),
    pytest.param(lambda: JaxMaskZero(underlying=JaxGRU(n_out=6)),
                 MaskZeroLayer, id="mask_zero_gru"),
    pytest.param(lambda: JaxTimeDistributed(
        underlying=JaxDense(n_out=3, activation="tanh")),
        TimeDistributedLayer, id="time_distributed_dense"),
    pytest.param(lambda: JaxLastTimeStep(underlying=JaxGRU(n_out=6)),
                 LastTimeStepLayer, id="last_time_step_gru"),
    pytest.param(lambda: JaxLastTimeStep(), LastTimeStepLayer,
                 id="last_time_step_bare"),
]


@pytest.mark.parametrize("make,cls", LAYERS)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_layer_matches_jax(make, cls, masked):
    """Each layer loaded from the JAX layer's JSON, on the JAX params: the
    same output type, the same activations with and without a padding
    mask (MaskZero computes its own from zero steps in the input)."""
    jl = make()
    B, T, F = 4, 5, 7
    itype = JaxInputType.recurrent(F, T)
    jp, layer = _port_layer(jl, itype, seed=3)
    assert isinstance(layer, cls)
    assert tuple(layer.output_type(InputType.recurrent(F, T)).shape) == tuple(
        jl.output_type(itype).shape)
    x = np.random.default_rng(4).normal(size=(B, T, F)).astype(np.float32)
    x[0, 3:] = 0.0  # zero steps: MaskZero masks them
    m = _mask(B, T) if masked else None
    want, _ = jl.apply(jp, {}, jnp.asarray(x),
                       mask=None if m is None else jnp.asarray(m))
    got, _ = layer.apply(_t_tree(jp), {}, torch.tensor(x),
                         mask=None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # LastTimeStep drops the time mask downstream, the others pass it on
    got_m = layer.feed_forward_mask(m, InputType.recurrent(F, T))
    assert (got_m is None) == (jl.feed_forward_mask(m, itype) is None)


@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_bidirectional_gru_modes_match_jax(mode):
    """Bidirectional(GRU): the JAX package flips x and the outputs; the port
    runs the backward direction with reverse=True. Same function, with and
    without a padding mask."""
    jl = JaxBidi(fwd=JaxGRU(n_out=6), mode=mode)
    itype = JaxInputType.recurrent(4, 5)
    jp, layer = _port_layer(jl, itype, seed=5)
    assert isinstance(layer, BidirectionalLayer) and isinstance(layer.fwd,
                                                                GRULayer)
    assert layer.output_type(InputType.recurrent(4, 5)).shape == tuple(
        jl.output_type(itype).shape)
    x = np.random.default_rng(5).normal(size=(3, 5, 4)).astype(np.float32)
    for m in (None, _mask(3, 5)):
        want, _ = jl.apply(jp, {}, jnp.asarray(x),
                           mask=None if m is None else jnp.asarray(m))
        got, _ = layer.apply(_t_tree(jp), {}, torch.tensor(x),
                             mask=None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cls,jcls,G", [(GRULayer, JaxGRU, 3),
                                        (SimpleRnnLayer, JaxSimpleRnn, 1)],
                         ids=["gru", "simple_rnn"])
def test_init_shapes_and_carry(cls, jcls, G):
    """Param shapes and keys as the JAX layer's; the carry is the one-tuple
    (h,); step() advances it exactly as apply_with_carry does."""
    layer = cls(n_out=6)
    p, _ = layer.init(torch.Generator().manual_seed(0),
                      InputType.recurrent(4, 3), "cpu")
    jp, _ = jcls(n_out=6).init(jax.random.key(0), JaxInputType.recurrent(4, 3))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert p["W"].shape == (4, G * 6) and not bool(p["b"].any())
    carry = layer.initial_carry(2)
    assert isinstance(carry, tuple) and len(carry) == 1
    assert carry[0].shape == (2, 6)
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(1))
    h0 = (torch.randn(2, 6, generator=torch.Generator().manual_seed(2)),)
    ys, want = layer.apply_with_carry(p, x, h0)
    carry = h0
    for t in range(3):
        carry, y = layer.step(p, carry, x[:, t])
        torch.testing.assert_close(y, ys[:, t], atol=1e-6, rtol=1e-6)
    assert len(carry) == 1
    torch.testing.assert_close(carry[0], want[0], atol=1e-6, rtol=1e-6)


def test_cnn_to_rnn_preprocessor_for_the_new_layers():
    """A GRU, SimpleRnn, Bidirectional(GRU) or wrapper after a conv layer
    gets the CnnToRnn preprocessor, as the JAX package adds it."""
    for jl in (JaxGRU(n_out=3), JaxSimpleRnn(n_out=3),
               JaxBidi(fwd=JaxGRU(n_out=3)),
               JaxLastTimeStep(underlying=JaxGRU(n_out=3)),
               JaxMaskZero(underlying=JaxGRU(n_out=3)),
               JaxTimeDistributed(underlying=JaxDense(n_out=3))):
        out = (JaxOut(n_out=2) if isinstance(jl, JaxLastTimeStep)
               else JaxRnnOut(n_out=2))
        jconf = (JaxNNC.builder().list()
                 .layer(JaxConv(n_out=2, kernel=(2, 2)))
                 .layer(jl).layer(out)
                 .set_input_type(JaxInputType.convolutional(5, 4, 1)).build())
        conf = MultiLayerConfiguration.from_json(jconf.to_json())
        assert isinstance(conf.preprocessors.get(1), CnnToRnnPreProcessor)
        assert conf.to_json() == jconf.to_json()


# ------------------------------------------------------ the GRU char-RNN

def _gru_charrnn_conf(bidi=False, seed=7, T=8):
    """GRU 32 x 2 (or Bidirectional(GRU 12) x 2 with Adam) + RnnOutput over
    a vocabulary of 11: TextGenerationLSTM's topology with GRU cells."""
    b = (JaxNNC.builder().seed(seed)
         .updater(JaxAdam(lr=1e-3) if bidi else JaxRMSProp(lr=1e-3))
         .gradient_clipping(5.0).list())
    for _ in range(2):
        b = b.layer(JaxBidi(fwd=JaxGRU(n_out=12)) if bidi
                    else JaxGRU(n_out=UNITS))
    return (b.layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V, T)).build())


def _port_of(jnet):
    """The port's network from the JAX net's configuration JSON, with its
    params, updater state and counters carried across."""
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert conf.to_json() == jnet.conf.to_json()
    net = MultiLayerNetwork(conf).init(device="cpu")
    load_jax_params(net, _np_tree(jnet.params))
    return load_jax_opt_state(net, _np_tree(jnet.opt_state), jnet.step_count,
                              jnet.epoch_count)


def _jax_net(bidi=False, seed=7):
    jnet = JaxNet(_gru_charrnn_conf(bidi, seed)).init()
    jnet.params = _jitter(jnet.params, seed, scale=0.1)
    return jnet


def _batches(n, T=6, B=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (B, T))
        out.append((np.eye(V, dtype=np.float32)[ids],
                    np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]))
    return out


def _one_hot(ids):
    return np.eye(V, dtype=np.float32)[np.asarray(ids)]


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net()
    return jnet, _port_of(jnet)


@pytest.mark.parametrize("bidi", [False, True], ids=["gru", "bidi_gru"])
def test_load_jax_params_carries_gru_weights(bidi):
    """W, RW and b of every GRU layer (nested under fwd/bwd for the
    Bidirectional net) cross unchanged, and output() then agrees."""
    jnet = _jax_net(bidi)
    net = _port_of(jnet)
    _assert_trees_close(net.params, jnet.params, atol=0, rtol=0)
    keys = net.params[0]["fwd"] if bidi else net.params[0]
    assert set(keys) == {"W", "RW", "b"}
    x = _batches(1, T=5, B=3, seed=9)[0][0]
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


def test_rnn_time_step_matches_jax(nets):
    jnet, net = nets
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    rng = np.random.default_rng(1)
    for t in (4, 1, 6):
        x = _one_hot(rng.integers(0, V, (3, t)))
        np.testing.assert_allclose(net.rnn_time_step(x).numpy(),
                                   np.asarray(jnet.rnn_time_step(x)), **TOL)
    single = _one_hot(rng.integers(0, V, (3,)))
    np.testing.assert_allclose(net.rnn_time_step(single).numpy(),
                               np.asarray(jnet.rnn_time_step(single)), **TOL)
    assert all(len(c) == 1 for c in net._rnn_carries.values())
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()


@pytest.mark.parametrize("bidi", [False, True], ids=["gru", "bidi_gru"])
def test_gru_charrnn_trains_like_jax(bidi):
    """Three fit_batch steps (RMSProp, or Adam for the Bidirectional net;
    clipping 5.0) from the same JAX-initialised weights: per-step losses,
    final params and updater state agree."""
    jnet = _jax_net(bidi, seed=11)
    net = _port_of(jnet)
    for x, y in _batches(3, seed=1):
        want = float(jnet.fit_batch((x, y)))
        got = net.fit_batch((x, y))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert net.step_count == jnet.step_count == 3
    _assert_trees_close(net.params, jnet.params)
    _assert_trees_close(net.opt_state, jnet.opt_state)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zip_crosses_packages_mid_training(tmp_path, writer):
    """A GRU net's zip written by either package after two steps restores
    in the other with params, updater state and counters; one more step
    then agrees in both."""
    jnet = _jax_net(seed=13)
    net = _port_of(jnet)
    batches = _batches(3, seed=6)
    for x, y in batches[:2]:
        jnet.fit_batch((x, y))
        net.fit_batch((x, y))
    path = str(tmp_path / "gru.zip")
    if writer == "port":
        net.save(path)
        jnet = jax_restore(path)
    else:
        jnet.save(path)
        net = MultiLayerNetwork.load(path, device="cpu")
    assert isinstance(net.layers[0], GRULayer)
    assert net.step_count == jnet.step_count == 2
    _assert_trees_close(net.params, jnet.params, atol=0, rtol=0)
    _assert_trees_close(net.opt_state, jnet.opt_state, atol=0, rtol=0)
    x, y = batches[2]
    np.testing.assert_allclose(net.fit_batch((x, y)),
                               float(jnet.fit_batch((x, y))), rtol=1e-5)
    _assert_trees_close(net.params, jnet.params)


# ---------------------------------------------------------------- serving

def test_carry_rows_take_one_tuples(nets):
    """extract_carry_rows / merge_carry_rows over GRU carries (h,)."""
    _, net = nets
    carries = net._init_carries(4)
    sub = {i: (torch.full((2, UNITS), float(i + 1)),) for i in carries}
    merged = merge_carry_rows(carries, sub, [1, 3])
    assert all(len(c) == 1 for c in merged.values())
    back = extract_carry_rows(merged, [3, 1])
    for i in carries:
        assert torch.equal(back[i][0], sub[i][0])
        assert not bool(merged[i][0][[0, 2]].any())


@pytest.mark.parametrize("prompt", [p for p in PROMPTS if len(p) > 1],
                         ids=lambda p: f"len{len(p)}")
def test_prefill_carry_matches_jax_gated_scan(nets, prompt):
    """One gru_layer call over the true prompt[:-1] == the JAX engine's
    pow2-padded prefill through a gated scan."""
    jnet, net = nets
    want = JaxEngine(jnet, slots=1, max_len=32)._prefill_state(tuple(prompt))
    got = GenerationEngine(net, slots=1, max_len=32,
                           device="cpu").adapter.prefill(prompt[:-1])
    assert set(got) == set(want)
    for i in want:
        assert len(got[i]) == len(want[i]) == 1
        np.testing.assert_allclose(got[i][0].numpy(), np.asarray(want[i][0]),
                                   **TOL)


@pytest.mark.parametrize("slots", [1, 8])
def test_greedy_generation_matches_jax(nets, slots):
    """Greedy tokens through both GenerationEngines agree; at slots=8 the
    JAX decode step runs its Pallas GRU kernel (interpret mode)."""
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
