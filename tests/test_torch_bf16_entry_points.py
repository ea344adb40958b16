"""A bf16 net's ``score``, ``rnn_time_step`` and ``GenerationEngine`` carries
against the JAX package: they compute at the reference's precision.

In the JAX package ``score`` passes the params and the input uncast, so a
bf16 net scores in f32; ``rnn_time_step`` casts the params and not x, and
both it and the engine start the carries in f32 (``initial_carry``).
jnp's promotion then runs each mixed f32/bf16 operation in f32 over the
bf16 weights. The port states the same contract (``common.dtypes.widen``):
a recurrent op or a dense product whose operands mix types computes in
the wider one.

Nets: LSTM(32) and GRU(32) char-RNNs over a vocabulary of 11, bf16, weights
carried by ``load_jax_params``; 200 steps at B = 3 and B = 8. The JAX
package runs its XLA lowering at B = 3 and its Pallas kernel (interpret
mode on the CPU) at B = 8. Tolerance 1e-6 absolute against the XLA lowering
(the order of f32 sums only; the gap before the repair was 4.7e-4 to
9e-4). At B = 8 the JAX default is held apart: the Pallas kernel rounds
h_{t-1} to R's bf16 for its product where jnp's promotion keeps it f32,
and in the engine it returns the carries in the input's bf16. The test
measures that spread of the JAX package's own two paths and holds the port
no farther from the Pallas path than the XLA lowering lies from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.env import env as jax_env
from deeplearning4j_tpu.generation.engine import (
    RecurrentDecodeAdapter as JaxAdapter,
)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import GRULayer as JaxGRU
from deeplearning4j_tpu.nn.layers import LSTMLayer as JaxLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.common.dtypes import matmul, widen
from deeplearning4j_tpu_torch.generation.engine import RecurrentDecodeAdapter
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)

V = 11
STEPS = 200
TOL = 1e-6
CELLS = {"lstm": JaxLSTM, "gru": JaxGRU}


@pytest.fixture
def jax_xla():
    """The JAX package on its XLA lowering for the duration of a test."""
    prev = jax_env.disable_pallas
    jax_env.disable_pallas = True
    yield
    jax_env.disable_pallas = prev


def _rnn_conf(cell):
    return (JaxNNC.builder().seed(3).data_type("bf16").list()
            .layer(CELLS[cell](n_out=32))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V, 8)).build())


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf).init(device="cpu")
    return load_jax_params(net, jax.tree_util.tree_map(np.asarray,
                                                       jnet.params))


def _rnn_time_step_run(net, B, out=lambda t: t.float().numpy()):
    """The outputs of 200 single-step ``rnn_time_step`` calls from a
    cleared state (either package's net), as f32 numpy."""
    net.rnn_clear_previous_state()
    rng = np.random.default_rng(0)
    return [np.asarray(out(net.rnn_time_step(
        np.eye(V, dtype=np.float32)[rng.integers(0, V, B)])), np.float32)
        for _ in range(STEPS)]


def _jax_rnn_time_step_run(jnet, B):
    return _rnn_time_step_run(jnet, B, out=lambda a: a)


def _engine_run(adapter, step, B):
    """Decode logits and carries of 200 steps of an engine's adapter from
    its initial state, fed the same tokens, as f32 numpy."""
    c = adapter.init_state(B)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        logits, c = step(c, rng.integers(0, V, B))
        out.append([np.asarray(logits, np.float32)] + [
            np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                       np.float32) for t in c[0]])
    return out


def _jax_engine_run(jnet, B):
    ja = JaxAdapter(jnet)
    assert all(np.asarray(t).dtype == np.float32
               for t in ja.init_state(B)[0])
    fn = jax.jit(lambda p, s, c, t: ja.decode(p, s, c, t, 0))
    return _engine_run(ja, lambda c, tok: fn(jnet.params, jnet.state, c,
                                             jnp.asarray(tok)), B)


def _port_engine_run(net, B):
    pa = RecurrentDecodeAdapter(net)
    assert all(t.dtype == torch.float32 for t in pa.init_state(B)[0])
    return _engine_run(pa, lambda c, tok: pa.decode(c, torch.tensor(tok)), B)


def _gap(a, b):
    """Largest absolute difference of two runs' matching arrays."""
    flat = lambda run: [x for step in run for x in (
        step if isinstance(step, list) else [step])]
    return max(float(np.abs(x - y).max()) for x, y in zip(flat(a), flat(b)))


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("cell", list(CELLS))
def test_rnn_time_step_matches_jax(cell, B, jax_xla):
    """At B = 3 this is also the JAX default path (its scan); at B = 8 the
    fixture keeps the JAX package on its XLA lowering."""
    jnet = JaxNet(_rnn_conf(cell)).init()
    net = _port_of(jnet)
    assert _gap(_rnn_time_step_run(net, B),
                _jax_rnn_time_step_run(jnet, B)) <= TOL
    assert all(c.dtype == torch.float32 for c in net._rnn_carries[0])


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("cell", list(CELLS))
def test_engine_carries_match_jax(cell, B, jax_xla):
    """Decode logits and carries, both engines' adapters from f32 carries."""
    jnet = JaxNet(_rnn_conf(cell)).init()
    assert _gap(_port_engine_run(_port_of(jnet), B),
                _jax_engine_run(jnet, B)) <= TOL


@pytest.mark.parametrize("cell", list(CELLS))
def test_b8_lies_within_the_jax_packages_own_spread(cell):
    """The JAX default at B = 8 (its Pallas kernel) against the port, and
    against the JAX package's XLA lowering on the same weights: the port
    is no farther from it than the XLA lowering is, and matches that."""
    jnet = JaxNet(_rnn_conf(cell)).init()
    net = _port_of(jnet)
    pallas = (_jax_rnn_time_step_run(jnet, 8), _jax_engine_run(jnet, 8))
    port = (_rnn_time_step_run(net, 8), _port_engine_run(net, 8))
    prev = jax_env.disable_pallas
    jax_env.disable_pallas = True
    try:  # traced now, so on the XLA lowering
        jxla = JaxNet(_rnn_conf(cell)).init()
        jxla.params = jnet.params
        xla = (_jax_rnn_time_step_run(jxla, 8), _jax_engine_run(jxla, 8))
    finally:
        jax_env.disable_pallas = prev
    for p, x, r in zip(port, xla, pallas):
        assert _gap(x, r) > 10 * TOL  # the Pallas path ran, and rounds h
        assert _gap(p, x) <= TOL
        assert _gap(p, r) <= _gap(x, r) + TOL


def test_score_of_a_bf16_net_matches_jax():
    """Dense 64-256-256-10 with tanh, B = 32: both packages score in f32
    (the gap before the repair was 1.0e-3)."""
    conf = (JaxNNC.builder().seed(3).data_type("bf16").list()
            .layer(JaxDense(n_out=256, activation="tanh"))
            .layer(JaxDense(n_out=256, activation="tanh"))
            .layer(JaxOutput(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(64)).build())
    jnet = JaxNet(conf).init()
    net = _port_of(jnet)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    assert abs(net.score((x, y)) - float(jnet.score((x, y)))) <= TOL
    # and an f64 input is taken as f32, as jnp.asarray takes it
    assert net.score((x.astype(np.float64), y)) == net.score((x, y))


def test_widen_promotes_as_jnp():
    f, b = torch.ones(2, 3), torch.ones(3, 4, dtype=torch.bfloat16)
    assert [t.dtype for t in widen(f, b, None)[:2]] == [torch.float32] * 2
    assert widen(f, b, None)[2] is None
    same = widen(b, b)
    assert same[0] is b and same[1] is b
    ints = torch.ones(2, dtype=torch.long)
    assert widen(ints, b)[0] is ints
    assert matmul(f, b).dtype == torch.float32
    np.testing.assert_array_equal(
        matmul(f, b).numpy(), np.asarray(jnp.ones((2, 3)) @ jnp.ones(
            (3, 4), jnp.bfloat16)))
