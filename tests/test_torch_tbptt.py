"""Truncated BPTT, the carry-row API, ``feed_forward`` and ``params_table``
of the port against the JAX package.

A network with ``tbptt_fwd_length`` L trains a longer sequence in chunks of
L (the last one partial), each chunk a step from the carries the chunk
before left, detached. Every chunk of one ``fit_batch`` steps at the same
``step_count`` (the JAX package increments it once, after the loop), so
Adam's and RMSProp's bias terms see one step a call; the score is the mean
of the chunk losses. The same inputs and weights go through both packages:
params, updater state, ``step_count`` and scores after N calls agree
within 1e-5 (f32). B = 3 keeps the JAX recurrent ops off their Pallas
paths on the CPU. A Bidirectional layer has no carry (no
``apply_with_carry``), so under tBPTT its chunks start from zero, in both
packages. The LSTM and GRU autograd functions return no gradient for a
carry that needs none (the detached chunk carries).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import (
    InputType as JaxInputType, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.layers import (
    GRULayer as JaxGRU,
    GravesBidirectionalLSTMLayer as JaxGravesBidi, GravesLSTMLayer as JaxGraves,
    LSTMLayer as JaxLSTM, RnnOutputLayer as JaxRnnOut,
    SimpleRnnLayer as JaxSimpleRnn,
)
from deeplearning4j_tpu.optimize import Adam as JaxAdam, RMSProp as JaxRMSProp
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.ops.cuda.fused_gru import FusedGRUFunction
from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import FusedLSTMFunction
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, **tol):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _close(port[k], ref[k], **tol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b, **tol)
    else:
        np.testing.assert_allclose(port.detach().cpu().numpy(),
                                   np.asarray(ref), **(tol or TOL))


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert conf.to_json() == jnet.conf.to_json()
    net = MultiLayerNetwork(conf).init(device="cpu")
    load_jax_params(net, _np(jnet.params), _np(jnet.state))
    return load_jax_opt_state(net, _np(jnet.opt_state), jnet.step_count)


CELLS = {"lstm": lambda: JaxLSTM(n_out=6), "graves": lambda: JaxGraves(n_out=6),
         "gru": lambda: JaxGRU(n_out=6), "rnn": lambda: JaxSimpleRnn(n_out=6),
         "bidi": lambda: JaxGravesBidi(n_out=4)}


def _jax_net(cells, tbptt, nin=4, nout=3, updater=None, seed=5, dropout=0.0):
    b = (JaxNNC.builder().seed(seed)
         .updater(updater or JaxAdam(lr=5e-2)).gradient_clipping(5.0).list())
    for c in cells:
        b = b.layer(CELLS[c]())
    b = b.layer(JaxRnnOut(n_out=nout, activation="softmax", loss="mcxent",
                          dropout=dropout))
    if tbptt:
        b = b.backprop_type_tbptt(tbptt)
    return JaxNet(b.set_input_type(JaxInputType.recurrent(nin)).build()).init()


def _seq(seed, B=3, T=10, nin=4, nout=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, nin)).astype(np.float32)
    y = np.eye(nout, dtype=np.float32)[rng.integers(0, nout, (B, T))]
    return x, y


CASES = [
    pytest.param(["lstm", "lstm"], 4, None, id="lstm2-partial-chunk"),
    pytest.param(["graves"], 5, None, id="graves-even-chunks"),
    pytest.param(["gru"], 3, JaxRMSProp(lr=1e-2), id="gru-rmsprop"),
    pytest.param(["rnn"], 4, None, id="simple-rnn"),
    pytest.param(["bidi", "lstm"], 4, None, id="bidi-then-lstm"),
]


@pytest.mark.parametrize("cells,L,updater", CASES)
def test_tbptt_trains_like_jax(cells, L, updater):
    jn = _jax_net(cells, L, updater=updater)
    net = _port_of(jn)
    for seed in range(3):
        x, y = _seq(seed)
        lj, lp = jn.fit_batch((x, y)), net.fit_batch((x, y))
        np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    assert net.step_count == jn.step_count == 3
    _close(net.params, _np(jn.params))
    _close(net.opt_state, _np(jn.opt_state))
    # after training, streaming inference from a fresh carry agrees
    x, _ = _seq(9, T=7)
    np.testing.assert_allclose(net.rnn_time_step(x[:, :4]).numpy(),
                               np.asarray(jn.rnn_time_step(x[:, :4])), **TOL)
    np.testing.assert_allclose(net.rnn_time_step(x[:, 4]).numpy(),
                               np.asarray(jn.rnn_time_step(x[:, 4])), **TOL)


def test_tbptt_score_is_the_mean_of_the_chunk_losses():
    """Chunk by chunk by hand on a copy: each chunk a step from the carry
    the last left, at one step index; the call's score is their mean."""
    jn = _jax_net(["lstm"], 4, updater=JaxAdam(lr=5e-2))
    net, ref = _port_of(jn), _port_of(jn)
    x, y = _seq(3)
    got = float(net.fit_batch((x, y)))
    carries = ref._init_carries(3)
    losses = []
    for s in (0, 4, 8):
        loss, carries = ref._train_step(
            ref._input(x[:, s:s + 4]), ref._labels(y[:, s:s + 4]), None,
            None, carries)
        losses.append(float(loss))
        assert ref.step_count == 0          # the same step for every chunk
    assert got == pytest.approx(sum(losses) / 3, rel=1e-6)
    _close(net.params, [{k: v.numpy() for k, v in p.items()}
                        for p in ref.params], atol=0, rtol=0)


def test_tbptt_masks_like_jax():
    """A features mask (padding) and a distinct labels mask, sliced per
    chunk in both packages."""
    jn = _jax_net(["lstm"], 4)
    net = _port_of(jn)
    x, y = _seq(4)
    fm = np.ones((3, 10), np.float32)
    fm[1, 7:] = 0
    fm[2, 3:] = 0
    lm = fm * (np.arange(10) % 2 == 0)
    for batch in ((x, y, fm), (x, y, fm, lm)):
        np.testing.assert_allclose(float(net.fit_batch(batch)),
                                   float(jn.fit_batch(batch)), rtol=1e-5)
    _close(net.params, _np(jn.params))


def test_tbptt_with_dropout_draws_per_chunk():
    """Dropout on the head's input draws a new mask each chunk from the
    network's generator: two nets from one seed train alike, and the loss
    differs from the same net without dropout."""
    x, y = _seq(6)

    def run(dropout):
        net = _port_of(_jax_net(["lstm"], 4, dropout=dropout))
        return [float(net.fit_batch((x, y))) for _ in range(2)]

    assert run(0.5) == run(0.5)
    assert run(0.5)[0] != run(0.0)[0]


def test_sequence_no_longer_than_the_chunk_takes_the_plain_step():
    jn = _jax_net(["lstm"], 10)
    net = _port_of(jn)
    x, y = _seq(7)
    np.testing.assert_allclose(float(net.fit_batch((x, y))),
                               float(jn.fit_batch((x, y))), rtol=1e-5)
    assert net.step_count == 1


def test_zoo_char_rnn_with_tbptt():
    """TextGenerationLSTM under tBPTT (DL4J's char-modelling settings,
    scaled down): a trailing chunk of 2, losses finite and falling."""
    conf = dataclasses.replace(
        TextGenerationLSTM(units=8, vocab_size=7, timesteps=10).conf(),
        tbptt_fwd_length=4, tbptt_bwd_length=4)
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 7, (3, 11))
    x = np.eye(7, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(7, dtype=np.float32)[ids[:, 1:]]
    losses = [float(net.fit_batch((x, y))) for _ in range(25)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert net.step_count == 25


# ------------------------------------------------------ autograd functions
def test_lstm_function_gives_no_gradient_to_detached_carries():
    g = torch.Generator().manual_seed(0)
    B, T, F, H = 3, 5, 4, 6
    x = torch.randn(B, T, F, generator=g, requires_grad=True)
    h0, c0 = torch.randn(B, H, generator=g), torch.randn(B, H, generator=g)
    W = torch.randn(F, 4 * H, generator=g, requires_grad=True)
    R = torch.randn(H, 4 * H, generator=g, requires_grad=True)
    b = torch.zeros(4 * H, requires_grad=True)
    ys, hT, cT = FusedLSTMFunction.apply(x, h0, c0, W, R, b, None, 0.0, False)
    grads = ys.grad_fn.apply(torch.ones_like(ys), torch.ones_like(hT),
                       torch.ones_like(cT))
    assert grads[1] is None and grads[2] is None
    assert all(grads[i] is not None for i in (0, 3, 4, 5))
    h0.requires_grad_()
    c0.requires_grad_()
    ys, hT, cT = FusedLSTMFunction.apply(x, h0, c0, W, R, b, None, 0.0, False)
    grads = ys.grad_fn.apply(torch.ones_like(ys), torch.ones_like(hT),
                       torch.ones_like(cT))
    assert grads[1] is not None and grads[2] is not None


def test_gru_function_gives_no_gradient_to_a_detached_carry():
    g = torch.Generator().manual_seed(1)
    B, T, F, H = 3, 4, 4, 5
    x = torch.randn(B, T, F, generator=g, requires_grad=True)
    h0 = torch.randn(B, H, generator=g)
    W = torch.randn(F, 3 * H, generator=g, requires_grad=True)
    R = torch.randn(H, 3 * H, generator=g, requires_grad=True)
    b = torch.zeros(3 * H, requires_grad=True)
    ys, hT = FusedGRUFunction.apply(x, h0, W, R, b, False)
    grads = ys.grad_fn.apply(torch.ones_like(ys), torch.ones_like(hT))
    assert grads[1] is None and grads[0] is not None


# ------------------------------------- carry rows, feed_forward, params_table
def test_carry_rows_like_jax():
    jn = _jax_net(["lstm", "gru"], 0)
    net = _port_of(jn)
    x, _ = _seq(8, B=4, T=3)
    net.rnn_time_step(x)
    jn.rnn_time_step(x)
    sub, jsub = net.rnn_get_carry_rows([2, 0]), jn.rnn_get_carry_rows([2, 0])
    _close(sub, _np(jsub))
    # a fresh row 1 from another stream, merged into the stored state
    other, jother = _port_of(jn), _jax_net(["lstm", "gru"], 0)
    other.rnn_time_step(x[:1] * 2)
    merged = net.rnn_set_carry_rows([1], other.rnn_get_carry_rows([0]))
    jn2 = jn
    jother.params = jn.params
    jother.rnn_time_step(x[:1] * 2)
    jmerged = jn2.rnn_set_carry_rows([1], jother.rnn_get_carry_rows([0]))
    _close(merged, _np(jmerged))
    np.testing.assert_allclose(net.rnn_time_step(x[:, 0]).numpy(),
                               np.asarray(jn.rnn_time_step(x[:, 0])), **TOL)
    fresh = _port_of(jn)
    with pytest.raises(ValueError, match="no stored rnn state"):
        fresh.rnn_get_carry_rows(0)
    with pytest.raises(ValueError, match="pass batch="):
        fresh.rnn_set_carry_rows(0, sub)
    got = fresh.rnn_set_carry_rows([0, 1], sub, batch=3)
    assert got[0][0].shape == (3, 6)


def test_feed_forward_and_params_table_like_jax():
    jn = _jax_net(["bidi", "lstm"], 0)
    net = _port_of(jn)
    x, _ = _seq(2, T=4)
    acts, jacts = net.feed_forward(x), jn.feed_forward(x)
    assert len(acts) == len(jacts) == 4
    for a, b in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    table, jtable = net.params_table(), jn.params_table()
    assert list(table) == list(jtable)
    assert "0_fwd_W" in table and "1_RW" in table
    for k in table:
        np.testing.assert_array_equal(table[k].numpy(), np.asarray(jtable[k]))


@pytest.mark.cuda
def test_tbptt_on_card_runs_the_lstm_kernels_from_carried_state(monkeypatch):
    """On the card each chunk launches one forward (with its reserve) and
    one backward kernel per LSTM layer, from the carries the chunk before
    left, and the call agrees with the same net on the CPU's plain path
    (score 1e-5 relative, params 1e-4 absolute, f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    from deeplearning4j_tpu_torch.common.trees import tree_map
    from deeplearning4j_tpu_torch.ops.cuda import FUSED_LSTM, FUSED_LSTM_BWD

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    jn = _jax_net(["lstm", "lstm"], 4)
    cpu = _port_of(jn)
    card = _port_of(jn).to("cuda")
    x, y = _seq(11, B=16, T=10)
    fwd, bwd, res = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches,
                     FUSED_LSTM.reserves)
    got = float(card.fit_batch((x, y)))
    assert (FUSED_LSTM.launches - fwd, FUSED_LSTM_BWD.launches - bwd,
            FUSED_LSTM.reserves - res) == (6, 6, 6)   # 3 chunks x 2 layers
    np.testing.assert_allclose(got, float(cpu.fit_batch((x, y))), rtol=1e-5)
    _close(card.params, tree_map(lambda a: a.numpy(), cpu.params),
           atol=1e-4, rtol=0)
