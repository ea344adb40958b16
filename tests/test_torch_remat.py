"""Gradient checkpointing (``remat``) of the port against the JAX package.

With ``remat`` on, each layer (each vertex of a ComputationGraph) keeps only
its inputs for the backward pass and recomputes its internals there
(``torch.utils.checkpoint``; the JAX package's ``jax.checkpoint``). The
loss and gradients of one training forward agree with the JAX package's
with remat (dropout off: the packages draw different bits) within 1e-5,
and are bitwise the port's own without remat, dropout on: the recompute
replays the dropout generator's draws of the forward. A naive
``torch.utils.checkpoint``, which restores only the global RNG states and
not the network's explicit generator, draws other masks in the recompute
and gives other gradients; a test below shows the trap is live. Running
statistics move once a step, as without remat.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import (
    InputType as JaxInputType, NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.layers import (
    BatchNormalizationLayer as JaxBN, DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.zoo.bert import Bert as JaxBert
from deeplearning4j_tpu_torch.common.dtypes import cast_floating
from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.nn import multilayer
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=97, max_len=16, d_model=32, n_layers=2, n_heads=2,
            d_ff=64, num_classes=3, dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, **tol):
    """``port`` (tensors) against ``ref`` (arrays), same nesting."""
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


def _bert_conf(dropout, remat):
    conf = JaxBert(dropout=dropout, **TINY).conf()
    conf.remat = remat
    return conf


def _port_mln(jconf, jparams):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    return load_jax_params(net, _np(jparams))


def _batch(seed, B=5, T=16, V=97, C=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (B, T)).astype(np.int32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    lens = rng.integers(1, T + 1, B)
    m = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return x, y, m


def _port_grads(net, x, y, m, seed=11):
    """The train step's loss and gradients (no update), the dropout
    generator seeded with ``seed``."""
    net._rng = torch.Generator().manual_seed(seed)
    params = tree_map(lambda p: p.detach().requires_grad_(), net.params)
    loss, _ = net._loss_terms(
        cast_floating(params, net._policy.compute_dtype), net._input(x),
        net._labels(y), net._mask(m), None, train=True, rng=net._rng)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    return loss.detach(), grads


def test_bert_remat_loss_and_grads_match_jax():
    jconf = _bert_conf(0.0, True)
    jn = JaxNet(jconf).init()
    x, y, m = _batch(1)

    def jloss(p):
        return jn._loss_terms(p, jn.state, jnp.asarray(x), jnp.asarray(y),
                              jax.random.key(0), jnp.asarray(m))[0]

    want, jgrads = jax.value_and_grad(jloss)(jn.params)
    net = _port_mln(jconf, jn.params)
    assert net.conf.remat
    loss, grads = _port_grads(net, x, y, m)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    _close(tree_unflatten(net.params, grads), _np(jgrads))


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_is_bitwise_the_step_without_remat(dropout):
    """From the same params, generator state and batch, with dropout on."""
    jn_params = JaxNet(_bert_conf(dropout, False)).init().params
    on = _port_mln(_bert_conf(dropout, True), jn_params)
    off = _port_mln(_bert_conf(dropout, False), jn_params)
    x, y, m = _batch(2)
    l_on, g_on = _port_grads(on, x, y, m)
    l_off, g_off = _port_grads(off, x, y, m)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    # the forward left the generator where the step without remat leaves it
    assert torch.equal(on._rng.get_state(), off._rng.get_state())
    # and fit_batch takes the same step
    for net in (on, off):
        net._rng = torch.Generator().manual_seed(5)
    assert float(on.fit_batch((x, y, m))) == float(off.fit_batch((x, y, m)))
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)


def test_naive_checkpoint_draws_other_masks(monkeypatch):
    """The generator trap is live: a plain ``torch.utils.checkpoint`` of
    each layer gives other gradients than the step without remat."""
    from torch.utils.checkpoint import checkpoint

    params = JaxNet(_bert_conf(0.3, False)).init().params
    on = _port_mln(_bert_conf(0.3, True), params)
    off = _port_mln(_bert_conf(0.3, False), params)
    monkeypatch.setattr(multilayer, "remat_apply", lambda fn, rng, *a:
                        checkpoint(lambda *b: fn(rng, *b), *a,
                                   use_reentrant=False))
    x, y, m = _batch(3)
    l_on, g_on = _port_grads(on, x, y, m)
    l_off, g_off = _port_grads(off, x, y, m)
    assert torch.equal(l_on, l_off)          # the forward is the same
    assert not all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def _jax_graph(remat, dropout):
    g = (JaxNNC.builder().seed(3).gradient_checkpointing(remat)
         .graph_builder().add_inputs("in")
         .set_input_types(**{"in": JaxInputType.feed_forward(6)}))
    g.add_layer("d1", JaxDense(n_out=8, activation="tanh", dropout=dropout),
                "in")
    g.add_layer("bn", JaxBN(), "d1")
    g.add_layer("d2", JaxDense(n_out=8, activation="relu"), "bn")
    g.add_layer("out", JaxOutput(n_out=3, activation="softmax",
                                 loss="mcxent", dropout=dropout), "d2")
    g.set_outputs("out")
    return g.build()


def _port_graph(jconf, jn):
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    return load_jax_opt_state(net, _np(jn.opt_state), jn.step_count)


def _xy(seed, B=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 6)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)])


def test_graph_remat_steps_like_jax():
    """Three steps of a graph with BatchNormalization, remat on in both
    packages: losses, params, running statistics and updater state."""
    jconf = _jax_graph(True, 0.0)
    jn = JaxGraph(jconf).init()
    net = _port_graph(jconf, jn)
    assert net.conf.remat
    for s in range(3):
        x, y = _xy(s)
        np.testing.assert_allclose(float(net.fit_batch((x, y))),
                                   float(jn.fit_batch((x, y))), rtol=1e-5)
    for mine, theirs in ((net.params, jn.params), (net.state, jn.state),
                         (net.opt_state, jn.opt_state)):
        _close(mine, _np(theirs))


def test_graph_remat_with_dropout_is_the_step_without():
    jn = JaxGraph(_jax_graph(False, 0.4)).init()
    on = _port_graph(_jax_graph(True, 0.4), jn)
    off = _port_graph(_jax_graph(False, 0.4), jn)
    x, y = _xy(9)
    for _ in range(2):
        assert float(on.fit_batch((x, y))) == float(off.fit_batch((x, y)))
    for mine, theirs in ((on.params, off.params), (on.state, off.state)):
        for a, b in zip(tree_leaves(mine), tree_leaves(theirs)):
            assert torch.equal(a, b)


def test_remat_moves_running_statistics_once():
    jconf = MultiLayerConfiguration.from_json(
        (JaxNNC.builder().seed(2).list().layer(JaxDense(n_out=5))
         .layer(JaxBN()).layer(JaxOutput(n_out=3, activation="softmax"))
         .set_input_type(JaxInputType.feed_forward(6)).build()).to_json())
    nets = [MultiLayerNetwork(dataclasses.replace(jconf, remat=r)).init(
        device="cpu") for r in (True, False)]
    x, y = _xy(4)
    for net in nets:
        net.fit_batch((x, y))
    assert torch.equal(nets[0].state[1]["mean"], nets[1].state[1]["mean"])
    assert torch.equal(nets[0].state[1]["var"], nets[1].state[1]["var"])


@pytest.mark.cuda
def test_remat_on_card_reruns_the_flash_forward():
    """On the card a remat step launches the flash forward twice a block
    (the forward and its recompute) and dq and dk/dv once, and gives the
    step without remat's loss and gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    from deeplearning4j_tpu_torch.ops.cuda import FLASH_DKV, FLASH_DQ, FLASH_FWD

    params = JaxNet(_bert_conf(0.3, False)).init().params
    on = _port_mln(_bert_conf(0.3, True), params).to("cuda")
    off = _port_mln(_bert_conf(0.3, False), params).to("cuda")
    x, y, m = _batch(5, B=8)
    counts = []
    for net in (on, off):
        before = [k.launches for k in (FLASH_FWD, FLASH_DQ, FLASH_DKV)]
        net._rng = torch.Generator(device="cuda").manual_seed(3)
        params_ = tree_map(lambda p: p.detach().requires_grad_(), net.params)
        loss, _ = net._loss_terms(
            cast_floating(params_, net._policy.compute_dtype), net._input(x),
            net._labels(y), net._mask(m), None, train=True, rng=net._rng)
        grads = torch.autograd.grad(loss, tree_leaves(params_))
        counts.append([k.launches - b for k, b in
                       zip((FLASH_FWD, FLASH_DQ, FLASH_DKV), before)])
        net._result = (loss, grads)
    assert counts == [[4, 2, 2], [2, 2, 2]]
    assert torch.equal(on._result[0], off._result[0])
    assert all(torch.equal(a, b) for a, b in zip(on._result[1],
                                                 off._result[1]))
