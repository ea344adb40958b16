"""TextGenerationLSTM at a width of its own, in both packages.

The zoo model takes the width of both LSTM layers from its ``units``
field: at ``units=1024`` the port's layers run the fused LSTM's grid
kernels on the card. Here, on the CPU at small sizes, the JAX package's
network and the port's agree on what that field builds: the configuration
JSON (at full width, no weights), and with the JAX weights crossing into
the port through the model zip, ``output()``, the loss, the gradients of
the loss and one ``fit_batch`` step (RMSProp 1e-3, clipping 5.0), on the
same numpy batch.

Tolerance 1e-5, relative for losses and absolute and relative for
outputs, gradients, params and updater state: the two packages differ
only in the order of their sums (f32; the port's LSTM layers take the
plain lowering on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.textgen import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(V, B, T, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, T))
    return (np.eye(V, dtype=np.float32)[ids],
            np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)])


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_full_width_configuration_matches_jax():
    """TextGenerationLSTM(units=1024) writes the JAX package's
    configuration JSON: two LSTM(1024) layers over the 77-character
    vocabulary, RMSProp 1e-3, clipping 5.0, f32."""
    conf = TextGenerationLSTM(units=1024, seed=3).conf()
    assert conf.to_json() == JaxTextGen(units=1024, seed=3).conf().to_json()
    assert [getattr(layer, "n_out", None) for layer in conf.layers] == [
        1024, 1024, 77]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX TextGenerationLSTM(units=24), its weights moved off their
    init, written as a model zip and read back by the port."""
    kw = dict(units=24, vocab_size=11, timesteps=6, seed=5)
    jnet = JaxTextGen(**kw).init()
    rng = np.random.default_rng(9)
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        jnet.params)
    path = str(tmp_path_factory.mktemp("zip") / "textgen.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    assert net.conf.to_json() == TextGenerationLSTM(**kw).conf().to_json()
    return kw, jnet, net


def test_output_and_loss_match_jax(pair):
    kw, jnet, net = pair
    x, y = _batch(kw["vocab_size"], 5, kw["timesteps"], seed=1)
    np.testing.assert_allclose(net.output(x).detach().numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    np.testing.assert_allclose(net.score((x, y)), float(jnet.score((x, y))),
                               rtol=1e-5)


def test_gradients_match_jax(pair):
    """The loss's gradients with respect to every parameter, through
    ``as_loss_fn`` in both packages (jax.grad; torch autograd)."""
    kw, jnet, net = pair
    x, y = _batch(kw["vocab_size"], 5, kw["timesteps"], seed=2)
    jloss_fn, (jparams, jstate) = jnet.as_loss_fn(train=True)
    jgrads = jax.grad(lambda p: jloss_fn(p, jstate, None, x, y)[0])(jparams)
    loss_fn, (params, state) = net.as_loss_fn(train=True)
    leaves = [t.detach().clone().requires_grad_() for t in _leaves(params)]
    it = iter(leaves)
    tree = jax.tree_util.tree_map(lambda _: next(it), params)
    loss, _ = loss_fn(tree, state, None, x, y)
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss_fn(jparams, jstate, None, x,
                                              y)[0]), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = _leaves(jgrads)
    assert len(grads) == len(want) > 0
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_one_fit_batch_matches_jax(tmp_path):
    """One RMSProp step with clipping from the same zip: the step's loss,
    the params and the updater state after it."""
    kw = dict(units=24, vocab_size=11, timesteps=6, seed=7)
    jnet = JaxTextGen(**kw).init()
    path = str(tmp_path / "textgen.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    x, y = _batch(kw["vocab_size"], 5, kw["timesteps"], seed=3)
    np.testing.assert_allclose(float(net.fit_batch((x, y))),
                               float(jnet.fit_batch((x, y))), rtol=1e-5)
    for port, ref in ((net.params, jnet.params),
                      (net.opt_state, jnet.opt_state)):
        a, b = _leaves(port), _leaves(ref)
        assert len(a) == len(b) > 0
        for t, r in zip(a, b):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(r),
                                       **TOL)
