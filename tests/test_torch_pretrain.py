"""The port's pretrain tier against the JAX package.

``AutoEncoderLayer`` and ``VariationalAutoencoderLayer`` from one
configuration JSON in both packages (their JSON both ways), on the JAX
layer's params: ``apply``, the encoder and decoder halves and
``reconstruct`` (1e-5); ``pretrain_loss`` and its gradients given the
noise the JAX layer draws (the corruption mask, each sample's eps, drawn
here from the same keys), mse and xent, gaussian and bernoulli, one and
three samples (1e-5); ``MultiLayerNetwork.pretrain`` at corruption 0
(no noise: threefry is not torch's generator) against the JAX package's
params after 5 steps a layer, over an array and over an iterator, with a
frozen dense layer and a flattening preprocessor below (1e-5); and the
four behaviours of ``tests/test_pretrain.py`` on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JaxArrayIter
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    AutoEncoderLayer as JaxAE, DenseLayer as JaxDense, OutputLayer as JaxOut,
    VariationalAutoencoderLayer as JaxVAE,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import Adam as JaxAdam
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.builders import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    AutoEncoderLayer, DenseLayer, Layer, OutputLayer,
    VariationalAutoencoderLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


def _layer_pair(jlayer, nin, seed=0):
    """The JAX layer, the port's from its JSON, and the JAX layer's params
    for both."""
    layer = Layer.from_dict(jlayer.to_dict())
    jp, _ = jlayer.init(jax.random.key(seed), JaxInputType.feed_forward(nin))
    return jlayer, layer, jp, _t(jp)


LAYERS = {
    "ae_mse": (JaxAE(n_out=6, corruption_level=0.3, activation="tanh"), 12),
    "ae_xent": (JaxAE(n_out=5, corruption_level=0.5, loss="xent"), 10),
    "vae_gauss": (JaxVAE(n_out=3, encoder_layer_sizes=(16, 8),
                         decoder_layer_sizes=(8,), activation="tanh"), 12),
    "vae_bern": (JaxVAE(n_out=2, encoder_layer_sizes=(16,),
                        decoder_layer_sizes=(16, 8), num_samples=3,
                        activation="leakyrelu",
                        reconstruction_distribution="bernoulli"), 10),
}


def _inputs(name, nin, seed=1):
    rng = np.random.default_rng(seed)
    if name in ("ae_xent", "vae_bern"):
        return (rng.random((7, nin)) > 0.5).astype(np.float32)
    return rng.normal(size=(7, nin)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_json_round_trip(name):
    jlayer, _ = LAYERS[name]
    layer = Layer.from_dict(jlayer.to_dict())
    assert type(layer).__name__ == type(jlayer).__name__
    assert layer.to_dict() == jlayer.to_dict()
    conf = (JaxNNC.builder().seed(3).list().layer(jlayer)
            .layer(JaxOut(n_out=2))
            .set_input_type(JaxInputType.feed_forward(LAYERS[name][1]))
            .build())
    port = MultiLayerConfiguration.from_json(conf.to_json())
    assert port.to_json() == conf.to_json()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_forward_halves_match_jax(name):
    jlayer, nin = LAYERS[name]
    jl, pl, jp, pp = _layer_pair(jlayer, nin)
    x = _inputs(name, nin)
    want, _ = jl.apply(jp, {}, jnp.asarray(x))
    got, _ = pl.apply(pp, {}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a [B, h, w, c] input is flattened first
    got4, _ = pl.apply(pp, {}, torch.tensor(x).reshape(7, 2, -1, 1))
    np.testing.assert_allclose(got4.numpy(), np.asarray(want), **TOL)
    if name.startswith("ae"):
        h = pl._encode(pp, torch.tensor(x))
        np.testing.assert_allclose(
            pl._decode(pp, h).numpy(),
            np.asarray(jl._decode(jp, jl._encode(jp, jnp.asarray(x)))),
            **TOL)
        return
    (mu, lv), (jmu, jlv) = pl.encode(pp, torch.tensor(x)), jl.encode(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **TOL)
    np.testing.assert_allclose(pl.decode(pp, mu).numpy(),
                               np.asarray(jl.decode(jp, jmu)), **TOL)
    np.testing.assert_allclose(pl.reconstruct(pp, torch.tensor(x)).numpy(),
                               np.asarray(jl.reconstruct(jp, jnp.asarray(x))),
                               **TOL)


def _jax_noise(jl, x, key):
    """The noise the JAX layer's pretrain_loss draws from ``key``."""
    if isinstance(jl, JaxAE):
        return np.asarray(jax.random.bernoulli(key, 1.0 - jl.corruption_level,
                                               x.shape))
    shape = (x.shape[0], jl.n_out)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, s),
                                                  shape))
                     for s in range(jl.num_samples)])


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_pretrain_loss_and_grads_given_jax_noise(name):
    jlayer, nin = LAYERS[name]
    jl, pl, jp, pp = _layer_pair(jlayer, nin, seed=4)
    x = _inputs(name, nin, seed=5)
    key = jax.random.key(9)
    want, jg = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), key))(jp)
    noise = torch.tensor(_jax_noise(jl, x, key))
    leaves, tdef = jax.tree_util.tree_flatten(pp)
    leaves = [a.requires_grad_(True) for a in leaves]
    p = jax.tree_util.tree_unflatten(tdef, leaves)
    got = pl.pretrain_loss(p, torch.tensor(x), noise=noise)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the port draws noise of the same shape and law from a generator
    gen = torch.Generator().manual_seed(0)
    drawn = pl.pretrain_noise(torch.tensor(x), gen)
    assert drawn.shape == noise.shape and drawn.dtype == noise.dtype


def test_noise_is_off_without_corruption_or_generator():
    layer = AutoEncoderLayer(n_out=3, corruption_level=0.0)
    x = torch.ones(2, 4)
    assert layer.pretrain_noise(x, torch.Generator()) is None
    assert AutoEncoderLayer(n_out=3).pretrain_noise(x, None) is None
    with pytest.raises(ValueError, match="generator"):
        VariationalAutoencoderLayer(n_out=2).pretrain_noise(x, None)


def _stack_conf(nnc, inputs, dense, ae, out, adam):
    return (nnc.builder().seed(7).updater(adam(lr=1e-2)).list()
            .layer(dense(n_out=10, activation="tanh", dropout=0.5))
            .layer(ae(n_out=6, corruption_level=0.0, activation="tanh"))
            .layer(ae(n_out=4, corruption_level=0.0, loss="xent"))
            .layer(out(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(inputs.convolutional(2, 3, 2)).build())


@pytest.mark.parametrize("source", ["array", "iterator"])
def test_pretrain_matches_jax_at_corruption_zero(source):
    """Greedy layer-wise pretraining at corruption 0, 5 steps a layer,
    below a frozen dense layer (dropout off in eval) behind the flattening
    preprocessor: every param of the port's net equals the JAX net's."""
    jconf = _stack_conf(JaxNNC, JaxInputType, JaxDense, JaxAE, JaxOut,
                        JaxAdam)
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    load_jax_params(net, _np(jnet.params))
    assert 0 in net.conf.preprocessors
    x = np.random.default_rng(3).random((16, 2, 3, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    if source == "array":
        jnet.pretrain(x, epochs=5)
        got = net.pretrain(x, epochs=5)
    else:
        jnet.pretrain(JaxArrayIter(x, y, batch_size=8), epochs=3)
        got = net.pretrain(ArrayDataSetIterator(x, y, batch_size=8), epochs=3)
    assert got is net
    for i, (a, b) in enumerate(zip(net.params, _np(jnet.params))):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k], **TOL,
                                       err_msg=f"layer {i} {k}")
    # the last loss of one more layer's run, as a float
    want = jnet.pretrain_layer(2, x, epochs=2)
    got = net.pretrain_layer(2, x, epochs=2)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, **TOL)


def test_pretrain_layer_refuses_a_layer_without_objective():
    net = MultiLayerNetwork(_stack_conf(
        NeuralNetConfiguration, InputType, DenseLayer, AutoEncoderLayer,
        OutputLayer, Adam)).init(device="cpu")
    with pytest.raises(ValueError, match="no pretrain objective"):
        net.pretrain_layer(0, np.zeros((2, 2, 3, 2), np.float32))


# ---------------------------------------------- tests/test_pretrain.py
def _data(rng, n=256, dim=16):
    half = n // 2
    x = np.concatenate([rng.normal(0.0, 0.3, (half, dim)),
                        rng.normal(1.0, 0.3, (n - half, dim))]).astype(
                            np.float32)
    y = np.concatenate([np.zeros(half, np.int64), np.ones(n - half, np.int64)])
    perm = rng.permutation(n)
    return x[perm], np.eye(2, dtype=np.float32)[y[perm]]


def _net(seed, lr, *layers, nin=16):
    b = NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr=lr)).list()
    for layer in layers:
        b = b.layer(layer)
    b = b.layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
    return MultiLayerNetwork(b.set_input_type(
        InputType.feed_forward(nin)).build()).init(device="cpu")


def test_reconstruction_improves(rng):
    x, y = _data(rng)
    model = _net(1, 1e-2, AutoEncoderLayer(n_out=8, corruption_level=0.2,
                                           activation="tanh"))
    l0 = model.pretrain_layer(0, x, epochs=1)
    l1 = model.pretrain_layer(0, x, epochs=30)
    assert np.isfinite(l1) and l1 < l0
    for _ in range(20):
        model.fit_batch((x, y))
    ev = model.evaluate(ArrayDataSetIterator(x, y, batch_size=64))
    assert ev.accuracy() > 0.9


def test_pretrain_all_layers(rng):
    x, _ = _data(rng)
    model = _net(2, 1e-2, AutoEncoderLayer(n_out=12, activation="tanh"),
                 AutoEncoderLayer(n_out=6, activation="tanh"))
    w0 = model.params[0]["W"].clone()
    w1 = model.params[1]["W"].clone()
    model.pretrain(x, epochs=5)
    assert not torch.allclose(w0, model.params[0]["W"])
    assert not torch.allclose(w1, model.params[1]["W"])


def test_vae_elbo_improves_and_reconstructs(rng):
    x, _ = _data(rng, n=256, dim=12)
    layer = VariationalAutoencoderLayer(
        n_out=4, encoder_layer_sizes=(32,), decoder_layer_sizes=(32,),
        reconstruction_distribution="gaussian")
    model = _net(3, 3e-3, layer, nin=12)
    l0 = model.pretrain_layer(0, x, epochs=1)
    l1 = model.pretrain_layer(0, x, epochs=60)
    assert np.isfinite(l1) and l1 < l0
    recon = layer.reconstruct(model.params[0], torch.tensor(x)).numpy()
    err = ((recon - x) ** 2).mean()
    base = ((x - x.mean(0)) ** 2).mean()
    assert err < base, (err, base)
    assert model.output(x[:5]).shape == (5, 2)


def test_vae_bernoulli_distribution(rng):
    x = (rng.random((128, 10)) > 0.5).astype(np.float32)
    layer = VariationalAutoencoderLayer(
        n_out=3, encoder_layer_sizes=(16,), decoder_layer_sizes=(16,),
        reconstruction_distribution="bernoulli")
    model = _net(4, 3e-3, layer, nin=10)
    loss = model.pretrain_layer(0, x, epochs=10)
    assert np.isfinite(loss)
    recon = layer.reconstruct(model.params[0], torch.tensor(x))
    assert float(recon.min()) >= 0.0 and float(recon.max()) <= 1.0
