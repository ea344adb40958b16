"""The port's BatchNormalizationLayer and the layer state it keeps, against
the JAX package.

A dense net and a conv net (NHWC, so the statistics run over batch, height
and width per channel) with BatchNormalization are built from one
configuration JSON in both packages, the port's weights carried from the
JAX net by ``load_jax_params``. Three ``fit_batch`` steps must move the
running mean and var (the train step stores each layer's new state, as the
JAX step's ``new_states``), and state and params then match the JAX net
within 1e-5 in f32 (only the order of f32 sums differs). The updater is
Nesterovs, not Adam: the bias of a layer just before a BatchNormalization
has a gradient that is 0 in exact arithmetic, and Adam would scale its
float noise up to a full step. In eval mode ``output()`` normalizes with
the running statistics. The state crosses the model zip both ways and
``load_jax_params``.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JaxBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JaxPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.util.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.util.serialization import write_model as jax_write
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import BatchNormalizationLayer
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.util.serialization import (
    restore_multi_layer_network,
)

TOL = dict(atol=1e-5, rtol=1e-5)


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


def _builder(seed):
    return (JaxNNC.builder().seed(seed)
            .updater(JaxNesterovs(lr=1e-2, momentum=0.9)).list())


def _dense_conf(**bn):
    return (_builder(11)
            .layer(JaxDense(n_out=32, activation="identity"))
            .layer(JaxBN(**bn))
            .layer(JaxDense(n_out=16, activation="relu"))
            .layer(JaxBN(decay=0.8))
            .layer(JaxOutput(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(12)).build())


def _conv_conf():
    return (_builder(12)
            .layer(JaxConv(n_out=6, kernel=(3, 3), activation="identity"))
            .layer(JaxBN())
            .layer(JaxPool(kernel=(2, 2), strides=(2, 2), pooling_type="max"))
            .layer(JaxConv(n_out=4, kernel=(3, 3), activation="relu"))
            .layer(JaxBN(lock_gamma_beta=True))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(10, 10, 2)).build())


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert conf.to_json() == jnet.conf.to_json()
    net = MultiLayerNetwork(conf).init(device="cpu")
    load_jax_params(net, _np(jnet.params), _np(jnet.state))
    return load_jax_opt_state(net, _np(jnet.opt_state), jnet.step_count)


def _batches(shape, classes, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
        y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                           shape[0])]
        out.append((x, y))
    return out


CASES = {
    "dense": (_dense_conf, (8, 12), 5),
    "dense_state_stats": (lambda: _dense_conf(use_mean_var_from_state=True),
                          (8, 12), 5),
    "conv_nhwc": (_conv_conf, (4, 10, 10, 2), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_batch_moves_state_like_jax(case):
    make, shape, classes = CASES[case]
    jnet = JaxNet(make()).init()
    net = _port_of(jnet)
    before = [{k: v.clone() for k, v in s.items()} for s in net.state]
    for x, y in _batches(shape, classes):
        lj = jnet.fit_batch((x, y))
        lp = net.fit_batch((x, y))
        np.testing.assert_allclose(lp, lj, **TOL)
    _close(net.state, _np(jnet.state))
    _close(net.params, _np(jnet.params))
    bn = [i for i, l in enumerate(net.layers)
          if isinstance(l, BatchNormalizationLayer)]
    assert bn and all(set(net.state[i]) == {"mean", "var"} for i in bn)
    moved = [not torch.equal(net.state[i]["mean"], before[i]["mean"])
             for i in bn]
    if case == "dense_state_stats":  # the first BN reads its state, keeps it
        assert moved == [False, True]
    else:
        assert all(moved)
    assert all(not net.state[i]["var"].requires_grad for i in bn)
    # eval mode: output() normalizes with the running statistics
    x = _batches(shape, classes, n=1, seed=7)[0][0]
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


def test_output_reads_running_statistics():
    """A BN layer in eval mode normalizes with its state: moving the state
    moves output(), and the batch's own statistics do not enter."""
    jnet = JaxNet(_dense_conf()).init()
    net = _port_of(jnet)
    x = _batches((8, 12), 5, n=1)[0][0]
    a = net.output(x)
    assert torch.equal(net.output(x[:3]), a[:3])  # no batch statistics
    net.state[1]["mean"] += 0.5
    assert not torch.allclose(net.output(x), a)


def test_bf16_statistics_in_f32():
    """In a bf16 net the one-pass statistics are taken in f32 and the state
    stays f32; the normalized activations keep the compute type."""
    layer = BatchNormalizationLayer()
    p, s = layer.init(torch.Generator(), InputType.feed_forward(6), "cpu")
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(16, 6)) * 3 + 100.0,
                     dtype=torch.float32)
    y, s2 = layer.apply({k: v.bfloat16() for k, v in p.items()}, s,
                        x.bfloat16(), train=True)
    assert y.dtype == torch.bfloat16
    assert s2["mean"].dtype == s2["var"].dtype == torch.float32
    xb = x.bfloat16().float()
    mean = xb.mean(0)
    var = ((xb * xb).mean(0) - mean * mean).clamp_min(0.0)
    torch.testing.assert_close(s2["mean"], 0.1 * mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2["var"], 0.9 + 0.1 * var, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_crosses_the_zip(tmp_path, writer):
    """After training, the running statistics cross the model zip in both
    directions, and the restored nets agree with the JAX net."""
    jnet = JaxNet(_conv_conf()).init()
    net = _port_of(jnet)
    for x, y in _batches((4, 10, 10, 2), 3):
        jnet.fit_batch((x, y))
        net.fit_batch((x, y))
    path = str(tmp_path / "bn.zip")
    if writer == "jax":
        jax_write(jnet, path)
        back = restore_multi_layer_network(path, device="cpu")
        _close(back.state, _np(jnet.state))
    else:
        net.save(path)
        back = jax_restore(path)
        _close(net.state, _np(back.state))
    x = _batches((4, 10, 10, 2), 3, n=1, seed=5)[0][0]
    np.testing.assert_allclose(
        np.asarray(back.output(x), np.float32),
        np.asarray(jnet.output(x), np.float32), **TOL)


def test_load_jax_params_checks_state_layers():
    jnet = JaxNet(_dense_conf()).init()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json())).init(
            device="cpu")
    with pytest.raises(ValueError, match="layers of state"):
        load_jax_params(net, _np(jnet.params), _np(jnet.state)[:-1])
