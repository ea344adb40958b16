"""The port's ``ParallelWrapper`` (``parallel/data_parallel.py``) and
``as_loss_fn`` on both network classes, against the JAX package.

The JAX side trains through its own ``ParallelWrapper`` on the conftest's 8
virtual devices; the port's through a gloo world of 4 ranks
(``torch_parallel_ranks.data_world``, one world for every case), from the
same configuration JSON, weights and numpy batches:

- the JAX tests' dense net, 5 steps, and ``fit`` over an iterator (2
  epochs of 2 batches): params within 1e-5;
- a ResNet-style conv + BatchNorm graph with a residual add, 3 steps at
  B = 16 (4 a rank): params, BN running statistics and updater state within
  1e-5 in f32, and within 1e-8 with both packages in f64. A control whose
  BatchNorm statistics are each rank's own (no all-reduce) misses the f32
  limit by orders;
- a padded-sequence LSTM whose ranks hold unequal valid counts (the global
  denominator), 3 steps: losses and params within 1e-5.

``as_loss_fn``: the loss and new state of both classes' functional surface,
with masks, l2 and ``denom``, equal to the JAX one within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.dtypes import DtypePolicy as JaxPolicy
from deeplearning4j_tpu.nn import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex as JaxAdd
from deeplearning4j_tpu.nn.layers import ActivationLayer as JaxAct
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JaxBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JaxPool
from deeplearning4j_tpu.nn.layers import LSTMLayer as JaxLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.optimize.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.optimize.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxWrapper
from deeplearning4j_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_F64 = dict(rtol=1e-8, atol=1e-8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense(seed=9):
    conf = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.1)).list()
            .layer(JaxDense(n_out=16, activation="relu"))
            .layer(JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())
    return JaxNet(conf).init()


def _resnet_style(seed=11):
    g = (JaxNNC.builder().seed(seed).updater(JaxNesterovs(lr=0.05))
         .graph_builder().add_inputs("in")
         .set_input_types(**{"in": JaxInputType.convolutional(8, 8, 3)})
         .add_layer("c1", JaxConv(n_out=8, kernel=(3, 3), padding="same",
                                  has_bias=False), "in")
         .add_layer("bn1", JaxBN(), "c1")
         .add_layer("r1", JaxAct(activation="relu"), "bn1")
         .add_layer("c2", JaxConv(n_out=8, kernel=(3, 3), padding="same",
                                  has_bias=False), "r1")
         .add_layer("bn2", JaxBN(), "c2")
         .add_layer("sc", JaxConv(n_out=8, kernel=(1, 1), padding="same",
                                  has_bias=False), "in")
         .add_layer("bn_sc", JaxBN(), "sc")
         .add_vertex("add", JaxAdd(op="add"), "bn2", "bn_sc")
         .add_layer("r2", JaxAct(activation="relu"), "add")
         .add_layer("gp", JaxPool(pooling_type="avg"), "r2")
         .add_layer("out", JaxOutput(n_out=4, activation="softmax",
                                     loss="mcxent"), "gp")
         .set_outputs("out").build())
    return JaxGraph(g).init()


def _lstm(seed=3):
    conf = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.3)).list()
            .layer(JaxLSTM(n_out=8))
            .layer(JaxRnnOutput(n_out=3, activation="softmax",
                                loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(4, 6)).build())
    return JaxNet(conf).init()


def _case(net, kind, batch, steps, **kw):
    return dict(json=net.conf.to_json(), kind=kind, params=_np(net.params),
                state=_np(net.state), opt=_np(net.opt_state), batch=batch,
                steps=steps, **kw)


def _jax_train(net, batch, steps, f64=False):
    """The JAX ParallelWrapper over 8 devices: (losses, params, state,
    updater state) as numpy."""
    w = JaxWrapper(net, JaxMesh(data=8), prefetch_buffer=0)
    if not f64:
        losses = [float(w.fit_batch(batch)) for _ in range(steps)]
        return losses, _np(net.params), _np(net.state), _np(net.opt_state)
    with jax.enable_x64(True):
        f = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        net.params, net.state, net.opt_state = (
            f(net.params), f(net.state), f(net.opt_state))
        net._policy = JaxPolicy(jnp.float64, jnp.float64, jnp.float64)
        losses = [float(w.fit_batch(batch)) for _ in range(steps)]
        return losses, _np(net.params), _np(net.state), _np(net.opt_state)


def _masked_sequences(rng, n=16, T=6, F=4, C=3):
    x = rng.normal(size=(n, T, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[np.argmax(x[..., :C], -1)]
    mask = np.ones((n, T), np.float32)
    # rank r holds rows 4r..4r+3: 24, 18, 12 and 9 valid steps
    lens = [6, 6, 6, 6, 6, 6, 3, 3, 3, 3, 3, 3, 2, 2, 2, 3]
    for i, L in enumerate(lens):
        mask[i, L:] = 0.0
    return x, y, mask


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of every case: {name: (port per rank, jax)}."""
    rng = np.random.default_rng(42)
    dx = rng.normal(size=(32, 8)).astype(np.float32)
    dy = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
    gx = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    gy = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    sx, sy, sm = _masked_sequences(rng)
    jax_runs, cases = {}, {}
    for name, make, kind, batch, steps, kw in (
            ("dense", _dense, "mln", (dx, dy), 5, {}),
            ("dense_fit", _dense, "mln", (dx, dy), 2, {"fit": 16}),
            ("graph_f32", _resnet_style, "graph", (gx, gy), 3, {}),
            ("graph_f64", _resnet_style, "graph",
             (gx.astype(np.float64), gy.astype(np.float64)), 3,
             {"f64": True}),
            ("graph_control", _resnet_style, "graph", (gx, gy), 3,
             {"control": True}),
            ("lstm_masked", _lstm, "mln", (sx, sy, sm), 3, {})):
        net = make()
        cases[name] = _case(net, kind, batch, steps, **kw)
        if name == "dense_fit":
            from deeplearning4j_tpu.datasets.iterators import (
                ArrayDataSetIterator,
            )

            JaxWrapper(net, JaxMesh(data=8), prefetch_buffer=2).fit(
                ArrayDataSetIterator(dx, dy, batch_size=16), epochs=2)
            jax_runs[name] = ([net.epoch_count, float(net.score_value)],
                              _np(net.params), _np(net.state),
                              _np(net.opt_state))
        elif name != "graph_control":
            jax_runs[name] = _jax_train(net, batch, steps,
                                        f64=kw.get("f64", False))
    jax_runs["graph_control"] = jax_runs["graph_f32"]
    port = launch.run(ranks.data_world, WORLD, device="cpu", args=(cases,),
                      threads=1, timeout=300)
    return {k: ([r[k] for r in port], jax_runs[k]) for k in cases}


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
        np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _max_diff(port, ref):
    if isinstance(ref, dict):
        return max(_max_diff(port[k], ref[k]) for k in ref)
    if isinstance(ref, (list, tuple)):
        return max((_max_diff(a, b) for a, b in zip(port, ref)), default=0.0)
    return float(np.abs(np.asarray(port) - np.asarray(ref)).max())


class TestDataParallel:
    def test_dp_matches_jax_wrapper(self, runs):
        """The collapse proof, across packages: the port's 4-rank data
        parallelism gives the JAX 8-device wrapper's trajectory."""
        port, (losses, params, _, _) = runs["dense"]
        for r in port:
            np.testing.assert_allclose(r[0], losses, **TOL)
            _close(r[1], params, **TOL)

    @pytest.mark.parametrize("what", ["params", "state", "opt_state"])
    def test_resnet_style_graph_f32(self, runs, what):
        """Global BatchNorm statistics: every rank's params, running
        statistics and updater state after 3 steps are the JAX wrapper's."""
        i = ["params", "state", "opt_state"].index(what) + 1
        port, ref = runs["graph_f32"]
        for r in port:
            _close(r[i], ref[i], **TOL)
            np.testing.assert_allclose(r[0], ref[0], **TOL)

    @pytest.mark.parametrize("what", ["params", "state", "opt_state"])
    def test_resnet_style_graph_f64(self, runs, what):
        i = ["params", "state", "opt_state"].index(what) + 1
        port, ref = runs["graph_f64"]
        for r in port:
            _close(r[i], ref[i], **TOL_F64)

    def test_control_without_the_bn_all_reduce_fails(self, runs):
        """The limits above catch a wrapper whose BatchNorm normalizes by
        each rank's own statistics."""
        port, ref = runs["graph_control"]
        assert _max_diff(port[0][2], ref[2]) > 100 * TOL["atol"]
        assert _max_diff(port[0][1], ref[1]) > 100 * TOL["atol"]

    def test_fit_drains_an_iterator_like_jax(self, runs):
        """``fit`` over an iterator (2 epochs of 2 batches, prefetched):
        the epochs counted, the last score and the params the JAX
        wrapper's."""
        port, (epochs_score, params, _, _) = runs["dense_fit"]
        for r in port:
            assert r[0][0] == epochs_score[0] == 2
            np.testing.assert_allclose(r[0][1], epochs_score[1], **TOL)
            _close(r[1], params, **TOL)

    def test_replicas_stay_identical(self, runs):
        for name in ("dense", "graph_f32", "lstm_masked"):
            port, _ = runs[name]
            for r in port[1:]:
                _close(r[1], port[0][1], rtol=0, atol=0)

    def test_masked_batch_with_unequal_counts_per_rank(self, runs):
        """The loss is the global batch's however the padding falls: the
        masked loss divides by the global valid count."""
        port, (losses, params, _, _) = runs["lstm_masked"]
        for r in port:
            np.testing.assert_allclose(r[0], losses, **TOL)
            _close(r[1], params, **TOL)


class TestAsLossFn:
    """Both classes' functional surface against the JAX one: loss and new
    state, with masks, l2 and ``denom``, train mode, no dropout."""

    def _mln(self):
        conf = (JaxNNC.builder().seed(5).updater(JaxSgd(lr=0.1))
                .list().layer(JaxLSTM(n_out=8, l2=1e-3))
                .layer(JaxRnnOutput(n_out=3, activation="softmax",
                                    loss="mcxent"))
                .set_input_type(JaxInputType.recurrent(4, 6)).build())
        return JaxNet(conf).init()

    @pytest.mark.parametrize("kind", ["mln", "graph"])
    @pytest.mark.parametrize("masks", ["none", "mask", "mask+label+denom"])
    def test_loss_and_state_match_jax(self, kind, masks):
        rng = np.random.default_rng(3)
        if kind == "mln":
            jn = self._mln()
            x, y, m = _masked_sequences(rng)
        else:
            jn = _resnet_style()
            x = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
            y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
            m = np.ones((8, 1), np.float32)
            m[5:] = 0.0
        args, kw = (), {}
        if masks != "none":
            args = (m,)
        if masks == "mask+label+denom":
            lm = m.copy()
            lm[0] = 0.0
            args, kw = (m, lm), {"denom": 3.0}
        jfn, (jp, js) = jn.as_loss_fn(train=True)
        jl, jstate = jax.jit(lambda p, s, *a, **k: jfn(p, s, None, *a, **k))(
            jp, js, jnp.asarray(x), jnp.asarray(y),
            *[jnp.asarray(a) for a in args],
            **{k: jnp.asarray(v) for k, v in kw.items()})
        net = ranks._port_net(_case(jn, kind, None, 0))
        fn, (p, s) = net.as_loss_fn(train=True)
        loss, state = fn(p, s, None, x, y, *args,
                         **{k: torch.tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        _close(ranks.np_tree(state), _np(jstate), rtol=1e-6, atol=1e-6)
