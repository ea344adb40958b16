"""Transfer learning in the port against the JAX package. Ported from
tests/test_transferlearning.py.

The same builder calls on the same source network (the JAX weights loaded
into the port's) give the same configuration JSON, copy the same
parameters, freeze the same layers (``trainable=False``, the NoOp
updater), and after ``load_jax_params`` of the JAX result's weights give
the same outputs and the same ``fit_batch`` trajectory (1e-5). Frozen
parameters do not move; a frozen BatchNormalization's running statistics
move as they do in the JAX package.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import (
    ComputationGraph as JaxGraph, FineTuneConfiguration as JaxFTC,
    InputType as JaxInputType, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration as JaxNNC, TransferLearning as JaxTL,
)
from deeplearning4j_tpu.nn.layers import (
    BatchNormalizationLayer as JaxBN, DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optimize import Adam as JaxAdam, Sgd as JaxSgd
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning, TransferLearningBuilder,
    TransferLearningGraphBuilder,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam

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


def _jax_mln(seed=7, bn=False):
    b = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.1)).list()
         .layer(JaxDense(n_out=16, activation="relu")))
    if bn:
        b = b.layer(JaxBN())
    conf = (b.layer(JaxDense(n_out=12, activation="relu"))
            .layer(JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())
    return JaxNet(conf).init()


def _jax_graph(seed=7):
    g = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.1)).graph_builder()
         .add_inputs("in").set_input_types(**{"in": JaxInputType.feed_forward(8)}))
    g.add_layer("d1", JaxDense(n_out=16, activation="relu"), "in")
    g.add_layer("bn", JaxBN(), "d1")
    g.add_layer("d2", JaxDense(n_out=12, activation="relu"), "bn")
    g.add_layer("out", JaxOutput(n_out=4, activation="softmax",
                                 loss="mcxent"), "d2")
    g.set_outputs("out")
    return JaxGraph(g.build()).init()


def _port(jn):
    if isinstance(jn, JaxGraph):
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jn.conf.to_json()))
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jn.conf.to_json()))
    net.init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    return load_jax_opt_state(net, _np(jn.opt_state))


def _xy(seed, n=8, classes=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _build_both(jn, calls):
    """Apply the same builder calls to the JAX network and its port."""
    graph = isinstance(jn, JaxGraph)
    jb = (JaxTL.GraphBuilder if graph else JaxTL.Builder)(jn)
    pb = (TransferLearning.GraphBuilder if graph
          else TransferLearning.Builder)(_port(jn))
    for name, jargs, pargs in calls:
        jb = getattr(jb, name)(*jargs)
        pb = getattr(pb, name)(*pargs)
    return jb.build(), pb.build()


def _check_pair(jnew, new, steps=3, classes=4):
    """Same configuration, the copied params equal, and with the JAX
    weights the same outputs and trajectory."""
    assert new.conf.to_json() == jnew.conf.to_json()
    load_jax_params(new, _np(jnew.params), _np(jnew.state))
    load_jax_opt_state(new, _np(jnew.opt_state))
    x, _ = _xy(1)
    out, jout = new.output(x), jnew.output(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for s in range(steps):
        x, y = _xy(10 + s, classes=classes)
        np.testing.assert_allclose(float(new.fit_batch((x, y))),
                                   float(jnew.fit_batch((x, y))), rtol=1e-5)
    _close(new.params, _np(jnew.params))
    _close(new.state, _np(jnew.state))


def test_feature_extractor_freezes_and_copies_like_jax():
    jn = _jax_mln(bn=True)
    jnew, new = _build_both(jn, [("set_feature_extractor", (1,), (1,))])
    assert [l.trainable for l in new.layers] == [
        l.trainable for l in jnew.layers] == [False, False, True, True]
    # every layer copied from the source, frozen or not
    _close(new.params, _np(jn.params), atol=0, rtol=0)
    frozen = [{k: v.clone() for k, v in p.items()} for p in new.params[:2]]
    mean = new.state[1]["mean"].clone()
    _check_pair(jnew, new)
    for p, before in zip(new.params[:2], frozen):
        assert all(torch.equal(p[k], before[k]) for k in p)
    assert not torch.equal(new.params[3]["W"],
                           torch.tensor(np.asarray(jn.params[3]["W"])))
    # a frozen BatchNormalization still moves its running statistics in
    # training, as in the JAX package (checked against it in _check_pair)
    assert not torch.equal(new.state[1]["mean"], mean)


def test_head_swap_with_fine_tune_configuration_like_jax():
    jn = _jax_mln()
    jnew, new = _build_both(jn, [
        ("fine_tune_configuration", (JaxFTC(updater=JaxAdam(lr=1e-3)),),
         (FineTuneConfiguration(updater=Adam(lr=1e-3)),)),
        ("set_feature_extractor", (1,), (1,)),
        ("n_out_replace", (2, 10), (2, 10))])
    assert new.layers[2].n_out == 10 and tuple(new.params[2]["W"].shape) == (
        12, 10)
    _close(new.params[:2], _np(jn.params[:2]), atol=0, rtol=0)
    _check_pair(jnew, new, classes=10)


def test_remove_and_add_layers_like_jax():
    jn = _jax_mln()
    jnew, new = _build_both(jn, [
        ("remove_output_layer", (), ()),
        ("add_layer", (JaxDense(n_out=6, activation="tanh"),),
         (DenseLayer(n_out=6, activation="tanh"),)),
        ("add_layer", (JaxOutput(n_out=2, activation="softmax",
                                 loss="mcxent"),),
         (OutputLayer(n_out=2, activation="softmax", loss="mcxent"),))])
    assert len(new.layers) == 4
    _check_pair(jnew, new, classes=2)


def test_graph_feature_extractor_and_head_swap_like_jax():
    jn = _jax_graph()
    jnew, new = _build_both(jn, [
        ("set_feature_extractor", ("d2",), ("d2",)),
        ("remove_vertex_and_connections", ("out",), ("out",)),
        ("add_layer", ("newout", JaxOutput(n_out=7, activation="softmax",
                                           loss="mcxent"), "d2"),
         ("newout", OutputLayer(n_out=7, activation="softmax",
                                loss="mcxent"), "d2")),
        ("set_outputs", ("newout",), ("newout",))])
    frozen = {n: new.conf.vertices[n].layer.trainable
              for n in ("d1", "bn", "d2", "newout")}
    assert frozen == {n: jnew.conf.vertices[n].layer.trainable
                      for n in frozen}
    assert frozen == {"d1": False, "bn": False, "d2": False, "newout": True}
    for n in ("d1", "bn", "d2"):
        _close(new.params[n], _np(jn.params[n]), atol=0, rtol=0)
    before = {n: {k: v.clone() for k, v in new.params[n].items()}
              for n in ("d1", "bn", "d2")}
    _check_pair(jnew, new, classes=7)
    for n, p in before.items():
        assert all(torch.equal(new.params[n][k], v) for k, v in p.items())


def test_builders_are_the_namespace_entries():
    assert TransferLearning.Builder is TransferLearningBuilder
    assert TransferLearning.GraphBuilder is TransferLearningGraphBuilder
    with pytest.raises(ValueError, match="not initialized"):
        TransferLearningBuilder(MultiLayerNetwork(MultiLayerConfiguration
                                .from_json(_jax_mln().conf.to_json()))
                                ).build()


@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["no-clip", "clip"])
def test_frozen_gradients_formed_only_for_a_global_clip(clip):
    """A frozen layer's gradient is formed only where the global-norm clip
    reads it (the JAX clip counts it): the trajectory is the JAX package's
    either way, the clip binding at 0.05."""
    jn = _jax_mln()
    jn.conf.max_grad_norm = clip
    jnew, new = _build_both(jn, [("set_feature_extractor", (1,), (1,))])
    need = [all(p.requires_grad for p in d.values())
            for d in new._differentiable(new.params)]
    assert need == ([True] * 3 if clip else [False, False, True])
    _check_pair(jnew, new)
