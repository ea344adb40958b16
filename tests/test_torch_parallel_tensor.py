"""The port's tensor and expert parallelism (``parallel/tensor_parallel.py``,
``parallel/expert.py``) against the JAX package's.

One gloo world of 4 ranks (``torch_parallel_ranks.tensor_world``) runs
``TensorParallel`` over a (data 2, model 2) mesh and the switch MoE over
(model 4); the JAX side runs its own over (data 2, model 4) of the
conftest's 8 virtual devices, from the same JSON, weights and batches.
The port's result must not depend on the specs, as GSPMD's does not: the
role-table layers compute Megatron-style from their shards, the rest from
gathered params. Tolerances are the JAX tests': the dense net 1e-5
(2e-4 relative), tiny BERT 5e-5 (5e-4 relative), the conv graph 1e-6
(1e-4 relative, losses 2e-5), the MoE 2e-4 (2e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.nn import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import ActivationLayer as JaxAct
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JaxBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JaxPool
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.optimize.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu.parallel import TensorParallel as JaxTP
from deeplearning4j_tpu.parallel import expert as jexpert
from deeplearning4j_tpu.zoo import Bert as JaxBert
from deeplearning4j_tpu_torch.parallel import launch
from deeplearning4j_tpu_torch.parallel import expert as pexpert
from deeplearning4j_tpu_torch.parallel.tensor_parallel import default_rules

import torch_parallel_ranks as ranks

TOL = {"dense": dict(rtol=2e-4, atol=1e-5),
       "bert": dict(rtol=5e-4, atol=5e-5),
       "conv": dict(rtol=1e-4, atol=1e-6)}
TOL_MOE = dict(rtol=2e-3, atol=2e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense(seed=9):
    conf = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.1)).list()
            .layer(JaxDense(n_out=16, activation="relu"))
            .layer(JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())
    return JaxNet(conf).init()


def _bert(seed=3):
    return JaxBert(vocab_size=64, max_len=8, d_model=32, n_layers=2,
                   n_heads=4, d_ff=64, num_classes=2, dropout=0.0,
                   dtype="float32", seed=seed).init()


def _conv_graph(seed=11):
    g = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.05))
         .graph_builder().add_inputs("in")
         .set_input_types(**{"in": JaxInputType.convolutional(8, 8, 3)})
         .add_layer("c1", JaxConv(n_out=16, kernel=(3, 3), padding="same",
                                  has_bias=False), "in")
         .add_layer("bn1", JaxBN(), "c1")
         .add_layer("r1", JaxAct(activation="relu"), "bn1")
         .add_layer("c2", JaxConv(n_out=32, kernel=(3, 3), padding="same"),
                    "r1")
         .add_layer("gp", JaxPool(pooling_type="avg"), "c2")
         .add_layer("out", JaxOutput(n_out=4, activation="softmax",
                                     loss="mcxent"), "gp")
         .set_outputs("out").build())
    return JaxGraph(g).init()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    ids = rng.integers(0, 64, (16, 8)).astype(np.int32)
    yb = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    cx = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    cy = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    jmesh = JaxMesh(data=2, model=4)
    tp_cases, jax_runs = {}, {}
    for name, make, kind, batch, steps in (
            ("dense", _dense, "mln", (x, y), 3),
            ("bert", _bert, "mln", (ids, yb), 2),
            ("conv", _conv_graph, "graph", (cx, cy), 3)):
        net = make()
        tp_cases[name] = dict(json=net.conf.to_json(), kind=kind,
                              params=_np(net.params), state=_np(net.state),
                              opt=_np(net.opt_state), batch=batch,
                              steps=steps)
        # the specs on a model axis of 2, as the port's mesh has it (a
        # dim that does not divide the axis is replicated)
        specs = jax.tree_util.tree_map(
            tuple, JaxTP(net, JaxMesh(data=4, model=2)).param_specs(),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        tp = JaxTP(net, jmesh)
        losses = [float(tp.fit_batch(batch)) for _ in range(steps)]
        jax_runs[name] = (losses, _np(net.params), specs,
                          np.asarray(net.output(batch[0])))
    moe_params = _np(jexpert.init_moe_params(jax.random.key(0), d_model=16,
                                             d_hidden=32, n_experts=4))
    mx = rng.normal(size=(64, 16)).astype(np.float32)
    mw = rng.normal(size=(64, 16)).astype(np.float32)
    train_params = _np(jexpert.init_moe_params(jax.random.key(1), d_model=8,
                                               d_hidden=16, n_experts=4))
    tx = rng.normal(size=(32, 8)).astype(np.float32)
    ty = tx @ rng.normal(size=(8, 8)).astype(np.float32)
    p = dict(tp=tp_cases, moe=dict(params=moe_params, x=mx, w=mw),
             moe_train=dict(params=train_params, x=tx, y=ty, steps=40))
    port = launch.run(ranks.tensor_world, 4, device="cpu", args=(p,),
                      threads=1, timeout=300)
    return p, jmesh, jax_runs, port


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


class TestTensorParallel:
    @pytest.mark.parametrize("name", ["dense", "bert"])
    def test_tp_matches_jax(self, case, name):
        """The JAX TensorParallel's trajectory (itself the single-device
        one): losses and every param, gathered whole from the shards."""
        _, _, jax_runs, port = case
        losses, params, _, out = jax_runs[name]
        for r in port:
            got = r[name]
            np.testing.assert_allclose(got[0], losses, **TOL[name])
            _close(got[1], params, **TOL[name])
            np.testing.assert_allclose(got[3], out, **TOL[name])

    @pytest.mark.parametrize("name", ["dense", "bert"])
    def test_param_specs_are_the_jax_rules(self, case, name):
        """The same role table, heuristics and divisibility rule."""
        _, _, jax_runs, port = case
        for r in port:
            assert r[name][2] == jax_runs[name][2]

    @pytest.mark.parametrize("name", ["bert", "conv"])
    def test_role_table_layers_compute_megatron_style(self, case, name):
        """The encoder blocks and the convolutions run Megatron-style from
        their shards; other sharded layers gather their params; layers
        without a sharded param run as they are."""
        for r in case[3]:
            kinds = r[name][4]
            for cls, megatron in kinds.values():
                if cls in ("TransformerEncoderLayer", "ConvolutionLayer"):
                    assert megatron is True, cls
                elif cls in ("EmbeddingSequenceLayer", "OutputLayer"):
                    assert megatron is False, cls
                else:
                    assert megatron is None, cls

    def test_megatron_roles_of_the_encoder(self):
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            TransformerEncoderLayer,
        )

        layer = TransformerEncoderLayer(d_model=32, n_heads=4)
        assert default_rules(layer, "Wq", 2) == (None, "model")
        assert default_rules(layer, "Wo", 2) == ("model", None)
        assert default_rules(layer, "W1", 2) == (None, "model")
        assert default_rules(layer, "W2", 2) == ("model", None)
        assert default_rules(layer, "b2", 1) == ()


class TestConvSharding:
    def test_tp_conv_graph_matches_jax(self, case):
        """Conv kernels split by output channel, BN replicated: the same
        steps as the JAX TensorParallel (and so the single device)."""
        _, _, jax_runs, port = case
        losses, params, _, out = jax_runs["conv"]
        for r in port:
            got = r["conv"]
            np.testing.assert_allclose(got[0], losses, rtol=2e-5)
            _close(got[1], params, **TOL["conv"])
            np.testing.assert_allclose(got[3], out, rtol=1e-4, atol=1e-5)

    def test_tp_conv_specs_shard_conv_kernels(self, case):
        _, _, jax_runs, port = case
        specs = port[0]["conv"][2]
        assert specs["c1"]["W"] == (None, None, None, "model")
        assert specs["c2"]["b"] == ("model",)
        assert specs["bn1"]["gamma"] == ()
        assert specs == jax_runs["conv"][2]


class TestExpertParallel:
    def test_moe_matches_jax_and_reference(self, case):
        p, jmesh, _, port = case
        moe = p["moe"]
        params = jexpert.place_moe_params(
            jax.tree_util.tree_map(jnp.asarray, moe["params"]), jmesh)
        x, w = jnp.asarray(moe["x"]), jnp.asarray(moe["w"])

        def loss(pp, xx):
            yy, aux = jexpert.switch_moe(pp, xx)
            return (yy * w).sum() + aux, (yy, aux)

        with jmesh.mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
        ref = pexpert.switch_moe_reference(moe["params"], moe["x"])
        np.testing.assert_allclose(ref, jexpert.switch_moe_reference(
            moe["params"], moe["x"]), rtol=1e-5, atol=1e-6)
        for rank, r in enumerate(port):
            got_y, got_aux, got_gx, got_gp = r["moe"]
            np.testing.assert_allclose(got_y, np.asarray(y), **TOL_MOE)
            np.testing.assert_allclose(got_y, ref, **TOL_MOE)
            assert got_aux == pytest.approx(float(aux), rel=1e-5)
            assert got_aux >= 1.0 - 1e-3
            np.testing.assert_allclose(got_gx, np.asarray(gx), **TOL_MOE)
            np.testing.assert_allclose(got_gp["router_W"],
                                       np.asarray(gp["router_W"]), **TOL_MOE)
            for k in ("W1", "b1", "W2", "b2"):
                # this rank's experts' gradients
                np.testing.assert_allclose(
                    got_gp[k], np.split(np.asarray(gp[k]), 4)[rank],
                    err_msg=k, **TOL_MOE)

    def test_placement_keeps_this_ranks_experts(self, case):
        for r in case[3]:
            assert r["moe_shapes"] == {"router_W": (16, 4),
                                       "W1": (1, 16, 32), "b1": (1, 1, 32),
                                       "W2": (1, 32, 16), "b2": (1, 1, 16)}
            assert r["moe_init"]["W1"] == (4, 8, 16)
        assert pexpert.moe_param_specs()["W1"] == ("model", None, None)

    def test_moe_trains_with_aux_loss(self, case):
        """Each rank trains its experts through the all-to-alls; the loss
        follows the JAX package's and falls."""
        p, jmesh, _, port = case
        tr = p["moe_train"]
        params = jexpert.place_moe_params(
            jax.tree_util.tree_map(jnp.asarray, tr["params"]), jmesh)
        xj, yt = jnp.asarray(tr["x"]), jnp.asarray(tr["y"])

        @jax.jit
        def step(pp):
            def loss_fn(q):
                yy, a = jexpert.switch_moe(q, xj)
                return ((yy + xj - yt) ** 2).mean() + 0.01 * a
            loss, grads = jax.value_and_grad(loss_fn)(pp)
            return jax.tree_util.tree_map(lambda a, g: a - 0.05 * g, pp,
                                          grads), loss

        losses = []
        with jmesh.mesh:
            for _ in range(tr["steps"]):
                params, l = step(params)
                losses.append(float(l))
        for r in port:
            got = r["moe_train"]
            np.testing.assert_allclose(got[:10], losses[:10], rtol=1e-4)
            assert got[-1] < got[0] * 0.75, (got[0], got[-1])
