"""The port's Spark shims (``parallel/spark.py``) and ``PerEntryUpdater``
against the JAX package's.

Mirrors ``tests/test_parallel.py``'s ``TestSparkShims`` and
``TestSparkLocalSgdRouting``, ``TestMaskedLocalSGD``'s Spark case, and
``tests/test_faults.py``'s ``TestElasticLocalSgd``. Every scenario runs in
both packages from the same configuration and initial params: the JAX
side with 4 replicas (a (data 4, model 2) mesh of the conftest's 8 virtual
devices; the batch splits over "data" only), the port's in one gloo world
of 4 ranks (``torch_parallel_ranks.spark_world``). Each asserts what the
JAX test asserts, in both packages, and the port's final params against
the JAX package's: within 1e-4 relative / 1e-5 absolute after the last
epoch (f32, the two lowerings' sums in other orders over up to 60 steps),
except where dropout draws differ between the packages (the port's
dropout is a torch stream). The control: the local-SGD average that
forgets replica 1 every round misses that limit. At one replica both
Spark routes equal the plain ``fit_batch`` bit for bit, and
``PerEntryUpdater`` the network's own ``_apply_updaters``.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import monitoring as jax_monitoring
from deeplearning4j_tpu.nn import (
    InputType, MultiLayerNetwork, NeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.optimize import Sgd
from deeplearning4j_tpu.parallel import DeviceMesh as JaxMesh
from deeplearning4j_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

TOL = dict(rtol=1e-4, atol=1e-5)
# the elastic scenario's straggler sleeps this long unless it is dropped
# at its 0.01 s budget: the run must end well inside it, however loaded
STRAGGLER_DELAY_S = 30.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mln(conf):
    return MultiLayerNetwork(conf).init()


def _model(seed=9):
    return _mln(NeuralNetConfiguration.builder().seed(seed)
                .updater(Sgd(lr=0.1)).list()
                .layer(DenseLayer(n_out=16, activation="relu"))
                .layer(OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(8)).build())


def _net_case(net):
    kind = "mln" if hasattr(net, "layers") else "graph"
    return {"json": net.conf.to_json(), "kind": kind,
            "params": _np(net.params), "state": _np(net.state)}


def _graph(builder):
    from deeplearning4j_tpu.nn.graph import ComputationGraph

    return ComputationGraph(builder.build()).init()


def _two_in_graph(outputs=("o",), lr=0.1):
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex

    g = (NeuralNetConfiguration.builder().seed(4).updater(Sgd(lr=lr))
         .graph_builder().add_inputs("a", "b")
         .set_input_types(**{"a": InputType.feed_forward(3),
                             "b": InputType.feed_forward(5)})
         .add_layer("fa", DenseLayer(n_out=8, activation="relu"), "a")
         .add_layer("fb", DenseLayer(n_out=8, activation="relu"), "b")
         .add_vertex("m", MergeVertex(), "fa", "fb"))
    if outputs == ("o1", "o2"):
        g = (g.add_layer("o1", OutputLayer(n_out=2, activation="softmax",
                                           loss="mcxent"), "m")
             .add_layer("o2", OutputLayer(n_out=1, activation="identity",
                                          loss="mse"), "m"))
    else:
        g = g.add_layer("o", OutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent"), "m")
    return _graph(g.set_outputs(*outputs))


def _array(x, y, batch):
    return {"kind": "array", "x": x, "y": y, "batch": batch}


def _scenarios():
    """{name: (JAX network, scenario)}."""
    from deeplearning4j_tpu.nn.layers import (
        BatchNormalizationLayer, CenterLossOutputLayer, GravesLSTMLayer,
        LSTMLayer, RnnOutputLayer,
    )
    from deeplearning4j_tpu.optimize import Adam

    rng = np.random.default_rng(17)
    out = {}

    def add(name, net, data, score, k, epochs, bpw=8, **kw):
        out[name] = (net, dict(net=_net_case(net), data=data, score=score,
                               k=k, epochs=epochs, bpw=bpw, **kw))

    # TestSparkShims
    x = rng.normal(size=(64, 4)).astype(np.float32)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    shims = _mln(NeuralNetConfiguration.builder().seed(4)
                 .updater(Sgd(lr=0.3)).list()
                 .layer(DenseLayer(n_out=16, activation="relu"))
                 .layer(OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
                 .set_input_type(InputType.feed_forward(4)).build())
    add("shims", shims, _array(x, y, 32), _array(x, y, 32), 5, 15,
        accuracy=True)
    # TestElasticLocalSgd: a worker crash at round 1, a straggler over its
    # budget at round 2
    elastic = _mln(NeuralNetConfiguration.builder().seed(4)
                   .updater(Sgd(lr=0.3)).list()
                   .layer(DenseLayer(n_out=16, activation="relu"))
                   .layer(OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
                   .set_input_type(InputType.feed_forward(4)).build())
    add("elastic", elastic, _array(x, y, 32), _array(x, y, 32), 2, 12,
        accuracy=True, straggler=0.01,
        faults=("worker_crash:1@round==1;collective_delay:1@round==2",
                STRAGGLER_DELAY_S))

    # TestSparkLocalSgdRouting
    x = rng.normal(size=(256, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 256)]
    data = _array(x, y, 64)
    add("k4", _model(seed=11), data, data, 4, 12)
    add("k4_forgets_a_replica", _model(seed=11), data, data, 4, 12,
        force_lost=[1])
    add("k1", _model(seed=11), data, data, 1, 3)
    bn = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr=0.1))
          .list().layer(DenseLayer(n_out=16, activation="relu"))
          .layer(BatchNormalizationLayer())
          .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
          .set_input_type(InputType.feed_forward(8)).build())
    add("k1_bn", _mln(bn), data, data, 1, 3)
    drop = (NeuralNetConfiguration.builder().seed(4).updater(Sgd(lr=0.1))
            .list().layer(DenseLayer(n_out=16, activation="relu",
                                     dropout=0.25, l2=1e-4))
            .layer(BatchNormalizationLayer())
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    add("bn_dropout_l2_k4", _mln(drop), data, data, 4, 12,
        compare=False)
    frozen = (NeuralNetConfiguration.builder().seed(4).updater(Sgd(lr=0.1))
              .list().layer(DenseLayer(n_out=8, activation="relu",
                                       trainable=False))
              .layer(DenseLayer(n_out=8, activation="relu",
                                updater=Adam(lr=0.01)))
              .layer(OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
              .set_input_type(InputType.feed_forward(8)).build())
    add("frozen_per_layer", _mln(frozen), data, data, 4, 8)
    clip = (NeuralNetConfiguration.builder().seed(4).updater(Sgd(lr=0.1))
            .gradient_clipping(1.0).list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    add("clipping", _mln(clip), data, data, 4, 8)
    center = (NeuralNetConfiguration.builder().seed(4).updater(Sgd(lr=0.1))
              .list().layer(DenseLayer(n_out=8, activation="relu"))
              .layer(CenterLossOutputLayer(n_out=4, activation="softmax",
                                           loss="mcxent"))
              .set_input_type(InputType.feed_forward(8)).build())
    add("center_loss", _mln(center), data, data, 4, 1)
    xt = rng.normal(size=(200, 8)).astype(np.float32)
    yt = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 200)]
    add("uneven_tail", _model(seed=11), _array(xt, yt, 64),
        _array(xt, yt, 64), 4, 4)

    a = rng.normal(size=(256, 3)).astype(np.float32)
    b = rng.normal(size=(256, 5)).astype(np.float32)
    cls = (a[:, 0] + b[:, 0] > 0).astype(np.int64)
    y1 = np.eye(2, dtype=np.float32)[cls]
    y2 = (a[:, :1] - b[:, :1]).astype(np.float32)
    multi = {"kind": "multi", "x": [a, b], "y": [y1, y2], "batch": 64,
             "names": ["a", "b"]}
    add("multi_io_graph", _two_in_graph(("o1", "o2"), lr=0.05), multi,
        multi, 4, 16, accuracy=True)
    xs = rng.normal(size=(256, 8)).astype(np.float32)
    ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 256)]
    single = _graph(NeuralNetConfiguration.builder().seed(4)
                    .updater(Sgd(lr=0.1)).graph_builder().add_inputs("in")
                    .set_input_types(**{"in": InputType.feed_forward(8)})
                    .add_layer("d", DenseLayer(n_out=8, activation="relu"),
                               "in")
                    .add_layer("o", OutputLayer(n_out=4,
                                                activation="softmax",
                                                loss="mcxent"), "d")
                    .set_outputs("o"))
    one = {"kind": "multi", "x": [xs], "y": [ys], "batch": 64,
           "names": ["in"]}
    add("single_io_graph_multids", single, one, one, 4, 12)
    ab = {"kind": "multi", "x": [a[:128], b[:128]], "y": [y1[:128]],
          "batch": 64, "names": ["a", "b"]}
    add("k1_multids", _two_in_graph(), ab, ab, 1, 8)
    a60 = {"kind": "multi", "x": [a[:60], b[:60]], "y": [y1[:60]],
           "batch": 60, "names": ["a", "b"]}
    add("multi_pools_across_epochs", _two_in_graph(), a60, a60, 2, 4)
    one_shot = _graph(NeuralNetConfiguration.builder().seed(4)
                      .updater(Sgd(lr=0.1)).graph_builder()
                      .add_inputs("in")
                      .set_input_types(**{"in": InputType.feed_forward(8)})
                      .add_layer("d", DenseLayer(n_out=8,
                                                 activation="relu"), "in")
                      .add_layer("o", OutputLayer(n_out=4,
                                                  activation="softmax",
                                                  loss="mcxent"), "d")
                      .set_outputs("o"))
    add("one_shot_k1", one_shot, {"kind": "oneshot", "x": xs[:64],
                                  "y": ys[:64]},
        _array(xs[:64], ys[:64], 64), 1, 1)
    lstm = _graph(NeuralNetConfiguration.builder().seed(4)
                  .updater(Sgd(lr=0.05)).graph_builder()
                  .add_inputs("s", "t")
                  .set_input_types(**{"s": InputType.recurrent(2, None),
                                      "t": InputType.recurrent(2, None)})
                  .add_layer("ls", GravesLSTMLayer(n_out=4,
                                                   activation="tanh"), "s")
                  .add_layer("lt", GravesLSTMLayer(n_out=4,
                                                   activation="tanh"), "t")
                  .add_layer("o1", RnnOutputLayer(n_out=2,
                                                  activation="softmax",
                                                  loss="mcxent"), "ls")
                  .add_layer("o2", RnnOutputLayer(n_out=2,
                                                  activation="softmax",
                                                  loss="mcxent"), "lt")
                  .set_outputs("o1", "o2"))
    s = rng.normal(size=(64, 6, 2)).astype(np.float32)
    yl = np.zeros((64, 6, 2), np.float32)
    yl[..., 0] = 1.0
    m = np.ones((64, 6), np.float32)
    masked = {"kind": "multi", "x": [s, s], "y": [yl, yl], "batch": 32,
              "fmask": m, "names": ["s", "t"]}
    add("masked_multids", lstm, masked, masked, 4, 8, bpw=4)
    bad = dict(masked, fmask=None, lmask=[m, m])
    add("per_output_masks_rejected", _graph_like(lstm), bad, masked, 4, 1,
        bpw=4)
    gk = _graph(NeuralNetConfiguration.builder().seed(5)
                .updater(Sgd(lr=0.2)).graph_builder().add_inputs("in")
                .add_layer("d", DenseLayer(n_out=16, activation="relu"),
                           "in")
                .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                              loss="mcxent"), "d")
                .set_input_types(**{"in": InputType.feed_forward(8)})
                .set_outputs("out"))
    add("graph_k4", gk, {"kind": "multi", "x": [x], "y": [y], "batch": 64,
                         "names": ["in"]},
        {"kind": "multi", "x": [x], "y": [y], "batch": 64,
         "names": ["in"]}, 4, 8, graph_facade=True)

    # TestMaskedLocalSGD's Spark case: a padded-sequence LSTM at K = 4
    seq = _mln(NeuralNetConfiguration.builder().seed(3)
               .updater(Sgd(lr=0.3)).list().layer(LSTMLayer(n_out=8))
               .layer(RnnOutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
               .set_input_type(InputType.recurrent(4, 6)).build())
    xq = rng.normal(size=(256, 6, 4)).astype(np.float32)
    yq = np.eye(3, dtype=np.float32)[np.argmax(xq[..., :3], axis=-1)]
    mq = np.ones((256, 6), np.float32)
    for i, L in enumerate(rng.integers(2, 7, 256)):
        mq[i, L:] = 0.0
    batches = [(xq[i:i + 32], yq[i:i + 32], mq[i:i + 32])
               for i in range(0, 256, 32)]
    lst = {"kind": "list", "batches": batches}
    add("padded_lstm_k4", seq, lst, lst, 4, 15)
    return out


def _graph_like(net):
    from deeplearning4j_tpu.nn.graph import ComputationGraph

    return ComputationGraph(net.conf).init()


@pytest.fixture(scope="module")
def runs():
    scenarios = _scenarios()
    port_cases = {n: sc for n, (_, sc) in scenarios.items()}
    port = launch.run(ranks.spark_world, 4, device="cpu",
                      args=(port_cases,), threads=1, timeout=600)
    jax_runs = {}
    try:
        for name, (net, sc) in scenarios.items():
            if name == "k4_forgets_a_replica":
                continue
            jax_runs[name] = ranks.run_spark(
                "deeplearning4j_tpu", sc, JaxMesh(data=4, model=2), net)
            jax_monitoring.reset()
    finally:
        jax_monitoring.disable()
    from deeplearning4j_tpu_torch import monitoring as port_monitoring

    port_monitoring.disable()
    return scenarios, jax_runs, port


def _both(runs, name):
    """[the JAX package's run, every rank's run] of scenario ``name``."""
    _, jax_runs, port = runs
    return [jax_runs[name]] + [r[name] for r in port]


def _same_params(runs, name, tol=TOL):
    _, jax_runs, port = runs
    want = jax.tree_util.tree_leaves(_np(jax_runs[name]["params"]))
    for r in port:
        got = jax.tree_util.tree_leaves(r[name]["params"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **tol)
    for r in port[1:]:  # the replicas leave every round identical
        for a, b in zip(jax.tree_util.tree_leaves(r[name]["params"]),
                        jax.tree_util.tree_leaves(port[0][name]["params"])):
            np.testing.assert_array_equal(a, b)


def _trains(run, factor=1.0):
    assert np.isfinite(run["l1"]) and run["l1"] < run["l0"] * factor, (
        run["l0"], run["l1"])


class TestSparkShims:
    def test_spark_dl4j_multilayer(self, runs):
        for r in _both(runs, "shims"):
            assert r["acc"] > 0.8, r["acc"]
        _same_params(runs, "shims")


class TestSparkLocalSgdRouting:
    def test_k4_trains_and_syncs_back(self, runs):
        for r in _both(runs, "k4"):
            _trains(r, 0.8)
        _same_params(runs, "k4")

    def test_average_that_forgets_a_replica_misses(self, runs):
        _, jax_runs, port = runs
        want = jax.tree_util.tree_leaves(_np(jax_runs["k4"]["params"]))
        got = jax.tree_util.tree_leaves(
            port[0]["k4_forgets_a_replica"]["params"])
        err = max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))
                  for a, b in zip(got, want))
        assert err > 10 * TOL["rtol"], err

    def test_k1_unchanged_sync_path(self, runs):
        for r in _both(runs, "k1"):
            _trains(r)
        _same_params(runs, "k1")

    def test_k1_bn_model_stays_exact_sync(self, runs):
        for r in _both(runs, "k1_bn"):
            _trains(r)
        _same_params(runs, "k1_bn")

    def test_bn_dropout_l2_train_on_k4_path(self, runs):
        scenarios = runs[0]
        before = scenarios["bn_dropout_l2_k4"][1]["net"]["state"]
        for r in _both(runs, "bn_dropout_l2_k4"):
            _trains(r)
            moved = any(np.any(np.asarray(a) != np.asarray(b)) for a, b in
                        zip(jax.tree_util.tree_leaves(before),
                            jax.tree_util.tree_leaves(_np(r["state"]))))
            assert moved, "BN running stats did not flow back"

    def test_frozen_and_per_layer_updaters_train_on_local_sgd(self, runs):
        scenarios = runs[0]
        p0 = scenarios["frozen_per_layer"][1]["net"]["params"]
        for r in _both(runs, "frozen_per_layer"):
            _trains(r)
            p = _np(r["params"])
            for k in p0[0]:
                np.testing.assert_array_equal(p[0][k], p0[0][k])
            assert any(np.any(p[1][k] != p0[1][k]) for k in p0[1])
        _same_params(runs, "frozen_per_layer")

    def test_grad_clipping_trains_on_local_sgd(self, runs):
        for r in _both(runs, "clipping"):
            _trains(r)
        _same_params(runs, "clipping")

    def test_multi_input_output_graph_on_local_sgd(self, runs):
        for r in _both(runs, "multi_io_graph"):
            _trains(r)
            assert r["acc"] > 0.7, r["acc"]
        _same_params(runs, "multi_io_graph")

    def test_single_io_graph_with_multidataset_stream(self, runs):
        for r in _both(runs, "single_io_graph_multids"):
            _trains(r)
        _same_params(runs, "single_io_graph_multids")

    def test_k1_sync_path_with_multidataset_stream(self, runs):
        for r in _both(runs, "k1_multids"):
            _trains(r)
        _same_params(runs, "k1_multids")

    def test_multi_rebatcher_pins_dict_slot_order_and_counts_drops(self):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        from deeplearning4j_tpu_torch.parallel.spark import (
            _RebatchingMultiIterator,
        )

        a1, b1 = np.full((3, 2), 1.0, np.float32), np.full((3, 2), 10.0,
                                                           np.float32)
        a2, b2 = np.full((3, 2), 2.0, np.float32), np.full((3, 2), 20.0,
                                                           np.float32)
        y = np.zeros((3, 1), np.float32)
        stream = [MultiDataSet({"a": a1, "b": b1}, [y]),
                  MultiDataSet({"b": b2, "a": a2}, [y])]
        it = _RebatchingMultiIterator(stream, 4, dp=4)
        out = list(it)
        got_a = np.concatenate([np.asarray(o.features["a"]) for o in out])
        got_b = np.concatenate([np.asarray(o.features["b"]) for o in out])
        assert (got_a < 5).all() and (got_b >= 10).all()
        assert it.dropped_rows == 2
        bad = [MultiDataSet({"a": a1, "b": b1}, [y]),
               MultiDataSet({"a": a2, "c": b2}, [y])]
        with pytest.raises(ValueError, match="slot keys changed"):
            list(_RebatchingMultiIterator(bad, 4, dp=2))

    def test_multi_local_sgd_pools_across_epochs_and_warns(self, runs):
        scenarios = runs[0]
        p0 = scenarios["multi_pools_across_epochs"][1]["net"]["params"]
        for r in _both(runs, "multi_pools_across_epochs"):
            moved = any(np.any(np.asarray(a) != np.asarray(b)) for a, b in
                        zip(jax.tree_util.tree_leaves(p0),
                            jax.tree_util.tree_leaves(_np(r["params"]))))
            assert moved, "rounds never completed across epochs"
            assert r["warned"], "the stranded rows were not warned"
        _same_params(runs, "multi_pools_across_epochs")

    def test_one_shot_generator_keeps_first_batch_at_k1(self, runs):
        scenarios = runs[0]
        p0 = scenarios["one_shot_k1"][1]["net"]["params"]
        for r in _both(runs, "one_shot_k1"):
            assert any(np.any(np.asarray(a) != np.asarray(b)) for a, b in
                       zip(jax.tree_util.tree_leaves(p0),
                           jax.tree_util.tree_leaves(_np(r["params"]))))
        _same_params(runs, "one_shot_k1")

    def test_masked_multidataset_trains_on_local_sgd(self, runs):
        for r in _both(runs, "masked_multids"):
            _trains(r)
        _same_params(runs, "masked_multids")
        for r in _both(runs, "per_output_masks_rejected"):
            assert r["error"][0] == "ValueError"
            assert "per-output labels masks" in r["error"][1]

    def test_unsupported_configs_rejected_loudly(self, runs):
        for r in _both(runs, "center_loss"):
            assert r["error"][0] == "NotImplementedError"
            assert "center loss" in r["error"][1]

    def test_uneven_tail_dropped_with_warning(self, runs):
        for r in _both(runs, "uneven_tail"):
            assert r["warned"], r
        _same_params(runs, "uneven_tail")

    def test_graph_model_k_gt_1_trains(self, runs):
        for r in _both(runs, "graph_k4"):
            _trains(r)
        _same_params(runs, "graph_k4")

    def test_padded_lstm_trains_at_k4_via_spark(self, runs):
        for r in _both(runs, "padded_lstm_k4"):
            _trains(r, 0.8)
        _same_params(runs, "padded_lstm_k4")


class TestElasticLocalSgd:
    def test_spark_rounds_survive_crash_and_straggler(self, runs):
        """worker_crash at round 1 and a straggler over its 0.01 s budget
        at round 2, the plan consulted alike on every rank: the job ends
        well inside the straggler's delay, each replica is dropped once
        and re-admitted, the survivors' averages still converge, and the
        recovery counts are the JAX package's."""
        for r in _both(runs, "elastic"):
            assert r["injected"] == {"worker_crash": 1,
                                     "collective_delay": 1}
            assert r["supervisor"] == (2, 2)
            assert r["acc"] > 0.8, r["acc"]
            for line in (
                    'outcome="dropped_worker"} 1',
                    'outcome="dropped_straggler"} 1',
                    'outcome="readmitted"} 2'):
                assert any(line in m for m in r["metrics"]), r["metrics"]
        for r in runs[2]:
            assert r["elastic"]["wall"] < STRAGGLER_DELAY_S / 2, r["elastic"]
        _same_params(runs, "elastic")


def test_one_replica_routes_equal_plain_fit():
    """At one replica (a gloo group of 1) both Spark routes, K = 1 through
    ParallelWrapper and K = 5 through local SGD, equal the plain fit_batch
    on the same batches bit for bit (every average divides by 1): a
    config #3-shaped char-LSTM (Graves bidirectional, Adam, clipping 5.0)
    at a small width. And PerEntryUpdater over the network's own updater
    selection (a frozen layer, an Adam override, the Sgd default) equals
    its _apply_updaters bit for bit."""
    from deeplearning4j_tpu.nn.layers import (
        GravesBidirectionalLSTMLayer, RnnOutputLayer,
    )
    from deeplearning4j_tpu.optimize import Adam

    rng = np.random.default_rng(5)
    V, T = 11, 7
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(lr=1e-2))
            .gradient_clipping(5.0).list()
            .layer(GravesBidirectionalLSTMLayer(n_out=6))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    ids = rng.integers(0, V, (40, T + 1))
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    frozen = (NeuralNetConfiguration.builder().seed(4).updater(Sgd(lr=0.1))
              .list().layer(DenseLayer(n_out=8, activation="relu",
                                       trainable=False))
              .layer(DenseLayer(n_out=8, activation="relu",
                                updater=Adam(lr=0.01)))
              .layer(OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
              .set_input_type(InputType.feed_forward(8)).build())
    (out,) = launch.run(ranks.spark_world1, 1, device="cpu", args=(
        {"net": _net_case(_mln(conf)), "per_entry_net":
         _net_case(_mln(frozen)), "x": x, "y": y, "batch": 4},),
        threads=1, timeout=300)
    plain_p, plain_o = out["plain"]
    for k in (1, 5):
        for a, b in zip(jax.tree_util.tree_leaves(out[k][0]),
                        jax.tree_util.tree_leaves(plain_p)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(out[1][1]),
                    jax.tree_util.tree_leaves(plain_o)):
        np.testing.assert_array_equal(a, b)
    mine, per = out["per_entry"]
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(per)):
        np.testing.assert_array_equal(a, b)


def test_per_entry_updater_matches_jax():
    """PerEntryUpdater's step against the JAX package's on the same
    grads, params and state (1e-6)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.optimize import Adam
    from deeplearning4j_tpu.optimize.updaters import NoOp as JaxNoOp
    from deeplearning4j_tpu.optimize.updaters import (
        PerEntryUpdater as JaxPerEntry,
    )
    from deeplearning4j_tpu_torch.optimize.updaters import (
        Adam as PortAdam, NoOp, PerEntryUpdater, Sgd as PortSgd,
    )
    import torch

    rng = np.random.default_rng(8)
    params = {k: {"W": rng.normal(size=(3, 2)).astype(np.float32)}
              for k in ("a", "b", "c")}
    grads = {k: {"W": rng.normal(size=(3, 2)).astype(np.float32)}
             for k in params}
    jup = JaxPerEntry({"a": JaxNoOp(), "b": Adam(lr=0.01),
                       "c": Sgd(lr=0.1)})
    pup = PerEntryUpdater({"a": NoOp(), "b": PortAdam(lr=0.01),
                           "c": PortSgd(lr=0.1)})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.as_tensor, params)
    js, ts = jup.init_state(jp), pup.init_state(tp)
    for step in range(3):
        ju, js = jup.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                            jp, step)
        tu, ts = pup.update(jax.tree_util.tree_map(torch.as_tensor, grads),
                            ts, tp, step)
        jp = jax.tree_util.tree_map(lambda p, d: p - d, jp, ju)
        tp = {k: {"W": tp[k]["W"] - tu[k]["W"]} for k in tp}
    for k in params:
        np.testing.assert_allclose(tp[k]["W"].numpy(),
                                   np.asarray(jp[k]["W"]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(tp["a"]["W"].numpy(), params["a"]["W"])
