"""The port's async fit loop, listeners, early stopping and ``evaluate``
against the JAX package. Ported from tests/test_async_dispatch.py.

``fit_batch`` keeps the loss on the device and returns a lazy ScoreHandle;
a window of ``DL4J_TORCH_ASYNC_STEPS`` steps (default 2) drains oldest
first, and listeners see each (iteration, epoch, score) at drain time with
the step's own attribution, the epoch-end listeners after the epoch's
drain. The sync mode (0, or a listener with ``needs_eager_score``) returns
floats. Both modes give the same floats and the same bits in every
parameter, and the same numbers as the JAX package (1e-5). A drain error
surfaces as ``AsyncStepError`` of the step it belongs to. A partial tail
batch pads up to the pow2 bucket of the largest batch with a zeroed labels
mask: the unpadded batch's loss and gradients. ``_fetch_scalar`` is the one
host fetch of the fit path: one per step, none at dispatch while the
window has room.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.env import env as jax_env
from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JaxArrayIter
from deeplearning4j_tpu.nn import (
    InputType as JaxInputType, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import (
    BatchNormalizationLayer as JaxBN, DenseLayer as JaxDense,
    LSTMLayer as JaxLSTM, OutputLayer as JaxOutput, RnnOutputLayer as JaxRnnOut,
)
from deeplearning4j_tpu.optimize import Sgd as JaxSgd
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JaxCollect,
)
from deeplearning4j_tpu_torch import faults
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.optimize import async_dispatch
from deeplearning4j_tpu_torch.optimize.async_dispatch import (
    AsyncStepError, ScoreHandle, pad_tail_batch,
)
from deeplearning4j_tpu_torch.optimize.earlystopping import (
    EarlyStoppingConfiguration, EarlyStoppingTrainer,
    MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener, CollectScoresListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TrainingListener,
)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _reset_env(monkeypatch):
    """Each test starts from the async default (window 2, padding on) in
    both packages."""
    for var in ("DL4J_TORCH_ASYNC_STEPS", "DL4J_TORCH_PAD_TAIL",
                "DL4J_TPU_ASYNC_STEPS", "DL4J_TPU_PAD_TAIL"):
        monkeypatch.delenv(var, raising=False)
    env.reload()
    jax_env.reload()
    yield
    env.reload()
    jax_env.reload()


def _async(monkeypatch, steps):
    monkeypatch.setenv("DL4J_TORCH_ASYNC_STEPS", str(steps))
    monkeypatch.setenv("DL4J_TPU_ASYNC_STEPS", str(steps))
    env.reload()
    jax_env.reload()


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


def _jax_conf(seed=5, n_in=4, bn=False):
    b = (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.1)).list()
         .layer(JaxDense(n_out=8, activation="relu")))
    if bn:
        b = b.layer(JaxBN())
    return (b.layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(n_in)).build())


def _jax_graph_conf(seed=3):
    return (JaxNNC.builder().seed(seed).updater(JaxSgd(lr=0.1))
            .graph_builder().add_inputs("in")
            .set_input_types(**{"in": JaxInputType.feed_forward(4)})
            .add_layer("d", JaxDense(n_out=8, activation="relu"), "in")
            .add_layer("o", JaxOutput(n_out=3, activation="softmax",
                                      loss="mcxent"), "d")
            .set_outputs("o").build())


def _pair(graph=False, **kw):
    """A JAX network and the port's, with the JAX weights."""
    if graph:
        jn = JaxGraph(_jax_graph_conf(**kw)).init()
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jn.conf.to_json())).init(device="cpu")
    else:
        jn = JaxNet(_jax_conf(**kw)).init()
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jn.conf.to_json())).init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    return jn, load_jax_opt_state(net, _np(jn.opt_state))


def _model(seed=5, **kw):
    return _pair(seed=seed, **kw)[1]


def _data(n=16, rng_seed=0, n_in=4):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _leaves(net):
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    return [a.detach().clone() for a in tree_leaves(net.params)]


# --------------------------------------------------------------- handles
def test_fit_batch_returns_lazy_handle_with_numeric_surface():
    net = _model()
    x, y = _data()
    h = net.fit_batch((x, y))
    assert isinstance(h, ScoreHandle) and not h.ready()
    assert "in-flight" in repr(h)
    v = float(h)
    assert h.ready() and np.isfinite(v) and repr(h).endswith(f"{v!r})")
    h = net.fit_batch((x, y))
    v = h.value()
    assert h + 1 == v + 1 and 1 + h == 1 + v and 1 - h == 1 - v
    assert h * 2 == v * 2 and -h == -v and abs(h) == abs(v)
    assert h / 2 == v / 2 and round(h, 3) == round(v, 3)
    assert (h < v + 1) and (h <= v) and (h > v - 1) and (h >= v)
    assert h == v and not (h != v) and f"{h:.4f}" == f"{v:.4f}"
    assert np.isfinite(np.asarray(h))


def test_window_caps_in_flight_steps_and_resizes(monkeypatch):
    net = _model()
    x, y = _data()
    handles = [net.fit_batch((x, y)) for _ in range(5)]
    assert len(net._score_window) == 2
    assert [h.ready() for h in handles] == [True, True, True, False, False]
    assert float(handles[4]) == net._score_value
    assert len(net._score_window) == 0
    net.fit_batch((x, y))
    net.fit_batch((x, y))
    _async(monkeypatch, 1)
    net.fit_batch((x, y))
    assert len(net._score_window) == 1


def test_sync_mode_returns_floats_like_jax(monkeypatch):
    _async(monkeypatch, 0)
    jn, net = _pair()
    x, y = _data()
    out, jout = net.fit_batch((x, y)), jn.fit_batch((x, y))
    assert isinstance(out, float) and isinstance(jout, float)
    assert out == pytest.approx(jout, rel=1e-5)
    assert getattr(net, "_score_window", None) is None


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
def test_async_and_sync_agree_bitwise_and_with_jax(monkeypatch, graph):
    """Three epochs through an iterator with a partial last batch: the
    same (iteration, score) pairs and parameter bits in both modes, and
    the JAX package's scores and parameters."""
    x, y = _data(40, rng_seed=7)
    runs = {}
    for steps in (0, 3):
        _async(monkeypatch, steps)
        jn, net = _pair(graph=graph)
        lst, jlst = CollectScoresListener(), JaxCollect()
        net.set_listeners(lst)
        jn.set_listeners(jlst)
        net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3)
        jn.fit(JaxArrayIter(x, y, batch_size=16), epochs=3)
        assert [i for i, _ in lst.scores] == [i for i, _ in jlst.scores]
        np.testing.assert_allclose([s for _, s in lst.scores],
                                   [s for _, s in jlst.scores], rtol=1e-5)
        _close(net.params, _np(jn.params))
        assert (net.step_count, net.epoch_count) == (9, 3)
        runs[steps] = (lst.scores, _leaves(net))
    assert runs[0][0] == runs[3][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[3][1]))


def test_equivalence_under_injected_data_io_fault(monkeypatch):
    x, y = _data(32, rng_seed=1)

    def run(steps):
        _async(monkeypatch, steps)
        net, lst = _model(seed=11), CollectScoresListener()
        net.set_listeners(lst)
        it = ArrayDataSetIterator(x, y, batch_size=8)
        it._retry = faults.RetryPolicy(max_attempts=4, base_delay_s=0.001)
        with faults.injected("data_io:2") as plan:
            net.fit(it, epochs=2)
        assert plan.injected["data_io"] == 2
        return lst.scores, _leaves(net)

    (s0, p0), (s2, p2) = run(0), run(2)
    assert s0 == s2 and all(torch.equal(a, b) for a, b in zip(p0, p2))


def test_numeric_fault_poisons_the_same_step_as_jax():
    """A ``loss_spike`` plan at step 1 poisons that step's host batch in
    both packages; the trajectories stay equal."""
    from deeplearning4j_tpu import faults as jax_faults

    jn, net = _pair()
    x, y = _data(8)
    with faults.injected("loss_spike:1@step==1"), \
            jax_faults.injected("loss_spike:1@step==1"):
        got = [float(net.fit_batch((x, y))) for _ in range(3)]
        want = [float(jn.fit_batch((x, y))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] > 10 * got[0]
    _close(net.params, _np(jn.params), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- error attribution
def test_in_flight_failure_surfaces_with_original_step(monkeypatch):
    net = _model()
    x, y = _data()
    real = async_dispatch._fetch_scalar
    calls = []

    def failing_fetch(arr):
        calls.append(1)
        if len(calls) == 2:
            raise FloatingPointError("injected device failure")
        return real(arr)

    monkeypatch.setattr(async_dispatch, "_fetch_scalar", failing_fetch)
    h0, h1, h2 = (net.fit_batch((x, y)) for _ in range(3))
    assert h0.ready()
    with pytest.raises(AsyncStepError) as exc_info:
        net.fit_batch((x, y))
    err = exc_info.value
    assert err.step == 1 and err.epoch == 0 and err.trace_id is None
    assert isinstance(err.__cause__, FloatingPointError)
    with pytest.raises(AsyncStepError):
        h1.value()
    assert np.isfinite(float(h2))


def test_drain_error_does_not_poison_later_deliveries(monkeypatch):
    net, lst = _model(), CollectScoresListener()
    net.set_listeners(lst)
    x, y = _data()
    real = async_dispatch._fetch_scalar
    calls = []

    def failing_fetch(arr):
        calls.append(1)
        if len(calls) == 2:
            raise FloatingPointError("injected device failure")
        return real(arr)

    monkeypatch.setattr(async_dispatch, "_fetch_scalar", failing_fetch)
    errors = []
    for _ in range(8):
        try:
            net.fit_batch((x, y))
        except AsyncStepError as e:
            errors.append(e)
    net._score_window.drain()
    assert [e.step for e in errors] == [1] and net.step_count == 8
    assert [i for i, _ in lst.scores] == [i for i in range(8) if i != 1]


def test_listener_call_order_and_attribution():
    events = []

    class Recorder(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            assert isinstance(score, float)
            events.append(("iter", iteration, epoch))

        def on_epoch_start(self, model, epoch):
            events.append(("epoch_start", epoch))

        def on_epoch_end(self, model, epoch):
            events.append(("epoch_end", epoch))

        def on_fit_end(self, model):
            events.append(("fit_end",))

    net = _model()
    net.set_listeners(Recorder())
    x, y = _data(24)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=2)
    assert events == [
        ("epoch_start", 0), ("iter", 0, 0), ("iter", 1, 0), ("iter", 2, 0),
        ("epoch_end", 0), ("epoch_start", 1), ("iter", 3, 1), ("iter", 4, 1),
        ("iter", 5, 1), ("epoch_end", 1), ("fit_end",)]
    events.clear()
    net.fit(x, y, epochs=2)          # the (features, labels) overload
    assert events == [("iter", 6, 2), ("iter", 7, 2), ("fit_end",)]


def test_eager_listener_forces_sync_and_drains_the_window():
    class Eager(TrainingListener):
        needs_eager_score = True

        def __init__(self):
            self.seen = []

        def iteration_done(self, model, iteration, epoch, score):
            assert isinstance(score, float)
            self.seen.append((iteration, score))

    net = _model()
    x, y = _data()
    h = net.fit_batch((x, y))
    assert not h.ready()
    eager = Eager()
    net.set_listeners(eager)
    out = net.fit_batch((x, y))
    assert h.ready() and isinstance(out, float)
    assert eager.seen == [(1, out)]
    for cls in (EvaluativeListener, CheckpointListener):
        assert cls.needs_eager_score
    for cls in (ScoreIterationListener, CollectScoresListener,
                PerformanceListener):
        assert not cls.needs_eager_score


def test_score_and_performance_listeners_report(tmp_path):
    lines = []
    net = _model()
    perf = PerformanceListener(frequency=2, log=lines.append)
    perf.batch_size = 8
    net.set_listeners(ScoreIterationListener(2, log=lines.append), perf)
    x, y = _data(40)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=1)
    assert [ln for ln in lines if ln.startswith("Score")] == [
        ln for ln in lines if ln.startswith("Score at iteration")]
    assert sum(ln.startswith("Score") for ln in lines) == 3  # 0, 2, 4
    assert perf.last_iters_per_sec > 0 and perf.last_samples_per_sec > 0
    assert "host_rss_mb" in perf.last_system
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                            keep_last=1)
    net.set_listeners(ck)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=1)
    assert len(ck.saved) == 1 and os.path.exists(ck.saved[0])


# ---------------------------------------------------------- host syncs
def test_dispatch_never_fetches_and_one_fetch_per_step(monkeypatch):
    fetches = []
    real = async_dispatch._fetch_scalar
    monkeypatch.setattr(async_dispatch, "_fetch_scalar",
                        lambda a: (fetches.append(1), real(a))[1])
    _async(monkeypatch, 8)
    net = _model()
    x, y = _data()
    for _ in range(5):
        net.fit_batch((x, y))
    assert fetches == []
    async_dispatch.drain_scores(net)
    assert len(fetches) == 5
    fetches.clear()
    net.fit(ArrayDataSetIterator(*_data(24), batch_size=8), epochs=2)
    assert len(fetches) == 6           # one a step; the epoch adds none


def test_tbptt_single_fetch_per_call(monkeypatch):
    conf = (JaxNNC.builder().seed(4).updater(JaxSgd(lr=0.05)).list()
            .layer(JaxLSTM(n_out=8))
            .layer(JaxRnnOut(n_out=2, activation="softmax", loss="mcxent"))
            .backprop_type_tbptt(4)
            .set_input_type(JaxInputType.recurrent(3)).build())
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 12, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 12))]
    fetches = []
    real = async_dispatch._fetch_scalar
    monkeypatch.setattr(async_dispatch, "_fetch_scalar",
                        lambda a: (fetches.append(1), real(a))[1])
    _async(monkeypatch, 0)
    net.fit_batch((x, y))
    assert len(fetches) == 1


def test_score_value_reads_drain():
    net = _model()
    x, y = _data()
    net.fit_batch((x, y))
    net.fit_batch((x, y))
    assert len(net._score_window) == 2
    v = net.score_value
    assert np.isfinite(v) and len(net._score_window) == 0
    assert net.score() == v
    s = net.score((x, y))
    assert isinstance(s, float) and np.isfinite(s)
    g = _model(graph=True)
    g.fit_batch((x, y))
    assert len(g._score_window) == 1 and np.isfinite(g.score_value)
    assert len(g._score_window) == 0


# --------------------------------------------------------- tail padding
def test_pad_tail_batch_shapes_masks_and_passthrough():
    x, y = np.ones((5, 4), np.float32), np.ones((5, 3), np.float32)
    px, py, pm, plm = pad_tail_batch(x, y, None, None, 32)
    assert px.shape == (8, 4) and py.shape == (8, 3) and pm is None
    np.testing.assert_array_equal(plm, [1, 1, 1, 1, 1, 0, 0, 0])
    assert not px[5:].any()
    tx, ty = torch.ones(5, 4), torch.ones(5, 2, 6)
    px, py, pm, plm = pad_tail_batch(tx, ty, None, None, 6)
    assert px.shape == (6, 4) and plm.shape == (6, 2)
    assert isinstance(plm, torch.Tensor) and plm[5].sum() == 0
    assert pad_tail_batch(x, y, None, None, 5)[0] is x
    m = np.ones((5, 4), np.float32)
    assert pad_tail_batch(x, y, m, None, 32)[0] is x
    x4, y4 = np.ones((4, 4), np.float32), np.ones((4, 3), np.float32)
    assert pad_tail_batch(x4, y4, None, None, 32)[0] is x4
    fx, fy, fm, flm = pad_tail_batch(x, y, m, np.ones(5, np.float32), 32)
    assert fm.shape == (8, 4) and fm[5:].all() and not flm[5:].any()


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
def test_padded_tail_gives_the_unpadded_loss_and_update(monkeypatch, graph):
    x, y = _data(32, rng_seed=5)
    sizes = (32, 20, 9)
    runs = {}
    for pad in ("0", "1"):
        monkeypatch.setenv("DL4J_TORCH_PAD_TAIL", pad)
        env.reload()
        net = _model(graph=graph, seed=13)
        runs[pad] = ([float(net.fit_batch((x[:n], y[:n]))) for n in sizes],
                     _leaves(net))
        if pad == "1":
            assert net._fit_max_batch == 32
    assert runs["1"][0] == pytest.approx(runs["0"][0], rel=1e-6)
    for a, b in zip(runs["1"][1], runs["0"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8)


def test_batchnorm_turns_padding_off():
    net = _model(bn=True)
    assert not net._tail_padding_ok()
    x, y = _data(16)
    net.fit_batch((x, y))
    seen = []
    real = net._train_step
    net._train_step = lambda x, *a, **k: (seen.append(x.shape[0]),
                                          real(x, *a, **k))[1]
    assert np.isfinite(float(net.fit_batch((x[:5], y[:5]))))
    assert seen == [5]


@pytest.mark.parametrize("case", ["plain", "batchnorm", "dense_output"])
def test_graph_padding_rule_matches_jax(case):
    """A ComputationGraph pads a tail batch exactly where the JAX graph
    does: no BatchNorm on batch statistics, every output an OutputLayer or
    LossLayer (one rule, ``supports_tail_padding``, for both classes)."""
    b = (JaxNNC.builder().seed(3).updater(JaxSgd(lr=0.1))
         .graph_builder().add_inputs("in")
         .set_input_types(**{"in": JaxInputType.feed_forward(4)})
         .add_layer("d", JaxDense(n_out=8, activation="relu"), "in"))
    last = "d"
    if case == "batchnorm":
        b = b.add_layer("bn", JaxBN(), "d")
        last = "bn"
    if case == "dense_output":
        b = b.add_layer("o", JaxDense(n_out=3, activation="softmax"), last)
    else:
        b = b.add_layer("o", JaxOutput(n_out=3, activation="softmax",
                                       loss="mcxent"), last)
    jn = JaxGraph(b.set_outputs("o").build()).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jn.conf.to_json())).init(device="cpu")
    assert net._tail_padding_ok() == jn._tail_padding_ok()
    assert net._tail_padding_ok() == (case == "plain")


# --------------------------------------------------------- early stopping
def test_early_stopping_keeps_the_best_epoch_and_drains():
    net = _model()
    x, y = _data(32)
    scores = iter([3.0, 1.0, 2.0, 2.5, 2.6, 0.5])

    def calc(model):
        return next(scores)

    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(10),
            ScoreImprovementEpochTerminationCondition(2)],
        iteration_termination_conditions=[
            MaxScoreIterationTerminationCondition(1e9),
            MaxTimeIterationTerminationCondition(1e9)],
        score_calculator=calc)
    snapshots = {}

    class Snap(TrainingListener):
        pass

    net.set_listeners(Snap())
    trainer = EarlyStoppingTrainer(cfg, net,
                                   ArrayDataSetIterator(x, y, batch_size=8))
    orig_fit = net.fit_batch

    def fit_batch(ds):
        out = orig_fit(ds)
        snapshots[net.step_count] = _leaves(net)
        return out

    net.fit_batch = fit_batch
    result = trainer.fit()
    # best at epoch 1 (1.0); epochs 2, 3 don't improve; 4 - 1 > 2 stops
    assert (result.best_epoch, result.best_score) == (1, 1.0)
    assert result.total_epochs == 5
    assert result.termination_reason == "EpochTermination"
    assert result.termination_details == "ScoreImprovementEpochTerminationCondition"
    # the model holds the best epoch's params: the end of epoch 1, step 8
    assert all(torch.equal(a, b) for a, b in zip(_leaves(net), snapshots[8]))
    assert len(getattr(net, "_score_window", [])) == 0


def test_early_stopping_iteration_termination_and_jax_parity():
    """An iteration condition stops the first epoch at its first step; with
    a score calculator absent the trainer reads ``score_value``, as the
    JAX package's does, and the two agree."""
    from deeplearning4j_tpu.optimize.earlystopping import (
        EarlyStoppingConfiguration as JaxCfg, EarlyStoppingTrainer as JaxES,
        MaxEpochsTerminationCondition as JaxMaxEpochs,
    )

    jn, net = _pair()
    x, y = _data(24)
    r = EarlyStoppingTrainer(EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(3)]),
        net, ArrayDataSetIterator(x, y, batch_size=8)).fit()
    jr = JaxES(JaxCfg(epoch_termination_conditions=[JaxMaxEpochs(3)]), jn,
               JaxArrayIter(x, y, batch_size=8)).fit()
    assert (r.total_epochs, r.best_epoch) == (jr.total_epochs, jr.best_epoch)
    np.testing.assert_allclose(list(r.score_vs_epoch.values()),
                               list(jr.score_vs_epoch.values()), rtol=1e-5)
    _close(net.params, _np(jn.params))
    stop = EarlyStoppingTrainer(EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
        iteration_termination_conditions=[
            MaxScoreIterationTerminationCondition(-1.0)]),
        _model(), ArrayDataSetIterator(x, y, batch_size=8)).fit()
    assert stop.termination_reason == "IterationTermination"
    assert stop.total_epochs == 0


# ------------------------------------------------------------------ evaluate
def test_multilayer_evaluate_matches_jax_and_argmax():
    jn, net = _pair()
    x, y = _data(30, rng_seed=3)
    ev = net.evaluate(ArrayDataSetIterator(x, y, batch_size=8))
    jev = jn.evaluate(JaxArrayIter(x, y, batch_size=8))
    np.testing.assert_array_equal(ev.cm.matrix, jev.cm.matrix)
    assert ev.accuracy() == jev.accuracy()
    want = np.mean(net.output(x).numpy().argmax(-1) == y.argmax(-1))
    assert ev.accuracy() == pytest.approx(want)


def test_sequence_evaluate_with_masks_matches_jax():
    conf = (JaxNNC.builder().seed(8).list().layer(JaxLSTM(n_out=5))
            .layer(JaxRnnOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(4)).build())
    jn = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    load_jax_params(net, _np(jn.params))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 6))]
    fm = (np.arange(6)[None] < np.array([[6], [4], [2]])).astype(np.float32)
    lm = fm * (np.arange(6) % 2)
    for ds in ([DataSet(x, y, fm)], [DataSet(x, y, fm, lm)]):
        ev, jev = net.evaluate(ds), jn.evaluate(ds)
        np.testing.assert_array_equal(ev.cm.matrix, jev.cm.matrix)


def test_graph_evaluate_matches_jax():
    jn, net = _pair(graph=True)
    x, y = _data(20, rng_seed=6)
    ev = net.evaluate(ArrayDataSetIterator(x, y, batch_size=8))
    jev = jn.evaluate(JaxArrayIter(x, y, batch_size=8))
    np.testing.assert_array_equal(ev.cm.matrix, jev.cm.matrix)
    m = np.float32([1, 0, 1, 1, 0, 1, 1, 1, 0, 1] * 2)
    ds = [DataSet(x, y, None, m)]
    np.testing.assert_array_equal(net.evaluate(ds).cm.matrix,
                                  jn.evaluate(ds).cm.matrix)


def test_evaluative_listener_runs_evaluate():
    net = _model()
    x, y = _data(16)
    lines = []
    lst = EvaluativeListener(lambda: ArrayDataSetIterator(x, y, 8),
                             frequency=2, log=lines.append)
    net.set_listeners(lst)
    net.fit(ArrayDataSetIterator(x, y, batch_size=4), epochs=1)
    assert [i for i, _ in lst.results] == [2]
    assert lines and lines[0].startswith("eval @ iter 2")



# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_draining_a_step_waits_for_that_step_alone():
    """On the card the window copies each loss to the host behind its own
    step: retiring the oldest step waits for that step, not for the work
    queued since (about a second of device sleep here), so the host stays
    ahead of the card. ``float()`` of the device loss would wait for it
    all."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_conf().to_json())).init(device="cuda")
    x, y = _data()
    first = net.fit_batch((x, y))
    second = net.fit_batch((x, y))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second at the H100's clocks
    t0 = time.perf_counter()
    third = net.fit_batch((x, y))  # the window retires the first step
    dispatched = time.perf_counter() - t0
    assert first.ready() and not third.ready()
    assert dispatched < 0.2, dispatched
    assert np.isfinite(float(second)) and not third.ready()
    t0 = time.perf_counter()
    assert np.isfinite(float(third))
    assert time.perf_counter() - t0 > 0.2  # the sleep was queued before it
