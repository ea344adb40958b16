"""The port's hyperparameter search (``deeplearning4j_tpu_torch/arbiter/``)
against the JAX package's, on the CPU.

The spaces, generators and runner are the JAX package's Python, copied:
the same seed gives the same draws and candidates. The network spaces
build the port's configurations: a ``MultiLayerSpace`` and a
``ComputationGraphSpace`` sampled from one numpy seed write the JAX
package's configuration JSON candidate for candidate, and a candidate's
JAX weights cross through ``load_jax_params`` to the same score within
``TOL`` (f32, relative). A space over ``GravesBidirectionalLSTMLayer``
(config #3's layers, whose ``fwd`` is derived from ``n_out``) samples
here, where the JAX package's raises; its candidates equal the JAX
configurations built from the same draws. ``tests/test_arbiter.py``'s
cases run here on the port with ``device="cpu"``.
"""

import json

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.arbiter as jarb
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
import deeplearning4j_tpu.optimize as jopt
import deeplearning4j_tpu_torch.arbiter as arb
import deeplearning4j_tpu_torch.nn.layers as layers
from deeplearning4j_tpu_torch.arbiter import (
    ContinuousParameterSpace, DiscreteParameterSpace, GridSearchGenerator,
    IntegerParameterSpace, MaxCandidatesCondition, MaxTimeCondition,
    OptimizationRunner, RandomSearchGenerator,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Sgd

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread for this file's tests: tier-1 runs six
    workers over the machine's cores, and at the default pool size their
    OpenMP threads oversubscribe them (the RL conv cases ran ~20x slower
    in six parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Pkg:
    """One package's names, so a space is written once for both."""

    def __init__(self, torch_side):
        if torch_side:
            self.arb, self.L, self.InputType = arb, layers, InputType
            self.Adam = Adam
            from deeplearning4j_tpu_torch.nn.conf.graph import (
                ElementWiseVertex,
            )
        else:
            self.arb, self.L, self.InputType = jarb, jlayers, jnn.InputType
            self.Adam = jopt.Adam
            from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex
        self.ElementWiseVertex = ElementWiseVertex


PORT, JAX = _Pkg(True), _Pkg(False)


def _json(conf):
    return json.loads(conf.to_json())


def test_exports_equal_the_jax_all():
    assert sorted(arb.__all__) == sorted(jarb.__all__)


@pytest.mark.parametrize("space", [
    lambda a: a.ContinuousParameterSpace(1e-4, 1e-1, log_scale=True),
    lambda a: a.ContinuousParameterSpace(-2.0, 3.0),
    lambda a: a.IntegerParameterSpace(3, 17),
    lambda a: a.DiscreteParameterSpace([128, 200, 256]),
], ids=["log", "linear", "integer", "discrete"])
def test_spaces_draw_and_grid_as_jax(space):
    got, want = space(arb), space(jarb)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    assert [got.sample(r1) for _ in range(20)] == \
        [want.sample(r2) for _ in range(20)]
    for n in (1, 4, 7):
        assert got.grid(n) == want.grid(n)


def _gen_spaces(a):
    return {"lr": a.ContinuousParameterSpace(1e-3, 1.0, log_scale=True),
            "width": a.IntegerParameterSpace(4, 64),
            "act": a.DiscreteParameterSpace(["relu", "tanh"])}


def test_generators_candidates_equal_jax():
    got = iter(RandomSearchGenerator(_gen_spaces(arb), seed=11))
    want = iter(jarb.RandomSearchGenerator(_gen_spaces(jarb), seed=11))
    assert [next(got) for _ in range(10)] == [next(want) for _ in range(10)]
    assert list(GridSearchGenerator(_gen_spaces(arb), 3)) == \
        list(jarb.GridSearchGenerator(_gen_spaces(jarb), 3))


def _mls(p):
    lr = p.arb.ContinuousParameterSpace(1e-4, 1e-2, log_scale=True)
    return (p.arb.MultiLayerSpace.builder()
            .updater_space(lambda r: p.Adam(lr=lr.sample(r)))
            .add_layer(p.L.LSTMLayer(n_out=p.arb.IntegerParameterSpace(4, 24)))
            .add_layer(p.L.LSTMLayer(
                n_out=p.arb.DiscreteParameterSpace([8, 16]),
                activation=p.arb.DiscreteParameterSpace(["tanh", "softsign"])))
            .add_layer(p.L.RnnOutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"))
            .set_input_type(p.InputType.recurrent(5, 6))
            .seed(2).build())


def test_multilayer_space_json_equals_jax():
    """Explicit rngs, the space's own rng, and the candidate generator:
    every candidate's configuration JSON is the JAX package's."""
    got, want = _mls(PORT), _mls(JAX)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(4):
        assert _json(got.sample(r1)) == _json(want.sample(r2))
    for _ in range(3):
        assert _json(got.sample()) == _json(want.sample())
    g1, g2 = got.candidate_generator(5), want.candidate_generator(5)
    for _ in range(3):
        assert _json(next(g1)["conf"]) == _json(next(g2)["conf"])


def _cgs(p):
    return (p.arb.ComputationGraphSpace.builder()
            .add_inputs("in")
            .set_input_types(**{"in": p.InputType.feed_forward(6)})
            .updater_space(lambda r: p.Adam(lr=float(10 ** r.uniform(-3, -2))))
            .add_layer("fc1", p.L.DenseLayer(
                n_out=p.arb.IntegerParameterSpace(8, 8), activation="relu"),
                "in")
            .add_layer("fc2", p.L.DenseLayer(
                n_out=8, activation=p.arb.DiscreteParameterSpace(
                    ["identity", "tanh"])), "fc1")
            .add_vertex("res", p.ElementWiseVertex(op="add"), "fc2", "fc1")
            .add_layer("out", p.L.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "res")
            .set_outputs("out").seed(4).build())


def test_graph_space_json_equals_jax():
    got, want = _cgs(PORT), _cgs(JAX)
    for _ in range(4):
        assert _json(got.sample()) == _json(want.sample())


def _config3_space(p):
    lr = p.arb.ContinuousParameterSpace(1e-4, 1e-2, log_scale=True)
    b = (p.arb.MultiLayerSpace.builder()
         .updater_space(lambda r: p.Adam(lr=lr.sample(r))))
    for _ in range(2):
        b = b.add_layer(p.L.GravesBidirectionalLSTMLayer(
            n_out=p.arb.DiscreteParameterSpace([128, 200, 256])))
    return (b.add_layer(p.L.RnnOutputLayer(n_out=77, activation="softmax",
                                           loss="mcxent"))
            .set_input_type(p.InputType.recurrent(77, 64)).build())


def test_graves_bidirectional_space_samples_the_jax_draws():
    """The port rebuilds ``fwd`` from the drawn ``n_out``; the JAX space
    keeps the template's and raises. The port's candidates equal the JAX
    configurations built from the same draws in the same order."""
    with pytest.raises(TypeError):
        _config3_space(JAX).sample(np.random.default_rng(0))
    space = _config3_space(PORT)
    rng, draw = np.random.default_rng(0), np.random.default_rng(0)
    widths = DiscreteParameterSpace([128, 200, 256])
    lr = ContinuousParameterSpace(1e-4, 1e-2, log_scale=True)
    for _ in range(3):
        got = space.sample(rng)
        b = (jnn.NeuralNetConfiguration.builder()
             .seed(int(draw.integers(1 << 30)))
             .updater(jopt.Adam(lr=lr.sample(draw))).list())
        for _ in range(2):
            b = b.layer(jlayers.GravesBidirectionalLSTMLayer(
                n_out=widths.sample(draw)))
        want = (b.layer(jlayers.RnnOutputLayer(n_out=77, activation="softmax",
                                               loss="mcxent"))
                .set_input_type(jnn.InputType.recurrent(77, 64)).build())
        assert _json(got) == _json(want)
        assert [l.fwd.n_out for l in got.layers[:2]] == \
            [l.n_out for l in got.layers[:2]]


def test_nested_spaces_of_their_own_stay_as_in_jax():
    """A nested layer whose spaces are its own (not the outer layer's) is
    not derived again: both packages draw the outer field alone and keep
    the template's nested layer."""
    def draw(p, seed):
        lstm = p.L.LSTMLayer(n_out=IntegerParameterSpace(3, 9))
        bi = p.L.BidirectionalLayer(
            fwd=lstm, mode=DiscreteParameterSpace(["concat", "add", "mul"]))
        mod = arb.spaces_net if p is PORT else jarb.spaces_net
        return lstm, mod._sample_layer(bi, np.random.default_rng(seed))

    for seed in range(4):
        (lp, got), (lj, want) = draw(PORT, seed), draw(JAX, seed)
        assert got.mode == want.mode and isinstance(got.mode, str)
        assert got.fwd is lp and want.fwd is lj


def test_candidate_weights_cross_to_the_same_score():
    """Each candidate's JAX net, its weights loaded into the port's net of
    the port's candidate: the same score within TOL."""
    import jax

    got, want = _mls(PORT), _mls(JAX)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (7, 6))]
    for _ in range(3):
        cj, cp = want.sample(), got.sample()
        jnet = jnn.MultiLayerNetwork(cj).init()
        pnet = MultiLayerNetwork(cp).init(device="cpu")
        load_jax_params(pnet, jax.tree_util.tree_map(np.asarray, jnet.params))
        sj, sp = jnet.score((x, y)), pnet.score((x, y))
        assert abs(sp - sj) <= TOL * abs(sj)


def test_runner_picks_the_jax_runners_best():
    """Both runners over the same generator and a deterministic score:
    the same results in the same order and the same best."""
    score = lambda hp: (np.log10(hp["lr"]) + 1.5) ** 2 + hp["width"] / 1e3
    got = OptimizationRunner(RandomSearchGenerator(_gen_spaces(arb), 2),
                             lambda hp: hp, score,
                             [MaxCandidatesCondition(12)])
    want = jarb.OptimizationRunner(
        jarb.RandomSearchGenerator(_gen_spaces(jarb), 2), lambda hp: hp,
        score, [jarb.MaxCandidatesCondition(12)])
    bg, bw = got.execute(), want.execute()
    assert (bg.index, bg.score, bg.hyperparams) == \
        (bw.index, bw.score, bw.hyperparams)
    assert [r.score for r in got.results] == [r.score for r in want.results]


# ---------------------------------- tests/test_arbiter.py's cases, on the port

class TestSpaces:
    def test_continuous(self):
        rng = np.random.default_rng(0)
        s = ContinuousParameterSpace(0.1, 10.0, log_scale=True)
        vals = [s.sample(rng) for _ in range(100)]
        assert all(0.1 <= v <= 10.0 for v in vals)
        g = s.grid(3)
        assert g[0] == pytest.approx(0.1) and g[-1] == pytest.approx(10.0)
        assert g[1] == pytest.approx(1.0)

    def test_integer_grid(self):
        s = IntegerParameterSpace(1, 10)
        assert s.grid(100) == list(range(1, 11))
        assert set(s.grid(3)) <= set(range(1, 11))

    def test_discrete(self):
        assert DiscreteParameterSpace(["a", "b"]).grid() == ["a", "b"]


class TestGenerators:
    def test_grid_product(self):
        gen = GridSearchGenerator({"x": DiscreteParameterSpace([1, 2]),
                                   "y": DiscreteParameterSpace(["a", "b"])})
        combos = list(gen)
        assert len(combos) == 4
        assert {"x": 1, "y": "a"} in combos

    def test_random_infinite(self):
        gen = iter(RandomSearchGenerator({"x": IntegerParameterSpace(0, 5)},
                                         seed=1))
        vals = [next(gen)["x"] for _ in range(20)]
        assert all(0 <= v <= 5 for v in vals)
        assert len(set(vals)) > 1


class TestRunner:
    def test_quadratic_minimum(self):
        runner = OptimizationRunner(
            RandomSearchGenerator({"x": ContinuousParameterSpace(-10, 10)},
                                  seed=0),
            build_fn=lambda hp: hp["x"],
            score_fn=lambda x: (x - 3.0) ** 2,
            termination_conditions=[MaxCandidatesCondition(200)])
        best = runner.execute()
        assert abs(best.hyperparams["x"] - 3.0) < 0.5
        assert len(runner.results) == 200
        assert runner.best().score == best.score

    def test_max_time_condition(self):
        runner = OptimizationRunner(
            RandomSearchGenerator({"x": ContinuousParameterSpace(0, 1)}),
            build_fn=lambda hp: hp["x"], score_fn=lambda x: x,
            termination_conditions=[MaxTimeCondition(0.0)])
        with pytest.raises(RuntimeError):
            runner.execute()

    def test_model_search(self, rng):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            NeuralNetConfiguration,
        )

        x = rng.normal(size=(64, 4)).astype(np.float32)
        w = rng.normal(size=(4, 3)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]

        def build(hp):
            conf = (NeuralNetConfiguration.builder().seed(1)
                    .updater(Sgd(lr=hp["lr"])).list()
                    .layer(layers.DenseLayer(n_out=hp["width"],
                                             activation="relu"))
                    .layer(layers.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"))
                    .set_input_type(InputType.feed_forward(4)).build())
            model = MultiLayerNetwork(conf).init(device="cpu")
            for _ in range(30):
                model.fit_batch((x, y))
            return model

        runner = OptimizationRunner(
            GridSearchGenerator({"width": DiscreteParameterSpace([4, 16]),
                                 "lr": DiscreteParameterSpace([0.001, 0.3])}),
            build_fn=build, score_fn=lambda m: m.score((x, y)),
            termination_conditions=[MaxCandidatesCondition(4)])
        best = runner.execute()
        assert len(runner.results) == 4
        assert best.hyperparams["lr"] == 0.3


class TestMultiLayerSpace:
    def test_sample_and_search(self, rng):
        lr_space = ContinuousParameterSpace(1e-3, 1e-1, log_scale=True)
        space = (arb.MultiLayerSpace.builder()
                 .updater_space(lambda r: Adam(lr=lr_space.sample(r)))
                 .add_layer(layers.DenseLayer(
                     n_out=IntegerParameterSpace(4, 32), activation="relu"))
                 .add_layer(layers.OutputLayer(n_out=3, activation="softmax",
                                               loss="mcxent"))
                 .set_input_type(InputType.feed_forward(6))
                 .build())
        conf = space.sample(np.random.default_rng(0))
        assert 4 <= conf.layers[0].n_out <= 32

        x = rng.normal(size=(48, 6)).astype(np.float32)
        w = rng.normal(size=(6, 3)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]

        def build(hp):
            model = MultiLayerNetwork(hp["conf"]).init(device="cpu")
            for _ in range(25):
                model.fit_batch((x, y))
            return model

        runner = OptimizationRunner(
            space.candidate_generator(seed=1), build,
            score_fn=lambda m: m.score((x, y)),
            termination_conditions=[MaxCandidatesCondition(4)])
        best = runner.execute()
        assert np.isfinite(best.score)
        assert len(runner.results) == 4


class TestEvaluationCalibration:
    def test_reliability_and_ece(self, rng):
        from deeplearning4j_tpu_torch.eval import EvaluationCalibration

        n = 2000
        conf = rng.uniform(0.5, 1.0, n)
        correct = rng.random(n) < conf
        labels = np.zeros((n, 2), np.float32)
        preds = np.zeros((n, 2), np.float32)
        preds[:, 0] = conf
        preds[:, 1] = 1 - conf
        labels[np.arange(n), np.where(correct, 0, 1)] = 1.0
        ev = EvaluationCalibration(n_bins=10).eval(labels, preds)
        c, a, counts = ev.reliability_curve()
        assert counts.sum() == n
        assert ev.expected_calibration_error() < 0.08


class TestComputationGraphSpace:
    def test_samples_build_and_train(self, rng):
        space = _cgs(PORT)
        for _ in range(4):
            model = ComputationGraph(space.sample()).init(device="cpu")
            x = rng.normal(size=(8, 6)).astype(np.float32)
            y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
            loss = model.fit_batch(({"in": x}, {"out": y}))
            assert np.isfinite(float(loss))
        lrs = {float(space.sample().updater.lr) for _ in range(6)}
        assert len(lrs) > 1

    def test_space_fields_vary(self):
        space = (arb.ComputationGraphSpace.builder()
                 .add_inputs("in")
                 .set_input_types(**{"in": InputType.feed_forward(4)})
                 .add_layer("fc", layers.DenseLayer(
                     n_out=IntegerParameterSpace(4, 64), activation="relu"),
                     "in")
                 .add_layer("out", layers.OutputLayer(
                     n_out=2, activation="softmax", loss="mcxent"), "fc")
                 .set_outputs("out")
                 .build())
        outs = {space.sample().vertices["fc"].layer.n_out for _ in range(12)}
        assert len(outs) > 1
