"""The port's training guardrails against the JAX package.

The sentinel's health word and clip against ``guardrails.sentinel.screen``
on the same gradients; ``SentinelState`` and ``bisect_culprit`` case by
case; an armed, untripped run bit for bit the unarmed one on both network
classes; and under the same fault spec the same trips, ladder actions,
quarantine entries and culprit as the JAX package, with params within
1e-5 (f32, no dropout). No updater writes its state in place, so the
device-side select keeps the old trees intact. A ``cuda`` case runs the
guarded step on the card.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import faults as jax_faults
from deeplearning4j_tpu import guardrails as jax_guardrails
from deeplearning4j_tpu import monitoring as jax_monitoring
from deeplearning4j_tpu.common.env import env as jax_env
from deeplearning4j_tpu.guardrails import bisect as jax_bisect
from deeplearning4j_tpu.guardrails import sentinel as jax_sentinel
from deeplearning4j_tpu.nn import (
    InputType as JaxInputType, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JaxDense, OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.optimize import Sgd as JaxSgd
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresListener as JaxCollect,
)
from deeplearning4j_tpu_torch import faults, guardrails, monitoring
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.common.trees import tree_leaves
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.guardrails import (
    Guardrail, GuardrailPolicy, GuardrailTripped, bisect_culprit, sentinel,
)
from deeplearning4j_tpu_torch.guardrails.sentinel import (
    SentinelState, WORD_OK,
)
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.optimize.async_dispatch import (
    AsyncStepError, drain_scores,
)
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresListener

_VARS = ("DL4J_TORCH_ASYNC_STEPS", "DL4J_TORCH_PAD_TAIL",
         "DL4J_TORCH_GUARDRAILS", "DL4J_TORCH_GUARDRAILS_DIR",
         "DL4J_TORCH_MONITORING", "DL4J_TPU_ASYNC_STEPS",
         "DL4J_TPU_PAD_TAIL", "DL4J_TPU_GUARDRAILS",
         "DL4J_TPU_GUARDRAILS_DIR", "DL4J_TPU_MONITORING")


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Fresh env, fault plans, registries and flight recorders in both
    packages around every test. The variables are cleared BEFORE the
    teardown reloads ``env``: monkeypatch restores them only after this
    fixture ends, and a reload with them still set would leak a test's
    arming into the next file on the worker."""
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    for e in (env, jax_env):
        e.reload()
    for f, m in ((faults, monitoring), (jax_faults, jax_monitoring)):
        f.configure("")
        m.reset()
    yield
    for f, m in ((faults, monitoring), (jax_faults, jax_monitoring)):
        f.configure("")
        m.reset()
    for var in _VARS:
        os.environ.pop(var, None)
    for e in (env, jax_env):
        e.reload()
    monitoring.reset()
    jax_monitoring.reset()


def _async(monkeypatch, steps):
    monkeypatch.setenv("DL4J_TORCH_ASYNC_STEPS", str(steps))
    monkeypatch.setenv("DL4J_TPU_ASYNC_STEPS", str(steps))
    env.reload()
    jax_env.reload()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_conf(seed=5, updater=None):
    return (JaxNNC.builder().seed(seed).updater(updater or JaxSgd(lr=0.1))
            .list().layer(JaxDense(n_out=8, activation="relu"))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())


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


def _data(n=16, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _leaves(net):
    return [a.detach().clone() for a in tree_leaves(net.params)]


def _same_floats(a, b, rel):
    """Equal within ``rel`` (relative), NaN where the other is NaN."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b)), (a, b)
    fin = np.isfinite(a) & np.isfinite(b)
    assert np.array_equal(np.isinf(a), np.isinf(b)), (a, b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rel, atol=0)


# --------------------------------------------------------------- sentinel
def _grads_case(kind):
    rng = np.random.default_rng(3)
    g = [{"W": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)},
         {"W": rng.normal(size=(5, 3)).astype(np.float32)}]
    if kind == "inf_grad":
        g[0]["W"][2, 1] = np.inf
    if kind == "nan_grad":
        g[1]["W"][0, 0] = np.nan
    return g


# (grads kind, loss, ctrl lanes [clip, gnorm_limit, z_limit, mean, var])
SCREEN_CASES = {
    "clean": ("clean", 1.25, [0, 0, 0, 0, -1]),
    "nan_loss": ("clean", float("nan"), [0, 0, 0, 0, -1]),
    "inf_grad": ("inf_grad", 0.5, [0, 0, 0, 0, -1]),
    "nan_grad_clipped": ("nan_grad", 0.5, [1.0, 0, 0, 0, -1]),
    "gnorm_trip": ("clean", 0.5, [0, 1.0, 0, 0, -1]),
    "clip_rescues": ("clean", 0.5, [0.5, 1.0, 0, 0, -1]),
    "clip_on_limit": ("clean", 0.5, [0.7, 0.7, 0, 0, -1]),
    "clip_above_norm": ("clean", 0.5, [1e3, 0, 0, 0, -1]),
    "z_trip": ("clean", 2.0, [0, 0, 6.0, 1.0, 0.01]),
    "z_pass": ("clean", 1.05, [0, 0, 6.0, 1.0, 0.01]),
    "z_warmup": ("clean", 2.0, [0, 0, 6.0, 1.0, -1.0]),
}


@pytest.mark.parametrize("with_clip", [True, False])
@pytest.mark.parametrize("case", sorted(SCREEN_CASES))
def test_screen_matches_jax(case, with_clip):
    """The same word (1e-6 relative, NaN for NaN) and the same
    clip-scaled gradients (1e-7) as the JAX sentinel."""
    kind, loss, ctrl = SCREEN_CASES[case]
    grads = _grads_case(kind)
    jg, jw = jax.jit(jax_sentinel.screen, static_argnums=3)(
        grads, np.float32(loss), jnp.asarray(ctrl, jnp.float32), with_clip)
    pg, pw = sentinel.screen(
        [{k: torch.from_numpy(v.copy()) for k, v in d.items()}
         for d in grads],
        torch.tensor(loss, dtype=torch.float32),
        torch.tensor(ctrl, dtype=torch.float32), with_clip=with_clip)
    assert pw.dtype == torch.float32 and pw.shape == (4,)
    _same_floats(pw.numpy(), np.asarray(jw), 1e-6)
    for a, b in zip(tree_leaves(pg), jax.tree_util.tree_leaves(jg)):
        a, b = a.numpy(), np.asarray(b)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)],
                                   rtol=0, atol=1e-7)
    if not with_clip:  # the hot variant passes the raw gradients through
        for a, b in zip(tree_leaves(pg), tree_leaves(grads)):
            np.testing.assert_array_equal(a.numpy(), b)


def test_screen_gnorm_is_the_clips_global_norm():
    """One definition of the global norm: the sentinel's lane and the
    configuration clip's scale read the same number."""
    from deeplearning4j_tpu_torch.nn.multilayer import global_norm_clip

    grads = [{k: torch.from_numpy(v) for k, v in d.items()}
             for d in _grads_case("clean")]
    _, w = sentinel.screen(grads, torch.tensor(1.0),
                           torch.tensor([0, 0, 0, 0, -1.0]))
    clipped = global_norm_clip(grads, 0.5)
    scale = clipped[0]["b"] / grads[0]["b"]
    assert torch.allclose(scale, 0.5 / (w[1] + 1e-12))


def test_tree_select_keeps_old_on_a_trip_without_a_host_branch():
    new = {"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    old = {"a": torch.zeros(3), "b": [torch.full((2,), 5.0)]}
    for ok, want in ((torch.tensor(True), new), (torch.tensor(False), old)):
        got = sentinel.tree_select(ok, new, old)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                    tree_leaves(want)))


# ------------------------------------------------------- sentinel state
STATE_CASES = {
    "alpha_half_warmup_2": (0.5, 2, [1.0, 2.0, 1.5, 3.0]),
    "warmup_gate": (0.9, 3, [1.0, 1.1]),
    "variance_floor": (0.9, 2, [2.0] * 10),
    "nonfinite_ignored": (0.9, 8, [1.0, float("nan"), float("inf"), 1.2]),
    "long_run": (0.9, 8, [1.0 / (1 + i) + 0.01 * (i % 3) for i in range(30)]),
}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_sentinel_state_matches_jax(case):
    alpha, warmup, losses = STATE_CASES[case]
    port, ref = SentinelState(alpha, warmup), jax_sentinel.SentinelState(
        alpha, warmup)
    for loss in losses:
        port.update(loss)
        ref.update(loss)
        assert (port.n, port.mean, port.var) == (ref.n, ref.mean, ref.var)
        assert port.baseline() == ref.baseline()
        for probe in (0.0, 2.0, 2.02, 100.0):
            assert port.zscore(probe) == ref.zscore(probe)


# ------------------------------------------------------------- bisection
@pytest.mark.parametrize("n,culprit", [(n, c) for n in (1, 2, 5, 8)
                                       for c in range(n)])
def test_bisect_culprit_matches_jax(n, culprit):
    """Both bisections name the same culprit in the same number of rounds,
    for a batch that trips in range and for one that corrupts the state
    the trip batch then trips on."""
    for state_corrupting in (False, True):
        got = []
        for fn in (bisect_culprit, jax_bisect.bisect_culprit):
            applied = []

            def run_range(i, j, applied=applied):
                applied.extend(range(i, j))
                if state_corrupting:
                    return culprit in applied
                return culprit in range(i, j)

            got.append(fn(n, run_range, lambda: list(applied),
                          lambda s: applied.__setitem__(slice(None), s)))
        assert got[0] == got[1]
        assert got[0][0] == culprit


def test_bisect_empty_window_rejected():
    with pytest.raises(ValueError):
        bisect_culprit(0, lambda i, j: True, list, lambda s: None)


# ------------------------------------------------ updaters under a select
@pytest.mark.parametrize("name", sorted(port_updaters._ALIASES))
def test_no_updater_writes_its_state_in_place(name):
    """The guarded step selects between the new trees and the old ones on
    the device; an updater that wrote into its old state (or the params)
    in place would clobber the ``old`` side of that select."""
    u = port_updaters.get_updater(name)
    g = torch.Generator().manual_seed(0)
    params = {"W": torch.randn(4, 3, generator=g),
              "b": torch.randn(3, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    state = u.init_state(params)
    # a non-trivial state, as after a few steps
    for step in range(2):
        _, state = u.update(grads, state, params, step)
    leaves = tree_leaves((params, state))
    before = [(t.clone(), t._version) for t in leaves]
    u.update(grads, state, params, 2)
    for t, (v, ver) in zip(leaves, before):
        assert t._version == ver and torch.equal(t, v)


# ------------------------------------------------------- armed, untripped
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("steps", [0, 2])
def test_armed_untripped_is_bit_identical(monkeypatch, graph, steps):
    """Arming the sentinel on a healthy run changes no bit of the
    trajectory (the hot variant does no scaling pass, and the select keeps
    every new leaf), on both network classes, sync and async."""
    _async(monkeypatch, steps)
    x, y = _data(32, rng_seed=7)
    _, plain = _pair(graph=graph)
    pl = CollectScoresListener()
    plain.set_listeners(pl)
    plain.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3)
    _, armed = _pair(graph=graph)
    al = CollectScoresListener()
    armed.set_listeners(al)
    guard = guardrails.arm(armed)
    armed.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3)
    assert al.scores == pl.scores
    for a, b in zip(tree_leaves((armed.params, armed.opt_state)),
                    tree_leaves((plain.params, plain.opt_state))):
        assert torch.equal(a, b)
    assert guard.trips == 0 and len(guard.sentinel_trace()) == 6


# ---------------------------------------------- the ladder against JAX
def _numeric_trips(rec):
    return [(e["step"], e["action"], e["trip"], e.get("culprit_step"))
            for e in rec.tail() if e["kind"] == "numeric_trip"]


def _quarantine(path):
    if not os.path.exists(path):
        return []
    out = []
    for line in open(path):
        r = json.loads(line)
        out.append((r["step"], r["epoch"], r["method"],
                    [(b["tensor"], b["shape"], b["dtype"], b["crc32"])
                     for b in r["batch"]], r["word"]))
    return out


LADDER_CASES = {
    # name: (async window, policy, fault spec, steps, with checkpoints)
    "skip": (0, dict(skip_budget=3), "nan_grad:1@step==2", 5, False),
    "skip_async": (2, dict(skip_budget=3), "nan_grad:1@step==2", 6, False),
    "clip_retry": (0, dict(skip_budget=0, clip_retry=True, clipnorm=0.5,
                           gnorm_limit=1.0, warmup_steps=10_000),
                   "loss_spike:1@step==3", 6, False),
    "rollback": (0, dict(skip_budget=0, clip_retry=False, checkpoint_every=2,
                         warmup_steps=10_000),
                 "nan_grad:1@step==2", 4, True),
    "rollback_bisect_async": (2, dict(skip_budget=0, checkpoint_every=5,
                                      warmup_steps=4),
                              "nan_grad:1@step==7", 20, True),
    "corrupt_bisect": (0, dict(skip_budget=0, checkpoint_every=4,
                               warmup_steps=3, z_limit=3.0),
                       "data_corrupt:1@step==6", 12, True),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_ladder_matches_jax_under_the_same_fault_spec(monkeypatch, tmp_path,
                                                      case):
    """The same trip steps, ladder actions, quarantine entries and culprit
    in both packages under one fault spec, every listener score equal
    (1e-5 relative, NaN for NaN), and params within 1e-5."""
    window, policy, spec, steps, ckpt = LADDER_CASES[case]
    _async(monkeypatch, window)
    x, y = _data()
    jn, net = _pair()
    runs = []
    for which, model, g_mod, f_mod, m_mod, collect in (
            ("jax", jn, jax_guardrails, jax_faults, jax_monitoring,
             JaxCollect),
            ("port", net, guardrails, faults, monitoring,
             CollectScoresListener)):
        d = tmp_path / which
        rec = m_mod.flight.configure(enabled=True)
        lst = collect()
        model.set_listeners(lst)
        kw = dict(checkpoint_dir=str(d)) if ckpt else dict(
            quarantine_path=str(d / "quarantine.ndjson"))
        guard = g_mod.arm(model, g_mod.GuardrailPolicy(**policy), **kw)
        f_mod.configure(spec)
        for _ in range(steps):
            model.fit_batch((x, y))
        if which == "jax":
            from deeplearning4j_tpu.optimize.async_dispatch import (
                drain_scores as jax_drain,
            )

            jax_drain(model)
        else:
            drain_scores(model)
        f_mod.configure("")
        runs.append(dict(
            counts=(guard.trips, guard.rollbacks, guard.steps_lost,
                    list(guard.quarantined), guard.last_bisect_probes,
                    int(model.step_count)),
            trips=_numeric_trips(rec),
            quarantine=_quarantine(str(d / "quarantine.ndjson")),
            scores=[(i, float(v)) for i, v in lst.scores]))
        g_mod.disarm(model)
    ref, got = runs
    assert ref["counts"][0] >= 1  # the fault tripped the sentinel
    assert got["counts"] == ref["counts"]
    assert got["trips"] == ref["trips"]
    assert [q[:4] for q in got["quarantine"]] == [
        q[:4] for q in ref["quarantine"]]
    for (_, _, _, _, wp), (_, _, _, _, wj) in zip(got["quarantine"],
                                                  ref["quarantine"]):
        _same_floats([wp[k] for k in ("ok", "gnorm", "loss", "z")],
                     [wj[k] for k in ("ok", "gnorm", "loss", "z")], 1e-5)
    assert [i for i, _ in got["scores"]] == [i for i, _ in ref["scores"]]
    _same_floats([v for _, v in got["scores"]],
                 [v for _, v in ref["scores"]], 1e-5)
    for a, b in zip(tree_leaves(net.params),
                    jax.tree_util.tree_leaves(jn.params)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_exhausted_ladder_surfaces_as_async_step_error(monkeypatch):
    """A trip the ladder cannot recover becomes an AsyncStepError of the
    original step with the sentinel word; later healthy steps still reach
    the listeners, in order."""
    _async(monkeypatch, 2)
    _, net = _pair()
    lst = CollectScoresListener()
    net.set_listeners(lst)
    guardrails.arm(net, GuardrailPolicy(skip_budget=0, clip_retry=False))
    x, y = _data()
    faults.configure("nan_grad:1@step==3")
    errors = []
    for _ in range(10):
        try:
            net.fit_batch((x, y))
        except AsyncStepError as e:
            errors.append(e)
    drain_scores(net)
    assert len(errors) == 1 and errors[0].step == 3
    assert isinstance(errors[0].__cause__, GuardrailTripped)
    assert errors[0].sentinel[WORD_OK] == 0.0 and "sentinel" in str(errors[0])
    assert [i for i, _ in lst.scores] == [i for i in range(10) if i != 3]


def test_nan_is_not_laundered_by_the_clip(monkeypatch):
    _async(monkeypatch, 0)
    _, net = _pair()
    guard = guardrails.arm(net, GuardrailPolicy(skip_budget=1,
                                                clip_retry=True, clipnorm=1.0))
    x, y = _data()
    faults.configure("nan_grad:2@step>0")
    net.fit_batch((x, y))
    net.fit_batch((x, y))  # trip 1: skip
    with pytest.raises(GuardrailTripped) as e:
        net.fit_batch((x, y))  # trip 2: the clip fails too, no checkpoints
    assert e.value.step == 2 and e.value.word[WORD_OK] == 0.0
    assert guard.trips == 2 and net.step_count == 3


def test_clip_retry_equals_the_clipnorm_updater(monkeypatch):
    """The ladder's clip rung and the updater's clipnorm share one
    definition: a clip-retried step equals a clipnorm-armed step."""
    _async(monkeypatch, 0)
    x, y = _data()
    c = 0.05
    _, via_guard = _pair()
    guardrails.arm(via_guard, GuardrailPolicy(
        skip_budget=0, clip_retry=True, clipnorm=c, gnorm_limit=c,
        warmup_steps=10_000))
    via_guard.fit_batch((x, y))
    _, via_opt = _pair(updater=JaxSgd(lr=0.1, clipnorm=c))
    via_opt.fit_batch((x, y))
    for a, b in zip(_leaves(via_guard), _leaves(via_opt)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_env_arming_and_checkpoint_cadence(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TORCH_GUARDRAILS", "1")
    monkeypatch.setenv("DL4J_TORCH_GUARDRAILS_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TORCH_ASYNC_STEPS", "0")
    env.reload()
    _, net = _pair()
    x, y = _data()
    for _ in range(9):
        net.fit_batch((x, y))
    guard = guardrails.get_guard(net)
    assert isinstance(guard, Guardrail) and guard.checkpointer is not None
    assert guardrails.get_guard(net) is guard  # cached on the model
    # the floor of the ladder before the first guarded update; the cadence
    # (every 25 steps by default) is not reached
    assert guard.checkpointer.all_steps() == [0]
    guardrails.arm(net, GuardrailPolicy(checkpoint_every=3),
                   checkpoint_dir=str(tmp_path / "cadence"))
    for _ in range(9):
        net.fit_batch((x, y))
    steps = guardrails.get_guard(net).checkpointer.all_steps()
    assert steps[-1] == 18 and set(steps) <= {9, 12, 15, 18}
    assert len(steps) <= 3  # keep_last
    guardrails.disarm(net)
    assert guardrails.get_guard(net) is None


def test_unarmed_fit_makes_no_guardrail_call(monkeypatch):
    calls = []
    monkeypatch.setattr(Guardrail, "step",
                        lambda self, *a, **k: calls.append("step"))
    monkeypatch.setattr(sentinel, "screen",
                        lambda *a, **k: calls.append("screen"))
    _, net = _pair()
    x, y = _data()
    for _ in range(3):
        net.fit_batch((x, y))
    drain_scores(net)
    assert calls == [] and net._guardrail is None


def test_recovery_metric_and_flight_incident(monkeypatch):
    """An injected nan_grad shows in dl4j_recovery_total and the guardrail
    tier, and records a numeric_trip flight incident, as in the JAX
    package."""
    monkeypatch.setenv("DL4J_TORCH_MONITORING", "1")
    env.reload()
    monitoring.reset()
    rec = monitoring.flight.configure(enabled=True)
    _async(monkeypatch, 0)
    _, net = _pair()
    guardrails.arm(net, GuardrailPolicy(skip_budget=3))
    x, y = _data()
    faults.configure("nan_grad:1@step==1")
    for _ in range(4):
        net.fit_batch((x, y))
    text = monitoring.metrics_text()
    assert ('dl4j_recovery_total{component="guardrails",outcome="skip"} 1'
            in text)
    assert 'dl4j_guardrail_trips_total{kind="nonfinite"} 1' in text
    assert "dl4j_guardrail_steps_lost_total 1" in text
    assert 'dl4j_faults_injected_total{cls="nan_grad"} 1' in text
    trips = [e for e in rec.tail() if e["kind"] == "numeric_trip"]
    assert len(trips) == 1 and trips[0]["action"] == "skip"
    assert trips[0]["sentinel_trace"][-1]["step"] == 1


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_guarded_step_on_the_card(tmp_path):
    """On the card: an armed, untripped step is bit for bit the unarmed
    one, and a nan_grad step is skipped with every param finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _data()
    nets = [MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_conf().to_json())).init(device="cuda") for _ in range(2)]
    guard = guardrails.arm(nets[1], GuardrailPolicy(skip_budget=3))
    for _ in range(3):
        for n in nets:
            n.fit_batch((x, y))
    for n in nets:
        drain_scores(n)
    for a, b in zip(tree_leaves(nets[0].params), tree_leaves(nets[1].params)):
        assert torch.equal(a, b)
    with faults.injected("nan_grad:1"):
        assert math.isnan(float(nets[1].fit_batch((x, y))))
    assert guard.trips == 1
    assert all(torch.isfinite(a).all() for a in tree_leaves(nets[1].params))
