"""The port's training path against the JAX package, on shared numpy inputs.

Losses, updaters (with learning-rate schedules), global-norm clipping, the
Bidirectional layer, l1/l2 terms, carrying params and updater state across,
three ``fit_batch`` steps of both char-RNN models, and model zips written by
one package and restored by the other. f32 throughout; tolerance 1e-5
(relative for losses, absolute and relative for params and updater state):
the two packages differ only in the order of their sums. On the CPU the
port's LSTM layers take the plain lowering, differentiated by torch
autograd; the kernel path's gradients are held to the same references in
tests/test_torch_fused_lstm_bwd.py.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    BidirectionalLayer as JaxBidi, DenseLayer as JaxDense,
    GravesBidirectionalLSTMLayer as JaxGravesBidi, GravesLSTMLayer as JaxGraves,
)
from deeplearning4j_tpu.nn.multilayer import global_norm_clip as jax_clip
from deeplearning4j_tpu.ops import losses as jax_losses
from deeplearning4j_tpu.optimize import schedules as jax_schedules
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.util.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.zoo.textgen import (
    BidirectionalGravesLSTMCharRnn as JaxCharRnn, TextGenerationLSTM as JaxTextGen,
)
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BidirectionalLayer, GravesBidirectionalLSTMLayer, GravesLSTMLayer, Layer,
    LSTMLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, global_norm_clip, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.ops import losses
from deeplearning4j_tpu_torch.optimize import schedules, updaters
from deeplearning4j_tpu_torch.util.serialization import restore_multi_layer_network
from deeplearning4j_tpu_torch.zoo import (
    BidirectionalGravesLSTMCharRnn, TextGenerationLSTM,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_trees_close(port, ref, **tol):
    """``port`` (tensors) against ``ref`` (arrays), same structure."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_trees_close(port[k], ref[k], **tol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_trees_close(a, b, **tol)
    else:
        np.testing.assert_allclose(port.detach().cpu().numpy(),
                                   np.asarray(ref), **(tol or TOL))


# ------------------------------------------------------------------ losses

def _loss_inputs(name, from_logits, seed=0):
    rng = np.random.default_rng(seed)
    B, C = 6, 5
    raw = rng.normal(size=(B, C)).astype(np.float32)
    if from_logits:
        output = raw
    elif name in ("mse", "l2", "l1", "mae", "mape", "msle", "cosineproximity",
                  "hinge", "squaredhinge"):
        output = raw
    else:  # probabilities
        e = np.exp(raw)
        output = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood", "kldivergence"):
        labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    elif name == "sparsemcxent":
        labels = rng.integers(0, C, B).astype(np.int32)
    elif name in ("hinge", "squaredhinge"):
        labels = np.sign(rng.normal(size=(B, C))).astype(np.float32)
    elif name in ("xent", "poisson"):
        labels = rng.uniform(0.05, 0.95, (B, C)).astype(np.float32)
    else:
        labels = rng.normal(size=(B, C)).astype(np.float32)
    mask = (rng.uniform(size=B) > 0.3).astype(np.float32)
    return labels, output, mask


@pytest.mark.parametrize("from_logits", [False, True], ids=["probs", "logits"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_loss_catalog_matches_jax(name, from_logits, masked):
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)
    labels, output, mask = _loss_inputs(name, from_logits,
                                        seed=len(name) + from_logits)
    m = mask if masked else None
    kw = {"from_logits": True} if from_logits else {}
    want = jax_losses.get_loss(name)(
        jnp.asarray(labels), jnp.asarray(output),
        None if m is None else jnp.asarray(m), **kw)
    got = losses.get_loss(name)(
        torch.tensor(labels), torch.tensor(output),
        None if m is None else torch.tensor(m), **kw)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_loss_errors():
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss("nope")
    with pytest.raises(ValueError, match="INDICES"):
        losses.sparse_mcxent(torch.zeros(2, 3), torch.zeros(2, 3))
    assert losses.get_loss(losses.mse) is losses.mse


# -------------------------------------------------------- schedules/updaters

SCHEDULES = [
    ("ConstantSchedule", dict(value=0.01)),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.9)),
    ("InverseSchedule", dict(initial_value=0.1, gamma=0.5, power=2.0)),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=3)),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.7, step_size=2)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step_size=2)),
    ("MapSchedule", dict(values=((0, 0.1), (2, 0.05), (4, 0.01)))),
    ("WarmupCosineSchedule", dict(peak_value=0.1, warmup_steps=2,
                                  total_steps=6, end_value=0.01)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, kw):
    mine = getattr(schedules, name)(**kw)
    ref = getattr(jax_schedules, name)(**kw)
    for step in range(8):
        np.testing.assert_allclose(mine(step), float(ref(jnp.asarray(step))),
                                   rtol=1e-6)
    back = schedules.Schedule.from_dict(ref.to_dict())
    assert type(back) is type(mine)
    assert [back(s) for s in range(8)] == pytest.approx(
        [mine(s) for s in range(8)])


UPDATERS = [
    ("NoOp", {}), ("Sgd", dict(lr=0.05)), ("Nesterovs", dict(lr=0.05)),
    ("Adam", {}), ("AdamW", dict(lr=0.01)), ("AMSGrad", dict(lr=0.01)),
    ("AdaMax", dict(lr=0.01)), ("Nadam", dict(lr=0.01)),
    ("RMSProp", dict(lr=0.01)), ("AdaGrad", {}), ("AdaDelta", {}),
    ("Adam", dict(lr=("ExponentialSchedule",
                      dict(initial_value=0.01, gamma=0.5)))),
    ("Sgd", dict(lr=("MapSchedule", dict(values=((0, 0.1), (1, 0.02)))))),
]


def _updater_pair(name, kw):
    kw = dict(kw)
    lr = kw.pop("lr", None)
    mk = lambda mod, smod: getattr(mod, name)(**kw, **(
        {} if lr is None else {"lr": getattr(smod, lr[0])(**lr[1])
                               if isinstance(lr, tuple) else lr}))
    return mk(updaters, schedules), mk(jax_updaters, jax_schedules)


@pytest.mark.parametrize("name,kw", UPDATERS,
                         ids=[f"{u[0]}{'-schedule' if isinstance(u[1].get('lr'), tuple) else ''}"
                              for u in UPDATERS])
def test_updaters_match_jax_over_three_steps(name, kw):
    mine, ref = _updater_pair(name, kw)
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    params = {"W": f(3, 4), "b": f(4), "fwd": {"RW": f(2, 8)}}
    p_port, p_jax = _t_tree(params), jax.tree_util.tree_map(jnp.asarray, params)
    s_port, s_jax = mine.init_state(p_port), ref.init_state(p_jax)
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda a: f(*a.shape), params)
        u_port, s_port = mine.update(_t_tree(grads), s_port, p_port, step)
        u_jax, s_jax = ref.update(
            jax.tree_util.tree_map(jnp.asarray, grads), s_jax, p_jax,
            jnp.asarray(step, jnp.int32))
        _assert_trees_close(u_port, u_jax, atol=1e-6, rtol=1e-5)
        _assert_trees_close(s_port, s_jax, atol=1e-6, rtol=1e-5)
        p_port = tree_map(lambda p, d: p - d, p_port, u_port)
        p_jax = jax.tree_util.tree_map(lambda p, d: p - d, p_jax, u_jax)
    back = updaters.updater_from_dict(ref.to_dict())
    assert back == mine


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_global_norm_clip_matches_jax(max_norm):
    rng = np.random.default_rng(4)
    tree = [{"W": rng.normal(size=(3, 5)).astype(np.float32),
             "b": rng.normal(size=5).astype(np.float32)},
            {"fwd": {"RW": rng.normal(size=(2, 2)).astype(np.float32)}}]
    got = global_norm_clip(_t_tree(tree), max_norm)
    want = jax_clip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    _assert_trees_close(got, want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_bidirectional_modes_match_jax(mode):
    """Bidirectional(GravesLSTM): the JAX package flips x and the outputs;
    the port runs the backward direction with reverse=True. Same function,
    with and without a padding mask."""
    jl = JaxBidi(fwd=JaxGraves(n_out=6), mode=mode)
    itype = JaxInputType.recurrent(4, 5)
    jp, _ = jl.init(jax.random.key(0), itype)
    rng = np.random.default_rng(5)
    jp = jax.tree_util.tree_map(  # nonzero peepholes and biases
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.2, jp)
    layer = Layer.from_dict(jl.to_dict())
    assert isinstance(layer, BidirectionalLayer)
    assert layer.output_type(InputType.recurrent(4, 5)).shape == tuple(
        jl.output_type(itype).shape)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[1, 3:] = 0
    for m in (None, mask):
        want, _ = jl.apply(jp, {}, jnp.asarray(x),
                           mask=None if m is None else jnp.asarray(m))
        got, _ = layer.apply(_t_tree(jp), {}, torch.tensor(x),
                             mask=None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_graves_bidirectional_json_and_params():
    jl = JaxGravesBidi(n_out=7)
    layer = Layer.from_dict(jl.to_dict())
    assert isinstance(layer, GravesBidirectionalLSTMLayer)
    assert isinstance(layer.fwd, GravesLSTMLayer)
    assert layer.to_dict() == jl.to_dict()
    assert GravesBidirectionalLSTMLayer(n_out=7).to_dict() == jl.to_dict()
    p, _ = layer.init(torch.Generator().manual_seed(0),
                      InputType.recurrent(3, 4), "cpu")
    assert set(p) == {"fwd", "bwd"}
    assert set(p["fwd"]) == {"W", "RW", "b", "pW"}
    assert not torch.equal(p["fwd"]["W"], p["bwd"]["W"])


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.01, 0.0), (0.0, 0.1),
                                   (0.02, 0.3)])
def test_regularization_matches_jax(l1, l2):
    rng = np.random.default_rng(6)
    for jl in (JaxDense(n_out=3, l1=l1, l2=l2),
               JaxGravesBidi(n_out=4, l1=l1, l2=l2)):
        itype = (JaxInputType.recurrent(5, 3) if isinstance(jl, JaxGravesBidi)
                 else JaxInputType.feed_forward(5))
        jp, _ = jl.init(jax.random.key(1), itype)
        jp = jax.tree_util.tree_map(
            lambda a: a + rng.normal(size=a.shape).astype(np.float32), jp)
        got = Layer.from_dict(jl.to_dict()).regularization(_t_tree(jp))
        np.testing.assert_allclose(float(got), float(jl.regularization(jp)),
                                   rtol=1e-5)


def test_dropout_draws_from_the_generator():
    layer = LSTMLayer(n_out=3, dropout=0.25)
    x = torch.ones(200, 50)
    a = layer._maybe_dropout(x, True, torch.Generator().manual_seed(1))
    b = layer._maybe_dropout(x, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert layer._maybe_dropout(x, False, None) is x
    with pytest.raises(ValueError, match="generator"):
        layer._maybe_dropout(x, True, None)


# --------------------------------------------- carrying state; the slice

def _port_of(jnet, port_model=None):
    """The port's network for ``jnet``: the port's own zoo model where
    given (its configuration must write the JAX JSON), with the JAX
    params, updater state and counters carried across."""
    if port_model is not None:
        assert port_model.conf().to_json() == jnet.conf.to_json()
        net = port_model.init(device="cpu")
    else:
        conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
        net = MultiLayerNetwork(conf).init(device="cpu")
    load_jax_params(net, _np_tree(jnet.params))
    return load_jax_opt_state(net, _np_tree(jnet.opt_state), jnet.step_count,
                              jnet.epoch_count)


def _batches(n, V, T=5, B=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (B, T))
        out.append((np.eye(V, dtype=np.float32)[ids],
                    np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]))
    return out


SLICE = [
    pytest.param(JaxCharRnn, BidirectionalGravesLSTMCharRnn,
                 dict(units=12, layers=2, vocab_size=11, timesteps=5),
                 id="bidi-graves-charrnn"),
    pytest.param(JaxTextGen, TextGenerationLSTM,
                 dict(units=12, vocab_size=11, timesteps=5), id="textgen"),
]


@pytest.mark.parametrize("jax_cls,port_cls,kw", SLICE)
def test_slice_trains_like_jax(jax_cls, port_cls, kw):
    """Both char-RNN models, built in both packages with the JAX weights
    carried across, train 3 fit_batch steps on the same data: per-step
    losses, final params and updater state agree."""
    jnet = jax_cls(**kw).init()
    rng = np.random.default_rng(7)
    # move the weights off their init (peepholes start at zero)
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        jnet.params)
    net = _port_of(jnet, port_cls(**kw))
    for x, y in _batches(3, kw["vocab_size"], seed=1):
        raw = jnet.fit_batch((x, y))
        got = net.fit_batch((x, y))
        # both packages return the same kind of score: in their default
        # async mode a lazy handle that drains to the step's float
        assert type(got).__name__ == type(raw).__name__
        np.testing.assert_allclose(float(got), float(raw), rtol=1e-5)
    assert net.step_count == jnet.step_count == 3
    _assert_trees_close(net.params, jnet.params)
    _assert_trees_close(net.opt_state, jnet.opt_state)
    x, y = _batches(1, kw["vocab_size"], seed=2)[0]
    np.testing.assert_allclose(net.score((x, y)), float(jnet.score((x, y))),
                               rtol=1e-5)


def test_masked_batch_trains_like_jax():
    """A padding mask: the loss is normalized by the mask's sum, and a
    labels mask distinct from the features mask covers the loss only."""
    jnet = JaxCharRnn(units=6, layers=1, vocab_size=7, timesteps=4).init()
    net = _port_of(jnet)
    (x, y), = _batches(1, 7, T=4, B=5, seed=3)
    m = np.ones((5, 4), np.float32)
    m[0, 2:] = 0
    lm = m.copy()
    lm[2, 0] = 0
    for ds in ((x, y, m), (x, y, m, lm)):
        np.testing.assert_allclose(net.fit_batch(ds), float(jnet.fit_batch(ds)),
                                   rtol=1e-5)
    _assert_trees_close(net.params, jnet.params)
    with pytest.raises(ValueError, match="ComputationGraph"):
        net.fit_batch((x, y, m, [lm]))


def test_load_jax_params_checks_nested_keys_and_shapes():
    jnet = JaxCharRnn(units=4, layers=1, vocab_size=5, timesteps=3).init()
    net = _port_of(jnet)
    assert net.params[0]["bwd"]["pW"].shape == (12,)
    _assert_trees_close(net.params, jnet.params, atol=0, rtol=0)
    _assert_trees_close(net.opt_state, jnet.opt_state, atol=0, rtol=0)
    bad = _np_tree(jnet.params)
    bad[0]["fwd"] = dict(bad[0]["fwd"], extra=np.zeros(1))
    with pytest.raises(ValueError, match="keys"):
        load_jax_params(net, bad)
    bad = _np_tree(jnet.params)
    bad[0]["bwd"]["RW"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="0/bwd/RW"):
        load_jax_params(net, bad)
    with pytest.raises(ValueError, match="layers"):
        load_jax_params(net, _np_tree(jnet.params)[:1])


def test_fit_overloads_count_steps_and_epochs():
    net = BidirectionalGravesLSTMCharRnn(units=4, layers=1, vocab_size=5,
                                         timesteps=3).init(device="cpu")
    batches = _batches(2, 5, T=3, B=2, seed=4)
    net.fit(*batches[0], epochs=2)
    assert (net.step_count, net.epoch_count) == (2, 0)
    net.fit(batches, epochs=3)
    assert (net.step_count, net.epoch_count) == (8, 3)
    assert np.isfinite(net.score())


def test_bf16_policy_trains_f32_params():
    net = BidirectionalGravesLSTMCharRnn(units=4, layers=1, vocab_size=5,
                                         timesteps=3, dtype="bf16").init(
                                             device="cpu")
    (x, y), = _batches(1, 5, T=3, B=2, seed=5)
    before = [a.clone() for a in net.params[0]["fwd"].values()]
    loss = net.fit_batch((x, y))
    assert np.isfinite(loss)
    after = list(net.params[0]["fwd"].values())
    assert all(a.dtype == torch.float32 for a in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


# ------------------------------------------------------------------- zips

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zip_crosses_packages_mid_training(tmp_path, writer):
    """A zip written by either package after two steps restores in the
    other with params, updater state and counters; one more step then
    agrees in both."""
    kw = dict(units=6, layers=2, vocab_size=7, timesteps=4)
    jnet = JaxCharRnn(**kw).init()
    net = _port_of(jnet)
    batches = _batches(3, 7, T=4, B=4, seed=6)
    for x, y in batches[:2]:
        jnet.fit_batch((x, y))
        net.fit_batch((x, y))
    path = str(tmp_path / "model.zip")
    if writer == "port":
        net.save(path)
        jnet = jax_restore(path)
    else:
        jnet.save(path)
        net = MultiLayerNetwork.load(path, device="cpu")
    assert net.step_count == jnet.step_count == 2
    _assert_trees_close(net.params, jnet.params, atol=0, rtol=0)
    _assert_trees_close(net.opt_state, jnet.opt_state, atol=0, rtol=0)
    x, y = batches[2]
    np.testing.assert_allclose(net.fit_batch((x, y)),
                               float(jnet.fit_batch((x, y))), rtol=1e-5)
    _assert_trees_close(net.params, jnet.params)
    _assert_trees_close(net.opt_state, jnet.opt_state)


def test_zip_without_updater_restores_fresh_state(tmp_path):
    net = TextGenerationLSTM(units=4, vocab_size=5).init(device="cpu")
    net.fit_batch(_batches(1, 5, T=3, B=2)[0])
    path = str(tmp_path / "m.zip")
    net.save(path, save_updater=False)
    back = restore_multi_layer_network(path, device="cpu")
    assert back.step_count == 1
    assert all(float(a.abs().sum()) == 0
               for a in jax.tree_util.tree_leaves(
                   [s["g2"] for s in back.opt_state if s]))
    kept = restore_multi_layer_network(path, device="cpu", load_updater=False)
    _assert_trees_close(kept.params, _np_tree(
        [{k: v.numpy() for k, v in p.items()} for p in net.params]),
        atol=0, rtol=0)


# ------------------------------------------------------------ refusals

def _tiny(**conf_kw):
    conf = TextGenerationLSTM(units=4, vocab_size=5, timesteps=3).conf()
    return MultiLayerNetwork(dataclasses.replace(conf, **conf_kw))


@pytest.mark.parametrize("case", ["tbptt", "remat", "guardrails", "faults"])
def test_unported_train_step_parts_raise(case, monkeypatch):
    """Guardrails, the one part of the JAX train step not ported yet, are
    refused before the step runs; truncated BPTT, remat and fault plans,
    refused until they were ported, now take the step."""
    from deeplearning4j_tpu_torch import faults

    (x, y), = _batches(1, 5, T=6, B=2, seed=8)
    if case == "tbptt":
        net = _tiny(tbptt_fwd_length=3, tbptt_bwd_length=3)
    elif case == "remat":
        net = _tiny(remat=True)
    else:
        net = _tiny()
        if case == "guardrails":
            monkeypatch.setattr(env, case, True)
    net.init(device="cpu")
    before = [p["W"].clone() for p in net.params]
    if case == "guardrails":
        with pytest.raises(NotImplementedError, match="not ported"):
            net.fit_batch((x, y))
        assert net.step_count == 0
        assert all(torch.equal(p["W"], b) for p, b in zip(net.params, before))
        return
    with (faults.injected("data_corrupt:1") if case == "faults"
          else contextlib.nullcontext()):
        assert np.isfinite(float(net.fit_batch((x, y))))
    assert net.step_count == 1
    assert all(not torch.equal(p["W"], b) for p, b in zip(net.params, before))


def test_tbptt_length_covering_the_sequence_trains():
    net = _tiny(tbptt_fwd_length=6, tbptt_bwd_length=6).init(device="cpu")
    (x, y), = _batches(1, 5, T=6, B=2, seed=9)
    assert np.isfinite(net.fit_batch((x, y)))


def test_dropout_in_training_is_seeded():
    """Dropout on an inner layer of a Bidirectional wrapper draws from the
    network's generator: two nets from one seed train alike, and the masks
    change the loss against the same net without dropout."""
    def net(dropout):
        inner = GravesLSTMLayer(n_out=4, dropout=dropout)
        conf = MultiLayerConfiguration(
            layers=[BidirectionalLayer(fwd=inner),
                    RnnOutputLayer(n_out=5, activation="softmax")],
            input_type=InputType.recurrent(5, 3), seed=3)
        return MultiLayerNetwork(conf).init(device="cpu")

    (x, y), = _batches(1, 5, T=3, B=4, seed=10)
    a, b, plain = net(0.5), net(0.5), net(0.0)
    la = [a.fit_batch((x, y)) for _ in range(2)]
    assert la == [b.fit_batch((x, y)) for _ in range(2)]
    assert la[0] != plain.fit_batch((x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_fit_batch_on_card_runs_the_kernels(dtype, monkeypatch):
    """On the card, a char-RNN's train step launches 4 forward (each with
    its reserve) and 4 backward kernels, and in f32 three steps agree with
    the same net trained on the CPU's plain path (losses 1e-5 relative,
    params 1e-4 absolute, as chip_smoke.py holds the full-width model:
    cuBLAS and the CPU sum in other orders, and Adam's first updates,
    about lr * g / |g|, magnify that for tiny gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    from deeplearning4j_tpu_torch.ops.cuda import FUSED_LSTM, FUSED_LSTM_BWD

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model = BidirectionalGravesLSTMCharRnn(units=24, layers=2, vocab_size=9,
                                           timesteps=7, dtype=dtype)
    net = model.init(device="cuda")
    cpu = MultiLayerNetwork(model.conf()).init(device="cpu")
    cpu.params = tree_map(lambda a: a.cpu(), net.params)
    batches = _batches(3, 9, T=7, B=16, seed=11)
    fwd, bwd, res = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches,
                     FUSED_LSTM.reserves)
    losses = [net.fit_batch(b) for b in batches]
    assert (FUSED_LSTM.launches - fwd, FUSED_LSTM_BWD.launches - bwd,
            FUSED_LSTM.reserves - res) == (12, 12, 12)
    assert all(np.isfinite(losses))
    if dtype == "float32":
        np.testing.assert_allclose(losses, [cpu.fit_batch(b) for b in batches],
                                   rtol=1e-5)
        _assert_trees_close(net.params, tree_map(lambda a: a.numpy(),
                                                 cpu.params),
                            atol=1e-4, rtol=0)
