"""The port's detection stack and center-loss training against the JAX
package, on shared numpy inputs from a seed.

- ``Yolo2OutputLayer``'s per-example loss and its gradient with respect to
  the network output against the JAX layer and ``jax.grad`` through it,
  f32, within 1e-6 (relative to the largest entry), with distinct priors
  and with tied priors (the responsible-anchor one-hot splits the same
  way); labels with 1-3 object cells an image.
- ``get_predicted_objects`` and ``non_max_suppression`` equal to the JAX
  functions on ``test_zoo.py``'s decode case and on a random one with
  many boxes (the same boxes in the same order; floats within 1e-6).
- ``CenterLossOutputLayer`` trained 3 ``fit_batch`` steps in a
  MultiLayerNetwork and in a ComputationGraph with a per-example labels
  mask: params, centers and updater state within 1e-5.
- ``YOLO2()`` at full depth (the Darknet-19 trunk, the passthrough, the
  head; 22 BatchNormalizations) on 64 x 64 x 3 images (a 2 x 2 grid), 80
  classes and its five priors, as ``test_torch_resnet.py`` does ResNet-50:
  ``output()`` at B = 2 and one step's loss at B = 4 within 1e-4 (f32);
  one step's params, BN state and Adam state within 1e-8 with both
  packages in f64; a JAX-written zip of it loads into the port and gives
  the same output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.dtypes import DtypePolicy as JaxPolicy
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import (
    CenterLossOutputLayer as JaxCenterLoss, DenseLayer as JaxDense,
)
from deeplearning4j_tpu.nn.layers import objdetect as jax_od
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu.util.serialization import write_model as jax_write
from deeplearning4j_tpu.zoo.darknet import YOLO2 as JaxYOLO2
from deeplearning4j_tpu_torch.common.dtypes import DtypePolicy
from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.nn.layers import objdetect
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.serialization import restore_model
from deeplearning4j_tpu_torch.zoo import YOLO2

TOL_LOSS = 1e-6
TOL_DECODE = dict(rtol=1e-6, atol=1e-6)
TOL_TRAIN = dict(rtol=1e-5, atol=1e-5)
TOL_OUT = dict(atol=1e-4, rtol=1e-4)
TOL_F64 = dict(atol=1e-8, rtol=1e-8)
PRIORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434))
TIED = ((1.0, 1.5), (1.0, 1.5), (2.0, 1.0))
YOLO2_PARAMS = 50_962_889  # at 80 classes and five priors, any image size


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
                                   np.asarray(ref), **tol)


def yolo_labels(rng, B, H, W, C, cells=(1, 3), wh=(0.3, 4.0)):
    """[B, H, W, 5 + C] labels: ``cells`` object cells an image, centers
    U[0, 1) in the cell, sizes U[wh] grid units, a one-hot class."""
    y = np.zeros((B, H, W, 5 + C), np.float32)
    for b in range(B):
        n = rng.integers(cells[0], cells[1] + 1)
        for c in rng.choice(H * W, size=min(n, H * W), replace=False):
            i, j = divmod(int(c), W)
            y[b, i, j, 0:2] = rng.random(2)
            y[b, i, j, 2:4] = rng.uniform(*wh, size=2)
            y[b, i, j, 4] = 1.0
            y[b, i, j, 5 + rng.integers(0, C)] = 1.0
    return y


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("anchors", [PRIORS, TIED], ids=["priors", "tied"])
@pytest.mark.parametrize("C", [4, 1])
def test_yolo2_loss_and_gradient_match_jax(anchors, C):
    rng = np.random.default_rng(len(anchors) + C)
    A, B, H, W = len(anchors), 3, 4, 5
    jl = jax_od.Yolo2OutputLayer(anchors=anchors, n_classes=C)
    pl = objdetect.Yolo2OutputLayer(anchors=anchors, n_classes=C)
    x = rng.normal(scale=2.0, size=(B, H, W, A * (5 + C))).astype(np.float32)
    x[0, 0, 0, 2:4] = 9.5  # past the clip of twh
    y = yolo_labels(rng, B, H, W, C)
    if anchors is TIED:  # the cells' boxes favour the tied pair
        y[..., 2:4] = np.where(y[..., 4:5] > 0, np.float32([1.0, 1.5]), 0.0)
    want = np.asarray(jl.score_from_preout(jnp.asarray(y), jnp.asarray(x)))
    gwant = np.asarray(jax.grad(lambda p: jl.score_from_preout(
        jnp.asarray(y), p).sum())(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = pl.score_from_preout(torch.tensor(y), xt)
    (g,) = torch.autograd.grad(got.sum(), xt)
    assert got.shape == (B,)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy() / scale, want / scale,
                               atol=TOL_LOSS, rtol=0)
    gscale = float(np.abs(gwant).max())
    np.testing.assert_allclose(g.numpy() / gscale, gwant / gscale,
                               atol=TOL_LOSS, rtol=0)
    assert np.abs(gwant[0, 0, 0, 2:4]).max() == 0.0  # clipped: no gradient


def test_yolo2_bf16_preout_is_scored_in_f32():
    rng = np.random.default_rng(1)
    pl = objdetect.Yolo2OutputLayer(anchors=PRIORS, n_classes=2)
    x = torch.tensor(rng.normal(size=(2, 2, 2, 21)).astype(np.float32))
    y = torch.tensor(yolo_labels(rng, 2, 2, 2, 2))
    got = pl.score_from_preout(y, x.bfloat16())
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, pl.score_from_preout(y, x.bfloat16().float()))


# --------------------------------------------------------------- decode

def _zoo_case():
    """``tests/test_zoo.py``'s decode case."""
    rng = np.random.default_rng(0)
    preout = rng.normal(size=(1, 4, 4, 2 * 7)).astype(np.float32)
    preout = preout.reshape(1, 4, 4, 2, 7)
    preout[..., 4] = -10.0
    preout[0, 1, 2, 0, 4] = 6.0
    preout[0, 1, 2, 1, 4] = 5.0
    preout[0, 1, 2, :, 5] = 4.0
    return ((1.0, 1.0), (2.0, 2.0)), 2, preout.reshape(1, 4, 4, 14), 0.4


def _random_case():
    """Many boxes of three classes, ties in confidence included."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(2, 6, 5, 3, 8)).astype(np.float32)
    p[..., 4] = rng.normal(1.0, 1.5, size=p.shape[:-1])
    p[0, 2, 3, :, 4] = 2.0  # three anchors at one confidence
    p[1, 0, :, 0, 4] = 2.0
    return PRIORS, 3, p.reshape(2, 6, 5, 24), 0.45


def _same_dets(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.class_index == b.class_index
        for f in ("center_x", "center_y", "width", "height", "confidence"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       **TOL_DECODE)
        np.testing.assert_allclose(a.class_probs, b.class_probs, **TOL_DECODE)


@pytest.mark.parametrize("case", [_zoo_case, _random_case],
                         ids=["test_zoo", "random"])
def test_decode_and_nms_match_jax(case):
    anchors, C, preout, iou = case()
    jl = jax_od.Yolo2OutputLayer(anchors=anchors, n_classes=C)
    pl = objdetect.Yolo2OutputLayer(anchors=anchors, n_classes=C)
    want = jax_od.get_predicted_objects(jl, preout, threshold=0.5)
    got = objdetect.get_predicted_objects(pl, torch.tensor(preout),
                                          threshold=0.5)
    assert len(got) == len(want) == preout.shape[0]
    for g, w in zip(got, want):
        assert len(w) > 0
        _same_dets(g, w)
        _same_dets(objdetect.non_max_suppression(g, iou),
                   jax_od.non_max_suppression(w, iou))


def test_decode_with_no_classes_matches_jax():
    rng = np.random.default_rng(2)
    preout = rng.normal(size=(1, 3, 3, 10)).astype(np.float32)
    anchors = ((1.0, 1.0), (2.0, 3.0))
    want = jax_od.get_predicted_objects(
        jax_od.Yolo2OutputLayer(anchors=anchors), preout, threshold=0.3)[0]
    got = objdetect.get_predicted_objects(
        objdetect.Yolo2OutputLayer(anchors=anchors), preout, threshold=0.3)[0]
    _same_dets(got, want)
    assert all(d.class_index == 0 and d.class_probs.size == 0 for d in got)


# ------------------------------------------------------ center loss training

def _center_batch(seed, B=6, F=7, K=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rng.integers(0, K, B)]
    return x, y


def test_center_loss_mln_trains_as_jax():
    conf = (JaxNNC.builder().seed(4).updater(JaxAdam(lr=0.05)).list()
            .layer(JaxDense(n_out=6, activation="tanh"))
            .layer(JaxCenterLoss(n_out=4, activation="softmax", alpha=0.4,
                                 lambda_=0.3))
            .set_input_type(JaxInputType.feed_forward(7)).build())
    jn = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()))
    net.init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    load_jax_opt_state(net, _np(jn.opt_state))
    for step in range(3):
        x, y = _center_batch(step)
        lj = float(jn.fit_batch((x, y)))
        lp = net.fit_batch((x, y))
        np.testing.assert_allclose(lp, lj, **TOL_TRAIN)
    _close(net.params, _np(jn.params), **TOL_TRAIN)
    _close(net.state, _np(jn.state), **TOL_TRAIN)
    _close(net.opt_state, _np(jn.opt_state), **TOL_TRAIN)
    assert float(net.state[-1]["centers"].abs().sum()) > 0


def test_center_loss_graph_with_labels_mask_trains_as_jax():
    """A per-example labels mask covers the center term and the center
    update."""
    g = (JaxNNC.builder().seed(5).updater(JaxAdam(lr=0.05)).graph_builder()
         .add_inputs("in")
         .set_input_types(**{"in": JaxInputType.feed_forward(7)}))
    g.add_layer("emb", JaxDense(n_out=5, activation="identity"), "in")
    g.add_layer("out", JaxCenterLoss(n_out=4, activation="softmax",
                                     alpha=0.9, lambda_=0.5), "emb")
    g.set_outputs("out")
    conf = g.build()
    jn = JaxGraph(conf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()))
    net.init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    load_jax_opt_state(net, _np(jn.opt_state))
    mask = np.float32([1, 0, 1, 1, 0, 1])
    for step in range(3):
        x, y = _center_batch(10 + step)
        lj = float(jn.fit_batch((x, y, None, mask)))
        lp = net.fit_batch((x, y, None, mask))
        np.testing.assert_allclose(lp, lj, **TOL_TRAIN)
    _close(net.params, _np(jn.params), **TOL_TRAIN)
    _close(net.state, _np(jn.state), **TOL_TRAIN)
    _close(net.opt_state, _np(jn.opt_state), **TOL_TRAIN)


# --------------------------------------------- YOLO2 at full depth, 64 x 64

SMALL = dict(height=64, width=64, dtype="float32")


@pytest.fixture(scope="module")
def jax_yolo2():
    """The JAX package's full-depth YOLO2 at 64 x 64 x 3, 80 classes, five
    priors, f32 (its init is the slow part, so the module builds it once):
    its JSON, params, state and updater state as numpy."""
    jn = JaxYOLO2(**SMALL).init()
    return (jn.conf.to_json(), _np(jn.params), _np(jn.state),
            _np(jn.opt_state))


def _pair(jax_yolo2):
    s, params, state, opt = jax_yolo2
    jn = JaxGraph(type(JaxYOLO2(**SMALL).conf()).from_json(s))
    jn.params, jn.state, jn.opt_state = (
        jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state, opt))
    net = ComputationGraph(ComputationGraphConfiguration.from_json(s))
    net.init(device="cpu")
    load_jax_params(net, params, state)
    return jn, load_jax_opt_state(net, opt)


def _batch(B, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 64, 64, 3)).astype(dtype)
    y = yolo_labels(rng, B, 2, 2, 80, cells=(1, 3), wh=(0.3, 2.0))
    return x, y.astype(dtype)


def test_yolo2_full_depth_output_matches_jax(jax_yolo2):
    jn, net = _pair(jax_yolo2)
    assert net.num_params() == YOLO2_PARAMS
    kinds = [type(getattr(v, "layer", v)).__name__
             for v in net.conf.vertices.values()]
    assert kinds.count("BatchNormalizationLayer") == 22
    x, _ = _batch(2)
    out = net.output(x)
    assert out.shape == (2, 2, 2, 425) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jn.output(x)),
                               **TOL_OUT)


def test_yolo2_full_depth_step_loss_matches_jax(jax_yolo2):
    jn, net = _pair(jax_yolo2)
    x, y = _batch(4, seed=1)
    lj = float(jn.fit_batch((x, y)))
    lp = net.fit_batch((x, y))
    np.testing.assert_allclose(lp, lj, rtol=1e-4)
    assert not torch.equal(net.state["dn0_bn"]["mean"],
                           torch.zeros_like(net.state["dn0_bn"]["mean"]))


class _Widened:
    """``jax.numpy`` as the JAX YOLO head sees it, with float32 meaning
    float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def test_yolo2_full_depth_step_in_f64_matches_jax(jax_yolo2, monkeypatch):
    """Both heads cast the preout and labels to f32 by design; in this f64
    comparison both casts are widened to f64 with the policies, so the
    step is f64 end to end (an f32 head's rounding, amplified through 22
    training-mode BatchNormalizations, moves the gradients by about 1e-4
    relative in either package)."""
    monkeypatch.setattr(jax_od, "jnp", _Widened())
    monkeypatch.setattr(objdetect, "LOSS_DTYPE", torch.float64)
    jn, net = _pair(jax_yolo2)
    x, y = _batch(4, np.float64, seed=2)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        jn.params, jn.state, jn.opt_state = (
            f64(jn.params), f64(jn.state), f64(jn.opt_state))
        jn._policy = JaxPolicy(jnp.float64, jnp.float64, jnp.float64)
        lj = float(jn.fit_batch((x, y)))
        want = [_np(t) for t in (jn.params, jn.state, jn.opt_state)]
    d = lambda t: tree_map(lambda a: a.double(), t)  # noqa: E731
    net.params, net.state, net.opt_state = (
        d(net.params), d(net.state), d(net.opt_state))
    net._policy = DtypePolicy(torch.float64, torch.float64, torch.float64)
    lp = net.fit_batch((x, y))
    np.testing.assert_allclose(lp, lj, rtol=1e-7)
    for got, ref in zip((net.params, net.state, net.opt_state), want):
        _close(got, ref, **TOL_F64)


def test_jax_written_yolo2_zip_loads_and_computes_the_same(jax_yolo2,
                                                           tmp_path):
    jn, _ = _pair(jax_yolo2)
    x, _ = _batch(2, seed=3)
    # running statistics off their init, as a trained net's are
    rng = np.random.default_rng(4)
    jn.state = {k: {"mean": jnp.asarray(rng.normal(0, 0.1, v["mean"].shape),
                                        jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 2, v["var"].shape),
                                       jnp.float32)}
                for k, v in jn.state.items()}
    jn.step_count = 3
    path = str(tmp_path / "yolo2.zip")
    jax_write(jn, path)
    net = restore_model(path, device="cpu")
    assert isinstance(net, ComputationGraph) and net.step_count == 3
    _close(net.state, _np(jn.state), atol=0, rtol=0)
    _close(net.opt_state, _np(jn.opt_state), atol=0, rtol=0)
    out = net.output(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jn.output(x)),
                               **TOL_OUT)
    dets = objdetect.get_predicted_objects(
        net.conf.vertices["output"].layer, out, threshold=0.5)
    assert len(dets) == 2
    assert YOLO2(**SMALL).conf().to_json() == jn.conf.to_json()
