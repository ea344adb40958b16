"""The port's ResNet-50 (``zoo/resnet.py``, BASELINE.json config #2) against
the JAX package's, on shared weights and numpy inputs.

- ``ResNet50().conf()`` at full width (224 x 224 x 3, 1000 classes, bf16)
  writes the JAX package's configuration JSON; no weights are built.
- At full depth (53 convolutions, 53 BatchNormalizations, 16 residual
  adds) on 32 x 32 x 3 images and 10 classes, f32:
  - ``output()`` at B = 2 agrees within 1e-4 (the stated tolerance for 53
    convolutions deep; eval mode normalizes with the running statistics);
  - the loss of one ``fit_batch`` step at B = 8 agrees within 1e-4
    (relative);
  - one ``fit_batch`` step with both packages in f64 gives the JAX
    graph's params, BN state and updater state within 1e-8.

Why the step's params are held in f64. Training-mode BatchNormalization
normalizes by each channel's batch statistics, and at 32 x 32 the last
stage is 1 x 1, so a channel's statistics come from B values. Through 53
such layers the f32 rounding of either package is amplified by many
orders: at B = 8 the port's f32 gradients differ from its own f64 ones by
a large fraction of a tensor's largest entry in the first layers, and the
JAX package's f32 gradients from the same f64 ones by as much, so two f32
implementations cannot agree elementwise on the update. At B = 2 (two
values a channel in the last stage) the amplification reaches the sign of
the normalized activations, in f64 too. So the update is compared where
the arithmetic is exact enough to compare it: f64, B = 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.dtypes import DtypePolicy as JaxPolicy
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.zoo.resnet import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.common.dtypes import DtypePolicy
from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.zoo import ResNet50

SMALL = dict(height=32, width=32, num_classes=10, dtype="float32")
TOL_OUT = dict(atol=1e-4, rtol=1e-4)
TOL_F64 = dict(atol=1e-8, rtol=1e-8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, **tol):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _close(port[k], ref[k], **tol)
    else:
        np.testing.assert_allclose(port.detach().cpu().numpy(),
                                   np.asarray(ref), **tol)


def test_full_width_conf_json_matches_jax():
    """Same builder calls, vertex names and defaults: the JSON of the
    224 x 224 x 3, 1000-class bf16 graph is the JAX package's, and reads
    back to the same string."""
    s = JaxResNet50().conf().to_json()
    conf = ResNet50().conf()
    assert conf.to_json() == s
    assert ComputationGraphConfiguration.from_json(s).to_json() == s
    assert conf.dtype == "bf16"
    assert conf.network_outputs == ["output"]
    kinds = [type(getattr(v, "layer", v)).__name__
             for v in conf.vertices.values()]
    assert kinds.count("ConvolutionLayer") == 53
    assert kinds.count("BatchNormalizationLayer") == 53
    assert kinds.count("ElementWiseVertex") == 16
    t = conf.vertex_output_types
    assert t["pool1"].shape == (56, 56, 64)
    assert t["s3b2_out"].shape == (7, 7, 2048)
    assert t["output"].size == 1000


@pytest.fixture(scope="module")
def jax_small():
    """The JAX package's full-depth ResNet-50 at 32 x 32 x 3 (its init is
    the slow part, so the module builds it once): its JSON, params, state
    and updater state as numpy."""
    jn = JaxResNet50(**SMALL).init()
    return (jn.conf.to_json(), _np(jn.params), _np(jn.state),
            _np(jn.opt_state))


def _pair(jax_small):
    """A fresh JAX graph and the port's, on the same weights."""
    s, params, state, opt = jax_small
    jn = JaxGraph(type(JaxResNet50(**SMALL).conf()).from_json(s))
    jn.params, jn.state, jn.opt_state = (
        jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state, opt))
    net = ComputationGraph(ComputationGraphConfiguration.from_json(s))
    net.init(device="cpu")
    load_jax_params(net, params, state)
    return jn, load_jax_opt_state(net, opt)


def _batch(B, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 32, 32, 3)).astype(dtype)
    y = np.eye(10, dtype=dtype)[rng.integers(0, 10, B)]
    return x, y


def test_full_depth_output_matches_jax(jax_small):
    jn, net = _pair(jax_small)
    assert net.num_params() == 23_528_522
    x, _ = _batch(2)
    out = net.output(x)
    assert out.shape == (2, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jn.output(x)),
                               **TOL_OUT)


def test_full_depth_step_loss_matches_jax(jax_small):
    jn, net = _pair(jax_small)
    x, y = _batch(8)
    lj = float(jn.fit_batch((x, y)))
    lp = net.fit_batch((x, y))
    np.testing.assert_allclose(lp, lj, rtol=1e-4)
    # the running statistics moved
    assert not torch.equal(net.state["bn1"]["mean"],
                           torch.zeros_like(net.state["bn1"]["mean"]))


def test_full_depth_step_in_f64_matches_jax(jax_small):
    jn, net = _pair(jax_small)
    x, y = _batch(8, np.float64)
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
    # fit_batch returns the loss in f32, as the JAX step does
    np.testing.assert_allclose(lp, lj, rtol=1e-7)
    for got, ref in zip((net.params, net.state, net.opt_state), want):
        _close(got, ref, **TOL_F64)


def test_zoo_init_builds_a_graph_and_restores_it(tmp_path):
    net = ResNet50(seed=3, **SMALL).init(device="cpu")
    assert isinstance(net, ComputationGraph)
    path = str(tmp_path / "resnet.zip")
    net.save(path)
    back = ResNet50(**SMALL).init_pretrained(path, device="cpu")
    assert isinstance(back, ComputationGraph)
    x, _ = _batch(2, seed=4)
    assert torch.equal(back.output(x), net.output(x))
