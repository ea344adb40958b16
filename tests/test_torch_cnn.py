"""The port's conv stack against the JAX package, on shared numpy inputs.

``conv2d``, the three pools and ``conv_out_len`` against the JAX package's
XLA lowerings (SAME at strides 1 and 2, where XLA pads one more at the end,
truncate, explicit pads, dilation, groups); the new preprocessors and
``auto_preprocessor``; every weight-init scheme and distribution (shape
and scale; the packages draw different numbers from one seed); the conv,
subsampling and LRN layers against their JAX twins on the JAX layers'
params; then whole networks in f32 through ``load_jax_params``: ``LeNet``
at full width
and an AlexNet-shaped net (AlexNet's layer sequence at narrow widths on a
67 x 67 input, the smallest that survives its strides, dropout 0), each
through ``output()`` and three ``fit_batch`` steps; ``AlexNet``'s
configuration JSON and an eval-mode ``output()``; and zips crossing both
ways mid-training. Tolerance 1e-5: the packages differ only in the order
of their sums. The ``cuda`` test runs an AlexNet-shaped net on the card
and counts its LRN launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import weights as jax_weights
from deeplearning4j_tpu.nn.conf import preprocessors as jax_pre
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JaxNNConf,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    ConvolutionLayer as JaxConv, DenseLayer as JaxDense,
    LocalResponseNormalizationLayer as JaxLRN, OutputLayer as JaxOutput,
    SubsamplingLayer as JaxPool,
)
from deeplearning4j_tpu.ops import convolution as jax_conv
from deeplearning4j_tpu.optimize.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.util.serialization import (
    restore_multi_layer_network as jax_restore,
)
from deeplearning4j_tpu.zoo.alexnet import AlexNet as JaxAlexNet
from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre
from deeplearning4j_tpu_torch.nn.conf.builders import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, Layer, LocalResponseNormalizationLayer,
    OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_opt_state, load_jax_params,
)
from deeplearning4j_tpu_torch.ops import convolution
from deeplearning4j_tpu_torch.ops.cuda import LRN_BWD, LRN_FWD
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo import AlexNet, LeNet

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(port, ref, **tol):
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


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# --------------------------------------------------------------- the ops

CONV_CASES = {
    "same_s1": dict(x=(2, 9, 7, 3), w=(3, 3, 3, 5), strides=(1, 1),
                    padding="same"),
    "same_s2_asym": dict(x=(2, 8, 9, 3), w=(3, 3, 3, 4), strides=(2, 2),
                         padding="same"),
    "same_even_kernel": dict(x=(1, 6, 6, 2), w=(4, 2, 2, 3), strides=(1, 1),
                             padding="same"),
    "same_s4_k11": dict(x=(1, 23, 23, 3), w=(11, 11, 3, 4), strides=(4, 4),
                        padding="same"),
    "truncate_s4_k11": dict(x=(1, 23, 23, 3), w=(11, 11, 3, 4),
                            strides=(4, 4), padding="truncate"),
    "valid": dict(x=(2, 7, 7, 2), w=(3, 2, 2, 3), strides=(1, 2),
                  padding="valid"),
    "explicit": dict(x=(2, 6, 5, 2), w=(3, 3, 2, 3), strides=(1, 1),
                     padding=(1, 2)),
    "dilation_same": dict(x=(1, 9, 9, 2), w=(3, 3, 2, 3), strides=(1, 1),
                          padding="same", dilation=(2, 2)),
    "dilation_valid": dict(x=(1, 9, 9, 2), w=(3, 3, 2, 3), strides=(2, 1),
                           padding="valid", dilation=(2, 3)),
    "groups": dict(x=(2, 5, 5, 4), w=(3, 3, 2, 6), strides=(1, 1),
                   padding="same", groups=2),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv2d_matches_xla(name):
    case = dict(CONV_CASES[name])
    x, w = _x(case.pop("x"), 1), _x(case.pop("w"), 2, scale=0.3)
    got = convolution.conv2d(torch.tensor(x), torch.tensor(w), **case)
    want = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), **case)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv2d_returns_contiguous_nhwc():
    x = torch.tensor(_x((2, 9, 9, 3), 3))
    y = convolution.conv2d(x, torch.tensor(_x((5, 5, 3, 8), 4)))
    assert y.is_contiguous()


POOL_CASES = {
    "valid_k2": dict(x=(2, 8, 8, 3), kernel=(2, 2), strides=None,
                     padding="valid"),
    "valid_k3_s2": dict(x=(2, 9, 11, 3), kernel=(3, 3), strides=(2, 2),
                        padding="valid"),
    "truncate": dict(x=(1, 7, 7, 2), kernel=(3, 3), strides=(2, 2),
                     padding="truncate"),
    "same_s1": dict(x=(2, 5, 6, 2), kernel=(3, 3), strides=(1, 1),
                    padding="same"),
    "same_s2_asym": dict(x=(2, 8, 7, 2), kernel=(3, 3), strides=(2, 2),
                         padding="same"),
    "same_k2_s2_odd": dict(x=(1, 7, 7, 2), kernel=(2, 2), strides=(2, 2),
                           padding="same"),
    "explicit": dict(x=(2, 6, 6, 2), kernel=(3, 3), strides=(2, 2),
                     padding=(1, 1)),
}


@pytest.mark.parametrize("pool", ["maxpool2d", "avgpool2d", "pnormpool2d"])
@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_pools_match_xla(pool, name):
    case = dict(POOL_CASES[name])
    x = _x(case.pop("x"), 5)
    kw = dict(pnorm=3) if pool == "pnormpool2d" else {}
    got = getattr(convolution, pool)(torch.tensor(x), **case, **kw)
    want = getattr(jax_conv, pool)(jnp.asarray(x), **case, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,k,s,pad,d", [
    (224, 11, 4, "truncate", 1), (54, 3, 2, "valid", 1), (26, 5, 1, "same", 1),
    (7, 3, 2, "same", 1), (8, 3, 2, "same", 1), (28, 5, 1, "same", 1),
    (9, 3, 1, 2, 1), (9, 3, 2, "valid", 2), (None, 3, 1, "same", 1)])
def test_conv_out_len_matches_jax(n, k, s, pad, d):
    assert convolution.conv_out_len(n, k, s, pad, d) == \
        jax_conv.conv_out_len(n, k, s, pad, d)


def test_conv_ops_are_registered():
    from deeplearning4j_tpu_torch.ops.registry import get_op

    for name in ("conv2d", "maxpool2d", "avgpool2d", "pnormpool2d", "lrn"):
        assert get_op(name).plain.fn is getattr(convolution, name)


# --------------------------------------------------------- preprocessors

def test_reshape_to_cnn_takes_flat_nhwc_and_nchw():
    p = pre.ReshapeToCnnPreProcessor(3, 4, 2)
    jp = jax_pre.ReshapeToCnnPreProcessor(3, 4, 2)
    for shape in ((5, 24), (5, 3, 4, 2), (5, 2, 3, 4)):
        x = _x(shape, 6)
        got = p(torch.tensor(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jp(jnp.asarray(x))))
        assert tuple(got.shape) == (5, 3, 4, 2)
    assert p.output_type(InputType.feed_forward(24)) == \
        InputType.convolutional(3, 4, 2)


def test_rnn_feed_forward_preprocessors():
    x = _x((2, 5, 3), 7)
    r2f, f2r = pre.RnnToFeedForwardPreProcessor(), \
        pre.FeedForwardToRnnPreProcessor(timesteps=5)
    flat = r2f(torch.tensor(x))
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jax_pre.RnnToFeedForwardPreProcessor()(
            jnp.asarray(x))))
    np.testing.assert_array_equal(f2r(flat).numpy(), x)
    assert r2f.output_type(InputType.recurrent(3, 5)) == \
        InputType.feed_forward(3)
    assert f2r.output_type(InputType.feed_forward(3)) == \
        InputType.recurrent(3, 5)


@pytest.mark.parametrize("p", [
    pre.ReshapeToCnnPreProcessor(28, 28, 1), pre.RnnToFeedForwardPreProcessor(),
    pre.FeedForwardToRnnPreProcessor(timesteps=7), pre.FlattenPreProcessor(),
    pre.CnnToRnnPreProcessor()], ids=lambda p: type(p).__name__)
def test_preprocessor_dicts_cross_packages(p):
    d = p.to_dict()
    assert pre.InputPreProcessor.from_dict(d) == p
    assert jax_pre.InputPreProcessor.from_dict(d).to_dict() == d


@pytest.mark.parametrize("prev,layer", [
    ("cnn_flat", "conv"), ("cnn_flat", "pool"), ("cnn_flat", "lrn"),
    ("cnn", "dense"), ("cnn", "output"), ("cnn", "conv"), ("ff", "dense")])
def test_auto_preprocessor_matches_jax(prev, layer):
    itypes = {"cnn_flat": "convolutional_flat", "cnn": "convolutional"}
    mk = lambda mod: {  # noqa: E731
        "conv": lambda: mod[0](n_out=3), "pool": lambda: mod[1](),
        "lrn": lambda: mod[2](), "dense": lambda: mod[3](n_out=3),
        "output": lambda: mod[4](n_out=3)}[layer]()
    port_layer = mk((ConvolutionLayer, SubsamplingLayer,
                     LocalResponseNormalizationLayer, DenseLayer, OutputLayer))
    jax_layer = mk((JaxConv, JaxPool, JaxLRN, JaxDense, JaxOutput))
    if prev == "ff":
        it, jit = InputType.feed_forward(12), JaxInputType.feed_forward(12)
    else:
        it = getattr(InputType, itypes[prev])(4, 3, 2)
        jit = getattr(JaxInputType, itypes[prev])(4, 3, 2)
    got = pre.auto_preprocessor(it, port_layer)
    want = jax_pre.auto_preprocessor(jit, jax_layer)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()


def test_auto_preprocessor_refuses_feed_forward_into_cnn():
    for cls in (ConvolutionLayer, SubsamplingLayer):
        layer = cls(n_out=3) if cls is ConvolutionLayer else cls()
        with pytest.raises(ValueError, match="ReshapeToCnnPreProcessor"):
            pre.auto_preprocessor(InputType.feed_forward(12), layer)


# ------------------------------------------------------------ weight init

SCHEMES = ["xavier", "xavier_uniform", "xavier_fan_in", "relu", "he",
           "he_normal", "relu_uniform", "he_uniform", "lecun_normal",
           "lecun_uniform", "sigmoid_uniform", "uniform", "normal",
           "var_scaling_normal_fan_in", "var_scaling_normal_fan_out",
           "var_scaling_normal_fan_avg", "var_scaling_uniform_fan_in",
           "var_scaling_uniform_fan_out", "var_scaling_uniform_fan_avg",
           "XAVIERUNIFORM", "VarScalingNormalFanOut"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_init_schemes_match_jax_in_shape_and_scale(scheme):
    shape = (5, 5, 16, 24)  # HWIO: fan_in 400, fan_out 600
    w = weights.init_weight(torch.Generator().manual_seed(0), shape, scheme)
    ref = np.asarray(jax_weights.init_weight(jax.random.PRNGKey(0), shape,
                                             scheme))
    assert tuple(w.shape) == shape and w.dtype == torch.float32
    np.testing.assert_allclose(float(w.std()), float(ref.std()), rtol=0.05)
    np.testing.assert_allclose(float(w.abs().max()), float(np.abs(ref).max()),
                               rtol=0.35)


@pytest.mark.parametrize("scheme", ["zero", "ones", "identity"])
def test_constant_schemes_equal_jax(scheme):
    shape = (6, 6)
    w = weights.init_weight(torch.Generator(), shape, scheme)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jax_weights.init_weight(
            jax.random.PRNGKey(0), shape, scheme)))


def test_init_refuses_unknown_and_bad_schemes():
    g = torch.Generator()
    with pytest.raises(ValueError, match="unknown weight init"):
        weights.init_weight(g, (2, 2), "glorot")
    with pytest.raises(ValueError, match="square"):
        weights.init_weight(g, (2, 3), "identity")
    with pytest.raises(ValueError, match="distribution"):
        weights.init_weight(g, (2, 3), "distribution")


@pytest.mark.parametrize("dist,mean,std,bounds", [
    (weights.NormalDistribution(0.5, 2.0), 0.5, 2.0, None),
    (weights.UniformDistribution(-1.0, 3.0), 1.0, 4.0 / 12 ** 0.5, (-1, 3)),
    (weights.TruncatedNormalDistribution(0.0, 1.0), 0.0, 0.880, (-2, 2)),
    (weights.ConstantDistribution(0.25), 0.25, 0.0, (0.25, 0.25))],
    ids=lambda v: type(v).__name__ if isinstance(v, weights.Distribution)
    else None)
def test_distributions_sample_and_round_trip(dist, mean, std, bounds):
    w = weights.init_weight(torch.Generator().manual_seed(1), (200, 300),
                            "distribution", distribution=dist)
    assert abs(float(w.mean()) - mean) < 0.03 * max(1.0, std)
    assert abs(float(w.std()) - std) < 0.03 * max(1.0, std)
    if bounds:
        assert bounds[0] <= float(w.min()) and float(w.max()) <= bounds[1]
    d = dist.to_dict()
    assert weights.Distribution.from_dict(d).to_dict() == d
    assert jax_weights.Distribution.from_dict(d).to_dict() == d


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 3, 2, 8)])
def test_orthogonal_distribution(shape):
    w = weights.OrthogonalDistribution(gain=2.0).sample(
        torch.Generator().manual_seed(2), shape)
    m = w.reshape(-1, shape[-1]).double() / 2.0
    small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    torch.testing.assert_close(small, torch.eye(small.shape[0],
                                                dtype=torch.float64),
                               atol=1e-5, rtol=0)


def test_conv_layer_init_is_he_with_zero_bias():
    layer = ConvolutionLayer(n_out=64, kernel=(5, 5))
    p, s = layer.init(torch.Generator().manual_seed(0),
                      InputType.convolutional(8, 8, 32), "cpu")
    assert s == {} and tuple(p["W"].shape) == (5, 5, 32, 64)
    np.testing.assert_allclose(float(p["W"].std()), (2.0 / 800) ** 0.5,
                               rtol=0.03)
    assert torch.equal(p["b"], torch.zeros(64))


# ---------------------------------------------------------------- layers

LAYER_CASES = {
    "conv_same_relu": (lambda m: m[0](n_out=6, kernel=(3, 3),
                                      activation="relu"), (2, 7, 7, 3)),
    "conv_s4_truncate": (lambda m: m[0](n_out=5, kernel=(11, 11),
                                        strides=(4, 4), padding="truncate"),
                         (1, 23, 23, 3)),
    "conv_groups_nobias": (lambda m: m[0](n_out=4, kernel=(3, 3), groups=2,
                                          has_bias=False), (2, 5, 5, 4)),
    "conv_explicit_dilated": (lambda m: m[0](n_out=3, kernel=(3, 3),
                                             padding=(1, 1),
                                             dilation=(2, 2)), (1, 9, 8, 2)),
    "pool_max": (lambda m: m[1](kernel=(3, 3), strides=(2, 2)),
                 (2, 9, 9, 4)),
    "pool_avg_same": (lambda m: m[1](kernel=(3, 3), strides=(2, 2),
                                     padding="same", pooling_type="avg"),
                      (2, 8, 8, 4)),
    "pool_pnorm": (lambda m: m[1](pooling_type="pnorm", pnorm=3),
                   (2, 6, 6, 4)),
    "lrn_default": (lambda m: m[2](), (2, 5, 5, 40)),
    "lrn_even": (lambda m: m[2](depth=4, alpha=0.5, beta=0.6, k=1.0),
                 (2, 5, 5, 7)),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layers_match_jax(name):
    make, shape = LAYER_CASES[name]
    layer = make((ConvolutionLayer, SubsamplingLayer,
                  LocalResponseNormalizationLayer))
    jlayer = make((JaxConv, JaxPool, JaxLRN))
    assert Layer.from_dict(jlayer.to_dict()) == layer
    it = JaxInputType.convolutional(*shape[1:])
    jp, js = jlayer.init(jax.random.PRNGKey(3), it)
    p, s = layer.init(torch.Generator(), InputType.convolutional(*shape[1:]),
                      "cpu")
    assert jax.tree_util.tree_map(np.shape, jp) == \
        {k: tuple(v.shape) for k, v in p.items()}
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = _x(shape, 8, scale=2.0)
    y, _ = layer.apply(p, s, torch.tensor(x))
    want, _ = jlayer.apply(jp, js, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    assert layer.output_type(InputType.convolutional(*shape[1:])).shape == \
        want.shape[1:]


# -------------------------------------------------------------- networks

def _port_of(jnet, conf):
    net = MultiLayerNetwork(conf).init(device="cpu")
    load_jax_params(net, _np_tree(jnet.params))
    return load_jax_opt_state(net, _np_tree(jnet.opt_state), jnet.step_count,
                              jnet.epoch_count)


def _images(seed, B, shape, classes, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B,) + shape) * scale).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)]


def _train_three_steps(jnet, net, batches):
    for x, y in batches:
        want = float(jnet.fit_batch((x, y)))
        got = net.fit_batch((x, y))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert net.step_count == jnet.step_count == len(batches)
    _assert_trees_close(net.params, jnet.params)
    _assert_trees_close(net.opt_state, jnet.opt_state)


def test_lenet_configuration_json_matches_jax():
    assert LeNet().conf().to_json() == JaxLeNet().conf().to_json()
    conf = MultiLayerConfiguration.from_json(JaxLeNet().conf().to_json())
    assert conf.to_json() == JaxLeNet().conf().to_json()


def test_lenet_output_and_fit_batch_match_jax():
    jnet = JaxLeNet().init()
    net = _port_of(jnet, LeNet().conf())
    assert net.num_params() == jnet.num_params() == 1256080
    x, _ = _images(1, 8, (784,), 10)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(jnp.asarray(x))), **TOL)
    before = net.params[0]["W"].clone()
    # images at a tenth of unit scale keep the loss near log(10): at unit
    # scale the He-initialised identity convs give logits large enough that
    # Adam's normalised steps on noise-level gradients drift apart by 2e-5
    _train_three_steps(jnet, net, [_images(10 + s, 8, (784,), 10, scale=0.1)
                                   for s in range(3)])
    assert not torch.equal(net.params[0]["W"], before)


def _alexnet_shaped(nn_conf, inputs, layers, updater, widths=(8, 12, 16, 16,
                                                                12, 24)):
    """AlexNet's layer sequence (conv1 11/4 truncate, LRN, pool 3/2, conv2
    5 same, LRN, pool, conv 3 x3, pool, dense x2, softmax) at narrow
    widths, dropout 0, 10 classes, on 67 x 67 x 3."""
    Conv, LRN, Pool, Dense, Out = layers
    c1, c2, c3, c4, c5, d = widths
    b = (nn_conf.builder().seed(5).updater(updater).list()
         .layer(Conv(n_out=c1, kernel=(11, 11), strides=(4, 4),
                     padding="truncate", activation="relu"))
         .layer(LRN())
         .layer(Pool(kernel=(3, 3), strides=(2, 2), pooling_type="max"))
         .layer(Conv(n_out=c2, kernel=(5, 5), padding="same",
                     activation="relu"))
         .layer(LRN(depth=4, alpha=0.1, beta=0.75, k=1.0))
         .layer(Pool(kernel=(3, 3), strides=(2, 2), pooling_type="max"))
         .layer(Conv(n_out=c3, kernel=(3, 3), activation="relu"))
         .layer(Conv(n_out=c4, kernel=(3, 3), activation="relu"))
         .layer(Conv(n_out=c5, kernel=(3, 3), activation="relu"))
         .layer(Pool(kernel=(3, 3), strides=(2, 2), pooling_type="max"))
         .layer(Dense(n_out=d, activation="relu"))
         .layer(Dense(n_out=d, activation="relu"))
         .layer(Out(n_out=10, activation="softmax", loss="mcxent")))
    return b.set_input_type(inputs.convolutional(67, 67, 3)).build()


def test_alexnet_shaped_output_and_fit_batch_match_jax():
    jconf = _alexnet_shaped(JaxNNConf, JaxInputType,
                            (JaxConv, JaxLRN, JaxPool, JaxDense, JaxOutput),
                            JaxNesterovs(lr=1e-2, momentum=0.9))
    conf = _alexnet_shaped(NeuralNetConfiguration, InputType,
                           (ConvolutionLayer, LocalResponseNormalizationLayer,
                            SubsamplingLayer, DenseLayer, OutputLayer),
                           Nesterovs(lr=1e-2, momentum=0.9))
    assert conf.to_json() == jconf.to_json()
    assert conf.layer_input_types[9].shape == (3, 3, 12)
    assert conf.layer_input_types[10].shape == (12,)
    from deeplearning4j_tpu.nn.multilayer import (
        MultiLayerNetwork as JaxNetwork,
    )

    jnet = JaxNetwork(jconf).init()
    net = _port_of(jnet, conf)
    x, _ = _images(2, 4, (67, 67, 3), 10)
    x *= 4.0  # large enough that the LRN window sums matter
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(jnp.asarray(x))), **TOL)
    n = (LRN_FWD.launches, LRN_BWD.launches)
    batches = [_images(20 + s, 4, (67, 67, 3), 10) for s in range(3)]
    _train_three_steps(jnet, net, [(4.0 * x, y) for x, y in batches])
    assert (LRN_FWD.launches, LRN_BWD.launches) == n  # CPU: plain only


def test_alexnet_configuration_round_trips_and_runs_in_eval_mode():
    model = AlexNet(height=67, width=67, num_classes=10)
    js = model.conf().to_json()
    assert js == JaxAlexNet(height=67, width=67, num_classes=10).conf().to_json()
    assert AlexNet().conf().to_json() == JaxAlexNet().conf().to_json()
    conf = MultiLayerConfiguration.from_json(js)
    assert conf.to_json() == js
    assert [type(l).__name__ for l in conf.layers].count(
        "LocalResponseNormalizationLayer") == 2
    net = MultiLayerNetwork(conf).init(device="cpu")
    x, _ = _images(3, 3, (67, 67, 3), 10)
    out = net.output(x)
    again = net.output(x)  # eval mode: no dropout, the same answer
    assert tuple(out.shape) == (3, 10) and torch.equal(out, again)
    torch.testing.assert_close(out.sum(-1), torch.ones(3))


def test_alexnet_published_shapes():
    conf = AlexNet().conf()
    shapes = [t.shape for t in conf.layer_input_types]
    assert shapes[1] == (54, 54, 96) and shapes[4] == (26, 26, 256)
    assert shapes[10] == (6400,) and conf.output_type.shape == (1000,)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zip_crosses_packages_mid_training(tmp_path, writer):
    jnet = JaxLeNet().init()
    net = _port_of(jnet, LeNet().conf())
    for s in range(2):
        x, y = _images(30 + s, 4, (784,), 10)
        jnet.fit_batch((x, y))
        net.fit_batch((x, y))
    path = str(tmp_path / "lenet.zip")
    if writer == "port":
        net.save(path)
        jnet = jax_restore(path)
    else:
        jnet.save(path)
        net = MultiLayerNetwork.load(path, device="cpu")
    assert net.step_count == jnet.step_count == 2
    assert tuple(net.params[0]["W"].shape) == (5, 5, 1, 20)  # HWIO
    _assert_trees_close(net.params, jnet.params, atol=0, rtol=0)
    _assert_trees_close(net.opt_state, jnet.opt_state, atol=0, rtol=0)
    x, y = _images(32, 4, (784,), 10)
    np.testing.assert_allclose(net.fit_batch((x, y)),
                               float(jnet.fit_batch((x, y))), rtol=1e-5)


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_alexnet_shaped_on_card_runs_the_lrn_kernels(cuda_device):
    """2 LRN forward launches per output(), 2 + 2 per fit_batch, and the
    same output as the CPU's plain path (TF32 off)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        conf = lambda: _alexnet_shaped(  # noqa: E731
            NeuralNetConfiguration, InputType,
            (ConvolutionLayer, LocalResponseNormalizationLayer,
             SubsamplingLayer, DenseLayer, OutputLayer),
            Nesterovs(lr=1e-2, momentum=0.9), widths=(96, 64, 32, 32, 32, 64))
        net = MultiLayerNetwork(conf()).init(device="cpu")
        card = MultiLayerNetwork(conf()).init(device=cuda_device)
        load_jax_params(card, [{k: a.numpy() for k, a in p.items()}
                               for p in net.params])
        x, y = _images(40, 4, (67, 67, 3), 10)
        n = (LRN_FWD.launches, LRN_BWD.launches)
        got = card.output(4.0 * x)
        torch.cuda.synchronize()
        assert (LRN_FWD.launches, LRN_BWD.launches) == (n[0] + 2, n[1])
        np.testing.assert_allclose(got.cpu().numpy(),
                                   net.output(4.0 * x).numpy(), atol=1e-5)
        card.fit_batch((4.0 * x, y))
        torch.cuda.synchronize()
        assert (LRN_FWD.launches, LRN_BWD.launches) == (n[0] + 4, n[1] + 2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
