"""The port's conv catalog against the JAX package, on shared numpy inputs
from a seed.

- Activations: every one of the 23 names and the four parametric forms
  against ``get_activation`` of the JAX package over x in [-30, 30], f32,
  within 1e-6 (relative to max(1, |y|)).
- The nine new ops (``conv1d``, ``conv3d``, ``deconv2d``,
  ``depthwise_conv2d``, ``maxpool3d``, ``avgpool3d``, ``upsampling2d``,
  ``space_to_depth``, ``depth_to_space``) against the JAX ops, f32, within
  1e-5: ``deconv2d`` at k in {2, 3, 4}, s in {1, 2}, SAME, VALID and
  explicit (0, 1); depthwise with mult in {1, 2}; the space_to_depth /
  depth_to_space round trip and channel order.
- Each new layer: ``output_type``, ``init`` shapes and ``apply`` against
  its JAX twin on the JAX layer's params (f32, 1e-5), and a test that
  pins the Deconvolution2D ``output_type`` / ``apply`` mismatch the JAX
  layer has.
- The catalogs: every JAX op name but three, every layer but the two
  autoencoders, every zoo model; ``RandomProvider``'s seeding (torch
  streams, so determinism and moments, not threefry's values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.layers as jax_layers
import deeplearning4j_tpu.zoo as jax_zoo
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.preprocessors import (
    auto_preprocessor as jax_auto_preprocessor,
)
from deeplearning4j_tpu.ops import activations as jax_act
from deeplearning4j_tpu.ops import convolution as jax_conv
from deeplearning4j_tpu.ops.registry import _REGISTRY as JAX_OPS
import deeplearning4j_tpu_torch.nn.layers as port_layers
import deeplearning4j_tpu_torch.zoo as port_zoo
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import auto_preprocessor
from deeplearning4j_tpu_torch.ops import activations, convolution
from deeplearning4j_tpu_torch.ops.registry import _REGISTRY as PORT_OPS
from deeplearning4j_tpu_torch.ops.rng import RandomProvider, get_random

TOL_ACT = 1e-6
TOL = dict(atol=1e-5, rtol=1e-5)

PARAMETRIC = ["leakyrelu:0.3", "elu:0.5", "relumax:6", "relumax:0.75",
              "thresholdedrelu:0.5", "thresholdedrelu:-1"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **(tol or TOL))


# ------------------------------------------------------------ activations

def test_activation_catalog_has_every_jax_name():
    assert sorted(activations.ACTIVATIONS) == sorted(jax_act.ACTIVATIONS)
    assert len(activations.ACTIVATIONS) == 23
    assert sorted(activations._PARAMETRIC) == sorted(jax_act._PARAMETRIC)


@pytest.mark.parametrize("name", sorted(jax_act.ACTIVATIONS) + PARAMETRIC)
def test_activation_matches_jax(name):
    x = np.concatenate([np.linspace(-30.0, 30.0, 6001, dtype=np.float32),
                        np.float32([0.0, 1.0, -1.0, 3.0, -3.0, 6.0])])
    x = x.reshape(1, -1)
    want = np.asarray(jax_act.get_activation(name)(jnp.asarray(x)))
    got = activations.get_activation(name)(_t(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max()) <= TOL_ACT, (name, float(err.max()))


def test_activation_names_and_errors():
    for name in jax_act.ACTIVATIONS:
        assert activations.activation_name(name.upper()) == \
            jax_act.activation_name(name.upper())
    assert activations.activation_name("Leaky_ReLU") == "leakyrelu"
    assert activations.activation_name(activations.ACTIVATIONS["cube"]) == "cube"
    assert activations.activation_name(torch.nn.functional.silu) == \
        jax_act.activation_name(jax.nn.silu) == "swish"
    with pytest.raises(ValueError, match="custom activation"):
        activations.activation_name(lambda x: x)
    with pytest.raises(ValueError, match="does not take a parameter"):
        activations.get_activation("relu:2")
    with pytest.raises(ValueError, match="unknown activation"):
        activations.get_activation("swishy")


# ------------------------------------------------------------------- ops

def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("padding", ["same", "valid", (0, 0), (1, 1)],
                         ids=["same", "valid", "p0", "p1"])
def test_deconv2d_matches_jax(k, s, padding):
    rng = _rng(k * 10 + s)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax_conv.deconv2d(x, w, strides=(s, s), padding=padding)
    _close(convolution.deconv2d(_t(x), _t(w), strides=(s, s),
                                padding=padding), want)


def test_deconv2d_sizes_are_lax_conv_transpose_sizes():
    """h = 5, s = 2: SAME 10, VALID 11 (k = 3), explicit (p, p)
    s(h-1) + 2p - k + 2."""
    x = torch.zeros((1, 5, 5, 1))
    for k, p, want in ((2, 0, 8), (2, 1, 10), (3, 0, 7), (3, 1, 9),
                       (4, 0, 6), (4, 1, 8)):
        y = convolution.deconv2d(x, torch.zeros((k, k, 1, 1)), strides=(2, 2),
                                 padding=(p, p))
        assert y.shape[1] == want == 2 * 4 + 2 * p - k + 2
    assert convolution.deconv2d(x, torch.zeros((3, 3, 1, 1)), strides=(2, 2),
                                padding="same").shape[1] == 10
    assert convolution.deconv2d(x, torch.zeros((3, 3, 1, 1)), strides=(2, 2),
                                padding="valid").shape[1] == 11


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("s,padding", [(1, "same"), (2, "same"),
                                       (2, "valid"), (1, (1, 1))])
def test_depthwise_conv2d_matches_jax(mult, s, padding):
    rng = _rng(mult)
    x = rng.normal(size=(2, 7, 6, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, mult)).astype(np.float32)
    want = jax_conv.depthwise_conv2d(x, w, strides=(s, s), padding=padding)
    _close(convolution.depthwise_conv2d(_t(x), _t(w), strides=(s, s),
                                        padding=padding), want)


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("padding", ["same", "valid", (1,)])
@pytest.mark.parametrize("d", [1, 2])
def test_conv1d_matches_jax(s, padding, d):
    rng = _rng(3)
    x = rng.normal(size=(2, 9, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5)).astype(np.float32)
    want = jax_conv.conv1d(x, w, strides=s, padding=padding, dilation=d)
    _close(convolution.conv1d(_t(x), _t(w), strides=s, padding=padding,
                              dilation=d), want)


@pytest.mark.parametrize("s", [(1, 1, 1), (2, 2, 2), (1, 2, 3)])
@pytest.mark.parametrize("padding", ["same", "valid", (1, 0, 1)])
def test_conv3d_matches_jax(s, padding):
    rng = _rng(4)
    x = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    w = rng.normal(size=(3, 2, 3, 3, 4)).astype(np.float32)
    want = jax_conv.conv3d(x, w, strides=s, padding=padding)
    _close(convolution.conv3d(_t(x), _t(w), strides=s, padding=padding),
           want)


@pytest.mark.parametrize("pool", ["maxpool3d", "avgpool3d"])
@pytest.mark.parametrize("kernel,strides", [((2, 2, 2), None),
                                            ((3, 3, 3), (2, 2, 2)),
                                            ((3, 2, 3), (1, 2, 2))])
@pytest.mark.parametrize("padding", ["same", "valid", (1, 1, 1)])
def test_pool3d_matches_jax(pool, kernel, strides, padding):
    """A tuple padding is VALID and avgpool3d divides by the full window
    volume under SAME, as the JAX ops do."""
    x = _rng(5).normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    want = getattr(jax_conv, pool)(x, kernel=kernel, strides=strides,
                                   padding=padding)
    _close(getattr(convolution, pool)(_t(x), kernel=kernel, strides=strides,
                                      padding=padding), want)


def test_avgpool3d_same_divides_by_the_full_window():
    y = convolution.avgpool3d(torch.ones((1, 3, 3, 3, 1)), kernel=(2, 2, 2),
                              strides=(2, 2, 2), padding="same")
    # the last window along each axis holds one real voxel of 8 on that axis
    assert float(y[0, -1, -1, -1, 0]) == pytest.approx(1 / 8)
    assert float(y[0, 0, 0, 0, 0]) == 1.0


def test_upsampling2d_matches_jax():
    x = _rng(6).normal(size=(2, 4, 6, 3)).astype(np.float32)
    for size in ((2, 2), (2, 3), (1, 4)):
        _close(convolution.upsampling2d(_t(x), size=size),
               jax_conv.upsampling2d(x, size=size))


@pytest.mark.parametrize("block", [2, 3])
def test_space_to_depth_and_back_match_jax(block):
    x = _rng(7).normal(size=(2, 6, 12, 5)).astype(np.float32)
    s2d = convolution.space_to_depth(_t(x), block=block)
    _close(s2d, jax_conv.space_to_depth(x, block=block))
    _close(convolution.depth_to_space(s2d, block=block), x, atol=0, rtol=0)
    y = _rng(8).normal(size=(2, 3, 4, 5 * block * block)).astype(np.float32)
    _close(convolution.depth_to_space(_t(y), block=block),
           jax_conv.depth_to_space(y, block=block))


def test_space_to_depth_channel_order_is_not_pixel_unshuffle():
    """Channel (bh * block + bw) * C + c, where F.pixel_unshuffle on NCHW
    gives c * block^2 + bh * block + bw."""
    x = torch.arange(32, dtype=torch.float32).reshape(1, 4, 4, 2)
    y = convolution.space_to_depth(x, block=2)
    for bh in range(2):
        for bw in range(2):
            for c in range(2):
                assert torch.equal(y[0, :, :, (bh * 2 + bw) * 2 + c],
                                   x[0, bh::2, bw::2, c])
    pu = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), 2)
    assert not torch.equal(pu.permute(0, 2, 3, 1), y)


def test_registry_has_every_jax_op_but_three():
    """The three this slice left have all come: the KV-cache decode's
    cached_dot_product_attention, then the two int8 ops with the
    quantization slice, each a plain lowering only, as in the JAX
    package: the port registers 22 of 22."""
    assert set(JAX_OPS) - set(PORT_OPS) == set()
    assert len(set(JAX_OPS) & set(PORT_OPS)) == len(JAX_OPS) == 22
    for name in ("cached_dot_product_attention", "quantized_matmul",
                 "quantized_einsum"):
        assert [i.platform for i in PORT_OPS[name].impls] == ["plain"]
    for name in ("conv1d", "conv3d", "deconv2d", "depthwise_conv2d",
                 "maxpool3d", "avgpool3d", "upsampling2d", "space_to_depth",
                 "depth_to_space"):
        impls = PORT_OPS[name].impls
        assert [i.platform for i in impls] == ["plain"], name


# ---------------------------------------------------------------- layers

def _itype_pair(kind, *shape):
    return (getattr(JaxInputType, kind)(*shape),
            getattr(InputType, kind)(*shape))


# (layer name, kwargs, input type kind and shape, input shape)
LAYERS = [
    ("Convolution1DLayer", dict(n_out=5, kernel=3, strides=2),
     ("recurrent", 4, 9), (2, 9, 4)),
    ("Convolution1DLayer", dict(n_out=5, kernel=3, padding=1, dilation=2,
                                activation="relu"),
     ("recurrent", 4, 9), (2, 9, 4)),
    ("Convolution3DLayer", dict(n_out=4, kernel=(3, 2, 3), strides=(1, 2, 1),
                                activation="tanh"),
     ("convolutional3d", 5, 6, 7, 3), (2, 5, 6, 7, 3)),
    ("Convolution3DLayer", dict(n_out=4, padding=(1, 0, 1), has_bias=False),
     ("convolutional3d", 5, 6, 7, 3), (2, 5, 6, 7, 3)),
    ("Deconvolution2DLayer", dict(n_out=4), ("convolutional", 5, 6, 3),
     (2, 5, 6, 3)),
    ("Deconvolution2DLayer", dict(n_out=4, kernel=(3, 3), strides=(2, 2),
                                  padding=(1, 1), activation="relu"),
     ("convolutional", 5, 6, 3), (2, 5, 6, 3)),
    ("SeparableConvolution2DLayer", dict(n_out=6, depth_multiplier=2,
                                         strides=(2, 2), activation="relu"),
     ("convolutional", 7, 6, 3), (2, 7, 6, 3)),
    ("SeparableConvolution2DLayer", dict(n_out=6, padding=(1, 1),
                                         has_bias=False),
     ("convolutional", 7, 6, 3), (2, 7, 6, 3)),
    ("DepthwiseConvolution2DLayer", dict(depth_multiplier=2, strides=(2, 2)),
     ("convolutional", 7, 6, 3), (2, 7, 6, 3)),
    ("DepthwiseConvolution2DLayer", dict(kernel=(2, 3), padding="valid",
                                         activation="leakyrelu"),
     ("convolutional", 7, 6, 3), (2, 7, 6, 3)),
    ("Subsampling1DLayer", dict(kernel=3, strides=2),
     ("recurrent", 4, 9), (2, 9, 4)),
    ("Subsampling1DLayer", dict(kernel=2, pooling_type="avg", padding="same"),
     ("recurrent", 4, 9), (2, 9, 4)),
    ("Upsampling2DLayer", dict(size=(2, 3)), ("convolutional", 3, 4, 2),
     (2, 3, 4, 2)),
    ("Cropping2DLayer", dict(crop=((1, 0), (2, 1))),
     ("convolutional", 6, 7, 2), (2, 6, 7, 2)),
    ("Cropping2DLayer", dict(crop=(1, 2)), ("convolutional", 6, 7, 2),
     (2, 6, 7, 2)),
    ("Cropping2DLayer", dict(crop=(0, 1, 2, 0)), ("convolutional", 6, 7, 2),
     (2, 6, 7, 2)),
    ("SpaceToDepthLayer", dict(block=2), ("convolutional", 6, 4, 3),
     (2, 6, 4, 3)),
    ("ElementWiseMultiplicationLayer", dict(activation="sigmoid"),
     ("feed_forward", 5), (3, 5)),
    ("RMSNormLayer", dict(), ("recurrent", 6, 4), (2, 4, 6)),
    ("RMSNormLayer", dict(n_out=6, eps=1e-3), ("feed_forward", 6), (3, 6)),
    ("DropoutLayer", dict(rate=0.3), ("feed_forward", 5), (3, 5)),
    ("LossLayer", dict(activation="softmax"), ("feed_forward", 5), (3, 5)),
    ("CnnLossLayer", dict(), ("convolutional", 3, 4, 2), (2, 3, 4, 2)),
    ("CenterLossOutputLayer", dict(n_out=4, alpha=0.1),
     ("feed_forward", 5), (3, 5)),
]


def _layer_pair(name, kw):
    return getattr(jax_layers, name)(**kw), getattr(port_layers, name)(**kw)


@pytest.mark.parametrize("name,kw,itype,shape", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_layer_matches_jax(name, kw, itype, shape):
    """output_type, init shapes (params and state) and eval apply on the
    JAX layer's params; the JSON of the layer both ways."""
    jl, pl = _layer_pair(name, kw)
    jt, pt = _itype_pair(itype[0], *itype[1:])
    assert pl.output_type(pt).to_dict() == jl.output_type(jt).to_dict()
    jp, js = jl.init(jax.random.key(3), jt)
    pp, ps = pl.init(torch.Generator().manual_seed(3), pt, "cpu")
    shapes = lambda t: {k: tuple(v.shape) for k, v in t.items()}  # noqa: E731
    assert shapes(pp) == shapes(jp) and shapes(ps) == shapes(js)
    assert pl.to_dict() == jl.to_dict()
    assert port_layers.Layer.from_dict(jl.to_dict()) == pl
    x = _rng(9).normal(size=shape).astype(np.float32)
    want, _ = jl.apply(jp, js, jnp.asarray(x))
    got, _ = pl.apply({k: _t(v) for k, v in jp.items()},
                      {k: _t(v) for k, v in js.items()}, _t(x))
    _close(got, want)


def test_deconv_output_type_and_apply_disagree_as_in_jax():
    """Deconvolution2D's output_type uses DL4J's s(h-1) + k - 2p, its apply
    lax's size: at h = 5, s = 2 they agree only where k = 2p + 1 (and
    under SAME). Both packages agree with each other on both."""
    x = np.zeros((1, 5, 5, 2), np.float32)
    for k, p, typed, applied in ((2, 0, 10, 8), (2, 1, 8, 10), (3, 0, 11, 7),
                                 (3, 1, 9, 9), (4, 0, 12, 6), (4, 1, 10, 8)):
        kw = dict(n_out=1, kernel=(k, k), strides=(2, 2), padding=(p, p))
        jl, pl = _layer_pair("Deconvolution2DLayer", kw)
        jt, pt = _itype_pair("convolutional", 5, 5, 2)
        assert pl.output_type(pt).shape[0] == jl.output_type(jt).shape[0] \
            == typed
        jp, _ = jl.init(jax.random.key(0), jt)
        got, _ = pl.apply({k_: _t(v) for k_, v in jp.items()}, {}, _t(x))
        want, _ = jl.apply(jp, {}, jnp.asarray(x))
        assert got.shape[1] == want.shape[1] == applied
        assert (typed == applied) == (k == 2 * p + 1)
    jl, pl = _layer_pair("Deconvolution2DLayer", dict(n_out=1, kernel=(3, 3),
                                                      padding="valid"))
    assert pl.output_type(InputType.convolutional(5, 5, 2)).shape[0] == 11
    got, _ = pl.apply({"W": torch.zeros((3, 3, 2, 1)),
                       "b": torch.zeros(1)}, {}, _t(x))
    assert got.shape[1] == 11  # VALID agrees at k = 3 >= s = 2


def test_dropout_layer_draws_from_the_generator_and_is_identity_in_eval():
    layer = port_layers.DropoutLayer(rate=0.25)
    x = torch.ones((400, 50))
    y, _ = layer.apply({}, {}, x)
    assert y is x
    with pytest.raises(ValueError, match="generator"):
        layer.apply({}, {}, x, train=True)
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a, _ = layer.apply({}, {}, x, train=True, rng=g())
    b, _ = layer.apply({}, {}, x, train=True, rng=g())
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.01


def test_center_loss_score_and_update_match_jax():
    jl, pl = _layer_pair("CenterLossOutputLayer",
                         dict(n_out=4, alpha=0.3, lambda_=0.7))
    rng = _rng(10)
    feats = rng.normal(size=(6, 5)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    centers = rng.normal(size=(4, 5)).astype(np.float32)
    mask = np.float32([1, 0, 1, 1, 0, 1])
    for m in (None, mask):
        ws, wst = jl.center_score_and_state(
            {}, {"centers": jnp.asarray(centers)}, jnp.asarray(feats),
            jnp.asarray(labels), mask=None if m is None else jnp.asarray(m))
        gs, gst = pl.center_score_and_state(
            {}, {"centers": _t(centers)}, _t(feats), _t(labels),
            mask=None if m is None else _t(m))
        _close(gs, ws)
        _close(gst["centers"], wst["centers"])


@pytest.mark.parametrize("name", ["Convolution1DLayer", "Subsampling1DLayer"])
def test_no_preprocessor_before_a_1d_layer_as_in_jax(name):
    kw = dict(n_out=3) if name == "Convolution1DLayer" else {}
    jl, pl = _layer_pair(name, kw)
    assert auto_preprocessor(InputType.convolutional(4, 4, 2), pl) is None
    assert jax_auto_preprocessor(JaxInputType.convolutional(4, 4, 2), jl) is None


@pytest.mark.parametrize("name", ["Deconvolution2DLayer",
                                  "SeparableConvolution2DLayer",
                                  "DepthwiseConvolution2DLayer",
                                  "Upsampling2DLayer", "Cropping2DLayer",
                                  "SpaceToDepthLayer"])
def test_cnn_flat_input_is_reshaped_before_new_conv_layers(name):
    kw = (dict(n_out=3) if name in ("Deconvolution2DLayer",
                                    "SeparableConvolution2DLayer") else {})
    jl, pl = _layer_pair(name, kw)
    got = auto_preprocessor(InputType.convolutional_flat(4, 4, 2), pl)
    want = jax_auto_preprocessor(JaxInputType.convolutional_flat(4, 4, 2), jl)
    assert got.to_dict() == want.to_dict()


def test_layer_catalog_matches_jax_but_the_autoencoders():
    """The autoencoders have come with the pretrain tier: the catalog is
    whole."""
    missing = set(jax_layers.__all__) - set(port_layers.__all__)
    assert missing == set()
    assert {"AutoEncoderLayer", "VariationalAutoencoderLayer"} <= set(
        port_layers.__all__)


def test_zoo_has_every_jax_model():
    assert set(jax_zoo.__all__) <= set(port_zoo.__all__)


# ------------------------------------------------------------------- rng

def test_random_provider_seeding_and_moments():
    a = RandomProvider(11, device="cpu")
    b = RandomProvider(11, device="cpu")
    assert a.seed == 11
    ua, ub = a.uniform((20000,), -2.0, 3.0), b.uniform((20000,), -2.0, 3.0)
    assert torch.equal(ua, ub)
    assert float(ua.min()) >= -2.0 and float(ua.max()) < 3.0
    assert abs(float(ua.mean()) - 0.5) < 0.05
    n = a.normal((20000,))
    assert not torch.equal(n, b.uniform((20000,)))  # streams moved apart
    assert abs(float(n.mean())) < 0.03 and abs(float(n.std()) - 1) < 0.03
    bern = a.bernoulli(0.3, (20000,))
    assert bern.dtype == torch.bool
    assert abs(float(bern.float().mean()) - 0.3) < 0.02
    # each draw consumes a split: the next draw differs, a reseed repeats
    assert not torch.equal(a.normal((8,)), a.normal((8,)))
    a.set_seed(11)
    assert torch.equal(a.uniform((20000,), -2.0, 3.0), ua)
    gens = a.split(3)
    assert len(gens) == 3 and all(isinstance(g, torch.Generator)
                                  for g in gens)
    draws = [torch.rand(4, generator=g) for g in gens]
    assert not torch.equal(draws[0], draws[1])
    assert a.normal((3,), dtype=torch.float64).dtype == torch.float64


def test_default_random_provider_is_shared():
    assert get_random() is get_random()
    assert isinstance(get_random(), RandomProvider)
