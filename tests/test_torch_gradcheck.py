"""The port's gradient checker (``deeplearning4j_tpu_torch/autodiff/
gradcheck.py``) on the port's networks, on the CPU.

Every case of ``tests/test_gradcheck.py`` and
``tests/test_gradcheck_catalog.py`` (the same layer configurations,
shapes, seeds, tolerances and sampled coordinates) runs the port's
``grad_check_model`` / ``grad_check_graph`` over a port network built from
the same configuration: autograd's gradients against central differences
in float64. The op-level loss checks run both packages' ``grad_check`` on
the same inputs. A function with a wrong backward is caught.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import grad_check as jax_grad_check
from deeplearning4j_tpu.ops.losses import get_loss as jax_get_loss
from deeplearning4j_tpu_torch.autodiff import (
    grad_check, grad_check_graph, grad_check_model,
)
from deeplearning4j_tpu_torch.common.trees import tree_leaves as _leaves
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, AutoEncoderLayer, BatchNormalizationLayer,
    BidirectionalLayer, Convolution1DLayer, Convolution3DLayer,
    ConvolutionLayer, Cropping2DLayer, Deconvolution2DLayer, DenseLayer,
    DepthwiseConvolution2DLayer, ElementWiseMultiplicationLayer,
    EmbeddingSequenceLayer, GlobalPoolingLayer, GravesBidirectionalLSTMLayer,
    GravesLSTMLayer, GRULayer, LastTimeStepLayer, LayerNormalizationLayer,
    LearnedSelfAttentionLayer, LocalResponseNormalizationLayer, LSTMLayer,
    OutputLayer, RMSNormLayer, RnnOutputLayer, SelfAttentionLayer,
    SeparableConvolution2DLayer, SimpleRnnLayer, SpaceToDepthLayer,
    Subsampling1DLayer, SubsamplingLayer, TransformerEncoderLayer,
    Upsampling2DLayer, ZeroPadding2DLayer,
)
from deeplearning4j_tpu_torch.ops.losses import get_loss
from deeplearning4j_tpu_torch.optimize.updaters import Sgd


def _net(conf_layers, itype, seed):
    b = NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.1)).list()
    for layer in conf_layers:
        b = b.layer(layer)
    return MultiLayerNetwork(b.set_input_type(itype).build()).init(
        device="cpu")


def _check(conf_layers, itype, x, y, rtol, checks, seed, mask=None):
    model = _net(conf_layers, itype, seed)
    res = grad_check_model(model, x, y, mask=mask, rtol=rtol,
                           max_checks_per_arg=checks)
    assert res["ok"], (f"gradcheck failed: max_rel={res['max_rel_error']}, "
                       f"first failures: {res['failures'][:3]}")
    return res


# ------------------------------------------------- tests/test_gradcheck.py

def _check1(conf_layers, itype, x, y, rtol=2e-2):
    return _check(conf_layers, itype, x, y, rtol, 24, 3)


class TestGradientChecks:
    def test_dense_softmax(self, rng):
        x = rng.normal(size=(8, 6)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
        _check1([DenseLayer(n_out=5, activation="tanh"),
                 OutputLayer(n_out=4, activation="softmax", loss="mcxent")],
                InputType.feed_forward(6), x, y)

    def test_cnn(self, rng):
        x = rng.normal(size=(4, 8, 8, 2)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
        _check1([ConvolutionLayer(n_out=4, kernel=(3, 3), activation="tanh"),
                 SubsamplingLayer(kernel=(2, 2), pooling_type="max"),
                 OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                InputType.convolutional(8, 8, 2), x, y)

    def test_lstm(self, rng):
        x = rng.normal(size=(4, 6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4 * 6)].reshape(
            4, 6, 3)
        _check1([LSTMLayer(n_out=7),
                 RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                InputType.recurrent(5, 6), x, y)

    def test_graves_lstm_peepholes(self, rng):
        x = rng.normal(size=(3, 5, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3 * 5)].reshape(
            3, 5, 2)
        _check1([GravesLSTMLayer(n_out=6),
                 RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                InputType.recurrent(4, 5), x, y)

    def test_batchnorm(self, rng):
        x = rng.normal(size=(8, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        _check1([DenseLayer(n_out=6, activation="identity"),
                 BatchNormalizationLayer(),
                 OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                InputType.feed_forward(5), x, y)

    def test_attention(self, rng):
        x = rng.normal(size=(3, 6, 8)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3 * 6)].reshape(
            3, 6, 2)
        _check1([SelfAttentionLayer(n_out=8, n_heads=2),
                 RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")],
                InputType.recurrent(8, 6), x, y)

    @pytest.mark.parametrize("loss", ["mse", "l1", "xent"])
    def test_op_level_losses(self, rng, loss):
        """OpValidation for raw loss ops, in both packages."""
        import jax.numpy as jnp

        y = np.abs(rng.normal(size=(4, 3))).astype(np.float32)
        p = np.abs(rng.normal(size=(4, 3))).astype(np.float32) + 0.1
        if loss == "xent":
            y = (y > y.mean()).astype(np.float32)
            p = 1.0 / (1.0 + np.exp(-p))
        fn, jfn = get_loss(loss), jax_get_loss(loss)
        res = grad_check(lambda a: fn(torch.from_numpy(y).double(), a).sum(),
                         p, rtol=2e-2, device="cpu")
        want = jax_grad_check(lambda a: jfn(jnp.asarray(y), a).sum(),
                              jnp.asarray(p), rtol=2e-2)
        assert res["ok"] and want["ok"], (res["failures"][:2],
                                          want["failures"][:2])


# ----------------------------------------- tests/test_gradcheck_catalog.py

def _ff_data(rng, n, fin, classes):
    x = rng.normal(size=(n, fin)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _seq_data(rng, n, t, fin, classes):
    x = rng.normal(size=(n, t, fin)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[
        rng.integers(0, classes, n * t)].reshape(n, t, classes)
    return x, y


def _img_data(rng, n, h, w, c, classes):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _check7(conf_layers, itype, x, y, rtol=3e-2, checks=10, mask=None):
    return _check(conf_layers, itype, x, y, rtol, checks, 7, mask=mask)


OUT3 = OutputLayer(n_out=3, activation="softmax", loss="mcxent")
ROUT2 = RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")

CNN_CASES = {
    "conv_dilated": [ConvolutionLayer(n_out=3, kernel=(3, 3), dilation=(2, 2),
                                      activation="tanh")],
    "separable_conv": [SeparableConvolution2DLayer(n_out=3, kernel=(3, 3),
                                                   activation="tanh")],
    "depthwise_conv": [DepthwiseConvolution2DLayer(
        kernel=(3, 3), depth_multiplier=2, activation="tanh")],
    "deconv": [Deconvolution2DLayer(n_out=3, kernel=(2, 2), strides=(2, 2),
                                    activation="tanh")],
    "avgpool": [ConvolutionLayer(n_out=3, kernel=(3, 3), activation="tanh"),
                SubsamplingLayer(kernel=(2, 2), pooling_type="avg")],
    "pnormpool": [ConvolutionLayer(n_out=3, kernel=(3, 3), activation="tanh"),
                  SubsamplingLayer(kernel=(2, 2), pooling_type="pnorm")],
    "lrn": [ConvolutionLayer(n_out=4, kernel=(3, 3), activation="tanh"),
            LocalResponseNormalizationLayer()],
    "upsample_crop_pad": [ZeroPadding2DLayer(pad=((1, 1), (1, 1))),
                          Upsampling2DLayer(size=(2, 2)),
                          Cropping2DLayer(crop=((1, 1), (1, 1))),
                          ConvolutionLayer(n_out=2, kernel=(3, 3),
                                           activation="tanh")],
    "space_to_depth": [SpaceToDepthLayer(block=2)],
    "global_pool_avg": [ConvolutionLayer(n_out=3, kernel=(3, 3),
                                         activation="tanh"),
                        GlobalPoolingLayer(pooling_type="avg")],
}


@pytest.mark.parametrize("name", sorted(CNN_CASES))
def test_cnn_family(rng, name):
    x, y = _img_data(rng, 2, 8, 8, 2, 3)
    _check7(CNN_CASES[name] + [OUT3], InputType.convolutional(8, 8, 2), x, y)


RNN_CASES = {
    "gru": [GRULayer(n_out=5)],
    "simple_rnn": [SimpleRnnLayer(n_out=5, activation="tanh")],
    "bidirectional_lstm_concat": [BidirectionalLayer(fwd=LSTMLayer(n_out=4),
                                                     mode="concat")],
    "bidirectional_gru_add": [BidirectionalLayer(fwd=GRULayer(n_out=4),
                                                 mode="add")],
    "graves_bidirectional": [GravesBidirectionalLSTMLayer(n_out=4)],
    "layer_norm_rnn": [SimpleRnnLayer(n_out=5, activation="tanh"),
                       LayerNormalizationLayer()],
    "rms_norm_rnn": [SimpleRnnLayer(n_out=5, activation="tanh"),
                     RMSNormLayer()],
    "learned_self_attention": [LearnedSelfAttentionLayer(n_out=6, n_heads=2,
                                                         n_queries=3),
                               SimpleRnnLayer(n_out=4, activation="tanh")],
    "transformer_encoder": [TransformerEncoderLayer(d_model=6, n_heads=2)],
}


@pytest.mark.parametrize("name", sorted(RNN_CASES))
def test_rnn_family(rng, name):
    fin = 6 if name in ("transformer_encoder",) else 4
    x, y = _seq_data(rng, 2, 5, fin, 2)
    if name == "learned_self_attention":
        # n_queries changes the sequence length
        y = np.eye(2, dtype=np.float32)[
            np.random.default_rng(0).integers(0, 2, 2 * 3)].reshape(2, 3, 2)
    _check7(RNN_CASES[name] + [ROUT2], InputType.recurrent(fin, 5), x, y)


def test_rnn_masked_gradients(rng):
    """Masked timesteps contribute zero gradient."""
    x, y = _seq_data(rng, 2, 5, 4, 2)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    _check7([LSTMLayer(n_out=4), ROUT2], InputType.recurrent(4, 5), x, y,
            mask=mask)


FF_CASES = {
    "elementwise_mult": [DenseLayer(n_out=5, activation="tanh"),
                         ElementWiseMultiplicationLayer()],
    "autoencoder": [AutoEncoderLayer(n_out=4, activation="tanh")],
    "parametric_activation": [DenseLayer(n_out=5, activation="identity"),
                              ActivationLayer(activation="leakyrelu:0.3")],
}


@pytest.mark.parametrize("name", sorted(FF_CASES))
def test_ff_family(rng, name):
    x, y = _ff_data(rng, 6, 5, 3)
    _check7(FF_CASES[name] + [OUT3], InputType.feed_forward(5), x, y)


def test_conv1d_chain(rng):
    x = rng.normal(size=(2, 8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 2)]
    _check7([Convolution1DLayer(n_out=4, kernel=3, activation="tanh"),
             Subsampling1DLayer(kernel=2, pooling_type="max"),
             GlobalPoolingLayer(pooling_type="max"),
             OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
            InputType.recurrent(3, 8), x, y)


def test_conv3d_chain(rng):
    x = rng.normal(size=(2, 4, 4, 4, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 2)]
    _check7([Convolution3DLayer(n_out=3, kernel=(2, 2, 2), activation="tanh"),
             OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
            InputType.convolutional3d(4, 4, 4, 2), x, y)


def test_embedding_sequence(rng):
    ids = rng.integers(0, 9, size=(3, 5)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3 * 5)].reshape(3, 5, 2)
    # integer inputs are not differentiable: the params only
    _check7([EmbeddingSequenceLayer(n_in=9, n_out=4),
             SimpleRnnLayer(n_out=4, activation="tanh"), ROUT2],
            InputType.recurrent(1, 5), ids, y)


def test_last_timestep_wrapper(rng):
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3)]
    _check7([LastTimeStepLayer(underlying=LSTMLayer(n_out=4)),
             OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
            InputType.recurrent(4, 5), x, y)


@pytest.mark.parametrize("loss", ["hinge", "squaredhinge", "poisson",
                                  "kld", "msle", "mape", "cosineproximity"])
def test_loss_catalog_gradients(rng, loss):
    """OpValidation for the remaining loss ops, in both packages."""
    import jax.numpy as jnp

    if loss in ("hinge", "squaredhinge"):
        y = np.where(rng.random((4, 3)) > 0.5, 1.0, -1.0).astype(np.float32)
        p = rng.normal(size=(4, 3)).astype(np.float32)
    elif loss in ("poisson", "kld", "msle", "mape"):
        y = (np.abs(rng.normal(size=(4, 3))) + 0.2).astype(np.float32)
        p = (np.abs(rng.normal(size=(4, 3))) + 0.2).astype(np.float32)
    else:
        y = rng.normal(size=(4, 3)).astype(np.float32)
        p = rng.normal(size=(4, 3)).astype(np.float32)
    fn, jfn = get_loss(loss), jax_get_loss(loss)
    res = grad_check(lambda a: fn(torch.from_numpy(y).double(), a).sum(), p,
                     rtol=3e-2, device="cpu")
    want = jax_grad_check(lambda a: jfn(jnp.asarray(y), a).sum(),
                          jnp.asarray(p), rtol=3e-2)
    assert res["ok"] and want["ok"], (res["failures"][:2],
                                      want["failures"][:2])


class TestGraphGradients:
    """GradientCheckTestsComputationGraph: DAG topologies."""

    @staticmethod
    def _builder():
        return (NeuralNetConfiguration.builder().seed(5).updater(Sgd(lr=0.1))
                .graph_builder())

    def test_residual_gradients(self, rng):
        from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex

        conf = (self._builder().add_inputs("in")
                .set_input_types(**{"in": InputType.feed_forward(6)})
                .add_layer("fc1", DenseLayer(n_out=6, activation="tanh"), "in")
                .add_layer("fc2", DenseLayer(n_out=6, activation="identity"),
                           "fc1")
                .add_vertex("res", ElementWiseVertex(op="add"), "fc2", "fc1")
                .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "res")
                .set_outputs("out").build())
        model = ComputationGraph(conf).init(device="cpu")
        x = rng.normal(size=(4, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
        res = grad_check_graph(model, {"in": x}, {"out": y}, rtol=3e-2,
                               max_checks_per_arg=10)
        assert res["ok"], res["failures"][:3]

    def test_multi_input_merge_gradients(self, rng):
        from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex

        conf = (self._builder().add_inputs("a", "b")
                .set_input_types(a=InputType.feed_forward(4),
                                 b=InputType.feed_forward(3))
                .add_layer("fa", DenseLayer(n_out=5, activation="tanh"), "a")
                .add_layer("fb", DenseLayer(n_out=4, activation="tanh"), "b")
                .add_vertex("m", MergeVertex(), "fa", "fb")
                .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "m")
                .set_outputs("out").build())
        model = ComputationGraph(conf).init(device="cpu")
        xa = rng.normal(size=(4, 4)).astype(np.float32)
        xb = rng.normal(size=(4, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        res = grad_check_graph(model, {"a": xa, "b": xb}, {"out": y},
                               rtol=3e-2, max_checks_per_arg=10)
        assert res["ok"], res["failures"][:3]

    def test_multi_output_gradients(self, rng):
        conf = (self._builder().add_inputs("in")
                .set_input_types(**{"in": InputType.feed_forward(5)})
                .add_layer("trunk", DenseLayer(n_out=6, activation="tanh"),
                           "in")
                .add_layer("out1", OutputLayer(n_out=2, activation="softmax",
                                               loss="mcxent"), "trunk")
                .add_layer("out2", OutputLayer(n_out=3, activation="identity",
                                               loss="mse"), "trunk")
                .set_outputs("out1", "out2").build())
        model = ComputationGraph(conf).init(device="cpu")
        x = rng.normal(size=(4, 5)).astype(np.float32)
        y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        y2 = rng.normal(size=(4, 3)).astype(np.float32)
        res = grad_check_graph(model, {"in": x}, {"out1": y1, "out2": y2},
                               rtol=3e-2, max_checks_per_arg=10)
        assert res["ok"], res["failures"][:3]


# --------------------------------------------------- the checker catches

class _WrongSquare(torch.autograd.Function):
    """x^2 whose backward forgets the factor 2."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * x


def test_a_wrong_gradient_is_caught(rng):
    x = rng.normal(size=(3, 4)).astype(np.float32)
    res = grad_check(lambda a: _WrongSquare.apply(a).sum(), x, device="cpu")
    assert not res["ok"]
    assert len(res["failures"]) == 12
    f = res["failures"][0]
    np.testing.assert_allclose(f["numeric"], 2 * f["analytic"], rtol=1e-6)
    assert grad_check(lambda a: (a * a).sum(), x, device="cpu")["ok"]


def test_a_model_with_a_wrong_layer_gradient_is_caught(rng, monkeypatch):
    """The tanh of a dense layer through a backward that drops 1 - y^2."""
    import deeplearning4j_tpu_torch.ops.activations as acts

    class _WrongTanh(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return torch.tanh(x)

        @staticmethod
        def backward(ctx, g):
            return g

    model = _net([DenseLayer(n_out=5, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                 InputType.feed_forward(4), 3)
    x, y = _ff_data(rng, 6, 4, 3)
    assert grad_check_model(model, x, y, rtol=2e-2)["ok"]
    monkeypatch.setitem(acts.ACTIVATIONS, "tanh", _WrongTanh.apply)
    res = grad_check_model(model, x, y, rtol=2e-2)
    assert not res["ok"] and res["failures"]


def _recording(seen):
    def fn(a):
        seen.append((a.dtype, a.device.type))
        return (a * a).sum()
    return fn


def test_checks_run_in_float64_on_the_cpu():
    """Asked for the CPU, or given CPU tensors, the check runs there."""
    seen = []
    grad_check(_recording(seen), np.ones((2, 2), np.float32),
               max_checks_per_arg=1, device="cpu")
    grad_check(_recording(seen), torch.ones(2, 2), max_checks_per_arg=1)
    assert set(seen) == {(torch.float64, "cpu")}


def test_host_arrays_go_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the check runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        grad_check(_recording([]), np.ones((2, 2), np.float32))


def test_a_network_on_the_cpu_is_checked_on_the_cpu(rng, monkeypatch):
    seen = set()
    model = _net([DenseLayer(n_out=5, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
                 InputType.feed_forward(4), 3)
    loss_terms = model._loss_terms

    def spy(p, x, y, m, train):
        seen.update((t.dtype, t.device.type) for t in (x, y, *_leaves(p)))
        return loss_terms(p, x, y, m, train=train)

    monkeypatch.setattr(model, "_loss_terms", spy)
    x, y = _ff_data(rng, 6, 4, 3)
    assert grad_check_model(model, x, y, rtol=2e-2,
                            max_checks_per_arg=4)["ok"]
    assert seen == {(torch.float64, "cpu")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_network_on_the_card_is_checked_on_the_card(cuda_device, rng,
                                                      monkeypatch):
    """A dense net and a residual graph on the card: every leaf and input
    of the checked loss is a float64 tensor on the card, and the checks
    pass there."""
    seen = set()
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Sgd(lr=0.1))
            .list().layer(DenseLayer(n_out=5, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    model = MultiLayerNetwork(conf).init(device=cuda_device)
    loss_terms = model._loss_terms

    def spy(p, x, y, m, train):
        seen.update((t.dtype, t.device.type) for t in (x, y, *_leaves(p)))
        return loss_terms(p, x, y, m, train=train)

    monkeypatch.setattr(model, "_loss_terms", spy)
    x, y = _ff_data(rng, 6, 4, 3)
    assert grad_check_model(model, x, y, rtol=2e-2)["ok"]
    assert seen == {(torch.float64, "cuda")}
    assert all(t.dtype == torch.float32 for t in _leaves(model.params))

    from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex

    gconf = (NeuralNetConfiguration.builder().seed(5).updater(Sgd(lr=0.1))
             .graph_builder().add_inputs("in")
             .set_input_types(**{"in": InputType.feed_forward(6)})
             .add_layer("fc1", DenseLayer(n_out=6, activation="tanh"), "in")
             .add_layer("fc2", DenseLayer(n_out=6, activation="identity"),
                        "fc1")
             .add_vertex("res", ElementWiseVertex(op="add"), "fc2", "fc1")
             .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"), "res")
             .set_outputs("out").build())
    graph = ComputationGraph(gconf).init(device=cuda_device)
    xg = rng.normal(size=(4, 6)).astype(np.float32)
    yg = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    assert grad_check_graph(graph, {"in": xg}, {"out": yg}, rtol=3e-2)["ok"]
