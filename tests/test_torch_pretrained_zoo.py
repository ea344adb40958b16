"""The port's pretrained-weight converters (``zoo/pretrained.py``) against
the JAX package's, on the same files.

The scenarios of ``tests/test_pretrained_zoo.py``: keras.applications VGG16
and ResNet50 built with ``weights=None`` from a seed and saved as h5, and a
small VGG-style torch CNN exported to ONNX (``onnx`` stubbed, as there).
Each file goes through both packages' converters. Tolerances: the port's
converted params equal the JAX package's exactly (both copy the same
arrays, transposed alike); the port's ``output()`` against Keras or torch
at the JAX test's limits (1e-5; ResNet50 2e-4, fifty layers of f32 conv
accumulated in other orders); the restored zip equals the converted model
bit for bit. Everything runs on the CPU.
"""

import importlib.machinery
import sys
import types

import jax
import numpy as np
import pytest
import torch


def _tf():
    try:
        import tensorflow
        return tensorflow
    except Exception:
        return None


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), tree)


def _assert_trees_equal(port_tree, jax_tree):
    pl = jax.tree_util.tree_leaves(_np_tree(port_tree))
    jl = jax.tree_util.tree_leaves(_np_tree(jax_tree))
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        np.testing.assert_array_equal(a, b)


def _keras_file(tf, tmp_path, build, name, seed):
    """(h5 path, Keras's output on two seeded images); the Keras model is
    dropped before the converters run."""
    tf.random.set_seed(seed)
    km = build(weights=None, input_shape=(224, 224, 3))
    h5 = str(tmp_path / f"{name}.h5")
    km.save(h5)
    x = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(
        np.float32)
    want = km(x, training=False).numpy()
    del km
    tf.keras.backend.clear_session()
    return h5, x, want


@pytest.mark.skipif(_tf() is None, reason="tensorflow not installed")
class TestKerasPretrained:
    def test_vgg16_round_trip(self, tmp_path):
        import tensorflow as tf

        from deeplearning4j_tpu.zoo import VGG16 as JaxVGG16
        from deeplearning4j_tpu.zoo.pretrained import (
            keras_h5_to_zoo as jax_keras_h5_to_zoo,
        )
        from deeplearning4j_tpu_torch.zoo import VGG16
        from deeplearning4j_tpu_torch.zoo.pretrained import (
            keras_h5_to_zoo, save_pretrained,
        )

        h5, x, want = _keras_file(tf, tmp_path,
                                  tf.keras.applications.VGG16, "vgg16", 1)
        m = keras_h5_to_zoo(h5, VGG16().init(device="cpu"))
        got = m.output(x).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        artifact = str(tmp_path / "vgg16_zoo.zip")
        save_pretrained(m, artifact)
        m2 = VGG16().init_pretrained(artifact, device="cpu")
        np.testing.assert_array_equal(m2.output(x).numpy(), got)
        del m2
        jm = jax_keras_h5_to_zoo(h5, JaxVGG16().init())
        _assert_trees_equal(m.params, jm.params)

    def test_resnet50_round_trip(self, tmp_path):
        import tensorflow as tf

        from deeplearning4j_tpu.zoo import ResNet50 as JaxResNet50
        from deeplearning4j_tpu.zoo.pretrained import (
            keras_h5_to_zoo as jax_keras_h5_to_zoo,
        )
        from deeplearning4j_tpu.zoo.pretrained import (
            resnet50_keras_map as jax_map,
        )
        from deeplearning4j_tpu_torch.zoo import ResNet50
        from deeplearning4j_tpu_torch.zoo.pretrained import (
            keras_h5_to_zoo, resnet50_keras_map, save_pretrained,
        )

        assert resnet50_keras_map() == jax_map()
        h5, x, want = _keras_file(tf, tmp_path,
                                  tf.keras.applications.ResNet50,
                                  "resnet50", 2)
        m = keras_h5_to_zoo(h5, ResNet50(dtype="float32").init(device="cpu"),
                            name_map=resnet50_keras_map())
        got = m.output(x).numpy()
        # 50 layers of f32 conv accumulated in other orders
        np.testing.assert_allclose(got, want, atol=2e-4)
        artifact = str(tmp_path / "resnet50_zoo.zip")
        save_pretrained(m, artifact)
        m2 = ResNet50(dtype="float32").init_pretrained(artifact,
                                                       device="cpu")
        np.testing.assert_array_equal(m2.output(x).numpy(), got)
        jm = jax_keras_h5_to_zoo(h5, JaxResNet50(dtype="float32").init(),
                                 name_map=jax_map())
        _assert_trees_equal(m.params, jm.params)
        _assert_trees_equal(m.state, jm.state)

    def test_mismatched_architecture_rejected(self, tmp_path):
        import tensorflow as tf

        from deeplearning4j_tpu.zoo import LeNet as JaxLeNet
        from deeplearning4j_tpu.zoo.pretrained import (
            keras_h5_to_zoo as jax_keras_h5_to_zoo,
        )
        from deeplearning4j_tpu_torch.zoo import LeNet
        from deeplearning4j_tpu_torch.zoo.pretrained import keras_h5_to_zoo

        km = tf.keras.Sequential([
            tf.keras.layers.Conv2D(4, 3, input_shape=(28, 28, 1)),
            tf.keras.layers.Flatten(),
            tf.keras.layers.Dense(10),
        ])
        h5 = str(tmp_path / "tiny.h5")
        km.save(h5)
        for convert, net in ((keras_h5_to_zoo, LeNet().init(device="cpu")),
                             (jax_keras_h5_to_zoo, JaxLeNet().init())):
            with pytest.raises(ValueError, match="do not align"):
                convert(h5, net)

    def test_graph_needs_a_complete_name_map(self):
        from deeplearning4j_tpu_torch.zoo import ResNet50
        from deeplearning4j_tpu_torch.zoo.pretrained import (
            keras_weights_to_zoo, resnet50_keras_map,
        )

        m = ResNet50(height=32, width=32, num_classes=4,
                     dtype="float32").init(device="cpu")
        with pytest.raises(ValueError, match="needs name_map"):
            keras_weights_to_zoo([], {}, m)
        partial = dict(resnet50_keras_map())
        partial.pop("s0b0_conva")
        with pytest.raises(ValueError, match="unmapped"):
            keras_weights_to_zoo([], {}, m, partial)


def _stub_onnx(monkeypatch):
    """torch's exporter only scans for onnxscript functions through onnx:
    a stub stands in for the package (as tests/test_pretrained_zoo.py)."""
    if "onnx" in sys.modules:
        return
    stub = types.ModuleType("onnx")
    stub.__spec__ = importlib.machinery.ModuleSpec("onnx", loader=None)
    stub.__version__ = "1.16.0"

    class _G:
        node = []

    class _M:
        graph = _G()
        functions = []

        def SerializeToString(self):
            return b""

    stub.load_model_from_string = lambda b: _M()
    monkeypatch.setitem(sys.modules, "onnx", stub)


class TestOnnxPretrained:
    def test_torch_cnn_layout_conversion(self, tmp_path, monkeypatch):
        """A small VGG-style torch export: OIHW conv kernels, transB Gemm
        and the flatten-order permutation, through both converters."""
        _stub_onnx(monkeypatch)
        import torch.nn as nn

        from deeplearning4j_tpu.nn.conf.builders import (
            NeuralNetConfiguration as JaxNNC,
        )
        from deeplearning4j_tpu.nn.multilayer import (
            MultiLayerNetwork as JaxNet,
        )
        from deeplearning4j_tpu.zoo.pretrained import (
            onnx_to_zoo as jax_onnx_to_zoo,
        )
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            MultiLayerConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.zoo.pretrained import (
            _infer_flatten_spatial, onnx_to_zoo,
        )

        torch.manual_seed(0)
        tm = nn.Sequential(
            nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(2),
            nn.Conv2d(8, 16, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(2),
            nn.Flatten(),
            nn.Linear(16 * 4 * 4, 32), nn.ReLU(),
            nn.Linear(32, 5),
        ).eval()
        x = torch.randn(2, 3, 16, 16)
        path = str(tmp_path / "cnn.onnx")
        torch.onnx.export(tm, (x,), path, input_names=["input"],
                          output_names=["logits"], opset_version=14,
                          dynamo=False)
        with torch.no_grad():
            logits = tm(x).numpy()

        from deeplearning4j_tpu.nn.conf.inputs import InputType
        from deeplearning4j_tpu.nn.layers import (
            ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
        )

        conf = (JaxNNC.builder().seed(0).list()
                .layer(ConvolutionLayer(n_out=8, kernel=(3, 3),
                                        padding="same", activation="relu"))
                .layer(SubsamplingLayer(kernel=(2, 2), strides=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(n_out=16, kernel=(3, 3),
                                        padding="same", activation="relu"))
                .layer(SubsamplingLayer(kernel=(2, 2), strides=(2, 2),
                                        pooling_type="max"))
                .layer(DenseLayer(n_out=32, activation="relu"))
                .layer(OutputLayer(n_out=5, activation="identity",
                                   loss="mse"))
                .set_input_type(InputType.convolutional(16, 16, 3)).build())
        jm = jax_onnx_to_zoo(path, JaxNet(conf).init())
        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json())).init(device="cpu")
        assert _infer_flatten_spatial(m) == (4, 4, 16)
        onnx_to_zoo(path, m)
        xn = np.transpose(x.numpy(), (0, 2, 3, 1))
        got = m.output(xn).numpy()
        np.testing.assert_allclose(got, logits, atol=1e-5)
        _assert_trees_equal(m.params, jm.params)
        np.testing.assert_allclose(got, np.asarray(jm.output(xn)),
                                   atol=1e-5)
        # the control: the first dense left in torch's C,H,W order
        bad = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json())).init(device="cpu")
        onnx_to_zoo(path, bad, flatten_spatial=(1, 1, 1))
        assert np.abs(bad.output(xn).numpy() - logits).max() > 1e-3
