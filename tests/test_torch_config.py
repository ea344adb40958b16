"""Configuration JSON and model zips shared by the JAX package and the port.

The port reads the JAX package's configuration JSON and writes it back
unchanged, and restores a model zip the JAX package wrote; the restored
net gives the JAX net's outputs at 1e-5 in f32.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    AutoEncoderLayer as JaxAutoEncoder, DenseLayer as JaxDense,
    GravesLSTMLayer as JaxGraves, OutputLayer as JaxOut,
    RnnOutputLayer as JaxRnnOut,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam
from deeplearning4j_tpu.optimize.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.zoo.textgen import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import FlattenPreProcessor
from deeplearning4j_tpu_torch.nn.layers import GravesLSTMLayer, LSTMLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import RMSProp
from deeplearning4j_tpu_torch.util.serialization import restore_multi_layer_network
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM


def _graves_conf():
    return (JaxNNC.builder().seed(3).updater(JaxAdam(lr=2e-3, clipnorm=1.0))
            .list()
            .layer(JaxGraves(n_out=7, name="g0",
                             updater=JaxNesterovs(lr=0.05)))
            .layer(JaxRnnOut(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(6, 3)).build())


def _dense_conf():
    return (JaxNNC.builder().seed(7).list()
            .layer(JaxDense(n_out=5, activation="tanh", bias_init=0.1))
            .layer(JaxOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(6)).build())


def _flatten_conf():
    return (JaxNNC.builder().seed(9).data_type("bf16").list()
            .layer(JaxDense(n_out=5, activation="sigmoid", weight_init="zero"))
            .layer(JaxOut(n_out=3, activation="identity", loss="mse"))
            .set_input_type(JaxInputType.convolutional(2, 3, 4)).build())


CONFS = {
    "textgen": lambda: JaxTextGen().conf(),
    "graves": _graves_conf,
    "dense": _dense_conf,
    "cnn_flatten": _flatten_conf,
}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_json_round_trip(name):
    text = CONFS[name]().to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert json.loads(conf.to_json()) == json.loads(text)


def test_port_textgen_writes_the_jax_json():
    assert (json.loads(TextGenerationLSTM().conf().to_json())
            == json.loads(JaxTextGen().conf().to_json()))


def test_resolved_types_and_records():
    conf = MultiLayerConfiguration.from_json(_graves_conf().to_json())
    assert isinstance(conf.layers[0], GravesLSTMLayer)
    assert conf.layers[0].updater.momentum == 0.9
    assert conf.updater.clipnorm == 1.0
    assert [t.kind for t in conf.layer_input_types] == ["rnn", "rnn"]
    flat = MultiLayerConfiguration.from_json(_flatten_conf().to_json())
    assert flat.preprocessors == {0: FlattenPreProcessor()}
    assert isinstance(MultiLayerConfiguration.from_json(
        JaxTextGen().conf().to_json()).updater, RMSProp)


def test_unported_layer_is_named():
    """Every layer of the JAX catalog is ported (the autoencoders came
    last), so a layer neither package has stands in for an unported one:
    the error names it."""
    conf = (JaxNNC.builder().list()
            .layer(JaxAutoEncoder(n_out=2))
            .layer(JaxOut(n_out=2))
            .set_input_type(JaxInputType.feed_forward(5)).build())
    MultiLayerConfiguration.from_json(conf.to_json())
    text = conf.to_json().replace('"AutoEncoderLayer"', '"SparseCodingLayer"')
    with pytest.raises(ValueError, match="SparseCodingLayer"):
        MultiLayerConfiguration.from_json(text)


def _restore_and_compare(jnet, path, x):
    jnet.save(str(path))
    net = restore_multi_layer_network(str(path), device="cpu")
    assert net.device == torch.device("cpu")
    for mine, theirs in zip(net.params, jnet.params):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]))
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               atol=1e-5, rtol=1e-5)
    return net


def test_restore_jax_textgen_zip(tmp_path):
    jnet = JaxTextGen(units=12, vocab_size=10, seed=4).init()
    x = np.eye(10, dtype=np.float32)[np.random.default_rng(0).integers(0, 10, (2, 7))]
    net = _restore_and_compare(jnet, tmp_path / "textgen.zip", x)
    assert all(isinstance(l, LSTMLayer) for l in net.layers[:2])


def test_restore_jax_graves_zip(tmp_path):
    jnet = JaxNet(_graves_conf()).init()
    rng = np.random.default_rng(1)
    jnet.params[0]["pW"] = jnet.params[0]["pW"] + rng.normal(size=21).astype(np.float32)
    x = rng.normal(size=(3, 3, 6)).astype(np.float32)
    _restore_and_compare(jnet, tmp_path / "graves.zip", x)


def test_restore_jax_dense_zip(tmp_path):
    jnet = JaxNet(_dense_conf()).init()
    x = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    _restore_and_compare(jnet, tmp_path / "dense.zip", x)


def test_restore_rejects_graph_zip(tmp_path):
    import zipfile

    path = tmp_path / "graph.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps({"model_class": "ComputationGraph"}))
    with pytest.raises(ValueError, match="ComputationGraph"):
        restore_multi_layer_network(str(path), device="cpu")


def test_port_init_is_seeded_and_device_explicit():
    a = TextGenerationLSTM(units=8, vocab_size=5, seed=1).init(device="cpu")
    b = TextGenerationLSTM(units=8, vocab_size=5, seed=1).init(device="cpu")
    c = TextGenerationLSTM(units=8, vocab_size=5, seed=2).init(device="cpu")
    assert all(torch.equal(a.params[i][k], b.params[i][k])
               for i in range(3) for k in a.params[i])
    assert not torch.equal(a.params[0]["W"], c.params[0]["W"])
    assert a.params[0]["b"][8:16].tolist() == [1.0] * 8  # forget-gate bias
    assert [sorted(p) for p in a.params] == [["RW", "W", "b"], ["RW", "W", "b"],
                                             ["W", "b"]]
    assert [tuple(a.params[i]["W"].shape) for i in range(3)] == [
        (5, 32), (8, 32), (8, 5)]
    b16 = MultiLayerNetwork(TextGenerationLSTM(units=8, vocab_size=5,
                                               dtype="bf16").conf())
    out = b16.init(device="cpu").output(np.eye(5, dtype=np.float32)[None])
    assert out.dtype == torch.float32 and out.shape == (1, 5, 5)
    assert b16.params[0]["W"].dtype == torch.float32  # params stay f32
