"""The port's Keras import against the JAX package.

Every model of ``tests/test_kerasimport.py`` (dense, LSTM, batch norm,
separable and depthwise conv, Conv2DTranspose, upsampling / cropping /
layer norm, Bidirectional LSTM concat and sum, 1-D pooling with LeakyReLU,
and the Functional graphs: residual add, concatenate, linear, subtract,
flatten into a merge) is written to h5 here with that file's writers and
imported by both packages: the same network class, the same params, and
``output()`` within 1e-5. Also: the Keras-3 fixture ``model_k3.keras``
against ``k3_golden.npz`` and against the JAX import; a branched Keras-3
Functional archive written here; two ``fit_batch`` steps of an imported
LSTM model against the JAX package's (1e-5); and the config-JSON half
with ``h5py`` blocked (``_build`` / ``_build_graph`` and the ``reader=``
seam on a ``{name: [arrays]}`` mapping). On the card (``cuda``) the
imported Bidirectional LSTM runs the LSTM kernels.
"""

import json
import pathlib
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from test_kerasimport import _fnode, _write_functional_h5, _write_keras_h5

from deeplearning4j_tpu.modelimport import KerasModelImport as JaxImport
from deeplearning4j_tpu_torch.modelimport import KerasModelImport
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TOL = dict(rtol=1e-5, atol=1e-5)


def _r(seed):
    return np.random.default_rng(seed)


def _n(rng, *shape, s=1.0):
    return rng.normal(size=shape).astype(np.float32) * s


def _dense(name, units, act, bias=True, **kw):
    return {"class_name": "Dense",
            "config": dict(name=name, units=units, activation=act,
                           use_bias=bias, **kw)}


def _mlp(rng):
    layers = [_dense("dense", 8, "relu", batch_input_shape=[None, 6]),
              _dense("dense_1", 3, "softmax")]
    w = {"dense": [("kernel:0", _n(rng, 6, 8)), ("bias:0", _n(rng, 8))],
         "dense_1": [("kernel:0", _n(rng, 8, 3)), ("bias:0", _n(rng, 3))]}
    return layers, w, _n(rng, 4, 6)


def _lstm_w(rng, F, H, prefix=""):
    return [(f"{prefix}kernel:0", _n(rng, F, 4 * H, s=0.3)),
            (f"{prefix}recurrent_kernel:0", _n(rng, H, 4 * H, s=0.3)),
            (f"{prefix}bias:0", _n(rng, 4 * H, s=0.1))]


def _lstm(rng):
    F, H = 5, 4
    layers = [{"class_name": "LSTM",
               "config": {"name": "lstm", "units": H,
                          "batch_input_shape": [None, 7, F]}},
              _dense("dense", 2, "softmax")]
    w = {"lstm": _lstm_w(rng, F, H),
         "dense": [("kernel:0", _n(rng, H, 2)), ("bias:0", np.zeros(2,
                                                                    np.float32))]}
    return layers, w, _n(rng, 2, 7, F)


def _bn(rng):
    layers = [{"class_name": "BatchNormalization",
               "config": {"name": "bn", "epsilon": 1e-3,
                          "batch_input_shape": [None, 6]}},
              _dense("dense", 2, "softmax", bias=False)]
    w = {"bn": [("gamma:0", rng.random(6).astype(np.float32) + 0.5),
                ("beta:0", _n(rng, 6)), ("moving_mean:0", _n(rng, 6)),
                ("moving_variance:0", rng.random(6).astype(np.float32) + 0.5)],
         "dense": [("kernel:0", _n(rng, 6, 2))]}
    return layers, w, _n(rng, 3, 6)


def _separable(rng):
    C, M, F = 3, 2, 5
    layers = [{"class_name": "SeparableConv2D",
               "config": {"name": "sep", "filters": F, "kernel_size": [3, 3],
                          "padding": "same", "activation": "relu",
                          "batch_input_shape": [None, 8, 8, C]}},
              {"class_name": "DepthwiseConv2D",
               "config": {"name": "dw", "kernel_size": [3, 3],
                          "padding": "valid", "activation": "tanh",
                          "depth_multiplier": 2}}]
    w = {"sep": [("depthwise_kernel:0", _n(rng, 3, 3, C, M, s=0.3)),
                 ("pointwise_kernel:0", _n(rng, 1, 1, C * M, F, s=0.3)),
                 ("bias:0", _n(rng, F, s=0.1))],
         "dw": [("depthwise_kernel:0", _n(rng, 3, 3, F, 2, s=0.3)),
                ("bias:0", _n(rng, F * 2, s=0.1))]}
    return layers, w, _n(rng, 2, 8, 8, C)


def _deconv(rng):
    C, F = 2, 3
    layers = [{"class_name": "Conv2DTranspose",
               "config": {"name": "up", "filters": F, "kernel_size": [2, 2],
                          "strides": [2, 2], "padding": "valid",
                          "activation": "linear", "use_bias": False,
                          "batch_input_shape": [None, 4, 4, C]}}]
    return layers, {"up": [("kernel:0", _n(rng, 2, 2, F, C, s=0.5))]}, \
        _n(rng, 1, 4, 4, C)


def _upsample(rng):
    layers = [{"class_name": "UpSampling2D",
               "config": {"name": "ups", "size": [2, 2],
                          "batch_input_shape": [None, 3, 3, 4]}},
              {"class_name": "Cropping2D",
               "config": {"name": "crop", "cropping": [[1, 1], [0, 2]]}},
              {"class_name": "LayerNormalization",
               "config": {"name": "ln", "epsilon": 1e-3}}]
    w = {"ln": [("gamma:0", rng.random(4).astype(np.float32) + 0.5),
                ("beta:0", _n(rng, 4))]}
    return layers, w, _n(rng, 2, 3, 3, 4)


def _bidi(merge_mode):
    def build(rng):
        F, H, T = 3, 4, 6
        layers = [{"class_name": "Bidirectional",
                   "config": {"name": "bidi", "merge_mode": merge_mode,
                              "batch_input_shape": [None, T, F],
                              "layer": {"class_name": "LSTM",
                                        "config": {"name": "lstm", "units": H,
                                                   "return_sequences": True}}}}]
        w = {"bidi": _lstm_w(rng, F, H, "forward/")
             + _lstm_w(rng, F, H, "backward/")}
        return layers, w, _n(rng, 2, T, F)
    return build


def _pool1d(rng):
    layers = [{"class_name": "MaxPooling1D",
               "config": {"name": "mp", "pool_size": [2], "strides": [2],
                          "batch_input_shape": [None, 8, 3]}},
              {"class_name": "LeakyReLU", "config": {"name": "lr",
                                                     "alpha": 0.3}}]
    return layers, {}, _n(rng, 2, 8, 3)


def _residual(rng):
    layers = [
        _fnode("in", "InputLayer", {"batch_input_shape": [None, 6]}, []),
        _fnode("da", "Dense", {"units": 5, "activation": "relu",
                               "use_bias": True}, ["in"]),
        _fnode("db", "Dense", {"units": 5, "activation": "tanh",
                               "use_bias": True}, ["in"]),
        _fnode("add", "Add", {}, ["da", "db"]),
        _fnode("out", "Dense", {"units": 3, "activation": "softmax",
                                "use_bias": True}, ["add"])]
    w = {n: [("kernel:0", _n(rng, i, o)), ("bias:0", _n(rng, o))]
         for n, i, o in (("da", 6, 5), ("db", 6, 5), ("out", 5, 3))}
    return layers, w, _n(rng, 4, 6)


def _linear_pair(op_name, cls):
    def build(rng):
        layers = [
            _fnode("in", "InputLayer", {"batch_input_shape": [None, 4]}, []),
            _fnode("da", "Dense", {"units": 3, "activation": "linear",
                                   "use_bias": False}, ["in"]),
            _fnode("db", "Dense", {"units": 3 if cls == "Subtract" else 2,
                                   "activation": "linear", "use_bias": False},
                   ["in"]),
            _fnode(op_name, cls, {"axis": -1} if cls == "Concatenate" else {},
                   ["da", "db"]),
            _fnode("out", "Dense", {"units": 2, "activation": "softmax",
                                    "use_bias": False}, [op_name])]
        nb = 3 if cls == "Subtract" else 2
        w = {"da": [("kernel:0", _n(rng, 4, 3))],
             "db": [("kernel:0", _n(rng, 4, nb))],
             "out": [("kernel:0", _n(rng, 3 if cls == "Subtract" else 5, 2))]}
        return layers, w, _n(rng, 3, 4)
    return build


def _linear_functional(rng):
    layers = [_fnode("in", "InputLayer", {"batch_input_shape": [None, 4]}, []),
              _fnode("out", "Dense", {"units": 2, "activation": "softmax",
                                      "use_bias": False}, ["in"])]
    return layers, {"out": [("kernel:0", _n(rng, 4, 2))]}, _n(rng, 3, 4)


def _flatten_merge(rng):
    layers = [
        _fnode("in", "InputLayer", {"batch_input_shape": [None, 2, 2, 3]}, []),
        _fnode("fl", "Flatten", {}, ["in"]),
        _fnode("db", "Dense", {"units": 4, "activation": "linear",
                               "use_bias": False}, ["fl"]),
        _fnode("cat", "Concatenate", {"axis": -1}, ["fl", "db"]),
        _fnode("out", "Dense", {"units": 2, "activation": "softmax",
                                "use_bias": False}, ["cat"])]
    w = {"db": [("kernel:0", _n(rng, 12, 4))],
         "out": [("kernel:0", _n(rng, 16, 2))]}
    return layers, w, _n(rng, 3, 2, 2, 3)


# name -> (builder, Functional?, the class both packages import it as)
MODELS = {
    "mlp": (_mlp, False, "MultiLayerNetwork"),
    "lstm_gates": (_lstm, False, "MultiLayerNetwork"),
    "batchnorm": (_bn, False, "MultiLayerNetwork"),
    "separable_depthwise": (_separable, False, "MultiLayerNetwork"),
    "conv2d_transpose": (_deconv, False, "MultiLayerNetwork"),
    "upsample_crop_layernorm": (_upsample, False, "MultiLayerNetwork"),
    "bidirectional_concat": (_bidi("concat"), False, "MultiLayerNetwork"),
    "bidirectional_sum": (_bidi("sum"), False, "MultiLayerNetwork"),
    "pool1d_leakyrelu": (_pool1d, False, "MultiLayerNetwork"),
    "residual_add": (_residual, True, "ComputationGraph"),
    "concatenate": (_linear_pair("cat", "Concatenate"), True,
                    "ComputationGraph"),
    "linear_functional": (_linear_functional, True, "MultiLayerNetwork"),
    "subtract": (_linear_pair("sub", "Subtract"), True, "ComputationGraph"),
    "flatten_into_merge": (_flatten_merge, True, "ComputationGraph"),
}


def _write(path, name):
    build, functional, _ = MODELS[name]
    layers, weights, x = build(_r(sum(map(ord, name))))
    if functional:
        outs = [layers[-1]["name"]]
        _write_functional_h5(path, layers, weights, ["in"], outs)
    else:
        _write_keras_h5(path, layers, weights)
    return layers, weights, x


def _assert_params_equal(got, want):
    got = jax.tree_util.tree_map(lambda t: t.numpy(), got)
    want = jax.tree_util.tree_map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_h5_import_matches_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.h5")
    _, _, x = _write(path, name)
    jm = JaxImport.import_model(path)
    pm = KerasModelImport.import_model(path, device="cpu")
    assert type(pm).__name__ == type(jm).__name__ == MODELS[name][2]
    assert pm._keras_names == jm._keras_names
    assert pm.conf.to_json() == jm.conf.to_json()
    _assert_params_equal(pm.params, jm.params)
    _assert_params_equal(pm.state, jm.state)
    np.testing.assert_allclose(pm.output(x).numpy(),
                               np.asarray(jm.output(x)), **TOL)


def test_imported_lstm_trains_as_the_jax_import(tmp_path):
    """The imported model trains as imported: its last Dense became an
    OutputLayer (mcxent from softmax) under Adam 1e-3; two fit_batch steps
    leave the port's params within 1e-5 of the JAX package's."""
    path = str(tmp_path / "lstm.h5")
    _, _, x = _write(path, "lstm_gates")
    jm = JaxImport.import_model(path)
    pm = KerasModelImport.import_model(path, device="cpu")
    assert type(pm.layers[-1]).__name__ == "OutputLayer"
    assert pm.layers[-1].loss == "mcxent"
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    for _ in range(2):
        want = float(jm.fit_batch((x, y)))
        got = float(pm.fit_batch((x, y)))
        np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), pm.params)),
            jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_keras3_fixture_against_golden():
    g = np.load(FIXTURES / "k3_golden.npz")
    pm = KerasModelImport.import_model(str(FIXTURES / "model_k3.keras"),
                                       device="cpu")
    jm = JaxImport.import_model(str(FIXTURES / "model_k3.keras"))
    out = pm.output(g["x"]).numpy()
    np.testing.assert_allclose(out, g["y"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jm.output(g["x"])), **TOL)
    _assert_params_equal(pm.params, jm.params)


def _ktensor(name):
    return {"class_name": "__keras_tensor__",
            "config": {"shape": [None], "dtype": "float32",
                       "keras_history": [name, 0, 0]}}


def _write_keras3_branched(path, rng):
    """A Keras-3 ``.keras`` archive of a branched Functional model (v3
    keras_history inbound nodes; weights under the save-time auto names:
    the Dense layers named "left", "right" and "head" are stored as dense,
    dense_1 and dense_2)."""
    import h5py

    def node(cls, name, cfg, parents):
        args = ([[_ktensor(p) for p in parents]] if len(parents) > 1
                else [_ktensor(parents[0])])
        return {"class_name": cls, "name": name,
                "config": dict(cfg, name=name),
                "inbound_nodes": [{"args": args, "kwargs": {}}]}

    layers = [
        {"class_name": "InputLayer", "name": "x",
         "config": {"name": "x", "batch_shape": [None, 5]},
         "inbound_nodes": []},
        node("Dense", "left", {"units": 4, "activation": "relu"}, ["x"]),
        node("Dense", "right", {"units": 4, "activation": "tanh"}, ["x"]),
        node("Add", "add", {}, ["left", "right"]),
        node("Dense", "head", {"units": 3, "activation": "softmax"},
             ["add"])]
    cfg = {"class_name": "Functional",
           "config": {"name": "functional", "layers": layers,
                      "input_layers": ["x", 0, 0],
                      "output_layers": ["head", 0, 0]}}
    weights = {"dense": [_n(rng, 5, 4), _n(rng, 4)],
               "dense_1": [_n(rng, 5, 4), _n(rng, 4)],
               "dense_2": [_n(rng, 4, 3), _n(rng, 3)]}
    h5 = path.with_suffix(".weights.h5")
    with h5py.File(h5, "w") as f:
        for lname, arrs in weights.items():
            vg = f.create_group(f"layers/{lname}/vars")
            for i, a in enumerate(arrs):
                vg.create_dataset(str(i), data=a)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", json.dumps(cfg))
        z.writestr("metadata.json", json.dumps({"keras_version": "3.0.0"}))
        z.write(h5, "model.weights.h5")
    return weights


def test_keras3_branched_functional_matches_jax(tmp_path):
    path = tmp_path / "branched.keras"
    weights = _write_keras3_branched(path, _r(31))
    pm = KerasModelImport.import_model(str(path), device="cpu")
    jm = JaxImport.import_model(str(path))
    assert isinstance(pm, ComputationGraph)
    assert type(jm).__name__ == "ComputationGraph"
    np.testing.assert_array_equal(pm.params["right"]["W"].numpy(),
                                  weights["dense_1"][0])
    _assert_params_equal(pm.params, jm.params)
    x = _n(_r(32), 6, 5)
    np.testing.assert_allclose(pm.output(x).numpy(),
                               np.asarray(jm.output(x)), **TOL)


def _dict_reader(weights):
    """``reader=`` over ``{keras layer name: [(name, array), ...]}``."""
    arrays = {k: [a for _, a in v] for k, v in weights.items()}
    return arrays, lambda src, name: src.get(name, [])


@pytest.mark.parametrize("name", ["bidirectional_concat", "batchnorm",
                                  "residual_add"])
def test_config_json_half_runs_without_h5py(tmp_path, monkeypatch, name):
    """With h5py blocked, the config dict builds through _build /
    _build_graph and the weights load through the reader seam from a
    mapping; the result is the JAX package's h5 import."""
    path = str(tmp_path / f"{name}.h5")
    layers, weights, x = _write(path, name)
    jm = JaxImport.import_model(path)
    functional = MODELS[name][1]
    cfg = {"class_name": "Functional" if functional else "Sequential",
           "config": {"name": "m", "layers": layers}}
    if functional:
        cfg["config"]["input_layers"] = [["in", 0, 0]]
        cfg["config"]["output_layers"] = [[layers[-1]["name"], 0, 0]]
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        KerasModelImport.import_model(path, device="cpu")
    arrays, reader = _dict_reader(weights)
    if functional:
        pm = KerasModelImport._build_graph(cfg, device="cpu")
        KerasModelImport._load_weights_graph(pm, arrays, reader=reader)
    else:
        pm = KerasModelImport._build(cfg, device="cpu")
        KerasModelImport._load_weights(pm, arrays, cfg, reader=reader)
    assert isinstance(pm, ComputationGraph if functional
                      else MultiLayerNetwork)
    _assert_params_equal(pm.params, jm.params)
    _assert_params_equal(pm.state, jm.state)
    np.testing.assert_allclose(pm.output(x).numpy(),
                               np.asarray(jm.output(x)), **TOL)


def test_unsupported_layer_is_named():
    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Conv3D", "config": {
            "name": "c", "batch_input_shape": [None, 4, 4, 1]}}]}}
    with pytest.raises(ValueError, match="unsupported Keras layer type: "
                                         "Conv3D"):
        KerasModelImport._build(cfg, device="cpu")
    with pytest.raises(ValueError, match="Conv3D"):
        JaxImport._build(cfg)


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_imported_bidirectional_lstm_runs_the_kernels_on_card(cuda_device):
    """The imported Bidirectional LSTM on the card, through the
    config-JSON half (the card's machine has no h5py): two LSTM forward
    launches a call (one a direction), and the CPU's output."""
    from deeplearning4j_tpu_torch.ops.cuda import FUSED_LSTM

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        layers, weights, x = _bidi("concat")(_r(5))
        cfg = {"class_name": "Sequential",
               "config": {"name": "m", "layers": layers}}
        arrays, reader = _dict_reader(weights)
        nets = []
        for dev in ("cpu", cuda_device):
            net = KerasModelImport._build(cfg, device=dev)
            KerasModelImport._load_weights(net, arrays, cfg, reader=reader)
            nets.append(net)
        FUSED_LSTM.launches = 0
        out = nets[1].output(x)
        torch.cuda.synchronize()
        assert FUSED_LSTM.launches == 2
        np.testing.assert_allclose(out.cpu().numpy(),
                                   nets[0].output(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
