"""Keras model import.

Counterpart of ``deeplearning4j_tpu/modelimport/keras.py`` (DL4J's
KerasModelImport and its per-layer mappers). Reads the Keras-2 h5 format
(the ``model_config`` JSON attribute and the ``model_weights`` group) and
Keras-3 ``.keras`` archives (``config.json`` and ``model.weights.h5``),
maps each Keras layer config onto the port's layer catalog, and copies the
weights with the gate and axis permutations the catalog needs (Keras LSTM
gates i, f, c, o become i, f, o, g).

Sequential models and Functional models with a linear topology become a
MultiLayerNetwork; Functional models with branches become a
ComputationGraph (inbound nodes become vertex edges; Add, Multiply,
Average, Maximum and Subtract become ElementWiseVertex, Concatenate a
MergeVertex).

The importer follows the JAX package's, not Keras: LSTM and GRU ignore
``activation`` and ``recurrent_activation``, and the GRU's two bias rows
are summed (not Keras's ``reset_after`` arithmetic).

``h5py`` is imported only inside the h5 entry points (``import_model``,
``_import_keras_zip``). The config-JSON half needs none: ``_build`` /
``_build_graph`` build the network from a config dict on ``device``, and
the weight loaders take a ``reader(source, keras layer name)`` returning
that layer's arrays in Keras order, e.g. from a ``{name: [arrays]}``
mapping.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalizationLayer, BidirectionalLayer,
    Convolution1DLayer, ConvolutionLayer, Cropping2DLayer,
    Deconvolution2DLayer, DenseLayer, DepthwiseConvolution2DLayer,
    DropoutLayer, EmbeddingSequenceLayer, GlobalPoolingLayer, GRULayer,
    LastTimeStepLayer, LayerNormalizationLayer, LSTMLayer, OutputLayer,
    SeparableConvolution2DLayer, SimpleRnnLayer, Subsampling1DLayer,
    SubsamplingLayer, Upsampling2DLayer, ZeroPadding2DLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam

_KERAS_ACT = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh",
    "softmax": "softmax", "elu": "elu", "selu": "selu", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid", "swish": "swish",
    "gelu": "gelu",
}


def read_h5_layer_arrays(h5file, layer_name):
    """One Keras layer's weight arrays, in Keras order, from a legacy
    whole-model h5."""
    wg = h5file["model_weights"]
    if layer_name not in wg:
        return []
    g = wg[layer_name]
    names = [n.decode() if isinstance(n, bytes) else n
             for n in g.attrs.get("weight_names", [])]
    return [np.asarray(g[n]) for n in names]


def h5_layer_order(h5file):
    """Keras layer names in creation order (the h5 ``layer_names`` attr;
    h5 groups themselves iterate alphabetically)."""
    wg = h5file["model_weights"]
    names = wg.attrs.get("layer_names")
    if names is None:
        return list(wg)
    return [n.decode() if isinstance(n, bytes) else n for n in names]


def _pad(cfg):
    return "same" if cfg.get("padding", "valid") == "same" else "valid"


def _keras_histories(obj, out=None):
    """The keras_history refs ([layer, node_idx, tensor_idx]) of a Keras-3
    inbound_nodes arg tree, in traversal order."""
    if out is None:
        out = []
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            out.append(obj["config"]["keras_history"])
            return out
        for v in obj.values():
            _keras_histories(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _keras_histories(v, out)
    return out


def _head(layer: DenseLayer) -> OutputLayer:
    """A Dense layer as an OutputLayer with the loss its activation implies
    (softmax: mcxent, sigmoid: xent, else mse), for training parity."""
    loss = "mcxent" if layer.activation == "softmax" else (
        "xent" if layer.activation == "sigmoid" else "mse")
    return OutputLayer(n_out=layer.n_out, activation=layer.activation,
                       loss=loss, has_bias=layer.has_bias)


class KerasLayerMapper:
    """Maps one Keras layer config dict onto a layer of the catalog (None
    for an input or a Flatten)."""

    def map(self, cls: str, cfg: dict) -> Optional[object]:
        act = _KERAS_ACT.get(cfg.get("activation", "linear"), "identity")
        if cls == "Dense":
            return DenseLayer(n_out=cfg["units"], activation=act,
                              has_bias=cfg.get("use_bias", True))
        if cls == "Conv2D":
            return ConvolutionLayer(
                n_out=cfg["filters"], kernel=tuple(cfg["kernel_size"]),
                strides=tuple(cfg.get("strides", (1, 1))), padding=_pad(cfg),
                dilation=tuple(cfg.get("dilation_rate", (1, 1))),
                activation=act, has_bias=cfg.get("use_bias", True))
        if cls == "Conv1D":
            return Convolution1DLayer(
                n_out=cfg["filters"], kernel=cfg["kernel_size"][0],
                strides=cfg.get("strides", [1])[0], padding=_pad(cfg),
                activation=act, has_bias=cfg.get("use_bias", True))
        if cls in ("MaxPooling2D", "AveragePooling2D"):
            return SubsamplingLayer(
                kernel=tuple(cfg["pool_size"]),
                strides=tuple(cfg.get("strides") or cfg["pool_size"]),
                padding=_pad(cfg),
                pooling_type="max" if cls.startswith("Max") else "avg")
        if cls in ("GlobalAveragePooling2D", "GlobalAveragePooling1D"):
            return GlobalPoolingLayer(pooling_type="avg")
        if cls in ("GlobalMaxPooling2D", "GlobalMaxPooling1D"):
            return GlobalPoolingLayer(pooling_type="max")
        if cls == "BatchNormalization":
            return BatchNormalizationLayer(eps=cfg.get("epsilon", 1e-3),
                                           decay=cfg.get("momentum", 0.99))
        if cls == "Dropout":
            return DropoutLayer(rate=cfg["rate"])
        if cls == "Activation":
            return ActivationLayer(activation=act)
        if cls == "Flatten":
            return None  # the automatic preprocessor flattens
        if cls == "ZeroPadding2D":
            return ZeroPadding2DLayer(
                pad=tuple(tuple(q) for q in cfg["padding"]))
        if cls in ("LSTM", "GRU", "SimpleRNN"):
            inner = {"LSTM": LSTMLayer, "GRU": GRULayer}.get(cls)
            inner = (inner(n_out=cfg["units"]) if inner is not None else
                     SimpleRnnLayer(n_out=cfg["units"], activation=act))
            if cfg.get("return_sequences", False):
                return inner
            # Keras's default return_sequences=False: the last step only
            return LastTimeStepLayer(underlying=inner)
        if cls == "Embedding":
            return EmbeddingSequenceLayer(n_in=cfg["input_dim"],
                                          n_out=cfg["output_dim"])
        if cls == "SeparableConv2D":
            return SeparableConvolution2DLayer(
                n_out=cfg["filters"], kernel=tuple(cfg["kernel_size"]),
                strides=tuple(cfg.get("strides", (1, 1))), padding=_pad(cfg),
                depth_multiplier=cfg.get("depth_multiplier", 1),
                activation=act, has_bias=cfg.get("use_bias", True))
        if cls == "DepthwiseConv2D":
            return DepthwiseConvolution2DLayer(
                kernel=tuple(cfg["kernel_size"]),
                strides=tuple(cfg.get("strides", (1, 1))), padding=_pad(cfg),
                depth_multiplier=cfg.get("depth_multiplier", 1),
                activation=act, has_bias=cfg.get("use_bias", True))
        if cls == "Conv2DTranspose":
            return Deconvolution2DLayer(
                n_out=cfg["filters"], kernel=tuple(cfg["kernel_size"]),
                strides=tuple(cfg.get("strides", (1, 1))), padding=_pad(cfg),
                activation=act, has_bias=cfg.get("use_bias", True))
        if cls == "UpSampling2D":
            return Upsampling2DLayer(size=tuple(cfg.get("size", (2, 2))))
        if cls == "Cropping2D":
            return Cropping2DLayer(
                crop=tuple(tuple(q) for q in cfg["cropping"]))
        if cls == "LayerNormalization":
            return LayerNormalizationLayer(eps=cfg.get("epsilon", 1e-3))
        if cls == "LeakyReLU":
            return ActivationLayer(
                activation=f"leakyrelu:{cfg.get('alpha', 0.3)}")
        if cls == "ELU":
            return ActivationLayer(activation=f"elu:{cfg.get('alpha', 1.0)}")
        if cls == "ReLU":
            if cfg.get("max_value") is not None:
                return ActivationLayer(activation=f"relumax:{cfg['max_value']}")
            ns = cfg.get("negative_slope", 0.0)
            if ns:
                return ActivationLayer(activation=f"leakyrelu:{ns}")
            return ActivationLayer(activation="relu")
        if cls in ("MaxPooling1D", "AveragePooling1D"):
            ps = cfg["pool_size"]
            ps = ps[0] if isinstance(ps, (list, tuple)) else ps
            st = cfg.get("strides")
            st = st[0] if isinstance(st, (list, tuple)) else st
            return Subsampling1DLayer(
                kernel=ps, strides=st,
                pooling_type="max" if cls.startswith("Max") else "avg")
        if cls in ("SpatialDropout1D", "SpatialDropout2D"):
            return DropoutLayer(rate=cfg["rate"])
        if cls == "Bidirectional":
            inner_cfg = cfg["layer"]
            inner = self.map(inner_cfg["class_name"], inner_cfg["config"])
            mode = {"concat": "concat", "sum": "add", "mul": "mul",
                    "ave": "average", None: "concat"}[
                        cfg.get("merge_mode", "concat")]
            if isinstance(inner, LastTimeStepLayer):
                # Keras merges the full sequences, then takes the last step
                return LastTimeStepLayer(underlying=BidirectionalLayer(
                    fwd=inner.underlying, mode=mode))
            return BidirectionalLayer(fwd=inner, mode=mode)
        if cls == "InputLayer":
            return None
        raise ValueError(f"unsupported Keras layer type: {cls}")


def _input_type_from_shape(shape) -> InputType:
    """batch_input_shape (None, ...) -> InputType."""
    dims = list(shape[1:])
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        return InputType.convolutional(dims[0], dims[1], dims[2])  # NHWC
    raise ValueError(f"cannot infer input type from shape {shape}")


class KerasModelImport:
    """KerasModelImport.importKerasSequentialModelAndWeights analog."""

    @staticmethod
    def import_model(h5_path: str, device: DeviceLike = "cuda"):
        """A Keras-2 h5 or a Keras-3 ``.keras`` archive as a network on
        ``device`` (the card by default)."""
        import zipfile

        import h5py

        if zipfile.is_zipfile(h5_path):        # Keras 3 ".keras" archive
            return KerasModelImport._import_keras_zip(h5_path, device)
        with h5py.File(h5_path, "r") as f:
            raw = f.attrs["model_config"]
            cfg = json.loads(raw if isinstance(raw, str) else raw.decode())
            if cfg["class_name"] in ("Functional", "Model") and \
                    KerasModelImport._is_nonlinear(cfg):
                model = KerasModelImport._build_graph(cfg, device)
                KerasModelImport._load_weights_graph(model, f)
            else:
                model = KerasModelImport._build(cfg, device)
                KerasModelImport._load_weights(model, f, cfg)
        return model

    # ------------------------------------------------- Keras 3 ".keras" zip
    @staticmethod
    def _import_keras_zip(path: str, device: DeviceLike = "cuda"):
        """Keras 3 archive: config.json and model.weights.h5, the weights
        under layers/<name>/vars/<i>. Sequential and linear Functional
        configs go through _build; branched Functional configs are
        normalized to the Keras-2 shape first."""
        import tempfile
        import zipfile

        import h5py

        with zipfile.ZipFile(path) as z:
            cfg = json.loads(z.read("config.json"))
            branched = (cfg["class_name"] in ("Functional", "Model")
                        and KerasModelImport._keras3_nonlinear(cfg))
            if branched:
                model = KerasModelImport._build_graph(
                    KerasModelImport._normalize_keras3_functional(cfg),
                    device)
            else:
                model = KerasModelImport._build(cfg, device)
            auto = KerasModelImport._v3_auto_names(cfg)
            reader = lambda f, name: KerasModelImport._v3_layer_arrays(  # noqa: E731
                f, name, auto)
            with tempfile.NamedTemporaryFile(suffix=".h5") as tmp:
                tmp.write(z.read("model.weights.h5"))
                tmp.flush()
                with h5py.File(tmp.name, "r") as f:
                    if branched:
                        KerasModelImport._load_weights_graph(model, f,
                                                             reader=reader)
                    else:
                        KerasModelImport._load_weights(model, f, cfg,
                                                       reader=reader)
        return model

    @staticmethod
    def _normalize_keras3_functional(cfg: dict) -> dict:
        """A Keras-3 Functional config in the Keras-2 shape _build_graph
        reads: inbound_nodes become [[[parent, node_idx, tensor_idx, {}],
        ...]] and input/output_layers nested [[name, 0, 0], ...] lists."""
        import copy

        cfg = copy.deepcopy(cfg)
        for lc in cfg["config"]["layers"]:
            nodes = lc.get("inbound_nodes") or []
            if len(nodes) > 1:
                # a layer called more than once (shared weights at several
                # places): collapsing its calls would build a wrong graph
                raise NotImplementedError(
                    f"layer {lc['config'].get('name')!r} is called "
                    "multiple times (shared layer); save as legacy h5 "
                    "(model.save('m.h5')) for this topology")
            hs = _keras_histories(nodes)
            lc["inbound_nodes"] = (
                [[[h[0], h[1], h[2], {}] for h in hs]] if hs else [])

        def norm_io(v):
            if not v:
                return []
            if isinstance(v[0], str):          # a single flat [name, n, t]
                return [v]
            return v

        cfg["config"]["input_layers"] = norm_io(
            cfg["config"].get("input_layers"))
        cfg["config"]["output_layers"] = norm_io(
            cfg["config"].get("output_layers"))
        return cfg

    @staticmethod
    def _keras3_nonlinear(cfg: dict) -> bool:
        """Branch or merge in a Keras-3 config (keras_history refs inside
        the inbound arg trees)."""
        consumed: dict = {}
        for lc in cfg["config"]["layers"]:
            ps = [h[0] for h in _keras_histories(lc.get("inbound_nodes")
                                                 or [])]
            if len(set(ps)) > 1:
                return True
            for p in ps:
                consumed[p] = consumed.get(p, 0) + 1
        return any(c > 1 for c in consumed.values())

    @staticmethod
    def _v3_auto_names(cfg: dict) -> dict:
        """{config layer name: save-time h5 group name}. Keras 3 keys a
        layer's weights by snake_case(class) plus a counter per base,
        assigned in config order at save time, not by the user's name."""
        import re

        def snake(cls):
            t = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", cls)
            t = re.sub(r"([a-z])([A-Z])", r"\1_\2", t)
            return t.lower()

        counters: dict = {}
        out: dict = {}
        for lc in cfg["config"]["layers"]:
            if lc["class_name"] == "InputLayer":
                continue
            base = snake(lc["class_name"])
            k = counters.get(base, 0)
            counters[base] = k + 1
            out[lc["config"]["name"]] = base if k == 0 else f"{base}_{k}"
        return out

    @staticmethod
    def _v3_layer_arrays(f, name, auto_names=None):
        """One layer's arrays from a Keras-3 weights h5 (vars/<i> in build
        order, the legacy weight_names order): the save-time auto name
        first, then the config name, then any group of that name."""
        g = None
        if auto_names and name in auto_names:
            g = f.get(f"layers/{auto_names[name]}")
        if g is None:
            g = f.get(f"layers/{name}")
        if g is None:
            hits: list = []
            f.visit(lambda p: hits.append(p)
                    if p.split("/")[-1] == name else None)
            for h in hits:
                if "vars" in f[h]:
                    g = f[h]
                    break
        if g is None or "vars" not in g:
            return []
        vg = g["vars"]
        return [np.asarray(vg[str(i)]) for i in range(len(vg))]

    @staticmethod
    def _is_nonlinear(cfg: dict) -> bool:
        """Functional models with branches or merges need a
        ComputationGraph; linear chains stay a MultiLayerNetwork."""
        for lc in cfg["config"]["layers"]:
            nodes = lc.get("inbound_nodes") or []
            if nodes and len(nodes[0]) > 1:
                return True  # a multi-input layer (merge)
        consumed: dict = {}
        for lc in cfg["config"]["layers"]:
            for n in (lc.get("inbound_nodes") or [[]])[0]:
                consumed[n[0]] = consumed.get(n[0], 0) + 1
        return any(c > 1 for c in consumed.values()) or \
            len(cfg["config"].get("output_layers", [])) > 1

    # ------------------------------------------------------------- topology
    @staticmethod
    def _build(cfg: dict, device: DeviceLike = "cuda") -> MultiLayerNetwork:
        """A Sequential (or linear Functional) config dict as a
        MultiLayerNetwork on ``device``, Adam 1e-3; a last Dense becomes an
        OutputLayer (``_head``)."""
        from deeplearning4j_tpu_torch.modelimport import optimizer as graph_opt

        layers_cfg = cfg["config"]["layers"]
        opt_stats = None
        if graph_opt.import_opt_enabled():
            # the import optimizer at the layer level: drop exporter no-ops
            # (rate-0 dropout, linear Activation layers)
            layers_cfg, opt_stats = graph_opt.prune_keras_layers(
                layers_cfg, graph=False)
        mapper = KerasLayerMapper()
        built, keras_names, itype = [], [], None
        for lc in layers_cfg:
            kcls, kcfg = lc["class_name"], lc["config"]
            if itype is None:
                shape = kcfg.get("batch_input_shape") or kcfg.get("batch_shape")
                if shape:
                    itype = _input_type_from_shape(shape)
                if kcls == "InputLayer":
                    continue
            layer = mapper.map(kcls, kcfg)
            if layer is None:
                continue
            built.append(layer)
            keras_names.append(kcfg["name"])
        if itype is None:
            raise ValueError("Keras model has no input shape information")
        if built and isinstance(built[-1], DenseLayer) and not isinstance(
                built[-1], OutputLayer):
            built[-1] = _head(built[-1])

        b = NeuralNetConfiguration.builder().updater(Adam(lr=1e-3)).list()
        for layer in built:
            b = b.layer(layer)
        conf = b.set_input_type(itype).build()
        model = MultiLayerNetwork(conf).init(device=resolve_device(device))
        model._keras_names = keras_names
        model.import_opt_stats = opt_stats
        return model

    # ---------------------------------------------------- functional -> DAG
    @staticmethod
    def _build_graph(cfg: dict, device: DeviceLike = "cuda"):
        """A Keras Functional topology as a ComputationGraph on ``device``:
        inbound_nodes become vertex edges, merge layers ElementWiseVertex
        or MergeVertex, and a Dense output an OutputLayer."""
        from deeplearning4j_tpu_torch.modelimport import optimizer as graph_opt
        from deeplearning4j_tpu_torch.nn.conf.graph import (
            ElementWiseVertex, MergeVertex,
        )
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            FlattenPreProcessor,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        mapper = KerasLayerMapper()
        gb = NeuralNetConfiguration.builder().updater(
            Adam(lr=1e-3)).graph_builder()
        input_types, keras_names = {}, []
        outputs = [o[0] for o in cfg["config"]["output_layers"]]
        layers_cfg = cfg["config"]["layers"]
        opt_stats = None
        if graph_opt.import_opt_enabled():
            layers_cfg, opt_stats = graph_opt.prune_keras_layers(
                layers_cfg, graph=True, outputs=outputs)

        for lc in layers_cfg:
            kcls, kcfg = lc["class_name"], lc["config"]
            name = lc.get("name") or kcfg["name"]
            inbound = [n[0] for n in (lc.get("inbound_nodes") or [[]])[0]]
            if kcls == "InputLayer":
                gb = gb.add_inputs(name)
                shape = kcfg.get("batch_input_shape") or kcfg.get("batch_shape")
                input_types[name] = _input_type_from_shape(shape)
                continue
            if kcls in ("Add", "Multiply", "Average", "Maximum", "Subtract"):
                opname = {"Add": "add", "Multiply": "mul", "Average": "average",
                          "Maximum": "max", "Subtract": "subtract"}[kcls]
                gb = gb.add_vertex(name, ElementWiseVertex(op=opname),
                                   *inbound)
                continue
            if kcls == "Concatenate":
                if kcfg.get("axis", -1) not in (-1,):
                    raise ValueError("Concatenate import supports axis=-1 only")
                gb = gb.add_vertex(name, MergeVertex(), *inbound)
                continue
            layer = mapper.map(kcls, kcfg)
            if layer is None:
                # a pass-through still needs a vertex later layers can name;
                # Flatten gets its preprocessor explicitly (the automatic
                # ones fire only before Dense/Output layers)
                layer = ActivationLayer(activation="identity")
                if kcls == "Flatten":
                    gb = gb.add_preprocessor(name, FlattenPreProcessor())
            if name in outputs and isinstance(layer, DenseLayer) and \
                    not isinstance(layer, OutputLayer):
                layer = _head(layer)
            gb = gb.add_layer(name, layer, *inbound)
            keras_names.append(name)

        conf = gb.set_input_types(**input_types).set_outputs(*outputs).build()
        model = ComputationGraph(conf).init(device=resolve_device(device))
        model._keras_names = keras_names
        model.import_opt_stats = opt_stats
        return model

    @staticmethod
    def _load_weights_graph(model, f, reader=None):
        from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

        reader = reader or read_h5_layer_arrays
        for name, vertex in model.conf.vertices.items():
            if not isinstance(vertex, LayerVertex):
                continue
            ws = reader(f, name)
            if not ws:
                continue
            KerasModelImport._copy_layer_weights(
                vertex.layer, model.params.get(name, {}),
                model.state.get(name, {}), ws)

    # -------------------------------------------------------------- weights
    @staticmethod
    def _load_weights(model: MultiLayerNetwork, f, cfg: dict, reader=None):
        reader = reader or read_h5_layer_arrays
        for li, (layer, kname) in enumerate(zip(model.layers,
                                                model._keras_names)):
            ws = reader(f, kname)
            if not ws:
                continue
            KerasModelImport._copy_layer_weights(
                layer, model.params[li], model.state[li], ws)

    @staticmethod
    def _copy_layer_weights(layer, p, state_entry, ws):
        """Copy one Keras layer's weight list into a layer's params (and
        running statistics into its state), on the device the params lie
        on. Shared by the sequential and the graph import."""
        if isinstance(layer, LastTimeStepLayer):
            layer = layer.underlying  # params are the wrapped RNN's
        put = _putter(p)
        if isinstance(layer, BidirectionalLayer):
            KerasModelImport._load_bidirectional(layer, p, ws)
        elif isinstance(layer, DenseLayer) and "W" in p:
            put(p, "W", ws[0])
            if layer.has_bias and len(ws) > 1:
                put(p, "b", ws[1])
        elif isinstance(layer, SeparableConvolution2DLayer):
            put(p, "dW", ws[0])  # (kh, kw, cin, mult)
            put(p, "pW", ws[1])  # (1, 1, cin * mult, filters)
            if layer.has_bias and len(ws) > 2:
                put(p, "b", ws[2])
        elif isinstance(layer, DepthwiseConvolution2DLayer):
            put(p, "W", ws[0])
            if layer.has_bias and len(ws) > 1:
                put(p, "b", ws[1])
        elif isinstance(layer, Deconvolution2DLayer):
            # Keras's Conv2DTranspose kernel is (kh, kw, out, in) with
            # scatter (flipped) semantics; the catalog's is HWIO without
            # the flip: transpose the channel dims and flip spatially
            put(p, "W", np.transpose(ws[0], (0, 1, 3, 2))[::-1, ::-1].copy())
            if layer.has_bias and len(ws) > 1:
                put(p, "b", ws[1])
        elif isinstance(layer, ConvolutionLayer):
            put(p, "W", ws[0])  # Keras HWIO is the catalog's
            if layer.has_bias and len(ws) > 1:
                put(p, "b", ws[1])
        elif isinstance(layer, LayerNormalizationLayer):
            put(p, "gamma", ws[0])
            if len(ws) > 1:
                put(p, "beta", ws[1])
        elif isinstance(layer, BatchNormalizationLayer):
            gamma, beta, mean, var = ws
            put(p, "gamma", gamma)
            put(p, "beta", beta)
            put(state_entry, "mean", mean)
            put(state_entry, "var", var)
        elif isinstance(layer, (LSTMLayer, GRULayer, SimpleRnnLayer)):
            KerasModelImport._load_rnn(layer, p, ws)
        elif isinstance(layer, EmbeddingSequenceLayer):
            put(p, "W", ws[0])

    @staticmethod
    def _load_rnn(layer, p, ws):
        """Copy one RNN cell's (kernel, recurrent kernel, bias) with the
        gate reorder."""
        put = _putter(p)
        kernel, rec, bias = ws
        if isinstance(layer, LSTMLayer):
            H = layer.n_out
            # Keras gates i, f, c, o -> i, f, o, g (c)
            perm = np.concatenate([np.arange(0, 2 * H),          # i, f
                                   np.arange(3 * H, 4 * H),      # o
                                   np.arange(2 * H, 3 * H)])     # c -> g
            put(p, "W", kernel[:, perm])
            put(p, "RW", rec[:, perm])
            put(p, "b", np.asarray(bias).reshape(-1, 4 * H).sum(0)[perm])
        elif isinstance(layer, GRULayer):
            # Keras gates z, r, h -> r, z, n; both bias rows summed
            H = layer.n_out
            perm = np.concatenate([np.arange(H, 2 * H), np.arange(0, H),
                                   np.arange(2 * H, 3 * H)])
            put(p, "W", kernel[:, perm])
            put(p, "RW", rec[:, perm])
            put(p, "b", np.asarray(bias).reshape(-1, 3 * H).sum(0)[perm])
        else:
            put(p, "W", kernel)
            put(p, "RW", rec)
            put(p, "b", bias)

    @staticmethod
    def _load_bidirectional(layer, p, ws):
        """Keras's Bidirectional stores the forward weights, then the
        backward ones."""
        half = len(ws) // 2
        KerasModelImport._load_rnn(layer.fwd, p["fwd"], ws[:half])
        KerasModelImport._load_rnn(layer.fwd, p["bwd"], ws[half:])


def _putter(tree):
    """``put(table, key, array)``: the array as an f32 tensor on the
    device of ``tree``'s tensors (the CPU if it has none)."""
    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    dev = leaves[0].device if leaves else torch.device("cpu")

    def put(table, key, arr):
        table[key] = torch.tensor(np.ascontiguousarray(arr),
                                  dtype=torch.float32, device=dev)

    return put
