"""Model serialization — the zip checkpoints both packages read and write.

Counterpart of ``deeplearning4j_tpu/util/serialization.py`` for a
MultiLayerNetwork and a ComputationGraph. A model zip holds:

    configuration.json   the network config JSON (loads unchanged in both)
    coefficients.npz     params, flat-named "<layer>/<key>[/<key>...]"
                         (a graph's "<vertex name>/<key>...")
    state.npz            non-trainable state
    updater.npz          optimizer state, flat-named "<layer>/<slot>/<key>..."
    meta.json            model class, step/epoch counters, format version

so a zip written by either package restores in the other with its params,
updater state and counters. Params keep the JAX package's layouts (a
conv kernel ``W`` is HWIO, [kh, kw, cin, cout]), so they cross unchanged.
An int8 inference view (``quantize()``) writes each quantized weight as
three entries, ``<path>/__q__`` (the int8 payload), ``__scale__`` and
``__axis__``, with ``"quantized": true`` in ``meta.json`` and no updater
state, as the JAX package does (``util/serialization.py:30-126`` there);
it restores as a view (``fit_batch`` refused) without ever being
dequantized.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike

FORMAT_VERSION = 1


def _flatten(tree, prefix=""):
    """Flatten nested lists/dicts of tensors into {path: numpy array}; a
    QuantizedTensor becomes its ``__q__``/``__scale__``/``__axis__``
    entries."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif getattr(tree, "is_quantized", False):
        key = prefix.rstrip("/")
        out[key + "/__q__"] = tree.q.detach().cpu().numpy()
        out[key + "/__scale__"] = tree.scale.detach().cpu().numpy()
        out[key + "/__axis__"] = np.asarray(tree.axis)
    elif tree is not None:
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    return out


def _unflatten(template, flat: dict, what: str):
    """Arrays shaped like ``template`` (nested lists/dicts) from the zip's
    flat names; a ``__q__``/``__scale__``/``__axis__`` triple rebuilds into
    a QuantizedTensor (on the CPU) where the template holds a float
    tensor."""

    def rebuild(t, prefix):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(t))
        key = prefix.rstrip("/")
        if key + "/__q__" in flat:
            from deeplearning4j_tpu_torch.quantize.tensor import (
                QuantizedTensor,
            )

            return QuantizedTensor(torch.from_numpy(flat[key + "/__q__"]),
                                   torch.from_numpy(flat[key + "/__scale__"]),
                                   int(flat[key + "/__axis__"]))
        if key not in flat:
            raise ValueError(f"{what} has no entry {key}")
        return flat[key]

    return rebuild(template, "")


def _npz_bytes(flat: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _npz_load(b: bytes) -> dict:
    with np.load(io.BytesIO(b)) as z:
        return {k: z[k] for k in z.files}


def write_model(model, path: str, save_updater: bool = True):
    """ModelSerializer.writeModel analog."""
    meta = {
        "format_version": FORMAT_VERSION,
        "model_class": ("ComputationGraph" if hasattr(model.conf, "vertices")
                        else "MultiLayerNetwork"),
        "step_count": model.step_count,
        "epoch_count": model.epoch_count,
        "quantized": bool(getattr(model, "_quantized", False)),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", model.conf.to_json())
        z.writestr("coefficients.npz", _npz_bytes(_flatten(model.params)))
        z.writestr("state.npz", _npz_bytes(_flatten(model.state)))
        if save_updater:
            z.writestr("updater.npz", _npz_bytes(_flatten(model.opt_state)))
        z.writestr("meta.json", json.dumps(meta))


def _read_meta(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("meta.json").decode())


def _restore(path: str, model_class: str, model_factory, conf_parser,
             device: DeviceLike, load_updater: bool):
    """Configuration, params, layer state (BatchNormalization's running
    statistics), updater state (unless ``load_updater`` is False or the zip
    has none) and the step and epoch counters of a ``model_class`` zip."""
    from deeplearning4j_tpu_torch.nn.multilayer import (
        load_jax_opt_state, load_jax_params,
    )

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json").decode())
        if meta.get("model_class", "MultiLayerNetwork") != model_class:
            raise ValueError(f"{path} holds a {meta['model_class']}, "
                             f"not a {model_class}")
        conf = conf_parser(z.read("configuration.json").decode())
        coeffs = _npz_load(z.read("coefficients.npz"))
        states = (_npz_load(z.read("state.npz"))
                  if "state.npz" in z.namelist() else {})
        upd = (_npz_load(z.read("updater.npz"))
               if load_updater and "updater.npz" in z.namelist() else {})
    net = model_factory(conf).init(conf.seed, device=device)
    load_jax_params(net, _unflatten(net.params, coeffs, "coefficients.npz"),
                    _unflatten(net.state, states, "state.npz")
                    if states else None)
    if upd:
        load_jax_opt_state(net, _unflatten(net.opt_state, upd, "updater.npz"))
    net.step_count = int(meta.get("step_count", 0))
    net.epoch_count = int(meta.get("epoch_count", 0))
    if meta.get("quantized"):
        net._quantized = True
        # an inference view carries no updater state (fit_batch refuses it)
        net.opt_state = ([{} for _ in net.params]
                         if isinstance(net.params, list) else {})
    return net


def restore_multi_layer_network(path: str, device: DeviceLike = "cuda",
                                load_updater: bool = True):
    """ModelSerializer.restoreMultiLayerNetwork analog."""
    from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return _restore(path, "MultiLayerNetwork", MultiLayerNetwork,
                    MultiLayerConfiguration.from_json, device, load_updater)


def restore_computation_graph(path: str, device: DeviceLike = "cuda",
                              load_updater: bool = True):
    """ModelSerializer.restoreComputationGraph analog."""
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return _restore(path, "ComputationGraph", ComputationGraph,
                    ComputationGraphConfiguration.from_json, device,
                    load_updater)


def restore_model(path: str, device: DeviceLike = "cuda",
                  load_updater: bool = True):
    """Either model class, by the zip's ``meta.json``."""
    if _read_meta(path)["model_class"] == "ComputationGraph":
        return restore_computation_graph(path, device, load_updater)
    return restore_multi_layer_network(path, device, load_updater)
