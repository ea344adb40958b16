"""Model serialization — reading the JAX package's zip checkpoints.

Counterpart of ``deeplearning4j_tpu/util/serialization.py`` (reading half).
A model zip holds ``configuration.json`` (the network config JSON, which
loads unchanged in both packages) and ``coefficients.npz`` (the params,
flat-named ``"<layer>/<key>"``), beside state, updater state and
``meta.json``. This slice restores configuration and coefficients for
inference; the updater state is not read, and writing a zip comes later.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.common.device import DeviceLike


def _npz_load(b: bytes) -> dict:
    with np.load(io.BytesIO(b)) as z:
        return {k: z[k] for k in z.files}


def _unflatten(template, flat: dict):
    """Per-layer dicts of arrays shaped like ``template`` (list of dicts)
    from the zip's flat ``"<layer>/<key>"`` names."""
    out = []
    for i, p in enumerate(template):
        layer = {}
        for k in p:
            key = f"{i}/{k}"
            if key + "/__q__" in flat:
                raise ValueError(f"{key} is an int8-quantized tensor; "
                                 "quantized models are not ported yet")
            if key not in flat:
                raise ValueError(f"checkpoint has no coefficient {key}")
            layer[k] = flat[key]
        out.append(layer)
    return out


def restore_multi_layer_network(path: str, device: DeviceLike = "cuda"):
    """ModelSerializer.restoreMultiLayerNetwork analog, for inference."""
    from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import (
        MultiLayerNetwork, load_jax_params,
    )

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json").decode())
        if meta.get("model_class", "MultiLayerNetwork") != "MultiLayerNetwork":
            raise ValueError(f"{path} holds a {meta['model_class']}, "
                             "not a MultiLayerNetwork")
        conf = MultiLayerConfiguration.from_json(
            z.read("configuration.json").decode())
        coeffs = _npz_load(z.read("coefficients.npz"))
    net = MultiLayerNetwork(conf).init(conf.seed, device=device)
    return load_jax_params(net, _unflatten(net.params, coeffs))
