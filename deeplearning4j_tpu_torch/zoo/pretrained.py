"""Pretrained-weight converters: Keras h5 / ONNX -> zoo model params.

Counterpart of ``deeplearning4j_tpu/zoo/pretrained.py``. Reference analog:
org.deeplearning4j.zoo.ZooModel.initPretrained(), which downloads a
DL4J-format zip; here the converters make that zip from real framework
artifacts on disk (nothing is fetched), and ``ZooModel.init_pretrained``
restores it: convert once, restore anywhere.

Layout rules:

- Keras h5 (TF backend) conv kernels are HWIO, the catalog's own (both
  are channels-last); BatchNorm moving statistics go to the layer state.
  The weights are copied by the Keras importer's per-layer copier
  (``modelimport.keras``: gate reorders, depthwise and transposed kernels).
- ONNX (a torch export) conv kernels are OIHW -> HWIO; Gemm weights are
  [out, in] (transB=1) -> [in, out]; the first dense after a flatten
  permutes its input features from torch's C,H,W flatten order to the
  catalog's H,W,C (the NCHW -> NHWC pitfall). The ONNX wire reader is
  ``modelimport.onnx``'s, with its graph optimizer off.

``h5py`` is imported inside :func:`keras_h5_to_zoo` only;
:func:`keras_weights_to_zoo` takes the arrays as a mapping.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def keras_h5_to_zoo(h5_path: str, model,
                    name_map: Optional[Dict[str, str]] = None):
    """Load weights from a Keras h5 into an initialized zoo model, in
    place (see :func:`keras_weights_to_zoo`). Returns the model."""
    import h5py

    from deeplearning4j_tpu_torch.modelimport.keras import (
        h5_layer_order, read_h5_layer_arrays,
    )

    with h5py.File(h5_path, "r") as f:
        order = h5_layer_order(f)
        arrays = {n: read_h5_layer_arrays(f, n) for n in order}
    return keras_weights_to_zoo(order, arrays, model, name_map)


def keras_weights_to_zoo(order: List[str], arrays: Dict[str, list], model,
                         name_map: Optional[Dict[str, str]] = None):
    """Keras layers' weight arrays (``arrays``: layer name -> arrays in
    Keras order; ``order``: the layer names in creation order) into an
    initialized zoo model, in place.

    MultiLayerNetwork: the Keras weighted layers are matched to the model's
    weighted layers in order (the architectures must align: the zoo
    builders mirror the canonical ones). ComputationGraph: ``name_map``
    maps the model's vertex name -> Keras layer name (ResNet-50's is
    :func:`resnet50_keras_map`). Returns the model."""
    from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
    from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

    arrays = {n: ws for n, ws in arrays.items() if ws}
    copy = KerasModelImport._copy_layer_weights
    if hasattr(model, "layers"):          # MultiLayerNetwork
        knames = [n for n in order if n in arrays]
        ours = [(i, l) for i, l in enumerate(model.layers)
                if model.params[i]]
        if len(knames) != len(ours):
            raise ValueError(
                f"keras h5 has {len(knames)} weighted layers, model has "
                f"{len(ours)}: architectures do not align")
        for kname, (i, layer) in zip(knames, ours):
            copy(layer, model.params[i], model.state[i], arrays[kname])
        return model

    if name_map is None:
        raise ValueError("ComputationGraph conversion needs name_map "
                         "(ours -> keras layer name)")
    uncovered = [n for n, p in model.params.items()
                 if p and n not in name_map]
    if uncovered:
        raise ValueError(f"name_map leaves weighted vertices unmapped "
                         f"(they would keep random init): {uncovered[:8]}")
    missing = []
    for ours_name, keras_name in name_map.items():
        vertex = model.conf.vertices.get(ours_name)
        if vertex is None or not isinstance(vertex, LayerVertex):
            missing.append(ours_name)
            continue
        ws = arrays.get(keras_name)
        if ws is None:
            missing.append(f"{ours_name} <- {keras_name}")
            continue
        if ours_name not in model.params:
            raise ValueError(f"vertex {ours_name!r} holds no params to load "
                             f"{keras_name!r} into")
        copy(vertex.layer, model.params[ours_name],
             model.state.get(ours_name, {}), ws)
    if missing:
        raise ValueError(f"unmapped layers: {missing[:8]}")
    return model


def resnet50_keras_map() -> Dict[str, str]:
    """The zoo ResNet50's vertex names -> keras.applications.ResNet50's
    layer names (stem conv1_*, stages conv{2..5}_block{1..N}_{0|1|2|3}_
    {conv|bn}, head 'predictions')."""
    m = {"conv1": "conv1_conv", "bn1": "conv1_bn", "output": "predictions"}
    stages = [(64, 3), (128, 4), (256, 6), (512, 3)]
    for si, (_, blocks) in enumerate(stages):
        for bi in range(blocks):
            ours = f"s{si}b{bi}"
            keras = f"conv{si + 2}_block{bi + 1}"
            for suffix, knum in (("a", 1), ("b", 2), ("c", 3)):
                m[f"{ours}_conv{suffix}"] = f"{keras}_{knum}_conv"
                m[f"{ours}_bn{suffix}"] = f"{keras}_{knum}_bn"
            if bi == 0:
                m[f"{ours}_proj"] = f"{keras}_0_conv"
                m[f"{ours}_projbn"] = f"{keras}_0_bn"
    return m


# ---------------------------------------------------------------- ONNX path


def onnx_to_zoo(onnx_path: str, model,
                flatten_spatial: Optional[tuple] = None):
    """Load weights from a torch-exported ONNX file into a sequential
    (MultiLayerNetwork) CNN zoo model, in place.

    Walks the ONNX graph in order collecting the Conv / Gemm / MatMul /
    BatchNormalization weights, converts OIHW -> HWIO and [out, in] ->
    [in, out], and permutes the first post-flatten dense from C,H,W to
    H,W,C feature order (``flatten_spatial`` = (H, W, C) at the flatten
    point; inferred from the model's preprocessors when omitted)."""
    from deeplearning4j_tpu_torch.modelimport.onnx import OnnxModelImport
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalizationLayer, ConvolutionLayer, DenseLayer,
    )

    imp = OnnxModelImport.import_model(onnx_path, optimize=False,
                                       device="cpu")
    inits = imp.initializers

    def node_ws(node):
        ws = [np.asarray(inits[i]) for i in node.inputs if i in inits]
        if node.op == "MatMul" and ws:
            # torch decomposes Linear on >2-D input into MatMul + Add;
            # the bias is the consuming Add's initializer
            out = node.outputs[0]
            for n2 in imp.nodes:
                if n2.op == "Add" and out in n2.inputs:
                    ws += [np.asarray(inits[i]) for i in n2.inputs
                           if i in inits]
                    break
        return ws

    weighted = [(n, node_ws(n)) for n in imp.nodes
                if n.op in ("Conv", "Gemm", "BatchNormalization", "MatMul")]
    weighted = [(n, ws) for n, ws in weighted if ws]
    ours = [(i, l) for i, l in enumerate(model.layers) if model.params[i]]
    if len(weighted) != len(ours):
        raise ValueError(
            f"onnx has {len(weighted)} weighted nodes, model has "
            f"{len(ours)} weighted layers: architectures do not align")

    if flatten_spatial is None:
        flatten_spatial = _infer_flatten_spatial(model)

    def put(table, key, arr):
        like = table[key]
        table[key] = torch.tensor(np.ascontiguousarray(arr),
                                  dtype=like.dtype, device=like.device)

    seen_dense = False
    for (node, ws), (i, layer) in zip(weighted, ours):
        p = model.params[i]
        if node.op == "Conv":
            if not isinstance(layer, ConvolutionLayer):
                raise ValueError(f"layer {i} is not a conv")
            put(p, "W", np.transpose(ws[0], (2, 3, 1, 0)))  # OIHW -> HWIO
            if len(ws) > 1:
                if "b" not in p:
                    raise ValueError(f"conv layer {i} has no bias param but "
                                     f"the ONNX node carries one")
                put(p, "b", ws[1])
        elif node.op == "BatchNormalization":
            if not isinstance(layer, BatchNormalizationLayer):
                raise ValueError(f"layer {i} is not batch norm")
            gamma, beta, mean, var = ws[:4]
            put(p, "gamma", gamma)
            put(p, "beta", beta)
            put(model.state[i], "mean", mean)
            put(model.state[i], "var", var)
        else:  # Gemm / MatMul
            if not isinstance(layer, DenseLayer):
                raise ValueError(f"layer {i} is not dense")
            W = ws[0]
            tb = node.attr("transB")
            if node.op == "Gemm" and tb is not None and tb.i:
                W = W.T  # [out, in] -> [in, out]
            if not seen_dense and flatten_spatial is not None:
                H, Wd, C = flatten_spatial
                if W.shape[0] == H * Wd * C:
                    # torch flattened C,H,W; the catalog flattens H,W,C
                    W = (W.reshape(C, H, Wd, -1).transpose(1, 2, 0, 3)
                         .reshape(H * Wd * C, -1))
                seen_dense = True
            put(p, "W", W)
            if len(ws) > 1:
                if "b" not in p:
                    raise ValueError(f"dense layer {i} has no bias param but "
                                     f"the ONNX node carries one")
                put(p, "b", ws[1])
    return model


def _infer_flatten_spatial(model):
    """(H, W, C) at the FlattenPreProcessor (CnnToFeedForward analog),
    from the resolved configuration's per-layer input types."""
    for i in range(len(model.conf.layers)):
        pre = model.conf.preprocessors.get(i)
        if pre is not None and type(pre).__name__ == "FlattenPreProcessor":
            prev = (model.conf.layers[i - 1].output_type(
                model.conf.layer_input_types[i - 1]) if i
                else model.conf.input_type)
            if getattr(prev, "kind", None) == "cnn":
                return tuple(prev.shape)  # (h, w, c) NHWC
    return None


def save_pretrained(model, path: str):
    """Write the converted model as a restorable zip: the artifact
    ``ZooModel.init_pretrained()`` consumes."""
    from deeplearning4j_tpu_torch.util.serialization import write_model

    write_model(model, path)
    return path
