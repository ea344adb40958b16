"""Post-training weight-only int8 pass over a trained network.

Counterpart of ``deeplearning4j_tpu/quantize/passes.py:28-123``.
``QUANT_RULES`` is the whitelist: for each layer class (by exact name, so a
subclass with other numerics opts in explicitly or not at all), which
param keys are quantized and along which axis their output channels run.
Biases, norms, recurrent matrices and embeddings stay as they are.

``quantize_network`` returns an inference view: a shallow copy of the net
sharing its configuration, whose params and state are copies it owns, with
the whitelisted weights replaced by :class:`QuantizedTensor`, no updater
state, and ``_quantized`` set, so ``fit_batch`` refuses to train it. The
original is untouched and goes on training.
"""

from __future__ import annotations

import copy
import time

import torch

from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map
from deeplearning4j_tpu_torch.quantize.tensor import quantize_tensor

# layer class name -> {param key: output-channel axis}
QUANT_RULES: dict[str, dict[str, int]] = {
    # dense stacks: W is [n_in, n_out]
    "DenseLayer": {"W": 1},
    "OutputLayer": {"W": 1},
    "RnnOutputLayer": {"W": 1},
    # attention projections [D, D], MLP [D, dff] and [dff, D]
    "SelfAttentionLayer": {"Wq": 1, "Wk": 1, "Wv": 1, "Wo": 1},
    "LearnedSelfAttentionLayer": {"Wq": 1, "Wk": 1, "Wv": 1, "Wo": 1},
    "TransformerEncoderLayer": {"Wq": 1, "Wk": 1, "Wv": 1, "Wo": 1,
                                "W1": 1, "W2": 1},
    # conv kernels are [kh, kw, cin // groups, n_out]
    "ConvolutionLayer": {"W": 3},
}


def quantize_params(params: dict, layer) -> tuple[dict, int]:
    """Quantize one layer's param table by QUANT_RULES. Returns (the new
    table, the number of tensors quantized); the table is the original
    object when nothing was quantized."""
    rules = QUANT_RULES.get(type(layer).__name__)
    if not rules or not params:
        return params, 0
    out, n = dict(params), 0
    for key, axis in rules.items():
        w = out.get(key)
        if w is None or getattr(w, "is_quantized", False):
            continue
        out[key] = quantize_tensor(w, axis)
        n += 1
    return (out, n) if n else (params, 0)


def _param_bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree))


def _own(leaf):
    """A copy of a tensor leaf, so the view owns its buffer: the original's
    training steps then cannot change what the view holds."""
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


def quantize_network(net, dtype: str = "int8"):
    """An int8 inference view of a ``MultiLayerNetwork`` or
    ``ComputationGraph`` (a view is returned as it is). With monitoring on,
    the quantize bundle records the pass: tensors converted, param bytes
    before and after, seconds."""
    if dtype != "int8":
        raise ValueError(f"unsupported quantization dtype {dtype!r}")
    if getattr(net, "_quantized", False):
        return net

    t0 = time.perf_counter()
    bytes_before = _param_bytes(net.params)
    tensors = 0

    q = copy.copy(net)
    if isinstance(net.params, list):  # MultiLayerNetwork: one entry a layer
        new_params = []
        for layer, p in zip(net.conf.layers, net.params):
            p2, n = quantize_params(p, layer)
            new_params.append(p2)
            tensors += n
        q.opt_state = [{} for _ in new_params]
    else:  # ComputationGraph: params by vertex name
        new_params = {}
        for name, p in net.params.items():
            v = net.conf.vertices[name]
            p2, n = quantize_params(p, getattr(v, "layer", v))
            new_params[name] = p2
            tensors += n
        q.opt_state = {}
    q.params = tree_map(_own, new_params)
    q.state = tree_map(_own, net.state)
    q._quantized = True

    from deeplearning4j_tpu_torch import monitoring

    mon = monitoring.quantize_monitor()
    if mon is not None:
        mon.observe_pass(dtype=dtype, tensors=tensors,
                         bytes_before=bytes_before,
                         bytes_after=_param_bytes(q.params),
                         seconds=time.perf_counter() - t0)
    return q
