"""How far a ResNet-50 training step can agree between two implementations,
on the CPU: the port's and the JAX package's, on shared weights.

Two measurements, each on the full-depth ResNet50 of both zoos (f32
policy, random weights from the JAX package's init, numpy data from a
seed):

1. gradients: at 32 x 32 x 3, B = 8, the loss gradients of the port in
   f32 and of the JAX package in f32, each against the port in f64. Per
   tensor, |a - b| max over |b| max; the largest over the tensors is
   printed for both. Training-mode BatchNormalization amplifies rounding
   through the depth, so the two f32 results differ from the f64 one by
   about as much as from each other.
2. trajectory: at 64 x 64 x 3, B = 16, 1000 classes, the loss of 12
   ``fit_batch`` steps of both packages on one repeated batch, with the
   model's own updater (Nesterovs 0.1, momentum 0.9).

Run from the root of a checkout, on the CPU (about a minute):

    JAX_PLATFORMS=cpu python3 experiments/resnet50_conditioning/compare.py

It prints one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.getcwd())

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from deeplearning4j_tpu.zoo.resnet import ResNet50 as JaxResNet50  # noqa: E402
from deeplearning4j_tpu_torch.common.trees import tree_map  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.builders import (  # noqa: E402
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402
    ComputationGraph, load_jax_opt_state, load_jax_params,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(size, classes):
    jn = JaxResNet50(height=size, width=size, num_classes=classes,
                     dtype="float32").init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jn.conf.to_json())).init(device="cpu")
    load_jax_params(net, _np(jn.params), _np(jn.state))
    load_jax_opt_state(net, _np(jn.opt_state))
    return jn, net


def batch(B, size, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, size, size, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)]
    return x, y


def port_grads(net, x, y, dtype):
    params = tree_map(lambda p: p.to(dtype).detach().requires_grad_(),
                      net.params)
    state = tree_map(lambda s: s.to(dtype), net.state)
    loss, _ = net._loss(params, state, {"input": torch.tensor(x).to(dtype)},
                        {"output": torch.tensor(y).to(dtype)}, None, None)
    leaves = [(k, kk, p) for k, d in params.items() for kk, p in d.items()]
    gs = torch.autograd.grad(loss, [p for _, _, p in leaves])
    return {(k, kk): g.double().numpy() for (k, kk, _), g in zip(leaves, gs)}


def worst_rel(a, ref):
    return max(float(np.abs(a[k] - ref[k]).max() / np.abs(ref[k]).max())
               for k in ref)


def main():
    jn, net = pair(32, 10)
    x, y = batch(8, 32, 10, 0)
    g64 = port_grads(net, x, y, torch.float64)
    g32 = port_grads(net, x, y, torch.float32)
    jg = _np(jax.grad(lambda p: jn._loss(
        p, jn.state, {"input": x}, {"output": y}, jax.random.key(0),
        None)[0])(jn.params))
    jg = {(k, kk): np.asarray(v, np.float64)
          for k, d in jg.items() for kk, v in d.items()}
    grads = {"port_f32_vs_port_f64": worst_rel(g32, g64),
             "jax_f32_vs_port_f64": worst_rel(jg, g64),
             "jax_f32_vs_port_f32": worst_rel(jg, g32)}

    jn, net = pair(64, 1000)
    x, y = batch(16, 64, 1000, 0)
    traj = {"jax": [float(jn.fit_batch((x, y))) for _ in range(12)],
            "port": [net.fit_batch((x, y)) for _ in range(12)]}
    print(json.dumps({"grads_32x32_b8_max_rel": grads,
                      "losses_64x64_b16": traj}))


if __name__ == "__main__":
    main()
