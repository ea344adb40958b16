"""Numeric gradient checking.

Counterpart of ``deeplearning4j_tpu/autodiff/gradcheck.py``
(org.deeplearning4j.gradientcheck.GradientCheckUtil and
org.nd4j.autodiff.validation.OpValidation): central-difference numeric
gradients against autograd's, the verification backbone of the reference's
test suite.

The checks run in float64, as the reference's do and as the JAX package's
do under x64: central differences at eps = 1e-4 mean nothing at f32
resolution. They run where their tensors live: a network on the card is
checked on the card (the H100 computes float64 natively), a network on the
CPU on the CPU. ``grad_check_model`` and ``grad_check_graph`` cast a
network's parameters and float inputs to float64 on the network's device
for the check and leave the network as it was.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_unflatten


def _f64(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``, float64 where it is floating."""
    t = (a.detach() if isinstance(a, torch.Tensor)
         else torch.as_tensor(np.asarray(a))).to(device)
    return t.to(torch.float64) if t.is_floating_point() else t


def _check_device(args, device) -> torch.device:
    """``device`` when given; else where the first tensor argument lives;
    else the card (the port's default, which raises without one)."""
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda")


def grad_check(
    fn: Callable,
    *args,
    eps: float = 1e-4,
    rtol: float = 1e-3,
    atol: float = 1e-5,
    max_checks_per_arg: int = 64,
    argnums=None,
    seed: int = 0,
    device=None,
) -> dict:
    """Compare autograd's gradients of scalar-valued ``fn(*args)`` (tensors
    in, a 0-d tensor out) to central differences.

    Every argument runs as a float64 tensor on ``device``: by default where
    the first tensor argument lives, or on the card when none is a tensor.
    Up to ``max_checks_per_arg`` coordinates an argument, chosen at random
    from ``seed``, are checked. Returns {"ok": bool, "max_rel_error": float,
    "failures": [...]}."""
    argnums = tuple(range(len(args))) if argnums is None else tuple(argnums)
    dev = _check_device(args, device)
    args = [_f64(a, dev) for a in args]
    leaves = [args[i].clone().requires_grad_() for i in argnums]
    call = list(args)
    for i, leaf in zip(argnums, leaves):
        call[i] = leaf
    with torch.enable_grad():
        grads = torch.autograd.grad(fn(*call), leaves, allow_unused=True)
    rng = np.random.default_rng(seed)
    failures = []
    max_rel = 0.0

    with torch.no_grad():
        for gi, ai in enumerate(argnums):
            a = args[ai]
            g = grads[gi]
            flat_grad = (np.zeros(a.numel()) if g is None
                         else g.reshape(-1).cpu().numpy())
            n = a.numel()
            idxs = rng.choice(n, size=min(n, max_checks_per_arg), replace=False)
            for idx in idxs:
                pert = a.reshape(-1).clone()
                args_p = list(args)
                pert[idx] += eps
                args_p[ai] = pert.reshape(a.shape)
                f_p = float(fn(*args_p))
                pert[idx] -= 2 * eps
                args_p[ai] = pert.reshape(a.shape)
                f_m = float(fn(*args_p))
                numeric = (f_p - f_m) / (2 * eps)
                analytic = float(flat_grad[idx])
                denom = max(abs(numeric), abs(analytic))
                rel = abs(numeric - analytic) / denom if denom > atol else 0.0
                max_rel = max(max_rel, rel)
                if rel > rtol and abs(numeric - analytic) > atol:
                    failures.append(
                        {"arg": ai, "index": int(idx), "numeric": numeric,
                         "analytic": analytic, "rel_error": rel})
    return {"ok": not failures, "max_rel_error": max_rel, "failures": failures}


def grad_check_model(model, x, y, mask=None, **kw) -> dict:
    """Gradient-check a MultiLayerNetwork's full loss wrt every parameter
    leaf (GradientCheckUtil.checkGradients): the loss of one training-mode
    forward (``_loss_terms``, no dropout rng) as a function of the
    flattened params, then ``grad_check`` over them."""
    params = model.params
    leaves = tree_leaves(params)
    dev = leaves[0].device
    m = None if mask is None else _f64(mask, dev)

    def loss_of(*args):
        leaf_args, xa, ya = args[:-2], args[-2], args[-1]
        p = tree_unflatten(params, list(leaf_args))
        loss, _ = model._loss_terms(p, xa, ya, m, train=True)
        return loss

    # x / y trail the leaves so grad_check casts them to f64 too; argnums
    # restricts the checked gradients to the parameter leaves
    return grad_check(loss_of, *leaves, x, y, device=dev,
                      argnums=tuple(range(len(leaves))), **kw)


def grad_check_graph(graph, inputs: dict, labels: dict, masks=None,
                     **kw) -> dict:
    """Gradient-check a ComputationGraph's loss wrt every parameter leaf
    (GradientCheckTestsComputationGraph): the same central checker over
    DAG topologies (merge / elementwise vertices, several inputs and
    outputs)."""
    params = graph.params
    leaves = tree_leaves(params)
    in_names, lab_names = list(inputs), list(labels)
    n_in = len(in_names)
    dev = leaves[0].device
    ms = None if masks is None else [None if m is None else _f64(m, dev)
                                     for m in masks]

    def loss_of(*args):
        leaf_args = args[:len(leaves)]
        xs = args[len(leaves):len(leaves) + n_in]
        ys = args[len(leaves) + n_in:]
        p = tree_unflatten(params, list(leaf_args))
        loss, _ = graph._loss(p, graph.state, dict(zip(in_names, xs)),
                              dict(zip(lab_names, ys)), None, ms)
        return loss

    trailing = [inputs[k] for k in in_names] + [labels[k] for k in lab_names]
    return grad_check(loss_of, *leaves, *trailing, device=dev,
                      argnums=tuple(range(len(leaves))), **kw)
