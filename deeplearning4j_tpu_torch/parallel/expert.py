"""Expert parallelism: switch-routed mixture of experts.

Counterpart of ``deeplearning4j_tpu/parallel/expert.py``: top-1 (switch)
routing as dense dispatch / combine einsums, capacity
``ceil(tokens / experts * capacity_factor)`` an expert, the greedy overflow
passes (``overflow_passes``: a token past its first choice's capacity tries
its next-best expert with room; 1 is strict top-1 dropping) and the
switch-transformer load-balancing aux loss.

The JAX package shards the expert-stacked weights over the mesh's "model"
axis and lets GSPMD insert the all-to-alls. Here, with a mesh, each "model"
rank keeps its experts (:func:`place_moe_params`) and :func:`switch_moe`
moves the tokens itself: every rank routes the whole (replicated) batch
with the replicated router, dispatches its slice of the tokens to the
experts' ranks by ``all_to_all``, runs its experts, and combines by the
reverse ``all_to_all``; the outputs are gathered. Without a mesh it is the
single-device computation.

:func:`init_moe_params` draws from an explicit ``torch.Generator`` (the JAX
package draws from a key; parity runs on params carried across as numpy).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.device import resolve_device
from deeplearning4j_tpu_torch.parallel.collectives import (
    all_gather, all_to_all, axis_group, mesh_device, shard,
)

_EXPERT_KEYS = ("W1", "b1", "W2", "b2")


def init_moe_params(generator, d_model: int, d_hidden: int, n_experts: int,
                    dtype=torch.float32, device="cuda"):
    """Router [d_model, E] and expert-stacked W1 [E, d_model, d_hidden], b1
    [E, 1, d_hidden], W2 [E, d_hidden, d_model], b2 [E, 1, d_model]: normal
    draws from ``generator`` (a ``torch.Generator`` or a seed) scaled by
    1/sqrt(fan-in), zero biases."""
    g = (generator if isinstance(generator, torch.Generator)
         else torch.Generator().manual_seed(int(generator)))
    dev = resolve_device(device)

    def normal(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    return {
        "router_W": normal(d_model, n_experts, scale=s_in),
        "W1": normal(n_experts, d_model, d_hidden, scale=s_in),
        "b1": torch.zeros((n_experts, 1, d_hidden), dtype=dtype, device=dev),
        "W2": normal(n_experts, d_hidden, d_model, scale=s_out),
        "b2": torch.zeros((n_experts, 1, d_model), dtype=dtype, device=dev),
    }


def moe_param_specs():
    """Specs sharding the experts over the "model" axis (tuples, as
    ``TensorParallel``'s)."""
    e = ("model", None, None)
    return {"router_W": (), "W1": e, "b1": e, "W2": e, "b2": e}


def place_moe_params(params, mesh, *, axis: str = "model"):
    """This rank's experts (its slice of dim 0 of the stacked weights over
    ``axis``) and the replicated router, on the mesh's device."""
    n = dist.get_world_size(axis_group(mesh, axis))
    r = dist.get_rank(axis_group(mesh, axis))
    E = params["router_W"].shape[1]
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks")
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(v).to(mesh_device(mesh))
        out[k] = (t.chunk(n, 0)[r].contiguous() if k in _EXPERT_KEYS
                  else t)
    return out


def _route(params, xt, capacity_factor, overflow_passes):
    """(dispatch [N, E, C] 0/1 f32, gate value [N], first-choice one-hot
    [N, E], gates [N, E]) of the greedy multi-pass placement: pass p lets
    every still-unplaced token try its rank-p expert, consuming the
    capacity the earlier passes left."""
    N = xt.shape[0]
    E = params["router_W"].shape[1]
    C = max(1, int(np.ceil(N / E * capacity_factor)))
    gates = torch.softmax((xt @ params["router_W"]).float(), dim=-1)
    order = torch.argsort(-gates.detach(), dim=-1, stable=True)
    f32 = dict(dtype=torch.float32, device=xt.device)
    onehot = torch.nn.functional.one_hot(order[:, 0], E).float()
    pos_oh = torch.zeros((N, E, C), **f32)
    gate_val = torch.zeros((N,), **f32)
    placed = torch.zeros((N,), **f32)
    used = torch.zeros((E,), **f32)
    for p in range(max(1, min(overflow_passes, E))):
        oh = (torch.nn.functional.one_hot(order[:, p], E).float()
              * (1.0 - placed)[:, None])
        pos = ((torch.cumsum(oh, 0) - 1.0) + used[None, :]) * oh
        keep = oh * (pos < C).float()
        slot = torch.nn.functional.one_hot(
            pos.clamp(0, C - 1).long(), C).float()
        pos_oh = pos_oh + slot * keep[..., None]
        gate_val = gate_val + (gates * keep).sum(-1)
        used = used + keep.sum(0)
        placed = placed + keep.sum(-1)
    return pos_oh, gate_val, onehot, gates


def _experts(params, xin, activation):
    h = activation(torch.einsum("ecd,edh->ech", xin, params["W1"])
                   + params["b1"])
    return torch.einsum("ech,ehd->ecd", h, params["W2"]) + params["b2"]


def switch_moe(params, x, *, capacity_factor: float = 1.25,
               activation=torch.relu, overflow_passes: int = 2, mesh=None,
               axis: str = "model"):
    """Top-1 switch MoE feed-forward: x [..., D] -> (y [..., D], aux_loss).

    aux_loss is the switch-transformer load-balancing term (n_experts *
    sum_e fraction_e * mean_gate_e, over first choices). Tokens no pass
    could place give zeros (the caller's residual passes them through).

    With ``mesh``, ``params`` are :func:`place_moe_params`'s (this rank's
    experts along ``axis``), ``x`` the same on every rank, the token count a
    multiple of the axis size; ``y`` comes back whole on every rank, and
    the gradients of the router and of ``x`` are whole too."""
    orig_shape = x.shape
    xt = x.reshape(-1, orig_shape[-1])
    pos_oh, gate_val, onehot, gates = _route(params, xt, capacity_factor,
                                             overflow_passes)
    E = gates.shape[1]
    if mesh is None:
        xin = torch.einsum("nec,nd->ecd", pos_oh, xt.float())
        out = _experts(params, xin, activation)
        yt = torch.einsum("nec,ecd->nd", pos_oh, out) * gate_val[:, None]
    else:
        g = axis_group(mesh, axis)
        n, r = dist.get_world_size(g), dist.get_rank(g)
        N, (_, C) = xt.shape[0], pos_oh.shape[1:]
        if N % n:
            raise ValueError(f"{N} tokens do not split over {n} ranks")
        El = E // n
        # dispatch: this rank's tokens into every expert's slots, each
        # expert's block sent to its rank; a slot holds one token, so the
        # sum over the senders is that token
        po = pos_oh.chunk(n, 0)[r]
        part = torch.einsum("nec,nd->ecd", po, shard(xt.float(), g, 0))
        xin = all_to_all(part, g, 0, 1).reshape(El, n, C, -1).sum(1)
        out = _experts(params, xin, activation)                # [El, C, D]
        # combine: each slot's output back to the rank of its token
        owner = pos_oh.reshape(n, N // n, E, C).sum(1)[:, r * El:(r + 1) * El]
        msgs = out[None] * owner[..., None]                  # [n, El, C, D]
        mine = all_to_all(msgs, g, 0, 0).reshape(E, C, -1)
        yt = (torch.einsum("nec,ecd->nd", po, mine)
              * shard(gate_val, g, 0)[:, None])
        yt = all_gather(yt, g, 0)
    aux = E * torch.sum(onehot.mean(0) * gates.mean(0))
    return yt.to(x.dtype).reshape(orig_shape), aux


def switch_moe_reference(params, x, *, capacity_factor: float = 1.25,
                         activation=torch.relu, overflow_passes: int = 2):
    """Loop-over-experts reference in numpy (for parity tests): the same
    math, the greedy multi-pass placement included, without dispatch
    tensors. ``params`` whole (not placed)."""
    p = {k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v, np.float32)) for k, v in params.items()}
    orig_shape = np.shape(x)
    D = orig_shape[-1]
    xt = np.asarray(x, np.float32).reshape(-1, D)
    N = xt.shape[0]
    E = p["router_W"].shape[1]
    C = max(1, int(np.ceil(N / E * capacity_factor)))
    logits = xt @ p["router_W"]
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = g / g.sum(-1, keepdims=True)
    order = np.argsort(-g, axis=-1, kind="stable")
    y = np.zeros_like(xt)
    counts = np.zeros(E, int)
    placed = np.zeros(N, bool)
    for ps in range(max(1, min(overflow_passes, E))):
        for i in range(N):
            if placed[i]:
                continue
            e = order[i, ps]
            if counts[e] >= C:
                continue
            counts[e] += 1
            placed[i] = True
            pre = xt[i] @ p["W1"][e] + p["b1"][e][0]
            h = activation(torch.as_tensor(pre)).numpy()
            y[i] = (h @ p["W2"][e] + p["b2"][e][0]) * g[i, e]
    return y.reshape(orig_shape)
