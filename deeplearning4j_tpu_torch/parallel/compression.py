"""Threshold-encoded gradient sharing: the EncodedGradientsAccumulator
analog.

Counterpart of ``deeplearning4j_tpu/parallel/compression.py``. Strom-style
encoding: each rank's update message carries only the entries whose
magnitude clears a threshold, quantized to +-threshold, with the remainder
kept locally (error feedback) for later rounds; an adaptive rule moves the
threshold toward a target message density. The JAX step is one
``shard_map`` over the data axis carrying {params, residual, thr}; here
each rank is a process carrying its own, and the only traffic is one
all-reduce of the encoded update (a flat buffer a dtype, with the loss and
the density riding the f32 one).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.parallel.collectives import (
    axis_group, mesh_device,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import flat_all_reduce


def threshold_encode(g, thr):
    """Ternary Strom encoding of one tensor: entries |g| >= thr become
    +-thr, the rest 0. Returns (encoded, residual), residual = g - encoded
    being the error feedback the reference keeps for later rounds."""
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    t = torch.as_tensor(thr, dtype=g.dtype, device=g.device)
    q = torch.where(g >= t, t, torch.where(g <= -t, -t, zero))
    return q, g - q


def message_density(encoded, thr):
    """Fraction of nonzero entries in an encoded tree (the quantity the
    reference's ThresholdAlgorithm steers), an f32 0-d tensor."""
    leaves = tree_leaves(encoded)
    total = sum(a.numel() for a in leaves)
    nz = sum((a.abs().float() > 0.5 * thr).sum() for a in leaves)
    return nz.float() / total


def rows(tree, index: int, count: int, device):
    """Slice ``index`` of ``count`` equal slices of dim 0 of every leaf, on
    ``device``."""
    def take(x):
        t = torch.as_tensor(x)
        if t.shape[0] % count:
            raise ValueError(f"batch {t.shape[0]} not divisible by {count} "
                             f"ranks")
        b = t.shape[0] // count
        return t[index * b:(index + 1) * b].to(device)

    return tree_map(take, tree)


class EncodedGradientTrainer:
    """Data-parallel trainer whose update exchange is threshold-encoded.

    ``loss_fn(params, x, y) -> scalar loss`` on the rank's slice of the
    batch. Each rank forms its lr-scaled update plus its residual, encodes
    it, keeps the remainder (clipped to +-``residual_clip`` * thr) as its
    residual, and applies the sum of every rank's encoded update; the
    threshold grows or shrinks by ``adapt_rate`` as the mean density is
    above or below ``target_density``. With ``ici_axis`` (a
    ``multi_slice_mesh``), gradients average in full precision over
    ``ici_axis`` first and only the exchange over ``axis`` is encoded.
    Momentum-class updaters belong on ``ParallelWrapper``: only ``Sgd``.

    The carry is this rank's {"params", "residual", "thr", "step"} (the
    JAX carry stacks the ranks' residuals on a leading axis)."""

    def __init__(self, loss_fn: Callable, updater, mesh, *, axis: str = "data",
                 ici_axis: Optional[str] = None, threshold: float = 1e-3,
                 adaptive: bool = True, target_density: float = 0.01,
                 adapt_rate: float = 1.05, residual_clip: float = 5.0):
        from deeplearning4j_tpu_torch.optimize.updaters import Sgd, get_updater

        self.loss_fn = loss_fn
        updater = get_updater(updater)
        if not isinstance(updater, Sgd):
            raise ValueError(
                "EncodedGradientTrainer exchanges lr-scaled updates (Strom "
                "encoding); use Sgd here: stateful updaters belong on the "
                "plain-sum ParallelWrapper path")
        self.updater = updater
        self.mesh = mesh
        self.axis, self.ici_axis = axis, ici_axis
        self.threshold = threshold
        self.adaptive = adaptive
        self.target_density = target_density
        self.adapt_rate = adapt_rate
        self.residual_clip = residual_clip
        self.device = mesh_device(mesh)

    def init(self, params):
        params = tree_map(lambda p: torch.as_tensor(p).to(self.device)
                          .clone(), params)
        return {"params": params,
                "residual": tree_map(torch.zeros_like, params),
                "thr": torch.tensor(self.threshold, device=self.device),
                "step": 0}

    def fit_batch(self, carry, x, y):
        """One encoded-exchange step over the global batch (the same on
        every rank, split over ``axis`` and ``ici_axis``). Returns
        (new carry, the mean loss)."""
        g_axis = axis_group(self.mesh, self.axis)
        n = dist.get_world_size(g_axis)
        index, count = dist.get_rank(g_axis), n
        g_ici = None
        if self.ici_axis is not None:
            g_ici = axis_group(self.mesh, self.ici_axis)
            m = dist.get_world_size(g_ici)
            index, count = index * m + dist.get_rank(g_ici), n * m
        xl = rows(x, index, count, self.device)
        yl = rows(y, index, count, self.device)
        params = carry["params"]
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = self.loss_fn(tree_unflatten(params, leaves), xl, yl)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach().float()
        if g_ici is not None:
            out = flat_all_reduce([loss] + grads, g_ici,
                                  dist.get_world_size(g_ici))
            loss, grads = out[0], out[1:]
        thr = carry["thr"]
        lr = self.updater._lr(carry["step"])
        u = [(lr * g).to(g.dtype) + r
             for g, r in zip(grads, tree_leaves(carry["residual"]))]
        enc = [threshold_encode(t, thr)[0] for t in u]
        residual = []
        for t, q in zip(u, enc):
            r = t - q
            if self.residual_clip:
                lim = (self.residual_clip * thr).to(t.dtype)
                r = torch.clamp(r, -lim, lim)
            residual.append(r)
        stats = torch.stack([loss, message_density(enc, thr)])
        out = flat_all_reduce([stats] + enc, g_axis)
        (loss, dens), shared = out[0] / n, out[1:]
        new_thr = thr
        if self.adaptive:
            new_thr = torch.where(dens > self.target_density,
                                  thr * self.adapt_rate,
                                  thr / self.adapt_rate).clamp(1e-8, 1e2)
        new_params = [p.detach() - d
                      for p, d in zip(tree_leaves(params), shared)]
        return {"params": tree_unflatten(params, new_params),
                "residual": tree_unflatten(params, residual),
                "thr": new_thr, "step": carry["step"] + 1}, loss
