"""Parameter averaging with local steps: the semantics of the reference's
ParameterAveragingTrainingMaster (local SGD).

Counterpart of ``deeplearning4j_tpu/parallel/param_averaging.py``. Each
replica fits its own copy for ``averaging_frequency`` (K) steps on its own
slices of the data, then the params (and, by default, the updater state)
are averaged across the replicas; between averages the replicas really
diverge, which is the point of the algorithm. The JAX round is one
``lax.scan`` of K local steps inside a ``shard_map``, with the replicas on a
leading axis; here each rank is a replica, its K local steps touch no
collective, and the round ends with one all-reduce a dtype over the
averaged leaves (the round's loss rides the f32 buffer).

Kept from the JAX trainer: the ``stateful`` contract over ``as_loss_fn``
(network state carried through the local steps, float leaves averaged at
the sync, integer ones passed through), ``max_grad_norm`` (the local
step's global-norm clip), ``skip_average`` (top-level entries not
averaged: frozen ones do not diverge), the masks (``denom`` = the
microbatch's global valid count over the replicas at K = 1, which makes a
round one global-batch step; each replica's own count at K > 1), and
``fit_round(..., lost=)``: the listed replicas' contributions are dropped
from the round's average (renormalized over the survivors), and every
replica leaves the round holding that average.

Not kept: the dropout key. Each local step of a stateful round draws from a
``torch.Generator`` seeded from (the round's seed, the step, the replica),
not from threefry's fold-in: the two packages agree at dropout 0. The
local-SGD monitoring bundle (``monitoring.localsgd_monitor``) times each
round and counts it, as the JAX trainer's does.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.parallel.collectives import (
    axis_group, mesh_device,
)
from deeplearning4j_tpu_torch.parallel.compression import rows
from deeplearning4j_tpu_torch.parallel.data_parallel import flat_all_reduce


def step_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed mixed from ``seed`` and ``parts`` (the round's seed,
    the local step, the replica)."""
    s = int(seed) & 0x7FFF_FFFF_FFFF_FFFF
    for p in parts:
        s = (s * 6364136223846793005 + 1442695040888963407
             + int(p)) & 0x7FFF_FFFF_FFFF_FFFF
    return s


def _entries(tree):
    return list(tree) if isinstance(tree, dict) else range(len(tree))


class ParameterAveragingTrainer:
    """Local-SGD trainer: K local steps a replica, then the average.

    ``loss_fn(params, x, y) -> scalar loss`` on the replica's slice; with
    ``stateful=True``, ``loss_fn(params, state, rng, x, y[, mask,
    label_mask], denom=...) -> (loss, new_state)``, the ``as_loss_fn``
    surface. ``updater`` is any framework updater: its state is
    per-replica and averaged with the params unless
    ``average_updater_state`` is False. The carry is this rank's replica:
    {"params", "opt", "step"} and, stateful, {"state", "rng"} (an int
    seed)."""

    def __init__(self, loss_fn: Callable, updater, mesh, *,
                 axis: str = "data", averaging_frequency: int = 1,
                 average_updater_state: bool = True, stateful: bool = False,
                 max_grad_norm: float = 0.0, skip_average=None):
        from deeplearning4j_tpu_torch.optimize.updaters import get_updater

        self.loss_fn = loss_fn
        self.updater = get_updater(updater)
        self.mesh = mesh
        self.axis = axis
        self.max_grad_norm = float(max_grad_norm)
        self.skip_average = skip_average
        if int(averaging_frequency) < 1:
            raise ValueError(f"averaging_frequency must be >= 1, got "
                             f"{averaging_frequency}")
        self.freq = int(averaging_frequency)
        self.average_updater_state = average_updater_state
        self.stateful = stateful
        self.device = mesh_device(mesh)

    def init(self, params, state=None, rng=None):
        """The replica's carry from ``params`` (and, stateful, the network
        ``state`` and the round seed ``rng``, an int, default 0)."""
        own = lambda t: tree_map(  # noqa: E731
            lambda a: torch.as_tensor(a).to(self.device).clone(), t)
        params = own(params)
        carry = {"params": params, "opt": self.updater.init_state(params),
                 "step": 0}
        if self.stateful:
            carry["state"] = own(state if state is not None else {})
            carry["rng"] = int(rng or 0)
        return carry

    def _local_step(self, p, o, s, i, seed, rank, mb):
        """One local step of this replica: (params, opt, state, loss)."""
        from deeplearning4j_tpu_torch.nn.multilayer import global_norm_clip

        leaves = [a.detach().requires_grad_(True) for a in tree_leaves(p)]
        pr = tree_unflatten(p, leaves)
        if self.stateful:
            gen = torch.Generator(device=self.device).manual_seed(
                step_seed(seed, i, rank))
            extra = ()
            if "mask" in mb or "label_mask" in mb:
                extra = (mb.get("mask"), mb.get("label_mask"))
            kw = {"denom": mb["denom"]} if "denom" in mb else {}
            loss, s = self.loss_fn(pr, s, gen, mb["x"], mb["y"], *extra,
                                   **kw)
            s = tree_map(lambda a: a.detach(), s)
        else:
            loss = self.loss_fn(pr, mb["x"], mb["y"])
        grads = tree_unflatten(p, list(torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            if self.max_grad_norm > 0:
                grads = global_norm_clip(grads, self.max_grad_norm)
            upd, o = self.updater.update(grads, o, p, i)
            p = tree_map(lambda a, d: a - d, p, upd)
        return p, o, s, loss.detach().float()

    def _averaged(self, tree):
        """The leaves of ``tree`` to average: every one, but the entries
        ``skip_average`` marks."""
        skip = self.skip_average
        if skip is None:
            return tree_leaves(tree)
        return [a for k in _entries(tree)
                if not (skip.get(k) if isinstance(tree, dict) else skip[k])
                for a in tree_leaves(tree[k])]

    def _round(self, carry, batches, lost):
        g = axis_group(self.mesh, self.axis)
        dp, rank = dist.get_world_size(g), dist.get_rank(g)
        p, o, i = carry["params"], carry["opt"], carry["step"]
        s = carry.get("state")
        seed = carry.get("rng", 0)
        losses = []
        for mb in batches:
            p, o, s, loss = self._local_step(p, o, s, i, seed, rank, mb)
            losses.append(loss)
            i += 1
        # the round's one collective: the replicas' leaves, weighted by
        # their survival flags, summed and renormalized by the survivors
        w = 0.0 if rank in lost else 1.0
        survivors = float(dp - len(lost))
        params = self._averaged(p)
        opt = self._averaged(o) if self.average_updater_state else []
        state = ([a for a in tree_leaves(s) if a.is_floating_point()]
                 if s is not None else [])
        loss = torch.stack(losses).mean()
        flat = [loss] + params + opt + state
        out = flat_all_reduce([a * w for a in flat], g, survivors)
        swap = {id(a): b for a, b in zip(flat, out)}
        new = lambda t: tree_unflatten(  # noqa: E731
            t, [swap.get(id(a), a) for a in tree_leaves(t)])
        carry = {"params": new(p), "opt": new(o), "step": i}
        if s is not None:
            carry["state"] = new(s)
            carry["rng"] = step_seed(seed, i)
        return carry, out[0]

    def fit_round(self, carry, x, y, mask=None, label_mask=None, lost=None):
        """One averaging round over a global batch of K microbatches.

        x / y: [K * global_batch, ...] arrays, or dicts of them (a
        ComputationGraph's inputs / outputs), split into K microbatches;
        each replica steps K times on its slices, then the one average.
        ``mask`` / ``label_mask`` ([K * global_batch, T]) ride the same
        split (``stateful`` only). ``lost``: replica indices whose
        contribution this round is dropped. Returns (carry, loss)."""
        if (mask is not None or label_mask is not None) and not self.stateful:
            raise ValueError(
                "masked batches need stateful=True (the as_loss_fn surface "
                "that takes (mask, label_mask))")
        g = axis_group(self.mesh, self.axis)
        K, dp, rank = self.freq, dist.get_world_size(g), dist.get_rank(g)
        batch = {"x": x, "y": y}
        if mask is not None:
            batch["mask"] = mask
        if label_mask is not None:
            batch["label_mask"] = label_mask
        n = np.shape(tree_leaves(x)[0])[0]
        for leaf in tree_leaves((x, y)):
            if np.shape(leaf)[0] != n:
                raise ValueError(
                    f"every x/y slot must share the batch axis: got "
                    f"{np.shape(leaf)[0]} rows vs {n}")
        if n % K:
            raise ValueError(f"batch {n} not divisible into {K} local steps")
        if (n // K) % dp:
            raise ValueError(f"per-step batch {n // K} not "
                             f"divisible by data-parallel degree {dp}")
        denom = None
        if K == 1 and (mask is not None or label_mask is not None):
            # K = 1 is sync data parallelism: each replica divides its
            # slice's loss by the global valid count over the replicas, so
            # the average is one global-batch step however the padding
            # falls; K > 1 keeps each replica's own count
            nm = np.asarray(label_mask if label_mask is not None else mask)
            denom = np.maximum(nm.reshape(K, -1).sum(axis=1), 1.0) / dp
        lost = sorted({int(i) for i in (lost or ())})
        if lost:
            bad = [i for i in lost if not 0 <= i < dp]
            if bad:
                raise ValueError(f"lost replica indices {bad} outside the "
                                 f"{dp}-replica data axis")
            if len(lost) >= dp:
                raise ValueError("cannot drop every replica from a round")
        step_rows = n // K
        batches = []
        for k in range(K):
            mb = tree_map(
                lambda a: torch.as_tensor(np.asarray(a) if not isinstance(
                    a, torch.Tensor) else a)[k * step_rows:
                                             (k + 1) * step_rows], batch)
            mb = rows(mb, rank, dp, self.device)
            if denom is not None:
                mb["denom"] = torch.tensor(denom[k], dtype=torch.float32,
                                           device=self.device)
            batches.append(mb)
        mon = monitoring.localsgd_monitor()
        if mon is None:
            return self._round(carry, batches, lost)
        with monitoring.span("localsgd.round", k=K, dp=dp):
            t0 = time.perf_counter()
            carry, loss = self._round(carry, batches, lost)
            float(loss)  # the round's device work is in its time
            mon.sync_seconds.observe(time.perf_counter() - t0)
        mon.rounds.inc()
        return carry, loss

    def params(self, carry):
        """The (replica-identical) averaged params."""
        return carry["params"]

    def state(self, carry):
        """The network state after the last sync (stateful mode)."""
        if not self.stateful:
            raise ValueError("state() requires stateful=True")
        return carry["state"]
