"""Data-parallel training: the ParallelWrapper.

Counterpart of ``deeplearning4j_tpu/parallel/data_parallel.py``. The JAX
wrapper runs the model's own jitted step with the batch sharded over the
mesh's "data" axis, and XLA reduces over the whole batch. Here each rank is
a process running the model's own eager step (``fit_batch``) on its slice
of the global host batch, and the step reaches the other replicas through
``nn/replicas.py``. What the JAX step means, and so what this keeps:

- **BatchNorm statistics are the whole batch's.** Every
  BatchNormalization layer averages its per-channel [mean, E[x^2]] over the
  replicas in f32 with a gradient through the sum, keeps the one-pass
  variance with ``max(var, 0)``, and moves its running statistics by the
  whole batch's on every rank. The slices are equal (the batch must split
  evenly), so the mean of the replicas' means is the batch's.
- **The loss is the global mean.** A masked loss divides by the global
  valid count over the replica count (one all-reduce of the count), so
  the replicas' average is the global batch's loss however the padding
  falls; the l1/l2 terms count once because the gradients are averaged,
  not summed.
- **One all-reduce a dtype for the gradients**, between ``autograd.grad``
  and the clip, as one flat buffer (JAX emits one fused all-reduce; a
  ResNet-50 has 161 leaves). The step's loss rides the f32 buffer, so the
  score every rank reports is the global mean, and a guarded step screens
  the reduced gradients.
- ``fit`` drains as the JAX wrapper's does; ``average_params`` is a no-op.

The JAX wrapper blocks on the updated params on its CPU transport so that
no host collective starts while the step's is in flight (``:70-81``). Here
the reported loss comes out of the step's all-reduce, so a drained score
means that collective is done: ``fit`` drains before it returns, and gloo's
collectives return when done.

Every rank calls ``fit_batch`` with the same global batch; the wrapper
broadcasts the first replica's params, layer state and updater state once,
before the first step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_unflatten
from deeplearning4j_tpu_torch.nn import replicas
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh


def _flat_by_dtype(tensors, collective) -> list:
    """``collective`` run in place on one flat buffer for each dtype of
    ``tensors``; returns new tensors of the inputs' shapes."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        for i, p in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = p.view(tensors[i].shape)
    return out


def flat_all_reduce(tensors, group, divisor: float = 1.0) -> list:
    """``tensors`` summed over ``group`` and divided by ``divisor``: one
    all-reduce for each dtype."""
    def reduce(flat):
        dist.all_reduce(flat, group=group)
        if divisor != 1.0:
            flat.div_(divisor)

    return _flat_by_dtype(tensors, reduce)


def flat_broadcast(tensors, group) -> list:
    """``tensors`` as the group's first rank holds them (one broadcast a
    dtype)."""
    src = dist.get_global_rank(group, 0)
    return _flat_by_dtype(
        tensors, lambda flat: dist.broadcast(flat, src, group=group))


class DataAxis:
    """The replicas context (``nn/replicas.py``) of one process group: the
    hooks a data-parallel step reaches the other replicas through."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)

    def stats(self, t):
        """BatchNormalization's equal-slice statistics averaged, with a
        gradient through the sum."""
        return collectives.psum(t, self.group) / self.size

    def denominator(self, count):
        """The global valid count (at least 1) over the replica count."""
        c = count.detach().to(torch.float32).reshape(1).clone()
        dist.all_reduce(c, group=self.group)
        return torch.clamp(c[0], min=1.0) / self.size

    def reduce_step(self, loss, grads):
        """The loss and the gradient tree averaged over the replicas."""
        leaves = tree_leaves(grads)
        out = flat_all_reduce([loss] + leaves, self.group, self.size)
        return out[0], tree_unflatten(grads, out[1:])


class ParallelWrapper:
    """Trains a model data-parallel over a mesh's "data" axis.

    Usage (the reference's wrapper-around-model pattern), in every rank::

        wrapper = ParallelWrapper(model, mesh)
        wrapper.fit(iterator, epochs=2)

    ``mesh`` defaults to every rank on "data", on the model's device type.
    """

    def __init__(self, model, mesh: Optional[DeviceMesh] = None,
                 prefetch_buffer: int = 2):
        self.model = model
        self.mesh = mesh or DeviceMesh(device=model.device.type)
        self.prefetch_buffer = prefetch_buffer
        self.axis = DataAxis(self.mesh.group("data"))
        self._placed = False

    def _place(self):
        """Check the model is on the mesh's device and give every replica
        the first one's params, layer state and updater state."""
        m = self.model
        if m.device.type != self.mesh.device_type:
            raise ValueError(f"the model is on {m.device}; the mesh runs on "
                             f"{self.mesh.device_type}")
        trees = (m.params, m.state, m.opt_state)
        leaves = [tree_leaves(t) for t in trees]
        flat = flat_broadcast([a for ls in leaves for a in ls],
                              self.axis.group)
        it = iter(flat)
        m.params, m.state, m.opt_state = (
            tree_unflatten(t, [next(it) for _ in ls])
            for t, ls in zip(trees, leaves))
        self._placed = True

    def fit_batch(self, ds):
        """One step on the global batch ``ds`` (a DataSet or a (features,
        labels[, mask[, labels_mask]]) tuple, the same on every rank): this
        rank's slice through the model's own ``fit_batch`` under the data
        axis. Returns what the model's ``fit_batch`` returns: the global
        mean loss (a float, or a lazy score under async dispatch)."""
        if not self._placed:
            self._place()
        from deeplearning4j_tpu_torch.nn.multilayer import _unpack

        x, y, mask, label_mask = _unpack(ds)
        batch = self.mesh.shard_batch((x, y, mask, label_mask))
        with replicas.use(self.axis):
            return self.model.fit_batch(batch)

    def fit(self, data, epochs: int = 1):
        from deeplearning4j_tpu_torch.datasets.iterators import (
            AsyncPrefetchIterator,
        )
        from deeplearning4j_tpu_torch.optimize.async_dispatch import (
            drain_scores,
        )

        if self.prefetch_buffer and hasattr(data, "reset"):
            # the prefetch thread stages host batches only: each rank takes
            # its slice, and no second thread touches the transport
            data = AsyncPrefetchIterator(data, queue_size=self.prefetch_buffer,
                                         device_put=False)
        for _ in range(epochs):
            try:
                for ds in data:
                    self.fit_batch(ds)
            except BaseException:
                drain_scores(self.model, suppress=True)
                raise
            drain_scores(self.model)
            if hasattr(data, "reset"):
                data.reset()
            self.model.epoch_count += 1
        return self.model

    def average_params(self):
        """No-op kept for API parity: the replicas stay identical by
        construction (every rank applies the same averaged gradients)."""
        return self.model.params
