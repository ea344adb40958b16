"""The data-parallel hook of the train step.

Under the JAX package's SPMD step, BatchNormalization's statistics, a masked
loss's valid count and the gradients are reduced over the whole sharded
batch by the compiler. The port's ranks are processes, each running the
train step of ``nn/multilayer.py`` / ``nn/graph.py`` on its slice of the
batch, so the step reaches the other ranks through the object this module
holds while a data-parallel trainer runs a step
(``parallel/data_parallel.py``):

- ``stats(t)``: BatchNormalization's per-channel [mean, E[x^2]] averaged
  over the replicas, differentiably (``nn/layers/norm.py``);
- ``denominator(count)``: a masked loss's normalizer from this rank's valid
  count: the global count over the replica count (``_loss_terms``,
  ``ComputationGraph._loss``);
- ``reduce_step(loss, grads)``: the loss and the gradients averaged over the
  replicas, between ``autograd.grad`` and the clip (``_step_update``).

Off (no trainer), every hook is one None check.
"""

from __future__ import annotations

import contextlib
import contextvars

_ACTIVE = contextvars.ContextVar("dl4j_torch_replicas", default=None)


def active():
    """The running data-parallel context, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use(ctx):
    """Run the steps inside the block under ``ctx``."""
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)
