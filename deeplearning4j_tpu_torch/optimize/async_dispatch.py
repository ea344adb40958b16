"""Async training dispatch: lazy scores, bounded in-flight windows, tail
padding.

Counterpart of ``deeplearning4j_tpu/optimize/async_dispatch.py``. On the
card PyTorch queues a step's kernels and returns at once; the host blocks
only where it reads a value back (``float(loss)``, ``.item()``, a copy to
the host). A ``fit_batch`` that returned ``float(loss)`` would wait for
every step to finish before the host could prepare the next. Three pieces:

- **ScoreHandle / AsyncScoreWindow**: ``fit_batch`` keeps the loss a
  device tensor and returns a lazy handle; a bounded window of in-flight
  steps (``DL4J_TORCH_ASYNC_STEPS``, default 2, ``=0`` returns floats)
  drains oldest-first when it fills, at epoch end, or when a score is
  read. Listener callbacks are deferred to drain time with the original
  (iteration, epoch, score) attribution; listeners that act on the model
  at each iteration declare ``needs_eager_score = True`` and force the
  eager path.
- **pad_tail_batch**: a partial tail batch is padded up to the pow2 bucket
  (``serving/warmup.py``'s ``pow2_buckets``) of the largest batch seen,
  with a zeroed labels mask on the padding, so the loss and gradients are
  the unpadded batch's and the kernels' plan caches see few shapes.
- **_fetch_scalar**: the one place the fit path turns a loss into a float,
  so tests can count the host syncs.

Not here yet: the guardrails' sentinel words and rollback re-queueing (the
guardrails slice), and the request trace of a dispatched step
(``trace_id`` stays None until ``monitoring/context.py`` is ported).
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.serving.warmup import bucket_for, pow2_buckets


class _InFlightScalar:
    """A device loss on its way to the host: a copy into pinned host memory
    queued behind its step on the stream, and the event recorded after the
    copy. Reading it waits for that event alone, not for the steps the host
    has queued since (``float()`` of a device tensor waits for the whole
    stream)."""

    __slots__ = ("host", "event")

    def __init__(self, loss: torch.Tensor):
        self.host = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
        self.host.copy_(loss.detach(), non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(loss.device))


def _start_fetch(loss):
    """Queue a device loss's copy to the host without blocking; host values
    pass through."""
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        return _InFlightScalar(loss)
    return loss


def _fetch_scalar(arr) -> float:
    """The host<-device sync. Every score fetch on the fit path funnels
    through here; an in-flight copy waits for its own step only."""
    if isinstance(arr, _InFlightScalar):
        arr.event.synchronize()
        arr = arr.host
    return float(arr)


class AsyncStepError(RuntimeError):
    """An in-flight train step failed; raised at drain time with the step
    it belongs to (not the step the host had reached when it surfaced).
    ``trace_id`` names the request trace that dispatched the step (None
    until the monitoring slice)."""

    def __init__(self, step: int, epoch: int, cause: BaseException,
                 trace_id: Optional[str] = None):
        msg = f"async train step {step} (epoch {epoch}) failed: {cause}"
        if trace_id:
            msg += f" [trace {trace_id}]"
        super().__init__(msg)
        self.step = step
        self.epoch = epoch
        self.trace_id = trace_id
        self.__cause__ = cause


class ScoreHandle:
    """Lazy score of one dispatched train step.

    Holds nothing on the device itself: the window owns the in-flight loss
    until drain. Any numeric use (``float()``, comparison, numpy coercion,
    formatting) drains through this step, so code written against the
    eager ``fit_batch -> float`` contract keeps working."""

    __slots__ = ("_window", "step", "epoch", "trace_id", "_value", "_error")

    def __init__(self, window: "AsyncScoreWindow", step: int, epoch: int):
        self._window = window
        self.step = step
        self.epoch = epoch
        self.trace_id = None  # the monitoring slice stamps the ambient trace
        self._value: Optional[float] = None
        self._error: Optional[AsyncStepError] = None

    def ready(self) -> bool:
        return self._value is not None or self._error is not None

    def value(self) -> float:
        if not self.ready():
            self._window.drain_through(self)
        if self._error is not None:
            raise self._error
        return self._value

    # ---- float-like surface (the eager contract was `fit_batch -> float`)
    def __float__(self):
        return float(self.value())

    def __int__(self):
        return int(self.value())

    def __bool__(self):
        return bool(self.value())

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.value(), dtype=dtype)

    def __format__(self, spec):
        return format(self.value(), spec)

    def __repr__(self):
        if self._error is not None:
            return f"ScoreHandle(step={self.step}, error={self._error!r})"
        if self._value is None:
            return f"ScoreHandle(step={self.step}, in-flight)"
        return f"ScoreHandle(step={self.step}, {self._value!r})"

    def __eq__(self, other):
        return self.value() == other

    def __ne__(self, other):
        return self.value() != other

    def __lt__(self, other):
        return self.value() < other

    def __le__(self, other):
        return self.value() <= other

    def __gt__(self, other):
        return self.value() > other

    def __ge__(self, other):
        return self.value() >= other

    def __hash__(self):
        return hash(self.value())

    def __add__(self, other):
        return self.value() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.value() - other

    def __rsub__(self, other):
        return other - self.value()

    def __mul__(self, other):
        return self.value() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.value() / other

    def __rtruediv__(self, other):
        return other / self.value()

    def __neg__(self):
        return -self.value()

    def __abs__(self):
        return abs(self.value())

    def __round__(self, n=None):
        return round(self.value(), n)


class AsyncScoreWindow:
    """Bounded window of in-flight (step, loss, deferred listeners) entries.

    ``submit`` appends and drains oldest-first once more than
    ``max_in_flight`` steps are outstanding, so the host stays at most that
    many steps ahead of the device. Drain order is FIFO: deferred listeners
    observe every (iteration, epoch, score) triple once, in step order, as
    in the sync trace."""

    def __init__(self, model, max_in_flight: int):
        self.model = model
        self.max_in_flight = max(1, int(max_in_flight))
        self._pending: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, loss) -> ScoreHandle:
        """Register one dispatched step's loss (a device tensor, its copy to
        the host queued here); returns its lazy handle. Called with the
        model's pre-increment step and epoch counters."""
        m = self.model
        handle = ScoreHandle(self, m.step_count, m.epoch_count)
        # snapshot: set_listeners() between dispatch and drain must not
        # change who observes this iteration
        self._pending.append((handle, _start_fetch(loss), tuple(m.listeners)))
        while len(self._pending) > self.max_in_flight:
            self._drain_one()
        return handle

    def _drain_one(self) -> None:
        # monitoring's drain and listener phases wait for the monitoring
        # slice: this is the JAX package's monitoring-off branch
        handle, loss, listeners = self._pending.popleft()
        try:
            value = _fetch_scalar(loss)
        except Exception as e:  # surfaced with the step it belongs to
            handle._error = AsyncStepError(handle.step, handle.epoch, e,
                                           trace_id=handle.trace_id)
            raise handle._error
        handle._value = value
        self.model._score_value = value
        for lst in listeners:
            lst.iteration_done(self.model, handle.step, handle.epoch, value)

    def drain(self) -> None:
        """Retire every in-flight step (epoch end / fit end / score read)."""
        while self._pending:
            self._drain_one()

    def drain_through(self, handle: ScoreHandle) -> None:
        while self._pending and not handle.ready():
            self._drain_one()


def get_window(model) -> Optional[AsyncScoreWindow]:
    """The model's async window per the current env and listeners, or None
    for the sync path. ``DL4J_TORCH_ASYNC_STEPS=0`` and eager-score
    listeners both force sync; a mode flip drains whatever is in flight
    first."""
    steps = env.async_steps
    eager = steps <= 0 or any(getattr(l, "needs_eager_score", False)
                              for l in model.listeners)
    window = getattr(model, "_score_window", None)
    if eager:
        if window is not None and len(window):
            window.drain()
        return None
    if window is None:
        window = AsyncScoreWindow(model, steps)
        model._score_window = window
    else:
        window.max_in_flight = max(1, steps)
    return window


def drain_scores(model, suppress: bool = False) -> None:
    """Drain a model's window if one exists. ``suppress=True`` is the
    already-unwinding cleanup form (the original exception wins)."""
    window = getattr(model, "_score_window", None)
    if window is None or not len(window):
        return
    if not suppress:
        window.drain()
        return
    try:
        window.drain()
    except Exception:
        pass


def deliver_score(model, loss, window: Optional[AsyncScoreWindow]
                  ) -> "float | ScoreHandle":
    """Sync path: fetch, set ``_score_value``, run the listeners. Async:
    submit to the window. The caller increments ``step_count`` after."""
    if window is not None:
        try:
            return window.submit(loss)
        except BaseException:
            # the handle is queued before the window drains, so an error
            # here belongs to an older step: this step is dispatched and
            # queued and consumes its id
            model.step_count += 1
            raise
    # monitoring's listener phase waits for the monitoring slice
    value = _fetch_scalar(loss)
    model._score_value = value
    for lst in model.listeners:
        lst.iteration_done(model, model.step_count, model.epoch_count, value)
    return value


# ---- tail-batch padding --------------------------------------------------
def _pad0(arr, pad: int, ones: bool = False):
    """Pad ``pad`` rows onto dim 0 (zeros, or ones for forward masks: an
    all-zero mask row would give softmax attention a fully masked row).
    Tensors pad on their own device, host arrays on the host; multi-input
    lists and dicts (the ComputationGraph shape) pad per entry."""
    if isinstance(arr, dict):
        return {k: _pad0(v, pad, ones) for k, v in arr.items()}
    if isinstance(arr, (list, tuple)):
        return [_pad0(v, pad, ones) for v in arr]
    if isinstance(arr, torch.Tensor):
        fill = torch.ones if ones else torch.zeros
        return torch.cat([arr, fill((pad,) + tuple(arr.shape[1:]),
                                    dtype=arr.dtype, device=arr.device)])
    a = np.asarray(arr)
    fill = np.ones if ones else np.zeros
    return np.concatenate([a, fill((pad,) + a.shape[1:], a.dtype)], axis=0)


def leading_dim(x) -> int:
    """Batch size of a features entry (array, or multi-input list/dict)."""
    if isinstance(x, dict):
        x = next(iter(x.values()))
    if isinstance(x, (list, tuple)):
        x = x[0]
    return int(x.shape[0] if isinstance(x, torch.Tensor) else np.shape(x)[0])


def _shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else np.shape(a)


def pad_tail_batch(x, y, mask, label_mask, max_batch: int):
    """Pad a partial tail batch up to its pow2 bucket of ``max_batch``.

    Returns (x, y, mask, label_mask), padded or passed through. The padded
    rows are zero features and labels excluded from the loss by a zeroed
    labels mask, so the masked-sum / valid-count normalization gives the
    unpadded batch's loss and gradients. Pass-through cases: full batches,
    batches already at a bucket size, and single-mask batches (their mask
    plays the forward and the loss role through shape-changing
    ``feed_forward_mask`` chains)."""
    b = leading_dim(x)
    if b >= max_batch:
        return x, y, mask, label_mask
    if mask is not None and label_mask is None:
        return x, y, mask, label_mask
    bucket = bucket_for(b, pow2_buckets(max_batch))
    if bucket <= b:
        return x, y, mask, label_mask
    pad = bucket - b
    if label_mask is None:
        # the loss mask that excludes the padding: per timestep [B, T] for
        # sequence labels, per example [B] otherwise
        ys = _shape(y)
        shape = ys[:2] if len(ys) == 3 else (b,)
        label_mask = (torch.ones(shape, dtype=torch.float32, device=y.device)
                      if isinstance(y, torch.Tensor)
                      else np.ones(shape, np.float32))
    x = _pad0(x, pad)
    y = _pad0(y, pad)
    if mask is not None:
        mask = _pad0(mask, pad, ones=True)
    label_mask = _pad0(label_mask, pad)
    return x, y, mask, label_mask


def supports_tail_padding(layers, outputs) -> bool:
    """Padding is loss-exact only when no layer computes cross-example
    batch statistics (BatchNorm's mean and variance would see the zero
    rows) and every output head reduces to per-example scores under a
    labels mask. ``layers`` are all the network's layers, ``outputs`` its
    output heads (None for an output that is no layer): a
    MultiLayerNetwork's last layer, a ComputationGraph's output vertices'
    layers."""
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalizationLayer
    from deeplearning4j_tpu_torch.nn.layers.output import LossLayer, OutputLayer

    outputs = list(outputs)
    if not outputs:
        return False
    for l in layers:
        if isinstance(l, BatchNormalizationLayer) and not l.use_mean_var_from_state:
            return False
    return all(isinstance(o, (OutputLayer, LossLayer)) for o in outputs)
