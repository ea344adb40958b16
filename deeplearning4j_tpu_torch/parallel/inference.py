"""Parallel inference: request batching in front of a model's ``output()``.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``. Reference
analog: org.deeplearning4j.parallelism.ParallelInference, an observable
queue that coalesces single requests into batches for the model.

The queue, its lanes and its supervision are the JAX module's, copied:

- **Admission.** The lanes can be bounded (``max_queue``; ``queue.Full``
  is the gateway's 429), every request can carry a monotonic-clock
  ``deadline`` (an expired request is shed at dispatch and resolved with
  :class:`DeadlineExceeded`), a forward-pass error is fanned back to every
  waiter of its batch, and ``stop(drain=True)`` flushes admitted requests
  before joining.
- **Self-healing.** A crash that escapes the forward-pass handler (a ragged
  stack, an injected ``infer_crash`` / ``worker_crash``) fans the error back
  to the in-flight batch and revives the loop in place; a thread found dead
  at submit time is restarted before the request is admitted. Every revival
  counts in ``restarts`` and ``dl4j_recovery_total{component="serving"}``;
  ``healthy()`` feeds the gateway's /healthz. ``slow_worker`` sleeps the
  plan's delay before the batch.
- **Priority lanes and replicas.** ``klass="batch"`` rides the low-priority
  lane, drained only when the primary lane is empty; ``replicas`` worker
  threads share the lanes and ``set_replicas(n)`` (the autoscaler's
  actuator) grows or shrinks the pool live. ``on_depth(backlog)`` fires
  whenever requests leave the lanes, sheds included.

What differs is the crossing between the host and the card. A batch is
stacked on the host, zero-padded to the next power of two (as in the JAX
package, where the pad bounded XLA's retraces; here it keeps the op
registry's choice cache, cuBLAS's plans and the recurrent launchers' plans
to a few shapes, the ones the registry's warm-up runs), staged on
``device`` in pinned memory without blocking the host, run through
``model.output`` with autograd off (so the recurrent wrappers take their
serving path), sliced to its real rows on the device, and copied back
once: that copy is the batch's one host sync. ``batches`` counts the
batches dispatched. Several replicas call ``model.output`` at once on the
default stream; the op registry's choice cache is locked for them.

``device`` defaults to the card and must be where a model that has a
``device`` lives; asking for the card where there is none raises.

With a ``mesh`` (a ``DeviceMesh``), the synchronous :meth:`output` is
collective, as the JAX package's is one program sharded over the mesh's
"data" axis: every rank calls it with the same x, each rank runs its slice
of dim 0 (the batch zero-padded to a multiple of the axis size), and the
slices are all-gathered and trimmed, so every rank returns the whole
batch's output. The batching workers stay local to their rank: they call
the model itself.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.monitoring import flight


class DeadlineExceeded(Exception):
    """Posted to a request's result queue when its deadline passed before
    dispatch. Callers that submit with deadlines must check ``get()``
    results with :func:`resolve`."""


def resolve(result):
    """Turn a result-queue item into a value: raises when the worker posted
    an exception (deadline shed or forward-pass failure)."""
    if isinstance(result, BaseException):
        raise result
    return result


class ParallelInference:
    """Batched inference server around a model's output().

    batch_limit: max requests coalesced into one device batch;
    queue_timeout_s: max wait to fill a batch before running partial;
    max_queue: bound on admitted-but-undispatched requests PER LANE (0 =
    unbounded; when full, ``submit`` raises ``queue.Full`` — backpressure,
    not pile-up);
    replicas: worker threads sharing the lanes (autoscaler-adjustable via
    :meth:`set_replicas`);
    on_shed: optional callback(n, klass) invoked when n deadline-expired
    requests of priority class ``klass`` are shed at dispatch;
    on_depth: optional callback(backlog) invoked whenever requests leave
    the lanes (dispatch or shed) — the queue-depth gauge feed;
    name: worker-thread name prefix (threads are ``<name>-<idx>``) — the
    gateway registry passes ``pi-<model>`` so stack dumps and Perfetto
    thread tracks identify which model a worker serves;
    device: where batches are staged (the model's device).
    """

    def __init__(self, model, mesh=None,
                 batch_limit: int = 32, queue_timeout_s: float = 0.005,
                 pad_batches: bool = True, max_queue: int = 0,
                 replicas: int = 1,
                 on_shed: Optional[Callable] = None,
                 on_depth: Optional[Callable[[int], None]] = None,
                 name: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device_type}, "
                             f"ParallelInference was asked for "
                             f"{self.device}")
        model_device = getattr(model, "device", None)
        if (isinstance(model_device, (str, torch.device))
                and torch.device(model_device) != self.device):
            raise ValueError(f"the model lives on {model_device}, "
                             f"ParallelInference was asked for "
                             f"{self.device}; call model.to(...)")
        self.model = model
        self.mesh = mesh
        self.name = name or "pi-worker"
        self.batch_limit = batch_limit
        self.queue_timeout_s = queue_timeout_s
        # a partially-filled batch is zero-padded up to the next power of
        # two before dispatch, so the model sees at most
        # log2(batch_limit)+1 batch shapes: the ones warm-up ran
        self.pad_batches = pad_batches
        self.max_queue = max_queue
        self.on_shed = on_shed
        self.on_depth = on_depth
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)       # primary
        self._q_lo: queue.Queue = queue.Queue(maxsize=max_queue)    # batch
        self._sem = threading.Semaphore(0)   # counts items across both lanes
        self._workers: Dict[int, threading.Thread] = {}
        self._target = max(1, int(replicas))
        self._stop = threading.Event()
        self._accepting = False
        # self-healing bookkeeping: how many times a worker loop was
        # revived after an unexpected death (crash escaping the per-batch
        # handler, or a thread found dead at submit time)
        self.restarts = 0
        self._restart_lock = threading.Lock()
        #: batches dispatched to the model (padded batches count once)
        self.batches = 0

    # --- synchronous one-shot API (ParallelInference.output) ---
    def output(self, x):
        """The model's output on ``x``; with a mesh, collective over its
        "data" axis (every rank calls it with the same x)."""
        if self.mesh is None:
            return self.model.output(x)
        from deeplearning4j_tpu_torch.common.trees import tree_map
        from deeplearning4j_tpu_torch.parallel.collectives import (
            all_gather, axis_group,
        )

        group = axis_group(self.mesh, "data")
        n, r = self.mesh.shape["data"], self.mesh.index("data")
        x = to_device(x, self.device)
        b = x.shape[0]
        per = -(-b // n)
        if per * n != b:
            x = torch.cat([x, x.new_zeros((per * n - b,) + x.shape[1:])])
        with torch.no_grad():
            ys = self.model.output(x[r * per:(r + 1) * per])
            return tree_map(lambda y: all_gather(y.contiguous(), group,
                                                 0)[:b], ys)

    def _forward(self, xs: np.ndarray, n: int) -> np.ndarray:
        """One padded batch through the model: staged on the device, the
        padding sliced off there, one copy back (the batch's sync)."""
        with torch.no_grad():
            ys = self.model.output(to_device(xs, self.device))
            if isinstance(ys, torch.Tensor):
                return ys[:n].cpu().numpy()
        return np.asarray(ys)[:n]

    # --- single-worker compatibility shims (tests poke worker 0) ---
    @property
    def _worker(self) -> Optional[threading.Thread]:
        return self._workers.get(0)

    @_worker.setter
    def _worker(self, thread: Optional[threading.Thread]) -> None:
        if thread is None:
            self._workers.pop(0, None)
        else:
            self._workers[0] = thread

    # --- async batched API ---
    def start(self):
        self._stop.clear()
        self._accepting = True
        for i in range(self._target):
            self._spawn(i)
        return self

    def _spawn(self, idx: int) -> None:
        t = threading.Thread(target=self._run, args=(idx,),
                             name=f"{self.name}-{idx}", daemon=True)
        self._workers[idx] = t
        t.start()

    def replicas(self) -> int:
        """Live worker-thread count (the autoscaler's observed state)."""
        return sum(1 for w in self._workers.values() if w.is_alive())

    def set_replicas(self, n: int) -> int:
        """Grow/shrink the worker pool to ``n`` threads. Growth spawns
        immediately; shrink is cooperative — surplus workers retire at
        their next loop check, finishing their in-flight batch first.
        Returns the new target."""
        n = max(1, int(n))
        with self._restart_lock:
            self._target = n
            if not self._stop.is_set():
                for i in range(n):
                    w = self._workers.get(i)
                    if w is None or not w.is_alive():
                        self._spawn(i)
        return self._target

    def stop(self, drain: bool = False, timeout: float = 30.0):
        """Stop the workers. ``drain=True`` first stops admitting, flushes
        every already-queued request (bounded by ``timeout``), and only
        then joins — in-flight work completes instead of being orphaned."""
        self._accepting = False
        alive = [w for w in self._workers.values() if w.is_alive()]
        if drain and alive:
            end = time.monotonic() + timeout
            while self.backlog() and time.monotonic() < end:
                time.sleep(0.005)
        self._stop.set()
        for w in self._workers.values():
            if w.is_alive():
                w.join(timeout=max(5.0, timeout))

    def drain(self, timeout: float = 30.0):
        """Graceful shutdown: stop admitting, flush, join."""
        self.stop(drain=True, timeout=timeout)

    def backlog(self) -> int:
        """Admitted-but-undispatched request count across both lanes
        (approximate)."""
        return self._q.qsize() + self._q_lo.qsize()

    def lane_backlog(self, klass: Optional[str] = None) -> int:
        """Backlog of the lane ``klass`` routes to. Admission capacity
        checks use this rather than :meth:`backlog` so a saturated batch
        lane cannot starve interactive admission — lanes are bounded
        independently, exactly like ``submit`` routes them."""
        return (self._q_lo if klass == "batch" else self._q).qsize()

    def submit(self, x, deadline: Optional[float] = None,
               klass: Optional[str] = None, trace=None) -> "queue.Queue":
        """Submit one example [features...] -> a result queue of size 1.

        ``deadline``: optional ``time.monotonic()`` instant; a request still
        undispatched past it is resolved with :class:`DeadlineExceeded`
        rather than executed. ``klass``: priority class — ``"batch"`` rides
        the low-priority lane, anything else the primary lane. ``trace``:
        optional RequestTrace — the worker records the request's queue-wait
        and device-dispatch spans on it (None = zero tracing work). Raises
        ``queue.Full`` when a bounded lane is at capacity and
        ``RuntimeError`` when the server is not accepting (stopped or
        draining). Worker threads found dead (they should be running while
        accepting) are restarted before the request is admitted — no
        request enters a lane nothing is consuming.
        """
        if not self._accepting:
            raise RuntimeError("ParallelInference is not accepting requests "
                               "(stopped or draining)")
        if (self._workers
                and not any(w.is_alive() for w in self._workers.values())
                and not self._stop.is_set()):
            self._revive("dead_thread")
        out: queue.Queue = queue.Queue(maxsize=1)
        lane = self._q_lo if klass == "batch" else self._q
        lane.put_nowait((np.asarray(x), out, deadline, klass, trace,
                         time.monotonic() if trace is not None else 0.0))
        self._sem.release()
        return out

    def healthy(self) -> bool:
        """True while at least one worker is running (or the pool is
        intentionally stopped); False only in the degraded window between
        the last worker death and its revival."""
        return (not self._workers or self._stop.is_set()
                or any(w.is_alive() for w in self._workers.values()))

    def _record_restart(self, outcome: str):
        with self._restart_lock:
            self.restarts += 1
        mon = monitoring.recovery_monitor()
        if mon is not None:
            mon.recovery_total.labels(component="serving",
                                      outcome=outcome).inc()
        rec = flight.recorder()
        if rec is not None:
            # a dump-trigger kind: a worker death under load is exactly
            # the incident the black box exists for
            rec.record("worker_crash", severity="error", component="serving",
                       worker=self.name, outcome=outcome,
                       restarts=self.restarts)

    def _revive(self, outcome: str):
        """Restart dead worker threads (detected at submit time). Queued
        requests are preserved — the new threads drain them."""
        spawned = False
        with self._restart_lock:
            if self._stop.is_set():
                return
            for i in range(self._target):
                w = self._workers.get(i)
                if w is not None and not w.is_alive():
                    self._spawn(i)
                    spawned = True
        if spawned:
            self._record_restart(outcome)

    def _pop(self, timeout: float):
        """One request off the lanes, primary first; None on timeout. A
        semaphore permit guarantees an item exists across the two lanes,
        so batch-only load never stalls behind a blocking get on the empty
        primary lane."""
        if not self._sem.acquire(timeout=timeout):
            return None
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return self._q_lo.get_nowait()

    def _run(self, idx: int = 0):
        while not self._stop.is_set():
            if idx >= self._target:
                return          # autoscaler shrank the pool; retire quietly
            try:
                self._serve_once()
            except Exception:  # noqa: BLE001 — a crash that escaped the
                # forward-pass handler (ragged np.stack, injected
                # infer_crash, a bug outside the forward try) used to kill
                # the thread and hang every queued future. _serve_once
                # already fanned the error to the in-flight batch; revive
                # the loop in place and keep serving.
                self._record_restart("worker_restarted")
                continue

    def _serve_once(self):
        """Pull + dispatch one batch. Any exception after requests are
        dequeued is fanned back to every unresolved waiter before it
        propagates — no future is ever silently dropped."""
        first = self._pop(timeout=0.05)
        if first is None:
            return
        batch = [first]
        while len(batch) < self.batch_limit:
            item = self._pop(timeout=self.queue_timeout_s)
            if item is None:
                break
            batch.append(item)
        if self.on_depth is not None:
            # requests just left the lanes; every exit path below (shed,
            # dispatch, error fan-back) counts as a dequeue for the gauge
            self.on_depth(self.backlog())
        pending = list(batch)       # not yet resolved with a result/error
        try:
            from deeplearning4j_tpu_torch import faults

            plan = faults.active()
            if plan is not None:
                if plan.fires("infer_crash") or plan.fires("worker_crash"):
                    raise faults.InferenceWorkerCrash(
                        "injected inference-worker crash")
                if plan.fires("slow_worker"):
                    time.sleep(plan.delay_s)
            # shed deadline-expired requests BEFORE dispatch: their callers
            # get an immediate DeadlineExceeded instead of riding (and
            # paying for) a device batch whose result nobody will read
            now = time.monotonic()
            live, shed = [], {}
            for item in batch:
                if item[2] is not None and now > item[2]:
                    item[1].put(DeadlineExceeded(
                        "deadline passed before dispatch"))
                    pending.remove(item)
                    shed[item[3]] = shed.get(item[3], 0) + 1
                    if item[4] is not None:
                        item[4].add_span("queue_wait", item[5], now)
                        item[4].event("shed", reason="deadline")
                else:
                    live.append(item)
                    if item[4] is not None:
                        item[4].add_span("queue_wait", item[5], now)
            if shed and self.on_shed is not None:
                for klass, n in shed.items():
                    self.on_shed(n, klass)
            if not live:
                return
            mon = monitoring.serving_monitor()
            if mon is not None:
                # batch-size distribution + queue backlog at dispatch time
                mon.batch_size.observe(len(live))
                mon.queue_depth.set(self.backlog())
            xs = np.stack([b[0] for b in live])
            n = xs.shape[0]
            if self.pad_batches and n > 1:
                bucket = min(1 << (n - 1).bit_length(), self.batch_limit)
                if bucket > n:
                    pad = np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)
                    xs = np.concatenate([xs, pad])
            t_dis = time.monotonic()
            with self._restart_lock:
                self.batches += 1
            try:
                ys = self._forward(xs, n)
            except Exception as e:  # noqa: BLE001 — an EXPECTED failure
                # mode (bad input, OOM): fan it back and keep the loop —
                # not a worker crash, so no restart is counted
                for item in live:
                    item[1].put(e)
                    pending.remove(item)
                return
            t_done = time.monotonic()
            for item, y in zip(live, ys):
                if item[4] is not None:
                    item[4].add_span("device_dispatch", t_dis, t_done,
                                     batch=len(live))
                item[1].put(y)
                pending.remove(item)
        except Exception as e:  # noqa: BLE001 — crash path: resolve every
            # still-pending waiter with the error, then escalate to _run
            # for the restart accounting
            for item in pending:
                item[1].put(e)
            raise
