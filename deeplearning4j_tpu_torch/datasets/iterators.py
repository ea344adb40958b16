"""DataSetIterator contract + implementations.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``: the
DataSetIterator contract (org.nd4j.linalg.dataset.api.iterator) with its
fault-plan read retry, the list and array iterators, and the prefetching
wrapper (DL4J's AsyncDataSetIterator), which stages each batch on the
device from pinned host memory on a background thread, so the copy
overlaps the step before it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterable+resettable; subclasses implement _produce().

    Batch reads are a fault-injection point (``data_io``) and run under a
    shared RetryPolicy: a transient storage error on one batch is retried
    with backoff instead of killing the epoch (the reference's
    RecordReader retry story, owned here by the iterator base so every
    subclass inherits it). With no fault plan installed this is a single
    None check per batch — the zero-overhead contract."""

    def __init__(self, batch_size: int):
        self.batch = batch_size
        self.preprocessor = None
        self._retry = None          # built lazily on first injected fault

    def _read_batch(self, it):
        """One guarded pull: the injected ``data_io`` fault fires BEFORE
        the generator advances, so a retry re-attempts the SAME batch."""
        from deeplearning4j_tpu_torch import faults

        plan = faults.active()
        if plan is None:
            return next(it)
        if self._retry is None:
            self._retry = faults.RetryPolicy(
                max_attempts=4, base_delay_s=0.01, max_delay_s=0.2,
                deadline_s=10.0)

        def pull():
            if plan.fires("data_io"):
                raise faults.DataReadFault("injected dataset read failure")
            return next(it)

        return self._retry.call(pull, component="data")

    def __iter__(self) -> Iterator[DataSet]:
        it = iter(self._produce())
        while True:
            try:
                ds = self._read_batch(it)
            except StopIteration:
                return
            if self.preprocessor is not None:
                self.preprocessor.transform(ds)
            yield ds

    def _produce(self):
        raise NotImplementedError

    def reset(self):
        pass

    def set_preprocessor(self, pre):
        self.preprocessor = pre
        return self


class ListDataSetIterator(DataSetIterator):
    """Iterate over pre-built DataSet batches (ListDataSetIterator)."""

    def __init__(self, datasets: list[DataSet], batch_size: int = 0):
        super().__init__(batch_size or (datasets[0].num_examples() if datasets else 0))
        self.datasets = datasets

    def _produce(self):
        yield from self.datasets


class ArrayDataSetIterator(DataSetIterator):
    """Batch a (features, labels) array pair, optional shuffle each epoch."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        super().__init__(batch_size)
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def _produce(self):
        n = self.features.shape[0]
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(0, n, self.batch):
            sl = idx[i : i + self.batch]
            if self.drop_last and len(sl) < self.batch:
                break
            yield DataSet(self.features[sl], self.labels[sl])

    def total_examples(self) -> int:
        return int(self.features.shape[0])


class AsyncPrefetchIterator(DataSetIterator):
    """Wrap any iterator with a background prefetch thread (AsyncDataSetIterator).

    queue_size=2 gives double buffering: batch N+1 is staged while the device
    runs batch N. With ``device_put`` the staging includes the host-to-device
    copy, from pinned memory and without blocking the host, so it overlaps
    the previous step's compute instead of following it. ``device`` is the
    card to stage on (default ``"cuda"``); ``sharder`` (a ``batch -> batch``
    callable) replaces the plain device copy.
    """

    def __init__(self, inner: DataSetIterator, queue_size: int = 2,
                 device_put: bool = True, sharder=None, device="cuda"):
        super().__init__(getattr(inner, "batch", 0))
        self.inner = inner
        self.queue_size = queue_size
        self.device_put = device_put
        self.sharder = sharder
        self.device = device
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def _stage(self, ds: DataSet) -> DataSet:
        """Move one batch to the device (or through the sharder) on the
        prefetch thread."""
        if self.sharder is not None:
            put = self.sharder
        else:
            from deeplearning4j_tpu_torch.common.device import (
                resolve_device, to_device,
            )

            dev = resolve_device(self.device)
            put = lambda a: to_device(a, dev)  # noqa: E731
        return DataSet(
            put(ds.features), put(ds.labels),
            None if ds.features_mask is None else put(ds.features_mask),
            None if ds.labels_mask is None else put(ds.labels_mask),
        )

    def _produce(self):
        q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        _END = object()
        error: list = []

        def worker():
            try:
                for ds in self.inner:
                    if stop.is_set():
                        return
                    if self.device_put or self.sharder is not None:
                        ds = self._stage(ds)
                    # bounded put, re-checking stop: a consumer that
                    # abandons the generator mid-epoch would otherwise
                    # leave this thread blocked on a full queue forever
                    # (thread + pinned device batches leaked)
                    while not stop.is_set():
                        try:
                            q.put(ds, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
                # a source failure (e.g. an exhausted data_io fault retry)
                # must surface in the training thread, not silently
                # truncate the epoch
                error.append(e)
            finally:
                # deliver _END unless the consumer already hung up (stop):
                # a live-but-slow consumer must still see the sentinel
                while not stop.is_set():
                    try:
                        q.put(_END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        self._stop, self._thread = stop, t
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield item
            t.join()
            if error:
                raise error[0]
        finally:
            # normal exhaustion, consumer abandonment (GeneratorExit), or
            # an exception downstream: stop the producer and unblock any
            # pending put so the thread exits
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)

    def close(self):
        """Stop the prefetch thread without consuming the iterator (the
        explicit form of abandoning the generator)."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def reset(self):
        self.inner.reset()
