"""Single-model servers predating the gateway (kept as the simple tier).

Counterpart of ``deeplearning4j_tpu/serving/legacy.py``. ``ModelServer`` is
copied whole, with a ``device`` (the card unless the caller passes
``device="cpu"``) for its ParallelInference. ``KNNServer`` serves the
nearest-neighbour structures of ``neighbors/``; its brute search runs on
the same kind of ``device``.

Reference analog: the reference's serving tier — ParallelInference behind
a REST endpoint (deeplearning4j model server / nearest-neighbors-server
pattern). Stdlib-only HTTP: POST /predict with JSON {"inputs": [[...]]}
returns {"outputs": [[...]]}; batching + async execution come from
ParallelInference underneath, so concurrent requests share device batches.

For multi-model registry / canary splits / admission control / warmup, use
:class:`deeplearning4j_tpu_torch.serving.ServingGateway`.
"""

from __future__ import annotations

import queue
import time

import numpy as np

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded, ParallelInference,
)
from deeplearning4j_tpu_torch.serving.http import (
    HttpError, _HttpServerMixin, serve_json,
)


class ModelServer(_HttpServerMixin):
    """Serve a model's output() via JSON HTTP.

        server = ModelServer(model, port=0).start()
        ... POST http://host:port/predict {"inputs": [...]}
        server.stop()
    """

    def __init__(self, model, port: int = 0, host: str = "127.0.0.1",
                 batch_limit: int = 32, queue_timeout: float = 30.0,
                 device: DeviceLike = "cuda"):
        self.model = model
        self._host, self._port = host, port
        self._timeout = queue_timeout
        self._pi = ParallelInference(model, batch_limit=batch_limit,
                                     device=device)

    def start(self) -> "ModelServer":
        self._pi.start()
        pi, timeout = self._pi, self._timeout

        def predict(body):
            xs = np.asarray(body["inputs"], np.float32)
            # one shared deadline for the whole request: when the first
            # result times out, the worker sheds the expired siblings too
            # instead of computing for (and orphaning) a gone client
            deadline = time.monotonic() + timeout
            queues = [pi.submit(x, deadline=deadline) for x in xs]
            outs = []
            for q in queues:
                try:
                    r = q.get(timeout=max(deadline - time.monotonic(), 0.001))
                except queue.Empty:
                    raise HttpError(504, "prediction timed out") from None
                if isinstance(r, DeadlineExceeded):
                    raise HttpError(504, "prediction timed out") from None
                if isinstance(r, BaseException):
                    raise HttpError(500, f"forward pass failed: {r}") from None
                outs.append(np.asarray(r).tolist())
            return {"outputs": outs}

        self._httpd, self._thread = serve_json(
            self._host, self._port,
            post_routes={"/predict": predict},
            get_routes={"/health": lambda _: {"status": "ok"}})
        return self

    def stop(self):
        self._stop_httpd()
        self._pi.drain()


class KNNServer(_HttpServerMixin):
    """Nearest-neighbors HTTP server.

    Reference analog: deeplearning4j-nearestneighbors-server's
    NearestNeighborsServer — a VPTree over an indexed point set behind
    REST. Endpoints:

        POST /knn     {"point": [...], "k": n}
                      -> {"results": [{"index": i, "distance": d}, ...]}
        POST /knnvec  {"vectors": [[...], ...], "k": n}   (batched; one
                      brute-force product on the server's device)
                      -> {"results": [[{"index", "distance"}, ...], ...]}
        GET  /health

    ``backend``: "vptree" (default, the reference's structure) | "kdtree" |
    "brute" (single points also answered by the batched product). The
    brute search runs ``neighbors.knn_search`` on ``device``: the card
    unless the caller passes ``device="cpu"``; the points go there once.
    """

    def __init__(self, points, port: int = 0, host: str = "127.0.0.1",
                 backend: str = "vptree", device: DeviceLike = "cuda"):
        from deeplearning4j_tpu_torch.neighbors import (
            KDTree, VPTree, knn_search,
        )

        self.device = resolve_device(device)
        self.points = np.asarray(points, np.float32)
        self._host, self._port = host, port
        on_device = to_device(self.points, self.device)
        self._brute = lambda qs, k: knn_search(on_device, qs, k=k,
                                               device=self.device)
        if backend == "vptree":
            self._tree = VPTree(self.points)
        elif backend == "kdtree":
            self._tree = KDTree(self.points)
        elif backend == "brute":
            self._tree = None
        else:
            raise ValueError("backend must be vptree|kdtree|brute")

    def _query_one(self, point, k):
        if self._tree is not None:
            idx, dist = self._tree.knn(np.asarray(point, np.float32), k=k)
            return [{"index": int(i), "distance": float(d)}
                    for i, d in zip(idx, dist)]
        return self._query_batch([point], k)[0]

    def _query_batch(self, vectors, k):
        idx, dist = self._brute(np.asarray(vectors, np.float32), k)
        return [[{"index": int(i), "distance": float(d)}
                 for i, d in zip(row_i, row_d)]
                for row_i, row_d in zip(idx, dist)]

    def start(self) -> "KNNServer":
        self._httpd, self._thread = serve_json(
            self._host, self._port,
            post_routes={
                "/knn": lambda b: {"results": self._query_one(
                    b["point"], int(b.get("k", 1)))},
                "/knnvec": lambda b: {"results": self._query_batch(
                    b["vectors"], int(b.get("k", 1)))},
            },
            get_routes={"/health": lambda _: {"status": "ok",
                                              "points": len(self.points)}})
        return self

    def stop(self):
        self._stop_httpd()
