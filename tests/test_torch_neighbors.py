"""The port's nearest-neighbor search (``deeplearning4j_tpu_torch/
neighbors/``) and ``KNNServer`` against the JAX package's, on the CPU.

``knn_search`` for each metric returns the JAX package's indices, and its
distances within 1e-5 (near 0 the euclidean formula's own f32
cancellation, sqrt(16 eps (qq + pp)) of the float64 distance, bounds both
packages); ties rank as ``lax.top_k`` ranks them (the lower index
first). The trees are the JAX package's code, held equal to it answer
for answer. ``tests/test_neighbors.py``'s cases, DeepWalk's too (on
the port's ``graphlearn/``), run here on the port.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.neighbors as jax_neighbors
import deeplearning4j_tpu_torch.neighbors as neighbors
from deeplearning4j_tpu_torch.common.topk import top_k
from deeplearning4j_tpu_torch.neighbors import KDTree, VPTree, knn_search
from deeplearning4j_tpu_torch.serving import KNNServer

TOL_DIST = 1e-5
METRICS = ["euclidean", "cosine", "manhattan"]


def _brute(points, q, k, metric="euclidean"):
    if metric == "euclidean":
        d = np.linalg.norm(points - q, axis=1)
    elif metric == "cosine":
        pn = points / np.linalg.norm(points, axis=1, keepdims=True)
        d = 1 - pn @ (q / np.linalg.norm(q))
    order = np.argsort(d)[:k]
    return order, d[order]


def test_exports_equal_the_jax_all():
    assert sorted(neighbors.__all__) == sorted(jax_neighbors.__all__)


@pytest.mark.parametrize("metric", METRICS)
def test_knn_search_against_jax(metric):
    """Indices equal and distances within TOL_DIST, with duplicate points
    (exact ties) and a query on a point (distance 0)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 16)).astype(np.float32)
    qs = rng.normal(size=(9, 16)).astype(np.float32)
    pts[40] = pts[7]
    pts[200] = pts[7]
    qs[0] = pts[7]
    want_i, want_d = jax_neighbors.knn_search(pts, qs, k=6, metric=metric)
    got_i, got_d = knn_search(pts, qs, k=6, metric=metric, device="cpu")
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    want_d = np.asarray(want_d)
    far = want_d > 0.1
    np.testing.assert_allclose(got_d[far], want_d[far], rtol=0,
                               atol=TOL_DIST)
    # near 0, sqrt(qq - 2 q.p + pp) keeps the cancellation of its f32
    # sums, which the two packages add in different orders: both stay
    # within sqrt(16 eps (qq + pp)) of the float64 distance
    q64, p64 = qs.astype(np.float64), pts.astype(np.float64)
    for r, c in zip(*np.nonzero(~far)):
        q, p = q64[r], p64[got_i[r, c]]
        if metric == "euclidean":
            truth = np.linalg.norm(q - p)
            floor = np.sqrt(16 * np.finfo(np.float32).eps * (q @ q + p @ p))
        else:
            truth = (1 - q @ p / np.linalg.norm(q) / np.linalg.norm(p)
                     if metric == "cosine" else np.abs(q - p).sum())
            floor = TOL_DIST
        assert abs(got_d[r, c] - truth) <= floor
        assert abs(want_d[r, c] - truth) <= floor
    assert list(got_i[0, :3]) == [7, 40, 200]   # ties in index order
    # a single query vector and a tensor input answer alike
    one_i, _ = knn_search(torch.tensor(pts), qs[3], k=6, metric=metric,
                          device="cpu")
    np.testing.assert_array_equal(one_i[0], got_i[3])


def test_top_k_ranks_as_lax_top_k():
    """The packed int64 rank and the stable sort agree with lax.top_k's
    order: +0.0 above -0.0, a NaN first, lower index first among ties."""
    import jax

    a = np.array([[1.0, -0.0, 0.0, np.nan, 1.0, -2.0, 0.0],
                  [3.0, 3.0, 3.0, -1.0, 2.0, 3.0, 0.5]], np.float32)
    want_v, want_i = jax.lax.top_k(a, 5)
    for t in (torch.tensor(a), torch.tensor(a, dtype=torch.float64)):
        got_v, got_i = top_k(t, 5)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.float().numpy(),
                                      np.asarray(want_v))


@pytest.mark.parametrize("metric", METRICS)
def test_vptree_equals_jax(metric):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 8))
    mine, theirs = (VPTree(pts, distance=metric, seed=3),
                    jax_neighbors.VPTree(pts, distance=metric, seed=3))
    for _ in range(10):
        q = rng.normal(size=(8,))
        assert mine.knn(q, k=5) == theirs.knn(q, k=5)


def test_kdtree_equals_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 4))
    mine, theirs = KDTree(pts), jax_neighbors.KDTree(pts)
    for _ in range(10):
        q = rng.normal(size=(4,))
        assert mine.knn(q, k=3) == theirs.knn(q, k=3)
    assert mine.nearest(pts[17] + 1e-9) == theirs.nearest(pts[17] + 1e-9)


# ------------------------------------- tests/test_neighbors.py, on the port

class TestVPTree:
    @pytest.mark.parametrize("metric", METRICS)
    def test_matches_bruteforce(self, rng, metric):
        pts = rng.normal(size=(200, 8))
        tree = VPTree(pts, distance=metric)
        for _ in range(10):
            q = rng.normal(size=(8,))
            idx, dist = tree.knn(q, k=5)
            if metric == "manhattan":
                ref = np.argsort(np.abs(pts - q).sum(1))[:5]
            else:
                ref, _ = _brute(pts, q, 5, metric)
            assert set(idx) == set(ref.tolist())
            assert dist == sorted(dist)


class TestKDTree:
    def test_matches_bruteforce(self, rng):
        pts = rng.normal(size=(300, 4))
        tree = KDTree(pts)
        for _ in range(10):
            q = rng.normal(size=(4,))
            idx, dist = tree.knn(q, k=3)
            ref, refd = _brute(pts, q, 3)
            assert set(idx) == set(ref.tolist())
            np.testing.assert_allclose(dist, refd, rtol=1e-9)

    def test_nearest(self, rng):
        pts = rng.normal(size=(50, 3))
        i, _ = KDTree(pts).nearest(pts[17] + 1e-9)
        assert i == 17


class TestDeviceKnn:
    @pytest.mark.parametrize("metric", METRICS)
    def test_matches_bruteforce(self, rng, metric):
        pts = rng.normal(size=(128, 16)).astype(np.float32)
        qs = rng.normal(size=(4, 16)).astype(np.float32)
        idx, _ = knn_search(pts, qs, k=4, metric=metric, device="cpu")
        assert idx.shape == (4, 4)
        for qi in range(4):
            if metric == "manhattan":
                ref = np.argsort(np.abs(pts - qs[qi]).sum(1))[:4]
            else:
                ref, _ = _brute(pts, qs[qi], 4, metric)
            assert set(idx[qi].tolist()) == set(ref.tolist())


def _post(url, path, body):
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


class TestKNNServer:
    @pytest.mark.parametrize("backend", ["vptree", "kdtree", "brute"])
    def test_endpoints_match_direct_search(self, backend):
        """Over HTTP on the CPU, each backend: /health, /knn, /knnvec and a
        bad request, against the JAX package's server on the same points."""
        from deeplearning4j_tpu.serving import KNNServer as JaxKNNServer

        rng = np.random.default_rng(0)
        pts = rng.normal(size=(50, 8)).astype(np.float32)
        servers = [KNNServer(pts, port=0, backend=backend,
                             device="cpu").start(),
                   JaxKNNServer(pts, port=0, backend=backend).start()]
        try:
            url, jax_url = (f"http://127.0.0.1:{s.port}" for s in servers)
            health = json.loads(urllib.request.urlopen(
                f"{url}/health", timeout=10).read())
            assert health["points"] == 50
            q = pts[7] + 1e-4
            body = _post(url, "/knn", {"point": q.tolist(), "k": 3})
            assert body["results"][0]["index"] == 7
            direct_i, _ = knn_search(pts, q[None], k=3, device="cpu")
            assert [r["index"] for r in body["results"]] == list(direct_i[0])
            want = _post(jax_url, "/knn", {"point": q.tolist(), "k": 3})
            for a, b in zip(body["results"], want["results"]):
                assert a["index"] == b["index"]
                assert abs(a["distance"] - b["distance"]) < TOL_DIST
            qs = pts[[3, 11]] + 1e-4
            body = _post(url, "/knnvec", {"vectors": qs.tolist(), "k": 2})
            assert body["results"][0][0]["index"] == 3
            assert body["results"][1][0]["index"] == 11
            want = _post(jax_url, "/knnvec", {"vectors": qs.tolist(),
                                              "k": 2})
            assert ([[r["index"] for r in row] for row in body["results"]]
                    == [[r["index"] for r in row]
                        for row in want["results"]])
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, "/knn", {"k": 1})
            assert err.value.code == 400
        finally:
            for s in servers:
                s.stop()

    def test_backends_agree(self):
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(40, 5)).astype(np.float32)
        q = rng.normal(size=(5,)).astype(np.float32)
        answers = [[r["index"] for r in KNNServer(
            pts, backend=b, device="cpu")._query_one(q, 4)]
            for b in ("vptree", "kdtree", "brute")]
        assert answers[0] == answers[1] == answers[2]

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="backend"):
            KNNServer(np.zeros((3, 2)), backend="ball", device="cpu")


class TestDeepWalk:
    def test_two_cliques(self):
        from deeplearning4j_tpu_torch.graphlearn import DeepWalk, Graph

        # two dense cliques joined by one bridge edge: embeddings should
        # cluster by clique
        edges = []
        for a in range(5):
            for b in range(a + 1, 5):
                edges.append((a, b))
                edges.append((a + 5, b + 5))
        edges.append((0, 5))
        g = Graph.from_edges(edges, n_vertices=10)
        dw = DeepWalk(vector_size=16, window=3, walk_length=10,
                      walks_per_vertex=20, epochs=5, learning_rate=0.01,
                      seed=4, device="cpu").fit(g)
        assert dw.get_vertex_vector(0).shape == (16,)
        # in-clique similarity beats cross-clique (excluding bridge nodes)
        assert dw.similarity(1, 2) > dw.similarity(1, 7)


def test_entry_points_take_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pts = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        knn_search(pts, pts[:1])
    for backend in ("vptree", "kdtree", "brute"):
        with pytest.raises(RuntimeError, match="cuda"):
            KNNServer(pts, backend=backend)


@pytest.mark.cuda
def test_knn_search_on_the_card_against_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(5000, 32)).astype(np.float32)
    qs = rng.normal(size=(16, 32)).astype(np.float32)
    for metric in METRICS:
        gi, gd = knn_search(pts, qs, k=8, metric=metric)
        ci, cd = knn_search(pts, qs, k=8, metric=metric, device="cpu")
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_allclose(gd, cd, rtol=0, atol=TOL_DIST)
