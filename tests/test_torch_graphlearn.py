"""The port's graph learning (``deeplearning4j_tpu_torch/graphlearn/``)
against the JAX package's, on the CPU.

``Graph`` and its random walks are the JAX package's numpy, copied: the
same seed gives the same walks. DeepWalk trains the port's Word2Vec on
them through its Python front, which draws the same pairs and host
negatives from one seed as the JAX package's: the vertex vectors are held
to JAX's within ``TOL_FIT`` (f32, relative to the largest entry; the
Word2Vec fits' tolerance in ``test_torch_nlp_embeddings.py``), and the
JAX model's state crosses through ``nlp.load_jax_state``.
``tests/test_neighbors.py``'s DeepWalk case runs in
``test_torch_neighbors.py``.
"""

import functools

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graphlearn as jax_gl
import deeplearning4j_tpu_torch.graphlearn as gl
from deeplearning4j_tpu_torch.nlp import load_jax_state

TOL_FIT = 1e-5

DeepWalk = functools.partial(gl.DeepWalk, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread for this file's tests: tier-1 runs six
    workers over the machine's cores, and at the default pool size their
    OpenMP threads oversubscribe them (the RL conv cases ran ~20x slower
    in six parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _edges(n=24, m=50, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(0, n, 2)) for _ in range(m)]


def test_exports_equal_the_jax_all():
    assert sorted(gl.__all__) == sorted(jax_gl.__all__)


def test_entry_point_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gl.DeepWalk()


@pytest.mark.parametrize("directed", [False, True])
def test_walks_equal_jax(directed):
    """Directed graphs have sinks (walks stop early); vertex 30 is
    isolated."""
    edges = _edges()
    got = gl.Graph.from_edges(edges, n_vertices=31, directed=directed)
    want = jax_gl.Graph.from_edges(edges, n_vertices=31, directed=directed)
    assert got.adj == want.adj
    assert [got.degree(v) for v in range(31)] == \
        [want.degree(v) for v in range(31)]
    for seed in (0, 5):
        assert got.random_walks(9, 3, seed=seed) == \
            want.random_walks(9, 3, seed=seed)


def test_deepwalk_walks_are_the_graphs():
    g = gl.Graph.from_edges(_edges())
    dw = DeepWalk(walk_length=7, walks_per_vertex=2, seed=3)
    assert dw.walks(g) == [[str(v) for v in w]
                           for w in g.random_walks(7, 2, seed=3)]


def test_deepwalk_fit_against_jax():
    edges = _edges()
    args = dict(vector_size=12, window=3, walk_length=8, walks_per_vertex=4,
                epochs=2, learning_rate=0.02, seed=4)
    got = DeepWalk(**args).fit(gl.Graph.from_edges(edges))
    want = jax_gl.DeepWalk(**args).fit(jax_gl.Graph.from_edges(edges))
    assert got.n_vertices == want.n_vertices
    assert got.w2v.vocab.words == want._w2v.vocab.words
    assert rel(got.w2v.W, want._w2v.W) < TOL_FIT
    assert rel(got.w2v.C, want._w2v.C) < TOL_FIT
    for v in (0, 5, 11):
        assert rel(got.get_vertex_vector(v), want.get_vertex_vector(v)) \
            < 10 * TOL_FIT
    assert abs(got.similarity(1, 2) - want.similarity(1, 2)) < 1e-4


def test_deepwalk_state_crosses_through_load_jax_state():
    g = _edges()
    args = dict(vector_size=8, window=2, walk_length=6, walks_per_vertex=2,
                epochs=1, seed=9)
    want = jax_gl.DeepWalk(**args).fit(jax_gl.Graph.from_edges(g))
    got = DeepWalk(**dict(args, seed=10)).fit(gl.Graph.from_edges(g))
    load_jax_state(got.w2v, want._w2v.vocab.words,
                   {"W": want._w2v.W, "C": want._w2v.C})
    for v in range(5):
        np.testing.assert_array_equal(got.get_vertex_vector(v),
                                      want.get_vertex_vector(v))
    assert got.vertices_nearest(0, 5) == want.vertices_nearest(0, 5)
