"""The port's t-SNE (``deeplearning4j_tpu_torch/plot/``) against the JAX
package's, on the CPU.

``_conditional_probs`` (host numpy, its squared distances in row blocks)
equals the JAX package's bit for bit. The optimizer is held to JAX's
``_tsne_optimize`` from the same P and Y0: within ``TOL_FIRST`` for the
first iterations at the defaults (learning rate 200), and within
``TOL_50`` after 50 iterations at learning rate 10. At 200 on these small
point sets the early iterations blow Y up from 1e-4 to ~50 and amplify
rounding ~10x an iteration: the JAX run against itself with one entry of
Y0 moved by one ulp parts by 6 % after 50 iterations at N = 300 (on the
CPU), so no f32 tolerance holds there; at learning rate 10 that
sensitivity is 2e-6. ``tests/test_tsne.py``'s case runs here on the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.plot as jax_plot
import deeplearning4j_tpu.plot.tsne as jax_tsne
import deeplearning4j_tpu_torch.plot as plot
import deeplearning4j_tpu_torch.plot.tsne as port_tsne

TOL_FIRST = 1e-5   # relative to max |Y|; read 2e-7 to 1.1e-6 (1-5 iterations)
TOL_50 = 1e-4      # relative to max |Y|; read 1.06e-5

BarnesHutTsne = functools.partial(plot.BarnesHutTsne, device="cpu")


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


def _clusters(n=120, d=10, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = np.eye(3, d) * 4.0
    return np.concatenate([rng.normal(c, spread, (n // 3, d))
                           for c in centers])


def _both(P, Y0, n_iter, lr, ex):
    kw = dict(learning_rate=lr, momentum_init=0.5, momentum_final=0.8,
              exaggeration=12.0)
    Yj, klj = jax_tsne._tsne_optimize(jnp.asarray(P, jnp.float32),
                                      jnp.asarray(Y0), n_iter=n_iter,
                                      exaggeration_iters=ex, **kw)
    Yp, klp = port_tsne._tsne_optimize(torch.tensor(P, dtype=torch.float32),
                                       torch.tensor(Y0), n_iter, ex, **kw)
    Yj = np.asarray(Yj)
    return (float(np.abs(Yp.numpy() - Yj).max() / np.abs(Yj).max()),
            float(klp), float(klj))


def test_exports_equal_the_jax_all():
    assert sorted(plot.__all__) == sorted(jax_plot.__all__)


def test_entry_point_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plot.BarnesHutTsne()


@pytest.mark.parametrize("block_bytes", [None, 4096])
def test_conditional_probs_equal_jax(monkeypatch, block_bytes):
    """Equal bit for bit, in one block and in blocks of a few rows."""
    if block_bytes is not None:
        monkeypatch.setattr(port_tsne, "_BLOCK_BYTES", block_bytes)
    X = _clusters(60)
    np.testing.assert_array_equal(port_tsne._conditional_probs(X, 10.0),
                                  jax_tsne._conditional_probs(X, 10.0))


def test_squared_distances_in_blocks_equal_the_broadcast(monkeypatch):
    X = np.random.default_rng(3).normal(size=(37, 7))
    want = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    monkeypatch.setattr(port_tsne, "_BLOCK_BYTES", 5 * 37 * 7 * 8)
    np.testing.assert_array_equal(port_tsne._sq_dists(X), want)


def test_initial_embedding_is_the_jax_draw():
    tsne = BarnesHutTsne(seed=5)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(
        tsne.initial_embedding(40),
        rng.normal(0, 1e-4, (40, 2)).astype(np.float32))


@pytest.mark.parametrize("n_iter", [1, 3])
def test_first_iterations_at_the_defaults_against_jax(n_iter):
    X = _clusters()
    P = jax_tsne._conditional_probs(X, 10.0)
    Y0 = BarnesHutTsne(seed=1).initial_embedding(len(X))
    err, klp, klj = _both(P, Y0, n_iter, 200.0, 2)
    assert err <= TOL_FIRST
    assert abs(klp - klj) <= TOL_FIRST * abs(klj)


def test_fifty_iterations_against_jax():
    """Across the exaggeration's end (iteration 12) and the momentum
    switch."""
    X = _clusters()
    P = jax_tsne._conditional_probs(X, 10.0)
    Y0 = BarnesHutTsne(seed=1).initial_embedding(len(X))
    err, klp, klj = _both(P, Y0, 50, 10.0, 12)
    assert err <= TOL_50
    assert abs(klp - klj) <= TOL_50 * abs(klj)


def test_fit_transform_is_the_optimizer_on_the_host_probs():
    tsne = BarnesHutTsne(perplexity=10, max_iter=8, learning_rate=10.0,
                         seed=2)
    X = _clusters(45)
    Y = tsne.fit_transform(X)
    P = jax_tsne._conditional_probs(np.asarray(X, np.float64), 10.0)
    Yj, klj = jax_tsne._tsne_optimize(
        jnp.asarray(P, jnp.float32), jnp.asarray(tsne.initial_embedding(45)),
        n_iter=8, exaggeration_iters=2, learning_rate=10.0,
        momentum_init=0.5, momentum_final=0.8, exaggeration=12.0)
    assert isinstance(Y, np.ndarray) and Y.shape == (45, 2)
    assert np.abs(Y - np.asarray(Yj)).max() <= TOL_FIRST * np.abs(Yj).max()
    assert abs(tsne.kl_divergence_ - float(klj)) <= TOL_FIRST * float(klj)


def test_step_is_one_iteration_of_the_optimizer():
    P = torch.tensor(jax_tsne._conditional_probs(_clusters(30), 5.0),
                     dtype=torch.float32)
    Y0 = torch.tensor(BarnesHutTsne(seed=3).initial_embedding(30))
    Y, vel, gains = Y0, torch.zeros_like(Y0), torch.ones_like(Y0)
    off = port_tsne.off_diagonal(30, P)
    for i in range(4):
        ex = i < 2
        Y, vel, gains = port_tsne.tsne_step(Y, vel, gains,
                                            P * 12.0 if ex else P,
                                            0.5 if ex else 0.8, 200.0, off)
    want, _ = port_tsne._tsne_optimize(P, Y0, 4, 2, 200.0, 0.5, 0.8, 12.0)
    assert torch.equal(Y, want)


# ------------------------------------ tests/test_tsne.py's case, on the port

class TestTsne:
    def test_separates_clusters(self, rng):
        centers = np.eye(3, 10) * 8.0
        X = np.concatenate([rng.normal(c, 0.3, (30, 10)) for c in centers])
        labels = np.repeat(np.arange(3), 30)
        tsne = BarnesHutTsne(n_components=2, perplexity=10, max_iter=400,
                             seed=1)
        Y = tsne.fit_transform(X)
        assert Y.shape == (90, 2)
        assert np.isfinite(tsne.kl_divergence_)
        intra = np.mean([np.linalg.norm(Y[labels == k] -
                                        Y[labels == k].mean(0), axis=1).mean()
                         for k in range(3)])
        cents = np.stack([Y[labels == k].mean(0) for k in range(3)])
        inter = np.mean([np.linalg.norm(cents[a] - cents[b])
                         for a in range(3) for b in range(a + 1, 3)])
        assert inter > 3.0 * intra, (intra, inter)


@pytest.mark.cuda
def test_iterations_on_the_card_from_the_cpus_states():
    """20 early iterations on the CPU; each again on the card from the
    CPU's state, within TOL_FIRST of the CPU's next Y."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    X = _clusters(300)
    P = torch.tensor(jax_tsne._conditional_probs(X, 30.0),
                     dtype=torch.float32)
    Pg = P.cuda()
    off, offg = (port_tsne.off_diagonal(len(X), t) for t in (P, Pg))
    Y0 = torch.tensor(BarnesHutTsne(seed=1).initial_embedding(len(X)))
    cpu = [(Y0, torch.zeros_like(Y0), torch.ones_like(Y0))]
    for _ in range(20):
        cpu.append(port_tsne.tsne_step(*cpu[-1], P * 12.0, 0.5, 200.0, off))
    for before, after in zip(cpu[:-1], cpu[1:]):
        got = port_tsne.tsne_step(*(t.cuda() for t in before), Pg * 12.0,
                                  0.5, 200.0, offg)[0].cpu()
        assert float((got - after[0]).abs().max()
                     / after[0].abs().max()) <= TOL_FIRST
