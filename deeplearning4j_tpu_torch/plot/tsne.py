"""t-SNE.

Counterpart of ``deeplearning4j_tpu/plot/tsne.py``: the same perplexity
search on the host, the same exact O(N^2) gradient, early exaggeration,
momentum and gain adaptation in f32, the same initial embedding (one numpy
draw from ``seed``), so the same points give the same embedding within f32
rounding.

Reference analog: org.deeplearning4j.plot.BarnesHutTsne — the reference
approximates the repulsive forces with a Barnes-Hut quadtree (``theta``).
The exact gradient is a handful of [N, N] products and elementwise passes
on the card, so for the N this class is used at (thousands of points) it
is exact; ``theta`` is accepted for API parity and ignored (exact = theta
0). The JAX package runs the loop as one jitted ``lax.fori_loop``; here it
is a Python loop of tensor ops on the device, the exaggeration and the
momentum switch a branch on the iteration, and KL computed once, at the
end, against P.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)

# rows of the [rows, N, D] float64 difference block of _sq_dists: 64 MB
_BLOCK_BYTES = 64 << 20


def _sq_dists(X: np.ndarray) -> np.ndarray:
    """``((X[:, None] - X[None]) ** 2).sum(-1)`` in row blocks: each row's
    sum is the same reduction over the same contiguous D values, so the
    result equals the whole broadcast's bit for bit without its [N, N, D]
    buffer (3.2 GB at N = 2,000, D = 100)."""
    n, d = X.shape
    rows = max(1, _BLOCK_BYTES // max(1, n * d * X.itemsize))
    out = np.empty((n, n), X.dtype)
    for s in range(0, n, rows):
        out[s:s + rows] = ((X[s:s + rows, None, :] - X[None, :, :]) ** 2
                           ).sum(-1)
    return out


def _conditional_probs(X: np.ndarray, perplexity: float) -> np.ndarray:
    """Per-point sigma binary search to hit the target perplexity (host-side,
    matches the reference's computeGaussianPerplexity)."""
    n = X.shape[0]
    d2 = _sq_dists(X)
    np.fill_diagonal(d2, np.inf)
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi = 1e-20, 1e20
        beta = 1.0
        for _ in range(64):
            p = np.exp(-d2[i] * beta)
            s = p.sum()
            if s <= 0:
                H = 0.0
            else:
                p = p / s
                H = -(p[p > 0] * np.log(p[p > 0])).sum()
            if abs(H - target) < 1e-5:
                break
            if H > target:
                lo = beta
                beta = beta * 2 if hi >= 1e20 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo <= 1e-20 else (beta + lo) / 2
        P[i] = np.exp(-d2[i] * beta)
        P[i, i] = 0.0
        P[i] /= max(P[i].sum(), 1e-12)
    P = (P + P.T) / (2.0 * n)
    return np.maximum(P, 1e-12)


def _grad_kl(Y, Pm, off_diag, need_kl=False):
    """The KL gradient at Y (and KL itself when ``need_kl``), the JAX
    package's f32 ops in its order."""
    d2 = ((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d2)
    num = num * off_diag
    Q = num / torch.clamp(num.sum(), min=1e-12)
    Q = torch.clamp(Q, min=1e-12)
    PQ = (Pm - Q) * num
    g = 4.0 * ((PQ.sum(1)[:, None] * Y) - PQ @ Y)
    kl = (Pm * torch.log(Pm / Q)).sum() if need_kl else None
    return g, kl


def off_diagonal(n, like):
    """``1 - eye(n)`` in ``like``'s type and device."""
    return 1.0 - torch.eye(n, dtype=like.dtype, device=like.device)


def tsne_step(Y, vel, gains, Pm, mom, learning_rate, off_diag):
    """One iteration: the gradient against ``Pm`` (P, exaggerated early),
    the gains rule, the momentum step and the re-centring; returns the new
    (Y, vel, gains)."""
    g, _ = _grad_kl(Y, Pm, off_diag)
    same_sign = torch.sign(g) == torch.sign(vel)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                        min=0.01)
    vel = mom * vel - learning_rate * gains * g
    Y = Y + vel
    return Y - Y.mean(0), vel, gains


def _tsne_optimize(P, Y0, n_iter, exaggeration_iters, learning_rate,
                   momentum_init, momentum_final, exaggeration):
    """``n_iter`` gradient steps from Y0 on P's device; returns (Y, KL)
    as device tensors."""
    off_diag = off_diagonal(Y0.shape[0], P)
    P_ex = P * exaggeration
    Y, vel, gains = Y0.clone(), torch.zeros_like(Y0), torch.ones_like(Y0)
    for i in range(n_iter):
        early = i < exaggeration_iters
        Y, vel, gains = tsne_step(
            Y, vel, gains, P_ex if early else P,
            momentum_init if early else momentum_final, learning_rate,
            off_diag)
    _, kl = _grad_kl(Y, P, off_diag, need_kl=True)
    return Y, kl


class BarnesHutTsne:
    """t-SNE with the reference's builder-ish surface.

        tsne = BarnesHutTsne(n_components=2, perplexity=30.0, max_iter=1000)
        Y = tsne.fit_transform(X)

    ``device``: the card when None (raising without one), the CPU only
    when asked. ``embedding_`` and ``kl_divergence_`` are host values.
    """

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, max_iter: int = 1000,
                 learning_rate: float = 200.0, exaggeration: float = 12.0,
                 seed: int = 42, device: DeviceLike = None):
        self.device = resolve_device("cuda" if device is None else device)
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta  # API parity; exact gradient is used regardless
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.exaggeration = exaggeration
        self.seed = seed
        self.embedding_: Optional[np.ndarray] = None
        self.kl_divergence_: float = float("nan")

    def initial_embedding(self, n: int) -> np.ndarray:
        """Y0: the JAX package's draw from ``seed``."""
        rng = np.random.default_rng(self.seed)
        return rng.normal(0, 1e-4, (n, self.n_components)).astype(np.float32)

    def optimize(self, P: np.ndarray, Y0: np.ndarray):
        """The optimizer alone over host P and Y0: (Y, KL) as device
        tensors, unread."""
        return _tsne_optimize(
            to_device(np.asarray(P, np.float32), self.device),
            to_device(np.asarray(Y0, np.float32), self.device),
            n_iter=self.max_iter,
            exaggeration_iters=min(250, self.max_iter // 4),
            learning_rate=self.learning_rate,
            momentum_init=0.5, momentum_final=0.8,
            exaggeration=self.exaggeration)

    def fit_transform(self, X) -> np.ndarray:
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        if n < 3:
            raise ValueError("need at least 3 points")
        perp = min(self.perplexity, (n - 1) / 3.0)
        P = _conditional_probs(X, perp)
        Y, kl = self.optimize(P, self.initial_embedding(n))
        self.embedding_ = Y.cpu().numpy()
        self.kl_divergence_ = float(kl)
        return self.embedding_

    fit = fit_transform
