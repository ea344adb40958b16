"""Seeded token samplers for autoregressive decode.

Counterpart of ``deeplearning4j_tpu/generation/sampler.py``. Knobs are per
row: temperature <= 0 means greedy (argmax), top_k <= 0 and top_p >= 1
disable their filters; top-k keeps every value tied with the k-th, and top-p
keeps the smallest probability-sorted prefix whose mass reaches p.

Determinism: each sampled row draws its one uniform number from a seed
derived from (request seed, absolute position), and every operation works
on one row at a time, so a token is a pure function of the seed, the
position and the logits, whatever slot the request sits in and whatever it
is batched with. The streams differ from the JAX package's threefry keys,
so tokens match across the packages for greedy decoding only.

The engine samples on the host, in one vectorised numpy pass over the
rows: it copies the step's logits once (2.4 KB at 8 slots and vocabulary
77; it needs the tokens on the host anyway, to stream them). Greedy rows
take the row's argmax; sampled rows invert the CDF of their filtered
distribution at their uniform. The same pass in torch on the card costs
about twenty eager launches a step, more host time than this (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def row_seed(seed: int, pos: int) -> int:
    """Generator seed for one (request seed, position): splitmix64 of the
    pair, so neighbouring positions get unrelated streams."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFF_FFFF_FFFF_FFFF


def row_uniform(seed: int, pos: int) -> float:
    """The row's draw in [0, 1): the top 53 bits of its 63-bit seed."""
    return (row_seed(seed, pos) >> 10) * 2.0 ** -53


def sample_batch(logits: np.ndarray, u, temperature, top_k,
                 top_p) -> np.ndarray:
    """Tokens [B] for float32 logits [B, V]; the knobs and the uniforms
    ``u`` are [B] arrays."""
    B, V = logits.shape
    rows = np.arange(B)
    temperature = np.asarray(temperature, np.float32)
    greedy = temperature <= 0.0
    temp = np.maximum(np.where(greedy, np.float32(1), temperature),
                      np.float32(1e-6))
    scaled = logits / temp[:, None]
    desc = -np.sort(-scaled, axis=-1)
    top_k = np.asarray(top_k, np.int64)
    k = np.where(top_k > 0, np.minimum(top_k, V), V)
    keep = scaled >= desc[rows, k - 1][:, None]
    masked = np.where(keep, scaled, -np.inf)
    e = np.exp(masked - masked.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    pdesc = -np.sort(-probs, axis=-1)
    csum = np.cumsum(pdesc, axis=-1)
    p = np.minimum(np.asarray(top_p, np.float32), 1.0)
    n_keep = np.maximum(((csum - pdesc) < p[:, None]).sum(axis=-1), 1)
    keep &= probs >= pdesc[rows, n_keep - 1][:, None]
    cdf = np.cumsum(np.where(keep, probs, 0.0), axis=-1, dtype=np.float64)
    target = np.asarray(u, np.float64) * cdf[:, -1]
    drawn = np.minimum((cdf <= target[:, None]).sum(axis=-1), V - 1)
    return np.where(greedy, logits.argmax(axis=-1), drawn).astype(np.int64)


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.detach().to("cpu", torch.float32).numpy()


def sample_row(logits: torch.Tensor, *, seed: int, pos: int,
               temperature: float, top_k: int, top_p: float) -> int:
    """One token from one row of logits [V]."""
    return int(sample_batch(_host(logits)[None], [row_uniform(seed, pos)],
                            [temperature], [top_k], [top_p])[0])


def sample_logits(logits: torch.Tensor, *, seeds, pos, temperature, top_k,
                  top_p, rows=None) -> np.ndarray:
    """One token per row of logits [B, V]; knobs are [B] arrays. Only
    ``rows`` are sampled (all by default); the others stay 0."""
    B = logits.shape[0]
    rows = np.arange(B) if rows is None else np.asarray(rows, np.int64)
    out = np.zeros((B,), np.int64)
    if rows.size == 0:
        return out
    u = [row_uniform(seeds[r], pos[r]) for r in rows]
    out[rows] = sample_batch(
        _host(logits)[rows], u, np.asarray(temperature)[rows],
        np.asarray(top_k)[rows], np.asarray(top_p)[rows])
    return out
