"""Device-side numeric sentinel for the train step.

Counterpart of ``deeplearning4j_tpu/guardrails/sentinel.py``: the
detection half of the training guardrails. A 4-lane f32 **health word** is
computed on the device inside the step, next to the gradients it judges,
so the host learns a step's health from the same one fetch that already
delivers its loss: the async window screens in-flight steps at drain with
no extra host sync.

Word lanes (``WORD_*``)::

    [ok, gnorm, loss, z]

    ok      1.0 when the step passed every armed screen, else 0.0
    gnorm   pre-clip global L2 gradient norm (f32 accumulation)
    loss    the step's f32 loss (the word replaces the bare loss fetch)
    z       loss z-score against the host-fed EWMA baseline

Control lanes (``CTRL_*``), passed per dispatch by the host policy::

    [clip, gnorm_limit, z_limit, ewma_mean, ewma_var]

    clip        > 0 scales gradients to global norm <= clip (the ladder's
                clip-retry / replay rung); 0 = no clipping
    gnorm_limit > 0 trips when the post-clip norm exceeds it; 0 = off
    z_limit     > 0 trips when z exceeds it; 0 = off
    ewma_mean / ewma_var
                host-side loss EWMA baseline; var < 0 = warmup, z off

The screens run on RAW gradients: clipping scales by ``clip/(gnorm+eps)``
and ``NaN * 0 == NaN``, so a clip can never launder a non-finite gradient
past the finite check. Nothing here reads a value on the host: the word,
the scale and the select stay on the device (no ``if ok:``).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map

WORD_OK, WORD_GNORM, WORD_LOSS, WORD_Z = range(4)
CTRL_CLIP, CTRL_GMAX, CTRL_ZMAX, CTRL_MEAN, CTRL_VAR = range(5)
WORD_LANES = 4
CTRL_LANES = 5


def global_norm(grads) -> torch.Tensor:
    """The global L2 norm of a gradient tree, accumulated in f32 (0-d, on
    the gradients' device); ``nn.multilayer.global_norm_clip`` scales by
    the same number."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(grads)))


def screen(grads, loss, ctrl, with_clip: bool = True):
    """Compute the health word for one step and apply the control clip.

    ``ctrl`` is the f32[5] control tensor on the gradients' device. Returns
    ``(grads, word)``: ``grads`` the (possibly clip-scaled) gradients to
    feed the updaters, ``word`` the f32[4] health word. The caller commits
    or discards the update on the device with :func:`tree_select` on
    ``word[WORD_OK]``.

    ``with_clip=False`` leaves the clip out (the armed-untripped hot path
    dispatches with clip == 0 every step, where a multiply-by-1.0 pass over
    every gradient leaf is pure overhead); the two variants give the same
    bits when clip == 0, so the retry/replay variant interleaves freely
    with the hot one.
    """
    clip, gmax, zmax, mean, var = ctrl.unbind(0)
    gnorm = global_norm(grads)
    loss32 = loss.float()
    z = (loss32 - mean) * torch.rsqrt(var + 1e-12)
    if with_clip:
        scale = torch.where(clip > 0,
                            torch.clamp(clip / (gnorm + 1e-12), max=1.0),
                            torch.ones_like(gnorm))
        gnorm_eff = gnorm * scale
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
    else:
        gnorm_eff = gnorm
    ok = torch.isfinite(loss32) & torch.isfinite(gnorm)
    # 1e-5 relative slack: with gnorm_limit == clipnorm the clipped norm
    # lands exactly ON the limit, and bare f32 `<=` would trip on rounding
    ok = ok & ((gmax <= 0) | (gnorm_eff <= gmax * (1 + 1e-5)))
    ok = ok & ~((zmax > 0) & (var >= 0) & ~(z <= zmax))
    word = torch.stack([ok.float(), gnorm, loss32, z])
    return grads, word


def tree_select(ok, new, old):
    """``torch.where`` over matching trees, leaf by leaf: ``new`` where the
    step is healthy, ``old`` otherwise. ``ok`` is a 0-d bool tensor on the
    device; the discard happens there, so a tripped update never reaches
    params and nothing non-finite can be checkpointed."""
    return tree_map(lambda n, o: torch.where(ok, n, o), new, old)


class SentinelState:
    """Host-side loss EWMA (mean + variance) feeding the z-screen control
    lanes. Updated only with losses from steps that passed their screens,
    so a divergence can't drag its own baseline along with it."""

    def __init__(self, alpha: float = 0.9, warmup: int = 8):
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, loss: float) -> None:
        loss = float(loss)
        if not math.isfinite(loss):
            return
        if self.n == 0:
            self.mean = loss
            self.var = 0.0
        else:
            a = self.alpha
            d = loss - self.mean
            self.mean = a * self.mean + (1 - a) * loss
            self.var = a * self.var + (1 - a) * d * d
        self.n += 1

    def baseline(self) -> "tuple[float, float]":
        """(mean, var) control lanes. Until ``warmup`` clean losses are
        seen, var is -1.0 and the device z screen stays off; afterwards
        var is floored away from zero so a near-constant warmup loss
        can't turn harmless jitter into a trip."""
        if self.n < self.warmup:
            return 0.0, -1.0
        floor = (0.05 * max(1e-3, abs(self.mean))) ** 2
        return self.mean, max(self.var, floor)

    def zscore(self, loss: float) -> float:
        """Host-side z of a loss against the current baseline (the same
        math the device runs); 0.0 during warmup."""
        mean, var = self.baseline()
        if var < 0:
            return 0.0
        return (float(loss) - mean) / math.sqrt(var + 1e-12)
