"""Loss-function catalog, name-addressable.

Counterpart of ``deeplearning4j_tpu/ops/losses.py``: the same names, the
same formulas and the same reductions. Each loss takes (labels, output,
mask) and returns per-example scores; the reduction to a scalar happens in
the training loop so that masking composes.

All losses take the *activated* output, except that the numerically fused
paths (softmax + cross entropy, sigmoid + binary cross entropy) take logits
when the caller passes ``from_logits=True``.
"""

from __future__ import annotations

from typing import Callable

import torch

_EPS = 1e-7


def _reduce(per_elem, mask):
    """Sum over output dims -> per-example score; apply mask if given."""
    score = per_elem.reshape(per_elem.shape[0], -1).sum(-1)
    if mask is not None:
        score = score * mask.reshape(mask.shape[0], -1).squeeze()
    return score


def _logp(output, from_logits):
    """Shared stable log-probability path (mcxent / sparse_mcxent)."""
    if from_logits:
        return torch.log_softmax(output, dim=-1)
    return torch.log(torch.clamp(output, _EPS, 1.0))


def _fold_mask(per, mask):
    """Fold a same-rank mask into the per-element scores; return the
    (possibly consumed) mask for _reduce."""
    if mask is not None and mask.dim() == per.dim():
        return per * mask, None
    return per, mask


def mcxent(labels, output, mask=None, from_logits=False):
    """Multi-class cross entropy (DL4J MCXENT / NEGATIVELOGLIKELIHOOD)."""
    per, mask = _fold_mask(-(labels * _logp(output, from_logits)), mask)
    return _reduce(per, mask)


def sparse_mcxent(labels, output, mask=None, from_logits=False):
    """Integer-label cross entropy: ``labels`` are class indices (the
    output's shape minus the class axis, or with a trailing 1). Indices out
    of range are clamped to the nearest class."""
    logp = _logp(output, from_logits)
    labels = torch.as_tensor(labels, device=logp.device).long()
    if labels.dim() == logp.dim():
        if labels.shape[-1] != 1:
            raise ValueError(
                f"sparse_mcxent takes class INDICES (trailing dim 1 or "
                f"absent); got labels {tuple(labels.shape)} against output "
                f"{tuple(output.shape)}; one-hot labels belong to "
                f"loss='mcxent'")
        labels = labels[..., 0]
    idx = labels.clamp(0, logp.shape[-1] - 1)[..., None]
    per = -torch.take_along_dim(logp, idx, dim=-1)[..., 0]
    per, mask = _fold_mask(per, mask)
    return _reduce(per, mask)


def xent(labels, output, mask=None, from_logits=False):
    """Binary cross entropy (DL4J XENT)."""
    if from_logits:
        per = (torch.clamp(output, min=0) - output * labels
               + torch.log1p(torch.exp(-output.abs())))
    else:
        p = torch.clamp(output, _EPS, 1.0 - _EPS)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _reduce(per, mask)


def mse(labels, output, mask=None, **_):
    d = output - labels
    # DL4J MSE averages over the output dimension (LossMSE = LossL2 / nOut)
    return _reduce(d * d, mask) / output.shape[-1]


def l2(labels, output, mask=None, **_):
    d = output - labels
    return _reduce(d * d, mask)


def mae(labels, output, mask=None, **_):
    return _reduce((output - labels).abs(), mask) / output.shape[-1]


def l1(labels, output, mask=None, **_):
    return _reduce((output - labels).abs(), mask)


def hinge(labels, output, mask=None, **_):
    # labels in {-1, +1} (DL4J LossHinge)
    return _reduce(torch.clamp(1.0 - labels * output, min=0.0), mask)


def squared_hinge(labels, output, mask=None, **_):
    h = torch.clamp(1.0 - labels * output, min=0.0)
    return _reduce(h * h, mask)


def kld(labels, output, mask=None, **_):
    y = torch.clamp(labels, _EPS, 1.0)
    p = torch.clamp(output, _EPS, 1.0)
    return _reduce(y * (torch.log(y) - torch.log(p)), mask)


def poisson(labels, output, mask=None, **_):
    return _reduce(output - labels * torch.log(torch.clamp(output, min=_EPS)),
                   mask)


def cosine_proximity(labels, output, mask=None, **_):
    norm = lambda a: torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    yn = labels / (norm(labels) + _EPS)
    pn = output / (norm(output) + _EPS)
    return _reduce(-(yn * pn), mask)


def mape(labels, output, mask=None, **_):
    per = ((labels - output) / torch.clamp(labels.abs(), min=_EPS)).abs() * 100.0
    return _reduce(per, mask) / output.shape[-1]


def msle(labels, output, mask=None, **_):
    d = (torch.log1p(torch.clamp(output, min=_EPS - 1))
         - torch.log1p(torch.clamp(labels, min=_EPS - 1)))
    return _reduce(d * d, mask) / output.shape[-1]


LOSSES: dict[str, Callable] = {
    "mcxent": mcxent,
    "negativeloglikelihood": mcxent,
    "sparsemcxent": sparse_mcxent,
    "xent": xent,
    "mse": mse,
    "l2": l2,
    "l1": l1,
    "mae": mae,
    "hinge": hinge,
    "squaredhinge": squared_hinge,
    "kldivergence": kld,
    "kld": kld,
    "poisson": poisson,
    "cosineproximity": cosine_proximity,
    "meanabsolutepercentageerror": mape,
    "mape": mape,
    "meansquaredlogarithmicerror": msle,
    "msle": msle,
}


def get_loss(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("_", "")
    if key not in LOSSES:
        raise ValueError(f"unknown loss '{name_or_fn}'; known: {sorted(LOSSES)}")
    return LOSSES[key]
