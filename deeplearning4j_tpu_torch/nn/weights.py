"""Weight initialization schemes, drawn from a ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: every DL4J WeightInit
name the JAX package takes (XAVIER, XAVIER_UNIFORM, XAVIER_FAN_IN, RELU /
HE, RELU_UNIFORM, LECUN_*, SIGMOID_UNIFORM, UNIFORM, NORMAL, ZERO, ONES,
IDENTITY, DISTRIBUTION, VAR_SCALING_*) with the same scales, and the
serializable ``Distribution`` classes a configuration can name. Fans are
computed from the weight shape the same way (a conv kernel is HWIO:
fan_in = kh*kw*cin, fan_out = kh*kw*cout). Samples come from a CPU
generator, so a seed gives the same weights on every device; they are then
moved to ``device``. The values differ from the JAX package's (threefry is
not torch's generator): weights cross between the packages through the
model zip.
"""

from __future__ import annotations

import math

import torch


def _fans(shape, fan_in=None, fan_out=None):
    if fan_in is not None and fan_out is not None:
        return fan_in, fan_out
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return receptive * shape[-2], receptive * shape[-1]


def _normal(generator, shape, std):
    return torch.randn(shape, generator=generator) * std


def _uniform(generator, shape, a):
    return torch.empty(shape).uniform_(-a, a, generator=generator)


# scheme -> the sampler's law and scale from (fan_in, fan_out)
_SCALED = {
    "xavier": ("normal", lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
    "xavier_uniform": ("uniform", lambda fi, fo: math.sqrt(6.0 / (fi + fo))),
    "xavier_fan_in": ("normal", lambda fi, fo: math.sqrt(1.0 / fi)),
    "relu": ("normal", lambda fi, fo: math.sqrt(2.0 / fi)),
    "relu_uniform": ("uniform", lambda fi, fo: math.sqrt(6.0 / fi)),
    "lecun_normal": ("normal", lambda fi, fo: math.sqrt(1.0 / fi)),
    "lecun_uniform": ("uniform", lambda fi, fo: math.sqrt(3.0 / fi)),
    "sigmoid_uniform": ("uniform",
                        lambda fi, fo: 4.0 * math.sqrt(6.0 / (fi + fo))),
    "uniform": ("uniform", lambda fi, fo: 1.0 / math.sqrt(fi)),
    "normal": ("normal", lambda fi, fo: 1.0 / math.sqrt(fi)),
    "var_scaling_normal_fan_in": ("normal", lambda fi, fo: math.sqrt(1.0 / fi)),
    "var_scaling_normal_fan_out": ("normal",
                                   lambda fi, fo: math.sqrt(1.0 / fo)),
    "var_scaling_normal_fan_avg": ("normal",
                                   lambda fi, fo: math.sqrt(2.0 / (fi + fo))),
    "var_scaling_uniform_fan_in": ("uniform",
                                   lambda fi, fo: math.sqrt(3.0 / fi)),
    "var_scaling_uniform_fan_out": ("uniform",
                                    lambda fi, fo: math.sqrt(3.0 / fo)),
    "var_scaling_uniform_fan_avg": ("uniform",
                                    lambda fi, fo: math.sqrt(6.0 / (fi + fo))),
}
# the other spellings the JAX package accepts
_ALIASES = {
    "xavieruniform": "xavier_uniform", "xavierfanin": "xavier_fan_in",
    "he": "relu", "he_normal": "relu", "henormal": "relu",
    "reluuniform": "relu_uniform", "he_uniform": "relu_uniform",
    "heuniform": "relu_uniform", "lecunnormal": "lecun_normal",
    "lecununiform": "lecun_uniform", "sigmoiduniform": "sigmoid_uniform",
    **{k.replace("_", ""): k for k in _SCALED if k.startswith("var_scaling")},
}


def init_weight(generator: torch.Generator, shape, scheme="xavier", *,
                device="cpu", dtype=torch.float32, fan_in=None, fan_out=None,
                distribution=None):
    """Sample a weight tensor for the named scheme (DL4J WeightInit names)."""
    scheme = str(scheme).lower()
    scheme = _ALIASES.get(scheme, scheme)
    shape = tuple(int(d) for d in shape)
    if scheme in ("zero", "zeros"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme in ("one", "ones"):
        return torch.ones(shape, dtype=dtype, device=device)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-d weight")
        return torch.eye(shape[0], dtype=dtype, device=device)
    if scheme == "distribution":
        if distribution is None:
            raise ValueError("DISTRIBUTION init requires a distribution")
        w = distribution.sample(generator, shape)
    elif scheme in _SCALED:
        law, scale = _SCALED[scheme]
        a = scale(*_fans(shape, fan_in, fan_out))
        w = (_normal if law == "normal" else _uniform)(generator, shape, a)
    else:
        raise ValueError(f"unknown weight init scheme '{scheme}'")
    return w.to(dtype=dtype, device=device)


class Distribution:
    """Serializable sampling distribution
    (org.deeplearning4j.nn.conf.distribution); ``sample`` draws from a
    CPU ``torch.Generator``."""

    def sample(self, generator, shape):  # pragma: no cover - abstract
        raise NotImplementedError

    def to_dict(self):
        d = dict(self.__dict__)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        t = d.pop("@type")
        return {c.__name__: c for c in (NormalDistribution, UniformDistribution,
                                        TruncatedNormalDistribution, ConstantDistribution,
                                        OrthogonalDistribution)}[t](**d)


class NormalDistribution(Distribution):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def sample(self, generator, shape):
        return self.mean + self.std * torch.randn(shape, generator=generator)


class UniformDistribution(Distribution):
    def __init__(self, lower=-1.0, upper=1.0):
        self.lower, self.upper = lower, upper

    def sample(self, generator, shape):
        return torch.empty(shape).uniform_(self.lower, self.upper,
                                           generator=generator)


class TruncatedNormalDistribution(Distribution):
    """mean + std * a standard normal truncated to [-2, 2] (as
    ``jax.random.truncated_normal(key, -2, 2)``), by inverting the CDF."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def sample(self, generator, shape):
        cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))  # noqa: E731
        lo, hi = cdf(-2.0), cdf(2.0)
        u = torch.empty(shape, dtype=torch.float64).uniform_(
            lo, hi, generator=generator)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return self.mean + self.std * z.clamp(-2.0, 2.0).float()


class ConstantDistribution(Distribution):
    def __init__(self, value=0.0):
        self.value = value

    def sample(self, generator, shape):
        return torch.full(shape, float(self.value))


class OrthogonalDistribution(Distribution):
    """gain * a random orthogonal matrix over (prod(shape[:-1]),
    shape[-1]), as ``jax.nn.initializers.orthogonal``: the Q of a normal
    matrix's QR with the signs of R's diagonal folded in."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def sample(self, generator, shape):
        n_rows = math.prod(shape[:-1])
        n_cols = shape[-1]
        a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                        generator=generator, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return self.gain * q.reshape(shape).float()
