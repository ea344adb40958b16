"""Seeded RNG utilities.

Counterpart of ``deeplearning4j_tpu/ops/rng.py``: a stateful holder with
DL4J's ergonomics (``Nd4j.getRandom().setSeed``) for imperative call
sites. The JAX holder splits a threefry key; this one keeps a host
``torch.Generator`` as its key stream, and ``split()`` draws a 63-bit seed
from it for a fresh ``torch.Generator`` on the holder's device, so one
seed gives one sequence of draws. The numbers are torch's, not
threefry's: the two packages agree on seeding determinism and on the
distributions, not on values.

The holder's device defaults to the card, as the port's entry points do;
pass ``device="cpu"`` to draw on the host. The device is resolved at the
first draw, so building the default holder needs no card.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device

_SEED_BOUND = 2 ** 63 - 1


class RandomProvider:
    """Stateful seed holder; ``split()`` hands out fresh generators."""

    def __init__(self, seed: int = 0, device: DeviceLike = "cuda"):
        self._device_like = device
        self._device = None
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        self._seed = int(seed)
        self._stream = torch.Generator().manual_seed(self._seed)

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(self._device_like)
        return self._device

    def split(self, n: int = 1):
        """One new generator on the holder's device (``n`` == 1) or a list
        of ``n``; each draw of the key stream seeds one."""
        seeds = torch.randint(0, _SEED_BOUND, (n,), generator=self._stream)
        gens = [torch.Generator(device=self.device).manual_seed(int(s))
                for s in seeds]
        return gens[0] if n == 1 else gens

    # samplers mirroring Nd4j.rand / Nd4j.randn
    def uniform(self, shape, minval=0.0, maxval=1.0, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=self.split(), dtype=dtype,
                       device=self.device)
        return u * (maxval - minval) + minval

    def normal(self, shape, dtype=torch.float32):
        return torch.randn(tuple(shape), generator=self.split(), dtype=dtype,
                           device=self.device)

    def bernoulli(self, p, shape):
        """Boolean draws, true with probability ``p``."""
        return torch.rand(tuple(shape), generator=self.split(),
                          device=self.device) < p


_default = RandomProvider(0)


def get_random() -> RandomProvider:
    """Nd4j.getRandom() analog."""
    return _default
