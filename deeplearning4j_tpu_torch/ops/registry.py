"""Op registry with per-call implementation selection.

Counterpart of ``deeplearning4j_tpu/ops/registry.py``, keeping the same seam:
each named op has

- exactly one ``plain`` implementation: an always-correct PyTorch lowering
  that runs on any device, and
- zero or more hand-written kernels (``cuda``), each with ``requires``
  (structural: the kernel can compute this call at all; never bypassed) and
  ``predicate`` (a speed heuristic; ``DL4J_TORCH_FORCE_KERNELS`` bypasses
  it), plus a ``priority`` among applicable kernels.

Selection also keys on the device: a CPU tensor takes the plain lowering; a
CUDA tensor takes the highest-priority kernel whose ``requires`` (and
``predicate``) holds. No TPU threshold is carried over: a kernel's predicate
on this card is a measured decision, and until one is measured a kernel has
none. ``DL4J_TORCH_DISABLE_KERNELS`` sends every call to the plain lowering.

The JAX registry chooses once, at trace time. PyTorch runs eagerly, so the
port chooses on every call and caches the choice per (op, device type
and index, dtypes, shapes, contiguity, whether autograd will need
gradients, flags) to keep the predicates off the hot path: a kernel's
``requires`` may depend on all of them (the recurrent kernels' backward
has its own limit on H). The
cache is a bounded LRU (``CHOICE_CACHE_SIZE`` entries an op): the choice is
a function of the key alone, so an evicted key is chosen again the same
way, and a server that sees a new shape per prompt length holds memory
flat. The cache is shared by every thread that runs ops (a server's
inference workers and its engine's step loop), so each op guards it
with a lock. ``DL4J_TORCH_NAN_PANIC`` checks every op's floating outputs and
raises ``FloatingPointError`` naming the op on a NaN or Inf (the JAX
registry's panic mode; a host read an op).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from deeplearning4j_tpu_torch.common.env import env

PLAIN = "plain"
# selection-cache entries kept per op (least recently used evicted first)
CHOICE_CACHE_SIZE = 256


@dataclasses.dataclass
class OpImpl:
    name: str
    platform: str  # "plain" | "cuda"
    fn: Callable[..., Any]
    predicate: Optional[Callable[..., bool]] = None  # speed heuristic
    requires: Optional[Callable[..., bool]] = None   # structural, always enforced
    priority: int = 0  # higher wins among applicable kernels

    def supported(self, *args, **kwargs) -> bool:
        """Structural applicability: the kernel computes this call right."""
        return self.requires is None or bool(self.requires(*args, **kwargs))

    def applicable(self, *args, **kwargs) -> bool:
        return self.supported(*args, **kwargs) and (
            self.predicate is None or bool(self.predicate(*args, **kwargs)))


def _device_key(device: torch.device):
    """(type, index) of a device: a plan chosen for one card is never
    reused for another (the grid kernels' plans depend on the card)."""
    return (device.type, device.index)


def _signature(a):
    """Hashable description of one argument for the selection cache."""
    if isinstance(a, torch.Tensor):
        return ("T", _device_key(a.device), a.dtype, tuple(a.shape),
                a.is_contiguous(), a.requires_grad)
    if isinstance(a, torch.device):
        return ("D",) + _device_key(a)
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    if isinstance(a, (tuple, list)):
        return tuple(_signature(v) for v in a)
    return ("obj", type(a).__qualname__)


def _device_type(args, kwargs) -> str:
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device.type
    return "cpu"


class _Op:
    """A named op: holds its implementations and picks one per call."""

    def __init__(self, name: str):
        self.name = name
        self.impls: list[OpImpl] = []
        self._choices: collections.OrderedDict = collections.OrderedDict()
        # serving threads (inference workers, the engine's step loop)
        # select concurrently: the lookup, insert, eviction and reorder
        # of the LRU happen under this lock, so no thread's reorder meets
        # a key another thread just evicted
        self._lock = threading.Lock()

    @property
    def plain(self) -> OpImpl:
        for impl in self.impls:
            if impl.platform == PLAIN:
                return impl
        raise KeyError(f"op '{self.name}' has no plain implementation")

    def _choose(self, args, kwargs) -> OpImpl:
        if env.disable_kernels or _device_type(args, kwargs) != "cuda":
            return self.plain
        ok = [i for i in self.impls if i.platform != PLAIN
              and (i.supported(*args, **kwargs) if env.force_kernels
                   else i.applicable(*args, **kwargs))]
        return max(ok, key=lambda i: i.priority) if ok else self.plain

    def select(self, *args, **kwargs) -> OpImpl:
        key = (env.disable_kernels, env.force_kernels,
               torch.is_grad_enabled(), _signature(args),
               _signature(tuple(sorted(kwargs.items()))))
        with self._lock:
            impl = self._choices.get(key)
            if impl is not None:
                self._choices.move_to_end(key)
                return impl
        impl = self._choose(args, kwargs)
        with self._lock:
            self._choices[key] = impl
            if len(self._choices) > CHOICE_CACHE_SIZE:
                self._choices.popitem(last=False)
        if env.verbose:
            print(f"[dl4j-torch] op {self.name} -> {impl.platform} "
                  f"for {key[3]}")
        return impl

    def __call__(self, *args, **kwargs):
        out = self.select(*args, **kwargs).fn(*args, **kwargs)
        if env.nan_panic:
            _nan_check(self.name, out)
        return out


def _nan_check(name: str, out) -> None:
    """Raise FloatingPointError if a floating tensor of ``out`` (nested
    tuples and lists) holds a NaN or an Inf."""
    if isinstance(out, (tuple, list)):
        for o in out:
            _nan_check(name, o)
    elif (isinstance(out, torch.Tensor) and out.is_floating_point()
          and not bool(torch.isfinite(out).all())):
        raise FloatingPointError(f"NaN/Inf in op {name}")


_REGISTRY: dict[str, _Op] = {}


def get_op(name: str) -> _Op:
    if name not in _REGISTRY:
        _REGISTRY[name] = _Op(name)
    return _REGISTRY[name]


def register_op(name: str):
    """Decorator: register ``fn`` as the plain PyTorch lowering of ``name``."""

    def deco(fn):
        get_op(name).impls.append(OpImpl(name=name, platform=PLAIN, fn=fn))
        return fn

    return deco


def register_impl(name: str, platform: str = "cuda", predicate=None,
                  requires=None, priority: int = 1):
    """Decorator: register a hand-written kernel implementation of ``name``.
    It is considered for CUDA tensors only."""

    def deco(fn):
        get_op(name).impls.append(
            OpImpl(name=name, platform=platform, fn=fn, predicate=predicate,
                   requires=requires, priority=priority))
        return fn

    return deco


def op(name: str) -> _Op:
    """Callable handle for a named op (selection at each call)."""
    return get_op(name)
