"""Compile-time observability and the kernel build directory.

Counterpart of ``deeplearning4j_tpu/monitoring/compile.py``. The JAX
package bridges ``jax.monitoring``'s XLA compile events into the registry
and points XLA's persistent compilation cache at a directory. The port
has one kind of compiled artefact: the nvcc libraries of the hand-written
kernels, which ``ops/cuda/build.py`` (``CudaLibrary.build``) writes into a
build directory, named by a hash of the source, the headers and the
flags. So:

- every build lands in ``dl4j_compiles_total`` and ``dl4j_compile_seconds``
  (:func:`record_build`, from the ``build_seconds`` the build measures);
- every library load that finds its hashed build already on disk is
  ``dl4j_compile_cache_events_total{kind="hit"}``, every build
  ``kind="miss"`` (:func:`record_cache`);
- :func:`configure_compile_cache` (or ``DL4J_TORCH_COMPILE_CACHE``)
  chooses the build directory, so a warm process start on a persistent
  directory builds nothing; ``deeplearning4j_tpu_torch/_build`` stays the
  default.

CUDA-graph captures are not compiles: they keep the engine's own counters
(``GenerationEngine.captures``). With monitoring off the hooks record
nothing (one None check at each build or load).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

_configured_dir: Optional[str] = None


def record_build(seconds: float) -> None:
    """One library built by nvcc in ``seconds`` (a cache miss)."""
    from deeplearning4j_tpu_torch import monitoring

    mon = monitoring.compile_monitor()
    if mon is None:
        return
    mon.compiles.inc()
    mon.compile_seconds.observe(seconds)
    mon.cache_events.labels(kind="miss").inc()


def record_cache(kind: str) -> None:
    """One build-directory probe: ``"hit"`` (the library was there)."""
    from deeplearning4j_tpu_torch import monitoring

    mon = monitoring.compile_monitor()
    if mon is not None:
        mon.cache_events.labels(kind=kind).inc()


def configure_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load the kernels' libraries under ``path`` (default: the
    ``DL4J_TORCH_COMPILE_CACHE`` variable). Returns the directory in
    effect, or None when neither is set (the default directory stays)."""
    from deeplearning4j_tpu_torch.common.env import env
    from deeplearning4j_tpu_torch.ops.cuda import build

    global _configured_dir
    path = path or env.compile_cache_dir
    if not path:
        return None
    build.BUILD_DIR = Path(path)
    _configured_dir = str(path)
    return _configured_dir


def configured_cache_dir() -> Optional[str]:
    return _configured_dir
