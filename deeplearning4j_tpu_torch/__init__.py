"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of the JAX package.

The module paths mirror the JAX package (``deeplearning4j_tpu``), so each
module's counterpart sits at the same relative path. The port imports torch,
numpy and the standard library only: never jax, and nothing of the JAX
package.

Every entry point runs on the card unless the caller passes
``device="cpu"``; with no card present it raises instead of falling back.
Kernels written by hand for Hopper live under ``csrc/`` and are built by
``nvcc`` at first use (``ops/cuda/build.py``), never at import.
"""

__version__ = "0.1.0"
