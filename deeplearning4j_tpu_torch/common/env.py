"""Runtime environment flags, read from process env vars.

Counterpart of ``deeplearning4j_tpu/common/env.py`` under the port's own
``DL4J_TORCH_`` prefix, with the JAX package's defaults. Only the flags the
ported slices read are carried over: the kernel kill switch, the force
switch, verbose dispatch logging, the import-graph optimizer's switch, the
async fit loop's window and tail padding, the fault plan's spec, seed and
delay (parsed by ``faults.configure``), and the guardrails switch, which
``fit_batch`` refuses until the guardrails are ported instead of training
without them. The dataset modules read ``DL4J_TORCH_DATA_DIR`` (where the
MNIST / CIFAR / SVHN files are looked for first) themselves.
"""

from __future__ import annotations

import os


def _flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


def _int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v.strip())
    except ValueError:
        return default


class Environment:
    """Process-wide runtime switches."""

    # Every op takes its plain PyTorch lowering, on the card too.
    DISABLE_KERNELS = "DL4J_TORCH_DISABLE_KERNELS"
    # Take a hand-written kernel wherever its ``requires`` holds, ignoring
    # its ``predicate`` (structural requirements are never bypassed).
    FORCE_KERNELS = "DL4J_TORCH_FORCE_KERNELS"
    # Print each op's selected implementation when the choice is made.
    VERBOSE = "DL4J_TORCH_VERBOSE"
    # The import-graph optimizer runs at import (default on; 0 keeps the
    # raw parsed graph).
    IMPORT_OPT = "DL4J_TORCH_IMPORT_OPT"
    # Not ported yet: arming training guardrails.
    GUARDRAILS = "DL4J_TORCH_GUARDRAILS"
    # Fault injection (``faults``): spec "cls:rate[@cond]", its seed and
    # the simulated straggler delay, read by faults.configure()/reset().
    FAULTS = "DL4J_TORCH_FAULTS"
    FAULTS_SEED = "DL4J_TORCH_FAULTS_SEED"
    FAULTS_DELAY_S = "DL4J_TORCH_FAULTS_DELAY_S"
    # Async fit loop (optimize/async_dispatch.py): train steps in flight
    # before fit_batch drains the oldest loss; 0 returns eager floats.
    ASYNC_STEPS = "DL4J_TORCH_ASYNC_STEPS"
    # Pad partial epoch-tail batches up to the pow2 bucket of the largest
    # batch seen (labels mask zeroed: loss-exact); 0 feeds them raw.
    PAD_TAIL = "DL4J_TORCH_PAD_TAIL"

    def __init__(self) -> None:
        self.reload()

    def reload(self) -> None:
        self.disable_kernels = _flag(self.DISABLE_KERNELS)
        self.force_kernels = _flag(self.FORCE_KERNELS)
        self.verbose = _flag(self.VERBOSE)
        self.import_opt = _flag(self.IMPORT_OPT, default=True)
        self.guardrails = _flag(self.GUARDRAILS)
        self.async_steps = max(0, _int(self.ASYNC_STEPS, 2))
        self.pad_tail = _flag(self.PAD_TAIL, default=True)


env = Environment()
