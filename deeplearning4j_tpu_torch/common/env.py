"""Runtime environment flags, read from process env vars.

Counterpart of ``deeplearning4j_tpu/common/env.py`` under the port's own
``DL4J_TORCH_`` prefix. Only the flags the ported slice reads are carried
over: the kernel kill switch, the force switch, verbose dispatch logging
and the import-graph optimizer's switch; and the switches of training features the port has not taken over
yet (guardrails, fault plans), so that ``fit_batch`` refuses them instead of
training without them.
"""

from __future__ import annotations

import os


def _flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


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
    # Not ported yet: arming training guardrails, installing a fault plan.
    GUARDRAILS = "DL4J_TORCH_GUARDRAILS"
    FAULTS = "DL4J_TORCH_FAULTS"

    def __init__(self) -> None:
        self.reload()

    def reload(self) -> None:
        self.disable_kernels = _flag(self.DISABLE_KERNELS)
        self.force_kernels = _flag(self.FORCE_KERNELS)
        self.verbose = _flag(self.VERBOSE)
        self.import_opt = _flag(self.IMPORT_OPT, default=True)
        self.guardrails = _flag(self.GUARDRAILS)
        self.faults = os.environ.get(self.FAULTS, "").strip()


env = Environment()
