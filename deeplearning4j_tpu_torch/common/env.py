"""Runtime environment flags, read from process env vars.

Counterpart of ``deeplearning4j_tpu/common/env.py`` under the port's own
``DL4J_TORCH_`` prefix, with the JAX package's defaults. Only the flags the
ported slices read are carried over: the kernel kill switch, the force
switch, verbose dispatch logging, the import-graph optimizer's switch, the
async fit loop's window and tail padding, the fault plan's spec, seed and
delay (parsed by ``faults.configure``), and the observability layer's
switches: monitoring, request tracing and the span tracer's ring, the
flight recorder, the guardrails, the op registry's NaN panic and the
kernel build directory (the JAX package's ``PROFILING`` flag is read by
nothing there, so the port does not carry it). The dataset modules read
``DL4J_TORCH_DATA_DIR`` (where the MNIST / CIFAR / SVHN files are looked
for first) themselves.
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
    # Training guardrails (``guardrails``): 1 arms the numeric sentinel
    # and the policy ladder on every model's fit loop; the DIR variant
    # gives the ladder a rollback checkpoint directory (without it the
    # ladder ends at clip-retry). Unset: the fit path makes no guardrail
    # call.
    GUARDRAILS = "DL4J_TORCH_GUARDRAILS"
    GUARDRAILS_DIR = "DL4J_TORCH_GUARDRAILS_DIR"
    # The monitoring layer (``monitoring``): the metrics registry and the
    # fit loop's, engine's and recovery paths' instruments. Default off:
    # the hot paths then make no registry or tracer call.
    MONITORING = "DL4J_TORCH_MONITORING"
    # Request tracing on engines and gateways built without an explicit
    # trace (``monitoring/context.py``).
    TRACING = "DL4J_TORCH_TRACING"
    # The span tracer's ring capacity: past it the oldest events drop.
    TRACE_MAX_EVENTS = "DL4J_TORCH_TRACE_MAX_EVENTS"
    # The flight recorder (``monitoring/flight.py``): 1 arms the incident
    # ring; DIR is where triggers dump their bundles; CAP its size.
    FLIGHT = "DL4J_TORCH_FLIGHT"
    FLIGHT_DIR = "DL4J_TORCH_FLIGHT_DIR"
    FLIGHT_CAP = "DL4J_TORCH_FLIGHT_CAP"
    # Check every registry op's floating outputs and raise on NaN/Inf,
    # naming the op (a host read an op: a debugging mode).
    NAN_PANIC = "DL4J_TORCH_NAN_PANIC"
    # Where the hand-written kernels' libraries are built and found
    # (``monitoring/compile.py``); unset: ``deeplearning4j_tpu_torch/_build``.
    COMPILE_CACHE = "DL4J_TORCH_COMPILE_CACHE"
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
        self.guardrails_dir = (os.environ.get(self.GUARDRAILS_DIR)
                               or "").strip() or None
        self.monitoring = _flag(self.MONITORING)
        self.tracing = _flag(self.TRACING)
        self.trace_max_events = max(1, _int(self.TRACE_MAX_EVENTS, 100_000))
        self.flight = _flag(self.FLIGHT)
        self.flight_dir = (os.environ.get(self.FLIGHT_DIR)
                           or "").strip() or None
        self.flight_cap = max(1, _int(self.FLIGHT_CAP, 512))
        self.nan_panic = _flag(self.NAN_PANIC)
        self.compile_cache_dir = (os.environ.get(self.COMPILE_CACHE)
                                  or "").strip() or None
        self.async_steps = max(0, _int(self.ASYNC_STEPS, 2))
        self.pad_tail = _flag(self.PAD_TAIL, default=True)


env = Environment()
