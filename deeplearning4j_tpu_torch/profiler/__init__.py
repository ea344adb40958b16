"""Profiling, tracing and the NaN panic.

Counterpart of ``deeplearning4j_tpu/profiler/``: the OpProfiler-style
aggregation of timed sections (ND4J OpProfiler), a numerics check over
parameter trees that names the bad leaf, the NaN panic, and the device
timeline, here from ``torch.profiler`` (a Chrome trace).
"""

from deeplearning4j_tpu_torch.profiler.profiler import (
    OpProfiler, ProfilerConfig, check_numerics, nan_panic, trace,
)

__all__ = ["OpProfiler", "ProfilerConfig", "check_numerics", "nan_panic",
           "trace"]
