"""Host and device system metrics for the monitoring path.

Counterpart of ``deeplearning4j_tpu/common/sysmetrics.py``: host RSS (the
JVM-heap analog of the reference's StatsListener) and device memory. The
JAX package reads PJRT's ``memory_stats()``; the port reads PyTorch's
caching allocator for the card (``torch.cuda.memory_allocated``,
``max_memory_allocated``) and the card's total memory, under the JAX
package's keys. A CPU device reports no device memory, as the JAX
package's CPU backend does.
"""

from __future__ import annotations

from typing import Dict


def host_rss_mb() -> float:
    """Resident set size of this process in MiB (from /proc/self/statm;
    falls back to resource.getrusage off-Linux)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os

        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except Exception:
        try:
            import resource
            import sys

            # peak (not current) RSS; ru_maxrss is KiB on Linux, bytes on
            # macOS — and this branch only runs where /proc is absent
            div = (1 << 20) if sys.platform == "darwin" else 1024
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / div
        except Exception:
            return 0.0


def device_memory_mb(device=None) -> Dict[str, float]:
    """{'device_mem_in_use_mb', 'device_mem_peak_mb', 'device_mem_limit_mb'}
    of a card (``device``: a ``torch.device``, an index or None for the
    current card); {} for a CPU device or where there is no card."""
    try:
        import torch

        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                return {}
        elif not torch.cuda.is_available():
            return {}
        mib = float(1 << 20)
        return {
            "device_mem_in_use_mb": torch.cuda.memory_allocated(device) / mib,
            "device_mem_peak_mb": torch.cuda.max_memory_allocated(device) / mib,
            "device_mem_limit_mb": torch.cuda.get_device_properties(
                device if device is not None
                else torch.cuda.current_device()).total_memory / mib,
        }
    except Exception:
        return {}


def system_metrics(device=None) -> Dict[str, float]:
    """All system scalar series for the listener path."""
    out = {"host_rss_mb": host_rss_mb()}
    out.update(device_memory_mb(device))
    return out
