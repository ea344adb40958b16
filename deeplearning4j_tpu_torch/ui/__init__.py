"""Training UI / stats subsystem.

Counterpart of ``deeplearning4j_tpu/ui/``: storage and server copied, the
listener reading the port's parameter trees (one device-to-host copy a
sampled iteration).

Reference analog: deeplearning4j-ui-parent — StatsListener -> StatsStorage
(mapdb-backed FileStatsStorage / InMemoryStatsStorage) -> UIServer web
dashboard (SURVEY.md §5 "Metrics/observability"). Rendering is a
dependency-free HTML report with inline SVG charts plus CSV scalar export
(TensorBoard-compatible layout), served by a stdlib http server.
"""

from deeplearning4j_tpu_torch.ui.storage import FileStatsStorage, InMemoryStatsStorage
from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.server import UIServer, render_report

__all__ = ["StatsListener", "InMemoryStatsStorage", "FileStatsStorage",
           "UIServer", "render_report"]
