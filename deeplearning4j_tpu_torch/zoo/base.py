"""ZooModel base.

Counterpart of ``deeplearning4j_tpu/zoo/base.py``: ``init()`` builds an
untrained model, ``init_pretrained()`` restores weights from a local zip.
Both run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.common.device import DeviceLike


@dataclasses.dataclass
class ZooModel:
    seed: int = 123

    def conf(self):
        raise NotImplementedError

    def init(self, device: DeviceLike = "cuda"):
        """Build + initialize the untrained model (ZooModel.init): a
        ComputationGraph for a graph configuration, else a
        MultiLayerNetwork."""
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        c = self.conf()
        model = (ComputationGraph if isinstance(c, ComputationGraphConfiguration)
                 else MultiLayerNetwork)
        return model(c).init(self.seed, device=device)

    def init_pretrained(self, checkpoint_path: str,
                        device: DeviceLike = "cuda"):
        """Restore weights from a model zip written by either package."""
        from deeplearning4j_tpu_torch.util.serialization import restore_model

        return restore_model(checkpoint_path, device=device)
