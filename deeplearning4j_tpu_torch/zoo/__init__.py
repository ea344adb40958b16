"""Model zoo (counterpart of ``zoo``): the models this slice serves."""

from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.textgen import TextGenerationLSTM

__all__ = ["ZooModel", "TextGenerationLSTM"]
