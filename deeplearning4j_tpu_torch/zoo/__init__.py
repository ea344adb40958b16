"""Model zoo (counterpart of ``zoo``): the models the port has so far."""

from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.bert import Bert, BertBase
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
from deeplearning4j_tpu_torch.zoo.textgen import (
    BidirectionalGravesLSTMCharRnn, TextGenerationLSTM,
)

__all__ = ["ZooModel", "AlexNet", "Bert", "BertBase", "LeNet", "ResNet50",
           "TextGenerationLSTM", "BidirectionalGravesLSTMCharRnn"]
