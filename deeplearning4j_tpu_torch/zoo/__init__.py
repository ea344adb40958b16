"""Model zoo (counterpart of ``deeplearning4j_tpu/zoo``): every model of
its ``__all__``. ``init()`` builds on the card unless ``device="cpu"``."""

from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.bert import Bert, BertBase
from deeplearning4j_tpu_torch.zoo.darknet import Darknet19, TinyYOLO, YOLO2
from deeplearning4j_tpu_torch.zoo.inception_resnet import InceptionResNetV1
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.nasnet import NASNet
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
from deeplearning4j_tpu_torch.zoo.simplecnn import SimpleCNN
from deeplearning4j_tpu_torch.zoo.squeezenet import SqueezeNet
from deeplearning4j_tpu_torch.zoo.textgen import (
    BidirectionalGravesLSTMCharRnn, TextGenerationLSTM,
)
from deeplearning4j_tpu_torch.zoo.unet import UNet
from deeplearning4j_tpu_torch.zoo.vgg import VGG16, VGG19
from deeplearning4j_tpu_torch.zoo.xception import Xception

__all__ = [
    "ZooModel", "LeNet", "AlexNet", "SimpleCNN", "VGG16", "VGG19", "ResNet50",
    "Darknet19", "TinyYOLO", "YOLO2", "SqueezeNet", "Xception", "UNet",
    "InceptionResNetV1", "NASNet",
    "TextGenerationLSTM", "BidirectionalGravesLSTMCharRnn", "Bert", "BertBase",
]
