"""Network configuration: input types, preprocessors, builders."""

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["InputType"]
