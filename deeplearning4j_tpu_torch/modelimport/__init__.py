"""Model import: TF frozen graphs and SavedModels, ONNX models.

Counterpart of ``deeplearning4j_tpu/modelimport`` (TFGraphMapper and the
ONNX importer, with the import-graph optimizer). The TF and ONNX frontends
share a dependency-free protobuf wire-format reader. Keras import waits for
the layers it maps onto (ROADMAP A3).
"""

from deeplearning4j_tpu_torch.modelimport.tensorflow import TFGraphMapper
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxModelImport

__all__ = ["TFGraphMapper", "OnnxModelImport"]
