"""Model import: Keras h5 and ``.keras``, TF frozen graphs and SavedModels,
ONNX models.

Counterpart of ``deeplearning4j_tpu/modelimport`` (KerasModelImport,
TFGraphMapper and the ONNX importer, with the import-graph optimizer). The
TF and ONNX frontends share a dependency-free protobuf wire-format reader;
the Keras frontend imports ``h5py`` only where it reads an h5 file.
"""

from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
from deeplearning4j_tpu_torch.modelimport.tensorflow import TFGraphMapper
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxModelImport

__all__ = ["KerasModelImport", "TFGraphMapper", "OnnxModelImport"]
