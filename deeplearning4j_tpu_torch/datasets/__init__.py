"""Data pipeline: DataSet, iterators, normalizers, fetchers.

Counterpart of ``deeplearning4j_tpu/datasets``. Batches are host numpy
until a network (or the prefetching iterator) moves them to its device;
the synthetic MNIST and CIFAR stand-ins come from numpy with the JAX
package's seeds, so their arrays are the same bytes.
"""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator, ListDataSetIterator, ArrayDataSetIterator, AsyncPrefetchIterator,
)
from deeplearning4j_tpu_torch.datasets.normalizers import (
    NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler,
)
from deeplearning4j_tpu_torch.datasets.mnist import EmnistDataSetIterator, MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets.cifar import Cifar10DataSetIterator, SvhnDataSetIterator
from deeplearning4j_tpu_torch.datasets.real import (DigitsDataSetIterator,
                                                    TabularDataSetIterator)

__all__ = [
    "DataSet", "MultiDataSet", "DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator",
    "AsyncPrefetchIterator", "NormalizerStandardize", "NormalizerMinMaxScaler",
    "ImagePreProcessingScaler", "MnistDataSetIterator",
    "EmnistDataSetIterator", "Cifar10DataSetIterator", "SvhnDataSetIterator",
    "DigitsDataSetIterator", "TabularDataSetIterator",
]
