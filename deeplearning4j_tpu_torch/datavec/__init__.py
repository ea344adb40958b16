"""DataVec-equivalent ETL.

Counterpart of ``deeplearning4j_tpu/datavec/``, copied: host Python and
numpy, with the same records, schemas, transform JSON and batches as the
JAX package's. A network's ``fit_batch`` moves a finished batch to its
device.

Reference analog: the `datavec/` module family (SURVEY.md §1 L3) —
RecordReader implementations (org.datavec.api.records.reader.impl.*),
Schema + TransformProcess + conditions/reducers/joins/analysis
(org.datavec.api.transform.**) and the local executor. ETL stays
host-side numpy (the device only sees ready batches).
"""

from deeplearning4j_tpu_torch.datavec.schema import ColumnType, Schema
from deeplearning4j_tpu_torch.datavec.records import (
    CollectionRecordReader, CSVRecordReader, CSVSequenceRecordReader,
    ImageRecordReader, LineRecordReader, RecordReader,
)
from deeplearning4j_tpu_torch.datavec.conditions import (
    BooleanCondition, ColumnCondition, Condition, equal_to, greater_than,
    in_set, is_invalid, less_than,
)
from deeplearning4j_tpu_torch.datavec.transform import TransformProcess
from deeplearning4j_tpu_torch.datavec.reduce import Reducer
from deeplearning4j_tpu_torch.datavec.join import Join
from deeplearning4j_tpu_torch.datavec.analysis import DataAnalysis, analyze
from deeplearning4j_tpu_torch.datavec.iterators import (
    RecordReaderDataSetIterator, SequenceRecordReaderDataSetIterator,
)

__all__ = [
    "ColumnType", "Schema", "RecordReader", "CSVRecordReader",
    "CSVSequenceRecordReader", "LineRecordReader", "CollectionRecordReader",
    "ImageRecordReader", "TransformProcess", "RecordReaderDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
    "Condition", "ColumnCondition", "BooleanCondition",
    "less_than", "greater_than", "equal_to", "in_set", "is_invalid",
    "Reducer", "Join", "DataAnalysis", "analyze",
]
