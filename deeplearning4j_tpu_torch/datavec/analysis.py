"""Data analysis — per-column statistics over a dataset.

Counterpart of ``deeplearning4j_tpu/datavec/analysis.py``, copied (host
Python).

Reference analog: org.datavec.local.transforms.AnalyzeLocal.analyze ->
org.datavec.api.transform.analysis.DataAnalysis (NumericalColumnAnalysis,
CategoricalAnalysis, StringAnalysis). Used to drive normalization ranges
and sanity-check ETL, same as the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.conditions import sample_stdev, try_float
from deeplearning4j_tpu_torch.datavec.schema import ColumnType, Schema


@dataclasses.dataclass
class NumericalColumnAnalysis:
    count: int
    count_invalid: int
    min: float
    max: float
    mean: float
    stdev: float

    def __repr__(self):
        return (f"numeric(count={self.count}, invalid={self.count_invalid}, "
                f"min={self.min:.6g}, max={self.max:.6g}, "
                f"mean={self.mean:.6g}, stdev={self.stdev:.6g})")


@dataclasses.dataclass
class CategoricalColumnAnalysis:
    count: int
    counts: Dict[str, int]  # category -> occurrences

    def __repr__(self):
        return f"categorical(count={self.count}, counts={self.counts})"


@dataclasses.dataclass
class StringColumnAnalysis:
    count: int
    count_unique: int
    min_length: int
    max_length: int
    mean_length: float

    def __repr__(self):
        return (f"string(count={self.count}, unique={self.count_unique}, "
                f"len=[{self.min_length},{self.max_length}], "
                f"mean_len={self.mean_length:.3g})")


class DataAnalysis:
    def __init__(self, schema: Schema, analyses: Dict[str, object]):
        self.schema = schema
        self._analyses = analyses

    def column_analysis(self, name: str):
        return self._analyses[name]

    def __repr__(self):
        lines = ["DataAnalysis:"]
        for c in self.schema.columns:
            lines.append(f"  {c.name}: {self._analyses[c.name]!r}")
        return "\n".join(lines)


def _numeric(values: list) -> NumericalColumnAnalysis:
    parsed = [try_float(v) for v in values]
    nums = [f for f in parsed if f is not None]
    invalid = len(parsed) - len(nums)
    if not nums:
        return NumericalColumnAnalysis(0, invalid, math.nan, math.nan,
                                       math.nan, math.nan)
    return NumericalColumnAnalysis(len(nums), invalid, min(nums), max(nums),
                                   sum(nums) / len(nums), sample_stdev(nums))


def analyze(schema: Schema, records: Sequence[list],
            sequences: bool = False) -> DataAnalysis:
    """AnalyzeLocal.analyze analog. ``records`` may be flat records or (with
    ``sequences=True``) a list of sequences, which are flattened first."""
    if sequences:
        records = [r for seq in records for r in seq]
    analyses = {}
    for i, c in enumerate(schema.columns):
        values = [r[i] for r in records]
        if c.type in (ColumnType.INTEGER, ColumnType.DOUBLE, ColumnType.TIME):
            analyses[c.name] = _numeric(values)
        elif c.type == ColumnType.CATEGORICAL:
            counts: Dict[str, int] = {}
            for v in values:
                counts[v] = counts.get(v, 0) + 1
            analyses[c.name] = CategoricalColumnAnalysis(len(values), counts)
        else:
            lens = [len(str(v)) for v in values]
            analyses[c.name] = StringColumnAnalysis(
                len(values), len(set(map(str, values))),
                min(lens) if lens else 0, max(lens) if lens else 0,
                sum(lens) / len(lens) if lens else 0.0)
    return DataAnalysis(schema, analyses)
