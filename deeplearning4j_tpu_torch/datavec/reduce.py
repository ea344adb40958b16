"""Reducer — group-by aggregation over records.

Counterpart of ``deeplearning4j_tpu/datavec/reduce.py``, copied (host
Python).

Reference analog: org.datavec.api.transform.reduce.Reducer (+ Builder) with
ReduceOp (MIN/MAX/SUM/MEAN/STDEV/COUNT/COUNT_UNIQUE/TAKE_FIRST/TAKE_LAST).
Output column naming follows the reference: ``op(column)`` for aggregated
columns; key columns keep their name and type.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from deeplearning4j_tpu_torch.datavec.conditions import sample_stdev, try_float
from deeplearning4j_tpu_torch.datavec.schema import ColumnMeta, ColumnType, Schema

_NUMERIC_OPS = ("min", "max", "sum", "mean", "stdev")
_ALL_OPS = _NUMERIC_OPS + ("count", "count_unique", "take_first", "take_last")


def _apply(op: str, values: list):
    if op == "count":
        return len(values)
    if op == "count_unique":
        return len(set(values))
    if op == "take_first":
        return values[0]
    if op == "take_last":
        return values[-1]
    # invalid/empty values are skipped, matching analyze()'s counting
    # (shared try_float semantics); all-invalid groups reduce to NaN
    nums = [f for f in (try_float(v) for v in values) if f is not None]
    if not nums:
        return float("nan")
    if op == "min":
        return min(nums)
    if op == "max":
        return max(nums)
    if op == "sum":
        return sum(nums)
    if op == "mean":
        return sum(nums) / len(nums)
    if op == "stdev":
        return sample_stdev(nums)
    raise ValueError(f"unknown reduce op {op}")


def _out_meta(op: str, col: ColumnMeta) -> ColumnMeta:
    name = f"{op}({col.name})"
    if op in ("count", "count_unique"):
        return ColumnMeta(name, ColumnType.INTEGER)
    if op in _NUMERIC_OPS:
        return ColumnMeta(name, ColumnType.DOUBLE)
    return ColumnMeta(name, col.type, col.categories)


class Reducer:
    """Group-by-key aggregation; build with ``Reducer.builder(*keys)``."""

    def __init__(self, keys: List[str], default_op: str,
                 column_ops: Dict[str, str]):
        for op in [default_op] + list(column_ops.values()):
            if op not in _ALL_OPS:
                raise ValueError(f"unknown reduce op {op}; one of {_ALL_OPS}")
        self.keys = keys
        self.default_op = default_op
        self.column_ops = dict(column_ops)

    def _op_for(self, name: str) -> str:
        return self.column_ops.get(name, self.default_op)

    def output_schema(self, schema: Schema) -> Schema:
        cols = []
        for c in schema.columns:
            if c.name in self.keys:
                cols.append(c)
            else:
                cols.append(_out_meta(self._op_for(c.name), c))
        return Schema(cols)

    def reduce(self, schema: Schema, records: Sequence[list]) -> List[list]:
        ki = [schema.index_of(k) for k in self.keys]
        groups: dict = {}
        for r in records:
            groups.setdefault(tuple(r[i] for i in ki), []).append(r)
        out = []
        for rows in groups.values():
            rec = []
            for i, c in enumerate(schema.columns):
                if c.name in self.keys:
                    rec.append(rows[0][i])
                else:
                    rec.append(_apply(self._op_for(c.name),
                                      [r[i] for r in rows]))
            out.append(rec)
        return out

    # ------------------------------------------------------------------ json
    def spec(self) -> dict:
        return {"keys": self.keys, "default_op": self.default_op,
                "column_ops": self.column_ops}

    @staticmethod
    def from_spec(spec: dict) -> "Reducer":
        return Reducer(spec["keys"], spec["default_op"], spec["column_ops"])

    # --------------------------------------------------------------- builder
    class Builder:
        def __init__(self, *keys: str):
            if not keys:
                raise ValueError("at least one key column required")
            self._keys = list(keys)
            self._default = "take_first"
            self._ops: Dict[str, str] = {}

        def default_op(self, op: str) -> "Reducer.Builder":
            self._default = op
            return self

        def _cols(self, op: str, names) -> "Reducer.Builder":
            for n in names:
                self._ops[n] = op
            return self

        def min_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("min", names)

        def max_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("max", names)

        def sum_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("sum", names)

        def mean_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("mean", names)

        def stdev_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("stdev", names)

        def count_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("count", names)

        def count_unique_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("count_unique", names)

        def take_first_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("take_first", names)

        def take_last_columns(self, *names: str) -> "Reducer.Builder":
            return self._cols("take_last", names)

        def build(self) -> "Reducer":
            return Reducer(self._keys, self._default, self._ops)

    @staticmethod
    def builder(*keys: str) -> "Reducer.Builder":
        return Reducer.Builder(*keys)
