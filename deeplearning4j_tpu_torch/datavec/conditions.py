"""Conditions — serializable predicates over records.

Counterpart of ``deeplearning4j_tpu/datavec/conditions.py``, copied (host
Python).

Reference analog: org.datavec.api.transform.condition (ColumnCondition with
ConditionOp, BooleanCondition AND/OR/NOT combinators). Conditions drive
ConditionFilter and conditional replace transforms, and round-trip through
the TransformProcess JSON form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence


def try_float(v: Any) -> "float | None":
    """float(v) or None if unparseable/NaN. Shared by conditions, analysis
    and reducers so invalid-value semantics can't drift between them."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return None if math.isnan(f) else f


def sample_stdev(nums: Sequence[float]) -> float:
    """n-1 sample standard deviation (reference: StandardDeviation)."""
    n = len(nums)
    if n < 2:
        return 0.0
    m = sum(nums) / n
    return math.sqrt(sum((x - m) ** 2 for x in nums) / (n - 1))


def _is_invalid(v: Any, col=None) -> bool:
    """Type-aware validity (reference: per-type analysis quality checks).

    Numeric/time columns: unparseable or NaN is invalid. Categorical:
    values outside the category list. String: only None/empty. Without
    column metadata, falls back to the numeric rule.
    """
    if v is None or v == "":
        return True
    if col is not None:
        from deeplearning4j_tpu_torch.datavec.schema import ColumnType
        if col.type == ColumnType.STRING:
            return False
        if col.type == ColumnType.CATEGORICAL:
            return col.categories is not None and v not in col.categories
    return try_float(v) is None


class Condition:
    def check(self, schema, record: list) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def spec(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- combinators (BooleanCondition analog)
    def __and__(self, other: "Condition") -> "Condition":
        return BooleanCondition("and", [self, other])

    def __or__(self, other: "Condition") -> "Condition":
        return BooleanCondition("or", [self, other])

    def __invert__(self) -> "Condition":
        return BooleanCondition("not", [self])


_OPS = {
    "lt": lambda v, t: float(v) < t,
    "lte": lambda v, t: float(v) <= t,
    "gt": lambda v, t: float(v) > t,
    "gte": lambda v, t: float(v) >= t,
    "eq": lambda v, t: v == t or (try_float(v) is not None
                                  and try_float(v) == try_float(t)),
    "neq": lambda v, t: not _OPS["eq"](v, t),
    "in_set": lambda v, t: v in t,
    "not_in_set": lambda v, t: v not in t,
}


@dataclasses.dataclass
class ColumnCondition(Condition):
    """ConditionOp applied to one column (NumericalColumnCondition /
    CategoricalColumnCondition / StringColumnCondition collapse into one
    class here — the op table is value-typed, not column-typed)."""

    column: str
    op: str
    value: Any = None

    def __post_init__(self):
        if self.op not in _OPS and self.op != "is_invalid":
            raise ValueError(f"unknown condition op {self.op!r}; "
                             f"one of {sorted(_OPS) + ['is_invalid']}")

    def check(self, schema, record: list) -> bool:
        v = record[schema.index_of(self.column)]
        if self.op == "is_invalid":
            return _is_invalid(v, schema.column(self.column))
        if self.op in ("lt", "lte", "gt", "gte") and try_float(v) is None:
            return False
        value = self.value
        if isinstance(value, (list, tuple)) and self.op in ("in_set", "not_in_set"):
            value = list(value)
        return _OPS[self.op](v, value)

    def spec(self) -> dict:
        v = self.value
        if isinstance(v, (set, frozenset, tuple)):
            v = sorted(v) if not isinstance(v, tuple) else list(v)
        return {"kind": "column", "column": self.column, "op": self.op,
                "value": v}


@dataclasses.dataclass
class BooleanCondition(Condition):
    """AND/OR/NOT over sub-conditions."""

    kind: str
    conditions: List[Condition]

    def check(self, schema, record: list) -> bool:
        if self.kind == "and":
            return all(c.check(schema, record) for c in self.conditions)
        if self.kind == "or":
            return any(c.check(schema, record) for c in self.conditions)
        if self.kind == "not":
            return not self.conditions[0].check(schema, record)
        raise ValueError(f"unknown boolean kind {self.kind}")

    def spec(self) -> dict:
        return {"kind": self.kind,
                "conditions": [c.spec() for c in self.conditions]}


def condition_from_spec(spec: dict) -> Condition:
    kind = spec["kind"]
    if kind == "column":
        return ColumnCondition(spec["column"], spec["op"], spec.get("value"))
    return BooleanCondition(kind, [condition_from_spec(s)
                                   for s in spec["conditions"]])


# convenience constructors mirroring the reference's static factories
def less_than(column: str, value: float) -> ColumnCondition:
    return ColumnCondition(column, "lt", value)


def greater_than(column: str, value: float) -> ColumnCondition:
    return ColumnCondition(column, "gt", value)


def equal_to(column: str, value: Any) -> ColumnCondition:
    return ColumnCondition(column, "eq", value)


def in_set(column: str, values: Sequence[Any]) -> ColumnCondition:
    return ColumnCondition(column, "in_set", list(values))


def is_invalid(column: str) -> ColumnCondition:
    return ColumnCondition(column, "is_invalid")
