"""Schema — typed column descriptions for tabular records.

Counterpart of ``deeplearning4j_tpu/datavec/schema.py``, copied (host
Python).

Reference analog: org.datavec.api.transform.schema.Schema (+ Builder).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence


class ColumnType(enum.Enum):
    STRING = "string"
    INTEGER = "integer"
    DOUBLE = "double"
    CATEGORICAL = "categorical"
    TIME = "time"


@dataclasses.dataclass
class ColumnMeta:
    name: str
    type: ColumnType
    categories: Optional[List[str]] = None  # for CATEGORICAL


class Schema:
    """Immutable-ish column schema with a DL4J-style Builder."""

    def __init__(self, columns: Sequence[ColumnMeta]):
        self.columns = list(columns)
        self._index = {c.name: i for i, c in enumerate(self.columns)}
        if len(self._index) != len(self.columns):
            raise ValueError("duplicate column names")

    # --------------------------------------------------------------- queries
    @property
    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> ColumnMeta:
        return self.columns[self._index[name]]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def __len__(self):
        return len(self.columns)

    def __repr__(self):
        cols = ", ".join(f"{c.name}:{c.type.value}" for c in self.columns)
        return f"Schema({cols})"

    # ------------------------------------------------------------------ json
    def to_dict(self) -> dict:
        return {"columns": [
            {"name": c.name, "type": c.type.value,
             **({"categories": c.categories} if c.categories else {})}
            for c in self.columns]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema([ColumnMeta(c["name"], ColumnType(c["type"]),
                                  c.get("categories"))
                       for c in d["columns"]])

    # --------------------------------------------------------------- builder
    class Builder:
        def __init__(self):
            self._cols: List[ColumnMeta] = []

        def add_column_string(self, name: str) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, ColumnType.STRING))
            return self

        def add_column_integer(self, name: str) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, ColumnType.INTEGER))
            return self

        def add_column_double(self, name: str) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, ColumnType.DOUBLE))
            return self

        def add_column_categorical(self, name: str, *categories: str) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, ColumnType.CATEGORICAL,
                                         list(categories)))
            return self

        def add_column_time(self, name: str) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, ColumnType.TIME))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()
