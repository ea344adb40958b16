"""TransformProcess — schema-aware record transformations.

Counterpart of ``deeplearning4j_tpu/datavec/transform.py``, copied (host
Python): the same JSON, byte for byte, and each package's JSON loads in the
other.

Reference analog: org.datavec.api.transform.TransformProcess (+ Builder) and
the local executor (org.datavec.local.transforms.LocalTransformExecutor).
Each step maps (schema, records) -> (schema, records); the Builder tracks the
evolving schema exactly like the reference (getFinalSchema), and the
declarative steps round-trip through JSON like the reference's Jackson form
(toJson/fromJson). Sequence steps follow the reference model: after
convert_to_sequence the executor carries List[sequence] (a sequence is a
list of records); per-record transforms then apply elementwise inside each
sequence, exactly like the reference's sequence-mode execution.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.conditions import (
    Condition, condition_from_spec, _is_invalid)
from deeplearning4j_tpu_torch.datavec.schema import ColumnMeta, ColumnType, Schema


@dataclasses.dataclass
class _Step:
    name: str
    schema_fn: Callable[[Schema], Schema]
    # per-record map: (schema, record) -> record | None (None = filtered out)
    record_fn: Optional[Callable[[Schema, list], Optional[list]]] = None
    # whole-dataset step: (schema, items) -> items
    global_fn: Optional[Callable[[Schema, list], list]] = None
    # whole-sequence step (sequence mode only): (schema, seq) -> seq | None
    sequence_fn: Optional[Callable[[Schema, list], Optional[list]]] = None
    seq_after: Optional[bool] = None  # toggles sequence mode after this step
    # required mode for global steps: True = sequences, False = flat records
    expects_seq: Optional[bool] = None
    spec: Optional[dict] = None       # JSON form; None = not serializable


class TransformProcess:
    def __init__(self, initial: Schema, steps: List[_Step]):
        self.initial_schema = initial
        self.steps = steps

    # -------------------------------------------------------------- executor
    def final_schema(self) -> Schema:
        s = self.initial_schema
        for st in self.steps:
            s = st.schema_fn(s)
        return s

    def execute(self, records: Sequence[list], sequences: bool = False
                ) -> List[list]:
        """LocalTransformExecutor.execute / executeSequence analog.

        ``records``: flat records (or sequences when ``sequences=True``,
        e.g. from CSVSequenceRecordReader). Returns flat records, unless the
        process ends in sequence mode, in which case a list of sequences.
        """
        items = [list(r) for r in records]
        schema = self.initial_schema
        seq = sequences
        for st in self.steps:
            if st.global_fn is not None:
                if st.expects_seq is not None and st.expects_seq != seq:
                    want = "sequence" if st.expects_seq else "flat-record"
                    raise ValueError(
                        f"step {st.name} requires {want} mode (currently "
                        f"{'sequence' if seq else 'flat-record'}); "
                        f"{'call convert_to_sequence first' if st.expects_seq else 'call convert_from_sequence first'}")
                items = st.global_fn(schema, items)
            elif st.sequence_fn is not None:
                if not seq:
                    raise ValueError(
                        f"step {st.name} requires sequence mode; call "
                        f"convert_to_sequence first (reference: sequence "
                        f"transforms only apply to sequence data)")
                items = [s2 for s in items
                         if (s2 := st.sequence_fn(schema, s)) is not None and s2]
            elif seq:
                new_items = []
                for s in items:
                    s2 = [r2 for r in s
                          if (r2 := st.record_fn(schema, r)) is not None]
                    if s2:
                        new_items.append(s2)
                items = new_items
            else:
                items = [r2 for r in items
                         if (r2 := st.record_fn(schema, r)) is not None]
            schema = st.schema_fn(schema)
            if st.seq_after is not None:
                seq = st.seq_after
        return items

    # ------------------------------------------------------------------ json
    def to_json(self) -> str:
        """Serializable form (reference: TransformProcess.toJson).

        Steps built from raw Python callables (``filter``, ``double_map``)
        have no declarative form and are rejected loudly, matching the
        reference's stance that JSON-round-trippable processes only use
        declarative transforms.
        """
        bad = [st.name for st in self.steps if st.spec is None]
        if bad:
            raise ValueError(
                f"steps {bad} use raw callables and cannot be serialized; "
                f"use declarative builder methods (conditions, math ops) "
                f"for JSON round-trip")
        return json.dumps({"schema": self.initial_schema.to_dict(),
                           "steps": [st.spec for st in self.steps]}, indent=1)

    @staticmethod
    def from_json(js: str) -> "TransformProcess":
        d = json.loads(js)
        b = TransformProcess.Builder(Schema.from_dict(d["schema"]))
        for spec in d["steps"]:
            spec = dict(spec)
            op = spec.pop("op")
            args = spec.pop("args", [])
            kwargs = spec
            if op in ("condition_filter", "conditional_replace_value"):
                # first arg (or 'condition' kwarg) is a serialized condition
                if "condition" in kwargs:
                    kwargs["condition"] = condition_from_spec(kwargs["condition"])
                else:
                    args = [condition_from_spec(args[0])] + list(args[1:])
            elif op == "reduce":
                from deeplearning4j_tpu_torch.datavec.reduce import Reducer
                kwargs["reducer"] = Reducer.from_spec(kwargs["reducer"])
            getattr(b, op)(*args, **kwargs)
        return b.build()

    # --------------------------------------------------------------- builder
    class Builder:
        def __init__(self, schema: Schema):
            self._initial = schema
            self._steps: List[_Step] = []

        def _declarative(self, op: str, *args, **kwargs) -> dict:
            return {"op": op, "args": list(args), **kwargs}

        # -- column removal/selection
        def remove_columns(self, *names: str) -> "TransformProcess.Builder":
            def schema_fn(s: Schema) -> Schema:
                return Schema([c for c in s.columns if c.name not in names])

            def record_fn(s: Schema, r: list):
                drop = {s.index_of(n) for n in names}
                return [v for i, v in enumerate(r) if i not in drop]

            self._steps.append(_Step(f"remove{names}", schema_fn, record_fn,
                                     spec=self._declarative("remove_columns",
                                                            *names)))
            return self

        def remove_all_columns_except(self, *names: str) -> "TransformProcess.Builder":
            def schema_fn(s: Schema) -> Schema:
                return Schema([c for c in s.columns if c.name in names])

            def record_fn(s: Schema, r: list):
                keep = {s.index_of(n) for n in names}
                return [v for i, v in enumerate(r) if i in keep]

            self._steps.append(_Step(f"keep{names}", schema_fn, record_fn,
                                     spec=self._declarative(
                                         "remove_all_columns_except", *names)))
            return self

        def rename_column(self, old: str, new: str) -> "TransformProcess.Builder":
            """RenameColumnsTransform analog."""

            def schema_fn(s: Schema) -> Schema:
                return Schema([ColumnMeta(new, c.type, c.categories)
                               if c.name == old else c for c in s.columns])

            self._steps.append(_Step(f"rename({old}->{new})", schema_fn,
                                     lambda s, r: r,
                                     spec=self._declarative("rename_column",
                                                            old, new)))
            return self

        def duplicate_column(self, name: str, new_name: str
                             ) -> "TransformProcess.Builder":
            """DuplicateColumnsTransform analog (copy appended after source)."""

            def schema_fn(s: Schema) -> Schema:
                cols = []
                for c in s.columns:
                    cols.append(c)
                    if c.name == name:
                        cols.append(ColumnMeta(new_name, c.type, c.categories))
                return Schema(cols)

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                return r[:i + 1] + [r[i]] + r[i + 1:]

            self._steps.append(_Step(f"dup({name})", schema_fn, record_fn,
                                     spec=self._declarative("duplicate_column",
                                                            name, new_name)))
            return self

        def add_constant_column(self, name: str, col_type: str, value
                                ) -> "TransformProcess.Builder":
            """AddConstantColumnTransform analog."""
            ct = ColumnType(col_type)

            def schema_fn(s: Schema) -> Schema:
                return Schema(s.columns + [ColumnMeta(name, ct)])

            self._steps.append(_Step(f"const({name})", schema_fn,
                                     lambda s, r: r + [value],
                                     spec=self._declarative(
                                         "add_constant_column", name,
                                         col_type, value)))
            return self

        # -- filters
        def filter(self, predicate: Callable[[Schema, list], bool]
                   ) -> "TransformProcess.Builder":
            """Keep records where predicate(schema, record) is True
            (FilterOp analog; raw-callable form — not JSON-serializable)."""

            def record_fn(s: Schema, r: list):
                return r if predicate(s, r) else None

            self._steps.append(_Step("filter", lambda s: s, record_fn))
            return self

        def condition_filter(self, condition: Condition
                             ) -> "TransformProcess.Builder":
            """ConditionFilter analog: REMOVES records matching the
            condition (reference semantics: filter out where satisfied)."""

            def record_fn(s: Schema, r: list):
                return None if condition.check(s, r) else r

            self._steps.append(_Step("condition_filter", lambda s: s, record_fn,
                                     spec=self._declarative(
                                         "condition_filter", condition.spec())))
            return self

        # -- conditional / invalid-value replacement
        def conditional_replace_value(self, column: str, value,
                                      condition: Condition
                                      ) -> "TransformProcess.Builder":
            """ConditionalReplaceValueTransform analog."""

            def record_fn(s: Schema, r: list):
                if condition.check(s, r):
                    r = list(r)
                    r[s.index_of(column)] = value
                return r

            self._steps.append(_Step(f"condreplace({column})", lambda s: s,
                                     record_fn,
                                     spec=self._declarative(
                                         "conditional_replace_value", column,
                                         value, condition=condition.spec())))
            return self

        def replace_invalid_with(self, column: str, value
                                 ) -> "TransformProcess.Builder":
            """ReplaceInvalidWithIntegerTransform / ReplaceEmpty analog:
            NaN / empty / unparseable values become ``value``."""

            def record_fn(s: Schema, r: list):
                i = s.index_of(column)
                if _is_invalid(r[i], s.column(column)):
                    r = list(r)
                    r[i] = value
                return r

            self._steps.append(_Step(f"replinvalid({column})", lambda s: s,
                                     record_fn,
                                     spec=self._declarative(
                                         "replace_invalid_with", column,
                                         value)))
            return self

        # -- categorical
        def categorical_to_integer(self, name: str) -> "TransformProcess.Builder":
            def schema_fn(s: Schema) -> Schema:
                cols = [ColumnMeta(c.name, ColumnType.INTEGER) if c.name == name
                        else c for c in s.columns]
                return Schema(cols)

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                cats = s.column(name).categories
                r = list(r)
                r[i] = cats.index(r[i])
                return r

            self._steps.append(_Step(f"cat2int({name})", schema_fn, record_fn,
                                     spec=self._declarative(
                                         "categorical_to_integer", name)))
            return self

        def integer_to_categorical(self, name: str, *categories: str
                                   ) -> "TransformProcess.Builder":
            """IntegerToCategoricalTransform analog (index -> category)."""

            def schema_fn(s: Schema) -> Schema:
                cols = [ColumnMeta(c.name, ColumnType.CATEGORICAL,
                                   list(categories))
                        if c.name == name else c for c in s.columns]
                return Schema(cols)

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = categories[int(r[i])]
                return r

            self._steps.append(_Step(f"int2cat({name})", schema_fn, record_fn,
                                     spec=self._declarative(
                                         "integer_to_categorical", name,
                                         *categories)))
            return self

        def categorical_to_one_hot(self, name: str) -> "TransformProcess.Builder":
            def schema_fn(s: Schema) -> Schema:
                cats = s.column(name).categories
                cols = []
                for c in s.columns:
                    if c.name == name:
                        cols.extend(ColumnMeta(f"{name}[{cat}]", ColumnType.INTEGER)
                                    for cat in cats)
                    else:
                        cols.append(c)
                return Schema(cols)

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                cats = s.column(name).categories
                onehot = [1 if r[i] == cat else 0 for cat in cats]
                return r[:i] + onehot + r[i + 1:]

            self._steps.append(_Step(f"onehot({name})", schema_fn, record_fn,
                                     spec=self._declarative(
                                         "categorical_to_one_hot", name)))
            return self

        def string_to_categorical(self, name: str, *categories: str
                                  ) -> "TransformProcess.Builder":
            def schema_fn(s: Schema) -> Schema:
                cols = [ColumnMeta(c.name, ColumnType.CATEGORICAL, list(categories))
                        if c.name == name else c for c in s.columns]
                return Schema(cols)

            self._steps.append(_Step(f"str2cat({name})", schema_fn,
                                     lambda s, r: r,
                                     spec=self._declarative(
                                         "string_to_categorical", name,
                                         *categories)))
            return self

        # -- string transforms
        def append_string(self, name: str, suffix: str
                          ) -> "TransformProcess.Builder":
            """AppendStringColumnTransform analog."""

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = str(r[i]) + suffix
                return r

            self._steps.append(_Step(f"append({name})", lambda s: s, record_fn,
                                     spec=self._declarative("append_string",
                                                            name, suffix)))
            return self

        def change_case(self, name: str, case: str = "lower"
                        ) -> "TransformProcess.Builder":
            """ChangeCaseStringTransform analog (case: lower|upper)."""
            if case not in ("lower", "upper"):
                raise ValueError("case must be 'lower' or 'upper'")

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = str(r[i]).lower() if case == "lower" else str(r[i]).upper()
                return r

            self._steps.append(_Step(f"case({name})", lambda s: s, record_fn,
                                     spec=self._declarative("change_case",
                                                            name, case)))
            return self

        def replace_string(self, name: str, old: str, new: str
                           ) -> "TransformProcess.Builder":
            """ReplaceStringTransform analog (substring replacement)."""

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = str(r[i]).replace(old, new)
                return r

            self._steps.append(_Step(f"replace({name})", lambda s: s, record_fn,
                                     spec=self._declarative("replace_string",
                                                            name, old, new)))
            return self

        def concat_columns(self, new_name: str, delimiter: str, *names: str
                           ) -> "TransformProcess.Builder":
            """ConcatenateStringColumns analog: new string column appended."""

            def schema_fn(s: Schema) -> Schema:
                return Schema(s.columns + [ColumnMeta(new_name,
                                                      ColumnType.STRING)])

            def record_fn(s: Schema, r: list):
                vals = [str(r[s.index_of(n)]) for n in names]
                return r + [delimiter.join(vals)]

            self._steps.append(_Step(f"concat({new_name})", schema_fn,
                                     record_fn,
                                     spec=self._declarative(
                                         "concat_columns", new_name,
                                         delimiter, *names)))
            return self

        # -- numeric math
        def double_math_op(self, name: str, op: str, value: float
                           ) -> "TransformProcess.Builder":
            ops = {"add": lambda x: x + value, "subtract": lambda x: x - value,
                   "multiply": lambda x: x * value, "divide": lambda x: x / value,
                   "pow": lambda x: x ** value}
            if op.lower() not in ops:
                raise ValueError(f"unknown math op {op}")
            f = ops[op.lower()]

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = f(float(r[i]))
                return r

            self._steps.append(_Step(f"math({name},{op})", lambda s: s,
                                     record_fn,
                                     spec=self._declarative(
                                         "double_math_op", name, op, value)))
            return self

        # reference spells the integer variant separately (IntegerMathOp);
        # keep the name for API parity, preserving int-ness
        def integer_math_op(self, name: str, op: str, value: int
                            ) -> "TransformProcess.Builder":
            # divide/modulus follow Java int semantics (truncate toward
            # zero; remainder sign follows the dividend), matching the
            # reference IntegerMathOp on negative operands
            ops = {"add": lambda x: x + value, "subtract": lambda x: x - value,
                   "multiply": lambda x: x * value,
                   "divide": lambda x: int(x / value),
                   "modulus": lambda x: x - int(x / value) * value}
            if op.lower() not in ops:
                raise ValueError(f"unknown math op {op}")
            f = ops[op.lower()]

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = f(int(r[i]))
                return r

            self._steps.append(_Step(f"imath({name},{op})", lambda s: s,
                                     record_fn,
                                     spec=self._declarative(
                                         "integer_math_op", name, op, value)))
            return self

        def double_columns_math_op(self, new_name: str, op: str, *names: str
                                   ) -> "TransformProcess.Builder":
            """DoubleColumnsMathOpTransform analog: new column from a
            row-wise op over existing columns (add/subtract/multiply/divide
            — subtract/divide are binary)."""
            if op.lower() in ("subtract", "divide") and len(names) != 2:
                raise ValueError(f"{op} requires exactly 2 columns")

            def apply(vals):
                o = op.lower()
                if o == "add":
                    return sum(vals)
                if o == "multiply":
                    out = 1.0
                    for v in vals:
                        out *= v
                    return out
                if o == "subtract":
                    return vals[0] - vals[1]
                if o == "divide":
                    return vals[0] / vals[1]
                raise ValueError(f"unknown math op {op}")

            def schema_fn(s: Schema) -> Schema:
                return Schema(s.columns + [ColumnMeta(new_name,
                                                      ColumnType.DOUBLE)])

            def record_fn(s: Schema, r: list):
                vals = [float(r[s.index_of(n)]) for n in names]
                return r + [apply(vals)]

            self._steps.append(_Step(f"colmath({new_name})", schema_fn,
                                     record_fn,
                                     spec=self._declarative(
                                         "double_columns_math_op", new_name,
                                         op, *names)))
            return self

        def double_map(self, name: str, fn: Callable[[float], float]
                       ) -> "TransformProcess.Builder":
            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                r[i] = fn(float(r[i]))
                return r

            self._steps.append(_Step(f"map({name})", lambda s: s, record_fn))
            return self

        # -- normalization over the dataset requires two passes; expose a
        #    fit-style helper mirroring the reference's analysis + transform
        def normalize_min_max(self, name: str, lo: float, hi: float
                              ) -> "TransformProcess.Builder":
            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                span = (hi - lo) or 1.0
                r[i] = (float(r[i]) - lo) / span
                return r

            self._steps.append(_Step(f"minmax({name})", lambda s: s, record_fn,
                                     spec=self._declarative(
                                         "normalize_min_max", name, lo, hi)))
            return self

        # -- time
        def string_to_time(self, name: str, fmt: str
                           ) -> "TransformProcess.Builder":
            """StringToTimeTransform analog: parse with ``fmt``
            (strptime syntax) -> epoch milliseconds, column becomes TIME."""

            def schema_fn(s: Schema) -> Schema:
                return Schema([ColumnMeta(c.name, ColumnType.TIME)
                               if c.name == name else c for c in s.columns])

            def record_fn(s: Schema, r: list):
                i = s.index_of(name)
                r = list(r)
                dt = _dt.datetime.strptime(str(r[i]), fmt)
                dt = dt.replace(tzinfo=_dt.timezone.utc)
                r[i] = int(dt.timestamp() * 1000)
                return r

            self._steps.append(_Step(f"str2time({name})", schema_fn, record_fn,
                                     spec=self._declarative("string_to_time",
                                                            name, fmt)))
            return self

        def derive_column_from_time(self, source: str, new_name: str,
                                    field: str) -> "TransformProcess.Builder":
            """DeriveColumnsFromTimeTransform analog. ``field``: one of
            hour_of_day | day_of_week | day_of_month | month | year."""
            # day_of_week is Joda-convention Monday=1..Sunday=7 (the
            # reference's DateTimeFieldType.dayOfWeek), not Python's 0-based
            fields = {"hour_of_day": lambda d: d.hour,
                      "day_of_week": lambda d: d.weekday() + 1,
                      "day_of_month": lambda d: d.day,
                      "month": lambda d: d.month,
                      "year": lambda d: d.year}
            if field not in fields:
                raise ValueError(f"unknown time field {field}; "
                                 f"one of {sorted(fields)}")
            f = fields[field]

            def schema_fn(s: Schema) -> Schema:
                return Schema(s.columns + [ColumnMeta(new_name,
                                                      ColumnType.INTEGER)])

            def record_fn(s: Schema, r: list):
                ms = int(r[s.index_of(source)])
                d = _dt.datetime.fromtimestamp(ms / 1000.0, _dt.timezone.utc)
                return r + [f(d)]

            self._steps.append(_Step(f"timefield({new_name})", schema_fn,
                                     record_fn,
                                     spec=self._declarative(
                                         "derive_column_from_time", source,
                                         new_name, field)))
            return self

        # -- group-by reduction (org.datavec.api.transform.reduce.Reducer)
        def reduce(self, reducer) -> "TransformProcess.Builder":
            def schema_fn(s: Schema) -> Schema:
                return reducer.output_schema(s)

            def global_fn(s: Schema, items: list) -> list:
                return reducer.reduce(s, items)

            self._steps.append(_Step("reduce", schema_fn, global_fn=global_fn,
                                     expects_seq=False,
                                     spec={"op": "reduce",
                                           "reducer": reducer.spec()}))
            return self

        # -- sequence steps (org.datavec.api.transform.sequence)
        def convert_to_sequence(self, key_column: str, sort_column: str
                                ) -> "TransformProcess.Builder":
            """ConvertToSequence analog: group records by ``key_column``,
            order each group by ``sort_column`` ascending
            (NumericalColumnComparator). Output items become sequences."""

            def global_fn(s: Schema, items: list) -> list:
                ki = s.index_of(key_column)
                si = s.index_of(sort_column)
                groups: dict = {}
                for r in items:
                    groups.setdefault(r[ki], []).append(r)
                return [sorted(g, key=lambda r: float(r[si]))
                        for g in groups.values()]

            self._steps.append(_Step("to_sequence", lambda s: s,
                                     global_fn=global_fn, seq_after=True,
                                     expects_seq=False,
                                     spec=self._declarative(
                                         "convert_to_sequence", key_column,
                                         sort_column)))
            return self

        def convert_from_sequence(self) -> "TransformProcess.Builder":
            """ConvertFromSequence analog: flatten sequences to records."""

            def global_fn(s: Schema, items: list) -> list:
                return [r for seq in items for r in seq]

            self._steps.append(_Step("from_sequence", lambda s: s,
                                     global_fn=global_fn, seq_after=False,
                                     expects_seq=True,
                                     spec=self._declarative(
                                         "convert_from_sequence")))
            return self

        def offset_sequence(self, columns: Sequence[str], offset: int
                            ) -> "TransformProcess.Builder":
            """OffsetSequenceTransform (TrimSequence mode) analog: the named
            columns are shifted ``offset`` steps relative to the others
            (positive = value comes from ``offset`` steps earlier), and the
            |offset| boundary rows that lose alignment are trimmed. The
            classic use is next-step prediction targets (offset -1 on the
            label column)."""
            cols = list(columns)
            if offset == 0:
                raise ValueError("offset must be nonzero")

            def sequence_fn(s: Schema, seq: list):
                idx = [s.index_of(c) for c in cols]
                n = len(seq)
                k = abs(offset)
                if n <= k:
                    return None
                out = []
                for t in range(k, n) if offset > 0 else range(0, n - k):
                    r = list(seq[t])
                    src = seq[t - offset]
                    for i in idx:
                        r[i] = src[i]
                    out.append(r)
                return out

            self._steps.append(_Step(f"offset({cols},{offset})", lambda s: s,
                                     sequence_fn=sequence_fn,
                                     spec=self._declarative(
                                         "offset_sequence", cols, offset)))
            return self

        def trim_sequence(self, n: int, from_first: bool = True
                          ) -> "TransformProcess.Builder":
            """SequenceTrimTransform analog: drop ``n`` steps from the
            start (``from_first=True``) or end of every sequence."""

            def sequence_fn(s: Schema, seq: list):
                out = seq[n:] if from_first else seq[:len(seq) - n]
                return out or None

            self._steps.append(_Step(f"trim({n})", lambda s: s,
                                     sequence_fn=sequence_fn,
                                     spec=self._declarative(
                                         "trim_sequence", n, from_first)))
            return self

        def split_sequence_by_length(self, max_length: int
                                     ) -> "TransformProcess.Builder":
            """SequenceSplit (SplitMaxLengthSequence) analog: sequences
            longer than ``max_length`` split into consecutive chunks."""

            def global_fn(s: Schema, items: list) -> list:
                out = []
                for seq in items:
                    for i in range(0, len(seq), max_length):
                        out.append(seq[i:i + max_length])
                return out

            self._steps.append(_Step(f"split({max_length})", lambda s: s,
                                     global_fn=global_fn, expects_seq=True,
                                     spec=self._declarative(
                                         "split_sequence_by_length",
                                         max_length)))
            return self

        def build(self) -> "TransformProcess":
            return TransformProcess(self._initial, list(self._steps))

    @staticmethod
    def builder(schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(schema)
