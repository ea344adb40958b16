"""Join — relational joins between two record sets.

Counterpart of ``deeplearning4j_tpu/datavec/join.py``, copied (host Python).

Reference analog: org.datavec.api.transform.join.Join (+ Builder; executed
by LocalTransformExecutor.executeJoin). Join types: Inner, LeftOuter,
RightOuter, FullOuter; missing side fills with None (the reference's
NullWritable).
"""

from __future__ import annotations

from typing import List, Sequence

from deeplearning4j_tpu_torch.datavec.schema import Schema

_TYPES = ("inner", "left_outer", "right_outer", "full_outer")


class Join:
    def __init__(self, join_type: str, left: Schema, right: Schema,
                 keys: List[str]):
        if join_type not in _TYPES:
            raise ValueError(f"join type must be one of {_TYPES}")
        for k in keys:
            left.index_of(k), right.index_of(k)  # raises KeyError if absent
        self.join_type = join_type
        self.left_schema = left
        self.right_schema = right
        self.keys = list(keys)

    def output_schema(self) -> Schema:
        # key columns once (from left), then left non-key, then right non-key
        cols = [self.left_schema.column(k) for k in self.keys]
        cols += [c for c in self.left_schema.columns if c.name not in self.keys]
        cols += [c for c in self.right_schema.columns
                 if c.name not in self.keys]
        return Schema(cols)

    def execute(self, left: Sequence[list], right: Sequence[list]
                ) -> List[list]:
        lk = [self.left_schema.index_of(k) for k in self.keys]
        rk = [self.right_schema.index_of(k) for k in self.keys]
        lnk = [i for i, c in enumerate(self.left_schema.columns)
               if c.name not in self.keys]
        rnk = [i for i, c in enumerate(self.right_schema.columns)
               if c.name not in self.keys]

        rindex: dict = {}
        for r in right:
            rindex.setdefault(tuple(r[i] for i in rk), []).append(r)

        out = []
        matched_right = set()
        for l in left:
            key = tuple(l[i] for i in lk)
            matches = rindex.get(key, [])
            if matches:
                matched_right.add(key)
                for r in matches:
                    out.append(list(key) + [l[i] for i in lnk]
                               + [r[i] for i in rnk])
            elif self.join_type in ("left_outer", "full_outer"):
                out.append(list(key) + [l[i] for i in lnk]
                           + [None] * len(rnk))
        if self.join_type in ("right_outer", "full_outer"):
            for key, rows in rindex.items():
                if key not in matched_right:
                    for r in rows:
                        out.append(list(key) + [None] * len(lnk)
                                   + [r[i] for i in rnk])
        return out

    # --------------------------------------------------------------- builder
    class Builder:
        def __init__(self, join_type: str = "inner"):
            self._type = join_type
            self._left = None
            self._right = None
            self._keys: List[str] = []

        def set_schemas(self, left: Schema, right: Schema) -> "Join.Builder":
            self._left, self._right = left, right
            return self

        def set_keys(self, *keys: str) -> "Join.Builder":
            self._keys = list(keys)
            return self

        def build(self) -> "Join":
            if self._left is None or self._right is None or not self._keys:
                raise ValueError("set_schemas and set_keys are required")
            return Join(self._type, self._left, self._right, self._keys)

    @staticmethod
    def builder(join_type: str = "inner") -> "Join.Builder":
        return Join.Builder(join_type)
