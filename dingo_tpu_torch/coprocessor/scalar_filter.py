"""Scalar predicate evaluation over vector scalar data
(port of dingo_tpu/coprocessor/scalar_filter.py).

Reference: the scalar post-filter in VectorReader compares requested scalar
key/values against each candidate's scalar data (vector_reader.cc:120-215,
CoprocessorScalar schema-typed compare). Scalar data is a map
field -> typed value (pb::common::VectorScalardata).

The reference's SCALAR post-filter mode is equality-on-all-requested-fields;
CoprocessorV2 runs rel-expression bytecode for richer predicates. Here
ScalarFilter supports conjunctions of typed comparisons (EQ/NE/LT/LE/GT/GE/
IN) which covers both the equality mode and the common coprocessor cases;
a full expression VM port is tracked for the coprocessor_v2 milestone.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Sequence


class CmpOp(enum.Enum):
    EQ = "eq"
    NE = "ne"
    LT = "lt"
    LE = "le"
    GT = "gt"
    GE = "ge"
    IN = "in"


@dataclasses.dataclass(frozen=True)
class ScalarPredicate:
    field: str
    op: CmpOp
    value: Any

    def matches(self, scalar: Dict[str, Any]) -> bool:
        if self.field not in scalar:
            return False
        v = scalar[self.field]
        try:
            if self.op is CmpOp.EQ:
                return v == self.value
            if self.op is CmpOp.NE:
                return v != self.value
            if self.op is CmpOp.LT:
                return v < self.value
            if self.op is CmpOp.LE:
                return v <= self.value
            if self.op is CmpOp.GT:
                return v > self.value
            if self.op is CmpOp.GE:
                return v >= self.value
            if self.op is CmpOp.IN:
                return v in self.value
        except TypeError:
            return False
        return False


@dataclasses.dataclass
class ScalarFilter:
    """Conjunction of predicates (the reference's post-filter requires every
    requested scalar entry to match)."""

    predicates: Sequence[ScalarPredicate] = ()

    @classmethod
    def equals(cls, required: Dict[str, Any]) -> "ScalarFilter":
        """Reference SCALAR filter mode: all key/values equal."""
        return cls([ScalarPredicate(k, CmpOp.EQ, v) for k, v in required.items()])

    def matches(self, scalar: Dict[str, Any]) -> bool:
        return all(p.matches(scalar) for p in self.predicates)

    def is_empty(self) -> bool:
        return not self.predicates

    def fields(self) -> set:
        """Scalar fields this filter reads — used to decide whether the
        narrow speed-up CF covers it (vector_index_utils.h split-keys)."""
        return {p.field for p in self.predicates}
