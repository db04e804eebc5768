"""Aggregation pushdown (port of dingo_tpu/coprocessor/aggregation.py;
reference src/coprocessor/aggregation.h:
AggregationManager with SUM/COUNT/COUNT_WITH_NULL/MAX/MIN aggregators applied
during scans)."""

from __future__ import annotations

import enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


class AggOp(enum.Enum):
    SUM = "sum"
    COUNT = "count"
    COUNT_WITH_NULL = "count_with_null"
    MAX = "max"
    MIN = "min"


class Aggregator:
    def __init__(self, specs: Sequence[Tuple[str, AggOp]]):
        """specs: list of (field, op)."""
        self.specs = list(specs)

    def run(self, rows: Iterable[Dict[str, Any]]) -> List[Optional[Any]]:
        acc: List[Optional[Any]] = [None] * len(self.specs)
        counts = [0] * len(self.specs)
        for row in rows:
            for i, (field, op) in enumerate(self.specs):
                v = row.get(field)
                if op is AggOp.COUNT_WITH_NULL:
                    counts[i] += 1
                    continue
                if v is None:
                    continue
                counts[i] += 1
                if op is AggOp.SUM:
                    acc[i] = v if acc[i] is None else acc[i] + v
                elif op is AggOp.MAX:
                    acc[i] = v if acc[i] is None else max(acc[i], v)
                elif op is AggOp.MIN:
                    acc[i] = v if acc[i] is None else min(acc[i], v)
        out: List[Optional[Any]] = []
        for i, (field, op) in enumerate(self.specs):
            if op in (AggOp.COUNT, AggOp.COUNT_WITH_NULL):
                out.append(counts[i])
            else:
                out.append(acc[i])
        return out
