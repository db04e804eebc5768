"""CoprocessorV2: typed-schema pushdown over serial-encoded table rows
(port of dingo_tpu/coprocessor/coprocessor_v2.py).

Reference: src/coprocessor/coprocessor_v2.{h,cc} — holds original/result
serial schemas + selection column indexes (coprocessor_v2.h:102-111), runs
rel-expression bytecode (rel::RelRunner from dingo-libexpr,
coprocessor_v2.cc:209-216) against each decoded row during a scan, then
projects (selection) and optionally aggregates (AggregationManager,
aggregation.h). This module plays the same role over dingo_tpu's pieces:
`common/serial.py` typed rows, the `coprocessor/expr.py` VM as the
expression engine, and a grouped aggregation manager.

Row wire format: a row VALUE is the concatenation of `serial.encode_value`
for each column in schema order (order-preserving typed encoding, so rows
are also memcomparable per column).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from dingo_tpu_torch.common import serial
from dingo_tpu_torch.coprocessor.expr import Expr


class CoprocessorError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class SchemaColumn:
    name: str
    sql_type: str = "VARCHAR"    # BIGINT/DOUBLE/VARCHAR/BOOL/BYTES
    index: int = 0


class AggOpV2(enum.Enum):
    """AggregationManager operator set (aggregation.h)."""

    SUM = 1
    COUNT = 2
    COUNT_WITH_NULL = 3
    MAX = 4
    MIN = 5
    SUM0 = 6     # like SUM but 0 (not NULL) over an empty group


@dataclasses.dataclass
class AggregationSpec:
    op: AggOpV2
    column_index: int = -1       # original-schema column; -1 for COUNT(*)
    expr: Optional[list] = None  # aggregate over an expression instead


@dataclasses.dataclass
class CoprocessorDef:
    """pb::store::Coprocessor analog.

    `selection` entries are original-schema column indexes (ints) or
    expr.py wire trees (lists) — the reference's rel-expression projection
    step evaluates arbitrary expressions per output column
    (coprocessor_v2.cc RelRunner::Put -> projection operators)."""

    original_schema: List[SchemaColumn]
    selection: List[Any] = dataclasses.field(default_factory=list)
    filter_expr: Optional[list] = None          # expr.py wire tree
    group_by: List[int] = dataclasses.field(default_factory=list)
    aggregations: List[AggregationSpec] = dataclasses.field(
        default_factory=list
    )


def encode_row(values: Sequence[Any]) -> bytes:
    """Row value bytes: concatenated typed encodings in schema order."""
    return b"".join(serial.encode_value(v) for v in values)


_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def _encode_out_row(values: Sequence[Any]) -> bytes:
    """Encode a COMPUTED output row (expression projection / aggregation).

    Computed values can fall outside what the typed codec represents —
    ints past int64 (encode_value would silently wrap them) or unencodable
    types (a list const). Both become CoprocessorError (a ValueError), which
    the scan RPCs report as a coprocessor error instead of crashing."""
    for v in values:
        if (isinstance(v, int) and not isinstance(v, bool)
                and not _INT64_MIN <= v <= _INT64_MAX):
            raise CoprocessorError(f"projected integer {v} overflows int64")
    try:
        return encode_row(values)
    except (TypeError, ValueError) as e:
        raise CoprocessorError(f"unencodable projected value: {e}") from e


def decode_row(blob: bytes, ncols: int) -> List[Any]:
    out, offset = [], 0
    for _ in range(ncols):
        v, offset = serial.decode_value(blob, offset)
        out.append(v)
    return out


class _Group:
    __slots__ = ("accs", "counts")

    def __init__(self, n: int):
        self.accs: List[Any] = [None] * n
        self.counts = [0] * n


class CoprocessorV2:
    """Filter -> project | group+aggregate over decoded rows."""

    def __init__(self, defn: CoprocessorDef):
        self.defn = defn
        ncols = len(defn.original_schema)
        self._proj: List[Any] = []   # int column index | compiled Expr
        for sel in defn.selection:
            if isinstance(sel, (list, tuple)):
                self._proj.append(Expr(sel))
            elif isinstance(sel, int) and 0 <= sel < ncols:
                self._proj.append(sel)
            else:
                raise CoprocessorError(f"bad selection entry {sel!r}")
        for idx in defn.group_by:
            if not 0 <= idx < ncols:
                raise CoprocessorError(f"column index {idx} out of range")
        self._agg_exprs: List[Optional[Expr]] = []
        for a in defn.aggregations:
            if a.expr is not None:
                self._agg_exprs.append(Expr(a.expr))
            elif a.column_index >= ncols or a.column_index < -1:
                # -1 is the COUNT(*) sentinel; anything else negative is a
                # caller bug that would silently aggregate the literal 1
                raise CoprocessorError(
                    f"aggregation column {a.column_index} out of range"
                )
            else:
                self._agg_exprs.append(None)
        self._names = [c.name for c in defn.original_schema]
        self._expr = (
            Expr(defn.filter_expr) if defn.filter_expr is not None else None
        )

    # -- row-at-a-time (RawCoprocessor::Filter contract) ---------------------
    def decode(self, value: bytes) -> List[Any]:
        return decode_row(value, len(self.defn.original_schema))

    def _fields(self, row: List[Any]) -> Dict[str, Any]:
        return dict(zip(self._names, row))

    def _needs_fields(self) -> bool:
        return (
            self._expr is not None
            or any(not isinstance(s, int) for s in self._proj)
            or any(e is not None for e in self._agg_exprs)
        )

    def filter_row(self, row: List[Any], fields=None) -> bool:
        if self._expr is None:
            return True
        # SQL WHERE semantics: a NULL operand / type mismatch / math-domain
        # error makes the predicate unknown, and unknown rows are not selected
        return self._expr.matches(
            self._fields(row) if fields is None else fields
        )

    def project(self, row: List[Any], fields=None) -> List[Any]:
        if not self._proj:
            return row
        out = []
        for sel in self._proj:
            if isinstance(sel, int):
                out.append(row[sel])
            else:
                if fields is None:
                    fields = self._fields(row)
                out.append(sel.eval_or_null(fields))
        return out

    # -- scan execution (CoprocessorV2::Execute contract) --------------------
    def execute(
        self, kvs: Iterable[Tuple[bytes, bytes]], limit: int = 0
    ) -> List[Tuple[bytes, bytes]]:
        """Run over scan output. Without aggregations: (key, projected-row)
        for rows passing the filter, stopping at `limit` matches (0 =
        unlimited). With aggregations: one row per group (limit applies to
        the grouped output), key = encoded group-by values (b"" for the
        global group)."""
        make_fields = self._needs_fields()   # one field map per row, shared
        if not self.defn.aggregations:
            # computed columns need the overflow/encodability guard; plain
            # column re-emission round-trips decoded values and cannot
            # produce an unencodable one — skip the per-value scan
            computed = any(not isinstance(s, int) for s in self._proj)
            enc = _encode_out_row if computed else encode_row
            out = []
            for k, v in kvs:
                row = self.decode(v)
                fields = self._fields(row) if make_fields else None
                if self.filter_row(row, fields):
                    out.append((k, enc(self.project(row, fields))))
                    if limit and len(out) >= limit:
                        break
            return out

        groups: Dict[bytes, _Group] = {}
        nagg = len(self.defn.aggregations)
        for _k, v in kvs:
            row = self.decode(v)
            fields = self._fields(row) if make_fields else None
            if not self.filter_row(row, fields):
                continue
            gkey = encode_row([row[i] for i in self.defn.group_by])
            g = groups.get(gkey)
            if g is None:
                g = groups[gkey] = _Group(nagg)
            for i, spec in enumerate(self.defn.aggregations):
                agg_expr = self._agg_exprs[i]
                if agg_expr is not None:
                    val = agg_expr.eval_or_null(fields)
                else:
                    val = row[spec.column_index] if spec.column_index >= 0 else 1
                op = spec.op
                if op is AggOpV2.COUNT_WITH_NULL:
                    g.counts[i] += 1
                    continue
                if val is None:
                    continue
                g.counts[i] += 1
                acc = g.accs[i]
                if op in (AggOpV2.SUM, AggOpV2.SUM0):
                    g.accs[i] = val if acc is None else acc + val
                elif op is AggOpV2.COUNT:
                    pass  # counts[i] carries it
                elif op is AggOpV2.MAX:
                    g.accs[i] = val if acc is None else max(acc, val)
                elif op is AggOpV2.MIN:
                    g.accs[i] = val if acc is None else min(acc, val)
        out = []
        for gkey in sorted(groups):
            g = groups[gkey]
            row_out: List[Any] = []
            for i, spec in enumerate(self.defn.aggregations):
                if spec.op in (AggOpV2.COUNT, AggOpV2.COUNT_WITH_NULL):
                    row_out.append(g.counts[i])
                elif spec.op is AggOpV2.SUM0:
                    row_out.append(0 if g.accs[i] is None else g.accs[i])
                else:
                    row_out.append(g.accs[i])
            out.append((gkey, _encode_out_row(row_out)))
        return out[:limit] if limit else out
