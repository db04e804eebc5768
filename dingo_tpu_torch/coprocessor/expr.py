"""Expression VM for pushdown predicates (coprocessor v2; port of
dingo_tpu/coprocessor/expr.py).

Reference: src/coprocessor/coprocessor_v2.{h,cc} runs rel-expression
bytecode from the dingo-libexpr submodule (rel::RelRunner,
coprocessor_v2.cc:209-216). This is an original expression evaluator over
the same role: a wire-encodable expression tree evaluated against a row's
field map, with comparison, boolean, arithmetic, membership, mathematical/
string function, cast, and conditional operators.

Wire form: nested lists (JSON friendly) —
    ["and", ["ge", ["field", "age"], ["const", 21]],
            ["in", ["field", "color"], ["const", ["red", "blue"]]]]
    ["mul", ["field", "price"], ["cast", "DOUBLE", ["field", "qty"]]]
    ["if", ["is_null", ["field", "name"]], ["const", "?"],
           ["upper", ["field", "name"]]]
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

_BINOPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "mod": lambda a, b: a % b,
    # math.pow, not **: always a double (SQL POWER), and negative-base
    # fractional exponents raise ValueError (-> unknown) instead of the **
    # operator's complex fallback, which would escape the NULL machinery
    # and huge int exponents can't allocate billion-digit integers
    "pow": lambda a, b: math.pow(_num(a), _num(b)),
    "in": lambda a, b: a in b,
    "concat": lambda a, b: _str(a) + _str(b),
}


def _str(v) -> str:
    if not isinstance(v, str):
        raise TypeError(f"expected string, got {type(v).__name__}")
    return v


def _num(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise TypeError(f"expected number, got {type(v).__name__}")
    return v


# Unary function library (libexpr op set: mathematical/string functions run
# inside rel-expression bytecode, src/coprocessor/coprocessor_v2.cc:209-216).
_UNOPS = {
    "neg": lambda a: -_num(a),
    "abs": lambda a: abs(_num(a)),
    "floor": lambda a: math.floor(_num(a)),
    "ceil": lambda a: math.ceil(_num(a)),
    "sqrt": lambda a: math.sqrt(_num(a)),
    "exp": lambda a: math.exp(_num(a)),
    "ln": lambda a: math.log(_num(a)),
    "lower": lambda a: _str(a).lower(),
    "upper": lambda a: _str(a).upper(),
    "length": lambda a: len(_str(a)),
}

def _cast_bool(v):
    # SQL CAST semantics for strings ('false' is false), not Python
    # truthiness (where any non-empty string would be true)
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0"):
            return False
        raise TypeError(f"cannot cast {v!r} to BOOL")
    return bool(v)


# Cast targets mirror the serial/SQL type names used by SchemaColumn.
# bytes -> VARCHAR decodes utf-8 (UnicodeDecodeError is a ValueError ->
# unknown), never Python repr.
_CASTS = {
    "BIGINT": lambda v: int(v),
    "DOUBLE": lambda v: float(v),
    "VARCHAR": lambda v: v if isinstance(v, str) else v.decode("utf-8")
    if isinstance(v, bytes) else str(v),
    "BOOL": _cast_bool,
}


class ExprError(ValueError):
    pass


class Expr:
    """Compiled expression (validates shape once; eval per row)."""

    def __init__(self, tree: Sequence):
        self._tree = self._validate(tree)

    @classmethod
    def _validate(cls, node) -> List:
        if not isinstance(node, (list, tuple)) or not node:
            raise ExprError(f"bad expr node {node!r}")
        op = node[0]
        if op == "const":
            if len(node) != 2:
                raise ExprError("const takes 1 arg")
            return ["const", node[1]]
        if op == "field":
            if len(node) != 2 or not isinstance(node[1], str):
                raise ExprError("field takes a name")
            return ["field", node[1]]
        if op == "not":
            if len(node) != 2:
                raise ExprError("not takes 1 arg")
            return ["not", cls._validate(node[1])]
        if op in ("and", "or"):
            if len(node) < 3:
                raise ExprError(f"{op} takes >=2 args")
            return [op] + [cls._validate(a) for a in node[1:]]
        if op == "is_null":
            if len(node) != 2:
                raise ExprError("is_null takes 1 arg")
            return ["is_null", cls._validate(node[1])]
        if op == "if":
            if len(node) != 4:
                raise ExprError("if takes cond/then/else")
            return ["if"] + [cls._validate(a) for a in node[1:]]
        if op == "cast":
            if len(node) != 3 or node[1] not in _CASTS:
                raise ExprError(
                    f"cast takes a type in {sorted(_CASTS)} and 1 arg"
                )
            return ["cast", node[1], cls._validate(node[2])]
        if op == "substr":
            # ["substr", s, start, len] — 0-based start, clamped like SQL
            if len(node) != 4:
                raise ExprError("substr takes string/start/len")
            return ["substr"] + [cls._validate(a) for a in node[1:]]
        if op in _UNOPS:
            if len(node) != 2:
                raise ExprError(f"{op} takes 1 arg")
            return [op, cls._validate(node[1])]
        if op in _BINOPS:
            if len(node) != 3:
                raise ExprError(f"{op} takes 2 args")
            return [op, cls._validate(node[1]), cls._validate(node[2])]
        raise ExprError(f"unknown op {op!r}")

    def eval(self, row: Dict[str, Any]) -> Any:
        return self._eval(self._tree, row)

    def matches(self, row: Dict[str, Any]) -> bool:
        try:
            return bool(self.eval(row))
        except _UNKNOWN:
            return False   # SQL unknown (type/domain error) filters the row

    def eval_or_null(self, row: Dict[str, Any]) -> Any:
        """Projection semantics: an unknown-valued expression yields NULL."""
        try:
            return self.eval(row)
        except _UNKNOWN:
            return None

    @classmethod
    def _eval(cls, node: List, row: Dict[str, Any]) -> Any:
        op = node[0]
        if op == "const":
            return node[1]
        if op == "field":
            return row.get(node[1])
        if op == "not":
            v = cls._bool3(node[1], row)
            if v is None:
                raise TypeError("unknown operand")
            return not v
        if op == "and":
            # Kleene three-valued AND: false dominates unknown
            unknown = False
            for a in node[1:]:
                v = cls._bool3(a, row)
                if v is None:
                    unknown = True
                elif not v:
                    return False
            if unknown:
                raise TypeError("unknown operand")
            return True
        if op == "or":
            # Kleene three-valued OR: true dominates unknown
            unknown = False
            for a in node[1:]:
                v = cls._bool3(a, row)
                if v is None:
                    unknown = True
                elif v:
                    return True
            if unknown:
                raise TypeError("unknown operand")
            return False
        if op == "is_null":
            return cls._eval(node[1], row) is None
        if op == "if":
            # SQL CASE: an unknown condition (NULL operand, type mismatch,
            # domain error inside the predicate) selects the ELSE branch
            try:
                cond = cls._eval(node[1], row)
            except _UNKNOWN:
                cond = None
            return cls._eval(node[2] if cond else node[3], row)
        if op == "cast":
            v = cls._eval(node[2], row)
            if v is None:
                raise TypeError("null operand")
            return _CASTS[node[1]](v)
        if op == "substr":
            s = _str(cls._require(node[1], row))
            start = _num(cls._require(node[2], row))
            ln = _num(cls._require(node[3], row))
            if isinstance(start, float) or isinstance(ln, float):
                raise TypeError("substr bounds must be integers")
            start, ln = max(0, start), max(0, ln)
            return s[start:start + ln]
        if op in _UNOPS:
            return _UNOPS[op](cls._require(node[1], row))
        a = cls._require(node[1], row)
        b = cls._require(node[2], row)
        return _BINOPS[op](a, b)

    @classmethod
    def _require(cls, node: List, row: Dict[str, Any]) -> Any:
        v = cls._eval(node, row)
        if v is None:
            raise TypeError("null operand")
        return v

    @classmethod
    def _bool3(cls, node: List, row: Dict[str, Any]):
        """Three-valued truth of a subexpression: True/False, or None when
        the value is NULL or its evaluation errored (SQL unknown)."""
        try:
            v = cls._eval(node, row)
        except _UNKNOWN:
            return None
        return None if v is None else bool(v)


# Errors that make an expression's value "unknown" in SQL terms: type
# mismatches, division by zero, math domain errors (sqrt(-1), ln(0)),
# overflow (exp(1e6)), and bad casts (int("x")).
_UNKNOWN = (TypeError, ArithmeticError, ValueError)


class ExprFilter:
    """ScalarFilter-compatible adapter so the VectorReader's TABLE filter
    mode and scans can take full expressions."""

    def __init__(self, tree: Sequence):
        self.expr = Expr(tree)

    def matches(self, scalar: Dict[str, Any]) -> bool:
        return self.expr.matches(scalar)

    def is_empty(self) -> bool:
        return False
