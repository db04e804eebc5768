"""Query parser for the document index (tantivy query-language subset;
port of dingo_tpu/document/query.py).

Reference: contrib/tantivy-search's QueryParser, reached through
src/document/document_index.h SearchWithQuery. Supported syntax:

    hello world              bare terms (OR by default)
    +must -not               required / excluded terms
    "exact phrase"           phrase (consecutive positions)
    title:hello              term restricted to one text field
    price:[10 TO 20]         inclusive numeric/bytes range
    price:{10 TO 20}         exclusive range ([ / { mix freely per end)
    price:[10 TO *]          open-ended range
    flag:true                bool column equality
    AND                      switch default conjunction to AND

Produces a ParsedQuery of text terms, phrases, and typed ColumnPredicates
that DocumentIndex.search_query evaluates.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Tuple

from dingo_tpu_torch.document.index import tokenize


class QueryParseError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ColumnPredicate:
    """Typed column constraint. op: eq | range (lo/hi, each optional);
    negate inverts the match (the parser's -field:... form)."""

    field: str
    op: str
    value: Any = None
    lo: Any = None
    hi: Any = None
    incl_lo: bool = True
    incl_hi: bool = True
    negate: bool = False

    def matches(self, doc: dict) -> bool:
        hit = self._matches_positive(doc)
        return not hit if self.negate else hit

    def _matches_positive(self, doc: dict) -> bool:
        v = doc.get(self.field)
        if v is None:
            return False
        try:
            if self.op == "eq":
                return v == self.value
            if self.lo is not None:
                if v < self.lo or (not self.incl_lo and v == self.lo):
                    return False
            if self.hi is not None:
                if v > self.hi or (not self.incl_hi and v == self.hi):
                    return False
            return True
        except TypeError:
            return False


@dataclasses.dataclass
class ParsedQuery:
    terms: List[str] = dataclasses.field(default_factory=list)
    required: List[str] = dataclasses.field(default_factory=list)
    excluded: List[str] = dataclasses.field(default_factory=list)
    phrases: List[List[str]] = dataclasses.field(default_factory=list)
    #: -"..." phrases: docs containing them are dropped
    neg_phrases: List[List[str]] = dataclasses.field(default_factory=list)
    #: (field, term) pairs — term must appear in that text field
    field_terms: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)
    predicates: List[ColumnPredicate] = dataclasses.field(
        default_factory=list)
    mode: str = "or"


_TOKEN_SPLIT = re.compile(
    r'[+-]?"[^"]*"'                 # quoted phrase (optionally signed)
    r"|[+-]?\w+:[\[{][^\]}]*[\]}]"  # field:[lo TO hi] (spans spaces)
    r"|\S+"                         # everything else
)
_RANGE = re.compile(
    r"^(?P<open>[\[{])\s*(?P<lo>[^ ]+)\s+TO\s+(?P<hi>[^ ]+)\s*"
    r"(?P<close>[\]}])$"
)


def _coerce(raw: str, schema_type: Optional[str]) -> Any:
    """Typed literal per the column's schema (i64/f64/bytes/bool/text)."""
    if raw == "*":
        return None
    if schema_type == "i64":
        try:
            return int(raw)
        except ValueError as e:
            raise QueryParseError(f"bad i64 literal {raw!r}") from e
    if schema_type == "f64":
        try:
            return float(raw)
        except ValueError as e:
            raise QueryParseError(f"bad f64 literal {raw!r}") from e
    if schema_type == "bool":
        if raw.lower() in ("true", "1"):
            return True
        if raw.lower() in ("false", "0"):
            return False
        raise QueryParseError(f"bad bool literal {raw!r}")
    if schema_type == "bytes":
        return raw.encode()
    # untyped / text: best-effort numeric, else string
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return raw


def parse_query(query: str, schema: Optional[dict] = None) -> ParsedQuery:
    """schema: column name -> type string ("text"/"i64"/"f64"/"bytes"/
    "bool"); None = schemaless (numeric literals coerced best-effort)."""
    out = ParsedQuery()
    schema = schema or {}
    for m in _TOKEN_SPLIT.finditer(query):
        tok = m.group(0)
        if tok == "AND":
            out.mode = "and"
            continue
        if tok == "OR":
            out.mode = "or"
            continue
        sign = ""
        if tok[:1] in "+-" and len(tok) > 1:
            sign, tok = tok[0], tok[1:]
        if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
            words = tokenize(tok[1:-1])
            if words:
                if sign == "-":
                    out.neg_phrases.append(words)
                else:
                    out.phrases.append(words)
                    out.terms.extend(words)
            continue
        if ":" in tok:
            field, _, rest = tok.partition(":")
            ftype = schema.get(field)
            rm = _RANGE.match(rest)
            if rm:
                lo = _coerce(rm.group("lo"), ftype)
                hi = _coerce(rm.group("hi"), ftype)
                out.predicates.append(ColumnPredicate(
                    field=field, op="range", lo=lo, hi=hi,
                    incl_lo=rm.group("open") == "[",
                    incl_hi=rm.group("close") == "]",
                    negate=sign == "-",
                ))
                continue
            if ftype in ("i64", "f64", "bytes", "bool"):
                out.predicates.append(ColumnPredicate(
                    field=field, op="eq", value=_coerce(rest, ftype),
                    negate=sign == "-"))
                continue
            # text field restriction
            for w in tokenize(rest):
                out.field_terms.append((field, w))
                out.terms.append(w)
            continue
        for w in tokenize(tok):
            if sign == "+":
                out.required.append(w)
            elif sign == "-":
                out.excluded.append(w)
                continue
            out.terms.append(w)
    # required terms also score
    for w in out.required:
        if w not in out.terms:
            out.terms.append(w)
    return out
