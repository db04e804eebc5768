"""DocumentIndex: BM25 inverted index with typed columns + range queries
(port of dingo_tpu/document/index.py).

Reference: src/document/document_index.h wraps tantivy (tokenized text
fields + i64/f64/bytes/bool columns; queries are boolean text matches with
optional column constraints, parsed from tantivy query syntax). This is an
original implementation covering that surface: tokenization, positional
postings with term frequencies, BM25 ranking, AND/OR boolean modes, PHRASE
queries (consecutive positions), field-restricted terms, typed column
schema with validation, sorted column indexes serving range queries, a
query parser (document/query.py), delete/upsert, save/load.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import threading
from collections import defaultdict

from dingo_tpu_torch.common import persist
from typing import Any, Dict, List, Optional, Sequence, Tuple

_TOKEN_RE = re.compile(r"[a-z0-9]+")

FIELD_POSITION_GAP = 1_000_000
BM25_K1 = 1.2
BM25_B = 0.75

#: column types (tantivy schema field kinds we cover)
COLUMN_TYPES = ("text", "i64", "f64", "bytes", "bool")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class SchemaError(ValueError):
    pass


def _check_typed(field: str, ftype: str, value: Any) -> Any:
    """Validate/coerce one column value against its schema type."""
    if ftype == "text":
        if not isinstance(value, str):
            raise SchemaError(f"{field}: expected text, got {type(value)}")
        return value
    if ftype == "i64":
        if isinstance(value, bool) or not isinstance(value, int):
            raise SchemaError(f"{field}: expected i64, got {value!r}")
        return value
    if ftype == "f64":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(f"{field}: expected f64, got {value!r}")
        return float(value)
    if ftype == "bytes":
        if not isinstance(value, (bytes, bytearray)):
            raise SchemaError(f"{field}: expected bytes, got {value!r}")
        return bytes(value)
    if ftype == "bool":
        if not isinstance(value, bool):
            raise SchemaError(f"{field}: expected bool, got {value!r}")
        return value
    raise SchemaError(f"{field}: unknown column type {ftype!r}")


class DocumentIndex:
    def __init__(self, index_id: int, text_fields: Sequence[str] = ("text",),
                 schema: Optional[Dict[str, str]] = None):
        """schema: column name -> type in COLUMN_TYPES. Text-typed schema
        columns are indexed alongside `text_fields`; typed columns are
        validated on add and back the range/eq predicates. schema=None =
        schemaless (everything accepted, filters compare raw values)."""
        self.id = index_id
        self.text_fields = list(text_fields)
        self.schema = dict(schema) if schema else None
        if self.schema:
            for f, t in self.schema.items():
                if t not in COLUMN_TYPES:
                    raise SchemaError(f"{f}: unknown column type {t!r}")
            for f, t in self.schema.items():
                if t == "text" and f not in self.text_fields:
                    self.text_fields.append(f)
        self._lock = threading.RLock()
        #: term -> {doc_id: [positions]} (tf == len(positions))
        self._postings: Dict[str, Dict[int, List[int]]] = defaultdict(dict)
        #: doc_id -> (doc dict, token_count)
        self._docs: Dict[int, Tuple[Dict[str, Any], int]] = {}
        #: doc_id -> {text_field: (pos_start, pos_end)} for field-restricted
        #: terms (recomputed on load — derived from the doc text)
        self._field_spans: Dict[int, Dict[str, Tuple[int, int]]] = {}
        #: typed column -> sorted [(value, doc_id)] (lazy; None = dirty)
        self._column_sorted: Dict[str, Optional[list]] = {}
        self._total_tokens = 0
        self.apply_log_id = 0

    # ---------------- mutation ----------------
    def check_doc(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Validate/coerce a doc against the schema (raises SchemaError).
        Service handlers call this BEFORE proposing through raft so an
        invalid doc never enters the log."""
        if not self.schema:
            return doc
        return {
            k: (_check_typed(k, self.schema[k], v)
                if k in self.schema else v)
            for k, v in doc.items()
        }

    def add(self, doc_id: int, doc: Dict[str, Any]) -> None:
        doc = self.check_doc(doc)
        with self._lock:
            if doc_id in self._docs:
                self._remove_unlocked(doc_id)
            ntok = 0
            pos = 0
            spans: Dict[str, Tuple[int, int]] = {}
            for field in self.text_fields:
                value = doc.get(field)
                if not isinstance(value, str):
                    continue
                start = pos
                for tok in tokenize(value):
                    self._postings[tok].setdefault(doc_id, []).append(pos)
                    pos += 1
                    ntok += 1
                spans[field] = (start, pos)
                # position gap between fields so a phrase cannot match
                # across a field boundary (tantivy parity)
                pos += FIELD_POSITION_GAP
            self._docs[doc_id] = (dict(doc), ntok)
            self._field_spans[doc_id] = spans
            self._total_tokens += ntok
            self._dirty_columns(doc)

    upsert = add

    def delete(self, doc_ids: Sequence[int]) -> int:
        with self._lock:
            n = 0
            for did in doc_ids:
                if did in self._docs:
                    self._remove_unlocked(int(did))
                    n += 1
            return n

    def _remove_unlocked(self, doc_id: int) -> None:
        doc, ntok = self._docs.pop(doc_id)
        self._field_spans.pop(doc_id, None)
        self._total_tokens -= ntok
        for field in self.text_fields:
            value = doc.get(field)
            if isinstance(value, str):
                for tok in set(tokenize(value)):
                    entry = self._postings.get(tok)
                    if entry is not None:
                        entry.pop(doc_id, None)
                        if not entry:
                            del self._postings[tok]
        self._dirty_columns(doc)

    def _dirty_columns(self, doc: Dict[str, Any]) -> None:
        if not self.schema:
            return
        for f, t in self.schema.items():
            if t in ("i64", "f64", "bytes") and f in doc:
                self._column_sorted[f] = None

    # ---------------- typed column index ------------------------------------
    def _sorted_column(self, field: str) -> Tuple[list, list]:
        """(sorted values, doc_ids aligned) for a typed column — cached
        together so bisect lookups stay O(log n) after the one-time build
        (lazy rebuild on mutation)."""
        cached = self._column_sorted.get(field)
        if cached is not None:
            return cached
        pairs = []
        for did, (doc, _n) in self._docs.items():
            v = doc.get(field)
            if v is not None:
                pairs.append((v, did))
        pairs.sort()
        cached = ([p[0] for p in pairs], [p[1] for p in pairs])
        self._column_sorted[field] = cached
        return cached

    def range_select(self, field: str, lo=None, hi=None,
                     incl_lo: bool = True, incl_hi: bool = True) -> List[int]:
        """Doc ids whose column lies in the range. Schema-typed columns
        ride the sorted column index (bisect); schemaless columns fall
        back to a per-doc scan with safe comparisons (mixed value types
        cannot sort, and nothing invalidates a schemaless cache)."""
        with self._lock:
            ftype = self.schema.get(field) if self.schema else None
            if self.schema and ftype not in ("i64", "f64", "bytes"):
                raise SchemaError(f"{field}: not a range-indexable column")
            if ftype is None:
                out = []
                for did, (doc, _n) in self._docs.items():
                    v = doc.get(field)
                    if v is None:
                        continue
                    try:
                        if lo is not None and (
                            v < lo or (not incl_lo and v == lo)
                        ):
                            continue
                        if hi is not None and (
                            v > hi or (not incl_hi and v == hi)
                        ):
                            continue
                    except TypeError:
                        continue
                    out.append(did)
                return sorted(out)
            values, doc_ids = self._sorted_column(field)
            i = 0
            if lo is not None:
                i = (bisect.bisect_left(values, lo) if incl_lo
                     else bisect.bisect_right(values, lo))
            j = len(values)
            if hi is not None:
                j = (bisect.bisect_right(values, hi) if incl_hi
                     else bisect.bisect_left(values, hi))
            return sorted(doc_ids[i:j])

    # ---------------- search ----------------
    def search(
        self,
        query: str,
        topk: int = 10,
        mode: str = "or",
        column_filter: Optional[Dict[str, Any]] = None,
    ) -> List[Tuple[int, float]]:
        """BM25-ranked (doc_id, score), best first.
        mode: 'or' | 'and' | 'phrase' (terms at consecutive positions)
        | 'query' (full parser syntax — document/query.py)."""
        if mode == "query":
            from dingo_tpu_torch.document.query import parse_query

            return self.search_query(
                parse_query(query, self.schema), topk,
                column_filter=column_filter,
            )
        terms = tokenize(query)
        if not terms:
            return []
        with self._lock:
            scores = self._bm25_unlocked(terms)
            hits = scores.items()
            if mode == "phrase":
                hits = [
                    (did, sc) for did, sc in scores.items()
                    if self._phrase_match_unlocked(did, terms)
                ]
            elif mode == "and":
                need = len(set(terms))
                uniq_matched: Dict[int, set] = defaultdict(set)
                for term in set(terms):
                    for did in self._postings.get(term, {}):
                        uniq_matched[did].add(term)
                hits = [
                    (did, sc) for did, sc in scores.items()
                    if len(uniq_matched.get(did, ())) >= need
                ]
            if column_filter:
                hits = [
                    (did, sc) for did, sc in hits
                    if all(self._docs[did][0].get(k) == v
                           for k, v in column_filter.items())
                ]
            return sorted(hits, key=lambda t: (-t[1], t[0]))[:topk]

    def search_query(self, pq, topk: int = 10,
                     column_filter: Optional[Dict[str, Any]] = None
                     ) -> List[Tuple[int, float]]:
        """Evaluate a ParsedQuery (document/query.py): scored text terms,
        +required/-excluded, phrases, field-restricted terms, and typed
        column predicates (ranges ride the sorted column index)."""
        with self._lock:
            if pq.terms:
                scores = self._bm25_unlocked(pq.terms)
                if pq.mode == "and":
                    need = set(pq.terms)
                    scores = {
                        did: sc for did, sc in scores.items()
                        if all(did in self._postings.get(t, {})
                               for t in need)
                    }
            elif pq.predicates:
                # pure column query: candidates from the POSITIVE
                # predicates' column indexes (negated ones cannot generate
                # candidates and filter below; all-negative queries
                # evaluate against every doc, like tantivy's all-query)
                cand: Optional[set] = None
                for p in pq.predicates:
                    if p.negate:
                        continue
                    if p.op == "range":
                        ids = set(self.range_select(
                            p.field, p.lo, p.hi, p.incl_lo, p.incl_hi))
                    else:
                        ids = {
                            did for did, (doc, _n) in self._docs.items()
                            if doc.get(p.field) == p.value
                        }
                    cand = ids if cand is None else (cand & ids)
                if cand is None:
                    cand = set(self._docs)
                scores = {did: 1.0 for did in cand}
                for p in pq.predicates:
                    if p.negate:
                        scores = {
                            d: s for d, s in scores.items()
                            if p.matches(self._docs[d][0])
                        }
            else:
                return []
            for t in pq.required:
                post = self._postings.get(t, {})
                scores = {d: s for d, s in scores.items() if d in post}
            for t in pq.excluded:
                post = self._postings.get(t, {})
                scores = {d: s for d, s in scores.items() if d not in post}
            for phrase in pq.phrases:
                scores = {
                    d: s for d, s in scores.items()
                    if self._phrase_match_unlocked(d, phrase)
                }
            for phrase in getattr(pq, "neg_phrases", ()):
                scores = {
                    d: s for d, s in scores.items()
                    if not self._phrase_match_unlocked(d, phrase)
                }
            for field, term in pq.field_terms:
                scores = {
                    d: s for d, s in scores.items()
                    if self._term_in_field_unlocked(d, field, term)
                }
            if pq.terms and pq.predicates:
                for p in pq.predicates:
                    scores = {
                        d: s for d, s in scores.items()
                        if p.matches(self._docs[d][0])
                    }
            if column_filter:
                scores = {
                    d: s for d, s in scores.items()
                    if all(self._docs[d][0].get(k) == v
                           for k, v in column_filter.items())
                }
            return sorted(
                scores.items(), key=lambda t: (-t[1], t[0])
            )[:topk]

    def _bm25_unlocked(self, terms: List[str]) -> Dict[int, float]:
        n_docs = len(self._docs)
        if n_docs == 0:
            return {}
        avg_len = self._total_tokens / n_docs
        scores: Dict[int, float] = defaultdict(float)
        for term in terms:
            postings = self._postings.get(term)
            if not postings:
                continue
            idf = math.log(1 + (n_docs - len(postings) + 0.5)
                           / (len(postings) + 0.5))
            for did, positions in postings.items():
                tf = len(positions)
                dlen = self._docs[did][1] or 1
                denom = tf + BM25_K1 * (
                    1 - BM25_B + BM25_B * dlen / max(avg_len, 1e-9)
                )
                scores[did] += idf * tf * (BM25_K1 + 1) / denom
        return scores

    def _phrase_match_unlocked(self, doc_id: int,
                               terms: List[str]) -> bool:
        """True when the terms occur at consecutive positions in order."""
        lists = []
        for term in terms:
            positions = self._postings.get(term, {}).get(doc_id)
            if not positions:
                return False
            lists.append(set(positions))
        return any(
            all(start + i in lists[i] for i in range(1, len(lists)))
            for start in lists[0]
        )

    def _term_in_field_unlocked(self, doc_id: int, field: str,
                                term: str) -> bool:
        span = self._field_spans.get(doc_id, {}).get(field)
        if span is None:
            return False
        positions = self._postings.get(term, {}).get(doc_id)
        if not positions:
            return False
        lo, hi = span
        return any(lo <= p < hi for p in positions)

    def get(self, doc_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._docs.get(doc_id)
            return entry[0] if entry else None

    def count(self) -> int:
        with self._lock:
            return len(self._docs)

    # ---------------- persistence ----------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with self._lock:
            blob = persist.dumps({
                "postings": dict(self._postings),
                "docs": self._docs,
                "total_tokens": self._total_tokens,
            })
        with open(os.path.join(path, "document.idx"), "wb") as f:
            f.write(blob)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({
                "text_fields": self.text_fields,
                "apply_log_id": self.apply_log_id,
                "schema": self.schema,
            }, f)

    def load(self, path: str) -> None:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "document.idx"), "rb") as f:
            state = persist.loads(f.read())
        with self._lock:
            self.text_fields = meta["text_fields"]
            self.apply_log_id = meta["apply_log_id"]
            self.schema = meta.get("schema")
            postings = state["postings"]
            # migrate pre-positional snapshots ({doc: tf} ints): synthesize
            # positions so BM25 keeps working; phrase matches degrade to
            # position-0 runs until the doc is re-upserted
            for term, docs in postings.items():
                for did, val in list(docs.items()):
                    if isinstance(val, int):
                        docs[did] = list(range(val))
            self._postings = defaultdict(dict, postings)
            self._docs = state["docs"]
            self._total_tokens = state["total_tokens"]
            # field spans + column indexes are derived state: recompute
            # spans from the stored docs (same deterministic walk as add)
            self._field_spans = {}
            self._column_sorted = {}
            for did, (doc, _n) in self._docs.items():
                pos = 0
                spans: Dict[str, Tuple[int, int]] = {}
                for field in self.text_fields:
                    value = doc.get(field)
                    if not isinstance(value, str):
                        continue
                    start = pos
                    pos += len(tokenize(value))
                    spans[field] = (start, pos)
                    pos += FIELD_POSITION_GAP
                self._field_spans[did] = spans
