"""In-flight dedupe plan (port of dingo_tpu/cache/dedupe.py): collapse
identical query rows inside one coalescer flush to a single kernel row
fanned out to every waiter.

Within one flush every entry shares the coalescer key (same region, topk
and resolved scalar parameters), so row identity is decided by the query
bytes alone: rows are keyed by ops/digest.py's row fingerprint over their
raw bytes (the 64-bit collision risk the integrity plane accepts). The
stacked batch shrinks before padding, so a 17-unique-row flush stages and
pads like any 17-row batch, whatever its fan-out.

Budget and priority:

- the plan is built from the post-expiry survivors, so an expired member
  has already failed its own future and cannot drag its siblings down,
  and the live siblings of an expired duplicate still get their row;
- survivors are priority-sorted before planning and the first occurrence
  wins the kernel slot, so a collapsed row sits at its most urgent
  member's position;
- expiry estimates price the deduped row count (the kernel work actually
  bought), and every member's own budget is still checked at flush time.

Host-side numpy over host arrays only.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from dingo_tpu_torch.ops.digest import row_fingerprints


def _stack(entries: Sequence[Any]) -> np.ndarray:
    return np.concatenate([e.queries for e in entries], axis=0)


def _row_keys(stacked: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(stacked)
    return row_fingerprints(
        "cache.dedupe", np.zeros(len(q), np.int64), q
    )


class DedupePlan:
    """One flush's collapse map.

    ``stacked``  — [u, d] unique rows, first occurrence order (entries
                   are pre-sorted highest-priority-first, so a shared
                   row dispatches at its most urgent member's position);
    ``fanout``   — per entry, an int array mapping each of ITS rows to a
                   unique-row index;
    ``collapsed``— duplicate rows removed from the kernel batch.
    """

    __slots__ = ("stacked", "fanout", "collapsed")

    def __init__(self, stacked: np.ndarray, fanout: List[np.ndarray],
                 collapsed: int):
        self.stacked = stacked
        self.fanout = fanout
        self.collapsed = collapsed

    def rows_for(self, i: int, results: Sequence) -> list:
        """Entry i's result rows out of the unique-batch results. A row
        shared by several waiters fans the SAME result object out to each
        — downstream treats reply rows as read-only."""
        return [results[int(j)] for j in self.fanout[i]]


def deduped_rows(entries: Sequence[Any]) -> int:
    """Unique-row count of a prospective flush — the kernel batch size
    dedupe would actually buy. Used by expiry estimation BEFORE the
    survivor plan exists (over-counts vs the survivors' plan, which only
    makes the hopeless-shed arm more conservative)."""
    if not entries:
        return 0
    return len(np.unique(_row_keys(_stack(entries))))


def build_plan(entries: Sequence[Any]) -> Optional[DedupePlan]:
    """Collapse map for the (post-expiry, priority-sorted) survivors.
    Returns None when nothing collapses — the caller keeps the plain
    contiguous-slice path, zero behavior change."""
    if not entries:
        return None
    stacked = _stack(entries)
    keys = _row_keys(stacked)
    first: dict = {}
    uidx: List[int] = []
    flat = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys.tolist()):
        j = first.get(k)
        if j is None:
            j = first[k] = len(uidx)
            uidx.append(i)
        flat[i] = j
    collapsed = len(keys) - len(uidx)
    if collapsed <= 0:
        return None
    fanout: List[np.ndarray] = []
    off = 0
    for e in entries:
        n = len(e.queries)
        fanout.append(flat[off:off + n].copy())
        off += n
    return DedupePlan(np.ascontiguousarray(stacked[uidx]), fanout,
                      collapsed)
