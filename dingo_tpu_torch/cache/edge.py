"""Serving-edge glue (port of dingo_tpu/cache/edge.py): cache lookup at
admission, fill after dispatch.

This is the layer services.py (and bench/tests) talk to; it composes the
key derivation (keys.py), the LRU store (store.py), and the policy gates
(policy.py) into two calls wrapped around the coalescer submit:

- ``lookup()`` BEFORE submit — a fully-hit request never touches the
  QoS queue (a hit costs no queue slot, no admission estimate, no
  tenant-row charge) and never dispatches a kernel; a partial hit
  submits only its miss rows.
- ``fill()`` AFTER results return — inserts the fresh rows at the
  version read BEFORE dispatch, and only if the live version still
  matches: a write that landed mid-flight means the rows we hold may
  predate it, and caching them at the new version would serve stale
  bytes as exact.

Tier order per row: exact (live version) → stale (bounded versions
behind, only while the shed ladder is degraded) → semantic (sq8-rounded
fingerprint, only while the shadow-quality estimator attests the recall
SLO). Semantic hits are handed to the estimator for sampling like any
other served reply — the gate that admits them is fed by the replies it
admits.

Everything is host-side; the index is only passed through to
QUALITY.observe_search, which owns its own sampling budget.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from dingo_tpu_torch.cache import keys as cache_keys
from dingo_tpu_torch.cache import policy
from dingo_tpu_torch.cache.keys import SemanticCodec
from dingo_tpu_torch.cache.store import ResultCache

#: process-global singletons (the PRESSURE/QUALITY pattern)
CACHE = ResultCache()
CODECS = SemanticCodec()


def active() -> bool:
    """Result-cache serving is on: subsystem enabled AND a byte budget
    exists (max_bytes = 0 leaves dedupe while disabling the store)."""
    return policy.cache_enabled() and CACHE.max_bytes() > 0


def index_version(index: Any) -> Optional[int]:
    """``SlotStore.mutation_version`` under an index (or index wrapper),
    read host-side; None when the object doesn't carry one (caching is
    skipped for it)."""
    if index is None:
        return None
    if hasattr(index, "own_index"):
        index = index.own_index
        if index is None:
            return None
    store = getattr(index, "store", None)
    ver = getattr(store, "mutation_version", None)
    if ver is None:
        return None
    try:
        return int(ver)
    except (TypeError, ValueError):
        return None


def region_version(region: Any) -> Optional[int]:
    """index_version through a Region's vector_index_wrapper."""
    return index_version(getattr(region, "vector_index_wrapper", None))


class EdgeLookup:
    """One request's per-row lookup outcome.

    ``rows``     — per query row: cached reply rows, or None (miss);
    ``miss_idx`` — indices of the miss rows (dispatch exactly these);
    ``fps``      — exact-tier fingerprints for every row (fill reuses
                   them so key derivation happens once);
    ``seed``     — the params seed the fingerprints bound to (the
                   semantic namespace binds to the same seed at fill);
    ``version``  — the mutation_version the lookup keyed on.
    """

    __slots__ = ("rows", "miss_idx", "fps", "seed", "version")

    def __init__(self, rows, miss_idx, fps, seed, version):
        self.rows = rows
        self.miss_idx = miss_idx
        self.fps = fps
        self.seed = seed
        self.version = version

    @property
    def complete(self) -> bool:
        return len(self.miss_idx) == 0

    @property
    def any_hit(self) -> bool:
        return len(self.miss_idx) < len(self.rows)

    def merge(self, miss_results: Sequence) -> List[list]:
        """Final per-row reply: cached rows where they hit, dispatched
        rows (in miss_idx order) where they didn't."""
        out = list(self.rows)
        for j, i in enumerate(self.miss_idx):
            out[int(i)] = miss_results[j]
        return out


def lookup(region_id: int, queries: np.ndarray, topn: int,
           kw_items: Tuple, version: Optional[int],
           index: Any = None) -> Optional[EdgeLookup]:
    """Per-row cache consult for one plain search. Returns None when the
    cache cannot serve at all (disabled / no version available) — the
    caller proceeds exactly as before. Misses are accounted here."""
    if version is None or not active():
        return None
    q = np.asarray(queries)
    if q.ndim != 2 or len(q) == 0:
        return None
    seed = cache_keys.params_seed(int(topn), kw_items)
    fps = cache_keys.query_fingerprints(q, seed)
    stale = policy.stale_versions_allowed(region_id)
    rows: List[Optional[list]] = []
    miss: List[int] = []
    for i, fp in enumerate(fps.tolist()):
        got = CACHE.lookup(region_id, fp, version, stale_versions=stale)
        rows.append(got)
        if got is None:
            miss.append(i)
    # semantic tier: only rows the exact/stale tiers missed, only while
    # the SLO gate holds, only once the per-region codec is trained
    if miss and policy.semantic_allowed(region_id):
        codes = CODECS.encode(region_id, q[miss])
        if codes is not None:
            sem_fps = cache_keys.semantic_fingerprints(codes, seed)
            still: List[int] = []
            served_rows: List[list] = []
            served_q: List[int] = []
            for j, i in enumerate(miss):
                got = CACHE.lookup(region_id, sem_fps[j], version,
                                   stale_versions=stale, semantic=True)
                rows[i] = got
                if got is None:
                    still.append(i)
                else:
                    served_q.append(i)
                    served_rows.append(got)
            miss = still
            if served_rows and index is not None:
                _sample_semantic(index, q[served_q], int(topn),
                                 served_rows)
    if miss:
        CACHE.note_miss(region_id, len(miss))
    return EdgeLookup(rows, np.asarray(miss, np.int64), fps, seed,
                      int(version))


def _sample_semantic(index, queries: np.ndarray, topk: int,
                     rows: Sequence[list]) -> None:
    """Hand approximate hits to the shadow-quality estimator: the gate
    that admits them must keep seeing the replies it admits. Sampling
    failures never fail serving."""
    try:
        from dingo_tpu_torch.obs.quality import QUALITY

        n = min(len(queries), len(rows))
        width = max((len(r) for r in rows[:n]), default=0)
        if n == 0 or width == 0:
            return
        ids = np.full((n, width), -1, np.int64)
        dists = np.full((n, width), np.inf, np.float32)
        for i, r in enumerate(rows[:n]):
            for j, v in enumerate(r[:width]):
                ids[i, j] = v.id
                dists[i, j] = v.distance
        QUALITY.observe_search(index, queries[:n], topk, ids, dists,
                               bucket="cache_semantic")
    except Exception:  # noqa: BLE001 — observability must not fail serving
        pass


def fill(region_id: int, looked: EdgeLookup, miss_results: Sequence,
         version_now: Optional[int], queries: np.ndarray,
         tenant: str = "default") -> None:
    """Insert freshly-dispatched miss rows. ``version_now`` is re-read
    AFTER the results came back: if it moved past the lookup version the
    rows may straddle a write — cache nothing (correct replies were
    still served; only the cache forgoes them)."""
    if not active():
        return
    if version_now is None or int(version_now) != looked.version:
        return
    q = np.asarray(queries)
    sem_on = False
    codes = None
    v = None
    try:
        from dingo_tpu_torch.common.config import FLAGS

        v = FLAGS.get("cache_semantic")
    except Exception:  # noqa: BLE001
        pass
    if isinstance(v, str):
        sem_on = v.strip().lower() in ("true", "1", "on", "yes")
    else:
        sem_on = bool(v)
    if sem_on and len(looked.miss_idx):
        # keep the per-region codec learning from real traffic, then
        # mirror fills into the semantic namespace so near-identical
        # future queries can hit
        CODECS.observe(region_id, q[looked.miss_idx])
        codes = CODECS.encode(region_id, q[looked.miss_idx])
    sem_fps = (cache_keys.semantic_fingerprints(codes, looked.seed)
               if codes is not None else None)
    for j, i in enumerate(looked.miss_idx):
        i = int(i)
        rows = miss_results[j]
        CACHE.put(region_id, looked.fps[i], looked.version, rows,
                  tenant=tenant)
        if sem_fps is not None:
            CACHE.put(region_id, sem_fps[j], looked.version, rows,
                      tenant=tenant)
