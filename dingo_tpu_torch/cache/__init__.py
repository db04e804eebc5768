"""Serving-edge result cache + in-flight query dedupe (port of
dingo_tpu/cache/).

Skewed traffic re-asks the same and near-same queries, and every repeat
bought a full kernel launch. Three rungs close that gap:

- **dedupe.py** — identical query rows inside one coalescer flush
  collapse to a single kernel row fanned out to every waiter (the row
  fingerprints of ops/digest.py; the batch shrinks before padding, so the
  pow2 ladder and the staging rings see the deduped batch).
- **store.py / keys.py** — a bounded per-region result cache keyed
  ``(query fingerprint, SlotStore.mutation_version, resolved params,
  filter fingerprint)``: the version key makes invalidation structural
  (every put/remove/growth bumps it), entries hold the final reply rows
  so a hit equals a fresh dispatch, LRU bounded by ``cache_max_bytes``
  with per-tenant fairness.
- **policy.py / edge.py** — the tier gates and the IndexService glue:
  hits are consulted at admission (a hit costs no queue slot), a
  serve-slightly-stale rung opens only while the shed ladder is degraded,
  and optional sq8-semantic hits (ops/sq.py's codec) serve only while the
  shadow-quality estimator (obs/quality.py) attests the recall SLO.

Everything is host-side: a lookup never touches a device tensor, so it
cannot add a device sync to the admission path.

Off by default (``cache_enabled``); one flag read when off.
"""

from dingo_tpu_torch.cache.dedupe import DedupePlan, build_plan, deduped_rows
from dingo_tpu_torch.cache.edge import (
    CACHE,
    CODECS,
    EdgeLookup,
    active,
    fill,
    index_version,
    lookup,
    region_version,
)
from dingo_tpu_torch.cache.keys import (
    SemanticCodec,
    params_seed,
    query_fingerprints,
    semantic_fingerprints,
)
from dingo_tpu_torch.cache.policy import (
    cache_enabled,
    dedupe_enabled,
    semantic_allowed,
    stale_versions_allowed,
)
from dingo_tpu_torch.cache.store import ResultCache

__all__ = [
    "CACHE",
    "CODECS",
    "DedupePlan",
    "EdgeLookup",
    "ResultCache",
    "SemanticCodec",
    "active",
    "build_plan",
    "cache_enabled",
    "dedupe_enabled",
    "deduped_rows",
    "fill",
    "index_version",
    "lookup",
    "params_seed",
    "query_fingerprints",
    "region_version",
    "semantic_allowed",
    "semantic_fingerprints",
    "stale_versions_allowed",
]
