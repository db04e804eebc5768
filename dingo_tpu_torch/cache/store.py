"""ResultCache: bounded per-region serving-edge result cache (port of
dingo_tpu/cache/store.py).

Entries store the FINAL post-rerank reply rows — the exact
``VectorWithData`` (id, distance) list a fresh dispatch returned for the
plain search path — keyed ``(fingerprint, mutation_version)``. Because
``SlotStore.mutation_version`` bumps on every put / remove / growth, a
hit at the live version is byte-identical to re-running the kernel: same
query bytes, same resolved params, same device state, and every search
family in the repo is deterministic given those.

Bounds and fairness:

- global LRU bounded by ``cache.max_bytes`` (approximate host-byte
  accounting: cached rows are (id, distance) pairs plus entry overhead);
- per-tenant fairness: one tenant's entries may occupy at most
  ``cache.tenant_share`` of the budget — its own inserts evict its own
  LRU tail first, so a scan-heavy tenant cannot flush everyone else's
  working set (the same isolation stance as qos.tenant_queue_rows).

Stale tier: a lookup may ask for ``stale_versions`` fallback — probe
``version - 1 .. version - stale`` after the exact version misses. The
POLICY layer only grants that allowance while the region's shed ladder
is degraded, so slightly-stale replies are strictly a pressure valve,
never the steady state.

Host-only by construction: lookups touch dict/OrderedDict state and
numpy scalars, never a device tensor (a lookup on the admission path must
never add a device sync).

All counters land in the curated ``cache.*`` metric family; per-region
rollups ride heartbeats (metrics/collector.py) and flight
bundles capture the family's absolute state.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from dingo_tpu_torch.common.metrics import METRICS

#: approximate host bytes per cached result item (id + distance + object
#: overhead) and per entry (key tuple, OrderedDict node, bookkeeping)
_ITEM_BYTES = 56
_ENTRY_BYTES = 160


def _entry_bytes(rows: List[Any]) -> int:
    return _ENTRY_BYTES + _ITEM_BYTES * len(rows)


class _Entry:
    __slots__ = ("rows", "nbytes", "tenant")

    def __init__(self, rows: List[Any], nbytes: int, tenant: str):
        self.rows = rows
        self.nbytes = nbytes
        self.tenant = tenant


class _RegionStats:
    __slots__ = ("hits", "misses", "stale_served", "semantic_served",
                 "dedup_collapsed")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.stale_served = 0
        self.semantic_served = 0
        self.dedup_collapsed = 0


class ResultCache:
    """One process-global instance (CACHE) serves every region, the way
    PRESSURE/QUALITY planes do — the byte bound is a store-level budget,
    not a per-region one."""

    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        #: (region_id, fp, version) -> _Entry, LRU order (oldest first)
        self._entries: "OrderedDict[Tuple[int, int, int], _Entry]" = (
            OrderedDict())
        self._bytes = 0
        self._tenant_bytes: Dict[str, int] = {}
        self._region_entries: Dict[int, int] = {}
        self._stats: Dict[int, _RegionStats] = {}

    # ---------------- config ----------------
    @staticmethod
    def max_bytes() -> int:
        from dingo_tpu_torch.common.config import FLAGS

        try:
            return max(0, int(FLAGS.get("cache_max_bytes")))
        except (TypeError, ValueError):
            return 0

    @staticmethod
    def tenant_share() -> float:
        from dingo_tpu_torch.common.config import FLAGS

        try:
            return float(FLAGS.get("cache_tenant_share"))
        except (TypeError, ValueError):
            return 0.0

    # ---------------- stats plumbing ----------------
    def _region_stats(self, region_id: int) -> _RegionStats:
        st = self._stats.get(region_id)
        if st is None:
            st = self._stats[region_id] = _RegionStats()
        return st

    def on_dedup(self, region_id: int, collapsed: int) -> None:
        """Coalescer hook: `collapsed` duplicate rows merged away from
        one flush (rows the kernel never saw)."""
        if collapsed <= 0:
            return
        with self._lock:
            self._region_stats(region_id).dedup_collapsed += collapsed
        self.registry.counter(
            "cache.dedup_collapsed", region_id=region_id).add(collapsed)

    # ---------------- lookup ----------------
    def lookup(self, region_id: int, fp: int, version: int,
               stale_versions: int = 0,
               semantic: bool = False) -> Optional[List[Any]]:
        """Rows for (region, fp) at `version`, falling back at most
        `stale_versions` versions behind; None = miss. A hit returns a
        shallow copy (callers build replies from it; the cached list
        itself must stay immutable). Miss accounting is the caller's job
        via note_miss() — one query row may probe exact AND semantic
        namespaces, but it is one miss."""
        fp = int(fp)
        with self._lock:
            for back in range(0, max(0, int(stale_versions)) + 1):
                key = (region_id, fp, int(version) - back)
                e = self._entries.get(key)
                if e is None:
                    continue
                self._entries.move_to_end(key)
                st = self._region_stats(region_id)
                st.hits += 1
                if back:
                    st.stale_served += 1
                if semantic:
                    st.semantic_served += 1
                rows = list(e.rows)
                break
            else:
                return None
        self.registry.counter("cache.hits", region_id=region_id).add(1)
        if back:
            self.registry.counter(
                "cache.stale_served", region_id=region_id).add(1)
        if semantic:
            self.registry.counter(
                "cache.semantic_served", region_id=region_id).add(1)
        return rows

    def note_miss(self, region_id: int, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self._region_stats(region_id).misses += n
        self.registry.counter("cache.misses", region_id=region_id).add(n)

    # ---------------- insert / eviction ----------------
    def put(self, region_id: int, fp: int, version: int, rows: List[Any],
            tenant: str = "default") -> bool:
        """Insert one reply's rows; returns False when the cache is
        disabled (max_bytes 0) or the single entry exceeds the tenant
        share. Re-inserting an existing key refreshes it."""
        budget = self.max_bytes()
        if budget <= 0:
            return False
        nbytes = _entry_bytes(rows)
        share = self.tenant_share()
        tenant_budget = (int(budget * share)
                         if 0.0 < share < 1.0 else budget)
        if nbytes > tenant_budget:
            return False
        key = (region_id, int(fp), int(version))
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._account_remove(key, old)
            entry = _Entry(list(rows), nbytes, tenant)
            self._entries[key] = entry
            self._bytes += nbytes
            self._tenant_bytes[tenant] = (
                self._tenant_bytes.get(tenant, 0) + nbytes)
            self._region_entries[region_id] = (
                self._region_entries.get(region_id, 0) + 1)
            # per-tenant fairness first: the inserting tenant's own LRU
            # tail pays for its overflow, never another tenant's entries
            if self._tenant_bytes.get(tenant, 0) > tenant_budget:
                evicted += self._evict_lru(
                    lambda k, e: e.tenant == tenant
                    and k != key,
                    lambda: self._tenant_bytes.get(tenant, 0)
                    > tenant_budget,
                )
            # then the global budget
            if self._bytes > budget:
                evicted += self._evict_lru(
                    lambda k, e: k != key,
                    lambda: self._bytes > budget,
                )
            self._publish_gauges_locked()
        if evicted:
            self.registry.counter(
                "cache.evictions", region_id=region_id).add(evicted)
        return True

    def _account_remove(self, key, e: _Entry) -> None:
        self._bytes -= e.nbytes
        left = self._tenant_bytes.get(e.tenant, 0) - e.nbytes
        if left > 0:
            self._tenant_bytes[e.tenant] = left
        else:
            self._tenant_bytes.pop(e.tenant, None)
        rid = key[0]
        n = self._region_entries.get(rid, 0) - 1
        if n > 0:
            self._region_entries[rid] = n
        else:
            self._region_entries.pop(rid, None)

    def _evict_lru(self, victim_ok, over) -> int:
        """Pop oldest entries matching victim_ok while over() holds.
        Caller holds the lock."""
        evicted = 0
        while over():
            victim = None
            for k in self._entries:          # oldest first
                if victim_ok(k, self._entries[k]):
                    victim = k
                    break
            if victim is None:
                break
            e = self._entries.pop(victim)
            self._account_remove(victim, e)
            evicted += 1
        return evicted

    # ---------------- observability / lifecycle ----------------
    def _publish_gauges_locked(self) -> None:
        self.registry.gauge("cache.bytes").set(float(self._bytes))
        for rid, n in self._region_entries.items():
            self.registry.gauge("cache.entries", rid).set(float(n))

    def region_stats(self, region_id: int) -> Dict[str, float]:
        """Heartbeat harvest (metrics/collector.py) — mirrors
        PRESSURE.region_stats's shape contract."""
        with self._lock:
            st = self._stats.get(region_id)
            entries = self._region_entries.get(region_id, 0)
            if st is None:
                return {"hits": 0, "misses": 0, "entries": entries,
                        "stale_served": 0, "semantic_served": 0,
                        "dedup_collapsed": 0}
            return {
                "hits": st.hits,
                "misses": st.misses,
                "entries": entries,
                "stale_served": st.stale_served,
                "semantic_served": st.semantic_served,
                "dedup_collapsed": st.dedup_collapsed,
            }

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "bytes": self._bytes,
                "entries": len(self._entries),
                "tenants": len(self._tenant_bytes),
            }

    def tenant_bytes(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_bytes.get(tenant, 0)

    def invalidate_region(self, region_id: int) -> None:
        """Drop every entry of one region (region destroy/move — version
        keying already handles ordinary writes)."""
        with self._lock:
            dead = [k for k in self._entries if k[0] == region_id]
            for k in dead:
                self._account_remove(k, self._entries.pop(k))
            self._publish_gauges_locked()
            self.registry.gauge("cache.entries", region_id).set(0.0)

    def forget_region(self, region_id: int) -> None:
        self.invalidate_region(region_id)
        with self._lock:
            self._stats.pop(region_id, None)

    def reset(self) -> None:
        """Test/bench isolation only."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._tenant_bytes.clear()
            self._region_entries.clear()
            self._stats.clear()
            self.registry.gauge("cache.bytes").set(0.0)
