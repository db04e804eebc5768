"""Metric snapshot records shipped store -> coordinator in heartbeats (port
of dingo_tpu/metrics/snapshot.py).

The persisted bytes equal the JAX package's (same registered names, same
fields in the same order), so a replicated coordinator's log entries
decode in both packages.

persist-registered because the replicated coordinator proposes
store_heartbeat(args, kwargs) through the meta raft group
(coordinator/raft_meta.py) — the payload must round-trip persist.dumps.
"""

from __future__ import annotations

import dataclasses
from typing import List

from dingo_tpu_torch.common import persist


@persist.register
@dataclasses.dataclass
class RegionMetricsSnapshot:
    """One region's sizes/counts/status as seen by its hosting store
    (reference pb::common::RegionMetrics subset + device accounting)."""

    region_id: int
    key_count: int = 0
    approximate_bytes: int = 0
    vector_count: int = 0
    vector_memory_bytes: int = 0
    device_memory_bytes: int = 0
    index_ready: bool = False
    index_building: bool = False
    index_build_error: bool = False
    index_apply_log_id: int = 0
    index_snapshot_log_id: int = 0
    apply_lag: int = 0
    is_leader: bool = False
    search_qps: float = 0.0
    document_count: int = 0
    #: HBM high-watermark of the region total (obs hbm ledger); peaks are
    #: what size a region move or explain an OOM — instants don't
    device_peak_bytes: int = 0
    #: live recall estimate from the quality plane (obs/quality.py):
    #: windowed shadow-scan recall@k with its Wilson CI. quality_samples
    #: is the number of scored queries in the window — 0 means the other
    #: three fields are meaningless (sampling off or no traffic), so
    #: renderers show '-' instead of 0.000
    quality_recall: float = 0.0
    quality_recall_ci_low: float = 0.0
    quality_recall_ci_high: float = 0.0
    quality_samples: int = 0
    #: serving-pressure rollup (obs/pressure.py): coalescer queue depth
    #: in query rows at collection, recent queue-wait watermark (ms, a
    #: rolling ~2x5s window max), cumulative shed+expired requests, and
    #: the shed controller's current degrade level (0 = serving at full
    #: quality) — the cluster top QDEPTH/PRESS/SHED columns
    qos_queue_depth: int = 0
    qos_queue_wait_ms: float = 0.0
    qos_shed_total: int = 0
    qos_degrade_level: int = 0
    #: state-integrity plane (obs/integrity.py): the raft applied index
    #: the digest vector corresponds to, the compact JSON
    #: {artifact: digest} vector ("" = plane off / unprimed), and the
    #: store-local scrub verdict. The coordinator compares replicas'
    #: digests at EQUAL applied indices and flags divergence
    integrity_applied_index: int = 0
    integrity_digests: str = ""
    integrity_mismatch: bool = False
    #: device-recovery plane (index/recovery.py): the region's device
    #: index OOMed past the ladder and serves host-exact until the
    #: background re-materialization lands
    device_degraded: bool = False
    #: serving-edge cache rollup (dingo_tpu/cache/): cumulative hit/miss
    #: counts and live entries for the region — the cluster top CACHE
    #: column renders hit rate, showing '-' while hits+misses == 0 (cache
    #: off or no plain-search traffic)
    cache_hits: int = 0
    cache_misses: int = 0
    cache_entries: int = 0
    #: workload-heat plane rollup (obs/heat.py): traffic concentration
    #: (hot_fraction = mass on the hottest 10% of heat units, gini over
    #: unit masses), working-set bytes to serve {50,90,99}% of traffic
    #: at the region's OWN precision tier, and cumulative sketch
    #: touches. touches == 0 means the other fields are meaningless
    #: (plane off or no traffic) — renderers show '-'. The coordinator's
    #: capacity plane rolls these against the store's HBM ledger
    heat_hot_fraction: float = 0.0
    heat_gini: float = 0.0
    heat_working_set_p50: int = 0
    heat_working_set_p90: int = 0
    heat_working_set_p99: int = 0
    heat_touches: int = 0
    #: per-shape cost model (obs/cost.py): the region's EWMA per-row
    #: dispatch cost in µs (0.0 = unmeasured)
    cost_row_us: float = 0.0
    #: memory-tier ladder (index/tiering.py): the rung serving this
    #: region's reads — hbm / hbm_sq8 / host_sq8 / mmap_sq8 ("" before
    #: the first collection; `cluster top` TIER column)
    serving_tier: str = ""
    #: control-plane flight recorder (obs/events.py): compact JSON of the
    #: live overrides in force on this region at collect time —
    #: {"tuning": {...}, "advisory_precision": ..., "tier": ...,
    #:  "tier_base": ...}. "" = none. `cluster explain` reconciles these
    #: against the event ledger (a live knob with no event = orphan)
    live_knobs: str = ""


@persist.register
@dataclasses.dataclass
class StoreMetricsSnapshot:
    """Whole-store snapshot: process-level device gauges + regions."""

    store_id: str
    collected_at_ms: int = 0
    device_bytes_in_use: int = 0
    device_bytes_limit: int = 0
    device_peak_bytes: int = 0
    engine_key_count: int = 0
    regions: List[RegionMetricsSnapshot] = dataclasses.field(
        default_factory=list
    )
    #: control-plane events (obs/events.Event) harvested since the last
    #: beat — each ledger entry ships exactly once (bounded by
    #: events.heartbeat_batch); the coordinator merges them into its
    #: cluster timeline. Untyped list: snapshot must not import obs/
    events: List = dataclasses.field(default_factory=list)

    def region(self, region_id: int) -> RegionMetricsSnapshot:
        for r in self.regions:
            if r.region_id == region_id:
                return r
        raise KeyError(region_id)
