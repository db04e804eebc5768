"""StoreMetricsCollector: crontab-driven per-region metrics snapshots (port
of dingo_tpu/metrics/collector.py).

Reference: StoreMetricsManager (src/metrics/store_metrics_manager.{h,cc}) —
CollectStoreRegionMetrics on a crontab, region sizes from the engine,
vector-index state from the wrappers, shipped in every StoreHeartbeat.

Every figure is double-published:
- into the process MetricsRegistry (region-labeled gauges), and
- as a StoreMetricsSnapshot cached on the collector, attached to the next
  heartbeat so the coordinator aggregates cluster-wide state.

The port fills every field: engine key counts and sampled bytes, the
index's state, raft leadership and apply lag, the allocator's bytes in
use, limit and peak on a CUDA store (through the HBM ledger's poll), the
per-region device bytes and their peak (``HbmLedger``), the search QPS
(IndexService's ``vector_search`` series), ``device_degraded``, and the
observability planes: quality, pressure, integrity, heat, cost, the
edge cache's hits, misses and entries, the memory-tier rung serving the
region (``serving_tier``), the events harvested since the last beat and
the live knobs they explain. A
collection pass ticks the flight recorder's metric ring.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.engine.raw_engine import CF_DEFAULT
from dingo_tpu_torch.index.recovery import RECOVERY
from dingo_tpu_torch.metrics.snapshot import (
    RegionMetricsSnapshot,
    StoreMetricsSnapshot,
)
from dingo_tpu_torch.mvcc.codec import Codec
from dingo_tpu_torch.obs.flight import FLIGHT
from dingo_tpu_torch.obs.hbm import HBM

_log = get_logger("metrics.collector")

#: bytes estimation samples at most this many kvs per region per tick,
#: then extrapolates by key count (a full scan would be O(dataset) per tick)
SIZE_SAMPLE_KVS = 1024


class StoreMetricsCollector:
    def __init__(self, node, registry=METRICS):
        self.node = node
        self.registry = registry
        self._lock = threading.Lock()
        self._latest: Optional[StoreMetricsSnapshot] = None
        self._latest_mono: float = 0.0
        #: region ids whose gauges were published last pass — the delta
        #: against the current pass drives registry series cleanup
        self._published_regions: set = set()
        self.collect_total = 0
        self.collect_errors = 0

    # ---------------- public API ----------------
    @property
    def latest(self) -> Optional[StoreMetricsSnapshot]:
        with self._lock:
            return self._latest

    def maybe_collect(self, max_age_s: float = 0.0) -> StoreMetricsSnapshot:
        """Return the cached snapshot if younger than max_age_s, else
        collect now (heartbeats without a metrics crontab stay fresh)."""
        with self._lock:
            fresh = (
                self._latest is not None
                and time.monotonic() - self._latest_mono <= max_age_s
            )
            if fresh:
                return self._latest
        return self.collect()

    def collect(self) -> StoreMetricsSnapshot:
        """One collection pass over every hosted region. Never raises —
        a collector bug must not kill the heartbeat/crontab. A FAILED pass
        keeps (and returns) the last good snapshot: shipping the partial,
        near-empty one would zero the coordinator's view of this store and
        make load-aware balancing move leaders TOWARD the malfunction."""
        node = self.node
        snap = StoreMetricsSnapshot(
            store_id=node.store_id,
            collected_at_ms=int(time.time() * 1000),
        )
        ok = True
        try:
            # one allocator query serves both the snapshot and the hbm
            # watermark gauges (a CPU store keeps no device state)
            if getattr(node.device, "type", "cpu") == "cuda":
                dev = HBM.poll_process()
            else:
                dev = {"bytes_in_use": 0, "bytes_limit": 0,
                       "peak_bytes_in_use": 0}
            snap.device_bytes_in_use = dev["bytes_in_use"]
            snap.device_bytes_limit = dev["bytes_limit"]
            snap.device_peak_bytes = dev["peak_bytes_in_use"]
            snap.engine_key_count = node.raw.count(CF_DEFAULT)
            for region in node.meta.get_all_regions():
                try:
                    snap.regions.append(self._collect_region(region))
                except Exception:  # noqa: BLE001
                    self.collect_errors += 1
                    _log.exception("collect failed for region %d", region.id)
            # control-plane events emitted since the last beat: each ships
            # exactly once; a failed pass before this point leaves them
            # pending for the next one
            from dingo_tpu_torch.obs.events import EVENTS

            evs = EVENTS.harvest(node_id=node.store_id)
            if evs:
                snap.events = list(evs)
                self.registry.gauge("event.heartbeat_bytes").set(sum(
                    len(e.actor) + len(e.knob) + len(e.old) + len(e.new)
                    + len(e.trigger) + len(e.evidence) + len(e.node_id)
                    + len(e.trace_id) + len(e.flight_bundle_id) + 24
                    for e in evs))
            self._publish(snap)
        except Exception:  # noqa: BLE001
            ok = False
            self.collect_errors += 1
            _log.exception("store metrics collection failed")
        with self._lock:
            if ok or self._latest is None:
                self._latest = snap
            # pace retries either way — a persistently failing pass must
            # not burn a full sweep attempt on every single heartbeat
            self._latest_mono = time.monotonic()
            self.collect_total += 1
            latest = self._latest
        # feed the flight recorder's metric-delta ring outside the lock
        FLIGHT.tick()
        return latest

    # ---------------- per-region ----------------
    def _collect_region(self, region) -> RegionMetricsSnapshot:
        node = self.node
        rm = RegionMetricsSnapshot(region_id=region.id)
        # data-CF keys are memcomparable mvcc-encoded (user_key + ts) —
        # bounds must encode the same way or the range misses everything.
        # Counts are MVCC versions, not live user keys: cheap (engine
        # count, no value decode) and GC keeps the two converging
        start = Codec.encode_bytes(region.definition.start_key)
        end = (Codec.encode_bytes(region.definition.end_key)
               if region.definition.end_key else None)
        rm.key_count = node.raw.count(CF_DEFAULT, start, end)
        rm.approximate_bytes = self._approximate_bytes(
            start, end, rm.key_count
        )
        raft = node.engine.get_node(region.id)
        if raft is not None:
            rm.is_leader = raft.is_leader()
            rm.apply_lag = max(0, raft.commit_index - raft.last_applied)
        wrapper = region.vector_index_wrapper
        if wrapper is not None:
            rm.index_ready = wrapper.is_ready()
            rm.index_build_error = wrapper.build_error
            rm.index_building = (
                wrapper.is_switching
                or region.id in node.index_manager._rebuilding
            )
            rm.index_apply_log_id = wrapper.apply_log_id
            rm.index_snapshot_log_id = wrapper.snapshot_log_id
            try:
                rm.vector_count = wrapper.get_count()
                rm.vector_memory_bytes = wrapper.get_memory_size()
            except Exception:  # noqa: BLE001 — index mid-build
                pass
            # own index only — a post-split share serves from the PARENT's
            # tensors; counting them on both regions would double-book
            # them. One walk serves both figures: the ledger's owners sum
            # to the index's bytes (shared dedup set)
            owners = HBM.account_index(region.id, wrapper)
            rm.device_memory_bytes = (
                sum(owners.values()) if owners
                else wrapper.get_device_memory_size())   # share/mid-build
            rm.device_peak_bytes = HBM.region_peak(region.id)
        rm.search_qps = self.registry.latency(
            "vector_search", region.id).windowed_qps()
        # live quality estimate (obs/quality.py)
        from dingo_tpu_torch.obs.quality import QUALITY

        est = QUALITY.region_estimate(region.id)
        if est is not None:
            rm.quality_recall = est["recall"]
            rm.quality_recall_ci_low = est["ci_low"]
            rm.quality_recall_ci_high = est["ci_high"]
            rm.quality_samples = int(est["queries"])
        # serving-pressure rollup (obs/pressure.py)
        from dingo_tpu_torch.obs.pressure import PRESSURE

        qs = PRESSURE.region_stats(region.id)
        rm.qos_queue_depth = int(qs["queue_depth"])
        rm.qos_queue_wait_ms = float(qs["queue_wait_ms"])
        rm.qos_shed_total = int(qs["shed_total"])
        rm.qos_degrade_level = int(self.registry.gauge(
            "qos.degrade_level", region.id).get())
        # state-integrity digest vector (obs/integrity.py), tagged with
        # the raft applied index it describes: the coordinator compares
        # replicas at equal applied indices
        from dingo_tpu_torch.obs.integrity import INTEGRITY

        own = wrapper.own_index if wrapper is not None else None
        applied, digests, mismatch = INTEGRITY.region_report(
            own, region_id=region.id)
        rm.integrity_applied_index = applied
        rm.integrity_digests = digests
        rm.integrity_mismatch = mismatch
        rm.device_degraded = RECOVERY.is_degraded(region.id)
        # serving-edge cache rollup (cache/): hits, misses, live entries
        from dingo_tpu_torch.cache.edge import CACHE

        cs = CACHE.region_stats(region.id)
        rm.cache_hits = int(cs["hits"])
        rm.cache_misses = int(cs["misses"])
        rm.cache_entries = int(cs["entries"])
        # workload-heat rollup (obs/heat.py): traffic concentration and
        # the working-set curve at the region's own tier (touches == 0:
        # no evidence)
        from dingo_tpu_torch.obs.cost import COST
        from dingo_tpu_torch.obs.heat import HEAT

        hs = HEAT.region_stats(region.id)
        if hs is not None:
            rm.heat_hot_fraction = float(hs["hot_fraction"])
            rm.heat_gini = float(hs["gini"])
            rm.heat_working_set_p50 = int(hs["ws_bytes"][50])
            rm.heat_working_set_p90 = int(hs["ws_bytes"][90])
            rm.heat_working_set_p99 = int(hs["ws_bytes"][99])
            rm.heat_touches = int(hs["touches"])
        rm.cost_row_us = float(COST.region_row_us(region.id))
        # memory-tier ladder (index/tiering.py): the rung serving reads; an
        # untracked region reports its resident precision's base rung
        from dingo_tpu_torch.index.tiering import TIERING

        rm.serving_tier = TIERING.region_tier(
            region.id, getattr(own, "_precision", "") if own else "")
        # the live overrides in force now, as compact JSON: `explain`
        # reconciles them against the merged event timeline
        from dingo_tpu_torch.obs.events import events_enabled

        if events_enabled():
            ts = TIERING.state().get(region.id)
            advisory = self.registry.gauge(
                "qos.precision_advisory", region.id).get()
            rm.live_knobs = json.dumps({
                "tuning": dict(getattr(own, "tuning", None) or {}),
                "advisory_precision": "sq8" if advisory > 0 else "",
                "tier": rm.serving_tier,
                "tier_base": ts["base"] if ts else rm.serving_tier,
            }, sort_keys=True, separators=(",", ":"))
        last = INTEGRITY.last_verified_ms(region.id)
        self.registry.gauge(
            "consistency.digest_age_s", region.id
        ).set((time.time() * 1000 - last) / 1000.0 if last else -1.0)
        return rm

    def _approximate_bytes(self, start: bytes, end, key_count: int) -> int:
        """Sampled size estimate: sum the first SIZE_SAMPLE_KVS kv sizes in
        the range, extrapolate by key count (ApproximateSize analog —
        RocksDB answers from SST metadata; a sorted-dict engine samples)."""
        if key_count <= 0:
            return 0
        sampled = 0
        n = 0
        for k, v in self.node.raw.scan(CF_DEFAULT, start, end):
            sampled += len(k) + len(v)
            n += 1
            if n >= SIZE_SAMPLE_KVS:
                break
        if n == 0:
            return 0
        return int(sampled * (key_count / n))

    # ---------------- registry publication ----------------
    def _publish(self, snap: StoreMetricsSnapshot) -> None:
        # retire series of regions this store no longer hosts (deleted,
        # merged away, moved) — their gauges would otherwise report the
        # last values forever
        current = {rm.region_id for rm in snap.regions}
        for rid in self._published_regions - current:
            self.registry.drop_region(rid)
            from dingo_tpu_torch.obs.cost import COST
            from dingo_tpu_torch.obs.events import EVENTS
            from dingo_tpu_torch.obs.heat import HEAT
            from dingo_tpu_torch.obs.integrity import INTEGRITY
            from dingo_tpu_torch.obs.pressure import PRESSURE
            from dingo_tpu_torch.obs.quality import QUALITY

            HBM.forget_region(rid)
            QUALITY.forget_region(rid)
            PRESSURE.forget_region(rid)
            INTEGRITY.forget_region(rid)
            HEAT.forget_region(rid)
            COST.forget_region(rid)
            # the event ledger, the tier ladder, the edge cache and its
            # stale-serving memo: a departed region's history, rung and
            # entries must not leak to a region re-created under its id
            from dingo_tpu_torch.cache import policy as cache_policy
            from dingo_tpu_torch.cache.edge import CACHE, CODECS
            from dingo_tpu_torch.index.tiering import TIERING

            EVENTS.forget_region(rid)
            TIERING.forget_region(rid)
            CACHE.forget_region(rid)
            CODECS.forget_region(rid)
            cache_policy.forget_region(rid)
        self._published_regions = current
        g = self.registry.gauge
        g("store.device.bytes_in_use").set(snap.device_bytes_in_use)
        g("store.device.bytes_limit").set(snap.device_bytes_limit)
        g("store.device.peak_bytes").set(snap.device_peak_bytes)
        g("store.engine.key_count").set(snap.engine_key_count)
        g("store.region_count").set(len(snap.regions))
        for rm in snap.regions:
            rid = rm.region_id
            g("store.region.key_count", rid).set(rm.key_count)
            g("store.region.approximate_bytes", rid).set(
                rm.approximate_bytes)
            g("store.region.vector_count", rid).set(rm.vector_count)
            g("store.region.vector_memory_bytes", rid).set(
                rm.vector_memory_bytes)
            g("store.region.device_memory_bytes", rid).set(
                rm.device_memory_bytes)
            # device bytes per resident vector: the precision-tier capacity
            # win (fp32 -> bf16 -> sq8) as one number; an emptied region
            # reports 0, never its last live value
            g("store.region.device_bytes_per_vector", rid).set(
                rm.device_memory_bytes / rm.vector_count
                if rm.vector_count else 0.0)
            g("store.region.apply_lag", rid).set(rm.apply_lag)
            g("store.region.is_leader", rid).set(1.0 if rm.is_leader else 0.0)
            g("store.region.index_ready", rid).set(
                1.0 if rm.index_ready else 0.0)
            g("store.region.index_building", rid).set(
                1.0 if rm.index_building else 0.0)
            g("store.region.document_count", rid).set(rm.document_count)
            # scrapeable pressure watermark (the depth gauge itself is
            # kept live by the coalescer's admit/dequeue accounting)
            g("qos.queue_wait_watermark_ms", rid).set(rm.qos_queue_wait_ms)
