"""StoreMetricsCollector: crontab-driven per-region metrics snapshots (port
of dingo_tpu/metrics/collector.py).

Reference: StoreMetricsManager (src/metrics/store_metrics_manager.{h,cc}) —
CollectStoreRegionMetrics on a crontab, region sizes from the engine,
vector-index state from the wrappers, shipped in every StoreHeartbeat.

Every figure is double-published:
- into the process MetricsRegistry (region-labeled gauges), and
- as a StoreMetricsSnapshot cached on the collector, attached to the next
  heartbeat so the coordinator aggregates cluster-wide state.

The port fills the fields whose sources it has: engine key counts and
sampled bytes, the index's state (ready, building or switching, build
error, apply and snapshot log ids, vector count, host bytes, the own
index's device bytes), raft leadership and apply lag, the allocator's
bytes in use, limit and peak on a CUDA store, and ``device_degraded``
from the recovery ladder. The fields fed by the observability and tiering
planes the port does not have yet (quality, pressure, integrity, cost,
heat, events, the flight recorder, the memory-tier ladder and the edge
cache; also the search QPS, recorded by the gRPC services) keep the
snapshot types' defaults.
"""

from __future__ import annotations

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

_log = get_logger("metrics.collector")

#: bytes estimation samples at most this many kvs per region per tick,
#: then extrapolates by key count (a full scan would be O(dataset) per tick)
SIZE_SAMPLE_KVS = 1024


def device_allocator_bytes(device) -> dict:
    """The caching allocator's bytes in use, the card's total bytes and the
    peak in use on a CUDA `device`; zeros for a CPU store (it keeps no
    device state)."""
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return {"bytes_in_use": 0, "bytes_limit": 0, "peak_bytes_in_use": 0}
    import torch

    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
    }


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
            dev = device_allocator_bytes(node.device)
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
            return self._latest

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
            # tensors; counting them on both regions would double-book them
            rm.device_memory_bytes = wrapper.get_device_memory_size()
        rm.device_degraded = RECOVERY.is_degraded(region.id)
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
