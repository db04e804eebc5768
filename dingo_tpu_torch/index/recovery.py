"""Device-failure recovery: the graduated out-of-memory ladder and degraded
mode (port of dingo_tpu/index/recovery.py).

A device allocation failure (``torch.cuda.OutOfMemoryError``, or the chaos
shim's ``InjectedDeviceFault``, ops/devfault.py) during an index write or
search walks a ladder instead of failing the apply or the request:

  rung 1  drop_rerank   - free the region's DeviceRerankCache (bf16/sq8
                          tiers; rebuilt by later writes)
  rung 2  evict_mirrors - free the dimension-blocked scan mirror and the
                          HNSW adjacency mirror (both are derived copies:
                          the scans fall back to the dense arms that gate
                          on ``vecs_blk is not None``, and HNSW re-exports
                          its adjacency lazily), then return the freed
                          blocks to the card (``torch.cuda.empty_cache``):
                          the caching allocator would otherwise keep them
  rung 3  retry         - re-run the failed op once (index mutations are
                          upserts/deletes: idempotent, safe to re-apply)

If the retry fails the same way the region goes device-degraded: writes
stop materializing into the device index (the engine keeps every write,
and apply_log_id does not advance, so replica comparisons at equal
applied indices stay sound), searches are served exactly from the engine
on the host (vector_reader._host_exact_search), and
``run_rematerializations`` rebuilds the index from the engine at the
advisory-lower tier ``device_recovery_remat_precision`` (the region
definition keeps its declared precision). On success the region leaves
degraded mode.

The store's metrics collector reports a degraded region to the
coordinator (``RegionMetricsSnapshot.device_degraded``) in every
heartbeat. Each rung and each degrade/re-materialization is an event of
the control-plane ledger (obs/events.py), and ``_rebuild_corrupted``
rebuilds from the engine every region whose integrity scrub confirmed
corrupt device state (obs/integrity.py).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from dingo_tpu_torch.common.log import get_logger, region_log
from dingo_tpu_torch.common.metrics import METRICS

_log = get_logger("index.recovery")

#: ladder rung names (label values of fault.oom_recoveries)
RUNG_DROP_RERANK = "drop_rerank"
RUNG_EVICT_MIRRORS = "evict_mirrors"
RUNG_RETRY = "retry"
RUNG_DEGRADE = "degrade"


class DeviceDegraded(RuntimeError):
    """The ladder was exhausted: the region is device-degraded and the op
    must be absorbed by the degraded path (host search, engine-only
    write), not retried against the device."""

    def __init__(self, region_id: int, cause: str = ""):
        super().__init__(
            f"region {region_id} device-degraded"
            + (f" ({cause})" if cause else "")
        )
        self.region_id = region_id


def _looks_like_oom(exc: BaseException) -> bool:
    from dingo_tpu_torch.obs.hbm import looks_like_oom

    return looks_like_oom(exc)


def _release_cached_blocks() -> None:
    """Hand the caching allocator's free blocks back to the card so the
    retry's allocations can use the bytes the rungs just freed."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class DeviceRecoveryPlane:
    """Process-global degraded-region registry and the OOM ladder."""

    def __init__(self, registry=METRICS):
        self._lock = threading.Lock()
        #: region_id -> {"reason", "since", "remat_pending"}
        self._degraded: Dict[int, Dict[str, Any]] = {}
        self._reg = registry
        self.ladder_runs = 0

    @staticmethod
    def enabled() -> bool:
        from dingo_tpu_torch.common.config import FLAGS

        return bool(FLAGS.get("device_recovery_enabled"))

    # -- degraded registry ---------------------------------------------------
    def is_degraded(self, region_id: int) -> bool:
        if not self._degraded:      # serving fast path: one attribute read
            return False
        with self._lock:
            return region_id in self._degraded

    def degraded_regions(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {rid: dict(info) for rid, info in self._degraded.items()}

    def mark_degraded(self, region_id: int, reason: str) -> None:
        with self._lock:
            fresh = region_id not in self._degraded
            self._degraded[region_id] = {
                "reason": reason,
                "since": time.time(),
                "remat_pending": True,
            }
            n = len(self._degraded)
        if fresh:
            self._reg.counter("fault.oom_recoveries",
                              labels={"rung": RUNG_DEGRADE}).add(1)
            from dingo_tpu_torch.obs.events import EVENTS

            EVENTS.emit(
                "recovery", region_id, "device_degraded", 0, 1,
                trigger="oom",
                evidence={"rung": RUNG_DEGRADE, "reason": reason},
            )
            region_log(_log, region_id).error(
                "region device-degraded (%s): serving host-exact, "
                "device writes deferred to re-materialization", reason)
        self._reg.gauge("fault.degraded_regions").set(float(n))
        # published (digest, applied) pairs can be torn by the partial
        # device write that stranded us here: withhold this region's
        # verdict until the re-materialized index re-primes the ledger
        from dingo_tpu_torch.obs.integrity import INTEGRITY

        INTEGRITY.forget_region(region_id)

    def clear_degraded(self, region_id: int) -> None:
        with self._lock:
            self._degraded.pop(region_id, None)
            n = len(self._degraded)
        self._reg.gauge("fault.degraded_regions").set(float(n))

    # -- the ladder ----------------------------------------------------------
    def attempt(self, wrapper, region_id: int, op: Callable[[], Any],
                kind: str = "op", cause: Optional[BaseException] = None):
        """Run `op()` with OOM recovery: on an OOM-classified failure walk
        the ladder (drop rerank -> evict mirrors) and retry once; a second
        OOM marks the region degraded and raises DeviceDegraded. Other
        exceptions propagate untouched. Pass `cause` when the caller
        already caught the first OOM: the initial run is skipped."""
        first = cause
        if first is None:
            try:
                return op()
            except Exception as e:  # noqa: BLE001 - classified below
                if not _looks_like_oom(e) or not self.enabled():
                    raise
                first = e
        t0 = time.perf_counter()
        self.ladder_runs += 1
        region_log(_log, region_id).warning(
            "device OOM during %s (%s: %s): running recovery ladder",
            kind, type(first).__name__, first)
        self._run_ladder(wrapper, region_id)
        try:
            out = op()
        except Exception as e2:  # noqa: BLE001
            if not _looks_like_oom(e2):
                raise
            self.mark_degraded(region_id, f"oom during {kind}")
            self._reg.latency("fault.recovery_ms").observe_us(
                (time.perf_counter() - t0) * 1e6)
            raise DeviceDegraded(region_id, f"oom during {kind}") from e2
        self._reg.counter("fault.oom_recoveries",
                          labels={"rung": RUNG_RETRY}).add(1)
        self._reg.latency("fault.recovery_ms").observe_us(
            (time.perf_counter() - t0) * 1e6)
        region_log(_log, region_id).info(
            "device OOM recovered by ladder retry (%s)", kind)
        return out

    def _run_ladder(self, wrapper, region_id: int) -> None:
        from dingo_tpu_torch.obs.events import EVENTS

        idx = getattr(wrapper, "own_index", None) if wrapper else None
        if idx is None:
            return
        if self._drop_rerank(idx):
            self._reg.counter("fault.oom_recoveries",
                              labels={"rung": RUNG_DROP_RERANK}).add(1)
            EVENTS.emit("recovery", region_id, "recovery_rung", "",
                        RUNG_DROP_RERANK, trigger="oom",
                        evidence={"rung": RUNG_DROP_RERANK})
        if self._evict_mirrors(idx):
            self._reg.counter("fault.oom_recoveries",
                              labels={"rung": RUNG_EVICT_MIRRORS}).add(1)
            EVENTS.emit("recovery", region_id, "recovery_rung", "",
                        RUNG_EVICT_MIRRORS, trigger="oom",
                        evidence={"rung": RUNG_EVICT_MIRRORS})
        _release_cached_blocks()

    @staticmethod
    def _drop_rerank(idx) -> bool:
        if getattr(idx, "_rerank_cache", None) is None:
            return False
        idx._rerank_cache = None
        return True

    @staticmethod
    def _evict_mirrors(idx) -> bool:
        store = getattr(idx, "store", None)
        if store is None:
            return False
        freed = False
        lock = getattr(store, "device_lock", None)
        with (lock if lock is not None else contextlib.nullcontext()):
            if getattr(store, "vecs_blk", None) is not None:
                # the pruned kernels gate on `vecs_blk is not None` and the
                # write path skips the mirror when absent: a clean fallback
                # to the dense scan, not a change of results
                store.vecs_blk = None
                store.bsq_blk = None
                freed = True
            if getattr(store, "adj", None) is not None:
                # HNSW re-exports its adjacency on the next device search
                store.adj = None
                store.graph_deg = 0
                if hasattr(idx, "_graph_key"):
                    idx._graph_key = None
                freed = True
        return freed

    # -- re-materialization --------------------------------------------------
    @staticmethod
    def remat_parameter(param):
        """The advisory-lower-precision build parameter of a degraded
        region's re-materialization (the region definition is untouched;
        index/manager.precision_override)."""
        from dingo_tpu_torch.common.config import FLAGS
        from dingo_tpu_torch.index.manager import precision_override

        target = str(FLAGS.get("device_recovery_remat_precision"))
        return precision_override(param, target)

    def rematerialize(self, manager, region, raft_log=None) -> bool:
        """Rebuild a degraded region's index from the engine at the
        advisory-lower precision, then leave degraded mode. False when a
        rebuild is already in flight or the rebuild failed (the next
        maintenance pass retries). Rides manager.rebuild_at_precision."""
        from dingo_tpu_torch.common.config import FLAGS

        rid = region.id
        target = str(FLAGS.get("device_recovery_remat_precision"))
        try:
            ok = manager.rebuild_at_precision(region, raft_log=raft_log,
                                              precision=target)
        except Exception:
            region_log(_log, rid).exception("re-materialization failed")
            return False
        if not ok:
            return False
        self._reg.counter("fault.rematerializations").add(1)
        self._reg.counter("build.remat_rebuilds", region_id=rid).add(1)
        from dingo_tpu_torch.obs.events import EVENTS

        EVENTS.emit(
            "recovery", rid, "device_degraded", 1, 0, trigger="remat",
            evidence={"precision": target or "default"},
        )
        self.clear_degraded(rid)
        region_log(_log, rid).info(
            "re-materialized from engine at precision=%s: degraded "
            "mode cleared", target or "default")
        return True

    def run_rematerializations(self, node) -> int:
        """Maintenance pass: re-materialize every degraded region of
        `node` (a StoreNode, or a MonoStoreNode, whose regions have no raft
        log), and rebuild from the engine every region whose scrub
        confirmed corrupt device state. Returns the number rebuilt."""
        n = 0
        for rid, info in self.degraded_regions().items():
            if not info.get("remat_pending"):
                continue
            region = node.meta.get_region(rid)
            if region is None:                 # region gone: just clear
                self.clear_degraded(rid)
                continue
            # a MonoStoreNode's engine has no raft member (no log to replay)
            get_node = getattr(node.engine, "get_node", None)
            raft_node = get_node(rid) if get_node is not None else None
            raft_log = raft_node.log if raft_node is not None else None
            if self.rematerialize(node.index_manager, region,
                                  raft_log=raft_log):
                n += 1
        n += self._rebuild_corrupted(node)
        return n

    def _rebuild_corrupted(self, node) -> int:
        """Scrub-confirmed mismatches: rebuild the poisoned index from the
        engine. The fresh index starts a fresh ledger, and the stale
        verdict, which belongs to the index that no longer serves, is
        forgotten."""
        from dingo_tpu_torch.obs.integrity import INTEGRITY

        n = 0
        get_node = getattr(node.engine, "get_node", None)
        for region in node.meta.get_all_regions():
            _a, _d, mismatch = INTEGRITY.region_report(None, region.id)
            if not mismatch:
                continue
            wrapper = region.vector_index_wrapper
            if wrapper is None or wrapper.own_index is None:
                continue
            raft_node = get_node(region.id) if get_node is not None else None
            raft_log = raft_node.log if raft_node is not None else None
            try:
                if node.index_manager.rebuild(region, raft_log=raft_log):
                    self._reg.counter("fault.rebuilds").add(1)
                    INTEGRITY.forget_region(region.id)
                    INTEGRITY.rebuild_from_index(wrapper.own_index)
                    region_log(_log, region.id).warning(
                        "corrupted device state rebuilt from engine")
                    n += 1
            except Exception:
                region_log(_log, region.id).exception(
                    "corruption rebuild failed")
        return n

    def clear(self) -> None:
        with self._lock:
            self._degraded.clear()
        self._reg.gauge("fault.degraded_regions").set(0.0)


#: process-global plane (one device; regions share its failure domain)
RECOVERY = DeviceRecoveryPlane()
