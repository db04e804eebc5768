"""VectorIndexManager: background build / rebuild / save / catch-up (port
of dingo_tpu/index/manager.py).

Reference: src/vector/vector_index_manager.{h,cc} (1,762 LoC) — task types
RebuildVectorIndexTask / SaveVectorIndexTask / LoadOrBuildVectorIndexTask
(vector_index_manager.h:35-131); BuildVectorIndex full scan build (:864)
with TrainForBuild (:1365); ReplayWalToVectorIndex raft-log catch-up (:763-
861); CatchUpLogToVectorIndex multi-round catch-up then atomic switch
(:1149); SaveVectorIndex (:1245); ScrubVectorIndex periodic check (:175).

Lifecycle (§3.4): a rebuild scans the engine's data CF into a FRESH index,
then replays raft-log entries that committed during the scan (possibly
several rounds), and finally swaps the wrapper's own_index under the
switching flag. The index is always reconstructible because the engine is
the source of truth and every index tracks apply_log_id.

The port builds every index on the manager's ``device`` (None = the CUDA
device; DeviceUnavailable without one) and keeps the last build's split
(engine scan, index ingest, train) per region in ``build_stats``. A build
may take a ``param_override`` (the device recovery's re-materialization
narrows the precision this way, leaving the region definition alone), and
an index with a bulk session (HNSW behind ``hnsw_device_build``) builds
its graph on the device from the same scan pages. ``compact_views`` is the
view-compaction crontab's entry point. The tiering plane's rebuilds are
not ported.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.common.log import get_logger, region_log
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.engine import write_data as wd
from dingo_tpu_torch.engine.raw_engine import RawEngine
from dingo_tpu_torch.index.base import IndexParameter, VectorIndex
from dingo_tpu_torch.index.factory import new_index
from dingo_tpu_torch.index.vector_reader import ReaderContext, VectorReader
from dingo_tpu_torch.raft.log import RaftLog
from dingo_tpu_torch.store.region import Region
from dingo_tpu_torch.trace import TRACER

_log = get_logger("index.manager")

#: kBuildVectorIndexBatchSize analog (reference scans in fixed batches)
BUILD_BATCH = 4096
#: max catch-up rounds before the final locked round (reference loops until
#: the lag is small, then swaps under SetIsSwitchingVectorIndex)
MAX_CATCHUP_ROUNDS = 8


class StaleSnapshot(RuntimeError):
    """A snapshot too old for the remaining raft log to bridge (the log was
    compacted past snapshot_log_id + 1); installing it would lose writes."""


def precision_override(param: Optional[IndexParameter],
                       target: Optional[str]) -> Optional[IndexParameter]:
    """`param` with its precision replaced by `target`, or `param` itself
    (the same object) when nothing changes. The region definition is never
    touched: its declared parameter stays what an ordinary rebuild
    returns to."""
    if param is None or not target:
        return param
    if (getattr(param, "precision", "") or "") == target:
        return param
    return dataclasses.replace(param, precision=target)


class VectorIndexManager:
    def __init__(self, engine: RawEngine, snapshot_root: Optional[str] = None,
                 device=None):
        self.engine = engine
        self.snapshot_root = snapshot_root
        self.device = resolve_device(device)
        #: region id -> the last build's rows and host-clock ms split
        #: {"rows", "scan_ms", "ingest_ms", "train_ms"}
        self.build_stats: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self.rebuild_running = 0     # bvar task counters (manager.h:177-208)
        self.rebuild_total = 0
        self.save_total = 0
        self._rebuilding: set = set()   # region ids with a rebuild in flight

    # ---------------- build ----------------
    def build_index(self, region: Region,
                    raft_log: Optional[RaftLog] = None,
                    param_override: Optional[IndexParameter] = None
                    ) -> VectorIndex:
        """BuildVectorIndex (vector_index_manager.cc:864): full scan of the
        region data CF -> fresh index (+train for IVF types).
        `param_override` builds with another parameter without touching
        the region definition."""
        assert region.vector_index_wrapper is not None
        param = param_override if param_override is not None \
            else region.definition.index_parameter
        index = new_index(region.id, param, device=self.device)
        reader = self._reader(region)

        with TRACER.start_span("index.build") as span:
            # streaming scan: BUILD_BATCH-row pages feed the index directly,
            # so peak host memory is one page, not the corpus
            total = 0
            scan_ns = ingest_ns = train_ns = 0
            # an index with a bulk session (TpuHnsw behind the
            # hnsw_device_build crossover) builds its graph on the device
            # from the same pages
            mk = getattr(index, "bulk_builder", None)
            bulk = mk() if mk is not None else None
            t0 = time.perf_counter_ns()
            # one engine scan, paged: the JAX package pages with
            # vector_scan_query from each page's last id + 1, copying the
            # rest of the region out of the engine per page (quadratic)
            for ids, vecs in reader.scan_pages(BUILD_BATCH):
                t1 = time.perf_counter_ns()
                scan_ns += t1 - t0
                total += len(ids)
                if bulk is not None:
                    bulk.add(ids, vecs)
                else:
                    index.upsert(ids, vecs)
                t0 = time.perf_counter_ns()
                ingest_ns += t0 - t1
            scan_ns += time.perf_counter_ns() - t0
            if bulk is not None:
                t1 = time.perf_counter_ns()
                bulk.finish()
                ingest_ns += time.perf_counter_ns() - t1
            if index.need_train() and total:
                # TrainForBuild (:1365), after ingest: trainable stores
                # buffer pre-train rows and the implicit train() samples
                # them on the device
                t1 = time.perf_counter_ns()
                try:
                    index.train()
                except Exception as e:  # noqa: BLE001
                    METRICS.counter(
                        "build.train_failures", region_id=region.id
                    ).add(1)
                    region_log(_log, region.id).warning(
                        "index train failed; serving untrained "
                        "fallback: %s", e)
                train_ns = time.perf_counter_ns() - t1
            self.build_stats[region.id] = {
                "rows": total, "scan_ms": scan_ns / 1e6,
                "ingest_ms": ingest_ns / 1e6, "train_ms": train_ns / 1e6,
            }
            span.set_attr("region_id", region.id)
            span.set_attr("rows", total)
            span.set_attr("device_build", bulk is not None)
        return index

    # ---------------- catch-up + switch ----------------
    def _catch_up_and_install(self, wrapper, index, region: Region,
                              raft_log: RaftLog) -> None:
        """Shared catch-up protocol (rebuild + load): open replay rounds
        without blocking writes, then ONE final round and the install under
        the wrapper lock with the switching flag set."""
        for _ in range(MAX_CATCHUP_ROUNDS):
            target = wrapper.apply_log_id
            if index.apply_log_id >= target:
                break
            self.replay_wal(index, region, raft_log,
                            index.apply_log_id + 1, target)
        with wrapper._lock:
            wrapper.is_switching = True
            try:
                self.replay_wal(index, region, raft_log,
                                index.apply_log_id + 1,
                                wrapper.apply_log_id)
                wrapper.own_index = index
                wrapper.ready = True
                wrapper.build_error = False
                wrapper.share_index = None
            finally:
                wrapper.is_switching = False

    def rebuild(self, region: Region,
                raft_log: Optional[RaftLog] = None,
                param_override: Optional[IndexParameter] = None) -> bool:
        """LaunchRebuildVectorIndex -> RebuildVectorIndex (:1062): build +
        multi-round WAL catch-up + atomic switch (:1149). Returns False
        when a rebuild of THIS region is already in flight (atomic
        test-and-set; two concurrent full scans would only waste minutes
        building the same index twice)."""
        wrapper = region.vector_index_wrapper
        assert wrapper is not None
        with self._lock:
            if region.id in self._rebuilding:
                return False
            self._rebuilding.add(region.id)
            self.rebuild_running += 1
            self.rebuild_total += 1
        region_log(_log, region.id).info("index rebuild starting")
        span = TRACER.start_span("index.rebuild")
        span.set_attr("region_id", region.id)
        token = span.attach()
        try:
            if raft_log is None:
                # No WAL to replay: hold the wrapper lock across scan+swap so
                # no write lands between the scan and the switch (otherwise
                # the fresh index would silently miss it forever).
                with wrapper._lock:
                    index = self.build_index(region, raft_log,
                                             param_override=param_override)
                    index.apply_log_id = wrapper.apply_log_id
                    wrapper.own_index = index
                    wrapper.ready = True
                    wrapper.build_error = False
                    wrapper.share_index = None
                return True
            start_log_id = wrapper.apply_log_id
            index = self.build_index(region, raft_log,
                                     param_override=param_override)
            index.apply_log_id = start_log_id
            self._catch_up_and_install(wrapper, index, region, raft_log)
            return True
        except Exception as e:
            span.set_error(e)
            wrapper.build_error = True
            raise
        finally:
            span.detach(token)
            span.end()
            with self._lock:
                self._rebuilding.discard(region.id)
                self.rebuild_running -= 1

    def rebuild_at_precision(self, region: Region,
                             raft_log: Optional[RaftLog] = None,
                             precision: Optional[str] = None) -> bool:
        """Rebuild at `precision` (None/empty/equal = the declared tier):
        engine scan -> fresh index -> WAL catch-up -> atomic switch. The
        device recovery's re-materialization lands here."""
        override = precision_override(
            region.definition.index_parameter, precision)
        return self.rebuild(region, raft_log=raft_log,
                            param_override=override)

    def replay_wal(self, index: VectorIndex, region: Region,
                   raft_log: RaftLog, start: int, end: int) -> int:
        """ReplayWalToVectorIndex (:763-861): read committed data entries
        from the raft log and re-apply VECTOR_ADD/VECTOR_DELETE."""
        if end < start:
            return 0
        n = 0
        with TRACER.start_span("index.catchup") as span:
            for log_id, _term, payload in raft_log.get_data_entries(start, end):
                data = wd.decode_write(payload)
                if isinstance(data, wd.VectorAddData):
                    index.upsert(data.ids, data.vectors)
                elif isinstance(data, wd.VectorDeleteData):
                    index.delete(data.ids)
                index.apply_log_id = log_id
                n += 1
            span.set_attr("region_id", region.id)
            span.set_attr("entries", n)
        return n

    # ---------------- save / load (snapshots) ----------------
    def snapshot_path(self, region_id: int) -> str:
        assert self.snapshot_root, "manager has no snapshot_root"
        return os.path.join(self.snapshot_root, f"index_{region_id}")

    def save_index(self, region: Region) -> str:
        """SaveVectorIndex (:1245): serialize the index + snapshot_log_id."""
        wrapper = region.vector_index_wrapper
        assert wrapper is not None and wrapper.own_index is not None
        path = self.snapshot_path(region.id)
        with TRACER.start_span("index.save") as span, wrapper._lock:
            span.set_attr("region_id", region.id)
            wrapper.own_index.save(path)
            wrapper.snapshot_log_id = wrapper.apply_log_id
            wrapper.write_count = 0
        with self._lock:
            self.save_total += 1
        region_log(_log, region.id).info(
            "index snapshot saved @log %d -> %s",
            wrapper.snapshot_log_id, path)
        return path

    def load_index(self, region: Region,
                   raft_log: Optional[RaftLog] = None,
                   path: Optional[str] = None) -> bool:
        """LoadOrBuild: try snapshot + WAL replay; False -> caller rebuilds.
        `path` overrides the default snapshot location (VectorLoad RPC)."""
        wrapper = region.vector_index_wrapper
        assert wrapper is not None
        path = path or self.snapshot_path(region.id)
        if not os.path.isdir(path):
            return False
        index = new_index(region.id, region.definition.index_parameter,
                          device=self.device)
        try:
            index.load(path)
        except Exception:
            return False
        if raft_log is None:
            if wrapper.apply_log_id > index.apply_log_id:
                raise StaleSnapshot(
                    f"snapshot at {index.apply_log_id}, region at "
                    f"{wrapper.apply_log_id}, no raft log to replay"
                )
            with wrapper._lock:
                wrapper.set_own(index)
            return True
        # the gap check must run BEFORE replaying: get_data_entries clamps
        # to the log's first_index, so a compacted log would silently skip
        # the missing entries and the post-replay log id would look fine
        if (
            wrapper.apply_log_id > index.apply_log_id
            and raft_log.first_index > index.apply_log_id + 1
        ):
            raise StaleSnapshot(
                f"snapshot at {index.apply_log_id} but the raft log starts "
                f"at {raft_log.first_index} (compacted); entries "
                f"{index.apply_log_id + 1}..{raft_log.first_index - 1} "
                "are unrecoverable from this snapshot"
            )
        # same catch-up-then-locked-install protocol as rebuild(); a live
        # region keeps applying raft entries to the OLD index meanwhile
        self._catch_up_and_install(wrapper, index, region, raft_log)
        return True

    # ---------------- scrub ----------------
    def scrub(self, region: Region, act: bool = False,
              raft_log: Optional[RaftLog] = None) -> dict:
        """ScrubVectorIndex (manager.h:175): periodic health check deciding
        rebuild/save needs. act=True performs them (the reference's scrub
        crontab LAUNCHES the rebuild/save tasks, it does not just report):
        a rebuild uses the atomic-swap path; a save writes the snapshot
        when a snapshot_root is configured."""
        wrapper = region.vector_index_wrapper
        if wrapper is None:
            return {}
        own = wrapper.own_index
        actions = {
            "need_rebuild": wrapper.need_to_rebuild(),
            "need_save": wrapper.need_to_save(),
            "need_compact": bool(
                own is not None and getattr(own, "need_compact", None)
                and own.need_compact()
            ),
        }
        if act:
            try:
                if actions["need_rebuild"]:
                    if self.rebuild(region, raft_log=raft_log):
                        actions["rebuilt"] = True
                    else:
                        actions["skipped_busy"] = True
                elif actions["need_compact"]:
                    # IVF view compaction: restore the dense bucket layout
                    # here, on the maintenance thread, so the search path
                    # never pays the O(N) rebuild (ivf_flat.py
                    # IvfViewMaintenance)
                    own.compact()
                    actions["compacted"] = True
                elif actions["need_save"] and self.snapshot_root:
                    self.save_index(region)
                    actions["saved"] = True
            except Exception as e:  # noqa: BLE001
                # scrub is best-effort background maintenance; the next
                # tick retries (wrapper.build_error carries the state)
                actions["error"] = str(e)
        return actions

    # ---------------- IVF view compaction ----------------
    def compact_views(self, regions) -> int:
        """Crontab entry point (registered at ivf_compact_interval_s):
        compact every region index whose incrementally-maintained IVF view
        crossed its tombstone/spill thresholds. Cheaper cadence than scrub
        (no rebuild/save checks) so garbage never waits a full scrub
        period."""
        n = 0
        for region in regions:
            wrapper = region.vector_index_wrapper
            own = wrapper.own_index if wrapper is not None else None
            if own is None or not hasattr(own, "maybe_compact"):
                continue
            try:
                if own.maybe_compact():
                    n += 1
                    region_log(_log, region.id).info("ivf view compacted")
            except Exception:  # noqa: BLE001 — best-effort maintenance
                _log.exception("view compaction failed (region %d)",
                               region.id)
        return n

    # ---------------- helpers ----------------
    def _reader(self, region: Region) -> VectorReader:
        return VectorReader(ReaderContext(
            region_id=region.id,
            partition_id=region.definition.partition_id,
            start_key=region.definition.start_key,
            end_key=region.definition.end_key,
            index_wrapper=None,          # scan must not consult the index
            engine=self.engine,
            parameter=region.definition.index_parameter,
        ), device=self.device)
