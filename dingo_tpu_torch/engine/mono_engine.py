"""MonoStoreEngine: single-replica engine (no raft) with the Engine API
(port of dingo_tpu/engine/mono_engine.py; region readers use the
engine's device).

Reference: src/engine/mono_store_engine.{h,cc} — same reader/writer surface
as RaftStoreEngine but writes apply directly through the handlers; used for
MONO_STORE regions and single-node deployments. Keeping the apply path
shared (engine/apply.py) means raft and mono regions behave identically
after commit.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.engine.apply import apply_write
from dingo_tpu_torch.engine.apply_results import ApplyResultBuffer
from dingo_tpu_torch.engine.raw_engine import RawEngine
from dingo_tpu_torch.engine.write_data import WriteData
from dingo_tpu_torch.index.vector_reader import ReaderContext, VectorReader
from dingo_tpu_torch.mvcc.codec import MAX_TS
from dingo_tpu_torch.store.region import Region


class MonoStoreEngine:
    def __init__(self, raw_engine: RawEngine, device=None):
        self.raw = raw_engine
        #: where region readers build their brute-force index
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._log_ids: Dict[int, int] = {}  # per-region apply log counter
        self._write_locks: Dict[int, "threading.Lock"] = {}
        self._apply_results = ApplyResultBuffer()

    def next_log_id(self, region_id: int) -> int:
        with self._lock:
            n = self._log_ids.get(region_id, 0) + 1
            self._log_ids[region_id] = n
            return n

    # -- Engine::Writer ------------------------------------------------------
    def _region_write_lock(self, region_id: int):
        with self._lock:
            lock = self._write_locks.get(region_id)
            if lock is None:
                lock = self._write_locks[region_id] = threading.Lock()
            return lock

    def write(self, region: Region, data: WriteData) -> int:
        """Synchronous apply; returns the log id (mono engine fakes the raft
        log with a per-region counter so the wrapper's apply-log contract
        stays identical). Applies serialize per region — the raft engine's
        apply loop gives the same guarantee, and result-bearing handlers
        (delete_range count-then-delete) rely on it for atomicity."""
        with self._region_write_lock(region.id):
            log_id = self.next_log_id(region.id)
            # mono IS the proposer, so results are always wanted
            result = apply_write(self.raw, region, data, log_id)
            if result is not None:
                self._apply_results.record(region.id, log_id, result)
            return log_id

    async_write = write  # mono apply is already synchronous

    def take_apply_result(self, region_id: int, log_id: int):
        return self._apply_results.take(region_id, log_id)

    # -- Engine::VectorReader --------------------------------------------------
    def new_vector_reader(self, region: Region, read_ts: int = MAX_TS) -> VectorReader:
        ctx = ReaderContext(
            region_id=region.id,
            partition_id=region.definition.partition_id,
            start_key=region.definition.start_key,
            end_key=region.definition.end_key,
            index_wrapper=region.vector_index_wrapper,
            engine=self.raw,
            read_ts=read_ts,
            parameter=region.definition.index_parameter,
        )
        return VectorReader(ctx, device=self.device)
