"""RaftStoreEngine: raft-replicated engine (port of
dingo_tpu/engine/raft_engine.py; region readers use the engine's device).

Reference: src/engine/raft_store_engine.{h,cc} — one RaftNode per region
(raft_node_manager_, raft_store_engine.cc:67,232); Write = propose + wait
(:417-444); reads go straight to the RawEngine (:466+) since committed state
is applied locally. The state machine callback dispatches committed payloads
through the same apply handlers the mono engine uses
(StoreStateMachine::on_apply -> RaftApplyHandlerFactory, §3.2).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.engine.apply import apply_write
from dingo_tpu_torch.engine.apply_results import ApplyResultBuffer
from dingo_tpu_torch.engine.raw_engine import ALL_CFS, CF_META, RawEngine, WriteBatch
from dingo_tpu_torch.engine.write_data import WriteData, decode_write, encode_write
from dingo_tpu_torch.raft import wire
from dingo_tpu_torch.index.vector_reader import ReaderContext, VectorReader
from dingo_tpu_torch.mvcc.codec import MAX_TS, Codec
from dingo_tpu_torch.raft.core import RaftNode
from dingo_tpu_torch.raft.transport import Transport
from dingo_tpu_torch.store.region import Region


def region_bounds(region: Region):
    """Encoded key range of a region in the mvcc-encoded CFs. An empty
    end_key (unbounded region) maps to None — encoding b"" would produce
    the MINIMUM key and make the range empty."""
    start = Codec.encode_bytes(region.definition.start_key)
    end_key = region.definition.end_key
    end = Codec.encode_bytes(end_key) if end_key else None
    return start, end


def region_snapshot(raw: RawEngine, region: Region) -> dict:
    """{cf: [(k, v)]} for this region's range only (meta CF excluded —
    store-local, never replicated)."""
    start, end = region_bounds(region)
    out = {}
    for cf in ALL_CFS:
        if cf == CF_META:
            continue
        pairs = raw.scan(cf, start, end)
        if pairs:
            out[cf] = pairs
    return out


def region_install(raw: RawEngine, region: Region, state: dict) -> None:
    start, end = region_bounds(region)
    batch = WriteBatch()
    for cf in ALL_CFS:
        if cf == CF_META:
            continue
        batch.delete_range(cf, start, end)
    for cf, pairs in state.items():
        for k, v in pairs:
            batch.put(cf, k, v)
    raw.write(batch)


class RaftStoreEngine:
    """Holds this store's raw engine + the raft node per hosted region."""

    def __init__(self, raw_engine: RawEngine, store_id: str,
                 transport: Transport, context=None, device=None):
        self.raw = raw_engine
        #: where region readers build their brute-force index
        self.device = resolve_device(device)
        self.store_id = store_id
        self.transport = transport
        #: hosting StoreNode (split handler + topology callbacks)
        self.context = context
        self._lock = threading.Lock()
        self._nodes: Dict[int, RaftNode] = {}   # RaftNodeManager
        self._regions: Dict[int, Region] = {}
        # propose() blocks until the local apply ran, so a proposer can
        # collect its applied outcome (e.g. delete_range counts) right
        # after write() returns; see ApplyResultBuffer for the waiter
        # gating that spares followers/replay the computation
        self._apply_results = ApplyResultBuffer()

    # -- node management (RaftNodeManager / AddNode) -------------------------
    def node_address(self, region_id: int) -> str:
        return f"{self.store_id}/r{region_id}"

    def add_node(self, region: Region, peer_store_ids, log=None,
                 **raft_kw) -> RaftNode:
        """AddNode (raft_store_engine.cc:232): start this region's raft
        member on this store."""
        region_id = region.id

        def apply_fn(index: int, payload: bytes) -> None:
            data = decode_write(payload)
            result = apply_write(
                self.raw, region, data, index, context=self.context,
                want_result=self._apply_results.wanted(region_id, data),
            )
            if result is not None:
                self._apply_results.record(region_id, index, result)

        def snapshot_save() -> bytes:
            # REGION-scoped checkpoint (the reference streams per-region
            # RocksDB SSTs through DingoFileSystemAdaptor): only this
            # region's key range, across all CFs — a store hosts many
            # regions on one raw engine and must not ship the others.
            return wire.encode(region_snapshot(self.raw, region))

        def snapshot_install(blob: bytes) -> None:
            region_install(self.raw, region, wire.decode(blob))
            # in-memory index must be rebuilt after a state install
            wrapper = region.vector_index_wrapper
            if wrapper is not None:
                wrapper.ready = False

        node = RaftNode(
            self.node_address(region_id),
            [f"{sid}/r{region_id}" for sid in peer_store_ids],
            self.transport,
            log=log,
            apply_fn=apply_fn,
            snapshot_save_fn=snapshot_save,
            snapshot_install_fn=snapshot_install,
            **raft_kw,
        )
        with self._lock:
            self._nodes[region_id] = node
            self._regions[region_id] = region
        node.start()
        return node

    def get_node(self, region_id: int) -> Optional[RaftNode]:
        with self._lock:
            return self._nodes.get(region_id)

    def stop_node(self, region_id: int) -> None:
        with self._lock:
            node = self._nodes.pop(region_id, None)
            self._regions.pop(region_id, None)
        if node:
            node.stop()

    def stop(self) -> None:
        with self._lock:
            nodes = list(self._nodes.values())
            self._nodes.clear()
        for n in nodes:
            n.stop()

    # -- Engine::Writer (Write = propose + wait, raft_store_engine.cc:417) ---
    def write(self, region: Region, data: WriteData, timeout: float = 5.0) -> int:
        node = self.get_node(region.id)
        if node is None:
            raise RuntimeError(f"no raft node for region {region.id}")
        payload = encode_write(data)
        waiter = self._apply_results.register_waiter(region.id, data)
        try:
            return node.propose(payload, timeout=timeout)
        finally:
            self._apply_results.unregister_waiter(waiter)

    def take_apply_result(self, region_id: int, log_id: int):
        """Result recorded by this region's apply handler for log_id (None
        if the handler produced none)."""
        return self._apply_results.take(region_id, log_id)

    # -- Engine::VectorReader -------------------------------------------------
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
