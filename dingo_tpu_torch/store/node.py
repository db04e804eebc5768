"""StoreNode: one store process's region lifecycle (port of
dingo_tpu/store/node.py).

Ties together what reference main.cc wires at startup (§3.3): raw engine,
raft store engine, store meta manager, vector index manager and the
storage facade. Every index the node builds lives on its ``device`` (None
= the CUDA device; DeviceUnavailable without one).

The port carries the region lifecycle only: ``create_region``,
``delete_region``, ``recover``, ``get_region`` and ``stop``, plus the
post-install rebuild that the region-install apply handler calls. The
control plane (coordinator heartbeats, region commands, split and merge,
vector-index snapshot pulls) raises NotPorted, and the node takes no
coordinator.

``MonoStoreNode`` is the same lifecycle over a MonoStoreEngine (a single
replica, no raft): the node of a MONO_STORE deployment.
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.engine.mono_engine import MonoStoreEngine
from dingo_tpu_torch.engine.raft_engine import RaftStoreEngine
from dingo_tpu_torch.engine.raw_engine import MemEngine, RawEngine
from dingo_tpu_torch.engine.storage import Storage
from dingo_tpu_torch.index.base import NotPorted
from dingo_tpu_torch.index.manager import VectorIndexManager
from dingo_tpu_torch.store.region import (
    Region,
    RegionDefinition,
    RegionState,
    StoreMetaManager,
)


def _control_plane(name: str):
    def not_ported(self, *args, **kwargs):
        raise NotPorted(f"StoreNode.{name} (the store's control plane) is "
                        "not ported yet")

    not_ported.__name__ = name
    return not_ported


def _materialize(node, definition: RegionDefinition) -> Region:
    """A region of `definition` with its own empty index, in `node`'s meta
    (CreateRegionTask's part that both node kinds share)."""
    region = Region(copy.deepcopy(definition), device=node.device)
    wrapper = region.vector_index_wrapper
    if wrapper is not None:
        wrapper.build_own()
        wrapper.set_own(wrapper.own_index)
    node.meta.add_region(region)
    return region


class StoreNode:
    def __init__(
        self,
        store_id: str,
        transport,
        coordinator=None,
        raw_engine: Optional[RawEngine] = None,
        snapshot_root: Optional[str] = None,
        raft_kw: Optional[dict] = None,
        device=None,
    ):
        if coordinator is not None:
            raise NotPorted("the coordinator is not ported yet")
        self.store_id = store_id
        self.coordinator = None
        self.device = resolve_device(device)
        self.raw = raw_engine or MemEngine()
        self.engine = RaftStoreEngine(self.raw, store_id, transport,
                                      context=self, device=self.device)
        self.meta = StoreMetaManager(self.raw, device=self.device)
        self.index_manager = VectorIndexManager(self.raw, snapshot_root,
                                                device=self.device)
        self.storage = Storage(self.engine)
        self.raft_kw = raft_kw or {}
        self._lock = threading.RLock()

    # ---------------- region lifecycle (RegionController tasks) -------------
    def create_region(self, definition: RegionDefinition) -> Region:
        """CreateRegionTask: materialize a region + its raft member."""
        with self._lock:
            existing = self.meta.get_region(definition.region_id)
            if existing is not None:
                return existing
            region = _materialize(self, definition)
            self.engine.add_node(region, definition.peers, **self.raft_kw)
            region.set_state(RegionState.NORMAL, "created")
            return region

    def delete_region(self, region_id: int) -> None:
        """DeleteRegionTask + purge."""
        with self._lock:
            region = self.meta.get_region(region_id)
            self.engine.stop_node(region_id)
            if region is not None:
                region.set_state(RegionState.DELETING, "coordinator cmd")
                if region.vector_index_wrapper:
                    region.vector_index_wrapper.stop()
            self.meta.delete_region(region_id)

    def recover(self) -> int:
        """Full restart recovery (main.cc:1074-1076 ordering): reload region
        meta, re-add each region's raft member, and rebuild in-memory
        vector indexes from the engine (the dual-write contract: the
        engine is the source of truth, indexes are rebuildable views).
        Returns the number of recovered regions."""
        n = self.meta.recover()
        for region in self.meta.get_all_regions():
            with self._lock:
                if self.engine.get_node(region.id) is None:
                    self.engine.add_node(
                        region, region.definition.peers, **self.raft_kw
                    )
                wrapper = region.vector_index_wrapper
                if wrapper is not None and wrapper.own_index is None:
                    self.index_manager.rebuild(region)
        return n

    def get_region(self, region_id: int) -> Optional[Region]:
        return self.meta.get_region(region_id)

    def after_region_install(self, region: Region) -> None:
        """Post-install (RegionImport) rebuild of the vector index on this
        replica. Called from the RegionInstallData apply handler so EVERY
        replica rebuilds from its freshly installed engine state."""
        if region.vector_index_wrapper is not None:
            self.index_manager.rebuild(region)

    # ---------------- control plane: not ported ------------------------------
    propose_split = _control_plane("propose_split")
    handle_split = _control_plane("handle_split")
    propose_merge = _control_plane("propose_merge")
    handle_merge = _control_plane("handle_merge")
    finish_merge_index = _control_plane("finish_merge_index")
    finish_child_index = _control_plane("finish_child_index")
    pull_vector_index_snapshot = _control_plane("pull_vector_index_snapshot")
    heartbeat_once = _control_plane("heartbeat_once")
    start_heartbeat = _control_plane("start_heartbeat")
    execute_region_cmd = _control_plane("execute_region_cmd")

    # ---------------- shutdown ----------------------------------------------
    def stop(self) -> None:
        self.engine.stop()
        self.raw.close()


class MonoStoreNode:
    """Regions on one MonoStoreEngine: writes apply synchronously on the
    caller's thread, reads go through the same Storage and VectorReader
    as a replicated node's."""

    def __init__(self, raw_engine: Optional[RawEngine] = None,
                 snapshot_root: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.raw = raw_engine or MemEngine()
        self.engine = MonoStoreEngine(self.raw, device=self.device)
        self.meta = StoreMetaManager(self.raw, device=self.device)
        self.index_manager = VectorIndexManager(self.raw, snapshot_root,
                                                device=self.device)
        self.storage = Storage(self.engine)

    def create_region(self, definition: RegionDefinition) -> Region:
        existing = self.meta.get_region(definition.region_id)
        if existing is not None:
            return existing
        region = _materialize(self, definition)
        region.set_state(RegionState.NORMAL, "created")
        return region

    def get_region(self, region_id: int) -> Optional[Region]:
        return self.meta.get_region(region_id)

    def stop(self) -> None:
        self.raw.close()
