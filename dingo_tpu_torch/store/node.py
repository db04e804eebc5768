"""StoreNode: one store process — engine + regions + controller + heartbeat
(port of dingo_tpu/store/node.py).

Ties together what reference main.cc wires at startup (§3.3): raw engine,
raft store engine, store meta manager, vector index manager, storage facade,
region controller, heartbeat. Also hosts the SplitHandler context: a raft-
committed split creates the child region on every replica and shares the
parent's vector index until the child's own rebuild completes
(raft_apply_handler.cc:702, SetShareVectorIndex :372,630). Every index the
node builds lives on its ``device`` (None = the CUDA device;
DeviceUnavailable without one).

The coordinator is reached in process (a CoordinatorControl, or a
RaftMetaCoordinator's ``control``). The vector-index snapshot pull from a
peer goes over gRPC and raises NotPorted, as do DOCUMENT regions.

``MonoStoreNode`` is the region lifecycle over a MonoStoreEngine (a single
replica, no raft, no coordinator): the node of a MONO_STORE deployment.
"""

from __future__ import annotations

import copy
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import List, Optional

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.common.log import get_logger, region_log
from dingo_tpu_torch.coordinator.control import RegionCmd, RegionCmdType
from dingo_tpu_torch.engine import write_data as wd
from dingo_tpu_torch.engine.mono_engine import MonoStoreEngine
from dingo_tpu_torch.engine.raft_engine import RaftStoreEngine
from dingo_tpu_torch.engine.raw_engine import MemEngine, RawEngine
from dingo_tpu_torch.engine.storage import Storage
from dingo_tpu_torch.index.base import NotPorted
from dingo_tpu_torch.index.manager import VectorIndexManager
from dingo_tpu_torch.metrics.collector import StoreMetricsCollector
from dingo_tpu_torch.raft.core import NotLeader
from dingo_tpu_torch.store.region import (
    Region,
    RegionDefinition,
    RegionState,
    StoreMetaManager,
)

_log = get_logger("store.node")


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
        self.store_id = store_id
        self.coordinator = coordinator
        self.device = resolve_device(device)
        self.raw = raw_engine or MemEngine()
        self.engine = RaftStoreEngine(self.raw, store_id, transport,
                                      context=self, device=self.device)
        self.meta = StoreMetaManager(self.raw, device=self.device)
        self.index_manager = VectorIndexManager(self.raw, snapshot_root,
                                                device=self.device)
        self.storage = Storage(self.engine)
        #: per-region metrics snapshots (StoreMetricsManager analog);
        #: ticked by the metrics crontab, attached to every heartbeat
        self.metrics = StoreMetricsCollector(self)
        self.raft_kw = raft_kw or {}
        self._lock = threading.RLock()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        #: cmd_ids already executed — a coordinator leader failover re-arms
        #: 'sent' commands (reset_sent_cmds) so delivery is at-least-once;
        #: this makes execution exactly-once on the store
        self._done_cmd_ids: "OrderedDict[int, None]" = OrderedDict()
        #: executed cmd_ids not yet acked to the coordinator; reported in
        #: the next heartbeat so the coordinator prunes its queues
        self._unacked_done: set = set()
        #: failed cmd_ids not yet nacked — the coordinator re-arms them
        #: (with its retry budget) on the next heartbeat
        self._failed_cmds: set = set()
        #: cmd_ids stalled on leadership churn — re-armed WITHOUT charging
        #: the retry budget (an election is not a command defect)
        self._stalled_cmds: set = set()
        if coordinator is not None:
            coordinator.register_store(store_id)

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

    # ---------------- split (raft-replicated) -------------------------------
    def propose_split(self, region_id: int, split_key: bytes,
                      child_region_id: int) -> None:
        """SplitRegionTask: leader proposes; SplitHandler applies on every
        replica via handle_split below."""
        region = self.meta.get_region(region_id)
        if region is None:
            raise KeyError(f"region {region_id} not hosted")
        self.engine.write(region, wd.SplitRegionData(
            child_region_id=child_region_id, split_key=split_key,
        ))

    def handle_split(self, parent: Region, data: wd.SplitRegionData,
                     log_id: int) -> None:
        """SplitHandler::Handle (raft_apply_handler.cc:702), applied on every
        replica: shrink parent, create child with the SAME peers, share the
        parent's vector index with the child until its own build finishes."""
        with self._lock:
            if self.meta.get_region(data.child_region_id) is not None:
                return  # replayed entry
            child_def = RegionDefinition(
                region_id=data.child_region_id,
                start_key=data.split_key,
                end_key=parent.definition.end_key,
                partition_id=parent.definition.partition_id,
                peers=list(parent.definition.peers),
                region_type=parent.definition.region_type,
                index_parameter=parent.definition.index_parameter,
                document_schema=parent.definition.document_schema,
            )
            child_def.epoch.version = parent.definition.epoch.version + 1
            parent.definition.end_key = data.split_key
            parent.definition.epoch.version += 1
            self.meta.update_region(parent)

            child = Region(child_def, device=self.device)
            if child.vector_index_wrapper is not None and \
                    parent.vector_index_wrapper is not None:
                # child serves from the parent's index (filtered by its own
                # range) until rebuilt — SetShareVectorIndex semantics
                child.vector_index_wrapper.set_share(
                    parent.vector_index_wrapper
                )
            self.meta.add_region(child)
            self.engine.add_node(child, child_def.peers, **self.raft_kw)
            child.set_state(RegionState.NORMAL, f"split from {parent.id}")
        # leader reports the new topology to the coordinator
        node = self.engine.get_node(parent.id)
        if self.coordinator is not None and node is not None and \
                node.is_leader():
            self.coordinator.on_region_split_done(parent.id, child_def)

    def propose_merge(self, target_region_id: int,
                      source_region_id: int) -> None:
        """MergeRegionTask: propose on the TARGET region's raft; applied on
        every replica via handle_merge (peers must be co-located — the
        coordinator aligns peers via change_peer first, as the reference's
        merge jobs do)."""
        target = self.meta.get_region(target_region_id)
        source = self.meta.get_region(source_region_id)
        if target is None or source is None:
            raise KeyError("merge requires both regions hosted")
        if target.definition.end_key != source.definition.start_key:
            raise ValueError("merge requires adjacent regions (target first)")
        self.engine.write(target, wd.MergeRegionData(
            source_region_id=source_region_id,
            source_end_key=source.definition.end_key,
        ))

    def handle_merge(self, target: Region, data: wd.MergeRegionData,
                     log_id: int) -> None:
        """CommitMergeHandler: target absorbs the source range; source's
        index becomes target's sibling; source region retires."""
        with self._lock:
            source = self.meta.get_region(data.source_region_id)
            if source is None:
                return  # replay after source already purged
            target.definition.end_key = data.source_end_key
            target.definition.epoch.version += 1
            self.meta.update_region(target)
            if (target.vector_index_wrapper is not None
                    and source.vector_index_wrapper is not None):
                target.vector_index_wrapper.set_sibling(
                    source.vector_index_wrapper
                )
            source.set_state(RegionState.TOMBSTONE,
                             f"merged into {target.id}")
            src_node = self.engine.get_node(source.id)
        # Quiesce OUTSIDE self._lock (holding it would stall every other
        # region's apply/heartbeat for the whole wait): let the source state
        # machine drain committed entries before retiring it (the
        # reference's PrepareMerge freezes the source first; losing
        # committed-but-unapplied writes would diverge replicas).
        if src_node is not None:
            deadline = time.monotonic() + 2.0
            while (src_node.last_applied < src_node.commit_index
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        self.engine.stop_node(source.id)
        self.meta.delete_region(source.id)
        node = self.engine.get_node(target.id)
        if self.coordinator is not None and node is not None \
                and node.is_leader():
            self.coordinator.on_region_merge_done(
                target.id, data.source_region_id, target.definition
            )

    def finish_merge_index(self, target_region_id: int) -> None:
        """Post-merge rebuild: own index covers the absorbed range, sibling
        dropped (reference: rebuild task after merge)."""
        target = self.meta.get_region(target_region_id)
        if target is None or target.vector_index_wrapper is None:
            return
        self.index_manager.rebuild(target)
        target.vector_index_wrapper.set_sibling(None)

    def after_region_install(self, region: Region) -> None:
        """Post-install (RegionImport) rebuild of the vector index on this
        replica. Called from the RegionInstallData apply handler so EVERY
        replica rebuilds from its freshly installed engine state."""
        if region.vector_index_wrapper is not None:
            self.index_manager.rebuild(region)

    def finish_child_index(self, child_region_id: int) -> None:
        """Post-split rebuild: give the child its own index and drop the
        share (reference: child rebuild task then UpdateVectorIndex)."""
        child = self.meta.get_region(child_region_id)
        if child is None or child.vector_index_wrapper is None:
            return
        self.index_manager.rebuild(child)  # clears the share on swap

    # ---------------- vector index snapshot transfer ------------------------
    def pull_vector_index_snapshot(self, region_id: int,
                                   peer_addr: str) -> bool:
        """PullLastSnapshotFromPeers: NodeService + FileService over gRPC."""
        raise NotPorted("StoreNode.pull_vector_index_snapshot (gRPC) is not "
                        "ported yet")

    # ---------------- heartbeat --------------------------------------------
    def heartbeat_once(self) -> List[RegionCmd]:
        """StoreHeartbeat (store/heartbeat.cc:61): send region metrics, then
        execute the returned region commands."""
        if self.coordinator is None:
            return []
        regions = self.meta.get_all_regions()
        leader_ids = [
            r.id for r in regions
            if (n := self.engine.get_node(r.id)) is not None and n.is_leader()
        ]
        acking = list(self._unacked_done)
        nacking = list(self._failed_cmds)
        stalling = list(self._stalled_cmds)
        snap = self.metrics.maybe_collect(
            max_age_s=float(FLAGS.get("metrics_collect_interval_s"))
        )
        cmds = self.coordinator.store_heartbeat(
            self.store_id,
            region_ids=[r.id for r in regions],
            leader_region_ids=leader_ids,
            region_defs=[r.definition for r in regions
                         if r.id in leader_ids],
            done_cmd_ids=acking,
            failed_cmd_ids=nacking,
            stalled_cmd_ids=stalling,
            metrics=snap,
        )
        # the call returned, so the coordinator applied the acks (raft-
        # replicated coordinators apply before responding)
        self._unacked_done.difference_update(acking)
        self._failed_cmds.difference_update(nacking)
        self._stalled_cmds.difference_update(stalling)
        # with an in-process replicated coordinator, the returned cmds ARE
        # the leader state machine's live objects — the status/retries
        # mutations below must never touch replicated state directly
        # (leader would transiently fork from followers)
        cmds = [copy.deepcopy(c) for c in cmds]
        for cmd in cmds:
            if cmd.cmd_id in self._done_cmd_ids:
                cmd.status = "done"    # duplicate delivery after coordinator
                self._unacked_done.add(cmd.cmd_id)  # failover — re-ack only
                continue
            try:
                region_log(_log, cmd.region_id).debug(
                    "executing cmd %d type=%s", cmd.cmd_id,
                    cmd.cmd_type.value)
                self.execute_region_cmd(cmd)
                cmd.status = "done"
                self._done_cmd_ids[cmd.cmd_id] = None
                self._unacked_done.add(cmd.cmd_id)
                while len(self._done_cmd_ids) > 10_000:
                    self._done_cmd_ids.popitem(last=False)
            except NotLeader as e:
                # leadership moved: hand the command to the hinted leader
                # ("<store>/r<region>" address) or nack it back to the
                # coordinator's queue (re-armed on the next beat)
                if e.leader_hint:
                    hinted_store = e.leader_hint.split("/")[0]
                    self.coordinator.requeue_cmd(
                        cmd, hinted_store, from_store=self.store_id
                    )
                else:
                    cmd.status = "pending"
                    self._stalled_cmds.add(cmd.cmd_id)
            except Exception as e:  # noqa: BLE001
                # transient failure: nack so the coordinator re-arms the
                # cmd next beat (the coordinator owns the retry budget —
                # the local objects are copies, mutating them cannot reach
                # its queues)
                cmd.status = f"failed: {e}"
                self._failed_cmds.add(cmd.cmd_id)
                region_log(_log, cmd.region_id).warning(
                    "cmd %d type=%s failed (nacking): %s", cmd.cmd_id,
                    cmd.cmd_type.value, e)
        return cmds

    def start_heartbeat(self, interval_s: float = 1.0) -> None:
        def loop():
            while not self._hb_stop.wait(interval_s):
                try:
                    self.heartbeat_once()
                except Exception:  # noqa: BLE001 — the next beat retries
                    pass

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    # ---------------- region command execution ------------------------------
    def execute_region_cmd(self, cmd: RegionCmd) -> None:
        """RegionController::DispatchRegionControlCommand
        (region_controller.h:406) — tasks :40-314."""
        t = cmd.cmd_type
        if t is RegionCmdType.CREATE:
            assert cmd.definition is not None
            self.create_region(cmd.definition)
        elif t is RegionCmdType.DELETE:
            self.delete_region(cmd.region_id)
        elif t is RegionCmdType.SPLIT:
            self.propose_split(cmd.region_id, cmd.split_key,
                               cmd.child_region_id)
        elif t is RegionCmdType.MERGE:
            # cmd.region_id = target, child_region_id field carries source
            self.propose_merge(cmd.region_id, cmd.child_region_id)
        elif t is RegionCmdType.CHANGE_PEER:
            # ChangePeerRegionTask: refresh the raft member list so the
            # leader replicates to added peers and drops removed ones
            assert cmd.definition is not None
            region = self.meta.get_region(cmd.region_id)
            node = self.engine.get_node(cmd.region_id)
            if region is not None:
                region.definition.peers = list(cmd.definition.peers)
                region.definition.epoch.conf_version = \
                    cmd.definition.epoch.conf_version
                self.meta.update_region(region)
            if node is not None:
                node.update_peers([
                    f"{sid}/r{cmd.region_id}" for sid in cmd.definition.peers
                ])
        elif t is RegionCmdType.TRANSFER_LEADER:
            node = self.engine.get_node(cmd.region_id)
            if node is not None:
                node.transfer_leadership(
                    f"{cmd.target_store_id}/r{cmd.region_id}"
                )
        elif t is RegionCmdType.SNAPSHOT:
            self.raw.checkpoint(os.path.join(
                tempfile.gettempdir(), f"dingo_ckpt_{self.store_id}"))
        elif t is RegionCmdType.HOLD_VECTOR_INDEX:
            region = self.meta.get_region(cmd.region_id)
            w = region.vector_index_wrapper if region is not None else None
            # build the region's OWN index when absent — is_ready() can be
            # true via a post-split share, which must not suppress the build
            if w is not None and (w.own_index is None or not w.ready
                                  or w.share_index is not None):
                self.index_manager.rebuild(region)
        elif t is RegionCmdType.SNAPSHOT_VECTOR_INDEX:
            region = self.meta.get_region(cmd.region_id)
            if region is not None:
                self.index_manager.save_index(region)
        elif t is RegionCmdType.TIER_DEMOTE:
            # capacity-plane handshake (index/tiering.py): flag the region
            # for the store's own memory_tier tick, which picks the moment
            # and the rung. Acked with tiering off too: a command the store
            # will never act on must not cycle through the coordinator's
            # retries as a failure
            from dingo_tpu_torch.index.tiering import TIERING

            if TIERING.enabled():
                TIERING.note_advisory(cmd.region_id)
        elif t in (RegionCmdType.STOP, RegionCmdType.PURGE):
            self.engine.stop_node(cmd.region_id)
        else:
            raise ValueError(f"unhandled region cmd {t}")

    # ---------------- shutdown ----------------------------------------------
    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
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
