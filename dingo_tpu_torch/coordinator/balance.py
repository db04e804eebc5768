"""Balance schedulers: leader-count and region-count balancing (port of
dingo_tpu/coordinator/balance.py).

Reference: src/coordinator/balance_leader.{h,cc} + balance_region.{h,cc}
(~2.6K LoC) — periodic crontab schedulers that inspect the store/region maps
and emit transfer-leader / change-peer jobs. Filters (balance_leader.h:98-
123) skip unhealthy stores/regions; an inspection time window gates when
balancing may run (config_helper.h:46-48).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from dingo_tpu_torch.coordinator.control import CoordinatorControl, StoreState


@dataclasses.dataclass
class TransferLeaderOp:
    region_id: int
    from_store: str
    to_store: str


@dataclasses.dataclass
class MoveRegionOp:
    region_id: int
    from_store: str
    to_store: str


@dataclasses.dataclass
class ScaleReplicaOp:
    """Grow/shrink a region's replica set for read scaling (the mesh
    serving tier's coordinator arm): peers to add ride first, drops later —
    raft membership changes stay one server at a time."""

    region_id: int
    current: int
    target: int
    add_stores: List[str]
    drop_stores: List[str]
    #: heartbeat evidence the sizing read (event-ledger snapshot): the
    #: region's leader QPS and the per-replica QPS target in force
    qps: float = 0.0
    target_qps: float = 0.0
    floor: int = 0


#: load-aware weight: one load unit per this many index bytes (memory is a
#: capacity signal alongside QPS — a cold 4GB leader still costs HBM)
LOAD_BYTES_PER_UNIT = 64 * 1024 * 1024
#: hysteresis floor: gaps under one load unit (1 QPS / 64MB) are noise —
#: acting on them would churn leadership for nothing (count mode's
#: `n_most <= n_least + 1` dead band, translated to load units)
MIN_LOAD_GAP = 1.0


def fresh_store_metrics(control: CoordinatorControl):
    """store_id -> snapshot for every ALIVE store with non-stale metrics
    (the one trust filter both the load balancer and the replica planner
    apply — staleness semantics must not diverge between schedulers)."""
    alive = {s.store_id for s in control.alive_stores()}
    rows = control.get_store_metrics()
    return {
        sid: snap for sid, snap, _at, stale in rows
        if not stale and sid in alive
    }


class BalanceLeaderScheduler:
    """Move leaders from the most-loaded store to the least-loaded one when
    the imbalance exceeds the ratio gate (BalanceLeaderScheduler).

    mode="count": load = leader tally (reference behavior).
    mode="load":  load = measured leader QPS + memory units from the
    store-metrics plane — two stores with EQUAL leader counts but skewed
    traffic rebalance under this mode where count mode sees no work.
    Falls back to count while metrics are missing or stale (a balancing
    decision on dead figures is worse than none)."""

    def __init__(self, control: CoordinatorControl, ratio_gate: float = 1.2,
                 mode: str = "count"):
        self.control = control
        self.ratio_gate = ratio_gate
        self.mode = mode

    # ---------------- load-aware helpers ----------------
    def _region_weights(self) -> Optional[Dict[str, Dict[int, float]]]:
        """store_id -> {led region_id -> weight}; None when any alive
        store lacks fresh metrics (fall back to count mode)."""
        alive = {s.store_id for s in self.control.alive_stores()}
        fresh = fresh_store_metrics(self.control)
        if alive - set(fresh):
            return None
        out: Dict[str, Dict[int, float]] = {}
        for sid, snap in fresh.items():
            out[sid] = {
                rm.region_id:
                    rm.search_qps
                    + (rm.vector_memory_bytes + rm.device_memory_bytes)
                    / LOAD_BYTES_PER_UNIT
                for rm in snap.regions if rm.is_leader
            }
        return out

    def plan(self) -> List[TransferLeaderOp]:
        if self.mode == "load":
            weights = self._region_weights()
            if weights is not None:
                return self._plan_load(weights)
        return self._plan_count()

    def _plan_count(self) -> List[TransferLeaderOp]:
        stores = self.control.alive_stores()
        if len(stores) < 2:
            return []
        by_leaders = sorted(stores, key=lambda s: len(s.leader_region_ids))
        least, most = by_leaders[0], by_leaders[-1]
        n_least = len(least.leader_region_ids)
        n_most = len(most.leader_region_ids)
        if n_most <= n_least + 1:
            return []
        if n_least > 0 and n_most / max(n_least, 1) < self.ratio_gate:
            return []
        ops = []
        movable = [
            rid for rid in most.leader_region_ids
            # target must already host a replica to receive leadership
            if least.store_id in
            (self.control.regions.get(rid).peers
             if self.control.regions.get(rid) else [])
        ]
        to_move = (n_most - n_least) // 2
        for rid in movable[:to_move]:
            ops.append(TransferLeaderOp(rid, most.store_id, least.store_id))
        return ops

    def _plan_load(self, weights: Dict[str, Dict[int, float]]
                   ) -> List[TransferLeaderOp]:
        stores = self.control.alive_stores()
        if len(stores) < 2:
            return []
        load = {
            s.store_id: sum(weights.get(s.store_id, {}).values())
            for s in stores
        }
        by_load = sorted(stores, key=lambda s: load[s.store_id])
        least, most = by_load[0], by_load[-1]
        l_least, l_most = load[least.store_id], load[most.store_id]
        gap = l_most - l_least
        if gap < MIN_LOAD_GAP:
            return []
        if l_least > 0 and l_most / l_least < self.ratio_gate:
            return []
        # move the heaviest movable leaders first, stopping once half the
        # gap shifts. Each move must STRICTLY shrink the gap (w < remaining
        # gap): with a single dominant leader, w == gap would mirror the
        # skew exactly and the next tick would move it straight back —
        # perpetual leadership ping-pong
        movable = sorted(
            (
                (w, rid) for rid, w in weights[most.store_id].items()
                if least.store_id in
                (self.control.regions.get(rid).peers
                 if self.control.regions.get(rid) else [])
            ),
            reverse=True,
        )
        ops: List[TransferLeaderOp] = []
        moved = 0.0
        for w, rid in movable:
            if moved >= gap / 2 or w >= gap - moved:
                continue
            ops.append(TransferLeaderOp(rid, most.store_id, least.store_id))
            moved += w
        return ops

    def dispatch(self) -> int:
        ops = self.plan()
        for op in ops:
            self.control.transfer_leader(op.region_id, op.to_store)
        return len(ops)


class ReplicaPlanScheduler:
    """Scale a region's read-replica count from its measured QPS
    (`balance.replica_mode = auto`): regions hotter than
    `balance.replica_qps_target` per replica gain replicas on the
    least-loaded stores; regions that cooled back down drop follower
    replicas from the most-loaded stores — never below the cluster's
    configured raft replication (the base peers are quorum, not elastic
    read capacity). The store-side mechanism is
    parallel/replica_group.py (device slices) or extra raft followers
    serving follower reads — this tier only decides COUNT and PLACEMENT
    from the heartbeat metrics plane, like the reference's region
    scheduler family."""

    def __init__(self, control: CoordinatorControl,
                 mode: Optional[str] = None,
                 qps_target: Optional[float] = None,
                 max_replicas: int = 5):
        self.control = control
        self._mode = mode
        self._qps_target = qps_target
        self.max_replicas = max_replicas

    def _flag(self, name: str, override):
        if override is not None:
            return override
        from dingo_tpu_torch.common.config import FLAGS

        return FLAGS.get(name)

    def plan(self) -> List[ScaleReplicaOp]:
        mode = self._flag("balance_replica_mode", self._mode)
        if mode != "auto":
            return []
        target_qps = float(
            self._flag("balance_replica_qps_target", self._qps_target)
        )
        fresh = fresh_store_metrics(self.control)
        if not fresh:
            return []    # planning replicas on dead figures is worse than none
        # store load (for placement) + per-region leader QPS (for sizing)
        store_load = {
            sid: sum(
                rm.search_qps
                + (rm.vector_memory_bytes + rm.device_memory_bytes)
                / LOAD_BYTES_PER_UNIT
                for rm in snap.regions
            )
            for sid, snap in fresh.items()
        }
        region_qps = {}
        for sid, snap in fresh.items():
            for rm in snap.regions:
                if rm.is_leader:
                    region_qps[rm.region_id] = rm.search_qps
        # NEVER shrink below the cluster's configured raft replication:
        # the base peers are write durability / quorum, only replicas the
        # planner ADDED beyond that are elastic read capacity. (Without
        # this floor every quiet region would erode to a single peer.)
        floor = max(1, int(getattr(self.control, "replication", 1) or 1))
        ops: List[ScaleReplicaOp] = []
        for rid, qps in sorted(region_qps.items()):
            definition = self.control.regions.get(rid)
            if definition is None:
                continue
            peers = list(definition.peers)
            current = len(peers)
            want = max(1, -(-int(qps) // max(1, int(target_qps))))
            target = min(max(want, floor), max(self.max_replicas, floor))
            # hysteresis: one-step moves only, and never below the raft
            # quorum floor the region was created with is the control
            # plane's concern — this planner only adds/removes ONE peer
            # per tick so a QPS spike can't thrash membership
            if target > current:
                cand = sorted(
                    (s for s in store_load if s not in peers),
                    key=lambda s: store_load[s],
                )
                if not cand:
                    continue
                ops.append(ScaleReplicaOp(
                    rid, current, current + 1, [cand[0]], [],
                    qps=float(qps), target_qps=target_qps, floor=floor,
                ))
            elif target < current and current > floor:
                leader = next(
                    (s.store_id for s in self.control.alive_stores()
                     if rid in s.leader_region_ids), None
                )
                followers = [s for s in peers if s != leader]
                if not followers:
                    continue
                drop = max(
                    followers, key=lambda s: store_load.get(s, 0.0)
                )
                ops.append(ScaleReplicaOp(
                    rid, current, current - 1, [], [drop],
                    qps=float(qps), target_qps=target_qps, floor=floor,
                ))
        return ops

    def dispatch(self) -> int:
        from dingo_tpu_torch.obs.events import EVENTS

        ops = self.plan()
        for op in ops:
            peers = list(self.control.regions[op.region_id].peers)
            for s in op.add_stores:
                peers = peers + [s]
                self.control.change_peer(op.region_id, peers)
            for s in op.drop_stores:
                peers = [p for p in peers if p != s]
                self.control.change_peer(op.region_id, peers)
            EVENTS.emit(
                "planner", op.region_id, "replicas", op.current, op.target,
                trigger="scale",
                evidence={
                    "qps": round(op.qps, 3),
                    "target_qps": op.target_qps,
                    "floor": op.floor,
                    "add": list(op.add_stores),
                    "drop": list(op.drop_stores),
                },
            )
        return len(ops)


class BalanceRegionScheduler:
    """Move replicas from crowded stores to empty ones (BalanceRegion)."""

    def __init__(self, control: CoordinatorControl, ratio_gate: float = 1.3):
        self.control = control
        self.ratio_gate = ratio_gate

    def plan(self) -> List[MoveRegionOp]:
        stores = self.control.alive_stores()
        if len(stores) < 2:
            return []
        by_regions = sorted(stores, key=lambda s: len(s.region_ids))
        least, most = by_regions[0], by_regions[-1]
        n_least, n_most = len(least.region_ids), len(most.region_ids)
        if n_most <= n_least + 1:
            return []
        if n_least > 0 and n_most / max(n_least, 1) < self.ratio_gate:
            return []
        ops = []
        for rid in most.region_ids:
            definition = self.control.regions.get(rid)
            if definition is None or least.store_id in definition.peers:
                continue
            ops.append(MoveRegionOp(rid, most.store_id, least.store_id))
            if len(ops) >= (n_most - n_least) // 2:
                break
        return ops

    def dispatch(self) -> int:
        ops = self.plan()
        for op in ops:
            definition = self.control.regions[op.region_id]
            # Two-phase: add the new peer, then remove the old one — raft
            # single-step membership changes stay safe only one server at a
            # time (simultaneous add+remove can elect two leaders).
            self.control.change_peer(
                op.region_id, definition.peers + [op.to_store]
            )
            self.control.change_peer(
                op.region_id,
                [p for p in self.control.regions[op.region_id].peers
                 if p != op.from_store],
            )
        return len(ops)
