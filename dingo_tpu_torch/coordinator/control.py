"""CoordinatorControl: the cluster brain (port of
dingo_tpu/coordinator/control.py).

Reference: src/coordinator/coordinator_control.{h,cc} + _coor/_fsm/_meta/
_watch.cc (~14K LoC) — id epochs, store/executor registry, region CRUD
(CreateRegionFinal coordinator_control.h:263, SplitRegionWithJob :304,
MergeRegionWithJob :309, ChangePeerRegionWithJob :313,
TransferLeaderRegionWithJob :319), store-operation queues pushed to stores
(RpcSendPushStoreOperation :547, AddRegionCmd :565), orphan recycling, and
heartbeat-driven store state (UpdateStoreState crontab; CheckRegionAllPeerOnline
:597-599).

State mutations go through MetaIncrement records persisted to the meta CF
(the reference replicates them via MetaStateMachine raft; the same
CoordinatorControl can sit behind a RaftNode by routing _persist through
propose — single-coordinator deployments write directly).

Ported: store registration, heartbeats and liveness; the command queue
with acks, nacks, stalls and requeue; region create/drop/split/merge and
their done reports; leader transfer, peer change, the GC safe point,
region health; the capacity plane; persistence and recovery from CF_META
(the persisted bytes equal the JAX package's); the replica-digest
integrity comparison (``diverged_regions``), the control-plane event
timeline (``cluster_events``, ``explain_region_overrides``) and the flight
captures of a divergence and of a dropped command.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.common.log import get_logger, region_log
from dingo_tpu_torch.common.metrics import METRICS
# heartbeat metrics payloads ride persist-encoded raft proposals on the
# replicated coordinator — the snapshot types must be registered before
# any log replay decodes one, so import them eagerly here
from dingo_tpu_torch.metrics import snapshot as _metrics_snapshot  # noqa: F401
from dingo_tpu_torch.engine.raw_engine import CF_META, RawEngine
from dingo_tpu_torch.index.base import IndexParameter
from dingo_tpu_torch.store.region import (
    RegionDefinition,
    RegionEpoch,
    RegionType,
)

_log = get_logger("coordinator.control")

_PREFIX_STORE = b"COOR_STORE_"
_PREFIX_REGION = b"COOR_REGION_"
_PREFIX_IDS = b"COOR_IDS_"
_KEY_OPS = b"COOR_OPS__"

#: the document index's column types (dingo_tpu/document/index.py), which
#: create_region validates a DOCUMENT region's schema against
COLUMN_TYPES = ("text", "i64", "f64", "bytes", "bool")


@persist.register
class StoreState(enum.Enum):
    """pb::common::StoreState."""

    NORMAL = "normal"
    OFFLINE = "offline"


@persist.register
class RegionCmdType(enum.Enum):
    """pb::coordinator::RegionCmdType subset (region_controller.h:40-314)."""

    CREATE = "create"
    DELETE = "delete"
    SPLIT = "split"
    MERGE = "merge"
    CHANGE_PEER = "change_peer"
    TRANSFER_LEADER = "transfer_leader"
    SNAPSHOT = "snapshot"
    PURGE = "purge"
    STOP = "stop"
    HOLD_VECTOR_INDEX = "hold_vector_index"
    SNAPSHOT_VECTOR_INDEX = "snapshot_vector_index"
    #: capacity-plane demote advisory -> store actuation handshake: the
    #: store flags the region for its memory-tier ladder (index/tiering)
    #: and the LOCAL policy tick picks the moment — the coordinator never
    #: forces a copy mid-burst
    TIER_DEMOTE = "tier_demote"


@persist.register
@dataclasses.dataclass
class RegionCmd:
    cmd_id: int
    region_id: int
    cmd_type: RegionCmdType
    definition: Optional[RegionDefinition] = None
    split_key: bytes = b""
    child_region_id: int = 0
    target_store_id: str = ""
    status: str = "pending"
    retries: int = 0
    #: store the cmd was queued to (job attribution; queues themselves are
    #: pruned once the store acks execution, so history lives in `jobs`)
    store_id: str = ""


@persist.register
@dataclasses.dataclass
class StoreInfo:
    store_id: str
    address: str = ""
    state: StoreState = StoreState.NORMAL
    last_heartbeat_ms: int = 0
    region_ids: List[int] = dataclasses.field(default_factory=list)
    leader_region_ids: List[int] = dataclasses.field(default_factory=list)
    capacity_bytes: int = 0
    used_bytes: int = 0


class CoordinatorControl:
    #: stores missing heartbeats longer than this go OFFLINE
    #: (server.heartbeat_interval_s based; UpdateStoreState crontab)
    OFFLINE_AFTER_MS = 30_000
    #: a store's metrics snapshot older than this is flagged stale in
    #: GetStoreMetrics/GetRegionMetrics and excluded from cluster rollups
    #: and load-aware balancing (3x the default heartbeat interval)
    METRICS_STALE_MS = 30_000

    def __init__(self, engine: RawEngine, replication: int = 3):
        self.engine = engine
        self.replication = replication
        self._lock = threading.RLock()
        self.stores: Dict[str, StoreInfo] = {}
        self.regions: Dict[int, RegionDefinition] = {}
        self.region_leaders: Dict[int, str] = {}
        #: per-store command queues (store operations pushed/pulled)
        self.store_ops: Dict[str, List[RegionCmd]] = {}
        #: freshest metrics snapshot per store -> (snapshot, received_ms).
        #: In-memory only, like the reference's bvar plane: telemetry is
        #: re-reported every beat, persisting it would only replay stale
        #: figures after a restart
        self.store_metrics: Dict[str, Tuple[object, int]] = {}
        #: capacity plane (coordinator/capacity.py): per-store plan
        #: re-derived from every beat's heat rollups. ADVISORY ONLY —
        #: tiering/split actuation is roadmap items 1-2. In-memory like
        #: store_metrics
        self.capacity_plans: Dict[str, Dict] = {}
        #: (store, region, kind) advisories already counted — the
        #: capacity.advisories counter ticks on NEW advice, not on every
        #: beat that re-derives the same one
        self._capacity_advised: set = set()
        self.jobs: List[RegionCmd] = []
        #: region id -> the evidence of a replica divergence at equal
        #: applied indices (state-integrity plane, obs/integrity.py)
        self.integrity_diverged: Dict[int, Dict] = {}
        #: regions a merge absorbed: a heartbeat whose region list was
        #: read before its store applied the merge must not bring one back
        #: (in memory, like store_metrics)
        self.merged_away: set = set()
        #: control-plane flight recorder (obs/events.py): the merged
        #: cluster timeline of controller decisions harvested from
        #: heartbeats plus the coordinator's own emissions (in memory,
        #: like store_metrics)
        from dingo_tpu_torch.obs.events import ClusterTimeline

        self.events = ClusterTimeline()
        self._next_region_id = 1000
        self._next_cmd_id = 1
        self._recover()

    # ---------------- persistence (MetaIncrement analog) -------------------
    def _persist(self, key: bytes, value) -> None:
        self.engine.put(CF_META, key, persist.dumps(value))

    def _recover(self) -> None:
        for k, v in self.engine.scan(CF_META, _PREFIX_STORE,
                                     _PREFIX_STORE + b"\xff"):
            info: StoreInfo = persist.loads(v)
            self.stores[info.store_id] = info
            self.store_ops.setdefault(info.store_id, [])
        for k, v in self.engine.scan(CF_META, _PREFIX_REGION,
                                     _PREFIX_REGION + b"\xff"):
            definition: RegionDefinition = persist.loads(v)
            self.regions[definition.region_id] = definition
        blob = self.engine.get(CF_META, _PREFIX_IDS)
        if blob:
            self._next_region_id, self._next_cmd_id = persist.loads(blob)
        blob = self.engine.get(CF_META, _KEY_OPS)
        if blob:
            self.store_ops, self.region_leaders = persist.loads(blob)
            # undelivered-but-marked-sent commands are re-sent after a crash
            for q in self.store_ops.values():
                for c in q:
                    if c.status == "sent":
                        c.status = "pending"

    def _persist_ids(self) -> None:
        self._persist(_PREFIX_IDS, (self._next_region_id, self._next_cmd_id))

    def _persist_ops(self) -> None:
        """Pending region commands + leadership map survive coordinator
        restart (the reference replicates these through MetaStateMachine)."""
        self._persist(_KEY_OPS, (self.store_ops, self.region_leaders))

    # ---------------- store registry ----------------------------------------
    def register_store(self, store_id: str, address: str = "", *,
                       now_ms: Optional[int] = None) -> None:
        """`now_ms` is supplied by the raft-meta harness so the op applies
        identically on every coordinator replica (wall clock is not
        deterministic); direct single-coordinator callers omit it."""
        with self._lock:
            info = self.stores.get(store_id) or StoreInfo(store_id, address)
            info.address = address or info.address
            info.state = StoreState.NORMAL
            info.last_heartbeat_ms = now_ms if now_ms is not None else int(time.time() * 1000)
            self.stores[store_id] = info
            self.store_ops.setdefault(store_id, [])
            self._persist(_PREFIX_STORE + store_id.encode(), info)

    def store_heartbeat(
        self,
        store_id: str,
        region_ids: Sequence[int] = (),
        leader_region_ids: Sequence[int] = (),
        capacity_bytes: int = 0,
        used_bytes: int = 0,
        region_defs: Sequence[RegionDefinition] = (),
        *,
        now_ms: Optional[int] = None,
        done_cmd_ids: Sequence[int] = (),
        failed_cmd_ids: Sequence[int] = (),
        stalled_cmd_ids: Sequence[int] = (),
        metrics=None,
    ) -> List[RegionCmd]:
        """StoreHeartbeat: record metrics, reconcile region topology from the
        store's reported definitions (splits survive leader crashes this
        way — the immediate split-done report is only a latency optimization;
        a region a merge absorbed is not brought back by a beat read before
        its store applied the merge), and return pending region commands (HandleStoreHeartbeatResponse
        flow, store/heartbeat.cc:294)."""
        with self._lock:
            for rd in region_defs:
                if rd.region_id in self.merged_away:
                    continue      # a beat older than the merge's report
                known = self.regions.get(rd.region_id)
                if known is None or rd.epoch.as_tuple() > known.epoch.as_tuple():
                    self.regions[rd.region_id] = rd
                    self._persist(
                        _PREFIX_REGION + str(rd.region_id).encode(), rd
                    )
            info = self.stores.get(store_id)
            if info is None:
                self.register_store(store_id, now_ms=now_ms)
                info = self.stores[store_id]
            beat_ms = now_ms if now_ms is not None else int(time.time() * 1000)
            info.last_heartbeat_ms = beat_ms
            info.region_ids = list(region_ids)
            info.leader_region_ids = list(leader_region_ids)
            info.capacity_bytes = capacity_bytes
            info.used_bytes = used_bytes
            if metrics is not None:
                # freshest-wins metrics plane (StoreMetricsManager analog);
                # staleness is judged from OUR receive clock, not the
                # store's collect clock — skewed store clocks must not
                # make live stores look stale
                self.store_metrics[store_id] = (metrics, beat_ms)
            for rid in leader_region_ids:
                self.region_leaders[rid] = store_id
            self._persist(_PREFIX_STORE + store_id.encode(), info)
            ops = self.store_ops.get(store_id, [])
            # ack: drop commands the store reports executed — without this
            # a remote (or raft-replicated) coordinator never learns a cmd
            # finished, and every leader election would re-deliver the whole
            # history via reset_sent_cmds
            if done_cmd_ids:
                done = set(done_cmd_ids)
                ops[:] = [c for c in ops if c.cmd_id not in done]
                for j in self.jobs:
                    # "pending" too: a leader election may have re-armed the
                    # job (reset_sent_cmds) before the store's ack landed
                    if j.cmd_id in done and j.status in ("sent", "pending"):
                        j.status = "done"
            # nack: the store could not execute these — re-arm for the next
            # beat, with a retry budget so poison commands don't loop
            # forever. This is the explicit re-delivery channel (the store
            # mutates COPIES of the queue objects; direct mutation would
            # fork an in-process replicated coordinator's leader state).
            if failed_cmd_ids:
                failed = set(failed_cmd_ids)
                doomed = []
                for c in ops:
                    if c.cmd_id in failed and c.status == "sent":
                        c.retries += 1
                        if c.retries >= 5:
                            c.status = "error: retry budget exhausted"
                            doomed.append(c.cmd_id)
                        else:
                            c.status = "pending"
                if doomed:
                    doomed_set = set(doomed)
                    ops[:] = [c for c in ops if c.cmd_id not in doomed_set]
                    for j in self.jobs:
                        if j.cmd_id in doomed_set:
                            j.status = "error: retry budget exhausted"
                            region_log(_log, j.region_id).warning(
                                "cmd %d type=%s dropped after %d failures",
                                j.cmd_id, j.cmd_type.value, 5)
                            # a dropped command is a silent topology-change
                            # failure (split/merge/peer move never happens)
                            # — make it loud: counter + flight bundle
                            from dingo_tpu_torch.obs.flight import FLIGHT

                            METRICS.counter(
                                "fault.cmd_retry_exhausted",
                                region_id=j.region_id,
                            ).add(1)
                            FLIGHT.trigger(
                                "cmd_retry_exhausted",
                                name=f"cmd_{j.cmd_id}_"
                                     f"{j.cmd_type.value}",
                                region_id=j.region_id,
                                extra={"cmd_id": j.cmd_id,
                                       "cmd_type": str(j.cmd_type.value),
                                       "store_id": store_id,
                                       "retries": 5},
                            )
            # stalled: delivery landed somewhere that cannot act YET (e.g.
            # region mid-election, requeue RPC failed) — re-arm without
            # charging the poison budget; leadership churn is not a
            # command defect
            if stalled_cmd_ids:
                stalled = set(stalled_cmd_ids)
                for c in ops:
                    if c.cmd_id in stalled and c.status == "sent":
                        c.status = "pending"
            pending = [c for c in ops if c.status == "pending"]
            for c in pending:
                c.status = "sent"
            if pending or done_cmd_ids or failed_cmd_ids or stalled_cmd_ids:
                self._persist_ops()
        # replica digest comparison OUTSIDE the lock: it parses digest
        # vectors and (on a fresh divergence) captures a flight bundle
        if metrics is not None:
            self._check_integrity(store_id, metrics)
            # capacity rollups ride the same beat: headroom vs working-
            # set demand + advisory tier/split recommendations; never
            # raises
            self._update_capacity(store_id, metrics)
            # control-plane events harvested by the store's collector
            # fold into the merged cluster timeline
            self._merge_events(store_id, metrics, beat_ms)
        return pending

    def reset_sent_cmds(self) -> int:
        """Mark every 'sent' command deliverable again. A command is 'sent'
        once handed to a store in a heartbeat response; if the coordinator
        (leader) dies before the response reaches the store, no survivor
        would re-deliver it. The new raft leader proposes this op on
        election — the store side dedups by cmd_id, so re-delivery is safe
        (reference re-pushes store operations the same way,
        RpcSendPushStoreOperation coordinator_control.h:547)."""
        with self._lock:
            n = 0
            for q in self.store_ops.values():
                for c in q:
                    if c.status == "sent":
                        c.status = "pending"
                        n += 1
            if n:
                self._persist_ops()
            return n

    def update_store_states(self, *, now_ms: Optional[int] = None) -> List[str]:
        """UpdateStoreState crontab: mark silent stores OFFLINE; returns the
        newly-offline store ids (region health checks follow)."""
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        newly = []
        with self._lock:
            for info in self.stores.values():
                if (
                    info.state is StoreState.NORMAL
                    and now - info.last_heartbeat_ms > self.OFFLINE_AFTER_MS
                ):
                    info.state = StoreState.OFFLINE
                    newly.append(info.store_id)
                    self._persist(_PREFIX_STORE + info.store_id.encode(), info)
        for sid in newly:
            _log.warning("store %s marked OFFLINE (silent > %dms)",
                         sid, self.OFFLINE_AFTER_MS)
        return newly

    def alive_stores(self) -> List[StoreInfo]:
        with self._lock:
            return [
                s for s in self.stores.values()
                if s.state is StoreState.NORMAL
            ]

    # ---------------- state-integrity comparison ----------------------------
    def _check_integrity(self, store_id: str, metrics) -> None:
        """Compare the arriving store's per-region digest vectors against
        every other store's cached snapshot AT EQUAL APPLIED INDICES
        (state-integrity plane, obs/integrity.py). Replicas that applied
        the same raft prefix hold the same logical data by contract, so
        differing digests mean one of them silently corrupted — raise the
        consistency.* family, flag the region DIVERGED, and capture a
        rate-limited flight bundle carrying BOTH digest vectors. A clean
        agreement at equal applied indices clears the flag. Runs OUTSIDE
        the coordinator lock (takes it briefly to snapshot/update state);
        never raises (heartbeats must not die on telemetry)."""
        try:
            self._check_integrity_inner(store_id, metrics)
        except Exception:  # noqa: BLE001 — observability must not re-raise
            _log.exception("integrity comparison failed")

    def _check_integrity_inner(self, store_id: str, metrics) -> None:
        from dingo_tpu_torch.common.metrics import METRICS
        from dingo_tpu_torch.obs.integrity import diverged_artifacts

        regions = getattr(metrics, "regions", None) or []
        with self._lock:
            peers = {
                sid: snap for sid, (snap, _at) in self.store_metrics.items()
                if sid != store_id
            }
        for rm in regions:
            digests = getattr(rm, "integrity_digests", "")
            if not digests:
                continue
            rid = rm.region_id
            applied = int(getattr(rm, "integrity_applied_index", 0))
            diverging = []
            agreeing = 0
            for sid, snap in peers.items():
                other = next(
                    (r for r in getattr(snap, "regions", [])
                     if r.region_id == rid), None,
                )
                if other is None:
                    continue
                o_digests = getattr(other, "integrity_digests", "")
                o_applied = int(
                    getattr(other, "integrity_applied_index", 0)
                )
                if not o_digests or o_applied != applied:
                    continue          # unequal applied = lag, not damage
                if o_digests == digests:
                    # canonical JSON (sorted keys, fixed separators):
                    # string equality IS vector equality — the common
                    # healthy path never pays a parse
                    agreeing += 1
                    continue
                arts = diverged_artifacts(digests, o_digests)
                if arts:
                    diverging.append(
                        {"store": sid, "artifacts": arts,
                         "digests": o_digests}
                    )
                else:
                    agreeing += 1
            if diverging:
                evidence = {
                    "applied_index": applied,
                    "store": store_id,
                    "digests": digests,
                    "peers": diverging,
                    "detected_ms": int(time.time() * 1000),
                }
                with self._lock:
                    newly = rid not in self.integrity_diverged
                    self.integrity_diverged[rid] = evidence
                if newly:
                    METRICS.counter(
                        "consistency.divergence", region_id=rid
                    ).add(1)
                    region_log(_log, rid).error(
                        "replica state DIVERGED at applied index %d: "
                        "%s vs %s", applied, store_id,
                        [d["store"] for d in diverging])
                    from dingo_tpu_torch.common.config import FLAGS
                    if bool(FLAGS.get("integrity_flight_on_divergence")):
                        from dingo_tpu_torch.obs.flight import FLIGHT

                        FLIGHT.trigger(
                            "divergence",
                            name=f"region_{rid}",
                            region_id=rid,
                            extra=evidence,
                        )
            elif agreeing:
                with self._lock:
                    was = self.integrity_diverged.pop(rid, None)
                if was is not None:
                    # replicas re-converged (rebuild/restore healed the
                    # bad copy): clear the flag
                    region_log(_log, rid).info(
                        "replica state digests re-converged")
        with self._lock:
            n = len(self.integrity_diverged)
        METRICS.gauge("consistency.diverged_regions").set(float(n))

    def diverged_regions(self) -> List[int]:
        with self._lock:
            return sorted(self.integrity_diverged)

    # ---------------- capacity plane ----------------------------------------
    def _update_capacity(self, store_id: str, metrics) -> None:
        """Re-derive the arriving store's capacity plan from its beat's
        heat rollups (coordinator/capacity.py): device headroom vs p99
        working-set demand + tier/split recommendations. Fresh DEMOTE
        advisories become a TIER_DEMOTE region command, which flags the
        region for the store's memory-tier ladder (index/tiering.py) when
        tier_enabled is on. Split advice stays advisory. Runs OUTSIDE the coordinator lock (takes it
        briefly to store the plan); never raises."""
        try:
            self._update_capacity_inner(store_id, metrics)
        except Exception:  # noqa: BLE001 — telemetry must not kill beats
            _log.exception("capacity planning failed")

    def _update_capacity_inner(self, store_id: str, metrics) -> None:
        from dingo_tpu_torch.coordinator import capacity as cap

        if not cap.capacity_advise_enabled():
            with self._lock:
                self.capacity_plans.pop(store_id, None)
            return
        plan = cap.plan_store(metrics)
        plan["store_id"] = plan["store_id"] or store_id
        with self._lock:
            self.capacity_plans[store_id] = plan
            live = {(store_id, a.region_id, a.kind)
                    for a in plan["advice"]}
            fresh = live - self._capacity_advised
            # retire memo entries whose advice lapsed so a recurrence
            # counts again (this store's keys only)
            self._capacity_advised = {
                k for k in self._capacity_advised if k[0] != store_id
            } | live
            # advisory -> actuation handshake: each FRESH demote advisory
            # becomes one TIER_DEMOTE command to the advised store (the
            # dedupe memo above already rate-limits recurrences to
            # re-advise only after the advice lapses and returns)
            for _sid, rid, kind in sorted(fresh):
                if kind != "demote":
                    continue
                self._queue_cmd(store_id, RegionCmd(
                    cmd_id=self._next_cmd(), region_id=rid,
                    cmd_type=RegionCmdType.TIER_DEMOTE,
                ))
        g = METRICS.gauge
        labels = {"store": store_id}
        g("capacity.headroom_bytes", labels=labels).set(
            plan["headroom_bytes"])
        g("capacity.headroom_fraction", labels=labels).set(
            round(plan["headroom_frac"], 6))
        g("capacity.demand_p99_bytes", labels=labels).set(
            plan["demand_p99_bytes"])
        g("capacity.resident_bytes", labels=labels).set(
            plan["resident_bytes"])
        g("capacity.advice_count", labels=labels).set(
            len(plan["advice"]))
        from dingo_tpu_torch.obs.events import EVENTS

        for _sid, rid, kind in fresh:
            METRICS.counter("capacity.advisories", region_id=rid,
                            labels={"kind": kind}).add(1)
            advice = next(a for a in plan["advice"]
                          if a.region_id == rid and a.kind == kind)
            EVENTS.emit(
                "capacity", rid, "advisory", "", kind,
                trigger="headroom",
                evidence={
                    "store": store_id,
                    "headroom_frac": round(plan["headroom_frac"], 4),
                    "demand_p99_bytes": plan["demand_p99_bytes"],
                    "bytes_at_stake": advice.bytes_at_stake,
                    "reason": advice.reason,
                },
            )
            region_log(_log, rid).info(
                "capacity advisory (%s): %s", kind, advice.reason)

    # ---------------- control-plane event timeline ---------------------------
    def _merge_events(self, store_id: str, metrics, recv_ms: int) -> None:
        """Fold one beat's harvested control-plane events into the merged
        cluster timeline. Receive-clock normalization: each event's
        store-stamped wall clock is adjusted by recv_ms - collected_at_ms
        (the METRICS_STALE_MS discipline — skewed store clocks must not
        scramble cross-node causality). Never raises."""
        try:
            evs = list(getattr(metrics, "events", ()) or ())
            if not evs:
                return
            collected = int(getattr(metrics, "collected_at_ms", 0) or 0)
            offset = recv_ms - collected if collected else 0
            self.events.merge(store_id, evs, offset_ms=offset)
        except Exception:  # noqa: BLE001 — telemetry must not kill beats
            _log.exception("event timeline merge failed")

    def _fold_local_events(self) -> None:
        """The coordinator is a controller too (replica planner, capacity
        advisor): harvest its OWN ledger into the timeline so `cluster
        events` shows store and coordinator decisions in one order. Its
        clock needs no offset — it IS the merge clock."""
        from dingo_tpu_torch.obs.events import EVENTS

        local = EVENTS.harvest(node_id="coordinator")
        if local:
            self.events.merge("coordinator", local)

    def cluster_events(self, region_id: int = 0, actor: str = "",
                       limit: int = 0) -> List:
        """Merged cluster timeline, oldest first (region_id 0 / actor ""
        = no filter)."""
        self._fold_local_events()
        return self.events.events(
            region_id=region_id or None, actor=actor, limit=limit
        )

    def explain_region_overrides(self, region_id: int) -> Dict:
        """`cluster explain <region>`: reconcile the region's live
        overrides (freshest non-stale replica rows, leader preferred)
        against the merged event timeline — every live knob should be
        accounted for by a decision chain; the rest are orphans
        (event.orphan_knobs gauge)."""
        from dingo_tpu_torch.common.metrics import METRICS
        from dingo_tpu_torch.obs.events import explain_region, live_overrides

        self._fold_local_events()
        live: Dict[str, str] = {}
        for _sid, stale, rm in self.get_region_metrics(region_id):
            if stale:
                continue
            if getattr(rm, "is_leader", False) or not live:
                live = live_overrides(rm)
        report = explain_region(
            region_id, live, self.events.events(region_id=region_id)
        )
        METRICS.gauge("event.orphan_knobs", region_id=region_id).set(
            len(report["orphans"]))
        return report

    def capacity_report(self) -> List[Dict]:
        """Per-store capacity plans, store-id ordered (DebugService /
        tests). Each plan is the plan_store dict — advice included."""
        with self._lock:
            return [self.capacity_plans[sid]
                    for sid in sorted(self.capacity_plans)]

    # ---------------- metrics aggregation -----------------------------------
    def get_store_metrics(self, store_id: str = "", *,
                          now_ms: Optional[int] = None) -> List[Tuple]:
        """Freshest snapshot per store: [(store_id, snapshot, last_update_ms,
        stale)] — stale once no beat delivered metrics for METRICS_STALE_MS
        (a stopped store keeps its last figures, flagged)."""
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        with self._lock:
            out = []
            for sid, (snap, at_ms) in sorted(self.store_metrics.items()):
                if store_id and sid != store_id:
                    continue
                stale = now - at_ms > self.METRICS_STALE_MS
                out.append((sid, snap, at_ms, stale))
            return out

    def get_region_metrics(self, region_id: int = 0, *,
                           now_ms: Optional[int] = None) -> List[Tuple]:
        """Per-replica region rows across stores: [(store_id, stale,
        RegionMetricsSnapshot)] (region_id 0 = every region)."""
        rows = []
        for sid, snap, _at, stale in self.get_store_metrics(now_ms=now_ms):
            for rm in snap.regions:
                if region_id and rm.region_id != region_id:
                    continue
                rows.append((sid, stale, rm))
        rows.sort(key=lambda r: (r[2].region_id, r[0]))
        return rows

    def cluster_metrics_rollup(self, *,
                               now_ms: Optional[int] = None) -> Dict[str, int]:
        """Cluster totals over NON-stale snapshots (leader replicas only
        for key/vector counts so replication factor doesn't multiply
        logical sizes; memory/device bytes sum over every replica — HBM
        is spent per replica)."""
        totals = {
            "key_count": 0, "vector_count": 0,
            "memory_bytes": 0, "device_memory_bytes": 0,
        }
        for _sid, snap, _at, stale in self.get_store_metrics(now_ms=now_ms):
            if stale:
                continue
            for rm in snap.regions:
                if rm.is_leader:
                    totals["key_count"] += rm.key_count
                    totals["vector_count"] += rm.vector_count
                totals["memory_bytes"] += rm.vector_memory_bytes
                totals["device_memory_bytes"] += rm.device_memory_bytes
        return totals

    def store_metrics_summary(self, store_id: str, *,
                              now_ms: Optional[int] = None) -> Dict[str, object]:
        """Per-store rollup for GetClusterStat's StoreStat rows (zeros +
        stale=True when the store never delivered metrics)."""
        rows = self.get_store_metrics(store_id, now_ms=now_ms)
        if not rows:
            return {"key_count": 0, "vector_count": 0, "memory_bytes": 0,
                    "device_memory_bytes": 0, "stale": True,
                    "leader_qps": 0.0}
        _sid, snap, _at, stale = rows[0]
        return {
            "key_count": sum(r.key_count for r in snap.regions),
            "vector_count": sum(r.vector_count for r in snap.regions),
            "memory_bytes": sum(r.vector_memory_bytes for r in snap.regions),
            "device_memory_bytes": sum(
                r.device_memory_bytes for r in snap.regions),
            "stale": stale,
            "leader_qps": sum(
                r.search_qps for r in snap.regions if r.is_leader),
        }

    # ---------------- id allocation -----------------------------------------
    def next_region_id(self) -> int:
        with self._lock:
            rid = self._next_region_id
            self._next_region_id += 1
            self._persist_ids()
            return rid

    def _next_cmd(self) -> int:
        cid = self._next_cmd_id
        self._next_cmd_id += 1
        self._persist_ids()
        return cid

    # ---------------- region CRUD -------------------------------------------
    def create_region(
        self,
        start_key: bytes,
        end_key: bytes,
        partition_id: int = 0,
        region_type: RegionType = RegionType.STORE,
        index_parameter: Optional[IndexParameter] = None,
        replication: Optional[int] = None,
        document_schema: Optional[Dict[str, str]] = None,
    ) -> RegionDefinition:
        """CreateRegionFinal (coordinator_control.h:263): allocate id, place
        peers on the least-loaded alive stores, queue CREATE commands."""
        if document_schema:
            bad = {f: t for f, t in document_schema.items()
                   if t not in COLUMN_TYPES}
            if bad:
                # an unknown type would fail DocumentIndex construction on
                # every peer's CREATE cmd with no error ever reaching the
                # caller — reject at the coordinator instead
                raise RuntimeError(f"unknown document column types: {bad}")
        with self._lock:
            # Overlapping key ranges of the SAME region type would route
            # two tables'/callers' data into one region (client routing
            # matches the first covering range of the right type). Checked
            # here, under the lock, so concurrent creates cannot both pass.
            # Different types (STORE raw keys vs INDEX/DOCUMENT id windows)
            # share the lexicographic keyspace but route independently.
            # empty end = truly unbounded (same semantics as
            # Region.contains_key): [a, "") overlaps ANY range starting
            # at or after a — a finite sentinel would let a region whose
            # keys exceed it slip past the check
            for other in self.regions.values():
                if other.region_type is not region_type:
                    continue
                if (not other.end_key or start_key < other.end_key) and (
                    not end_key or other.start_key < end_key
                ):
                    raise RuntimeError(
                        f"range overlaps region {other.region_id}"
                    )
            peers = self._place_peers(replication or self.replication)
            if not peers:
                raise RuntimeError("no alive stores to place region")
            definition = RegionDefinition(
                region_id=self.next_region_id(),
                start_key=start_key,
                end_key=end_key,
                partition_id=partition_id,
                peers=peers,
                region_type=region_type,
                index_parameter=index_parameter,
                document_schema=document_schema,
            )
            self.regions[definition.region_id] = definition
            self._persist(
                _PREFIX_REGION + str(definition.region_id).encode(), definition
            )
            for sid in peers:
                self._queue_cmd(sid, RegionCmd(
                    cmd_id=self._next_cmd(),
                    region_id=definition.region_id,
                    cmd_type=RegionCmdType.CREATE,
                    definition=definition,
                ))
            region_log(_log, definition.region_id).info(
                "create type=%s peers=%s", region_type.name, peers)
            return definition

    def _place_peers(self, n: int) -> List[str]:
        alive = sorted(
            self.alive_stores(), key=lambda s: len(s.region_ids)
        )
        return [s.store_id for s in alive[:n]]

    #: retained job-history entries (introspection; oldest trimmed)
    JOB_HISTORY_MAX = 10_000

    def _queue_cmd(self, store_id: str, cmd: RegionCmd) -> None:
        cmd.store_id = store_id
        self.store_ops.setdefault(store_id, []).append(cmd)
        self.jobs.append(cmd)
        if len(self.jobs) > self.JOB_HISTORY_MAX:
            del self.jobs[: len(self.jobs) - self.JOB_HISTORY_MAX]
        self._persist_ops()

    def requeue_cmd(self, cmd: RegionCmd, store_id: str,
                    from_store: Optional[str] = None) -> None:
        """Re-dispatch a command to another store (e.g. the store executing
        a SPLIT discovered it is not the raft leader and reports the hint).
        The command MOVES queues — leaving it in the source would re-deliver
        it on every heartbeat and eventually double-execute."""
        with self._lock:
            if from_store is not None:
                src = self.store_ops.get(from_store, [])
                src[:] = [c for c in src if c.cmd_id != cmd.cmd_id]
            cmd.status = "pending"
            cmd.store_id = store_id
            q = self.store_ops.setdefault(store_id, [])
            if all(c.cmd_id != cmd.cmd_id for c in q):
                q.append(cmd)
            # keep the jobs history pointing at the LIVE object (a remote
            # requeue arrives as a fresh pb-decoded copy; the stale entry
            # would otherwise show the old store/status forever)
            for i, j in enumerate(self.jobs):
                if j.cmd_id == cmd.cmd_id:
                    self.jobs[i] = cmd
                    break
            else:
                self.jobs.append(cmd)
            self._persist_ops()

    def drop_region(self, region_id: int) -> None:
        with self._lock:
            definition = self.regions.pop(region_id, None)
            if definition is None:
                return
            self.engine.delete(CF_META, _PREFIX_REGION + str(region_id).encode())
            for sid in definition.peers:
                self._queue_cmd(sid, RegionCmd(
                    cmd_id=self._next_cmd(), region_id=region_id,
                    cmd_type=RegionCmdType.DELETE,
                ))

    # ---------------- split / merge / peers ---------------------------------
    def split_region(self, region_id: int, split_key: bytes) -> int:
        """SplitRegionWithJob (:304): allocate a child id and push SPLIT to
        the leader store; the split itself replicates through region raft."""
        with self._lock:
            parent = self.regions.get(region_id)
            if parent is None:
                raise KeyError(f"region {region_id}")
            if not (parent.start_key < split_key < parent.end_key):
                raise ValueError("split key outside region range")
            child_id = self.next_region_id()
            leader = self.region_leaders.get(region_id, parent.peers[0])
            self._queue_cmd(leader, RegionCmd(
                cmd_id=self._next_cmd(), region_id=region_id,
                cmd_type=RegionCmdType.SPLIT, split_key=split_key,
                child_region_id=child_id,
            ))
            region_log(_log, region_id).info(
                "split queued -> child %d via %s", child_id, leader)
            return child_id

    def merge_region(self, target_region_id: int,
                     source_region_id: int) -> None:
        """MergeRegionWithJob (:309): queue MERGE to the target's leader
        (regions must be adjacent with co-located peers)."""
        with self._lock:
            target = self.regions.get(target_region_id)
            source = self.regions.get(source_region_id)
            if target is None or source is None:
                raise KeyError("unknown region")
            if target.end_key != source.start_key:
                raise ValueError("regions not adjacent (target must precede)")
            if set(target.peers) != set(source.peers):
                raise ValueError("merge requires co-located peers")
            leader = self.region_leaders.get(target_region_id,
                                             target.peers[0])
            cmd = RegionCmd(
                cmd_id=self._next_cmd(), region_id=target_region_id,
                cmd_type=RegionCmdType.MERGE,
                child_region_id=source_region_id,
            )
            self._queue_cmd(leader, cmd)
            region_log(_log, target_region_id).info(
                "merge queued: absorbing region %d via %s",
                source_region_id, leader)

    def on_region_merge_done(self, target_id: int, source_id: int,
                             target_def) -> None:
        with self._lock:
            self.merged_away.add(source_id)
            self.regions.pop(source_id, None)
            self.region_leaders.pop(source_id, None)
            for q in self.store_ops.values():
                q[:] = [c for c in q if c.region_id != source_id]
            self.engine.delete(
                CF_META, _PREFIX_REGION + str(source_id).encode()
            )
            self.regions[target_id] = target_def
            self._persist(_PREFIX_REGION + str(target_id).encode(), target_def)
            self._persist_ops()

    def on_region_split_done(
        self, parent_id: int, child: RegionDefinition
    ) -> None:
        """Store reports the applied split; update metadata + epochs."""
        with self._lock:
            parent = self.regions.get(parent_id)
            if parent is not None:
                parent.end_key = child.start_key
                parent.epoch.version += 1
                self._persist(_PREFIX_REGION + str(parent_id).encode(), parent)
            self.regions[child.region_id] = child
            self._persist(
                _PREFIX_REGION + str(child.region_id).encode(), child
            )

    def transfer_leader(self, region_id: int, target_store: str) -> None:
        with self._lock:
            definition = self.regions.get(region_id)
            if definition is None:
                raise KeyError(f"region {region_id}")
            if target_store not in definition.peers:
                # the raft core silently refuses a non-peer target
                # (core.py transfer_leadership) — fail the RPC instead of
                # letting the operator believe leadership moved
                raise ValueError(
                    f"{target_store!r} is not a peer of region {region_id} "
                    f"(peers: {definition.peers})"
                )
            leader = self.region_leaders.get(region_id)
            if leader is None:
                raise KeyError(f"no leader known for region {region_id}")
            self._queue_cmd(leader, RegionCmd(
                cmd_id=self._next_cmd(), region_id=region_id,
                cmd_type=RegionCmdType.TRANSFER_LEADER,
                target_store_id=target_store,
            ))
            region_log(_log, region_id).info(
                "leader transfer queued: %s -> %s", leader, target_store)

    def change_peer(self, region_id: int, new_peers: List[str]) -> None:
        """ChangePeerRegionWithJob (:313)."""
        with self._lock:
            definition = self.regions.get(region_id)
            if definition is None:
                raise KeyError(f"region {region_id}")
            unknown = [p for p in new_peers if p not in self.stores]
            if unknown:
                # a typo'd store id would persist into the definition and
                # queue a CREATE no store ever drains — reject up front
                # (balancer call sites always pass registered stores)
                raise ValueError(f"unknown stores in peer set: {unknown}")
            old = set(definition.peers)
            new = set(new_peers)
            definition.peers = list(new_peers)
            definition.epoch.conf_version += 1
            self._persist(_PREFIX_REGION + str(region_id).encode(), definition)
            for sid in new - old:   # additions get CREATE
                self._queue_cmd(sid, RegionCmd(
                    cmd_id=self._next_cmd(), region_id=region_id,
                    cmd_type=RegionCmdType.CREATE, definition=definition,
                ))
            for sid in old & new:   # survivors update raft membership
                self._queue_cmd(sid, RegionCmd(
                    cmd_id=self._next_cmd(), region_id=region_id,
                    cmd_type=RegionCmdType.CHANGE_PEER, definition=definition,
                ))
            for sid in old - new:   # removals get DELETE
                self._queue_cmd(sid, RegionCmd(
                    cmd_id=self._next_cmd(), region_id=region_id,
                    cmd_type=RegionCmdType.DELETE,
                ))
            region_log(_log, region_id).info(
                "peer change: %s -> %s", sorted(old), sorted(new))

    #: GC retention window (versions younger than this always survive)
    GC_RETENTION_MS = 3_600_000

    def gc_safe_ts(self, tso) -> int:
        """Safe point = now - retention, in TSO format (coordinator pushes
        this to stores; their MVCC GC prunes below it)."""
        from dingo_tpu_torch.mvcc.ts_provider import compose_ts
        import time as _time

        return compose_ts(
            int(_time.time() * 1000) - self.GC_RETENTION_MS, 0
        )

    # ---------------- failure handling --------------------------------------
    def check_region_health(self) -> List[Tuple[int, List[str]]]:
        """CheckRegionAllPeerOnline (:597-599): regions with offline peers,
        with a proposed replacement peer set."""
        out = []
        with self._lock:
            alive = {s.store_id for s in self.alive_stores()}
            for rid, definition in self.regions.items():
                dead = [p for p in definition.peers if p not in alive]
                if not dead:
                    continue
                candidates = [
                    s.store_id for s in sorted(
                        self.alive_stores(), key=lambda s: len(s.region_ids)
                    ) if s.store_id not in definition.peers
                ]
                replacement = [p for p in definition.peers if p in alive]
                replacement += candidates[: len(dead)]
                out.append((rid, replacement))
        return out
