"""Raft-replicated coordinator role (MetaStateMachine analog; port of
dingo_tpu/coordinator/raft_meta.py).

Reference: src/coordinator/coordinator_control.h:218 (SubmitMetaIncrementSync
routes every coordinator mutation through braft) + src/raft/meta_state_machine.h
(one state machine applying MetaIncrement records for CoordinatorControl,
TsoControl, KvControl, AutoIncrementControl alike). Round-3 VERDICT Missing #2:
our coordinator persisted to a single process's local engine — coordinator
crash = no region ops, no TSO, no meta.

Nothing here touches the device — this is the control plane. The reference's MetaIncrement is a protobuf diff record; ours
is a typed op record `(target, method, args, kwargs)` applied by invoking the
SAME control method bodies on every replica (command replication). That works
iff apply is deterministic, which drives three design rules:

1. **No wall clock in apply.** Every time-dependent control method takes
   `now_ms`; the proposing leader stamps it into the op (_STAMP_NOW).
   TsoControl runs with clock_init=False so its physical mark derives only
   from replicated ops (see tso.py for the failover-safety argument).
2. **Exactly-once replay.** Each op's engine writes are buffered and
   committed in ONE atomic WriteBatch together with the applied-index
   marker (_BatchedEngine), so a restarted replica skips already-applied
   entries instead of re-executing them (re-running create_region would
   allocate fresh ids and diverge from live replicas).
3. **Deterministic failures.** Exceptions raised by an op are caught,
   recorded, and re-raised only on the proposing node; buffered writes are
   committed either way so partial in-memory mutation matches the engine
   on every replica.

Reads are served from local in-memory state. The leader's state is
linearizable with respect to its own applies (propose blocks until local
apply); services route mutations to the leader and surrender NotLeader with
a hint, mirroring the store-side raft contract. Coordinator READS on a
FOLLOWER can be stale by the follower's apply lag (no read-index/leader-
lease pass — the reference serves reads through the braft leader): clients
pointed at a follower may see an old region map or job list. This is
deliberate: store-side region-epoch checks reject stale routing, and
SDK/heartbeat clients rotate to the leader on any mutation. Callers
needing linearizable meta reads should read through the leader (the
rotating client channel lands there after any write).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.coordinator.auto_increment import AutoIncrementControl
from dingo_tpu_torch.coordinator.control import CoordinatorControl
from dingo_tpu_torch.coordinator.kv_control import KvControl
from dingo_tpu_torch.coordinator.meta import MetaControl
from dingo_tpu_torch.coordinator.tso import TsoControl
from dingo_tpu_torch.engine.raw_engine import CF_META, RawEngine, WriteBatch
from dingo_tpu_torch.raft.core import NotLeader, RaftNode
from dingo_tpu_torch.raft.log import RaftLog
from dingo_tpu_torch.raft.transport import Transport

_KEY_APPLIED = b"METARAFT_APPLIED"

#: mutating methods per control — routed through raft; everything else is a
#: local read. An explicit whitelist (not introspection): adding a mutation
#: without listing it here would silently fork replica state.
_MUTATIONS: Dict[str, frozenset] = {
    "control": frozenset({
        "register_store", "store_heartbeat", "update_store_states",
        "next_region_id", "create_region", "requeue_cmd", "drop_region",
        "split_region", "merge_region", "on_region_merge_done",
        "on_region_split_done", "transfer_leader", "change_peer",
        "reset_sent_cmds",
    }),
    "tso": frozenset({"gen_ts", "advance_to"}),
    "kv": frozenset({
        "kv_put", "kv_delete_range", "kv_compaction",
        "lease_grant", "lease_renew", "lease_revoke", "lease_gc",
    }),
    "auto_incr": frozenset({"create", "generate", "update", "delete"}),
    "meta": frozenset({
        "create_schema", "drop_schema", "create_table", "import_table",
        "drop_table",
    }),
}

#: ops whose body consults the wall clock: the LEADER stamps now_ms at
#: propose time so all replicas apply the identical timestamp
_STAMP_NOW = frozenset({
    ("control", "register_store"), ("control", "store_heartbeat"),
    ("control", "update_store_states"),
    ("tso", "gen_ts"),
    ("kv", "kv_put"), ("kv", "lease_grant"), ("kv", "lease_renew"),
    ("kv", "lease_gc"),
})

#: sentinel distinguishing "result evicted" from a legitimate None result
_RESULT_EVICTED = object()


class _BatchedEngine:
    """Engine facade the controls write through.

    Normally passes straight through. Inside an apply, put/delete are
    buffered and flushed as ONE WriteBatch together with the applied-index
    marker — the atomicity that makes replay exactly-once. Reads always hit
    the real engine: control methods never read back their own same-op
    writes (state lives in memory; the engine is a write-behind), so
    read-your-writes inside a batch is not needed.
    """

    def __init__(self, real: RawEngine):
        self._real = real
        self._batch: Optional[WriteBatch] = None

    # -- batching protocol (state machine only) ------------------------------
    def begin(self) -> None:
        self._batch = WriteBatch()

    def commit(self, marker_key: bytes, marker_value: bytes) -> None:
        batch = self._batch
        self._batch = None
        batch.put(CF_META, marker_key, marker_value)
        self._real.write(batch)

    # -- RawEngine writes ----------------------------------------------------
    def put(self, cf: str, key: bytes, value: bytes) -> None:
        if self._batch is not None:
            self._batch.put(cf, key, value)
        else:
            self._real.put(cf, key, value)

    def delete(self, cf: str, key: bytes) -> None:
        if self._batch is not None:
            self._batch.delete(cf, key)
        else:
            self._real.delete(cf, key)

    def write(self, batch: WriteBatch) -> None:
        if self._batch is not None:
            self._batch.ops.extend(batch.ops)
        else:
            self._real.write(batch)

    # -- everything else (reads, checkpoint, close) --------------------------
    def __getattr__(self, name):
        return getattr(self._real, name)


class MetaStateMachine:
    """All coordinator-side controls over one engine, applied from the log.

    meta_state_machine.h analog: one apply path for every control; snapshot
    = the whole meta CF (the coordinator process hosts no data regions, so
    CF_META is exclusively coordinator state).
    """

    def __init__(self, engine: RawEngine, replication: int = 3):
        self._real_engine = engine
        self.engine = _BatchedEngine(engine)
        self.replication = replication
        blob = engine.get(CF_META, _KEY_APPLIED)
        self.applied_index: int = persist.loads(blob) if blob else 0
        self._build_controls()

    def _build_controls(self) -> None:
        self.control = CoordinatorControl(self.engine, self.replication)
        self.tso = TsoControl(self.engine, clock_init=False)
        self.kv = KvControl(self.engine)
        self.auto_incr = AutoIncrementControl(self.engine)
        self.meta = MetaControl(self.engine, self.control)

    # -- log application -----------------------------------------------------
    def apply(self, index: int, payload: bytes) -> Optional[Tuple[bool, Any]]:
        if index <= self.applied_index:
            return None     # replayed entry already reflected in the engine
        target, method, args, kwargs = persist.loads(payload)
        obj = getattr(self, target)
        if method not in _MUTATIONS[target]:
            raise ValueError(f"refusing non-whitelisted op {target}.{method}")
        self.engine.begin()
        try:
            try:
                result: Tuple[bool, Any] = (
                    True, getattr(obj, method)(*args, **kwargs)
                )
            except Exception as exc:  # noqa: BLE001 — deterministic on all
                result = (False, exc)  # replicas; re-raised at the proposer
        finally:
            self.applied_index = index
            self.engine.commit(_KEY_APPLIED, persist.dumps(index))
        return result

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> bytes:
        from dingo_tpu_torch.raft import wire

        pairs = self._real_engine.scan(CF_META, b"", None)
        return wire.encode([list(p) for p in pairs])

    def install(self, blob: bytes) -> None:
        from dingo_tpu_torch.raft import wire

        pairs = wire.decode(blob)
        batch = WriteBatch()
        batch.delete_range(CF_META, b"", None)
        for k, v in pairs:
            batch.put(CF_META, k, v)
        self._real_engine.write(batch)
        blob2 = self._real_engine.get(CF_META, _KEY_APPLIED)
        self.applied_index = persist.loads(blob2) if blob2 else 0
        # rebuild in-memory state from the installed engine image; local
        # watch registrations do not survive (snapshot install only happens
        # on a follower that fell behind — watchers live on the leader)
        self._build_controls()


class _Proxy:
    """Duck-type stand-in for one control: reads go to local state,
    mutations become replicated ops. Services/balancers/crontabs take these
    in place of the raw control objects."""

    def __init__(self, coordinator: "RaftMetaCoordinator", target: str):
        object.__setattr__(self, "_coordinator", coordinator)
        object.__setattr__(self, "_target", target)

    def __getattr__(self, name: str):
        coordinator = self._coordinator
        target = self._target
        if name in _MUTATIONS[target]:
            def call(*args, **kwargs):
                # now_ms is keyword-only on every stamped method, so a
                # positional timestamp cannot slip past this check; an
                # explicit now_ms=0 counts as provided (None = unset)
                if (target, name) in _STAMP_NOW and \
                        kwargs.get("now_ms") is None:
                    kwargs["now_ms"] = int(time.time() * 1000)
                return coordinator.propose_op(target, name, args, kwargs)
            return call
        # reads (and constants) — resolved per call so a snapshot install
        # that rebuilds the controls is transparent
        return getattr(getattr(coordinator.sm, target), name)


class RaftMetaCoordinator:
    """One coordinator replica: MetaStateMachine behind a RaftNode.

    Exposes .control/.tso/.kv/.auto_incr/.meta proxies with the exact API
    of the raw controls; NotLeader (with a leader hint) escapes from
    mutations on a follower, mirroring the store-side write contract.
    """

    def __init__(
        self,
        node_id: str,
        peer_ids: List[str],
        transport: Transport,
        engine: RawEngine,
        replication: int = 3,
        log: Optional[RaftLog] = None,
        **raft_kw,
    ):
        self.sm = MetaStateMachine(engine, replication)
        self._results: Dict[int, Tuple[bool, Any]] = {}
        self._results_lock = threading.Lock()
        self.node = RaftNode(
            node_id, peer_ids, transport, log=log,
            apply_fn=self._apply_fn,
            snapshot_save_fn=self.sm.snapshot,
            snapshot_install_fn=self.sm.install,
            on_leader_start=self._on_leader_start,
            **raft_kw,
        )
        self.control = _Proxy(self, "control")
        self.tso = _Proxy(self, "tso")
        self.kv = _Proxy(self, "kv")
        self.auto_incr = _Proxy(self, "auto_incr")
        self.meta = _Proxy(self, "meta")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.node.start()

    def stop(self) -> None:
        self.node.stop()

    def is_leader(self) -> bool:
        return self.node.is_leader()

    def leader_hint(self) -> Optional[str]:
        return self.node.leader_id

    def _on_leader_start(self, term: int) -> None:
        """New leader: re-arm commands a dead leader marked 'sent' but may
        never have delivered (see CoordinatorControl.reset_sent_cmds). Goes
        through the log like every mutation — a leader-local shortcut would
        fork replica state."""
        try:
            self.propose_op("control", "reset_sent_cmds", (), {})
        except Exception:   # noqa: BLE001 — lost leadership already; the
            pass            # next leader's own on_leader_start covers it

    # -- replicated mutation -------------------------------------------------
    def _apply_fn(self, index: int, payload: bytes) -> None:
        result = self.sm.apply(index, payload)
        if result is None:
            return
        with self._results_lock:
            self._results[index] = result
            while len(self._results) > 4096:   # bound: waiters pop their own
                self._results.pop(next(iter(self._results)))

    def propose_op(self, target: str, method: str,
                   args: tuple, kwargs: dict, timeout: float = 5.0) -> Any:
        if not self.node.is_leader():
            raise NotLeader(self.node.leader_id)
        payload = persist.dumps((target, method, list(args), kwargs))
        index = self.node.propose(payload, timeout=timeout)
        with self._results_lock:
            entry = self._results.pop(index, _RESULT_EVICTED)
        if entry is _RESULT_EVICTED:
            # the bounded buffer evicted this apply's outcome (>4096
            # concurrent proposals) — the op APPLIED, but its return value
            # and any exception it raised are gone; surface that instead
            # of silently returning None/success
            raise RuntimeError(
                f"{target}.{method}: apply result evicted under load "
                f"(op applied at index {index}; outcome unknown)")
        ok, value = entry
        if not ok:
            raise value
        return value
