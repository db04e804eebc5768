"""The crontab schedules of the coordinator and store roles (the
in-process half of dingo_tpu/server/main.py, reference
src/server/main.cc:526-541 and server.cc:506-700).

``coordinator_crontab`` and ``store_crontab`` take an in-process
coordinator (a CoordinatorControl, or a RaftMetaCoordinator whose proxies
route mutations through its raft group) or a StoreNode and return a
CrontabManager carrying the jobs of the JAX package's schedule that the
port has: the coordinator's store-state update, lease GC and the three
balance/replica planners; the store's heartbeat, split check, vector-index
scrub, IVF view compaction, metrics collection, the quality tuner, the
load-shedding ladder, the integrity scrub, the device-memory watermark
poll, the memory-tier ladder's tick and the flight recorder's node
config. The gRPC serving of either role is not carried, nor are two
store jobs: the MVCC GC, whose safe point comes from the coordinator over
gRPC, and the stream scan GC. ``maybe_metrics_http`` starts the plain-HTTP
Prometheus sidecar when ``metrics_http_port`` is set. ``_make_engine``
opens a role's raw engine (mem, WAL or the native LSM) from its data
directory.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.crontab import CrontabManager
from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.coordinator.balance import (
    BalanceLeaderScheduler,
    BalanceRegionScheduler,
    ReplicaPlanScheduler,
)
from dingo_tpu_torch.engine.raw_engine import MemEngine, WalEngine
from dingo_tpu_torch.store.checker import PreSplitChecker

_log = get_logger("server.main")


def _make_engine(args):
    """Raw engine per ``args.engine`` ("mem", "wal" or "lsm"; default
    "wal") and ``args.data_dir``: a MemEngine without a data directory."""
    engine = getattr(args, "engine", "wal")
    if not args.data_dir:
        return MemEngine()
    if engine == "lsm":
        from dingo_tpu_torch.engine.lsm_engine import LsmRawEngine

        return LsmRawEngine(args.data_dir)
    if engine == "mem":
        return MemEngine()
    return WalEngine(args.data_dir)


def coordinator_crontab(control, kv_control,
                        is_leader: Optional[Callable[[], bool]] = None
                        ) -> CrontabManager:
    """The coordinator's schedule (reference main.py serve_coordinator):
    mutations run only where `is_leader()` holds (a follower of a
    replicated coordinator would bounce with NotLeader); a single
    coordinator passes no `is_leader`."""
    is_leader = is_leader or (lambda: True)

    def when_leader(fn):
        return lambda: fn() if is_leader() else None

    crontab = CrontabManager()
    crontab.add("update_store_state", 5.0,
                when_leader(control.update_store_states))
    crontab.add("lease_gc", 10.0, when_leader(kv_control.lease_gc))
    balance_leader = BalanceLeaderScheduler(control)

    def dispatch_balance_leader():
        # balance_mode is hot-changeable — re-read per tick
        balance_leader.mode = str(FLAGS.get("balance_mode"))
        return balance_leader.dispatch()

    crontab.add("balance_leader", 30.0, when_leader(dispatch_balance_leader))
    crontab.add("balance_region", 60.0,
                when_leader(BalanceRegionScheduler(control).dispatch))
    # the replica planner reads balance_replica_mode/qps_target per tick
    # and no-ops while the mode is off or the metrics are stale
    crontab.add("replica_plan", 30.0,
                when_leader(ReplicaPlanScheduler(control).dispatch))
    crontab.start()
    return crontab


def store_crontab(node) -> CrontabManager:
    """The store's schedule (reference main.py serve_store) over an
    in-process node: the heartbeat reaches ``node.coordinator`` directly."""
    crontab = CrontabManager()
    if node.coordinator is not None:
        crontab.add("heartbeat",
                    float(FLAGS.get("server_heartbeat_interval_s")),
                    node.heartbeat_once, immediately=True)
    crontab.add("split_check", 60.0,
                lambda: PreSplitChecker(node).run()
                if node.coordinator else None)
    scrub_worker = {"thread": None}

    def scrub_all():
        # rebuilds/saves can take minutes; run them OFF the shared crontab
        # thread so the other jobs keep ticking, one worker at a time
        t = scrub_worker["thread"]
        if t is not None and t.is_alive():
            return

        def work():
            for r in node.meta.get_all_regions():
                raft = node.engine.get_node(r.id)
                actions = node.index_manager.scrub(
                    r, act=True, raft_log=raft.log if raft else None
                )
                if actions.get("error"):
                    _log.warning("scrub region %d: %s", r.id,
                                 actions["error"])

        t = threading.Thread(target=work, name="scrub", daemon=True)
        scrub_worker["thread"] = t
        t.start()

    crontab.add("scrub_vector_index", 60.0, scrub_all)
    # IVF view compaction: restores the dense bucket layout once the
    # incrementally-maintained view accumulates tombstone/spill garbage,
    # off the search path (index/manager.py compact_views)
    crontab.add(
        "ivf_compact",
        float(FLAGS.get("ivf_compact_interval_s")),
        lambda: node.index_manager.compact_views(
            node.meta.get_all_regions()
        ),
    )
    # metrics collection rides its own crontab so heartbeats reuse the
    # cached snapshot instead of paying a full region sweep per beat
    crontab.add(
        "store_metrics",
        float(FLAGS.get("metrics_collect_interval_s")),
        node.metrics.collect,
        immediately=True,
    )
    # closed-loop SLO parameter controller (obs/tuner.py): one ladder
    # step per region per tick against the live recall interval; hot-gated
    # on tuner_enabled per tick
    from dingo_tpu_torch.obs.tuner import QualityTunerRunner

    crontab.add(
        "quality_tuner",
        float(FLAGS.get("tuner_interval_s")),
        QualityTunerRunner(node, crontab=crontab).tick,
    )
    # graduated load shedding (obs/pressure.py): one degrade level per
    # tick per over-pressure region, one back per calm tick; hot-gated on
    # qos_enabled and a 'degrade' shed policy
    from dingo_tpu_torch.obs.pressure import ShedController

    crontab.add(
        "qos_shed",
        float(FLAGS.get("qos_shed_interval_s")),
        ShedController(node, crontab=crontab).tick,
    )
    # state-integrity scrub (obs/integrity.py): recompute the digests from
    # device state in chunks under the store's device lock and check them
    # against the write-path ledger, on its own worker; hot-gated on
    # integrity_enabled
    from dingo_tpu_torch.obs.integrity import IntegrityScrubRunner

    crontab.add(
        "consistency_scrub",
        float(FLAGS.get("integrity_scrub_interval_s")),
        IntegrityScrubRunner(node, crontab=crontab).tick,
    )
    # memory-tier ladder (index/tiering.py): one policy pass a tick,
    # hot-gated on tier_enabled; a transition is a whole-region copy, so
    # the tick body runs on its own worker
    from dingo_tpu_torch.index.tiering import TierRunner

    crontab.add(
        "memory_tier",
        float(FLAGS.get("tier_interval_s")),
        TierRunner(node, crontab=crontab).tick,
    )
    # device-memory watermark poll (per-region owner ledgers refresh with
    # each store_metrics pass) and the flight recorder's node config
    from dingo_tpu_torch.obs.flight import FLIGHT
    from dingo_tpu_torch.obs.hbm import HBM

    crontab.add(
        "hbm_watermark",
        float(FLAGS.get("hbm_watermark_interval_s")),
        HBM.poll_process,
        immediately=True,
    )

    def flight_node_config():
        regions = {}
        for r in node.meta.get_all_regions():
            raft = node.engine.get_node(r.id) \
                if hasattr(node.engine, "get_node") else None
            param = r.definition.index_parameter
            regions[r.id] = {
                "type": r.definition.region_type.name,
                "index": param.index_type.name if param else None,
                "leader": raft.is_leader() if raft is not None else False,
            }
        return {"store_id": node.store_id, "regions": regions}

    FLIGHT.config_provider = flight_node_config
    crontab.start()
    return crontab


def maybe_metrics_http():
    """Start the plain-HTTP /metrics and /vars sidecar on
    ``metrics_http_port`` (0 = off); returns it (call ``stop()``) or
    None."""
    port = int(FLAGS.get("metrics_http_port"))
    if port <= 0:
        return None
    from dingo_tpu_torch.metrics.http import MetricsHttpServer

    srv = MetricsHttpServer(port)
    bound = srv.start()
    _log.info("metrics http sidecar on 127.0.0.1:%d/metrics", bound)
    return srv
