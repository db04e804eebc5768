"""The control-plane event ledger of the port (obs/events.py, its emitters
and the coordinator's timeline) against the JAX package's, case by case
from tests/test_events.py (the pb, DebugService, CLI, cache and tiering
cases stay there), each through both packages.

Tolerance: none. The same emissions give the same events (actor, region,
knob, old and new values, trigger, evidence), the same timeline order and
the same ``explain`` report in both packages; timestamps and sequence
numbers are each package's own clock."""

import json
import time
import types

import numpy as np
import pytest
import torch

from torch_cluster_util import PKGS, Pkg

torch.set_num_threads(1)

P = {name: Pkg(name) for name in PKGS}
_SAVED = ("events_enabled", "events_max_entries", "events_heartbeat_batch",
          "capacity_advise", "capacity_headroom_target")


@pytest.fixture(autouse=True)
def _fresh_ledger():
    saved = []
    for p in P.values():
        saved.append((p, {k: p.config.FLAGS.get(k) for k in _SAVED}))
        p.events.EVENTS.reset()
    yield
    for p, flags in saved:
        for k, v in flags.items():
            p.config.FLAGS.set(k, v)
        p.events.EVENTS.reset()


@pytest.fixture(params=PKGS)
def pkg(request):
    return P[request.param]


def _view(evs):
    """The comparable part of events: everything but clocks and seqs."""
    return [(e.actor, e.region_id, e.knob, e.old, e.new, e.trigger,
             e.evidence_dict(), e.node_id) for e in evs]


def _mk_event(p, **kw):
    base = dict(actor="tuner", region_id=7, knob="nprobe", old="8",
                new="16", trigger="tighten", evidence="", ts_ms=1000,
                actor_seq=1, node_id="s1")
    base.update(kw)
    return p.events.Event(**base)


# ---------------- ledger mechanics ----------------

def test_emit_records_stringified_change_and_evidence(pkg):
    ev_mod, m = pkg.events, pkg.metrics.METRICS
    c0 = m.counter("event.emitted", region_id=42,
                   labels={"actor": "tuner"}).get()
    ev = ev_mod.EVENTS.emit("tuner", 42, "nprobe", 8, 16, trigger="tighten",
                            evidence={"ci_low": 0.71, "slo": 0.95})
    assert (ev.actor, ev.region_id, ev.knob) == ("tuner", 42, "nprobe")
    assert (ev.old, ev.new) == ("8", "16")
    assert ev.ts_ms > 0 and ev.actor_seq > 0
    assert ev.evidence_dict() == {"ci_low": 0.71, "slo": 0.95}
    assert m.counter("event.emitted", region_id=42,
                     labels={"actor": "tuner"}).get() == c0 + 1
    assert ev_mod.EVENTS.recent(region_id=42) == [ev]


def test_flag_off_means_inert(pkg):
    pkg.config.FLAGS.set("events_enabled", False)
    E = pkg.events.EVENTS
    assert E.emit("tuner", 1, "nprobe", 8, 16, trigger="tighten") is None
    assert E.recent() == [] and E.state()["entries"] == 0


def test_ring_bound_counts_only_unharvested_drops(pkg):
    pkg.config.FLAGS.set("events_max_entries", 16)
    E = pkg.events.EVENTS
    for i in range(20):
        E.emit("shed", 1, "degrade_level", i, i + 1, trigger="escalate")
    assert E.state()["entries"] == 16 and E.dropped == 4
    assert len(E.harvest(batch=16, node_id="s1")) == 16
    for i in range(16):
        E.emit("shed", 1, "degrade_level", i, i + 1, trigger="escalate")
    assert E.dropped == 4 and E.state()["entries"] == 16


def test_actor_seq_monotone_within_and_across_restart(pkg):
    E = pkg.events.EVENTS
    a = E.emit("tier", 1, "tier", "hbm", "hbm_sq8", trigger="demote")
    b = E.emit("tier", 1, "tier", "hbm_sq8", "host_sq8", trigger="demote")
    assert b.actor_seq == a.actor_seq + 1
    time.sleep(0.002)
    c = pkg.events.EventLedger().emit("tier", 1, "tier", "host_sq8",
                                      "hbm_sq8", trigger="promote")
    assert c.actor_seq > b.actor_seq


def test_harvest_ships_each_event_exactly_once_and_stamps_node(pkg):
    E = pkg.events.EVENTS
    for i in range(3):
        E.emit("tuner", 1, "nprobe", i, i + 1, trigger="tighten")
    first = E.harvest(batch=2, node_id="s9")
    assert len(first) == 2 and all(e.node_id == "s9" for e in first)
    assert len(E.harvest(batch=8, node_id="s9")) == 1
    assert E.harvest(batch=8, node_id="s9") == []
    assert len(E.recent()) == 3


def test_same_emissions_same_events():
    got = {}
    for name, p in P.items():
        E = p.events.EVENTS
        E.emit("tuner", 3, "nprobe", 8, 16, trigger="tighten",
               evidence={"ci_low": 0.7, "slo": 0.95})
        E.emit("shed", 3, "degrade_level", 0, 1, trigger="escalate")
        E.emit("tuner", 4, "ef", 64, 96, trigger="tighten")
        E.forget_region(4)
        got[name] = (_view(E.harvest(node_id="s1")), E.state()["entries"])
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]


# ---------------- the timeline and explain ----------------

def test_timeline_orders_by_receive_adjusted_clock(pkg):
    tl = pkg.events.ClusterTimeline()
    a = _mk_event(pkg, node_id="sA", ts_ms=1_000, actor_seq=5)
    b = _mk_event(pkg, node_id="sB", actor="shed", knob="degrade_level",
                  ts_ms=10_500, actor_seq=3)
    assert tl.merge("sB", [b], offset_ms=0) == 1
    assert tl.merge("sA", [a], offset_ms=10_000) == 1
    assert [e.node_id for e in tl.events()] == ["sB", "sA"]
    assert tl.merge("sA", [a], offset_ms=10_000) == 0
    assert len(tl.events()) == 2


def test_coordinator_heartbeat_merges_skewed_stores(pkg):
    coord = pkg.coordinator(replication=1)
    snapm = pkg.snapshot
    coord.register_store("sA")
    coord.register_store("sB")
    now = int(time.time() * 1000)
    evA = _mk_event(pkg, node_id="sA", actor="shed", knob="degrade_level",
                    ts_ms=now - 10_000, actor_seq=9)
    evB = _mk_event(pkg, node_id="sB", ts_ms=now - 80, actor_seq=4)
    snapB = snapm.StoreMetricsSnapshot("sB")
    snapB.collected_at_ms = now - 80
    snapB.events = [evB]
    snapA = snapm.StoreMetricsSnapshot("sA")
    snapA.collected_at_ms = now - 10_000
    snapA.events = [evA]
    coord.store_heartbeat("sB", metrics=snapB)
    time.sleep(0.01)
    coord.store_heartbeat("sA", metrics=snapA)
    assert [e.node_id for e in coord.cluster_events(region_id=7)] == \
        ["sB", "sA"]
    coord.store_heartbeat("sA", metrics=snapA)
    assert len(coord.cluster_events(region_id=7)) == 2


def test_live_overrides_equal_the_reference():
    got = {}
    for name, p in P.items():
        R = p.snapshot.RegionMetricsSnapshot
        rows = [
            R(7, live_knobs=json.dumps({
                "tuning": {"nprobe": 96, "ef": 40},
                "advisory_precision": "sq8", "tier": "host_sq8",
                "tier_base": "hbm"}), qos_degrade_level=2,
              device_degraded=True),
            R(7, live_knobs=json.dumps({"tuning": {}, "tier": "hbm",
                                        "tier_base": "hbm"})),
            R(7, serving_tier="host_sq8"),
            R(7, serving_tier="hbm"),
        ]
        got[name] = [p.events.live_overrides(r) for r in rows]
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]
    assert got["dingo_tpu_torch"][0]["degrade_level"] == "2"


def _episode(p, rid, monkeypatch):
    """The seven emits of one episode, each package's events clock held at
    one instant across them. ``explain_region`` sorts a knob's chain by
    (ts_ms, node_id, actor_seq), and actor_seq starts at ts_ms * 1000 for
    each actor: the ``capacity`` and ``tier`` events tie when they share a
    millisecond and not across a boundary, so a package whose emits
    straddled one would order the chain otherwise than the other."""
    now = time.time()
    monkeypatch.setattr(p.events, "time", types.SimpleNamespace(
        time=lambda: now, perf_counter=time.perf_counter))
    E = p.events.EVENTS
    E.emit("tuner", rid, "nprobe", 8, 16, trigger="tighten",
           evidence={"ci_low": 0.7, "slo": 0.95})
    E.emit("shed", rid, "degrade_level", 0, 1, trigger="escalate",
           evidence={"pressure_ms": 120.0})
    E.emit("shed", rid, "degrade_level", 1, 2, trigger="escalate",
           evidence={"pressure_ms": 200.0})
    E.emit("capacity", rid, "advisory", "", "demote", trigger="headroom",
           evidence={"headroom_frac": 0.03})
    E.emit("tier", rid, "tier", "hbm", "host_sq8", trigger="demote",
           evidence={"headroom": 0.03})
    E.emit("recovery", rid, "device_degraded", 0, 1, trigger="oom",
           evidence={"reason": "oom"})
    E.emit("recovery", rid, "device_degraded", 1, 0, trigger="remat",
           evidence={"precision": "sq8"})
    live = {"nprobe": "16", "degrade_level": "2", "tier": "host_sq8"}
    return p.events.explain_region(rid, live, E.recent())


def _report_view(report):
    return {"orphans": report["orphans"],
            "entries": [(e["knob"], e["value"], e["explained"],
                         _view(e["chain"]))
                        for e in report["entries"]]}


def test_explain_reconstructs_the_full_episode_zero_orphans(monkeypatch):
    got = {n: _episode(p, 31, monkeypatch) for n, p in P.items()}
    port = got["dingo_tpu_torch"]
    assert port["orphans"] == []
    assert all(e["explained"] for e in port["entries"])
    by_knob = {e["knob"]: e for e in port["entries"]}
    assert [(e.old, e.new) for e in by_knob["degrade_level"]["chain"]] == \
        [("0", "1"), ("1", "2")]
    assert {e.actor for e in by_knob["tier"]["chain"]} == {"tier",
                                                          "capacity"}
    assert _report_view(port) == _report_view(got["dingo_tpu"])


def test_explain_flags_orphans(pkg):
    ex, E = pkg.events.explain_region, pkg.events.EVENTS
    report = ex(32, {"ef": "64"}, [])
    assert report["orphans"] == ["ef"]
    E.emit("tuner", 32, "nprobe", 8, 16, trigger="tighten")
    assert ex(32, {"nprobe": "64"}, E.recent())["orphans"] == ["nprobe"]
    assert ex(32, {"nprobe": "16"}, E.recent())["orphans"] == []


def test_coordinator_explain_sets_orphan_gauge(pkg):
    coord = pkg.coordinator(replication=1)
    coord.register_store("s1")
    S, R = pkg.snapshot.StoreMetricsSnapshot, pkg.snapshot.RegionMetricsSnapshot
    rid, now = 33, int(time.time() * 1000)
    snap = S("s1", regions=[R(rid, is_leader=True, live_knobs=json.dumps(
        {"tuning": {"nprobe": 16}}))])
    snap.collected_at_ms = now
    snap.events = [_mk_event(pkg, region_id=rid, new="16", ts_ms=now)]
    coord.store_heartbeat("s1", metrics=snap)
    assert coord.explain_region_overrides(rid)["orphans"] == []
    g = pkg.metrics.METRICS.gauge("event.orphan_knobs", region_id=rid)
    assert g.get() == 0.0
    snap2 = S("s1", regions=[R(rid, is_leader=True, live_knobs=json.dumps(
        {"tuning": {"nprobe": 16, "ef": 80}}))])
    snap2.collected_at_ms = now + 1
    coord.store_heartbeat("s1", metrics=snap2)
    assert coord.explain_region_overrides(rid)["orphans"] == ["ef"]
    assert g.get() == 1.0


# ---------------- the emitters ----------------

def _ivf(p, rid, nprobe):
    b = p.base
    return p.new_index(rid, b.IndexParameter(
        index_type=b.IndexType.IVF_FLAT, dimension=32, ncentroids=16,
        default_nprobe=nprobe))


class _PlaneRecorder:
    def reset_region(self, region_id):
        pass


def _estimate(recall):
    return {"recall": recall, "ci_low": recall - 0.01,
            "ci_high": recall + 0.01, "queries": 100, "trials": 1000,
            "newest_ts": time.time(), "oldest_ts": time.time() - 1.0}


def test_emitters_equal_the_reference():
    """The tuner, the shed ladder, the recovery plane and the replica
    planner emit the same events in both packages."""
    got = {}
    for name, p in P.items():
        E = p.events.EVENTS
        idx = _ivf(p, 9701, 1)
        tuner = p.tuner.SloTuner(slo_recall=0.95, latency_budget_ms=0.0,
                                 quality_plane=_PlaneRecorder())
        tuner.step_index(idx, _estimate(0.5))
        ctl = p.pressure.ShedController(node=None)
        idx2 = _ivf(p, 9702, 4)
        try:
            ctl.step_region(9702, idx2, pressure_ms=200.0, max_queue_ms=50.0)
            ctl.step_region(9702, idx2, pressure_ms=5.0, max_queue_ms=50.0)
        finally:
            p.metrics.METRICS.gauge("qos.degrade_level",
                                    region_id=9702).set(0.0)
        rec = p.recovery.RECOVERY
        try:
            rec.mark_degraded(9703, "oom during search")
        finally:
            rec.clear_degraded(9703)
        got[name] = _view(E.recent())
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]
    actors = [v[0] for v in got["dingo_tpu_torch"]]
    assert actors == ["tuner", "shed", "shed", "recovery"]


def test_replica_planner_emits_scale_decision(pkg):
    S, R = pkg.snapshot.StoreMetricsSnapshot, pkg.snapshot.RegionMetricsSnapshot

    class _Store:
        def __init__(self, sid):
            self.store_id = sid

    class _Region:
        def __init__(self, peers):
            self.peers = list(peers)

    class _Control:
        def __init__(self):
            self.regions = {1: _Region(["s1"])}
            self._metrics = {
                "s1": S("s1", regions=[R(1, is_leader=True,
                                         search_qps=120.0)]),
                "s2": S("s2", regions=[])}

        def alive_stores(self):
            return [_Store("s1"), _Store("s2")]

        def get_store_metrics(self):
            return [(sid, snap, 0.0, False)
                    for sid, snap in self._metrics.items()]

        def change_peer(self, region_id, peers):
            self.regions[region_id] = _Region(peers)

    sched = pkg.balance.ReplicaPlanScheduler(_Control(), mode="auto",
                                             qps_target=50.0)
    assert sched.dispatch() == 1
    evs = pkg.events.EVENTS.recent(actor="planner", region_id=1)
    assert [(e.knob, e.old, e.new) for e in evs] == [("replicas", "1", "2")]
    ev = evs[0].evidence_dict()
    assert ev["qps"] == 120.0 and ev["target_qps"] == 50.0 and ev["add"]


def test_capacity_advisor_emits_headroom_evidence(pkg):
    f = pkg.config.FLAGS
    f.set("capacity_advise", True)
    f.set("capacity_headroom_target", 0.2)
    coord = pkg.coordinator(replication=1)
    coord.register_store("s1")
    rm = pkg.snapshot.RegionMetricsSnapshot(9705)
    rm.device_memory_bytes = 200 << 20
    rm.heat_working_set_p99 = 4 << 20
    rm.heat_touches = 8000
    rm.heat_hot_fraction = 0.9
    snap = pkg.snapshot.StoreMetricsSnapshot("s1", regions=[rm])
    snap.device_bytes_limit = 256 << 20
    snap.device_bytes_in_use = 250 << 20
    coord.store_heartbeat("s1", region_ids=[9705], metrics=snap)
    evs = pkg.events.EVENTS.recent(actor="capacity", region_id=9705)
    assert {e.new for e in evs} == {"demote", "split"}
    assert evs[0].evidence_dict()["store"] == "s1"
    assert {e.actor for e in coord.cluster_events(region_id=9705)} == \
        {"capacity"}


def test_recovery_events_reach_the_timeline_through_heartbeats(pkg):
    """A store's events ride its collector's snapshot into the
    coordinator's timeline exactly once."""
    from torch_cluster_util import drive_heartbeats, stop_nodes

    transport, coord, nodes = pkg.cluster(n=1, replication=1)
    try:
        n = nodes["s0"]
        pkg.events.EVENTS.emit("recovery", 77, "device_degraded", 0, 1,
                               trigger="oom", evidence={"rung": "degrade"})
        n.metrics._latest_mono = 0.0
        drive_heartbeats(nodes, rounds=2)
        evs = coord.cluster_events(region_id=77)
        assert [(e.actor, e.node_id, e.new) for e in evs] == \
            [("recovery", "s0", "1")]
    finally:
        stop_nodes(nodes)
