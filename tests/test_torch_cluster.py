"""The in-process control plane of the port against the JAX package's: the
cases of test_cluster.py (coordinator + three StoreNodes on LocalTransport,
heartbeats, region create / split / merge / peer change, failure
detection, balance planning, TSO, auto-increment, KV), each driven
through both packages with the same sequence of coordinator calls and
heartbeats, plus the heartbeat's ``device_degraded`` flag, the metrics
snapshot, the region commands, the crontab schedules and the
``is_switching`` flag of the index switch.

Held equal between the packages: the coordinator's region definitions
(ids, keys, epoch version and conf_version, peers), the commands it
issued (type, region, split key, child id, in order), KV revisions, and
search replies (ids modulo exact ties, distances at rtol 1e-5, atol
1e-5 near 0). TSO
values come from the wall clock and are held monotonic, not equal. The
port runs on the CPU (``device="cpu"``); every wait has a deadline.
"""

import json
import time

import numpy as np
import pytest
import torch

from torch_cluster_util import (
    PKGS,
    Pkg,
    assert_same_modulo_ties,
    cmd_view,
    drive_heartbeats,
    exact_ids,
    region_view,
    rows,
    stop_nodes,
    wait_for,
    wait_region_leader,
)

torch.set_num_threads(1)


def both(scenario, **kw):
    """Run `scenario(pkg, **kw)` on the JAX package, then on the port;
    returns their observables."""
    return [scenario(Pkg(name), **kw) for name in PKGS]


def assert_same_plane(ref, port):
    assert port["regions"] == ref["regions"]
    assert port["cmds"] == ref["cmds"]


# -- the cases of test_cluster.py --------------------------------------------

def _create_via_heartbeat(p):
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord)
        drive_heartbeats(nodes)
        for n in nodes.values():
            assert n.get_region(d.region_id) is not None
        leader = wait_region_leader(nodes, d.region_id)
        x = np.eye(8, dtype=np.float32)[:4]
        region = leader.get_region(d.region_id)
        leader.storage.vector_add(region, np.arange(4, dtype=np.int64), x)
        res = leader.storage.vector_batch_search(region, x[:1], 1)
        assert res[0][0].id == 0
        return {"regions": region_view(coord), "cmds": cmd_view(coord),
                "res": res}
    finally:
        stop_nodes(nodes)


def test_create_region_via_heartbeat():
    ref, port = both(_create_via_heartbeat)
    assert_same_plane(ref, port)
    assert_same_modulo_ties(ref["res"], port["res"])


def _split_then_rebuild(p):
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord, hi=1000)
        drive_heartbeats(nodes)
        leader = wait_region_leader(nodes, d.region_id)
        region = leader.get_region(d.region_id)
        x = np.random.default_rng(0).standard_normal((100, 8)).astype(
            np.float32)
        leader.storage.vector_add(region, np.arange(100, dtype=np.int64), x)
        time.sleep(0.3)
        child_id = coord.split_region(d.region_id,
                                      p.vcodec.encode_vector_key(0, 50))
        drive_heartbeats(nodes)
        time.sleep(0.3)
        for n in nodes.values():
            child = n.get_region(child_id)
            assert child is not None, n.store_id
            assert child.id_window()[0] == 50
        assert region.id_window()[1] == 50
        assert coord.regions[child_id].start_key == \
            p.vcodec.encode_vector_key(0, 50)
        assert coord.regions[d.region_id].end_key == \
            p.vcodec.encode_vector_key(0, 50)
        child_leader = wait_region_leader(nodes, child_id)
        child = child_leader.get_region(child_id)
        assert child.vector_index_wrapper.share_index is not None
        shared = child_leader.engine.new_vector_reader(
            child).vector_batch_search(x[60][None, :], 5)
        assert shared[0][0].id == 60
        assert all(v.id >= 50 for v in shared[0])
        child_leader.finish_child_index(child_id)
        assert child.vector_index_wrapper.share_index is None
        assert child.vector_index_wrapper.own_index.get_count() == 50
        own = child_leader.engine.new_vector_reader(
            child).vector_batch_search(x[60][None, :], 3)
        assert own[0][0].id == 60
        return {"regions": region_view(coord), "cmds": cmd_view(coord),
                "shared": shared, "own": own, "x": x}
    finally:
        stop_nodes(nodes)


def test_split_shares_index_then_rebuilds():
    ref, port = both(_split_then_rebuild)
    assert_same_plane(ref, port)
    assert_same_modulo_ties(ref["shared"], port["shared"])
    assert_same_modulo_ties(ref["own"], port["own"])
    # the share serves the child's window of the parent's rows exactly
    x = port["x"]
    want, _ = exact_ids(x[50:], np.arange(50, 100), x[60], 5)
    assert rows(port["shared"])[0][0].tolist() == want.tolist()


def _failure_detection(p):
    transport, coord, nodes = p.cluster()
    try:
        d = coord.create_region(start_key=b"a", end_key=b"z")
        drive_heartbeats(nodes)
        coord.stores["s2"].last_heartbeat_ms -= 60_000
        newly = coord.update_store_states()
        assert newly == ["s2"]
        health = coord.check_region_health()
        assert len(health) == 1
        rid, replacement = health[0]
        assert rid == d.region_id
        assert "s2" not in replacement
        assert len(replacement) == 2
        return {"regions": region_view(coord), "cmds": cmd_view(coord),
                "health": health,
                "states": {s: i.state.value for s, i in coord.stores.items()}}
    finally:
        stop_nodes(nodes)


def test_store_failure_detection_and_replacement_plan():
    ref, port = both(_failure_detection)
    assert_same_plane(ref, port)
    assert port["health"] == ref["health"]
    assert port["states"] == ref["states"]


def _balance_planning(p):
    coord = p.coordinator(replication=1)
    for sid in ("a", "b"):
        coord.register_store(sid)
    rids = []
    for i in range(6):
        d = coord.create_region(start_key=bytes([i]), end_key=bytes([i + 1]),
                                replication=1)
        rids.append(d.region_id)
    coord.stores["a"].region_ids = rids
    coord.stores["a"].leader_region_ids = rids
    coord.stores["b"].region_ids = []
    coord.stores["b"].leader_region_ids = []
    for rid in rids:
        coord.region_leaders[rid] = "a"
    moves = p.balance.BalanceRegionScheduler(coord).plan()
    assert moves and all(m.from_store == "a" and m.to_store == "b"
                         for m in moves)
    coord.regions[rids[0]].peers = ["a", "b"]
    ops = p.balance.BalanceLeaderScheduler(coord).plan()
    assert any(op.region_id == rids[0] for op in ops)
    n_moved = p.balance.BalanceRegionScheduler(coord).dispatch()
    n_led = p.balance.BalanceLeaderScheduler(coord).dispatch()
    return {"regions": region_view(coord), "cmds": cmd_view(coord),
            "moves": [(m.region_id, m.from_store, m.to_store) for m in moves],
            "ops": [(o.region_id, o.from_store, o.to_store) for o in ops],
            "dispatched": (n_moved, n_led)}


def test_balance_planning():
    ref, port = both(_balance_planning)
    assert_same_plane(ref, port)
    for key in ("moves", "ops", "dispatched"):
        assert port[key] == ref[key], key


def _tso_restart(p):
    eng = p.raw.MemEngine()
    tso = p.tso.TsoControl(eng)
    first, _ = tso.gen_ts(100)
    tso2 = p.tso.TsoControl(eng)
    second, _ = tso2.gen_ts(1)
    assert second > first
    return {"first": first, "second": second}


def test_tso_monotonic_across_restart():
    # wall-clock values: each package's held monotonic across the restart
    # (inside the scenario), not equal to the other's
    ref, port = both(_tso_restart)
    assert port["second"] > port["first"] and ref["second"] > ref["first"]


def _auto_increment(p):
    eng = p.raw.MemEngine()
    ai = p.ai.AutoIncrementControl(eng)
    got = [ai.generate(7, 10), ai.generate(7, 5)]
    ai2 = p.ai.AutoIncrementControl(eng)
    got.append(ai2.generate(7, 1))
    assert got[0] == (1, 11) and got[1][0] == 11 and got[2][0] == 16
    return got


def test_auto_increment():
    ref, port = both(_auto_increment)
    assert port == ref


def _kv_etcd(p):
    kv = p.kvm.KvControl(p.raw.MemEngine())
    r1 = kv.kv_put(b"/cfg/a", b"1")
    r2 = kv.kv_put(b"/cfg/a", b"2")
    assert r2 > r1
    items, rev = kv.kv_range(b"/cfg/", b"/cfg/\xff")
    assert len(items) == 1 and items[0].version == 2
    events = []
    kv.watch(b"/cfg/b", r2 + 1,
             lambda ev, item: events.append((ev, item.value)))
    kv.kv_put(b"/cfg/b", b"x")
    assert events == [("put", b"x")]
    kv.kv_put(b"/cfg/b", b"y")
    assert len(events) == 1
    lease = kv.lease_grant(ttl_s=60)
    kv.kv_put(b"/eph/1", b"v", lease_id=lease.lease_id)
    assert kv.lease_revoke(lease.lease_id) == 1
    assert kv.kv_range(b"/eph/1")[0] == []
    return {"revs": (r1, r2, rev, kv._revision), "events": events,
            "lease": lease.lease_id}


def test_kv_control_etcd_semantics():
    ref, port = both(_kv_etcd)
    assert port == ref


def _kv_lease_expiry(p):
    kv = p.kvm.KvControl(p.raw.MemEngine())
    lease = kv.lease_grant(ttl_s=0)
    time.sleep(0.01)
    kv.kv_put(b"/x", b"v")
    kv.lease_gc()
    with pytest.raises(KeyError):
        kv.kv_put(b"/e", b"v", lease_id=lease.lease_id)
    return kv._revision


def test_kv_lease_expiry():
    ref, port = both(_kv_lease_expiry)
    assert port == ref


def _change_peer(p):
    transport, coord, nodes = p.cluster()
    nodes["s3"] = p.store("s3", transport, coord, 3)
    try:
        d = coord.create_region(start_key=b"a", end_key=b"z", replication=2)
        drive_heartbeats(nodes)
        leader = wait_region_leader(
            {k: v for k, v in nodes.items() if k in d.peers}, d.region_id)
        region = leader.get_region(d.region_id)
        leader.storage.kv_put(region, [(b"k1", b"v1"), (b"k2", b"v2")])
        outsider = next(s for s in nodes if s not in d.peers)
        coord.change_peer(d.region_id, d.peers + [outsider])
        drive_heartbeats(nodes, rounds=6)
        time.sleep(0.5)
        new_node = nodes[outsider]
        assert new_node.get_region(d.region_id) is not None
        got = new_node.storage.kv_get(new_node.get_region(d.region_id),
                                      b"k1")
        assert got == b"v1"
        return {"regions": region_view(coord), "cmds": cmd_view(coord),
                "outsider": outsider}
    finally:
        stop_nodes(nodes)


def test_change_peer_catches_up_new_store():
    ref, port = both(_change_peer)
    assert_same_plane(ref, port)
    assert port["outsider"] == ref["outsider"]


def _dedup(ids):
    out = []
    for i in ids:
        if i not in out:
            out.append(i)
    return out


def _split_merge(p, partition, seed, n, mid, delete=None, probe=75):
    """The merge cases' shared sequence: split at `mid`, the child's own
    index, merge back, an optional delete in the absorbed range."""
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord, partition=partition, hi=1000)
        drive_heartbeats(nodes)
        leader = wait_region_leader(nodes, d.region_id)
        region = leader.get_region(d.region_id)
        x = np.random.default_rng(seed).standard_normal((n, 8)).astype(
            np.float32)
        leader.storage.vector_add(region, np.arange(n, dtype=np.int64), x)
        time.sleep(0.3)
        child_id = coord.split_region(
            d.region_id, p.vcodec.encode_vector_key(partition, mid))
        drive_heartbeats(nodes, rounds=4)
        time.sleep(0.5)
        wait_region_leader(nodes, child_id).finish_child_index(child_id)
        coord.merge_region(d.region_id, child_id)
        drive_heartbeats(nodes, rounds=4)
        time.sleep(0.5)
        for nd in nodes.values():
            assert nd.get_region(child_id) is None, nd.store_id
        assert region.id_window() == (0, 1000)
        assert coord.regions.get(child_id) is None
        assert coord.regions[d.region_id].end_key == \
            p.vcodec.encode_vector_key(partition, 1000)
        tl = wait_region_leader(nodes, d.region_id)
        tr = tl.get_region(d.region_id)
        assert tr.vector_index_wrapper.sibling_index is not None
        if delete is not None:
            tl.storage.vector_delete(tr, [delete])
        merged = tl.engine.new_vector_reader(tr).vector_batch_search(
            x[probe][None, :], 3)
        out = {"regions": region_view(coord), "cmds": cmd_view(coord),
               "merged": merged, "x": x}
        if delete is None:
            tl.finish_merge_index(d.region_id)
            assert tr.vector_index_wrapper.sibling_index is None
            assert tr.vector_index_wrapper.own_index.get_count() == n
            out["rebuilt"] = tl.engine.new_vector_reader(
                tr).vector_batch_search(x[probe][None, :], 3)
        return out
    finally:
        stop_nodes(nodes)


def test_merge_regions():
    ref, port = both(_split_merge, partition=3, seed=1, n=100, mid=50)
    assert_same_plane(ref, port)
    x = port["x"]
    want, _ = exact_ids(x, np.arange(100), x[75], 3)
    got = rows(port["merged"])[0][0].tolist()
    ref_ids = rows(ref["merged"])[0][0].tolist()
    assert got[0] == ref_ids[0] == 75
    # the JAX package's sibling merge repeats the ids both indexes hold;
    # the port's holds each once: its answer is numpy's, and it begins
    # with the JAX answer's distinct ids
    assert got == want.tolist()
    assert got[:len(_dedup(ref_ids))] == _dedup(ref_ids)
    assert_same_modulo_ties(ref["rebuilt"], port["rebuilt"])


def _stale_beat_after_merge(p):
    """Split, merge back, then deliver a heartbeat whose region list a
    store read before it applied the merge: the child's leader still
    reporting the child's definition. Returns whether the coordinator's
    map holds the child afterwards."""
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord, partition=5, hi=1000)
        drive_heartbeats(nodes)
        leader = wait_region_leader(nodes, d.region_id)
        leader.storage.vector_add(
            leader.get_region(d.region_id), np.arange(40, dtype=np.int64),
            np.random.default_rng(3).standard_normal((40, 8)).astype(
                np.float32))
        child_id = coord.split_region(
            d.region_id, p.vcodec.encode_vector_key(5, 20))
        drive_heartbeats(nodes, rounds=4)
        time.sleep(0.5)
        child_leader = wait_region_leader(nodes, child_id)
        stale = child_leader.get_region(child_id).definition
        coord.merge_region(d.region_id, child_id)
        drive_heartbeats(nodes, rounds=4)
        time.sleep(0.5)
        assert coord.regions.get(child_id) is None
        coord.store_heartbeat(child_leader.store_id,
                              region_ids=[d.region_id, child_id],
                              leader_region_ids=[child_id],
                              region_defs=[stale])
        return coord.regions.get(child_id) is not None
    finally:
        stop_nodes(nodes)


def test_stale_heartbeat_does_not_bring_back_a_merged_region():
    """The coordinator reconciles its map from the definitions a store
    reports as leader; a beat read before the store applied a merge
    carries the absorbed child. The port keeps merged-away ids out of that
    reconciliation (ROADMAP section C, fault C10: the smoke's cluster
    phase waited out its merge on exactly this); the JAX package puts the
    child back, pinned here as the known difference."""
    assert _stale_beat_after_merge(Pkg("dingo_tpu_torch")) is False
    assert _stale_beat_after_merge(Pkg("dingo_tpu")) is True


def _split_checker(p):
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord, partition=4, hi=10000)
        drive_heartbeats(nodes)
        leader = wait_region_leader(nodes, d.region_id)
        region = leader.get_region(d.region_id)
        leader.storage.vector_add(
            region, np.arange(200, dtype=np.int64),
            np.random.default_rng(2).standard_normal((200, 8)).astype(
                np.float32))
        proposals = p.checker.PreSplitChecker(leader, max_keys=100).run()
        assert len(proposals) == 1
        assert proposals[0].region_id == d.region_id
        assert any(c.cmd_type.value == "split"
                   for q in coord.store_ops.values() for c in q)
        drive_heartbeats(nodes, rounds=4)
        time.sleep(0.5)
        merges = p.checker.PreMergeChecker(leader, min_keys=10_000).run()
        assert len(merges) >= 1
        return {"regions": region_view(coord), "cmds": cmd_view(coord),
                "split": [(q.region_id, q.split_key) for q in proposals],
                "merges": [(m.source_region_id, m.target_region_id)
                           for m in merges]}
    finally:
        stop_nodes(nodes)


def test_split_checker_proposes_midpoint():
    ref, port = both(_split_checker)
    assert_same_plane(ref, port)
    assert port["split"] == ref["split"]
    # the median id of 0..199 (HALF_SPLIT)
    assert port["split"][0][1] == Pkg("dingo_tpu_torch").vcodec\
        .encode_vector_key(4, 100)
    assert port["merges"] == ref["merges"]


def test_merge_sibling_sees_deletes():
    ref, port = both(_split_merge, partition=5, seed=7, n=60, mid=30,
                     delete=45, probe=45)
    assert_same_plane(ref, port)
    for obs in (ref, port):
        assert 45 not in rows(obs["merged"])[0][0].tolist()
    x = port["x"]
    live = np.delete(np.arange(60), 45)
    want, _ = exact_ids(x[live], live, x[45], 3)
    assert rows(port["merged"])[0][0].tolist() == want.tolist()


# -- the heartbeat's device_degraded flag (test_device_recovery.py) ---------

def _degraded_beat(p):
    coord = p.coordinator(replication=1)
    n = p.store("s0", p.raft.LocalTransport(), coord, 0)
    rec, fault = p.recovery.RECOVERY, p.devfault.DEVFAULT
    fault.disarm()
    rec.clear()
    try:
        d = p.index_region(coord)
        wait_for(lambda: n.heartbeat_once() is not None and
                 (rn := n.engine.get_node(d.region_id)) is not None and
                 rn.is_leader(), what="a region leader")
        region = n.get_region(d.region_id)
        x = np.random.default_rng(3).standard_normal((32, 8)).astype(
            np.float32)
        ids = np.arange(32, dtype=np.int64)
        n.storage.vector_add(region, ids[:8], x[:8])
        fault.arm(1 << 30)
        n.storage.vector_add(region, ids[8:], x[8:])
        fault.disarm()
        rm = n.metrics.collect().region(d.region_id)
        assert rm.device_degraded is True
        # the flag reaches the coordinator in the next beat
        n.metrics._latest_mono = 0.0
        n.heartbeat_once()
        seen = coord.get_region_metrics(d.region_id)
        assert [r.device_degraded for _, _, r in seen] == [True]
        rec.run_rematerializations(n)
        rm2 = n.metrics.collect().region(d.region_id)
        assert rm2.device_degraded is False
        return {"cmds": cmd_view(coord), "flags": (True, False),
                "count": rm2.vector_count}
    finally:
        fault.disarm()
        rec.clear()
        n.stop()


def test_heartbeat_snapshot_carries_device_degraded():
    ref, port = both(_degraded_beat)
    assert port == ref


# -- the metrics snapshot ----------------------------------------------------

#: the snapshot fields fed by the observability planes (quality,
#: pressure, integrity, heat, cost, events; the search QPS of
#: IndexService): both packages fill them from the same state, equal;
#: device_peak_bytes is held by its relation to the region's device bytes
#: (each package's own layout); the memory-tier ladder's serving_tier and
#: the edge cache's cache_* fields compare equal like the rest
PLANE_FIELDS = (
    "search_qps", "device_peak_bytes", "quality_recall",
    "quality_recall_ci_low", "quality_recall_ci_high", "quality_samples",
    "qos_queue_depth", "qos_queue_wait_ms", "qos_shed_total",
    "qos_degrade_level", "integrity_applied_index", "integrity_digests",
    "integrity_mismatch", "cache_hits", "cache_misses", "cache_entries",
    "heat_hot_fraction", "heat_gini", "heat_working_set_p50",
    "heat_working_set_p90", "heat_working_set_p99", "heat_touches",
    "cost_row_us", "serving_tier", "live_knobs")
#: fields both packages fill from the same state
SHARED_FIELDS = ("region_id", "key_count", "approximate_bytes",
                 "vector_count", "index_ready", "index_building",
                 "index_build_error", "index_apply_log_id",
                 "index_snapshot_log_id", "apply_lag", "is_leader",
                 "document_count", "device_degraded")


def _snapshot(p):
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord)
        drive_heartbeats(nodes)
        leader = wait_region_leader(nodes, d.region_id)
        region = leader.get_region(d.region_id)
        x = np.random.default_rng(4).standard_normal((64, 8)).astype(
            np.float32)
        leader.storage.vector_add(region, np.arange(64, dtype=np.int64), x)
        raft = leader.engine.get_node(d.region_id)
        wait_for(lambda: all(
            nd.engine.get_node(d.region_id).last_applied >= raft.commit_index
            for nd in nodes.values()), what="every replica applied")
        snaps = {sid: nd.metrics.collect() for sid, nd in nodes.items()}
        for nd in nodes.values():
            nd.metrics._latest_mono = 0.0
        drive_heartbeats(nodes, rounds=1)
        return {"snaps": snaps, "rollup": coord.cluster_metrics_rollup(),
                "leader": leader.store_id,
                "summary": {sid: coord.store_metrics_summary(sid)
                            for sid in nodes}}
    finally:
        stop_nodes(nodes)


def test_metrics_snapshot_fields():
    ref, port = both(_snapshot)
    for sid, snap in port["snaps"].items():
        rsnap = ref["snaps"][sid]
        assert snap.store_id == rsnap.store_id == sid
        assert snap.engine_key_count == rsnap.engine_key_count
        for rm, rrm in zip(snap.regions, rsnap.regions):
            for f in SHARED_FIELDS:
                if f == "is_leader":
                    continue     # the leader is whoever won the election
                assert getattr(rm, f) == getattr(rrm, f), (sid, f)
            for f in PLANE_FIELDS:
                if f == "device_peak_bytes":
                    for m in (rm, rrm):
                        assert m.device_peak_bytes >= \
                            m.device_memory_bytes > 0, (sid, f)
                else:
                    assert getattr(rm, f) == getattr(rrm, f), (sid, f)
            # the integrity plane is on by default in both packages: the
            # replicas' digest vectors of the same 64 rows are equal
            assert json.loads(rm.integrity_digests)["rows"]
            assert rm.integrity_applied_index > 0
            assert rm.index_ready and rm.vector_count == 64
            assert rm.device_memory_bytes > 0
        # a CPU store keeps no device state
        assert snap.device_bytes_in_use == snap.device_bytes_limit == 0
    assert port["rollup"]["key_count"] == ref["rollup"]["key_count"]
    assert port["rollup"]["vector_count"] == ref["rollup"]["vector_count"]
    for sid in port["summary"]:
        for f in ("key_count", "vector_count", "stale"):
            assert port["summary"][sid][f] == ref["summary"][sid][f]


def test_snapshot_bytes_equal_the_reference():
    """A heartbeat payload persists to the same bytes in both packages, so
    a replicated coordinator's log entries decode in either."""
    ref, port = Pkg("dingo_tpu"), Pkg("dingo_tpu_torch")

    def payload(p):
        rm = p.snapshot.RegionMetricsSnapshot(
            region_id=7, key_count=3, vector_count=2, is_leader=True,
            device_memory_bytes=1 << 20, device_degraded=True)
        snap = p.snapshot.StoreMetricsSnapshot(
            store_id="s1", collected_at_ms=123, regions=[rm])
        return ("control", "store_heartbeat", ["s1"],
                {"metrics": snap, "now_ms": 5})

    a, b = ref.persist.dumps(payload(ref)), port.persist.dumps(payload(port))
    assert a == b
    back = port.persist.loads(a)
    assert back[3]["metrics"].region(7).device_degraded is True
    assert ref.persist.loads(b)[3]["metrics"].regions[0].vector_count == 2


# -- region commands ----------------------------------------------------------

def test_every_region_command_executes_on_the_port():
    """execute_region_cmd takes every command type (reference node.py
    :457-522): SNAPSHOT checkpoints under the temp dir, HOLD builds a
    split child's own index, TIER_DEMOTE is acked without action (tiering
    off, as the JAX package's default), STOP/PURGE stop the raft member."""
    p = Pkg("dingo_tpu_torch")
    T = p.control.RegionCmdType
    transport, coord, nodes = p.cluster(n=1, replication=1)
    n = nodes["s0"]
    try:
        d = p.index_region(coord, hi=100)
        wait_for(lambda: n.heartbeat_once() is not None and
                 (rn := n.engine.get_node(d.region_id)) is not None
                 and rn.is_leader(), what="a region leader")
        region = n.get_region(d.region_id)
        x = np.random.default_rng(5).standard_normal((40, 8)).astype(
            np.float32)
        n.storage.vector_add(region, np.arange(40, dtype=np.int64), x)
        cmd = p.control.RegionCmd
        n.execute_region_cmd(cmd(1, d.region_id, T.SNAPSHOT))
        n.execute_region_cmd(cmd(2, d.region_id, T.TIER_DEMOTE))
        n.execute_region_cmd(cmd(3, d.region_id, T.SPLIT,
                                 split_key=p.vcodec.encode_vector_key(0, 20),
                                 child_region_id=900))
        wait_for(lambda: n.get_region(900) is not None, what="the child")
        child = n.get_region(900)
        assert child.vector_index_wrapper.share_index is not None
        n.execute_region_cmd(cmd(4, 900, T.HOLD_VECTOR_INDEX))
        assert child.vector_index_wrapper.share_index is None
        assert child.vector_index_wrapper.own_index.get_count() == 20
        n.execute_region_cmd(cmd(5, 900, T.TRANSFER_LEADER,
                                 target_store_id="s0"))
        n.execute_region_cmd(cmd(6, 900, T.STOP))
        assert n.engine.get_node(900) is None
        n.execute_region_cmd(cmd(7, 900, T.DELETE))
        assert n.get_region(900) is None
        with pytest.raises(p.base.NotPorted):
            n.pull_vector_index_snapshot(d.region_id, "localhost:1")
    finally:
        stop_nodes(nodes)


@pytest.mark.parametrize("pkg", PKGS)
def test_split_and_merge_apply_need_a_node(pkg):
    """apply.py routes SplitRegionData / MergeRegionData to the hosting
    node; without one (a mono engine) both raise NotImplementedError."""
    p = Pkg(pkg)
    definition = p.regm.RegionDefinition(
        region_id=3, start_key=b"a", end_key=b"z")
    region = p.regm.Region(definition, **p.kw)
    eng = p.raw.MemEngine()
    for data in (p.wd.SplitRegionData(child_region_id=4, split_key=b"m"),
                 p.wd.MergeRegionData(source_region_id=4,
                                      source_end_key=b"zz")):
        with pytest.raises(NotImplementedError):
            p.apply.apply_write(eng, region, data, 1)


def test_observability_consumers_raise_not_ported():
    """The coordinator's observability consumers are ported: none raises
    NotPorted any more, and on a fresh coordinator each answers as the
    JAX package's does (no divergence, no event, no live knob)."""
    got = {}
    for name in PKGS:
        coord = Pkg(name).coordinator()
        got[name] = (coord.diverged_regions(), coord.cluster_events(),
                     coord.explain_region_overrides(1))
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]
    assert got["dingo_tpu_torch"][:2] == ([], [])


def _plane_steps(p):
    """The coordinator steps the port leaves out (integrity comparison,
    event timeline) do nothing on the JAX coordinator either when fed the
    port's snapshots: no divergence, no event."""
    transport, coord, nodes = p.cluster()
    try:
        d = p.index_region(coord)
        drive_heartbeats(nodes)
        leader = wait_region_leader(nodes, d.region_id)
        leader.storage.vector_add(
            leader.get_region(d.region_id), np.arange(16, dtype=np.int64),
            np.ones((16, 8), np.float32))
        return [nd.metrics.collect() for nd in nodes.values()]
    finally:
        stop_nodes(nodes)


def test_reference_coordinator_skips_the_left_out_steps_on_port_beats():
    ref = Pkg("dingo_tpu")
    snaps = _plane_steps(Pkg("dingo_tpu_torch"))
    coord = ref.coordinator()
    before = len(coord.cluster_events())
    for snap in snaps:
        blob = Pkg("dingo_tpu_torch").persist.dumps(snap)
        coord.store_heartbeat(snap.store_id, metrics=ref.persist.loads(blob))
    assert coord.diverged_regions() == []
    assert len(coord.cluster_events()) == before
    assert coord.integrity_diverged == {}


# -- the crontab schedules of the two roles -----------------------------------

def test_server_crontab_schedules():
    """The two roles' schedules carry the ported jobs; the store's
    heartbeat and metrics jobs run at once (a region the coordinator
    creates reaches the store), and a tick of every job raises nothing."""
    from dingo_tpu_torch.server.main import coordinator_crontab, store_crontab

    p = Pkg("dingo_tpu_torch")
    transport, coord, nodes = p.cluster(n=1, replication=1)
    kv = p.kvm.KvControl(p.raw.MemEngine())
    n = nodes["s0"]
    d = p.index_region(coord)
    ctab = coordinator_crontab(coord, kv)
    stab = store_crontab(n)
    try:
        assert set(ctab.stats()) == {"update_store_state", "lease_gc",
                                     "balance_leader", "balance_region",
                                     "replica_plan"}
        assert set(stab.stats()) == {"heartbeat", "split_check",
                                     "scrub_vector_index", "ivf_compact",
                                     "store_metrics", "quality_tuner",
                                     "qos_shed", "consistency_scrub",
                                     "memory_tier", "hbm_watermark",
                                     "scan_gc"}
        wait_for(lambda: n.get_region(d.region_id) is not None,
                 what="the heartbeat job delivering CREATE")
        wait_for(lambda: bool(coord.get_store_metrics("s0")),
                 what="a heartbeat with the store's metrics")
    finally:
        ctab.stop()
        stab.stop()
    try:
        for tab in (ctab, stab):
            with tab._lock:
                for t in tab._crontabs.values():
                    t._next_due = 0.0
            assert tab.run_pending() == len(tab.stats())
            assert all(s["errors"] == 0 for s in tab.stats().values()), \
                tab.stats()
    finally:
        stop_nodes(nodes)


def test_compact_views_compacts_a_dirty_ivf_view():
    p = Pkg("dingo_tpu_torch")
    from dingo_tpu_torch.common.config import FLAGS

    transport, coord, nodes = p.cluster(n=1, replication=1)
    n = nodes["s0"]
    try:
        d = p.index_region(coord, index_type="ivf_flat", ncentroids=4,
                           default_nprobe=4)
        wait_for(lambda: n.heartbeat_once() is not None and
                 (rn := n.engine.get_node(d.region_id)) is not None
                 and rn.is_leader(), what="a region leader")
        region = n.get_region(d.region_id)
        x = np.random.default_rng(6).standard_normal((256, 8)).astype(
            np.float32)
        n.storage.vector_add(region, np.arange(256, dtype=np.int64), x)
        raft = n.engine.get_node(d.region_id)
        n.index_manager.rebuild(region, raft_log=raft.log)
        own = region.vector_index_wrapper.own_index
        assert own.is_trained()
        n.storage.vector_batch_search(region, x[:2], 3)   # builds the view
        assert own.view_stats()["built"]
        n.storage.vector_delete(region, list(range(0, 256, 2)))
        assert own.need_compact()
        assert FLAGS.get("ivf_compact_interval_s") == 60.0
        assert n.index_manager.compact_views(n.meta.get_all_regions()) == 1
        assert not own.need_compact()
        assert n.index_manager.compact_views(n.meta.get_all_regions()) == 0
    finally:
        stop_nodes(nodes)


# -- is_switching --------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_is_switching_set_around_the_index_switch(pkg, monkeypatch):
    """The wrapper's is_switching reads True in the final catch-up round
    of a rebuild (the replay under the wrapper lock, right before the
    switch) and False after, in both packages."""
    p = Pkg(pkg)
    transport, coord, nodes = p.cluster(n=1, replication=1)
    n = nodes["s0"]
    try:
        d = p.index_region(coord)
        wait_for(lambda: n.heartbeat_once() is not None and
                 (rn := n.engine.get_node(d.region_id)) is not None
                 and rn.is_leader(), what="a region leader")
        region = n.get_region(d.region_id)
        w = region.vector_index_wrapper
        n.storage.vector_add(region, np.arange(8, dtype=np.int64),
                             np.ones((8, 8), np.float32))
        seen = []
        real = type(n.index_manager).replay_wal

        def spy(self, index, region_, raft_log, start, end):
            seen.append(w.is_switching)
            return real(self, index, region_, raft_log, start, end)

        monkeypatch.setattr(type(n.index_manager), "replay_wal", spy)
        assert w.is_switching is False
        raft = n.engine.get_node(d.region_id)
        n.index_manager.rebuild(region, raft_log=raft.log)
        assert seen and seen[-1] is True
        assert w.is_switching is False
        snap = n.metrics.collect().region(d.region_id)
        assert snap.index_building is False
    finally:
        stop_nodes(nodes)


# -- device bytes read while the raft apply threads write --------------------

def _walk_while_written(read, write, rounds=40):
    """Call `read` `rounds` times while another thread runs `write` in a
    loop, with a short thread switch interval so that the threads change
    places inside a walk; returns what `read` returned and the writer's
    error, if any."""
    import sys
    import threading

    stop, errs, out = threading.Event(), [], []

    def writer():
        try:
            i = 0
            while not stop.is_set():
                write(i)
                i += 1
        except Exception as e:  # noqa: BLE001 — reported by the test
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(rounds):
            out.append(read())
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(interval)
    return out, errs


def test_tensor_bytes_while_a_map_changes_size():
    """The walk copies a dict before it reads it: a map that another
    thread grows and shrinks neither breaks it nor changes the bytes."""
    from dingo_tpu_torch.index.base import tensor_bytes

    class Holder:
        pass

    Holder.__module__ = "dingo_tpu_torch.index.holder"
    h = Holder()
    h.rows = torch.zeros(1000, 8)
    h.slots = {i: i for i in range(100_000)}
    h.views = {0: torch.zeros(16, 4)}
    want = h.rows.nbytes + h.views[0].nbytes

    def write(i):
        k = 100_000 + i % 50_000
        if k in h.slots:
            del h.slots[k]
        else:
            h.slots[k] = k

    got, errs = _walk_while_written(lambda: tensor_bytes(h), write)
    assert not errs
    assert got == [want] * len(got)


def test_device_bytes_of_an_index_under_writes():
    """get_device_memory_size of an IVF_FLAT index, as the metrics
    collector and the smoke read it, while upserts and deletes move its
    id map."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat

    d, n = 16, 20_000
    x = np.random.default_rng(12).standard_normal((n, d)).astype(np.float32)
    idx = TpuIvfFlat(1, IndexParameter(index_type=IndexType.IVF_FLAT,
                                       dimension=d, ncentroids=16),
                     device="cpu")
    idx.upsert(np.arange(n), x)
    idx.train()

    def write(i):
        ids = np.arange(n + 64 * (i % 8), n + 64 * (i % 8 + 1))
        if i % 16 < 8:
            idx.upsert(ids, x[:64])
        else:
            idx.delete(ids)

    got, errs = _walk_while_written(idx.get_device_memory_size, write,
                                    rounds=20)
    assert not errs
    assert all(b > 0 for b in got)
