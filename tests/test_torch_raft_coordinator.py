"""The raft-replicated coordinator of the port (coordinator/raft_meta.py)
against the JAX package's: the cases of test_raft_coordinator.py, each
driven through both packages with the same coordinator calls —
replicated mutations on all replicas, NotLeader routing, TSO
monotonicity across failover, a leader crash mid-split completed by a
survivor, exactly-once replay after restart, snapshot-install catch-up,
replicated meta and KV, and the nack/stall re-arming of commands.

Held equal between the packages: region definitions, the commands issued
(with their retries and final status), auto-increment values and KV
revisions. TSO values are held monotonic across the failover, not equal.
Every wait has a deadline.
"""

import dataclasses
import time

import pytest
import torch

from torch_cluster_util import PKGS, Pkg, cmd_view, region_view

torch.set_num_threads(1)

FAST = dict(election_timeout=(0.05, 0.12), heartbeat_interval=0.02)


def both(scenario, *args):
    return [scenario(Pkg(name), *args) for name in PKGS]


def make_cluster(p, n=3, transport=None, **raft_kw):
    transport = transport or p.raft.LocalTransport()
    ids = [f"coor{i}" for i in range(n)]
    coords = [p.raft_meta.RaftMetaCoordinator(
        ids[i], ids, transport, p.raw.MemEngine(), **{**FAST, **raft_kw})
        for i in range(n)]
    for c in coords:
        c.start()
    return transport, coords


def wait_leader(coords, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [c for c in coords if c.is_leader()]
        if leaders:
            return leaders[0]
        time.sleep(0.01)
    raise AssertionError("no coordinator leader elected")


def wait_converged(coords, fn, expect, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(fn(c) == expect for c in coords):
            return
        time.sleep(0.01)
    got = [fn(c) for c in coords]
    raise AssertionError(f"replicas did not converge: {got} != {expect}")


def stop_all(coords):
    for c in coords:
        try:
            c.stop()
        except Exception:  # noqa: BLE001 — already stopped
            pass


def _create_visible(p):
    _, coords = make_cluster(p)
    try:
        leader = wait_leader(coords)
        for sid in ("s1", "s2", "s3"):
            leader.control.register_store(sid, f"addr-{sid}")
        definition = leader.control.create_region(b"a", b"m")
        rid = definition.region_id
        wait_converged(coords, lambda c: rid in c.sm.control.regions, True)
        views = []
        for c in coords:
            assert c.sm.control.regions[rid].peers == definition.peers
            queued = [cmd.cmd_id for q in c.sm.control.store_ops.values()
                      for cmd in q if cmd.region_id == rid]
            assert len(queued) == 3
            views.append((region_view(c.sm.control), cmd_view(c.sm.control)))
        assert all(v == views[0] for v in views)
        return views[0]
    finally:
        stop_all(coords)


def test_replicated_create_region_visible_on_all_replicas():
    ref, port = both(_create_visible)
    assert port == ref


def _not_leader(p):
    _, coords = make_cluster(p)
    try:
        leader = wait_leader(coords)
        follower = next(c for c in coords if c is not leader)
        deadline = time.monotonic() + 3
        while follower.leader_hint() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(p.rcore.NotLeader) as exc:
            follower.control.register_store("s9")
        assert exc.value.leader_hint == leader.node.id
        return "s9" in leader.sm.control.stores
    finally:
        stop_all(coords)


def test_follower_mutation_raises_not_leader_with_hint():
    ref, port = both(_not_leader)
    assert port == ref is False


def _tso_failover(p):
    _, coords = make_cluster(p)
    try:
        leader = wait_leader(coords)
        issued = []
        for _ in range(5):
            first, count = leader.tso.gen_ts(100)
            issued.append(first + count - 1)
        assert issued == sorted(issued)
        leader.stop()
        survivors = [c for c in coords if c is not leader]
        new_leader = wait_leader(survivors)
        first, count = new_leader.tso.gen_ts(1)
        assert first > issued[-1], (
            f"TSO regressed after failover: {first} <= {issued[-1]}")
        return issued[-1], first
    finally:
        stop_all(coords)


def test_tso_never_regresses_across_failover():
    ref, port = both(_tso_failover)
    for last, after in (ref, port):
        assert after > last


def _crash_mid_split(p):
    _, coords = make_cluster(p)
    try:
        leader = wait_leader(coords)
        for sid in ("s1", "s2", "s3"):
            leader.control.register_store(sid)
        definition = leader.control.create_region(b"a", b"z")
        rid = definition.region_id
        for sid in ("s1", "s2", "s3"):
            leader.control.store_heartbeat(sid, region_ids=[rid])
        leader.control.store_heartbeat("s1", region_ids=[rid],
                                       leader_region_ids=[rid])
        child_id = leader.control.split_region(rid, b"m")
        sent = leader.control.store_heartbeat("s1", region_ids=[rid],
                                              leader_region_ids=[rid])
        assert any(c.cmd_type.value == "split" for c in sent)
        leader.stop()
        survivors = [c for c in coords if c is not leader]
        new_leader = wait_leader(survivors)
        deadline = time.monotonic() + 5
        redelivered = []
        while time.monotonic() < deadline and not redelivered:
            redelivered = [
                c for c in new_leader.control.store_heartbeat(
                    "s1", region_ids=[rid], leader_region_ids=[rid])
                if c.cmd_type.value == "split"
            ]
            time.sleep(0.02)
        assert redelivered, "survivor never re-delivered the split cmd"
        assert redelivered[0].child_region_id == child_id
        child_def = dataclasses.replace(
            definition, region_id=child_id, start_key=b"m", end_key=b"z")
        new_leader.control.on_region_split_done(rid, child_def)
        wait_converged(survivors,
                       lambda c: child_id in c.sm.control.regions, True)
        assert new_leader.sm.control.regions[rid].end_key == b"m"
        return (region_view(new_leader.sm.control),
                cmd_view(new_leader.sm.control))
    finally:
        stop_all(coords)


def test_leader_crash_mid_split_survivor_completes():
    ref, port = both(_crash_mid_split)
    assert port == ref


def _restart_replay(p, tmp_path):
    root = tmp_path / p.name
    root.mkdir()
    transport = p.raft.LocalTransport()
    engine = p.raw.MemEngine()
    c = p.raft_meta.RaftMetaCoordinator(
        "coor0", ["coor0"], transport, engine,
        log=p.rlog.RaftLog(str(root / "meta.log")), **FAST)
    c.start()
    try:
        leader = wait_leader([c])
        leader.control.register_store("s1")
        r1 = leader.control.create_region(b"a", b"b", replication=1)
        r2 = leader.control.create_region(b"b", b"c", replication=1)
        next_id = leader.sm.control._next_region_id
    finally:
        c.stop()
    c2 = p.raft_meta.RaftMetaCoordinator(
        "coor0", ["coor0"], transport, engine,
        log=p.rlog.RaftLog(str(root / "meta.log")), **FAST)
    c2.start()
    try:
        leader = wait_leader([c2])
        assert set(leader.sm.control.regions) == {r1.region_id, r2.region_id}
        assert leader.sm.control._next_region_id == next_id
        r3 = leader.control.create_region(b"c", b"d", replication=1)
        assert r3.region_id == next_id
        return region_view(leader.sm.control), cmd_view(leader.sm.control)
    finally:
        c2.stop()


def test_restart_replays_exactly_once(tmp_path):
    ref, port = both(_restart_replay, tmp_path)
    assert port == ref


def _snapshot_install(p):
    transport = p.raft.LocalTransport()
    _, coords = make_cluster(p, transport=transport, snapshot_threshold=10)
    try:
        leader = wait_leader(coords)
        lagger = next(c for c in coords if c is not leader)
        for other in coords:
            if other is not lagger:
                transport.partition(other.node.id, lagger.node.id)
        leader.control.register_store("s1")
        for _ in range(25):
            leader.auto_incr.generate(7, 10)
        transport.heal()
        wait_converged(coords, lambda c: c.sm.auto_incr.get(7), 251,
                       timeout=8.0)
        return lagger.sm.auto_incr.get(7), sorted(lagger.sm.control.stores)
    finally:
        stop_all(coords)


def test_lagging_follower_catches_up_via_snapshot_install():
    ref, port = both(_snapshot_install)
    assert port == ref


def _meta_and_kv(p):
    _, coords = make_cluster(p)
    try:
        leader = wait_leader(coords)
        r1 = leader.kv.kv_put(b"cfg/a", b"1")
        rev = leader.kv.kv_put(b"cfg/a", b"2")
        leader.meta.create_schema("analytics")
        wait_converged(
            coords, lambda c: c.sm.kv.kv_range(b"cfg/a")[0][0].value, b"2")
        wait_converged(
            coords, lambda c: "analytics" in c.sm.meta.get_schemas(), True)
        assert rev >= 2
        return r1, rev, leader.sm.meta.get_schemas(), \
            leader.sm.meta.meta_revision
    finally:
        stop_all(coords)


def test_meta_and_kv_replicate():
    ref, port = both(_meta_and_kv)
    assert port == ref


def _nack_rearm(p):
    _, coords = make_cluster(p)
    try:
        leader = wait_leader(coords)
        leader.control.register_store("s1")
        leader.control.create_region(b"a", b"z", replication=1)
        cmds = leader.control.store_heartbeat("s1")
        assert [c.cmd_id for c in cmds]
        cmd_id = cmds[0].cmd_id

        def sm_cmd():
            return next(c for c in leader.sm.control.store_ops["s1"]
                        if c.cmd_id == cmd_id)

        assert sm_cmd().status == "sent"
        leader.control.store_heartbeat("s1", stalled_cmd_ids=[cmd_id])
        assert sm_cmd().retries == 0
        leader.control.store_heartbeat("s1", failed_cmd_ids=[cmd_id])
        assert sm_cmd().retries == 1
        for _ in range(5):
            leader.control.store_heartbeat("s1", failed_cmd_ids=[cmd_id])
        assert all(c.cmd_id != cmd_id
                   for c in leader.sm.control.store_ops["s1"])
        job = next(j for j in leader.sm.control.jobs if j.cmd_id == cmd_id)
        assert job.status.startswith("error")
        time.sleep(0.5)
        for c in coords:
            j = next(j for j in c.sm.control.jobs if j.cmd_id == cmd_id)
            assert j.status.startswith("error"), c.node.id
        return [(j.cmd_id, j.status, j.retries)
                for j in leader.sm.control.jobs]
    finally:
        stop_all(coords)


def test_nack_rearms_failed_cmds_without_touching_leader_state():
    ref, port = both(_nack_rearm)
    assert port == ref
