"""The port's raft layer against the JAX package's: the TLV wire codec and
the typed write payloads give the same bytes for the same trees in both
packages (ndarrays included), the raft log behaves the same, and the
3-node cases of test_raft.py run on the port's RaftNode over its
LocalTransport (every wait has a deadline)."""

import importlib
import pickle
import time

import numpy as np
import pytest
import torch

from dingo_tpu_torch.raft import LocalTransport, NotLeader, RaftNode
from dingo_tpu_torch.raft.core import ProposalFailed
from dingo_tpu_torch.raft.log import RaftLog

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------- wire codec: the same bytes in both packages --------------

CASES = [
    None, True, False, 0, -1, 2**62, -(2**62), 1.5, float("inf"), "",
    "héllo", b"", b"\x00\xff" * 100, [], {},
    [1, "a", b"b", None, [2, 3]],
    {"from": "s1/r7", "term": 3, "entries": [(1, 1, b"x"), (2, 1, b"y")],
     "commit": 2, "ok": True, "blob": b"\x00" * 1000},
]


def _norm(o):
    if isinstance(o, (list, tuple)):
        return [_norm(i) for i in o]
    if isinstance(o, dict):
        return {k: _norm(v) for k, v in o.items()}
    return o


@pytest.mark.parametrize("obj", CASES, ids=range(len(CASES)))
def test_wire_bytes_equal_and_roundtrip(obj):
    jw, tw = mod("dingo_tpu", "raft.wire"), mod("dingo_tpu_torch", "raft.wire")
    blob = tw.encode(obj)
    assert blob == jw.encode(obj)
    assert _norm(tw.decode(blob)) == _norm(obj)
    assert _norm(tw.decode(blob)) == _norm(jw.decode(blob))


def test_wire_obj_ndarrays_byte_equal():
    jw, tw = mod("dingo_tpu", "raft.wire"), mod("dingo_tpu_torch", "raft.wire")
    rng = np.random.default_rng(3)
    tree = {"v": rng.standard_normal((5, 32)).astype(np.float32),
            "ids": np.arange(5, dtype=np.int64), "n": np.int64(4),
            "f": np.float32(0.5), "b": np.bool_(True),
            "nested": [rng.integers(0, 255, (3, 4), dtype=np.uint8)]}
    blob = tw.encode_obj(tree)
    assert blob == jw.encode_obj(tree)
    back = tw.decode_obj(blob)
    assert np.array_equal(back["v"], tree["v"])
    assert back["v"].dtype == np.float32 and back["ids"].dtype == np.int64
    assert np.array_equal(back["nested"][0], tree["nested"][0])
    assert tw.blob_checksum(blob) == jw.blob_checksum(blob)


@pytest.mark.parametrize("bad", [
    b"", b"\x63", b"\x03\x00",
    b"\x05\x00\x00\x00\x00\x00\x00\x00\x09abc",
    b"\x07" + b"\xff" * 8,
    b"\x08\x00\x00\x00\x00\x00\x00\x00\x01" + b"\x03" + b"\x00" * 8 + b"\x00",
])
def test_wire_malformed_rejected(bad):
    tw = mod("dingo_tpu_torch", "raft.wire")
    with pytest.raises(tw.WireError):
        tw.decode(bad)
    with pytest.raises(tw.WireError):
        tw.decode(tw.encode({"a": 1}) + b"x")
    with pytest.raises(tw.WireError):
        tw.encode(object())


def _payloads(pkg):
    wd = mod(pkg, "engine.write_data")
    rng = np.random.default_rng(11)
    v = rng.standard_normal((6, 32)).astype(np.float32)
    return [
        wd.KvPutData(cf="default", ts=7, kvs=[(b"a", b"1"), (b"b", b"2")],
                     ttl_ms=5),
        wd.KvDeleteData(cf="default", ts=8, keys=[b"a"]),
        wd.KvDeleteRangeData(cf="default", ts=9, ranges=[(b"a", b"z")]),
        wd.VectorAddData(ts=10, ids=np.arange(6, dtype=np.int64), vectors=v,
                         scalars=[{"c": i, "s": "x"} for i in range(6)],
                         is_update=False, ttl_ms=0,
                         table_values=[b"t"] * 6),
        wd.VectorAddData(ts=11, ids=np.arange(6, 12, dtype=np.int64),
                         vectors=v),
        wd.VectorDeleteData(ts=12, ids=np.asarray([1, 3], np.int64)),
        wd.RegionInstallData(cfs={"default": [(b"k", b"v")]}),
    ]


@pytest.mark.parametrize("i", range(7))
def test_encode_write_bytes_equal(i):
    jw = mod("dingo_tpu", "engine.write_data")
    tw = mod("dingo_tpu_torch", "engine.write_data")
    jp, tp = _payloads("dingo_tpu")[i], _payloads("dingo_tpu_torch")[i]
    blob = tw.encode_write(tp)
    assert blob == jw.encode_write(jp)
    back = tw.decode_write(jw.encode_write(jp))
    assert type(back).__name__ == type(jp).__name__
    assert tw.encode_write(back) == blob


# ---------------- raft log: both packages ----------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_log_persistence_and_recovery(pkg, tmp_path):
    Log = mod(pkg, "raft.log").RaftLog
    log = Log(str(tmp_path / "raft.log"))
    i1 = log.append(1, b"a")
    log.append(1, b"b")
    log.append(2, b"c")
    log.close()
    log2 = Log(str(tmp_path / "raft.log"))
    assert log2.last_index() == 3
    assert log2.entry_at(i1) == (1, b"a")
    assert log2.term_at(3) == 2
    log2.compact(2)
    assert log2.first_index == 3
    log2.close()
    log3 = Log(str(tmp_path / "raft.log"))
    assert log3.snapshot_index == 2
    assert log3.entry_at(3) == (2, b"c")
    log3.close()


def test_log_file_bytes_equal(tmp_path):
    """A log file written by either package has the same bytes and
    recovers in the other."""
    paths = {}
    for pkg in PKGS:
        log = mod(pkg, "raft.log").RaftLog(str(tmp_path / f"{pkg}.log"))
        log.set_hard_state(3, "n1")
        for i in range(6):
            log.append(1 + i // 3, f"p{i}".encode())
        log.compact(2)
        log.close()
        paths[pkg] = tmp_path / f"{pkg}.log"
    assert paths["dingo_tpu"].read_bytes() == \
        paths["dingo_tpu_torch"].read_bytes()
    log = RaftLog(str(paths["dingo_tpu"]))
    assert log.hard_state() == (3, "n1")
    assert [i for i, _, _ in log.get_data_entries(1, 6)] == [3, 4, 5, 6]
    log.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_hard_state_and_bounds(pkg, tmp_path):
    Log = mod(pkg, "raft.log").RaftLog
    log = Log(str(tmp_path / "r.log"))
    log.set_hard_state(5, "n2")
    log.close()
    log2 = Log(str(tmp_path / "r.log"))
    assert log2.hard_state() == (5, "n2")
    log2.close()
    log = Log()
    for i in range(10):
        log.append(1, f"p{i}".encode())
    log.compact(2)
    assert [i for i, _, _ in log.get_data_entries(1, 5)] == [3, 4, 5]
    assert log.get_data_entries(1, 1) == []


@pytest.mark.parametrize("pkg", PKGS)
def test_log_torn_tail_then_append(pkg, tmp_path):
    Log = mod(pkg, "raft.log").RaftLog
    log = Log(str(tmp_path / "r.log"))
    for i in range(5):
        log.append(1, f"p{i}".encode())
    log.close()
    p = tmp_path / "r.log"
    p.write_bytes(p.read_bytes()[:-3])
    log2 = Log(str(p))
    assert log2.last_index() == 4
    log2.append(1, b"after")
    log2.close()
    log3 = Log(str(p))
    assert log3.last_index() == 5 and log3.entry_at(5)[1] == b"after"
    log3.close()


# ---------------- 3-node groups on the port (test_raft.py) -----------------

def make_cluster(n=3, transport=None, applied=None, **kw):
    transport = transport or LocalTransport()
    applied = applied if applied is not None else {}
    nodes = {}
    for i in range(n):
        nid = f"n{i}"
        applied.setdefault(nid, [])

        def apply_fn(index, payload, nid=nid):
            applied[nid].append((index, payload))

        nodes[nid] = RaftNode(nid, [f"n{j}" for j in range(n)], transport,
                              apply_fn=apply_fn, seed=i, **kw)
    for node in nodes.values():
        node.start()
    return transport, nodes, applied


def wait_leader(nodes, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [n for n in nodes.values() if n.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.02)
    raise AssertionError("no unique leader elected")


def wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def stop_all(nodes):
    for n in nodes.values():
        n.stop()


def test_election_and_replication():
    _, nodes, applied = make_cluster()
    try:
        leader = wait_leader(nodes)
        for i in range(5):
            leader.propose(f"cmd{i}".encode())
        want = [f"cmd{i}".encode() for i in range(5)]
        assert wait_for(lambda: all([p for _, p in log] == want
                                    for log in applied.values()))
    finally:
        stop_all(nodes)


def test_propose_on_follower_raises():
    _, nodes, _ = make_cluster()
    try:
        wait_leader(nodes)
        follower = next(n for n in nodes.values() if not n.is_leader())
        with pytest.raises(NotLeader):
            follower.propose(b"x")
    finally:
        stop_all(nodes)


def test_leader_failover_and_rejoin():
    transport, nodes, applied = make_cluster()
    try:
        leader = wait_leader(nodes)
        leader.propose(b"before")
        old_id = leader.id
        for other in nodes:
            if other != old_id:
                transport.partition(old_id, other)
        survivors = {k: v for k, v in nodes.items() if k != old_id}
        new_leader = wait_leader(survivors, timeout=5)
        assert new_leader.id != old_id
        new_leader.propose(b"after")
        transport.heal()
        assert wait_for(lambda: [p for _, p in applied[old_id]]
                        == [b"before", b"after"])
        assert not nodes[old_id].is_leader()
    finally:
        stop_all(nodes)


def test_snapshot_install_for_lagging_follower():
    transport = LocalTransport()
    state = {f"n{i}": [] for i in range(3)}

    def mk(nid):
        def apply_fn(index, payload):
            state[nid].append(payload)

        def save():
            return pickle.dumps(state[nid])

        def install(blob):
            state[nid][:] = pickle.loads(blob)

        return RaftNode(nid, ["n0", "n1", "n2"], transport,
                        apply_fn=apply_fn, snapshot_save_fn=save,
                        snapshot_install_fn=install, snapshot_threshold=5,
                        seed=int(nid[1]))

    nodes = {f"n{i}": mk(f"n{i}") for i in range(3)}
    for n in nodes.values():
        n.start()
    try:
        leader = wait_leader(nodes)
        lagger = next(k for k in nodes if k != leader.id)
        for other in nodes:
            if other != lagger:
                transport.partition(lagger, other)
        for i in range(20):   # exceeds snapshot_threshold: the log compacts
            leader.propose(f"v{i}".encode())
        assert wait_for(lambda: leader.log.snapshot_index > 0)
        transport.heal()
        want = [f"v{i}".encode() for i in range(20)]
        assert wait_for(lambda: state[lagger] == want)
    finally:
        stop_all(nodes)


def test_no_commit_without_quorum():
    transport, nodes, _ = make_cluster()
    try:
        leader = wait_leader(nodes)
        for other in nodes:
            if other != leader.id:
                transport.partition(leader.id, other)
        with pytest.raises(ProposalFailed):
            leader.propose(b"lost", timeout=0.5)
    finally:
        stop_all(nodes)


def test_new_leader_applies_entry_acknowledged_by_old_leader():
    """An entry the old leader committed, applied and acknowledged, whose
    commit index never reached the followers before the old leader was cut
    off, is applied on the new leader and its follower at once: the new
    leader commits a no-op of its term (the port departs from the JAX
    package here, whose new leader applies it only with the next proposal)
    and apply_fn never sees the no-op."""
    transport = LocalTransport()
    applied = {}
    cut = {}

    def on_apply(nid, payload):
        if payload == b"acked" and nid == cut.get("leader"):
            # the old leader's apply of the acknowledged entry: cut it off
            # before a heartbeat can carry the commit index to anyone
            for other in applied:
                if other != nid:
                    transport.partition(nid, other)

    nodes = {}
    for i in range(3):
        nid = f"n{i}"
        applied[nid] = []

        def apply_fn(index, payload, nid=nid):
            applied[nid].append(payload)
            on_apply(nid, payload)

        nodes[nid] = RaftNode(nid, ["n0", "n1", "n2"], transport,
                              apply_fn=apply_fn, seed=i,
                              election_timeout=(0.6, 1.0),
                              heartbeat_interval=0.3)
    for n in nodes.values():
        n.start()
    try:
        leader = wait_leader(nodes)
        leader.propose(b"first")
        assert wait_for(lambda: all(a == [b"first"]
                                    for a in applied.values()))
        cut["leader"] = leader.id
        leader.propose(b"acked")
        survivors = {k: v for k, v in nodes.items() if k != leader.id}
        assert all(applied[k] == [b"first"] for k in survivors)
        new_leader = wait_leader(survivors, timeout=10.0)
        assert new_leader.id != leader.id
        assert wait_for(lambda: all(applied[k] == [b"first", b"acked"]
                                    for k in survivors), 5.0), applied
        last = new_leader.log.last_index()
        assert new_leader.log.entry_at(last)[1] == b""
        assert wait_for(lambda: new_leader.last_applied == last)
    finally:
        stop_all(nodes)


def test_check_quorum_deposes_partitioned_leader():
    transport, nodes, _ = make_cluster(election_timeout=(0.1, 0.2),
                                       heartbeat_interval=0.03)
    try:
        leader = wait_leader(nodes)
        for p in nodes:
            if p != leader.id:
                transport.partition(leader.id, p)
        assert wait_for(lambda: not leader.is_leader(), 3.0)
        assert wait_for(lambda: any(n is not leader and n.is_leader()
                                    for n in nodes.values()), 3.0)
        transport.heal()
        assert wait_for(lambda: not leader.is_leader(), 3.0)
    finally:
        stop_all(nodes)


def test_failpoint_fires_at_raft_propose():
    """The port's failpoint registry reaches raft/core.py's propose site
    and counts into the port's metrics registry."""
    from dingo_tpu_torch.common.failpoint import (
        FAILPOINTS,
        FailPointInjectedError,
    )
    from dingo_tpu_torch.common.metrics import METRICS

    _, nodes, applied = make_cluster()
    fired = METRICS.counter("fault.injected",
                            labels={"point": "before_raft_propose"})
    fired0 = fired.get()
    try:
        leader = wait_leader(nodes)
        with FAILPOINTS.scoped("before_raft_propose", "100%1*error(30001)"):
            with pytest.raises(FailPointInjectedError) as err:
                leader.propose(b"a")
            assert err.value.errcode == 30001
            leader.propose(b"b")            # the count of 1 is spent
        assert fired.get() == fired0 + 1
        assert wait_for(lambda: all([p for _, p in log] == [b"b"]
                                    for log in applied.values()))
    finally:
        stop_all(nodes)
