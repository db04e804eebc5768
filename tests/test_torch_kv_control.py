"""The port's revisioned KV (coordinator/kv_control.py), MetaControl
(coordinator/meta.py) and coordinator state carried across packages,
against the JAX package's: the eleven non-RPC cases of
test_kv_revisions.py (version chains, as-of reads, compaction, watch
replay, future-revision errors, restart recovery over a WalEngine), each
driven through both packages with revisions held equal as exact values;
MetaControl's schema and table CRUD, its persistence across a restart and
its meta watch, called directly; and the coordinator's controls
recovering from a meta column family the other package persisted, both
ways (coordinator/carry.py).
"""

import pytest
import torch

from torch_cluster_util import PKGS, Pkg, cmd_view, region_view

torch.set_num_threads(1)


def both(scenario, *args):
    return [scenario(Pkg(name), *args) for name in PKGS]


def kv_of(p):
    return p.kvm.KvControl(p.raw.MemEngine())


def chain(kv):
    """The whole revision state: current and compacted revisions, every
    key's version chain."""
    return (kv._revision, kv._compact_revision,
            {k: [(i.value, i.create_revision, i.mod_revision, i.version)
                 for i in c] for k, c in sorted(kv._history.items())})


def _version_chain(p):
    kv = kv_of(p)
    r1 = kv.kv_put(b"k", b"v1")
    r2 = kv.kv_put(b"k", b"v2")
    kv.kv_delete_range(b"k")
    r4 = kv.kv_put(b"k", b"v4")
    items, _ = kv.kv_range(b"k")
    assert items[0].value == b"v4" and items[0].version == 1
    assert kv.kv_range(b"k", revision=r1)[0][0].value == b"v1"
    assert kv.kv_range(b"k", revision=r2)[0][0].value == b"v2"
    assert kv.kv_range(b"k", revision=r4 - 1)[0] == []
    assert kv.kv_range(b"k", revision=r4)[0][0].value == b"v4"
    return (r1, r2, r4), chain(kv)


def test_version_chain_and_as_of_reads():
    ref, port = both(_version_chain)
    assert port == ref


def _as_of_scan(p):
    kv = kv_of(p)
    kv.kv_put(b"a", b"1")
    rev = kv.kv_put(b"b", b"2")
    kv.kv_put(b"c", b"3")
    kv.kv_delete_range(b"a")
    items, cur = kv.kv_range(b"a", b"z", revision=rev)
    got = [(i.key, i.value) for i in items]
    assert got == [(b"a", b"1"), (b"b", b"2")]
    return rev, cur, got


def test_as_of_range_scan():
    ref, port = both(_as_of_scan)
    assert port == ref


def _compaction_base(p):
    kv = kv_of(p)
    kv.kv_put(b"k", b"v1")
    r2 = kv.kv_put(b"k", b"v2")
    r3 = kv.kv_put(b"k", b"v3")
    removed = kv.kv_compaction(r2)
    assert removed == 1
    assert kv.kv_range(b"k", revision=r2)[0][0].value == b"v2"
    with pytest.raises(p.kvm.CompactedError):
        kv.kv_range(b"k", revision=r2 - 1)
    assert kv.kv_range(b"k", revision=r3)[0][0].value == b"v3"
    return removed, chain(kv)


def test_compaction_drops_history_keeps_base():
    ref, port = both(_compaction_base)
    assert port == ref


def _compaction_dead(p):
    kv = kv_of(p)
    kv.kv_put(b"gone", b"x")
    kv.kv_delete_range(b"gone")
    cur = kv.kv_put(b"live", b"y")
    removed = kv.kv_compaction(cur)
    assert removed == 2
    assert kv.kv_range(b"gone")[0] == []
    assert kv.kv_range(b"live")[0][0].value == b"y"
    return removed, chain(kv)


def test_compaction_drops_dead_keys_entirely():
    ref, port = both(_compaction_dead)
    assert port == ref


def _watch_history(p):
    kv = kv_of(p)
    r1 = kv.kv_put(b"w", b"v1")
    kv.kv_put(b"w", b"v2")
    got = []
    kv.watch(b"w", r1, lambda e, i: got.append((e, i.value, i.mod_revision)))
    assert [g[:2] for g in got] == [("put", b"v1")]
    kv.watch(b"w", r1 + 1,
             lambda e, i: got.append((e, i.value, i.mod_revision)))
    assert [g[:2] for g in got[1:]] == [("put", b"v2")]
    return got


def test_watch_replays_history():
    ref, port = both(_watch_history)
    assert port == ref


def _watch_tombstone(p):
    kv = kv_of(p)
    kv.kv_put(b"w", b"v1")
    r2 = kv.kv_put(b"w", b"v2")
    kv.kv_delete_range(b"w")
    got = []
    kv.watch(b"w", r2 + 1, lambda e, i: got.append((e, i.mod_revision)))
    assert [g[0] for g in got] == ["delete"]
    return got


def test_watch_replays_tombstone():
    ref, port = both(_watch_tombstone)
    assert port == ref


def _watch_future(p):
    kv = kv_of(p)
    got = []
    kv.watch(b"f", kv._revision + 1,
             lambda e, i: got.append((e, i.value, i.mod_revision)))
    kv.kv_put(b"f", b"x")
    kv.kv_put(b"f", b"y")
    assert [g[:2] for g in got] == [("put", b"x")]
    return got


def test_watch_future_fires_once():
    ref, port = both(_watch_future)
    assert port == ref


def _future_rev(p):
    kv = kv_of(p)
    kv.kv_put(b"k", b"v1")
    with pytest.raises(p.kvm.FutureRevError):
        kv.kv_range(b"k", revision=kv._revision + 100)
    return kv._revision


def test_future_revision_read_errors():
    ref, port = both(_future_rev)
    assert port == ref


def _legacy_seed(p, tmp_path):
    path = str(tmp_path / p.name / "kv")
    eng = p.raw.WalEngine(path)
    legacy = p.kvm.KvItem(key=b"old", value=b"v1", create_revision=2,
                          mod_revision=2, version=1)
    eng.put(p.raw.CF_META, b"VKV_" + b"old", p.persist.dumps(legacy))
    eng.put(p.raw.CF_META, b"VKVREV__", p.persist.dumps(2))
    eng.close()
    eng = p.raw.WalEngine(path)
    kv = p.kvm.KvControl(eng)
    rev = kv.kv_put(b"old", b"v2")
    eng.close()
    eng = p.raw.WalEngine(path)
    kv2 = p.kvm.KvControl(eng)
    items, _ = kv2.kv_range(b"old", revision=2)
    assert items and items[0].value == b"v1"
    out = rev, chain(kv2)
    eng.close()
    return out


def test_legacy_seed_survives_two_restarts(tmp_path):
    ref, port = both(_legacy_seed, tmp_path)
    assert port == ref


def _watch_below_floor(p):
    kv = kv_of(p)
    kv.kv_put(b"k", b"v1")
    kv.kv_put(b"k", b"v2")
    cur = kv.kv_put(b"other", b"z")
    kv.kv_compaction(cur)
    with pytest.raises(p.kvm.CompactedError):
        kv.watch(b"k", 2, lambda e, i: None)
    return chain(kv)


def test_watch_below_compaction_floor_errors():
    ref, port = both(_watch_below_floor)
    assert port == ref


def _history_restart(p, tmp_path):
    path = str(tmp_path / p.name / "kv")
    eng = p.raw.WalEngine(path)
    kv = p.kvm.KvControl(eng)
    r1 = kv.kv_put(b"k", b"v1")
    r2 = kv.kv_put(b"k", b"v2")
    kv.kv_compaction(r1)
    eng.close()
    eng2 = p.raw.WalEngine(path)
    kv2 = p.kvm.KvControl(eng2)
    assert kv2.kv_range(b"k", revision=r1)[0][0].value == b"v1"
    assert kv2.kv_range(b"k", revision=r2)[0][0].value == b"v2"
    assert kv2._compact_revision == r1
    got = []
    kv2.watch(b"k", r2, lambda e, i: got.append(i.value))
    assert got == [b"v2"]
    out = chain(kv2)
    eng2.close()
    return out


def test_history_survives_restart(tmp_path):
    ref, port = both(_history_restart, tmp_path)
    assert port == ref


# -- MetaControl ---------------------------------------------------------------

def _meta_crud(p):
    eng = p.raw.MemEngine()
    coord = p.coordinator(replication=1, engine=eng)
    coord.register_store("s1", now_ms=1)
    meta = p.meta.MetaControl(eng, coord)
    events = []
    meta.watch(meta.meta_revision + 1, events.append)
    meta.create_schema("analytics")
    with pytest.raises(p.meta.MetaExistsError):
        meta.create_schema("analytics")
    part = [p.meta.PartitionDefinition(partition_id=9, id_lo=0, id_hi=1000),
            p.meta.PartitionDefinition(partition_id=9, id_lo=1000,
                                       id_hi=2000)]
    t = meta.create_table(
        "analytics", "docs", part,
        columns=[p.meta.ColumnDefinition("id", "BIGINT", primary=True)],
        index_parameter=p.index_param("flat", dim=16))
    with pytest.raises(p.meta.MetaExistsError):
        meta.create_table("analytics", "docs", part)
    with pytest.raises(p.meta.MetaError):
        meta.drop_schema("analytics")          # not empty
    kv_t = meta.create_table("dingo", "kv", [p.meta.PartitionDefinition(
        partition_id=0, start_key=b"a", end_key=b"m")])
    replay = []
    meta.watch(2, replay.append)              # the ring still covers 2
    state = {"schemas": meta.get_schemas(), "tables": sorted(meta.tables),
             "table": (t.table_id, [q.region_id for q in t.partitions],
                       t.table_type.value),
             "kv_table": (kv_t.table_id, kv_t.table_type.value),
             "events": list(events), "replay": list(replay),
             "regions": region_view(coord), "cmds": cmd_view(coord)}
    # restart: the table ids, definitions and revision survive, the event
    # ring does not (a watcher from before gets a resync)
    meta2 = p.meta.MetaControl(eng, p.coordinator(replication=1, engine=eng))
    t2 = meta2.get_table("analytics", "docs")
    assert t2 is not None and t2.partitions == t.partitions
    resync = []
    meta2.watch(2, resync.append)
    assert resync[0]["event"] == "resync"
    state["after_restart"] = (meta2.get_schemas(),
                              [x.name for x in meta2.get_tables("dingo")],
                              meta2.meta_revision, meta2._next_table_id)
    meta2.drop_table("analytics", "docs")
    meta2.drop_schema("analytics")
    state["dropped"] = (meta2.get_schemas(), meta2.meta_revision,
                        cmd_view(meta2.control))
    return state


def test_meta_control_crud_persistence_and_watch():
    ref, port = both(_meta_crud)
    assert port == ref
    assert port["events"][0]["event"] == "create_schema"
    assert [e["event"] for e in port["replay"]] == ["create_schema"]
    assert port["dropped"][0] == ["dingo", "meta", "root"]


# -- state carried across ------------------------------------------------------

def _coordinator_state(p, engine):
    """Drive every control of a coordinator over `engine`; returns the
    state a recovered coordinator must show."""
    coord = p.coordinator(engine=engine)
    for sid in ("s0", "s1", "s2"):
        coord.register_store(sid, f"addr-{sid}", now_ms=1000)
    d = p.index_region(coord, hi=4096)
    coord.store_heartbeat("s0", region_ids=[d.region_id],
                          leader_region_ids=[d.region_id], now_ms=2000)
    child = coord.split_region(d.region_id,
                               p.vcodec.encode_vector_key(0, 2048))
    tso = p.tso.TsoControl(engine)
    ts, _ = tso.gen_ts(10)
    kv = p.kvm.KvControl(engine)
    kv.kv_put(b"cfg/a", b"1")
    kv.kv_put(b"cfg/a", b"2")
    kv.lease_grant(60, now_ms=3000)
    ai = p.ai.AutoIncrementControl(engine)
    ai.generate(5, 100)
    meta = p.meta.MetaControl(engine, coord)
    meta.create_schema("carry")
    return ts, child


def _recovered(ctl):
    """What a recovered set of controls shows (package-neutral)."""
    c = ctl.control
    return {
        "regions": region_view(c), "stores": sorted(c.stores),
        "ids": (c._next_region_id, c._next_cmd_id),
        "ops": {s: [(x.cmd_id, x.cmd_type.value, x.status, x.split_key,
                     x.child_region_id) for x in q]
                for s, q in sorted(c.store_ops.items())},
        "leaders": dict(c.region_leaders),
        "kv": chain(ctl.kv), "leases": sorted(ctl.kv._leases),
        "ai": ctl.auto_incr.get(5),
        "schemas": ctl.meta.get_schemas(),
        "meta_rev": ctl.meta.meta_revision,
    }


def _jax_controls(p, engine):
    class Ctl:
        pass

    ctl = Ctl()
    ctl.control = p.coordinator(engine=engine)
    ctl.tso = p.tso.TsoControl(engine)
    ctl.kv = p.kvm.KvControl(engine)
    ctl.auto_incr = p.ai.AutoIncrementControl(engine)
    ctl.meta = p.meta.MetaControl(engine, ctl.control)
    return ctl


def test_coordinator_state_carries_across_both_ways():
    from dingo_tpu_torch.coordinator.carry import controls_from_reference

    ref, port = Pkg("dingo_tpu"), Pkg("dingo_tpu_torch")
    # JAX package -> port
    jeng = ref.raw.MemEngine()
    ts, child = _coordinator_state(ref, jeng)
    jstate = jeng.snapshot_state()
    ctl = controls_from_reference(jstate)
    want = _recovered(_jax_controls(ref, jeng))
    assert _recovered(ctl) == want
    assert child in ctl.control.regions or any(
        c.child_region_id == child for q in ctl.control.store_ops.values()
        for c in q)
    assert ctl.tso.gen_ts(1)[0] > ts
    # the port persists the same bytes for the same calls
    peng = port.raw.MemEngine()
    _coordinator_state(port, peng)
    pstate = peng.snapshot_state()
    volatile = (b"TSO_HIGH_WATER",)   # the wall clock's watermark
    strip = [(k, v) for k, v in pstate[port.raw.CF_META]
             if k not in volatile]
    assert strip == [(k, v) for k, v in jstate[ref.raw.CF_META]
                     if k not in volatile]
    # port -> JAX package
    back = ref.raw.MemEngine()
    back.load_state(pstate)
    assert _recovered(_jax_controls(ref, back)) == _recovered(
        controls_from_reference(pstate))
    # the port keeps issuing where the JAX package left off
    c2 = ctl.control
    nxt = c2.create_region(b"x", b"y")
    assert nxt.region_id == want["ids"][0]
