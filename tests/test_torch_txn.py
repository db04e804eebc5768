"""Percolator transactions of the port against the JAX package's
(engine/txn.py, engine/concurrency.py, engine/gc.py and the TxnRaftData
apply).

A seeded script of transaction operations goes through both packages'
TxnEngine, on a MonoStoreEngine and on a 3-replica raft region, with both
modules' clocks held at the same instants (monkeypatch), so a lock's
create_ms and its TTL expiry agree. After it the data, lock and write CFs
of every engine are equal byte for byte across the packages, and every
operation had the same outcome: the same return value, or the same
exception type with equal fields (``KeyIsLocked.key`` and ``.lock``,
``WriteConflict.key`` and ``.conflict_ts``). Then test_txn.py's in-process
cases, a small concurrent-transfer stress run (no lost update, no
deadlock: every thread joins within its timeout) and test_document_region
_gc.py's safe-point case run through the port.
"""

import dataclasses
import enum
import importlib
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from test_torch_coprocessor import port_cases, port_on_cpu

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
SIDS = ["s0", "s1", "s2"]
#: raft timing that rides out a loaded host (the tier-1 run's workers):
#: elections not before 1 s of silence, proposals wait up to 30 s
RAFT_KW = {"election_timeout": (1.0, 2.0), "heartbeat_interval": 0.1}
PROPOSE_TIMEOUT_S = 30.0
T0_S = 1_700_000_000.0


def pkg(name):
    p = types.SimpleNamespace(name=name, kw={"device": "cpu"} if name ==
                              "dingo_tpu_torch" else {})
    for attr, m in {"txn": "engine.txn", "raw": "engine.raw_engine",
                    "monom": "engine.mono_engine", "regm": "store.region",
                    "node": "store.node", "raft": "raft",
                    "gc": "engine.gc", "st": "engine.storage",
                    "codec": "mvcc.codec"}.items():
        setattr(p, attr, importlib.import_module(f"{name}.{m}"))
    return p


class Clock:
    """A module's ``time`` held at `now` seconds (moved by the script)."""

    def __init__(self):
        self.now = T0_S

    def time(self):
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    out = {}
    for name in PKGS:
        c = Clock()
        monkeypatch.setattr(importlib.import_module(f"{name}.engine.txn"),
                            "time", c)
        out[name] = c
    return out


def script(seed, n):
    """A fixed list of operations over 8 keys: transactions committed or
    left locked, stale prewrites, reads into locks, status checks and
    lock resolution after the TTL, rollbacks, pessimistic locks, heart
    beats, scans, GC and a delete_range."""
    rng = random.Random(seed)
    keys = [b"k%d" % i for i in range(8)]
    ts, started, ops = 10, [], []
    for _ in range(n):
        ts += rng.randrange(1, 4)
        kind = rng.choices(
            ["txn", "get", "scan", "batch_get", "status", "resolve",
             "rollback", "pessimistic", "heart_beat", "sleep", "scan_lock",
             "secondary", "stale", "gc", "dump"],
            weights=[10, 4, 2, 2, 3, 2, 2, 3, 1, 2, 1, 1, 2, 1, 1])[0]
        if kind == "txn":
            ks = rng.sample(keys, rng.randrange(1, 4))
            muts = [(rng.choice(["put", "put", "delete", "lock"]), k,
                     b"v%d" % ts) for k in ks]
            commit = rng.random() < 0.6
            ops.append(("txn", muts, ts, rng.choice([1000, 3000, 60000]),
                        ts + 1 if commit else 0))
            started.append((ks[0], ts, ks))
            ts += 1
        elif kind in ("status", "resolve", "rollback", "heart_beat",
                      "secondary") and started:
            primary, sts, ks = rng.choice(started)
            if kind == "status":
                ops.append(("status", primary, sts, ts))
            elif kind == "resolve":
                ops.append(("resolve", sts, rng.choice([0, ts]),
                            rng.choice([None, ks])))
            elif kind == "rollback":
                ops.append(("rollback", ks, sts))
            elif kind == "heart_beat":
                ops.append(("heart_beat", primary, sts, 9000))
            else:
                ops.append(("secondary", ks, sts))
        elif kind == "pessimistic":
            ks = rng.sample(keys, rng.randrange(1, 3))
            ops.append(("pessimistic", ks, ts, ts + rng.randrange(0, 3),
                        rng.random() < 0.5))
            started.append((ks[0], ts, ks))
            ts += 3
        elif kind == "stale":
            ops.append(("txn", [("put", rng.choice(keys), b"old")],
                        max(1, ts - 40), 3000, ts))
        elif kind == "sleep":
            ops.append(("sleep", rng.choice([500, 2500, 7000])))
        elif kind in ("get", "batch_get", "scan", "scan_lock", "gc", "dump"):
            ops.append((kind, rng.sample(keys, 3), ts))
    ops.append(("delete_range", b"k6", b"k8"))
    ops.append(("dump", keys, ts + 10))
    return ops


def plain(v):
    """Outcome values as comparable plain data."""
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def run_script(p, t, clock, ops):
    """Each operation's outcome: ("ok", value) or ("raised", type, fields)."""
    T = p.txn
    out = []
    for op in ops:
        try:
            kind = op[0]
            if kind == "txn":
                _, muts, sts, ttl, cts = op
                m = [T.Mutation(T.Op(o), k, v) for o, k, v in muts]
                t.prewrite(m, muts[0][1], sts, lock_ttl_ms=ttl)
                if cts:
                    t.commit([k for _, k, _ in muts], sts, cts)
                r = None
            elif kind == "get":
                r = t.get(op[1][0], op[2])
            elif kind == "batch_get":
                r = t.batch_get(op[1], op[2])
            elif kind == "scan":
                r = t.scan(b"k0", b"k9", op[2])
            elif kind == "scan_lock":
                r = t.scan_lock(max_ts=op[2])
            elif kind == "status":
                r = t.check_txn_status(op[1], op[2], op[3])
            elif kind == "resolve":
                r = t.resolve_lock(op[1], op[2], op[3])
            elif kind == "rollback":
                r = t.batch_rollback(op[1], op[2])
            elif kind == "heart_beat":
                r = t.heart_beat(op[1], op[2], op[3])
            elif kind == "secondary":
                r = t.check_secondary_locks(op[1], op[2])
            elif kind == "pessimistic":
                _, ks, sts, fts, undo = op
                t.pessimistic_lock(ks, ks[0], sts, fts)
                if undo:
                    t.pessimistic_rollback(ks, sts)
                r = None
            elif kind == "sleep":
                clock.now += op[1] / 1000.0
                r = None
            elif kind == "gc":
                r = t.gc(op[2] - 20)
            elif kind == "delete_range":
                r = t.delete_range(op[1], op[2])
            else:
                r = t.dump()
            out.append(("ok", plain(r)))
        except T.TxnError as e:
            out.append(("raised", type(e).__name__, plain({
                k: getattr(e, k) for k in ("key", "lock", "conflict_ts")
                if hasattr(e, k)}), str(e)))
    return out


def txn_cfs(p, raw):
    return {cf: list(raw.scan(cf, b"", None))
            for cf in (p.raw.CF_TXN_DATA, p.raw.CF_TXN_LOCK,
                       p.raw.CF_TXN_WRITE)}


def store_region(p, peers=()):
    return p.regm.RegionDefinition(
        region_id=5, start_key=b"", end_key=b"\xff" * 8, peers=list(peers),
        region_type=p.regm.RegionType.STORE)


def test_script_on_mono_equal(clocks):
    ops = script(seed=7, n=220)
    outcomes, cfs = {}, {}
    for name in PKGS:
        p = pkg(name)
        raw = p.raw.MemEngine()
        region = p.regm.Region(store_region(p), **p.kw)
        t = p.txn.TxnEngine(p.monom.MonoStoreEngine(raw, **p.kw), region)
        outcomes[name] = run_script(p, t, clocks[name], ops)
        cfs[name] = txn_cfs(p, raw)
    assert outcomes["dingo_tpu_torch"] == outcomes["dingo_tpu"]
    assert cfs["dingo_tpu_torch"] == cfs["dingo_tpu"]
    kinds = {o[1] for o in outcomes["dingo_tpu_torch"] if o[0] == "raised"}
    # the script meets every conflict the engine reports
    assert {"KeyIsLocked", "WriteConflict"} <= kinds, kinds
    assert any(o[0] == "ok" and isinstance(o[1], dict)
               and o[1].get("action") == "rolled_back"
               for o in outcomes["dingo_tpu_torch"])
    assert all(cfs["dingo_tpu_torch"].values())


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


class Patient:
    """A raft engine whose proposals wait PROPOSE_TIMEOUT_S to apply."""

    def __init__(self, engine):
        self.engine = engine
        self.raw = engine.raw

    def write(self, region, data):
        return self.engine.write(region, data, timeout=PROPOSE_TIMEOUT_S)


def test_script_on_raft_region_equal(clocks):
    """The same script through a 3-replica raft region: the TxnRaftData
    batches apply on every replica, and every replica of each package
    holds the same bytes."""
    ops = script(seed=11, n=90)
    outcomes, cfs = {}, {}
    for name in PKGS:
        p = pkg(name)
        transport = p.raft.LocalTransport()
        nodes = {sid: p.node.StoreNode(sid, transport, None,
                                       raft_kw={"seed": i, **RAFT_KW},
                                       **p.kw)
                 for i, sid in enumerate(SIDS)}
        try:
            d = store_region(p, SIDS)
            regions = {sid: n.create_region(d) for sid, n in nodes.items()}

            def leader():
                lead = [s for s in SIDS
                        if nodes[s].engine.get_node(5).is_leader()]
                return lead[0] if len(lead) == 1 else None

            assert wait_for(lambda: leader() is not None)
            lead = leader()
            t = p.txn.TxnEngine(Patient(nodes[lead].engine), regions[lead])
            outcomes[name] = run_script(p, t, clocks[name], ops)
            target = nodes[lead].engine.get_node(5).commit_index
            assert wait_for(lambda: all(
                nodes[s].engine.get_node(5).last_applied >= target
                for s in SIDS))
            cfs[name] = [txn_cfs(p, nodes[s].raw) for s in SIDS]
        finally:
            for n in nodes.values():
                n.stop()
    assert outcomes["dingo_tpu_torch"] == outcomes["dingo_tpu"]
    for got, want in zip(cfs["dingo_tpu_torch"], cfs["dingo_tpu"]):
        assert got == want
    assert cfs["dingo_tpu_torch"][0] == cfs["dingo_tpu_torch"][2]


def test_exception_fields_equal(clocks):
    got = {}
    for name in PKGS:
        p = pkg(name)
        T = p.txn
        t = T.TxnEngine(p.monom.MonoStoreEngine(p.raw.MemEngine(), **p.kw),
                        p.regm.Region(store_region(p), **p.kw))
        t.prewrite([T.Mutation(T.Op.PUT, b"a", b"1")], b"a", 10)
        t.commit([b"a"], 10, 20)
        t.prewrite([T.Mutation(T.Op.PUT, b"b", b"2")], b"b", 30,
                   lock_ttl_ms=1500)
        errs = []
        for fn in (lambda: t.get(b"b", 35),
                   lambda: t.prewrite([T.Mutation(T.Op.PUT, b"a", b"x")],
                                      b"a", 15),
                   lambda: t.commit([b"zz"], 99, 100),
                   lambda: t.heart_beat(b"zz", 1, 10)):
            try:
                fn()
            except T.TxnError as e:
                errs.append((type(e).__name__, plain(getattr(e, "key", None)),
                             plain(getattr(e, "lock", None)),
                             getattr(e, "conflict_ts", None)))
        clocks[name].now += 2.0
        errs.append(plain(t.check_txn_status(b"b", 30, 40)))
        got[name] = errs
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]
    assert [e[0] for e in got["dingo_tpu"][:4]] == [
        "KeyIsLocked", "WriteConflict", "TxnNotFound", "TxnNotFound"]
    assert got["dingo_tpu"][4]["action"] == "rolled_back"


# ---------------- the JAX package's cases through the port ------------------

TXN_CASES = ["test_prewrite_commit_get", "test_delete_and_overwrite_versions",
             "test_write_conflict", "test_lock_blocks_other_txn",
             "test_rollback_then_late_prewrite_fails",
             "test_commit_idempotent_and_missing", "test_pessimistic_flow",
             "test_pessimistic_rollback",
             "test_check_txn_status_expired_lock",
             "test_check_txn_status_committed",
             "test_resolve_lock_commits_secondaries",
             "test_resolve_lock_rollback", "test_heart_beat_extends_ttl",
             "test_scan_snapshot", "test_scan_hits_lock",
             "test_gc_drops_old_versions", "test_latches_serialize",
             "test_commit_bare_pessimistic_lock_rejected",
             "test_pessimistic_conflict_behind_rollback_record",
             "test_concurrent_prewrite_same_key_excluded"]


def test_txn_case_list_is_whole():
    mod = port_cases("test_txn.py")
    assert sorted(TXN_CASES) == sorted(
        n for n in dir(mod) if n.startswith("test_"))


@pytest.mark.parametrize("case", TXN_CASES)
def test_txn_cases_through_the_port(case, monkeypatch):
    port_on_cpu(monkeypatch)
    mod = port_cases("test_txn.py")
    assert mod.TxnEngine.__module__ == "dingo_tpu_torch.engine.txn"
    getattr(mod, case)()


def test_gc_safe_point_case_through_the_port(monkeypatch):
    port_on_cpu(monkeypatch)
    mod = port_cases("test_document_region_gc.py")
    assert mod.GCSafePointManager.__module__ == "dingo_tpu_torch.engine.gc"
    mod.test_gc_safe_point_prunes_versions()


def test_gc_non_txn_equal():
    """Version GC below the safe point removes the same rows in both."""
    got = {}
    for name in PKGS:
        p = pkg(name)
        raw = p.raw.MemEngine()
        storage = p.st.Storage(p.monom.MonoStoreEngine(raw, **p.kw))
        region = p.regm.Region(store_region(p), **p.kw)
        Codec = p.codec.Codec
        tss = []
        for i in range(30):
            tss.append(storage.kv_put(region, [(b"k%d" % (i % 5),
                                                b"v%d" % i)]))
        tss.append(storage.kv_batch_delete(region, [b"k1", b"k3"]))
        gc = p.gc.GCSafePointManager()
        removed = [gc.gc_non_txn(raw)]
        for cut in (tss[12], tss[-1] + 1):
            gc.update(cut)
            removed.append(gc.gc_non_txn(raw))
        got[name] = (removed, [(Codec.decode_key(k)[0], v)
                               for k, v in raw.scan("default", b"", None)])
    assert got["dingo_tpu_torch"][0] == got["dingo_tpu"][0]
    assert got["dingo_tpu_torch"][1] == got["dingo_tpu"][1]
    assert got["dingo_tpu_torch"][0][0] == 0 and got["dingo_tpu"][0][1] > 0


def test_concurrent_transfers_conserve_total():
    """test_concurrency_stress.py's transfers, small, on the port: 4
    threads of 12 pessimistic transfers between 4 accounts. No money is
    made or lost (no lost update), every thread joins within 60 s (no
    deadlock) and no lock is left."""
    from dingo_tpu_torch.engine.mono_engine import MonoStoreEngine
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.engine.txn import (
        KeyIsLocked,
        Mutation,
        Op,
        TxnEngine,
        WriteConflict,
    )
    from dingo_tpu_torch.mvcc.ts_provider import compose_ts
    from dingo_tpu_torch.store.region import (
        Region,
        RegionDefinition,
        RegionType,
    )

    txn = TxnEngine(MonoStoreEngine(MemEngine(), device="cpu"), Region(
        RegionDefinition(region_id=1, start_key=b"a", end_key=b"z",
                         region_type=RegionType.STORE), device="cpu"))
    lock = threading.Lock()
    counter = [0]

    def next_ts():
        with lock:
            counter[0] += 1
            return compose_ts(int(time.time() * 1000), counter[0])

    accounts = [b"acct%d" % i for i in range(4)]
    init = next_ts()
    txn.prewrite([Mutation(Op.PUT, a, b"1000") for a in accounts],
                 accounts[0], init)
    txn.commit(accounts, init, next_ts())
    done, errors = [0], []

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(12):
                a, b = r.choice(len(accounts), 2, replace=False)
                src, dst = accounts[a], accounts[b]
                start_ts, for_update = next_ts(), next_ts()
                try:
                    txn.pessimistic_lock([src, dst], src, start_ts,
                                         for_update, ttl_ms=5000)
                except (KeyIsLocked, WriteConflict):
                    continue
                try:
                    amt = int(r.integers(1, 20))
                    sv = int(txn.get(src, for_update) or b"0")
                    dv = int(txn.get(dst, for_update) or b"0")
                    txn.prewrite(
                        [Mutation(Op.PUT, src, str(sv - amt).encode()),
                         Mutation(Op.PUT, dst, str(dv + amt).encode())],
                        src, start_ts, for_update_ts=for_update)
                    txn.commit([src, dst], start_ts, next_ts())
                    with lock:
                        done[0] += 1
                except (KeyIsLocked, WriteConflict):
                    txn.pessimistic_rollback([src, dst], start_ts)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads), "a worker deadlocked"
    assert not errors, errors
    read_ts = next_ts()
    balances = [int(txn.get(a, read_ts)) for a in accounts]
    assert sum(balances) == 4000, (balances, done[0])
    assert done[0] > 0
    assert txn.scan_lock() == []
