"""The Txn RPCs of the port's StoreService against the JAX package's:
tests/test_txn_grpc.py's flows driven with raw requests over gRPC, the
same flow against each package's cluster (an in-process coordinator and
three StoreNodes, each hosted by its package's DingoServer) with two KV
regions, [a, m) and [m, z), so a transaction crosses regions.

Each flow records what it observes (error codes, values, lock keys,
actions; never a timestamp, since each cluster has its own TSO) and the
two records must be equal: the pessimistic flow with a conflict, a
cross-region commit read back by TxnBatchGet, an orphan lock found by
TxnScanLock and resolved after its TTL, TxnHeartBeat extending a TTL,
TxnCheckSecondaryLocks with TxnDump and TxnGc, and four concurrent
TxnPessimisticLock calls with one winner. The client SDK's 2PC and the
CLI verbs are not ported.
"""

import threading
import time

import pytest
import torch

from test_torch_grpc_server import PB, PKGS, Pair, wait_for

torch.set_num_threads(1)

#: the lock TTL of a flow that waits for its lock to expire
SHORT_TTL_MS = 150


@pytest.fixture(scope="module")
def pair():
    pr = Pair()
    try:
        regions = [pr.create(kind="kv", start=b"a", end=b"m"),
                   pr.create(kind="kv", start=b"m", end=b"z")]
        pr.regions = {name: [r[name] for r in regions] for name in PKGS}
        yield pr
    finally:
        pr.close()


class Txns:
    """Raw Txn RPCs against one cluster, routed by key to its region's
    leader; timestamps from the cluster's own TSO."""

    def __init__(self, cluster, regions):
        self.c = cluster
        self.regions = regions

    def ts(self):
        return self.c.tso.gen_ts()[0]

    def region(self, key):
        return self.regions[0] if key < b"m" else self.regions[1]

    def groups(self, keys):
        out = {}
        for k in keys:
            out.setdefault(self.region(k), []).append(k)
        return out.items()

    def rpc(self, rid, method, req):
        req.context.region_id = rid
        return self.c.call(rid, "StoreService", method, req)

    def lock(self, keys, primary, start_ts, ttl_ms=3000):
        return [self.rpc(rid, "TxnPessimisticLock",
                         PB.TxnPessimisticLockRequest(
                             keys=group, primary_lock=primary,
                             start_ts=start_ts, for_update_ts=start_ts,
                             lock_ttl_ms=ttl_ms)).error.errcode
                for rid, group in self.groups(keys)]

    def prewrite(self, puts, primary, start_ts, ttl_ms=3000,
                 for_update_ts=0):
        codes = []
        for rid, group in self.groups(list(puts)):
            req = PB.TxnPrewriteRequest(
                primary_lock=primary, start_ts=start_ts,
                lock_ttl_ms=ttl_ms, for_update_ts=for_update_ts)
            for k in group:
                req.mutations.add(op="put", key=k, value=puts[k])
            codes.append(self.rpc(rid, "TxnPrewrite", req).error.errcode)
        return codes

    def commit(self, keys, start_ts, commit_ts):
        """Region by region in the order of `keys` (a 2PC client puts
        the primary first)."""
        return [self.rpc(rid, "TxnCommit", PB.TxnCommitRequest(
            keys=group, start_ts=start_ts,
            commit_ts=commit_ts)).error.errcode
            for rid, group in self.groups(keys)]

    def get(self, key):
        r = self.rpc(self.region(key), "TxnGet",
                     PB.TxnGetRequest(key=key, start_ts=self.ts()))
        return (r.error.errcode, r.value if r.found else None)

    def put_commit(self, puts):
        start = self.ts()
        primary = min(puts)
        codes = self.prewrite(puts, primary, start)
        commit_ts = self.ts()
        return codes + self.commit(sorted(puts), start, commit_ts), \
            commit_ts

    def status(self, primary, lock_ts):
        r = self.rpc(self.region(primary), "TxnCheckStatus",
                     PB.TxnCheckStatusRequest(primary_key=primary,
                                              lock_ts=lock_ts,
                                              caller_start_ts=self.ts()))
        return r.error.errcode, r.action

    def scan_locks(self):
        keys = []
        for rid in self.regions:
            req = PB.TxnScanLockRequest()
            req.range.start_key = b"a" if rid == self.regions[0] else b"m"
            req.range.end_key = b"m" if rid == self.regions[0] else b"z"
            keys += [li.key for li in self.rpc(rid, "TxnScanLock",
                                               req).locks]
        return sorted(keys)

    def resolve(self, start_ts, commit_ts=0):
        return [self.rpc(rid, "TxnResolveLock", PB.TxnResolveLockRequest(
            start_ts=start_ts, commit_ts=commit_ts)).resolved
            for rid in self.regions]


def both(pair, flow):
    """flow(Txns) on each package's cluster; the records must be
    equal. Returns the port's."""
    got = {name: flow(Txns(c, pair.regions[name]))
           for name, c in pair.c.items()}
    assert got["dingo_tpu"] == got["dingo_tpu_torch"]
    return got["dingo_tpu_torch"]


def test_pessimistic_flow_end_to_end(pair):
    """lock -> prewrite -> commit, then a locked key refuses a second
    pessimistic txn until the first rolls back."""
    def flow(t):
        rec = []
        s = t.ts()
        keys = [b"acct1", b"acct2"]
        rec += t.lock(keys, b"acct1", s)
        rec += t.prewrite({b"acct1": b"90", b"acct2": b"110"}, b"acct1", s,
                          for_update_ts=s)
        rec += t.commit(keys, s, t.ts())
        rec += [t.get(b"acct1"), t.get(b"acct2")]
        t1 = t.ts()
        rec += t.lock([b"acct1"], b"acct1", t1)
        t2 = t.ts()
        rec += t.lock([b"acct1"], b"acct1", t2)
        rec.append(t.rpc(t.region(b"acct1"), "TxnPessimisticRollback",
                         PB.TxnPessimisticRollbackRequest(
                             keys=[b"acct1"], start_ts=t1)).error.errcode)
        t3 = t.ts()
        rec += t.lock([b"acct1"], b"acct1", t3)
        rec += t.prewrite({b"acct1": b"42"}, b"acct1", t3, for_update_ts=t3)
        rec += t.commit([b"acct1"], t3, t.ts())
        rec.append(t.get(b"acct1"))
        return rec

    rec = both(pair, flow)
    assert rec == [0, 0, 0, (0, b"90"), (0, b"110"), 0, 40001, 0, 0, 0, 0,
                   (0, b"42")]


def test_cross_region_commit_and_batch_get(pair):
    """One txn over both regions commits; TxnBatchGet on each region sees
    the committed rows and skips the absent key."""
    def flow(t):
        codes, _ = t.put_commit({b"bob": b"1", b"sue": b"2"})
        ts = t.ts()
        got = {}
        for rid, group in t.groups([b"bob", b"sue", b"nope"]):
            r = t.rpc(rid, "TxnBatchGet",
                      PB.TxnBatchGetRequest(keys=group, start_ts=ts))
            got.update({kv.key: kv.value for kv in r.kvs})
        return codes, got

    codes, got = both(pair, flow)
    assert codes == [0, 0, 0, 0]
    assert got == {b"bob": b"1", b"sue": b"2"}


def test_orphan_lock_discovery_and_resolve(pair):
    """A txn that prewrites over both regions and never commits:
    TxnScanLock finds its locks, TxnCheckStatus rolls the primary back
    once its TTL has run out, TxnResolveLock clears every region and the
    keys are writable again."""
    def flow(t):
        rec = []
        s = t.ts()
        keys = [b"crash1", b"mcrash2"]
        rec += t.lock(keys, b"crash1", s, ttl_ms=SHORT_TTL_MS)
        rec += t.prewrite({b"crash1": b"zz", b"mcrash2": b"zz"}, b"crash1",
                          s, ttl_ms=SHORT_TTL_MS, for_update_ts=s)
        rec.append(t.scan_locks())
        seen = []
        wait_for(lambda: seen.append(t.status(b"crash1", s)) or
                 seen[-1][1] != "locked", what="the orphan's TTL to expire")
        rec.append(seen[-1])
        rec.append(sum(t.resolve(s)) >= 1)
        rec.append(t.scan_locks())
        n = t.ts()
        rec += t.lock([b"crash1"], b"crash1", n)
        rec += t.prewrite({b"crash1": b"alive"}, b"crash1", n,
                          for_update_ts=n)
        rec += t.commit([b"crash1"], n, t.ts())
        rec.append(t.get(b"crash1"))
        return rec

    rec = both(pair, flow)
    assert rec[4] == [b"crash1", b"mcrash2"]
    assert rec[5] == (0, "rolled_back")
    assert rec[6:] == [True, [], 0, 0, 0, (0, b"alive")]


def test_heart_beat_extends_ttl(pair):
    """TxnHeartBeat raises a 200 ms lock's TTL to 60 s: past the old TTL
    the primary still reads as locked."""
    def flow(t):
        s = t.ts()
        rec = t.lock([b"hb1"], b"hb1", s, ttl_ms=200)
        t0 = time.monotonic()
        r = t.rpc(t.region(b"hb1"), "TxnHeartBeat",
                  PB.TxnHeartBeatRequest(primary_lock=b"hb1", start_ts=s,
                                         advise_lock_ttl_ms=60000))
        rec.append((r.error.errcode, r.lock_ttl_ms >= 60000))
        # let the original TTL run out before asking
        time.sleep(max(0.0, 0.3 - (time.monotonic() - t0)))
        rec.append(t.status(b"hb1", s))
        rec.append(t.rpc(t.region(b"hb1"), "TxnPessimisticRollback",
                         PB.TxnPessimisticRollbackRequest(
                             keys=[b"hb1"], start_ts=s)).error.errcode)
        return rec

    assert both(pair, flow) == [0, (0, True), (0, "locked"), 0]


def test_check_secondary_locks_and_dump_and_gc(pair):
    """TxnCheckSecondaryLocks reports a prewritten secondary and the
    missing key; TxnDump shows the committed writes; TxnGc below a safe
    point past the second commit drops the older version, and the newest
    survives."""
    def flow(t):
        rec = [t.put_commit({b"gckey": b"v1"})[0]]
        codes, commit2 = t.put_commit({b"gckey": b"v2"})
        rec.append(codes)
        s3 = t.ts()
        rec += t.prewrite({b"sec1": b"s"}, b"sec1", s3, ttl_ms=5000)
        r = t.rpc(t.region(b"sec1"), "TxnCheckSecondaryLocks",
                  PB.TxnCheckSecondaryLocksRequest(
                      keys=[b"sec1", b"sec_absent"], start_ts=s3))
        rec.append(([li.key for li in r.locks], list(r.missing_keys),
                    r.commit_ts))
        rec.append(t.resolve(s3))
        rid = t.region(b"gckey")
        req = PB.TxnDumpRequest()
        req.range.start_key, req.range.end_key = b"gckey", b"gckez"
        dump = t.rpc(rid, "TxnDump", req)
        rec.append(([(w.key, w.op) for w in dump.writes],
                    [d.value for d in dump.datas], len(dump.locks)))
        gc = t.rpc(rid, "TxnGc", PB.TxnGcRequest(safe_point_ts=commit2 + 1))
        rec.append((gc.error.errcode, gc.deleted >= 1))
        rec.append(t.get(b"gckey"))
        return rec

    rec = both(pair, flow)
    assert rec[2] == 0
    assert rec[3] == ([b"sec1"], [b"sec_absent"], 0)
    assert rec[4] == [0, 1]   # sec1 lies in [m, z)
    writes, datas, nlocks = rec[5]
    assert writes and all(k == b"gckey" for k, _ in writes)
    assert sorted(datas) == [b"v1", b"v2"] and nlocks == 0
    assert rec[6] == (0, True) and rec[7] == (0, b"v2")


def test_concurrent_pessimistic_lock_single_winner(pair):
    """Four TxnPessimisticLock calls race on one key: exactly one wins
    (the per-region TxnEngine's latches serialize the check and the
    write), the others answer 40001."""
    def flow(t):
        codes = []
        starts = [t.ts() for _ in range(4)]
        ready = threading.Barrier(4)

        def worker(s):
            ready.wait()
            codes.append((t.lock([b"contested"], b"contested", s)[0], s))

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in starts]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        winners = [s for code, s in codes if code == 0]
        for s in winners:
            t.rpc(t.region(b"contested"), "TxnPessimisticRollback",
                  PB.TxnPessimisticRollbackRequest(keys=[b"contested"],
                                                   start_ts=s))
        return sorted(code for code, _ in codes)

    assert both(pair, flow) == [0, 40001, 40001, 40001]
