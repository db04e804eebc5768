"""The replicated region path of the port against the JAX package's, as a
whole: 3-store LocalTransport clusters (StoreNode -> RaftStoreEngine ->
apply -> MemEngine + index wrapper) with FLAT and IVF_FLAT regions in each
package, the cases of test_storage_slice.py and test_index_manager.py on
a MonoStoreEngine through both packages, IndexService bound to a node,
the region carry function, and the NotPorted raise sites.

Seeded numpy inputs go through both packages; search ids are compared
modulo exact ties and distances within rtol 1e-4, atol 1e-3. The port
runs on the CPU (``device="cpu"``; None means CUDA and raises here). Raft
waits retry on NotLeader and every wait has a deadline.
"""

import importlib
import time

import numpy as np
import pytest
import torch

from dingo_tpu_torch.common.device import DeviceUnavailable
from dingo_tpu_torch.index.base import NotPorted, NotSupported

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
DIM = 32
RTOL, ATOL = 1e-4, 1e-3
SIDS = ["s0", "s1", "s2"]


class Pkg:
    """One package's region-path modules; the port's constructors get
    ``device="cpu"``."""

    MODS = {"regm": "store.region", "monom": "engine.mono_engine",
            "raw": "engine.raw_engine", "st": "engine.storage",
            "vcodec": "index.codec", "base": "index.base",
            "reader": "index.vector_reader", "mgr": "index.manager",
            "wd": "engine.write_data", "node": "store.node",
            "raft": "raft", "rlog": "raft.log",
            "sf": "coprocessor.scalar_filter", "codec": "mvcc.codec",
            "dist": "ops.distance", "raft_engine": "engine.raft_engine"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    def param(self, index_type="flat", **kw):
        b = self.base
        kw.setdefault("ncentroids", 8)
        kw.setdefault("default_nprobe", 8)
        return b.IndexParameter(index_type=b.IndexType(index_type),
                                dimension=kw.pop("dimension", DIM), **kw)

    def definition(self, region_id=77, index_type="flat", partition=1,
                   id_lo=0, id_hi=1 << 40, peers=(), **kw):
        r = self.regm
        return r.RegionDefinition(
            region_id=region_id,
            start_key=self.vcodec.encode_vector_key(partition, id_lo),
            end_key=self.vcodec.encode_vector_key(partition, id_hi),
            partition_id=partition, peers=list(peers),
            region_type=r.RegionType.INDEX,
            index_parameter=self.param(index_type, **kw))

    def region(self, definition):
        reg = self.regm.Region(definition, **self.kw)
        w = reg.vector_index_wrapper
        if w is not None:
            w.build_own()
            w.set_own(w.own_index)
        return reg

    def mono(self, raw=None):
        raw = raw if raw is not None else self.raw.MemEngine()
        engine = self.monom.MonoStoreEngine(raw, **self.kw)
        return raw, engine, self.st.Storage(engine)

    def manager(self, raw, root=None):
        return self.mgr.VectorIndexManager(raw, root, **self.kw)

    def store_node(self, sid, transport, seed, **kw):
        return self.node.StoreNode(sid, transport, None, raft_kw={"seed": seed},
                                   **kw, **self.kw)


@pytest.fixture(params=PKGS)
def p(request):
    return Pkg(request.param)


def rand(n, seed=0, d=DIM):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


def clustered(n, seed=0, d=DIM, ncl=16):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((ncl, d), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)] + rng.standard_normal(
        (n, d), dtype=np.float32)
    return x.astype(np.float32)


def assert_same_rows(a_rows, b_rows):
    """Rows of VectorWithData: distances within tolerance, ids equal modulo
    exact ties (a differing id sits next to an equal distance)."""
    assert len(a_rows) == len(b_rows)
    for a, b in zip(a_rows, b_rows):
        assert len(a) == len(b)
        da = np.asarray([v.distance for v in a], np.float32)
        db = np.asarray([v.distance for v in b], np.float32)
        np.testing.assert_allclose(db, da, rtol=RTOL, atol=ATOL)
        ia = np.asarray([v.id for v in a])
        ib = np.asarray([v.id for v in b])
        for c in np.flatnonzero(ia != ib):
            near = [db[c2] for c2 in (c - 1, c + 1) if 0 <= c2 < len(db)]
            assert any(abs(db[c] - v) <= ATOL for v in near), (c, ia, ib)


def ids_of(rows):
    return [[v.id for v in row] for row in rows]


# ---------------- 3-store clusters in both packages ------------------------

def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


class Cluster:
    def __init__(self, p, index_type, region_id=9, **param_kw):
        self.p = p
        self.region_id = region_id
        self.transport = p.raft.LocalTransport()
        self.nodes = {sid: p.store_node(sid, self.transport, i)
                      for i, sid in enumerate(SIDS)}
        d = p.definition(region_id, index_type, peers=SIDS, **param_kw)
        self.regions = {sid: n.create_region(d)
                        for sid, n in self.nodes.items()}

    def raft(self, sid):
        return self.nodes[sid].engine.get_node(self.region_id)

    def leader(self, among=None, timeout=10.0):
        among = among or list(self.nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leaders = [s for s in among if self.raft(s).is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.02)
        raise AssertionError("no unique leader")

    def on_leader(self, fn, among=None, attempts=8):
        """fn(node, region) on the current leader, retried across
        leadership churn (test_raft_store_engine.py's pattern)."""
        NotLeader = self.p.raft.NotLeader
        for _ in range(attempts):
            sid = self.leader(among)
            try:
                return fn(self.nodes[sid], self.regions[sid])
            except NotLeader:
                time.sleep(0.1)
        raise AssertionError("leadership never stabilized")

    def settle(self, among=None):
        """Every replica has applied the leader's commit index."""
        among = among or list(self.nodes)
        target = self.raft(self.leader(among)).commit_index
        assert wait_for(lambda: all(self.raft(s).last_applied >= target
                                    for s in among))

    def user_pairs(self, sid):
        """(cf, user key, value) of every version, ts stripped."""
        raw = self.nodes[sid].raw
        Codec = self.p.codec.Codec
        out = []
        for cf in self.p.raw.ALL_CFS:
            if cf == self.p.raw.CF_META:
                continue
            for k, v in raw.scan(cf, b"", None):
                out.append((cf, Codec.decode_key(k)[0], v))
        return out

    def search(self, sid, q, topk, **kw):
        return self.nodes[sid].storage.vector_batch_search(
            self.regions[sid], q, topk, **kw)

    def stop(self, sids=None):
        for sid in sids or list(self.nodes):
            self.nodes[sid].stop()


def _write_sequence(c, x, ids_add, up_ids, up_x, del_ids):
    for i in range(0, len(ids_add), 256):
        c.on_leader(lambda n, r, i=i: n.storage.vector_add(
            r, ids_add[i:i + 256], x[i:i + 256],
            [{"i": int(v)} for v in ids_add[i:i + 256]]))
    c.on_leader(lambda n, r: n.storage.vector_add(r, up_ids, up_x))
    c.on_leader(lambda n, r: n.storage.vector_delete(r, del_ids))
    c.settle()


@pytest.mark.parametrize("index_type", ["flat", "ivf_flat"])
def test_cluster_matches_reference(index_type):
    """Adds (ascending ids), upserts and deletes through the leader's
    Storage: every replica's engine and index converge, both packages'
    engines hold the same (user key, value) pairs, and leader searches
    match the JAX package's (IVF_FLAT untrained on brute force, then
    trained by VectorIndexManager.rebuild on every replica)."""
    n = 1500
    x = clustered(n, seed=3)
    ids = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(4)
    up_ids = np.sort(rng.choice(n, 100, replace=False)).astype(np.int64)
    up_x = clustered(100, seed=5)
    del_ids = np.sort(rng.choice(n, 60, replace=False)).astype(np.int64)
    q = x[rng.choice(n, 16, replace=False)] + 0.05
    live = n - len(np.setdiff1d(del_ids, []))
    clusters = {pkg: Cluster(Pkg(pkg), index_type, ncentroids=8)
                for pkg in PKGS}
    try:
        for c in clusters.values():
            _write_sequence(c, x, ids, up_ids, up_x, del_ids)
        pairs = {pkg: c.user_pairs(c.leader()) for pkg, c in clusters.items()}
        assert pairs["dingo_tpu"] == pairs["dingo_tpu_torch"]
        tc = clusters["dingo_tpu_torch"]
        for sid in SIDS:
            assert tc.user_pairs(sid) == pairs["dingo_tpu_torch"], sid
            assert tc.nodes[sid].storage.vector_count(tc.regions[sid]) == live
            assert tc.regions[sid].vector_index_wrapper.get_count() == live
        kw = {"nprobe": 8} if index_type == "ivf_flat" else {}
        rounds = ["untrained", "trained"] if index_type == "ivf_flat" \
            else ["flat"]
        for phase in rounds:
            if phase == "trained":
                for c in clusters.values():
                    for sid in SIDS:
                        c.nodes[sid].index_manager.rebuild(
                            c.regions[sid],
                            raft_log=c.raft(sid).log)
                for sid in SIDS:
                    own = tc.regions[sid].vector_index_wrapper.own_index
                    assert own.is_trained(), sid
            res = {pkg: c.search(c.leader(), q, 10, **kw)
                   for pkg, c in clusters.items()}
            assert_same_rows(res["dingo_tpu"], res["dingo_tpu_torch"])
            lead = tc.leader()
            for sid in SIDS:
                assert ids_of(tc.search(sid, q, 10, **kw)) == \
                    ids_of(res["dingo_tpu_torch"]), (phase, sid)
            assert all(v.id not in set(del_ids.tolist())
                       for row in res["dingo_tpu_torch"] for v in row)
            assert lead in SIDS
    finally:
        for c in clusters.values():
            c.stop()


def test_follower_write_rejected_and_failover_keeps_acked_writes():
    p = Pkg("dingo_tpu_torch")
    c = Cluster(p, "flat")
    try:
        x = rand(40, seed=8)
        c.on_leader(lambda n, r: n.storage.vector_add(
            r, np.arange(40, dtype=np.int64), x))
        lead = c.leader()
        follower = next(s for s in SIDS if s != lead)
        with pytest.raises(p.raft.NotLeader):
            c.nodes[follower].storage.vector_add(
                c.regions[follower], np.asarray([99], np.int64), x[:1])
        with pytest.raises(p.raft.NotLeader):
            c.nodes[follower].storage.kv_put(c.regions[follower],
                                             [(b"k", b"v")])
        c.settle()
        c.stop([lead])
        survivors = [s for s in SIDS if s != lead]
        c.on_leader(lambda n, r: n.storage.vector_add(
            r, np.asarray([100], np.int64), x[:1] * 2), among=survivors)
        c.settle(survivors)
        for sid in survivors:
            assert c.nodes[sid].storage.vector_count(c.regions[sid]) == 41
            res = c.search(sid, x[:3], 1)
            assert [row[0].id for row in res] == [0, 1, 2]
            assert c.search(sid, x[:1] * 2, 1)[0][0].id == 100
    finally:
        c.stop()            # a stopped node stops again harmlessly


def test_region_install_rides_the_log_and_rebuilds_every_replica():
    """RegionInstallData applies at one log position on every replica and
    each replica's install hook rebuilds its index."""
    p = Pkg("dingo_tpu_torch")
    c = Cluster(p, "flat")
    try:
        x = rand(64, seed=9)
        c.on_leader(lambda n, r: n.storage.vector_add(
            r, np.arange(64, dtype=np.int64), x))
        lead = c.leader()
        state = p.raft_engine.region_snapshot(c.nodes[lead].raw,
                                              c.regions[lead])
        c.on_leader(lambda n, r: n.storage.vector_delete(r, list(range(32))))
        install = p.wd.RegionInstallData(
            cfs=[(cf, list(pairs)) for cf, pairs in state.items()])
        c.on_leader(lambda n, r: n.engine.write(r, install, timeout=10.0))
        c.settle()
        for sid in SIDS:
            reg = c.regions[sid]
            assert c.nodes[sid].storage.vector_count(reg) == 64, sid
            assert reg.vector_index_wrapper.get_count() == 64, sid
            assert c.search(sid, x[:2], 1)[0][0].id == 0
    finally:
        c.stop()


# ---------------- test_storage_slice.py on MonoStoreEngine, both packages --

def test_vector_add_search_roundtrip(p):
    raw, engine, storage = p.mono()
    region = p.region(p.definition())
    x = rand(100)
    ids = np.arange(100, dtype=np.int64)
    scalars = [{"color": "red" if i % 2 == 0 else "blue", "n": i}
               for i in range(100)]
    storage.vector_add(region, ids, x, scalars)
    res = storage.vector_batch_search(region, x[:3], 5)
    assert [r[0].id for r in res] == [0, 1, 2]
    assert res[0][0].distance == pytest.approx(0.0, abs=1e-3)
    got = storage.vector_batch_query(region, [5, 99, 12345],
                                     with_scalar_data=True)
    assert got[0].scalar["n"] == 5
    assert np.allclose(got[1].vector, x[99], atol=1e-5)
    assert got[2] is None
    storage.vector_delete(region, [0, 1, 2])
    res = storage.vector_batch_search(region, x[:1], 3)
    assert all(v.id >= 3 for v in res[0])
    assert storage.vector_batch_query(region, [1])[0] is None
    assert storage.vector_count(region) == 97


def _mono_pair(index_type="flat", **kw):
    out = {}
    for pkg in PKGS:
        q = Pkg(pkg)
        raw, engine, storage = q.mono()
        out[pkg] = (q, storage, q.region(q.definition(index_type=index_type,
                                                      **kw)))
    return out


def _both(stacks, fn):
    return {pkg: fn(q, st, reg) for pkg, (q, st, reg) in stacks.items()}


def test_filters_match_reference():
    """Scalar post-filter (x10 over-fetch), scalar pre-filter, vector-id
    pre-filter and a batch query give the same rows in both packages."""
    stacks = _mono_pair()
    x = rand(200, seed=1)
    ids = np.arange(200, dtype=np.int64)
    scal = [{"color": "red" if i % 4 == 0 else "blue", "bucket": i % 10}
            for i in range(200)]
    _both(stacks, lambda q, st, r: st.vector_add(r, ids, x, scal))

    def post(q, st, r):
        m = q.reader
        return st.vector_batch_search(
            r, x[:4], 5, filter_mode=m.VectorFilterMode.SCALAR,
            filter_type=m.VectorFilterType.QUERY_POST,
            scalar_filter=q.sf.ScalarFilter.equals({"color": "red"}),
            with_scalar_data=True)

    def pre(q, st, r):
        m = q.reader
        return st.vector_batch_search(
            r, x[:2], 50, filter_mode=m.VectorFilterMode.SCALAR,
            filter_type=m.VectorFilterType.QUERY_PRE,
            scalar_filter=q.sf.ScalarFilter.equals({"bucket": 3}))

    def by_id(q, st, r):
        return st.vector_batch_search(
            r, x[:2], 10, filter_mode=q.reader.VectorFilterMode.VECTOR_ID,
            vector_ids=[7, 13, 21, 150])

    for fn in (post, pre, by_id):
        got = _both(stacks, fn)
        assert_same_rows(got["dingo_tpu"], got["dingo_tpu_torch"])
    t = _both(stacks, post)["dingo_tpu_torch"]
    assert all(len(row) == 5 and all(v.id % 4 == 0 and
                                     v.scalar["color"] == "red" for v in row)
               for row in t)
    t = _both(stacks, pre)["dingo_tpu_torch"]
    assert all(len(row) == 20 and all(v.id % 10 == 3 for v in row)
               for row in t)
    assert sorted(v.id for v in _both(stacks, by_id)["dingo_tpu_torch"][0]) \
        == [7, 13, 21, 150]
    bq = _both(stacks, lambda q, st, r: st.vector_batch_query(
        r, [5, 9, 999], with_scalar_data=True))
    for a, b in zip(bq["dingo_tpu"], bq["dingo_tpu_torch"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.scalar == b.scalar
            assert a.vector.tobytes() == b.vector.tobytes()


@pytest.mark.parametrize("index_type", ["ivf_flat", "bruteforce"])
def test_bruteforce_paths_match_reference(index_type):
    """EVECTOR_NOT_SUPPORT (vector_reader.cc:1814-1833): an untrained IVF
    and a BRUTEFORCE region scan the engine into a temporary FLAT."""
    stacks = _mono_pair(index_type)
    x = rand(150, seed=2)
    _both(stacks, lambda q, st, r: st.vector_add(
        r, np.arange(150, dtype=np.int64), x))
    got = _both(stacks, lambda q, st, r: st.vector_batch_search(r, x[:6], 5))
    assert_same_rows(got["dingo_tpu"], got["dingo_tpu_torch"])
    assert [r[0].id for r in got["dingo_tpu_torch"]] == list(range(6))


def test_validation_guards_and_caps(p):
    raw, engine, storage = p.mono()
    region = p.region(p.definition())
    InvalidParameter = p.base.InvalidParameter
    x = rand(10)
    with pytest.raises(InvalidParameter):
        storage.vector_add(region, np.arange(9, dtype=np.int64), x)
    with pytest.raises(InvalidParameter):      # 4,096-row cap
        storage.vector_add(region, np.arange(4097, dtype=np.int64),
                           rand(4097))
    with pytest.raises(InvalidParameter):      # 32 MiB cap
        storage.vector_add(region, np.arange(2100, dtype=np.int64),
                           rand(2100, d=4096))
    with pytest.raises(InvalidParameter):      # row width
        storage.vector_add(region, np.arange(2, dtype=np.int64),
                           rand(2, d=DIM + 1))
    storage.vector_add(region, np.arange(10, dtype=np.int64), x)
    with pytest.raises(InvalidParameter):
        storage.vector_batch_search(region, x, 100000)
    with pytest.raises(InvalidParameter):
        storage.vector_batch_search(region, rand(4097), 1)
    assert p.st.VECTOR_MAX_BATCH_COUNT == 4096
    assert p.st.VECTOR_MAX_REQUEST_SIZE == 32 * 1024 * 1024


def test_border_ids_scan_and_count(p):
    raw, engine, storage = p.mono()
    region = p.region(p.definition(id_lo=5, id_hi=101))
    x = rand(20)
    ids = (np.arange(20, dtype=np.int64) + 1) * 5
    storage.vector_add(region, ids, x)
    with pytest.raises(p.base.InvalidParameter):    # outside the window
        storage.vector_add(region, np.asarray([101], np.int64), x[:1])
    assert storage.vector_get_border_id(region, get_min=True) == 5
    assert storage.vector_get_border_id(region, get_min=False) == 100
    rows = storage.vector_scan_query(region, start_id=50, limit=3)
    assert [r.id for r in rows] == [50, 55, 60]
    assert storage.vector_count(region) == 20
    res = storage.vector_batch_search(region, x[-1:], 1)
    assert res[0][0].id == 100


def test_kv_surface(p):
    raw, engine, storage = p.mono()
    region = p.region(p.definition())
    storage.kv_put(region, [(b"a", b"1"), (b"b", b"2")])
    assert storage.kv_get(region, b"a") == b"1"
    assert storage.kv_put_if_absent(region, [(b"a", b"X"), (b"c", b"3")]) \
        == [False, True]
    assert storage.kv_compare_and_set(region, b"b", b"2", b"20")
    assert not storage.kv_compare_and_set(region, b"b", b"2", b"30")
    storage.kv_batch_delete(region, [b"a"])
    assert storage.kv_get(region, b"a") is None
    assert [k for k, _ in storage.kv_scan(region, b"a", b"z")] == [b"b", b"c"]
    assert storage.kv_delete_range(region, [(b"a", b"z")]) == 2
    assert storage.kv_scan(region, b"a", b"z") == []
    r = p.regm.Region(p.regm.RegionDefinition(
        region_id=88, start_key=b"a", end_key=b"", partition_id=1,
        region_type=p.regm.RegionType.STORE), **p.kw)
    storage.kv_put(r, [(b"a", b"1"), (b"m", b"2"), (b"\xffzz", b"3")])
    assert storage.kv_delete_range(r, [(b"b", b"")]) == 2
    assert storage.kv_get(r, b"a") == b"1"
    assert storage.kv_get(r, b"\xffzz") is None


def test_speedup_cf_pre_filter(p):
    raw, engine, storage = p.mono()
    region = p.region(p.definition(scalar_speedup_keys=("k",)))
    x = rand(60)
    scal = [{"k": i % 3, "wide": "x" * 10} if i % 5 else {"wide": "y"}
            for i in range(60)]
    storage.vector_add(region, np.arange(60, dtype=np.int64), x, scal)
    m = p.reader
    res = storage.vector_batch_search(
        region, x[:1], 60, filter_mode=m.VectorFilterMode.SCALAR,
        filter_type=m.VectorFilterType.QUERY_PRE,
        scalar_filter=p.sf.ScalarFilter.equals({"k": 1}))
    want = sorted(i for i in range(60) if i % 5 and i % 3 == 1)
    assert sorted(v.id for v in res[0]) == want
    narrow = raw.scan(p.raw.CF_VECTOR_SCALAR_SPEEDUP, b"", None)
    assert len(narrow) == 60


def test_rebuild_from_engine_and_meta_recovery(p, tmp_path):
    """The index is a view rebuildable from the engine; region meta
    recovers from the meta CF."""
    path = str(tmp_path / "wal")
    raw = p.raw.WalEngine(path)
    _, engine, storage = p.mono(raw)
    region = p.region(p.definition())
    meta = p.regm.StoreMetaManager(raw, **p.kw)
    meta.add_region(region)
    x = rand(60)
    storage.vector_add(region, np.arange(60, dtype=np.int64), x)
    storage.vector_delete(region, [10, 11])
    raw.close()
    raw2 = p.raw.WalEngine(path)
    _, engine2, storage2 = p.mono(raw2)
    meta2 = p.regm.StoreMetaManager(raw2, **p.kw)
    assert meta2.recover() == 1
    region2 = meta2.get_region(77)
    assert region2.definition.partition_id == 1
    p.manager(raw2).rebuild(region2)
    assert storage2.vector_batch_search(region2, x[:1], 3)[0][0].id == 0
    assert storage2.vector_count(region2) == 58
    assert region2.vector_index_wrapper.get_count() == 58
    raw2.close()


def test_region_serialize_bytes_equal():
    blobs = {}
    for pkg in PKGS:
        q = Pkg(pkg)
        d = q.definition(5, "ivf_flat", peers=SIDS, ncentroids=64)
        d.epoch = q.regm.RegionEpoch(conf_version=2, version=5)
        reg = q.regm.Region(d, **q.kw)
        reg.state = q.regm.RegionState.NORMAL
        blobs[pkg] = reg.serialize()
    assert blobs["dingo_tpu"] == blobs["dingo_tpu_torch"]
    Region = Pkg("dingo_tpu_torch").regm.Region
    got = Region.deserialize(blobs["dingo_tpu"], device="cpu")
    assert got.definition.index_parameter.ncentroids == 64
    assert got.state.value == "normal"


# ---------------- test_index_manager.py, both packages ---------------------

def _mgr_stack(p, index_type="flat"):
    raw, engine, storage = p.mono()
    region = p.region(p.definition(5, index_type, partition=0, ncentroids=4,
                                   default_nprobe=4))
    return raw, storage, region


def test_build_from_scan_and_replay_catchup(p, tmp_path):
    raw, storage, region = _mgr_stack(p)
    x = rand(100, seed=1)
    storage.vector_add(region, np.arange(50, dtype=np.int64), x[:50])
    mgr = p.manager(raw, str(tmp_path))
    index = mgr.build_index(region)
    assert index.get_count() == 50
    assert [r.ids[0] for r in index.search(x[:2], 1)] == [0, 1]
    log = p.rlog.RaftLog()
    wd = p.wd
    for i in range(50, 60):
        log.append(1, wd.encode_write(wd.VectorAddData(
            ts=1, ids=np.asarray([i], np.int64), vectors=x[i:i + 1])))
    log.append(1, wd.encode_write(wd.VectorDeleteData(
        ts=2, ids=np.asarray([0, 1], np.int64))))
    log.append(1, wd.encode_write(wd.VectorAddData(
        ts=3, ids=np.asarray([10], np.int64), vectors=x[10:11])))
    assert mgr.replay_wal(index, region, log, 1, log.last_index()) == 12
    assert index.get_count() == 58
    assert index.apply_log_id == log.last_index()
    assert index.search(x[55][None, :], 1)[0].ids[0] == 55


def test_rebuild_switches_and_trains_ivf(p, tmp_path):
    raw, storage, region = _mgr_stack(p, "ivf_flat")
    x = rand(200, seed=2)
    storage.vector_add(region, np.arange(200, dtype=np.int64), x)
    w = region.vector_index_wrapper
    old = w.own_index
    mgr = p.manager(raw, str(tmp_path))
    assert mgr.rebuild(region, raft_log=p.rlog.RaftLog())
    assert w.own_index is not old and w.own_index.is_trained()
    assert w.own_index.get_count() == 200
    res = w.search(x[:2], 3, nprobe=4)
    assert [r.ids[0] for r in res] == [0, 1]
    if p.name == "dingo_tpu_torch":
        st = mgr.build_stats[region.id]
        assert st["rows"] == 200 and st["train_ms"] > 0
        assert min(st["scan_ms"], st["ingest_ms"]) > 0


def test_save_load_with_replay_and_stale_gap(p, tmp_path):
    raw, storage, region = _mgr_stack(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((80, DIM)).astype(np.float32)
    storage.vector_add(region, np.arange(80, dtype=np.int64), x)
    mgr = p.manager(raw, str(tmp_path))
    assert not mgr.load_index(region)          # no snapshot yet
    mgr.rebuild(region)
    w = region.vector_index_wrapper
    w.apply_log_id = 7
    w.own_index.apply_log_id = 7
    mgr.save_index(region)
    assert w.snapshot_log_id == 7
    log = p.rlog.RaftLog()
    wd = p.wd
    for _ in range(7):
        log.append(1, wd.encode_write(wd.KvPutData(cf="default", ts=1,
                                                   kvs=[])))
    log.append(1, wd.encode_write(wd.VectorAddData(
        ts=2, ids=np.asarray([999], np.int64),
        vectors=rng.standard_normal((1, DIM)).astype(np.float32))))
    region2 = p.regm.Region(region.definition, **p.kw)
    w2 = region2.vector_index_wrapper
    w2.apply_log_id = 8
    assert mgr.load_index(region2, raft_log=log)
    assert w2.own_index.get_count() == 81
    assert w2.own_index.apply_log_id == 8
    gap = p.rlog.RaftLog()
    for _ in range(400):
        gap.append(1, b"x")
    gap.compact(300)
    w.apply_log_id = 400
    with pytest.raises(p.mgr.StaleSnapshot, match="compacted"):
        mgr.load_index(region, raft_log=gap)


def test_scrub_reports_and_acts(p, tmp_path):
    import os

    raw, storage, region = _mgr_stack(p)
    mgr = p.manager(raw, str(tmp_path))
    w = region.vector_index_wrapper
    assert mgr.scrub(region) == {"need_rebuild": False, "need_save": False,
                                 "need_compact": False}
    x = rand(50)
    storage.vector_add(region, np.arange(50, dtype=np.int64), x)
    w.save_write_threshold = 10
    assert mgr.scrub(region, act=True).get("saved") is True
    assert os.path.isdir(mgr.snapshot_path(region.id))
    assert w.write_count == 0
    actions = mgr.scrub(region, act=True)
    assert "saved" not in actions and "rebuilt" not in actions


# ---------------- IndexService bound to a node ----------------------------

def test_index_service_reply_equals_direct_storage_search():
    """Coalesced (pipelined) replies through IndexService(node) equal a
    direct Storage search, and the reader fills stage_us with the device
    wait (kernel) apart from the whole resolve."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.server.services import IndexService
    from dingo_tpu_torch.store.node import MonoStoreNode

    p = Pkg("dingo_tpu_torch")
    node = MonoStoreNode(device="cpu")
    region = node.create_region(p.definition(3, "ivf_flat", ncentroids=8))
    x = clustered(1200, seed=6)
    for i in range(0, 1200, 400):
        node.storage.vector_add(region, np.arange(i, i + 400, dtype=np.int64),
                                x[i:i + 400])
    node.index_manager.rebuild(region)
    q = x[:32] + 0.01
    direct = [node.storage.vector_batch_search(region, q[i:i + 4], 5,
                                               nprobe=4)
              for i in range(0, 32, 4)]
    saved = FLAGS.get("pipeline_enabled")
    FLAGS.set("pipeline_enabled", True)
    svc = IndexService(node, window_ms=20.0, max_batch=64)
    try:
        futs = [svc.submit(3, q[i:i + 4], 5, nprobe=4)
                for i in range(0, 32, 4)]
        got = [f.result(timeout=30) for f in futs]
        stages = svc._get_coalescer().stage_totals()
    finally:
        svc.close()
        FLAGS.set("pipeline_enabled", saved)
    for g, want in zip(got, direct):
        assert ids_of(g) == ids_of(want)
        assert [v.distance for r in g for v in r] == \
            [v.distance for r in want for v in r]
    assert "dispatch" in stages
    assert 0 < stages["kernel"] < stages["resolve"]
    node.stop()


def test_reader_async_fills_stage_split():
    from dingo_tpu_torch.store.node import MonoStoreNode

    p = Pkg("dingo_tpu_torch")
    node = MonoStoreNode(device="cpu")
    region = node.create_region(p.definition(4))
    x = rand(300, seed=7)
    node.storage.vector_add(region, np.arange(300, dtype=np.int64), x)
    stage = {}
    thunk = node.storage.vector_batch_search_async(region, x[:8], 3,
                                                   stage_us=stage)
    rows = thunk()
    assert [r[0].id for r in rows] == list(range(8))
    assert set(stage) == {"prefilter_us", "postfilter_us", "backfill_us",
                          "search_us", "total_us"}
    assert stage["search_us"] <= stage["total_us"]
    node.stop()


# ---------------- carry: a reference region into a port node ---------------

@pytest.mark.parametrize("replicated", [False, True])
def test_region_from_reference(replicated):
    """The JAX package's engine state and region blob, as plain data, go
    into a port node (mono, or the leader of a 3-store cluster), which
    rebuilds the index from its engine: the same search ids."""
    from dingo_tpu_torch.index.carry import region_from_reference
    from dingo_tpu_torch.store.node import MonoStoreNode

    j = Pkg("dingo_tpu")
    raw, _, storage = j.mono()
    region = j.region(j.definition(12, "ivf_flat", ncentroids=8,
                                   peers=SIDS))
    x = clustered(800, seed=10)
    storage.vector_add(region, np.arange(800, dtype=np.int64), x,
                       [{"n": i} for i in range(800)])
    storage.vector_delete(region, list(range(0, 800, 9)))
    j.manager(raw).rebuild(region)
    q = x[1:9] + 0.02
    want = storage.vector_batch_search(region, q, 10, nprobe=8)
    state, blob = raw.snapshot_state(), region.serialize()
    t = Pkg("dingo_tpu_torch")
    if replicated:
        # every store hosts the region's raft member first; the leader
        # proposes the install
        c = Cluster(t, "ivf_flat", region_id=12, ncentroids=8)
        try:
            treg = c.on_leader(
                lambda n, r: region_from_reference(n, state, blob))
            c.settle()
            for sid in SIDS:
                reg = c.nodes[sid].get_region(12)
                assert reg.vector_index_wrapper.own_index.is_trained()
                got = c.nodes[sid].storage.vector_batch_search(
                    reg, q, 10, nprobe=8)
                assert_same_rows(want, got)
            assert treg.id == 12
        finally:
            c.stop()
        return
    node = MonoStoreNode(device="cpu")
    treg = region_from_reference(node, state, blob)
    got = node.storage.vector_batch_search(treg, q, 10, nprobe=8)
    assert_same_rows(want, got)
    assert node.storage.vector_count(treg) == storage.vector_count(region)
    node.stop()


# ---------------- NotPorted: unported features fail loudly -----------------

def test_not_ported_raise_sites():
    from dingo_tpu_torch.index.base import (
        IndexParameter,
        IndexType,
        InvalidParameter,
    )
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.flat import TpuBinaryFlat, TpuFlat
    from dingo_tpu_torch.index.ivf_flat import TpuBinaryIvfFlat, TpuIvfFlat
    from dingo_tpu_torch.ops.distance import Metric

    with pytest.raises(NotPorted, match="gRPC"):    # factory.py
        new_index(1, IndexParameter(index_type=IndexType.DISKANN,
                                    dimension=8), device="cpu")
    # HAMMING is ported: the FLAT constructor takes it as the JAX
    # package's does, the binary families build, and a plain IVF_FLAT
    # refuses it as the JAX package's does
    assert TpuFlat(1, IndexParameter(dimension=8, metric=Metric.HAMMING),
                   device="cpu").metric is Metric.HAMMING
    for itype, cls in ((IndexType.BINARY_FLAT, TpuBinaryFlat),
                       (IndexType.BINARY_IVF_FLAT, TpuBinaryIvfFlat)):
        param = IndexParameter(index_type=itype, dimension=8,
                               metric=Metric.HAMMING, ncentroids=2)
        assert isinstance(new_index(1, param, device="cpu"), cls)
    with pytest.raises(InvalidParameter):
        TpuIvfFlat(1, IndexParameter(index_type=IndexType.IVF_FLAT,
                                     dimension=8, metric=Metric.HAMMING),
                   device="cpu")
    with pytest.raises(NotPorted):                  # base.py
        new_index(1, IndexParameter(dimension=8, dtype="int8"), device="cpu")
    assert not issubclass(NotPorted, NotSupported)


def test_not_ported_stubs_of_this_slice():
    from dingo_tpu_torch.store.node import StoreNode

    p = Pkg("dingo_tpu_torch")
    raw, engine, storage = p.mono()
    region = p.region(p.definition())
    wd = p.wd
    # split and merge apply through a StoreNode's handlers: a mono engine
    # has none and raises what the JAX package raises
    for data in (wd.SplitRegionData(child_region_id=2, split_key=b"x"),
                 wd.MergeRegionData(source_region_id=2, source_end_key=b"")):
        with pytest.raises(NotImplementedError):
            engine.write(region, data)
    for data in (wd.DocumentAddData(ts=1, ids=[1], documents=[{}]),
                 wd.DocumentDeleteData(ts=1, ids=[1]),
                 wd.TxnRaftData(puts=[], deletes=[])):
        with pytest.raises(NotPorted):
            engine.write(region, data)
    with pytest.raises(NotPorted):                  # TABLE filter
        storage.vector_batch_search(
            region, rand(1), 1,
            filter_mode=p.reader.VectorFilterMode.TABLE)
    with pytest.raises(NotPorted):                  # DOCUMENT region
        p.regm.Region(p.regm.RegionDefinition(
            region_id=3, start_key=b"a", end_key=b"b",
            region_type=p.regm.RegionType.DOCUMENT), device="cpu")
    # a binary region's reader is ported: it reads packed uint8 rows
    bin_def = p.definition(index_type="binary_flat", dimension=64,
                           metric=p.dist.Metric.HAMMING)
    bin_region = p.region(bin_def)
    reader = engine.new_vector_reader(bin_region)
    assert reader._binary and reader._query_dtype() is np.uint8
    rows = np.arange(16, dtype=np.uint8).reshape(2, 8)
    storage.vector_add(bin_region, np.arange(2, dtype=np.int64), rows)
    got = storage.vector_batch_search(bin_region, rows[1], 2)
    assert [(v.id, v.distance) for v in got[0]][0] == (1, 0.0)
    assert storage.vector_batch_query(bin_region, [0])[0].vector.tolist() \
        == rows[0].tolist()
    # the control plane is ported: a node takes a coordinator, and only
    # the gRPC snapshot pull is left
    transport = p.raft.LocalTransport()
    node = StoreNode("s9", transport, device="cpu")
    try:
        assert node.heartbeat_once() == []          # no coordinator
        with pytest.raises(NotPorted):
            node.pull_vector_index_snapshot(1, "localhost:1")
    finally:
        node.stop()


def test_reader_falls_back_only_on_not_supported():
    """NotSupported / NotTrained take the brute-force scan; NotPorted (an
    unported feature) propagates instead of becoming a scan."""
    p = Pkg("dingo_tpu_torch")
    raw, engine, storage = p.mono()
    region = p.region(p.definition())
    x = rand(40, seed=11)
    storage.vector_add(region, np.arange(40, dtype=np.int64), x)
    w = region.vector_index_wrapper
    scans = []
    reader_cls = p.reader.VectorReader
    orig = reader_cls._brute_force_search

    def spy(self, *a, **kw):
        scans.append(1)
        return orig(self, *a, **kw)

    reader_cls._brute_force_search = spy
    try:
        for exc, falls_back in ((NotSupported, True), (NotPorted, False)):
            def boom(*a, exc=exc, **kw):
                raise exc("x")

            w.search = boom
            if falls_back:
                res = storage.vector_batch_search(region, x[:2], 1)
                assert [r[0].id for r in res] == [0, 1]
            else:
                with pytest.raises(NotPorted):
                    storage.vector_batch_search(region, x[:2], 1)
        assert len(scans) == 1
    finally:
        reader_cls._brute_force_search = orig


# ---------------- device=None means CUDA ------------------------------------

def test_region_entry_points_default_to_cuda(monkeypatch):
    """Without a card, every region entry point's device=None raises
    DeviceUnavailable: nothing falls back to the CPU."""
    from dingo_tpu_torch.engine.mono_engine import MonoStoreEngine
    from dingo_tpu_torch.engine.raft_engine import RaftStoreEngine
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.index.manager import VectorIndexManager
    from dingo_tpu_torch.index.vector_reader import ReaderContext, VectorReader
    from dingo_tpu_torch.raft import LocalTransport
    from dingo_tpu_torch.store.node import MonoStoreNode, StoreNode
    from dingo_tpu_torch.store.region import Region

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = Pkg("dingo_tpu_torch")
    d = p.definition()
    ctx = ReaderContext(region_id=1, partition_id=1, start_key=d.start_key,
                        end_key=d.end_key, index_wrapper=None,
                        engine=MemEngine(), parameter=d.index_parameter)
    for make in (lambda: StoreNode("s0", LocalTransport()),
                 lambda: MonoStoreNode(),
                 lambda: RaftStoreEngine(MemEngine(), "s0", LocalTransport()),
                 lambda: MonoStoreEngine(MemEngine()),
                 lambda: Region(d),
                 lambda: VectorIndexManager(MemEngine()),
                 lambda: VectorReader(ctx)):
        with pytest.raises(DeviceUnavailable):
            make()


def test_rebuild_and_brute_force_scan_the_engine_once():
    """The index build and the brute-force search page the region from one
    engine scan (pages of at most BUILD_BATCH / BRUTEFORCE_BATCH rows, in
    id order, deletes skipped), with the rows vector_scan_query returns."""
    from dingo_tpu_torch.index import manager as tmgr
    from dingo_tpu_torch.index import vector_reader as trd

    p = Pkg("dingo_tpu_torch")
    raw, engine, storage = p.mono()
    region = p.region(p.definition(index_type="ivf_flat"))
    x = rand(700, seed=12)
    storage.vector_add(region, np.arange(700, dtype=np.int64) * 3, x)
    storage.vector_delete(region, [0, 30, 2097])
    reader = engine.new_vector_reader(region)
    want = reader.vector_scan_query(0, limit=10_000, with_vector_data=True)
    pages = list(reader.scan_pages(256))
    assert [len(i) for i, _ in pages] == [256, 256, 185]
    assert np.concatenate([i for i, _ in pages]).tolist() == \
        [r.id for r in want]
    assert np.array_equal(np.concatenate([v for _, v in pages]),
                          np.stack([r.vector for r in want]))
    scans = []
    orig = raw.scan

    def counting(cf, start=b"", end=None):
        scans.append(cf)
        return orig(cf, start, end)

    raw.scan = counting
    saved = (tmgr.BUILD_BATCH, trd.BRUTEFORCE_BATCH)
    tmgr.BUILD_BATCH = trd.BRUTEFORCE_BATCH = 64
    try:
        res = storage.vector_batch_search(region, x[5:7], 1)
        assert [r[0].id for r in res] == [15, 18]
        assert scans == ["default"]
        p.manager(raw).rebuild(region)
        assert scans == ["default", "default"]
    finally:
        tmgr.BUILD_BATCH, trd.BRUTEFORCE_BATCH = saved
    assert region.vector_index_wrapper.get_count() == 697
