"""The store role's gRPC front end of the port against the JAX package's:
two clusters side by side, each an in-process CoordinatorControl and
three StoreNodes on one LocalTransport, every node hosted by its
package's DingoServer on a free port. Regions are created in process;
the same requests go to both clusters through gRPC channels and the
replies are compared field by field: error codes equal, distances
within rtol 1e-5 of the row's scale (its largest distance) and ids equal
modulo ties at that tolerance.

The cases are those of tests/test_grpc_server.py that need no client
SDK or coordinator server, the gRPC cases that test_coprocessor_v2.py,
test_document_region_gc.py, test_document_typed.py and
test_snapshot_transfer_expr.py drive, and the slice's acceptance case
at d 768 (VectorAdd 2,048 rows, VectorBuild IVF_FLAT nlist 8,
VectorSearch 64 queries k 10), also across the wire: each package's
ServiceStub against the other's server. The port's nodes run on the
CPU (``device="cpu"``). Every wait polls against a deadline; the
fixtures close their channels, servers and nodes.
"""

import importlib
import json
import time

import grpc
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
SIDS = ("s0", "s1", "s2")
RTOL = 1e-5


class Pkg:
    """One package's modules of the store role and its gRPC surface; the
    port's constructors get ``device="cpu"``."""

    MODS = {"control": "coordinator.control", "tso": "coordinator.tso",
            "raw": "engine.raw_engine", "raft": "raft", "node": "store.node",
            "region": "store.region", "vcodec": "index.codec",
            "base": "index.base",
            "rpc": "server.rpc", "gt": "raft.grpc_transport",
            "convert": "server.convert"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    def param(self, index_type="flat", dimension=16, **kw):
        b = self.base
        return b.IndexParameter(index_type=b.IndexType(index_type),
                                dimension=dimension, **kw)


PB = importlib.import_module("dingo_tpu_torch.server.dingo_pb2")
WIRE = importlib.import_module("dingo_tpu_torch.raft.wire")


def wait_for(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    assert cond(), f"timed out waiting for {what}"


class GrpcCluster:
    """One package's cluster: `n` StoreNodes on one LocalTransport (or,
    with ``grpc_raft``, each on its own GrpcRaftTransport through the
    servers' RaftService), heartbeating to an in-process coordinator (or,
    without ``heartbeat``, registered with it by one beat) and each hosted
    by a DingoServer."""

    def __init__(self, name, n=3, replication=3, grpc_raft=False,
                 heartbeat=True):
        p = self.p = Pkg(name)
        self.control = p.control.CoordinatorControl(
            p.raw.MemEngine(), replication=replication)
        self.tso = p.tso.TsoControl(p.raw.MemEngine())
        self.sids = SIDS[:n]
        shared = None if grpc_raft else p.raft.LocalTransport()
        self.transports, self.nodes, self.servers = {}, {}, {}
        self.addrs, self.channels, self._stubs = {}, {}, {}
        for i, sid in enumerate(self.sids):
            t = shared or p.gt.GrpcRaftTransport(sid)
            node = p.node.StoreNode(sid, t, self.control,
                                    raft_kw={"seed": i}, **p.kw)
            srv = p.rpc.DingoServer()
            srv.host_store_role(node)
            port = srv.start()
            self.transports[sid] = t
            self.nodes[sid] = node
            self.servers[sid] = srv
            self.addrs[sid] = f"127.0.0.1:{port}"
            self.channels[sid] = grpc.insecure_channel(self.addrs[sid])
        if grpc_raft:
            for t in self.transports.values():
                for sid, addr in self.addrs.items():
                    t.set_peer(sid, addr)
        for node in self.nodes.values():
            if heartbeat:
                node.start_heartbeat(0.1)
            else:
                self.control.store_heartbeat(node.store_id)

    def stub(self, sid, service):
        key = (sid, service)
        if key not in self._stubs:
            self._stubs[key] = self.p.rpc.ServiceStub(self.channels[sid],
                                                      service)
        return self._stubs[key]

    def create(self, kind="index", start=None, end=None, dimension=16,
               index_type="flat", replication=None, schema=None, **pkw):
        """A region created in process; returns its id once every peer
        holds it and one of them leads it."""
        p = self.p
        rt = p.region.RegionType
        kw = {"replication": replication}
        if kind == "kv":
            kw.update(start_key=start, end_key=end)
        else:
            lo, hi = start or 0, end or (1 << 40)
            kw.update(start_key=p.vcodec.encode_vector_key(0, lo),
                      end_key=p.vcodec.encode_vector_key(0, hi))
        if kind == "index":
            kw.update(region_type=rt.INDEX, index_parameter=p.param(
                index_type, dimension, **pkw))
        elif kind == "document":
            kw.update(region_type=rt.DOCUMENT, document_schema=schema)
        d = self.control.create_region(**kw)
        wait_for(lambda: all(self.nodes[s].get_region(d.region_id)
                             is not None for s in d.peers),
                 what="CREATE on every peer")
        self.leader(d.region_id)
        return d.region_id

    def raft(self, sid, rid):
        return self.nodes[sid].engine.get_node(rid)

    def leader(self, rid, timeout=10.0):
        found = []

        def one():
            found[:] = [s for s in self.sids
                        if (r := self.raft(s, rid)) is not None
                        and r.is_leader()]
            return len(found) == 1

        wait_for(one, timeout, what=f"a leader of region {rid}")
        return found[0]

    def followers(self, rid):
        lead = self.leader(rid)
        return [s for s in self.sids
                if s != lead and self.raft(s, rid) is not None]

    def settle(self, rid):
        """Every replica has applied the leader's commit index."""
        target = self.raft(self.leader(rid), rid).commit_index
        wait_for(lambda: all(self.raft(s, rid).last_applied >= target
                             for s in self.sids
                             if self.raft(s, rid) is not None),
                 what="replicas applying the commit index")

    def call(self, rid, service, method, req, timeout=10.0):
        """`method` on the region's leader, retried while leadership moves
        (20001 is the not-leader answer)."""
        deadline = time.monotonic() + timeout
        while True:
            sid = self.leader(rid)
            resp = getattr(self.stub(sid, service), method)(req, timeout=30)
            code = getattr(getattr(resp, "error", None), "errcode", 0)
            if code != 20001 or time.monotonic() > deadline:
                return resp
            time.sleep(0.05)

    def close(self):
        for ch in self.channels.values():
            ch.close()
        for srv in self.servers.values():
            srv.stop()
        for node in self.nodes.values():
            node.stop()
        for t in set(self.transports.values()):
            if hasattr(t, "close"):
                t.close()


class Pair:
    """The JAX package's cluster and the port's, driven alike."""

    def __init__(self, **kw):
        self.c = {}
        try:
            for name in PKGS:
                self.c[name] = GrpcCluster(name, **kw)
        except Exception:
            self.close()
            raise

    @property
    def ref(self):
        return self.c["dingo_tpu"]

    @property
    def port(self):
        return self.c["dingo_tpu_torch"]

    def create(self, **kw):
        return {name: c.create(**kw) for name, c in self.c.items()}

    def call(self, rids, service, method, build, **kw):
        """build(region_id) -> request, sent to each cluster's leader;
        returns {package: reply}."""
        return {name: c.call(rids[name], service, method,
                             build(rids[name]), **kw)
                for name, c in self.c.items()}

    def close(self):
        for c in self.c.values():
            c.close()


@pytest.fixture(scope="module")
def pair():
    pr = Pair()
    yield pr
    pr.close()


# ---------------- comparisons ------------------------------------------------

def hits(result):
    return ([r.vector.id for r in result.results],
            np.asarray([r.distance for r in result.results], np.float64))


def assert_same_search(a, b, rtol=RTOL):
    """Equal error codes and, per query, distances within rtol of the
    row's scale and ids equal modulo ties at that tolerance (a differing
    id sits next to a distance equal to its own). The scale is the row's
    largest |distance| (at least 10): an L2 distance is ||q||^2 - 2 q.x +
    ||x||^2, whose rounding is that of its terms, so a near-0 self-match
    carries the absolute error of its neighbours' distances."""
    assert a.error.errcode == b.error.errcode, (a.error, b.error)
    assert len(a.batch_results) == len(b.batch_results)
    for ra, rb in zip(a.batch_results, b.batch_results):
        ia, da = hits(ra)
        ib, db = hits(rb)
        assert len(ia) == len(ib), (ia, ib)
        tol = rtol * max([10.0, *np.abs(da)])
        np.testing.assert_allclose(db, da, rtol=0, atol=tol)
        for c in (k for k in range(len(ia)) if ia[k] != ib[k]):
            near = [db[c2] for c2 in (c - 1, c + 1) if 0 <= c2 < len(db)]
            assert any(abs(db[c] - v) <= tol for v in near), \
                (c, ia, ib, da, db)


def plain(msg, drop=()):
    """A reply with the fields that legitimately differ (timestamps,
    log ids) cleared, for whole-message equality."""
    out = type(msg)()
    out.CopyFrom(msg)
    for f in drop:
        out.ClearField(f)
    return out


def assert_same(replies, drop=()):
    a, b = (plain(replies[n], drop) for n in PKGS)
    assert a == b, (a, b)


def vector_add_req(rid, ids, x, scalars=None, table=None):
    req = PB.VectorAddRequest()
    req.context.region_id = rid
    for j, vid in enumerate(ids):
        v = req.vectors.add()
        v.vector.id = int(vid)
        v.vector.values.extend(x[j].tolist())
        for k, val in (scalars[j] if scalars else {}).items():
            e = v.scalar_data.add()
            e.key = k
            e.value = WIRE.encode_obj(val)
        if table is not None:
            v.table_data = table[j]
    return req


def search_req(rid, q, topn, **param):
    req = PB.VectorSearchRequest()
    req.context.region_id = rid
    for row in q:
        req.vectors.add().values.extend(row.tolist())
    req.parameter.top_n = topn
    for k, v in param.items():
        if k == "coprocessor":
            req.parameter.coprocessor.CopyFrom(v)
        else:
            setattr(req.parameter, k, v)
    return req


def add_rows(pair, rids, ids, x, batch=512, **kw):
    for i in range(0, len(ids), batch):
        r = pair.call(rids, "IndexService", "VectorAdd",
                      lambda rid: vector_add_req(
                          rid, ids[i:i + batch], x[i:i + batch],
                          **{k: v[i:i + batch] for k, v in kw.items()}))
        for name in PKGS:
            assert r[name].error.errcode == 0, (name, r[name].error)


def rand(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def test_message_classes_are_shared():
    """Both packages' modules hold the same serialized file and the
    same message classes: the bytes a stub sends are one format."""
    ref = importlib.import_module("dingo_tpu.server.dingo_pb2")
    port = importlib.import_module("dingo_tpu_torch.server.dingo_pb2")
    assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    assert port.VectorSearchRequest is ref.VectorSearchRequest
    assert Pkg("dingo_tpu_torch").rpc.PROTO_PACKAGE == \
        ref.DESCRIPTOR.package
    jax_schema = Pkg("dingo_tpu").rpc.SERVICE_SCHEMA
    for svc, methods in Pkg("dingo_tpu_torch").rpc.SERVICE_SCHEMA.items():
        assert methods == jax_schema[svc], svc


# ---------------- IndexService -----------------------------------------------

def test_index_lifecycle_rpcs(pair):
    """VectorStatus / CountMemory / GetRegionMetrics / Dump / Reset /
    Build on a FLAT region, then a search: the same replies."""
    rids = pair.create(index_type="flat", dimension=16, start=0,
                       end=1 << 30)
    x = rand(40, 16, 0)
    add_rows(pair, rids, list(range(40)), x)

    def call(method, req_t):
        def build(rid):
            req = req_t()
            req.context.region_id = rid
            return req
        return pair.call(rids, "IndexService", method, build)

    st = call("VectorStatus", PB.VectorStatusRequest)
    for name in PKGS:
        s = st[name]
        assert s.error.errcode == 0 and s.ready and s.count == 40, name
        assert s.index_type == "flat" and s.apply_log_id > 0, name
    assert_same(st, drop=("apply_log_id", "snapshot_log_id"))
    cm = call("VectorCountMemory", PB.VectorCountMemoryRequest)
    assert all(cm[n].bytes > 0 for n in PKGS)
    rm = call("VectorGetRegionMetrics", PB.VectorGetRegionMetricsRequest)
    assert rm["dingo_tpu"].vector_count == 40
    assert rm["dingo_tpu"].min_id == 0 and rm["dingo_tpu"].max_id == 39
    assert rm["dingo_tpu"].region_state == "normal"
    assert_same(rm, drop=("memory_bytes",))
    dump = call("VectorDump", PB.VectorDumpRequest)
    parsed = {n: json.loads(dump[n].json) for n in PKGS}
    for n in PKGS:
        assert parsed[n]["count"] == 40 and parsed[n]["ready"] is True
    assert sorted(parsed["dingo_tpu"]) == sorted(parsed["dingo_tpu_torch"])
    for key in ("region_id", "count", "ready", "trained", "index_type"):
        assert parsed["dingo_tpu"][key] == parsed["dingo_tpu_torch"][key]
    # reset drops the view and rebuilds it from the engine
    for method, req_t in (("VectorReset", PB.VectorResetRequest),
                          ("VectorBuild", PB.VectorBuildRequest)):
        r = call(method, req_t)
        assert all(r[n].error.errcode == 0 for n in PKGS), method
        st = call("VectorStatus", PB.VectorStatusRequest)
        assert all(st[n].ready and st[n].count == 40 for n in PKGS)
    res = pair.call(rids, "IndexService", "VectorSearch",
                    lambda rid: search_req(rid, x[:2], 3))
    assert [r.results[0].vector.id for r in
            res["dingo_tpu_torch"].batch_results] == [0, 1]
    assert_same_search(res["dingo_tpu"], res["dingo_tpu_torch"])


def test_vector_rpcs_match(pair, tmp_path):
    """VectorImport, VectorDelete, VectorBatchQuery, VectorGetBorderId,
    VectorScanQuery, VectorCount and VectorLoad (no snapshot),
    plus the region guards (10001 unknown region, 10002 epoch, 70001 on
    a region without an index)."""
    rids = pair.create(index_type="flat", dimension=8, start=1 << 30,
                       end=1 << 31)
    base = 1 << 30
    x = rand(30, 8, 1)
    ids = [base + i for i in range(30)]
    add_rows(pair, rids, ids, x, scalars=[{"i": i} for i in range(30)])

    def imp(rid):
        req = PB.VectorImportRequest()
        req.context.region_id = rid
        for j in range(3):
            v = req.vectors.add()
            v.vector.id = base + 40 + j
            v.vector.values.extend(x[j].tolist())
        req.delete_ids.extend([base + 1, base + 2])
        return req

    r = pair.call(rids, "IndexService", "VectorImport", imp)
    assert r["dingo_tpu_torch"].added == 3
    assert_same(r, drop=("ts",))

    def delete(rid):
        req = PB.VectorDeleteRequest()
        req.context.region_id = rid
        req.ids.extend([base + 3, base + 999])
        return req

    assert_same(pair.call(rids, "IndexService", "VectorDelete", delete))
    for name, c in pair.c.items():
        c.settle(rids[name])

    def batch_query(rid):
        req = PB.VectorBatchQueryRequest(with_vector_data=True,
                                         with_scalar_data=True)
        req.context.region_id = rid
        req.vector_ids.extend([base, base + 1, base + 5, base + 41])
        return req

    bq = pair.call(rids, "IndexService", "VectorBatchQuery", batch_query)
    assert [v.vector.id for v in bq["dingo_tpu_torch"].vectors] == \
        [base, -1, base + 5, base + 41]
    assert_same(bq)
    for get_min in (True, False):
        def border(rid, get_min=get_min):
            req = PB.VectorGetBorderIdRequest(get_min=get_min)
            req.context.region_id = rid
            return req
        assert_same(pair.call(rids, "IndexService", "VectorGetBorderId",
                              border))
    for rev in (False, True):
        def scan(rid, rev=rev):
            req = PB.VectorScanQueryRequest(
                vector_id_start=base + 4, max_scan_count=5, is_reverse=rev,
                with_vector_data=True, with_scalar_data=True)
            req.context.region_id = rid
            if rev:
                req.vector_id_start = base + 20
            return req
        sq = pair.call(rids, "IndexService", "VectorScanQuery", scan)
        assert len(sq["dingo_tpu_torch"].vectors) == 5
        assert_same(sq)

    def count(rid):
        req = PB.VectorCountRequest()
        req.context.region_id = rid
        return req

    cnt = pair.call(rids, "IndexService", "VectorCount", count)
    assert cnt["dingo_tpu_torch"].count == 30 + 3 - 3
    assert_same(cnt)

    def load(rid, path=""):
        req = PB.VectorLoadRequest(path=path)
        req.context.region_id = rid
        return req

    # a missing snapshot: 70003; no snapshot root at all: the manager's
    # assertion, answered in-band by the generic handler
    ld = pair.call(rids, "IndexService", "VectorLoad",
                   lambda rid: load(rid, str(tmp_path / "none")))
    assert ld["dingo_tpu_torch"].error.errcode == 70003
    assert_same(ld)
    ld = pair.call(rids, "IndexService", "VectorLoad", load)
    assert ld["dingo_tpu_torch"].error.errcode == 99999
    assert_same(ld)
    # the guards, straight at one store of each cluster
    kv = pair.create(kind="kv", start=b"lc", end=b"ld")
    for make, code in ((lambda rid: 987654, 10001),
                       (lambda rid: rid, 10002)):
        got = {}
        for name, c in pair.c.items():
            req = PB.VectorCountRequest()
            req.context.region_id = make(rids[name])
            if code == 10002:
                req.context.region_epoch.version = 99
            got[name] = c.stub(c.leader(rids[name]),
                               "IndexService").VectorCount(req)
        assert got["dingo_tpu_torch"].error.errcode == code
        assert_same(got)
    st = pair.call(kv, "IndexService", "VectorStatus",
                   lambda rid: PB.VectorStatusRequest(
                       context=PB.Context(region_id=rid)))
    assert st["dingo_tpu_torch"].error.errcode == 70001
    assert_same(st)


def test_vector_search_debug_stage_timings(pair):
    """VectorSearchDebug: the same hits and the same stage fields, each
    package's search and total stages > 0 and the stages within the
    total."""
    rids = pair.create(index_type="flat", dimension=16, start=1 << 31,
                       end=1 << 32)
    x = rand(50, 16, 0)
    add_rows(pair, rids, [(1 << 31) + i for i in range(50)], x)

    def build(rid):
        req = PB.VectorSearchDebugRequest()
        req.context.region_id = rid
        req.vectors.add().values.extend([0.1] * 16)
        req.parameter.top_n = 3
        return req

    got = pair.call(rids, "IndexService", "VectorSearchDebug", build)
    assert_same_search(got["dingo_tpu"], got["dingo_tpu_torch"])
    stages = ("prefilter_us", "search_us", "postfilter_us", "backfill_us")
    for name in PKGS:
        r = got[name]
        assert len(r.batch_results[0].results) == 3
        assert r.total_us > 0 and r.search_us > 0, name
        assert r.total_us >= sum(getattr(r, s) for s in stages), name
    fields = [f.name for f in got["dingo_tpu_torch"].DESCRIPTOR.fields]
    assert set(stages) | {"total_us"} <= set(fields)


def test_range_search_over_grpc(pair):
    """radius > 0 takes the range arm: both packages answer the hits
    within the radius, at most top_n of them."""
    rids = pair.create(index_type="flat", dimension=16, start=1 << 32,
                       end=1 << 33)
    x = rand(200, 16, 2)
    add_rows(pair, rids, [(1 << 32) + i for i in range(200)], x)
    q = rand(1, 16, 3)
    full = pair.call(rids, "IndexService", "VectorSearch",
                     lambda rid: search_req(rid, q, 20))
    assert_same_search(full["dingo_tpu"], full["dingo_tpu_torch"])
    radius = full["dingo_tpu"].batch_results[0].results[4].distance
    got = pair.call(rids, "IndexService", "VectorSearch",
                    lambda rid: search_req(rid, q, 10, radius=radius))
    assert_same_search(got["dingo_tpu"], got["dingo_tpu_torch"])
    ids, dist = hits(got["dingo_tpu_torch"].batch_results[0])
    assert 0 < len(ids) <= 10
    assert all(d <= radius + 1e-4 for d in dist)


def test_table_filter_over_grpc(pair):
    """TABLE coprocessor filter over the wire: rows ride VectorAdd's
    table_data, the search parameter carries a pb.Coprocessor; pre and
    post variants answer the same hits in both packages."""
    serial = importlib.import_module(
        "dingo_tpu_torch.coprocessor.coprocessor_v2")
    lo = 1 << 33
    rids = pair.create(index_type="flat", dimension=16, start=lo,
                       end=1 << 34)
    x = rand(120, 16, 5)
    rows = [["eng" if i % 4 == 0 else "ops", float(i)] for i in range(120)]
    add_rows(pair, rids, [lo + i for i in range(120)], x,
             table=[serial.encode_row(r) for r in rows])
    cop = PB.Coprocessor()
    for i, (name, t) in enumerate((("dept", "VARCHAR"), ("rank", "DOUBLE"))):
        col = cop.original_schema.add()
        col.name, col.sql_type, col.index = name, t, i
    cop.filter_expr = WIRE.encode(
        ["eq", ["field", "dept"], ["const", "eng"]])
    for ftype, q, topn in ((PB.QUERY_PRE, x[:4], 8),
                           (PB.QUERY_POST, x[4:6], 5)):
        got = pair.call(rids, "IndexService", "VectorSearch",
                        lambda rid: search_req(
                            rid, q, topn, filter=PB.TABLE_FILTER,
                            filter_type=ftype, coprocessor=cop))
        assert_same_search(got["dingo_tpu"], got["dingo_tpu_torch"])
        for r in got["dingo_tpu_torch"].batch_results:
            assert all((v.vector.id - lo) % 4 == 0 for v in r.results)
        if ftype == PB.QUERY_PRE:
            first = got["dingo_tpu_torch"].batch_results[0].results[0]
            assert first.vector.id == lo


def test_failpoint_injects_into_write_path(pair):
    """A panic failpoint armed through DebugService answers the next
    VectorAdd in-band (99999, the failpoint named), then disarms."""
    lo = 1 << 34
    rids = pair.create(index_type="flat", dimension=16, start=lo,
                       end=1 << 35)
    for name, c in pair.c.items():
        sid = c.leader(rids[name])
        dbg = c.stub(sid, "DebugService")
        assert dbg.FailPoint(PB.FailPointRequest(
            name="before_vector_add", config="100%1*panic")).error.errcode \
            == 0
        req = vector_add_req(rids[name], [lo + 123], np.zeros((1, 16),
                                                              np.float32))
        idx = c.stub(sid, "IndexService")
        resp = idx.VectorAdd(req)
        assert resp.error.errcode == 99999, name
        assert "failpoint" in resp.error.errmsg, name
        assert idx.VectorAdd(req).error.errcode == 0, name
        assert dbg.FailPoint(PB.FailPointRequest(
            name="before_vector_add", remove=True)).error.errcode == 0
        bad = dbg.FailPoint(PB.FailPointRequest(name="x", config="bogus!"))
        assert bad.error.errcode == 50001, name


def test_calc_distance_util(pair):
    """UtilService.VectorCalcDistance, all three metrics, against the
    JAX package's (f32, rtol 1e-5); empty operands are 30001."""
    q, x = rand(3, 12, 7), rand(5, 12, 8)
    for metric in (PB.METRIC_TYPE_L2, PB.METRIC_TYPE_INNER_PRODUCT,
                   PB.METRIC_TYPE_COSINE):
        req = PB.VectorCalcDistanceRequest(metric_type=metric)
        for row in q:
            req.op_left_vectors.add().values.extend(row.tolist())
        for row in x:
            req.op_right_vectors.add().values.extend(row.tolist())
        got = {n: c.stub("s0", "UtilService").VectorCalcDistance(req)
               for n, c in pair.c.items()}
        mats = {n: np.asarray([list(r.values) for r in got[n].distances])
                for n in PKGS}
        assert mats["dingo_tpu_torch"].shape == (3, 5)
        np.testing.assert_allclose(mats["dingo_tpu_torch"],
                                   mats["dingo_tpu"], rtol=RTOL, atol=1e-6)
    req = PB.VectorCalcDistanceRequest()
    req.op_left_vectors.add().values.extend([1.0, 0.0])
    got = {n: c.stub("s0", "UtilService").VectorCalcDistance(req)
           for n, c in pair.c.items()}
    assert got["dingo_tpu_torch"].error.errcode == 30001
    assert_same(got)
    one = PB.VectorCalcDistanceRequest(metric_type=PB.METRIC_TYPE_L2)
    one.op_left_vectors.add().values.extend([1.0, 0.0])
    one.op_right_vectors.add().values.extend([0.0, 1.0])
    r = pair.port.stub("s0", "UtilService").VectorCalcDistance(one)
    assert r.distances[0].values[0] == pytest.approx(2.0, abs=1e-4)


def test_util_service_resolves_none_to_cuda(monkeypatch):
    """No CPU default: a UtilService without a device is a CUDA one,
    and without a card it raises."""
    from dingo_tpu_torch.common.device import DeviceUnavailable
    from dingo_tpu_torch.server.grpc_services import UtilService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        UtilService()
    assert UtilService("cpu").device == torch.device("cpu")


# ---------------- StoreService KV --------------------------------------------

@pytest.fixture(scope="module")
def kv(pair):
    return pair.create(kind="kv", start=b"u", end=b"w")


def kv_req(req_t, rid, **kw):
    req = req_t(**kw)
    req.context.region_id = rid
    return req


def put(pair, rids, pairs):
    def build(rid):
        req = kv_req(PB.KvBatchPutRequest, rid)
        for k, v in pairs:
            e = req.kvs.add()
            e.key, e.value = k, v
        return req
    r = pair.call(rids, "StoreService", "KvBatchPut", build)
    assert_same(r, drop=("ts",))
    assert r["dingo_tpu_torch"].error.errcode == 0


def get(pair, rids, key):
    r = pair.call(rids, "StoreService", "KvGet",
                  lambda rid: kv_req(PB.KvGetRequest, rid, key=key))
    assert_same(r)
    p = r["dingo_tpu_torch"]
    return p.value if p.found else None


def test_kv_put_if_absent_and_compare_and_set(pair, kv):
    put(pair, kv, [(b"u-cas", b"v1")])

    def pia(atomic, items):
        def build(rid):
            req = kv_req(PB.KvPutIfAbsentRequest, rid, is_atomic=atomic)
            for k, v in items:
                e = req.kvs.add()
                e.key, e.value = k, v
            return req
        r = pair.call(kv, "StoreService", "KvPutIfAbsent", build)
        assert_same(r)
        return list(r["dingo_tpu_torch"].key_states)

    assert pia(False, [(b"u-cas", b"loser"), (b"u-pia-new", b"winner")]) \
        == [False, True]
    assert get(pair, kv, b"u-cas") == b"v1"
    assert get(pair, kv, b"u-pia-new") == b"winner"
    # atomic batch: one existing key poisons the whole batch
    assert pia(True, [(b"u-pia-new", b"x"), (b"u-pia-never", b"x")]) == \
        [False, False]
    assert get(pair, kv, b"u-pia-never") is None

    def cas(rid):
        req = kv_req(PB.KvCompareAndSetRequest, rid, expect_value=b"v1")
        req.kv.key, req.kv.value = b"u-cas", b"v2"
        return req

    for want in (True, False):   # the second expect is stale
        r = pair.call(kv, "StoreService", "KvCompareAndSet", cas)
        assert_same(r)
        assert r["dingo_tpu_torch"].key_state is want
    assert get(pair, kv, b"u-cas") == b"v2"


def test_kv_batch_get_and_delete_range(pair):
    """KvBatchGet / KvDeleteRange with the region-bounds guards (60003
    start >= end, 60004 outside the region) on every KV entry point."""
    rids = pair.create(kind="kv", start=b"dq", end=b"ds")
    put(pair, rids, [(f"dr{i}".encode(), f"v{i}".encode())
                     for i in range(5)])

    def bget(keys):
        def build(rid):
            req = kv_req(PB.KvBatchGetRequest, rid)
            req.keys.extend(keys)
            return req
        r = pair.call(rids, "StoreService", "KvBatchGet", build)
        assert_same(r)
        return r["dingo_tpu_torch"]

    r = bget([b"dr1", b"drMISSING", b"dr3"])
    assert list(r.found) == [True, False, True]
    assert r.kvs[0].value == b"v1" and r.kvs[2].value == b"v3"

    def delete_range(start, end):
        def build(rid):
            req = kv_req(PB.KvDeleteRangeRequest, rid)
            req.range.start_key, req.range.end_key = start, end
            return req
        r = pair.call(rids, "StoreService", "KvDeleteRange", build)
        assert_same(r)
        return r["dingo_tpu_torch"]

    assert delete_range(b"dr1", b"dr4").delete_count == 3
    assert get(pair, rids, b"dr0") == b"v0"
    assert get(pair, rids, b"dr2") is None
    assert get(pair, rids, b"dr4") == b"v4"
    assert delete_range(b"dr1", b"dr4").delete_count == 0
    assert delete_range(b"dq", b"zz").error.errcode == 60004
    assert delete_range(b"dr4", b"dr1").error.errcode == 60003
    outside = []
    for method, build in (
            ("KvBatchPut", lambda rid: kv_req(
                PB.KvBatchPutRequest, rid,
                kvs=[PB.KeyValue(key=b"zz-outside", value=b"x")])),
            ("KvBatchGet", lambda rid: kv_req(
                PB.KvBatchGetRequest, rid, keys=[b"zz-outside"])),
            ("KvPutIfAbsent", lambda rid: kv_req(
                PB.KvPutIfAbsentRequest, rid,
                kvs=[PB.KeyValue(key=b"zz-outside", value=b"x")])),
            ("KvCompareAndSet", lambda rid: kv_req(
                PB.KvCompareAndSetRequest, rid,
                kv=PB.KeyValue(key=b"zz-outside", value=b"x"))),
            ("KvBatchDelete", lambda rid: kv_req(
                PB.KvBatchDeleteRequest, rid, keys=[b"zz-outside"]))):
        r = pair.call(rids, "StoreService", method, build)
        assert_same(r)
        outside.append(r["dingo_tpu_torch"].error.errcode)
        assert "outside region" in r["dingo_tpu_torch"].error.errmsg
    assert outside == [60004] * 5
    # KvBatchDelete inside the region
    r = pair.call(rids, "StoreService", "KvBatchDelete",
                  lambda rid: kv_req(PB.KvBatchDeleteRequest, rid,
                                     keys=[b"dr0"]))
    assert_same(r)
    assert get(pair, rids, b"dr0") is None


def test_kv_reads_leader_gated(pair, kv):
    """A follower answers KV reads with 20001 and the leader hint."""
    put(pair, kv, [(b"u-gate", b"v")])
    got = {}
    for name, c in pair.c.items():
        follower = c.followers(kv[name])[0]
        req = kv_req(PB.KvGetRequest, kv[name], key=b"u-gate")
        got[name] = c.stub(follower, "StoreService").KvGet(req)
        assert got[name].error.errcode == 20001, name
        assert "not leader" in got[name].error.errmsg
    assert get(pair, kv, b"u-gate") == b"v"


def test_scan_with_coprocessor_over_grpc(pair):
    """KvScan carrying a Coprocessor (test_coprocessor_v2.py): the
    filter + projection arm and the grouped COUNT(*) arm; a malformed
    projection expression is 60001."""
    cop2 = importlib.import_module(
        "dingo_tpu_torch.coprocessor.coprocessor_v2")
    schema = [("id", "BIGINT"), ("dept", "VARCHAR"), ("salary", "DOUBLE"),
              ("active", "BOOL")]
    rows = [[1, "eng", 100.0, True], [2, "eng", 150.0, False],
            [3, "ops", 80.0, True], [4, "hr", 90.0, True],
            [5, "ops", 120.0, None]]
    # not under b"r": vector and document keys start with it
    rids = pair.create(kind="kv", start=b"g", end=b"h")
    put(pair, rids, [(b"g/%d" % r[0], cop2.encode_row(r)) for r in rows])

    def scan(fill):
        def build(rid):
            req = kv_req(PB.KvScanRequest, rid)
            req.range.start_key, req.range.end_key = b"g", b"h"
            for i, (name, t) in enumerate(schema):
                col = req.coprocessor.original_schema.add()
                col.name, col.sql_type, col.index = name, t, i
            fill(req.coprocessor)
            return req
        r = pair.call(rids, "StoreService", "KvScan", build)
        assert_same(r)
        return r["dingo_tpu_torch"]

    def filt(c):
        c.selection.extend([0, 2])
        c.filter_expr = WIRE.encode(["gt", ["field", "salary"],
                                     ["const", 95.0]])

    r = scan(filt)
    assert r.error.errcode == 0
    assert [cop2.decode_row(kv.value, 2) for kv in r.kvs] == \
        [[1, 100.0], [2, 150.0], [5, 120.0]]

    def agg(c):
        c.group_by.append(1)
        a = c.aggregations.add()
        a.op, a.column_index = 2, -1   # COUNT(*)

    r = scan(agg)
    counts = {kv.key: cop2.decode_row(kv.value, 1)[0] for kv in r.kvs}
    assert counts[cop2.encode_row(["eng"])] == 2
    assert counts[cop2.encode_row(["ops"])] == 2
    assert counts[cop2.encode_row(["hr"])] == 1

    def malformed(c):
        c.projections.add().expr = WIRE.encode(2)

    assert scan(malformed).error.errcode == 60001


@pytest.mark.parametrize("case", ["test_projection_over_wire_proto",
                                  "test_malformed_projection_expr_rejected"])
def test_coprocessor_wire_cases_through_the_port(case):
    """test_coprocessor_v2.py's wire cases with their imports from the
    port: the port's convert.coprocessor_from_pb builds the engine."""
    from test_torch_coprocessor import port_cases

    mod = port_cases("test_coprocessor_v2.py")
    assert mod.CoprocessorV2.__module__ == \
        "dingo_tpu_torch.coprocessor.coprocessor_v2"
    getattr(mod, case)()


# ---------------- scan sessions ----------------------------------------------

def scan_begin(rid, start, end, page):
    req = kv_req(PB.KvScanBeginRequest, rid, page_size=page)
    req.range.start_key, req.range.end_key = start, end
    return req


def test_scan_sessions_over_grpc(pair):
    """KvScanBegin / Continue page the same keys in both packages; an
    exhausted session is released (10010 after); KvScanRelease."""
    rids = pair.create(kind="kv", start=b"k", end=b"l")
    kvs = [(f"k{i:03d}".encode(), f"v{i}".encode()) for i in range(25)]
    put(pair, rids, kvs)
    pages = {}
    for name, c in pair.c.items():
        sid = c.leader(rids[name])
        stub = c.stub(sid, "StoreService")
        r1 = stub.KvScanBegin(scan_begin(rids[name], b"k", b"l", 10))
        cont = PB.KvScanContinueRequest(scan_id=r1.scan_id)
        r2, r3, r4 = (stub.KvScanContinue(cont) for _ in range(3))
        pages[name] = [(len(r.kvs), r.has_more, r.error.errcode)
                       for r in (r1, r2, r3, r4)]
        got = [kv.key for r in (r1, r2, r3) for kv in r.kvs]
        assert got == [k for k, _ in kvs], name
        r5 = stub.KvScanBegin(scan_begin(rids[name], b"k", b"l", 4))
        assert stub.KvScanRelease(PB.KvScanReleaseRequest(
            scan_id=r5.scan_id)).error.errcode == 0
        assert stub.KvScanContinue(PB.KvScanContinueRequest(
            scan_id=r5.scan_id)).error.errcode == 10010
    assert pages["dingo_tpu_torch"] == [(10, True, 0), (10, True, 0),
                                        (5, False, 0), (0, False, 10010)]
    assert pages["dingo_tpu"] == pages["dingo_tpu_torch"]


def test_scan_snapshot_isolated_from_writes(pair):
    """Pages come from the open-time snapshot though keys are written
    and deleted between pages; the store crontab's scan GC recycles an
    idle session."""
    from dingo_tpu_torch.server.services import _SCAN_SESSIONS

    rids = pair.create(kind="kv", start=b"m", end=b"n")
    put(pair, rids, [(b"m%02d" % i, b"v") for i in range(10)])
    for name, c in pair.c.items():
        sid = c.leader(rids[name])
        stub = c.stub(sid, "StoreService")
        r1 = stub.KvScanBegin(scan_begin(rids[name], b"m", b"n", 4))
        node = c.nodes[sid]
        region = node.get_region(rids[name])
        node.storage.kv_put(region, [(b"m000", b"new")])
        node.storage.kv_batch_delete(region, [b"m07"])
        cont = PB.KvScanContinueRequest(scan_id=r1.scan_id)
        r2, r3 = stub.KvScanContinue(cont), stub.KvScanContinue(cont)
        got = [kv.key for r in (r1, r2, r3) for kv in r.kvs]
        assert got == [b"m%02d" % i for i in range(10)], name
    idle = stub.KvScanBegin(scan_begin(rids["dingo_tpu_torch"], b"m", b"n",
                                       2))
    assert _SCAN_SESSIONS.get(idle.scan_id) is not None
    _SCAN_SESSIONS.get(idle.scan_id).last_active_ms = 0
    assert _SCAN_SESSIONS.recycle_idle() >= 1
    assert _SCAN_SESSIONS.get(idle.scan_id) is None


# ---------------- DocumentService --------------------------------------------

def doc_add(rid, docs, encode):
    req = PB.DocumentAddRequest()
    req.context.region_id = rid
    for did, fields in docs:
        e = req.documents.add()
        e.id = did
        for k, v in fields.items():
            f = e.fields.add()
            f.key, f.value = k, encode(v)
    return req


def test_document_region_over_grpc(pair):
    """test_document_region_gc.py's region over gRPC: add, search with
    fields, count, replication to a follower, delete; a non-DOCUMENT
    region is 80001."""
    rids = pair.create(kind="document", start=0, end=1 << 30)
    docs = [(1, {"text": "tpu raft storage"}),
            (2, {"text": "vector search engine"}),
            (3, {"text": "raft consensus replication"})]
    r = pair.call(rids, "DocumentService", "DocumentAdd",
                  lambda rid: doc_add(rid, docs, WIRE.encode))
    assert_same(r, drop=("ts",))

    def search(rid):
        req = PB.DocumentSearchRequest(query="raft", with_fields=True)
        req.context.region_id = rid
        return req

    s = pair.call(rids, "DocumentService", "DocumentSearch", search)
    assert sorted(d.id for d in s["dingo_tpu_torch"].documents) == [1, 3]
    assert_same(s)
    cnt = pair.call(rids, "DocumentService", "DocumentCount",
                    lambda rid: PB.DocumentCountRequest(
                        context=PB.Context(region_id=rid)))
    assert cnt["dingo_tpu_torch"].count == 3
    assert_same(cnt)
    for name, c in pair.c.items():
        c.settle(rids[name])
        for sid in c.followers(rids[name]):
            reg = c.nodes[sid].get_region(rids[name])
            assert reg.document_index.count() == 3, (name, sid)
    r = pair.call(rids, "DocumentService", "DocumentDelete",
                  lambda rid: PB.DocumentDeleteRequest(
                      context=PB.Context(region_id=rid), ids=[1]))
    assert_same(r)
    s = pair.call(rids, "DocumentService", "DocumentSearch", search)
    assert [d.id for d in s["dingo_tpu_torch"].documents] == [3]
    assert_same(s)
    kv = pair.create(kind="kv", start=b"dz0", end=b"dz1")
    r = pair.call(kv, "DocumentService", "DocumentCount",
                  lambda rid: PB.DocumentCountRequest(
                      context=PB.Context(region_id=rid)))
    assert r["dingo_tpu_torch"].error.errcode == 80001
    assert_same(r)


def test_typed_document_region_over_grpc(pair):
    """test_document_typed.py's typed region: the schema travels with the
    region, query-mode search with a typed range, and the leader rejects
    a schema-invalid doc before the propose (80002, count unchanged)."""
    rids = pair.create(kind="document", start=1 << 30, end=1 << 31,
                       schema={"text": "text", "price": "i64"})
    docs = [(1, {"text": "cheap red shirt", "price": 10}),
            (2, {"text": "expensive red coat", "price": 200}),
            (3, {"text": "cheap blue shirt", "price": 12})]
    r = pair.call(rids, "DocumentService", "DocumentAdd",
                  lambda rid: doc_add(rid, docs, WIRE.encode_obj))
    assert r["dingo_tpu_torch"].error.errcode == 0
    assert_same(r, drop=("ts",))

    def search(rid):
        req = PB.DocumentSearchRequest(query="red price:[* TO 100]",
                                       mode="query", top_n=10)
        req.context.region_id = rid
        return req

    s = pair.call(rids, "DocumentService", "DocumentSearch", search)
    assert [d.id for d in s["dingo_tpu_torch"].documents] == [1]
    assert_same(s)
    bad = pair.call(rids, "DocumentService", "DocumentAdd",
                    lambda rid: doc_add(rid, [(9, {"price": "not a number"})],
                                        WIRE.encode_obj))
    assert bad["dingo_tpu_torch"].error.errcode == 80002
    assert "expected i64" in bad["dingo_tpu_torch"].error.errmsg
    assert_same(bad)
    cnt = pair.call(rids, "DocumentService", "DocumentCount",
                    lambda rid: PB.DocumentCountRequest(
                        context=PB.Context(region_id=rid)))
    assert cnt["dingo_tpu_torch"].count == 3
    assert_same(cnt)


# ---------------- NodeService and DebugService --------------------------------

def test_node_and_debug_services(pair):
    """NodeInfo, the log-level RPCs, GetVectorIndexSnapshotMeta (not
    ported: in-band 99999 from the port), MetricsDump in both formats and
    an unknown format (50002), FlightDump and EventDump."""
    for name, c in pair.c.items():
        node = c.stub("s0", "NodeService")
        info = node.NodeInfo(PB.NodeInfoRequest())
        assert info.store_id == "s0" and len(info.region_ids) >= 1, name
        assert set(info.leader_region_ids) <= set(info.region_ids)
        assert node.SetLogLevel(PB.SetLogLevelRequest(
            level="info", module="grpc_test")).error.errcode == 0
        assert node.SetLogLevel(PB.SetLogLevelRequest(
            level="loud")).error.errcode == 90003
        levels = {e.module: e.level for e in
                  node.GetLogLevel(PB.GetLogLevelRequest()).levels}
        assert levels["dingo.grpc_test"] == "INFO", name
        dbg = c.stub("s0", "DebugService")
        assert "vector_add" in dbg.MetricsDump(PB.MetricsDumpRequest()).json
        prom = dbg.MetricsDump(PB.MetricsDumpRequest(format="prometheus"))
        assert prom.error.errcode == 0 and prom.json.strip()
        assert dbg.MetricsDump(PB.MetricsDumpRequest(
            format="xml")).error.errcode == 50002
        fl = dbg.FlightDump(PB.FlightDumpRequest(include_payload=True,
                                                 bundle_id="nope"))
        assert fl.error.errcode == 50003, name
        ev = dbg.EventDump(PB.EventDumpRequest(limit=5))
        assert ev.error.errcode == 0 and len(ev.events) <= 5
    snap = pair.port.stub("s0", "NodeService").GetVectorIndexSnapshotMeta(
        PB.VectorIndexSnapshotMetaRequest(region_id=1))
    assert snap.error.errcode == 99999
    assert "NotPorted" in snap.error.errmsg


# ---------------- the slice's acceptance case, d 768 --------------------------

D768, N768, Q768, K768 = 768, 2048, 64, 10


@pytest.fixture(scope="module")
def ivf768(pair):
    """An IVF_FLAT region (nlist 8, d 768) in each cluster: 2,048 rows
    by VectorAdd, then VectorBuild trains it."""
    rng = np.random.default_rng(768)
    centers = 3.0 * rng.standard_normal((16, D768), dtype=np.float32)
    x = (centers[rng.integers(0, 16, N768)] + rng.standard_normal(
        (N768, D768), dtype=np.float32)).astype(np.float32)
    lo = 1 << 36
    rids = pair.create(index_type="ivf_flat", dimension=D768, start=lo,
                       end=1 << 37, ncentroids=8, default_nprobe=8)
    add_rows(pair, rids, [lo + i for i in range(N768)], x, batch=256)
    for name, c in pair.c.items():
        c.settle(rids[name])
    build = pair.call(rids, "IndexService", "VectorBuild",
                      lambda rid: PB.VectorBuildRequest(
                          context=PB.Context(region_id=rid)))
    assert_same(build)
    st = pair.call(rids, "IndexService", "VectorStatus",
                   lambda rid: PB.VectorStatusRequest(
                       context=PB.Context(region_id=rid)))
    for name in PKGS:
        assert st[name].trained and st[name].count == N768, name
    q = x[rng.choice(N768, Q768, replace=False)] + 0.05 * \
        rng.standard_normal((Q768, D768), dtype=np.float32)
    return rids, q.astype(np.float32), lo


@pytest.mark.parametrize("nprobe", [0, 3])
def test_ivf_flat_d768_search_matches(pair, ivf768, nprobe):
    """VectorSearch, 64 queries, k 10 on the trained region: the port's
    ids are the JAX store's modulo ties, distances within rtol 1e-5
    (nprobe 0 takes the region's default, all 8 lists; 3 probes a part
    and so holds the two packages' centroids equal too)."""
    rids, q, lo = ivf768
    kw = {"nprobe": nprobe} if nprobe else {}
    got = pair.call(rids, "IndexService", "VectorSearch",
                    lambda rid: search_req(rid, q, K768, **kw))
    a, b = got["dingo_tpu"], got["dingo_tpu_torch"]
    assert b.error.errcode == 0 and len(b.batch_results) == Q768
    assert all(len(r.results) == K768 for r in b.batch_results)
    assert all(lo <= v.vector.id < lo + N768
               for r in b.batch_results for v in r.results)
    assert_same_search(a, b)


def test_cross_wire_stubs(pair, ivf768):
    """Each package's ServiceStub against the other's server: the JAX
    stub reads the port's store, the port's stub the JAX store, and the
    replies equal those of the same package's stub."""
    rids, q, lo = ivf768
    stubs = {n: importlib.import_module(f"{n}.server.rpc").ServiceStub
             for n in PKGS}
    for server_pkg, c in pair.c.items():
        sid = c.leader(rids[server_pkg])
        req = search_req(rids[server_pkg], q[:16], K768)
        got = {n: stubs[n](c.channels[sid], "IndexService").VectorSearch(
            req, timeout=30) for n in PKGS}
        assert got["dingo_tpu"] == got["dingo_tpu_torch"], server_pkg
        assert len(got["dingo_tpu"].batch_results) == 16
        cnt = {n: stubs[n](c.channels[sid], "IndexService").VectorCount(
            PB.VectorCountRequest(context=PB.Context(
                region_id=rids[server_pkg]))) for n in PKGS}
        assert cnt["dingo_tpu"].count == cnt["dingo_tpu_torch"].count == \
            N768
    # and across packages: the JAX stub on the port's server answers what
    # the port's stub on the JAX server answers, modulo ties
    jsid = pair.ref.leader(rids["dingo_tpu"])
    psid = pair.port.leader(rids["dingo_tpu_torch"])
    on_port = stubs["dingo_tpu"](pair.port.channels[psid],
                                 "IndexService").VectorSearch(
        search_req(rids["dingo_tpu_torch"], q, K768), timeout=30)
    on_ref = stubs["dingo_tpu_torch"](pair.ref.channels[jsid],
                                      "IndexService").VectorSearch(
        search_req(rids["dingo_tpu"], q, K768), timeout=30)
    assert_same_search(on_ref, on_port)
