"""The serving-edge result cache and in-flight dedupe of the port (cache/,
common/coalescer.py, server/services.py) against the JAX package's: the
16 functions of test_cache.py, each run through both packages, plus the
port's IndexService consulting and filling the cache on a node, the
dedupe on the coalescer's pipelined arm, and fingerprints byte-equal to
the JAX package's.

Tolerances: cache hits are held byte-identical to a fresh dispatch within
each package (the claim of the cache); the two packages' fresh replies
are held to ids modulo ties and distances within rtol 1e-5 (atol 1e-5
near 0) for fp32, rtol 2e-2 / atol 0.2 for sq8 (test_tiering.py's
device-versus-host bound; the JAX package's jitted sq8 decode fuses into
an FMA). Fingerprints, dedupe plans and cache accounting compare exactly.

The port runs on the CPU (``device="cpu"``).
"""

import importlib
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")


class Pkg:
    MODS = {"edge": "cache.edge", "keys": "cache.keys",
            "policy": "cache.policy", "dedupe": "cache.dedupe",
            "store": "cache.store", "coal": "common.coalescer",
            "config": "common.config", "metrics": "common.metrics",
            "index": "index.base", "factory": "index.factory",
            "pressure": "obs.pressure", "quality": "obs.quality"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    @property
    def torch(self) -> bool:
        return self.name == "dingo_tpu_torch"

    @property
    def FLAGS(self):
        return self.config.FLAGS

    def coalescer(self, run, window_ms, **kw):
        return self.coal.SearchCoalescer(run, window_ms=window_ms,
                                              **kw, **self.kw)

    def new_index(self, rid, param):
        return self.factory.new_index(rid, param, **self.kw)


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


def _cache_on(p):
    p.FLAGS.set("cache_enabled", True)
    p.edge.CACHE.reset()
    p.edge.CODECS.reset()


def _cache_off(p):
    p.FLAGS.set("cache_enabled", False)
    p.FLAGS.set("cache_semantic", False)
    p.FLAGS.set("cache_max_bytes", 64 * 1024 * 1024)
    p.FLAGS.set("cache_stale_versions", 1)
    p.FLAGS.set("cache_tenant_share", 0.5)
    p.edge.CACHE.reset()
    p.edge.CODECS.reset()


@pytest.fixture
def cache_on(pkg):
    _cache_on(pkg)
    yield pkg
    _cache_off(pkg)


def rows_of(results):
    """Per-row reply as (id, distance) python scalars: equality is exact."""
    return [list(zip(r.ids.tolist(), r.distances.tolist()))
            for r in results]


def _close_rows(a, b, rtol, atol):
    """Two packages' replies: distances within the tolerance, an id that
    differs sits at a distance equal to a neighbour's."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        ia = np.asarray([i for i, _ in ra])
        ib = np.asarray([i for i, _ in rb])
        da = np.asarray([d for _, d in ra])
        db = np.asarray([d for _, d in rb])
        np.testing.assert_allclose(db, da, rtol=rtol, atol=atol)
        for c in np.flatnonzero(ia != ib):
            near = [db[j] for j in (c - 1, c + 1) if 0 <= j < len(db)]
            assert any(np.isclose(db[c], v, rtol=rtol, atol=atol)
                       for v in near), (ia, ib, da, db)


# -- in-flight dedupe ---------------------------------------------------------

def _dedupe_one_row(p):
    calls = []

    def run(key, stacked):
        calls.append(np.array(stacked, copy=True))
        return [("reply", float(q.sum())) for q in stacked]

    co = p.coalescer(run, 40.0)
    try:
        dup = np.full((1, 4), 7.0, np.float32)
        solo = np.full((1, 4), 9.0, np.float32)
        futs = [co.submit("k", dup) for _ in range(4)]
        futs.append(co.submit("k", solo))
        got = [f.result(timeout=5) for f in futs]
    finally:
        co.stop()
    return calls, got, p.edge.CACHE.region_stats(0)["dedup_collapsed"]


def test_dedupe_collapses_to_one_kernel_row(cache_on):
    calls, got, collapsed = _dedupe_one_row(cache_on)
    assert len(calls) == 1 and len(calls[0]) == 2
    for rows in got[:4]:
        assert rows == [("reply", 28.0)]
    assert got[4] == [("reply", 36.0)]
    assert collapsed == 3


def test_dedupe_off_without_subsystem(pkg):
    calls = []

    def run(key, stacked):
        calls.append(len(stacked))
        return list(range(len(stacked)))

    co = pkg.coalescer(run, 30.0)
    try:
        dup = np.full((1, 4), 7.0, np.float32)
        for f in [co.submit("k", dup) for _ in range(3)]:
            f.result(timeout=5)
    finally:
        co.stop()
    assert calls == [3]     # no plan: the kernel sees every row


class _E:
    def __init__(self, q):
        self.queries = q


def test_build_plan_none_when_nothing_collapses(pkg):
    a = _E(np.arange(4, dtype=np.float32).reshape(1, 4))
    b = _E(np.arange(4, 8, dtype=np.float32).reshape(1, 4))
    assert pkg.dedupe.build_plan([a, b]) is None
    assert pkg.dedupe.deduped_rows([a, b]) == 2
    dup = _E(np.arange(4, dtype=np.float32).reshape(1, 4))
    plan = pkg.dedupe.build_plan([a, b, dup])
    assert plan is not None and plan.collapsed == 1
    assert len(plan.stacked) == 2


def test_dedupe_plans_equal_the_reference():
    """The same flush collapses to the same unique rows and fan-out maps
    in both packages."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((6, 8)).astype(np.float32)
    entries = [_E(base[rng.integers(0, 6, size=3)]) for _ in range(7)]
    plans = {name: Pkg(name).dedupe.build_plan(entries) for name in PKGS}
    a, b = plans["dingo_tpu"], plans["dingo_tpu_torch"]
    assert a.collapsed == b.collapsed > 0
    np.testing.assert_array_equal(a.stacked, b.stacked)
    for fa, fb in zip(a.fanout, b.fanout):
        np.testing.assert_array_equal(fa, fb)


# -- exact hits: byte-identity + invalidation --------------------------------

FAMILIES = [
    ("flat", "fp32"), ("flat", "sq8"), ("ivf_flat", "fp32"),
    ("ivf_flat", "sq8"), ("hnsw", "fp32"), ("hnsw", "sq8"),
]


def _mk_index(p, rid, index_type, precision, d=16, n=96):
    b = p.index
    kw = {}
    if index_type == "ivf_flat":
        kw = {"ncentroids": 4, "default_nprobe": 4}
    elif index_type == "hnsw":
        kw = {"nlinks": 8, "efconstruction": 40}
    idx = p.new_index(rid, b.IndexParameter(
        index_type=b.IndexType(index_type), dimension=d,
        precision=precision, **kw))
    rng = np.random.default_rng(rid)
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx.upsert(np.arange(n, dtype=np.int64), x)
    if index_type == "ivf_flat":
        idx.train()
    search_kw = {"nprobe": 4} if index_type == "ivf_flat" else {}
    return idx, x, search_kw


def _hit_vs_fresh(p, index_type, precision):
    rid = 4000 + FAMILIES.index((index_type, precision))
    idx, x, kw = _mk_index(p, rid, index_type, precision)
    kw_items = tuple(sorted(kw.items()))
    q = x[:3] + np.float32(0.01)
    ver = p.edge.index_version(idx)
    assert ver is not None
    looked = p.edge.lookup(rid, q, 5, kw_items, ver, index=idx)
    assert looked is not None and not looked.any_hit
    fresh = rows_of(idx.search(q, 5, **kw))
    p.edge.fill(rid, looked, fresh, p.edge.index_version(idx), q)
    again = p.edge.lookup(rid, q, 5, kw_items, ver, index=idx)
    assert again is not None and again.complete
    # byte-identical to a second uncached dispatch too: determinism is
    # part of the claim
    assert again.rows == rows_of(idx.search(q, 5, **kw))
    assert again.rows == fresh
    st = p.edge.CACHE.region_stats(rid)
    assert st["hits"] == 3 and st["misses"] == 3
    return fresh


@pytest.mark.parametrize("index_type,precision", FAMILIES,
                         ids=[f"{t}-{p}" for t, p in FAMILIES])
def test_hit_byte_identical_to_fresh_dispatch(index_type, precision):
    got = {}
    for name in PKGS:
        p = Pkg(name)
        _cache_on(p)
        try:
            got[name] = _hit_vs_fresh(p, index_type, precision)
        finally:
            _cache_off(p)
    tol = (dict(rtol=1e-5, atol=1e-5) if precision == "fp32"
           else dict(rtol=2e-2, atol=0.2))
    _close_rows(got["dingo_tpu"], got["dingo_tpu_torch"], **tol)


def test_params_change_is_a_different_key(cache_on):
    p = cache_on
    rid = 4100
    idx, x, kw = _mk_index(p, rid, "flat", "fp32")
    q = x[:2]
    ver = p.edge.index_version(idx)
    looked = p.edge.lookup(rid, q, 5, (), ver, index=idx)
    p.edge.fill(rid, looked, rows_of(idx.search(q, 5)), ver, q)
    other = p.edge.lookup(rid, q, 7, (), ver, index=idx)
    assert other is not None and not other.any_hit


def test_partial_hit_submits_only_miss_rows(cache_on):
    p = cache_on
    rid = 4200
    idx, x, kw = _mk_index(p, rid, "flat", "fp32")
    ver = p.edge.index_version(idx)
    q0 = x[:1]
    looked = p.edge.lookup(rid, q0, 5, (), ver, index=idx)
    p.edge.fill(rid, looked, rows_of(idx.search(q0, 5)), ver, q0)
    q = np.concatenate([x[:1], x[10:11]], axis=0)
    part = p.edge.lookup(rid, q, 5, (), ver, index=idx)
    assert part is not None and part.any_hit and not part.complete
    assert part.miss_idx.tolist() == [1]
    miss_rows = rows_of(idx.search(q[part.miss_idx], 5))
    merged = part.merge(miss_rows)
    assert merged[0] == rows_of(idx.search(q0, 5))[0]
    assert merged[1] == miss_rows[0]
    full = rows_of(idx.search(q, 5))
    for got, want in zip(merged, full):
        assert [i for i, _ in got] == [i for i, _ in want]
        assert np.allclose([s for _, s in got], [s for _, s in want],
                           atol=1e-4)


@pytest.mark.parametrize("mutate", ["upsert", "delete", "train"])
def test_invalidation_on_mutation(cache_on, mutate):
    p = cache_on
    rid = 4300
    idx, x, kw = _mk_index(p, rid, "ivf_flat", "fp32")
    kw_items = tuple(sorted(kw.items()))
    q = x[:2]
    v0 = p.edge.index_version(idx)
    looked = p.edge.lookup(rid, q, 5, kw_items, v0, index=idx)
    p.edge.fill(rid, looked, rows_of(idx.search(q, 5, **kw)), v0, q)
    assert p.edge.lookup(rid, q, 5, kw_items, v0, index=idx).complete
    if mutate == "upsert":
        idx.upsert(np.array([500], np.int64), x[:1] + np.float32(1.0))
    elif mutate == "delete":
        idx.delete(np.array([3], np.int64))
    else:
        idx.train()
    v1 = p.edge.index_version(idx)
    assert v1 > v0      # every mutation kind bumps the serving version
    after = p.edge.lookup(rid, q, 5, kw_items, v1, index=idx)
    assert not after.any_hit


def test_fill_skipped_when_version_moved_mid_flight(cache_on):
    p = cache_on
    rid = 4400
    idx, x, kw = _mk_index(p, rid, "flat", "fp32")
    q = x[:1]
    v0 = p.edge.index_version(idx)
    looked = p.edge.lookup(rid, q, 5, (), v0, index=idx)
    fresh = rows_of(idx.search(q, 5))
    idx.upsert(np.array([700], np.int64), x[5:6])   # a write mid-flight
    p.edge.fill(rid, looked, fresh, p.edge.index_version(idx), q)
    assert p.edge.CACHE.stats()["entries"] == 0


# -- stale rung ---------------------------------------------------------------

def test_stale_rung_only_under_degrade_and_never_beyond_bound(cache_on):
    p = cache_on
    METRICS = p.metrics.METRICS
    rid = 4500
    p.FLAGS.set("cache_stale_versions", 2)
    rc = p.edge.CACHE
    rows = [[(1, 0.5)]]
    rc.put(rid, 99, version=5, rows=rows)
    METRICS.gauge("qos.degrade_level", rid).set(0.0)
    assert p.policy.stale_versions_allowed(rid) == 0
    assert rc.lookup(rid, 99, version=6, stale_versions=0) is None
    METRICS.gauge("qos.degrade_level", rid).set(1.0)
    allowed = p.policy.stale_versions_allowed(rid)
    assert allowed == 2
    assert rc.lookup(rid, 99, version=7, stale_versions=allowed) == rows
    assert rc.region_stats(rid)["stale_served"] == 1
    assert rc.lookup(rid, 99, version=8, stale_versions=allowed) is None
    METRICS.gauge("qos.degrade_level", rid).set(0.0)
    p.policy.stale_versions_allowed(rid)


# -- per-tenant fairness + eviction accounting -------------------------------

def test_tenant_evicts_own_tail_never_neighbors(cache_on):
    p = cache_on
    p.FLAGS.set("cache_max_bytes", 2000)
    p.FLAGS.set("cache_tenant_share", 0.5)    # 1000 bytes per tenant
    rc = p.store.ResultCache()
    rows = [(i, float(i)) for i in range(5)]    # 160 + 5*56 = 440 bytes
    assert rc.put(1, 1, 1, rows, tenant="b")
    for fp in (10, 11, 12):
        assert rc.put(1, fp, 1, rows, tenant="a")
    assert rc.tenant_bytes("a") <= 1000
    assert rc.tenant_bytes("b") == 440
    assert rc.lookup(1, 10, 1) is None
    assert rc.lookup(1, 12, 1) == rows
    big = [(i, float(i)) for i in range(20)]    # 160 + 20*56 = 1280
    assert not rc.put(1, 77, 1, big, tenant="a")


def test_eviction_accounting_tracks_lru(cache_on):
    p = cache_on
    p.FLAGS.set("cache_max_bytes", 1000)
    p.FLAGS.set("cache_tenant_share", 0.0)
    rc = p.store.ResultCache()
    rows = [(i, float(i)) for i in range(5)]
    rc.put(7, 1, 1, rows)
    rc.put(7, 2, 1, rows)
    assert rc.stats() == {"bytes": 880, "entries": 2, "tenants": 1}
    rc.put(7, 3, 1, rows)
    st = rc.stats()
    assert st["bytes"] == 880 and st["entries"] == 2
    assert rc.lookup(7, 1, 1) is None
    assert rc.lookup(7, 2, 1) == rows
    assert rc.region_stats(7)["entries"] == 2
    rc.put(7, 4, 1, rows)
    assert rc.lookup(7, 3, 1) is None
    assert rc.lookup(7, 2, 1) == rows


# -- semantic tier ------------------------------------------------------------

def test_semantic_gate_fails_closed_and_closes_on_dip(cache_on,
                                                      monkeypatch):
    p = cache_on
    Q = p.quality.QUALITY
    rid = 4600
    p.FLAGS.set("cache_semantic", True)
    monkeypatch.setattr(Q, "region_estimate", lambda _rid: None)
    assert not p.policy.semantic_allowed(rid)
    p.FLAGS.set("quality_slo_recall", 0.95)
    monkeypatch.setattr(Q, "region_estimate", lambda _rid: {"ci_low": 0.97})
    assert p.policy.semantic_allowed(rid)
    monkeypatch.setattr(Q, "region_estimate", lambda _rid: {"ci_low": 0.90})
    assert not p.policy.semantic_allowed(rid)


def test_semantic_hit_serves_rounded_query_and_respects_gate(
        cache_on, monkeypatch):
    p = cache_on
    Q = p.quality.QUALITY
    rid = 4700
    idx, x, kw = _mk_index(p, rid, "flat", "fp32", d=8, n=300)
    p.FLAGS.set("cache_semantic", True)
    p.FLAGS.set("quality_slo_recall", 0.95)
    monkeypatch.setattr(Q, "region_estimate", lambda _rid: {"ci_low": 0.99})
    p.edge.CODECS.observe(rid, x[:p.keys.SEMANTIC_TRAIN_ROWS])
    assert p.edge.CODECS.trained(rid)
    q = x[:1]
    ver = p.edge.index_version(idx)
    looked = p.edge.lookup(rid, q, 5, (), ver, index=idx)
    p.edge.fill(rid, looked, rows_of(idx.search(q, 5)), ver, q)
    near = q + np.float32(1e-6)
    got = p.edge.lookup(rid, near, 5, (), ver, index=idx)
    assert got is not None and got.complete
    assert p.edge.CACHE.region_stats(rid)["semantic_served"] == 1
    monkeypatch.setattr(Q, "region_estimate", lambda _rid: {"ci_low": 0.50})
    got = p.edge.lookup(rid, near, 5, (), ver, index=idx)
    assert not got.any_hit


# -- budget/priority across dedupe -------------------------------------------

def _expired_member(p):
    P = p.pressure
    p.FLAGS.set("qos_enabled", True)
    P.PRESSURE.reset()
    calls = []

    def run(key, stacked):
        calls.append(np.array(stacked, copy=True))
        return [("reply", float(q.sum())) for q in stacked]

    co = p.coalescer(run, 80.0)
    try:
        dup = np.full((1, 4), 3.0, np.float32)
        now = time.monotonic()
        token = P.attach_budget(P.Budget(60_000.0, priority=2, t0=now))
        try:
            f_alive = co.submit("k", dup, region_id=77)
        finally:
            P.detach_budget(token)
        token = P.attach_budget(P.Budget(20.0, priority=0, t0=now))
        try:
            f_dead = co.submit("k", dup, region_id=77)
        finally:
            P.detach_budget(token)
        assert f_alive.result(timeout=5) == [("reply", 12.0)]
        with pytest.raises(P.DeadlineExceeded):
            f_dead.result(timeout=5)
    finally:
        co.stop()
        p.FLAGS.set("qos_enabled", False)
    return calls


def test_expired_member_fails_alone_dedupe_siblings_served(cache_on):
    calls = _expired_member(cache_on)
    assert len(calls) == 1 and len(calls[0]) == 1


def test_collapsed_row_rides_highest_priority_position(cache_on):
    p = cache_on
    P = p.pressure
    p.FLAGS.set("qos_enabled", True)
    P.PRESSURE.reset()
    calls = []

    def run(key, stacked):
        calls.append(np.array(stacked, copy=True))
        return [("reply", float(q.sum())) for q in stacked]

    co = p.coalescer(run, 80.0)
    try:
        row_a = np.full((1, 4), 1.0, np.float32)
        row_b = np.full((1, 4), 2.0, np.float32)
        futs = []
        for q, prio in ((row_a, 0), (row_b, 0), (row_b, 2)):
            token = P.attach_budget(P.Budget(60_000.0, priority=prio))
            try:
                futs.append(co.submit("k", q, region_id=78))
            finally:
                P.detach_budget(token)
        got = [f.result(timeout=5) for f in futs]
    finally:
        co.stop()
        p.FLAGS.set("qos_enabled", False)
    assert len(calls) == 1 and len(calls[0]) == 2   # B collapsed
    assert float(calls[0][0].sum()) == 8.0          # B dispatched first
    assert got[1] == got[2] == [("reply", 8.0)]
    assert got[0] == [("reply", 4.0)]


# -- key derivation -----------------------------------------------------------

def test_query_fingerprints_bind_params_and_bytes(pkg):
    k = pkg.keys
    q = np.arange(8, dtype=np.float32).reshape(2, 4)
    s1 = k.params_seed(5, (("nprobe", 4),))
    s2 = k.params_seed(5, (("nprobe", 8),))
    s3 = k.params_seed(5, (("nprobe", 4),), filter_fp=b"\x01")
    f1 = k.query_fingerprints(q, s1)
    assert f1.shape == (2,)
    assert not np.any(f1 == k.query_fingerprints(q, s2))
    assert not np.any(f1 == k.query_fingerprints(q, s3))
    q2 = q.copy()
    q2[0, 0] = np.nextafter(q2[0, 0], np.float32(1e9))
    f2 = k.query_fingerprints(q2, s1)
    assert f2[0] != f1[0] and f2[1] == f1[1]


def test_fingerprints_equal_the_reference():
    """Seeds, exact and semantic fingerprints and the semantic codec's
    codes are the JAX package's bit for bit (a cache keyed by one
    package's fingerprints is readable by the other's)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    got = {}
    for name in PKGS:
        k = Pkg(name).keys
        seed = k.params_seed(10, (("nprobe", 32),), filter_fp=b"\x07\x09")
        codec = k.SemanticCodec()
        codec.observe(3, np.tile(q, (7, 1)))
        codes = codec.encode(3, q)
        got[name] = (np.uint64(seed), k.query_fingerprints(q, seed), codes,
                     k.semantic_fingerprints(codes, seed))
    for a, b in zip(got["dingo_tpu"], got["dingo_tpu_torch"]):
        np.testing.assert_array_equal(a, b)


# -- the port's serving path: IndexService and the pipelined arm ----------

def _service_node(n=96, d=16):
    """A one-store port cluster holding a FLAT region of `n` rows (its id
    is the coordinator's); returns (node, region id, rows, stop)."""
    from torch_cluster_util import (
        Pkg as CPkg,
        drive_heartbeats,
        stop_nodes,
        wait_region_leader,
    )

    cp = CPkg("dingo_tpu_torch")
    _transport, coord, nodes = cp.cluster(n=1, replication=1)
    # a region id of its own: the search-latency series, the cost model
    # and the cache are keyed by region id, and the other files' clusters
    # start at 1000
    while coord.next_region_id() < 7500:
        pass
    dfn = cp.index_region(coord, dim=d)
    drive_heartbeats(nodes)
    node = wait_region_leader(nodes, dfn.region_id)
    x = np.random.default_rng(12).standard_normal((n, d)).astype(np.float32)
    node.storage.vector_add(node.get_region(dfn.region_id),
                            np.arange(n, dtype=np.int64), x)
    return node, dfn.region_id, x, lambda: stop_nodes(nodes)


def test_index_service_consults_and_fills_the_cache():
    """IndexService.submit on a node: the first request misses and fills,
    the repeat is a complete hit that launches nothing and equals a fresh
    dispatch, a partial hit submits only its miss rows, a write bumps the
    version (the same request misses, then refills), and the collector's
    cache_* fields equal CACHE.region_stats."""
    from dingo_tpu_torch.server.services import IndexService

    p = Pkg("dingo_tpu_torch")
    _cache_on(p)
    node, rid, x, stop = _service_node()
    region = node.get_region(rid)
    dispatched = []
    orig = node.storage.vector_batch_search

    def spy(region_, queries, topk, **kw):
        dispatched.append(len(queries))
        return orig(region_, queries, topk, **kw)

    node.storage.vector_batch_search = spy
    svc = IndexService(node, window_ms=1.0, max_batch=64)
    try:
        q = x[:4] + np.float32(0.01)

        def ask(qq):
            return [[(v.id, v.distance) for v in r] for r in
                    svc.submit(rid, qq, 5).result(timeout=10)]

        first = ask(q)
        assert dispatched == [4]
        again = ask(q)
        assert again == first and dispatched == [4]   # no kernel row
        fresh = [[(v.id, v.distance) for v in r]
                 for r in orig(region, q, 5)]
        assert again == fresh
        part = ask(np.concatenate([q[:2], x[20:22]]))
        assert dispatched == [4, 2]
        assert part[:2] == first[:2]
        st0 = p.edge.CACHE.region_stats(rid)
        node.storage.vector_add(region, np.asarray([500], np.int64),
                                x[50:51] + np.float32(3.0))
        ask(q)
        assert dispatched == [4, 2, 4]                # the write: a miss
        ask(q)
        assert dispatched == [4, 2, 4]                # refilled: a hit
        st = p.edge.CACHE.region_stats(rid)
        assert st["hits"] == st0["hits"] + 4
        node.metrics._latest_mono = 0.0
        rm = node.metrics.collect().region(rid)
        assert (rm.cache_hits, rm.cache_misses, rm.cache_entries) == (
            st["hits"], st["misses"], st["entries"])
        # a flight bundle's cache section now carries the cache.* family
        from dingo_tpu_torch.obs.flight import FLIGHT

        bundle = FLIGHT.get_json(FLIGHT.trigger("manual", name="cache"))
        assert any("cache.hits" in key for key in bundle["cache"]), \
            bundle["cache"]
    finally:
        svc.close()
        node.storage.vector_batch_search = orig
        stop()
        _cache_off(p)


def test_pipelined_arm_dedupes_and_fans_out():
    """On the coalescer's pipelined arm (forced on the CPU) identical rows
    of concurrent submitters dispatch once; every future resolves to the
    solo answer."""
    import threading

    from dingo_tpu_torch.server.services import IndexService

    p = Pkg("dingo_tpu_torch")
    _cache_on(p)
    p.FLAGS.set("cache_max_bytes", 0)         # dedupe only, no result cache
    saved = p.FLAGS.get("pipeline_enabled")
    p.FLAGS.set("pipeline_enabled", "true")
    node, rid, x, stop = _service_node()
    region = node.get_region(rid)
    rows = []
    orig = node.storage.vector_batch_search_async

    def spy(region_, queries, topk, **kw):
        rows.append(len(queries))
        return orig(region_, queries, topk, **kw)

    node.storage.vector_batch_search_async = spy
    svc = IndexService(node, window_ms=50.0, max_batch=64)
    try:
        q = x[3:5] + np.float32(0.02)
        solo = [[(v.id, v.distance) for v in r]
                for r in node.storage.vector_batch_search(region, q, 5)]
        futs = []
        ths = [threading.Thread(target=lambda: futs.append(
            svc.submit(rid, q, 5))) for _ in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        got = [[[(v.id, v.distance) for v in r] for r in f.result(timeout=10)]
               for f in futs]
        collapsed = p.edge.CACHE.region_stats(rid)["dedup_collapsed"]
    finally:
        svc.close()
        node.storage.vector_batch_search_async = orig
        stop()
        p.FLAGS.set("pipeline_enabled", saved)
        _cache_off(p)
    assert sum(rows) < 8 * 2 and collapsed == 8 * 2 - sum(rows)
    assert all(g == solo for g in got)
