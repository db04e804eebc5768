"""TABLE-filtered VectorSearch of the port against the JAX package's: table
rows ride VectorAdd into the vector_table CF, and the reader runs a
CoprocessorV2 over them. The pre variant scans the table CF into candidate
ids that the index takes as a filter; the post variant over-fetches
topk x 10 and filters the candidates' table rows on the host.

Seeded numpy inputs go through both packages' Storage on a
MonoStoreEngine(MemEngine()), FLAT and IVF_FLAT (trained by the index
manager), L2 and IP. Ids are equal modulo exact ties, distances within
rtol 1e-5, atol 1e-5 of the magnitude their f32 sums run through. The
port runs on the CPU (``device="cpu"``), where its kernel wrappers take
their plain versions. Then test_storage_slice.py's
own TABLE case runs through the port, and a TABLE request through
IndexService.submit is held to the direct path: it never reaches the
coalescer or the edge cache, whose keys carry no coprocessor.
"""

import importlib
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
DIM, N = 16, 400
RTOL = ATOL = 1e-5
MODS = {"regm": "store.region", "monom": "engine.mono_engine",
        "raw": "engine.raw_engine", "st": "engine.storage",
        "vcodec": "index.codec", "base": "index.base",
        "reader": "index.vector_reader", "mgr": "index.manager",
        "v2": "coprocessor.coprocessor_v2", "dist": "ops.distance",
        "codec": "mvcc.codec"}


def pkg(name):
    p = types.SimpleNamespace(name=name, kw={"device": "cpu"} if name ==
                              "dingo_tpu_torch" else {})
    for attr, m in MODS.items():
        setattr(p, attr, importlib.import_module(f"{name}.{m}"))
    return p


def region_of(p, index_type, metric, region_id=99):
    definition = p.regm.RegionDefinition(
        region_id=region_id,
        start_key=p.vcodec.encode_vector_key(1, 0),
        end_key=p.vcodec.encode_vector_key(1, 1 << 40),
        partition_id=1, region_type=p.regm.RegionType.INDEX,
        index_parameter=p.base.IndexParameter(
            index_type=p.base.IndexType(index_type), dimension=DIM,
            metric=p.dist.Metric(metric), ncentroids=8, default_nprobe=4))
    region = p.regm.Region(definition, **p.kw)
    w = region.vector_index_wrapper
    w.build_own()
    w.set_own(w.own_index)
    return region


def data(seed=3):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((8, DIM), dtype=np.float32)
    x = (centers[rng.integers(0, 8, N)]
         + rng.standard_normal((N, DIM), dtype=np.float32)).astype(np.float32)
    cat = rng.integers(0, 10, N)
    price = rng.random(N)
    tag = rng.choice(["a", "b", "c", "d"], N)
    rows = [[int(c), float(pr), str(t)] for c, pr, t in zip(cat, price, tag)]
    q = (x[rng.choice(N, 6, replace=False)]
         + 0.1 * rng.standard_normal((6, DIM), dtype=np.float32))
    return x, rows, q.astype(np.float32)


def schema(p):
    C = p.v2.SchemaColumn
    return [C("cat", "BIGINT", 0), C("price", "DOUBLE", 1),
            C("tag", "VARCHAR", 2)]


PREDICATES = {
    "selective": (["lt", ["field", "cat"], ["const", 2]],
                  lambda r: r[0] < 2),
    "broad": (["and", ["lt", ["field", "cat"], ["const", 6]],
               ["ge", ["field", "price"], ["const", 0.2]]],
              lambda r: r[0] < 6 and r[1] >= 0.2),
    "unknown": (["gt", ["div", ["field", "price"], ["sub", ["field", "cat"],
                                                      ["const", 3]]],
                 ["const", 0.1]],
                lambda r: r[0] != 3 and r[1] / (r[0] - 3) > 0.1),
}


def build(p, index_type, metric, x, rows, with_table=None):
    raw = p.raw.MemEngine()
    engine = p.monom.MonoStoreEngine(raw, **p.kw)
    storage = p.st.Storage(engine)
    region = region_of(p, index_type, metric)
    ids = np.arange(N, dtype=np.int64)
    table = [p.v2.encode_row(r) for r in rows]
    if with_table is not None:        # some vectors without a table row
        table = [t if keep else None for t, keep in zip(table, with_table)]
    for lo in range(0, N, 128):
        storage.vector_add(region, ids[lo:lo + 128], x[lo:lo + 128],
                           table_values=table[lo:lo + 128])
    if index_type == "ivf_flat":
        assert p.mgr.VectorIndexManager(raw, None, **p.kw).rebuild(region)
        assert region.vector_index_wrapper.own_index.is_trained()
    return types.SimpleNamespace(p=p, raw=raw, engine=engine,
                                 storage=storage, region=region)


def cop(p, pred):
    return p.v2.CoprocessorV2(p.v2.CoprocessorDef(
        original_schema=schema(p), filter_expr=PREDICATES[pred][0]))


def search(s, q, topk, variant, pred, **kw):
    R = s.p.reader
    return s.storage.vector_batch_search(
        s.region, q, topk, filter_mode=R.VectorFilterMode.TABLE,
        filter_type=(R.VectorFilterType.QUERY_PRE if variant == "pre"
                     else R.VectorFilterType.QUERY_POST),
        coprocessor=cop(s.p, pred), **kw)


def assert_same_rows(a_rows, b_rows, q, x):
    """Ids equal modulo exact ties, distances within rtol 1e-5, atol 1e-5
    of the magnitude the f32 sum runs through: |q|^2 + |x|^2 for L2's
    expansion (~100 here; the packages add its terms in other orders),
    |q| |x| for IP."""
    assert len(a_rows) == len(b_rows)
    qn = np.linalg.norm(q, axis=1)
    xn = np.linalg.norm(x, axis=1)
    for qi, (a, b) in enumerate(zip(a_rows, b_rows)):
        assert len(a) == len(b)
        da = np.asarray([v.distance for v in a], np.float32)
        db = np.asarray([v.distance for v in b], np.float32)
        ia = np.asarray([v.id for v in a])
        ib = np.asarray([v.id for v in b])
        mag = np.maximum(qn[qi] ** 2 + xn[ib] ** 2, qn[qi] * xn[ib])
        tol = ATOL * np.maximum(1.0, mag) + RTOL * np.abs(da)
        assert np.all(np.abs(db - da) <= tol), (da, db, tol)
        for c in np.flatnonzero(ia != ib):
            near = [db[c2] for c2 in (c - 1, c + 1) if 0 <= c2 < len(db)]
            assert any(abs(db[c] - v) <= tol[c] for v in near), (c, ia, ib)


@pytest.fixture(scope="module")
def dataset():
    return data()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("index_type", ["flat", "ivf_flat"])
def test_table_filters_equal_across_packages(dataset, index_type, metric):
    x, rows, q = dataset
    s = {name: build(pkg(name), index_type, metric, x, rows)
         for name in PKGS}
    kw = {"nprobe": 4} if index_type == "ivf_flat" else {}
    for pred, (_, keep) in PREDICATES.items():
        want = {i for i, r in enumerate(rows) if keep(r)}
        for variant, topk in (("pre", 20), ("post", 5), ("post", 10)):
            got = {name: search(s[name], q, topk, variant, pred, **kw)
                   for name in PKGS}
            assert_same_rows(got["dingo_tpu"], got["dingo_tpu_torch"], q, x)
            for row in got["dingo_tpu_torch"]:
                assert all(v.id in want for v in row), (pred, variant)
                if variant == "pre":
                    assert len(row) == min(topk, len(want))
    # the post variant is the filtered prefix of the unfiltered over-fetch
    port = s["dingo_tpu_torch"]
    for topk in (5, 10):
        over = port.storage.vector_batch_search(port.region, q, topk * 10,
                                                **kw)
        got = search(port, q, topk, "post", "broad", **kw)
        keep = PREDICATES["broad"][1]
        for o, g in zip(over, got):
            assert [v.id for v in g] == [
                v.id for v in o if keep(rows[v.id])][:topk]


def test_table_filter_contract(dataset):
    """A vector without a table row is never a candidate; a delete
    tombstones the table CF; a missing coprocessor raises ValueError."""
    x, rows, q = dataset
    with_table = np.arange(N) % 5 != 0
    s = {name: build(pkg(name), "flat", "l2", x, rows, with_table)
         for name in PKGS}
    R = {name: s[name].p.reader for name in PKGS}
    for name in PKGS:
        for variant in ("pre", "post"):
            got = search(s[name], q, 10, variant, "broad")
            assert all(with_table[v.id] for row in got for v in row)
        with pytest.raises(ValueError, match="coprocessor"):
            s[name].storage.vector_batch_search(
                s[name].region, q[:1], 5,
                filter_mode=R[name].VectorFilterMode.TABLE,
                filter_type=R[name].VectorFilterType.QUERY_PRE)
        with pytest.raises(ValueError, match="coprocessor"):
            s[name].storage.vector_batch_search(
                s[name].region, q[:1], 5,
                filter_mode=R[name].VectorFilterMode.TABLE)
    assert_same_rows(search(s["dingo_tpu"], q, 10, "pre", "broad"),
                     search(s["dingo_tpu_torch"], q, 10, "pre", "broad"), q, x)
    # the table CF's rows are the same bytes in both engines (the
    # version stamps, each package's own clock, stripped)
    def table_cf(name):
        Codec = s[name].p.codec.Codec
        return [(Codec.decode_key(k)[0], v) for k, v in
                s[name].raw.scan("vector_table", b"", None)]

    assert table_cf("dingo_tpu_torch") == table_cf("dingo_tpu")
    assert len(table_cf("dingo_tpu_torch")) == int(with_table.sum())
    # deletes tombstone the table CF: deleted ids leave the candidates
    first = [v.id for v in search(s["dingo_tpu_torch"], q, 10, "pre",
                                  "broad")[0]]
    gone = first[:3]
    for name in PKGS:
        s[name].storage.vector_delete(s[name].region, gone)
    got = {name: search(s[name], q, 10, variant, "broad")
           for name in PKGS for variant in ("pre",)}
    assert_same_rows(got["dingo_tpu"], got["dingo_tpu_torch"], q, x)
    assert not set(gone) & {v.id for row in got["dingo_tpu_torch"]
                            for v in row}
    reader = s["dingo_tpu_torch"].engine.new_vector_reader(
        s["dingo_tpu_torch"].region)
    cand = reader._scan_table_candidates(cop(s["dingo_tpu_torch"].p,
                                             "broad"))
    assert not set(gone) & set(cand.tolist())
    ref_reader = s["dingo_tpu"].engine.new_vector_reader(s["dingo_tpu"].region)
    assert cand.tolist() == ref_reader._scan_table_candidates(
        cop(s["dingo_tpu"].p, "broad")).tolist()


def test_storage_slice_table_case_through_the_port(monkeypatch):
    """test_storage_slice.py::test_table_coprocessor_filter_pre_and_post,
    its imports from the JAX package taken from the port (a region on
    the CPU)."""
    from test_torch_coprocessor import port_cases, port_on_cpu

    port_on_cpu(monkeypatch)
    mod = port_cases("test_storage_slice.py")
    assert mod.Region.__module__ == "dingo_tpu_torch.store.region"
    mod.test_table_coprocessor_filter_pre_and_post()


def test_index_service_table_request_searches_directly(dataset):
    """A TABLE request through IndexService.submit takes the direct path:
    no coalescer batch, no edge-cache lookup or fill, no dedupe; a plain
    request on the same service takes the coalescer (the spies see it)."""
    from dingo_tpu_torch.cache import edge as cache_edge
    from dingo_tpu_torch.cache.edge import CACHE
    from dingo_tpu_torch.common import coalescer as co
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.server.services import IndexService
    from dingo_tpu_torch.store.node import MonoStoreNode

    x, rows, q = dataset
    p = pkg("dingo_tpu_torch")
    node = MonoStoreNode(device="cpu")
    definition = region_of(p, "flat", "l2").definition
    region = node.create_region(definition)
    node.storage.vector_add(region, np.arange(N, dtype=np.int64), x,
                            table_values=[p.v2.encode_row(r) for r in rows])
    calls = {"submit": 0, "lookup": 0, "fill": 0}
    orig_submit, orig_lookup = co.SearchCoalescer.submit, cache_edge.lookup
    orig_fill = cache_edge.fill

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    saved = {f: FLAGS.get(f) for f in ("cache_enabled",)}
    FLAGS.set("cache_enabled", True)
    co.SearchCoalescer.submit = spy("submit", orig_submit)
    cache_edge.lookup = spy("lookup", orig_lookup)
    cache_edge.fill = spy("fill", orig_fill)
    svc = IndexService(node, window_ms=2.0, max_batch=64)
    try:
        dedup0 = CACHE.region_stats(region.id)
        R = p.reader
        for variant in (R.VectorFilterType.QUERY_PRE,
                        R.VectorFilterType.QUERY_POST):
            for _ in range(2):        # a second identical request too
                got = svc.submit(
                    region.id, q, 10, filter_mode=R.VectorFilterMode.TABLE,
                    filter_type=variant,
                    coprocessor=cop(p, "selective")).result(timeout=60)
                want = node.storage.vector_batch_search(
                    region, q, 10, filter_mode=R.VectorFilterMode.TABLE,
                    filter_type=variant, coprocessor=cop(p, "selective"))
                assert [[v.id for v in r] for r in got] == \
                    [[v.id for v in r] for r in want]
                keep = PREDICATES["selective"][1]
                assert all(keep(rows[v.id]) for r in got for v in r)
        assert calls == {"submit": 0, "lookup": 0, "fill": 0}
        assert svc._coalescer is None
        assert CACHE.region_stats(region.id) == dedup0
        # the control: an unfiltered request is coalesced and cached
        svc.submit(region.id, q, 10).result(timeout=60)
        assert calls["submit"] == 1 and calls["lookup"] == 1
    finally:
        svc.close()
        co.SearchCoalescer.submit = orig_submit
        cache_edge.lookup, cache_edge.fill = orig_lookup, orig_fill
        for f, v in saved.items():
            FLAGS.set(f, v)
        node.stop()
