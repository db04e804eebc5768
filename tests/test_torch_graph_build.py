"""The device bulk build of the port (ops/graph_build.py, the bulk session
of index/hnsw.py, the manager's bulk arm) against the JAX package's, on the
CPU, and the cases of test_graph_build.py.

Parity: the same rows through both packages' bulk builds, and one
``insert_batch`` call on the same partial graph, give adjacency rows equal
as sets, the same entry slot and the same ``reverse_dropped``, for L2, IP
and COSINE in fp32, bf16 and sq8. The port runs with ``device="cpu"``
(kernel G's plain version); "auto" keeps the bulk build off on the CPU, so
the cases force ``hnsw_device_build`` on, as the JAX package's do.
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
D = 32
METRICS_ = ("l2", "ip", "cosine")


class Pkg:
    MODS = {"base": "index.base", "factory": "index.factory",
            "config": "common.config", "metrics": "common.metrics",
            "dist": "ops.distance"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    def metric(self, m):
        M = self.dist.Metric
        return {"l2": M.L2, "ip": M.INNER_PRODUCT, "cosine": M.COSINE}[m]

    def param(self, metric="l2", **kw):
        b = self.base
        p = dict(index_type=b.IndexType.HNSW, dimension=D, nlinks=12,
                 efconstruction=64, metric=self.metric(metric))
        p.update(kw)
        return b.IndexParameter(**p)

    def index(self, rid, metric="l2", **kw):
        return self.factory.new_index(rid, self.param(metric, **kw),
                                      **self.kw)

    def flags(self, **kw):
        for k, v in kw.items():
            self.config.FLAGS.set(k, v)

    def counter(self, name, rid):
        return self.metrics.METRICS.counter(name, region_id=rid)

    def bulk_build(self, rid, ids, x, chunk=500, **param_kw):
        self.flags(hnsw_device_build=True)
        idx = self.index(rid, **param_kw)
        sess = idx.bulk_builder(expect_rows=len(ids))
        assert sess is not None
        for s in range(0, len(ids), chunk):
            sess.add(ids[s:s + chunk], x[s:s + chunk])
        sess.finish()
        return idx


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    for name in PKGS:
        Pkg(name).flags(hnsw_device_build="auto", hnsw_device_search="auto",
                        hnsw_build_batch=256, hnsw_build_alpha=1.0,
                        train_sample_rows=65536)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(18)
    n = 1200
    x = rng.standard_normal((n, D)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    q = x[:10] + 0.01 * rng.standard_normal((10, D)).astype(np.float32)
    return ids, x, q


@pytest.fixture()
def port():
    return Pkg("dingo_tpu_torch")


def exact_topk(x, ids, q, k, metric):
    if metric == "l2":
        score = -(((q[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    elif metric == "cosine":
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        score = qn @ xn.T
    else:
        score = q @ x.T
    return ids[np.argsort(-score, axis=1)[:, :k]]


def recall(res, want, k=10):
    return float(np.mean(
        [len(set(r.ids) & set(w)) / k for r, w in zip(res, want)]))


def _rows_as_sets(adj):
    return [frozenset(r.tolist()) - {-1} for r in np.asarray(adj)]


# ---------------- parity with the JAX package --------------------------------

@pytest.mark.parametrize("tier", ["fp32", "bf16", "sq8"])
@pytest.mark.parametrize("metric", METRICS_)
def test_bulk_build_matches_reference(corpus, metric, tier):
    """Both packages' bulk builds of the same rows (five insert batches):
    adjacency rows equal as sets, equal entry and reverse_dropped."""
    ids, x, _ = corpus
    out = {}
    for name in PKGS:
        p = Pkg(name)
        rd = p.counter("build.reverse_dropped", 60)
        r0 = rd.get()
        idx = p.bulk_build(60, ids, x, metric=metric, precision=tier)
        out[name] = (_rows_as_sets(idx.store.adj[:len(ids)]),
                     idx._entry_slot, rd.get() - r0)
    (ra, ea, da), (rb, eb, db) = out["dingo_tpu"], out["dingo_tpu_torch"]
    assert ea == eb and da == db
    assert ra == rb


def test_insert_batch_matches_reference(corpus):
    """One insert_batch call of each package on the same store and the same
    partial graph (after a first batch): equal rows as sets, entry and
    reverse_dropped."""
    import jax.numpy as jnp
    from dingo_tpu.ops.graph_build import insert_batch as jinsert
    from dingo_tpu_torch.ops.graph_build import insert_batch as tinsert

    ids, x, _ = corpus
    ref, port = Pkg("dingo_tpu"), Pkg("dingo_tpu_torch")
    a = ref.index(61)
    a.store.put(ids[:512], x[:512])
    st = a.store
    cap, deg = st.capacity, 24
    jm, tm = ref.metric("l2"), port.metric("l2")
    z, o = jnp.zeros((D,), jnp.float32), jnp.ones((D,), jnp.float32)
    adj0 = jnp.full((cap, deg), -1, jnp.int32)
    first = np.arange(256, dtype=np.int32)
    adj1, e1, _ = jinsert(adj0, st.vecs, st.sqnorm, st.device_mask(),
                          jnp.asarray(first), jnp.asarray(-1, jnp.int32),
                          z, o, beam=64, max_iters=48, metric=jm, sq=False,
                          alpha_sq=1.0)
    second = np.concatenate([np.arange(256, 512, dtype=np.int32)])
    adj_np = np.asarray(adj1)
    adj2, e2, dr = jinsert(adj1, st.vecs, st.sqnorm, st.device_mask(),
                           jnp.asarray(second), e1, z, o, beam=64,
                           max_iters=48, metric=jm, sq=False, alpha_sq=1.0)
    tadj = torch.full((cap + 1, deg), -1, dtype=torch.int32)
    tadj[:cap] = torch.from_numpy(adj_np)
    vecs = torch.from_numpy(np.asarray(st.vecs))
    sqn = torch.from_numpy(np.asarray(st.sqnorm))
    valid = torch.from_numpy(np.asarray(st.device_mask()))
    te, tdr = tinsert(tadj, vecs, sqn, valid, torch.from_numpy(second),
                      torch.tensor(int(e1), dtype=torch.int32),
                      torch.zeros(D), torch.ones(D), 64, 48, tm, False, 1.0)
    assert int(te) == int(e2) and int(tdr) == int(dr)
    assert _rows_as_sets(tadj[:cap]) == _rows_as_sets(adj2)


# ---------------- the cases of test_graph_build.py ---------------------------

@pytest.mark.parametrize("tier", ["fp32", "sq8"])
@pytest.mark.parametrize("metric", METRICS_)
def test_device_built_recall_at_least_host_built(corpus, port, metric,
                                                 tier):
    """Searching the device-built graph reaches the host-built graph's
    recall less 0.01 at equal ef (both searched by the device walk). The
    sq8 arm builds on quantized scores, so its graph sees another geometry
    than the host graph's f32 one: it keeps the JAX package's own noise
    floor for that case, 0.05 (test_graph_build.py)."""
    ids, x, q = corpus
    dev = port.bulk_build(62, ids, x, metric=metric, precision=tier)
    port.flags(hnsw_device_build=False)
    host = port.index(63, metric, precision=tier)
    host.add(ids, x)
    want = exact_topk(x, ids, q, 10, metric)
    port.flags(hnsw_device_search=True)
    r_host = recall(host.search(q, 10, ef=128), want)
    r_dev = recall(dev.search(q, 10, ef=128), want)
    assert r_dev >= r_host - (0.01 if tier == "fp32" else 0.05)
    if metric == "l2" and tier == "fp32":
        assert r_dev >= 0.9


def test_adjacency_byte_stable_under_fixed_seed(corpus, port):
    ids, x, _ = corpus
    a = port.bulk_build(64, ids, x)
    b = port.bulk_build(65, ids, x)
    assert torch.equal(a.store.adj, b.store.adj)
    assert a._entry_slot == b._entry_slot


def test_incremental_insert_parity_after_bulk_build(corpus, port):
    ids, x, q = corpus
    rng = np.random.default_rng(5)
    idx = port.bulk_build(66, ids, x)
    assert idx._native_pending
    assert idx.bulk_builder() is None       # a second session refuses
    bf = port.counter("build.backfills", 66)
    bf0 = bf.get()
    extra = rng.standard_normal((60, D)).astype(np.float32)
    eids = np.arange(len(ids), len(ids) + 60, dtype=np.int64)
    idx.upsert(eids, extra)                  # back-fills, then inserts
    assert bf.get() == bf0 + 1
    assert not idx._native_pending
    port.flags(hnsw_device_search=True)
    res = idx.search(extra[:10], 1, ef=64)
    assert np.mean([len(r.ids) and r.ids[0] == w
                    for r, w in zip(res, eids[:10])]) >= 0.9
    port.flags(hnsw_device_search=False)
    want = exact_topk(x, ids, q, 10, "l2")
    assert recall(idx.search(q, 10, ef=128), want) >= 0.9
    idx.delete(eids)
    port.flags(hnsw_device_search=True)
    for r in idx.search(extra[:5], 5, ef=64):
        assert (r.ids < len(ids)).all()


def test_no_new_shape_across_second_build(corpus, port):
    """A second bulk build at identical shapes launches no new kernel
    shape (the sentinel's kernel.new_shapes; the JAX package's
    xla.recompiles)."""
    from dingo_tpu_torch.obs.sentinel import SENTINEL

    ids, x, _ = corpus
    port.bulk_build(67, ids, x)
    n0 = SENTINEL.new_shapes()
    port.bulk_build(68, ids, x)
    assert SENTINEL.new_shapes() - n0 == 0


def test_save_load_after_bulk_build(tmp_path, corpus, port):
    ids, x, q = corpus
    idx = port.bulk_build(69, ids[:600], x[:600])
    idx.save(str(tmp_path))
    assert not idx._native_pending
    idx2 = port.index(69)
    idx2.load(str(tmp_path))
    port.flags(hnsw_device_search=True)
    want = exact_topk(x[:600], ids[:600], q, 10, "l2")
    assert recall(idx2.search(q, 10, ef=128), want) >= 0.9


def test_reverse_dropped_counted(corpus, port):
    ids, x, _ = corpus
    rd = port.counter("build.reverse_dropped", 70)
    rd0 = rd.get()
    port.flags(hnsw_device_build=True)
    idx = port.index(70)
    sess = idx.bulk_builder(expect_rows=len(ids))
    for s in range(0, len(ids), 500):
        sess.add(ids[s:s + 500], x[s:s + 500])
    stats = sess.finish()
    assert rd.get() - rd0 == stats["reverse_dropped"] > 0


def test_build_phase_timings_split(corpus, port):
    """A builder given a timings dict splits its time into the walk, the
    occlusion selection and the reprune."""
    ids, x, _ = corpus
    port.flags(hnsw_device_build=True)
    idx = port.index(71)
    sess = idx.bulk_builder(expect_rows=600)
    sess.builder.timings = {}
    sess.add(ids[:600], x[:600])
    sess.finish()
    t = sess.builder.timings
    assert set(t) == {"walk", "select", "reprune"}
    assert all(v > 0 for v in t.values())


# -- the manager: streaming build, bulk arm, re-materialization ---------------

def _make_stack(rid, index_type="hnsw", **param_kw):
    from dingo_tpu_torch.engine.mono_engine import MonoStoreEngine
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.engine.storage import Storage
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.store.region import (
        Region,
        RegionDefinition,
        RegionType,
    )

    raw = MemEngine()
    engine = MonoStoreEngine(raw, device="cpu")
    storage = Storage(engine)
    defaults = dict(index_type=IndexType(index_type), dimension=16,
                    ncentroids=4, default_nprobe=4, nlinks=8,
                    efconstruction=48)
    defaults.update(param_kw)
    region = Region(RegionDefinition(
        region_id=rid,
        start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(0, 1 << 40),
        region_type=RegionType.INDEX,
        index_parameter=IndexParameter(**defaults),
    ), device="cpu")
    w = region.vector_index_wrapper
    w.build_own()
    w.set_own(w.own_index)
    return raw, engine, storage, region


def test_manager_build_streams_bounded_chunks(monkeypatch):
    """The build pages the engine scan in BUILD_BATCH-row chunks."""
    from dingo_tpu_torch.index.manager import BUILD_BATCH, VectorIndexManager
    from dingo_tpu_torch.index.vector_reader import VectorReader

    raw, engine, storage, region = _make_stack(72)
    rng = np.random.default_rng(2)
    n = BUILD_BATCH + 500
    x = rng.standard_normal((n, 16)).astype(np.float32)
    all_ids = np.arange(n, dtype=np.int64)
    for s in range(0, n, 4096):
        storage.vector_add(region, all_ids[s:s + 4096], x[s:s + 4096])
    pages = []
    orig = VectorReader.scan_pages

    def spy(self, rows):
        for ids, vecs in orig(self, rows):
            pages.append(len(ids))
            yield ids, vecs

    monkeypatch.setattr(VectorReader, "scan_pages", spy)
    index = VectorIndexManager(raw, device="cpu").build_index(region)
    assert index.get_count() == n
    assert len(pages) >= 2 and max(pages) <= BUILD_BATCH
    res = index.search(x[:2], 1)
    assert [r.ids[0] for r in res] == [0, 1]


def test_manager_build_uses_bulk_device_arm(port):
    from dingo_tpu_torch.index.manager import VectorIndexManager

    raw, engine, storage, region = _make_stack(73)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((900, 16)).astype(np.float32)
    storage.vector_add(region, np.arange(900, dtype=np.int64), x)
    port.flags(hnsw_device_build=True)
    db = port.counter("build.device_builds", 73)
    db0 = db.get()
    mgr = VectorIndexManager(raw, device="cpu")
    assert mgr.rebuild(region)
    assert db.get() == db0 + 1
    index = region.vector_index_wrapper.own_index
    assert index.get_count() == 900
    assert [r.ids[0] for r in index.search(x[:2], 1)] == [0, 1]


def test_remat_override_goes_through_bulk_path(port):
    from dingo_tpu_torch.index.manager import VectorIndexManager
    from dingo_tpu_torch.index.recovery import DeviceRecoveryPlane

    raw, engine, storage, region = _make_stack(74)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    storage.vector_add(region, np.arange(600, dtype=np.int64), x)
    port.flags(hnsw_device_build=True)
    db = port.counter("build.device_builds", 74)
    db0 = db.get()
    override = DeviceRecoveryPlane.remat_parameter(
        region.definition.index_parameter)
    mgr = VectorIndexManager(raw, device="cpu")
    assert mgr.rebuild(region, param_override=override)
    assert db.get() == db0 + 1
    index = region.vector_index_wrapper.own_index
    assert index._precision == "sq8"
    assert region.definition.index_parameter.precision == ""
    assert index.get_count() == 600


def test_manager_train_failure_counted_not_swallowed(port):
    from dingo_tpu_torch.index.manager import VectorIndexManager

    raw, engine, storage, region = _make_stack(75, index_type="ivf_flat")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    storage.vector_add(region, np.arange(3, dtype=np.int64), x)
    tf = port.counter("build.train_failures", 75)
    t0 = tf.get()
    index = VectorIndexManager(raw, device="cpu").build_index(region)
    assert tf.get() == t0 + 1
    assert not index.is_trained()
    assert index.get_count() == 3


def test_manager_build_trains_ivf_from_stream():
    from dingo_tpu_torch.index.manager import VectorIndexManager

    raw, engine, storage, region = _make_stack(76, index_type="ivf_flat")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    storage.vector_add(region, np.arange(300, dtype=np.int64), x)
    index = VectorIndexManager(raw, device="cpu").build_index(region)
    assert index.is_trained()
    assert [r.ids[0] for r in index.search(x[:3], 1)] == [0, 1, 2]


def test_train_sample_rows_conf_caps_device_sample(port):
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index

    idx = new_index(77, IndexParameter(index_type=IndexType.IVF_FLAT,
                                       dimension=8, ncentroids=4),
                    device="cpu")
    rng = np.random.default_rng(8)
    n = 300
    idx.add(np.arange(n, dtype=np.int64),
            rng.standard_normal((n, 8)).astype(np.float32))
    port.flags(train_sample_rows=64)
    assert int(idx._train_rows_device(0).shape[0]) == 64
    assert int(idx._train_rows_device(32).shape[0]) == 32
    port.flags(train_sample_rows=0)
    assert int(idx._train_rows_device(128).shape[0]) == n


def test_resolve_train_cap_semantics(port):
    from dingo_tpu_torch.index.flat import _resolve_train_cap

    port.flags(train_sample_rows=1000)
    assert _resolve_train_cap(0) == 1000
    assert _resolve_train_cap(500) == 500
    assert _resolve_train_cap(5000) == 1000
    port.flags(train_sample_rows=0)
    assert _resolve_train_cap(500) == 0
