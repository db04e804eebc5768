"""HNSW in the port (index/hnsw.py, ops/beam.py, kernel G's plain version,
the host graph's own copy and binding) against the JAX package's, on the
CPU: the cases of test_hnsw_device.py, and parity.

- The host path: both packages build the same native graph from the same
  rows and seed, so the candidate labels are identical and the reranked
  ids equal (distances within 1e-6 relative: two rerank products).
- The walk: the port's ``beam_search`` on the JAX package's own exported
  adjacency equals JAX ``beam_search`` (equal result sets, ``hops``,
  ``vcount`` and ``occ``) for L2, IP and COSINE, in fp32, bf16 and sq8.
  The one allowed difference is a slot at the beam's edge whose score ties
  the one it displaced within 1e-5 relative (two f32 sums in another
  order); the test checks that for any difference it meets.
- A walk of exactly ``max_iters`` rounds equals the JAX walk's early exit,
  and more rounds change nothing.

The port runs with ``device="cpu"``.
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
D = 32
TIERS = ("fp32", "bf16", "sq8")
METRICS_ = ("l2", "ip", "cosine")


class Pkg:
    MODS = {"base": "index.base", "factory": "index.factory",
            "config": "common.config", "metrics": "common.metrics",
            "dist": "ops.distance", "beam": "ops.beam"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    def metric(self, m):
        M = self.dist.Metric
        return {"l2": M.L2, "ip": M.INNER_PRODUCT, "cosine": M.COSINE}[m]

    def index(self, rid, metric="l2", **kw):
        b = self.base
        p = dict(index_type=b.IndexType.HNSW, dimension=D, nlinks=16,
                 efconstruction=80, metric=self.metric(metric))
        p.update(kw)
        return self.factory.new_index(rid, b.IndexParameter(**p), **self.kw)

    def flags(self, **kw):
        for k, v in kw.items():
            self.config.FLAGS.set(k, v)

    def counter(self, name, rid):
        return self.metrics.METRICS.counter(name, region_id=rid)


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    for name in PKGS:
        Pkg(name).flags(hnsw_device_search="auto", hnsw_device_beam=0,
                        hnsw_max_iters=48)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    n = 2500
    x = rng.standard_normal((n, D)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    q = x[:12] + 0.01 * rng.standard_normal((12, D)).astype(np.float32)
    return ids, x, q


@pytest.fixture()
def port():
    return Pkg("dingo_tpu_torch")


@pytest.fixture()
def ref():
    return Pkg("dingo_tpu")


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


# ---------------- parity with the JAX package --------------------------------

@pytest.mark.parametrize("metric", METRICS_)
def test_host_path_identical_to_reference(corpus, ref, port, metric):
    """Same hnsw.cc, same rows, same seed: the native candidate labels are
    identical and the reranked ids equal."""
    ids, x, q = corpus
    out = {}
    for p in (ref, port):
        p.flags(hnsw_device_search=False)
        idx = p.index(20, metric)
        idx.add(ids, x)
        qq = idx._prep_queries(q)
        labels = np.empty((len(q), 96), np.int64)
        dist = np.empty((len(q), 96), np.float32)
        import ctypes

        lib = idx._lib if p is port else __import__(
            "dingo_tpu.index.hnsw", fromlist=["_lib"])._lib()
        lib.hnsw_search(
            idx._graph, len(q),
            qq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 96, 96,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        out[p.name] = (labels, dist, idx.search(q, 10, ef=96))
    (la, da, ra), (lb, db, rb) = out["dingo_tpu"], out["dingo_tpu_torch"]
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(da, db)
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6,
                                   atol=1e-5)


def _ref_walk_inputs(ref, corpus, metric, tier):
    """A JAX index's exported graph and walk inputs, and the same as torch
    tensors."""
    import jax.numpy as jnp

    ids, x, q = corpus
    idx = ref.index(21, metric, precision=tier)
    idx.add(ids, x)
    st = idx.store
    with st.device_lock:
        idx._ensure_device_graph()
    qq = idx._prep_queries(q)
    sq = tier == "sq8"
    if sq:
        vmin, scale = st.sq_vmin_d, st.sq_scale_d
    else:
        vmin = jnp.zeros((D,), jnp.float32)
        scale = jnp.ones((D,), jnp.float32)
    jargs = (st.adj, st.vecs, st.sqnorm, st.device_mask(),
             st.device_mask(), jnp.asarray(qq),
             jnp.asarray(idx._entry_slot, jnp.int32), vmin, scale)
    if tier == "fp32":
        vecs = torch.from_numpy(np.asarray(st.vecs, np.float32))
    elif tier == "bf16":
        vecs = torch.from_numpy(np.asarray(st.vecs.astype(jnp.float32))
                                ).to(torch.bfloat16)
    else:
        vecs = torch.from_numpy(np.asarray(st.vecs))
    valid = torch.from_numpy(np.asarray(st.device_mask()))
    targs = (torch.from_numpy(np.asarray(st.adj)), vecs,
             torch.from_numpy(np.asarray(st.sqnorm)), valid, valid,
             torch.from_numpy(qq), idx._entry_slot,
             torch.from_numpy(np.asarray(vmin)),
             torch.from_numpy(np.asarray(scale)))
    return jargs, targs, sq


def _assert_walks_equal(want, got, scores_of):
    """Equal result sets, hops, vcount and occ; a differing slot must tie
    (1e-5 relative) the one it displaced at the beam's edge."""
    w_slots, w_hops, w_vc, w_occ = (np.asarray(a) for a in want)
    g_slots, g_hops, g_vc, g_occ = (t.numpy() for t in got)
    for qi in range(len(w_slots)):
        a, b = set(w_slots[qi].tolist()), set(g_slots[qi].tolist())
        if a != b:
            sa = scores_of(qi, sorted(a - b))
            sb = scores_of(qi, sorted(b - a))
            edge = min(scores_of(qi, sorted(a & b - {-1})))
            for s in np.concatenate([sa, sb]):
                assert abs(s - edge) <= 1e-5 * max(1.0, abs(edge)), qi
            continue
        assert w_hops[qi] == g_hops[qi] and w_vc[qi] == g_vc[qi] \
            and w_occ[qi] == g_occ[qi], qi


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("metric", METRICS_)
def test_walk_matches_reference_beam_search(corpus, ref, port, metric,
                                            tier):
    from dingo_tpu.ops.beam import beam_search as jbeam
    from dingo_tpu_torch.ops.kernel_beam import candidate_scores_plain

    jargs, targs, sq = _ref_walk_inputs(ref, corpus, metric, tier)
    jm, tm = ref.metric(metric), port.metric(metric)
    want = jbeam(*jargs, beam=64, max_iters=48, metric=jm, sq=sq)
    got = port.beam.beam_search(*targs, 64, 48, tm, sq)

    def scores_of(qi, slots):
        s = torch.tensor([slots], dtype=torch.int32)
        return candidate_scores_plain(
            targs[5][qi:qi + 1], targs[1], targs[2], s, tm,
            targs[7], targs[8]).numpy()[0]

    _assert_walks_equal(want, got, scores_of)


@pytest.mark.parametrize("metric", METRICS_)
def test_fixed_rounds_equal_early_exit(corpus, ref, port, metric):
    """The port's walk runs exactly max_iters rounds: it equals the JAX
    walk that exits early, and rounds past convergence change nothing
    (48 rounds equal 200 and equal max(hops) + 1)."""
    _, targs, sq = _ref_walk_inputs(ref, corpus, metric, "fp32")
    tm = port.metric(metric)
    base = port.beam.beam_search(*targs, 64, 48, tm, sq)
    cut = int(base[1].max()) + 1
    assert cut < 48                      # converged well inside the cap
    for iters in (cut, 200):
        out = port.beam.beam_search(*targs, 64, iters, tm, sq)
        for a, b in zip(base, out):
            assert torch.equal(a, b), iters
    # one round short of convergence is a different walk
    short = port.beam.beam_search(*targs, 64, cut - 2, tm, sq)
    assert not torch.equal(short[1], base[1])


@pytest.mark.parametrize("tier", ["fp32", "sq8"])
def test_carry_from_reference_snapshot(corpus, ref, port, tier, tmp_path):
    """A JAX TpuHnsw.save directory into a port TpuHnsw
    (carry.hnsw_from_reference): host-path results identical, device-walk
    candidate sets equal to the JAX package's on the same queries."""
    from dingo_tpu_torch.index.carry import hnsw_from_reference

    ids, x, q = corpus
    a = ref.index(22, "l2", precision=tier)
    a.add(ids[:2000], x[:2000])
    a.delete(ids[:50])
    a.save(str(tmp_path))
    b = hnsw_from_reference(tmp_path, device="cpu", index_id=22)
    assert b.parameter.nlinks == 16 and b.parameter.efconstruction == 80
    assert b._precision == tier and b.get_count() == a.get_count()
    for p, idx in ((ref, a), (port, b)):
        p.flags(hnsw_device_search=False)
    host_a, host_b = a.search(q, 10, ef=96), b.search(q, 10, ef=96)
    # sq8: XLA fuses the JAX package's jitted decode into an FMA, the port
    # rounds twice (one bf16 ulp on ~0.1% of values): the rerank's
    # distances then agree to the repo's kernel tolerance, not to 1e-6
    rtol, atol = (1e-6, 1e-5) if tier == "fp32" else (1e-4, 1e-3)
    for ra, rb in zip(host_a, host_b):
        np.testing.assert_array_equal(ra.ids, rb.ids)
        np.testing.assert_allclose(ra.distances, rb.distances, rtol=rtol,
                                   atol=atol)
    # the walk on each package's restored mirror: the same candidate sets
    from dingo_tpu.ops.beam import beam_search as jbeam
    import jax.numpy as jnp

    st = a.store
    with st.device_lock:
        a._ensure_device_graph()
    sq = tier == "sq8"
    jv = (st.sq_vmin_d, st.sq_scale_d) if sq else (
        jnp.zeros((D,), jnp.float32), jnp.ones((D,), jnp.float32))
    want = jbeam(st.adj, st.vecs, st.sqnorm, st.device_mask(),
                 st.device_mask(), jnp.asarray(a._prep_queries(q)),
                 jnp.asarray(a._entry_slot, jnp.int32), *jv, beam=64,
                 max_iters=48, metric=ref.metric("l2"), sq=sq)
    tb = b.store
    with tb.device_lock:
        b._ensure_device_graph()
    sq_on, vmin, scale = b._codec()
    got = port.beam.beam_search(tb.adj, tb.vecs, tb.sqnorm,
                                tb.device_mask(), tb.device_mask(),
                                torch.from_numpy(b._prep_queries(q)),
                                b._entry_slot, vmin, scale, 64, 48,
                                port.metric("l2"), sq_on)
    for w, g in zip(np.asarray(want[0]), got[0].numpy()):
        assert set(st.ids_of_slots(w.astype(np.int64)).tolist()) == \
            set(tb.ids_of_slots(g.astype(np.int64)).tolist())


# ---------------- the cases of test_hnsw_device.py ---------------------------

@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("metric", METRICS_)
def test_device_recall_at_least_host(corpus, port, metric, tier):
    ids, x, q = corpus
    idx = port.index(30, metric, precision=tier)
    idx.add(ids, x)
    want = exact_topk(x, ids, q, 10, metric)
    port.flags(hnsw_device_search=False)
    r_host = recall(idx.search(q, 10, ef=96), want)
    port.flags(hnsw_device_search=True)
    r_dev = recall(idx.search(q, 10, ef=96), want)
    assert r_dev >= r_host - 1e-9
    if metric == "l2":
        assert r_dev >= 0.9


def test_device_final_order_matches_host_on_agreeing_sets(corpus, port):
    ids, x, q = corpus
    idx = port.index(31)
    idx.add(ids, x)
    port.flags(hnsw_device_search=False)
    host = idx.search(q, 10, ef=128)
    port.flags(hnsw_device_search=True)
    dev = idx.search(q, 10, ef=128)
    want = exact_topk(x, ids, q, 10, "l2")
    assert recall(host, want) == 1.0 and recall(dev, want) == 1.0
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6,
                                   atol=1e-5)


def test_incremental_upsert_delete_adjacency_sync(corpus, port):
    ids, x, q = corpus
    idx = port.index(32)
    idx.add(ids[:2000], x[:2000])
    port.flags(hnsw_device_search=True)
    rb = port.counter("hnsw.adjacency_rebuilds", 32)
    idx.search(q, 10, ef=64)
    rb0 = rb.get()
    idx.search(q, 10, ef=64)              # read-only: no re-export
    assert rb.get() == rb0
    idx.upsert(ids[2000:2300], x[2000:2300])
    res = idx.search(x[2000:2300:30], 1, ef=64)
    assert rb.get() == rb0 + 1
    hit = np.mean([len(r.ids) and r.ids[0] == w
                   for r, w in zip(res, ids[2000:2300:30])])
    assert hit >= 0.9
    idx.delete(ids[:500])
    for r in idx.search(q, 20, ef=128):
        assert (r.ids >= 500).all()
    assert rb.get() == rb0 + 2


def test_no_new_shape_after_warmup(corpus, port):
    """After warmup over the (batch, beam) buckets, serving with any ef and
    batch inside them launches no new kernel shape (the sentinel's
    kernel.new_shapes, the port's counterpart of xla.recompiles)."""
    from dingo_tpu_torch.obs.sentinel import SENTINEL

    ids, x, q = corpus
    idx = port.index(33)
    idx.add(ids, x)
    port.flags(hnsw_device_search=True)
    idx.warmup(batches=(1, 8, 32), topk=10, ef=64)
    n0 = SENTINEL.new_shapes()
    for b, ef in ((1, 64), (5, 60), (8, 49), (27, 64), (32, 52)):
        idx.search(q[:1].repeat(b, axis=0), 10, ef=ef)
    assert SENTINEL.new_shapes() - n0 == 0


def test_filter_pushdown_equivalence(corpus, port):
    from dingo_tpu_torch.index.base import FilterSpec

    ids, x, q = corpus
    idx = port.index(34)
    idx.add(ids, x)
    spec = FilterSpec(ranges=[(500, 1500)])
    sub = (ids >= 500) & (ids < 1500)
    want = exact_topk(x[sub], ids[sub], q, 10, "l2")
    port.flags(hnsw_device_search=False)
    r_host = recall(idx.search(q, 10, spec, ef=160), want)
    port.flags(hnsw_device_search=True)
    hits = port.counter("hnsw.filter_mask_hits", 34)
    h0 = hits.get()
    res = idx.search(q, 10, spec, ef=160)
    for r in res:
        assert ((r.ids >= 500) & (r.ids < 1500)).all()
    assert recall(res, want) >= r_host - 1e-9
    idx.search(q, 10, spec, ef=160)
    assert hits.get() > h0


def test_snapshot_roundtrip_adjacency(tmp_path, corpus, port):
    ids, x, q = corpus
    idx = port.index(35)
    idx.add(ids[:2000], x[:2000])
    port.flags(hnsw_device_search=True)
    before = idx.search(q, 10, ef=96)
    idx.save(str(tmp_path))
    idx2 = port.index(35)
    idx2.load(str(tmp_path))
    assert idx2.store.adj is not None
    assert torch.equal(idx.store.adj, idx2.store.adj)
    rb = port.counter("hnsw.adjacency_rebuilds", 35)
    rb0 = rb.get()
    after = idx2.search(q, 10, ef=96)
    assert rb.get() == rb0      # mirror restored from the snapshot
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a.ids, b.ids)


def test_sq8_snapshot_keeps_codes(tmp_path, corpus, port):
    ids, x, q = corpus
    idx = port.index(36, precision="sq8")
    idx.add(ids[:1500], x[:1500])
    port.flags(hnsw_device_search=True)
    before = idx.search(q, 10, ef=96)
    idx.save(str(tmp_path))
    idx2 = port.index(36, precision="sq8")
    idx2.load(str(tmp_path))
    assert torch.equal(idx.store.vecs[:1500], idx2.store.vecs[:1500])
    after = idx2.search(q, 10, ef=96)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a.ids, b.ids)


def test_entry_tombstone_falls_back(corpus, port):
    ids, x, q = corpus
    idx = port.index(37)
    idx.add(ids[:300], x[:300])
    idx.delete(ids[:250])
    port.flags(hnsw_device_search=True)
    for r in idx.search(q, 5, ef=64):
        assert len(r.ids) > 0
        assert ((r.ids >= 250) & (r.ids < 300)).all()


@pytest.mark.parametrize("device_search", [True, False])
def test_empty_index(port, device_search):
    port.flags(hnsw_device_search=device_search)
    idx = port.index(38)
    res = idx.search(np.zeros((2, D), np.float32), 5)
    assert all(len(r.ids) == 0 for r in res)


# ---------------- entry points ----------------------------------------------

def test_factory_builds_port_hnsw_and_auto_is_host_on_cpu(corpus, port):
    """new_index(HNSW) builds the port's TpuHnsw; on the CPU the "auto"
    flags take the host graph and the host build (on a CUDA store they
    take the walk and the bulk build)."""
    from dingo_tpu_torch.common.config import (
        hnsw_device_build_enabled,
        hnsw_device_enabled,
    )
    from dingo_tpu_torch.index.hnsw import TpuHnsw

    idx = port.index(39)
    assert isinstance(idx, TpuHnsw)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not hnsw_device_enabled(cpu) and hnsw_device_enabled(cuda)
    assert not hnsw_device_build_enabled(cpu)
    assert hnsw_device_build_enabled(cuda)
    assert idx.bulk_builder() is None
    ids, x, q = corpus
    idx.add(ids[:500], x[:500])
    h = port.counter("hnsw.host_searches", 39)
    h0 = h.get()
    idx.search(q, 3)
    assert h.get() == h0 + 1


def test_hnsw_host_vectors_rejected_by_both_factories():
    """HNSW serves from the store's device rows: both factories refuse
    host_vectors with the same error (the port's built such an index)."""
    for name in PKGS:
        base = importlib.import_module(f"{name}.index.base")
        factory = importlib.import_module(f"{name}.index.factory")
        param = base.IndexParameter(index_type=base.IndexType.HNSW,
                                    dimension=8, host_vectors=True)
        kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        with pytest.raises(base.InvalidParameter,
                           match="HNSW does not support host_vectors"):
            factory.new_index(1, param, **kw)


def test_region_search_passes_ef_to_hnsw(corpus, port):
    """An HNSW region on a MonoStoreNode: the reader and the wrapper pass
    the request's ef to the index, as the JAX package's do."""
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.hnsw import TpuHnsw
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    ids, x, q = corpus
    b = port.base
    node = MonoStoreNode(device="cpu")
    region = node.create_region(RegionDefinition(
        region_id=7, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=b.IndexParameter(index_type=b.IndexType.HNSW,
                                         dimension=D, nlinks=16,
                                         efconstruction=80)))
    node.storage.vector_add(region, ids[:1000], x[:1000])
    seen = []
    orig = TpuHnsw.search_async

    def spy(self, queries, topk, filter_spec=None, ef=None, staged=None):
        seen.append(ef)
        return orig(self, queries, topk, filter_spec, ef, staged)

    TpuHnsw.search_async = spy
    try:
        rows = node.storage.vector_batch_search(region, q, 5, ef=77)
    finally:
        TpuHnsw.search_async = orig
        node.stop()
    assert seen == [77]
    want = exact_topk(x[:1000], ids[:1000], q, 5, "l2")
    assert np.mean([r[0].id == w[0] for r, w in zip(rows, want)]) >= 0.9
