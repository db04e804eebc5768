"""The binary (hamming) family and range search of the port against the
JAX package: ``bits_to_pm1`` and ``pairwise_hamming``, TpuBinaryFlat and
TpuBinaryIvfFlat through the cases of test_binary_ivf_flat.py and
test_index_flat.py (``test_binary_flat_hamming``, ``test_range_search``),
snapshots both ways, ``index_from_reference`` for binary, and a binary
region through Storage (brute force, trained, radius, filter and a
degraded region's host path).

Seeded numpy inputs go through both packages. Hamming distances are
integers and must be equal; ids are compared modulo ties: every returned
id's exact (numpy) hamming distance equals the distance returned beside
it, and the sorted distances equal the exact top-k's. Float range search
compares distances within rtol 1e-4, atol 1e-3. The port runs on the CPU
(``device="cpu"``)."""

import importlib

import numpy as np
import pytest
import torch

from dingo_tpu.index.base import InvalidParameter as JInvalid
from dingo_tpu.index.base import NotTrained as JNotTrained
from dingo_tpu.ops import distance as jdist
from dingo_tpu.ops.distance import Metric as JMetric
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.base import InvalidParameter as TInvalid
from dingo_tpu_torch.index.base import NotTrained as TNotTrained
from dingo_tpu_torch.index.carry import index_from_reference
from dingo_tpu_torch.index.factory import new_index as t_new_index
from dingo_tpu_torch.index.flat import TpuBinaryFlat, flat_search_plain
from dingo_tpu_torch.index.ivf_flat import TpuBinaryIvfFlat, ivf_scan_scores
from dingo_tpu_torch.ops import distance as tdist
from dingo_tpu_torch.ops.distance import Metric as TMetric

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
RTOL, ATOL = 1e-4, 1e-3
DIM_BITS = 128
NBYTES = DIM_BITS // 8


def hamming(q, x):
    """Exact [b, n] hamming distances of packed rows (numpy)."""
    return np.unpackbits(q[:, None, :] ^ x[None, :, :], axis=-1).sum(-1)


class Side:
    """One package's index constructors (the port's on the CPU)."""

    def __init__(self, name):
        self.name = name
        self.port = name == "dingo_tpu_torch"
        base = importlib.import_module(f"{name}.index.base")
        self.Param, self.Type, self.Filter = (base.IndexParameter,
                                              base.IndexType, base.FilterSpec)
        self.Metric = importlib.import_module(f"{name}.ops.distance").Metric
        self._new = importlib.import_module(f"{name}.index.factory").new_index

    def new(self, index_type, dim=DIM_BITS, index_id=1, **kw):
        metric = kw.pop("metric", "hamming")
        param = self.Param(index_type=self.Type(index_type), dimension=dim,
                           metric=self.Metric(metric), **kw)
        if self.port:
            return self._new(index_id, param, device="cpu")
        return self._new(index_id, param)

    def binary_ivf(self, nlist=8, index_id=1):
        return self.new("binary_ivf_flat", ncentroids=nlist,
                        index_id=index_id)


@pytest.fixture(params=PKGS)
def side(request):
    return Side(request.param)


def both():
    return [Side(p) for p in PKGS]


@pytest.fixture(scope="module")
def corpus():
    """test_binary_ivf_flat.py's clustered corpus: few bits flipped around
    8 prototypes."""
    rng = np.random.default_rng(7)
    protos = rng.integers(0, 256, (8, NBYTES), dtype=np.uint8)
    rows = []
    for i in range(2000):
        base = protos[i % 8].copy()
        flip = rng.integers(0, NBYTES, 2)
        base[flip] ^= rng.integers(1, 256, 2).astype(np.uint8)
        rows.append(base)
    x = np.stack(rows)
    return np.arange(len(x), dtype=np.int64), x


def assert_exact_hamming(res, q, x_of, k):
    """Each reply: its distances equal the exact top-k's, and every id's
    exact distance equals the distance beside it (ids modulo ties)."""
    for qi, r in enumerate(res):
        ids = np.asarray(r.ids, np.int64)
        got = hamming(q[qi:qi + 1], x_of(ids))[0] if len(ids) else []
        np.testing.assert_array_equal(r.distances, got)
        all_ids, all_x = x_of(None)
        want = np.sort(hamming(q[qi:qi + 1], all_x)[0])[:k]
        np.testing.assert_array_equal(r.distances, want)
        assert len(set(ids.tolist())) == len(ids)


def rows_of(ids_all, x):
    pos = {int(v): i for i, v in enumerate(ids_all)}

    def x_of(ids):
        if ids is None:
            return ids_all, x
        return x[[pos[int(i)] for i in ids]]
    return x_of


def assert_same_hamming(jres, tres):
    """Both packages' replies: equal distances, and the same id set at
    every distance but the last one of a row (ties there may cross the
    k-th place and pick other ids)."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.distances, a.distances)
        for v in np.unique(a.distances)[:-1]:
            sel = a.distances == v
            assert set(a.ids[sel].tolist()) == set(b.ids[sel].tolist())


# ---------------- ops ---------------------------------------------------------

@pytest.mark.parametrize("nbits", [64, 61, 8])
def test_bits_to_pm1_matches_reference(nbits):
    rng = np.random.default_rng(nbits)
    packed = rng.integers(0, 256, (9, -(-nbits // 8)), dtype=np.uint8)
    want = np.asarray(jdist.bits_to_pm1(packed, nbits))
    got = tdist.bits_to_pm1(torch.from_numpy(packed), nbits).numpy()
    np.testing.assert_array_equal(got, want)
    # little-endian within a byte, as numpy's bitorder="little"
    lit = np.unpackbits(packed, axis=1, bitorder="little")[:, :nbits]
    np.testing.assert_array_equal(got, lit.astype(np.float32) * 2 - 1)


@pytest.mark.parametrize("nbits", [64, 61])
def test_pairwise_hamming_exact_and_matches_reference(nbits):
    rng = np.random.default_rng(3)
    nb = -(-nbits // 8)
    q = rng.integers(0, 256, (5, nb), dtype=np.uint8)
    x = rng.integers(0, 256, (37, nb), dtype=np.uint8)
    got = tdist.pairwise_hamming(torch.from_numpy(q), torch.from_numpy(x),
                                 nbits).numpy()
    want = np.asarray(jdist.pairwise_hamming(q, x, nbits))
    np.testing.assert_array_equal(got, want)
    qb = np.unpackbits(q, axis=1, bitorder="little")[:, :nbits]
    xb = np.unpackbits(x, axis=1, bitorder="little")[:, :nbits]
    np.testing.assert_array_equal(got, (qb[:, None] != xb[None]).sum(-1))
    scores = tdist.score_matrix(torch.from_numpy(q), torch.from_numpy(x),
                                TMetric.HAMMING, nbits=nbits).numpy()
    np.testing.assert_array_equal(scores, -got)
    np.testing.assert_array_equal(
        scores, np.asarray(jdist.score_matrix(q, x, JMetric.HAMMING,
                                              nbits=nbits)))


def test_pm1_product_is_exact_past_bf16():
    """The int8 product of +/-1 rows is exact at widths where a bf16
    result would round (integers past 256), for any query row count."""
    rng = np.random.default_rng(5)
    x = (rng.integers(0, 2, (40, 1024)) * 2 - 1).astype(np.int8)
    for b in (1, 17, 33):
        q = (rng.integers(0, 2, (b, 1024)) * 2 - 1).astype(np.float32)
        got = tdist._dot(torch.from_numpy(q), torch.from_numpy(x)).numpy()
        want = q.astype(np.int64) @ x.astype(np.int64).T
        np.testing.assert_array_equal(got, want)
    x[:, :] = 1
    got = tdist._dot(torch.ones((2, 1024)), torch.from_numpy(x)).numpy()
    assert (got == 1024).all()


def test_metric_docstring_and_ascending():
    assert tdist.metric_ascending(TMetric.HAMMING)
    assert "not ported" not in (TMetric.__doc__ or "")


# ---------------- TpuBinaryFlat ------------------------------------------------

def test_binary_flat_hamming(side):
    """test_index_flat.py::test_binary_flat_hamming on both packages."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (200, 8), dtype=np.uint8)
    ids = np.arange(200, dtype=np.int64)
    idx = side.new("binary_flat", dim=64, index_id=2)
    idx.add(ids, x)
    res = idx.search(x[[5]], 3)
    assert res[0].ids[0] == 5 and res[0].distances[0] == 0.0


def test_binary_flat_matches_reference_and_numpy():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (700, 8), dtype=np.uint8)
    ids = np.arange(1000, 1700, dtype=np.int64)
    q = x[[3, 70, 400, 699]].copy()
    q[:, 0] ^= 1
    res = {}
    for s in both():
        idx = s.new("binary_flat", dim=64)
        idx.upsert(ids, x)
        res[s.name] = idx.search(q, 10)
    assert_exact_hamming(res["dingo_tpu_torch"], q, rows_of(ids, x), 10)
    assert_same_hamming(res["dingo_tpu"], res["dingo_tpu_torch"])


def test_binary_flat_filter_upsert_delete_match_reference():
    rng = np.random.default_rng(12)
    x = rng.integers(0, 256, (300, 8), dtype=np.uint8)
    ids = np.arange(300, dtype=np.int64)
    new_rows = rng.integers(0, 256, (20, 8), dtype=np.uint8)
    out = {}
    for s in both():
        idx = s.new("binary_flat", dim=64)
        idx.add(ids, x)
        spec = s.Filter(ranges=[(100, 200)])
        a = idx.search(x[:4], 6, spec)
        idx.upsert(ids[:20], new_rows)       # rows replaced in place
        idx.delete(ids[250:])
        b = idx.search(np.concatenate([new_rows[:3], x[250:252]]), 6)
        out[s.name] = (a, b, idx.get_count())
    j, t = out["dingo_tpu"], out["dingo_tpu_torch"]
    assert t[2] == j[2] == 250
    assert all(100 <= i < 200 for r in t[0] for i in r.ids)
    assert_same_hamming(j[0], t[0])
    assert_same_hamming(j[1], t[1])
    assert [r.ids[0] for r in t[1][:3]] == [0, 1, 2]
    assert all(i < 250 for r in t[1] for i in r.ids)


def test_binary_flat_stays_on_the_plain_arm(monkeypatch):
    """int8 rows never reach B1/B4 (JAX flat.py:544-546), even with the
    crossover forced on; the plain arm is counted."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.ops import kernel_topk, kernel_topk_pruned

    def boom(*a, **kw):
        raise AssertionError("a kernel took int8 rows")

    monkeypatch.setattr(kernel_topk, "fused_topk", boom)
    monkeypatch.setattr(kernel_topk_pruned, "pruned_fused_search", boom)
    saved = FLAGS.get("use_pallas_fused_search")
    FLAGS.set("use_pallas_fused_search", True)
    try:
        rng = np.random.default_rng(4)
        x = rng.integers(0, 256, (100, 8), dtype=np.uint8)
        idx = t_new_index(1, TParam(index_type=TType.BINARY_FLAT,
                                    dimension=64, metric=TMetric.HAMMING),
                          device="cpu")
        idx.add(np.arange(100, dtype=np.int64), x)
        before = flat_search_plain.calls
        assert idx.search(x[:2], 3)[0].ids[0] == 0
        assert flat_search_plain.calls == before + 1
        assert idx.store.vecs.dtype == torch.int8
        assert idx.store.vecs_blk is None
        assert float(idx.store.sqnorm[0]) == 64.0
    finally:
        FLAGS.set("use_pallas_fused_search", saved)


def test_binary_flat_bad_shapes(side):
    Invalid = TInvalid if side.port else JInvalid
    with pytest.raises(Invalid):
        side.new("binary_flat", dim=65)
    idx = side.new("binary_flat", dim=64)
    with pytest.raises(Invalid):
        idx.add(np.arange(2, dtype=np.int64), np.zeros((2, 5), np.uint8))
    with pytest.raises(Invalid):
        idx.search(np.zeros((1, 5), np.uint8), 1)


# ---------------- range search --------------------------------------------------

def test_binary_range_search_is_the_exact_set():
    rng = np.random.default_rng(21)
    x = rng.integers(0, 256, (600, 8), dtype=np.uint8)
    ids = np.arange(600, dtype=np.int64)
    q = x[[10, 20]]
    hd = hamming(q, x)
    radius = float(np.sort(hd[0])[30])
    out = {}
    for s in both():
        idx = s.new("binary_flat", dim=64)
        idx.add(ids, x)
        out[s.name] = idx.range_search(q, radius)
    for qi in range(2):
        want = set(ids[hd[qi] <= radius].tolist())
        for name in PKGS:
            r = out[name][qi]
            assert set(r.ids.tolist()) == want
            assert (r.distances <= radius).all()
    # the cap: a radius past every row returns `limit` rows
    idx = t_new_index(1, TParam(index_type=TType.BINARY_FLAT, dimension=64,
                                metric=TMetric.HAMMING), device="cpu")
    idx.add(ids, x)
    assert len(idx.range_search(q, 64.0, limit=50)[0].ids) == 50


def _float_corpus(n=1000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.int64),
            rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_range_search_matches_reference(metric):
    """test_index_flat.py::test_range_search on both packages, on FLAT and
    on a full-probe IVF_FLAT: the exact set within the radius."""
    ids, x = _float_corpus()
    q = x[[0, 7]]
    # the radius sits midway between two neighbours' distances, so the
    # f32 summation order of either package cannot move a row across it
    if metric == "l2":
        d = ((q[:, None] - x[None]) ** 2).sum(-1)
        radius = float(np.sort(d[0])[20:22].mean())
        inside = d <= radius
    else:
        d = q @ x.T
        radius = float(np.sort(d[0])[-22:-20].mean())
        inside = d >= radius
    for itype, kw in (("flat", {}),
                      ("ivf_flat", {"ncentroids": 8, "default_nprobe": 8})):
        out = {}
        for s in both():
            idx = s.new(itype, dim=16, metric=metric, **kw)
            idx.add(ids, x)
            if itype == "ivf_flat":
                idx.train()
            out[s.name] = idx.range_search(q, radius)
        for qi in range(2):
            want = set(ids[inside[qi]].tolist())
            j, t = out["dingo_tpu"][qi], out["dingo_tpu_torch"][qi]
            assert set(t.ids.tolist()) == want
            assert set(j.ids.tolist()) == want
            order = np.argsort(t.ids)
            jorder = np.argsort(j.ids)
            np.testing.assert_allclose(t.distances[order],
                                       j.distances[jorder], rtol=RTOL,
                                       atol=ATOL)


def test_range_search_caps_at_limit_and_takes_the_plain_arm():
    """k = 1024 is past the kernels' ceiling: FLAT takes the plain arm, as
    the JAX package's k > 64 crossover does."""
    ids, x = _float_corpus(n=3000)
    idx = t_new_index(1, TParam(index_type=TType.FLAT, dimension=16),
                      device="cpu")
    idx.add(ids, x)
    before = flat_search_plain.calls
    res = idx.range_search(x[:2], 1e9)
    assert flat_search_plain.calls == before + 1
    assert [len(r.ids) for r in res] == [1024, 1024]


# ---------------- TpuBinaryIvfFlat: test_binary_ivf_flat.py's cases -------------

def test_untrained_raises_not_trained(side, corpus):
    ids, x = corpus
    idx = side.binary_ivf()
    idx.upsert(ids[:100], x[:100])
    with pytest.raises(TNotTrained if side.port else JNotTrained):
        idx.search(x[:1], 3)


def test_trained_search_exact_at_full_probe(corpus):
    ids, x = corpus
    q = x[[5, 900, 1500]]
    out = {}
    for s in both():
        idx = s.binary_ivf()
        idx.upsert(ids, x)
        idx.train()
        out[s.name] = idx.search(q, 5, nprobe=idx.nlist)
    for name in PKGS:
        for qi, r in enumerate(out[name]):
            hd = hamming(q[qi][None, :], x)[0]
            np.testing.assert_array_equal(np.sort(r.distances),
                                          np.sort(hd)[:5])
            assert r.ids[0] == ids[[5, 900, 1500][qi]] or \
                r.distances[0] == 0.0
    assert_exact_hamming(out["dingo_tpu_torch"], q, rows_of(ids, x), 5)
    assert_same_hamming(out["dingo_tpu"], out["dingo_tpu_torch"])


def test_nprobe_subset_recall(side, corpus):
    ids, x = corpus
    idx = side.binary_ivf()
    idx.upsert(ids, x)
    idx.train()
    q = x[:16]
    res = idx.search(q, 10, nprobe=2)
    hits = 0
    for qi, r in enumerate(res):
        hd = hamming(q[qi][None, :], x)[0]
        kth = np.sort(hd)[9]
        # counted modulo ties: a hit is any id at most the k-th distance
        hits += sum(hd[int(i)] <= kth for i in r.ids) / 10
    assert hits / len(q) > 0.5


def test_partial_probe_equals_reference_on_carried_state(corpus, tmp_path):
    """With the JAX index's centroids and assignment carried across, a
    partial-probe search is the same computation in both packages."""
    ids, x = corpus
    jidx = Side("dingo_tpu").binary_ivf()
    jidx.upsert(ids, x)
    jidx.train()
    jidx.save(str(tmp_path / "j"))
    tidx = index_from_reference(str(tmp_path / "j"), device="cpu")
    assert isinstance(tidx, TpuBinaryIvfFlat)
    q = x[[1, 2, 300, 1999]]
    for nprobe in (1, 2, 3):
        assert_same_hamming(jidx.search(q, 10, nprobe=nprobe),
                            tidx.search(q, 10, nprobe=nprobe))


def test_filter_and_delete(corpus):
    ids, x = corpus
    out = {}
    for s in both():
        idx = s.binary_ivf(index_id=2)
        idx.upsert(ids, x)
        idx.train()
        a = idx.search(x[[5]], 5, nprobe=idx.nlist,
                       filter_spec=s.Filter(ranges=[(100, 1000)]))
        idx.delete(ids[:10])
        b = idx.search(x[[5]], 5, nprobe=idx.nlist)
        out[s.name] = (a, b)
    for name in PKGS:
        a, b = out[name]
        assert all(100 <= i < 1000 for i in a[0].ids)
        assert 5 not in b[0].ids
    for k in range(2):
        assert_same_hamming(out["dingo_tpu"][k], out["dingo_tpu_torch"][k])


def test_upsert_after_train_takes_the_incremental_view(corpus):
    ids, x = corpus
    rng = np.random.default_rng(8)
    fresh = rng.integers(0, 256, (40, NBYTES), dtype=np.uint8)
    fresh_ids = np.arange(5000, 5040, dtype=np.int64)
    q = fresh[:4]
    out = {}
    for s in both():
        idx = s.binary_ivf()
        idx.upsert(ids, x)
        idx.train()
        idx.search(x[:1], 3, nprobe=idx.nlist)     # builds the view
        idx.upsert(fresh_ids, fresh)
        out[s.name] = idx.search(q, 5, nprobe=idx.nlist)
        if s.port:
            assert idx.full_rebuilds == 1          # appended in place
    assert [r.ids[0] for r in out["dingo_tpu_torch"]] == list(fresh_ids[:4])
    assert_same_hamming(out["dingo_tpu"], out["dingo_tpu_torch"])


def test_save_load_roundtrip(side, corpus, tmp_path):
    ids, x = corpus
    idx = side.binary_ivf(index_id=3)
    idx.upsert(ids[:500], x[:500])
    idx.train()
    want = [(list(r.ids), list(r.distances))
            for r in idx.search(x[:4], 5, nprobe=idx.nlist)]
    idx.save(str(tmp_path / "b"))
    idx2 = side.binary_ivf(index_id=3)
    idx2.load(str(tmp_path / "b"))
    got = [(list(r.ids), list(r.distances))
           for r in idx2.search(x[:4], 5, nprobe=idx2.nlist)]
    assert want == got


def test_bad_dimension_rejected(side):
    Invalid = TInvalid if side.port else JInvalid
    with pytest.raises(Invalid):
        side.new("binary_ivf_flat", dim=65, ncentroids=4, index_id=4)
    idx = side.binary_ivf()
    with pytest.raises(Invalid):
        idx.upsert(np.arange(2, dtype=np.int64), np.zeros((2, 5), np.uint8))
    # a plain IVF_FLAT refuses HAMMING in both packages
    with pytest.raises(Invalid):
        side.new("ivf_flat", ncentroids=4)


def test_binary_ivf_plain_arm_and_no_pruning_metadata(corpus, monkeypatch):
    """HAMMING is outside the kernels' route and int8 views get no block
    norms (JAX ivf_flat.py:722, :878-885), even with every flag forced."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.ops import kernel_ivf, kernel_ivf_pruned

    def boom(*a, **kw):
        raise AssertionError("a kernel took the binary scan")

    monkeypatch.setattr(kernel_ivf, "ivf_list_topk", boom)
    monkeypatch.setattr(kernel_ivf_pruned, "ivf_pruned_search", boom)
    saved = FLAGS.get("use_pallas_ivf_search")
    FLAGS.set("use_pallas_ivf_search", True)
    try:
        ids, x = corpus
        idx = Side("dingo_tpu_torch").binary_ivf()
        idx.upsert(ids, x)
        idx.train(x[:400])                 # an explicit, packed train set
        before = ivf_scan_scores.calls
        res = idx.search(x[:3], 4, nprobe=4)
        assert ivf_scan_scores.calls == before + 1
        assert idx._bucket_bsq is None and idx._buckets.dtype == torch.int8
        assert idx.centroids.dtype == torch.float32
        assert [r.distances[0] for r in res] == [0.0, 0.0, 0.0]
        assert idx.warmup(batches=(1, 8)) == 2     # packed warmup rows
    finally:
        FLAGS.set("use_pallas_ivf_search", saved)


# ---------------- snapshots and the carry ----------------------------------------

@pytest.mark.parametrize("itype", ["binary_flat", "binary_ivf_flat"])
def test_snapshots_both_ways(itype, corpus, tmp_path):
    """A JAX snapshot loads into the port and a port snapshot into the JAX
    package; the npz holds packed rows in both directions."""
    ids, x = corpus
    kw = {"ncentroids": 8} if itype == "binary_ivf_flat" else {}
    srch = {"nprobe": 8} if itype == "binary_ivf_flat" else {}
    q = x[[0, 17, 999]]
    j, t = both()
    for src, dst in ((j, t), (t, j)):
        a = src.new(itype, **kw)
        a.upsert(ids[:800], x[:800])
        if kw:
            a.train()
        a.delete(ids[:5])
        a.apply_log_id = 42
        path = str(tmp_path / f"{src.name}_{itype}")
        a.save(path)
        npz = np.load(f"{path}/{itype}.npz")
        assert npz["vectors"].dtype == np.uint8
        assert npz["vectors"].shape == (795, NBYTES)
        b = dst.new(itype, **kw)
        b.load(path)
        assert b.get_count() == 795 and b.apply_log_id == 42
        assert_same_hamming(a.search(q, 6, **srch), b.search(q, 6, **srch))


def test_index_from_reference_binary_arrays(corpus):
    """The mapping form: packed rows (and centroids with their assignment)
    give the same answers as the JAX index they came from."""
    ids, x = corpus
    jidx = Side("dingo_tpu").binary_ivf()
    jidx.upsert(ids, x)
    jidx.train()
    live = np.flatnonzero(jidx.store.ids_by_slot >= 0)
    arrays = {"ids": jidx.store.ids_by_slot[live],
              "vectors": np.packbits(np.asarray(jidx.store.vecs)[live] > 0,
                                     axis=1, bitorder="little"),
              "centroids": np.asarray(jidx.centroids),
              "assign": jidx._assign_h[live]}
    tidx = index_from_reference(arrays, device="cpu")
    assert isinstance(tidx, TpuBinaryIvfFlat)
    assert tidx.dimension == DIM_BITS and tidx.metric is TMetric.HAMMING
    q = x[[3, 4, 1000]]
    assert_same_hamming(jidx.search(q, 8, nprobe=2),
                        tidx.search(q, 8, nprobe=2))
    flat = index_from_reference({"ids": arrays["ids"],
                                 "vectors": arrays["vectors"]}, device="cpu")
    assert isinstance(flat, TpuBinaryFlat)
    assert_exact_hamming(flat.search(q, 8), q, rows_of(ids, x), 8)


# ---------------- a binary region through Storage -------------------------------

class RegionSide:
    """One package's mono-engine Storage over a binary region."""

    MODS = {"regm": "store.region", "monom": "engine.mono_engine",
            "raw": "engine.raw_engine", "st": "engine.storage",
            "vcodec": "index.codec", "base": "index.base",
            "reader": "index.vector_reader", "mgr": "index.manager",
            "sf": "coprocessor.scalar_filter", "rec": "index.recovery"}

    def __init__(self, name, index_type):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))
        b = self.base
        param = b.IndexParameter(
            index_type=b.IndexType(index_type), dimension=DIM_BITS,
            metric=importlib.import_module(f"{name}.ops.distance")
            .Metric.HAMMING, ncentroids=8, default_nprobe=8)
        r = self.regm
        self.region = r.Region(r.RegionDefinition(
            region_id=5, start_key=self.vcodec.encode_vector_key(1, 0),
            end_key=self.vcodec.encode_vector_key(1, 1 << 40),
            partition_id=1, region_type=r.RegionType.INDEX,
            index_parameter=param), **self.kw)
        w = self.region.vector_index_wrapper
        w.build_own()
        w.set_own(w.own_index)
        self.raw_engine = self.raw.MemEngine()
        engine = self.monom.MonoStoreEngine(self.raw_engine, **self.kw)
        self.storage = self.st.Storage(engine)

    def search(self, q, k, **kw):
        return self.storage.vector_batch_search(self.region, q, k, **kw)


def _rows_of(reply):
    return [(np.asarray([v.id for v in row], np.int64),
             np.asarray([v.distance for v in row], np.float32))
            for row in reply]


def assert_region_rows(jrows, trows, q, x_of, k=None):
    class R:
        def __init__(self, ids, d):
            self.ids, self.distances = ids, d
    j = [R(*r) for r in _rows_of(jrows)]
    t = [R(*r) for r in _rows_of(trows)]
    assert_same_hamming(j, t)
    if k is not None:
        assert_exact_hamming(t, q, x_of, k)


@pytest.mark.parametrize("index_type", ["binary_flat", "binary_ivf_flat"])
def test_binary_region_through_storage(index_type, corpus):
    """Untrained (the reader's brute force over a temporary binary FLAT),
    trained by the manager's rebuild from the engine's uint8 rows, a
    VECTOR_ID filter, a scalar post-filter, a radius request and the
    degraded region's host path: both packages give the same rows."""
    ids, x = corpus
    sides = [RegionSide(p, index_type) for p in PKGS]
    scal = [{"odd": int(i % 2)} for i in range(len(ids))]
    for s in sides:
        for lo in range(0, len(ids), 1000):
            s.storage.vector_add(s.region, ids[lo:lo + 1000],
                                 x[lo:lo + 1000], scal[lo:lo + 1000])
    q = x[[4, 50, 1234]].copy()
    q[:, 1] ^= 3
    x_of = rows_of(ids, x)
    port = sides[1]
    bf = port.reader.VectorReader._brute_force_search
    calls = []

    def spy(self, *a, **kw):
        calls.append(1)
        return bf(self, *a, **kw)

    port.reader.VectorReader._brute_force_search = spy
    try:
        got = [s.search(q, 7) for s in sides]
    finally:
        port.reader.VectorReader._brute_force_search = bf
    # a binary FLAT serves untrained; an untrained binary IVF brute-forces
    assert len(calls) == (1 if index_type == "binary_ivf_flat" else 0)
    assert_region_rows(*got, q, x_of, 7)
    for s in sides:
        s.mgr.VectorIndexManager(s.raw_engine, None, **s.kw).rebuild(
            s.region)
        assert s.region.vector_index_wrapper.own_index.is_trained()
    idx = port.region.vector_index_wrapper.own_index
    assert idx.get_count() == len(ids)
    assert idx.store.vecs.dtype == torch.int8
    got = [s.search(q, 7) for s in sides]
    assert_region_rows(*got, q, x_of, 7)
    got = [s.search(q, 5, filter_mode=s.reader.VectorFilterMode.VECTOR_ID,
                    vector_ids=[4, 6, 8, 50, 1234, 1500]) for s in sides]
    assert_region_rows(*got, q, x_of)
    assert {v.id for row in got[1] for v in row} <= {4, 6, 8, 50, 1234,
                                                     1500}
    got = [s.search(q, 5, filter_mode=s.reader.VectorFilterMode.SCALAR,
                    scalar_filter=s.sf.ScalarFilter.equals({"odd": 1}))
           for s in sides]
    assert_region_rows(*got, q, x_of)
    assert all(v.id % 2 == 1 for row in got[1] for v in row)
    hd = hamming(q, x)
    radius = float(np.sort(hd[0])[12])
    got = [s.search(q, 64, radius=radius) for s in sides]
    assert_region_rows(*got, q, x_of)
    for qi, row in enumerate(got[1]):
        want = set(ids[hd[qi] <= radius].tolist())
        assert {v.id for v in row} <= want
        assert all(v.distance <= radius for v in row)
    assert {v.id for v in got[1][0]} == set(ids[hd[0] <= radius].tolist())
    # backfilled vectors stay packed bytes
    got = port.storage.vector_batch_query(port.region, [4])
    assert got[0].vector.dtype == np.uint8
    np.testing.assert_array_equal(got[0].vector, x[4])
    # a degraded region serves the exact host path over the engine rows
    for s in sides:
        s.rec.RECOVERY.mark_degraded(s.region.id, "test")
    try:
        got = [s.search(q, 7) for s in sides]
    finally:
        for s in sides:
            s.rec.RECOVERY.clear()
    assert_region_rows(*got, q, x_of, 7)


def test_binary_region_coalesced_replies_equal_direct(corpus):
    """A binary region's uint8 queries through IndexService(node): the
    coalescer stacks them as uint8, the staging ring stages them, and the
    index's _prep_queries rebinding makes the staged claim miss (as in the
    JAX package), so the index pads its own unpacked rows. Replies equal
    a direct Storage search."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.server.services import IndexService
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType
    from dingo_tpu_torch.index import codec as vcodec

    ids, x = corpus
    node = MonoStoreNode(device="cpu")
    region = node.create_region(RegionDefinition(
        region_id=3, start_key=vcodec.encode_vector_key(1, 0),
        end_key=vcodec.encode_vector_key(1, 1 << 40), partition_id=1,
        region_type=RegionType.INDEX,
        index_parameter=TParam(index_type=TType.BINARY_IVF_FLAT,
                               dimension=DIM_BITS, metric=TMetric.HAMMING,
                               ncentroids=8, default_nprobe=8)))
    for lo in range(0, len(ids), 1000):
        node.storage.vector_add(region, ids[lo:lo + 1000], x[lo:lo + 1000])
    node.index_manager.rebuild(region)
    q = x[:16].copy()
    q[:, 0] ^= 1
    direct = [node.storage.vector_batch_search(region, q[i:i + 4], 5,
                                               nprobe=4)
              for i in range(0, 16, 4)]
    saved = FLAGS.get("pipeline_enabled")
    FLAGS.set("pipeline_enabled", True)
    miss = METRICS.counter("pipeline.staged_miss")
    before = miss.get()
    svc = IndexService(node, window_ms=20.0, max_batch=64)
    try:
        futs = [svc.submit(3, q[i:i + 4], 5, nprobe=4)
                for i in range(0, 16, 4)]
        got = [f.result(timeout=30) for f in futs]
    finally:
        svc.close()
        FLAGS.set("pipeline_enabled", saved)
        node.stop()
    for g, want in zip(got, direct):
        assert [[v.id for v in r] for r in g] == \
            [[v.id for v in r] for r in want]
        assert [v.distance for r in g for v in r] == \
            [v.distance for r in want for v in r]
    assert miss.get() > before           # the rebinding misses the claim
