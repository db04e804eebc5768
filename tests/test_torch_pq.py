"""Port parity for the IVF_PQ slice: dingo_tpu_torch against dingo_tpu.

Inputs are made with numpy from a seed and go through both packages. The
JAX kernel B5 runs in interpret mode, as the JAX package's own tests run
it on the CPU; the port's B5 wrapper takes its plain version because the
tensors lie on the CPU.

Tolerances: the PQ ops (split, tables, ADC sums, reconstruction) within
rtol 1e-5, atol 1e-4 (f32 sums in another order: a gather + sum here, a
one-hot matmul there); B5 and index distances within rtol 1e-4, atol 1e-3
(ADC and L2 distances reach ~100 here); ids equal modulo exact-score ties.
Codes equal, except where a row's two candidate codewords are tied to
within f32 rounding (none occur at these seeds).
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import FilterSpec as JFilter
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.ivf_pq import TpuIvfPq as JPq
from dingo_tpu.index.ivf_pq import _encode_residual as jax_encode_residual
from dingo_tpu.index.ivf_pq import _ivfpq_adc_lut as jax_adc_lut_all
from dingo_tpu.index.wrapper import VectorIndexWrapper as JWrapper
from dingo_tpu.ops import pq as jpq
from dingo_tpu.ops import rerank as jrr
from dingo_tpu.ops.distance import Metric as JMetric
from dingo_tpu.ops.pallas_pq import ivf_pq_adc_topk as jax_adc_topk
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.index import ivf_pq as tivf
from dingo_tpu_torch.index.base import FilterSpec as TFilter
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.carry import index_from_reference
from dingo_tpu_torch.index.factory import new_index
from dingo_tpu_torch.index.flat import flat_search_plain
from dingo_tpu_torch.index.wrapper import VectorIndexWrapper as TWrapper
from dingo_tpu_torch.ops import pq as tpq
from dingo_tpu_torch.ops import rerank as trr
from dingo_tpu_torch.ops.distance import Metric as TMetric
from dingo_tpu_torch.ops.kernel_pq import ivf_pq_adc_topk

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

OPS_RTOL, OPS_ATOL = 1e-5, 1e-4
RTOL, ATOL = 1e-4, 1e-3

METRICS = [("l2", JMetric.L2, TMetric.L2),
           ("ip", JMetric.INNER_PRODUCT, TMetric.INNER_PRODUCT),
           ("cosine", JMetric.COSINE, TMetric.COSINE)]
MIDS = [m[0] for m in METRICS]


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_topk_match(jv, ji, tv, ti, rtol=RTOL, atol=ATOL):
    """Scores equal within tolerance; ids equal except where the score at
    that position is tied (within atol) with a neighbouring position."""
    jv, ji, tv, ti = (np.asarray(a) for a in (jv, ji, tv, ti))
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=rtol, atol=atol)
    for r in range(jv.shape[0]):
        for c in np.flatnonzero(ji[r] != ti[r]):
            near = [tv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < tv.shape[1]]
            assert any(abs(tv[r, c] - v) <= atol for v in near), (r, c)


def assert_same_results(jres, tres):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids)
        assert_topk_match(a.distances[None], a.ids[None], b.distances[None],
                          b.ids[None])


def assert_codes_match(jcodes, tcodes, subs, codebooks):
    """Codes equal except where both codewords are tied to within f32
    rounding for that subvector (subs [m, n, dsub])."""
    jcodes, tcodes = np.asarray(jcodes), np.asarray(tcodes)
    for i, j in zip(*np.nonzero(jcodes != tcodes)):
        s = np.asarray(subs[j, i], np.float64)
        dj = ((s - codebooks[j, jcodes[i, j]]) ** 2).sum()
        dt = ((s - codebooks[j, tcodes[i, j]]) ** 2).sum()
        assert abs(dj - dt) <= 1e-5 * max(1.0, dj), (i, j)


# -- (a) ops/pq -----------------------------------------------------------------
def test_split_lut_scan_reconstruct_match_jax():
    rng = np.random.default_rng(30)
    n, d, m, ksub = 700, 32, 8, 256
    x = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((5, d), dtype=np.float32)
    cb = rng.standard_normal((m, ksub, d // m), dtype=np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    np.testing.assert_array_equal(
        tpq.split_subvectors(_t(x), m).numpy(),
        np.asarray(jpq.split_subvectors(jnp.asarray(x), m)))
    jl = np.asarray(jpq.adc_lut(jnp.asarray(q), jnp.asarray(cb)))
    tl = tpq.adc_lut(_t(q), _t(cb))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=OPS_RTOL, atol=OPS_ATOL)
    js = np.asarray(jpq.adc_scan(jnp.asarray(jl), jnp.asarray(codes),
                                 chunk=256))
    ts = tpq.adc_scan(_t(jl), _t(codes), chunk=256).numpy()
    np.testing.assert_allclose(ts, js, rtol=OPS_RTOL, atol=OPS_ATOL)
    np.testing.assert_array_equal(
        tpq.pq_reconstruct(_t(codes), _t(cb)).numpy(),
        np.asarray(jpq.pq_reconstruct(jnp.asarray(codes), jnp.asarray(cb))))


def test_pq_encode_and_residual_codes_match_jax():
    rng = np.random.default_rng(31)
    n, d, m, nlist = 2000, 32, 8, 6
    x = rng.standard_normal((n, d), dtype=np.float32)
    cb = rng.standard_normal((m, 256, d // m), dtype=np.float32)
    jc = jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb), chunk=512)
    tc = tpq.pq_encode(_t(x), _t(cb), chunk=512)
    assert tc.dtype == torch.uint8 and tc.shape == (n, m)
    assert_codes_match(jc, tc, np.asarray(tpq.split_subvectors(_t(x), m)), cb)

    cent = rng.standard_normal((nlist, d), dtype=np.float32)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    jr = jax_encode_residual(jnp.asarray(x), jnp.asarray(assign),
                             jnp.asarray(cent), jnp.asarray(cb))
    tr = tivf._encode_residual(_t(x), _t(assign), _t(cent), _t(cb))
    resid = x - cent[assign]
    assert_codes_match(jr, tr, np.asarray(
        tpq.split_subvectors(_t(resid), m)), cb)


def test_pq_train_matches_jax_given_seed():
    """Each subspace holds ksub well-separated clusters, so farthest-first
    takes one seed per cluster and no point sits near a tie between two
    centroids: the fits agree to f32 rounding of the cluster means."""
    rng = np.random.default_rng(32)
    n, m, ksub, dsub = 1200, 4, 8, 3
    centers = 10.0 * rng.standard_normal((m, ksub, dsub), dtype=np.float32)
    lab = rng.integers(0, ksub, (n, m))
    x = (centers[np.arange(m)[None, :], lab]
         + 0.05 * rng.standard_normal((n, m, dsub), dtype=np.float32))
    x = x.reshape(n, m * dsub).astype(np.float32)
    jcb = np.asarray(jpq.pq_train(jnp.asarray(x), m=m, ksub=ksub, iters=5,
                                  seed=3))
    tcb = tpq.pq_train(_t(x), m=m, ksub=ksub, iters=5, seed=3).numpy()
    np.testing.assert_allclose(tcb, jcb, atol=1e-4)


def test_adc_tables_match_jax():
    """The residual tables B5 reads (expanded form q_sq - 2 dots + cb_sq)
    over a coarse probe ranking."""
    rng = np.random.default_rng(33)
    b, d, m, nlist, nprobe = 6, 32, 8, 10, 4
    q = rng.standard_normal((b, d), dtype=np.float32)
    cent = rng.standard_normal((nlist, d), dtype=np.float32)
    cb = rng.standard_normal((m, 256, d // m), dtype=np.float32)
    probes = np.stack([rng.choice(nlist, nprobe, replace=False)
                       for _ in range(b)]).astype(np.int32)
    jl = np.asarray(jax_adc_lut_all(jnp.asarray(q), jnp.asarray(cent),
                                    jnp.asarray(probes), jnp.asarray(cb)))
    tl = tivf._ivfpq_adc_lut(_t(q), _t(cent), _t(probes), _t(cb))
    assert tl.is_contiguous() and tl.shape == (b, nprobe, m, 256)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=OPS_RTOL, atol=OPS_ATOL)


# -- (b) B5 plain version against the JAX kernel in interpret mode --------------
@pytest.mark.parametrize("k", [5, 40])
@pytest.mark.parametrize("m", [4, 8, 12])
def test_adc_topk_plain_matches_jax(m, k):
    """Spill buckets share their rank's table through coarse_pos; padded
    ranks, invalid rows, and a query that sees fewer valid rows than k."""
    rng = np.random.default_rng(40 + m + k)
    b, nprobe, cap, nb, ksub = 8, 3, 16, 12, 256
    lut = (5.0 * rng.random((b, nprobe, m, ksub))).astype(np.float32)
    codes = rng.integers(0, ksub, (nb, cap, m)).astype(np.uint8)
    valid = rng.random((nb, cap)) < 0.8
    slot = rng.permutation(nb * cap).reshape(nb, cap).astype(np.int32)
    vprobes = np.stack([rng.choice(nb, 5, replace=False)
                        for _ in range(b)]).astype(np.int32)
    coarse_pos = np.tile(np.array([0, 0, 1, 2, 2], np.int32), (b, 1))
    vprobes[1, 3:] = -1                     # padded ranks are skipped
    vprobes[4, :] = -1                      # a query that probes nothing
    vprobes[6, 1:] = -1                     # one bucket: few valid rows
    valid[vprobes[6, 0]] = False
    valid[vprobes[6, 0], :3] = True
    jv, ji = jax_adc_topk(jnp.asarray(vprobes), jnp.asarray(coarse_pos),
                          jnp.asarray(lut), jnp.asarray(codes),
                          jnp.asarray(valid), jnp.asarray(slot), k=k,
                          interpret=True)
    tv, ti = ivf_pq_adc_topk(_t(vprobes), _t(coarse_pos), _t(lut),
                             _t(codes), _t(valid), _t(slot), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert (ti[4] == -1).all() and np.isneginf(tv[4]).all()
    assert (ti[6, 3:] == -1).all() and np.isfinite(tv[6, :3]).all()
    assert_topk_match(jv, ji, tv, ti)


# -- (c) exact device rerank ----------------------------------------------------
@pytest.mark.parametrize("k", [4, 9])
@pytest.mark.parametrize("name,jm,tm", METRICS, ids=MIDS)
def test_exact_rerank_device_matches_jax(name, jm, tm, k):
    """Candidates with -1 pads; k = 9 exceeds the shortlist (k' = 7)."""
    rng = np.random.default_rng(50 + k)
    vecs = rng.standard_normal((300, 16), dtype=np.float32)
    if tm is TMetric.COSINE:
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    sq = (vecs * vecs).sum(1)
    q = rng.standard_normal((5, 16), dtype=np.float32)
    cand = rng.integers(0, 300, (5, 7)).astype(np.int32)
    cand[0, 4:] = -1
    cand[3, :] = -1
    jd, js = jrr.exact_rerank_device(jnp.asarray(vecs), jnp.asarray(sq),
                                     jnp.asarray(q), jnp.asarray(cand), k=k,
                                     metric=jm)
    td, ts = trr.exact_rerank_device(_t(vecs), _t(sq), _t(q), _t(cand), k,
                                     tm)
    assert td.shape == (5, k) and (ts.numpy()[3] == -1).all()
    jd, td = np.asarray(jd), td.numpy()
    sign = 1.0 if tm is TMetric.L2 else -1.0     # scores, larger is better
    assert_topk_match(-sign * jd, js, -sign * td, ts.numpy())


# -- (d) TpuIvfPq against the JAX index -----------------------------------------
D, NLIST, M = 32, 16, 8


def _data(seed, n=2500, d=D, ncl=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    q = x[rng.choice(n, 8, replace=False)] + 0.05 * rng.standard_normal(
        (8, d), dtype=np.float32)
    return x.astype(np.float32), q.astype(np.float32), rng


def _jparam(jm, host_vectors=False):
    return JParam(index_type=JType.IVF_PQ, dimension=D, metric=jm,
                  ncentroids=NLIST, nsubvector=M, default_nprobe=8,
                  host_vectors=host_vectors)


def _tparam(tm, host_vectors=False):
    return TParam(index_type=TType.IVF_PQ, dimension=D, metric=tm,
                  ncentroids=NLIST, nsubvector=M, default_nprobe=8,
                  host_vectors=host_vectors)


@pytest.fixture
def flags():
    """Set flags on both packages for one test; restored after."""
    names = ("ivfpq_rerank_factor", "use_pallas_ivf_search")
    saved = {f: (JFLAGS.get(f), TFLAGS.get(f)) for f in names}

    def set_both(**kw):
        for f, v in kw.items():
            JFLAGS.set(f, v)
            TFLAGS.set(f, v)

    try:
        yield set_both
    finally:
        for f, (jv, tv) in saved.items():
            JFLAGS.set(f, jv)
            TFLAGS.set(f, tv)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """One trained JAX snapshot per metric (shared: tests load fresh
    indexes from it, in both packages)."""
    x, q, _ = _data(60)
    out = {}
    for name, jm, _tm in METRICS:
        j = JPq(11, _jparam(jm))
        j.upsert(np.arange(len(x), dtype=np.int64), x)
        j.train()
        path = tmp_path_factory.mktemp(f"pq_{name}")
        j.save(str(path))
        out[name] = str(path)
    return x, q, out


def _load_pair(path, jm, tm, host_vectors):
    j = JPq(11, _jparam(jm, host_vectors))
    j.load(path)
    t = index_from_reference(path, device="cpu", index_id=11,
                             parameter=_tparam(tm, host_vectors))
    return j, t


@pytest.mark.parametrize("host_vectors", [False, True], ids=["dev", "host"])
@pytest.mark.parametrize("name,jm,tm", METRICS, ids=MIDS)
def test_ivfpq_untrained_exact_matches_jax(name, jm, tm, host_vectors):
    """The hybrid contract: before training both serve an exact scan."""
    x, q, _ = _data(61, n=1500)
    j = JPq(12, _jparam(jm, host_vectors))
    t = new_index(12, _tparam(tm, host_vectors), device="cpu")
    for idx in (j, t):
        idx.upsert(np.arange(len(x), dtype=np.int64), x)
    assert not t.is_trained() and t.need_train()
    calls = flat_search_plain.calls
    assert_same_results(j.search(q, 10), t.search(q, 10))
    spec = ([(100, 1200)], np.arange(300, 400))
    assert_same_results(
        j.search(q, 10, JFilter(ranges=spec[0], exclude_ids=spec[1])),
        t.search(q, 10, TFilter(ranges=spec[0], exclude_ids=spec[1])))
    assert flat_search_plain.calls == calls + (0 if host_vectors else 2)


@pytest.mark.parametrize("host_vectors", [False, True], ids=["dev", "host"])
@pytest.mark.parametrize("name,jm,tm", METRICS, ids=MIDS)
def test_ivfpq_trained_matches_jax(snapshots, flags, name, jm, tm,
                                   host_vectors):
    """Carried across through the snapshot: the same codes, then the XLA
    arm on both sides (factor 8: rerank of 80 candidates), ADC distances
    (factor 1), a filter, and in-place upserts and deletes."""
    x, q, paths = snapshots
    j, t = _load_pair(paths[name], jm, tm, host_vectors)
    n = len(x)
    np.testing.assert_array_equal(t._assign_h[:n], j._assign_h[:n])
    np.testing.assert_array_equal(t._codes.numpy()[:n],
                                  np.asarray(j._codes)[:n])
    np.testing.assert_allclose(t.codebooks.numpy(), np.asarray(j.codebooks))

    flags(ivfpq_rerank_factor=8)
    calls = tivf._ivfpq_scan_kernel.calls
    assert_same_results(j.search(q, 10, nprobe=6), t.search(q, 10, nprobe=6))
    assert tivf._ivfpq_scan_kernel.calls == calls + 1
    flags(ivfpq_rerank_factor=1)
    assert_same_results(j.search(q, 10, nprobe=6), t.search(q, 10, nprobe=6))
    flags(ivfpq_rerank_factor=8)
    jspec = JFilter(ranges=[(100, 1900)], exclude_ids=np.arange(200, 260))
    tspec = TFilter(ranges=[(100, 1900)], exclude_ids=np.arange(200, 260))
    tr = t.search(q, 10, tspec, nprobe=6)
    assert_same_results(j.search(q, 10, jspec, nprobe=6), tr)
    assert all(((r.ids >= 100) & (r.ids < 1900)).all()
               and not np.isin(r.ids, np.arange(200, 260)).any() for r in tr)

    # incremental writes on both sides: upsert fresh + overwrite, delete
    new = x[:40] + 0.01 * np.random.default_rng(62).standard_normal(
        (40, D), dtype=np.float32)
    new_ids = np.concatenate([np.arange(n, n + 30), np.arange(500, 510)])
    dels = np.arange(1000, 1050, dtype=np.int64)
    for idx in (j, t):
        idx.upsert(new_ids.astype(np.int64), new)
        idx.delete(dels)
    assert t.full_rebuilds == 1 and not t._view_dirty      # in place
    qq = np.concatenate([q, new[:4]])
    tr = t.search(qq, 10, nprobe=6)
    assert_same_results(j.search(qq, 10, nprobe=6), tr)
    assert not any(np.isin(r.ids, dels).any() for r in tr)
    if tm is not TMetric.INNER_PRODUCT:      # a row is its own nearest
        assert [int(r.ids[0]) for r in tr[8:]] == new_ids[:4].tolist()


@pytest.mark.parametrize("host_vectors", [False, True], ids=["dev", "host"])
def test_ivfpq_fused_route_matches_jax(snapshots, flags, host_vectors):
    """The B5 route forced on both sides at k 5 (kprime 40 <= 64): JAX runs
    its kernel in interpret mode, the port its plain version; then the
    rerank (on the device, or from host rows at resolve)."""
    x, q, paths = snapshots
    j, t = _load_pair(paths["l2"], JMetric.L2, TMetric.L2, host_vectors)
    flags(ivfpq_rerank_factor=8, use_pallas_ivf_search=True)
    calls = tivf._ivfpq_scan_kernel.calls
    spec = (JFilter(ranges=[(0, 1200)]), TFilter(ranges=[(0, 1200)]))
    assert_same_results(j.search(q, 5, nprobe=6), t.search(q, 5, nprobe=6))
    tr = t.search(q, 5, spec[1], nprobe=6)
    assert_same_results(j.search(q, 5, spec[0], nprobe=6), tr)
    assert all((r.ids < 1200).all() for r in tr)
    assert tivf._ivfpq_scan_kernel.calls == calls    # B5 served all
    # k 10 at factor 8 is kprime 80 > 64: the XLA arm, even when forced
    t.search(q, 10, nprobe=6)
    assert tivf._ivfpq_scan_kernel.calls == calls + 1


def test_ivfpq_fused_route_adc_distances_match_jax(snapshots, flags):
    """Factor 1 on the B5 route: ADC distances straight from the kernel
    (JAX interpret) and the plain version (port)."""
    x, q, paths = snapshots
    j, t = _load_pair(paths["ip"], JMetric.INNER_PRODUCT,
                      TMetric.INNER_PRODUCT, False)
    flags(ivfpq_rerank_factor=1, use_pallas_ivf_search=True)
    assert_same_results(j.search(q[:4], 10, nprobe=4),
                        t.search(q[:4], 10, nprobe=4))


def test_ivfpq_from_arrays_with_reference_codes(snapshots):
    """index_from_reference over numpy arrays (codes and assignments
    installed as given) builds the same state as over the snapshot."""
    x, q, paths = snapshots
    a = index_from_reference(paths["l2"], device="cpu", index_id=11)
    assert a.m == M and a.nlist == NLIST
    data = dict(np.load(f"{paths['l2']}/ivf_pq.npz"))
    j = JPq(11, _jparam(JMetric.L2))
    j.load(paths["l2"])
    n = len(x)
    data["codes"] = np.asarray(j._codes)[:n]
    data["assign"] = j._assign_h[:n]
    b = index_from_reference(data, device="cpu", index_id=11)
    np.testing.assert_array_equal(a._codes.numpy(), b._codes.numpy())
    np.testing.assert_array_equal(a._assign_h, b._assign_h)
    assert_same_results(a.search(q, 10, nprobe=4), b.search(q, 10, nprobe=4))


def test_ivfpq_train_in_port_matches_jax_coarse_state():
    """The port's own train(): the same sample, the same coarse centroids
    and assignments, and PQ codebooks fit on the same residuals (their
    k-means may part at near-ties, so the search is held to recall, not
    to equal ids)."""
    x, q, _ = _data(63)
    j = JPq(13, _jparam(JMetric.L2))
    t = new_index(13, _tparam(TMetric.L2), device="cpu")
    for idx in (j, t):
        idx.upsert(np.arange(len(x), dtype=np.int64), x)
        idx.train()
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               atol=1e-4)
    np.testing.assert_array_equal(t._assign_h, j._assign_h)
    assert t.codebooks.shape == (M, 256, D // M)
    want = [r.ids for r in j.search(q, 10, nprobe=16)]
    got = [r.ids for r in t.search(q, 10, nprobe=16)]
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(want, got))
    assert hits >= 0.9 * 10 * len(q)


def test_ivfpq_save_load_roundtrip_in_jax_format(snapshots, tmp_path):
    """The port writes the JAX package's snapshot and the JAX package
    loads it back to the same answers."""
    x, q, paths = snapshots
    t = index_from_reference(paths["cosine"], device="cpu", index_id=11)
    t.save(str(tmp_path))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["m"] == M and meta["nlist"] == NLIST and meta["trained"]
    j = JPq(11, _jparam(JMetric.COSINE))
    j.load(str(tmp_path))
    assert_same_results(j.search(q, 10, nprobe=6), t.search(q, 10, nprobe=6))


def test_ivfpq_wrapper_raft_order_matches_jax():
    """Raft-ordered adds and deletes through VectorIndexWrapper serve an
    IVF_PQ index: exact before train, ADC + rerank after, log-id guard."""
    x, q, _ = _data(64, n=1200)
    jw = JWrapper(21, _jparam(JMetric.L2))
    tw = TWrapper(21, _tparam(TMetric.L2), device="cpu")
    jw.set_own(jw.build_own())
    tw.set_own(tw.build_own())
    ops = [("add", np.arange(0, 600), x[:600], 1),
           ("add", np.arange(600, 1200), x[600:], 2),
           ("add", np.arange(0, 50), x[:50], 2),           # replay: ignored
           ("delete", np.arange(0, 30), None, 3)]
    for op, ids, vecs, log_id in ops:
        for w in (jw, tw):
            if op == "add":
                w.add(ids.astype(np.int64), vecs, log_id)
            else:
                w.delete(ids.astype(np.int64), log_id)
        assert tw.apply_log_id == jw.apply_log_id
        assert tw.get_count() == jw.get_count()
    assert_same_results(jw.search(q, 10), tw.search(q, 10))
    path_j = jw.own_index
    path_j.train()
    snap = {"ids": path_j.store.to_host()["ids"],
            "vectors": np.asarray(path_j.store.to_host()["vectors"]),
            "centroids": np.asarray(path_j.centroids),
            "codebooks": np.asarray(path_j.codebooks)}
    tw.set_own(index_from_reference(snap, device="cpu", index_id=21,
                                    parameter=_tparam(TMetric.L2)))
    tw.apply_log_id = jw.apply_log_id
    for w in (jw, tw):
        w.delete(np.arange(30, 60, dtype=np.int64), 4)
        w.add(np.arange(2000, 2010, dtype=np.int64), x[100:110], 5)
    assert tw.get_count() == jw.get_count() == 1150
    assert_same_results(jw.search(q, 10, nprobe=6),
                        tw.search(q, 10, nprobe=6))
    assert_same_results(jw.search_async(q, 10, nprobe=6)(),
                        tw.search_async(q, 10, nprobe=6)())


def test_ivfpq_invalid_parameters_match_jax():
    from dingo_tpu.index.base import InvalidParameter as JInvalid
    from dingo_tpu_torch.index.base import InvalidParameter as TInvalid
    from dingo_tpu_torch.index.base import NotTrained

    for kw in ({"dimension": 30}, {"nbits_per_idx": 4},
               {"precision": "sq8"}, {"metric": "hamming"}):
        jkw = dict(kw)
        tkw = dict(kw)
        if "metric" in kw:
            jkw["metric"], tkw["metric"] = JMetric.HAMMING, TMetric.HAMMING
        with pytest.raises(JInvalid):
            JPq(1, dataclasses.replace(_jparam(JMetric.L2), **jkw))
        with pytest.raises(TInvalid):
            new_index(1, dataclasses.replace(_tparam(TMetric.L2), **tkw),
                      device="cpu")
    t = new_index(1, _tparam(TMetric.L2), device="cpu")
    t.upsert(np.arange(100), np.ones((100, D), np.float32))
    with pytest.raises(NotTrained):
        t.train()                  # fewer rows than ksub


@pytest.mark.parametrize("host_vectors", [False, True], ids=["dev", "host"])
def test_ivfpq_runs_on_the_card_unless_told(monkeypatch, host_vectors):
    from dingo_tpu_torch.common.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        new_index(1, _tparam(TMetric.L2, host_vectors))
    t = new_index(1, _tparam(TMetric.L2, host_vectors), device="cpu")
    assert t.device.type == "cpu" and t.store.vecs_blk is None
