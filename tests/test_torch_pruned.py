"""The pruned scan route: the blocked helpers, the plain versions of B3
(ivf_pruned_topk) and B4 (pruned_fused_topk) against the JAX kernels in
interpret mode, the slot store's blocked mirror, and the pruned IVF_FLAT
and FLAT routes as a whole against the JAX package.

Small shapes: d = 32 with ivf_dim_block = 8 on both packages (4 blocks),
as tests/test_pruned_scan.py does; every flag a test sets is restored.

Tolerances: ids equal modulo exact ties; scores within rtol 1e-5,
atol 1e-4 (f32 partial sums in another order). The plain versions walk
the JAX kernels' own order, so all four stats lanes must be equal."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.common.metrics import METRICS as JMETRICS
from dingo_tpu.index.base import FilterSpec as JFilter
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.flat import TpuFlat as JFlat
from dingo_tpu.index.ivf_flat import TpuIvfFlat as JIvf
from dingo_tpu.ops import blocked as jb
from dingo_tpu.ops.distance import Metric as JMetric
from dingo_tpu.ops.pallas_ivf import ivf_pruned_topk as jax_b3
from dingo_tpu.ops.pallas_topk import pruned_fused_topk as jax_b4
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.common.metrics import METRICS as TMETRICS
from dingo_tpu_torch.index.base import FilterSpec as TFilter
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.carry import index_from_reference
from dingo_tpu_torch.index.flat import TpuFlat, flat_search_plain
from dingo_tpu_torch.index.ivf_flat import ivf_scan_scores
from dingo_tpu_torch.index.slot_store import SlotStore
from dingo_tpu_torch.ops import blocked as tb
from dingo_tpu_torch.ops.kernel_ivf_pruned import ivf_pruned_topk
from dingo_tpu_torch.ops.kernel_topk_pruned import (
    BLOCK,
    pruned_fused_topk,
    pruned_fused_topk_plain,
)
from dingo_tpu_torch.ops.scatter import scatter_bucket_dim_update

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
D, DBLK, K = 32, 8, 10

#: flags both packages share; each test that sets one restores it
SHARED = ("ivf_dim_block", "use_pallas_fused_search", "use_pallas_ivf_search",
          "vector_blocked_layout", "ivf_prune_scan",
          "ivf_prune_inbucket_bound", "ivf_prune_check_interval")


@pytest.fixture
def flags():
    """set(name, value) on both packages; everything restored after."""
    saved = {f: (JFLAGS.get(f), TFLAGS.get(f)) for f in SHARED}

    def set_both(name, value):
        JFLAGS.set(name, value)
        TFLAGS.set(name, value)

    try:
        set_both("ivf_dim_block", DBLK)
        yield set_both
    finally:
        for f, (jv, tv) in saved.items():
            JFLAGS.set(f, jv)
            TFLAGS.set(f, tv)


def _t(a):
    return torch.from_numpy(np.array(a))


def _corpus(seed, n, d=D, ncl=16, nq=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    q = x[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, d), dtype=np.float32)
    return x.astype(np.float32), q.astype(np.float32), rng


def assert_topk_match(jv, ji, tv, ti):
    """Scores equal within tolerance (-inf where -inf); ids equal except
    at positions whose score ties a neighbour's."""
    jv, ji, tv, ti = (np.asarray(a) for a in (jv, ji, tv, ti))
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ti[~fin], -1)
    np.testing.assert_array_equal(ji[~fin], -1)
    for r in range(jv.shape[0]):
        for c in np.flatnonzero(ji[r] != ti[r]):
            near = [tv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < tv.shape[1]]
            assert any(abs(tv[r, c] - v) <= ATOL for v in near), (r, c)


def assert_same_results(jres, tres, atol=1e-3):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-4,
                                   atol=atol)
        for c in np.flatnonzero(a.ids != b.ids):
            near = [b.distances[c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < len(b.ids)]
            assert any(abs(b.distances[c] - v) <= atol for v in near), c


# -- (a) blocked helpers ----------------------------------------------------
@pytest.mark.parametrize("n,d,dblk", [(37, 32, 8), (20, 30, 8), (5, 256, 128)])
def test_blocked_round_trip_is_bit_exact_and_matches_jax(n, d, dblk):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d), dtype=np.float32)
    want = jb.to_blocked(x, dblk)
    got = tb.to_blocked(_t(x), dblk)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    back = tb.from_blocked(got, d)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), jb.from_blocked(want, d))
    assert tb.n_blocks(d, dblk) == jb.n_blocks(d, dblk)
    assert tb.pad_dim(d, dblk) == jb.pad_dim(d, dblk)


@pytest.mark.parametrize("d,dblk", [(32, 8), (30, 8), (768, 128)])
def test_block_norms_match_jax(d, dblk):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((50, d), dtype=np.float32)
    np.testing.assert_allclose(tb.block_sqnorms(_t(x), dblk).numpy(),
                               np.asarray(jb.block_sqnorms(x, dblk)),
                               rtol=1e-6)
    buckets = rng.standard_normal((3, 16, d), dtype=np.float32)
    np.testing.assert_allclose(
        tb.bucket_block_sqnorms(_t(buckets), dblk).numpy(),
        np.asarray(jb.bucket_block_sqnorms(jnp.asarray(buckets), dblk)),
        rtol=1e-6)
    q = rng.standard_normal((6, d), dtype=np.float32)
    got = tb.query_prefix_sqnorms(_t(q), dblk).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jb.query_prefix_sqnorms(jnp.asarray(q), dblk)),
        rtol=1e-6)
    np.testing.assert_allclose(got[:, -1], (q * q).sum(1), rtol=1e-6)


@pytest.mark.parametrize("dim,flag,want", [
    (32, 8, 8), (32, 128, None), (256, 128, 128), (24, 16, None),
    (16, 8, 8), (8, 8, None), (64, 0, None)])
def test_resolve_dim_block_matches_jax(flags, dim, flag, want):
    flags("ivf_dim_block", flag)
    assert tb.resolve_dim_block(dim) == jb.resolve_dim_block(dim) == want


def test_scatter_bucket_dim_update_in_place():
    dst = torch.zeros((4, 3, 8))
    vals = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1
    out = scatter_bucket_dim_update(dst, np.array([1, 3]), np.array([5, 0]),
                                    vals)
    assert out is dst
    np.testing.assert_array_equal(dst[1, :, 5].numpy(), [1, 2, 3])
    np.testing.assert_array_equal(dst[3, :, 0].numpy(), [4, 5, 6])
    assert float(dst.sum()) == 21.0


# -- (b) B3 plain vs JAX ivf_pruned_topk (interpret) ------------------------
@pytest.fixture(scope="module")
def ivf_arrays():
    """Arrays of a real JAX MutableIvfView with per-block norms, and probe
    lists with padded ranks (flags set and restored here, since the view
    is built once for the module)."""
    saved = {f: JFLAGS.get(f) for f in ("ivf_dim_block",
                                        "use_pallas_ivf_search")}
    try:
        JFLAGS.set("ivf_dim_block", DBLK)
        JFLAGS.set("use_pallas_ivf_search", True)
        x, q, rng = _corpus(30, 3000)
        ji = JIvf(31, JParam(index_type=JType.IVF_FLAT, dimension=D,
                             ncentroids=16))
        ji.upsert(np.arange(3000, dtype=np.int64), x)
        ji.train()
        ji.search(q, K, nprobe=4)             # builds view + block norms
        view = ji._view
        assert ji._bucket_bsq is not None
        arrays = {
            "buckets": np.asarray(ji._buckets),
            "bsq": np.asarray(ji._bucket_bsq),
            "sqnorm": np.asarray(ji._bucket_sqnorm),
            "valid": np.asarray(view.bucket_valid),
            "slot": np.asarray(view.bucket_slot),
        }
    finally:
        for f, v in saved.items():
            JFLAGS.set(f, v)
    vp = rng.integers(0, view.nbuckets, (8, 6)).astype(np.int32)
    vp[1, 3:] = -1                           # padded ranks
    vp[4] = -1                               # a query that probes nothing
    arrays["vprobes"] = vp
    arrays["q"] = q
    arrays["qpsq"] = np.asarray(jb.query_prefix_sqnorms(jnp.asarray(q),
                                                        DBLK))
    return arrays


def _b3_both(a, valid, ascending, check_every, inbucket, k=K):
    order = [a["vprobes"], a["q"], a["qpsq"], a["buckets"], a["bsq"],
             a["sqnorm"], valid, a["slot"]]
    jv, ji, js = jax_b3(*[jnp.asarray(x) for x in order], None, None, k=k,
                        dim_block=DBLK, ascending=ascending,
                        check_every=check_every, interpret=True, nq=8,
                        inbucket=inbucket)
    tv, ti, ts = ivf_pruned_topk(*[_t(x) for x in order], k, ascending,
                                 check_every, inbucket)
    return (jv, ji, js), (tv, ti, ts)


CASES = [pytest.param(asc, ib, ce, id=f"{m}-inbucket{int(ib)}-every{ce}")
         for asc, m in ((True, "l2"), (False, "ip"))
         for ib in (True, False) for ce in (1, 2)]


@pytest.mark.parametrize("ascending,inbucket,check_every", CASES)
def test_b3_plain_matches_jax(ivf_arrays, ascending, inbucket, check_every):
    (jv, ji, js), (tv, ti, ts) = _b3_both(ivf_arrays, ivf_arrays["valid"],
                                          ascending, check_every, inbucket)
    assert_topk_match(jv, ji, tv, ti)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[4] == 0).all() and (ti[4] == -1).all()   # probed nothing
    s = ts.numpy().sum(0)
    assert 0 < s[0] < s[1] and s[2] < s[3]               # pruning engaged


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
def test_b3_plain_fewer_valid_rows_than_k(ivf_arrays, ascending):
    valid = np.zeros_like(ivf_arrays["valid"])
    rows = np.argwhere(ivf_arrays["valid"])[:: 97][:6]    # 6 live rows
    valid[rows[:, 0], rows[:, 1]] = True
    vp = np.tile(np.unique(rows[:, 0]).astype(np.int32), (8, 1))
    a = dict(ivf_arrays, vprobes=vp)
    (jv, ji, js), (tv, ti, ts) = _b3_both(a, valid, ascending, 1, True)
    assert_topk_match(jv, ji, tv, ti)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti[:, 6:] == -1).all() and (ti[:, :6] >= 0).all()


# -- (c) B4 plain vs JAX pruned_fused_topk (interpret) ----------------------
@pytest.fixture(scope="module")
def flat_mirror():
    """A JAX TpuFlat's blocked mirror (n = 6000 rows in 8192 slots, a
    deleted run so some slots are invalid)."""
    saved = {f: JFLAGS.get(f) for f in ("ivf_dim_block",
                                        "vector_blocked_layout")}
    try:
        JFLAGS.set("ivf_dim_block", DBLK)
        JFLAGS.set("vector_blocked_layout", True)
        x, q, _ = _corpus(32, 6000)
        jf = JFlat(33, JParam(index_type=JType.FLAT, dimension=D))
        jf.upsert(np.arange(6000, dtype=np.int64), x)
        jf.delete(np.arange(100, 400, dtype=np.int64))
        st = jf.store
        assert st.vecs_blk is not None
        return {"q": q, "x_blk": np.asarray(st.vecs_blk),
                "bsq": np.asarray(st.bsq_blk),
                "xsq": np.asarray(st.sqnorm),
                "valid": np.asarray(st.device_mask())}
    finally:
        for f, v in saved.items():
            JFLAGS.set(f, v)


def _b4_both(m, valid, ascending, check_every, inbucket, k=K):
    block = BLOCK   # the row block the port's CPU arm walks
    jv, ji, js = jax_b4(jnp.asarray(m["q"]), jnp.asarray(m["x_blk"]),
                        jnp.asarray(m["bsq"]), jnp.asarray(m["xsq"]),
                        jnp.asarray(valid), None, None, k=k, block=block,
                        dim_block=DBLK, check_every=check_every,
                        ascending=ascending, interpret=True,
                        inbucket=inbucket)
    tv, ti, ts = pruned_fused_topk(_t(m["q"]), _t(m["x_blk"]), _t(m["bsq"]),
                                   _t(m["xsq"]), _t(valid), k, ascending,
                                   check_every, inbucket)
    return (jv, ji, js), (tv, ti, ts)


@pytest.mark.parametrize("ascending,inbucket,check_every", CASES)
def test_b4_plain_matches_jax(flat_mirror, ascending, inbucket, check_every):
    (jv, ji, js), (tv, ti, ts) = _b4_both(flat_mirror, flat_mirror["valid"],
                                          ascending, check_every, inbucket)
    assert_topk_match(jv, ji, tv, ti)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    s = ts.numpy().sum(0)
    assert s[3] == 8 * 5700 and s[1] == s[3] * (D // DBLK)
    assert 0 < s[0] < s[1] and s[2] < s[3]


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
def test_b4_plain_fewer_valid_rows_than_k(flat_mirror, ascending):
    valid = np.zeros_like(flat_mirror["valid"])
    valid[[3, 2500, 4100, 5999]] = True
    (jv, ji, js), (tv, ti, ts) = _b4_both(flat_mirror, valid, ascending, 1,
                                          True)
    assert_topk_match(jv, ji, tv, ti)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti[:, 4:] == -1).all()
    assert sorted(ti[0, :4].tolist()) == [3, 2500, 4100, 5999]


def test_b4_plain_agrees_with_unblocked_scan():
    """Pruned or not, the exact tier gives the same ids: B4's plain version
    against a plain score matrix over the same rows."""
    x, q, _ = _corpus(34, 4096)
    xt = _t(x)
    blk = tb.to_blocked(xt, DBLK)
    bsq = tb.block_sqnorms(xt, DBLK)
    xsq = (xt * xt).sum(1)
    valid = torch.ones(4096, dtype=torch.bool)
    for ascending in (True, False):
        v, i, _ = pruned_fused_topk_plain(_t(q), blk, bsq, xsq, valid, K,
                                          ascending, 1, True, 1024)
        dots = _t(q) @ xt.T
        s = -((_t(q) ** 2).sum(1)[:, None] - 2 * dots + xsq) \
            if ascending else dots
        want_v, want_i = torch.topk(s, K, dim=1)
        np.testing.assert_allclose(v.numpy(), want_v.numpy(), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())


# -- (e) the slot store's blocked mirror --------------------------------------
def test_slot_store_mirror_follows_puts_deletes_and_growth(flags):
    rng = np.random.default_rng(35)
    st = SlotStore(D, "cpu", capacity=4096, blocked=True)
    assert st.dim_block == DBLK and st.nblk == D // DBLK
    assert st.vecs_blk.shape == (4, 4096, DBLK)
    x = rng.standard_normal((3000, D), dtype=np.float32)
    st.put(np.arange(3000), x)
    st.remove_slots(np.arange(100, 200))
    st.put(np.arange(150, 160), x[:10] * 2)          # reuse + overwrite
    st.put(np.arange(3000, 6000), rng.standard_normal((3000, D),
                                                      dtype=np.float32))
    assert st.capacity == 8192                       # grew past 4096
    np.testing.assert_array_equal(st.vecs_blk.numpy(),
                                  tb.to_blocked(st.vecs, DBLK).numpy())
    np.testing.assert_allclose(st.bsq_blk.numpy(),
                               tb.block_sqnorms(st.vecs, DBLK).numpy(),
                               rtol=1e-6)
    base = 8192 * (D * 4 + 8 + 4 + 1)
    assert st.memory_size() == base + 8192 * (D * 4 + 4 * 4)


def test_slot_store_mirror_follows_the_flag(flags):
    flags("vector_blocked_layout", "auto")
    assert SlotStore(D, "cpu").vecs_blk is None      # auto: off on the CPU
    flags("vector_blocked_layout", True)
    assert SlotStore(D, "cpu").vecs_blk is not None
    assert SlotStore(D, "cpu", blocked=False).vecs_blk is None
    assert SlotStore(12, "cpu").vecs_blk is None     # 12 does not block
    flags("vector_blocked_layout", False)
    assert SlotStore(D, "cpu", blocked=True).vecs_blk is not None


# -- (d) the routes as a whole ----------------------------------------------
def _fraction(metrics, rid):
    return metrics.gauge("ivf.pruned_dim_fraction", region_id=rid).get()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_pruned_route_matches_jax(flags, tmp_path, metric):
    flags("use_pallas_ivf_search", True)
    jm = JMetric(metric)
    n = 2500
    x, q, rng = _corpus(36, n)
    jidx = JIvf(41, JParam(index_type=JType.IVF_FLAT, dimension=D,
                           metric=jm, ncentroids=12))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.train()
    jidx.save(str(tmp_path))
    tidx = index_from_reference(str(tmp_path), device="cpu", index_id=41)
    ivf_scan_scores.calls = 0
    jspec = JFilter(ranges=[(100, 2000)], exclude_ids=np.arange(300, 340))
    tspec = TFilter(ranges=[(100, 2000)], exclude_ids=np.arange(300, 340))
    for js, ts in ((None, None), (jspec, tspec)):
        JMETRICS.gauge("ivf.pruned_dim_fraction", region_id=41).set(0.0)
        TMETRICS.gauge("ivf.pruned_dim_fraction", region_id=41).set(0.0)
        assert_same_results(jidx.search(q, K, js, nprobe=4),
                            tidx.search(q, K, ts, nprobe=4))
        assert 0.0 < _fraction(JMETRICS, 41) < 1.0
        assert 0.0 < _fraction(TMETRICS, 41) < 1.0
    assert tidx._bucket_bsq is not None and ivf_scan_scores.calls == 0
    assert TMETRICS.counter("ivf.pruned_candidates", region_id=41).get() > 0

    # in-place upsert (fresh + overwrite) and delete: the bsq scatter arm
    new = x[:30] + 0.01 * rng.standard_normal((30, D), dtype=np.float32)
    new_ids = np.concatenate([np.arange(n, n + 20), np.arange(500, 510)])
    dels = np.arange(1000, 1040, dtype=np.int64)
    for idx in (jidx, tidx):
        idx.upsert(new_ids.astype(np.int64), new)
        idx.delete(dels)
    assert tidx.full_rebuilds == 1 and not tidx._view_dirty
    qq = np.concatenate([q, new[:4]])
    tres = tidx.search(qq, K, nprobe=4)
    assert_same_results(jidx.search(qq, K, nprobe=4), tres)
    assert not any(np.isin(r.ids, dels).any() for r in tres)

    # pruned ids equal the unpruned (B2) route's in the port itself
    flags("ivf_prune_scan", False)
    tidx.compact()
    assert tidx._bucket_bsq is None
    assert [r.ids.tolist() for r in tidx.search(qq, K, nprobe=4)] == \
        [r.ids.tolist() for r in tres]


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_pruned_route_matches_jax(flags, tmp_path, metric):
    flags("use_pallas_fused_search", True)
    flags("vector_blocked_layout", True)
    jm = JMetric(metric)
    n = 5000
    x, q, rng = _corpus(37, n)
    jidx = JFlat(42, JParam(index_type=JType.FLAT, dimension=D, metric=jm))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.save(str(tmp_path))
    tidx = index_from_reference(str(tmp_path), device="cpu", index_id=42)
    assert tidx.store.vecs_blk is not None            # rebuilt from flag
    flat_search_plain.calls = 0
    jspec = JFilter(include_ids=np.arange(0, n, 3))
    tspec = TFilter(include_ids=np.arange(0, n, 3))
    for js, ts in ((None, None), (jspec, tspec)):
        JMETRICS.gauge("ivf.pruned_dim_fraction", region_id=42).set(0.0)
        TMETRICS.gauge("ivf.pruned_dim_fraction", region_id=42).set(0.0)
        assert_same_results(jidx.search(q, K, js), tidx.search(q, K, ts))
        assert 0.0 < _fraction(JMETRICS, 42) < 1.0
        assert 0.0 < _fraction(TMETRICS, 42) < 1.0
    assert flat_search_plain.calls == 0

    new = rng.standard_normal((25, D), dtype=np.float32)
    for idx in (jidx, tidx):
        idx.upsert(np.arange(n, n + 25, dtype=np.int64), new)
        idx.delete(np.arange(0, 50, dtype=np.int64))
    qq = np.concatenate([q, new[:3]])
    tres = tidx.search(qq, K)
    assert_same_results(jidx.search(qq, K), tres)
    if metric == "l2":
        assert [r.ids[0] for r in tres[-3:]] == [n, n + 1, n + 2]

    # the snapshot says which layout served; pruned == unpruned ids
    tidx.save(str(tmp_path / "port"))
    meta = json.load(open(tmp_path / "port" / "meta.json"))
    assert meta["blocked_layout"] is True and meta["dim_block"] == DBLK
    flags("ivf_prune_scan", False)
    assert [r.ids.tolist() for r in tidx.search(qq, K)] == \
        [r.ids.tolist() for r in tres]


def test_flat_snapshot_meta_without_mirror(flags, tmp_path):
    flags("vector_blocked_layout", False)
    idx = TpuFlat(5, TParam(index_type=TType.FLAT, dimension=D),
                  device="cpu")
    idx.upsert(np.arange(10), np.ones((10, D), np.float32))
    idx.save(str(tmp_path))
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["blocked_layout"] is False and meta["dim_block"] == 0


@pytest.mark.parametrize("precision", ["bf16", "sq8"])
def test_pruned_flat_other_tiers_keep_mirror(flags, precision):
    """bf16 and sq8 FLAT stores keep the blocked mirror in their own dtype
    (bf16 rows, uint8 codes) and search through B4's arm of that tier, as
    the JAX index does with its pruned kernel."""
    flags("vector_blocked_layout", True)
    flags("ivf_prune_scan", True)
    flags("use_pallas_fused_search", True)
    x, q, _ = _corpus(40, 2500)
    jf = JFlat(41, JParam(index_type=JType.FLAT, dimension=D,
                          precision=precision))
    tf = TpuFlat(41, TParam(index_type=TType.FLAT, dimension=D,
                            precision=precision), device="cpu")
    for idx in (jf, tf):
        idx.upsert(np.arange(2500, dtype=np.int64), x)
    want = {"bf16": torch.bfloat16, "sq8": torch.uint8}[precision]
    assert tf.store.vecs.dtype == tf.store.vecs_blk.dtype == want
    assert tf.store.vecs_blk.shape == (D // DBLK, tf.store.capacity, DBLK)
    assert_same_results(jf.search(q, K), tf.search(q, K))


def test_metrics_series_keys_match_jax():
    from dingo_tpu.common.metrics import _series_key as jkey
    from dingo_tpu_torch.common.metrics import MetricsRegistry, _series_key

    for args in (("a.b", None, None), ("a.b", 7, None),
                 ("a.b", 7, {"z": 1, "p": "x"}), ("a", 0, {"k": "v"})):
        assert _series_key(*args) == jkey(*args)
    reg = MetricsRegistry()
    reg.counter("ivf.pruned_candidates", region_id=3).add(5)
    reg.counter("ivf.pruned_candidates", region_id=3).add(2)
    reg.gauge("ivf.pruned_dim_fraction", region_id=3).set(0.25)
    assert reg.dump() == {"ivf.pruned_candidates{region=3}": 7,
                          "ivf.pruned_dim_fraction{region=3}": 0.25}


def test_pruned_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; a tensor on
    any other device goes to the kernel or raises."""
    meta = torch.zeros((4, 8, 8), device="meta")
    with pytest.raises(ValueError):
        pruned_fused_topk(torch.zeros((2, 32)), meta, torch.zeros((4, 8)),
                          torch.zeros(8), torch.ones(8, dtype=torch.bool), 2)
    with pytest.raises(ValueError):
        ivf_pruned_topk(torch.zeros((2, 3), dtype=torch.int32),
                        torch.zeros((2, 32)), torch.zeros((2, 4)),
                        torch.zeros((5, 8, 32), device="meta"),
                        torch.zeros((5, 4, 8)), torch.zeros((5, 8)),
                        torch.ones((5, 8), dtype=torch.bool),
                        torch.zeros((5, 8), dtype=torch.int32), 2)
