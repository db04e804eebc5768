"""The bf16 and sq8 precision tiers, piece by piece, against the JAX
package: the SQ8 codec, precision resolution, the tier stores and their
blocked mirrors, the plain version of every bf16/sq8 kernel arm (B1-bf16,
B2-bf16, B3-bf16/sq8, B4-bf16/sq8) against the JAX Pallas kernel in
interpret mode, the rerank cache and cached rerank, and snapshots carried
both ways. tests/test_torch_precision_index.py holds the indexes as a
whole.

Small shapes: d = 32 with ivf_dim_block = 8 (4 blocks); inputs come from
numpy seeds and go to both packages. Tolerances: the codec is bit-equal;
kernel scores within rtol 1e-4, atol 1e-3 (f32 sums in another order:
bf16 x bf16 products are exact in f32, so the arms differ from the JAX
kernels only there); ids equal modulo exact ties; the plain versions walk
the JAX kernels' order, so all four stats lanes are equal.

The sq8 decode is code * scale + vmin, a multiply and an add rounded
apart (numpy, the port, its CUDA kernels). Under jit XLA's CPU backend
contracts it into one fused multiply-add, which rounds a small share of
decoded values to the neighbouring bf16 (about 0.1% on Gaussian rows). The
cases that hold an sq8 arm against a jitted JAX path therefore use a
dyadic codec (DYADIC: a power-of-two scale, vmin a multiple of it), on
which both forms are exact; the codec tests hold trained codecs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.base import resolve_precision as j_resolve
from dingo_tpu.index.flat import TpuFlat as JFlat
from dingo_tpu.index.ivf_flat import TpuIvfFlat as JIvf
from dingo_tpu.index.rerank_cache import DeviceRerankCache as JCache
from dingo_tpu.index.slot_store import SlotStore as JStore
from dingo_tpu.index.slot_store import SqSlotStore as JSqStore
from dingo_tpu.ops import blocked as jb
from dingo_tpu.ops import sq as jsq
from dingo_tpu.ops.distance import Metric as JMetric
from dingo_tpu.ops.pallas_ivf import ivf_list_topk as jax_b2
from dingo_tpu.ops.pallas_ivf import ivf_pruned_topk as jax_b3
from dingo_tpu.ops.pallas_topk import fused_topk as jax_b1
from dingo_tpu.ops.pallas_topk import pruned_fused_topk as jax_b4
from dingo_tpu.ops.rerank import cached_rerank_device as j_cached_rerank
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.base import InvalidParameter, precision_tier
from dingo_tpu_torch.index.carry import index_from_reference
from dingo_tpu_torch.index.flat import TpuFlat
from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat
from dingo_tpu_torch.index.rerank_cache import DeviceRerankCache
from dingo_tpu_torch.index.slot_store import SlotStore, SqSlotStore
from dingo_tpu_torch.ops import blocked as tb
from dingo_tpu_torch.ops import sq as tsq
from dingo_tpu_torch.ops.distance import Metric as TMetric
from dingo_tpu_torch.ops.kernel_ivf import ivf_list_topk
from dingo_tpu_torch.ops.kernel_ivf_pruned import ivf_pruned_topk
from dingo_tpu_torch.ops.kernel_topk import fused_topk
from dingo_tpu_torch.ops.kernel_topk_pruned import BLOCK, pruned_fused_topk
from dingo_tpu_torch.ops.rerank import (
    cached_rerank_device,
    exact_rerank_device,
)

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
D, DBLK, K = 32, 8, 10
SHARED = ("ivf_dim_block", "use_pallas_fused_search", "use_pallas_ivf_search",
          "vector_blocked_layout", "ivf_prune_scan", "vector_precision",
          "rerank_cache_rows", "rerank_cache_dtype",
          "quantized_rerank_factor")


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


#: a codec whose decode is exact in f32 with or without a fused
#: multiply-add: range [-4, 4) in steps of 2^-5
DYADIC = jsq.SqParams(np.full(D, -4.0, np.float32),
                      np.full(D, 2.0 ** -5, np.float32))


def _bf16_np(x):
    """f32 rows rounded to bf16, as the JAX package's ml_dtypes array."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _bf16_t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16)


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


def assert_same_results(jres, tres, atol=ATOL):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=RTOL,
                                   atol=atol)
        for c in np.flatnonzero(a.ids != b.ids):
            near = [b.distances[c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < len(b.ids)]
            assert any(abs(b.distances[c] - v) <= atol for v in near), c


# -- the SQ8 codec ----------------------------------------------------------
@pytest.mark.parametrize("seed,margin", [(0, jsq.TRAIN_MARGIN), (1, 0.0)])
def test_sq_codec_bit_equal_to_jax(seed, margin):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((500, D))).astype(np.float32)
    x[:, 5] = 1.25                                # a constant dimension
    jp, tp = jsq.sq_train(x, margin), tsq.sq_train(x, margin)
    np.testing.assert_array_equal(tp.vmin, jp.vmin)
    np.testing.assert_array_equal(tp.scale, jp.scale)
    # rows past the trained range clip to 0 / 255 instead of wrapping
    y = np.concatenate([x[:100], 50.0 * np.ones((3, D), np.float32),
                        -50.0 * np.ones((3, D), np.float32)])
    codes = tsq.sq_encode(y, tp)
    np.testing.assert_array_equal(codes, jsq.sq_encode(y, jp))
    assert (codes[100:103] == 255).all() and (codes[103:] == 0).all()
    np.testing.assert_array_equal(tsq.sq_decode(codes, tp),
                                  jsq.sq_decode(codes, jp))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = tsq.sq_decode_device(_t(codes), _t(tp.vmin), _t(tp.scale),
                                   dtype).to(torch.float32).numpy()
        want = np.asarray(jsq.sq_decode_device(
            jnp.asarray(codes), jnp.asarray(jp.vmin), jnp.asarray(jp.scale),
            jdt), np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_sq_scores_match_jax(metric):
    x, q, _ = _corpus(2, 300)
    p = jsq.sq_train(x)
    codes = jsq.sq_encode(x, p)
    deq = jsq.sq_decode(codes, p)
    sqn = (deq * deq).sum(1).astype(np.float32)
    want = jsq.sq_score_matrix(jnp.asarray(q), jnp.asarray(codes),
                               jnp.asarray(p.vmin), jnp.asarray(p.scale),
                               JMetric(metric), jnp.asarray(sqn))
    got = tsq.sq_score_matrix(_t(q), _t(codes), _t(p.vmin), _t(p.scale),
                              TMetric(metric), _t(sqn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    data = codes[:64].reshape(8, 8, D)
    want = jsq.sq_bucket_scores(jnp.asarray(q), jnp.asarray(data),
                                jnp.asarray(sqn[:64].reshape(8, 8)),
                                jnp.asarray(p.vmin), jnp.asarray(p.scale),
                                JMetric(metric))
    got = tsq.sq_bucket_scores(_t(q), _t(data), _t(sqn[:64].reshape(8, 8)),
                               _t(p.vmin), _t(p.scale), TMetric(metric))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bf16_scores_blocked_and_exact(metric):
    """bf16 rows at 768 dims (six DOT_BLOCKs), norms ~860 as in the chip
    smoke's recipe: the plain score arm equals the JAX package's within
    the kernel tolerance and lies within ATOL of the f64 score under the
    tier's arithmetic (f32 |q|^2, bf16 query in the dot, bf16 rows); f32
    rows keep one product."""
    from dingo_tpu.ops.distance import score_matrix as j_score
    from dingo_tpu_torch.ops.distance import DOT_BLOCK, _dot, score_matrix

    d = 768
    assert d > DOT_BLOCK
    x, q, _ = _corpus(11, 2048, d=d, ncl=8, nq=8)
    x = x * np.float32(0.35 / 0.3)
    xb = _bf16_np(x)
    xb32 = xb.astype(np.float32)
    xsq = _norms(xb32)
    got = score_matrix(_t(q), _bf16_t(x), TMetric(metric),
                       x_sqnorm=_t(xsq)).numpy()
    want = np.asarray(j_score(jnp.asarray(q), jnp.asarray(xb),
                              JMetric(metric), x_sqnorm=jnp.asarray(xsq)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    qb = _bf16_np(q).astype(np.float64)
    dots = qb @ xb32.astype(np.float64).T
    exact = dots if metric == "ip" else -(
        (q.astype(np.float64) ** 2).sum(1)[:, None] - 2.0 * dots
        + xsq.astype(np.float64)[None, :])
    assert np.abs(got - exact).max() <= ATOL
    x32 = _t(xb32)
    assert torch.equal(_dot(_t(q), x32), _t(q) @ x32.T)


# -- precision resolution ----------------------------------------------------
@pytest.mark.parametrize("kw,flag", [
    ({}, "fp32"), ({}, "sq8"), ({"precision": "bfloat16"}, "fp32"),
    ({"precision": "F32"}, "sq8"), ({"precision": "int8"}, "fp32"),
    ({"precision": "uint8"}, "fp32"), ({"dtype": "bfloat16"}, "fp32"),
    ({"dtype": "bf16", "precision": "sq8"}, "fp32"),
    ({"precision": "fp8"}, "fp32")])
def test_precision_resolution_matches_jax(flags, kw, flag):
    """Aliases, the legacy dtype='bfloat16', the vector_precision flag as
    the default, and an unknown tier raising in both packages."""
    flags("vector_precision", flag)
    try:
        want = j_resolve(JParam(dimension=D, **kw))
    except Exception as e:   # noqa: BLE001 - the JAX package's error
        with pytest.raises(InvalidParameter):
            precision_tier(TParam(dimension=D, **kw))
        assert type(e).__name__ == "InvalidParameter"
        return
    assert precision_tier(TParam(dimension=D, **kw)) == want


# -- the tier stores --------------------------------------------------------
def _store_ops(store, x, rng):
    """The same puts, overwrites and deletes on either package's store."""
    store.put(np.arange(300, dtype=np.int64), x[:300])
    store.put(np.arange(250, 420, dtype=np.int64), x[300:470])   # overwrite
    store.remove_slots(np.arange(10, 60, 3, dtype=np.int64))
    store.put(np.asarray([5000, 5001], np.int64), x[470:472])  # reuse slots


@pytest.mark.parametrize("tier", ["bf16", "sq8"])
def test_tier_store_matches_jax(flags, tier):
    x, _, rng = _corpus(3, 500)
    if tier == "sq8":
        js, ts = JSqStore(D, blocked=True), SqSlotStore(D, "cpu",
                                                        blocked=True)
    else:
        js = JStore(D, jnp.bfloat16, blocked=True)
        ts = SlotStore(D, "cpu", blocked=True, dtype=torch.bfloat16)
    _store_ops(js, x, rng)
    _store_ops(ts, x, rng)
    np.testing.assert_array_equal(ts.ids_by_slot, js.ids_by_slot)
    if tier == "sq8":
        np.testing.assert_array_equal(ts.sq_params.vmin, js.sq_params.vmin)
        np.testing.assert_array_equal(ts.vecs.numpy(), np.asarray(js.vecs))
        np.testing.assert_array_equal(ts.vecs_blk.numpy(),
                                      np.asarray(js.vecs_blk))
        np.testing.assert_array_equal(ts.codes_to_host()["codes"],
                                      js.codes_to_host()["codes"])
    else:
        np.testing.assert_array_equal(
            ts.vecs.view(torch.int16).numpy(),
            np.asarray(js.vecs).view(np.int16))
        np.testing.assert_array_equal(
            ts.vecs_blk.view(torch.int16).numpy(),
            np.asarray(js.vecs_blk).view(np.int16))
    # norms of what the scans accumulate: bf16 rows, or the f32 decode
    np.testing.assert_allclose(ts.sqnorm.numpy(), np.asarray(js.sqnorm),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.bsq_blk.numpy(), np.asarray(js.bsq_blk),
                               rtol=1e-6, atol=1e-6)
    th, jh = ts.to_host(), js.to_host()
    np.testing.assert_array_equal(th["ids"], jh["ids"])
    np.testing.assert_array_equal(th["vectors"],
                                  np.asarray(jh["vectors"], np.float32))
    live = np.flatnonzero(js.ids_by_slot >= 0)[:40]
    np.testing.assert_array_equal(ts.rows_device(live).numpy(),
                                  np.asarray(js.rows_device(live)))
    ratio = SlotStore(D, "cpu", blocked=True).memory_size() \
        / ts.memory_size()
    assert ratio == pytest.approx(
        JStore(D, jnp.float32, blocked=True).memory_size()
        / js.memory_size())


def test_sq_store_trains_once_and_takes_codes():
    x, _, _ = _corpus(4, 200)
    st = SqSlotStore(D, "cpu", blocked=False)
    assert st.vecs_blk is None and st.sq_params is None
    st.maybe_train(x[:50])
    p = st.sq_params
    st.put(np.arange(100), 10.0 * x[:100])        # no retrain on write
    assert st.sq_params is p
    with pytest.raises(RuntimeError):
        st.set_params(tsq.sq_train(x))
    st2 = SqSlotStore(D, "cpu", blocked=False)
    st2.set_params(p)
    st2.put_codes(np.arange(100), st.codes_to_host()["codes"])
    np.testing.assert_array_equal(st2.vecs.numpy(), st.vecs.numpy())
    np.testing.assert_array_equal(st2.sqnorm.numpy(), st.sqnorm.numpy())


# -- the kernel arms: plain versions vs the JAX kernels (interpret) ---------
@pytest.fixture(scope="module")
def arm_data():
    """Rows in every tier's form: bf16 rows with their norms, sq8 codes
    with the codec and the norms of their f32 decode."""
    x, q, rng = _corpus(5, 4096)
    p = DYADIC
    codes = jsq.sq_encode(x, p)
    deq = jsq.sq_decode(codes, p)
    xb = _bf16_np(x)
    xb32 = xb.astype(np.float32)
    valid = rng.random(4096) < 0.9
    return {"q": q, "valid": valid, "rng": rng, "vmin": p.vmin,
            "scale": p.scale,
            "bf16": {"rows": xb, "t": _bf16_t(x), "f32": xb32},
            "sq8": {"rows": codes, "t": _t(codes), "f32": deq}}


def _norms(f32):
    return (f32 * f32).sum(1).astype(np.float32)


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
def test_b1_bf16_plain_matches_jax(arm_data, ascending):
    a = arm_data["bf16"]
    xsq = _norms(a["f32"])
    jv, ji = jax_b1(jnp.asarray(arm_data["q"]), jnp.asarray(a["rows"]),
                    jnp.asarray(xsq), jnp.asarray(arm_data["valid"]), k=K,
                    ascending=ascending, interpret=True)
    tv, ti = fused_topk(_t(arm_data["q"]), a["t"], _t(xsq),
                        _t(arm_data["valid"]), K, ascending)
    assert_topk_match(jv, ji, tv, ti)


def _buckets(arm_data, tier):
    """[24, 64, d] bucket arrays of one tier from the corpus's first
    rows, with invalid rows and probe lists that pad some ranks."""
    a = arm_data[tier]
    nb, cap = 24, 64
    rows = a["rows"][:nb * cap].reshape(nb, cap, D)
    f32 = a["f32"][:nb * cap].reshape(nb, cap, D)
    valid = arm_data["valid"][:nb * cap].reshape(nb, cap)
    rng = np.random.default_rng(6)
    vp = rng.integers(0, nb, (8, 6)).astype(np.int32)
    vp[1, 3:] = -1
    vp[4] = -1
    return {"rows": rows, "t": a["t"][:nb * cap].reshape(nb, cap, D),
            "sqnorm": (f32 * f32).sum(2).astype(np.float32),
            "bsq": np.asarray(jb.bucket_block_sqnorms(jnp.asarray(f32),
                                                      DBLK)),
            "valid": valid, "vprobes": vp,
            "slot": np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)}


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
def test_b2_bf16_plain_matches_jax(arm_data, ascending):
    bk = _buckets(arm_data, "bf16")
    q = arm_data["q"]
    jv, ji = jax_b2(jnp.asarray(bk["vprobes"]), jnp.asarray(q),
                    jnp.asarray(bk["rows"]), jnp.asarray(bk["sqnorm"]),
                    jnp.asarray(bk["valid"]), jnp.asarray(bk["slot"]), k=K,
                    ascending=ascending, interpret=True, nq=8)
    tv, ti = ivf_list_topk(_t(bk["vprobes"]), _t(q), bk["t"],
                           _t(bk["sqnorm"]), _t(bk["valid"]),
                           _t(bk["slot"]), K, ascending)
    assert_topk_match(jv, ji, tv, ti)


ARM_CASES = [pytest.param(tier, asc, ib, id=f"{tier}-{m}-inbucket{int(ib)}")
             for tier in ("bf16", "sq8")
             for asc, m in ((True, "l2"), (False, "ip"))
             for ib in (True, False)]


def _codec(arm_data, tier):
    if tier != "sq8":
        return (None, None), {}
    return ((jnp.asarray(arm_data["vmin"]), jnp.asarray(arm_data["scale"])),
            {"sq_vmin": _t(arm_data["vmin"]),
             "sq_scale": _t(arm_data["scale"])})


@pytest.mark.parametrize("tier,ascending,inbucket", ARM_CASES)
def test_b3_tier_plain_matches_jax(arm_data, tier, ascending, inbucket):
    bk = _buckets(arm_data, tier)
    q = arm_data["q"]
    qpsq = np.asarray(jb.query_prefix_sqnorms(jnp.asarray(q), DBLK))
    jcodec, tcodec = _codec(arm_data, tier)
    order = [bk["vprobes"], q, qpsq, bk["rows"], bk["bsq"], bk["sqnorm"],
             bk["valid"], bk["slot"]]
    jv, ji, js = jax_b3(*[jnp.asarray(x) for x in order], *jcodec, k=K,
                        dim_block=DBLK, ascending=ascending, check_every=1,
                        interpret=True, nq=8, sq=tier == "sq8",
                        inbucket=inbucket)
    targs = [bk["t"] if i == 3 else _t(x) for i, x in enumerate(order)]
    tv, ti, ts = ivf_pruned_topk(*targs, K, ascending, 1, inbucket, **tcodec)
    assert_topk_match(jv, ji, tv, ti)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    s = ts.numpy().sum(0)
    assert 0 < s[0] < s[1] and s[2] < s[3]               # pruning engaged


@pytest.mark.parametrize("tier,ascending,inbucket", ARM_CASES)
def test_b4_tier_plain_matches_jax(arm_data, tier, ascending, inbucket):
    a = arm_data[tier]
    q = arm_data["q"]
    valid = arm_data["valid"]
    x_blk = np.asarray(jb.to_blocked(a["rows"], DBLK))
    bsq = np.asarray(jb.block_sqnorms(a["f32"], DBLK), np.float32)
    xsq = _norms(a["f32"])
    jcodec, tcodec = _codec(arm_data, tier)
    jv, ji, js = jax_b4(jnp.asarray(q), jnp.asarray(x_blk), jnp.asarray(bsq),
                        jnp.asarray(xsq), jnp.asarray(valid), *jcodec, k=K,
                        block=BLOCK, dim_block=DBLK, check_every=1,
                        ascending=ascending, interpret=True,
                        sq=tier == "sq8", inbucket=inbucket)
    tv, ti, ts = pruned_fused_topk(_t(q), tb.to_blocked(a["t"], DBLK),
                                   _t(bsq), _t(xsq), _t(valid), K, ascending,
                                   1, inbucket, **tcodec)
    assert_topk_match(jv, ji, tv, ti)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_sq8_kernel_wrappers_need_the_codec(arm_data):
    bk = _buckets(arm_data, "sq8")
    with pytest.raises(ValueError):
        pruned_fused_topk(_t(arm_data["q"]),
                          tb.to_blocked(arm_data["sq8"]["t"], DBLK),
                          torch.zeros((4, 4096)), torch.zeros(4096),
                          _t(arm_data["valid"]), K)
    with pytest.raises(ValueError):
        ivf_pruned_topk(_t(bk["vprobes"]), _t(arm_data["q"]),
                        torch.zeros((8, 4)), bk["t"], _t(bk["bsq"]),
                        _t(bk["sqnorm"]), _t(bk["valid"]), _t(bk["slot"]), K)


# -- the rerank cache and cached rerank --------------------------------------
def _cache_ops(cache, x):
    out = [cache.offer(np.asarray([3, 9, 3, 40]), x[:4])]   # 3 repeats
    out.append(cache.offer(np.arange(100, 110), x[4:14]))   # fills 6
    out.append(cache.offer(np.asarray([9, 500]), x[14:16]))  # refresh only
    out.append(cache.invalidate(np.asarray([40, 7])))
    out.append(cache.offer(np.asarray([500, 501]), x[16:18]))
    return out


def test_rerank_cache_matches_jax():
    x, _, _ = _corpus(7, 20)
    jc = JCache(D, 10)
    tc = DeviceRerankCache(D, 10, "cpu")
    assert _cache_ops(tc, x) == _cache_ops(jc, x)
    assert len(tc) == len(jc) == 10
    np.testing.assert_array_equal(tc.device_map(1024).numpy(),
                                  np.asarray(jc.device_map(1024)))
    m = tc.device_map(1024)
    assert tc.device_map(1024) is m          # unchanged: no re-upload
    tc.invalidate(np.asarray([100]))
    assert tc.device_map(1024) is not m
    # slot 9 holds its refreshed row
    np.testing.assert_array_equal(tc.vecs[m[9].item()].numpy(), x[14])


def test_cached_rerank_full_cache_is_exact_and_partial_keeps_quantized():
    x, q, rng = _corpus(8, 400)
    vecs, sq = _t(x), _t((x * x).sum(1))
    cand = np.stack([rng.choice(400, 40, replace=False)
                     for _ in range(8)]).astype(np.int32)
    cand[2, 30:] = -1
    quant = rng.random((8, 40)).astype(np.float32) * 50
    cache = DeviceRerankCache(D, 512, "cpu")
    cache.offer(np.arange(400), x)
    for metric in ("l2", "ip"):
        got = cached_rerank_device(cache.vecs, cache.sqnorm,
                                   cache.device_map(400), _t(quant),
                                   _t(cand), _t(q), K, TMetric(metric))
        want = exact_rerank_device(vecs, sq, _t(q), _t(cand), K,
                                   TMetric(metric))
        assert_topk_match(want[0].numpy(), want[1].numpy(),
                          got[0].numpy(), got[1].numpy())
    # half the rows cached: the uncached keep their quantized score
    part = DeviceRerankCache(D, 512, "cpu")
    part.offer(np.arange(0, 400, 2), x[::2])
    jpart = JCache(D, 512)
    jpart.offer(np.arange(0, 400, 2), x[::2])
    for metric in ("l2", "ip"):
        got = cached_rerank_device(part.vecs, part.sqnorm,
                                   part.device_map(400), _t(quant), _t(cand),
                                   _t(q), K, TMetric(metric))
        want = j_cached_rerank(jpart.vecs, jpart.sqnorm,
                               jpart.device_map(400), jnp.asarray(quant),
                               jnp.asarray(cand), jnp.asarray(q), k=K,
                               metric=JMetric(metric))
        assert_topk_match(np.asarray(want[0]), np.asarray(want[1]),
                          got[0].numpy(), got[1].numpy())
        odd = got[1].numpy() % 2 == 1
        qv = {(r, int(s)): quant[r, c] for r in range(8)
              for c, s in enumerate(cand[r])}
        for r, c in zip(*np.nonzero(odd)):
            assert got[0].numpy()[r, c] == qv[(r, int(got[1][r, c]))]


# -- snapshots and arrays carried across ------------------------------------
def _jax_ivf(tier, x, nlist=8):
    idx = JIvf(9, JParam(index_type=JType.IVF_FLAT, dimension=D,
                         ncentroids=nlist, precision=tier))
    if tier == "sq8":
        idx.store.set_params(DYADIC)
    idx.upsert(np.arange(len(x), dtype=np.int64), x)
    idx.train()
    return idx


@pytest.mark.parametrize("tier", ["bf16", "sq8"])
def test_jax_tier_snapshot_loads_into_port(flags, tmp_path, tier):
    x, q, _ = _corpus(9, 800)
    jidx = _jax_ivf(tier, x)
    jidx.save(str(tmp_path))
    tidx = index_from_reference(str(tmp_path), device="cpu")
    assert tidx._precision == tier
    if tier == "sq8":
        np.testing.assert_array_equal(tidx.store.codes_to_host()["codes"],
                                      jidx.store.codes_to_host()["codes"])
    assert_same_results(jidx.search(q, K, nprobe=4),
                        tidx.search(q, K, nprobe=4))
    # and back: the port's snapshot loads into the JAX package
    tidx.save(str(tmp_path / "port"))
    back = JIvf(10, JParam(index_type=JType.IVF_FLAT, dimension=D,
                           ncentroids=8, precision=tier))
    back.load(str(tmp_path / "port"))
    assert_same_results(back.search(q, K, nprobe=4),
                        tidx.search(q, K, nprobe=4))


def test_sq8_arrays_carry_across(flags):
    x, q, _ = _corpus(10, 800)
    jidx = _jax_ivf("sq8", x)
    codes = jidx.store.codes_to_host()
    live = jidx.store.ids_by_slot >= 0
    tidx = index_from_reference({
        "ids": codes["ids"], "codes": codes["codes"],
        "sq_vmin": jidx.store.sq_params.vmin,
        "sq_scale": jidx.store.sq_params.scale,
        "centroids": np.asarray(jidx.centroids),
        "assign": jidx._assign_h[np.flatnonzero(live)]}, device="cpu")
    assert tidx._precision == "sq8"
    assert_same_results(jidx.search(q, K, nprobe=4),
                        tidx.search(q, K, nprobe=4))


@pytest.mark.parametrize("snap,port,ok", [
    ("fp32", "bf16", True), ("bf16", "fp32", True),
    ("fp32", "sq8", False), ("sq8", "fp32", False), ("sq8", "bf16", False)])
def test_tier_flip_rules(tmp_path, snap, port, ok):
    x, q, _ = _corpus(11, 300)
    jidx = JFlat(12, JParam(index_type=JType.FLAT, dimension=D,
                            precision=snap))
    jidx.upsert(np.arange(300, dtype=np.int64), x)
    jidx.save(str(tmp_path))
    tidx = TpuFlat(12, TParam(index_type=TType.FLAT, dimension=D,
                              precision=port), device="cpu")
    if not ok:
        with pytest.raises(InvalidParameter):
            tidx.load(str(tmp_path))
        return
    tidx.load(str(tmp_path))
    assert tidx._precision == port and tidx.get_count() == 300
    want = JFlat(13, JParam(index_type=JType.FLAT, dimension=D,
                            precision=port))
    want.load(str(tmp_path))
    assert_same_results(want.search(q, K), tidx.search(q, K))


def test_ivf_tier_view_keeps_store_dtype(flags):
    """The view holds bf16 rows / codes on every device (the JAX package
    widens its bf16 view on the CPU only because XLA converts slowly
    there), with the norms of what the scan accumulates."""
    x, q, _ = _corpus(12, 600)
    for tier, dt in (("bf16", torch.bfloat16), ("sq8", torch.uint8)):
        idx = TpuIvfFlat(14, TParam(index_type=TType.IVF_FLAT, dimension=D,
                                    ncentroids=8, precision=tier),
                         device="cpu")
        idx.upsert(np.arange(600), x)
        idx.train()
        idx.search(q, K, nprobe=2)
        assert idx._buckets.dtype == dt
        view = idx._view
        live = view.bucket_slot >= 0
        slots = view.bucket_slot[live].long()
        np.testing.assert_array_equal(idx._bucket_sqnorm[live].numpy(),
                                      idx.store.sqnorm[slots].numpy())
