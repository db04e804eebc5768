"""The bf16 and sq8 tiers of TpuFlat and TpuIvfFlat as a whole, against
the JAX package: each tier x metric x route (pruned: B4/B3; unpruned:
B1/B2, or the plain arm for sq8, which has no unpruned kernel arm; plain:
the crossover off), before and after an incremental upsert and delete; the
sq8 pruned route against its plain arm; the rerank stage; the device bytes
the tiers save. The JAX side runs its Pallas kernels in interpret mode.

Small shapes: d = 32 with ivf_dim_block = 8 (d = 64 for the byte ratios,
as tests/test_precision.py). sq8 indexes that meet the JAX package take a
dyadic codec (see tests/test_torch_precision.py: XLA's CPU backend fuses
the jitted decode's multiply and add). Tolerance: ids equal modulo exact
ties, distances within rtol 1e-4, atol 1e-3."""

import numpy as np
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.flat import TpuFlat as JFlat
from dingo_tpu.index.ivf_flat import TpuIvfFlat as JIvf
from dingo_tpu.ops import sq as jsq
from dingo_tpu.ops.distance import Metric as JMetric
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.flat import (
    TpuFlat,
    flat_search_plain,
    sq_flat_search_plain,
)
from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat, ivf_scan_scores
from dingo_tpu_torch.ops import (
    kernel_ivf,
    kernel_ivf_pruned,
    kernel_topk,
    kernel_topk_pruned,
)
from dingo_tpu_torch.ops.distance import Metric as TMetric

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

D, DBLK, K, NLIST = 32, 8, 10, 8
SHARED = ("ivf_dim_block", "use_pallas_fused_search", "use_pallas_ivf_search",
          "vector_blocked_layout", "ivf_prune_scan", "rerank_cache_rows",
          "rerank_cache_dtype", "quantized_rerank_factor")
DYADIC = jsq.SqParams(np.full(D, -4.0, np.float32),
                      np.full(D, 2.0 ** -5, np.float32))

#: route -> flags of the FLAT and the IVF_FLAT index
ROUTES = {
    "pruned": {"vector_blocked_layout": True, "use_pallas_fused_search": True,
               "use_pallas_ivf_search": True, "ivf_prune_scan": True},
    "unpruned": {"vector_blocked_layout": False,
                 "use_pallas_fused_search": True,
                 "use_pallas_ivf_search": True, "ivf_prune_scan": False},
    "plain": {"vector_blocked_layout": False,
              "use_pallas_fused_search": False,
              "use_pallas_ivf_search": False, "ivf_prune_scan": True},
}


@pytest.fixture
def flags():
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


def _corpus(seed, n, d=D, ncl=16, nq=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    q = x[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, d), dtype=np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def assert_same_results(jres, tres, atol=1e-3):
    """Distances equal within tolerance; an id may differ only where its
    distance ties a neighbour's, or at the last position (a tie with the
    (k+1)-th candidate, which the list does not show)."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-4,
                                   atol=atol)
        for c in np.flatnonzero(a.ids != b.ids):
            near = [b.distances[c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < len(b.ids)]
            assert c == len(b.ids) - 1 or any(
                abs(b.distances[c] - v) <= atol for v in near), c


def _pair(kind, tier, metric, dyadic=True, idx_id=1):
    """The same index in both packages (flags already set)."""
    if kind == "flat":
        j = JFlat(idx_id, JParam(index_type=JType.FLAT, dimension=D,
                                 metric=JMetric(metric), precision=tier))
        t = TpuFlat(idx_id, TParam(index_type=TType.FLAT, dimension=D,
                                   metric=TMetric(metric), precision=tier),
                    device="cpu")
    else:
        j = JIvf(idx_id, JParam(index_type=JType.IVF_FLAT, dimension=D,
                                metric=JMetric(metric), ncentroids=NLIST,
                                precision=tier))
        t = TpuIvfFlat(idx_id, TParam(index_type=TType.IVF_FLAT,
                                      dimension=D, metric=TMetric(metric),
                                      ncentroids=NLIST, precision=tier),
                       device="cpu")
    if tier == "sq8" and dyadic:
        j.store.set_params(DYADIC)
        t.store.set_params(DYADIC)
    return j, t


def _search(idx, q, kind):
    return idx.search(q, K) if kind == "flat" else idx.search(q, K, nprobe=4)


def _arm(kind, route, tier, metric):
    """The arm a search of (kind, route, tier, metric) must take: a plain
    arm's call counter, or (module, kernel wrapper, position of the rows
    argument) to spy on: on the CPU a wrapper runs its plain version and
    counts no launch."""
    if kind == "flat":
        if metric == "cosine" or route == "plain" or (
                tier == "sq8" and route == "unpruned"):
            return (sq_flat_search_plain if tier == "sq8"
                    else flat_search_plain)
        if route == "pruned":
            return kernel_topk_pruned, "pruned_fused_topk", 1
        return kernel_topk, "fused_topk", 1
    if route == "plain" or (tier == "sq8" and (route == "unpruned"
                                               or metric == "cosine")):
        return ivf_scan_scores
    if route == "pruned":
        return kernel_ivf_pruned, "ivf_pruned_topk", 3
    return kernel_ivf, "ivf_list_topk", 2


CASES = [pytest.param(kind, tier, metric, route,
                      id=f"{kind}-{tier}-{metric}-{route}")
         for kind in ("flat", "ivf") for tier in ("bf16", "sq8")
         for metric in ("l2", "ip", "cosine")
         for route in ("pruned", "unpruned", "plain")]


@pytest.mark.parametrize("kind,tier,metric,route", CASES)
def test_tier_index_matches_jax(flags, monkeypatch, kind, tier, metric,
                                route):
    for f, v in ROUTES[route].items():
        flags(f, v)
    x, q = _corpus(60, 1500)
    j, t = _pair(kind, tier, metric)
    for idx in (j, t):
        idx.upsert(np.arange(1500, dtype=np.int64), x)
        if kind == "ivf":
            idx.train()
    arm = _arm(kind, route, tier, metric)
    seen = []
    if isinstance(arm, tuple):
        mod, name, pos = arm
        real = getattr(mod, name)

        def spy(*a, **kw):
            seen.append(a[pos].dtype)
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    else:
        before = arm.calls
    assert_same_results(_search(j, q, kind), _search(t, q, kind))
    # the arm this route takes: the tier's kernel arm, or the plain arm
    if isinstance(arm, tuple):
        assert seen == [t.store.vecs.dtype]
    else:
        assert arm.calls == before + 1
    # in place: upserts of new and of moved rows, deletes
    new = x[:60] + 0.02
    for idx in (j, t):
        idx.upsert(np.arange(2000, 2060, dtype=np.int64), new)
        idx.upsert(np.arange(0, 40, dtype=np.int64), x[100:140])
        idx.delete(np.arange(200, 260, dtype=np.int64))
    assert_same_results(_search(j, new[:8], kind), _search(t, new[:8], kind))
    assert_same_results(_search(j, q, kind), _search(t, q, kind))


def _recall(res, gt):
    return float(np.mean([len(set(r.ids) & set(g)) / K
                          for r, g in zip(res, gt)]))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sq8_pruned_recall_matches_plain_arm(flags, metric):
    """test_pruned_scan.py's gate on the port alone, with a codec trained
    on the data: the pruned sq8 route keeps >= 0.995 of the plain arm's
    recall against the exact top-k."""
    x, q = _corpus(61, 3000, nq=16)
    qd = q if metric == "ip" else None
    exact = (q @ x.T) if qd is not None else -(
        (q * q).sum(1)[:, None] - 2 * q @ x.T + (x * x).sum(1)[None, :])
    gt = np.argsort(-exact, axis=1)[:, :K]
    res = {}
    for route in ("plain", "pruned"):
        for f, v in ROUTES[route].items():
            flags(f, v)
        t = TpuIvfFlat(2, TParam(index_type=TType.IVF_FLAT, dimension=D,
                                 metric=TMetric(metric), ncentroids=NLIST,
                                 precision="sq8"), device="cpu")
        t.upsert(np.arange(3000), x)
        t.train()
        res[route] = t.search(q, K, nprobe=4)
        assert (t._bucket_bsq is not None) == (route == "pruned")
    assert _recall(res["pruned"], gt) >= 0.995 * _recall(res["plain"], gt)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("tier", ["bf16", "sq8"])
def test_rerank_cache_restores_exact_ids(flags, kind, tier):
    """A cache that covers every row reranks the over-fetched shortlist
    exactly: the ids of the fp32 tier (modulo ties), and the JAX package's
    answer with the same cache."""
    for f, v in ROUTES["pruned"].items():
        flags(f, v)
    flags("rerank_cache_rows", 4096)
    flags("quantized_rerank_factor", 4)
    x, q = _corpus(62, 1500)
    j, t = _pair(kind, tier, "l2", idx_id=3)
    flags("rerank_cache_rows", 0)
    _, exact = _pair(kind, "fp32", "l2", idx_id=4)
    for idx in (j, t, exact):
        idx.upsert(np.arange(1500, dtype=np.int64), x)
        if kind == "ivf":
            idx.train()
    assert len(t._rerank_cache) == 1500
    assert_same_results(_search(j, q, kind), _search(t, q, kind))
    assert_same_results(_search(exact, q, kind), _search(t, q, kind))
    t.delete(np.arange(0, 1500, 2, dtype=np.int64))   # invalidated rows
    assert len(t._rerank_cache) == 750
    assert all((r.ids % 2 == 1).all() for r in _search(t, q, kind))


def test_tier_device_bytes(flags):
    """tests/test_precision.py's capacity gates: the IVF view + store of
    sq8 >= 3.5x smaller than fp32's, the bf16 FLAT store >= 1.8x (d = 64,
    no blocked mirror, as the JAX package on the CPU)."""
    d = 64
    rng = np.random.default_rng(63)
    x = rng.standard_normal((6000, d)).astype(np.float32)
    sizes = {}
    for tier in ("fp32", "bf16", "sq8"):
        ivf = TpuIvfFlat(5, TParam(index_type=TType.IVF_FLAT, dimension=d,
                                   ncentroids=32, precision=tier),
                         device="cpu")
        flat = TpuFlat(6, TParam(index_type=TType.FLAT, dimension=d,
                                 precision=tier), device="cpu")
        for idx in (ivf, flat):
            idx.upsert(np.arange(6000), x)
        ivf.train()
        ivf.search(x[:4], K, nprobe=4)     # materializes the view
        sizes[tier] = (ivf.get_device_memory_size(),
                       flat.get_device_memory_size())
    assert sizes["fp32"][0] / sizes["sq8"][0] >= 3.5, sizes
    assert sizes["fp32"][1] / sizes["bf16"][1] >= 1.8, sizes
