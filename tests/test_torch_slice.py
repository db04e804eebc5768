"""The slice as a whole: a JAX index is saved, the port loads its snapshot
through index_from_reference(..., device="cpu"), and both answer the same
searches — with and without a filter, before and after an incremental
upsert and delete. The JAX side runs its Pallas kernels in interpret mode
(the crossover flags forced on); the port's kernel wrappers take their
plain versions on CPU tensors.

Tolerance: ids equal modulo exact-score ties; distances within rtol 1e-4,
atol 1e-3 (f32 sums in another order; L2 distances here reach ~100)."""

import numpy as np
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import FilterSpec as JFilter
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.flat import TpuFlat as JFlat
from dingo_tpu.index.ivf_flat import TpuIvfFlat as JIvf
from dingo_tpu.index.wrapper import VectorIndexWrapper as JWrapper
from dingo_tpu.ops.distance import Metric as JMetric
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.index.base import FilterSpec as TFilter
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.carry import index_from_reference
from dingo_tpu_torch.index.flat import flat_search_plain
from dingo_tpu_torch.index.ivf_flat import ivf_scan_scores
from dingo_tpu_torch.index.wrapper import VectorIndexWrapper as TWrapper
from dingo_tpu_torch.ops.distance import Metric as TMetric

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
KERNEL_FLAGS = ("use_pallas_fused_search", "use_pallas_ivf_search")


@pytest.fixture
def kernels_on():
    """Both packages route through their kernel arms; flags restored."""
    saved_j = {f: JFLAGS.get(f) for f in KERNEL_FLAGS}
    saved_t = {f: TFLAGS.get(f) for f in KERNEL_FLAGS}
    try:
        for f in KERNEL_FLAGS:
            JFLAGS.set(f, True)
            TFLAGS.set(f, True)
        yield
    finally:
        for f in KERNEL_FLAGS:
            JFLAGS.set(f, saved_j[f])
            TFLAGS.set(f, saved_t[f])


def _data(seed, n, d, ncl=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncl, d), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    q = x[rng.choice(n, 8, replace=False)] + 0.05 * rng.standard_normal(
        (8, d), dtype=np.float32)
    return x.astype(np.float32), q.astype(np.float32), rng


def assert_same_results(jres, tres):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=RTOL,
                                   atol=ATOL)
        for c in np.flatnonzero(a.ids != b.ids):
            near = [b.distances[c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < len(b.ids)]
            assert any(abs(b.distances[c] - v) <= ATOL for v in near), c


METRICS = [("l2", JMetric.L2, TMetric.L2),
           ("ip", JMetric.INNER_PRODUCT, TMetric.INNER_PRODUCT),
           ("cosine", JMetric.COSINE, TMetric.COSINE)]


@pytest.mark.parametrize("name,jm,tm", METRICS, ids=[m[0] for m in METRICS])
def test_ivf_flat_slice_matches_jax(kernels_on, tmp_path, name, jm, tm):
    n, d, nlist = 2500, 32, 16
    x, q, rng = _data(20, n, d)
    jidx = JIvf(7, JParam(index_type=JType.IVF_FLAT, dimension=d,
                          metric=jm, ncentroids=nlist))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.train()
    jidx.save(str(tmp_path))
    tidx = index_from_reference(str(tmp_path), device="cpu", index_id=7)
    assert tidx.metric is tm and tidx.nlist == nlist
    assert tidx.get_count() == n

    ivf_scan_scores.calls = 0
    jspec = JFilter(ranges=[(100, 1900)], exclude_ids=np.arange(200, 260))
    tspec = TFilter(ranges=[(100, 1900)], exclude_ids=np.arange(200, 260))
    for spec in (None, "filter"):
        js, ts = (None, None) if spec is None else (jspec, tspec)
        assert_same_results(jidx.search(q, 10, js, nprobe=6),
                            tidx.search(q, 10, ts, nprobe=6))
    # the port ran its B2 arm (plain version on the CPU), not the XLA arm
    assert ivf_scan_scores.calls == 0

    # incremental writes on both sides: upsert fresh + overwrite, delete
    new = x[:40] + 0.01 * rng.standard_normal((40, d), dtype=np.float32)
    new_ids = np.concatenate([np.arange(n, n + 30), np.arange(500, 510)])
    dels = np.arange(1000, 1050)
    for idx in (jidx, tidx):
        idx.upsert(new_ids.astype(np.int64), new)
        idx.delete(dels.astype(np.int64))
    assert tidx.full_rebuilds == 1 and not tidx._view_dirty  # in place
    for js, ts in ((None, None), (jspec, tspec)):
        qq = np.concatenate([q, new[:4]])
        jr = jidx.search(qq, 10, js, nprobe=6)
        tr = tidx.search(qq, 10, ts, nprobe=6)
        assert_same_results(jr, tr)
        assert not any(np.isin(r.ids, dels).any() for r in tr)
    # k > 64 takes the XLA-equivalent arm on both sides
    assert_same_results(jidx.search(q[:2], 70, nprobe=6),
                        tidx.search(q[:2], 70, nprobe=6))
    assert ivf_scan_scores.calls == 1


def test_ivf_flat_from_arrays_matches_snapshot(tmp_path):
    """index_from_reference over numpy arrays builds the same state as
    over the snapshot directory."""
    n, d, nlist = 1200, 16, 8
    x, q, _ = _data(21, n, d)
    jidx = JIvf(3, JParam(index_type=JType.IVF_FLAT, dimension=d,
                          ncentroids=nlist))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.train()
    jidx.save(str(tmp_path))
    data = dict(np.load(tmp_path / "ivf_flat.npz"))
    a = index_from_reference(str(tmp_path), device="cpu")
    b = index_from_reference(data, device="cpu")
    np.testing.assert_array_equal(a._assign_h, b._assign_h)
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())
    assert_same_results(a.search(q, 5, nprobe=4), b.search(q, 5, nprobe=4))


@pytest.mark.parametrize("name,jm,tm", METRICS[:2], ids=["l2", "ip"])
def test_flat_slice_matches_jax(kernels_on, tmp_path, name, jm, tm):
    n, d = 3000, 24
    x, q, rng = _data(22, n, d)
    jidx = JFlat(4, JParam(index_type=JType.FLAT, dimension=d, metric=jm))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.save(str(tmp_path))
    tidx = index_from_reference(str(tmp_path), device="cpu")
    assert tidx.index_type is TType.FLAT

    flat_search_plain.calls = 0
    spec_j = JFilter(include_ids=np.arange(0, n, 3))
    spec_t = TFilter(include_ids=np.arange(0, n, 3))
    assert_same_results(jidx.search(q, 10), tidx.search(q, 10))
    assert_same_results(jidx.search(q, 10, spec_j),
                        tidx.search(q, 10, spec_t))
    assert flat_search_plain.calls == 0   # the port's B1 arm served both

    new = rng.standard_normal((25, d), dtype=np.float32)
    for idx in (jidx, tidx):
        idx.upsert(np.arange(n, n + 25, dtype=np.int64), new)
        idx.delete(np.arange(0, 50, dtype=np.int64))
    qq = np.concatenate([q, new[:3]])
    assert_same_results(jidx.search(qq, 10), tidx.search(qq, 10))
    assert_same_results(jidx.search(qq, 10, spec_j),
                        tidx.search(qq, 10, spec_t))


def test_wrapper_log_id_replay_matches_jax():
    """The apply-log guard: a write whose log id does not advance is
    ignored, identically in both packages."""
    d = 16
    x, q, _ = _data(23, 400, d)
    jw = JWrapper(9, JParam(index_type=JType.FLAT, dimension=d))
    tw = TWrapper(9, TParam(index_type=TType.FLAT, dimension=d),
                  device="cpu")
    jw.set_own(jw.build_own())
    tw.set_own(tw.build_own())
    ops = [("add", np.arange(0, 200), x[:200], 1),
           ("add", np.arange(200, 300), x[200:300], 2),
           ("add", np.arange(300, 400), x[300:400], 2),     # replay: ignored
           ("delete", np.arange(0, 20), None, 1),            # stale: ignored
           ("delete", np.arange(0, 20), None, 3),
           ("add", np.arange(300, 350), x[300:350], 0)]      # log id 0 applies
    for op, ids, vecs, log_id in ops:
        for w in (jw, tw):
            if op == "add":
                w.add(ids.astype(np.int64), vecs, log_id)
            else:
                w.delete(ids.astype(np.int64), log_id)
        assert tw.apply_log_id == jw.apply_log_id
        assert tw.get_count() == jw.get_count()
        assert tw.write_count == jw.write_count
    assert tw.get_count() == 330 and tw.apply_log_id == 3
    assert_same_results(jw.search(q, 5), tw.search(q, 5))
    assert_same_results(jw.search_async(q, 5)(), tw.search_async(q, 5)())


def test_unported_features_raise_not_supported():
    from dingo_tpu_torch.index.base import InvalidParameter, NotPorted
    from dingo_tpu_torch.index.factory import new_index

    # DISKANN is a gRPC proxy (its core is ported: dingo_tpu_torch.diskann);
    # the binary family is ported and builds
    with pytest.raises(NotPorted, match="gRPC"):
        new_index(1, TParam(index_type=TType.DISKANN, dimension=8),
                  device="cpu")
    for t in (TType.BINARY_FLAT, TType.BINARY_IVF_FLAT):
        idx = new_index(1, TParam(index_type=t, dimension=8,
                                  metric=TMetric.HAMMING, ncentroids=2),
                        device="cpu")
        assert idx.index_type is t and idx.store.dtype == torch.int8
    # sq8 is invalid for IVF_PQ, as in the JAX package (its codes are
    # already quantized)
    with pytest.raises(InvalidParameter):
        new_index(1, TParam(index_type=TType.IVF_PQ, dimension=8,
                            nsubvector=4, precision="sq8"), device="cpu")
    with pytest.raises(InvalidParameter):
        new_index(1, TParam(index_type=TType.FLAT, dimension=8,
                            precision="fp8"), device="cpu")


TIER_CASES = [
    (TType.IVF_FLAT, 8, {"precision": "bf16"}, "bf16"),
    (TType.IVF_FLAT, 8, {"precision": "sq8"}, "sq8"),
    (TType.IVF_FLAT, 8, {"dtype": "bfloat16"}, "bf16"),
    (TType.IVF_PQ, 8, {"precision": "bf16"}, "bf16"),
    (TType.IVF_PQ, 8, {"dtype": "bfloat16"}, "bf16"),
    (TType.FLAT, 256, {"precision": "bf16"}, "bf16"),
    (TType.FLAT, 256, {"precision": "sq8"}, "sq8"),
]


@pytest.mark.parametrize("t,dim,kw,tier", TIER_CASES,
                         ids=[f"{c[0].value}-{c[3]}-{sorted(c[2])[0]}"
                              for c in TIER_CASES])
def test_precision_tiers_construct_write_and_search(t, dim, kw, tier):
    """The bf16 and sq8 tiers build on FLAT, IVF_FLAT (and bf16 on
    IVF_PQ), hold their rows in the tier's dtype, and answer a search
    (the FLAT cases with the blocked mirror forced on, the pruned route)."""
    import torch
    from dingo_tpu_torch.index.factory import new_index

    saved = {f: TFLAGS.get(f)
             for f in ("vector_blocked_layout", "ivf_prune_scan")}
    try:
        TFLAGS.set("vector_blocked_layout", "true")
        TFLAGS.set("ivf_prune_scan", "true")
        idx = new_index(1, TParam(index_type=t, dimension=dim, ncentroids=4,
                                  nsubvector=4, **kw), device="cpu")
    finally:
        for f, v in saved.items():
            TFLAGS.set(f, v)
    assert idx._precision == tier
    x, q, _ = _data(50, 300, dim)
    idx.upsert(np.arange(300), x)
    want = {"bf16": torch.bfloat16, "sq8": torch.uint8}[tier]
    assert idx.store.vecs.dtype == want
    if t is TType.FLAT:
        assert idx.store.vecs_blk.dtype == want
    if idx.need_train():
        idx.train()
    res = idx.search(q, 5)
    assert all(len(r.ids) == 5 for r in res)
    # queries are stored rows plus small noise: their own row ranks first
    assert sum(int(r.ids[0] in range(300)) for r in res) == len(res)


def test_jax_sq8_snapshot_loads_into_the_port(tmp_path):
    """A JAX sq8 FLAT snapshot (codes + codec, no rows) carries its tier
    and its codes across: the port index holds the same codes and answers
    as the JAX index does."""
    n, d = 400, 16
    x, q, _ = _data(51, n, d)
    jidx = JFlat(3, JParam(index_type=JType.FLAT, dimension=d,
                           precision="sq8"))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.save(str(tmp_path))
    tidx = index_from_reference(str(tmp_path), device="cpu")
    assert tidx._precision == "sq8"
    np.testing.assert_array_equal(tidx.store.codes_to_host()["codes"],
                                  jidx.store.codes_to_host()["codes"])
    assert_same_results(jidx.search(q, 5), tidx.search(q, 5))


def test_ivf_compaction_keeps_results(kernels_on):
    """Enough tombstones trip need_compact(); compact() rebuilds the dense
    view and searches answer as before, and as the JAX index does."""
    n, d, nlist = 1500, 16, 8
    x, q, _ = _data(24, n, d)
    jidx = JIvf(5, JParam(index_type=JType.IVF_FLAT, dimension=d,
                          ncentroids=nlist))
    jidx.upsert(np.arange(n, dtype=np.int64), x)
    jidx.train()
    tidx = index_from_reference(
        {"ids": np.arange(n), "vectors": x,
         "centroids": np.asarray(jidx.centroids),
         "assign": jidx._assign_h[:n]}, device="cpu")
    tidx.search(q, 5, nprobe=4)                 # builds the view
    dels = np.arange(0, n, 2, dtype=np.int64)
    for idx in (jidx, tidx):
        idx.delete(dels)
    assert tidx.need_compact()
    before = tidx.search(q, 5, nprobe=4)
    tidx.compact()
    assert not tidx.need_compact()
    assert tidx.view_stats()["tombstones"] == 0
    after = tidx.search(q, 5, nprobe=4)
    assert_same_results(before, after)
    assert_same_results(jidx.search(q, 5, nprobe=4), after)
