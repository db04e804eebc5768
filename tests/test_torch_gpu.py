"""Kernels B1-B5 against their plain versions on the CUDA device, over
the edge cases the serving shapes do not reach: several query tiles, k up
to K_MAX, ragged row counts, masks, padded ranks, a dimension that is not
a multiple of 4 (the kernels' scalar-load path), dimension blocks that are
not a multiple of the SGEMM depth, both prune bounds and the in-bucket
refresh on and off; for B5, subspace counts that take each code-load width
and spill buckets that share a table. The bf16 and sq8 arms of B1-B4 run
the same kinds of cases, k 1, 10 and 64, both load widths (a dimension or
block that is not a multiple of the 16-byte load, and a row array that is
not 16-byte aligned, take the scalar path), and the index routes of both
tiers on the device. B4's seeded scan runs in every arm on data where its
later blocks prune (the f32 arm's then run pair by pair) and on data where
nothing dies. B3's bucket-major scan runs in every arm on the cases its work
list meets (a bucket probed by every query, shared probes, budget 1,
padded ranks and rows, empty and sparse buckets, k 1 and 64, a block
wider than a warp's 128 columns); its device work list is held against
probe_items_plain; and search_async's dispatch runs, for every index
family, under torch.cuda.set_sync_debug_mode("error"). B5's per-rank CTAs
run on spill buckets, unsorted coarse_pos, ranks no probe reaches and
buckets wider than one selection step, and IVF_PQ's residual-table kernel
against the torch composite at each subspace width it specialises. B1 and
B2 on the tensor cores run both arms at d 960 and d 100 (bf16 rows with a
pitch TMA cannot read), n not a multiple of the tile, every row invalid,
k 1 and 64, padded ranks and a bucket probed by more than 8 queries; B2
at d 6500 and 6501; B2's result for a query is the same bits alone or at
another column of its items; and at d 960 the default route serves FLAT
on B1 and IVF_FLAT on B2.

Marked ``gpu``: on a machine without a CUDA device each test skips (the
decision is made inside the test). Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerance: scores within rtol 1e-4, atol 1e-3 (f32 sums in another order);
slots equal modulo ties at that tolerance. The pruned kernels walk the
candidates in another order than their plain versions, so only stats
lanes 1 and 3 must be equal; lanes 0 and 2 keep 0 <= lane0 <= lane1 and
lane2 <= lane3."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-4, 1e-3
#: B4 against B1 (two kernels, not a kernel and its plain version): B1 sums
#: a row's d products in one FMA chain, B4 in dimension blocks as the TPU
#: kernel does; at |q|^2 ~ 860 (d = 768) the two round up to ~2e-3 apart
CROSS_ATOL = 1e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_parity(kv, ki, pv, pi, atol=ATOL):
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    np.testing.assert_array_equal(np.isneginf(kv), np.isneginf(pv))
    fin = np.isfinite(pv)
    np.testing.assert_allclose(kv[fin], pv[fin], rtol=RTOL, atol=atol)
    np.testing.assert_array_equal(ki[~fin], -1)
    for r in range(kv.shape[0]):
        for c in np.flatnonzero(ki[r] != pi[r]):
            near = [kv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < kv.shape[1]]
            assert any(abs(kv[r, c] - v) <= atol for v in near), (r, c)


@pytest.mark.parametrize("b,n,d,k,ascending,keep", [
    (64, 5000, 768, 10, True, 1.0),
    (64, 9000, 960, 10, True, 1.0),     # GIST's width
    (3, 1000, 33, 64, True, 0.5),       # k = K_MAX, odd d, ragged n
    (130, 4097, 128, 17, False, 0.9),   # three query tiles, IP
    (8, 300, 64, 40, True, 0.05),       # fewer valid rows than k
])
def test_fused_topk_kernel_matches_plain(b, n, d, k, ascending, keep):
    from dingo_tpu_torch.ops import kernel_topk as kt

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(n + b)
    x = torch.randn((n, d), generator=g).to(dev)
    q = torch.randn((b, d), generator=g).to(dev)
    xsq = (x * x).sum(1)
    valid = (torch.rand(n, generator=g) < keep).to(dev)
    before = kt.fused_topk.launches
    kv, ki = kt.fused_topk(q, x, xsq, valid, k, ascending)
    assert kt.fused_topk.launches == before + 1
    pv, pi = kt.fused_topk_plain(q, x, xsq, valid, k, ascending)
    torch.cuda.synchronize()
    _assert_parity(kv, ki, pv, pi)


@pytest.mark.parametrize("d,cap,k,ascending", [
    (768, 1024, 12, True),
    (30, 100, 64, True),     # scalar path, k = K_MAX, cap not a multiple of 4
    (128, 256, 5, False),
])
def test_ivf_list_topk_kernel_matches_plain(d, cap, k, ascending):
    from dingo_tpu_torch.ops import kernel_ivf as ki_mod

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d + cap)
    nb, b, budget = 40, 16, 9
    buckets = torch.randn((nb, cap, d), generator=g).to(dev)
    sq = (buckets * buckets).sum(-1)
    valid = (torch.rand((nb, cap), generator=g) < 0.8).to(dev)
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = torch.randn((b, d), generator=g).to(dev)
    vp = torch.randint(0, nb, (b, budget), generator=g, dtype=torch.int32)
    vp[2, 3:] = -1                         # padded ranks
    vp[5] = -1                             # a query that probes nothing
    vp = vp.to(dev)
    kv, kslots = ki_mod.ivf_list_topk(vp, q, buckets, sq, valid, slot, k,
                                      ascending)
    pv, pslots = ki_mod.ivf_list_topk_plain(vp, q, buckets, sq, valid, slot,
                                            k, ascending)
    torch.cuda.synchronize()
    assert (kslots[5] == -1).all()
    _assert_parity(kv, kslots, pv, pslots)


def _assert_stats(ks, ps):
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ks[:, 1], ps[:, 1])
    np.testing.assert_array_equal(ks[:, 3], ps[:, 3])
    assert (ks[:, 0] >= 0).all() and (ks[:, 0] <= ks[:, 1]).all()
    assert (ks[:, 2] >= 0).all() and (ks[:, 2] <= ks[:, 3]).all()


def _clustered(g, n, d, ncl=32):
    centers = torch.randn((ncl, d), generator=g)
    return centers[torch.randint(0, ncl, (n,), generator=g)] + 0.3 * \
        torch.randn((n, d), generator=g)


@pytest.mark.parametrize("d,dblk,cap,k,ascending,inbucket,every", [
    (768, 128, 1024, 12, True, True, 1),
    (768, 128, 1024, 12, False, True, 1),
    (256, 64, 300, 64, True, False, 2),     # k = K_MAX, cap not a multiple
    (30, 10, 100, 5, False, True, 2),       # scalar path (dblk % 4 != 0)
])
def test_ivf_pruned_topk_kernel_matches_plain(d, dblk, cap, k, ascending,
                                              inbucket, every):
    from dingo_tpu_torch.ops import blocked
    from dingo_tpu_torch.ops import kernel_ivf_pruned as b3

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d + cap + k)
    nb, b, budget = 40, 16, 9
    buckets = _clustered(g, nb * cap, d).reshape(nb, cap, d).to(dev)
    sq = (buckets * buckets).sum(-1)
    bsq = blocked.bucket_block_sqnorms(buckets, dblk)
    valid = (torch.rand((nb, cap), generator=g) < 0.8).to(dev)
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = (buckets.reshape(-1, d)[torch.randint(0, nb * cap, (b,),
                                              generator=g).to(dev)]
         + 0.05 * torch.randn((b, d), generator=g).to(dev))
    qpsq = blocked.query_prefix_sqnorms(q, dblk)
    vp = torch.randint(0, nb, (b, budget), generator=g, dtype=torch.int32)
    vp[2, 3:] = -1                         # padded ranks
    vp[5] = -1                             # a query that probes nothing
    vp = vp.to(dev)
    args = (vp, q, qpsq, buckets, bsq, sq, valid, slot, k, ascending, every,
            inbucket)
    before = b3.ivf_pruned_topk.launches
    kv, kslots, ks = b3.ivf_pruned_topk(*args)
    assert b3.ivf_pruned_topk.launches == before + 1
    pv, pslots, ps = b3.ivf_pruned_topk_plain(*args)
    torch.cuda.synchronize()
    assert (kslots[5] == -1).all() and (ks[5] == 0).all()
    _assert_parity(kv, kslots, pv, pslots)
    _assert_stats(ks, ps)
    # pruned or not, the exact tier gives B2's answer
    from dingo_tpu_torch.ops import kernel_ivf
    v2, s2 = kernel_ivf.ivf_list_topk(vp, q, buckets, sq, valid, slot, k,
                                      ascending)
    _assert_parity(kv, kslots, v2, s2)


@pytest.mark.parametrize("b,n,d,dblk,k,ascending,inbucket,every,keep", [
    (64, 8192, 768, 128, 10, True, True, 1, 1.0),
    (64, 8192, 768, 128, 10, False, True, 1, 1.0),
    (130, 4096, 256, 64, 33, True, False, 2, 0.7),   # three query tiles
    (3, 4096, 40, 8, 64, False, True, 1, 0.9),       # dblk < BK, k = K_MAX
    (8, 4096, 64, 32, 20, True, True, 1, 0.002),     # fewer valid than k
])
def test_pruned_fused_topk_kernel_matches_plain(b, n, d, dblk, k, ascending,
                                                inbucket, every, keep):
    from dingo_tpu_torch.ops import blocked
    from dingo_tpu_torch.ops import kernel_topk
    from dingo_tpu_torch.ops import kernel_topk_pruned as b4

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(n + b + d)
    x = _clustered(g, n, d).to(dev)
    q = x[torch.randint(0, n, (b,), generator=g).to(dev)] + 0.05 * \
        torch.randn((b, d), generator=g).to(dev)
    xsq = (x * x).sum(1)
    x_blk = blocked.to_blocked(x, dblk)
    bsq = blocked.block_sqnorms(x, dblk)
    valid = (torch.rand(n, generator=g) < keep).to(dev)
    args = (q, x_blk, bsq, xsq, valid, k, ascending, every, inbucket)
    before = b4.pruned_fused_topk.launches
    kv, ki, ks = b4.pruned_fused_topk(*args)
    assert b4.pruned_fused_topk.launches == before + 1
    pv, pi, ps = b4.pruned_fused_topk_plain(*args)
    torch.cuda.synchronize()
    _assert_parity(kv, ki, pv, pi)
    _assert_stats(ks, ps)
    v1, i1 = kernel_topk.fused_topk(q, x, xsq, valid, k, ascending)
    _assert_parity(kv, ki, v1, i1, atol=CROSS_ATOL)


def _flags(**kw):
    from dingo_tpu_torch.common.config import FLAGS

    saved = {f: FLAGS.get(f) for f in kw}
    for f, v in kw.items():
        FLAGS.set(f, v)
    return saved


def _restore(saved):
    from dingo_tpu_torch.common.config import FLAGS

    for f, v in saved.items():
        FLAGS.set(f, v)


def test_ivf_index_serves_through_kernel_on_device():
    """An IVF_FLAT index on the device routes its search through B2 when
    pruning is off, through B3 by default, and both answer alike."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import kernel_ivf, kernel_ivf_pruned

    _cuda()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 256), dtype=np.float32)
    param = IndexParameter(index_type=IndexType.IVF_FLAT, dimension=256,
                           ncentroids=16)
    saved = _flags(ivf_prune_scan=False)
    try:
        gpu = new_index(1, param)
        gpu.upsert(np.arange(5000), x)
        gpu.train()
        before = kernel_ivf.ivf_list_topk.launches
        res = gpu.search(x[:8], 10, nprobe=16)
        assert kernel_ivf.ivf_list_topk.launches == before + 1
        assert [int(r.ids[0]) for r in res] == list(range(8))
    finally:
        _restore(saved)
    gpu.compact()                 # the flag flip lands at the next rebuild
    before = kernel_ivf_pruned.ivf_pruned_topk.launches
    pruned = gpu.search(x[:8], 10, nprobe=16)
    assert kernel_ivf_pruned.ivf_pruned_topk.launches == before + 1
    assert [r.ids.tolist() for r in pruned] == [r.ids.tolist() for r in res]


def test_flat_index_serves_through_pruned_kernel_on_device():
    """A FLAT index on the device keeps the blocked mirror by default and
    routes through B4; with the mirror off it routes through B1."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import kernel_topk, kernel_topk_pruned

    _cuda()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6000, 256), dtype=np.float32)
    param = IndexParameter(index_type=IndexType.FLAT, dimension=256)
    pruned_idx = new_index(2, param)
    assert pruned_idx.store.vecs_blk is not None
    saved = _flags(vector_blocked_layout=False)
    try:
        plain_idx = new_index(3, param)
    finally:
        _restore(saved)
    assert plain_idx.store.vecs_blk is None
    for idx in (pruned_idx, plain_idx):
        idx.upsert(np.arange(6000), x)
    b4_before = kernel_topk_pruned.pruned_fused_topk.launches
    b1_before = kernel_topk.fused_topk.launches
    a = pruned_idx.search(x[:8], 10)
    b = plain_idx.search(x[:8], 10)
    assert kernel_topk_pruned.pruned_fused_topk.launches == b4_before + 1
    assert kernel_topk.fused_topk.launches == b1_before + 1
    assert [r.ids.tolist() for r in a] == [r.ids.tolist() for r in b]


@pytest.mark.parametrize("m,ksub,cap,k,spill", [
    (96, 256, 1024, 60, True),     # the serving shape: 16-byte code loads
    (96, 256, 1024, 10, False),
    (8, 256, 64, 10, True),        # 8-byte code loads
    (8, 256, 1024, 60, False),
    (12, 256, 100, 33, True),      # 4-byte loads, cap not a multiple of 256
    (6, 16, 50, 64, True),         # byte loads, small ksub, k = K_MAX
])
def test_ivf_pq_adc_topk_kernel_matches_plain(m, ksub, cap, k, spill):
    """B5 against its plain version: spill buckets that share a rank's
    table through coarse_pos, a filtered validity mask, padded ranks, a
    query that probes nothing and one with fewer valid rows than k."""
    from dingo_tpu_torch.ops import kernel_pq

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(m + cap + k)
    nb, b, nprobe = 40, 16, 4
    lut = 5.0 * torch.rand((b, nprobe, m, ksub), generator=g)
    codes = torch.randint(0, ksub, (nb, cap, m), generator=g,
                          dtype=torch.uint8)
    valid = torch.rand((nb, cap), generator=g) < 0.8       # a filter
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32)
    budget = 7 if spill else nprobe
    vp = torch.randint(0, nb, (b, budget), generator=g, dtype=torch.int32)
    pos = [0, 0, 1, 2, 2, 2, 3] if spill else list(range(nprobe))
    cp = torch.tensor(pos, dtype=torch.int32).repeat(b, 1)
    vp[2, 3:] = -1                         # padded ranks
    vp[5] = -1                             # a query that probes nothing
    vp[7, 1:] = -1                         # one bucket, 3 valid rows
    valid[vp[7, 0]] = False
    valid[vp[7, 0], :3] = True
    args = [t.to(dev) for t in (vp, cp, lut, codes, valid, slot)] + [k]
    before = kernel_pq.ivf_pq_adc_topk.launches
    kv, ks = kernel_pq.ivf_pq_adc_topk(*args)
    assert kernel_pq.ivf_pq_adc_topk.launches == before + 1
    pv, ps = kernel_pq.ivf_pq_adc_topk_plain(*args)
    torch.cuda.synchronize()
    assert (ks[5] == -1).all() and (ks[7, 3:] == -1).all()
    _assert_parity(kv, ks, pv, ps)


def test_ivf_pq_index_serves_through_b5_on_device():
    """An IVF_PQ index on the device routes topk 10 at rerank factor 6
    through B5 (kprime 60 <= 64), and at factor 8 through the XLA arm;
    both rerank exactly, so they agree on ids, as does the host-row store
    carried across with the same codes."""
    from dingo_tpu_torch.index import ivf_pq
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import kernel_pq

    _cuda()
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((32, 256), dtype=np.float32)
    x = (centers[rng.integers(0, 32, 6000)] + 0.3 * rng.standard_normal(
        (6000, 256), dtype=np.float32)).astype(np.float32)
    param = IndexParameter(index_type=IndexType.IVF_PQ, dimension=256,
                           ncentroids=16, nsubvector=32)
    idx = new_index(4, param)
    idx.upsert(np.arange(6000), x)
    idx.train()
    saved = _flags(ivfpq_rerank_factor=6)
    try:
        b5, xla = kernel_pq.ivf_pq_adc_topk.launches, \
            ivf_pq._ivfpq_scan_kernel.calls
        luts = kernel_pq.ivfpq_adc_lut.launches
        fused = idx.search(x[:8], 10, nprobe=8)
        assert kernel_pq.ivf_pq_adc_topk.launches == b5 + 1
        assert kernel_pq.ivfpq_adc_lut.launches == luts + 1
        assert ivf_pq._ivfpq_scan_kernel.calls == xla
        assert [int(r.ids[0]) for r in fused] == list(range(8))
        host = new_index(5, IndexParameter(
            index_type=IndexType.IVF_PQ, dimension=256, ncentroids=16,
            nsubvector=32, host_vectors=True))
        slots = idx.store.slots_of(np.arange(6000))
        host.restore_arrays(np.arange(6000), x, idx.centroids.cpu().numpy(),
                            idx.codebooks.cpu().numpy(),
                            idx._codes[torch.from_numpy(slots).cuda()]
                            .cpu().numpy(), idx._assign_h[slots])
        hres = host.search(x[:8], 10, nprobe=8)
        assert kernel_pq.ivf_pq_adc_topk.launches == b5 + 2
        assert kernel_pq.ivfpq_adc_lut.launches == luts + 2
        assert [r.ids.tolist() for r in hres] == \
            [r.ids.tolist() for r in fused]
    finally:
        _restore(saved)
    saved = _flags(use_pallas_ivf_search=False, ivfpq_rerank_factor=6)
    try:
        plain = idx.search(x[:8], 10, nprobe=8)
        assert ivf_pq._ivfpq_scan_kernel.calls == xla + 1
        assert kernel_pq.ivfpq_adc_lut.launches == luts + 2   # XLA arm
    finally:
        _restore(saved)
    assert [r.ids.tolist() for r in plain] == [r.ids.tolist() for r in fused]
    for a, b in zip(plain, fused):
        np.testing.assert_allclose(a.distances, b.distances, rtol=RTOL,
                                   atol=ATOL)


# -- B5 per (query, coarse rank), and the residual-table kernel ---------------
@pytest.mark.parametrize("spill", [True, False], ids=["spill", "flat"])
@pytest.mark.parametrize("k", [1, 12, 60, 64])
@pytest.mark.parametrize("ksub", [16, 256])
@pytest.mark.parametrize("m", [8, 16, 96, 192])
def test_ivf_pq_adc_topk_rank_cases(m, ksub, k, spill):
    """B5 against its plain version on the cases its per-rank CTAs meet:
    a rank that owns three spill buckets, coarse_pos out of order, a rank
    no probe reaches, a filtered bucket_valid, a query with fewer valid
    rows than k, a query whose probes are all padded, and buckets wider
    than one selection step (cap 600 > SEG)."""
    from dingo_tpu_torch.ops import kernel_pq

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(m * 7 + ksub + k)
    nb, b, nprobe, cap = 30, 6, 5, 600 if m <= 16 else 130
    lut = 5.0 * torch.rand((b, nprobe, m, ksub), generator=g)
    codes = torch.randint(0, ksub, (nb, cap, m), generator=g,
                          dtype=torch.uint8)
    valid = torch.rand((nb, cap), generator=g) < 0.7        # a filter
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32)
    pos = [0, 0, 0, 1, 3, 3] if spill else [0, 1, 2, 3]   # rank 4: none
    budget = len(pos)
    vp = torch.randint(0, nb, (b, budget), generator=g, dtype=torch.int32)
    cp = torch.tensor(pos, dtype=torch.int32).repeat(b, 1)
    perm = torch.randperm(budget, generator=g)
    vp[3], cp[3] = vp[3, perm], cp[3, perm]          # coarse_pos unsorted
    vp[1] = -1                             # every probe padded
    vp[4, 1:] = -1                         # one bucket, 3 valid rows
    valid[vp[4, 0]] = False
    valid[vp[4, 0], :3] = True
    args = [t.to(dev) for t in (vp, cp, lut, codes, valid, slot)] + [k]
    before = kernel_pq.ivf_pq_adc_topk.launches
    kv, ks = kernel_pq.ivf_pq_adc_topk(*args)
    assert kernel_pq.ivf_pq_adc_topk.launches == before + 1
    pv, ps = kernel_pq.ivf_pq_adc_topk_plain(*args)
    torch.cuda.synchronize()
    assert (ks[1] == -1).all() and torch.isneginf(kv[1]).all()
    assert (ks[4, 3:] == -1).all() and torch.isfinite(kv[4, :min(k, 3)]).all()
    _assert_parity(kv, ks, pv, ps)


@pytest.mark.parametrize("cap", [40, 600])
def test_ivf_pq_adc_topk_equals_its_model_with_ties(cap):
    """B5's pick is deterministic (score, then slot): on tables of small
    integers, where many rows tie, its output equals the host model of its
    two passes (rank_lists_plain, merge_lists_plain) bit for bit, slots in
    the same order."""
    from dingo_tpu_torch.ops import kernel_pq

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(cap)
    nb, b, nprobe, m, ksub, k = 12, 3, 3, 16, 16, 60
    lut = torch.randint(0, 4, (b, nprobe, m, ksub), generator=g).float()
    codes = torch.randint(0, ksub, (nb, cap, m), generator=g,
                          dtype=torch.uint8)
    valid = torch.rand((nb, cap), generator=g) < 0.9
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32)
    vp = torch.randint(0, nb, (b, 5), generator=g, dtype=torch.int32)
    cp = torch.tensor([[0, 2, 0, 1, 0]] * b, dtype=torch.int32)
    vp[2, 3:] = -1
    args = [vp, cp, lut, codes, valid, slot]
    rv, ri = kernel_pq.rank_lists_plain(*args, k)
    mv, mi = kernel_pq.merge_lists_plain(rv, ri, k)
    kv, ki = kernel_pq.ivf_pq_adc_topk(*[t.to(dev) for t in args], k)
    torch.cuda.synchronize()
    assert torch.equal(kv.cpu(), mv) and torch.equal(ki.cpu(), mi)


@pytest.mark.parametrize("d,m,ksub,nprobe", [
    (768, 96, 256, 32),     # the serving shape: dsub 8
    (768, 96, 256, 16),
    (64, 16, 16, 7),        # dsub 4, ksub 16: 64 subspaces a CTA
    (64, 32, 256, 5),       # dsub 2
    (256, 16, 256, 9),      # dsub 16
    (96, 4, 256, 3),        # dsub 24: codewords read at each rank
])
def test_ivfpq_adc_lut_kernel_matches_plain(d, m, ksub, nprobe):
    """The residual-table kernel against ivfpq_adc_lut_plain (the torch
    composite). Tolerance rtol 1e-5, atol 1e-4: the f32 sums over dsub run
    in another order (cuBLAS's product and torch's reductions there)."""
    from dingo_tpu_torch.ops import kernel_pq

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d + m + nprobe)
    b, nlist = 11, 40
    q = torch.randn((b, d), generator=g).to(dev)
    cent = torch.randn((nlist, d), generator=g).to(dev)
    cb = torch.randn((m, ksub, d // m), generator=g).to(dev)
    probes = torch.stack([torch.randperm(nlist, generator=g)[:nprobe]
                          for _ in range(b)]).to(torch.int32).to(dev)
    before = kernel_pq.ivfpq_adc_lut.launches
    got = kernel_pq.ivfpq_adc_lut(q, cent, probes, cb)
    assert kernel_pq.ivfpq_adc_lut.launches == before + 1
    want = kernel_pq.ivfpq_adc_lut_plain(q, cent, probes, cb)
    torch.cuda.synchronize()
    assert got.shape == (b, nprobe, m, ksub) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# -- the bf16 and sq8 arms ----------------------------------------------------
def _tier_rows(x, tier, misalign=False):
    """f32 rows [..., d] in a tier's form on their device -> (rows as
    stored, f32 values the arm accumulates, codec kwargs). misalign puts
    the rows one element past a 16-byte boundary (the scalar path)."""
    from dingo_tpu_torch.ops import sq

    if tier == "bf16":
        rows = x.to(torch.bfloat16)
        f32, kw = rows.to(torch.float32), {}
    else:
        flat = x.reshape(-1, x.shape[-1]).cpu().numpy()
        p = sq.sq_train(flat)
        codes = torch.from_numpy(sq.sq_encode(flat, p)).reshape(x.shape)
        rows = codes.to(x.device)
        kw = {"sq_vmin": torch.from_numpy(p.vmin).to(x.device),
              "sq_scale": torch.from_numpy(p.scale).to(x.device)}
        f32 = torch.from_numpy(sq.sq_decode(codes.reshape(flat.shape), p)
                               ).reshape(x.shape).to(x.device)
    return (_misaligned(rows) if misalign else rows), f32, kw


def _misaligned(t):
    """A contiguous copy of t one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("b,n,d,k,ascending,keep,misalign", [
    (64, 5000, 768, 10, True, 1.0, False),
    (3, 1000, 33, 64, True, 0.5, False),     # d % 8 != 0: scalar loads
    (130, 4097, 128, 1, False, 0.9, False),  # three query tiles, k = 1
    (8, 300, 64, 40, True, 0.05, False),     # fewer valid rows than k
    (16, 2048, 256, 10, False, 1.0, True),   # misaligned rows
])
def test_fused_topk_bf16_kernel_matches_plain(b, n, d, k, ascending, keep,
                                              misalign):
    from dingo_tpu_torch.ops import kernel_topk as kt

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(n + b + 1)
    x, f32, _ = _tier_rows(torch.randn((n, d), generator=g).to(dev), "bf16",
                           misalign)
    q = torch.randn((b, d), generator=g).to(dev)
    xsq = (f32 * f32).sum(1)
    valid = (torch.rand(n, generator=g) < keep).to(dev)
    before = kt.fused_topk.launches_bf16
    kv, ki = kt.fused_topk(q, x, xsq, valid, k, ascending)
    assert kt.fused_topk.launches_bf16 == before + 1
    pv, pi = kt.fused_topk_plain(q, x, xsq, valid, k, ascending)
    torch.cuda.synchronize()
    _assert_parity(kv, ki, pv, pi)


@pytest.mark.parametrize("d,cap,k,ascending,misalign", [
    (768, 1024, 10, True, False),
    (30, 100, 64, True, False),      # scalar loads, k = K_MAX
    (128, 256, 1, False, False),
    (256, 128, 10, True, True),      # misaligned buckets
])
def test_ivf_list_topk_bf16_kernel_matches_plain(d, cap, k, ascending,
                                                 misalign):
    from dingo_tpu_torch.ops import kernel_ivf as ki_mod

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d + cap + 2)
    nb, b, budget = 40, 16, 9
    buckets, f32, _ = _tier_rows(
        torch.randn((nb, cap, d), generator=g).to(dev), "bf16", misalign)
    sq = (f32 * f32).sum(-1)
    valid = (torch.rand((nb, cap), generator=g) < 0.8).to(dev)
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = torch.randn((b, d), generator=g).to(dev)
    vp = torch.randint(0, nb, (b, budget), generator=g, dtype=torch.int32)
    vp[2, 3:] = -1
    vp[5] = -1
    vp = vp.to(dev)
    before = ki_mod.ivf_list_topk.launches_bf16
    kv, kslots = ki_mod.ivf_list_topk(vp, q, buckets, sq, valid, slot, k,
                                      ascending)
    assert ki_mod.ivf_list_topk.launches_bf16 == before + 1
    pv, pslots = ki_mod.ivf_list_topk_plain(vp, q, buckets, sq, valid, slot,
                                            k, ascending)
    torch.cuda.synchronize()
    assert (kslots[5] == -1).all()
    _assert_parity(kv, kslots, pv, pslots)


TIER_B3 = [
    (768, 128, 1024, 10, True, True, 1, False),
    (768, 128, 1024, 64, False, True, 1, False),
    (256, 64, 300, 1, True, False, 2, False),
    (30, 10, 100, 5, False, True, 2, False),    # scalar loads (both tiers)
    (48, 16, 64, 12, True, True, 1, True),      # misaligned buckets
]


@pytest.mark.parametrize("tier", ["bf16", "sq8"])
@pytest.mark.parametrize("d,dblk,cap,k,ascending,inbucket,every,misalign",
                         TIER_B3)
def test_ivf_pruned_topk_tier_kernel_matches_plain(tier, d, dblk, cap, k,
                                                   ascending, inbucket,
                                                   every, misalign):
    from dingo_tpu_torch.ops import blocked
    from dingo_tpu_torch.ops import kernel_ivf_pruned as b3

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d + cap + k + 3)
    nb, b, budget = 40, 16, 9
    raw = _clustered(g, nb * cap, d).reshape(nb, cap, d).to(dev)
    buckets, f32, kw = _tier_rows(raw, tier, misalign)
    sq = (f32 * f32).sum(-1)
    bsq = blocked.bucket_block_sqnorms(f32, dblk)
    valid = (torch.rand((nb, cap), generator=g) < 0.8).to(dev)  # a filter
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = (raw.reshape(-1, d)[torch.randint(0, nb * cap, (b,),
                                          generator=g).to(dev)]
         + 0.05 * torch.randn((b, d), generator=g).to(dev))
    qpsq = blocked.query_prefix_sqnorms(q, dblk)
    vp = torch.randint(0, nb, (b, budget), generator=g, dtype=torch.int32)
    vp[2, 3:] = -1
    vp[5] = -1
    vp = vp.to(dev)
    args = (vp, q, qpsq, buckets, bsq, sq, valid, slot, k, ascending, every,
            inbucket)
    counter = f"launches_{tier}"
    before = getattr(b3.ivf_pruned_topk, counter)
    kv, kslots, ks = b3.ivf_pruned_topk(*args, **kw)
    assert getattr(b3.ivf_pruned_topk, counter) == before + 1
    pv, pslots, ps = b3.ivf_pruned_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (kslots[5] == -1).all() and (ks[5] == 0).all()
    _assert_parity(kv, kslots, pv, pslots)
    _assert_stats(ks, ps)


TIER_B4 = [
    (64, 8192, 768, 128, 10, True, True, 1, 1.0, False),
    (64, 8192, 768, 128, 10, False, True, 1, 1.0, False),
    (130, 4096, 256, 64, 33, True, False, 2, 0.7, False),
    (3, 4096, 40, 8, 64, False, True, 1, 0.9, False),   # sq8: scalar loads
    (8, 4096, 64, 32, 1, True, True, 1, 0.002, False),  # fewer valid, k 1
    (5, 4096, 60, 12, 10, True, True, 1, 1.0, False),   # scalar (both)
    (16, 4096, 128, 32, 10, False, True, 1, 0.8, True),  # misaligned
]


@pytest.mark.parametrize("tier", ["bf16", "sq8"])
@pytest.mark.parametrize(
    "b,n,d,dblk,k,ascending,inbucket,every,keep,misalign", TIER_B4)
def test_pruned_fused_topk_tier_kernel_matches_plain(
        tier, b, n, d, dblk, k, ascending, inbucket, every, keep, misalign):
    from dingo_tpu_torch.ops import blocked
    from dingo_tpu_torch.ops import kernel_topk_pruned as b4

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(n + b + d + 4)
    raw = _clustered(g, n, d).to(dev)
    q = raw[torch.randint(0, n, (b,), generator=g).to(dev)] + 0.05 * \
        torch.randn((b, d), generator=g).to(dev)
    rows, f32, kw = _tier_rows(raw, tier)
    x_blk = blocked.to_blocked(rows, dblk)
    if misalign:
        x_blk = _misaligned(x_blk)
    xsq = (f32 * f32).sum(1)
    bsq = blocked.block_sqnorms(f32, dblk)
    valid = (torch.rand(n, generator=g) < keep).to(dev)
    args = (q, x_blk, bsq, xsq, valid, k, ascending, every, inbucket)
    counter = f"launches_{tier}"
    before = getattr(b4.pruned_fused_topk, counter)
    kv, ki, ks = b4.pruned_fused_topk(*args, **kw)
    assert getattr(b4.pruned_fused_topk, counter) == before + 1
    pv, pi, ps = b4.pruned_fused_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_parity(kv, ki, pv, pi)
    _assert_stats(ks, ps)


@pytest.mark.parametrize("tier", ["bf16", "sq8"])
def test_tier_indexes_serve_through_their_arms_on_device(tier):
    """bf16/sq8 FLAT and IVF_FLAT on the device: the default routes take
    B4's and B3's arm of the tier; with pruning off, bf16 takes B1/B2 and
    sq8 its plain arms; the routes agree."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import (
        kernel_ivf,
        kernel_ivf_pruned,
        kernel_topk,
        kernel_topk_pruned,
    )

    _cuda()
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((32, 256), dtype=np.float32)
    x = (centers[rng.integers(0, 32, 6000)] + 0.3 * rng.standard_normal(
        (6000, 256), dtype=np.float32)).astype(np.float32)
    counter = f"launches_{tier}"
    flat = new_index(6, IndexParameter(index_type=IndexType.FLAT,
                                       dimension=256, precision=tier))
    ivf = new_index(7, IndexParameter(index_type=IndexType.IVF_FLAT,
                                      dimension=256, ncentroids=16,
                                      precision=tier))
    for idx in (flat, ivf):
        idx.upsert(np.arange(6000), x)
    ivf.train()
    b4 = getattr(kernel_topk_pruned.pruned_fused_topk, counter)
    b3 = getattr(kernel_ivf_pruned.ivf_pruned_topk, counter)
    f_pruned = flat.search(x[:8], 10)
    i_pruned = ivf.search(x[:8], 10, nprobe=16)
    assert getattr(kernel_topk_pruned.pruned_fused_topk, counter) == b4 + 1
    assert getattr(kernel_ivf_pruned.ivf_pruned_topk, counter) == b3 + 1
    assert [int(r.ids[0]) for r in f_pruned] == list(range(8))
    saved = _flags(ivf_prune_scan=False)
    try:
        ivf.compact()
        before = (getattr(kernel_topk.fused_topk, counter, 0),
                  getattr(kernel_ivf.ivf_list_topk, counter, 0))
        f_un = flat.search(x[:8], 10)
        i_un = ivf.search(x[:8], 10, nprobe=16)
        after = (getattr(kernel_topk.fused_topk, counter, 0),
                 getattr(kernel_ivf.ivf_list_topk, counter, 0))
        assert after == ((before[0] + 1, before[1] + 1) if tier == "bf16"
                         else before)
    finally:
        _restore(saved)
    # B4's bf16 arm pairs a bf16 query (the TPU kernel's bf16 matmul), B1's
    # keeps it f32: they agree on the nearest row, and B4 agrees with the
    # plain arm, which pairs the same way (and clamps L2 at 0, as the JAX
    # package's XLA arm does and its kernels do not: a row's distance to
    # itself comes out slightly negative); B3 and B2 share their arithmetic
    saved = _flags(use_pallas_fused_search=False)
    try:
        f_plain = flat.search(x[:8], 10)
    finally:
        _restore(saved)
    for ra, rb in zip(f_pruned, f_un):
        assert ra.ids[0] == rb.ids[0]
    for a, b in ((f_pruned, f_plain), (i_pruned, i_un)):
        for ra, rb in zip(a, b):
            assert ra.ids[0] == rb.ids[0]
            np.testing.assert_allclose(np.maximum(ra.distances, 0.0),
                                       np.maximum(rb.distances, 0.0),
                                       rtol=RTOL, atol=CROSS_ATOL)


# B4's seeded scan in every arm. "pruning" cases: eight queries over 64
# clusters of clustered rows (the seed's strided sample holds at least k
# rows of each query's cluster), where most pairs die after the first
# block; the kernel must then prune about as much as the plain version
# (scanned fraction within 0.15 of it). The f32 arm's later blocks run on
# the rows still alive for some query, pair by pair; the bf16 and sq8 arms
# keep every row of a tile that has one alive.
# "edge" cases: clustered rows at k 64, a row count that is not a multiple
# of 128 and a sparse valid mask. "dense" cases: IP on uniform rows, where
# rows stay alive for some query and every block stays on the dense path.
B4_ARMS = ["f32", "bf16", "sq8"]
B4_CASES = [
    # b, n, d, dblk, k, ascending, keep, data
    (8, 65536, 256, 32, 10, True, 1.0, "pruning"),
    (8, 65536, 256, 32, 1, True, 1.0, "pruning"),      # k 1
    (8, 65536, 100, 20, 10, True, 1.0, "pruning"),     # scalar loads
    (40, 20000, 256, 32, 64, True, 0.3, "edge"),
    (64, 16384, 256, 32, 10, False, 1.0, "dense"),
    (17, 5000, 100, 20, 10, False, 1.0, "dense"),      # scalar loads
]


def _b4_scanned(stats):
    s = stats.double().sum(0).cpu().numpy()
    return s[0] / s[1]


@pytest.mark.parametrize("arm", B4_ARMS)
@pytest.mark.parametrize("b,n,d,dblk,k,ascending,keep,data", B4_CASES)
def test_pruned_fused_topk_seeded_compacted_scan(arm, b, n, d, dblk, k,
                                                 ascending, keep, data):
    from dingo_tpu_torch.ops import blocked
    from dingo_tpu_torch.ops import kernel_topk_pruned as b4

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(n + b + d + k)
    if data == "dense":
        raw = (torch.rand((n, d), generator=g) - 0.5).to(dev)
        q = (torch.rand((b, d), generator=g) - 0.5).to(dev)
    else:
        raw = _clustered(g, n, d, ncl=64 if data == "pruning" else 16).to(dev)
        q = raw[torch.randint(0, n, (b,), generator=g).to(dev)] + 0.05 * \
            torch.randn((b, d), generator=g).to(dev)
    if arm == "f32":
        rows, f32, kw = raw, raw, {}
    else:
        rows, f32, kw = _tier_rows(raw, arm)
    x_blk = blocked.to_blocked(rows, dblk)
    xsq = (f32 * f32).sum(1)
    bsq = blocked.block_sqnorms(f32, dblk)
    valid = (torch.rand(n, generator=g) < keep).to(dev)
    args = (q, x_blk, bsq, xsq, valid, k, ascending, 1, True)
    counter = "launches" if arm == "f32" else f"launches_{arm}"
    before = getattr(b4.pruned_fused_topk, counter)
    b4.pruned_fused_topk.count_tiles = True
    try:
        kv, ki, ks = b4.pruned_fused_topk(*args, **kw)
    finally:
        b4.pruned_fused_topk.count_tiles = False
    assert getattr(b4.pruned_fused_topk, counter) == before + 1
    steps, sparse, rows_read = b4.pruned_fused_topk.tiles.tolist()
    # the plain version walks row blocks of BLOCK slots where they divide n
    block = b4.BLOCK if n % b4.BLOCK == 0 else n
    pv, pi, ps = b4.pruned_fused_topk_plain(*args, block=block, **kw)
    torch.cuda.synchronize()
    _assert_parity(kv, ki, pv, pi)
    _assert_stats(ks, ps)
    nblk = d // dblk
    assert 0 < steps and rows_read <= int(valid.sum()) * nblk
    if arm != "f32":
        assert sparse == 0       # the tensor-core arms stay dense
    if data == "pruning":
        assert _b4_scanned(ks) <= _b4_scanned(ps) + 0.15
        if arm == "f32":         # blocks ran pair by pair on fewer rows
            assert sparse > 0
            assert rows_read < 0.5 * int(valid.sum()) * nblk
    elif data == "dense":          # (nearly) every block slice is read
        assert rows_read >= 0.9 * int(valid.sum()) * nblk


# -- B3: the bucket-major scan ------------------------------------------------
# Cases the serving shapes do not reach, in every arm: a bucket probed by all
# 64 queries (its items split), every query probing the same buckets, budget
# 1, -1 ranks with padded query rows, an empty and a sparse bucket, k 1 and
# 64, cap not a multiple of the row tile, d 100 with dblk 20 (scalar loads
# in the bf16 and sq8 arms), a block wider than the 128 columns a warp
# holds (dblk 256), L2 and IP each with the in-bucket bound on and off.
B3_CASES = [
    # name, b, budget, d, dblk, cap, k, ascending, inbucket
    ("hot", 64, 9, 256, 64, 300, 10, True, True),
    ("same", 16, 6, 256, 64, 256, 10, False, True),
    ("budget1", 16, 1, 128, 32, 200, 5, True, False),
    ("padded", 16, 9, 256, 64, 128, 64, False, False),
    ("sparse", 16, 6, 128, 32, 96, 1, True, True),
    ("scalar", 16, 6, 100, 20, 150, 10, True, True),
    ("wide", 16, 6, 512, 256, 128, 10, False, True),   # two 128-column passes
]


def _b3_probes(name, g, b, budget, nb):
    vp = torch.stack([torch.randperm(nb, generator=g)[:budget]
                      for _ in range(b)]).to(torch.int32)
    if name == "hot":
        vp[:, 0] = 3
        vp[:, 1:] = torch.where(vp[:, 1:] == 3, (vp[:, 1:] + 1) % nb,
                                vp[:, 1:])
        vp[:, 1:] = torch.where(vp[:, 1:] == 3, vp[:, 1:] + 1, vp[:, 1:])
    elif name == "same":
        vp[:] = vp[0]
    elif name == "padded":
        vp[2, 3:] = -1
        vp[7, 1:] = -1
        vp[-3:] = -1                      # padded query rows
    elif name == "sparse":
        vp[:, 0] = 5                      # the empty bucket first
        vp[:, 1] = 7                      # then the sparse one
        vp[:, 2:] = torch.where(vp[:, 2:] >= 5, vp[:, 2:], vp[:, 2:] + 8)
        vp[:, 2:] = torch.clamp_max(vp[:, 2:], nb - 1)
    return vp


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("name,b,budget,d,dblk,cap,k,ascending,inbucket",
                         B3_CASES)
def test_ivf_pruned_topk_bucket_major_cases(arm, name, b, budget, d, dblk,
                                            cap, k, ascending, inbucket):
    from dingo_tpu_torch.ops import blocked
    from dingo_tpu_torch.ops import kernel_ivf_pruned as b3

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(b + budget + d + cap + k)
    nb = 24
    raw = _clustered(g, nb * cap, d).reshape(nb, cap, d).to(dev)
    if arm == "f32":
        buckets, f32, kw = raw, raw, {}
    else:
        buckets, f32, kw = _tier_rows(raw, arm)
    sq = (f32 * f32).sum(-1)
    bsq = blocked.bucket_block_sqnorms(f32, dblk)
    valid = (torch.rand((nb, cap), generator=g) < 0.8).to(dev)
    valid[5] = False                              # an empty bucket
    valid[7] = False
    valid[7, :2] = True                           # a sparse one
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = (raw.reshape(-1, d)[torch.randint(0, nb * cap, (b,),
                                          generator=g).to(dev)]
         + 0.05 * torch.randn((b, d), generator=g).to(dev))
    qpsq = blocked.query_prefix_sqnorms(q, dblk)
    vp = _b3_probes(name, g, b, budget, nb).to(dev)
    args = (vp, q, qpsq, buckets, bsq, sq, valid, slot, k, ascending, 1,
            inbucket)
    counter = "launches" if arm == "f32" else f"launches_{arm}"
    before = getattr(b3.ivf_pruned_topk, counter)
    b3.ivf_pruned_topk.count_staged = True
    try:
        kv, ki, ks = b3.ivf_pruned_topk(*args, **kw)
    finally:
        b3.ivf_pruned_topk.count_staged = False
    assert getattr(b3.ivf_pruned_topk, counter) == before + 1
    staged = int(b3.ivf_pruned_topk.staged)
    pv, pi, ps = b3.ivf_pruned_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_parity(kv, ki, pv, pi)
    _assert_stats(ks, ps)
    dead = (vp < 0).all(dim=1).cpu()
    assert (ki[dead] == -1).all() and (ks[dead] == 0).all()
    # a row slice leaves HBM once per item: never more than the pairs the
    # scan kept alive, plus the seed's first 2k rows of each rank-0 bucket
    nblk = d // dblk
    lane0 = int(ks[:, 0].sum())
    assert 0 < staged <= lane0 + b * 2 * k * nblk
    if name in ("hot", "same"):       # several queries share each item
        assert staged < lane0


@pytest.mark.parametrize("name,b,budget", [("hot", 64, 9), ("same", 16, 6),
                                           ("padded", 16, 9),
                                           ("budget1", 16, 1),
                                           ("random", 64, 49)])
def test_ivf_pruned_work_list_matches_plain(name, b, budget):
    """The device work list equals probe_items_plain."""
    from dingo_tpu_torch.ops import kernel_ivf_pruned as b3

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(b * budget)
    nb = 1100 if name == "random" else 24
    vp = _b3_probes(name, g, b, budget, nb)
    want = b3.probe_items_plain(vp, nb)
    got = b3.probe_items(vp.to(dev), nb)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


# -- C1: a search's dispatch does not synchronize ------------------------------
SYNC_CASES = ["flat_b4", "flat_b1", "ivf_fp32", "ivf_bf16", "ivf_sq8",
              "pq_trained", "pq_untrained"]


@pytest.mark.parametrize("case", SYNC_CASES)
def test_search_async_dispatch_does_not_sync(case):
    """search_async (the dispatch, not resolve) makes no synchronizing CUDA
    call: under torch.cuda.set_sync_debug_mode("error") such a call
    raises. Each family dispatches right after an upsert (FLAT and the
    untrained IVF_PQ re-upload the validity mask), unfiltered and with two
    filters it has not seen (IVF: a filter-cache miss): FLAT on B4 and on
    B1, IVF_FLAT in every tier on B3, IVF_PQ on the device store trained
    (B5, its residual tables built by their kernel) and untrained (the
    exact whole-store arm). Each dispatch runs again with ``staged=``
    (the serving pipeline's ring, staged on the same thread under the same
    mode), which the family claims without a miss."""
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.common.pipeline import StagingRing
    from dingo_tpu_torch.index.base import FilterSpec, IndexParameter, \
        IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import (
        kernel_ivf_pruned,
        kernel_pq,
        kernel_topk,
        kernel_topk_pruned,
    )

    _cuda()
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((32, 256), dtype=np.float32)
    x = (centers[rng.integers(0, 32, 6000)] + 0.3 * rng.standard_normal(
        (6000, 256), dtype=np.float32)).astype(np.float32)
    kind, arm = case.split("_")
    kw = {} if kind == "flat" else {"nprobe": 8}
    saved = _flags(vector_blocked_layout=arm != "b1",
                   ivfpq_rerank_factor=6)
    try:
        if kind == "flat":
            idx = new_index(20, IndexParameter(index_type=IndexType.FLAT,
                                               dimension=256))
            counter = (kernel_topk_pruned.pruned_fused_topk, "launches") \
                if arm == "b4" else (kernel_topk.fused_topk, "launches")
        elif kind == "ivf":
            idx = new_index(21, IndexParameter(
                index_type=IndexType.IVF_FLAT, dimension=256, ncentroids=16,
                precision=arm))
            counter = (kernel_ivf_pruned.ivf_pruned_topk,
                       "launches" if arm == "fp32" else f"launches_{arm}")
        else:
            idx = new_index(22, IndexParameter(
                index_type=IndexType.IVF_PQ, dimension=256, ncentroids=16,
                nsubvector=32))
            counter = (kernel_pq.ivf_pq_adc_topk, "launches") \
                if arm == "trained" else None
        idx.upsert(np.arange(6000), x)
        if kind == "ivf" or arm == "trained":
            idx.train()
        idx.search(x[:8], 10, **kw)          # kernels built, view up
        idx.upsert(np.arange(6000, 6100), x[:100] + 0.5)
        filters = [None, FilterSpec(ranges=[(0, 3000)]),
                   FilterSpec(exclude_ids=np.arange(10))]
        before = None if counter is None else getattr(*counter)
        luts = kernel_pq.ivfpq_adc_lut.launches
        ring = StagingRing(depth=len(filters), device="cuda")
        q8 = x[:8]
        misses = METRICS.counter("pipeline.staged_miss").get()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            thunks = [idx.search_async(x[:8], 10, f, **kw) for f in filters]
            staged = [ring.stage(q8) for _ in filters]
            thunks += [idx.search_async(q8, 10, f, staged=s, **kw)
                       for f, s in zip(filters, staged)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        res = [t() for t in thunks]
        for s in staged:
            s.release()
    finally:
        _restore(saved)
    assert METRICS.counter("pipeline.staged_miss").get() == misses
    if counter is not None:
        assert getattr(*counter) == before + 6
    # IVF_PQ trained: the residual tables, one kernel per dispatch
    assert kernel_pq.ivfpq_adc_lut.launches == luts + (
        6 if case == "pq_trained" else 0)
    for res_ in (res[:3], res[3:]):
        assert [int(r.ids[0]) for r in res_[0]] == list(range(8))
        assert all(r.ids.max() < 3000 for r in res_[1])
        assert not any(np.isin(r.ids, np.arange(10)).any()
                       for r in res_[2])
    for a, b in zip(res[:3], res[3:]):
        for ra, rb in zip(a, b):
            assert np.array_equal(ra.ids, rb.ids)
            assert ra.distances.tobytes() == rb.distances.tobytes()


# -- B1 and B2 on the tensor cores (split precision; B2 over work items) -------
def _rows_of(x, arm):
    """(rows as the arm stores them, their f32 values)."""
    if arm == "f32":
        return x, x
    rows, f32, _ = _tier_rows(x, "bf16")
    return rows, f32


def _exact_scores(q, f32, xsq, ids, ascending):
    """f64 'larger is better' scores of rows ids[b, k] (-1: -inf) for the
    queries q, with the rows' given norms."""
    q64, x64 = q.double().cpu(), f32.double().cpu()
    idx = ids.long().cpu()
    rows = x64[idx.clamp_min(0)]                       # [b, k, d]
    dots = torch.einsum("bd,bkd->bk", q64, rows)
    if ascending:
        sc = -(((q64 * q64).sum(1)[:, None] - 2.0 * dots)
               + xsq.double().cpu()[idx.clamp_min(0)])
    else:
        sc = dots
    return torch.where(idx < 0, torch.full_like(sc, -np.inf), sc).numpy()


def _assert_as_exact_as_plain(kv, ki, pv, pi, q, f32, xsq, ascending):
    """Kernel against plain where the f32 GEMM's own rounding can pass the
    parity tolerance (queries that nearly repeat a row, d 960: scores near
    0 from norms near 1,000): both against f64. The same -inf entries;
    every kernel score within 2x the plain's largest error against f64
    plus ATOL of its slot's f64 score (the fp32 tier's gate, precision_check
    .py); a kernel slot outside the plain's list no worse in f64 than the
    plain's k-th best by more than that."""
    kv, pv = kv.cpu().numpy(), pv.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(kv), np.isneginf(pv))
    fin = np.isfinite(pv)
    assert (ki.cpu().numpy()[~fin] == -1).all()
    kref = _exact_scores(q, f32, xsq, ki, ascending)
    pref = _exact_scores(q, f32, xsq, pi, ascending)
    perr = float(np.abs(pv[fin] - pref[fin]).max()) if fin.any() else 0.0
    allow = 2.0 * perr + ATOL
    assert np.abs(kv[fin] - kref[fin]).max(initial=0.0) <= allow
    kset, pset = ki.cpu().numpy(), pi.cpu().numpy()
    for r in range(len(kv)):
        if not fin[r].any():
            continue
        kth = pref[r][fin[r]].min()
        for c in np.flatnonzero(~np.isin(kset[r], pset[r])):
            assert kref[r, c] >= kth - allow, (r, c)


B1_SPLIT_CASES = [
    (64, 9000, 960, 10, True, 1.0),    # GIST's width; n not a tile multiple
    (64, 5000, 100, 64, True, 0.9),    # bf16 rows: a 200-byte pitch, plain
    (70, 3000, 960, 1, False, 0.8),    # two query tiles, k 1, IP
    (16, 700, 100, 10, True, 0.0),     # every row invalid
]


@pytest.mark.parametrize("arm", ["f32", "bf16"])
@pytest.mark.parametrize("b,n,d,k,ascending,keep", B1_SPLIT_CASES)
def test_fused_topk_split_kernel_matches_plain(arm, b, n, d, k, ascending,
                                               keep):
    from dingo_tpu_torch.ops import kernel_topk as kt

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(n + d + k)
    # clustered rows and queries near stored rows: scores near 0, where
    # the absolute tolerance, not the relative one, holds the sums
    raw = _clustered(g, n, d).to(dev)
    rows, f32 = _rows_of(raw, arm)
    q = (raw[torch.randint(0, n, (b,), generator=g).to(dev)]
         + 0.05 * torch.randn((b, d), generator=g).to(dev))
    xsq = (f32 * f32).sum(1)
    valid = (torch.rand(n, generator=g) < keep).to(dev)
    counter = "launches" if arm == "f32" else "launches_bf16"
    before = getattr(kt.fused_topk, counter)
    kv, ki = kt.fused_topk(q, rows, xsq, valid, k, ascending)
    assert getattr(kt.fused_topk, counter) == before + 1
    pv, pi = kt.fused_topk_plain(q, rows, xsq, valid, k, ascending)
    torch.cuda.synchronize()
    _assert_as_exact_as_plain(kv, ki, pv, pi, q, f32, xsq, ascending)
    if keep == 0.0:
        assert torch.isneginf(kv).all() and (ki == -1).all()


def _split_probes(g, b, budget, nb, hot):
    """Distinct buckets per query, none of them bucket 3 except at rank 0
    of the first `hot` queries (more than 8 of them: two items)."""
    others = torch.tensor([v for v in range(nb) if v != 3])
    vp = torch.stack([others[torch.randperm(nb - 1, generator=g)[:budget]]
                      for _ in range(b)]).to(torch.int32)
    vp[:hot, 0] = 3
    vp[2, 3:] = -1                         # padded ranks
    vp[b - 1] = -1                         # a query that probes nothing
    return vp


B2_SPLIT_CASES = [
    (960, 1024, 12, True, 0),      # GIST's width at the smoke's cap
    (100, 300, 64, True, 15),      # bf16 rows: plain loads; cap % 128 != 0
    (960, 200, 1, False, 12),      # k 1, IP
]


@pytest.mark.parametrize("arm", ["f32", "bf16"])
@pytest.mark.parametrize("d,cap,k,ascending,hot", B2_SPLIT_CASES)
def test_ivf_list_topk_split_kernel_matches_plain(arm, d, cap, k, ascending,
                                                  hot):
    from dingo_tpu_torch.ops import kernel_ivf as ki_mod

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d + cap + k)
    nb, b, budget = 40, 16, 9
    raw = _clustered(g, nb * cap, d).to(dev)
    rows, f32 = _rows_of(raw.reshape(nb, cap, d), arm)
    sq = (f32 * f32).sum(-1)
    valid = (torch.rand((nb, cap), generator=g) < 0.8).to(dev)
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = (raw[torch.randint(0, nb * cap, (b,), generator=g).to(dev)]
         + 0.05 * torch.randn((b, d), generator=g).to(dev))
    vp = _split_probes(g, b, budget, nb, hot).to(dev)
    counter = "launches" if arm == "f32" else "launches_bf16"
    before = getattr(ki_mod.ivf_list_topk, counter)
    kv, kslots = ki_mod.ivf_list_topk(vp, q, rows, sq, valid, slot, k,
                                      ascending)
    assert getattr(ki_mod.ivf_list_topk, counter) == before + 1
    pv, pslots = ki_mod.ivf_list_topk_plain(vp, q, rows, sq, valid, slot, k,
                                            ascending)
    torch.cuda.synchronize()
    assert (kslots[b - 1] == -1).all()
    _assert_parity(kv, kslots, pv, pslots)


@pytest.mark.parametrize("arm", ["f32", "bf16"])
@pytest.mark.parametrize("d", [6500, 6501])
def test_ivf_list_topk_wide_rows(arm, d):
    """Widths far past what 8 whole query rows beside the ring would leave
    room for (B2 stages the queries in the rows' column chunks): d 6500
    (f32 rows by TMA, bf16 rows by plain loads) and 6501 (plain loads),
    cap not a multiple of the tile, a bucket probed by 9 queries."""
    from dingo_tpu_torch.ops import kernel_ivf as ki_mod

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(d)
    nb, cap, b, budget, k = 24, 130, 12, 5, 10
    rows, f32 = _rows_of(torch.randn((nb, cap, d), generator=g).to(dev),
                         arm)
    sq = (f32 * f32).sum(-1)
    valid = (torch.rand((nb, cap), generator=g) < 0.9).to(dev)
    slot = torch.randperm(nb * cap, generator=g).reshape(nb, cap).to(
        torch.int32).to(dev)
    q = torch.randn((b, d), generator=g).to(dev)
    vp = _split_probes(g, b, budget, nb, 9).to(dev)
    kv, kslots = ki_mod.ivf_list_topk(vp, q, rows, sq, valid, slot, k)
    pv, pslots = ki_mod.ivf_list_topk_plain(vp, q, rows, sq, valid, slot, k)
    torch.cuda.synchronize()
    _assert_parity(kv, kslots, pv, pslots)


@pytest.mark.parametrize("arm", ["f32", "bf16"])
def test_ivf_list_topk_pair_does_not_depend_on_its_item(arm):
    """Every query probes the same buckets (items of 8): a query's results
    are the same bits alone, and at another column of its items."""
    from dingo_tpu_torch.ops import kernel_ivf as ki_mod

    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(31)
    nb, cap, d, b = 24, 256, 960, 16
    rows, f32 = _rows_of(torch.randn((nb, cap, d), generator=g).to(dev), arm)
    sq = (f32 * f32).sum(-1)
    valid = (torch.rand((nb, cap), generator=g) < 0.9).to(dev)
    slot = torch.arange(nb * cap, dtype=torch.int32).reshape(nb, cap).to(dev)
    q = torch.randn((b, d), generator=g).to(dev)
    vp = torch.randperm(nb, generator=g)[:6].to(torch.int32).repeat(b, 1)
    vp = vp.contiguous().to(dev)
    args = (rows, sq, valid, slot, 10)
    all_v, all_i = ki_mod.ivf_list_topk(vp, q, *args)
    alone = vp.clone()
    alone[1:] = -1
    one_v, one_i = ki_mod.ivf_list_topk(alone, q, *args)
    rev_v, rev_i = ki_mod.ivf_list_topk(vp, q.flip(0).contiguous(), *args)
    torch.cuda.synchronize()
    assert torch.equal(all_v[0], one_v[0]) and torch.equal(all_i[0], one_i[0])
    assert torch.equal(all_v, rev_v.flip(0)) and torch.equal(all_i,
                                                             rev_i.flip(0))


def test_default_route_at_d960_serves_on_b1_and_b2():
    """d = 960 (GIST1M) does not tile into 128-column blocks, so with every
    flag at its default a FLAT index serves on B1 and a trained IVF_FLAT
    on B2; the pruned kernels B3 and B4 do not launch."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import (
        kernel_ivf,
        kernel_ivf_pruned,
        kernel_topk,
        kernel_topk_pruned,
    )

    _cuda()
    rng = np.random.default_rng(960)
    centers = rng.standard_normal((16, 960), dtype=np.float32)
    x = (centers[rng.integers(0, 16, 5000)] + 0.3 * rng.standard_normal(
        (5000, 960), dtype=np.float32)).astype(np.float32)
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    b4 = kernel_topk_pruned.pruned_fused_topk
    pruned_before = (b3.launches, b4.launches)
    flat = new_index(30, IndexParameter(index_type=IndexType.FLAT,
                                        dimension=960))
    assert flat.store.vecs_blk is None
    flat.upsert(np.arange(5000), x)
    b1_before = kernel_topk.fused_topk.launches
    res_flat = flat.search(x[:8], 10)
    assert kernel_topk.fused_topk.launches == b1_before + 1
    ivf = new_index(31, IndexParameter(index_type=IndexType.IVF_FLAT,
                                       dimension=960, ncentroids=16))
    ivf.upsert(np.arange(5000), x)
    ivf.train()
    b2_before = kernel_ivf.ivf_list_topk.launches
    res_ivf = ivf.search(x[:8], 10, nprobe=16)
    assert kernel_ivf.ivf_list_topk.launches == b2_before + 1
    assert (b3.launches, b4.launches) == pruned_before
    assert [int(r.ids[0]) for r in res_flat] == list(range(8))
    # all 16 lists probed: the IVF search is exact, as FLAT's
    assert [r.ids.tolist() for r in res_ivf] == [r.ids.tolist()
                                                 for r in res_flat]


# -- the coalesced serving path on the card -----------------------------------
def test_staging_slot_reuse_waits_for_its_copy():
    """A depth-1 ring: the first batch's upload is queued behind a long
    kernel (torch.cuda._sleep) and its slot released at once, as after a
    dispatch that raised. The second stage() waits on the slot's copy
    event before it writes the slot, so the first upload still carries the
    first batch's bytes."""
    from dingo_tpu_torch.common.pipeline import StagingRing

    _cuda()
    rng = np.random.default_rng(21)
    a = rng.standard_normal((48, 4096), dtype=np.float32)
    b = rng.standard_normal((48, 4096), dtype=np.float32)
    ring = StagingRing(depth=1, device="cuda")
    ring.stage(a).release()              # the slot exists, its copy done
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))          # holds the stream ~0.2 s
    s1 = ring.stage(a)
    qa = s1.qpad
    s1.release()                         # the copy is still queued
    s2 = ring.stage(b)
    qb = s2.qpad
    torch.cuda.synchronize()
    want_a = np.zeros((64, 4096), np.float32)
    want_a[:48] = a
    want_b = np.zeros((64, 4096), np.float32)
    want_b[:48] = b
    assert qa.cpu().numpy().tobytes() == want_a.tobytes()
    assert qb.cpu().numpy().tobytes() == want_b.tobytes()
    s2.release()


def _coalesced_rows(svc, q, topk, kw):
    futs = [svc.submit(1 + (i // 4) % 4, q[i:i + 4], topk, **kw)
            for i in range(0, len(q), 4)]
    return [r for f in futs for r in f.result(timeout=60)]


@pytest.mark.parametrize("family", ["flat_b4", "ivf_b3", "pq_b5"])
def test_coalesced_pipelined_equals_serial_on_device(family):
    """The coalesced service on the card: the pipelined arm (staged
    uploads, completion lane) returns the serial arm's ids and distances
    bit for bit, claims every staged upload and runs the family's
    kernel."""
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.ops import (
        kernel_ivf_pruned,
        kernel_pq,
        kernel_topk_pruned,
    )
    from dingo_tpu_torch.server.services import IndexService
    from torch_region_util import node_over_wrapper

    _cuda()
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((32, 256), dtype=np.float32)
    x = (centers[rng.integers(0, 32, 8000)] + 0.3 * rng.standard_normal(
        (8000, 256), dtype=np.float32)).astype(np.float32)
    q = x[:64] + 0.01
    saved = _flags(ivfpq_rerank_factor=6, pipeline_enabled="auto")
    try:
        if family == "flat_b4":
            idx = new_index(40, IndexParameter(index_type=IndexType.FLAT,
                                               dimension=256))
            kern, kw = kernel_topk_pruned.pruned_fused_topk, {}
        elif family == "ivf_b3":
            idx = new_index(41, IndexParameter(
                index_type=IndexType.IVF_FLAT, dimension=256,
                ncentroids=32))
            kern, kw = kernel_ivf_pruned.ivf_pruned_topk, {"nprobe": 8}
        else:
            idx = new_index(42, IndexParameter(
                index_type=IndexType.IVF_PQ, dimension=256, ncentroids=32,
                nsubvector=32))
            kern, kw = kernel_pq.ivf_pq_adc_topk, {"nprobe": 8}
        idx.upsert(np.arange(8000), x)
        if family != "flat_b4":
            idx.train()
        w = VectorIndexWrapper(idx.id, idx.parameter)
        w.set_own(idx)
        out = {}
        for pipelined in ("false", "auto"):
            _flags(pipeline_enabled=pipelined)
            node = node_over_wrapper(w, np.arange(8000), x,
                                     keys=(1, 2, 3, 4))
            svc = IndexService(node, window_ms=2.0, max_batch=64)
            launches = kern.launches
            misses = METRICS.counter("pipeline.staged_miss").get()
            try:
                out[pipelined] = _coalesced_rows(svc, q, 10, kw)
                stages = svc._get_coalescer().stage_totals()
            finally:
                svc.close()
            assert kern.launches > launches
            assert METRICS.counter("pipeline.staged_miss").get() == misses
            # "auto" takes the pipelined arm on a CUDA device
            assert ("dispatch" in stages) == (pipelined == "auto")
    finally:
        _restore(saved)
    for a, b in zip(out["false"], out["auto"]):
        assert [v.id for v in a] == [v.id for v in b]
        assert [v.distance for v in a] == [v.distance for v in b]
    if family != "pq_b5":          # PQ codes approximate the rows
        assert [r[0].id for r in out["auto"]] == list(range(64))


def test_completion_lane_fifo_on_device():
    """Handoffs whose resolve waits on a reply's device fetch (the
    HostFetch event) resolve in submission order, each with its own
    values, behind kernels of different lengths."""
    from dingo_tpu_torch.common.pipeline import CompletionLane
    from dingo_tpu_torch.ops.topk import begin_host_fetch

    _cuda()
    done = []

    class H:
        def __init__(self, tag, fetch):
            self.tag, self.fetch = tag, fetch

        def resolve(self):
            (v,) = self.fetch.get()
            done.append((self.tag, float(v[0])))

        def abandon(self):  # pragma: no cover
            raise AssertionError("drained, not abandoned")

    lane = CompletionLane(name="test-lane-gpu")
    dev = torch.device("cuda")
    for i in range(8):
        torch.cuda._sleep(int(2e7) * (8 - i))
        t = torch.full((4,), float(i), device=dev) * 2.0
        assert lane.submit(H(i, begin_host_fetch(t)))
    lane.stop(drain=True, timeout=30)
    assert done == [(i, 2.0 * i) for i in range(8)]


# ---------------- the replicated region path on the card -------------------

def _region_cluster(d, nlist, dev_peers=("s0", "s1", "s2")):
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.raft import LocalTransport
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    transport = LocalTransport()
    nodes = {sid: StoreNode(sid, transport, raft_kw={
        "seed": i, "election_timeout": (1.0, 2.0),
        "heartbeat_interval": 0.1}) for i, sid in enumerate(dev_peers)}
    definition = RegionDefinition(
        region_id=1, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), peers=list(dev_peers),
        region_type=RegionType.INDEX, index_parameter=IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=d, ncentroids=nlist))
    regions = {sid: n.create_region(definition) for sid, n in nodes.items()}
    return nodes, regions


def _region_leader(nodes, timeout=20.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        lead = [s for s, n in nodes.items() if n.engine.get_node(1).is_leader()]
        if len(lead) == 1:
            return lead[0]
        time.sleep(0.02)
    raise AssertionError("no unique leader")


def _region_write(nodes, regions, fn, attempts=10):
    import time

    from dingo_tpu_torch.raft import NotLeader

    for _ in range(attempts):
        sid = _region_leader(nodes)
        try:
            return fn(nodes[sid].storage, regions[sid])
        except NotLeader:
            time.sleep(0.1)
    raise AssertionError("leadership never stabilized")


def _region_settle(nodes, timeout=30.0):
    import time

    lead = _region_leader(nodes)
    target = nodes[lead].engine.get_node(1).commit_index
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(n.engine.get_node(1).last_applied >= target
               for n in nodes.values()):
            return
        time.sleep(0.02)
    raise AssertionError("replicas did not apply the commit index")


def _region_data(n=6000, d=256, seed=31):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d), dtype=np.float32)
    x = (centers[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)).astype(np.float32)
    return x, x[rng.choice(n, 16, replace=False)] + 0.01


def test_region_cluster_searches_on_b4_then_b3():
    """A 3-store region on the card: writes through the leader's Storage
    replicate; untrained, every replica's reader brute-forces on B4 with
    numpy's exact ids; after VectorIndexManager.rebuild on each replica,
    the reader searches on B3 and the replicas agree."""
    from dingo_tpu_torch.ops import kernel_ivf_pruned, kernel_topk_pruned

    _cuda()
    x, q = _region_data()
    nodes, regions = _region_cluster(256, 16)
    try:
        for lo in range(0, len(x), 1000):
            _region_write(nodes, regions, lambda s, r, lo=lo: s.vector_add(
                r, np.arange(lo, lo + 1000, dtype=np.int64),
                x[lo:lo + 1000]))
        _region_settle(nodes)
        d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        exact = np.argsort(d2, axis=1)[:, :10]
        b4 = kernel_topk_pruned.pruned_fused_topk
        b3 = kernel_ivf_pruned.ivf_pruned_topk
        l4 = b4.launches
        for sid, node in nodes.items():
            rows = node.storage.vector_batch_search(regions[sid], q, 10)
            for qi, row in enumerate(rows):
                got = [v.id for v in row]
                assert set(got) == set(exact[qi].tolist()) or np.allclose(
                    np.sort(d2[qi, got]), np.sort(d2[qi, exact[qi]]),
                    rtol=1e-4), (sid, qi)
        assert b4.launches >= l4 + 3
        l3 = b3.launches
        for sid, node in nodes.items():
            node.index_manager.rebuild(regions[sid],
                                       raft_log=node.engine.get_node(1).log)
            assert regions[sid].vector_index_wrapper.own_index.is_trained()
        ids = {sid: [[v.id for v in row] for row in
                     node.storage.vector_batch_search(regions[sid], q, 10,
                                                      nprobe=16)]
               for sid, node in nodes.items()}
        assert b3.launches >= l3 + 3
        assert ids["s1"] == ids["s0"] and ids["s2"] == ids["s0"]
        for qi in range(len(q)):
            assert ids["s0"][qi][0] == exact[qi][0]
    finally:
        for node in nodes.values():
            node.stop()


def _trained_mono_region(d=256, n=6000, nlist=16):
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    x, q = _region_data(n, d)
    node = MonoStoreNode()
    region = node.create_region(RegionDefinition(
        region_id=2, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=IndexParameter(index_type=IndexType.IVF_FLAT,
                                       dimension=d, ncentroids=nlist)))
    for lo in range(0, n, 2000):
        node.storage.vector_add(region, np.arange(lo, lo + 2000), x[lo:lo + 2000])
    node.index_manager.rebuild(region)
    return node, region, x, q


def test_region_reader_async_dispatch_does_not_sync():
    """Storage.vector_batch_search_async through the reader (its id-window
    filter compiled anew after a write) takes the async arm and makes no
    synchronizing call before its resolve."""
    from dingo_tpu_torch.index.vector_reader import VectorReader
    from dingo_tpu_torch.ops import kernel_ivf_pruned

    _cuda()
    node, region, x, q = _trained_mono_region()
    try:
        node.storage.vector_batch_search(region, q, 10, nprobe=8)   # warm
        node.storage.vector_add(region, np.asarray([7000], np.int64),
                                x[:1] + 0.5)
        want = node.storage.vector_batch_search(region, q, 10, nprobe=8)
        node.storage.vector_add(region, np.asarray([7001], np.int64),
                                x[:1] + 0.6)
        node.storage.vector_add(region, np.asarray([7001], np.int64),
                                x[:1] + 0.5)
        launches = kernel_ivf_pruned.ivf_pruned_topk.launches
        stage = {}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            thunk = node.storage.vector_batch_search_async(
                region, q, 10, nprobe=8, stage_us=stage)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert thunk.__name__ != "sync_thunk"       # no fallback
        got = thunk()
        assert kernel_ivf_pruned.ivf_pruned_topk.launches == launches + 1
        assert stage["search_us"] <= stage["total_us"]
        for a, b in zip(got, want):
            ga = [v.id for v in a if v.id != 7001]
            gb = [v.id for v in b if v.id != 7001]
            assert ga[:5] == gb[:5]
        assert isinstance(node.engine.new_vector_reader(region), VectorReader)
    finally:
        node.stop()


def test_region_search_b3_kernel_matches_plain():
    """One region search's B3 launch, captured on the way, against B3's
    plain version on the same inputs."""
    from dingo_tpu_torch.ops import kernel_ivf_pruned

    _cuda()
    node, region, x, q = _trained_mono_region()
    orig = kernel_ivf_pruned.ivf_pruned_topk
    seen = []

    def spy(*a, **kw):
        out = orig(*a, **kw)
        if not seen:
            seen.append(([t.clone() if torch.is_tensor(t) else t for t in a],
                         dict(kw), [o.clone() for o in out]))
        return out

    spy.__dict__ = orig.__dict__      # the kernel reads its flags by name
    kernel_ivf_pruned.ivf_pruned_topk = spy
    try:
        node.storage.vector_batch_search(region, q, 10, nprobe=8)
    finally:
        kernel_ivf_pruned.ivf_pruned_topk = orig
        node.stop()
    assert seen
    args, kw, (kv, ki, ks) = seen[0]
    pv, pi, ps = kernel_ivf_pruned.ivf_pruned_topk_plain(*args, **kw)
    _assert_parity(kv, ki, pv, pi)
    assert torch.equal(ks[:, 1], ps[:, 1]) and torch.equal(ks[:, 3], ps[:, 3])


# ---------------- kernel G and the HNSW walk on the card ---------------------

G_CASES = [
    # b, C, d, cap, hole share, rows the slots draw from (None: all)
    (64, 4096, 768, 20000, 0.9, None),
    (3, 100, 32, 500, 0.0, None),
    (5, 70, 33, 300, 0.5, None),    # d off the 16-byte loads: scalar path
    (2, 9, 768, 64, 1.0, None),     # every slot a hole
    # the walk's shapes: queries share rows (2,000 of 100,000), one row in
    # every live slot, repeats within a query, the build's reprune and
    # the build walk's rounds
    (64, 16384, 768, 100000, 0.5, 2000),
    (64, 4096, 768, 20000, 0.0, 1),
    (64, 2048, 128, 5000, 0.3, 50),
    (1024, 72, 768, 100000, 0.2, None),
    (256, 16384, 768, 100000, 0.5, None),
]


def _g_inputs(arm, b, c, d, cap, holes, pool, seed):
    """CPU inputs of kernel G: queries, rows of the arm, their norms (the
    store's convention), the sq8 codec, and slots [b, c] drawn from `pool`
    random rows (None: all cap) with a `holes` share of -1."""
    from dingo_tpu_torch.ops.distance import squared_norms
    from dingo_tpu_torch.ops.sq import sq_decode_device, sq_train, sq_encode

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, d)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    vmin = scale = None
    if arm == "sq8":
        params = sq_train(x)
        vecs = torch.from_numpy(sq_encode(x, params))
        vmin = torch.from_numpy(params.vmin)
        scale = torch.from_numpy(params.scale)
        sqn = squared_norms(sq_decode_device(vecs, vmin, scale,
                                             torch.float32))
    else:
        vecs = torch.from_numpy(x).to(torch.bfloat16 if arm == "bf16"
                                      else torch.float32)
        sqn = squared_norms(vecs)
    rows = (np.arange(cap) if pool is None
            else rng.choice(cap, pool, replace=False))
    slots = rows[rng.integers(0, len(rows), (b, c))].astype(np.int32)
    slots[rng.random((b, c)) < holes] = -1
    return q, vecs, sqn, torch.from_numpy(slots), vmin, scale


_METRICS = {"l2": "L2", "ip": "INNER_PRODUCT", "cosine": "COSINE"}


def _g_check(got, plain, slots):
    """Holes exactly -inf, live slots within the tolerance."""
    got, plain, slots = (t.cpu().numpy() for t in (got, plain, slots))
    np.testing.assert_array_equal(np.isneginf(got), slots < 0)
    fin = slots >= 0
    np.testing.assert_allclose(got[fin], plain[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("b,c,d,cap,holes,pool", G_CASES)
def test_candidate_scores_kernel_matches_plain(arm, metric, b, c, d, cap,
                                               holes, pool):
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    m = getattr(Metric, _METRICS[metric])
    ins = _g_inputs(arm, b, c, d, cap, holes, pool, b * 7 + c)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    # the large cases' plain version on the card (the same torch ops)
    pdev = on if b * c > 1 << 18 else (lambda t: t)
    plain = kb.candidate_scores_plain(*(pdev(t) for t in ins[:4]), m,
                                      *(pdev(t) for t in ins[4:]))
    counter = "launches" if arm == "f32" else f"launches_{arm}"
    n0 = getattr(kb.candidate_scores, counter)
    q, vecs, sqn, slots, vmin, scale = (on(t) for t in ins)
    got = kb.candidate_scores(q, vecs, sqn, slots, m, vmin, scale)
    assert getattr(kb.candidate_scores, counter) == n0 + 1
    _g_check(got, plain, ins[3])
    # each design where it can take the inputs, whichever the shape chose
    _g_check(kb._scores_pair(q, vecs, sqn, slots, m, vmin, scale), plain,
             ins[3])
    if kb.block_arm_fits(q, vecs, slots):
        _g_check(kb._scores_block(q, vecs, sqn, slots, m, vmin, scale),
                 plain, ins[3])


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("b,c,d,cap,holes,pool", [
    (3, 100, 32, 500, 0.0, None),       # one partial query block
    (70, 300, 48, 1000, 0.3, None),     # two blocks; d ends mid-stage
    (130, 50, 64, 200, 0.1, 20),        # three blocks sharing 20 rows
    (2, 9, 768, 64, 1.0, None),         # every slot a hole: no rows
    (64, 600, 16, 100000, 0.0, None),   # one 16-column stage, rows > 256
    (40, 300, 160, 2000, 0.2, 100),     # one block: runs of 1-2 stages
])
def test_candidate_scores_block_arm_forced_matches_plain(
        arm, metric, b, c, d, cap, holes, pool):
    """The block arm on shapes the walk does not give it (its launcher
    called whatever the shape): partial query blocks, several blocks, a d
    that ends inside a stage, no live slot, a tile boundary inside a
    block, one block whose tiles are cut into runs of columns of unequal
    length. The launcher counts nothing."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    if arm == "sq8" and d % 16:
        pytest.skip("sq8 codes need d a multiple of 16 on the block arm")
    m = getattr(Metric, _METRICS[metric])
    ins = _g_inputs(arm, b, c, d, cap, holes, pool, b * 11 + c)
    plain = kb.candidate_scores_plain(*ins[:4], m, *ins[4:])
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    g = kb.candidate_scores
    n0 = (g.block, g.pair, g.launches, g.launches_bf16, g.launches_sq8)
    got = kb._scores_block(*(on(t) for t in ins[:4]), m,
                           *(on(t) for t in ins[4:]))
    assert (g.block, g.pair, g.launches, g.launches_bf16,
            g.launches_sq8) == n0
    _g_check(got, plain, ins[3])


def test_candidate_scores_block_arm_empty_store():
    """The block arm on a store with no row: every slot a hole, -inf, and
    no product launched."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    q = torch.randn(4, 64, device=dev)
    vecs = torch.zeros((0, 64), device=dev)
    slots = torch.full((4, 2048), -1, dtype=torch.int32, device=dev)
    got = kb._scores_block(q, vecs, torch.zeros(0, device=dev), slots,
                           Metric.L2)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(got).all())


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("b,c,d,cap,holes,pool", [
    (64, 16384, 768, 100000, 0.5, 2000),
    (256, 16384, 768, 100000, 0.5, None),
])
def test_candidate_scores_block_arm_bitwise_repeatable(arm, b, c, d, cap,
                                                       holes, pool):
    """Two launches of one input give the same bits, and so does a launch
    on the candidate columns permuted (the claim pass then numbers the
    rows in another order): a pair's dot depends only on its query and
    its row."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    q, vecs, sqn, slots, vmin, scale = (
        None if t is None else t.to(dev)
        for t in _g_inputs(arm, b, c, d, cap, holes, pool, 23))
    g = kb._scores_block
    one = g(q, vecs, sqn, slots, Metric.L2, vmin, scale)
    two = g(q, vecs, sqn, slots, Metric.L2, vmin, scale)
    perm = torch.randperm(c, generator=torch.Generator().manual_seed(5))
    perm = perm.to(dev)
    three = g(q, vecs, sqn, slots[:, perm].contiguous(), Metric.L2, vmin,
              scale)
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))
    assert torch.equal(one[:, perm].view(torch.int32),
                       three.view(torch.int32))


def test_candidate_scores_design_arm_by_shape():
    """The block arm takes the build walk's rounds, the per-pair arm the
    seeds, the search's one-block rounds, the selection-sized and reprune
    launches and inputs the block arm cannot copy in 16-byte pieces; each
    launch moves its design's counter and its dtype arm's."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    g = kb.candidate_scores
    cases = [  # (b, c, d, block arm?)
        (64, 16384, 128, False), (256, 16384, 128, True),
        (65, kb.BLOCK_MIN_SLOTS, 128, True),
        (128, kb.BLOCK_MIN_SLOTS - 1, 128, False),
        (64, 1, 128, False), (1024, 72, 128, False), (256, 512, 128, False),
        (64, 4096, 33, False),              # d off the 16-byte pieces
        (64 * kb.BLOCK_MAX_BLOCKS + 1, 2048, 32, False),   # too many blocks
    ]
    for b, c, d, block in cases:
        q, vecs, sqn, slots, _, _ = (
            None if t is None else t.to(dev)
            for t in _g_inputs("f32", b, c, d, 3000, 0.5, None, 3))
        nb, npair, nf = g.block, g.pair, g.launches
        g(q, vecs, sqn, slots, Metric.L2)
        assert (g.block - nb, g.pair - npair) == (
            (1, 0) if block else (0, 1)), (b, c, d)
        assert g.launches == nf + 1
    # the per-design launchers take any shape they can and count nothing
    nb, npair = g.block, g.pair
    q, vecs, sqn, slots, _, _ = (
        None if t is None else t.to(dev)
        for t in _g_inputs("f32", 64, 16384, 128, 3000, 0.5, None, 3))
    torch.testing.assert_close(kb._scores_pair(q, vecs, sqn, slots,
                                               Metric.L2),
                               kb._scores_block(q, vecs, sqn, slots,
                                                Metric.L2),
                               rtol=RTOL, atol=ATOL)
    q, vecs, sqn, slots, _, _ = (
        None if t is None else t.to(dev)
        for t in _g_inputs("f32", 4, 100, 33, 300, 0.5, None, 3))
    with pytest.raises(ValueError):
        kb._scores_block(q, vecs, sqn, slots, Metric.L2)
    assert (g.block, g.pair) == (nb, npair)


def test_candidate_scores_block_scratch_across_layouts():
    """The block arm keeps its scratch from launch to launch: launches of
    the search's and the build walk's layouts in turn, and a store that
    grows between two launches of one layout, each match the plain
    version (a map entry of an earlier launch or layout never reads as
    claimed)."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    cases = [(128, 2048, 64, 5000, 0.3, 300),
             (256, 2048, 64, 5000, 0.3, None),
             (128, 2048, 64, 5000, 0.3, 300), (128, 2048, 64, 9000, 0.1, 300),
             (128, 2048, 64, 9000, 0.6, 2000)]
    for i, (b, c, d, cap, holes, pool) in enumerate(cases):
        ins = _g_inputs("f32", b, c, d, cap, holes, pool, 31 + i)
        plain = kb.candidate_scores_plain(*ins[:4], Metric.L2)
        nb = kb.candidate_scores.block
        got = kb.candidate_scores(*(t.to(dev) for t in ins[:4]), Metric.L2)
        assert kb.candidate_scores.block == nb + 1
        _g_check(got, plain, ins[3])


@pytest.mark.parametrize("seed", [7, 11, 13])
def test_candidate_scores_block_f32_as_exact_as_plain(seed):
    """The f32 block arm multiplies in 3xTF32 on the tensor cores: its
    scores' largest relative error against f64 (over |f64| >= 1e-3 of the
    largest) is at most twice the plain f32 version's, at the walk's
    shape (precision_check.py's gate)."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    q, vecs, sqn, slots = (
        t.to(dev) for t in _g_inputs("f32", 64, 16384, 768, 100000, 0.5,
                                     2000, seed)[:4])
    for metric in (Metric.L2, Metric.INNER_PRODUCT):
        got = kb._scores_block(q, vecs, sqn, slots, metric)
        plain = kb.candidate_scores_plain(q, vecs, sqn, slots, metric)
        live = slots >= 0
        r = slots[live].long()
        qi = torch.nonzero(live, as_tuple=True)[0]
        q64, x64 = q.double()[qi], vecs.double()[r]
        dot = (q64 * x64).sum(1)
        ref = (-((q.double() ** 2).sum(1)[qi] - 2.0 * dot
                 + sqn.double()[r]) if metric is Metric.L2 else dot)

        def rel(v):
            err = (v[live].double() - ref).abs()
            big = ref.abs() >= 1e-3 * ref.abs().max()
            return float((err[big] / ref.abs()[big]).max())

        assert rel(got) <= 2.0 * rel(plain), (metric, rel(got), rel(plain))


def test_candidate_scores_unaligned_rows_take_scalar_loads():
    """A row array that does not start on a 16-byte boundary: the scalar
    path, same scores."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.distance import Metric, squared_norms

    dev = _cuda()
    rng = np.random.default_rng(5)
    big = torch.from_numpy(rng.standard_normal((401 * 64 + 1,))
                           .astype(np.float32)).to(dev)
    vecs = big[1:].view(401, 64)                 # 4-byte offset
    sqn = squared_norms(vecs)
    q = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(-1, 401, (4, 50)).astype(np.int32))
    got = kb.candidate_scores(q.to(dev), vecs, sqn, slots.to(dev), Metric.L2)
    plain = kb.candidate_scores_plain(q, vecs.cpu(), sqn.cpu(), slots,
                                      Metric.L2)
    fin = (slots >= 0).numpy()
    np.testing.assert_allclose(got.cpu().numpy()[fin], plain.numpy()[fin],
                               rtol=RTOL, atol=ATOL)


def _hnsw_corpus(n=6000, d=128, nq=64, seed=3):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((24, d), dtype=np.float32)
    x = (centers[rng.integers(0, 24, n)] + rng.standard_normal(
        (n, d), dtype=np.float32)).astype(np.float32)
    q = (x[rng.integers(0, n, nq)] + 0.1 * rng.standard_normal(
        (nq, d), dtype=np.float32)).astype(np.float32)
    return x, q


def _hnsw_index(tier="fp32", device="cuda", n=6000, d=128, **kw):
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index

    x, q = _hnsw_corpus(n, d)
    idx = new_index(40, IndexParameter(index_type=IndexType.HNSW,
                                       dimension=d, nlinks=16,
                                       efconstruction=96, precision=tier,
                                       **kw), device=device)
    idx.add(np.arange(n, dtype=np.int64), x)
    return idx, x, q


def _recall(res, x, q, k=10):
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :k]
    return float(np.mean([len(set(r.ids) & set(e)) / k
                          for r, e in zip(res, exact)]))


@pytest.mark.parametrize("tier", ["fp32", "bf16", "sq8"])
def test_hnsw_walk_on_device_matches_plain_walk(tier):
    """The same graph walked on the card (kernel G) and on the CPU (its
    plain version): recall within 0.01, hops within 1."""
    from dingo_tpu_torch.ops import kernel_beam as kb
    from dingo_tpu_torch.ops.beam import beam_search

    dev = _cuda()
    idx, x, q = _hnsw_index(tier)
    g = kb.candidate_scores
    counter = "launches" if tier == "fp32" else f"launches_{tier}"
    n0 = getattr(g, counter)
    res = idx.search(q, 10, ef=128)
    assert getattr(g, counter) > n0
    st = idx.store
    sq_on, vmin, scale = idx._codec()
    qd = torch.from_numpy(idx._prep_queries(q))
    args = (st.adj, st.vecs, st.sqnorm, st.device_mask(), st.device_mask())
    out_d = beam_search(*args, qd.to(dev), idx._entry_slot, vmin, scale,
                        128, 48, idx._kernel_metric, sq_on)
    out_p = beam_search(*(a.cpu() for a in args), qd, idx._entry_slot,
                        vmin.cpu(), scale.cpu(), 128, 48,
                        idx._kernel_metric, sq_on)
    hops_d, hops_p = out_d[1].cpu().numpy(), out_p[1].numpy()
    assert np.abs(hops_d - hops_p).max() <= 1
    ids_d = st.ids_of_slots(out_d[0].cpu().numpy().astype(np.int64))
    ids_p = st.ids_of_slots(out_p[0].numpy().astype(np.int64))
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :10]
    rd = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(ids_d, exact)])
    rp = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(ids_p, exact)])
    assert abs(rd - rp) <= 0.01
    assert _recall(res, x, q) >= 0.9


def test_hnsw_device_search_dispatch_does_not_sync():
    """search_async of a device-walk HNSW (the walk's max_iters rounds,
    kernel G, the rerank) makes no synchronizing call, with and without a
    filter it has not seen."""
    from dingo_tpu_torch.index.base import FilterSpec

    _cuda()
    idx, x, q = _hnsw_index()
    idx.search(q[:8], 10, ef=64)         # mirror exported, shapes warm
    idx.upsert(np.arange(6000, 6100, dtype=np.int64), x[:100] + 0.5)
    idx.search(q[:8], 10, ef=64)         # re-export after the write
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        thunks = [idx.search_async(q, 10, ef=64),
                  idx.search_async(q, 10, FilterSpec(ranges=[(0, 3000)]),
                                   ef=64)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res, filt = thunks[0](), thunks[1]()
    assert _recall(res, x, q) >= 0.9
    assert all((r.ids < 3000).all() for r in filt)


def test_device_bulk_build_on_card_routes():
    """The device bulk build on the card: kernel G in discovery and
    reprune, a graph that routes, and the native back-fill on the first
    write."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import kernel_beam as kb

    _cuda()
    x, q = _hnsw_corpus(4000)
    idx = new_index(41, IndexParameter(index_type=IndexType.HNSW,
                                       dimension=128, nlinks=16,
                                       efconstruction=96))
    sess = idx.bulk_builder(expect_rows=4000)
    assert sess is not None          # "auto" is on for a CUDA store
    n0 = kb.candidate_scores.launches
    for s in range(0, 4000, 1000):
        sess.add(np.arange(s, s + 1000, dtype=np.int64), x[s:s + 1000])
    stats = sess.finish()
    assert stats["rows"] == 4000 and kb.candidate_scores.launches > n0
    assert _recall(idx.search(q, 10, ef=128), x[:4000], q) >= 0.9
    idx.upsert(np.asarray([4000], np.int64), x[:1] + 0.25)
    assert not idx._native_pending
    FLAGS.set("hnsw_device_search", False)
    try:
        assert _recall(idx.search(q, 10, ef=128), np.concatenate(
            [x[:4000], x[:1] + 0.25]), q) >= 0.9
    finally:
        FLAGS.set("hnsw_device_search", "auto")


def test_recovery_retry_and_degrade_on_card_region():
    """A FLAT region on the card (B4 on its path): one injected fault is
    recovered by the ladder's retry; a persistent one degrades the region,
    whose host path answers like numpy and absorbs writes; the
    re-materialization rebuilds it on the card."""
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.recovery import RECOVERY
    from dingo_tpu_torch.ops.devfault import DEVFAULT
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    _cuda()
    x, q = _hnsw_corpus(6000, 256, nq=16)
    node = MonoStoreNode()
    region = node.create_region(RegionDefinition(
        region_id=3, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=IndexParameter(index_type=IndexType.FLAT,
                                       dimension=256)))
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :5]
    try:
        node.storage.vector_add(region, np.arange(4000), x[:4000])
        DEVFAULT.arm(1)
        rows = node.storage.vector_batch_search(region, q, 5)
        assert DEVFAULT.armed() == 0 and not RECOVERY.is_degraded(3)
        e4 = np.argsort(d2[:, :4000], axis=1)[:, :5]
        assert [r[0].id for r in rows] == e4[:, 0].tolist()
        DEVFAULT.arm(1 << 30)
        node.storage.vector_add(region, np.arange(4000, 6000), x[4000:])
        assert RECOVERY.is_degraded(3)
        rows = node.storage.vector_batch_search(region, q, 5)
        assert [[v.id for v in r] for r in rows] == exact.tolist()
        DEVFAULT.disarm()
        assert RECOVERY.run_rematerializations(node) == 1
        assert not RECOVERY.is_degraded(3)
        rows = node.storage.vector_batch_search(region, q, 5)
        assert [r[0].id for r in rows] == exact[:, 0].tolist()
    finally:
        DEVFAULT.disarm()
        RECOVERY.clear()
        node.stop()


# ---------------- the control plane: split and merge on the card -----------

def _wait(cond, what, timeout=30.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out: {what}")


def _leader_of(nodes, rid):
    out = []

    def one():
        out[:] = [s for s, n in nodes.items()
                  if (r := n.engine.get_node(rid)) is not None
                  and r.is_leader()]
        return len(out) == 1

    _wait(one, f"a leader of region {rid}")
    return out[0]


def _assert_exact(rows, x, ids, q, k=10):
    """Each reply row is a valid exact top-k of `q` over rows `x` (with
    ids `ids`): the same id set, or the same sorted distances (ties)."""
    pos = {int(i): j for j, i in enumerate(ids)}
    for qi, row in enumerate(rows):
        got = [v.id for v in row]
        assert len(got) == k and len(set(got)) == k, (qi, got)
        d2 = ((x - q[qi][None, :]) ** 2).sum(1)
        want = np.argsort(d2, kind="stable")[:k]
        have = np.sort(d2[[pos[i] for i in got]])
        assert set(got) == set(ids[want].tolist()) or np.allclose(
            have, np.sort(d2[want]), rtol=1e-4), (qi, got)


def test_region_split_and_merge_on_the_card():
    """A coordinator and three stores on the card: an IVF_FLAT region
    created by the coordinator and delivered by heartbeats, trained on
    every replica, split at id 3000 by a coordinator command, its child
    served through the parent's shared index, then by its own index, then
    merged back and served through the sibling merge, then rebuilt whole.
    Each search (nprobe = nlist) equals numpy's exact top-10 modulo ties;
    B4 serves the untrained scan and B3 every trained search."""
    from dingo_tpu_torch.coordinator.control import CoordinatorControl
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.ops import kernel_ivf_pruned, kernel_topk_pruned
    from dingo_tpu_torch.raft import LocalTransport
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionType

    _cuda()
    x, q = _region_data()
    n, nlist, mid = len(x), 16, 3000
    ids = np.arange(n)
    transport = LocalTransport()
    coord = CoordinatorControl(MemEngine(), replication=3)
    nodes = {sid: StoreNode(sid, transport, coord, raft_kw={
        "seed": i, "election_timeout": (1.0, 2.0),
        "heartbeat_interval": 0.1}) for i, sid in enumerate(
            ("s0", "s1", "s2"))}
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    b4 = kernel_topk_pruned.pruned_fused_topk

    def beat(rounds=2):
        for _ in range(rounds):
            for nd in nodes.values():
                nd.heartbeat_once()

    def search(rid, **kw):
        return {s: nd.storage.vector_batch_search(nd.get_region(rid), q, 10,
                                                  **kw)
                for s, nd in nodes.items()}

    try:
        d = coord.create_region(
            vcodec.encode_vector_key(0, 0), vcodec.encode_vector_key(1),
            region_type=RegionType.INDEX, index_parameter=IndexParameter(
                index_type=IndexType.IVF_FLAT, dimension=x.shape[1],
                ncentroids=nlist, default_nprobe=nlist))
        rid = d.region_id
        beat()
        _wait(lambda: all(nd.get_region(rid) for nd in nodes.values()),
              "every store hosts the region")
        lead = _leader_of(nodes, rid)
        for lo in range(0, n, 1000):
            nodes[lead].storage.vector_add(
                nodes[lead].get_region(rid), ids[lo:lo + 1000],
                x[lo:lo + 1000])
        commit = nodes[lead].engine.get_node(rid).commit_index
        _wait(lambda: all(nd.engine.get_node(rid).last_applied >= commit
                          for nd in nodes.values()), "replicas applied")
        l4 = b4.launches
        for rows in search(rid).values():
            _assert_exact(rows, x, ids, q)
        assert b4.launches >= l4 + 3
        for nd in nodes.values():
            nd.index_manager.rebuild(nd.get_region(rid),
                                     raft_log=nd.engine.get_node(rid).log)
        beat()                       # the leader reports its region
        child = coord.split_region(rid, vcodec.encode_vector_key(0, mid))
        _wait(lambda: (beat(1) or True) and all(
            nd.get_region(child) is not None for nd in nodes.values()),
            "every store hosts the child")
        assert coord.regions[child].start_key == \
            vcodec.encode_vector_key(0, mid)
        xc, ic = x[mid:], ids[mid:]
        for stage in ("share", "own"):
            l3 = b3.launches
            got = search(child, nprobe=nlist)
            assert b3.launches >= l3 + 3, stage
            for s, rows in got.items():
                w = nodes[s].get_region(child).vector_index_wrapper
                assert (w.share_index is not None) == (stage == "share")
                _assert_exact(rows, xc, ic, q)
            if stage == "share":
                for nd in nodes.values():
                    nd.finish_child_index(child)
        for rows in search(rid, nprobe=nlist).values():
            _assert_exact(rows, x[:mid], ids[:mid], q)
        coord.merge_region(rid, child)
        _wait(lambda: (beat(1) or True) and all(
            nd.get_region(child) is None for nd in nodes.values()),
            "the child merged away")
        assert child not in coord.regions
        for stage in ("sibling", "rebuilt"):
            l3 = b3.launches
            got = search(rid, nprobe=nlist)
            assert b3.launches >= l3 + 3, stage
            for s, rows in got.items():
                w = nodes[s].get_region(rid).vector_index_wrapper
                assert (w.sibling_index is not None) == (stage == "sibling")
                _assert_exact(rows, x, ids, q)
            if stage == "sibling":
                for nd in nodes.values():
                    nd.finish_merge_index(rid)
    finally:
        for nd in nodes.values():
            nd.stop()


# ---------------- the binary family, range search and DiskANN -------------

def _packed(n, nbytes, seed, protos=64):
    """Clustered packed rows: prototypes with a few bytes flipped."""
    g = np.random.default_rng(seed)
    base = g.integers(0, 256, (protos, nbytes), dtype=np.uint8)
    x = base[g.integers(0, protos, n)]
    flip = g.integers(0, nbytes, (n, 4))
    x[np.arange(n)[:, None], flip] ^= g.integers(
        1, 256, (n, 4)).astype(np.uint8)
    return x


def _hamming(q, x):
    return np.unpackbits(q[:, None, :] ^ x[None, :, :], axis=-1).sum(-1)


def _assert_exact_hamming(res, q, x, ids, k):
    """Distances equal the exact top-k's and every id's exact distance
    (ids modulo ties)."""
    pos = {int(v): i for i, v in enumerate(ids)}
    hd = _hamming(q, x)
    for qi, r in enumerate(res):
        want = np.sort(hd[qi])[:k]
        np.testing.assert_array_equal(r.distances, want)
        got = hd[qi, [pos[int(i)] for i in r.ids]]
        np.testing.assert_array_equal(r.distances, got)


def test_pm1_product_exact_on_device():
    """The int8 product (torch._int_mm) on the card is exact at 768 and
    1024 bits for 1, 17 and 64 query rows, and a ragged row count."""
    from dingo_tpu_torch.ops.distance import _dot, pairwise_hamming

    dev = _cuda()
    g = np.random.default_rng(1)
    for d, n in ((768, 4096), (1024, 1000)):
        x = (g.integers(0, 2, (n, d)) * 2 - 1).astype(np.int8)
        for b in (1, 17, 64):
            q = (g.integers(0, 2, (b, d)) * 2 - 1).astype(np.float32)
            got = _dot(torch.from_numpy(q).to(dev),
                       torch.from_numpy(x).to(dev)).cpu().numpy()
            want = q.astype(np.int64) @ x.astype(np.int64).T
            np.testing.assert_array_equal(got, want)
    qp, xp = _packed(5, 96, 2), _packed(333, 96, 3)
    got = pairwise_hamming(torch.from_numpy(qp).to(dev),
                           torch.from_numpy(xp).to(dev), 768).cpu().numpy()
    np.testing.assert_array_equal(got, _hamming(qp, xp))


def test_binary_indexes_serve_exact_hamming_on_device():
    """BINARY_FLAT and BINARY_IVF_FLAT at 768 bits on the card: exact
    hamming top-10 (full probe on IVF), range search equal to the exact
    set, writes visible, and only the plain arms launched (no B1-B5)."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.flat import flat_search_plain
    from dingo_tpu_torch.index.ivf_flat import ivf_scan_scores
    from dingo_tpu_torch.ops import (kernel_ivf, kernel_ivf_pruned,
                                     kernel_pq, kernel_topk,
                                     kernel_topk_pruned)
    from dingo_tpu_torch.ops.distance import Metric

    dev = _cuda()
    n = 20000
    x = _packed(n, 96, 4)
    ids = np.arange(n, dtype=np.int64)
    q = x[:64].copy()
    q[:, 5] ^= 0x11
    kernels = (kernel_topk.fused_topk, kernel_ivf.ivf_list_topk,
               kernel_ivf_pruned.ivf_pruned_topk,
               kernel_topk_pruned.pruned_fused_topk,
               kernel_pq.ivf_pq_adc_topk)
    before = [kf.launches for kf in kernels]
    flat = new_index(1, IndexParameter(index_type=IndexType.BINARY_FLAT,
                                       dimension=768, metric=Metric.HAMMING))
    ivf = new_index(2, IndexParameter(
        index_type=IndexType.BINARY_IVF_FLAT, dimension=768,
        metric=Metric.HAMMING, ncentroids=32, default_nprobe=32))
    assert flat.device == dev and flat.store.vecs.is_cuda
    for idx in (flat, ivf):
        idx.add(ids, x)
    ivf.train()
    f0, i0 = flat_search_plain.calls, ivf_scan_scores.calls
    _assert_exact_hamming(flat.search(q, 10), q, x, ids, 10)
    _assert_exact_hamming(ivf.search(q, 10, nprobe=32), q, x, ids, 10)
    assert flat_search_plain.calls == f0 + 1
    assert ivf_scan_scores.calls == i0 + 1
    hd = _hamming(q[:2], x)
    radius = float(np.sort(hd[0])[40])
    for idx in (flat, ivf):
        r = idx.range_search(q[:2], radius)
        assert set(r[0].ids.tolist()) == set(ids[hd[0] <= radius].tolist())
    new_rows = _packed(100, 96, 5)
    for idx in (flat, ivf):
        idx.upsert(ids[:100], new_rows)
        idx.delete(ids[100:200])
    x2 = x.copy()
    x2[:100] = new_rows
    keep = np.ones(n, bool)
    keep[100:200] = False
    q2 = np.concatenate([new_rows[:4], x[150:152]])
    for idx, kw in ((flat, {}), (ivf, {"nprobe": 32})):
        res = idx.search(q2, 10, **kw)
        _assert_exact_hamming(res, q2, x2[keep], ids[keep], 10)
    assert [kf.launches for kf in kernels] == before


def test_binary_region_serves_through_the_reader_on_device():
    """A BINARY_IVF_FLAT region on a MonoStoreNode: untrained, the
    reader's brute force over a temporary binary FLAT on the card; after
    the manager's rebuild, the index; both exact at full probe."""
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.ops.distance import Metric
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    _cuda()
    n = 6000
    x = _packed(n, 96, 6)
    ids = np.arange(n, dtype=np.int64)
    node = MonoStoreNode()
    try:
        region = node.create_region(RegionDefinition(
            region_id=4, start_key=vcodec.encode_vector_key(1, 0),
            end_key=vcodec.encode_vector_key(1, 1 << 40), partition_id=1,
            region_type=RegionType.INDEX, index_parameter=IndexParameter(
                index_type=IndexType.BINARY_IVF_FLAT, dimension=768,
                metric=Metric.HAMMING, ncentroids=16, default_nprobe=16)))
        for lo in range(0, n, 2000):
            node.storage.vector_add(region, ids[lo:lo + 2000],
                                    x[lo:lo + 2000])
        q = x[:8].copy()
        q[:, 0] ^= 3

        class R:
            def __init__(self, row):
                self.ids = np.asarray([v.id for v in row])
                self.distances = np.asarray([v.distance for v in row],
                                            np.float32)

        for stage in ("brute force", "index"):
            if stage == "index":
                node.index_manager.rebuild(region)
            rows = node.storage.vector_batch_search(region, q, 10)
            _assert_exact_hamming([R(r) for r in rows], q, x, ids, 10)
    finally:
        node.stop()


def test_diskann_core_on_device(tmp_path):
    """DiskAnnCore on the card: push, build, load (codes on the device),
    a search whose distances equal the f64 distances of their ids, a
    restart that serves the same ids, and destroy removing the files."""
    import os

    from dingo_tpu_torch.diskann import CoreState, DiskAnnCore
    from dingo_tpu_torch.index.base import IndexParameter, IndexType

    _cuda()
    g = np.random.default_rng(7)
    n, d = 20000, 64
    centers = g.standard_normal((64, d)).astype(np.float32)
    x = (centers[g.integers(0, 64, n)]
         + 0.2 * g.standard_normal((n, d))).astype(np.float32)
    ids = np.arange(10, 10 + n, dtype=np.int64)
    param = IndexParameter(index_type=IndexType.DISKANN, dimension=d,
                           ncentroids=32, nsubvector=16, default_nprobe=8)
    path = str(tmp_path / "dk")
    core = DiskAnnCore(1, param, path)
    core.push_data(ids, x, has_more=False)
    core.build()
    core.load()
    assert core._codes.is_cuda and core._code_buckets.is_cuda
    q = x[:64] + 0.01
    res = core.search(q, 10, nprobe=8)
    d64 = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
           ** 2).sum(-1)
    gt = np.argsort(d64, axis=1)[:, :10]
    hits = 0
    for qi, (r_ids, r_d) in enumerate(res):
        np.testing.assert_allclose(r_d, d64[qi, r_ids - 10], rtol=RTOL,
                                   atol=ATOL)
        hits += len(set(r_ids.tolist()) & set((gt[qi] + 10).tolist()))
    assert hits / (64 * 10) >= 0.95
    core2 = DiskAnnCore(1, param, path)
    assert core2.count == n and core2.try_load()
    res2 = core2.search(q, 10, nprobe=8)
    assert [r[0].tolist() for r in res2] == [r[0].tolist() for r in res]
    core2.close()
    core.destroy()
    assert core.status() is CoreState.UNINIT and not os.path.exists(path)


@pytest.mark.parametrize("index_type", ["flat", "ivf_flat"])
def test_tier_ladder_round_trip_on_the_card(index_type):
    """The memory-tier ladder (index/tiering.py) on a one-replica store on
    the card, 16,384 x 128 rows through Storage: hbm -> hbm_sq8 ->
    host_sq8 -> mmap_sq8 and back. B4-sq8 (FLAT) or B3-sq8 (IVF_FLAT, the
    IVF crossover forced at d 128; 64-column dimension blocks, so that the
    blocked mirror exists) launches at hbm_sq8; the host rungs
    hold 0 device bytes and launch neither kernel; at every rung
    memory_allocated follows the serving index's device bytes (each
    replaced index freed: within a quarter of the fp32 index's bytes);
    the mmap file is removed on promotion; the ids after the round trip
    equal those before it modulo ties (each reply an exact top-10 at
    nprobe = nlist)."""
    import gc
    import os

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.coordinator.control import CoordinatorControl
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.tiering import TIERING, HostSqFlat
    from dingo_tpu_torch.ops import kernel_ivf_pruned, kernel_topk_pruned
    from dingo_tpu_torch.raft import LocalTransport
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionType

    _cuda()
    n, d, nlist = 16_384, 128, 16
    rng = np.random.default_rng(17)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:32] + np.float32(0.05) * rng.standard_normal(
        (32, d)).astype(np.float32)
    ids = np.arange(n)
    ivf = index_type == "ivf_flat"
    kern = (kernel_ivf_pruned.ivf_pruned_topk if ivf
            else kernel_topk_pruned.pruned_fused_topk)
    saved = {f: FLAGS.get(f) for f in ("use_pallas_ivf_search",
                                       "ivf_dim_block")}
    FLAGS.set("use_pallas_ivf_search", True)
    FLAGS.set("ivf_dim_block", 64)
    TIERING.reset()
    coord = CoordinatorControl(MemEngine(), replication=1)
    node = StoreNode("s0", LocalTransport(), coord, raft_kw={"seed": 0})
    try:
        kw = {"ncentroids": nlist, "default_nprobe": nlist} if ivf else {}
        dfn = coord.create_region(
            vcodec.encode_vector_key(0, 0), vcodec.encode_vector_key(1),
            region_type=RegionType.INDEX, index_parameter=IndexParameter(
                index_type=IndexType(index_type), dimension=d, **kw))
        rid = dfn.region_id
        node.heartbeat_once()
        _leader_of({"s0": node}, rid)
        region = node.get_region(rid)
        for lo in range(0, n, 4096):
            node.storage.vector_add(region, ids[lo:lo + 4096], x[lo:lo + 4096])
        if ivf:
            node.index_manager.rebuild(
                region, raft_log=node.engine.get_node(rid).log)
        search_kw = {"nprobe": nlist} if ivf else {}

        def search():
            return node.storage.vector_batch_search(region, q, 10,
                                                    **search_kw)

        before = search()
        _assert_exact(before, x, ids, q)
        w = region.vector_index_wrapper
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        dbytes0 = w.get_device_memory_size()
        walk = []
        for kind, name in (("demote", "hbm_sq8"), ("demote", "host_sq8"),
                           ("demote", "mmap_sq8"), ("promote", "host_sq8"),
                           ("promote", "hbm_sq8"), ("promote", "hbm")):
            path = TIERING.state().get(rid, {}) and \
                TIERING._regions[rid].mmap_path
            assert getattr(TIERING, kind)(node, region)["ok"]
            l_sq8 = kern.launches_sq8
            rows = search()
            torch.cuda.synchronize()
            host = isinstance(w.own_index, HostSqFlat)
            walk.append((name, kern.launches_sq8 - l_sq8,
                         w.get_device_memory_size()))
            gc.collect()
            grown = torch.cuda.memory_allocated() - alloc0
            assert grown <= (w.get_device_memory_size() - dbytes0
                             + dbytes0 // 4), (name, grown, walk)
            if host:
                assert w.get_device_memory_size() == 0, name
                assert kern.launches_sq8 == l_sq8, name
            elif name == "hbm_sq8":
                assert kern.launches_sq8 > l_sq8, (name, walk)
            if kind == "promote" and name == "host_sq8":
                assert path and not os.path.exists(path)
        after = search()
        _assert_exact(after, x, ids, q)
        for a, b in zip(after, before):
            ia, ib = [v.id for v in a], [v.id for v in b]
            if ia != ib:          # ties only: the same sorted distances
                np.testing.assert_allclose(
                    sorted(v.distance for v in a),
                    sorted(v.distance for v in b), rtol=RTOL, atol=ATOL)
    finally:
        node.stop()
        TIERING.reset()
        for f, v in saved.items():
            FLAGS.set(f, v)
