"""Kernels B1-B5 against their plain versions on the CUDA device, over
the edge cases the serving shapes do not reach: several query tiles, k up
to K_MAX, ragged row counts, masks, padded ranks, a dimension that is not
a multiple of 4 (the kernels' scalar-load path), dimension blocks that are
not a multiple of the SGEMM depth, both prune bounds and the in-bucket
refresh on and off; for B5, subspace counts that take each code-load width
and spill buckets that share a table.

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
        fused = idx.search(x[:8], 10, nprobe=8)
        assert kernel_pq.ivf_pq_adc_topk.launches == b5 + 1
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
        assert [r.ids.tolist() for r in hres] == \
            [r.ids.tolist() for r in fused]
    finally:
        _restore(saved)
    saved = _flags(use_pallas_ivf_search=False, ivfpq_rerank_factor=6)
    try:
        plain = idx.search(x[:8], 10, nprobe=8)
        assert ivf_pq._ivfpq_scan_kernel.calls == xla + 1
    finally:
        _restore(saved)
    assert [r.ids.tolist() for r in plain] == [r.ids.tolist() for r in fused]
    for a, b in zip(plain, fused):
        np.testing.assert_allclose(a.distances, b.distances, rtol=RTOL,
                                   atol=ATOL)
