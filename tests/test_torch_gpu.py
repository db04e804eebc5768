"""Kernel B1/B2 against their plain versions on the CUDA device, over the
edge cases the serving shapes do not reach: several query tiles, k up to
K_MAX, ragged row counts, masks, padded ranks, a dimension that is not a
multiple of 4 (the kernel's scalar-load path).

Marked ``gpu``: on a machine without a CUDA device each test skips (the
decision is made inside the test). Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerance: scores within rtol 1e-4, atol 1e-3 (f32 sums in another order);
slots equal modulo ties at that tolerance."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-4, 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_parity(kv, ki, pv, pi):
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    np.testing.assert_array_equal(np.isneginf(kv), np.isneginf(pv))
    fin = np.isfinite(pv)
    np.testing.assert_allclose(kv[fin], pv[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ki[~fin], -1)
    for r in range(kv.shape[0]):
        for c in np.flatnonzero(ki[r] != pi[r]):
            near = [kv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < kv.shape[1]]
            assert any(abs(kv[r, c] - v) <= ATOL for v in near), (r, c)


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


def test_ivf_index_serves_through_kernel_on_device():
    """An IVF_FLAT index on the device routes its search through B2 and
    agrees with the same index run on the CPU."""
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import kernel_ivf

    _cuda()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 256), dtype=np.float32)
    param = IndexParameter(index_type=IndexType.IVF_FLAT, dimension=256,
                           ncentroids=16)
    gpu = new_index(1, param)
    gpu.upsert(np.arange(5000), x)
    gpu.train()
    before = kernel_ivf.ivf_list_topk.launches
    res = gpu.search(x[:8], 10, nprobe=16)
    assert kernel_ivf.ivf_list_topk.launches == before + 1
    assert [int(r.ids[0]) for r in res] == list(range(8))
