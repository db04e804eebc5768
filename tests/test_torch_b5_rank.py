"""Kernel B5's per-rank design (one CTA per (query, coarse rank), a
block-wide selection) and the residual tables it reads, held on the CPU.

- ``rank_select_plain`` models B5's selection step by step (a running list
  of the best 64 and its k-th best, the rows above it joining the list,
  the best 64 of the union kept by the order-preserving uint32 image of
  the scores). It must equal ``torch.topk`` over every row on random
  scores with ties, -inf and fewer valid rows than k, at k in {1, 10, 60,
  64} (hypothesis, derandomized).
- ``ivf_pq_adc_topk_plain`` (the contract B5 is held to on the card) and
  ``rank_lists_plain`` then ``merge_lists_plain`` (the kernel's two
  passes) must
  equal the JAX kernel in interpret mode on probe layouts with three or
  more spill buckets per rank, ranks cut by the budget, and coarse_pos
  given out of order.
- The table path (``ivfpq_adc_lut``, whose CPU tensors take
  ``ivfpq_adc_lut_plain``) must equal the JAX package's ``_ivfpq_adc_lut``
  at m in {4, 8, 16} and ksub in {16, 256}.

Tolerances: the selection is exact (scores equal bit for bit, ids equal
modulo exact score ties); B5 against JAX within rtol 1e-4, atol 1e-3 and
ids modulo ties (f32 sums in another order: a gather and a sum here, a
one-hot matmul there; ADC distances reach ~100); the f32 tables within
rtol 1e-5, atol 1e-4. Small sizes: d <= 64, a few queries and buckets.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dingo_tpu.index.ivf_pq import _ivfpq_adc_lut as jax_adc_lut_all
from dingo_tpu.ops.pallas_pq import ivf_pq_adc_topk as jax_adc_topk
from dingo_tpu_torch.index.ivf_layout import expand_probes_ranked
from dingo_tpu_torch.ops import kernel_pq

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
OPS_RTOL, OPS_ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_topk_match(jv, ji, tv, ti, rtol=RTOL, atol=ATOL):
    """Scores equal within tolerance, -inf where the other has -inf; ids
    equal except where the score at that position is tied (within atol)
    with a neighbouring position."""
    jv, ji, tv, ti = (np.asarray(a) for a in (jv, ji, tv, ti))
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    np.testing.assert_array_equal(ti[np.isneginf(tv)], -1)
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=rtol, atol=atol)
    for r in range(jv.shape[0]):
        for c in np.flatnonzero(ji[r] != ti[r]):
            near = [tv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < tv.shape[1]]
            assert any(abs(tv[r, c] - v) <= atol for v in near), (r, c)


# -- (a) the selection against torch.topk -----------------------------------
def test_score_keys_preserve_order():
    vals = np.array([-np.inf, -3e38, -1.5, -1e-30, -0.0, 0.0, 1e-30, 2.5,
                     3e38, np.inf, np.nan], np.float32)
    keys = kernel_pq.score_keys(_t(vals)).numpy()
    assert keys[0] == 0 and keys[-1] == 0          # -inf and NaN: empty
    fin = keys[1:-1]
    assert (fin > 0).all() and (np.diff(fin) >= 0).all()
    assert keys[4] + 1 == keys[5]                  # -0.0 just below +0.0
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4000).astype(np.float32) * 50
    kx = kernel_pq.score_keys(_t(x)).numpy()
    assert (np.argsort(kx, kind="stable")
            == np.argsort(x, kind="stable")).all()


@st.composite
def _score_rows(draw, k):
    n = draw(st.integers(0, 3 * kernel_pq.SEG))
    pool = draw(st.sampled_from(["ties", "spread"]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    if pool == "ties":     # a few distinct values: ties at every rank
        scores = rng.integers(-6, 1, n).astype(np.float32) * 0.5
    else:
        scores = (-50.0 * rng.random(n)).astype(np.float32)
    dead = rng.random(n) < draw(st.sampled_from([0.0, 0.3, 0.97]))
    scores[dead] = -np.inf
    # split into the kernel's steps: SEG rows, or fewer at a bucket's end
    cuts = sorted(set(rng.integers(0, n + 1, draw(st.integers(0, 4)))))
    bounds, lo = [], 0
    for c in cuts + [n]:
        for s in range(lo, c, kernel_pq.SEG):
            bounds.append((s, min(c, s + kernel_pq.SEG)))
        lo = c
    return scores, bounds


@pytest.mark.parametrize("k", [1, 10, 60, 64])
def test_rank_select_plain_equals_topk(k):
    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(_score_rows(k))
    def check(case):
        scores, bounds = case
        slots = np.arange(len(scores), dtype=np.int64) * 3 + 7
        steps = [(_t(scores[a:b]), _t(slots[a:b])) for a, b in bounds]
        v, s = kernel_pq.rank_select_plain(steps, k)
        v, s = v.numpy(), s.numpy()
        full = np.concatenate([scores, np.full(k, -np.inf, np.float32)])
        want, _ = torch.topk(_t(full), k)
        np.testing.assert_array_equal(v, want.numpy())   # bit for bit
        valid = np.isfinite(v)
        assert (s[~valid] == -1).all()
        got = s[valid]
        assert len(set(got.tolist())) == len(got)          # no repeats
        by_slot = dict(zip(slots.tolist(), scores.tolist()))
        assert [by_slot[i] for i in got.tolist()] == v[valid].tolist()

    check()


def test_rank_select_plain_keeps_a_full_list_across_steps():
    """A later step's rows enter only above the running k-th best; a step
    with none leaves the list as it was."""
    k = 4
    first = (_t(np.array([-5, -1, -3, -2, -4, -6], np.float32)),
             _t(np.arange(6)))
    below = (_t(np.array([-9, -7, -4], np.float32)), _t(np.arange(6, 9)))
    above = (_t(np.array([-0.5, -8], np.float32)), _t(np.arange(9, 11)))
    v, s = kernel_pq.rank_select_plain([first, below, above], k)
    assert v.tolist() == [-0.5, -1, -2, -3]
    assert s.tolist() == [9, 1, 3, 2]


# -- (b) the contract and the kernel's two passes against JAX ---------------------
def _layout(seed, b, nprobe, nlist, max_spill, cap, m, ksub):
    """A probe layout from the port's expand_probes_ranked over a probe
    table in which most lists own max_spill (>= 3) buckets, so the budget
    cuts the last ranks' spill buckets; then each query's (vprobe,
    coarse_pos) pairs shuffled, so coarse_pos comes out of order."""
    rng = np.random.default_rng(seed)
    nspill = rng.integers(1, max_spill + 1, nlist)
    nspill[rng.random(nlist) < 0.7] = max_spill
    table = np.full((nlist, max_spill), -1, np.int32)
    nb = 0
    for lst in range(nlist):
        table[lst, :nspill[lst]] = np.arange(nb, nb + nspill[lst])
        nb += nspill[lst]
    probes = np.stack([rng.choice(nlist, nprobe, replace=False)
                       for _ in range(b)]).astype(np.int32)
    vprobes, coarse_pos = expand_probes_ranked(_t(probes), _t(table),
                                               nprobe, max_spill)
    vprobes, coarse_pos = vprobes.numpy().copy(), coarse_pos.numpy().copy()
    for q in range(b):
        perm = rng.permutation(vprobes.shape[1])
        vprobes[q], coarse_pos[q] = vprobes[q, perm], coarse_pos[q, perm]
    lut = (5.0 * rng.random((b, nprobe, m, ksub))).astype(np.float32)
    codes = rng.integers(0, ksub, (nb, cap, m)).astype(np.uint8)
    valid = rng.random((nb, cap)) < 0.8
    slot = rng.permutation(nb * cap).reshape(nb, cap).astype(np.int32)
    kept = (vprobes >= 0).sum(1)
    return vprobes, coarse_pos, lut, codes, valid, slot, nspill[probes].sum(
        1) - kept


@pytest.mark.parametrize("k,cap,m,ksub", [
    (10, 40, 8, 256),
    (60, 24, 4, 16),      # k above a rank's rows: -inf tails per rank
    (5, 600, 6, 32),      # cap over SEG: two selection steps per bucket
])
def test_b5_plain_and_ranked_passes_match_jax(k, cap, m, ksub):
    b, nprobe, nlist, max_spill = 4, 6, 9, 4
    vp, cp, lut, codes, valid, slot, cut = _layout(
        17 + k + cap, b, nprobe, nlist, max_spill, cap, m, ksub)
    assert cut.max() > 0                      # the budget cut spill buckets
    per_rank = [np.bincount(cp[q][vp[q] >= 0], minlength=nprobe)
                for q in range(b)]
    assert max(c.max() for c in per_rank) >= 3      # 3+ spill buckets
    assert any((np.diff(cp[q]) < 0).any() for q in range(b))   # unsorted
    vp[1, :] = -1                             # a query that probes nothing
    jv, ji = jax_adc_topk(jnp.asarray(vp), jnp.asarray(cp), jnp.asarray(lut),
                          jnp.asarray(codes), jnp.asarray(valid),
                          jnp.asarray(slot), k=k, interpret=True)
    args = [_t(a) for a in (vp, cp, lut, codes, valid, slot)]
    tv, ti = kernel_pq.ivf_pq_adc_topk(*args, k)
    assert_topk_match(jv, ji, tv.numpy(), ti.numpy())
    rv, ri = kernel_pq.rank_lists_plain(*args, k)
    assert rv.shape == (b, nprobe, k)
    assert (ri[1] == -1).all() and torch.isneginf(rv[1]).all()
    mv, mi = kernel_pq.merge_lists_plain(rv, ri, k)
    assert_topk_match(jv, ji, mv.numpy(), mi.numpy())


# -- (c) the residual tables against JAX ------------------------------------------
@pytest.mark.parametrize("ksub", [16, 256])
@pytest.mark.parametrize("m", [4, 8, 16])
def test_adc_lut_matches_jax(m, ksub):
    rng = np.random.default_rng(60 + m + ksub)
    b, d, nlist, nprobe = 5, 64, 12, 6
    q = rng.standard_normal((b, d), dtype=np.float32)
    cent = rng.standard_normal((nlist, d), dtype=np.float32)
    cb = rng.standard_normal((m, ksub, d // m), dtype=np.float32)
    probes = np.stack([rng.choice(nlist, nprobe, replace=False)
                       for _ in range(b)]).astype(np.int32)
    jl = np.asarray(jax_adc_lut_all(jnp.asarray(q), jnp.asarray(cent),
                                    jnp.asarray(probes), jnp.asarray(cb)))
    before = kernel_pq.ivfpq_adc_lut.launches
    tl = kernel_pq.ivfpq_adc_lut(_t(q), _t(cent), _t(probes), _t(cb))
    assert kernel_pq.ivfpq_adc_lut.launches == before    # CPU: plain
    assert tl.is_contiguous() and tl.shape == (b, nprobe, m, ksub)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=OPS_RTOL, atol=OPS_ATOL)
