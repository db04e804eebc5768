"""Kernel B3's bucket-major visiting order, on the CPU.

The CUDA kernel (csrc/ivf_pruned_topk.cu) takes a work list of items, a
probed bucket with up to QT of the queries that probe it, and visits them
rank-first with a per-query threshold shared across items.
``probe_items_plain`` defines that list; these tests hold its properties
against a reference written here, and show with the plain per-bucket step
(``scan_unit_plain``) that a walk in the items' order, each item's
queries starting from the k-th best their finished items published,
returns what the JAX kernel's order returns (``ivf_pruned_topk_plain``,
itself held against the JAX kernel in tests/test_torch_pruned.py).

Small shapes: d = 32, dblk = 8 (4 blocks), cap 24, 12 buckets. Tolerance:
scores within rtol 1e-5, atol 1e-4 (the walk multiplies a bucket's rows
by all its queries at once, the plain version query by query); ids equal
modulo ties at that tolerance; stats lanes 1 and 3 equal, 0 <= lane0 <=
lane1 and lane2 <= lane3 (the walk prunes with other thresholds)."""

import numpy as np
import pytest
import torch

from dingo_tpu_torch.ops import blocked
from dingo_tpu_torch.ops.kernel_ivf_pruned import (
    QT,
    _stable_topk,
    arm_query,
    arm_rows,
    ivf_pruned_topk,
    ivf_pruned_topk_plain,
    probe_items_plain,
    scan_unit_plain,
)
from dingo_tpu_torch.ops.sq import sq_encode, sq_train

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
NB, CAP, D, DBLK = 12, 24, 32, 8


def _vprobes(seed, b, budget, nb, hot=False, pad_rows=0):
    """Distinct buckets per query (as IVF probes are), -1 padded ranks,
    optionally one bucket every query probes at rank 0 and padded query
    rows that probe nothing."""
    rng = np.random.default_rng(seed)
    vp = np.stack([rng.permutation(nb)[:budget] for _ in range(b)])
    if hot:
        for q in range(b):
            row = [x for x in vp[q] if x != 3][:budget - 1]
            vp[q] = [3] + row
    cut = rng.integers(1, budget + 1, size=b)
    for q in range(b):
        vp[q, cut[q]:] = -1
    if pad_rows:
        vp[-pad_rows:] = -1
    return torch.from_numpy(vp.astype(np.int32))


def _items_reference(vp, nb, qt):
    """The work list from its definition, in plain Python."""
    b, budget = vp.shape
    by_bucket = {}
    for q in range(b):
        for r in range(budget):
            bkt = int(vp[q, r])
            if 0 <= bkt < nb:
                by_bucket.setdefault(bkt, []).append((r, q))
    pairs, items = [], []
    for bkt in sorted(by_bucket):
        lst = sorted(by_bucket[bkt])
        base = len(pairs)
        pairs += [q * budget + r for r, q in lst]
        for c0 in range(0, len(lst), qt):
            items.append((lst[c0][0], bkt, c0, base + c0,
                          min(qt, len(lst) - c0)))
    items.sort()
    return pairs, [(bkt, first, n) for _, bkt, _, first, n in items]


CASES = [(0, 16, 6, False, 0), (1, 16, 6, True, 0), (2, 24, 9, True, 3),
         (3, 5, 1, False, 1), (4, 64, 12, True, 0)]


@pytest.mark.parametrize("seed,b,budget,hot,pad", CASES)
def test_probe_items_match_their_definition(seed, b, budget, hot, pad):
    vp = _vprobes(seed, b, budget, NB, hot, pad)
    pairs, items, n_items = probe_items_plain(vp, NB)
    want_pairs, want_items = _items_reference(vp.numpy(), NB, QT)
    assert n_items == len(want_items)
    assert pairs[:len(want_pairs)].tolist() == want_pairs
    assert (pairs[len(want_pairs):] == -1).all()
    assert items[:n_items].tolist() == [list(t) for t in want_items]
    assert (items[n_items:] == -1).all()


@pytest.mark.parametrize("seed,b,budget,hot,pad", CASES)
def test_probe_items_cover_every_pair_once(seed, b, budget, hot, pad):
    vp = _vprobes(seed, b, budget, NB, hot, pad)
    pairs, items, n_items = probe_items_plain(vp, NB)
    seen = []
    first_ranks = []
    for bkt, first, n in items[:n_items].tolist():
        assert 1 <= n <= QT
        got = pairs[first:first + n].tolist()
        assert all(int(vp[p // budget, p % budget]) == bkt for p in got)
        seen += got
        first_ranks.append(got[0] % budget)
    valid = [q * budget + r for q in range(b) for r in range(budget)
             if 0 <= int(vp[q, r]) < NB]
    assert sorted(seen) == sorted(valid)
    assert len(seen) == len(set(seen))
    # rank-first: every item holding a rank-0 pair comes before the others
    assert first_ranks == sorted(first_ranks)
    n0 = sum(1 for p in valid if p % budget == 0)
    assert sum(1 for x in first_ranks if x == 0) >= -(-n0 // QT)
    if hot:
        # bucket 3 is probed by every live query: it splits into items
        hot_items = [t for t in items[:n_items].tolist() if t[0] == 3]
        live = int((vp[:, 0] >= 0).sum())
        assert len(hot_items) == -(-live // QT)


def _arrays(seed, tier):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, D)).astype(np.float32)
    raw = (centers[rng.integers(0, 6, NB * CAP)]
           + 0.3 * rng.standard_normal((NB * CAP, D))).astype(np.float32)
    kw = {}
    if tier == "bf16":
        rows = torch.from_numpy(raw).to(torch.bfloat16)
        f32 = rows.to(torch.float32)
    elif tier == "sq8":
        params = sq_train(raw)
        rows = torch.from_numpy(sq_encode(raw, params))
        kw = {"sq_vmin": torch.from_numpy(params.vmin),
              "sq_scale": torch.from_numpy(params.scale)}
        f32 = arm_rows(rows, 0, kw["sq_vmin"], kw["sq_scale"])
    else:
        rows = torch.from_numpy(raw)
        f32 = rows
    buckets = rows.reshape(NB, CAP, D)
    f32 = f32.reshape(NB, CAP, D)
    valid = torch.from_numpy(rng.random((NB, CAP)) < 0.8)
    valid[5] = False                        # an empty bucket
    valid[7] = torch.from_numpy(np.arange(CAP) < 2)   # a sparse one
    slot = torch.from_numpy(
        rng.permutation(NB * CAP).reshape(NB, CAP).astype(np.int32))
    q = torch.from_numpy(raw[rng.integers(0, NB * CAP, 16)]
                         + 0.05 * rng.standard_normal((16, D)).astype(
                             np.float32))
    return (buckets, blocked.bucket_block_sqnorms(f32, DBLK),
            (f32 * f32).sum(-1), valid, slot, q, kw)


def bucket_major_walk(vprobes, queries, qpsq, buckets, bucket_bsq,
                      bucket_sqnorm, bucket_valid, bucket_slot, k,
                      ascending, check_every, inbucket, sq_vmin=None,
                      sq_scale=None):
    """B3 in the kernel's visiting order: the items of probe_items_plain
    one after another, each scanned by scan_unit_plain for all its queries
    at once, its queries' pruning starting from the k-th best their
    finished items published; each (query, rank) keeps its item's k
    candidates, merged at the end."""
    b, budget = vprobes.shape
    nb, cap, d = buckets.shape
    nblk = qpsq.shape[1]
    dblk = d // nblk
    q32 = queries.to(torch.float32)
    qsq = (q32 * q32).sum(dim=1)
    qdot = arm_query(q32, buckets.dtype == torch.uint8)
    thr = torch.full((b,), float("-inf"))
    cand_v = torch.full((b, budget, k), float("-inf"))
    cand_i = torch.full((b, budget, k), -1, dtype=torch.int32)
    stats = torch.zeros((b, 4))
    pairs, items, n_items = probe_items_plain(vprobes, nb)
    for bkt, first, n in items[:n_items].tolist():
        pq = pairs[first:first + n].long()
        qs, rs = pq // budget, pq % budget
        st = torch.zeros((n, 4))
        rows = buckets[bkt:bkt + 1]
        bv, bi = scan_unit_plain(
            qdot[qs], qsq[qs], qpsq[qs],
            lambda jb: arm_rows(rows[:, :, jb * dblk:(jb + 1) * dblk],
                                jb * dblk, sq_vmin, sq_scale),
            bucket_bsq[bkt:bkt + 1], bucket_sqnorm[bkt:bkt + 1],
            bucket_valid[bkt].to(torch.float32).expand(n, cap),
            bucket_slot[bkt:bkt + 1],
            torch.full((n, k), float("-inf")),
            torch.full((n, k), -1, dtype=torch.int32), st, k, ascending,
            check_every, inbucket, init_thr=thr[qs])
        stats[qs] += st
        cand_v[qs, rs] = bv
        cand_i[qs, rs] = bi
        thr[qs] = torch.maximum(thr[qs], bv[:, k - 1])
    vals, ids = _stable_topk(cand_v.reshape(b, -1), cand_i.reshape(b, -1),
                             k)
    ids = torch.where(torch.isneginf(vals), torch.full_like(ids, -1), ids)
    return vals, ids, stats


def _assert_same(kv, ki, pv, pi):
    kv, ki, pv, pi = (t.numpy() for t in (kv, ki, pv, pi))
    np.testing.assert_array_equal(np.isneginf(kv), np.isneginf(pv))
    fin = np.isfinite(pv)
    np.testing.assert_allclose(kv[fin], pv[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ki[~fin], -1)
    for r in range(kv.shape[0]):
        for c in np.flatnonzero(ki[r] != pi[r]):
            near = [kv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < kv.shape[1]]
            assert any(abs(kv[r, c] - v) <= ATOL for v in near), (r, c)


@pytest.mark.parametrize("tier", ["fp32", "bf16", "sq8"])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("inbucket", [True, False])
def test_bucket_major_walk_is_exact(tier, ascending, inbucket):
    buckets, bsq, sqn, valid, slot, q, kw = _arrays(11, tier)
    vp = _vprobes(12, 16, 6, NB, hot=True, pad_rows=2)
    qpsq = blocked.query_prefix_sqnorms(q, DBLK)
    args = (vp, q, qpsq, buckets, bsq, sqn, valid, slot, 5, ascending, 1,
            inbucket)
    wv, wi, ws = bucket_major_walk(*args, **kw)
    pv, pi, ps = ivf_pruned_topk_plain(*args, **kw)
    _assert_same(wv, wi, pv, pi)
    np.testing.assert_array_equal(ws[:, 1], ps[:, 1])
    np.testing.assert_array_equal(ws[:, 3], ps[:, 3])
    assert (ws[:, 0] >= 0).all() and (ws[:, 0] <= ws[:, 1]).all()
    assert (ws[:, 2] >= 0).all() and (ws[:, 2] <= ws[:, 3]).all()
    assert (wi[-2:] == -1).all() and (ws[-2:] == 0).all()


@pytest.mark.parametrize("k,every,budget", [(1, 1, 6), (24, 2, 6),
                                            (5, 1, 1)])
def test_bucket_major_walk_edges(k, every, budget):
    """k 1, k over the rows of most buckets, a check every other block,
    and budget 1 (rank 0 only)."""
    buckets, bsq, sqn, valid, slot, q, kw = _arrays(13, "fp32")
    vp = _vprobes(14, 16, budget, NB, hot=budget > 1)
    qpsq = blocked.query_prefix_sqnorms(q, DBLK)
    args = (vp, q, qpsq, buckets, bsq, sqn, valid, slot, k, True, every,
            True)
    wv, wi, ws = bucket_major_walk(*args, **kw)
    pv, pi, ps = ivf_pruned_topk_plain(*args, **kw)
    _assert_same(wv, wi, pv, pi)
    np.testing.assert_array_equal(ws[:, 1], ps[:, 1])
    np.testing.assert_array_equal(ws[:, 3], ps[:, 3])


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version (the kernel runs
    only on CUDA tensors) and counts no launch."""
    buckets, bsq, sqn, valid, slot, q, kw = _arrays(15, "fp32")
    vp = _vprobes(16, 16, 6, NB)
    qpsq = blocked.query_prefix_sqnorms(q, DBLK)
    args = (vp, q, qpsq, buckets, bsq, sqn, valid, slot, 5)
    before = ivf_pruned_topk.launches
    got = ivf_pruned_topk(*args)
    want = ivf_pruned_topk_plain(*args)
    assert ivf_pruned_topk.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
