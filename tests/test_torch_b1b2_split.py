"""Kernels B1 and B2's split-precision arithmetic, on the CPU.

The CUDA kernels (csrc/fused_topk.cu, csrc/ivf_topk.cu) multiply on the
tensor cores: f32 rows by 3xTF32, bf16 rows against a three-way bf16
split of the f32 query. ``ops/split_dot.py`` models both; these tests
hold the models' splits and products against f64, the top-k through them
against the plain versions (``fused_topk_plain``, ``ivf_list_topk_plain``)
and the JAX package's Pallas kernels in interpret mode, and B2's
per-(query, rank) candidates, built item by item from B3's work list
(items of 1-8 queries; a bucket probed by more than 8 queries makes two
items) and part by part of a bucket's 128-row tiles, merged, against
``ivf_list_topk_plain``. B1's rescore of its winners (an f32 FMA chain
over the columns in order) is held to the sequential-sum bound of f64.

Small shapes: d 32, 37 (not a multiple of 4) and 100 (not a multiple of
8), a few hundred rows, inputs from numpy seeds. Tolerances: the splits
exactly as stated (TF32 parts have 11 significant bits; hi + lo within
2^-21 |v|; the bf16 parts sum to the query exactly); a product within
(5 2^-22 + (d + 2) 2^-24) sum |q_i x_i| of f64 (the dropped q_lo.x_lo
term, the two truncated residuals, f32 accumulation); scores
within rtol 1e-4, atol 1e-3 (f32 sums in another order), ids equal modulo
ties at that tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.ops.pallas_ivf import ivf_list_topk as jax_b2
from dingo_tpu.ops.pallas_topk import fused_topk as jax_b1
from dingo_tpu_torch.ops.kernel_ivf import ivf_list_topk, ivf_list_topk_plain
from dingo_tpu_torch.ops.kernel_ivf_pruned import probe_items_plain
from dingo_tpu_torch.ops.kernel_topk import fused_topk, fused_topk_plain
from dingo_tpu_torch.ops.split_dot import (
    chain_dot,
    fused_topk_split,
    ivf_item_candidates,
    ivf_parts,
    merge_candidates,
    round_tf32,
    split_bf16x3_plain,
    split_dot,
    split_tf32_plain,
)

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
ARMS = ["f32", "bf16"]
DIMS = [32, 37, 100]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(x, arm):
    """(rows as the arm stores them, their f32 values)."""
    t = _t(x)
    if arm == "bf16":
        t = t.to(torch.bfloat16)
    return t, t.to(torch.float32)


def _jax_rows(rows):
    if rows.dtype == torch.bfloat16:
        return jnp.asarray(rows.to(torch.float32).numpy(), jnp.bfloat16)
    return jnp.asarray(rows.numpy())


def _corpus(seed, n, d, nq=8, ncl=12):
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


# -- the splits ----------------------------------------------------------------
def _rna_tf32_f64(v):
    """TF32 rounding (nearest, ties away) computed in f64: |v| / ulp is
    exact, and floor(y + 0.5) rounds a tie of a positive y up."""
    out = np.zeros_like(v, dtype=np.float64)
    nz = v != 0
    a = np.abs(v[nz].astype(np.float64))
    ulp = np.exp2(np.floor(np.log2(a)) - 10)
    out[nz] = np.sign(v[nz]) * np.floor(a / ulp + 0.5) * ulp
    return out


def test_round_tf32_is_cvt_rna():
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096))
         ).astype(np.float32)
    # exact ties (the low 13 bits 0x1000) go away from zero
    ties = (v.view(np.int32) & ~np.int32(0x1FFF)) | np.int32(0x1000)
    v = np.concatenate([v, ties.view(np.float32), [0.0, -0.0]]).astype(
        np.float32)
    got = round_tf32(_t(v)).numpy()
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(got.astype(np.float64), _rna_tf32_f64(v))
    tied = ties.view(np.float32)
    assert (np.abs(round_tf32(_t(tied)).numpy()) > np.abs(tied)).all()


def test_split_tf32_parts_and_residual():
    rng = np.random.default_rng(2)
    v = rng.standard_normal(8192).astype(np.float32) * 30.0
    hi, lo = (p.numpy() for p in split_tf32_plain(_t(v)))
    for p in (hi, lo):
        assert (p.view(np.int32) & 0x1FFF == 0).all()
    err = np.abs(v.astype(np.float64) - hi.astype(np.float64)
                 - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(v.astype(np.float64))).all()
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(v)).all()
    # lo is the exact residual with its low 13 bits cleared
    resid = v - hi
    np.testing.assert_array_equal(lo.view(np.int32),
                                  resid.view(np.int32) & ~np.int32(0x1FFF))


def test_split_bf16x3_sums_to_the_query_exactly():
    rng = np.random.default_rng(3)
    q = (rng.standard_normal(8192) * np.exp2(rng.integers(-8, 8, 8192))
         ).astype(np.float32)
    parts = split_bf16x3_plain(_t(q))
    for p in parts:          # each part is a bf16 value
        p = p.numpy()
        assert (p.view(np.int32) & 0xFFFF == 0).all()
    total = sum(p.numpy().astype(np.float64) for p in parts)
    np.testing.assert_array_equal(total, q.astype(np.float64))


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("d", DIMS)
def test_split_dot_within_its_bound_of_f64(arm, d):
    x, q, _ = _corpus(d, 300, d)
    rows, f32 = _rows(x, arm)
    got = split_dot(_t(q), rows).numpy().astype(np.float64)
    q64, x64 = q.astype(np.float64), f32.numpy().astype(np.float64)
    ref = q64 @ x64.T
    mag = np.abs(q64) @ np.abs(x64).T
    bound = (5 * 2.0 ** -22 + (d + 2) * 2.0 ** -24) * mag
    assert (np.abs(got - ref) <= bound).all()
    # and it is no coarser than twice an f32 product of the same rows
    plain = (_t(q) @ f32.T).numpy().astype(np.float64)
    assert np.abs(got - ref).max() <= 2 * np.abs(plain - ref).max() + 1e-6


# -- B1: top-k through the model ----------------------------------------------
@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("d", DIMS)
def test_fused_topk_split_matches_plain_and_jax(arm, d, ascending):
    n, k = 1024, 10
    x, q, rng = _corpus(d + 7, n, d)
    rows, f32 = _rows(x, arm)
    xsq = (f32 * f32).sum(1)
    valid = rng.random(n) < 0.9
    sv, si = fused_topk_split(_t(q), rows, xsq, _t(valid), k, ascending)
    pv, pi = fused_topk_plain(_t(q), rows, xsq, _t(valid), k, ascending)
    assert_topk_match(pv, pi, sv, si)
    # the wrapper on CPU tensors is the plain version
    wv, wi = fused_topk(_t(q), rows, xsq, _t(valid), k, ascending)
    assert torch.equal(wv, pv) and torch.equal(wi, pi)
    jv, ji = jax_b1(jnp.asarray(q), _jax_rows(rows), jnp.asarray(xsq.numpy()),
                    jnp.asarray(valid), k=k, block=512, ascending=ascending,
                    interpret=True)
    assert_topk_match(jv, ji, sv, si)


@pytest.mark.parametrize("arm", ARMS)
def test_chain_dot_within_the_sequential_bound_of_f64(arm):
    """B1's rescore model: an f32 FMA chain over d columns errs at most
    d 2^-24 sum |q_i x_i| (the bound of a sequential f32 sum)."""
    d = 100
    x, q, _ = _corpus(17, 64, d, nq=64)
    rows, f32 = _rows(x, arm)
    got = chain_dot(_t(q), rows).numpy().astype(np.float64)
    q64, x64 = q.astype(np.float64), f32.numpy().astype(np.float64)
    ref = (q64 * x64).sum(1)
    bound = d * 2.0 ** -24 * (np.abs(q64) * np.abs(x64)).sum(1)
    assert (np.abs(got - ref) <= bound).all()


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("arm", ARMS)
def test_fused_topk_split_returns_chain_scores_sorted(arm, ascending):
    """B1 ranks by the split products and returns each winner's f32 chain
    score, sorted: the values are chain_dot's at the returned slots."""
    n, d, k = 500, 37, 16
    x, q, rng = _corpus(23, n, d)
    rows, f32 = _rows(x, arm)
    xsq = (f32 * f32).sum(1)
    valid = torch.from_numpy(rng.random(n) < 0.9)
    sv, si = fused_topk_split(_t(q), rows, xsq, valid, k, ascending)
    q32 = _t(q)
    dots = chain_dot(q32.repeat_interleave(k, 0),
                     rows[si.reshape(-1).long()]).reshape(-1, k)
    want = (-(((q32 * q32).sum(1)[:, None] - 2.0 * dots) + xsq[si.long()])
            if ascending else dots)
    assert torch.equal(sv, want)
    assert (sv[:, :-1] >= sv[:, 1:]).all()
    assert bool(valid[si.long()].all())


def test_fused_topk_split_all_invalid_and_k_64():
    x, q, _ = _corpus(5, 200, 37)
    rows, f32 = _rows(x, "f32")
    xsq = (f32 * f32).sum(1)
    none = torch.zeros(200, dtype=torch.bool)
    v, i = fused_topk_split(_t(q), rows, xsq, none, 64)
    assert torch.isneginf(v).all() and (i == -1).all()
    some = torch.zeros(200, dtype=torch.bool)
    some[[3, 50, 199]] = True
    v, i = fused_topk_split(_t(q), rows, xsq, some, 64)
    pv, pi = fused_topk_plain(_t(q), rows, xsq, some, 64)
    assert_topk_match(pv, pi, v, i)
    assert (i[:, 3:] == -1).all()


# -- B2: per-pair candidates from the work list ----------------------------------
def _ivf_case(seed, d, arm, b=16, budget=5, nb=20, cap=40, hot=11):
    """Buckets [nb, cap, d] with invalid rows; the first `hot` queries
    probe bucket 3 at rank 0 (more than 8: two items) and no query probes
    it elsewhere; distinct buckets per query, some padded ranks and a
    query that probes nothing."""
    x, q, rng = _corpus(seed, nb * cap, d, nq=b)
    rows, f32 = _rows(x, arm)
    rows = rows.reshape(nb, cap, d)
    f32 = f32.reshape(nb, cap, d)
    others = np.asarray([v for v in range(nb) if v != 3])
    vp = np.stack([rng.permutation(others)[:budget] for _ in range(b)])
    vp[:hot, 0] = 3
    vp[2, 3:] = -1
    vp[13] = -1
    valid = rng.random((nb, cap)) < 0.85
    slot = rng.permutation(nb * cap).reshape(nb, cap).astype(np.int32)
    return {"vp": _t(vp.astype(np.int32)), "q": _t(q), "rows": rows,
            "sq": (f32 * f32).sum(-1), "valid": _t(valid), "slot": _t(slot),
            "nb": nb}


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("d", DIMS)
def test_ivf_item_candidates_merge_to_plain_and_jax(arm, d, ascending):
    k = 12
    c = _ivf_case(d, d, arm)
    pairs, items, n_items = probe_items_plain(c["vp"], c["nb"])
    counts = items[:n_items, 2].tolist()
    hot = [it for it in items[:n_items].tolist() if it[0] == 3]
    assert sorted(x[2] for x in hot) == [3, 8]      # 11 queries: two items
    assert min(counts) >= 1 and max(counts) == 8
    args = (c["vp"], c["q"], c["rows"], c["sq"], c["valid"], c["slot"], k,
            ascending)
    cv, ci = ivf_item_candidates(*args)
    assert torch.isneginf(cv[13]).all() and (ci[13] == -1).all()
    assert torch.isneginf(cv[2, 3:]).all()
    mv, mi = merge_candidates(cv, ci, k)
    pv, pi = ivf_list_topk_plain(*args)
    assert_topk_match(pv, pi, mv, mi)
    wv, wi = ivf_list_topk(*args)
    assert torch.equal(wv, pv) and torch.equal(wi, pi)
    jv, ji = jax_b2(jnp.asarray(c["vp"].numpy()), jnp.asarray(c["q"].numpy()),
                    _jax_rows(c["rows"]), jnp.asarray(c["sq"].numpy()),
                    jnp.asarray(c["valid"].numpy()),
                    jnp.asarray(c["slot"].numpy()), k=k, ascending=ascending,
                    interpret=True, nq=16)
    assert_topk_match(jv, ji, mv, mi)


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("arm", ARMS)
def test_ivf_item_candidates_in_two_parts(arm, ascending):
    """cap 300 is three 128-row tiles: B2 scans each item in two parts,
    tiles 0-1 and tile 2, each pair keeping k candidates a part; merged,
    they are ivf_list_topk_plain's."""
    k = 10
    c = _ivf_case(41, 37, arm, budget=4, nb=10, cap=300, hot=9)
    args = (c["vp"], c["q"], c["rows"], c["sq"], c["valid"], c["slot"], k,
            ascending)
    cv, ci = ivf_item_candidates(*args)
    assert ivf_parts(300) == 2 and cv.shape == (16, 4, 2, k)
    # part 1 holds rows 256-299 only
    slot = c["slot"].numpy()
    late = set(slot[:, 256:].ravel().tolist())
    got = ci[:, :, 1][ci[:, :, 1] >= 0].tolist()
    assert got and set(got) <= late
    mv, mi = merge_candidates(cv, ci, k)
    pv, pi = ivf_list_topk_plain(*args)
    assert_topk_match(pv, pi, mv, mi)


@pytest.mark.parametrize("arm", ARMS)
def test_ivf_pair_candidates_do_not_depend_on_the_item(arm):
    """Query 0 alone, or sharing each of its buckets with other queries
    in items of every size: its candidates are the same bits."""
    c = _ivf_case(9, 37, arm)
    args = (c["q"], c["rows"], c["sq"], c["valid"], c["slot"], 10)
    shared_v, shared_i = ivf_item_candidates(c["vp"], *args)
    alone = c["vp"].clone()
    alone[1:] = -1
    alone_v, alone_i = ivf_item_candidates(alone, *args)
    assert torch.equal(shared_v[0], alone_v[0])
    assert torch.equal(shared_i[0], alone_i[0])
    # the same pairs cut into items of one query each
    one_v, one_i = ivf_item_candidates(c["vp"], *args, qt=1)
    assert torch.equal(one_v, shared_v) and torch.equal(one_i, shared_i)
