"""Port parity: dingo_tpu_torch ops against their dingo_tpu counterparts.

Inputs are made with numpy from a seed and go through both packages. JAX
kernels run as the JAX package's own tests run them on the CPU
(interpret mode); the port's kernel wrappers take their plain versions
because the tensors lie on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.index.ivf_layout import MutableIvfView as JaxView
from dingo_tpu.index.ivf_layout import expand_probes as jax_expand
from dingo_tpu.ops import distance as jd
from dingo_tpu.ops import kmeans as jk
from dingo_tpu.ops import topk as jt
from dingo_tpu.ops.pallas_ivf import _pad_rows as jax_pad_rows
from dingo_tpu.ops.pallas_ivf import ivf_list_search as jax_ivf_search
from dingo_tpu.ops.pallas_topk import fused_search as jax_fused_search
from dingo_tpu_torch.ops import distance as td
from dingo_tpu_torch.ops import kmeans as tk
from dingo_tpu_torch.ops import topk as tt
from dingo_tpu_torch.ops.kernel_ivf import _pad_rows, ivf_list_topk
from dingo_tpu_torch.ops.kernel_topk import fused_topk

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

#: f32 sums land in another order in the two packages (XLA vs torch CPU)
RTOL, ATOL = 1e-4, 1e-4

METRICS = [("l2", jd.Metric.L2, td.Metric.L2),
           ("ip", jd.Metric.INNER_PRODUCT, td.Metric.INNER_PRODUCT),
           ("cosine", jd.Metric.COSINE, td.Metric.COSINE)]


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_topk_match(jv, ji, tv, ti, rtol=RTOL, atol=ATOL):
    """Scores equal within tolerance; ids equal except where the score at
    that position is tied (within atol) with a neighbouring position —
    the two packages order exact ties differently."""
    jv, ji, tv, ti = (np.asarray(a) for a in (jv, ji, tv, ti))
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    for r in range(jv.shape[0]):
        for c in np.flatnonzero(ji[r] != ti[r]):
            near = [tv[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < tv.shape[1]]
            assert any(abs(tv[r, c] - v) <= atol for v in near), (r, c)


# -- (a) distance and top-k ----------------------------------------------------
@pytest.mark.parametrize("name,jm,tm", METRICS, ids=[m[0] for m in METRICS])
def test_score_matrix_matches_jax(name, jm, tm):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((6, 24), dtype=np.float32)
    x = rng.standard_normal((300, 24), dtype=np.float32)
    xsq = (x * x).sum(1)
    want = np.asarray(jd.score_matrix(jnp.asarray(q), jnp.asarray(x), jm,
                                      x_sqnorm=jnp.asarray(xsq)))
    got = td.score_matrix(_t(q), _t(x), tm, x_sqnorm=_t(xsq)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        td.scores_to_distances(_t(got), tm).numpy(),
        np.asarray(jd.scores_to_distances(jnp.asarray(got), jm)))
    assert td.metric_ascending(tm) == jd.metric_ascending(jm)


PAIRWISE = [("l2", "pairwise_l2sqr"), ("ip", "pairwise_inner_product"),
            ("cosine", "pairwise_cosine")]


@pytest.mark.parametrize("name,fn", PAIRWISE, ids=[m[0] for m in PAIRWISE])
def test_pairwise_matches_jax(name, fn):
    """The three pairwise matrices UtilService.VectorCalcDistance serves,
    f32, against the JAX package's within rtol 1e-5 (atol 1e-5 for the
    entries near 0 of IP and cosine)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((7, 24), dtype=np.float32)
    x = rng.standard_normal((40, 24), dtype=np.float32)
    want = np.asarray(getattr(jd, fn)(jnp.asarray(q), jnp.asarray(x)))
    got = getattr(td, fn)(_t(q), _t(x))
    assert got.dtype == torch.float32 and got.shape == (7, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if name == "cosine":
        xn = td.normalize(_t(x))
        np.testing.assert_allclose(
            td.pairwise_cosine(_t(q), xn, x_is_normalized=True).numpy(),
            want, rtol=1e-5, atol=1e-5)


def test_norms_and_normalize_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, 16), dtype=np.float32)
    x[3] = 0.0   # the squared-norm floor path
    np.testing.assert_allclose(td.squared_norms(_t(x)).numpy(),
                               np.asarray(jd.squared_norms(jnp.asarray(x))),
                               rtol=1e-6)
    # same host function, same bits
    np.testing.assert_array_equal(td.np_normalize(x), jd.np_normalize(x))
    np.testing.assert_allclose(td.normalize(_t(x)).numpy(),
                               np.asarray(jd.normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [5, 40])
def test_topk_scores_matches_jax(k):
    """Masked top-k, including k > n (pads with -inf / -1)."""
    rng = np.random.default_rng(3)
    s = rng.standard_normal((4, 30), dtype=np.float32)
    valid = rng.random(30) > 0.3
    ids = np.arange(100, 130, dtype=np.int32)
    jv, ji = jt.topk_scores(jnp.asarray(s), k, valid=jnp.asarray(valid),
                            ids=jnp.asarray(ids))
    tv, ti = tt.topk_scores(_t(s), k, valid=_t(valid), ids=_t(ids))
    assert_topk_match(jv, ji, tv.numpy(), ti.numpy())
    assert (ti.numpy()[np.isneginf(tv.numpy())] == -1).all()


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(4)
    a = -np.sort(-rng.standard_normal((3, 5), dtype=np.float32), axis=1)
    b = -np.sort(-rng.standard_normal((3, 5), dtype=np.float32), axis=1)
    a[0, 3:] = -np.inf
    ia = rng.integers(0, 99, (3, 5)).astype(np.int32)
    ib = rng.integers(100, 199, (3, 5)).astype(np.int32)
    jv, ji = jt.merge_topk(jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b),
                           jnp.asarray(ib), 6)
    tv, ti = tt.merge_topk(_t(a), _t(ia), _t(b), _t(ib), 6)
    assert_topk_match(jv, ji, tv.numpy(), ti.numpy())


def test_host_fetch_passes_cpu_tensors_and_drops_none():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = tt.begin_host_fetch(a, None, torch.tensor([1, 2])).get()
    assert len(got) == 2 and isinstance(got[0], np.ndarray)
    np.testing.assert_array_equal(got[0], a.numpy())


# -- (b) B1 plain version against the JAX kernel in interpret mode -------------
@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("n,k,masked", [
    (2048, 10, False),      # n a multiple of the block
    (3000, 7, True),        # n padded to the block, with a mask
    (1500, 16, True),       # padded, bigger k
])
def test_fused_topk_plain_matches_jax(ascending, n, k, masked):
    rng = np.random.default_rng(5)
    d = 32
    x = rng.standard_normal((n, d), dtype=np.float32)
    q = x[:8] + 0.05 * rng.standard_normal((8, d), dtype=np.float32)
    xsq = (x * x).sum(1)
    valid = (rng.random(n) > 0.25) if masked else np.ones(n, bool)
    jv, ji = jax_fused_search(q, jnp.asarray(x), jnp.asarray(xsq),
                              jnp.asarray(valid), k, block=1024,
                              ascending=ascending)
    tv, ti = fused_topk(_t(q), _t(x), _t(xsq), _t(valid), k,
                        ascending=ascending)
    # distances here reach ~100: 1e-5 relative f32 error is ~1e-3 absolute
    assert_topk_match(jv, ji, tv.numpy(), ti.numpy(), rtol=1e-4, atol=1e-3)


def test_fused_topk_fewer_valid_than_k_gives_minus_one():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1024, 16), dtype=np.float32)
    valid = np.zeros(1024, bool)
    valid[[3, 500, 900]] = True
    xsq = (x * x).sum(1)
    jv, ji = jax_fused_search(x[:4], jnp.asarray(x), jnp.asarray(xsq),
                              jnp.asarray(valid), 5, block=512)
    tv, ti = fused_topk(_t(x[:4]), _t(x), _t(xsq), _t(valid), 5)
    ti = ti.numpy()
    assert (ti[:, 3:] == -1).all() and (np.asarray(ji)[:, 3:] == -1).all()
    assert np.isneginf(tv.numpy()[:, 3:]).all()
    assert_topk_match(np.asarray(jv)[:, :3], np.asarray(ji)[:, :3],
                      tv.numpy()[:, :3], ti[:, :3], atol=1e-3)


# -- (c) B2 plain version against the JAX kernel on a real MutableIvfView ------
@pytest.fixture(scope="module")
def ivf_view():
    rng = np.random.default_rng(7)
    n, d, nlist = 2000, 16, 8
    x = rng.standard_normal((n, d), dtype=np.float32)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    assign[:700] = 2                        # a hot list that spills
    valid = np.ones(n, bool)
    valid[::9] = False                      # tombstoned slots
    view = JaxView.build(assign, valid, nlist, n, cap_hint=128)
    xsq = (x * x).sum(1)
    buckets = np.asarray(view.gather_rows(jnp.asarray(x)))
    bsq = np.asarray(view.gather_rows(jnp.asarray(xsq)))
    return x, view, buckets, bsq


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
def test_ivf_list_topk_plain_matches_jax(ivf_view, ascending):
    x, view, buckets, bsq = ivf_view
    rng = np.random.default_rng(8)
    nq, nprobe, k = 6, 3, 10
    q = x[:nq] + 0.05 * rng.standard_normal((nq, x.shape[1]),
                                            dtype=np.float32)
    probes = np.stack([rng.choice(8, nprobe, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    vprobes = np.asarray(jax_expand(jnp.asarray(probes), view.probe_table,
                                    nprobe, view.max_spill)).copy()
    assert view.max_spill > 1 and vprobes.shape[1] > nprobe
    vprobes[1, 1:] = -1                     # padded ranks are skipped
    vprobes[4, :] = -1                      # a query that probes nothing
    slot = np.asarray(view.bucket_slot)
    valid = np.asarray(view.bucket_valid)
    jv, ji = jax_ivf_search(jnp.asarray(vprobes), jnp.asarray(q),
                            jnp.asarray(buckets), jnp.asarray(bsq),
                            jnp.asarray(valid), jnp.asarray(slot), k=k,
                            ascending=ascending)
    tv, ti = ivf_list_topk(_t(vprobes), _t(q), _t(buckets), _t(bsq),
                           _t(valid), _t(slot), k, ascending=ascending)
    assert (ti.numpy()[4] == -1).all()
    assert_topk_match(jv, ji, tv.numpy(), ti.numpy(), rtol=1e-4, atol=1e-3)


def test_pad_rows_matches_jax():
    q = np.ones((5, 4), np.float32)
    vp = np.arange(10, dtype=np.int32).reshape(5, 2)
    jq, jvp = jax_pad_rows(jnp.asarray(q), jnp.asarray(vp))
    tq, tvp = _pad_rows(_t(q), _t(vp))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))


# -- (e) k-means ----------------------------------------------------------------
def _clusters(seed, n=3000, d=16, ncl=12, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.standard_normal((ncl, d), dtype=np.float32)
    lab = rng.integers(0, ncl, n)
    x = (centers[lab] + spread * rng.standard_normal(
        (n, d), dtype=np.float32)).astype(np.float32)
    return x, lab


def test_kmeans_fit_matches_jax_given_seeds():
    """Same seed indices -> centroids within 1e-4 (the update sums in
    another order: index_add_ vs a one-hot matmul). One seed per
    well-separated cluster, so no point sits near a tie between two
    centroids and the assignments agree exactly."""
    x, lab = _clusters(9)
    seeds = np.asarray([np.flatnonzero(lab == c)[0] for c in range(12)])
    jc, jn = jk.kmeans_fit(jnp.asarray(x), jnp.asarray(seeds, jnp.int32),
                           k=12, iters=5, chunk=1024)
    tc, tn = tk.kmeans_fit(_t(x), _t(seeds), k=12, iters=5, chunk=1024)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        tk.kmeans_assign(_t(x), tc, chunk=1024).numpy(),
        np.asarray(jk.kmeans_assign(jnp.asarray(x), jc, chunk=1024)))


def test_farthest_first_init_matches_jax():
    x, _ = _clusters(11, n=800)
    want = np.asarray(jk.farthest_first_init(jnp.asarray(x), jnp.int32(17),
                                             12))
    got = tk.farthest_first_init(_t(x), 17, 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_empty_cluster_jumps_to_farthest_point():
    """Two identical seeds leave one cluster empty; it must jump to the
    farthest point exactly as the JAX package does."""
    x, lab = _clusters(12, n=600, ncl=4)
    first = [int(np.flatnonzero(lab == c)[0]) for c in range(3)]
    seeds = np.array([first[0], first[0], first[1], first[2]], np.int64)
    jc, _ = jk.kmeans_fit(jnp.asarray(x), jnp.asarray(seeds, jnp.int32),
                          k=4, iters=1)
    tc, _ = tk.kmeans_fit(_t(x), _t(seeds), k=4, iters=1)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
