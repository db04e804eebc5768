"""The seed of kernel B4 (pruned_fused_topk) is exact: B4 starts each
query's prune threshold at the k-th best score over a strided sample of
slots (``seed_slots``), so the threshold is a score that k real rows
reach and pruning against it can drop no row of the true top k.

Held here through the plain version, which takes the same seed through
``init_thr`` (``seed_threshold_plain`` computes it with the plain
arithmetic): seeded and unseeded give the same scores and ids in every arm
(f32, bf16 rows, sq8 codes), for L2 and IP with the in-bucket refresh on
and off; stats lanes 1 and 3 are equal and the seeded lane 0 is no greater
for any query. The seeded f32 plain version is also held against the JAX
package's kernel in interpret mode, and the seed against the k-th best of
an exact (f64) scan of the sample.

Small shapes: d = 32 in dimension blocks of 8, 6000 rows in 8192 slots of
a JAX TpuFlat's mirror (a deleted run leaves invalid slots), 16 clusters
and 8 queries. Tolerances: seeded and unseeded runs agree exactly (the
seed only moves pruning); against JAX, scores within rtol 1e-5, atol 1e-4
(f32 partial sums in another order) and ids modulo exact ties; the seed
against f64 within rtol 1e-5, atol 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.flat import TpuFlat as JFlat
from dingo_tpu.ops.pallas_topk import pruned_fused_topk as jax_b4
from dingo_tpu_torch.ops import blocked as tb
from dingo_tpu_torch.ops.kernel_topk_pruned import (
    BLOCK,
    SEED_STRIDE,
    pruned_fused_topk_plain,
    seed_slots,
    seed_threshold_plain,
)

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
D, DBLK, K, N = 32, 8, 10, 6000
#: a dyadic sq8 codec: decode and bf16 rounding are exact both ways
SQ_SCALE, SQ_VMIN = 2.0 ** -5, -4.0


@pytest.fixture(scope="module")
def mirror():
    """A JAX TpuFlat's blocked mirror over clustered rows, as tensors, in
    the three arms: f32 rows, bf16 rows, sq8 codes (each with the norms
    of what its arm accumulates)."""
    saved = {f: JFLAGS.get(f) for f in ("ivf_dim_block",
                                        "vector_blocked_layout")}
    try:
        JFLAGS.set("ivf_dim_block", DBLK)
        JFLAGS.set("vector_blocked_layout", True)
        rng = np.random.default_rng(51)
        centers = rng.standard_normal((16, D), dtype=np.float32)
        x = centers[rng.integers(0, 16, N)] + 0.3 * rng.standard_normal(
            (N, D), dtype=np.float32)
        q = x[rng.choice(N, 8, replace=False)] + 0.05 * \
            rng.standard_normal((8, D), dtype=np.float32)
        jf = JFlat(52, JParam(index_type=JType.FLAT, dimension=D))
        jf.upsert(np.arange(N, dtype=np.int64), x.astype(np.float32))
        jf.delete(np.arange(100, 400, dtype=np.int64))
        st = jf.store
        assert st.vecs_blk is not None
        blk = torch.from_numpy(np.array(st.vecs_blk))
        valid = torch.from_numpy(np.array(st.device_mask()))
    finally:
        for f, v in saved.items():
            JFLAGS.set(f, v)
    rows = tb.from_blocked(blk, D)                  # [capacity, D] f32
    bf = rows.to(torch.bfloat16)
    codes = torch.round((rows - SQ_VMIN) / SQ_SCALE).clamp(0, 255).to(
        torch.uint8)
    dec = codes.to(torch.float32) * SQ_SCALE + SQ_VMIN
    codec = {"sq_vmin": torch.full((D,), SQ_VMIN),
             "sq_scale": torch.full((D,), SQ_SCALE)}
    arms = {}
    for name, stored, f32, kw in (("f32", rows, rows, {}),
                                  ("bf16", bf, bf.float(), {}),
                                  ("sq8", codes, dec, codec)):
        arms[name] = (tb.to_blocked(stored, DBLK),
                      tb.block_sqnorms(f32, DBLK), (f32 * f32).sum(1), kw,
                      f32)
    return {"q": torch.from_numpy(q.astype(np.float32)), "valid": valid,
            "arms": arms, "jax": (np.array(st.vecs_blk),
                                  np.array(st.bsq_blk), np.array(st.sqnorm))}


def _scan(m, arm, ascending, inbucket, init_thr=None):
    x_blk, bsq, xsq, kw, _ = m["arms"][arm]
    block = min(BLOCK, x_blk.shape[1])
    return pruned_fused_topk_plain(m["q"], x_blk, bsq, xsq, m["valid"], K,
                                   ascending, 1, inbucket, block,
                                   init_thr=init_thr, **kw)


def _seed(m, arm, ascending):
    x_blk, bsq, xsq, kw, _ = m["arms"][arm]
    return seed_threshold_plain(m["q"], x_blk, bsq, xsq, m["valid"], K,
                                ascending, **kw)


def test_seed_slots_are_every_stride_th_slot():
    assert SEED_STRIDE == 64
    np.testing.assert_array_equal(seed_slots(8192).numpy(),
                                  np.arange(0, 8192, 64))
    np.testing.assert_array_equal(seed_slots(130).numpy(), [0, 64, 128])


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("inbucket", [True, False], ids=["inb", "noinb"])
def test_seeded_plain_equals_unseeded(mirror, arm, ascending, inbucket):
    seed = _seed(mirror, arm, ascending)
    assert torch.isfinite(seed).all()       # the sample holds >= k rows
    v0, i0, s0 = _scan(mirror, arm, ascending, inbucket)
    v1, i1, s1 = _scan(mirror, arm, ascending, inbucket, init_thr=seed)
    np.testing.assert_array_equal(v1.numpy(), v0.numpy())
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())
    np.testing.assert_array_equal(s1[:, 1].numpy(), s0[:, 1].numpy())
    np.testing.assert_array_equal(s1[:, 3].numpy(), s0[:, 3].numpy())
    assert (s1[:, 0] <= s0[:, 0]).all()
    # the seed is a score k real rows reach: never above the final k-th
    assert (seed <= v0[:, K - 1]).all()


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
def test_seed_is_the_kth_best_of_the_sample(mirror, arm, ascending):
    """The seed against an exact f64 scan of the sampled slots in the
    arm's operands (the query rounded to bf16 where the arm pairs bf16)."""
    _, _, _, _, f32 = mirror["arms"][arm]
    idx = seed_slots(f32.shape[0])
    x = f32[idx].double().numpy()
    ok = mirror["valid"][idx].numpy()
    q32 = mirror["q"]
    qd = (q32 if arm == "f32" else q32.to(torch.bfloat16).float()).double()
    dots = qd.numpy() @ x.T
    if ascending:
        s = -((q32.double() ** 2).sum(1).numpy()[:, None] - 2 * dots
              + (x * x).sum(1)[None, :])
    else:
        s = dots
    s = np.where(ok[None, :], s, -np.inf)
    want = -np.sort(-s, axis=1)[:, K - 1]
    np.testing.assert_allclose(_seed(mirror, arm, ascending).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ascending", [True, False], ids=["l2", "ip"])
@pytest.mark.parametrize("inbucket", [True, False], ids=["inb", "noinb"])
def test_seeded_plain_matches_jax(mirror, ascending, inbucket):
    jblk, jbsq, jxsq = mirror["jax"]
    jv, ji, js = jax_b4(jnp.asarray(mirror["q"].numpy()), jnp.asarray(jblk),
                        jnp.asarray(jbsq), jnp.asarray(jxsq),
                        jnp.asarray(mirror["valid"].numpy()), None, None,
                        k=K, block=BLOCK, dim_block=DBLK, check_every=1,
                        ascending=ascending, interpret=True,
                        inbucket=inbucket)
    tv, ti, ts = _scan(mirror, "f32", ascending, inbucket,
                       init_thr=_seed(mirror, "f32", ascending))
    jv, ji, js = (np.asarray(a) for a in (jv, ji, js))
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv.numpy()), fin)
    np.testing.assert_allclose(tv.numpy()[fin], jv[fin], rtol=RTOL,
                               atol=ATOL)
    tvn, tin = tv.numpy(), ti.numpy()
    for r in range(jv.shape[0]):
        for c in np.flatnonzero(ji[r] != tin[r]):
            near = [tvn[r, c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < tvn.shape[1]]
            assert any(abs(tvn[r, c] - v) <= ATOL for v in near), (r, c)
    np.testing.assert_array_equal(ts[:, 1].numpy(), js[:, 1])
    np.testing.assert_array_equal(ts[:, 3].numpy(), js[:, 3])
    assert (ts[:, 0].numpy() <= js[:, 0]).all()
