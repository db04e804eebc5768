"""Storage dtypes beyond float32 and bf16 (IndexParameter.dtype) in the port
against the JAX package: FLAT, IVF_FLAT, IVF_PQ and HNSW (its host graph and
its device walk) crossed with float16, int8 and float64, each through both
packages on the CPU.

Where both serve: the same stored rows (the device store's values and
norms; float64 keeps float32 rows, as JAX does without 64-bit mode), and
the same answers, ids equal modulo ties with distances within rtol 1e-3
(float16) or 1e-5 (the others) and an absolute 4 f32 ulps of the largest
squared norm (the L2 expansion's cancellation near 0, summed in each
package's own order). Where the JAX package raises, the port
raises the same error type.

int8 from floats. The rows are Gaussian times 100, so about a third of
the values lie outside +/-127. The JAX package's device write converts
them as XLA does (saturating: 200.7 -> 127, -1e6 -> -128, NaN -> 0), its
host store (IVF_PQ with host_vectors) as numpy does (wrapping: 200.7 ->
-56); a plain torch cast wraps too. The port matches each, and a test
pins the three casts on the same values."""

import warnings

import numpy as np
import pytest
import torch

from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.factory import new_index as j_new_index
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.base import InvalidParameter
from dingo_tpu_torch.index.factory import new_index as t_new_index
from dingo_tpu_torch.index.slot_store import SlotStore
from dingo_tpu_torch.ops.distance import saturate_int8

torch.set_num_threads(1)

D, N, K = 16, 300, 6
DTYPES = ("float16", "int8", "float64")
FAMILIES = {
    "flat": {},
    "ivf_flat": {"ncentroids": 4, "default_nprobe": 4},
    "ivf_pq": {"ncentroids": 4, "nsubvector": 4, "default_nprobe": 4},
    "hnsw": {},
}
#: the HNSW device walk's flags, set on both packages
WALK_FLAGS = ("hnsw_device_search", "hnsw_device_build")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, D)) * 100).astype(np.float32)
    q = x[rng.choice(N, 8, replace=False)] + rng.standard_normal(
        (8, D)).astype(np.float32)
    return np.arange(N, dtype=np.int64), x, q.astype(np.float32)


def _build(pkg, family, dtype, **extra):
    kw = dict(FAMILIES[family], **extra)
    with warnings.catch_warnings():
        # float64: both packages warn that the rows are float32
        warnings.simplefilter("ignore", UserWarning)
        if pkg == "jax":
            return j_new_index(1, JParam(index_type=JType(family),
                                         dimension=D, dtype=dtype, **kw))
        return t_new_index(1, TParam(index_type=TType(family), dimension=D,
                                     dtype=dtype, **kw), device="cpu")


def _serve(pkg, family, dtype, **extra):
    """(stored rows by id order, their norms, search results)."""
    ids, x, q = _data()
    idx = _build(pkg, family, dtype, **extra)
    with warnings.catch_warnings():
        # numpy's wrapping cast of the host store warns on the values it
        # wraps, as in the JAX package
        warnings.simplefilter("ignore", RuntimeWarning)
        idx.upsert(ids, x)
        if family.startswith("ivf"):
            idx.train(x)
    store = idx.store
    slots = store.slots_of(ids)
    if pkg == "jax":
        vecs, sq = np.asarray(store.vecs), np.asarray(store.sqnorm)
    elif isinstance(store.vecs, np.ndarray):
        vecs, sq = store.vecs, store.sqnorm
    else:
        vecs, sq = store.vecs.cpu().numpy(), store.sqnorm.cpu().numpy()
    return vecs[slots], sq[slots], idx.search(q, K)


def _cancellation_atol() -> float:
    """Absolute error of an f32 L2 distance ||q||^2 - 2 q.x + ||x||^2 at
    this data's norms (~1.6e5): each package sums the terms in its own
    order, and near a distance of 0 the terms cancel, so the rounding of
    the terms (4 ulps of the largest) is what the two may differ by."""
    _, x, q = _data()
    big = float((x * x).sum(1).max() + (q * q).sum(1).max())
    return 4 * float(np.finfo(np.float32).eps) * big


def _assert_same_answers(jres, tres, rtol):
    atol = _cancellation_atol()
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids) == K
        np.testing.assert_allclose(b.distances, a.distances, rtol=rtol,
                                   atol=atol)
        for c in np.flatnonzero(a.ids != b.ids):
            near = [b.distances[c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < K]
            assert c == K - 1 or any(
                np.isclose(b.distances[c], v, rtol=rtol, atol=atol)
                for v in near), (a.ids, b.ids)


@pytest.fixture
def walk_flags():
    saved = {f: (JFLAGS.get(f), TFLAGS.get(f)) for f in WALK_FLAGS}

    def set_both(value):
        for f in WALK_FLAGS:
            JFLAGS.set(f, value)
            TFLAGS.set(f, value)

    try:
        yield set_both
    finally:
        for f, (jv, tv) in saved.items():
            JFLAGS.set(f, jv)
            TFLAGS.set(f, tv)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_storage_dtype_matches_the_jax_package(family, dtype):
    jv, jsq, jres = _serve("jax", family, dtype)
    tv, tsq, tres = _serve("torch", family, dtype)
    want = {"float16": np.float16, "int8": np.int8,
            "float64": np.float32}[dtype]
    assert jv.dtype == tv.dtype == want
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tsq, jsq, rtol=1e-6)
    _assert_same_answers(jres, tres, 1e-3 if dtype == "float16" else 1e-5)


@pytest.mark.parametrize("dtype", ("float16", "int8"))
def test_hnsw_device_walk_matches_the_jax_package(walk_flags, dtype):
    """The device walk (kernel G's plain version for these rows: the JAX
    package scores them in XLA, the query cast to the rows' dtype)."""
    walk_flags(True)
    jv, _, jres = _serve("jax", "hnsw", dtype)
    tv, _, tres = _serve("torch", "hnsw", dtype)
    np.testing.assert_array_equal(tv, jv)
    _assert_same_answers(jres, tres, 1e-3 if dtype == "float16" else 1e-5)


def test_ivf_pq_host_rows_cast_as_the_jax_host_store():
    """IVF_PQ with host_vectors: the JAX package's host store casts with
    numpy, so its int8 rows wrap where its device rows saturate."""
    jv, jsq, _ = _serve("jax", "ivf_pq", "int8", host_vectors=True)
    tv, tsq, _ = _serve("torch", "ivf_pq", "int8", host_vectors=True)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tsq, jsq, rtol=1e-6)
    _, x, _ = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_array_equal(tv, x.astype(np.int8))


def test_int8_casts_differ_past_the_range_and_the_port_saturates():
    """The three casts on the same values: XLA's (the JAX device store)
    saturates, numpy's and torch's wrap; the port's device store and its
    canonical rows (the integrity ledger's) saturate."""
    import jax.numpy as jnp

    v = np.array([[0.4, -0.6, 1.7, -1.7, 126.9, 127.5, 128.2, -128.9,
                   -129.5, 200.7, -200.7, 255.9, 256.5, 1000.3, -1e6,
                   3e9, np.nan, np.inf, -np.inf, 0.0]], np.float32)
    xla = np.asarray(jnp.asarray(v).astype(jnp.int8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        wrapped = v.astype(np.int8)
    plain = torch.from_numpy(v[:, :16]).to(torch.int8).numpy()
    assert (xla != wrapped).any()
    np.testing.assert_array_equal(plain, wrapped[:, :16])
    np.testing.assert_array_equal(saturate_int8(torch.from_numpy(v)).numpy(),
                                  xla)
    store = SlotStore(v.shape[1], "cpu", dtype=torch.int8)
    store.put(np.array([5]), v)
    np.testing.assert_array_equal(store.vecs[store.slots_of([5])].numpy(),
                                  xla)
    np.testing.assert_array_equal(store.canonical_rows(v), xla)


@pytest.mark.parametrize("dtype", ("not_a_dtype", "f32x"))
def test_unknown_dtype_name_raises_the_same_type(dtype):
    with pytest.raises(TypeError):
        _build("jax", "flat", dtype)
    with pytest.raises(TypeError):
        _build("torch", "flat", dtype)


@pytest.mark.parametrize("dtype", ("bool", "complex64", "uint8", "int32"))
def test_other_numpy_dtypes_refused(dtype):
    """The port stores float16, float32, float64 and int8 rows; another
    numpy dtype raises InvalidParameter when the index is built (the JAX
    package keeps any numpy dtype)."""
    with pytest.raises(InvalidParameter, match="storage dtype"):
        _build("torch", "flat", dtype)


def test_aliases_and_tiers_take_the_jax_package_stores():
    for name, want in (("half", torch.float16), ("i1", torch.int8),
                       ("double", torch.float32), ("f32", torch.float32)):
        assert _build("torch", "flat", name).store.dtype == want, name
    # the bf16 and sq8 tiers ignore the storage dtype, as in the JAX
    # package
    assert _build("torch", "flat", "int8",
                  precision="bf16").store.dtype == torch.bfloat16
    assert _build("torch", "flat", "float16",
                  precision="sq8").store.dtype == torch.uint8


@pytest.mark.parametrize("store_cls", ("SlotStore", "HostSlotStore"))
@pytest.mark.parametrize("dtype", ("float16", "int8", "float32", "bfloat16"))
def test_canonical_rows_are_the_stored_rows(store_cls, dtype):
    """The integrity ledger digests a store's canonical rows against a
    read-back of its rows: both the device store (saturating int8) and the
    host store (numpy's wrapping cast) agree with what they keep, past the
    int8 range too."""
    from dingo_tpu_torch.index import slot_store
    from dingo_tpu_torch.index.slot_store import host_bits

    _, x, _ = _data()
    store = getattr(slot_store, store_cls)(D, "cpu",
                                           dtype=getattr(torch, dtype))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        store.put(np.arange(N, dtype=np.int64), x)
        canon = store.canonical_rows(x)
    vecs = store.vecs if isinstance(store.vecs, np.ndarray) \
        else host_bits(store.vecs)
    np.testing.assert_array_equal(vecs[store.slots_of(np.arange(N))], canon)
