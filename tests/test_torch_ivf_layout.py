"""Port parity: the bucketed IVF layout (build_layout, expand_probes,
MutableIvfView append/tombstone) against dingo_tpu/index/ivf_layout.py.
Host bookkeeping is integer-exact, so everything must match exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dingo_tpu.index import ivf_layout as jl
from dingo_tpu_torch.index import ivf_layout as tl

# small shapes: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)


def _skewed(seed, n=3000, nlist=16):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    assign[: n // 3] = 5                      # hot list -> spill buckets
    valid = rng.random(n) > 0.1
    assign[rng.random(n) < 0.05] = -1         # unassigned slots
    return assign, valid, nlist


@pytest.mark.parametrize("cap_hint", [None, 64])
def test_build_layout_matches_jax(cap_hint):
    assign, valid, nlist = _skewed(0)
    j = jl.build_layout(assign, valid, nlist, cap_hint)
    t = tl.build_layout(assign, valid, nlist, cap_hint)
    assert (t.cap_list, t.max_spill, t.nbuckets) == \
        (j.cap_list, j.max_spill, j.nbuckets)
    np.testing.assert_array_equal(t.bucket_slot_h, j.bucket_slot_h)
    np.testing.assert_array_equal(t.probe_table_h, np.asarray(j.probe_table))
    np.testing.assert_array_equal(t.bucket_coarse_h,
                                  np.asarray(j.bucket_coarse))


@pytest.mark.parametrize("n", [1, 7, 9, 100, 1000, 4097])
def test_ladders_match_jax(n):
    assert tl.alloc_buckets(n) == jl.alloc_buckets(n)
    assert tl.shape_bucket(n) == jl.shape_bucket(n)


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_expand_probes_matches_jax(nprobe):
    assign, valid, nlist = _skewed(1)
    lay = jl.build_layout(assign, valid, nlist, 32)
    assert lay.max_spill > 1
    rng = np.random.default_rng(2)
    probes = np.stack([rng.choice(nlist, nprobe, replace=False)
                       for _ in range(6)]).astype(np.int32)
    probes[0, 0] = 5                          # the spilling list first
    jv, jp = jl.expand_probes_ranked(jnp.asarray(probes), lay.probe_table,
                                     nprobe, lay.max_spill)
    tv, tp = tl.expand_probes_ranked(
        torch.from_numpy(probes),
        torch.from_numpy(np.array(lay.probe_table)), nprobe, lay.max_spill)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _views(seed, cap_hint=32):
    assign, valid, nlist = _skewed(seed, n=800, nlist=8)
    jv = jl.MutableIvfView.build(assign, valid, nlist, 1024, cap_hint)
    tv = tl.MutableIvfView.build(assign, valid, nlist, 1024, "cpu", cap_hint)
    return jv, tv


def _assert_views_equal(jv, tv):
    for name in ("bucket_slot_h", "bucket_coarse_h", "bucket_fill",
                 "probe_table_h", "list_nb", "slot_pos"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      err_msg=name)
    for name in ("nbuckets", "alloc", "max_spill", "version", "tombstones",
                 "live_rows", "inplace_appends", "buckets_added"):
        assert getattr(tv, name) == getattr(jv, name), name
    for name in ("bucket_slot", "bucket_valid", "probe_table",
                 "bucket_coarse"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)),
                                      err_msg=name)


def _apply(view, upd):
    if upd is not None:
        view.apply_device(upd)
    return upd


def test_mutable_view_append_and_tombstone_match_jax():
    jv, tv = _views(3)
    _assert_views_equal(jv, tv)
    rng = np.random.default_rng(4)
    for step in range(4):
        # appends (fresh slots + re-placements), enough to spill a list
        slots = rng.choice(1024, 120, replace=False)
        assigns = rng.integers(0, 8, 120).astype(np.int32)
        assigns[:40] = 1
        ju = _apply(jv, jv.stage_upsert(slots, assigns))
        tu = _apply(tv, tv.stage_upsert(slots, assigns))
        assert (ju is None) == (tu is None)
        assert tu.appended == ju.appended
        assert tu.grew_alloc == ju.grew_alloc
        _assert_views_equal(jv, tv)
        dels = rng.choice(1024, 60, replace=False)
        _apply(jv, jv.stage_delete(dels))
        _apply(tv, tv.stage_delete(dels))
        _assert_views_equal(jv, tv)
    assert tv.buckets_added > 0 and tv.tombstones > 0


def test_view_gather_rows_matches_jax():
    jv, tv = _views(5)
    src = np.random.default_rng(6).standard_normal((1024, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tv.gather_rows(torch.from_numpy(src)).numpy(),
        np.asarray(jv.gather_rows(jnp.asarray(src))))
