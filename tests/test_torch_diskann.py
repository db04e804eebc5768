"""The diskann role's core of the port against the JAX package: the cases
of test_diskann.py (lifecycle and recall, restart try_load,
reset/close/destroy) through both packages, restart adoption and the
truncation of orphan rows, upsert in place, the port's core loading and
searching a directory the JAX core built (the on-disk format is the
interchange), and the item manager's asynchronous build. The proxy index
and the role's service are gRPC and not in the port.

Seeded numpy inputs at d 32, m 8, nlist 16 go through both packages.
Distances within rtol 1e-4, atol 1e-3; ids modulo ties (a differing id
sits next to an equal distance). The port runs on the CPU
(``device="cpu"``)."""

import importlib
import os
import time

import numpy as np
import pytest
import torch

from dingo_tpu_torch.common.device import DeviceUnavailable
from dingo_tpu_torch.index.ivf_pq import _ivfpq_scan_kernel

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
RTOL, ATOL = 1e-4, 1e-3
DIM = 32


class Pkg:
    def __init__(self, name):
        self.name = name
        self.port = name == "dingo_tpu_torch"
        self.core_m = importlib.import_module(f"{name}.diskann.core")
        self.item_m = importlib.import_module(f"{name}.diskann.item")
        self.base = importlib.import_module(f"{name}.index.base")
        self.Metric = importlib.import_module(f"{name}.ops.distance").Metric
        self.State = self.core_m.CoreState
        self.Error = self.core_m.DiskAnnError

    def param(self, metric="l2", **kw):
        b = self.base
        return b.IndexParameter(
            index_type=b.IndexType.DISKANN, dimension=DIM, ncentroids=16,
            nsubvector=8, default_nprobe=8, metric=self.Metric(metric), **kw)

    def core(self, index_id, path, metric="l2"):
        kw = {"device": "cpu"} if self.port else {}
        return self.core_m.DiskAnnCore(index_id, self.param(metric),
                                       str(path), **kw)

    def manager(self, root):
        kw = {"device": "cpu"} if self.port else {}
        return self.item_m.DiskAnnItemManager(str(root), **kw)


@pytest.fixture(params=PKGS)
def p(request):
    return Pkg(request.param)


@pytest.fixture(scope="module")
def corpus():
    """test_diskann.py's recipe at d 32: 16 centers + 0.15 noise."""
    rng = np.random.default_rng(13)
    centers = rng.standard_normal((16, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 16, 5000)] + 0.15 * rng.standard_normal(
        (5000, DIM)).astype(np.float32)
    return np.arange(5000, dtype=np.int64), x


def exact_l2(q, x):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    return ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)


def assert_same_results(a, b):
    """Two lists of (ids, distances): distances within tolerance, ids
    equal modulo ties."""
    assert len(a) == len(b)
    for (ia, da), (ib, db) in zip(a, b):
        assert len(ia) == len(ib)
        np.testing.assert_allclose(db, da, rtol=RTOL, atol=ATOL)
        for c in np.flatnonzero(np.asarray(ia) != np.asarray(ib)):
            near = [db[c2] for c2 in (c - 1, c + 1) if 0 <= c2 < len(db)]
            assert any(abs(db[c] - v) <= ATOL for v in near), (c, ia, ib)


def test_core_lifecycle_and_recall(p, tmp_path, corpus):
    ids, x = corpus
    core = p.core(1, tmp_path / "d1")
    assert core.status() is p.State.UNINIT
    with pytest.raises(p.Error):
        core.build()  # nothing imported
    core.push_data(ids[:3000], x[:3000], has_more=True)
    assert core.status() is p.State.IMPORTING
    core.push_data(ids[3000:], x[3000:], has_more=False)
    assert core.status() is p.State.IMPORTED
    with pytest.raises(p.Error):
        core.search(x[:1], 5)  # not loaded
    core.build()
    assert core.status() is p.State.BUILT
    core.load()
    assert core.status() is p.State.LOADED

    q = x[:16] + 0.01
    res = core.search(q, 10, nprobe=16)
    d2 = exact_l2(q, x)
    gt = np.argsort(d2, axis=1)[:, :10]
    recall = np.mean([len(set(r_ids) & set(ids[g])) / 10
                      for (r_ids, _), g in zip(res, gt)])
    assert recall >= 0.8, recall  # PQ prune + exact disk rerank
    # exact distances from the rerank, not ADC approximations: every one
    # against the f64 distance of its id
    for qi, (r_ids, r_d) in enumerate(res):
        np.testing.assert_allclose(r_d, d2[qi, r_ids], rtol=RTOL, atol=ATOL)
    if p.port:
        assert set(core.search_timings) == {"adc_ms", "gather_ms",
                                            "rerank_ms"}
        assert set(core.build_timings) >= {"coarse_fit_s", "pq_fit_s",
                                           "encode_s"}


def test_builds_agree_across_packages(tmp_path, corpus):
    """The same pushes built by each package: the coarse and PQ fits
    follow the same seeds, so the codes agree and the searches give the
    same ids modulo ties."""
    ids, x = corpus
    cores = {}
    for name in PKGS:
        c = Pkg(name).core(5, tmp_path / name)
        c.push_data(ids, x, has_more=False)
        c.build()
        c.load()
        cores[name] = c
    j, t = (np.load(tmp_path / name / "pq_index.npz") for name in PKGS)
    np.testing.assert_allclose(t["centroids"], j["centroids"], rtol=1e-4,
                               atol=1e-4)
    assert (t["assign"] == j["assign"]).mean() >= 0.999
    assert (t["codes"] == j["codes"]).mean() >= 0.99
    q = x[100:116] + 0.01
    assert_same_results(cores["dingo_tpu"].search(q, 10, nprobe=8),
                        cores["dingo_tpu_torch"].search(q, 10, nprobe=8))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_port_loads_a_directory_the_jax_core_built(tmp_path, corpus,
                                                   metric):
    """The on-disk format carries DiskANN's state across: a new port core
    on the JAX core's directory adopts its import, loads its codes and
    answers with the JAX core's ids modulo ties."""
    ids, x = corpus
    d = tmp_path / "jax"
    jcore = Pkg("dingo_tpu").core(3, d, metric)
    jcore.push_data(ids, x, has_more=False)
    jcore.build()
    jcore.load()
    tcore = Pkg("dingo_tpu_torch").core(3, d, metric)
    assert tcore.count == 5000
    assert tcore.status().value == "imported"
    assert tcore.try_load() is True
    assert tcore.status().value == "loaded"
    q = x[[7, 70, 700, 4000]] + 0.02
    for nprobe, factor in ((8, None), (3, 4), (16, 8)):
        before = _ivfpq_scan_kernel.calls
        got = tcore.search(q, 10, nprobe=nprobe, rerank_factor=factor)
        assert _ivfpq_scan_kernel.calls == before + 1
        assert_same_results(jcore.search(q, 10, nprobe=nprobe,
                                         rerank_factor=factor), got)


def test_core_restart_try_load(p, tmp_path, corpus):
    """A new process can try_load a previously built index from disk."""
    ids, x = corpus
    d = tmp_path / "d2"
    core = p.core(2, d)
    core.push_data(ids[:2000], x[:2000], has_more=False)
    core.build()
    core2 = p.core(2, d)
    assert core2.count == 2000 and core2.status() is p.State.IMPORTED
    core2.count = 2000
    assert core2.try_load() is True
    res = core2.search(x[:2], 3, nprobe=16)
    assert res[0][0][0] == 0
    core3 = p.core(3, tmp_path / "d3")
    assert core3.try_load() is False


def test_restart_truncates_orphan_rows(p, tmp_path, corpus):
    """Rows appended without their ids (a crash between the two appends)
    are cut off at restart, so the next push stays aligned."""
    ids, x = corpus
    d = tmp_path / "d5"
    core = p.core(5, d)
    core.push_data(ids[:300], x[:300], has_more=False)
    with open(d / "vectors.f32", "ab") as f:
        f.write(x[300:310].tobytes())
    core2 = p.core(5, d)
    assert os.path.getsize(d / "vectors.f32") == 300 * DIM * 4
    assert core2.push_data(ids[300:400], x[300:400], has_more=False) == 400
    rows = np.fromfile(d / "vectors.f32", np.float32).reshape(-1, DIM)
    np.testing.assert_array_equal(rows[300:400], x[300:400])


def test_push_data_upserts_in_place(p, tmp_path, corpus):
    ids, x = corpus
    d = tmp_path / "d6"
    core = p.core(6, d)
    assert core.push_data(ids[:500], x[:500], has_more=True) == 500
    new = x[1000:1010]
    assert core.push_data(ids[:10], new, has_more=False) == 500
    rows = np.fromfile(d / "vectors.f32", np.float32).reshape(-1, DIM)
    assert rows.shape[0] == 500
    np.testing.assert_array_equal(rows[:10], new)
    np.testing.assert_array_equal(np.fromfile(d / "ids.bin", np.int64),
                                  ids[:500])
    core.build()
    core.load()
    res = core.search(new[:3], 1, nprobe=16)
    assert [int(r[0][0]) for r in res] == [0, 1, 2]
    assert all(float(r[1][0]) <= 1e-3 for r in res)


def test_reset_close_destroy(p, tmp_path, corpus):
    ids, x = corpus
    d = tmp_path / "d4"
    core = p.core(4, d)
    core.push_data(ids[:500], x[:500], has_more=False)
    core.build()
    core.load()
    core.close()
    assert core.status() is p.State.BUILT
    with pytest.raises(p.Error):
        core.search(x[:1], 5)
    core.load()
    core.reset()
    assert core.status() is p.State.IMPORTED and core.count == 500
    core.reset(delete_data_file=True)
    assert core.status() is p.State.UNINIT and core.count == 0
    assert not os.path.exists(d / "vectors.f32")
    core.destroy()
    assert not os.path.exists(d)


def test_item_manager_async_build(p, tmp_path, corpus):
    ids, x = corpus
    mgr = p.manager(tmp_path / "root")
    try:
        core = mgr.create(7, p.param())
        with pytest.raises(p.Error):
            mgr.create(7, p.param())
        with pytest.raises(p.Error):
            mgr.submit_build(8)
        with pytest.raises(p.Error):
            mgr.submit_build(7)             # nothing imported yet
        core.push_data(ids[:3000], x[:3000], has_more=False)
        mgr.submit_build(7)
        deadline = time.monotonic() + 120
        while core.status() is not p.State.BUILT:
            assert core.status() in (p.State.IMPORTED, p.State.BUILDING)
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert mgr.get(7) is core and set(mgr.all_items()) == {7}
        core.load()
        res = core.search(x[:4] + 0.01, 5, nprobe=16)
        assert [int(r[0][0]) for r in res] == [0, 1, 2, 3]
        mgr.destroy(7)
        assert mgr.get(7) is None
        assert not os.path.exists(tmp_path / "root" / "7")
    finally:
        mgr.stop()


def test_item_manager_records_a_failed_build(p, tmp_path, corpus):
    ids, x = corpus
    mgr = p.manager(tmp_path / "root")
    try:
        core = mgr.create(9, p.param())
        core.push_data(ids[:100], x[:100], has_more=False)  # < ksub rows
        mgr.submit_build(9)
        deadline = time.monotonic() + 60
        while core.status() is not p.State.FAILED:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert "rows" in core.last_error
    finally:
        mgr.stop()


def test_core_rejects_bad_parameters(p, tmp_path):
    b = p.base
    with pytest.raises(b.InvalidParameter):
        p.core_m.DiskAnnCore(1, b.IndexParameter(
            index_type=b.IndexType.DISKANN, dimension=30, nsubvector=8),
            str(tmp_path / "x"), **({"device": "cpu"} if p.port else {}))
    with pytest.raises(b.InvalidParameter):
        p.core(1, tmp_path / "y", metric="hamming")
    core = p.core(1, tmp_path / "z")
    with pytest.raises(b.InvalidParameter):
        core.push_data(np.arange(2), np.zeros((2, 8), np.float32), False)


def test_port_core_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """device=None means CUDA: without a card the core and the manager
    raise instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Pkg("dingo_tpu_torch")
    with pytest.raises(DeviceUnavailable):
        t.core_m.DiskAnnCore(1, t.param(), str(tmp_path / "a"))
    with pytest.raises(DeviceUnavailable):
        t.item_m.DiskAnnItemManager(str(tmp_path / "b"))
