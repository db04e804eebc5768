"""The quality plane and the SLO tuner of the port (ops/shadow.py,
obs/quality.py, obs/tuner.py and the index hooks) against the JAX
package's, case by case from tests/test_quality.py (the pb, CLI and
flight-gRPC cases stay there), each through both packages on the same
seeded numpy inputs.

Tolerances: the scoring math (recall hits, RBO, score gap, the Wilson
interval, the windowed estimator) is equal exactly; the shadow scan's ids
equal the JAX package's modulo exact score ties and its distances within
rtol 1e-5, atol 1e-4 (f32 sums in another order); live estimates are
compared to numpy's recall within 1e-6; the tuner's steps are equal."""

import time

import numpy as np
import pytest
import torch

from torch_cluster_util import PKGS, Pkg

torch.set_num_threads(1)

P = {name: Pkg(name) for name in PKGS}
J, T = P["dingo_tpu"], P["dingo_tpu_torch"]


@pytest.fixture(autouse=True)
def _quality_env():
    saved = []
    for p in P.values():
        f = p.config.FLAGS
        saved.append((p, f.get("quality_sample_rate"),
                      f.get("quality_window_s")))
        f.set("quality_window_s", 3600.0)
    yield
    for p, rate, win in saved:
        p.config.FLAGS.set("quality_sample_rate", rate)
        p.config.FLAGS.set("quality_window_s", win)
        p.quality.QUALITY.clear()


@pytest.fixture(params=PKGS)
def pkg(request):
    return P[request.param]


def _corpus(n=2000, d=32, seed=3, noise=2.0, nq=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d), dtype=np.float32)
    x = centers[rng.integers(0, 16, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    queries = x[rng.choice(n, nq, replace=False)] + 0.3 * (
        rng.standard_normal((nq, d)).astype(np.float32))
    return ids, x, queries


def _exact_gt(x, ids, queries, k):
    dmat = ((queries ** 2).sum(1)[:, None] - 2.0 * queries @ x.T
            + (x ** 2).sum(1)[None, :])
    return ids[np.argsort(dmat, axis=1)[:, :k]]


def _recall(res, gt, k):
    return float(np.mean([len(set(r.ids) & set(g)) / k
                          for r, g in zip(res, gt)]))


def _ivf(p, region_id, d=32, nlist=16, nprobe=2, precision=""):
    b = p.base
    return p.new_index(region_id, b.IndexParameter(
        index_type=b.IndexType.IVF_FLAT, dimension=d, ncentroids=nlist,
        default_nprobe=nprobe, precision=precision))


def _flat(p, region_id, d=16, precision=""):
    b = p.base
    return p.new_index(region_id, b.IndexParameter(
        index_type=b.IndexType.FLAT, dimension=d, precision=precision))


def _fake_estimate(recall, half=0.01, queries=100, trials=1000, age_s=0.0):
    return {"recall": recall, "ci_low": max(0.0, recall - half),
            "ci_high": min(1.0, recall + half), "queries": queries,
            "trials": trials, "newest_ts": time.time() - age_s,
            "oldest_ts": time.time() - age_s - 1.0}


class _PlaneRecorder:
    def __init__(self):
        self.resets = []

    def reset_region(self, region_id):
        self.resets.append(region_id)


# ---------------- the scoring math: equal to the reference --------------

def test_scoring_math_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        served = rng.integers(-1, 40, 10)
        gt = rng.integers(-1, 40, 10)
        sd = np.sort(rng.random(10).astype(np.float32))
        gd = np.sort(rng.random(10).astype(np.float32))
        jq, tq = J.quality, T.quality
        assert jq.recall_hits(served, gt) == tq.recall_hits(served, gt)
        assert jq.rank_biased_overlap(served, gt) == \
            tq.rank_biased_overlap(served, gt)
        for asc in (True, False):
            assert jq.score_gap(sd, gd, asc) == tq.score_gap(sd, gd, asc)
    for hits, trials in [(0, 0), (0, 10), (95, 100), (100, 100),
                         (950, 1000), (3, 7)]:
        assert J.quality.wilson_interval(hits, trials) == \
            T.quality.wilson_interval(hits, trials)


def test_recall_hits_ignores_padding(pkg):
    q = pkg.quality
    assert q.recall_hits(np.asarray([1, 2, 3, -1, -1]),
                         np.asarray([2, 3, 9, -1, -1])) == (2, 3)
    assert q.recall_hits(np.asarray([-1]), np.asarray([-1])) == (0, 0)


def test_rbo_order_sensitivity(pkg):
    rbo = pkg.quality.rank_biased_overlap
    a = np.arange(10)
    assert rbo(a, a) == pytest.approx(1.0)
    assert rbo(a, a + 100) == pytest.approx(0.0)
    assert 0.0 < rbo(a, a[::-1]) < 1.0
    front = np.concatenate([a[:5], a[:5] + 100])
    back = np.concatenate([a[5:] + 100, a[5:]])
    assert rbo(front, a) > rbo(back, a)


def test_estimator_windowing_and_reset(pkg):
    est = pkg.quality.WindowedEstimator()
    est.add(8, 70, 80, 7.5, [0.1, 0.2])
    st = est.stats()
    assert st["recall"] == pytest.approx(70 / 80)
    assert st["queries"] == 8 and st["trials"] == 80
    assert st["ci_low"] < st["recall"] < st["ci_high"]
    est.reset()
    assert est.stats() is None
    pkg.config.FLAGS.set("quality_window_s", 0.05)
    est.add(4, 40, 40, 4.0, [])
    time.sleep(0.12)
    assert est.stats() is None


def test_estimator_stats_equal_the_reference():
    ests = {n: p.quality.WindowedEstimator() for n, p in P.items()}
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = int(rng.integers(1, 16))
        trials = q * 10
        hits = int(rng.integers(0, trials + 1))
        gaps = rng.random(q).tolist()
        for e in ests.values():
            e.add(q, hits, trials, float(q) * 0.8, gaps)
    a, b = (ests[n].stats() for n in PKGS)
    for key in ("recall", "ci_low", "ci_high", "rbo", "gap_p50", "gap_p99",
                "hits", "queries", "trials"):
        assert a[key] == b[key], key


# ---------------- the shadow oracle and the live estimate ----------------

def test_shadow_ids_equal_the_reference_modulo_ties():
    ids, x, queries = _corpus(nq=16)
    k = 10
    got = {}
    for name, p in P.items():
        idx = _ivf(p, 9320)
        idx.store.reserve(len(ids))
        idx.upsert(ids, x)
        oracle = p.quality.ShadowOracle(idx)
        assert oracle.mode == "store"
        got[name] = oracle.exact_topk(queries, k)
    (ji, jd), (ti, td) = got["dingo_tpu"], got["dingo_tpu_torch"]
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    for qi in range(len(queries)):
        if not np.array_equal(ti[qi], ji[qi]):
            # a tie: the differing ids sit at the same distance
            diff = set(ti[qi]) ^ set(ji[qi])
            dq = ((x[list(diff)] - queries[qi]) ** 2).sum(1)
            assert np.ptp(dq) <= 1e-4 * max(1.0, float(dq.max())), qi
    gt = _exact_gt(x, ids, queries, k)
    assert np.mean([len(set(a) & set(b)) / k for a, b in zip(ti, gt)]) == 1.0


def test_live_estimate_matches_brute_force(pkg):
    ids, x, queries = _corpus()
    k = 10
    gt = _exact_gt(x, ids, queries, k)
    idx = _ivf(pkg, 9301)
    idx.store.reserve(len(ids))
    idx.upsert(ids, x)
    idx.train()
    pkg.config.FLAGS.set("quality_sample_rate", 1.0)
    res = idx.search(queries, k)
    assert pkg.quality.QUALITY.flush()
    est = pkg.quality.QUALITY.region_estimate(9301)
    offline = _recall(res, gt, k)
    assert est is not None and est["queries"] == len(queries)
    assert est["recall"] == pytest.approx(offline, abs=1e-6)
    assert est["ci_low"] <= est["recall"] <= est["ci_high"]
    assert pkg.metrics.METRICS.gauge("quality.recall", 9301).get() == \
        pytest.approx(offline, abs=1e-6)


def test_sampling_off_is_inert(pkg, monkeypatch):
    """Rate 0: no shadow scan dispatched, no estimator state, and served
    results identical to a sampled run."""
    import importlib

    shadow_mod = importlib.import_module(f"{pkg.name}.ops.shadow")
    calls = {"n": 0}
    real = shadow_mod.shadow_exact_topk

    def spy(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(shadow_mod, "shadow_exact_topk", spy)
    ids, x, queries = _corpus(n=1500)
    idx = _ivf(pkg, 9302)
    idx.store.reserve(len(ids))
    idx.upsert(ids, x)
    idx.train()
    m = pkg.metrics.METRICS
    scans0 = m.counter("quality.shadow_scans", 9302).get()
    res_off = idx.search(queries, 10)
    res_off2 = idx.search(queries, 10)
    pkg.quality.QUALITY.flush()
    assert calls["n"] == 0
    assert m.counter("quality.shadow_scans", 9302).get() == scans0
    assert pkg.quality.QUALITY.region_estimate(9302) is None
    pkg.config.FLAGS.set("quality_sample_rate", 1.0)
    res_on = idx.search(queries, 10)
    pkg.quality.QUALITY.flush()
    assert calls["n"] >= 1
    for a, b, c in zip(res_off, res_off2, res_on):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.ids, c.ids)
        np.testing.assert_allclose(a.distances, c.distances)


def test_rate_zero_search_adds_no_work_on_the_port(monkeypatch):
    """The port's hooks at rate 0 and heat off: the shadow scan never
    runs (its call counter stays), no oracle is attached, and the reply's
    one fetch group holds only the reply's own arrays."""
    from dingo_tpu_torch.ops import shadow, topk

    sizes = []
    real = topk.begin_host_fetch

    def spy(*arrays):
        sizes.append(sum(a is not None for a in arrays))
        return real(*arrays)

    ids, x, queries = _corpus(n=1000)
    idx = _ivf(T, 9330)
    idx.upsert(ids, x)
    idx.train()
    import dingo_tpu_torch.index.ivf_flat as ivf_mod

    monkeypatch.setattr(ivf_mod, "begin_host_fetch", spy)
    calls0 = shadow.shadow_exact_topk.calls
    idx.search(queries, 10)
    assert shadow.shadow_exact_topk.calls == calls0
    assert not T.quality.QUALITY._oracles
    assert sizes == [2]          # dists and slots, nothing of the planes


def test_ci_width_shrinks_with_sample_count(pkg):
    ids, x, queries = _corpus()
    idx = _ivf(pkg, 9303)
    idx.store.reserve(len(ids))
    idx.upsert(ids, x)
    idx.train()
    pkg.config.FLAGS.set("quality_sample_rate", 1.0)
    idx.search(queries, 10)
    pkg.quality.QUALITY.flush()
    one = pkg.quality.QUALITY.region_estimate(9303)
    for _ in range(9):
        idx.search(queries, 10)
    pkg.quality.QUALITY.flush()
    many = pkg.quality.QUALITY.region_estimate(9303)
    assert many["queries"] > one["queries"]
    assert many["ci_high"] - many["ci_low"] < one["ci_high"] - one["ci_low"]


def test_quantized_mirror_keeps_original_rows(pkg):
    pkg.config.FLAGS.set("quality_sample_rate", 1.0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    ids = np.arange(64, dtype=np.int64)
    idx = _flat(pkg, 9304, precision="sq8")
    idx.upsert(ids, x)
    oracle = pkg.quality.QUALITY._oracle_for(idx)
    assert oracle.mode == "mirror"
    snap = oracle._mirror.to_host()
    order = np.argsort(snap["ids"])
    np.testing.assert_array_equal(snap["ids"][order], ids)
    np.testing.assert_array_equal(snap["vectors"][order], x)
    idx.delete(ids[:8])
    gt_ids, _ = oracle.exact_topk(x[:2], k=4)
    assert not (set(gt_ids.ravel().tolist()) & set(range(8)))


def test_filtered_search_scored_against_filtered_truth(pkg):
    ids, x, queries = _corpus(n=2000)
    k = 10
    idx = _ivf(pkg, 9309, nlist=16, nprobe=16)
    idx.store.reserve(len(ids))
    idx.upsert(ids, x)
    idx.train()
    keep = ids[ids % 8 == 3]
    spec = pkg.base.FilterSpec(include_ids=keep)
    pkg.config.FLAGS.set("quality_sample_rate", 1.0)
    res = idx.search(queries, k, spec)
    assert pkg.quality.QUALITY.flush()
    est = pkg.quality.QUALITY.region_estimate(9309)
    assert est is not None and est["recall"] > 0.95
    assert all(set(r.ids) <= set(keep.tolist()) for r in res)
    mask = np.isin(ids, keep)
    gt_f = _exact_gt(x[mask], ids[mask], queries, k)
    assert est["recall"] == pytest.approx(_recall(res, gt_f, k), abs=1e-6)


def test_mirror_survives_sample_rate_toggle(pkg):
    f = pkg.config.FLAGS
    f.set("quality_sample_rate", 1.0)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    ids = np.arange(64, dtype=np.int64)
    idx = _flat(pkg, 9306, precision="sq8")
    idx.upsert(ids[:32], x[:32])
    oracle = pkg.quality.QUALITY._oracle_for(idx)
    f.set("quality_sample_rate", 0.0)
    idx.delete(ids[:8])
    idx.upsert(ids[32:], x[32:])
    f.set("quality_sample_rate", 1.0)
    gt_ids, _ = oracle.exact_topk(x[40:42], k=4)
    assert not (set(gt_ids.ravel().tolist()) & set(range(8)))
    assert set(oracle._mirror.to_host()["ids"]) == set(ids[8:].tolist())


def test_install_reference_and_score_direct(pkg):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    ids = np.arange(256, dtype=np.int64)
    queries = x[:4]
    k = 5
    gt = _exact_gt(x, ids, queries, k)
    q = pkg.quality.QUALITY
    q.install_reference(9305, ids, x, **pkg.kw)
    assert q.score_direct(9305, queries, gt, k, kind="mesh")["recall"] == \
        pytest.approx(1.0)
    wrong = gt.copy()
    wrong[:, 0] = -1
    assert q.score_direct(9305, queries, wrong, k,
                          kind="mesh")["recall"] == pytest.approx(0.8)
    assert q.region_estimate(9305)["queries"] == 8


def test_standalone_reference_needs_a_card_unless_told(monkeypatch):
    """The port's standalone reference mirror is an entry point: it runs
    on the card unless the caller asks for the CPU."""
    from dingo_tpu_torch.common.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((8, 4), np.float32)
    with pytest.raises(DeviceUnavailable):
        T.quality.QUALITY.install_reference(9306, np.arange(8), x)
    T.quality.QUALITY.install_reference(9306, np.arange(8), x,
                                        device="cpu")
    T.quality.QUALITY.forget_region(9306)


# ---------------- the tuner ----------------

def test_ladder_helpers_equal_the_reference():
    for cap in (1, 16, 64, 512):
        assert J.tuner.ladder_values(cap) == T.tuner.ladder_values(cap)
    vals = T.tuner.ladder_values(64)
    assert vals == (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
    for cur in (1, 8, 10, 64, 80):
        for up in (True, False):
            assert J.tuner.ladder_step(vals, cur, up=up) == \
                T.tuner.ladder_step(vals, cur, up=up)


def _walk(p, estimates, region_id, slo, **ivf_kw):
    idx = _ivf(p, region_id, **ivf_kw)
    plane = _PlaneRecorder()
    tuner = p.tuner.SloTuner(slo_recall=slo, latency_budget_ms=0.0,
                             quality_plane=plane)
    ops = []
    for est in estimates:
        op = tuner.step_index(idx, est)
        ops.append(None if op is None else
                   (op.knob, op.old, op.new, op.direction, op.applied))
    return ops, dict(idx.tuning), plane.resets


@pytest.mark.parametrize("case", ["tighten", "relax", "in_band",
                                  "quantized"])
def test_tuner_steps_equal_the_reference(case):
    if case == "tighten":
        args = ([_fake_estimate(0.5)] * 10, 9310, 0.95)
        kw = dict(nlist=16, nprobe=1)
    elif case == "relax":
        args = ([_fake_estimate(0.999, half=0.001)] * 6, 9311, 0.90)
        kw = dict(nlist=16, nprobe=4)
    elif case == "in_band":
        args = ([_fake_estimate(0.95, half=0.02), _fake_estimate(0.5),
                 None, _fake_estimate(0.5, queries=8)], 9312, 0.95)
        kw = dict(nlist=16, nprobe=4)
    else:
        args = ([_fake_estimate(0.5)] * 4 + [_fake_estimate(0.99, 0.02)]
                + [_fake_estimate(0.5)], 9314, 0.99)
        kw = dict(nlist=16, nprobe=16, precision="sq8")
    got = {n: _walk(p, *args, **kw) for n, p in P.items()}
    assert got["dingo_tpu_torch"] == got["dingo_tpu"]
    if case == "tighten":
        steps = [o[2] for o in got["dingo_tpu_torch"][0] if o]
        assert steps == [2, 3, 4, 6, 8, 12, 16]


def test_tuner_in_band_holds_and_budget_blocks(pkg):
    idx = _ivf(pkg, 9313, nlist=16, nprobe=4)
    tuner = pkg.tuner.SloTuner(slo_recall=0.95, latency_budget_ms=5.0,
                               quality_plane=_PlaneRecorder())
    assert tuner.step_index(idx, _fake_estimate(0.95, half=0.02)) is None
    blocked = pkg.metrics.METRICS.counter("quality.tuner_blocked", 9313)
    b0 = blocked.get()
    assert tuner.step_index(idx, _fake_estimate(0.5), p99_ms=50.0) is None
    assert blocked.get() == b0 + 1
    op = tuner.step_index(idx, _fake_estimate(0.999, half=0.0005),
                          p99_ms=50.0)
    assert op is not None and op.direction == "relax"


def test_tuner_knobs_for_hnsw(pkg):
    b = pkg.base
    idx = pkg.new_index(9315, b.IndexParameter(
        index_type=b.IndexType.HNSW, dimension=8, nlinks=4,
        efconstruction=32))
    tuner = pkg.tuner.SloTuner(slo_recall=0.95, latency_budget_ms=0.0,
                               quality_plane=_PlaneRecorder())
    op = tuner.step_index(idx, _fake_estimate(0.5))
    assert op.knob == "ef" and op.new > idx.ef_search_default
    assert idx.tuning["ef"] == op.new


def test_tuner_override_reaches_the_search_path(pkg):
    ids, x, queries = _corpus(n=3000)
    k = 10
    gt = _exact_gt(x, ids, queries, k)
    idx = _ivf(pkg, 9316, nlist=16, nprobe=1)
    idx.store.reserve(len(ids))
    idx.upsert(ids, x)
    idx.train()
    before = _recall(idx.search(queries, k), gt, k)
    idx.tuning["nprobe"] = 16
    after = _recall(idx.search(queries, k), gt, k)
    assert after >= before
    assert after == pytest.approx(
        _recall(idx.search(queries, k, nprobe=16), gt, k))
    assert _recall(idx.search(queries, k, nprobe=1), gt, k) == \
        pytest.approx(before, abs=1e-6)


def test_no_new_shapes_across_tuner_steps():
    """Tuner steps pick shape-ladder values only: a warmed region serves
    the whole walk, shadow scans included, with no new kernel shape (the
    port's launch sentinel; B3's plain version runs through its wrapper
    with the kernel crossover forced)."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS

    saved = {k: FLAGS.get(k) for k in ("use_pallas_ivf_search",
                                       "ivf_dim_block")}
    FLAGS.set("use_pallas_ivf_search", "True")
    FLAGS.set("ivf_dim_block", 8)
    try:
        ids, x, queries = _corpus(n=2000)
        k = 10
        idx = _ivf(T, 9317, nlist=16, nprobe=1)
        idx.store.reserve(len(ids))
        idx.upsert(ids, x)
        idx.train()
        for np_ in T.tuner.ladder_values(16):
            idx.warmup(batches=(len(queries),), topk=k, nprobe=np_)
        FLAGS.set("quality_sample_rate", 1.0)
        idx.search(queries, k)
        assert T.quality.QUALITY.flush()
        shapes = METRICS.counter("kernel.new_shapes")
        s0 = shapes.get()
        hits = METRICS.counter("kernel.shape_hits",
                               labels={"kernel": "ivf_pruned_topk"})
        h0 = hits.get()
        tuner = T.tuner.SloTuner(slo_recall=0.99, latency_budget_ms=0.0,
                                 min_queries=4)
        for _ in range(8):
            idx.search(queries, k)
            assert T.quality.QUALITY.flush()
            tuner.step_index(idx, T.quality.QUALITY.region_estimate(9317))
        assert idx.tuning.get("nprobe", 1) > 1
        assert hits.get() > h0          # the kernel wrapper did run
        assert shapes.get() - s0 == 0
    finally:
        for key, v in saved.items():
            FLAGS.set(key, v)
