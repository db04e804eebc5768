"""The heat plane and the per-shape cost model of the port (obs/heat.py,
obs/cost.py, the index hooks and the coalescer's wait estimate) against
the JAX package's, case by case from tests/test_heat.py (the pb, capacity
render and CLI cases stay there), each through both packages on the same
seeded numpy inputs.

Tolerances: sketch masses, Gini, hot fraction and working-set estimates
of the same observation stream equal the JAX package's within rtol 1e-12
(the same float64 arithmetic; the plane's statistics within 1e-9, its
observations stamped by the wall clock under a decay constant far past
the run), cost estimates exactly; the coalescer's cold-start estimate is
the prior exactly."""

import math
import time

import numpy as np
import pytest
import torch

from torch_cluster_util import PKGS, Pkg

torch.set_num_threads(1)

P = {name: Pkg(name) for name in PKGS}
J, T = P["dingo_tpu"], P["dingo_tpu_torch"]
_SAVED = ("heat_enabled", "heat_decay_s", "heat_max_entries",
          "cost_enabled", "cost_prior_row_ms", "qos_enabled",
          "qos_max_queue_ms")


@pytest.fixture(autouse=True)
def heat_env():
    saved = []
    for p in P.values():
        saved.append((p, {k: p.config.FLAGS.get(k) for k in _SAVED}))
        p.heat.HEAT.reset()
        p.cost.COST.reset()
    yield
    for p, flags in saved:
        for k, v in flags.items():
            p.config.FLAGS.set(k, v)
        p.heat.HEAT.reset()
        p.cost.COST.reset()


@pytest.fixture(params=PKGS)
def pkg(request):
    return P[request.param]


# ---------------- sketch math ----------------

def test_sketch_decays_at_the_configured_rate(pkg):
    tau = 10.0
    rh = pkg.heat._RegionHeat(0.0)
    rh.fold("ivf", np.array([1]), 1.0, 0.0, tau, 4096)
    rh.fold("ivf", np.array([2]), 1.0, 3.0 * tau, tau, 4096)
    scale = math.exp((rh.t0 - 3.0 * tau) / tau)
    assert rh.mass[("ivf", 2)] * scale == pytest.approx(1.0)
    assert rh.mass[("ivf", 1)] / rh.mass[("ivf", 2)] == pytest.approx(
        math.exp(-3.0), rel=1e-6)


def test_sketch_memory_is_bounded_and_keeps_the_hottest(pkg):
    rh = pkg.heat._RegionHeat(0.0)
    rh.fold("slot", np.full(50, 7), 1.0, 0.0, 10.0, 64)
    for start in range(0, 500, 100):
        rh.fold("slot", np.arange(start + 100, start + 200), 1.0, 0.0,
                10.0, 64)
    assert len(rh.mass) <= 64
    assert ("slot", 7) in rh.mass


def test_sketch_folds_equal_the_reference():
    rng = np.random.default_rng(4)
    stream = [(rng.zipf(1.4, 300) % 200, float(t))
              for t in np.cumsum(rng.random(30) * 5.0)]
    masses = {}
    for name, p in P.items():
        rh = p.heat._RegionHeat(0.0)
        for units, t in stream:
            rh.fold("ivf", units, 1.0, t, 20.0, 128)
        masses[name] = (rh.t0, dict(rh.mass))
    (jt, jm), (tt, tm) = masses["dingo_tpu"], masses["dingo_tpu_torch"]
    assert jt == tt and set(jm) == set(tm)
    for key in jm:
        assert tm[key] == pytest.approx(jm[key], rel=1e-12)


def test_gini_hot_fraction_working_set_equal_the_reference():
    rng = np.random.default_rng(5)
    for counts in (np.ones(100), 1.0 / np.arange(1, 101) ** 1.5,
                   np.bincount(rng.zipf(1.3, 20_000) % 200,
                               minlength=200).astype(np.float64),
                   np.array([])):
        for f in ("gini", "hot_fraction"):
            assert getattr(J.heat, f)(counts) == pytest.approx(
                getattr(T.heat, f)(counts), rel=1e-12, abs=1e-15)
        if len(counts):
            rows = rng.integers(1, 64, len(counts)).astype(np.float64)
            assert J.heat.working_set_rows(counts, rows, (50, 90, 99)) == \
                T.heat.working_set_rows(counts, rows, (50, 90, 99))


def test_working_set_matches_exact_replay(pkg):
    rng = np.random.default_rng(5)
    units = rng.zipf(1.3, 20_000) % 200
    counts = np.bincount(units, minlength=200).astype(np.float64)
    est = pkg.heat.working_set_rows(counts, np.full(200, 32.0),
                                    (50, 90, 99))
    order = np.argsort(counts)[::-1]
    cum = np.cumsum(counts[order]) / counts.sum()
    for p in (50, 90, 99):
        assert est[p] == (int(np.searchsorted(cum, p / 100.0)) + 1) * 32


# ---------------- the async plane ----------------

def test_plane_stats_equal_the_reference():
    """Skewed (zipf) against uniform traffic: both packages' planes read
    the same touches, hot fraction, Gini and working set."""
    rng = np.random.default_rng(11)
    feed = [(rng.zipf(1.5, 256) % 64, rng.integers(0, 64, 256))
            for _ in range(20)]
    stats = {}
    for name, p in P.items():
        p.config.FLAGS.set("heat_enabled", True)
        # the plane stamps each observation with the wall clock: a decay
        # constant far past the runs' length takes the two runs' clocks
        # out of the comparison
        p.config.FLAGS.set("heat_decay_s", 1e9)
        plane = p.heat.HeatPlane(p.metrics.MetricsRegistry())
        rows = np.full(64, 100.0)
        for rid in (1, 2):
            plane.register_layout(rid, "ivf", lambda rows=rows: {
                "unit_rows": rows, "row_bytes": 128.0, "tier": "fp32",
                "dim": 32})
        for skewed, uniform in feed:
            plane.observe(1, "ivf", skewed)
            plane.observe(2, "ivf", uniform)
        assert plane.flush(timeout=30.0)
        stats[name] = (plane.region_stats(1), plane.region_stats(2))
    for j, t in zip(stats["dingo_tpu"], stats["dingo_tpu_torch"]):
        assert t["touches"] == j["touches"] == 20 * 256
        assert t["ws_bytes"] == j["ws_bytes"]
        for key in ("hot_fraction", "gini"):
            assert t[key] == pytest.approx(j[key], rel=1e-9)
    s1, s2 = stats["dingo_tpu_torch"]
    assert s1["hot_fraction"] > s2["hot_fraction"] + 0.2
    assert s1["gini"] > s2["gini"] + 0.2


def test_slot_kind_maps_to_blocks_and_filters_padding(pkg):
    pkg.config.FLAGS.set("heat_enabled", True)
    plane = pkg.heat.HeatPlane(pkg.metrics.MetricsRegistry())
    blk = pkg.heat.SLOT_BLOCK
    plane.observe(9, "slot", np.array([0, 5, blk + 1, -1, -1, 3 * blk]))
    assert plane.flush()
    assert set(plane.unit_masses(9, "slot")) == {("slot", 0), ("slot", 1),
                                                 ("slot", 3)}
    assert plane.region_stats(9)["touches"] == 4


def test_flag_off_is_inert(pkg):
    pkg.config.FLAGS.set("heat_enabled", False)
    assert not pkg.heat.heat_enabled()
    assert pkg.heat.HEAT.unit_masses(123) == {}
    assert pkg.heat.HEAT.region_stats(123) is None


# ---------------- the cost model ----------------

def test_kernel_id_equals_the_reference():
    for key in ((7, 10, (("nprobe", 8),)), (7, 10), "opaque",
                (3, 5, (("ef", 64), ("nprobe", 2)))):
        assert J.cost.kernel_id(key) == T.cost.kernel_id(key)
        assert J.cost.kernel_region(key) == T.cost.kernel_region(key)


def test_cost_estimates_equal_the_reference():
    rng = np.random.default_rng(3)
    notes = [(str(rng.choice(["cheap", "wide"])),
              int(rng.choice([4, 8, 32, 64])), float(rng.random() * 10))
             for _ in range(200)]
    est = {}
    for name, p in P.items():
        p.config.FLAGS.set("cost_enabled", True)
        p.config.FLAGS.set("cost_prior_row_ms", 0.5)
        model = p.cost.CostModel(p.metrics.MetricsRegistry())
        for kind, rows, ms in notes:
            model.note(kind, rows, ms, region_id=3)
        est[name] = ([model.estimate_run_ms(k, r)
                      for k in ("cheap", "wide", "other")
                      for r in (1, 4, 6, 8, 33, 64, 200)],
                     model.region_row_us(3))
    assert est["dingo_tpu_torch"] == est["dingo_tpu"]


def test_cost_model_interpolates_and_clamps(pkg):
    pkg.config.FLAGS.set("cost_enabled", True)
    model = pkg.cost.CostModel(pkg.metrics.MetricsRegistry())
    for _ in range(5):
        model.note("k", 32, 3.2)
    assert model.estimate_run_ms("k", 32) == pytest.approx(3.2)
    assert model.estimate_run_ms("k", 64) >= 3.2
    assert model.estimate_run_ms("k", 8) <= 3.2
    pkg.config.FLAGS.set("cost_prior_row_ms", 0.5)
    assert model.estimate_run_ms("other", 10) == pytest.approx(5.0)


def test_coalescer_cold_start_sheds_on_the_prior(pkg):
    """Before any sample the wait estimate is the prior, not 0; only with
    the cost model off does the 0.0 answer remain. A cold region under
    QoS therefore sheds a request whose budget the prior already spends,
    in both packages."""
    co = pkg.coalescer.SearchCoalescer(
        lambda key, q: [[] for _ in q], window_ms=1.0,
        **({"device": "cpu"} if pkg.torch else {}))
    f = pkg.config.FLAGS
    try:
        f.set("cost_enabled", True)
        f.set("cost_prior_row_ms", 0.5)
        assert co.estimated_wait_ms(8) == pytest.approx(8 * 0.5)
        f.set("qos_enabled", True)
        f.set("qos_max_queue_ms", 1000.0)
        qp = pkg.pressure
        budget = qp.Budget(2.0, "t", 1)        # 2 ms left, 8 rows = 4 ms
        rej = co._admission_reject(budget, 8, 5)
        assert isinstance(rej, qp.RequestShed)
        f.set("cost_enabled", False)
        assert co.estimated_wait_ms(8) == 0.0
        assert co._admission_reject(budget, 8, 5) is None
    finally:
        f.set("qos_enabled", False)
        co.stop()


def test_coalescer_feeds_the_cost_model(pkg):
    pkg.config.FLAGS.set("cost_enabled", True)
    key = (41, 10, (("nprobe", 4),))
    co = pkg.coalescer.SearchCoalescer(
        lambda k, q: (time.sleep(0.01), [[] for _ in q])[1], window_ms=1.0,
        **({"device": "cpu"} if pkg.torch else {}))
    try:
        co.submit(key, np.zeros((4, 8), np.float32)).result(timeout=30)
        kid = pkg.cost.kernel_id(key)
        deadline = time.monotonic() + 10.0
        while not pkg.cost.COST.has_model(kid) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert pkg.cost.COST.has_model(kid)
        assert pkg.cost.COST.estimate_run_ms(kid, 4) >= 5.0
        assert pkg.cost.COST.region_row_us(41) > 0.0
        assert co.estimated_wait_ms(4, key=key) >= 5.0
    finally:
        co.stop()


# ---------------- end to end through a live index ----------------

def _ivf_region(p, rid, n=2000, d=32, nlist=8, nprobe=4):
    b = p.base
    x = np.random.default_rng(7).standard_normal((n, d)).astype(np.float32)
    idx = p.new_index(rid, b.IndexParameter(
        index_type=b.IndexType.IVF_FLAT, dimension=d, ncentroids=nlist,
        default_nprobe=nprobe))
    idx.store.reserve(n)
    idx.upsert(np.arange(n, dtype=np.int64), x)
    idx.train()
    return idx, x


def test_ivf_heat_end_to_end(pkg):
    """Probed lists land in the sketch, the flag-off arm leaves the plane
    untouched, and the layout prices the working set."""
    idx, x = _ivf_region(pkg, 71)
    q = x[:16] + 0.01
    pkg.config.FLAGS.set("heat_enabled", False)
    idx.search(q, 5, nprobe=4)
    assert pkg.heat.HEAT.region_stats(71) is None
    pkg.config.FLAGS.set("heat_enabled", True)
    for _ in range(5):
        idx.search(q, 5, nprobe=4)
    assert pkg.heat.HEAT.flush()
    st = pkg.heat.HEAT.region_stats(71)
    assert st is not None and st["touches"] >= 5 * 16 * 4
    masses = pkg.heat.HEAT.unit_masses(71, "ivf")
    assert masses and all(0 <= u < 8 for (_, u) in masses)
    assert st["ws_bytes"][99] > 0


def test_heat_adds_no_fetch_and_no_new_shape_on_the_port(monkeypatch):
    """With heat on, the probed-list ids join the reply's one fetch group
    (one group, one more array) and the kernel sees no new shape."""
    import dingo_tpu_torch.index.ivf_flat as ivf_mod
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.ops import topk

    saved = {k: FLAGS.get(k) for k in ("use_pallas_ivf_search",
                                       "ivf_dim_block")}
    FLAGS.set("use_pallas_ivf_search", "True")
    FLAGS.set("ivf_dim_block", 8)
    groups = []
    real = topk.begin_host_fetch

    def spy(*arrays):
        groups.append(sum(a is not None for a in arrays))
        return real(*arrays)

    monkeypatch.setattr(ivf_mod, "begin_host_fetch", spy)
    try:
        idx, x = _ivf_region(T, 72)
        q = x[:16] + 0.01
        FLAGS.set("heat_enabled", False)
        idx.search(q, 5, nprobe=4)
        shapes = METRICS.counter("kernel.new_shapes")
        s0 = shapes.get()
        FLAGS.set("heat_enabled", True)
        idx.search(q, 5, nprobe=4)
        assert shapes.get() == s0
        # off: dists, slots, prune stats; on: the same plus the probes
        assert groups == [3, 4]
    finally:
        for k, v in saved.items():
            FLAGS.set(k, v)
