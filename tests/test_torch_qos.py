"""QoS admission of the port (obs/pressure.py and the coalescer's QoS arm)
against the JAX package's, case by case from tests/test_qos.py, each case
run through both packages: the Budget's metadata round trip, the
no-budget pass-through, malformed headers and the default deadline;
rejection at admission with no run, expiry in queue, expiry at the real
dispatch of the pipelined arm, the dispatch stage's accounting, hopeless
and priority-pressure shed, the wait estimate over displaced batches, the
tenant cap, the degrade policy that never drops, queue depth released on
stop, priority-mixed batches answering each caller with its own rows and
no new kernel shape (the JAX package: no recompile), and the 2-bucket
watermark. One budget sequence gives the same decisions and touches the
same ``qos.*`` series in both packages.

The port has no per-shape cost model yet, so the JAX side runs with
``cost_enabled`` off wherever the wait estimate decides. The degrade
ladder (ShedController) and the SLO tuner are not ported yet; their cases
stay in tests/test_qos.py."""

import time
import types

import numpy as np
import pytest
import torch

from dingo_tpu.common import coalescer as jco
from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.common.metrics import METRICS as JMETRICS
from dingo_tpu.obs import pressure as jqp
from dingo_tpu_torch.common import coalescer as tco
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.common.metrics import METRICS as TMETRICS
from dingo_tpu_torch.obs import pressure as tqp

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(co=jco, qp=jqp, flags=JFLAGS,
                                 metrics=JMETRICS, dev={}),
    "torch": types.SimpleNamespace(co=tco, qp=tqp, flags=TFLAGS,
                                   metrics=TMETRICS, dev={"device": "cpu"}),
}
_FLAGS = ("qos_enabled", "qos_shed_policy", "qos_max_queue_ms",
          "qos_tenant_queue_rows", "qos_default_deadline_ms",
          "pipeline_enabled")


def _qos_on(p):
    """Set QoS on in one package; returns the saved flags."""
    saved = {f: p.flags.get(f) for f in _FLAGS}
    if p.flags is JFLAGS:
        saved["cost_enabled"] = JFLAGS.get("cost_enabled")
        JFLAGS.set("cost_enabled", False)
    p.flags.set("qos_enabled", True)
    return saved


def _restore(p, saved):
    for f, v in saved.items():
        p.flags.set(f, v)
    p.qp.PRESSURE.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """One package with QoS on; every flag it twists is restored."""
    p = PKGS[request.param]
    saved = _qos_on(p)
    try:
        yield p
    finally:
        _restore(p, saved)


def _make(p, run, **kw):
    return p.co.SearchCoalescer(run, **kw, **p.dev)


def _submit(p, co, rows, budget, **kw):
    token = p.qp.attach_budget(budget)
    try:
        return co.submit("k", np.zeros((rows, 4), np.float32), **kw)
    finally:
        p.qp.detach_budget(token)


# -------------------- budget metadata --------------------------------------

def test_budget_metadata_round_trip(pkg):
    qp = pkg.qp
    with qp.budget_scope(5000.0, tenant="acme", priority=2):
        md = qp.inject_budget_metadata([("other-header", "kept")])
    pairs = dict(md)
    assert pairs["other-header"] == "kept"
    assert 0.0 < float(pairs[qp.DEADLINE_METADATA_KEY]) <= 5000.0
    assert pairs["x-dingo-tenant"] == "acme"
    assert pairs["x-dingo-priority"] == "2"
    b = qp.extract_budget_metadata(md)
    assert b is not None
    assert b.tenant == "acme" and b.priority == 2
    assert 0.0 < b.remaining_ms() <= 5000.0 and not b.expired()


def test_budget_metadata_no_budget_allocates_nothing(pkg):
    assert pkg.qp.inject_budget_metadata(None) is None
    assert pkg.qp.inject_budget_metadata([("k", "v")]) == [("k", "v")]


def test_budget_metadata_malformed_and_defaults(pkg):
    qp = pkg.qp
    pkg.flags.set("qos_enabled", False)
    assert qp.extract_budget_metadata(
        [(qp.DEADLINE_METADATA_KEY, "bogus")]) is None
    # a disabled server still adopts a well-formed header
    b = qp.extract_budget_metadata([(qp.DEADLINE_METADATA_KEY, "120.5")])
    assert b is not None and 0.0 < b.remaining_ms() <= 120.5
    # qos_enabled grants the configured default to headerless requests
    pkg.flags.set("qos_enabled", True)
    pkg.flags.set("qos_default_deadline_ms", 300.0)
    b = qp.extract_budget_metadata([])
    assert b is not None and 0.0 < b.remaining_ms() <= 300.0
    pkg.flags.set("qos_default_deadline_ms", 0.0)
    assert qp.extract_budget_metadata([]) is None


# -------------------- admission and expiry ----------------------------------

def test_expired_at_admission_is_rejected_before_queueing(pkg):
    ran = []
    co = _make(pkg, lambda k, q: ran.append(len(q)) or list(range(len(q))),
               window_ms=5.0)
    series = dict(name="qos.expired", region_id=77,
                  labels={"tenant": "default", "priority": "1",
                          "where": "admission"})
    try:
        expired0 = pkg.metrics.counter(**series).get()
        fut = _submit(pkg, co, 2, pkg.qp.Budget(-1.0), region_id=77)
        with pytest.raises(pkg.qp.DeadlineExceeded):
            fut.result(timeout=5)
        assert pkg.metrics.counter(**series).get() == expired0 + 1
    finally:
        co.stop(drain=True)
    assert ran == []                        # nothing ever ran


def test_expiry_in_queue_skips_kernel_entirely(pkg):
    """A batch of only dead entries runs nothing: the budget died while
    the request sat inside the window."""
    ran = []
    co = _make(pkg, lambda k, q: ran.append(len(q)) or list(range(len(q))),
               window_ms=60.0)
    try:
        fut = _submit(pkg, co, 1, pkg.qp.Budget(10.0), region_id=78)
        with pytest.raises(pkg.qp.DeadlineExceeded,
                           match="expired in queue"):
            fut.result(timeout=5)
    finally:
        co.stop(drain=True)
    assert ran == []


def test_pipelined_expiry_checked_at_real_dispatch(pkg):
    """A cap-displaced batch waits in the ready queue for the timer
    thread; on the pipelined arm expiry runs at the real dispatch, so a
    budget that died there never reaches dispatch_fn."""
    pkg.flags.set("pipeline_enabled", "true")
    dispatched = []

    def dispatch(key, stacked, staged=None):
        dispatched.append(len(stacked))
        return lambda: list(range(len(stacked)))

    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=10_000.0,
               max_batch=4, dispatch_fn=dispatch)
    try:
        doomed_budget = pkg.qp.Budget(20.0)
        doomed = _submit(pkg, co, 2, doomed_budget, region_id=79)
        deadline = time.monotonic() + 5
        while not doomed_budget.expired() and time.monotonic() < deadline:
            time.sleep(0.002)                # the clock is what is tested
        # displace the pending batch to the ready queue: 2 + 4 > cap 4
        live = _submit(pkg, co, 4, pkg.qp.Budget(60_000.0), region_id=79)
        with pytest.raises(pkg.qp.DeadlineExceeded,
                           match="expired in queue"):
            doomed.result(timeout=5)
        assert 2 not in dispatched, dispatched
        assert len(live.result(timeout=5)) == 4
    finally:
        co.stop()


def test_pipelined_dispatch_stage_accounted(pkg):
    """The pipelined flush books its enqueue cost under the 'dispatch'
    stage of the per-stage budget accounting."""
    pkg.flags.set("pipeline_enabled", "true")

    def dispatch(key, stacked, staged=None):
        return lambda: list(range(len(stacked)))

    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=5.0,
               dispatch_fn=dispatch)
    rec = pkg.metrics.latency("qos.stage_budget_pct",
                              labels={"stage": "dispatch"})
    stage0 = rec.stats()["count"]
    try:
        fut = _submit(pkg, co, 2, pkg.qp.Budget(10_000.0))
        assert len(fut.result(timeout=5)) == 2
    finally:
        co.stop(drain=True)      # joins the lane: its accounting is done
    assert rec.stats()["count"] > stage0


def test_admission_shed_hopeless_and_priority_pressure(pkg):
    qp = pkg.qp
    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=5.0)
    try:
        # a measured service rate: ~100 ms estimated wait and run
        co._ewma_row_ms = 50.0
        co._ewma_run_ms = 50.0
        pkg.flags.set("qos_max_queue_ms", 80.0)
        with pytest.raises(qp.RequestShed, match="remaining"):
            _submit(pkg, co, 1, qp.Budget(40.0)).result(timeout=5)
        with pytest.raises(qp.RequestShed, match="pressure|bound"):
            _submit(pkg, co, 1, qp.Budget(60_000.0, priority=1)
                    ).result(timeout=5)
        # interactive (>= 2) is exempt from pressure shed
        assert len(_submit(pkg, co, 1, qp.Budget(60_000.0, priority=2)
                           ).result(timeout=5)) == 1
        # batch/background (0) sheds at half the bound (re-pin the EWMA:
        # the served request updated it with a real, tiny run time)
        co._ewma_row_ms = 50.0
        co._ewma_run_ms = 50.0
        pkg.flags.set("qos_max_queue_ms", 150.0)
        with pytest.raises(qp.RequestShed, match="priority 0"):
            _submit(pkg, co, 1, qp.Budget(60_000.0, priority=0)
                    ).result(timeout=5)
        assert len(_submit(pkg, co, 1, qp.Budget(60_000.0, priority=1)
                           ).result(timeout=5)) == 1
    finally:
        co.stop()


def test_estimated_wait_counts_displaced_ready_batches(pkg):
    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=10_000.0)
    try:
        co._ewma_row_ms = 2.0
        co._ewma_run_ms = 10.0

        class _Rows:
            queries = np.zeros((8, 4), np.float32)

        displaced = pkg.co._PendingBatch()
        displaced.entries.append(_Rows())
        with co._lock:
            co._ready.append(("k", displaced))
        assert co.estimated_wait_ms() == 8 * 2.0 + 10.0
        with co._lock:
            co._ready.clear()
    finally:
        co.stop()


def test_admission_shed_tenant_queue_cap(pkg):
    qp = pkg.qp
    pkg.flags.set("qos_tenant_queue_rows", 4)
    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=10_000.0)
    try:
        first = _submit(pkg, co, 4, qp.Budget(60_000.0, tenant="greedy"))
        over = _submit(pkg, co, 1, qp.Budget(60_000.0, tenant="greedy"))
        with pytest.raises(qp.RequestShed, match="tenant greedy over"):
            over.result(timeout=5)
        # another tenant is not charged for greedy's share
        ok = _submit(pkg, co, 1, qp.Budget(60_000.0, tenant="polite"))
        assert not ok.done()
        co.stop(drain=True)
        assert len(first.result(timeout=5)) == 4
        assert len(ok.result(timeout=5)) == 1
    finally:
        co.stop()


def test_degrade_policy_never_drops_requests(pkg):
    """'degrade' is knob-ladder only: neither admission nor the flush-time
    hopeless arm fails a live request."""
    pkg.flags.set("qos_shed_policy", "degrade")
    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=5.0)
    try:
        co._ewma_row_ms = 50.0
        co._ewma_run_ms = 50.0
        fut = _submit(pkg, co, 1, pkg.qp.Budget(5_000.0))
        assert len(fut.result(timeout=5)) == 1   # served, not shed
    finally:
        co.stop()


def test_stop_no_drain_releases_queue_depth(pkg):
    """Discarded entries leave no phantom queue depth."""
    pkg.qp.PRESSURE.reset()
    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=10_000.0)
    fut = _submit(pkg, co, 3, pkg.qp.Budget(60_000.0), region_id=79)
    assert pkg.qp.PRESSURE.region_stats(79)["queue_depth"] == 3
    co.stop(drain=False)
    with pytest.raises(Exception):
        fut.result(timeout=5)
    assert pkg.qp.PRESSURE.region_stats(79)["queue_depth"] == 0


def test_watermark_two_bucket_rolling_window(pkg):
    rp = pkg.qp._RegionPressure()
    rp.note_wait(12.0, now=100.0)
    assert rp.recent_watermark(100.1) == 12.0
    rp.note_wait(5.0, now=105.0)                 # next bucket
    assert rp.recent_watermark(105.1) == 12.0    # previous max still seen
    assert rp.recent_watermark(112.0) == 5.0     # old bucket aged out
    assert rp.recent_watermark(120.0) == 0.0


# -------------------- through an index --------------------------------------

def _ivf_pair(n=256, d=16, nlist=8, seed=0):
    from dingo_tpu.index import IndexParameter as JParam
    from dingo_tpu.index import IndexType as JType
    from dingo_tpu.index import new_index as jnew
    from dingo_tpu_torch.index.base import IndexParameter as TParam
    from dingo_tpu_torch.index.base import IndexType as TType
    from dingo_tpu_torch.index.factory import new_index as tnew

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    j = jnew(9400, JParam(index_type=JType.IVF_FLAT, dimension=d,
                          ncentroids=nlist, default_nprobe=nlist))
    t = tnew(9400, TParam(index_type=TType.IVF_FLAT, dimension=d,
                          ncentroids=nlist, default_nprobe=nlist),
             device="cpu")
    for idx in (j, t):
        idx.upsert(ids, x)
        idx.train()
    return {"jax": j, "torch": t}, x


def _shape_count(name):
    """Lifetime count of new compiled shapes (JAX: recompiles) or new
    kernel shapes (the port's sentinel)."""
    if name == "jax":
        return JMETRICS.counter("xla.recompiles").get()
    from dingo_tpu_torch.obs.sentinel import SENTINEL

    return SENTINEL.new_shapes()


def test_priority_mixed_batching_each_caller_gets_own_rows():
    """Priority batch forming reorders entries inside a batch: every
    caller still gets its own rows, and once the pow2 ladder is warm no
    batch mints a new shape (the port's kernel wrapper B2 on its plain
    route; the JAX package's jitted programs)."""
    idxs, x = _ivf_pair()
    k, max_batch = 5, 16
    saved_t = TFLAGS.get("use_pallas_ivf_search")
    TFLAGS.set("use_pallas_ivf_search", True)
    try:
        for name in ("jax", "torch"):
            p, idx = PKGS[name], idxs[name]
            saved = _qos_on(p)
            try:
                for b in (1, 2, 4, 8, 16):      # warm the ladder
                    idx.search(x[:b], k, nprobe=8)
                shapes0 = _shape_count(name)

                def run(key, stacked, idx=idx):
                    return idx.search(np.asarray(stacked), k, nprobe=8)

                co = _make(p, run, window_ms=15.0, max_batch=max_batch)
                try:
                    futs = []
                    for i in range(24):
                        token = p.qp.attach_budget(p.qp.Budget(
                            30_000.0, tenant=f"t{i % 2}", priority=i % 3))
                        try:
                            futs.append((i, co.submit("k", x[[i]],
                                                      region_id=9400)))
                        finally:
                            p.qp.detach_budget(token)
                    for i, fut in futs:
                        rows = fut.result(timeout=30)
                        assert len(rows) == 1
                        assert int(rows[0].ids[0]) == i, name
                finally:
                    co.stop()
                assert _shape_count(name) == shapes0, name
            finally:
                _restore(p, saved)
    finally:
        TFLAGS.set("use_pallas_ivf_search", saved_t)


def test_expired_budget_through_the_service_launches_nothing():
    """The port's entry point: a request whose budget is spent gets
    DeadlineExceeded and no kernel wrapper is called (sentinel calls
    flat), while a live one is served and counted served in its deadline
    (the reference service's on_served)."""
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.obs.sentinel import SENTINEL
    from dingo_tpu_torch.server.services import IndexService
    from torch_region_util import node_over_wrapper

    idxs, x = _ivf_pair()
    t = idxs["torch"]
    w = VectorIndexWrapper(9400, t.parameter, device="cpu")
    w.set_own(t)
    p = PKGS["torch"]
    saved = _qos_on(p)
    saved_t = TFLAGS.get("use_pallas_ivf_search")
    TFLAGS.set("use_pallas_ivf_search", True)
    node = node_over_wrapper(w, np.arange(len(x)), x, keys=(9400,))
    svc = IndexService(node, window_ms=2.0)
    served = TMETRICS.counter("qos.served_in_deadline", region_id=9400)
    served0 = served.get()
    try:
        with p.qp.budget_scope(60_000.0):
            rows = svc.submit(9400, x[[3]], 5, nprobe=8).result(timeout=30)
        assert rows[0][0].id == 3
        calls0 = sum(e["calls"] for e in SENTINEL.state().values())
        with p.qp.budget_scope(-1.0):
            fut = svc.submit(9400, x[[3]], 5, nprobe=8)
        with pytest.raises(p.qp.DeadlineExceeded):
            fut.result(timeout=5)
        assert sum(e["calls"] for e in SENTINEL.state().values()) == calls0
    finally:
        # joins the flush thread: the live reply's done-callback has run
        svc.close()
        TFLAGS.set("use_pallas_ivf_search", saved_t)
        _restore(p, saved)
    assert served.get() == served0 + 1


# -------------------- the same decisions in both packages -------------------

#: (rows, deadline_ms, tenant, priority): live, dead on arrival, hopeless
#: against the pinned service rate, tenant over its cap, priority pressure
_BUDGETS = [(1, 60_000.0, "a", 1), (2, -1.0, "a", 1), (1, 40.0, "b", 1),
            (3, 60_000.0, "a", 2), (2, 60_000.0, "a", 2),
            (1, 60_000.0, "b", 0), (1, 60_000.0, "c", 1),
            (1, 60_000.0, "c", 2), (2, -5.0, "c", 0)]


def _decisions(p, region_id):
    saved = _qos_on(p)
    p.flags.set("qos_tenant_queue_rows", 4)
    p.flags.set("qos_max_queue_ms", 120.0)
    before = p.metrics.dump()
    co = _make(p, lambda k, q: list(range(len(q))), window_ms=60_000.0)
    try:
        co._ewma_row_ms = 10.0
        co._ewma_run_ms = 50.0
        futs = [_submit(p, co, rows, p.qp.Budget(ms, tenant, prio),
                        region_id=region_id)
                for rows, ms, tenant, prio in _BUDGETS]
        co.stop(drain=True)
        out = []
        for f in futs:
            exc = f.exception(timeout=10)
            out.append(type(exc).__name__ if exc else len(f.result()))
    finally:
        co.stop()
        _restore(p, saved)
    return out, _touched(before, p.metrics.dump(), region_id)


def _touched(before, after, region_id):
    """qos.* series this run moved: of this region, or without a region
    (a latency series moves when its count does)."""
    def val(v):
        return v["count"] if isinstance(v, dict) else v

    return {k for k, v in after.items()
            if k.startswith("qos.")
            and ("region=" not in k or f"region={region_id}" in k)
            and (k not in before or val(before[k]) != val(v))}


def test_same_budget_sequence_same_decisions_and_series():
    jd, js = _decisions(PKGS["jax"], 9501)
    td, ts = _decisions(PKGS["torch"], 9501)
    assert td == jd
    assert "RequestShed" in td and "DeadlineExceeded" in td and 1 in td
    assert ts == js
    assert any(k.startswith("qos.shed{") for k in ts)
