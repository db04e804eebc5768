"""The port's SearchCoalescer against the JAX package's, case by case from
tests/test_coalescer.py (all but the service-layer case, which needs the
gRPC server), each case run through both packages: coalescing inside the
window, distinct keys, the max_batch flush, run errors, the per-submit cap,
a cap-displaced batch that does not block its submitter, submit racing
stop (plain and QoS, serial and pipelined) and pending batches drained on
stop. Batch forming is held equal across the packages: one submit sequence
with max_batch-triggered flushes (the window never expires) forms the same
batches in both. The port's ``IndexService`` binding runs a wrapper's
search and search_async through the coalescer.

Threads are ordered with threading.Event and barriers; every wait has a
timeout."""

import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dingo_tpu.common import coalescer as jco
from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu_torch.common import coalescer as tco
from dingo_tpu_torch.common.config import FLAGS as TFLAGS

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(Coalescer=jco.SearchCoalescer,
                                 Stopped=jco.CoalescerStopped,
                                 flags=JFLAGS, dev={}),
    "torch": types.SimpleNamespace(Coalescer=tco.SearchCoalescer,
                                   Stopped=tco.CoalescerStopped,
                                   flags=TFLAGS, dev={"device": "cpu"}),
}
_FLAGS = ("qos_enabled", "pipeline_enabled")


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """One package's coalescer; the flags a case twists are restored."""
    p = PKGS[request.param]
    saved = {f: p.flags.get(f) for f in _FLAGS}
    try:
        yield p
    finally:
        for f, v in saved.items():
            p.flags.set(f, v)


def _make(p, run, **kw):
    return p.Coalescer(run, **kw, **p.dev)


def test_coalesces_within_window(pkg):
    calls = []

    def run(key, stacked):
        calls.append(len(stacked))
        return [("row", key, float(q.sum())) for q in stacked]

    co = _make(pkg, run, window_ms=20.0)
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [
                pool.submit(
                    lambda i=i: co.submit(
                        "k", np.full((2, 4), i, np.float32)
                    ).result(timeout=5)
                )
                for i in range(8)
            ]
            results = [f.result(timeout=10) for f in futs]
        assert sum(calls) == 16
        assert len(calls) <= 3, calls
        for i, rows in enumerate(results):
            assert len(rows) == 2
            assert all(r[2] == float(i * 4) for r in rows)
    finally:
        co.stop()


def test_distinct_keys_do_not_mix(pkg):
    seen = {}

    def run(key, stacked):
        seen.setdefault(key, 0)
        seen[key] += len(stacked)
        return [key] * len(stacked)

    co = _make(pkg, run, window_ms=10.0)
    try:
        f1 = co.submit("a", np.zeros((3, 2), np.float32))
        f2 = co.submit("b", np.zeros((2, 2), np.float32))
        assert f1.result(timeout=5) == ["a"] * 3
        assert f2.result(timeout=5) == ["b"] * 2
        assert seen == {"a": 3, "b": 2}
    finally:
        co.stop()


def test_max_batch_flushes_immediately(pkg):
    calls = []

    def run(key, stacked):
        calls.append(len(stacked))
        return list(range(len(stacked)))

    co = _make(pkg, run, window_ms=10_000.0, max_batch=4)
    try:
        f = co.submit("k", np.zeros((4, 2), np.float32))
        # a full batch runs inline: done when submit returns, no window
        assert f.done()
        f.result(timeout=5)
        assert calls == [4]
    finally:
        co.stop()


def test_run_errors_propagate_to_all_waiters(pkg):
    def run(key, stacked):
        raise ValueError("boom")

    co = _make(pkg, run, window_ms=5.0)
    try:
        f1 = co.submit("k", np.zeros((1, 2), np.float32))
        f2 = co.submit("k", np.zeros((1, 2), np.float32))
        for f in (f1, f2):
            with pytest.raises(ValueError, match="boom"):
                f.result(timeout=5)
    finally:
        co.stop()


def test_per_submit_cap_splits_batches(pkg):
    """Merged batches never exceed the per-key cap each request respects
    alone."""
    calls = []

    def run(key, stacked):
        calls.append(len(stacked))
        return list(range(len(stacked)))

    co = _make(pkg, run, window_ms=50.0, max_batch=1024)
    try:
        f1 = co.submit("k", np.zeros((6, 2), np.float32), max_batch=8)
        f2 = co.submit("k", np.zeros((6, 2), np.float32), max_batch=8)
        assert len(f1.result(timeout=5)) == 6
        assert len(f2.result(timeout=5)) == 6
        assert all(c <= 8 for c in calls), calls
    finally:
        co.stop()


def test_cap_displaced_batch_does_not_block_submitter(pkg):
    """A submit that displaces a full previous batch does not run that
    batch inline: the displaced batch flushes elsewhere while the new
    caller's submit returns at once."""
    release = threading.Event()
    started = threading.Event()

    def run(key, stacked):
        if len(stacked) == 6:          # the displaced batch
            started.set()
            assert release.wait(5)
        return list(range(len(stacked)))

    # the window cannot expire between the two submits
    co = _make(pkg, run, window_ms=10_000.0, max_batch=1024)
    try:
        f1 = co.submit("k", np.zeros((6, 2), np.float32), max_batch=8)
        f2 = co.submit("k", np.zeros((4, 2), np.float32), max_batch=8)
        # the second submit returned while the displaced run is blocked
        assert started.wait(5)
        assert not f1.done()
        release.set()
        assert len(f1.result(timeout=5)) == 6
        co.stop(drain=True)
        assert len(f2.result(timeout=5)) == 4
    finally:
        release.set()
        co.stop()


def _race(pkg, submitters, per, trial, drain, **kw):
    start = threading.Barrier(submitters + 1)
    futs: list = []
    flock = threading.Lock()
    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=1.0, **kw)

    def submitter():
        start.wait(timeout=10)
        for _ in range(per):
            f = co.submit("k", np.zeros((1, 2), np.float32))
            with flock:
                futs.append(f)

    threads = [threading.Thread(target=submitter)
               for _ in range(submitters)]
    for t in threads:
        t.start()
    start.wait(timeout=10)
    # vary the interleaving: stop lands anywhere from before the first
    # submit to mid-storm
    time.sleep(0.0015 * trial)
    co.stop(drain=drain)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(futs) == submitters * per
    served = stopped = 0
    for f in futs:
        # every future resolves within a bound: a result or CoalescerStopped
        try:
            f.result(timeout=5)
            served += 1
        except pkg.Stopped:
            stopped += 1
    assert served + stopped == submitters * per


@pytest.mark.parametrize("qos", [False, True])
def test_submit_racing_stop_never_hangs(pkg, qos):
    """A submit racing stop(drain=False) gets a CoalescerStopped future,
    never a place in a queue nobody flushes (the QoS arm widens the window
    between the stop check and the append)."""
    pkg.flags.set("qos_enabled", qos)
    for trial in range(6):
        _race(pkg, 4, 40, trial, drain=False)


def test_pipelined_pending_batches_drain_on_stop(pkg):
    """stop(drain=True) before the window expires, pipelined: the pending
    batches still resolve to real results."""
    pkg.flags.set("pipeline_enabled", "true")

    def dispatch(key, stacked, staged=None):
        return lambda: list(range(len(stacked)))

    co = _make(pkg, lambda k, q: list(range(len(q))), window_ms=10_000.0,
               dispatch_fn=dispatch)
    futs = [co.submit("k", np.zeros((2, 4), np.float32))
            for _ in range(3)]
    co.stop(drain=True)
    for f in futs:
        assert len(f.result(timeout=5)) == 2


def test_pipelined_submit_stop_race_storm(pkg):
    """The submit-vs-stop contract holds with the pipelined arm on: every
    future resolves, on the flush thread or the completion lane."""
    pkg.flags.set("pipeline_enabled", "true")

    def dispatch(key, stacked, staged=None):
        return lambda: list(range(len(stacked)))

    for trial in range(6):
        _race(pkg, 3, 30, trial, drain=(trial % 2 == 0),
              dispatch_fn=dispatch)


def test_stop_drain_runs_pending(pkg):
    ran = []

    def run(key, stacked):
        ran.append(len(stacked))
        return list(range(len(stacked)))

    co = _make(pkg, run, window_ms=10_000.0)   # never expires alone
    fut = co.submit("k", np.zeros((3, 2), np.float32))
    co.stop(drain=True)
    assert fut.result(timeout=1) == [0, 1, 2]
    assert ran == [3]


def test_stop_no_drain_fails_futures_and_later_submits(pkg):
    def run(key, stacked):  # pragma: no cover — must not run
        raise AssertionError("must not run")

    co = _make(pkg, run, window_ms=10_000.0)
    fut = co.submit("k", np.zeros((3, 2), np.float32))
    co.stop(drain=False)
    with pytest.raises(pkg.Stopped):
        fut.result(timeout=1)
    late = co.submit("k", np.zeros((1, 2), np.float32))
    with pytest.raises(pkg.Stopped):
        late.result(timeout=1)


# ---------------- the same batches in both packages ---------------------

#: (key, rows, per-submit cap): full batches, cap displacement, a second
#: key, and leftovers drained by stop
_SEQUENCE = [("a", 3, 0), ("a", 5, 0), ("b", 2, 0), ("a", 4, 0),
             ("b", 7, 0), ("a", 1, 6), ("a", 6, 6), ("b", 8, 0),
             ("b", 3, 4), ("a", 8, 0), ("b", 1, 0), ("a", 2, 0)]


def _batches(p, qos):
    """The batches one package forms from _SEQUENCE at max_batch 8 with a
    window that never expires: (key, row tags) per run, sorted (displaced
    batches run on threads of their own)."""
    p.flags.set("qos_enabled", qos)
    formed = []
    lock = threading.Lock()

    def run(key, stacked):
        with lock:
            formed.append((key, tuple(int(v) for v in stacked[:, 0])))
        return [int(v) for v in stacked[:, 0]]

    co = _make(p, run, window_ms=60_000.0, max_batch=8)
    futs, tag = [], 0
    for key, rows, cap in _SEQUENCE:
        q = np.arange(tag, tag + rows, dtype=np.float32)[:, None] \
            * np.ones((1, 4), np.float32)
        futs.append((co.submit(key, q, max_batch=cap),
                     list(range(tag, tag + rows))))
        tag += rows
    co.stop(drain=True)
    for f, want in futs:
        assert f.result(timeout=10) == want
    return sorted(formed)


@pytest.mark.parametrize("qos", [False, True])
def test_same_submit_sequence_forms_same_batches(qos):
    # the port has no per-shape cost model: the JAX package's admission
    # estimate runs without it too
    saved = [(fl, f, fl.get(f)) for fl, f in (
        (JFLAGS, "qos_enabled"), (TFLAGS, "qos_enabled"),
        (JFLAGS, "cost_enabled"))]
    JFLAGS.set("cost_enabled", False)
    try:
        jb = _batches(PKGS["jax"], qos)
        tb = _batches(PKGS["torch"], qos)
    finally:
        for fl, f, v in saved:
            fl.set(f, v)
    assert tb == jb
    assert all(len(rows) <= 8 for _, rows in tb)


# ---------------- the port's entry point --------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
def test_index_service_serves_through_the_coalescer(pipelined):
    """IndexService binds run to the node's Storage.vector_batch_search
    and dispatch to its vector_batch_search_async(staged=...): concurrent
    requests of four regions (a MonoStoreEngine node whose regions own one
    wrapper) share batches and each caller gets the direct search's rows
    back."""
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.server.services import IndexService
    from torch_region_util import node_over_wrapper

    rng = np.random.default_rng(5)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    w = VectorIndexWrapper(1, IndexParameter(
        index_type=IndexType.IVF_FLAT, dimension=16, ncentroids=8),
        device="cpu")
    w.set_own(w.build_own())
    w.add(np.arange(1500, dtype=np.int64), x, 1)
    w.own_index.train()
    q = x[:32] + 0.01
    direct = [w.search(q[i:i + 4], 5, nprobe=4) for i in range(0, 32, 4)]
    saved = TFLAGS.get("pipeline_enabled")
    TFLAGS.set("pipeline_enabled", pipelined)
    node = node_over_wrapper(w, np.arange(1500), x, keys=(1, 2, 3, 4))
    svc = IndexService(node, window_ms=20.0, max_batch=64)
    miss = METRICS.counter("pipeline.staged_miss").get()
    try:
        futs = [svc.submit(1 + (i // 4) % 4, q[i:i + 4], 5, nprobe=4)
                for i in range(0, 32, 4)]
        got = [f.result(timeout=30) for f in futs]
        stages = svc._get_coalescer().stage_totals()
    finally:
        svc.close()
        TFLAGS.set("pipeline_enabled", saved)
    for g, want in zip(got, direct):
        for a, b in zip(g, want):
            assert [v.id for v in a] == b.ids.tolist()
            assert np.asarray([v.distance for v in a],
                              np.float32).tobytes() == b.distances.tobytes()
    assert METRICS.counter("pipeline.staged_miss").get() == miss
    assert ("dispatch" in stages) == pipelined


def test_index_service_window_zero_searches_directly():
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.server.services import IndexService
    from torch_region_util import node_over_wrapper

    x = np.random.default_rng(6).standard_normal((64, 8)).astype(np.float32)
    w = VectorIndexWrapper(1, IndexParameter(index_type=IndexType.FLAT,
                                             dimension=8), device="cpu")
    w.set_own(w.build_own())
    w.add(np.arange(64, dtype=np.int64), x, 1)
    node = node_over_wrapper(w, np.arange(64), x)
    svc = IndexService(node, window_ms=0.0)
    try:
        rows = svc.submit(1, x[:3], 1).result(timeout=5)
        assert [r[0].id for r in rows] == [0, 1, 2]
        assert svc._coalescer is None
        with pytest.raises(Exception, match="gone"):
            svc.submit(9, x[:1], 1).result(timeout=5)
    finally:
        svc.close()
