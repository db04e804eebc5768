"""The port's serving pipeline (common/pipeline.py and the coalescer's
pipelined arm) against the JAX package's, case by case from
tests/test_pipeline.py, each case run through both packages: the staging
ring's pow2 ladder and zero tail (byte-equal to the JAX ring's buffer),
``take`` identity, depth backpressure, a closed ring, the completion
lane's FIFO order and idempotent stop, drain and no-drain, and the
dispatch/resolve overlap.

Per family (FLAT, IVF_FLAT, IVF_PQ) and tier (fp32, bf16, sq8; IVF_PQ
fp32) at d 32, nlist 16: a JAX index is built and trained, carried to the
port through its snapshot (index_from_reference, device="cpu"), and both
answer the same 4-row requests through their coalescers. On the port the
pipelined arm equals the serial arm and a direct search bit for bit, with
no staged miss; against the JAX package's coalescer, ids are equal modulo
ties and distances within rtol 1e-4, atol 1e-3 (f32 sums in another
order). sq8 takes a dyadic codec (XLA's CPU backend fuses the JAX decode's
multiply and add; see tests/test_torch_precision.py).

Threads are ordered with threading.Event, every wait has a timeout."""

import threading
import time
import types

import numpy as np
import pytest
import torch

from dingo_tpu.common import coalescer as jco
from dingo_tpu.common import pipeline as jpipe
from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.index.base import IndexParameter as JParam
from dingo_tpu.index.base import IndexType as JType
from dingo_tpu.index.flat import TpuFlat as JFlat
from dingo_tpu.index.ivf_flat import TpuIvfFlat as JIvf
from dingo_tpu.index.ivf_pq import TpuIvfPq as JPq
from dingo_tpu.ops import sq as jsq
from dingo_tpu_torch.common import coalescer as tco
from dingo_tpu_torch.common import pipeline as tpipe
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.common.metrics import METRICS as TMETRICS
from dingo_tpu_torch.index.base import IndexParameter as TParam
from dingo_tpu_torch.index.base import IndexType as TType
from dingo_tpu_torch.index.carry import index_from_reference

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

N, D, K, NLIST, NPROBE = 2000, 32, 10, 16, 8
RTOL, ATOL = 1e-4, 1e-3
DYADIC = jsq.SqParams(np.full(D, -4.0, np.float32),
                      np.full(D, 2.0 ** -5, np.float32))

#: each package's pipeline surface; the port's entry points take a device
PKGS = {
    "jax": types.SimpleNamespace(
        Ring=jpipe.StagingRing, Lane=jpipe.CompletionLane,
        Coalescer=jco.SearchCoalescer, Stopped=jco.CoalescerStopped,
        coalescer=jco, flags=JFLAGS, dev={},
        host=lambda qpad: np.asarray(qpad)),
    "torch": types.SimpleNamespace(
        Ring=tpipe.StagingRing, Lane=tpipe.CompletionLane,
        Coalescer=tco.SearchCoalescer, Stopped=tco.CoalescerStopped,
        coalescer=tco, flags=TFLAGS, dev={"device": "cpu"},
        host=lambda qpad: qpad.numpy()),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """One package's pipeline, its flags restored after the test."""
    p = PKGS[request.param]
    saved = {f: p.flags.get(f) for f in ("pipeline_enabled",
                                         "pipeline_depth")}
    p.flags.set("pipeline_enabled", "true")
    try:
        yield p
    finally:
        for f, v in saved.items():
            p.flags.set(f, v)


@pytest.fixture
def both_pipelined():
    saved = [(fl, fl.get("pipeline_enabled")) for fl in (JFLAGS, TFLAGS)]
    for fl, _ in saved:
        fl.set("pipeline_enabled", "true")
    try:
        yield
    finally:
        for fl, v in saved:
            fl.set("pipeline_enabled", v)


# ---------------- staging ring primitives -------------------------------

@pytest.mark.parametrize("rows", [1, 5, 8])
def test_staging_ring_pads_on_ladder_and_zero_tail_byte_equal(rows):
    """Both rings pad onto the pow2 ladder with a zeroed tail, and the
    port's upload is byte-equal to the JAX ring's buffer."""
    stacked = np.arange(rows * 4, dtype=np.float32).reshape(rows, 4) + 1
    jring, tring = jpipe.StagingRing(depth=2), tpipe.StagingRing(
        depth=2, device="cpu")
    js, ts = jring.stage(stacked), tring.stage(stacked)
    jq, tq = js.take(stacked), ts.take(stacked)
    assert ts.rows == js.rows == rows
    assert tuple(tq.shape) == np.asarray(jq).shape \
        == (tpipe._next_pow2(rows), 4)
    host = tq.numpy()
    assert np.array_equal(host[:rows], stacked)
    assert not host[rows:].any()
    assert host.tobytes() == np.asarray(jq).tobytes()
    # the slot is reused and re-zeroed: a shorter batch after a longer one
    js.release()
    ts.release()
    short = stacked[:1] * 2
    js, ts = jring.stage(short), tring.stage(short)
    assert ts.take(short).numpy().tobytes() == \
        np.asarray(js.take(short)).tobytes()
    js.release()
    ts.release()


def test_staged_batch_take_identity(pkg):
    ring = pkg.Ring(depth=1, **pkg.dev)
    stacked = np.ones((2, 4), np.float32)
    staged = ring.stage(stacked)
    # the exact staged array claims the upload; a copy (what a dtype
    # rebind in _prep_queries produces) does not
    assert staged.take(stacked) is not None
    assert staged.take(stacked.copy()) is None
    assert staged.take(np.asarray(stacked, np.float64)) is None
    staged.release()
    staged.release()  # idempotent


def test_staging_ring_depth_backpressure(pkg):
    ring = pkg.Ring(depth=2, **pkg.dev)
    a = ring.stage(np.zeros((1, 4), np.float32))
    b = ring.stage(np.zeros((1, 4), np.float32))
    third_in = threading.Event()

    def third():
        s = ring.stage(np.zeros((1, 4), np.float32))
        third_in.set()
        s.release()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not third_in.wait(timeout=0.3)   # both slots leased: blocked
    a.release()
    assert third_in.wait(timeout=5)         # a release unblocks the ring
    b.release()
    t.join(timeout=5)
    assert not t.is_alive()


def test_staging_ring_closed_raises(pkg):
    ring = pkg.Ring(depth=1, **pkg.dev)
    ring.close()
    with pytest.raises(RuntimeError, match="closed"):
        ring.stage(np.zeros((1, 4), np.float32))


def test_staging_ring_returns_slot_when_fill_fails():
    """A stage() that raises after taking a slot hands it back (the port
    only: the JAX ring keeps the slot)."""
    ring = tpipe.StagingRing(depth=1, device="cpu")
    with pytest.raises(TypeError):
        ring.stage(np.zeros((1, 4), np.complex64).astype(object))
    s = ring.stage(np.zeros((1, 4), np.float32))
    s.release()


def test_ring_without_device_needs_cuda(monkeypatch):
    from dingo_tpu_torch.common.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        tpipe.StagingRing(depth=2)
    with pytest.raises(DeviceUnavailable):
        tco.SearchCoalescer(lambda k, q: [])


def test_completion_lane_fifo_and_stop_idempotent(pkg):
    done = []

    class H:
        def __init__(self, tag):
            self.tag = tag

        def resolve(self):
            done.append(self.tag)

        def abandon(self):  # pragma: no cover
            done.append(("abandon", self.tag))

    lane = pkg.Lane(name="test-lane")
    for i in range(5):
        assert lane.submit(H(i))
    lane.stop(drain=True)
    assert done == [0, 1, 2, 3, 4]
    assert not lane.submit(H(9))    # a stopped lane refuses handoffs
    lane.stop(drain=True)           # idempotent


# ---------------- dispatch/resolve overlap and stage totals -------------

class _FrozenClock:
    """The time module with monotonic() held at one instant."""

    def __init__(self, now):
        self.now = now

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_dispatch_overlap_ordering(pkg, monkeypatch):
    """Both due batches dispatch before either resolves, and the lane
    resolves them in dispatch order.

    Both batches take one creation instant (the coalescer module's clock
    is held across the two submits), so "b" is due in the sweep that
    finds "a" due, however long the submits take apart: with each
    batch's own instant, a gap between them longer than the flush
    thread's wake-up delay put "b" in a later sweep, after "a" had
    resolved."""
    events = []
    guard = threading.Lock()

    def run(key, stacked):  # pragma: no cover — pipelined arm only
        raise AssertionError("serial arm must not run")

    def dispatch(key, stacked, staged=None):
        with guard:
            events.append(("dispatch", key))

        def thunk():
            with guard:
                events.append(("resolve", key))
            return [key] * len(stacked)

        return thunk

    co = pkg.Coalescer(run, window_ms=50.0, dispatch_fn=dispatch,
                       **pkg.dev)
    try:
        monkeypatch.setattr(pkg.coalescer, "time",
                            _FrozenClock(time.monotonic()))
        fa = co.submit("a", np.zeros((2, 4), np.float32))
        fb = co.submit("b", np.zeros((2, 4), np.float32))
        monkeypatch.setattr(pkg.coalescer, "time", time)
        assert fa.result(timeout=10) == ["a", "a"]
        assert fb.result(timeout=10) == ["b", "b"]
    finally:
        co.stop()
    order = {e: i for i, e in enumerate(events)}
    assert order[("dispatch", "a")] < order[("resolve", "a")]
    assert order[("dispatch", "b")] < order[("resolve", "a")], events
    assert order[("resolve", "a")] < order[("resolve", "b")]


def test_stage_totals_record_pipeline_stages(pkg):
    resolved = threading.Event()

    def dispatch(key, stacked, staged=None):
        def thunk():
            return list(range(len(stacked)))
        return thunk

    co = pkg.Coalescer(lambda k, s: list(range(len(s))), window_ms=5.0,
                       dispatch_fn=dispatch, **pkg.dev)
    try:
        fut = co.submit("k", np.zeros((2, 4), np.float32))
        fut.add_done_callback(lambda f: resolved.set())
        assert fut.result(timeout=10) == [0, 1]
        assert resolved.wait(timeout=10)
        # the lane books resolve before it fans out the results
        totals = co.stage_totals()
    finally:
        co.stop()
    assert "dispatch" in totals and "resolve" in totals, totals


# ---------------- shutdown contract on the lane -------------------------

def test_stop_drain_resolves_queued_handoffs(pkg):
    """stop(drain=True) while one handoff is mid-resolve and another is
    queued: every future gets its real results."""
    release = threading.Event()
    a_started = threading.Event()

    def dispatch(key, stacked, staged=None):
        def thunk():
            if key == "a":
                a_started.set()
                assert release.wait(timeout=10)
            return [key] * len(stacked)
        return thunk

    co = pkg.Coalescer(lambda k, s: [k] * len(s), window_ms=5.0,
                       dispatch_fn=dispatch, **pkg.dev)
    fa = co.submit("a", np.zeros((1, 4), np.float32))
    fb = co.submit("b", np.zeros((1, 4), np.float32))
    assert a_started.wait(timeout=10)
    stopper = threading.Thread(target=co.stop, kwargs={"drain": True})
    stopper.start()
    release.set()
    stopper.join(timeout=20)
    assert not stopper.is_alive()
    assert fa.result(timeout=10) == ["a"]
    assert fb.result(timeout=10) == ["b"]


def test_stop_nodrain_abandons_but_runs_fetch(pkg):
    """stop(drain=False): a queued handoff fails fast with
    CoalescerStopped, but its thunk still runs (device-side leases must be
    released); the one mid-resolve completes."""
    release = threading.Event()
    a_started = threading.Event()
    b_queued = threading.Event()
    ran = []

    def dispatch(key, stacked, staged=None):
        def thunk():
            if key == "a":
                a_started.set()
                assert release.wait(timeout=10)
            ran.append(key)
            return [key] * len(stacked)
        return thunk

    co = pkg.Coalescer(lambda k, s: [k] * len(s), window_ms=5.0,
                       dispatch_fn=dispatch, **pkg.dev)
    lane_submit = co._lane.submit

    def counting_submit(handoff):
        ok = lane_submit(handoff)
        if co._lane.depth() >= 2:
            b_queued.set()
        return ok

    co._lane.submit = counting_submit
    fa = co.submit("a", np.zeros((1, 4), np.float32))
    fb = co.submit("b", np.zeros((1, 4), np.float32))
    assert a_started.wait(timeout=10)
    assert b_queued.wait(timeout=10)        # b waits behind a on the lane
    stopper = threading.Thread(target=co.stop, kwargs={"drain": False})
    stopper.start()
    with pytest.raises(pkg.Stopped):
        fb.result(timeout=10)               # abandoned before a finished
    release.set()
    stopper.join(timeout=20)
    assert not stopper.is_alive()
    assert fa.result(timeout=10) == ["a"]   # mid-resolve completes
    assert "b" in ran                       # the fetch ran anyway


# ---------------- families x tiers: pipelined == serial, == JAX ---------

_FAMILIES = [
    ("flat", "fp32"), ("flat", "bf16"), ("flat", "sq8"),
    ("ivf_flat", "fp32"), ("ivf_flat", "bf16"), ("ivf_flat", "sq8"),
    ("ivf_pq", "fp32"),
]


def _corpus():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((16, D), dtype=np.float32)
    x = centers[rng.integers(0, 16, N)] + 0.3 * rng.standard_normal(
        (N, D), dtype=np.float32)
    q = x[:16] + 0.01 * rng.standard_normal((16, D), dtype=np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _pair(family, precision, tmp_path):
    """A trained JAX index and the port's copy, carried through the JAX
    snapshot."""
    x, q = _corpus()
    ids = np.arange(N, dtype=np.int64)
    kw = {"dimension": D}
    if family != "flat":
        kw.update(ncentroids=NLIST, default_nprobe=NPROBE)
    if family == "ivf_pq":
        kw["nsubvector"] = 8
    else:
        kw["precision"] = precision
    jtype = {"flat": JType.FLAT, "ivf_flat": JType.IVF_FLAT,
             "ivf_pq": JType.IVF_PQ}[family]
    ttype = {"flat": TType.FLAT, "ivf_flat": TType.IVF_FLAT,
             "ivf_pq": TType.IVF_PQ}[family]
    cls = {"flat": JFlat, "ivf_flat": JIvf, "ivf_pq": JPq}[family]
    j = cls(1, JParam(index_type=jtype, **kw))
    if precision == "sq8":
        j.store.set_params(DYADIC)
    j.add(ids, x)
    if family != "flat":
        j.train()
    j.save(str(tmp_path))
    t = index_from_reference(str(tmp_path), device="cpu", index_id=1,
                             parameter=TParam(index_type=ttype, **kw))
    return j, t, q


def _via_coalescer(p, idx, q, search_kw, chunks=4):
    """Submit q in `chunks`-row requests under distinct keys (the same
    batch composition in every arm) and flatten the per-query rows."""
    def run(key, stacked):
        return idx.search(stacked, K, **search_kw)

    def dispatch(key, stacked, staged=None):
        return idx.search_async(stacked, K, staged=staged, **search_kw)

    co = p.Coalescer(run, window_ms=5.0, dispatch_fn=dispatch, **p.dev)
    try:
        futs = [co.submit(i, q[i:i + chunks])
                for i in range(0, len(q), chunks)]
        return [r for f in futs for r in f.result(timeout=60)]
    finally:
        co.stop()


def _assert_bitwise_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g.ids), np.asarray(w.ids))
        assert np.asarray(g.distances, np.float32).tobytes() == \
            np.asarray(w.distances, np.float32).tobytes()


def _assert_close(jres, tres):
    """Distances within RTOL/ATOL; an id may differ only where its
    distance ties a neighbour's or at the last position."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a.ids) == len(b.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=RTOL,
                                   atol=ATOL)
        for c in np.flatnonzero(np.asarray(a.ids) != np.asarray(b.ids)):
            near = [b.distances[c2] for c2 in (c - 1, c + 1)
                    if 0 <= c2 < len(b.ids)]
            assert c == len(b.ids) - 1 or any(
                abs(b.distances[c] - v) <= ATOL for v in near), c


@pytest.mark.parametrize("family,precision", _FAMILIES)
def test_pipelined_byte_identical_and_matches_jax(both_pipelined, tmp_path,
                                                  family, precision):
    """The port's pipelined arm (overlapped dispatch, staged upload, lane
    resolve) returns bit-equal ids and distances against its serial arm
    and a direct per-chunk search, claims every staged upload, and agrees
    with the JAX package's coalescer."""
    j, t, q = _pair(family, precision, tmp_path)
    kw = {} if family == "flat" else {"nprobe": NPROBE}
    direct = [r for i in range(0, len(q), 4)
              for r in t.search(q[i:i + 4], K, **kw)]
    p = PKGS["torch"]
    TFLAGS.set("pipeline_enabled", "false")
    serial = _via_coalescer(p, t, q, kw)
    TFLAGS.set("pipeline_enabled", "true")
    miss = TMETRICS.counter("pipeline.staged_miss").get()
    pipelined = _via_coalescer(p, t, q, kw)
    assert TMETRICS.counter("pipeline.staged_miss").get() == miss
    _assert_bitwise_equal(serial, direct)
    _assert_bitwise_equal(pipelined, direct)
    _assert_close(_via_coalescer(PKGS["jax"], j, q, kw), pipelined)


def test_depth_ladder_identical(both_pipelined, tmp_path):
    """Depths 1, 2 and 4 return the same bytes (the ring pads on the same
    ladder as _pad_batch)."""
    _, t, q = _pair("flat", "fp32", tmp_path)
    saved = TFLAGS.get("pipeline_depth")
    try:
        baseline = None
        for depth in (1, 2, 4):
            TFLAGS.set("pipeline_depth", depth)
            rows = _via_coalescer(PKGS["torch"], t, q, {})
            if baseline is None:
                baseline = rows
            else:
                _assert_bitwise_equal(rows, baseline)
    finally:
        TFLAGS.set("pipeline_depth", saved)


def test_cosine_queries_miss_the_staged_slot(both_pipelined):
    """IVF_FLAT COSINE normalizes its queries in _prep_queries, so the
    staged array is rebound: the family pads and uploads itself, the miss
    is counted, and the results equal the serial arm's."""
    from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat
    from dingo_tpu_torch.ops.distance import Metric

    x, q = _corpus()
    t = TpuIvfFlat(3, TParam(index_type=TType.IVF_FLAT, dimension=D,
                             metric=Metric.COSINE, ncentroids=NLIST),
                   device="cpu")
    t.upsert(np.arange(N, dtype=np.int64), x)
    t.train()
    kw = {"nprobe": NPROBE}
    TFLAGS.set("pipeline_enabled", "false")
    serial = _via_coalescer(PKGS["torch"], t, q, kw)
    TFLAGS.set("pipeline_enabled", "true")
    miss = TMETRICS.counter("pipeline.staged_miss").get()
    pipelined = _via_coalescer(PKGS["torch"], t, q, kw)
    assert TMETRICS.counter("pipeline.staged_miss").get() == miss + 4
    _assert_bitwise_equal(pipelined, serial)
