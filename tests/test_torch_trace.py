"""The port's tracer (dingo_tpu_torch/trace) against the JAX package's,
case by case from tests/test_trace.py, each case run through both
packages: the shared no-op span when unsampled, the span tree and buffer,
error status, the ``span.<name>`` latency bridge, the slow-query log (an
adopted ingress kept, the replication plane excluded), the bounded ring,
head sampling, metadata inject and extract with the same header, a remote
parent, the coalescer's span tree across its thread handoff (one trace,
co-batched traces linked), and the JSON and Chrome exports. The same
recorded spans give the same Chrome export in both packages, and spans
recorded the same way by both tracers have the same record schema."""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import dingo_tpu.trace as jtrace
from dingo_tpu.common import coalescer as jco
from dingo_tpu.common.config import FLAGS as JFLAGS
from dingo_tpu.common.metrics import METRICS as JMETRICS
import dingo_tpu_torch.trace as ttrace
from dingo_tpu_torch.common import coalescer as tco
from dingo_tpu_torch.common.config import FLAGS as TFLAGS
from dingo_tpu_torch.common.metrics import METRICS as TMETRICS

# one intra-op thread keeps the parallel test workers from oversubscribing
torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(tr=jtrace, co=jco, flags=JFLAGS,
                                 metrics=JMETRICS, dev={}),
    "torch": types.SimpleNamespace(tr=ttrace, co=tco, flags=TFLAGS,
                                   metrics=TMETRICS, dev={"device": "cpu"}),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """One package; the flags a case twists and its buffer are reset."""
    p = PKGS[request.param]
    saved = {f: p.flags.get(f) for f in ("trace_sampling_rate",
                                         "slow_query_ms")}
    p.tr.TRACE_BUFFER.clear()
    try:
        yield p
    finally:
        for f, v in saved.items():
            p.flags.set(f, v)
        p.tr.TRACE_BUFFER.clear()


@pytest.fixture
def sampled(pkg):
    pkg.flags.set("trace_sampling_rate", 1.0)
    return pkg


# ---------------- span core ----------------

def test_unsampled_returns_shared_noop(pkg):
    pkg.flags.set("trace_sampling_rate", 0.0)
    s1 = pkg.tr.TRACER.start_span("a")
    s2 = pkg.tr.TRACER.start_span("b")
    assert s1 is pkg.tr.NOOP_SPAN and s2 is pkg.tr.NOOP_SPAN
    with s1 as s:
        s.set_attr("k", 1).end()
    assert s1.duration_us() == 0.0


def test_span_tree_and_buffer(sampled):
    tr = sampled.tr
    with tr.TRACER.start_span("root") as root:
        root.set_attr("who", "me")
        with tr.TRACER.start_span("child") as child:
            assert tr.current_span() is child
            assert child.trace_id == root.trace_id
            assert child.parent_id == root.span_id
        assert tr.current_span() is root
    recs = tr.TRACE_BUFFER.snapshot()
    assert [r["name"] for r in recs] == ["child", "root"]   # end order
    assert recs[0]["trace_id"] == recs[1]["trace_id"]
    assert recs[1]["attrs"] == {"who": "me"}
    assert recs[1]["parent_id"] == ""


def test_span_error_status(sampled):
    with pytest.raises(ValueError):
        with sampled.tr.TRACER.start_span("boom"):
            raise ValueError("x")
    assert sampled.tr.TRACE_BUFFER.snapshot()[-1]["status"] == \
        "error: ValueError"


def test_metrics_bridge(sampled):
    rec = sampled.metrics.latency("span.bridged")
    before = rec.stats()["count"]
    with sampled.tr.TRACER.start_span("bridged"):
        pass
    assert rec.stats()["count"] == before + 1


def test_slow_query_log(sampled):
    tr = sampled.tr
    sampled.flags.set("slow_query_ms", 0.001)
    # request roots (rpc./client. prefix) qualify for the slow log
    with tr.TRACER.start_span("rpc.test.Slow"):
        time.sleep(0.005)
    slow = tr.TRACE_BUFFER.slow_queries()
    assert slow and slow[-1]["name"] == "rpc.test.Slow"
    # interior spans never enter it
    with tr.TRACER.start_span("rpc.test.Outer"):
        with tr.TRACER.start_span("index.search"):
            time.sleep(0.005)
    assert all(s["name"] != "index.search"
               for s in tr.TRACE_BUFFER.slow_queries())


def test_slow_log_covers_adopted_ingress_and_excludes_raft(sampled):
    tr = sampled.tr
    sampled.flags.set("slow_query_ms", 0.001)
    remote = tr.SpanContext(0xabc, 0xdef, sampled=True)
    with tr.TRACER.start_span("rpc.StoreService.KvScan", parent=remote):
        time.sleep(0.005)
    assert any(s["name"] == "rpc.StoreService.KvScan"
               for s in tr.TRACE_BUFFER.slow_queries())
    with tr.TRACER.start_span("client.RaftService.RaftMessage"):
        time.sleep(0.005)
    assert all(s["name"] != "client.RaftService.RaftMessage"
               for s in tr.TRACE_BUFFER.slow_queries())


def test_slow_watch_keeps_unsampled_outliers(pkg):
    tr = pkg.tr
    pkg.flags.set("trace_sampling_rate", 0.5)
    pkg.flags.set("slow_query_ms", 0.001)
    t0 = tr.TRACER.slow_watch_start()
    assert t0 > 0
    time.sleep(0.003)
    tr.TRACER.slow_watch_end("rpc.test.Unsampled", t0)
    rec = tr.TRACE_BUFFER.slow_queries()[-1]
    assert rec["name"] == "rpc.test.Unsampled"
    assert rec["attrs"] == {"unsampled": True}
    pkg.flags.set("trace_sampling_rate", 0.0)
    assert tr.TRACER.slow_watch_start() == 0


def test_buffer_ring_bounded(pkg):
    buf = pkg.tr.TraceBuffer(capacity=4)
    for i in range(10):
        buf.add({"name": f"s{i}", "trace_id": "t"})
    snap = buf.snapshot()
    assert [r["name"] for r in snap] == ["s6", "s7", "s8", "s9"]
    assert buf.stats()["dropped"] == 6
    assert [r["name"] for r in buf.snapshot(limit=2)] == ["s8", "s9"]


def test_sampling_rate_fraction(sampled):
    sampled.flags.set("trace_sampling_rate", 0.5)
    hits = sum(bool(sampled.tr.TRACER.start_span("p").sampled)
               for _ in range(400))
    assert 100 < hits < 300   # ~200 expected; generous bounds


# ---------------- metadata propagation ----------------

def test_metadata_inject_extract_roundtrip(sampled):
    tr = sampled.tr
    with tr.TRACER.start_span("client") as sp:
        md = tr.inject_metadata([("other", "1")])
        assert ("other", "1") in md
        ctx = tr.extract_metadata(md)
        assert ctx.trace_id == sp.trace_id
        assert ctx.span_id == sp.span_id
        assert ctx.sampled
    assert tr.inject_metadata(None) is None
    assert tr.extract_metadata(None) is None
    assert tr.extract_metadata([("x", "y")]) is None
    assert tr.extract_metadata([(tr.TRACE_METADATA_KEY, "garbage")]) is None


def test_metadata_header_is_shared():
    """A header injected by one package is extracted by the other."""
    assert jtrace.TRACE_METADATA_KEY == ttrace.TRACE_METADATA_KEY
    assert jtrace.UNSAMPLED_HEADER == ttrace.UNSAMPLED_HEADER
    saved = TFLAGS.get("trace_sampling_rate")
    TFLAGS.set("trace_sampling_rate", 1.0)
    try:
        with ttrace.TRACER.start_span("client") as sp:
            md = ttrace.inject_metadata()
        ctx = jtrace.extract_metadata(md)
        assert (ctx.trace_id, ctx.span_id) == (sp.trace_id, sp.span_id)
    finally:
        TFLAGS.set("trace_sampling_rate", saved)
        ttrace.TRACE_BUFFER.clear()


def test_remote_parent_links_span(sampled):
    tr = sampled.tr
    md = [(tr.TRACE_METADATA_KEY, f"{0xabc:016x}-{0xdef:016x}-1")]
    with tr.TRACER.start_span("server", parent=tr.extract_metadata(md)) as sp:
        assert sp.trace_id == 0xabc
        assert sp.parent_id == 0xdef
    md0 = [(tr.TRACE_METADATA_KEY, f"{0xabc:016x}-{0xdef:016x}-0")]
    assert tr.TRACER.start_span(
        "s", parent=tr.extract_metadata(md0)) is tr.NOOP_SPAN


# ---------------- coalescer propagation ----------------

def test_coalescer_span_tree_single_trace(sampled):
    """A search through SearchCoalescer.submit yields one connected tree
    ingress -> coalesce.wait -> coalesce.run -> index.search with one
    trace id, though the batch runs on the timer thread."""
    tr = sampled.tr

    def run(key, stacked):
        with tr.TRACER.start_span("index.search") as sp:
            sp.set_attr("batch", len(stacked))
        return list(range(len(stacked)))

    co = sampled.co.SearchCoalescer(run, window_ms=5.0, **sampled.dev)
    try:
        with tr.TRACER.start_span("rpc.test.Search") as ingress:
            fut = co.submit("k", np.zeros((2, 4), np.float32))
            assert fut.result(timeout=5) == [0, 1]
            trace_id = f"{ingress.trace_id:016x}"
    finally:
        co.stop()
    spans = {r["name"]: r
             for r in tr.TRACE_BUFFER.snapshot(trace_id=trace_id)}
    assert {"rpc.test.Search", "coalesce.wait", "coalesce.run",
            "index.search"} <= set(spans)
    assert spans["coalesce.wait"]["parent_id"] == \
        spans["rpc.test.Search"]["span_id"]
    assert spans["coalesce.run"]["parent_id"] == \
        spans["coalesce.wait"]["span_id"]
    assert spans["index.search"]["parent_id"] == \
        spans["coalesce.run"]["span_id"]
    assert spans["coalesce.run"]["attrs"]["batch_size"] == 2
    assert spans["coalesce.run"]["thread"] != \
        spans["rpc.test.Search"]["thread"]


def test_coalescer_pipelined_span_tree_crosses_the_lane():
    """Pipelined (the port): coalesce.run opens on the flush thread and
    ends on the completion lane, still in the submitter's trace; the lane
    re-attaches the span the handoff carries."""
    tr = ttrace
    saved = {f: TFLAGS.get(f) for f in ("pipeline_enabled",
                                        "trace_sampling_rate")}
    TFLAGS.set("pipeline_enabled", "true")
    TFLAGS.set("trace_sampling_rate", 1.0)
    tr.TRACE_BUFFER.clear()
    seen = {}

    def dispatch(key, stacked, staged=None):
        seen["dispatch"] = tr.current_span()

        def thunk():
            seen["resolve"] = tr.current_span()
            return list(range(len(stacked)))
        return thunk

    co = tco.SearchCoalescer(lambda k, q: [], window_ms=5.0,
                             dispatch_fn=dispatch, device="cpu")
    try:
        fut = co.submit("k", np.zeros((2, 4), np.float32))
        assert fut.result(timeout=5) == [0, 1]
    finally:
        co.stop(drain=True)
        for f, v in saved.items():
            TFLAGS.set(f, v)
    recs = tr.TRACE_BUFFER.snapshot()
    tr.TRACE_BUFFER.clear()
    runs = [r for r in recs if r["name"] == "coalesce.run"]
    waits = [r for r in recs if r["name"] == "coalesce.wait"]
    assert len(runs) == len(waits) == 1
    assert runs[0]["trace_id"] == waits[0]["trace_id"]
    assert runs[0]["parent_id"] == waits[0]["span_id"]
    assert seen["dispatch"] is seen["resolve"]
    assert seen["dispatch"].name == "coalesce.run"


def test_coalescer_batch_links_cobatched_traces(sampled):
    """Two sampled submitters merged into one batch: the run span lands in
    the first trace and records the other trace id as a link."""
    tr = sampled.tr
    both_in = threading.Barrier(2)
    co = sampled.co.SearchCoalescer(lambda k, q: list(range(len(q))),
                                    window_ms=10_000.0, **sampled.dev)
    traces, futs = [], []
    lock = threading.Lock()

    def one():
        with tr.TRACER.start_span("rpc.r") as sp:
            f = co.submit("k", np.zeros((1, 4), np.float32))
            with lock:
                traces.append(f"{sp.trace_id:016x}")
                futs.append(f)
            both_in.wait(timeout=10)

    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    co.stop(drain=True)          # flushes the one pending batch
    for f in futs:
        assert len(f.result(timeout=5)) == 1
    runs = [r for r in tr.TRACE_BUFFER.snapshot()
            if r["name"] == "coalesce.run"]
    assert len(runs) == 1
    assert runs[0]["attrs"]["requests"] == 2
    assert set(runs[0]["attrs"]["cobatched_traces"]) == \
        set(traces) - {runs[0]["trace_id"]}


# ---------------- exporters ----------------

def test_json_and_chrome_export(sampled, tmp_path):
    tr = sampled.tr
    with tr.TRACER.start_span("outer"):
        with tr.TRACER.start_span("inner"):
            pass
    payload = tr.to_json()
    assert len(payload["traces"]) == 1
    (spans,) = payload["traces"].values()
    assert {s["name"] for s in spans} == {"outer", "inner"}
    assert payload["stats"]["buffered"] == 2
    chrome = tr.to_chrome_trace()
    assert {e["name"] for e in chrome["traceEvents"]} == {"outer", "inner"}
    for ev in chrome["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 1
        assert ev["args"]["trace_id"]
    path = tr.dump_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(chrome))


def test_trace_flags_defined_with_reference_defaults():
    for name in ("trace_sampling_rate", "slow_query_ms"):
        assert TFLAGS.get(name) == JFLAGS.get(name)
    assert TFLAGS.get("trace_sampling_rate") == 0.0
    assert TFLAGS.get("slow_query_ms") == 500.0


def _records():
    return [
        {"name": "coalesce.wait", "trace_id": "00000000000000ab",
         "span_id": "0000000000000001", "parent_id": "", "start_us": 10,
         "dur_us": 0, "thread": 7, "status": "ok", "attrs": {}},
        {"name": "coalesce.run", "trace_id": "00000000000000ab",
         "span_id": "0000000000000002", "parent_id": "0000000000000001",
         "start_us": 12, "dur_us": 350, "thread": 8,
         "status": "error: ValueError",
         "attrs": {"batch_size": 16, "requests": 4,
                   "cobatched_traces": ["00000000000000cd"]}},
    ]


def test_chrome_export_same_in_both_packages():
    """The same recorded spans give the same Chrome export (and JSON
    grouping) in both packages."""
    assert ttrace.to_chrome_trace(_records()) == \
        jtrace.to_chrome_trace(_records())
    assert ttrace.to_json(_records(), [])["traces"] == \
        jtrace.to_json(_records(), [])["traces"]


def test_recorded_span_schema_same_in_both_packages():
    """Spans recorded the same way by both tracers carry the same keys,
    the same id widths and the same attribute names."""
    recs = {}
    for name, p in PKGS.items():
        saved = p.flags.get("trace_sampling_rate")
        p.flags.set("trace_sampling_rate", 1.0)
        p.tr.TRACE_BUFFER.clear()
        try:
            co = p.co.SearchCoalescer(lambda k, q: list(range(len(q))),
                                      window_ms=5.0, **p.dev)
            try:
                with p.tr.TRACER.start_span("rpc.test.Schema"):
                    co.submit("k", np.zeros((3, 4), np.float32)
                              ).result(timeout=5)
            finally:
                co.stop()
            recs[name] = {r["name"]: r for r in p.tr.TRACE_BUFFER.snapshot()}
        finally:
            p.flags.set("trace_sampling_rate", saved)
            p.tr.TRACE_BUFFER.clear()
    assert set(recs["jax"]) == set(recs["torch"])
    for span, j in recs["jax"].items():
        t = recs["torch"][span]
        assert set(t) == set(j)
        assert set(t["attrs"]) == set(j["attrs"])
        assert len(t["trace_id"]) == len(j["trace_id"]) == 16
        chrome_t = ttrace.to_chrome_trace([t])["traceEvents"][0]
        chrome_j = jtrace.to_chrome_trace([j])["traceEvents"][0]
        assert set(chrome_t) == set(chrome_j)
        assert set(chrome_t["args"]) == set(chrome_j["args"])
