"""Trace propagation through the port's gRPC front end: the seven cases
of tests/test_trace_grpc.py on the port's DingoServer, ServiceStub,
TRACER and FLAGS, the DebugService Prometheus case of
tests/test_metrics_grpc.py on a store's own server, the trace context
across the wire between the packages (a JAX client span is the parent of
the port server's ingress span and the other way round), and one error
bundle, with the request's trace, for a coalesced search that fails.

The end-to-end case builds a one-store cluster in each package (an
in-process coordinator, a StoreNode hosted by its DingoServer) and one
VectorSearch through each coalescer must give the same span names in
one connected trace.
"""

import importlib
import json
import time

import grpc
import numpy as np
import pytest
import torch

from test_torch_grpc_server import PB, PKGS, GrpcCluster, search_req, \
    vector_add_req, wait_for

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.server.grpc_services import DebugService
from dingo_tpu_torch.server.rpc import DingoServer, ServiceStub, _register
from dingo_tpu_torch.trace import (
    TRACE_BUFFER,
    TRACER,
    current_span,
    inject_metadata,
    to_chrome_trace,
)

torch.set_num_threads(1)


def trace_mods(name):
    """One package's FLAGS, TRACER and TRACE_BUFFER."""
    tr = importlib.import_module(f"{name}.trace")
    return (importlib.import_module(f"{name}.common.config").FLAGS,
            tr.TRACER, tr.TRACE_BUFFER)


@pytest.fixture()
def sampled():
    for name in PKGS:
        flags, _, buf = trace_mods(name)
        buf.clear()
        flags.set("trace_sampling_rate", 1.0)
    try:
        yield
    finally:
        for name in PKGS:
            flags, _, buf = trace_mods(name)
            flags.set("trace_sampling_rate", 0.0)
            buf.clear()


@pytest.fixture()
def debug_server():
    """A port DingoServer with DebugService alone, and a channel to it."""
    server = DingoServer()
    _register(server._server, "DebugService", DebugService())
    port = server.start()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield server, chan
    chan.close()
    server.stop()


def test_grpc_metadata_propagation_roundtrip(sampled, debug_server):
    """The client span context rides the metadata: the server's ingress
    span joins the same trace with the client span as its parent."""
    _, chan = debug_server
    stub = ServiceStub(chan, "DebugService")
    with TRACER.start_span("test.client_root") as root:
        stub.MetricsDump(PB.MetricsDumpRequest())
        trace_id = f"{root.trace_id:016x}"
    spans = {r["name"]: r for r in TRACE_BUFFER.snapshot(trace_id=trace_id)}
    assert "client.DebugService.MetricsDump" in spans
    assert "rpc.DebugService.MetricsDump" in spans
    assert spans["rpc.DebugService.MetricsDump"]["parent_id"] == \
        spans["client.DebugService.MetricsDump"]["span_id"]
    assert spans["client.DebugService.MetricsDump"]["parent_id"] == \
        spans["test.client_root"]["span_id"]


def test_grpc_unsampled_sends_no_metadata(debug_server):
    """With sampling off the stub adds no metadata and the server records
    nothing."""
    FLAGS.set("trace_sampling_rate", 0.0)
    TRACE_BUFFER.clear()
    _, chan = debug_server
    ServiceStub(chan, "DebugService").MetricsDump(PB.MetricsDumpRequest())
    assert TRACE_BUFFER.snapshot() == []


def test_grpc_propagates_unsampled_decision(sampled, debug_server):
    """At 0 < rate < 1 an unsampled root's decision rides the metadata
    as '0-0-0': every recorded server span has a client parent."""
    FLAGS.set("trace_sampling_rate", 0.5)
    _, chan = debug_server
    stub = ServiceStub(chan, "DebugService")
    for _ in range(40):
        stub.MetricsDump(PB.MetricsDumpRequest())
    recs = TRACE_BUFFER.snapshot()
    server_spans = [r for r in recs if r["name"].startswith("rpc.")]
    client_ids = {(r["trace_id"], r["span_id"]) for r in recs
                  if r["name"].startswith("client.")}
    assert server_spans, "rate 0.5 over 40 calls: expected samples"
    for s in server_spans:
        assert (s["trace_id"], s["parent_id"]) in client_ids, s


def test_tracing_off_ingress_leaves_context_clean():
    """A rate-0 server with no incoming header attaches no context, so
    its own outbound calls send no '0-0-0'."""
    FLAGS.set("trace_sampling_rate", 0.0)
    seen = {}

    class Probe(DebugService):
        def MetricsDump(self, req):
            seen["ctx"] = current_span()
            seen["onward_md"] = inject_metadata(None)
            return super().MetricsDump(req)

    server = DingoServer()
    _register(server._server, "DebugService", Probe())
    port = server.start()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        ServiceStub(chan, "DebugService").MetricsDump(
            PB.MetricsDumpRequest())
        assert seen["ctx"] is None
        assert seen["onward_md"] is None
    finally:
        chan.close()
        server.stop()


def test_slow_query_logged_even_when_unsampled(sampled, debug_server):
    """Always-sample-slow: a request that loses the sampling roll still
    lands in the slow-query log, with no span tree."""
    FLAGS.set("trace_sampling_rate", 1e-9)
    FLAGS.set("slow_query_ms", 0.0001)
    _, chan = debug_server
    try:
        ServiceStub(chan, "DebugService").MetricsDump(
            PB.MetricsDumpRequest())
        mine = [s for s in TRACE_BUFFER.slow_queries()
                if s["name"] == "rpc.DebugService.MetricsDump"]
        assert mine and mine[-1]["attrs"] == {"unsampled": True}
        assert mine[-1]["dur_us"] > 0
        assert all(r["name"] != "rpc.DebugService.MetricsDump"
                   for r in TRACE_BUFFER.snapshot())
    finally:
        FLAGS.set("slow_query_ms", 500.0)


def test_slow_log_excludes_background_roots(sampled):
    """Only rpc./client. roots enter the slow-query log; a slow
    background root is buffered but not logged."""
    FLAGS.set("slow_query_ms", 0.001)
    try:
        with TRACER.start_span("index.rebuild"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.005:
                pass
        assert all(s["name"] != "index.rebuild"
                   for s in TRACE_BUFFER.slow_queries())
        assert any(r["name"] == "index.rebuild"
                   for r in TRACE_BUFFER.snapshot())
    finally:
        FLAGS.set("slow_query_ms", 500.0)


def _search_trace(name):
    """One VectorSearch through a one-store cluster of `name` with a 10 ms
    coalescing window: (the trace's spans, its id, TraceDump's JSON,
    TraceChromeDump's JSON)."""
    flags, tracer, buf = trace_mods(name)
    c = GrpcCluster(name, n=1, replication=1)
    flags.set("search_coalescing_window_ms", 10.0)
    try:
        rid = c.create(index_type="flat", dimension=8, start=0, end=1 << 30)
        x = np.random.default_rng(0).standard_normal((50, 8)).astype(
            np.float32)
        add = c.call(rid, "IndexService", "VectorAdd",
                     vector_add_req(rid, list(range(50)), x))
        assert add.error.errcode == 0
        buf.clear()
        with tracer.start_span("test.ingress") as root:
            res = c.call(rid, "IndexService", "VectorSearch",
                         search_req(rid, x[[3]], 3))
            trace_id = f"{root.trace_id:016x}"
        assert res.batch_results[0].results[0].vector.id == 3
        spans = buf.snapshot(trace_id=trace_id)
        dbg = c.stub("s0", "DebugService")
        dump = json.loads(dbg.TraceDump(PB.MetricsDumpRequest()).json)
        chrome = json.loads(dbg.TraceChromeDump(PB.MetricsDumpRequest()).json)
        return spans, trace_id, dump, chrome
    finally:
        flags.set("search_coalescing_window_ms", 0.0)
        c.close()


@pytest.mark.parametrize("name", PKGS)
def test_failed_coalesced_search_black_boxes_once(sampled, name):
    """A VectorSearch that fails inside the coalescer answers 30001 and
    writes exactly one error bundle, which carries the request's trace,
    in both packages."""
    flags, tracer, _ = trace_mods(name)
    flight = importlib.import_module(f"{name}.obs.flight").FLIGHT
    err = importlib.import_module(f"{name}.index.base").VectorIndexError
    c = GrpcCluster(name, n=1, replication=1)
    flags.set("search_coalescing_window_ms", 10.0)
    try:
        rid = c.create(index_type="flat", dimension=8, start=0, end=1 << 30)
        x = np.random.default_rng(0).standard_normal((20, 8)).astype(
            np.float32)
        add = c.call(rid, "IndexService", "VectorAdd",
                     vector_add_req(rid, list(range(20)), x))
        assert add.error.errcode == 0
        storage = c.nodes["s0"].storage

        def fail(*a, **kw):
            raise err("index gone")

        storage.vector_batch_search = fail
        storage.vector_batch_search_async = fail
        flight.clear()
        with tracer.start_span("test.ingress") as root:
            res = c.call(rid, "IndexService", "VectorSearch",
                         search_req(rid, x[[3]], 3))
            trace_id = f"{root.trace_id:016x}"
        assert res.error.errcode == 30001
        metas = [m for m in flight.bundles_meta() if m["reason"] == "error"]
        assert len(metas) == 1, metas
        assert metas[0]["name"] == "rpc.IndexService.VectorSearch"
        assert flight.get_json(metas[0]["id"])["trace_id"] == trace_id
    finally:
        flags.set("search_coalescing_window_ms", 0.0)
        c.close()


def test_vector_search_trace_end_to_end(sampled):
    """At sampling 1.0 one VectorSearch RPC through the coalescer gives
    >= 5 nested spans in one connected trace (rpc -> coalesce.wait ->
    coalesce.run -> index.search -> ops.*), exported by TraceDump and as
    a Chrome trace; the port's span names are the JAX package's (but its
    XLA compile span)."""
    names = {}
    for name in PKGS:
        spans, trace_id, dump, chrome = _search_trace(name)
        names[name] = {s["name"] for s in spans}
        assert len(spans) >= 5, names[name]
        assert {"rpc.IndexService.VectorSearch", "coalesce.wait",
                "coalesce.run", "index.search"} <= names[name]
        assert any(n.startswith("ops.") for n in names[name]), names[name]
        ids = {s["span_id"] for s in spans}
        roots = [s for s in spans if not s["parent_id"]]
        assert [r["name"] for r in roots] == ["test.ingress"]
        for s in spans:
            assert s["trace_id"] == trace_id
            if s["parent_id"]:
                assert s["parent_id"] in ids, s
        rpc_span = next(s for s in spans
                        if s["name"] == "rpc.IndexService.VectorSearch")
        assert rpc_span["attrs"]["region_id"] >= 1
        assert rpc_span["attrs"]["batch"] == 1
        assert trace_id in dump["traces"]
        assert {s["name"] for s in dump["traces"][trace_id]} >= {
            "rpc.IndexService.VectorSearch", "coalesce.run"}
        assert chrome["traceEvents"]
    # the JAX package also records its first call's XLA compile, which
    # the port has no counterpart for
    assert names["dingo_tpu_torch"] == {
        n for n in names["dingo_tpu"] if not n.startswith("xla.")}
    local = to_chrome_trace(spans)
    assert {e["name"] for e in local["traceEvents"]} == \
        names["dingo_tpu_torch"]
    for ev in local["traceEvents"]:
        assert ev["ph"] == "X"
        assert isinstance(ev["ts"], int) and ev["dur"] >= 1


@pytest.mark.parametrize("client", PKGS)
def test_trace_context_crosses_packages(sampled, client):
    """A client span of one package is the parent of the ingress span on
    the other package's server: the trace metadata is one format."""
    server_pkg = PKGS[1 - PKGS.index(client)]
    _, c_tracer, c_buf = trace_mods(client)
    _, _, s_buf = trace_mods(server_pkg)
    rpc = importlib.import_module(f"{server_pkg}.server.rpc")
    svc_mod = importlib.import_module(
        "dingo_tpu_torch.server.grpc_services" if server_pkg ==
        "dingo_tpu_torch" else "dingo_tpu.server.services")
    server = rpc.DingoServer()
    rpc._register(server._server, "DebugService", svc_mod.DebugService())
    port = server.start()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = importlib.import_module(f"{client}.server.rpc").ServiceStub(
            chan, "DebugService")
        with c_tracer.start_span("test.cross_root") as root:
            stub.MetricsDump(PB.MetricsDumpRequest())
            trace_id = f"{root.trace_id:016x}"
        egress = next(s for s in c_buf.snapshot(trace_id=trace_id)
                      if s["name"] == "client.DebugService.MetricsDump")
        wait_for(lambda: any(s["name"] == "rpc.DebugService.MetricsDump"
                             for s in s_buf.snapshot(trace_id=trace_id)),
                 what="the server span")
        ingress = next(s for s in s_buf.snapshot(trace_id=trace_id)
                       if s["name"] == "rpc.DebugService.MetricsDump")
        assert ingress["parent_id"] == egress["span_id"]
    finally:
        chan.close()
        server.stop()


def test_debug_metrics_dump_prometheus_over_grpc():
    """DebugService.MetricsDump on a store's own server: the Prometheus
    text format parses line by line, the default stays the JSON dump, in
    both packages."""
    from test_store_metrics import parse_prometheus

    for name in PKGS:
        c = GrpcCluster(name, n=1, replication=1)
        try:
            stub = c.stub("s0", "DebugService")
            resp = stub.MetricsDump(PB.MetricsDumpRequest(
                format="prometheus"))
            assert not resp.error.errcode, name
            parse_prometheus(resp.json)
            json.loads(stub.MetricsDump(PB.MetricsDumpRequest()).json)
        finally:
            c.close()
