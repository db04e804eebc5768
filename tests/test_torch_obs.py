"""The port's HBM ledger, flight recorder, Prometheus exposition and
metrics sidecar (obs/hbm.py, metrics/device.py, obs/flight.py, the
tracer's slow-query capture, common/metrics.py, metrics/http.py) against
the JAX package's, case by case from tests/test_obs.py's HBM, flight and
Prometheus cases and tests/test_store_metrics.py's Prometheus and
HTTP-scrape cases; and the repo's metric-name lint over the port.

Tolerance: none. The same registry contents render to the same
Prometheus text in both packages; the ledger's owner columns sum to the
port's ``tensor_bytes`` of the index exactly."""

import json
import os
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

from torch_cluster_util import PKGS, Pkg

torch.set_num_threads(1)

P = {name: Pkg(name) for name in PKGS}
J, T = P["dingo_tpu"], P["dingo_tpu_torch"]
_SAVED = ("trace_sampling_rate", "slow_query_ms", "obs_flight_max_bundles",
          "obs_flight_buffer_s", "obs_exemplars")


@pytest.fixture(autouse=True)
def obs_env():
    saved = []
    for p in P.values():
        saved.append((p, {k: p.config.FLAGS.get(k) for k in _SAVED}))
        p.flight.FLIGHT.clear()
        p.trace.TRACE_BUFFER.clear()
    yield
    for p, flags in saved:
        for k, v in flags.items():
            p.config.FLAGS.set(k, v)
        p.flight.FLIGHT.clear()
        p.trace.TRACE_BUFFER.clear()


@pytest.fixture(params=PKGS)
def pkg(request):
    return P[request.param]


# ---------------- the HBM ledger ----------------

def test_hbm_ledger_owner_attribution_and_watermark(pkg):
    HBM, M = pkg.hbm.HBM, pkg.metrics.METRICS
    rid = 960
    HBM.forget_region(rid)
    b = pkg.base
    idx = pkg.new_index(rid, b.IndexParameter(index_type=b.IndexType.FLAT,
                                              dimension=16))
    idx.upsert(np.arange(64, dtype=np.int64), np.ones((64, 16), np.float32))
    idx.search(np.ones((2, 16), np.float32), 4)
    owners = HBM.account_index(rid, idx)
    assert owners.get("slot_store", 0) > 0
    total = sum(owners.values())
    assert HBM.region_peak(rid) == total
    if pkg.torch:
        # the owner columns are the port's device bytes of the index
        assert total == pkg.base.tensor_bytes(idx)
    HBM.update_region(rid, {"slot_store": 10})
    assert HBM.region_peak(rid) == total
    assert M.gauge("hbm.region.bytes", rid,
                   labels={"owner": "slot_store"}).get() == 10
    assert M.gauge("hbm.region.total_peak_bytes", rid).get() == total
    assert HBM.state()["regions"][rid]["total_peak_bytes"] == total
    HBM.forget_region(rid)
    assert HBM.region_peak(rid) == 0


def test_hbm_ledger_of_an_ivf_index_equals_tensor_bytes():
    """Every owner (store, view, centroids, the rest) of a trained IVF
    index, each storage once: the sum is tensor_bytes(index)."""
    b = T.base
    idx = T.new_index(963, b.IndexParameter(
        index_type=b.IndexType.IVF_FLAT, dimension=16, ncentroids=8,
        default_nprobe=4))
    x = np.random.default_rng(0).standard_normal((512, 16)).astype(
        np.float32)
    idx.upsert(np.arange(512, dtype=np.int64), x)
    idx.train()
    idx.search(x[:4], 5)
    owners = T.hbm.HBM.account_index(963, idx)
    assert owners["ivf_view"] > 0 and owners["centroids"] > 0
    assert sum(owners.values()) == b.tensor_bytes(idx)
    T.hbm.HBM.forget_region(963)


def test_hbm_owner_attribution_dedupes_shared_tensors():
    from types import SimpleNamespace

    t = torch.ones((32, 8))
    fake = SimpleNamespace(store=[t], _view=[t])
    owners = T.hbm.HBM.account_index(961, fake)
    assert owners.get("ivf_view", 0) == t.untyped_storage().nbytes()
    assert owners.get("slot_store", 0) == 0
    T.hbm.HBM.forget_region(961)


def test_hbm_alloc_failure_hook(pkg):
    HBM, M, F = pkg.hbm.HBM, pkg.metrics.METRICS, pkg.flight.FLIGHT
    oom = (torch.cuda.OutOfMemoryError("CUDA out of memory") if pkg.torch
           else RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    c0 = M.counter("hbm.alloc_failures").get()
    assert HBM.on_alloc_failure(ValueError("bad nprobe")) is None
    assert M.counter("hbm.alloc_failures").get() == c0
    bid = HBM.on_alloc_failure(oom, context="VectorSearch", region_id=7)
    assert bid
    assert M.counter("hbm.alloc_failures").get() == c0 + 1
    meta = F.bundles_meta()[-1]
    assert (meta["reason"], meta["region_id"]) == ("device_oom", 7)
    bundle = F.get_json(bid)
    assert "out of memory" in bundle["trigger"]["error"].lower()
    assert "hbm" in bundle and "kernel_cache" in bundle


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from dingo_tpu_torch.metrics.device import device_memory_stats

    assert device_memory_stats() == {"devices": 0, "bytes_in_use": 0,
                                     "bytes_limit": 0,
                                     "peak_bytes_in_use": 0}


# ---------------- the flight recorder ----------------

def _capture_log(pkg, monkeypatch):
    lines = []
    monkeypatch.setattr(
        f"{pkg.name}.trace.span._log",
        type("L", (), {"warning":
                       lambda self, msg, *a: lines.append(msg % a)})())
    return lines


def test_flight_slow_query_trigger_and_exemplar(pkg, monkeypatch):
    f, M = pkg.config.FLAGS, pkg.metrics.METRICS
    f.set("trace_sampling_rate", 1.0)
    f.set("slow_query_ms", 0.001)
    lines = _capture_log(pkg, monkeypatch)
    F = pkg.flight.FLIGHT
    F.tick()
    M.latency("span.rpc.TestService.Slow").observe_us(
        10_000_000.0, trace_id="feedfacefeedface")
    with pkg.trace.TRACER.start_span("rpc.TestService.Slow") as span:
        time.sleep(0.004)
        trace_id = f"{span.trace_id:016x}"
    metas = F.bundles_meta()
    assert metas and metas[-1]["reason"] == "slow_query"
    assert metas[-1]["trace_id"] == trace_id
    assert lines and trace_id in lines[-1] and metas[-1]["id"] in lines[-1]
    bundle = F.get_json(metas[-1]["id"])
    assert any(s["name"] == "rpc.TestService.Slow" for s in bundle["spans"])
    for section in ("metrics", "hbm", "quality", "events", "integrity",
                    "kernel_cache"):
        assert section in bundle, section
    text = M.render_prometheus()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("span_rpc_TestService_Slow")
                and 'quantile="0.99"' in ln)
    assert f'trace_id="{trace_id}"' in line


def test_flight_unsampled_slow_query_still_bundles(pkg, monkeypatch):
    f = pkg.config.FLAGS
    f.set("trace_sampling_rate", 1e-12)
    f.set("slow_query_ms", 0.001)
    lines = _capture_log(pkg, monkeypatch)
    TR = pkg.trace.TRACER
    t0 = TR.slow_watch_start()
    assert t0
    time.sleep(0.004)
    TR.slow_watch_end("rpc.TestService.Unsampled", t0)
    metas = pkg.flight.FLIGHT.bundles_meta()
    assert metas and metas[-1]["reason"] == "slow_query"
    assert metas[-1]["trace_id"] == ""
    assert lines and metas[-1]["id"] in lines[-1]


def test_error_bundle_contains_inflight_root_span(pkg):
    pkg.config.FLAGS.set("trace_sampling_rate", 1.0)
    TR, F = pkg.trace.TRACER, pkg.flight.FLIGHT
    with TR.start_span("rpc.TestService.Fails") as root:
        with TR.start_span("child.work"):
            pass
        bid = F.on_rpc_error("rpc.TestService.Fails", ValueError("boom"),
                             root)
    names = {s["name"]: s for s in F.get_json(bid)["spans"]}
    assert "child.work" in names
    assert names["rpc.TestService.Fails"]["attrs"]["in_flight"] is True


def test_flight_metrics_delta_window(pkg):
    F = pkg.flight.FLIGHT
    F.tick()
    pkg.metrics.METRICS.counter("flighttest.delta_probe").add(7)
    bundle = F.get_json(F.trigger("manual", name="delta-test"))
    assert bundle["metrics"]["deltas"]["flighttest.delta_probe"] == 7


def test_flight_rate_limit_and_retention(pkg):
    F = pkg.flight.FLIGHT
    assert F.trigger("stormy") and F.trigger("stormy") == ""
    pkg.config.FLAGS.set("obs_flight_max_bundles", 2)
    for reason in ("r_a", "r_b", "r_c"):
        F.trigger(reason)
    assert [m["reason"] for m in F.bundles_meta()] == ["r_b", "r_c"]
    pkg.config.FLAGS.set("obs_flight_max_bundles", 0)
    assert F.trigger("r_d") == ""


def test_bundle_sections_equal_the_reference():
    keys = {}
    for name, p in P.items():
        keys[name] = sorted(p.flight.FLIGHT.get_json(
            p.flight.FLIGHT.trigger("manual", name="keys")))
    assert keys["dingo_tpu_torch"] == keys["dingo_tpu"]


# ---------------- Prometheus and the HTTP sidecar ----------------

_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (-?[0-9.eE+\-]+|NaN)"
    r"(?: # \{[^{}]*\} -?[0-9.eE+\-]+(?: -?[0-9.eE+\-]+)?)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        name, labelstr, value = m.groups()
        out[(name, tuple(sorted(_LABEL_RE.findall(labelstr or ""))))] = \
            float(value)
    return out


def _fill(reg):
    reg.counter("rpc.requests", labels={"service": "index"}).add(5)
    reg.gauge("store.region.key_count", region_id=3).set(42)
    reg.gauge("quality.recall", 3, {"kind": "ivf_flat"}).set(0.96)
    lat = reg.latency("vector_search", region_id=3)
    for v in (100.0, 200.0):
        lat.observe_us(v)


def test_prometheus_rendering_parses_back(pkg):
    m = pkg.metrics.MetricsRegistry()
    _fill(m)
    series = parse_prometheus(m.render_prometheus())
    assert series[("rpc_requests", (("service", "index"),))] == 5.0
    assert series[("store_region_key_count", (("region", "3"),))] == 42.0
    assert series[("vector_search_count", (("region", "3"),))] == 2.0
    assert ("vector_search", (("quantile", "0.5"), ("region", "3"))) in \
        series


def test_prometheus_text_equals_the_reference():
    texts = {}
    for name, p in P.items():
        m = p.metrics.MetricsRegistry()
        _fill(m)
        # the windowed rate reads the clock: compare everything else
        texts[name] = [ln for ln in m.render_prometheus().splitlines()
                       if "_qps" not in ln]
    assert texts["dingo_tpu_torch"] == texts["dingo_tpu"]


def test_prometheus_exemplars_stripped_for_classic_scrape(pkg):
    m = pkg.metrics.MetricsRegistry()
    m.latency("span.rpc.classic_probe").observe_us(
        5000.0, trace_id="abcdef0123456789")
    assert "trace_id=" in m.render_prometheus()
    assert "trace_id=" not in m.render_prometheus(exemplars=False)


def test_metrics_http_server_scrape(pkg):
    m = pkg.metrics.MetricsRegistry()
    m.gauge("store.engine.key_count").set(77)
    m.counter("rpc.requests").add(3)
    m.latency("span.rpc.scrape_probe").observe_us(
        7000.0, trace_id="feed0123feed0123")
    srv = pkg.http.MetricsHttpServer(port=0, registry=m)
    port = srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            assert r.status == 200
            assert "version=0.0.4" in r.headers["Content-Type"]
            body = r.read().decode()
        series = parse_prometheus(body)
        assert series[("store_engine_key_count", ())] == 77.0
        assert series[("rpc_requests", ())] == 3.0
        assert "trace_id=" not in body
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics?exemplars=1",
            timeout=5).read().decode()
        assert 'trace_id="feed0123feed0123"' in body
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/vars",
                                    timeout=5) as r:
            assert json.load(r)["store.engine.key_count"] == 77.0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=5) as r:
            assert r.read() == b"ok\n"
    finally:
        srv.stop()


def test_store_crontab_serves_the_sidecar_when_asked():
    from dingo_tpu_torch.server.main import maybe_metrics_http

    assert maybe_metrics_http() is None          # port 0: off


# ---------------- the metric-name lint over the port ----------------

def test_port_metric_names_are_clean():
    """tools/check_metrics_names.py's checker over every module of the
    port (its SRC_DIRS cover only the JAX package)."""
    import importlib

    checker = importlib.import_module("tools.check_metrics_names")
    root = os.path.join(checker.REPO, "dingo_tpu_torch")
    bad, checked = [], 0
    for dirpath, _dirs, files in os.walk(root):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                checked += 1
                bad += [(path, ln, msg)
                        for ln, msg in checker.check_file(path)]
    assert checked >= 100
    assert not bad, bad


def test_index_service_search_error_writes_a_bundle():
    """A search that fails through the port's IndexService black-boxes the
    moment, as the JAX package's VectorSearch RPC does."""
    from types import SimpleNamespace

    from dingo_tpu_torch.index.base import VectorIndexError
    from dingo_tpu_torch.server.services import IndexService

    def fail(*a, **kw):
        raise VectorIndexError("boom")

    node = SimpleNamespace(
        device=torch.device("cpu"),
        get_region=lambda rid: SimpleNamespace(id=rid),
        storage=SimpleNamespace(vector_batch_search=fail))
    svc = IndexService(node, window_ms=0.0)
    fut = svc.submit(7, np.zeros((1, 4), np.float32), 3)
    with pytest.raises(VectorIndexError):
        fut.result(timeout=10)
    metas = T.flight.FLIGHT.bundles_meta()
    assert metas and metas[-1]["reason"] == "error"
    assert metas[-1]["name"] == "rpc.IndexService.VectorSearch"
    assert T.metrics.METRICS.latency("vector_search", 7).stats()["count"] >= 1
