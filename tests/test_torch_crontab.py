"""CrontabManager failure isolation in the port (common/crontab.py) and the
JAX package: the cases of test_crontab_isolation.py through both
packages — a failing crontab increments its error count, the other
crontabs keep firing in the same tick, the scheduler thread survives, and
errors are mirrored into each package's own metrics registry."""

import importlib
import time

import pytest

from torch_cluster_util import PKGS


@pytest.fixture(params=PKGS)
def pkg(request):
    return (importlib.import_module(f"{request.param}.common.crontab"),
            importlib.import_module(f"{request.param}.common.metrics"))


def test_failing_crontab_does_not_starve_others_same_tick(pkg):
    crontab, _ = pkg
    mgr = crontab.CrontabManager(tick_s=0.01)
    order = []
    # the failing tab registers FIRST so it's due before the healthy one
    mgr.add("boom", 0.01, lambda: (_ for _ in ()).throw(RuntimeError("x")),
            immediately=True)
    mgr.add("heartbeat", 0.01, lambda: order.append("hb"), immediately=True)
    for _ in range(4):
        mgr.run_pending()
        time.sleep(0.015)
    stats = mgr.stats()
    assert stats["boom"]["errors"] >= 3
    assert stats["boom"]["last_error"].startswith("RuntimeError")
    assert stats["heartbeat"]["runs"] >= 3
    assert stats["heartbeat"]["errors"] == 0


def test_scheduler_thread_survives_exceptions(pkg):
    crontab, _ = pkg
    mgr = crontab.CrontabManager(tick_s=0.005)
    hits = []
    mgr.add("boom", 0.005, lambda: 1 / 0, immediately=True)
    mgr.add("alive", 0.005, lambda: hits.append(1), immediately=True)
    mgr.start()
    try:
        time.sleep(0.2)
        assert mgr._thread is not None and mgr._thread.is_alive()
        n = len(hits)
        assert n >= 5
        assert mgr.stats()["boom"]["errors"] >= 5
        time.sleep(0.1)
        assert len(hits) > n
    finally:
        mgr.stop()


def test_errors_mirrored_into_metrics_registry(pkg):
    crontab, metrics = pkg
    mgr = crontab.CrontabManager()
    mgr.add("always_fails", 0.001, lambda: 1 / 0, immediately=True)
    counter = metrics.METRICS.counter(
        "crontab.errors", labels={"name": "always_fails"})
    before = counter.get()
    time.sleep(0.002)
    mgr.run_pending()
    assert counter.get() == before + 1
