"""Named counters, gauges and latency recorders with a region dimension
(the counter, gauge and latency part of dingo_tpu/common/metrics.py).

``METRICS`` keys each series as ``name{region=<id>,k=v,...}``, the JAX
package's series key, so a dump reads the same in both packages. The
latency recorder (ref metrics.py:80) feeds the pressure plane and the
tracer's ``span.<name>`` series. Its trace-id exemplars and Prometheus
rendering are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def get(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, delta: float) -> float:
        """Atomic up/down delta (queue depth is moved by request and flush
        threads at once; get()+set() would drop one side's delta)."""
        with self._lock:
            self._value += delta
            return self._value

    def get(self) -> float:
        return self._value


#: windowed-QPS horizon: per-second hit buckets retained this many seconds
QPS_WINDOW_S = 16


class LatencyRecorder:
    """Ring of recent samples (microseconds) with windowed qps and
    percentile queries. ``count`` is the lifetime total; ``qps`` covers
    the last QPS_WINDOW_S seconds only."""

    def __init__(self, window: int = 4096):
        self._window = window
        self._samples: List[float] = []
        self._pos = 0
        self._count = 0
        self._sum_us = 0.0
        self._t0 = time.monotonic()
        # slot i holds the hits of absolute second _sec_id[i]
        self._sec_hits = [0] * QPS_WINDOW_S
        self._sec_id = [-1] * QPS_WINDOW_S
        self._lock = threading.Lock()

    def observe_us(self, us: float) -> None:
        with self._lock:
            if len(self._samples) < self._window:
                self._samples.append(us)
            else:
                self._samples[self._pos] = us
                self._pos = (self._pos + 1) % self._window
            self._count += 1
            self._sum_us += us
            now_s = int(time.monotonic())
            i = now_s % QPS_WINDOW_S
            if self._sec_id[i] != now_s:
                self._sec_id[i] = now_s
                self._sec_hits[i] = 0
            self._sec_hits[i] += 1

    @staticmethod
    def _pick(ordered: List[float], p: float) -> float:
        """Percentile over a sorted window; 0.0 on an empty one."""
        if not ordered:
            return 0.0
        i = min(len(ordered) - 1, int(p / 100.0 * len(ordered)))
        return ordered[i]

    def percentile(self, p: float) -> float:
        with self._lock:
            return self._pick(sorted(self._samples), p)

    def stats(self) -> Dict[str, float]:
        now = time.monotonic()
        now_s = int(now)
        with self._lock:
            ordered = sorted(self._samples)
            count = self._count
            total_us = self._sum_us
            recent = sum(
                hits for sid, hits in zip(self._sec_id, self._sec_hits)
                if sid >= 0 and now_s - sid < QPS_WINDOW_S
            )
            age = now - self._t0
        n = len(ordered)
        return {
            "count": count,
            "sum_us": total_us,
            "qps": recent / max(min(age, float(QPS_WINDOW_S)), 1e-9),
            "avg_us": sum(ordered) / n if n else 0.0,
            "p50_us": self._pick(ordered, 50),
            "p99_us": self._pick(ordered, 99),
        }


def _series_key(name: str, region_id: Optional[int],
                labels: Optional[Dict[str, str]]) -> str:
    """`name{k=v,...}` series key: region first, free-form labels after,
    sorted."""
    parts: List[Tuple[str, str]] = []
    if region_id:
        parts.append(("region", str(region_id)))
    if labels:
        parts.extend(
            (k, str(v)) for k, v in sorted(labels.items()) if k != "region"
        )
    if not parts:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in parts) + "}"


class MetricsRegistry:
    """Named counters, gauges and latency recorders with a region
    dimension plus labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._latencies: Dict[str, LatencyRecorder] = {}

    def counter(self, name: str, region_id: Optional[int] = None,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        key = _series_key(name, region_id, labels)
        with self._lock:
            return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, region_id: Optional[int] = None,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        key = _series_key(name, region_id, labels)
        with self._lock:
            return self._gauges.setdefault(key, Gauge())

    def latency(self, name: str, region_id: Optional[int] = None,
                labels: Optional[Dict[str, str]] = None) -> LatencyRecorder:
        key = _series_key(name, region_id, labels)
        with self._lock:
            rec = self._latencies.get(key)
            if rec is None:
                rec = self._latencies[key] = LatencyRecorder()
            return rec

    def dump(self) -> Dict[str, object]:
        """/vars-style dump: series key -> value (a latency series -> its
        stats)."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            lats = list(self._latencies.items())
        out: Dict[str, object] = {}
        for k, c in counters:
            out[k] = c.get()
        for k, g in gauges:
            out[k] = g.get()
        for k, lr in lats:
            out[k] = lr.stats()
        return out


METRICS = MetricsRegistry()
