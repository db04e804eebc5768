"""Named counters and gauges with a region dimension (the counter/gauge
part of dingo_tpu/common/metrics.py).

``METRICS`` keys each series as ``name{region=<id>,k=v,...}``, the JAX
package's series key, so a dump reads the same in both packages. The
latency recorder and Prometheus rendering are not ported yet.
"""

from __future__ import annotations

import threading
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

    def get(self) -> float:
        return self._value


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
    """Named counters and gauges with a region dimension plus labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

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

    def dump(self) -> Dict[str, object]:
        """/vars-style dump: series key -> value."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
        out: Dict[str, object] = {}
        for k, c in counters:
            out[k] = c.get()
        for k, g in gauges:
            out[k] = g.get()
        return out


METRICS = MetricsRegistry()
