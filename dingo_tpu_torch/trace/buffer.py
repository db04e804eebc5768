"""Bounded in-process retention for finished spans (port of
dingo_tpu/trace/buffer.py).

Two stores with different eviction pressure:

- a ring of the most recent sampled spans (overwritten oldest-first), the
  source of the JSON and Chrome exports;
- a slow-query log (deque) fed only by root spans that crossed
  ``slow_query_ms``, so a burst of fast traces cannot churn the slow
  evidence out of the ring.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional


class TraceBuffer:
    def __init__(self, capacity: int = 2048, slow_capacity: int = 256):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: List[Dict] = []
        self._pos = 0
        self._dropped = 0
        self._slow: deque = deque(maxlen=slow_capacity)

    def add(self, record: Dict) -> None:
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(record)
            else:
                self._ring[self._pos] = record
                self._pos = (self._pos + 1) % self.capacity
                self._dropped += 1

    def add_slow(self, record: Dict) -> None:
        with self._lock:
            self._slow.append(record)

    def snapshot(self, trace_id: Optional[str] = None,
                 limit: int = 0) -> List[Dict]:
        """Spans oldest-first, optionally filtered to one trace. `limit`
        keeps the newest n (0 = all)."""
        with self._lock:
            out = self._ring[self._pos:] + self._ring[:self._pos]
        if trace_id is not None:
            out = [r for r in out if r["trace_id"] == trace_id]
        if limit > 0:
            out = out[-limit:]
        return out

    def slow_queries(self) -> List[Dict]:
        with self._lock:
            return list(self._slow)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "buffered": len(self._ring),
                "capacity": self.capacity,
                "dropped": self._dropped,
                "slow": len(self._slow),
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pos = 0
            self._dropped = 0
            self._slow.clear()


TRACE_BUFFER = TraceBuffer()
