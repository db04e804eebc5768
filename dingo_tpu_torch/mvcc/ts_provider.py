"""Timestamp provisioning (port of dingo_tpu/mvcc/ts_provider.py).

Reference: mvcc::TsProvider (src/mvcc/ts_provider.h:40) leases BatchTs blocks
from the coordinator's TSO oracle (src/coordinator/tso_control.h:92-175:
TsoTimestamp = physical milliseconds + 18-bit logical counter) and hands out
timestamps from the lease with a local atomic, refreshing in the background
when the block runs low.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

TSO_LOGICAL_BITS = 18


def compose_ts(physical_ms: int, logical: int) -> int:
    return (physical_ms << TSO_LOGICAL_BITS) | logical


def decompose_ts(ts: int) -> Tuple[int, int]:
    return ts >> TSO_LOGICAL_BITS, ts & ((1 << TSO_LOGICAL_BITS) - 1)


class LocalTsOracle:
    """Standalone TSO for single-node / test deployments (the coordinator's
    TsoControl serves this role in a cluster — coordinator/tso.py)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_physical = 0
        self._logical = 0

    def generate(self, count: int) -> Tuple[int, int]:
        """Returns (first_ts, count): a contiguous block."""
        with self._lock:
            now = int(time.time() * 1000)
            if now > self._last_physical:
                self._last_physical = now
                self._logical = 0
            first = compose_ts(self._last_physical, self._logical)
            self._logical += count
            # logical overflow rolls physical forward (tso_control semantics)
            while self._logical >= (1 << TSO_LOGICAL_BITS):
                self._last_physical += 1
                self._logical -= 1 << TSO_LOGICAL_BITS
            return first, count


class TsProvider:
    """Batched ts allocation with lease refill (ts_provider.h:40)."""

    def __init__(
        self,
        source: Optional[Callable[[int], Tuple[int, int]]] = None,
        batch_size: int = 8192,
    ):
        self._source = source or LocalTsOracle().generate
        self._batch = batch_size
        self._lock = threading.Lock()
        self._next = 0
        self._limit = 0

    def get_ts(self) -> int:
        with self._lock:
            if self._next >= self._limit:
                first, count = self._source(self._batch)
                self._next, self._limit = first, first + count
            ts = self._next
            self._next += 1
            return ts
