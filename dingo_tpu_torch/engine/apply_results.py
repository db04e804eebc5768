"""Apply-result side channel shared by the replication engines
(port of dingo_tpu/engine/apply_results.py).

A proposer that needs the APPLIED outcome of its own write (e.g. the exact
delete_range count — a pre-propose scan races concurrent writes) registers
a waiter before proposing; the apply path computes result payloads only for
entries whose (region, payload-type) has a live local waiter, so followers
and restart replay never pay for result computation that nobody collects.

Bounded FIFO: results a waiter never collected (leadership lost between
apply and collection) are evicted oldest-first.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class ApplyResultBuffer:
    MAX_ENTRIES = 256

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._results: Dict[Tuple[int, int], dict] = {}
        # (region_id, payload type name) -> number of local proposers
        # currently waiting on a result of that type
        self._waiters: Dict[Tuple[int, str], int] = {}

    # -- proposer side -------------------------------------------------------
    def register_waiter(self, region_id: int, data) -> Tuple[int, str]:
        key = (region_id, type(data).__name__)
        with self._lock:
            self._waiters[key] = self._waiters.get(key, 0) + 1
        return key

    def unregister_waiter(self, key: Tuple[int, str]) -> None:
        with self._lock:
            n = self._waiters.get(key, 1) - 1
            if n <= 0:
                self._waiters.pop(key, None)
            else:
                self._waiters[key] = n

    def take(self, region_id: int, log_id: int) -> Optional[dict]:
        with self._lock:
            return self._results.pop((region_id, log_id), None)

    # -- apply side ----------------------------------------------------------
    def wanted(self, region_id: int, data) -> bool:
        with self._lock:
            return self._waiters.get(
                (region_id, type(data).__name__), 0
            ) > 0

    def record(self, region_id: int, log_id: int, result: dict) -> None:
        with self._lock:
            self._results[(region_id, log_id)] = result
            while len(self._results) > self.MAX_ENTRIES:
                self._results.pop(next(iter(self._results)))
