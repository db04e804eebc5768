"""TsoControl: the cluster timestamp oracle (port of
dingo_tpu/coordinator/tso.py).

Reference: src/coordinator/tso_control.{h,cc} — TsoTimestamp is physical
milliseconds + an 18-bit logical counter (tso_control.h:92,173-175),
raft-replicated; it leases BatchTs blocks to stores' TsProviders. The safety
invariant: after failover the new oracle must never re-issue timestamps, so
the high-water physical mark persists ahead of issuance (save_interval
semantics).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.engine.raw_engine import CF_META, RawEngine
from dingo_tpu_torch.mvcc.ts_provider import TSO_LOGICAL_BITS, compose_ts

_KEY = b"TSO_HIGH_WATER"
#: persist the physical watermark this far ahead (ms)
SAVE_AHEAD_MS = 3000


class TsoControl:
    def __init__(self, engine: RawEngine, clock_init: bool = True):
        """clock_init=False (raft-meta mode) initializes the physical mark
        from PERSISTED state only: seeding from the local wall clock would
        let a clock-skewed leader issue timestamps above anything recorded
        in the replicated log, which a failover successor (whose state is
        exactly the applied log) could then re-issue. Deterministic mode
        takes time exclusively from the now_ms the leader stamps into each
        replicated gen_ts op."""
        self.engine = engine
        self._lock = threading.Lock()
        blob = engine.get(CF_META, _KEY)
        persisted = persist.loads(blob) if blob else 0
        # never go below the persisted watermark (failover safety)
        self._physical = max(
            persisted, int(time.time() * 1000) if clock_init else 0
        )
        self._logical = 0
        self._persisted_until = persisted
        if clock_init:
            self._save_ahead()

    def _save_ahead(self) -> None:
        target = self._physical + SAVE_AHEAD_MS
        if target > self._persisted_until:
            self.engine.put(CF_META, _KEY, persist.dumps(target))
            self._persisted_until = target

    def gen_ts(self, count: int = 1, *,
               now_ms: Optional[int] = None) -> Tuple[int, int]:
        """GenerateTso: a contiguous block [first, first+count). In
        raft-meta mode now_ms is the leader's stamp so the op applies
        identically on every replica."""
        with self._lock:
            now = now_ms if now_ms is not None else int(time.time() * 1000)
            if now > self._physical:
                self._physical = now
                self._logical = 0
            first = compose_ts(self._physical, self._logical)
            self._logical += count
            while self._logical >= (1 << TSO_LOGICAL_BITS):
                self._physical += 1
                self._logical -= 1 << TSO_LOGICAL_BITS
            self._save_ahead()
            return first, count

    def current(self) -> int:
        with self._lock:
            return compose_ts(self._physical, self._logical)

    def advance_to(self, ts: int) -> None:
        """Never hand out timestamps at or below `ts` again (restore path:
        a restored cluster must stay ahead of every ts the backed-up
        cluster issued)."""
        with self._lock:
            physical = ts >> TSO_LOGICAL_BITS
            if physical >= self._physical:
                self._physical = physical + 1
                self._logical = 0
                self._save_ahead()
