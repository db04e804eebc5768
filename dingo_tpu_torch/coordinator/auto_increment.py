"""AutoIncrementControl: table auto-increment id allocation (port of
dingo_tpu/coordinator/auto_increment.py).

Reference: src/coordinator/auto_increment_control.{h,cc}
(GenerateAutoIncrement auto_increment_control.h:72) — per-table counters
with batch allocation, persisted so ids never repeat across restarts.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.engine.raw_engine import CF_META, RawEngine

_PREFIX = b"AUTO_INCR_"


class AutoIncrementControl:
    def __init__(self, engine: RawEngine):
        self.engine = engine
        self._lock = threading.Lock()
        self._counters: Dict[int, int] = {}
        for k, v in engine.scan(CF_META, _PREFIX, _PREFIX + b"\xff"):
            self._counters[int(k[len(_PREFIX):])] = persist.loads(v)

    def create(self, table_id: int, start_id: int = 1) -> None:
        with self._lock:
            if table_id in self._counters:
                raise KeyError(f"auto-increment for table {table_id} exists")
            self._counters[table_id] = start_id
            self._persist(table_id)

    def generate(self, table_id: int, count: int = 1) -> Tuple[int, int]:
        """GenerateAutoIncrement: [first, first+count)."""
        with self._lock:
            if table_id not in self._counters:
                self._counters[table_id] = 1
            first = self._counters[table_id]
            self._counters[table_id] = first + count
            self._persist(table_id)
            return first, first + count

    def get(self, table_id: int) -> int:
        with self._lock:
            return self._counters.get(table_id, 0)

    def update(self, table_id: int, value: int, force: bool = False) -> None:
        with self._lock:
            cur = self._counters.get(table_id, 0)
            if force or value > cur:
                self._counters[table_id] = value
                self._persist(table_id)

    def delete(self, table_id: int) -> None:
        with self._lock:
            self._counters.pop(table_id, None)
            self.engine.delete(CF_META, _PREFIX + str(table_id).encode())

    def _persist(self, table_id: int) -> None:
        self.engine.put(
            CF_META,
            _PREFIX + str(table_id).encode(),
            persist.dumps(self._counters[table_id]),
        )
