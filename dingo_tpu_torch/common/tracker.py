"""Per-request latency tracker (port of
dingo_tpu/common/tracker.py).

Reference: src/common/tracker.{h,cc} (tracker.h:30-124) — a Tracker rides in
the request context recording stage timestamps: service-queue wait, raft
commit wait, store-write, vector-index-write, plus a RocksDB PerfContext
snapshot; IndexService attaches it (index_service.cc:291-292) and
VectorSearchDebug returns the breakdown.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class Tracker:
    __slots__ = ("created_ns", "_marks", "_spans", "_open")

    def __init__(self):
        self.created_ns = time.perf_counter_ns()
        self._marks: Dict[str, int] = {}
        self._spans: Dict[str, int] = {}
        self._open: Dict[str, int] = {}

    # -- stage spans ---------------------------------------------------------
    def begin(self, stage: str) -> None:
        self._open[stage] = time.perf_counter_ns()

    def end(self, stage: str) -> None:
        t0 = self._open.pop(stage, None)
        if t0 is not None:
            self._spans[stage] = self._spans.get(stage, 0) + (
                time.perf_counter_ns() - t0
            )

    def mark(self, event: str) -> None:
        self._marks[event] = time.perf_counter_ns() - self.created_ns

    class _Span:
        __slots__ = ("tracker", "stage")

        def __init__(self, tracker: "Tracker", stage: str):
            self.tracker = tracker
            self.stage = stage

        def __enter__(self):
            self.tracker.begin(self.stage)
            return self

        def __exit__(self, *exc):
            self.tracker.end(self.stage)
            return False

    def span(self, stage: str) -> "_Span":
        return self._Span(self, stage)

    # -- report --------------------------------------------------------------
    def total_us(self) -> float:
        return (time.perf_counter_ns() - self.created_ns) / 1000.0

    def report(self) -> Dict[str, float]:
        """Stage durations in microseconds (VectorSearchDebug response)."""
        out = {k: v / 1000.0 for k, v in self._spans.items()}
        out["total_us"] = self.total_us()
        return out
