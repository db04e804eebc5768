"""Trace exporters: a JSON dump and Chrome ``trace_event`` files (port of
dingo_tpu/trace/export.py).

The Chrome format (one ``X`` complete event per span, microsecond
timestamps) loads in chrome://tracing and Perfetto; pid groups a process
and tid lanes follow the OS thread each span ran on, so the coalescer's
queue wait (caller thread) and batch run (flush thread) land on different
lanes of the same trace. The schema is the JAX package's, so
tools/trace_report.py reads both.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from dingo_tpu_torch.trace.buffer import TRACE_BUFFER


def to_json(records: Optional[List[Dict]] = None,
            slow: Optional[List[Dict]] = None) -> Dict:
    """Spans grouped by trace id (oldest-first within a trace) plus the
    slow-query log and the buffer's counters."""
    if records is None:
        records = TRACE_BUFFER.snapshot()
    if slow is None:
        slow = TRACE_BUFFER.slow_queries()
    traces: Dict[str, List[Dict]] = {}
    for rec in records:
        traces.setdefault(rec["trace_id"], []).append(rec)
    return {
        "traces": traces,
        "slow_queries": slow,
        "stats": TRACE_BUFFER.stats(),
    }


def to_chrome_trace(records: Optional[List[Dict]] = None) -> Dict:
    """Chrome trace_event JSON object (the object form with a
    ``traceEvents`` array, which Perfetto also accepts)."""
    if records is None:
        records = TRACE_BUFFER.snapshot()
    pid = os.getpid()
    events = []
    for rec in records:
        args = {
            "trace_id": rec["trace_id"],
            "span_id": rec["span_id"],
            "parent_id": rec["parent_id"],
            "status": rec["status"],
        }
        args.update(rec["attrs"])
        events.append({
            "name": rec["name"],
            "cat": "dingo",
            "ph": "X",
            "ts": rec["start_us"],
            "dur": max(rec["dur_us"], 1),   # 0-width events vanish in the UI
            "pid": pid,
            "tid": rec["thread"],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path: str,
                      records: Optional[List[Dict]] = None) -> str:
    """Write the Chrome trace file; returns the path."""
    payload = to_chrome_trace(records)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path
