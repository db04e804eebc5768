"""Stream: generic paging abstraction for long scans (port of
dingo_tpu/common/stream.py).

Reference: src/common/stream.{h,cc} (stream.h:47-105) — a StreamManager hands
out stream ids; each request either opens a stream (first page) or continues
one (stream_id + release flag); server-side state carries the scan cursor.
Used by TxnScan / ScanLock / KvScan v2. Idle streams are recycled by a
crontab (scan_manager auto-release, server.cc:555-582) — the scan-session
layer (ScanManager v1/v2) is this plus per-scan ownership.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Dict, Generic, Iterator, List, Optional, Tuple


class Stream:
    def __init__(self, stream_id: str, source: Iterator, limit: int):
        self.id = stream_id
        self._source = source
        self.limit = limit
        self.last_active_ms = int(time.time() * 1000)
        self.finished = False
        #: serializes concurrent pagers — two in-flight continues on one
        #: generator would raise 'generator already executing'
        self._lock = threading.Lock()

    def next_page(self, limit: Optional[int] = None) -> Tuple[List[Any], bool]:
        """Returns (items, has_more)."""
        with self._lock:
            self.last_active_ms = int(time.time() * 1000)
            n = limit or self.limit
            items: List[Any] = []
            try:
                for _ in range(n):
                    items.append(next(self._source))
            except StopIteration:
                self.finished = True
                return items, False
            return items, True


class StreamManager:
    """StreamManager (stream.h) + ScanManager session recycling."""

    def __init__(self, idle_timeout_s: float = 60.0):
        self._lock = threading.Lock()
        self._streams: Dict[str, Stream] = {}
        self.idle_timeout_s = idle_timeout_s

    def open(self, source: Iterator, limit: int = 1000) -> Stream:
        stream = Stream(uuid.uuid4().hex, source, limit)
        with self._lock:
            self._streams[stream.id] = stream
        return stream

    def get(self, stream_id: str) -> Optional[Stream]:
        with self._lock:
            return self._streams.get(stream_id)

    def release(self, stream_id: str) -> None:
        with self._lock:
            self._streams.pop(stream_id, None)

    def recycle_idle(self) -> int:
        """Crontab entry (scan session GC, server.cc:555-582)."""
        now = int(time.time() * 1000)
        doomed = []
        with self._lock:
            for sid, s in self._streams.items():
                if s.finished or now - s.last_active_ms > self.idle_timeout_s * 1000:
                    doomed.append(sid)
            for sid in doomed:
                del self._streams[sid]
        return len(doomed)

    def count(self) -> int:
        with self._lock:
            return len(self._streams)
