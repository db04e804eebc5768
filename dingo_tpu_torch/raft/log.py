"""Raft log storage (port of dingo_tpu/raft/log.py).

Reference: src/log/ — RocksLogStorage (multi-region raft log in one RocksDB,
rocks_log_storage.h:180) and SegmentLogStorage (segment files). Key extra
duty: the vector index catch-up path reads committed data entries straight
from this log (GetDataEntries, vector_index_manager.cc:796), so the log
keeps entries until a snapshot truncates them.

Here: an in-memory list with an optional append-only file behind it
(segment-style); entries are (term, payload_bytes). Index 0 is a sentinel —
raft indices are 1-based like the paper.
"""

from __future__ import annotations

import os
import struct

from dingo_tpu_torch.raft import wire
import threading
from typing import List, Optional, Tuple

_REC_MAGIC = 0x5AF7106D


class RaftLog:
    def __init__(self, path: Optional[str] = None):
        self._lock = threading.RLock()
        # entries[i] corresponds to raft index first_index + i
        self._entries: List[Tuple[int, bytes]] = []
        self.first_index = 1          # index of entries[0]
        self.snapshot_index = 0       # last index covered by a snapshot
        self.snapshot_term = 0
        self._hard_term = 0           # persisted (term, voted_for)
        self._hard_vote: Optional[str] = None
        self._path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._replay()
            self._fh = open(path, "ab")

    # -- persistence ---------------------------------------------------------
    def _replay(self) -> None:
        if not os.path.exists(self._path):
            return
        good = 0
        with open(self._path, "rb") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                magic, ln = struct.unpack(">II", hdr)
                if magic != _REC_MAGIC:
                    break
                blob = f.read(ln)
                if len(blob) < ln:
                    break
                try:
                    rec = wire.decode(blob)
                except wire.WireError:
                    break  # torn/corrupt tail
                kind = rec[0]
                if kind == "append":
                    _, index, term, payload = rec
                    self._truncate_from_unlocked(index)
                    self._entries.append((term, payload))
                elif kind == "compact":
                    _, index, term = rec
                    self._apply_compaction(index, term)
                elif kind == "hard":
                    _, self._hard_term, self._hard_vote = rec
                good = f.tell()
        # truncate a torn tail so post-recovery appends are not written
        # after garbage (unreachable by the next replay = acked-entry loss)
        if os.path.getsize(self._path) > good:
            with open(self._path, "r+b") as f:
                f.truncate(good)

    def _write_rec(self, rec) -> None:
        if self._fh is None:
            return
        blob = wire.encode(list(rec))
        self._fh.write(struct.pack(">II", _REC_MAGIC, len(blob)) + blob)
        self._fh.flush()

    # -- hard state (term/vote survive restart: raft election safety) -------
    def hard_state(self):
        with self._lock:
            return self._hard_term, self._hard_vote

    def set_hard_state(self, term: int, voted_for: Optional[str]) -> None:
        with self._lock:
            self._hard_term, self._hard_vote = term, voted_for
            self._write_rec(("hard", term, voted_for))

    # -- core API ------------------------------------------------------------
    def last_index(self) -> int:
        with self._lock:
            return self.first_index + len(self._entries) - 1 if self._entries \
                else self.snapshot_index

    def last_term(self) -> int:
        with self._lock:
            if self._entries:
                return self._entries[-1][0]
            return self.snapshot_term

    def term_at(self, index: int) -> Optional[int]:
        with self._lock:
            if index == 0:
                return 0
            if index == self.snapshot_index:
                return self.snapshot_term
            i = index - self.first_index
            if 0 <= i < len(self._entries):
                return self._entries[i][0]
            return None

    def entry_at(self, index: int) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            i = index - self.first_index
            if 0 <= i < len(self._entries):
                return self._entries[i]
            return None

    def append(self, term: int, payload: bytes) -> int:
        with self._lock:
            index = self.last_index() + 1
            self._entries.append((term, payload))
            self._write_rec(("append", index, term, payload))
            return index

    def put_at(self, index: int, term: int, payload: bytes) -> None:
        """Follower append with conflict truncation."""
        with self._lock:
            self._truncate_from_unlocked(index)
            assert index == self.last_index() + 1, (index, self.last_index())
            self._entries.append((term, payload))
            self._write_rec(("append", index, term, payload))

    def _truncate_from_unlocked(self, index: int) -> None:
        i = index - self.first_index
        if i < len(self._entries):
            del self._entries[max(i, 0):]

    def entries_from(self, start: int, max_count: int = 256):
        """[(index, term, payload)] from `start`, bounded."""
        with self._lock:
            out = []
            idx = max(start, self.first_index)
            while idx <= self.last_index() and len(out) < max_count:
                term, payload = self._entries[idx - self.first_index]
                out.append((idx, term, payload))
                idx += 1
            return out

    def get_data_entries(self, start: int, end: int):
        """Committed payloads in [start, end] — the vector-index catch-up
        feed (vector_index_manager.cc:796 GetDataEntries)."""
        with self._lock:
            lo = max(start, self.first_index)
            if end < lo:
                return []
            return self.entries_from(lo, max_count=end - lo + 1)

    # -- compaction / snapshot ----------------------------------------------
    def _apply_compaction(self, index: int, term: int) -> None:
        keep_from = index + 1
        i = keep_from - self.first_index
        if i > 0:
            self._entries = self._entries[i:] if i <= len(self._entries) else []
            self.first_index = keep_from
        self.snapshot_index = index
        self.snapshot_term = term
        self.first_index = max(self.first_index, keep_from)

    def compact(self, index: int) -> None:
        """Drop entries <= index (after a snapshot covers them)."""
        with self._lock:
            term = self.term_at(index) or self.snapshot_term
            self._apply_compaction(index, term)
            self._write_rec(("compact", index, term))

    def install_snapshot_mark(self, index: int, term: int) -> None:
        """Follower received a full snapshot: reset the log to start after it."""
        with self._lock:
            self._entries = []
            self.first_index = index + 1
            self.snapshot_index = index
            self.snapshot_term = term
            self._write_rec(("compact", index, term))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
