"""Raw KV engine interface + implementations
(port of dingo_tpu/engine/raw_engine.py).

Reference: src/engine/raw_engine.h defines the abstract RawEngine over named
column families (common/constant.h:43-55: default, vector_scalar,
vector_scalar_key_speed_up, vector_table, txn data/lock/write, meta), with
RocksRawEngine as the production engine (rocks_raw_engine.{h,cc}) and
MemEngine for tests (mem_engine.h).

Here: MemEngine is a sorted in-memory CF map (tests + raft apply target);
WalEngine adds crash-safe persistence via an append-only WAL + checkpoint
snapshots — functionally covering RocksRawEngine's role (persistence,
checkpoint for raft snapshots, ingest) with a pure-Python LSM-lite. A C++
LSM engine is a planned upgrade; the interface below is what the rest of
the stack codes against.
"""

from __future__ import annotations

import bisect
import os
import struct

from dingo_tpu_torch.raft import wire
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from dingo_tpu_torch.trace import TRACER

# Column family names (common/constant.h:43-55)
CF_DEFAULT = "default"
CF_META = "meta"
CF_VECTOR_SCALAR = "vector_scalar"
CF_VECTOR_SCALAR_SPEEDUP = "vector_scalar_key_speed_up"
CF_VECTOR_TABLE = "vector_table"
CF_TXN_DATA = "data"
CF_TXN_LOCK = "lock"
CF_TXN_WRITE = "write"

ALL_CFS = (
    CF_DEFAULT,
    CF_META,
    CF_VECTOR_SCALAR,
    CF_VECTOR_SCALAR_SPEEDUP,
    CF_VECTOR_TABLE,
    CF_TXN_DATA,
    CF_TXN_LOCK,
    CF_TXN_WRITE,
)


class SortedKv:
    """Sorted byte-key map with range scans (one column family)."""

    __slots__ = ("_keys", "_map")

    def __init__(self):
        self._keys: List[bytes] = []
        self._map: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes) -> None:
        if key not in self._map:
            bisect.insort(self._keys, key)
        self._map[key] = value

    def get(self, key: bytes) -> Optional[bytes]:
        return self._map.get(key)

    def delete(self, key: bytes) -> bool:
        if key in self._map:
            del self._map[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]
            return True
        return False

    def scan(
        self, start: bytes = b"", end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """[start, end) ascending."""
        i = bisect.bisect_left(self._keys, start)
        while i < len(self._keys):
            k = self._keys[i]
            if end is not None and k >= end:
                return
            yield k, self._map[k]
            i += 1

    def scan_reverse(
        self, start: bytes = b"", end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """[start, end) descending."""
        hi = bisect.bisect_left(self._keys, end) if end is not None else len(self._keys)
        lo = bisect.bisect_left(self._keys, start)
        for i in range(hi - 1, lo - 1, -1):
            k = self._keys[i]
            yield k, self._map[k]

    def delete_range(self, start: bytes, end: Optional[bytes]) -> int:
        """[start, end); end None = to the end of the CF."""
        lo = bisect.bisect_left(self._keys, start)
        hi = (bisect.bisect_left(self._keys, end) if end is not None
              else len(self._keys))
        doomed = self._keys[lo:hi]
        for k in doomed:
            del self._map[k]
        del self._keys[lo:hi]
        return len(doomed)

    def count(self, start: bytes = b"", end: Optional[bytes] = None) -> int:
        lo = bisect.bisect_left(self._keys, start)
        hi = bisect.bisect_left(self._keys, end) if end is not None else len(self._keys)
        return hi - lo

    def __len__(self) -> int:
        return len(self._map)


class WriteBatch:
    """Atomic multi-CF mutation (RocksDB WriteBatch equivalent)."""

    def __init__(self):
        self.ops: List[Tuple[str, str, bytes, bytes]] = []

    def put(self, cf: str, key: bytes, value: bytes) -> "WriteBatch":
        self.ops.append(("put", cf, key, value))
        return self

    def delete(self, cf: str, key: bytes) -> "WriteBatch":
        self.ops.append(("del", cf, key, b""))
        return self

    def delete_range(
        self, cf: str, start: bytes, end: Optional[bytes]
    ) -> "WriteBatch":
        """end None = unbounded (to the end of the CF) — an encoded empty
        key sorts BELOW every real key, so it must never be used as an
        upper bound."""
        self.ops.append(("delr", cf, start, end))
        return self


class RawEngine:
    """Abstract raw engine (raw_engine.h)."""

    def get(self, cf: str, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def write(self, batch: WriteBatch) -> None:
        raise NotImplementedError

    def scan(self, cf, start=b"", end=None):
        raise NotImplementedError

    def scan_reverse(self, cf, start=b"", end=None):
        raise NotImplementedError

    def count(self, cf, start=b"", end=None) -> int:
        raise NotImplementedError

    # convenience single ops
    def put(self, cf: str, key: bytes, value: bytes) -> None:
        self.write(WriteBatch().put(cf, key, value))

    def delete(self, cf: str, key: bytes) -> None:
        self.write(WriteBatch().delete(cf, key))

    def checkpoint(self, path: str) -> None:
        raise NotImplementedError

    def restore_checkpoint(self, path: str) -> None:
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027
        pass


class MemEngine(RawEngine):
    """In-memory engine (reference mem_engine.h) — also the memtable of
    WalEngine and the raft-apply target in tests."""

    def __init__(self):
        self._cfs: Dict[str, SortedKv] = {cf: SortedKv() for cf in ALL_CFS}
        self._lock = threading.RLock()

    def cf(self, name: str) -> SortedKv:
        kv = self._cfs.get(name)
        if kv is None:
            with self._lock:
                kv = self._cfs.setdefault(name, SortedKv())
        return kv

    def get(self, cf, key):
        with self._lock:
            return self.cf(cf).get(key)

    def write(self, batch: WriteBatch) -> None:
        with TRACER.start_span("engine.write") as span:
            span.set_attr("ops", len(batch.ops))
            with self._lock:
                for op, cf, a, b in batch.ops:
                    kv = self.cf(cf)
                    if op == "put":
                        kv.put(a, b)
                    elif op == "del":
                        kv.delete(a)
                    elif op == "delr":
                        kv.delete_range(a, b)

    def scan(self, cf, start=b"", end=None):
        with self._lock:
            return list(self.cf(cf).scan(start, end))

    def scan_reverse(self, cf, start=b"", end=None):
        with self._lock:
            return list(self.cf(cf).scan_reverse(start, end))

    def count(self, cf, start=b"", end=None):
        with self._lock:
            return self.cf(cf).count(start, end)

    def snapshot_state(self) -> Dict[str, List[Tuple[bytes, bytes]]]:
        with self._lock:
            return {
                name: list(kv.scan()) for name, kv in self._cfs.items() if len(kv)
            }

    def load_state(self, state: Dict[str, List[Tuple[bytes, bytes]]]) -> None:
        with self._lock:
            self._cfs = {cf: SortedKv() for cf in ALL_CFS}
            for name, pairs in state.items():
                kv = self.cf(name)
                for k, v in pairs:
                    kv.put(k, v)

    def checkpoint(self, path: str) -> None:
        """Atomic: state is written to a temp file and renamed, so a crash
        mid-checkpoint leaves the previous checkpoint intact."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, "mem.ckpt")
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(wire.encode(self.snapshot_state()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)

    def restore_checkpoint(self, path: str) -> None:
        with open(os.path.join(path, "mem.ckpt"), "rb") as f:
            self.load_state(wire.decode(f.read()))


_WAL_MAGIC = 0xD1460A11


class WalEngine(MemEngine):
    """Crash-safe engine: MemEngine + append-only WAL + checkpoints.

    Write path: serialize the batch, append to WAL (fsync optional), apply to
    the memtable. Recovery: load last checkpoint, replay WAL tail. Covers the
    RocksRawEngine duties the stack needs today (durability, checkpoint for
    raft snapshots); compaction == checkpoint + WAL truncation.
    """

    def __init__(self, path: str, fsync: bool = False,
                 checkpoint_threshold_bytes: Optional[int] = None):
        super().__init__()
        from dingo_tpu_torch.common.config import FLAGS

        self.path = path
        self.fsync = fsync
        self.checkpoint_threshold_bytes = (
            checkpoint_threshold_bytes
            if checkpoint_threshold_bytes is not None
            else FLAGS.get("wal_checkpoint_bytes")
        )
        os.makedirs(path, exist_ok=True)
        self._wal_path = os.path.join(path, "wal.log")
        self._ckpt_dir = os.path.join(path, "checkpoint")
        import threading

        self._wal_lock = threading.Lock()
        self._recover()
        self._wal = open(self._wal_path, "ab")
        self._wal_bytes = os.path.getsize(self._wal_path)

    def _recover(self) -> None:
        if os.path.isdir(self._ckpt_dir):
            try:
                super().restore_checkpoint(self._ckpt_dir)
            except FileNotFoundError:
                pass
        if os.path.exists(self._wal_path):
            good = 0
            with open(self._wal_path, "rb") as f:
                while True:
                    hdr = f.read(8)
                    if len(hdr) < 8:
                        break
                    magic, ln = struct.unpack(">II", hdr)
                    if magic != _WAL_MAGIC:
                        break  # torn/corrupt tail
                    blob = f.read(ln)
                    if len(blob) < ln:
                        break
                    try:
                        ops = wire.decode(blob)
                    except wire.WireError:
                        break  # torn/corrupt tail
                    batch = WriteBatch()
                    batch.ops = [tuple(op) for op in ops]
                    MemEngine.write(self, batch)
                    good = f.tell()
            # truncate the torn tail BEFORE reopening for append: new
            # records written after garbage would be unreachable by the
            # next restart's replay (silent loss of acked writes)
            if os.path.getsize(self._wal_path) > good:
                with open(self._wal_path, "r+b") as f:
                    f.truncate(good)

    def write(self, batch: WriteBatch) -> None:
        blob = wire.encode([list(op) for op in batch.ops])
        # one lock serializes WAL append + memtable apply + rotation:
        # multiple raft apply threads share this engine, and a rotation
        # closing self._wal mid-append would drop an acked write
        with TRACER.start_span("engine.wal_write") as span, self._wal_lock:
            span.set_attr("bytes", len(blob))
            self._wal.write(struct.pack(">II", _WAL_MAGIC, len(blob)) + blob)
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())
            self._wal_bytes += 8 + len(blob)
            super().write(batch)
            # bounded restart: once the WAL outgrows the threshold, fold it
            # into a checkpoint and truncate (RocksDB flush+compaction
            # analog; round-1 replayed an unbounded WAL on every start)
            if self._wal_bytes >= self.checkpoint_threshold_bytes:
                self._checkpoint_locked()

    def checkpoint(self, path: Optional[str] = None) -> None:
        """Checkpoint + truncate WAL (RocksDB checkpoint analog used by the
        raft snapshot path, dingo_filesystem_adaptor.h:42-115)."""
        if path is not None and path != self._ckpt_dir:
            super().checkpoint(path)   # snapshot elsewhere; WAL untouched
            return
        with self._wal_lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        super().checkpoint(self._ckpt_dir)
        self._wal.close()
        self._wal = open(self._wal_path, "wb")
        self._wal_bytes = 0

    def close(self) -> None:
        self._wal.close()
