"""Key latches + in-flight lock table for txn serialization (port of
dingo_tpu/engine/concurrency.py).

Reference: src/common/latch.{h,cc} (sharded wait-queue key latches, latch.h:
27-95) + src/engine/concurrency_manager.{h,cc} (LockKey/CheckKeys,
concurrency_manager.h:50-54): concurrent txn requests touching overlapping
key sets serialize before running conflict checks, so prewrite check+write
is atomic per key.

Sharded, refcounted: a key's lock slot is created on first acquisition and
removed when its last holder releases (the reference drops drained wait
queues the same way), so the table doesn't grow with the keyspace.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterable, List

_NUM_SHARDS = 64


class Latches:
    """Sharded refcounted key latches; acquire in sorted order (no deadlock)."""

    def __init__(self, shards: int = _NUM_SHARDS):
        self._shards = [
            (threading.Lock(), {}) for _ in range(shards)
        ]  # (guard, {key: [lock, refcount]})

    def _shard(self, key: bytes):
        return self._shards[hash(key) % len(self._shards)]

    @contextmanager
    def acquire(self, keys: Iterable[bytes]):
        ordered = sorted(set(keys))
        held = []
        for k in ordered:
            guard, table = self._shard(k)
            with guard:
                ent = table.get(k)
                if ent is None:
                    ent = [threading.Lock(), 0]
                    table[k] = ent
                ent[1] += 1
            ent[0].acquire()
            held.append((k, ent))
        try:
            yield
        finally:
            for k, ent in reversed(held):
                ent[0].release()
                guard, table = self._shard(k)
                with guard:
                    ent[1] -= 1
                    if ent[1] == 0 and table.get(k) is ent:
                        del table[k]


class ConcurrencyManager:
    """Txn-level wrapper: latch the key set for the duration of a
    check-then-write critical section."""

    def __init__(self):
        self.latches = Latches()

    def with_keys(self, keys: Iterable[bytes]):
        return self.latches.acquire(keys)
