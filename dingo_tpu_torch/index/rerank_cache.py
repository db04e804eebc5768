"""Bounded device row cache for the exact rerank of bf16/sq8 shortlists
(port of dingo_tpu/index/rerank_cache.py).

The quantized tiers keep no full-precision rows on the device (that is the
memory they save), so an exact rerank needs a separate, bounded source of
true rows. The cache is a SlotStore of its own (no blocked mirror: no scan
reads it) keyed by the owning store's slots:

  offer()       the write path hands over the rows it already holds: rows
                of slots already cached always refresh (an upsert must not
                leave a stale row serving reranks), new slots fill the
                cache until max_rows.
  invalidate()  deletes drop the row (a reused slot must never rerank
                against a dead vector).
  device_map()  [store_capacity] int32 owning slot -> cache row (-1 when
                absent), rebuilt on the host and uploaded only when the
                cache changed or the owning store grew, so a search
                dispatches the rerank with no host synchronization.

The cache shares the owning store's device_lock: its rows are written
under it and captured by searches under it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from dingo_tpu_torch.common.device import upload
from dingo_tpu_torch.index.slot_store import SlotStore, _next_pow2


class DeviceRerankCache:
    def __init__(self, dim: int, max_rows: int, device: torch.device,
                 dtype: torch.dtype = torch.float32,
                 device_lock: Optional[threading.RLock] = None):
        if max_rows <= 0:
            raise ValueError(f"max_rows {max_rows}")
        self.max_rows = int(max_rows)
        self.inner = SlotStore(dim, device, capacity=_next_pow2(max_rows),
                               blocked=False, dtype=dtype)
        if device_lock is not None:
            self.inner.device_lock = device_lock
        self._dmap: Optional[torch.Tensor] = None
        self._map_capacity = 0

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def vecs(self) -> torch.Tensor:
        return self.inner.vecs

    @property
    def sqnorm(self) -> torch.Tensor:
        return self.inner.sqnorm

    def offer(self, slots: np.ndarray, rows: np.ndarray) -> int:
        """Insert or refresh rows keyed by owning-store slots; returns how
        many landed. Cached slots always update; new slots are admitted
        while the cache has room (every row of an admitted slot lands, so
        a slot repeated in one batch keeps the store's last write)."""
        slots = np.asarray(slots, np.int64)
        if not len(slots):
            return 0
        present = self.inner.slots_of(slots) >= 0
        take = present.copy()
        room = self.max_rows - len(self.inner)
        if room > 0:
            fresh = np.flatnonzero(~present)
            uniq, first = np.unique(slots[fresh], return_index=True)
            admitted = uniq[np.argsort(first)][:room]
            take[fresh] = np.isin(slots[fresh], admitted)
        if not take.any():
            return 0
        self.inner.put(slots[take], np.asarray(rows)[take])
        self._dmap = None
        return int(take.sum())

    def invalidate(self, slots: np.ndarray) -> int:
        n = int((self.inner.remove_slots(np.asarray(slots, np.int64))
                 >= 0).sum())
        if n:
            self._dmap = None
        return n

    def device_map(self, store_capacity: int) -> torch.Tensor:
        """[store_capacity] int32: owning slot -> cache row, -1 when
        absent."""
        if self._dmap is None or self._map_capacity != store_capacity:
            m = np.full((store_capacity,), -1, np.int32)
            cache_rows = np.flatnonzero(self.inner.ids_by_slot >= 0)
            if len(cache_rows):
                store_slots = self.inner.ids_by_slot[cache_rows]
                # drop entries past a (reloaded) smaller store
                ok = store_slots < store_capacity
                m[store_slots[ok]] = cache_rows[ok].astype(np.int32)
            self._dmap = upload(m, self.inner.device)
            self._map_capacity = store_capacity
        return self._dmap

    def memory_size(self) -> int:
        return self.inner.memory_size()
