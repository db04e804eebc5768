"""Device-resident slot store: the IndexIDMap2 equivalent (port of the fp32
``SlotStore`` in dingo_tpu/index/slot_store.py).

  host side   — ids_by_slot int64[capacity] (-1 = empty) + dict id->slot +
                free-slot list + validity bitmap. 64-bit external ids never
                go on the device; kernels work in slot space.
  device side — vecs[capacity, d] and sqnorm[capacity] f32 (cached
                ||x||^2) as torch tensors. Writes land in place, one slice
                assignment per contiguous slot run (fresh appends are one
                run, free slots are handed out ascending); the JAX package
                needed donated dynamic_update_slice programs for the same.
  blocked     — optional dimension-blocked mirror for the pruned FLAT scan
                (kernel B4): vecs_blk[nblk, capacity, dblk] plus per-block
                norms bsq_blk[nblk, capacity], written in the same slot runs.
  host        — HostSlotStore keeps the same bookkeeping with rows and
                norms in numpy (IVF_PQ with host_vectors).

Capacity grows by doubling. Deletes are host tombstones; slots freed while
searches are in flight park in limbo until the last lease ends, so an async
resolve never translates a reassigned slot.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from dingo_tpu_torch.common.config import blocked_layout_enabled
from dingo_tpu_torch.ops.blocked import (
    block_sqnorms,
    resolve_dim_block,
    to_blocked,
)

MIN_CAPACITY = 4096


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class SlotStore:
    def __init__(self, dim: int, device: torch.device,
                 capacity: int = MIN_CAPACITY,
                 blocked: Optional[bool] = None):
        self.dim = dim
        self.device = torch.device(device)
        self.dtype = torch.float32
        self.capacity = max(MIN_CAPACITY, _next_pow2(capacity))
        # dimension-blocked scan mirror, decided once here (flag
        # vector_blocked_layout, or `blocked` forces); None when off or
        # when the dimension does not block
        self.dim_block: Optional[int] = None
        self.nblk = 0
        self.vecs_blk: Optional[torch.Tensor] = None
        self.bsq_blk: Optional[torch.Tensor] = None
        if blocked is None:
            blocked = blocked_layout_enabled(self.device)
        if blocked and self._blocked_dtype_ok():
            self.dim_block = resolve_dim_block(dim)
            if self.dim_block:
                self.nblk = dim // self.dim_block
                self.vecs_blk = torch.zeros(
                    (self.nblk, self.capacity, self.dim_block),
                    dtype=self.dtype, device=self.device)
                self.bsq_blk = torch.zeros((self.nblk, self.capacity),
                                           dtype=torch.float32,
                                           device=self.device)
        #: bumped by put/remove/growth; keys caches of the slot<->id map
        self.mutation_version = 0
        self.vecs, self.sqnorm = self._alloc_storage(self.capacity)
        self.ids_by_slot = np.full((self.capacity,), -1, np.int64)
        self.valid_h = np.zeros((self.capacity,), np.bool_)
        self._dmask: Optional[torch.Tensor] = None
        self._id_to_slot: dict = {}
        self._free: list = list(range(self.capacity - 1, -1, -1))
        self._inflight = 0
        self._limbo: list = []
        # guards the _inflight/_limbo/_free transitions (a release racing a
        # writer must not drain a slot a search still has to translate)
        self._lease_lock = threading.Lock()
        # serializes device writes and growth against search dispatch: a
        # search captures vecs/sqnorm/the mask and launches under this lock
        self.device_lock = threading.RLock()

    # -- bookkeeping -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._id_to_slot)

    def __contains__(self, vid: int) -> bool:
        return int(vid) in self._id_to_slot

    def slots_of(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray(
            [self._id_to_slot.get(int(i), -1) for i in ids], np.int64
        )

    def ids_of_slots(self, slots: np.ndarray) -> np.ndarray:
        """Translate kernel-space slots (-1 allowed) back to external ids."""
        safe = np.where(slots >= 0, slots, 0)
        out = self.ids_by_slot[safe]
        return np.where(slots >= 0, out, -1)

    def device_mask(self) -> torch.Tensor:
        """Validity bitmap on the device, re-uploaded only after a change."""
        if self._dmask is None:
            self._dmask = torch.from_numpy(self.valid_h.copy()).to(
                self.device)
        return self._dmask

    def _blocked_dtype_ok(self) -> bool:
        """Tiers whose scan kernel reads a blocked mirror: f32 rows (the
        only tier ported)."""
        return self.dtype == torch.float32

    def memory_size(self) -> int:
        size = self.capacity * (self.dim * 4 + 8 + 4 + 1)
        if self.vecs_blk is not None:
            # blocked scan mirror: one more copy of the rows + block norms
            size += self.capacity * (self.dim * 4 + self.nblk * 4)
        return size

    def reserve(self, capacity: int) -> None:
        """Pre-size the device arrays (bulk ingest grows once)."""
        if capacity > self.capacity:
            self._grow(capacity)

    # -- row storage (HostSlotStore keeps it in numpy) ---------------------
    def _alloc_storage(self, capacity: int):
        return (torch.zeros((capacity, self.dim), dtype=self.dtype,
                            device=self.device),
                torch.zeros((capacity,), dtype=torch.float32,
                            device=self.device))

    def _grow_storage(self, pad: int):
        return (torch.cat([self.vecs, self.vecs.new_zeros((pad, self.dim))]),
                torch.cat([self.sqnorm, self.sqnorm.new_zeros((pad,))]))

    def _write_runs(self, runs, rows_h: np.ndarray) -> None:
        """Write rows sorted by slot; runs = [(lo, hi, first slot)] of
        contiguous slots, one slice assignment each."""
        rows = torch.from_numpy(rows_h).to(self.device)
        row_sq = (rows * rows).sum(dim=1)
        with self.device_lock:
            if self.vecs_blk is not None:
                rows_blk = to_blocked(rows, self.dim_block)
                row_bsq = block_sqnorms(rows, self.dim_block)
            for lo, hi, s0 in runs:
                self.vecs[s0:s0 + hi - lo] = rows[lo:hi]
                self.sqnorm[s0:s0 + hi - lo] = row_sq[lo:hi]
                if self.vecs_blk is not None:
                    self.vecs_blk[:, s0:s0 + hi - lo] = rows_blk[:, lo:hi]
                    self.bsq_blk[:, s0:s0 + hi - lo] = row_bsq[:, lo:hi]

    # -- mutation ----------------------------------------------------------
    def put(self, ids: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        """Insert/replace rows; returns the assigned slots."""
        n = len(ids)
        if n == 0:
            return np.empty(0, np.int64)
        slots = np.empty(n, np.int64)
        for i, vid in enumerate(ids):
            vid = int(vid)
            s = self._id_to_slot.get(vid)
            if s is None:
                if not self._free:
                    self._grow(max(self.capacity * 2,
                                   _next_pow2(self.capacity + n)))
                s = self._free.pop()
                self._id_to_slot[vid] = s
                self.ids_by_slot[s] = vid
            slots[i] = s
        vectors = np.asarray(vectors, np.float32)
        order = np.argsort(slots, kind="stable")
        sslots = slots[order]
        run_starts = np.flatnonzero(np.diff(sslots) != 1) + 1
        runs = [(int(lo), int(hi), int(sslots[lo])) for lo, hi in zip(
            np.concatenate([[0], run_starts]),
            np.concatenate([run_starts, [n]]))]
        self._write_runs(runs, np.ascontiguousarray(vectors[order]))
        self.valid_h[slots] = True
        self._dmask = None
        self.mutation_version += 1
        return slots

    def remove_slots(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone rows; returns each id's former slot (-1 if absent)."""
        slots = np.full(len(ids), -1, np.int64)
        removed = 0
        with self._lease_lock:
            dest = self._limbo if self._inflight > 0 else self._free
            for i, vid in enumerate(ids):
                s = self._id_to_slot.pop(int(vid), None)
                if s is not None:
                    self.ids_by_slot[s] = -1
                    self.valid_h[s] = False
                    dest.append(s)
                    slots[i] = s
                    removed += 1
        if removed:
            self._dmask = None
            self.mutation_version += 1
        return slots

    # -- in-flight search accounting --------------------------------------
    def begin_search(self) -> "SearchLease":
        with self._lease_lock:
            self._inflight += 1
        return SearchLease(self)

    def end_search(self) -> None:
        with self._lease_lock:
            self._inflight -= 1
            if self._inflight == 0 and self._limbo:
                self._free.extend(self._limbo)
                self._limbo.clear()

    def _grow(self, new_capacity: int) -> None:
        new_capacity = _next_pow2(new_capacity)
        pad = new_capacity - self.capacity
        with self.device_lock:
            self.vecs, self.sqnorm = self._grow_storage(pad)
            if self.vecs_blk is not None:
                self.vecs_blk = torch.cat(
                    [self.vecs_blk, self.vecs_blk.new_zeros(
                        (self.nblk, pad, self.dim_block))], dim=1)
                self.bsq_blk = torch.cat(
                    [self.bsq_blk, self.bsq_blk.new_zeros((self.nblk, pad))],
                    dim=1)
        self.ids_by_slot = np.concatenate(
            [self.ids_by_slot, np.full((pad,), -1, np.int64)]
        )
        self.valid_h = np.concatenate(
            [self.valid_h, np.zeros((pad,), np.bool_)]
        )
        self._dmask = None
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self.capacity = new_capacity
        self.mutation_version += 1

    # -- host round-trips --------------------------------------------------
    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        """f32 rows at `slots` as a device tensor (train-path gather: only
        slot indices cross to the device, the rows never leave it)."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        with self.device_lock:
            return self.vecs[idx]

    def to_host(self) -> dict:
        """Compacted host snapshot {ids, vectors} of live rows (save path)."""
        live = np.flatnonzero(self.ids_by_slot >= 0)
        idx = torch.as_tensor(live, device=self.device)
        with self.device_lock:
            vecs_h = self.vecs[idx].cpu().numpy()
        return {"ids": self.ids_by_slot[live], "vectors": vecs_h}

    @classmethod
    def from_host(cls, dim: int, device, ids: np.ndarray,
                  vectors: np.ndarray,
                  capacity: Optional[int] = None,
                  blocked: Optional[bool] = None) -> "SlotStore":
        store = cls(dim, device, capacity or max(MIN_CAPACITY, len(ids)),
                    blocked=blocked)
        if len(ids):
            store.put(np.asarray(ids, np.int64), vectors)
        return store


class HostSlotStore(SlotStore):
    """SlotStore whose rows and norms live in host memory (numpy), for an
    index whose search never reads full rows from the device (IVF_PQ with
    host_vectors: it scans codes and reranks from host rows at resolve).
    Bookkeeping is SlotStore's; `device` is where rows_device uploads.
    fp32 only, and never a blocked mirror."""

    def _blocked_dtype_ok(self) -> bool:
        return False

    def _alloc_storage(self, capacity: int):
        return (np.zeros((capacity, self.dim), np.float32),
                np.zeros((capacity,), np.float32))

    def _grow_storage(self, pad: int):
        return (np.concatenate([self.vecs, np.zeros((pad, self.dim),
                                                    np.float32)]),
                np.concatenate([self.sqnorm, np.zeros((pad,), np.float32)]))

    def _write_runs(self, runs, rows_h: np.ndarray) -> None:
        sq = (rows_h * rows_h).sum(axis=1)
        with self.device_lock:
            for lo, hi, s0 in runs:
                self.vecs[s0:s0 + hi - lo] = rows_h[lo:hi]
                self.sqnorm[s0:s0 + hi - lo] = sq[lo:hi]

    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        # the host gather is the upload
        rows = self.vecs[np.asarray(slots, np.int64)]
        return torch.from_numpy(rows).to(self.device)

    def to_host(self) -> dict:
        live = np.flatnonzero(self.ids_by_slot >= 0)
        return {"ids": self.ids_by_slot[live], "vectors": self.vecs[live]}

    def memory_size(self) -> int:
        # host bytes; the device holds only the owner's codes and centroids
        return int(self.vecs.nbytes + self.sqnorm.nbytes)


class SearchLease:
    """Pairs begin_search with exactly one end_search, even when the caller
    drops the resolve thunk (release() is idempotent; __del__ backstops)."""

    __slots__ = ("_store", "_done")

    def __init__(self, store: SlotStore):
        self._store = store
        self._done = False

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._store.end_search()

    def __del__(self):  # noqa: D105
        self.release()
