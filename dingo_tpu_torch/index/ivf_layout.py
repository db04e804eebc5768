"""Skew-proof bucketed IVF layout (port of dingo_tpu/index/ivf_layout.py).

  data        [B, cap_list, d]   B = sum_l ceil(count_l / cap_list)  (>= nlist)
  bucket_slot [B, cap_list]      slot per row, -1 pad
  probe_table [nlist, max_spill] bucket ids per coarse list, -1 pad

The bucket width sits near the MEAN list size and a long list spills into
several fixed-width buckets, so memory is bounded by n*d + nlist*cap*d
whatever the assignment skew. Probe expansion (coarse list -> its spill
buckets) runs on the device. Host bookkeeping is numpy, as in the JAX
package; the device mirrors are torch tensors updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dingo_tpu_torch.common.device import upload
from dingo_tpu_torch.index.slot_store import _next_pow2

MIN_CAP = 8
MAX_CAP = 2048


@dataclasses.dataclass
class BucketLayout:
    """Host-side layout description (the device copies live on the
    MutableIvfView that wraps it)."""

    cap_list: int
    max_spill: int
    nbuckets: int
    bucket_slot_h: np.ndarray      # [B, cap_list] int32, -1 pad
    probe_table_h: np.ndarray      # [nlist, max_spill] int32, -1 pad
    bucket_coarse_h: np.ndarray    # [B] int32: coarse list of each bucket


def build_layout(assign_h: np.ndarray, valid_h: np.ndarray, nlist: int,
                 cap_hint: Optional[int] = None) -> BucketLayout:
    """Group live slots by coarse assignment into fixed-width spill
    buckets. assign_h: [capacity] int32 (-1 unassigned); valid_h: [capacity]
    bool."""
    live = np.flatnonzero(valid_h)
    assign = assign_h[live]
    keep = assign >= 0
    live, assign = live[keep], assign[keep]

    counts = np.bincount(assign, minlength=nlist).astype(np.int64)
    mean = max(1, int(np.ceil(len(live) / max(1, nlist))))
    cap_list = cap_hint or min(MAX_CAP, max(MIN_CAP, _next_pow2(mean)))

    nb = np.maximum(1, -(-counts // cap_list))
    max_spill = int(nb.max()) if len(nb) else 1
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(nb, out=offsets[1:])
    nbuckets = int(offsets[-1])

    order = np.argsort(assign, kind="stable")
    live_s, assign_s = live[order], assign[order]
    starts = np.zeros(nlist, np.int64)
    np.cumsum(counts, out=starts)
    starts = np.concatenate([[0], starts[:-1]])
    pos = np.arange(len(live_s), dtype=np.int64) - starts[assign_s]
    bucket_id = offsets[assign_s] + pos // cap_list
    row = pos % cap_list

    bucket_slot = np.full((nbuckets, cap_list), -1, np.int32)
    bucket_slot[bucket_id, row] = live_s

    probe = offsets[:nlist, None] + np.arange(max_spill)[None, :]
    probe = np.where(
        np.arange(max_spill)[None, :] < nb[:, None], probe, -1
    ).astype(np.int32)
    coarse = np.repeat(np.arange(nlist, dtype=np.int32), nb)
    return BucketLayout(cap_list=cap_list, max_spill=max_spill,
                        nbuckets=nbuckets, bucket_slot_h=bucket_slot,
                        probe_table_h=probe, bucket_coarse_h=coarse)


def alloc_buckets(n: int) -> int:
    """Physical bucket allocation for n logical buckets: the smallest
    {1, 1.25, 1.5, 1.75} x pow2 value >= n (bounds padding at 25%)."""
    n = max(1, int(n))
    if n <= 8:
        return _next_pow2(n)
    p = _next_pow2(n)
    for num in (5, 6, 7):
        cand = (p // 8) * num
        if cand >= n:
            return cand
    return p


def shape_bucket(n: int) -> int:
    """Round a request shape (topk, nprobe) up to the {1, 1.5} x pow2
    ladder (..., 8, 12, 16, 24, 32, 48, 64, ...)."""
    n = int(n)
    if n <= 4:
        return max(1, n)
    p = _next_pow2(n)
    mid = 3 * (p // 4)
    return mid if mid >= n else p


class MutableIvfView:
    """Incrementally maintained bucketed IVF view: slot -> (bucket, row)
    positions, per-bucket fill cursors, per-list bucket chains. Upserts
    append into free rows of a list's tail bucket (a fresh spill bucket
    when the chain is full), deletes flip the row invalid; a deferred
    compaction restores the dense layout.

    This class owns the index-agnostic device arrays (bucket_slot,
    bucket_valid, probe_table, bucket_coarse); the owning index owns the
    data arrays grouped by the same coordinates. stage_*() is host-only;
    apply_device() and the index's data scatters run under the store's
    device_lock. Invariant: a row is live iff bucket_slot[b, r] >= 0."""

    def __init__(self, lay: BucketLayout, nlist: int, slot_capacity: int,
                 device: torch.device):
        self.device = torch.device(device)
        self.cap_list = lay.cap_list
        self.nlist = nlist
        self.nbuckets = lay.nbuckets
        self.alloc = alloc_buckets(lay.nbuckets)
        self.max_spill = lay.max_spill

        cap = self.cap_list
        self.bucket_slot_h = np.full((self.alloc, cap), -1, np.int32)
        self.bucket_slot_h[: lay.nbuckets] = lay.bucket_slot_h
        self.bucket_coarse_h = np.full((self.alloc,), -1, np.int32)
        self.bucket_coarse_h[: lay.nbuckets] = lay.bucket_coarse_h
        self.bucket_fill = (self.bucket_slot_h >= 0).sum(axis=1).astype(
            np.int32
        )
        self.probe_table_h = lay.probe_table_h.copy()
        self.list_nb = (self.probe_table_h >= 0).sum(axis=1).astype(np.int32)

        self.slot_pos = np.full((slot_capacity,), -1, np.int32)
        flat = self.bucket_slot_h.reshape(-1)
        live = np.flatnonzero(flat >= 0)
        self.slot_pos[flat[live]] = live

        self.version = 0
        self.tombstones = 0
        self.inplace_appends = 0
        self.buckets_added = 0
        self.base_buckets = lay.nbuckets
        self.base_rows = int(len(live))
        self.live_rows = int(len(live))

        self.bucket_slot = self._up(self.bucket_slot_h)
        self.bucket_valid = self._up(self.bucket_slot_h >= 0)
        self.probe_table = self._up(self.probe_table_h)
        self.bucket_coarse = self._up(
            np.where(self.bucket_coarse_h >= 0, self.bucket_coarse_h, 0)
        )

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    @classmethod
    def build(cls, assign_h: np.ndarray, valid_h: np.ndarray, nlist: int,
              slot_capacity: int, device,
              cap_hint: Optional[int] = None) -> "MutableIvfView":
        lay = build_layout(assign_h, valid_h, nlist, cap_hint)
        return cls(lay, nlist, slot_capacity, device)

    # -- derived -----------------------------------------------------------
    def gather_rows(self, source: torch.Tensor) -> torch.Tensor:
        """[alloc, cap_list, *source.shape[1:]] rows grouped by bucket."""
        flat = self.bucket_slot_h.reshape(-1)
        idx = upload(np.where(flat >= 0, flat, 0).astype(np.int64),
                     source.device)
        out = source[idx]
        return out.reshape((self.alloc, self.cap_list)
                           + tuple(source.shape[1:]))

    def tombstone_ratio(self) -> float:
        return self.tombstones / max(1, self.live_rows + self.tombstones)

    def spill_ratio(self) -> float:
        return self.buckets_added / max(1, self.base_buckets)

    def stats(self) -> dict:
        return {
            "nbuckets": self.nbuckets,
            "alloc_buckets": self.alloc,
            "cap_list": self.cap_list,
            "live_rows": self.live_rows,
            "tombstones": self.tombstones,
            "tombstone_ratio": self.tombstone_ratio(),
            "inplace_appends": self.inplace_appends,
            "buckets_added": self.buckets_added,
            "spill_ratio": self.spill_ratio(),
            "version": self.version,
        }

    # -- staging (host bookkeeping; no device work) ------------------------
    def ensure_slot_capacity(self, capacity: int) -> None:
        if capacity > len(self.slot_pos):
            grown = np.full((capacity,), -1, np.int32)
            grown[: len(self.slot_pos)] = self.slot_pos
            self.slot_pos = grown

    def _alloc_bucket(self, coarse: int) -> int:
        """Allocate a fresh spill bucket for `coarse`; returns its id."""
        if self.nbuckets == self.alloc:
            new_alloc = alloc_buckets(self.nbuckets + 1)
            grown = np.full((new_alloc, self.cap_list), -1, np.int32)
            grown[: self.alloc] = self.bucket_slot_h
            self.bucket_slot_h = grown
            gc = np.full((new_alloc,), -1, np.int32)
            gc[: self.alloc] = self.bucket_coarse_h
            self.bucket_coarse_h = gc
            gf = np.zeros((new_alloc,), np.int32)
            gf[: self.alloc] = self.bucket_fill
            self.bucket_fill = gf
            self.alloc = new_alloc
        s = int(self.list_nb[coarse])
        if s == self.max_spill:
            new_spill = max(self.max_spill + 1,
                            self.max_spill + self.max_spill // 2)
            grown = np.full((self.nlist, new_spill), -1, np.int32)
            grown[:, : self.max_spill] = self.probe_table_h
            self.probe_table_h = grown
            self.max_spill = new_spill
        b = self.nbuckets
        self.nbuckets += 1
        self.buckets_added += 1
        self.bucket_coarse_h[b] = coarse
        self.probe_table_h[coarse, s] = b
        self.list_nb[coarse] = s + 1
        return b

    def stage_delete(self, slots: np.ndarray) -> Optional["_ViewUpdate"]:
        """Tombstone the given slots' rows (host arrays updated here)."""
        upd = _ViewUpdate(self.alloc, self.nbuckets)
        for s in np.asarray(slots, np.int64):
            self._tombstone(int(s), upd)
        return self._finish(upd)

    def stage_upsert(self, slots: np.ndarray, assigns: np.ndarray
                     ) -> Optional["_ViewUpdate"]:
        """Place upserted slots: tombstone any previous position, append
        into the assigned list's tail bucket. None = no-op batch."""
        slots = np.asarray(slots, np.int64)
        upd = _ViewUpdate(self.alloc, self.nbuckets)
        placed: dict = {}
        for i, (s, lst) in enumerate(zip(slots, np.asarray(assigns))):
            s, lst = int(s), int(lst)
            self._tombstone(s, upd)
            if lst < 0:
                continue
            tail = int(self.probe_table_h[lst, self.list_nb[lst] - 1]) \
                if self.list_nb[lst] else -1
            if tail < 0 or self.bucket_fill[tail] >= self.cap_list:
                tail = self._alloc_bucket(lst)
            r = int(self.bucket_fill[tail])
            self.bucket_fill[tail] = r + 1
            self.bucket_slot_h[tail, r] = s
            self.slot_pos[s] = tail * self.cap_list + r
            self.live_rows += 1
            self.inplace_appends += 1
            placed[s] = i
            upd.touched.append(tail * self.cap_list + r)
        upd.appended = [(int(self.slot_pos[s]), i) for s, i in placed.items()]
        return self._finish(upd)

    def _tombstone(self, slot: int, upd: "_ViewUpdate") -> None:
        if slot < 0 or slot >= len(self.slot_pos):
            return
        pos = int(self.slot_pos[slot])
        if pos < 0:
            return
        self.slot_pos[slot] = -1
        self.bucket_slot_h[pos // self.cap_list, pos % self.cap_list] = -1
        self.tombstones += 1
        self.live_rows -= 1
        upd.touched.append(pos)

    def _finish(self, upd: "_ViewUpdate") -> Optional["_ViewUpdate"]:
        if not upd.touched and upd.nbuckets_before == self.nbuckets:
            return None
        self.version += 1
        pos = np.unique(np.asarray(upd.touched, np.int64))
        upd.b_idx = (pos // self.cap_list).astype(np.int32)
        upd.r_idx = (pos % self.cap_list).astype(np.int32)
        upd.slot_vals = self.bucket_slot_h[upd.b_idx, upd.r_idx]
        upd.grew_alloc = self.alloc if upd.alloc_before != self.alloc else None
        upd.new_probe = upd.nbuckets_before != self.nbuckets
        return upd

    # -- device apply (caller holds the store's device_lock) ---------------
    def apply_device(self, upd: "_ViewUpdate") -> None:
        from dingo_tpu_torch.ops.scatter import (
            pad_buckets,
            scatter_bucket_update,
        )

        if upd.grew_alloc is not None:
            self.bucket_slot = pad_buckets(self.bucket_slot, upd.grew_alloc,
                                           fill=-1)
            self.bucket_valid = pad_buckets(self.bucket_valid,
                                            upd.grew_alloc, fill=False)
        if len(upd.b_idx):
            scatter_bucket_update(self.bucket_slot, upd.b_idx, upd.r_idx,
                                  upd.slot_vals)
            scatter_bucket_update(self.bucket_valid, upd.b_idx, upd.r_idx,
                                  upd.slot_vals >= 0)
        if upd.new_probe:
            # probe table / coarse map are tiny: re-upload them whole
            self.probe_table = self._up(self.probe_table_h)
            self.bucket_coarse = self._up(
                np.where(self.bucket_coarse_h >= 0, self.bucket_coarse_h, 0)
            )


class _ViewUpdate:
    """Scatter batch staged by MutableIvfView."""

    __slots__ = ("alloc_before", "nbuckets_before", "touched", "appended",
                 "b_idx", "r_idx", "slot_vals", "grew_alloc", "new_probe")

    def __init__(self, alloc_before: int, nbuckets_before: int):
        self.alloc_before = alloc_before
        self.nbuckets_before = nbuckets_before
        self.touched: list = []
        self.appended: list = []
        self.b_idx = np.empty(0, np.int32)
        self.r_idx = np.empty(0, np.int32)
        self.slot_vals = np.empty(0, np.int32)
        self.grew_alloc: Optional[int] = None
        self.new_probe = False


def expand_probes(probes: torch.Tensor, probe_table: torch.Tensor,
                  nprobe: int, max_spill: int) -> torch.Tensor:
    """Coarse probes [b, nprobe] -> virtual bucket probes [b, budget]
    (int32). Valid buckets come first in rank order; past the budget the
    lowest-ranked lists' spill buckets drop."""
    virt, _ = expand_probes_ranked(probes, probe_table, nprobe, max_spill)
    return virt


def expand_probes_ranked(probes: torch.Tensor, probe_table: torch.Tensor,
                         nprobe: int, max_spill: int):
    """expand_probes plus each virtual probe's coarse-rank position."""
    b = probes.shape[0]
    virt = probe_table[probes.long()].reshape(b, nprobe * max_spill)
    if max_spill == 1:
        pos = torch.arange(nprobe, dtype=torch.int32,
                           device=probes.device)[None, :].expand(b, nprobe)
        return virt, pos
    width = nprobe * max_spill
    cols = torch.arange(width, dtype=torch.int32,
                        device=probes.device)[None, :]
    key = torch.where(virt >= 0, cols, torch.full_like(cols, width))
    order = torch.argsort(key, dim=1, stable=True)
    virt = torch.gather(virt, 1, order)
    budget = min(width, nprobe + max(8, nprobe // 2) + max_spill - 1)
    pos = (order // max_spill).to(torch.int32)
    return virt[:, :budget].contiguous(), pos[:, :budget]
