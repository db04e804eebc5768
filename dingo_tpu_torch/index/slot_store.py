"""Device-resident slot store: the IndexIDMap2 equivalent (port of
``SlotStore``, ``SqSlotStore`` and ``HostSlotStore`` in
dingo_tpu/index/slot_store.py).

  host side   — ids_by_slot int64[capacity] (-1 = empty) + dict id->slot +
                free-slot list + validity bitmap. 64-bit external ids never
                go on the device; kernels work in slot space.
  device side — vecs[capacity, d] in the tier's dtype (f32, bf16, the
                f16 or int8 of IndexParameter.dtype, int8 +/-1 rows of
                the binary family, or uint8 codes in SqSlotStore)
                and sqnorm[capacity] f32, the norms of what the scans
                accumulate: the stored bf16 rows, the f32 decode of the
                codes, or nbits for +/-1 rows. Writes land in place, one slice
                assignment per contiguous slot run (fresh appends are one
                run, free slots are handed out ascending); the JAX package
                needed donated dynamic_update_slice programs for the same.
  blocked     — optional dimension-blocked mirror for the pruned FLAT scan
                (kernel B4; never for int8 rows, which stay off the
                kernels as in the JAX package): vecs_blk[nblk, capacity, dblk] in the store's
                dtype plus per-block norms bsq_blk[nblk, capacity] f32 (of
                the same values as sqnorm), written in the same slot runs.
  host        — HostSlotStore keeps the same bookkeeping with rows and
                norms in numpy (IVF_PQ with host_vectors; bf16 rows as
                their uint16 bit patterns). HostSqSlotStore and
                MmapSqSlotStore keep sq8 codes in host RAM or in an
                np.memmap file: the host rungs of the memory-tier ladder
                (index/tiering.py).

Capacity grows by doubling. Deletes are host tombstones; slots freed while
searches are in flight park in limbo until the last lease ends, so an async
resolve never translates a reassigned slot.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from dingo_tpu_torch.common.config import blocked_layout_enabled
from dingo_tpu_torch.common.device import upload
from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.ops.distance import to_row_dtype
from dingo_tpu_torch.ops.blocked import (
    block_sqnorms,
    resolve_dim_block,
    to_blocked,
)
from dingo_tpu_torch.ops.sq import (
    SqParams,
    sq_decode,
    sq_decode_device,
    sq_encode,
    sq_train,
)

MIN_CAPACITY = 4096


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


#: row dtypes of the float tiers (SqSlotStore holds uint8 codes): the
#: kernels' f32 and bf16 arms
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
#: row dtypes the scan kernels read: the float tiers and sq8 codes
KERNEL_DTYPES = FLOAT_DTYPES + (torch.uint8,)
#: row dtypes of SlotStore: the float tiers, the other storage dtypes of
#: IndexParameter.dtype (f16; int8 from floats, as XLA converts them:
#: ops/distance.to_row_dtype) and the binary family's +/-1 int8 rows
ROW_DTYPES = FLOAT_DTYPES + (torch.float16, torch.int8)


def host_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host in their canonical byte form: bf16 as
    its uint16 bit patterns (numpy has no bf16), any other dtype as is."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


class SlotStore:
    def __init__(self, dim: int, device: torch.device,
                 capacity: int = MIN_CAPACITY,
                 blocked: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        self.dim = dim
        self.device = torch.device(device)
        if dtype not in self._row_dtypes():
            raise ValueError(f"{type(self).__name__} does not store {dtype}")
        self.dtype = dtype
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
        # graph adjacency mirror of the device HNSW tier (index/hnsw.py):
        # [capacity, graph_deg] int32 slot-space neighbour lists, -1 padded,
        # read by the beam walk (ops/beam.py); installed by set_graph(),
        # grown with the capacity
        self.graph_deg = 0
        self.adj: Optional[torch.Tensor] = None
        #: bumped by put/remove/growth; keys caches of the slot<->id map
        #: (the HNSW filter-mask cache and adjacency mirror among them)
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

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host-to-device hook of the write path's row upload: a plain
        copy. The tier ladder's promotion shadows it with an instance
        attribute, a staging-ring uploader (common/pipeline.StagingRing),
        so that bulk code ingest overlaps each chunk's upload with the
        previous chunk's write (index/tiering.py). An uploader may return
        more rows than it was given (a ring pads to the pow2 ladder):
        callers slice."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

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
            self._dmask = upload(self.valid_h.copy(), self.device)
        return self._dmask

    def _row_dtypes(self):
        return ROW_DTYPES

    def _blocked_dtype_ok(self) -> bool:
        """Tiers whose scan kernel (B4) reads a blocked mirror: f32, bf16
        and sq8 codes (SqSlotStore); f16 and int8 rows (the binary
        family's among them) stay on the plain arm, as in the JAX
        package."""
        return self.dtype in KERNEL_DTYPES

    def memory_size(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        size = self.capacity * (self.dim * itemsize + 8 + 4 + 1)
        if self.vecs_blk is not None:
            # blocked scan mirror: one more copy of the rows + block norms
            size += self.capacity * (self.dim * itemsize + self.nblk * 4)
        if self.adj is not None:
            size += self.capacity * self.graph_deg * 4
        return size

    def set_graph(self, adj, deg: int) -> None:
        """Install the slot-space adjacency mirror: [capacity, deg] int32
        neighbour slots, -1 padded (a numpy array or a tensor). A full
        swap, not a scatter: one node insert can rewire arbitrary
        neighbours' lists."""
        if tuple(adj.shape) != (self.capacity, deg):
            raise ValueError(
                f"adjacency shape {tuple(adj.shape)} != "
                f"({self.capacity}, {deg})")
        if not isinstance(adj, torch.Tensor):
            adj = torch.from_numpy(np.ascontiguousarray(adj, np.int32))
        with self.device_lock:
            self.graph_deg = deg
            self.adj = adj.to(device=self.device, dtype=torch.int32)

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

    def _stored_rows(self, rows_h: np.ndarray):
        """(rows as the device stores them, the f32 values the scans
        accumulate) for a batch of prepped rows: f32 rows as they are,
        bf16 rows rounded (their norms are those of the rounded rows, the
        JAX package's stored-row convention); int8 +/-1 rows go up as they
        are, a quarter of the bytes; f32 rows of an int8 store saturate
        (ops/distance.to_row_dtype)."""
        n = len(rows_h)
        if self.dtype == torch.int8 and rows_h.dtype == np.int8:
            stored = self._upload(np.ascontiguousarray(rows_h))[:n]
            return stored, stored.to(torch.float32)
        rows = self._upload(np.ascontiguousarray(rows_h, np.float32))[:n]
        stored = to_row_dtype(rows, self.dtype)
        return stored, stored.to(torch.float32)

    def canonical_rows(self, rows: np.ndarray) -> np.ndarray:
        """The stored form of prepped rows as host bytes: what the device
        rows hold after a put() of `rows` (the integrity ledger digests
        these, so the incremental digest and a device read-back agree bit
        for bit). f32 and int8 +/-1 rows as they are; f16 and bf16 rows
        rounded, bf16 as its 16-bit patterns (numpy has no bf16: the same
        bytes as the JAX package's ml_dtypes rows); f32 rows of an int8
        store saturated as the device write saturates them (the JAX
        package's canonical rows wrap there, a plain numpy cast, and its
        scrub then flags its own device rows). SqSlotStore encodes."""
        if self.dtype == torch.int8 and rows.dtype == np.int8:
            return np.ascontiguousarray(rows)
        rows = np.ascontiguousarray(rows, np.float32)
        if self.dtype == torch.float32:
            return rows
        return host_bits(to_row_dtype(torch.from_numpy(rows), self.dtype))

    def _write_runs(self, runs, rows_h: np.ndarray) -> None:
        """Write rows sorted by slot; runs = [(lo, hi, first slot)] of
        contiguous slots, one slice assignment each."""
        DEVFAULT.maybe_fail("index.slot_store.write_run")
        rows, rows32 = self._stored_rows(rows_h)
        row_sq = (rows32 * rows32).sum(dim=1)
        with self.device_lock:
            if self.vecs_blk is not None:
                rows_blk = to_blocked(rows, self.dim_block)
                row_bsq = block_sqnorms(rows32, self.dim_block)
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
        vectors = np.asarray(vectors)
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
            if self.adj is not None:
                # slots are stable across growth: existing rows keep
                # their lists, new slots start with none
                self.adj = torch.cat(
                    [self.adj, self.adj.new_full((pad, self.graph_deg), -1)])
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
    def gather(self, ids: np.ndarray):
        """(found mask, f32 rows) by external id; absent ids read slot 0.
        Quantized stores return their decoded rows."""
        slots = self.slots_of(ids)
        found = slots >= 0
        rows = self.rows_device(np.where(found, slots, 0))
        return found, rows.cpu().numpy()

    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        """f32 rows at `slots` as a device tensor (train-path gather: only
        slot indices cross to the device, the rows never leave it)."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        with self.device_lock:
            return self.vecs[idx].to(torch.float32)

    def _live_rows(self):
        live = np.flatnonzero(self.ids_by_slot >= 0)
        idx = torch.as_tensor(live, device=self.device)
        with self.device_lock:
            return self.ids_by_slot[live], self.vecs[idx]

    def to_host(self) -> dict:
        """Compacted host snapshot {ids, vectors (f32)} of live rows (save
        path; bf16 rows widen exactly)."""
        ids, rows = self._live_rows()
        return {"ids": ids, "vectors": rows.to(torch.float32).cpu().numpy()}

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


class SqSlotStore(SlotStore):
    """SlotStore whose device rows are SQ8 codes (uint8, 1 byte a
    dimension; ops/sq.py codec).

    The contract stays float: put() takes f32 rows and encodes them,
    rows_device() and to_host() decode, so training and the exact paths
    above run unchanged. Only the scans read the codes (vecs, plus the
    codec on the device as sq_vmin_d / sq_scale_d). sqnorm and the blocked
    norms are those of the f32 decode. The codec trains on the first write
    batch unless maybe_train() or set_params() installed one first (an
    explicit train set, a snapshot)."""

    def __init__(self, dim: int, device: torch.device,
                 capacity: int = MIN_CAPACITY,
                 blocked: Optional[bool] = None):
        super().__init__(dim, device, capacity, blocked, dtype=torch.uint8)
        self.sq_params: Optional[SqParams] = None
        self._sq_vmin_d: Optional[torch.Tensor] = None
        self._sq_scale_d: Optional[torch.Tensor] = None
        #: (id of the f32 rows, row count, codes) of the latest put():
        #: canonical_rows of the same batch (the integrity ledger's, right
        #: after the put) reuses the codes instead of encoding again
        self._canonical_memo = None

    def _row_dtypes(self):
        return (torch.uint8,)

    # -- codec lifecycle ---------------------------------------------------
    def set_params(self, params: SqParams) -> None:
        if self.sq_params is not None and len(self):
            raise RuntimeError(
                "cannot swap SQ params under live codes (re-ingest instead)")
        self.sq_params = params
        self._sq_vmin_d = None
        self._sq_scale_d = None

    def maybe_train(self, rows: np.ndarray) -> None:
        """Install params trained on `rows` when none exist yet."""
        if self.sq_params is None and len(rows):
            self.set_params(sq_train(np.asarray(rows, np.float32)))

    @property
    def sq_vmin_d(self) -> torch.Tensor:
        if self._sq_vmin_d is None:
            self._sq_vmin_d = torch.from_numpy(
                self.sq_params.vmin.copy()).to(self.device)
        return self._sq_vmin_d

    @property
    def sq_scale_d(self) -> torch.Tensor:
        if self._sq_scale_d is None:
            self._sq_scale_d = torch.from_numpy(
                self.sq_params.scale.copy()).to(self.device)
        return self._sq_scale_d

    def codec_device(self):
        """(vmin, scale) on the device; an identity codec while the store
        is untrained (then it is empty: nothing valid to scan, and the
        first real write still trains it)."""
        if self.sq_params is None:
            vmin = torch.zeros((self.dim,), dtype=torch.float32,
                               device=self.device)
            return vmin, torch.ones_like(vmin)
        return self.sq_vmin_d, self.sq_scale_d

    def encode(self, rows: np.ndarray) -> np.ndarray:
        return sq_encode(rows, self.sq_params)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return sq_decode(codes, self.sq_params)

    # -- float-facing writes, code-facing storage -------------------------
    def put(self, ids: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        self.maybe_train(vectors)
        codes = self.encode(np.asarray(vectors, np.float32))
        self._canonical_memo = (id(vectors), len(codes), codes)
        return super().put(ids, codes)

    def canonical_rows(self, rows: np.ndarray) -> np.ndarray:
        """The stored form of prepped rows: their sq8 codes (the integrity
        ledger's 'rows' artifact of an sq8 store digests codes). The codes
        of the put() just made of the same array are reused (the memo is
        consumed; every put() refreshes it, so a recycled object id never
        pairs with stale codes)."""
        memo = self._canonical_memo
        if memo is not None and memo[0] == id(rows) and memo[1] == len(rows):
            self._canonical_memo = None
            return memo[2]
        return self.encode(np.asarray(rows, np.float32))

    def put_codes(self, ids: np.ndarray, codes: np.ndarray) -> np.ndarray:
        """Raw-code ingest (snapshot load): a saved code array goes back
        bit-exactly."""
        if self.sq_params is None:
            raise RuntimeError("set_params before put_codes")
        return super().put(ids, np.asarray(codes, np.uint8))

    def _stored_rows(self, rows_h: np.ndarray):
        # rows_h are codes here; the norms describe their f32 decode, made
        # on the device from the uploaded codes (f32 multiply, f32 add: the
        # host decode's values)
        codes = self._upload(np.ascontiguousarray(rows_h, np.uint8))
        codes = codes[:len(rows_h)]
        return codes, sq_decode_device(codes, self.sq_vmin_d,
                                       self.sq_scale_d, torch.float32)

    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        with self.device_lock:
            codes = self.vecs[idx]
            if self.sq_params is None:   # no writes yet: nothing to decode
                return codes.to(torch.float32)
            return sq_decode_device(codes, self.sq_vmin_d, self.sq_scale_d,
                                    torch.float32)

    def to_host(self) -> dict:
        """Decoded f32 snapshot of live rows; codes_to_host() is the
        compact persistence form."""
        ids, codes = self._live_rows()
        codes = codes.cpu().numpy()
        if self.sq_params is None:   # no write ever happened: empty
            return {"ids": ids, "vectors": codes.astype(np.float32)}
        return {"ids": ids, "vectors": self.decode(codes)}

    def codes_to_host(self) -> dict:
        """Compacted {ids, codes} of live rows (save path; 1 byte a
        dimension)."""
        ids, codes = self._live_rows()
        return {"ids": ids, "codes": codes.cpu().numpy()}


class HostSlotStore(SlotStore):
    """SlotStore whose rows and norms live in host memory (numpy), for an
    index whose search never reads full rows from the device (IVF_PQ with
    host_vectors: it scans codes and reranks from host rows at resolve).
    Bookkeeping is SlotStore's; `device` is where rows_device uploads.
    Rows in the store's dtype, bf16 rows as their uint16 bit patterns;
    never a blocked mirror."""

    def _blocked_dtype_ok(self) -> bool:
        return False

    def _np_dtype(self):
        if self.dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return torch.empty((), dtype=self.dtype).numpy().dtype

    def _alloc_storage(self, capacity: int):
        return (np.zeros((capacity, self.dim), self._np_dtype()),
                np.zeros((capacity,), np.float32))

    def _grow_storage(self, pad: int):
        return (np.concatenate([self.vecs, np.zeros((pad, self.dim),
                                                    self.vecs.dtype)]),
                np.concatenate([self.sqnorm, np.zeros((pad,), np.float32)]))

    def host_rows(self, idx) -> np.ndarray:
        """f32 rows at `idx` (a slice or slot indices); bf16 rows widen
        exactly from their bit patterns."""
        rows = self.vecs[idx]
        if rows.dtype == np.uint16:
            rows = (rows.astype(np.uint32) << 16).view(np.float32)
        return np.ascontiguousarray(rows, np.float32)

    def _write_runs(self, runs, rows_h: np.ndarray) -> None:
        stored, rows32 = self._stored_rows(rows_h)
        if self.dtype == torch.bfloat16:
            stored = stored.view(torch.int16).numpy().view(np.uint16)
        else:
            stored = stored.numpy()
        rows32 = rows32.numpy()
        sq = (rows32 * rows32).sum(axis=1)
        with self.device_lock:
            for lo, hi, s0 in runs:
                self.vecs[s0:s0 + hi - lo] = stored[lo:hi]
                self.sqnorm[s0:s0 + hi - lo] = sq[lo:hi]

    def _stored_rows(self, rows_h: np.ndarray):
        """bf16 rows rounded by torch; any other dtype cast by numpy, as
        the JAX package's host store casts (its int8 rows wrap where the
        device store's saturate)."""
        rows = np.ascontiguousarray(rows_h, np.float32)
        if self.dtype == torch.bfloat16:
            stored = torch.from_numpy(rows).to(torch.bfloat16)
        else:
            stored = torch.from_numpy(rows.astype(self._np_dtype()))
        return stored, stored.to(torch.float32)

    def canonical_rows(self, rows: np.ndarray) -> np.ndarray:
        """The rows as this store keeps them: numpy's cast (bf16 rows as
        SlotStore's)."""
        if self.dtype == torch.bfloat16:
            return super().canonical_rows(rows)
        return np.ascontiguousarray(rows, np.float32).astype(
            self._np_dtype())

    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        # the host gather is the upload
        return torch.from_numpy(
            self.host_rows(np.asarray(slots, np.int64))).to(self.device)

    def to_host(self) -> dict:
        live = np.flatnonzero(self.ids_by_slot >= 0)
        return {"ids": self.ids_by_slot[live],
                "vectors": self.host_rows(live)}

    def memory_size(self) -> int:
        # host bytes; the device holds only the owner's codes and centroids
        return int(self.vecs.nbytes + self.sqnorm.nbytes)


class HostSqSlotStore(SqSlotStore):
    """SqSlotStore whose uint8 codes and norms live in host RAM (numpy):
    the host_sq8 rung of the memory-tier ladder (index/tiering.py). A
    demoted region's codes leave the card, its serving arm becomes a paged
    exact scan on the host (tiering.HostSqFlat) and its device bytes drop
    to 0. The float-facing contract stays SqSlotStore's (put() encodes,
    gather() decodes) and canonical_rows() still returns the codes, so the
    integrity ledger's 'rows' artifact compares byte for byte across the
    hbm_sq8, host_sq8 and mmap_sq8 rungs. `device` is only where
    rows_device uploads."""

    #: rows decoded at a time for the norms of a write (bounds the f32
    #: temporary of a whole-region transcription)
    DECODE_CHUNK = 65536

    def _blocked_dtype_ok(self) -> bool:
        return False   # the codes live on the host: no device scan mirror

    def _alloc_storage(self, capacity: int):
        return (np.zeros((capacity, self.dim), np.uint8),
                np.zeros((capacity,), np.float32))

    def _grow_storage(self, pad: int):
        return (np.concatenate([np.asarray(self.vecs),
                                np.zeros((pad, self.dim), np.uint8)]),
                np.concatenate([self.sqnorm, np.zeros((pad,), np.float32)]))

    def _norms(self, codes: np.ndarray) -> np.ndarray:
        """Norms of the codes' f32 decode, as the JAX package's host store
        computes them (np.einsum), DECODE_CHUNK rows at a time on a thread
        each (numpy releases the GIL; a row's value does not depend on its
        chunk)."""
        out = np.empty(len(codes), np.float32)

        def one(lo):
            deq = self.decode(codes[lo:lo + self.DECODE_CHUNK])
            out[lo:lo + len(deq)] = np.einsum("ld,ld->l", deq, deq)

        starts = range(0, len(codes), self.DECODE_CHUNK)
        if len(starts) > 1:
            with ThreadPoolExecutor(min(len(starts),
                                        os.cpu_count() or 1)) as pool:
                list(pool.map(one, starts))
        elif len(codes):
            one(0)
        return out

    def _write_runs(self, runs, rows_h: np.ndarray) -> None:
        # rows_h are codes (put() encodes before the base put)
        codes = np.ascontiguousarray(rows_h, np.uint8)
        sq = self._norms(codes)
        with self.device_lock:
            for lo, hi, s0 in runs:
                self.vecs[s0:s0 + hi - lo] = codes[lo:hi]
                self.sqnorm[s0:s0 + hi - lo] = sq[lo:hi]

    def gather(self, ids: np.ndarray):
        slots = self.slots_of(ids)
        found = slots >= 0
        codes = np.asarray(self.vecs[np.where(found, slots, 0)], np.uint8)
        if self.sq_params is None:
            return found, codes.astype(np.float32)
        return found, self.decode(codes)

    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        # the host gather and decode are the upload
        codes = np.asarray(self.vecs[np.asarray(slots, np.int64)], np.uint8)
        rows = (codes.astype(np.float32) if self.sq_params is None
                else self.decode(codes))
        return torch.from_numpy(rows).to(self.device)

    def codes_to_host(self) -> dict:
        live = np.flatnonzero(self.ids_by_slot >= 0)
        return {"ids": self.ids_by_slot[live],
                "codes": np.asarray(self.vecs[live], np.uint8)}

    def to_host(self) -> dict:
        snap = self.codes_to_host()
        codes = snap.pop("codes")
        snap["vectors"] = (codes.astype(np.float32) if self.sq_params is None
                           else self.decode(codes))
        return snap

    def memory_size(self) -> int:
        # host bytes; this store holds nothing on the device
        return int(np.asarray(self.vecs).nbytes + self.sqnorm.nbytes)


class MmapSqSlotStore(HostSqSlotStore):
    """HostSqSlotStore whose code array is an np.memmap on disk: the
    mmap_sq8 rung, the bottom of the ladder. The paged scan faults codes
    in on demand, so a cold region's steady RAM is its bookkeeping and
    norms. The file is the raw [capacity, dim] uint8 code matrix, the host
    rung's bytes."""

    def __init__(self, dim: int, path: str, device: torch.device,
                 capacity: int = MIN_CAPACITY):
        # the storage hooks run inside super().__init__: path first
        self._mmap_path = path
        super().__init__(dim, device, capacity, blocked=False)

    def _alloc_storage(self, capacity: int):
        os.makedirs(os.path.dirname(self._mmap_path) or ".", exist_ok=True)
        return (np.memmap(self._mmap_path, dtype=np.uint8, mode="w+",
                          shape=(capacity, self.dim)),
                np.zeros((capacity,), np.float32))

    def _grow_storage(self, pad: int):
        new_cap = self.capacity + pad
        self.vecs.flush()
        with open(self._mmap_path, "r+b") as f:
            f.truncate(new_cap * self.dim)
        return (np.memmap(self._mmap_path, dtype=np.uint8, mode="r+",
                          shape=(new_cap, self.dim)),
                np.concatenate([self.sqnorm, np.zeros((pad,), np.float32)]))

    @property
    def path(self) -> str:
        return self._mmap_path

    def disk_bytes(self) -> int:
        return int(self.capacity) * int(self.dim)

    def memory_size(self) -> int:
        # the codes are on disk; the RAM cost is the norm cache
        return int(self.sqnorm.nbytes)

    def close(self, unlink: bool = True) -> None:
        """Release the mapping (promotion, retirement): flush, drop the
        map, optionally unlink the file. A straggling reader then meets a
        zero-row array and fails loudly instead of touching an unmapped
        page."""
        with self.device_lock:
            try:
                self.vecs.flush()
            except (AttributeError, ValueError, OSError):
                pass
            self.vecs = np.zeros((0, self.dim), np.uint8)
        if unlink:
            try:
                os.unlink(self._mmap_path)
            except OSError:
                pass


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
