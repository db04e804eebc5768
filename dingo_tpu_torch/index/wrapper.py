"""VectorIndexWrapper: lifecycle state machine around a VectorIndex (port of
dingo_tpu/index/wrapper.py).

Tracks ready/stop/build-error flags, apply_log_id & snapshot_log_id, and
the own/share/sibling index pointers used during region split and merge.
The raft apply handlers talk to the wrapper, never to the index: the
engine is the source of truth and the index an apply-log-tracked view, so
a write applies only when its log id advances. A device OOM during a write
walks the recovery ladder (index/recovery.py); a device-degraded region's
writes stay in the engine until re-materialization.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    SearchResult,
    VectorIndex,
    VectorIndexError,
)
from dingo_tpu_torch.index.factory import new_index
from dingo_tpu_torch.index.recovery import RECOVERY, DeviceDegraded
from dingo_tpu_torch.obs.integrity import INTEGRITY
from dingo_tpu_torch.ops.distance import metric_ascending


def _merge_results(a: SearchResult, b: SearchResult, topk: int, metric):
    """The post-merge sibling merge: both answers in score order, each id
    once. The target's own index still holds the absorbed range's rows
    from before the split, so an id can come from both indexes; the JAX
    package keeps both copies (its top-k then repeats ids), the port keeps
    the better-scored one (stable: the target's on a tie)."""
    ids = np.concatenate([a.ids, b.ids])
    d = np.concatenate([a.distances, b.distances])
    order = np.argsort(d if metric_ascending(metric) else -d, kind="stable")
    ids, d = ids[order], d[order]
    _, first = np.unique(ids, return_index=True)
    keep = np.zeros(len(ids), bool)
    keep[first] = True
    keep |= ids < 0
    return SearchResult(ids[keep][:topk], d[keep][:topk])


class _Pin:
    """One search's hold on the index it picked, from the pick to its
    resolve: a retire (index/tiering.py) waits for the pins on an index it
    swapped out before it frees that index's device tensors. release() is
    idempotent; __del__ backstops a thunk that is never resolved."""

    __slots__ = ("_owner", "_key", "_done")

    def __init__(self, owner: "VectorIndexWrapper", key: int):
        self._owner = owner
        self._key = key
        self._done = False

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._owner._unpin(self._key)

    def __del__(self):  # noqa: D105
        self.release()


class VectorIndexWrapper:
    def __init__(self, index_id: int, parameter: IndexParameter,
                 save_write_threshold: int = 10000, device=None):
        self.id = index_id
        self.parameter = parameter
        self.device = device
        self._lock = threading.RLock()
        self.own_index: Optional[VectorIndex] = None
        #: parent's index served by a split child until its own rebuild
        self.share_index: Optional["VectorIndexWrapper"] = None
        #: pre-merge sibling's index
        self.sibling_index: Optional["VectorIndexWrapper"] = None
        self.ready = False
        self.stopped = False
        self.build_error = False
        #: set while the manager installs a rebuilt or loaded index (the
        #: final catch-up round and the switch, under the wrapper lock)
        self.is_switching = False
        self.apply_log_id = 0
        self.snapshot_log_id = 0
        self.write_count = 0
        self.save_write_threshold = save_write_threshold
        #: id(index) -> searches between their pick and their resolve
        self._pins: Dict[int, int] = {}
        self._unpinned = threading.Condition(self._lock)

    # -- index lifecycle -----------------------------------------------------
    def build_own(self) -> VectorIndex:
        with self._lock:
            self.own_index = new_index(self.id, self.parameter,
                                       device=self.device)
            return self.own_index

    def set_own(self, index: VectorIndex) -> None:
        """Atomic switch after rebuild/catch-up."""
        with self._lock:
            self.own_index = index
            self.apply_log_id = index.apply_log_id
            self.ready = True
            self.build_error = False

    def set_share(self, share: Optional["VectorIndexWrapper"]) -> None:
        with self._lock:
            self.share_index = share

    def set_sibling(self, sibling: Optional["VectorIndexWrapper"]) -> None:
        with self._lock:
            self.sibling_index = sibling

    def active(self) -> Optional[VectorIndex]:
        """Own index if ready, else the shared parent's."""
        with self._lock:
            if self.ready and self.own_index is not None:
                return self.own_index
            if self.share_index is not None:
                return self.share_index.active()
            return None

    def _pin(self) -> Tuple[Optional[VectorIndex], Optional[_Pin]]:
        """active(), with a pin on the index counted by the wrapper that
        owns it (a split child's pick pins the parent's index)."""
        with self._lock:
            if self.ready and self.own_index is not None:
                idx = self.own_index
                key = id(idx)
                self._pins[key] = self._pins.get(key, 0) + 1
                return idx, _Pin(self, key)
            if self.share_index is not None:
                return self.share_index._pin()
            return None, None

    def _unpin(self, key: int) -> None:
        with self._lock:
            n = self._pins[key] - 1
            if n:
                self._pins[key] = n
            else:
                del self._pins[key]
                self._unpinned.notify_all()

    def wait_unpinned(self, index: VectorIndex, timeout: float) -> bool:
        """Wait until no search holds `index` (one swapped out: no new
        search can pick it). False on timeout."""
        with self._lock:
            return self._unpinned.wait_for(
                lambda: id(index) not in self._pins, timeout)

    def is_ready(self) -> bool:
        with self._lock:
            return (self.ready and not self.stopped) or (
                self.share_index is not None and self.share_index.is_ready()
            )

    def stop(self) -> None:
        with self._lock:
            self.stopped = True

    # -- writes (apply-log contract) -----------------------------------------
    def _write_target(self, log_id: int) -> Optional[VectorIndex]:
        """Index a write at `log_id` applies to, or None when it must be
        skipped (no index, stopped, or the log id was already applied)."""
        idx = self.own_index if self.ready else None
        if idx is None:
            # split child before rebuild: writes land in the shared parent
            idx = self.active()
        if idx is None or self.stopped:
            return None
        if log_id != 0 and log_id <= self.apply_log_id:
            return None   # already materialized (snapshot load or replay)
        return idx

    def _advance(self, idx: VectorIndex, ids: np.ndarray,
                 log_id: int) -> None:
        # post-merge: purge absorbed-range versions from the sibling so the
        # search-time sibling merge cannot resurrect stale vectors
        sib = self.sibling_index.active() if self.sibling_index else None
        if sib is not None and sib is not idx:
            sib.delete(ids)
        if log_id:
            self.apply_log_id = log_id
            if idx is self.own_index:
                idx.apply_log_id = log_id
                # stamp the integrity ledger with the applied index this
                # write advanced to, still inside the lock and the pending
                # bracket: a heartbeat reads a consistent (digest, applied
                # index) pair, so replicas compare at equal indices
                INTEGRITY.tag_applied(idx, log_id)
        self.write_count += len(ids)

    def _apply(self, idx: VectorIndex, ids: np.ndarray, log_id: int,
               mutate: Callable[[], None]) -> None:
        """Run a write's index mutation through the device recovery ladder
        (index/recovery.py) and advance the apply cursor. A degraded
        region's write stays in the engine only: the device index awaits
        re-materialization and apply_log_id does not advance (replicas are
        compared at equal applied indices, and this index's state is that
        of the last advanced log id)."""
        if RECOVERY.is_degraded(self.id):
            return

        def op():
            # the pending-write bracket spans the index mutation and its
            # applied-index tag: between the ledger fold and the tag the
            # pair is torn, and the ledger withholds its digest vector
            # while the bracket is open (obs/integrity.py heartbeat_view)
            own = idx is self.own_index
            if own:
                INTEGRITY.note_mutation_begin(idx)
            try:
                mutate()
                self._advance(idx, ids, log_id)
            finally:
                if own:
                    INTEGRITY.note_mutation_end(idx)

        try:
            # mutations are upserts/deletes, idempotent: the ladder's retry
            # re-applies the whole block safely
            RECOVERY.attempt(self, self.id, op, kind="write")
        except DeviceDegraded:
            return

    def add(self, ids: np.ndarray, vectors: np.ndarray, log_id: int,
            is_upsert: bool = True) -> None:
        """Apply a raft-committed VECTOR_ADD iff log_id advances."""
        with self._lock:
            idx = self._write_target(log_id)
            if idx is None:
                return
            mutate = idx.upsert if is_upsert else idx.add
            self._apply(idx, ids, log_id, lambda: mutate(ids, vectors))

    def delete(self, ids: np.ndarray, log_id: int) -> None:
        with self._lock:
            idx = self._write_target(log_id)
            if idx is None:
                return
            self._apply(idx, ids, log_id, lambda: idx.delete(ids))

    # -- reads ---------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int,
               filter_spec: Optional[FilterSpec] = None,
               **kw) -> List[SearchResult]:
        idx, pin = self._pin()
        if idx is None:
            raise VectorIndexError(f"vector index {self.id} not ready")
        try:
            results = idx.search(queries, topk, filter_spec, **kw)
        finally:
            pin.release()
        sibling = self.sibling_index
        sib, spin = sibling._pin() if sibling is not None else (None, None)
        if sib is not None:
            try:
                other = sib.search(queries, topk, filter_spec, **kw)
            finally:
                spin.release()
            results = [
                _merge_results(a, b, topk, self.parameter.metric)
                for a, b in zip(results, other)
            ]
        return results

    def search_async(self, queries: np.ndarray, topk: int,
                     filter_spec: Optional[FilterSpec] = None,
                     staged=None,
                     **kw) -> Callable[[], List[SearchResult]]:
        """Dispatch now, resolve later; the sibling-merge window takes a
        thunk around the serial path (the merge needs both on the host).
        ``staged`` (common/pipeline.StagedBatch) passes the serving
        pipeline's upload on to the index."""
        idx, pin = self._pin()
        if idx is None:
            raise VectorIndexError(f"vector index {self.id} not ready")
        sibling = self.sibling_index
        if sibling is not None and sibling.active() is not None:
            pin.release()    # the serial path pins at its own pick
            return lambda: self.search(queries, topk, filter_spec, **kw)
        dispatch = getattr(idx, "search_async", None)
        try:
            thunk = (dispatch(queries, topk, filter_spec, staged=staged, **kw)
                     if dispatch is not None else
                     lambda: idx.search(queries, topk, filter_spec, **kw))
        except BaseException:
            pin.release()
            raise

        def resolve() -> List[SearchResult]:
            try:
                return thunk()
            finally:
                pin.release()

        return resolve

    # -- policies --------------------------------------------------------------
    def need_to_save(self) -> bool:
        idx = self.own_index
        if idx is None:
            return False
        log_behind = self.apply_log_id - self.snapshot_log_id
        return self.write_count >= self.save_write_threshold or \
            idx.need_to_save(log_behind)

    def need_to_rebuild(self) -> bool:
        idx = self.own_index
        return idx is not None and idx.need_to_rebuild()

    def get_count(self) -> int:
        idx = self.active()
        return idx.get_count() if idx else 0

    def get_memory_size(self) -> int:
        idx = self.own_index
        return idx.get_memory_size() if idx else 0

    def get_device_memory_size(self) -> int:
        """Device bytes of the OWN index (a shared parent's tensors are
        accounted on the parent's region, not double-counted here)."""
        idx = self.own_index
        return idx.get_device_memory_size() if idx else 0
