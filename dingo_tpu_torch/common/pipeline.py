"""Overlapped serving pipeline primitives (port of
dingo_tpu/common/pipeline.py).

Three small pieces the coalescer composes into an overlapped hot path:

- ``StagingRing``: per-key reusable query staging. ``stage()`` pads the
  stacked host batch into a ring slot on the pow2 ladder of
  ``index/flat._pad_batch`` (zeroed tail rows) and starts the slot's
  upload, so batch N+1's transfer overlaps batch N's kernels. On CUDA a
  slot is a pinned host tensor filled through its numpy view and uploaded
  with ``.to(device, non_blocking=True)`` on the current stream; a CUDA
  event recorded after the copy guards the slot. At most ``depth`` staged
  batches are outstanding per key: ``stage()`` blocks while the ring is
  full (backpressure toward admission).

- ``CompletionLane``: one drainer thread that runs every resolve of the
  pipelined path, so the flush thread dispatches the next due batch and
  never waits on a device-to-host fetch. Handoffs resolve in FIFO
  (dispatch) order. The lane thread only waits on the CUDA events of the
  replies' fetches (``ops/topk.HostFetch``); it launches nothing.

- the handoff protocol: anything with ``resolve()`` and ``abandon()`` can
  ride the lane. ``abandon()`` is the stop(drain=False) contract: fail the
  futures, but still run the fetch so device-side leases are released.

Slot reuse: a slot is handed out again only after its
``StagedBatch.release()``, which the lane calls after the reply's fetch,
or the coalescer calls at once when the dispatch raised. In the second
case the non-blocking copy out of the slot may still be in flight, so
``stage()`` waits on the slot's last copy event before it writes into the
slot (a no-op wait in the first case: the copy preceded the fetch).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.common.log import get_logger

_log = get_logger("pipeline")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class StagedBatch:
    """One staged query batch: the host array it was built from and its
    padded upload. Index families take it through ``search_async``'s
    ``staged=`` and claim the upload with ``take()``: the identity check
    makes a stale claim impossible, because a ``_prep_queries`` that
    rebinds the array (a dtype cast, COSINE's normalization) gets None and
    the family pads and uploads itself."""

    __slots__ = ("src", "qpad", "rows", "_ring", "_slot", "_released")

    def __init__(self, src: np.ndarray, qpad: torch.Tensor, rows: int,
                 ring: "StagingRing", slot: int):
        self.src = src
        self.qpad = qpad
        self.rows = rows
        self._ring = ring
        self._slot = slot
        self._released = False

    def take(self, queries) -> Optional[torch.Tensor]:
        """The staged upload iff ``queries`` is the exact array this batch
        was staged from (``np.asarray`` of a float32 array with a float32
        dtype returns the same object)."""
        if queries is self.src:
            return self.qpad
        return None

    def release(self) -> None:
        """Return the slot to the ring. Idempotent."""
        if self._released:
            return
        self._released = True
        self.qpad = None
        ring, self._ring = self._ring, None
        if ring is not None:
            ring._return_slot(self._slot)


class StagingRing:
    """Per-coalescer-key ring of ``depth`` reusable host staging slots.

    Slots are pow2-ladder shaped ([_next_pow2(b), *tail]) and zero-padded
    on every ``stage``, so the padded rows are byte-identical to the
    serial path's zero pad. A slot whose cached buffer does not fit the
    requested (shape, dtype) is reallocated in place; the ladder keeps
    that rare at steady state. ``device`` None means CUDA (raises
    DeviceUnavailable without one); the tests pass "cpu", where a slot is
    a plain host tensor and its "upload" a copy."""

    def __init__(self, depth: int = 2, device=None):
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        self._cuda = self.device.type == "cuda"
        self._free = threading.Semaphore(self.depth)
        self._lock = threading.Lock()
        self._slots: List[Optional[torch.Tensor]] = [None] * self.depth
        #: per slot: the event recorded after its last upload (CUDA)
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.depth
        self._avail: deque = deque(range(self.depth))
        self._closed = False

    def stage(self, stacked: np.ndarray) -> StagedBatch:
        """Pad ``stacked`` into a ring slot and start its upload. Blocks
        while all ``depth`` slots are in flight."""
        self._free.acquire()
        with self._lock:
            if self._closed:
                self._free.release()
                raise RuntimeError("staging ring closed")
            slot = self._avail.popleft()
            buf = self._slots[slot]
        try:
            return self._fill(stacked, slot, buf)
        except BaseException:
            self._return_slot(slot)
            raise

    def _fill(self, stacked: np.ndarray, slot: int,
              buf: Optional[torch.Tensor]) -> StagedBatch:
        b = stacked.shape[0]
        bb = _next_pow2(max(1, b))
        shape = (bb,) + tuple(stacked.shape[1:])
        dtype = torch.from_numpy(np.empty(0, stacked.dtype)).dtype
        ev = self._events[slot]
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            # a new buffer: the caching host allocator keeps the old one
            # until any copy out of it has completed
            buf = torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
            with self._lock:
                self._slots[slot] = buf
        elif ev is not None and not ev.query():
            # the slot's last upload may still be reading it
            ev.synchronize()
        host = buf.numpy()
        np.copyto(host[:b], stacked)
        if bb != b:
            host[b:] = 0
        if self._cuda:
            qpad = buf.to(self.device, non_blocking=True)
            if ev is None:
                ev = self._events[slot] = torch.cuda.Event()
            ev.record()
        else:
            qpad = buf.clone()
        return StagedBatch(stacked, qpad, b, self, slot)

    def _return_slot(self, slot: int) -> None:
        with self._lock:
            self._avail.append(slot)
        self._free.release()

    def close(self) -> None:
        with self._lock:
            self._closed = True


class CompletionLane:
    """Single-thread FIFO drain for pipelined resolves: the only place the
    pipelined path waits on the device, so the flush thread stays free to
    dispatch the next due batch."""

    def __init__(self, name: str = "dingo-completion-lane"):
        self._name = name
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._active = False  # a handoff is mid-resolve on the lane

    def submit(self, handoff) -> bool:
        """Enqueue a handoff. False once the lane is stopped: the caller
        then resolves (or abandons) it inline."""
        with self._cv:
            if self._stopped:
                return False
            self._queue.append(handoff)
            if self._thread is None:
                # each handoff carries its run span and re-attaches it on
                # the lane thread
                self._thread = threading.Thread(
                    target=self._loop, name=self._name, daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
        return True

    def depth(self) -> int:
        with self._cv:
            return len(self._queue) + (1 if self._active else 0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait(timeout=0.5)
                if not self._queue:
                    if self._stopped:
                        return
                    continue
                handoff = self._queue.popleft()
                self._active = True
            try:
                handoff.resolve()
            except Exception:  # noqa: BLE001 — the lane must keep draining
                # a handoff settles its own futures; a raise here is a
                # fault of resolve() itself
                _log.exception("completion lane: resolve raised")
            finally:
                with self._cv:
                    self._active = False
                    self._cv.notify_all()

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the lane. drain=True resolves everything queued first;
        drain=False abandons queued handoffs (futures fail fast, device
        leases still released)."""
        with self._cv:
            self._stopped = True
            abandoned: Tuple = ()
            if not drain:
                abandoned = tuple(self._queue)
                self._queue.clear()
            self._cv.notify_all()
        for handoff in abandoned:
            try:
                handoff.abandon()
            except Exception:  # noqa: BLE001 — abandon every handoff
                _log.exception("completion lane: abandon raised")
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)


class KeyedStaging:
    """Coalescer keys to their StagingRing, made lazily (a key's first
    pipelined flush creates its ring)."""

    def __init__(self, depth: int = 2, device=None):
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._rings: Dict[Any, StagingRing] = {}

    def ring(self, key) -> StagingRing:
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = StagingRing(self.depth,
                                                      self.device)
            return ring

    def close(self) -> None:
        with self._lock:
            rings = list(self._rings.values())
            self._rings.clear()
        for ring in rings:
            ring.close()
