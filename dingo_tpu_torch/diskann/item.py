"""DiskAnnItemManager: the per-index registry and its build worker (port of
dingo_tpu/diskann/item.py).

Reference: DiskANNItem's per-index state machine (diskann_item.h:43) and
the DiskANNItemManager singleton (diskann_item_manager.h:50) with their
build worker set. One background thread drains the build queue: builds
are device-heavy, and running them one at a time matches the reference's
bounded build worker set.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Optional

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.diskann.core import CoreState, DiskAnnCore, DiskAnnError
from dingo_tpu_torch.index.base import IndexParameter


class DiskAnnItemManager:
    """Cores under ``root_dir/<index id>`` on ``device`` (None = the CUDA
    device; raises without one)."""

    def __init__(self, root_dir: str, device=None):
        self.root = root_dir
        self.device = resolve_device(device)
        os.makedirs(root_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._items: Dict[int, DiskAnnCore] = {}
        self._build_q: "queue.Queue[Optional[int]]" = queue.Queue()
        self._worker = threading.Thread(
            target=self._build_loop, name="diskann-build", daemon=True
        )
        self._worker.start()

    # -- registry ------------------------------------------------------------
    def create(self, index_id: int, parameter: IndexParameter) -> DiskAnnCore:
        with self._lock:
            if index_id in self._items:
                raise DiskAnnError(f"index {index_id} exists")
            core = DiskAnnCore(index_id, parameter,
                               os.path.join(self.root, str(index_id)),
                               device=self.device)
            self._items[index_id] = core
            return core

    def get(self, index_id: int) -> Optional[DiskAnnCore]:
        with self._lock:
            return self._items.get(index_id)

    def destroy(self, index_id: int) -> None:
        with self._lock:
            core = self._items.pop(index_id, None)
        if core is not None:
            core.destroy()

    def all_items(self):
        with self._lock:
            return dict(self._items)

    # -- asynchronous build ---------------------------------------------------
    def submit_build(self, index_id: int) -> None:
        core = self.get(index_id)
        if core is None:
            raise DiskAnnError(f"index {index_id} not found")
        if core.status() not in (CoreState.IMPORTED, CoreState.BUILT):
            raise DiskAnnError(f"build in state {core.status().value}")
        self._build_q.put(index_id)

    def _build_loop(self) -> None:
        while True:
            index_id = self._build_q.get()
            if index_id is None:
                return
            core = self.get(index_id)
            if core is None:
                continue
            try:
                core.build()
            except Exception:  # noqa: BLE001 — the worker keeps running
                pass  # the core's state and last_error report the failure

    def stop(self) -> None:
        self._build_q.put(None)
        self._worker.join(timeout=5)
