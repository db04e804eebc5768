"""Worker pools: task execution sets with dispatch policies (port of
dingo_tpu/common/runnable.py).

Reference: src/common/runnable.{h,cc} — TaskRunnable + Worker over bthread
execution queues; SimpleWorkerSet / PriorWorkerSet with round-robin,
least-queue, and hash-by-region dispatch (runnable.h:138-291); read/write/
apply worker sets sized by flags at boot (main.cc:1019-1046). The reference
uses M:N bthreads; here each worker is an OS thread consuming its own queue
(the device data plane batches its own work, so worker counts stay small).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional


class Worker:
    def __init__(self, name: str):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self.executed = 0
        self._thread.start()

    def execute(self, task: Callable[[], None]) -> None:
        self._q.put(task)

    def queue_size(self) -> int:
        return self._q.qsize()

    def _loop(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            try:
                task()
            except Exception:
                pass
            finally:
                self.executed += 1

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=2)


class WorkerSet:
    """SimpleWorkerSet with the three dispatch policies."""

    def __init__(self, name: str, workers: int = 4):
        self._workers: List[Worker] = [
            Worker(f"{name}-{i}") for i in range(workers)
        ]
        self._rr = 0
        self._lock = threading.Lock()

    def execute_rr(self, task: Callable[[], None]) -> None:
        with self._lock:
            w = self._workers[self._rr % len(self._workers)]
            self._rr += 1
        w.execute(task)

    def execute_least_queue(self, task: Callable[[], None]) -> None:
        """ExecuteLeastQueue (index_service.cc:362-365 read path)."""
        w = min(self._workers, key=lambda w: w.queue_size())
        w.execute(task)

    def execute_hash(self, key: int, task: Callable[[], None]) -> None:
        """Hash-by-region dispatch: per-region ordering preserved."""
        self._workers[hash(key) % len(self._workers)].execute(task)

    def total_executed(self) -> int:
        return sum(w.executed for w in self._workers)

    def stop(self) -> None:
        for w in self._workers:
            w.stop()
