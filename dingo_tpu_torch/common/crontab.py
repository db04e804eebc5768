"""CrontabManager: periodic background jobs (port of
dingo_tpu/common/crontab.py).

Reference: src/crontab/crontab.{h,cc} (CrontabManager on bthread_timer_add,
crontab.h:62); the full production schedule registers in server.cc:506-700
(heartbeat, metrics collection, scan GC, split/merge checkers, coordinator
update/job/recycle/lease/compaction tasks, vector-index scrub).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from dingo_tpu_torch.common.log import get_logger

_log = get_logger("crontab")


class Crontab:
    def __init__(self, name: str, interval_s: float,
                 func: Callable[[], None], immediately: bool = False):
        self.name = name
        self.interval_s = interval_s
        self.func = func
        self.immediately = immediately
        self.run_count = 0
        self.error_count = 0
        self.last_run_ms = 0
        self.last_error = ""
        self._next_due = 0.0


class CrontabManager:
    def __init__(self, tick_s: float = 0.05):
        self._tick = tick_s
        self._lock = threading.Lock()
        self._crontabs: Dict[str, Crontab] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, name: str, interval_s: float, func: Callable[[], None],
            immediately: bool = False) -> None:
        with self._lock:
            tab = Crontab(name, interval_s, func, immediately)
            now = time.monotonic()
            tab._next_due = now if immediately else now + interval_s
            self._crontabs[name] = tab

    def remove(self, name: str) -> None:
        with self._lock:
            self._crontabs.pop(name, None)

    def set_interval(self, name: str, interval_s: float) -> bool:
        """Hot-change a crontab's period (takes effect when the tab next
        comes due — crontab bodies that advertise a hot-changeable
        interval flag re-apply it here per tick). False if unknown."""
        with self._lock:
            tab = self._crontabs.get(name)
            if tab is None:
                return False
            if tab.interval_s != interval_s:
                tab.interval_s = interval_s
                tab._next_due = min(
                    tab._next_due, time.monotonic() + interval_s
                )
            return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="crontab")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def run_pending(self) -> int:
        """Manual pump (tests / single-threaded drivers).

        Failure isolation contract: one crontab's exception must neither
        stop the remaining due crontabs this tick nor unschedule the
        failing one — a buggy metrics collector silently killing the
        heartbeat crontab would partition the store. Errors are counted,
        logged, and mirrored into the metrics registry."""
        now = time.monotonic()
        due: List[Crontab] = []
        with self._lock:
            for tab in self._crontabs.values():
                if now >= tab._next_due:
                    tab._next_due = now + tab.interval_s
                    due.append(tab)
        for tab in due:
            try:
                tab.func()
                tab.run_count += 1
            except Exception as e:  # noqa: BLE001
                tab.error_count += 1
                tab.last_error = f"{type(e).__name__}: {e}"
                _log.exception("crontab %r failed (run %d, error %d)",
                               tab.name, tab.run_count, tab.error_count)
                try:
                    from dingo_tpu_torch.common.metrics import METRICS

                    METRICS.counter(
                        "crontab.errors", labels={"name": tab.name}
                    ).add(1)
                except Exception:  # noqa: BLE001 — never amplify
                    pass
            tab.last_run_ms = int(time.time() * 1000)
        return len(due)

    def _loop(self) -> None:
        while not self._stop.wait(self._tick):
            try:
                self.run_pending()
            except Exception:  # noqa: BLE001
                # run_pending already isolates per-tab errors; this guards
                # the scheduler itself (e.g. an exotic failure inside the
                # due-computation) — the thread must outlive any bug
                _log.exception("crontab scheduler tick failed")

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "interval_s": t.interval_s,
                    "runs": t.run_count,
                    "errors": t.error_count,
                    "last_error": t.last_error,
                }
                for name, t in self._crontabs.items()
            }
