"""Failpoint: runtime fault injection (port of dingo_tpu/common/failpoint.py).

Reference: src/common/failpoint.{h,cc} — named failpoints configured at
runtime (via DebugService) with actions panic/sleep/print/yield/delay
(failpoint.h:44-141), compiled in behind ENABLE_FAILPOINT. Here failpoints
are always available (no compile gate) and applied with `apply("name")` at
the instrumented site.

Config string format (reference-compatible spirit):
    "<percent>%<count>*<action>(<arg>)"
e.g. "100%10*sleep(50)" = always fire, first 10 times, sleep 50ms;
     "50%error(30001)"  = half the passes raise errcode 30001;
     "3*panic"          = panic the first 3 times, then off.

Actions:
    panic        — raise FailPointError
    error(code)  — raise FailPointInjectedError carrying an errcode (the
                   rpc layer converts it in-band like any application
                   error, so clients exercise their retry classification)
    sleep/delay(ms) — stall the instrumented site
    print(msg)   — log the pass
    yield        — yield the GIL (scheduling perturbation)

Determinism: the probabilistic roll uses one process-global seeded rng;
``FAILPOINTS.set_seed(s)`` re-arms it so a chaos scenario replays the
exact same fault schedule. ``scoped()`` installs a point for the dynamic
extent of a with-block (tests can't leak configured faults).

Every pass that FIRES bumps the curated ``fault.injected`` counter
(labels={"point": name}) so chaos gates can assert the fault actually
happened rather than trusting the schedule.
"""

from __future__ import annotations

import contextlib
import random
import re
import threading
import time
from typing import Dict, Optional


class FailPointError(RuntimeError):
    """Raised by the `panic` action."""


class FailPointInjectedError(FailPointError):
    """Raised by the `error(code)` action; carries an in-band errcode so
    the rpc layer and client retry classification see a typed failure."""

    def __init__(self, name: str, errcode: int):
        super().__init__(f"failpoint {name} injected error {errcode}")
        self.point = name
        self.errcode = errcode


class _FailPoint:
    def __init__(self, name: str, percent: int, count: int, action: str,
                 arg: str):
        self.name = name
        self.percent = percent
        self.count = count          # -1 = unlimited
        self.action = action
        self.arg = arg
        self.hits = 0


_CFG_RE = re.compile(
    r"^(?:(?P<pct>\d+)%)?(?:(?P<cnt>\d+)\*)?(?P<act>\w+)(?:\((?P<arg>[^)]*)\))?$"
)

_ACTIONS = ("panic", "error", "sleep", "delay", "print", "yield")


class FailPointManager:
    def __init__(self, seed: int = 0xFA11):
        self._lock = threading.Lock()
        self._points: Dict[str, _FailPoint] = {}
        self._rng = random.Random(seed)

    def set_seed(self, seed: int) -> None:
        """Re-arm the probabilistic roll for a deterministic replay."""
        with self._lock:
            self._rng = random.Random(seed)

    def configure(self, name: str, config: str) -> None:
        """e.g. configure("before_raft_commit", "50%3*sleep(100)")."""
        m = _CFG_RE.match(config.strip())
        if not m:
            raise ValueError(f"bad failpoint config {config!r}")
        if m.group("act") not in _ACTIONS:
            raise ValueError(
                f"unknown failpoint action {m.group('act')!r} "
                f"(want one of {_ACTIONS})"
            )
        point = _FailPoint(
            name,
            int(m.group("pct") or 100),
            int(m.group("cnt") or -1),
            m.group("act"),
            m.group("arg") or "",
        )
        with self._lock:
            self._points[name] = point

    def remove(self, name: str) -> None:
        with self._lock:
            self._points.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._points.clear()

    def list(self) -> Dict[str, str]:
        with self._lock:
            return {
                n: f"{p.percent}%{p.count}*{p.action}({p.arg})"
                for n, p in self._points.items()
            }

    def hits(self, name: str) -> int:
        """Times the point FIRED (post-roll) — chaos gates assert on it."""
        with self._lock:
            p = self._points.get(name)
            return p.hits if p is not None else 0

    @contextlib.contextmanager
    def scoped(self, name: str, config: str):
        """Install a point for the extent of a with-block, restoring any
        previous config on exit (tests / chaos scenarios can't leak)."""
        with self._lock:
            prev = self._points.get(name)
        self.configure(name, config)
        try:
            yield self
        finally:
            with self._lock:
                if prev is not None:
                    self._points[name] = prev
                else:
                    self._points.pop(name, None)

    def apply(self, name: str) -> None:
        """Call at the instrumented site; may sleep/raise per config."""
        with self._lock:
            point = self._points.get(name)
            if point is None:
                return
            if point.count == 0:
                return
            if self._rng.random() * 100 >= point.percent:
                return
            if point.count > 0:
                point.count -= 1
            point.hits += 1
            action, arg = point.action, point.arg
        # lazy import: failpoint is reachable from early-import modules
        # (engine/storage) and must not force the metrics registry up
        from dingo_tpu_torch.common.metrics import METRICS

        METRICS.counter("fault.injected", labels={"point": name}).add(1)
        if action == "panic":
            raise FailPointError(f"failpoint {name} panic")
        if action == "error":
            raise FailPointInjectedError(name, int(arg or 99999))
        if action == "sleep" or action == "delay":
            time.sleep(float(arg or 0) / 1000.0)
        elif action == "print":
            print(f"[failpoint] {name}: {arg}")
        elif action == "yield":
            time.sleep(0)


#: process-global manager (the reference's singleton)
FAILPOINTS = FailPointManager()


def failpoint(name: str) -> None:
    FAILPOINTS.apply(name)


def failpoint_scope(name: str, config: str):
    """Module-level sugar for ``FAILPOINTS.scoped`` (test idiom)."""
    return FAILPOINTS.scoped(name, config)
