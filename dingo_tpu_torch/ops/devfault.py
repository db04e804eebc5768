"""Device-fault shim: a synthetic device out-of-memory at dispatch (port of
dingo_tpu/ops/devfault.py).

A real allocation failure on the card surfaces as
``torch.cuda.OutOfMemoryError`` and is classified by
``obs/hbm.looks_like_oom``; it is hard to produce on demand, and the CPU
has none. This shim raises an equivalent failure where a device program is
dispatched, so the whole recovery ladder (drop caches, evict mirrors,
retry, degrade to the host path; index/recovery.py) runs with real
exceptions on the real code path, deterministically.

The dispatch points: every kernel wrapper reports its launch to
``SENTINEL.launch`` (obs/sentinel.py), which calls ``maybe_fail`` first,
and the torch-op arms that stand for the JAX package's sentineled XLA
programs (the FLAT/IVF/IVF_PQ plain arms, the slot-store writes, the
scatters, the reranks, the beam walk and the graph build) call it
themselves. Each point's name contains the JAX package's sentinel name
(``ops.pallas.pruned_fused_topk``, ``ops.beam.search``, ...), so an
``arm(n, kernel_substr=...)`` written for one package targets the same
program in the other.

Disarmed cost: one attribute read per dispatch. Arm with
``DEVFAULT.arm(n)`` to fail the next n dispatches, or
``DEVFAULT.arm(n, kernel_substr="flat")`` to fail only matching ones.
"""

from __future__ import annotations

import threading
from typing import Optional


class InjectedDeviceFault(RuntimeError):
    """Synthetic device allocation failure; ``looks_like_oom`` classifies
    it as it classifies ``torch.cuda.OutOfMemoryError``."""


class DeviceFaultShim:
    def __init__(self):
        self._lock = threading.Lock()
        self._armed = 0
        self._kernel_substr: Optional[str] = None
        self.fired = 0

    def arm(self, n: int = 1, kernel_substr: Optional[str] = None) -> None:
        """Fail the next `n` dispatches (optionally only those whose name
        contains `kernel_substr`)."""
        with self._lock:
            self._armed = int(n)
            self._kernel_substr = kernel_substr

    def disarm(self) -> None:
        with self._lock:
            self._armed = 0
            self._kernel_substr = None

    def armed(self) -> int:
        return self._armed

    def maybe_fail(self, kernel: str) -> None:
        """Called at a dispatch point before the device work is issued."""
        if not self._armed:           # disarmed fast path: no lock
            return
        with self._lock:
            if not self._armed:
                return
            if self._kernel_substr is not None \
                    and self._kernel_substr not in kernel:
                return
            self._armed -= 1
            self.fired += 1
        from dingo_tpu_torch.common.metrics import METRICS

        METRICS.counter("fault.injected",
                        labels={"point": "device_dispatch"}).add(1)
        raise InjectedDeviceFault(
            f"injected device fault at {kernel} (CUDA out of memory while "
            "trying to allocate: synthetic)"
        )


#: process-global shim (one device, one set of dispatch points)
DEVFAULT = DeviceFaultShim()
