"""Device-memory accounting per region, and the allocation-failure
classification (port of dingo_tpu/obs/hbm.py).

``HbmLedger`` attributes a region's live device bytes to named owners
(slot_store, ivf_view, rerank_cache, pq, centroids, other) over a shared
dedup set (a tensor storage reachable from two owners is charged to the
first), keeps the high-watermark per (region, owner) and per region
total, and publishes everything as ``hbm.*`` gauges. ``poll_process()``
refreshes the process-level allocator view (``torch.cuda.memory_stats``:
``hbm.bytes_in_use`` etc.) on the ``hbm_watermark_interval_s`` crontab.
The bytes are those of ``index/base.py::tensor_bytes``, the port's
counterpart of the JAX package's ``live_device_bytes``.

``on_alloc_failure()`` is the allocation-failure hook: a device OOM bumps
``hbm.alloc_failures`` and captures a flight-recorder bundle with the
ledger attached.

The JAX package matches the text of an XlaRuntimeError
(RESOURCE_EXHAUSTED). On the card an allocation failure has a type of its
own, ``torch.cuda.OutOfMemoryError`` (``torch.OutOfMemoryError``), and the
chaos shim raises ``InjectedDeviceFault`` (ops/devfault.py); those two
and nothing else walk the recovery ladder, so no error whose message
happens to say "out of memory" is mistaken for one.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import torch

from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.ops.devfault import InjectedDeviceFault

# NOTE: dingo_tpu_torch.metrics.* is imported lazily inside methods —
# metrics/collector.py imports this module, so a module-level import here
# would be a cycle.

__all__ = ["HBM", "HbmLedger", "looks_like_oom"]


def _oom_types():
    t = getattr(torch, "OutOfMemoryError", None)
    if t is None:
        t = getattr(torch.cuda, "OutOfMemoryError", None)
    return (InjectedDeviceFault,) + ((t,) if t is not None else ())


_OOM_TYPES = _oom_types()


def looks_like_oom(exc: BaseException) -> bool:
    """True for a device allocation failure: a torch out-of-memory error
    or an injected device fault."""
    return isinstance(exc, _OOM_TYPES)


def _owned_roots(index):
    """(owner, root) pairs for the ledger walk, most-specific first so the
    shared dedup set charges each buffer to its real owner. Accepts a
    VectorIndexWrapper (unwraps own_index; a share/sibling view serves
    from the PARENT's arrays and must not double-book) or a bare index."""
    if hasattr(index, "own_index"):
        if index.own_index is None:
            return None          # share/sibling or not built: nothing owned
        index = index.own_index
    return [
        ("ivf_view", getattr(index, "_view", None)),
        ("rerank_cache", getattr(index, "_rerank_cache", None)),
        ("pq", [getattr(index, "codebooks", None),
                getattr(index, "_codes", None)]),
        ("centroids", [getattr(index, "centroids", None),
                       getattr(index, "_c_sqnorm", None)]),
        ("slot_store", getattr(index, "store", None)),
        ("other", index),
    ]


class HbmLedger:
    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        #: region -> owner -> current bytes
        self._cur: Dict[int, Dict[str, int]] = {}
        #: region -> owner -> high-watermark bytes
        self._peak: Dict[int, Dict[str, int]] = {}
        #: region -> high-watermark of the region TOTAL (not the sum of
        #: owner peaks — owners peak at different times)
        self._region_peak: Dict[int, int] = {}
        self._proc_peak = 0
        self.alloc_failures = 0

    # ---- accounting --------------------------------------------------------
    def account_index(self, region_id: int, index) -> Dict[str, int]:
        """Measure one region's index and fold it into the ledger.
        Never raises (runs inside the metrics collector pass)."""
        try:
            from dingo_tpu_torch.metrics.device import live_device_bytes_by_owner

            roots = _owned_roots(index)
            owners = (
                live_device_bytes_by_owner(roots) if roots is not None
                else {}
            )
        except Exception:  # noqa: BLE001 — index mid-build/swap
            return {}
        self.update_region(region_id, owners)
        return owners

    def update_region(self, region_id: int,
                      owners: Dict[str, int]) -> None:
        owners = {k: int(v) for k, v in owners.items() if v}
        total = sum(owners.values())
        g = self.registry.gauge
        with self._lock:
            prev = self._cur.get(region_id, {})
            peaks = self._peak.setdefault(region_id, {})
            for owner in set(prev) - set(owners):
                # owner vanished (view rebuilt, cache dropped): zero its
                # gauge so scrapes don't report freed HBM forever
                g("hbm.region.bytes", region_id,
                  labels={"owner": owner}).set(0)
            for owner, nbytes in owners.items():
                peaks[owner] = max(peaks.get(owner, 0), nbytes)
                g("hbm.region.bytes", region_id,
                  labels={"owner": owner}).set(nbytes)
                g("hbm.region.peak_bytes", region_id,
                  labels={"owner": owner}).set(peaks[owner])
            self._cur[region_id] = owners
            self._region_peak[region_id] = max(
                self._region_peak.get(region_id, 0), total
            )
            # region totals live under DISTINCT names: sharing the
            # owner-labeled name would double-count every label-agnostic
            # aggregation (sum(hbm_region_bytes) = 2x real usage)
            g("hbm.region.total_bytes", region_id).set(total)
            g("hbm.region.total_peak_bytes", region_id).set(
                self._region_peak[region_id]
            )

    def region_peak(self, region_id: int) -> int:
        with self._lock:
            return self._region_peak.get(region_id, 0)

    def forget_region(self, region_id: int) -> None:
        """Deleted/moved region: drop ledger rows (the metrics collector
        drops the region-labeled gauge series alongside)."""
        with self._lock:
            self._cur.pop(region_id, None)
            self._peak.pop(region_id, None)
            self._region_peak.pop(region_id, None)

    # ---- process-level view ------------------------------------------------
    def poll_process(self) -> Dict[str, int]:
        """Refresh process allocator gauges (the hbm.watermark_interval_s
        crontab body; also runs with every metrics collection pass)."""
        from dingo_tpu_torch.metrics.device import device_memory_stats

        stats = device_memory_stats()
        g = self.registry.gauge
        g("hbm.bytes_in_use").set(stats["bytes_in_use"])
        g("hbm.bytes_limit").set(stats["bytes_limit"])
        with self._lock:
            self._proc_peak = max(self._proc_peak,
                                  stats["peak_bytes_in_use"],
                                  stats["bytes_in_use"])
            g("hbm.peak_bytes").set(self._proc_peak)
        return stats

    # ---- allocation-failure hook -------------------------------------------
    def on_alloc_failure(self, exc: BaseException,
                         context: str = "",
                         region_id: int = 0,
                         capture: bool = True) -> Optional[str]:
        """Record a device allocation failure; returns the flight bundle
        id when one was captured. Call with ANY exception from a device
        call site — non-OOM shapes are ignored, so callers don't need to
        classify. Pass capture=False from sites that ALSO hand the error
        to FLIGHT.on_rpc_error: that bundle carries the victim's trace
        id, and a trace-less one captured here first would win the
        per-reason rate limit instead."""
        if not looks_like_oom(exc):
            return None
        self.alloc_failures += 1
        self.registry.counter("hbm.alloc_failures").add(1)
        if not capture:
            return None
        try:
            from dingo_tpu_torch.obs.flight import FLIGHT

            return FLIGHT.trigger(
                "device_oom",
                name=context or type(exc).__name__,
                region_id=region_id,
                extra={"error": f"{type(exc).__name__}: {exc}"[:2000]},
            )
        except Exception:  # noqa: BLE001 — observability must not re-raise
            return None

    # ---- flight-recorder snapshot ------------------------------------------
    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "regions": {
                    rid: {
                        "bytes": dict(self._cur.get(rid, {})),
                        "peak_bytes": dict(self._peak.get(rid, {})),
                        "total_peak_bytes": self._region_peak.get(rid, 0),
                    }
                    for rid in sorted(
                        set(self._cur) | set(self._region_peak)
                    )
                },
                "process_peak_bytes": self._proc_peak,
                "alloc_failures": self.alloc_failures,
                "sampled_at": time.time(),
            }


HBM = HbmLedger()
