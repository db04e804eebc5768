"""Workload-heat plane: WHERE traffic lands, not just how much of it
(port of dingo_tpu/obs/heat.py).

The metrics plane knows each region's QPS; nothing in the system knows
which IVF buckets, graph neighborhoods, or slot ranges that traffic
actually touches — the signal the memory-tier ladder (tiering,
device-aware split) need before they can demote a cold region or split a
hot one on evidence instead of guesses. This module is that sensor:

- **Access sketches.** Per region, an exponential-decay sketch over
  *heat units* — IVF bucket ids on the IVF paths, fixed slot blocks
  (``SLOT_BLOCK`` rows) on FLAT/HNSW. Every unit carries a decayed touch
  mass with e-folding time ``heat.decay_s``: a unit untouched for one
  decay constant keeps 1/e of its mass. Entries are bounded at
  ``heat.max_entries`` per region; past it the coldest are evicted.
- **Zero new device syncs.** The sketches are fed ENTIRELY from arrays
  the resolve paths already hold on host: IVF appends its probed-bucket
  ids to the batch's EXISTING ``begin_host_fetch`` group (one D2H copy
  either way: the one-sync-per-reply contract stays intact), FLAT and
  HNSW reuse the result-slot array they already fetched. The serving
  thread only appends to a bounded queue; folding, decay, eviction, and
  all derived math run on a dedicated worker (the quality-plane async
  lane). ``heat.enabled`` off = one flag read and an early return,
  nothing allocated (the sampling-off discipline).
- **Working-set estimator.** Sorting units by decayed mass and walking
  the cumulative traffic curve yields bytes-to-serve-{50,90,99}%-of-
  traffic, priced per precision tier (fp32/bf16/sq8 bytes per row) from
  a layout provider each index registers (rows per unit + its own
  tier). That curve IS the tiering decision input: a region whose p99
  working set is a sliver of its resident bytes is a demote candidate.
- **Shape.** ``heat.*`` curated family (bucket_gini, hot_fraction,
  working_set_bytes{pct,tier}, touches, entries, dropped); region
  rollups ride heartbeats (RegionMetricsSnapshot.heat_*) to the
  coordinator's capacity plane (coordinator/capacity.py) and surface in
  ``cluster top`` (HEAT/WSET), ``cluster capacity``, and flight bundles.

Sketch math: masses are stored in a *time-warped* basis — a touch at
time t adds ``exp((t - t0)/tau)`` where t0 is the region's reference
time — so a fold is O(touched units) with no rescan, and the true
decayed mass is recovered at read time by one multiply. When the warp
factor grows past ``_REBASE_WARP`` the sketch rebases (one O(n) sweep)
to keep the floats in range.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS

_log = get_logger("obs.heat")

#: FLAT/HNSW heat-unit granule: one unit = this many consecutive slots.
#: Coarse enough that a region's sketch stays small (1M rows -> 512
#: units), fine enough that a hot shard of the slot space stands out.
SLOT_BLOCK = 2048

#: pending touch batches; overflow drops (and counts) — the async lane
#: must never apply backpressure to the serving path
QUEUE_MAX = 256

#: percentiles of the traffic curve the working-set estimator prices
WS_PCTS = (50, 90, 99)

#: bytes per coordinate, per precision tier (the working-set price list)
TIER_BYTES = {"fp32": 4.0, "bf16": 2.0, "sq8": 1.0}

#: rebase the time-warped masses when the warp factor exceeds e^16
#: (~53 decay constants of uptime between O(n) sweeps at default tau)
_REBASE_WARP = 16.0

#: derived stats (gini/hot-fraction/working set) are recomputed and
#: published at most this often per region — folds are much hotter
_PUBLISH_MIN_S = 1.0

#: layout providers are polled at most this often (rows-per-bucket via
#: bincount over the host assignment array is cheap, but not per-fold)
_LAYOUT_TTL_S = 10.0


def heat_enabled() -> bool:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return bool(FLAGS.get("heat_enabled"))
    except KeyError:     # registry not populated (unit contexts)
        return False


def _decay_s() -> float:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return max(1.0, float(FLAGS.get("heat_decay_s")))
    except KeyError:
        return 300.0


def _max_entries() -> int:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return max(16, int(FLAGS.get("heat_max_entries")))
    except KeyError:
        return 4096


# ---------------------------------------------------------------------------
# pure sketch math (unit-testable)
# ---------------------------------------------------------------------------

def gini(masses: np.ndarray) -> float:
    """Gini coefficient of the mass distribution in [0, 1): 0 = every
    unit equally hot, ->1 = all traffic on one unit. The single-number
    skew signal `cluster top` and the split advisory read."""
    x = np.sort(np.asarray(masses, np.float64))
    n = x.size
    total = float(x.sum())
    if n <= 1 or total <= 0.0:
        return 0.0
    idx = np.arange(1, n + 1, dtype=np.float64)
    return float((2.0 * idx - n - 1.0) @ x) / (n * total)


def hot_fraction(masses: np.ndarray, top: float = 0.1) -> float:
    """Traffic mass carried by the hottest ``top`` fraction of units
    (>=1 unit). Uniform traffic reads ~``top``; a Zipf hotspot reads
    near 1.0 — the separation test_heat.py pins down."""
    x = np.sort(np.asarray(masses, np.float64))[::-1]
    total = float(x.sum())
    if x.size == 0 or total <= 0.0:
        return 0.0
    k = max(1, int(math.ceil(top * x.size)))
    return float(x[:k].sum()) / total


def working_set_rows(masses: np.ndarray, rows: np.ndarray,
                     pcts: Tuple[int, ...] = WS_PCTS) -> Dict[int, int]:
    """Rows needed to serve each pct of traffic: walk units hottest
    first, accumulate traffic mass, stop when the cumulative share
    reaches pct/100. The byte figure is rows x the tier's row price."""
    m = np.asarray(masses, np.float64)
    r = np.asarray(rows, np.float64)
    total = float(m.sum())
    if m.size == 0 or total <= 0.0:
        return {p: 0 for p in pcts}
    order = np.argsort(m)[::-1]
    cum_mass = np.cumsum(m[order]) / total
    cum_rows = np.cumsum(r[order])
    out: Dict[int, int] = {}
    for p in pcts:
        i = int(np.searchsorted(cum_mass, p / 100.0))
        i = min(i, m.size - 1)
        out[p] = int(cum_rows[i])
    return out


# ---------------------------------------------------------------------------
# per-region sketch
# ---------------------------------------------------------------------------

class _RegionHeat:
    """One region's decayed-touch sketch + cached layout + derived
    stats. All mutation happens on the plane's worker thread; reads
    (region_stats, unit view) take the plane lock for the brief copy."""

    __slots__ = ("mass", "t0", "touches", "layouts", "layout_cache",
                 "layout_ts", "last_publish", "stats")

    def __init__(self, now: float):
        #: (kind, unit_id) -> time-warped touch mass
        self.mass: Dict[Tuple[str, int], float] = {}
        #: reference time of the warp basis (exp((t - t0)/tau))
        self.t0 = now
        self.touches = 0
        #: kind -> layout provider ( -> dict(unit_rows, row_bytes, tier,
        #: dim)); refreshed from the worker at most every _LAYOUT_TTL_S
        self.layouts: Dict[str, Callable[[], Optional[dict]]] = {}
        self.layout_cache: Dict[str, dict] = {}
        self.layout_ts = 0.0
        self.last_publish = 0.0
        #: last derived stats (the heartbeat read)
        self.stats: Dict[str, Any] = {}

    # -- decay basis --------------------------------------------------------
    def warp(self, now: float, tau: float) -> float:
        return math.exp((now - self.t0) / tau)

    def rebase(self, now: float, tau: float) -> None:
        """Renormalize the warped masses to reference time ``now`` (the
        O(n) sweep that keeps exp() in float range over long uptimes)."""
        scale = math.exp((self.t0 - now) / tau)
        for k in self.mass:
            self.mass[k] *= scale
        self.t0 = now

    def fold(self, kind: str, units: np.ndarray, weight: float,
             now: float, tau: float, cap: int) -> int:
        """Add one touch batch. Returns the number of raw touches."""
        if (now - self.t0) / tau > _REBASE_WARP:
            self.rebase(now, tau)
        w = weight * self.warp(now, tau)
        uniq, counts = np.unique(units, return_counts=True)
        m = self.mass
        for u, c in zip(uniq.tolist(), counts.tolist()):
            key = (kind, int(u))
            m[key] = m.get(key, 0.0) + w * c
        n = int(counts.sum())
        self.touches += n
        if len(m) > cap:
            self.evict(cap)
        return n

    def evict(self, cap: int) -> None:
        """Drop the coldest entries down to ``cap`` (their mass is the
        least informative; the working-set tail they represent is the
        part already safe to leave cold)."""
        items = sorted(self.mass.items(), key=lambda kv: kv[1],
                       reverse=True)
        self.mass = dict(items[:cap])

    # -- layout -------------------------------------------------------------
    def refresh_layouts(self, now: float) -> None:
        if now - self.layout_ts < _LAYOUT_TTL_S and self.layout_cache:
            return
        self.layout_ts = now
        for kind, fn in list(self.layouts.items()):
            try:
                lay = fn()
            except Exception:  # noqa: BLE001 — providers ride on live
                _log.exception("heat layout provider failed")  # indexes
                lay = None
            if lay is not None:
                self.layout_cache[kind] = lay

    def rows_of(self, kind: str, unit: int) -> float:
        lay = self.layout_cache.get(kind)
        if lay is None:
            return float(SLOT_BLOCK)
        unit_rows = lay.get("unit_rows")
        if unit_rows is None:
            return float(lay.get("rows_per_unit", SLOT_BLOCK))
        if 0 <= unit < len(unit_rows):
            return float(unit_rows[unit])
        return 0.0

    # -- derived ------------------------------------------------------------
    def derive(self, now: float, tau: float) -> Dict[str, Any]:
        """Recompute gini / hot fraction / working set from the live
        sketch (worker thread; the O(n log n) sort is over <= cap
        entries). Bytes are priced at the region's OWN tier; the
        per-tier what-if curve is published as labeled gauges."""
        self.refresh_layouts(now)
        keys = list(self.mass.keys())
        masses = np.fromiter(self.mass.values(), np.float64, len(keys))
        rows = np.fromiter(
            (self.rows_of(k[0], k[1]) for k in keys), np.float64,
            len(keys))
        ws_rows = working_set_rows(masses, rows)
        # the region's own tier prices the headline bytes figure
        dim = 0.0
        own_row_bytes = 0.0
        tier = "fp32"
        for lay in self.layout_cache.values():
            dim = max(dim, float(lay.get("dim", 0)))
            own_row_bytes = max(own_row_bytes,
                                float(lay.get("row_bytes", 0.0)))
            tier = lay.get("tier", tier)
        if own_row_bytes <= 0.0:
            own_row_bytes = dim * TIER_BYTES.get(tier, 4.0)
        st: Dict[str, Any] = {
            "gini": gini(masses),
            "hot_fraction": hot_fraction(masses),
            "entries": len(keys),
            "touches": self.touches,
            "tier": tier,
            "ws_rows": ws_rows,
            "ws_bytes": {p: int(r * own_row_bytes)
                         for p, r in ws_rows.items()},
            # what-if: the same traffic served from each precision tier
            "ws_bytes_tier": {
                t: {p: int(r * dim * tb) for p, r in ws_rows.items()}
                for t, tb in TIER_BYTES.items()
            } if dim > 0 else {},
        }
        self.stats = st
        return st


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

class HeatPlane:
    """Process-global heat sketch aggregator (``HEAT``).

    Serving-thread surface: ``observe`` (bounded enqueue, overflow drops
    and counts) and ``register_layout`` (dict set). Everything else —
    folding, decay, eviction, working-set math, metric publication —
    runs on the single worker thread."""

    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._worker: Optional[threading.Thread] = None
        self._busy = 0
        self._regions: Dict[int, _RegionHeat] = {}

    # -- serving-thread surface ---------------------------------------------
    def observe(self, region_id: int, kind: str, units,
                weight: float = 1.0) -> None:
        """Record one resolve's touches. ``units`` is a host array of
        unit ids (IVF bucket ids for kind="ivf"; raw result slots for
        kind="slot" — mapped to SLOT_BLOCK units and -1-filtered on the
        worker, not here). Call sites gate on heat_enabled() so the
        off path never reaches this function."""
        try:
            arr = np.asarray(units)
            if arr.size == 0:
                return
            item = (int(region_id), kind, arr.reshape(-1).copy(),
                    float(weight), time.time())
        except Exception:  # noqa: BLE001 — observability never breaks
            _log.exception("heat observe failed")          # the reply
            return
        with self._cond:
            if len(self._queue) >= QUEUE_MAX:
                self.registry.counter(
                    "heat.dropped", region_id=region_id).add(1)
                return
            self._queue.append(item)
            self._ensure_worker()
            self._cond.notify()

    def register_layout(self, region_id: int, kind: str,
                        provider: Callable[[], Optional[dict]]) -> None:
        """Attach a layout provider for (region, kind). The provider is
        invoked on the WORKER thread (<= once per _LAYOUT_TTL_S) and
        returns ``{"unit_rows": array-or-None, "rows_per_unit": int,
        "row_bytes": float, "tier": str, "dim": int}`` or None."""
        with self._lock:
            rh = self._regions.get(region_id)
            if rh is None:
                rh = self._regions[region_id] = _RegionHeat(time.time())
            rh.layouts[kind] = provider

    # -- async lane ---------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        # context-free background fold loop (the quality-plane pattern):
        # touch batches carry their own timestamps; no trace or budget
        # crosses into the worker.
        # a context-free background loop
        self._worker = threading.Thread(
            target=self._run, name="heat-fold", daemon=True
        )
        self._worker.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                item = self._queue.popleft()
                self._busy += 1
            try:
                self._fold(item)
            except Exception:  # noqa: BLE001 — the lane must survive
                _log.exception("heat fold failed")
            finally:
                with self._cond:
                    self._busy -= 1
                    self._cond.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued touch batch is folded (tests,
        smoke, the collector's deterministic reads)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._busy:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._cond.wait(timeout=remain)
        return True

    # -- folding (worker thread) --------------------------------------------
    def _fold(self, item) -> None:
        region_id, kind, units, weight, ts = item
        if kind == "slot":
            units = units[units >= 0] // SLOT_BLOCK
            if units.size == 0:
                return
        tau = _decay_s()
        cap = _max_entries()
        with self._lock:
            rh = self._regions.get(region_id)
            if rh is None:
                rh = self._regions[region_id] = _RegionHeat(ts)
            n = rh.fold(kind, units, weight, ts, tau, cap)
            publish = ts - rh.last_publish >= _PUBLISH_MIN_S
            if publish:
                rh.last_publish = ts
        self.registry.counter("heat.touches", region_id=region_id).add(n)
        if publish:
            with self._lock:
                st = rh.derive(ts, tau)
            self._publish(region_id, st)

    def _publish(self, region_id: int, st: Dict[str, Any]) -> None:
        g = self.registry.gauge
        g("heat.bucket_gini", region_id).set(round(st["gini"], 6))
        g("heat.hot_fraction", region_id).set(
            round(st["hot_fraction"], 6))
        g("heat.entries", region_id).set(st["entries"])
        for p, b in st["ws_bytes"].items():
            g("heat.working_set_bytes", region_id,
              {"pct": str(p), "tier": st["tier"]}).set(b)
        for tier, per_pct in st["ws_bytes_tier"].items():
            if tier == st["tier"]:
                continue
            for p, b in per_pct.items():
                g("heat.working_set_bytes", region_id,
                  {"pct": str(p), "tier": tier}).set(b)

    # -- read side ----------------------------------------------------------
    def region_stats(self, region_id: int) -> Optional[Dict[str, Any]]:
        """Latest derived stats for the heartbeat harvest (collector
        thread). Recomputes when folds landed since the last publish so
        a freshly-flushed test or smoke read is never a beat stale."""
        with self._lock:
            rh = self._regions.get(region_id)
            if rh is None or rh.touches == 0:
                return None
            return rh.derive(time.time(), _decay_s())

    def unit_masses(self, region_id: int,
                    kind: Optional[str] = None) -> Dict[Tuple[str, int],
                                                        float]:
        """Decayed per-unit masses (the smoke, tests). True mass
        basis (warp undone)."""
        now = time.time()
        tau = _decay_s()
        with self._lock:
            rh = self._regions.get(region_id)
            if rh is None:
                return {}
            scale = math.exp((rh.t0 - now) / tau)
            return {k: v * scale for k, v in rh.mass.items()
                    if kind is None or k[0] == kind}

    def forget_region(self, region_id: int) -> None:
        """Drop the region's sketch when the store no longer hosts it
        (the collector's retire loop)."""
        with self._lock:
            self._regions.pop(region_id, None)

    def reset(self) -> None:
        """Forget everything (tests)."""
        with self._cond:
            self._queue.clear()
            self._regions.clear()


HEAT = HeatPlane()
