"""Per-(kernel, padded-shape) dispatch cost model (port of
dingo_tpu/obs/cost.py).

The coalescer's admission control used to price every queued row with
ONE scalar per-row EWMA — a global average over every kernel family and
batch shape the process ever ran. That is wrong in both directions: a
small-k FLAT dispatch and a wide-beam HNSW dispatch can differ by an
order of magnitude per row, and padded execution means cost steps at
the pad-ladder points rather than scaling linearly. This module learns
the real surface from the timings the completion lane already records:

- **Key.** (kernel id, padded-rows ladder point). The kernel id is
  derived from the coalescer key — (region, topn, params) IS one
  compiled-program family — and the rows axis uses the serving shape
  ladder (index/ivf_layout.shape_bucket), so the model's support is
  exactly the set of batch shapes the serving path runs.
- **Learning.** Every dispatch completion feeds ``note(kernel, rows,
  run_ms)``: an EWMA per ladder point (alpha 0.3, the coalescer's own
  smoothing) plus a per-kernel per-row rate for interpolation between
  points, and a per-region run-time/row-rate aggregate for the SLO
  tuner and heartbeats.
- **Estimating.** ``estimate_run_ms(kernel, rows)`` answers from the
  exact ladder point when it has one, interpolates/extrapolates from
  the nearest measured point otherwise, and falls back to the
  ``cost.prior_row_ms`` conservative prior when the kernel has never
  been measured — so the FIRST overload burst sheds on a pessimistic
  estimate instead of riding in on the old ``return 0.0`` cold-start
  hole.
- **Shape.** ``cost.*`` curated family; per-region row-rate rides
  heartbeats (RegionMetricsSnapshot.cost_row_us) into the coordinator's
  capacity rollups and flight bundles.

Everything here is host-side dict math under one lock — safe to call
from the completion lane's resolve and the admission path.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, Optional, Tuple

from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS

_log = get_logger("obs.cost")

#: EWMA smoothing for per-point run times (the coalescer's own alpha)
_ALPHA = 0.3

#: per-kernel ladder points kept (pad ladders are short; this is a
#: runaway bound, not a working limit)
_MAX_POINTS = 64

#: publication throttle: gauges update on note() at most this often
#: per kernel (completion-lane rate can be thousands/s)
_PUBLISH_EVERY = 16


def cost_enabled() -> bool:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return bool(FLAGS.get("cost_enabled"))
    except KeyError:
        return True


def prior_row_ms() -> float:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return max(0.0, float(FLAGS.get("cost_prior_row_ms")))
    except KeyError:
        return 0.5


def _ladder(rows: int) -> int:
    """Rows -> the serving pad-ladder point ({1,1.5}x-pow2, the shape
    discipline every dispatch actually compiles at)."""
    try:
        from dingo_tpu_torch.index.ivf_layout import shape_bucket

        return int(shape_bucket(max(1, int(rows))))
    except Exception:  # noqa: BLE001 — unit contexts without the index
        r, p = max(1, int(rows)), 1                       # package
        while p < r:
            p *= 2
        return p


def kernel_id(key: Any) -> str:
    """Stable kernel-family id from a coalescer key. The canonical key
    is (region_id, topn, params-tuple); params collapse to a short hash
    so metric labels stay bounded. Any other hashable (test fakes)
    falls back to its repr."""
    if isinstance(key, tuple) and len(key) >= 2 \
            and isinstance(key[0], int):
        tail = ""
        if len(key) > 2 and key[2]:
            h = hashlib.blake2s(repr(key[2:]).encode(),
                                digest_size=4).hexdigest()
            tail = f":{h}"
        return f"r{key[0]}:k{key[1]}{tail}"
    return repr(key)[:48]


def kernel_region(key: Any) -> Optional[int]:
    if isinstance(key, tuple) and key and isinstance(key[0], int):
        return key[0]
    return None


class _KernelModel:
    __slots__ = ("points", "row_ms", "samples")

    def __init__(self):
        #: ladder rows -> EWMA total run ms at that point
        self.points: Dict[int, float] = {}
        #: per-row rate EWMA across points (interpolation fallback)
        self.row_ms = 0.0
        self.samples = 0


class CostModel:
    """Process-global dispatch cost model (``COST``)."""

    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        self._kernels: Dict[str, _KernelModel] = {}
        #: region -> (EWMA run ms of its typical dispatch, EWMA row ms)
        self._regions: Dict[int, Tuple[float, float]] = {}

    # -- learning -----------------------------------------------------------
    def note(self, kernel: str, rows: int, run_ms: float,
             region_id: Optional[int] = None) -> None:
        """Feed one completed dispatch (completion lane / serial run
        path). ``rows`` is the UNPADDED row count; the ladder point it
        compiled at is recomputed here so caller and model can never
        disagree about the axis."""
        if not cost_enabled():
            return
        rows = int(rows)
        if rows <= 0 or run_ms <= 0.0:
            return
        point = _ladder(rows)
        per_row = run_ms / point
        with self._lock:
            km = self._kernels.get(kernel)
            if km is None:
                km = self._kernels[kernel] = _KernelModel()
            cur = km.points.get(point)
            km.points[point] = run_ms if cur is None else (
                (1.0 - _ALPHA) * cur + _ALPHA * run_ms)
            km.row_ms = per_row if km.samples == 0 else (
                (1.0 - _ALPHA) * km.row_ms + _ALPHA * per_row)
            km.samples += 1
            samples = km.samples
            if len(km.points) > _MAX_POINTS:
                km.points.pop(min(km.points))
            if region_id is not None:
                r_run, r_row = self._regions.get(region_id, (0.0, 0.0))
                first = r_run == 0.0 and r_row == 0.0
                self._regions[region_id] = (
                    run_ms if first else
                    (1.0 - _ALPHA) * r_run + _ALPHA * run_ms,
                    per_row if first else
                    (1.0 - _ALPHA) * r_row + _ALPHA * per_row,
                )
            point_ms = km.points[point]
            row_ms = km.row_ms
        if samples == 1 or samples % _PUBLISH_EVERY == 0:
            labels = {"kernel": kernel, "rows": str(point)}
            self.registry.gauge("cost.run_ms", region_id,
                                labels).set(round(point_ms, 4))
            self.registry.gauge(
                "cost.row_us", region_id,
                {"kernel": kernel}).set(round(row_ms * 1000.0, 3))
            self.registry.counter("cost.samples", region_id).add(
                1 if samples == 1 else _PUBLISH_EVERY)

    # -- estimating ---------------------------------------------------------
    def estimate_run_ms(self, kernel: Optional[str], rows: int) -> float:
        """Predicted run time of a ``rows``-row dispatch of ``kernel``.
        Exact ladder point -> its EWMA; otherwise scale the nearest
        measured point by the per-row rate; never measured -> the
        conservative prior (rows x cost.prior_row_ms)."""
        rows = int(rows)
        if rows <= 0:
            return 0.0
        point = _ladder(rows)
        with self._lock:
            km = self._kernels.get(kernel) if kernel is not None \
                else None
            if km is None or not km.points:
                return rows * prior_row_ms()
            exact = km.points.get(point)
            if exact is not None:
                return exact
            # nearest measured point in log-rows distance; beyond the
            # support extrapolate by the per-row rate, between points
            # scale the nearer one's per-row cost
            near = min(km.points,
                       key=lambda p: abs(_log2(p) - _log2(point)))
            near_ms = km.points[near]
            est = near_ms * (point / near)
            # a smaller dispatch never costs MORE than the measured
            # larger one; a larger one never costs less than measured
            if point < near:
                return min(near_ms, max(est, km.row_ms * point))
            return max(est, near_ms)

    def has_model(self, kernel: Optional[str]) -> bool:
        if kernel is None:
            return False
        with self._lock:
            km = self._kernels.get(kernel)
            return km is not None and bool(km.points)

    def row_ms(self, kernel: Optional[str]) -> Optional[float]:
        """Measured per-row rate for the kernel (None = unmeasured)."""
        if kernel is None:
            return None
        with self._lock:
            km = self._kernels.get(kernel)
            if km is None or km.samples == 0:
                return None
            return km.row_ms

    # -- region aggregates (tuner, heartbeats) ------------------------------
    def region_typical_ms(self, region_id: int) -> Optional[float]:
        """EWMA run time of the region's typical dispatch — the latency
        floor the SLO tuner treats as evidence before (and alongside)
        measured p99s."""
        with self._lock:
            st = self._regions.get(region_id)
            return st[0] if st is not None else None

    def region_row_us(self, region_id: int) -> float:
        """Per-row cost in µs for heartbeat rollups (0.0 = unmeasured)."""
        with self._lock:
            st = self._regions.get(region_id)
            return st[1] * 1000.0 if st is not None else 0.0

    # -- lifecycle ----------------------------------------------------------
    def forget_region(self, region_id: int) -> None:
        with self._lock:
            self._regions.pop(region_id, None)
            prefix = f"r{region_id}:"
            for k in [k for k in self._kernels if k.startswith(prefix)]:
                del self._kernels[k]

    def reset(self) -> None:
        with self._lock:
            self._kernels.clear()
            self._regions.clear()


def _log2(x: int) -> float:
    import math

    return math.log2(max(1, x))


COST = CostModel()
