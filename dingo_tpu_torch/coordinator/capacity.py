"""Coordinator capacity plane: device headroom vs measured working-set
demand, with tier/split recommendations (port of
dingo_tpu/coordinator/capacity.py, whole).

Each heartbeat's snapshot can carry a workload-heat rollup per region
(RegionMetrics.heat_* — bytes to serve {50,90,99}% of traffic at the
region's own precision tier, traffic concentration). This module turns
one store's snapshot into a capacity view:

- **Headroom** — the device limit minus bytes in use, as absolute bytes
  and as a fraction of the limit. ``capacity_headroom_target`` is the
  fraction the plane wants free.
- **Demand** — the regions' p99 working-set bytes summed. Resident bytes
  far above demand are *cold* — the tiering candidate mass.
- **Advisories** — pure recommendations, exactly two kinds:
  - ``demote``: the store is under its headroom target and a region
    holds the most cold bytes (resident − p99 working set).
  - ``split``: one region concentrates the store's traffic (share ≥
    ``SPLIT_TRAFFIC_SHARE``) onto a hot core (hot_fraction ≥
    ``SPLIT_HOT_FRACTION``).

The plane never actuates: control.py turns each fresh ``demote`` advisory
into a TIER_DEMOTE region command, which the store acks (the memory-tier
ladder that would act on it is not ported; the JAX package acks it the
same way under its default ``tier_enabled = False``). The port's
snapshots carry no heat rollup yet, so no advisory fires.

All inputs are duck-typed, every function is deterministic, and nothing
here takes locks or touches devices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

#: a region advises "split" when it carries at least this share of the
#: store's sketch touches...
SPLIT_TRAFFIC_SHARE = 0.5
#: ...concentrated onto a hot core at least this tight (mass on the
#: hottest 10% of heat units)
SPLIT_HOT_FRACTION = 0.6
#: demote advisories require real evidence: at least this many sketch
#: touches on the region (a freshly-started sketch must not demote
#: anything) and at least this many cold bytes to be worth a move
MIN_TOUCHES = 1000
MIN_COLD_BYTES = 1 << 20


def capacity_advise_enabled() -> bool:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return bool(FLAGS.get("capacity_advise"))
    except KeyError:
        return True


def headroom_target() -> float:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return max(0.0, min(1.0, float(
            FLAGS.get("capacity_headroom_target"))))
    except KeyError:
        return 0.2


@dataclasses.dataclass
class CapacityAdvice:
    """One advisory recommendation (never an order)."""

    store_id: str
    region_id: int
    kind: str          # "demote" | "split"
    reason: str
    #: bytes the advice is about (cold bytes for demote, p99 working
    #: set for split) — the ranking axis
    bytes_at_stake: int = 0


def region_cold_bytes(rm: Any) -> int:
    """Resident bytes the measured traffic does NOT need: device
    residency minus the p99 working set (floored at 0 — a working set
    estimated above residency just means the sketch prices a tier the
    store doesn't hold)."""
    resident = int(getattr(rm, "device_memory_bytes", 0) or 0)
    ws = int(getattr(rm, "heat_working_set_p99", 0) or 0)
    return max(0, resident - min(ws, resident))


def plan_store(snap: Any, target: Optional[float] = None) -> Dict[str, Any]:
    """Capacity plan for ONE store snapshot (pb StoreMetrics or
    StoreMetricsSnapshot). Returns a dict of rollups + advice list,
    ranked by bytes at stake. Pure and deterministic — the coordinator
    hook and the CLI render call this same function."""
    if target is None:
        target = headroom_target()
    store_id = str(getattr(snap, "store_id", ""))
    limit = int(getattr(snap, "device_bytes_limit", 0) or 0)
    in_use = int(getattr(snap, "device_bytes_in_use", 0) or 0)
    regions = list(getattr(snap, "regions", []) or [])
    headroom = max(0, limit - in_use)
    frac = headroom / limit if limit > 0 else 1.0
    demand = sum(int(getattr(r, "heat_working_set_p99", 0) or 0)
                 for r in regions)
    resident = sum(int(getattr(r, "device_memory_bytes", 0) or 0)
                   for r in regions)
    touches_total = sum(int(getattr(r, "heat_touches", 0) or 0)
                        for r in regions)
    advice: List[CapacityAdvice] = []
    # demote: under the headroom target, recommend the coldest region
    if limit > 0 and frac < target:
        candidates = [
            (region_cold_bytes(r), r) for r in regions
            if int(getattr(r, "heat_touches", 0) or 0) >= MIN_TOUCHES
        ]
        candidates = [(cb, r) for cb, r in candidates
                      if cb >= MIN_COLD_BYTES]
        if candidates:
            cold, r = max(candidates, key=lambda c: c[0])
            advice.append(CapacityAdvice(
                store_id=store_id,
                region_id=int(r.region_id),
                kind="demote",
                bytes_at_stake=cold,
                reason=(
                    f"headroom {frac:.0%} < target {target:.0%}; "
                    f"{cold} resident bytes outside the p99 working set"
                ),
            ))
    # split: a single region hogging the store's traffic on a hot core
    if touches_total > 0:
        for r in regions:
            touches = int(getattr(r, "heat_touches", 0) or 0)
            if touches < MIN_TOUCHES:
                continue
            share = touches / touches_total
            hot = float(getattr(r, "heat_hot_fraction", 0.0) or 0.0)
            if share >= SPLIT_TRAFFIC_SHARE and hot >= SPLIT_HOT_FRACTION \
                    and len(regions) >= 1:
                advice.append(CapacityAdvice(
                    store_id=store_id,
                    region_id=int(r.region_id),
                    kind="split",
                    bytes_at_stake=int(
                        getattr(r, "heat_working_set_p99", 0) or 0),
                    reason=(
                        f"carries {share:.0%} of store traffic with "
                        f"hot_fraction {hot:.2f} — a hotspot splitting "
                        f"would spread"
                    ),
                ))
    advice.sort(key=lambda a: -a.bytes_at_stake)
    return {
        "store_id": store_id,
        "limit_bytes": limit,
        "in_use_bytes": in_use,
        "headroom_bytes": headroom,
        "headroom_frac": frac,
        "demand_p99_bytes": demand,
        "resident_bytes": resident,
        "touches": touches_total,
        "advice": advice,
    }


def plan_cluster(snaps: List[Any],
                 target: Optional[float] = None) -> List[Dict[str, Any]]:
    """Per-store plans for a set of snapshots (cluster view), in
    store-id order for stable rendering."""
    plans = [plan_store(s, target) for s in snaps]
    plans.sort(key=lambda p: p["store_id"])
    return plans
