"""Cache policy gates (port of dingo_tpu/cache/policy.py): when each
serving tier is allowed to answer.

Three tiers, strictly ordered by how much they're allowed to assume:

- **dedupe** (always safe): collapsing identical in-flight rows changes
  nothing observable — every fan-out member receives the same rows a solo
  dispatch would have produced. Enabled whenever the subsystem is.
- **exact hits** (safe at the live version): keyed on
  ``mutation_version``, so correctness is structural. Enabled whenever
  the subsystem is and ``cache.max_bytes`` > 0.
- **stale hits**: bounded ``cache.stale_versions`` behind, and ONLY
  while the region's shed ladder is degraded (qos.degrade_level > 0) —
  a pressure valve on the QoS degrade ladder, never steady state.
- **semantic hits**: sq8-rounded fingerprints, off by default, and gated
  live by the shadow-quality estimator: they serve only while the
  windowed recall CI lower bound holds ``quality.slo_recall``. No
  estimate for the region (cold estimator) means NO semantic serving —
  the gate fails closed.

Every gate is a cheap host-side read (flag + gauge/dict); nothing here
touches a device value.
"""

from __future__ import annotations


def cache_enabled() -> bool:
    """Whole-subsystem gate (``cache.enabled``)."""
    from dingo_tpu_torch.common.config import result_cache_enabled

    return result_cache_enabled()


def dedupe_enabled() -> bool:
    """In-flight dedupe rides the subsystem gate; it needs no byte
    budget (``cache.max_bytes = 0`` keeps dedupe while disabling the
    result store)."""
    return cache_enabled()


#: region_id -> stale bound currently engaged. Transition memo so the
#: event ledger records WHEN stale serving engaged/disengaged, not every
#: per-query gate read (stale_versions_allowed is hot-path).
_stale_engaged: dict = {}


def stale_versions_allowed(region_id: int) -> int:
    """How many mutation_versions behind a hit may serve for this region
    RIGHT NOW: ``cache.stale_versions`` while the shed ladder is degraded,
    else 0 (exact-version only)."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.obs.pressure import degrade_level

    try:
        bound = int(FLAGS.get("cache_stale_versions"))
    except (TypeError, ValueError):
        bound = 0
    level = degrade_level(region_id) if bound > 0 else 0
    allowed = bound if (bound > 0 and level > 0) else 0
    prev = _stale_engaged.get(region_id, 0)
    if allowed != prev:
        _stale_engaged[region_id] = allowed
        from dingo_tpu_torch.obs.events import EVENTS

        EVENTS.emit(
            "cache", region_id, "stale_rung", prev, allowed,
            trigger="engage" if allowed else "disengage",
            evidence={"degrade_level": level, "bound": bound},
        )
    return allowed


def forget_region(region_id: int) -> None:
    """Drop the stale-serving transition memo for a retired region (called
    from the collector's retire sweep alongside the other planes)."""
    _stale_engaged.pop(region_id, None)


def semantic_allowed(region_id: int) -> bool:
    """Live SLO gate for approximate hits: ``cache.semantic`` is on AND
    the shadow-quality estimator currently attests the region's windowed
    recall CI lower bound >= ``quality.slo_recall``. Fails closed when
    the estimator has no evidence."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.obs.quality import QUALITY

    v = FLAGS.get("cache_semantic")
    if isinstance(v, str):
        on = v.strip().lower() in ("true", "1", "on", "yes")
    else:
        on = bool(v)
    if not on:
        return False
    est = QUALITY.region_estimate(region_id)
    if not est:
        return False
    try:
        slo = float(FLAGS.get("quality_slo_recall"))
        ci_low = float(est.get("ci_low", 0.0))
    except (TypeError, ValueError):
        return False
    return ci_low >= slo
