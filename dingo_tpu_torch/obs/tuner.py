"""Closed-loop SLO parameter controller over the quality plane (port of
dingo_tpu/obs/tuner.py).

The quality plane (obs/quality.py) is the sensor: a windowed live recall
estimate with a Wilson CI per region. This module is the actuator: given
``quality.slo_recall`` and a latency budget, it walks the region's search
knobs ONE step per tick along a cheap→expensive ladder —

  rerank_factor (quantized tiers)  →  nprobe (IVF family) / ef (HNSW)
      →  precision tier (ADVISORY — a tier flip means re-encoding the
         store, so the tuner publishes the target instead of flipping)

— **tightening** (next step up) when the recall CI's upper bound dips
below the SLO (the estimate says the SLO is violated with confidence),
and **relaxing** (step down, most expensive knob first) when the lower
bound clears the SLO with margin, i.e. the region is paying for recall
nobody asked for.

Every value the tuner can choose sits on the SAME {1,1.5}x-pow2 shape
ladder the serving path buckets to (ivf_layout.shape_bucket), so a tuner
step never mints a new compiled program: steady-state recompiles stay 0
across tuner activity — the launch sentinel (obs/sentinel.py) makes
this a checkable invariant.

Discipline per step: apply the knob to ``index.tuning`` (consulted by the
index search paths as the default when the request doesn't pin the
parameter), then RESET the region's estimator window — evidence gathered
under the old setting must not judge the new one; the controller
naturally waits for ``min_queries`` of fresh post-step evidence before
moving again, which is the hysteresis that keeps it from thrashing.

Wired like the replica planner: ``QualityTunerRunner`` rides a store
crontab (``tuner.interval_s``), hot-reads ``tuner.enabled`` per tick, and
no-ops on stale/missing estimates — tuning on dead figures is worse than
not tuning.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS

_log = get_logger("obs.tuner")

#: rerank_factor ladder for the quantized tiers' exact-rerank breadth
RERANK_LADDER = (1, 2, 4, 8, 16)

#: ef ceiling for the HNSW ladder (beyond this the graph walk costs more
#: than a scan)
EF_CAP = 512

#: precision tiers cheap→expensive (the advisory ladder)
PRECISION_LADDER = ("sq8", "bf16", "fp32")


def ladder_values(cap: int, floor: int = 1) -> Tuple[int, ...]:
    """Every {1,1.5}x-pow2 shape-bucket value in [floor, cap] (plus cap
    itself): the EXACT set of shapes the serving path's bucketing can
    produce, so a tuner-chosen value is always an already-warm program."""
    vals = {1, 2, 3}
    p = 4
    while p <= cap:
        vals.add(p)
        mid = 3 * (p // 2)
        if mid <= cap:
            vals.add(mid)
        p *= 2
    vals.add(int(cap))
    return tuple(sorted(v for v in vals if floor <= v <= cap))


def ladder_step(values: Tuple[int, ...], current: int,
                up: bool) -> Optional[int]:
    """Next ladder value above/below `current`; None at the bound."""
    if up:
        for v in values:
            if v > current:
                return v
        return None
    prev = None
    for v in values:
        if v >= current:
            break
        prev = v
    return prev


@dataclasses.dataclass
class TuneOp:
    region_id: int
    knob: str            # "nprobe" | "ef" | "rerank_factor" | "precision"
    old: object
    new: object
    direction: str       # "tighten" | "relax"
    applied: bool = True  # False = advisory (precision target)


class SloTuner:
    """One step of the cheap→expensive knob walk per call (crontab tick).

    Overrides land in ``index.tuning`` — the per-region serving defaults
    the search paths consult when a request doesn't pin the parameter —
    so client-pinned requests are never second-guessed."""

    def __init__(self, slo_recall: Optional[float] = None,
                 latency_budget_ms: Optional[float] = None,
                 relax_margin: float = 0.02, min_queries: int = 32,
                 quality_plane=None):
        self._slo = slo_recall
        self._budget = latency_budget_ms
        self.relax_margin = relax_margin
        self.min_queries = min_queries
        self._quality = quality_plane
        #: region -> precision target already advised (the advisory is
        #: published ONCE per stuck-at-ceiling episode, not every tick)
        self._advised: Dict[int, str] = {}

    def _flag(self, name: str, override):
        if override is not None:
            return override
        from dingo_tpu_torch.common.config import FLAGS

        return FLAGS.get(name)

    def _plane(self):
        if self._quality is not None:
            return self._quality
        from dingo_tpu_torch.obs.quality import QUALITY

        return QUALITY

    # -- knob model ----------------------------------------------------------
    def _knobs(self, index) -> List[Tuple[str, Tuple[int, ...], int]]:
        """(knob, ladder, current) cheap→expensive for this index kind.
        Current = tuning override if set, else the configured default —
        the tuner's first step moves FROM the operator's setting."""
        from dingo_tpu_torch.common.config import FLAGS

        knobs: List[Tuple[str, Tuple[int, ...], int]] = []
        kind = index.index_type.value
        precision = getattr(index, "_precision", "fp32")
        # the quantized-tier rerank knob is only a LIVE actuator when the
        # index actually has a rerank cache (_rerank_shortlist returns
        # None without one) — offering it cache-less would burn tuner
        # ticks stepping a disconnected dial while the SLO stays violated
        quant_rerank = (
            precision in ("bf16", "sq8")
            and getattr(index, "_rerank_cache", None) is not None
        )
        if kind in ("ivf_flat", "ivf_pq"):
            if kind == "ivf_pq":
                # IVF_PQ's exact-rerank breadth works without a cache
                # (ADC prune + device/host row rerank)
                cur = int(index.tuning.get("rerank_factor")
                          or FLAGS.get("ivfpq_rerank_factor"))
                knobs.append(("rerank_factor", RERANK_LADDER, cur))
            elif quant_rerank:
                cur = int(index.tuning.get("rerank_factor")
                          or FLAGS.get("quantized_rerank_factor"))
                knobs.append(("rerank_factor", RERANK_LADDER, cur))
            nlist = int(getattr(index, "nlist", 0) or 1)
            cur = int(index.tuning.get("nprobe")
                      or index.parameter.default_nprobe)
            knobs.append(("nprobe", ladder_values(nlist), min(cur, nlist)))
        elif kind == "hnsw":
            cur = int(index.tuning.get("ef")
                      or getattr(index, "ef_search_default", 64))
            knobs.append(("ef", ladder_values(EF_CAP, floor=4),
                          min(cur, EF_CAP)))
        elif kind == "flat" and quant_rerank:
            cur = int(index.tuning.get("rerank_factor")
                      or FLAGS.get("quantized_rerank_factor"))
            knobs.append(("rerank_factor", RERANK_LADDER, cur))
        return knobs

    def _tighten(self, index) -> Optional[TuneOp]:
        for knob, ladder, cur in self._knobs(index):
            nxt = ladder_step(ladder, cur, up=True)
            if nxt is not None:
                return TuneOp(index.id, knob, cur, nxt, "tighten")
        # every live knob is at its ladder ceiling: the remaining lever is
        # the precision tier — advisory only (a flip re-encodes the store;
        # a tier migration is the mechanism that will act).
        # Emitted once per stuck episode: unapplied ops don't reset the
        # estimator window, so without the memo the same advisory would
        # re-fire (counter + log line) every single tick forever.
        precision = getattr(index, "_precision", "fp32")
        if precision in PRECISION_LADDER[:-1]:
            target = PRECISION_LADDER[
                PRECISION_LADDER.index(precision) + 1]
            if self._advised.get(index.id) == target:
                return None
            self._advised[index.id] = target
            return TuneOp(index.id, "precision", precision, target,
                          "tighten", applied=False)
        return None

    def _relax(self, index) -> Optional[TuneOp]:
        for knob, ladder, cur in reversed(self._knobs(index)):
            prev = ladder_step(ladder, cur, up=False)
            if prev is not None:
                return TuneOp(index.id, knob, cur, prev, "relax")
        return None

    # -- the control step -----------------------------------------------------
    def step_index(self, index, estimate: Optional[Dict[str, float]],
                   p99_ms: Optional[float] = None) -> Optional[TuneOp]:
        """Decide + apply at most one knob step for this region. Returns
        the op (advisory ops carry applied=False), or None (no evidence,
        in-band, or at a ladder bound)."""
        slo = float(self._flag("quality_slo_recall", self._slo))
        budget = float(self._flag("tuner_latency_budget_ms", self._budget))
        if estimate is None or estimate.get("queries", 0) < self.min_queries:
            return None     # no / not enough fresh evidence: hold position
        if METRICS.gauge("qos.degrade_level",
                         region_id=index.id).get() > 0:
            # the pressure shed ladder (obs/pressure.py ShedController) is
            # actively degrading this region: tightening the very knobs it
            # just relaxed would make the two controllers fight — hold and
            # count until pressure clears (the shed controller restores
            # the saved settings on its way back down)
            METRICS.counter("quality.tuner_blocked",
                            region_id=index.id).add(1)
            return None
        from dingo_tpu_torch.obs.quality import WindowedEstimator

        age = time.time() - float(estimate.get("newest_ts", 0.0))
        if age > 2.0 * WindowedEstimator._window_s():
            return None     # stale estimate: tuning on dead figures
        ci_lo = float(estimate["ci_low"])
        ci_hi = float(estimate["ci_high"])
        over_budget = budget > 0 and p99_ms is not None and p99_ms > budget
        if ci_hi < slo:
            # the SLO is violated with confidence — tighten, unless the
            # latency budget is already blown (then quality and latency
            # are in direct conflict: hold, count, let load shedding /
            # the operator arbitrate rather than oscillate)
            if over_budget:
                METRICS.counter("quality.tuner_blocked",
                                region_id=index.id).add(1)
                return None
            op = self._tighten(index)
        elif ci_lo > slo + self.relax_margin or (over_budget and
                                                 ci_lo > slo):
            # comfortably above the SLO (or above it AND over the latency
            # budget): walk back toward faster settings. Leaving the
            # stuck-at-ceiling regime re-arms the precision advisory.
            self._advised.pop(index.id, None)
            op = self._relax(index)
        else:
            self._advised.pop(index.id, None)   # back in band: re-arm
            return None     # in band
        if op is None:
            return None
        if op.applied:
            index.tuning[op.knob] = int(op.new)
            self._plane().reset_region(index.id)
        from dingo_tpu_torch.obs.events import EVENTS

        EVENTS.emit(
            "tuner", index.id, op.knob, op.old, op.new,
            trigger=op.direction if op.applied else "advise",
            evidence={"ci_low": round(ci_lo, 4), "ci_high": round(ci_hi, 4),
                      "slo": slo, "p99_ms": p99_ms, "budget_ms": budget,
                      "queries": int(estimate.get("queries", 0))},
        )
        self._note(op, getattr(index, "_precision", "fp32"))
        _log.info(
            "tuner region %d: %s %s %s -> %s (recall CI [%.4f, %.4f], "
            "slo %.2f)", op.region_id, op.direction, op.knob, op.old,
            op.new, ci_lo, ci_hi, slo,
        )
        return op

    @staticmethod
    def _note(op: TuneOp, precision: str) -> None:
        METRICS.counter("quality.tuner_steps", region_id=op.region_id,
                        labels={"knob": op.knob,
                                "direction": op.direction}).add(1)
        if op.knob == "nprobe":
            METRICS.gauge("quality.tuner_nprobe",
                          region_id=op.region_id).set(float(op.new))
        elif op.knob == "ef":
            METRICS.gauge("quality.tuner_ef",
                          region_id=op.region_id).set(float(op.new))
        elif op.knob == "rerank_factor":
            METRICS.gauge("quality.tuner_rerank_factor",
                          region_id=op.region_id).set(float(op.new))
        elif op.knob == "precision":
            METRICS.gauge(
                "quality.tuner_precision_target", region_id=op.region_id
            ).set(float(PRECISION_LADDER.index(str(op.new))))


class QualityTunerRunner:
    """Store-side crontab body (server/main.py ``quality_tuner`` tab, the
    replica-planner wiring pattern): per ready region, read the live
    estimate + the measured vector_search p99 and take one tuner step.
    Hot-reads ``tuner.enabled`` per tick so operators can flip it live."""

    def __init__(self, node, tuner: Optional[SloTuner] = None,
                 crontab=None, tab_name: str = "quality_tuner"):
        self.node = node
        self.tuner = tuner or SloTuner()
        #: owning CrontabManager (when crontab-wired): tuner.interval_s
        #: is hot-changeable, so each tick re-applies it to the tab
        self._crontab = crontab
        self._tab_name = tab_name

    def tick(self) -> int:
        from dingo_tpu_torch.common.config import FLAGS
        from dingo_tpu_torch.obs.quality import QUALITY

        if self._crontab is not None:
            self._crontab.set_interval(
                self._tab_name, float(FLAGS.get("tuner_interval_s"))
            )
        if not bool(FLAGS.get("tuner_enabled")):
            return 0
        steps = 0
        for region in self.node.meta.get_all_regions():
            wrapper = region.vector_index_wrapper
            if wrapper is None or not wrapper.is_ready():
                continue
            index = wrapper.own_index
            if index is None:
                continue
            est = QUALITY.region_estimate(region.id)
            st = METRICS.latency("vector_search", region.id).stats()
            p99_ms = st["p99_us"] / 1000.0 if st["count"] else None
            # the per-shape cost model is a latency FLOOR: a region
            # whose typical dispatch alone cannot fit the budget is
            # over-budget evidence even before (or between) measured
            # p99 samples — the tuner must not walk recall knobs UP
            # into a latency wall the cost surface already predicts
            from dingo_tpu_torch.obs.cost import COST, cost_enabled

            if cost_enabled():
                typical = COST.region_typical_ms(region.id)
                if typical is not None:
                    p99_ms = typical if p99_ms is None \
                        else max(p99_ms, typical)
            if self.tuner.step_index(index, est, p99_ms=p99_ms) is not None:
                steps += 1
        return steps
