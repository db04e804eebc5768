"""Serving-pressure observability plane + QoS budget propagation (port
of dingo_tpu/obs/pressure.py).

The rest of the observability stack can see latency (trace), recompiles
(sentinel), HBM (ledger), and recall (quality) — but nothing measures
*pressure*: how long requests wait relative to what they can afford, who
is demanding the capacity, and what fraction of the work served actually
arrived in time to matter. Under overload those are the only questions;
KBest (PAPERS.md) ties sustained QPS to a kernel path that is fed but
bounded, and Faiss frames ANN serving as optimization under a budget —
here the budget is per-request *time*, and this module makes it a
first-class, propagated, observed quantity.

Three cooperating pieces:

- **Budget** — the per-request deadline/tenant/priority triple. It rides
  the same plumbing as the trace context: a contextvar inside a process
  (surviving the coalescer's thread handoff via capture-at-submit), request
  metadata between processes (``x-dingo-deadline-ms`` carries REMAINING
  milliseconds, never absolute wall time — clocks differ across hosts;
  the deadline-propagation convention of RPC systems). Extraction never fails the
  request it rode in on, and with ``qos.enabled = false`` and no headers
  present the path allocates nothing (the tracing discipline).

- **PressurePlane** (``PRESSURE``) — the sensor: the curated ``qos.*``
  metrics family. Per-(region, tenant, priority) demand and queue-depth
  gauges, queue-wait recorders and short-window watermarks, per-stage
  time-budget accounting (queue-wait / batch-form / kernel / rerank as
  percentages of the request's deadline), goodput-vs-throughput and
  shed/expired counters, and deadline-exceeded flight-bundle triggers.
  Region rollups ride heartbeats into the coordinator's ``cluster top``
  QDEPTH/PRESS/SHED columns (metrics/collector.py harvests them).

- **ShedController** — the actuator: graduated degrade under sustained
  queue pressure, built as an EXTENSION of the SLO tuner's knob ladder
  (obs/tuner.py), not a parallel controller: level 1 drops the exact
  rerank stage (``rerank_factor`` -> 1), level 2 walks nprobe/ef DOWN
  the same {1,1.5}x-pow2 shape ladder one step per tick (every value it
  can choose is an already-warm program — degrading never recompiles),
  level 3 publishes an ADVISORY sq8 precision target (a tier flip
  re-encodes the store; the memory-tier ladder is the actor).
  Overrides land in ``VectorIndex.tuning`` — the same override path the
  tuner uses — and the ORIGINAL values are saved and restored as
  pressure clears, one level per tick in each direction (hysteresis).
  While a region is degraded the SLO tuner holds (it would tighten the
  very knobs pressure just relaxed).

The admission/expiry mechanics that FEED this plane live in
common/coalescer.py (the QoS layer grown out of the batching window);
the error types both layers speak are defined here.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS

_log = get_logger("obs.pressure")

#: request metadata keys. The deadline carries REMAINING milliseconds at
#: injection time (clock-skew safe); tenant key is configurable via
#: ``qos.tenant_header`` so deployments can reuse an existing auth header.
DEADLINE_METADATA_KEY = "x-dingo-deadline-ms"
PRIORITY_METADATA_KEY = "x-dingo-priority"
DEFAULT_TENANT_HEADER = "x-dingo-tenant"

#: priority semantics: higher = more important. 0 = batch/background
#: (shed first), 1 = default, >= 2 = interactive (never pressure-shed,
#: only hopeless-deadline shed applies).
DEFAULT_PRIORITY = 1

#: watermark bucket rotation: recent_watermark() = max queue wait over
#: the current + previous bucket (a 2-bucket rolling window needs no
#: reader-side reset, so the collector and the shed controller can both
#: read it without racing each other)
WATERMARK_BUCKET_S = 5.0


class QosRejected(RuntimeError):
    """Base for QoS admission rejections. NOT retried as a direct search
    by the service layer — a rejection under pressure that falls back to
    an unbatched search would defeat the whole admission decision."""


class DeadlineExceeded(QosRejected):
    """The request's budget was already spent (at admission or in queue)."""


class RequestShed(QosRejected):
    """Dropped by admission control under pressure (policy-dependent)."""


def qos_enabled() -> bool:
    try:
        return bool(FLAGS.get("qos_enabled"))
    except KeyError:
        return False


def shed_policy() -> str:
    """`qos.shed_policy`: 'off' (observe only), 'degrade' (knob ladder
    only), 'drop' (admission shed only), 'degrade_drop' (both)."""
    try:
        return str(FLAGS.get("qos_shed_policy"))
    except KeyError:
        return "degrade_drop"


def _policy_drops() -> bool:
    return shed_policy() in ("drop", "degrade_drop")


# ---------------------------------------------------------------------------
# Budget: the propagated deadline/tenant/priority triple
# ---------------------------------------------------------------------------

class Budget:
    """Per-request time budget. ``deadline`` is a host-local monotonic
    instant (never propagated raw — remaining ms is what crosses the
    wire). ``deadline_ms`` keeps the ORIGINAL grant so stage accounting
    can express spent time as a fraction of it."""

    __slots__ = ("deadline", "deadline_ms", "tenant", "priority", "t0")

    def __init__(self, deadline_ms: float, tenant: str = "default",
                 priority: int = DEFAULT_PRIORITY,
                 t0: Optional[float] = None):
        self.t0 = time.monotonic() if t0 is None else t0
        self.deadline_ms = float(deadline_ms)
        self.deadline = self.t0 + self.deadline_ms / 1000.0
        self.tenant = tenant or "default"
        self.priority = int(priority)

    def remaining_ms(self, now: Optional[float] = None) -> float:
        return (self.deadline - (now if now is not None
                                 else time.monotonic())) * 1000.0

    def expired(self, now: Optional[float] = None) -> bool:
        return self.remaining_ms(now) <= 0.0

    def elapsed_ms(self, now: Optional[float] = None) -> float:
        return ((now if now is not None else time.monotonic())
                - self.t0) * 1000.0

    def fraction_spent(self, ms: float) -> float:
        """`ms` as a percentage of the original grant (stage accounting)."""
        if self.deadline_ms <= 0:
            return 0.0
        return 100.0 * ms / self.deadline_ms

    def __repr__(self) -> str:
        return (f"Budget(remaining={self.remaining_ms():.1f}ms, "
                f"tenant={self.tenant!r}, priority={self.priority})")


_BUDGET: contextvars.ContextVar[Optional[Budget]] = contextvars.ContextVar(
    "dingo_torch_qos_budget", default=None
)


def current_budget() -> Optional[Budget]:
    return _BUDGET.get()


def attach_budget(budget: Optional[Budget]):
    """Make `budget` current; returns the token for detach_budget()."""
    return _BUDGET.set(budget)


def detach_budget(token) -> None:
    try:
        _BUDGET.reset(token)
    except ValueError:
        pass    # token minted in another thread/context (handoff)


@contextlib.contextmanager
def budget_scope(deadline_ms: float, tenant: str = "default",
                 priority: int = DEFAULT_PRIORITY):
    """Client-side scope: calls made inside carry this budget (the stub's
    egress injection reads the contextvar, mirroring trace injection)."""
    token = attach_budget(Budget(deadline_ms, tenant, priority))
    try:
        yield
    finally:
        detach_budget(token)


def tenant_header() -> str:
    try:
        return str(FLAGS.get("qos_tenant_header")) or DEFAULT_TENANT_HEADER
    except KeyError:
        return DEFAULT_TENANT_HEADER


def inject_budget_metadata(
    metadata: Optional[Sequence[Tuple[str, str]]] = None,
) -> Optional[List[Tuple[str, str]]]:
    """Append the current budget to outbound request metadata (remaining-ms
    form). Returns the input unchanged (possibly None) when no budget is
    attached — the no-QoS path must not allocate."""
    cur = _BUDGET.get()
    if cur is None:
        return list(metadata) if metadata is not None else None
    entries = [(DEADLINE_METADATA_KEY, f"{cur.remaining_ms():.3f}")]
    if cur.tenant != "default":
        entries.append((tenant_header(), cur.tenant))
    if cur.priority != DEFAULT_PRIORITY:
        entries.append((PRIORITY_METADATA_KEY, str(cur.priority)))
    return [*(metadata or ()), *entries]


def extract_budget_metadata(
    metadata: Optional[Iterable[Tuple[str, str]]],
) -> Optional[Budget]:
    """Parse the QoS headers out of invocation metadata into a Budget.
    Malformed values never fail the RPC (the trace-extract contract).
    With no deadline header: ``qos.enabled`` servers grant the configured
    ``qos.default_deadline_ms`` (0 = unbounded -> no budget); disabled
    servers return None unless a deadline header is present (pure
    propagation still works so a mid-upgrade fleet keeps the chain)."""
    deadline_ms: Optional[float] = None
    tenant = "default"
    priority = DEFAULT_PRIORITY
    thdr = tenant_header()
    for key, value in metadata or ():
        try:
            if key == DEADLINE_METADATA_KEY:
                deadline_ms = float(value)
            elif key == thdr:
                tenant = str(value) or "default"
            elif key == PRIORITY_METADATA_KEY:
                priority = int(value)
        except (TypeError, ValueError):
            continue
    if deadline_ms is None:
        if not qos_enabled():
            return None
        try:
            default_ms = float(FLAGS.get("qos_default_deadline_ms"))
        except KeyError:
            default_ms = 0.0
        if default_ms <= 0:
            return None
        deadline_ms = default_ms
    return Budget(deadline_ms, tenant, priority)


# ---------------------------------------------------------------------------
# PressurePlane: the qos.* sensor
# ---------------------------------------------------------------------------

class _RegionPressure:
    """Per-region aggregate the heartbeat rollup harvests. Counters are
    cumulative (the snapshot ships totals; the coordinator sees rates via
    successive beats); the queue-wait watermark is a 2-bucket rolling max
    so concurrent readers never need a reset."""

    __slots__ = ("queued_rows", "shed", "expired", "served",
                 "served_in_deadline", "deadline_exceeded",
                 "_wm_bucket", "_wm_cur", "_wm_prev")

    def __init__(self):
        self.queued_rows = 0
        self.shed = 0
        self.expired = 0
        self.served = 0
        self.served_in_deadline = 0
        self.deadline_exceeded = 0
        self._wm_bucket = 0
        self._wm_cur = 0.0
        self._wm_prev = 0.0

    def note_wait(self, wait_ms: float, now: float) -> None:
        b = int(now / WATERMARK_BUCKET_S)
        if b != self._wm_bucket:
            self._wm_prev = self._wm_cur if b == self._wm_bucket + 1 else 0.0
            self._wm_cur = 0.0
            self._wm_bucket = b
        if wait_ms > self._wm_cur:
            self._wm_cur = wait_ms

    def recent_watermark(self, now: float) -> float:
        b = int(now / WATERMARK_BUCKET_S)
        if b == self._wm_bucket:
            return max(self._wm_cur, self._wm_prev)
        if b == self._wm_bucket + 1:
            return self._wm_cur
        return 0.0


class PressurePlane:
    """Process-global pressure sensor (one per store, like METRICS)."""

    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        self._regions: Dict[int, _RegionPressure] = {}

    def _region(self, region_id: int) -> _RegionPressure:
        """Caller must hold self._lock — every _RegionPressure mutation
        happens under the plane lock (read-modify-write counters shared
        across request + flush threads)."""
        rp = self._regions.get(region_id)
        if rp is None:
            rp = self._regions[region_id] = _RegionPressure()
        return rp

    @staticmethod
    def _labels(budget: Optional[Budget]) -> Dict[str, str]:
        if budget is None:
            return {"tenant": "default", "priority": str(DEFAULT_PRIORITY)}
        return {"tenant": budget.tenant, "priority": str(budget.priority)}

    # -- queue lifecycle -----------------------------------------------------
    def on_admit(self, region_id: int, rows: int,
                 budget: Optional[Budget]) -> None:
        lab = self._labels(budget)
        self.registry.counter("qos.admitted", region_id=region_id).add(1)
        self.registry.counter("qos.demand_rows", labels=lab).add(rows)
        self.registry.gauge("qos.queue_depth", region_id=region_id,
                            labels=lab).add(rows)
        with self._lock:
            self._region(region_id).queued_rows += rows

    def on_dequeue(self, region_id: int, rows: int,
                   budget: Optional[Budget]) -> None:
        self.registry.gauge("qos.queue_depth", region_id=region_id,
                            labels=self._labels(budget)).add(-rows)
        with self._lock:
            rp = self._region(region_id)
            rp.queued_rows = max(0, rp.queued_rows - rows)

    def observe_wait(self, region_id: int, wait_ms: float,
                     budget: Optional[Budget]) -> None:
        self.registry.latency("qos.queue_wait", region_id=region_id
                              ).observe_us(wait_ms * 1000.0)
        with self._lock:
            self._region(region_id).note_wait(wait_ms, time.monotonic())

    # -- outcomes ------------------------------------------------------------
    def on_expired(self, where: str, region_id: int,
                   budget: Optional[Budget], n: int = 1) -> None:
        """`where` is 'admission' (rejected before any queueing) or
        'queue' (died waiting; dropped before dispatch)."""
        self.registry.counter(
            "qos.expired", region_id=region_id,
            labels={**self._labels(budget), "where": where},
        ).add(n)
        with self._lock:
            self._region(region_id).expired += n

    def on_shed(self, reason: str, region_id: int,
                budget: Optional[Budget], n: int = 1) -> None:
        """`reason`: 'pressure' (queue-wait bound), 'hopeless' (could not
        finish inside its own deadline), 'tenant_limit' (per-tenant
        queue-row cap)."""
        self.registry.counter(
            "qos.shed", region_id=region_id,
            labels={**self._labels(budget), "reason": reason},
        ).add(n)
        with self._lock:
            self._region(region_id).shed += n

    def on_served(self, region_id: int, budget: Optional[Budget],
                  elapsed_ms: Optional[float] = None) -> None:
        """Throughput vs goodput: every reply counts served; only replies
        inside their deadline count toward goodput. A reply that missed
        its deadline additionally black-boxes the moment (rate-limited)."""
        self.registry.counter("qos.served", region_id=region_id).add(1)
        if budget is not None and elapsed_ms is None:
            elapsed_ms = budget.elapsed_ms()
        in_deadline = budget is None or elapsed_ms <= budget.deadline_ms
        with self._lock:
            rp = self._region(region_id)
            rp.served += 1
            if in_deadline:
                rp.served_in_deadline += 1
            else:
                rp.deadline_exceeded += 1
        if in_deadline:
            self.registry.counter("qos.served_in_deadline",
                                  region_id=region_id).add(1)
        else:
            self.registry.counter("qos.deadline_exceeded",
                                  region_id=region_id).add(1)
            self._flight_deadline_exceeded(region_id, budget, elapsed_ms)

    def observe_stages(self, budget: Optional[Budget],
                       stages_ms: Dict[str, float]) -> None:
        """Per-stage time-budget accounting: each stage's share of the
        request's deadline, observed in PERCENT (the recorder's p50/p99
        then read as 'the kernel stage typically eats N% of the grant').
        Stages: queue / batch_form / kernel / rerank, plus dispatch on
        the pipelined path (the kernel-enqueue + staging cost the
        overlapped flush pays per batch — booked separately so it never
        inflates the kernel fraction the SLO tuner reads)."""
        if budget is None or budget.deadline_ms <= 0:
            return
        for stage, ms in stages_ms.items():
            if ms <= 0:
                continue
            self.registry.latency(
                "qos.stage_budget_pct", labels={"stage": stage}
            ).observe_us(budget.fraction_spent(ms))

    def _flight_deadline_exceeded(self, region_id: int, budget: Budget,
                                  elapsed_ms: float) -> None:
        """Deadline-exceeded flight bundle: carries the absolute qos.*
        family state (the recorder snapshots it like mesh/hnsw/quality).
        Rate-limited per reason by the recorder itself; never raises."""
        try:
            from dingo_tpu_torch.obs.flight import FLIGHT

            FLIGHT.trigger(
                "deadline_exceeded", region_id=region_id,
                extra={
                    "elapsed_ms": round(elapsed_ms, 1),
                    "deadline_ms": round(budget.deadline_ms, 1),
                    "tenant": budget.tenant,
                    "priority": budget.priority,
                },
            )
        except Exception:  # noqa: BLE001 — observability never fails serving
            pass

    # -- rollups -------------------------------------------------------------
    def region_stats(self, region_id: int) -> Dict[str, float]:
        """Heartbeat harvest (metrics/collector.py): queue depth, recent
        queue-wait watermark, cumulative shed+expired, goodput counters.
        Read-only — the watermark window rotates by itself."""
        with self._lock:
            rp = self._regions.get(region_id)
            if rp is None:
                return {"queue_depth": 0, "queue_wait_ms": 0.0,
                        "shed_total": 0, "served": 0,
                        "served_in_deadline": 0}
            return {
                "queue_depth": rp.queued_rows,
                "queue_wait_ms": rp.recent_watermark(time.monotonic()),
                "shed_total": rp.shed + rp.expired,
                "served": rp.served,
                "served_in_deadline": rp.served_in_deadline,
            }

    def queue_pressure_ms(self, region_id: int) -> float:
        """The shed controller's input: recent queue-wait watermark."""
        with self._lock:
            rp = self._regions.get(region_id)
            return rp.recent_watermark(time.monotonic()) if rp else 0.0

    def forget_region(self, region_id: int) -> None:
        with self._lock:
            self._regions.pop(region_id, None)

    def reset(self) -> None:
        """Test and benchmark isolation only."""
        with self._lock:
            self._regions.clear()


PRESSURE = PressurePlane()


def degrade_level(region_id: int) -> int:
    """Current shed-ladder degrade level for a region, read from the
    published ``qos.degrade_level`` gauge (the same value heartbeats and
    the SLO tuner consume) — 0 when no ShedController has run. Lets
    consumers outside the qos plane (e.g. the serving-edge cache's
    stale-rung policy) observe pressure without holding a ShedController
    reference."""
    from dingo_tpu_torch.common.metrics import METRICS

    try:
        return int(METRICS.gauge("qos.degrade_level", region_id).get())
    except (TypeError, ValueError):
        return 0


# ---------------------------------------------------------------------------
# ShedController: graduated degrade on the tuner's ladder
# ---------------------------------------------------------------------------

#: degrade ladder levels (cheap -> drastic); one level per tick each way
DEGRADE_NONE = 0
DEGRADE_DROP_RERANK = 1      # rerank_factor -> 1 (skip the exact stage)
DEGRADE_LOWER_PROBE = 2      # nprobe/ef one ladder step down per tick
DEGRADE_SQ8_ADVISORY = 3     # publish the precision target (never flips)

MAX_DEGRADE_LEVEL = DEGRADE_SQ8_ADVISORY


class ShedController:
    """Pressure actuator: walks each over-pressure region one degrade
    level per tick and restores one level per calm tick. Escalation uses
    the SAME knob model and shape ladder as the SLO tuner (every value a
    warm program), and every change goes through ``index.tuning`` so a
    request-pinned parameter still wins."""

    def __init__(self, node, plane: Optional[PressurePlane] = None,
                 tuner=None, crontab=None, tab_name: str = "qos_shed"):
        from dingo_tpu_torch.obs.tuner import SloTuner

        self.node = node
        self.plane = plane or PRESSURE
        self.tuner = tuner or SloTuner()
        #: owning CrontabManager (when crontab-wired): qos.shed_interval_s
        #: is hot-changeable, so each tick re-applies it to the tab (the
        #: QualityTunerRunner pattern)
        self._crontab = crontab
        self._tab_name = tab_name
        #: region -> degrade level
        self._level: Dict[int, int] = {}
        #: region -> {knob: original tuning value (None = was unset)}
        self._saved: Dict[int, Dict[str, Optional[int]]] = {}

    def degrade_level(self, region_id: int) -> int:
        return self._level.get(region_id, 0)

    # -- knob mechanics (the tuner's ladder, walked downward) ---------------
    def _save(self, region_id: int, knob: str, index) -> None:
        self._saved.setdefault(region_id, {}).setdefault(
            knob, index.tuning.get(knob)
        )

    def _apply_level(self, index, level: int) -> Optional[str]:
        """Apply ONE escalation step for `level`; returns a description
        (for the log/counter) or None when the level has no effect on
        this index kind (still counts as escalated — the next tick moves
        on)."""
        from dingo_tpu_torch.obs.tuner import ladder_step

        rid = index.id
        knobs = {k: (ladder, cur) for k, ladder, cur
                 in self.tuner._knobs(index)}
        if level == DEGRADE_DROP_RERANK:
            if "rerank_factor" not in knobs:
                return None
            _, cur = knobs["rerank_factor"]
            if cur <= 1:
                return None
            self._save(rid, "rerank_factor", index)
            index.tuning["rerank_factor"] = 1
            return f"rerank_factor {cur} -> 1"
        if level == DEGRADE_LOWER_PROBE:
            for knob in ("nprobe", "ef"):
                if knob not in knobs:
                    continue
                ladder, cur = knobs[knob]
                prev = ladder_step(ladder, cur, up=False)
                if prev is None:
                    return None
                self._save(rid, knob, index)
                index.tuning[knob] = int(prev)
                return f"{knob} {cur} -> {prev}"
            return None
        if level == DEGRADE_SQ8_ADVISORY:
            precision = getattr(index, "_precision", "fp32")
            if precision == "sq8":
                return None
            self.registry_gauge_advisory(rid, 1.0)
            return f"advisory precision {precision} -> sq8"
        return None

    def registry_gauge_advisory(self, region_id: int, v: float) -> None:
        self.plane.registry.gauge(
            "qos.precision_advisory", region_id=region_id
        ).set(v)

    def _restore(self, index) -> None:
        """Put every saved knob back (pressure cleared)."""
        saved = self._saved.pop(index.id, {})
        for knob, orig in saved.items():
            if orig is None:
                index.tuning.pop(knob, None)
            else:
                index.tuning[knob] = orig
        self.registry_gauge_advisory(index.id, 0.0)

    # -- the control step ----------------------------------------------------
    def step_region(self, region_id: int, index,
                    pressure_ms: float, max_queue_ms: float) -> int:
        """One tick for one region: escalate one level while the recent
        queue-wait watermark exceeds ``qos.max_queue_ms``, de-escalate
        one level once it falls below half of it (hysteresis band), hold
        in between. Returns the new degrade level."""
        from dingo_tpu_torch.obs.events import EVENTS

        level = self._level.get(region_id, 0)
        g = self.plane.registry.gauge
        if max_queue_ms > 0 and pressure_ms > max_queue_ms:
            if level < MAX_DEGRADE_LEVEL:
                level += 1
                desc = self._apply_level(index, level)
                self._level[region_id] = level
                EVENTS.emit(
                    "shed", region_id, "degrade_level", level - 1, level,
                    trigger="escalate",
                    evidence={"pressure_ms": round(pressure_ms, 2),
                              "max_queue_ms": max_queue_ms,
                              "step": desc or ""},
                )
                self.plane.registry.counter(
                    "qos.degrade_steps", region_id=region_id,
                    labels={"direction": "down"},
                ).add(1)
                if desc or level == DEGRADE_LOWER_PROBE:
                    # quality evidence gathered before the knob moved must
                    # not judge the degraded setting (the tuner's reset
                    # discipline)
                    self._reset_quality(region_id)
                _log.warning(
                    "shed region %d: pressure %.0fms > %.0fms, degrade "
                    "level %d (%s)", region_id, pressure_ms, max_queue_ms,
                    level, desc or "no-op for this index",
                )
            else:
                # at the ladder top but pressure persists: the graduated
                # walk continues — nprobe/ef keeps stepping down one warm
                # ladder rung per tick until its floor ("one step per
                # tick" outlives the level count; the floor ends it)
                desc = self._apply_level(index, DEGRADE_LOWER_PROBE)
                if desc:
                    EVENTS.emit(
                        "shed", region_id, "degrade_level", level, level,
                        trigger="escalate",
                        evidence={"pressure_ms": round(pressure_ms, 2),
                                  "max_queue_ms": max_queue_ms,
                                  "step": desc},
                    )
                    self.plane.registry.counter(
                        "qos.degrade_steps", region_id=region_id,
                        labels={"direction": "down"},
                    ).add(1)
                    self._reset_quality(region_id)
                    _log.warning(
                        "shed region %d: pressure %.0fms > %.0fms still, "
                        "degrade level %d (%s)", region_id, pressure_ms,
                        max_queue_ms, level, desc,
                    )
        elif level > 0 and pressure_ms < 0.5 * max_queue_ms:
            level -= 1
            if level == 0:
                self._restore(index)
                self._reset_quality(region_id)
            self._level[region_id] = level
            EVENTS.emit(
                "shed", region_id, "degrade_level", level + 1, level,
                trigger="restore" if level == 0 else "relax",
                evidence={"pressure_ms": round(pressure_ms, 2),
                          "max_queue_ms": max_queue_ms},
            )
            self.plane.registry.counter(
                "qos.degrade_steps", region_id=region_id,
                labels={"direction": "up"},
            ).add(1)
            _log.info("shed region %d: pressure cleared, degrade level %d",
                      region_id, level)
        g("qos.degrade_level", region_id=region_id).set(float(level))
        return level

    @staticmethod
    def _reset_quality(region_id: int) -> None:
        try:
            from dingo_tpu_torch.obs.quality import QUALITY

            QUALITY.reset_region(region_id)
        except Exception:  # noqa: BLE001
            pass

    def _restore_all(self) -> None:
        """The flags no longer permit degrading: a disabled actuator must
        not pin its overrides — put every degraded region back to its
        saved settings NOW (and zero the gauges, which the SLO tuner
        reads as 'hold while > 0')."""
        if not self._level and not self._saved:
            return
        by_id = {}
        if self.node is not None:
            for region in self.node.meta.get_all_regions():
                wrapper = region.vector_index_wrapper
                if wrapper is not None and wrapper.own_index is not None:
                    by_id[region.id] = wrapper.own_index
        from dingo_tpu_torch.obs.events import EVENTS

        for rid in set(self._level) | set(self._saved):
            index = by_id.get(rid)
            if index is not None:
                self._restore(index)        # pops _saved, zeroes advisory
            else:
                self._saved.pop(rid, None)  # region departed: just drop
                self.registry_gauge_advisory(rid, 0.0)
            EVENTS.emit(
                "shed", rid, "degrade_level",
                self._level.get(rid, 0), 0, trigger="disable",
                evidence={"reason": "shed policy flipped off"},
            )
            self._level.pop(rid, None)
            self.plane.registry.gauge(
                "qos.degrade_level", region_id=rid).set(0.0)
            self._reset_quality(rid)
            _log.info("shed region %d: degrading disabled, settings "
                      "restored", rid)

    def tick(self) -> int:
        """Crontab body (server/main.py ``qos_shed`` tab): hot-reads the
        flags per tick so operators can flip policy live; no-ops entirely
        unless ``qos.enabled`` and the policy includes 'degrade' — but a
        flip-to-off mid-incident still restores any degraded region
        first (overrides must never outlive the actuator)."""
        if self._crontab is not None:
            self._crontab.set_interval(
                self._tab_name, float(FLAGS.get("qos_shed_interval_s"))
            )
        try:
            max_queue_ms = float(FLAGS.get("qos_max_queue_ms"))
        except KeyError:
            max_queue_ms = 0.0
        if not qos_enabled() or max_queue_ms <= 0 \
                or shed_policy() not in ("degrade", "degrade_drop"):
            self._restore_all()
            return 0
        degraded = 0
        for region in self.node.meta.get_all_regions():
            wrapper = region.vector_index_wrapper
            if wrapper is None or not wrapper.is_ready():
                continue
            index = wrapper.own_index
            if index is None:
                continue
            pressure_ms = self.plane.queue_pressure_ms(region.id)
            if self.step_region(region.id, index, pressure_ms,
                                max_queue_ms) > 0:
                degraded += 1
        return degraded
