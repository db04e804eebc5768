"""Serving-pressure plane and QoS budget propagation: the admission half
of dingo_tpu/obs/pressure.py.

- **Budget**: the per-request deadline, tenant and priority. Inside a
  process it rides a contextvar (the coalescer captures it at submit and
  consults it on its flush thread); between processes it rides request
  metadata, where ``x-dingo-deadline-ms`` carries the remaining
  milliseconds, never an absolute time (clocks differ across hosts).
  Extraction never fails the request it rode in on.

- **PressurePlane** (``PRESSURE``): the ``qos.*`` metrics family. Demand
  and queue-depth per (region, tenant, priority), queue-wait recorders and
  a short-window watermark, per-stage time-budget accounting (queue,
  batch_form, dispatch, kernel, rerank as percentages of the request's
  deadline), goodput against throughput, shed and expired counters.

The admission and expiry mechanics that feed the plane live in
common/coalescer.py; the error types both speak are defined here. The
degrade ladder (ShedController, ``degrade_level``) and the plane's
flight-recorder bundle need the SLO tuner, events and quality planes and
are not ported yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.metrics import METRICS

#: metadata keys. The deadline carries REMAINING milliseconds at injection
#: time; the tenant key is configurable through ``qos_tenant_header``
DEADLINE_METADATA_KEY = "x-dingo-deadline-ms"
PRIORITY_METADATA_KEY = "x-dingo-priority"
DEFAULT_TENANT_HEADER = "x-dingo-tenant"

#: higher = more important. 0 = batch/background (shed first), 1 = default,
#: >= 2 = interactive (never pressure-shed, only hopeless-deadline shed)
DEFAULT_PRIORITY = 1

#: recent_watermark() = max queue wait over the current + previous bucket
#: (a 2-bucket rolling window needs no reader-side reset)
WATERMARK_BUCKET_S = 5.0


class QosRejected(RuntimeError):
    """Base of QoS admission rejections. Not to be retried as a direct
    search: that would serve exactly the work admission refused."""


class DeadlineExceeded(QosRejected):
    """The request's budget was already spent (at admission or in queue)."""


class RequestShed(QosRejected):
    """Dropped by admission control under pressure (policy-dependent)."""


def qos_enabled() -> bool:
    return bool(FLAGS.get("qos_enabled"))


def shed_policy() -> str:
    """`qos_shed_policy`: 'off' (observe only), 'degrade' (knob ladder
    only), 'drop' (admission shed only), 'degrade_drop' (both)."""
    return str(FLAGS.get("qos_shed_policy"))


def _policy_drops() -> bool:
    return shed_policy() in ("drop", "degrade_drop")


# ---------------------------------------------------------------------------
# Budget: the propagated deadline/tenant/priority triple
# ---------------------------------------------------------------------------

class Budget:
    """Per-request time budget. ``deadline`` is a host-local monotonic
    instant (only the remaining ms crosses the wire); ``deadline_ms`` keeps
    the original grant so stage accounting can express spent time as a
    fraction of it."""

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
        """`ms` as a percentage of the original grant."""
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
        pass    # token minted in another thread's context (a handoff)


@contextlib.contextmanager
def budget_scope(deadline_ms: float, tenant: str = "default",
                 priority: int = DEFAULT_PRIORITY):
    """Client-side scope: calls made inside carry this budget."""
    token = attach_budget(Budget(deadline_ms, tenant, priority))
    try:
        yield
    finally:
        detach_budget(token)


def tenant_header() -> str:
    return str(FLAGS.get("qos_tenant_header")) or DEFAULT_TENANT_HEADER


def inject_budget_metadata(
    metadata: Optional[Sequence[Tuple[str, str]]] = None,
) -> Optional[List[Tuple[str, str]]]:
    """Append the current budget to outbound metadata (remaining-ms form).
    Returns the input unchanged (possibly None) when no budget is
    attached."""
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
    """Parse the QoS headers out of request metadata into a Budget.
    Malformed values never fail the request. With no deadline header a
    ``qos_enabled`` server grants ``qos_default_deadline_ms`` (0 = no
    budget); a disabled one returns None unless a deadline header is
    present (propagation alone keeps the chain)."""
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
        default_ms = float(FLAGS.get("qos_default_deadline_ms"))
        if default_ms <= 0:
            return None
        deadline_ms = default_ms
    return Budget(deadline_ms, tenant, priority)


# ---------------------------------------------------------------------------
# PressurePlane: the qos.* sensor
# ---------------------------------------------------------------------------

class _RegionPressure:
    """Per-region aggregate. Counters are cumulative; the queue-wait
    watermark is a 2-bucket rolling max, so readers never reset it."""

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
    """Process-wide pressure sensor."""

    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        self._regions: Dict[int, _RegionPressure] = {}

    def _region(self, region_id: int) -> _RegionPressure:
        """Caller holds self._lock: every _RegionPressure change happens
        under it (request and flush threads share the counters)."""
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
        """`where` is 'admission' (rejected before queueing) or 'queue'
        (died waiting; dropped before dispatch)."""
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
        """Throughput against goodput: every reply counts served; only
        replies inside their deadline count toward goodput."""
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
        self.registry.counter(
            "qos.served_in_deadline" if in_deadline
            else "qos.deadline_exceeded", region_id=region_id).add(1)

    def observe_stages(self, budget: Optional[Budget],
                       stages_ms: Dict[str, float]) -> None:
        """Each stage's share of the request's deadline, observed in
        percent. Stages: queue, batch_form, kernel, rerank, plus dispatch
        on the pipelined path (booked apart so the enqueue cost never
        inflates the kernel fraction)."""
        if budget is None or budget.deadline_ms <= 0:
            return
        for stage, ms in stages_ms.items():
            if ms <= 0:
                continue
            self.registry.latency(
                "qos.stage_budget_pct", labels={"stage": stage}
            ).observe_us(budget.fraction_spent(ms))

    # -- rollups -------------------------------------------------------------
    def region_stats(self, region_id: int) -> Dict[str, float]:
        """Queue depth, recent queue-wait watermark, cumulative
        shed+expired and goodput counters of a region."""
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

    def reset(self) -> None:
        """Test and benchmark isolation."""
        with self._lock:
            self._regions.clear()


PRESSURE = PressurePlane()
