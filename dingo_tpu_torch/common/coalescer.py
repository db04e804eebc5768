"""Search request coalescing and QoS admission (port of
dingo_tpu/common/coalescer.py).

A coalescer queues requests for the same key (region, topk, search
parameters) inside a small time window and launches one batch; each
caller gets its rows back. On the card one [64, d] scan costs little more
than one [1, d] scan, so filling the batch dimension is the gain.

QoS (``qos_enabled``; obs/pressure.py holds the plane and the errors): the
queue in front of the kernel is the only place admission can act.

- **admission**: a request whose budget is already spent is rejected
  before it queues (its future carries ``DeadlineExceeded``; no kernel is
  launched for it). Under pressure (estimated wait beyond
  ``qos_max_queue_ms``) low-priority work is shed, and a request that
  could not finish inside its own remaining budget is shed as hopeless. A
  per-tenant queued-row cap (``qos_tenant_queue_rows``) bounds one
  tenant's share of the queue.
- **priority batch forming**: entries dispatch highest-priority-first
  inside a batch, and the full-batch threshold sits on the pow2 pad
  ladder, so a full batch is exactly a warm shape (the launch sentinel,
  obs/sentinel.py, counts a shape off the ladder).
- **expiry before dispatch**: entries whose deadline passed while queued
  (or whose remaining budget cannot cover the estimated run) fail at flush
  time and leave the stacked batch; a batch of only dead entries launches
  nothing.
- **accounting**: queue wait, per-stage budget fractions, demand and
  shed/expired counters land in the ``qos.*`` family through PRESSURE.

With ``qos_enabled`` off, submit takes the plain path (one flag read).

Tracing: each submit opens a ``coalesce.wait`` span as a child of the
caller's current span; the batch run opens ``coalesce.run`` parented to
the first sampled waiter and attaches it on the flush thread, so the
device-side spans nest into that caller's trace. The budget makes the same
handoff: captured from the contextvar at submit, carried on the entry,
consulted on the flush thread.

Shutdown contract: ``submit()`` never raises and never hangs; every future
it returns resolves. The admitted-or-stopped decision is made under the
queue lock at append time, so a submit racing ``stop(drain=False)`` gets a
``CoalescerStopped`` future instead of slipping into a queue nobody will
flush.

Pipelined arm (``pipeline_enabled``, common/pipeline.py): with a
``dispatch_fn`` and the flag on ("auto" = on for a CUDA device), the flush
loop splits dispatch from resolve. Every due batch is dispatched first
(kernels launched, no host sync: ``dispatch_fn`` returns a resolve thunk),
so one key's kernels overlap another's fetch; the thunks then resolve FIFO
on a CompletionLane thread. Query staging (pad + upload) goes through a
per-key StagingRing of ``pipeline_depth`` pinned slots. Expiry runs inside
``_dispatch``, i.e. at the real dispatch time. Stage totals book the
enqueue cost under ``dispatch``. stop(drain=True) resolves queued
handoffs; stop(drain=False) abandons them (futures fail fast, the fetch
still runs so device-side search leases are released).

The wait estimate prices the rows ahead with the per-shape cost model
(obs/cost.py) once a key's kernel has been measured, with the per-row
EWMA of measured runs otherwise, and before any run with the
``cost_prior_row_ms`` prior (never 0, so a cold region's first overload
burst sheds). The JAX package's in-flight dedupe and edge-cache hooks are
not ported yet: every row of a batch is dispatched.
"""

from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from dingo_tpu_torch.common.config import (
    FLAGS,
    pipeline_depth,
    serving_pipeline_enabled,
)
from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.common.pipeline import CompletionLane, KeyedStaging
from dingo_tpu_torch.obs import cost as _cost
from dingo_tpu_torch.obs import pressure as qp
from dingo_tpu_torch.obs.pressure import PRESSURE
from dingo_tpu_torch.trace import NOOP_SPAN, TRACER


class CoalescerStopped(RuntimeError):
    """Set on futures whose batch was discarded by stop(drain=False) or
    that arrived after (or concurrently with) stop()."""


#: an entry whose remaining budget cannot cover ~2x the estimated batch
#: run would expire mid-flight more often than not
_EXPIRY_RUN_MARGIN = 2.0


def _prev_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class _Entry:
    """One submit: its queries plus everything the flush thread needs."""

    __slots__ = ("queries", "future", "wait_span", "budget", "priority",
                 "tenant", "region_id", "t0", "qos")

    def __init__(self, queries, future, wait_span, budget, region_id,
                 qos=False):
        self.queries = queries
        self.future = future
        self.wait_span = wait_span
        self.budget = budget
        self.priority = budget.priority if budget is not None else 1
        self.tenant = budget.tenant if budget is not None else "default"
        self.region_id = region_id
        self.t0 = time.monotonic()
        #: admitted under QoS accounting: dequeue and row release mirror
        #: the admit-side bookkeeping even if the flag flips mid-flight
        self.qos = qos


class _PendingBatch:
    __slots__ = ("entries", "created")

    def __init__(self):
        self.entries: List[_Entry] = []
        self.created = time.monotonic()

    def rows(self) -> int:
        return sum(len(e.queries) for e in self.entries)


class SearchCoalescer:
    """Batches `search(queries) -> per-query results` calls per key.

    run_fn(key, queries[batch, d]) returns a list of per-query result
    rows; callers receive exactly their rows. run_fn may take a
    ``stage_us`` dict kwarg: the coalescer then reads the kernel and
    rerank split out of it for the per-stage budget accounting. A batch
    flushes when the window expires or it reaches max_batch. One daemon
    timer thread serves all keys, sleeping until the earliest pending
    deadline; a caller whose own submission fills a batch runs that batch
    inline, while a cap-displaced previous batch flushes on its own thread
    (QoS mode: on the timer thread), so the new caller never pays for a
    search it is not part of.

    ``device`` is the device the batches run on (None = CUDA; raises
    DeviceUnavailable without one): it decides ``pipeline_enabled``'s
    "auto" and where the staging rings upload.
    """

    def __init__(self, run_fn: Callable[[Any, np.ndarray], Sequence],
                 window_ms: float = 2.0, max_batch: int = 256,
                 dispatch_fn: Optional[Callable] = None, device=None):
        self.run_fn = run_fn
        self.dispatch_fn = dispatch_fn
        self.device = resolve_device(device)
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        try:
            self._run_takes_stages = "stage_us" in inspect.signature(
                run_fn).parameters
        except (TypeError, ValueError):
            self._run_takes_stages = False
        self._dispatch_params = frozenset()
        if dispatch_fn is not None:
            try:
                self._dispatch_params = frozenset(
                    inspect.signature(dispatch_fn).parameters)
            except (TypeError, ValueError):
                pass
        # pipelined state: the lane thread starts on the first handoff;
        # staging rings are made per key on first use
        self._lane = CompletionLane()
        self._staging: Optional[KeyedStaging] = None
        #: cumulative per-stage wall time (ms) across pipelined flushes
        self.stage_totals_ms: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._pending: Dict[Any, _PendingBatch] = {}
        #: cap-displaced batches awaiting the timer thread (QoS mode): one
        #: dispatcher keeps the service-rate estimate honest
        self._ready: List = []
        #: queued query rows per tenant (admission cap bookkeeping)
        self._tenant_rows: Dict[str, int] = {}
        #: EWMA of per-row service time and per-batch run time (0 until
        #: the first measured run)
        self._ewma_row_ms = 0.0
        self._ewma_run_ms = 0.0
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(
            target=self._flush_loop, name="search-coalescer", daemon=True
        )
        self._thread.start()

    # -- QoS helpers ---------------------------------------------------------
    def _queued_rows(self) -> int:
        # both queues: window-pending batches and cap-displaced ones
        # awaiting the timer thread (under overload most of the wait
        # sits in the second)
        return (sum(b.rows() for b in self._pending.values())
                + sum(b.rows() for _, b in self._ready))

    def estimated_wait_ms(self, extra_rows: int = 0,
                          key: Any = None) -> float:
        """Admission estimate: the rows ahead priced by the per-shape cost
        model (obs/cost.py) when this key's kernel has been measured, by
        the per-row EWMA otherwise, plus one batch run. Before any sample
        it is the ``cost_prior_row_ms`` prior, never 0. With the cost
        model off and nothing measured it is 0."""
        with self._lock:
            rows = self._queued_rows()
        total = rows + extra_rows
        if _cost.cost_enabled():
            kid = _cost.kernel_id(key) if key is not None else None
            if _cost.COST.has_model(kid):
                return (_cost.COST.estimate_run_ms(kid, total)
                        + self._ewma_run_ms)
            if self._ewma_row_ms <= 0:
                return total * _cost.prior_row_ms()
        if self._ewma_row_ms <= 0:
            return 0.0
        return total * self._ewma_row_ms + self._ewma_run_ms

    def _est_run_ms(self, rows: int, key: Any = None) -> float:
        """Expected run time of a batch of `rows`: the key's measured
        per-shape surface when the cost model has one; else the per-batch
        EWMA floor, scaled up by the per-row cost for batches larger than
        recent history."""
        if key is not None and _cost.cost_enabled():
            kid = _cost.kernel_id(key)
            if _cost.COST.has_model(kid):
                return _cost.COST.estimate_run_ms(kid, rows)
        if self._ewma_row_ms <= 0:
            return self._ewma_run_ms
        return max(self._ewma_run_ms, rows * self._ewma_row_ms)

    def _note_run(self, rows: int, run_ms: float, key: Any = None) -> None:
        if rows <= 0 or run_ms <= 0:
            return
        row_ms = run_ms / rows
        a = 0.3
        self._ewma_row_ms = (row_ms if self._ewma_row_ms == 0
                             else a * row_ms + (1 - a) * self._ewma_row_ms)
        self._ewma_run_ms = (run_ms if self._ewma_run_ms == 0
                             else a * run_ms + (1 - a) * self._ewma_run_ms)
        if key is not None:
            _cost.COST.note(_cost.kernel_id(key), rows, run_ms,
                            region_id=_cost.kernel_region(key))

    def _admission_reject(self, budget, n_rows: int, region_id: int,
                          key: Any = None):
        """QoS admission decision for one submit: an exception to set on
        the future (already counted), or None = admit. Called outside the
        queue lock; only estimates are read here."""
        if budget is not None and budget.expired():
            PRESSURE.on_expired("admission", region_id, budget)
            return qp.DeadlineExceeded(
                f"deadline exceeded at admission "
                f"({-budget.remaining_ms():.1f}ms past)"
            )
        if not qp._policy_drops():
            return None
        tenant_cap = int(FLAGS.get("qos_tenant_queue_rows"))
        if tenant_cap > 0 and budget is not None:
            with self._lock:
                queued = self._tenant_rows.get(budget.tenant, 0)
            if queued + n_rows > tenant_cap:
                PRESSURE.on_shed("tenant_limit", region_id, budget)
                return qp.RequestShed(
                    f"tenant {budget.tenant} over queue cap "
                    f"({queued}+{n_rows} > {tenant_cap} rows)"
                )
        est_ms = self.estimated_wait_ms(extra_rows=n_rows, key=key)
        if budget is not None and budget.deadline_ms > 0 \
                and est_ms > budget.remaining_ms():
            # hopeless: it would expire in queue, and serving it late only
            # burns capacity an in-deadline request needs
            PRESSURE.on_shed("hopeless", region_id, budget)
            return qp.RequestShed(
                f"estimated wait {est_ms:.0f}ms exceeds remaining "
                f"budget {budget.remaining_ms():.0f}ms"
            )
        max_queue_ms = float(FLAGS.get("qos_max_queue_ms"))
        if max_queue_ms > 0:
            # batch/background (0) sheds at half the bound, default (1) at
            # the bound, interactive (>= 2) never pressure-sheds
            prio = budget.priority if budget is not None else 1
            allowed = (0.5 * max_queue_ms if prio <= 0
                       else max_queue_ms if prio == 1
                       else float("inf"))
            if est_ms > allowed:
                PRESSURE.on_shed("pressure", region_id, budget)
                return qp.RequestShed(
                    f"queue pressure {est_ms:.0f}ms over bound "
                    f"{allowed:.0f}ms (priority {prio})"
                )
        return None

    # -- submission ----------------------------------------------------------
    def submit(self, key: Any, queries: np.ndarray,
               max_batch: int = 0, region_id: int = 0) -> Future:
        """Queue queries [n, d] under key; resolves to n result rows.
        max_batch (0 = the coalescer default) caps the stacked row count
        for this key, so merging never builds a batch that would trip a
        limit each request respects alone.

        Never raises, never hangs: admission rejections (DeadlineExceeded,
        RequestShed), shutdown (CoalescerStopped) and run errors all
        resolve the returned future."""
        cap = min(self.max_batch, max_batch or self.max_batch)
        fut: Future = Future()
        wait_span = TRACER.start_span("coalesce.wait")
        qos = qp.qos_enabled()
        budget = qp.current_budget() if qos else None
        if qos:
            rejection = self._admission_reject(budget, len(queries),
                                               region_id, key=key)
            if rejection is not None:
                wait_span.end()
                fut.set_exception(rejection)
                return fut
            # a full-ladder batch pads to itself: flushing at a pow2 row
            # count hands the kernel an exactly-warm shape
            cap = _prev_pow2(cap)
        entry = _Entry(np.asarray(queries), fut, wait_span, budget,
                       region_id, qos=qos)
        flush_now = None
        flush_first = None
        with self._lock:
            if self._stop:
                # the stopped check and the append are one decision
                wait_span.end()
                fut.set_exception(CoalescerStopped("coalescer stopped"))
                return fut
            batch = self._pending.get(key)
            if batch is not None and batch.rows() + len(queries) > cap:
                # adding would exceed the cap: flush the queued batch
                # elsewhere and start fresh for this request. QoS mode
                # hands it to the timer thread's ready queue (one
                # dispatcher, expiry checked when it really runs); plain
                # mode gives it a thread of its own
                displaced = self._pending.pop(key)
                if qos:
                    self._ready.append((key, displaced))
                    displaced = None
                flush_first = displaced
                batch = None
            if batch is None:
                batch = self._pending[key] = _PendingBatch()
            batch.entries.append(entry)
            if qos:
                self._tenant_rows[entry.tenant] = (
                    self._tenant_rows.get(entry.tenant, 0) + len(queries)
                )
                # inside the queue lock: a flush pops this batch under the
                # same lock, so on_dequeue never precedes its on_admit
                PRESSURE.on_admit(region_id, len(queries), budget)
            if batch.rows() >= cap:
                flush_now = self._pending.pop(key)
        if flush_first is not None:
            threading.Thread(
                target=self._run, args=(key, flush_first),
                name="coalescer-flush", daemon=True,
            ).start()
        self._wake.set()
        if flush_now is not None:
            # the caller's own batch is full: run it inline
            self._run(key, flush_now)
        return fut

    # -- flushing ------------------------------------------------------------
    def _release_rows(self, entries: List[_Entry]) -> None:
        with self._lock:
            for e in entries:
                if not e.qos:
                    continue
                left = self._tenant_rows.get(e.tenant, 0) - len(e.queries)
                if left > 0:
                    self._tenant_rows[e.tenant] = left
                else:
                    self._tenant_rows.pop(e.tenant, None)

    def _expire_dead(self, entries: List[_Entry], region_id: int,
                     now: float, key: Any = None) -> List[_Entry]:
        """Expiry before dispatch: fail entries that died in queue (or
        whose remaining budget cannot cover the estimated run) and return
        the survivors."""
        # pure expiry (the deadline contract) always applies; the
        # hopeless arm is a drop and obeys the admission policy gate
        drops = qp._policy_drops()
        rows = sum(len(e.queries) for e in entries)
        est_run = _EXPIRY_RUN_MARGIN * self._est_run_ms(rows, key=key)
        live: List[_Entry] = []
        for e in entries:
            if e.budget is None or e.budget.deadline_ms <= 0:
                live.append(e)
                continue
            remaining = e.budget.remaining_ms(now)
            if remaining <= 0:
                PRESSURE.on_expired("queue", region_id, e.budget)
                e.future.set_exception(qp.DeadlineExceeded(
                    f"expired in queue ({-remaining:.1f}ms past deadline)"
                ))
            elif drops and est_run > 0 and remaining < est_run:
                PRESSURE.on_shed("hopeless", region_id, e.budget)
                e.future.set_exception(qp.RequestShed(
                    f"remaining {remaining:.0f}ms cannot cover the "
                    f"~{est_run:.0f}ms batch run"
                ))
            else:
                live.append(e)
        return live

    def _begin_flush(self, batch: _PendingBatch, flush_t0: float,
                     key: Any = None):
        """Shared flush prologue of both arms: end the queue-wait spans,
        mirror the QoS dequeue accounting, expire dead entries (at the
        real dispatch time, cap-displaced batches included), sort the
        survivors by priority and open the run span parented to the first
        sampled waiter. Returns (entries, run_span, waits_ms, qos); empty
        entries mean everything expired (no kernel may launch)."""
        qos = qp.qos_enabled()
        entries = batch.entries
        region_id = entries[0].region_id if entries else 0
        run_span = NOOP_SPAN
        links = []
        waits_ms: Dict[int, float] = {}
        for e in entries:
            e.wait_span.end()
            waits_ms[id(e)] = (flush_t0 - e.t0) * 1000.0
            if e.wait_span.sampled:
                if run_span is NOOP_SPAN:
                    run_span = TRACER.start_span(
                        "coalesce.run", parent=e.wait_span.context
                    )
                else:
                    links.append(f"{e.wait_span.trace_id:016x}")
        if any(e.qos for e in entries):
            self._release_rows(entries)
            for e in entries:
                if not e.qos:
                    continue
                PRESSURE.on_dequeue(e.region_id, len(e.queries), e.budget)
                PRESSURE.observe_wait(e.region_id, waits_ms[id(e)],
                                      e.budget)
        if qos:
            entries = self._expire_dead(entries, region_id, flush_t0,
                                        key=key)
            if not entries:
                if run_span is not NOOP_SPAN:
                    run_span.set_attr("all_expired", True)
                    run_span.end()
                return [], NOOP_SPAN, waits_ms, qos
            # highest priority first (stable); result slicing follows
            entries = sorted(entries, key=lambda e: -e.priority)
        if run_span is not NOOP_SPAN:
            run_span.set_attr("batch_size",
                              sum(len(e.queries) for e in entries))
            run_span.set_attr("requests", len(entries))
            run_span.set_attr(
                "queue_wait_us",
                int((flush_t0 - batch.created) * 1e6),
            )
            if links:
                run_span.set_attr("cobatched_traces", links)
        return entries, run_span, waits_ms, qos

    @staticmethod
    def _fan_out(entries: List[_Entry], results) -> None:
        """Resolve every entry's future with its contiguous slice."""
        off = 0
        for e in entries:
            n = len(e.queries)
            e.future.set_result(list(results[off:off + n]))
            off += n

    def _note_stage_totals(self, **stages_ms) -> None:
        with self._lock:
            for name, ms in stages_ms.items():
                if ms > 0:
                    self.stage_totals_ms[name] = (
                        self.stage_totals_ms.get(name, 0.0) + ms)

    def stage_totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.stage_totals_ms)

    def _pipelined(self) -> bool:
        return self.dispatch_fn is not None \
            and serving_pipeline_enabled(self.device)

    def _run(self, key: Any, batch: _PendingBatch) -> None:
        """Serial arm: run one batch to its results on this thread."""
        flush_t0 = time.monotonic()
        entries, run_span, waits_ms, qos = self._begin_flush(batch,
                                                             flush_t0, key)
        if not entries:
            return
        token = run_span.attach()
        stage_us: Optional[Dict[str, int]] = (
            {} if (qos and self._run_takes_stages) else None
        )
        try:
            stacked = np.concatenate([e.queries for e in entries], axis=0)
            form_ms = (time.monotonic() - flush_t0) * 1000.0
            run_t0 = time.monotonic()
            if stage_us is not None:
                results = self.run_fn(key, stacked, stage_us=stage_us)
            else:
                results = self.run_fn(key, stacked)
            run_ms = (time.monotonic() - run_t0) * 1000.0
            self._note_run(len(stacked), run_ms, key=key)
            self._fan_out(entries, results)
            if qos:
                self._account_stages(entries, waits_ms, form_ms, run_ms,
                                     stage_us)
        except Exception as exc:  # noqa: BLE001 — the waiters get it
            run_span.set_error(exc)
            for e in entries:
                if not e.future.done():
                    e.future.set_exception(exc)
        finally:
            run_span.detach(token)
            run_span.end()

    @staticmethod
    def _split_stages(stage_us, run_ms: float):
        """(kernel_ms, rerank_ms) of a run: from the reader's stage_us
        when the callback filled it (search_us = the scan, postfilter +
        backfill = the rerank tail), else the whole run as kernel."""
        if stage_us:
            k = stage_us.get("search_us", 0) / 1000.0
            r = (stage_us.get("postfilter_us", 0)
                 + stage_us.get("backfill_us", 0)) / 1000.0
            if k > 0:
                return k, min(r, max(0.0, run_ms - k))
        return run_ms, 0.0

    @classmethod
    def _account_stages(cls, entries, waits_ms, form_ms, run_ms, stage_us,
                        dispatch_ms: Optional[float] = None):
        """Per-stage time-budget accounting: queue, batch_form, kernel and
        rerank (plus dispatch on the pipelined path, where the flush
        thread rather than the device was the bottleneck) as fractions of
        each entry's deadline."""
        kernel_ms, rerank_ms = cls._split_stages(stage_us, run_ms)
        for e in entries:
            if e.budget is None:
                continue
            stages = {
                "queue": waits_ms.get(id(e), 0.0),
                "batch_form": form_ms,
                "kernel": kernel_ms,
                "rerank": rerank_ms,
            }
            if dispatch_ms is not None:
                stages["dispatch"] = dispatch_ms
            PRESSURE.observe_stages(e.budget, stages)

    # -- pipelined arm -------------------------------------------------------
    def _dispatch(self, key: Any, batch: _PendingBatch):
        """Dispatch one due batch without resolving it: stage the stacked
        queries (a reused pinned slot, its upload started here), call
        dispatch_fn for the resolve thunk and return a _Handoff for the
        completion lane. None when the batch fully expired or dispatch
        failed (futures are resolved either way). Runs on the flush
        thread and never waits on the device; the pipelined path's one
        wait per reply is in _Handoff.resolve() on the lane thread."""
        flush_t0 = time.monotonic()
        entries, run_span, waits_ms, qos = self._begin_flush(batch,
                                                             flush_t0, key)
        if not entries:
            return None
        token = run_span.attach()
        staged = None
        stage_us: Optional[Dict[str, int]] = (
            {} if "stage_us" in self._dispatch_params else None
        )
        try:
            stacked = np.concatenate([e.queries for e in entries], axis=0)
            if "staged" in self._dispatch_params:
                if self._staging is None:
                    self._staging = KeyedStaging(pipeline_depth(),
                                                 self.device)
                staged = self._staging.ring(key).stage(stacked)
            form_ms = (time.monotonic() - flush_t0) * 1000.0
            dispatch_t0 = time.monotonic()
            kw: Dict[str, Any] = {}
            if staged is not None:
                kw["staged"] = staged
            if stage_us is not None:
                kw["stage_us"] = stage_us
            thunk = self.dispatch_fn(key, stacked, **kw)
            dispatch_ms = (time.monotonic() - dispatch_t0) * 1000.0
            self._note_stage_totals(batch_form=form_ms,
                                    dispatch=dispatch_ms)
            run_span.detach(token)
            return _Handoff(self, entries, waits_ms, form_ms, dispatch_ms,
                            run_span, staged, thunk, stage_us, qos,
                            len(stacked), key)
        except Exception as exc:  # noqa: BLE001 — the waiters get it
            run_span.set_error(exc)
            run_span.detach(token)
            run_span.end()
            if staged is not None:
                # the upload may still be in flight: the ring waits on the
                # slot's copy event before it writes the slot again
                staged.release()
            for e in entries:
                if not e.future.done():
                    e.future.set_exception(exc)
            return None

    def _flush_loop(self) -> None:
        timeout = None   # nothing pending: sleep until a submit wakes us
        while True:
            # wait until the earliest pending batch's deadline
            self._wake.wait(timeout=timeout)
            self._wake.clear()
            if self._stop:
                return
            now = time.monotonic()
            timeout = None
            with self._lock:
                # QoS-displaced batches first: they are older than
                # anything still inside its window
                due = self._ready
                self._ready = []
                for key in list(self._pending):
                    age = now - self._pending[key].created
                    if age >= self.window_s:
                        due.append((key, self._pending.pop(key)))
                    else:
                        remain = self.window_s - age
                        timeout = remain if timeout is None else min(
                            timeout, remain)
            # several keys due in one sweep: the most important first
            due.sort(key=lambda kb: -max(
                (e.priority for e in kb[1].entries), default=0
            ))
            if self._pipelined():
                # every due batch's kernels launch before any resolve
                # runs; the lane resolves the thunks FIFO
                handoffs = []
                for key, batch in due:
                    h = self._dispatch(key, batch)
                    if h is not None:
                        handoffs.append(h)
                for h in handoffs:
                    if not self._lane.submit(h):
                        # lane already stopped (stop racing a flush):
                        # resolve inline, the futures must still settle
                        h.resolve()
            else:
                for key, batch in due:
                    self._run(key, batch)

    def stop(self, drain: bool = True) -> None:
        """Shut down. drain=True runs pending batches to completion;
        drain=False fails their futures with CoalescerStopped. Either way
        every pending future resolves."""
        with self._lock:
            self._stop = True
            leftovers = self._ready + list(self._pending.items())
            self._ready = []
            self._pending.clear()
            self._tenant_rows.clear()
        self._wake.set()
        for key, batch in leftovers:
            if drain:
                self._run(key, batch)
            else:
                exc = CoalescerStopped("coalescer stopped before flush")
                for e in batch.entries:
                    e.wait_span.end()
                    if e.qos:
                        # mirror the flush's dequeue accounting: no
                        # phantom queue depth
                        PRESSURE.on_dequeue(e.region_id, len(e.queries),
                                            e.budget)
                    if not e.future.done():
                        e.future.set_exception(exc)
        # the lane honours the same contract: drain resolves queued
        # handoffs, no-drain abandons them (the fetch still runs)
        self._lane.stop(drain=drain)
        if self._staging is not None:
            self._staging.close()
        self._thread.join(timeout=2)


class _Handoff:
    """One dispatched-but-unresolved batch riding the completion lane.

    ``resolve()`` is the pipelined path's one host wait per reply: it runs
    the dispatch_fn's thunk, slices the results to the waiters' futures,
    closes the accounting the dispatch half opened and releases the
    staging slot. ``abandon()`` is the stop(drain=False) arm: the futures
    fail with CoalescerStopped, but the thunk still runs, because the
    dispatch acquired device-side search leases that only its fetch
    releases."""

    __slots__ = ("coalescer", "entries", "waits_ms", "form_ms",
                 "dispatch_ms", "run_span", "staged", "thunk", "stage_us",
                 "qos", "rows", "key")

    def __init__(self, coalescer, entries, waits_ms, form_ms, dispatch_ms,
                 run_span, staged, thunk, stage_us, qos, rows, key=None):
        self.key = key
        self.coalescer = coalescer
        self.entries = entries
        self.waits_ms = waits_ms
        self.form_ms = form_ms
        self.dispatch_ms = dispatch_ms
        self.run_span = run_span
        self.staged = staged
        self.thunk = thunk
        self.stage_us = stage_us
        self.qos = qos
        self.rows = rows

    def resolve(self) -> None:
        c = self.coalescer
        token = self.run_span.attach()
        t0 = time.monotonic()
        try:
            results = self.thunk()
            resolve_ms = (time.monotonic() - t0) * 1000.0
            c._note_run(self.rows, self.dispatch_ms + resolve_ms,
                        key=self.key)
            kernel_ms, rerank_ms = c._split_stages(self.stage_us,
                                                   resolve_ms)
            c._note_stage_totals(kernel=kernel_ms, rerank=rerank_ms,
                                 resolve=resolve_ms)
            c._fan_out(self.entries, results)
            if self.qos:
                c._account_stages(self.entries, self.waits_ms,
                                  self.form_ms, resolve_ms, self.stage_us,
                                  dispatch_ms=self.dispatch_ms)
        except Exception as exc:  # noqa: BLE001 — the waiters get it
            self.run_span.set_error(exc)
            for e in self.entries:
                if not e.future.done():
                    e.future.set_exception(exc)
        finally:
            self.run_span.detach(token)
            self.run_span.end()
            if self.staged is not None:
                self.staged.release()

    def abandon(self) -> None:
        exc = CoalescerStopped("coalescer stopped before resolve")
        for e in self.entries:
            if not e.future.done():
                e.future.set_exception(exc)
        try:
            # run the fetch anyway: it releases the search leases
            self.thunk()
        except Exception:  # noqa: BLE001 — the futures already failed
            pass
        finally:
            self.run_span.end()
            if self.staged is not None:
                self.staged.release()
