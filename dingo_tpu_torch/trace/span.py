"""Span / SpanContext / Tracer: the in-process tracing core (port of
dingo_tpu/trace/span.py).

A Span is one timed operation; SpanContext is the (trace_id, span_id,
sampled) triple that links spans into a tree and rides request metadata
between processes. Inside a process a contextvar propagates the current
span, so spans nest across the coalescer's thread handoffs as long as the
handoff side attaches the captured context (see common/coalescer.py).

Sampling is head-based and decided once at the root: an unsampled root
returns the shared NOOP_SPAN and every descendant site sees it through
the contextvar and short-circuits: one check, no allocation per site.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.trace.buffer import TRACE_BUFFER

#: metadata key carrying "trace_id-span_id-flags" (hex-hex-int)
TRACE_METADATA_KEY = "x-dingo-trace"

_log = get_logger("trace")

_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "dingo_torch_trace_span", default=None
)


def _gen_id() -> int:
    """Non-zero 63-bit random id (0 is the 'no parent' sentinel)."""
    return (int.from_bytes(os.urandom(8), "big") >> 1) or 1


class SpanContext:
    """The propagated identity of a span: what children and remote hops
    need to link to it. Immutable by convention."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self) -> str:
        return (f"SpanContext({self.trace_id:016x}, {self.span_id:016x}, "
                f"sampled={self.sampled})")


class Span:
    """A recording span. Use as a context manager for same-thread scopes;
    for cross-thread lifetimes create it, hand it off, and call end()."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "attrs", "status", "thread_id", "_tracer",
                 "_token")

    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: int = 0):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _gen_id()
        self.parent_id = parent_id
        self.start_ns = time.perf_counter_ns()
        self.end_ns = 0
        self.attrs: Dict[str, Any] = {}
        self.status = "ok"
        self.thread_id = threading.get_ident()
        self._tracer = tracer
        self._token = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def set_error(self, exc: BaseException) -> "Span":
        self.status = f"error: {type(exc).__name__}"
        return self

    # -- contextvar scope ----------------------------------------------------
    def attach(self):
        """Make this span the current one; returns a token for detach()."""
        return _CURRENT.set(self)

    def detach(self, token) -> None:
        try:
            _CURRENT.reset(token)
        except ValueError:
            # token minted in another thread's context (a handoff); that
            # context is gone with its thread, nothing to restore
            pass

    def __enter__(self) -> "Span":
        self._token = self.attach()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.set_error(exc)
        if self._token is not None:
            self.detach(self._token)
            self._token = None
        self.end()
        return False

    # -- completion ----------------------------------------------------------
    def end(self) -> None:
        if self.end_ns:
            return          # idempotent
        self.end_ns = time.perf_counter_ns()
        self._tracer._finish(self)

    def duration_us(self) -> float:
        end = self.end_ns or time.perf_counter_ns()
        return (end - self.start_ns) / 1000.0

    def record(self) -> Dict[str, Any]:
        """The buffered and exported form (ids as fixed-width hex)."""
        return {
            "name": self.name,
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent_id": f"{self.parent_id:016x}" if self.parent_id else "",
            "start_us": self.start_ns // 1000,
            "dur_us": (self.end_ns - self.start_ns) // 1000,
            "thread": self.thread_id,
            "status": self.status,
            "attrs": self.attrs,
        }


class _NoopSpan:
    """Shared do-nothing span. Every method is free of side effects and
    allocations except attach(): ingress sites attach it so descendants
    of an unsampled root short-circuit instead of minting roots of their
    own."""

    __slots__ = ()

    sampled = False
    name = ""
    context = None
    attrs: Dict[str, Any] = {}

    def set_attr(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def set_error(self, exc: BaseException) -> "_NoopSpan":
        return self

    def attach(self):
        return _CURRENT.set(self)

    def detach(self, token) -> None:
        try:
            _CURRENT.reset(token)
        except ValueError:
            pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def end(self) -> None:
        pass

    def duration_us(self) -> float:
        return 0.0


NOOP_SPAN = _NoopSpan()

#: wire form of a decided-but-unsampled context: downstream hops honour
#: the root's decision instead of rolling again
UNSAMPLED_HEADER = "0-0-0"


def current_span():
    """The contextvar-current span (Span, NOOP_SPAN, or None)."""
    return _CURRENT.get()


class Tracer:
    """Mints spans, applies the sampling policy, feeds finished spans to
    the buffer, the slow-query log and the ``span.<name>`` latency
    series."""

    #: replication-plane spans: a slow peer makes every one of these slow
    #: and would churn the user-query evidence out of the slow log
    _SLOW_LOG_EXCLUDE = ("rpc.RaftService.", "client.RaftService.",
                         "rpc.PushService.", "client.PushService.")

    def __init__(self, buffer) -> None:
        self.buffer = buffer

    def start_span(self, name: str,
                   parent: Optional[SpanContext] = None):
        """Start a span. parent=None inherits the contextvar's current
        span, or else makes a sampling decision for a new root; an
        explicit SpanContext (from metadata, or captured at a queue
        handoff) overrides inheritance."""
        if parent is None:
            cur = _CURRENT.get()
            if cur is not None:
                if not cur.sampled:
                    return NOOP_SPAN
                return Span(self, name, cur.trace_id, parent_id=cur.span_id)
            rate = FLAGS.get("trace_sampling_rate")
            if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
                return NOOP_SPAN
            return Span(self, name, _gen_id())
        if not parent.sampled:
            return NOOP_SPAN
        return Span(self, name, parent.trace_id, parent_id=parent.span_id)

    def _finish(self, span: Span) -> None:
        rec = span.record()
        self.buffer.add(rec)
        # every span name is a latency series; the trace id rides along as
        # an exemplar candidate (outliers surface it in the Prometheus
        # exposition)
        METRICS.latency(f"span.{span.name}").observe_us(
            rec["dur_us"] or (span.end_ns - span.start_ns) / 1000.0,
            trace_id=rec["trace_id"])
        if self._slow_eligible(span.name, span.parent_id):
            slow_ms = FLAGS.get("slow_query_ms")
            if slow_ms > 0 and rec["dur_us"] >= slow_ms * 1000.0:
                self.buffer.add_slow(rec)
                bundle_id = self._capture_flight(rec)
                if bundle_id:
                    # pin the scrape exemplar to the sample a bundle was
                    # captured for, not to a larger unbundled one
                    METRICS.latency(f"span.{span.name}").pin_exemplar(
                        rec["dur_us"], rec["trace_id"])
                _log.warning(
                    "slow query: %s took %.1f ms (trace %s%s)",
                    span.name, rec["dur_us"] / 1000.0, rec["trace_id"],
                    f", bundle {bundle_id}" if bundle_id else "")

    @staticmethod
    def _capture_flight(rec: Dict[str, Any]) -> str:
        """Hand the slow-log record to the flight recorder (which
        rate-limits); observability never fails the request that tripped
        it."""
        try:
            from dingo_tpu_torch.obs.flight import FLIGHT

            return FLIGHT.on_slow_query(rec)
        except Exception:  # noqa: BLE001
            return ""

    @classmethod
    def _slow_eligible(cls, name: str, parent_id: int = 0) -> bool:
        """Slow-query log membership: every RPC ingress span (root or
        adopted from a remote parent) and client-side request roots; never
        background roots or the replication plane."""
        if name.startswith(cls._SLOW_LOG_EXCLUDE):
            return False
        return name.startswith("rpc.") or (
            parent_id == 0 and name.startswith("client.")
        )

    # -- always-sample-slow (tail safety net) --------------------------------
    def slow_watch_start(self) -> int:
        """Non-zero t0 when a request that lost the head-sampling roll
        should still be watched for the slow-query log; 0 when tracing is
        off, so the rate-0 path stays free."""
        if FLAGS.get("trace_sampling_rate") > 0 \
                and FLAGS.get("slow_query_ms") > 0:
            return time.perf_counter_ns()
        return 0

    def slow_watch_end(self, name: str, t0: int) -> None:
        if not t0 or not self._slow_eligible(name):
            return
        dur_us = (time.perf_counter_ns() - t0) // 1000
        slow_ms = FLAGS.get("slow_query_ms")
        if slow_ms <= 0 or dur_us < slow_ms * 1000.0:
            return
        # the request was unsampled, so no span tree exists; the outlier
        # itself is kept as a single record
        rec = {
            "name": name, "trace_id": "", "span_id": "", "parent_id": "",
            "start_us": t0 // 1000, "dur_us": dur_us,
            "thread": threading.get_ident(), "status": "ok",
            "attrs": {"unsampled": True},
        }
        self.buffer.add_slow(rec)
        bundle_id = self._capture_flight(rec)
        _log.warning("slow query (unsampled): %s took %.1f ms%s", name,
                     dur_us / 1000.0,
                     f" (bundle {bundle_id})" if bundle_id else "")


# -- cross-process propagation (request metadata) ----------------------------

def inject_metadata(
    metadata: Optional[Sequence[Tuple[str, str]]] = None,
) -> Optional[List[Tuple[str, str]]]:
    """Metadata list carrying the current span context, merged with the
    caller's metadata. Returns the input unchanged (possibly None) when
    there is nothing to propagate."""
    cur = _CURRENT.get()
    if cur is None or not cur.sampled:
        return list(metadata) if metadata is not None else None
    entry = (
        TRACE_METADATA_KEY,
        f"{cur.trace_id:016x}-{cur.span_id:016x}-1",
    )
    return [*(metadata or ()), entry]


def extract_metadata(
    metadata: Optional[Iterable[Tuple[str, str]]],
) -> Optional[SpanContext]:
    """Parse the propagation header out of request metadata. None when
    absent or malformed (a bad header never fails its request)."""
    if not metadata:
        return None
    for key, value in metadata:
        if key != TRACE_METADATA_KEY:
            continue
        try:
            trace_hex, span_hex, flags = value.split("-")
            return SpanContext(
                int(trace_hex, 16), int(span_hex, 16),
                sampled=bool(int(flags)),
            )
        except (ValueError, AttributeError):
            return None
    return None


TRACER = Tracer(TRACE_BUFFER)
