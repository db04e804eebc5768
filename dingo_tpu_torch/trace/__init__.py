"""Tracing and query profiling (port of dingo_tpu/trace).

Every ingress mints (or adopts) a trace id, spans nest through contextvars
across the coalescer's thread handoffs, request metadata carries the
context between processes, and a bounded ring buffer keeps sampled traces
for a JSON dump and a Chrome ``trace_event`` file (chrome://tracing,
Perfetto).

Overhead contract: with ``trace_sampling_rate = 0`` every instrumented
site costs one sampled-check (a contextvar read and a flag read) and
returns the shared no-op span.
"""

from dingo_tpu_torch.trace.buffer import TRACE_BUFFER, TraceBuffer
from dingo_tpu_torch.trace.export import (
    dump_chrome_trace,
    to_chrome_trace,
    to_json,
)
from dingo_tpu_torch.trace.span import (
    NOOP_SPAN,
    TRACE_METADATA_KEY,
    TRACER,
    UNSAMPLED_HEADER,
    Span,
    SpanContext,
    Tracer,
    current_span,
    extract_metadata,
    inject_metadata,
)

__all__ = [
    "NOOP_SPAN",
    "Span",
    "SpanContext",
    "TRACER",
    "TRACE_BUFFER",
    "TRACE_METADATA_KEY",
    "TraceBuffer",
    "Tracer",
    "UNSAMPLED_HEADER",
    "current_span",
    "dump_chrome_trace",
    "extract_metadata",
    "inject_metadata",
    "to_chrome_trace",
    "to_json",
]
