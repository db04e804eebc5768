"""Launch-and-shape sentinel: the port's counterpart of
dingo_tpu/obs/sentinel.py.

The JAX package's ``sentinel_jit`` counts jit traces: a call whose
argument signature (dtypes and shape buckets) is new compiles, a stall of
0.1-40 s on the serving path. The port has no jit. Its kernels are built
once per library by ``ops/cuda_build.py`` (nvcc) and a launch takes any
shape, so the two events the sentinel watches are:

- the first launch of each (kernel, route, argument-shape signature):
  every wrapper in ``ops/kernel_*.py`` reports each call through
  ``SENTINEL.launch``. The route is ``cuda`` for a launch and ``plain``
  where the wrapper ran its plain version on CPU tensors, so the CPU tests
  hold the same invariant;
- each library build by ``ops/cuda_build.py`` (``SENTINEL.on_build``).

Counters and their names in the JAX package:

  kernel.new_shapes                    xla.recompiles
  kernel.new_shapes_by_kernel{kernel}  xla.recompiles_by_kernel{kernel}
  kernel.shape_hits{kernel}            xla.cache_hits{kernel}
  kernel.builds                        (none: one compile per library)
  kernel.build_ms_total                xla.compile_ms_total
  kernel.build_ms{library} (gauge)     xla.compile_ms{kernel} (gauge)
  span kernel.build                    span xla.compile

The invariant is the JAX package's: after warm-up, steady-state serving
adds no new shape. Here a new shape costs no compile, but it means a batch
left the pow2 ladder the warm-up covered: new allocations and a shape no
warm-up timed.

Device-fault injection: ``launch`` first calls
``DEVFAULT.maybe_fail`` (ops/devfault.py) with the JAX package's sentinel
name of the program the kernel replaces (``FAULT_NAMES``), as the JAX
sentinel does before each dispatch, so an armed shim fails the same
program in both packages.

Cost of a repeated shape: one tuple of (dtype, shape) pairs, a dict lookup
under the kernel's lock and one Counter.add.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.ops.devfault import DEVFAULT

__all__ = ["SENTINEL", "LaunchSentinel", "FAULT_NAMES"]

#: kernel wrapper name -> the JAX package's sentinel name of the program it
#: replaces (the device-fault shim's dispatch name); a kernel of the port's
#: own (G, ops/kernel_beam.py) is named under its program already
FAULT_NAMES = {
    "fused_topk": "ops.pallas.fused_topk",
    "pruned_fused_topk": "ops.pallas.pruned_fused_topk",
    "ivf_list_topk": "ops.pallas.ivf_list_topk",
    "ivf_pruned_topk": "ops.pallas.ivf_pruned_topk",
    "ivf_pq_adc_topk": "ops.pallas.pq_adc_topk",
    "ivfpq_adc_lut": "index.ivfpq.adc_lut",
}


def _sig_text(key) -> str:
    """`route:dtype[AxB]_dtype[C]_k` text of a signature key."""
    route, shapes, scalars = key
    parts = [f"{str(dt).replace('torch.', '')}[{'x'.join(map(str, s))}]"
             for dt, s in shapes]
    parts += [repr(v) for v in scalars]
    return f"{route}:" + "_".join(parts)


class _Entry:
    """Per-kernel accounting (guarded by its own lock)."""

    __slots__ = ("calls", "new_shapes", "last_new_at", "sigs", "hits",
                 "lock")

    def __init__(self, kernel: str):
        self.calls = 0
        self.new_shapes = 0
        self.last_new_at = 0.0
        self.sigs: Dict[Any, int] = {}
        self.hits = METRICS.counter("kernel.shape_hits",
                                    labels={"kernel": kernel})
        self.lock = threading.Lock()


class LaunchSentinel:
    """Registry of kernel launches by shape signature and of library
    builds. Process-wide singleton ``SENTINEL``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._builds: Dict[str, Dict[str, float]] = {}

    def entry(self, kernel: str) -> _Entry:
        with self._lock:
            e = self._entries.get(kernel)
            if e is None:
                e = self._entries[kernel] = _Entry(kernel)
            return e

    # ---- launches ------------------------------------------------------------
    def launch(self, kernel: str, tensors, *scalars) -> bool:
        """Count one call of `kernel` on `tensors` (its inputs) and the
        scalars that size its outputs; True when the signature is new.
        Raises the device-fault shim's fault when it is armed for this
        kernel."""
        DEVFAULT.maybe_fail(FAULT_NAMES.get(kernel, kernel))
        route = "cuda" if tensors[0].is_cuda else "plain"
        key = (route, tuple((t.dtype, tuple(t.shape)) for t in tensors),
               scalars)
        e = self.entry(kernel)
        with e.lock:
            e.calls += 1
            seen = e.sigs.get(key, 0)
            e.sigs[key] = seen + 1
            if seen:
                new = False
            else:
                new = True
                e.new_shapes += 1
                e.last_new_at = time.monotonic()
        if new:
            METRICS.counter("kernel.new_shapes").add(1)
            METRICS.counter("kernel.new_shapes_by_kernel",
                            labels={"kernel": kernel}).add(1)
        else:
            e.hits.add(1)
        return new

    def new_shapes(self) -> int:
        """Lifetime total of new signatures (the kernel.new_shapes
        counter's figure, kept here so callers can diff it)."""
        with self._lock:
            entries = list(self._entries.values())
        return sum(e.new_shapes for e in entries)

    # ---- builds ----------------------------------------------------------------
    def on_build(self, library: str, ms: float) -> None:
        """Record one library build by nvcc and its wall time, as a
        `kernel.build` span (a root unless a sampled request is current:
        a build stall is evidence whatever the sampling rate)."""
        with self._lock:
            b = self._builds.setdefault(
                library, {"builds": 0, "build_ms_total": 0.0,
                          "last_build_ms": 0.0})
            b["builds"] += 1
            b["build_ms_total"] += ms
            b["last_build_ms"] = ms
        METRICS.counter("kernel.builds").add(1)
        METRICS.counter("kernel.build_ms_total").add(int(ms))
        METRICS.gauge("kernel.build_ms", labels={"library": library}).set(ms)
        from dingo_tpu_torch.trace.span import (
            TRACER,
            Span,
            _gen_id,
            current_span,
        )

        cur = current_span()
        if cur is not None and cur.sampled:
            span = Span(TRACER, "kernel.build", cur.trace_id,
                        parent_id=cur.span_id)
        else:
            span = Span(TRACER, "kernel.build", _gen_id())
        span.start_ns = time.perf_counter_ns() - int(ms * 1e6)
        span.set_attr("library", library)
        span.set_attr("ms", round(ms, 2))
        span.end()

    # ---- snapshot ----------------------------------------------------------------
    def reset(self) -> None:
        """Forget every kernel's signatures (test and benchmark
        isolation; the kernel.* counters keep their lifetime totals)."""
        with self._lock:
            self._entries.clear()

    def builds(self) -> Dict[str, Dict[str, float]]:
        """Per library built in this process: builds and their ms."""
        with self._lock:
            return {k: dict(v) for k, v in self._builds.items()}

    def state(self) -> Dict[str, Dict[str, Any]]:
        """Per kernel: calls, shape hits, new shapes, the age of the last
        new shape and each signature's count."""
        with self._lock:
            entries = list(self._entries.items())
        out: Dict[str, Dict[str, Any]] = {}
        now = time.monotonic()
        for kernel, e in entries:
            with e.lock:
                out[kernel] = {
                    "calls": e.calls,
                    "new_shapes": e.new_shapes,
                    "shape_hits": e.calls - e.new_shapes,
                    "last_new_shape_age_s": (
                        round(now - e.last_new_at, 1)
                        if e.last_new_at else None),
                    "signatures": {_sig_text(k): n
                                   for k, n in e.sigs.items()},
                }
        return out


SENTINEL = LaunchSentinel()
