"""Flight recorder: a bounded in-memory black box for bad moments (port
of dingo_tpu/obs/flight.py).

When a p99 outlier, a search error, a device OOM, a corruption verdict or
a replica divergence happens, the state an operator needs (the offending
trace's spans, what the metrics were doing in the seconds before, the
launch sentinel's shapes, how device memory was distributed, the quality,
pressure and integrity state, the last controller decisions) is gone by
the time anyone looks. The flight recorder snapshots all of it at the
trigger into a compressed bundle and keeps the last
``obs_flight_max_bundles`` of them.

Triggers, each rate-limited per reason so a storm records one
representative bundle:
- a slow query crossing ``slow_query_ms`` (the tracer's slow log, sampled
  or not);
- a search error (``on_rpc_error``);
- a device allocation failure (the HBM ledger's hook);
- a scrub mismatch, a replica divergence, a dropped region command.

A bundle carries the trigger, the trace's spans (or the slow-log tail
when unsampled), metric deltas over the last ``obs_flight_buffer_s``
seconds (against the tick ring the metrics collector drives), the
sentinel state, the HBM ledger, the curated families' absolute values,
digests, events and the node config. Payload = zlib(JSON); ``get`` and
``get_json`` read it back (the gRPC FlightDump surface is not ported).

Latency series carry exemplars (trace ids on outlier samples, see
common/metrics.py), so a Prometheus scrape links a bad bucket to a trace
id and the trace id to its bundle.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS

_log = get_logger("obs.flight")

#: minimum spacing between bundles of the SAME reason (storm control)
MIN_TRIGGER_INTERVAL_S = 1.0

#: spans attached to a bundle when the trigger has no trace id (unsampled
#: slow query): the recent slow-log tail plus newest ring spans
_UNTRACED_SPAN_LIMIT = 64


def _bundle_id() -> str:
    return f"fb-{int(time.time()):x}-{os.urandom(3).hex()}"


def _flatten_numeric(dump: Dict[str, Any]) -> Dict[str, float]:
    """MetricsRegistry.dump() -> flat numeric view: counters/gauges as-is,
    latency stats keep their count/sum (the delta-able parts)."""
    out: Dict[str, float] = {}
    for key, val in dump.items():
        if isinstance(val, (int, float)):
            out[key] = float(val)
        elif isinstance(val, dict):
            for sub in ("count", "sum_us"):
                if sub in val:
                    out[f"{key}.{sub}"] = float(val[sub])
    return out


class FlightRecorder:
    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        #: (meta dict, compressed payload bytes), newest last (a list,
        #: not a deque: eviction is reason-aware, see _trigger)
        self._bundles: List = []
        #: (monotonic, wall_ms, flat numeric metrics) tick ring
        self._ticks: deque = deque()
        self._last_trigger: Dict[str, float] = {}
        #: optional provider of region/index config for bundles — the
        #: server wires node state here; tests inject dicts
        self.config_provider: Optional[Callable[[], Dict[str, Any]]] = None

    # ---- metrics tick ring -------------------------------------------------
    def tick(self, dump: Optional[Dict[str, Any]] = None) -> None:
        """Sample the metrics registry into the delta ring. Driven by the
        store-metrics crontab; call directly in tests/tools."""
        window = float(FLAGS.get("obs_flight_buffer_s"))
        now = time.monotonic()
        flat = _flatten_numeric(dump if dump is not None
                                else self.registry.dump())
        with self._lock:
            self._ticks.append((now, int(time.time() * 1000), flat))
            # keep one tick OLDER than the window so a trigger right after
            # pruning still has a full-window baseline
            while (len(self._ticks) > 2
                   and now - self._ticks[1][0] > window):
                self._ticks.popleft()

    def _metrics_delta(self, now_flat: Optional[Dict[str, float]] = None
                       ) -> Dict[str, Any]:
        if now_flat is None:
            now_flat = _flatten_numeric(self.registry.dump())
        with self._lock:
            base = self._ticks[0] if self._ticks else None
        if base is None:
            return {"window_s": 0.0, "deltas": {}, "note": "no ticks yet"}
        base_t, _base_ms, base_flat = base
        deltas = {}
        for key, val in now_flat.items():
            d = val - base_flat.get(key, 0.0)
            if d:
                deltas[key] = round(d, 3)
        return {
            "window_s": round(time.monotonic() - base_t, 1),
            "deltas": deltas,
        }

    def _family_state(self, now_flat: Dict[str, float],
                      prefix: str) -> Dict[str, Any]:
        """Current values of one curated series family — ABSOLUTE values,
        unlike the delta window: a slow-query bundle must show the shard
        balance / graph-walk health at capture time, not only how it
        moved during the window. Shares the capture's single registry
        dump. Captured families: mesh.* (shard rows, skew, replica
        routing), hnsw.* (hops, visited fraction, beam occupancy,
        adjacency rebuilds), and quality.* (live recall/CI/RBO + tuner
        knob positions — was the store trading recall when the incident
        hit?), qos.* (queue depth/wait, shed/expired counters, degrade
        level — was the store under pressure, and what had admission
        already given up on?), cache.* (hit/miss/dedupe/stale/
        semantic counters, resident bytes — was the serving-edge cache
        absorbing the skewed traffic or churning?), heat.* (traffic
        concentration + working-set bytes — was the incident load skewed
        onto a hot core, and how much of the region did it actually
        touch?), cost.* (learned per-kernel dispatch costs — what did
        the coalescer believe a row cost when it made its admission
        calls?), and capacity.* (coordinator headroom/advisory rollups
        when the bundle fires coordinator-side)."""
        return {k: v for k, v in now_flat.items() if k.startswith(prefix)}

    @staticmethod
    def _integrity_state() -> Dict[str, Any]:
        """Per-region digest vectors + scrub verdicts at capture time
        (obs/integrity.py): a divergence/corruption bundle must carry the
        actual digest vectors of both sides, not only the counters."""
        try:
            from dingo_tpu_torch.obs.integrity import INTEGRITY

            return INTEGRITY.state()
        except Exception:  # noqa: BLE001 — black box must never raise
            return {}

    @staticmethod
    def _events_state() -> list:
        """The newest control-plane decisions at capture time
        (obs/events.py): an anomaly bundle should answer "what did the
        controllers just DO" without a second RPC — the knob walk that
        led into the episode is usually the diagnosis."""
        try:
            import dataclasses as _dc

            from dingo_tpu_torch.obs.events import EVENTS

            return [_dc.asdict(e) for e in EVENTS.last_before(32)]
        except Exception:  # noqa: BLE001 — black box must never raise
            return []

    # ---- triggers ----------------------------------------------------------
    def on_slow_query(self, rec: Dict[str, Any]) -> str:
        """Tracer hook: `rec` is the slow-log record (sampled span or the
        synthesized unsampled one)."""
        extra = {"dur_ms": round(rec.get("dur_us", 0) / 1000.0, 1)}
        prune = self._pruned_fractions()
        if prune:
            # a slow scan with pruning barely engaging (fraction ~0) is
            # a different diagnosis than one pruning hard — carry the
            # per-region gauge right in the trigger meta so the bundle
            # answers it even when no metrics collector tick ring runs
            # (the smoke, tests)
            extra["pruned_dim_fraction"] = prune
        return self.trigger(
            "slow_query",
            trace_id=rec.get("trace_id", ""),
            name=rec.get("name", ""),
            extra=extra,
        )

    @staticmethod
    def _pruned_fractions() -> Dict[str, float]:
        """Current ivf.pruned_dim_fraction gauge per series (empty when
        the pruned scan never ran)."""
        from dingo_tpu_torch.common.metrics import METRICS

        out = {}
        with METRICS._lock:
            items = list(METRICS._gauges.items())
        for key, g in items:
            if key.startswith("ivf.pruned_dim_fraction"):
                out[key] = round(g.get(), 4)
        return out

    def on_rpc_error(self, span_name: str, exc: BaseException,
                     span=None) -> str:
        from dingo_tpu_torch.obs.hbm import looks_like_oom

        trace_id = ""
        live = None
        if span is not None and getattr(span, "sampled", False):
            trace_id = f"{span.trace_id:016x}"
            # the failing ingress span hasn't ENDED yet (we run inside
            # its except arm), so the buffer snapshot can't contain it —
            # synthesize its in-flight record or the bundle would show a
            # trace with children but no failing root
            live = {
                "name": span.name,
                "trace_id": trace_id,
                "span_id": f"{span.span_id:016x}",
                "parent_id": (f"{span.parent_id:016x}"
                              if span.parent_id else ""),
                "start_us": span.start_ns // 1000,
                "dur_us": int(span.duration_us()),
                "thread": span.thread_id,
                "status": span.status if span.status != "ok"
                else f"error: {type(exc).__name__}",
                "attrs": {**span.attrs, "in_flight": True},
            }
        return self.trigger(
            "device_oom" if looks_like_oom(exc) else "error",
            trace_id=trace_id,
            name=span_name,
            extra={"error": f"{type(exc).__name__}: {exc}"[:2000]},
            live_span=live,
        )

    def trigger(self, reason: str, trace_id: str = "", name: str = "",
                region_id: int = 0,
                extra: Optional[Dict[str, Any]] = None,
                live_span: Optional[Dict[str, Any]] = None) -> str:
        """Capture a bundle; returns its id, or "" when rate-limited or
        disabled (obs.flight_max_bundles = 0). `live_span` is the
        in-flight (not-yet-ended) triggering span's record, appended to
        the trace snapshot. Never raises."""
        try:
            return self._trigger(reason, trace_id, name, region_id, extra,
                                 live_span)
        except Exception:  # noqa: BLE001 — the black box must never be
            _log.exception("flight trigger failed")  # the crash
            return ""

    def _trigger(self, reason, trace_id, name, region_id, extra,
                 live_span=None) -> str:
        max_bundles = int(FLAGS.get("obs_flight_max_bundles"))
        if max_bundles <= 0:
            return ""
        now = time.monotonic()
        with self._lock:
            last = self._last_trigger.get(reason, 0.0)
            if now - last < MIN_TRIGGER_INTERVAL_S:
                self.registry.counter(
                    "flight.suppressed", labels={"reason": reason}
                ).add(1)
                return ""
            self._last_trigger[reason] = now

        from dingo_tpu_torch.obs.sentinel import SENTINEL
        from dingo_tpu_torch.obs.hbm import HBM
        from dingo_tpu_torch.trace import TRACE_BUFFER

        spans_fallback = False
        if trace_id:
            spans = TRACE_BUFFER.snapshot(trace_id=trace_id)
            if live_span is not None and not any(
                    s.get("span_id") == live_span["span_id"] for s in spans):
                spans = spans + [live_span]
            if not spans:
                # nothing of the trace finished and no live record — the
                # recent ring tail is the best available context
                spans = TRACE_BUFFER.snapshot(limit=_UNTRACED_SPAN_LIMIT)
                spans_fallback = True
        else:
            spans = TRACE_BUFFER.snapshot(limit=_UNTRACED_SPAN_LIMIT)
            spans_fallback = True
        config: Dict[str, Any] = {"flags": FLAGS.all()}
        if self.config_provider is not None:
            try:
                config["node"] = self.config_provider()
            except Exception:  # noqa: BLE001
                config["node"] = {"error": "config provider failed"}

        bid = _bundle_id()
        # ONE registry dump per capture, shared by the delta window and
        # the absolute mesh state (capture fires exactly when the store
        # is struggling — don't walk the registry twice)
        now_flat = _flatten_numeric(self.registry.dump())
        payload = {
            "id": bid,
            "reason": reason,
            "name": name,
            "trace_id": trace_id,
            "region_id": region_id,
            "created_ms": int(time.time() * 1000),
            "trigger": extra or {},
            "spans": spans,
            "spans_fallback": spans_fallback,
            "slow_queries": TRACE_BUFFER.slow_queries()[-8:],
            "metrics": self._metrics_delta(now_flat),
            "kernel_cache": SENTINEL.state(),
            "hbm": HBM.state(),
            "mesh": self._family_state(now_flat, "mesh."),
            "hnsw": self._family_state(now_flat, "hnsw."),
            "quality": self._family_state(now_flat, "quality."),
            "qos": self._family_state(now_flat, "qos."),
            "consistency": self._family_state(now_flat, "consistency."),
            "cache": self._family_state(now_flat, "cache."),
            "heat": self._family_state(now_flat, "heat."),
            "cost": self._family_state(now_flat, "cost."),
            "capacity": self._family_state(now_flat, "capacity."),
            "integrity": self._integrity_state(),
            "events": self._events_state(),
            "config": config,
        }
        blob = zlib.compress(
            json.dumps(payload, default=str).encode("utf-8"), 6
        )
        meta = {
            "id": bid,
            "reason": reason,
            "name": name,
            "trace_id": trace_id,
            "region_id": region_id,
            "created_ms": payload["created_ms"],
            "payload_bytes": len(blob),
        }
        with self._lock:
            self._bundles.append((meta, blob))
            while len(self._bundles) > max_bundles:
                # reason-aware eviction: a storm of one reason (generic
                # rpc errors at the rate limit) must not flush the single
                # device_oom/slow_query bundle an operator actually needs
                # — evict the oldest bundle of a reason that still has
                # duplicates; only when every reason is down to one,
                # evict the oldest overall
                counts: Dict[str, int] = {}
                for m, _ in self._bundles:
                    counts[m["reason"]] = counts.get(m["reason"], 0) + 1
                victim = next(
                    (i for i, (m, _) in enumerate(self._bundles)
                     if counts[m["reason"]] > 1),
                    0,
                )
                del self._bundles[victim]
        self.registry.counter("flight.bundles",
                              labels={"reason": reason}).add(1)
        return bid

    # ---- access ------------------------------------------------------------
    def bundles_meta(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(meta) for meta, _ in self._bundles]

    def get(self, bundle_id: str = "") -> Optional[bytes]:
        """Compressed payload by id (newest bundle when id is empty)."""
        found = self.get_with_id(bundle_id)
        return found[1] if found else None

    def get_with_id(self, bundle_id: str = ""):
        """(id, payload) resolved under ONE lock hold, so 'newest' and
        its id can't diverge when a trigger lands concurrently."""
        with self._lock:
            if not self._bundles:
                return None
            if not bundle_id:
                meta, blob = self._bundles[-1]
                return meta["id"], blob
            for meta, blob in self._bundles:
                if meta["id"] == bundle_id:
                    return meta["id"], blob
        return None

    def get_json(self, bundle_id: str = "") -> Optional[Dict[str, Any]]:
        blob = self.get(bundle_id)
        if blob is None:
            return None
        return json.loads(zlib.decompress(blob).decode("utf-8"))

    def clear(self) -> None:
        with self._lock:
            self._bundles.clear()
            self._ticks.clear()
            self._last_trigger.clear()


FLIGHT = FlightRecorder()


def black_box_error(span_name: str, exc: BaseException, span=None,
                    region_id: int = 0) -> str:
    """One-call error black-box for rpc/search failure arms. Encodes the
    ordering contract ONCE: on_rpc_error first (its bundle carries the
    victim's trace id), then the hbm ledger only COUNTS an OOM
    (capture=False — a trace-less device_oom bundle captured first would
    win the per-reason rate limit). Never raises."""
    try:
        from dingo_tpu_torch.obs.hbm import HBM

        bid = FLIGHT.on_rpc_error(span_name, exc, span)
        HBM.on_alloc_failure(exc, context=span_name, region_id=region_id,
                             capture=False)
        return bid
    except Exception:  # noqa: BLE001 — never mask the original error
        return ""
