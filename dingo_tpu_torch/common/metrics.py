"""Metrics: counters, gauges, latency recorders with percentile windows
(port of dingo_tpu/common/metrics.py).

Reference: bvar everywhere — multi-dimension per-region metrics
(store_bvar_metrics.h:86-89), task counters (vector_index_manager.h:177-199),
ad-hoc bvar::LatencyRecorder at each layer (vector_reader.cc:64-65,
raft_store_engine.cc:418,450), exposed via brpc /vars and the metrics
services. Here: a process-global registry the server layer dumps as JSON
(/vars analog) or Prometheus text exposition format (plain-HTTP /metrics).

Naming contract: metric names are lowercase dotted identifiers
(`store.region.key_count`); dimensions ride as labels (`region=`, plus
free-form key=value pairs). Prometheus rendering mangles dots to
underscores — tools/check_metrics_names.py lints registration sites so
the mangled names stay valid and no series is silently dropped.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

#: registration-time contract for metric names (see module docstring);
#: tools/check_metrics_names.py enforces it over literal call sites
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_.]*$")


def valid_metric_name(name: str) -> bool:
    return METRIC_NAME_RE.match(name) is not None


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def get(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, delta: float) -> float:
        """Atomic up/down delta. Concurrent accounting sites (live device
        bytes, in-flight builds) must not race a read-modify-write through
        get()+set() — two racing set()s would drop one side's delta."""
        with self._lock:
            self._value += delta
            return self._value

    def get(self) -> float:
        return self._value


#: windowed-QPS horizon: per-second hit buckets retained this many seconds
QPS_WINDOW_S = 16

#: exemplar retention: an outlier exemplar not beaten by a larger sample
#: is replaced by the next traced sample after this long, so the scrape
#: follows CURRENT outliers instead of the all-time worst
EXEMPLAR_WINDOW_S = 60.0


class LatencyRecorder:
    """bvar::LatencyRecorder analog: ring of recent samples with
    windowed qps estimation and percentile queries.

    `count` is the lifetime total; `qps` is measured over the last
    QPS_WINDOW_S seconds only (per-second hit buckets) — lifetime
    count / process uptime would decay toward zero on long-lived
    processes and never reflect current load."""

    def __init__(self, window: int = 4096):
        self._window = window
        self._samples: List[float] = []
        self._pos = 0
        self._count = 0
        self._sum_us = 0.0
        self._t0 = time.monotonic()
        # per-second hit buckets: slot i holds the count for absolute
        # second _sec_id[i]; stale slots (a different second hashed here
        # more than QPS_WINDOW_S ago) are excluded at read time
        self._sec_hits = [0] * QPS_WINDOW_S
        self._sec_id = [-1] * QPS_WINDOW_S
        # exemplar: (value_us, trace_id, unix_ts) of a recent outlier
        # sample that carried a trace id — the Prometheus exposition
        # attaches it to the p99 series (OpenMetrics exemplar syntax) so a
        # scrape links a bad bucket straight to its trace/flight bundle
        self._ex_us = 0.0
        self._ex_trace = ""
        self._ex_ts = 0.0
        # a pinned exemplar (sample the flight recorder bundled) is sticky:
        # merely-larger unbundled samples can't displace it inside the
        # window, so the scrape keeps linking to a bundle that exists
        self._ex_pinned = False
        self._lock = threading.Lock()

    def observe_us(self, us: float, trace_id: str = "") -> None:
        with self._lock:
            if len(self._samples) < self._window:
                self._samples.append(us)
            else:
                self._samples[self._pos] = us
                self._pos = (self._pos + 1) % self._window
            self._count += 1
            self._sum_us += us
            now_s = int(time.monotonic())
            i = now_s % QPS_WINDOW_S
            if self._sec_id[i] != now_s:
                self._sec_id[i] = now_s
                self._sec_hits[i] = 0
            self._sec_hits[i] += 1
            if trace_id:
                now = time.time()
                expired = now - self._ex_ts > EXEMPLAR_WINDOW_S
                if expired or (not self._ex_pinned and us >= self._ex_us):
                    self._ex_us = us
                    self._ex_trace = trace_id
                    self._ex_ts = now
                    self._ex_pinned = False

    def pin_exemplar(self, us: float, trace_id: str) -> None:
        """Force this sample to be the exemplar regardless of magnitude.
        The slow-query path pins the sample it just flight-recorded so the
        scrape's exemplar always links to a CAPTURED bundle's trace, not
        merely the window's largest sample (e.g. a warmup compile)."""
        if not trace_id:
            return
        with self._lock:
            self._ex_us = us
            self._ex_trace = trace_id
            self._ex_ts = time.time()
            self._ex_pinned = True

    def exemplar(self):
        """(value_us, trace_id, unix_ts) of the retained outlier, or None
        when no traced sample has been observed."""
        with self._lock:
            if not self._ex_trace:
                return None
            return (self._ex_us, self._ex_trace, self._ex_ts)

    class _Timer:
        __slots__ = ("rec", "t0")

        def __init__(self, rec):
            self.rec = rec

        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            self.rec.observe_us((time.perf_counter_ns() - self.t0) / 1000.0)
            return False

    def time(self) -> "_Timer":
        return self._Timer(self)

    @staticmethod
    def _pick(ordered: List[float], p: float) -> float:
        """Percentile over a pre-sorted window; 0.0 on an empty window
        (metrics endpoints poll before the first sample — never raise)."""
        if not ordered:
            return 0.0
        i = min(len(ordered) - 1, int(p / 100.0 * len(ordered)))
        return ordered[i]

    def percentile(self, p: float) -> float:
        with self._lock:
            return self._pick(sorted(self._samples), p)

    def windowed_qps(self, now: Optional[float] = None) -> float:
        """Rate over the recent QPS_WINDOW_S-second window (young
        recorders divide by their actual age so early reads aren't
        deflated by the not-yet-elapsed window)."""
        if now is None:
            now = time.monotonic()
        now_s = int(now)
        with self._lock:
            recent = sum(
                hits for sid, hits in zip(self._sec_id, self._sec_hits)
                if sid >= 0 and now_s - sid < QPS_WINDOW_S
            )
            age = now - self._t0
        return recent / max(min(age, float(QPS_WINDOW_S)), 1e-9)

    def stats(self) -> Dict[str, float]:
        # one snapshot + one sort for every derived figure (p50 and p99
        # used to re-sort the window under separate lock acquisitions)
        now = time.monotonic()
        now_s = int(now)
        with self._lock:
            ordered = sorted(self._samples)
            count = self._count
            total_us = self._sum_us
            recent = sum(
                hits for sid, hits in zip(self._sec_id, self._sec_hits)
                if sid >= 0 and now_s - sid < QPS_WINDOW_S
            )
            age = now - self._t0
        n = len(ordered)
        return {
            "count": count,
            "sum_us": total_us,
            "qps": recent / max(min(age, float(QPS_WINDOW_S)), 1e-9),
            "avg_us": sum(ordered) / n if n else 0.0,
            "p50_us": self._pick(ordered, 50),
            "p99_us": self._pick(ordered, 99),
        }


def _series_key(name: str, region_id: Optional[int],
                labels: Optional[Dict[str, str]]) -> str:
    """`name{k=v,...}` series key. region_id stays the first label (and the
    only one for legacy call sites, so existing dump keys are unchanged);
    free-form labels follow sorted (StoreBvarMetrics multi-dimension
    pattern generalized)."""
    parts: List[Tuple[str, str]] = []
    if region_id:
        parts.append(("region", str(region_id)))
    if labels:
        parts.extend(
            (k, str(v)) for k, v in sorted(labels.items()) if k != "region"
        )
    if not parts:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in parts) + "}"


def split_series_key(key: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Inverse of _series_key: `name{k=v,...}` -> (name, [(k, v), ...])."""
    if not key.endswith("}") or "{" not in key:
        return key, []
    name, _, rest = key.partition("{")
    pairs = []
    for item in rest[:-1].split(","):
        k, _, v = item.partition("=")
        pairs.append((k, v))
    return name, pairs


def mangle_prometheus_name(name: str) -> str:
    """Metric-name mangling for the exposition format: Prometheus names
    are [a-zA-Z_:][a-zA-Z0-9_:]*, so dots (and any other byte outside
    that set) become underscores."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _prom_label_str(pairs: Iterable[Tuple[str, str]]) -> str:
    rendered = []
    for k, v in pairs:
        k = re.sub(r"[^a-zA-Z0-9_]", "_", k)
        if k and k[0].isdigit():
            k = "_" + k
        v = str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        rendered.append(f'{k}="{v}"')
    if not rendered:
        return ""
    return "{" + ",".join(rendered) + "}"


class MetricsRegistry:
    """Named metrics with a region dimension plus free-form labels
    (StoreBvarMetrics multi-dimension pattern)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._latencies: Dict[str, LatencyRecorder] = {}

    def counter(self, name: str, region_id: Optional[int] = None,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        key = _series_key(name, region_id, labels)
        with self._lock:
            return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, region_id: Optional[int] = None,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        key = _series_key(name, region_id, labels)
        with self._lock:
            return self._gauges.setdefault(key, Gauge())

    def latency(self, name: str, region_id: Optional[int] = None,
                labels: Optional[Dict[str, str]] = None) -> LatencyRecorder:
        key = _series_key(name, region_id, labels)
        with self._lock:
            return self._latencies.setdefault(key, LatencyRecorder())

    def drop_region(self, region_id: int) -> int:
        """Forget every series labeled region=<id> (a deleted region's
        gauges must not report its last values forever)."""
        tag = f"region={region_id}"
        n = 0
        with self._lock:
            for d in (self._counters, self._gauges, self._latencies):
                dead = [
                    k for k in d
                    if any(f"{p[0]}={p[1]}" == tag
                           for p in split_series_key(k)[1])
                ]
                for k in dead:
                    del d[k]
                n += len(dead)
        return n

    def dump(self) -> Dict[str, object]:
        """/vars-style dump."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            lats = list(self._latencies.items())
        out: Dict[str, object] = {}
        for k, c in counters:
            out[k] = c.get()
        for k, g in gauges:
            out[k] = g.get()
        for k, lr in lats:
            out[k] = lr.stats()
        return out

    def render_prometheus(self, exemplars: Optional[bool] = None) -> str:
        """Prometheus text exposition format (v0.0.4): counters and gauges
        as-is, latency windows as summaries (quantile labels + lifetime
        _sum/_count). Dotted names mangle to underscores; series sharing a
        base name group under one # TYPE header.

        `exemplars` controls the OpenMetrics trace-id exemplar suffix on
        p99 series: None follows the obs.exemplars flag (the in-band
        DebugService dump and tools default), False strips them — the
        CLASSIC text format cannot carry exemplars, so the HTTP sidecar
        passes False unless the scraper negotiated OpenMetrics."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            lats = list(self._latencies.items())

        lines: List[str] = []
        by_name: Dict[str, List[str]] = {}

        def emit(kind: str, key: str, render_fn) -> None:
            name, pairs = split_series_key(key)
            pname = mangle_prometheus_name(name)
            block = by_name.get(pname)
            if block is None:
                block = by_name[pname] = [f"# TYPE {pname} {kind}"]
            render_fn(pname, pairs, block)

        for key, c in counters:
            v = c.get()
            emit("counter", key,
                 lambda pn, pairs, b, v=v:
                 b.append(f"{pn}{_prom_label_str(pairs)} {v}"))
        for key, g in gauges:
            v = g.get()
            emit("gauge", key,
                 lambda pn, pairs, b, v=v:
                 b.append(f"{pn}{_prom_label_str(pairs)} {_fmt(v)}"))
        exemplars_on = _exemplars_enabled() if exemplars is None \
            else (exemplars and _exemplars_enabled())
        for key, lr in lats:
            st = lr.stats()
            ex = lr.exemplar() if exemplars_on else None

            def render(pn, pairs, b, st=st, ex=ex):
                for q, field in (("0.5", "p50_us"), ("0.99", "p99_us")):
                    line = (
                        f"{pn}{_prom_label_str(list(pairs) + [('quantile', q)])}"
                        f" {_fmt(st[field])}"
                    )
                    if q == "0.99" and ex is not None:
                        # OpenMetrics exemplar: trace id of a recent
                        # outlier sample rides the p99 series
                        val, trace_id, ts = ex
                        line += (
                            f' # {{trace_id="{trace_id}"}} '
                            f"{_fmt(round(val, 3))} {_fmt(round(ts, 3))}"
                        )
                    b.append(line)
                ls = _prom_label_str(pairs)
                b.append(f"{pn}_sum{ls} {_fmt(st['sum_us'])}")
                b.append(f"{pn}_count{ls} {int(st['count'])}")

            emit("summary", key, render)
            # windowed rate rides as a sibling gauge — a summary type may
            # only carry quantile/_sum/_count series, strict parsers reject
            # extra suffixes inside the block
            name, pairs = split_series_key(key)
            emit("gauge", f"{name}_qps",
                 lambda pn, _ignored, b, pairs=pairs, q=st["qps"]:
                 b.append(f"{pn}{_prom_label_str(pairs)} {_fmt(q)}"))

        for pname in sorted(by_name):
            lines.extend(by_name[pname])
        return "\n".join(lines) + "\n"


def _exemplars_enabled() -> bool:
    """obs.exemplars flag (lazy import: config must stay import-light and
    cycle-free from this module)."""
    try:
        from dingo_tpu_torch.common.config import FLAGS

        return bool(FLAGS.get("obs_exemplars"))
    except Exception:  # noqa: BLE001 — registry usable standalone
        return False


def _fmt(v: float) -> str:
    """Render floats without exponent surprises; integers stay integral."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


METRICS = MetricsRegistry()
