"""Control-plane flight recorder: the decision event ledger (port of
dingo_tpu/obs/events.py).

Seven autonomous controllers navigate the speed/recall/
memory operating-point space live — the SLO tuner, the QoS shed ladder,
the tier manager, the device-recovery plane, the replica planner, the
capacity advisor, and the cache stale rung — all writing into
``index.tuning``, precision advisories, and tier rungs. This module is
the missing record of *which* controller moved *which* knob on *what*
evidence: every actuation emits one :class:`Event` whose ``evidence``
field snapshots the exact metric values the controller read when it
decided (tuner: CI bounds vs the SLO; shed: estimated wait vs
``qos.max_queue_ms``; tier manager: headroom + windowed QPS; recovery:
the OOM rung; planner/capacity: heartbeat QPS / working-set inputs;
cache: the degrade level).

Plane shape (the HEAT/QUALITY/PRESSURE discipline):

- module singleton ``EVENTS``; ``events.enabled`` off means ``emit`` is
  ONE flag read and allocates nothing;
- a bounded per-node ring (``events.max_entries``) with overflow counted
  in ``event.dropped`` — the ledger may forget, it may never grow;
- per-actor monotone sequence numbers that survive restart (the epoch-ms
  base makes a restarted store's seq continue above its predecessor's),
  so the coordinator can dedupe re-sent events exactly;
- ``harvest()`` hands each event to the heartbeat exactly once (the
  metrics collector batches ``events.heartbeat_batch`` per beat and the
  coordinator merges them into the cluster timeline).

Emission is synchronous and host-only: an emit is a dict -> JSON dump +
a deque append under one lock, no device touch, no worker thread —
controller decisions are rare (crontab ticks), so unlike the heat/quality
planes there is nothing to take off the serving path.

Coordinator-side, :class:`ClusterTimeline` merges heartbeat batches into
a causally-ordered cluster view: each store's wall clock is normalized by
the heartbeat receive offset (the METRICS_STALE_MS receive-clock
discipline — ``recv_ms - collected_at_ms`` absorbs skew), events order by
(adjusted ts, node, actor_seq), and per-(node, actor) max-seq dedupe makes
re-delivered heartbeats idempotent. ``explain_region`` reconstructs every
currently live override/rung/advisory on a region as the chain of events
that explains it, flagging live knobs with no surviving explanation
("orphan knobs" — the ring or timeline forgot, or a writer bypassed the
ledger).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.common.metrics import METRICS

#: the seven controller actors (and the knobs they own) — documentation
#: and render-order, not an emit-time allowlist: a new controller may
#: emit under a new actor name without touching this table
ACTORS = (
    # actor       knobs it moves             evidence fields it snapshots
    ("tuner",     "nprobe/ef/rerank_factor/precision(advisory)",
     "ci_low, ci_high, slo, p99_ms, budget_ms, queries"),
    ("shed",      "degrade_level (+saved tuning writes)",
     "pressure_ms, max_queue_ms, level"),
    ("tier",      "tier rung",
     "from, to, headroom, qps, advisory, ms"),
    ("recovery",  "device_degraded, recovery rung",
     "rung, reason, precision"),
    ("planner",   "replica count",
     "qps, target_qps, floor, peers, add/drop store"),
    ("capacity",  "demote/split advisory",
     "headroom_frac, target, bytes_at_stake"),
    ("cache",     "stale-version rung",
     "degrade_level, bound"),
)


def events_enabled() -> bool:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return bool(FLAGS.get("events_enabled"))
    except KeyError:
        return True


def events_max_entries() -> int:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return max(16, int(FLAGS.get("events_max_entries")))
    except (KeyError, TypeError, ValueError):
        return 1024


def events_heartbeat_batch() -> int:
    from dingo_tpu_torch.common.config import FLAGS

    try:
        return max(0, int(FLAGS.get("events_heartbeat_batch")))
    except (KeyError, TypeError, ValueError):
        return 128


@persist.register
@dataclasses.dataclass
class Event:
    """One control-plane decision. persist-registered because events ride
    the heartbeat snapshot, which the replicated coordinator raft-proposes
    (the RegionMetricsSnapshot contract)."""

    actor: str              #: which controller decided (ACTORS table)
    region_id: int          #: the region it actuated (0 = store-wide)
    knob: str               #: what moved (nprobe / degrade_level / tier...)
    old: str                #: stringified prior value
    new: str                #: stringified new value
    trigger: str            #: why, one word (tighten/escalate/demote/...)
    #: compact JSON snapshot of the exact inputs the controller read when
    #: it decided — the evidence, not a re-derivation
    evidence: str = ""
    ts_ms: int = 0          #: emitter wall clock (normalized on merge)
    actor_seq: int = 0      #: per-(node, actor) monotone, restart-safe
    node_id: str = ""       #: stamped at harvest (store_id) or merge
    trace_id: str = ""      #: hex trace id when a sampled span was live
    flight_bundle_id: str = ""   #: bundle that snapshotted this episode

    def evidence_dict(self) -> Dict[str, Any]:
        if not self.evidence:
            return {}
        try:
            return json.loads(self.evidence)
        except ValueError:
            return {"_raw": self.evidence}


_EVENT_FIELDS = tuple(f.name for f in dataclasses.fields(Event))


class EventLedger:
    """Bounded per-node ring of control-plane decisions (``EVENTS``)."""

    def __init__(self, registry=METRICS):
        self._reg = registry
        self._lock = threading.Lock()
        self._ring: deque = deque()
        #: actor -> next sequence number. Seeded from the wall clock
        #: (epoch_ms * 1000) so a restarted process continues ABOVE every
        #: seq its predecessor could have minted — coordinator dedupe
        #: stays a per-(node, actor) max-seq watermark, no epochs needed
        self._seq: Dict[str, int] = {}
        #: ring indices below this were already harvested into a heartbeat
        self._harvested = 0
        self._dropped = 0
        #: lifetime accounting (overhead attribution): total emits
        #: and wall seconds spent inside emit() while enabled
        self._emitted = 0
        self._emit_s = 0.0

    # -- emit ---------------------------------------------------------------
    def emit(self, actor: str, region_id: int, knob: str, old, new,
             trigger: str, evidence: Optional[Dict[str, Any]] = None,
             trace_id: str = "", flight_bundle_id: str = "",
             ) -> Optional[Event]:
        """Record one actuation. Returns the Event, or None when the
        ledger is off (one flag read, nothing allocated)."""
        if not events_enabled():
            return None
        t_emit = time.perf_counter()
        if not trace_id:
            from dingo_tpu_torch.trace.span import current_span

            sp = current_span()
            tid = getattr(sp, "trace_id", 0) if sp is not None else 0
            if tid:
                trace_id = format(tid, "x")
        ev = Event(
            actor=str(actor),
            region_id=int(region_id),
            knob=str(knob),
            old=str(old),
            new=str(new),
            trigger=str(trigger),
            evidence=json.dumps(evidence, sort_keys=True,
                                separators=(",", ":"), default=str)
            if evidence else "",
            ts_ms=int(time.time() * 1000),
            trace_id=trace_id,
            flight_bundle_id=flight_bundle_id,
        )
        cap = events_max_entries()
        with self._lock:
            seq = self._seq.get(actor)
            if seq is None:
                seq = ev.ts_ms * 1000
            ev.actor_seq = seq
            self._seq[actor] = seq + 1
            self._ring.append(ev)
            while len(self._ring) > cap:
                self._ring.popleft()
                if self._harvested > 0:
                    # already shipped to the coordinator: a normal ring
                    # eviction, not a loss
                    self._harvested -= 1
                else:
                    self._dropped += 1
                    self._reg.counter("event.dropped").add(1)
            self._emitted += 1
        self._reg.counter("event.emitted", region_id=int(region_id),
                          labels={"actor": str(actor)}).add(1)
        self._emit_s += time.perf_counter() - t_emit
        return ev

    # -- queries ------------------------------------------------------------
    def recent(self, limit: int = 0, region_id: Optional[int] = None,
               actor: str = "") -> List[Event]:
        """Matching events, oldest first (the ring's natural order)."""
        with self._lock:
            evs = list(self._ring)
        if region_id is not None:
            evs = [e for e in evs if e.region_id == int(region_id)]
        if actor:
            evs = [e for e in evs if e.actor == actor]
        if limit and len(evs) > limit:
            evs = evs[-limit:]
        return evs

    def last_before(self, limit: int) -> List[Event]:
        """The newest `limit` events — the flight-bundle section."""
        return self.recent(limit=limit)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._ring), "dropped": self._dropped,
                    "pending": len(self._ring) - self._harvested,
                    "emitted": self._emitted,
                    "emit_s": self._emit_s,
                    "seq": dict(self._seq)}

    # -- heartbeat transport ------------------------------------------------
    def harvest(self, batch: int = 0, node_id: str = "") -> List[Event]:
        """Events not yet shipped, up to `batch` (0 = flag default), each
        returned EXACTLY once across harvests and stamped with the
        harvesting node. Shipped events stay in the ring for local
        EventDump / flight bundles until the bound evicts them."""
        if batch <= 0:
            batch = events_heartbeat_batch()
        if batch <= 0:
            return []
        with self._lock:
            pending = len(self._ring) - self._harvested
            take = min(batch, max(0, pending))
            if take <= 0:
                return []
            start = self._harvested
            out = [self._ring[i] for i in range(start, start + take)]
            self._harvested = start + take
        if node_id:
            for ev in out:
                if not ev.node_id:
                    ev.node_id = node_id
        return out

    # -- lifecycle ----------------------------------------------------------
    def forget_region(self, region_id: int) -> None:
        """Drop a departed region's events (the collector retire loop)."""
        rid = int(region_id)
        with self._lock:
            kept, harvested = [], 0
            for i, ev in enumerate(self._ring):
                if ev.region_id == rid:
                    continue
                if i < self._harvested:
                    harvested += 1
                kept.append(ev)
            self._ring = deque(kept)
            self._harvested = harvested

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq.clear()
            self._harvested = 0
            self._dropped = 0
            self._emitted = 0
            self._emit_s = 0.0


EVENTS = EventLedger()


# -- coordinator-side merge + explain ---------------------------------------

class ClusterTimeline:
    """Causally-ordered cluster-wide merge of per-node event batches.

    Heartbeat clocks skew; the coordinator normalizes each batch by its
    heartbeat's receive offset (``recv_ms - collected_at_ms``, the
    METRICS_STALE_MS receive-clock discipline) so two stores' decisions
    order by the coordinator's clock, not their own. Within one adjusted
    millisecond the (node, actor_seq) pair breaks ties deterministically.
    Re-delivered batches (raft replay, duplicate heartbeats) dedupe on the
    per-(node, actor) max-seq watermark.
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: [(adjusted_ts_ms, node_id, actor_seq, Event)]
        self._events: List[Tuple[int, str, int, Event]] = []
        #: (node_id, actor) -> highest actor_seq merged
        self._seen: Dict[Tuple[str, str], int] = {}

    def merge(self, node_id: str, events: List[Event],
              offset_ms: int = 0) -> int:
        """Fold one node's batch in; returns how many were new."""
        if not events:
            return 0
        cap = events_max_entries()
        added = 0
        with self._lock:
            for ev in events:
                nid = ev.node_id or node_id
                key = (nid, ev.actor)
                if ev.actor_seq <= self._seen.get(key, -1):
                    continue
                self._seen[key] = ev.actor_seq
                self._events.append(
                    (int(ev.ts_ms + offset_ms), nid, ev.actor_seq, ev))
                added += 1
            if added:
                self._events.sort(key=lambda t: (t[0], t[1], t[2]))
                if len(self._events) > cap:
                    del self._events[: len(self._events) - cap]
        return added

    def events(self, region_id: Optional[int] = None, actor: str = "",
               limit: int = 0) -> List[Event]:
        """Merged timeline, oldest first; filters compose."""
        with self._lock:
            rows = list(self._events)
        out = []
        for adj, nid, _seq, ev in rows:
            if region_id is not None and ev.region_id != int(region_id):
                continue
            if actor and ev.actor != actor:
                continue
            out.append(ev)
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def forget_region(self, region_id: int) -> None:
        rid = int(region_id)
        with self._lock:
            self._events = [t for t in self._events
                            if t[3].region_id != rid]

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._seen.clear()


def live_overrides(rm: Any) -> Dict[str, str]:
    """The currently live knobs on one region, from its freshest metrics
    snapshot (pb RegionMetrics or RegionMetricsSnapshot — duck-typed like
    the capacity plane). Keys are the knob names events carry, values are
    stringified current values — the set ``explain`` must account for."""
    live: Dict[str, str] = {}
    raw = str(getattr(rm, "live_knobs", "") or "")
    if raw:
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = {}
        for knob, value in (parsed.get("tuning") or {}).items():
            live[str(knob)] = str(value)
        adv = parsed.get("advisory_precision")
        if adv:
            live["precision"] = str(adv)
        base = parsed.get("tier_base")
        tier = parsed.get("tier") or getattr(rm, "serving_tier", "")
        if tier and base and tier != base:
            live["tier"] = str(tier)
    else:
        tier = str(getattr(rm, "serving_tier", "") or "")
        if tier and tier not in ("hbm", "hbm_sq8"):
            # without the live_knobs rollup the base rung is unknown;
            # only unambiguously-demoted rungs count as live overrides
            live["tier"] = tier
    lvl = int(getattr(rm, "qos_degrade_level", 0) or 0)
    if lvl > 0:
        live["degrade_level"] = str(lvl)
    if bool(getattr(rm, "device_degraded", False)):
        live["device_degraded"] = "1"
    return live


def explain_region(region_id: int, live: Dict[str, str],
                   events: List[Event]) -> Dict[str, Any]:
    """Account for every live override/rung/advisory on a region as a
    chain of explaining events.

    For each live knob the newest event whose ``knob`` matches (tier
    rungs match the ``tier`` knob regardless of which rung) anchors the
    chain; the chain then walks older same-knob events (the path the
    controller took) plus the events that triggered it — a shed-degrade
    explains a cache stale-rung engage, a capacity advisory explains a
    tier demote. A live knob with NO matching event is an **orphan**: the
    ring/timeline forgot, or a writer bypassed the ledger.
    """
    region_events = [e for e in events if e.region_id == int(region_id)]
    entries: List[Dict[str, Any]] = []
    orphans: List[str] = []
    for knob, value in sorted(live.items()):
        matching = [e for e in region_events if e.knob == knob]
        if not matching:
            orphans.append(knob)
            entries.append({"knob": knob, "value": value,
                            "explained": False, "chain": []})
            continue
        anchor = matching[-1]
        chain = list(matching)
        # cross-controller causality: the anchor's trigger may itself be
        # another controller's decision — surface the newest explaining
        # event per linked actor so the chain reads end to end
        linked = {
            "degrade_level": ("shed",),
            "tier": ("capacity",),
        }.get(knob, ())
        for actor in linked:
            hits = [e for e in region_events
                    if e.actor == actor and e is not anchor
                    and e not in chain]
            if hits:
                chain.append(hits[-1])
        chain.sort(key=lambda e: (e.ts_ms, e.node_id, e.actor_seq))
        # tier rung values pass on any anchor (rungs are a ladder walk —
        # the anchor's `new` IS the live rung when nothing was skipped,
        # and a mid-walk heartbeat is not an integrity violation); every
        # other knob must land exactly where its newest event says, else
        # something moved it afterwards without emitting — an orphan
        # WRITE even though the knob has history
        # str() both sides: local ledger events carry typed old/new
        # (ints, rung names) while pb round-tripped ones carry strings
        explained = knob == "tier" or str(anchor.new) == value
        entries.append({
            "knob": knob,
            "value": value,
            "explained": explained,
            "chain": chain,
        })
        if not explained:
            orphans.append(knob)
    return {
        "region_id": int(region_id),
        "live": dict(sorted(live.items())),
        "entries": entries,
        "orphans": sorted(set(orphans)),
    }
