"""Memory-tier ladder: policy-driven device <-> host <-> mmap serving tiers
(port of dingo_tpu/index/tiering.py).

A region's serving state moves along four rungs, coldest regions first:

  rung 0  hbm       — the declared fp32/bf16 device index (B3/B4 and the
                      other device arms)
  rung 1  hbm_sq8   — the device index rebuilt at the sq8 tier (4x the
                      rows a byte; B3-sq8 for IVF_FLAT, B4-sq8 for FLAT)
  rung 2  host_sq8  — the uint8 codes in host RAM (HostSqSlotStore),
                      served by a paged exact scan over their decode
                      (HostSqFlat): the region's device bytes drop to 0
  rung 3  mmap_sq8  — the same codes as an np.memmap on disk
                      (MmapSqSlotStore): cold pages never fault in

A region declared at sq8 starts at rung 1; binary (HAMMING) regions have
no sq8 codec and never ride the ladder. The host rungs are serving states
of their own, entered only by a counted transition (``tier.demotions``,
the ``tier.current`` gauge, a ``tier`` event): nothing routes a device
region to the host scan because a kernel failed or no card was found.

Policy inputs are the existing planes: demotion on a coordinator capacity
advisory (the ``TIER_DEMOTE`` region command, store/node.py) or when the
allocator's free share falls under ``tier_demote_headroom`` (victim: the
advisory-flagged region, then the coldest by windowed ``vector_search``
QPS, ties toward the most resident bytes outside the heat plane's p99
working set); promotion of a region whose windowed QPS holds above
``tier_promote_qps``, one rung, when the projected footprint leaves the
demote tripwire untouched.

Transitions:

  * rung 0 <-> 1 are engine rebuilds through the one shared arm,
    ``VectorIndexManager.rebuild_at_precision`` (the device recovery's
    re-materialization rides it too);
  * sq8 <-> sq8 moves (rungs 1-3) are byte-exact code transcriptions:
    {ids, codes, codec} snapshotted under the wrapper lock, poured into
    the destination store, then verified;
  * every transcription is digest-gated (obs/integrity.py): the
    destination's 'rows' artifact is recomputed from its live state and
    compared with the source's ledger before the swap; on a mismatch the
    copy is dropped, ``tier.digest_refusals`` counts and the old rung
    keeps serving. The sq8 'rows' artifact digests codes, so the gate is
    exact across the hbm_sq8, host_sq8 and mmap_sq8 rungs;
  * the install is the manager's catch-up protocol: writes that landed
    during the copy replay from the raft log with the same codec
    (identical codes), then the swap under the wrapper lock;
  * host_sq8 -> hbm_sq8 of a FLAT region pours the codes into a fresh
    device store through a staging ring (common/pipeline.StagingRing
    swapped into the store's ``_upload`` hook), so a chunk's upload
    overlaps the previous chunk's write; other families rebuild from the
    engine at sq8 (their device form needs more than the codes);
  * leaving the card runs the retire hook: the rerank cache, the blocked
    mirror, the adjacency mirror and the filter-mask cache are dropped
    under the store's device lock and the HBM ledger forgets the region.

``TIERING`` is one per process, keyed by region id, as in the JAX
package; ``TierRunner`` is the store crontab's ``memory_tier`` job.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dingo_tpu_torch.common.log import get_logger, region_log
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    InvalidParameter,
    drop_device_tensors,
    resolve_precision,
    strip_invalid,
)
from dingo_tpu_torch.index.flat import _SlotStoreIndex
from dingo_tpu_torch.index.slot_store import (
    MIN_CAPACITY,
    HostSqSlotStore,
    MmapSqSlotStore,
    SqSlotStore,
    _next_pow2,
)
from dingo_tpu_torch.ops.distance import Metric, metric_ascending, np_normalize
from dingo_tpu_torch.ops.sq import SqParams

_log = get_logger("index.tiering")

#: ladder rungs, warmest first (label values of tier.demotions/promotions
#: {to} and the heartbeat's serving_tier)
RUNGS = ("hbm", "hbm_sq8", "host_sq8", "mmap_sq8")
RUNG_HBM, RUNG_HBM_SQ8, RUNG_HOST_SQ8, RUNG_MMAP_SQ8 = range(4)

#: slots per decoded page of the host/mmap exact scan
SCAN_PAGE = 8192
#: rows per promotion upload chunk (one staged slot each)
PROMOTE_CHUNK = 4096
#: seconds a retire waits for the searches that picked the replaced index
#: to resolve before it frees that index's device tensors
RETIRE_WAIT_S = 30.0


class TierRefused(RuntimeError):
    """A tier transition was refused before the swap (the destination
    failed the digest gate, the source holds no sq8 codes, or a write
    raced a copy with no log to catch up from). The region keeps serving
    its current rung; a later tick may retry."""


# ---------------------------------------------------------------------------
# Host/mmap serving arm
# ---------------------------------------------------------------------------

class HostSqFlat(_SlotStoreIndex):
    """Serving index of the host_sq8 and mmap_sq8 rungs: a paged exact
    scan over the decoded codes of a HostSqSlotStore or MmapSqSlotStore,
    torch on CPU tensors on the search path (no device work; the intra-op
    threads share a page's decode and product, where the JAX package's
    numpy loop decodes on one core; pages with no valid slot are skipped,
    so a cold mmap'd region never faults its codes in).

    Distances follow the device family's conventions (L2 ascending, IP
    and cosine descending; cosine rows stored normalized, queries
    normalized here), FilterSpec masks compose as on the device, and the
    integrity, quality and heat hooks are the device index's. Scores are
    exact f32 over the decode of the same codes the device sq8 arms read,
    with the store's cached decoded-row norms. The search parameters of
    the float families that ride the ladder (IVF's nprobe, HNSW's ef) do
    not apply to an exact scan and are taken and ignored, where the JAX
    package's HostSqFlat raises on them; any other parameter raises
    TypeError. The scan holds the store's device_lock for its
    whole length, as in the JAX package (writes to the replica wait); the
    longest hold is kept in ``max_lock_ms``."""

    def __init__(self, index_id: int, parameter: IndexParameter, store):
        super().__init__(index_id, parameter)
        if parameter.metric is Metric.HAMMING:
            raise InvalidParameter("host sq8 tier needs a float metric")
        self.store = store
        self.device = (store.device if store is not None
                       else torch.device("cpu"))
        self._precision = "sq8"
        self._rerank_cache = None     # host rung: no device row cache
        self._kernel_metric = parameter.metric
        #: longest device_lock hold of a scan, ms
        self.max_lock_ms = 0.0

    # -- search ------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int,
               filter_spec: Optional[FilterSpec] = None,
               nprobe: Optional[int] = None, ef: Optional[int] = None):
        return self.search_async(queries, topk, filter_spec)()

    def search_async(self, queries: np.ndarray, topk: int,
                     filter_spec: Optional[FilterSpec] = None,
                     nprobe: Optional[int] = None, ef: Optional[int] = None,
                     staged=None):
        """The paged exact scan, run now: host work is the dispatch, and
        the returned thunk hands over the computed results (the serving
        pipeline's dispatch-now/resolve-later convention). `staged` is
        accepted for the wrapper's signature and ignored: nothing is
        uploaded."""
        queries = self._prep_queries(queries)
        if self.metric is Metric.COSINE:
            # rows are stored normalized: the scan below is a plain product
            queries = np_normalize(queries)
        store = self.store
        lease = store.begin_search()
        try:
            self._count_search()
            ids, dists, slots = self._paged_scan(
                queries, int(topk), filter_spec)
        finally:
            lease.release()
        from dingo_tpu_torch.obs.heat import HEAT, heat_enabled
        from dingo_tpu_torch.obs.quality import QUALITY

        if heat_enabled():
            HEAT.register_layout(self.id, "slot", self._heat_layout)
            HEAT.observe(self.id, "slot", slots)
        QUALITY.observe_search(
            self, queries, topk, ids, dists, bucket="tier_host",
            filter_spec=filter_spec)
        results = [strip_invalid(i, d) for i, d in zip(ids, dists)]

        def resolve():
            return results

        return resolve

    def _paged_scan(self, q: np.ndarray, k: int,
                    filter_spec: Optional[FilterSpec]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Running top-k merge over SCAN_PAGE-slot decoded pages. Scores
        are larger-is-better inside (L2 negated) and converted at the end.
        The decode is the host decode's (f32 multiply, f32 add). Returns
        (ids, distances, slots), each [nq, k], -1 padded."""
        store = self.store
        nq = q.shape[0]
        metric = self.metric
        best_s = torch.full((nq, k), -np.inf, dtype=torch.float32)
        best_slot = torch.full((nq, k), -1, dtype=torch.int64)
        with store.device_lock:
            t_lock = time.perf_counter()
            valid = store.valid_h.copy()
            if filter_spec is not None and not filter_spec.is_empty():
                valid &= filter_spec.slot_mask(store.ids_by_slot)
            if store.sq_params is not None and valid.any():
                qt = torch.from_numpy(np.ascontiguousarray(q, np.float32))
                q_sq = (qt * qt).sum(1)
                scale = torch.from_numpy(store.sq_params.scale)
                vmin = torch.from_numpy(store.sq_params.vmin)
                for lo in range(0, store.capacity, SCAN_PAGE):
                    hi = min(store.capacity, lo + SCAN_PAGE)
                    vmask = valid[lo:hi]
                    if not vmask.any():
                        continue   # cold page: never touched (mmap rung)
                    codes = torch.from_numpy(
                        np.ascontiguousarray(store.vecs[lo:hi], np.uint8))
                    deq = codes.to(torch.float32) * scale + vmin
                    if metric is Metric.L2:
                        # |q|^2 - 2 q.x + |x|^2, negated; the norms are the
                        # cached decoded-row norms
                        sqn = torch.from_numpy(store.sqnorm[lo:hi])
                        scores = -(q_sq[:, None] - 2.0 * (qt @ deq.T)
                                   + sqn[None, :])
                    else:   # IP, and cosine over normalized rows/queries
                        scores = qt @ deq.T
                    scores = scores.masked_fill(
                        ~torch.from_numpy(vmask)[None, :], -np.inf)
                    vals, part = torch.topk(scores, min(k, hi - lo), dim=1)
                    cat_s = torch.cat([best_s, vals], dim=1)
                    cat_slot = torch.cat([best_slot, part + lo], dim=1)
                    best_s, sel = torch.topk(cat_s, k, dim=1)
                    best_slot = cat_slot.gather(1, sel)
            best_s, best_slot = best_s.numpy(), best_slot.numpy()
            ids = store.ids_of_slots(best_slot)
            held = (time.perf_counter() - t_lock) * 1e3
        self.max_lock_ms = max(self.max_lock_ms, held)
        order = np.argsort(-best_s, axis=1, kind="stable")
        best_s = np.take_along_axis(best_s, order, axis=1)
        best_slot = np.take_along_axis(best_slot, order, axis=1)
        ids = np.take_along_axis(ids, order, axis=1)
        hit = np.isfinite(best_s)
        ids = np.where(hit, ids, -1)
        best_slot = np.where(hit, best_slot, -1)
        dists = np.where(
            hit, -best_s if metric_ascending(metric) else best_s, 0.0,
        ).astype(np.float32)
        return ids, dists, best_slot

    # -- lifecycle ---------------------------------------------------------
    def save(self, path: str) -> None:
        """TpuFlat's sq8 snapshot form (flat.npz: ids, codes and codec;
        meta precision 'sq8'): a declared-sq8 FLAT region restores through
        TpuFlat.load, and any other region's restore fails its container
        check and the manager rebuilds at the declared tier from the
        engine, the ladder's reset on restart."""
        os.makedirs(path, exist_ok=True)
        snap = self.store.codes_to_host()
        out = {"ids": snap["ids"], "codes": snap["codes"]}
        if self.store.sq_params is not None:
            out["sq_vmin"] = self.store.sq_params.vmin
            out["sq_scale"] = self.store.sq_params.scale
        np.savez(os.path.join(path, "flat.npz"), **out)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(self._save_meta(), f)

    def load(self, path: str) -> None:
        """Reads HostSqFlat.save's directory, the JAX package's included."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._check_meta(meta)
        data = np.load(os.path.join(path, "flat.npz"))
        self.store = HostSqSlotStore(
            self.dimension, self.device,
            capacity=max(len(data["ids"]), 1))
        if "sq_vmin" in data.files:
            self.store.set_params(SqParams(
                np.asarray(data["sq_vmin"], np.float32),
                np.asarray(data["sq_scale"], np.float32)))
            if len(data["ids"]):
                self.store.put_codes(np.asarray(data["ids"], np.int64),
                                     np.asarray(data["codes"], np.uint8))
        self.apply_log_id = meta["apply_log_id"]
        self.write_count_since_save = 0
        self._integrity_on_restore(meta)


# ---------------------------------------------------------------------------
# Tier manager
# ---------------------------------------------------------------------------

class _RegionTier:
    """Per-region ladder state (in memory: a restart rebuilds every region
    at its declared tier, and the state resets with it)."""

    __slots__ = ("rung", "base", "advisory", "mmap_path", "last_change")

    def __init__(self, base: int):
        self.rung = base
        self.base = base
        self.advisory = False         # coordinator demote advisory pending
        self.mmap_path: Optional[str] = None
        self.last_change = 0.0


class TierManager:
    """Per-store ladder actuator: one transition a tick, the worst (or
    best) candidate first."""

    def __init__(self, registry=METRICS):
        self._lock = threading.Lock()
        self._tick_lock = threading.Lock()
        self._regions: Dict[int, _RegionTier] = {}
        self._reg = registry
        #: a synthetic device-memory limit for CPU tests: in-use is then
        #: the HBM ledger's per-region sum over a fresh accounting pass
        self.budget_override: Optional[int] = None
        #: test seam, called with a stage name at fixed points of a
        #: transition: "copied" (between copy and digest verify; ctx is the
        #: destination index), "mid_demote"/"mid_promote" (after verify,
        #: before install; at the start of an engine-rebuild arm)
        self.test_hook: Optional[Callable[..., None]] = None
        self.transitions = 0
        #: the policy inputs of the current tick, recorded into the
        #: transition's event (direct demote()/promote() carry none)
        self._decision_ctx: Optional[Dict[str, Any]] = None

    @staticmethod
    def enabled() -> bool:
        from dingo_tpu_torch.common.config import FLAGS

        try:
            return bool(FLAGS.get("tier_enabled"))
        except KeyError:
            return False

    # -- state -------------------------------------------------------------
    def _base_rung(self, region) -> int:
        param = region.definition.index_parameter
        try:
            return (RUNG_HBM_SQ8
                    if resolve_precision(param) == "sq8" else RUNG_HBM)
        except Exception:  # noqa: BLE001 — unknown tier string
            return RUNG_HBM

    def _state(self, region) -> _RegionTier:
        with self._lock:
            st = self._regions.get(region.id)
            if st is None:
                st = _RegionTier(self._base_rung(region))
                self._regions[region.id] = st
            return st

    def region_tier(self, region_id: int, precision: str = "") -> str:
        """The rung name for the heartbeat. An untracked region reports
        its resident tier (the collector passes the serving index's
        precision: a declared-sq8 region reads hbm_sq8)."""
        with self._lock:
            st = self._regions.get(region_id)
        if st is not None:
            return RUNGS[st.rung]
        return RUNGS[RUNG_HBM_SQ8] if precision == "sq8" else RUNGS[RUNG_HBM]

    def note_advisory(self, region_id: int) -> None:
        """A coordinator TIER_DEMOTE landed: flag the region so that the
        next tick prefers it as the demotion victim (the tick actuates,
        so a burst of commands cannot stack concurrent copies)."""
        with self._lock:
            st = self._regions.get(region_id)
            if st is None:
                st = self._regions[region_id] = _RegionTier(RUNG_HBM)
            st.advisory = True
        self._reg.counter("tier.advisories", region_id=region_id).add(1)

    def forget_region(self, region_id: int) -> None:
        with self._lock:
            self._regions.pop(region_id, None)

    def reset(self) -> None:
        with self._lock:
            self._regions.clear()
        self.budget_override = None
        self.test_hook = None

    def state(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {
                rid: {"rung": RUNGS[st.rung], "base": RUNGS[st.base],
                      "advisory": st.advisory}
                for rid, st in self._regions.items()
            }

    def resident_fraction(self, node) -> float:
        """Device-resident share of the store's index bytes: 1.0 while
        every region is on the card, falling as regions demote."""
        dev = tot = 0
        for region in node.meta.get_all_regions():
            w = region.vector_index_wrapper
            if w is None or w.own_index is None:
                continue
            d = int(w.get_device_memory_size())
            m = int(w.get_memory_size())
            dev += d
            tot += max(d, m)
        return (dev / tot) if tot else 1.0

    # -- policy tick ---------------------------------------------------------
    def tick(self, node) -> Dict[str, Any]:
        """One policy pass: demote one victim when pressed (headroom under
        tier_demote_headroom, or an advisory pending), else promote one
        sustained-hot region a rung when it fits. Returns the transition's
        report ({} when disabled)."""
        if not self.enabled():
            return {}
        with self._tick_lock:
            return self._tick_inner(node)

    def _tick_inner(self, node) -> Dict[str, Any]:
        from dingo_tpu_torch.common.config import FLAGS

        regions = {r.id: r for r in node.meta.get_all_regions()}
        with self._lock:
            for rid in [r for r in self._regions if r not in regions]:
                self._regions.pop(rid, None)
        limit, in_use = self._headroom(node)
        headroom = ((limit - in_use) / limit) if limit else 1.0
        demote_at = float(FLAGS.get("tier_demote_headroom"))
        promote_qps = float(FLAGS.get("tier_promote_qps"))
        qps = {
            rid: self._reg.latency("vector_search",
                                   region_id=rid).windowed_qps()
            for rid in regions
        }
        with self._lock:
            advisory = any(st.advisory for st in self._regions.values())
        self._decision_ctx = {
            "headroom": round(headroom, 4),
            "demote_at": demote_at,
            "promote_qps": promote_qps,
            "advisory": advisory,
        }
        try:
            if headroom < demote_at or advisory:
                victim = self._pick_demote(regions, qps, promote_qps)
                if victim is not None:
                    self._decision_ctx["qps"] = round(
                        qps.get(victim, 0.0), 3)
                    return self.demote(node, regions[victim])
            target = self._pick_promote(regions, qps, promote_qps, limit,
                                        in_use, demote_at)
            if target is not None:
                self._decision_ctx["qps"] = round(qps.get(target, 0.0), 3)
                return self.promote(node, regions[target])
        finally:
            self._decision_ctx = None
        return {"idle": True, "headroom": headroom}

    def _headroom(self, node) -> Tuple[int, int]:
        """(limit, in use) of device memory: the allocator's figures
        (obs/hbm.py), or under budget_override the ledger's per-region
        sum."""
        from dingo_tpu_torch.obs.hbm import HBM

        if self.budget_override is not None:
            for region in node.meta.get_all_regions():
                w = region.vector_index_wrapper
                if w is not None:
                    HBM.account_index(region.id, w)
            state = HBM.state()
            in_use = sum(sum(r["bytes"].values())
                         for r in state["regions"].values())
            return int(self.budget_override), int(in_use)
        stats = HBM.poll_process()
        return (int(stats.get("bytes_limit", 0) or 0),
                int(stats.get("bytes_in_use", 0) or 0))

    def _pick_demote(self, regions, qps, promote_qps) -> Optional[int]:
        """Demotion victim: advisory-flagged first, then the coldest by
        windowed QPS, ties toward the most resident bytes outside the p99
        working set. A region hot enough to promote is never demoted."""
        from dingo_tpu_torch.obs.heat import HEAT, heat_enabled

        heat_on = heat_enabled()
        cands = []
        for rid, region in regions.items():
            st = self._state(region)
            if st.rung >= RUNG_MMAP_SQ8:
                continue     # already at the bottom
            param = region.definition.index_parameter
            if param is None or param.metric is Metric.HAMMING:
                continue     # binary family: no sq8 codec, no ladder
            w = region.vector_index_wrapper
            if w is None or w.own_index is None or not w.ready:
                continue
            r_qps = qps.get(rid, 0.0)
            if r_qps >= promote_qps and not st.advisory:
                continue     # hot region: demoting it would thrash
            waste = 0
            if heat_on:
                stats = HEAT.region_stats(rid)
                if stats:
                    ws = stats.get("ws_bytes") or {}
                    ws99 = int(ws.get(99, ws.get("99", 0)) or 0)
                    resident = int(w.get_device_memory_size()
                                   or w.get_memory_size())
                    waste = max(0, resident - ws99)
            cands.append((not st.advisory, r_qps, -waste, rid))
        if not cands:
            return None
        cands.sort()
        return cands[0][3]

    def _pick_promote(self, regions, qps, promote_qps, limit, in_use,
                      demote_at) -> Optional[int]:
        """The hottest demoted region whose next rung up fits: in use after
        the promotion must stay under the demote tripwire."""
        from dingo_tpu_torch.obs.heat import TIER_BYTES

        best = None
        for rid, region in regions.items():
            st = self._state(region)
            if st.rung <= st.base:
                continue
            r_qps = qps.get(rid, 0.0)
            if r_qps < promote_qps:
                continue
            target = st.rung - 1
            if target <= RUNG_HBM_SQ8 and limit:
                w = region.vector_index_wrapper
                count = w.get_count() if w is not None else 0
                tier = ("sq8" if target == RUNG_HBM_SQ8
                        else resolve_precision(
                            region.definition.index_parameter))
                est = int(count * region.definition.index_parameter.dimension
                          * TIER_BYTES.get(tier, 4.0))
                if in_use + est > limit * (1.0 - demote_at):
                    continue
            if best is None or r_qps > best[0]:
                best = (r_qps, rid)
        return best[1] if best else None

    # -- transitions ---------------------------------------------------------
    def demote(self, node, region) -> Dict[str, Any]:
        """One rung down: 0 -> 1 rebuilds from the engine at sq8; 1 -> 2
        and 2 -> 3 are digest-gated code transcriptions."""
        st = self._state(region)
        st.advisory = False
        if st.rung >= RUNG_MMAP_SQ8:
            return {"region": region.id, "action": "demote",
                    "ok": False, "reason": "already at bottom rung"}
        return self._transition(node, region, st, st.rung + 1, "demote")

    def promote(self, node, region) -> Dict[str, Any]:
        """One rung up: 3 -> 2 transcribes mmap to RAM, 2 -> 1 re-enters
        the card (the staged code pour for FLAT, an sq8 rebuild
        otherwise), 1 -> 0 rebuilds at the declared precision."""
        st = self._state(region)
        if st.rung <= st.base:
            return {"region": region.id, "action": "promote",
                    "ok": False, "reason": "already at base rung"}
        return self._transition(node, region, st, st.rung - 1, "promote")

    def _transition(self, node, region, st: _RegionTier, target: int,
                    kind: str) -> Dict[str, Any]:
        rid = region.id
        src_rung = st.rung
        t0 = time.perf_counter()
        report = {"region": rid, "action": kind,
                  "from": RUNGS[src_rung], "to": RUNGS[target]}
        try:
            if target == RUNG_HBM or (
                    kind == "demote" and target == RUNG_HBM_SQ8):
                ok = self._rebuild_rung(node, region, target, kind)
            elif kind == "promote" and target == RUNG_HBM_SQ8:
                ok = self._promote_to_device(node, region, st)
            else:
                ok = self._transcribe(node, region, st, target, kind)
        except TierRefused as e:
            region_log(_log, rid).warning(
                "tier %s %s->%s refused: %s", kind, RUNGS[src_rung],
                RUNGS[target], e)
            report.update(ok=False, reason=str(e))
            return report
        if not ok:
            report.update(ok=False, reason="rebuild busy")
            return report
        st.rung = target
        st.last_change = time.time()
        self.transitions += 1
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        from dingo_tpu_torch.obs.events import EVENTS

        evidence: Dict[str, Any] = {"ms": round(elapsed_ms, 1)}
        if self._decision_ctx:
            evidence.update(self._decision_ctx)
        EVENTS.emit("tier", rid, "tier", RUNGS[src_rung], RUNGS[target],
                    trigger=kind, evidence=evidence)
        self._reg.counter(
            "tier.demotions" if kind == "demote" else "tier.promotions",
            region_id=rid, labels={"to": RUNGS[target]},
        ).add(1)
        self._reg.gauge("tier.current", region_id=rid).set(float(target))
        self._reg.latency("tier.transition_ms").observe_us(elapsed_ms * 1e3)
        self._publish_mmap_bytes(region)
        region_log(_log, rid).info("tier %s %s -> %s (%.0f ms)", kind,
                                   RUNGS[src_rung], RUNGS[target],
                                   elapsed_ms)
        report.update(ok=True, ms=elapsed_ms)
        return report

    def _publish_mmap_bytes(self, region) -> None:
        w = region.vector_index_wrapper
        store = (getattr(w.own_index, "store", None)
                 if w is not None and w.own_index is not None else None)
        nbytes = (store.disk_bytes()
                  if isinstance(store, MmapSqSlotStore) else 0)
        self._reg.gauge("tier.mmap_bytes", region_id=region.id).set(
            float(nbytes))

    def _hook(self, stage: str, ctx=None) -> None:
        hook = self.test_hook
        if hook is not None:
            hook(stage, ctx)

    @staticmethod
    def _raft_log(node, region_id: int):
        get_node = getattr(node.engine, "get_node", None)
        raft_node = get_node(region_id) if get_node is not None else None
        return raft_node.log if raft_node is not None else None

    # -- transition arms -----------------------------------------------------
    def _rebuild_rung(self, node, region, target: int, kind: str) -> bool:
        """Precision-crossing move: an engine rebuild through the shared
        arm (manager.rebuild_at_precision). The engine is the source of
        truth and the fresh index's ledger is folded as it is built; a
        digest gate against the old index would compare different
        containers by design. The replaced index's device tensors are
        freed (_free_replaced)."""
        self._hook("mid_" + kind)
        precision = "sq8" if target == RUNG_HBM_SQ8 else None
        wrapper = region.vector_index_wrapper
        old = wrapper.own_index
        ok = node.index_manager.rebuild_at_precision(
            region, raft_log=self._raft_log(node, region.id),
            precision=precision)
        if ok:
            self._free_replaced(wrapper, old, region.id)
        return ok

    def _snapshot_source(self, wrapper):
        """The source index's codes, codec, integrity digests and applied
        index, taken under the wrapper lock (writes hold it for their whole
        mutation)."""
        from dingo_tpu_torch.obs.integrity import INTEGRITY

        with wrapper._lock:
            src = wrapper.own_index
            store = getattr(src, "store", None)
            if not isinstance(store, SqSlotStore):
                raise TierRefused(
                    f"source store {type(store).__name__} holds no sq8 "
                    "codes to transcribe")
            snap = store.codes_to_host()
            params = store.sq_params
            digests = INTEGRITY.snapshot_artifacts(src)
            applied = wrapper.apply_log_id
        return src, snap, params, digests, applied

    def _verify_copy(self, src_digests: Dict[str, str], dest,
                     region_id: int) -> None:
        """The digest gate: the destination's 'rows' artifact recomputed
        from its live state against the source's. sq8 'rows' digests codes
        keyed by id, so copies of one state digest identically on every
        sq8 rung and one flipped byte is a refusal. Skipped when the
        integrity plane is off (nothing to compare against)."""
        if not src_digests or "rows" not in src_digests:
            return
        from dingo_tpu_torch.obs.integrity import INTEGRITY

        dest_digests = INTEGRITY.rebuild_from_index(dest)
        if dest_digests.get("rows") != src_digests["rows"]:
            self._reg.counter("tier.digest_refusals",
                              region_id=region_id).add(1)
            raise TierRefused(
                "destination copy failed the rows-digest gate "
                f"(src {src_digests['rows'][:12]}.. != dest "
                f"{dest_digests.get('rows', '<none>')[:12]}..)")

    def _install(self, node, wrapper, dest, region, snap_applied: int
                 ) -> None:
        """Swap the verified destination in through the manager's catch-up
        protocol (writes that landed during the copy replay with the same
        codec). Without a raft log the install refuses if a write raced
        the copy: there is nothing to replay from."""
        raft_log = self._raft_log(node, region.id)
        if raft_log is not None:
            node.index_manager._catch_up_and_install(
                wrapper, dest, region, raft_log)
            return
        with wrapper._lock:
            if wrapper.apply_log_id != snap_applied:
                raise TierRefused(
                    "writes raced the copy and there is no raft log to "
                    "catch up from")
            wrapper.own_index = dest
            wrapper.ready = True
            wrapper.build_error = False
            wrapper.share_index = None

    def _transcribe(self, node, region, st: _RegionTier, target: int,
                    kind: str) -> bool:
        """sq8 -> sq8 move (device -> host, host -> mmap, mmap -> host): a
        byte-exact code transcription, digest-gated, installed with
        catch-up."""
        rid = region.id
        wrapper = region.vector_index_wrapper
        src, snap, params, digests, applied = self._snapshot_source(wrapper)
        dim = region.definition.index_parameter.dimension
        cap = max(MIN_CAPACITY, _next_pow2(len(snap["ids"])))
        device = node.index_manager.device
        if target == RUNG_MMAP_SQ8:
            path = self._mmap_file(rid)
            st.mmap_path = path
            dest_store = MmapSqSlotStore(dim, path, device, capacity=cap)
        else:
            dest_store = HostSqSlotStore(dim, device, capacity=cap)
        dest = HostSqFlat(rid, region.definition.index_parameter, dest_store)
        try:
            if params is not None:
                dest_store.set_params(params)
                if len(snap["ids"]):
                    dest_store.put_codes(
                        np.asarray(snap["ids"], np.int64),
                        np.asarray(snap["codes"], np.uint8))
            dest.apply_log_id = applied
            snap = None
            self._hook("copied", dest)
            self._verify_copy(digests, dest, rid)
            self._hook("mid_" + kind, dest)
            self._install(node, wrapper, dest, region, applied)
        except BaseException:
            if isinstance(dest_store, MmapSqSlotStore):
                dest_store.close(unlink=True)
            raise
        # swapped: retire the source's residency
        src_was_device = st.rung <= RUNG_HBM_SQ8
        if src_was_device:
            self._release_device(wrapper, src, rid)
        src_store = getattr(src, "store", None)
        if isinstance(src_store, MmapSqSlotStore) and not src_was_device:
            src_store.close(unlink=True)
            st.mmap_path = None
        return True

    def _promote_to_device(self, node, region, st: _RegionTier) -> bool:
        """host_sq8 -> hbm_sq8: a FLAT region pours its host codes into a
        fresh device SqSlotStore through a staging ring, then the same
        digest gate and catch-up install. Families whose device form needs
        more than the codes (IVF views, HNSW graphs) rebuild from the
        engine at sq8."""
        from dingo_tpu_torch.index.base import IndexType
        from dingo_tpu_torch.index.factory import new_index
        from dingo_tpu_torch.index.flat import TpuFlat
        from dingo_tpu_torch.index.manager import precision_override

        rid = region.id
        wrapper = region.vector_index_wrapper
        param = region.definition.index_parameter
        raft_log = self._raft_log(node, rid)
        if param.index_type is not IndexType.FLAT:
            # the kill point of the rebuild arms (_rebuild_rung's): the
            # JAX package's IVF and HNSW promotions have none
            self._hook("mid_promote")
            ok = node.index_manager.rebuild_at_precision(
                region, raft_log=raft_log, precision="sq8")
            if ok:
                self._retire_host_source(st)
            return ok
        src, snap, params, digests, applied = self._snapshot_source(wrapper)
        dest = new_index(rid, precision_override(param, "sq8"),
                         device=node.index_manager.device)
        if not (type(dest) is TpuFlat
                and isinstance(dest.store, SqSlotStore)
                and not isinstance(dest.store, HostSqSlotStore)
                and params is not None):
            # an untrained codec: the rebuild arm
            ok = node.index_manager.rebuild_at_precision(
                region, raft_log=raft_log, precision="sq8")
            if ok:
                self._retire_host_source(st, src)
            return ok
        dest.store.set_params(params)
        if len(snap["ids"]):
            dest.store.reserve(_next_pow2(len(snap["ids"])))
            self._staged_put_codes(dest.store,
                                   np.asarray(snap["ids"], np.int64),
                                   np.asarray(snap["codes"], np.uint8))
        snap = None
        dest.apply_log_id = applied
        self._hook("copied", dest)
        self._verify_copy(digests, dest, rid)
        self._hook("mid_promote", dest)
        self._install(node, wrapper, dest, region, applied)
        self._retire_host_source(st, src)
        return True

    @staticmethod
    def _retire_host_source(st: _RegionTier, src=None) -> None:
        """A region that left a host rung for the card: close and unlink
        the mmap file if the old rung was mmap-backed."""
        src_store = getattr(src, "store", None)
        if isinstance(src_store, MmapSqSlotStore):
            src_store.close(unlink=True)
        elif st.mmap_path is not None and os.path.exists(st.mmap_path):
            os.unlink(st.mmap_path)
        st.mmap_path = None

    @staticmethod
    def _staged_put_codes(dstore, ids: np.ndarray, codes: np.ndarray
                          ) -> None:
        """Bulk code ingest through a staging ring: the store's `_upload`
        hook stages each PROMOTE_CHUNK-row chunk into a pinned slot and
        starts its upload, so chunk N's copy is in flight while chunk
        N-1's write runs. A slot is recycled only once a newer upload
        begins: by then the older chunk's write was queued behind its
        copy on the stream, and the ring waits on the slot's copy event
        before refilling it."""
        from dingo_tpu_torch.common.pipeline import StagingRing

        ring = StagingRing(depth=2, device=dstore.device)
        pending: list = []

        def upload(arr):
            while len(pending) >= 2:
                pending.pop(0).release()
            staged = ring.stage(np.ascontiguousarray(arr))
            pending.append(staged)
            return staged.qpad

        dstore._upload = upload         # shadows the store's plain copy
        try:
            for lo in range(0, len(ids), PROMOTE_CHUNK):
                dstore.put_codes(ids[lo:lo + PROMOTE_CHUNK],
                                 codes[lo:lo + PROMOTE_CHUNK])
        finally:
            del dstore._upload
            for staged in pending:
                staged.release()
            ring.close()

    @staticmethod
    def _release_device(wrapper, src, region_id: int) -> None:
        """The retire hook of a region leaving the card: free the source
        index's device tensors (_free_replaced: its rows, rerank cache,
        blocked and adjacency mirrors, filter-mask cache), and have the HBM
        ledger forget the region (its gauges read 0 and its peak goes)."""
        TierManager._free_replaced(wrapper, src, region_id)
        from dingo_tpu_torch.obs.hbm import HBM

        HBM.update_region(region_id, {})   # zero the live owner gauges
        HBM.forget_region(region_id)       # and drop the peaks

    @staticmethod
    def _free_replaced(wrapper, old, region_id: int) -> None:
        """Free the device tensors of an index a transition swapped out,
        once the searches that picked it have resolved (the wrapper's
        pins): the card gets the memory back whatever else still refers to
        the object. The JAX package leaves the arrays to their last
        reference."""
        if old is None or old is wrapper.own_index:
            return
        if not wrapper.wait_unpinned(old, RETIRE_WAIT_S):
            region_log(_log, region_id).warning(
                "tier retire: searches still hold the replaced index after "
                "%.0f s; its device memory goes with its last reference",
                RETIRE_WAIT_S)
            return
        lock = getattr(getattr(old, "store", None), "device_lock", None)
        with (lock if lock is not None else contextlib.nullcontext()):
            drop_device_tensors(old)

    def _mmap_file(self, region_id: int) -> str:
        from dingo_tpu_torch.common.config import FLAGS

        root = str(FLAGS.get("tier_mmap_dir") or "").strip()
        if not root:
            root = os.path.join(tempfile.gettempdir(),
                                f"dingo_tier_{os.getpid()}")
        return os.path.join(root, f"region_{region_id}.codes")


class TierRunner:
    """The store crontab's ``memory_tier`` body: re-applies
    tier_interval_s each tick, gates on tier_enabled, and runs the policy
    tick on one worker thread (a transition is a whole-region copy; the
    crontab thread must not wait behind it)."""

    def __init__(self, node, crontab=None):
        self.node = node
        self._crontab = crontab
        self._worker: Optional[threading.Thread] = None
        self.ticks = 0

    def tick(self) -> None:
        if self._crontab is not None:
            from dingo_tpu_torch.common.config import FLAGS

            self._crontab.set_interval("memory_tier",
                                       float(FLAGS.get("tier_interval_s")))
        if not TierManager.enabled():
            return
        t = self._worker
        if t is not None and t.is_alive():
            return   # the previous transition is still copying

        def work():
            try:
                TIERING.tick(self.node)
            except Exception:  # noqa: BLE001 — maintenance must not die
                _log.exception("tier tick failed")
            self.ticks += 1

        t = threading.Thread(target=work, name="memory_tier", daemon=True)
        self._worker = t
        t.start()


#: process-global ladder (one device; its regions share the memory budget)
TIERING = TierManager()
