"""Quality observability plane: live recall measured in production
(port of dingo_tpu/obs/quality.py).

The observability stack can see latency, launches, and device memory — but every
approximate-search knob (nprobe, ef, rerank factor, precision tier) trades
against an axis none of those instruments measure: **result quality**.
This module closes the loop: for a head-sampled fraction of live searches
(``quality.sample_rate``, the trace-sampling discipline — one float
compare and an early return when 0, nothing allocated, nothing
dispatched), the region re-answers the SAME queries **exactly** with a
shadow scan (ops/shadow.py, the FLAT kernel's math over the region's fp32
reference rows) and scores the served result against the ground truth:

- recall@k        — fraction of true top-k ids the served result found;
- rank-biased overlap (RBO, p=0.9) — order-sensitive agreement, so a
  result that found the right ids in the wrong order still reads worse
  than a perfect one;
- score gap       — relative regret of the served k-th best distance vs
  the true k-th best (how much WORSE, not just how different).

Scoring runs on a dedicated async lane (bounded queue + one worker
thread, overflow drops and counts — the served reply never waits), feeds
windowed estimators with Wilson confidence intervals per (region, index
kind, precision tier, parameter bucket), and publishes the curated
``quality.*`` metrics family. Region rollups ride heartbeats to the
coordinator (RegionMetricsSnapshot.quality_*), surface in ``cluster top``
(RECALL column), Prometheus, and flight bundles.

Ground truth sources, per index tier:
- fp32 SlotStore indexes (FLAT / IVF_FLAT / HNSW fp32, IVF_PQ's device
  store) — the index's own rows ARE the fp32 reference: zero extra
  memory, the shadow scan reads them under the store's lease/lock
  discipline.
- quantized tiers (bf16 / sq8) — the oracle keeps a private fp32 mirror
  (a SlotStore fed the ORIGINAL rows at write time via the index hooks),
  so the estimate includes quantization loss — the precision knob must
  never look free to the SLO tuner. A mirror attached mid-life backfills
  from the store's decoded rows (the best reconstruction available) until
  overwritten by fresh writes.
- host-vector stores (IVF_PQ host mode) — numpy scan over the host rows.

Consistency note: a sample scored while writes are in flight is judged
against the FRESHEST reference rows, which may be slightly newer than
the store state the search actually scanned — a served result can be
"wrong" only about rows that changed in the race window, so the skew is
bounded by write rate x scoring latency and washes out in the windowed
estimate (the same eventual-consistency stance the metrics plane takes).

The closed-loop controller that acts on these estimates lives in
obs/tuner.py.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.ops.distance import Metric, metric_ascending

_log = get_logger("obs.quality")

#: queries scored per sampled batch — a fixed cap so the shadow kernel
#: compiles for ONE batch bucket (pow2-padded) and the estimator's cost
#: per sample is bounded regardless of serving batch size
SHADOW_MAX_QUERIES = 16

#: pending shadow jobs; overflow drops (and counts) — the async lane must
#: never apply backpressure to the serving path
QUEUE_MAX = 64

#: rank-biased overlap persistence (Webber et al.: top-weighted, p=0.9
#: puts ~86% of the weight in the first 10 ranks)
RBO_P = 0.9

#: Wilson interval z for the 95% CI the tuner compares against the SLO
WILSON_Z = 1.96


# ---------------------------------------------------------------------------
# host scoring math (pure, unit-testable)
# ---------------------------------------------------------------------------

def recall_hits(served_ids: np.ndarray, gt_ids: np.ndarray) -> Tuple[int, int]:
    """(hits, trials) for one query: |served ∩ truth| over |truth|
    (-1 padding excluded on both sides). Trials count the TRUE neighbors,
    so a region with fewer than k rows still scores 1.0 when everything
    was found."""
    gt = {int(i) for i in gt_ids if i >= 0}
    if not gt:
        return 0, 0
    served = {int(i) for i in served_ids if i >= 0}
    return len(served & gt), len(gt)


def rank_biased_overlap(served_ids: np.ndarray, gt_ids: np.ndarray,
                        p: float = RBO_P) -> float:
    """Truncated RBO at the list depth: order-sensitive agreement in
    [0, 1], weight p^(d-1) on prefix depth d, normalized over the
    truncated depth so identical lists score exactly 1.0."""
    a = [int(i) for i in served_ids if i >= 0]
    b = [int(i) for i in gt_ids if i >= 0]
    depth = max(len(a), len(b))
    if depth == 0:
        return 1.0
    num = den = 0.0
    sa: set = set()
    sb: set = set()
    for d in range(1, depth + 1):
        if d <= len(a):
            sa.add(a[d - 1])
        if d <= len(b):
            sb.add(b[d - 1])
        w = p ** (d - 1)
        num += w * (len(sa & sb) / d)
        den += w
    return num / den


def score_gap(served_dists: np.ndarray, gt_dists: np.ndarray,
              ascending: bool) -> float:
    """Relative regret of the served k-th best vs the true k-th best wire
    distance (>= 0; 0 = the served tail is as good as the exact tail).
    Distributions of this gap separate 'missed a near-duplicate' from
    'wandered into the wrong cluster' at equal recall."""
    sd = [float(d) for d in served_dists if math.isfinite(d)]
    gd = [float(d) for d in gt_dists if math.isfinite(d)]
    if not sd or not gd:
        return 0.0
    s_kth, g_kth = sd[-1], gd[-1]
    regret = (s_kth - g_kth) if ascending else (g_kth - s_kth)
    return max(0.0, regret / max(abs(g_kth), 1e-9))


def wilson_interval(hits: int, trials: int,
                    z: float = WILSON_Z) -> Tuple[float, float]:
    """Wilson score interval for hits/trials — well-behaved at p near 1
    (where recall SLOs live) and at small n, unlike the normal
    approximation which collapses to a zero-width band at p=1."""
    if trials <= 0:
        return 0.0, 1.0
    n = float(trials)
    phat = hits / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (phat + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(
        phat * (1.0 - phat) / n + z2 / (4.0 * n * n)
    )
    # at phat in {0, 1} the bound on that side is EXACTLY the endpoint;
    # the float evaluation above lands an ulp inside it
    lo = 0.0 if hits == 0 else max(0.0, center - half)
    hi = 1.0 if hits == trials else min(1.0, center + half)
    return lo, hi


def _shadow_batch_pad(q: np.ndarray) -> np.ndarray:
    """Pow2-pad the shadow batch with the SERVING path's own padding
    (index/flat._pad_batch — one source of truth for the batch ladder,
    lazily imported to keep this module cycle-free from the index
    package)."""
    from dingo_tpu_torch.index.flat import _pad_batch

    return _pad_batch(q)


def _k_bucket(k: int) -> int:
    """Round shadow k up the {1,1.5}x-pow2 ladder (the serving shape
    discipline) so the shadow kernel compiles once per k bucket."""
    from dingo_tpu_torch.index.ivf_layout import shape_bucket

    return shape_bucket(int(k))


# ---------------------------------------------------------------------------
# ground-truth oracle
# ---------------------------------------------------------------------------

class ShadowOracle:
    """Exact top-k answer source for one region. Three arms:

    - ``store``  — the index's own fp32 SlotStore rows (zero extra state);
    - ``mirror`` — a private fp32 SlotStore fed original rows at write
      time (quantized tiers), backfilled from decoded rows on attach;
    - ``host``   — numpy scan over a HostSlotStore's rows.
    """

    def __init__(self, index=None, dim: int = 0, metric=None,
                 device=None):
        self.metric = metric if metric is not None else (
            index.metric if index is not None else Metric.L2
        )
        self._index = weakref.ref(index) if index is not None else None
        self._mirror = None
        #: serializes mirror mutations: write hooks run on serving
        #: threads while the deferred backfill runs on the async lane
        self._mu = threading.Lock()
        #: backfill-of-preexisting-rows still owed (mirror arm, see
        #: ensure_backfilled); _fresh = ids touched by hooks SINCE attach
        #: — the backfill must never clobber an original with a decode
        self._pending_backfill = False
        self._fresh: set = set()
        self.mode = "mirror"
        if index is not None:
            store = index.store
            import torch

            from dingo_tpu_torch.index.slot_store import (
                HostSlotStore,
                SqSlotStore,
            )

            if isinstance(store, HostSlotStore):
                self.mode = "host"
                return
            if not isinstance(store, SqSlotStore) and (
                store.dtype == torch.float32
            ):
                self.mode = "store"
                return
            dim = index.dimension
            device = store.device
        # quantized tier (or a standalone reference): private fp32 mirror
        # on the store's device. blocked=False: the mirror is scanned by
        # the plain shadow scan only, so a dimension-blocked copy would be
        # pure waste. Created EMPTY: rows the store already holds are owed
        # as a DEFERRED backfill (ensure_backfilled, run on the async lane
        # before the first scoring) so attaching mid-life on a large store
        # never stalls the write/serving thread that triggered it.
        import torch

        from dingo_tpu_torch.index.slot_store import SlotStore

        if index is None:
            # a standalone reference lives on the card unless the caller
            # asks for the CPU (raises DeviceUnavailable without a card)
            from dingo_tpu_torch.common.device import resolve_device

            device = resolve_device(device)
        self._mirror = SlotStore(dim, device, blocked=False,
                                 dtype=torch.float32)
        self._pending_backfill = index is not None and len(index.store) > 0

    # -- write feed (mirror arm only; others read the live store) ----------
    def observe_write(self, ids: np.ndarray, rows: np.ndarray) -> None:
        if self._mirror is None:
            return
        ids = np.asarray(ids, np.int64)
        with self._mu:
            self._mirror.put(ids, np.asarray(rows, np.float32))
            if self._pending_backfill:
                self._fresh.update(int(i) for i in ids)

    def observe_delete(self, ids: np.ndarray) -> None:
        if self._mirror is None:
            return
        ids = np.asarray(ids, np.int64)
        with self._mu:
            self._mirror.remove_slots(ids)
            if self._pending_backfill:
                self._fresh.update(int(i) for i in ids)

    def ensure_backfilled(self) -> None:
        """Fill the mirror with the store's pre-attach rows (decoded —
        the best reconstruction available) the first time anyone needs to
        SCORE against it. Runs on the async lane; rows the write hooks
        touched since attach keep their original (or deleted) state."""
        with self._mu:
            if not self._pending_backfill:
                return
        idx = self._index() if self._index is not None else None
        if idx is None:
            with self._mu:
                self._pending_backfill = False
                self._fresh.clear()
            return
        snap = idx.store.to_host()          # OUTSIDE _mu: slow download
        with self._mu:
            keep = ~np.isin(snap["ids"],
                            np.fromiter(self._fresh, np.int64,
                                        len(self._fresh)))
            if keep.any():
                self._mirror.reserve(int(keep.sum()))
                self._mirror.put(
                    snap["ids"][keep],
                    np.asarray(snap["vectors"], np.float32)[keep],
                )
            self._pending_backfill = False
            self._fresh.clear()

    # -- exact answers ------------------------------------------------------
    def _ref_store(self):
        if self._mirror is not None:
            return self._mirror
        idx = self._index() if self._index is not None else None
        return idx.store if idx is not None else None

    def exact_topk(self, queries: np.ndarray, k: int, filter_spec=None
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(ids [b, k], wire distances [b, k]) of the exact answer, -1/inf
        padded; None when the reference store is gone (index deleted).

        `filter_spec` restricts the ground truth to the SAME candidate
        set the served search was allowed (compiled id-based against the
        reference store's own slot space, so it works identically for
        store/mirror/host arms) — a filtered search scored against
        unfiltered truth would read as a recall collapse proportional to
        the filter's selectivity."""
        store = self._ref_store()
        if store is None:
            return None
        queries = np.asarray(queries, np.float32)
        b = queries.shape[0]
        filtered = filter_spec is not None and not filter_spec.is_empty()
        if self.mode == "host":
            return self._exact_host(store, queries, k, filter_spec)
        from dingo_tpu_torch.common.device import upload
        from dingo_tpu_torch.ops.distance import widen_int_rows
        from dingo_tpu_torch.ops.shadow import shadow_exact_topk

        kb = _k_bucket(k)
        qpad = upload(_shadow_batch_pad(queries), store.device)
        # filter mask compiles in numpy OUTSIDE the device lock (the
        # serving paths' discipline); same [capacity] bool shape as the
        # plain validity mask
        np_mask = filter_spec.slot_mask(store.ids_by_slot) if filtered \
            else None
        lease = store.begin_search()
        try:
            with store.device_lock:
                mask = upload(np_mask, store.device) \
                    if np_mask is not None else store.device_mask()
                dists, slots = shadow_exact_topk(
                    widen_int_rows(store.vecs), store.sqnorm, mask, qpad,
                    k=kb, metric=self.metric,
                )
            dists_h = dists.cpu().numpy()
            slots_h = slots.cpu().numpy()
            ids = store.ids_of_slots(slots_h[:b, :k])
        finally:
            lease.release()
        return ids, np.asarray(dists_h[:b, :k], np.float32)

    def _exact_host(self, store, queries: np.ndarray, k: int,
                    filter_spec=None):
        vecs = store.host_rows(slice(None))
        valid = store.valid_h
        if filter_spec is not None and not filter_spec.is_empty():
            valid = valid & filter_spec.slot_mask(store.ids_by_slot)
        if self.metric is Metric.L2:
            scores = -(
                (queries ** 2).sum(1)[:, None]
                - 2.0 * queries @ vecs.T
                + np.asarray(store.sqnorm)[None, :]
            )
        elif self.metric is Metric.COSINE:
            # rows stored normalized (write-side prep): IP is cosine
            scores = queries @ vecs.T
        else:
            scores = queries @ vecs.T
        scores = np.where(valid[None, :], scores, -np.inf)
        kk = min(k, scores.shape[1])
        part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        vals = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-vals, axis=1)
        slots = np.take_along_axis(part, order, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        ids = store.ids_of_slots(slots)
        ids = np.where(np.isneginf(vals), -1, ids)
        dists = -vals if metric_ascending(self.metric) else vals
        if kk < k:
            ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
            dists = np.pad(dists, ((0, 0), (0, k - kk)),
                           constant_values=np.inf)
        return ids, np.asarray(dists, np.float32)


# ---------------------------------------------------------------------------
# windowed estimator
# ---------------------------------------------------------------------------

class WindowedEstimator:
    """Sliding-window recall/RBO/score-gap aggregate with a Wilson CI.

    Each scored sample contributes (hits, trials) Bernoulli evidence —
    recall@k over n queries is hits/(found slots), so the CI narrows with
    BOTH more sampled queries and larger k. Entries older than
    ``quality.window_s`` age out at read time."""

    def __init__(self):
        self._lock = threading.Lock()
        #: (wall_ts, queries, hits, trials, rbo_sum, gaps tuple)
        self._entries: deque = deque()

    @staticmethod
    def _window_s() -> float:
        from dingo_tpu_torch.common.config import FLAGS

        try:
            return float(FLAGS.get("quality_window_s"))
        except KeyError:
            return 60.0

    def add(self, queries: int, hits: int, trials: int, rbo_sum: float,
            gaps: List[float]) -> None:
        now = time.time()
        window = self._window_s()
        with self._lock:
            self._entries.append(
                (now, queries, hits, trials, rbo_sum, tuple(gaps))
            )
            while self._entries and now - self._entries[0][0] > window:
                self._entries.popleft()

    def reset(self) -> None:
        """Drop the window — the tuner calls this after a knob step so
        pre-step evidence can't vote on the post-step configuration."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> Optional[Dict[str, float]]:
        now = time.time()
        window = self._window_s()
        with self._lock:
            while self._entries and now - self._entries[0][0] > window:
                self._entries.popleft()
            entries = list(self._entries)
        if not entries:
            return None
        queries = sum(e[1] for e in entries)
        hits = sum(e[2] for e in entries)
        trials = sum(e[3] for e in entries)
        rbo_sum = sum(e[4] for e in entries)
        gaps = sorted(g for e in entries for g in e[5])
        lo, hi = wilson_interval(hits, trials)
        pick = (lambda p: gaps[min(len(gaps) - 1,
                                   int(p * len(gaps)))]) if gaps else (
            lambda p: 0.0)
        return {
            "recall": hits / trials if trials else 0.0,
            "ci_low": lo,
            "ci_high": hi,
            "rbo": rbo_sum / queries if queries else 0.0,
            "gap_p50": pick(0.50),
            "gap_p99": pick(0.99),
            "hits": hits,
            "queries": queries,
            "trials": trials,
            "newest_ts": entries[-1][0],
            "oldest_ts": entries[0][0],
        }


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Sample:
    region_id: int
    kind: str
    precision: str
    bucket: str
    metric: Any
    topk: int
    queries: np.ndarray
    served_ids: np.ndarray
    served_dists: Optional[np.ndarray]
    #: the served search's filter (None = unfiltered): ground truth is
    #: computed under the SAME candidate restriction
    filter_spec: Any = None


#: index kinds with quality hooks (binary/diskann/bruteforce have no
#: float shadow-scan semantics here)
_SUPPORTED_KINDS = {"flat", "ivf_flat", "ivf_pq", "hnsw"}


class QualityPlane:
    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        #: region_id -> (weakref to index or None, ShadowOracle)
        self._oracles: Dict[int, Tuple[Optional[weakref.ref],
                                       ShadowOracle]] = {}
        #: (region, kind, precision, bucket) -> estimator
        self._estimators: Dict[Tuple, WindowedEstimator] = {}
        self._region_keys: Dict[int, set] = {}
        self._queue: deque = deque()
        self._cond = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        self._busy = 0
        self._rng = random.Random(0x51AD0)

    # -- gating -------------------------------------------------------------
    @staticmethod
    def sample_rate() -> float:
        from dingo_tpu_torch.common.config import FLAGS

        try:
            return float(FLAGS.get("quality_sample_rate"))
        except KeyError:   # registry not populated (unit contexts)
            return 0.0

    @staticmethod
    def _supported(index) -> bool:
        try:
            return index.index_type.value in _SUPPORTED_KINDS
        except Exception:  # noqa: BLE001 — duck-typed test fakes
            return False

    def _oracle_for(self, index) -> ShadowOracle:
        oracle = self._attached_oracle(index)
        if oracle is not None:
            return oracle
        # construct OUTSIDE the plane lock: a mid-life attach on a large
        # quantized store backfills its fp32 mirror from a full store
        # download — holding the (shared, also-the-async-lane's) lock
        # across that would stall every other region's hooks and the
        # scoring worker for the duration
        oracle = ShadowOracle(index)
        with self._lock:
            cur = self._oracles.get(index.id)
            if cur is not None and cur[0] is not None and cur[0]() is index:
                return cur[1]      # raced with another creator: keep it
            self._oracles[index.id] = (weakref.ref(index), oracle)
        return oracle

    def _attached_oracle(self, index) -> Optional[ShadowOracle]:
        """The index's oracle ONLY if already attached — never creates."""
        with self._lock:
            cur = self._oracles.get(index.id)
        if cur is not None and cur[0] is not None and cur[0]() is index:
            return cur[1]
        return None

    def _write_oracle(self, index) -> Optional[ShadowOracle]:
        """Oracle the write hooks should feed. An ALREADY-ATTACHED mirror
        keeps syncing even while sampling is momentarily off — toggling
        `quality.sample_rate` 1 -> 0 -> 1 around an incident must not
        leave the ground-truth mirror silently stale (deleted rows
        resurrected, fresh rows missing) and send the tuner chasing a
        phantom recall drop. Only CREATION is gated on the rate."""
        if not self._oracles and self.sample_rate() <= 0.0:
            return None              # common case: plane never engaged
        oracle = self._attached_oracle(index)
        if oracle is None and self.sample_rate() > 0.0:
            oracle = self._oracle_for(index)
        return oracle

    # -- index hooks ----------------------------------------------------------
    def observe_write(self, index, ids: np.ndarray,
                      rows: np.ndarray) -> None:
        """Write-path hook (index upsert, AFTER the store put): keeps the
        quantized tiers' fp32 mirror in sync. No-ops entirely while the
        plane was never engaged for this index."""
        if not self._supported(index):
            return
        try:
            oracle = self._write_oracle(index)
            if oracle is not None:
                oracle.observe_write(ids, rows)
        except Exception:  # noqa: BLE001 — observability must never
            _log.exception("quality observe_write failed")   # break writes

    def observe_delete(self, index, ids: np.ndarray) -> None:
        if not self._supported(index):
            return
        try:
            oracle = self._write_oracle(index)
            if oracle is not None:
                oracle.observe_delete(ids)
        except Exception:  # noqa: BLE001
            _log.exception("quality observe_delete failed")

    def observe_search(self, index, queries: np.ndarray, topk: int,
                       ids: np.ndarray, dists: Optional[np.ndarray],
                       bucket: str = "", filter_spec=None) -> None:
        """Search-resolve hook: head-sample this served batch for shadow
        scoring. The zero-rate path is one float compare; a sampled batch
        pays two small array copies and a queue append — scoring (and,
        on a first-ever sample, oracle attach + mirror backfill) happens
        on the async lane. Filtered searches carry their FilterSpec so
        the ground truth is restricted identically."""
        rate = self.sample_rate()
        if rate <= 0.0 or not self._supported(index):
            return
        if self._rng.random() >= rate:
            return
        try:
            nq = min(int(np.asarray(queries).shape[0]), SHADOW_MAX_QUERIES)
            sample = _Sample(
                region_id=index.id,
                kind=index.index_type.value,
                precision=getattr(index, "_precision", "fp32"),
                bucket=bucket,
                metric=index.metric,
                topk=int(topk),
                queries=np.array(queries[:nq], np.float32, copy=True),
                served_ids=np.array(ids[:nq], np.int64, copy=True),
                served_dists=(np.array(dists[:nq], np.float32, copy=True)
                              if dists is not None else None),
                filter_spec=(filter_spec if filter_spec is not None
                             and not filter_spec.is_empty() else None),
            )
            target = weakref.ref(index)
        except Exception:  # noqa: BLE001
            _log.exception("quality observe_search failed")
            return
        with self._cond:
            if len(self._queue) >= QUEUE_MAX:
                self.registry.counter(
                    "quality.dropped", region_id=index.id).add(1)
                return
            self._queue.append((sample, target))
            self._ensure_worker()
            self._cond.notify()

    # -- direct reference API (indexes without hooks, tests) -----------------
    def install_reference(self, region_id: int, ids: np.ndarray,
                          rows: np.ndarray, metric=Metric.L2,
                          device=None) -> None:
        """Install a standalone fp32 reference for a region served by an
        index without hooks (mesh-sharded paths): the oracle owns a
        mirror built from the given rows, on the card unless `device`
        says otherwise."""
        oracle = ShadowOracle(dim=int(np.asarray(rows).shape[1]),
                              metric=metric, device=device)
        oracle._mirror.reserve(len(ids))
        oracle.observe_write(ids, rows)
        with self._lock:
            self._oracles[region_id] = (None, oracle)

    def score_direct(self, region_id: int, queries: np.ndarray,
                     served_ids: np.ndarray, topk: int,
                     served_dists: Optional[np.ndarray] = None,
                     kind: str = "flat", precision: str = "fp32",
                     bucket: str = "") -> Optional[Dict[str, float]]:
        """Synchronous shadow scoring against an installed reference (or
        a hook-registered oracle). Feeds the same estimators/metrics as
        the async lane; returns this call's own scores."""
        with self._lock:
            cur = self._oracles.get(region_id)
        if cur is None:
            return None
        oracle = cur[1]
        oracle.ensure_backfilled()
        sample = _Sample(
            region_id=region_id, kind=kind, precision=precision,
            bucket=bucket, metric=oracle.metric, topk=int(topk),
            queries=np.asarray(queries, np.float32)[:SHADOW_MAX_QUERIES],
            served_ids=np.asarray(served_ids, np.int64)[:SHADOW_MAX_QUERIES],
            served_dists=(np.asarray(served_dists, np.float32)
                          [:SHADOW_MAX_QUERIES]
                          if served_dists is not None else None),
        )
        return self._score(sample, oracle)

    # -- async lane ----------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._worker = threading.Thread(
            target=self._run, name="quality-shadow", daemon=True
        )
        self._worker.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                sample, target = self._queue.popleft()
                self._busy += 1
            try:
                # resolve the oracle HERE: a first-ever sample's oracle
                # attach (potentially a full mirror backfill) runs on
                # this lane, never on the serving thread that sampled
                if isinstance(target, weakref.ref):
                    index = target()
                    oracle = self._oracle_for(index) \
                        if index is not None else None
                else:
                    oracle = target
                if oracle is not None:
                    # mirror arm owes pre-attach rows before it can judge
                    # anyone (no-op bool check on every later sample)
                    oracle.ensure_backfilled()
                    self._score(sample, oracle)
            except Exception:  # noqa: BLE001 — the lane must survive
                _log.exception("shadow scoring failed")
            finally:
                # the lane waits for its next sample holding nothing: a
                # local left bound to the last index would keep a retired
                # index (and its device memory) alive
                sample = target = index = oracle = None
                with self._cond:
                    self._busy -= 1
                    self._cond.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued shadow job has been scored (tests,
        the smoke, and the tuner's deterministic drive)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._busy:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._cond.wait(timeout=remain)
        return True

    # -- scoring + publication ------------------------------------------------
    def _score(self, s: _Sample,
               oracle: ShadowOracle) -> Optional[Dict[str, float]]:
        answer = oracle.exact_topk(s.queries, s.topk,
                                   filter_spec=s.filter_spec)
        if answer is None:
            return None
        gt_ids, gt_dists = answer
        self.registry.counter(
            "quality.shadow_scans", region_id=s.region_id).add(1)
        asc = metric_ascending(s.metric)
        hits = trials = 0
        rbo_sum = 0.0
        gaps: List[float] = []
        nq = len(s.queries)
        for qi in range(nq):
            h, t = recall_hits(s.served_ids[qi], gt_ids[qi])
            hits += h
            trials += t
            rbo_sum += rank_biased_overlap(s.served_ids[qi], gt_ids[qi])
            if s.served_dists is not None:
                gaps.append(score_gap(
                    s.served_dists[qi], gt_dists[qi], asc))
        key = (s.region_id, s.kind, s.precision, s.bucket)
        est = self._estimator(key)
        est.add(nq, hits, trials, rbo_sum, gaps)
        self.registry.counter(
            "quality.samples", region_id=s.region_id).add(nq)
        self._publish(key, est.stats())
        self._publish_region(s.region_id)
        lo, hi = wilson_interval(hits, trials)
        return {
            "recall": hits / trials if trials else 0.0,
            "ci_low": lo,
            "ci_high": hi,
            "rbo": rbo_sum / nq if nq else 0.0,
            "queries": nq,
        }

    def _estimator(self, key: Tuple) -> WindowedEstimator:
        with self._lock:
            est = self._estimators.get(key)
            if est is None:
                est = self._estimators[key] = WindowedEstimator()
                self._region_keys.setdefault(key[0], set()).add(key)
            return est

    def _publish(self, key: Tuple, st: Optional[Dict[str, float]]) -> None:
        if st is None:
            return
        region_id, kind, precision, bucket = key
        labels = {"kind": kind, "precision": precision,
                  "bucket": bucket or "-"}
        g = self.registry.gauge
        g("quality.recall", region_id, labels).set(round(st["recall"], 6))
        g("quality.recall_ci_low", region_id, labels).set(
            round(st["ci_low"], 6))
        g("quality.recall_ci_high", region_id, labels).set(
            round(st["ci_high"], 6))
        g("quality.rbo", region_id, labels).set(round(st["rbo"], 6))
        g("quality.score_gap_p50", region_id, labels).set(
            round(st["gap_p50"], 6))
        g("quality.score_gap_p99", region_id, labels).set(
            round(st["gap_p99"], 6))

    def _publish_region(self, region_id: int) -> None:
        st = self.region_estimate(region_id)
        if st is None:
            return
        g = self.registry.gauge
        g("quality.recall", region_id).set(round(st["recall"], 6))
        g("quality.recall_ci_low", region_id).set(round(st["ci_low"], 6))
        g("quality.recall_ci_high", region_id).set(round(st["ci_high"], 6))
        g("quality.rbo", region_id).set(round(st["rbo"], 6))
        g("quality.window_queries", region_id).set(st["queries"])

    # -- read side ------------------------------------------------------------
    def region_estimate(self, region_id: int) -> Optional[Dict[str, float]]:
        """Windowed rollup across the region's (kind, precision, bucket)
        estimators — what the heartbeat, `cluster top`, and the SLO tuner
        read. None when nothing was scored inside the window."""
        with self._lock:
            keys = list(self._region_keys.get(region_id, ()))
            ests = [self._estimators[k] for k in keys]
        parts = [st for st in (e.stats() for e in ests) if st is not None]
        if not parts:
            return None
        hits = sum(p["hits"] for p in parts)
        trials = sum(p["trials"] for p in parts)
        queries = sum(p["queries"] for p in parts)
        lo, hi = wilson_interval(hits, trials)
        return {
            "recall": hits / trials if trials else 0.0,
            "ci_low": lo,
            "ci_high": hi,
            "rbo": (sum(p["rbo"] * p["queries"] for p in parts) / queries
                    if queries else 0.0),
            "gap_p99": max(p["gap_p99"] for p in parts),
            "queries": queries,
            "trials": trials,
            "newest_ts": max(p["newest_ts"] for p in parts),
            "oldest_ts": min(p["oldest_ts"] for p in parts),
        }

    def reset_region(self, region_id: int) -> None:
        """Clear the region's estimator windows (the tuner's post-step
        contract: evidence gathered under the old knob setting must not
        judge the new one)."""
        with self._lock:
            ests = [self._estimators[k]
                    for k in self._region_keys.get(region_id, ())]
        for e in ests:
            e.reset()

    def forget_region(self, region_id: int) -> None:
        """Drop the region's oracle (and, for quantized tiers, its full
        fp32 mirror) + estimator state when the store no longer hosts it
        — the quality-plane leg of the collector's retire loop, next to
        registry.drop_region / HBM.forget_region."""
        with self._lock:
            self._oracles.pop(region_id, None)
            for key in self._region_keys.pop(region_id, ()):
                self._estimators.pop(key, None)

    def clear(self) -> None:
        """Forget every oracle/estimator (tests)."""
        with self._cond:
            self._queue.clear()
        with self._lock:
            self._oracles.clear()
            self._estimators.clear()
            self._region_keys.clear()


QUALITY = QualityPlane()
