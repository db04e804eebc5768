"""TpuIvfFlat: inverted-file index (port of dingo_tpu/index/ivf_flat.py,
float metrics, in the fp32, bf16 and sq8 precision tiers), and
TpuBinaryIvfFlat, its hamming counterpart over bit-packed rows.

  train  — Lloyd k-means on the device (ops/kmeans.py) over a sampled
           subset, deterministic farthest-first init.
  layout — rows live in a flat SlotStore; a bucketed view [B, cap_list, d]
           of fixed-width spill buckets (ivf_layout.py) is maintained
           incrementally: upserts append into free rows of the assigned
           list's tail bucket, deletes flip rows invalid, and a deferred
           compaction restores the dense layout.
  search — [b, nlist] centroid scores -> top-nprobe coarse lists ->
           virtual bucket probes -> kernel B3 (ops/kernel_ivf_pruned.py),
           the dimension-blocked early-pruning scan, when the view carries
           per-block norms (_bucket_bsq: ivf_prune_scan on and a dimension
           that blocks), else kernel B2 (ops/kernel_ivf.py); both read only
           the probed buckets. The JAX package's XLA arm (a per-rank
           gather + einsum + running top-k) serves k > 64 and the
           crossover's off side.
  tiers  — the view keeps the store's dtype: bf16 rows (B3/B2 widen them,
           the query stays f32) or sq8 codes with norms of their f32
           decode (B3 decodes them; unpruned sq8 and sq8 + COSINE take the
           plain arm, ivf_scan_scores with the codec). With a rerank cache
           the scan over-fetches max(topk, topk * factor) and the
           shortlist is reranked on the device under the same lock.

  binary — TpuBinaryIvfFlat keeps the binary family's int8 +/-1 store
           (flat.BinaryPm1Mixin): float k-means over +/-1 space with float
           centroids, probes by float L2, and the list scan on the plain
           arm as a +/-1 inner product (int8 buckets widen after the
           gather, as in the JAX package), converted to hamming at
           resolve. HAMMING is outside the kernels' route, and int8 views
           carry no pruning metadata (JAX ivf_flat.py:722, :878-885).

An untrained index raises NotTrained, the reader's brute-force contract.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from dingo_tpu_torch.common.config import (
    FLAGS,
    ivf_kernel_enabled,
    prune_scan_enabled,
)
from dingo_tpu_torch.common.device import resolve_device, upload
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    InvalidParameter,
    NotTrained,
    SearchResult,
    VectorIndex,
    resolve_precision,
    strip_invalid,
)
from dingo_tpu_torch.index.flat import (
    BinaryPm1Mixin,
    _SlotStoreIndex,
    _check_binary_dimension,
    _new_tier_store,
    _resolve_train_cap,
    _staged_or_upload,
    integrity_mutation,
)
from dingo_tpu_torch.index.ivf_layout import (
    MutableIvfView,
    expand_probes,
    shape_bucket,
)
from dingo_tpu_torch.index.slot_store import KERNEL_DTYPES
from dingo_tpu_torch.ops import kernel_ivf, kernel_ivf_pruned
from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.ops.blocked import (
    block_sqnorms,
    bucket_block_sqnorms,
    resolve_dim_block,
)
from dingo_tpu_torch.ops.distance import (
    Metric,
    device_wait_span,
    metric_ascending,
    np_normalize,
    scores_to_distances,
    squared_norms,
)
from dingo_tpu_torch.ops.kmeans import (
    MAX_POINTS_PER_CENTROID,
    kmeans_assign,
    train_kmeans,
)
from dingo_tpu_torch.ops.scatter import (
    MAX_SCATTER_BATCH,
    pad_buckets,
    scatter_bucket_dim_update,
    scatter_bucket_update,
)
from dingo_tpu_torch.ops.sq import sq_bucket_scores, sq_decode_device
from dingo_tpu_torch.ops.topk import begin_host_fetch, merge_topk
from dingo_tpu_torch.obs.heat import HEAT, heat_enabled
from dingo_tpu_torch.obs.integrity import INTEGRITY
from dingo_tpu_torch.obs.quality import QUALITY
from dingo_tpu_torch.trace import TRACER

#: rows per chunk when (re)assigning the whole store after training
ASSIGN_CHUNK = 1 << 18


def coarse_probes(queries: torch.Tensor, centroids: torch.Tensor,
                  c_sqnorm: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Top-nprobe coarse lists per query: [b, nprobe] int32. The coarse
    quantizer is always L2 (on normalized data L2 orders like cosine)."""
    d = (squared_norms(queries)[:, None] - 2.0 * (queries @ centroids.T)
         + c_sqnorm[None, :])
    return torch.topk(-d, nprobe, dim=1).indices.to(torch.int32)


def ivf_scan_scores(buckets, bucket_sqnorm, bucket_valid, bucket_slot,
                    probes, queries, k: int, metric: Metric,
                    sq_vmin=None, sq_scale=None):
    """The JAX package's XLA arm: scan probe ranks with a running top-k.
    Float buckets (bf16 widens exactly) score against the f32 query; code
    buckets (sq_vmin/sq_scale given) decode on the fly and score as the
    JAX package's sq_bucket_scores. Returns raw scores (descending-better)
    + slots [b, k]."""
    b = queries.shape[0]
    nprobe = probes.shape[1]
    dev = queries.device
    qsq = squared_norms(queries)
    best_v = torch.full((b, k), -torch.inf, dtype=torch.float32, device=dev)
    best_s = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for r in range(nprobe):
        lists_r = probes[:, r].long()
        rank_ok = lists_r >= 0
        lc = torch.where(rank_ok, lists_r, torch.zeros_like(lists_r))
        if sq_vmin is not None:
            scores = sq_bucket_scores(queries, buckets[lc],
                                      bucket_sqnorm[lc], sq_vmin, sq_scale,
                                      metric)
        else:
            dots = torch.einsum("bd,bcd->bc", queries,
                                buckets[lc].to(torch.float32))
            if metric is Metric.L2:
                scores = -(qsq[:, None] - 2.0 * dots + bucket_sqnorm[lc])
            else:   # IP / cosine (queries pre-normalized for cosine)
                scores = dots
        val = bucket_valid[lc] & rank_ok[:, None]
        scores = torch.where(val, scores, torch.full_like(scores, -torch.inf))
        vals_r, idx_r = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        slots_r = torch.gather(bucket_slot[lc], 1, idx_r)
        slots_r = torch.where(torch.isneginf(vals_r),
                              torch.full_like(slots_r, -1), slots_r)
        best_v, best_s = merge_topk(best_v, best_s, vals_r, slots_r, k)
    return best_v, best_s


#: searches that took this arm (crossover off, k > 64, unpruned sq8 or
#: sq8 + COSINE)
ivf_scan_scores.calls = 0


def _filter_bucket_mask(slot_mask: torch.Tensor,
                        bucket_slot: torch.Tensor) -> torch.Tensor:
    """Expand a [capacity] slot mask to [B, cap_list] on the device."""
    safe = torch.where(bucket_slot >= 0, bucket_slot,
                       torch.zeros_like(bucket_slot)).long()
    return slot_mask[safe] & (bucket_slot >= 0)


#: filter-mask cache entries kept per index
FILTER_CACHE_SIZE = 16


class IvfViewMaintenance:
    """Incremental bucketed-view lifecycle: append-in-place upserts,
    tombstone deletes, deferred compaction, the filter-mask cache and
    (k, nprobe) shape bucketing. The owning index implements
    `_materialize_view_data` / `_scatter_view_data` for its data arrays."""

    _view: Optional[MutableIvfView]
    _view_dirty: bool

    def _materialize_view_data(self, view: MutableIvfView) -> None:
        raise NotImplementedError

    def _scatter_view_data(self, upd, rows) -> None:
        raise NotImplementedError

    # -- view lifecycle ----------------------------------------------------
    def _ensure_view(self) -> None:
        """Hot-path entry: rebuild only when there is no usable view."""
        if self._view is None or self._view_dirty:
            self._rebuild_view("search")

    def _rebuild_view(self, reason: str = "search") -> None:
        """Full dense rebuild (build_layout + gather), all under one
        device_lock hold so no write lands between snapshot and swap."""
        compacting = reason == "compact"
        name = "ivf.compact" if compacting else "ivf.full_rebuild"
        with TRACER.start_span(name) as span:
            with self.store.device_lock:
                view = MutableIvfView.build(
                    self._assign_h, self.store.valid_h, self.nlist,
                    self.store.capacity, self.device,
                )
                self._materialize_view_data(view)
                self._view = view
                self._view_dirty = False
                self._filter_cache.clear()
            if span.sampled:
                span.set_attr("region_id", self.id)
                span.set_attr("buckets", view.nbuckets)
                span.set_attr("rows", view.live_rows)
        self.full_rebuilds += 1
        METRICS.counter(
            "ivf.compactions" if compacting else "ivf.full_rebuild",
            region_id=self.id,
        ).add(1)
        self._update_view_gauges()

    def _update_view_gauges(self) -> None:
        v = self._view
        if v is not None:
            METRICS.gauge("ivf.tombstone_ratio", region_id=self.id).set(
                v.tombstone_ratio())

    def _invalidate_view(self) -> None:
        with self.store.device_lock:
            self._view_dirty = True
            self._filter_cache.clear()

    # -- incremental write path --------------------------------------------
    def _view_apply_upsert(self, slots, assign, rows) -> None:
        if len(slots) > MAX_SCATTER_BATCH:
            # batch big enough to amortize a dense rebuild: defer it
            self._invalidate_view()
            return
        # stage (host) + apply (device) under ONE hold: a concurrent search
        # never sees staged host state ahead of the device arrays
        with TRACER.start_span("ivf.append_inplace") as span:
            with self.store.device_lock:
                view = self._view
                if view is None or self._view_dirty:
                    self._view_dirty = True
                    return
                view.ensure_slot_capacity(self.store.capacity)
                upd = view.stage_upsert(slots, np.asarray(assign))
                if upd is None:
                    return
                view.apply_device(upd)
                self._scatter_view_data(upd, rows)
            if span.sampled:
                span.set_attr("region_id", self.id)
                span.set_attr("rows", int(len(slots)))
        METRICS.counter("ivf.inplace_appends", region_id=self.id).add(
            len(upd.appended))
        self._update_view_gauges()

    def _view_apply_delete(self, slots) -> None:
        with self.store.device_lock:
            view = self._view
            if view is None or self._view_dirty:
                self._view_dirty = True
                return
            upd = view.stage_delete(slots)
            if upd is None:
                return
            view.apply_device(upd)
        METRICS.counter("ivf.tombstones", region_id=self.id).add(
            len(upd.touched))
        self._update_view_gauges()

    # -- compaction --------------------------------------------------------
    def need_compact(self) -> bool:
        v = self._view
        if v is None:
            return False
        if self._view_dirty:
            return True
        return (
            v.tombstone_ratio() >= FLAGS.get("ivf_compact_tombstone_ratio")
            or v.spill_ratio() >= FLAGS.get("ivf_compact_spill_ratio")
        )

    def compact(self) -> None:
        """Rebuild the dense layout now (O(N); keep it off the serving
        path)."""
        self._rebuild_view("compact")

    def maybe_compact(self) -> bool:
        if self.need_compact():
            self.compact()
            return True
        return False

    def view_stats(self) -> dict:
        out = {"built": self._view is not None, "dirty": self._view_dirty}
        if self._view is not None:
            out.update(self._view.stats())
        return out

    # -- filter-mask cache -------------------------------------------------
    def _prep_filter_mask(self, filter_spec: Optional[FilterSpec]):
        """Host-side filter work done OUTSIDE the device lock; the in-lock
        consumer revalidates against the live view version."""
        if filter_spec is None or filter_spec.is_empty():
            return None
        view = self._view
        fp = filter_spec.fingerprint()
        ver = view.version if view is not None else -1
        hit = self._filter_cache.get(fp)
        if hit is not None and hit[0] == ver:
            return (fp, ver, None)
        return (fp, ver, filter_spec.slot_mask(self.store.ids_by_slot))

    def _bucket_valid_for_filter(self, filter_spec: Optional[FilterSpec],
                                 prep=None) -> torch.Tensor:
        """Device validity mask for the scan; callers hold device_lock."""
        view = self._view
        if filter_spec is None or filter_spec.is_empty():
            return view.bucket_valid
        fp, ver, mask = prep if prep is not None else (
            filter_spec.fingerprint(), view.version, None
        )
        hit = self._filter_cache.get(fp)
        if hit is not None and hit[0] == view.version:
            METRICS.counter("ivf.filter_mask_hits", region_id=self.id).add(1)
            return hit[1]
        if mask is None or ver != view.version:
            mask = filter_spec.slot_mask(self.store.ids_by_slot)
        bmask = _filter_bucket_mask(upload(mask, self.device),
                                    view.bucket_slot)
        if len(self._filter_cache) >= FILTER_CACHE_SIZE:
            stale = [k for k, (v, _) in self._filter_cache.items()
                     if v != view.version]
            for k in stale:
                del self._filter_cache[k]
            while len(self._filter_cache) >= FILTER_CACHE_SIZE:
                self._filter_cache.pop(next(iter(self._filter_cache)))
        self._filter_cache[fp] = (view.version, bmask)
        METRICS.counter("ivf.filter_mask_misses", region_id=self.id).add(1)
        return bmask

    # -- shape bucketing and warmup ----------------------------------------
    def _shape_buckets(self, topk: int, nprobe: int):
        """(k_eff, nprobe_eff) on the {1, 1.5}x-pow2 ladder; results slice
        back to topk."""
        if not FLAGS.get("ivf_shape_bucketing"):
            return topk, nprobe
        return shape_bucket(topk), min(shape_bucket(nprobe), self.nlist)

    def _warmup_queries(self, b: int) -> np.ndarray:
        return np.ones((b, self.dimension), np.float32)

    def warmup(self, batches=(1, 8, 64), topk: int = 10,
               nprobe: Optional[int] = None) -> int:
        """One search per batch bucket, so that steady-state serving meets
        no new shape; returns the searches run (0 untrained)."""
        if not self.is_trained():
            return 0
        with TRACER.start_span("ivf.warmup") as span:
            self._ensure_view()
            for bsz in batches:
                self.search(self._warmup_queries(int(bsz)), topk,
                            nprobe=nprobe)
            if span.sampled:
                span.set_attr("searches", len(batches))
        return len(batches)


class TpuIvfFlat(IvfViewMaintenance, _SlotStoreIndex):
    _snapshot_file = "ivf_flat.npz"

    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        VectorIndex.__init__(self, index_id, parameter)
        if parameter.dimension <= 0:
            raise InvalidParameter(f"dimension {parameter.dimension}")
        if parameter.ncentroids <= 0:
            raise InvalidParameter(f"ncentroids {parameter.ncentroids}")
        if parameter.metric is Metric.HAMMING and type(self) is TpuIvfFlat:
            raise InvalidParameter("use BINARY_IVF_FLAT for hamming")
        self.device = resolve_device(device)
        self._kernel_metric = parameter.metric
        tier = resolve_precision(parameter)
        self.store = _new_tier_store(tier, parameter, self.device)
        self._init_precision(tier)
        self.nlist = parameter.ncentroids
        self.centroids: Optional[torch.Tensor] = None     # [nlist, d]
        self._c_sqnorm: Optional[torch.Tensor] = None
        self._assign_h = np.full((self.store.capacity,), -1, np.int32)
        self._view: Optional[MutableIvfView] = None
        self._buckets: Optional[torch.Tensor] = None      # [alloc, cap, d]
        self._bucket_sqnorm: Optional[torch.Tensor] = None
        #: [alloc, nblk, cap_list] per-block norms for the pruned scan
        self._bucket_bsq: Optional[torch.Tensor] = None
        self._view_dirty = True
        self._filter_cache: dict = {}
        #: dense view rebuilds (first search after train/load, oversize
        #: write batches, compaction)
        self.full_rebuilds = 0

    def _prep_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = super()._prep_queries(queries)
        if self.metric is Metric.COSINE:
            queries = np_normalize(queries)
        return queries

    def _grow_assign(self) -> None:
        if self._assign_h.shape[0] < self.store.capacity:
            grown = np.full((self.store.capacity,), -1, np.int32)
            grown[: self._assign_h.shape[0]] = self._assign_h
            self._assign_h = grown

    def _heat_layout(self) -> Optional[dict]:
        """Heat-plane layout provider: rows per IVF list from the host
        assignment array, priced at this tier's bytes a row (run on the
        heat plane's worker thread, never a serving thread)."""
        assign = self._assign_h
        if assign is None:
            return None
        from dingo_tpu_torch.obs.heat import TIER_BYTES

        rows = np.bincount(assign[assign >= 0].astype(np.int64),
                           minlength=self.nlist)
        return {
            "unit_rows": rows,
            "row_bytes": self.dimension * TIER_BYTES.get(
                self._precision, 4.0),
            "tier": self._precision,
            "dim": self.dimension,
        }

    # -- state-integrity: the bucket-assignment artifact -------------------
    def _integrity_assign(self, ids: np.ndarray, assign: np.ndarray) -> None:
        """Fold a write batch's coarse-list assignments into the
        'ivf_buckets' digest (the ledger tracks the assignment truth; the
        scrub reads the device view's arrangement back and compares)."""
        if len(ids) == 0 or not INTEGRITY.tracking(self):
            return
        ids = np.asarray(ids, np.int64)
        assign = np.asarray(assign, np.int32)
        placed = assign >= 0
        if placed.any():
            INTEGRITY.note_write(self, "ivf_buckets", ids[placed],
                                 assign[placed])

    def _integrity_reset_assign(self) -> None:
        """Rebuild the assignment digest from _assign_h (train and load
        reassign every stored row at once)."""
        if not INTEGRITY.tracking(self):
            return
        INTEGRITY.reset_artifact(self, "ivf_buckets")
        live = np.flatnonzero(self.store.ids_by_slot >= 0)
        if len(live):
            assign = self._assign_h[live].astype(np.int32)
            self._integrity_assign(self.store.ids_by_slot[live], assign)

    # -- mutation: track assignments ---------------------------------------
    @integrity_mutation
    def upsert(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = self._prep_vectors(vectors)
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        slots = self.store.put(np.asarray(ids, np.int64), vectors)
        self._offer_rerank(slots, vectors)
        # quantized tiers mirror the rows before quantization for the
        # shadow ground truth (no-op while sampling is off)
        QUALITY.observe_write(self, np.asarray(ids, np.int64), vectors)
        self._integrity_write(ids, vectors)
        self._grow_assign()
        if self.is_trained():
            rows = torch.from_numpy(vectors).to(self.device, torch.float32)
            assign = kmeans_assign(rows, self.centroids).cpu().numpy()
            self._assign_h[slots] = assign
            self._integrity_assign(ids, assign)
            if self._view is not None and not self._view_dirty:
                self._view_apply_upsert(slots, assign, vectors)
            else:
                self._invalidate_view()
        else:
            self._view_dirty = True
        self.write_count_since_save += len(ids)

    @integrity_mutation
    def delete(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        slots = self.store.remove_slots(ids)
        removed = int((slots >= 0).sum())
        self._invalidate_rerank(slots)
        QUALITY.observe_delete(self, ids)
        self._integrity_delete(ids)
        if removed:
            if self._view is not None and not self._view_dirty:
                self._view_apply_delete(slots[slots >= 0])
            else:
                self._invalidate_view()
        self.write_count_since_save += removed

    # -- training ----------------------------------------------------------
    def need_train(self) -> bool:
        return True

    def is_trained(self) -> bool:
        return self.centroids is not None

    @integrity_mutation
    def train(self, vectors: Optional[np.ndarray] = None) -> None:
        """Train the coarse quantizer; with no train set, sample the
        stored rows on the device (only slot indices cross the bus)."""
        if vectors is None:
            dv = self._train_rows_device(MAX_POINTS_PER_CENTROID * self.nlist)
            if int(dv.shape[0]) < self.nlist:
                raise NotTrained(f"need >= {self.nlist} train vectors, "
                                 f"have {int(dv.shape[0])}")
            if self.metric is Metric.COSINE:
                dv = dv * torch.rsqrt(torch.clamp_min(
                    (dv * dv).sum(dim=1, keepdim=True), 1e-30))
        else:
            if self._precision == "sq8":
                # an explicit train set reaches the codec before any
                # encode: min/max of the true distribution
                self.store.maybe_train(self._prep_vectors(vectors))
            vectors = np.asarray(vectors, np.float32)
            if len(vectors) < self.nlist:
                raise NotTrained(f"need >= {self.nlist} train vectors, "
                                 f"have {len(vectors)}")
            if self.metric is Metric.COSINE:
                vectors = np_normalize(vectors)
            cap = _resolve_train_cap(MAX_POINTS_PER_CENTROID * self.nlist)
            if cap and len(vectors) > cap:
                sel = np.random.default_rng(self.id).choice(
                    len(vectors), cap, replace=False
                )
                vectors = vectors[sel]
            dv = torch.from_numpy(np.ascontiguousarray(vectors)).to(
                self.device)
        self.centroids, _ = train_kmeans(dv, k=self.nlist, iters=10,
                                         seed=self.id)
        self._c_sqnorm = squared_norms(self.centroids)
        # (re)assign everything stored, in chunks of device rows
        live = np.flatnonzero(self.store.ids_by_slot >= 0)
        for lo in range(0, len(live), ASSIGN_CHUNK):
            sl = live[lo:lo + ASSIGN_CHUNK]
            self._assign_h[sl] = kmeans_assign(
                self.store.rows_device(sl), self.centroids
            ).cpu().numpy()
        self._integrity_reset_assign()
        self._invalidate_view()
        self.store.mutation_version += 1

    # -- bucketed view data ------------------------------------------------
    def _kernel_rows(self) -> bool:
        """Whether the store's rows are of a kernel arm (f32, bf16, sq8
        codes): f16 and int8 rows take the plain arm, as in the JAX
        package."""
        return self.store.dtype in KERNEL_DTYPES

    def _prune_dim_block(self) -> Optional[int]:
        """Dimension-block width the pruned scan would use for this index,
        or None when pruning cannot apply (kernel crossover or flag off;
        HAMMING, the binary family's metric; sq8 + COSINE, whose plain arm
        divides by the decoded norm and the kernel does not; or a
        dimension that does not block). Read at each
        view rebuild, so a flag flip takes effect at the next one."""
        if not ivf_kernel_enabled(self.dimension, self.device):
            return None
        if not prune_scan_enabled():
            return None
        if not self._kernel_rows():
            return None
        if self.metric not in (Metric.L2, Metric.INNER_PRODUCT,
                               Metric.COSINE):
            return None
        if self._precision == "sq8" and self.metric is Metric.COSINE:
            return None
        return resolve_dim_block(self.dimension)

    def _materialize_view_data(self, view: MutableIvfView) -> None:
        """Dense gather of the whole store into bucket coordinates, in the
        store's dtype (bf16 rows stay 2 bytes on every device; codes stay
        codes), plus the pruning metadata when the pruned route will read
        it: per-block norms of what the scan accumulates, the f32 decode
        for codes (caller holds device_lock)."""
        self._buckets = view.gather_rows(self.store.vecs)
        self._bucket_sqnorm = view.gather_rows(self.store.sqnorm)
        self._bucket_bsq = None
        dblk = self._prune_dim_block()
        if dblk:
            data = self._buckets
            if self._precision == "sq8":
                data = sq_decode_device(data, *self.store.codec_device(),
                                        torch.float32)
            self._bucket_bsq = bucket_block_sqnorms(data, dblk)

    def _scatter_view_data(self, upd, rows) -> None:
        """Apply a staged append batch to the data arrays in place (caller
        holds device_lock)."""
        if upd.grew_alloc is not None:
            self._buckets = pad_buckets(self._buckets, upd.grew_alloc)
            self._bucket_sqnorm = pad_buckets(self._bucket_sqnorm,
                                              upd.grew_alloc)
            if self._bucket_bsq is not None:
                self._bucket_bsq = pad_buckets(self._bucket_bsq,
                                               upd.grew_alloc)
        if not upd.appended:
            return
        cap = self._view.cap_list
        pos = np.asarray([p for p, _ in upd.appended], np.int64)
        src = np.asarray([i for _, i in upd.appended], np.int64)
        sel = np.asarray(rows, np.float32)[src]
        if self._precision == "sq8":
            # the view mirrors the store: codes, with norms of their decode
            sel = self.store.encode(sel)
            norm_rows = self.store.decode(sel)
        elif self._precision == "bf16":
            # norms of the bf16 rows the scan reads (the store's rule)
            norm_rows = torch.from_numpy(sel).to(torch.bfloat16).to(
                torch.float32).numpy()
        else:
            norm_rows = sel
        sq = (norm_rows ** 2).sum(axis=1)
        scatter_bucket_update(self._buckets, pos // cap, pos % cap, sel)
        scatter_bucket_update(self._bucket_sqnorm, pos // cap, pos % cap, sq)
        if self._bucket_bsq is not None:
            dblk = self.dimension // self._bucket_bsq.shape[1]
            bsq_rows = block_sqnorms(torch.from_numpy(norm_rows), dblk).T
            scatter_bucket_dim_update(self._bucket_bsq, pos // cap,
                                      pos % cap, bsq_rows)

    # -- search -------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int,
               filter_spec: Optional[FilterSpec] = None,
               nprobe: Optional[int] = None) -> List[SearchResult]:
        return self.search_async(queries, topk, filter_spec, nprobe)()

    def search_async(self, queries: np.ndarray, topk: int,
                     filter_spec: Optional[FilterSpec] = None,
                     nprobe: Optional[int] = None, staged=None):
        """Dispatch now, resolve later (one host wait in the thunk).
        ``staged``: the serving pipeline's pre-padded upload of these
        queries (flat._staged_or_upload)."""
        if not self.is_trained():
            raise NotTrained("IVF_FLAT not trained")   # reader falls back
        queries = self._prep_queries(queries)
        self._ensure_view()
        self._count_search()
        b = queries.shape[0]
        topk = int(topk)
        nprobe = min(
            nprobe or self.tuned("nprobe", self.parameter.default_nprobe),
            self.nlist,
        )
        kprime = self._rerank_shortlist(topk)
        k_eff, nprobe = self._shape_buckets(max(topk, kprime or 0), nprobe)
        qpad = _staged_or_upload(staged, queries, self.device)
        lease = self.store.begin_search()
        try:
            probes = coarse_probes(qpad, self.centroids, self._c_sqnorm,
                                   nprobe)
            fprep = self._prep_filter_mask(filter_spec)
            # view snapshot + dispatch under the device lock: a concurrent
            # write mutates the bucket arrays in place
            with self.store.device_lock:
                view = self._view
                vprobes = expand_probes(probes, view.probe_table, nprobe,
                                        view.max_spill)
                # padded query rows probe nothing, so they cost no scan
                vprobes[b:] = -1
                valid = self._bucket_valid_for_filter(filter_spec, fprep)
                kernel_ok = (
                    ivf_kernel_enabled(self.dimension, self.device)
                    and self.metric in (Metric.L2, Metric.INNER_PRODUCT,
                                        Metric.COSINE)
                    and k_eff <= kernel_ivf.K_MAX
                    and self._kernel_rows()
                )
                stats = None
                sq = self._precision == "sq8"
                codec = self.store.codec_device() if sq else (None, None)
                if kernel_ok and self._bucket_bsq is not None:
                    # dimension-blocked early-pruning scan: partial
                    # distances per block, candidates that cannot beat
                    # the running k-th best stop scanning
                    vals, slots, stats = kernel_ivf_pruned.ivf_pruned_search(
                        vprobes, qpad, self._buckets, self._bucket_bsq,
                        self._bucket_sqnorm, valid, view.bucket_slot, k_eff,
                        self.dimension // self._bucket_bsq.shape[1],
                        ascending=metric_ascending(self._kernel_metric),
                        sq_vmin=codec[0], sq_scale=codec[1],
                    )
                elif kernel_ok and not sq:
                    vals, slots = kernel_ivf.ivf_list_topk(
                        vprobes, qpad, self._buckets, self._bucket_sqnorm,
                        valid, view.bucket_slot, k_eff,
                        ascending=metric_ascending(self._kernel_metric),
                    )
                else:
                    ivf_scan_scores.calls += 1
                    DEVFAULT.maybe_fail("index.ivf.scan_sq" if sq
                                        else "index.ivf.scan")
                    vals, slots = ivf_scan_scores(
                        self._buckets, self._bucket_sqnorm, valid,
                        view.bucket_slot, vprobes, qpad, k_eff,
                        self._kernel_metric, *codec,
                    )
                dists = scores_to_distances(vals, self._kernel_metric)
                if kprime is not None:
                    # exact rerank of the quantized shortlist, under the
                    # same lock (the cache shares it), still asynchronous
                    dists, slots = self._dispatch_rerank(qpad, dists, slots,
                                                         topk)
        except Exception:
            lease.release()
            raise
        if kprime is not None:
            # a sampled trace times the scan and rerank as ops.rerank
            # (outside the lock; nothing for an unsampled request)
            device_wait_span("rerank", (dists, slots))
        store = self.store
        # one D2H group for the whole reply, the prune stats included; the
        # heat plane's probed-list ids ride the same group (no extra sync)
        heat_on = heat_enabled()
        if heat_on:
            HEAT.register_layout(self.id, "ivf", self._heat_layout)
        fetch = begin_host_fetch(dists, slots, stats,
                                 probes if heat_on else None)
        device_wait_span("ivf_scan", (dists, slots))

        def resolve() -> List[SearchResult]:
            try:
                fetched = fetch.get()
                dists_h, slots_h = fetched[0], fetched[1]
                if stats is not None:
                    self._note_prune_stats(fetched[2][:b])
                if heat_on:
                    # probed list ids: which partitions this batch read
                    HEAT.observe(self.id, "ivf", fetched[-1][:b])
                # shape bucketing may have run a larger k; slice back
                ids = store.ids_of_slots(
                    slots_h[:b, :topk].astype(np.int64))
                dists_h = self._convert_distances(dists_h[:b, :topk])
                # head-sampled shadow scoring, attributed to the nprobe
                # bucket scanned (async lane; nothing at rate 0)
                QUALITY.observe_search(
                    self, queries, topk, ids, dists_h,
                    bucket=f"nprobe={nprobe}", filter_spec=filter_spec)
                return [strip_invalid(i, d) for i, d in zip(ids, dists_h)]
            finally:
                lease.release()

        return resolve

    # -- lifecycle -----------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        snap = self._save_rows()
        extras = {}
        if self.is_trained():
            extras["centroids"] = self.centroids.cpu().numpy()
            live = self.store.ids_by_slot >= 0
            extras["assign"] = self._assign_h[np.flatnonzero(live)]
        np.savez(os.path.join(path, self._snapshot_file), **snap, **extras)
        meta = self._save_meta()
        meta["nlist"] = self.nlist
        meta["trained"] = self.is_trained()
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def load(self, path: str) -> None:
        """Reads the JAX package's snapshot format as well as its own."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._check_meta(meta)
        if meta["nlist"] != self.nlist:
            raise InvalidParameter(
                f"snapshot nlist {meta['nlist']} != {self.nlist}"
            )
        data = np.load(os.path.join(path, self._snapshot_file))
        trained = bool(meta.get("trained"))
        self.restore_arrays(
            data["ids"],
            centroids=data["centroids"] if trained else None,
            assign=data["assign"] if trained else None,
            **self._snapshot_rows(data),
        )
        self.apply_log_id = meta["apply_log_id"]
        self._integrity_on_restore(meta)

    def restore_arrays(self, ids, vectors=None, centroids=None, assign=None,
                       codes=None, sq_params=None) -> None:
        """Install rows (already prepped: cosine rows stay as stored) or an
        sq8 store's codes with their codec, centroids and per-row
        assignments, as a snapshot load does."""
        slots = self._restore_store(ids, vectors, codes, sq_params)
        self._assign_h = np.full((self.store.capacity,), -1, np.int32)
        self.centroids = None
        self._c_sqnorm = None
        self._grow_assign()
        if centroids is not None:
            self.centroids = torch.from_numpy(
                np.array(centroids, np.float32)).to(self.device)
            self._c_sqnorm = squared_norms(self.centroids)
            self._assign_h[slots] = np.asarray(assign, np.int32)
        self._view = None
        self._view_dirty = True
        self._filter_cache.clear()
        self.write_count_since_save = 0


class TpuBinaryIvfFlat(BinaryPm1Mixin, TpuIvfFlat):
    """Binary (bit-packed) IVF with a hamming list scan (the reference's
    faiss::IndexBinaryIVF arm; the JAX package's TpuBinaryIvfFlat).
    dimension is in bits; wire rows are dimension // 8 uint8 bytes. Rows
    unpack once into the +/-1 int8 store, so the coarse quantizer is float
    k-means over +/-1 space (its centroids stay float) and the list scan
    is a +/-1 inner product. Snapshots (save, load, restore_arrays) are
    IVF_FLAT's with packed rows."""

    _snapshot_file = "binary_ivf_flat.npz"

    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        _check_binary_dimension(parameter)
        super().__init__(index_id, parameter, device=device)
        self.nbytes = parameter.dimension // 8
        self.store = self._binary_store()
        # the +/-1 store is the family's quantized form: the float tiers
        # and their rerank cache do not apply on top of it
        self._precision = "fp32"
        self._rerank_cache = None
        self._kernel_metric = Metric.INNER_PRODUCT
        self._assign_h = np.full((self.store.capacity,), -1, np.int32)

    def _warmup_queries(self, b: int) -> np.ndarray:
        return np.ones((b, self.nbytes), np.uint8)   # the packed wire rows

    def train(self, vectors: Optional[np.ndarray] = None) -> None:
        """Float k-means over +/-1 space: an explicit train set arrives
        packed (the wire format); the implicit one samples the unpacked
        store."""
        if vectors is not None:
            vectors = self._prep_vectors(vectors)
        super().train(vectors)
