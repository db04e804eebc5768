"""TpuIvfPq: IVF + product quantization with residual encoding and the
reference's hybrid flat -> pq lifecycle (port of dingo_tpu/index/ivf_pq.py,
fp32 store tier).

  codes    — residual PQ: code(x) = pq_encode(x - centroid[assign(x)]),
             kept in a device [capacity, m] uint8 tensor written on upsert;
             a bucketed view [B, cap_list, m] groups them by coarse list
             (ivf_layout.py), maintained in place as in IVF_FLAT.
  search   — coarse probes -> virtual bucket probes with their coarse rank
             -> an ADC scan with residual tables, then an exact rerank of
             topk * ivfpq_rerank_factor candidates. The scan is kernel B5
             (ops/kernel_pq.py), over tables built by the table kernel
             kernel_pq.ivfpq_adc_lut, when the crossover fires, the table
             [b, nprobe, m, ksub] fits LUT_BUDGET_BYTES and
             max(k, topk * factor) <= 64; else the JAX package's XLA arm
             as plain torch (_ivfpq_scan_kernel). A device store reranks on
             the device right after the scan; a host store (host_vectors)
             reranks from host rows at resolve.
  fallback — untrained: exact whole-store scan (the hybrid contract; NOT an
             error, unlike IVF_FLAT).

The bf16 precision tier stores the rows (device or host) as bf16, which the
untrained exact scan and the reranks read; the ADC scan (B5) never reads
them. sq8 is InvalidParameter, as in the JAX package (the codes are already
quantized).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from dingo_tpu_torch.common.config import FLAGS, ivf_kernel_enabled
from dingo_tpu_torch.common.device import resolve_device, upload
from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    InvalidParameter,
    NotTrained,
    SearchResult,
    VectorIndex,
    precision_tier,
    resolve_precision,
    strip_invalid,
)
from dingo_tpu_torch.index.flat import (
    _SlotStoreIndex,
    _resolve_train_cap,
    _staged_or_upload,
    flat_search_plain,
)
from dingo_tpu_torch.index.ivf_flat import IvfViewMaintenance, coarse_probes
from dingo_tpu_torch.index.ivf_layout import (
    MutableIvfView,
    expand_probes_ranked,
)
from dingo_tpu_torch.index.slot_store import (
    MIN_CAPACITY,
    HostSlotStore,
    SlotStore,
)
from dingo_tpu_torch.ops import kernel_pq
from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.ops.distance import (
    Metric,
    metric_ascending,
    normalize,
    np_normalize,
    scores_to_distances,
    squared_norms,
)
from dingo_tpu_torch.ops.kmeans import (
    MAX_POINTS_PER_CENTROID,
    kmeans_assign,
    train_kmeans,
)
# the residual tables' plain version, under the JAX package's name
from dingo_tpu_torch.ops.kernel_pq import (
    ivfpq_adc_lut_plain as _ivfpq_adc_lut,
)
from dingo_tpu_torch.ops.pq import (
    codebook_sqnorms as _codebook_sqnorms,
    pq_encode,
    pq_train,
    residual_lut_tables as _residual_lut_tables,
)
from dingo_tpu_torch.ops.rerank import _topk_epilogue, exact_rerank_device
from dingo_tpu_torch.ops.scatter import pad_buckets, scatter_bucket_update
from dingo_tpu_torch.ops.topk import begin_host_fetch, merge_topk

#: host rows per step of the untrained host-store scan
HOST_SCAN_CHUNK = 65536
#: rows encoded per device round during the train-time (re)encode
ENCODE_CHUNK = 131072
#: the precomputed [b, nprobe, m, ksub] table regime (shared by a list's
#: spill buckets, and the only one B5 takes) holds up to this many bytes
LUT_BUDGET_BYTES = 256 * 1024 * 1024


def _chunked_host_scan(store: HostSlotStore, mask_h: np.ndarray,
                       qpad: torch.Tensor, k: int, metric: Metric):
    """Exact scan streaming host chunks through the whole-store arm with a
    running top-k merge (the untrained arm of a host store; slots stay
    global). Returns (wire distances, slots)."""
    b, dev = qpad.shape[0], qpad.device
    sqnorm_h = store.sqnorm
    best_v = torch.full((b, k), -torch.inf, dtype=torch.float32, device=dev)
    best_s = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    asc = metric_ascending(metric)
    for i in range(0, store.vecs.shape[0], HOST_SCAN_CHUNK):
        hi = min(store.vecs.shape[0], i + HOST_SCAN_CHUNK)
        if not mask_h[i:hi].any():
            continue
        # bf16 rows go to the plain arm as bf16, as on a device store
        rows = torch.from_numpy(store.host_rows(slice(i, hi))).to(
            store.dtype)
        d, sl = flat_search_plain(
            rows.to(dev),
            torch.from_numpy(np.ascontiguousarray(sqnorm_h[i:hi])).to(dev),
            torch.from_numpy(np.ascontiguousarray(mask_h[i:hi])).to(dev),
            qpad, k, metric)
        vals = -d if asc else d
        gsl = torch.where(sl >= 0, sl + i, torch.full_like(sl, -1))
        best_v, best_s = merge_topk(best_v, best_s, vals, gsl, k)
    best_s = torch.where(torch.isneginf(best_v), torch.full_like(best_s, -1),
                         best_s)
    return scores_to_distances(best_v, metric), best_s


def _exact_rerank_host(store: HostSlotStore, queries: torch.Tensor,
                       cand_slots: np.ndarray, k: int, metric: Metric):
    """Exact rerank of ADC candidates from a host store: one host gather,
    one upload, one batched product on the device. Returns (wire distances
    [b, k], slots [b, k])."""
    b, kprime = cand_slots.shape
    dev = queries.device
    flat_idx = np.where(cand_slots >= 0, cand_slots, 0).reshape(-1)
    rows = torch.from_numpy(store.host_rows(flat_idx).reshape(
        b, kprime, -1)).to(dev)
    qd = queries.to(torch.float32)
    dots = torch.einsum("bd,bkd->bk", qd, rows)
    if metric is Metric.L2:
        # candidate norms from the store's cache, same host fancy-index
        c_sq = torch.from_numpy(store.sqnorm[flat_idx].reshape(b, kprime)).to(
            dev)
        scores = -(squared_norms(qd)[:, None] - 2.0 * dots + c_sq)
    else:
        scores = dots
    cand = torch.from_numpy(np.asarray(cand_slots, np.int32)).to(dev)
    return _topk_epilogue(scores, cand, k, metric)


def _encode_residual(vectors: torch.Tensor, assign: torch.Tensor,
                     centroids: torch.Tensor, codebooks: torch.Tensor
                     ) -> torch.Tensor:
    """codes[n, m] uint8 for residuals (vectors - their centroid)."""
    return pq_encode(vectors - centroids[assign.long()], codebooks)


def _ivfpq_scan_kernel(code_buckets, bucket_valid, bucket_slot,
                       bucket_coarse, probes_coarse, probes, coarse_pos,
                       queries, centroids, codebooks, k: int,
                       precompute_lut: bool):
    """The JAX package's XLA arm: per probe rank, the rank's residual table
    [b, m, ksub] (gathered by coarse_pos from the precomputed [b, nprobe,
    m, ksub] tables, or built per rank from each bucket's coarse list when
    they would not fit), the gathered code bucket's ADC distances, and a
    running top-k. Returns (wire ADC distances ascending, slots) [b, k]."""
    b, d = queries.shape
    m, ksub, _ = codebooks.shape
    dev = queries.device
    cb_sq = _codebook_sqnorms(codebooks)
    rows = torch.arange(b, device=dev)
    if precompute_lut:
        nprobe = probes_coarse.shape[1]
        resid_all = queries[:, None, :] - centroids[probes_coarse.long()]
        lut_all = _residual_lut_tables(
            resid_all.reshape(b * nprobe, d), codebooks, cb_sq
        ).reshape(b, nprobe, m, ksub)
    best_v = torch.full((b, k), -torch.inf, dtype=torch.float32, device=dev)
    best_s = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for r in range(probes.shape[1]):
        vl = probes[:, r].long()
        rank_ok = vl >= 0
        bkt = torch.where(rank_ok, vl, torch.zeros_like(vl))
        if precompute_lut:
            lut = lut_all[rows, coarse_pos[:, r].long()]   # [b, m, ksub]
        else:
            lists_r = bucket_coarse[bkt].long()
            lut = _residual_lut_tables(queries - centroids[lists_r],
                                       codebooks, cb_sq)
        codes = code_buckets[bkt]                           # [b, cap, m]
        val = bucket_valid[bkt] & rank_ok[:, None]
        slot = bucket_slot[bkt]
        dist = torch.gather(lut, 2, codes.transpose(1, 2).long()).sum(dim=1)
        scores = torch.where(val, -dist, torch.full_like(dist, -torch.inf))
        vals_r, idx_r = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        slots_r = torch.gather(slot, 1, idx_r)
        slots_r = torch.where(torch.isneginf(vals_r),
                              torch.full_like(slots_r, -1), slots_r)
        best_v, best_s = merge_topk(best_v, best_s, vals_r, slots_r, k)
    return -best_v, best_s


#: searches that took the XLA arm (crossover off, table over budget, or
#: max(k, topk * factor) > 64)
_ivfpq_scan_kernel.calls = 0


class TpuIvfPq(IvfViewMaintenance, _SlotStoreIndex):
    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        VectorIndex.__init__(self, index_id, parameter)
        p = parameter
        if p.dimension <= 0:
            raise InvalidParameter(f"dimension {p.dimension}")
        if p.dimension % p.nsubvector:
            raise InvalidParameter(
                f"dimension {p.dimension} not divisible by m={p.nsubvector}"
            )
        if p.nbits_per_idx != 8:
            raise InvalidParameter("only nbits=8 supported (uint8 codes)")
        if p.metric is Metric.HAMMING:
            raise InvalidParameter("hamming not valid for IVF_PQ")
        if precision_tier(p) == "sq8":
            raise InvalidParameter(
                "IVF_PQ codes are already quantized; sq8 applies to "
                "FLAT/IVF_FLAT"
            )
        self._precision = resolve_precision(p)
        self.device = resolve_device(device)
        self.store = self._new_store(MIN_CAPACITY)
        self.nlist = p.ncentroids
        self.m = p.nsubvector
        self.ksub = 1 << p.nbits_per_idx
        self.centroids: Optional[torch.Tensor] = None     # [nlist, d]
        self._c_sqnorm: Optional[torch.Tensor] = None
        self.codebooks: Optional[torch.Tensor] = None     # [m, ksub, dsub]
        self._assign_h = np.full((self.store.capacity,), -1, np.int32)
        self._codes: Optional[torch.Tensor] = None        # [capacity, m] u8
        self._code_buckets: Optional[torch.Tensor] = None  # [alloc, cap, m]
        self._view: Optional[MutableIvfView] = None
        self._view_dirty = True
        self._filter_cache: dict = {}
        self.full_rebuilds = 0

    def _new_store(self, capacity: int) -> SlotStore:
        dtype = torch.bfloat16 if self._precision == "bf16" \
            else torch.float32
        if self.parameter.host_vectors:
            return HostSlotStore(self.dimension, self.device, capacity,
                                 dtype=dtype)
        # no IVF_PQ path reads the blocked FLAT mirror
        return SlotStore(self.dimension, self.device, capacity, blocked=False,
                         dtype=dtype)

    def _prep_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = super()._prep_queries(queries)
        if self.metric is Metric.COSINE:
            queries = np_normalize(queries)
        return queries

    # -- mutation ----------------------------------------------------------
    def _ensure_code_capacity(self) -> None:
        cap = self.store.capacity
        if self._assign_h.shape[0] < cap:
            grown = np.full((cap,), -1, np.int32)
            grown[: self._assign_h.shape[0]] = self._assign_h
            self._assign_h = grown
        if self._codes is not None and self._codes.shape[0] < cap:
            self._codes = torch.cat([self._codes, self._codes.new_zeros(
                (cap - self._codes.shape[0], self.m))])

    def _set_codes(self, slots: np.ndarray, codes: torch.Tensor) -> None:
        with self.store.device_lock:
            self._codes[torch.as_tensor(np.asarray(slots, np.int64),
                                        device=self.device)] = codes

    def upsert(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = self._prep_vectors(vectors)
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        slots = self.store.put(np.asarray(ids, np.int64), vectors)
        self._ensure_code_capacity()
        if self.is_trained():
            dv = torch.from_numpy(vectors).to(self.device)
            assign = kmeans_assign(dv, self.centroids)
            codes = _encode_residual(dv, assign, self.centroids,
                                     self.codebooks)
            assign_h = assign.cpu().numpy()
            self._assign_h[slots] = assign_h
            self._set_codes(slots, codes)
            if self._view is not None and not self._view_dirty:
                # the fresh codes go into the bucketed view in place
                self._view_apply_upsert(slots, assign_h, codes)
            else:
                self._invalidate_view()
        else:
            self._view_dirty = True
        self.write_count_since_save += len(ids)

    def delete(self, ids: np.ndarray) -> None:
        slots = self.store.remove_slots(np.asarray(ids, np.int64))
        removed = int((slots >= 0).sum())
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
        return self.codebooks is not None

    def train(self, vectors: Optional[np.ndarray] = None) -> None:
        """Coarse k-means, then m PQ fits on the residuals of the same
        sample, then re-encode every stored row chunk by chunk."""
        cap = _resolve_train_cap(MAX_POINTS_PER_CENTROID * self.nlist)
        rng = np.random.default_rng(self.id)
        min_train = max(self.nlist, self.ksub)
        if vectors is None:
            # sample slots; only their indices (host store: the sampled
            # rows) cross the bus
            live = np.flatnonzero(self.store.ids_by_slot >= 0)
            sel = live if (not cap or len(live) <= cap) else np.sort(
                rng.choice(live, cap, replace=False))
            if len(sel) < min_train:
                raise NotTrained(
                    f"need >= {min_train} train vectors, have {len(sel)}")
            dv = self.store.rows_device(sel)
            if self.metric is Metric.COSINE:
                dv = normalize(dv)
        else:
            vectors = np.asarray(vectors, np.float32)
            if len(vectors) < min_train:
                raise NotTrained(f"need >= {min_train} train vectors, "
                                 f"have {len(vectors)}")
            if self.metric is Metric.COSINE:
                vectors = np_normalize(vectors)
            if cap and len(vectors) > cap:
                vectors = vectors[rng.choice(len(vectors), cap,
                                             replace=False)]
            dv = torch.from_numpy(np.ascontiguousarray(vectors)).to(
                self.device)
        self.centroids, _ = train_kmeans(dv, k=self.nlist, iters=10,
                                         seed=self.id)
        self._c_sqnorm = squared_norms(self.centroids)
        assign = kmeans_assign(dv, self.centroids)
        resid = dv - self.centroids[assign.long()]
        self.codebooks = pq_train(resid, m=self.m, ksub=self.ksub, iters=10,
                                  seed=self.id)
        # encode everything stored, one chunk of device rows at a time
        self._codes = torch.zeros((self.store.capacity, self.m),
                                  dtype=torch.uint8, device=self.device)
        self._ensure_code_capacity()
        live = np.flatnonzero(self.store.ids_by_slot >= 0)
        for i in range(0, len(live), ENCODE_CHUNK):
            sl = live[i:i + ENCODE_CHUNK]
            rows = self.store.rows_device(sl)
            if self.metric is Metric.COSINE:
                rows = normalize(rows)
            a = kmeans_assign(rows, self.centroids)
            self._assign_h[sl] = a.cpu().numpy()
            self._set_codes(sl, _encode_residual(rows, a, self.centroids,
                                                 self.codebooks))
        self._invalidate_view()
        self.store.mutation_version += 1

    # -- bucketed view (IvfViewMaintenance data hooks) ---------------------
    def _materialize_view_data(self, view: MutableIvfView) -> None:
        self._code_buckets = view.gather_rows(self._codes)

    def _scatter_view_data(self, upd, rows: torch.Tensor) -> None:
        """Scatter freshly encoded codes ([n, m] uint8 on the device) into
        the bucketed code view in place; caller holds device_lock."""
        if upd.grew_alloc is not None:
            self._code_buckets = pad_buckets(self._code_buckets,
                                             upd.grew_alloc)
        if not upd.appended:
            return
        cap = self._view.cap_list
        pos = np.asarray([p for p, _ in upd.appended], np.int64)
        src = torch.as_tensor([i for _, i in upd.appended],
                              dtype=torch.int64, device=rows.device)
        scatter_bucket_update(self._code_buckets, pos // cap, pos % cap,
                              rows[src])

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
        queries = self._prep_queries(queries)
        b = queries.shape[0]
        topk = int(topk)
        qpad = _staged_or_upload(staged, queries, self.device)
        store = self.store
        host = isinstance(store, HostSlotStore)
        # lease before any dispatch: result slots stay limbo-parked until
        # resolve translates them (and, on a host store, gathers their rows)
        lease = store.begin_search()
        rerank_host = False
        try:
            if not self.is_trained():
                # hybrid contract: exact whole-store scan until trained
                filtered = (filter_spec is not None
                            and not filter_spec.is_empty())
                if host:
                    mask_h = (filter_spec.slot_mask(store.ids_by_slot)
                              if filtered else store.valid_h)
                    dists, slots = _chunked_host_scan(
                        store, mask_h, qpad, topk, self.metric)
                else:
                    mask = (upload(filter_spec.slot_mask(
                        store.ids_by_slot), self.device)
                        if filtered else store.device_mask())
                    with store.device_lock:
                        flat_search_plain.calls += 1
                        DEVFAULT.maybe_fail("index.flat.search")
                        dists, slots = flat_search_plain(
                            store.vecs, store.sqnorm, mask, qpad, topk,
                            self.metric)
            else:
                dists, slots, rerank_host = self._search_trained(
                    qpad, b, topk, filter_spec, nprobe)
        except Exception:
            lease.release()
            raise
        # one D2H group for the whole reply
        fetch = begin_host_fetch(dists, slots)

        def resolve() -> List[SearchResult]:
            try:
                dists_h, slots_h = fetch.get()
                if rerank_host:
                    # the ADC scan was a prune and the exact rows sit in
                    # host memory: the candidates must reach the host
                    # before their rows can be gathered, so this arm
                    # synchronizes twice
                    d_r, s_r = _exact_rerank_host(
                        store, qpad[:b], slots_h[:b], topk, self.metric)
                    dists_h, slots_h = d_r.cpu().numpy(), s_r.cpu().numpy()
                # shape bucketing may have run a larger k; slice back
                ids = store.ids_of_slots(
                    slots_h[:b, :topk].astype(np.int64))
                return [strip_invalid(i, d)
                        for i, d in zip(ids, dists_h[:b, :topk])]
            finally:
                lease.release()

        return resolve

    def _search_trained(self, qpad: torch.Tensor, b: int, topk: int,
                        filter_spec: Optional[FilterSpec],
                        nprobe: Optional[int]):
        """Dispatch the trained search -> (dists, slots, rerank at
        resolve)."""
        self._ensure_view()
        store = self.store
        host = isinstance(store, HostSlotStore)
        nprobe = min(
            nprobe or self.tuned("nprobe", self.parameter.default_nprobe),
            self.nlist,
        )
        k_eff, nprobe = self._shape_buckets(topk, nprobe)
        probes = coarse_probes(qpad, self.centroids, self._c_sqnorm, nprobe)
        fprep = self._prep_filter_mask(filter_spec)
        factor = self.tuned("rerank_factor",
                            int(FLAGS.get("ivfpq_rerank_factor")))
        # ADC prune + exact rerank: host rows rerank at resolve, device rows
        # right after the scan in the same stream
        rerank_host = host and factor > 1
        rerank_dev = not host and factor > 1 and len(store) > 0
        kprime = (min(len(store), topk * factor)
                  if (rerank_host or rerank_dev) else k_eff)
        kk = max(k_eff, kprime)
        # one residual table per (query, coarse rank), shared by a list's
        # spill buckets, while [b, nprobe, m, ksub] fits the budget
        lut_bytes = qpad.shape[0] * nprobe * self.m * self.ksub * 4
        precompute = lut_bytes <= LUT_BUDGET_BYTES
        # kernel B5: the IVF crossover, the precomputed-table regime (its
        # resident operand) and the kernel's k ceiling
        use_fused = (ivf_kernel_enabled(self.dimension, self.device)
                     and precompute and kk <= kernel_pq.K_MAX)
        # view snapshot + dispatch under the device lock: a concurrent
        # write mutates the bucket arrays in place
        with store.device_lock:
            view = self._view
            vprobes, coarse_pos = expand_probes_ranked(
                probes, view.probe_table, nprobe, view.max_spill)
            # padded query rows probe nothing, so they cost no scan
            vprobes[b:] = -1
            valid = self._bucket_valid_for_filter(filter_spec, fprep)
            if use_fused:
                lut_all = kernel_pq.ivfpq_adc_lut(qpad, self.centroids,
                                                  probes, self.codebooks)
                vals, slots = kernel_pq.ivf_pq_adc_topk(
                    vprobes, coarse_pos.contiguous(), lut_all,
                    self._code_buckets, valid, view.bucket_slot, kk)
                dists = -vals          # wire: ADC squared L2, ascending
            else:
                _ivfpq_scan_kernel.calls += 1
                DEVFAULT.maybe_fail("index.ivfpq.scan")
                dists, slots = _ivfpq_scan_kernel(
                    self._code_buckets, valid, view.bucket_slot,
                    view.bucket_coarse, probes, vprobes, coarse_pos, qpad,
                    self.centroids, self.codebooks, kk, precompute)
            if rerank_dev:
                dists, slots = exact_rerank_device(
                    store.vecs, store.sqnorm, qpad, slots, topk, self.metric)
        return dists, slots, rerank_host

    # -- lifecycle -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Writes the JAX package's snapshot format (codes are re-encoded
        at load, as there)."""
        os.makedirs(path, exist_ok=True)
        snap = self.store.to_host()
        extras = {}
        if self.is_trained():
            extras["centroids"] = self.centroids.cpu().numpy()
            extras["codebooks"] = self.codebooks.cpu().numpy()
        np.savez(os.path.join(path, "ivf_pq.npz"), ids=snap["ids"],
                 vectors=np.asarray(snap["vectors"], np.float32), **extras)
        meta = self._save_meta()
        meta.update(nlist=self.nlist, m=self.m, trained=self.is_trained())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def load(self, path: str) -> None:
        """Reads the JAX package's snapshot format as well as its own."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._check_meta(meta)
        if meta["nlist"] != self.nlist or meta["m"] != self.m:
            raise InvalidParameter("snapshot nlist/m mismatch")
        data = np.load(os.path.join(path, "ivf_pq.npz"))
        trained = bool(meta.get("trained"))
        self.restore_arrays(
            data["ids"], data["vectors"],
            data["centroids"] if trained else None,
            data["codebooks"] if trained else None,
        )
        self.apply_log_id = meta["apply_log_id"]

    def restore_arrays(self, ids, vectors, centroids=None, codebooks=None,
                       codes=None, assign=None) -> None:
        """Install rows (already prepped: cosine rows stay as stored) and,
        when trained, the centroids and codebooks; the rows' codes and
        assignments are installed as given, or re-encoded when absent, as
        the JAX package's load does."""
        if (centroids is None) != (codebooks is None):
            raise InvalidParameter("centroids and codebooks go together")
        if (codes is None) != (assign is None):
            raise InvalidParameter("codes and assign go together")
        ids = np.asarray(ids, np.int64)
        self.store = self._new_store(max(len(ids), 1))
        self._assign_h = np.full((self.store.capacity,), -1, np.int32)
        self._codes = None
        self.centroids = self._c_sqnorm = self.codebooks = None
        self._view = None
        self._view_dirty = True
        self._filter_cache.clear()
        if centroids is not None:
            self.centroids = torch.from_numpy(
                np.array(centroids, np.float32)).to(self.device)
            self._c_sqnorm = squared_norms(self.centroids)
            self.codebooks = torch.from_numpy(
                np.array(codebooks, np.float32)).to(self.device)
            self._codes = torch.zeros((self.store.capacity, self.m),
                                      dtype=torch.uint8, device=self.device)
        vectors = np.ascontiguousarray(vectors, np.float32)
        slots = self.store.put(ids, vectors) if len(ids) \
            else np.empty(0, np.int64)
        self._ensure_code_capacity()
        if self.is_trained() and len(ids):
            if codes is None:
                dv = torch.from_numpy(vectors).to(self.device)
                a = kmeans_assign(dv, self.centroids)
                codes_d = _encode_residual(dv, a, self.centroids,
                                           self.codebooks)
                assign_h = a.cpu().numpy()
            else:
                codes_d = torch.from_numpy(np.array(codes, np.uint8)).to(
                    self.device)
                assign_h = np.asarray(assign, np.int32)
            self._assign_h[slots] = assign_h
            self._set_codes(slots, codes_d)
        self.write_count_since_save = 0
