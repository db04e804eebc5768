"""TpuFlat: exact brute-force index (port of dingo_tpu/index/flat.py, float
metrics, in the fp32, bf16 and sq8 precision tiers), and TpuBinaryFlat,
exact hamming search over bit-packed rows.

The whole search is one scan of the slot store, by the first arm that
applies to an L2/IP index with k <= the kernels' K_MAX when the fused
crossover fired:

  * kernel B4 (ops/kernel_topk_pruned.py) when the store keeps the
    dimension-blocked mirror and ivf_prune_scan is on: partial distances
    per dimension block, candidates that cannot beat the running k-th best
    stop scanning; its stats lanes feed the ivf.pruned_* metrics. Each tier
    has its arm (f32, bf16 rows with a bf16 query, sq8 codes decoded);
  * kernel B1 (ops/kernel_topk.py) otherwise, for f32 and bf16 rows:
    fused distance + running top-k, no [b, capacity] score matrix;

else the JAX package's own XLA arm (score matrix + masked top-k) as plain
torch ops: flat_search_plain for float rows, sq_flat_search_plain for
codes (an empty, untrained sq8 store scans with an identity codec). Query
batches pad to powers of two, as in the JAX package.

The binary family (BinaryPm1Mixin) unpacks rows once at write time into an
int8 +/-1 store and scans it on the plain arm as an inner product (an
exact int8 product, ops/distance._dot_pm1): hamming(a, b) = (nbits -
<pm(a), pm(b)>) / 2 at resolve. B1 and B4 never see int8 rows, as the
JAX package keeps them off its fused kernels.

The bf16/sq8 tiers may rerank: with a rerank cache (rerank_cache_rows > 0)
a search scans topk * quantized_rerank_factor candidates and reranks them
on the device, exactly for the cached ones (index/rerank_cache.py).
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from dingo_tpu_torch.common.config import (
    FLAGS,
    fused_kernel_enabled,
    prune_scan_enabled,
    train_sample_rows,
)
from dingo_tpu_torch.common.device import resolve_device, upload
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    InvalidParameter,
    NotSupported,
    SearchResult,
    VectorIndex,
    resolve_precision,
    strip_invalid,
)
from dingo_tpu_torch.index.rerank_cache import DeviceRerankCache
from dingo_tpu_torch.index.slot_store import SlotStore, SqSlotStore, _next_pow2
from dingo_tpu_torch.ops import kernel_topk, kernel_topk_pruned
from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.ops.distance import (
    Metric,
    metric_ascending,
    np_normalize,
    score_matrix,
    scores_to_distances,
)
from dingo_tpu_torch.ops.rerank import cached_rerank_device
from dingo_tpu_torch.ops.sq import SqParams, sq_score_matrix
from dingo_tpu_torch.ops.topk import begin_host_fetch, topk_scores


def flat_search_plain(vecs, sqnorm, mask, queries, k: int, metric: Metric):
    """The JAX package's XLA arm (flat.py:_flat_search_kernel): whole-store
    score matrix + masked top-k -> (distances, slots)."""
    scores = score_matrix(queries, vecs, metric, x_sqnorm=sqnorm,
                          x_is_normalized=(metric is Metric.COSINE))
    vals, slots = topk_scores(scores, k, valid=mask[None, :])
    return scores_to_distances(vals, metric), slots


#: searches that took the plain arm (crossover off, COSINE, k > K_MAX, or
#: the binary family's int8 rows)
flat_search_plain.calls = 0


def sq_flat_search_plain(codes, vmin, scale, sqnorm, mask, queries, k: int,
                         metric: Metric):
    """The JAX package's sq8 XLA arm (flat.py:_sq_flat_search_kernel):
    decode-on-the-fly bf16 scores over the codes + masked top-k ->
    (distances, slots)."""
    scores = sq_score_matrix(queries, codes, vmin, scale, metric,
                             x_sqnorm=sqnorm)
    vals, slots = topk_scores(scores, k, valid=mask[None, :])
    return scores_to_distances(vals, metric), slots


#: sq8 searches that took the plain arm (crossover or pruning off, COSINE,
#: k > K_MAX, or an untrained store)
sq_flat_search_plain.calls = 0


def _new_tier_store(precision: str, dim: int, device,
                    capacity: int = 0) -> SlotStore:
    """SlotStore of a precision tier: fp32 and bf16 are row dtypes of the
    float store, sq8 is the quantizing store."""
    kw = {"capacity": capacity} if capacity else {}
    if precision == "sq8":
        return SqSlotStore(dim, device, **kw)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return SlotStore(dim, device, dtype=dtype, **kw)


def _resolve_train_cap(derived: int) -> int:
    """Effective train-sample row cap: conf train_sample_rows meets the
    caller's derived cap; 0 from conf = full corpus (lifts both)."""
    conf = train_sample_rows()
    if conf == 0:
        return 0
    if derived <= 0:
        return conf
    return min(conf, derived)


def _pad_batch(q: np.ndarray) -> np.ndarray:
    b = q.shape[0]
    bb = _next_pow2(max(1, b))
    if bb != b:
        q = np.concatenate([q, np.zeros((bb - b,) + q.shape[1:], q.dtype)])
    return q


def _staged_or_upload(staged, queries: np.ndarray,
                      device: torch.device) -> torch.Tensor:
    """The padded device copy of `queries`: the serving pipeline's staged
    upload (common/pipeline.StagedBatch) when it was built from this very
    array, else padded and uploaded here. A staged batch that
    ``_prep_queries`` rebound (a dtype cast, COSINE's normalization) misses
    as in the JAX package, and each miss is counted
    (``pipeline.staged_miss``)."""
    qpad = staged.take(queries) if staged is not None else None
    if qpad is None:
        if staged is not None:
            METRICS.counter("pipeline.staged_miss").add(1)
        qpad = upload(_pad_batch(queries), device)
    return qpad


class _SlotStoreIndex(VectorIndex):
    """Shared machinery for indexes whose rows live in a SlotStore."""

    store: SlotStore
    device: torch.device
    _kernel_metric: Metric
    _precision: str = "fp32"
    #: bounded device row cache for the exact rerank of quantized tiers
    _rerank_cache: Optional[DeviceRerankCache] = None

    # -- precision tier and rerank stage -----------------------------------
    def _init_precision(self, tier: str) -> None:
        """Record the tier and, for bf16/sq8 with rerank_cache_rows > 0,
        attach a fresh rerank cache. Call after self.store exists: the
        cache shares its lock."""
        self._precision = tier
        self._rerank_cache = None
        rows = int(FLAGS.get("rerank_cache_rows"))
        if tier in ("bf16", "sq8") and rows > 0:
            dtype = getattr(torch, str(FLAGS.get("rerank_cache_dtype")))
            self._rerank_cache = DeviceRerankCache(
                self.dimension, rows, self.device, dtype=dtype,
                device_lock=self.store.device_lock)

    def _offer_rerank(self, slots, vectors) -> None:
        if self._rerank_cache is not None:
            self._rerank_cache.offer(slots, vectors)

    def _invalidate_rerank(self, slots) -> None:
        if self._rerank_cache is not None:
            self._rerank_cache.invalidate(slots[slots >= 0])

    def _rerank_shortlist(self, topk: int) -> Optional[int]:
        """k' to over-fetch for the rerank stage, or None when the stage
        is off (fp32 tier, no cache, an empty cache, or factor <= 1)."""
        cache = self._rerank_cache
        if cache is None or not len(cache):
            return None
        factor = self.tuned("rerank_factor",
                            int(FLAGS.get("quantized_rerank_factor")))
        if factor <= 1:
            return None
        return topk * factor

    def _dispatch_rerank(self, qpad, dists, slots, topk: int):
        """Rerank the quantized shortlist against the cache; the caller
        holds store.device_lock (the cache's lock too)."""
        cache = self._rerank_cache
        return cached_rerank_device(
            cache.vecs, cache.sqnorm, cache.device_map(self.store.capacity),
            dists, slots, qpad, k=topk, metric=self.metric)

    def _prep_vectors(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dimension:
            raise InvalidParameter(
                f"vector dim {vectors.shape} != {self.dimension}"
            )
        if self.metric is Metric.COSINE:
            # stored normalized; search then runs plain IP
            vectors = np_normalize(vectors)
        return vectors

    def _prep_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.dimension:
            raise InvalidParameter(
                f"query dim {queries.shape[1]} != {self.dimension}"
            )
        return queries

    def _train_rows_device(self, derived_cap: int = 0) -> torch.Tensor:
        """Live rows for implicit training, gathered on the device from
        host-sampled slot indices (seeded by index id)."""
        live = np.flatnonzero(self.store.ids_by_slot >= 0)
        cap = _resolve_train_cap(derived_cap)
        if cap and len(live) > cap:
            sel = np.random.default_rng(self.id).choice(
                len(live), cap, replace=False
            )
            live = np.sort(live[sel])
        return self.store.rows_device(live)

    def _note_prune_stats(self, stats_h) -> None:
        """Fold a pruned-scan stats block ([b, 4] host array: scanned
        pairs, total pairs, full scans, candidates) into the metrics.
        Called from resolve(), so the hot path never synchronizes for
        it."""
        sums = np.asarray(stats_h, np.float64).sum(axis=0)
        scanned, total, full, cand = (float(x) for x in sums[:4])
        if total > 0:
            METRICS.gauge(
                "ivf.pruned_dim_fraction", region_id=self.id
            ).set(max(0.0, 1.0 - scanned / total))
        METRICS.counter("ivf.pruned_candidates", region_id=self.id).add(
            int(max(0.0, cand - full))
        )

    # -- mutation ----------------------------------------------------------
    def add(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        uniq, counts = np.unique(ids, return_counts=True)
        if (counts > 1).any():
            raise InvalidParameter(
                f"duplicate ids within batch: {uniq[counts > 1][:5].tolist()}"
            )
        dup = [int(i) for i in ids if int(i) in self.store]
        if dup:
            raise InvalidParameter(f"duplicate ids {dup[:5]} (use upsert)")
        self.upsert(ids, vectors)

    def upsert(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = self._prep_vectors(vectors)
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        slots = self.store.put(np.asarray(ids, np.int64), vectors)
        self._offer_rerank(slots, vectors)
        self.write_count_since_save += len(ids)

    def delete(self, ids: np.ndarray) -> None:
        slots = self.store.remove_slots(np.asarray(ids, np.int64))
        self._invalidate_rerank(slots)
        self.write_count_since_save += int((slots >= 0).sum())

    # -- search ------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int,
               filter_spec: Optional[FilterSpec] = None
               ) -> List[SearchResult]:
        return self.search_async(queries, topk, filter_spec)()

    def search_async(self, queries: np.ndarray, topk: int,
                     filter_spec: Optional[FilterSpec] = None,
                     staged=None) -> Callable[[], List[SearchResult]]:
        """Dispatch the search and return a thunk materializing results.
        One host sync per reply: resolve() waits on one fetch group; the
        uploads here do not wait (common.device.upload). ``staged``: the
        serving pipeline's pre-padded upload of these queries
        (_staged_or_upload)."""
        queries = self._prep_queries(queries)
        b = queries.shape[0]
        qpad = _staged_or_upload(staged, queries, self.device)
        store = self.store
        # lease BEFORE dispatch: result slots stay limbo-parked until
        # resolve translates them
        lease = store.begin_search()
        try:
            with store.device_lock:
                if filter_spec is None or filter_spec.is_empty():
                    mask = store.device_mask()
                else:
                    mask = upload(filter_spec.slot_mask(store.ids_by_slot),
                                  self.device)
                kprime = self._rerank_shortlist(int(topk))
                dists, slots, stats = self._run_search_kernel(
                    qpad, mask, kprime or int(topk))
                if kprime is not None:
                    # exact rerank of the quantized shortlist, under the
                    # same lock (the cache shares it), still asynchronous
                    dists, slots = self._dispatch_rerank(
                        qpad, dists, slots, int(topk))
        except Exception:
            lease.release()
            raise
        # one D2H group for the whole reply, the prune stats included
        fetch = begin_host_fetch(dists, slots, stats)

        def resolve() -> List[SearchResult]:
            try:
                fetched = fetch.get()
                dists_h, slots_h = fetched[0], fetched[1]
                if stats is not None:
                    self._note_prune_stats(fetched[2][:b])
                ids = store.ids_of_slots(slots_h[:b].astype(np.int64))
                dists_h = self._convert_distances(dists_h[:b])
                return [strip_invalid(i, d) for i, d in zip(ids, dists_h)]
            finally:
                lease.release()

        return resolve

    def _convert_distances(self, dists: np.ndarray) -> np.ndarray:
        """Scan distances -> wire distances at resolve: the identity for
        float metrics; the binary family turns its +/-1 inner products
        into hamming distances."""
        return dists

    def _run_search_kernel(self, qpad: torch.Tensor, mask: torch.Tensor,
                           k: int):
        """Crossover for the whole-store scan -> (dists, slots,
        prune_stats_or_None): kernel B4 (the tier's arm) when the fused
        crossover fired for L2/IP, k fits the kernels' lists, the store
        keeps the blocked mirror and pruning is on; kernel B1 for float
        rows when only the first two hold; else the plain arm of the
        tier."""
        store = self.store
        # the binary family's int8 rows stay on the plain arm, as the JAX
        # package keeps them off its fused kernels (flat.py:544-546)
        fused_on = (
            fused_kernel_enabled(store.capacity, self.device)
            and self._kernel_metric in (Metric.L2, Metric.INNER_PRODUCT)
            and k <= kernel_topk.K_MAX
            and store.dtype != torch.int8
        )
        pruned_on = fused_on and store.vecs_blk is not None \
            and prune_scan_enabled()
        ascending = metric_ascending(self._kernel_metric)
        if self._precision == "sq8":
            # an empty untrained store scans on the plain arm with an
            # identity codec (codec_device)
            vmin, scale = store.codec_device()
            if pruned_on and store.sq_params is not None:
                vals, slots, stats = kernel_topk_pruned.pruned_fused_search(
                    qpad, store.vecs_blk, store.bsq_blk, store.sqnorm, mask,
                    k, ascending=ascending, sq_vmin=vmin, sq_scale=scale)
                return scores_to_distances(vals, self._kernel_metric), \
                    slots, stats
            sq_flat_search_plain.calls += 1
            DEVFAULT.maybe_fail("index.flat.search_sq")
            dists, slots = sq_flat_search_plain(
                store.vecs, vmin, scale, store.sqnorm, mask, qpad, k,
                self._kernel_metric)
            return dists, slots, None
        if pruned_on:
            vals, slots, stats = kernel_topk_pruned.pruned_fused_search(
                qpad, store.vecs_blk, store.bsq_blk, store.sqnorm, mask, k,
                ascending=ascending,
            )
            return scores_to_distances(vals, self._kernel_metric), slots, \
                stats
        if fused_on:
            vals, slots = kernel_topk.fused_topk(
                qpad, store.vecs, store.sqnorm, mask, k, ascending=ascending,
            )
            return scores_to_distances(vals, self._kernel_metric), slots, \
                None
        flat_search_plain.calls += 1
        DEVFAULT.maybe_fail("index.flat.search")
        dists, slots = flat_search_plain(store.vecs, store.sqnorm, mask,
                                         qpad, k, self._kernel_metric)
        return dists, slots, None

    # -- lifecycle ---------------------------------------------------------
    def get_count(self) -> int:
        return len(self.store)

    def get_memory_size(self) -> int:
        return self.store.memory_size()

    def _save_meta(self) -> dict:
        return {
            "index_type": self.index_type.value,
            "dimension": self.dimension,
            "metric": self.metric.value,
            "apply_log_id": self.apply_log_id,
            "count": self.get_count(),
            "precision": self._precision,
            # scan-layout metadata, informational: rows persist flat and
            # the blocked mirror is rebuilt at load from the flag
            "blocked_layout": self.store.vecs_blk is not None,
            "dim_block": int(self.store.dim_block or 0),
        }

    def _check_meta(self, meta: dict) -> None:
        """Snapshot compatibility. fp32 and bf16 snapshots share the f32
        row format and load across that flip (rows re-cast into the new
        store); sq8 holds codes and its codec, so crossing it raises.
        Snapshots without a precision key load under any tier. The JAX
        package's `integrity` digests are ignored until that plane is
        ported."""
        if meta["dimension"] != self.dimension:
            raise InvalidParameter(
                f"snapshot dimension {meta['dimension']} != {self.dimension}"
            )
        if meta["metric"] != self.metric.value:
            raise InvalidParameter(
                f"snapshot metric {meta['metric']} != {self.metric.value}"
            )
        snap_p = meta.get("precision")
        if snap_p is not None and snap_p != self._precision \
                and "sq8" in (snap_p, self._precision):
            raise InvalidParameter(
                f"snapshot precision {snap_p} != {self._precision}")

    def _restore_store(self, ids, vectors=None, codes=None,
                       sq_params: Optional[SqParams] = None) -> np.ndarray:
        """A fresh tier store (and rerank cache) holding the restored
        rows: f32 rows, or the sq8 codes with their codec put back
        bit-exactly. Returns the rows' slots."""
        ids = np.asarray(ids, np.int64)
        self.store = _new_tier_store(self._precision, self.dimension,
                                     self.device, capacity=max(len(ids), 1))
        self._init_precision(self._precision)
        if codes is not None:
            if self._precision != "sq8":
                raise InvalidParameter("sq8 codes given to a "
                                       f"{self._precision} index")
            self.store.set_params(sq_params)
            if len(ids):
                return self.store.put_codes(ids, codes)
        elif len(ids):
            return self.store.put(ids, vectors)
        return np.empty(0, np.int64)

    def _save_rows(self) -> dict:
        """The snapshot's row arrays: an sq8 store's codes with its codec
        (1 byte a dimension, restored bit-exactly), else f32 rows."""
        if self._precision == "sq8" and self.store.sq_params is not None:
            snap = self.store.codes_to_host()
            snap["sq_vmin"] = self.store.sq_params.vmin
            snap["sq_scale"] = self.store.sq_params.scale
            return snap
        snap = self.store.to_host()
        snap["vectors"] = np.asarray(snap["vectors"], np.float32)
        return snap

    @staticmethod
    def _snapshot_rows(data) -> dict:
        """restore keyword arguments from snapshot arrays (npz or a
        mapping): vectors, or codes with their codec."""
        if "codes" in data:
            return {"codes": np.asarray(data["codes"], np.uint8),
                    "sq_params": SqParams(
                        np.asarray(data["sq_vmin"], np.float32),
                        np.asarray(data["sq_scale"], np.float32))}
        return {"vectors": data["vectors"]}

    def need_to_save(self, last_save_log_behind: int) -> bool:
        return (
            self.write_count_since_save >= 10000
            or last_save_log_behind >= 10000000
        )


class TpuFlat(_SlotStoreIndex):
    """Exact search; also the brute-force engine that serves a region while
    its IVF is untrained. The name keeps the JAX package's, so a reader
    finds the counterpart."""

    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        super().__init__(index_id, parameter)
        if parameter.dimension <= 0:
            raise InvalidParameter(f"dimension {parameter.dimension}")
        self.device = resolve_device(device)
        tier = resolve_precision(parameter)
        if tier == "sq8" and parameter.metric is Metric.HAMMING:
            raise InvalidParameter("sq8 tier needs a float metric")
        self.store = _new_tier_store(tier, parameter.dimension, self.device)
        self._init_precision(tier)
        self._kernel_metric = parameter.metric

    def train(self, vectors: Optional[np.ndarray] = None) -> None:
        """FLAT needs no training, but the sq8 tier installs its codec
        from an explicit train set given before ingest (otherwise the
        first write batch trains it). need_train() stays False."""
        if self._precision == "sq8" and vectors is not None:
            self.store.maybe_train(self._prep_vectors(vectors))

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "flat.npz"), **self._save_rows())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(self._save_meta(), f)

    def load(self, path: str) -> None:
        """Reads the JAX package's snapshot format as well as its own."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._check_meta(meta)
        data = np.load(os.path.join(path, "flat.npz"))
        self.restore_arrays(data["ids"], **self._snapshot_rows(data))
        self.apply_log_id = meta["apply_log_id"]

    def restore_arrays(self, ids, vectors=None, codes=None,
                       sq_params: Optional[SqParams] = None) -> None:
        """Install stored rows as a snapshot load does (cosine rows are
        already normalized, so they go in as they are), or an sq8 store's
        codes with their codec."""
        self._restore_store(ids, vectors, codes, sq_params)
        self.write_count_since_save = 0


class BinaryPm1Mixin:
    """The binary indexes' codec (TpuBinaryFlat, TpuBinaryIvfFlat):
    dimension is in bits and wire rows are dimension // 8 uint8 bytes.
    Rows unpack once at write time (little-endian bits within a byte)
    into a +/-1 int8 store, so a search is one exact int8 product and
    hamming(a, b) = (nbits - <pm(a), pm(b)>) / 2. Snapshots hold the
    packed rows, in the JAX package's format."""

    dimension: int
    nbytes: int

    def _unpack_pm1(self, packed: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(packed, axis=1, bitorder="little")
        bits = bits[:, : self.dimension]
        return bits.astype(np.int8) * 2 - 1

    def _repack(self, pm1: np.ndarray) -> np.ndarray:
        return np.packbits(pm1 > 0, axis=1, bitorder="little")

    def _convert_distances(self, dists: np.ndarray) -> np.ndarray:
        # the scan returned +/-1 inner products (descending); hamming
        # distances ascend
        return (self.dimension - dists) * 0.5

    def _prep_vectors(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, np.uint8)
        if vectors.ndim != 2 or vectors.shape[1] != self.nbytes:
            raise InvalidParameter(f"binary vector shape {vectors.shape}")
        return self._unpack_pm1(vectors)

    def _prep_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = np.asarray(queries, np.uint8)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.nbytes:
            raise InvalidParameter(f"binary query shape {queries.shape}")
        return self._unpack_pm1(queries).astype(np.float32)

    def _binary_store(self, capacity: int = 0) -> SlotStore:
        """An empty +/-1 int8 store on the index's device."""
        kw = {"capacity": capacity} if capacity else {}
        return SlotStore(self.dimension, self.device, dtype=torch.int8, **kw)

    def _save_rows(self) -> dict:
        """The snapshot's rows, packed (the JAX package's format)."""
        snap = self.store.to_host()
        snap["vectors"] = self._repack(snap["vectors"])
        return snap

    def _restore_store(self, ids, vectors=None, codes=None,
                       sq_params=None) -> np.ndarray:
        """A fresh +/-1 store holding the packed snapshot rows; returns
        their slots."""
        ids = np.asarray(ids, np.int64)
        self.store = self._binary_store(max(len(ids), 1))
        if not len(ids):
            return np.empty(0, np.int64)
        return self.store.put(ids, self._unpack_pm1(
            np.asarray(vectors, np.uint8)))


def _check_binary_dimension(parameter: IndexParameter) -> None:
    if parameter.dimension <= 0 or parameter.dimension % 8:
        raise InvalidParameter("binary dimension must be multiple of 8")


class TpuBinaryFlat(BinaryPm1Mixin, _SlotStoreIndex):
    """Exact hamming search over bit-packed rows (the reference's
    faiss::IndexBinaryFlat arm; the JAX package's TpuBinaryFlat)."""

    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        super().__init__(index_id, parameter)
        _check_binary_dimension(parameter)
        self.nbytes = parameter.dimension // 8
        self.device = resolve_device(device)
        self.store = self._binary_store()
        self._kernel_metric = Metric.INNER_PRODUCT

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "binary_flat.npz"), **self._save_rows())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(self._save_meta(), f)

    def load(self, path: str) -> None:
        """Reads the JAX package's snapshot format as well as its own."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._check_meta(meta)
        data = np.load(os.path.join(path, "binary_flat.npz"))
        self.restore_arrays(data["ids"], data["vectors"])
        self.apply_log_id = meta["apply_log_id"]

    def restore_arrays(self, ids, vectors) -> None:
        """Install packed uint8 rows as a snapshot load does."""
        self._restore_store(ids, vectors)
        self.write_count_since_save = 0


class TpuBruteforce(VectorIndex):
    """Reference VectorIndexBruteforce: holds no data; search raises
    NotSupported so the reader takes the scan + temporary FLAT path."""

    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        super().__init__(index_id, parameter)
        self.device = resolve_device(device)

    def add(self, ids, vectors):  # noqa: D102
        pass

    def upsert(self, ids, vectors):  # noqa: D102
        pass

    def delete(self, ids):  # noqa: D102
        pass

    def search(self, queries, topk, filter_spec=None):
        raise NotSupported("BRUTEFORCE index has no in-memory search")

    def save(self, path):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"index_type": self.index_type.value}, f)

    def load(self, path):
        pass

    def get_count(self) -> int:
        return 0

    def get_memory_size(self) -> int:
        return 0
