"""TpuHnsw: the HNSW graph index, host graph for writes and device graph for
reads (port of dingo_tpu/index/hnsw.py).

Reference: VectorIndexHnsw (src/vector/vector_index_hnsw.{h,cc}, wrapping
hnswlib; NeedToRebuild when deleted > half the total count, :577-589).

Two serving paths share one SlotStore and one exact device rerank:

  host path - graph construction and beam search in the port's copy of the
  native C++ graph (csrc/host/hnsw.cc, bound by dingo_tpu_torch/native):
  an over-fetched candidate set (ef per query), post-filtered on the host,
  then reranked exactly on the device against the SlotStore rows.

  device path (``hnsw_device_search``) - the native level-0 adjacency is
  exported into a slot-space ``[capacity, deg]`` int32 mirror
  (SlotStore.adj, deg = 2 * nlinks) and the walk runs on the card
  (ops/beam.py): frontier gathers, kernel G's candidate scores, a
  per-query visited map, beam merges, ``hnsw_max_iters`` rounds. The
  mirror re-exports lazily on the first search after a write, keyed on
  (native graph version, store mutation version).

Both paths end in the same exact rerank (ops/rerank.py), so their final
order is the same whenever their candidate sets agree. Filters apply on
the device inside the walk (a result beam of eligible slots only) through
a (fingerprint, store version) mask cache, which the host path's
post-filter shares.

A device bulk build (``bulk_builder``; ops/graph_build.py) installs an
adjacency the native graph does not hold; the first host-path use (a
write, a host search, ``save``) replays every row into the native graph
and re-exports its level 0 as the mirror (``_ensure_native_graph``).

The JAX package's quality, heat and integrity hooks are not ported.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import List, Optional

import numpy as np
import torch

from dingo_tpu_torch.common.config import (
    FLAGS,
    hnsw_device_build_enabled,
    hnsw_device_enabled,
)
from dingo_tpu_torch.common.device import resolve_device, upload
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    InvalidParameter,
    SearchResult,
    resolve_precision,
    strip_invalid,
)
from dingo_tpu_torch.index.flat import (
    _SlotStoreIndex,
    _new_tier_store,
    _staged_or_upload,
)
from dingo_tpu_torch.index.ivf_layout import shape_bucket
from dingo_tpu_torch.native import load_hnsw
from dingo_tpu_torch.ops.beam import beam_search
from dingo_tpu_torch.ops.distance import Metric, np_normalize
from dingo_tpu_torch.ops.rerank import exact_rerank_device, sq_rerank_device
from dingo_tpu_torch.ops.topk import begin_host_fetch

#: filter-mask cache entries kept per index
FILTER_CACHE_SIZE = 16

#: rows replayed per native add call in the back-fill after a bulk build
BACKFILL_CHUNK = 8192


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class TpuHnsw(_SlotStoreIndex):
    def __init__(self, index_id: int, parameter: IndexParameter,
                 device=None):
        super().__init__(index_id, parameter)
        p = parameter
        if p.dimension <= 0:
            raise InvalidParameter(f"dimension {p.dimension}")
        if p.metric is Metric.HAMMING:
            raise InvalidParameter("hamming not valid for HNSW")
        self.device = resolve_device(device)
        tier = resolve_precision(parameter)
        self.store = _new_tier_store(tier, p.dimension, self.device)
        self._init_precision(tier)
        self.ef_search_default = max(64, p.efconstruction // 2)
        self._lib = load_hnsw()
        self._graph = self._lib.hnsw_new(
            p.dimension, 0 if p.metric is Metric.L2 else 1, p.nlinks,
            p.efconstruction, index_id)
        self._kernel_metric = p.metric
        #: level-0 degree of the exported adjacency (hnsw M0 = 2 * M)
        self._graph_deg = max(1, int(p.nlinks)) * 2
        #: (native graph version, store mutation version) the mirror was
        #: built against; None = never built
        self._graph_key = None
        self._entry_slot = -1
        #: a device bulk build installed an adjacency the native graph does
        #: not hold yet: the first host-path use back-fills it
        self._native_pending = False
        #: fingerprint -> (store version, numpy mask, device mask or None)
        self._filter_cache: dict = {}

    def __del__(self):  # noqa: D105
        try:
            if getattr(self, "_graph", None):
                self._lib.hnsw_free(self._graph)
        except Exception:
            pass

    # -- prep ---------------------------------------------------------------
    def _prep_vectors(self, vectors: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(super()._prep_vectors(vectors),
                                    np.float32)

    def _prep_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = np.ascontiguousarray(super()._prep_queries(queries),
                                       np.float32)
        if self.metric is Metric.COSINE:
            queries = np_normalize(queries)
        return queries

    # -- mutation ------------------------------------------------------------
    def train(self, vectors: Optional[np.ndarray] = None) -> None:
        """The graph needs no training; the sq8 tier may install its codec
        from an explicit train set (else the first write batch trains
        it)."""
        if self._precision == "sq8" and vectors is not None:
            self.store.maybe_train(self._prep_vectors(vectors))

    def upsert(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self._ensure_native_graph()
        vectors = self._prep_vectors(vectors)
        ids = np.ascontiguousarray(ids, np.int64)
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        slots = self.store.put(ids, vectors)
        self._offer_rerank(slots, vectors)
        self._lib.hnsw_add(self._graph, len(ids), _i64p(ids), _f32p(vectors))
        self.write_count_since_save += len(ids)

    def delete(self, ids: np.ndarray) -> None:
        self._ensure_native_graph()
        ids = np.ascontiguousarray(ids, np.int64)
        slots = self.store.remove_slots(ids)
        self._invalidate_rerank(slots)
        self._lib.hnsw_delete(self._graph, len(ids), _i64p(ids))
        self.write_count_since_save += int((slots >= 0).sum())

    # -- device graph mirror -------------------------------------------------
    def _install_adjacency(self, labels: np.ndarray, adj_nodes: np.ndarray,
                           entry_label: int) -> None:
        """Remap a node-space level-0 export ([n] labels, [n, deg] node
        indices, -1 padded) into the slot-space mirror; the caller holds
        store.device_lock. Nodes whose label has no live slot (tombstones)
        drop: their slot may already hold another vector."""
        store = self.store
        deg = self._graph_deg
        full = np.full((store.capacity, deg), -1, np.int32)
        n = len(labels)
        if n:
            slot_by_node = store.slots_of(labels)
            safe = np.where(adj_nodes >= 0, adj_nodes, 0)
            neigh_slot = slot_by_node[safe].astype(np.int32)
            adj_slots = np.where(adj_nodes >= 0, neigh_slot, np.int32(-1))
            live = slot_by_node >= 0
            full[slot_by_node[live]] = adj_slots[live]
        store.set_graph(full, deg)
        entry = -1
        if entry_label >= 0:
            entry = int(store.slots_of(
                np.asarray([entry_label], np.int64))[0])
        if entry < 0 and n:
            # entry tombstoned in the store: any live slot restarts the walk
            live_slots = np.flatnonzero(store.valid_h)
            if len(live_slots):
                entry = int(live_slots[0])
        self._entry_slot = entry
        METRICS.gauge("hnsw.graph_nodes", region_id=self.id).set(float(n))

    def _export_level0(self):
        """(labels [n], adjacency [n, deg]) of the native level-0 graph in
        node space."""
        n = int(self._lib.hnsw_total_count(self._graph))
        labels = np.empty(n, np.int64)
        adj = np.full((n, self._graph_deg), -1, np.int32)
        if n:
            # n goes back in as the buffers' capacity: the native side
            # clamps to it, so a racing insert cannot overflow them
            self._lib.hnsw_export_level0(
                self._graph, n, self._graph_deg, _i64p(labels),
                adj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return labels, adj

    def _graph_version(self):
        return (int(self._lib.hnsw_graph_version(self._graph)),
                self.store.mutation_version)

    def _ensure_device_graph(self) -> None:
        """Lazy sync of the mirror (caller holds store.device_lock): one
        tuple compare when fresh, a re-export after a write."""
        want = self._graph_version()
        if self._graph_key == want and self.store.adj is not None:
            return
        labels, adj = self._export_level0()
        self._install_adjacency(
            labels, adj, int(self._lib.hnsw_entry_label(self._graph)))
        self._graph_key = want
        METRICS.counter("hnsw.adjacency_rebuilds", region_id=self.id).add(1)

    def adjacency_in_sync(self) -> bool:
        return (self.store.adj is not None
                and self._graph_key == self._graph_version())

    # -- device bulk build ---------------------------------------------------
    def bulk_builder(self, expect_rows: int = 0):
        """A bulk-construction session (the manager's build feeds scan
        pages through it): rows stream into the SlotStore and the level-0
        graph builds on the device in pow2 batches. None when
        ``hnsw_device_build`` says host, or when the index already holds
        rows (a bulk build constructs from empty)."""
        if not hnsw_device_build_enabled(self.device):
            return None
        if len(self.store) or int(self._lib.hnsw_total_count(self._graph)):
            return None
        return _HnswBulkSession(self, expect_rows)

    def _bulk_put(self, ids: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        """upsert() without the native add: the device builder makes the
        edges and the native graph back-fills later."""
        vectors = self._prep_vectors(vectors)
        ids = np.ascontiguousarray(ids, np.int64)
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        slots = self.store.put(ids, vectors)
        self._offer_rerank(slots, vectors)
        self.write_count_since_save += len(ids)
        return slots

    def _install_built_adjacency(self, adj: torch.Tensor,
                                 entry_slot: int) -> None:
        """Install a device-built [capacity, deg] adjacency as the graph:
        the mirror serves device searches at once, ``_graph_key`` pins it
        against a lazy native re-export (which would install the still
        empty native graph), and ``_native_pending`` arms the back-fill."""
        store = self.store
        with store.device_lock:
            store.set_graph(adj, self._graph_deg)
            entry = int(entry_slot)
            if entry < 0 or not store.valid_h[entry]:
                live_slots = np.flatnonzero(store.valid_h)
                entry = int(live_slots[0]) if len(live_slots) else -1
            self._entry_slot = entry
            self._graph_key = self._graph_version()
            self._native_pending = True
        METRICS.gauge("hnsw.graph_nodes", region_id=self.id).set(
            float(len(store)))

    def _ensure_native_graph(self) -> None:
        """Replay the store's rows into the native graph after a device
        bulk build, at the first host-path use (write, host search, save):
        BACKFILL_CHUNK rows per native add, quantized tiers as their
        decoded rows. Then the native level 0 re-installs as the mirror,
        so the device walk, the host graph and snapshots describe one
        topology from here on. Single-threaded native inserts: hours at
        1M x 768 (the JAX package does the same)."""
        if not self._native_pending:
            return
        self._native_pending = False
        store = self.store
        ids = store.ids_by_slot[np.flatnonzero(store.valid_h)]
        for s in range(0, len(ids), BACKFILL_CHUNK):
            chunk = np.ascontiguousarray(ids[s:s + BACKFILL_CHUNK], np.int64)
            _, rows = store.gather(chunk)
            rows = np.ascontiguousarray(rows, np.float32)
            self._lib.hnsw_add(self._graph, len(chunk), _i64p(chunk),
                               _f32p(rows))
        self._graph_key = None
        with store.device_lock:
            self._ensure_device_graph()
        METRICS.counter("build.backfills", region_id=self.id).add(1)

    # -- filter-mask cache ---------------------------------------------------
    def _prep_filter(self, filter_spec: Optional[FilterSpec]):
        """(fingerprint, store version, numpy mask, device mask or None),
        or None for no filter; the numpy mask builds outside the device
        lock."""
        if filter_spec is None or filter_spec.is_empty():
            return None
        fp = filter_spec.fingerprint()
        ver = self.store.mutation_version
        hit = self._filter_cache.get(fp)
        if hit is not None and hit[0] == ver:
            METRICS.counter("hnsw.filter_mask_hits", region_id=self.id).add(1)
            return (fp, ver, hit[1], hit[2])
        mask = filter_spec.slot_mask(self.store.ids_by_slot)
        self._cache_filter(fp, (ver, mask, None))
        METRICS.counter("hnsw.filter_mask_misses", region_id=self.id).add(1)
        return (fp, ver, mask, None)

    def _cache_filter(self, fp: bytes, entry) -> None:
        if len(self._filter_cache) >= FILTER_CACHE_SIZE:
            ver = self.store.mutation_version
            for k in [k for k, v in self._filter_cache.items()
                      if v[0] != ver]:
                del self._filter_cache[k]
            while len(self._filter_cache) >= FILTER_CACHE_SIZE:
                self._filter_cache.pop(next(iter(self._filter_cache)))
        self._filter_cache[fp] = entry

    def _device_filter_mask(self, filter_spec, prep):
        """[capacity] bool mask on the device for the walk (caller holds
        store.device_lock): uploaded once per (filter, store version),
        rebuilt when a write raced the prep."""
        if prep is None:
            return None
        fp, ver, np_mask, dev = prep
        cur = self.store.mutation_version
        if dev is not None and ver == cur:
            return dev
        if ver != cur or np_mask is None:
            np_mask = filter_spec.slot_mask(self.store.ids_by_slot)
            ver = cur
        dev = upload(np_mask, self.device)
        self._cache_filter(fp, (ver, np_mask, dev))
        return dev

    # -- search --------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int,
               filter_spec: Optional[FilterSpec] = None,
               ef: Optional[int] = None) -> List[SearchResult]:
        return self.search_async(queries, topk, filter_spec, ef)()

    def search_async(self, queries: np.ndarray, topk: int,
                     filter_spec: Optional[FilterSpec] = None,
                     ef: Optional[int] = None, staged=None):
        """Dispatch the search and return the thunk that resolves it (one
        host sync). ``ef``: the request's search width (default
        max(64, efconstruction / 2)), at least topk."""
        queries = self._prep_queries(queries)
        b = queries.shape[0]
        ef = max(int(ef or self.tuned("ef", self.ef_search_default)),
                 int(topk))
        if self._device_search_on():
            return self._device_search_async(queries, b, int(topk),
                                             filter_spec, ef, staged)
        return self._host_search_async(queries, b, int(topk), filter_spec,
                                       ef, staged)

    def _device_search_on(self) -> bool:
        return hnsw_device_enabled(self.device) and len(self.store) > 0

    def _beam_width(self, ef: int, topk: int) -> int:
        """ef -> beam: a fixed hnsw_device_beam wins, else the {1,1.5} x
        pow2 shape bucket (a handful of shapes in steady state)."""
        fixed = int(FLAGS.get("hnsw_device_beam"))
        if fixed > 0:
            return max(fixed, topk)
        return max(shape_bucket(max(ef, topk)), 1)

    def _codec(self):
        """(sq on, vmin, scale): the sq8 store's codec on the device, else
        an identity codec."""
        store = self.store
        if self._precision == "sq8" and store.sq_params is not None:
            return True, store.sq_vmin_d, store.sq_scale_d
        vmin = torch.zeros((self.dimension,), dtype=torch.float32,
                           device=self.device)
        return False, vmin, torch.ones_like(vmin)

    def _device_search_async(self, queries, b, topk, filter_spec, ef,
                             staged=None):
        store = self.store
        beam = self._beam_width(ef, topk)
        max_iters = max(1, int(FLAGS.get("hnsw_max_iters")))
        METRICS.counter("hnsw.device_searches", region_id=self.id).add(1)
        prep = self._prep_filter(filter_spec)
        qpad = _staged_or_upload(staged, queries, self.device)
        lease = store.begin_search()
        try:
            with store.device_lock:
                self._ensure_device_graph()
                valid = store.device_mask()
                fmask = self._device_filter_mask(filter_spec, prep)
                sq_on, vmin, scale = self._codec()
                cap = store.capacity
                rslots, hops, vcount, occ = beam_search(
                    store.adj, store.vecs, store.sqnorm, valid,
                    fmask if fmask is not None else valid, qpad,
                    self._entry_slot, vmin, scale, beam=beam,
                    max_iters=max_iters, metric=self._kernel_metric,
                    sq=sq_on)
                dists, out_slots = self._final_rerank(qpad, rslots, topk)
        except Exception:
            lease.release()
            raise
        # the walk's diagnostics join the reply's one fetch group
        fetch = begin_host_fetch(dists, out_slots, hops, vcount, occ)

        def resolve() -> List[SearchResult]:
            try:
                dists_h, slots_h, hops_h, vc_h, occ_h = fetch.get()
                self._note_walk_stats(hops_h[:b], vc_h[:b], occ_h[:b], cap,
                                      beam)
                ids = store.ids_of_slots(slots_h[:b].astype(np.int64))
                return [strip_invalid(i, d)
                        for i, d in zip(ids, dists_h[:b])]
            finally:
                lease.release()

        return resolve

    def _host_search_async(self, queries, b, topk, filter_spec, ef,
                           staged=None):
        self._ensure_native_graph()
        METRICS.counter("hnsw.host_searches", region_id=self.id).add(1)
        # 1) host graph: over-fetched candidate labels per query
        cand_labels = np.empty((b, ef), np.int64)
        cand_d = np.empty((b, ef), np.float32)
        self._lib.hnsw_search(self._graph, b, _f32p(queries), ef, ef,
                              _i64p(cand_labels), _f32p(cand_d))
        # 2) host post-filter through the shared mask cache (the graph
        #    itself has no filter pushdown)
        prep = self._prep_filter(filter_spec)
        slots = self.store.slots_of(cand_labels.reshape(-1)).reshape(b, ef)
        valid = slots >= 0
        if prep is not None:
            fmask = prep[2]
            if prep[1] != self.store.mutation_version:  # raced a write
                fmask = filter_spec.slot_mask(self.store.ids_by_slot)
            valid &= fmask[np.where(slots >= 0, slots, 0)]
        # 3) the exact device rerank the device path ends in too
        qpad = _staged_or_upload(staged, queries, self.device)
        bb = qpad.shape[0]
        cand = np.where(valid, slots, -1).astype(np.int32)
        if bb != b:
            cand = np.concatenate([cand, np.full((bb - b, ef), -1, np.int32)])
        store = self.store
        lease = store.begin_search()   # slots stable until resolve
        try:
            with store.device_lock:
                dists, out_slots = self._final_rerank(
                    qpad, upload(cand, self.device), topk)
        except Exception:
            lease.release()
            raise
        fetch = begin_host_fetch(dists, out_slots)

        def resolve() -> List[SearchResult]:
            try:
                dists_h, slots_h = fetch.get()
                ids = store.ids_of_slots(slots_h[:b].astype(np.int64))
                return [strip_invalid(i, d)
                        for i, d in zip(ids, dists_h[:b])]
            finally:
                lease.release()

        return resolve

    def _final_rerank(self, qpad, cand_slots, topk: int):
        """Exact device rerank of a candidate set (caller holds
        store.device_lock): fp32 exactly; bf16 on the stored rows widened
        to f32; sq8 decoded on the device (exact for the tier), chaining
        the cached f32 rerank when a rerank cache holds rows."""
        store = self.store
        metric = self._kernel_metric
        if self._precision == "sq8":
            vmin, scale = store.codec_device()
            cache = self._rerank_cache
            if cache is not None and len(cache):
                kk = int(cand_slots.shape[1])
                dists, slots = sq_rerank_device(
                    store.vecs, vmin, scale, store.sqnorm, qpad, cand_slots,
                    k=kk, metric=metric)
                return self._dispatch_rerank(qpad, dists, slots, topk)
            return sq_rerank_device(store.vecs, vmin, scale, store.sqnorm,
                                    qpad, cand_slots, k=topk, metric=metric)
        return exact_rerank_device(store.vecs, store.sqnorm, qpad,
                                   cand_slots, k=topk, metric=metric)

    def _note_walk_stats(self, hops, vcount, occ, cap, beam) -> None:
        """Fold one resolved device walk into the metrics (from resolve():
        the dispatch never waits for them)."""
        METRICS.gauge("hnsw.mean_hops", region_id=self.id).set(
            float(np.mean(hops)) if len(hops) else 0.0)
        METRICS.gauge("hnsw.visited_fraction", region_id=self.id).set(
            float(np.mean(vcount)) / max(1, cap) if len(vcount) else 0.0)
        METRICS.gauge("hnsw.beam_occupancy", region_id=self.id).set(
            float(np.mean(occ)) / max(1, beam) if len(occ) else 0.0)

    def warmup(self, batches=(1, 8, 64), topk: int = 10,
               ef: Optional[int] = None) -> int:
        """Run one search per batch bucket so that steady-state serving
        meets no new kernel shape; no-op on an empty index."""
        if len(self.store) == 0:
            return 0
        for bsz in batches:
            self.search(np.ones((int(bsz), self.dimension), np.float32),
                        topk, ef=ef)
        return len(batches)

    # -- lifecycle ------------------------------------------------------------
    def get_count(self) -> int:
        return len(self.store)

    def get_deleted_count(self) -> int:
        return int(self._lib.hnsw_deleted_count(self._graph))

    def get_memory_size(self) -> int:
        return self.store.memory_size() + int(
            self._lib.hnsw_memory(self._graph))

    def need_to_rebuild(self) -> bool:
        """Reference trigger: deleted > total / 2 (tombstones count in the
        total, as hnswlib's element count does)."""
        deleted = self.get_deleted_count()
        total = deleted + self.get_count()
        return total > 0 and deleted * 2 > total

    def _save_meta(self) -> dict:
        meta = super()._save_meta()
        meta["hnsw_graph"] = {
            "deg": self._graph_deg,
            "nodes": int(self._lib.hnsw_total_count(self._graph)),
            "entry_label": int(self._lib.hnsw_entry_label(self._graph)),
        }
        return meta

    def save(self, path: str) -> None:
        """The JAX package's snapshot format: meta.json, hnsw_vectors.npz
        (f32 rows, or sq8 codes with their codec), the native graph blob
        and the level-0 adjacency in node space."""
        self._ensure_native_graph()
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "hnsw_vectors.npz"), **self._save_rows())
        size = self._lib.hnsw_save_size(self._graph)
        buf = np.empty(size, np.uint8)
        written = self._lib.hnsw_save(
            self._graph, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        with open(os.path.join(path, "hnsw_graph.bin"), "wb") as f:
            f.write(buf[:written].tobytes())
        labels, adj = self._export_level0()
        np.savez(os.path.join(path, "hnsw_adj.npz"), labels=labels, adj=adj)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(self._save_meta(), f)

    def load(self, path: str) -> None:
        """Reads the JAX package's snapshots as well as its own."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self._check_meta(meta)
        data = np.load(os.path.join(path, "hnsw_vectors.npz"))
        self._restore_store(data["ids"], **self._snapshot_rows(data))
        blob = np.fromfile(os.path.join(path, "hnsw_graph.bin"), np.uint8)
        new_graph = self._lib.hnsw_load(
            blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(blob))
        if not new_graph:
            raise InvalidParameter("bad hnsw graph blob")
        self._lib.hnsw_free(self._graph)
        self._graph = new_graph
        self._filter_cache.clear()
        self._graph_key = None
        self._entry_slot = -1
        self._native_pending = False   # the loaded blob is the graph
        adj_path = os.path.join(path, "hnsw_adj.npz")
        graph_meta = meta.get("hnsw_graph")
        if graph_meta and os.path.exists(adj_path) \
                and int(graph_meta.get("deg", -1)) == self._graph_deg:
            snap = np.load(adj_path)
            with self.store.device_lock:
                self._install_adjacency(
                    np.asarray(snap["labels"], np.int64),
                    np.asarray(snap["adj"], np.int32),
                    int(graph_meta.get("entry_label", -1)))
                self._graph_key = self._graph_version()
        self.apply_log_id = meta["apply_log_id"]
        self.write_count_since_save = 0


class _HnswBulkSession:
    """One bulk construction: rows in by add(), graph installed by
    finish(). Owns a BulkGraphBuilder over the index's SlotStore."""

    def __init__(self, index: TpuHnsw, expect_rows: int = 0):
        from dingo_tpu_torch.ops.graph_build import BulkGraphBuilder

        self.index = index
        if expect_rows > 0:
            index.store.reserve(expect_rows)
        self.builder = BulkGraphBuilder(
            index.store, index._graph_deg, index._kernel_metric,
            sq=(index._precision == "sq8"),
            batch_rows=int(FLAGS.get("hnsw_build_batch")),
            beam=index._beam_width(index.parameter.efconstruction, 1),
            max_iters=max(1, int(FLAGS.get("hnsw_max_iters"))),
            alpha=float(FLAGS.get("hnsw_build_alpha")),
            region_id=index.id,
        )

    def add(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        slots = self.index._bulk_put(ids, vectors)
        self.builder.add_slots(np.asarray(slots, np.int32))

    def finish(self) -> dict:
        adj, entry, stats = self.builder.finish()
        self.index._install_built_adjacency(adj, entry)
        METRICS.counter("build.device_builds", region_id=self.index.id).add(1)
        return stats
