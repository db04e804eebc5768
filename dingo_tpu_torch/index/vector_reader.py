"""VectorReader: region-local search orchestration (the query planner;
port of dingo_tpu/index/vector_reader.py).

Reference: src/vector/vector_reader.{h,cc} (2,429 LoC) — VectorBatchSearch
(vector_reader.cc:439) -> SearchVector (:104) dispatches on filter mode:
  SCALAR post-filter  — over-fetch topk*10, then compare scalar data (:120-215)
  VECTOR_ID pre-filter — explicit candidate ids (:216-222, impl :830)
  SCALAR pre-filter   — scan scalar CF for candidates -> id filter (:853);
                        reads the narrow speed-up CF when it covers the
                        filter's fields (SplitVectorScalarData contract)
  TABLE filter        — coprocessor over the vector_table CF (:169-232),
                        pre (scan -> candidate ids) and post (over-fetch
                        then filter rows) variants
plus SearchAndRangeSearchWrapper (:1781) choosing index search vs
BruteForceSearch (:1873: scan region KVs in 2,048-vector batches —
FLAGS_vector_index_bruteforce_batch_count :61 — build temp flat index,
search, merge per-query top-k), and the VectorBatchQuery / GetBorderId /
ScanQuery / Count entry points (vector_reader.h:44-88).

The port: the brute-force path builds its temporary FLAT index on the
reader's ``device`` (None = the CUDA device; DeviceUnavailable without
one). Only NotSupported and NotTrained fall back to brute force, as in the
JAX package; NotPorted propagates. A device OOM walks the recovery ladder
(index/recovery.py), and a device-degraded region is served by an exact
numpy scan of the engine (``_host_exact_search``); every other error
propagates. Search parameters (``nprobe``, HNSW's ``ef``) pass through
to the index. A TABLE filter runs a CoprocessorV2 over the region's table
rows: the pre variant hands the matching ids to the index as a filter, the
post variant filters an over-fetched search on the host. A binary
region (BINARY_FLAT, BINARY_IVF_FLAT) keeps its rows and queries as
packed uint8: its brute force scans a temporary TpuBinaryFlat and its
degraded host path counts differing bits. The async arm fills ``stage_us`` with the
device wait and fetch (``search_us``) apart from the whole resolve
(``total_us``), which also builds the reply rows.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.coprocessor.scalar_filter import ScalarFilter
from dingo_tpu_torch.engine.raw_engine import (
    CF_DEFAULT,
    CF_VECTOR_SCALAR,
    CF_VECTOR_SCALAR_SPEEDUP,
    CF_VECTOR_TABLE,
    RawEngine,
)
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.index.base import (
    FilterSpec,
    IndexParameter,
    IndexType,
    NotSupported,
    NotTrained,
    SearchResult,
    VectorIndexError,
)
from dingo_tpu_torch.index.flat import TpuBinaryFlat, TpuFlat
from dingo_tpu_torch.index.recovery import RECOVERY, DeviceDegraded
from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
from dingo_tpu_torch.mvcc.codec import MAX_TS
from dingo_tpu_torch.mvcc.reader import Reader as MvccReader
from dingo_tpu_torch.obs.hbm import looks_like_oom
from dingo_tpu_torch.raft import wire
from dingo_tpu_torch.trace import TRACER

#: FLAGS_vector_index_bruteforce_batch_count (vector_reader.cc:61)
BRUTEFORCE_BATCH = 2048
#: scalar post-filter over-fetch multiplier (vector_reader.cc:137,182)
POST_FILTER_OVERFETCH = 10
#: FLAGS_vector_max_range_search_result_count (vector_reader.cc:60)
RANGE_SEARCH_CAP = 1024


class VectorFilterMode(enum.Enum):
    """pb::common::VectorFilter."""

    NONE = "none"
    SCALAR = "scalar"          # scalar key/values must match
    VECTOR_ID = "vector_id"    # explicit candidate list
    TABLE = "table"            # coprocessor over table data


class VectorFilterType(enum.Enum):
    """pb::common::VectorFilterType."""

    QUERY_POST = "post"
    QUERY_PRE = "pre"


@dataclasses.dataclass
class VectorWithData:
    id: int
    distance: float = 0.0
    vector: Optional[np.ndarray] = None
    scalar: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ReaderContext:
    """Engine::VectorReader::Context (engine.h:124-156)."""

    region_id: int
    partition_id: int
    start_key: bytes
    end_key: bytes
    index_wrapper: Optional[VectorIndexWrapper]
    engine: RawEngine
    read_ts: int = MAX_TS
    parameter: Optional[IndexParameter] = None

    def id_window(self) -> Tuple[int, int]:
        return vcodec.range_to_vector_ids(self.start_key, self.end_key)


def is_binary_dim_param(param) -> bool:
    """True when param describes a binary (bit-packed) index: dimension is
    in bits, rows on the wire/data-CF are dimension//8 uint8 bytes."""
    from dingo_tpu_torch.index.base import IndexType as _IT

    return param is not None and param.index_type in (
        _IT.BINARY_FLAT, _IT.BINARY_IVF_FLAT
    )


def serialize_vector(v: np.ndarray) -> bytes:
    """Data-CF row bytes: uint8 rows (binary indexes) stay raw bit-packed
    bytes; everything else is little-endian f32."""
    v = np.asarray(v)
    if v.dtype == np.uint8:
        return v.tobytes()
    return np.asarray(v, np.float32).tobytes()


def deserialize_vector(b: bytes, dim: int, binary: bool = False) -> np.ndarray:
    if binary:
        return np.frombuffer(b, np.uint8, count=dim // 8)
    return np.frombuffer(b, np.float32, count=dim)


def serialize_scalar(scalar: Dict[str, Any]) -> bytes:
    return wire.encode_obj(scalar)


def deserialize_scalar(b: bytes) -> Dict[str, Any]:
    return wire.decode_obj(b)


class VectorReader:
    def __init__(self, ctx: ReaderContext, device=None):
        self.ctx = ctx
        self.device = resolve_device(device)
        self._data = MvccReader(ctx.engine, CF_DEFAULT)
        self._scalar = MvccReader(ctx.engine, CF_VECTOR_SCALAR)
        self._speedup = MvccReader(ctx.engine, CF_VECTOR_SCALAR_SPEEDUP)
        self._table = MvccReader(ctx.engine, CF_VECTOR_TABLE)
        self._binary = is_binary_dim_param(ctx.parameter)

    def _scalar_source(
        self, scalar_filter: Optional[ScalarFilter]
    ) -> MvccReader:
        """The narrow speed-up CF when it covers every field the filter
        reads (apply writes the flagged subset there —
        raft_apply_handler.cc:1115 via SplitVectorScalarData); the wide
        scalar CF otherwise. Match semantics are identical: a vector
        without any flagged field has no narrow row, and a filter on a
        missing field never matches."""
        keys = tuple(
            getattr(self.ctx.parameter, "scalar_speedup_keys", ()) or ()
        ) if self.ctx.parameter else ()
        if (
            keys
            and scalar_filter is not None
            and not scalar_filter.is_empty()
            and scalar_filter.fields() <= set(keys)
        ):
            return self._speedup
        return self._scalar

    def _deser(self, blob: bytes) -> np.ndarray:
        return deserialize_vector(blob, self.ctx.parameter.dimension,
                                  binary=self._binary)

    def _query_dtype(self):
        return np.uint8 if self._binary else np.float32

    # ---------------- public entry points (vector_reader.h:44-88) ----------

    def vector_batch_search(
        self,
        queries: np.ndarray,
        topk: int,
        filter_mode: VectorFilterMode = VectorFilterMode.NONE,
        filter_type: VectorFilterType = VectorFilterType.QUERY_POST,
        **kw,
    ) -> List[List[VectorWithData]]:
        """Batch search. When `stage_us` (kw) is a dict it receives
        per-stage wall times in microseconds (prefilter/search/postfilter/
        backfill/total) — the VectorSearchDebug contract
        (vector_reader.h:85-88)."""
        with TRACER.start_span("index.search") as span:
            if span.sampled:
                span.set_attr("region_id", self.ctx.region_id)
                span.set_attr("batch", int(np.atleast_2d(queries).shape[0]))
                span.set_attr("topk", int(topk))
                span.set_attr("filter_mode", filter_mode.value)
            return self._batch_search_impl(
                queries, topk, filter_mode, filter_type, **kw
            )

    def vector_batch_search_async(
        self,
        queries: np.ndarray,
        topk: int,
        staged=None,
        stage_us: Optional[dict] = None,
        **search_kw,
    ):
        """Dispatch-now/resolve-later arm of vector_batch_search for the
        serving pipeline's coalescer: kernels enqueue here (flush
        thread), the returned thunk performs the reply's single host
        sync (completion lane). PLAIN searches only — the coalescer's
        plain-path conditions (no filters, no radius, no data backfill)
        are exactly the shapes whose whole post-kernel work is the one
        fetch. Anything that cannot stay async — degraded region,
        wrapper not ready/supported, a dispatch-time error — falls back to
        a thunk around the full sync path, which keeps its brute-force and
        OOM-recovery ladders.
        ``stage_us`` is filled at RESOLVE time: search_us there is the
        device wait and fetch, which the coalescer books as kernel time;
        total_us also holds the reply rows' construction (the dispatch
        stage is accounted separately)."""
        import time as _time

        queries = np.asarray(queries, self._query_dtype())
        if queries.ndim == 1:
            queries = queries[None, :]

        def sync_thunk():
            return self.vector_batch_search(
                queries, topk, stage_us=stage_us, **search_kw
            )

        wrapper = self.ctx.index_wrapper
        if (wrapper is None or not wrapper.is_ready()
                or RECOVERY.is_degraded(self.ctx.region_id)):
            return sync_thunk
        base = FilterSpec(ranges=[self.ctx.id_window()])
        with TRACER.start_span("index.search") as span:
            if span.sampled:
                span.set_attr("region_id", self.ctx.region_id)
                span.set_attr("batch", int(queries.shape[0]))
                span.set_attr("topk", int(topk))
                span.set_attr("pipelined", True)
            try:
                thunk = wrapper.search_async(
                    queries, topk, base, staged=staged, **search_kw
                )
            except Exception:  # noqa: BLE001 — sync path re-raises real
                # errors through its own fallback/recovery ladders
                return sync_thunk

        def resolve() -> List[List[VectorWithData]]:
            t0 = _time.perf_counter_ns()
            results = thunk()
            wait_ns = _time.perf_counter_ns() - t0
            out = [
                [VectorWithData(int(i), float(d))
                 for i, d in zip(r.ids, r.distances)]
                for r in results
            ]
            if stage_us is not None:
                total_ns = _time.perf_counter_ns() - t0
                stage_us["prefilter_us"] = 0
                stage_us["postfilter_us"] = 0
                stage_us["backfill_us"] = 0
                stage_us["search_us"] = wait_ns // 1000
                stage_us["total_us"] = total_ns // 1000
            return out

        return resolve

    def _batch_search_impl(
        self,
        queries: np.ndarray,
        topk: int,
        filter_mode: VectorFilterMode = VectorFilterMode.NONE,
        filter_type: VectorFilterType = VectorFilterType.QUERY_POST,
        scalar_filter: Optional[ScalarFilter] = None,
        vector_ids: Optional[Sequence[int]] = None,
        coprocessor=None,
        with_vector_data: bool = False,
        with_scalar_data: bool = False,
        stage_us: Optional[dict] = None,
        **search_kw,
    ) -> List[List[VectorWithData]]:
        import time as _time

        t_start = _time.perf_counter_ns()
        prefilter_ns = postfilter_ns = backfill_ns = 0
        queries = np.asarray(queries, self._query_dtype())
        if queries.ndim == 1:
            queries = queries[None, :]
        base = FilterSpec(ranges=[self.ctx.id_window()])

        radius = search_kw.pop("radius", 0.0)
        if filter_mode is VectorFilterMode.VECTOR_ID:
            # pre-filter on explicit ids (vector_reader.cc:216-222, :830)
            t0 = _time.perf_counter_ns()
            ids = np.asarray(sorted(set(map(int, vector_ids or []))), np.int64)
            spec = FilterSpec(ranges=base.ranges, include_ids=ids)
            prefilter_ns = _time.perf_counter_ns() - t0
            results = self._search_with_fallback(queries, topk, spec, **search_kw)
        elif filter_mode is VectorFilterMode.SCALAR and (
            filter_type is VectorFilterType.QUERY_PRE
        ):
            # scan scalar CF for candidates (vector_reader.cc:853)
            t0 = _time.perf_counter_ns()
            cand = self._scan_scalar_candidates(scalar_filter)
            spec = FilterSpec(ranges=base.ranges, include_ids=cand)
            prefilter_ns = _time.perf_counter_ns() - t0
            results = self._search_with_fallback(queries, topk, spec, **search_kw)
        elif filter_mode is VectorFilterMode.SCALAR:
            # post-filter with x10 over-fetch (vector_reader.cc:120-215)
            over = self._search_with_fallback(
                queries, topk * POST_FILTER_OVERFETCH, base, **search_kw
            )
            t0 = _time.perf_counter_ns()
            results = [
                self._post_filter_scalar(r, scalar_filter, topk) for r in over
            ]
            postfilter_ns = _time.perf_counter_ns() - t0
        elif filter_mode is VectorFilterMode.TABLE and (
            filter_type is VectorFilterType.QUERY_PRE
        ):
            # coprocessor over the table CF -> candidate ids
            # (vector_reader.cc:169-232 TABLE dispatch, pre variant)
            t0 = _time.perf_counter_ns()
            cand = self._scan_table_candidates(coprocessor)
            spec = FilterSpec(ranges=base.ranges, include_ids=cand)
            prefilter_ns = _time.perf_counter_ns() - t0
            results = self._search_with_fallback(queries, topk, spec, **search_kw)
        elif filter_mode is VectorFilterMode.TABLE:
            # post variant: over-fetch then coprocessor-filter each
            # candidate's table row (same x10 contract as SCALAR post)
            over = self._search_with_fallback(
                queries, topk * POST_FILTER_OVERFETCH, base, **search_kw
            )
            t0 = _time.perf_counter_ns()
            results = [
                self._post_filter_table(r, coprocessor, topk) for r in over
            ]
            postfilter_ns = _time.perf_counter_ns() - t0
        else:
            results = self._search_with_fallback(queries, topk, base, **search_kw)

        if radius:
            # range-search semantics: keep hits within radius, capped at
            # RANGE_SEARCH_CAP (vector_reader.cc:60)
            results = [self._radius_cut(r, radius) for r in results]
        out: List[List[VectorWithData]] = []
        for r in results:
            row = [
                VectorWithData(int(i), float(d))
                for i, d in zip(r.ids, r.distances)
            ]
            out.append(row)
        if with_vector_data or with_scalar_data:
            t0 = _time.perf_counter_ns()
            self._backfill_many(out, with_vector_data, with_scalar_data)
            backfill_ns = _time.perf_counter_ns() - t0
        if stage_us is not None:
            total_ns = _time.perf_counter_ns() - t_start
            stage_us["prefilter_us"] = prefilter_ns // 1000
            stage_us["postfilter_us"] = postfilter_ns // 1000
            stage_us["backfill_us"] = backfill_ns // 1000
            stage_us["total_us"] = total_ns // 1000
            stage_us["search_us"] = (
                total_ns - prefilter_ns - postfilter_ns - backfill_ns
            ) // 1000
        return out

    def _radius_cut(self, r: SearchResult, radius: float) -> SearchResult:
        from dingo_tpu_torch.ops.distance import Metric, metric_ascending

        metric = self.ctx.parameter.metric if self.ctx.parameter else Metric.L2
        keep = (r.distances <= radius) if metric_ascending(metric) \
            else (r.distances >= radius)
        return SearchResult(r.ids[keep][:RANGE_SEARCH_CAP],
                            r.distances[keep][:RANGE_SEARCH_CAP])

    def vector_batch_query(
        self,
        vector_ids: Sequence[int],
        with_vector_data: bool = True,
        with_scalar_data: bool = False,
    ) -> List[Optional[VectorWithData]]:
        keys = {
            int(vid): vcodec.encode_vector_key(self.ctx.partition_id, int(vid))
            for vid in vector_ids
        }
        data_map = self._data.kv_batch_get(keys.values(), self.ctx.read_ts)
        scalar_map = (
            self._scalar.kv_batch_get(keys.values(), self.ctx.read_ts)
            if with_scalar_data else {}
        )
        out: List[Optional[VectorWithData]] = []
        for vid in vector_ids:
            key = keys[int(vid)]
            blob = data_map.get(key)
            if blob is None:
                out.append(None)
                continue
            v = VectorWithData(int(vid))
            if with_vector_data and self.ctx.parameter:
                v.vector = self._deser(blob)
            if with_scalar_data:
                sb = scalar_map.get(key)
                v.scalar = deserialize_scalar(sb) if sb else {}
            out.append(v)
        return out

    def vector_get_border_id(self, get_min: bool) -> Optional[int]:
        """Min/max visible vector id in the region (VectorGetBorderId)."""
        mn, mx = self.vector_border_ids()
        return mn if get_min else mx

    def vector_border_ids(self):
        """(min_id, max_id) in ONE visibility scan ((None, None) when
        empty) — metrics endpoints poll this, so don't scan twice."""
        ids = self._visible_ids()
        if not ids:
            return None, None
        return min(ids), max(ids)

    def vector_scan_query(
        self,
        start_id: int,
        end_id: Optional[int] = None,
        limit: int = 1000,
        is_reverse: bool = False,
        with_vector_data: bool = True,
        with_scalar_data: bool = False,
        scalar_filter: Optional[ScalarFilter] = None,
    ) -> List[VectorWithData]:
        lo, hi = self.ctx.id_window()
        lo = max(lo, int(start_id)) if not is_reverse else lo
        if end_id is not None:
            hi = min(hi, int(end_id) + 1)
        out: List[VectorWithData] = []
        items = self._scan_data(lo, hi)
        if is_reverse:
            items = list(items)[::-1]
            items = [x for x in items if x[0] <= start_id]
        for vid, blob in items:
            v = VectorWithData(vid)
            if with_scalar_data or (scalar_filter and not scalar_filter.is_empty()):
                key = vcodec.encode_vector_key(self.ctx.partition_id, vid)
                sb = self._scalar.kv_get(key, self.ctx.read_ts)
                scalar = deserialize_scalar(sb) if sb else {}
                if scalar_filter and not scalar_filter.matches(scalar):
                    continue
                if with_scalar_data:
                    v.scalar = scalar
            if with_vector_data and self.ctx.parameter:
                v.vector = self._deser(blob)
            out.append(v)
            if len(out) >= limit:
                break
        return out

    def vector_count(self) -> int:
        return sum(1 for _ in self._scan_data(*self.ctx.id_window()))

    # ---------------- internals --------------------------------------------

    def _search_with_fallback(
        self, queries: np.ndarray, topk: int, spec: FilterSpec, **kw
    ) -> List[SearchResult]:
        """SearchAndRangeSearchWrapper (:1781): index search when the wrapper
        is ready and supports it, else brute-force scan (:1873). Only the
        reference's EVECTOR_NOT_SUPPORT / EVECTOR_INDEX_NOT_TRAIN fall back;
        NotPorted propagates. A device-degraded region (index/recovery.py)
        serves the exact host path; a device OOM mid-search walks the
        recovery ladder and serves the host path if the region degrades;
        any other error propagates."""
        wrapper = self.ctx.index_wrapper
        if wrapper is not None and RECOVERY.is_degraded(self.ctx.region_id):
            return self._host_exact_search(queries, topk, spec)
        if wrapper is not None and wrapper.is_ready():
            try:
                return wrapper.search(queries, topk, spec, **kw)
            except (NotSupported, NotTrained):
                pass  # EVECTOR_NOT_SUPPORT contract -> brute force
            except Exception as e:  # noqa: BLE001 - OOM-classified below
                if not (looks_like_oom(e) and RECOVERY.enabled()):
                    raise
                try:
                    return RECOVERY.attempt(
                        wrapper, self.ctx.region_id,
                        lambda: wrapper.search(queries, topk, spec, **kw),
                        kind="search", cause=e)
                except DeviceDegraded:
                    return self._host_exact_search(queries, topk, spec)
        return self._brute_force_search(queries, topk, spec)

    def _host_exact_search(
        self, queries: np.ndarray, topk: int, spec: FilterSpec
    ) -> List[SearchResult]:
        """Degraded-mode serving: an exact scan of the engine's rows in
        numpy, with no device tensor at all (the brute-force path builds a
        temporary device FLAT, which is what just failed). The engine holds
        every acknowledged write, those applied while the device index was
        degraded included."""
        from dingo_tpu_torch.ops.distance import Metric, metric_ascending

        param = self.ctx.parameter
        if param is None:
            raise VectorIndexError("host exact search needs index parameter")
        with TRACER.start_span("index.host_exact") as span:
            span.set_attr("region_id", self.ctx.region_id)
            ids_l: List[int] = []
            rows: List[np.ndarray] = []
            for vid, blob in self._scan_data(*self.ctx.id_window()):
                ids_l.append(vid)
                rows.append(self._deser(blob))
            span.set_attr("rows", len(ids_l))
            nq = len(queries)
            if not ids_l:
                return [SearchResult(np.empty(0, np.int64),
                                     np.empty(0, np.float32))
                        for _ in range(nq)]
            ids = np.asarray(ids_l, np.int64)
            valid = self._spec_mask(ids, spec)
            metric = param.metric
            if self._binary:
                db = np.unpackbits(np.stack(rows).astype(np.uint8), axis=1)
                qb = np.unpackbits(
                    np.asarray(queries, np.uint8).reshape(nq, -1), axis=1)
                # hamming distance from products of the {0, 1} planes
                scores = -(qb @ (1 - db).T.astype(np.float32)
                           + (1 - qb) @ db.T.astype(np.float32))
            elif metric is Metric.L2:
                vecs = np.stack(rows).astype(np.float32)
                q = np.asarray(queries, np.float32)
                scores = -(
                    (q ** 2).sum(1)[:, None]
                    - 2.0 * q @ vecs.T
                    + (vecs ** 2).sum(1)[None, :]
                )
            else:
                # COSINE rows are stored normalized by the write path, as
                # in the JAX package: the inner product is the score
                scores = np.asarray(queries, np.float32) @ np.stack(
                    rows).astype(np.float32).T
            scores = np.where(valid[None, :], scores, -np.inf)
            kk = min(int(topk), scores.shape[1])
            part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
            vals = np.take_along_axis(scores, part, axis=1)
            order = np.argsort(-vals, axis=1)
            part = np.take_along_axis(part, order, axis=1)
            vals = np.take_along_axis(vals, order, axis=1)
            out: List[SearchResult] = []
            for qi in range(nq):
                keep = ~np.isneginf(vals[qi])
                d = vals[qi][keep]
                d = -d if metric_ascending(metric) else d
                out.append(SearchResult(ids[part[qi][keep]],
                                        np.asarray(d, np.float32)))
            return out

    @staticmethod
    def _spec_mask(ids: np.ndarray, spec: Optional[FilterSpec]) -> np.ndarray:
        """FilterSpec evaluated against external ids (the host path has no
        slot space)."""
        mask = np.ones(len(ids), np.bool_)
        if spec is None or spec.is_empty():
            return mask
        if spec.ranges:
            rm = np.zeros(len(ids), np.bool_)
            for lo, hi in spec.ranges:
                rm |= (ids >= lo) & (ids < hi)
            mask &= rm
        if spec.include_ids is not None:
            mask &= np.isin(ids, np.asarray(spec.include_ids, np.int64))
        if spec.exclude_ids is not None:
            mask &= ~np.isin(ids, np.asarray(spec.exclude_ids, np.int64))
        return mask

    def _brute_force_search(
        self, queries: np.ndarray, topk: int, spec: FilterSpec
    ) -> List[SearchResult]:
        """Scan region data in BRUTEFORCE_BATCH chunks into a temp flat index
        (the reference builds a temp faiss flat per 2,048-vector batch and
        merges per-query top-k heaps; one TPU flat over the scan is the same
        result with fewer kernel launches)."""
        with TRACER.start_span("index.bruteforce") as span:
            out = self._brute_force_search_impl(queries, topk, spec)
            span.set_attr("batch", len(queries))
            return out

    def _brute_force_search_impl(
        self, queries: np.ndarray, topk: int, spec: FilterSpec
    ) -> List[SearchResult]:
        if self.ctx.parameter is None:
            raise VectorIndexError("brute force needs index parameter (dim)")
        # a binary region scans a temporary binary FLAT
        itype, cls = ((IndexType.BINARY_FLAT, TpuBinaryFlat) if self._binary
                      else (IndexType.FLAT, TpuFlat))
        param = IndexParameter(
            index_type=itype,
            dimension=self.ctx.parameter.dimension,
            metric=self.ctx.parameter.metric,
        )
        temp = cls(self.ctx.region_id, param, device=self.device)
        for ids, vecs in self.scan_pages(BRUTEFORCE_BATCH):
            temp.upsert(ids, vecs)
        if temp.get_count() == 0:
            return [SearchResult(np.empty(0, np.int64), np.empty(0, np.float32))
                    for _ in range(len(queries))]
        return temp.search(queries, topk, spec)

    def scan_pages(self, rows: int):
        """The region's visible vectors in ascending id order as pages of
        (ids int64 [<= rows], vectors [<= rows, d]), all from one engine
        scan (the brute-force scan's and the index build's feed)."""
        ids: List[int] = []
        blobs: List[bytes] = []
        for vid, blob in self._scan_data(*self.ctx.id_window()):
            ids.append(vid)
            blobs.append(blob)
            if len(ids) >= rows:
                yield np.asarray(ids, np.int64), self._page_rows(blobs)
                ids, blobs = [], []
        if ids:
            yield np.asarray(ids, np.int64), self._page_rows(blobs)

    def _page_rows(self, blobs: List[bytes]) -> np.ndarray:
        """A page's rows [n, d] (writable), read from one joined buffer:
        every blob is one serialize_vector row of the region's width."""
        dim = self.ctx.parameter.dimension
        width, dtype = (dim // 8, np.uint8) if self._binary \
            else (dim, np.float32)
        nbytes = width * np.dtype(dtype).itemsize
        bad = next((len(b) for b in blobs if len(b) != nbytes), None)
        if bad is not None:
            raise ValueError(f"a stored row of {bad} bytes in a region of "
                             f"{nbytes}-byte rows")
        return np.frombuffer(bytearray(b"".join(blobs)),
                             dtype).reshape(len(blobs), width)

    def _scan_data(self, lo: int, hi: int):
        return self._scan_rows(self._data, lo, hi)

    def _scan_rows(self, src: MvccReader, lo: int, hi: int):
        """(id, blob) of `src`'s visible rows with ids in [lo, hi)."""
        start = vcodec.encode_vector_key(self.ctx.partition_id, lo)
        end = vcodec.encode_vector_key(self.ctx.partition_id, hi)
        # prefix + partition + id: the id at bytes 9-17 (decode_vector_key's
        # layout, read in place for the common full-length key)
        prefix = vcodec.VECTOR_PREFIX
        id_at = vcodec.VECTOR_ID_STRUCT.unpack_from
        for key, blob in src.iter_visible(start, end, self.ctx.read_ts):
            if len(key) >= 17 and key[:1] == prefix:
                yield id_at(key, 9)[0], blob
                continue
            _, vid, _ = vcodec.decode_vector_key(key)
            if vid is None:
                continue
            yield vid, blob

    def _visible_ids(self) -> List[int]:
        return [vid for vid, _ in self._scan_data(*self.ctx.id_window())]

    # shared skeletons for the SCALAR and TABLE filter paths: pre-filter =
    # scan a CF into a candidate id set, post-filter = keep over-fetched
    # hits whose CF row matches, stopping at topk
    def _scan_candidates(self, src: MvccReader, match) -> np.ndarray:
        return np.asarray([vid for vid, blob in self._scan_rows(
            src, *self.ctx.id_window()) if match(blob)], np.int64)

    def _post_filter(
        self, result: SearchResult, topk: int, src: MvccReader, match
    ) -> SearchResult:
        keep_ids, keep_d = [], []
        for vid, dist in zip(result.ids, result.distances):
            key = vcodec.encode_vector_key(self.ctx.partition_id, int(vid))
            blob = src.kv_get(key, self.ctx.read_ts)
            if match(blob):
                keep_ids.append(vid)
                keep_d.append(dist)
                if len(keep_ids) >= topk:
                    break
        return SearchResult(
            np.asarray(keep_ids, np.int64), np.asarray(keep_d, np.float32)
        )

    def _scan_scalar_candidates(
        self, scalar_filter: Optional[ScalarFilter]
    ) -> np.ndarray:
        src = self._scalar_source(scalar_filter)
        if scalar_filter is None:
            return self._scan_candidates(src, lambda blob: True)
        return self._scan_candidates(
            src, lambda blob: scalar_filter.matches(deserialize_scalar(blob))
        )

    def _post_filter_scalar(
        self,
        result: SearchResult,
        scalar_filter: Optional[ScalarFilter],
        topk: int,
    ) -> SearchResult:
        if scalar_filter is None or scalar_filter.is_empty():
            return SearchResult(result.ids[:topk], result.distances[:topk])
        return self._post_filter(
            result, topk, self._scalar_source(scalar_filter),
            lambda blob: scalar_filter.matches(
                deserialize_scalar(blob) if blob else {}
            ),
        )

    def _scan_table_candidates(self, coprocessor) -> np.ndarray:
        """TABLE pre-filter: run the coprocessor's filter over every table
        row in the region (vector_reader.cc TABLE dispatch). A vector
        without a table row is never a candidate, as the scalar pre-filter
        drops a missing field."""
        if coprocessor is None:
            raise ValueError("TABLE filter requires a coprocessor")
        return self._scan_candidates(
            self._table,
            lambda blob: coprocessor.filter_row(coprocessor.decode(blob)),
        )

    def _post_filter_table(
        self, result: SearchResult, coprocessor, topk: int
    ) -> SearchResult:
        if coprocessor is None:
            raise ValueError("TABLE filter requires a coprocessor")
        return self._post_filter(
            result, topk, self._table,
            lambda blob: blob is not None
            and coprocessor.filter_row(coprocessor.decode(blob)),
        )

    def _backfill(
        self, row: List[VectorWithData], with_vector: bool, with_scalar: bool
    ) -> None:
        """Backfill vectors/scalars from the engine by id
        (vector_reader.cc:243-266)."""
        self._backfill_many([row], with_vector, with_scalar)

    def _backfill_many(
        self,
        rows: List[List[VectorWithData]],
        with_vector: bool,
        with_scalar: bool,
    ) -> None:
        """Batched backfill over every result row at once: ONE multi-get
        per column source (data / scalar) for the whole batch instead of
        the per-id kv_get N+1 loop — batch*topk ids used to cost up to
        2*batch*topk engine point lookups per search response."""
        hits = [v for row in rows for v in row]
        if not hits:
            return
        keys = {
            v.id: vcodec.encode_vector_key(self.ctx.partition_id, v.id)
            for v in hits
        }
        data_map = (
            self._data.kv_batch_get(keys.values(), self.ctx.read_ts)
            if with_vector and self.ctx.parameter else {}
        )
        scalar_map = (
            self._scalar.kv_batch_get(keys.values(), self.ctx.read_ts)
            if with_scalar else {}
        )
        for v in hits:
            key = keys[v.id]
            if with_vector and self.ctx.parameter:
                blob = data_map.get(key)
                if blob is not None:
                    v.vector = self._deser(blob)
            if with_scalar:
                sb = scalar_map.get(key)
                v.scalar = deserialize_scalar(sb) if sb else {}
