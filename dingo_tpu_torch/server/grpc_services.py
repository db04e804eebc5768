"""The store role's gRPC handlers over the protobuf messages (port of the
store-role half of dingo_tpu/server/services.py).

Reference service registry (src/server/main.cc:681-1360): IndexService,
StoreService, DocumentService, PushService, NodeService, DebugService and
UtilService. Handlers are hand-written over the generated messages and
registered with generic method handlers (server/rpc.py). The class and
method names are the JAX package's, and so are the error codes, so a
client of either package gets the same replies from a store of either.

``IndexService`` subclasses the core search service (server/services.py):
a parameter-identical, filter-free VectorSearch goes through its
``submit`` (the coalescer and the serving-edge cache), every other search
through ``node.storage.vector_batch_search``. ``UtilService`` computes on
its device, CUDA unless the caller names another. Not ported here:
FileService, RegionControlService and NodeService's
GetVectorIndexSnapshotMeta, which raises NotPorted (the generic handler
answers it in-band).

    server = DingoServer()             # server/rpc.py
    server.host_store_role(node)
    port = server.start()
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Dict, Optional

import numpy as np
import torch

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.common.failpoint import FAILPOINTS
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.engine.storage import (
    MAX_TOPN_BATCH_PRODUCT,
    VECTOR_MAX_BATCH_COUNT,
)
from dingo_tpu_torch.engine.txn import Mutation, Op, TxnEngine, TxnError
from dingo_tpu_torch.index.base import NotPorted, VectorIndexError
from dingo_tpu_torch.index.manager import StaleSnapshot
from dingo_tpu_torch.index.vector_reader import (
    RANGE_SEARCH_CAP,
    VectorFilterMode,
)
from dingo_tpu_torch.obs import pressure as qos
from dingo_tpu_torch.obs.flight import black_box_error
from dingo_tpu_torch.ops.distance import (
    pairwise_cosine,
    pairwise_inner_product,
    pairwise_l2sqr,
)
from dingo_tpu_torch.raft.core import NotLeader
from dingo_tpu_torch.server import convert
from dingo_tpu_torch.server import dingo_pb2 as pb
from dingo_tpu_torch.server.services import IndexService as _CoreIndexService
from dingo_tpu_torch.server.services import _SCAN_SESSIONS
from dingo_tpu_torch.store.node import StoreNode
from dingo_tpu_torch.store.region import Region
from dingo_tpu_torch.trace import current_span


def _err(resp, code: int, msg: str):
    resp.error.errcode = code
    resp.error.errmsg = msg
    return resp



def _rebuild_region(node: StoreNode, region: Region) -> None:
    """Forced rebuild through the atomic-swap path, WITH the raft log so
    catch-up happens in open rounds and the old index serves throughout
    (blocking-scan rebuild is reserved for regions with no raft node)."""
    raft = node.engine.get_node(region.id)
    node.index_manager.rebuild(region, raft_log=raft.log if raft else None)


def _clamp_range_or_err(region: Region, start: bytes, end: bytes, resp):
    """Validate a KV request range against the region bounds
    (ServiceHelper::ValidateRange analog): a store hosts many regions in
    ONE shared engine, so an unclamped range reads or deletes ANOTHER
    region's keys. Returns (start, end) or None with the error set."""
    if end and start >= end:
        _err(resp, 60003, "illegal range: start >= end")
        return None
    r_start, r_end = region.range
    if start < r_start or (r_end and (not end or end > r_end)):
        _err(resp, 60004,
             f"range outside region {region.id} bounds")
        return None
    return start, end


def _keys_in_region_or_err(region: Region, keys, resp) -> bool:
    for k in keys:
        if not region.contains_key(k):
            _err(resp, 60004,
                 f"key outside region {region.id} bounds")
            return False
    return True


def _region_or_err(node: StoreNode, context_pb, resp) -> Optional[Region]:
    region = node.get_region(context_pb.region_id)
    if region is None:
        _err(resp, 10001, f"region {context_pb.region_id} not found")
        return None
    # epoch check (reference validates region epoch on every request)
    if (
        context_pb.region_epoch.version
        and context_pb.region_epoch.version != region.epoch.version
    ):
        _err(resp, 10002,
             f"epoch mismatch {context_pb.region_epoch.version} != "
             f"{region.epoch.version}")
        return None
    return region




class IndexService(_CoreIndexService):
    """Vector RPCs (index_service.h:92+) over the core service: the
    parameter-identical, filter-free searches go through the core's
    ``submit`` (its coalescer and the serving-edge cache), every other
    search straight to the region's storage."""

    def _do_search(self, req, resp, stage_us=None):
        """Shared VectorSearch/VectorSearchDebug body: build kwargs (incl.
        the radius range-search arm), run the reader, fill batch_results
        (binary-aware vector payloads + scalar backfill)."""
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp, None
        # fault-injection point for the search path (flight-recorder tests
        # panic here; a panic propagates to the generic rpc handler which
        # black-boxes it and answers in-band)
        FAILPOINTS.apply("before_vector_search")
        budget = qos.current_budget() if qos.qos_enabled() else None
        if budget is not None and budget.expired():
            # deadline-aware admission: a request that arrives already
            # dead is rejected before ANY index work
            qos.PRESSURE.on_expired("admission", region.id, budget)
            return _err(resp, 30002, "deadline exceeded at admission"), None
        ingress = current_span()
        if ingress is not None and ingress.sampled:
            ingress.set_attr("region_id", region.id)
            ingress.set_attr("batch", len(req.vectors))
            ingress.set_attr("topn", req.parameter.top_n or 10)
        try:
            binary = convert.is_binary_parameter(
                region.definition.index_parameter
            )
            queries = convert.queries_from_pb(req.vectors, binary=binary)
            kw = convert.search_kwargs_from_pb(req.parameter)
            if req.parameter.nprobe:
                kw["nprobe"] = req.parameter.nprobe
            if req.parameter.ef_search:
                kw["ef"] = req.parameter.ef_search
            topn = req.parameter.top_n or 10
            if req.parameter.radius > 0:
                # VectorRangeSearch path: over-fetch to the cap, reader cuts
                kw["radius"] = req.parameter.radius
                topn = min(max(topn, 128), RANGE_SEARCH_CAP)
            window = self.window()
            # coalesce only parameter-identical, filter-free searches
            plain = (
                window > 0
                and stage_us is None
                and req.parameter.radius <= 0
                and not kw.get("with_vector_data")
                and not kw.get("with_scalar_data")
                and kw.get("filter_mode") in (None, VectorFilterMode.NONE)
                and not kw.get("vector_ids")
                and kw.get("scalar_filter") is None
            )
            if plain:
                # the core keys a batch by the scalar parameters; the
                # filter mode and type are their defaults here
                scalar_kw = {
                    k: v for k, v in kw.items()
                    if isinstance(v, (int, float, str, bool, type(None)))
                }
                # a merged batch must respect the same guards each request
                # passes alone (4096 rows; topn*rows product)
                cap = min(VECTOR_MAX_BATCH_COUNT,
                          MAX_TOPN_BATCH_PRODUCT // max(1, topn))
                fut = None
                try:
                    fut = self.submit(region.id, queries, topn,
                                      max_batch=cap, span=ingress,
                                      **scalar_kw)
                    results = fut.result(timeout=30)
                except (VectorIndexError, ValueError) as e:
                    if fut is None:
                        raise       # black-boxed below, once
                    # the core's submit black-boxed it, with this span
                    return _err(resp, 30001, str(e)), None
                except qos.QosRejected as e:
                    # an admission/expiry decision is FINAL — falling
                    # back to a direct search would serve exactly the
                    # work the QoS layer decided the store cannot afford
                    return _err(
                        resp,
                        30002 if isinstance(e, qos.DeadlineExceeded)
                        else 30003,
                        str(e),
                    ), None
                except (RuntimeError, FuturesTimeoutError):
                    # coalescer stopped mid-flight (flag hot-change) or
                    # the batch stalled: serve this request directly
                    results = self.node.storage.vector_batch_search(
                        region, queries, topn, **kw
                    )
            else:
                lat = METRICS.latency("vector_search", region.id)
                t0 = time.perf_counter_ns()
                results = self.node.storage.vector_batch_search(
                    region, queries, topn, stage_us=stage_us, **kw
                )
                lat.observe_us((time.perf_counter_ns() - t0) / 1000.0)
                if qos.qos_enabled():
                    # throughput vs goodput: every reply counts served;
                    # only the ones inside their budget count toward
                    # goodput (the core's submit counts its own)
                    qos.PRESSURE.on_served(region.id, budget)
        except (VectorIndexError, ValueError) as e:
            # in-band search failures never reach the generic rpc handler,
            # so they black-box here (device OOMs included)
            black_box_error("rpc.IndexService.VectorSearch", e, ingress,
                            region_id=region.id)
            return _err(resp, 30001, str(e)), None
        for row in results:
            r = resp.batch_results.add()
            for v in row:
                item = r.results.add()
                item.vector.id = v.id
                item.distance = v.distance
                if v.vector is not None:
                    convert.fill_vector_pb(item.vector, v.vector)
                if v.scalar:
                    convert.scalar_to_pb(item.scalar_data, v.scalar)
        return resp, region

    def VectorSearch(self, req: pb.VectorSearchRequest) -> pb.VectorSearchResponse:
        resp, _ = self._do_search(req, pb.VectorSearchResponse())
        return resp

    def VectorSearchDebug(self, req: pb.VectorSearchDebugRequest):
        """VectorSearch + per-stage timings (the reference's SearchDebug
        RPC, vector_reader.h:85-88 / index_service.h SearchDebug)."""
        stage_us: Dict[str, int] = {}
        resp, _ = self._do_search(
            req, pb.VectorSearchDebugResponse(), stage_us=stage_us
        )
        for field in ("prefilter_us", "search_us", "postfilter_us",
                      "backfill_us", "total_us"):
            setattr(resp, field, stage_us.get(field, 0))
        return resp

    @staticmethod
    def _vector_batch_from_pb(region, req_vectors):
        """Decode a repeated VectorWithScalar into the storage call shape:
        (ids, vectors, scalars, table_values) — shared by VectorAdd and
        VectorImport so the two RPCs cannot diverge."""
        ids = np.asarray([v.vector.id for v in req_vectors], np.int64)
        if convert.is_binary_parameter(region.definition.index_parameter):
            vectors = np.stack([
                np.frombuffer(v.vector.binary_values, np.uint8)
                for v in req_vectors
            ])
        else:
            vectors = np.asarray(
                [list(v.vector.values) for v in req_vectors], np.float32
            )
        scalars = [convert.scalar_from_pb(v.scalar_data) for v in req_vectors]
        table_values = None
        if any(v.HasField("table_data") for v in req_vectors):
            table_values = [
                v.table_data if v.HasField("table_data") else None
                for v in req_vectors
            ]
        return ids, vectors, scalars, table_values

    def VectorAdd(self, req: pb.VectorAddRequest) -> pb.VectorAddResponse:
        resp = pb.VectorAddResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        try:
            ids, vectors, scalars, table_values = self._vector_batch_from_pb(
                region, req.vectors)
            ts = self.node.storage.vector_add(
                region, ids, vectors, scalars,
                is_update=req.is_update, ttl_ms=req.ttl_ms,
                table_values=table_values,
            )
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        except (VectorIndexError, ValueError) as e:
            return _err(resp, 30001, str(e))
        resp.ts = ts
        resp.key_states.extend([True] * len(req.vectors))
        METRICS.counter("vector_add", region.id).add(len(req.vectors))
        return resp

    def VectorImport(self, req: pb.VectorImportRequest):
        """Bulk import (index_service.h:57 VectorImport): upserts + deletes
        in one call, sharing VectorAdd's validation and write path."""
        resp = pb.VectorImportResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        try:
            ts = 0
            if req.vectors:
                ids, vectors, scalars, table_values = (
                    self._vector_batch_from_pb(region, req.vectors))
                ts = self.node.storage.vector_add(
                    region, ids, vectors, scalars,
                    is_update=True, ttl_ms=req.ttl_ms,
                    table_values=table_values,
                )
                resp.added = len(req.vectors)
            if req.delete_ids:
                ts = self.node.storage.vector_delete(
                    region, list(req.delete_ids))
                resp.deleted = len(req.delete_ids)
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        except (VectorIndexError, ValueError) as e:
            return _err(resp, 30001, str(e))
        resp.ts = ts
        METRICS.counter("vector_import", region.id).add(
            len(req.vectors) + len(req.delete_ids))
        return resp

    def VectorDelete(self, req: pb.VectorDeleteRequest) -> pb.VectorDeleteResponse:
        resp = pb.VectorDeleteResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        try:
            self.node.storage.vector_delete(region, list(req.ids))
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        resp.key_states.extend([True] * len(req.ids))
        return resp

    def VectorBatchQuery(self, req: pb.VectorBatchQueryRequest):
        resp = pb.VectorBatchQueryResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        rows = self.node.storage.vector_batch_query(
            region, list(req.vector_ids),
            with_vector_data=req.with_vector_data,
            with_scalar_data=req.with_scalar_data,
        )
        for row in rows:
            out = resp.vectors.add()
            if row is None:
                out.vector.id = -1
                continue
            out.vector.id = row.id
            if row.vector is not None:
                convert.fill_vector_pb(out.vector, row.vector)
            if row.scalar:
                convert.scalar_to_pb(out.scalar_data, row.scalar)
        return resp

    def VectorGetBorderId(self, req: pb.VectorGetBorderIdRequest):
        resp = pb.VectorGetBorderIdResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        border = self.node.storage.vector_get_border_id(region, req.get_min)
        resp.id = border if border is not None else -1
        return resp

    def VectorScanQuery(self, req: pb.VectorScanQueryRequest):
        resp = pb.VectorScanQueryResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        rows = self.node.storage.vector_scan_query(
            region,
            start_id=req.vector_id_start,
            end_id=req.vector_id_end or None,
            limit=req.max_scan_count or 1000,
            is_reverse=req.is_reverse,
            with_vector_data=req.with_vector_data,
            with_scalar_data=req.with_scalar_data,
        )
        for row in rows:
            out = resp.vectors.add()
            out.vector.id = row.id
            if row.vector is not None:
                convert.fill_vector_pb(out.vector, row.vector)
            if row.scalar:
                convert.scalar_to_pb(out.scalar_data, row.scalar)
        return resp

    def VectorBuild(self, req: pb.VectorBuildRequest):
        """Trigger a full rebuild (LaunchRebuildVectorIndex analog)."""
        resp = pb.VectorBuildResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if region.vector_index_wrapper is None:
            return _err(resp, 70001, "region has no vector index")
        try:
            _rebuild_region(self.node, region)
        except Exception as e:  # noqa: BLE001
            return _err(resp, 70002, f"rebuild failed: {e}")
        return resp

    def VectorLoad(self, req: pb.VectorLoadRequest):
        """Load the index from its snapshot (+ WAL catch-up)."""
        resp = pb.VectorLoadResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if region.vector_index_wrapper is None:
            return _err(resp, 70001, "region has no vector index")
        try:
            raft = self.node.engine.get_node(region.id)
            ok = self.node.index_manager.load_index(
                region, raft_log=raft.log if raft else None,
                path=req.path or None,
            )
        except StaleSnapshot as e:
            return _err(resp, 70004, f"stale snapshot refused: {e}")
        except (OSError, ValueError, VectorIndexError) as e:
            return _err(resp, 70003, f"load failed: {e}")
        if not ok:
            return _err(resp, 70003,
                        "snapshot missing or unreadable (nothing loaded)")
        return resp

    def VectorStatus(self, req: pb.VectorStatusRequest):
        resp = pb.VectorStatusResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        w = region.vector_index_wrapper
        if w is None:
            return _err(resp, 70001, "region has no vector index")
        resp.ready = w.ready
        resp.build_error = w.build_error
        resp.is_switching = w.is_switching
        resp.apply_log_id = w.apply_log_id
        resp.snapshot_log_id = w.snapshot_log_id
        idx = w.own_index
        if idx is not None:
            resp.count = idx.get_count()
            resp.trained = idx.is_trained()
            resp.index_type = idx.index_type.value
        return resp

    def VectorReset(self, req: pb.VectorResetRequest):
        """Drop the in-memory index and rebuild from the engine (the
        engine is the source of truth; the index is a view)."""
        resp = pb.VectorResetResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        w = region.vector_index_wrapper
        if w is None:
            return _err(resp, 70001, "region has no vector index")
        try:
            # rebuild() swaps atomically under the wrapper lock — the old
            # index keeps serving (and absorbing raft applies) until the
            # fresh one is ready; never pre-mark not-ready here
            _rebuild_region(self.node, region)
        except Exception as e:  # noqa: BLE001
            return _err(resp, 70002, f"reset rebuild failed: {e}")
        return resp

    def VectorDump(self, req: pb.VectorDumpRequest):
        resp = pb.VectorDumpResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        w = region.vector_index_wrapper
        if w is None:
            return _err(resp, 70001, "region has no vector index")
        idx = w.own_index
        dump = {
            "region_id": region.id,
            "ready": w.ready,
            "apply_log_id": w.apply_log_id,
            "snapshot_log_id": w.snapshot_log_id,
            "write_count_since_save": getattr(
                idx, "write_count_since_save", 0
            ) if idx else 0,
        }
        if idx is not None:
            dump.update(
                index_type=idx.index_type.value,
                count=idx.get_count(),
                memory_bytes=idx.get_memory_size(),
                trained=idx.is_trained(),
            )
        resp.json = json.dumps(dump)
        return resp

    def VectorCountMemory(self, req: pb.VectorCountMemoryRequest):
        resp = pb.VectorCountMemoryResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        w = region.vector_index_wrapper
        idx = w.own_index if w else None
        if idx is None:
            return _err(resp, 70001, "region has no vector index")
        resp.bytes = idx.get_memory_size()
        return resp

    def VectorGetRegionMetrics(self, req: pb.VectorGetRegionMetricsRequest):
        resp = pb.VectorGetRegionMetricsResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        w = region.vector_index_wrapper
        idx = w.own_index if w else None
        if idx is not None:
            resp.vector_count = idx.get_count()
            resp.memory_bytes = idx.get_memory_size()
        reader = self.node.engine.new_vector_reader(region)
        mn, mx = reader.vector_border_ids()   # one region scan, both ends
        resp.min_id = mn if mn is not None else -1
        resp.max_id = mx if mx is not None else -1
        resp.region_state = region.state.value
        return resp

    def VectorCount(self, req: pb.VectorCountRequest):
        resp = pb.VectorCountResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        resp.count = self.node.storage.vector_count(region)
        return resp


class UtilService:
    """VectorCalcDistance (util service exposure of CalcDistanceEntry,
    vector_index_utils.h:43-160), computed on `device` (None = CUDA)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def VectorCalcDistance(self, req: pb.VectorCalcDistanceRequest):
        resp = pb.VectorCalcDistanceResponse()
        left = convert.queries_from_pb(req.op_left_vectors)
        right = convert.queries_from_pb(req.op_right_vectors)
        if left.size == 0 or right.size == 0:
            return _err(resp, 30001, "empty operands")
        metric = {
            pb.METRIC_TYPE_L2: pairwise_l2sqr,
            pb.METRIC_TYPE_INNER_PRODUCT: pairwise_inner_product,
            pb.METRIC_TYPE_COSINE: pairwise_cosine,
        }.get(req.metric_type, pairwise_l2sqr)
        d = metric(torch.from_numpy(left).to(self.device),
                   torch.from_numpy(right).to(self.device)).cpu().numpy()
        for row in d:
            resp.distances.add().values.extend(row.tolist())
        return resp


class StoreService:
    """KV + txn RPCs (store_service.h)."""

    def __init__(self, node: StoreNode):
        self.node = node
        # one TxnEngine per region, NOT per request: the engine's
        # ConcurrencyManager (per-key latches) only serializes concurrent
        # check-then-write sections if every request for a region shares it
        # — a per-request manager would let two pessimistic locks for
        # different txns both "win" the same key
        self._txn_engines: Dict[int, TxnEngine] = {}
        self._txn_engines_lock = threading.Lock()

    def _txn(self, region: Region) -> TxnEngine:
        with self._txn_engines_lock:
            eng = self._txn_engines.get(region.id)
            if eng is None or eng.region is not region:
                # new region object (create/epoch change): fresh engine
                eng = TxnEngine(self.node.engine, region)
                self._txn_engines[region.id] = eng
            return eng

    def KvGet(self, req: pb.KvGetRequest) -> pb.KvGetResponse:
        resp = pb.KvGetResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        value = self.node.storage.kv_get(region, req.key)
        resp.found = value is not None
        resp.value = value or b""
        return resp

    def KvBatchPut(self, req: pb.KvBatchPutRequest) -> pb.KvBatchPutResponse:
        resp = pb.KvBatchPutResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if not _keys_in_region_or_err(
            region, [kv.key for kv in req.kvs], resp
        ):
            return resp
        try:
            resp.ts = self.node.storage.kv_put(
                region, [(kv.key, kv.value) for kv in req.kvs],
                ttl_ms=req.ttl_ms,
            )
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        return resp

    def KvBatchGet(self, req: pb.KvBatchGetRequest):
        resp = pb.KvBatchGetResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        if not _keys_in_region_or_err(region, list(req.keys), resp):
            return resp
        values = self.node.storage.kv_batch_get(region, list(req.keys))
        for key, value in zip(req.keys, values):
            kv = resp.kvs.add()
            kv.key = key
            kv.value = value or b""
            resp.found.append(value is not None)
        return resp

    def KvDeleteRange(self, req: pb.KvDeleteRangeRequest):
        resp = pb.KvDeleteRangeResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        clamped = _clamp_range_or_err(
            region, req.range.start_key, req.range.end_key, resp
        )
        if clamped is None:
            return resp
        try:
            # count comes from the applied write itself (exact under
            # concurrent writes; also no follower-side scan before the
            # NotLeader rejection)
            resp.delete_count = self.node.storage.kv_delete_range(
                region, [clamped]
            )
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        return resp

    def KvPutIfAbsent(self, req: pb.KvPutIfAbsentRequest):
        """KvPutIfAbsent / KvBatchPutIfAbsent (store_service.cc KV set)."""
        resp = pb.KvPutIfAbsentResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if not _keys_in_region_or_err(
            region, [kv.key for kv in req.kvs], resp
        ):
            return resp
        try:
            states = self.node.storage.kv_put_if_absent(
                region, [(kv.key, kv.value) for kv in req.kvs],
                is_atomic=req.is_atomic,
            )
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        resp.key_states.extend(states)
        return resp

    def KvCompareAndSet(self, req: pb.KvCompareAndSetRequest):
        """KvCompareAndSet (store_service.cc): expect_value b'' means
        'expect absent' (the reference's empty-value convention)."""
        resp = pb.KvCompareAndSetResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if not _keys_in_region_or_err(region, [req.kv.key], resp):
            return resp
        expect = req.expect_value if req.expect_value else None
        try:
            resp.key_state = self.node.storage.kv_compare_and_set(
                region, req.kv.key, expect, req.kv.value
            )
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        return resp

    def KvBatchDelete(self, req: pb.KvBatchDeleteRequest):
        resp = pb.KvBatchDeleteResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if not _keys_in_region_or_err(region, list(req.keys), resp):
            return resp
        try:
            self.node.storage.kv_batch_delete(region, list(req.keys))
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        return resp

    def KvScan(self, req: pb.KvScanRequest) -> pb.KvScanResponse:
        resp = pb.KvScanResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            cop = convert.coprocessor_from_pb(req.coprocessor)
        except ValueError as e:
            return _err(resp, 60001, f"bad coprocessor: {e}")
        clamped = _clamp_range_or_err(
            region, req.range.start_key, req.range.end_key, resp
        )
        if clamped is None:
            return resp
        pairs = self.node.storage.kv_scan(
            region, clamped[0], clamped[1],
            # coprocessor filtering happens after the scan; a pre-filter
            # limit would truncate the candidate set
            limit=0 if cop is not None else req.limit,
            keys_only=req.keys_only and cop is None,
        )
        if cop is not None:
            try:
                pairs = cop.execute(pairs)
            except ValueError as e:
                return _err(resp, 60002, f"coprocessor execute: {e}")
            if req.limit:
                pairs = pairs[: req.limit]
        for k, v in pairs:
            kv = resp.kvs.add()
            kv.key = k
            kv.value = v
        return resp

    # ---- scan sessions (ScanManager v1/v2 + Stream paging) ----
    def KvScanBegin(self, req: pb.KvScanBeginRequest) -> pb.KvScanBeginResponse:
        resp = pb.KvScanBeginResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        from dingo_tpu_torch.engine.raw_engine import CF_DEFAULT
        from dingo_tpu_torch.mvcc.codec import MAX_TS
        from dingo_tpu_torch.mvcc.reader import Reader as MvccReader

        clamped = _clamp_range_or_err(
            region, req.range.start_key, req.range.end_key, resp)
        if clamped is None:
            return resp
        reader = MvccReader(self.node.raw, CF_DEFAULT)
        # materialize at open: the session must be a stable snapshot —
        # paging a live iterator would skip/repeat keys under concurrent
        # writes (the reference ScanManager pins a snapshot the same way)
        snapshot = tuple(reader.iter_visible(
            clamped[0], clamped[1], req.context.read_ts or MAX_TS,
        ))
        stream = _SCAN_SESSIONS.open(iter(snapshot),
                                             limit=req.page_size or 100)
        items, more = stream.next_page()
        resp.scan_id = stream.id
        resp.has_more = more
        for k, v in items:
            kv = resp.kvs.add()
            kv.key = k
            kv.value = v
        if not more:
            _SCAN_SESSIONS.release(stream.id)
        return resp

    def KvScanContinue(self, req: pb.KvScanContinueRequest):
        resp = pb.KvScanContinueResponse()
        stream = _SCAN_SESSIONS.get(req.scan_id)
        if stream is None:
            return _err(resp, 10010, f"unknown scan {req.scan_id}")
        items, more = stream.next_page(req.page_size or None)
        resp.has_more = more
        for k, v in items:
            kv = resp.kvs.add()
            kv.key = k
            kv.value = v
        if not more:
            _SCAN_SESSIONS.release(req.scan_id)
        return resp

    def KvScanRelease(self, req: pb.KvScanReleaseRequest):
        resp = pb.KvScanReleaseResponse()
        _SCAN_SESSIONS.release(req.scan_id)
        return resp

    # ---- txn ----
    def _leader_region_or_err(self, context_pb, resp):
        """KV and txn RPCs are leader-gated — reads included: a follower
        lagging raft apply would serve state missing already-committed
        writes (the reference serves reads through the raft leader; write
        RPCs would fail at propose anyway, this just fails them earlier
        with the routing hint). Caveat: this is a ROLE check, not a
        read-index/leader-lease pass — a deposed leader that has not yet
        seen the new term can still serve a bounded-stale read during a
        partition (closing that window needs read-index or check-quorum
        in raft/core.py; tracked, matches the coordinator's documented
        stale-read stance in coordinator/raft_meta.py)."""
        region = _region_or_err(self.node, context_pb, resp)
        if region is None:
            return None
        raft = self.node.engine.get_node(region.id)
        if raft is not None and not raft.is_leader():
            hint = getattr(raft, "leader_id", None) or ""
            _err(resp, 20001, f"not leader: {hint}")
            return None
        return region

    def TxnPrewrite(self, req: pb.TxnPrewriteRequest):
        resp = pb.TxnPrewriteResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        muts = [
            Mutation(Op(m.op), m.key, m.value) for m in req.mutations
        ]
        try:
            self._txn(region).prewrite(
                muts, req.primary_lock, req.start_ts,
                lock_ttl_ms=req.lock_ttl_ms or 3000,
                for_update_ts=req.for_update_ts,
            )
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnCommit(self, req: pb.TxnCommitRequest):
        resp = pb.TxnCommitResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            self._txn(region).commit(list(req.keys), req.start_ts, req.commit_ts)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnGet(self, req: pb.TxnGetRequest):
        resp = pb.TxnGetResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            value = self._txn(region).get(req.key, req.start_ts)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        resp.found = value is not None
        resp.value = value or b""
        return resp

    def TxnScan(self, req: pb.TxnScanRequest):
        resp = pb.TxnScanResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            cop = convert.coprocessor_from_pb(req.coprocessor)
        except ValueError as e:
            return _err(resp, 60001, f"bad coprocessor: {e}")
        try:
            pairs = self._txn(region).scan(
                req.range.start_key, req.range.end_key, req.start_ts,
                limit=0 if cop is not None else req.limit,
            )
        except TxnError as e:
            return _err(resp, 40001, str(e))
        if cop is not None:
            import struct as _struct

            try:
                pairs = cop.execute(pairs, limit=req.limit)
            except (ValueError, IndexError, _struct.error) as e:
                return _err(resp, 60002, f"coprocessor execute: {e}")
        for k, v in pairs:
            kv = resp.kvs.add()
            kv.key = k
            kv.value = v
        return resp

    def TxnBatchRollback(self, req: pb.TxnBatchRollbackRequest):
        resp = pb.TxnBatchRollbackResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            self._txn(region).batch_rollback(list(req.keys), req.start_ts)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnCheckStatus(self, req: pb.TxnCheckStatusRequest):
        resp = pb.TxnCheckStatusResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        st = self._txn(region).check_txn_status(
            req.primary_key, req.lock_ts, req.caller_start_ts
        )
        resp.action = st["action"]
        resp.commit_ts = st["commit_ts"]
        return resp

    # -- pessimistic / maintenance txn surface (store_service.h exposes 16
    # Txn RPCs; engine semantics live in engine/txn.py) ----------------------
    def TxnPessimisticLock(self, req: pb.TxnPessimisticLockRequest):
        resp = pb.TxnPessimisticLockResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            self._txn(region).pessimistic_lock(
                list(req.keys), req.primary_lock, req.start_ts,
                req.for_update_ts, ttl_ms=req.lock_ttl_ms or 3000,
            )
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnPessimisticRollback(self, req: pb.TxnPessimisticRollbackRequest):
        resp = pb.TxnPessimisticRollbackResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            self._txn(region).pessimistic_rollback(
                list(req.keys), req.start_ts)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnResolveLock(self, req: pb.TxnResolveLockRequest):
        resp = pb.TxnResolveLockResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            resp.resolved = self._txn(region).resolve_lock(
                req.start_ts, req.commit_ts,
                keys=list(req.keys) or None,
            )
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnHeartBeat(self, req: pb.TxnHeartBeatRequest):
        resp = pb.TxnHeartBeatResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            resp.lock_ttl_ms = self._txn(region).heart_beat(
                req.primary_lock, req.start_ts, req.advise_lock_ttl_ms)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnGc(self, req: pb.TxnGcRequest):
        resp = pb.TxnGcResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            resp.deleted = self._txn(region).gc(req.safe_point_ts)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    @staticmethod
    def _lock_to_pb(dst, key: bytes, lock) -> None:
        dst.key = key
        dst.lock_ts = lock.lock_ts
        dst.primary_lock = lock.primary
        dst.op = lock.op.value
        dst.ttl_ms = lock.ttl_ms
        dst.for_update_ts = lock.for_update_ts

    def TxnScanLock(self, req: pb.TxnScanLockRequest):
        resp = pb.TxnScanLockResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        from dingo_tpu_torch.mvcc.codec import MAX_TS as _MAX_TS

        locks = self._txn(region).scan_lock(
            req.range.start_key, req.range.end_key,
            max_ts=req.max_ts or _MAX_TS, limit=req.limit,
        )
        for key, lock in locks:
            self._lock_to_pb(resp.locks.add(), key, lock)
        return resp

    def TxnBatchGet(self, req: pb.TxnBatchGetRequest):
        resp = pb.TxnBatchGetResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            pairs = self._txn(region).batch_get(list(req.keys), req.start_ts)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        for key, value in pairs:
            if value is None:
                continue
            kv = resp.kvs.add()
            kv.key = key
            kv.value = value
        return resp

    def TxnCheckSecondaryLocks(self, req: pb.TxnCheckSecondaryLocksRequest):
        resp = pb.TxnCheckSecondaryLocksResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        st = self._txn(region).check_secondary_locks(
            list(req.keys), req.start_ts)
        for key, lock in st["locks"]:
            self._lock_to_pb(resp.locks.add(), key, lock)
        resp.commit_ts = st["commit_ts"]
        resp.missing_keys.extend(st["missing"])
        return resp

    def TxnDeleteRange(self, req: pb.TxnDeleteRangeRequest):
        resp = pb.TxnDeleteRangeResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        try:
            self._txn(region).delete_range(
                req.range.start_key, req.range.end_key)
        except TxnError as e:
            return _err(resp, 40001, str(e))
        return resp

    def TxnDump(self, req: pb.TxnDumpRequest):
        resp = pb.TxnDumpResponse()
        region = self._leader_region_or_err(req.context, resp)
        if region is None:
            return resp
        d = self._txn(region).dump(
            req.range.start_key, req.range.end_key, limit=req.limit)
        for e in d["locks"]:
            li = resp.locks.add()
            li.key, li.lock_ts, li.primary_lock = (
                e["key"], e["lock_ts"], e["primary"])
            li.op, li.ttl_ms, li.for_update_ts = (
                e["op"], e["ttl_ms"], e["for_update_ts"])
        for e in d["writes"]:
            wi = resp.writes.add()
            wi.key, wi.commit_ts = e["key"], e["commit_ts"]
            wi.start_ts, wi.op = e["start_ts"], e["op"]
        for e in d["datas"]:
            di = resp.datas.add()
            di.key, di.start_ts, di.value = (
                e["key"], e["start_ts"], e["value"])
        return resp



class DocumentService:
    """Full-text RPCs (reference DocumentService, server/main.cc:1176)."""

    def __init__(self, node: StoreNode):
        self.node = node

    def DocumentAdd(self, req: pb.DocumentAddRequest) -> pb.DocumentAddResponse:
        from dingo_tpu_torch.engine import write_data as wd

        resp = pb.DocumentAddResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if region.document_index is None:
            return _err(resp, 80001, "not a DOCUMENT region")
        ids = [d.id for d in req.documents]
        docs = [convert.scalar_from_pb(d.fields) for d in req.documents]
        # typed-schema validation BEFORE the raft propose: a doc that can
        # never apply must not enter the log (apply-time failures would
        # have to fail identically on every replica forever)
        from dingo_tpu_torch.document.index import SchemaError

        try:
            for doc in docs:
                region.document_index.check_doc(doc)
        except SchemaError as e:
            return _err(resp, 80002, str(e))
        try:
            ts = self.node.storage.ts_provider.get_ts()
            self.node.engine.write(region, wd.DocumentAddData(
                ts=ts, ids=ids, documents=docs, is_update=req.is_update,
            ))
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        resp.ts = ts
        return resp

    def DocumentDelete(self, req: pb.DocumentDeleteRequest):
        from dingo_tpu_torch.engine import write_data as wd

        resp = pb.DocumentDeleteResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if region.document_index is None:
            return _err(resp, 80001, "not a DOCUMENT region")
        try:
            ts = self.node.storage.ts_provider.get_ts()
            self.node.engine.write(region, wd.DocumentDeleteData(
                ts=ts, ids=list(req.ids),
            ))
        except NotLeader as e:
            return _err(resp, 20001, f"not leader: {e.leader_hint}")
        return resp

    def DocumentSearch(self, req: pb.DocumentSearchRequest):
        resp = pb.DocumentSearchResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if region.document_index is None:
            return _err(resp, 80001, "not a DOCUMENT region")
        hits = region.document_index.search(
            req.query,
            topk=req.top_n or 10,
            mode=req.mode or "or",
            column_filter=convert.scalar_from_pb(req.column_filter) or None,
        )
        for did, score in hits:
            d = resp.documents.add()
            d.id = did
            d.score = score
            if req.with_fields:
                doc = region.document_index.get(did)
                if doc:
                    convert.scalar_to_pb(d.fields, doc)
        return resp

    def DocumentCount(self, req: pb.DocumentCountRequest):
        resp = pb.DocumentCountResponse()
        region = _region_or_err(self.node, req.context, resp)
        if region is None:
            return resp
        if region.document_index is None:
            return _err(resp, 80001, "not a DOCUMENT region")
        resp.count = region.document_index.count()
        return resp



class PushService:
    """Coordinator -> store push of store operations (push_service.h — the
    inverse of the heartbeat pull)."""

    def __init__(self, node: StoreNode):
        self.node = node

    def PushStoreOperation(self, req: pb.PushStoreOperationRequest):
        resp = pb.PushStoreOperationResponse()
        for c in req.commands:
            # per-command isolation: a malformed or failing command must not
            # abort the batch or lose acks for commands that DID execute
            try:
                cmd = convert.region_cmd_from_pb(c)
                self.node.execute_region_cmd(cmd)
                resp.done_cmd_ids.append(c.cmd_id)
            except NotLeader as e:
                if self.node.coordinator is not None and e.leader_hint:
                    self.node.coordinator.requeue_cmd(
                        cmd, e.leader_hint.split("/")[0],
                        from_store=self.node.store_id,
                    )
            except Exception:  # noqa: BLE001
                pass
        return resp



class NodeService:
    def __init__(self, node: StoreNode):
        self.node = node

    def GetVectorIndexSnapshotMeta(
        self, req: pb.VectorIndexSnapshotMetaRequest
    ) -> pb.VectorIndexSnapshotMetaResponse:
        """The snapshot manifest of a peer pull: the pull and its
        FileService are not ported; the generic handler answers the raise
        in-band (99999)."""
        raise NotPorted("NodeService.GetVectorIndexSnapshotMeta (the "
                        "snapshot peer pull) is not ported")

    def NodeInfo(self, req: pb.NodeInfoRequest) -> pb.NodeInfoResponse:
        resp = pb.NodeInfoResponse()
        resp.store_id = self.node.store_id
        regions = self.node.meta.get_all_regions()
        resp.region_ids.extend(r.id for r in regions)
        resp.leader_region_ids.extend(
            r.id for r in regions
            if (n := self.node.engine.get_node(r.id)) is not None
            and n.is_leader()
        )
        return resp

    def SetLogLevel(self, req: pb.SetLogLevelRequest):
        """Runtime log-level flip (node_service.h log-level RPC)."""
        from dingo_tpu_torch.common import log as dlog

        resp = pb.SetLogLevelResponse()
        try:
            dlog.set_level(req.level, module=req.module or None)
        except ValueError as e:
            return _err(resp, 90003, str(e))
        dlog.get_logger("node").info(
            "log level set to %s (module=%s)", req.level.upper(),
            req.module or "<all>")
        return resp

    def GetLogLevel(self, req: pb.GetLogLevelRequest):
        from dingo_tpu_torch.common import log as dlog

        resp = pb.GetLogLevelResponse()
        for module, level in sorted(dlog.get_levels().items()):
            e = resp.levels.add()
            e.module = module
            e.level = level
        return resp



class DebugService:
    def MetricsDump(self, req: pb.MetricsDumpRequest) -> pb.MetricsDumpResponse:
        resp = pb.MetricsDumpResponse()
        fmt = req.format or "json"
        if fmt == "prometheus":
            # the payload field stays `json` (wire compatibility); the
            # content is Prometheus text exposition format
            resp.json = METRICS.render_prometheus()
        elif fmt == "json":
            resp.json = json.dumps(METRICS.dump())
        else:
            return _err(resp, 50002, f"unknown metrics format {fmt!r}")
        return resp

    def TraceDump(self, req: pb.MetricsDumpRequest) -> pb.MetricsDumpResponse:
        """Sampled span buffer + slow-query log as JSON (spans grouped by
        trace id) — the RPC face of dingo_tpu/trace."""
        from dingo_tpu_torch.trace import to_json

        resp = pb.MetricsDumpResponse()
        resp.json = json.dumps(to_json())
        return resp

    def TraceChromeDump(self, req: pb.MetricsDumpRequest):
        """Same buffer in Chrome trace_event form: save the payload to a
        file and open it in chrome://tracing / Perfetto, or feed it to
        tools/trace_report.py for a per-stage latency table."""
        from dingo_tpu_torch.trace import to_chrome_trace

        resp = pb.MetricsDumpResponse()
        resp.json = json.dumps(to_chrome_trace())
        return resp

    def FailPoint(self, req: pb.FailPointRequest) -> pb.FailPointResponse:
        resp = pb.FailPointResponse()
        try:
            if req.remove:
                FAILPOINTS.remove(req.name)
            else:
                FAILPOINTS.configure(req.name, req.config)
        except ValueError as e:
            return _err(resp, 50001, str(e))
        return resp

    def FlightDump(self, req: pb.FlightDumpRequest) -> pb.FlightDumpResponse:
        """Flight-recorder export: bundle catalog always; one compressed
        payload (zlib JSON — tools/flight_report.py renders it) when
        include_payload is set (bundle_id empty = newest)."""
        from dingo_tpu_torch.obs.flight import FLIGHT

        resp = pb.FlightDumpResponse()
        metas = FLIGHT.bundles_meta()
        for m in metas:
            out = resp.bundles.add()
            for field in ("id", "reason", "name", "trace_id", "region_id",
                          "created_ms", "payload_bytes"):
                setattr(out, field, m[field])
        if req.include_payload:
            found = FLIGHT.get_with_id(req.bundle_id)
            if found is None:
                return _err(
                    resp, 50003,
                    f"no flight bundle {req.bundle_id!r}" if req.bundle_id
                    else "no flight bundles captured",
                )
            # id + payload resolved atomically: a bundle captured between
            # the catalog read above and here can't mislabel the blob
            resp.payload_bundle_id, resp.payload = found
        return resp

    def EventDump(self, req: pb.EventDumpRequest) -> pb.EventDumpResponse:
        """This process's control-plane decision ring (obs/events.py),
        oldest first — harvested-but-unevicted events included, so the
        local view overlaps the coordinator's merged timeline."""
        from dingo_tpu_torch.obs.events import EVENTS

        resp = pb.EventDumpResponse()
        for ev in EVENTS.recent(
            limit=int(req.limit) or 0,
            region_id=req.region_id or None,
            actor=req.actor,
        ):
            convert.control_event_to_pb(ev, resp.events.add())
        resp.dropped = EVENTS.dropped
        return resp


