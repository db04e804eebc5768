"""gRPC server plumbing of the store role (port of
dingo_tpu/server/rpc.py): hand-written method handler registration,
DingoServer and the client-side ServiceStub.

``SERVICE_SCHEMA`` maps each store-role service's methods to their
request and response messages; ``_register`` wraps every handler with
trace ingress from the metadata, the QoS budget, NotLeader as 20001 and
any other exception as an in-band 99999 (black-boxed by the flight
recorder), and the slow-query watch. The wire paths are the JAX
package's (``/dingo_tpu.<Service>/<Method>``), so stubs and servers of
the two packages talk to each other.

    server = DingoServer()             # 127.0.0.1, a free port
    server.host_store_role(node)
    port = server.start()
    stub = ServiceStub(grpc.insecure_channel(f"127.0.0.1:{port}"),
                       "IndexService")
    server.stop()

The coordinator and diskann roles, FileService and RegionControlService
are not ported.
"""

from __future__ import annotations

from concurrent import futures
from typing import Dict, Tuple

import grpc

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.obs.pressure import (
    attach_budget,
    detach_budget,
    extract_budget_metadata,
    inject_budget_metadata,
)
from dingo_tpu_torch.raft.core import NotLeader
from dingo_tpu_torch.server import dingo_pb2 as pb
from dingo_tpu_torch.server.grpc_services import (
    DebugService,
    DocumentService,
    IndexService,
    NodeService,
    PushService,
    StoreService,
    UtilService,
)
from dingo_tpu_torch.trace import (
    TRACE_METADATA_KEY,
    TRACER,
    UNSAMPLED_HEADER,
    current_span,
    extract_metadata,
    inject_metadata,
)

#: the proto package of proto/dingo.proto: the first part of every wire
#: path, the same for servers and clients of both packages
PROTO_PACKAGE = "dingo_tpu"

#: service -> method -> (request type, response type), the store role's
SERVICE_SCHEMA: Dict[str, Dict[str, Tuple[type, type]]] = {
    "IndexService": {
        "VectorSearch": (pb.VectorSearchRequest, pb.VectorSearchResponse),
        "VectorSearchDebug": (
            pb.VectorSearchDebugRequest, pb.VectorSearchDebugResponse,
        ),
        "VectorAdd": (pb.VectorAddRequest, pb.VectorAddResponse),
        "VectorImport": (pb.VectorImportRequest, pb.VectorImportResponse),
        "VectorDelete": (pb.VectorDeleteRequest, pb.VectorDeleteResponse),
        "VectorBatchQuery": (pb.VectorBatchQueryRequest, pb.VectorBatchQueryResponse),
        "VectorGetBorderId": (pb.VectorGetBorderIdRequest, pb.VectorGetBorderIdResponse),
        "VectorScanQuery": (pb.VectorScanQueryRequest, pb.VectorScanQueryResponse),
        "VectorCount": (pb.VectorCountRequest, pb.VectorCountResponse),
        "VectorBuild": (pb.VectorBuildRequest, pb.VectorBuildResponse),
        "VectorLoad": (pb.VectorLoadRequest, pb.VectorLoadResponse),
        "VectorStatus": (pb.VectorStatusRequest, pb.VectorStatusResponse),
        "VectorReset": (pb.VectorResetRequest, pb.VectorResetResponse),
        "VectorDump": (pb.VectorDumpRequest, pb.VectorDumpResponse),
        "VectorCountMemory": (
            pb.VectorCountMemoryRequest, pb.VectorCountMemoryResponse,
        ),
        "VectorGetRegionMetrics": (
            pb.VectorGetRegionMetricsRequest,
            pb.VectorGetRegionMetricsResponse,
        ),
    },
    "StoreService": {
        "KvGet": (pb.KvGetRequest, pb.KvGetResponse),
        "KvBatchGet": (pb.KvBatchGetRequest, pb.KvBatchGetResponse),
        "KvDeleteRange": (
            pb.KvDeleteRangeRequest, pb.KvDeleteRangeResponse,
        ),
        "KvBatchPut": (pb.KvBatchPutRequest, pb.KvBatchPutResponse),
        "KvPutIfAbsent": (pb.KvPutIfAbsentRequest, pb.KvPutIfAbsentResponse),
        "KvCompareAndSet": (
            pb.KvCompareAndSetRequest, pb.KvCompareAndSetResponse,
        ),
        "KvBatchDelete": (pb.KvBatchDeleteRequest, pb.KvBatchDeleteResponse),
        "KvScan": (pb.KvScanRequest, pb.KvScanResponse),
        "TxnPrewrite": (pb.TxnPrewriteRequest, pb.TxnPrewriteResponse),
        "TxnCommit": (pb.TxnCommitRequest, pb.TxnCommitResponse),
        "TxnGet": (pb.TxnGetRequest, pb.TxnGetResponse),
        "TxnScan": (pb.TxnScanRequest, pb.TxnScanResponse),
        "TxnBatchRollback": (pb.TxnBatchRollbackRequest, pb.TxnBatchRollbackResponse),
        "TxnCheckStatus": (pb.TxnCheckStatusRequest, pb.TxnCheckStatusResponse),
        "TxnPessimisticLock": (
            pb.TxnPessimisticLockRequest, pb.TxnPessimisticLockResponse,
        ),
        "TxnPessimisticRollback": (
            pb.TxnPessimisticRollbackRequest, pb.TxnPessimisticRollbackResponse,
        ),
        "TxnResolveLock": (pb.TxnResolveLockRequest, pb.TxnResolveLockResponse),
        "TxnHeartBeat": (pb.TxnHeartBeatRequest, pb.TxnHeartBeatResponse),
        "TxnGc": (pb.TxnGcRequest, pb.TxnGcResponse),
        "TxnScanLock": (pb.TxnScanLockRequest, pb.TxnScanLockResponse),
        "TxnBatchGet": (pb.TxnBatchGetRequest, pb.TxnBatchGetResponse),
        "TxnCheckSecondaryLocks": (
            pb.TxnCheckSecondaryLocksRequest, pb.TxnCheckSecondaryLocksResponse,
        ),
        "TxnDeleteRange": (pb.TxnDeleteRangeRequest, pb.TxnDeleteRangeResponse),
        "TxnDump": (pb.TxnDumpRequest, pb.TxnDumpResponse),
        "KvScanBegin": (pb.KvScanBeginRequest, pb.KvScanBeginResponse),
        "KvScanContinue": (pb.KvScanContinueRequest, pb.KvScanContinueResponse),
        "KvScanRelease": (pb.KvScanReleaseRequest, pb.KvScanReleaseResponse),
    },
    "UtilService": {
        "VectorCalcDistance": (pb.VectorCalcDistanceRequest, pb.VectorCalcDistanceResponse),
    },
    "DocumentService": {
        "DocumentAdd": (pb.DocumentAddRequest, pb.DocumentAddResponse),
        "DocumentDelete": (pb.DocumentDeleteRequest, pb.DocumentDeleteResponse),
        "DocumentSearch": (pb.DocumentSearchRequest, pb.DocumentSearchResponse),
        "DocumentCount": (pb.DocumentCountRequest, pb.DocumentCountResponse),
    },
    "NodeService": {
        "NodeInfo": (pb.NodeInfoRequest, pb.NodeInfoResponse),
        "GetVectorIndexSnapshotMeta": (
            pb.VectorIndexSnapshotMetaRequest,
            pb.VectorIndexSnapshotMetaResponse,
        ),
        "SetLogLevel": (pb.SetLogLevelRequest, pb.SetLogLevelResponse),
        "GetLogLevel": (pb.GetLogLevelRequest, pb.GetLogLevelResponse),
    },
    "DebugService": {
        "MetricsDump": (pb.MetricsDumpRequest, pb.MetricsDumpResponse),
        # trace exports reuse the MetricsDump message pair (json payload);
        # the method name alone routes — no proto regen needed
        "TraceDump": (pb.MetricsDumpRequest, pb.MetricsDumpResponse),
        "TraceChromeDump": (pb.MetricsDumpRequest, pb.MetricsDumpResponse),
        "FailPoint": (pb.FailPointRequest, pb.FailPointResponse),
        "FlightDump": (pb.FlightDumpRequest, pb.FlightDumpResponse),
        # process-local control-plane event ring (obs/events.py)
        "EventDump": (pb.EventDumpRequest, pb.EventDumpResponse),
    },
    "RaftService": {
        "RaftMessage": (pb.RaftMessageRequest, pb.RaftMessageResponse),
    },
    "PushService": {
        "PushStoreOperation": (
            pb.PushStoreOperationRequest, pb.PushStoreOperationResponse,
        ),
    },
}


def _register(server: grpc.Server, service_name: str, impl) -> None:
    schema = SERVICE_SCHEMA[service_name]
    handlers = {}
    for method, (req_t, resp_t) in schema.items():
        fn = getattr(impl, method)

        def make(fn, req_t, resp_t, method):
            span_name = f"rpc.{service_name}.{method}"

            def handler(request, context):
                # trace ingress: adopt the caller's context from metadata
                # (one distributed trace across client -> server -> raft
                # hops) or mint a root here; attaching makes every deeper
                # span — coalescer, reader, kernels — a descendant
                metadata = context.invocation_metadata()
                parent = extract_metadata(metadata)
                span = TRACER.start_span(span_name, parent=parent)
                # qos ingress: adopt the caller's time budget (remaining-
                # ms header -> host-monotonic deadline) or grant the
                # configured default while qos.enabled; None otherwise —
                # the budget rides the same contextvar plumbing as the
                # span, so the coalescer handoff and nested egress calls
                # see it without any per-layer threading
                budget = extract_budget_metadata(metadata)
                btoken = attach_budget(budget) if budget is not None \
                    else None
                # always-sample-slow: an unsampled request still gets a
                # two-clock-read watch so outlier latency is never lost
                slow_t0 = 0 if span.sampled else TRACER.slow_watch_start()
                # attach only when a sampling DECISION exists (sampled,
                # an upstream header, or a local rate roll). A rate-0
                # ingress with no header must leave the context clean —
                # otherwise nested outbound calls would propagate '0-0-0'
                # for a decision nobody made and permanently suppress
                # sampling on downstream servers that have tracing on
                decided = (
                    span.sampled or parent is not None
                    or FLAGS.get("trace_sampling_rate") > 0
                )
                token = span.attach() if decided else None
                try:
                    resp = fn(request)
                    if span.sampled and getattr(
                        getattr(resp, "error", None), "errcode", 0
                    ):
                        span.set_attr("errcode", resp.error.errcode)
                    return resp
                except NotLeader as e:
                    # replicated-coordinator followers (raft_meta proxies)
                    # surface the hint so clients re-route, same contract
                    # as store-side region writes
                    span.set_attr("errcode", 20001)
                    resp = resp_t()
                    if hasattr(resp, "error"):
                        resp.error.errcode = 20001
                        resp.error.errmsg = f"not leader: {e.leader_hint}"
                    return resp
                except Exception as e:  # noqa: BLE001
                    # unexpected failures (incl. injected failpoints) become
                    # in-band errors instead of opaque grpc UNKNOWNs
                    from dingo_tpu_torch.common.log import get_logger

                    get_logger("rpc").exception(
                        "%s.%s failed", service_name, method)
                    span.set_error(e)
                    # black-box the failure: spans + metric deltas + kernel
                    # cache + hbm ledger at the moment it happened (device
                    # OOMs get their own reason and bump hbm.alloc_failures)
                    from dingo_tpu_torch.obs.flight import black_box_error

                    black_box_error(span_name, e, span)
                    resp = resp_t()
                    if hasattr(resp, "error"):
                        resp.error.errcode = 99999
                        resp.error.errmsg = f"{type(e).__name__}: {e}"
                    return resp
                finally:
                    if btoken is not None:
                        detach_budget(btoken)
                    if token is not None:
                        span.detach(token)
                    span.end()
                    TRACER.slow_watch_end(span_name, slow_t0)

            return handler

        handlers[method] = grpc.unary_unary_rpc_method_handler(
            make(fn, req_t, resp_t, method),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            f"{PROTO_PACKAGE}.{service_name}", handlers
        ),
    ))


class DingoServer:
    def __init__(self, port: int = 0, max_workers: int = 16):
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    def host_store_role(self, node) -> None:
        """--role=store|index service set (main.cc:681+), without
        FileService and RegionControlService. UtilService computes on
        the node's device."""
        from dingo_tpu_torch.raft.grpc_transport import (
            GrpcRaftTransport,
            RaftService,
        )

        if isinstance(node.engine.transport, GrpcRaftTransport):
            _register(self._server, "RaftService",
                      RaftService(node.engine.transport))
        _register(self._server, "PushService", PushService(node))
        self._index_service = IndexService(node)
        _register(self._server, "IndexService", self._index_service)
        _register(self._server, "StoreService", StoreService(node))
        _register(self._server, "DocumentService", DocumentService(node))
        _register(self._server, "NodeService", NodeService(node))
        _register(self._server, "DebugService", DebugService())
        _register(self._server, "UtilService", UtilService(node.device))

    def start(self) -> int:
        self._server.start()
        return self.port

    def stop(self, grace: float = 0.5) -> None:
        svc = getattr(self, "_index_service", None)
        if svc is not None:
            svc.close()
        self._server.stop(grace)


class _TracedCall:
    """Wraps a unary-unary multicallable: egress span + trace metadata
    injection so server-side spans join the caller's trace. Unsampled
    calls pass metadata through untouched (one sampled-check)."""

    __slots__ = ("_call", "_name")

    def __init__(self, call, name: str):
        self._call = call
        self._name = name

    def __call__(self, request, timeout=None, metadata=None, **kwargs):
        with TRACER.start_span(self._name) as span:
            # qos egress: the current budget (if any) crosses the wire as
            # remaining-ms + tenant + priority, next to the trace context
            metadata = inject_budget_metadata(metadata)
            if span.sampled:
                metadata = inject_metadata(metadata)
            elif current_span() is not None \
                    or FLAGS.get("trace_sampling_rate") > 0:
                # a decision WAS made — locally (rate > 0) or upstream
                # (an attached noop from an adopted '0-0-0' header):
                # propagate it so downstream servers don't re-roll and
                # mint fragment roots mid-request. With tracing fully off
                # and no inherited decision we send nothing — that path
                # stays allocation-free
                metadata = [
                    *(metadata or ()),
                    (TRACE_METADATA_KEY, UNSAMPLED_HEADER),
                ]
            return self._call(
                request, timeout=timeout, metadata=metadata, **kwargs
            )


class ServiceStub:
    """Minimal client-side stub (the grpc codegen plugin is absent)."""

    def __init__(self, channel: grpc.Channel, service_name: str):
        self._channel = channel
        self._service = service_name
        for method, (req_t, resp_t) in SERVICE_SCHEMA[service_name].items():
            setattr(self, method, _TracedCall(channel.unary_unary(
                f"/{PROTO_PACKAGE}.{service_name}/{method}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            ), f"client.{service_name}.{method}"))
