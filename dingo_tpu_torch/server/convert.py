"""protobuf <-> internal object conversions (port of
dingo_tpu/server/convert.py): index parameters, region definitions,
scalar entries and predicates, search parameters, region commands,
vector payloads, the coprocessor, and the control-event and metrics
messages of the heartbeat."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from dingo_tpu_torch.coprocessor.scalar_filter import CmpOp, ScalarFilter, ScalarPredicate
from dingo_tpu_torch.index.base import IndexParameter, IndexType
from dingo_tpu_torch.index.vector_reader import VectorFilterMode, VectorFilterType
from dingo_tpu_torch.ops.distance import Metric
from dingo_tpu_torch.server import dingo_pb2 as pb
from dingo_tpu_torch.store.region import RegionDefinition, RegionEpoch, RegionType
from dingo_tpu_torch.raft import wire

_METRIC_TO_PB = {
    Metric.L2: pb.METRIC_TYPE_L2,
    Metric.INNER_PRODUCT: pb.METRIC_TYPE_INNER_PRODUCT,
    Metric.COSINE: pb.METRIC_TYPE_COSINE,
    Metric.HAMMING: pb.METRIC_TYPE_HAMMING,
}
_PB_TO_METRIC = {v: k for k, v in _METRIC_TO_PB.items()}

_ITYPE_TO_PB = {
    IndexType.FLAT: pb.VECTOR_INDEX_TYPE_FLAT,
    IndexType.IVF_FLAT: pb.VECTOR_INDEX_TYPE_IVF_FLAT,
    IndexType.IVF_PQ: pb.VECTOR_INDEX_TYPE_IVF_PQ,
    IndexType.HNSW: pb.VECTOR_INDEX_TYPE_HNSW,
    IndexType.DISKANN: pb.VECTOR_INDEX_TYPE_DISKANN,
    IndexType.BRUTEFORCE: pb.VECTOR_INDEX_TYPE_BRUTEFORCE,
    IndexType.BINARY_FLAT: pb.VECTOR_INDEX_TYPE_BINARY_FLAT,
    IndexType.BINARY_IVF_FLAT: pb.VECTOR_INDEX_TYPE_BINARY_IVF_FLAT,
}
_PB_TO_ITYPE = {v: k for k, v in _ITYPE_TO_PB.items()}

_FILTER_TO_MODE = {
    pb.VECTOR_FILTER_NONE: VectorFilterMode.NONE,
    pb.SCALAR_FILTER: VectorFilterMode.SCALAR,
    pb.TABLE_FILTER: VectorFilterMode.TABLE,
    pb.VECTOR_ID_FILTER: VectorFilterMode.VECTOR_ID,
}


def index_parameter_to_pb(p: Optional[IndexParameter]) -> pb.VectorIndexParameter:
    out = pb.VectorIndexParameter()
    if p is None:
        return out
    out.index_type = _ITYPE_TO_PB[p.index_type]
    out.dimension = p.dimension
    out.metric_type = _METRIC_TO_PB[p.metric]
    out.ncentroids = p.ncentroids
    out.nsubvector = p.nsubvector
    out.nbits_per_idx = p.nbits_per_idx
    out.default_nprobe = p.default_nprobe
    out.efconstruction = p.efconstruction
    out.nlinks = p.nlinks
    out.host_vectors = p.host_vectors
    out.scalar_speedup_keys.extend(p.scalar_speedup_keys)
    out.precision = p.precision
    return out


def index_parameter_from_pb(m: pb.VectorIndexParameter) -> Optional[IndexParameter]:
    if m.index_type == pb.VECTOR_INDEX_TYPE_NONE:
        return None
    return IndexParameter(
        index_type=_PB_TO_ITYPE[m.index_type],
        dimension=m.dimension,
        metric=_PB_TO_METRIC.get(m.metric_type, Metric.L2),
        ncentroids=m.ncentroids or 2048,
        nsubvector=m.nsubvector or 64,
        nbits_per_idx=m.nbits_per_idx or 8,
        default_nprobe=m.default_nprobe or 80,
        efconstruction=m.efconstruction or 200,
        nlinks=m.nlinks or 32,
        host_vectors=m.host_vectors,
        scalar_speedup_keys=tuple(m.scalar_speedup_keys),
        precision=m.precision,
    )


def region_def_to_pb(d: RegionDefinition) -> pb.RegionDefinition:
    out = pb.RegionDefinition()
    out.region_id = d.region_id
    out.epoch.conf_version = d.epoch.conf_version
    out.epoch.version = d.epoch.version
    out.range.start_key = d.start_key
    out.range.end_key = d.end_key
    out.partition_id = d.partition_id
    out.peers.extend(d.peers)
    out.region_type = {"store": 0, "index": 1, "document": 2}[d.region_type.value]
    out.index_parameter.CopyFrom(index_parameter_to_pb(d.index_parameter))
    for name, ftype in (d.document_schema or {}).items():
        col = out.document_schema.add()
        col.name = name
        col.sql_type = ftype
    return out


def region_def_from_pb(m: pb.RegionDefinition) -> RegionDefinition:
    return RegionDefinition(
        region_id=m.region_id,
        start_key=m.range.start_key,
        end_key=m.range.end_key,
        partition_id=m.partition_id,
        peers=list(m.peers),
        epoch=RegionEpoch(m.epoch.conf_version or 1, m.epoch.version or 1),
        region_type=[RegionType.STORE, RegionType.INDEX,
                     RegionType.DOCUMENT][m.region_type],
        index_parameter=index_parameter_from_pb(m.index_parameter),
        document_schema=(
            {c.name: c.sql_type for c in m.document_schema}
            if m.document_schema else None
        ),
    )


def scalar_to_pb(entries, scalar: Optional[Dict[str, Any]]) -> None:
    for k, v in (scalar or {}).items():
        e = entries.add()
        e.key = k
        e.value = wire.encode_obj(v)


def scalar_from_pb(entries) -> Dict[str, Any]:
    return {e.key: wire.decode_obj(e.value) for e in entries}


def predicates_from_pb(preds) -> Optional[ScalarFilter]:
    if not preds:
        return None
    return ScalarFilter([
        ScalarPredicate(p.field, CmpOp(p.op), wire.decode_obj(p.value))
        for p in preds
    ])


def search_kwargs_from_pb(param: pb.VectorSearchParameter) -> dict:
    kw: dict = {
        "filter_mode": _FILTER_TO_MODE.get(param.filter, VectorFilterMode.NONE),
        "filter_type": (
            VectorFilterType.QUERY_PRE
            if param.filter_type == pb.QUERY_PRE
            else VectorFilterType.QUERY_POST
        ),
        "with_vector_data": param.with_vector_data,
        "with_scalar_data": param.with_scalar_data,
    }
    if param.vector_ids:
        kw["vector_ids"] = list(param.vector_ids)
    sf = predicates_from_pb(param.predicates)
    if sf is not None:
        kw["scalar_filter"] = sf
    cop = coprocessor_from_pb(param.coprocessor)
    if cop is not None:
        kw["coprocessor"] = cop
    return kw


def region_cmd_from_pb(c):
    """pb.RegionCmd -> coordinator RegionCmd (single source of truth for
    the three command-delivery paths: push, requeue, remote heartbeat)."""
    from dingo_tpu_torch.coordinator.control import RegionCmd, RegionCmdType

    return RegionCmd(
        cmd_id=c.cmd_id,
        region_id=c.region_id,
        cmd_type=RegionCmdType(c.cmd_type),
        definition=(region_def_from_pb(c.definition)
                    if c.definition.region_id else None),
        split_key=c.split_key,
        child_region_id=c.child_region_id,
        target_store_id=c.target_store_id,
    )


def fill_vector_pb(vector_pb, row: np.ndarray) -> None:
    """Emit a stored row into a Vector message: packed uint8 rows go to
    binary_values, float rows to values."""
    if row.dtype == np.uint8:
        vector_pb.binary_values = row.tobytes()
    else:
        vector_pb.values.extend(row.tolist())


def queries_from_pb(vectors, binary: bool = False) -> np.ndarray:
    if binary:
        return np.stack([
            np.frombuffer(v.binary_values, np.uint8) for v in vectors
        ])
    return np.asarray([list(v.values) for v in vectors], np.float32)


def is_binary_parameter(param) -> bool:
    from dingo_tpu_torch.index.vector_reader import is_binary_dim_param

    return is_binary_dim_param(param)


def coprocessor_from_pb(m) -> "object | None":
    """pb.Coprocessor -> CoprocessorV2 (None when the field is unset)."""
    if not m.original_schema:
        return None
    from dingo_tpu_torch.coprocessor.coprocessor_v2 import (
        AggOpV2,
        AggregationSpec,
        CoprocessorDef,
        CoprocessorV2,
        SchemaColumn,
    )

    if m.projections:
        selection = []
        for p in m.projections:
            if p.expr:
                tree = wire.decode(p.expr)
                if not isinstance(tree, (list, tuple)):
                    # a scalar here would be silently taken as a column
                    # index by CoprocessorDef — reject the malformed expr
                    raise ValueError(f"projection expr is not a tree: {tree!r}")
                selection.append(tree)
            else:
                selection.append(p.column_index)
    else:
        selection = list(m.selection)
    defn = CoprocessorDef(
        original_schema=[
            SchemaColumn(c.name, c.sql_type or "VARCHAR", c.index)
            for c in m.original_schema
        ],
        selection=selection,
        filter_expr=wire.decode(m.filter_expr) if m.filter_expr else None,
        group_by=list(m.group_by),
        aggregations=[
            AggregationSpec(
                AggOpV2(a.op), a.column_index,
                expr=wire.decode(a.expr) if a.expr else None,
            )
            for a in m.aggregations
        ],
    )
    return CoprocessorV2(defn)


# ---------------- store metrics (heartbeat payload) ----------------

_REGION_METRIC_FIELDS = (
    "region_id", "key_count", "approximate_bytes", "vector_count",
    "vector_memory_bytes", "device_memory_bytes", "index_ready",
    "index_building", "index_build_error", "index_apply_log_id",
    "index_snapshot_log_id", "apply_lag", "is_leader", "search_qps",
    "document_count", "device_peak_bytes",
    # quality plane (obs/quality.py): windowed live recall + Wilson CI;
    # quality_samples == 0 means the figures carry no evidence
    "quality_recall", "quality_recall_ci_low", "quality_recall_ci_high",
    "quality_samples",
    # serving-pressure plane (obs/pressure.py): queue depth / recent
    # queue-wait watermark / cumulative shed+expired / degrade level
    "qos_queue_depth", "qos_queue_wait_ms", "qos_shed_total",
    "qos_degrade_level",
    # state-integrity plane (obs/integrity.py): applied-index-tagged
    # per-artifact digest vector + store-local scrub verdict
    "integrity_applied_index", "integrity_digests", "integrity_mismatch",
    "device_degraded",
    # serving-edge cache (cache/): hit/miss rollup + entries
    "cache_hits", "cache_misses", "cache_entries",
    # workload-heat plane (obs/heat.py): traffic concentration + the
    # {50,90,99}% working-set bytes at the region's own tier; touches
    # == 0 means no evidence. Feeds the coordinator's capacity rollups
    "heat_hot_fraction", "heat_gini", "heat_working_set_p50",
    "heat_working_set_p90", "heat_working_set_p99", "heat_touches",
    # per-shape cost model (obs/cost.py): EWMA per-row dispatch cost µs
    "cost_row_us",
    # memory-tier ladder (index/tiering.py): serving rung name
    "serving_tier",
    # control-plane flight recorder (obs/events.py): live-overrides JSON
    "live_knobs",
)

_STORE_METRIC_FIELDS = (
    "store_id", "collected_at_ms", "device_bytes_in_use",
    "device_bytes_limit", "device_peak_bytes", "engine_key_count",
)

# control-plane decision events (obs/events.Event <-> pb.ControlEvent);
# same field names on both sides, all scalars
_CONTROL_EVENT_FIELDS = (
    "actor", "region_id", "knob", "old", "new", "trigger", "evidence",
    "ts_ms", "actor_seq", "node_id", "trace_id", "flight_bundle_id",
)


def control_event_to_pb(ev, out: Optional[pb.ControlEvent] = None
                        ) -> pb.ControlEvent:
    out = out if out is not None else pb.ControlEvent()
    for f in _CONTROL_EVENT_FIELDS:
        v = getattr(ev, f)
        # old/new are free-typed on the ledger Event (ints, floats, rung
        # names, None); the wire carries strings
        if f in ("old", "new"):
            v = "" if v is None else str(v)
        setattr(out, f, v)
    return out


def control_event_from_pb(m: pb.ControlEvent):
    from dingo_tpu_torch.obs.events import Event

    return Event(**{f: getattr(m, f) for f in _CONTROL_EVENT_FIELDS})


def region_metrics_to_pb(rm, out: Optional[pb.RegionMetrics] = None
                         ) -> pb.RegionMetrics:
    out = out if out is not None else pb.RegionMetrics()
    for f in _REGION_METRIC_FIELDS:
        setattr(out, f, getattr(rm, f))
    return out


def region_metrics_from_pb(m: pb.RegionMetrics):
    from dingo_tpu_torch.metrics.snapshot import RegionMetricsSnapshot

    return RegionMetricsSnapshot(
        **{f: getattr(m, f) for f in _REGION_METRIC_FIELDS}
    )


def store_metrics_to_pb(snap, out: Optional[pb.StoreMetrics] = None
                        ) -> pb.StoreMetrics:
    out = out if out is not None else pb.StoreMetrics()
    for f in _STORE_METRIC_FIELDS:
        setattr(out, f, getattr(snap, f))
    for rm in snap.regions:
        region_metrics_to_pb(rm, out.regions.add())
    for ev in getattr(snap, "events", ()):
        control_event_to_pb(ev, out.events.add())
    return out


def store_metrics_from_pb(m: pb.StoreMetrics):
    from dingo_tpu_torch.metrics.snapshot import StoreMetricsSnapshot

    snap = StoreMetricsSnapshot(
        **{f: getattr(m, f) for f in _STORE_METRIC_FIELDS}
    )
    snap.regions = [region_metrics_from_pb(r) for r in m.regions]
    snap.events = [control_event_from_pb(e) for e in m.events]
    return snap
