"""Typed write payloads (raft proposal bodies)
(port of dingo_tpu/engine/write_data.py).

Reference: src/engine/write_data.h (762 LoC) — WriteDataBuilder::BuildWrite
constructs typed RaftCmdRequest payloads (KV puts, vector adds with cf/ts/ttl,
deletes); the same payload is applied by the raft state machine on every
replica (handler/raft_apply_handler.h:29-193).

These dataclasses are the wire-neutral equivalents; `encode_write` /
`decode_write` serialize them with the typed TLV codec (raft/wire.py) for
replication — decoding network bytes can only ever produce these dataclass
shapes, never execute code (the reference gets the same property from
protobuf-typed RaftCmdRequest messages).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dingo_tpu_torch.raft import wire


@dataclasses.dataclass
class KvPutData:
    """PutHandler payload."""

    cf: str
    ts: int
    kvs: List[Tuple[bytes, bytes]]
    ttl_ms: int = 0


@dataclasses.dataclass
class KvDeleteData:
    """DeleteBatchHandler payload (tombstone versions)."""

    cf: str
    ts: int
    keys: List[bytes]


@dataclasses.dataclass
class KvDeleteRangeData:
    """DeleteRangeHandler payload."""

    cf: str
    ts: int
    ranges: List[Tuple[bytes, bytes]]


@dataclasses.dataclass
class VectorAddData:
    """VectorAddHandler payload (raft_apply_handler.cc:1115): vector rows +
    scalar data; handler writes data/scalar/table CFs then updates the
    in-memory index through the wrapper."""

    ts: int
    ids: np.ndarray                       # [n] int64
    vectors: np.ndarray                   # [n, d] f32
    scalars: Optional[List[Dict[str, Any]]] = None
    is_update: bool = True                # upsert vs add
    ttl_ms: int = 0
    #: per-vector serial-encoded table row -> vector_table CF (the TABLE
    #: coprocessor filter's data source, vector_reader.cc:169-232).
    #: Per entry: None = leave this vector's row untouched, b"" = clear
    #: it, bytes = replace it.
    table_values: Optional[List[Optional[bytes]]] = None


@dataclasses.dataclass
class VectorDeleteData:
    """VectorDeleteHandler payload (raft_apply_handler.cc:1374)."""

    ts: int
    ids: np.ndarray


@dataclasses.dataclass
class RebuildVectorIndexData:
    """RebuildVectorIndexHandler (raft_apply_handler.cc:1546): replicated
    marker that a rebuild cutover happened at this log position."""

    cutover_log_id: int = 0


@dataclasses.dataclass
class SplitRegionData:
    """SplitHandler payload (raft_apply_handler.cc:702)."""

    child_region_id: int
    split_key: bytes


@dataclasses.dataclass
class DocumentAddData:
    """DocumentAdd/BatchAddHandler payload (handler list,
    raft_apply_handler.h: DocumentAdd/Delete/BatchAddHandler)."""

    ts: int
    ids: List[int]
    documents: List[Dict[str, Any]]
    is_update: bool = True


@dataclasses.dataclass
class DocumentDeleteData:
    ts: int
    ids: List[int]


@dataclasses.dataclass
class MergeRegionData:
    """CommitMergeHandler payload (raft_apply_handler.cc:78-99,1021):
    target absorbs the source region's range; the source's in-memory index
    becomes the target's sibling until the target rebuilds."""

    source_region_id: int
    source_end_key: bytes


@dataclasses.dataclass
class RegionInstallData:
    """Whole-region wipe + restore (RegionImport) routed through the raft
    log: every replica applies the install at the same log position, so
    concurrent raft writes order strictly before or after it and replicas
    can never diverge (the off-log `region_install` push this replaces
    left any replica that applied a concurrent write mid-push permanently
    forked)."""

    cfs: List[Tuple[str, List[Tuple[bytes, bytes]]]]


@dataclasses.dataclass
class TxnRaftData:
    """TxnHandler payload (raft_apply_handler_txn.cc): pre-encoded CF writes
    produced by the Percolator helper (engine/txn.py)."""

    puts: List[Tuple[str, bytes, bytes]]
    deletes: List[Tuple[str, bytes]]


WriteData = Any  # union of the payload dataclasses above

_PAYLOAD_TYPES = {
    cls.__name__: cls
    for cls in (
        KvPutData, KvDeleteData, KvDeleteRangeData, VectorAddData,
        VectorDeleteData, RebuildVectorIndexData, SplitRegionData,
        DocumentAddData, DocumentDeleteData, MergeRegionData,
        RegionInstallData, TxnRaftData,
    )
}

def encode_write(data: WriteData) -> bytes:
    """Raft proposal payload bytes for any of the dataclasses above."""
    fields = {
        f.name: wire.to_plain(getattr(data, f.name))
        for f in dataclasses.fields(data)
    }
    return wire.encode({"kind": type(data).__name__, "fields": fields})


def decode_write(payload: bytes) -> WriteData:
    """Inverse of encode_write; raises wire.WireError on malformed bytes.
    Decoded ndarrays are read-only views over the wire buffer; tuples decode
    as lists (apply handlers only iterate/unpack)."""
    d = wire.decode(payload)
    if not isinstance(d, dict) or "kind" not in d or "fields" not in d:
        raise wire.WireError("decode_write: not a WriteData envelope")
    cls = _PAYLOAD_TYPES.get(d["kind"])
    if cls is None:
        raise wire.WireError(f"decode_write: unknown payload kind {d['kind']!r}")
    fields = d["fields"]
    if not isinstance(fields, dict):
        raise wire.WireError("decode_write: fields must be a dict")
    names = {f.name for f in dataclasses.fields(cls)}
    if set(fields) - names:
        raise wire.WireError(
            f"decode_write: unexpected fields {set(fields) - names}"
        )
    try:
        return cls(**{k: wire.from_plain(v) for k, v in fields.items()})
    except (TypeError, ValueError) as e:
        raise wire.WireError(f"decode_write: bad fields: {e}") from e
