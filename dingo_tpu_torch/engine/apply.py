"""Apply handlers: committed write payloads -> raw engine + vector index
(port of dingo_tpu/engine/apply.py).

Reference: src/handler/raft_apply_handler.{h,cc} — per-command-type handlers
dispatched from StoreStateMachine::on_apply (store_state_machine.cc:110-216).
The same handlers serve both the raft path (every replica applies the
committed entry) and the mono path (single-replica direct apply), which is
exactly how MonoStoreEngine reuses them in the reference.

Key invariant (§3.2): the raw engine write happens FIRST (source of truth),
then the vector index is updated iff log_id > wrapper.apply_log_id — the
in-memory ANN index is an apply-log-tracked materialized view that can always
be rebuilt from the engine.

Split and merge are routed to the hosting StoreNode's handlers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dingo_tpu_torch.engine.raw_engine import (
    CF_DEFAULT,
    CF_VECTOR_SCALAR,
    CF_VECTOR_SCALAR_SPEEDUP,
    CF_VECTOR_TABLE,
    RawEngine,
    WriteBatch,
)
from dingo_tpu_torch.engine import write_data as wd
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.index.vector_reader import serialize_scalar, serialize_vector
from dingo_tpu_torch.mvcc.codec import MAX_TS, Codec, ValueFlag
from dingo_tpu_torch.store.region import Region
from dingo_tpu_torch.raft import wire


def apply_write(
    engine: RawEngine, region: Region, data: wd.WriteData, log_id: int = 0,
    context=None, want_result: bool = True,
) -> Optional[dict]:
    """Dispatch one committed payload (RaftApplyHandlerFactory equivalent).

    `context` (optional) is the hosting StoreNode for handlers that touch
    region topology (SplitHandler needs to create the child region and its
    raft member on EVERY replica applying the entry).

    Returns an optional handler result (e.g. {"deleted": n} for range
    deletes) that the replication engines surface to the proposer — the
    applied state, not a pre-propose scan, is what response counts must
    reflect (they can diverge under concurrent writes)."""
    from dingo_tpu_torch.common.failpoint import failpoint

    failpoint("before_apply")
    if isinstance(data, wd.SplitRegionData):
        if context is None:
            raise NotImplementedError(
                "region split needs a StoreNode context (mono engines do "
                "not host split topology)"
            )
        context.handle_split(region, data, log_id)
        return None
    if isinstance(data, wd.MergeRegionData):
        if context is None:
            raise NotImplementedError("region merge needs a StoreNode context")
        context.handle_merge(region, data, log_id)
        return None
    if isinstance(data, wd.RegionInstallData):
        _apply_region_install(engine, region, data)
        # rebuild derived in-memory indexes on THIS replica (each replica's
        # apply runs with its own node context)
        if context is not None and hasattr(context, "after_region_install"):
            context.after_region_install(region)
        return None
    if isinstance(data, wd.KvPutData):
        _apply_kv_put(engine, data)
    elif isinstance(data, wd.KvDeleteData):
        _apply_kv_delete(engine, data)
    elif isinstance(data, wd.KvDeleteRangeData):
        return _apply_kv_delete_range(engine, data, want_result)
    elif isinstance(data, wd.VectorAddData):
        _apply_vector_add(engine, region, data, log_id)
    elif isinstance(data, wd.VectorDeleteData):
        _apply_vector_delete(engine, region, data, log_id)
    elif isinstance(data, wd.DocumentAddData):
        _apply_document_add(engine, region, data, log_id)
    elif isinstance(data, wd.DocumentDeleteData):
        _apply_document_delete(engine, region, data, log_id)
    elif isinstance(data, wd.TxnRaftData):
        _apply_txn(engine, data)
    else:
        raise TypeError(f"unknown write payload {type(data)}")
    return None


def _apply_region_install(
    engine: RawEngine, region: Region, data: wd.RegionInstallData
) -> None:
    """Wipe + restore the region's range — delegates to the one
    region_install implementation (function-level import: raft_engine
    imports this module at top level)."""
    from dingo_tpu_torch.engine.raft_engine import region_install

    region_install(engine, region, dict(data.cfs))


def _apply_kv_put(engine: RawEngine, data: wd.KvPutData) -> None:
    batch = WriteBatch()
    flag = ValueFlag.PUT_TTL if data.ttl_ms else ValueFlag.PUT
    for key, value in data.kvs:
        batch.put(
            data.cf,
            Codec.encode_key(key, data.ts),
            Codec.package_value(value, flag, data.ttl_ms),
        )
    engine.write(batch)


def _apply_kv_delete(engine: RawEngine, data: wd.KvDeleteData) -> None:
    batch = WriteBatch()
    for key in data.keys:
        batch.put(
            data.cf,
            Codec.encode_key(key, data.ts),
            Codec.package_value(b"", ValueFlag.DELETE),
        )
    engine.write(batch)


def _apply_kv_delete_range(
    engine: RawEngine, data: wd.KvDeleteRangeData, want_result: bool
) -> Optional[dict]:
    """Range deletes drop whole encoded ranges (the reference issues RocksDB
    DeleteRange on the raw engine rather than writing per-key tombstones).

    The live-key count at apply time is what delete_count responses must
    report (a pre-propose scan races concurrent writes) — but it is NOT
    consensus state, so only a node with a waiting proposer pays for the
    scan (want_result); followers and log replay skip it. The scan runs
    inside the (per-region) apply loop, so it delays only this region's
    later applies — same serialization the reference's raft apply has.

    An empty end key means "to the end" (region with unbounded end_key):
    it must become an unbounded engine range, NOT an encoded b"" (which
    sorts below every real key and would delete nothing)."""
    deleted = 0
    if want_result:
        from dingo_tpu_torch.mvcc.reader import Reader as MvccReader

        reader = MvccReader(engine, data.cf)
        for start, end in data.ranges:
            deleted += reader.kv_count(start, end, MAX_TS)
    batch = WriteBatch()
    for start, end in data.ranges:
        batch.delete_range(
            data.cf, Codec.encode_bytes(start),
            Codec.encode_bytes(end) if end else None,
        )
    engine.write(batch)
    return {"deleted": deleted} if want_result else None


def _apply_vector_add(
    engine: RawEngine, region: Region, data: wd.VectorAddData, log_id: int
) -> None:
    """VectorAddHandler (raft_apply_handler.cc:1115): write data CF + scalar
    CF (+ speed-up/table CFs when schemas exist), then update the index."""
    part = region.definition.partition_id
    param = region.definition.index_parameter
    speedup_keys = tuple(
        getattr(param, "scalar_speedup_keys", ()) or ()) if param else ()
    batch = WriteBatch()
    flag = ValueFlag.PUT_TTL if data.ttl_ms else ValueFlag.PUT
    for i, vid in enumerate(data.ids):
        key = vcodec.encode_vector_key(part, int(vid))
        ekey = Codec.encode_key(key, data.ts)
        batch.put(
            CF_DEFAULT,
            ekey,
            Codec.package_value(
                serialize_vector(data.vectors[i]), flag, data.ttl_ms
            ),
        )
        if data.scalars is not None:
            batch.put(
                CF_VECTOR_SCALAR,
                ekey,
                Codec.package_value(
                    serialize_scalar(data.scalars[i]), flag, data.ttl_ms
                ),
            )
            if speedup_keys:
                # SplitVectorScalarData (vector_index_utils.h, written at
                # raft_apply_handler.cc:1115): the flagged subset lands in
                # a narrow CF so covered pre-filter scans skip the wide
                # one. The narrow CF is a DERIVED view of the wide row, so
                # every wide write gets a narrow twin — a tombstone when
                # the upsert dropped all flagged fields, or the previous
                # narrow version would stay visible and covered filters
                # would diverge from the wide path.
                subset = {
                    k: data.scalars[i][k]
                    for k in speedup_keys if k in data.scalars[i]
                }
                if subset:
                    batch.put(
                        CF_VECTOR_SCALAR_SPEEDUP,
                        ekey,
                        Codec.package_value(
                            serialize_scalar(subset), flag, data.ttl_ms
                        ),
                    )
                else:
                    batch.put(
                        CF_VECTOR_SCALAR_SPEEDUP, ekey,
                        Codec.package_value(b"", ValueFlag.DELETE),
                    )
        if data.table_values is not None:
            # table rows are an independent attribute, per entry:
            # None = leave this vector's row untouched, b"" = clear it,
            # bytes = replace it
            tv = data.table_values[i]
            if tv:
                batch.put(
                    CF_VECTOR_TABLE,
                    ekey,
                    Codec.package_value(tv, flag, data.ttl_ms),
                )
            elif tv is not None:
                batch.put(
                    CF_VECTOR_TABLE, ekey,
                    Codec.package_value(b"", ValueFlag.DELETE),
                )
    engine.write(batch)

    wrapper = region.vector_index_wrapper
    if wrapper is not None and wrapper.is_ready():
        if data.is_update:
            wrapper.add(data.ids, data.vectors, log_id, is_upsert=True)
        else:
            wrapper.add(data.ids, data.vectors, log_id, is_upsert=False)


def _apply_vector_delete(
    engine: RawEngine, region: Region, data: wd.VectorDeleteData, log_id: int
) -> None:
    part = region.definition.partition_id
    batch = WriteBatch()
    for vid in data.ids:
        key = vcodec.encode_vector_key(part, int(vid))
        ekey = Codec.encode_key(key, data.ts)
        batch.put(CF_DEFAULT, ekey, Codec.package_value(b"", ValueFlag.DELETE))
        batch.put(
            CF_VECTOR_SCALAR, ekey, Codec.package_value(b"", ValueFlag.DELETE)
        )
        batch.put(
            CF_VECTOR_SCALAR_SPEEDUP, ekey,
            Codec.package_value(b"", ValueFlag.DELETE),
        )
        batch.put(
            CF_VECTOR_TABLE, ekey, Codec.package_value(b"", ValueFlag.DELETE)
        )
    engine.write(batch)
    wrapper = region.vector_index_wrapper
    if wrapper is not None and wrapper.is_ready():
        wrapper.delete(np.asarray(data.ids, np.int64), log_id)


def _apply_document_add(
    engine: RawEngine, region: Region, data: wd.DocumentAddData, log_id: int
) -> None:
    """DocumentAdd handler: persist docs (source of truth) then update the
    in-memory full-text index — same dual-write contract as vectors."""
    part = region.definition.partition_id
    batch = WriteBatch()
    for did, doc in zip(data.ids, data.documents):
        key = vcodec.encode_vector_key(part, int(did))
        batch.put(
            CF_DEFAULT,
            Codec.encode_key(key, data.ts),
            Codec.package_value(wire.encode_obj(doc)),
        )
    engine.write(batch)
    if region.document_index is not None and (
        log_id == 0 or log_id > region.document_index.apply_log_id
    ):
        for did, doc in zip(data.ids, data.documents):
            region.document_index.upsert(int(did), doc)
        if log_id:
            region.document_index.apply_log_id = log_id


def _apply_document_delete(
    engine: RawEngine, region: Region, data: wd.DocumentDeleteData, log_id: int
) -> None:
    part = region.definition.partition_id
    batch = WriteBatch()
    for did in data.ids:
        key = vcodec.encode_vector_key(part, int(did))
        batch.put(
            CF_DEFAULT,
            Codec.encode_key(key, data.ts),
            Codec.package_value(b"", ValueFlag.DELETE),
        )
    engine.write(batch)
    if region.document_index is not None and (
        log_id == 0 or log_id > region.document_index.apply_log_id
    ):
        region.document_index.delete([int(d) for d in data.ids])
        if log_id:
            region.document_index.apply_log_id = log_id


def _apply_txn(engine: RawEngine, data: wd.TxnRaftData) -> None:
    batch = WriteBatch()
    for cf, key, value in data.puts:
        batch.put(cf, key, value)
    for cf, key in data.deletes:
        batch.delete(cf, key)
    engine.write(batch)
