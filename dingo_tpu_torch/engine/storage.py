"""Storage facade: role-agnostic entry points over the engines (port of
dingo_tpu/engine/storage.py).

Reference: src/engine/storage.{h,cc} (storage.h:33) — stateless dispatch that
picks the engine (raft vs mono, GetStoreEngine storage.cc:65), stamps TSO
timestamps (ts_provider_->GetTs(), storage.cc:460), validates requests, and
exposes KvGet/KvPut/VectorAdd (storage.cc:458)/VectorBatchSearch
(storage.cc:577)/Txn* to the RPC services.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dingo_tpu_torch.engine import write_data as wd
from dingo_tpu_torch.engine.raw_engine import CF_DEFAULT
from dingo_tpu_torch.index.base import InvalidParameter
from dingo_tpu_torch.index.vector_reader import VectorWithData
from dingo_tpu_torch.mvcc.codec import MAX_TS
from dingo_tpu_torch.mvcc.reader import Reader as MvccReader
from dingo_tpu_torch.mvcc.ts_provider import TsProvider
from dingo_tpu_torch.store.region import Region

#: FLAGS_vector_max_batch_count (index_service.cc:50)
VECTOR_MAX_BATCH_COUNT = 4096
#: FLAGS_vector_max_request_size (index_service.cc:51)
VECTOR_MAX_REQUEST_SIZE = 32 * 1024 * 1024
#: topN * batch guard (index_service.cc:206)
MAX_TOPN_BATCH_PRODUCT = 10 * VECTOR_MAX_BATCH_COUNT


class Storage:
    def __init__(self, engine, ts_provider: Optional[TsProvider] = None):
        """engine: MonoStoreEngine or RaftStoreEngine (same surface)."""
        import threading

        self.engine = engine
        self.ts_provider = ts_provider or TsProvider()
        self._locks_guard = threading.Lock()
        self._region_locks: Dict[int, Any] = {}

    def _region_lock(self, region: Region):
        """Serializes read-check-write primitives per region (the reference
        uses Latches/ConcurrencyManager for the same job, latch.h:27-95)."""
        import threading

        with self._locks_guard:
            lock = self._region_locks.get(region.id)
            if lock is None:
                lock = self._region_locks[region.id] = threading.Lock()
            return lock

    # ---------------- KV ----------------------------------------------------

    def kv_get(self, region: Region, key: bytes,
               read_ts: int = MAX_TS) -> Optional[bytes]:
        return MvccReader(self.engine.raw, CF_DEFAULT).kv_get(key, read_ts)

    def kv_batch_get(self, region: Region, keys: Sequence[bytes],
                     read_ts: int = MAX_TS) -> List[Optional[bytes]]:
        reader = MvccReader(self.engine.raw, CF_DEFAULT)
        return [reader.kv_get(k, read_ts) for k in keys]

    def kv_put(self, region: Region, kvs: Sequence[Tuple[bytes, bytes]],
               ttl_ms: int = 0) -> int:
        ts = self.ts_provider.get_ts()
        self.engine.write(
            region, wd.KvPutData(cf=CF_DEFAULT, ts=ts, kvs=list(kvs),
                                 ttl_ms=ttl_ms)
        )
        return ts

    def kv_put_if_absent(
        self, region: Region, kvs: Sequence[Tuple[bytes, bytes]],
        is_atomic: bool = False,
    ) -> List[bool]:
        """KvPutIfAbsent semantics: per-key success flags. is_atomic: all
        keys must be absent or nothing is written (store_service.cc
        KvBatchPutIfAbsent atomic arm)."""
        reader = MvccReader(self.engine.raw, CF_DEFAULT)
        with self._region_lock(region):
            ts = self.ts_provider.get_ts()
            wins, results = [], []
            for k, v in kvs:
                if reader.kv_get(k, MAX_TS) is None:
                    wins.append((k, v))
                    results.append(True)
                else:
                    results.append(False)
            if is_atomic and not all(results):
                return [False] * len(results)
            if wins:
                self.engine.write(
                    region, wd.KvPutData(cf=CF_DEFAULT, ts=ts, kvs=wins)
                )
            return results

    def kv_compare_and_set(
        self, region: Region, key: bytes, expect: Optional[bytes], value: bytes
    ) -> bool:
        reader = MvccReader(self.engine.raw, CF_DEFAULT)
        with self._region_lock(region):
            cur = reader.kv_get(key, MAX_TS)
            if cur != expect:
                return False
            ts = self.ts_provider.get_ts()
            self.engine.write(
                region, wd.KvPutData(cf=CF_DEFAULT, ts=ts, kvs=[(key, value)])
            )
            return True

    def kv_batch_delete(self, region: Region, keys: Sequence[bytes]) -> int:
        ts = self.ts_provider.get_ts()
        self.engine.write(
            region, wd.KvDeleteData(cf=CF_DEFAULT, ts=ts, keys=list(keys))
        )
        return ts

    def kv_delete_range(
        self, region: Region, ranges: Sequence[Tuple[bytes, bytes]]
    ) -> int:
        """Returns the number of live keys the APPLIED write removed (the
        apply handler counts them; a pre-propose scan would race concurrent
        writes)."""
        ts = self.ts_provider.get_ts()
        log_id = self.engine.write(
            region,
            wd.KvDeleteRangeData(cf=CF_DEFAULT, ts=ts, ranges=list(ranges)),
        )
        result = self.engine.take_apply_result(region.id, log_id)
        return int(result["deleted"]) if result else 0

    def kv_scan(
        self,
        region: Region,
        start: bytes,
        end: bytes,
        limit: int = 0,
        read_ts: int = MAX_TS,
        keys_only: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        return MvccReader(self.engine.raw, CF_DEFAULT).kv_scan(
            start, end, read_ts, limit, keys_only
        )

    # ---------------- vector -------------------------------------------------

    def _validate_vector_batch(self, region: Region, ids, vectors) -> None:
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        if len(ids) > VECTOR_MAX_BATCH_COUNT:
            raise InvalidParameter(
                f"batch {len(ids)} > {VECTOR_MAX_BATCH_COUNT}"
            )
        if vectors.nbytes > VECTOR_MAX_REQUEST_SIZE:
            raise InvalidParameter("request exceeds 32MiB")
        param = region.definition.index_parameter
        from dingo_tpu_torch.index.vector_reader import is_binary_dim_param

        want = None
        if param:
            want = (param.dimension // 8 if is_binary_dim_param(param)
                    else param.dimension)
        if want is not None and vectors.shape[1] != want:
            raise InvalidParameter(
                f"row width {vectors.shape[1]} != {want}"
            )
        lo, hi = region.id_window()
        ids = np.asarray(ids, np.int64)
        if ((ids < lo) | (ids >= hi)).any():
            raise InvalidParameter("vector id out of region range")

    def vector_add(
        self,
        region: Region,
        ids: np.ndarray,
        vectors: np.ndarray,
        scalars: Optional[List[Dict[str, Any]]] = None,
        is_update: bool = True,
        ttl_ms: int = 0,
        table_values: Optional[List[bytes]] = None,
    ) -> int:
        """Storage::VectorAdd (storage.cc:458-482): stamp TSO ts, build write
        payload, hand to the engine (raft propose or mono apply)."""
        from dingo_tpu_torch.common.failpoint import failpoint

        failpoint("before_vector_add")
        from dingo_tpu_torch.index.vector_reader import is_binary_dim_param

        if is_binary_dim_param(region.definition.index_parameter):
            vectors = np.asarray(vectors, np.uint8)
        else:
            vectors = np.asarray(vectors, np.float32)
        ids = np.asarray(ids, np.int64)
        self._validate_vector_batch(region, ids, vectors)
        ts = self.ts_provider.get_ts()
        self.engine.write(
            region,
            wd.VectorAddData(
                ts=ts, ids=ids, vectors=vectors, scalars=scalars,
                is_update=is_update, ttl_ms=ttl_ms,
                table_values=table_values,
            ),
        )
        return ts

    def vector_delete(self, region: Region, ids: Sequence[int]) -> int:
        ts = self.ts_provider.get_ts()
        self.engine.write(
            region,
            wd.VectorDeleteData(ts=ts, ids=np.asarray(ids, np.int64)),
        )
        return ts

    def _search_queries(self, region: Region, queries,
                        topk: int) -> np.ndarray:
        """The search guards: the region's query dtype, a 2-d batch of at
        most VECTOR_MAX_BATCH_COUNT rows, topk x rows under the
        index_service.cc:206 product cap."""
        from dingo_tpu_torch.index.vector_reader import is_binary_dim_param

        qdtype = (
            np.uint8
            if is_binary_dim_param(region.definition.index_parameter)
            else np.float32
        )
        queries = np.asarray(queries, qdtype)
        if queries.ndim == 1:
            queries = queries[None, :]
        if len(queries) > VECTOR_MAX_BATCH_COUNT:
            raise InvalidParameter("too many queries")
        if topk * len(queries) > MAX_TOPN_BATCH_PRODUCT:
            raise InvalidParameter(
                "topN * batch exceeds guard (index_service.cc:206)"
            )
        return queries

    def vector_batch_search(
        self, region: Region, queries: np.ndarray, topk: int, **kw
    ) -> List[List[VectorWithData]]:
        """Storage::VectorBatchSearch (storage.cc:577)."""
        queries = self._search_queries(region, queries, topk)
        reader = self.engine.new_vector_reader(region)
        return reader.vector_batch_search(queries, topk, **kw)

    def vector_batch_search_async(
        self, region: Region, queries: np.ndarray, topk: int, **kw
    ):
        """Dispatch-now/resolve-later arm of vector_batch_search (serving
        pipeline): same guards, returns the reader's resolve thunk."""
        queries = self._search_queries(region, queries, topk)
        reader = self.engine.new_vector_reader(region)
        return reader.vector_batch_search_async(queries, topk, **kw)

    def vector_batch_query(self, region: Region, ids: Sequence[int], **kw):
        return self.engine.new_vector_reader(region).vector_batch_query(ids, **kw)

    def vector_get_border_id(self, region: Region, get_min: bool):
        return self.engine.new_vector_reader(region).vector_get_border_id(get_min)

    def vector_scan_query(self, region: Region, **kw):
        return self.engine.new_vector_reader(region).vector_scan_query(**kw)

    def vector_count(self, region: Region) -> int:
        return self.engine.new_vector_reader(region).vector_count()
