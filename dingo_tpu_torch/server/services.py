"""The port's coalesced search ingress: ``IndexService`` of
dingo_tpu/server/services.py, bound to a store node.

``IndexService(node)`` holds one SearchCoalescer whose ``run`` is the
node's ``storage.vector_batch_search(region, ...)`` and whose ``dispatch``
is ``storage.vector_batch_search_async(region, ..., staged=...)``, as in
the JAX package's ``_get_coalescer``: every batch goes through the
region's VectorReader (its id-window filter, its brute-force fallback for
an untrained index) and the reader fills the coalescer's ``stage_us``
split. Requests with the same (region, topk, scalar search parameters)
share a batch. With ``cache_enabled`` those requests consult the
serving-edge cache first (cache/edge.py): a request whose rows all hit
resolves at once and launches nothing, a partial hit submits only its
miss rows, and the fresh rows fill the cache when the region's
mutation_version did not move while they were computed. The gRPC
handlers (server/grpc_services.py) subclass it; this module imports
neither grpc nor protobuf, so the card's phases use it in process.

    service = IndexService(node, window_ms=2.0, max_batch=64)
    rows = service.submit(1, queries, 10, nprobe=32).result(timeout=30)
    service.close()

Each reply is a list of VectorWithData rows, one list per query. The
coalescer runs on the node's device: on CUDA ``pipeline_enabled = "auto"``
takes the pipelined arm. ``_SCAN_SESSIONS`` holds the KvScanBegin
sessions; the store crontab's ``scan_gc`` job recycles the idle ones.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from dingo_tpu_torch.cache import edge as cache_edge
from dingo_tpu_torch.common.coalescer import SearchCoalescer
from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.common.stream import StreamManager
from dingo_tpu_torch.index.base import VectorIndexError
from dingo_tpu_torch.obs import pressure as qp
from dingo_tpu_torch.obs.flight import black_box_error
from dingo_tpu_torch.store.region import Region


class IndexService:
    """Vector searches over a node's regions through one coalescer.

    ``window_ms`` None follows the ``search_coalescing_window_ms`` flag,
    hot changes included; a window of 0 searches each request directly,
    as the JAX package's service does. With ``qos_enabled`` each reply is
    counted served (and in or past its deadline) by the pressure plane."""

    def __init__(self, node, window_ms: Optional[float] = None,
                 max_batch: int = 256):
        self.node = node
        self._window_from_flag = window_ms is None
        self.window_ms = float(FLAGS.get("search_coalescing_window_ms")
                               if window_ms is None else window_ms)
        self.max_batch = max_batch
        self._coalescer: Optional[SearchCoalescer] = None
        self._coalescer_lock = threading.Lock()

    def window(self) -> float:
        """The coalescing window in force. One that follows the flag
        re-reads it: a moved window stops the coalescer, and the next
        coalesced request builds one with the new window."""
        if not self._window_from_flag:
            return self.window_ms
        window = float(FLAGS.get("search_coalescing_window_ms"))
        with self._coalescer_lock:
            if window != self.window_ms:
                if self._coalescer is not None:
                    self._coalescer.stop()
                    self._coalescer = None
                self.window_ms = window
        return window

    def _region(self, region_id: int) -> Region:
        region = self.node.get_region(region_id)
        if region is None:
            raise VectorIndexError(f"region {region_id} gone")
        return region

    def _get_coalescer(self) -> SearchCoalescer:
        with self._coalescer_lock:
            if self._coalescer is None:
                def run(key, stacked, stage_us=None):
                    region_id, topk, kw_items = key
                    return self.node.storage.vector_batch_search(
                        self._region(region_id), stacked, topk,
                        stage_us=stage_us, **dict(kw_items))

                def dispatch(key, stacked, staged=None, stage_us=None):
                    # the pipelined arm: launch now, return the resolve
                    # thunk; the coalescer's completion lane waits on it
                    region_id, topk, kw_items = key
                    return self.node.storage.vector_batch_search_async(
                        self._region(region_id), stacked, topk,
                        staged=staged, stage_us=stage_us, **dict(kw_items))

                self._coalescer = SearchCoalescer(
                    run, window_ms=self.window_ms, max_batch=self.max_batch,
                    dispatch_fn=dispatch, device=self.node.device)
            return self._coalescer

    def submit(self, region_id: int, queries: np.ndarray, topk: int,
               max_batch: int = 0, span=None, **kw) -> Future:
        """Search `queries` [n, d] on a region: a Future of n rows of
        VectorWithData. `kw` are the reader's search parameters; only
        requests whose parameters are all scalars (nprobe) are coalesced,
        others (a filter) search directly, as in the JAX package's
        service. `max_batch` (0 = the service's) caps the rows a merged
        batch of this request's key may stack. A search that fails with
        VectorIndexError or ValueError writes one flight bundle, carrying
        `span` (the request's ingress span) when given; the JAX package's
        VectorSearch black-boxes those failures and no others."""
        t0 = time.perf_counter_ns()
        plain = all(isinstance(v, (int, float, str, bool, type(None)))
                    for v in kw.values())
        if plain and self.window() > 0:
            key = (region_id, int(topk), tuple(sorted(kw.items())))
            fut = self._submit_cached(key, region_id, queries, int(topk),
                                      max_batch)
        else:
            fut = Future()
            try:
                fut.set_result(self.node.storage.vector_batch_search(
                    self._region(region_id), queries, topk, **kw))
            except Exception as exc:  # noqa: BLE001 — the caller's future
                fut.set_exception(exc)
        # the region's search latency series: its windowed rate is the
        # heartbeat's search_qps, its p99 the SLO tuner's latency budget
        lat = METRICS.latency("vector_search", region_id)
        # throughput against goodput: with qos on every reply counts
        # served, only those inside their budget count toward goodput
        qos = qp.qos_enabled()
        budget = qp.current_budget() if qos else None
        out: Future = Future()

        def finished(f: Future) -> None:
            # the caller's future resolves after the accounting, so a
            # failure's flight bundle exists when the caller sees it
            lat.observe_us((time.perf_counter_ns() - t0) / 1000.0)
            exc = f.exception()
            if isinstance(exc, (VectorIndexError, ValueError)):
                # a failed search black-boxes the moment (a flight bundle;
                # a device OOM is also counted by the HBM ledger)
                black_box_error("rpc.IndexService.VectorSearch", exc, span,
                                region_id=region_id)
            if exc is not None:
                out.set_exception(exc)
                return
            if qos:
                qp.PRESSURE.on_served(region_id, budget)
            out.set_result(f.result())

        fut.add_done_callback(finished)
        return out

    def _submit_cached(self, key, region_id: int, queries,
                       topk: int, max_batch: int = 0) -> Future:
        """The coalesced submit wrapped in the edge cache: lookup before
        the queue (a hit costs no queue slot and no kernel row), fill and
        merge after the miss rows return."""
        looked = None
        if cache_edge.active():
            region = self.node.get_region(region_id)
            if region is not None:
                w = getattr(region, "vector_index_wrapper", None)
                looked = cache_edge.lookup(
                    region_id, queries, topk, key[2],
                    cache_edge.region_version(region),
                    index=getattr(w, "own_index", None))
        if looked is None:
            return self._get_coalescer().submit(key, queries,
                                                max_batch=max_batch,
                                                region_id=region_id)
        fut: Future = Future()
        if looked.complete:
            fut.set_result(looked.rows)
            return fut
        q = np.asarray(queries)
        budget = qp.current_budget() if qp.qos_enabled() else None
        tenant = budget.tenant if budget is not None else "default"
        inner = self._get_coalescer().submit(key, q[looked.miss_idx],
                                             max_batch=max_batch,
                                             region_id=region_id)

        def stitch(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                fut.set_exception(exc)
                return
            try:
                results = f.result()
                # the version is read again now: rows that may straddle a
                # write are served but not cached
                cache_edge.fill(
                    region_id, looked, results,
                    cache_edge.region_version(
                        self.node.get_region(region_id)),
                    q, tenant=tenant)
                fut.set_result(looked.merge(results))
            except Exception as e:  # noqa: BLE001 — the caller's future
                fut.set_exception(e)

        inner.add_done_callback(stitch)
        return fut

    def close(self, drain: bool = True) -> None:
        with self._coalescer_lock:
            if self._coalescer is not None:
                self._coalescer.stop(drain=drain)
                self._coalescer = None


#: the store's KvScanBegin sessions (the ScanManager v2 role)
_SCAN_SESSIONS = StreamManager(idle_timeout_s=60.0)
