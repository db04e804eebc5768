"""The port's coalesced search ingress: ``IndexService`` of
dingo_tpu/server/services.py, bound to a store node.

``IndexService(node)`` holds one SearchCoalescer whose ``run`` is the
node's ``storage.vector_batch_search(region, ...)`` and whose ``dispatch``
is ``storage.vector_batch_search_async(region, ..., staged=...)``, as in
the JAX package's ``_get_coalescer``: every batch goes through the
region's VectorReader (its id-window filter, its brute-force fallback for
an untrained index) and the reader fills the coalescer's ``stage_us``
split. Requests with the same (region, topk, scalar search parameters)
share a batch. The gRPC server around it is not ported yet: callers submit
in-process.

    service = IndexService(node, window_ms=2.0, max_batch=64)
    rows = service.submit(1, queries, 10, nprobe=32).result(timeout=30)
    service.close()

Each reply is a list of VectorWithData rows, one list per query. The
coalescer runs on the node's device: on CUDA ``pipeline_enabled = "auto"``
takes the pipelined arm.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np

from dingo_tpu_torch.common.coalescer import SearchCoalescer
from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.index.base import VectorIndexError
from dingo_tpu_torch.obs import pressure as qp
from dingo_tpu_torch.store.region import Region


class IndexService:
    """Vector searches over a node's regions through one coalescer.

    ``window_ms`` None takes the ``search_coalescing_window_ms`` flag; a
    window of 0 searches each request directly, as the JAX package's
    service does. With ``qos_enabled`` each reply is counted served (and
    in or past its deadline) by the pressure plane."""

    def __init__(self, node, window_ms: Optional[float] = None,
                 max_batch: int = 256):
        self.node = node
        self.window_ms = float(FLAGS.get("search_coalescing_window_ms")
                               if window_ms is None else window_ms)
        self.max_batch = max_batch
        self._coalescer: Optional[SearchCoalescer] = None
        self._coalescer_lock = threading.Lock()

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
               **kw) -> Future:
        """Search `queries` [n, d] on a region: a Future of n rows of
        VectorWithData. `kw` are the reader's search parameters; only
        requests whose parameters are all scalars (nprobe) are coalesced,
        others (a filter) search directly, as in the JAX package's
        service."""
        plain = all(isinstance(v, (int, float, str, bool, type(None)))
                    for v in kw.values())
        if plain and self.window_ms > 0:
            key = (region_id, int(topk), tuple(sorted(kw.items())))
            fut = self._get_coalescer().submit(key, queries,
                                               region_id=region_id)
        else:
            fut = Future()
            try:
                fut.set_result(self.node.storage.vector_batch_search(
                    self._region(region_id), queries, topk, **kw))
            except Exception as exc:  # noqa: BLE001 — the caller's future
                fut.set_exception(exc)
        if qp.qos_enabled():
            # throughput against goodput: every reply counts served, only
            # those inside their budget count toward goodput
            budget = qp.current_budget()

            def served(f: Future) -> None:
                if f.exception() is None:
                    qp.PRESSURE.on_served(region_id, budget)

            fut.add_done_callback(served)
        return fut

    def close(self, drain: bool = True) -> None:
        with self._coalescer_lock:
            if self._coalescer is not None:
                self._coalescer.stop(drain=drain)
                self._coalescer = None
