"""DiskAnnCore: a disk-resident vector index with device-side PQ pruning
(port of dingo_tpu/diskann/core.py, the core of the diskann role).

Storage keeps full vectors out of device memory:
  disk   — raw rows in an append-only file (``vectors.f32``, f32 [n, d])
           with their ids (``ids.bin``, int64), written while importing;
  device — coarse centroids [nlist, d], residual PQ codebooks and codes
           [n, m] uint8, and the codes grouped into spill buckets
           (index/ivf_layout.py).
  search — the IVF_PQ XLA arm's ADC scan over the probed buckets
           (index/ivf_pq._ivfpq_scan_kernel, counted in its ``calls``)
           gives topk * RERANK_FACTOR candidate rows, one bounded,
           sorted gather reads them from disk, and an exact f32 rerank on
           the device orders them.

The files are the JAX package's (``vectors.f32``, ``ids.bin``,
``pq_index.npz``, ``meta.json``), so the port loads a directory the JAX
core built. Where the port departs from it: the L2 rerank sums the squared
differences (the JAX core expands ||q||^2 - 2 q.x + ||x||^2, which loses
~1e-3 at ||x||^2 ~ 860), and the encode runs in 8,192-row pieces of each
65,536-row chunk (bounding the [m, rows, ksub] distance block).

State machine (DiskANNCoreState): UNINIT -> IMPORTING -> IMPORTED ->
BUILDING -> BUILT -> LOADING -> LOADED (+FAILED); reset and close return
to earlier states, destroy removes the files.
"""

from __future__ import annotations

import enum
import json
import os
import shutil
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.device import resolve_device, upload
from dingo_tpu_torch.index.base import IndexParameter, InvalidParameter
from dingo_tpu_torch.index.flat import _pad_batch
from dingo_tpu_torch.index.ivf_flat import coarse_probes
from dingo_tpu_torch.index.ivf_layout import (
    MutableIvfView,
    expand_probes_ranked,
)
from dingo_tpu_torch.index.ivf_pq import LUT_BUDGET_BYTES, _ivfpq_scan_kernel
from dingo_tpu_torch.ops.distance import Metric, np_normalize, squared_norms
from dingo_tpu_torch.ops.kmeans import (
    MAX_POINTS_PER_CENTROID,
    kmeans_assign,
    train_kmeans,
)
from dingo_tpu_torch.ops.pq import pq_train, split_subvectors

#: ADC candidates read from disk per requested result (the JAX core's
#: default: factor 32 gave recall@10 0.994 at 50K x 128, nprobe 24)
RERANK_FACTOR = 32
#: rows read from disk and encoded per device round during the build
ENCODE_CHUNK = 65536
#: rows per nearest-codeword block inside a chunk
ENCODE_BLOCK = 8192


def _bounded_gather(mmap: np.ndarray, flat_rows: np.ndarray) -> np.ndarray:
    """Rows of the on-disk vector file under an IO budget: the candidate
    rows deduplicated and sorted (queries share neighbours; ascending
    offsets read mostly forward), read diskann_rerank_io_rows at a time,
    then put back in the caller's order."""
    budget = max(1, int(FLAGS.get("diskann_rerank_io_rows")))
    uniq, inverse = np.unique(flat_rows, return_inverse=True)
    out = np.empty((uniq.shape[0], mmap.shape[1]), dtype=mmap.dtype)
    for i in range(0, uniq.shape[0], budget):
        out[i:i + budget] = mmap[uniq[i:i + budget]]
    return out[inverse]


def _encode(resid: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Residuals [n, d] -> codes [n, m] uint8: per subspace the argmin of
    ||sub||^2 - 2 sub.cb + ||cb||^2, unclamped, as the JAX core's build
    encodes."""
    m = codebooks.shape[0]
    cb_sq = (codebooks * codebooks).sum(-1)                  # [m, ksub]
    out = torch.empty((resid.shape[0], m), dtype=torch.uint8,
                      device=resid.device)
    for lo in range(0, resid.shape[0], ENCODE_BLOCK):
        subs = split_subvectors(resid[lo:lo + ENCODE_BLOCK], m)
        d2 = ((subs * subs).sum(-1)[:, :, None]
              - 2.0 * torch.bmm(subs, codebooks.transpose(1, 2))
              + cb_sq[:, None, :])
        out[lo:lo + ENCODE_BLOCK] = torch.argmin(d2, dim=2).T.to(
            torch.uint8)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CoreState(enum.Enum):
    UNINIT = "uninit"
    IMPORTING = "importing"
    IMPORTED = "imported"
    BUILDING = "building"
    BUILT = "built"
    LOADING = "loading"
    LOADED = "loaded"
    FAILED = "failed"


class DiskAnnError(RuntimeError):
    pass


class DiskAnnCore:
    def __init__(self, index_id: int, parameter: IndexParameter,
                 data_dir: str, device=None):
        if parameter.dimension <= 0:
            raise InvalidParameter(f"dimension {parameter.dimension}")
        if parameter.dimension % parameter.nsubvector:
            raise InvalidParameter(
                f"dimension {parameter.dimension} % m={parameter.nsubvector}"
            )
        if parameter.metric not in (Metric.L2, Metric.INNER_PRODUCT,
                                    Metric.COSINE):
            raise InvalidParameter(f"diskann metric {parameter.metric}")
        self.device = resolve_device(device)
        self.id = index_id
        self.parameter = parameter
        self.dim = parameter.dimension
        self.metric = parameter.metric
        self.nlist = parameter.ncentroids
        self.m = parameter.nsubvector
        self.ksub = 1 << parameter.nbits_per_idx
        self.dir = data_dir
        os.makedirs(self.dir, exist_ok=True)
        self.state = CoreState.UNINIT
        self._lock = threading.Lock()
        self.count = 0
        self._ids: Optional[np.ndarray] = None         # [n] int64
        self._mmap: Optional[np.memmap] = None         # [n, d] f32 on disk
        self.centroids: Optional[torch.Tensor] = None
        self._c_sqnorm: Optional[torch.Tensor] = None
        self.codebooks: Optional[torch.Tensor] = None
        self._codes: Optional[torch.Tensor] = None     # [n, m] uint8
        self._layout: Optional[MutableIvfView] = None
        self._code_buckets: Optional[torch.Tensor] = None
        self.last_error = ""
        self._id_to_row: dict = {}
        #: host-clock seconds of the last build's steps (the device is
        #: synchronized at each step's end)
        self.build_timings: dict = {}
        #: host-clock ms of the last search's steps: the ADC scan (to its
        #: candidates on the host), the disk gather, the rerank
        self.search_timings: dict = {}
        # restart recovery: a previous incarnation's import is adopted
        # (count and ids restored), so appends stay aligned with the file
        if os.path.exists(self._ids_path()):
            prev = np.fromfile(self._ids_path(), np.int64)
            self.count = len(prev)
            self._id_to_row = {int(v): i for i, v in enumerate(prev)}
            # a crash between the row append and the ids append leaves
            # orphan rows in vectors.f32: truncate them
            want = self.count * self.dim * 4
            if (os.path.exists(self._data_path())
                    and os.path.getsize(self._data_path()) > want):
                with open(self._data_path(), "r+b") as f:
                    f.truncate(want)
            if self.count:
                self.state = CoreState.IMPORTED

    # -- paths ---------------------------------------------------------------
    def _data_path(self) -> str:
        return os.path.join(self.dir, "vectors.f32")

    def _ids_path(self) -> str:
        return os.path.join(self.dir, "ids.bin")   # append-only int64

    def _index_path(self) -> str:
        return os.path.join(self.dir, "pq_index.npz")

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    # -- import --------------------------------------------------------------
    def push_data(self, ids: np.ndarray, vectors: np.ndarray,
                  has_more: bool) -> int:
        """Append a batch to the disk file (VectorPushData); an id pushed
        before overwrites its row in place. Returns the row count."""
        with self._lock:
            # IMPORTED is re-enterable: restart recovery lands there and a
            # caller may resume pushing before (re)building
            if self.state not in (CoreState.UNINIT, CoreState.IMPORTING,
                                  CoreState.IMPORTED):
                raise DiskAnnError(f"push_data in state {self.state.value}")
            self.state = CoreState.IMPORTING
        vectors = np.asarray(vectors, np.float32)
        ids = np.asarray(ids, np.int64)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise InvalidParameter(f"vector shape {vectors.shape}")
        if len(ids) != len(vectors):
            raise InvalidParameter("ids/vectors length mismatch")
        if self.metric is Metric.COSINE:
            vectors = np_normalize(vectors)
        with self._lock:
            fresh_rows, fresh_ids = [], []
            replace = []           # (row index, vector)
            for vid, row in zip(ids, vectors):
                r = self._id_to_row.get(int(vid))
                if r is None:
                    self._id_to_row[int(vid)] = self.count + len(fresh_ids)
                    fresh_ids.append(int(vid))
                    fresh_rows.append(row)
                else:
                    replace.append((r, row))
            if fresh_rows:
                with open(self._data_path(), "ab") as f:
                    f.write(np.stack(fresh_rows).tobytes())
                    f.flush()
            if replace:
                mm = np.memmap(self._data_path(), np.float32, "r+",
                               shape=(self.count + len(fresh_ids), self.dim))
                for r, row in replace:
                    mm[r] = row
                mm.flush()
                del mm
            if fresh_ids:
                # append-only: O(batch) a push, not O(total) rewrites
                with open(self._ids_path(), "ab") as f:
                    f.write(np.asarray(fresh_ids, np.int64).tobytes())
            self.count += len(fresh_ids)
            if not has_more:
                self.state = CoreState.IMPORTED
            return self.count

    # -- build ---------------------------------------------------------------
    def build(self) -> None:
        """Train the coarse quantizer and residual PQ on a disk sample,
        then encode every row in ENCODE_CHUNK-row chunks on the device
        (VectorBuild)."""
        with self._lock:
            # a build while IMPORTING ends the import (the serving path
            # streams rows with has_more=True and then asks for the build)
            if self.state is CoreState.IMPORTING and self.count:
                self.state = CoreState.IMPORTED
            if self.state not in (CoreState.IMPORTED, CoreState.BUILT):
                raise DiskAnnError(f"build in state {self.state.value}")
            self.state = CoreState.BUILDING
        try:
            self._build()
            with self._lock:
                self.state = CoreState.BUILT
        except Exception as e:
            with self._lock:
                self.state = CoreState.FAILED
                self.last_error = str(e)
            raise

    def _build(self) -> None:
        n = self.count
        if n < max(self.nlist, self.ksub):
            raise DiskAnnError(
                f"need >= {max(self.nlist, self.ksub)} rows, have {n}"
            )
        dev = self.device
        t0 = time.perf_counter()
        mm = np.memmap(self._data_path(), np.float32, "r",
                       shape=(n, self.dim))
        cap = min(n, MAX_POINTS_PER_CENTROID * self.nlist)
        rng = np.random.default_rng(self.id)
        sel = np.sort(rng.choice(n, cap, replace=False)) if cap < n \
            else np.arange(n)
        sample = torch.from_numpy(np.array(mm[sel])).to(dev)
        t1 = time.perf_counter()
        centroids, _ = train_kmeans(sample, k=self.nlist, iters=10,
                                    seed=self.id)
        _sync(dev)
        t2 = time.perf_counter()
        assign_s = kmeans_assign(sample, centroids)
        resid = sample - centroids[assign_s.long()]
        codebooks = pq_train(resid, m=self.m, ksub=self.ksub, iters=10,
                             seed=self.id)
        _sync(dev)
        t3 = time.perf_counter()
        sample = resid = None
        codes = np.empty((n, self.m), np.uint8)
        assign = np.empty(n, np.int32)
        for i in range(0, n, ENCODE_CHUNK):
            rows = torch.from_numpy(np.array(mm[i:i + ENCODE_CHUNK])).to(dev)
            a = kmeans_assign(rows, centroids)
            c = _encode(rows - centroids[a.long()], codebooks)
            codes[i:i + ENCODE_CHUNK] = c.cpu().numpy()
            assign[i:i + ENCODE_CHUNK] = a.cpu().numpy()
        t4 = time.perf_counter()
        np.savez(self._index_path(), centroids=centroids.cpu().numpy(),
                 codebooks=codebooks.cpu().numpy(), codes=codes,
                 assign=assign)
        with open(self._meta_path(), "w") as f:
            json.dump({"count": n, "dim": self.dim, "m": self.m,
                       "nlist": self.nlist,
                       "metric": self.metric.value}, f)
        self.build_timings = {
            "sample_s": t1 - t0, "coarse_fit_s": t2 - t1,
            "pq_fit_s": t3 - t2, "encode_s": t4 - t3,
            "save_s": time.perf_counter() - t4}

    # -- load ----------------------------------------------------------------
    def load(self) -> None:
        """Map the disk file; the codes, centroids and codebooks go on the
        device, the rows stay on disk (VectorLoad)."""
        with self._lock:
            if self.state not in (CoreState.BUILT, CoreState.LOADED,
                                  CoreState.UNINIT, CoreState.IMPORTED):
                raise DiskAnnError(f"load in state {self.state.value}")
            if not os.path.exists(self._index_path()):
                raise DiskAnnError("not built")
            self.state = CoreState.LOADING
        try:
            with open(self._meta_path()) as f:
                meta = json.load(f)
            if meta["dim"] != self.dim or meta["m"] != self.m:
                raise DiskAnnError("index file parameter mismatch")
            n = meta["count"]
            data = np.load(self._index_path())
            dev = self.device
            self._mmap = np.memmap(self._data_path(), np.float32, "r",
                                   shape=(n, self.dim))
            self._ids = np.fromfile(self._ids_path(), np.int64)[:n]
            self.count = n
            self.centroids = torch.from_numpy(
                np.asarray(data["centroids"], np.float32)).to(dev)
            self._c_sqnorm = squared_norms(self.centroids)
            self.codebooks = torch.from_numpy(
                np.asarray(data["codebooks"], np.float32)).to(dev)
            self._codes = torch.from_numpy(
                np.asarray(data["codes"], np.uint8)).to(dev)
            self._layout = MutableIvfView.build(
                np.asarray(data["assign"], np.int32), np.ones(n, bool),
                self.nlist, n, dev)
            self._code_buckets = self._layout.gather_rows(self._codes)
            with self._lock:
                self.state = CoreState.LOADED
        except Exception as e:
            with self._lock:
                self.state = CoreState.FAILED
                self.last_error = str(e)
            raise

    def try_load(self) -> bool:
        """Load if an index file exists (VectorTryLoad); False otherwise."""
        if not os.path.exists(self._index_path()):
            return False
        self.load()
        return True

    # -- search --------------------------------------------------------------
    def search(self, queries: np.ndarray, topk: int,
               nprobe: Optional[int] = None,
               rerank_factor: Optional[int] = None,
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """ADC prune on the device, then the exact rerank of rows read from
        disk. Returns per query (ids [k], distances [k]): L2 ascending,
        IP/COSINE descending."""
        with self._lock:
            if self.state is not CoreState.LOADED:
                raise DiskAnnError(f"search in state {self.state.value}")
            # the state a concurrent close()/reset() clears, kept alive in
            # locals for this search
            mmap = self._mmap
            ids_arr = self._ids
            lay = self._layout
            code_buckets = self._code_buckets
            centroids = self.centroids
            c_sqnorm = self._c_sqnorm
            codebooks = self.codebooks
            count = self.count
        t0 = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric is Metric.COSINE:
            queries = np_normalize(queries)
        b = queries.shape[0]
        k = int(topk)
        kprime = min(count, k * (rerank_factor or RERANK_FACTOR))
        nprobe = min(nprobe or self.parameter.default_nprobe, self.nlist)
        dev = self.device
        qpad = upload(_pad_batch(queries), dev)
        probes = coarse_probes(qpad, centroids, c_sqnorm, nprobe)
        vprobes, coarse_pos = expand_probes_ranked(
            probes, lay.probe_table, nprobe, lay.max_spill)
        vprobes[b:] = -1           # padded query rows scan nothing
        lut_bytes = qpad.shape[0] * nprobe * self.m * self.ksub * 4
        _ivfpq_scan_kernel.calls += 1
        _, rows = _ivfpq_scan_kernel(
            code_buckets, lay.bucket_valid, lay.bucket_slot,
            lay.bucket_coarse, probes, vprobes, coarse_pos, qpad,
            centroids, codebooks, kprime,
            precompute_lut=lut_bytes <= LUT_BUDGET_BYTES)
        rows = rows[:b].cpu().numpy().astype(np.int64)   # [b, k'] rows
        t1 = time.perf_counter()
        safe = np.where(rows >= 0, rows, 0)
        cand = _bounded_gather(mmap, safe.reshape(-1)).reshape(
            b, kprime, self.dim)
        t2 = time.perf_counter()
        dc = upload(cand, dev)
        qd = qpad[:b]
        if self.metric is Metric.L2:
            exact = ((qd[:, None, :] - dc) ** 2).sum(-1)
            key = exact
        else:
            exact = torch.einsum("bd,bkd->bk", qd, dc)
            key = -exact
        valid = upload(rows >= 0, dev)
        key = torch.where(valid, key, torch.full_like(key, torch.inf))
        order = torch.argsort(key, dim=1, stable=True)[:, :k]
        exact_h = torch.gather(exact, 1, order).cpu().numpy()
        order_h = order.cpu().numpy()
        t3 = time.perf_counter()
        out = []
        for qi in range(b):
            r = rows[qi][order_h[qi]]
            keep = r >= 0
            out.append((ids_arr[r[keep]], exact_h[qi][keep]))
        self.search_timings = {"adc_ms": (t1 - t0) * 1e3,
                               "gather_ms": (t2 - t1) * 1e3,
                               "rerank_ms": (t3 - t2) * 1e3}
        return out

    # -- lifecycle -----------------------------------------------------------
    def status(self) -> CoreState:
        with self._lock:
            return self.state

    def close(self) -> None:
        """Drop the device and mapped state; the files stay (VectorClose)."""
        with self._lock:
            self._mmap = None
            self._codes = None
            self._code_buckets = None
            self._layout = None
            self.centroids = None
            self._c_sqnorm = None
            self.codebooks = None
            if self.state in (CoreState.LOADED, CoreState.LOADING):
                self.state = CoreState.BUILT

    def reset(self, delete_data_file: bool = False) -> None:
        """Back to an importable state (VectorReset)."""
        self.close()
        with self._lock:
            if delete_data_file:
                for p in (self._data_path(), self._ids_path(),
                          self._index_path(), self._meta_path()):
                    if os.path.exists(p):
                        os.remove(p)
                self.count = 0
                self._id_to_row.clear()
                self.state = CoreState.UNINIT
            else:
                self.state = (
                    CoreState.IMPORTED if self.count else CoreState.UNINIT
                )

    def destroy(self) -> None:
        self.close()
        with self._lock:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.count = 0
            self._id_to_row.clear()
            self.state = CoreState.UNINIT
