#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: 1M x 768, nlist 1024
    python3 chip_smoke.py --n 131072 --nlist 128   # a quicker, smaller run
    python3 chip_smoke.py --hnsw-n 131072          # a smaller HNSW build

Builds the port's eight CUDA kernel libraries from ``dingo_tpu_torch/csrc``
(one nvcc per source, in parallel), fourteen kernels and arms in all:

  B1 fused_topk         csrc/fused_topk.cu         FLAT scan, pruning off
                                                   or d not in 128-column
                                                   blocks (f32, bf16 rows;
                                                   split-precision tensor
                                                   cores)
  B2 ivf_list_topk      csrc/ivf_topk.cu           IVF scan, likewise (f32,
                                                   bf16 rows; bucket-major
                                                   items, tensor cores)
  B3 ivf_pruned_topk    csrc/ivf_pruned_topk.cu    IVF scan, pruned, the
                                                   default (f32, bf16, sq8)
  B4 pruned_fused_topk  csrc/pruned_fused_topk.cu  FLAT scan over the blocked
                                                   mirror, the default (f32,
                                                   bf16, sq8)
  B5 ivf_pq_adc_topk    csrc/ivf_pq_adc_topk.cu    IVF_PQ Quick-ADC scan, one
                                                   CTA per (query, coarse rank)
     ivfpq_adc_lut        csrc/ivfpq_adc_lut.cu      IVF_PQ's residual tables
                                                   (an XLA program there)
  G  candidate_scores   csrc/beam_scores.cu        HNSW walk and build: a
                                                   score per live candidate
                                                   slot (an XLA program
                                                   there); per-pair arm
     candidate_scores_block csrc/beam_block.cu     its block arm, the build
                                                   walk's rounds: each
                                                   distinct row of a
                                                   64-query block read
                                                   once, tensor cores

then serves an IVF_FLAT region the way the Index role does: raft-ordered
adds through VectorIndexWrapper, a brute-force FLAT search while the
region is untrained (B4 by default; B1 through a FLAT store built without
the blocked mirror), training, IVF searches at several nprobe (B3 by
default; B2 with ivf_prune_scan off), pipelined searches on both routes,
an in-place upsert and delete on the pruned routes. Then an IVF_PQ region
at BASELINE.json config 3's widths (m 96, nbits 8) over the same rows:
exact while untrained, trained, B5 at rerank factor 6 (k 10 x 6 = 60, under
B5's ceiling of 64) against the XLA arm, the two crossovers that send a
search to the XLA arm (factor 8; a [b, nprobe, m, 256] table over 256 MiB
at nprobe 64), pipelined searches on both arms, in-place writes, and a
host_vectors index carried across with the same codes. Then the bf16 and
sq8 precision tiers on the same rows (the fp32 FLAT and IVF_PQ state
released first): per tier a FLAT index searched untrained (B4's arm of the
tier; B1-bf16 or sq8's plain arm with pruning off) and an IVF_FLAT region
at nprobe 16/32/64 (B3's arm; B2-bf16 or sq8's plain arm with pruning
off), recall against the JAX package's gates, a rerank cache (over the
first 262,144 rows, RERANK_N, a depth cut), in-place writes on every
route, device bytes beside fp32's, pipelined timing with fp32 and both
tiers taking turns, a profile of the
sq8 route, and five kernel-vs-plain cases per arm. Last, the default
route at GIST1M's width (262,144 x 960 f32 from the same recipe, GIST1M's
1,000,000 rows cut for the smoke's time, nlist 1024, every flag at its
default): 960 does not tile into 128-column
blocks, so a FLAT index serves on B1 and an IVF_FLAT region on B2 (B3 and
B4 must not launch), with recall@10, each kernel against its plain
version, both timed in turns and pipelined ms/batch with a profile.
Before it, VectorIndex.range_search on the fp32 IVF_FLAT region (a radius
per query midway between two rows' f64 distances near its 300th
neighbour; the hits == the exact set). After it, the binary family on the
same rows binarized by sign (768 bits, 96 packed bytes a row): a
BINARY_FLAT index (the exact int8 +/-1 product's ms and temporary bytes,
hamming top-10 == a popcount reference on the card, ids modulo ties,
pipelined ms, device bytes against the packed size, range search == the
exact set and the 1,024 cap), a BINARY_IVF_FLAT index at nlist 1024
(train, recall@10 modulo ties at nprobe 16/32/64 with the gate >= 0.95,
full probe == FLAT, pipelined ms), 8,192 upserts and 4,096 deletes on
both, and a binary region on the first 262,144 rows through Storage and
IndexService(node) (the brute force untrained, the index after the
manager's rebuild, a filter and a radius request, the pipelined arm's
staged misses); no B1-B5 launch in the phase. Then the diskann role's
core at config 3's widths (m 96) on the first 262,144 of the rows (cut for the smoke's time) under
tempfile.gettempdir(): push_data, the build split
into coarse fit / PQ fit / encode, the load's device bytes, searches at
nprobe 32 with rerank factor 32 (ms split into ADC scan, disk gather and
rerank; recall@10 >= 0.95; distances == f64), a restart, upserts in place
and the item manager's asynchronous rebuild, then close, reset and
destroy. The
tensor-core instructions of B1's and B2's arms (cuobjdump) are counted
and checked (TF32 in the f32 arms, bf16 in the bf16 arms). Every kernel is
held against its plain PyTorch version on the card (B3/B4 for L2 and IP,
the in-bucket refresh on and off; B3 also on a filter and on fewer valid
rows than k; B5 with spill buckets, a rank with three or more of them,
a filter, fewer valid rows than k, k 1, 12 and 64, a query whose probes
are all padded and coarse_pos rows out of order; the table kernel against
the torch composite at nprobe 16 and 32), and the launches each serving
path made are counted. The table kernel is timed against the torch
composite in turns, and the B5 route's profile must name both kernels. B3's staged row
slices (``count_staged``) are held against the per-(query, rank) total
(at most half) and printed beside the distinct-bucket total; B3 is timed
with and without its rank-0 seed launch. A filtered search, and an IP
and a COSINE region (a quarter of the rows), run on the B3 and B2 routes
through the wrapper with the same ids modulo ties, and a search's
dispatch runs under ``torch.cuda.set_sync_debug_mode("error")`` (no host
sync before its resolve). After the kernel timings, the coalesced serving
phase drives the fp32 IVF_FLAT region (B3), the FLAT store (B4) and the
IVF_PQ region (B5, factor 6) through the port's entry point for many small
requests (``server/services.IndexService``: a SearchCoalescer bound to
the wrappers' search and search_async(staged=...)) with the JAX package's
pipeline_sweep traffic: 4-row requests over 4 keys, max_batch 64, a 2 ms
window, 16 in flight a round, serial against pipelined arms (IVF_FLAT at
depths 1, 2 and 4 over 3 rounds of turns); it prints rows/s, request p50
and p99, stage fractions, the depth-2 arm's device busy share and a
per-thread host sample profile, and checks byte-identical probe replies
across arms, probe ids == a direct search modulo ties, no staged miss, no
new kernel shape after the warmed ladder, an expired budget launching
nothing, the span tree and its Chrome export, and 8,192 upserts and 4,096
deletes under load (the service now bound to a MonoStoreEngine node whose
regions own the wrappers, so every batch goes through Storage and the
region's VectorReader). Last, the replicated region phase at full width
and depth, every earlier phase's device state released: three StoreNodes
on LocalTransport (a dingo-store region's three replicas) on the one card,
bound to one in-process CoordinatorControl, which creates the IVF_FLAT
region (nlist 1024, every flag at its default) and delivers it to the
stores by heartbeats; the 1M rows, each with a table row (cat BIGINT,
price DOUBLE, tag VARCHAR, encoded before the ingest's clock starts),
through the leader's Storage.vector_add in 4,096-row raft proposals
(acknowledged rows/s, the share of time in apply); untrained searches on
two replicas (the reader's brute-force scan, B4; ids == numpy exact
modulo ties, replicas agree); VectorIndexManager.rebuild on each replica
(engine scan / index ingest / train); B3 at nprobe 32 (recall@10 >= 0.95,
the replicas' ids equal, region path against wrapper-direct ms);
TABLE-filtered searches (table_phase: a CoprocessorV2 over the table CF,
predicates "cat < 5" and "cat < 50 and price >= 0.2"; the pre variant's
candidates scanned by B3 under their bucket mask, its prefilter split
into the engine scan and the coprocessor's rows/s, recall@10 >= 0.95
against exact top-10 over the filtered rows; the post variant at topk 6,
whose over-fetch of 60 runs on B3, and 10, whose 100 takes the k > 64
arm, each reply the filtered prefix of the unfiltered search on every
replica; B3's device ms under each mask beside the unfiltered launch; a
row deleted through raft leaves a follower's candidates, then comes back);
IndexService(node) on the leader under the pipeline_sweep traffic while
8,192 upserts and 4,096 deletes are proposed (each visible on the leader
when acknowledged and on a follower once applied; no dispatch falls back
to the reader's sync path); one region search's B3 launch against its
plain version; the reader's dispatch under the sync-debug mode; device
bytes per replica and peak host RSS; then the observability phase on the
same region (obs_phase: the three replicas' heartbeat digests equal, one
replica's full integrity scrub with the search p99 beside it, a flipped
byte in its device rows named by the scrub, flagged by the coordinator and
rebuilt by the recovery plane; live recall intervals at nprobe 8 and 32
against numpy, shadow ids, shadow and served ms, the sq8 mirror arm; the
SLO tuner's walk with its events and explain; skewed against uniform
heat; the cost model against measured run times; the HBM ledger; a flight
bundle of a forced slow query; the shed ladder under overload; a
Prometheus scrape; the ledger runs at the JAX package's defaults there and
in the ingest, and is off in the other phases); then the serving-edge
cache on the same region (edge_cache_phase: IndexService(node) at nprobe
32 under 4,096 four-row requests drawn Zipf(1.1) from 512 queries, cache
off then on, rows/s, p50/p99, hit rate, B3 launches and kernel rows; hits
against a fresh dispatch, a 4,096-row write's invalidation and refill,
eight threads' identical rows deduped to one kernel batch, the
heartbeat's cache_* fields); then the memory-tier ladder on the leader's
replica (ladder_phase: hbm -> hbm_sq8 through a coordinator TIER_DEMOTE
and the memory_tier tick, -> host_sq8 -> mmap_sq8, back up through a
tick under search traffic and two promotions; per rung the transition's
seconds, device and host bytes, memory_allocated following the serving
index's device bytes (each replaced index freed), ms a batch, recall@10
>= 0.95 and the heartbeat's serving_tier; B3-sq8 against its plain version, device bytes
0 and no B3/B4 launch on the host rungs, the mmap file removed, ids
after the round trip against before and the other replicas, six tier
events and 0 orphans), and the same walk on a 65,536 x 768 FLAT region
of a one-replica store (B4-sq8 against its plain version, one digest
refusal, the staged put_codes pour); then the cluster phase on
the same region (one split_check tick at the default 1,000,000 keys proposes the
median id, heartbeats deliver SPLIT, the child is served through the
parent's index, 2,048 upserts and 1,024 deletes proposed on each side
while split, HOLD_VECTOR_INDEX on each replica in turn, coord.merge_region
and the sibling-merged search, finish_merge_index on each replica in
turn, a leader transfer; recall@10 >= 0.95 against exact top-10 on the
card at every stage, equal ids on every replica, device peak); then the
leader's node stops and the survivors hold every acknowledged write.
Then the native LSM engine (lsm_phase: LsmRawEngine over
csrc/host/lsm.cc, built with g++ at first use into build/dingo_tpu_torch)
under a one-replica StoreNode in a temporary directory, an IVF_FLAT region
of the first 65,536 rows (LSM_N, a depth cut for the smoke's time):
ingest rows/s, an untrained search on B4, train and search on B3, the
engine closed and reopened, the node's recover rebuilding the index from
the engine scan (seconds, the scan's share), the same ids; flush,
compaction, checkpoint and restore, SST counts and bytes on disk.
Then HNSW at BASELINE.json config 4's widths (768 dims, M 32,
efConstruction 200, ef 200, every flag at its default) on 262,144 rows of
its own from the same recipe (``--hnsw-n`` sets the depth; config 4's 1M
does not fit the smoke's time beside the cluster phase): the device bulk build
(rows/s split into the walk, the occlusion selection and the reprune;
reverse_dropped), recall@10 >= 0.95 against exact top-10 computed on the
card, pipelined ms per 64-query batch, the walk's hops / visited slots /
occupancy, kernel G's launches and live-candidate share, device bytes,
and a dispatch under the sync-debug mode; kernel G by call site (the
build's walk seed and rounds, selection and reprune; the search's seed
and rounds): device time, launches and live share in windows of build
batches (the designs the shapes take) and in a search with each of its
two designs, its share of the build's phases and of a search, and on
each site's busiest launch both designs against the plain version, bit
for bit on a second launch, timed in turns, beside each design's bound;
G's launches on the main path are read before any search with a swapped
design; the search pipelined with each design in turns, 6 pairs; then
a 20,000-row HNSW index whose host graph
takes the writes (its one-thread native inserts run beside the HNSW
phase; device walk against host walk at equal ef, upserts and deletes,
filter pushdown, save/load). Each phase that serves through the wrappers
and the reader checks that the recovery ladder never fired. Then the
device recovery ladder on
a 65,536-row FLAT region (a retried fault, a degraded region served by the
host path and absorbing writes, re-materialization back onto B4, a real
CUDA out-of-memory error classified). Last, host paths
(txn_doc_phase): a seeded script of Percolator transactions on a KV
region of a one-replica node (commits, write conflicts, a lock seen by a
reader, check_txn_status and resolve_lock after a lock's TTL,
batch_rollback, gc below a safe point), its snapshot reads against a dict
model; and a DOCUMENT region on three raft replicas with 10,000 typed
documents, BM25 and range queries, a delete, and every node restarted
with its index rebuilt, answering the same. Then, last, the chaos harness
(chaos_phase: dingo_tpu_torch/tools/chaos.py's six scenarios through
run_scenarios, each on an IVF_FLAT region of LSM_N x d from bench.py's
recipe loaded in 4,096-row proposals and trained on every replica before
its fault; every gate checked, the 15 s recovery bound and the 0.9
goodput floor among them, and B3 launching again after the OOM storm's
re-materialization; then the crash-recovery matrix, FLAT, IVF_FLAT and
HNSW each fp32 and sq8, at CHAOS_MATRIX_N x d, HNSW at CHAOS_MATRIX_HNSW_N
x d). Timings are medians over ROUNDS
rounds in which the routes
(pipelined searches) or the five kernels take turns, so two readings that
are compared come from the same card and minute. Data is BASELINE.json
config 2 made with bench.py's recipe (seed 7, n // 1000 Gaussian centers +
0.35 noise, queries = stored rows + 0.05 noise).

The last line is ``{"ok": true, "device": {...}}``. A failed check is
printed and the run goes on through every phase; it then exits nonzero
after the kernels line, without the last line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): f32 without tensor cores,
#: dense bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
#: B1 and B2 multiply in split precision on the tensor cores: three
#: products per dot (3xTF32 for f32 rows, three bf16 query parts for bf16)
SPLIT_PASSES = 3
#: the default-route phase at GIST1M's width (ann-benchmarks'
#: gist-960-euclidean: 1,000,000 x 960): 960 does not tile into the pruned
#: route's 128-column blocks, so FLAT serves on B1 and IVF_FLAT on B2
GIST_D = 960
#: rows of the d 960 phase: GIST1M's 1,000,000 cut to 500,000 for the
#: smoke's 1,200 s limit once the ladder and edge-cache phases came in,
#: then to 262,144 once the TABLE, LSM and transaction/document phases
#: came in, and to 65,536 once the chaos phase came in (PERF.md section 4)
GIST_N = 65_536
#: kernel-vs-plain tolerance: f32 sums land in a different order
RTOL, ATOL = 1e-4, 1e-3
#: the residual tables (entries ~1-100) against the torch composite: f32
#: sums over dsub in another order (cuBLAS's product, torch's reductions)
LUT_RTOL, LUT_ATOL = 1e-5, 1e-4
#: two id lists agree modulo ties when their exact (f64) distances, sorted,
#: agree within the f32 rounding of a distance computed as
#: ||q||^2 - 2 q.x + ||x||^2 at these magnitudes
TIE_RTOL = 1e-4
#: rounds of each timing, the routes or kernels compared alternating in
#: each round; the median and the spread are reported
ROUNDS = 5
#: IVF_PQ subspaces: BASELINE.json config 3 (768 dims -> 8 per subspace)
PQ_M = 96
#: the precision tiers of the tier phase
TIERS = ("bf16", "sq8")
#: the tiers' cached rerank runs on the first RERANK_N rows (a depth cut for
#: the smoke's clock: its two 1M-row indexes a tier took 14-21 s)
RERANK_N = 262_144
#: each tier arm's name on the kernels line, its source and the TPU kernel
#: (and dtype arm) it replaces
ARM_NAMES = {"B1-bf16": "fused_topk_bf16", "B2-bf16": "ivf_list_topk_bf16",
             "B3-bf16": "ivf_pruned_topk_bf16",
             "B3-sq8": "ivf_pruned_topk_sq8",
             "B4-bf16": "pruned_fused_topk_bf16",
             "B4-sq8": "pruned_fused_topk_sq8"}
ARM_SOURCES = {"B1": "fused_topk.cu", "B2": "ivf_topk.cu",
               "B3": "ivf_pruned_topk.cu", "B4": "pruned_fused_topk.cu"}
ARM_REPLACES = {"B1-bf16": "dingo_tpu/ops/pallas_topk.py:67",
                "B2-bf16": "dingo_tpu/ops/pallas_ivf.py:65",
                "B3-bf16": "dingo_tpu/ops/pallas_ivf.py:305",
                "B3-sq8": "dingo_tpu/ops/pallas_ivf.py:296",
                "B4-bf16": "dingo_tpu/ops/pallas_topk.py:244",
                "B4-sq8": "dingo_tpu/ops/pallas_topk.py:235"}


class SmokeFailure(Exception):
    pass


#: checks that failed: the run goes on through every phase and fails after
#: the kernels line, without the last line
FAILED: list = []


def check(cond: bool, what: str) -> None:
    if not cond:
        FAILED.append(what)
        print(f"FAIL {what}", flush=True)
        return
    print(f"PASS {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(n: int, d: int, batch: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    ncl = max(64, n // 1000)
    centers = rng.standard_normal((ncl, d), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)]
    x += 0.35 * rng.standard_normal((n, d), dtype=np.float32)
    queries = x[rng.choice(n, batch, replace=False)] + 0.05 * (
        rng.standard_normal((batch, d), dtype=np.float32)
    )
    extra = centers[rng.integers(0, ncl, 8192)] + 0.35 * (
        rng.standard_normal((8192, d), dtype=np.float32)
    )
    return x, queries.astype(np.float32), extra.astype(np.float32)


def exact_topk(x: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    xsq = np.einsum("nd,nd->n", x, x)
    out = np.empty((len(q), k), np.int64)
    for i in range(0, len(q), 16):
        qs = q[i:i + 16]
        dist = (qs * qs).sum(1)[:, None] - 2.0 * (qs @ x.T) + xsq[None, :]
        part = np.argpartition(dist, k, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(dist, part, 1), axis=1)
        out[i:i + 16] = np.take_along_axis(part, order, 1)
    return out


def exact_dists(x, q, ids, metric: str = "L2") -> np.ndarray:
    """Exact (f64) smaller-is-better scores of rows `ids` for query q: the
    squared L2 distance, or the negated inner product (IP) or cosine."""
    rows = x[ids].astype(np.float64)
    q = q.astype(np.float64)
    if metric == "L2":
        return ((rows - q[None, :]) ** 2).sum(1)
    if metric == "COSINE":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        q = q / np.linalg.norm(q)
    return -(rows @ q)


def same_modulo_ties(x, queries, got, want, metric: str = "L2") -> bool:
    """Each query's id list is a valid exact top-k: sorted f64 scores of
    `got` and `want` agree within TIE_RTOL."""
    for qi in range(len(queries)):
        g = np.asarray(got[qi], np.int64)
        w = np.asarray(want[qi], np.int64)
        if len(g) != len(w):
            return False
        if set(g.tolist()) == set(w.tolist()):
            continue
        dg = np.sort(exact_dists(x, queries[qi], g, metric))
        dw = np.sort(exact_dists(x, queries[qi], w, metric))
        if not np.allclose(dg, dw, rtol=TIE_RTOL, atol=0.0):
            return False
    return True


def kernel_parity(kv, ki, pv, pi) -> tuple:
    """Kernel vs plain on the same inputs: scores (both sorted descending)
    within RTOL/ATOL, and every slot the two disagree on is tied with the
    plain k-th score. Returns (ok, max_abs_err over finite scores)."""
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    fin = np.isfinite(pv)
    ok = bool(np.array_equal(fin, np.isfinite(kv)))
    err = float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0
    ok = ok and bool(np.allclose(kv[fin], pv[fin], rtol=RTOL, atol=ATOL))
    for r in range(len(kv)):
        extra = set(ki[r].tolist()) - set(pi[r].tolist())
        kth = pv[r][fin[r]].min() if fin[r].any() else -np.inf
        for s in extra:
            sv = kv[r][list(ki[r]).index(s)]
            if not np.isclose(sv, kth, rtol=RTOL, atol=ATOL):
                ok = False
    return ok, err


@contextlib.contextmanager
def first_launch(module, name: str):
    """Swap the kernel wrapper `module.name` for a spy that keeps a copy
    of its first call's arguments and results, [(args, kwargs, outputs)],
    for a check against the plain version. The spy shares the wrapper's
    attribute dict: the wrapper reads its flags and counts its launches
    through the module's name, which is the spy's while it is in place."""
    import torch

    orig = getattr(module, name)
    captured: list = []

    def spy(*a, **kw):
        res = orig(*a, **kw)
        if not captured:
            captured.append(([v.clone() if torch.is_tensor(v) else v
                              for v in a], dict(kw), [o.clone() for o in res]))
        return res

    spy.__dict__ = orig.__dict__
    setattr(module, name, spy)
    try:
        yield captured
    finally:
        setattr(module, name, orig)


def time_ms(fn, torch, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_spread(xs) -> tuple:
    """(median, min, max) of a list of readings."""
    return float(np.median(xs)), float(min(xs)), float(max(xs))


def spread_text(xs) -> str:
    med, lo, hi = median_spread(xs)
    return f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, {len(xs)} rounds)"


def pipelined_window(wrapper, queries, k, nprobe, reps=20):
    """One window of `reps` search_async dispatches resolved after the
    last one (one host sync per reply), as a callable. nprobe None: a
    FLAT index (no probes)."""
    kw = {} if nprobe is None else {"nprobe": nprobe}

    def run_window():
        thunks = [wrapper.search_async(queries, k, **kw)
                  for _ in range(reps)]
        for th in thunks:
            th()
    return run_window


def pipelined_ms(wrapper, queries, k, nprobe, reps=20) -> float:
    """Host ms per batch over one pipelined window, after warm-up."""
    import torch

    kw = {} if nprobe is None else {"nprobe": nprobe}
    for _ in range(3):
        wrapper.search_async(queries, k, **kw)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipelined_window(wrapper, queries, k, nprobe, reps)()
    return (time.perf_counter() - t0) * 1e3 / reps


def stats_ok(ks, ps) -> bool:
    """Pruned kernel vs plain stats [b, 4]: lanes 1 and 3 equal; 0 <=
    lane0 <= lane1 and lane2 <= lane3 (how much a kernel prunes depends on
    the order it walks the candidates)."""
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    return bool(np.array_equal(ks[:, 1], ps[:, 1])
                and np.array_equal(ks[:, 3], ps[:, 3])
                and (ks[:, 0] >= 0).all() and (ks[:, 0] <= ks[:, 1]).all()
                and (ks[:, 2] >= 0).all() and (ks[:, 2] <= ks[:, 3]).all())


def pruned_fraction(stats) -> float:
    """1 - scanned pairs / total pairs over a [b, 4] stats block."""
    s = stats.double().sum(0).cpu().numpy()
    return float(1.0 - s[0] / s[1]) if s[1] > 0 else 0.0


def set_flags(flags, **kw) -> dict:
    saved = {f: flags.get(f) for f in kw}
    for f, v in kw.items():
        flags.set(f, v)
    return saved


def bound_of(nbytes: float, ops: float, peak: float = PEAK_F32_FLOPS):
    """(bound ms, "bytes" or "operations") on the published peaks (`peak`:
    the operation rate of the operands' type)."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / peak
    return max(t_b, t_o) * 1e3, ("operations" if t_o > t_b else "bytes")


def timed_calls(module, name, spent: list):
    """Swap module.name for a wrapper that adds its synchronized host time
    to spent; returns the original (restore it with setattr)."""
    import torch

    orig = getattr(module, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    return orig


def sass_mma(cuda_build, lib_name: str, kernel: str):
    """Tensor-core instructions in each arm of a scan kernel of a built
    library (cuobjdump -sass; a failure to read it raises): {(arm,
    opcode): count}, and whether any TF32 operation appears."""
    import os

    lib = cuda_build.build([lib_name])[lib_name]
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True)
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and kernel in fn and "MMA" in line:
            arm = ("f32" if "kernelIf" in fn else
                   "sq8" if "kernelIh" in fn else "bf16")
            op = next(t for t in line.split() if "MMA" in t)
            counts[(arm, op)] = counts.get((arm, op), 0) + 1
    return counts, "TF32" in out.stdout


def b4_tiles_text(b4, stats) -> str:
    """B4's scan counters after its last launch (count_tiles on): (tile,
    block) steps computed, those pair by pair (the f32 arm), and the share
    of the valid rows' block slices it read (rows computed / (valid rows
    x blocks))."""
    steps, sparse, rows = b4.tiles.tolist()
    s = stats.double().sum(0).cpu().numpy()
    nq = max(1, int((stats[:, 3] > 0).sum()))
    pairs = s[1] / nq                     # valid rows x blocks, per query
    return (f"; tile steps {steps}, sparse {sparse}, row slices read "
            f"{rows / pairs if pairs else 0.0:.4f}")


def b3_staged_report(name, staged, stats, vprobes, cap, nblk,
                     scanned) -> None:
    """B3's staged row slices (count_staged) beside the distinct-bucket
    total (each probed bucket's rows once per block) and the per-(query,
    rank) total (lane 0 summed: what a walk per pair reads). Checks that a
    bucket is staged once per item group (at most half the per-pair
    total) and that the kernel's scanned fraction (lane 0 / lane 1) is
    within 0.10 of the plain version's; scanned = (kernel, plain)."""
    vp = vprobes.cpu().numpy()
    distinct = len(np.unique(vp[vp >= 0])) * cap * nblk
    lane0 = int(stats[:, 0].double().sum())
    print(f"{name} L2 row slices staged {staged}, distinct-bucket total "
          f"{distinct} (buckets x cap x blocks), per-(query, rank) total "
          f"{lane0} (lane 0 summed): staged / lane 0 "
          f"{staged / max(1, lane0):.4f}, staged / distinct "
          f"{staged / max(1, distinct):.4f}", flush=True)
    check(staged <= 0.5 * lane0, f"{name}: staged row slices <= half the "
          "per-(query, rank) total")
    check(abs(scanned[0] - scanned[1]) <= 0.10,
          f"{name}: scanned fraction within 0.10 of the plain version's "
          f"({scanned[0]:.4f} / {scanned[1]:.4f})")


def b4_ratio_text(reads, new, old) -> str:
    """Median (and range) of the per-round ratios reads[new] / reads[old]."""
    r = np.divide(reads[new], reads[old])
    return (f"per-round ratio {new} / {old} median {np.median(r):.4f} "
            f"(min {r.min():.4f}, max {r.max():.4f})")


def recall_at(res, gt, k) -> float:
    hits = sum(len(set(r.ids.tolist()) & set(g.tolist()))
               for r, g in zip(res, gt))
    return hits / (len(gt) * k)


def recovery_quiet(phase: str, card: str) -> None:
    """Fail the run if the device recovery ladder fired by the end of a
    measured phase: a retried search or write is slower than the card's,
    and a degraded region answers from numpy on the host, so the phase's
    numbers would not be the card's."""
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.recovery import RECOVERY

    fired = {key: v for key, v in METRICS.dump().items()
             if key.startswith("fault.oom_recoveries")}
    degraded = sorted(RECOVERY.degraded_regions())
    print(f"[{card}] {phase}: recovery ladder runs {RECOVERY.ladder_runs}, "
          f"fault.oom_recoveries {fired or 0}, degraded regions {degraded}",
          flush=True)
    check(RECOVERY.ladder_runs == 0 and not any(fired.values())
          and not degraded, f"{phase}: the device recovery ladder never "
          "fired (no retry, no degraded region)")


def device_holders(scope: dict, floor: int = 1 << 20) -> dict:
    """{name: bytes} of the CUDA storages each value of `scope` reaches
    (through containers, instance attributes and closures), for the names
    that reach at least `floor` bytes: what keeps an earlier phase's device
    state alive."""
    import torch

    out = {}
    for name, root in scope.items():
        seen, storages, todo = set(), {}, [(root, 0)]
        while todo:
            obj, depth = todo.pop()
            if id(obj) in seen or depth > 8:
                continue
            seen.add(id(obj))
            if torch.is_tensor(obj):
                if obj.is_cuda:
                    st = obj.untyped_storage()
                    storages[st.data_ptr()] = st.nbytes()
                continue
            if isinstance(obj, (str, bytes, int, float, np.ndarray, type,
                                types.ModuleType)):
                continue
            if isinstance(obj, dict):
                kids = list(obj.values())
            elif isinstance(obj, (list, tuple, set, frozenset)):
                kids = list(obj)
            else:
                kids = list(getattr(obj, "__dict__", {}).values())
                for cell in getattr(obj, "__closure__", None) or ():
                    try:
                        kids.append(cell.cell_contents)
                    except ValueError:      # an empty cell
                        pass
                kids.append(getattr(obj, "__self__", None))
            todo += [(c, depth + 1) for c in kids if c is not None]
        if sum(storages.values()) >= floor:
            out[name] = sum(storages.values())
    return out


def device_profile(fn, top: int = 8, was: str = "") -> str:
    """Run fn once under torch.profiler and describe the card's side of it:
    the device time of the `top` heaviest kernels (and copies), and the
    device's busy share (union of their intervals) of the window's wall
    time, profiler overhead included; `was` names the same window's busy
    share in an earlier run (PERF.md), printed beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s_, e_ = e.time_range.start, e.time_range.end
        spans.append((s_, e_))
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (e_ - s_) / 1e3, cnt + 1)
    if not spans:
        return f"wall {wall_ms:.2f} ms; device time not measured (the " \
               "profiler saw no device events)"
    busy, lo, hi = 0.0, None, None
    for s_, e_ in sorted(spans):
        if hi is None or s_ > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s_, e_
        else:
            hi = max(hi, e_)
    busy = (busy + hi - lo) / 1e3
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    rows = "; ".join(f"{name[:60]} {ms:.3f} ms x{cnt}"
                     for name, (ms, cnt) in heavy)
    was = f" (PR 5's run: {was})" if was else ""
    return (f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({busy / wall_ms:.1%}){was}; by device time: {rows}")


def host_profile(fn, top: int = 10) -> str:
    """Run fn once under cProfile and name the host functions with the
    most own time (cProfile's overhead included: read the shares, not the
    milliseconds)."""
    import cProfile
    import os
    import pstats

    import torch

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    heavy = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    rows = "; ".join(
        f"{func} ({os.path.basename(file)}:{line}) {tt * 1e3:.1f} ms "
        f"x{nc}" for (file, line, func), (_, nc, tt, _, _) in heavy)
    return f"wall {wall_ms:.1f} ms; by own time: {rows}"


def metric_regions(x, queries, nlist) -> None:
    """An IP and a COSINE IVF_FLAT region (the first quarter of the rows,
    nlist / 4) served through the wrapper on the pruned route (B3) and on
    the unpruned one (B2): ids equal modulo ties of the region's metric."""
    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.ops import kernel_ivf, kernel_ivf_pruned
    from dingo_tpu_torch.ops.distance import Metric

    b2, b3 = kernel_ivf.ivf_list_topk, kernel_ivf_pruned.ivf_pruned_topk
    n, d, k = x.shape[0] // 4, x.shape[1], 10
    for ri, (metric, tag) in enumerate(((Metric.INNER_PRODUCT, "IP"),
                                        (Metric.COSINE, "COSINE"))):
        t0 = time.perf_counter()
        w = VectorIndexWrapper(30 + ri, IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=d, metric=metric,
            ncentroids=max(16, nlist // 4), default_nprobe=32),
            device=torch.device("cuda"))
        w.set_own(w.build_own())
        idx = w.own_index
        idx.store.reserve(n)
        for lo in range(0, n, 65536):
            w.add(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                  x[lo:min(n, lo + 65536)], lo // 65536 + 1)
        idx.train()
        before = b3.launches
        res3 = w.search(queries, k, nprobe=32)
        ran3 = b3.launches > before
        saved = set_flags(FLAGS, ivf_prune_scan=False)
        try:
            idx.compact()
            before = b2.launches
            res2 = w.search(queries, k, nprobe=32)
            ran2 = b2.launches > before
        finally:
            for f_, v_ in saved.items():
                FLAGS.set(f_, v_)
        torch.cuda.synchronize()
        print(f"{tag} IVF_FLAT region ({n} rows, nlist "
              f"{max(16, nlist // 4)}): B3 and B2 searched at nprobe 32 in "
              f"{time.perf_counter() - t0:.1f} s with ingest and train",
              flush=True)
        check(ran3 and ran2 and same_modulo_ties(
            x, queries, [r.ids for r in res3], [r.ids for r in res2], tag),
              f"{tag} IVF_FLAT region through the wrapper: B3 ids == B2 ids "
              "modulo ties (nprobe 32)")
        del w, idx, res3, res2
        torch.cuda.empty_cache()


def ivf_pq_phase(x, queries, extra, gt, nlist, m, card) -> dict:
    """Serve an IVF_PQ region at BASELINE config 3's widths (d 768, m 96,
    nbits 8, k 10, batch 64) over the smoke's rows: exact while untrained,
    then the B5 route (rerank factor 6) against the XLA arm, the
    crossovers, pipelined timing, in-place writes, and a host_vectors
    index carried across with the same codes. Returns what the kernel
    comparison and the report need."""
    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.index import ivf_pq
    from dingo_tpu_torch.index.base import (
        FilterSpec,
        IndexParameter,
        IndexType,
    )
    from dingo_tpu_torch.index.flat import flat_search_plain
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.ivf_flat import coarse_probes
    from dingo_tpu_torch.index.ivf_layout import (
        MutableIvfView,
        expand_probes_ranked,
    )
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.ops import kernel_pq
    from dingo_tpu_torch.ops.distance import Metric

    b5 = kernel_pq.ivf_pq_adc_topk
    lutk = kernel_pq.ivfpq_adc_lut
    xla = ivf_pq._ivfpq_scan_kernel
    n, d = x.shape
    batch, k = len(queries), gt.shape[1]
    dev = torch.device("cuda")
    param = IndexParameter(index_type=IndexType.IVF_PQ, dimension=d,
                           metric=Metric.L2, ncentroids=nlist, nsubvector=m,
                           default_nprobe=32)
    wrapper = VectorIndexWrapper(11, param, device=dev)
    wrapper.set_own(wrapper.build_own())
    index = wrapper.own_index
    index.store.reserve(n)
    t0 = time.perf_counter()
    log_id = 0
    for lo in range(0, n, 65536):
        log_id += 1
        wrapper.add(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                    x[lo:lo + 65536], log_id)
    torch.cuda.synchronize()
    print(f"IVF_PQ ingest {n} rows in {log_id} raft adds: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(index.get_count() == n, f"IVF_PQ wrapper holds {n} rows")

    # -- untrained: the hybrid contract, an exact whole-store scan ---------
    before = flat_search_plain.calls
    res = wrapper.search(queries, k)
    check(flat_search_plain.calls == before + 1
          and same_modulo_ties(x, queries, [r.ids for r in res], gt),
          "untrained IVF_PQ search is exact (ids == numpy top-10 modulo "
          "ties)")

    # -- train: coarse fit, m PQ fits, assign + encode of every row ---------
    coarse_s, pq_s = [], []
    orig_km = timed_calls(ivf_pq, "train_kmeans", coarse_s)
    orig_pq = timed_calls(ivf_pq, "pq_train", pq_s)
    try:
        t0 = time.perf_counter()
        index.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        ivf_pq.train_kmeans, ivf_pq.pq_train = orig_km, orig_pq
    print(f"IVF_PQ train: {total:.1f} s = coarse fit (nlist {nlist}) "
          f"{sum(coarse_s):.1f} s + {m} PQ fits {sum(pq_s):.1f} s + assign "
          f"and encode of {n} rows {total - sum(coarse_s) - sum(pq_s):.1f} s",
          flush=True)
    t0 = time.perf_counter()
    index.search(queries[:1], k, nprobe=16)          # builds the code view
    torch.cuda.synchronize()
    print(f"IVF_PQ view build: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(index.view_stats())}", flush=True)

    def searches(tag, nprobes, **flags):
        saved = set_flags(FLAGS, **flags)
        try:
            out = {np_: wrapper.search(queries, k, nprobe=np_)
                   for np_ in nprobes}
            torch.cuda.synchronize()
        finally:
            for f_, v_ in saved.items():
                FLAGS.set(f_, v_)
        for np_, r in out.items():
            print(f"IVF_PQ {tag} recall@{k} nprobe={np_}: "
                  f"{recall_at(r, gt, k):.4f}", flush=True)
        return out

    # -- the main path: the B5 route (k 10 x factor 6 = 60 <= 64) ----------
    b5.launches = 0
    lutk.launches = 0
    xla.calls = 0
    res_b5 = searches("B5 route (factor 6)", (16, 32),
                      ivfpq_rerank_factor=6)
    b5_launches, lut_launches, b5_xla_calls = (b5.launches, lutk.launches,
                                               xla.calls)
    print(f"IVF_PQ B5 route: ivf_pq_adc_topk launches {b5_launches}, "
          f"ivfpq_adc_lut launches {lut_launches}, XLA-arm searches "
          f"{b5_xla_calls}", flush=True)
    check(b5_launches > 0 and b5_xla_calls == 0,
          "IVF_PQ searches at factor 6 ran kernel B5, not the XLA arm")
    check(lut_launches == b5_launches,
          "each B5 search built its residual tables with the table kernel")
    check(all(len(r.ids) == k and np.isfinite(r.distances).all()
              for rs in res_b5.values() for r in rs)
          and all(int(r.ids[0]) == int(g[0])
                  for r, g in zip(res_b5[32], gt)),
          "B5 route: k finite results, top-1 == exact top-1 at nprobe 32")

    # -- the same searches on the XLA arm (kernel forced off) ---------------
    before = (b5.launches, xla.calls)
    res_xla = searches("XLA arm (kernel off, factor 6)", (16, 32),
                       ivfpq_rerank_factor=6, use_pallas_ivf_search=False)
    check(b5.launches == before[0] and xla.calls == before[1] + 2,
          "use_pallas_ivf_search=False takes the XLA arm")
    # the exact rerank reads each arm's 60-long ADC shortlist. The arms sum
    # a row's lookups in another order, so where ADC scores near-tie at
    # rank 60 they may keep different rows, and that query's final top-10
    # may differ. The shortlists (the scans without the rerank) must agree
    # modulo ADC ties, and the final lists wherever the shortlists hold
    # the same rows
    kprime = 6 * k
    short = {}
    for arm, flags in (("B5", {}), ("XLA", {"use_pallas_ivf_search": False})):
        saved = set_flags(FLAGS, ivfpq_rerank_factor=1, **flags)
        try:
            short[arm] = {np_: wrapper.search(queries, kprime, nprobe=np_)
                          for np_ in (16, 32)}
        finally:
            for f_, v_ in saved.items():
                FLAGS.set(f_, v_)
    for np_ in (16, 32):
        sa, sb = short["B5"][np_], short["XLA"][np_]
        check(same_tier_results(sa, sb),
              f"B5 route == XLA arm ADC shortlists (k {kprime}, ids modulo "
              f"ADC ties) at nprobe={np_}")
        same_rows = [set(r1.ids.tolist()) == set(r2.ids.tolist())
                     for r1, r2 in zip(sa, sb)]
        print(f"IVF_PQ nprobe={np_}: {len(same_rows) - sum(same_rows)} of "
              f"{batch} shortlists differ by ADC ties at rank {kprime}",
              flush=True)
        a, b_ = res_b5[np_], res_xla[np_]
        check(all(same_modulo_ties(x, queries[i:i + 1], [a[i].ids],
                                   [b_[i].ids])
                  and np.allclose(np.sort(a[i].distances),
                                  np.sort(b_[i].distances), rtol=RTOL,
                                  atol=ATOL)
                  for i in range(batch) if same_rows[i]),
              f"B5 route == XLA arm (ids modulo ties, distances) at "
              f"nprobe={np_} wherever the shortlists hold the same rows")

    # -- the crossovers: kprime 80 > 64, and a table over 256 MiB -----------
    for tag, nprobe_, factor in (("factor 8", 32, 8),
                                 ("nprobe 64 (table 402 MB)", 64, 6)):
        before = (b5.launches, xla.calls)
        searches(f"crossover {tag}", (nprobe_,), ivfpq_rerank_factor=factor)
        check(b5.launches == before[0] and xla.calls == before[1] + 1,
              f"crossover {tag} takes the XLA arm, as in the JAX package")

    # -- pipelined serving cost: the B5 route against the XLA arm ----------
    pipe = {True: [], False: []}
    for r in range(ROUNDS):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            saved = set_flags(FLAGS, ivfpq_rerank_factor=6,
                              use_pallas_ivf_search=on)
            try:
                before = b5.launches
                pipe[on].append(pipelined_ms(wrapper, queries, k, 32))
                if (b5.launches > before) != on:
                    raise SmokeFailure("pipelined IVF_PQ search took the "
                                       "other arm")
            finally:
                for f_, v_ in saved.items():
                    FLAGS.set(f_, v_)
    for on, tag in ((True, "B5 route"), (False, "XLA arm")):
        med = median_spread(pipe[on])[0]
        print(f"[{card}] pipelined IVF_PQ search ({tag}) b={batch} k={k} "
              f"nprobe=32 factor 6 via search_async x20: "
              f"{spread_text(pipe[on])} per batch ({batch / med * 1e3:.0f} "
              f"QPS at the median); readings "
              f"{[round(v, 4) for v in pipe[on]]}", flush=True)
    print(f"[{card}] pipelined IVF_PQ B5 route / XLA arm, median of the "
          f"per-round ratios: "
          f"{np.median(np.divide(pipe[True], pipe[False])):.4f}", flush=True)
    saved = set_flags(FLAGS, ivfpq_rerank_factor=6)
    try:
        prof = device_profile(pipelined_window(wrapper, queries, k, 32),
                              top=10, was="49.9%")
        print(f"[{card}] profile, pipelined IVF_PQ B5 route x20: " + prof,
              flush=True)
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    check("adc_rank_kernel" in prof and "adc_lut_kernel" in prof,
          "the B5 route's profile names B5 and the table kernel")
    saved = set_flags(FLAGS, ivfpq_rerank_factor=6)
    try:
        print(f"[{card}] host profile, pipelined IVF_PQ B5 route x20: "
              + host_profile(pipelined_window(wrapper, queries, k, 32)),
              flush=True)
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)

    # -- in-place writes through B5 ----------------------------------------
    saved = set_flags(FLAGS, ivfpq_rerank_factor=6)
    try:
        new_ids = np.arange(n, n + len(extra), dtype=np.int64)
        rebuilds, view = index.full_rebuilds, index._view
        log_id += 1
        wrapper.add(new_ids, extra, log_id)
        check(index._view is view and not index._view_dirty
              and index.full_rebuilds == rebuilds,
              f"IVF_PQ upsert of {len(extra)} rows applied in place")
        before = b5.launches
        res = wrapper.search(extra[:batch], k, nprobe=32)
        check(b5.launches > before and all(
            len(r.ids) and r.ids[0] == i
            for r, i in zip(res, new_ids[:batch])),
              "upserted rows come back as their own nearest neighbour (B5)")
        log_id += 1
        wrapper.delete(new_ids, log_id)
        res = wrapper.search(extra[:batch], k, nprobe=32)
        check(index.get_count() == n and not any(
            (r.ids >= n).any() for r in res), "deleted rows are gone (B5)")

        # -- host_vectors: the same codes, rerank from host rows --------------
        host = new_index(12, dataclasses.replace(param, host_vectors=True),
                         device=dev)
        t0 = time.perf_counter()
        slots = index.store.slots_of(np.arange(n))
        host.restore_arrays(np.arange(n), x, index.centroids.cpu().numpy(),
                            index.codebooks.cpu().numpy(),
                            index._codes[torch.from_numpy(slots).to(dev)]
                            .cpu().numpy(), index._assign_h[slots])
        print(f"host_vectors IVF_PQ carried across: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        before = b5.launches
        hres = host.search(queries, k, nprobe=32)
        check(b5.launches > before, "host_vectors IVF_PQ search ran B5")
        check(same_modulo_ties(x, queries, [r.ids for r in hres],
                               [r.ids for r in res_b5[32]]),
              "host_vectors IVF_PQ (B5 + host rerank) ids == the device "
              "store's modulo ties")
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    del host

    # -- B5 against its plain version at the path's shapes ------------------
    qpad = torch.from_numpy(queries).to(dev)
    nprobe_t = 32
    kk = k * 6
    view = index._view
    probes = coarse_probes(qpad, index.centroids, index._c_sqnorm, nprobe_t)
    lut_all = ivf_pq._ivfpq_adc_lut(qpad, index.centroids, probes,
                                    index.codebooks)

    def b5_args(v, codes, valid):
        vprobes, coarse_pos = expand_probes_ranked(
            probes, v.probe_table, nprobe_t, v.max_spill)
        return (vprobes, coarse_pos.contiguous(), lut_all, codes, valid,
                v.bucket_slot, kk)

    def shared_tables(a) -> int:
        vp_, cp_ = a[0].cpu().numpy(), a[1].cpu().numpy()
        return int(((cp_[:, 1:] == cp_[:, :-1]) & (vp_[:, 1:] >= 0)).sum())

    # a view of the same rows at half the bucket width: every list longer
    # than cap / 2 spills, so its buckets share their rank's table
    with index.store.device_lock:
        filtered = index._bucket_valid_for_filter(FilterSpec(
            ranges=[(0, n // 2)], exclude_ids=np.arange(0, n, 7)))
        sparse = index._bucket_valid_for_filter(FilterSpec(
            include_ids=np.arange(0, n, n // 20)))
        half = MutableIvfView.build(index._assign_h, index.store.valid_h,
                                    nlist, index.store.capacity, dev,
                                    cap_hint=view.cap_list // 2)
        half_codes = half.gather_rows(index._codes)
        # and at a quarter: a list of ~1,000 rows takes four buckets
        quarter = MutableIvfView.build(
            index._assign_h, index.store.valid_h, nlist,
            index.store.capacity, dev, cap_hint=view.cap_list // 4)
        quarter_codes = quarter.gather_rows(index._codes)
    path_args = b5_args(view, index._code_buckets, view.bucket_valid)
    half_args = b5_args(half, half_codes, half.bucket_valid)
    quarter_args = b5_args(quarter, quarter_codes, quarter.bucket_valid)
    check(shared_tables(half_args) > 0,
          "the half-width view's probes include spill buckets that share "
          "a table")
    qvp, qcp = quarter_args[0].cpu().numpy(), quarter_args[1].cpu().numpy()
    most = max(int(np.bincount(qcp[i][qvp[i] >= 0]).max())
               for i in range(batch))
    check(most >= 3, f"the quarter-width view gives a rank {most} spill "
          "buckets (>= 3)")
    # a query whose probes are all padded, and every query's (vprobe,
    # coarse_pos) pairs in a shuffled order (B5 assumes no order)
    padded_vp = path_args[0].clone()
    padded_vp[0] = -1
    perm = torch.stack([torch.randperm(path_args[0].shape[1])
                        for _ in range(batch)]).to(dev)
    shuffled = (torch.gather(path_args[0], 1, perm),
                torch.gather(path_args[1], 1, perm).contiguous())
    ok_all, err_all = True, 0.0
    for tag, a_ in (
            (f"the path's view ({shared_tables(path_args)} probes share "
             "their rank's table)", path_args),
            (f"spill buckets, cap {half.cap_list} "
             f"({shared_tables(half_args)} probes share their rank's "
             "table)", half_args),
            (f"a rank with {most} spill buckets, cap {quarter.cap_list}",
             quarter_args),
            ("filtered bucket_valid", path_args[:4] + (filtered,)
             + path_args[5:]),
            ("fewer valid rows than k", path_args[:4] + (sparse,)
             + path_args[5:]),
            ("k 1", path_args[:6] + (1,)),
            ("k 12", path_args[:6] + (12,)),
            ("k 64", path_args[:6] + (64,)),
            ("a query whose probes are all padded", (padded_vp,)
             + path_args[1:]),
            ("coarse_pos rows out of order", shuffled + path_args[2:])):
        kv, ki = b5(*a_)
        pv, pi = kernel_pq.ivf_pq_adc_topk_plain(*a_)
        ok, err = kernel_parity(kv, ki, pv, pi)
        if a_[4] is sparse:
            ok = ok and bool((ki[:, 30:] == -1).all())
        if a_[0] is padded_vp:
            ok = ok and bool((ki[0] == -1).all()
                             and torch.isneginf(kv[0]).all())
        check(ok, f"B5 kernel == plain, {tag} (max abs err {err:.3g})")
        ok_all, err_all = ok_all and ok, max(err_all, err)
    del half, half_codes, quarter, quarter_codes, quarter_args

    # -- the table kernel against the torch composite (its plain version) --
    lut_ok, lut_err = True, 0.0
    for np_ in (16, 32):
        pr = coarse_probes(qpad, index.centroids, index._c_sqnorm, np_)
        got = lutk(qpad, index.centroids, pr, index.codebooks)
        want = kernel_pq.ivfpq_adc_lut_plain(qpad, index.centroids, pr,
                                             index.codebooks)
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=LUT_RTOL, atol=LUT_ATOL))
        check(ok, f"table kernel == torch composite at nprobe={np_}, "
              f"[{batch}, {np_}, {m}, {index.ksub}] (max abs err "
              f"{err:.3g}, rtol {LUT_RTOL}, atol {LUT_ATOL})")
        lut_ok, lut_err = lut_ok and ok, max(lut_err, err)
    del got, want
    lut_fns = {
        "kernel": lambda: lutk(qpad, index.centroids, probes,
                               index.codebooks),
        "torch": lambda: kernel_pq.ivfpq_adc_lut_plain(
            qpad, index.centroids, probes, index.codebooks)}
    lut_reads = {nm: [] for nm in lut_fns}
    for r in range(ROUNDS):
        for nm in (("kernel", "torch") if r % 2 == 0 else ("torch",
                                                           "kernel")):
            lut_reads[nm].append(time_ms(lut_fns[nm], torch))
    dsub = d // m
    ncent = len(np.unique(probes.cpu().numpy()))
    lut_bytes = (batch * nprobe_t * m * index.ksub * 4 + batch * d * 4
                 + ncent * d * 4 + m * index.ksub * dsub * 4
                 + batch * nprobe_t * 4)
    lut_ops = 2.0 * batch * nprobe_t * m * index.ksub * (dsub + 1)
    lut_bound, lut_by = bound_of(lut_bytes, lut_ops)
    lut_ms = median_spread(lut_reads["kernel"])[0]
    torch_ms = median_spread(lut_reads["torch"])[0]
    print(f"[{card}] ivfpq_adc_lut [{batch}, {nprobe_t}, {m}, {index.ksub}]"
          f": {spread_text(lut_reads['kernel'])}; torch composite "
          f"{spread_text(lut_reads['torch'])}; per-round kernel / torch "
          f"median {np.median(np.divide(lut_reads['kernel'], lut_reads['torch'])):.4f}"
          f"; bound {lut_bound:.4f} ms ({lut_by}); launches on the IVF_PQ "
          f"path {lut_launches}", flush=True)
    vp = path_args[0].cpu().numpy()
    cpn = path_args[1].cpu().numpy()

    # bound: the distinct (query, coarse rank) tables the live probes read
    # plus the distinct probed buckets' codes, valid flags and slots
    live = vp >= 0
    ntables = len(np.unique(np.stack([np.broadcast_to(
        np.arange(batch)[:, None], vp.shape)[live], cpn[live]]), axis=1).T)
    nbuck = len(np.unique(vp[live]))
    cap = view.cap_list
    nbytes = (ntables * m * index.ksub * 4 + nbuck * cap * (m + 1 + 4)
              + vp.size * 8 + batch * kk * 8)
    bound, by = bound_of(nbytes, float(live.sum()) * cap * m)
    return {"wrapper": wrapper, "args": path_args, "launches": b5_launches,
            "xla_calls": b5_xla_calls, "ok": ok_all, "err": err_all,
            "bound": bound, "by": by,
            "lut": {"launches": lut_launches, "ok": lut_ok, "err": lut_err,
                    "reads": lut_reads["kernel"], "ms": lut_ms,
                    "torch_ms": torch_ms, "bound": lut_bound, "by": lut_by},
            "shape": f"b={batch} budget={vp.shape[1]} cap={cap} m={m} "
                     f"k={kk} tables={ntables} distinct buckets={nbuck}"}


def thread_profile(fn, top: int = 6, period_s: float = 0.001) -> str:
    """Run fn while a sampler thread reads every thread's innermost Python
    frame each `period_s` (sys._current_frames). cProfile sees only the
    thread that enables it, and the coalesced path runs on three: the
    submitter, the coalescer's flush thread (search-coalescer) and its
    completion lane. Per thread with samples: their count and the `top`
    functions by share of them (a thread blocked in C shows the Python
    frame that called it, e.g. threading's wait); the sampler's own cost
    is included."""
    import collections
    import os
    import threading

    counts = collections.defaultdict(collections.Counter)
    names = {}
    stop = threading.Event()

    def sampler():
        me = threading.get_ident()
        n = 0
        while not stop.wait(period_s):
            if n % 50 == 0:
                names.update({t.ident: t.name for t in threading.enumerate()})
            n += 1
            for tid, frame in sys._current_frames().items():
                if tid != me:
                    code = frame.f_code
                    counts[tid][(code.co_name,
                                 os.path.basename(code.co_filename),
                                 code.co_firstlineno)] += 1

    t = threading.Thread(target=sampler, name="smoke-sampler", daemon=True)
    t0 = time.perf_counter()
    t.start()
    try:
        fn()
    finally:
        stop.set()
        t.join(timeout=10)
    wall_ms = (time.perf_counter() - t0) * 1e3
    parts = []
    for tid, c in sorted(counts.items(), key=lambda kv: -sum(kv[1].values())):
        total = sum(c.values())
        name = names.get(tid, str(tid))
        if total < 10 or not name.startswith(
                ("MainThread", "search-coalescer", "dingo-completion-lane",
                 "coalescer-flush", "smoke-writer")):
            continue
        rows = ", ".join(f"{f} ({file}:{line}) {k / total:.1%}"
                         for (f, file, line), k in c.most_common(top))
        parts.append(f"{name} [{total} samples]: {rows}")
    return f"wall {wall_ms:.1f} ms; " + "; ".join(parts)


#: the coalesced serving phase drives the JAX package's pipeline_sweep
#: traffic (bench.py:2160): 4-row requests over 4 coalescer keys, max_batch
#: 64, a 2 ms window, a closed loop of 16 requests in flight a round
CO_REQ_ROWS, CO_KEYS, CO_MAX_BATCH, CO_WINDOW_MS, CO_IN_FLIGHT = \
    4, 4, 64, 2.0, 16
#: seconds each arm serves, split over CO_TURNS turns taken in rotation
CO_ARM_S, CO_TURNS = 2.0, 3
#: the writer of the load round: rows upserted, then deleted, in chunks
CO_WRITE_ROWS, CO_DELETE_ROWS, CO_WRITE_CHUNK = 8192, 4096, 512


def alias_region(node, region_id: int, region):
    """A read-only region `region_id` on `node` over `region`'s key range
    and index: the same engine rows and the same wrapper under another
    region id, as the sweep serves one index under several keys. It has
    no raft member, so it takes no writes."""
    import copy

    from dingo_tpu_torch.store.region import Region, RegionState

    definition = copy.deepcopy(region.definition)
    definition.region_id = region_id
    alias = Region(definition, device=node.device)
    alias.vector_index_wrapper = region.vector_index_wrapper
    node.meta.add_region(alias)
    alias.set_state(RegionState.NORMAL, f"alias of region {region.id}")
    return alias


def co_node(wrapper, x):
    """A MonoStoreEngine node whose region 1 holds `x` (ids 0..n-1, the
    rows `wrapper` holds) in its engine and is served by `wrapper`, with
    regions 2..CO_KEYS as its aliases. The rows go in through
    Storage.vector_add; the wrapper stands for an index snapshot taken at
    the region's last ingest log id, so the apply-log contract skips those
    writes in the index and applies every later one. Returns (node, region
    1)."""
    from dingo_tpu_torch.engine.storage import VECTOR_MAX_BATCH_COUNT
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    n = x.shape[0]
    node = MonoStoreNode(device=wrapper.device)
    region = node.create_region(RegionDefinition(
        region_id=1, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=wrapper.parameter))
    region.vector_index_wrapper = wrapper
    index = wrapper.own_index
    index.apply_log_id = -(-n // VECTOR_MAX_BATCH_COUNT)
    wrapper.set_own(index)
    t0 = time.perf_counter()
    for lo in range(0, n, VECTOR_MAX_BATCH_COUNT):
        hi = min(n, lo + VECTOR_MAX_BATCH_COUNT)
        node.storage.vector_add(region, np.arange(lo, hi, dtype=np.int64),
                                x[lo:hi])
    print(f"coalesced node: {n} rows into a MonoStoreEngine region through "
          f"Storage.vector_add in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for r in range(2, CO_KEYS + 1):
        alias_region(node, r, region)
    return node, region


def co_service(node, depth: int):
    """The port's entry point over `node` (co_node's): every batch goes
    through Storage and the region's VectorReader. Depth 0 is the serial
    arm (pipeline_enabled false), else the pipelined arm at that staging
    depth. Returns (service, saved flags)."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.server.services import IndexService

    saved = set_flags(FLAGS, pipeline_enabled="true" if depth else "false",
                      pipeline_depth=max(1, depth))
    svc = IndexService(node, window_ms=CO_WINDOW_MS, max_batch=CO_MAX_BATCH)
    return svc, saved


def co_close(svc, saved) -> None:
    from dingo_tpu_torch.common.config import FLAGS

    svc.close()
    for f_, v_ in saved.items():
        FLAGS.set(f_, v_)


def closed_loop(svc, pool, k, kw, seconds, stop=None, keys=None):
    """Serve `pool`'s 4-row requests through `svc` in a closed loop:
    CO_IN_FLIGHT requests over the region ids `keys` (1..CO_KEYS by
    default) a round, then wait for all of them; for `seconds`, or until
    `stop` is set when given (60 s at most). Returns (rows served, wall s,
    request latencies ms)."""
    keys = list(keys or range(1, CO_KEYS + 1))
    lat: list = []
    rows, i = 0, 0
    nreq = len(pool) // CO_REQ_ROWS
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0
        if el > 60 or (stop.is_set() if stop is not None else el >= seconds):
            break
        futs = []
        for j in range(CO_IN_FLIGHT):
            r = i % nreq
            i += 1
            s = time.perf_counter()
            f = svc.submit(keys[j % len(keys)],
                           pool[r * CO_REQ_ROWS:(r + 1) * CO_REQ_ROWS], k,
                           **kw)
            f.add_done_callback(
                lambda _f, s=s: lat.append((time.perf_counter() - s) * 1e3))
            futs.append(f)
        for f in futs:
            rows += len(f.result(timeout=60))
    return rows, time.perf_counter() - t0, lat


def probe_digest(svc, probe, k, kw):
    """The fixed probe set's replies, one 4-row request at a time (each
    alone in its batch, so every arm forms the same batches): (sha1 over
    the ids' and distances' bytes, ids per query)."""
    import hashlib

    sha, ids = hashlib.sha1(), []
    for i in range(0, len(probe), CO_REQ_ROWS):
        for row in svc.submit(1, probe[i:i + CO_REQ_ROWS], k,
                              **kw).result(timeout=60):
            rid = np.asarray([v.id for v in row], np.int64)
            sha.update(rid.tobytes())
            sha.update(np.asarray([v.distance for v in row],
                                  np.float32).tobytes())
            ids.append(rid)
    return sha.hexdigest(), ids


def serve_arm(node, depth, pool, probe, k, kw, seconds) -> dict:
    """One turn of one arm: warm its own path (ring slots, lane thread),
    read the probe set's digest, serve the closed loop for `seconds`.
    Stage totals are the loop's only."""
    svc, saved = co_service(node, depth)
    try:
        for f in [svc.submit(1 + i % CO_KEYS, pool[:CO_REQ_ROWS], k, **kw)
                  for i in range(2 * CO_KEYS)]:
            f.result(timeout=60)
        sha, ids = probe_digest(svc, probe, k, kw)
        base = svc._get_coalescer().stage_totals()
        rows, wall, lat = closed_loop(svc, pool, k, kw, seconds)
        totals = svc._get_coalescer().stage_totals()
    finally:
        co_close(svc, saved)
    return {"rows": rows, "wall": wall, "lat": lat, "sha": sha, "ids": ids,
            "totals": {s: totals.get(s, 0.0) - base.get(s, 0.0)
                       for s in totals}}


def arm_report(name, tag, turns, card) -> dict:
    """Fold one arm's turns: rows/s at saturation, p50 and p99 request
    latency, stage fractions of the pipelined arm (batch_form, dispatch
    and resolve are the flush and lane walls; kernel and rerank lie inside
    resolve) and the dispatch-overhead percentage, as bench.py's
    pipeline_sweep reports them."""
    rows = sum(t["rows"] for t in turns)
    wall = sum(t["wall"] for t in turns)
    lat = np.concatenate([np.asarray(t["lat"], np.float64) for t in turns])
    totals: dict = {}
    for t in turns:
        for s, ms in t["totals"].items():
            totals[s] = totals.get(s, 0.0) + ms
    out = {"rows_per_s": rows / wall, "turn_rows_per_s":
           [t["rows"] / t["wall"] for t in turns],
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "requests": len(lat)}
    text = (f"[{card}] coalesced {name} {tag}: {out['rows_per_s']:.1f} "
            f"rows/s (turns {[round(v, 1) for v in out['turn_rows_per_s']]})"
            f", request p50 {out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f}"
            f" ms over {len(lat)} requests")
    serialized = sum(totals.get(s, 0.0)
                     for s in ("batch_form", "dispatch", "resolve"))
    if serialized > 0:
        out["stage_fractions"] = {
            s: totals.get(s, 0.0) / serialized
            for s in ("batch_form", "dispatch", "kernel", "rerank",
                      "resolve")}
        out["dispatch_overhead_pct"] = \
            100.0 * totals.get("dispatch", 0.0) / serialized
        text += ("; stage fractions " + ", ".join(
            f"{s} {v:.4f}" for s, v in out["stage_fractions"].items())
            + f"; dispatch overhead {out['dispatch_overhead_pct']:.2f}%")
    print(text, flush=True)
    return out


def coalesced_phase(x, extra, regions, card) -> dict:
    """Serve the smoke's indexes through the port's coalesced entry point
    (server/services.IndexService over a co_node: a SearchCoalescer whose
    run is Storage.vector_batch_search and whose dispatch is its
    vector_batch_search_async(staged=...)) with the traffic of the JAX
    package's pipeline_sweep. `regions`: name -> (wrapper, kernel wrapper
    whose launches the path must make, search kwargs, depths, flags).
    Each index gets a node of its own, released after its arms. IVF_FLAT
    takes the serial arm and depths 1, 2 and 4 in turns over CO_TURNS
    rounds; the others their serial arm and depth 2. Checks byte-identical
    probe replies across arms, probe ids == a direct search modulo ties,
    no staged miss, no new kernel shape after warm-up, an expired budget
    launching nothing, the span tree and its Chrome export, and writes
    under load (on the first region). Prints each arm's rows/s, p50/p99
    and stage fractions, and the depth-2 arm's device busy share and host
    profile."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.obs.sentinel import SENTINEL

    n = x.shape[0]
    k = 10
    rng = np.random.default_rng(23)
    pool = (x[rng.choice(n, 1024, replace=False)] + 0.05 * rng.standard_normal(
        (1024, x.shape[1]), dtype=np.float32)).astype(np.float32)
    probe = pool[:32]
    misses0 = METRICS.counter("pipeline.staged_miss").get()
    report: dict = {}
    t_phase = time.perf_counter()
    for name, (wrapper, kern, kw, depths, flags) in regions.items():
        saved_region = set_flags(FLAGS, **flags)
        node, region = co_node(wrapper, x)
        try:
            kern.launches = 0
            b = 1
            while b <= CO_MAX_BATCH:          # warm the pow2 batch ladder
                wrapper.search(pool[:b], k, **kw)
                b *= 2
            new0 = SENTINEL.new_shapes()
            arms = [0] + list(depths)
            turns = {a: [] for a in arms}
            rounds = CO_TURNS if len(arms) > 2 else 1
            for r in range(rounds):
                for a in arms[r % len(arms):] + arms[:r % len(arms)]:
                    turns[a].append(serve_arm(node, a, pool, probe, k, kw,
                                              CO_ARM_S / rounds))
            new_shapes = SENTINEL.new_shapes() - new0
            direct = wrapper.search(probe, k, **kw)
            out = {"launches": kern.launches}
            for a in arms:
                out[a] = arm_report(name, "serial" if a == 0 else
                                    f"pipelined depth {a}", turns[a], card)
            shas = {t["sha"] for a in arms for t in turns[a]}
            check(len(shas) == 1, f"coalesced {name}: probe replies "
                  f"byte-identical across every arm and turn ({len(shas)} "
                  "digests)")
            check(same_modulo_ties(x, probe, turns[0][0]["ids"],
                                   [r.ids for r in direct]),
                  f"coalesced {name}: probe ids == a direct search modulo "
                  "ties")
            check(new_shapes == 0, f"coalesced {name}: no new kernel shape "
                  f"after the warmed ladder ({new_shapes})")
            check(kern.launches > 0, f"coalesced {name}: the path launched "
                  f"its kernel ({kern.launches} launches)")
            if 2 in depths:
                ratio = out[2]["rows_per_s"] / out[0]["rows_per_s"]
                print(f"[{card}] coalesced {name}: depth 2 / serial rows/s "
                      f"{ratio:.4f}; launches in the arms {kern.launches}",
                      flush=True)
            report[name] = out
            if name == next(iter(regions)):
                report["checks"] = co_checks(node, region, kern, pool,
                                             extra, k, kw, card)
        finally:
            node.stop()
            node = region = None
            for f_, v_ in saved_region.items():
                FLAGS.set(f_, v_)
    misses = METRICS.counter("pipeline.staged_miss").get() - misses0
    check(misses == 0, f"coalesced phase: pipeline.staged_miss {misses} on "
          "the L2 regions")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"coalesced serving phase: {report['seconds']:.1f} s", flush=True)
    return report


def co_checks(node, region, kern, pool, extra, k, kw, card) -> dict:
    """The depth-2 arm's profiles, then the checks that need a live
    service: an expired budget, the span tree, writes under load (through
    `region`'s Storage)."""
    import tempfile
    import threading

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.obs import pressure as qp
    from dingo_tpu_torch.obs.sentinel import SENTINEL
    from dingo_tpu_torch.trace import TRACE_BUFFER, to_chrome_trace
    from dingo_tpu_torch.trace.export import dump_chrome_trace

    out: dict = {}
    svc, saved = co_service(node, 2)
    try:
        closed_loop(svc, pool, k, kw, 0.2)          # warm
        out["device_profile"] = device_profile(
            lambda: closed_loop(svc, pool, k, kw, 0.5))
        print(f"[{card}] profile, coalesced depth 2 (0.5 s closed loop): "
              + out["device_profile"], flush=True)
        out["host_profile"] = thread_profile(
            lambda: closed_loop(svc, pool, k, kw, 1.0))
        print(f"[{card}] host sample profile, coalesced depth 2 (1 s "
              "closed loop): " + out["host_profile"], flush=True)

        # an expired budget: DeadlineExceeded at admission, no launch
        qsaved = set_flags(FLAGS, qos_enabled=True)
        try:
            launches = kern.launches
            calls = sum(e["calls"] for e in SENTINEL.state().values())
            with qp.budget_scope(-1.0):
                fut = svc.submit(1, pool[:CO_REQ_ROWS], k, **kw)
            exc = fut.exception(timeout=30)
            check(isinstance(exc, qp.DeadlineExceeded)
                  and kern.launches == launches
                  and sum(e["calls"] for e in SENTINEL.state().values())
                  == calls, "coalesced: an expired budget gets "
                  "DeadlineExceeded with no kernel launch")
        finally:
            for f_, v_ in qsaved.items():
                FLAGS.set(f_, v_)
    finally:
        co_close(svc, saved)

    # the span tree of one request (the service closed after it, so the
    # lane has ended the run span), and its Chrome export
    tsaved = set_flags(FLAGS, trace_sampling_rate=1.0)
    TRACE_BUFFER.clear()
    svc, saved = co_service(node, 2)
    try:
        svc.submit(1, pool[:CO_REQ_ROWS], k, **kw).result(timeout=60)
    finally:
        co_close(svc, saved)
        for f_, v_ in tsaved.items():
            FLAGS.set(f_, v_)
    recs = TRACE_BUFFER.snapshot()
    TRACE_BUFFER.clear()
    waits = [r for r in recs if r["name"] == "coalesce.wait"]
    runs = [r for r in recs if r["name"] == "coalesce.run"]
    with tempfile.TemporaryDirectory() as tmp:
        path = dump_chrome_trace(os.path.join(tmp, "trace.json"), recs)
        with open(path) as f:
            chrome = json.load(f)
    check(len(waits) == 1 and len(runs) == 1
          and runs[0]["trace_id"] == waits[0]["trace_id"]
          and runs[0]["parent_id"] == waits[0]["span_id"]
          and chrome == json.loads(json.dumps(to_chrome_trace(recs)))
          and all(e["ph"] == "X" for e in chrome["traceEvents"]),
          "coalesced: trace_sampling_rate 1 gives coalesce.wait and "
          "coalesce.run in one trace; the Chrome export parses")

    # writes under load: a depth-2 round while a writer thread upserts
    # CO_WRITE_ROWS rows and deletes CO_DELETE_ROWS, in chunks
    wrapper = region.vector_index_wrapper
    n = wrapper.get_count()
    wid = np.arange(CO_WRITE_ROWS, dtype=np.int64) + 10 * n + 1_000_003
    rows_w = extra[:CO_WRITE_ROWS]
    done = threading.Event()
    errors: list = []

    def writer():
        try:
            for lo in range(0, CO_WRITE_ROWS, CO_WRITE_CHUNK):
                node.storage.vector_add(region, wid[lo:lo + CO_WRITE_CHUNK],
                                        rows_w[lo:lo + CO_WRITE_CHUNK])
            for lo in range(0, CO_DELETE_ROWS, CO_WRITE_CHUNK):
                node.storage.vector_delete(region,
                                           wid[lo:lo + CO_WRITE_CHUNK])
        except Exception as e:  # noqa: BLE001 — reported by the check
            errors.append(repr(e))
        finally:
            done.set()

    svc, saved = co_service(node, 2)
    try:
        t = threading.Thread(target=writer, name="smoke-writer", daemon=True)
        t.start()
        rows, wall, lat = closed_loop(svc, pool, k, kw, 0.0, stop=done)
        t.join(timeout=60)
    finally:
        co_close(svc, saved)
    live, dead = wid[CO_DELETE_ROWS:], wid[:CO_DELETE_ROWS]
    found = 0
    for lo in range(0, len(live), 64):
        res = wrapper.search(rows_w[CO_DELETE_ROWS + lo:
                                    CO_DELETE_ROWS + lo + 64], k, **kw)
        found += sum(len(r.ids) > 0 and r.ids[0] == i
                     for r, i in zip(res, live[lo:lo + 64]))
    leaked = 0
    for lo in range(0, CO_DELETE_ROWS, 64):
        res = wrapper.search(rows_w[lo:lo + 64], k, **kw)
        leaked += sum(int(np.isin(r.ids, dead).sum()) for r in res)
    print(f"[{card}] coalesced writes under load: {CO_WRITE_ROWS} upserts + "
          f"{CO_DELETE_ROWS} deletes in {CO_WRITE_CHUNK}-row chunks during "
          f"{wall:.2f} s of depth-2 serving ({rows / wall:.1f} rows/s, p99 "
          f"{np.percentile(lat, 99):.3f} ms); live upserted rows found by "
          f"their own vector {found}/{len(live)}, deleted ids returned "
          f"{leaked}", flush=True)
    check(not errors and not t.is_alive() and found == len(live)
          and leaked == 0, "coalesced: each upserted row is found by its own "
          f"vector and no deleted id appears {errors}")
    node.storage.vector_delete(region, live)   # the region back to its rows
    check(wrapper.get_count() == n and node.storage.vector_count(region)
          == n, "coalesced: the region's index and engine hold its rows "
          "again after the writes")
    out["writes"] = {"rows_per_s": rows / wall, "found": found,
                     "leaked": leaked}
    return out


def gist_phase(n, nlist, card) -> dict:
    """The default route at GIST1M's width (ann-benchmarks'
    gist-960-euclidean: 1,000,000 x 960; the smoke runs GIST_N of them),
    rows from make_data's recipe,
    batch 64, k 10, every flag at its default. 960 does not tile into the
    pruned route's 128-column blocks, so a FLAT index serves on B1 and a
    trained IVF_FLAT on B2 (B3 and B4 do not launch): recall@10 against
    the exact top-10, each kernel against its plain version, the two
    kernels timed in turns, pipelined ms/batch of each index with the
    device's busy share. Returns the launches of B1 and B2."""
    import torch

    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.flat import TpuFlat
    from dingo_tpu_torch.index.ivf_flat import coarse_probes
    from dingo_tpu_torch.index.ivf_layout import expand_probes, shape_bucket
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.ops import (
        kernel_ivf,
        kernel_ivf_pruned,
        kernel_topk,
        kernel_topk_pruned,
    )
    from dingo_tpu_torch.ops.distance import Metric

    b1, b2 = kernel_topk.fused_topk, kernel_ivf.ivf_list_topk
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    b4 = kernel_topk_pruned.pruned_fused_topk
    d, batch, k = GIST_D, 64, 10
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    x, queries, _ = make_data(n, d, batch)
    gt = exact_topk(x, queries, k)
    print(f"d {d}: data + numpy exact top-{k} of {n} rows: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    flat = TpuFlat(40, IndexParameter(index_type=IndexType.FLAT,
                                      dimension=d, metric=Metric.L2),
                   device=dev)
    flat.store.reserve(n)
    for lo in range(0, n, 65536):
        flat.upsert(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                    x[lo:min(n, lo + 65536)])
    check(flat.store.vecs_blk is None,
          f"d {d}: the FLAT store keeps no blocked mirror by default")
    wrapper = VectorIndexWrapper(41, IndexParameter(
        index_type=IndexType.IVF_FLAT, dimension=d, metric=Metric.L2,
        ncentroids=nlist, default_nprobe=32), device=dev)
    wrapper.set_own(wrapper.build_own())
    ivf = wrapper.own_index
    ivf.store.reserve(n)
    for i, lo in enumerate(range(0, n, 65536)):
        wrapper.add(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                    x[lo:min(n, lo + 65536)], i + 1)
    ivf.train()
    torch.cuda.synchronize()
    print(f"d {d}: FLAT and IVF_FLAT (nlist {nlist}) ingest, train: "
          f"{time.perf_counter() - t0:.1f} s since the phase began",
          flush=True)

    # the searches, flags at their defaults: B1 and B2, not B3 or B4
    launches = {nm: kern.launches for nm, kern in
                (("B1", b1), ("B2", b2), ("B3", b3), ("B4", b4))}
    res_flat = flat.search(queries, k)
    res_ivf = {nprobe: wrapper.search(queries, k, nprobe=nprobe)
               for nprobe in (32, 64)}
    torch.cuda.synchronize()
    launches = {nm: kern.launches - launches[nm] for nm, kern in
                (("B1", b1), ("B2", b2), ("B3", b3), ("B4", b4))}
    rec = {nprobe: recall_at(r, gt, k) for nprobe, r in res_ivf.items()}
    print(f"[{card}] d {d} default route: launches {launches}; FLAT "
          f"recall@{k} {recall_at(res_flat, gt, k):.4f}; IVF_FLAT recall@{k} "
          f"nprobe=32 {rec[32]:.4f}, nprobe=64 {rec[64]:.4f}", flush=True)
    check(ivf._bucket_bsq is None,
          f"d {d}: the IVF view carries no block norms (no pruned route)")
    check(launches["B1"] > 0 and launches["B2"] > 0
          and launches["B3"] == 0 and launches["B4"] == 0,
          f"d {d}, flags at their defaults: FLAT served on B1, IVF_FLAT on "
          "B2, B3 and B4 not launched")
    check(same_modulo_ties(x, queries, [r.ids for r in res_flat], gt),
          f"d {d}: B1 ids == numpy exact top-10 modulo ties")
    check(rec[64] >= 0.95, f"d {d}: IVF_FLAT recall@10 >= 0.95 at nprobe=64 "
                           "(B2)")

    # each kernel against its plain version, then both timed in turns
    qpad = torch.from_numpy(queries).to(dev)
    fs = flat.store
    b1_args = (qpad, fs.vecs, fs.sqnorm, fs.device_mask(), k)
    nprobe_t = shape_bucket(32)
    probes = coarse_probes(qpad, ivf.centroids, ivf._c_sqnorm, nprobe_t)
    view = ivf._view
    vprobes = expand_probes(probes, view.probe_table, nprobe_t,
                            view.max_spill)
    b2_args = (vprobes, qpad, ivf._buckets, ivf._bucket_sqnorm,
               view.bucket_valid, view.bucket_slot, shape_bucket(k))
    out = {}
    for nm, kern, plain, a_ in (
            ("B1", b1, kernel_topk.fused_topk_plain, b1_args),
            ("B2", b2, kernel_ivf.ivf_list_topk_plain, b2_args)):
        kv, ki = kern(*a_)
        pv, pi = plain(*a_)
        ok, err = kernel_parity(kv, ki, pv, pi)
        check(ok, f"d {d}: {nm} kernel == plain (max abs err {err:.3g})")
        out[nm] = {"ok": ok, "err": err,
                   "plain_ms": time_ms(lambda: plain(*a_), torch, iters=3,
                                       warmup=1)}
    reads = {"B1": [], "B2": []}
    for r in range(ROUNDS):
        for nm in (("B1", "B2") if r % 2 == 0 else ("B2", "B1")):
            kern, a_ = (b1, b1_args) if nm == "B1" else (b2, b2_args)
            reads[nm].append(time_ms(lambda: kern(*a_), torch))
    vp = vprobes.cpu().numpy()
    nbuck = len(np.unique(vp[vp >= 0]))
    cap = view.cap_list
    b1_bytes = batch * d * 4 + n * (d * 4 + 4 + 1) + batch * k * 8
    b2_bytes = (nbuck * cap * (d * 4 + 4 + 1 + 4) + batch * d * 4
                + vp.size * 4 + batch * shape_bucket(k) * 8)
    bounds = {"B1": bound_of(b1_bytes, SPLIT_PASSES * 2.0 * batch * n * d,
                             PEAK_TF32_FLOPS),
              "B2": bound_of(b2_bytes, SPLIT_PASSES * 2.0 * int(
                  (vp >= 0).sum()) * cap * d, PEAK_TF32_FLOPS)}
    for nm in ("B1", "B2"):
        out[nm]["reads"] = reads[nm]
        out[nm]["bound"] = bounds[nm]
        print(f"[{card}] d {d} {nm} "
              + (f"n={n}" if nm == "B1" else
                 f"budget={vp.shape[1]} cap={cap} distinct buckets={nbuck}")
              + f": {spread_text(reads[nm])}, plain "
              f"{out[nm]['plain_ms']:.4f} ms, bound {bounds[nm][0]:.4f} ms "
              f"({bounds[nm][1]})", flush=True)

    # pipelined serving of both indexes, then a profile of each window
    for tag, idx_, nprobe in (("FLAT (B1)", flat, None),
                              ("IVF_FLAT nprobe=32 (B2)", wrapper, 32)):
        ms = [pipelined_ms(idx_, queries, k, nprobe) for _ in range(ROUNDS)]
        med = median_spread(ms)[0]
        print(f"[{card}] d {d} pipelined {tag} b={batch} k={k} via "
              f"search_async x20: {spread_text(ms)} per batch "
              f"({batch / med * 1e3:.0f} QPS at the median)", flush=True)
        print(f"[{card}] d {d} profile, pipelined {tag} x20: "
              + device_profile(pipelined_window(idx_, queries, k, nprobe)),
              flush=True)
    out["launches"] = launches
    return out


def same_tier_results(a, b) -> bool:
    """Two result lists of one tier agree modulo ties of that tier's own
    distances: every id that only one list holds sits at (within
    RTOL/ATOL of) the other list's k-th distance, and the distances agree
    position by position."""
    for ra, rb in zip(a, b):
        if len(ra.ids) != len(rb.ids) or not np.allclose(
                ra.distances, rb.distances, rtol=RTOL, atol=ATOL):
            return False
        for r1, r2 in ((ra, rb), (rb, ra)):
            extra = set(r1.ids.tolist()) - set(r2.ids.tolist())
            for i in extra:
                dist = r1.distances[list(r1.ids).index(i)]
                if not np.isclose(dist, r2.distances[-1], rtol=RTOL,
                                  atol=ATOL):
                    return False
    return True


def f64_witness(res_a, res_b, queries, store) -> str:
    """Two result lists of a float tier against f64 distances of the same
    pairs under the tier's arithmetic (|q|^2 of the f32 query, the query
    rounded to the rows' dtype in the dot, the stored row): each list's
    largest |error|, and each position where the two differ by more than
    RTOL/ATOL with both distances and the f64 ones."""
    import torch

    def exact(qi, ids):
        slots = torch.as_tensor(store.slots_of(np.asarray(ids)),
                                device=store.vecs.device)
        rows = store.vecs[slots].double()
        q = torch.as_tensor(queries[qi], device=rows.device)
        qr = q.to(store.vecs.dtype).double()
        q = q.double()
        return ((q * q).sum() - 2.0 * (rows @ qr)
                + (rows * rows).sum(1)).cpu().numpy()

    err_a = err_b = 0.0
    apart = []
    for qi, (ra, rb) in enumerate(zip(res_a, res_b)):
        fa, fb = exact(qi, ra.ids), exact(qi, rb.ids)
        err_a = max(err_a, float(np.abs(ra.distances - fa).max()))
        err_b = max(err_b, float(np.abs(rb.distances - fb).max()))
        for r in range(min(len(ra.ids), len(rb.ids))):
            if not np.isclose(ra.distances[r], rb.distances[r], rtol=RTOL,
                              atol=ATOL):
                apart.append(
                    f"query {qi} rank {r} ids {ra.ids[r]}/{rb.ids[r]}: "
                    f"{ra.distances[r]:.5f} / {rb.distances[r]:.5f}, f64 "
                    f"{fa[r]:.5f} / {fb[r]:.5f}")
    return (f"max |error| {err_a:.3g} / {err_b:.3g}; {len(apart)} positions "
            f"apart by more than RTOL/ATOL" + "".join(
                f"; {t}" for t in apart[:8]))


def sq8_mirror_arm(ivf, queries, gt, card) -> None:
    """The quality plane's mirror arm on the tier phase's sq8 IVF_FLAT
    (its oracle attached at the first write, fed the original rows): a
    window of scored searches at nprobe 32, the live recall interval
    against numpy's recall of the same queries, the mirror's device
    bytes beside the index's; then the oracle is dropped."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.index.base import tensor_bytes
    from dingo_tpu_torch.obs.quality import QUALITY

    k = gt.shape[1]
    oracle = QUALITY._attached_oracle(ivf)
    QUALITY.flush(timeout=300)     # the ingest's own sampled search
    QUALITY.reset_region(ivf.id)
    FLAGS.set("quality_sample_rate", 1.0)
    try:
        for _ in range(OBS_WINDOW_BATCHES):
            res = ivf.search(queries, k, nprobe=32)
        QUALITY.flush(timeout=300)
    finally:
        FLAGS.set("quality_sample_rate", 0.0)
    est = QUALITY.region_estimate(ivf.id)
    num = sum(len(set(r.ids.tolist()) & set(g.tolist()))
              for r, g in zip(res[:16], gt[:16])) / (16 * k)
    mirror_b = tensor_bytes(oracle._mirror) if oracle is not None else 0
    idx_b = ivf.get_device_memory_size()
    print(f"[{card}] obs quality, sq8 IVF_FLAT (the tier phase's "
          f"{len(ivf.store)} rows, sampling on from the first write): "
          f"oracle arm {oracle.mode if oracle else None}, live recall@{k} "
          "at nprobe 32 "
          + (f"{est['recall']:.4f} [{est['ci_low']:.4f}, "
             f"{est['ci_high']:.4f}] over {est['queries']} scored queries"
             if est else "none")
          + f" against the mirror's original rows, numpy's {num:.4f}; "
          f"mirror device bytes {mirror_b} beside the index's {idx_b}",
          flush=True)
    check(oracle is not None and oracle.mode == "mirror" and est is not None
          and est["ci_low"] <= num <= est["ci_high"]
          and mirror_b >= len(ivf.store) * ivf.dimension * 4,
          "obs quality sq8: the fp32 mirror arm scores against the original "
          "rows (the interval contains numpy's recall) and holds them on "
          "the device")
    QUALITY.forget_region(ivf.id)


def tier_phase(x, queries, extra, gt, nlist, card, fp32) -> list:
    """The bf16 and sq8 precision tiers at full width on the smoke's rows:
    for each tier a FLAT index searched before training (B4's arm of the
    tier by default; B1-bf16, or sq8's plain arm, with pruning off) and an
    IVF_FLAT region served through the wrapper at nprobe 16/32/64 (B3's arm
    by default; B2-bf16 or sq8's plain arm with pruning off), recall
    against the numpy exact top-10 and the JAX package's gates, the cached
    rerank, in-place writes on every route, device bytes beside fp32's,
    pipelined timing with fp32 and the tiers taking turns, a profile of the
    sq8 IVF route, and each arm against its plain version. Returns the six
    arms' entries of the kernels line."""
    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.flat import (
        TpuFlat,
        flat_search_plain,
        sq_flat_search_plain,
    )
    from dingo_tpu_torch.index.ivf_flat import coarse_probes, ivf_scan_scores
    from dingo_tpu_torch.index.ivf_layout import expand_probes, shape_bucket
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.ops import (
        kernel_ivf,
        kernel_ivf_pruned,
        kernel_topk,
        kernel_topk_pruned,
    )
    from dingo_tpu_torch.ops.blocked import (
        block_sqnorms,
        bucket_block_sqnorms,
        query_prefix_sqnorms,
        to_blocked,
    )
    from dingo_tpu_torch.ops.distance import Metric

    b1, b2 = kernel_topk.fused_topk, kernel_ivf.ivf_list_topk
    b3, b4 = kernel_ivf_pruned.ivf_pruned_topk, \
        kernel_topk_pruned.pruned_fused_topk
    n, d = x.shape
    batch, k = len(queries), gt.shape[1]
    dev = torch.device("cuda")
    nprobes = (16, 32, 64)
    launches, plain_calls, state = {}, {}, {}

    def ingest_flat(index_id, tier, rows=n):
        f = TpuFlat(index_id, IndexParameter(
            index_type=IndexType.FLAT, dimension=d, metric=Metric.L2,
            precision=tier), device=dev)
        f.store.reserve(rows)
        for lo in range(0, rows, 65536):
            f.upsert(np.arange(lo, min(rows, lo + 65536), dtype=np.int64),
                     x[lo:min(rows, lo + 65536)])
        return f

    def ingest_ivf(index_id, tier, rows=n):
        w = VectorIndexWrapper(index_id, IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=d, metric=Metric.L2,
            ncentroids=nlist, default_nprobe=32, precision=tier), device=dev)
        w.set_own(w.build_own())
        w.own_index.store.reserve(rows)
        for i, lo in enumerate(range(0, rows, 65536)):
            w.add(np.arange(lo, min(rows, lo + 65536), dtype=np.int64),
                  x[lo:min(rows, lo + 65536)], i + 1)
        w.own_index.train()
        w.own_index.search(queries[:1], k, nprobe=16)    # builds the view
        return w

    def route_flags(pruned):
        return set_flags(FLAGS, ivf_prune_scan=pruned)

    def restore(saved):
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)

    for ti, tier in enumerate(TIERS):
        ctr = f"launches_{tier}"
        plain_flat = sq_flat_search_plain if tier == "sq8" \
            else flat_search_plain
        # -- FLAT, the untrained region's brute-force arm -------------------
        t0 = time.perf_counter()
        flat = ingest_flat(40 + ti, tier)
        torch.cuda.synchronize()
        st = flat.store
        print(f"{tier} FLAT ingest {n} rows: {time.perf_counter() - t0:.1f}"
              f" s (rows {st.vecs.dtype}, mirror "
              f"{None if st.vecs_blk is None else st.vecs_blk.dtype})",
              flush=True)
        check(st.vecs_blk is not None and st.vecs_blk.dtype == st.vecs.dtype,
              f"{tier} FLAT keeps the blocked mirror in its row dtype")
        setattr(b4, ctr, 0)
        plain_flat.calls = 0
        res_b4 = flat.search(queries, k)
        torch.cuda.synchronize()
        launches[f"B4-{tier}"] = getattr(b4, ctr)
        check(launches[f"B4-{tier}"] > 0 and plain_flat.calls == 0,
              f"{tier} FLAT search ran B4's {tier} arm")
        r_b4 = recall_at(res_b4, gt, k)
        saved = route_flags(False)
        try:
            if tier == "bf16":
                setattr(b1, ctr, 0)
            plain_flat.calls = 0
            res_un = flat.search(queries, k)
            torch.cuda.synchronize()
            if tier == "bf16":
                launches["B1-bf16"] = b1.launches_bf16
                plain_calls["B1-bf16"] = plain_flat.calls
            else:
                plain_calls["B4-sq8"] = plain_flat.calls
        finally:
            restore(saved)
        r_un = recall_at(res_un, gt, k)
        saved = set_flags(FLAGS, use_pallas_fused_search=False)
        try:
            res_plain = flat.search(queries, k)       # the plain arm
        finally:
            restore(saved)
        r_plain = recall_at(res_plain, gt, k)
        print(f"{tier} FLAT recall@{k}: pruned (B4-{tier}) {r_b4:.4f}, "
              f"unpruned ({'B1-bf16' if tier == 'bf16' else 'plain arm'}) "
              f"{r_un:.4f}, plain arm {r_plain:.4f}; fp32 FLAT is exact",
              flush=True)
        if tier == "bf16":
            check(launches["B1-bf16"] > 0 and plain_calls["B1-bf16"] == 0,
                  "bf16 FLAT search with pruning off ran B1's bf16 arm")
            print("bf16 FLAT distances, pruned (B4) / plain arm, against "
                  "f64: " + f64_witness(res_b4, res_plain, queries, st),
                  flush=True)
            check(same_tier_results(res_b4, res_plain),
                  "bf16 FLAT pruned (B4) ids == plain-arm ids modulo ties")
        else:
            check(plain_calls["B4-sq8"] > 0,
                  "sq8 FLAT search with pruning off took the plain arm")
            check(r_b4 >= 0.995 * r_plain,
                  "sq8 FLAT pruned recall >= 0.995 x the plain arm's")
        check(min(r_b4, r_un) >= 1.0 - 0.05,
              f"{tier} FLAT recall@{k} within 0.05 of fp32's (1.0)")

        # -- IVF_FLAT through the wrapper -----------------------------------
        t0 = time.perf_counter()
        if tier == "sq8":
            # the quality plane's mirror arm: sampling on from the first
            # write, so the fp32 mirror holds the original rows
            FLAGS.set("quality_sample_rate", 1.0)
        try:
            w = ingest_ivf(50 + ti, tier)
        finally:
            FLAGS.set("quality_sample_rate", 0.0)
        torch.cuda.synchronize()
        ivf = w.own_index
        print(f"{tier} IVF_FLAT ingest + train + view: "
              f"{time.perf_counter() - t0:.1f} s (view {ivf._buckets.dtype}"
              f", block norms {ivf._bucket_bsq is not None})", flush=True)
        check(ivf._bucket_bsq is not None
              and ivf._buckets.dtype == ivf.store.vecs.dtype,
              f"{tier} IVF view keeps the store dtype, with block norms")
        setattr(b3, ctr, 0)
        ivf_scan_scores.calls = 0
        res3 = {p: w.search(queries, k, nprobe=p) for p in nprobes}
        torch.cuda.synchronize()
        launches[f"B3-{tier}"] = getattr(b3, ctr)
        plain_calls[f"B3-{tier}"] = ivf_scan_scores.calls
        check(launches[f"B3-{tier}"] > 0 and ivf_scan_scores.calls == 0,
              f"{tier} IVF searches ran B3's {tier} arm")
        if tier == "sq8":
            sq8_mirror_arm(ivf, queries, gt, card)
        saved = route_flags(False)
        try:
            ivf.compact()
            check(ivf._bucket_bsq is None, f"{tier} unpruned view")
            if tier == "bf16":
                setattr(b2, ctr, 0)
            ivf_scan_scores.calls = 0
            res_u = {p: w.search(queries, k, nprobe=p) for p in nprobes}
            torch.cuda.synchronize()
            if tier == "bf16":
                launches["B2-bf16"] = b2.launches_bf16
                plain_calls["B2-bf16"] = ivf_scan_scores.calls
                check(launches["B2-bf16"] > 0
                      and ivf_scan_scores.calls == 0,
                      "bf16 IVF searches with pruning off ran B2's bf16 arm")
            else:
                check(ivf_scan_scores.calls == len(nprobes),
                      "sq8 IVF searches with pruning off took the plain arm")
        finally:
            restore(saved)
        ivf.compact()
        for p in nprobes:
            r3, ru = recall_at(res3[p], gt, k), recall_at(res_u[p], gt, k)
            rf = fp32["recall"][p]
            print(f"{tier} IVF recall@{k} nprobe={p}: pruned (B3-{tier}) "
                  f"{r3:.4f}, unpruned "
                  f"({'B2-bf16' if tier == 'bf16' else 'plain arm'}) "
                  f"{ru:.4f}; fp32 {rf:.4f}", flush=True)
            check(min(r3, ru) >= rf - 0.05,
                  f"{tier} IVF recall@{k} within 0.05 of fp32's at "
                  f"nprobe={p}")
            if tier == "bf16":
                check(same_tier_results(res3[p], res_u[p]),
                      f"bf16 IVF pruned (B3) ids == unpruned (B2) ids "
                      f"modulo ties at nprobe={p}")
            else:
                check(r3 >= 0.995 * ru,
                      f"sq8 IVF pruned recall >= 0.995 x the plain arm's "
                      f"at nprobe={p}")

        # -- device bytes: store + mirror + view, beside fp32's -------------
        nbytes = ivf.get_device_memory_size()
        ratio = fp32["bytes"] / nbytes
        print(f"[{card}] {tier} IVF_FLAT device bytes (store + mirror + "
              f"view + centroids): {nbytes / 2**30:.3f} GiB against fp32's "
              f"{fp32['bytes'] / 2**30:.3f} GiB: {ratio:.3f}x smaller; "
              f"FLAT {flat.get_device_memory_size() / 2**30:.3f} GiB",
              flush=True)
        check(ratio >= (3.5 if tier == "sq8" else 1.8),
              f"{tier} device bytes >= {3.5 if tier == 'sq8' else 1.8}x "
              "smaller than fp32's")

        # -- in-place upserts and deletes, visible on every route -----------
        new_ids = np.arange(n, n + len(extra), dtype=np.int64)
        rebuilds, view = ivf.full_rebuilds, ivf._view
        w.add(new_ids, extra, w.apply_log_id + 1)
        flat.upsert(new_ids, extra)
        check(ivf._view is view and not ivf._view_dirty
              and ivf.full_rebuilds == rebuilds,
              f"{tier} IVF upsert of {len(extra)} rows applied in place")

        def routes_see(ids_ok, tag):
            for pruned in (True, False):
                saved = route_flags(pruned)
                try:
                    ivf.compact()
                    got = [w.search(extra[:batch], k, nprobe=32),
                           flat.search(extra[:batch], k)]
                finally:
                    restore(saved)
                for name, res in zip(("IVF", "FLAT"), got):
                    check(ids_ok(res), f"{tier} {name} "
                          f"{'pruned' if pruned else 'unpruned'} route: "
                          f"{tag}")
            ivf.compact()

        routes_see(lambda res: all(len(r.ids) and r.ids[0] == i for r, i in
                                   zip(res, new_ids[:batch])),
                   "upserted rows come back as their own nearest neighbour")
        w.delete(new_ids, w.apply_log_id + 1)
        flat.delete(new_ids)
        routes_see(lambda res: not any((r.ids >= n).any() for r in res),
                   "deleted rows are gone")
        check(ivf.get_count() == n and flat.get_count() == n,
              f"{tier} counts back to {n}")
        state[tier] = {"flat": flat, "wrapper": w, "res": res3}

    # -- the cached rerank, factor 4, on the first RERANK_N rows (a depth
    # cut for the smoke's clock), a cache over each of them: against their
    # own exact top-k and the same rows' IVF scan without a cache --------
    m = min(n, RERANK_N)
    gt_m = exact_topk(x[:m], queries, k)
    saved = set_flags(FLAGS, rerank_cache_rows=m, quantized_rerank_factor=4)
    try:
        for ti, tier in enumerate(TIERS):
            t0 = time.perf_counter()
            fr = ingest_flat(60 + ti, tier, m)
            wr = ingest_ivf(70 + ti, tier, m)
            torch.cuda.synchronize()
            check(len(fr._rerank_cache) == m
                  and len(wr.own_index._rerank_cache) == m,
                  f"{tier} rerank caches hold every row")
            before = getattr(b4, f"launches_{tier}")
            rf = fr.search(queries, k)
            ri = wr.search(queries, k, nprobe=32)
            torch.cuda.synchronize()
            check(getattr(b4, f"launches_{tier}") > before,
                  f"{tier} reranked FLAT scanned with B4 (k' 40)")
            secs = time.perf_counter() - t0
            del fr, wr
            FLAGS.set("rerank_cache_rows", 0)
            try:
                w0 = ingest_ivf(80 + ti, tier, m)
                check(w0.own_index._rerank_cache is None
                      or len(w0.own_index._rerank_cache) == 0,
                      f"{tier} IVF without a rerank cache")
                ri0 = w0.search(queries, k, nprobe=32)
            finally:
                FLAGS.set("rerank_cache_rows", m)
            del w0
            r_ivf, r_ivf0 = recall_at(ri, gt_m, k), recall_at(ri0, gt_m, k)
            print(f"{tier} cached rerank (factor 4, a cache over the first "
                  f"{m} rows, {secs:.1f} s with ingest): FLAT recall@{k} "
                  f"{recall_at(rf, gt_m, k):.4f}; IVF nprobe=32 "
                  f"{r_ivf:.4f} (the same rows without the rerank "
                  f"{r_ivf0:.4f})", flush=True)
            check(same_modulo_ties(x[:m], queries, [r.ids for r in rf],
                                   gt_m),
                  f"{tier} FLAT with the cached rerank == fp32 exact ids "
                  "modulo ties")
            check(r_ivf >= r_ivf0,
                  f"{tier} IVF cached rerank recall >= the scan's own")
            torch.cuda.empty_cache()
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)

    # -- pipelined serving cost, fp32 / bf16 / sq8 taking turns ------------
    wrappers = {"fp32": fp32["wrapper"], "bf16": state["bf16"]["wrapper"],
                "sq8": state["sq8"]["wrapper"]}
    b3_ctr = {"fp32": "launches", "bf16": "launches_bf16",
              "sq8": "launches_sq8"}
    pipe = {t: [] for t in wrappers}
    order = list(wrappers)
    for r in range(ROUNDS):
        for tier in order[r % 3:] + order[:r % 3]:
            before = getattr(b3, b3_ctr[tier])
            pipe[tier].append(pipelined_ms(wrappers[tier], queries, k, 32))
            if getattr(b3, b3_ctr[tier]) == before:
                raise SmokeFailure(f"pipelined {tier} search missed B3")
    for tier in order:
        med = median_spread(pipe[tier])[0]
        print(f"[{card}] pipelined IVF search, {tier} tier (default route, "
              f"B3{'' if tier == 'fp32' else '-' + tier}) b={batch} k={k} "
              f"nprobe=32 via search_async x20: {spread_text(pipe[tier])} "
              f"per batch ({batch / med * 1e3:.0f} QPS at the median); "
              f"readings {[round(v, 4) for v in pipe[tier]]}", flush=True)
    for tier in TIERS:
        print(f"[{card}] pipelined {tier} / fp32, median of the per-round "
              f"ratios: "
              f"{np.median(np.divide(pipe[tier], pipe['fp32'])):.4f}",
              flush=True)
    print(f"[{card}] profile, pipelined IVF search (sq8, B3-sq8) x20: "
          + device_profile(pipelined_window(wrappers["sq8"], queries, k, 32),
                           was="40.4%"), flush=True)
    print(f"[{card}] profile, pipelined IVF search (bf16, B3-bf16) x20: "
          + device_profile(pipelined_window(wrappers["bf16"], queries, k,
                                            32), was="not measured"),
          flush=True)

    # -- each arm against its plain version, at the path's shapes ----------
    qpad = torch.from_numpy(queries).to(dev)
    k_eff = shape_bucket(k)
    rng = np.random.default_rng(11)
    arms = {}
    for tier in TIERS:
        fst = state[tier]["flat"].store
        ivf = state[tier]["wrapper"].own_index
        view = ivf._view
        codec = ({"sq_vmin": fst.sq_vmin_d, "sq_scale": fst.sq_scale_d}
                 if tier == "sq8" else {})
        icodec = ({"sq_vmin": ivf.store.sq_vmin_d,
                   "sq_scale": ivf.store.sq_scale_d}
                  if tier == "sq8" else {})
        fmask = fst.device_mask()
        filt = fmask & torch.from_numpy(rng.random(fst.capacity) < 0.5).to(
            dev)
        few = torch.zeros_like(fmask)
        few[torch.nonzero(fmask)[:5, 0]] = True
        probes = coarse_probes(qpad, ivf.centroids, ivf._c_sqnorm, 32)
        vprobes = expand_probes(probes, view.probe_table, 32, view.max_spill)
        dblk = d // ivf._bucket_bsq.shape[1]
        qpsq = query_prefix_sqnorms(qpad, dblk)
        bfilt = view.bucket_valid & torch.from_numpy(
            rng.random(tuple(view.bucket_valid.shape)) < 0.5).to(dev)
        bfew = torch.zeros_like(view.bucket_valid)
        live = torch.nonzero(view.bucket_valid)[:5]
        bfew[live[:, 0], live[:, 1]] = True
        # a small case whose width forces the scalar loads: d 100 and
        # dimension blocks of 20 (not multiples of 8 or 16)
        sd, sdb = 100, 20
        srows = fst.vecs[:4096, :sd].contiguous()
        if tier == "sq8":
            scodec = {"sq_vmin": fst.sq_vmin_d[:sd].contiguous(),
                      "sq_scale": fst.sq_scale_d[:sd].contiguous()}
            sf32 = (srows.to(torch.float32) * scodec["sq_scale"]
                    + scodec["sq_vmin"])
        else:
            scodec = {}
            sf32 = srows.to(torch.float32)
        sq_small = qpad[:8, :sd].contiguous()
        svalid = torch.ones(4096, dtype=torch.bool, device=dev)
        sbk = srows.reshape(32, 128, sd)
        sbk32 = sf32.reshape(32, 128, sd)
        svp = torch.from_numpy(rng.integers(0, 32, (8, 6)).astype(
            np.int32)).to(dev)
        sslot = torch.arange(4096, dtype=torch.int32, device=dev).reshape(
            32, 128)
        cases = {}
        cases[f"B4-{tier}"] = (b4, kernel_topk_pruned.pruned_fused_topk_plain,
                               [("L2", (qpad, fst.vecs_blk, fst.bsq_blk,
                                        fst.sqnorm, fmask, k, True, 1, True),
                                 codec),
                                ("IP", (qpad, fst.vecs_blk, fst.bsq_blk,
                                        fst.sqnorm, fmask, k, False, 1,
                                        True), codec),
                                ("filter", (qpad, fst.vecs_blk, fst.bsq_blk,
                                            fst.sqnorm, filt, k, True, 1,
                                            True), codec),
                                ("fewer valid rows than k",
                                 (qpad, fst.vecs_blk, fst.bsq_blk,
                                  fst.sqnorm, few, k, True, 1, True), codec),
                                ("d 100, dblk 20: scalar loads",
                                 (sq_small, to_blocked(srows, sdb),
                                  block_sqnorms(sf32, sdb),
                                  (sf32 * sf32).sum(1), svalid, k, True, 1,
                                  True), scodec)])
        b3_args = (vprobes, qpad, qpsq, ivf._buckets, ivf._bucket_bsq,
                   ivf._bucket_sqnorm)
        cases[f"B3-{tier}"] = (b3, kernel_ivf_pruned.ivf_pruned_topk_plain,
                               [("L2", b3_args + (view.bucket_valid,
                                                  view.bucket_slot, k_eff,
                                                  True, 1, True), icodec),
                                ("IP", b3_args + (view.bucket_valid,
                                                  view.bucket_slot, k_eff,
                                                  False, 1, True), icodec),
                                ("filter", b3_args + (bfilt,
                                                      view.bucket_slot,
                                                      k_eff, True, 1, True),
                                 icodec),
                                ("fewer valid rows than k",
                                 b3_args + (bfew, view.bucket_slot, k_eff,
                                            True, 1, True), icodec),
                                ("d 100, dblk 20: scalar loads",
                                 (svp, sq_small,
                                  query_prefix_sqnorms(sq_small, sdb), sbk,
                                  bucket_block_sqnorms(sbk32, sdb),
                                  (sbk32 * sbk32).sum(-1),
                                  torch.ones((32, 128), dtype=torch.bool,
                                             device=dev), sslot, k_eff,
                                  True, 1, True), scodec)])
        if tier == "bf16":
            cases["B1-bf16"] = (b1, kernel_topk.fused_topk_plain, [
                ("L2", (qpad, fst.vecs, fst.sqnorm, fmask, k, True), {}),
                ("IP", (qpad, fst.vecs, fst.sqnorm, fmask, k, False), {}),
                ("filter", (qpad, fst.vecs, fst.sqnorm, filt, k, True), {}),
                ("fewer valid rows than k",
                 (qpad, fst.vecs, fst.sqnorm, few, k, True), {}),
                ("d 100: scalar loads", (sq_small, srows,
                                         (sf32 * sf32).sum(1), svalid, k,
                                         True), {})])
            b2_args = (vprobes, qpad, ivf._buckets, ivf._bucket_sqnorm)
            cases["B2-bf16"] = (b2, kernel_ivf.ivf_list_topk_plain, [
                ("L2", b2_args + (view.bucket_valid, view.bucket_slot,
                                  k_eff, True), {}),
                ("IP", b2_args + (view.bucket_valid, view.bucket_slot,
                                  k_eff, False), {}),
                ("filter", b2_args + (bfilt, view.bucket_slot, k_eff,
                                      True), {}),
                ("fewer valid rows than k",
                 b2_args + (bfew, view.bucket_slot, k_eff, True), {}),
                ("d 100: scalar loads", (svp, sq_small, sbk,
                                         (sbk32 * sbk32).sum(-1),
                                         torch.ones((32, 128),
                                                    dtype=torch.bool,
                                                    device=dev), sslot,
                                         k_eff, True), {})])
        for name, (kern, plain, cs) in cases.items():
            ok_all, err_all, frac = True, 0.0, None
            for tag, a_, kw in cs:
                b4.count_tiles = b3.count_staged = True
                kout = kern(*a_, **kw)
                b4.count_tiles = b3.count_staged = False
                staged = b3.staged if name.startswith("B3") else None
                pout = plain(*a_, **kw)
                ok, err = kernel_parity(kout[0], kout[1], pout[0], pout[1])
                if len(kout) == 3:
                    ok = ok and stats_ok(kout[2], pout[2])
                    kf, pf = (pruned_fraction(kout[2]),
                              pruned_fraction(pout[2]))
                    if tag == "L2":
                        frac = (kf, pf)
                        if staged is not None:
                            b3_staged_report(
                                name, int(staged), kout[2], a_[0],
                                int(a_[3].shape[1]), int(a_[2].shape[1]),
                                (1.0 - kf, 1.0 - pf))
                    if tag in ("L2", "IP"):
                        tiles = b4_tiles_text(b4, kout[2]) \
                            if name.startswith("B4") else ""
                        print(f"{name} {tag}: scanned fraction kernel "
                              f"{1 - kf:.4f}, plain {1 - pf:.4f}{tiles}",
                              flush=True)
                check(ok, f"{name} kernel == plain, {tag} (max abs err "
                          f"{err:.3g})")
                ok_all, err_all = ok_all and ok, max(err_all, err)
            arms[name] = {"ok": ok_all, "err": err_all, "frac": frac,
                          "run": (kern, cs[0][1], cs[0][2]),
                          "ip": (kern, cs[1][1], cs[1][2]),
                          "plain": (plain, cs[0][1], cs[0][2])}

    # -- timings: the six arms alternating in each round --------------------
    # (and B4's tier arms against B1-bf16 on IP, where little prunes)
    names = list(arms)
    runs = {nm: arms[nm]["run"] for nm in names}
    for nm in ("B1-bf16", "B4-bf16", "B4-sq8"):
        runs[f"{nm} IP"] = arms[nm]["ip"]
    order = list(runs)
    reads = {nm: [] for nm in order}
    for r in range(ROUNDS):
        for nm in order[r % len(order):] + order[:r % len(order)]:
            kern, a_, kw = runs[nm]
            reads[nm].append(time_ms(lambda: kern(*a_, **kw), torch))
    for tier in TIERS:
        for tag in ("", " IP"):
            print(f"[{card}] B4-{tier} against B1-bf16, "
                  f"{'IP' if tag else 'L2'}: B4-{tier} "
                  f"{spread_text(reads[f'B4-{tier}{tag}'])}, B1-bf16 "
                  f"{spread_text(reads[f'B1-bf16{tag}'])}; "
                  + b4_ratio_text(reads, f"B4-{tier}{tag}", f"B1-bf16{tag}"),
                  flush=True)
    for tier in TIERS:
        print(f"[{card}] B3-{tier} against B2-bf16 (B2 has no sq8 arm), "
              f"L2: " + b4_ratio_text(reads, f"B3-{tier}", "B2-bf16"),
              flush=True)
    entries = []
    for nm in names:
        plain, a_, kw = arms[nm]["plain"]
        # B4's plain version, ~2 s a call: one timed call, warmed by the
        # parity runs above
        slow, b4_arm = nm.startswith(("B3", "B4")), nm.startswith("B4")
        plain_ms = time_ms(lambda: plain(*a_, **kw), torch,
                           iters=1 if b4_arm else 3 if slow else 5,
                           warmup=0 if b4_arm else 1 if slow else 2)
        bound, by, shape = tier_bound(nm, a_, arms[nm]["frac"], batch, d)
        med, lo, hi = median_spread(reads[nm])
        print(f"[{card}] {nm} {shape}: {spread_text(reads[nm])}, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})"
              + ("" if arms[nm]["frac"] is None else
                 f"; pruned fraction kernel {arms[nm]['frac'][0]:.4f}, "
                 f"plain {arms[nm]['frac'][1]:.4f}"), flush=True)
        e = {"name": ARM_NAMES[nm], "route": "cuda",
             "source": f"dingo_tpu_torch/csrc/{ARM_SOURCES[nm[:2]]}",
             "replaces": ARM_REPLACES[nm], "launches": launches[nm],
             "max_abs_err": arms[nm]["err"], "ms": med, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "parity": arms[nm]["ok"],
             "plain_arm_searches": plain_calls.get(nm, 0),
             "ms_min": lo, "ms_max": hi}
        if arms[nm]["frac"] is not None:
            e["pruned_fraction"], e["plain_pruned_fraction"] = \
                arms[nm]["frac"]
        entries.append(e)
    return entries


def tier_bound(name, a_, frac, batch, d):
    """(bound ms, "bytes"/"operations", shape text) of one tier arm on its
    timed inputs: each input byte read once (the pruned arms: row bytes
    times the smaller scanned fraction of kernel and plain version, plus
    the metadata no pruning skips), each output written once; the f32
    FMAs of B3-bf16 on the f32 peak, the bf16 x bf16 products of
    B4-bf16 and the sq8 arms on the bf16 tensor-core peak, and B1-bf16's
    and B2-bf16's three bf16 products there too."""
    bf16_ops = name in ("B4-bf16", "B4-sq8", "B3-sq8")
    peak = PEAK_BF16_FLOPS if bf16_ops else PEAK_F32_FLOPS
    # B1-bf16 and B2-bf16: three bf16 products (the query's parts) on the
    # tensor cores
    passes = 1
    if name in ("B1-bf16", "B2-bf16"):
        peak, passes = PEAK_BF16_FLOPS, SPLIT_PASSES
    f = 1.0 if frac is None else max(0.0, 1.0 - max(frac))
    if name.startswith(("B1", "B4")):
        q, x = a_[0], a_[1]
        n = int(x.shape[1]) if x.dim() == 3 else int(x.shape[0])
        k = int(a_[5] if name.startswith("B4") else a_[4])
        item = x.element_size()
        nblk = int(x.shape[0]) if x.dim() == 3 else 0
        nbytes = (n * d * item * f + n * (4 + 1 + 4 * nblk)
                  + batch * (d + nblk) * 4 + batch * k * 8)
        ops = 2.0 * batch * n * d * f
        shape = f"b={batch} n={n} d={d} k={k}"
    else:
        vp = a_[0].cpu().numpy()
        buckets = a_[3] if name.startswith("B3") else a_[2]
        cap, item = int(buckets.shape[1]), buckets.element_size()
        k = int(a_[8] if name.startswith("B3") else a_[6])
        nbuck = len(np.unique(vp[vp >= 0]))
        npairs = int((vp >= 0).sum())
        nblk = int(a_[4].shape[1]) if name.startswith("B3") else 0
        nbytes = (nbuck * cap * d * item * f
                  + nbuck * cap * (4 + 1 + 4 + 4 * nblk)
                  + batch * (d + nblk) * 4 + vp.size * 4 + batch * k * 8)
        ops = 2.0 * npairs * cap * d * f
        shape = (f"b={batch} budget={vp.shape[1]} cap={cap} d={d} k={k} "
                 f"distinct buckets={nbuck}")
    bound, by = bound_of(nbytes, passes * ops, peak)
    return bound, by, shape


#: the region phase: a region replicated three ways (a dingo-store region's
#: default replica count), three StoreNodes on LocalTransport on the one
#: card bound to one in-process coordinator, which creates the region and
#: delivers it by heartbeats. The raft timeouts are longer than the
#: in-process tests' so that a 4,096-row apply on a raft thread does not
#: look like a dead leader. The sweep's other keys serve the region's index
#: read-only under REGION_ALIASES (below the coordinator's region ids)
REGION_ALIASES = (2, 3, 4)
REGION_PEERS = ("s0", "s1", "s2")
REGION_RAFT = {"election_timeout": (1.0, 2.0), "heartbeat_interval": 0.1}
#: proposals of VECTOR_MAX_BATCH_COUNT rows (engine/storage.py), ascending
#: ids: SortedKv.put appends for ascending keys
REGION_PROPOSAL_ROWS = 4096
REGION_NPROBE = 32


def region_phase(x, queries, extra, gt, nlist, card, dev,
                 before_cluster=None) -> dict:
    """The replicated region path at full width and depth: a coordinator
    and three StoreNodes, an IVF_FLAT region created by the coordinator
    and delivered by heartbeats; the rows go through the leader's
    Storage.vector_add as raft proposals; untrained searches through every
    replica's Storage (the reader's brute-force scan, B4); each replica's
    VectorIndexManager.rebuild (engine scan, train, build); trained
    searches on B3 (recall, replicas agree, region path against
    wrapper-direct); IndexService(node) on the leader serving
    pipeline_sweep traffic while upserts and deletes are proposed (each
    visible on the leader when acknowledged and on a follower once it has
    applied the write's log index; no dispatch falls back to the sync
    path); one B3 launch of a region search against its plain version; the
    reader's dispatch under the sync-debug mode; then the cluster phase on
    the same region (cluster_phase: split check, split, merge, leader
    transfer); then the leader's node stops and the survivors hold the
    acknowledged state. Returns the phase's numbers, each kernel's
    launches in it, and the cluster phase's numbers under "cluster"."""
    import resource
    import threading

    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.coordinator.control import CoordinatorControl
    from dingo_tpu_torch.engine import raft_engine
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.vector_reader import VectorReader
    from dingo_tpu_torch.ops import kernel_ivf_pruned, kernel_topk_pruned
    from dingo_tpu_torch.ops.distance import Metric
    from dingo_tpu_torch.raft import LocalTransport, NotLeader
    from dingo_tpu_torch.server.services import IndexService
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionType

    n, d = x.shape
    k = 10
    t_phase = time.perf_counter()
    # every arm's launch counter, zeroed: the phase's own launches
    counters = zero_launches()
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    b4 = kernel_topk_pruned.pruned_fused_topk
    out: dict = {}

    # the share of time the raft threads spend in apply, per store
    apply_s = {sid: 0.0 for sid in REGION_PEERS}
    orig_apply = raft_engine.apply_write

    def timed_apply(engine, region, data, log_id=0, context=None,
                    want_result=True):
        t = time.perf_counter()
        try:
            return orig_apply(engine, region, data, log_id, context=context,
                              want_result=want_result)
        finally:
            if context.store_id in apply_s:     # not the ladder's FLAT store
                apply_s[context.store_id] += time.perf_counter() - t

    raft_engine.apply_write = timed_apply
    transport = LocalTransport()
    coord = CoordinatorControl(MemEngine(), replication=len(REGION_PEERS))
    nodes = {sid: StoreNode(sid, transport, coord,
                            raft_kw={"seed": i, **REGION_RAFT}, device=dev)
             for i, sid in enumerate(REGION_PEERS)}
    definition = coord.create_region(
        vcodec.encode_vector_key(0, 0), vcodec.encode_vector_key(1),
        region_type=RegionType.INDEX, index_parameter=IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=d, metric=Metric.L2,
            ncentroids=nlist, default_nprobe=REGION_NPROBE))
    rid = definition.region_id
    for nd in nodes.values():              # the CREATE commands
        nd.heartbeat_once()
    regions = {sid: nd.get_region(rid) for sid, nd in nodes.items()}
    check(all(r is not None for r in regions.values())
          and sorted(definition.peers) == sorted(REGION_PEERS),
          f"region: the coordinator placed region {rid} on "
          f"{definition.peers} and the heartbeats created it on every store")
    live_peers = list(REGION_PEERS)

    def raft(sid):
        return nodes[sid].engine.get_node(rid)

    def leader(timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            lead = [s for s in live_peers if raft(s).is_leader()]
            if len(lead) == 1:
                return lead[0]
            time.sleep(0.02)
        raise SmokeFailure("region phase: no unique raft leader")

    def on_leader(fn, attempts=20):
        """fn(node, region) on the leader, retried on NotLeader (the
        reference tests' pattern); returns (leader, fn's result)."""
        for _ in range(attempts):
            sid = leader()
            try:
                return sid, fn(nodes[sid], regions[sid])
            except NotLeader:
                time.sleep(0.1)
        raise SmokeFailure("region phase: leadership never stabilized")

    def settle(timeout=300.0):
        # every entry any replica knows committed: after a leader change
        # the new leader's commit index can lag one the old leader acked
        leader()
        target = max(raft(s).commit_index for s in live_peers)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(raft(s).last_applied >= target for s in live_peers):
                return
            time.sleep(0.02)
        raise SmokeFailure("region phase: replicas did not apply the "
                           "leader's commit index")

    def search(sid, q, **kw):
        return nodes[sid].storage.vector_batch_search(regions[sid], q, k,
                                                      **kw)

    def ids_of(rows):
        return [[v.id for v in row] for row in rows]

    try:
        # -- ingest: 4,096-row proposals in ascending ids, under the JAX
        # package's defaults (the integrity ledger folds every write) ------
        FLAGS.set("integrity_enabled", True)
        print(f"[{card}] region phase: integrity_enabled True for the "
              "ingest (the JAX package's default)", flush=True)
        # the table rows (the TABLE filter phase's) are encoded before
        # the ingest's clock starts: it measures the write
        t0 = time.perf_counter()
        cols, trows = table_rows(n)
        print(f"[{card}] region phase: {n} table rows (cat BIGINT, price "
              f"DOUBLE, tag VARCHAR) encoded in {time.perf_counter() - t0:.1f}"
              f" s, {np.mean([len(r_) for r_ in trows[:4096]]):.1f} bytes a "
              "row", flush=True)
        leader()
        t0 = time.perf_counter()
        for lo in range(0, n, REGION_PROPOSAL_ROWS):
            hi = min(n, lo + REGION_PROPOSAL_ROWS)
            ids = np.arange(lo, hi, dtype=np.int64)
            on_leader(lambda nd, r, ids=ids, lo=lo, hi=hi:
                      nd.storage.vector_add(r, ids, x[lo:hi],
                                            table_values=trows[lo:hi]))
        ingest_s = time.perf_counter() - t0
        lead = leader()
        settle()
        settled_s = time.perf_counter() - t0
        out["ingest_rows_per_s"] = n / ingest_s
        out["apply_share"] = {s: apply_s[s] / ingest_s for s in REGION_PEERS}
        print(f"[{card}] region ingest: {n} rows in "
              f"{-(-n // REGION_PROPOSAL_ROWS)} proposals of "
              f"{REGION_PROPOSAL_ROWS} through the leader's "
              f"Storage.vector_add, 3 replicas: {ingest_s:.1f} s, "
              f"acknowledged {out['ingest_rows_per_s']:.1f} rows/s (with a "
              "table row each; without them: PERF.md section 6); every "
              f"replica applied at {settled_s:.1f} s; apply time / ingest "
              "wall " + ", ".join(
                  f"{s}{' (leader)' if s == lead else ''} "
                  f"{out['apply_share'][s]:.4f}" for s in REGION_PEERS),
              flush=True)
        counts = {s: regions[s].vector_index_wrapper.get_count()
                  for s in REGION_PEERS}
        check(all(c == n for c in counts.values()),
              f"region: every replica's index holds the {n} rows {counts}")

        # -- untrained: the reader's brute-force scan on B4 -------------------
        # (its temporary FLAT indexes measure no plane: no ledger for them)
        FLAGS.set("integrity_enabled", False)
        print(f"[{card}] region phase: integrity_enabled False for the "
              "untrained brute-force searches (temporary FLAT indexes)",
              flush=True)
        # on two of the three replicas (a depth cut for the smoke's clock:
        # 8.3-8.6 s a replica)
        bf_peers = REGION_PEERS[:2]
        l4 = b4.launches
        t0 = time.perf_counter()
        with first_launch(kernel_topk_pruned, "pruned_fused_topk") as b4_call:
            untrained = {s: ids_of(search(s, queries)) for s in bf_peers}
        bf_s = (time.perf_counter() - t0) / len(bf_peers)
        print(f"[{card}] region untrained search (reader brute force: "
              f"engine scan into a temporary FLAT, B4), 64 queries: "
              f"{bf_s:.2f} s a replica, B4 launches {b4.launches - l4}",
              flush=True)
        check(b4.launches > l4, "region untrained: the brute-force scan "
              "ran on B4")
        for s in bf_peers:
            check(same_modulo_ties(x, queries, untrained[s], gt),
                  f"region untrained: {s} ids == numpy exact top-{k} "
                  "modulo ties")
        check(all(same_modulo_ties(x, queries, untrained[s],
                                   untrained[bf_peers[0]])
                  for s in bf_peers),
              "region untrained: the replicas agree (exactly equal: "
              f"{all(untrained[s] == untrained[bf_peers[0]] for s in bf_peers)})")
        # the first brute-force B4 launch against its plain version (the
        # wrapper passes the sq8 codec where the plain version takes block)
        if b4_call:
            a_, kw_, (kv, ki, _) = b4_call[0]
            pv, pi, _ = kernel_topk_pruned.pruned_fused_topk_plain(
                *a_[:9], **dict(zip(("sq_vmin", "sq_scale"), a_[9:])), **kw_)
            ok, err = kernel_parity(kv, ki, pv, pi)
        else:
            ok, err = False, float("nan")
        b4_call = a_ = None
        out["b4_parity"] = (ok, err)
        check(ok, "region: a brute-force search's B4 launch == its plain "
              f"version (max abs err {err:.3e})")

        # -- train: each replica's VectorIndexManager.rebuild -----------------
        # (the ledger on again: the rebuilt indexes carry it into the
        # observability phase)
        FLAGS.set("integrity_enabled", True)
        print(f"[{card}] region phase: integrity_enabled True from the "
              "rebuilds through the observability phase", flush=True)
        builds = {}
        for s in REGION_PEERS:
            t0 = time.perf_counter()
            nodes[s].index_manager.rebuild(regions[s], raft_log=raft(s).log)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            st = dict(nodes[s].index_manager.build_stats[rid])
            st["total_ms"] = (time.perf_counter() - t0) * 1e3
            builds[s] = st
            print(f"[{card}] region rebuild {s}: {st['rows']} rows, engine "
                  f"scan {st['scan_ms'] / 1e3:.2f} s, index ingest "
                  f"{st['ingest_ms'] / 1e3:.2f} s, train "
                  f"{st['train_ms'] / 1e3:.2f} s, whole rebuild "
                  f"{st['total_ms'] / 1e3:.2f} s", flush=True)
        out["rebuild"] = builds
        print(f"[{card}] region with the integrity ledger on: acknowledged "
              f"ingest {out['ingest_rows_per_s']:.1f} rows/s (without it, "
              "PERF.md section 5: 24906.3), rebuild a replica " + ", ".join(
                  f"{s_} {b_['total_ms'] / 1e3:.2f} s"
                  for s_, b_ in builds.items())
              + " (without it: 10.81 s)", flush=True)
        fails = METRICS.counter("build.train_failures",
                                region_id=rid).get()
        check(fails == 0 and all(
            regions[s].vector_index_wrapper.own_index.is_trained()
            for s in REGION_PEERS),
            f"region: build.train_failures {fails}, every replica trained")

        # -- trained: B3 ------------------------------------------------------
        l3 = b3.launches
        trained = {s: ids_of(search(s, queries, nprobe=REGION_NPROBE))
                   for s in REGION_PEERS}
        check(b3.launches > l3, "region trained: the search ran on B3")
        rec = {s: sum(len(set(r) & set(g.tolist()))
                      for r, g in zip(trained[s], gt)) / (len(gt) * k)
               for s in REGION_PEERS}
        out["recall"] = rec
        print(f"[{card}] region trained search nprobe {REGION_NPROBE}: "
              f"recall@{k} " + ", ".join(f"{s} {v:.4f}"
                                        for s, v in rec.items()), flush=True)
        check(min(rec.values()) >= 0.95,
              f"region trained: recall@{k} >= 0.95 on every replica")
        check(all(trained[s] == trained[REGION_PEERS[0]]
                  for s in REGION_PEERS),
              "region trained: the three replicas return the same ids")

        # region path against wrapper-direct, the same 64-query batch
        w = regions[lead].vector_index_wrapper
        fns = {"region path": lambda: search(lead, queries,
                                             nprobe=REGION_NPROBE),
               "wrapper-direct": lambda: w.search(queries, k,
                                                  nprobe=REGION_NPROBE)}
        for fn in fns.values():
            fn()
        reads = {nm: [] for nm in fns}
        order = list(fns)
        for r in range(ROUNDS):
            for nm in order[r % 2:] + order[:r % 2]:
                t0 = time.perf_counter()
                for _ in range(10):
                    fns[nm]()
                reads[nm].append((time.perf_counter() - t0) * 100.0)
        out["region_ms"] = median_spread(reads["region path"])[0]
        out["wrapper_ms"] = median_spread(reads["wrapper-direct"])[0]
        print(f"[{card}] region path against wrapper-direct, 64 queries, "
              f"k {k}, nprobe {REGION_NPROBE} (host ms a search, results on "
              f"the host): region {spread_text(reads['region path'])}, "
              f"wrapper {spread_text(reads['wrapper-direct'])}; per-round "
              "ratio median " + f"{np.median(np.divide(reads['region path'], reads['wrapper-direct'])):.4f}",
              flush=True)

        # -- TABLE filters: the coprocessor over the table CF, B3 under the
        # candidates' mask ---------------------------------------------------
        out["table"], launches_ = phase_launches(
            lambda: table_phase(nodes, regions, lead, live_peers, x, queries,
                                cols, trows, card, dev, on_leader, settle))
        out["table"]["launches"] = launches_
        cols = trows = None
        print(f"[{card}] table phase launches {launches_}", flush=True)
        check(launches_["ivf_pruned_topk"] > 0,
              "table phase: the TABLE-filtered searches ran on B3")

        # -- writes under coalesced load --------------------------------------
        pool_rng = np.random.default_rng(29)
        pool = (x[pool_rng.choice(n, 1024, replace=False)] + 0.05
                * pool_rng.standard_normal((1024, d), dtype=np.float32)
                ).astype(np.float32)
        kw = {"nprobe": REGION_NPROBE}
        dispatches = {"async": 0, "sync_fallback": 0}
        orig_async = VectorReader.vector_batch_search_async

        def spy_async(self, *a, **kw_):
            thunk = orig_async(self, *a, **kw_)
            dispatches["sync_fallback" if thunk.__name__ == "sync_thunk"
                       else "async"] += 1
            return thunk

        wid = np.arange(n, n + CO_WRITE_ROWS, dtype=np.int64)
        rows_w = extra[:CO_WRITE_ROWS]
        done = threading.Event()
        errors: list = []
        seen = {"leader": 0, "follower": 0, "gone": 0}

        def visible(sid, i) -> bool:
            row = search(sid, rows_w[i:i + 1], **kw)[0]
            return bool(row) and row[0].id == wid[i]

        def writer():
            try:
                for lo in range(0, CO_WRITE_ROWS, CO_WRITE_CHUNK):
                    sl = slice(lo, lo + CO_WRITE_CHUNK)
                    sid, _ = on_leader(lambda nd, r: nd.storage.vector_add(
                        r, wid[sl], rows_w[sl]))
                    lid = raft(sid).commit_index
                    seen["leader"] += visible(sid, lo)
                    for f in live_peers:
                        if f == sid:
                            continue
                        deadline = time.monotonic() + 60
                        while raft(f).last_applied < lid and \
                                time.monotonic() < deadline:
                            time.sleep(0.005)
                        seen["follower"] += visible(f, lo)
                for lo in range(0, CO_DELETE_ROWS, CO_WRITE_CHUNK):
                    sl = slice(lo, lo + CO_WRITE_CHUNK)
                    sid, _ = on_leader(lambda nd, r: nd.storage.vector_delete(
                        r, wid[sl]))
                    seen["gone"] += not visible(sid, lo)
            except Exception as e:  # noqa: BLE001 — reported by the check
                errors.append(repr(e))
            finally:
                done.set()

        # the sweep's CO_KEYS keys: the region's index also served, read
        # only, under REGION_ALIASES on the leader (the same engine rows)
        keys = (rid,) + REGION_ALIASES[:CO_KEYS - 1]
        for r_ in keys[1:]:
            alias_region(nodes[lead], r_, regions[lead])
        saved = set_flags(FLAGS, pipeline_enabled="true", pipeline_depth=2)
        VectorReader.vector_batch_search_async = spy_async
        svc = IndexService(nodes[lead], window_ms=CO_WINDOW_MS,
                           max_batch=CO_MAX_BATCH)
        try:
            closed_loop(svc, pool, k, kw, 0.5, keys=keys)          # warm
            base = svc._get_coalescer().stage_totals()
            l3 = b3.launches
            t = threading.Thread(target=writer, name="smoke-region-writer",
                                 daemon=True)
            t.start()
            rows, wall, lat = closed_loop(svc, pool, k, kw, 0.0, stop=done,
                                          keys=keys)
            t.join(timeout=120)
            totals = svc._get_coalescer().stage_totals()
        finally:
            svc.close()
            VectorReader.vector_batch_search_async = orig_async
            for f_, v_ in saved.items():
                FLAGS.set(f_, v_)
            for r_ in keys[1:]:
                nodes[lead].meta.delete_region(r_)
        nchunk = CO_WRITE_ROWS // CO_WRITE_CHUNK
        out["coalesced"] = arm_report(
            "region IVF_FLAT (B3) on the leader", "pipelined depth 2, "
            f"{CO_WRITE_ROWS} upserts + {CO_DELETE_ROWS} deletes proposed",
            [{"rows": rows, "wall": wall, "lat": lat,
              "totals": {s_: totals.get(s_, 0.0) - base.get(s_, 0.0)
                         for s_ in totals}}], card)
        out["dispatches"] = dict(dispatches)
        print(f"[{card}] region writes under load: visible on the leader "
              f"when acknowledged {seen['leader']}/{nchunk}, on a follower "
              f"once applied {seen['follower']}/"
              f"{nchunk * (len(live_peers) - 1)}, deleted rows gone "
              f"{seen['gone']}/{CO_DELETE_ROWS // CO_WRITE_CHUNK}; reader "
              f"dispatches async {dispatches['async']}, sync fallback "
              f"{dispatches['sync_fallback']}; B3 launches while serving "
              f"{b3.launches - l3}", flush=True)
        check(not errors and not t.is_alive()
              and seen["leader"] == nchunk
              and seen["follower"] == nchunk * (len(live_peers) - 1)
              and seen["gone"] == CO_DELETE_ROWS // CO_WRITE_CHUNK,
              f"region writes under load: each write visible on the leader "
              f"when acknowledged and on every replica once applied "
              f"{errors}")
        check(dispatches["async"] > 0 and dispatches["sync_fallback"] == 0,
              "region coalesced: every dispatch took the reader's async "
              "arm")
        settle()
        live, dead = wid[CO_DELETE_ROWS:], wid[:CO_DELETE_ROWS]
        dead_ids = set(dead.tolist())
        for s in live_peers:
            found = leaked = 0
            for lo in range(0, len(live), 64):
                res = search(s, rows_w[CO_DELETE_ROWS + lo:
                                       CO_DELETE_ROWS + lo + 64], **kw)
                found += sum(bool(r) and r[0].id == i
                             for r, i in zip(res, live[lo:lo + 64]))
            for lo in range(0, CO_DELETE_ROWS, 64):
                res = search(s, rows_w[lo:lo + 64], **kw)
                leaked += sum(v.id in dead_ids for r in res for v in r)
            check(found == len(live) and leaked == 0,
                  f"region writes: {s} finds every live upsert by its own "
                  f"vector ({found}/{len(live)}) and no deleted id "
                  f"({leaked})")

        # -- one region search's B3 launch against its plain version ---------
        with first_launch(kernel_ivf_pruned, "ivf_pruned_topk") as captured:
            search(lead, queries, **kw)
        if captured:
            a_, kw_, (kv, ki, _) = captured[0]
            pv, pi, _ = kernel_ivf_pruned.ivf_pruned_topk_plain(*a_, **kw_)
            ok, err = kernel_parity(kv, ki, pv, pi)
        else:
            ok, err = False, float("nan")
        out["b3_parity"] = (ok, err)
        check(ok, f"region: a region search's B3 launch == its plain "
              f"version (max abs err {err:.3e})")

        # -- the reader's dispatch makes no host sync -------------------------
        on_leader(lambda nd, r: nd.storage.vector_add(
            r, np.asarray([n + CO_WRITE_ROWS], np.int64), rows_w[:1]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        sync_err = None
        try:
            thunk = nodes[lead].storage.vector_batch_search_async(
                regions[lead], queries, k, **kw)
        except Exception as e:  # noqa: BLE001 — reported by the check
            sync_err, thunk = repr(e), None
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        check(sync_err is None and thunk is not None
              and thunk.__name__ != "sync_thunk"
              and ids_of(thunk()) == ids_of(search(lead, queries, **kw)),
              "region: the reader's async dispatch makes no synchronizing "
              f"call and resolves to the sync search's ids {sync_err}")

        # -- device bytes and host memory -------------------------------------
        dbytes = {s: regions[s].vector_index_wrapper.own_index
                  .get_device_memory_size() for s in REGION_PEERS}
        out["device_bytes"] = dbytes
        out["peak_rss"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        print(f"[{card}] region memory: device bytes per replica "
              + ", ".join(f"{s} {v / 2**30:.3f} GiB"
                          for s, v in dbytes.items())
              + f"; peak host RSS of the process {out['peak_rss'] / 2**30:.2f}"
              " GiB", flush=True)

        # -- the cluster phase on this region ----------------------------------
        captured = a_ = kw_ = None         # B3's arguments hold the IVF view
        live_ids = np.concatenate([np.arange(n, dtype=np.int64),
                                   wid[CO_DELETE_ROWS:],
                                   [n + CO_WRITE_ROWS]])
        live_vecs = np.concatenate([x, rows_w[CO_DELETE_ROWS:],
                                    rows_w[:1]])
        # -- the observability planes on this region --------------------------
        out["obs"] = obs_phase(coord, nodes, regions, rid, live_ids,
                               live_vecs, queries, nlist, card, dev)
        recovery_quiet("obs phase", card)
        # -- the serving-edge cache, then the memory-tier ladder, on the
        # replica IndexService reads ----------------------------------------
        lead = leader()
        out["edge_cache"], launches_ = phase_launches(
            lambda: edge_cache_phase(coord, nodes, regions, rid, lead,
                                     live_ids, live_vecs, card, dev,
                                     on_leader))
        out["edge_cache"]["launches"] = launches_
        recovery_quiet("edge cache phase", card)
        settle()
        out["ladder"], launches_ = phase_launches(
            lambda: ladder_phase(coord, nodes, regions, rid, leader(),
                                 live_ids, live_vecs, queries, card, dev))
        out["ladder"]["launches"] = launches_
        print(f"[{card}] edge cache phase launches "
              f"{out['edge_cache']['launches']}; ladder phase launches "
              f"{out['ladder']['launches']}", flush=True)
        recovery_quiet("ladder phase", card)
        FLAGS.set("integrity_enabled", False)
        print(f"[{card}] cluster phase: integrity_enabled False (it "
              "measures no plane; indexes that carry a ledger keep "
              "folding their writes)", flush=True)
        if before_cluster is not None:
            # run() starts the HNSW writes phase's one-thread host inserts
            # here: with a core busy beside them, the ledger's fold and the
            # scrub ran 2-3.5x slower on the card's host (PERF.md section 6)
            before_cluster()
        l_before = read_launches(counters)
        out["cluster"] = cluster_phase(coord, nodes, rid, live_ids,
                                       live_vecs, extra, card, dev)
        live_ids = live_vecs = None
        out["cluster"]["launches"] = {
            name: v - l_before[name]
            for name, v in read_launches(counters).items()}
        print(f"[{card}] cluster phase launches "
              f"{out['cluster']['launches']}", flush=True)
        check(out["cluster"]["launches"]["ivf_pruned_topk"] > 0,
              "cluster phase: the share-served, own-index, sibling-merged "
              "and rebuilt searches ran on B3")
        lead = leader()

        # -- failover: the leader's node stops --------------------------------
        settle()
        want_ids = ids_of(search(lead, queries, **kw))
        want_count = out["cluster"]["count"]
        t0 = time.perf_counter()
        nodes[lead].stop()
        live_peers.remove(lead)
        new_lead = leader()
        elect_s = time.perf_counter() - t0
        got_count = {s: nodes[s].storage.vector_count(regions[s])
                     for s in live_peers}
        got_ids = {s: ids_of(search(s, queries, **kw)) for s in live_peers}
        on_leader(lambda nd, r: nd.storage.vector_add(
            r, np.asarray([n + CO_WRITE_ROWS + 1], np.int64), rows_w[1:2]))
        row = search(new_lead, rows_w[1:2], **kw)[0]
        print(f"[{card}] region failover: {lead} stopped, {new_lead} leads "
              f"after {elect_s:.2f} s; vector_count {got_count} (acknowledged "
              f"{want_count}); a write on the new leader visible "
              f"{bool(row) and row[0].id == n + CO_WRITE_ROWS + 1}",
              flush=True)
        check(all(c == want_count for c in got_count.values())
              and all(g == want_ids for g in got_ids.values())
              and bool(row) and row[0].id == n + CO_WRITE_ROWS + 1,
              "region failover: the survivors hold every acknowledged write "
              "(count and search ids) and take new writes")
        out["failover_s"] = elect_s
    finally:
        raft_engine.apply_write = orig_apply
        for s in REGION_PEERS:
            nodes[s].stop()
    out["launches"] = read_launches(counters)
    check(out["launches"]["ivf_pruned_topk"] > 0
          and out["launches"]["pruned_fused_topk"] > 0,
          f"region phase launched B3 and B4 {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] region phase launches {out['launches']}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


#: the TABLE filter phase's schema (cat BIGINT uniform in 0-99, price
#: DOUBLE uniform in [0, 1), tag VARCHAR of 7 values), its predicates
#: (selective ~5%, broad ~40%) and the post variant's topk values: 6
#: over-fetches 60 rows (<= K_MAX 64: B3), 10 over-fetches 100 (the k > 64
#: arm, ivf_scan_scores, as in the JAX package)
TABLE_TAGS = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta")
TABLE_PREDICATES = {
    "selective": (["lt", ["field", "cat"], ["const", 5]],
                  lambda c: c["cat"] < 5, "cat < 5"),
    "broad": (["and", ["lt", ["field", "cat"], ["const", 50]],
               ["ge", ["field", "price"], ["const", 0.2]]],
              lambda c: (c["cat"] < 50) & (c["price"] >= 0.2),
              "cat < 50 and price >= 0.2"),
}
TABLE_POST_TOPK = (6, 10)


def table_rows(n: int, seed: int = 41) -> tuple:
    """The region's table: numpy columns drawn from `seed` and each row's
    CoprocessorV2 encoding (serial typed values in schema order)."""
    from dingo_tpu_torch.coprocessor.coprocessor_v2 import encode_row

    rng = np.random.default_rng(seed)
    cols = {"cat": rng.integers(0, 100, n), "price": rng.random(n),
            "tag": rng.integers(0, len(TABLE_TAGS), n)}
    rows = [encode_row([c, p, TABLE_TAGS[t]]) for c, p, t in zip(
        cols["cat"].tolist(), cols["price"].tolist(), cols["tag"].tolist())]
    return cols, rows


def table_phase(nodes, regions, lead, live_peers, x, queries, cols, rows,
                card, dev, on_leader, settle) -> dict:
    """TABLE-filtered VectorSearch on the trained region at nprobe
    REGION_NPROBE, every flag at its default. The pre variant (one
    64-query batch a predicate) scans the table CF through the
    coprocessor into candidate ids, which B3 scans under their bucket
    mask; the post variant over-fetches topk x 10 and filters on the host.
    Checks: every returned id satisfies its predicate (numpy over the
    columns), pre recall@10 >= 0.95 against exact top-10 over the filtered
    rows, each post reply is the filtered prefix of the same index's
    unfiltered search at topk x 10, B3 launches in the pre variant and the
    topk-6 post variant, every replica's post replies agree, and a vector
    deleted through raft leaves a follower's pre-variant candidates (then
    comes back, with its table row)."""
    import torch

    from dingo_tpu_torch.coprocessor.coprocessor_v2 import (
        CoprocessorDef,
        CoprocessorV2,
        SchemaColumn,
    )
    from dingo_tpu_torch.index.ivf_flat import ivf_scan_scores
    from dingo_tpu_torch.index.vector_reader import (
        VectorFilterMode,
        VectorFilterType,
    )
    from dingo_tpu_torch.ops import kernel_ivf_pruned

    n = len(x)
    k = 10
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    schema = [SchemaColumn("cat", "BIGINT", 0),
              SchemaColumn("price", "DOUBLE", 1),
              SchemaColumn("tag", "VARCHAR", 2)]
    out: dict = {"pre": {}, "post": {}}
    t_phase = time.perf_counter()

    def cop(pred):
        return CoprocessorV2(CoprocessorDef(
            original_schema=schema, filter_expr=TABLE_PREDICATES[pred][0]))

    def table_search(sid, variant, pred, topk, stage=None):
        return nodes[sid].storage.vector_batch_search(
            regions[sid], queries, topk, nprobe=REGION_NPROBE,
            filter_mode=VectorFilterMode.TABLE,
            filter_type=(VectorFilterType.QUERY_PRE if variant == "pre"
                         else VectorFilterType.QUERY_POST),
            coprocessor=cop(pred), stage_us=stage)

    def ids_of(res):
        return [[v.id for v in row] for row in res]

    def satisfied(res, keep):
        return all(bool(keep[v.id]) for row in res for v in row)

    # the engine scan of the table CF alone: the pre variant's prefilter
    # time less this is the coprocessor's
    reader = nodes[lead].engine.new_vector_reader(regions[lead])
    t0 = time.perf_counter()
    scanned = sum(1 for _ in reader._scan_rows(reader._table,
                                               *reader.ctx.id_window()))
    scan_s = time.perf_counter() - t0
    out["table_rows"] = scanned
    out["scan_s"] = scan_s
    print(f"[{card}] table phase: the engine scan of the table CF, "
          f"{scanned} rows: {scan_s:.2f} s", flush=True)
    check(scanned == n, f"table phase: the table CF holds a row for each "
          f"of the {n} vectors ({scanned})")

    # the unfiltered search's B3 launch, for the device time beside the
    # masked one
    with first_launch(kernel_ivf_pruned, "ivf_pruned_topk") as plain_call:
        nodes[lead].storage.vector_batch_search(regions[lead], queries, k,
                                                nprobe=REGION_NPROBE)
    masks = {}
    first_pre = {}
    for pred, (_, keep_fn, text) in TABLE_PREDICATES.items():
        keep = np.asarray(keep_fn(cols))
        cand = int(keep.sum())
        stage: dict = {}
        l3 = b3.launches
        t0 = time.perf_counter()
        with first_launch(kernel_ivf_pruned, "ivf_pruned_topk") as call:
            res = table_search(lead, "pre", pred, k, stage)
        wall = time.perf_counter() - t0
        launched = b3.launches - l3
        got = ids_of(res)
        first_pre[pred] = got
        gt_f = exact_topk_masked(x, np.arange(n, dtype=np.int64), keep,
                                 queries, k, dev)
        rec = sum(len(set(r) & set(g.tolist()))
                  for r, g in zip(got, gt_f)) / (len(gt_f) * k)
        pre_s = stage["prefilter_us"] / 1e6
        cop_s = max(pre_s - scan_s, 1e-9)
        masked = int(call[0][0][6].sum()) if call else -1
        masks[pred] = call[0] if call else None
        out["pre"][pred] = {
            "candidates": cand, "recall": rec, "b3_launches": launched,
            "prefilter_s": pre_s, "coprocessor_s": cop_s,
            "coprocessor_rows_per_s": scanned / cop_s,
            "search_ms": stage["search_us"] / 1e3, "wall_s": wall,
            "mask_rows": masked}
        print(f"[{card}] table pre variant, {text}: {cand} candidates "
              f"({cand / n:.4f} of the rows), prefilter {pre_s:.2f} s "
              f"(engine scan {scan_s:.2f} s + coprocessor {cop_s:.2f} s, "
              f"{scanned / cop_s:.1f} rows/s), search "
              f"{stage['search_us'] / 1e3:.2f} ms a 64-query batch, whole "
              f"call {wall:.2f} s; B3 launches {launched}, its mask "
              f"{masked} rows; recall@{k} against exact over the filtered "
              f"rows {rec:.4f}", flush=True)
        check(launched > 0 and masked == cand,
              f"table pre {text}: B3 ran under the candidates' bucket mask "
              f"({masked} rows of {cand})")
        check(satisfied(res, keep) and all(len(r) == k for r in got),
              f"table pre {text}: every returned id satisfies the predicate")
        check(rec >= 0.95, f"table pre {text}: recall@{k} {rec:.4f} >= 0.95")
        # the post variant: over-fetch then filter on the host
        for topk in TABLE_POST_TOPK:
            over = ids_of(nodes[lead].storage.vector_batch_search(
                regions[lead], queries, topk * 10, nprobe=REGION_NPROBE))
            per = {}
            l3, lx = b3.launches, ivf_scan_scores.calls
            for sid in live_peers:
                stage = {}
                per[sid] = ids_of(table_search(sid, "post", pred, topk,
                                               stage))
                if sid == lead:
                    post_stage = stage
            arm = {"b3": b3.launches - l3,
                   "k_over_64": ivf_scan_scores.calls - lx}
            want = [[i for i in o if keep[i]][:topk] for o in over]
            out["post"][f"{pred}_{topk}"] = {
                "postfilter_s": post_stage["postfilter_us"] / 1e6,
                "search_ms": post_stage["search_us"] / 1e3,
                "launches": arm,
                "mean_len": float(np.mean([len(r) for r in per[lead]]))}
            print(f"[{card}] table post variant, {text}, topk {topk} "
                  f"(over-fetch {topk * 10}): postfilter "
                  f"{post_stage['postfilter_us'] / 1e3:.2f} ms, search "
                  f"{post_stage['search_us'] / 1e3:.2f} ms a batch, mean "
                  f"reply {out['post'][f'{pred}_{topk}']['mean_len']:.2f} "
                  f"ids; B3 launches {arm['b3']}, k > 64 arm "
                  f"{arm['k_over_64']} ({len(live_peers)} replicas)",
                  flush=True)
            check(all(per[sid] == want for sid in live_peers),
                  f"table post {text} topk {topk}: every replica's reply is "
                  f"the filtered prefix of the unfiltered top-{topk * 10}")
            check(all(keep[i] for r in per[lead] for i in r),
                  f"table post {text} topk {topk}: every returned id "
                  "satisfies the predicate")
            if topk * 10 <= kernel_ivf_pruned.K_MAX:
                check(arm["b3"] >= len(live_peers),
                      f"table post {text} topk {topk}: the over-fetch ran "
                      "on B3")
            else:
                check(arm["k_over_64"] >= len(live_peers),
                      f"table post {text} topk {topk}: the over-fetch of "
                      f"{topk * 10} took the k > 64 arm")
    # B3's device time under each mask beside the unfiltered launch (these
    # launches compare, they are not the main path's: the count is put back)
    l3 = b3.launches
    times = {}
    for tag, call in [("unfiltered", plain_call[0] if plain_call else None)] \
            + [(p_, masks[p_]) for p_ in TABLE_PREDICATES]:
        if call is None:
            continue
        a_, kw_, _ = call
        times[tag] = time_dev_ms(lambda a_=a_, kw_=kw_: b3(*a_, **kw_),
                                 torch)
    b3.launches = l3
    out["b3_ms"] = times
    print(f"[{card}] table phase: B3 device ms a 64-query launch at nprobe "
          f"{REGION_NPROBE}: " + ", ".join(
              f"{t_} {v:.4f}" for t_, v in times.items()), flush=True)
    plain_call = masks = None

    # a delete through raft leaves the candidate set: a follower's pre
    # variant after it is the leader's reply before it without that id
    sel = "selective"
    dead = first_pre[sel][0][0]
    on_leader(lambda nd, r: nd.storage.vector_delete(r, [dead]))
    settle()
    follower = next(sid for sid in live_peers if sid != lead)
    after = ids_of(table_search(follower, "pre", sel, k))
    ok = True
    for got_q, was_q in zip(after, first_pre[sel]):
        kept = [i for i in was_q if i != dead]
        ok = ok and dead not in got_q and got_q[:len(kept)] == kept
    check(ok, f"table phase: id {dead}, deleted through raft, left the "
          f"selective pre variant's candidates on {follower}, whose reply "
          "is the leader's before the delete without it")
    dead_arr = np.asarray([dead], np.int64)
    on_leader(lambda nd, r: nd.storage.vector_add(
        r, dead_arr, x[dead:dead + 1], table_values=[rows[dead]]))
    settle()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] table phase: {out['seconds']:.1f} s", flush=True)
    return out


#: the edge-cache phase: 4-row requests (pipeline_sweep's shape) drawn
#: Zipf(EDGE_ZIPF_S) from EDGE_QUERIES distinct queries, EDGE_REQUESTS of
#: them, CO_IN_FLIGHT in flight a round, served once with the cache off
#: and once with it on
EDGE_QUERIES, EDGE_REQUESTS, EDGE_ZIPF_S = 512, 4096, 1.1
#: rows of the FLAT region the ladder phase walks on a one-replica store:
#: 262,144 cut to 131,072 for the smoke's 1,200 s limit, then to 65,536
#: once the TABLE, LSM and transaction/document phases came in, and to
#: 32,768 once the chaos phase came in (PERF.md section 4)
LADDER_FLAT_N = 32_768
#: at each ladder rung, torch.cuda.memory_allocated() against the hbm
#: rung may exceed the serving index's device bytes against the fp32
#: index's by at most this much (small live buffers of the reader); a
#: replaced index still allocated exceeds it by its whole size
LADDER_ALLOC_SLACK = 128 << 20


def phase_launches(fn):
    """Run fn() with every kernel arm's launch count set to 0 just before
    it and read just after; the counts then go back to what they were plus
    fn's own, so an enclosing phase's totals stay whole. Returns (fn's
    result, {arm: launches in fn})."""
    counters = launch_counters()
    before = read_launches(counters)
    zero_launches()
    try:
        res = fn()
    finally:
        got = read_launches(counters)
        for kf, attr in counters:
            nm = kf.__name__ + attr[len("launches"):]
            setattr(kf, attr, before[nm] + got[nm])
    return res, got


def heartbeat_row(coord, node, rid):
    """The region's row of the coordinator's view after one heartbeat of
    `node` carrying a fresh metrics collection."""
    node.metrics._latest_mono = 0.0
    node.heartbeat_once()
    rows = {s: rm for s, _stale, rm in coord.get_region_metrics(rid)}
    return rows.get(node.store_id)


def edge_cache_phase(coord, nodes, regions, rid, lead, live_ids, live_vecs,
                     card, dev, on_leader) -> dict:
    """The serving-edge cache on the region phase's 1M-row IVF_FLAT region
    (B3, nprobe 32) through IndexService(node) on the leader: the same
    4,096-request Zipf sequence served with cache_enabled off, then on
    (rows/s, p50/p99, hit rate, B3 launches, kernel rows each); a sample
    of hits against a fresh dispatch of the same rows; a 4,096-row write
    that bumps the region's mutation_version, after which the same
    requests miss and then refill; 8 threads submitting identical rows in
    one window (kernel rows < rows submitted, every future the solo
    answer); the next heartbeat's cache_* fields against
    CACHE.region_stats."""
    import threading

    from dingo_tpu_torch.cache import edge as cache_edge
    from dingo_tpu_torch.cache.edge import CACHE
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.ops import kernel_ivf_pruned
    from dingo_tpu_torch.server.services import IndexService

    k = 10
    kw = {"nprobe": REGION_NPROBE}
    t_phase = time.perf_counter()
    out: dict = {}
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    node, region = nodes[lead], regions[lead]
    d = live_vecs.shape[1]
    rng = np.random.default_rng(41)
    pick = rng.choice(len(live_vecs), EDGE_QUERIES, replace=False)
    qset = (live_vecs[pick] + 0.05 * rng.standard_normal(
        (EDGE_QUERIES, d), dtype=np.float32)).astype(np.float32)
    p = 1.0 / np.arange(1, EDGE_QUERIES + 1) ** EDGE_ZIPF_S
    draws = rng.choice(EDGE_QUERIES, size=(EDGE_REQUESTS, CO_REQ_ROWS),
                       p=p / p.sum())
    reqs = [np.ascontiguousarray(qset[r]) for r in draws]
    kernel_rows = [0]
    st = node.storage
    orig_async, orig_sync = st.vector_batch_search_async, \
        st.vector_batch_search

    def spy_async(r_, q_, topk, **kw_):
        kernel_rows[0] += len(q_)
        return orig_async(r_, q_, topk, **kw_)

    def spy_sync(r_, q_, topk, **kw_):
        kernel_rows[0] += len(q_)
        return orig_sync(r_, q_, topk, **kw_)

    saved = set_flags(FLAGS, cache_enabled=False)
    st.vector_batch_search_async, st.vector_batch_search = spy_async, \
        spy_sync
    svc = IndexService(node, window_ms=CO_WINDOW_MS, max_batch=CO_MAX_BATCH)
    try:
        svc.submit(rid, reqs[0], k, **kw).result(timeout=60)      # warm

        def serve(tag):
            CACHE.reset()
            s0 = dict(CACHE.region_stats(rid))
            l3, kr = b3.launches, kernel_rows[0]
            lat: list = []
            t0 = time.perf_counter()
            for lo in range(0, EDGE_REQUESTS, CO_IN_FLIGHT):
                futs = []
                for q_ in reqs[lo:lo + CO_IN_FLIGHT]:
                    s = time.perf_counter()
                    f = svc.submit(rid, q_, k, **kw)
                    f.add_done_callback(lambda _f, s=s: lat.append(
                        (time.perf_counter() - s) * 1e3))
                    futs.append(f)
                for f in futs:
                    f.result(timeout=60)
            wall = time.perf_counter() - t0
            s1 = CACHE.region_stats(rid)
            hits = s1["hits"] - s0["hits"]
            misses = s1["misses"] - s0["misses"]
            r_ = {"rows_per_s": EDGE_REQUESTS * CO_REQ_ROWS / wall,
                  "p50_ms": float(np.percentile(lat, 50)),
                  "p99_ms": float(np.percentile(lat, 99)),
                  "hit_rate": hits / max(1, hits + misses),
                  "b3_launches": b3.launches - l3,
                  "kernel_rows": kernel_rows[0] - kr, "wall_s": wall}
            print(f"[{card}] edge cache {tag}: {EDGE_REQUESTS} requests of "
                  f"{CO_REQ_ROWS} rows (Zipf s {EDGE_ZIPF_S} over "
                  f"{EDGE_QUERIES} queries), {r_['rows_per_s']:.1f} rows/s, "
                  f"request p50 {r_['p50_ms']:.3f} ms, p99 "
                  f"{r_['p99_ms']:.3f} ms, hit rate {r_['hit_rate']:.4f} "
                  f"({hits} hits, {misses} misses), B3 launches "
                  f"{r_['b3_launches']}, kernel rows {r_['kernel_rows']}, "
                  f"{wall:.2f} s", flush=True)
            return r_

        out["off"] = serve("off")
        FLAGS.set("cache_enabled", True)
        out["on"] = serve("on")
        check(out["on"]["hit_rate"] > 0.5 and out["off"]["hit_rate"] == 0
              and out["on"]["kernel_rows"] < out["off"]["kernel_rows"],
              "edge cache: the cache-on run hits (rate "
              f"{out['on']['hit_rate']:.4f}) and dispatches fewer kernel rows "
              f"({out['on']['kernel_rows']} against "
              f"{out['off']['kernel_rows']})")

        # -- hits against a fresh dispatch of the same rows -----------------
        sample = [reqs[i] for i in range(0, EDGE_REQUESTS, 128)]
        kr = kernel_rows[0]
        hit_rows = [svc.submit(rid, q_, k, **kw).result(timeout=60)
                    for q_ in sample]
        served_by_cache = kernel_rows[0] == kr
        fresh = [orig_sync(region, q_, k, **kw) for q_ in sample]
        same_ids = all([[v.id for v in r] for r in a]
                       == [[v.id for v in r] for r in b]
                       for a, b in zip(hit_rows, fresh))
        err = max(abs(u.distance - v.distance) for a, b in zip(hit_rows, fresh)
                  for ra, rb in zip(a, b) for u, v in zip(ra, rb))
        print(f"[{card}] edge cache: {len(sample)} sampled requests served "
              f"from the cache without a kernel row {served_by_cache}; ids "
              f"== a fresh dispatch of the same rows {same_ids}, distances "
              f"max abs diff {err:.3e}", flush=True)
        check(served_by_cache and same_ids and err <= 1e-4,
              "edge cache: every sampled hit equals a fresh dispatch of the "
              "same rows (ids equal, distances within 1e-4)")

        # -- a write bumps the version: miss, then refill --------------------
        v0 = cache_edge.region_version(region)
        wsel = np.arange(0, len(live_ids), len(live_ids) // REGION_PROPOSAL_ROWS
                         )[:REGION_PROPOSAL_ROWS]
        on_leader(lambda nd, r: nd.storage.vector_add(
            r, live_ids[wsel], live_vecs[wsel]))
        deadline = time.monotonic() + 60
        while cache_edge.region_version(region) == v0 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        v1 = cache_edge.region_version(region)
        s0 = dict(CACHE.region_stats(rid))
        for q_ in sample:
            svc.submit(rid, q_, k, **kw).result(timeout=60)
        s1 = dict(CACHE.region_stats(rid))
        for q_ in sample:
            svc.submit(rid, q_, k, **kw).result(timeout=60)
        s2 = CACHE.region_stats(rid)
        nrow = len(sample) * CO_REQ_ROWS
        # a row repeated within the sample hits once an earlier request
        # refilled it (a repeat inside one request misses with it)
        seen: set = set()
        uniq = 0
        for q_ in sample:
            keys_ = [r.tobytes() for r in q_]
            uniq += sum(key_ not in seen for key_ in keys_)
            seen.update(keys_)
        print(f"[{card}] edge cache: a {len(wsel)}-row write (the live rows' "
              f"own vectors) moved mutation_version {v0} -> {v1}; the "
              f"sampled requests ({uniq} of their {nrow} rows first seen) then "
              f"missed {s1['misses'] - s0['misses']} rows and hit "
              f"{s1['hits'] - s0['hits']}, then hit "
              f"{s2['hits'] - s1['hits']}/{nrow} (refilled)", flush=True)
        check(v1 > v0 and s1["misses"] - s0["misses"] == uniq
              and s1["hits"] - s0["hits"] == nrow - uniq
              and s2["hits"] - s1["hits"] == nrow,
              "edge cache: a write bumps the version, the same queries miss "
              "(each row until a request refills it) and then refill")

        # -- in-flight dedupe: 8 threads, identical rows, one window --------
        fresh_q = (qset[:CO_REQ_ROWS] + np.float32(0.011)).astype(np.float32)
        solo = [[v.id for v in r] for r in orig_sync(region, fresh_q, k,
                                                     **kw)]
        svc2 = IndexService(node, window_ms=50.0, max_batch=CO_MAX_BATCH)
        try:
            svc2.submit(rid, reqs[1], k, **kw).result(timeout=60)   # warm
            kr = kernel_rows[0]
            c0 = CACHE.region_stats(rid)["dedup_collapsed"]
            futs: list = []
            lock = threading.Lock()
            go = threading.Event()

            def client():
                go.wait()
                f = svc2.submit(rid, fresh_q, k, **kw)
                with lock:
                    futs.append(f)

            ths = [threading.Thread(target=client) for _ in range(8)]
            for t_ in ths:
                t_.start()
            go.set()
            for t_ in ths:
                t_.join()
            got = [[[v.id for v in r] for r in f.result(timeout=60)]
                   for f in futs]
            dispatched = kernel_rows[0] - kr
            collapsed = CACHE.region_stats(rid)["dedup_collapsed"] - c0
        finally:
            svc2.close()
        print(f"[{card}] edge cache dedupe: 8 threads x {CO_REQ_ROWS} "
              f"identical rows in one window: kernel rows {dispatched} of "
              f"{8 * CO_REQ_ROWS} submitted, dedup_collapsed {collapsed}; "
              f"every future == the solo answer "
              f"{all(g == solo for g in got)}", flush=True)
        check(len(got) == 8 and dispatched < 8 * CO_REQ_ROWS
              and all(g == solo for g in got),
              "edge cache dedupe: fewer kernel rows than submitted, every "
              "future resolves to the solo answer")

        # -- the heartbeat's cache_* fields -----------------------------------
        rm = heartbeat_row(coord, node, rid)
        cs = CACHE.region_stats(rid)
        print(f"[{card}] edge cache heartbeat: cache_hits {rm.cache_hits}, "
              f"cache_misses {rm.cache_misses}, cache_entries "
              f"{rm.cache_entries}; CACHE.region_stats {cs}", flush=True)
        check((rm.cache_hits, rm.cache_misses, rm.cache_entries)
              == (cs["hits"], cs["misses"], cs["entries"]),
              "edge cache: the next heartbeat's cache_* fields == "
              "CACHE.region_stats")
    finally:
        svc.close()
        del st.vector_batch_search_async, st.vector_batch_search
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
        CACHE.reset()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] edge cache phase: {out['seconds']:.1f} s", flush=True)
    return out


class _LiveRows:
    """Rows of the region's live set by external id (`x[ids]` for
    same_modulo_ties); `ids` sorted ascending."""

    def __init__(self, ids, vecs):
        self.ids, self.vecs = ids, vecs

    def __getitem__(self, ids):
        return self.vecs[np.searchsorted(self.ids, ids)]


def reader_ms(node, region, queries, k, kw, reps=20) -> float:
    """ms a 64-query batch through the node's reader, pipelined: `reps`
    dispatches (vector_batch_search_async), then their resolves, over the
    wall with the card synchronized."""
    import torch

    for th in [node.storage.vector_batch_search_async(region, queries, k,
                                                      **kw)
               for _ in range(2)]:
        th()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thunks = [node.storage.vector_batch_search_async(region, queries, k,
                                                     **kw)
              for _ in range(reps)]
    for th in thunks:
        th()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def ladder_phase(coord, nodes, regions, rid, lead, live_ids, live_vecs,
                 queries, card, dev) -> dict:
    """The memory-tier ladder on the replica IndexService reads (the
    leader's) of the region phase's 1M x 768 IVF_FLAT region, tier_enabled
    on and the integrity ledger on (the digest gate): down hbm -> hbm_sq8
    through a coordinator TIER_DEMOTE and the store's memory_tier tick,
    then hbm_sq8 -> host_sq8 -> mmap_sq8; up mmap_sq8 -> host_sq8 through
    a tick under search traffic above tier_promote_qps, then host_sq8 ->
    hbm_sq8 -> hbm by direct promote. At each rung the transition's
    seconds, device bytes (tensor_bytes) and the memory_allocated delta
    (gated: it follows the serving index's device bytes, so every replaced
    index was freed; memory_reserved printed), host and mmap bytes, ms a
    64-query batch through the reader, recall@10
    against the exact top-10 of the live rows, and the next heartbeat's
    serving_tier. B3-sq8 at hbm_sq8 against its plain version; no B3/B4
    launch on the host rungs; the mmap file gone after the promotion; ids
    after the round trip against those before it and the other replicas';
    the six tier events and 0 orphans. Then ladder_flat_phase."""
    import gc
    import threading

    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.coordinator.control import RegionCmd, RegionCmdType
    from dingo_tpu_torch.index.tiering import TIERING, HostSqFlat, TierRunner
    from dingo_tpu_torch.ops import kernel_ivf_pruned
    from dingo_tpu_torch.server.services import IndexService

    k = 10
    kw = {"nprobe": REGION_NPROBE}
    t_phase = time.perf_counter()
    out: dict = {"rungs": {}}
    node, region = nodes[lead], regions[lead]
    w = region.vector_index_wrapper
    rows_by_id = _LiveRows(live_ids, live_vecs)
    exact = live_ids[exact_topk_device(live_vecs, queries, k, dev)]
    saved = set_flags(FLAGS, tier_enabled=True, integrity_enabled=True)
    print(f"[{card}] ladder phase: tier_enabled True, integrity_enabled "
          "True (the digest gate)", flush=True)

    def ids_of(rows):
        return [[v.id for v in r] for r in rows]

    def recall(got):
        return sum(len(set(g) & set(e.tolist()))
                   for g, e in zip(got, exact)) / (len(exact) * k)

    gc.collect()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    before = ids_of(node.storage.vector_batch_search(region, queries, k,
                                                     **kw))
    others = {s: ids_of(nodes[s].storage.vector_batch_search(
        regions[s], queries, k, **kw)) for s in nodes if s != lead}

    #: the fp32 index's device bytes, read at the hbm rung
    dbytes0 = w.own_index.get_device_memory_size()

    def rung_report(name, secs, full=True):
        """The rung's numbers and checks; `full` False (the way up) runs
        one search for recall instead of the timed batches."""
        gc.collect()
        torch.cuda.synchronize()
        own = w.own_index
        dbytes = own.get_device_memory_size()
        alloc = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        host = own.get_memory_size() if isinstance(own, HostSqFlat) else 0
        st_ = TIERING._regions.get(rid)
        path = st_.mmap_path if st_ is not None else None
        fbytes = os.path.getsize(path) if path and os.path.exists(path) \
            else 0

        def searches():
            if not full:
                t0 = time.perf_counter()
                res = node.storage.vector_batch_search(region, queries, k,
                                                       **kw)
                return res, [(time.perf_counter() - t0) * 1e3]
            if isinstance(own, HostSqFlat):
                ts = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    res = node.storage.vector_batch_search(region, queries,
                                                           k, **kw)
                    ts.append((time.perf_counter() - t0) * 1e3)
                return res, ts
            res = node.storage.vector_batch_search(region, queries, k, **kw)
            return res, [reader_ms(node, region, queries, k, kw)]

        (res, ts), launches = phase_launches(searches)
        got = ids_of(res)
        rec = recall(got)
        rm = heartbeat_row(coord, node, rid)
        r_ = {"seconds": secs, "device_bytes": dbytes,
              "alloc_delta": alloc - alloc0, "reserved": reserved,
              "host_bytes": host,
              "mmap_bytes": fbytes, "ms": ts, "recall": rec,
              "serving_tier": rm.serving_tier, "launches": launches,
              "ids": got}
        out["rungs"][name if full else name + " up"] = r_
        kern = {a: v for a, v in launches.items() if v}
        lock_ms = getattr(own, "max_lock_ms", None)
        print(f"[{card}] ladder rung {name}: transition {secs:.2f} s; device "
              f"bytes {dbytes}, memory_allocated {alloc / 2**30:.2f} GiB "
              f"({(alloc - alloc0) / 2**30:+.2f} against hbm; the serving "
              f"index's device bytes {(dbytes - dbytes0) / 2**30:+.2f} "
              f"against the fp32 index's), memory_reserved "
              f"{reserved / 2**30:.2f} GiB, host bytes "
              f"{host}, mmap file bytes {fbytes}; ms a 64-query batch "
              + ("(one search, timed) " + f"{ts[0]:.1f}" if not full
                 else "(two batches, timed) " + ", ".join(f"{t:.1f}"
                                                         for t in ts)
                 if isinstance(own, HostSqFlat)
                 else f"(pipelined through the reader) {ts[0]:.4f}")
              + f"; recall@{k} {rec:.4f}; heartbeat serving_tier "
              f"{rm.serving_tier}; kernel launches {kern or 'none'}"
              + (f"; longest device_lock hold of a host scan {lock_ms:.1f} ms"
                 if lock_ms is not None else ""), flush=True)
        check(rec >= 0.95, f"ladder {name}: recall@{k} >= 0.95")
        check(alloc - alloc0 <= dbytes - dbytes0 + LADDER_ALLOC_SLACK,
              f"ladder {name}: memory_allocated against hbm <= the serving "
              f"index's device bytes against the fp32 index's + "
              f"{LADDER_ALLOC_SLACK >> 20} MiB (every replaced index freed)")
        check(rm.serving_tier == name,
              f"ladder {name}: the next heartbeat's serving_tier == the rung")
        if isinstance(own, HostSqFlat):
            check(dbytes == 0 and not any(
                launches[a] for a in launches
                if a.startswith(("ivf_pruned_topk", "pruned_fused_topk"))),
                f"ladder {name}: device bytes 0 and no B3/B4 launch on the "
                "host rung")
        return r_

    def timed(fn):
        t0 = time.perf_counter()
        rep = fn()
        return rep, time.perf_counter() - t0

    try:
        rung_report("hbm", 0.0)
        # -- down: the coordinator's TIER_DEMOTE, then the memory_tier tick --
        coord._queue_cmd(lead, RegionCmd(
            cmd_id=coord._next_cmd(), region_id=rid,
            cmd_type=RegionCmdType.TIER_DEMOTE))
        node.heartbeat_once()
        flagged = TIERING.state().get(rid, {}).get("advisory", False)
        runner = TierRunner(node)

        def tick():
            runner.tick()
            runner._worker.join()
            return runner.ticks

        _, secs = timed(tick)
        check(flagged and TIERING.region_tier(rid) == "hbm_sq8",
              "ladder: the coordinator's TIER_DEMOTE flagged the region and "
              "the store's memory_tier tick demoted it to hbm_sq8")
        with first_launch(kernel_ivf_pruned, "ivf_pruned_topk") as captured:
            node.storage.vector_batch_search(region, queries, k, **kw)
        if captured:
            a_, kw_, (kv, ki, _) = captured[0]
            pv, pi, _ = kernel_ivf_pruned.ivf_pruned_topk_plain(*a_, **kw_)
            ok, err = kernel_parity(kv, ki, pv, pi)
            sq8 = a_[3].dtype == torch.uint8      # the buckets hold codes
        else:
            ok, err, sq8 = False, float("nan"), False
        captured = a_ = kw_ = kv = ki = pv = pi = None
        out["b3_sq8_parity"] = (ok, err)
        r_ = rung_report("hbm_sq8", secs)
        check(ok and sq8 and r_["launches"].get("ivf_pruned_topk_sq8", 0) > 0,
              "ladder hbm_sq8: the region's searches launched B3-sq8, and "
              f"its launch == the plain version (max abs err {err:.3e})")
        for name in ("host_sq8", "mmap_sq8"):
            rep, secs = timed(lambda: TIERING.demote(node, region))
            check(rep.get("ok"), f"ladder: demote to {name} {rep}")
            rung_report(name, secs)
        mmap_path = TIERING._regions[rid].mmap_path
        # -- up: mmap -> host through a tick under search traffic -----------
        svc = IndexService(node, window_ms=CO_WINDOW_MS,
                           max_batch=CO_MAX_BATCH)
        stop = threading.Event()
        served = [0]

        def traffic():
            i = 0
            while not stop.is_set():
                futs = [svc.submit(rid, queries[(i + j) % len(queries):
                                                (i + j) % len(queries) + 1],
                                   k, **kw) for j in range(CO_MAX_BATCH)]
                i += CO_MAX_BATCH
                for f in futs:
                    f.result(timeout=120)
                served[0] += len(futs)

        lat = METRICS.latency("vector_search", rid)
        want = float(FLAGS.get("tier_promote_qps"))
        t_ = threading.Thread(target=traffic, name="ladder-traffic",
                              daemon=True)
        t0 = time.perf_counter()
        t_.start()
        while lat.windowed_qps() <= 1.5 * want and \
                time.perf_counter() - t0 < 60:
            time.sleep(0.25)
        qps = lat.windowed_qps()
        stop.set()
        t_.join(timeout=180)
        svc.close()
        print(f"[{card}] ladder: {served[0]} one-row requests through "
              f"IndexService at the mmap rung in {time.perf_counter() - t0:.1f}"
              f" s, windowed search QPS {qps:.2f} (tier_promote_qps {want})",
              flush=True)
        _, secs = timed(tick)
        check(TIERING.region_tier(rid) == "host_sq8",
              f"ladder: the memory_tier tick under search traffic (windowed "
              f"QPS {qps:.2f}) promoted the region to host_sq8")
        rung_report("host_sq8", secs, full=False)
        print(f"[{card}] ladder mmap_sq8 -> host_sq8 (tick): the mmap file "
              f"gone {not os.path.exists(mmap_path)}", flush=True)
        check(not os.path.exists(mmap_path),
              "ladder: the mmap file is gone after the promotion")
        for name in ("hbm_sq8", "hbm"):
            rep, secs = timed(lambda: TIERING.promote(node, region))
            check(rep.get("ok"), f"ladder: promote to {name} {rep}")
            rung_report(name, secs, full=False)
        after = ids_of(node.storage.vector_batch_search(region, queries, k,
                                                        **kw))
        rec_after = recall(after)
        same_before = same_modulo_ties(rows_by_id, queries, after, before)
        same_others = all(same_modulo_ties(rows_by_id, queries, after, o)
                          for o in others.values())
        print(f"[{card}] ladder round trip: recall@{k} {rec_after:.4f}; ids "
              f"== before modulo ties {same_before} (exactly "
              f"{after == before}); == the other replicas' modulo ties "
              f"{same_others}", flush=True)
        check(same_before and same_others and rec_after >= 0.95,
              "ladder: ids after the round trip == those before it and the "
              "other two replicas' (modulo ties)")
        rm = heartbeat_row(coord, node, rid)
        evs = coord.cluster_events(region_id=rid, actor="tier")
        report = coord.explain_region_overrides(rid)
        moves = [(e.old, e.new) for e in evs]
        print(f"[{card}] ladder events {moves}; explain orphans "
              f"{report['orphans']}; serving_tier {rm.serving_tier}",
              flush=True)
        check(len(evs) == 6 and report["orphans"] == []
              and rm.serving_tier == "hbm",
              "ladder: cluster_events shows the six tier events, "
              "explain_region_overrides 0 orphans")
        out["events"] = moves
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    out["seconds_1m"] = time.perf_counter() - t_phase
    print(f"[{card}] ladder phase, the 1M region: {out['seconds_1m']:.1f} s",
          flush=True)
    out["flat"] = ladder_flat_phase(live_vecs, queries, card, dev)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] ladder phase: {out['seconds']:.1f} s", flush=True)
    return out


def ladder_flat_phase(x, queries, card, dev) -> dict:
    """The ladder on a FLAT region of LADDER_FLAT_N x 768 (the first rows
    of the live set, ids 0..n-1) on a one-replica store of its own
    coordinator, ingested through Storage: B4-sq8 at hbm_sq8 against its
    plain version; one digest refusal (a byte flipped at the `copied`
    hook of the hbm_sq8 -> host_sq8 transcription: TierRefused inside,
    tier.digest_refusals bumped, the old rung serving the same ids); the
    clean walk down to mmap_sq8 and back, host_sq8 -> hbm_sq8 by the
    staged put_codes pour (its rows/s); ids after the round trip against
    those before it; at every step memory_allocated follows the serving
    index's device bytes (each replaced index freed)."""
    import gc

    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.coordinator.control import CoordinatorControl
    from dingo_tpu_torch.engine.raw_engine import MemEngine
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index import tiering
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.tiering import TIERING, HostSqFlat
    from dingo_tpu_torch.ops import kernel_topk_pruned
    from dingo_tpu_torch.ops.distance import Metric
    from dingo_tpu_torch.raft import LocalTransport
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionType

    k = 10
    n = min(LADDER_FLAT_N, len(x))
    t_phase = time.perf_counter()
    out: dict = {"rungs": {}}
    saved = set_flags(FLAGS, tier_enabled=True, integrity_enabled=True)
    fcoord = CoordinatorControl(MemEngine(), replication=1)
    # a region id of its own: the ladder's state is keyed by region id
    while fcoord.next_region_id() < 2000:
        pass
    node = StoreNode("f0", LocalTransport(), fcoord,
                     raft_kw={"seed": 0, **REGION_RAFT}, device=dev)
    frid = None
    try:
        dfn = fcoord.create_region(
            vcodec.encode_vector_key(0, 0), vcodec.encode_vector_key(1),
            region_type=RegionType.INDEX, index_parameter=IndexParameter(
                index_type=IndexType.FLAT, dimension=x.shape[1],
                metric=Metric.L2))
        frid = dfn.region_id
        node.heartbeat_once()
        region = node.get_region(frid)
        deadline = time.monotonic() + 60
        while not node.engine.get_node(frid).is_leader():
            if time.monotonic() > deadline:
                raise SmokeFailure("ladder FLAT: no leader")
            time.sleep(0.02)
        t0 = time.perf_counter()
        for lo in range(0, n, REGION_PROPOSAL_ROWS):
            hi = min(n, lo + REGION_PROPOSAL_ROWS)
            node.storage.vector_add(region, np.arange(lo, hi, dtype=np.int64),
                                    x[lo:hi])
        ingest_s = time.perf_counter() - t0
        exact = exact_topk_device(x[:n], queries, k, dev)

        def ids_of(rows):
            return [[v.id for v in r] for r in rows]

        def search():
            return ids_of(node.storage.vector_batch_search(region, queries,
                                                           k))

        def recall(got):
            return sum(len(set(g) & set(e.tolist()))
                       for g, e in zip(got, exact)) / (len(exact) * k)

        before = search()
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        dbytes0 = region.vector_index_wrapper.own_index \
            .get_device_memory_size()
        print(f"[{card}] ladder FLAT: {n} x {x.shape[1]} rows through "
              f"Storage in {ingest_s:.1f} s on a one-replica store (region "
              f"{frid}); recall@{k} at hbm {recall(before):.4f}", flush=True)

        def step(kind, name):
            t0 = time.perf_counter()
            rep = getattr(TIERING, kind)(node, region)
            secs = time.perf_counter() - t0
            check(rep.get("ok"), f"ladder FLAT: {kind} to {name} {rep}")
            torch.cuda.synchronize()
            own = region.vector_index_wrapper.own_index
            (got, _), launches = phase_launches(lambda: (search(), None))
            rec = recall(got)
            dbytes = own.get_device_memory_size()
            gc.collect()
            torch.cuda.synchronize()
            alloc = torch.cuda.memory_allocated() - alloc0
            out["rungs"][f"{kind} {name}"] = {
                "seconds": secs, "recall": rec, "device_bytes": dbytes,
                "alloc_delta": alloc, "launches": launches}
            print(f"[{card}] ladder FLAT {kind} to {name}: {secs:.2f} s, "
                  f"device bytes {dbytes}, memory_allocated "
                  f"{alloc / 2**30:+.3f} GiB against hbm (the serving "
                  f"index's device bytes {(dbytes - dbytes0) / 2**30:+.3f}), "
                  f"recall@{k} {rec:.4f}, launches "
                  f"{ {a: v for a, v in launches.items() if v} or 'none'}",
                  flush=True)
            check(alloc <= dbytes - dbytes0 + LADDER_ALLOC_SLACK,
                  f"ladder FLAT {kind} to {name}: memory_allocated against "
                  f"hbm <= the serving index's device bytes against the "
                  f"fp32 index's + {LADDER_ALLOC_SLACK >> 20} MiB")
            if isinstance(own, HostSqFlat):
                check(dbytes == 0 and not any(
                    v for a, v in launches.items()
                    if a.startswith(("ivf_pruned_topk", "pruned_fused_topk"))),
                    f"ladder FLAT {name}: device bytes 0, no B3/B4 launch")
            return got, launches

        _, launches = step("demote", "hbm_sq8")
        with first_launch(kernel_topk_pruned, "pruned_fused_topk") as cap:
            search()
        if cap:
            a_, kw_, (kv, ki, _) = cap[0]
            pv, pi, _ = kernel_topk_pruned.pruned_fused_topk_plain(
                *a_[:9], **dict(zip(("sq_vmin", "sq_scale"), a_[9:])),
                **kw_)
            ok, err = kernel_parity(kv, ki, pv, pi)
            sq8 = a_[1].dtype == torch.uint8
        else:
            ok, err, sq8 = False, float("nan"), False
        cap = a_ = kw_ = kv = ki = pv = pi = None
        out["b4_sq8_parity"] = (ok, err)
        check(ok and sq8 and launches.get("pruned_fused_topk_sq8", 0) > 0,
              "ladder FLAT hbm_sq8: the region's searches launched B4-sq8, "
              f"and its launch == the plain version (max abs err {err:.3e})")
        # -- one digest refusal -------------------------------------------------
        at_sq8 = search()
        refusals0 = METRICS.counter("tier.digest_refusals",
                                    region_id=frid).get()
        raised = []

        def corrupt(stage, ctx=None):
            if stage == "copied" and ctx is not None:
                ctx.store.vecs[0, 0] ^= 1      # one flipped destination byte

        orig_verify = TIERING._verify_copy

        def verify(*a, **kw_):
            try:
                return orig_verify(*a, **kw_)
            except tiering.TierRefused as e:
                raised.append(e)
                raise

        TIERING.test_hook, TIERING._verify_copy = corrupt, verify
        try:
            rep = TIERING.demote(node, region)
        finally:
            TIERING.test_hook = None
            del TIERING._verify_copy
        refusals = METRICS.counter("tier.digest_refusals",
                                   region_id=frid).get() - refusals0
        still = search()
        print(f"[{card}] ladder FLAT digest refusal: report {rep}; "
              f"TierRefused raised {len(raised)}, tier.digest_refusals "
              f"+{refusals}; rung {TIERING.region_tier(frid)}, the same ids "
              f"{still == at_sq8}", flush=True)
        check(rep.get("ok") is False and raised and refusals == 1
              and TIERING.region_tier(frid) == "hbm_sq8" and still == at_sq8,
              "ladder FLAT: a byte flipped at the copied hook is refused "
              "(TierRefused, tier.digest_refusals + 1) and the old rung "
              "serves the same ids")
        step("demote", "host_sq8")
        step("demote", "mmap_sq8")
        step("promote", "host_sq8")
        pour = []
        orig_pour = TIERING._staged_put_codes

        def timed_pour(dstore, ids, codes):
            t0 = time.perf_counter()
            orig_pour(dstore, ids, codes)
            torch.cuda.synchronize()
            pour.append((len(ids), time.perf_counter() - t0))

        TIERING._staged_put_codes = timed_pour
        try:
            step("promote", "hbm_sq8")
        finally:
            del TIERING._staged_put_codes
        rows_, secs_ = pour[0] if pour else (0, float("nan"))
        out["pour_rows_per_s"] = rows_ / secs_
        print(f"[{card}] ladder FLAT host_sq8 -> hbm_sq8: the staged "
              f"put_codes pour of {rows_} rows in {secs_:.3f} s, "
              f"{out['pour_rows_per_s']:.1f} rows/s", flush=True)
        check(len(pour) == 1, "ladder FLAT: the promotion to hbm_sq8 took "
              "the staged put_codes pour")
        after, _ = step("promote", "hbm")
        same = same_modulo_ties(x, queries, after, before)
        print(f"[{card}] ladder FLAT round trip: ids == before modulo ties "
              f"{same} (exactly {after == before})", flush=True)
        check(same, "ladder FLAT: ids after the round trip == before "
              "(modulo ties)")
        node.metrics._latest_mono = 0.0
        node.heartbeat_once()
    finally:
        node.stop()
        if frid is not None:
            TIERING.forget_region(frid)
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] ladder FLAT: {out['seconds']:.1f} s", flush=True)
    return out


def launch_counters():
    """Every kernel arm's launch counter, as (wrapper, attribute)."""
    from dingo_tpu_torch.ops import (
        kernel_beam,
        kernel_ivf,
        kernel_ivf_pruned,
        kernel_pq,
        kernel_topk,
        kernel_topk_pruned,
    )

    return [(kf, attr) for kf in (
        kernel_topk.fused_topk, kernel_ivf.ivf_list_topk,
        kernel_ivf_pruned.ivf_pruned_topk,
        kernel_topk_pruned.pruned_fused_topk, kernel_pq.ivf_pq_adc_topk,
        kernel_pq.ivfpq_adc_lut, kernel_beam.candidate_scores)
        for attr in ("launches", "launches_bf16", "launches_sq8")
        if hasattr(kf, attr)]


def zero_launches() -> list:
    counters = launch_counters()
    for kf, attr in counters:
        setattr(kf, attr, 0)
    return counters


def read_launches(counters) -> dict:
    return {kf.__name__ + attr[len("launches"):]: getattr(kf, attr)
            for kf, attr in counters}


#: the cluster phase: on each side of the split, rows upserted (new
#: vectors for existing ids) and deleted while the child is served
#: through the parent's index, proposed in chunks
CLUSTER_UPSERTS, CLUSTER_DELETES, CLUSTER_CHUNK = 2048, 1024, 512


def exact_topk_masked(vecs, ids, mask, q, k: int, dev):
    """Exact L2 top-k ids (from `ids`) of q over the rows of `vecs` where
    `mask` holds, computed on `dev` in f32 in row chunks: the cluster
    phase's ground truth on a region's live rows."""
    import torch

    qt = torch.from_numpy(q).to(dev)
    qsq = (qt * qt).sum(1)
    best_d = best_i = None
    for lo in range(0, len(vecs), 262_144):
        sel = np.flatnonzero(mask[lo:lo + 262_144]) + lo
        if not len(sel):
            continue
        xt = torch.from_numpy(vecs[sel]).to(dev)
        d2 = qsq[:, None] - 2.0 * (qt @ xt.T) + (xt * xt).sum(1)[None, :]
        v, i = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False)
        i = torch.from_numpy(ids[sel]).to(dev)[i]
        if best_d is not None:
            v, pos = torch.topk(torch.cat([best_d, v], 1), k, dim=1,
                                largest=False)
            i = torch.cat([best_i, i], 1).gather(1, pos)
        best_d, best_i = v, i
    return best_i.cpu().numpy()


def cluster_phase(coord, nodes, rid, live_ids, live_vecs, extra, card,
                  dev) -> dict:
    """The in-process control plane on the region phase's trained region
    (BASELINE.json config 2 under a coordinator): one split_check tick
    (PreSplitChecker at split_check_approximate_keys, its default
    1,000,000: the checker proposes the median id to the coordinator),
    heartbeats deliver SPLIT and the raft group applies it on every
    replica; the child searched through the parent's shared index (recall
    @10 at nprobe 32 against exact top-10 over its range, equal ids on
    every replica); CLUSTER_UPSERTS upserts and CLUSTER_DELETES deletes
    proposed on each side while split, each visible when acknowledged and
    on every replica once applied; HOLD_VECTOR_INDEX on each replica in
    turn (the child's own index); coord.merge_region delivered by
    heartbeats; the sibling-merged search (== numpy's merge of the two
    indexes' answers, recall, replicas agree, no deleted id back);
    finish_merge_index on each replica in turn; then a leader transfer
    through the coordinator. `live_ids`/`live_vecs` are the region's rows
    (updated here as the phase writes). Returns the phase's numbers; the
    region's live row count under "count"."""
    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.coordinator.balance import BalanceLeaderScheduler
    from dingo_tpu_torch.coordinator.control import RegionCmd, RegionCmdType
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import FilterSpec
    from dingo_tpu_torch.raft import NotLeader
    from dingo_tpu_torch.raft.core import NOOP
    from dingo_tpu_torch.store.checker import PreSplitChecker

    k, kw = 10, {"nprobe": REGION_NPROBE}
    d = live_vecs.shape[1]
    sids = list(nodes)
    cuda = dev.type == "cuda"
    out: dict = {}
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        # the region phase's own peak, then this phase's
        out["region_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated() if cuda else 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def beat():
        for nd in nodes.values():
            nd.heartbeat_once()
        return True

    def wait(cond, what, timeout=120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.05)
        raise SmokeFailure(f"cluster phase: {what} within {timeout:.0f} s")

    def leader_of(r, timeout=60.0):
        got: list = []

        def one():
            got[:] = [s for s in sids
                      if (rn := nodes[s].engine.get_node(r)) is not None
                      and rn.is_leader()]
            return len(got) == 1

        wait(one, f"one raft leader of region {r}", timeout)
        return got[0]

    def on_leader(r, fn, attempts=20):
        for _ in range(attempts):
            s = leader_of(r)
            try:
                return s, fn(nodes[s], nodes[s].get_region(r))
            except NotLeader:
                time.sleep(0.1)
        raise SmokeFailure(f"cluster phase: region {r}'s leadership never "
                           "stabilized")

    def settle(r):
        # every entry any replica knows committed: after a leader change
        # the new leader's commit index can lag one the old leader acked
        leader_of(r)
        target = max(nodes[s].engine.get_node(r).commit_index for s in sids)
        wait(lambda: all(nodes[s].engine.get_node(r).last_applied >= target
                         for s in sids),
             f"every replica applied region {r}'s commit index", 300.0)

    def search(s, r, q):
        return nodes[s].storage.vector_batch_search(nodes[s].get_region(r),
                                                    q, k, **kw)

    def ids_of(rows):
        return [[v.id for v in row] for row in rows]

    def recall(got, gt):
        return sum(len(set(g_) & set(w_.tolist()))
                   for g_, w_ in zip(got, gt)) / (len(gt) * k)

    def replicas(r, q, gt, what):
        """Every replica's ids for q on region r: recall against gt on
        each, the replicas' ids equal. Returns the first replica's ids."""
        got = {s: ids_of(search(s, r, q)) for s in sids}
        rec = {s: recall(got[s], gt) for s in sids}
        same = all(got[s] == got[sids[0]] for s in sids)
        print(f"[{card}] cluster {what}: recall@{k} at nprobe "
              f"{REGION_NPROBE} " + ", ".join(f"{s} {v:.4f}"
                                              for s, v in rec.items())
              + f"; the replicas' ids equal {same}", flush=True)
        check(min(rec.values()) >= 0.95 and same,
              f"cluster {what}: recall@{k} >= 0.95 on every replica and "
              "the replicas return the same ids")
        out.setdefault("recall", {})[what] = rec
        return got[sids[0]]

    def timed(fn):
        fn()
        reads = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            reads.append((time.perf_counter() - t0) * 100.0)
        return reads

    def visibility(r, what, writes, on=None):
        """Each upsert found by its own vector (top-1 its id), no deleted
        id in the answer to its old vector, on every replica (or `on`)."""
        for s in on or sids:
            found = leaked = total_up = total_del = 0
            for up_pos, del_pos in writes:
                for lo in range(0, len(up_pos), 64):
                    p_ = up_pos[lo:lo + 64]
                    res = search(s, r, live_vecs[p_])
                    found += sum(bool(row) and row[0].id == i for row, i in
                                 zip(res, live_ids[p_]))
                for lo in range(0, len(del_pos), 64):
                    p_ = del_pos[lo:lo + 64]
                    dead = set(live_ids[p_].tolist())
                    res = search(s, r, live_vecs[p_])
                    leaked += sum(v.id in dead for row in res for v in row)
                total_up += len(up_pos)
                total_del += len(del_pos)
            check(found == total_up and leaked == 0,
                  f"cluster {what}: {s} finds every upsert by its own "
                  f"vector ({found}/{total_up}) and no deleted id "
                  f"({leaked} of {total_del} deleted rows answered)")

    alive = np.ones(len(live_ids), bool)
    rng = np.random.default_rng(41)
    beat()                      # the leader reports the region's leadership
    lead = leader_of(rid)

    # -- one split_check tick ------------------------------------------------
    count = int(alive.sum())
    flag = FLAGS.get("split_check_approximate_keys")
    lowered = count < flag
    if lowered:                 # a smaller run than config 2's million rows
        FLAGS.set("split_check_approximate_keys", count)
    try:
        t0 = time.perf_counter()
        proposals = PreSplitChecker(nodes[lead]).run()
        check_s = time.perf_counter() - t0
    finally:
        if lowered:
            FLAGS.set("split_check_approximate_keys", flag)
    t_split = time.perf_counter()
    median_id = int(np.sort(live_ids)[count // 2])
    split_key = vcodec.encode_vector_key(0, median_id)
    splits = [c for c in coord.jobs if c.cmd_type is RegionCmdType.SPLIT
              and c.region_id == rid]
    child = splits[-1].child_region_id if splits else None
    print(f"[{card}] cluster split check: region {rid} holds {count} rows, "
          f"split_check_approximate_keys {FLAGS.get('split_check_approximate_keys')}"
          + (f" (lowered to {count} for this smaller run)" if lowered else "")
          + f"; the checker proposed "
          + (", ".join(f"id {vcodec.decode_vector_key(p_.split_key)[1]}"
                       for p_ in proposals) or "nothing")
          + f" (numpy's median id {median_id}) in {check_s:.2f} s; the "
          f"coordinator queued SPLIT -> child {child}", flush=True)
    check(len(proposals) == 1 and proposals[0].region_id == rid
          and proposals[0].split_key == split_key and child is not None
          and (lowered or flag == 1_000_000),
          "cluster: the split checker proposed the median id by itself at "
          "the default split_check_approximate_keys (1,000,000)")
    if child is None:
        raise SmokeFailure("cluster phase: no split was queued")

    # -- heartbeats deliver SPLIT; the raft group applies it -----------------
    wait(lambda: beat() and all(nodes[s].get_region(child) is not None
                                for s in sids),
         "every replica hosts the child")
    lead_c = leader_of(child)
    out["split_s"] = time.perf_counter() - t_split
    parent_def, child_def = coord.regions[rid], coord.regions.get(child)
    shared = [nodes[s].get_region(child).vector_index_wrapper.share_index
              is not None for s in sids]
    print(f"[{card}] cluster split: every replica hosts child {child} "
          f"{out['split_s']:.2f} s after the proposal (its raft leader "
          f"{lead_c}); coordinator: parent epoch version "
          f"{parent_def.epoch.version}, child start == split key "
          f"{child_def is not None and child_def.start_key == split_key}; "
          f"child served through the parent's index on {sum(shared)}/3 "
          "replicas", flush=True)
    check(child_def is not None and child_def.start_key == split_key
          and parent_def.end_key == split_key and all(shared),
          "cluster split: the coordinator's map holds parent and child at "
          "the split key, every replica serves the child through the "
          "parent's index")

    # -- the child through the share -----------------------------------------
    in_child = live_ids >= median_id

    def near(mask):
        """64 queries near live rows where `mask` holds (the smoke's
        recipe: a stored row + 0.05 noise)."""
        rows_ = live_vecs[rng.choice(np.flatnonzero(mask), 64, replace=False)]
        return (rows_ + 0.05 * rng.standard_normal(
            (64, d), dtype=np.float32)).astype(np.float32)

    qc, qp = near(in_child), near(~in_child)
    replicas(child, qc, exact_topk_masked(live_vecs, live_ids,
                                          alive & in_child, qc, k, dev),
             "child through the share")
    replicas(rid, qp, exact_topk_masked(live_vecs, live_ids,
                                        alive & ~in_child, qp, k, dev),
             "parent after the split")

    # -- writes on each side while split ---------------------------------------
    writes = []
    lead_w = leader_of(rid)
    term_w = nodes[lead_w].engine.get_node(rid).current_term
    t0 = time.perf_counter()
    for side, r, in_side in (("parent", rid, ~in_child),
                             ("child", child, in_child)):
        cand = np.flatnonzero(alive & in_side)
        sel = rng.choice(cand, CLUSTER_UPSERTS + CLUSTER_DELETES,
                         replace=False)
        up_pos, del_pos = sel[:CLUSTER_UPSERTS], sel[CLUSTER_UPSERTS:]
        new = (extra[rng.integers(0, len(extra), CLUSTER_UPSERTS)]
               + 0.35 * rng.standard_normal((CLUSTER_UPSERTS, d),
                                            dtype=np.float32)
               ).astype(np.float32)
        seen_up = seen_del = 0
        for lo in range(0, CLUSTER_UPSERTS, CLUSTER_CHUNK):
            p_ = up_pos[lo:lo + CLUSTER_CHUNK]
            s, _ = on_leader(r, lambda nd, reg: nd.storage.vector_add(
                reg, live_ids[p_], new[lo:lo + CLUSTER_CHUNK]))
            row = search(s, r, new[lo:lo + 1])[0]
            seen_up += bool(row) and row[0].id == live_ids[p_[0]]
        live_vecs[up_pos] = new
        for lo in range(0, CLUSTER_DELETES, CLUSTER_CHUNK):
            p_ = del_pos[lo:lo + CLUSTER_CHUNK]
            s, _ = on_leader(r, lambda nd, reg: nd.storage.vector_delete(
                reg, live_ids[p_].tolist()))
            row = search(s, r, live_vecs[p_[:1]])[0]
            seen_del += live_ids[p_[0]] not in [v.id for v in row]
        alive[del_pos] = False
        writes.append((up_pos, del_pos))
        nup, ndel = CLUSTER_UPSERTS // CLUSTER_CHUNK, \
            CLUSTER_DELETES // CLUSTER_CHUNK
        print(f"[{card}] cluster writes while split, {side} side (region "
              f"{r}): {CLUSTER_UPSERTS} upserts and {CLUSTER_DELETES} "
              f"deletes in {CLUSTER_CHUNK}-row proposals; visible on the "
              f"leader when acknowledged {seen_up}/{nup}, deleted rows gone "
              f"{seen_del}/{ndel}", flush=True)
        check(seen_up == nup and seen_del == ndel,
              f"cluster writes ({side} side): each acknowledged write "
              "visible on the leader")
    out["writes_s"] = time.perf_counter() - t0
    settle(rid)
    settle(child)
    lead_s = leader_of(rid)
    rn = nodes[lead_s].engine.get_node(rid)
    noops = sum(rn.log.entry_at(i)[1] == NOOP
                for i in range(rn.log.first_index, rn.log.last_index() + 1))
    print(f"[{card}] cluster writes settled: region {rid}'s raft leader "
          f"{lead_w} (term {term_w}) at the writes, {lead_s} (term "
          f"{rn.current_term}) once every replica applied; no-op entries "
          f"in its log {noops} (a new leader appends one when its log "
          "runs past its commit index)", flush=True)
    visibility(rid, "parent side once applied", writes[:1])
    visibility(child, "child side once applied (through the share)",
               writes[1:])
    gt_c = exact_topk_masked(live_vecs, live_ids, alive & in_child, qc, k,
                             dev)
    replicas(child, qc, gt_c, "child through the share after the writes")
    reads_share = timed(lambda: search(lead_c, child, qc))

    # -- HOLD_VECTOR_INDEX: the child's own index, one replica at a time ------
    out["child_rebuild_s"] = {}
    for i, s in enumerate(sids):
        t0 = time.perf_counter()
        nodes[s].execute_region_cmd(RegionCmd(
            cmd_id=-(i + 1), region_id=child,
            cmd_type=RegionCmdType.HOLD_VECTOR_INDEX))
        sync()
        out["child_rebuild_s"][s] = time.perf_counter() - t0
        w = nodes[s].get_region(child).vector_index_wrapper
        check(w.share_index is None and w.own_index is not None
              and w.own_index.is_trained(),
              f"cluster: HOLD_VECTOR_INDEX gave {s}'s child its own trained "
              "index and dropped the share")
    print(f"[{card}] cluster child rebuild (HOLD_VECTOR_INDEX, one replica "
          "at a time): " + ", ".join(
              f"{s} {v:.2f} s" for s, v in out["child_rebuild_s"].items()),
          flush=True)
    replicas(child, qc, gt_c, "child on its own index")
    reads_own = timed(lambda: search(lead_c, child, qc))
    visibility(child, "child side on its own index", writes[1:],
               on=[lead_c])
    out["share_ms"] = median_spread(reads_share)[0]
    out["own_ms"] = median_spread(reads_own)[0]
    print(f"[{card}] cluster child search, 64 queries, k {k}, nprobe "
          f"{REGION_NPROBE} (host ms a search): through the parent's share "
          f"{spread_text(reads_share)}, on its own index "
          f"{spread_text(reads_own)}", flush=True)

    # -- merge back -------------------------------------------------------------
    end_key = parent_def.end_key if child_def is None else child_def.end_key
    t0 = time.perf_counter()
    coord.merge_region(rid, child)
    wait(lambda: beat() and child not in coord.regions and all(
        nodes[s].get_region(child) is None for s in sids),
         "the child merged into its parent on every replica")
    out["merge_s"] = time.perf_counter() - t0
    lead = leader_of(rid)
    sib = [nodes[s].get_region(rid).vector_index_wrapper.sibling_index
           is not None for s in sids]
    print(f"[{card}] cluster merge: child {child} absorbed on every replica "
          f"{out['merge_s']:.2f} s after coord.merge_region; parent end key "
          f"restored {coord.regions[rid].end_key == end_key}; sibling index "
          f"attached on {sum(sib)}/3 replicas", flush=True)
    check(coord.regions[rid].end_key == end_key and all(sib),
          "cluster merge: the parent covers the whole range again and "
          "serves the absorbed range through the sibling index")
    qm = np.concatenate([qp[:32], qc[:32]])
    gt_m = exact_topk_masked(live_vecs, live_ids, alive, qm, k, dev)
    merged = replicas(rid, qm, gt_m, "merged region through the sibling")
    # the sibling merge against numpy's merge of the two indexes' answers
    region = nodes[lead].get_region(rid)
    w = region.vector_index_wrapper
    spec = FilterSpec(ranges=[region.id_window()])
    a_ = w.own_index.search(qm, k, spec, **kw)
    b_ = w.sibling_index.active().search(qm, k, spec, **kw)
    want = []
    for ra, rb in zip(a_, b_):
        ids_ = np.concatenate([ra.ids, rb.ids])
        dist = np.concatenate([ra.distances, rb.distances])
        order = np.argsort(dist, kind="stable")
        keep = []
        for j in order:
            if ids_[j] >= 0 and ids_[j] not in keep:
                keep.append(int(ids_[j]))
        want.append(keep[:k])
    got = ids_of(search(lead, rid, qm))
    check(got == want and got == merged,
          "cluster merge: the sibling-merged search == numpy's merge of the "
          "own and sibling indexes' answers (each id once)")
    visibility(rid, "merged region through the sibling", writes)
    reads_merged = timed(lambda: search(lead, rid, qm))

    # -- finish_merge_index, one replica at a time ----------------------------
    out["merge_rebuild_s"] = {}
    for s in sids:
        t0 = time.perf_counter()
        nodes[s].finish_merge_index(rid)
        sync()
        out["merge_rebuild_s"][s] = time.perf_counter() - t0
        w = nodes[s].get_region(rid).vector_index_wrapper
        check(w.sibling_index is None and w.own_index.is_trained(),
              f"cluster: finish_merge_index rebuilt {s}'s index whole and "
              "dropped the sibling")
    print(f"[{card}] cluster merge rebuild (finish_merge_index, one "
          "replica at a time): " + ", ".join(
              f"{s} {v:.2f} s" for s, v in out["merge_rebuild_s"].items()),
          flush=True)
    rebuilt = replicas(rid, qm, gt_m, "merged region on its rebuilt index")
    visibility(rid, "merged region on its rebuilt index", writes,
               on=[lead])
    reads_rebuilt = timed(lambda: search(lead, rid, qm))
    out["merged_ms"] = median_spread(reads_merged)[0]
    out["rebuilt_ms"] = median_spread(reads_rebuilt)[0]
    print(f"[{card}] cluster merged-region search, 64 queries (host ms a "
          f"search): through the sibling merge {spread_text(reads_merged)}, "
          f"on the rebuilt index {spread_text(reads_rebuilt)}", flush=True)

    # -- a leader transfer through the coordinator -----------------------------
    beat()
    moved = BalanceLeaderScheduler(coord).dispatch()
    old = leader_of(rid)
    target = next(s for s in sids if s != old)
    if not moved:
        coord.transfer_leader(rid, target)
    t0 = time.perf_counter()
    wait(lambda: beat() and any(
        nodes[s].engine.get_node(rid).is_leader() for s in sids if s != old),
         "leadership moved off the old leader", 60.0)
    new = leader_of(rid)
    out["transfer_s"] = time.perf_counter() - t0
    after = ids_of(search(new, rid, qm))
    print(f"[{card}] cluster leader transfer: BalanceLeaderScheduler "
          f"dispatched {moved} (one region: nothing to balance), "
          f"coord.transfer_leader {old} -> {target}; {new} leads after "
          f"{out['transfer_s']:.2f} s; its search returns the rebuilt ids "
          f"{after == rebuilt}", flush=True)
    check(new != old and after == rebuilt,
          "cluster: leadership moved and the new leader's searches answer "
          "with the same ids")

    out["count"] = int(alive.sum())
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if cuda else 0.0)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] cluster phase: device peak {out['peak_gib']:.2f} GiB "
          f"({base_bytes / 2**30:.2f} GiB held at its start); "
          f"{out['seconds']:.1f} s", flush=True)
    if out["peak_gib"] > 60.0:
        print(f"[{card}] cluster phase: device holders (MiB) " + ", ".join(
            f"{nm_} {b_ / 2**20:.1f}" for nm_, b_ in sorted(
                device_holders(locals()).items(), key=lambda kv_: -kv_[1])),
            flush=True)
    recovery_quiet("cluster phase", card)
    return out


# -- HNSW on the card (BASELINE.json config 4) and the recovery ladder -------

#: the observability phase: scored batches a quality window, requests a
#: cost ladder point, seconds of overload for the shed ladder
OBS_WINDOW_BATCHES = 8
#: searches of the p99 without a scrub (the p99 during one takes as many as
#: the scrub's wall time allows, ~3,500)
OBS_CALM_SEARCHES = 300
OBS_COST_BURSTS = 24
OBS_OVERLOAD_S = 4.0


def obs_phase(coord, nodes, regions, rid, live_ids, live_vecs, queries,
              nlist, card, dev) -> dict:
    """The observability planes on the region phase's three replicas of
    config 2 (1M x 768, IVF_FLAT nlist 1024, B3) under its coordinator,
    at the JAX package's defaults (integrity, cost and events on):
    integrity (the replicas' heartbeat digests equal, one replica's full
    scrub with the search p99 beside it, a flipped byte in one replica's
    device rows named by the scrub, flagged by the coordinator, rebuilt
    by the recovery plane and cleared by a clean pass); quality (live
    recall intervals at nprobe 8 and 32 against numpy, shadow ids against
    numpy, shadow and served ms; the sq8 mirror arm is measured on the
    tier phase's sq8 index, sq8_mirror_arm); the SLO tuner's
    walk with its events and ``explain``; heat and cost; the HBM ledger
    and device peak; a flight bundle of a forced slow query; the shed
    ladder under overload; a scrape of the Prometheus sidecar. Returns
    the phase's numbers."""
    import re as re_
    import threading
    import urllib.request
    import warnings

    import torch

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.base import tensor_bytes
    from dingo_tpu_torch.index.recovery import RECOVERY
    from dingo_tpu_torch.metrics.http import MetricsHttpServer
    from dingo_tpu_torch.obs.cost import COST, kernel_id
    from dingo_tpu_torch.obs.flight import FLIGHT
    from dingo_tpu_torch.obs.hbm import HBM
    from dingo_tpu_torch.obs.heat import HEAT
    from dingo_tpu_torch.obs import integrity as integrity_mod
    from dingo_tpu_torch.obs.integrity import INTEGRITY
    from dingo_tpu_torch.obs.pressure import PRESSURE, ShedController
    from dingo_tpu_torch.obs.quality import QUALITY, ShadowOracle
    from dingo_tpu_torch.obs.sentinel import SENTINEL
    from dingo_tpu_torch.obs.tuner import SloTuner, ladder_values
    from dingo_tpu_torch.ops import kernel_ivf_pruned, shadow
    from dingo_tpu_torch.server.services import IndexService
    from dingo_tpu_torch.trace import TRACER

    k = 10
    t_phase = time.perf_counter()
    out: dict = {}
    peers = sorted(nodes)
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    l3_start = b3.launches
    shadow_start = shadow.shadow_exact_topk.calls
    print(f"[{card}] obs phase: integrity_enabled "
          f"{FLAGS.get('integrity_enabled')}, cost_enabled "
          f"{FLAGS.get('cost_enabled')}, events_enabled "
          f"{FLAGS.get('events_enabled')}, quality_sample_rate "
          f"{FLAGS.get('quality_sample_rate')}, heat_enabled "
          f"{FLAGS.get('heat_enabled')}, qos_enabled "
          f"{FLAGS.get('qos_enabled')} (the JAX package's defaults)",
          flush=True)

    def raft(sid):
        return nodes[sid].engine.get_node(rid)

    def leader():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            lead = [s for s in peers if raft(s).is_leader()]
            if len(lead) == 1:
                return lead[0]
            time.sleep(0.02)
        raise SmokeFailure("obs phase: no unique raft leader")

    def settle():
        target = raft(leader()).commit_index
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if all(raft(s).last_applied >= target for s in peers):
                return
            time.sleep(0.02)
        raise SmokeFailure("obs phase: replicas did not settle")

    def search(sid, q, **kw):
        return nodes[sid].storage.vector_batch_search(regions[sid], q, k,
                                                      **kw)

    def ids_of(rows):
        return [[v.id for v in row] for row in rows]

    def beat():
        for nd in nodes.values():
            nd.metrics._latest_mono = 0.0
            nd.heartbeat_once()

    def coord_rows():
        return {s: rm for s, _stale, rm in coord.get_region_metrics(rid)}

    def index_of(sid):
        return regions[sid].vector_index_wrapper.own_index

    qsub = queries[:16]
    cuda = dev.type == "cuda"
    exact_pos = exact_topk_device(live_vecs, queries, k, dev)
    exact_ids = live_ids[exact_pos]

    def recall_vs_exact(got, rows=None):
        want = exact_ids if rows is None else exact_ids[rows]
        return sum(len(set(g) & set(w.tolist()))
                   for g, w in zip(got, want)) / (len(want) * k)

    def exact_dists_live(q, ids):
        pos = np.searchsorted(live_ids, np.asarray(ids, np.int64))
        diff = live_vecs[pos].astype(np.float64) - q.astype(np.float64)
        return np.sort((diff * diff).sum(1))

    def ties_ok(got, q):
        for qi in range(len(q)):
            if set(got[qi]) == set(exact_ids[qi].tolist()):
                continue
            if not np.allclose(exact_dists_live(q[qi], got[qi]),
                               exact_dists_live(q[qi], exact_ids[qi]),
                               rtol=TIE_RTOL, atol=0.0):
                return False
        return True

    lead = leader()
    settle()
    follower = next(s for s in peers if s != lead)

    # -- integrity: replica digests, a scrub, a flipped byte ------------------
    beat()
    rows_ = coord_rows()
    digests = {s: rows_[s].integrity_digests for s in peers}
    applied = {s: rows_[s].integrity_applied_index for s in peers}
    print(f"[{card}] obs integrity: heartbeat digest vectors at applied "
          f"indices {applied}: " + "; ".join(
              f"{s} {digests[s]}" for s in peers), flush=True)
    check(all(digests[s] for s in peers)
          and len(set(digests.values())) == 1
          and len(set(applied.values())) == 1
          and coord.diverged_regions() == [],
          "obs integrity: the three replicas' heartbeat digests are equal "
          "at equal applied indices and diverged_regions() == []")

    fidx = index_of(follower)
    lat_scrub: list = []
    scrub_out: dict = {}

    def scrubber():
        scrub_out["res"] = INTEGRITY.scrub_index(fidx)

    search(follower, queries, nprobe=REGION_NPROBE)             # warm
    th = threading.Thread(target=scrubber, name="smoke-scrub", daemon=True)
    t0 = time.perf_counter()
    th.start()
    while th.is_alive():
        t1 = time.perf_counter()
        search(follower, queries, nprobe=REGION_NPROBE)
        lat_scrub.append((time.perf_counter() - t1) * 1e3)
    th.join()
    scrub_s = time.perf_counter() - t0
    lat_calm = []
    for _ in range(OBS_CALM_SEARCHES):
        t1 = time.perf_counter()
        search(follower, queries, nprobe=REGION_NPROBE)
        lat_calm.append((time.perf_counter() - t1) * 1e3)
    res = scrub_out["res"]
    out["scrub"] = {
        "seconds": scrub_s,
        "artifacts": {a: {key: r.get(key) for key in (
            "status", "slots", "seconds", "d2h_bytes", "max_lock_ms")}
            for a, r in res.items()},
        "p99_during_ms": float(np.percentile(lat_scrub, 99)),
        "p99_calm_ms": float(np.percentile(lat_calm, 99)),
        "searches_during": len(lat_scrub)}
    print(f"[{card}] obs integrity: full scrub of {follower}'s index "
          f"{scrub_s:.2f} s: " + "; ".join(
              f"{a} {r['status']} {r['slots']} slots {r['seconds']:.2f} s "
              f"({r['slots'] / max(r['seconds'], 1e-9):.1f} rows/s), D2H "
              f"{r['d2h_bytes']} B, longest device-lock hold "
              f"{r['max_lock_ms']:.2f} ms" for a, r in res.items())
          + f"; search p99 on {follower} during the scrub "
          f"{out['scrub']['p99_during_ms']:.3f} ms over "
          f"{len(lat_scrub)} searches, without one "
          f"{out['scrub']['p99_calm_ms']:.3f} ms over {len(lat_calm)}",
          flush=True)
    check(set(res) >= {"rows", "blocked", "ivf_buckets"}
          and all(r["status"] == "ok" for r in res.values()),
          "obs integrity: a full scrub of a replica finds every artifact "
          f"(rows, blocked, ivf_buckets) ok {sorted(res)}")

    def rows_pass(idx):
        """The scrub's pass over the `rows` artifact alone, from the
        plane's own reader and digest against the ledger, its verdict
        recorded as scrub_index records it (the flag the heartbeat
        carries). The other artifacts were scrubbed whole above."""
        led = INTEGRITY.ledger(idx)
        with led.lock:
            art = led.artifacts["rows"]
            version, muts = art.version, led.mutations
        t1 = time.perf_counter()
        actual, _fp, n = integrity_mod._digest_chunks(
            "rows", integrity_mod._iter_rows(idx, integrity_mod.SCRUB_CHUNK))
        secs = time.perf_counter() - t1
        with led.lock:
            raced = (led.pending or led.mutations != muts
                     or art.version != version)
            expected = art.digest.copy()
        status = ("raced" if raced else "ok" if actual == expected
                  else "mismatch")
        r = {"status": status, "slots": n, "seconds": secs,
             "expected": expected.hex(), "actual": actual.hex()}
        INTEGRITY._finish_scrub(idx.id, {"rows": r}, secs)
        return {"rows": r}

    slot = int(fidx.store.slots_of(np.asarray([int(exact_ids[0][0])],
                                              np.int64))[0])
    with fidx.store.device_lock:
        fidx.store.vecs.view(torch.int32)[slot, 0] ^= 1 << 24
    if cuda:
        torch.cuda.synchronize()
    res = rows_pass(fidx)
    beat()
    flagged = coord_rows()[follower].integrity_mismatch
    print(f"[{card}] obs integrity: one byte of row "
          f"{int(exact_ids[0][0])} flipped in {follower}'s device rows: "
          f"scrub rows {res['rows']['status']} "
          f"({res['rows']['seconds']:.2f} s); coordinator's row for "
          f"{follower} integrity_mismatch {flagged}", flush=True)
    check(res["rows"]["status"] == "mismatch" and flagged
          and INTEGRITY.region_report(None, rid)[2],
          "obs integrity: the scrub names `rows` and the coordinator flags "
          "the region")
    t0 = time.perf_counter()
    rebuilt = RECOVERY._rebuild_corrupted(nodes[follower])
    rebuild_s = time.perf_counter() - t0
    res = rows_pass(index_of(follower))
    beat()
    cleared = not coord_rows()[follower].integrity_mismatch
    got = ids_of(search(follower, queries, nprobe=REGION_NPROBE))
    want = ids_of(search(lead, queries, nprobe=REGION_NPROBE))
    rec_f = recall_vs_exact(got)
    out["corruption_rebuild_s"] = rebuild_s
    print(f"[{card}] obs integrity: _rebuild_corrupted rebuilt {rebuilt} "
          f"region(s) in {rebuild_s:.2f} s (engine rebuild, ledger fold "
          f"and a recompute from the device); clean pass rows "
          f"{res['rows']['status']}; the flag cleared on the coordinator "
          f"{cleared}; {follower}'s replies == the leader's {got == want}, "
          f"recall@{k} against numpy over the live rows {rec_f:.4f}",
          flush=True)
    check(rebuilt == 1 and res["rows"]["status"] == "ok" and cleared
          and got == want and rec_f >= 0.95,
          "obs integrity: _rebuild_corrupted rebuilds the replica, a clean "
          "pass clears the flag and the replies equal the leader's and "
          "numpy's (recall@10 >= 0.95)")

    # -- quality: live recall, shadow ids, costs, the sq8 mirror ---------------
    lidx = index_of(lead)
    oracle = ShadowOracle(lidx)
    got_s, _d = oracle.exact_topk(qsub, k)
    shadow_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        oracle.exact_topk(qsub, k)
        shadow_ms.append((time.perf_counter() - t1) * 1e3)
    out["shadow_ms"] = float(np.median(shadow_ms))
    check(oracle.mode == "store" and ties_ok(got_s.tolist(), qsub),
          "obs quality: the shadow scan's ids for 16 queries == numpy's "
          "exact top-10 over the live rows modulo ties (store arm)")
    windows = {}
    for nprobe in (8, 32):
        QUALITY.reset_region(rid)
        FLAGS.set("quality_sample_rate", 1.0)
        served = []
        for _ in range(OBS_WINDOW_BATCHES):
            served = ids_of(search(lead, queries, nprobe=nprobe))
        QUALITY.flush(timeout=120)
        FLAGS.set("quality_sample_rate", 0.0)
        est = QUALITY.region_estimate(rid)
        num = recall_vs_exact(served[:16], rows=slice(0, 16))
        windows[nprobe] = (est, num)
        print(f"[{card}] obs quality nprobe {nprobe}: live recall@{k} "
              f"{est['recall']:.4f} [{est['ci_low']:.4f}, "
              f"{est['ci_high']:.4f}] over {est['queries']} scored "
              f"queries; numpy's recall of the same queries {num:.4f}",
              flush=True)
        check(est["ci_low"] <= num <= est["ci_high"],
              f"obs quality nprobe {nprobe}: the live recall interval "
              "contains numpy's recall of the same queries")
    out["quality_windows"] = {p: (e["recall"], e["ci_low"], e["ci_high"], n_)
                              for p, (e, n_) in windows.items()}
    served_ms = {}
    for rate in (0.0, 0.05, 1.0):
        FLAGS.set("quality_sample_rate", rate)
        search(lead, queries, nprobe=REGION_NPROBE)
        QUALITY.flush(timeout=120)
        reads = []
        for _ in range(20):
            t1 = time.perf_counter()
            search(lead, queries, nprobe=REGION_NPROBE)
            reads.append((time.perf_counter() - t1) * 1e3)
            QUALITY.flush(timeout=120)      # untimed: the lane's work
        served_ms[rate] = float(np.median(reads))
    FLAGS.set("quality_sample_rate", 0.0)
    out["served_ms"] = served_ms
    print(f"[{card}] obs quality: shadow scan {out['shadow_ms']:.3f} ms a "
          "scored batch (16 queries over the store, with its read-back); "
          "served ms a 64-query batch at sample rate " + ", ".join(
              f"{r}: {v:.3f}" for r, v in served_ms.items()), flush=True)
    check(served_ms[1.0] < served_ms[0.0] + out["shadow_ms"],
          "obs quality: the served reply does not wait for its shadow "
          "scoring (served ms at rate 1.0 < rate 0 + one shadow scan)")

    # -- the SLO tuner and its events -----------------------------------------
    for v in ladder_values(min(64, nlist)):
        lidx.warmup(batches=(len(queries),), topk=k, nprobe=v)
    lidx.tuning["nprobe"] = 1
    # midpoints of two rows of different clusters: their neighbours lie in
    # two lists, so nprobe 1 misses about half of them. Batches of 16, so
    # that the shadow scan scores every query (it takes a batch's first
    # 16) and the interval and numpy's recall cover the same queries.
    nh = 256
    hard = (0.5 * (live_vecs[np.arange(nh) * 997 % len(live_vecs)]
                   + live_vecs[np.arange(nh) * 7919 % len(live_vecs)])
            ).astype(np.float32)
    hard_pos = exact_topk_device(live_vecs, hard, k, dev)
    hard_ids = live_ids[hard_pos]
    for v in ladder_values(min(64, nlist)):
        lidx.warmup(batches=(16,), topk=k, nprobe=v)
    FLAGS.set("quality_sample_rate", 1.0)
    search(lead, hard[:16])              # the shadow scan's shapes
    QUALITY.flush(timeout=120)
    QUALITY.reset_region(rid)
    shapes0 = SENTINEL.new_shapes()
    tuner = SloTuner(slo_recall=0.95, latency_budget_ms=0.0,
                     min_queries=nh)
    steps = []
    est = None
    for _tick in range(16):
        got_t = []
        for lo in range(0, nh, 16):
            got_t += ids_of(search(lead, hard[lo:lo + 16]))
        QUALITY.flush(timeout=120)
        est = QUALITY.region_estimate(rid)
        if est is not None and est["ci_low"] >= 0.95:
            break
        op = tuner.step_index(lidx, est)
        if op is not None:
            steps.append((op.knob, op.old, op.new))
    FLAGS.set("quality_sample_rate", 0.0)
    new_shapes = SENTINEL.new_shapes() - shapes0
    num = sum(len(set(g) & set(w.tolist()))
              for g, w in zip(got_t, hard_ids)) / (len(hard) * k)
    beat()
    events = coord.cluster_events(region_id=rid, actor="tuner")
    report = coord.explain_region_overrides(rid)
    out["tuner"] = {"steps": steps, "recall": num,
                    "ci_low": est["ci_low"] if est else None,
                    "new_shapes": new_shapes,
                    "orphans": report["orphans"]}
    print(f"[{card}] obs tuner: nprobe override 1, {nh} midpoint queries "
          "a tick; "
          f"steps {steps}; stopped at nprobe {lidx.tuning.get('nprobe')} "
          f"with live recall@{k} interval low end "
          f"{est['ci_low'] if est else float('nan'):.4f}, numpy's recall "
          f"there {num:.4f}; tuner events on the coordinator "
          f"{[(e.knob, e.old, e.new) for e in events]}; explain orphans "
          f"{report['orphans']}; kernel.new_shapes across the walk "
          f"{new_shapes}", flush=True)
    check(len(steps) >= 1 and est is not None and est["ci_low"] >= 0.95
          and num >= 0.95,
          "obs tuner: from a low nprobe the ticks walk up until the live "
          "interval's low end is >= 0.95, where numpy's recall is >= 0.95")
    check([(e.knob, e.old, e.new) for e in events][-len(steps):]
          == [(kn, str(o), str(n_)) for kn, o, n_ in steps]
          and report["orphans"] == [] and new_shapes == 0,
          "obs tuner: each step is an event on the coordinator's timeline, "
          "explain_region_overrides rebuilds the episode with zero "
          "orphans, and kernel.new_shapes stays 0")
    tuned_nprobe = lidx.tuning.get("nprobe")

    # -- heat: skewed against uniform traffic, no extra sync ------------------
    FLAGS.set("heat_enabled", True)
    assign = lidx._assign_h
    live_slots = np.flatnonzero(lidx.store.ids_by_slot >= 0)
    hot_lists = np.random.default_rng(3).choice(nlist, nlist // 10,
                                                replace=False)
    hot_rows = live_slots[np.isin(assign[live_slots], hot_lists)]
    rng = np.random.default_rng(5)

    def heat_batch(slots_, n_hot=0):
        """64 queries near stored rows: `n_hot` of them from the hot
        lists' rows, the rest from `slots_`."""
        pick = np.concatenate([rng.choice(hot_rows, n_hot),
                               rng.choice(slots_, 64 - n_hot)])
        ids_ = lidx.store.ids_by_slot[pick]
        pos = np.searchsorted(live_ids, ids_)
        return (live_vecs[pos] + 0.05 * rng.standard_normal(
            live_vecs[pos].shape, dtype=np.float32)).astype(np.float32)

    # skewed: 58 of each 64 queries (90%) drawn from the rows of 10% of
    # the lists, the rest uniform; at nprobe 1 a query reads its own list
    heat_stats = {}
    for name_, n_hot in (("skewed", 58), ("uniform", 0)):
        HEAT.forget_region(rid)
        for _ in range(32):
            search(lead, heat_batch(live_slots, n_hot), nprobe=1)
        HEAT.flush()
        heat_stats[name_] = HEAT.region_stats(rid)
    syncs = {}
    real_sync = torch.cuda.Event.synchronize
    for heat_on in (False, True):
        FLAGS.set("heat_enabled", heat_on)
        count = {"event": 0}

        def counting(self_, count=count):
            count["event"] += 1
            return real_sync(self_)

        torch.cuda.Event.synchronize = counting
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(8):
                    search(lead, queries, nprobe=REGION_NPROBE)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.Event.synchronize = real_sync
        syncs[heat_on] = (count["event"], len(caught))
    beat()
    rm = coord_rows()[lead]
    FLAGS.set("heat_enabled", False)
    out["heat"] = {k_: (v["hot_fraction"], v["gini"], v["touches"])
                   for k_, v in heat_stats.items()}
    print(f"[{card}] obs heat (nprobe 1, 2,048 queries each): skewed "
          f"(90% from the rows of {nlist // 10} of {nlist} lists) "
          f"hot fraction {heat_stats['skewed']['hot_fraction']:.4f}, Gini "
          f"{heat_stats['skewed']['gini']:.4f}; uniform "
          f"{heat_stats['uniform']['hot_fraction']:.4f}, "
          f"{heat_stats['uniform']['gini']:.4f}; heartbeat heat_touches "
          f"{rm.heat_touches}; 8 searches' event waits and sync-debug "
          f"warnings, heat off {syncs[False]}, on {syncs[True]}",
          flush=True)
    check(heat_stats["skewed"]["hot_fraction"]
          > heat_stats["uniform"]["hot_fraction"]
          and heat_stats["skewed"]["gini"] > heat_stats["uniform"]["gini"],
          "obs heat: skewed queries read a higher hot fraction and Gini "
          "than uniform ones")
    check(syncs[True] == syncs[False],
          "obs heat: the sync spy sees no extra synchronization with heat "
          "on (the probe ids ride the reply's one fetch)")

    # -- cost: the coalescer's model against measured run times ---------------
    notes: list = []
    real_note = COST.note

    def spy_note(kid, rows, run_ms, region_id=None):
        notes.append((kid, rows, run_ms))
        return real_note(kid, rows, run_ms, region_id=region_id)

    COST.note = spy_note
    svc = IndexService(nodes[lead], window_ms=2.0, max_batch=64)
    try:
        pool = heat_batch(live_slots)
        for m_ in (1, 4, 16):
            for _ in range(OBS_COST_BURSTS):
                futs = [svc.submit(rid, pool[(j * 4) % 64:(j * 4) % 64 + 4],
                                   k, nprobe=REGION_NPROBE)
                        for j in range(m_)]
                for f_ in futs:
                    f_.result(timeout=60)
    finally:
        svc.close()
        COST.note = real_note
    kid = kernel_id((rid, k, (("nprobe", REGION_NPROBE),)))
    by_rows: dict = {}
    for kid_, rows, ms in notes:
        if kid_ == kid:
            by_rows.setdefault(rows, []).append(ms)
    ratios = {r: COST.estimate_run_ms(kid, r) / float(np.median(v))
              for r, v in sorted(by_rows.items()) if len(v) >= 3}
    beat()
    rm = coord_rows()[lead]
    out["cost"] = {"row_us": rm.cost_row_us, "ratios": ratios}
    print(f"[{card}] obs cost: heartbeat cost_row_us {rm.cost_row_us:.3f}; "
          "model estimate / measured median run ms by batch rows: "
          + ", ".join(f"{r}: {v:.3f} ({len(by_rows[r])} runs)"
                      for r, v in ratios.items()), flush=True)
    check(rm.cost_row_us > 0 and ratios
          and all(0.5 <= v <= 2.0 for v in ratios.values()),
          "obs cost: cost_row_us > 0 in the heartbeat and the model's "
          "estimate is within 2x of the measured median at each ladder "
          "point served")

    # -- HBM ledger and the device peak ---------------------------------------
    owners = HBM.account_index(rid, regions[lead].vector_index_wrapper)
    tb = tensor_bytes(lidx)
    beat()
    rm = coord_rows()[lead]
    out["hbm"] = {"owners": owners, "tensor_bytes": tb,
                  "device_peak_bytes": rm.device_peak_bytes}
    print(f"[{card}] obs hbm: the leader's region owners {owners} sum "
          f"{sum(owners.values())} B, tensor_bytes {tb} B; heartbeat "
          f"device_peak_bytes {rm.device_peak_bytes}", flush=True)
    check(sum(owners.values()) == tb and rm.device_peak_bytes >= tb > 0,
          "obs hbm: HbmLedger's region bytes == tensor_bytes of the index "
          "and device_peak_bytes rides the heartbeat")

    # -- flight: a forced slow query ------------------------------------------
    saved = set_flags(FLAGS, trace_sampling_rate=1.0, slow_query_ms=0.001)
    FLIGHT.clear()
    FLIGHT.tick()
    try:
        with TRACER.start_span("rpc.IndexService.VectorSearch") as span:
            search(lead, queries, nprobe=REGION_NPROBE)
            trace_id = f"{span.trace_id:016x}"
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    metas = [m_ for m_ in FLIGHT.bundles_meta()
             if m_["reason"] == "slow_query"]
    bundle = FLIGHT.get_json(metas[-1]["id"]) if metas else {}
    print(f"[{card}] obs flight: {len(metas)} slow-query bundle(s); spans "
          f"{sorted({s_['name'] for s_ in bundle.get('spans', [])})}; "
          f"metric deltas {len(bundle.get('metrics', {}).get('deltas', {}))}"
          f", hbm regions {sorted(bundle.get('hbm', {}).get('regions', {}))}"
          f", quality series {len(bundle.get('quality', {}))}, events "
          f"{len(bundle.get('events', []))}", flush=True)
    check(len(metas) == 1 and bundle.get("trace_id") == trace_id
          and any(s_["name"] == "rpc.IndexService.VectorSearch"
                  for s_ in bundle.get("spans", []))
          and bundle["metrics"]["deltas"] and bundle["hbm"]["regions"]
          and bundle["quality"] and bundle["events"],
          "obs flight: a forced slow query writes one bundle with spans, "
          "metric deltas, the HBM ledger, the quality state and the events")

    # -- shedding under overload ----------------------------------------------
    saved = set_flags(FLAGS, qos_enabled=True, qos_shed_policy="degrade",
                      qos_max_queue_ms=1.0)
    ctl = ShedController(nodes[lead])
    svc = IndexService(nodes[lead], window_ms=2.0, max_batch=64)
    shed0 = PRESSURE.region_stats(rid)["shed_total"]
    levels, fails, served_n = [], [], [0]
    stop = threading.Event()

    def flood():
        while not stop.is_set():
            futs = [svc.submit(rid, pool[j * 4:j * 4 + 4], k,
                               nprobe=REGION_NPROBE) for j in range(16)]
            for f_ in futs:
                try:
                    f_.result(timeout=60)
                    served_n[0] += 1
                except Exception as e:  # noqa: BLE001 — counted
                    fails.append(repr(e))

    try:
        threads = [threading.Thread(target=flood, daemon=True)
                   for _ in range(6)]
        for t_ in threads:
            t_.start()
        t0 = time.perf_counter()
        # overload for OBS_OVERLOAD_S, and on until the ladder has climbed
        # two levels (20 s at most)
        while time.perf_counter() - t0 < 20.0 and (
                time.perf_counter() - t0 < OBS_OVERLOAD_S
                or max(levels, default=0) < 2):
            time.sleep(0.5)
            ctl.tick()
            levels.append(ctl.degrade_level(rid))
        stop.set()
        for t_ in threads:
            t_.join(timeout=60)
        t0 = time.perf_counter()
        while ctl.degrade_level(rid) > 0 and time.perf_counter() - t0 < 30:
            time.sleep(0.5)
            ctl.tick()
            levels.append(ctl.degrade_level(rid))
        shed = PRESSURE.region_stats(rid)["shed_total"] - shed0
    finally:
        svc.close()
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    out["shed"] = {"levels": levels, "served": served_n[0],
                   "failed": len(fails), "shed": shed}
    print(f"[{card}] obs shed: degrade levels a tick {levels}; requests "
          f"served {served_n[0]}, failed {len(fails)}, shed {shed}; nprobe "
          f"override back to {lidx.tuning.get('nprobe')} (the tuner's "
          f"{tuned_nprobe})", flush=True)
    check(max(levels) >= 1 and levels[-1] == 0 and not fails and shed == 0
          and lidx.tuning.get("nprobe") == tuned_nprobe,
          "obs shed: under overload the ShedController raises the degrade "
          "level and walks it back, and no request is dropped")
    lidx.tuning.pop("nprobe", None)

    # -- a Prometheus scrape ---------------------------------------------------
    srv = MetricsHttpServer(port=0)
    port = srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r_:
            body = r_.read().decode()
    finally:
        srv.stop()
    line_re = re_.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? "
                          r"(-?[0-9.eE+\-]+|[Nn]a[Nn]|[+-]?[Ii]nf)$")
    bad = [ln for ln in body.splitlines()
           if ln and not ln.startswith("#") and not line_re.match(ln)]
    names = {line_re.match(ln).group(1) for ln in body.splitlines()
             if ln and not ln.startswith("#") and line_re.match(ln)}
    fams = ("quality_", "consistency_", "hbm_", "heat_", "cost_", "event_",
            "qos_", "kernel_", "ivf_", "vector_search")
    missing = [f_ for f_ in fams if not any(n_.startswith(f_)
                                            for n_ in names)]
    print(f"[{card}] obs prometheus: scrape of {len(body)} B, "
          f"{len(names)} series names, unparseable lines {len(bad)}, "
          f"curated families missing {missing}", flush=True)
    check(not bad and not missing,
          "obs prometheus: a scrape of MetricsHttpServer parses back and "
          "holds the curated families")

    # the planes' per-region state (the heat plane's layout providers are
    # bound methods of the indexes) goes as the collector's retire loop
    # would drop it: the stopped replicas' device state must not outlive
    # the region phase
    HEAT.forget_region(rid)
    QUALITY.forget_region(rid)
    out["b3_launches"] = b3.launches - l3_start
    out["shadow_scans"] = shadow.shadow_exact_topk.calls - shadow_start
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] obs phase: B3 launches {out['b3_launches']}, shadow "
          f"scans (plain torch) {out['shadow_scans']}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


#: BASELINE.json config 4: HNSW 1M x 768, M = 32 (level-0 degree 64),
#: efConstruction 200, searched at ef 200 (beam 256 on the shape ladder)
HNSW_NLINKS = 32
HNSW_EFC = 200
HNSW_EF = 200
#: rows of the HNSW phase's device bulk build: BASELINE's 1M cut to
#: 500,000 once the cluster phase came in (the whole smoke with a 1M build
#: took 1059.7 s of its 1200 s limit, the HNSW phase 295.0 s), then to
#: 262,144 once the TABLE, LSM and transaction/document phases came in,
#: and to 32,768 once the chaos phase came in (PERF.md section 4);
#: `--hnsw-n 1000000` runs config 4 whole
HNSW_N = 32_768
#: rows of the HNSW writes phase: its host graph inserts one row at a time
#: on one thread (the JAX package's native graph; 9.60-17.29 ms a row at
#: d 768 and 4,096 rows on the card's hosts, PERF.md section 4), so the
#: inserts run in a thread beside the cluster and HNSW phases (started
#: after the observability phase, whose latencies they would disturb);
#: cut from 20,000 to 5,000 once the chaos phase came in (the shorter HNSW
#: phase left the smoke waiting ~30 s for the inserts; PERF.md section 4)
HNSW_WRITE_N = 5_000
#: the recovery phase's FLAT region
RECOVERY_N = 65_536


def exact_topk_device(x, q, k: int, dev=None):
    """Exact L2 top-k ids of q against x, computed on the card (or `dev`)
    in f32 (TF32 off) in row chunks: the HNSW phases' ground truth."""
    import torch

    dev = torch.device("cuda") if dev is None else dev
    qt = torch.from_numpy(q).to(dev)
    qsq = (qt * qt).sum(1)
    best_d = best_i = None
    for lo in range(0, len(x), 262_144):
        xt = torch.from_numpy(x[lo:lo + 262_144]).to(dev)
        d2 = qsq[:, None] - 2.0 * (qt @ xt.T) + (xt * xt).sum(1)[None, :]
        v, i = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False)
        i = i + lo
        if best_d is None:
            best_d, best_i = v, i
        else:
            best_d, pos = torch.topk(torch.cat([best_d, v], 1), k, dim=1,
                                     largest=False)
            best_i = torch.cat([best_i, i], 1).gather(1, pos)
    return best_i.cpu().numpy()


#: batches of each window of G's per-site measurement in the bulk build
G_WINDOW = 8
#: rounds (pair, block, block, pair) of the HNSW search pipelined with each
#: of G's designs in turns
G_TURNS = 3
#: GPU clock cycles a G measurement sleeps the stream before its first
#: event (~0.5 ms), so that the wrapper's host work is queued behind it
#: and the events read device time only
G_SLEEP_CYCLES = 1_000_000


def g_site(prefix: str, slots, beam_deg: int) -> str:
    """The call site of a G launch by its slots' shape: the walk's seed
    ([b, 1]) and rounds ([b, beam x degree]); in the build, the
    occlusion selection and the reprune ([1024, degree + window])."""
    from dingo_tpu_torch.ops.graph_build import REVERSE_WINDOW

    c = slots.shape[1]
    if c == 1:
        return f"{prefix}.seed"
    if c == beam_deg:
        return f"{prefix}.rounds"
    if c == 2 * HNSW_NLINKS + REVERSE_WINDOW:
        return f"{prefix}.reprune"
    return f"{prefix}.select"


def time_dev_ms(fn, torch, iters: int = 10, warmup: int = 2) -> float:
    """Device ms a call of fn: the stream sleeps first, so that the host's
    launches queue behind it and the events see no host gap."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(G_SLEEP_CYCLES * max(1, iters // 2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def g_sites_spy(beam_deg: int, batch_rows: int, timings: dict):
    """A spy on kernel G for the bulk build and the search, which calls the
    wrapper as it is (the launches it counts are the main path's): per
    window and call site (g_site; "build.rounds") the device time of every
    launch (events around the wrapper after a stream sleep, so no host
    time), launches, slots and live slots, and per site a copy of the
    queries and slots of its busiest launch (most live slots). The build's
    windows are G_PLAN's, each G_WINDOW `batch_rows`-row batches long,
    entered at the walk's seed launches once `st["armed"]` is set: a
    measured window records its launches under its name; an unmeasured
    one only snapshots the graph builder's `timings` at its ends (no
    sleep, no event). `st["search"]` = name records a search's launches
    instead. Returns (orig, spy, st)."""
    import torch

    from dingo_tpu_torch.ops import kernel_beam

    orig = kernel_beam.candidate_scores
    st = {"armed": False, "seeds": 0, "search": None, "rec": {},
          "best": {}, "times": {}}

    def window():
        i = (st["seeds"] - 1) // G_WINDOW
        return G_PLAN[i] if 0 <= i < len(G_PLAN) else None

    def spy(*a, **kw):
        slots = a[3]
        build_seed = (st["search"] is None and slots.shape[1] == 1
                      and slots.shape[0] == batch_rows)
        if st["armed"] and build_seed:
            # a build batch starts: close the last window, open the next
            st["seeds"] += 1
            if (st["seeds"] - 1) % G_WINDOW == 0:
                i = (st["seeds"] - 1) // G_WINDOW
                if 0 < i <= len(G_PLAN):
                    w0 = G_PLAN[i - 1][0]
                    st["times"][w0] = (st["times"][w0], dict(timings))
                if i < len(G_PLAN):
                    st["times"][G_PLAN[i][0]] = dict(timings)
                else:
                    st["armed"] = False
        if st["search"] is not None:
            name, measured = st["search"], True
        else:
            w = window() if st["armed"] else None
            name, measured = w if w else (None, False)
        if not measured:
            return orig(*a, **kw)
        site = g_site(name, slots, beam_deg)
        torch.cuda._sleep(G_SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **kw)
        e1.record()
        live = int((slots >= 0).sum())
        r = st["rec"].setdefault(site, [0.0, 0, 0, 0])
        r[0] += e0.elapsed_time(e1)
        r[1] += 1
        r[2] += slots.numel()
        r[3] += live
        # the busiest launch of a site over the build's or the searches'
        # windows
        key = name.split(".")[0] + "." + site.rsplit(".", 1)[1]
        best = st["best"].get(key)
        if best is None or live > best["live"]:
            st["best"][key] = {"live": live, "site": key, "args": [
                a[0].clone(), a[1], a[2], slots.clone(), *a[4:]]}
        return out

    spy.__dict__ = orig.__dict__
    return orig, spy, st


#: the build's windows of G's per-site measurement: (name, measured); the
#: unmeasured ones time the graph builder's phases without the spy's
#: sleeps and events
G_PLAN = [("build", True), ("clean", False), ("clean2", False)]
#: the graph builder's timed phase that holds each G call site
G_PHASE = {"seed": "walk", "rounds": "walk", "select": "select",
           "reprune": "reprune"}


class g_designs:
    """Within the block, G's designs as `arm` says, for the comparisons in
    turns: "pair" every launch on the per-pair arm (G before the block arm
    came), "block" every launch of at least BLOCK_MIN_SLOTS slots a query
    on the block arm where it fits (whatever the query count). The
    wrapper's choice (kernel_beam.takes_block_arm) is swapped for the
    block's length; the launches made there are the caller's to leave out
    of the main path's counts."""

    def __init__(self, arm: str):
        self.arm = arm

    def __enter__(self):
        from dingo_tpu_torch.ops import kernel_beam as kb

        self.orig = kb.takes_block_arm
        kb.takes_block_arm = (
            (lambda q, v, s: False) if self.arm == "pair" else
            (lambda q, v, s: s.shape[1] >= kb.BLOCK_MIN_SLOTS
             and kb.block_arm_fits(q, v, s)))
        return self

    def __exit__(self, *exc):
        from dingo_tpu_torch.ops import kernel_beam as kb

        kb.takes_block_arm = self.orig
        return False


def g_build_sites(gst: dict, card: str, batch_rows: int) -> dict:
    """G in the bulk build, each design by shape: each call site's device
    time, launches, slots and live share a batch (the measured window),
    and G's share of the graph builder's walk, selection and reprune
    seconds a batch (the two clean windows, which ran without the spy's
    sleeps and events)."""
    spans = [gst["times"].get(w) for w in ("clean", "clean2")]
    spans = [sp for sp in spans if isinstance(sp, tuple)]
    if not spans:
        print(f"[{card}] G in the build: not measured (the build ended "
              "before its windows)", flush=True)
        return {}
    phase_s = {ph: float(np.mean([(t1.get(ph, 0.0) - t0.get(ph, 0.0))
                                  / G_WINDOW for t0, t1 in spans]))
               for ph in ("walk", "select", "reprune")}
    g_ms = dict.fromkeys(phase_s, 0.0)
    sites = {}
    for site, (ms, n, slots, live) in sorted(gst["rec"].items()):
        if not site.startswith("build."):
            continue
        kind = site.rsplit(".", 1)[1]
        g_ms[G_PHASE[kind]] += ms / G_WINDOW
        sites[kind] = {"ms_batch": ms / G_WINDOW,
                       "launches_batch": n / G_WINDOW,
                       "slots_batch": slots / G_WINDOW,
                       "live_share": live / max(1, slots)}
        print(f"[{card}] G build {kind}: {ms / G_WINDOW:.3f} ms device time "
              f"a batch, {n / G_WINDOW:.2f} launches, {slots / G_WINDOW:.0f}"
              f" slots ({live / max(1, slots):.4f} live)", flush=True)
    rows_s = batch_rows / max(1e-9, sum(phase_s.values()))
    print(f"[{card}] G build share (graph builder timings a batch over "
          f"{len(spans)} windows of {G_WINDOW}): " + "; ".join(
              f"{ph} {phase_s[ph] * 1e3:.2f} ms, G {g_ms[ph]:.2f} ms "
              f"({g_ms[ph] / max(1e-9, phase_s[ph] * 1e3):.1%})"
              for ph in phase_s)
          + f"; {rows_s:.1f} rows/s over the three", flush=True)
    return {"phase_s": phase_s, "g_ms": g_ms, "sites": sites,
            "rows_s": rows_s}


def g_search_sites(gst: dict, card: str, turns: dict) -> dict:
    """G in a search of the HNSW phase, per design (g_designs): each call
    site's device time, launches and live share, and G's share of the
    search's pipelined ms (the same design's, taken in turns)."""
    res = {}
    for arm in ("pair", "block"):
        tot = 0.0
        for site, (ms, n, slots, live) in sorted(gst["rec"].items()):
            if not site.startswith(f"search.{arm}."):
                continue
            tot += ms
            print(f"[{card}] G search {site.rsplit('.', 1)[1]}, {arm} arm: "
                  f"{ms:.3f} ms device time, {n} launches, {slots} slots "
                  f"({live / max(1, slots):.4f} live)", flush=True)
        pipe = median_spread(turns[arm])[0]
        print(f"[{card}] G in a search, {arm} arm: {tot:.3f} ms of the "
              f"pipelined {pipe:.3f} ms a 64-query batch ({tot / pipe:.1%}; "
              f"pipelined readings {', '.join(f'{v:.3f}' for v in turns[arm])}"
              " ms, in turns pair, block, block, pair)", flush=True)
        res[arm] = {"g_ms": tot, "pipe_ms": pipe, "pipe_reads": turns[arm]}
    return res


def g_bounds(nbytes: float, live: int, d: int, dtype) -> dict:
    """Each design's bound on one launch: the bytes side (`nbytes` at the
    memory rate) against the operations that design does at its peak: 2 d
    a live pair on the CUDA cores at the f32 rate (the per-pair arm), or
    on the tensor cores (the block arm: f32 rows in SPLIT_PASSES TF32
    passes, bf16 and sq8 rows as bf16)."""
    import torch

    flops = 2.0 * d * live
    if dtype == torch.float32:
        block_ops, block_peak = SPLIT_PASSES * flops, PEAK_TF32_FLOPS
    else:
        block_ops, block_peak = flops, PEAK_BF16_FLOPS
    return {"pair": bound_of(nbytes, flops, PEAK_F32_FLOPS),
            "block": bound_of(nbytes, block_ops, block_peak),
            "bytes_ms": nbytes / PEAK_BYTES * 1e3,
            "f32_ops_ms": flops / PEAK_F32_FLOPS * 1e3,
            "tc_ops_ms": block_ops / block_peak * 1e3}


def g_site_launch(key: str, best: dict, card: str, d: int) -> dict:
    """Kernel G on a call site's busiest launch: each design's launcher
    (kernel_beam._scores_pair, _scores_block; they count nothing) against
    the plain version, each design's result repeated bit for bit, their
    device times in turns (pair, block, block, pair), and each design's
    bound (g_bounds): the distinct live rows and their norms read once,
    the slots read and the scores written once."""
    import torch

    from dingo_tpu_torch.ops import kernel_beam

    fns = {"pair": kernel_beam._scores_pair,
           "block": kernel_beam._scores_block}
    a = best["args"]
    slots = a[3]
    b_, c_ = slots.shape
    live = best["live"]
    pv = kernel_beam.candidate_scores_plain(*a)
    fin = torch.isfinite(pv)
    res = {"site": best["site"], "b": b_, "c": c_, "live": live,
           "auto": "block" if kernel_beam.takes_block_arm(a[0], a[1], slots)
           else "pair"}
    for arm, fn in fns.items():
        kv = fn(*a)
        again = fn(*a)
        ok = bool(torch.equal(fin, torch.isfinite(kv)) and torch.allclose(
            kv[fin], pv[fin], rtol=RTOL, atol=ATOL))
        res[f"{arm}_err"] = (float((kv[fin] - pv[fin]).abs().max())
                             if bool(fin.any()) else 0.0)
        res[f"{arm}_ok"] = ok
        res[f"{arm}_repeat"] = bool(torch.equal(kv.view(torch.int32),
                                                again.view(torch.int32)))
    reads = {"pair": [], "block": []}
    for _ in range(ROUNDS):
        for arm in ("pair", "block", "block", "pair"):
            reads[arm].append(time_dev_ms(lambda: fns[arm](*a), torch))
    res["plain_ms"] = time_ms(lambda: kernel_beam.candidate_scores_plain(*a),
                              torch, iters=2, warmup=1)
    rows = int(torch.unique(slots[slots >= 0]).numel())
    esize = a[1].element_size()
    nbytes = rows * (d * esize + 4) + b_ * c_ * 8 + b_ * d * 4
    res["rows"] = rows
    bd = g_bounds(nbytes, live, d, a[1].dtype)
    res.update({k_: bd[k_] for k_ in ("bytes_ms", "f32_ops_ms", "tc_ops_ms")})
    for arm in ("pair", "block"):
        res[f"{arm}_bound"], res[f"{arm}_by"] = bd[arm]
        res[f"{arm}_ms"] = median_spread(reads[arm])[0]
        res[f"{arm}_reads"] = reads[arm]
    half = res["block_ms"] <= 2.0 * res["block_bound"]
    check(res["pair_ok"] and res["block_ok"],
          f"G on {best['site']}'s busiest launch: both designs == the plain "
          f"version (max abs err pair {res['pair_err']:.3e}, block "
          f"{res['block_err']:.3e})")
    check(res["pair_repeat"] and res["block_repeat"],
          f"G on {best['site']}'s busiest launch: a second launch gives the "
          "same bits (both designs)")
    tc = ("3xTF32 at TF32" if a[1].dtype == torch.float32 else "bf16 at bf16")
    print(f"[{card}] G {best['site']} busiest launch [{b_}, {c_}], live "
          f"{live} ({live / (b_ * c_):.4f}), {rows} distinct live rows "
          f"({live / max(1, rows):.2f} pairs a row): block arm "
          f"{spread_text(reads['block'])}; per-pair arm "
          f"{spread_text(reads['pair'])} (in turns); plain "
          f"{res['plain_ms']:.4f} ms; bytes {res['bytes_ms']:.4f} ms at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; operations {res['f32_ops_ms']:.4f}"
          f" ms on the CUDA cores (f32, {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)"
          f", {res['tc_ops_ms']:.4f} ms on the tensor cores ({tc} peak); "
          f"block arm {res['block_ms'] / res['block_bound']:.2f}x its bound "
          f"{res['block_bound']:.4f} ms ({res['block_by']}, tensor cores), "
          f"{'within' if half else 'not within'} twice it; per-pair arm "
          f"{res['pair_ms'] / res['pair_bound']:.2f}x its bound "
          f"{res['pair_bound']:.4f} ms ({res['pair_by']}, CUDA cores); the "
          f"shape takes the {res['auto']} arm", flush=True)
    return res


def hnsw_phase(n_h: int, card: str) -> dict:
    """BASELINE.json config 4 on the card, flags at their defaults: the
    device bulk build (build rows/s split into walk, occlusion selection
    and reprune, reverse_dropped), recall@10 at ef 200 against exact top-10
    computed on the card, pipelined ms per 64-query batch, the walk's
    hops / visited / occupancy, kernel G's launches and live-candidate
    share, device bytes, and a dispatch under the sync-debug mode. Kernel
    G by call site (g_sites_spy): its device time, launches, pairs and
    live share in a window of build batches (the designs the shapes take)
    and in a search with each design (g_designs); its share of the
    build's walk, selection and reprune (windows without the spy's sleeps)
    and of a search; each site's busiest launch on both designs against
    the plain version and each design's bound (g_site_launch); the search
    pipelined with each design in turns. G's launches on the main path
    are read before any search with a swapped design."""
    import torch

    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.hnsw import TpuHnsw
    from dingo_tpu_torch.obs.sentinel import SENTINEL
    from dingo_tpu_torch.ops import kernel_beam
    from dingo_tpu_torch.ops.distance import Metric

    g = kernel_beam.candidate_scores
    d, k, batch = 768, 10, 64
    t_phase = time.perf_counter()
    x, queries, _ = make_data(n_h, d, batch, seed=11)
    gt = exact_topk_device(x, queries, k)
    param = IndexParameter(index_type=IndexType.HNSW, dimension=d,
                           metric=Metric.L2, nlinks=HNSW_NLINKS,
                           efconstruction=HNSW_EFC)
    idx = new_index(50, param)
    check(isinstance(idx, TpuHnsw) and idx.device.type == "cuda",
          "new_index(HNSW) builds the port's TpuHnsw on the card")
    for attr in ("launches", "launches_bf16", "launches_sq8", "block",
                 "pair"):
        setattr(g, attr, 0)
    out: dict = {}

    # -- the device bulk build ------------------------------------------------
    sess = idx.bulk_builder(expect_rows=n_h)
    check(sess is not None, "hnsw_device_build 'auto' takes the device bulk "
          "build for a CUDA store")
    sess.builder.timings = {}
    beam_deg = idx._beam_width(HNSW_EFC, 1) * idx._graph_deg
    orig, spy, gst = g_sites_spy(beam_deg, sess.builder.batch_rows,
                                 sess.builder.timings)
    kernel_beam.candidate_scores = spy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for lo in range(0, n_h, 65536):
            hi = min(n_h, lo + 65536)
            # G's windows start half way through the build
            gst["armed"] |= gst["seeds"] == 0 and hi > n_h // 2
            sess.add(np.arange(lo, hi, dtype=np.int64), x[lo:hi])
        stats = sess.finish()
        torch.cuda.synchronize()
    finally:
        kernel_beam.candidate_scores = orig
    build_s = time.perf_counter() - t0
    tm = sess.builder.timings
    out["build_launches"] = g.launches
    out["build_s"] = build_s
    print(f"[{card}] HNSW bulk build {n_h} x {d} (M {HNSW_NLINKS}, "
          f"efConstruction {HNSW_EFC} -> beam {idx._beam_width(HNSW_EFC, 1)},"
          f" batch {sess.builder.batch_rows}, {stats['batches']} batches): "
          f"{build_s:.1f} s, {n_h / build_s:.1f} rows/s; walk "
          f"{tm.get('walk', 0):.1f} s, occlusion selection "
          f"{tm.get('select', 0):.1f} s, reprune {tm.get('reprune', 0):.1f} s"
          f", the rest (row puts, host) "
          f"{build_s - sum(tm.values()):.1f} s; reverse_dropped "
          f"{stats['reverse_dropped']} of {stats['rows'] * idx._graph_deg} "
          f"edges; G launches {g.launches}", flush=True)
    check(stats["rows"] == n_h and idx.get_count() == n_h,
          f"HNSW bulk build holds {n_h} rows")
    check(g.launches > 0, "the bulk build launched kernel G")
    check(g.block > 0 and g.pair > 0, "the bulk build launched both of G's "
          f"designs (block arm {g.block}, per-pair arm {g.pair})")
    out["build_block"], out["build_pair"] = g.block, g.pair
    out["g_build"] = g_build_sites(gst, card, sess.builder.batch_rows)
    check(idx._native_pending, "the bulk-built graph is not back-filled "
          "into the host graph (no host-path use)")

    # -- search at ef 200 -----------------------------------------------------
    idx.warmup(batches=(batch,), topk=k, ef=HNSW_EF)
    shapes0 = SENTINEL.new_shapes()
    l0 = g.launches
    res = idx.search(queries, k, ef=HNSW_EF)
    per_search = g.launches - l0
    rec = recall_at(res, gt, k)
    beam = idx._beam_width(HNSW_EF, k)
    cap = idx.store.capacity
    hops = METRICS.gauge("hnsw.mean_hops", region_id=50).get()
    vfrac = METRICS.gauge("hnsw.visited_fraction", region_id=50).get()
    occ = METRICS.gauge("hnsw.beam_occupancy", region_id=50).get()
    print(f"[{card}] HNSW search b={batch} k={k} ef {HNSW_EF} (beam {beam},"
          f" {HNSW_NLINKS * 2} neighbours a node): recall@10 {rec:.4f}; mean"
          f" hops {hops:.2f}, mean visited {vfrac * cap:.1f} slots, mean "
          f"result occupancy {occ * beam:.1f} of {beam}; G launches a "
          f"search {per_search}", flush=True)
    check(rec >= 0.95, f"HNSW recall@10 at ef {HNSW_EF} >= 0.95 ({rec:.4f})")
    g.count_live, g.live, g.slots = True, 0, 0
    idx.search(queries, k, ef=HNSW_EF)
    g.count_live = False
    share = g.live / max(1, g.slots)
    print(f"[{card}] G live candidate slots in a search: {g.live} of "
          f"{g.slots} ({share:.4f})", flush=True)

    # pipelined: REPS dispatches, then their resolves
    reps = 10
    idx.search_async(queries, k, ef=HNSW_EF)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thunks = [idx.search_async(queries, k, ef=HNSW_EF) for _ in range(reps)]
    for th in thunks:
        th()
    pipe_ms = (time.perf_counter() - t0) * 1e3 / reps
    out["pipe_ms"] = pipe_ms
    print(f"[{card}] HNSW pipelined: {pipe_ms:.3f} ms per {batch}-query "
          f"batch, {batch * 1e3 / pipe_ms:.1f} QPS", flush=True)
    check(SENTINEL.new_shapes() == shapes0,
          "no new kernel shape after the HNSW warmup")

    def window():
        for th in [idx.search_async(queries, k, ef=HNSW_EF)
                   for _ in range(2)]:
            th()
    print(f"[{card}] HNSW pipelined window of 2 searches: "
          + device_profile(window, top=10), flush=True)

    # dispatch without a host sync
    torch.cuda.synchronize()
    synced = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        th = idx.search_async(queries, k, ef=HNSW_EF)
    except RuntimeError as e:
        import traceback

        synced, th = str(e), None
        tb = traceback.extract_tb(e.__traceback__)
        synced += " at " + "; ".join(f"{f.filename.split('/')[-1]}:"
                                     f"{f.lineno}" for f in tb[-3:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(synced is None and th is not None,
          "HNSW search_async dispatch makes no synchronizing call"
          + (f" ({synced})" if synced else ""))
    if th is not None:
        th()
    # the main path's launches: the build and every search above, each
    # design as the shapes chose it; the searches with a swapped design
    # and the parity and timing launches below are not counted
    launches = {"block": g.block, "pair": g.pair}
    search_block = launches["block"] > out["build_block"]
    check(launches["block"] + launches["pair"] > out["build_block"]
          + out["build_pair"], "the main path's searches launched G")

    # -- kernel G by call site in a search, each design; pipelined in turns --
    kernel_beam.candidate_scores = spy
    try:
        for arm in ("pair", "block"):
            gst["search"] = f"search.{arm}"
            with g_designs(arm):
                idx.search(queries, k, ef=HNSW_EF)
    finally:
        kernel_beam.candidate_scores = orig
        gst["search"] = None
    turns = {"pair": [], "block": []}
    for _ in range(G_TURNS):
        for arm in ("pair", "block", "block", "pair"):
            with g_designs(arm):
                idx.search_async(queries, k, ef=HNSW_EF)()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for th in [idx.search_async(queries, k, ef=HNSW_EF)
                           for _ in range(reps)]:
                    th()
                turns[arm].append((time.perf_counter() - t0) * 1e3 / reps)
    out["pipe_turns"] = {a_: median_spread(v)[0] for a_, v in turns.items()}
    out["g_search"] = g_search_sites(gst, card, turns)
    wins = sum(p_ > b_ for p_, b_ in zip(turns["pair"], turns["block"]))
    print(f"[{card}] HNSW pipelined in turns: the block arm faster in {wins}"
          f" of {len(turns['pair'])} pairs of readings; medians pair "
          f"{out['pipe_turns']['pair']:.3f} ms, block "
          f"{out['pipe_turns']['block']:.3f} ms; the search's rounds take "
          f"the {'block' if search_block else 'per-pair'} arm by shape",
          flush=True)

    # -- kernel G on each call site's busiest launch -------------------------
    sites = {}
    for key in ("search.rounds", "build.rounds", "build.select",
                "build.reprune", "search.seed", "build.seed"):
        if key in gst["best"]:
            sites[key] = g_site_launch(key, gst["best"][key], card, d)
    check("search.rounds" in sites and "build.rounds" in sites,
          "G's busiest launches of the search and build walk rounds were "
          "captured")

    # -- device bytes -------------------------------------------------------
    st = idx.store
    store_b = st.vecs.numel() * st.vecs.element_size() + st.sqnorm.numel() * 4
    adj_b = st.adj.numel() * 4
    vis_b = batch * (cap + 1) * 4
    print(f"[{card}] HNSW device bytes: store {store_b / 2**20:.1f} MiB, "
          f"adjacency {adj_b / 2**20:.1f} MiB ([{cap}, {st.graph_deg}] "
          f"int32), visited map {vis_b / 2**20:.1f} MiB a {batch}-query "
          f"search ([{batch}, {cap + 1}] int32); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out.update({
        "recall": rec, "launches_search": per_search, "live_share": share,
        "hops": hops, "launches": launches, "sites": sites})
    return out


def hnsw_writes_start(n_w: int) -> dict:
    """Start the HNSW writes phase: an HNSW index whose host graph takes
    n_w rows, inserted by the native graph one row at a time on one
    thread (the JAX package's). The insert runs on a thread of its own
    (ctypes releases the GIL inside the native call) so that it overlaps
    the HNSW phase; this returns once the rows' device writes are done,
    so the thread does not touch the card again."""
    import threading

    import torch

    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops.distance import Metric

    x, queries, extra = make_data(n_w, 768, 64, seed=13)
    param = IndexParameter(index_type=IndexType.HNSW, dimension=768,
                           metric=Metric.L2, nlinks=HNSW_NLINKS,
                           efconstruction=HNSW_EFC)
    idx = new_index(51, param)
    st = {"idx": idx, "param": param, "x": x, "queries": queries,
          "extra": extra, "error": None}
    version = idx.store.mutation_version

    def insert():
        t0 = time.perf_counter()
        try:
            idx.add(np.arange(n_w, dtype=np.int64), x)
        except BaseException as e:  # noqa: BLE001 - re-raised at the join
            st["error"] = e
        st["insert_s"] = time.perf_counter() - t0

    st["thread"] = threading.Thread(target=insert, name="hnsw-host-inserts",
                                    daemon=True)
    st["thread"].start()
    # the store bumps its mutation version once its device writes are
    # queued; the native inserts follow
    while idx.store.mutation_version == version and st["thread"].is_alive():
        time.sleep(0.01)
    torch.cuda.synchronize()
    return st


def hnsw_writes_phase(st: dict, card: str) -> dict:
    """The HNSW index of hnsw_writes_start once its host graph holds the
    rows: the device walk against the host walk at equal ef (with the
    share of the graph a walk visits), upserts and deletes then the
    adjacency mirror's re-export, filter pushdown against the host
    post-filter, and save/load."""
    import tempfile

    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.base import FilterSpec
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.ops import kernel_beam

    k = 10
    g = kernel_beam.candidate_scores
    t_phase = time.perf_counter()
    st["thread"].join()
    waited = time.perf_counter() - t_phase
    if st["error"] is not None:
        raise st["error"]
    idx, param, x = st["idx"], st["param"], st["x"]
    queries, extra = st["queries"], st["extra"]
    n_w, d = x.shape
    ins_s = st["insert_s"]
    gt = exact_topk_device(x, queries, k)

    def walk(device_on, q=queries, spec=None):
        saved = set_flags(FLAGS, hnsw_device_search=device_on)
        try:
            return idx.search(q, k, spec, ef=HNSW_EF)
        finally:
            set_flags(FLAGS, **saved)

    l0 = g.launches
    r_host = recall_at(walk(False), gt, k)
    r_dev = recall_at(walk(True), gt, k)
    vfrac = METRICS.gauge("hnsw.visited_fraction", region_id=51).get()
    cap = idx.store.capacity
    print(f"[{card}] HNSW writes phase {n_w} x {d}: host graph inserts "
          f"{ins_s:.1f} s ({ins_s * 1e3 / n_w:.2f} ms a row, one thread, "
          f"beside the HNSW phase; {waited:.1f} s waited for them after "
          f"it); recall@10 at ef {HNSW_EF}: device walk {r_dev:.4f}, host "
          f"walk {r_host:.4f}; a device walk visits {vfrac * cap:.1f} "
          f"slots a query, {vfrac * cap / n_w:.4f} of the {n_w} rows",
          flush=True)
    check(r_dev >= r_host - 0.01, "HNSW device-walk recall >= host-walk "
          f"recall - 0.01 ({r_dev:.4f} vs {r_host:.4f})")
    check(g.launches > l0, "the device walk of the writes phase launched G")

    # upserts (new ids and replaced rows), deletes, then the mirror re-export
    rb = METRICS.counter("hnsw.adjacency_rebuilds", region_id=51)
    new_ids = np.arange(n_w, n_w + 512, dtype=np.int64)
    idx.upsert(new_ids, extra[:512])
    idx.upsert(np.arange(512, dtype=np.int64), extra[512:1024])
    gone = np.arange(1024, 1536, dtype=np.int64)
    idx.delete(gone)
    rb0 = rb.get()
    res_new = walk(True, extra[:64], None)
    hit = float(np.mean([len(r.ids) and r.ids[0] == w
                         for r, w in zip(res_new, new_ids[:64])]))
    res_q = walk(True)
    leaked = sum(int(np.isin(r.ids, gone).sum()) for r in res_q)
    check(rb.get() == rb0 + 1 and hit >= 0.9 and leaked == 0,
          f"HNSW adjacency re-exported after writes (rebuilds +"
          f"{rb.get() - rb0}), upserted rows found ({hit:.3f}), deleted "
          f"ids absent ({leaked} leaked)")

    # filter pushdown against the host post-filter
    cur = np.concatenate([x, extra[:512]])
    cur[:512] = extra[512:1024]
    alive = np.ones(len(cur), bool)
    alive[1024:1536] = False
    lo, hi = 0, n_w // 2
    sub = np.flatnonzero(alive & (np.arange(len(cur)) >= lo)
                         & (np.arange(len(cur)) < hi))
    fgt = sub[exact_topk_device(cur[sub], queries, k)]
    spec = FilterSpec(ranges=[(lo, hi)])
    f_dev = walk(True, queries, spec)
    f_host = walk(False, queries, spec)
    rf_dev, rf_host = recall_at(f_dev, fgt, k), recall_at(f_host, fgt, k)
    inside = all(((r.ids >= lo) & (r.ids < hi)).all() for r in f_dev)
    check(inside and rf_dev >= rf_host - 0.01,
          f"HNSW filter pushdown: results inside the filter, recall "
          f"{rf_dev:.4f} vs the host post-filter's {rf_host:.4f}")

    # save / load
    before = walk(True)
    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        idx2 = new_index(51, param)
        idx2.load(tmp)
    saved = set_flags(FLAGS, hnsw_device_search=True)
    try:
        after = idx2.search(queries, k, ef=HNSW_EF)
    finally:
        set_flags(FLAGS, **saved)
    # the snapshot compacts the slots (512 ids were deleted), so the two
    # mirrors are compared in id space, and the walks modulo exact ties
    # (the walk breaks ties by slot)

    def id_graph(ix):
        st_ = ix.store
        live = np.flatnonzero(st_.ids_by_slot >= 0)
        nb = st_.ids_of_slots(st_.adj.cpu().numpy()[live].astype(np.int64))
        return {int(v): frozenset(r.tolist()) - {-1}
                for v, r in zip(st_.ids_by_slot[live], nb)}

    same_graph = id_graph(idx) == id_graph(idx2)
    same = same_modulo_ties(cur, queries, [r.ids for r in after],
                            [r.ids for r in before])
    check(same_graph and same, "HNSW save/load: the same adjacency in id "
          "space, the same device-walk ids modulo ties")
    print(f"[{card}] HNSW writes phase: {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    return {"recall_dev": r_dev, "recall_host": r_host, "insert_s": ins_s,
            "visited_share": vfrac * cap / n_w}


def recovery_phase(card: str) -> dict:
    """The device recovery ladder on a FLAT region of a MonoStoreNode on the
    card (B4 on its path): one injected fault recovered by the retry; a
    persistent fault degrades the region, whose host path answers like
    numpy and absorbs writes; re-materialization brings the region back
    on B4 (held against its plain version); one real CUDA out-of-memory
    error classified."""
    import torch

    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.recovery import RECOVERY
    from dingo_tpu_torch.obs.hbm import looks_like_oom
    from dingo_tpu_torch.ops import kernel_topk, kernel_topk_pruned
    from dingo_tpu_torch.ops.devfault import DEVFAULT
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    n, d, k = RECOVERY_N, 768, 10
    t_phase = time.perf_counter()
    x, queries, extra = make_data(n, d, 64, seed=17)
    b1, b4 = kernel_topk.fused_topk, kernel_topk_pruned.pruned_fused_topk
    counters = [(b1, "launches"), (b1, "launches_bf16"), (b4, "launches"),
                (b4, "launches_bf16"), (b4, "launches_sq8")]
    for kf, attr in counters:
        setattr(kf, attr, 0)
    node = MonoStoreNode()
    rid = 9
    region = node.create_region(RegionDefinition(
        region_id=rid, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=IndexParameter(index_type=IndexType.FLAT,
                                       dimension=d)))
    out: dict = {}
    try:
        for lo in range(0, n, 4096):
            node.storage.vector_add(region, np.arange(lo, lo + 4096),
                                    x[lo:lo + 4096])
        gt = exact_topk(x, queries, k)

        def ids(rows):
            return [[v.id for v in r] for r in rows]

        l4 = b4.launches
        got = ids(node.storage.vector_batch_search(region, queries, k))
        check(b4.launches > l4 and same_modulo_ties(x, queries, got, gt),
              "recovery: the FLAT region serves on B4 with numpy's ids")
        DEVFAULT.arm(1)
        got = ids(node.storage.vector_batch_search(region, queries, k))
        check(DEVFAULT.armed() == 0 and not RECOVERY.is_degraded(rid)
              and same_modulo_ties(x, queries, got, gt),
              "recovery: one injected device fault is recovered by the "
              "ladder's retry, ids == numpy's")
        DEVFAULT.arm(1 << 30)
        wrapper = region.vector_index_wrapper
        applied = wrapper.apply_log_id
        node.storage.vector_add(region, np.arange(n, n + 4096),
                                extra[:4096])
        degraded = RECOVERY.is_degraded(rid)
        allx = np.concatenate([x, extra[:4096]])
        gt2 = exact_topk(allx, queries, k)
        t0 = time.perf_counter()
        got = ids(node.storage.vector_batch_search(region, queries, k))
        host_s = time.perf_counter() - t0
        check(degraded and wrapper.apply_log_id == applied
              and same_modulo_ties(allx, queries, got, gt2),
              "recovery: a persistent fault degrades the region; the write "
              "is absorbed (apply_log_id stays), the host exact path "
              f"answers like numpy over every row ({host_s:.2f} s)")
        DEVFAULT.disarm()
        l4s = b4.launches_sq8
        with first_launch(kernel_topk_pruned, "pruned_fused_topk") as call:
            t0 = time.perf_counter()
            n_remat = RECOVERY.run_rematerializations(node)
            remat_s = time.perf_counter() - t0
            got = ids(node.storage.vector_batch_search(region, queries, k))
        idx = wrapper.own_index
        if call:
            a_, kw_, (kv, ki, _) = call[0]
            pv, pi, _ = kernel_topk_pruned.pruned_fused_topk_plain(
                *a_[:9], **dict(zip(("sq_vmin", "sq_scale"), a_[9:])), **kw_)
            ok, err = kernel_parity(kv, ki, pv, pi)
        else:
            ok, err = False, float("nan")
        check(n_remat == 1 and not RECOVERY.is_degraded(rid)
              and idx._precision == "sq8" and b4.launches_sq8 > l4s and ok,
              f"recovery: re-materialized in {remat_s:.2f} s at "
              f"{idx._precision}, out of degraded mode, B4-sq8 back and == "
              f"its plain version (max abs err {err:.3e})")
        recall = float(np.mean([len(set(r) & set(w.tolist())) / k
                                for r, w in zip(got, gt2)]))
        print(f"[{card}] recovery: recall@10 after re-materialization at "
              f"sq8 {recall:.4f}", flush=True)
        check(recall >= 0.9, "recovery: the re-materialized region serves "
              f"(recall@10 {recall:.4f})")
    finally:
        DEVFAULT.disarm()
        RECOVERY.clear()
        node.stop()
    # one real CUDA out-of-memory error
    free, _total = torch.cuda.mem_get_info()
    caught = None
    try:
        torch.empty(int(free) + (8 << 30), dtype=torch.uint8,
                    device="cuda")
    except Exception as e:  # noqa: BLE001 - classified below
        caught = e
    check(caught is not None and looks_like_oom(caught),
          "recovery: a real CUDA out-of-memory error ("
          f"{type(caught).__name__}) is classified by looks_like_oom")
    out["launches"] = {"pruned_fused_topk": b4.launches,
                       "pruned_fused_topk_sq8": b4.launches_sq8,
                       "fused_topk": b1.launches}
    print(f"[{card}] recovery phase: {time.perf_counter() - t_phase:.1f} s;"
          f" launches B4 {b4.launches}, B4-sq8 {b4.launches_sq8}, B1 "
          f"{b1.launches}", flush=True)
    return out


#: the binary phase: rows upserted (new packed rows for existing ids) and
#: deleted, on FLAT and on IVF_FLAT, and the radius search's target count
BIN_UPSERTS, BIN_DELETES, BIN_RANGE_MAX = 8192, 4096, 1024
#: the binary region (through Storage and IndexService) holds the first
#: BIN_REGION_N rows (a depth cut for the smoke's clock: 20.8 s at 1M)
BIN_REGION_N = 262_144
#: DiskANN (BASELINE.json config 3's widths): subspaces, probes, and the
#: rows each push carries
DK_M, DK_NPROBE, DK_PUSH = 96, 32, 65536
#: rows of the DiskANN phase: the 1M rows cut to 500,000 for the smoke's
#: 1,200 s limit once the ladder and edge-cache phases came in, then to
#: 262,144 once the TABLE, LSM and transaction/document phases came in,
#: and to 32,768 once the chaos phase came in (PERF.md section 4)
DK_N = 32_768


def exact_hamming_device(qb, xb, dev, chunk: int = 8192):
    """[b, n] exact hamming distances of packed rows on the card: a
    popcount table over the XOR of the bytes (a reference independent of
    the indexes' +/-1 product)."""
    import torch

    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int32, device=dev)
    q = torch.from_numpy(qb).to(dev)
    out = torch.empty((len(qb), len(xb)), dtype=torch.int32, device=dev)
    for lo in range(0, len(xb), chunk):
        xc = torch.from_numpy(xb[lo:lo + chunk]).to(dev)
        out[:, lo:lo + chunk] = lut[(q[:, None, :] ^ xc[None]).int()].sum(
            -1, dtype=torch.int32)
    return out


def hamming_reply_ok(res, kth, exact_of, k: int = 10) -> tuple:
    """(ok, recall@k) of replies against exact distances: exact_of(qi,
    ids) gives the exact distances of the returned ids, kth[qi] the exact
    k-th distance. A returned id is a hit when its distance is at most the
    k-th (hits counted modulo ties); ok when each reply has k rows and
    every returned distance equals the exact distance of its id."""
    ok, hits = True, 0
    for qi, r in enumerate(res):
        ex = exact_of(qi, np.asarray(r.ids, np.int64))
        ok = ok and len(r.ids) == k and np.array_equal(
            np.asarray(r.distances), ex)
        hits += int((ex <= kth[qi]).sum())
    return ok, hits / (len(res) * k)


class Reply:
    """A region reply row (VectorWithData) as ids and distances."""

    def __init__(self, row):
        self.ids = np.asarray([v.id for v in row], np.int64)
        self.distances = np.asarray([v.distance for v in row], np.float32)


def same_hamming(got, want) -> bool:
    """Equal distances, and the same ids at every distance but a row's
    last one (ties there may cross the k-th place)."""
    return len(got) == len(want) and all(
        np.array_equal(g.distances, w.distances)
        and all(set(g.ids[g.distances == v].tolist())
                == set(w.ids[w.distances == v].tolist())
                for v in np.unique(w.distances)[:-1])
        for g, w in zip(got, want))


def fp32_range_phase(index, x, queries, card, dev) -> None:
    """VectorIndex.range_search on the fp32 IVF_FLAT region (default
    nprobe 32): per query a radius midway between two neighbours' f64
    distances around the query's 300th nearest row, so that an f32 sum
    cannot move a row across it; the hits must equal the exact set within
    the radius (1 to 1,024 of them). k = 1,024 is past the kernels' lists:
    the search takes the plain arm (ivf_scan_scores), as the JAX package's
    k > 64 crossover does."""
    import torch

    from dingo_tpu_torch.index.ivf_flat import ivf_scan_scores

    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to(dev)
    calls = ivf_scan_scores.calls
    oks, counts, ms = [], [], []
    for qi in range(8):
        q = queries[qi]
        qd = torch.from_numpy(q).to(dev)
        d32 = ((xd - qd) ** 2).sum(1)
        t = float(torch.kthvalue(d32, 300).values)
        cand = torch.nonzero(d32 <= t + 5.0).flatten().cpu().numpy()
        d64 = ((x[cand].astype(np.float64) - q.astype(np.float64)) ** 2
               ).sum(1)
        s = np.sort(d64)
        j0, j1 = 250, min(len(s) - 1, 350)
        j = j0 + int(np.argmax(np.diff(s[j0:j1 + 1])))
        radius = float((s[j] + s[j + 1]) / 2)
        want = set(cand[d64 <= radius].tolist())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = index.range_search(q[None, :], radius)[0]
        ms.append((time.perf_counter() - t1) * 1e3)
        counts.append(len(got.ids))
        oks.append(set(got.ids.tolist()) == want
                   and bool((got.distances <= radius).all()))
    xd = None
    plain = ivf_scan_scores.calls - calls
    print(f"[{card}] fp32 IVF_FLAT range_search (nprobe 32, limit 1024): "
          f"hits per query {counts}, equal to the exact set {oks}; "
          f"{np.median(ms):.2f} ms a query (median, synchronous); plain-arm "
          f"searches {plain}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(all(oks), "fp32 IVF_FLAT range_search: the hits equal the exact "
          "set within the radius")
    check(all(1 <= c <= BIN_RANGE_MAX for c in counts),
          "fp32 IVF_FLAT range_search: every radius returns 1 to 1024 hits")
    check(plain == 8, "fp32 range_search took the plain arm (k 1024)")


def binary_phase(x, queries, extra, nlist, card, dev) -> dict:
    """The binary family at BASELINE.json config 2's corpus binarized by
    sign (768 bits, 96 packed bytes a row; the queries likewise): a
    BINARY_FLAT index (ingest, the exact int8 product's time and
    temporary bytes, exact hamming against a popcount reference on the
    card with ids modulo ties, pipelined ms, writes, device bytes against
    the packed size), a BINARY_IVF_FLAT index at nlist (train, recall@10
    modulo ties at nprobe 16/32/64, full probe == FLAT, pipelined ms,
    writes in place), range_search on the FLAT (hits == the exact set, the
    1024 cap), and a binary region through Storage and IndexService(node)
    (the brute force untrained, the index trained, a filter and a radius
    request; replies == the region's own index modulo ties). No B1-B5
    launch: the family stays on the plain arms, as in the JAX package."""
    import torch

    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.engine.storage import VECTOR_MAX_BATCH_COUNT
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import FilterSpec, IndexParameter, \
        IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.flat import flat_search_plain
    from dingo_tpu_torch.index.ivf_flat import ivf_scan_scores
    from dingo_tpu_torch.index.vector_reader import (
        VectorFilterMode,
        VectorReader,
    )
    from dingo_tpu_torch.ops.distance import Metric, _dot_pm1
    from dingo_tpu_torch.server.services import IndexService
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    t_phase = time.perf_counter()
    n, d = x.shape
    k = 10
    counters = zero_launches()
    plain0 = (flat_search_plain.calls, ivf_scan_scores.calls)
    out: dict = {}
    t0 = time.perf_counter()
    xb = np.packbits(x > 0, axis=1, bitorder="little")
    qb = np.packbits(queries > 0, axis=1, bitorder="little")
    eb = np.packbits(extra > 0, axis=1, bitorder="little")
    hd = exact_hamming_device(qb, xb, dev)
    kth_all = torch.topk(hd, k, dim=1, largest=False).values
    kth = kth_all[:, -1].cpu().numpy()
    hd_h = hd.cpu().numpy()
    hd = None
    print(f"[{card}] binary phase: {n} x {d} f32 rows binarized by sign to "
          f"{xb.shape[1]} bytes a row, {len(qb)} queries; exact hamming "
          f"(popcount on the card) {time.perf_counter() - t0:.1f} s; the "
          f"queries' nearest rows at {hd_h.min(1)[:8].tolist()} bits, "
          f"10th at {kth[:8].tolist()}", flush=True)

    def exact_of(qi, ids):
        return hd_h[qi, ids]

    def param(itype, **kw):
        return IndexParameter(index_type=itype, dimension=d,
                              metric=Metric.HAMMING, **kw)

    # -- BINARY_FLAT ----------------------------------------------------------
    flat = new_index(11, param(IndexType.BINARY_FLAT), device=dev)
    flat.store.reserve(n)
    t0 = time.perf_counter()
    for lo in range(0, n, 65536):
        flat.upsert(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                    xb[lo:lo + 65536])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    dev_bytes = flat.get_device_memory_size()
    packed = n * xb.shape[1]
    print(f"[{card}] BINARY_FLAT ingest {n} rows: {ingest_s:.1f} s "
          f"({n / ingest_s:.0f} rows/s); device bytes {dev_bytes} "
          f"({dev_bytes / packed:.2f}x the {packed} packed bytes: the "
          f"+/-1 int8 store, capacity {flat.store.capacity}, and its norms "
          "and mask)", flush=True)
    check(flat.store.vecs.dtype == torch.int8 and flat.store.vecs_blk is None,
          "BINARY_FLAT keeps a +/-1 int8 store and no blocked mirror")
    res = flat.search(qb, k)
    ok = hamming_reply_ok(res, kth, exact_of)[0]
    same_k = all(np.array_equal(r.distances, kth_all[qi].cpu().numpy())
                 for qi, r in enumerate(res))
    check(ok and same_k, "BINARY_FLAT: distances equal the exact hamming "
          "top-10 and every id's exact distance (ids modulo ties)")
    # the exact +/-1 product alone: ms and temporary bytes
    qpad = torch.from_numpy(flat._unpack_pm1(qb).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _dot_pm1(qpad, flat.store.vecs)
    torch.cuda.synchronize()
    tmp_bytes = torch.cuda.max_memory_allocated() - base
    pm1_ms = time_ms(lambda: _dot_pm1(qpad, flat.store.vecs), torch,
                     iters=10)
    plain_ms = time_ms(lambda: flat_search_plain(
        flat.store.vecs, flat.store.sqnorm, flat.store.device_mask(), qpad,
        k, Metric.INNER_PRODUCT), torch, iters=10)
    cap = flat.store.capacity
    pm1_bound, pm1_by = bound_of(cap * d + len(qb) * d + len(qb) * cap * 4,
                                 2.0 * len(qb) * cap * d, 1979e12)
    print(f"[{card}] exact +/-1 product (torch._int_mm, int8 x int8 -> "
          f"int32, as f32) [{len(qb)}, {d}] x [{cap}, {d}]: {pm1_ms:.4f} ms, "
          f"temporary bytes {tmp_bytes} (int32 and f32 [{max(24, len(qb))}, "
          f"{cap}] and the padded int8 query); bound {pm1_bound:.4f} ms "
          f"({pm1_by}); the whole plain-arm search (product + masked top-"
          f"{k}) {plain_ms:.4f} ms", flush=True)
    out["pm1_ms"], out["pm1_tmp_bytes"] = pm1_ms, tmp_bytes
    out["flat_plain_ms"] = plain_ms
    reads = []
    for _ in range(ROUNDS):
        reads.append(pipelined_ms(flat, qb, k, None))
    out["flat_ms"] = median_spread(reads)[0]
    print(f"[{card}] BINARY_FLAT pipelined ms per {len(qb)}-query batch: "
          f"{spread_text(reads)}", flush=True)
    print(f"[{card}] BINARY_FLAT profile of a pipelined window: "
          + device_profile(pipelined_window(flat, qb, k, None, reps=5)),
          flush=True)

    # -- range search on the FLAT: the exact counts within each radius from
    # the popcount reference; the largest radius giving every query 1 to
    # 1,024 hits
    cum = np.cumsum(np.stack([np.bincount(row, minlength=d + 1)
                              for row in hd_h]), axis=1)
    fits = [r_ for r_ in range(d + 1)
            if cum[:, r_].max() <= BIN_RANGE_MAX and cum[:, r_].min() >= 1]
    check(bool(fits), "binary range_search: a radius gives every query 1 "
          "to 1024 rows")
    radius = float(max(fits or [int(kth.max())]))
    t0 = time.perf_counter()
    rres = flat.range_search(qb, radius)
    range_ms = (time.perf_counter() - t0) * 1e3
    counts = [len(r.ids) for r in rres]
    exact_sets = all(set(r.ids.tolist()) == set(
        np.flatnonzero(hd_h[qi] <= radius).tolist())
        for qi, r in enumerate(rres))
    capped = flat.range_search(qb[:4], float(d))
    print(f"[{card}] BINARY_FLAT range_search at radius {radius:.0f} bits: "
          f"hits per query min {min(counts)} max {max(counts)}, equal to "
          f"the exact set {exact_sets}, {range_ms:.1f} ms (64 queries, "
          f"synchronous); radius {d}: {[len(r.ids) for r in capped]} hits",
          flush=True)
    check(exact_sets and 1 <= min(counts) and max(counts) <= BIN_RANGE_MAX,
          "binary range_search: 1-1024 hits a query, equal to the exact set")
    check(all(len(r.ids) == BIN_RANGE_MAX for r in capped),
          "binary range_search: the 1024 cap holds")
    out["range_ms"] = range_ms

    # -- BINARY_IVF_FLAT ------------------------------------------------------
    ivf = new_index(12, param(IndexType.BINARY_IVF_FLAT, ncentroids=nlist,
                              default_nprobe=32), device=dev)
    ivf.store.reserve(n)
    t0 = time.perf_counter()
    for lo in range(0, n, 65536):
        ivf.upsert(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                   xb[lo:lo + 65536])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ivf.train()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ivf.search(qb[:1], k, nprobe=1)            # builds the bucketed view
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    view = ivf._view
    print(f"[{card}] BINARY_IVF_FLAT (nlist {nlist}): ingest "
          f"{t1 - t0:.1f} s, train {t2 - t1:.1f} s (float k-means over "
          f"+/-1 space, float centroids), view {t3 - t2:.1f} s ({view.nbuckets}"
          f" buckets of {view.cap_list} rows, max spill {view.max_spill}); "
          f"block norms {ivf._bucket_bsq is not None}", flush=True)
    out["train_s"] = t2 - t1
    check(ivf._bucket_bsq is None and ivf._buckets.dtype == torch.int8,
          "BINARY_IVF_FLAT: int8 buckets and no pruning metadata")
    recalls = {}
    for nprobe in (16, 32, 64):
        ok, rec = hamming_reply_ok(ivf.search(qb, k, nprobe=nprobe), kth,
                                   exact_of)
        recalls[nprobe] = rec
        check(ok, f"BINARY_IVF_FLAT nprobe {nprobe}: every returned "
              "distance equals its id's exact hamming distance")
    print(f"[{card}] BINARY_IVF_FLAT recall@10 (hits at most the exact "
          f"10th distance): " + ", ".join(
              f"nprobe {p_} {r_:.4f}" for p_, r_ in recalls.items()),
          flush=True)
    out["recall"] = recalls
    check(max(recalls.values()) >= 0.95,
          "BINARY_IVF_FLAT recall@10 >= 0.95 at some nprobe")
    full = ivf.search(qb, k, nprobe=nlist)
    check(all(np.array_equal(a.distances, b.distances)
              for a, b in zip(full, res))
          and hamming_reply_ok(full, kth, exact_of)[0],
          "BINARY_IVF_FLAT at full probe == BINARY_FLAT (distances equal, "
          "ids modulo ties)")
    gate = min(p_ for p_, r_ in recalls.items()
               if r_ >= 0.95) if max(recalls.values()) >= 0.95 else 32
    reads = []
    for _ in range(ROUNDS):
        reads.append(pipelined_ms(ivf, qb, k, gate))
    out["ivf_ms"], out["ivf_nprobe"] = median_spread(reads)[0], gate
    print(f"[{card}] BINARY_IVF_FLAT pipelined ms per {len(qb)}-query batch "
          f"at nprobe {gate}: {spread_text(reads)}", flush=True)
    print(f"[{card}] BINARY_IVF_FLAT profile of a pipelined window: "
          + device_profile(pipelined_window(ivf, qb, k, gate, reps=5)),
          flush=True)

    # -- writes on both -----------------------------------------------------
    up_ids = np.arange(BIN_UPSERTS, dtype=np.int64)
    del_ids = np.arange(BIN_UPSERTS, BIN_UPSERTS + BIN_DELETES,
                        dtype=np.int64)
    rebuilds = ivf.full_rebuilds
    t0 = time.perf_counter()
    for idx in (flat, ivf):
        idx.upsert(up_ids, eb[:BIN_UPSERTS])
        idx.delete(del_ids)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    probe_up, probe_del = eb[:64], xb[BIN_UPSERTS:BIN_UPSERTS + 64]
    for name, idx, kw in (("BINARY_FLAT", flat, {}),
                          ("BINARY_IVF_FLAT", ivf, {"nprobe": gate})):
        r_up = idx.search(probe_up, k, **kw)
        r_del = idx.search(probe_del, k, **kw)
        vis = all(r.distances[0] == 0.0 and i in r.ids[r.distances == 0]
                  for i, r in enumerate(r_up))
        gone = not any(set(r.ids.tolist()) & set(del_ids.tolist())
                       for r in r_del)
        check(vis and gone, f"{name}: {BIN_UPSERTS} upserts and "
              f"{BIN_DELETES} deletes visible to the next search")
    check(ivf.full_rebuilds == rebuilds and not ivf._view_dirty,
          "BINARY_IVF_FLAT: the writes landed in the view in place")
    print(f"[{card}] binary writes: {BIN_UPSERTS} upserts + {BIN_DELETES} "
          f"deletes on both indexes in {write_s:.2f} s", flush=True)

    flat = ivf = None
    torch.cuda.empty_cache()

    # -- a binary region through Storage and IndexService(node), on the
    # first BIN_REGION_N rows against their own exact k-th distances -------
    n_r = min(n, BIN_REGION_N)
    kth_r = np.partition(hd_h[:, :n_r], k - 1, axis=1)[:, k - 1]
    node = MonoStoreNode(device=dev)
    region = node.create_region(RegionDefinition(
        region_id=21, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=param(IndexType.BINARY_IVF_FLAT, ncentroids=nlist,
                              default_nprobe=32)))
    t0 = time.perf_counter()
    for lo in range(0, n_r, VECTOR_MAX_BATCH_COUNT):
        hi = min(n_r, lo + VECTOR_MAX_BATCH_COUNT)
        node.storage.vector_add(region, np.arange(lo, hi, dtype=np.int64),
                                xb[lo:hi])
    ingest_s = time.perf_counter() - t0
    brute = []
    bf = VectorReader._brute_force_search

    def spy(self, *a, **kw):
        brute.append(1)
        return bf(self, *a, **kw)

    orig_async = VectorReader.vector_batch_search_async
    VectorReader._brute_force_search = spy
    try:
        t0 = time.perf_counter()
        rows_u = node.storage.vector_batch_search(region, qb, k)
        untrained_s = time.perf_counter() - t0
        ok_u = hamming_reply_ok([Reply(r) for r in rows_u], kth_r,
                                exact_of)[0]
        t0 = time.perf_counter()
        node.index_manager.rebuild(region)
        rebuild_s = time.perf_counter() - t0
        n_brute = len(brute)
        own = region.vector_index_wrapper.own_index
        direct = own.search(qb, k, nprobe=32)
        miss0 = METRICS.counter("pipeline.staged_miss").get()
        dispatches = {"async": 0, "sync_fallback": 0}

        def spy_async(self, *a, **kw_):
            thunk = orig_async(self, *a, **kw_)
            dispatches["sync_fallback" if thunk.__name__ == "sync_thunk"
                       else "async"] += 1
            return thunk

        VectorReader.vector_batch_search_async = spy_async
        # max_batch 128: the 64 rows stay under the cap, so the window's
        # timer flushes them through the pipelined arm (a full batch runs
        # inline on the serial arm, as in the JAX package)
        svc = IndexService(node, window_ms=2.0, max_batch=128)
        try:
            futs = [svc.submit(21, qb[i:i + 4], k, nprobe=32)
                    for i in range(0, len(qb), 4)]
            replies = [row for f in futs for row in f.result(timeout=120)]
            plain_dispatches = dict(dispatches)
            filt_ids = np.arange(0, n_r, 7, dtype=np.int64)[:50000]
            fut_f = svc.submit(21, qb[:8], k, nprobe=32,
                               filter_mode=VectorFilterMode.VECTOR_ID,
                               vector_ids=filt_ids.tolist())
            rrad = float(kth_r.max())
            fut_r = svc.submit(21, qb[:8], 64, nprobe=32, radius=rrad)
            got_f, got_r = fut_f.result(timeout=120), fut_r.result(
                timeout=120)
        finally:
            svc.close()
        misses = METRICS.counter("pipeline.staged_miss").get() - miss0
        direct_f = own.search(qb[:8], k, FilterSpec(include_ids=filt_ids),
                              nprobe=32)
        direct_r = own.range_search(qb[:8], rrad, limit=64)
    finally:
        VectorReader._brute_force_search = bf
        VectorReader.vector_batch_search_async = orig_async
        node.stop()

    def same(rows, want):
        return same_hamming([Reply(r) for r in rows], want)

    check(n_brute >= 1 and ok_u, "binary region untrained: the reader's "
          "brute force (a temporary BINARY_FLAT) serves exact hamming")
    check(n_brute == len(brute), "binary region trained: the index serves "
          "(no brute force after the rebuild)")
    check(same(replies, direct), "binary region: IndexService replies == "
          "the region's own index (distances equal, ids modulo ties)")
    check(plain_dispatches["async"] > 0
          and plain_dispatches["sync_fallback"] == 0
          and misses >= plain_dispatches["async"],
          "binary region: the coalesced uint8 batches dispatch on the "
          "pipelined arm, and each staged upload is missed by the packed "
          "queries' unpacking (the index pads its own, as the JAX "
          f"package's does) ({plain_dispatches}, {misses} misses)")
    check(same(got_f, direct_f) and all(v.id % 7 == 0 for row in got_f
                                        for v in row),
          "binary region: a VECTOR_ID filter request passes through")
    check(same(got_r, direct_r) and all(v.distance <= rrad for row in got_r
                                        for v in row),
          "binary region: a radius request passes through")
    print(f"[{card}] binary region ({n_r} rows, BINARY_IVF_FLAT nlist {nlist})"
          f": ingest through Storage.vector_add {ingest_s:.1f} s, untrained "
          f"search (brute force) {untrained_s:.2f} s, rebuild {rebuild_s:.1f}"
          f" s ({node.index_manager.build_stats.get(21)}); "
          f"reader dispatches {dispatches} (the radius request falls back "
          f"to the sync path by design), pipeline.staged_miss {misses}",
          flush=True)
    own = None
    out["launches"] = read_launches(counters)
    plain = (flat_search_plain.calls - plain0[0],
             ivf_scan_scores.calls - plain0[1])
    out["plain"] = plain
    check(not any(out["launches"].values()),
          f"binary phase: no kernel launched ({out['launches']})")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] binary phase: plain-arm searches FLAT {plain[0]}, IVF "
          f"{plain[1]}; kernel launches {out['launches']}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def diskann_phase(x, queries, extra, gt, nlist, card, dev) -> dict:
    """The diskann role's core at BASELINE.json config 3's widths (d 768,
    m 96, nbits 8) over the smoke's rows, nlist `nlist`, L2, under
    tempfile.gettempdir(): push_data in 65,536-row batches (rows/s, file
    bytes), the build (coarse fit, PQ fit, encode), the load (device
    bytes: codes and centroids only), searches at nprobe 32 with the
    default rerank factor 32 (ms a 64-query batch split into the ADC
    scan, the disk gather and the rerank; recall@10 >= 0.95; every
    distance against the f64 distance of its id), a restart that serves
    the same ids, upserts in place and the item manager's asynchronous
    rebuild, then reset, close and destroy (the files gone). The ADC scan
    is the IVF_PQ XLA arm (plain torch), as in the JAX package."""
    import shutil
    import tempfile

    import torch

    from dingo_tpu_torch.diskann import CoreState, DiskAnnCore, \
        DiskAnnItemManager
    from dingo_tpu_torch.index.base import IndexParameter, IndexType, \
        tensor_bytes
    from dingo_tpu_torch.index.ivf_pq import _ivfpq_scan_kernel
    from dingo_tpu_torch.ops.distance import Metric

    t_phase = time.perf_counter()
    n, d = x.shape
    k = 10
    counters = zero_launches()
    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    n_dk = min(n, DK_N)
    need = int(n_dk * d * 4 * 1.25) + (1 << 30)
    if free < need:
        n_dk = int((free - (1 << 30)) / (d * 4 * 1.25)) // DK_PUSH * DK_PUSH
    print(f"[{card}] DiskANN phase: {free} bytes free under {root}; "
          + (f"the rows cut from {n} to {n_dk}, {need} bytes needed"
             if n_dk < n else f"{n} rows need ~{need} bytes"), flush=True)
    check(n_dk > 0, "DiskANN phase: the disk holds its rows")
    xs = x[:n_dk]
    gt_dk = gt if n_dk == n else exact_topk_device(xs, queries, k, dev)
    tmp = tempfile.mkdtemp(prefix="dingo-diskann-", dir=root)
    out: dict = {"rows": n_dk}
    param = IndexParameter(index_type=IndexType.DISKANN, dimension=d,
                           metric=Metric.L2, ncentroids=nlist,
                           nsubvector=DK_M, nbits_per_idx=8,
                           default_nprobe=DK_NPROBE)
    mgr = DiskAnnItemManager(os.path.join(tmp, "items"), device=dev)
    try:
        core = mgr.create(1, param)
        t0 = time.perf_counter()
        ids = np.arange(n_dk, dtype=np.int64)
        for lo in range(0, n_dk, DK_PUSH):
            core.push_data(ids[lo:lo + DK_PUSH], xs[lo:lo + DK_PUSH],
                           has_more=lo + DK_PUSH < n_dk)
        push_s = time.perf_counter() - t0
        fbytes = os.path.getsize(core._data_path())
        check(core.status() is CoreState.IMPORTED and core.count == n_dk
              and fbytes == n_dk * d * 4, "DiskANN: every row pushed, the "
              "file holds them, the import ended")
        t0 = time.perf_counter()
        core.build()
        build_s = time.perf_counter() - t0
        bt = core.build_timings
        t0 = time.perf_counter()
        core.load()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        dbytes = tensor_bytes(core)
        print(f"[{card}] DiskANN push_data {n_dk} rows in "
              f"{n_dk // DK_PUSH + (n_dk % DK_PUSH > 0)} pushes: "
              f"{push_s:.1f} s ({n_dk / push_s:.0f} rows/s), vectors.f32 "
              f"{fbytes} bytes; build {build_s:.1f} s (sample read "
              f"{bt['sample_s']:.1f}, coarse fit {bt['coarse_fit_s']:.1f}, "
              f"PQ fit {bt['pq_fit_s']:.1f}, encode {bt['encode_s']:.1f}, "
              f"save {bt['save_s']:.1f}); load {load_s:.1f} s, device bytes "
              f"{dbytes} ({dbytes / fbytes:.3f} of the rows' bytes)",
              flush=True)
        out.update(push_s=push_s, build_s=build_s, load_s=load_s,
                   device_bytes=dbytes, build=dict(bt))
        check(dbytes < fbytes / 4, "DiskANN: the device holds codes and "
              "centroids, not rows")
        calls = _ivfpq_scan_kernel.calls
        res = core.search(queries, k, nprobe=DK_NPROBE)
        got_ids = [r[0] for r in res]
        rec = sum(len(set(g.tolist()) & set(w.tolist()))
                  for g, w in zip(got_ids, gt_dk)) / (len(queries) * k)
        dist_ok = all(np.allclose(r[1], exact_dists(xs, queries[qi], r[0]),
                                  rtol=1e-4, atol=1e-3)
                      for qi, r in enumerate(res))
        check(rec >= 0.95, f"DiskANN recall@10 >= 0.95 at nprobe "
              f"{DK_NPROBE} (got {rec:.4f})")
        check(dist_ok and all(len(r[0]) == k for r in res),
              "DiskANN: every returned distance == the f64 distance of its "
              "id (rtol 1e-4, atol 1e-3)")
        splits, walls = [], []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            core.search(queries, k, nprobe=DK_NPROBE)
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(core.search_timings))
        med = {key: float(np.median([s_[key] for s_ in splits]))
               for key in splits[0]}
        out.update(recall=rec, ms=float(np.median(walls)), split=med)
        print(f"[{card}] DiskANN search nprobe {DK_NPROBE}, rerank factor "
              f"32 (k' {k * 32}): recall@10 {rec:.4f}; ms per "
              f"{len(queries)}-query batch {spread_text(walls)}; split "
              f"(medians): ADC scan {med['adc_ms']:.2f}, disk gather "
              f"{med['gather_ms']:.2f}, rerank {med['rerank_ms']:.2f}",
              flush=True)
        print(f"[{card}] DiskANN profile of one search: " + device_profile(
            lambda: core.search(queries, k, nprobe=DK_NPROBE)), flush=True)
        check(_ivfpq_scan_kernel.calls - calls == ROUNDS + 2,
              "DiskANN: each search ran the IVF_PQ XLA arm once")
        # a restart: a new core on the same directory
        core2 = DiskAnnCore(1, param, core.dir, device=dev)
        adopted = core2.count
        loaded = core2.try_load()
        res2 = core2.search(queries, k, nprobe=DK_NPROBE)
        core2.close()
        core2 = None
        check(adopted == n_dk and loaded and all(
            np.array_equal(a[0], b[0]) for a, b in zip(res, res2)),
            "DiskANN restart: a new core adopts the count and try_load "
            "serves the same ids")
        # upserts in place, then the item manager's asynchronous rebuild
        up = extra[:4096]
        core.reset()
        core.push_data(ids[:len(up)], up, has_more=False)
        check(core.count == n_dk and os.path.getsize(core._data_path())
              == fbytes, "DiskANN upsert: rows replaced in place")
        t0 = time.perf_counter()
        mgr.submit_build(1)
        deadline = time.monotonic() + 600
        while core.status() in (CoreState.IMPORTED, CoreState.BUILDING) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        rebuild_s = time.perf_counter() - t0
        check(core.status() is CoreState.BUILT, "DiskANN: the item "
              f"manager's asynchronous build reaches built "
              f"({core.status().value} {core.last_error})")
        core.load()
        res3 = core.search(up[:64], k, nprobe=DK_NPROBE)
        check(all(int(r[0][0]) == i and float(r[1][0]) <= 1e-3
                  for i, r in enumerate(res3)),
              "DiskANN: the upserted rows are found after the rebuild")
        core.close()
        st_close = core.status()
        core.reset()
        st_reset = core.status()
        path = core.dir
        mgr.destroy(1)
        check(st_close is CoreState.BUILT and st_reset is CoreState.IMPORTED
              and not os.path.exists(path) and mgr.get(1) is None,
              "DiskANN close -> built, reset -> imported, destroy removes "
              "the files")
        out["rebuild_s"] = rebuild_s
        print(f"[{card}] DiskANN restart served the same ids; asynchronous "
              f"rebuild after {len(up)} upserts {rebuild_s:.1f} s",
              flush=True)
    finally:
        mgr.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = read_launches(counters)
    check(not any(out["launches"].values()),
          f"DiskANN phase: no kernel launched ({out['launches']})")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] DiskANN phase: {out['seconds']:.1f} s", flush=True)
    return out


#: rows of the LSM phase's IVF_FLAT region: the 1M region's rows cut to
#: 65,536 for the smoke's 1,200 s limit (PERF.md section 4); full width
LSM_N = 65_536
#: the LSM phase's coarse lists (the region phase's 1,024 scaled to its rows)
LSM_NLIST = 64


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f_))
               for r, _, fs in os.walk(path) for f_ in fs)


def lsm_phase(x, queries, card, dev) -> dict:
    """A one-replica StoreNode on the native LSM engine (LsmRawEngine over
    csrc/host/lsm.cc, built with g++ at first use) in a temporary directory
    on local disk, holding an IVF_FLAT region of LSM_N x d: ingest through
    Storage.vector_add; an untrained search (the reader's brute force, B4);
    train and search (B3); stop the node and close the engine; reopen from
    the same directory, recover (meta, raft member, the index rebuilt from
    the engine scan) and search again; then flush, compact, checkpoint
    and restore. Checks: the ids after the reopen and the restore equal
    those before (modulo ties), SST counts stay bounded after compaction,
    and every acknowledged row is there after each step."""
    import shutil
    import tempfile

    import torch

    from dingo_tpu_torch.engine.lsm_engine import LsmRawEngine
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.ops import kernel_ivf_pruned, kernel_topk_pruned
    from dingo_tpu_torch.ops.distance import Metric
    from dingo_tpu_torch.raft import LocalTransport
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    n, d = x.shape
    k, rid = 10, 7
    b3 = kernel_ivf_pruned.ivf_pruned_topk
    b4 = kernel_topk_pruned.pruned_fused_topk
    out: dict = {}
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dingo_lsm_smoke_")
    path, ckpt = os.path.join(root, "store"), os.path.join(root, "ckpt")
    definition = RegionDefinition(
        region_id=rid, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), peers=["s0"],
        region_type=RegionType.INDEX, index_parameter=IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=d, metric=Metric.L2,
            ncentroids=LSM_NLIST, default_nprobe=REGION_NPROBE))
    gt = exact_topk_device(x, queries, k, dev)

    def open_node():
        raw = LsmRawEngine(path)
        return raw, StoreNode("s0", LocalTransport(), None, raw_engine=raw,
                              raft_kw={"seed": 0, **REGION_RAFT}, device=dev)

    def leader_of(node, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rn = node.engine.get_node(rid)
            if rn is not None and rn.is_leader():
                return
            time.sleep(0.02)
        raise SmokeFailure("LSM phase: the one replica never led")

    def ids_of(res):
        return [[v.id for v in row] for row in res]

    raw = node = None
    try:
        raw, node = open_node()
        region = node.create_region(definition)
        leader_of(node)
        t0 = time.perf_counter()
        for lo in range(0, n, REGION_PROPOSAL_ROWS):
            hi = min(n, lo + REGION_PROPOSAL_ROWS)
            node.storage.vector_add(region, np.arange(lo, hi, dtype=np.int64),
                                    x[lo:hi])
        ingest_s = time.perf_counter() - t0
        out["ingest_rows_per_s"] = n / ingest_s
        ssts = raw.sst_counts()
        print(f"[{card}] LSM phase: {n} x {d} rows in {REGION_PROPOSAL_ROWS}"
              f"-row proposals through Storage.vector_add on one replica: "
              f"{ingest_s:.1f} s, {n / ingest_s:.1f} rows/s; SSTs a CF "
              f"{ {cf: c for cf, c in ssts.items() if c} }; on disk "
              f"{dir_bytes(path) / 2**20:.1f} MiB", flush=True)
        l4 = b4.launches
        untrained = ids_of(node.storage.vector_batch_search(region, queries,
                                                            k))
        check(b4.launches > l4 and same_modulo_ties(x, queries, untrained,
                                                    gt),
              "LSM phase: the untrained search ran on B4 and returned the "
              f"exact top-{k} modulo ties")
        t0 = time.perf_counter()
        node.index_manager.rebuild(region)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        l3 = b3.launches
        before = ids_of(node.storage.vector_batch_search(
            region, queries, k, nprobe=REGION_NPROBE))
        rec = sum(len(set(r) & set(g.tolist()))
                  for r, g in zip(before, gt)) / (len(gt) * k)
        out["recall"] = rec
        check(b3.launches > l3 and rec >= 0.95,
              f"LSM phase: the trained search ran on B3, recall@{k} "
              f"{rec:.4f} >= 0.95")
        node.stop()
        raw.close()
        node = raw = None
        # -- reopen from the same directory ------------------------------
        t0 = time.perf_counter()
        raw, node = open_node()
        t_open = time.perf_counter() - t0
        recovered = node.recover()
        reopen_s = time.perf_counter() - t0
        st = node.index_manager.build_stats.get(rid, {})
        region = node.get_region(rid)
        leader_of(node)
        count = node.storage.vector_count(region)
        l3 = b3.launches
        after = ids_of(node.storage.vector_batch_search(
            region, queries, k, nprobe=REGION_NPROBE))
        out["reopen_s"] = reopen_s
        out["scan_share"] = st.get("scan_ms", 0.0) / 1e3 / reopen_s
        print(f"[{card}] LSM phase: train and build {build_s:.2f} s; "
              f"reopen + recover + rebuild {reopen_s:.2f} s (engine open "
              f"{t_open:.2f} s, engine scan {st.get('scan_ms', 0) / 1e3:.2f}"
              f" s = {out['scan_share']:.3f} of it, index ingest "
              f"{st.get('ingest_ms', 0) / 1e3:.2f} s, train "
              f"{st.get('train_ms', 0) / 1e3:.2f} s); recall@{k} {rec:.4f}",
              flush=True)
        check(recovered == 1 and count == n and b3.launches > l3
              and same_modulo_ties(x, queries, after, before),
              f"LSM phase: after the reopen the region holds all {n} "
              f"acknowledged rows ({count}) and B3 returns the ids of before "
              "the reopen modulo ties")
        # -- flush, compact, checkpoint and restore -----------------------
        raw.flush()
        flushed = raw.sst_counts()
        raw.compact()
        compacted = raw.sst_counts()
        t0 = time.perf_counter()
        raw.checkpoint(ckpt)
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw.restore_checkpoint(ckpt)
        restore_s = time.perf_counter() - t0
        count2 = node.storage.vector_count(region)
        restored = ids_of(node.storage.vector_batch_search(
            region, queries, k, nprobe=REGION_NPROBE))
        out["disk_bytes"] = dir_bytes(path)
        out["ckpt_bytes"] = dir_bytes(ckpt)
        print(f"[{card}] LSM phase: SSTs a CF after the flush "
              f"{ {cf: c for cf, c in flushed.items() if c} }, after the "
              f"compaction { {cf: c for cf, c in compacted.items() if c} }; "
              f"checkpoint {ckpt_s:.2f} s ({out['ckpt_bytes'] / 2**20:.1f} "
              f"MiB), restore {restore_s:.2f} s; on disk "
              f"{out['disk_bytes'] / 2**20:.1f} MiB for "
              f"{n * d * 4 / 2**20:.1f} MiB of vectors", flush=True)
        check(all(c <= 1 for c in compacted.values())
              and all(compacted[cf] <= max(1, flushed[cf]) for cf in flushed),
              "LSM phase: the compaction leaves at most one SST a CF")
        check(count2 == n and restored == after,
              f"LSM phase: after the checkpoint's restore the engine holds "
              f"all {n} rows ({count2}) and the search returns the same ids")
    finally:
        if node is not None:
            node.stop()
        if raw is not None:
            raw.close()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] LSM phase: {out['seconds']:.1f} s", flush=True)
    return out


#: the transactions and documents phase: Percolator transactions over
#: TXN_KEYS keys, and TXN_DOCS typed documents in a DOCUMENT region
TXN_KEYS, TXN_ROUNDS, TXN_DOCS = 64, 400, 10_000
#: the lock TTL of the transactions the script abandons
TXN_TTL_MS = 20
DOC_WORDS = ("red blue green shoes hat coat warm running walking winter "
             "waterproof stylish comfortable hiking light heavy raft store "
             "vector search engine storage region index").split()


def txn_doc_phase(card, dev) -> dict:
    """Host paths on the card's machine: a KV region on a one-replica
    StoreNode runs a seeded script of Percolator transactions (prewrite
    and commit, write conflicts, a lock seen by a reader, check_txn_status
    and resolve_lock after a lock's TTL, batch_rollback, gc below a safe
    point), and its snapshot reads are held against a dict model; then a
    DOCUMENT region on three raft replicas takes TXN_DOCS typed documents,
    answers BM25 and range queries, takes a delete, and after every node
    restarts on its engine (recover rebuilds the index) answers the same."""
    import random

    from dingo_tpu_torch.engine import write_data as wd
    from dingo_tpu_torch.engine.txn import (
        KeyIsLocked,
        Mutation,
        Op,
        TxnEngine,
        WriteConflict,
    )
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.raft import LocalTransport, NotLeader
    from dingo_tpu_torch.store.node import StoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    out: dict = {}
    t_phase = time.perf_counter()
    rng = random.Random(43)

    def wait_leader(nodes, rid, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            lead = [s for s, n_ in nodes.items()
                    if n_.engine.get_node(rid) is not None
                    and n_.engine.get_node(rid).is_leader()]
            if len(lead) == 1:
                return lead[0]
            time.sleep(0.02)
        raise SmokeFailure(f"txn/doc phase: region {rid} has no leader")

    # -- Percolator transactions against a dict model ----------------------
    node = StoreNode("t0", LocalTransport(), None,
                     raft_kw={"seed": 0, **REGION_RAFT}, device=dev)
    try:
        region = node.create_region(RegionDefinition(
            region_id=11, start_key=b"", end_key=b"\xff" * 8, peers=["t0"],
            region_type=RegionType.STORE))
        wait_leader({"t0": node}, 11)
        txn = TxnEngine(node.engine, region)
        keys = [b"acct%03d" % i for i in range(TXN_KEYS)]
        model: dict = {}
        ts = [100]

        def next_ts():
            # even: an odd ts (a stale transaction's start) is never taken
            ts[0] += 2
            return ts[0]

        seen = {"committed": 0, "conflict": 0, "locked_read": 0,
                "rolled_back": 0, "resolved": 0}
        t0 = time.perf_counter()
        for _ in range(TXN_ROUNDS):
            ks = rng.sample(keys, rng.randrange(1, 4))
            start = next_ts()
            muts = [Mutation(Op.DELETE, k_) if rng.random() < 0.1 else
                    Mutation(Op.PUT, k_, b"v%d" % start) for k_ in ks]
            fate = rng.random()
            # an abandoned transaction's locks live TXN_TTL_MS
            txn.prewrite(muts, ks[0], start,
                         lock_ttl_ms=TXN_TTL_MS if 0.7 <= fate < 0.85
                         else 3000)
            if fate < 0.7:
                commit = next_ts()
                txn.commit(ks, start, commit)
                for m in muts:
                    if m.op is Op.PUT:
                        model[m.key] = m.value
                    else:
                        model.pop(m.key, None)
                seen["committed"] += 1
                # a transaction that started before this commit conflicts
                try:
                    txn.prewrite([Mutation(Op.PUT, ks[0], b"stale")], ks[0],
                                 start - 1)
                    raise SmokeFailure("a stale prewrite was accepted")
                except WriteConflict:
                    seen["conflict"] += 1
                    txn.batch_rollback([ks[0]], start - 1)
            elif fate < 0.85:
                # a reader meets the lock; once its TTL has run out the
                # reader rolls the transaction back through its primary
                # and resolves the secondaries' locks
                try:
                    txn.get(ks[-1], next_ts())
                    raise SmokeFailure("a read passed a live lock")
                except KeyIsLocked:
                    seen["locked_read"] += 1
                time.sleep(2 * TXN_TTL_MS / 1e3)
                status = txn.check_txn_status(ks[0], start, next_ts())
                if status["action"] != "rolled_back":
                    raise SmokeFailure(f"an expired primary lock: {status}")
                seen["resolved"] += txn.resolve_lock(start, 0)
            else:
                txn.batch_rollback(ks, start)
                seen["rolled_back"] += 1
        read_ts = next_ts()
        got = dict(txn.scan(b"", b"\xff", read_ts))
        safe = read_ts
        removed = txn.gc(safe)
        got_after_gc = dict(txn.scan(b"", b"\xff", next_ts()))
        dump = txn.dump()
        txn_s = time.perf_counter() - t0
        out["txn"] = dict(seen, seconds=txn_s, gc_removed=removed,
                          locks_left=len(dump["locks"]))
        print(f"[{card}] txn phase: {TXN_ROUNDS} transactions over "
              f"{TXN_KEYS} keys through raft in {txn_s:.2f} s ({seen}); gc "
              f"below the safe point removed {removed} records; dump: "
              f"{len(dump['writes'])} writes, {len(dump['datas'])} data "
              f"rows, {len(dump['locks'])} locks", flush=True)
        check(got == model and got_after_gc == model and not dump["locks"]
              and seen["conflict"] and seen["locked_read"],
              f"txn phase: the snapshot reads equal the dict model "
              f"({len(model)} keys) before and after gc, no lock is left")
    finally:
        node.stop()

    # -- a DOCUMENT region under raft ---------------------------------------
    schema = {"title": "text", "body": "text", "price": "i64",
              "rating": "f64", "in_stock": "bool"}
    docs = [{"title": " ".join(rng.choice(DOC_WORDS)
                               for _ in range(rng.randrange(1, 4))),
             "body": " ".join(rng.choice(DOC_WORDS)
                              for _ in range(rng.randrange(5, 25))),
             "price": rng.randrange(1, 1000),
             "rating": round(rng.uniform(0, 5), 2),
             "in_stock": rng.random() < 0.7} for _ in range(TXN_DOCS)]
    queries = [("red shoes", "or"), ("warm winter coat", "and"),
               ("running shoes", "phrase"),
               ("hiking price:[100 TO 300]", "query"),
               ("+vector -raft rating:[4.0 TO 5.0]", "query"),
               ('"waterproof hiking" in_stock:true', "query")]
    peers = ["d0", "d1", "d2"]

    def answers(nodes, rid):
        res = {}
        for s_, n_ in nodes.items():
            idx = n_.get_region(rid).document_index
            res[s_] = ([idx.search(q, topk=20, mode=m) for q, m in queries]
                       + [idx.range_select("price", 100, 200),
                          idx.range_select("rating", 4.5, None),
                          idx.count()])
        return res

    def start_nodes(raws=None):
        transport = LocalTransport()
        return {s_: StoreNode(s_, transport, None,
                              raft_kw={"seed": i, **REGION_RAFT},
                              raw_engine=None if raws is None else raws[s_],
                              device=dev)
                for i, s_ in enumerate(peers)}

    def propose(nodes, rid, data):
        for _ in range(20):
            s_ = wait_leader(nodes, rid)
            try:
                nodes[s_].engine.write(nodes[s_].get_region(rid), data)
                return
            except NotLeader:
                time.sleep(0.1)
        raise SmokeFailure("doc phase: leadership never stabilized")

    def settle(nodes, rid, timeout=60.0):
        target = nodes[wait_leader(nodes, rid)].engine.get_node(
            rid).commit_index
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(n_.engine.get_node(rid).last_applied >= target
                   for n_ in nodes.values()):
                return
            time.sleep(0.02)
        raise SmokeFailure("doc phase: the replicas did not apply")

    rid = 12
    nodes = start_nodes()
    try:
        for n_ in nodes.values():
            n_.create_region(RegionDefinition(
                region_id=rid, start_key=vcodec.encode_vector_key(0, 0),
                end_key=vcodec.encode_vector_key(1), peers=peers,
                region_type=RegionType.DOCUMENT, document_schema=schema))
        t0 = time.perf_counter()
        for lo in range(0, TXN_DOCS, 1000):
            propose(nodes, rid, wd.DocumentAddData(
                ts=lo + 1, ids=list(range(lo, lo + 1000)),
                documents=docs[lo:lo + 1000]))
        deleted = list(range(0, TXN_DOCS, 97))
        propose(nodes, rid, wd.DocumentDeleteData(ts=TXN_DOCS + 1,
                                                  ids=deleted))
        settle(nodes, rid)
        add_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        before = answers(nodes, rid)
        query_s = (time.perf_counter() - t0) / len(peers)
        raws = {s_: n_.raw for s_, n_ in nodes.items()}
    finally:
        for n_ in nodes.values():
            n_.stop()
    nodes = start_nodes(raws)
    try:
        t0 = time.perf_counter()
        recovered = [n_.recover() for n_ in nodes.values()]
        restart_s = time.perf_counter() - t0
        wait_leader(nodes, rid)
        after = answers(nodes, rid)
    finally:
        for n_ in nodes.values():
            n_.stop()
    lead = before[peers[0]]
    hits = sum(len(r) for r in lead[:len(queries)])
    out["doc"] = {"add_s": add_s, "query_s": query_s,
                  "restart_s": restart_s, "count": lead[-1], "hits": hits}
    print(f"[{card}] doc phase: {TXN_DOCS} typed documents in 1,000-doc "
          f"proposals on 3 replicas and {len(deleted)} deleted: "
          f"{add_s:.2f} s; {len(queries)} BM25 queries and 2 range "
          f"selects {query_s * 1e3:.1f} ms a replica ({hits} hits); the "
          f"three nodes' restart with the index rebuilt {restart_s:.2f} s",
          flush=True)
    check(all(a == lead for a in before.values())
          and lead[-1] == TXN_DOCS - len(deleted) and hits > 0
          and not any(d_ in deleted for r in lead[:len(queries)]
                      for d_, _ in r),
          "doc phase: the replicas agree, count the live documents and "
          "return no deleted one")
    check(recovered == [1, 1, 1] and after == before,
          "doc phase: after the restart every replica rebuilt its index "
          "and answers the same ids and scores")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] txn/doc phase: {out['seconds']:.1f} s", flush=True)
    return out


#: the chaos phase: each scenario of dingo_tpu_torch/tools/chaos.py on an
#: IVF_FLAT region of the LSM phase's size (LSM_N x d, LSM_NLIST lists),
#: then the crash-recovery matrix at CHAOS_MATRIX_N x d (nlist
#: CHAOS_MATRIX_NLIST, every list probed)
CHAOS_MATRIX_N = 8_192
CHAOS_MATRIX_NLIST = 8
#: rows of the matrix's HNSW cases: 8,192 cut to 512. An HNSW write goes
#: to the host graph, one native insert a row on one thread (13 ms at d
#: 768), and the restart's device bulk build leaves that graph to a
#: back-fill at the first write after it, so an 8,192-row case inserted
#: every row twice: 196-197 s a case on the card, 20.8-20.9 s at 1,024
#: (PERF.md section 6)
CHAOS_MATRIX_HNSW_N = 512
#: the scenarios whose regions have three replicas
THREE_REPLICA = ("leader_failover", "partition_heal")


def chaos_phase(d, card, dev) -> dict:
    """The port's chaos harness on the card, last: run_scenarios() with
    each of the six scenarios (kill/restart, leader failover, partition
    and heal, an OOM storm on every dispatch, a flipped device byte, a
    kill inside a tier transition) on an IVF_FLAT region of LSM_N x d from
    bench.py's recipe, loaded in 4,096-row proposals and trained on every
    replica before the scenario's own 8-row acknowledged batches and its
    fault; durable stores checkpoint at the wal_checkpoint_bytes flag's
    default, and the three-replica scenarios run the region phase's
    election timeouts. Then the crash-recovery matrix (FLAT, IVF_FLAT and
    HNSW, each fp32 and sq8) at CHAOS_MATRIX_N x d, the HNSW cases at
    CHAOS_MATRIX_HNSW_N x d. Checks every gate of every scenario and case
    (the 15 s recovery bound and the 0.9 goodput floor among them), and
    that the warmed reads after the OOM storm's re-materialization launch
    B3 again (the device path came back). Prints, per scenario, the
    acknowledged and lost rows, recovery ms, goodput, every gate and the
    B3 and B4 launches. Runs after every other phase has stopped its
    nodes: Cluster.close() clears the process-global planes and the storm
    faults every dispatch in the process until its disarm."""
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.index.base import IndexType
    from dingo_tpu_torch.ops import kernel_ivf_pruned, kernel_topk_pruned
    from dingo_tpu_torch.tools import chaos

    arms = ("launches", "launches_bf16", "launches_sq8")

    def b3():
        return sum(getattr(kernel_ivf_pruned.ivf_pruned_topk, a_)
                   for a_ in arms)

    def b4():
        return sum(getattr(kernel_topk_pruned.pruned_fused_topk, a_)
                   for a_ in arms)

    t_phase = time.perf_counter()
    # the digest gates read the integrity ledger (off since the early
    # phases)
    FLAGS.set("integrity_enabled", True)
    kw = {"device": dev, "dim": d, "checkpoint_bytes": None}
    out: dict = {"scenarios": {}, "matrix": {}}
    # B3 launches (every arm: the OOM storm's re-materialization builds
    # at the device_recovery_remat_precision flag's sq8) of the warmed
    # reads that follow each recovery
    warmed: dict = {}
    real = chaos._steady_recompiles

    def spy(node, region, queries, reps=3):
        l3 = b3()
        try:
            return real(node, region, queries, reps)
        finally:
            warmed[current] = b3() - l3

    chaos._steady_recompiles = spy
    try:
        for current in chaos.SCENARIOS:
            l3, l4 = b3(), b4()
            t0 = time.perf_counter()
            # followers apply 4,096-row proposals on their raft threads:
            # the three-replica scenarios take the region phase's election
            # timeouts; one replica elects only itself, at the defaults
            raft = REGION_RAFT if current in THREE_REPLICA else None
            res = chaos.run_scenarios([current], seed=0, n=LSM_N,
                                      index_type=IndexType.IVF_FLAT,
                                      nlist=LSM_NLIST, raft_kw=raft, **kw)
            r = res["scenarios"][0]
            r["seconds"] = time.perf_counter() - t0
            r["b3_launches"], r["b4_launches"] = b3() - l3, b4() - l4
            out["scenarios"][current] = r
            print(f"[{card}] chaos phase: {current} on a {LSM_N} x {d} "
                  f"IVF_FLAT region (nlist {LSM_NLIST}): "
                  f"{'PASS' if r['passed'] else 'FAIL'} in "
                  f"{r['seconds']:.1f} s; acked {r.get('acked')}, lost "
                  f"{r.get('lost')}, recovery_ms {r.get('recovery_ms')} "
                  f"(bound {chaos.RECOVERY_BOUND_S * 1e3:.0f}), goodput "
                  f"{r.get('goodput', '-')}; B3 launches "
                  f"{r['b3_launches']} ({warmed.get(current, '-')} in the "
                  f"warmed reads after recovery), B4 launches "
                  f"{r['b4_launches']}; gates "
                  + " ".join(f"{g}={'ok' if v else 'VIOLATED'}"
                             for g, v in r["gates"].items())
                  + (f"; error {r['error']}" if "error" in r else ""),
                  flush=True)
            check(r["passed"], f"chaos phase: {current} passes every gate "
                  f"({r['gates']})")
    finally:
        chaos._steady_recompiles = real
    check(warmed.get("oom_storm", 0) > 0,
          "chaos phase: after oom_storm's re-materialization the warmed "
          f"reads launch B3 again ({warmed.get('oom_storm')})")
    t0 = time.perf_counter()
    hnsw = [c_ for c_ in chaos.MATRIX if c_[0] is IndexType.HNSW]
    mat = chaos.run_matrix(
        cases=[c_ for c_ in chaos.MATRIX if c_ not in hnsw],
        n=CHAOS_MATRIX_N, nlist=CHAOS_MATRIX_NLIST, **kw)
    mat_h = chaos.run_matrix(cases=hnsw, n=CHAOS_MATRIX_HNSW_N, **kw)
    for c in mat["cases"] + mat_h["cases"]:
        out["matrix"][c["name"]] = c
        rows = CHAOS_MATRIX_HNSW_N if c in mat_h["cases"] \
            else CHAOS_MATRIX_N
        print(f"[{card}] chaos phase: matrix {c['name']} at "
              f"{rows} x {d}: {'PASS' if c['passed'] else 'FAIL'}"
              f" in {c['seconds']:.1f} s;"
              f" acked {c.get('acked')}, lost {c.get('lost')}, recovery_ms "
              f"{c.get('recovery_ms')}, top-1 {c.get('top1')}; gates "
              + " ".join(f"{g}={'ok' if v else 'VIOLATED'}"
                         for g, v in c["gates"].items())
              + (f"; error {c['error']}" if "error" in c else ""),
              flush=True)
        check(c["passed"], f"chaos phase: matrix case {c['name']} passes "
              f"every gate ({c['gates']})")
    out["matrix_seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] chaos phase: matrix {out['matrix_seconds']:.1f} s; "
          f"phase {out['seconds']:.1f} s", flush=True)
    return out


def run(args) -> int:
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dingo_tpu_torch import native
    from dingo_tpu_torch.common.config import FLAGS
    from dingo_tpu_torch.common.metrics import METRICS
    from dingo_tpu_torch.index.base import (
        FilterSpec,
        IndexParameter,
        IndexType,
        NotSupported,
        NotTrained,
    )
    from dingo_tpu_torch.index.flat import TpuFlat, flat_search_plain
    from dingo_tpu_torch.index.ivf_flat import (
        coarse_probes,
        ivf_scan_scores,
    )
    from dingo_tpu_torch.index.ivf_layout import expand_probes, shape_bucket
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
    from dingo_tpu_torch.ops import (
        cuda_build,
        kernel_beam,
        kernel_ivf,
        kernel_ivf_pruned,
        kernel_pq,
        kernel_topk,
        kernel_topk_pruned,
    )
    from dingo_tpu_torch.ops.blocked import query_prefix_sqnorms
    from dingo_tpu_torch.ops.distance import Metric

    b1, b2 = kernel_topk.fused_topk, kernel_ivf.ivf_list_topk
    b3, b4 = kernel_ivf_pruned.ivf_pruned_topk, kernel_topk_pruned.\
        pruned_fused_topk

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    # the phases before the region phase (kernels, IVF_PQ, coalesced, the
    # tiers, d 960, binary, DiskANN) measure no plane: the integrity
    # ledger's host fold stays off there; the region phase's ingest and
    # the observability phase run under the JAX package's defaults
    FLAGS.set("integrity_enabled", False)
    print("integrity_enabled False for the kernel, IVF_PQ, coalesced, "
          "tier, d 960, binary and DiskANN phases (they measure no plane; "
          "the region phase turns it on)", flush=True)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # -- build: the kernel libraries (one nvcc a source, all started
    # together), every arm's entry point, the host libraries (g++) and the
    # SASS reads run on a thread of their own while the data is made ------
    built: dict = {}

    def build_all():
        try:
            t_b = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                host = [pool.submit(native.build, nm_)
                        for nm_ in native.SOURCES]
                cuda_build.build()
                for mod in (kernel_topk, kernel_ivf, kernel_ivf_pruned,
                            kernel_topk_pruned):
                    for dtype in mod.ARMS:  # every arm's entry point resolves
                        mod._launcher(dtype)
                kernel_pq._launcher()
                kernel_pq._lut_launcher()
                kernel_beam._launcher()
                kernel_beam._block_launcher()
                built["seconds"] = time.perf_counter() - t_b
                reads = [("pruned_fused_topk", "pruned_scan_kernel"),
                         ("ivf_pruned_topk", "ivf_pruned_kernel"),
                         ("fused_topk", "fused_scan_kernel"),
                         ("ivf_topk", "ivf_scan_kernel")]
                sass_f = {lib: pool.submit(sass_mma, cuda_build, lib, kern)
                          for lib, kern in reads}
                built["sass"] = {lib: f_.result() for lib, f_ in
                                 sass_f.items()}
                for f_ in host:
                    f_.result()
            built["all_s"] = time.perf_counter() - t_b
        except BaseException as e:  # noqa: BLE001 — raised on the main thread
            built["error"] = e

    builder = threading.Thread(target=build_all, name="smoke-build")
    builder.start()
    n, d, nlist, batch, k = args.n, args.d, args.nlist, 64, 10
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    x, queries, extra = make_data(n, d, batch)
    gt = exact_topk(x, queries, k)
    print(f"data + numpy exact top-{k}: {time.perf_counter() - t0:.1f} s "
          "(the build beside it)", flush=True)
    builder.join()
    if "error" in built:
        raise built["error"]
    print(f"build: {built['seconds']:.1f} s; with the host libraries and "
          f"the SASS reads {built['all_s']:.1f} s, beside the data",
          flush=True)
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    sass, tf32 = built["sass"]["pruned_fused_topk"]
    print("SASS of B4's scan kernels: " + ("; ".join(
        f"{arm} {op} x{c}" for (arm, op), c in sorted(sass.items()))
        or "no MMA") + f"; TF32 anywhere: {tf32}", flush=True)
    sass3, tf32_3 = built["sass"]["ivf_pruned_topk"]
    mma3 = {key: c for key, c in sass3.items()
            if key[1].startswith(("HMMA", "HGMMA"))}
    print("SASS of B3's scan kernels (CUDA-core FMAs by design): matrix "
          "MMAs (HMMA, HGMMA) " + ("; ".join(
              f"{arm} {op} x{c}" for (arm, op), c in sorted(mma3.items()))
              or "none in any arm") + "; other opcodes naming MMA: "
          + ("; ".join(f"{arm} {op} x{c}"
                       for (arm, op), c in sorted(sass3.items())
                       if (arm, op) not in mma3) or "none")
          + f"; TF32 anywhere: {tf32_3}", flush=True)
    check(not tf32_3, "no TF32 operation in B3's library")
    for tag, lib_name in (("B1", "fused_topk"), ("B2", "ivf_topk")):
        sass_s, _ = built["sass"][lib_name]
        print(f"SASS of {tag}'s scan kernels (split-precision products): "
              + ("; ".join(f"{arm} {op} x{c}"
                           for (arm, op), c in sorted(sass_s.items()))
                 or "no MMA"), flush=True)
        check(any(arm == "f32" and op.startswith(("HMMA", "HGMMA"))
                  and "TF32" in op for arm, op in sass_s),
              f"{tag} f32's scan kernel issues TF32 tensor-core MMAs "
              "(3xTF32)")
        check(any(arm == "bf16" and op.startswith(("HMMA", "HGMMA"))
                  and "BF16" in op for arm, op in sass_s),
              f"{tag}-bf16's scan kernel issues bf16 tensor-core MMAs")
    for tier in TIERS:
        check(any(arm == tier and "HMMA" in op and "BF16" in op
                  for arm, op in sass),
              f"B4-{tier}'s scan kernels issue bf16 tensor-core MMAs")
    check(not any(arm == "f32" for arm, _ in sass),
          "B4 f32's scan kernels issue no MMA")
    check(not tf32, "no TF32 operation in B4's library")

    # -- ingest through the wrapper -------------------------------------------
    param = IndexParameter(index_type=IndexType.IVF_FLAT, dimension=d,
                           metric=Metric.L2, ncentroids=nlist,
                           default_nprobe=32)
    wrapper = VectorIndexWrapper(1, param, device=dev)
    wrapper.set_own(wrapper.build_own())
    index = wrapper.own_index
    index.store.reserve(n)
    t0 = time.perf_counter()
    log_id = 0
    for lo in range(0, n, 65536):
        log_id += 1
        hi = min(n, lo + 65536)
        wrapper.add(np.arange(lo, hi, dtype=np.int64), x[lo:hi], log_id)
    torch.cuda.synchronize()
    print(f"ingest {n} rows in {log_id} raft adds: "
          f"{time.perf_counter() - t0:.1f} s (blocked mirror "
          f"{index.store.vecs_blk is not None})", flush=True)
    check(index.get_count() == n, f"wrapper holds {n} rows")
    wrapper.add(np.asarray([n + 777], np.int64), x[:1], log_id)
    check(index.get_count() == n and (n + 777) not in index.store
          and wrapper.apply_log_id == log_id, "replayed log id ignored")

    def flat_store(index_id):
        f = TpuFlat(index_id, IndexParameter(
            index_type=IndexType.FLAT, dimension=d, metric=Metric.L2),
            device=dev)
        f.store.reserve(n)
        for lo in range(0, n, 65536):
            f.upsert(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                     x[lo:min(n, lo + 65536)])
        return f

    # -- untrained: the reader's brute-force arm, pruned by default (B4) -----
    flat = flat_store(2)
    check(flat.store.vecs_blk is not None,
          "FLAT store keeps the blocked mirror by default on the card")
    b4.launches = 0
    flat_search_plain.calls = 0
    try:
        wrapper.search(queries, k)
        raise SmokeFailure("untrained IVF search did not raise NotTrained")
    except (NotTrained, NotSupported):
        res = flat.search(queries, k)
    torch.cuda.synchronize()
    b4_launches = b4.launches
    b4_plain_calls = flat_search_plain.calls
    b4_serving_frac = METRICS.gauge("ivf.pruned_dim_fraction",
                                    region_id=2).get()
    print(f"untrained path (pruned): pruned_fused_topk launches "
          f"{b4_launches}, plain-arm searches {b4_plain_calls}, "
          f"ivf.pruned_dim_fraction {b4_serving_frac:.4f}", flush=True)
    check(b4_launches > 0, "untrained search ran kernel B4")
    check(same_modulo_ties(x, queries, [r.ids for r in res], gt),
          "B4 brute-force ids == numpy exact top-10 modulo ties")

    # -- the unpruned FLAT arm (B1): a store built without the mirror -------
    saved = set_flags(FLAGS, vector_blocked_layout=False)
    try:
        flat1 = flat_store(3)
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    check(flat1.store.vecs_blk is None, "FLAT store without the mirror")
    b1.launches = 0
    flat_search_plain.calls = 0
    res = flat1.search(queries, k)
    torch.cuda.synchronize()
    b1_launches = b1.launches
    b1_plain_calls = flat_search_plain.calls
    print(f"unpruned FLAT path: fused_topk launches {b1_launches}, "
          f"plain-arm searches {b1_plain_calls}", flush=True)
    check(b1_launches > 0, "unpruned FLAT search ran kernel B1")
    check(same_modulo_ties(x, queries, [r.ids for r in res], gt),
          "B1 brute-force ids == numpy exact top-10 modulo ties")

    # -- train + IVF search, pruned by default (B3) ---------------------------
    t0 = time.perf_counter()
    index.train()
    torch.cuda.synchronize()
    print(f"train (nlist {nlist}): {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    index.search(queries[:1], k, nprobe=16)   # builds the bucket view
    torch.cuda.synchronize()
    print(f"view build: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(index.view_stats())}", flush=True)
    check(index._bucket_bsq is not None,
          "IVF view carries per-block norms (pruned route)")
    nprobes = (16, 32, 64)

    def ivf_searches(tag):
        out, rec = {}, {}
        for nprobe in nprobes:
            out[nprobe] = wrapper.search(queries, k, nprobe=nprobe)
            rec[nprobe] = recall_at(out[nprobe], gt, k)
            print(f"{tag} recall@{k} nprobe={nprobe}: {rec[nprobe]:.4f}",
                  flush=True)
        torch.cuda.synchronize()
        return out, rec

    b3.launches = 0
    ivf_scan_scores.calls = 0
    res_b3, recall = ivf_searches("pruned")
    b3_launches = b3.launches
    b3_plain_calls = ivf_scan_scores.calls
    b3_serving_frac = METRICS.gauge("ivf.pruned_dim_fraction",
                                    region_id=1).get()
    print(f"trained path (pruned): ivf_pruned_topk launches {b3_launches}, "
          f"plain-arm searches {b3_plain_calls}, ivf.pruned_dim_fraction "
          f"{b3_serving_frac:.4f}", flush=True)
    check(b3_launches > 0, "trained search ran kernel B3")
    check(recall[64] >= 0.95, "recall@10 >= 0.95 at nprobe=64 (B3)")
    # a filtered search on each route (C3): half the ids
    fspec = FilterSpec(ranges=[(0, n // 2)])
    res_b3_f = wrapper.search(queries, k, fspec, nprobe=32)

    # -- the unpruned IVF route (B2): ivf_prune_scan off, view rebuilt ------
    saved = set_flags(FLAGS, ivf_prune_scan=False)
    try:
        index.compact()                  # the flip lands at a rebuild
        check(index._bucket_bsq is None, "unpruned view has no block norms")
        b2.launches = 0
        ivf_scan_scores.calls = 0
        res_b2, recall_b2 = ivf_searches("unpruned")
        res_b2_f = wrapper.search(queries, k, fspec, nprobe=32)
        b2_launches = b2.launches
        b2_plain_calls = ivf_scan_scores.calls
    finally:
        for f_, v_ in saved.items():
            FLAGS.set(f_, v_)
    print(f"trained path (unpruned): ivf_list_topk launches {b2_launches}, "
          f"plain-arm searches {b2_plain_calls}", flush=True)
    check(b2_launches > 0, "trained search ran kernel B2")
    check(recall_b2[64] >= 0.95, "recall@10 >= 0.95 at nprobe=64 (B2)")
    for nprobe in nprobes:
        check(same_modulo_ties(x, queries,
                               [r.ids for r in res_b3[nprobe]],
                               [r.ids for r in res_b2[nprobe]]),
              f"B3 ids == B2 ids modulo ties at nprobe={nprobe}")
    check(all((r.ids < n // 2).all() for r in res_b3_f)
          and same_modulo_ties(x, queries, [r.ids for r in res_b3_f],
                               [r.ids for r in res_b2_f]),
          "filtered IVF_FLAT search: B3 ids == B2 ids modulo ties, all "
          "inside the filter")
    metric_regions(x, queries, nlist)

    # -- pipelined serving cost: both routes alternated within this call -----
    pipe = {True: [], False: []}
    for r in range(ROUNDS):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            saved = set_flags(FLAGS, ivf_prune_scan=on)
            try:
                index.compact()
                if (index._bucket_bsq is not None) != on:
                    raise SmokeFailure(f"rebuild with ivf_prune_scan={on} "
                                       "took the other route")
                kern = b3 if on else b2
                before = kern.launches
                pipe[on].append(pipelined_ms(wrapper, queries, k, 32))
                if kern.launches == before:
                    raise SmokeFailure("pipelined search missed its kernel")
            finally:
                for f_, v_ in saved.items():
                    FLAGS.set(f_, v_)
    for on, tag in ((True, "pruned, B3"), (False, "unpruned, B2")):
        med = median_spread(pipe[on])[0]
        print(f"[{card}] pipelined IVF search ({tag}) b={batch} k={k} "
              f"nprobe=32 via search_async x20: {spread_text(pipe[on])} per "
              f"batch ({batch / med * 1e3:.0f} QPS at the median); readings "
              f"{[round(v, 4) for v in pipe[on]]}", flush=True)
    print(f"[{card}] pipelined pruned / unpruned, median of the per-round "
          f"ratios: {np.median(np.divide(pipe[True], pipe[False])):.4f}",
          flush=True)
    index.compact()                      # back to the pruned view
    check(index._bucket_bsq is not None, "pruned view rebuilt")
    # C1: a search's dispatch makes no synchronizing CUDA call (the
    # uploads are pinned and non-blocking); resolve waits once
    index.search(queries, k, nprobe=32)
    torch.cuda.synchronize()
    thunks, c1_err = [], ""
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f_ in (None, FilterSpec(ranges=[(0, n // 3)])):
            thunks.append(wrapper.search_async(queries, k, f_, nprobe=32))
    except RuntimeError as e:
        c1_err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for th in thunks:
        th()
    check(not c1_err and len(thunks) == 2,
          "search_async dispatch (B3 route; unfiltered, a new filter) makes "
          f"no synchronizing call {c1_err}")
    print(f"[{card}] profile, pipelined IVF search (pruned, B3) x20: "
          + device_profile(pipelined_window(wrapper, queries, k, 32),
                           was="30.1%"), flush=True)

    # -- each kernel against its plain version, at the path's shapes ---------
    qpad = torch.from_numpy(queries).to(dev)
    fstore = flat1.store
    fmask = fstore.device_mask()
    kv, ki = b1(qpad, fstore.vecs, fstore.sqnorm, fmask, k)
    pv, pi = kernel_topk.fused_topk_plain(qpad, fstore.vecs, fstore.sqnorm,
                                          fmask, k)
    b1_ok, b1_err = kernel_parity(kv, ki, pv, pi)
    check(b1_ok, f"B1 kernel == plain (max abs err {b1_err:.3g})")

    nprobe_t = shape_bucket(32)
    k_eff = shape_bucket(k)
    probes = coarse_probes(qpad, index.centroids, index._c_sqnorm, nprobe_t)
    view = index._view
    vprobes = expand_probes(probes, view.probe_table, nprobe_t,
                            view.max_spill)
    b2_args = (vprobes, qpad, index._buckets, index._bucket_sqnorm,
               view.bucket_valid, view.bucket_slot, k_eff)
    kv, ki = b2(*b2_args)
    pv, pi = kernel_ivf.ivf_list_topk_plain(*b2_args)
    b2_ok, b2_err = kernel_parity(kv, ki, pv, pi)
    check(b2_ok, f"B2 kernel == plain (max abs err {b2_err:.3g})")

    dblk = d // index._bucket_bsq.shape[1]
    qpsq = query_prefix_sqnorms(qpad, dblk)
    pstore = flat.store

    def b3_args(ascending, inbucket):
        return (vprobes, qpad, qpsq, index._buckets, index._bucket_bsq,
                index._bucket_sqnorm, view.bucket_valid, view.bucket_slot,
                k_eff, ascending, 1, inbucket)

    def b4_args(ascending, inbucket):
        # the store's arrays as they are at the call: the writes below may
        # grow it (at --n 131072 they do)
        return (qpad, pstore.vecs_blk, pstore.bsq_blk, pstore.sqnorm,
                pstore.device_mask(), k, ascending, 1, inbucket)

    pruned = {}
    for name, kern, plain, mk in (
            ("B3", b3, kernel_ivf_pruned.ivf_pruned_topk_plain, b3_args),
            ("B4", b4, kernel_topk_pruned.pruned_fused_topk_plain, b4_args)):
        ok_all, err_all = True, 0.0
        for metric_name, ascending in (("L2", True), ("IP", False)):
            for inbucket in (True, False):
                a_ = mk(ascending, inbucket)
                b4.count_tiles = b3.count_staged = True
                kv, ki, ks = kern(*a_)
                b4.count_tiles = b3.count_staged = False
                if name == "B3" and ascending and inbucket:
                    b3_staged = int(b3.staged)
                tiles = b4_tiles_text(b4, ks) if name == "B4" else ""
                pv, pi, ps = plain(*a_)
                ok, err = kernel_parity(kv, ki, pv, pi)
                ok = ok and stats_ok(ks, ps)
                kf, pf = pruned_fraction(ks), pruned_fraction(ps)
                print(f"{name} {metric_name} inbucket={int(inbucket)}: "
                      f"pruned fraction kernel {kf:.4f}, plain {pf:.4f} "
                      f"(scanned {1 - kf:.4f} / {1 - pf:.4f}){tiles}; "
                      f"max abs err {err:.3g}", flush=True)
                check(ok, f"{name} {metric_name} inbucket={int(inbucket)} "
                          "kernel == plain (ids, scores, stats lanes)")
                ok_all, err_all = ok_all and ok, max(err_all, err)
                if ascending and inbucket:
                    pruned[name] = (kf, pf, ks)
                elif inbucket:
                    pruned[f"{name} IP"] = (kf, pf)
        pruned[name] += (ok_all, err_all)
    b3_staged_report("B3", b3_staged, pruned["B3"][2], vprobes,
                     view.cap_list, d // dblk,
                     (1.0 - pruned["B3"][0], 1.0 - pruned["B3"][1]))
    # B3 (f32) on a filter and on fewer valid rows than k, as its tier arms
    crng = np.random.default_rng(11)
    bfilt = view.bucket_valid & torch.from_numpy(
        crng.random(tuple(view.bucket_valid.shape)) < 0.5).to(dev)
    bfew = torch.zeros_like(view.bucket_valid)
    live = torch.nonzero(view.bucket_valid)[:5]
    bfew[live[:, 0], live[:, 1]] = True
    for tag, valid_ in (("filter", bfilt), ("fewer valid rows than k", bfew)):
        a_ = b3_args(True, True)
        a_ = a_[:6] + (valid_,) + a_[7:]
        kv, ki, ks = b3(*a_)
        pv, pi, ps = kernel_ivf_pruned.ivf_pruned_topk_plain(*a_)
        ok, err = kernel_parity(kv, ki, pv, pi)
        ok = ok and stats_ok(ks, ps)
        check(ok, f"B3 kernel == plain, {tag} (max abs err {err:.3g})")
        pruned["B3"] = pruned["B3"][:3] + (pruned["B3"][3] and ok,
                                           max(pruned["B3"][4], err))

    # -- incremental upsert + delete on the pruned routes ---------------------
    new_ids = np.arange(n, n + len(extra), dtype=np.int64)
    rebuilds = index.full_rebuilds
    view = index._view
    log_id += 1
    wrapper.add(new_ids, extra, log_id)
    check(index._view is view and not index._view_dirty
          and index.full_rebuilds == rebuilds,
          f"upsert of {len(extra)} rows applied in place (no view rebuild)")
    b3_before = b3.launches
    res = wrapper.search(extra[:batch], k, nprobe=32)
    check(b3.launches > b3_before and all(
        len(r.ids) and r.ids[0] == i for r, i in zip(res, new_ids[:batch])),
          "upserted rows come back as their own nearest neighbour (B3)")
    log_id += 1
    wrapper.delete(new_ids, log_id)
    res = wrapper.search(extra[:batch], k, nprobe=32)
    check(index.get_count() == n and not any(
        (r.ids >= n).any() for r in res), "deleted rows are gone (B3)")
    flat.upsert(new_ids, extra)
    b4_before = b4.launches
    res = flat.search(extra[:batch], k)
    check(b4.launches > b4_before and all(
        len(r.ids) and r.ids[0] == i for r, i in zip(res, new_ids[:batch])),
          "upserted rows come back as their own nearest neighbour (B4)")
    flat.delete(new_ids)
    res = flat.search(extra[:batch], k)
    check(flat.get_count() == n and not any(
        (r.ids >= n).any() for r in res), "deleted rows are gone (B4)")

    # -- pipelined FLAT serving: the default route (B4 over the mirror)
    # against a store built without the mirror (B1), taking turns ---------
    fpipe = {"B4": [], "B1": []}
    for r in range(ROUNDS):
        for nm in (("B4", "B1") if r % 2 == 0 else ("B1", "B4")):
            idx_, kern = (flat, b4) if nm == "B4" else (flat1, b1)
            before = kern.launches
            fpipe[nm].append(pipelined_ms(idx_, queries, k, None))
            if kern.launches == before:
                raise SmokeFailure(f"pipelined FLAT search missed {nm}")
    for nm, tag in (("B4", "default route, B4"), ("B1", "no mirror, B1")):
        med = median_spread(fpipe[nm])[0]
        print(f"[{card}] pipelined FLAT search ({tag}) b={batch} k={k} via "
              f"search_async x20: {spread_text(fpipe[nm])} per batch "
              f"({batch / med * 1e3:.0f} QPS at the median); readings "
              f"{[round(v, 4) for v in fpipe[nm]]}", flush=True)
    print(f"[{card}] pipelined FLAT " + b4_ratio_text(fpipe, "B4", "B1"),
          flush=True)
    for nm, idx_ in (("B4", flat), ("B1", flat1)):
        print(f"[{card}] profile, pipelined FLAT search ({nm}) x20: "
              + device_profile(pipelined_window(idx_, queries, k, None)),
              flush=True)

    # -- IVF_PQ at BASELINE config 3's widths: the B5 route ------------------
    pq = ivf_pq_phase(x, queries, extra, gt, nlist, PQ_M, card)
    # B5 on the same probes at B2's k, and with codes whose lookups hit 32
    # distinct banks per warp: what the k 60 inserts and the random-code
    # bank conflicts cost
    nbk, capk, mk = pq["args"][3].shape
    rows_ = torch.arange(capk, device=dev)[:, None] * 7
    cols_ = torch.arange(mk, device=dev)[None, :] * 13
    bank_free = ((rows_ + cols_) % 256).to(torch.uint8).expand(
        nbk, capk, mk).contiguous()
    b5_k12 = pq["args"][:6] + (shape_bucket(k),)
    b5_bank_free = pq["args"][:3] + (bank_free,) + pq["args"][4:]

    def b3_unseeded(*a_):
        """B3 without its rank-0 seed launch (what the seed buys)."""
        b3.seed = False
        try:
            return b3(*a_)
        finally:
            b3.seed = True

    # -- timings: the five kernels alternated in each round -------------------
    timed = {
        "B1": lambda: b1(qpad, fstore.vecs, fstore.sqnorm, fmask, k),
        "B4": lambda: b4(*b4_args(True, True)),
        "B1 IP": lambda: b1(qpad, fstore.vecs, fstore.sqnorm, fmask, k,
                            False),
        "B4 IP": lambda: b4(*b4_args(False, True)),
        "B2": lambda: b2(*b2_args),
        "B3": lambda: b3(*b3_args(True, True)),
        "B3 no seed": lambda: b3_unseeded(*b3_args(True, True)),
        "B5": lambda: kernel_pq.ivf_pq_adc_topk(*pq["args"]),
        "B5 k=12": lambda: kernel_pq.ivf_pq_adc_topk(*b5_k12),
        "B5 bank-free codes": lambda: kernel_pq.ivf_pq_adc_topk(
            *b5_bank_free),
    }
    reads = {name: [] for name in timed}
    order = list(timed)
    for r in range(ROUNDS):
        for name in order[r % len(order):] + order[:r % len(order)]:
            reads[name].append(time_ms(timed[name], torch))
    b1_ms, b2_ms, b3_ms, b4_ms = (median_spread(reads[nm])[0]
                                  for nm in ("B1", "B2", "B3", "B4"))
    b1_plain_ms = time_ms(lambda: kernel_topk.fused_topk_plain(
        qpad, fstore.vecs, fstore.sqnorm, fmask, k), torch, iters=5)
    nrow = fstore.capacity
    b1_bytes = batch * d * 4 + nrow * (d * 4 + 4 + 1) + batch * k * 8
    b1_ops = 2.0 * batch * nrow * d
    # the kernel's products: three TF32 passes on the tensor cores; the
    # bound of the same products as CUDA-core f32 FMAs printed beside it
    b1_bound, b1_by = bound_of(b1_bytes, SPLIT_PASSES * b1_ops,
                               PEAK_TF32_FLOPS)
    b1_fma_bound = bound_of(b1_bytes, b1_ops)[0]

    b2_plain_ms = time_ms(lambda: kernel_ivf.ivf_list_topk_plain(*b2_args),
                          torch, iters=5)
    vp = vprobes.cpu().numpy()
    cap = view.cap_list
    nbuck = len(np.unique(vp[vp >= 0]))
    npairs = int((vp >= 0).sum())
    b2_bytes = (nbuck * cap * (d * 4 + 4 + 1 + 4) + batch * d * 4
                + vp.size * 4 + batch * k_eff * 8)
    b2_ops = 2.0 * npairs * cap * d
    b2_bound, b2_by = bound_of(b2_bytes, SPLIT_PASSES * b2_ops,
                               PEAK_TF32_FLOPS)

    # pruned bounds: the unpruned work times a scanned fraction (lane0 /
    # lane1 of the L2 runs above), plus the metadata no pruning skips. The
    # function needs no more than the smaller of the kernel's and the
    # plain version's fractions (both measured on these inputs), so
    # bound_ms uses that one; the bound at the kernel's own fraction is
    # printed beside it.
    nblk = d // dblk

    def b3_bound_at(frac):
        nbytes = (nbuck * cap * d * 4 * frac
                  + nbuck * cap * (4 + 1 + 4 + nblk * 4)
                  + batch * (d + nblk) * 4 + vp.size * 4
                  + batch * k_eff * 8)
        return bound_of(nbytes, 2.0 * npairs * cap * d * frac)

    prow = pstore.capacity

    def b4_bound_at(frac):
        nbytes = (prow * d * 4 * frac + prow * (nblk * 4 + 4 + 1)
                  + batch * (d + nblk) * 4 + batch * k * 8)
        return bound_of(nbytes, 2.0 * batch * prow * d * frac)

    b3_kfrac, b3_pfrac = 1.0 - pruned["B3"][0], 1.0 - pruned["B3"][1]
    b3_frac = min(b3_kfrac, b3_pfrac)
    b3_plain_ms = time_ms(lambda: kernel_ivf_pruned.ivf_pruned_topk_plain(
        *b3_args(True, True)), torch, iters=3, warmup=1)
    b3_bound, b3_by = b3_bound_at(b3_frac)
    b3_kbound = b3_bound_at(b3_kfrac)[0]

    b4_kfrac, b4_pfrac = 1.0 - pruned["B4"][0], 1.0 - pruned["B4"][1]
    b4_frac = min(b4_kfrac, b4_pfrac)
    # B4's plain version takes ~2 s a call (its row blocks in order, on
    # the host): one timed call, warmed by the parity runs above
    b4_plain_ms = time_ms(lambda: kernel_topk_pruned.pruned_fused_topk_plain(
        *b4_args(True, True)), torch, iters=1, warmup=0)
    b4_bound, b4_by = b4_bound_at(b4_frac)
    b4_kbound = b4_bound_at(b4_kfrac)[0]

    print(f"[{card}] B1 fused_topk b={batch} n={nrow} d={d} k={k}: "
          f"{spread_text(reads['B1'])}, plain {b1_plain_ms:.4f} ms, bound "
          f"{b1_bound:.4f} ms ({b1_by}; the products alone "
          f"{SPLIT_PASSES * b1_ops / PEAK_TF32_FLOPS * 1e3:.4f} ms as three "
          f"TF32 passes, {b1_fma_bound:.4f} ms as f32 FMAs)", flush=True)
    # B2 reads a bucket once per item (a bucket and up to 8 of its
    # queries): the items' bytes, beside the distinct buckets' of the bound
    n_items = kernel_ivf_pruned.probe_items(vprobes,
                                            index._buckets.shape[0])[2]
    item_bytes = n_items * cap * d * 4
    print(f"[{card}] B2 ivf_list_topk b={batch} budget={vp.shape[1]} "
          f"cap={cap} d={d} k={k_eff} distinct buckets={nbuck}, pairs "
          f"{npairs}, items {n_items}: {spread_text(reads['B2'])}, plain "
          f"{b2_plain_ms:.4f} ms, bound {b2_bound:.4f} ms ({b2_by}: the "
          f"distinct buckets' {b2_bytes / 1e9:.3f} GB); the items' rows "
          f"{item_bytes / 1e9:.3f} GB, streamed at "
          f"{item_bytes / median_spread(reads['B2'])[0] / 1e9:.3f} TB/s",
          flush=True)
    print(f"[{card}] B3 ivf_pruned_topk L2 (same shapes, dblk={dblk}, "
          f"scanned fraction kernel {b3_kfrac:.4f}, plain {b3_pfrac:.4f}): "
          f"{spread_text(reads['B3'])}, plain {b3_plain_ms:.4f} ms, bound "
          f"{b3_bound:.4f} ms ({b3_by}; {b3_kbound:.4f} ms at the kernel's "
          f"own fraction)", flush=True)
    print(f"[{card}] B4 pruned_fused_topk L2 b={batch} n={prow} d={d} "
          f"dblk={dblk} k={k} (scanned fraction kernel {b4_kfrac:.4f}, "
          f"plain {b4_pfrac:.4f}): {spread_text(reads['B4'])}, plain "
          f"{b4_plain_ms:.4f} ms, bound {b4_bound:.4f} ms ({b4_by}; "
          f"{b4_kbound:.4f} ms at the kernel's own fraction)", flush=True)
    b5_plain_ms = time_ms(lambda: kernel_pq.ivf_pq_adc_topk_plain(
        *pq["args"]), torch, iters=3, warmup=1)
    print(f"[{card}] B5 ivf_pq_adc_topk {pq['shape']}: "
          f"{spread_text(reads['B5'])}, plain {b5_plain_ms:.4f} ms, bound "
          f"{pq['bound']:.4f} ms ({pq['by']}); launches on the IVF_PQ path "
          f"{pq['launches']}", flush=True)
    for tag in ("B5 k=12", "B5 bank-free codes"):
        ratios = np.divide(reads[tag], reads["B5"])
        print(f"[{card}] {tag} (same probes and tables): "
              f"{spread_text(reads[tag])}; per-round ratio to B5 at k "
              f"{pq['args'][6]} median {np.median(ratios):.4f}", flush=True)
    nsk = b3_unseeded(*b3_args(True, True))[2]
    print(f"[{card}] B3 without the rank-0 seed launch: "
          f"{spread_text(reads['B3 no seed'])}; per-round ratio to B3 with "
          "it median "
          f"{np.median(np.divide(reads['B3 no seed'], reads['B3'])):.4f}"
          f"; scanned fraction {1 - pruned_fraction(nsk):.4f} (with the "
          f"seed {b3_kfrac:.4f})", flush=True)
    for new, old in (("B4", "B1"), ("B3", "B2")):
        ratios = np.divide(reads[new], reads[old])
        print(f"[{card}] {new} / {old} (pruned / unpruned kernel), per-round "
              f"ratio median {np.median(ratios):.4f} (min {ratios.min():.4f}"
              f", max {ratios.max():.4f})", flush=True)
    print(f"[{card}] B4 f32 against B1 f32, L2 (B4 scanned fraction kernel "
          f"{b4_kfrac:.4f}, plain {b4_pfrac:.4f}): B4 "
          f"{spread_text(reads['B4'])}, B1 {spread_text(reads['B1'])}; "
          + b4_ratio_text(reads, "B4", "B1"), flush=True)
    print(f"[{card}] B4 f32 against B1 f32, IP (B4 scanned fraction kernel "
          f"{1 - pruned['B4 IP'][0]:.4f}, plain {1 - pruned['B4 IP'][1]:.4f}"
          f"): B4 {spread_text(reads['B4 IP'])}, B1 "
          f"{spread_text(reads['B1 IP'])}; "
          + b4_ratio_text(reads, "B4 IP", "B1 IP"), flush=True)

    # -- the coalesced serving path: the port's IndexService (coalescer,
    # staging ring, completion lane) over the fp32 regions, with the JAX
    # package's pipeline_sweep traffic --------------------------------------
    fwrap = VectorIndexWrapper(2, flat.parameter, device=dev)
    fwrap.set_own(flat)
    coalesced = coalesced_phase(x, extra, {
        "IVF_FLAT (B3)": (wrapper, b3, {"nprobe": 32}, (1, 2, 4), {}),
        "FLAT (B4)": (fwrap, b4, {}, (2,), {}),
        "IVF_PQ (B5)": (pq["wrapper"], kernel_pq.ivf_pq_adc_topk,
                        {"nprobe": 32}, (2,), {"ivfpq_rerank_factor": 6}),
    }, card)
    recovery_quiet("coalesced phase", card)

    # -- the precision tiers: release the fp32 FLAT stores and the IVF_PQ
    # state first (their peaks would add up); the fp32 IVF_FLAT region
    # stays, for the tiers' device-bytes and pipelined comparisons --------
    flat = flat1 = fstore = pstore = fmask = pmask = timed = fwrap = None
    pq["args"] = pq["wrapper"] = b5_k12 = b5_bank_free = bank_free = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    peak_fp32 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    index.compact()               # the dense view, as the tiers' are built
    t0 = time.perf_counter()
    tier_entries = tier_phase(x, queries, extra, gt, nlist, card, {
        "wrapper": wrapper, "recall": recall,
        "bytes": index.get_device_memory_size()})
    print(f"tier phase: {time.perf_counter() - t0:.1f} s", flush=True)
    tiers = {e["name"]: e for e in tier_entries}
    peak_tiers = torch.cuda.max_memory_allocated()

    # -- VectorIndex.range_search on the fp32 IVF_FLAT region ---------------
    fp32_range_phase(index, x, queries, card, dev)

    # -- GIST1M's width on the default route (B1, B2), the fp32 region and
    # the tiers' state released first -----------------------------------
    wrapper = index = view = vprobes = probes = qpad = None
    b2_args = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gist = gist_phase(min(args.n, GIST_N), nlist, card)
    print(f"d {GIST_D} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    peak_gist = torch.cuda.max_memory_allocated()

    # -- the binary family over the rows binarized, then the diskann role's
    # core over the rows themselves --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    binary = binary_phase(x, queries, extra, nlist, card, dev)
    recovery_quiet("binary phase", card)
    peak_binary = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    diskann = diskann_phase(x, queries, extra, gt, nlist, card, dev)
    peak_diskann = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    # -- the replicated region path: three StoreNodes over the same rows,
    # every earlier phase's device state released first: the last
    # references into the fp32 phases' indexes, B3's argument tuple (the
    # IVF view), the last pipelined FLAT index, resolved thunks (their
    # closures hold the IVF wrapper) and kernel outputs. The HNSW writes
    # phase's one-thread host graph inserts start here and run beside the
    # region and HNSW phases ----------------------------------------------
    a_ = idx_ = thunks = th = nsk = None
    kv = ki = pv = pi = ks = ps = qpsq = bfilt = bfew = valid_ = None
    rows_ = cols_ = live = None
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[{card}] device memory held at the region phase's start: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    started: dict = {}

    def start_writes():
        started["t"] = time.perf_counter()
        started["writes"] = hnsw_writes_start(HNSW_WRITE_N)

    region = region_phase(x, queries, extra, gt, nlist, card, dev,
                          before_cluster=start_writes)
    if "writes" not in started:       # a region phase cut short
        start_writes()
    t_writes, writes = started["t"], started["writes"]
    peak_region = max(region["cluster"].get("region_peak_gib", 0.0) * 2**30,
                      torch.cuda.max_memory_allocated())

    # -- the native LSM engine under a store node, on the first LSM_N rows
    recovery_quiet("region phase", card)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lsm, lsm_launches = phase_launches(
        lambda: lsm_phase(x[:min(n, LSM_N)], queries, card, dev))
    print(f"LSM phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{lsm_launches}", flush=True)
    check(lsm_launches["ivf_pruned_topk"] > 0
          and lsm_launches["pruned_fused_topk"] > 0,
          "LSM phase: its searches ran on B4 (untrained) and B3 (trained)")
    recovery_quiet("LSM phase", card)

    # -- HNSW (BASELINE.json config 4) on its own rows, then the HNSW writes
    # phase and the recovery ladder; every earlier phase's device state
    # released first ---------------------------------------------------------
    x = queries = extra = gt = None
    gc.collect()                  # the stopped replicas' reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    holders = device_holders(locals())
    in_tensors = sum({t_.untyped_storage().data_ptr():
                      t_.untyped_storage().nbytes()
                      for t_ in gc.get_objects()
                      if torch.is_tensor(t_) and t_.is_cuda}.values())
    print(f"[{card}] device memory held by earlier phases at the HNSW "
          f"phase's start: {held / 2**30:.2f} GiB, {in_tensors / 2**30:.2f} "
          "GiB of it in live tensors; reached from run()'s names (MiB): "
          + (", ".join(f"{nm_} {b_ / 2**20:.1f}" for nm_, b_ in sorted(
              holders.items(), key=lambda kv_: -kv_[1])) or "none"),
          flush=True)
    check(held < n * d * 4, "the earlier phases' device state is released "
          f"before the HNSW phase ({held / 2**30:.2f} GiB held, less than "
          f"one {n} x {d} f32 store)")
    t0 = time.perf_counter()
    hnsw = hnsw_phase(args.hnsw_n, card)
    print(f"HNSW phase: {time.perf_counter() - t0:.1f} s (the writes "
          "phase's host graph inserts ran beside it and the region phase "
          f"on another core, started {t0 - t_writes:.1f} s before it)",
          flush=True)
    recovery_quiet("HNSW phase", card)
    peak_hnsw = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hnsw_writes_phase(writes, card)
    writes = None
    print(f"HNSW writes phase: {time.perf_counter() - t0:.1f} s after the "
          "HNSW phase", flush=True)
    recovery_quiet("HNSW writes phase", card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    recovery = recovery_phase(card)
    # -- transactions and a DOCUMENT region: host paths --------------------
    t0 = time.perf_counter()
    txn_doc_phase(card, dev)
    print(f"txn/doc phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # -- the chaos harness, last: every node of the earlier phases stopped
    t0 = time.perf_counter()
    chaos_phase(d, card, dev)
    print(f"chaos phase: {time.perf_counter() - t0:.1f} s", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              by, ok, plain_calls, frac=None):
        e = {"name": name, "route": "cuda",
             "source": f"dingo_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "parity": ok, "plain_arm_searches": plain_calls}
        if frac is not None:
            e["pruned_fraction"], e["plain_pruned_fraction"] = frac
        return e

    kernels = [
        entry("fused_topk", "fused_topk.cu",
              "dingo_tpu/ops/pallas_topk.py:106", b1_launches, b1_err, b1_ms,
              b1_plain_ms, b1_bound, b1_by, b1_ok, b1_plain_calls),
        entry("ivf_list_topk", "ivf_topk.cu",
              "dingo_tpu/ops/pallas_ivf.py:100", b2_launches, b2_err, b2_ms,
              b2_plain_ms, b2_bound, b2_by, b2_ok, b2_plain_calls),
        entry("ivf_pruned_topk", "ivf_pruned_topk.cu",
              "dingo_tpu/ops/pallas_ivf.py:381", b3_launches,
              pruned["B3"][4], b3_ms, b3_plain_ms, b3_bound, b3_by,
              pruned["B3"][3], b3_plain_calls, pruned["B3"][:2]),
        entry("pruned_fused_topk", "pruned_fused_topk.cu",
              "dingo_tpu/ops/pallas_topk.py:318", b4_launches,
              pruned["B4"][4], b4_ms, b4_plain_ms, b4_bound, b4_by,
              pruned["B4"][3], b4_plain_calls, pruned["B4"][:2]),
        entry("ivf_pq_adc_topk", "ivf_pq_adc_topk.cu",
              "dingo_tpu/ops/pallas_pq.py:100", pq["launches"], pq["err"],
              median_spread(reads["B5"])[0], b5_plain_ms, pq["bound"],
              pq["by"], pq["ok"], pq["xla_calls"]),
    ]
    for e, nm in zip(kernels, ("B1", "B2", "B3", "B4", "B5")):
        _, e["ms_min"], e["ms_max"] = median_spread(reads[nm])
    # B1 and B2: their launches on the default route at d 960 beside the
    # flag route's at d 768 (`launches`), and their times at that width
    for e, nm in zip(kernels[:2], ("B1", "B2")):
        g_ = gist[nm]
        e["launches_default_route_d960"] = gist["launches"][nm]
        e["ms_d960"] = median_spread(g_["reads"])[0]
        e["plain_ms_d960"] = g_["plain_ms"]
        e["bound_ms_d960"], e["bound_by_d960"] = g_["bound"]
        e["parity"] = e["parity"] and g_["ok"]
        e["max_abs_err"] = max(e["max_abs_err"], g_["err"])
    lut = pq["lut"]
    # the table kernel: its plain version is the torch composite, which is
    # also the PyTorch yardstick (no single call computes the tables)
    e = entry("ivfpq_adc_lut", "ivfpq_adc_lut.cu",
              "dingo_tpu/index/ivf_pq.py:195 (XLA, no Pallas kernel)",
              lut["launches"], lut["err"], lut["ms"], lut["torch_ms"],
              lut["bound"], lut["by"], lut["ok"], pq["xla_calls"])
    e["library_ms"] = lut["torch_ms"]
    _, e["ms_min"], e["ms_max"] = median_spread(lut["reads"])
    kernels.append(e)
    # every arm, B1-B4 each followed by its tier arms
    kernels = (kernels[:1] + [tiers["fused_topk_bf16"]] + kernels[1:2]
               + [tiers["ivf_list_topk_bf16"]] + kernels[2:3]
               + [tiers["ivf_pruned_topk_bf16"], tiers["ivf_pruned_topk_sq8"]]
               + kernels[3:4] + [tiers["pruned_fused_topk_bf16"],
                                 tiers["pruned_fused_topk_sq8"]]
               + kernels[4:])
    # G, its two designs: the HNSW phase's main-path launches of each (its
    # build and the searches before any swapped design); each design on
    # the busiest launch of the sites it takes by shape, against the plain
    # version and that design's bound; every site's numbers beside them
    sites = hnsw["sites"]
    g_rep = "dingo_tpu/ops/beam.py:55 (XLA _candidate_scores, no Pallas " \
        "kernel)"
    for arm, src in (("pair", "beam_scores.cu"), ("block", "beam_block.cu")):
        name = "candidate_scores" + ("_block" if arm == "block" else "")
        mine = [v for v in sites.values() if v["auto"] == arm]
        if not mine:
            check(False, f"{name}: no busiest launch captured")
            continue
        site = max(mine, key=lambda v: v["live"])
        e = entry(name, src, g_rep, hnsw["launches"][arm],
                  site[f"{arm}_err"], site[f"{arm}_ms"], site["plain_ms"],
                  site[f"{arm}_bound"], site[f"{arm}_by"],
                  site[f"{arm}_ok"] and site[f"{arm}_repeat"], 0)
        _, e["ms_min"], e["ms_max"] = median_spread(site[f"{arm}_reads"])
        e["at_site"] = site["site"]
        e["launches_build"] = hnsw[f"build_{arm}"]
        e["by_site"] = {
            k: {"shape": [v["b"], v["c"]], "live": v["live"],
                "distinct_rows": v["rows"], "ms": v[f"{arm}_ms"],
                "bound_ms": v[f"{arm}_bound"], "bound_by": v[f"{arm}_by"],
                "bytes_ms": v["bytes_ms"], "f32_ops_ms": v["f32_ops_ms"],
                "tc_ops_ms": v["tc_ops_ms"], "plain_ms": v["plain_ms"],
                "takes_this_arm": v["auto"] == arm}
            for k, v in sites.items()}
        e["build"] = hnsw["g_build"]
        e["search"] = hnsw["g_search"].get(arm)
        kernels.append(e)
    e["launches_per_search"] = hnsw["launches_search"]
    e["live_share"] = hnsw["live_share"]
    for e_ in kernels:
        e_["launches_region_phase"] = region["launches"].get(e_["name"], 0)
        e_["launches_cluster_phase"] = region["cluster"]["launches"].get(
            e_["name"], 0)
        e_["launches_recovery_phase"] = recovery["launches"].get(
            e_["name"], 0)
        e_["launches_binary_phase"] = binary["launches"].get(e_["name"], 0)
        e_["launches_diskann_phase"] = diskann["launches"].get(
            e_["name"], 0)
        e_["launches_edge_cache_phase"] = region["edge_cache"][
            "launches"].get(e_["name"], 0)
        e_["launches_ladder_phase"] = region["ladder"]["launches"].get(
            e_["name"], 0)
        e_["launches_table_phase"] = region["table"]["launches"].get(
            e_["name"], 0)
        e_["launches_lsm_phase"] = lsm_launches.get(e_["name"], 0)
    check(region["launches"].get("ivf_pruned_topk_sq8", 0) > 0
          and region["launches"].get("pruned_fused_topk_sq8", 0) > 0,
          "the region phase launched B3-sq8 and B4-sq8 (the ladder's "
          "hbm_sq8 rung)")
    check(len(kernels) == 14 and all(e_["parity"] for e_ in kernels),
          "the kernels line lists 14 entries, each with parity")
    print(f"[{card}] serving-path ivf.pruned_dim_fraction: IVF (B3) "
          f"{b3_serving_frac:.4f}, FLAT (B4) {b4_serving_frac:.4f}",
          flush=True)
    print(f"[{card}] peak device memory: fp32 and IVF_PQ phases "
          f"{peak_fp32 / 2**30:.2f} GiB, tier phase "
          f"{peak_tiers / 2**30:.2f} GiB, d {GIST_D} phase "
          f"{peak_gist / 2**30:.2f} GiB, binary phase "
          f"{peak_binary / 2**30:.2f} GiB, DiskANN phase "
          f"{peak_diskann / 2**30:.2f} GiB, region phase "
          f"{peak_region / 2**30:.2f} GiB (its cluster phase "
          f"{region['cluster']['peak_gib']:.2f} GiB), HNSW phase "
          f"{peak_hnsw / 2**30:.2f} GiB ({held / 2**30:.2f} GiB of it "
          "held from before)", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILED:
        raise SmokeFailure(f"{len(FAILED)} checks failed: {FAILED}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--hnsw-n", type=int, default=HNSW_N)
    args = ap.parse_args()
    try:
        return run(args)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    except SmokeFailure as e:
        print(f"FAIL {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
