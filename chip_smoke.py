#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: 1M x 768, nlist 1024
    python3 chip_smoke.py --n 131072 --nlist 128   # a quicker, smaller run

Builds the port's CUDA kernels from ``dingo_tpu_torch/csrc`` (one nvcc per
source, in parallel), then serves an IVF_FLAT region the way the Index
role does: raft-ordered adds through VectorIndexWrapper, a brute-force
FLAT search while the region is untrained (kernel B1), training, IVF
searches at several nprobe (kernel B2), an in-place upsert and delete.
Every kernel is held against its plain PyTorch version on the card, and
the launches each serving path made are counted. Data is BASELINE.json
config 2 made with bench.py's recipe (seed 7, n // 1000 Gaussian centers
+ 0.35 noise, queries = stored rows + 0.05 noise).

The last line is ``{"ok": true, "device": {...}}``; any failed check exits
nonzero before it. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): f32 without tensor cores,
#: and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: kernel-vs-plain tolerance: f32 sums land in a different order
RTOL, ATOL = 1e-4, 1e-3
#: two id lists agree modulo ties when their exact (f64) distances, sorted,
#: agree within the f32 rounding of a distance computed as
#: ||q||^2 - 2 q.x + ||x||^2 at these magnitudes
TIE_RTOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"PASS {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(n: int, d: int, batch: int):
    rng = np.random.default_rng(7)
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


def exact_dists(x, q, ids) -> np.ndarray:
    rows = x[ids].astype(np.float64)
    return ((rows - q.astype(np.float64)[None, :]) ** 2).sum(1)


def same_modulo_ties(x, queries, got, want) -> bool:
    """Each query's id list is a valid exact top-k: sorted f64 distances
    of `got` and `want` agree within TIE_RTOL."""
    for qi in range(len(queries)):
        g = np.asarray(got[qi], np.int64)
        w = np.asarray(want[qi], np.int64)
        if len(g) != len(w):
            return False
        if set(g.tolist()) == set(w.tolist()):
            continue
        dg = np.sort(exact_dists(x, queries[qi], g))
        dw = np.sort(exact_dists(x, queries[qi], w))
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


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dingo_tpu_torch.index.base import (
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
    from dingo_tpu_torch.ops import cuda_build, kernel_ivf, kernel_topk
    from dingo_tpu_torch.ops.distance import Metric

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    kernel_topk._launcher()
    kernel_ivf._launcher()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    n, d, nlist, batch, k = args.n, args.d, args.nlist, 64, 10
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    x, queries, extra = make_data(n, d, batch)
    gt = exact_topk(x, queries, k)
    print(f"data + numpy exact top-{k}: {time.perf_counter() - t0:.1f} s",
          flush=True)

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
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(index.get_count() == n, f"wrapper holds {n} rows")
    wrapper.add(np.asarray([n + 777], np.int64), x[:1], log_id)
    check(index.get_count() == n and (n + 777) not in index.store
          and wrapper.apply_log_id == log_id, "replayed log id ignored")

    # -- untrained: the reader's brute-force arm (B1) --------------------------
    flat = TpuFlat(1, IndexParameter(index_type=IndexType.FLAT, dimension=d,
                                     metric=Metric.L2), device=dev)
    flat.store.reserve(n)
    for lo in range(0, n, 65536):
        flat.upsert(np.arange(lo, min(n, lo + 65536), dtype=np.int64),
                    x[lo:min(n, lo + 65536)])
    kernel_topk.fused_topk.launches = 0
    flat_search_plain.calls = 0
    try:
        wrapper.search(queries, k)
        raise SmokeFailure("untrained IVF search did not raise NotTrained")
    except (NotTrained, NotSupported):
        res = flat.search(queries, k)
    torch.cuda.synchronize()
    b1_launches = kernel_topk.fused_topk.launches
    b1_plain_calls = flat_search_plain.calls
    print(f"untrained path: fused_topk launches {b1_launches}, plain-arm "
          f"searches {b1_plain_calls}", flush=True)
    check(b1_launches > 0, "untrained search ran kernel B1")
    check(same_modulo_ties(x, queries, [r.ids for r in res], gt),
          "brute-force ids == numpy exact top-10 modulo ties")

    # -- train + IVF search (B2) -----------------------------------------------
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
    kernel_ivf.ivf_list_topk.launches = 0
    ivf_scan_scores.calls = 0
    recall = {}
    for nprobe in (16, 32, 64):
        res = wrapper.search(queries, k, nprobe=nprobe)
        hits = sum(len(set(r.ids.tolist()) & set(g.tolist()))
                   for r, g in zip(res, gt))
        recall[nprobe] = hits / (len(gt) * k)
        print(f"recall@{k} nprobe={nprobe}: {recall[nprobe]:.4f}", flush=True)
    torch.cuda.synchronize()
    b2_launches = kernel_ivf.ivf_list_topk.launches
    b2_plain_calls = ivf_scan_scores.calls
    print(f"trained path: ivf_list_topk launches {b2_launches}, plain-arm "
          f"searches {b2_plain_calls}", flush=True)
    check(b2_launches > 0, "trained search ran kernel B2")
    check(recall[64] >= 0.95, "recall@10 >= 0.95 at nprobe=64")

    # -- each kernel against its plain version, at the path's shapes ---------
    qpad = torch.from_numpy(queries).to(dev)
    fstore = flat.store
    fmask = fstore.device_mask()
    kv, ki = kernel_topk.fused_topk(qpad, fstore.vecs, fstore.sqnorm, fmask,
                                    k)
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
    kv, ki = kernel_ivf.ivf_list_topk(*b2_args)
    pv, pi = kernel_ivf.ivf_list_topk_plain(*b2_args)
    b2_ok, b2_err = kernel_parity(kv, ki, pv, pi)
    check(b2_ok, f"B2 kernel == plain (max abs err {b2_err:.3g})")

    # -- incremental upsert + delete through the wrapper ----------------------
    new_ids = np.arange(n, n + len(extra), dtype=np.int64)
    rebuilds = index.full_rebuilds
    log_id += 1
    wrapper.add(new_ids, extra, log_id)
    check(index._view is view and not index._view_dirty
          and index.full_rebuilds == rebuilds,
          f"upsert of {len(extra)} rows applied in place (no view rebuild)")
    res = wrapper.search(extra[:batch], k, nprobe=32)
    check(all(len(r.ids) and r.ids[0] == i
              for r, i in zip(res, new_ids[:batch])),
          "upserted rows come back as their own nearest neighbour")
    log_id += 1
    wrapper.delete(new_ids, log_id)
    res = wrapper.search(extra[:batch], k, nprobe=32)
    check(index.get_count() == n and not any(
        (r.ids >= n).any() for r in res), "deleted rows are gone")

    # -- timings ---------------------------------------------------------------
    b1_ms = time_ms(lambda: kernel_topk.fused_topk(
        qpad, fstore.vecs, fstore.sqnorm, fmask, k), torch)
    b1_plain_ms = time_ms(lambda: kernel_topk.fused_topk_plain(
        qpad, fstore.vecs, fstore.sqnorm, fmask, k), torch, iters=5)
    nrow = fstore.capacity
    b1_bytes = batch * d * 4 + nrow * (d * 4 + 4 + 1) + batch * k * 8
    b1_ops = 2.0 * batch * nrow * d
    b1_bound = max(b1_bytes / PEAK_BYTES, b1_ops / PEAK_F32_FLOPS) * 1e3
    b1_by = "operations" if b1_ops / PEAK_F32_FLOPS > b1_bytes / PEAK_BYTES \
        else "bytes"

    b2_ms = time_ms(lambda: kernel_ivf.ivf_list_topk(*b2_args), torch)
    b2_plain_ms = time_ms(lambda: kernel_ivf.ivf_list_topk_plain(*b2_args),
                          torch, iters=5)
    vp = vprobes.cpu().numpy()
    cap = view.cap_list
    nbuck = len(np.unique(vp[vp >= 0]))
    npairs = int((vp >= 0).sum())
    b2_bytes = (nbuck * cap * (d * 4 + 4 + 1 + 4) + batch * d * 4
                + vp.size * 4 + batch * k_eff * 8)
    b2_ops = 2.0 * npairs * cap * d
    b2_bound = max(b2_bytes / PEAK_BYTES, b2_ops / PEAK_F32_FLOPS) * 1e3
    b2_by = "operations" if b2_ops / PEAK_F32_FLOPS > b2_bytes / PEAK_BYTES \
        else "bytes"
    print(f"[{card}] B1 fused_topk b={batch} n={nrow} d={d} k={k}: "
          f"{b1_ms:.4f} ms, plain {b1_plain_ms:.4f} ms, bound "
          f"{b1_bound:.4f} ms ({b1_by})", flush=True)
    print(f"[{card}] B2 ivf_list_topk b={batch} budget={vp.shape[1]} "
          f"cap={cap} d={d} k={k_eff} distinct buckets={nbuck}: "
          f"{b2_ms:.4f} ms, plain {b2_plain_ms:.4f} ms, bound "
          f"{b2_bound:.4f} ms ({b2_by})", flush=True)

    reps = 20
    for _ in range(3):
        wrapper.search_async(queries, k, nprobe=32)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thunks = [wrapper.search_async(queries, k, nprobe=32)
              for _ in range(reps)]
    for th in thunks:
        th()
    pipe_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"[{card}] pipelined IVF search b={batch} k={k} nprobe=32 via "
          f"search_async x{reps}: {pipe_ms:.4f} ms/batch "
          f"({batch / pipe_ms * 1e3:.0f} QPS)", flush=True)

    kernels = [
        {"name": "fused_topk", "route": "cuda",
         "source": "dingo_tpu_torch/csrc/fused_topk.cu",
         "replaces": "dingo_tpu/ops/pallas_topk.py:106",
         "launches": b1_launches, "max_abs_err": b1_err, "ms": b1_ms,
         "plain_ms": b1_plain_ms, "bound_ms": b1_bound, "bound_by": b1_by,
         "library_ms": None, "parity": b1_ok,
         "plain_arm_searches": b1_plain_calls},
        {"name": "ivf_list_topk", "route": "cuda",
         "source": "dingo_tpu_torch/csrc/ivf_topk.cu",
         "replaces": "dingo_tpu/ops/pallas_ivf.py:100",
         "launches": b2_launches, "max_abs_err": b2_err, "ms": b2_ms,
         "plain_ms": b2_plain_ms, "bound_ms": b2_bound, "bound_by": b2_by,
         "library_ms": None, "parity": b2_ok,
         "plain_arm_searches": b2_plain_calls},
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=1024)
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
