#!/usr/bin/env python3
"""The port's f32 arithmetic against f64 on one NVIDIA GPU.

    python3 precision_check.py                  # seeds 7, 11, 13; 1M x 768
    python3 precision_check.py --n 131072 --seeds 7

For each seed, the rows are chip_smoke.py's (bench.py's recipe: n // 1000
Gaussian centers + 0.35 noise, queries = stored rows + 0.05 noise, d 768,
64 queries), and the coarse quantizer and the PQ codebooks are trained as
TpuIvfPq trains them (nlist 1024 over a 65,536-row sample, m 96 over its
residuals). These f32 computations are read against the same computation
in f64 on the same f32 inputs:

  flat     the fp32 plain FLAT arm's distance matrix (``pairwise_l2sqr``,
           what ``flat_search_plain`` ranks), every [64, n] entry, and its
           top-10 ids against the f64 top-10;
  kmeans   the k-means assignment's distances (``pairwise_l2sqr`` of a
           65,536-row sample against the centroids) and its argmin;
  probes   ``coarse_probes``' query-to-centroid distances and its top-32;
  table    the residual-table kernel (``kernel_pq.ivfpq_adc_lut``) at
           nprobe 32, every [64, 32, 96, 256] entry;
  B1, B1-bf16, B2, B2-bf16
           the split-precision tensor-core kernels (3xTF32 for f32 rows,
           three bf16 parts of the query for bf16 rows): B1 over all the
           rows, B2 over an IVF_FLAT index of them (nlist 1024, nprobe 32),
           k 10; their distances (negated scores) against f64's at the
           same (query, row), beside the fp32 plain arm's there
           (``pairwise_l2sqr`` of the same rows as f32, "plain at the same
           entries"), and their ids against f64's top-10 (of every row for
           B1, of the probed rows for B2). The gate: relative error at most
           twice the plain arm's on the same entries, and no id off f64's
           other than by a tie; a failed gate exits 1.

For each it prints the largest relative error |f32 - f64| / |f64| (over
entries whose f64 value is above 1e-3 of the largest, so that a distance
that cancels to ~0 does not set it), the largest absolute error, and the
ids (or assignments) that differ from f64's other than by a tie: an id
outside f64's list whose f64 distance is not within 1e-5 relative of the
k-th. The card's name and power limit come first. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

#: two f64 distances closer than this (relative) are a tie
TIE_RTOL = 1e-5


def rel_errors(got, ref) -> tuple:
    """(max relative error over |ref| >= 1e-3 max |ref|, max abs error)."""
    import torch

    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    big = ref.abs() >= 1e-3 * float(ref.abs().max())
    rel = float((err[big] / ref.abs()[big]).max())
    return rel, float(err.max())


def untied_misses(got_ids, ref_dist, k: int) -> int:
    """Ids in got_ids[i] (each row's k smallest by f32) that are not among
    f64's k smallest of ref_dist[i] and not tied with f64's k-th."""
    import torch

    kth = torch.topk(ref_dist, k, dim=1, largest=False).values[:, -1:]
    dist_got = torch.gather(ref_dist, 1, got_ids.long())
    tied = (dist_got - kth).abs() <= TIE_RTOL * kth.abs()
    return int(((dist_got > kth) & ~tied).sum())


def check_seed(seed: int, n: int, d: int, nlist: int, m: int) -> dict:
    import torch

    from chip_smoke import make_data
    from dingo_tpu_torch.index.ivf_flat import coarse_probes
    from dingo_tpu_torch.ops import kernel_pq
    from dingo_tpu_torch.ops.distance import pairwise_l2sqr, squared_norms
    from dingo_tpu_torch.ops.kmeans import kmeans_assign, train_kmeans
    from dingo_tpu_torch.ops.pq import pq_train

    dev = torch.device("cuda")
    x_h, q_h, _ = make_data(n, d, 64, seed=seed)
    x = torch.from_numpy(x_h).to(dev)
    q = torch.from_numpy(q_h).to(dev)
    out = {}

    # the fp32 plain FLAT arm: every entry of its distance matrix
    d32 = pairwise_l2sqr(q, x, squared_norms(x))
    x64, q64 = x.double(), q.double()
    d64 = ((q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ x64.T)
           + (x64 * x64).sum(1)[None, :]).clamp_min(0.0)
    ids = torch.topk(d32, 10, dim=1, largest=False).indices
    out["flat"] = rel_errors(d32, d64) + (untied_misses(ids, d64, 10),)
    del d32, d64

    # the coarse quantizer as TpuIvfPq trains it, and its assignment
    rng = np.random.default_rng(seed)
    sample = x[torch.from_numpy(rng.choice(n, min(n, 65536),
                                           replace=False)).to(dev)]
    cent, _ = train_kmeans(sample, k=nlist, iters=10, seed=seed)
    c64, s64 = cent.double(), sample.double()
    a32 = pairwise_l2sqr(sample, cent, squared_norms(cent))
    a64 = ((s64 * s64).sum(1)[:, None] - 2.0 * (s64 @ c64.T)
           + (c64 * c64).sum(1)[None, :]).clamp_min(0.0)
    assign = kmeans_assign(sample, cent)
    out["kmeans"] = rel_errors(a32, a64) + (
        untied_misses(assign[:, None], a64, 1),)
    del a32, a64

    # the probes: coarse_probes' distances and its top-32
    c_sq = squared_norms(cent)
    p32 = (squared_norms(q)[:, None] - 2.0 * (q @ cent.T) + c_sq[None, :])
    p64 = ((q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ c64.T)
           + (c64 * c64).sum(1)[None, :])
    probes = coarse_probes(q, cent, c_sq, 32)
    out["probes"] = rel_errors(p32, p64) + (untied_misses(probes, p64, 32),)

    # the residual tables, as the B5 route builds them
    resid = sample - cent[assign.long()]
    books = pq_train(resid, m=m, ksub=256, iters=10, seed=seed)
    lut = kernel_pq.ivfpq_adc_lut(q, cent, probes, books)
    r64 = (q64[:, None, :] - c64[probes.long()]).reshape(64, 32, m, d // m)
    b64 = books.double()
    t64 = ((r64 * r64).sum(-1)[..., None]
           - 2.0 * torch.einsum("bpjt,jct->bpjc", r64, b64)
           + (b64 * b64).sum(-1)[None, None])
    out["table"] = rel_errors(lut, t64) + (0,)
    del lut, t64, r64
    out.update(split_kernels(x, q, seed))
    return out


def split_kernels(x, q, seed: int) -> dict:
    """B1 and B2 in both arms against f64 on rows x [n, d] and queries q:
    {name: (rel, abs, untied misses, plain rel, plain abs)} over each
    kernel's returned (query, row) entries; the plain fp32 arm's errors at
    the same entries."""
    import torch

    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat, coarse_probes
    from dingo_tpu_torch.index.ivf_layout import expand_probes
    from dingo_tpu_torch.ops import kernel_ivf, kernel_topk
    from dingo_tpu_torch.ops.distance import pairwise_l2sqr, squared_norms

    k, dev = 10, x.device
    q64 = q.double()
    out = {}
    for arm, dtype in (("", torch.float32), ("-bf16", torch.bfloat16)):
        rows = x.to(dtype)
        x32 = rows.to(torch.float32)
        xsq = squared_norms(x32)
        x64 = x32.double()
        d64 = ((q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ x64.T)
               + (x64 * x64).sum(1)[None, :])

        def errors(dist32, ids, cand64):
            """(rel, abs) of the kernel's distances at its ids, untied
            misses against the f64 top-k of cand64 (inf: not a candidate),
            (rel, abs) of the plain arm at the same entries."""
            ids = ids.long()
            ref = torch.gather(d64, 1, ids)
            plain = torch.gather(pairwise_l2sqr(q, x32, xsq), 1, ids)
            return (rel_errors(dist32, ref)
                    + (untied_misses(ids, cand64, k),)
                    + rel_errors(plain, ref))

        v, i = kernel_topk.fused_topk(q, rows, xsq,
                                      torch.ones(x.shape[0], dtype=torch.bool,
                                                 device=dev), k)
        out["B1" + arm] = errors(-v, i, d64)

        ivf = TpuIvfFlat(90, IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=x.shape[1],
            ncentroids=1024, precision="fp32" if not arm else "bf16"),
            device=dev)
        ivf.upsert(np.arange(x.shape[0]), x.cpu().numpy())
        ivf.train()
        ivf.search(q[:1].cpu().numpy(), k, nprobe=32)   # the bucket view
        view = ivf._view
        probes = coarse_probes(q, ivf.centroids, ivf._c_sqnorm, 32)
        vp = expand_probes(probes, view.probe_table, 32, view.max_spill)
        v, i = kernel_ivf.ivf_list_topk(
            vp, q, ivf._buckets, ivf._bucket_sqnorm, view.bucket_valid,
            view.bucket_slot, k)
        # f64's top-k among the rows the probes reach
        ok = vp >= 0
        slots = view.bucket_slot[vp.clamp_min(0).long()]   # [b, r, cap]
        live = view.bucket_valid[vp.clamp_min(0).long()] & ok[:, :, None]
        reach = torch.full_like(d64, float("inf"))
        flat_slots = slots.reshape(slots.shape[0], -1).long()
        flat_live = live.reshape(live.shape[0], -1)
        src = torch.where(flat_live, torch.gather(d64, 1,
                                                  flat_slots.clamp_min(0)),
                          torch.full_like(flat_slots, float("inf"),
                                          dtype=torch.float64))
        reach.scatter_(1, flat_slots.clamp_min(0), src)
        out["B2" + arm] = errors(-v, i, reach)
        del ivf, view, d64, x64, reach
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 11, 13])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("precision_check: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    gate_failed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = check_seed(seed, args.n, args.d, args.nlist, args.m)
        for name, (rel, ab, miss, *plain) in res.items():
            beside = ""
            if plain:   # a split-precision kernel: the gate
                prel, pab = plain
                beside = (f"; the fp32 plain arm at the same entries: max "
                          f"rel err {prel:.3e}, max abs err {pab:.3e}")
                if rel > 2.0 * prel or miss:
                    gate_failed.append(f"seed {seed} {name}")
            print(f"[{card}] seed {seed} {name}: max rel err {rel:.3e}, max "
                  f"abs err {ab:.3e}, ids off f64's other than by a tie "
                  f"{miss}{beside}", flush=True)
            w = worst.get(name, (0.0, 0.0, 0, 0.0))
            worst[name] = (max(w[0], rel), max(w[1], ab), w[2] + miss,
                           max(w[3], plain[0] if plain else 0.0))
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (rel, ab, miss, prel) in worst.items():
        print(f"[{card}] over seeds {args.seeds} {name}: max rel err "
              f"{rel:.3e}, max abs err {ab:.3e}, untied misses {miss}"
              + (f" (plain arm at the same entries {prel:.3e})" if prel
                 else ""), flush=True)
    print("gate (split-precision kernels: relative error <= 2x the plain "
          "arm's at the same entries, no untied miss): "
          + ("FAILED " + ", ".join(gate_failed) if gate_failed else "passed"),
          flush=True)
    return 1 if gate_failed else 0


if __name__ == "__main__":
    sys.exit(main())
