"""k-means for IVF coarse quantizers (port of dingo_tpu/ops/kmeans.py).

Lloyd's iterations over fixed-size chunks: assignment is an argmin over the
[chunk, k] L2 matrix (one matrix product), the update sums rows per
cluster with ``index_add_``. Empty clusters keep their centroid, except the
first empty one, which jumps to the farthest point. Seeding is a greedy
farthest-first traversal from a host-chosen first index, so training is
deterministic given (data, seed). Everything stays on the data's device;
no step synchronizes with the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dingo_tpu_torch.ops.distance import pairwise_l2sqr, squared_norms

#: faiss ClusteringParameters.max_points_per_centroid default
MAX_POINTS_PER_CENTROID = 256


def farthest_first_init(x: torch.Tensor, first_idx: int, k: int
                        ) -> torch.Tensor:
    """Greedy farthest-first seeding -> [k] int64 row indices into x."""
    x = x.to(torch.float32)
    n = x.shape[0]
    x_sq = squared_norms(x)
    chosen = torch.zeros((k,), dtype=torch.int64, device=x.device)
    chosen[0] = int(first_idx)
    min_d = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    for i in range(1, k):
        c = x[chosen[i - 1]]
        d = x_sq - 2.0 * (x @ c) + torch.dot(c, c)
        torch.minimum(min_d, d, out=min_d)
        chosen[i] = torch.argmax(min_d)
    return chosen


def _chunks(n: int, chunk: int):
    chunk = min(chunk, max(256, n))
    return [(s, min(n, s + chunk)) for s in range(0, n, chunk)]


def kmeans_fit(x: torch.Tensor, seed_idx: torch.Tensor, k: int,
               iters: int = 10, chunk: int = 16384
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit k centroids to x[n, d]; seed_idx: [k] initial row indices.
    Returns (centroids[k, d] f32, cluster_sizes[k] f32)."""
    x = x.to(torch.float32)
    n, d = x.shape
    dev = x.device
    spans = _chunks(n, chunk)
    centroids = x[seed_idx.to(dev).long()].clone()
    arange_k = torch.arange(k, device=dev)
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        best_all = torch.empty((n,), dtype=torch.float32, device=dev)
        for lo, hi in spans:
            xi = x[lo:hi]
            dist = pairwise_l2sqr(xi, centroids)
            best, assign = torch.min(dist, dim=1)
            sums.index_add_(0, assign, xi)
            counts.index_add_(0, assign, torch.ones_like(best))
            best_all[lo:hi] = best
        far_pt = x[torch.argmax(best_all)]
        empty = counts < 0.5
        new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
        new_c = torch.where(empty[:, None], centroids, new_c)
        first_empty = torch.argmax(empty.to(torch.int32))
        jump = (arange_k == first_empty) & empty.any()
        centroids = torch.where(jump[:, None], far_pt[None, :], new_c)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    for lo, hi in spans:
        assign = torch.argmin(pairwise_l2sqr(x[lo:hi], centroids), dim=1)
        counts.index_add_(0, assign, torch.ones((hi - lo,), device=dev))
    return centroids, counts


def train_kmeans(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Farthest-first init + Lloyd iterations; the first seed index comes
    from numpy's default_rng(seed), as in the JAX package."""
    first = np.random.default_rng(seed).integers(0, x.shape[0])
    seeds = farthest_first_init(x, int(first), k)
    return kmeans_fit(x, seeds, k=k, iters=iters)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                  chunk: int = 16384) -> torch.Tensor:
    """Nearest-centroid assignment [n] int32, chunked for memory."""
    x = x.to(torch.float32)
    n = x.shape[0]
    c_sq = squared_norms(centroids)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    for lo, hi in _chunks(n, chunk):
        out[lo:hi] = torch.argmin(
            pairwise_l2sqr(x[lo:hi], centroids, c_sq), dim=1
        ).to(torch.int32)
    return out
