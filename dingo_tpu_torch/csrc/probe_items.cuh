// The work list of the bucket-major IVF scans (B2 and B3): ITEMS of one
// probed bucket and up to QT of the queries that probe it, built on the
// device from vprobes[b, budget] by two small kernels, with no host read.
// The valid (query, rank) pairs are grouped by bucket, by rank then query
// within a bucket, and cut into chunks of QT; the items are ordered by the
// rank of their first pair, then bucket, then position in the bucket, so
// that the items holding rank-0 pairs come first. The definition is
// ops/kernel_ivf_pruned.py::probe_items_plain.
#pragma once

#include "topk_common.cuh"

namespace dingo {

// Work list, pass 1, a warp per (query, rank) pair p = q * budget + r
// (its lanes split the scan over all pairs): its place among the valid
// pairs ordered by (bucket, rank, query) goes to pairs[]; a pair that
// opens a chunk of QT within its bucket (an item head) records its
// position in the bucket, the item's first pair and its count, and counts
// one item. With cand_v, every pair's candidate row is set to (-inf, -1).
template <int QT>
__global__ void items_pairs_kernel(const int* __restrict__ vprobes, int n,
                                   int budget, int nbuckets, int k,
                                   int* __restrict__ pairs,
                                   int* __restrict__ pos,
                                   int* __restrict__ first,
                                   int* __restrict__ count,
                                   int* __restrict__ counters,
                                   float* __restrict__ cand_v,
                                   int* __restrict__ cand_i) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n) return;
  const int bkt = vprobes[p];
  const bool valid = bkt >= 0 && bkt < nbuckets;
  if (cand_v != nullptr)
    for (int c = lane; c < k; c += 32) {
      cand_v[(size_t)p * k + c] = -CUDART_INF_F;
      cand_i[(size_t)p * k + c] = -1;
    }
  if (lane == 0) pos[p] = -1;
  if (!valid) return;
  const int q = p / budget, r = p - q * budget;
  int less = 0, before = 0, same = 0;
  for (int j = lane; j < n; j += 32) {
    const int b2 = __ldg(vprobes + j);
    if (b2 == bkt) {
      const int q2 = j / budget, r2 = j - q2 * budget;
      ++same;
      before += r2 < r || (r2 == r && q2 < q);
    } else if (b2 >= 0 && b2 < bkt) {
      ++less;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    less += __shfl_xor_sync(FULL_MASK, less, off);
    before += __shfl_xor_sync(FULL_MASK, before, off);
    same += __shfl_xor_sync(FULL_MASK, same, off);
  }
  if (lane != 0) return;
  pairs[less + before] = p;
  if (before % QT == 0) {
    pos[p] = before;
    first[p] = less + before;
    count[p] = min(QT, same - before);
    atomicAdd(counters, 1);
  }
}

// Work list, pass 2, a warp per item head: its slot among the heads
// ordered by (rank, bucket, position in the bucket).
__global__ void items_order_kernel(const int* __restrict__ vprobes,
                                   const int* __restrict__ pos,
                                   const int* __restrict__ first,
                                   const int* __restrict__ count, int n,
                                   int budget, int* __restrict__ item_bucket,
                                   int* __restrict__ item_first,
                                   int* __restrict__ item_count) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n) return;
  const int mp = pos[p];
  if (mp < 0) return;
  const int bkt = vprobes[p];
  const int r = p % budget;
  int slot = 0;
  const int step = 32 % budget;
  for (int j = lane, r2 = lane % budget; j < n; j += 32) {
    const int p2 = __ldg(pos + j);
    if (p2 >= 0) {
      const int b2 = __ldg(vprobes + j);
      slot += r2 < r || (r2 == r && (b2 < bkt || (b2 == bkt && p2 < mp)));
    }
    r2 += step;
    if (r2 >= budget) r2 -= budget;
  }
  for (int off = 16; off > 0; off >>= 1)
    slot += __shfl_xor_sync(FULL_MASK, slot, off);
  if (lane != 0) return;
  item_bucket[slot] = bkt;
  item_first[slot] = first[p];
  item_count[slot] = count[p];
}

// The work list into work[7 n + 2] (n = b * budget): pairs, pos, first,
// count, item_bucket, item_first, item_count ([n] each), counters [2].
template <int QT>
int build_items(const int* vprobes, int b, int budget, int nbuckets, int k,
                int* work, float* cand_v, int* cand_i, cudaStream_t st) {
  const int n = b * budget;
  int* counters = work + 7 * (size_t)n;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + 7) / 8;   // a warp per pair
  items_pairs_kernel<QT><<<grid, 256, 0, st>>>(
      vprobes, n, budget, nbuckets, k, work, work + n, work + 2 * n,
      work + 3 * n, counters, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  items_order_kernel<<<grid, 256, 0, st>>>(
      vprobes, work + n, work + 2 * n, work + 3 * n, n, budget, work + 4 * n,
      work + 5 * n, work + 6 * n);
  return (int)cudaGetLastError();
}

}  // namespace dingo
