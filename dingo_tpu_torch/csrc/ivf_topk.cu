// Kernel B2: IVF probed-bucket scan + running top-k.
//
// Replaces dingo_tpu/ops/pallas_ivf.py::ivf_list_topk (body _ivf_kernel),
// in both of its row arms: f32 rows, and bf16 rows widened to f32 as they
// load (pallas_ivf.py:65, the query stays f32, f32 products). For each
// query and each of its `budget` virtual probes (bucket ids, -1 = padded
// rank, skipped), scans the bucket's [cap, d] rows and keeps the k
// best "larger is better" scores (L2: -(||q||^2 - 2 q.x + ||x||^2); IP: q.x)
// over valid rows, with their slots; -1 where the score is -inf. k <= 64.
//
// What bounds it on an H100: the work per row is one d-long dot product
// (2 FLOP per 4 bytes read), so bytes bound it: at b = 64, nprobe = 32,
// cap = 1024, d = 768 each probe reads a 3 MB bucket, and the least time is
// the bytes of the distinct buckets the batch probes over 3.35 TB/s.
// bf16 arm: the rows halve to 1.5 MB a bucket, so the byte bound halves;
// the FMAs stay the same f32 ones, 8 per 16-byte load instead of 4 (1 FLOP
// per byte read, far under the card's ~20 f32 FLOP per byte of HBM), so
// bytes still bound the arm.
//
// Design: the TPU's scalar prefetch picks the bucket a grid step DMAs; here
// each CTA reads its own bucket id from vprobes. One CTA per (query, probe
// rank): the query sits in shared memory, each warp takes every 8th row,
// four rows at a time (four independent float4 streams per lane keep loads
// in flight), reduces the dot products with shuffles and inserts into its
// own running list; warp 0 then folds the eight lists into one and writes
// k candidates per (query, rank). The cross-rank merge is the same second
// pass as B1. A bucket probed by several queries of the batch is read once
// per query (L2 may catch the repeats); sharing a bucket tile across the
// queries that probe it is later work.

#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 4;   // rows per warp step

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ivf_scan_kernel(const int* __restrict__ vprobes,
                const float* __restrict__ queries,
                const T* __restrict__ buckets,
                const float* __restrict__ bucket_sqnorm,
                const unsigned char* __restrict__ bucket_valid,
                const int* __restrict__ bucket_slot, int budget, int nbuckets,
                int cap, int d, int k, int ascending,
                float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [d] (padded to 4)
  const int dpad = (d + 3) & ~3;
  float* topv = qs + dpad;                            // [NWARPS][k]
  int* topi = reinterpret_cast<int*>(topv + NWARPS * k);
  __shared__ float qsq_s;

  const int r = blockIdx.x, qi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t out_base = ((size_t)qi * budget + r) * k;
  const int bucket = vprobes[(size_t)qi * budget + r];
  if (bucket < 0 || bucket >= nbuckets) {   // padded rank: no scan
    for (int c = tid; c < k; c += THREADS) {
      cand_v[out_base + c] = -CUDART_INF_F;
      cand_i[out_base + c] = -1;
    }
    return;
  }

  for (int c = tid; c < dpad; c += THREADS)
    qs[c] = c < d ? queries[(size_t)qi * d + c] : 0.f;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fmaf(qs[c], qs[c], s);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
    if (lane == 0) qsq_s = s;
  }
  float* lv = topv + warp * k;
  int* li = topi + warp * k;
  dingo::list_init(lv, li, k);
  __syncthreads();
  const float qsq = qsq_s;

  const size_t bbase = (size_t)bucket * cap;
  float thr = -CUDART_INF_F;
  for (int row0 = warp * ROWS; row0 < cap; row0 += NWARPS * ROWS) {
    float acc[ROWS];
    const T* rowp[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      acc[t] = 0.f;
      rowp[t] = row0 + t < cap ? buckets + (bbase + row0 + t) * d : nullptr;
    }
    dingo::group_row_dots<T, VEC, ROWS, 32>(rowp, qs, d, 0,
                                            dingo::Codec{}, lane, acc);
#pragma unroll
    for (int t = 0; t < ROWS; ++t)
      for (int off = 16; off > 0; off >>= 1)
        acc[t] += __shfl_xor_sync(dingo::FULL_MASK, acc[t], off);
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int row = row0 + t;
      if (row >= cap) break;
      const size_t p = bbase + row;
      if (!bucket_valid[p]) continue;
      const float sc = ascending ? -((qsq - 2.0f * acc[t]) + bucket_sqnorm[p])
                                 : acc[t];
      if (sc > thr) {
        dingo::warp_insert(lv, li, k, sc, bucket_slot[p]);
        thr = lv[k - 1];
      }
    }
  }
  __syncthreads();

  // warp 0 folds the other warps' lists into its own
  if (warp == 0) {
    float t0 = lv[k - 1];
    for (int w = 1; w < NWARPS; ++w) {
      for (int i = 0; i < k; ++i) {
        const float v = topv[w * k + i];
        if (!(v > t0)) break;   // lists are sorted: the rest cannot enter
        dingo::warp_insert(lv, li, k, v, topi[w * k + i]);
        t0 = lv[k - 1];
      }
    }
    for (int c = lane; c < k; c += 32) {
      cand_v[out_base + c] = lv[c];
      cand_i[out_base + c] = li[c];
    }
  }
}

template <typename T>
int launch(const int* vprobes, const float* queries, const T* buckets,
           const float* bucket_sqnorm, const unsigned char* bucket_valid,
           const int* bucket_slot, int b, int budget, int nbuckets, int cap,
           int d, int k, int ascending, int vec, float* cand_v, int* cand_i,
           float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > dingo::K_MAX || b < 1 || budget < 1 || cap < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)((d + 3) & ~3) +
                      (sizeof(float) + sizeof(int)) * (size_t)NWARPS * k;
  auto kernel = vec ? ivf_scan_kernel<T, true> : ivf_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(budget, b), THREADS, smem, st>>>(
      vprobes, queries, buckets, bucket_sqnorm, bucket_valid, bucket_slot,
      budget, nbuckets, cap, d, k, ascending, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<b, 256, 0, st>>>(cand_v, cand_i,
                                                  budget * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vprobes[b, budget] i32; queries[b, d] f32; buckets[nbuckets, cap, d] f32
// (dingo_ivf_list_topk) or bf16 (dingo_ivf_list_topk_bf16);
// bucket_sqnorm[nbuckets, cap] f32; bucket_valid[nbuckets, cap] bytes;
// bucket_slot[nbuckets, cap] i32. cand_v/cand_i: [b, budget, k] scratch;
// out_v/out_i: [b, k]. vec = d a multiple of 4 (f32) or 8 (bf16) with
// 16-byte aligned rows and queries. Returns cudaGetLastError() after both
// launches.
int dingo_ivf_list_topk(const int* vprobes, const float* queries,
                        const float* buckets, const float* bucket_sqnorm,
                        const unsigned char* bucket_valid,
                        const int* bucket_slot, int b, int budget,
                        int nbuckets, int cap, int d, int k, int ascending,
                        int vec, float* cand_v, int* cand_i, float* out_v,
                        int* out_i, void* stream) {
  return launch(vprobes, queries, buckets, bucket_sqnorm, bucket_valid,
                bucket_slot, b, budget, nbuckets, cap, d, k, ascending, vec,
                cand_v, cand_i, out_v, out_i, stream);
}

int dingo_ivf_list_topk_bf16(const int* vprobes, const float* queries,
                             const __nv_bfloat16* buckets,
                             const float* bucket_sqnorm,
                             const unsigned char* bucket_valid,
                             const int* bucket_slot, int b, int budget,
                             int nbuckets, int cap, int d, int k,
                             int ascending, int vec, float* cand_v,
                             int* cand_i, float* out_v, int* out_i,
                             void* stream) {
  return launch(vprobes, queries, buckets, bucket_sqnorm, bucket_valid,
                bucket_slot, b, budget, nbuckets, cap, d, k, ascending, vec,
                cand_v, cand_i, out_v, out_i, stream);
}

}  // extern "C"
