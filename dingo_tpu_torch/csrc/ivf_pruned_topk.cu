// Kernel B3: dimension-blocked early-pruning IVF probed-bucket scan.
//
// Replaces dingo_tpu/ops/pallas_ivf.py::ivf_pruned_topk (body
// _ivf_pruned_kernel) in its three row arms (pallas_ivf.py:296-310):
//   f32   rows and query f32;
//   bf16  rows widened exactly to f32 as they load, query f32;
//   sq8   uint8 codes decoded per element (code * scale + vmin in f32,
//         rounded to bf16) and the query rounded to bf16, f32 accumulation
//         (topk_common.cuh has the decode).
// Norms, bounds and stats are f32 in every arm; the store supplies the
// norms of what the arm accumulates. For each query and its `budget` virtual
// probes (bucket ids, -1 = padded rank, skipped) it returns the k best
// "larger is better" scores over valid rows, their slots (-1 where the
// score is -inf) and four stats lanes per query: 0 = candidate-block pairs
// scanned, 1 = pairs total, 2 = candidates scanned to the last block,
// 3 = candidates considered. k <= 64.
//
// Scores accumulate one dimension block (dblk columns) at a time. After a
// block j the bounds are
//   L2: partial = qpsq[j] - 2 cum + xpsq[j], upper bound of the score
//       -partial (the remaining blocks add >= 0 to the distance);
//   IP: cum + sqrt(qtail xtail) (Cauchy-Schwarz on the unseen suffix);
// and a candidate whose upper bound is strictly below the threshold is
// dropped. The threshold is the running k-th best, raised (flag
// `inbucket`) to the k-th largest suffix-norm LOWER bound among the
// bucket's alive candidates (L2: -(partial + (|q_tail| + |x_tail|)^2);
// IP: cum - |q_tail||x_tail|, both shaved by 1e-5 |lb| + 1e-6), and to the
// k-th best that other CTAs of the same query have published.
//
// What bounds it on an H100: bytes. Each probed bucket's rows are read
// block by block, alive rows only, plus the [nblk, cap] block norms; at
// b = 64, nprobe = 32, cap = 1024, d = 768 the unpruned traffic is that of
// B2 (3 MB per probed bucket) and pruning cuts the row bytes to the
// scanned fraction of (row, block) pairs. The bf16 arm halves the row bytes
// (1.5 MB a bucket) and the sq8 arm quarters them (0.75 MB), so their byte
// bound drops by 2x and 4x; the block norms, valid bytes and slots stay.
// The sq8 decode adds a multiply, an add and a rounding per element, which
// at 4 FMA-equivalents per byte stays under the card's f32 rate.
//
// Design: on the TPU the grid walks (query, rank, block) in order and
// streams whole [cap, dblk] tiles. Here one CTA owns a query and a group of
// consecutive probe ranks and walks them in order, so its running top-k
// (shared memory) carries from bucket to bucket. Per bucket it keeps cum,
// xpsq and the compacted list of alive rows in shared memory (12 KB at
// cap = 1024). Per block the 8 warps read the dblk-element slice (512, 256
// or 128 contiguous bytes at dblk = 128) of ALIVE rows only, 16 bytes per
// lane and load where dblk is a multiple of 4, 8 or 16 elements (else one
// element per lane). A row's slice is 32, 16 or 8 such loads, so a warp
// splits into groups of that many lanes, each group four rows per step
// (four, eight or sixteen rows a warp step), and folds the dots into cum:
// unlike the TPU, skipping a dead row here saves its HBM bytes. Warp 0
// then runs the block's epilogue: the bound refresh as a warp filter
// against the current threshold (no sort), the prune with an
// order-preserving ballot compaction, or, after the last block, the merge
// of the survivors into the running list. Each CTA's k candidates go to
// [b, groups, k] and B2's second pass merges them.
//
// The CTAs of one query run at the same time, so on the TPU's order only
// the CTA holding rank 0 (the query's nearest list) starts with good
// candidates; the others would scan their first bucket with no threshold.
// A seed launch of the same kernel therefore runs first, one CTA per query
// over the first 2k valid rows of its rank-0 bucket, and publishes their
// k-th best. Those rows are scanned again, with the same arithmetic, by
// the main launch, so the seed is the exact score of k real candidates:
// a valid threshold. The seed adds no candidates and no stats.

#include <type_traits>

#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 4;   // rows per warp step

template <typename T, bool VEC, int LPR>
__global__ void __launch_bounds__(THREADS)
ivf_pruned_kernel(const int* __restrict__ vprobes,
                  const float* __restrict__ queries,
                  const float* __restrict__ qpsq,
                  const T* __restrict__ buckets, dingo::Codec codec,
                  const float* __restrict__ bucket_bsq,
                  const float* __restrict__ bucket_sqnorm,
                  const unsigned char* __restrict__ bucket_valid,
                  const int* __restrict__ bucket_slot, int budget,
                  int nbuckets, int cap, int d, int dblk, int k,
                  int ascending, int check_every, int inbucket,
                  int ranks_per_cta, int row_limit,
                  int* __restrict__ thr_shared,
                  int* __restrict__ stats, float* __restrict__ cand_v,
                  int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float smem[];
  const int dpad = (d + 3) & ~3;
  float* qs = smem;                                     // [dpad]
  float* cum = qs + dpad;                               // [cap]
  float* xps = cum + cap;                               // [cap]
  int* alive = reinterpret_cast<int*>(xps + cap);       // [cap] row ids
  float* topv = reinterpret_cast<float*>(alive + cap);  // [k]
  int* topi = reinterpret_cast<int*>(topv + k);         // [k]
  float* tmpv = reinterpret_cast<float*>(topi + k);     // [k]
  __shared__ float qsq_s;
  __shared__ int nalive_s;
  __shared__ int st[4];

  const int g = blockIdx.x, qi = blockIdx.y, ngroups = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblk = d / dblk;
  const int r_lo = g * ranks_per_cta;
  const int r_hi = min(budget, r_lo + ranks_per_cta);

  // the sq8 arm pairs bf16 operands: its query rounds to bf16 here, while
  // ||q||^2 (below) and qpsq stay those of the f32 query
  constexpr bool kRoundQ = std::is_same<T, uint8_t>::value;
  for (int c = tid; c < dpad; c += THREADS) {
    const float v = c < d ? queries[(size_t)qi * d + c] : 0.f;
    qs[c] = kRoundQ ? dingo::round_bf16(v) : v;
  }
  if (tid < 4) st[tid] = 0;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = queries[(size_t)qi * d + c];
      s = fmaf(v, v, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
    if (lane == 0) qsq_s = s;
    dingo::list_init(topv, topi, k);
  }
  __syncthreads();
  const float qsq = qsq_s;
  // lane groups of the block scan: LPR lanes a row, rgroups rows a warp
  constexpr int rgroups = 32 / LPR;
  const int sub = lane / LPR, gl = lane % LPR;

  for (int r = r_lo; r < r_hi; ++r) {
    const int bucket = vprobes[(size_t)qi * budget + r];
    if (bucket < 0 || bucket >= nbuckets) continue;   // padded rank
    const size_t bbase = (size_t)bucket * cap;
    __syncthreads();   // the previous bucket's readers are done
    for (int c = tid; c < cap; c += THREADS) {
      cum[c] = 0.f;
      xps[c] = 0.f;
    }
    if (warp == 0) {   // alive list = the valid rows, in row order
      int cnt = 0;
      for (int base = 0; base < cap; base += 32) {
        const int row = base + lane;
        const bool v = row < cap && bucket_valid[bbase + row];
        const unsigned m = __ballot_sync(dingo::FULL_MASK, v);
        if (v) alive[cnt + __popc(m & ((1u << lane) - 1u))] = row;
        cnt += __popc(m);
      }
      if (lane == 0) {
        nalive_s = min(cnt, row_limit);
        st[1] += cnt * nblk;
        st[3] += cnt;
      }
    }
    __syncthreads();
    int nalive = nalive_s;

    for (int jb = 0; jb < nblk; ++jb) {
      if (tid == 0) {
        st[0] += nalive;
        if (jb == nblk - 1) st[2] += nalive;
      }
      if (nalive == 0) break;
      const int j0 = jb * dblk;

      // partial dots of this block over the alive rows: groups of LPR
      // lanes, ROWS rows each (a warp takes 32 / LPR groups of rows). The
      // trip count is the warp's, so every lane reaches the shuffles
      for (int w0 = warp * rgroups * ROWS; w0 < nalive;
           w0 += NWARPS * rgroups * ROWS) {
        const int p0 = w0 + sub * ROWS;
        int rows[ROWS];
        float acc[ROWS];
        const T* rowp[ROWS];
#pragma unroll
        for (int t = 0; t < ROWS; ++t) {
          rows[t] = p0 + t < nalive ? alive[p0 + t] : -1;
          acc[t] = 0.f;
          rowp[t] = rows[t] >= 0 ? buckets + (bbase + rows[t]) * d + j0
                                 : nullptr;
        }
        dingo::group_row_dots<T, VEC, ROWS, LPR>(rowp, qs + j0, dblk, j0,
                                                 codec, gl, acc);
#pragma unroll
        for (int t = 0; t < ROWS; ++t)
#pragma unroll
          for (int off = LPR >> 1; off > 0; off >>= 1)
            acc[t] += __shfl_xor_sync(dingo::FULL_MASK, acc[t], off);
#pragma unroll
        for (int t = 0; t < ROWS; ++t) {
          if (gl == t && rows[t] >= 0) {
            cum[rows[t]] += acc[t];
            xps[rows[t]] +=
                bucket_bsq[((size_t)bucket * nblk + jb) * cap + rows[t]];
          }
        }
      }
      __syncthreads();

      // the block's epilogue, warp 0
      if (warp == 0) {
        const float qp = qpsq[(size_t)qi * nblk + jb];
        const float qtail = fmaxf(qsq - qp, 0.f);
        if (jb == nblk - 1) {
          // merge the survivors' final scores into the running list
          float thr = topv[k - 1];
          for (int base = 0; base < nalive; base += 32) {
            const int p = base + lane;
            float sc = -CUDART_INF_F;
            int sid = -1;
            if (p < nalive) {
              const int row = alive[p];
              sc = ascending ? -((qp - 2.0f * cum[row]) + xps[row])
                             : cum[row];
              sid = bucket_slot[bbase + row];
            }
            unsigned mask = __ballot_sync(dingo::FULL_MASK, sc > thr);
            while (mask) {
              const int src = __ffs(mask) - 1;
              const float v = __shfl_sync(dingo::FULL_MASK, sc, src);
              const int id = __shfl_sync(dingo::FULL_MASK, sid, src);
              dingo::warp_insert(topv, topi, k, v, id);
              thr = topv[k - 1];
              mask &= ~(1u << src);
              mask &= __ballot_sync(dingo::FULL_MASK, sc > thr);
            }
          }
          if (lane == 0 && topv[k - 1] > -CUDART_INF_F)
            atomicMax(thr_shared + qi, dingo::ord_of(topv[k - 1]));
        } else if ((jb + 1) % check_every == 0) {
          float bnd = fmaxf(topv[k - 1],
                            dingo::float_of(__ldcg(thr_shared + qi)));
          if (inbucket) {
            // k-th largest lower bound among the alive rows, kept only
            // where it beats the current threshold: a warp filter
            for (int c = lane; c < k; c += 32) tmpv[c] = -CUDART_INF_F;
            __syncwarp();
            float t = bnd;
            for (int base = 0; base < nalive; base += 32) {
              const int p = base + lane;
              float lb = -CUDART_INF_F;
              if (p < nalive) {
                const int row = alive[p];
                lb = dingo::bounds_of(cum[row], xps[row],
                                      bucket_sqnorm[bbase + row], qp, qtail,
                                      ascending).lb;
              }
              unsigned mask = __ballot_sync(dingo::FULL_MASK, lb > t);
              while (mask) {
                const int src = __ffs(mask) - 1;
                dingo::warp_insert(tmpv, nullptr, k,
                                   __shfl_sync(dingo::FULL_MASK, lb, src), -1);
                t = fmaxf(bnd, tmpv[k - 1]);
                mask &= ~(1u << src);
                mask &= __ballot_sync(dingo::FULL_MASK, lb > t);
              }
            }
            bnd = fmaxf(bnd, tmpv[k - 1]);
          }
          // drop rows whose upper bound is strictly below the threshold;
          // in-place, order-preserving compaction of the alive list
          int cnt = 0;
          for (int base = 0; base < nalive; base += 32) {
            const int p = base + lane;
            int row = -1;
            bool keep = false;
            if (p < nalive) {
              row = alive[p];
              keep = !(dingo::bounds_of(cum[row], xps[row],
                                        bucket_sqnorm[bbase + row], qp,
                                        qtail, ascending).ub < bnd);
            }
            const unsigned m = __ballot_sync(dingo::FULL_MASK, keep);
            if (keep) alive[cnt + __popc(m & ((1u << lane) - 1u))] = row;
            cnt += __popc(m);
            __syncwarp();
          }
          if (lane == 0) nalive_s = cnt;
        }
      }
      __syncthreads();
      nalive = nalive_s;
    }
  }

  if (warp == 0 && cand_v != nullptr) {   // not the seed launch
    const size_t base = ((size_t)qi * ngroups + g) * k;
    for (int c = lane; c < k; c += 32) {
      cand_v[base + c] = topv[c];
      cand_i[base + c] = topi[c];
    }
    if (lane < 4) atomicAdd(stats + (size_t)qi * 4 + lane, st[lane]);
  }
}

size_t smem_bytes(int cap, int d, int k) {
  return sizeof(float) * ((size_t)((d + 3) & ~3) + 3 * (size_t)cap +
                          3 * (size_t)k);
}

template <typename T>
int launch(const int* vprobes, const float* queries, const float* qpsq,
           const T* buckets, dingo::Codec codec, const float* bucket_bsq,
           const float* bucket_sqnorm, const unsigned char* bucket_valid,
           const int* bucket_slot, int b, int budget, int nbuckets, int cap,
           int d, int dblk, int k, int ascending, int check_every,
           int inbucket, int ranks_per_cta, int vec, int* thr_shared,
           int* stats, float* cand_v, int* cand_i, float* out_v, int* out_i,
           void* stream) {
  if (k < 1 || k > dingo::K_MAX || b < 1 || budget < 1 || cap < 1 ||
      d < 1 || dblk < 1 || d % dblk != 0 || check_every < 1 ||
      ranks_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(cap, d, k);
  const int groups = (budget + ranks_per_cta - 1) / ranks_per_cta;
  const int lpr = dingo::lanes_per_row<T>(dblk, vec);
  auto kernel = !vec        ? ivf_pruned_kernel<T, false, 32>
                : lpr == 16 ? ivf_pruned_kernel<T, true, 16>
                : lpr == 8  ? ivf_pruned_kernel<T, true, 8>
                            : ivf_pruned_kernel<T, true, 32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // seed: rank 0 only, its first 2k valid rows, no candidates or stats
  kernel<<<dim3(1, b), THREADS, smem, st>>>(
      vprobes, queries, qpsq, buckets, codec, bucket_bsq, bucket_sqnorm,
      bucket_valid, bucket_slot, budget, nbuckets, cap, d, dblk, k,
      ascending, check_every, inbucket, 1, 2 * k, thr_shared, nullptr,
      nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(groups, b), THREADS, smem, st>>>(
      vprobes, queries, qpsq, buckets, codec, bucket_bsq, bucket_sqnorm,
      bucket_valid, bucket_slot, budget, nbuckets, cap, d, dblk, k,
      ascending, check_every, inbucket, ranks_per_cta, cap, thr_shared,
      stats, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<b, 256, 0, st>>>(cand_v, cand_i, groups * k,
                                                  k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vprobes[b, budget] i32; queries[b, d] f32; qpsq[b, nblk] f32 inclusive
// per-block prefix norms; buckets[nbuckets, cap, d] f32, bf16 (_bf16) or
// uint8 codes with vmin/scale [d] f32 (_sq8);
// bucket_bsq[nbuckets, nblk, cap] f32; bucket_sqnorm[nbuckets, cap] f32;
// bucket_valid[nbuckets, cap] bytes; bucket_slot[nbuckets, cap] i32.
// thr_shared[b] i32 holds ord_of(-inf) on entry; stats[b, 4] i32 zeros.
// cand_v/cand_i: [b, groups, k] scratch with groups = ceil(budget /
// ranks_per_cta); out_v/out_i: [b, k]. vec = d and dblk multiples of 4
// (f32), 8 (bf16) or 16 (sq8) with 16-byte aligned rows. Returns
// cudaGetLastError() after the launches (seed, scan, merge).
#define DINGO_B3_ARGS                                                        \
  const int *vprobes, const float *queries, const float *qpsq,              \
      const float *bucket_bsq, const float *bucket_sqnorm,                  \
      const unsigned char *bucket_valid, const int *bucket_slot, int b,     \
      int budget, int nbuckets, int cap, int d, int dblk, int k,            \
      int ascending, int check_every, int inbucket, int ranks_per_cta,      \
      int vec, int *thr_shared, int *stats, float *cand_v, int *cand_i,     \
      float *out_v, int *out_i, void *stream
#define DINGO_B3_PASS(buckets, codec)                                        \
  launch(vprobes, queries, qpsq, buckets, codec, bucket_bsq, bucket_sqnorm, \
         bucket_valid, bucket_slot, b, budget, nbuckets, cap, d, dblk, k,   \
         ascending, check_every, inbucket, ranks_per_cta, vec, thr_shared,  \
         stats, cand_v, cand_i, out_v, out_i, stream)

size_t dingo_ivf_pruned_smem_bytes(int cap, int d, int k) {
  return smem_bytes(cap, d, k);
}

int dingo_ivf_pruned_topk(const float* buckets, DINGO_B3_ARGS) {
  return DINGO_B3_PASS(buckets, (dingo::Codec{nullptr, nullptr}));
}

int dingo_ivf_pruned_topk_bf16(const __nv_bfloat16* buckets,
                               DINGO_B3_ARGS) {
  return DINGO_B3_PASS(buckets, (dingo::Codec{nullptr, nullptr}));
}

int dingo_ivf_pruned_topk_sq8(const uint8_t* buckets, const float* vmin,
                              const float* scale, DINGO_B3_ARGS) {
  return DINGO_B3_PASS(buckets, (dingo::Codec{vmin, scale}));
}

}  // extern "C"
