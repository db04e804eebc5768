// Running top-k pieces shared by the scan kernels (the Hopper counterpart
// of _select_topk in dingo_tpu/ops/pallas_topk.py).
//
// A running list is k <= K_MAX (score, slot) pairs in shared memory, sorted
// by descending score. A warp inserts one candidate at a time, all 32 lanes
// cooperating (each lane owns list positions lane and lane + 32), so an
// insertion costs two ballots and one shift, independent of k. A candidate
// is inserted only when its score is strictly above the current k-th best:
// among equal scores the earlier candidate stays, which keeps the lowest
// slot when candidates arrive in slot order (the TPU kernel's tie rule).
// Slots whose score is -inf are never inserted, so a list that saw fewer
// than k valid rows keeps (-inf, -1) entries, the contract of every exit.
//
// Row element types of the precision tiers: float (fp32 rows),
// __nv_bfloat16 (bf16 rows) and uint8_t (sq8 codes). The CUDA-core scan
// (B3) converts each element to f32 as it loads (B4's bf16 arms feed the
// tensor cores instead, with the same sq8 decode):
//   bf16  widens exactly (__bfloat162float);
//   sq8   decodes code * scale[j] + vmin[j] in f32 with __fmul_rn then
//         __fadd_rn (no contraction into an FMA: numpy and the JAX package
//         round the multiply and the add apart, and an FMA would flip bf16
//         roundings near a tie), then rounds to bf16 and widens back.
// A query that the arm pairs with bf16 operands is rounded the same way
// (round_bf16) where it is staged; its norms stay those of the f32 query.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace dingo {

constexpr int K_MAX = 64;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The sq8 codec on the device ([d] f32 each); unused by the float arms.
struct Codec {
  const float* vmin;
  const float* scale;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sq_decode(float code, float scale,
                                           float vmin) {
  return round_bf16(__fadd_rn(__fmul_rn(code, scale), vmin));
}

// One element of a row as the scans accumulate it; col = its dimension.
__device__ __forceinline__ float row_value(float v, int, Codec) { return v; }
__device__ __forceinline__ float row_value(__nv_bfloat16 v, int, Codec) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float row_value(uint8_t v, int col, Codec cd) {
  return sq_decode((float)v, __ldg(cd.scale + col), __ldg(cd.vmin + col));
}

__device__ __forceinline__ void list_init(float* vals, int* ids, int k) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < k; i += 32) {
    vals[i] = -CUDART_INF_F;
    ids[i] = -1;
  }
  __syncwarp();
}

// Called by all 32 lanes of a warp with the same (v, id); requires
// v > vals[k - 1]. ids may be null: a value-only list, as the pruned
// scans' selection of the k-th largest lower bound.
__device__ __forceinline__ void warp_insert(float* vals, int* ids, int k,
                                            float v, int id) {
  const int lane = threadIdx.x & 31;
  const int i0 = lane, i1 = lane + 32;
  float a = 0.f, b = 0.f;
  int ia = -1, ib = -1;
  bool ga = false, gb = false;
  if (i0 < k) { a = vals[i0]; ia = ids ? ids[i0] : -1; ga = a >= v; }
  if (i1 < k) { b = vals[i1]; ib = ids ? ids[i1] : -1; gb = b >= v; }
  const int p = __popc(__ballot_sync(FULL_MASK, ga)) +
                __popc(__ballot_sync(FULL_MASK, gb));
  __syncwarp();
  if (i0 < k && i0 >= p && i0 + 1 < k) {
    vals[i0 + 1] = a;
    if (ids) ids[i0 + 1] = ia;
  }
  if (i1 < k && i1 >= p && i1 + 1 < k) {
    vals[i1 + 1] = b;
    if (ids) ids[i1 + 1] = ib;
  }
  if (lane == 0) {
    vals[p] = v;
    if (ids) ids[p] = id;
  }
  __syncwarp();
}

// Bounds of the pruned scans (B3, B4) for one candidate after some
// dimension block: cum = partial dot, xps = the row's prefix norm and
// xsq its total norm, qp = the query's prefix norm, qtail = ||q||^2 - qp.
//   ub: L2 -(qp - 2 cum + xps) (the remaining blocks add >= 0 to the
//       distance); IP cum + sqrt(qtail xtail) (Cauchy-Schwarz);
//   lb: L2 -(partial + (|q_tail| + |x_tail|)^2) (triangle inequality);
//       IP cum - sqrt(qtail xtail); shaved by 1e-5 |lb| + 1e-6 so f32
//       rounding stays on the conservative side.
// ub is raised by 1e-5 (||q||^2 + ||x||^2) + 1e-6 for the same reason: a
// seed launch publishes a row's exact final score as the threshold, and
// the same row's ub at an earlier block, summed from partial dots and
// prefix norms reduced in other orders, can round below it by a few ulps
// of the norms; without the raise the row prunes itself and a k = 1
// search whose query is that row comes back empty.
struct Bounds {
  float ub, lb;
};

__device__ __forceinline__ Bounds bounds_of(float cum, float xps, float xsq,
                                            float qp, float qtail,
                                            int ascending) {
  const float xtail = fmaxf(xsq - xps, 0.f);
  Bounds r;
  if (ascending) {
    const float partial = (qp - 2.0f * cum) + xps;
    const float tail = sqrtf(qtail) + sqrtf(xtail);
    r.ub = -partial;
    r.lb = -(partial + tail * tail);
  } else {
    const float s = sqrtf(qtail * xtail);
    r.ub = cum + s;
    r.lb = cum - s;
  }
  r.lb = r.lb - 1e-5f * fabsf(r.lb) - 1e-6f;
  r.ub = r.ub + 1e-5f * (qp + qtail + xsq) + 1e-6f;
  return r;
}

// The bounds of a (query, row) pair after a block in a kernel arm
// (bounds_of). The arms that multiply in bf16 (B4's bf16 and sq8 arms,
// B3's sq8 arm) multiply the query rounded to bf16 (and sq8 rows rounded
// to bf16) while the norms are those of the f32 query and of the f32
// rows, so a pair's remaining blocks can add a little less than 0 to its
// L2 distance, or a little more than the Cauchy-Schwarz term to its inner
// product: each side's bf16 rounding moves its tail's squared norm by at
// most 2^-8 of it. There both bounds widen by 2^-7 of the tail terms,
// which keeps them bounds of the score the arm computes: the scan then
// prunes no pair its own arithmetic would have kept, a seeded row among
// them.
template <bool kBf16>
__device__ __forceinline__ Bounds arm_bounds(float cum, float xps, float xsq,
                                             float qp, float qtail,
                                             int ascending) {
  Bounds r = bounds_of(cum, xps, xsq, qp, qtail, ascending);
  if (kBf16) {
    const float xtail = fmaxf(xsq - xps, 0.f);
    const float cross = sqrtf(qtail * xtail);
    const float slack =
        ascending ? 0.0078125f * (qtail + xtail + 2.0f * cross)
                  : 0.0078125f * 2.0f * cross;
    r.ub += slack;
    r.lb -= slack;
  }
  return r;
}

// Order-preserving int image of a float (and its inverse): a > b as floats
// iff ord_of(a) > ord_of(b) as ints, so atomicMax on the image keeps a
// running float maximum. The pruned scans share each query's k-th best
// across CTAs this way: any partial list's k-th best is at most the final
// one, so it is always a valid prune threshold.
__device__ __forceinline__ int ord_of(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float float_of(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Second pass: cand_v/cand_i hold [rows, m] candidates (m = lists x k);
// one block per row picks the top k by k rounds of a block-wide argmax
// (ties -> lowest candidate position, i.e. the earliest list). Taken
// candidates are marked NaN in cand_v, which is scratch. Writes slot -1
// wherever the picked score is -inf. With thr (B4's seed) it publishes
// each row's k-th best, where finite, by atomicMax on its ordered image,
// and out_v/out_i may be null.
template <int THREADS>
__global__ void merge_candidates(float* __restrict__ cand_v,
                                 const int* __restrict__ cand_i, int m,
                                 int k, float* __restrict__ out_v,
                                 int* __restrict__ out_i,
                                 int* __restrict__ thr = nullptr) {
  constexpr int NW = THREADS / 32;
  __shared__ float sv[NW];
  __shared__ int si[NW];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* cv = cand_v + (size_t)row * m;
  const int* ci = cand_i + (size_t)row * m;
  for (int r = 0; r < k; ++r) {
    float best = -CUDART_INF_F;
    int bidx = INT_MAX;
    for (int j = threadIdx.x; j < m; j += THREADS) {
      const float v = cv[j];
      if (better(v, j, best, bidx)) { best = v; bidx = j; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(FULL_MASK, best, off);
      const int oi = __shfl_down_sync(FULL_MASK, bidx, off);
      if (better(ov, oi, best, bidx)) { best = ov; bidx = oi; }
    }
    if (lane == 0) { sv[warp] = best; si[warp] = bidx; }
    __syncthreads();
    if (warp == 0) {
      best = lane < NW ? sv[lane] : -CUDART_INF_F;
      bidx = lane < NW ? si[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(FULL_MASK, best, off);
        const int oi = __shfl_down_sync(FULL_MASK, bidx, off);
        if (better(ov, oi, best, bidx)) { best = ov; bidx = oi; }
      }
      if (lane == 0) {
        const bool none = bidx == INT_MAX || best == -CUDART_INF_F;
        if (out_v != nullptr) {
          out_v[(size_t)row * k + r] = best;
          out_i[(size_t)row * k + r] = none ? -1 : ci[bidx];
        }
        if (thr != nullptr && r == k - 1 && !none)
          atomicMax(thr + row, ord_of(best));
        if (bidx != INT_MAX) cv[bidx] = CUDART_NAN_F;
      }
    }
    __syncthreads();
  }
}

}  // namespace dingo
