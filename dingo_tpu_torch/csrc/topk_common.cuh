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
// Row element types of the precision tiers, shared by every scan: float
// (fp32 rows), __nv_bfloat16 (bf16 rows) and uint8_t (sq8 codes). The
// CUDA-core scans convert each element to f32 on load and run their f32
// tile unchanged (B4's bf16 arms feed the tensor cores instead, with the
// same sq8 decode):
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
#include <type_traits>

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

// Elements per 16-byte load of each row type.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// The codec of the N columns of one 16-byte load, fetched once and reused
// for every row of a warp step (empty for the float arms).
template <typename T>
struct ColCodec {
  __device__ __forceinline__ void load(int, Codec) {}
};
template <>
struct ColCodec<uint8_t> {
  float sc[16], vm[16];
  __device__ __forceinline__ void load(int col0, Codec cd) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[i] = __ldg(cd.scale + col0 + i);
      vm[i] = __ldg(cd.vmin + col0 + i);
    }
  }
};

// Unpack one 16-byte load of Vec16<T>::N elements to f32.
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         const ColCodec<float>&, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         const ColCodec<__nv_bfloat16>&,
                                         float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         const ColCodec<uint8_t>& cc,
                                         float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = sq_decode((float)((w[i >> 2] >> (8 * (i & 3))) & 0xffu),
                       cc.sc[i], cc.vm[i]);
}

// Partial dots of ROWS rows with a query slice, one group of LPR lanes
// (lane l of it) striding over `len` columns starting at column col0 (row
// pointers already offset to col0; a null row skips). VEC reads 16 bytes
// per lane and load, which needs len a multiple of Vec16<T>::N and 16-byte
// aligned row slices; the caller folds the group's lanes. qs is the staged
// query slice in shared memory.
template <typename T, bool VEC, int ROWS, int LPR>
__device__ __forceinline__ void group_row_dots(const T* (&rowp)[ROWS],
                                               const float* __restrict__ qs,
                                               int len, int col0, Codec cd,
                                               int l, float (&acc)[ROWS]) {
  if (VEC) {
    constexpr int N = Vec16<T>::N;
    for (int c = l; c < len / N; c += LPR) {
      float qv[N];
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + c * N + e);
        qv[e] = q4.x;
        qv[e + 1] = q4.y;
        qv[e + 2] = q4.z;
        qv[e + 3] = q4.w;
      }
      ColCodec<T> cc;
      cc.load(col0 + c * N, cd);
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        if (rowp[t] != nullptr) {
          // f32 rows take the read-only path, which the kernels'
          // __restrict__ gave them before the row pointers moved into an
          // array; bf16 rows measured slower on it (B2-bf16 1.28 against
          // 1.12 ms, H100 80GB HBM3 at 700 W)
          const uint4* src = reinterpret_cast<const uint4*>(rowp[t]) + c;
          const uint4 raw = std::is_same<T, float>::value ? __ldg(src) : *src;
          float xv[N];
          unpack16(raw, cc, xv);
#pragma unroll
          for (int e = 0; e < N; ++e) acc[t] = fmaf(qv[e], xv[e], acc[t]);
        }
      }
    }
  } else {
    for (int c = l; c < len; c += LPR) {
      const float qv = qs[c];
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
        if (rowp[t] != nullptr)
          acc[t] = fmaf(qv, row_value(rowp[t][c], col0 + c, cd), acc[t]);
    }
  }
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

// Lanes per row of group_row_dots over a slice of `len` elements: the
// slice's 16-byte groups, 16 or 8, when VEC would leave lanes of a warp
// idle (a dimension block of 128 bf16 values is 16 groups, of 128 codes
// 8), so that one warp scans 32 / LPR rows at once; else the whole warp.
template <typename T>
inline int lanes_per_row(int len, bool vec) {
  const int g = len / Vec16<T>::N;
  return (vec && (g == 16 || g == 8)) ? g : 32;
}

// Row tiles of the register-blocked scan (B1): a 128-row x 16-column
// step of x goes through registers (8 values per thread of 256) into the
// transposed shared tile Xs[16][ld]. f32 rows load one element per thread
// and slot (consecutive threads on consecutive columns). bf16 rows and sq8
// codes load, with VEC, 8 consecutive columns of one row per thread (one
// 16-byte load of bf16, one 8-byte load of codes: ncols a multiple of 8
// and 16-byte aligned rows), else one element as f32 does. col_off is the
// dimension of column 0 (the sq8 codec's index).
constexpr int TILE_THREADS = 256;
constexpr int TILE_BK = 16;

template <typename T, bool VEC>
struct RowTile {
  static constexpr bool kVec = VEC && sizeof(T) < 4;

  __device__ __forceinline__ static void load(const T* __restrict__ x,
                                              int ncols, int row_hi, int r0,
                                              int k0, int col_off, Codec cd,
                                              int tid, float (&px)[8]) {
    if (kVec) {
      const int row = r0 + (tid >> 1), c = k0 + (tid & 1) * 8;
      if (row < row_hi && c < ncols) {
        const T* src = x + (size_t)row * ncols + c;
        if (sizeof(T) == 2) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            px[2 * i] = __uint_as_float(w[i] << 16);
            px[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
          }
        } else {
          const uint2 raw = *reinterpret_cast<const uint2*>(src);
          const unsigned w[2] = {raw.x, raw.y};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            px[i] = sq_decode((float)((w[i >> 2] >> (8 * (i & 3))) & 0xffu),
                              __ldg(cd.scale + col_off + c + i),
                              __ldg(cd.vmin + col_off + c + i));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) px[i] = 0.f;
      }
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = tid + TILE_THREADS * t, rr = e / TILE_BK,
                  kk = e % TILE_BK;
        const int row = r0 + rr, c = k0 + kk;
        px[t] = (row < row_hi && c < ncols)
                    ? row_value(x[(size_t)row * ncols + c], col_off + c, cd)
                    : 0.f;
      }
    }
  }

  __device__ __forceinline__ static void store(float* Xs, int ld, int tid,
                                               const float (&px)[8]) {
    if (kVec) {
      const int rr = tid >> 1, kk0 = (tid & 1) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) Xs[(kk0 + i) * ld + rr] = px[i];
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = tid + TILE_THREADS * t;
        Xs[(e % TILE_BK) * ld + e / TILE_BK] = px[t];
      }
    }
  }
};

}  // namespace dingo
