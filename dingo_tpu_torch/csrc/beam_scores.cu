// Kernel G: candidate scoring of the HNSW beam walk and the graph build.
//
// Replaces no Pallas kernel. It stands for the XLA program
// dingo_tpu/ops/beam.py::_candidate_scores (:55), which gathers the rows of
// every candidate slot into a [b, C, d] array and contracts it with the
// queries: at BASELINE config 4 (d 768, beam 256, level-0 degree 64) a
// search batch of 64 gathers 64 x 16,384 rows a round, 3.2 GB of f32, and a
// 256-row build batch 12.9 GB. Most candidate slots are holes once a walk
// has started (visited, invalid or repeated; beam.py:154-160), and a hole
// needs no row. This kernel reads only the live rows and writes one score
// per (query, candidate slot):
//
//   dot   = sum_t q[t] * row[t]            f32 accumulation
//   L2      -(qsq - 2 dot + sqnorm[slot])
//   COSINE  dot * rsqrt(max(sqnorm[slot], 1e-30))
//   IP      dot
//   hole (slot < 0)  -inf, no read
//
// the formulas of ops/rerank._scores_from_rows. Arms by row type: f32 rows
// (the f32 query); bf16 rows (the query rounded to bf16, products exact in
// f32); uint8 sq8 codes, decoded as code * scale + vmin (a multiply then an
// add, two roundings, as ops/sq.py::sq_decode_device) and rounded to the
// bf16 surrogate, then multiplied like bf16. qsq is |q|^2 of the f32 query,
// computed by the caller as the plain version does.
//
// What bounds it on an H100: bytes. Each live candidate reads its row
// (d * 4 / 2 / 1 bytes by arm) and its norm; the slots and the scores are
// 8 bytes a candidate slot, live or not. The flops (2 d a live candidate)
// are far below the f32 rate.
//
// Design: a CTA owns one query and a tile of TILE candidate slots, with the
// query (and the sq8 codec) in shared memory. One warp per candidate: the
// lanes read the row with 16-byte loads (scalar loads when d or a row's
// address is not 16-byte aligned), reduce across the warp with shuffles,
// and lane 0 applies the metric epilogue. A hole costs the warp one load of
// its slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;   // candidate slots a CTA

enum RowKind { kF32 = 0, kBF16 = 1, kSQ8 = 2 };
enum MetricKind { kL2 = 0, kIP = 1, kCOS = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KIND>
__device__ __forceinline__ float row_dot(const void* rows, int64_t slot,
                                         int d, bool vec_ok, const float* sq,
                                         const float* svmin,
                                         const float* sscale, int lane) {
  float acc = 0.f;
  if constexpr (KIND == kF32) {
    const float* r = static_cast<const float*>(rows) + slot * d;
    if (vec_ok) {
      const float4* r4 = reinterpret_cast<const float4*>(r);
      for (int i = lane; i < d / 4; i += 32) {
        const float4 v = __ldg(r4 + i);
        const float* qq = sq + 4 * i;
        acc = fmaf(qq[0], v.x, acc);
        acc = fmaf(qq[1], v.y, acc);
        acc = fmaf(qq[2], v.z, acc);
        acc = fmaf(qq[3], v.w, acc);
      }
    } else {
      for (int i = lane; i < d; i += 32) acc = fmaf(sq[i], __ldg(r + i), acc);
    }
  } else if constexpr (KIND == kBF16) {
    const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(rows) + slot * d;
    if (vec_ok) {
      const uint4* r4 = reinterpret_cast<const uint4*>(r);
      for (int i = lane; i < d / 8; i += 32) {
        const uint4 v = __ldg(r4 + i);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        const float* qq = sq + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = __uint_as_float(w[j] << 16);
          const float hi = __uint_as_float(w[j] & 0xffff0000u);
          acc = fmaf(qq[2 * j], lo, acc);
          acc = fmaf(qq[2 * j + 1], hi, acc);
        }
      }
    } else {
      for (int i = lane; i < d; i += 32)
        acc = fmaf(sq[i], __bfloat162float(r[i]), acc);
    }
  } else {
    const uint8_t* r = static_cast<const uint8_t*>(rows) + slot * d;
    if (vec_ok) {
      const uint4* r4 = reinterpret_cast<const uint4*>(r);
      for (int i = lane; i < d / 16; i += 32) {
        const uint4 v = __ldg(r4 + i);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int t = 16 * i + j;
          const float code = (float)((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
          const float x = bf16_round(
              __fadd_rn(__fmul_rn(code, sscale[t]), svmin[t]));
          acc = fmaf(sq[t], x, acc);
        }
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float x = bf16_round(
            __fadd_rn(__fmul_rn((float)r[t], sscale[t]), svmin[t]));
        acc = fmaf(sq[t], x, acc);
      }
    }
  }
  return acc;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
beam_scores_kernel(const float* __restrict__ queries,
                   const float* __restrict__ qsq,
                   const void* __restrict__ rows,
                   const float* __restrict__ sqnorm,
                   const int* __restrict__ slots,
                   const float* __restrict__ vmin,
                   const float* __restrict__ scale, int C, int d, int metric,
                   float* __restrict__ out) {
  extern __shared__ float smem[];   // q[d] (+ vmin[d], scale[d] for sq8)
  float* sq = smem;
  float* svmin = smem + d;
  float* sscale = smem + 2 * d;
  const int qi = blockIdx.y;
  const int c0 = blockIdx.x * TILE;
  for (int t = threadIdx.x; t < d; t += THREADS) {
    const float v = queries[(size_t)qi * d + t];
    sq[t] = (KIND == kF32) ? v : bf16_round(v);
    if constexpr (KIND == kSQ8) {
      svmin[t] = vmin[t];
      sscale[t] = scale[t];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vec = KIND == kF32 ? 4 : (KIND == kBF16 ? 8 : 16);
  const bool d_ok = (d % vec) == 0;
  const float q2 = qsq[qi];
  const int cend = min(C, c0 + TILE);
  for (int c = c0 + warp; c < cend; c += WARPS) {
    const size_t o = (size_t)qi * C + c;
    const int slot = __ldg(slots + o);
    if (slot < 0) {
      if (lane == 0) out[o] = -CUDART_INF_F;
      continue;
    }
    const size_t esz = KIND == kF32 ? 4 : (KIND == kBF16 ? 2 : 1);
    const bool vec_ok =
        d_ok && ((reinterpret_cast<uintptr_t>(rows) +
                  (size_t)slot * d * esz) % 16 == 0);
    const float dot = warp_sum(row_dot<KIND>(rows, slot, d, vec_ok, sq,
                                             svmin, sscale, lane));
    if (lane == 0) {
      const float n2 = __ldg(sqnorm + slot);
      float s;
      if (metric == kL2) {
        s = -((q2 - 2.0f * dot) + n2);
      } else if (metric == kCOS) {
        s = dot * rsqrtf(fmaxf(n2, 1e-30f));
      } else {
        s = dot;
      }
      out[o] = s;
    }
  }
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// queries [b, d] f32, qsq [b] f32, rows [cap, d] (kind 0 f32, 1 bf16,
// 2 uint8 sq8 codes), sqnorm [cap] f32, slots [b, C] int32 (-1 = hole),
// vmin/scale [d] f32 (sq8 only), metric 0 L2 / 1 IP / 2 COSINE ->
// out [b, C] f32.
int dingo_beam_scores(const float* queries, const float* qsq,
                      const void* rows, const float* sqnorm, const int* slots,
                      const float* vmin, const float* scale, int kind, int b,
                      int C, int d, int metric, float* out,
                      cudaStream_t stream) {
  if (b <= 0 || C <= 0) return 0;
  const dim3 grid((C + TILE - 1) / TILE, b);
  const size_t shm = (size_t)d * sizeof(float) * (kind == kSQ8 ? 3 : 1);
  if (shm > 48 * 1024) {
    auto set = [&](const void* fn) {
      return cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)shm);
    };
    cudaError_t e = kind == kF32 ? set((const void*)beam_scores_kernel<kF32>)
                    : kind == kBF16
                        ? set((const void*)beam_scores_kernel<kBF16>)
                        : set((const void*)beam_scores_kernel<kSQ8>);
    if (e != cudaSuccess) return (int)e;
  }
  if (kind == kF32) {
    beam_scores_kernel<kF32><<<grid, THREADS, shm, stream>>>(
        queries, qsq, rows, sqnorm, slots, vmin, scale, C, d, metric, out);
  } else if (kind == kBF16) {
    beam_scores_kernel<kBF16><<<grid, THREADS, shm, stream>>>(
        queries, qsq, rows, sqnorm, slots, vmin, scale, C, d, metric, out);
  } else {
    beam_scores_kernel<kSQ8><<<grid, THREADS, shm, stream>>>(
        queries, qsq, rows, sqnorm, slots, vmin, scale, C, d, metric, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
