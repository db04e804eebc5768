// IVF_PQ residual ADC tables, built on the card in one pass.
//
// Replaces dingo_tpu/index/ivf_pq.py::_ivfpq_adc_lut (:195), an XLA program
// with no Pallas kernel: the table that pallas_pq.py's kernel takes as
// lut_all, and that kernel B5 (ivf_pq_adc_topk.cu) reads here.
//   lut[q, r, j, c] = (q_sq - 2 dot) + cb_sq[j, c]
// with s = queries[q] - centroids[probes[q, r]] restricted to subspace j,
// q_sq = sum_t s_t^2, dot = sum_t s_t y_jct and cb_sq[j, c] = sum_t y_jct^2:
// the expression order of _residual_lut_tables, f32 FMAs over dsub in
// column order, no tensor cores (no TF32). A probe outside [0, nlist)
// gives NaN entries (its residual is not formed), which B5 scores as
// invalid rows.
//
// What bounds it on an H100: bytes. The table [b, nprobe, m, ksub] f32 is
// written once (201 MB at b 64, nprobe 32, m 96, ksub 256: 0.060 ms at
// 3.35 TB/s); its inputs (queries, probed centroids, codebooks) are ~3% of
// that, and its 2 * dsub flops an entry a fifth of the write time at the
// f32 rate.
//
// Design: one write of the table and nothing else through HBM (the torch
// composite writes and reads [b * nprobe, m, ksub] tensors several times:
// the product, the expanded form's passes, the permuted copy). A CTA owns
// (query, group of JG subspaces), JG = 256 threads / (ksub / 4): each thread
// owns 4 consecutive codewords of one subspace and keeps them and their
// squared norms in registers for the whole CTA (dsub <= 16; other widths
// read them through L1 at each rank). The residual slices of a chunk of
// ranks are formed in shared memory, and each thread writes one 16-byte
// streaming store per rank, so a warp writes 512 contiguous bytes of a
// [ksub] row.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// residual floats staged per chunk of ranks (32 KB)
constexpr int SRES_FLOATS = 8192;

// three CTAs an SM (<= 80 registers), and streaming stores: each measured
// faster at the serving shape (H100 80GB HBM3, 700 W)
template <int DSUB>   // 0: dsub at run time, codewords re-read at each rank
__global__ void __launch_bounds__(THREADS, 3)
adc_lut_kernel(const float* __restrict__ queries,
               const float* __restrict__ centroids,
               const int* __restrict__ probes,
               const float* __restrict__ codebooks, int d, int nlist,
               int nprobe, int m, int ksub, int dsub, int jg, int rchunk,
               float* __restrict__ lut) {
  extern __shared__ float sres[];                  // [rchunk][jn * dsub]
  const int qi = blockIdx.y, j0 = blockIdx.x * jg;
  const int jn = min(jg, m - j0);
  const int w = jn * dsub;
  const int quads = ksub / 4;
  const int tid = threadIdx.x;
  const int jl = tid / quads, c0 = 4 * (tid % quads);
  const bool active = jl < jn;
  const int j = j0 + jl;
  constexpr int NY = DSUB > 0 ? DSUB : 1;
  const int ds = DSUB > 0 ? DSUB : dsub;

  // this thread's 4 codewords (contiguous: [4, dsub]) and their norms
  const float* cw = codebooks + ((size_t)j * ksub + c0) * ds;
  float y[4][NY];
  float cbsq[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (DSUB > 0) {
#pragma unroll
        for (int t = 0; t < DSUB; ++t) {
          y[i][t] = __ldg(cw + i * DSUB + t);
          cbsq[i] = fmaf(y[i][t], y[i][t], cbsq[i]);
        }
      } else {
        for (int t = 0; t < ds; ++t) {
          const float v = __ldg(cw + i * ds + t);
          cbsq[i] = fmaf(v, v, cbsq[i]);
        }
      }
    }
  }

  const float* qrow = queries + (size_t)qi * d + (size_t)j0 * ds;
  for (int r0 = 0; r0 < nprobe; r0 += rchunk) {
    const int rn = min(rchunk, nprobe - r0);
    __syncthreads();                 // the previous chunk's slices are read
    for (int i = tid; i < rn * w; i += THREADS) {
      const int r = i / w, t = i - r * w;
      const int p = probes[(size_t)qi * nprobe + r0 + r];
      sres[i] = (p >= 0 && p < nlist)
                    ? qrow[t] - centroids[(size_t)p * d + (size_t)j0 * ds + t]
                    : CUDART_NAN_F;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rn; ++r) {
      const float* s = sres + r * w + jl * ds;
      float qsq = 0.f;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (DSUB > 0) {
#pragma unroll
        for (int t = 0; t < DSUB; ++t) {
          const float st = s[t];
          qsq = fmaf(st, st, qsq);
#pragma unroll
          for (int i = 0; i < 4; ++i) dot[i] = fmaf(st, y[i][t], dot[i]);
        }
      } else {
        for (int t = 0; t < ds; ++t) {
          const float st = s[t];
          qsq = fmaf(st, st, qsq);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dot[i] = fmaf(st, __ldg(cw + i * ds + t), dot[i]);
        }
      }
      float4 o;   // (q_sq - 2 dot) + cb_sq; 2 dot is exact, so one FMA
      o.x = __fadd_rn(__fmaf_rn(-2.f, dot[0], qsq), cbsq[0]);
      o.y = __fadd_rn(__fmaf_rn(-2.f, dot[1], qsq), cbsq[1]);
      o.z = __fadd_rn(__fmaf_rn(-2.f, dot[2], qsq), cbsq[2]);
      o.w = __fadd_rn(__fmaf_rn(-2.f, dot[3], qsq), cbsq[3]);
      float* dst =
          lut + (((size_t)qi * nprobe + r0 + r) * m + j) * ksub + c0;
      __stcs(reinterpret_cast<float4*>(dst), o);   // written once, read once
    }
  }
}

template <int DSUB>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st, const float* q,
                   const float* cent, const int* probes, const float* cb,
                   int d, int nlist, int nprobe, int m, int ksub, int dsub,
                   int jg, int rchunk, float* lut) {
  adc_lut_kernel<DSUB><<<grid, THREADS, smem, st>>>(
      q, cent, probes, cb, d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// queries [b, d] f32; centroids [nlist, d] f32; probes [b, nprobe] i32;
// codebooks [m, ksub, dsub] f32 (d = m * dsub; ksub a multiple of 4 up to
// 1024); lut [b, nprobe, m, ksub] f32, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
int dingo_ivfpq_adc_lut(const float* queries, const float* centroids,
                        const int* probes, const float* codebooks, int b,
                        int d, int nlist, int nprobe, int m, int ksub,
                        int dsub, float* lut, void* stream) {
  if (b < 1 || nprobe < 1 || m < 1 || dsub < 1 || d != m * dsub ||
      nlist < 1 || ksub < 4 || ksub % 4 != 0 || ksub / 4 > THREADS)
    return (int)cudaErrorInvalidValue;
  const int jg = THREADS / (ksub / 4);
  const int w = jg * dsub;
  const int rchunk = w >= SRES_FLOATS ? 1 : (nprobe < SRES_FLOATS / w
                                                  ? nprobe
                                                  : SRES_FLOATS / w);
  const size_t smem = sizeof(float) * (size_t)rchunk * w;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((m + jg - 1) / jg, b);
  cudaError_t err;
  switch (dsub) {
    case 1:
      err = launch<1>(grid, smem, st, queries, centroids, probes, codebooks,
                      d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
      break;
    case 2:
      err = launch<2>(grid, smem, st, queries, centroids, probes, codebooks,
                      d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
      break;
    case 4:
      err = launch<4>(grid, smem, st, queries, centroids, probes, codebooks,
                      d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
      break;
    case 8:
      err = launch<8>(grid, smem, st, queries, centroids, probes, codebooks,
                      d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
      break;
    case 16:
      err = launch<16>(grid, smem, st, queries, centroids, probes, codebooks,
                       d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
      break;
    default:
      err = launch<0>(grid, smem, st, queries, centroids, probes, codebooks,
                      d, nlist, nprobe, m, ksub, dsub, jg, rchunk, lut);
  }
  return (int)err;
}

}  // extern "C"
