// Kernel B1: fused distance + running top-k over a whole slot store.
//
// Replaces dingo_tpu/ops/pallas_topk.py::fused_topk (body _fused_kernel) in
// both of its row arms: f32 rows, and bf16 rows widened exactly to f32 as
// they load (pallas_topk.py:67; the query stays f32, f32 products).
// Computes, for q[b, d] against x[n, d], the k best "larger is
// better" scores (L2: -(||q||^2 - 2 q.x + ||x||^2); IP: q.x) over rows whose
// valid byte is set, and their slots (-1 where the score is -inf). It never
// writes a [b, n] score matrix.
//
// What bounds it on an H100: at the serving shape (b = 64, n = 2^20,
// d = 768) the 2.b.n.d = 103 GFLOP of f32 FMA take 1.54 ms at the 67 TFLOP/s
// f32 (non tensor core) peak, while the 3.2 GB of rows take 0.96 ms at
// 3.35 TB/s: operations bound it. The fp32 tier must stay true fp32
// (the JAX package pins Precision.HIGHEST), so TF32 tensor cores are out.
// The bf16 arm halves the row bytes (1.6 GB, 0.48 ms) and keeps the same
// f32 FMAs, so it is further inside the operations bound; its rows load as
// 8 bf16 values (16 bytes) per thread and tile step where d is a multiple
// of 8.
//
// Design: the TPU streams blocks through one core in order and carries the
// running best from grid step to step. Hopper runs blocks in parallel, so
// n is split across CTAs instead. Each CTA owns a contiguous slot range
// and one 64-query tile, keeps a per-query running top-k in shared memory,
// and walks its range in 128-row tiles: a register-blocked SGEMM
// (64 x 128 tile, BK = 16 through shared memory, 4 x 8 outputs per thread,
// next tile's loads issued before the current tile's FMAs) fills a score
// tile in shared memory, then each warp filters its 8 queries' 128 scores
// against the running k-th best with ballots and inserts the few that
// pass. Each CTA writes its k candidates per query to [b, nsplit, k]; a
// second small kernel merges them to [b, k]. wgmma/TMA are later work.

#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;        // queries per CTA tile
constexpr int BN = 128;       // rows per scan tile
constexpr int BK = 16;        // depth per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 thread grid, 4 x 8 outputs each
constexpr int QS_LD = BQ + 4; // padded leading dims (float4-aligned)
constexpr int XS_LD = BN + 4;
constexpr int S_LD = BN + 1;
static_assert(THREADS == dingo::TILE_THREADS && BK == dingo::TILE_BK &&
                  BN * BK == 8 * THREADS,
              "the row tile loader's shape");

__device__ __forceinline__ void load_q(const float* __restrict__ q, int b,
                                       int d, int q0, int k0, int tid,
                                       float (&pq)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = tid + THREADS * t, qq = e / BK, kk = e % BK;
    const int qg = q0 + qq, c = k0 + kk;
    pq[t] = (qg < b && c < d) ? q[(size_t)qg * d + c] : 0.f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_scan_kernel(const float* __restrict__ q, const T* __restrict__ x,
                  const float* __restrict__ xsq,
                  const unsigned char* __restrict__ valid, int b, int n,
                  int d, int k, int ascending, int rows_per_split,
                  float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [BK][QS_LD]
  float* Xs = Qs + BK * QS_LD;              // [BK][XS_LD]
  float* S = Xs + BK * XS_LD;               // [BQ][S_LD]
  float* qsq_s = S + BQ * S_LD;             // [BQ]
  float* topv = qsq_s + BQ;                 // [BQ][k]
  int* topi = reinterpret_cast<int*>(topv + BQ * k);  // [BQ][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n, row_lo + rows_per_split);

  // prologue: ||q||^2 of this tile's queries, empty running lists
  for (int i = 0; i < BQ / 8; ++i) {
    const int ql = warp * (BQ / 8) + i, qg = q0 + ql;
    float s = 0.f;
    if (qg < b)
      for (int c = lane; c < d; c += 32) {
        const float v = q[(size_t)qg * d + c];
        s = fmaf(v, v, s);
      }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
    if (lane == 0) qsq_s[ql] = s;
    dingo::list_init(topv + ql * k, topi + ql * k, k);
  }
  __syncthreads();

  const int tq = tid >> 4;   // query group: queries tq*4 .. tq*4+3
  const int tr = tid & 15;   // row group: rows tr*4.. and 64+tr*4..
  const int nsteps = (d + BK - 1) / BK;

  for (int r0 = row_lo; r0 < row_hi; r0 += BN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // register staging of the next BK step: 4 query and 8 row elements
    using Tile = dingo::RowTile<T, VEC>;
    const dingo::Codec none{nullptr, nullptr};
    float pq[4], px[8];
    load_q(q, b, d, q0, 0, tid, pq);
    Tile::load(x, d, row_hi, r0, 0, 0, none, tid, px);
    for (int s = 0; s < nsteps; ++s) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = tid + THREADS * t;
        Qs[(e % BK) * QS_LD + e / BK] = pq[t];
      }
      Tile::store(Xs, XS_LD, tid, px);
      __syncthreads();
      if (s + 1 < nsteps) {
        load_q(q, b, d, q0, (s + 1) * BK, tid, pq);
        Tile::load(x, d, row_hi, r0, (s + 1) * BK, 0, none, tid, px);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            Qs + kk * QS_LD + tq * 4);
        const float4 x0 = *reinterpret_cast<const float4*>(
            Xs + kk * XS_LD + tr * 4);
        const float4 x1 = *reinterpret_cast<const float4*>(
            Xs + kk * XS_LD + 64 + tr * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // scores of this tile into shared memory (-inf for masked/out of range)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = tq * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rl = (j < 4) ? tr * 4 + j : 64 + tr * 4 + (j - 4);
        const int row = r0 + rl;
        float sc = -CUDART_INF_F;
        if (row < row_hi && valid[row]) {
          sc = ascending ? -((qsq_s[ql] - 2.0f * acc[i][j]) + xsq[row])
                         : acc[i][j];
        }
        S[ql * S_LD + rl] = sc;
      }
    }
    __syncthreads();

    // selection: warp w owns queries w*8 .. w*8+7 of the tile
    for (int i = 0; i < BQ / 8; ++i) {
      const int ql = warp * (BQ / 8) + i;
      if (q0 + ql >= b) break;
      float* lv = topv + ql * k;
      int* li = topi + ql * k;
      float thr = lv[k - 1];
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const float sc = S[ql * S_LD + j * 32 + lane];
        unsigned mask = __ballot_sync(dingo::FULL_MASK, sc > thr);
        while (mask) {
          const int src = __ffs(mask) - 1;
          const float v = __shfl_sync(dingo::FULL_MASK, sc, src);
          dingo::warp_insert(lv, li, k, v, r0 + j * 32 + src);
          thr = lv[k - 1];
          mask &= ~(1u << src);
          mask &= __ballot_sync(dingo::FULL_MASK, sc > thr);
        }
      }
    }
    __syncthreads();
  }

  // this CTA's candidates: cand[q][split][0..k)
  for (int i = 0; i < BQ / 8; ++i) {
    const int ql = warp * (BQ / 8) + i, qg = q0 + ql;
    if (qg >= b) break;
    const size_t base = ((size_t)qg * nsplit + split) * k;
    for (int c = lane; c < k; c += 32) {
      cand_v[base + c] = topv[ql * k + c];
      cand_i[base + c] = topi[ql * k + c];
    }
  }
}

size_t scan_smem_bytes(int k) {
  return sizeof(float) * (BK * QS_LD + BK * XS_LD + BQ * S_LD + BQ) +
         (sizeof(float) + sizeof(int)) * (size_t)BQ * k;
}

template <typename T>
int launch(const float* q, const T* x, const float* xsq,
           const unsigned char* valid, int b, int n, int d, int k,
           int ascending, int rows_per_split, int vec, float* cand_v,
           int* cand_i, float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > dingo::K_MAX || rows_per_split % BN != 0 || n < 1 ||
      b < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = scan_smem_bytes(k);
  auto kernel = vec ? fused_scan_kernel<T, true> : fused_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (n + rows_per_split - 1) / rows_per_split;
  dim3 grid(nsplit, (b + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, st>>>(q, x, xsq, valid, b, n, d, k, ascending,
                                      rows_per_split, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<b, 256, 0, st>>>(cand_v, cand_i,
                                                  nsplit * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q[b,d] f32; x[n,d] f32 (dingo_fused_topk) or bf16 (dingo_fused_topk_bf16);
// xsq[n] f32; valid[n] bytes (nonzero = live). cand_v/cand_i: [b, nsplit,
// k] scratch, nsplit = ceil(n / rows_per_split); out_v/out_i: [b, k].
// vec (bf16 only) = d a multiple of 8 and 16-byte aligned rows. Returns
// cudaGetLastError() after both launches.
int dingo_fused_topk(const float* q, const float* x, const float* xsq,
                     const unsigned char* valid, int b, int n, int d, int k,
                     int ascending, int rows_per_split, int vec,
                     float* cand_v, int* cand_i, float* out_v, int* out_i,
                     void* stream) {
  return launch(q, x, xsq, valid, b, n, d, k, ascending, rows_per_split, vec,
                cand_v, cand_i, out_v, out_i, stream);
}

int dingo_fused_topk_bf16(const float* q, const __nv_bfloat16* x,
                          const float* xsq, const unsigned char* valid, int b,
                          int n, int d, int k, int ascending,
                          int rows_per_split, int vec, float* cand_v,
                          int* cand_i, float* out_v, int* out_i,
                          void* stream) {
  return launch(q, x, xsq, valid, b, n, d, k, ascending, rows_per_split, vec,
                cand_v, cand_i, out_v, out_i, stream);
}

}  // extern "C"
