// Kernel B4: dimension-blocked early-pruning scan over the FLAT store's
// blocked mirror.
//
// Replaces dingo_tpu/ops/pallas_topk.py::pruned_fused_topk (body
// _pruned_fused_kernel) in its three row arms (pallas_topk.py:235-251):
//   f32   rows and query f32;
//   bf16  rows widened exactly to f32, the query rounded to bf16: the
//         bf16 x bf16 products of the TPU's bf16 matmul, each exact in f32,
//         summed by f32 FMAs (only the summation order differs);
//   sq8   uint8 codes decoded per element (code * scale + vmin in f32,
//         rounded to bf16), the query rounded to bf16, f32 accumulation.
// Norms, bounds and stats stay f32 (the store keeps the norms of what the
// arm accumulates). q[b, d] against the mirror
// x_blk[nblk, n, dblk] (block j of row r at x_blk[j, r, :]) with per-block
// norms bsq_blk[nblk, n], total norms xsq[n] and valid[n]: the k best
// "larger is better" scores over valid rows, their slots (-1 where the
// score is -inf), and the four stats lanes of B3 (ivf_pruned_topk.cu has
// the bound math). It never writes a [b, n] score matrix.
//
// What bounds it on an H100: the same 2 b n d f32 FMAs as B1 where nothing
// prunes (operations: 1.54 ms at b = 64, n = 2^20, d = 768 on the 67 TFLOP/s
// f32 peak), cut by the scanned fraction where whole row tiles die, plus
// the mirror bytes of the blocks still read. The bf16 and sq8 arms halve
// and quarter those row bytes and keep the FMAs, so they are further
// inside the operations bound; the sq8 decode adds a multiply, an add and
// a rounding per loaded element (per row tile and step, not per query).
// bf16 rows load 8 values (16 bytes) and codes 8 (8 bytes) per thread and
// tile step where dblk is a multiple of 8 (bf16) or 16 (sq8).
//
// Design: B1's. Each CTA owns a contiguous slot range and a 64-query tile
// and walks its range in 128-row tiles. Per tile it keeps the [64, 128]
// partial dots in the registers of B1's SGEMM tile (4 x 8 outputs per
// thread) across dimension blocks, and the (query, row) alive bits in one
// 32-bit mask per thread. Per block it runs the block's SGEMM over the
// mirror's contiguous [128, dblk] slice (BK = 16 steps through shared
// memory) into the registers, then adds that block dot to the running one,
// which each thread keeps for its outputs in shared memory: a sum of
// block dots, as in the TPU kernel and the plain version (a single
// 768-long FMA chain, as in B1, rounds about 1e-3 away from them at
// |q|^2 ~ 860), at B1's register count. It adds the block norms and
// applies the bounds: warps filter each query's 128 lower
// bounds against its threshold for the in-tile refresh (no sort), then
// every thread clears the bits of its outputs
// whose upper bound is strictly below it. A tile with no alive bit left
// skips its remaining blocks. After the last block the survivors' scores
// go through B1's ballot selection into the per-query running lists, and
// each list's k-th best is published across CTAs (atomicMax on its ordered
// int image). A second pass merges the CTAs' candidates, as in B1.

#include <type_traits>

#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;        // queries per CTA tile
constexpr int BN = 128;       // rows per scan tile
constexpr int BK = 16;        // depth per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 thread grid, 4 x 8 outputs each
constexpr int QS_LD = BQ + 4;
constexpr int XS_LD = BN + 4;
constexpr int S_LD = BN + 1;
constexpr int C_LD = BN + 4;  // running dots, float4-aligned rows
static_assert(THREADS == dingo::TILE_THREADS && BK == dingo::TILE_BK &&
                  BN * BK == 8 * THREADS,
              "the row tile loader's shape");

// One BK step of the query tile; the arms that pair bf16 operands round it.
template <bool ROUND>
__device__ __forceinline__ void load_q(const float* __restrict__ q, int qld,
                                       int ncols, int b, int q0, int k0,
                                       int tid, float (&pq)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = tid + THREADS * t, qq = e / BK, kk = e % BK;
    const int qg = q0 + qq, c = k0 + kk;
    const float v = (qg < b && c < ncols) ? q[(size_t)qg * qld + c] : 0.f;
    pq[t] = ROUND ? dingo::round_bf16(v) : v;
  }
}

__device__ __forceinline__ int row_of(int tr, int j) {
  return (j < 4) ? tr * 4 + j : 64 + tr * 4 + (j - 4);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pruned_scan_kernel(const float* __restrict__ q,
                   const float* __restrict__ qpsq,
                   const T* __restrict__ xb, dingo::Codec codec,
                   const float* __restrict__ bsq,
                   const float* __restrict__ xsq,
                   const unsigned char* __restrict__ valid, int b, int n,
                   int d, int dblk, int k, int ascending, int check_every,
                   int inbucket, int rows_per_split,
                   int* __restrict__ thr_shared, int* __restrict__ stats,
                   float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [BK][QS_LD]
  float* Xs = Qs + BK * QS_LD;              // [BK][XS_LD]
  float* S = Xs + BK * XS_LD;               // [BQ][S_LD]
  float* C = S + BQ * S_LD;                 // [BQ][C_LD] running dots
  float* qsq_s = C + BQ * C_LD;             // [BQ]
  float* qp_s = qsq_s + BQ;                 // [BQ] prefix norm, this block
  float* bnd_s = qp_s + BQ;                 // [BQ] prune threshold
  float* xps_s = bnd_s + BQ;                // [BN] row prefix norms
  float* xsq_s = xps_s + BN;                // [BN] row total norms
  float* topv = xsq_s + BN;                 // [BQ][k]
  int* topi = reinterpret_cast<int*>(topv + BQ * k);    // [BQ][k]
  float* tmpv = reinterpret_cast<float*>(topi + BQ * k);  // [BQ][k]
  int* st = reinterpret_cast<int*>(tmpv + BQ * k);      // [BQ][4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n, row_lo + rows_per_split);
  const int nblk = d / dblk;

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
  for (int c = tid; c < BQ * 4; c += THREADS) st[c] = 0;
  __syncthreads();

  const int tq = tid >> 4;   // query group: queries tq*4 .. tq*4+3
  const int tr = tid & 15;   // row group: rows tr*4.. and 64+tr*4..
  const int nsteps = (dblk + BK - 1) / BK;

  for (int r0 = row_lo; r0 < row_hi; r0 += BN) {
    for (int c = tid; c < BN; c += THREADS) {
      xps_s[c] = 0.f;
      xsq_s[c] = r0 + c < row_hi ? xsq[r0 + c] : 0.f;
    }
    unsigned alive = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + row_of(tr, j);
        if (q0 + tq * 4 + i < b && row < row_hi && valid[row])
          alive |= 1u << (i * 8 + j);
      }
    const int nvalid = __syncthreads_count(
        tid < BN && r0 + tid < row_hi && valid[r0 + tid] != 0);
    if (tid < BQ && q0 + tid < b) {
      st[tid * 4 + 1] += nvalid * nblk;
      st[tid * 4 + 3] += nvalid;
    }

    for (int jb = 0; jb < nblk; ++jb) {
      // alive pairs per query: the 16 threads of a query group share a
      // half-warp, so a shuffle sum and one plain write replace atomics
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int cnt = __popc((alive >> (i * 8)) & 0xffu);
        for (int off = 1; off < 16; off <<= 1)
          cnt += __shfl_xor_sync(dingo::FULL_MASK, cnt, off);
        if (tr == 0) {
          st[(tq * 4 + i) * 4] += cnt;
          if (jb == nblk - 1) st[(tq * 4 + i) * 4 + 2] += cnt;
        }
      }
      if (!__syncthreads_or(alive != 0)) break;   // the tile is all dead
      if (tid < BQ)
        qp_s[tid] = q0 + tid < b ? qpsq[(size_t)(q0 + tid) * nblk + jb]
                                 : 0.f;

      // this block's dots
      constexpr bool kRoundQ = !std::is_same<T, float>::value;
      using Tile = dingo::RowTile<T, VEC>;
      const float* qj = q + (size_t)jb * dblk;
      const T* xj = xb + (size_t)jb * n * dblk;
      const int col_off = jb * dblk;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      float pq[4], px[8];
      load_q<kRoundQ>(qj, d, dblk, b, q0, 0, tid, pq);
      Tile::load(xj, dblk, row_hi, r0, 0, col_off, codec, tid, px);
      for (int s = 0; s < nsteps; ++s) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int e = tid + THREADS * t;
          Qs[(e % BK) * QS_LD + e / BK] = pq[t];
        }
        Tile::store(Xs, XS_LD, tid, px);
        __syncthreads();
        if (s + 1 < nsteps) {
          load_q<kRoundQ>(qj, d, dblk, b, q0, (s + 1) * BK, tid, pq);
          Tile::load(xj, dblk, row_hi, r0, (s + 1) * BK, col_off, codec, tid,
                     px);
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
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
        }
        __syncthreads();
      }
      // running dot += this block's dot; acc holds the running dot below
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* c = reinterpret_cast<float4*>(C + (tq * 4 + i) * C_LD);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (jb > 0) {
            const float4 v = c[h * 16 + tr];
            acc[i][4 * h] += v.x;
            acc[i][4 * h + 1] += v.y;
            acc[i][4 * h + 2] += v.z;
            acc[i][4 * h + 3] += v.w;
          }
          c[h * 16 + tr] = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                       acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      }
      if (tid < BN && r0 + tid < row_hi)
        xps_s[tid] += bsq[(size_t)jb * n + r0 + tid];
      __syncthreads();

      if (jb == nblk - 1) {
        // survivors' final scores -> the running lists (B1's selection)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = tq * 4 + i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int rl = row_of(tr, j);
            float sc = -CUDART_INF_F;
            if (alive & (1u << (i * 8 + j)))
              sc = ascending
                       ? -((qp_s[ql] - 2.0f * acc[i][j]) + xps_s[rl])
                       : acc[i][j];
            S[ql * S_LD + rl] = sc;
          }
        }
        __syncthreads();
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
          if (lane == 0 && lv[k - 1] > -CUDART_INF_F)
            atomicMax(thr_shared + q0 + ql, dingo::ord_of(lv[k - 1]));
        }
        __syncthreads();
      } else if ((jb + 1) % check_every == 0) {
        if (tid < BQ)
          bnd_s[tid] = q0 + tid < b
                           ? fmaxf(topv[tid * k + k - 1],
                                   dingo::float_of(
                                       __ldcg(thr_shared + q0 + tid)))
                           : CUDART_INF_F;
        if (inbucket) {
          // lower bounds of the alive outputs -> S; each warp then keeps
          // its queries' k-th largest where it beats the threshold
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ql = tq * 4 + i;
            const float qtail = fmaxf(qsq_s[ql] - qp_s[ql], 0.f);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int rl = row_of(tr, j);
              S[ql * S_LD + rl] =
                  (alive & (1u << (i * 8 + j)))
                      ? dingo::bounds_of(acc[i][j], xps_s[rl], xsq_s[rl],
                                         qp_s[ql], qtail, ascending).lb
                      : -CUDART_INF_F;
            }
          }
          __syncthreads();
          for (int i = 0; i < BQ / 8; ++i) {
            const int ql = warp * (BQ / 8) + i;
            if (q0 + ql >= b) break;
            float* tv = tmpv + ql * k;
            for (int c = lane; c < k; c += 32) tv[c] = -CUDART_INF_F;
            __syncwarp();
            const float bnd = bnd_s[ql];
            float t = bnd;
#pragma unroll
            for (int j = 0; j < BN / 32; ++j) {
              const float lb = S[ql * S_LD + j * 32 + lane];
              unsigned mask = __ballot_sync(dingo::FULL_MASK, lb > t);
              while (mask) {
                const int src = __ffs(mask) - 1;
                dingo::warp_insert(tv, nullptr, k,
                                   __shfl_sync(dingo::FULL_MASK, lb, src), -1);
                t = fmaxf(bnd, tv[k - 1]);
                mask &= ~(1u << src);
                mask &= __ballot_sync(dingo::FULL_MASK, lb > t);
              }
            }
            if (lane == 0) bnd_s[ql] = fmaxf(bnd, tv[k - 1]);
          }
        }
        __syncthreads();
        // prune: clear outputs whose upper bound is strictly below
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = tq * 4 + i;
          const float qtail = fmaxf(qsq_s[ql] - qp_s[ql], 0.f);
          const float bnd = bnd_s[ql];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int rl = row_of(tr, j);
            if (dingo::bounds_of(acc[i][j], xps_s[rl], xsq_s[rl], qp_s[ql],
                                 qtail, ascending).ub < bnd)
              alive &= ~(1u << (i * 8 + j));
          }
        }
      }
    }
    __syncthreads();
  }

  // this CTA's candidates: cand[q][split][0..k), and its stats
  for (int i = 0; i < BQ / 8; ++i) {
    const int ql = warp * (BQ / 8) + i, qg = q0 + ql;
    if (qg >= b) break;
    const size_t base = ((size_t)qg * nsplit + split) * k;
    for (int c = lane; c < k; c += 32) {
      cand_v[base + c] = topv[ql * k + c];
      cand_i[base + c] = topi[ql * k + c];
    }
    if (lane < 4) atomicAdd(stats + (size_t)qg * 4 + lane, st[ql * 4 + lane]);
  }
}

size_t scan_smem_bytes(int k) {
  return sizeof(float) * (BK * QS_LD + BK * XS_LD + BQ * S_LD + BQ * C_LD +
                          3 * BQ + 2 * BN) +
         (2 * sizeof(float) + sizeof(int)) * (size_t)BQ * k +
         sizeof(int) * BQ * 4;
}

template <typename T>
int launch(const float* q, const float* qpsq, const T* x_blk,
           dingo::Codec codec, const float* bsq_blk, const float* xsq,
           const unsigned char* valid, int b, int n, int d, int dblk, int k,
           int ascending, int check_every, int inbucket, int rows_per_split,
           int vec, int* thr_shared, int* stats, float* cand_v, int* cand_i,
           float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > dingo::K_MAX || rows_per_split % BN != 0 || n < 1 ||
      b < 1 || dblk < 1 || d % dblk != 0 || check_every < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = scan_smem_bytes(k);
  auto kernel =
      vec ? pruned_scan_kernel<T, true> : pruned_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (n + rows_per_split - 1) / rows_per_split;
  dim3 grid(nsplit, (b + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, st>>>(
      q, qpsq, x_blk, codec, bsq_blk, xsq, valid, b, n, d, dblk, k,
      ascending, check_every, inbucket, rows_per_split, thr_shared, stats,
      cand_v, cand_i);
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

// q[b, d] f32; qpsq[b, nblk] f32 inclusive per-block prefix norms (of the
// f32 query); x_blk[nblk, n, dblk] f32, bf16 (_bf16) or uint8 codes with
// vmin/scale [d] f32 (_sq8); bsq_blk[nblk, n] f32; xsq[n] f32; valid[n]
// bytes. thr_shared[b] i32 holds ord_of(-inf) on entry; stats[b, 4] i32
// zeros. cand_v/cand_i: [b, nsplit, k] scratch, nsplit = ceil(n /
// rows_per_split); out_v/out_i: [b, k]. vec (bf16, sq8) = dblk a multiple
// of 8 (bf16) or 16 (sq8) and a 16-byte aligned mirror. Returns
// cudaGetLastError() after both launches.
#define DINGO_B4_ARGS                                                       \
  const float *q, const float *qpsq, const float *bsq_blk,                 \
      const float *xsq, const unsigned char *valid, int b, int n, int d,   \
      int dblk, int k, int ascending, int check_every, int inbucket,       \
      int rows_per_split, int vec, int *thr_shared, int *stats,            \
      float *cand_v, int *cand_i, float *out_v, int *out_i, void *stream
#define DINGO_B4_PASS(x_blk, codec)                                         \
  launch(q, qpsq, x_blk, codec, bsq_blk, xsq, valid, b, n, d, dblk, k,     \
         ascending, check_every, inbucket, rows_per_split, vec, thr_shared, \
         stats, cand_v, cand_i, out_v, out_i, stream)

int dingo_pruned_fused_topk(const float* x_blk, DINGO_B4_ARGS) {
  return DINGO_B4_PASS(x_blk, (dingo::Codec{nullptr, nullptr}));
}

int dingo_pruned_fused_topk_bf16(const __nv_bfloat16* x_blk,
                                 DINGO_B4_ARGS) {
  return DINGO_B4_PASS(x_blk, (dingo::Codec{nullptr, nullptr}));
}

int dingo_pruned_fused_topk_sq8(const uint8_t* x_blk, const float* vmin,
                                const float* scale, DINGO_B4_ARGS) {
  return DINGO_B4_PASS(x_blk, (dingo::Codec{vmin, scale}));
}

}  // extern "C"
