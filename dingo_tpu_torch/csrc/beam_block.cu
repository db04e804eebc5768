// Kernel G, block arm: candidate scoring of the HNSW beam walk and the
// graph build, each distinct candidate row of a query block read once and
// scored against the block's queries on the tensor cores.
//
// Replaces no Pallas kernel. Like beam_scores.cu (the per-pair arm) it
// stands for the XLA program dingo_tpu/ops/beam.py::_candidate_scores
// (:55) and computes what that arm computes, with the formulas of
// ops/rerank._scores_from_rows:
//
//   L2      -(qsq - 2 dot + sqnorm[slot])
//   COSINE  dot * rsqrt(max(sqnorm[slot], 1e-30))
//   IP      dot
//   hole (slot < 0)  -inf, no read
//
// Arms by row type: f32 rows against the f32 query (3xTF32, below); bf16
// rows against the query rounded to bf16; uint8 sq8 codes decoded as
// code * scale + vmin (a multiply then an add, two roundings) and rounded
// to the bf16 surrogate, then as bf16. bf16 x bf16 products are exact in
// f32.
//
// What bounds it on an H100: bytes. The queries of one walk start from
// one entry point and their candidate sets overlap, so a launch's live
// slots name far fewer distinct rows than pairs (64 x 16,384 slots of a
// 1M-row search: 523,522 live, 47,730 distinct rows, 11.0x fewer bytes).
// The per-pair arm reads a row for every live pair. This arm reads each
// distinct row of a 64-query block once (ops/kernel_beam.py sends it the
// launches of two or more blocks: the build walk's rounds):
//   1. claim_kernel maps each live slot's row to a compact index of its
//      block: the first slot to reach a row marks it in a [blocks, cap]
//      map (atomicCAS), a CTA's winners take consecutive indices after one
//      atomicAdd on the block's count, and the row list [blocks, dcap]
//      holds the row of each index. The count stays on the device. The
//      scratch outlives a launch: a map entry carries the epoch of the
//      launch that wrote it (an entry of another epoch is free), and the
//      scatter sets the counts back to -1 for the next launch, so a launch
//      clears nothing first.
//   2. product_kernel: one persistent CTA an SM walks the tiles of BN =
//      128 distinct rows of every block (the counts read on the device).
//      All 256 threads gather the tile's rows, 256 bytes of a row a stage
//      (128 for sq8 codes; cp.async, 16 bytes a thread, zeros past the
//      count and past d), into a ring in the 128-byte swizzle, with the
//      block's queries' same columns: each stage holds two boxes of
//      columns, one for each warpgroup. Each warpgroup multiplies the 64
//      queries (A, from registers, M = 64) by the 128 rows (B, N = 128) on
//      its box with wgmma (wgmma.cuh, as B1), so a stage reads twice the
//      bytes of a row at once and a tile is half B1's; at the tile's end
//      the second warpgroup's totals are added to the first's. f32 rows:
//      3xTF32 (split_mma.cuh), each warpgroup splitting its box in place
//      to hi = rna(x) and lo = x - hi; sq8: each warpgroup decodes its
//      half of the codes once into a bf16 plane. Each pair of k steps sums
//      from zero into a partial that is added to an f32 total (the tensor
//      cores truncate as they accumulate). A tile's dots go to a dense
//      [blocks, 64, dcap] f32 buffer.
//   3. scatter_kernel writes each slot's score: the dot of its query and
//      its row's index, then the metric's epilogue.
// A dot depends only on its query and its row: not on the index the claim
// gave the row nor on the rows beside it in the tile, so two launches of
// the same input give the same bits whatever order the claims took.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "split_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;          // queries of a block (wgmma M)
constexpr int BN = 128;         // distinct rows of a tile (wgmma N)
constexpr int NT = dingo::WG_N8;
constexpr int THREADS = 256;    // two warpgroups; every thread also loads
constexpr int BOX = BN * 128;   // one box: 128 rows x 128 bytes, swizzled
constexpr int MAX_BLOCKS = 64;  // query blocks of a launch (b <= 4,096)
constexpr int CLAIM_THREADS = 256;
constexpr int CLAIM_SPT = 8;    // slots a claim thread takes
constexpr int CLAIM_SLOTS = CLAIM_SPT * CLAIM_THREADS;

enum RowKind { kF32 = 0, kBF16 = 1, kSQ8 = 2 };
enum MetricKind { kL2 = 0, kIP = 1, kCOS = 2 };

// Per arm: BK columns a stage (two boxes, one a warpgroup); RB bytes of a
// row a stage; QBOX f32 query boxes of 32 columns a stage; ROWB bytes of
// a stage's rows (two swizzled boxes, or the raw sq8 codes); PLANE bytes
// of the warpgroups' planes (the f32 lo parts, the sq8 decode); NSTAGE
// ring stages (as many as the shared memory holds).
template <int KIND>
struct Arm;
template <>
struct Arm<kF32> {
  static constexpr int BK = 64, RB = 256, QBOX = 2, ROWB = 2 * BOX,
                       PLANE = 2 * BOX, NSTAGE = 4, ESIZE = 4;
};
template <>
struct Arm<kBF16> {
  static constexpr int BK = 128, RB = 256, QBOX = 4, ROWB = 2 * BOX,
                       PLANE = 0, NSTAGE = 3, ESIZE = 2;
};
template <>
struct Arm<kSQ8> {
  static constexpr int BK = 128, RB = 128, QBOX = 4, ROWB = BN * 128,
                       PLANE = 2 * BOX, NSTAGE = 3, ESIZE = 1;
};

template <int KIND>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return Arm<KIND>::ROWB + Arm<KIND>::QBOX * BQ * 128;
}

template <int KIND>
size_t product_smem(int d) {
  return 1024 + (size_t)Arm<KIND>::NSTAGE * stage_bytes<KIND>() +
         Arm<KIND>::PLANE +
         (KIND == kSQ8 ? 2 * sizeof(float) * (size_t)d : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   dingo::smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- 1. claim ----------------------------------------------------------------
// grid (ceil(C / CLAIM_SLOTS), b): a CTA takes up to CLAIM_SLOTS slots of
// one query row, so all of its slots are in one block. A map [blocks,
// cap] entry is epoch << 32 | state: of another epoch, free; of this
// launch's, CLAIMED or the row's index. cnt [blocks] is -1 at the start;
// a block holds cnt + 1 distinct rows.
constexpr unsigned long long CLAIMED = 0xfffffffeull;

__global__ void __launch_bounds__(CLAIM_THREADS)
claim_kernel(const int* __restrict__ slots, int C, long long cap, int dcap,
             unsigned long long epoch, unsigned long long* __restrict__ map,
             int* __restrict__ cnt, int* __restrict__ rows) {
  const int q = blockIdx.y, blk = q / BQ;
  const int c0 = blockIdx.x * CLAIM_SLOTS;
  const int cend = min(C, c0 + CLAIM_SLOTS);
  const int* qs = slots + (size_t)q * C;
  unsigned long long* bmap = map + (size_t)blk * cap;
  const unsigned long long tag = epoch << 32;
  int r[CLAIM_SPT];
#pragma unroll
  for (int i = 0; i < CLAIM_SPT; ++i) {
    const int c = c0 + threadIdx.x + i * CLAIM_THREADS;
    r[i] = c < cend ? __ldg(qs + c) : -1;
  }
  uint32_t won = 0;
  int n = 0;
  // a row already claimed (most repeats) is seen by a plain read from L2
  // and takes no atomic; a stale read only costs a CAS that fails
#pragma unroll
  for (int i = 0; i < CLAIM_SPT; ++i) {
    if (r[i] < 0) continue;
    const unsigned long long seen = __ldcg(bmap + r[i]);
    if ((seen >> 32) != epoch &&
        atomicCAS(bmap + r[i], seen, tag | CLAIMED) == seen) {
      won |= 1u << i;
      ++n;
    }
  }
  // the CTA's winners in thread order: an exclusive prefix, one atomicAdd
  __shared__ int wsum[CLAIM_THREADS / 32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < CLAIM_THREADS / 32; ++w) {
      const int v = wsum[w];
      wsum[w] = tot;
      tot += v;
    }
    base = tot ? atomicAdd(cnt + blk, tot) + 1 : 0;
  }
  __syncthreads();
  int u = base + wsum[warp] + x - n;
#pragma unroll
  for (int i = 0; i < CLAIM_SPT; ++i)
    if (won & (1u << i)) {
      bmap[r[i]] = tag | (unsigned)u;
      rows[(size_t)blk * dcap + u] = r[i];
      ++u;
    }
}

// -- 2. the product over distinct rows -------------------------------------
struct BlockArgs {
  const float* q;        // [b, d]
  const void* x;         // [cap, d] rows
  const float* vmin;     // [d] (sq8)
  const float* scale;    // [d] (sq8)
  const int* rows;       // [blocks, dcap] row of each index
  const int* cnt;        // [blocks] distinct rows - 1
  float* dots;           // [blocks, BQ, dcap]
  int b, d, nblk, dcap, nchunks;
};

// Tile t of the launch (tiles of every block, block by block) -> block,
// first row index.
__device__ __forceinline__ void locate(int t, const int* scount, int nblk,
                                       int& blk, int& u0) {
  blk = 0;
  u0 = 0;
  for (int i = 0; i < nblk; ++i) {
    const int nt = (scount[i] + BN - 1) / BN;
    if (t < nt) {
      blk = i;
      u0 = t * BN;
      return;
    }
    t -= nt;
  }
}

// One ring stage's copies: the tile's rows at columns [ch BK, + BK) and
// the block's queries at the same columns. Each thread copies 16-byte
// pieces of fixed rows (rid, reloaded at a new tile) and one piece column.
template <int KIND>
__device__ __forceinline__ void load_stage(const BlockArgs& a,
                                           unsigned char* st, int blk,
                                           int ch, const int (&rid)[8],
                                           int tid) {
  constexpr int BK = Arm<KIND>::BK, ES = Arm<KIND>::ESIZE;
  constexpr int PER_ROW = Arm<KIND>::RB / 16;     // pieces of a row
  constexpr int ROWS_A_PASS = THREADS / PER_ROW;
  constexpr int NR = BN / ROWS_A_PASS;            // rows of a thread
  const int pc = tid % PER_ROW;
  const int col = ch * BK + pc * (16 / ES);       // first column of piece
  const bool col_ok = col < a.d;
  const unsigned char* xb = static_cast<const unsigned char*>(a.x);
  // a piece's place: the raw codes row by row, or box pc / 8 swizzled
  const int pbox = KIND == kSQ8 ? 0 : (pc >> 3) * BOX;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = tid / PER_ROW + i * ROWS_A_PASS;
    const bool ok = col_ok && rid[i] >= 0;
    const void* src =
        ok ? xb + ((size_t)rid[i] * a.d + col) * ES : a.x;
    void* dst = KIND == kSQ8 ? st + r * 128 + pc * 16
                             : st + pbox + dingo::sw128(r, (pc & 7) * 16);
    cp_async16(dst, src, ok);
  }
  // queries: QBOX boxes [BQ][32 columns] f32, 8 pieces a query row
  unsigned char* qs = st + Arm<KIND>::ROWB;
  const int qp = tid & 7;
#pragma unroll
  for (int i = 0; i < 2 * Arm<KIND>::QBOX; ++i) {
    const int qr = (tid >> 3) + 32 * (i & 1), bx = i >> 1;
    const int qg = blk * BQ + qr;
    const int qc = ch * BK + bx * 32 + qp * 4;
    const bool ok = qg < a.b && qc < a.d;
    const void* src = ok ? a.q + (size_t)qg * a.d + qc : a.q;
    cp_async16(qs + bx * BQ * 128 + dingo::sw128(qr, qp * 16), src, ok);
  }
}

// The row ids this thread copies in a tile (-1 past the block's count).
template <int KIND>
__device__ __forceinline__ void tile_rows(const BlockArgs& a, int blk,
                                          int u0, int count, int tid,
                                          int (&rid)[8]) {
  constexpr int PER_ROW = Arm<KIND>::RB / 16;
  constexpr int ROWS_A_PASS = THREADS / PER_ROW;
  constexpr int NR = BN / ROWS_A_PASS;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = u0 + tid / PER_ROW + i * ROWS_A_PASS;
    rid[i] = (i < NR && u < count)
                 ? __ldg(a.rows + (size_t)blk * a.dcap + u)
                 : -1;
  }
}

// f32 rows, a warpgroup's box of one stage (32 columns): split in place to
// hi and into the lo plane, then two partials of two k8 steps each,
// 3xTF32 (q_hi x_lo + q_lo x_hi + q_hi x_hi, the small terms first).
__device__ __forceinline__ void stage_dots_f32(float* xw, const float* qs,
                                               float* lw, int mt, int wq,
                                               int g, int t,
                                               float (&p)[NT][4],
                                               float (&acc)[NT][4]) {
  float4* xv = reinterpret_cast<float4*>(xw);
  float4* lv = reinterpret_cast<float4*>(lw);
#pragma unroll 4
  for (int i = threadIdx.x & 127; i < BN * 32 / 4; i += 128) {
    const float4 v = xv[i];
    const float4 h = make_float4(__uint_as_float(dingo::tf32_rna(v.x)),
                                 __uint_as_float(dingo::tf32_rna(v.y)),
                                 __uint_as_float(dingo::tf32_rna(v.z)),
                                 __uint_as_float(dingo::tf32_rna(v.w)));
    xv[i] = h;
    lv[i] = make_float4(__fsub_rn(v.x, h.x), __fsub_rn(v.y, h.y),
                        __fsub_rn(v.z, h.z), __fsub_rn(v.w, h.w));
  }
  fence_async_shared();
  dingo::bar_sync(1 + wq, 128);
  const float* qr = qs + (mt * 16 + g) * 32 + t;
  const uint64_t dx = dingo::sw128_desc(xw), dl = dingo::sw128_desc(lw);
#pragma unroll
  for (int s0 = 0; s0 < 4; s0 += 2) {
    uint32_t qh[2][4], ql[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u;
      const int c0 = (((2 * s) ^ g) & 7) << 2;
      const int c1 = (((2 * s + 1) ^ g) & 7) << 2;
      dingo::split_tf32(qr[c0], qh[u][0], ql[u][0]);
      dingo::split_tf32(qr[8 * 32 + c0], qh[u][1], ql[u][1]);
      dingo::split_tf32(qr[c1], qh[u][2], ql[u][2]);
      dingo::split_tf32(qr[8 * 32 + c1], qh[u][3], ql[u][3]);
    }
    dingo::fence_regs(p);
    dingo::wg_fence();
    dingo::wgmma_tf32(p, qh[0], dl + 2 * s0, 0);
    dingo::wgmma_tf32(p, qh[1], dl + 2 * (s0 + 1), 1);
    dingo::wgmma_tf32(p, ql[0], dx + 2 * s0, 1);
    dingo::wgmma_tf32(p, ql[1], dx + 2 * (s0 + 1), 1);
    dingo::wgmma_tf32(p, qh[0], dx + 2 * s0, 1);
    dingo::wgmma_tf32(p, qh[1], dx + 2 * (s0 + 1), 1);
    dingo::wg_commit_wait();
    dingo::fence_regs(p);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
  }
}

// sq8 codes, a warpgroup's half of one stage: the 64 codes of each of the
// tile's rows at columns c0 .. + 63 (raw rows 128 bytes apart) decoded to
// bf16 (code * scale + vmin, two roundings, then bf16; zero past d) into
// the warpgroup's plane in the 128-byte swizzle.
__device__ __forceinline__ void decode_stage(const unsigned char* rw,
                                             unsigned char* pw, int wq,
                                             int c0, int d,
                                             const float* svmin,
                                             const float* sscale) {
#pragma unroll 2
  for (int e = threadIdx.x & 127; e < BN * 8; e += 128) {
    const int r = e >> 3, oc = e & 7;
    const uint2 c8 = *reinterpret_cast<const uint2*>(rw + r * 128 + oc * 8);
    const int cb = c0 + oc * 8;
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float v[2];
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int j = 2 * h + z, c = cb + j;
        const uint32_t word = j < 4 ? c8.x : c8.y;
        const float code = (float)((word >> (8 * (j & 3))) & 0xffu);
        v[z] = c < d ? __fadd_rn(__fmul_rn(code, sscale[c]), svmin[c])
                     : 0.f;
      }
      w[h] = dingo::bf16x2_bits(__floats2bfloat162_rn(v[0], v[1]));
    }
    *reinterpret_cast<uint4*>(pw + dingo::sw128(r, oc * 16)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_async_shared();
  dingo::bar_sync(1 + wq, 128);
}

// bf16 rows (or an sq8 plane), a warpgroup's box of one stage (64
// columns): the query rounded to bf16 (A) against the rows (B); two
// partials of two k16 steps each.
__device__ __forceinline__ void stage_dots_bf16(const unsigned char* xw,
                                                const float* qs, int mt,
                                                int g, int t,
                                                float (&p)[NT][4],
                                                float (&acc)[NT][4]) {
  // the queries' columns kk + 2t, + 1 in their f32 box of 32 columns
  const float* qr = qs + (mt * 16 + g) * 32 + 2 * (t & 1);
  const uint64_t dx = dingo::sw128_desc(xw);
#pragma unroll
  for (int s0 = 0; s0 < 4; s0 += 2) {
    uint32_t a1[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kk = 16 * (s0 + u);
      const float* qb = qr + (kk >> 5) * (BQ * 32);
      const int kc = (kk & 31) >> 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // rows (+0 | +8) x columns (+0 | +8)
        const int ch = ((kc + (t >> 1) + (i >> 1) * 2) ^ g) & 7;
        const float2 v = *reinterpret_cast<const float2*>(
            qb + (i & 1) * 8 * 32 + ch * 4);
        a1[u][i] = dingo::bf16x2_bits(__floats2bfloat162_rn(v.x, v.y));
      }
    }
    dingo::fence_regs(p);
    dingo::wg_fence();
    dingo::wgmma_bf16(p, a1[0], dx + 2 * s0, 0);
    dingo::wgmma_bf16(p, a1[1], dx + 2 * (s0 + 1), 1);
    dingo::wg_commit_wait();
    dingo::fence_regs(p);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
product_kernel(const BlockArgs a) {
  constexpr uint32_t SB = stage_bytes<KIND>();
  constexpr int NSTAGE = Arm<KIND>::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (dingo::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* plane = ring + (size_t)NSTAGE * SB;
  float* svmin = reinterpret_cast<float*>(plane + Arm<KIND>::PLANE);
  float* sscale = svmin + a.d;
  __shared__ int scount[MAX_BLOCKS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < a.nblk; i += THREADS) scount[i] = a.cnt[i] + 1;
  if constexpr (KIND == kSQ8)
    for (int i = tid; i < a.d; i += THREADS) {
      svmin[i] = a.vmin[i];
      sscale[i] = a.scale[i];
    }
  __syncthreads();
  int ntiles = 0;
  for (int i = 0; i < a.nblk; ++i) ntiles += (scount[i] + BN - 1) / BN;
  // this CTA's tiles: blockIdx.x + k gridDim.x, k < mine
  const int mine = blockIdx.x < ntiles
                       ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int total = mine * a.nchunks;

  // the loader's tile and its rows
  int lk = -1, lblk = 0, lu0 = 0;
  int rid[8];
  auto load = [&](int j) {
    const int k = j / a.nchunks, ch = j - k * a.nchunks;
    if (k != lk) {
      lk = k;
      locate(blockIdx.x + k * gridDim.x, scount, a.nblk, lblk, lu0);
      tile_rows<KIND>(a, lblk, lu0, scount[lblk], tid, rid);
    }
    load_stage<KIND>(a, ring + (size_t)(j % NSTAGE) * SB, lblk, ch, rid,
                     tid);
  };
#pragma unroll 1
  for (int j = 0; j < NSTAGE - 1; ++j) {
    if (j < total) load(j);
    cp_async_commit();
  }

  const int mt = warp & 3, wq = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float part[NT][4], acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = acc[j][e] = 0.f;

#pragma unroll 1
  for (int j = 0; j < total; ++j) {
    cp_async_wait<NSTAGE - 2>();
    fence_async_shared();
    __syncthreads();   // stage j landed; every warp is done with j - 1
    if (j + NSTAGE - 1 < total) load(j + NSTAGE - 1);
    cp_async_commit();
    const int k = j / a.nchunks, ch = j - k * a.nchunks;
    unsigned char* st = ring + (size_t)(j % NSTAGE) * SB;
    // this warpgroup's box of the stage and its queries' columns
    const float* qs = reinterpret_cast<const float*>(
        st + Arm<KIND>::ROWB + wq * (Arm<KIND>::QBOX / 2) * BQ * 128);
    if constexpr (KIND == kF32) {
      stage_dots_f32(reinterpret_cast<float*>(st + wq * BOX), qs,
                     reinterpret_cast<float*>(plane + wq * BOX), mt, wq, g,
                     t, part, acc);
    } else if constexpr (KIND == kBF16) {
      stage_dots_bf16(st + wq * BOX, qs, mt, g, t, part, acc);
    } else {
      decode_stage(st + wq * 64, plane + wq * BOX, wq, ch * 128 + wq * 64,
                   a.d, svmin, sscale);
      stage_dots_bf16(plane + wq * BOX, qs, mt, g, t, part, acc);
    }
    if (ch == a.nchunks - 1) {
      // the tile's dots: the second warpgroup's totals go through the
      // stage just read (element-major, no bank conflict) to the first,
      // which adds them to its own and writes (query qa | qb, row index
      // 8 jj + 2t, + 1)
      float* xch = reinterpret_cast<float*>(st) + mt * 32 + lane;
      __syncthreads();
      if (wq == 1)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) xch[(jj * 4 + e) * 128] = acc[jj][e];
      __syncthreads();
      if (wq == 0) {
        int blk = 0, u0 = 0;
        locate(blockIdx.x + k * gridDim.x, scount, a.nblk, blk, u0);
        const int qa = mt * 16 + g;
        float* da = a.dots + ((size_t)blk * BQ + qa) * a.dcap + u0;
        float* db = da + (size_t)8 * a.dcap;
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = acc[jj][e] + xch[(jj * 4 + e) * 128];
          *reinterpret_cast<float2*>(da + jj * 8 + 2 * t) =
              make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(db + jj * 8 + 2 * t) =
              make_float2(v[2], v[3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
    }
  }
}

// -- 3. scores -------------------------------------------------------------
// Also sets the counts back to -1: the next launch's claim starts there
// (the product, which reads them, is done).
__global__ void __launch_bounds__(256)
scatter_kernel(const int* __restrict__ slots, const float* __restrict__ qsq,
               const float* __restrict__ sqnorm,
               const unsigned long long* __restrict__ map,
               const float* __restrict__ dots, long long cap, int dcap,
               int b, int C, int metric, int* __restrict__ cnt, int nblk,
               float* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x < nblk) cnt[threadIdx.x] = -1;
  const size_t n = (size_t)b * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = __ldg(slots + i);
    float s = -CUDART_INF_F;
    if (r >= 0) {
      const int q = (int)(i / C), blk = q / BQ;
      const int u = (int)(unsigned)map[(size_t)blk * cap + r];
      const float dot = dots[((size_t)blk * BQ + (q - blk * BQ)) * dcap + u];
      const float n2 = __ldg(sqnorm + r);
      if (metric == kL2) {
        s = -((__ldg(qsq + q) - 2.0f * dot) + n2);
      } else if (metric == kCOS) {
        s = dot * rsqrtf(fmaxf(n2, 1e-30f));
      } else {
        s = dot;
      }
    }
    out[i] = s;
  }
}

int sm_count() {
  static int n[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (n[dev] == 0 &&
      cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n[dev];
}

// The persistent grid: one CTA an SM, at most one a tile. The kernel's
// shared-memory limit is raised once for the largest size asked yet (a
// driver call on every launch showed up in the host-bound walk).
template <int KIND>
int launch_product(const BlockArgs& a, long long max_tiles,
                   cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t shm = product_smem<KIND>(a.d);
  if (shm > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        product_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return (int)e;
    allowed = shm;
  }
  const int grid = (int)(max_tiles < sm_count() ? max_tiles : sm_count());
  if (grid == 0) return 0;   // no row to read (an empty store)
  product_kernel<KIND><<<grid, THREADS, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// queries [b, d] f32, qsq [b] f32, rows [cap, d] (kind 0 f32, 1 bf16,
// 2 uint8 sq8 codes; d * element size a multiple of 16, 16-byte aligned
// like the queries), sqnorm [cap] f32, slots [b, C] int32 (-1 = hole),
// vmin/scale [d] f32 (sq8 only), metric 0 L2 / 1 IP / 2 COSINE -> out
// [b, C] f32. blocks = ceil(b / 64) <= 64; dcap >= min(cap, 64 C), a
// multiple of 128. scratch: 16-byte aligned 4-byte words, which the
// caller keeps from launch to launch on one stream (ops/kernel_beam.py
// lays it out the same way):
//   [0, 64)                   the counts, -1 between launches
//   [64, + 2 blocks cap)      the map, 64-bit entries
//   [.., + blocks dcap)       the row list
//   rounded up to 4 words:    the dots [blocks, 64, dcap] f32
// At its first use, and whenever blocks, cap or dcap change, the caller
// zeroes the map and sets the counts to -1; epoch (> 0) is new each
// launch on the scratch.
int dingo_beam_scores_block(const float* queries, const float* qsq,
                            const void* rows, const float* sqnorm,
                            const int* slots, const float* vmin,
                            const float* scale, int kind, int b, int C, int d,
                            long long cap, int metric, int* scratch,
                            int dcap, unsigned epoch, float* out,
                            cudaStream_t stream) {
  if (b <= 0 || C <= 0) return 0;
  const int nblk = (b + BQ - 1) / BQ;
  if (nblk > MAX_BLOCKS || dcap % BN != 0 || epoch == 0)
    return (int)cudaErrorInvalidValue;
  int* cnt = scratch;
  auto* map = reinterpret_cast<unsigned long long*>(scratch + MAX_BLOCKS);
  int* rowlist = scratch + MAX_BLOCKS + 2 * (size_t)nblk * cap;
  const size_t ids = MAX_BLOCKS + 2 * (size_t)nblk * cap + (size_t)nblk * dcap;
  float* dots = reinterpret_cast<float*>(scratch + ((ids + 3) & ~(size_t)3));
  claim_kernel<<<dim3((C + CLAIM_SLOTS - 1) / CLAIM_SLOTS, b), CLAIM_THREADS,
                 0, stream>>>(slots, C, cap, dcap, epoch, map, cnt, rowlist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  BlockArgs a;
  a.q = queries;
  a.x = rows;
  a.vmin = vmin;
  a.scale = scale;
  a.rows = rowlist;
  a.cnt = cnt;
  a.dots = dots;
  a.b = b;
  a.d = d;
  a.nblk = nblk;
  a.dcap = dcap;
  const int bk = kind == kF32 ? Arm<kF32>::BK : Arm<kBF16>::BK;
  a.nchunks = (d + bk - 1) / bk;
  const long long max_tiles = (long long)nblk * (dcap / BN);
  int rc = kind == kF32    ? launch_product<kF32>(a, max_tiles, stream)
           : kind == kBF16 ? launch_product<kBF16>(a, max_tiles, stream)
                           : launch_product<kSQ8>(a, max_tiles, stream);
  if (rc != 0) return rc;

  const long long n = (long long)b * C;
  const long long want = (n + 255) / 256;
  const int sgrid = (int)(want < 16LL * sm_count() ? want : 16LL * sm_count());
  scatter_kernel<<<sgrid, 256, 0, stream>>>(slots, qsq, sqnorm, map, dots,
                                            cap, dcap, b, C, metric, cnt,
                                            nblk, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
