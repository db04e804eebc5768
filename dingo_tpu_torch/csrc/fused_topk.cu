// Kernel B1: fused distance + running top-k over a whole slot store.
//
// Replaces dingo_tpu/ops/pallas_topk.py::fused_topk (body _fused_kernel) in
// both of its row arms: f32 rows, and bf16 rows against the f32 query
// (pallas_topk.py:67). Computes, for q[b, d] against x[n, d], the k best
// "larger is better" scores (L2: -(||q||^2 - 2 q.x + ||x||^2); IP: q.x)
// over rows whose valid byte is set, and their slots (-1 where the score
// is -inf). It never writes a [b, n] score matrix.
//
// What bounds it on an H100: at the serving shape (b = 64, n = 2^20,
// d = 768) the rows are 3.2 GB in f32 (0.96 ms at 3.35 TB/s) and 1.6 GB in
// bf16 (0.48 ms). The products are 103 GFLOP a pass; the split-precision
// products below take three passes on the tensor cores, 0.62 ms at the
// 495 TFLOP/s TF32 peak and 0.31 ms at the 989 TFLOP/s bf16 peak, so bytes
// bound both arms. (As plain f32 FMAs the same products took 1.54 ms at
// the 67 TFLOP/s CUDA-core peak: the bound of the kernel this replaces.)
//
// Design: the TPU streams blocks through one core in order and carries the
// running best from grid step to step; Hopper runs blocks in parallel, so
// each CTA owns a contiguous slot range and one 64-query tile and writes
// its candidates, which a second small kernel merges to [b, k].
//   1. A producer warp streams the range in tiles of 256 rows, 128 bytes
//      of columns at a time (32 f32 or 64 bf16 columns), by TMA tensor
//      copies into a shared-memory ring of three or four stages, with the
//      64 queries' same columns (f32; two boxes of 32 columns for bf16
//      rows) in the same stage: 128-byte swizzle, zeros past the matrix's
//      last row and column. The next tiles' copies are in flight while a
//      tile multiplies and while its scores are filtered.
//   2. Two consumer warpgroups (eight warps) multiply the 64-query tile
//      (M = 64) by the row tile with wgmma, warpgroup w taking the tile's
//      rows 128 w .. + 127 (N = 128): the queries are A, from registers
//      (warp i of a warpgroup holds queries 16 i .. + 15), the rows B,
//      K-major straight from the stage TMA filled (the 128-byte swizzle is
//      wgmma's). f32 rows: 3xTF32 (m64n128k8) — the warpgroup first
//      rounds its rows in place to hi = rna(x) and writes lo = x - hi to a
//      plane of the same layout; bf16 rows: the rows as they landed
//      against the three bf16 parts of the query (m64n128k16). The
//      queries are split in registers. Each pair of k steps sums from zero
//      into a partial, which is added to an f32 total (split_mma.cuh: the
//      tensor cores truncate as they accumulate).
//   3. Selection: after each tile a warp filters its 16 x 128 scores in
//      registers against its own running lists (one per query and
//      warpgroup: 2 per query in the CTA; the rows' norms and validity
//      were read as the tile started) with ballots, and inserts the few
//      that pass (topk_common.cuh's warp_insert); no CTA-wide barrier, so
//      the other warps' products go on meanwhile. Each CTA writes its 2 k
//      candidates per query to [b, 2 nsplit, k]; merge_candidates picks
//      the k best. The lists share the shared memory with the ring (and
//      the f32 arm's lo planes): four stages up to k = 33, three above.
//   4. The k winners of each query are scored again in the f32
//      arithmetic of the kernel this one replaces (rescore_kernel: one FMA
//      chain over the columns in order) and re-sorted, so the tier's
//      returned distances are what they were. The split products are
//      closer to exact than such a chain over 768 columns and differ from
//      it by up to the chain's own rounding (2.3e-3 at the smoke's
//      near-duplicate queries, against the 1e-3 parity tolerance).
//   Inputs TMA cannot read (a row pitch that is not a multiple of 16
//   bytes, a misaligned base) take the same ring, filled by the producer
//   warp with plain loads.

#include <cstring>
#include <type_traits>

#include "split_mma.cuh"
#include "topk_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;                   // queries per CTA tile
constexpr int BN = 256;                  // rows per scan tile
constexpr int NCW = 8;                   // consumer warps
constexpr int WN = BN / (NCW / 4);       // rows of a tile per warp (128)
constexpr int NT = WN / 8;               // n8 column tiles per warp
constexpr int THREADS = (NCW + 1) * 32;  // + the producer warp
constexpr int MAX_STAGES = 4;

// BK: columns per ring stage (128 bytes of a row); QBOX: 32-column boxes
// of the f32 queries per stage.
template <typename T>
struct Arm;
template <>
struct Arm<float> {
  static constexpr int BK = 32, QBOX = 1;
};
template <>
struct Arm<__nv_bfloat16> {
  static constexpr int BK = 64, QBOX = 2;
};

template <typename T>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return BN * 128 + Arm<T>::QBOX * BQ * 128;
}

struct Args {
  const float* q;
  const void* x;
  const float* xsq;
  const unsigned char* valid;
  int b, n, d, k, ascending, rows_per_split, tma, nstage;
  float* cand_v;
  int* cand_i;
};

constexpr int LPQ = NCW / 4;             // running lists per query
static_assert(LPQ == 2, "a warpgroup reads the other one's lists (wq ^ 1)");

// The f32 arm's lo planes: one [WN rows x 128 bytes] per warpgroup.
template <typename T>
__host__ __device__ constexpr uint32_t lo_bytes() {
  return std::is_same<T, float>::value ? (NCW / 4) * WN * 128 : 0;
}

template <typename T>
size_t smem_bytes(int nstage, int k) {
  return 1024 + (size_t)nstage * stage_bytes<T>() + lo_bytes<T>() +
         (sizeof(float) + sizeof(int)) * (size_t)BQ * LPQ * k +
         sizeof(float) * BQ + 2 * sizeof(uint64_t) * nstage;
}

// -- the products: wgmma over a warpgroup's 64 queries x 128 rows --------
// The 64-query tile is A (M = 64), from registers: warp mt of a
// warpgroup holds queries 16 mt .. + 15, split as mma.sync fragments are
// laid out. The row tile is B (N = 128 rows of the warpgroup), K-major
// from the stage in the 128-byte swizzle (what TMA wrote). Each pair of k
// steps sums from zero into a partial, the small terms first, which is
// then added to the f32 total (split_mma.cuh says why).

using dingo::fence_regs;
using dingo::sw128_desc;
using dingo::wg_commit_wait;
using dingo::wg_fence;
using dingo::wgmma_bf16;
using dingo::wgmma_tf32;
static_assert(NT == dingo::WG_N8, "wgmma.cuh multiplies n128 tiles");

// One stage's products, f32 rows (3xTF32): the warpgroup splits its 128
// rows first, hi = rna(x) in place and lo = x - hi into its plane at the
// same swizzled offsets, then runs two partials of two k8 steps each.
__device__ __forceinline__ void stage_dots(float* xs, const float* qs,
                                           float* lo, int mt, int wq, int g,
                                           int t, float (&p)[NT][4],
                                           float (&acc)[NT][4]) {
  float* xw = xs + wq * WN * 32;   // this warpgroup's rows
  float4* xv = reinterpret_cast<float4*>(xw);
  float4* lv = reinterpret_cast<float4*>(lo);
  dingo::bar_sync(2 + wq, 128);    // the last stage's products read lo
#pragma unroll 4
  for (int i = threadIdx.x & 127; i < WN * 32 / 4; i += 128) {
    const float4 v = xv[i];
    const float4 h = make_float4(__uint_as_float(dingo::tf32_rna(v.x)),
                                 __uint_as_float(dingo::tf32_rna(v.y)),
                                 __uint_as_float(dingo::tf32_rna(v.z)),
                                 __uint_as_float(dingo::tf32_rna(v.w)));
    xv[i] = h;
    lv[i] = make_float4(__fsub_rn(v.x, h.x), __fsub_rn(v.y, h.y),
                        __fsub_rn(v.z, h.z), __fsub_rn(v.w, h.w));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  dingo::bar_sync(2 + wq, 128);
  const float* qr = qs + (mt * 16 + g) * 32 + t;
  const uint64_t dx = sw128_desc(xw), dl = sw128_desc(lo);
#pragma unroll
  for (int s0 = 0; s0 < 4; s0 += 2) {
    uint32_t qh[2][4], ql[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {                     // columns 8 (s0 + u)
      const int s = s0 + u;
      const int c0 = (((2 * s) ^ g) & 7) << 2;
      const int c1 = (((2 * s + 1) ^ g) & 7) << 2;
      dingo::split_tf32(qr[c0], qh[u][0], ql[u][0]);
      dingo::split_tf32(qr[8 * 32 + c0], qh[u][1], ql[u][1]);
      dingo::split_tf32(qr[c1], qh[u][2], ql[u][2]);
      dingo::split_tf32(qr[8 * 32 + c1], qh[u][3], ql[u][3]);
    }
    fence_regs(p);
    wg_fence();
    wgmma_tf32(p, qh[0], dl + 2 * s0, 0);
    wgmma_tf32(p, qh[1], dl + 2 * (s0 + 1), 1);
    wgmma_tf32(p, ql[0], dx + 2 * s0, 1);
    wgmma_tf32(p, ql[1], dx + 2 * (s0 + 1), 1);
    wgmma_tf32(p, qh[0], dx + 2 * s0, 1);
    wgmma_tf32(p, qh[1], dx + 2 * (s0 + 1), 1);
    wg_commit_wait();
    fence_regs(p);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
  }
}

// One stage's products, bf16 rows: the rows as they landed, against the
// three bf16 parts of the f32 query; two partials of two k16 steps each.
__device__ __forceinline__ void stage_dots(__nv_bfloat16* xb,
                                           const float* qs, float*, int mt,
                                           int wq, int g, int t,
                                           float (&p)[NT][4],
                                           float (&acc)[NT][4]) {
  // the queries' columns kk + 2t, + 1 in their f32 box of 32 columns
  const float* qr = qs + (mt * 16 + g) * 32 + 2 * (t & 1);
  const uint64_t dx = sw128_desc(xb + wq * WN * 64);
#pragma unroll
  for (int s0 = 0; s0 < 4; s0 += 2) {
    uint32_t a1[2][4], a2[2][4], a3[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {                     // columns 16 (s0 + u)
      const int kk = 16 * (s0 + u);
      const float* qb = qr + (kk >> 5) * (BQ * 32);
      const int kc = (kk & 31) >> 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // rows (+0 | +8) x columns (+0 | +8)
        const int ch = ((kc + (t >> 1) + (i >> 1) * 2) ^ g) & 7;
        const float2 v = *reinterpret_cast<const float2*>(
            qb + (i & 1) * 8 * 32 + ch * 4);
        dingo::split_bf16x3(v.x, v.y, a1[u][i], a2[u][i], a3[u][i]);
      }
    }
    fence_regs(p);
    wg_fence();
    wgmma_bf16(p, a3[0], dx + 2 * s0, 0);
    wgmma_bf16(p, a3[1], dx + 2 * (s0 + 1), 1);
    wgmma_bf16(p, a2[0], dx + 2 * s0, 1);
    wgmma_bf16(p, a2[1], dx + 2 * (s0 + 1), 1);
    wgmma_bf16(p, a1[0], dx + 2 * s0, 1);
    wgmma_bf16(p, a1[1], dx + 2 * (s0 + 1), 1);
    wg_commit_wait();
    fence_regs(p);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
  }
}

// The rare path of the selection, out of line (the hot path stays small):
// inserts the scores of one n8 tile that beat their query's running k-th
// best, lane by lane in ballot order, into the warp's own lists. sc: (qa,
// row0 + 2t), (qa, + 1), (qb, row0 + 2t), (qb, + 1); returns the new
// thresholds of qa and qb.
__device__ __noinline__ float2 insert_tile(float s0, float s1, float s2,
                                           float s3, int row0, int qbase,
                                           int wq, float* topv, int* topi,
                                           int k, int la, int lb, bool oka,
                                           bool okb, float thra,
                                           float thrb) {
  const float sc[4] = {s0, s1, s2, s3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    unsigned m =
        __ballot_sync(dingo::FULL_MASK, sc[e] > (e < 2 ? thra : thrb));
    while (m) {
      const int src = __ffs(m) - 1;
      const float v = __shfl_sync(dingo::FULL_MASK, sc[e], src);
      const int l = (qbase + (src >> 2) + (e < 2 ? 0 : 8)) * LPQ + wq;
      dingo::warp_insert(topv + l * k, topi + l * k, k, v,
                         row0 + 2 * (src & 3) + (e & 1));
      thra = oka ? topv[la * k + k - 1] : CUDART_INF_F;
      thrb = okb ? topv[lb * k + k - 1] : CUDART_INF_F;
      m &= ~(1u << src);
      m &= __ballot_sync(dingo::FULL_MASK, sc[e] > (e < 2 ? thra : thrb));
    }
  }
  return make_float2(thra, thrb);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_scan_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap qmap, const Args a) {
  constexpr int BK = Arm<T>::BK, QBOX = Arm<T>::QBOX;
  constexpr uint32_t SB = stage_bytes<T>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (dingo::smem_u32(smem_raw) & 1023)) & 1023);
  const int k = a.k, nst = a.nstage;
  float* lo = reinterpret_cast<float*>(ring + (size_t)nst * SB);
  float* topv = reinterpret_cast<float*>(ring + (size_t)nst * SB +
                                         lo_bytes<T>());
  int* topi = reinterpret_cast<int*>(topv + BQ * LPQ * k);
  float* qsq_s = reinterpret_cast<float*>(topi + BQ * LPQ * k);
  uint64_t* full = reinterpret_cast<uint64_t*>(qsq_s + BQ);
  uint64_t* empty = full + nst;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int row_lo = split * a.rows_per_split;
  const int row_hi = min(a.n, row_lo + a.rows_per_split);
  const int ntiles = (row_hi - row_lo + BN - 1) / BN;
  const int nchunks = (a.d + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      dingo::mbar_init(full + s, 1);
      dingo::mbar_init(empty + s, NCW);
    }
    dingo::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {   // producer
    uint32_t it = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = row_lo + tile * BN;
      for (int ch = 0; ch < nchunks; ++ch, ++it) {
        const uint32_t s = it % nst, f = it / nst;
        if (f > 0) dingo::mbar_wait(empty + s, (f - 1) & 1);
        unsigned char* st = ring + (size_t)s * SB;
        const int c0 = ch * BK;
        if (a.tma) {
          if (lane == 0) {
            dingo::mbar_arrive_expect_tx(full + s, SB);
            dingo::tma_load_2d(st, &xmap, c0, r0, full + s);
            for (int bx = 0; bx < QBOX; ++bx)
              dingo::tma_load_2d(st + BN * 128 + bx * BQ * 128, &qmap,
                                 c0 + 32 * bx, q0, full + s);
          }
        } else {
          dingo::fill_box_sw128<T>(st, static_cast<const T*>(a.x), a.n, a.d,
                                   r0, c0, BN, lane);
          for (int bx = 0; bx < QBOX; ++bx)
            dingo::fill_box_sw128<float>(st + BN * 128 + bx * BQ * 128, a.q,
                                         a.b, a.d, q0, c0 + 32 * bx, BQ,
                                         lane);
          __syncwarp();
          if (lane == 0) dingo::mbar_arrive(full + s);
        }
      }
    }
    return;
  }

  // consumers: ||q||^2 of this tile's queries, empty running lists (warp w
  // owns queries 16 (w % 4) .. + 15, the tile's rows WN (w / 4) .. +
  // WN - 1 and lists (query, w / 4))
  const int mt = warp & 3, wq = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  if (wq == 0)
    for (int i = 0; i < 16; ++i) {
      const int ql = mt * 16 + i, qg = q0 + ql;
      float s = 0.f;
      if (qg < a.b)
        for (int c = lane; c < a.d; c += 32) {
          const float v = a.q[(size_t)qg * a.d + c];
          s = fmaf(v, v, s);
        }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
      if (lane == 0) qsq_s[ql] = s;
    }
  for (int i = 0; i < 16; ++i) {
    const int l = (mt * 16 + i) * LPQ + wq;
    dingo::list_init(topv + l * k, topi + l * k, k);
  }
  dingo::bar_sync(1, NCW * 32);
  const int qla = mt * 16 + g, qlb = qla + 8;
  const bool oka = q0 + qla < a.b, okb = q0 + qlb < a.b;
  const float qsqa = qsq_s[qla], qsqb = qsq_s[qlb];
  float thra = oka ? -CUDART_INF_F : CUDART_INF_F;   // empty lists
  float thrb = okb ? -CUDART_INF_F : CUDART_INF_F;
  // this warp's lists of qla and qlb, and the other warpgroup's
  float* lva = topv + (qla * LPQ + wq) * k;
  float* lvb = topv + (qlb * LPQ + wq) * k;
  const float* lva_o = topv + (qla * LPQ + (wq ^ 1)) * k;
  const float* lvb_o = topv + (qlb * LPQ + (wq ^ 1)) * k;

  uint32_t it = 0;
  float part[NT][4];   // a partial of the products (starts from zero)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int r0 = row_lo + tile * BN + wq * WN;   // this warp's rows
    // the rows' norms and validity, read now (no load waits on another)
    // and used after the products: lane l holds rows l, l + 32, ...
    float xq[WN / 32];
    unsigned char vq[WN / 32];
#pragma unroll
    for (int h = 0; h < WN / 32; ++h) {
      const int row = r0 + h * 32 + lane;
      const bool in = row < row_hi;
      xq[h] = in ? __ldg(a.xsq + row) : 0.f;
      vq[h] = in ? __ldg(a.valid + row) : 0;
    }
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int ch = 0; ch < nchunks; ++ch, ++it) {
      const uint32_t s = it % nst;
      dingo::mbar_wait(full + s, (it / nst) & 1);
      unsigned char* st = ring + (size_t)s * SB;
      stage_dots(reinterpret_cast<T*>(st),
                 reinterpret_cast<const float*>(st + BN * 128),
                 lo + wq * WN * 32, mt, wq, g, t, part, acc);
      __syncwarp();
      if (lane == 0) dingo::mbar_arrive(empty + s);
    }

    // scores in place: acc[j] = (qla, row 8 j + 2t), (qla, + 1), (qlb,
    // 8 j + 2t), (qlb, + 1) of this warp's rows from r0; -inf if invalid
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = (j * 8 + 2 * t + e) & 31;
        const float xs = __shfl_sync(dingo::FULL_MASK, xq[j / 4], rr);
        const bool ok = __shfl_sync(dingo::FULL_MASK, (int)vq[j / 4], rr);
        acc[j][e] = !ok ? -CUDART_INF_F
                    : a.ascending ? -((qsqa - 2.0f * acc[j][e]) + xs)
                                  : acc[j][e];
        acc[j][2 + e] = !ok ? -CUDART_INF_F
                        : a.ascending ? -((qsqb - 2.0f * acc[j][2 + e]) + xs)
                                      : acc[j][2 + e];
      }
    if (tile == 0) {
      // the lists are empty: fill each at once with the tile's k best,
      // k rounds of an argmax over the four lanes (t) that hold a query's
      // 128 scores, each round the best pair below the last one taken
      float lav = CUDART_INF_F, lbv = CUDART_INF_F;
      int lar = -1, lbr = -1;
      for (int r = 0; r < k; ++r) {
        float bav = -CUDART_INF_F, bbv = -CUDART_INF_F;
        int bar = INT_MAX, bbr = INT_MAX;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rr = j * 8 + 2 * t + e;
            const float va = acc[j][e], vb = acc[j][2 + e];
            if ((va < lav || (va == lav && rr > lar)) &&
                dingo::better(va, rr, bav, bar)) {
              bav = va;
              bar = rr;
            }
            if ((vb < lbv || (vb == lbv && rr > lbr)) &&
                dingo::better(vb, rr, bbv, bbr)) {
              bbv = vb;
              bbr = rr;
            }
          }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ov = __shfl_xor_sync(dingo::FULL_MASK, bav, off);
          const int orr = __shfl_xor_sync(dingo::FULL_MASK, bar, off);
          if (dingo::better(ov, orr, bav, bar)) {
            bav = ov;
            bar = orr;
          }
          const float pv = __shfl_xor_sync(dingo::FULL_MASK, bbv, off);
          const int prr = __shfl_xor_sync(dingo::FULL_MASK, bbr, off);
          if (dingo::better(pv, prr, bbv, bbr)) {
            bbv = pv;
            bbr = prr;
          }
        }
        if (t == 0) {
          const bool na = bar == INT_MAX || bav == -CUDART_INF_F;
          const bool nb = bbr == INT_MAX || bbv == -CUDART_INF_F;
          if (oka) {
            lva[r] = na ? -CUDART_INF_F : bav;
            topi[(qla * LPQ + wq) * k + r] = na ? -1 : r0 + bar;
          }
          if (okb) {
            lvb[r] = nb ? -CUDART_INF_F : bbv;
            topi[(qlb * LPQ + wq) * k + r] = nb ? -1 : r0 + bbr;
          }
        }
        lav = bav;
        lar = bar;
        lbv = bbv;
        lbr = bbr;
      }
      __syncwarp();
      thra = oka ? lva[k - 1] : CUDART_INF_F;
      thrb = okb ? lvb[k - 1] : CUDART_INF_F;
      continue;
    }
    // later tiles: a candidate must beat its list's k-th best and the
    // other warpgroup's list of the same query (their union is merged)
    thra = fmaxf(thra, oka ? lva_o[k - 1] : CUDART_INF_F);
    thrb = fmaxf(thrb, okb ? lvb_o[k - 1] : CUDART_INF_F);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (__any_sync(dingo::FULL_MASK, acc[j][0] > thra || acc[j][1] > thra ||
                                           acc[j][2] > thrb ||
                                           acc[j][3] > thrb)) {
        const float2 th = insert_tile(
            acc[j][0], acc[j][1], acc[j][2], acc[j][3], r0 + j * 8, mt * 16,
            wq, topv, topi, k, qla * LPQ + wq, qlb * LPQ + wq, oka, okb,
            thra, thrb);
        thra = th.x;
        thrb = th.y;
      }
    }
  }

  // this warp's candidates: cand[q][LPQ split + wq][0..k)
  for (int i = 0; i < 16; ++i) {
    const int ql = mt * 16 + i, qg = q0 + ql;
    if (qg >= a.b) break;
    const int l = ql * LPQ + wq;
    const size_t base = ((size_t)qg * LPQ * nsplit + LPQ * split + wq) * k;
    for (int c = lane; c < k; c += 32) {
      a.cand_v[base + c] = topv[l * k + c];
      a.cand_i[base + c] = topi[l * k + c];
    }
  }
}

// The k winners' scores in the f32 arithmetic of the kernel this one
// replaces (and of an f32 GEMM that sums each output in column order),
// then the k re-sorted (larger score first, equal scores in merge order).
// Each dot is one FMA chain over the columns in order from zero; ||q||^2
// is summed as the scan sums it. The split products rank the rows; what a
// caller reads back are the fp32 tier's f32 dots. One block per query:
// the winners' rows pass through shared memory RC columns at a time
// (coalesced), and thread t < k runs entry t's chain.
constexpr int RC = 128;                  // columns a rescore step
constexpr int RTHREADS = 128;

template <typename T>
__global__ void __launch_bounds__(RTHREADS)
rescore_kernel(const float* __restrict__ q, const T* __restrict__ x,
               const float* __restrict__ xsq, int d, int k, int ascending,
               float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float xs[dingo::K_MAX * (RC + 1)];   // pitch RC + 1: no conflicts
  __shared__ float qs[RC];
  __shared__ float sv[dingo::K_MAX];
  __shared__ int sid[dingo::K_MAX];
  __shared__ float qsq_s;
  const int row = blockIdx.x, t = threadIdx.x;
  const float* qr = q + (size_t)row * d;
  if (t < k) sid[t] = out_i[(size_t)row * k + t];
  if (t < 32) {
    float s = 0.f;
    for (int c = t; c < d; c += 32) s = fmaf(qr[c], qr[c], s);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
    if (t == 0) qsq_s = s;
  }
  float acc = 0.f;
  for (int c0 = 0; c0 < d; c0 += RC) {
    const int w = min(RC, d - c0);
    __syncthreads();   // the last step's columns are consumed
    for (int e = t; e < w; e += RTHREADS) qs[e] = qr[c0 + e];
    // eight loads a thread in flight before their stores
    for (int e0 = t; e0 < k * RC; e0 += 8 * RTHREADS) {
      float tv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * RTHREADS, r = e / RC, c = e - r * RC;
        const int id = e < k * RC ? sid[r] : -1;
        tv[u] = c < w && id >= 0
                    ? dingo::row_value(x[(size_t)id * d + c0 + c], c0 + c,
                                       dingo::Codec{})
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * RTHREADS;
        if (e < k * RC) xs[(e / RC) * (RC + 1) + e % RC] = tv[u];
      }
    }
    __syncthreads();
    if (t < k && sid[t] >= 0) {
      const float* xr = xs + t * (RC + 1);
#pragma unroll 8
      for (int c = 0; c < w; ++c) acc = fmaf(qs[c], xr[c], acc);
    }
  }
  float v = -CUDART_INF_F;
  if (t < k && sid[t] >= 0)
    v = ascending ? -((qsq_s - 2.0f * acc) + __ldg(xsq + sid[t])) : acc;
  if (t < k) sv[t] = v;
  __syncthreads();
  if (t < k) {
    int rank = 0;
    for (int u = 0; u < k; ++u) rank += sv[u] > v || (sv[u] == v && u < t);
    out_v[(size_t)row * k + rank] = v;
    out_i[(size_t)row * k + rank] = sid[t];
  }
}

template <typename T>
int launch(Args a, float* out_v, int* out_i, void* stream) {
  if (a.k < 1 || a.k > dingo::K_MAX || a.rows_per_split % BN != 0 ||
      a.n < 1 || a.b < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  a.nstage = MAX_STAGES;   // as many stages as the running lists leave room
  while (a.nstage > 2 && smem_bytes<T>(a.nstage, a.k) > (size_t)max_smem)
    --a.nstage;
  const size_t smem = smem_bytes<T>(a.nstage, a.k);
  CUtensorMap xmap, qmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&qmap, 0, sizeof(qmap));
  if (a.tma) {
    int rc = dingo::encode_map(&xmap, a.x,
                               std::is_same<T, __nv_bfloat16>::value, a.n,
                               a.d, BN, Arm<T>::BK, true);
    if (rc == 0)
      rc = dingo::encode_map(&qmap, a.q, false, a.b, a.d, BQ, 32, true);
    if (rc != 0) return rc;
  }
  auto kernel = fused_scan_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (a.n + a.rows_per_split - 1) / a.rows_per_split;
  dim3 grid(nsplit, (a.b + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, st>>>(xmap, qmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<a.b, 256, 0, st>>>(
      a.cand_v, a.cand_i, LPQ * nsplit * a.k, a.k, out_v, out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rescore_kernel<T><<<a.b, RTHREADS, 0, st>>>(
      a.q, static_cast<const T*>(a.x), a.xsq, a.d, a.k, a.ascending, out_v,
      out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Running lists per query and CTA (the candidates' middle dimension is
// this times nsplit).
int dingo_fused_topk_lists() { return LPQ; }

// q[b,d] f32; x[n,d] f32 (dingo_fused_topk) or bf16 (dingo_fused_topk_bf16);
// xsq[n] f32; valid[n] bytes (nonzero = live). rows_per_split: a multiple
// of 256; cand_v/cand_i: [b, L nsplit, k] scratch (L from
// dingo_fused_topk_lists), nsplit = ceil(n /
// rows_per_split); out_v/out_i: [b, k]. tma = rows and queries can go by
// TMA (a row pitch that is a multiple of 16 bytes for both, 16-byte
// aligned bases). Returns cudaGetLastError() after the launches (scan,
// merge, rescore).
int dingo_fused_topk(const float* q, const float* x, const float* xsq,
                     const unsigned char* valid, int b, int n, int d, int k,
                     int ascending, int rows_per_split, int tma,
                     float* cand_v, int* cand_i, float* out_v, int* out_i,
                     void* stream) {
  return launch<float>(Args{q, x, xsq, valid, b, n, d, k, ascending,
                            rows_per_split, tma, 0, cand_v, cand_i},
                       out_v, out_i, stream);
}

int dingo_fused_topk_bf16(const float* q, const __nv_bfloat16* x,
                          const float* xsq, const unsigned char* valid, int b,
                          int n, int d, int k, int ascending,
                          int rows_per_split, int tma, float* cand_v,
                          int* cand_i, float* out_v, int* out_i,
                          void* stream) {
  return launch<__nv_bfloat16>(Args{q, x, xsq, valid, b, n, d, k, ascending,
                                    rows_per_split, tma, 0, cand_v, cand_i},
                               out_v, out_i, stream);
}

}  // extern "C"
