// Kernel B4: dimension-blocked early-pruning scan over the FLAT store's
// blocked mirror.
//
// Replaces dingo_tpu/ops/pallas_topk.py::pruned_fused_topk (body
// _pruned_fused_kernel) in its three row arms (pallas_topk.py:235-251):
//   f32   rows and query f32, f32 FMAs (no TF32);
//   bf16  bf16 rows, the query rounded to bf16: the bf16 x bf16 products
//         of the TPU's bf16 matmul, each exact in f32, summed in f32 by the
//         bf16 tensor cores (mma.sync m16n8k16, f32 accumulate);
//   sq8   uint8 codes decoded per element (code * scale + vmin in f32,
//         rounded to bf16) as they are staged, then as bf16.
// Norms, bounds and stats stay f32 (the store keeps the norms of what the
// arm accumulates). q[b, d] against the mirror x_blk[nblk, n, dblk] (block
// j of row r at x_blk[j, r, :]) with per-block norms bsq_blk[nblk, n],
// total norms xsq[n] and valid[n]: the k best "larger is better" scores
// over valid rows, their slots (-1 where the score is -inf), and the four
// stats lanes of B3 (ivf_pruned_topk.cu has the bound math). It never
// writes a [b, n] score matrix.
//
// What bounds it on an H100: where nothing prunes, the 2 b n d products
// (f32: 1.54 ms at b = 64, n = 2^20, d = 768 on the 67 TFLOP/s f32 peak;
// bf16 operands on the tensor cores: 0.10 ms) or the mirror's bytes (3.2,
// 1.6, 0.8 GB: 0.96, 0.48, 0.24 ms); where it prunes, the products cut to
// the alive (query, row, block) triples and the bytes to the (row, block)
// pairs still alive for some query.
//
// Design. Each CTA owns a contiguous slot range and a 64-query tile and
// walks its range in 128-row tiles; per tile it keeps, in shared memory,
// the running dot of every (query, row) pair, one alive bit per pair (a
// byte per row and warp: the warp's eight queries), the ordered list of
// the tile's rows alive for some query, and per warp the ordered list of
// rows alive for one of its queries. Per dimension block:
//   1. the block's dots, added to the running dot (a sum of block dots, as
//      in the TPU kernel and the plain version). Block 0 and every block
//      while many rows live run dense over the row list: the f32 arm as a
//      register tile of 4 queries x 8 rows per thread (rows in groups of
//      32, so a list of m rows costs ceil(m / 32) quarters of the full
//      tile); the bf16 and sq8 arms on the tensor cores (mma.sync
//      m16n8k16, f32 accumulate), warp w taking the list's 8-row groups w
//      and w + 8 against all 64 queries, 128 columns at a time staged by
//      16-byte asynchronous copies (sq8 codes decode as the fragments are
//      built), the next block's copies issued while this block's bounds
//      run. Rows die for all
//      64 queries only slowly (a row is alive while ANY query keeps it),
//      so once every warp holds at most PAIR_CAP alive pairs the f32 arm
//      computes pair by pair: one lane per alive (query, row) pair, one
//      FMA chain over the block in column order, the same chain as the
//      dense tile's, so a row's dots never depend on the path;
//   2. the bounds: each warp, for its eight queries, takes the threshold
//      (its list's k-th best, the k-th best published by other CTAs and,
//      with `inbucket`, the k-th largest lower bound among the tile's
//      alive pairs), clears the bits whose upper bound is strictly below
//      it and compacts its row list; stats count the alive pairs;
//   3. in the f32 arm the tile's row list drops the rows dead for every
//      query (B3's ballot compaction, order kept), so that they cost
//      neither bytes nor products later. The bf16 and sq8 arms keep the
//      tile's full list: at a batch of 64 a row stays alive while any
//      query keeps it, so nearly every tile keeps nearly all its rows,
//      and the tensor cores multiply the whole tile for the price of a
//      few rows. In every arm a tile with no alive row skips its
//      remaining blocks.
// After the last block the survivors' scores go through B1's ballot
// selection into the per-query running lists, and each list's k-th best is
// published across CTAs (atomicMax on its ordered int image). A second
// pass merges the CTAs' candidates, as in B1.
//
// The CTAs start together, so without help each one would prune only after
// its own list held k rows. A seed launch of the same kernel therefore runs
// first over a strided sample of slots (every seed_stride-th), with no
// pruning, and a merge publishes each query's k-th best of the sample as
// its starting threshold. The main launch scans those rows again with the
// same arithmetic (a row's dots do not depend on its place in a tile), so
// the seed is the exact score of k real candidates: a valid threshold. The
// seed adds no candidates and no stats. The sample is strided, not the
// first slots, since regions are often written cluster by cluster.

#include <type_traits>

#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;          // queries per CTA tile
constexpr int BN = 128;         // rows per scan tile
constexpr int THREADS = 256;    // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int C_LD = BN + 4;    // running dots
// f32 dense tile: BK columns per shared-memory step
constexpr int BK = 16;
constexpr int QS_LD = BQ + 4;
constexpr int XS_LD = BN + 4;
// f32 pair path: PC columns per staged chunk, two chunk buffers
constexpr int PC = 32;
constexpr int PC_LD = PC + 4;   // 16-byte aligned rows
// a block runs pair by pair once no warp holds more than PAIR_CAP alive
// (query, row) pairs (of its 8 x 128)
constexpr int PAIR_CAP = 256;
constexpr int NPL = PAIR_CAP / 32;      // pairs per lane
// bf16 arms: KC columns per staged chunk; bf16 rows (KLD: a 4-word skew
// per row keeps the fragment loads conflict-free) or sq8 codes (XC_LD)
constexpr int KC = 128;
constexpr int KLD = KC + 8;
constexpr int XC_LD = KC + 16;
static_assert(BQ == 8 * NWARPS, "a warp owns eight queries");
static_assert(BK * (QS_LD + XS_LD) <= BN * PC_LD,
              "the dense f32 tile fits in the second pair buffer");

struct ScanArgs {
  const float* q;        // [b, d]
  const __nv_bfloat16* q16;    // [b, d] the query rounded to bf16 (bf16
                               // arms), or null
  const float* qpsq;     // [b, nblk]
  const void* xb;        // [nblk, n, dblk] f32, bf16 or uint8
  dingo::Codec codec;    // sq8 only
  const float* bsq;      // [nblk, n]
  const float* xsq;      // [n]
  const unsigned char* valid;  // [n]
  int b, n, d, dblk, k, ascending, check_every, inbucket;
  int nrows;             // scanned rows: slots 0, step, 2 step, ...
  int step;
  int rows_per_split;
  int* thr_shared;       // [b] ordered images of the k-th bests
  int* stats;            // [b, 4] or null (seed)
  float* cand_v;         // [b, nsplit, k]
  int* cand_i;
  int* tiles;            // [3] or null: blocks computed, of them pair
                         // by pair (f32), rows computed
};

__host__ __device__ inline int up16(int v) { return (v + 15) & ~15; }

// Shared memory, in bytes from the base; every array 16-byte aligned.
// Staging: f32 Qp[2][BQ][PC_LD] + Xp[2][BN][PC_LD] (the dense tile's
// Qs/Xs inside Xp[1]); bf16 Qb[BQ][KLD] + Xb[BN][KLD]; sq8 Qb + the codes
// Xc[BN][XC_LD].
struct Layout {
  int qs, xs, c, qm, xps, xsq, rl, wr, pl, qsq, qp, thr, codec, st, topv,
      topi, tmpv, total;
};

__host__ __device__ inline Layout layout_of(int k, int d, bool mma,
                                            bool sq) {
  Layout L;
  int o = 0;
  L.qs = o;
  o += mma ? BQ * KLD * 2 : up16(2 * BQ * PC_LD * 4);
  L.xs = o;
  o += !mma ? up16(2 * BN * PC_LD * 4) : sq ? BN * XC_LD : BN * KLD * 2;
  L.c = o;    o += BQ * C_LD * 4;
  L.qm = o;   o += BN * 8;
  L.xps = o;  o += BN * 4;
  L.xsq = o;  o += BN * 4;
  L.rl = o;   o += BN * 4;
  L.wr = o;   o += NWARPS * BN;
  L.pl = o;   o += mma ? 0 : NWARPS * PAIR_CAP * 2;
  L.qsq = o;  o += BQ * 4;
  L.qp = o;   o += BQ * 4;
  L.thr = o;  o += BQ * 4;
  L.codec = o;
  o += sq ? up16(2 * ((d + 19) & ~3) * 4) : 0;
  L.st = o;   o += BQ * 4 * 4;
  L.topv = o; o += up16(BQ * k * 4);
  L.topi = o; o += up16(BQ * k * 4);
  L.tmpv = o; o += up16(BQ * k * 4);
  L.total = o;
  return L;
}

// c += A B for one m16n8k16 tile. The MMA sums its 16 exact bf16 x bf16
// products from zero and c takes the result by an IEEE f32 add: chaining
// the block's k steps through the tensor core's own accumulator rounds the
// running sum coarser and biased low (measured against f64 scores).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
  c[0] += d0;
  c[1] += d1;
  c[2] += d2;
  c[3] += d3;
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Asynchronous copies, global -> shared (no registers on the way): 16
// bytes (both 16-byte aligned) or 4 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slot of local row `row` of the tile at r0 (scan row r0 + row).
__device__ __forceinline__ size_t slot_of(const ScanArgs& a, int r0,
                                          int row) {
  return (size_t)(r0 + row) * a.step;
}

// ---- the f32 arm: a block's dots of the listed rows by f32 FMAs ----------
// Thread (tq, tr) = (tid / 16, tid % 16) holds queries tq*4 .. tq*4+3 and
// list positions j*32 + tr*2 + {0, 1} for j < ceil(m / 32); the loader
// stages 16 columns of ceil(m / 32) * 32 rows per step (thread slot t:
// position tid / 16 + 16 t, column tid % 16; 64 contiguous bytes a row).
__device__ __forceinline__ void block_dots_f32(const ScanArgs& a,
                                               const float* __restrict__ xb,
                                               int jb, int q0, int r0,
                                               const int* rl, int m,
                                               float* Qs, float* Xs, float* C,
                                               int tid) {
  const int tq = tid >> 4, tr = tid & 15, kk = tid & 15;
  const int jmax = (m + 31) >> 5;
  const int dblk = a.dblk;
  const float* rowp[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int p = (tid >> 4) + 16 * t;
    rowp[t] = (t < 2 * jmax && p < m)
                  ? xb + ((size_t)jb * a.n + (size_t)(r0 + rl[p]) * a.step) *
                             dblk
                  : nullptr;
  }
  const float* qj = a.q + (size_t)jb * dblk;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float pq[4], px[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = tid + THREADS * t, qq = e / BK, c = k0 + e % BK;
      pq[t] = (q0 + qq < a.b && c < dblk) ? qj[(size_t)(q0 + qq) * a.d + c]
                                          : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      px[t] = (rowp[t] != nullptr && k0 + kk < dblk) ? __ldg(rowp[t] + k0 + kk)
                                                     : 0.f;
  };
  const int nsteps = (dblk + BK - 1) / BK;
  load(0);
  for (int s = 0; s < nsteps; ++s) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = tid + THREADS * t;
      Qs[(e % BK) * QS_LD + e / BK] = pq[t];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (t < 2 * jmax) Xs[kk * XS_LD + (tid >> 4) + 16 * t] = px[t];
    __syncthreads();
    if (s + 1 < nsteps) load((s + 1) * BK);
#pragma unroll
    for (int k2 = 0; k2 < BK; ++k2) {
      const float4 q4 = *reinterpret_cast<const float4*>(
          Qs + k2 * QS_LD + tq * 4);
      const float av[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < jmax) {
          const float2 x2 = *reinterpret_cast<const float2*>(
              Xs + k2 * XS_LD + j * 32 + tr * 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][2 * j] = fmaf(av[i], x2.x, acc[i][2 * j]);
            acc[i][2 * j + 1] = fmaf(av[i], x2.y, acc[i][2 * j + 1]);
          }
        }
      }
    }
    __syncthreads();
  }
  // running dot = block dot (+ the earlier blocks' sum)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int p = j * 32 + tr * 2 + e2;
      if (j < jmax && p < m) {
        const int row = rl[p];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* c = C + (tq * 4 + i) * C_LD + row;
          *c = jb == 0 ? acc[i][2 * j + e2] : acc[i][2 * j + e2] + *c;
        }
      }
    }
}


// ---- the f32 arm on a sparse block: alive pairs only ---------------------
// Only the alive (query, row) pairs are multiplied, each by one lane as a
// single FMA chain over the block's columns in order from 0 (the dense
// tile's chain, so a row's dots never depend on the path). The listed
// rows' slices and the queries' go through shared memory PC columns at a
// time, indexed by local row, by 16-byte asynchronous copies (8 threads
// read one row's 128 contiguous bytes), two chunks in flight; the first
// two chunks of a block are issued during the previous block's bounds (by
// the kernel), since the rows they copy are a superset of the rows still
// alive then.
__device__ __forceinline__ void stage_pairs(const ScanArgs& a,
                                            const float* __restrict__ xb,
                                            int jb, int c0, int q0, int r0,
                                            const int* rl, int m, float* Qp,
                                            float* Xp, int tid) {
  const int dblk = a.dblk, w = min(PC, dblk - c0);
  const float* xblk = xb + (size_t)jb * a.n * dblk + c0;
  const float* qblk = a.q + (size_t)jb * dblk + c0;
  // 16-byte copies where rows and queries allow them, else 4-byte ones
  const bool v4 = (dblk & 3) == 0 && (a.d & 3) == 0 &&
                  ((reinterpret_cast<size_t>(xb) |
                    reinterpret_cast<size_t>(a.q)) & 15) == 0;
  if (v4) {
    constexpr int U = PC / 4;
    for (int e = tid; e < m * U; e += THREADS) {
      const int p = e / U, c = (e % U) * 4;
      if (c < w) {
        const int row = rl[p];
        cp_async16(Xp + row * PC_LD + c,
                   xblk + slot_of(a, r0, row) * dblk + c);
      }
    }
    for (int e = tid; e < BQ * U; e += THREADS) {
      const int qq = e / U, c = (e % U) * 4;
      if (c < w && qq < a.b - q0)
        cp_async16(Qp + qq * PC_LD + c, qblk + (size_t)(q0 + qq) * a.d + c);
    }
  } else {
    for (int e = tid; e < m * PC; e += THREADS) {
      const int p = e / PC, c = e % PC;
      if (c < w) {
        const int row = rl[p];
        cp_async4(Xp + row * PC_LD + c,
                  xblk + slot_of(a, r0, row) * dblk + c);
      }
    }
    for (int e = tid; e < BQ * PC; e += THREADS) {
      const int qq = e / PC, c = e % PC;
      if (c < w && qq < a.b - q0)
        cp_async4(Qp + qq * PC_LD + c, qblk + (size_t)(q0 + qq) * a.d + c);
    }
  }
  cp_async_commit();
}

// Warp w takes the pairs of its eight queries (at most PAIR_CAP, so <= 8
// a lane), listed in pl from its row list wr / wc. `pre`: chunk 0 is
// already in flight in buffer 0.
__device__ __forceinline__ void block_dots_pairs(
    const ScanArgs& a, const float* __restrict__ xb, int jb, int q0, int r0,
    const int* rl, int m, const unsigned char* wr, int wc,
    const unsigned char* qmb, unsigned short* pl, float* Qp, float* Xp,
    float* C, bool pre, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int dblk = a.dblk, nch = (dblk + PC - 1) / PC;
  // chunks issued so far: the kernel prefetches the first two
  int issued = pre ? min(2, nch) : 0;
  int total = 0;
  for (int base = 0; base < wc; base += 32) {
    const int e = base + lane;
    const int row = e < wc ? wr[e] : 0;
    unsigned byte = e < wc ? qmb[row * 8 + warp] : 0u;
    const int c = __popc(byte);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(dingo::FULL_MASK, incl, off);
      if (lane >= off) incl += v;
    }
    int o = total + incl - c;
    while (byte) {
      const int i = __ffs(byte) - 1;
      pl[o++] = (unsigned short)((row << 3) | i);
      byte &= byte - 1u;
    }
    total += __shfl_sync(dingo::FULL_MASK, incl, 31);
  }
  __syncwarp();
  int pe[NPL];                          // (row << 3) | query in warp
  float acc[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int t = j * 32 + lane;
    pe[j] = t < total ? pl[t] : 0;
    acc[j] = 0.f;
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1, w = min(PC, dblk - ch * PC);
    for (; issued < min(nch, ch + 2); ++issued)   // two chunks in flight
      stage_pairs(a, xb, jb, issued * PC, q0, r0, rl, m,
                  Qp + (issued & 1) * BQ * PC_LD,
                  Xp + (issued & 1) * BN * PC_LD, tid);
    if (issued > ch + 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const float* qb = Qp + buf * BQ * PC_LD;
    const float* xs = Xp + buf * BN * PC_LD;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      if (j * 32 < total) {       // warp-uniform; lanes past total idle
        const float* qp = qb + (warp * 8 + (pe[j] & 7)) * PC_LD;
        const float* xp = xs + (pe[j] >> 3) * PC_LD;
        float s = acc[j];
#pragma unroll 8
        for (int c = 0; c < w; ++c) s = fmaf(qp[c], xp[c], s);
        acc[j] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NPL; ++j)
    if (j * 32 + lane < total) {
      float* cp = C + (warp * 8 + (pe[j] & 7)) * C_LD + (pe[j] >> 3);
      *cp = acc[j] + *cp;
    }
}

// ---- the bf16 and sq8 arms: a block's dots on the tensor cores -----------
// Stage columns [c0, c0 + w) of block jb (w16: w rounded up to 16): the 64
// queries, already rounded to bf16, into Qb[64][KLD]; the listed rows
// (local rows list[0..cnt), or 0..cnt-1 where list is null), indexed by
// local row, into Xb[row][KLD] as bf16 or Xc[row][XC_LD] as sq8 codes
// (decoded as the fragments are built). VEC: 16-byte asynchronous copies
// (dblk a multiple of 8 or 16, an aligned mirror; the caller commits and
// waits); else element by element. Pad columns [w, w16) are zero (bf16,
// and the queries; a pad code decodes to a finite value that meets a zero
// query).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_mma(const ScanArgs& a,
                                          const T* __restrict__ xb, int jb,
                                          int c0, int w, int w16, int q0,
                                          int r0, const int* list, int cnt,
                                          __nv_bfloat16* Qb, void* Xs,
                                          int tid) {
  constexpr bool kSq = std::is_same<T, uint8_t>::value;
  const int dblk = a.dblk, col0 = jb * dblk + c0;
  __nv_bfloat16* Xb = static_cast<__nv_bfloat16*>(Xs);
  uint8_t* Xc = static_cast<uint8_t*>(Xs);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  if (VEC) {
    const int qu = w / 8;                // 8 bf16 per copy (w % 8 == 0)
    for (int e = tid; e < BQ * qu; e += THREADS) {
      const int qq = e / qu, c = (e % qu) * 8;
      __nv_bfloat16* dst = Qb + qq * KLD + c;
      if (qq < a.b - q0)
        cp_async16(dst, a.q16 + (size_t)(q0 + qq) * a.d + col0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    constexpr int EL = 16 / sizeof(T);
    const int units = w / EL;            // w % EL == 0 under VEC
    const T* xblk = xb + (size_t)jb * a.n * dblk + c0;
    for (int e = tid; e < cnt * units; e += THREADS) {
      const int p = e / units, c = (e % units) * EL;
      const int row = list ? list[p] : p;
      void* dst = kSq ? static_cast<void*>(Xc + row * XC_LD + c)
                      : static_cast<void*>(Xb + row * KLD + c);
      cp_async16(dst, xblk + slot_of(a, r0, row) * dblk + c);
    }
  } else {
    for (int e = tid; e < BQ * w; e += THREADS) {
      const int qq = e / w, c = e % w;
      Qb[qq * KLD + c] = qq < a.b - q0
                             ? a.q16[(size_t)(q0 + qq) * a.d + col0 + c]
                             : zero;
    }
    for (int e = tid; e < cnt * w; e += THREADS) {
      const int p = e / w, c = e % w;
      const int row = list ? list[p] : p;
      const T v = xb[((size_t)jb * a.n + slot_of(a, r0, row)) * dblk + c0 + c];
      if constexpr (kSq)
        Xc[row * XC_LD + c] = v;
      else
        Xb[row * KLD + c] = v;
    }
  }
  if (w16 > w) {
    for (int e = tid; e < BQ * (w16 - w); e += THREADS)
      Qb[(e / (w16 - w)) * KLD + w + e % (w16 - w)] = zero;
    if (!kSq)
      for (int e = tid; e < cnt * (w16 - w); e += THREADS) {
        const int p = e / (w16 - w);
        Xb[(list ? list[p] : p) * KLD + w + e % (w16 - w)] = zero;
      }
  }
}

// The codec in shared memory: scale[0, cst), then vmin[0, cst), zero past
// d, so that pad columns decode to 0.
__host__ __device__ inline int codec_stride(int d) { return (d + 19) & ~3; }

// Warp w multiplies the 64 staged queries (four m16 tiles) with the list's
// 8-row groups w and w + 8 (n8 tiles), where they hold rows. Fragment
// loads are 32-bit (bf16: conflict-free under the 4-word row skew); sq8
// fragments decode two codes per register (__fmul_rn, __fadd_rn, then
// bf16), the codec of the lane's four columns loaded once per k step.
template <typename T>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* Qb,
                                          const void* Xs,
                                          const float* codec_s, int d,
                                          int col0, int w16, const int* rl,
                                          int m, float (&acc)[2][4][4],
                                          int warp, int lane) {
  constexpr bool kSq = std::is_same<T, uint8_t>::value;
  const int g = lane >> 2, tig = lane & 3;
  const int nt = (m + 7) >> 3;
  const bool has[2] = {warp < nt, warp + NWARPS < nt};
  if (!has[0]) return;
  int rr[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int p = (warp + NWARPS * s) * 8 + g;
    rr[s] = rl[p < m ? p : 0];           // past m: any staged row, unused
  }
  for (int ks = 0; ks < w16; ks += 16) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* qp = Qb + (mt * 16 + g) * KLD + ks + tig * 2;
      af[mt][0] = lds32(qp);
      af[mt][1] = lds32(qp + 8 * KLD);
      af[mt][2] = lds32(qp + 8);
      af[mt][3] = lds32(qp + 8 * KLD + 8);
    }
    float2 sc0, sc8, vm0, vm8;
    if (kSq) {
      const float* sc = codec_s + col0 + ks + tig * 2;
      const float* vm = codec_s + codec_stride(d) + col0 + ks + tig * 2;
      sc0 = *reinterpret_cast<const float2*>(sc);
      sc8 = *reinterpret_cast<const float2*>(sc + 8);
      vm0 = *reinterpret_cast<const float2*>(vm);
      vm8 = *reinterpret_cast<const float2*>(vm + 8);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (has[s]) {
        uint32_t b0, b1;
        if (kSq) {
          const uint8_t* xp = static_cast<const uint8_t*>(Xs) +
                              rr[s] * XC_LD + ks + tig * 2;
          const unsigned u0 = *reinterpret_cast<const unsigned short*>(xp);
          const unsigned u8 =
              *reinterpret_cast<const unsigned short*>(xp + 8);
          b0 = pack_bf16(
              __fadd_rn(__fmul_rn((float)(u0 & 0xffu), sc0.x), vm0.x),
              __fadd_rn(__fmul_rn((float)(u0 >> 8), sc0.y), vm0.y));
          b1 = pack_bf16(
              __fadd_rn(__fmul_rn((float)(u8 & 0xffu), sc8.x), vm8.x),
              __fadd_rn(__fmul_rn((float)(u8 >> 8), sc8.y), vm8.y));
        } else {
          const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(Xs) +
                                    rr[s] * KLD + ks + tig * 2;
          b0 = lds32(xp);
          b1 = lds32(xp + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[s][mt], af[mt], b0, b1);
      }
    }
  }
}

// A block's dots for the listed rows: each KC-column chunk staged (unless
// `pre`: the block's single chunk was issued during the previous block's
// bounds), then multiplied; the running dots take the sum.
template <typename T, bool VEC>
__device__ __forceinline__ void block_dots_mma(const ScanArgs& a,
                                               const T* __restrict__ xb,
                                               const float* codec_s, int jb,
                                               int q0, int r0, const int* rl,
                                               int m, __nv_bfloat16* Qb,
                                               void* Xs, float* C, bool pre,
                                               int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[s][mt][r] = 0.f;
  for (int c0 = 0; c0 < a.dblk; c0 += KC) {
    const int w = min(KC, a.dblk - c0), w16 = up16(w);
    if (!pre) {
      stage_mma<T, VEC>(a, xb, jb, c0, w, w16, q0, r0, rl, m, Qb, Xs, tid);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    mma_chunk<T>(Qb, Xs, codec_s, a.d, jb * a.dblk + c0, w16, rl, m, acc,
                 warp, lane);
    __syncthreads();
    pre = false;
  }
  // running dot = block dot (+ the earlier blocks' sum); accumulator r of
  // tile (mt, n8 group) is query mt*16 + g + 8 (r / 2), position
  // group*8 + tig*2 + r % 2
  const int nt = (m + 7) >> 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (warp + NWARPS * s >= nt) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = (warp + NWARPS * s) * 8 + tig * 2 + (r & 1);
      if (p >= m) continue;
      const int row = rl[p];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float* c = C + (mt * 16 + g + 8 * (r >> 1)) * C_LD + row;
        *c = jb == 0 ? acc[s][mt][r] : acc[s][mt][r] + *c;
      }
    }
  }
}

// Order-preserving compaction of a list of local rows to those whose
// `keep` holds (one warp; in place: a lane writes at or below the position
// it read). Returns the new length.
template <typename I, typename Keep>
__device__ __forceinline__ int compact_rows(I* list, int len, Keep keep,
                                            int lane) {
  int cnt = 0;
  for (int base = 0; base < len; base += 32) {
    const int p = base + lane;
    const int row = p < len ? (int)list[p] : -1;
    const bool k = row >= 0 && keep(row);
    const unsigned msk = __ballot_sync(dingo::FULL_MASK, k);
    __syncwarp();
    if (k) list[cnt + __popc(msk & ((1u << lane) - 1u))] = (I)row;
    cnt += __popc(msk);
    __syncwarp();
  }
  return cnt;
}

// The bounds of a (query, row) pair after a block (topk_common.cuh's
// bounds_of). The bf16 arms multiply the query rounded to bf16 (and sq8
// rows rounded to bf16) while the norms are those of the f32 query and of
// the f32 rows, so a pair's remaining blocks can add a little less than 0
// to its L2 distance, or a little more than the Cauchy-Schwarz term to
// its inner product: each side's bf16 rounding moves its tail's squared
// norm by at most 2^-8 of it. There both bounds widen by 2^-7 of the tail
// terms, which keeps them bounds of the score the arm computes: the scan
// then prunes no pair its own arithmetic would have kept.
template <bool kBf16>
__device__ __forceinline__ dingo::Bounds arm_bounds(float cum, float xps,
                                                    float xsq, float qp,
                                                    float qtail,
                                                    int ascending) {
  dingo::Bounds r = dingo::bounds_of(cum, xps, xsq, qp, qtail, ascending);
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

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pruned_scan_kernel(const ScanArgs a) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr bool kSq = std::is_same<T, uint8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(a.k, a.d, kMma, kSq);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* C = reinterpret_cast<float*>(smem + L.c);
  // staging: bf16 arms Qb / Xs (bf16 rows or sq8 codes); f32 pair buffers
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);
  void* Xs = smem + L.xs;
  float* Qp = reinterpret_cast<float*>(smem + L.qs);
  float* Xp = reinterpret_cast<float*>(smem + L.xs);
  unsigned long long* qm = reinterpret_cast<unsigned long long*>(smem + L.qm);
  unsigned char* qmb = smem + L.qm;      // qmb[row * 8 + warp]
  float* xps_s = reinterpret_cast<float*>(smem + L.xps);
  float* xsq_s = reinterpret_cast<float*>(smem + L.xsq);
  int* rl = reinterpret_cast<int*>(smem + L.rl);
  unsigned char* wr = smem + L.wr + warp * BN;   // this warp's alive rows
  unsigned short* pl =
      reinterpret_cast<unsigned short*>(smem + L.pl) + warp * PAIR_CAP;
  float* qsq_s = reinterpret_cast<float*>(smem + L.qsq);
  float* qp_s = reinterpret_cast<float*>(smem + L.qp);
  float* thr_s = reinterpret_cast<float*>(smem + L.thr);  // shared k-th
                                                          // bests seen
  float* codec_s = reinterpret_cast<float*>(smem + L.codec);
  int* st = reinterpret_cast<int*>(smem + L.st);
  float* topv = reinterpret_cast<float*>(smem + L.topv);
  int* topi = reinterpret_cast<int*>(smem + L.topi);
  float* tmpv = reinterpret_cast<float*>(smem + L.tmpv);
  __shared__ int m_s;
  __shared__ int over_s[NWARPS];         // a warp's alive pairs > PAIR_CAP

  const T* xb = static_cast<const T*>(a.xb);
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int row_lo = split * a.rows_per_split;
  const int row_hi = min(a.nrows, row_lo + a.rows_per_split);
  const int nblk = a.d / a.dblk, k = a.k;
  const int nq = min(BQ, a.b - q0);      // queries of this tile
  // the alive bits of a valid row: this tile's queries
  const unsigned long long qfull =
      nq >= 64 ? ~0ull : ((1ull << nq) - 1ull);
  int n_steps = 0, n_sparse = 0, n_rows = 0;   // the tile counters
  // the next block's rows are copied while this block's bounds run where
  // every block is checked (the scan; the seed checks none) and, in the
  // bf16 arms, a block is one chunk of 16-byte copies
  const bool prefetch =
      a.check_every == 1 && (!kMma || (VEC && a.dblk <= KC));
  int pre_r0 = -1, pre_jb = -1;          // the (tile, block) in flight

  for (int i = 0; i < BQ / NWARPS; ++i) {
    const int ql = warp * (BQ / NWARPS) + i, qg = q0 + ql;
    float s = 0.f;
    if (qg < a.b)
      for (int c = lane; c < a.d; c += 32) {
        const float v = a.q[(size_t)qg * a.d + c];
        s = fmaf(v, v, s);
      }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
    if (lane == 0) qsq_s[ql] = s;
    dingo::list_init(topv + ql * k, topi + ql * k, k);
  }
  for (int c = tid; c < BQ * 4; c += THREADS) st[c] = 0;
  if (kSq) {
    const int cst = codec_stride(a.d);
    for (int c = tid; c < cst; c += THREADS) {
      codec_s[c] = c < a.d ? a.codec.scale[c] : 0.f;
      codec_s[cst + c] = c < a.d ? a.codec.vmin[c] : 0.f;
    }
  }
  __syncthreads();

  for (int r0 = row_lo; r0 < row_hi; r0 += BN) {
    // the lists start as the tile's valid rows, alive for every query
    if (tid < BN) {
      const int vr = r0 + tid;
      const size_t slot = (size_t)vr * a.step;
      const bool in = vr < row_hi;
      const float xs = in ? a.xsq[slot] : 0.f;
      const bool ok = in && a.valid[slot] != 0;
      xps_s[tid] = 0.f;
      xsq_s[tid] = ok ? xs : 0.f;
      qm[tid] = ok ? qfull : 0ull;
      rl[tid] = tid;
    }
    __syncthreads();
    if (warp == 0) {
      const int cnt = compact_rows(
          rl, BN, [&](int row) { return qm[row] != 0ull; }, lane);
      if (lane == 0) m_s = cnt;
    }
    __syncthreads();
    const int nvalid = m_s;
    if (tid < nq) {
      st[tid * 4 + 1] += nvalid * nblk;
      st[tid * 4 + 3] += nvalid;
    }
    int wc = nvalid;                     // this warp's list length
    for (int p = lane; p < nvalid; p += 32) wr[p] = (unsigned char)rl[p];
    __syncwarp();
    bool pairs = false;                  // f32: the next block pair by pair

    for (int jb = 0; jb < nblk; ++jb) {
      const int m = m_s;
      if (m == 0) break;                 // every row of the tile is dead
      const bool last = jb == nblk - 1;
      // loads needed only after this block's dots, issued first: the
      // query prefix norms, the k-th bests other CTAs published, the
      // listed rows' block norms
      float qp_pre = 0.f, thr_pre = -CUDART_INF_F, bsq_pre = 0.f;
      if (tid < nq) {
        qp_pre = a.qpsq[(size_t)(q0 + tid) * nblk + jb];
        thr_pre = dingo::float_of(__ldcg(a.thr_shared + q0 + tid));
      }
      if (tid < m)
        bsq_pre = a.bsq[(size_t)jb * a.n + (size_t)(r0 + rl[tid]) * a.step];
      // stats lanes 0 and 2: alive pairs entering this block, per query
      {
        int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int e = lane; e < wc; e += 32) {
          const unsigned byte = qmb[wr[e] * 8 + warp];
#pragma unroll
          for (int i = 0; i < 8; ++i) cnt[i] += (byte >> i) & 1u;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = __reduce_add_sync(dingo::FULL_MASK, cnt[i]);
          const int ql = warp * 8 + i;
          if (lane == 0 && ql < nq) {
            st[ql * 4] += c;
            if (last) st[ql * 4 + 2] += c;
          }
        }
      }
      if (tid == 0) {
        ++n_steps;
        n_rows += m;
        n_sparse += pairs;
      }

      // a prefetch for another block (its tile ended early) is retired
      // before its buffers are staged again
      const bool pre = pre_r0 == r0 && pre_jb == jb;
      if (pre_r0 >= 0 && !pre) cp_async_wait<0>();
      pre_r0 = -1;
      if constexpr (kMma) {
        block_dots_mma<T, VEC>(a, xb, codec_s, jb, q0, r0, rl, m, Qb, Xs, C,
                               pre, tid);
        // the next chunk of this CTA's scan while the bounds run: the next
        // block of this tile over the current list (a superset of the rows
        // that will stay), or block 0 of the next tile over all its rows
        if (prefetch) {
          if (!last) {
            stage_mma<T, VEC>(a, xb, jb + 1, 0, a.dblk, up16(a.dblk), q0, r0,
                              rl, m, Qb, Xs, tid);
            pre_r0 = r0;
            pre_jb = jb + 1;
          } else if (r0 + BN < row_hi) {
            stage_mma<T, VEC>(a, xb, 0, 0, a.dblk, up16(a.dblk), q0,
                              r0 + BN, nullptr, min(BN, row_hi - r0 - BN),
                              Qb, Xs, tid);
            pre_r0 = r0 + BN;
            pre_jb = 0;
          }
          cp_async_commit();
        }
      } else {
        const float* xf = reinterpret_cast<const float*>(xb);
        if (pairs) {
          block_dots_pairs(a, xf, jb, q0, r0, rl, m, wr, wc, qmb, pl, Qp, Xp,
                           C, pre, tid);
        } else {
          if (pre) cp_async_wait<0>();   // a prefetch this block won't use
          block_dots_f32(a, xf, jb, q0, r0, rl, m, Xp + BN * PC_LD,
                         Xp + BN * PC_LD + BK * QS_LD, C, tid);
        }
        if (prefetch && !last) {         // the next block's first chunks
          stage_pairs(a, xf, jb + 1, 0, q0, r0, rl, m, Qp, Xp, tid);
          if (a.dblk > PC)
            stage_pairs(a, xf, jb + 1, PC, q0, r0, rl, m, Qp + BQ * PC_LD,
                        Xp + BN * PC_LD, tid);
          pre_r0 = r0;
          pre_jb = jb + 1;
        }
      }
      if (tid < BQ) {
        qp_s[tid] = qp_pre;
        thr_s[tid] = thr_pre;
      }
      if (tid < m) xps_s[rl[tid]] += bsq_pre;
      __syncthreads();

      if (last) {
        // survivors' final scores -> the running lists (B1's selection)
        for (int i = 0; i < 8; ++i) {
          const int ql = warp * 8 + i;
          if (ql >= nq) break;
          float* lv = topv + ql * k;
          int* li = topi + ql * k;
          const float qp = qp_s[ql];
          float thr = lv[k - 1];
          for (int base = 0; base < wc; base += 32) {
            const int e = base + lane;
            float sc = -CUDART_INF_F;
            int slot = -1;
            if (e < wc) {
              const int row = wr[e];
              if ((qmb[row * 8 + warp] >> i) & 1u) {
                const float cum = C[ql * C_LD + row];
                sc = a.ascending ? -((qp - 2.0f * cum) + xps_s[row]) : cum;
              }
              slot = (r0 + row) * a.step;
            }
            unsigned mask = __ballot_sync(dingo::FULL_MASK, sc > thr);
            while (mask) {
              const int src = __ffs(mask) - 1;
              const float v = __shfl_sync(dingo::FULL_MASK, sc, src);
              const int id = __shfl_sync(dingo::FULL_MASK, slot, src);
              dingo::warp_insert(lv, li, k, v, id);
              thr = lv[k - 1];
              mask &= ~(1u << src);
              mask &= __ballot_sync(dingo::FULL_MASK, sc > thr);
            }
          }
          if (lane == 0 && lv[k - 1] > thr_s[ql])   // publish only news
            atomicMax(a.thr_shared + q0 + ql, dingo::ord_of(lv[k - 1]));
        }
      } else if ((jb + 1) % a.check_every == 0) {
        // each warp's eight thresholds, then its bits of its listed rows
        float qp_r[8], qt_r[8], bnd_r[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ql = warp * 8 + i;
          qp_r[i] = qp_s[ql];
          qt_r[i] = fmaxf(qsq_s[ql] - qp_r[i], 0.f);
          bnd_r[i] = ql < nq ? fmaxf(topv[ql * k + k - 1], thr_s[ql])
                             : CUDART_INF_F;
        }
        if (a.inbucket) {
          // each query's k-th largest lower bound among its alive pairs,
          // kept only where it beats the threshold: a warp filter per
          // query, the eight bounds of a row computed together
          float t_r[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            t_r[i] = bnd_r[i];
            for (int c = lane; c < k; c += 32)
              tmpv[(warp * 8 + i) * k + c] = -CUDART_INF_F;
          }
          __syncwarp();
          for (int base = 0; base < wc; base += 32) {
            const int e = base + lane;
            const int row = e < wc ? wr[e] : 0;
            const unsigned byte = e < wc ? qmb[row * 8 + warp] : 0u;
            float lb[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              lb[i] = ((byte >> i) & 1u)
                          ? arm_bounds<kMma>(C[(warp * 8 + i) * C_LD + row],
                                             xps_s[row], xsq_s[row], qp_r[i],
                                             qt_r[i], a.ascending).lb
                          : -CUDART_INF_F;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              unsigned mask = __ballot_sync(dingo::FULL_MASK, lb[i] > t_r[i]);
              float* tv = tmpv + (warp * 8 + i) * k;
              while (mask) {
                const int src = __ffs(mask) - 1;
                dingo::warp_insert(
                    tv, nullptr, k,
                    __shfl_sync(dingo::FULL_MASK, lb[i], src), -1);
                t_r[i] = fmaxf(bnd_r[i], tv[k - 1]);
                mask &= ~(1u << src);
                mask &= __ballot_sync(dingo::FULL_MASK, lb[i] > t_r[i]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (warp * 8 + i < nq)
              bnd_r[i] = fmaxf(bnd_r[i], tmpv[(warp * 8 + i) * k + k - 1]);
        }
        // prune: clear the bits whose upper bound is strictly below, then
        // drop this warp's rows with no bit left (order kept)
        int npairs = 0;
        for (int e = lane; e < wc; e += 32) {
          const int row = wr[e];
          const unsigned byte = qmb[row * 8 + warp];
          unsigned keep = byte;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if ((byte >> i) & 1u) {
              const int ql = warp * 8 + i;
              if (arm_bounds<kMma>(C[ql * C_LD + row], xps_s[row], xsq_s[row],
                                   qp_r[i], qt_r[i], a.ascending).ub <
                  bnd_r[i])
                keep &= ~(1u << i);
            }
          }
          if (keep != byte) qmb[row * 8 + warp] = (unsigned char)keep;
          npairs += __popc(keep);
        }
        __syncwarp();
        wc = compact_rows(
            wr, wc, [&](int row) { return qmb[row * 8 + warp] != 0; }, lane);
        npairs = __reduce_add_sync(dingo::FULL_MASK, npairs);
        if (lane == 0) over_s[warp] = npairs > PAIR_CAP;
        __syncthreads();
        // warp 0: the tile's rows alive for some query; the f32 list drops
        // the dead ones, and a tile with none left ends
        if (warp == 0) {
          int alive = 0;
          for (int base = 0; base < m; base += 32) {
            const int p = base + lane;
            alive += __popc(
                __ballot_sync(dingo::FULL_MASK, p < m && qm[rl[p]] != 0ull));
          }
          int cnt = m;
          if (alive == 0)
            cnt = 0;
          else if (!kMma && alive < m)
            cnt = compact_rows(
                rl, m, [&](int row) { return qm[row] != 0ull; }, lane);
          if (lane == 0) m_s = cnt;
        }
        __syncthreads();
        if (!kMma) {                     // f32: pair by pair where it fits
          pairs = true;
          for (int w = 0; w < NWARPS; ++w) pairs = pairs && !over_s[w];
        }
        continue;
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();                    // no copy outlives the CTA

  // this CTA's candidates: cand[q][split][0..k), its stats and counters
  if (a.cand_v != nullptr)
    for (int i = 0; i < BQ / NWARPS; ++i) {
      const int ql = warp * (BQ / NWARPS) + i, qg = q0 + ql;
      if (ql >= nq) break;
      const size_t base = ((size_t)qg * nsplit + split) * k;
      for (int c = lane; c < k; c += 32) {
        a.cand_v[base + c] = topv[ql * k + c];
        a.cand_i[base + c] = topi[ql * k + c];
      }
      if (a.stats != nullptr && lane < 4)
        atomicAdd(a.stats + (size_t)qg * 4 + lane, st[ql * 4 + lane]);
    }
  if (a.tiles != nullptr && tid == 0) {
    atomicAdd(a.tiles, n_steps);
    atomicAdd(a.tiles + 1, n_sparse);
    atomicAdd(a.tiles + 2, n_rows);
  }
}

template <typename T>
int launch(ScanArgs a, int vec, int seed_stride, int seed_rows_per_split,
           float* seed_cand_v, int* seed_cand_i, float* out_v, int* out_i,
           void* stream) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  if (a.k < 1 || a.k > dingo::K_MAX || a.rows_per_split % BN != 0 ||
      a.n < 1 || a.b < 1 || a.dblk < 1 || a.d % a.dblk != 0 ||
      a.check_every < 1 || seed_stride < 1 ||
      seed_rows_per_split % BN != 0 || (kMma && a.q16 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem =
      layout_of(a.k, a.d, kMma, std::is_same<T, uint8_t>::value).total;
  auto kernel =
      vec ? pruned_scan_kernel<T, true> : pruned_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qtiles = (a.b + BQ - 1) / BQ;
  const int nblk = a.d / a.dblk;

  // seed: every seed_stride-th slot, no pruning, no stats; the merge
  // publishes each query's k-th best of the sample into thr_shared
  ScanArgs s = a;
  s.step = seed_stride;
  s.nrows = (a.n + seed_stride - 1) / seed_stride;
  s.rows_per_split = seed_rows_per_split;
  s.check_every = nblk + 1;
  s.stats = nullptr;
  s.tiles = nullptr;
  s.cand_v = seed_cand_v;
  s.cand_i = seed_cand_i;
  const int seed_split = (s.nrows + seed_rows_per_split - 1) /
                         seed_rows_per_split;
  kernel<<<dim3(seed_split, qtiles), THREADS, smem, st>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<a.b, 256, 0, st>>>(
      seed_cand_v, seed_cand_i, seed_split * a.k, a.k, nullptr, nullptr,
      a.thr_shared);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  a.step = 1;
  a.nrows = a.n;
  const int nsplit = (a.n + a.rows_per_split - 1) / a.rows_per_split;
  kernel<<<dim3(nsplit, qtiles), THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<a.b, 256, 0, st>>>(
      a.cand_v, a.cand_i, nsplit * a.k, a.k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q[b, d] f32; q16[b, d] bf16, q rounded to bf16 (the bf16 and sq8 arms;
// null for f32); qpsq[b, nblk] f32 inclusive per-block prefix norms (of
// the f32 query); x_blk[nblk, n, dblk] f32, bf16 (_bf16) or uint8 codes
// with vmin/scale [d] f32 (_sq8); bsq_blk[nblk, n] f32; xsq[n] f32;
// valid[n] bytes. thr_shared[b] i32 holds ord_of(-inf) on entry;
// stats[b, 4] i32 and tiles[3] i32 zeros. cand_v/cand_i: [b, nsplit, k]
// scratch, nsplit = ceil(n / rows_per_split); seed_cand_v/seed_cand_i:
// [b, seed_split, k], seed_split = ceil(ceil(n / seed_stride) /
// seed_rows_per_split); out_v/out_i: [b, k]. vec (bf16, sq8) = dblk a
// multiple of 8 (bf16) or 16 (sq8) and a 16-byte aligned mirror. Returns
// cudaGetLastError() after the launches (seed, its merge, scan, merge).
#define DINGO_B4_ARGS                                                       \
  const float *q, const __nv_bfloat16 *q16, const float *qpsq,             \
      const float *bsq_blk, const float *xsq, const unsigned char *valid,  \
      int b, int n, int d, int dblk, int k, int ascending,                 \
      int check_every, int inbucket, int rows_per_split, int vec,          \
      int seed_stride, int seed_rows_per_split, int *thr_shared,           \
      int *stats, int *tiles, float *cand_v, int *cand_i,                  \
      float *seed_cand_v, int *seed_cand_i, float *out_v, int *out_i,      \
      void *stream
#define DINGO_B4_PASS(T, x_blk, vmin, scale)                                \
  launch<T>(ScanArgs{q, q16, qpsq, x_blk, dingo::Codec{vmin, scale},       \
                     bsq_blk, xsq, valid, b, n, d, dblk, k, ascending,     \
                     check_every, inbucket, n, 1, rows_per_split,          \
                     thr_shared, stats, cand_v, cand_i, tiles},            \
            vec, seed_stride, seed_rows_per_split, seed_cand_v,            \
            seed_cand_i, out_v, out_i, stream)

int dingo_pruned_fused_topk(const float* x_blk, DINGO_B4_ARGS) {
  return DINGO_B4_PASS(float, x_blk, nullptr, nullptr);
}

int dingo_pruned_fused_topk_bf16(const __nv_bfloat16* x_blk,
                                 DINGO_B4_ARGS) {
  return DINGO_B4_PASS(__nv_bfloat16, x_blk, nullptr, nullptr);
}

int dingo_pruned_fused_topk_sq8(const uint8_t* x_blk, const float* vmin,
                                const float* scale, DINGO_B4_ARGS) {
  return DINGO_B4_PASS(uint8_t, x_blk, vmin, scale);
}

}  // extern "C"
