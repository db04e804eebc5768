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
// and a (query, row) pair whose upper bound is strictly below the
// query's threshold is dropped. The threshold is the k-th best that the
// query's finished buckets have published, raised (flag `inbucket`) to the
// k-th largest suffix-norm LOWER bound among the bucket's alive rows for
// that query (L2: -(partial + (|q_tail| + |x_tail|)^2); IP: cum -
// |q_tail||x_tail|, both shaved by 1e-5 |lb| + 1e-6).
//
// What bounds it on an H100: bytes, in principle. At b = 64, nprobe = 32
// (budget 49), cap = 1024, d = 768 the (query, rank) pairs probe some 730
// distinct buckets, 3 MB each in f32 (1.5 MB bf16, 0.75 MB sq8). Block 0
// of every valid row has to be read; pruning cuts the later blocks to the
// rows still alive. As built, the per-row work of staging and the dots and
// the per-item epilogues take more time than the bytes (PERF.md, PR 6).
//
// Design. The TPU kernel walks (query, rank, block) in order, so a bucket
// that several queries probe is streamed once per query. Here the unit of
// work is an ITEM: one bucket and up to QT of the queries that probe it.
//   1. Work list, built on the device by two small kernels (no host read):
//      the valid (query, rank) pairs grouped by bucket, by rank then query
//      within a bucket, cut into chunks of QT; the items ordered by the
//      rank of their first pair, then bucket, so that the items holding
//      rank-0 pairs come first and thresholds rise early. The definition
//      is ops/kernel_ivf_pruned.py::probe_items_plain.
//   2. A persistent grid (SMs x CTAs per SM) takes items from an atomic
//      counter. Per item a CTA walks the dimension blocks over the whole
//      bucket (the TPU's order: the in-bucket bound sees every alive row).
//      Per block it stages the dblk-slices of the rows alive for ANY of the
//      item's queries into shared memory, in row tiles of about 16 KB,
//      with cp.async (16 bytes a thread, a warp a row) into a ring of
//      NSTAGE = 2 buffers, so that the next tile's copy overlaps this
//      tile's dots. A row slice so leaves HBM once per item, and rows dead
//      for every query of the item cost no bytes. The norms the bounds
//      read (the bucket's row norms, the block norms of the alive rows)
//      are loaded into shared memory once per item and block, all at
//      once, and never inside a dependent loop.
//      The dots run on CUDA cores (the f32 and bf16 arms multiply an f32
//      query; an item holds few queries, so an MMA tile would be mostly
//      padding). A warp takes a row at a time: lane l owns the columns
//      4l..4l+3 of each 128-column segment, keeps the item's query values
//      there (and, for sq8, the codec) in registers for the whole block,
//      reads the row's four values once (each code decoded once, by its
//      lane) and keeps one sum per query; a reduce-scatter over the warp
//      (fold) adds the lanes. Its code is instantiated for 1, 2, 4 and 8
//      queries, and the lane offsets and FMA order do not depend on that,
//      so a pair's dot is the same in every item.
//   3. The block epilogue runs on every warp: the in-bucket k-th largest
//      lower bound of each query on the warps w = q (mod nq), each over a
//      share of the rows, merged by warp q; the bounds and the prune
//      decision of every (query, row) pair, one row per thread; an
//      order-preserving block-wide compaction of the alive rows. The
//      survivors' final scores go into each query's list (one warp per
//      query) after the last block.
//   4. Thresholds: each query's finished items publish their k-th best by
//      atomicMax on its ordered image; every check reads it. A seed launch
//      of the same kernel runs first, one CTA per query over the first 2k
//      valid rows of its rank-0 bucket, and publishes their k-th best:
//      those rows are scanned again by the main launch with the same
//      arithmetic (a row's dot does not depend on the item or the tile),
//      so the seed is the exact score of k real candidates.
//   5. Each (query, rank) pair writes its item's k candidates to [b,
//      budget, k] at its rank (unprobed ranks stay -inf), and
//      merge_candidates picks the k best; stats lanes go to stats[q] by
//      integer atomicAdd.

#include <type_traits>

#include "probe_items.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int QT = 8;                     // queries per item (<= NWARPS)
constexpr int SEG = 128;                  // columns a warp's lanes hold
constexpr int STAGE_BYTES = 16384;        // one stage buffer, about
constexpr int NSTAGE = 2;                 // stage buffers in the ring

static_assert(QT <= 8 && QT <= NWARPS, "a query takes a warp in the "
              "merges, a bit of the byte mask and a slot of the 8-query "
              "dots");

struct Args {
  const int* vprobes;
  const float* queries;
  const float* qpsq;
  const void* buckets;
  dingo::Codec codec;
  const float* bsq;
  const float* sqnorm;
  const unsigned char* valid;
  const int* slot;
  int b, budget, nbuckets, cap, d, dblk, k, ascending, check_every, inbucket;
  int* thr;         // [b] ordered image of each query's published k-th best
  int* stats;       // [b, 4]
  int* staged;      // [1] or null: row slices staged
  const int* pairs;        // work list (see build_items)
  const int* item_bucket;
  const int* item_first;
  const int* item_count;
  int* counters;    // [0] items, [1] next item to take
  float* cand_v;    // [b, budget, k]
  int* cand_i;
};

// Shared memory of a CTA, offsets in bytes. qsl [QT, ldq] holds the
// item's query slices of the current block and cdc [2, ldq] its codec
// slice (sq8: scale, vmin), cum [QT, cap] the partial dots of every
// (query, row) pair of the item, xsq [cap] the rows' norms and xps [cap]
// their prefix block norms, alive [cap] the rows alive for some query,
// msk [cap] a bit per query, stage a ring of NSTAGE buffers of rt row
// slices (srow bytes each).
struct Layout {
  size_t qsl, cdc, cum, xsq, xps, alive, msk, stage, topv, topi, tmpv,
      total;
  int ldq, ldc, srow, rt;
};

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 15) & ~size_t(15);
  return at;
}

__host__ __device__ inline Layout layout_of(int cap, int dblk, int k,
                                            int esize) {
  Layout L;
  size_t o = 0;
  L.ldq = (dblk + 3) & ~3;
  L.ldc = cap + 1;   // the queries' cum rows in distinct banks
  L.srow = (dblk * esize + 15) & ~15;
  // rows a tile: a multiple of 16 between 16 and 128, about STAGE_BYTES
  L.rt = STAGE_BYTES / L.srow / 16 * 16;
  L.rt = L.rt < 16 ? 16 : L.rt > 128 ? 128 : L.rt;
  L.qsl = take(o, sizeof(float) * QT * L.ldq);
  L.cdc = take(o, sizeof(float) * 2 * L.ldq);
  L.cum = take(o, sizeof(float) * QT * (size_t)L.ldc);
  L.xsq = take(o, sizeof(float) * (size_t)cap);
  L.xps = take(o, sizeof(float) * (size_t)cap);
  L.alive = take(o, sizeof(int) * (size_t)cap);
  L.msk = take(o, (size_t)cap);
  L.stage = take(o, (size_t)NSTAGE * L.rt * L.srow);
  L.topv = take(o, sizeof(float) * QT * k);
  L.topi = take(o, sizeof(int) * QT * k);
  L.tmpv = take(o, sizeof(float) * NWARPS * k);
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order-preserving block-wide append: each thread offers `row` when `keep`
// holds; kept rows land at list[running...] in thread order. Returns the
// new length (the same in every thread). Callers read the list positions
// they compact in place before the call: the first barrier orders those
// reads before any write.
__device__ __forceinline__ int block_append(int* list, int running,
                                            bool keep, int row, int* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(dingo::FULL_MASK, keep);
  if (lane == 0) wcnt[warp] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const int c = wcnt[w];
    total += c;
    if (w < warp) before += c;
  }
  __syncthreads();
  if (keep) list[running + before + __popc(m & ((1u << lane) - 1u))] = row;
  return running + total;
}

// Ballot-filtered insertion of one value per lane into a warp's sorted
// list in shared memory (vals, ids; ids may be null), of the values
// above max(base, the list's k-th).
__device__ __forceinline__ void warp_offer(float* vals, int* ids, int k,
                                           float base, float v, int id) {
  float t = fmaxf(base, vals[k - 1]);
  unsigned m = __ballot_sync(dingo::FULL_MASK, v > t);
  while (m) {
    const int src = __ffs(m) - 1;
    dingo::warp_insert(vals, ids, k, __shfl_sync(dingo::FULL_MASK, v, src),
                       __shfl_sync(dingo::FULL_MASK, id, src));
    t = fmaxf(base, vals[k - 1]);
    m &= ~(1u << src);
    m &= __ballot_sync(dingo::FULL_MASK, v > t);
  }
}

// Stage tile t of the alive list (block columns j0..j0+dblk) into ring
// buffer t % NSTAGE: 16-byte cp.async chunks with VEC, else element loads.
// The caller commits the group.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_tile(const Args& a, const Layout& L,
                                           unsigned char* stage,
                                           const int* alive, int nalive,
                                           int t, size_t bbase, int j0) {
  const int r0 = t * L.rt, nrows = min(L.rt, nalive - r0);
  unsigned char* buf = stage + (size_t)(t % NSTAGE) * L.rt * L.srow;
  const T* rows = static_cast<const T*>(a.buckets);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nrows; i += NWARPS) {   // a warp a row
    const T* src = rows + (bbase + alive[r0 + i]) * a.d + j0;
    unsigned char* dst = buf + (size_t)i * L.srow;
    if (VEC) {
      const int nch = a.dblk * (int)sizeof(T) / 16;
      for (int c = lane; c < nch; c += 32)
        cp_async16(dst + c * 16,
                   reinterpret_cast<const unsigned char*>(src) + c * 16);
    } else {
      for (int c = lane; c < a.dblk; c += 32)
        reinterpret_cast<T*>(dst)[c] = src[c];
    }
  }
  if (a.staged != nullptr && threadIdx.x == 0) atomicAdd(a.staged, nrows);
}

// Four values of a staged row at columns col..col+3 as the arm multiplies
// them (0 past s1): one 16-byte load of f32, 8 bytes of bf16 or 4 codes
// (rows start 16-byte aligned in shared memory), element loads at a
// ragged end. sq8 codes decode here with the lane's codec of those
// columns (sc, vm): each staged code is decoded once, by the one lane
// that owns its column.
template <typename T>
__device__ __forceinline__ void row4(const unsigned char* rowp, int col,
                                     int s1, const float* sc,
                                     const float* vm, float (&x)[4]) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    unsigned w = 0;
    if (col + 4 <= s1) {
      w = *reinterpret_cast<const unsigned*>(rowp + col);
    } else {
      for (int e = 0; e < 4 && col + e < s1; ++e)
        w |= (unsigned)rowp[col + e] << (8 * e);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = col + e < s1
                 ? dingo::sq_decode((float)((w >> (8 * e)) & 0xffu), sc[e],
                                    vm[e])
                 : 0.f;
  } else if (col + 4 <= s1) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(rowp + col * 4);
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(rowp + col * 2);
      x[0] = __uint_as_float(r.x << 16);
      x[1] = __uint_as_float(r.x & 0xffff0000u);
      x[2] = __uint_as_float(r.y << 16);
      x[3] = __uint_as_float(r.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = col + e < s1 ? dingo::row_value(
                                reinterpret_cast<const T*>(rowp)[col + e], 0,
                                dingo::Codec{})
                          : 0.f;
  }
}

// Four floats of a shared-memory row at columns c..c+3 (0 past s1): one
// 16-byte load where all four are in range (rows are 16-byte aligned and
// c a multiple of 4).
__device__ __forceinline__ void load4(const float* row, int c, int s1,
                                      float (&out)[4]) {
  if (c + 4 <= s1) {
    const float4 f = *reinterpret_cast<const float4*>(row + c);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = c + e < s1 ? row[c + e] : 0.f;
  }
}

// QN per-query sums of every lane folded over the warp (clobbers v): a
// reduce-scatter halves the values at lane offsets 16, 8, ... while more
// than one is left, plain xor steps finish. Lane l returns query
// l / (32 / QN)'s dot. The offsets always run 16, 8, 4, 2, 1 and IEEE
// addition commutes, so a query's dot is the same for every QN.
template <int QN>
__device__ __forceinline__ float fold(float (&v)[QN]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = QN, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool hi = lane & off;
#pragma unroll
    for (int j = 0; j < n / 2; ++j)
      v[j] = (hi ? v[j + n / 2] : v[j]) +
             __shfl_xor_sync(dingo::FULL_MASK, hi ? v[j] : v[j + n / 2],
                             off);
  }
  float z = v[0];
#pragma unroll
  for (int off = 16 / QN; off > 0; off >>= 1)
    z += __shfl_xor_sync(dingo::FULL_MASK, z, off);
  return z;
}

// A lane's operands of the SEG-column segment at s0: the item's query
// values at the lane's columns 4l..4l+3 (0 for missing queries and past
// the block) and, for sq8 codes, the codec there.
struct LaneCols {
  float q[QT][4], sc[4], vm[4];
};

__device__ __forceinline__ void load_cols(const Layout& L, const float* qsl,
                                          const float* cdc, bool sq, int s0,
                                          int dblk, int nq, LaneCols& lc) {
  const int c = s0 + 4 * (threadIdx.x & 31), s1 = min(dblk, s0 + SEG);
#pragma unroll
  for (int k = 0; k < QT; ++k)
    load4(qsl + (k < nq ? k : 0) * L.ldq, c, k < nq ? s1 : 0, lc.q[k]);
  if (sq) {
    load4(cdc, c, s1, lc.sc);
    load4(cdc + L.ldq, c, s1, lc.vm);
  }
}

// Partial dots of a staged tile (row slices at buf, srow bytes apart, of
// element type T) with the item's nq <= QN queries, for the segment at
// s0; adds them to cum (assigns at block 0). A warp takes a row at a time,
// two rows a step: lane l reads the row's four values at the segment's
// columns 4l..4l+3 once (each staged byte is read from shared memory
// once, each code decoded once), multiplies them with the queries'
// values it holds there (lc) and keeps QN sums; fold adds the lanes. A
// pair's dot is so the same whatever the item, its size, the tile or the
// row's place in it.
template <typename T, int QN>
__device__ __forceinline__ void tile_dots(const Layout& L,
                                          const unsigned char* buf,
                                          const int* alive, int nalive,
                                          int t, const LaneCols& lc, int s0,
                                          int dblk, int nq, float* cum,
                                          int jb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = t * L.rt, nrows = min(L.rt, nalive - r0);
  const int col = s0 + 4 * lane, s1 = min(dblk, s0 + SEG);
  const int q = lane / (32 / QN);
  const bool first = jb == 0 && s0 == 0;
  for (int i0 = warp; i0 < nrows; i0 += 2 * NWARPS) {
    const int i1 = i0 + NWARPS;
    const bool two = i1 < nrows;
    float x0[4], x1[4], v0[QN], v1[QN];
    row4<T>(buf + (size_t)i0 * L.srow, col, s1, lc.sc, lc.vm, x0);
    row4<T>(buf + (size_t)(two ? i1 : i0) * L.srow, col, s1, lc.sc, lc.vm,
            x1);
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      v0[k] = v1[k] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v0[k] = fmaf(lc.q[k][e], x0[e], v0[k]);
        v1[k] = fmaf(lc.q[k][e], x1[e], v1[k]);
      }
    }
    const float d0 = fold<QN>(v0), d1 = fold<QN>(v1);
    if (lane % (32 / QN) == 0 && q < nq) {
      float* c0 = cum + (size_t)q * L.ldc + alive[r0 + i0];
      *c0 = first ? d0 : *c0 + d0;
      if (two) {
        float* c1 = cum + (size_t)q * L.ldc + alive[r0 + i1];
        *c1 = first ? d1 : *c1 + d1;
      }
    }
  }
}

// Persistent scan over the work list (seed = 0), or the seed launch (seed
// = 1: CTA q scans the first 2k valid rows of query q's rank-0 bucket and
// only publishes their k-th best).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ivf_pruned_kernel(const Args a, int seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(a.cap, a.dblk, a.k, (int)sizeof(T));
  float* qsl = reinterpret_cast<float*>(smem + L.qsl);
  float* cdc = reinterpret_cast<float*>(smem + L.cdc);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* xsq = reinterpret_cast<float*>(smem + L.xsq);
  float* xps = reinterpret_cast<float*>(smem + L.xps);
  int* alive = reinterpret_cast<int*>(smem + L.alive);
  unsigned char* msk = smem + L.msk;
  unsigned char* stage = smem + L.stage;
  float* topv = reinterpret_cast<float*>(smem + L.topv);
  int* topi = reinterpret_cast<int*>(smem + L.topi);
  float* tmpv = reinterpret_cast<float*>(smem + L.tmpv);
  __shared__ int s_q[QT], s_r[QT], s_nal[QT], s_st0[QT], s_st2[QT];
  __shared__ float s_qsq[QT], s_bnd[QT], s_qp[QT], s_qtail[QT];
  __shared__ int s_wcnt[NWARPS];
  __shared__ int s_bucket, s_nq;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = a.cap, d = a.d, dblk = a.dblk, k = a.k;
  const int nblk = d / dblk;
  // the sq8 arm pairs bf16 operands: its query rounds to bf16 where it is
  // staged, while ||q||^2 and qpsq stay those of the f32 query
  constexpr bool kRoundQ = std::is_same<T, uint8_t>::value;

  for (int iter = 0;; ++iter) {
    if (tid == 0) {
      int bucket = -1, nq = 0;
      if (seed) {
        if (iter == 0) {
          bucket = a.vprobes[(size_t)blockIdx.x * a.budget];
          nq = 1;
          s_q[0] = blockIdx.x;
          s_r[0] = 0;
        }
      } else {
        const int it = atomicAdd(a.counters + 1, 1);
        if (it < __ldcg(a.counters)) {
          bucket = a.item_bucket[it];
          nq = a.item_count[it];
          const int first = a.item_first[it];
          for (int i = 0; i < nq; ++i) {
            const int p = a.pairs[first + i];
            s_q[i] = p / a.budget;
            s_r[i] = p - s_q[i] * a.budget;
          }
        }
      }
      if (bucket < 0 || bucket >= a.nbuckets) nq = 0;
      s_bucket = bucket;
      s_nq = nq;
    }
    __syncthreads();
    const int nq = s_nq;
    if (nq == 0) return;
    const int bucket = s_bucket;
    const size_t bbase = (size_t)bucket * cap;

    // each query's norm (of the f32 query) and empty list, a warp each
    if (warp < nq) {
      const float* qg = a.queries + (size_t)s_q[warp] * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float v = qg[c];
        s = fmaf(v, v, s);
      }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
      if (lane == 0) {
        s_qsq[warp] = s;
        s_st0[warp] = 0;
        s_st2[warp] = 0;
      }
      dingo::list_init(topv + warp * k, topi + warp * k, k);
    }
    // the alive list: the bucket's valid rows in row order, alive for
    // every query of the item; their norms
    const unsigned char full = (unsigned char)((1u << nq) - 1u);
    int nvalid = 0;
    for (int base = 0; base < cap; base += THREADS) {
      const int row = base + tid;
      const bool v = row < cap && a.valid[bbase + row];
      if (v) {
        msk[row] = full;
        xsq[row] = a.sqnorm[bbase + row];
      }
      nvalid = block_append(alive, nvalid, v, row, s_wcnt);
    }
    int nalive = seed ? min(nvalid, 2 * k) : nvalid;
    if (tid < nq) s_nal[tid] = nalive;
    __syncthreads();

    for (int jb = 0; jb < nblk; ++jb) {
      const bool last = jb == nblk - 1;
      if (tid < nq) {
        s_st0[tid] += s_nal[tid];
        if (last) s_st2[tid] += s_nal[tid];
      }
      if (nalive == 0) break;
      const int j0 = jb * dblk;
      for (int e = tid; e < nq * dblk; e += THREADS) {
        const int q = e / dblk, c = e - q * dblk;
        const float v = a.queries[(size_t)s_q[q] * d + j0 + c];
        qsl[q * L.ldq + c] = kRoundQ ? dingo::round_bf16(v) : v;
      }
      if (kRoundQ)
        for (int c = tid; c < dblk; c += THREADS) {
          cdc[c] = a.codec.scale[j0 + c];
          cdc[L.ldq + c] = a.codec.vmin[j0 + c];
        }
      // the alive rows' prefix block norms, all loads in flight at once
      const float* bsq = a.bsq + ((size_t)bucket * nblk + jb) * cap;
      for (int p = tid; p < nalive; p += THREADS) {
        const int row = alive[p];
        xps[row] = jb == 0 ? bsq[row] : xps[row] + bsq[row];
      }
      // the ring: NSTAGE - 1 tiles in flight ahead of the one multiplied;
      // the barrier at a tile's turn also frees the buffer read last turn
      const int ntiles = (nalive + L.rt - 1) / L.rt;
      LaneCols lc;
      for (int t = 0; t < NSTAGE - 1; ++t) {
        if (t < ntiles)
          stage_tile<T, VEC>(a, L, stage, alive, nalive, t, bbase, j0);
        cp_async_commit();
      }
      for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        if (t + NSTAGE - 1 < ntiles)
          stage_tile<T, VEC>(a, L, stage, alive, nalive, t + NSTAGE - 1,
                             bbase, j0);
        cp_async_commit();
        const unsigned char* buf =
            stage + (size_t)(t % NSTAGE) * L.rt * L.srow;
        for (int s0 = 0; s0 < dblk; s0 += SEG) {
          // a block of one segment keeps its lane operands for every tile
          if (t == 0 || dblk > SEG)
            load_cols(L, qsl, cdc, kRoundQ, s0, dblk, nq, lc);
          if (nq == 1)
            tile_dots<T, 1>(L, buf, alive, nalive, t, lc, s0, dblk, nq, cum,
                            jb);
          else if (nq == 2)
            tile_dots<T, 2>(L, buf, alive, nalive, t, lc, s0, dblk, nq, cum,
                            jb);
          else if (nq <= 4)
            tile_dots<T, 4>(L, buf, alive, nalive, t, lc, s0, dblk, nq, cum,
                            jb);
          else
            tile_dots<T, 8>(L, buf, alive, nalive, t, lc, s0, dblk, nq, cum,
                            jb);
        }
      }
      __syncthreads();

      if (last) {
        // the survivors' final scores into their query's list, a warp each
        if (warp < nq) {
          const int qi = s_q[warp];
          const float qp = a.qpsq[(size_t)qi * nblk + jb];
          float* tv = topv + warp * k;
          int* ti = topi + warp * k;
          const float* cq = cum + (size_t)warp * L.ldc;
          for (int p0 = 0; p0 < nalive; p0 += 32) {
            const int p = p0 + lane;
            float sc = -CUDART_INF_F;
            int sid = -1;
            if (p < nalive) {
              const int row = alive[p];
              if ((msk[row] >> warp) & 1) {
                sc = a.ascending ? -((qp - 2.0f * cq[row]) + xps[row])
                                 : cq[row];
                sid = a.slot[bbase + row];
              }
            }
            warp_offer(tv, ti, k, -CUDART_INF_F, sc, sid);
          }
          if (lane == 0 && tv[k - 1] > -CUDART_INF_F)
            atomicMax(a.thr + qi, dingo::ord_of(tv[k - 1]));
        }
      } else if ((jb + 1) % a.check_every == 0) {
        if (tid < nq) {
          const float qp = a.qpsq[(size_t)s_q[tid] * nblk + jb];
          s_qp[tid] = qp;
          s_qtail[tid] = fmaxf(s_qsq[tid] - qp, 0.f);
          s_bnd[tid] = dingo::float_of(__ldcg(a.thr + s_q[tid]));
          s_nal[tid] = 0;
        }
        __syncthreads();
        if (a.inbucket) {
          // k-th largest lower bound of each query over its alive rows:
          // warps w = q (mod nq) each take a share of the rows, above the
          // current threshold only, and warp q merges their lists
          const int q = warp % nq, share = warp / nq;
          const int nshare = (NWARPS - 1 - q) / nq + 1;
          float* tv = tmpv + warp * k;
          for (int c = lane; c < k; c += 32) tv[c] = -CUDART_INF_F;
          __syncwarp();
          const float base = s_bnd[q], qp = s_qp[q], qtail = s_qtail[q];
          const float* cq = cum + (size_t)q * L.ldc;
          for (int p0 = share * 32; p0 < nalive; p0 += nshare * 32) {
            const int p = p0 + lane;
            float lb = -CUDART_INF_F;
            if (p < nalive) {
              const int row = alive[p];
              if ((msk[row] >> q) & 1)
                lb = dingo::bounds_of(cq[row], xps[row], xsq[row], qp,
                                      qtail, a.ascending).lb;
            }
            warp_offer(tv, nullptr, k, base, lb, -1);
          }
          __syncthreads();
          if (warp < nq) {
            for (int w2 = warp + nq; w2 < NWARPS; w2 += nq)
              for (int c0 = 0; c0 < k; c0 += 32) {
                const float v = c0 + lane < k ? tmpv[w2 * k + c0 + lane]
                                              : -CUDART_INF_F;
                warp_offer(tv, nullptr, k, base, v, -1);
              }
            __syncwarp();
            if (lane == 0) s_bnd[warp] = fmaxf(base, tv[k - 1]);
          }
          __syncthreads();
        }
        // drop the pairs whose upper bound is strictly below their query's
        // threshold, a row per thread; compact the rows still alive for
        // some query, in order
        int cnt[QT];
#pragma unroll
        for (int q = 0; q < QT; ++q) cnt[q] = 0;
        int running = 0;
        for (int p0 = 0; p0 < nalive; p0 += THREADS) {
          const int p = p0 + tid;
          int row = -1;
          unsigned m = 0;
          if (p < nalive) {
            row = alive[p];
            m = msk[row];
            const float xp = xps[row], xs = xsq[row];
#pragma unroll
            for (int q = 0; q < QT; ++q) {
              if (q < nq && ((m >> q) & 1)) {
                const float ub = dingo::bounds_of(cum[(size_t)q * L.ldc + row],
                                                  xp, xs, s_qp[q],
                                                  s_qtail[q], a.ascending).ub;
                if (ub < s_bnd[q]) m &= ~(1u << q);
              }
              cnt[q] += (m >> q) & 1;
            }
            msk[row] = (unsigned char)m;
          }
          running = block_append(alive, running, m != 0, row, s_wcnt);
        }
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          int c = cnt[q];
          for (int off = 16; off > 0; off >>= 1)
            c += __shfl_xor_sync(dingo::FULL_MASK, c, off);
          if (lane == 0 && q < nq && c) atomicAdd(&s_nal[q], c);
        }
        nalive = running;
      }
      __syncthreads();
    }

    __syncthreads();
    if (!seed && warp < nq) {
      const size_t cb = ((size_t)s_q[warp] * a.budget + s_r[warp]) * k;
      for (int c = lane; c < k; c += 32) {
        a.cand_v[cb + c] = topv[warp * k + c];
        a.cand_i[cb + c] = topi[warp * k + c];
      }
      if (lane < 4) {
        const int v = lane == 0   ? s_st0[warp]
                      : lane == 1 ? nvalid * nblk
                      : lane == 2 ? s_st2[warp]
                                  : nvalid;
        atomicAdd(a.stats + (size_t)s_q[warp] * 4 + lane, v);
      }
    }
    if (seed) return;
    __syncthreads();
  }
}

template <typename T>
int launch(Args a, int vec, int seed, int* work, float* out_v, int* out_i,
           void* stream) {
  if (a.k < 1 || a.k > dingo::K_MAX || a.b < 1 || a.budget < 1 ||
      a.cap < 1 || a.d < 1 || a.dblk < 1 || a.d % a.dblk != 0 ||
      a.check_every < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n = a.b * a.budget;
  int rc = dingo::build_items<QT>(a.vprobes, a.b, a.budget, a.nbuckets,
                                  a.k, work, a.cand_v, a.cand_i, st);
  if (rc != 0) return rc;
  a.pairs = work;
  a.item_bucket = work + 4 * (size_t)n;
  a.item_first = work + 5 * (size_t)n;
  a.item_count = work + 6 * (size_t)n;
  a.counters = work + 7 * (size_t)n;
  const size_t smem = layout_of(a.cap, a.dblk, a.k, (int)sizeof(T)).total;
  auto kernel = vec ? ivf_pruned_kernel<T, true> : ivf_pruned_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (seed) {
    kernel<<<a.b, THREADS, smem, st>>>(a, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<min(n, per_sm * sms), THREADS, smem, st>>>(a, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<a.b, 256, 0, st>>>(
      a.cand_v, a.cand_i, a.budget * a.k, a.k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Queries per item; the wrapper checks it against its own QT.
int dingo_ivf_pruned_qt() { return QT; }

// The work list alone (the scan builds its own): vprobes[b, budget] i32;
// work[7 b budget + 2] i32 as build_items lays it out.
int dingo_ivf_pruned_items(const int* vprobes, int b, int budget,
                           int nbuckets, int* work, void* stream) {
  if (b < 1 || budget < 1) return (int)cudaErrorInvalidValue;
  return dingo::build_items<QT>(vprobes, b, budget, nbuckets, 1, work,
                                nullptr, nullptr,
                                reinterpret_cast<cudaStream_t>(stream));
}

// vprobes[b, budget] i32; queries[b, d] f32; qpsq[b, nblk] f32 inclusive
// per-block prefix norms; buckets[nbuckets, cap, d] f32, bf16 (_bf16) or
// uint8 codes with vmin/scale [d] f32 (_sq8);
// bucket_bsq[nbuckets, nblk, cap] f32; bucket_sqnorm[nbuckets, cap] f32;
// bucket_valid[nbuckets, cap] bytes; bucket_slot[nbuckets, cap] i32.
// thr_shared[b] i32 holds ord_of(-inf) on entry; stats[b, 4] i32 zeros;
// work[7 b budget + 2] i32 scratch; staged[1] i32 zero or null;
// cand_v/cand_i: [b, budget, k] scratch; out_v/out_i: [b, k]. vec = d and
// dblk multiples of 4 (f32), 8 (bf16) or 16 (sq8) with 16-byte aligned
// rows; seed = run the seed launch. Returns cudaGetLastError() after the
// launches (work list, seed, scan, merge).
#define DINGO_B3_ARGS                                                        \
  const int *vprobes, const float *queries, const float *qpsq,              \
      const float *bucket_bsq, const float *bucket_sqnorm,                  \
      const unsigned char *bucket_valid, const int *bucket_slot, int b,     \
      int budget, int nbuckets, int cap, int d, int dblk, int k,            \
      int ascending, int check_every, int inbucket, int vec, int seed,      \
      int *thr_shared, int *stats, int *work, int *staged, float *cand_v,   \
      int *cand_i, float *out_v, int *out_i, void *stream
#define DINGO_B3_PASS(T, buckets, codec)                                     \
  launch<T>(Args{vprobes, queries, qpsq, buckets, codec, bucket_bsq,        \
                 bucket_sqnorm, bucket_valid, bucket_slot, b, budget,       \
                 nbuckets, cap, d, dblk, k, ascending, check_every,         \
                 inbucket, thr_shared, stats, staged, nullptr, nullptr,     \
                 nullptr, nullptr, nullptr, cand_v, cand_i},                \
            vec, seed, work, out_v, out_i, stream)

int dingo_ivf_pruned_topk(const float* buckets, DINGO_B3_ARGS) {
  return DINGO_B3_PASS(float, buckets, (dingo::Codec{nullptr, nullptr}));
}

int dingo_ivf_pruned_topk_bf16(const __nv_bfloat16* buckets,
                               DINGO_B3_ARGS) {
  return DINGO_B3_PASS(__nv_bfloat16, buckets,
                       (dingo::Codec{nullptr, nullptr}));
}

int dingo_ivf_pruned_topk_sq8(const uint8_t* buckets, const float* vmin,
                              const float* scale, DINGO_B3_ARGS) {
  return DINGO_B3_PASS(uint8_t, buckets, (dingo::Codec{vmin, scale}));
}

}  // extern "C"
