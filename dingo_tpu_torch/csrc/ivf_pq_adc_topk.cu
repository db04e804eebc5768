// Kernel B5: IVF_PQ Quick-ADC probed-bucket scan + running top-k.
//
// Replaces dingo_tpu/ops/pallas_pq.py::ivf_pq_adc_topk (body _adc_kernel).
// For each query and each of its `budget` virtual probes (bucket ids, -1 =
// padded rank, skipped), scans the bucket's [cap, m] uint8 codes against the
// residual look-up table of the probe's coarse rank, lut_all[q,
// coarse_pos[q, r], m, ksub]: dist = sum_j lut[j, code_j], score = -dist over
// valid rows (-inf elsewhere), and keeps the k best (score, slot) pairs; -1
// where the score is -inf. k <= 64.
//
// What bounds it on an H100: bytes. A row costs m table lookups and m adds
// against m code bytes, far below the card's operation rate; the least time
// is the distinct (query, coarse rank) tables the batch reads (m * ksub * 4
// bytes each, 96 KiB at m 96) plus the distinct probed buckets' codes, valid
// flags and slots, over 3.35 TB/s.
//
// Design: the TPU kernel keeps the rank's table resident in VMEM and does
// the lookup as a one-hot contraction on the MXU, 8 subspaces at a time.
// Here a lookup is a lookup, and the work unit is one CTA per (query,
// coarse rank):
//   - the CTA reads its query's `budget` (vprobe, coarse_pos) pairs and
//     keeps, in budget order, every valid probe whose coarse_pos is its
//     rank (no order is assumed); a rank with none writes -inf / -1 and
//     exits, so each rank's table is read once, however many spill buckets
//     share it;
//   - one thread starts the table's TMA bulk copies (cp.async.bulk into
//     shared memory, completion on an mbarrier) as the CTA starts, for any
//     query that probes something, while the CTA reads its probe list, and
//     every thread stages its first code pieces with cp.async into a
//     two-buffer ring of 16-byte pieces, so code bytes flow while the table
//     lands. At m 96 / ksub 256 the table, the ring, the candidate buffer
//     and the list take ~109 KB: two CTAs per SM (one at larger m * ksub).
//     A 16-byte piece of a 96-byte row uses half of each 32-byte sector it
//     brings; measured at the smoke's shapes, a third ring stage, a
//     register queue of four pieces and L1-allocating copies were slower,
//     and a whole-row ring of 256 rows (48 KB) would leave one CTA per SM;
//   - one thread per code row sums the table entries in subspace order in
//     f32, one add per subspace, so a row's score has the same bits
//     whichever CTA, step or code path computes it;
//   - selection is block-wide: after every SEG rows (or the end of a
//     bucket) the rows above the running k-th best are compacted with a
//     ballot and a warp prefix count, keyed by the order-preserving uint32
//     image of their scores. Each warp sorts 64 of them in registers (a
//     bitonic network over shuffles), the sorted chunks merge pairwise in
//     a tree (a bitonic half-cleaner and six steps each), and warp 0 merges
//     the result into the running list of the best 64; its k-th entry is
//     the next threshold. Equal scores order by slot, so the pick is
//     deterministic; against the plain version, ties may differ.
// Output is [b, nprobe, k] candidates, one sorted list per (query, rank).
// A second kernel streams each query's nprobe * k candidates through the
// same pick (one CTA a query) into [b, k].

#include "topk_common.cuh"

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// rows scored between two selections (two row groups of THREADS)
constexpr int SEG = 2 * THREADS;
// the running list's padded length (the bitonic sort's width)
constexpr int LIST = dingo::K_MAX;
static_assert(LIST == 64 && SEG / 64 <= NWARPS,
              "select_step sorts one 64-entry chunk of a step per warp");
// TMA bulk copies of the table go in pieces of at most this many bytes
constexpr int BULK_PIECE = 32768;

// Order-preserving image of a score: a > b iff key(a) > key(b), and every
// non-NaN score maps above 0, which marks an empty entry or invalid row.
__device__ __forceinline__ uint32_t key_of(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float score_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- the table's TMA bulk copy, completed on an mbarrier --------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: the rank's [m, ksub] table into shared memory by TMA bulk
// copies, completing on bar (phase 0).
__device__ __forceinline__ void start_table_copy(float* lut, const float* src,
                                            int tsize, uint64_t* bar) {
  mbar_init(bar, 1);
  const uint32_t bytes = (uint32_t)tsize * 4u;
  mbar_expect_tx(bar, bytes);
  for (uint32_t o = 0; o < bytes; o += BULK_PIECE)
    bulk_copy(reinterpret_cast<unsigned char*>(lut) + o,
              reinterpret_cast<const unsigned char*>(src) + o,
              min((uint32_t)BULK_PIECE, bytes - o), bar);
}

// -- the code ring: 16-byte pieces, zero-filled past the bucket's rows -----
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool have) {
  // .cg (L2 only): measured faster than .ca here (H100 80GB HBM3)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(have ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Adds the four table entries a 32-bit word of codes selects (subspaces j,
// j + 1, j + 2, j + 3; lut_j points at subspace j's table), in order.
__device__ __forceinline__ float add_word(float s, uint32_t w,
                                          const float* lut_j, int ksub) {
  s += lut_j[w & 0xffu];
  s += lut_j[ksub + ((w >> 8) & 0xffu)];
  s += lut_j[2 * ksub + ((w >> 16) & 0xffu)];
  s += lut_j[3 * ksub + (w >> 24)];
  return s;
}

// Sixteen subspaces from one 16-byte piece of codes, in order.
__device__ __forceinline__ float add_piece(float s, uint4 w, const float* l,
                                           int ksub) {
  s = add_word(s, w.x, l, ksub);
  s = add_word(s, w.y, l + 4 * ksub, ksub);
  s = add_word(s, w.z, l + 8 * ksub, ksub);
  return add_word(s, w.w, l + 12 * ksub, ksub);
}

// ADC distance of one code row read straight from global memory. VEC =
// bytes per load (8, 4 or 1); the caller guarantees m % VEC == 0 and a
// VEC-aligned row. (16-byte rows go through the ring instead.)
template <int VEC>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row,
                                         const float* lut, int m, int ksub) {
  float s = 0.f;
  if constexpr (VEC == 8) {
    const uint2* p = reinterpret_cast<const uint2*>(row);
    for (int c = 0; c < m / 8; ++c) {
      const uint2 w = __ldg(p + c);
      const float* l = lut + (size_t)c * 8 * ksub;
      s = add_word(s, w.x, l, ksub);
      s = add_word(s, w.y, l + 4 * ksub, ksub);
    }
  } else if constexpr (VEC == 4) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row);
    for (int c = 0; c < m / 4; ++c)
      s = add_word(s, __ldg(p + c), lut + (size_t)c * 4 * ksub, ksub);
  } else {
    for (int j = 0; j < m; ++j) s += lut[(size_t)j * ksub + __ldg(row + j)];
  }
  return s;
}

// The CTA's shared state beside the table and the ring.
struct Lists {
  uint32_t* ckey;   // [SEG] candidates of the current step
  int* cslot;       // [SEG]
  uint32_t* lkey;   // [LIST] running list, best first
  int* lslot;       // [LIST]
};

struct Scalars {
  int nbk;          // probes of this rank
  int ncand;        // candidates in the current step
  int wcnt[NWARPS];
};

// The order of the pick: a higher key first, then the lower slot (only
// empty entries, key 0 and slot -1, are ever equal).
__device__ __forceinline__ bool before(uint32_t ka, int sa, uint32_t kb,
                                       int sb) {
  return ka > kb || (ka == kb && sa < sb);
}

// 64 (key, slot) pairs in a warp's registers: element lane in (k0, s0),
// element lane + 32 in (k1, s1).
struct Pairs {
  uint32_t k0, k1;
  int s0, s1;
};

// One compare-exchange step of a bitonic network at stride < 32 on the
// element e = lane + 32 h held in (k, s): it keeps the pair's first element
// (in the pick's order) when e is the lower index of a descending block or
// the upper index of an ascending one.
__device__ __forceinline__ void cx_lanes(uint32_t& k, int& s, int e,
                                         int stride, bool desc) {
  const uint32_t pk = __shfl_xor_sync(dingo::FULL_MASK, k, stride);
  const int ps = __shfl_xor_sync(dingo::FULL_MASK, s, stride);
  const bool lower = (e & stride) == 0;
  const bool mine_first = before(k, s, pk, ps);
  if (mine_first != (lower == desc)) {
    k = pk;
    s = ps;
  }
}

// The stride-32 step: elements lane and lane + 32 sit in one lane.
__device__ __forceinline__ void cx_halves(Pairs& p) {
  if (before(p.k1, p.s1, p.k0, p.s0)) {
    const uint32_t k = p.k0;
    const int s = p.s0;
    p.k0 = p.k1;
    p.s0 = p.s1;
    p.k1 = k;
    p.s1 = s;
  }
}

// Bitonic sort of the 64 pairs, best first (21 steps, no shared memory).
__device__ __forceinline__ void sort64(Pairs& p, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {
        cx_halves(p);
      } else {
        cx_lanes(p.k0, p.s0, lane, stride, (lane & size) == 0);
        cx_lanes(p.k1, p.s1, lane + 32, stride, ((lane + 32) & size) == 0);
      }
    }
  }
}

// a <- the best 64 of (a U b), best first; both sorted best first. The
// half-cleaner max(a[i], b[63 - i]) leaves a bitonic sequence that holds
// the best 64, which six descending steps sort.
__device__ __forceinline__ void merge64(Pairs& a, const Pairs& b, int lane) {
  const int src = 31 - lane;
  const uint32_t rk1 = __shfl_sync(dingo::FULL_MASK, b.k1, src);
  const int rs1 = __shfl_sync(dingo::FULL_MASK, b.s1, src);
  const uint32_t rk0 = __shfl_sync(dingo::FULL_MASK, b.k0, src);
  const int rs0 = __shfl_sync(dingo::FULL_MASK, b.s0, src);
  if (!before(a.k0, a.s0, rk1, rs1)) {
    a.k0 = rk1;
    a.s0 = rs1;
  }
  if (!before(a.k1, a.s1, rk0, rs0)) {
    a.k1 = rk0;
    a.s1 = rs0;
  }
  cx_halves(a);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    cx_lanes(a.k0, a.s0, lane, stride, true);
    cx_lanes(a.k1, a.s1, lane + 32, stride, true);
  }
}

__device__ __forceinline__ Pairs load64(const uint32_t* key, const int* slot,
                                        int base, int n, int lane) {
  Pairs p;
  const int i0 = base + lane, i1 = base + lane + 32;
  p.k0 = i0 < n ? key[i0] : 0u;
  p.s0 = i0 < n ? slot[i0] : -1;
  p.k1 = i1 < n ? key[i1] : 0u;
  p.s1 = i1 < n ? slot[i1] : -1;
  return p;
}

__device__ __forceinline__ void store64(uint32_t* key, int* slot, int base,
                                        const Pairs& p, int lane) {
  key[base + lane] = p.k0;
  slot[base + lane] = p.s0;
  key[base + lane + 32] = p.k1;
  slot[base + lane + 32] = p.s1;
}

// The running list <- its best LIST of (list U candidates ckey[0, n)).
// Called by every thread. Warp w sorts candidates [64 w, 64 w + 64) in
// registers, chunks are merged pairwise in a tree (a level per barrier),
// and warp 0 merges the last chunk into the list.
__device__ void select_step(const Lists& L, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = (n + 63) / 64;
  if (warp < nch) {
    Pairs p = load64(L.ckey, L.cslot, 64 * warp, n, lane);
    sort64(p, lane);
    store64(L.ckey, L.cslot, 64 * warp, p, lane);
  }
  __syncthreads();
  for (int span = 1; span < nch; span <<= 1) {
    const int left = 2 * warp * span, right = left + span;
    if (right < nch) {
      Pairs a = load64(L.ckey, L.cslot, 64 * left, SEG, lane);
      const Pairs b = load64(L.ckey, L.cslot, 64 * right, SEG, lane);
      merge64(a, b, lane);
      store64(L.ckey, L.cslot, 64 * left, a, lane);
    }
    __syncthreads();
  }
  if (warp == 0) {
    Pairs a = load64(L.lkey, L.lslot, 0, LIST, lane);
    const Pairs b = load64(L.ckey, L.cslot, 0, SEG, lane);
    merge64(a, b, lane);
    store64(L.lkey, L.lslot, 0, a, lane);
  }
  __syncthreads();
}

// A stream of (key, slot) offers from every thread, a row group at a time,
// folded into a running top-k. offer() compacts the keys above the running
// k-th best into the candidate buffer (a ballot and a warp prefix count);
// end_step() runs select_step when any thread offered one. At most
// SEG / THREADS groups may be offered between two end_step() calls.
struct Picker {
  Lists L;
  Scalars* S;
  int k;
  uint32_t thr;     // the running k-th best key (0: list not full)
  bool added;       // this thread offered a candidate since the last step

  __device__ void init(const Lists& lists, Scalars* sc, int k_) {
    L = lists;
    S = sc;
    k = k_;
    thr = 0u;
    added = false;
    for (int i = threadIdx.x; i < LIST; i += THREADS) {
      L.lkey[i] = 0u;
      L.lslot[i] = -1;
    }
    if (threadIdx.x == 0) S->ncand = 0;
    // the caller's next __syncthreads() publishes both
  }

  // slot is read only for a candidate
  __device__ __forceinline__ void offer(uint32_t key, const int* slot) {
    const int lane = threadIdx.x & 31;
    const bool cand = key > thr;
    const unsigned bal = __ballot_sync(dingo::FULL_MASK, cand);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&S->ncand, __popc(bal));
    base = __shfl_sync(dingo::FULL_MASK, base, 0);
    if (cand) {
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      L.ckey[pos] = key;
      L.cslot[pos] = *slot;
      added = true;
    }
  }

  __device__ __forceinline__ void end_step() {
    // a uniform decision; S->ncand is read before any thread can add to
    // it again (select_step's barriers come first)
    if (__syncthreads_or(added)) {
      select_step(L, S->ncand);
      thr = L.lkey[k - 1];
      if (threadIdx.x == 0) S->ncand = 0;
      __syncthreads();
    }
    added = false;
  }

  // the list's first k as (score, slot) pairs, -inf / -1 where empty
  __device__ void write(float* out_v, int* out_i) const {
    for (int c = threadIdx.x; c < k; c += THREADS) {
      const uint32_t key = L.lkey[c];
      out_v[c] = key ? score_of(key) : -CUDART_INF_F;
      out_i[c] = key ? L.lslot[c] : -1;
    }
  }
};

__device__ __forceinline__ Lists carve_lists(unsigned char* p) {
  Lists L;
  L.ckey = reinterpret_cast<uint32_t*>(p);
  L.cslot = reinterpret_cast<int*>(L.ckey + SEG);
  L.lkey = reinterpret_cast<uint32_t*>(L.cslot + SEG);
  L.lslot = reinterpret_cast<int*>(L.lkey + LIST);
  return L;
}
constexpr size_t LISTS_BYTES = (size_t)SEG * 8 + (size_t)LIST * 8;

// Code pieces of the rows a thread scans, in scan order: piece c of row
// (g % gpb) * THREADS + tid of bucket blist[g / gpb], for row group g.
struct PieceCursor {
  const uint8_t* codes;
  const int* blist;
  int nbk, gpb, cap, m, npiece;
  int piece, gb, bi;

  __device__ __forceinline__ const uint8_t* next(bool& have) {
    const int row = gb * THREADS + threadIdx.x;
    have = bi < nbk && row < cap;
    const uint8_t* p =
        have ? codes + ((size_t)blist[bi] * cap + row) * m + 16 * piece
             : codes;
    if (++piece == npiece) {
      piece = 0;
      if (++gb == gpb) {
        gb = 0;
        ++bi;
      }
    }
    return p;
  }
};

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
adc_rank_kernel(const int* __restrict__ vprobes,
                const int* __restrict__ coarse_pos,
                const float* __restrict__ lut_all,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ bucket_valid,
                const int* __restrict__ bucket_slot, int budget, int nprobe,
                int nbuckets, int cap, int m, int ksub, int k, int lut_bulk,
                float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ Scalars S;
  const int tsize = m * ksub;
  const int tpad = (tsize + 3) & ~3;
  float* lut = reinterpret_cast<float*>(smem_raw);             // [m, ksub]
  uint4* ring = reinterpret_cast<uint4*>(lut + tpad);          // [2][THREADS]
  const int nring = VEC == 16 ? 2 * THREADS : 0;
  const Lists lists = carve_lists(reinterpret_cast<unsigned char*>(
      ring + nring));
  int* blist = reinterpret_cast<int*>(lists.lslot + LIST);     // [budget]

  const int rank = blockIdx.x, qi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t out_base = ((size_t)qi * nprobe + rank) * k;
  const float* src = lut_all + ((size_t)qi * nprobe + rank) * (size_t)tsize;

  // -- the table's TMA copies start at once for a query that probes
  // anything (a padded query's CTAs load nothing); the probe list is read
  // while they fly
  const bool speculate = lut_bulk && vprobes[(size_t)qi * budget] >= 0;
  if (speculate && tid == 0) start_table_copy(lut, src, tsize, &bar);

  // -- this rank's probes, in budget order ----------------------------------
  if (tid == 0) S.nbk = 0;
  for (int c0 = 0; c0 < budget; c0 += THREADS) {
    const int i = c0 + tid;
    int bkt = -1;
    bool take = false;
    if (i < budget) {
      bkt = vprobes[(size_t)qi * budget + i];
      take = coarse_pos[(size_t)qi * budget + i] == rank && bkt >= 0 &&
             bkt < nbuckets;
    }
    const unsigned bal = __ballot_sync(dingo::FULL_MASK, take);
    if (lane == 0) S.wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = S.nbk, all = 0;
    for (int w = 0; w < NWARPS; ++w) {
      if (w < warp) off += S.wcnt[w];
      all += S.wcnt[w];
    }
    if (take) blist[off + __popc(bal & ((1u << lane) - 1u))] = bkt;
    __syncthreads();
    if (tid == 0) S.nbk += all;
    __syncthreads();
  }
  const int nbk = S.nbk;
  if (nbk == 0) {            // no probe at this rank: nothing to scan
    if (speculate) mbar_wait(&bar, 0);   // no copy may outlive the CTA
    for (int c = tid; c < k; c += THREADS) {
      cand_v[out_base + c] = -CUDART_INF_F;
      cand_i[out_base + c] = -1;
    }
    return;
  }
  if (!lut_bulk) {
    for (int i = tid; i < tsize; i += THREADS) lut[i] = __ldg(src + i);
  } else if (!speculate && tid == 0) {
    start_table_copy(lut, src, tsize, &bar);
  }
  Picker pk;
  pk.init(lists, &S, k);

  // -- the row groups: bucket blist[g / gpb], rows (g % gpb) * THREADS + tid
  const int gpb = (cap + THREADS - 1) / THREADS;
  const int ngroups = nbk * gpb;
  const int npiece = VEC == 16 ? m / 16 : 1;
  PieceCursor fc{codes, blist, nbk, gpb, cap, m, npiece, 0, 0, 0};
  bool have;
  if constexpr (VEC == 16) {
    // the first pieces flow while the table lands
    for (int st = 0; st < 2; ++st) {
      const uint8_t* p = fc.next(have);
      cp_async16(ring + st * THREADS + tid, p, have);
      cp_async_commit();
    }
  }
  if (lut_bulk) mbar_wait(&bar, 0);
  __syncthreads();

  const int step_groups = SEG / THREADS;
  int piece = 0;             // pieces consumed
  for (int g = 0; g < ngroups; ++g) {
    const int bi = g / gpb, gb = g - bi * gpb;
    const int row = gb * THREADS + tid;
    const size_t p = (size_t)blist[bi] * cap + row;
    float s = 0.f;
    if constexpr (VEC == 16) {
      for (int c = 0; c < npiece; ++c, ++piece) {
        cp_async_wait1();
        const uint4 w = ring[(piece & 1) * THREADS + tid];
        s = add_piece(s, w, lut + (size_t)c * 16 * ksub, ksub);
        const uint8_t* np_ = fc.next(have);
        cp_async16(ring + (piece & 1) * THREADS + tid, np_, have);
        cp_async_commit();
      }
    } else if (row < cap) {
      s = adc_row<VEC>(codes + p * m, lut, m, ksub);
    }
    uint32_t key = 0u;
    if (row < cap && bucket_valid[p]) {
      const float sc = -s;
      if (sc > -CUDART_INF_F) key = key_of(sc);
    }
    pk.offer(key, bucket_slot + p);
    if (gb % step_groups == step_groups - 1 || gb == gpb - 1) pk.end_step();
  }
  pk.write(cand_v + out_base, cand_i + out_base);
}

// Second pass: the [b, nprobe * k] rank lists of each query through the
// same running pick, SEG candidates a step (one CTA per query).
__global__ void __launch_bounds__(THREADS)
merge_ranks_kernel(const float* __restrict__ cand_v,
                   const int* __restrict__ cand_i, int n, int k,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ __align__(16) unsigned char buf[LISTS_BYTES];
  __shared__ Scalars S;
  const int qi = blockIdx.x;
  Picker pk;
  pk.init(carve_lists(buf), &S, k);
  __syncthreads();
  const float* v = cand_v + (size_t)qi * n;
  const int* ids = cand_i + (size_t)qi * n;
  for (int g0 = 0; g0 < n; g0 += SEG) {
    for (int i0 = g0; i0 < g0 + SEG && i0 < n; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      uint32_t key = 0u;
      if (i < n) {
        const float sc = v[i];
        if (sc > -CUDART_INF_F) key = key_of(sc);
      }
      pk.offer(key, ids + (i < n ? i : 0));
    }
    pk.end_step();
  }
  pk.write(out_v + (size_t)qi * k, out_i + (size_t)qi * k);
}

// Dynamic shared memory of adc_rank_kernel.
size_t smem_bytes(int vec, int m, int ksub, int budget) {
  const size_t tpad = (size_t)((m * ksub + 3) & ~3);
  return sizeof(float) * tpad + (vec == 16 ? 2 * THREADS * 16 : 0) +
         LISTS_BYTES + sizeof(int) * (size_t)budget;
}

template <int VEC>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t st,
                        const int* vprobes, const int* coarse_pos,
                        const float* lut_all, const uint8_t* codes,
                        const uint8_t* valid, const int* slot, int budget,
                        int nprobe, int nbuckets, int cap, int m, int ksub,
                        int k, int lut_bulk, float* cand_v, int* cand_i) {
  cudaError_t err = cudaFuncSetAttribute(
      adc_rank_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the largest carveout, so that two CTAs of ~110 KB share an SM
  err = cudaFuncSetAttribute(adc_rank_kernel<VEC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  adc_rank_kernel<VEC><<<grid, THREADS, smem, st>>>(
      vprobes, coarse_pos, lut_all, codes, valid, slot, budget, nprobe,
      nbuckets, cap, m, ksub, k, lut_bulk, cand_v, cand_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vprobes, coarse_pos [b, budget] i32; lut_all [b, nprobe, m, ksub] f32;
// codes [nbuckets, cap, m] u8; bucket_valid [nbuckets, cap] bytes;
// bucket_slot [nbuckets, cap] i32. cand_v/cand_i: [b, nprobe, k] scratch;
// out_v/out_i: [b, k]. code_vec = bytes per code load (16: the cp.async
// ring, 8, 4 or 1: m % code_vec == 0 and rows code_vec-aligned); lut_bulk =
// (m * ksub) % 4 == 0 and a 16-byte aligned lut_all (the TMA copy).
// Returns cudaGetLastError() after both launches.
int dingo_ivf_pq_adc_topk(const int* vprobes, const int* coarse_pos,
                          const float* lut_all, const uint8_t* codes,
                          const uint8_t* bucket_valid, const int* bucket_slot,
                          int b, int budget, int nprobe, int nbuckets,
                          int cap, int m, int ksub, int k, int code_vec,
                          int lut_bulk, float* cand_v, int* cand_i,
                          float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > dingo::K_MAX || b < 1 || budget < 1 || nprobe < 1 ||
      cap < 1 || m < 1 || ksub < 1 || ksub > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(code_vec, m, ksub, budget);
  dim3 grid(nprobe, b);
  cudaError_t err;
#define DINGO_B5_ARGS                                                      \
  grid, smem, st, vprobes, coarse_pos, lut_all, codes, bucket_valid,      \
      bucket_slot, budget, nprobe, nbuckets, cap, m, ksub, k, lut_bulk,    \
      cand_v, cand_i
  switch (code_vec) {
    case 16:
      err = launch_scan<16>(DINGO_B5_ARGS);
      break;
    case 8:
      err = launch_scan<8>(DINGO_B5_ARGS);
      break;
    case 4:
      err = launch_scan<4>(DINGO_B5_ARGS);
      break;
    case 1:
      err = launch_scan<1>(DINGO_B5_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DINGO_B5_ARGS
  if (err != cudaSuccess) return (int)err;
  merge_ranks_kernel<<<b, THREADS, 0, st>>>(cand_v, cand_i, nprobe * k, k,
                                           out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
