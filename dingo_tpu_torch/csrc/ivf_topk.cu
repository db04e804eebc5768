// Kernel B2: IVF probed-bucket scan + running top-k.
//
// Replaces dingo_tpu/ops/pallas_ivf.py::ivf_list_topk (body _ivf_kernel),
// in both of its row arms: f32 rows, and bf16 rows against the f32 query
// (pallas_ivf.py:65). For each query and each of its `budget` virtual
// probes (bucket ids, -1 = padded rank, skipped), scans the bucket's
// [cap, d] rows and keeps the k best "larger is better" scores (L2:
// -(||q||^2 - 2 q.x + ||x||^2); IP: q.x) over valid rows, with their
// slots; -1 where the score is -inf. k <= 64.
//
// What bounds it on an H100: bytes. A row is one d-long dot per query
// that probes its bucket, so the least time is the bytes of the DISTINCT
// buckets the batch probes over 3.35 TB/s (b = 64, nprobe = 32 at cap
// 1024, d = 768: some 730 buckets of 3 MB in f32, 1.5 MB in bf16).
//
// Design.
//   1. Work list (probe_items.cuh, shared with B3): items of one bucket
//      and up to QT = 8 of the queries that probe it, built on the device;
//      a bucket probed by more than 8 queries makes several items. Every
//      (query, rank) pair's candidate row starts as -inf / -1.
//   2. A persistent grid, one CTA an SM, takes the units in turn (unit
//      c, c + grid, ...): a unit is one of PARTS parts of an item, a run
//      of its 128-row tiles. Units cost the same (tiles of a bucket
//      against 8 query columns), and there are enough of them that the
//      last round leaves few SMs idle. One producer warp streams the
//      unit's rows through a shared-memory ring of up to
//      eight stages, a TMA tensor copy of a 128-row x 128-byte box a stage
//      (32 f32 or 64 bf16 columns, 128-byte swizzle, zeros past the last
//      column), and beside it the same columns of the item's queries (a
//      bulk copy of each query's chunk): a bucket leaves HBM once per
//      item, not once per (query, rank), and no width is too wide to
//      stage.
//   3. Eight consumer warps, 16 rows each, multiply on the tensor cores
//      with the rows as M and the item's queries as N = 8 (mma.sync):
//      f32 rows by 3xTF32 (m16n8k8; rows and queries split in registers),
//      bf16 rows against the three bf16 parts of the query (m16n8k16).
//      Each k step's products sum from zero (split_mma.cuh: the tensor
//      cores truncate as they accumulate), a stage's steps into a stage
//      sum, 128 columns' stage sums into a block sum, and the block sums
//      into the f32 total. A (query, row) dot so depends on the columns
//      alone, not on the item's size or the query's column in it, and a
//      pair's candidates are the same in every item; padding columns of
//      an item of fewer than 8 queries cost products, not bytes.
//   4. Selection in the scan, a warp per query column: after each tile
//      the warps put their 16 x 8 scores in a shared score tile (two
//      buffers, one barrier a tile), and warp j keeps query j's running
//      list: the unit's first tile fills it at once (k rounds of a warp
//      argmax over the tile's 128 scores), later tiles insert the scores
//      above its k-th best (topk_common.cuh's ballot and warp_insert).
//      After the unit's last tile warp j writes the pair's k candidates of
//      that part to cand[q, r, part, :]; merge_candidates then picks each
//      query's k best of its [budget, parts, k].
//   Rows whose pitch is not a multiple of 16 bytes (or a misaligned base)
//   take the same ring, filled by the producer warp with plain loads.

#include <cstring>
#include <type_traits>

#include "probe_items.cuh"
#include "split_mma.cuh"

namespace {

constexpr int QT = 8;                    // queries per item = mma N
constexpr int NCW = 8;                   // consumer warps
constexpr int THREADS = (NCW + 1) * 32;  // + the producer warp
constexpr int ROWS = NCW * 16;           // rows per tile
constexpr int STAGE = ROWS * 128;        // bytes of a stage's row box
constexpr int MAX_STAGES = 8;
constexpr int BLOCK_COLS = 128;          // columns of a block sum
constexpr int PARTS = 2;                 // units an item, at most
static_assert(QT <= NCW, "warp j keeps query j's running list");

// Units an item of ceil(cap / ROWS) tiles is cut into.
__host__ __device__ inline int parts_of(int cap) {
  const int ntiles = (cap + ROWS - 1) / ROWS;
  return ntiles < PARTS ? ntiles : PARTS;
}

// BK: columns per ring stage (128 bytes of a row); QP: pitch, in floats,
// of a query's chunk in a stage (BK + 4: the 8 queries of a column meet
// distinct banks; 16-byte multiples for the bulk copies).
template <typename T>
struct Arm;
template <>
struct Arm<float> {
  static constexpr int BK = 32, QP = 36;
};
template <>
struct Arm<__nv_bfloat16> {
  static constexpr int BK = 64, QP = 68;
};

struct Args {
  const float* queries;
  const void* buckets;
  const float* sqnorm;
  const unsigned char* valid;
  const int* slot;
  int b, budget, nbuckets, cap, d, k, ascending, tma, nstage;
  const int* pairs;
  const int* item_bucket;
  const int* item_first;
  const int* item_count;
  const int* counters;
  const float* qsq;  // [b] ||q||^2
  float* cand_v;
  int* cand_i;
};

constexpr int SP = ROWS + 4;   // pitch of a query's row in the score tile

// Shared memory of the scan: the row boxes (nstage), the queries' chunks
// (nstage x QT x QP floats), two score tiles [QT, SP], the running lists
// (QT x k), barriers.
template <typename T>
size_t smem_bytes(int nstage, int k) {
  return 1024 + (size_t)nstage * STAGE +
         (size_t)nstage * QT * Arm<T>::QP * sizeof(float) +
         2 * sizeof(float) * QT * SP +
         (sizeof(float) + sizeof(int)) * (size_t)QT * k +
         2 * sizeof(uint64_t) * nstage;
}

// One stage's products, from zero: s (rows warp*16 + g, + 8; queries 2t,
// 2t + 1) = the tile's 128 bytes of columns against the queries' same
// columns (qs: query j's at j * QP). In the swizzled tile, row r's 16-byte
// chunk c sits at chunk c ^ (r % 8), and r % 8 = g for both rows of a
// thread. The four k steps run as waves of independent products, each
// step's partial from zero, summed in step order.
__device__ __forceinline__ void stage_dots(const float* xs, const float* qs,
                                           int warp, int g, int t,
                                           float (&sum)[4]) {
  const float* xr = xs + (warp * 16 + g) * 32 + t;   // row warp*16 + g
  const float* qr = qs + g * Arm<float>::QP + t;     // query g
  uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {                      // columns 8s ..
    const int c0 = (((2 * s) ^ g) & 7) << 2;          // columns 8s + t
    const int c1 = (((2 * s + 1) ^ g) & 7) << 2;      // columns 8s + 4 + t
    dingo::split_tf32(xr[c0], ah[s][0], al[s][0]);
    dingo::split_tf32(xr[8 * 32 + c0], ah[s][1], al[s][1]);
    dingo::split_tf32(xr[c1], ah[s][2], al[s][2]);
    dingo::split_tf32(xr[8 * 32 + c1], ah[s][3], al[s][3]);
    dingo::split_tf32(qr[8 * s], bh[s][0], bl[s][0]);
    dingo::split_tf32(qr[8 * s + 4], bh[s][1], bl[s][1]);
  }
  float p[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    dingo::mma_tf32_zc(p[s], ah[s], bl[s][0], bl[s][1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) dingo::mma_tf32(p[s], al[s], bh[s][0], bh[s][1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) dingo::mma_tf32(p[s], ah[s], bh[s][0], bh[s][1]);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sum[e] = ((p[0][e] + p[1][e]) + p[2][e]) + p[3][e];
}

__device__ __forceinline__ void stage_dots(const __nv_bfloat16* xb,
                                           const float* qs, int warp, int g,
                                           int t, float (&sum)[4]) {
  const uint32_t* xr =
      reinterpret_cast<const uint32_t*>(xb) + (warp * 16 + g) * 32 + t;
  const float* qr = qs + g * Arm<__nv_bfloat16>::QP + 2 * t;
  uint32_t a[4][4], q1[4][2], q2[4][2], q3[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {                      // columns 16s ..
    const int c0 = (((2 * s) ^ g) & 7) << 2;          // columns 16s + 2t, +1
    const int c1 = (((2 * s + 1) ^ g) & 7) << 2;      // columns 16s + 8 + 2t
    a[s][0] = xr[c0];
    a[s][1] = xr[8 * 32 + c0];
    a[s][2] = xr[c1];
    a[s][3] = xr[8 * 32 + c1];
    const float2 v0 = *reinterpret_cast<const float2*>(qr + 16 * s);
    const float2 v1 = *reinterpret_cast<const float2*>(qr + 16 * s + 8);
    dingo::split_bf16x3(v0.x, v0.y, q1[s][0], q2[s][0], q3[s][0]);
    dingo::split_bf16x3(v1.x, v1.y, q1[s][1], q2[s][1], q3[s][1]);
  }
  float p[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    dingo::mma_bf16_zc(p[s], a[s], q3[s][0], q3[s][1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) dingo::mma_bf16(p[s], a[s], q2[s][0], q2[s][1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) dingo::mma_bf16(p[s], a[s], q1[s][0], q1[s][1]);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sum[e] = ((p[0][e] + p[1][e]) + p[2][e]) + p[3][e];
}

// ||q||^2 of each query, a warp a query (the order B1's scan sums it in).
__global__ void qsq_kernel(const float* __restrict__ q, int b, int d,
                           float* __restrict__ qsq) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= b) return;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = q[(size_t)row * d + c];
    s = fmaf(v, v, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(dingo::FULL_MASK, s, off);
  if (lane == 0) qsq[row] = s;
}

// The scan: CTA c takes units c, c + grid, ... (unit = item * parts +
// part) and writes each of their pairs' k candidates to cand[q, r, part,
// :] (rows' slots; -inf / -1 past the valid rows).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ivf_scan_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  constexpr int BK = Arm<T>::BK, QP = Arm<T>::QP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (dingo::smem_u32(smem_raw) & 1023)) & 1023);
  const int nst = a.nstage, k = a.k;
  float* qring = reinterpret_cast<float*>(ring + (size_t)nst * STAGE);
  float* sbuf = qring + (size_t)nst * QT * QP;   // [2][QT][SP]
  float* topv = sbuf + 2 * QT * SP;
  int* topi = reinterpret_cast<int*>(topv + QT * k);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(topi + QT * k) + 7) & ~uintptr_t(7));
  uint64_t* empty = full + nst;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      dingo::mbar_init(full + s, 1);
      dingo::mbar_init(empty + s, NCW);
    }
    dingo::mbar_init_fence();
  }
  // an item of fewer than 8 queries leaves stale query chunks, and a
  // query's last chunk leaves stale columns past d (the rows there are
  // zeros): start from finite values
  for (int i = tid; i < nst * QT * QP; i += THREADS) qring[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int parts = parts_of(a.cap);
  const int nunits = a.counters[0] * parts;
  const int ntiles = (a.cap + ROWS - 1) / ROWS;
  const int tpu = (ntiles + parts - 1) / parts;   // tiles a unit
  const int nchunks = (a.d + BK - 1) / BK;

  if (warp == NCW) {   // producer
    uint32_t it = 0;
    for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
      const int item = u / parts, part = u - item * parts;
      const int first = a.item_first[item], cnt = a.item_count[item];
      const int qrow = lane < cnt ? a.pairs[first + lane] / a.budget : 0;
      const long long rbase = (long long)a.item_bucket[item] * a.cap;
      const int tend = min(ntiles, (part + 1) * tpu);
      for (int tile = part * tpu; tile < tend; ++tile) {
        const long long row0 = rbase + tile * ROWS;
        for (int ch = 0; ch < nchunks; ++ch, ++it) {
          const uint32_t s = it % nst, f = it / nst;
          if (f > 0) dingo::mbar_wait(empty + s, (f - 1) & 1);
          unsigned char* st = ring + (size_t)s * STAGE;
          float* qs = qring + (size_t)s * QT * QP;
          const int c0 = ch * BK;
          if (a.tma) {
            const uint32_t qbytes = (uint32_t)min(BK, a.d - c0) * 4u;
            if (lane == 0) {
              dingo::mbar_arrive_expect_tx(full + s, STAGE + cnt * qbytes);
              dingo::tma_load_2d(st, &xmap, c0, (int)row0, full + s);
            }
            __syncwarp();
            if (lane < cnt)
              dingo::bulk_load(qs + lane * QP,
                               a.queries + (size_t)qrow * a.d + c0, qbytes,
                               full + s);
          } else {
            dingo::fill_box_sw128<T>(st, static_cast<const T*>(a.buckets),
                                     (long long)a.nbuckets * a.cap, a.d,
                                     row0, c0, ROWS, lane);
            for (int j = 0; j < cnt; ++j) {
              const int qj = __shfl_sync(dingo::FULL_MASK, qrow, j);
              for (int c = lane; c < BK; c += 32)
                qs[j * QP + c] =
                    c0 + c < a.d ? a.queries[(size_t)qj * a.d + c0 + c] : 0.f;
            }
            __syncwarp();
            if (lane == 0) dingo::mbar_arrive(full + s);
          }
        }
      }
    }
    return;
  }

  // consumers: warp w owns rows w*16 .. w*16+15 of each tile and, as
  // w < the item's count, query w's running list (lv, li: rows of the
  // bucket)
  const int g = lane >> 2, t = lane & 3, j0 = 2 * t, j1 = 2 * t + 1;
  float* lv = topv + warp * k;
  int* li = topi + warp * k;
  uint32_t it = 0, nt = 0;   // stages and tiles this CTA consumed
  for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
    const int item = u / parts, part = u - item * parts;
    const int first = a.item_first[item], cnt = a.item_count[item];
    const size_t bbase = (size_t)a.item_bucket[item] * a.cap;
    const bool mine = warp < cnt;
    const float qsq0 = j0 < cnt ? a.qsq[a.pairs[first + j0] / a.budget] : 0.f;
    const float qsq1 = j1 < cnt ? a.qsq[a.pairs[first + j1] / a.budget] : 0.f;
    float thr = -CUDART_INF_F;
    const int tbeg = part * tpu, tend = min(ntiles, tbeg + tpu);
    for (int tile = tbeg; tile < tend; ++tile, ++nt) {
      // the rows' norms and validity, read now (no load waits on another)
      const int lr = warp * 16 + g;                // row in the tile
      const int rlo = tile * ROWS + lr, rhi = rlo + 8;
      const bool inlo = rlo < a.cap, inhi = rhi < a.cap;
      const bool vlo = inlo && __ldg(a.valid + bbase + rlo);
      const bool vhi = inhi && __ldg(a.valid + bbase + rhi);
      const float xlo = inlo ? __ldg(a.sqnorm + bbase + rlo) : 0.f;
      const float xhi = inhi ? __ldg(a.sqnorm + bbase + rhi) : 0.f;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, blk[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < nchunks; ++ch, ++it) {
        const uint32_t s = it % nst;
        dingo::mbar_wait(full + s, (it / nst) & 1);
        float sum[4];
        stage_dots(reinterpret_cast<const T*>(ring + (size_t)s * STAGE),
                   qring + (size_t)s * QT * QP, warp, g, t, sum);
        __syncwarp();
        if (lane == 0) dingo::mbar_arrive(empty + s);
#pragma unroll
        for (int e = 0; e < 4; ++e) blk[e] += sum[e];
        if ((ch + 1) % (BLOCK_COLS / BK) == 0 || ch == nchunks - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e] += blk[e];
            blk[e] = 0.f;
          }
        }
      }
      // the tile's scores into the score tile: (lr, j0), (lr, j1), (lr + 8,
      // j0), (lr + 8, j1); -inf for invalid rows and rows past the bucket.
      // The other buffer may still be read; this one was read a tile ago,
      // before every warp passed the last barrier.
      float* buf = sbuf + (nt & 1) * QT * SP;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = e < 2 ? vlo : vhi;
        const float xs = e < 2 ? xlo : xhi, qsq = (e & 1) ? qsq1 : qsq0;
        buf[((e & 1) ? j1 : j0) * SP + lr + (e < 2 ? 0 : 8)] =
            !ok ? -CUDART_INF_F
            : a.ascending ? -((qsq - 2.0f * acc[e]) + xs)
                          : acc[e];
      }
      dingo::bar_sync(1, NCW * 32);
      if (!mine) continue;
      // warp w: query w's 128 scores, lane l holding rows l + 32 h
      float v[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) v[h] = buf[warp * SP + lane + 32 * h];
      const int r0 = tile * ROWS;
      if (tile == tbeg) {
        // the list is empty: its k best of the tile at once, k rounds of
        // a warp argmax, each round the best below the last one taken
        float lastv = CUDART_INF_F;
        int lastr = -1;
        for (int r = 0; r < k; ++r) {
          float bv = -CUDART_INF_F;
          int br = INT_MAX;
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int row = lane + 32 * h;
            if ((v[h] < lastv || (v[h] == lastv && row > lastr)) &&
                dingo::better(v[h], row, bv, br)) {
              bv = v[h];
              br = row;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(dingo::FULL_MASK, bv, off);
            const int orr = __shfl_xor_sync(dingo::FULL_MASK, br, off);
            if (dingo::better(ov, orr, bv, br)) {
              bv = ov;
              br = orr;
            }
          }
          const bool none = br == INT_MAX || bv == -CUDART_INF_F;
          if (lane == 0) {
            lv[r] = none ? -CUDART_INF_F : bv;
            li[r] = none ? -1 : r0 + br;
          }
          lastv = bv;
          lastr = br;
        }
        __syncwarp();
        thr = lv[k - 1];
        continue;
      }
      // later tiles: insert those above the k-th best, in ballot order
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        unsigned m = __ballot_sync(dingo::FULL_MASK, v[h] > thr);
        while (m) {
          const int src = __ffs(m) - 1;
          const float val = __shfl_sync(dingo::FULL_MASK, v[h], src);
          dingo::warp_insert(lv, li, k, val, r0 + src + 32 * h);
          thr = lv[k - 1];
          m &= ~(1u << src);
          m &= __ballot_sync(dingo::FULL_MASK, v[h] > thr);
        }
      }
    }
    if (mine) {   // the pair's candidates of this part (rows -> slots)
      // pair p = q budget + r: its part's row of cand
      const size_t out = ((size_t)a.pairs[first + warp] * parts + part) * k;
      for (int c = lane; c < k; c += 32) {
        const int r = li[c];
        a.cand_v[out + c] = lv[c];
        a.cand_i[out + c] = r < 0 ? -1 : __ldg(a.slot + bbase + r);
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch(Args a, const int* vprobes, int* work, float* out_v, int* out_i,
           void* stream) {
  if (a.k < 1 || a.k > dingo::K_MAX || a.b < 1 || a.budget < 1 ||
      a.cap < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return (int)err;
  a.nstage = MAX_STAGES;   // as many stages as the lists leave room for
  while (a.nstage > 2 && smem_bytes<T>(a.nstage, a.k) > (size_t)max_smem)
    --a.nstage;
  const size_t smem = smem_bytes<T>(a.nstage, a.k);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  auto kernel = ivf_scan_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n = a.b * a.budget;
  const int parts = parts_of(a.cap);
  // every pair's rows of cand start as -inf / -1
  int rc = dingo::build_items<QT>(vprobes, a.b, a.budget, a.nbuckets,
                                  a.k * parts, work, a.cand_v, a.cand_i, st);
  if (rc != 0) return rc;
  a.pairs = work;
  a.item_bucket = work + 4 * (size_t)n;
  a.item_first = work + 5 * (size_t)n;
  a.item_count = work + 6 * (size_t)n;
  a.counters = work + 7 * (size_t)n;
  float* qsq = reinterpret_cast<float*>(work + 7 * (size_t)n + 2);
  a.qsq = qsq;
  qsq_kernel<<<(a.b + 7) / 8, 256, 0, st>>>(a.queries, a.b, a.d, qsq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  if (a.tma) {
    rc = dingo::encode_map(&xmap, a.buckets,
                           std::is_same<T, __nv_bfloat16>::value,
                           (uint64_t)a.nbuckets * a.cap, a.d, ROWS,
                           Arm<T>::BK, true);
    if (rc != 0) return rc;
  }
  kernel<<<sms, THREADS, smem, st>>>(xmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<a.b, 256, 0, st>>>(
      a.cand_v, a.cand_i, a.budget * parts * a.k, a.k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Parts an item of a bucket of cap rows is scanned in (the candidates'
// third dimension).
int dingo_ivf_list_parts(int cap) { return parts_of(cap); }

// vprobes[b, budget] i32; queries[b, d] f32; buckets[nbuckets, cap, d] f32
// (dingo_ivf_list_topk) or bf16 (dingo_ivf_list_topk_bf16);
// bucket_sqnorm[nbuckets, cap] f32; bucket_valid[nbuckets, cap] bytes;
// bucket_slot[nbuckets, cap] i32. tma = rows and queries can go by TMA (a
// row pitch that is a multiple of 16 bytes, 16-byte aligned buckets and
// queries); work[7 b budget + 2 + b] i32 scratch (the work list, then the
// queries' norms); cand_v / cand_i: [b, budget, P, k] scratch (P from
// dingo_ivf_list_parts(cap)); out_v/out_i: [b, k]. Returns
// cudaGetLastError() after the launches (work list, norms, scan, merge).
#define DINGO_B2_ARGS                                                       \
  const int *vprobes, const float *queries, const float *bucket_sqnorm,    \
      const unsigned char *bucket_valid, const int *bucket_slot, int b,    \
      int budget, int nbuckets, int cap, int d, int k, int ascending,      \
      int tma, int *work, float *cand_v, int *cand_i, float *out_v,        \
      int *out_i, void *stream
#define DINGO_B2_PASS(T)                                                    \
  launch<T>(Args{queries, buckets, bucket_sqnorm, bucket_valid,            \
                 bucket_slot, b, budget, nbuckets, cap, d, k, ascending,   \
                 tma, 0, nullptr, nullptr, nullptr, nullptr, nullptr,      \
                 nullptr, cand_v, cand_i},                                 \
            vprobes, work, out_v, out_i, stream)

int dingo_ivf_list_topk(const float* buckets, DINGO_B2_ARGS) {
  return DINGO_B2_PASS(float);
}

int dingo_ivf_list_topk_bf16(const __nv_bfloat16* buckets, DINGO_B2_ARGS) {
  return DINGO_B2_PASS(__nv_bfloat16);
}

}  // extern "C"
