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
// Here a lookup is a lookup: one CTA per (query, probe rank) copies its
// rank's table into shared memory with 16-byte loads (dynamic shared memory
// above 48 KB: two CTAs fit per SM at m 96; the launch takes m * ksub up to
// 192 * 256 floats), then each thread takes one code row at a time, reads
// its m bytes as 16-, 8- or 4-byte vectors and sums the table entries in
// subspace order in f32. Selection is B2's: a warp ballot against the warp
// list's k-th best, a warp-parallel sorted insert for each survivor
// (topk_common.cuh), warp 0 folds the eight lists, and the same block-argmax
// merge pass folds [b, budget, k] candidates. Spill buckets of one coarse
// list reload the same table (from L2); lookups at random codes conflict on
// shared-memory banks. Both are left for later work.

#include "topk_common.cuh"

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

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

// ADC distance of one code row. VEC = bytes per load (16, 8, 4 or 1); the
// caller guarantees m % VEC == 0 and a VEC-aligned row.
template <int VEC>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row,
                                         const float* lut, int m, int ksub) {
  float s = 0.f;
  if constexpr (VEC == 16) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < m / 16; ++c) {
      const uint4 w = __ldg(p + c);
      const float* l = lut + (size_t)c * 16 * ksub;
      s = add_word(s, w.x, l, ksub);
      s = add_word(s, w.y, l + 4 * ksub, ksub);
      s = add_word(s, w.z, l + 8 * ksub, ksub);
      s = add_word(s, w.w, l + 12 * ksub, ksub);
    }
  } else if constexpr (VEC == 8) {
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

template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
adc_scan_kernel(const int* __restrict__ vprobes,
                const int* __restrict__ coarse_pos,
                const float* __restrict__ lut_all,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ bucket_valid,
                const int* __restrict__ bucket_slot, int budget, int nprobe,
                int nbuckets, int cap, int m, int ksub, int k, int lut_vec4,
                float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) float smem[];
  const int tsize = m * ksub;
  float* lut = smem;                                  // [m, ksub]
  float* topv = lut + ((tsize + 3) & ~3);             // [NWARPS][k]
  int* topi = reinterpret_cast<int*>(topv + NWARPS * k);

  const int r = blockIdx.x, qi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t out_base = ((size_t)qi * budget + r) * k;
  const int bucket = vprobes[(size_t)qi * budget + r];
  const int cp = coarse_pos[(size_t)qi * budget + r];
  if (bucket < 0 || bucket >= nbuckets || cp < 0 || cp >= nprobe) {
    for (int c = tid; c < k; c += THREADS) {   // padded rank: no scan
      cand_v[out_base + c] = -CUDART_INF_F;
      cand_i[out_base + c] = -1;
    }
    return;
  }

  const float* src = lut_all + ((size_t)qi * nprobe + cp) * (size_t)tsize;
  if (lut_vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(lut);
    for (int i = tid; i < tsize / 4; i += THREADS) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = tid; i < tsize; i += THREADS) lut[i] = __ldg(src + i);
  }
  float* lv = topv + warp * k;
  int* li = topi + warp * k;
  dingo::list_init(lv, li, k);
  __syncthreads();

  const size_t bbase = (size_t)bucket * cap;
  float thr = -CUDART_INF_F;
  for (int row0 = 0; row0 < cap; row0 += THREADS) {
    const int row = row0 + tid;
    float sc = -CUDART_INF_F;
    int sl = -1;
    if (row < cap) {
      const size_t p = bbase + row;
      if (bucket_valid[p]) {
        sc = -adc_row<VEC>(codes + p * m, lut, m, ksub);
        sl = bucket_slot[p];
      }
    }
    // survivors enter the warp's list one at a time, in row order
    unsigned want = __ballot_sync(dingo::FULL_MASK, sc > thr);
    while (want) {
      const int from = __ffs(want) - 1;
      const float v = __shfl_sync(dingo::FULL_MASK, sc, from);
      const int id = __shfl_sync(dingo::FULL_MASK, sl, from);
      dingo::warp_insert(lv, li, k, v, id);
      thr = lv[k - 1];
      want &= ~(1u << from);
      want &= __ballot_sync(dingo::FULL_MASK, sc > thr);
    }
  }
  __syncthreads();

  // warp 0 folds the other warps' lists into its own
  if (warp == 0) {
    float t0 = lv[k - 1];
    for (int w = 1; w < NWARPS; ++w) {
      for (int i = 0; i < k; ++i) {
        const float v = topv[w * k + i];
        if (!(v > t0)) break;   // lists are sorted: the rest cannot enter
        dingo::warp_insert(lv, li, k, v, topi[w * k + i]);
        t0 = lv[k - 1];
      }
    }
    for (int c = lane; c < k; c += 32) {
      cand_v[out_base + c] = lv[c];
      cand_i[out_base + c] = li[c];
    }
  }
}

template <int VEC>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t st,
                        const int* vprobes, const int* coarse_pos,
                        const float* lut_all, const uint8_t* codes,
                        const uint8_t* valid, const int* slot, int budget,
                        int nprobe, int nbuckets, int cap, int m, int ksub,
                        int k, int lut_vec4, float* cand_v, int* cand_i) {
  cudaError_t err = cudaFuncSetAttribute(
      adc_scan_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  adc_scan_kernel<VEC><<<grid, THREADS, smem, st>>>(
      vprobes, coarse_pos, lut_all, codes, valid, slot, budget, nprobe,
      nbuckets, cap, m, ksub, k, lut_vec4, cand_v, cand_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dingo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vprobes, coarse_pos [b, budget] i32; lut_all [b, nprobe, m, ksub] f32;
// codes [nbuckets, cap, m] u8; bucket_valid [nbuckets, cap] bytes;
// bucket_slot [nbuckets, cap] i32. cand_v/cand_i: [b, budget, k] scratch;
// out_v/out_i: [b, k]. code_vec = bytes per code load (16, 8, 4 or 1:
// m % code_vec == 0 and rows code_vec-aligned); lut_vec4 = (m * ksub) % 4
// == 0 and a 16-byte aligned lut_all. Returns cudaGetLastError() after both
// launches.
int dingo_ivf_pq_adc_topk(const int* vprobes, const int* coarse_pos,
                          const float* lut_all, const uint8_t* codes,
                          const uint8_t* bucket_valid, const int* bucket_slot,
                          int b, int budget, int nprobe, int nbuckets,
                          int cap, int m, int ksub, int k, int code_vec,
                          int lut_vec4, float* cand_v, int* cand_i,
                          float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > dingo::K_MAX || b < 1 || budget < 1 || nprobe < 1 ||
      cap < 1 || m < 1 || ksub < 1 || ksub > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)((m * ksub + 3) & ~3) +
                      (sizeof(float) + sizeof(int)) * (size_t)NWARPS * k;
  dim3 grid(budget, b);
  cudaError_t err;
  switch (code_vec) {
    case 16:
      err = launch_scan<16>(grid, smem, st, vprobes, coarse_pos, lut_all,
                            codes, bucket_valid, bucket_slot, budget, nprobe,
                            nbuckets, cap, m, ksub, k, lut_vec4, cand_v,
                            cand_i);
      break;
    case 8:
      err = launch_scan<8>(grid, smem, st, vprobes, coarse_pos, lut_all,
                           codes, bucket_valid, bucket_slot, budget, nprobe,
                           nbuckets, cap, m, ksub, k, lut_vec4, cand_v,
                           cand_i);
      break;
    case 4:
      err = launch_scan<4>(grid, smem, st, vprobes, coarse_pos, lut_all,
                           codes, bucket_valid, bucket_slot, budget, nprobe,
                           nbuckets, cap, m, ksub, k, lut_vec4, cand_v,
                           cand_i);
      break;
    case 1:
      err = launch_scan<1>(grid, smem, st, vprobes, coarse_pos, lut_all,
                           codes, bucket_valid, bucket_slot, budget, nprobe,
                           nbuckets, cap, m, ksub, k, lut_vec4, cand_v,
                           cand_i);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  dingo::merge_candidates<256><<<b, 256, 0, st>>>(cand_v, cand_i,
                                                  budget * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
