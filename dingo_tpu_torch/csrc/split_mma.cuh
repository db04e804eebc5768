// Split-precision tensor-core products and the TMA ring pieces of the
// unpruned scans (B1 fused_topk.cu, by wgmma; B2 ivf_topk.cu, by
// mma.sync).
//
// The fp32 tier's dot products keep f32 accuracy on the tensor cores by
// splitting operands (the JAX package's Precision.HIGHEST is itself a
// multi-pass product on the TPU's bf16 matrix unit):
//   3xTF32 (f32 rows): x = x_hi + x_lo and q = q_hi + q_lo: hi is v
//     rounded to TF32 as cvt.rna rounds (to nearest, ties away from zero),
//     by integer operations (cvt.rna issues on the slower conversion
//     pipe); lo is the exact f32 residual v - hi, of which
//     the tensor cores read the upper 19 bits (sign, exponent, 10 fraction
//     bits: lo truncated to TF32, ~2^-21 |v|); dot = q_hi.x_lo +
//     q_lo.x_hi + q_hi.x_hi, the small terms first. q_lo.x_lo (~2^-22
//     relative) is dropped.
//   bf16 rows x 3-way bf16 query: q = q1 + q2 + q3, each part the bf16
//     rounding (to nearest even) of the residual left by the ones before,
//     which is exact for normal f32 values; each part times a bf16 row
//     value is exact in f32; dot = q3.x + q2.x + q1.x, the small terms
//     first.
// The products of each k step (B1: of each pair of k steps) sum from zero
// and that partial is added to an f32 total (below: why; B2 sums a
// stage's partials, then 128 columns' stage sums, before the total).
// ops/split_dot.py holds host models of both splits and products. A
// single TF32 pass stays out of the fp32 tier.
//
// mma.sync fragments (PTX ISA, m16n8k8 .tf32 and m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4: A (16 x K, row major) rows g and g + 8;
// B (K x 8, column major) column g; C rows g and g + 8, columns 2t, 2t + 1.
// wgmma with A from registers lays each warp's 16 rows of A, and each n8
// block of its accumulator, out the same way.
//
// Tiles land by TMA into shared memory in the 128-byte swizzle: a tile
// row of 128 bytes has its 16-byte chunk c at chunk c ^ (row % 8), the
// tile starting on a 1024-byte boundary. A warp reading rows g = 0..7 at
// one chunk index so meets 32 distinct banks.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace dingo {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After every mbar_init and before the barriers are used: makes the
// initialisation visible to the async proxy (TMA) and the other threads
// (the caller then syncs the CTA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the phase with the given parity. A phase
// that never completes (a broken ring protocol) traps after ~2^35 cycles
// (some 20 s), so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// -- TMA -------------------------------------------------------------------
// A 2-D tile (box) of a tensor map into shared memory, completing on bar;
// c0 is the column (innermost) coordinate, c1 the row. Columns and rows
// outside the tensor land as zeros and count in the box's bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A contiguous run of bytes (a multiple of 16, 16-byte aligned at both
// ends) into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of (row, byte) in a tile of 128-byte rows in the 128-byte
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B).
__host__ __device__ __forceinline__ uint32_t sw128(uint32_t row,
                                                   uint32_t byte) {
  return row * 128u + ((((byte >> 4) ^ row) & 7u) << 4) + (byte & 15u);
}

// Named barrier over the first `threads` threads of the CTA (id > 0: the
// producer warp, which has left, is not among them).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- operand splits ----------------------------------------------------------
// cvt.rna.tf32.f32 of a finite v: add half a TF32 ulp to the magnitude
// bits (a carry rounds up into the exponent) and clear the 13 bits below.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = rna(v), lo = v - hi exactly (the tensor cores read lo's upper 19
// bits), both as mma operand registers.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}

// (v0, v1) = p1 + p2 + p3, each a bf16x2 (v0 in the low half, the lower
// k index of an mma fragment register).
__device__ __forceinline__ void split_bf16x3(float v0, float v1,
                                             uint32_t& p1, uint32_t& p2,
                                             uint32_t& p3) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v0, v1);
  float r0 = v0 - __low2float(a), r1 = v1 - __high2float(a);
  __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  r0 -= __low2float(b);
  r1 -= __high2float(b);
  __nv_bfloat162 c = __floats2bfloat162_rn(r0, r1);
  p1 = bf16x2_bits(a);
  p2 = bf16x2_bits(b);
  p3 = bf16x2_bits(c);
}

// -- tensor-core products (f32 accumulate) -----------------------------------
// The tensor cores add each product into their accumulator with
// truncation, so an accumulator that grows to the size of a whole dot
// product (||q||^2 ~ 860 at d = 768) loses up to 1 ulp of it at every
// instruction, always towards zero: over 768 columns far more than the
// fp32 tier's tolerance. The scans therefore start each k step's partial
// from zero (mma_*_zc), sum the step's three products into it (the small
// terms first; the partial stays near one step's size) and add it to an
// f32 register total with an ordinary rounded add. B2 issues the
// products of a stage's k steps in waves, so that none waits on the one
// before it; the asm is not volatile, so the compiler may interleave them
// further. (B1's wgmma products follow the same rule, in fused_topk.cu.)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (a zero accumulator)
__device__ __forceinline__ void mma_tf32_zc(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_zc(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// -- host: tensor maps -------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no link to libcuda), or null.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over the row-major [rows, cols] matrix at ptr (cols * esize a
// multiple of 16, ptr 16-byte aligned) with boxes of box_rows x box_cols,
// box_cols * esize <= 128 bytes, in the 128-byte swizzle when swizzle is
// set; zeros outside the matrix. Returns a cudaError_t.
inline int encode_map(CUtensorMap* map, const void* ptr, bool bf16,
                      uint64_t rows, uint64_t cols, uint32_t box_rows,
                      uint32_t box_cols, bool swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const uint64_t esize = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Generic-load counterpart of a swizzled TMA box, for inputs TMA cannot
// read (a row pitch that is not a multiple of 16 bytes, a misaligned base):
// one warp copies rows [row0, row0 + box_rows) x columns [col0, col0 +
// 128 / sizeof(T)) of src[rows, cols] into dst in the same layout, zeros
// outside the matrix.
template <typename T>
__device__ __forceinline__ void fill_box_sw128(unsigned char* dst,
                                               const T* __restrict__ src,
                                               long long rows, int cols,
                                               long long row0, int col0,
                                               int box_rows, int lane) {
  constexpr int PER_ROW = 128 / (int)sizeof(T);
  for (int e = lane; e < box_rows * PER_ROW; e += 32) {
    const int r = e / PER_ROW, c = e % PER_ROW;
    const long long gr = row0 + r;
    const int gc = col0 + c;
    const T v = (gr < rows && gc < cols) ? src[gr * cols + gc] : T(0.f);
    *reinterpret_cast<T*>(dst + sw128(r, c * (int)sizeof(T))) = v;
  }
}

}  // namespace dingo
