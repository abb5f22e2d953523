// Warp-level tensor-core products (mma.sync) and shared-memory copies, shared by both
// kernel families: the softmax-attention kernels and the VQ search (attention_qkv_common.cuh
// re-exports these into namespace attn) and the linear-attention block forward and backward
// (linear_attention_common.cuh).
//
//  - mma_bf16 (m16n8k16, bf16 operands, f32 accumulator) for operands that are exact in
//    bf16: a product of values rounded to bf16 is exact in the f32 accumulator.
//  - mma (m16n8k8, TF32 operands) and the 3xTF32 scheme: an f32 x is split into a TF32
//    hi and a remainder lo, and a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi (the
//    dropped a_lo b_lo is ~2^-21 relative), which keeps f32 products' accuracy on the
//    tensor cores. Two variants:
//      split_tf32 + mma3_split: lo exact, read truncated by the mma, and the three
//        products added into the caller's accumulator, ~9 2^-24 of |a b| a product. For
//        products whose sum is about as large as its terms: the softmax-attention kernels
//        (scores, p v, their gradients) and the VQ distances.
//      split_tf32_rn + mma3_split_fresh: lo rounded to nearest TF32 too (~2.5 2^-24 of
//        |a b|, an f32 FMA's), and each k step's three products summed in a fresh
//        accumulator, then added to the caller's by an f32 add that rounds to nearest:
//        the mma's own accumulation rounds every step against the running sum. For sums
//        of large terms that cancel: the linear-attention block, whose q logits reach ~1e3
//        on the head-scale-disparity input and whose dxn = dp Wqkvᵀ runs through the same
//        large weights. It costs two conversions and four adds more a k step.
//  - ldmatrix, plain and transposed, for bf16 fragments of tiles in shared memory.
//  - cp.async 16-byte copies into shared memory, so that a ring of tiles fills while the
//    products of the previous tile run.
//
// The fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8"): lane
// (g, t) = (lane / 4, lane % 4) holds accumulator elements (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) of a 16 x 8 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

// c += a b for a 16 x 8 A (row-major fragment), an 8 x 8 B (column fragment), f32 c.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for the f32 paths, in two integer operations and one subtraction where two
// cvt.rna.tf32 conversions would do: hi rounded to TF32 by adding half of its last place
// to the bits and clearing the 13 bits TF32 drops, lo the exact remainder, which the mma
// reads truncated to TF32 (~2^-21 relative in all). The conversions were a third of the
// packed-qkv kernels' f32 time on the H100. Finite x below 2^128 (1 - 2^-12) only: the
// rounding would carry past the largest float.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b in the 3xTF32 scheme on split operands, the small terms first.
__device__ __forceinline__ void mma3_split(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b0_lo, uint32_t b1_hi, uint32_t b1_lo) {
  mma(c, a_lo, b0_hi, b1_hi);
  mma(c, a_hi, b0_lo, b1_lo);
  mma(c, a_hi, b0_hi, b1_hi);
}

// x = hi + lo with both rounded to nearest TF32, the same integer rounding applied to the
// remainder.
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c += a b in the 3xTF32 scheme, the three products summed in a fresh accumulator first.
__device__ __forceinline__ void mma3_split_fresh(float (&c)[4], const uint32_t (&a_hi)[4],
                                                 const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                                 uint32_t b0_lo, uint32_t b1_hi,
                                                 uint32_t b1_lo) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_split(t, a_hi, a_lo, b0_hi, b0_lo, b1_hi, b1_lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// c += a b for a 16 x 16 A (row-major fragment), a 16 x 8 B (column fragment), both bf16
// pairs, f32 c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x and y (x in the low half) as a bf16 pair.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory; zeros where !valid (no byte is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n groups of this thread's copies are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n));
}

}  // namespace tc
