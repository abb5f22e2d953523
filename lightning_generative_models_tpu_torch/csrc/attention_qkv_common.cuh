// Shared pieces of the softmax-attention kernels: the packed-qkv forward and backward
// (attention_qkv.cu, replacing _vmem_attn_fwd_kernel; attention_qkv_bwd.cu, replacing
// _vmem_attn_bwd_kernel) and the flash forward (flash_attention.cu, replacing
// _flash_kernel), all of lightning_generative_models_tpu/ops/attention.py; the VQ search
// (vq.cu) takes its TF32 split, fragment reads and copies.
//
// What bounds them on an H100 SXM: their [n, n] x d products (989 TFLOP/s bf16, 495 TF32
// on the tensor cores, against 67 TFLOP/s of f32 FMA on the CUDA cores) and, at the DiT's
// n = 256, the bytes of qkv (3.35 TB/s). So every product here runs on the tensor cores
// as warp-level mma.sync, and the operand tiles stream through shared memory by cp.async.
//
// The building blocks (the products, ldmatrix and cp.async themselves in mma_sync.cuh):
//  - mma_bf16 (m16n8k16, bf16 operands) for operands that are exact in bf16: the bf16
//    path's q, k, v and g, whose products are exact in the f32 accumulator.
//  - mma (m16n8k8, TF32 operands) and the 3xTF32 scheme (split_tf32, mma3_split), which
//    keeps the f32 products' accuracy for the f32 path's operands.
//  - split_bf16: an f32 intermediate (P, dS) as bf16 hi + bf16 lo (~2^-17 relative) for
//    a product with an exact bf16 operand: two mma_bf16 where one f32 product was.
//  - ldmatrix, plain and transposed, for bf16 fragments of row-major tiles, and plain
//    for f32 fragments read as 32-bit words.
//  - cp.async 16-byte copies into shared memory, zero-filled past the ragged edge, so
//    that a ring of tiles fills while the products of the previous tile run.
//  - rows_dot_rows (a b^T of two tiles in shared memory) and acc_times_tile (an
//    accumulator block in registers times a tile in shared memory): every [n, n] x d
//    product of the packed-qkv kernels is one of the two.
//  - quad_max / quad_sum: a row of an mma accumulator lives in the four lanes of a quad.
//
// The fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8"): lane
// (g, t) = (lane / 4, lane % 4) holds accumulator elements (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) of a 16 x 8 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

#include "mma_sync.cuh"

namespace attn {

// The tensor-core products, fragment loads and copies of mma_sync.cuh, shared with the
// linear-attention kernels.
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4;
using tc::ldmatrix_x4_trans;
using tc::mma;
using tc::mma3_split;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_addr;
using tc::split_tf32;

constexpr int kMaxD = 128;  // head width, a multiple of 8

// (batch, token, head) strides of one operand, in elements.
struct Strides {
  long long batch, token, head;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const Strides& s, int b, int h) {
  return static_cast<const T*>(base) + b * s.batch + h * s.head;
}

template <typename T>
__device__ __forceinline__ T* head_ptr(void* base, const Strides& s, int b, int h) {
  return static_cast<T*>(base) + b * s.batch + h * s.head;
}

inline bool valid_shape(int b, int heads, int n_q, int n_kv, int d) {
  return b >= 1 && b <= 65535 && heads >= 1 && heads <= 65535 && n_q >= 1 && n_kv >= 1 &&
         d >= 8 && d <= kMaxD && d % 8 == 0;
}

// -- split operands ----------------------------------------------------------------------

// The pair (x, y) as hi + lo, both bf16 pairs: hi the rounded values, lo the rounded
// remainders, to ~2^-17 relative.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// The A fragments (hi and lo) of a 16 x 16 block whose values sit in two adjacent 16 x 8
// accumulator tiles c0 (columns 0-7) and c1 (columns 8-15): the accumulator layout of
// a row's pair of columns is the A layout's, so scores become an operand in registers.
__device__ __forceinline__ void acc_to_a_bf16(const float (&c0)[4], const float (&c1)[4],
                                              uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// The TF32 A fragments (hi and lo) of the 16 x 8 block in accumulator tile c, with the
// block's k index permuted: logical k = t holds column 2t and k = t + 4 column 2t + 1, so
// the B operand of the same product reads rows 2t and 2t + 1 (acc_times_tile).
__device__ __forceinline__ void acc_to_a_tf32(const float (&c)[4], uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// -- shared-memory fragments (bf16) ------------------------------------------------------

// The A fragment of the 16 x 16 block at (row r0, column c0) of a row-major bf16 tile.
__device__ __forceinline__ void a_frag_bf16(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                            int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column blocks, n0..n0+7 and n0+8..n0+15, over k = k0..k0+15, of a
// tile stored [n][k] (row-major by n: k in q k^T): b[0], b[1] the first, b[2], b[3] the
// second.
__device__ __forceinline__ void b_frags_nk_bf16(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                                int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same two blocks of a tile stored [k][n] (row-major by k: v in p v), transposed on
// the way.
__device__ __forceinline__ void b_frags_kn_bf16(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                                int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                           (lane >> 4) * 8);
}

// The same fragments of f32 tiles for the TF32 mma (m16n8k8), read by ldmatrix as 32-bit
// words: a row of an 8 x 8 b16 matrix is 4 floats, and lane (g, t) receives word t of row
// g. The A fragment of the 16 x 8 block at (r0, c0), and the B fragments of the 8-column
// blocks n0 and n0 + 8 over k = k0..k0 + 7 of a tile stored [n][k].
__device__ __forceinline__ void a_frag_f32(uint32_t (&a)[4], const float* tile, int ld, int r0,
                                           int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 + (lane >> 4) * 4);
}

__device__ __forceinline__ void b_frags_nk_f32(uint32_t (&b)[4], const float* tile, int ld,
                                               int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 4);
}

// -- cp.async ------------------------------------------------------------------------------

// Start copying rows row0 .. row0 + ROWS - 1 of a [n, d] slice (row stride token, d a
// multiple of 16 bytes' worth) into a [ROWS][ld] tile, rows at or past n zero-filled.
// All THREADS threads of the block take part; DMAX bounds d at compile time.
template <typename T, int ROWS, int DMAX, int THREADS>
__device__ __forceinline__ void load_tile_async(T* dst, int ld, const T* src, long long token,
                                                int row0, int n, int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DMAX / kVec;  // chunks of the widest row
  constexpr int kChunks = ROWS * kPerRow;
  const int per_row = d / kVec;
#pragma unroll
  for (int j = 0; j < (kChunks + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / kPerRow, c = i % kPerRow;
    if (i < kChunks && c < per_row) {
      const bool valid = row0 + r < n;
      cp_async16(dst + r * ld + c * kVec, valid ? src + (row0 + r) * token + c * kVec : src,
                 valid);
    }
  }
}

// -- tiles in shared memory ---------------------------------------------------------------

// Row stride, in elements, of a [rows][d] tile in shared memory. bf16: d rounded up to
// the 16-wide k step of mma_bf16, plus 8 (an odd multiple of 16 bytes: the eight rows
// that one ldmatrix reads fall in eight different 16-byte bank groups). f32: d + 4 (the
// fragment reads of rows g, columns t and of rows 2t, columns g fall in 32 banks).
template <typename T>
__host__ __device__ constexpr int tile_ld(int d) {
  return sizeof(T) == 2 ? (d + 15) / 16 * 16 + 8 : d + 4;
}

// Zero columns d .. ceil16(d) - 1 of a bf16 [rows][ld] region: the k padding of a head
// width that is not a multiple of 16. cp.async never writes them.
__device__ __forceinline__ void zero_k_padding(__nv_bfloat16* tile, int rows, int ld, int d) {
  if (d % 16 == 0) return;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    *reinterpret_cast<uint4*>(tile + r * ld + d) = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero_k_padding(float*, int, int, int) {}

// s[j] = (the warp's rows r0 .. r0 + 15 of a) . (rows 8 j .. 8 j + 7 of b) over d
// features, j < 8: a 16 x 64 block of a b^T, both tiles [rows][ld] in shared memory.
// bf16: the operands are exact, one mma_bf16 a step. f32: 3xTF32.
template <int DMAX>
__device__ __forceinline__ void rows_dot_rows(float (&s)[8][4], const __nv_bfloat16* a_s,
                                              const __nv_bfloat16* b_s, int ld, int r0,
                                              int d) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int e = 0; e < DMAX / 16; ++e) {
    if (16 * e >= d) break;
    uint32_t a[4];
    a_frag_bf16(a, a_s, ld, r0, 16 * e);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      b_frags_nk_bf16(b, b_s, ld, 16 * jj, 16 * e);
      mma_bf16(s[2 * jj], a, b[0], b[1]);
      mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

template <int DMAX>
__device__ __forceinline__ void rows_dot_rows(float (&s)[8][4], const float* a_s,
                                              const float* b_s, int ld, int r0, int d) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int e = 0; e < DMAX / 8; ++e) {
    if (8 * e >= d) break;
    uint32_t a[4], hi[4], lo[4];
    a_frag_f32(a, a_s, ld, r0, 8 * e);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), hi[i], lo[i]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4], b_hi[4], b_lo[4];
      b_frags_nk_f32(b, b_s, ld, 16 * jj, 8 * e);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), b_hi[i], b_lo[i]);
      mma3_split(s[2 * jj], hi, lo, b_hi[0], b_lo[0], b_hi[1], b_lo[1]);
      mma3_split(s[2 * jj + 1], hi, lo, b_hi[2], b_lo[2], b_hi[3], b_lo[3]);
    }
  }
}

// acc[j] += p b for the warp's 16 x 64 block p (accumulator tiles p[0..7], k = the 64
// columns) and a [64][ld] tile b in shared memory (k = its rows), over the output columns
// 8 j .. 8 j + 7 below d. p is an f32 intermediate (probabilities, dS): split, as bf16
// hi + lo against an exact bf16 b, as TF32 hi + lo against an f32 b (3xTF32), in both
// cases from registers.
template <int NT>
__device__ __forceinline__ void acc_times_tile(float (&acc)[NT][4], const float (&p)[8][4],
                                               const __nv_bfloat16* b_s, int ld, int d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    acc_to_a_bf16(p[2 * kk], p[2 * kk + 1], hi, lo);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (16 * jj >= d) break;
      uint32_t b[4];
      b_frags_kn_bf16(b, b_s, ld, 16 * jj, 16 * kk);
      mma_bf16(acc[2 * jj], lo, b[0], b[1]);
      mma_bf16(acc[2 * jj], hi, b[0], b[1]);
      if (16 * jj + 8 < d) {
        mma_bf16(acc[2 * jj + 1], lo, b[2], b[3]);
        mma_bf16(acc[2 * jj + 1], hi, b[2], b[3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void acc_times_tile(float (&acc)[NT][4], const float (&p)[8][4],
                                               const float* b_s, int ld, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t hi[4], lo[4];
    acc_to_a_tf32(p[e], hi, lo);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j >= d) break;
      const float* br = b_s + (8 * e + 2 * t) * ld + 8 * j + g;  // the permuted k rows
      uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
      split_tf32(br[0], b0_hi, b0_lo);
      split_tf32(br[ld], b1_hi, b1_lo);
      mma3_split(acc[j], hi, lo, b0_hi, b0_lo, b1_hi, b1_lo);
    }
  }
}

// -- rows of an accumulator tile -----------------------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write the pair (x, y) to dst[0], dst[1] in T (dst 2-element aligned).
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// Write rows r0 + g and r0 + g + 8 (those below n) of the accumulator tiles acc[j]
// (columns 8 j .. 8 j + 7, j < d / 8), times mul, to a [n, d] slice with row stride token.
template <typename T, int NT>
__device__ __forceinline__ void store_acc_rows(T* dst, long long token, int r0, int n, int d,
                                               const float (&acc)[NT][4], float mul0,
                                               float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= n) continue;
    const float mul = i ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j >= d) break;
      store_pair(dst + row * token + 8 * j + 2 * t, acc[j][2 * i] * mul,
                 acc[j][2 * i + 1] * mul);
    }
  }
}

}  // namespace attn
