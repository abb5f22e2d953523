// VQ codebook nearest-neighbour search, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/vq.py:_vq_kernel (launched
// through nearest_codes_pallas). Same function:
//
//   out[n] = argmin_k ( ||e_k||^2 - 2 z_n . e_k ),   z = flat [N, D], e = codebook [K, D],
//
// in f32, with the first index on ties (jnp.argmin's rule). The ||z_n||^2 term is constant
// over a row and dropped, as in the TPU kernel. ||e_k||^2 is summed here, in f32, so the
// search is one launch. A row whose scores are all NaN returns code 0.
//
// What bounds it on an H100 SXM: 2 N K D flops of f32-accurate products against
// 4 (N D + K D + N) bytes. On the tensor cores in 3xTF32 (three TF32 products for one f32
// product: 495 / 3 = 165 TFLOP/s) that is 1.6 us at the VQ-VAE's N = 4,096, K = 512,
// D = 64 (268 MFLOP), against 0.36 us of bytes: bound by operations (4.0 us at the
// 67 TFLOP/s of f32 FMA on the CUDA cores).
//
// Design. The TPU program holds the codebook in VMEM and forms a [block_n, K] score tile
// with one MXU product. Here a block is one warpgroup and takes 64 latent rows, 16 a warp:
//  - Scores on the tensor cores in 3xTF32: z and e are split into TF32 hi + lo and
//    z e^T is taken as z_lo e_hi + z_hi e_lo + z_hi e_hi (the small terms first), with
//    f32 accumulation (the dropped z_lo e_lo is ~2^-21 relative): f32 accuracy, as the
//    f32 paths of the attention kernels. Each product is a wgmma.m64n64k8 (TF32), its A
//    operand the warp's z fragments, split once and kept in registers, its B operand a
//    split code tile in shared memory (K-major, 128-byte swizzle).
//  - The codebook streams through a ring of three shared-memory stages of 64 codes, in
//    16-byte cp.async copies (rows padded to D + 4 floats); the copies of later tiles are
//    in flight while a tile is split and its products run. The warpgroup splits each tile
//    into its hi and lo parts in 16-byte pieces (no bank hit twice), and takes the tile's
//    ||e||^2 in f32, two threads a code, once for all four warps.
//  - The argmin in the accumulator registers: a running (score, index) pair a row and
//    lane, replaced on a strict '<' in increasing k (the first of equal scores stays, and
//    NaN never enters), then reduced over the quad with the lower index on equal scores.
//    The [N, K] scores never leave the SM.
//  - A cluster of two blocks takes the same 64 rows, each block one half of the codebook
//    (in whole 64-code tiles), so N = 4,096 is 128 blocks on the 132 SMs and each block
//    reads half the codebook. Block 0 merges the pairs of block 1 through distributed
//    shared memory, with the lower index on equal scores. No atomics: repeats are bit
//    identical.
// The copies, the split and the barriers of a tile, not the products, set the pace at the
// VQ-VAE's shape (PERF.md, Findings).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_qkv_common.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using attn::a_frag_f32;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::load_tile_async;
using attn::smem_addr;
using attn::split_tf32;
using wgmma::keep;
using wgmma::mma_tf32_rs;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int kThreads = 128;      // one warpgroup
constexpr int kRows = 64;          // latent rows a block (and its cluster): 16 a warp
constexpr int kCodes = 64;         // codes a tile
constexpr int kStages = 3;
constexpr int kCluster = 2;        // blocks that share the rows, each a part of the codebook
constexpr int kNone = 0x7fffffff;  // no score below +inf yet

// Shared memory of a block, in floats: the split tile's hi and lo parts (each [slab][64
// codes][32 floats], 128-byte swizzled, 1024-byte aligned), z [64][D + 4], the ring of raw
// codebook tiles [kStages][64][D + 4], ||e||^2 [64].
template <int D>
struct Smem {
  static constexpr int ld = D + 4;
  static constexpr int slabs = (D + 31) / 32;  // 32 floats of k a 128-byte row
  static constexpr int hi = 0;
  static constexpr int lo = hi + slabs * kCodes * 32;
  static constexpr int z = lo + slabs * kCodes * 32;
  static constexpr int raw = z + kRows * ld;
  static constexpr int sq = raw + kStages * kCodes * ld;
  // 1024 bytes of slack to align the swizzle's 1024-byte atoms.
  static constexpr size_t bytes = 1024 + sizeof(float) * (sq + kCodes);
};

// The descriptor of a K-major TF32 operand, 128-byte swizzle (layout type 1): rows of 32
// floats of k, the 8-row groups 1024 bytes apart (stride byte offset); the k step of 8
// floats is 32 bytes along the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// (best, idx) becomes the smaller of itself and (s, i): the lower score, the lower index
// on equal scores.
__device__ __forceinline__ void take_min(float& best, int& idx, float s, int i) {
  if (s < best || (s == best && i < idx)) {
    best = s;
    idx = i;
  }
}

template <int D>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    vq_nearest_wgmma_kernel(const float* __restrict__ flat, const float* __restrict__ codebook,
                            int* __restrict__ out, int n, int k, int k_part) {
  using S = Smem<D>;
  constexpr int kSteps = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  float* z_s = smem + S::z;
  float* raw_s = smem + S::raw;
  float* hi_s = smem + S::hi;
  float* lo_s = smem + S::lo;
  float* sq_s = smem + S::sq;
  __shared__ float best_s[kRows];
  __shared__ int idx_s[kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * kRows;
  const int c_begin = min(k, rank * k_part), c_end = min(k, c_begin + k_part);
  const int n_codes = c_end - c_begin;
  const int n_tiles = (n_codes + kCodes - 1) / kCodes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const float* cb = codebook + static_cast<size_t>(c_begin) * D;

  // Group 0: the block's rows of z (rows past n zero-filled) and the first tile.
  load_tile_async<float, kRows, D, kThreads>(z_s, S::ld, flat, D, row0, n, D);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile_async<float, kCodes, D, kThreads>(raw_s + s * kCodes * S::ld, S::ld, cb, D,
                                                  s * kCodes, n_codes, D);
    cp_async_commit();
  }

  uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
  float best[2] = {INFINITY, INFINITY};  // rows g and g + 8 of the warp's 16
  int idx[2] = {kNone, kNone};
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile it (and z) landed for this thread's copies
    __syncthreads();  // ... and everyone's; tile it - 1's products are done everywhere
    if (it == 0) {
#pragma unroll
      for (int e = 0; e < kSteps; ++e) {
        uint32_t a[4];
        a_frag_f32(a, z_s, S::ld, 16 * warp, 8 * e);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), a_hi[e][i], a_lo[e][i]);
      }
    }

    // Split the tile into its TF32 hi and lo parts, swizzled, four elements at a time:
    // elements 4 q .. 4 q + 3 of code c go to slab q / 8, row c, 16-byte chunk (q % 8) ^
    // (c % 8). Eight threads read and write 128 bytes of one row: no bank is hit twice.
    const float* tile = raw_s + (it % kStages) * kCodes * S::ld;
#pragma unroll
    for (int r = 0; r < kCodes * D / 4 / kThreads; ++r) {
      const int i = threadIdx.x + kThreads * r;
      const int code = i / (D / 4), q = i % (D / 4);
      const int at = (q / 8) * kCodes * 32 + code * 32 + (((q % 8) ^ (code & 7)) << 2);
      const float4 x = *reinterpret_cast<const float4*>(tile + code * S::ld + 4 * q);
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi_s + at) = h;
      *reinterpret_cast<uint4*>(lo_s + at) = l;
    }
    // ||e||^2 of the tile's codes in f32: two threads a code, alternate 16-byte chunks.
    {
      const int code = threadIdx.x >> 1, half = threadIdx.x & 1;
      float sq = 0.f;
#pragma unroll
      for (int q = half; q < D / 4; q += 2) {
        const float4 x = *reinterpret_cast<const float4*>(tile + code * S::ld + 4 * q);
        sq = fmaf(x.x, x.x, sq);
        sq = fmaf(x.y, x.y, sq);
        sq = fmaf(x.z, x.z, sq);
        sq = fmaf(x.w, x.w, sq);
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      if (half == 0) sq_s[code] = sq;
    }
    // The split parts go to the products (the async proxy); then the copy of a later tile
    // starts, after the fence, which would otherwise wait for it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < n_tiles)
      load_tile_async<float, kCodes, D, kThreads>(raw_s + (next % kStages) * kCodes * S::ld,
                                                  S::ld, cb, D, next * kCodes, n_codes, D);
    cp_async_commit();

    // Scores: z e^T in 3xTF32, the small terms first at each step of 8 elements.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < kSteps; ++e) {
      const uint32_t off = (e / 4) * kCodes * 128 + (e % 4) * 32;
      const uint64_t hi = desc_sw128(smem_addr(hi_s) + off), lo = desc_sw128(smem_addr(lo_s) + off);
      mma_tf32_rs(acc, a_lo[e], hi, e > 0);
      mma_tf32_rs(acc, a_hi[e], lo, 1);
      mma_tf32_rs(acc, a_hi[e], hi, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);

    // acc[4 j + c]: row g + 8 (c / 2), code 8 j + 2 t + c % 2 of the tile.
    const int base = c_begin + it * kCodes;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int code = 8 * j + 2 * t + c;
        if (base + code >= c_end) continue;
        const float norm = sq_s[code];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float score = norm - 2.0f * acc[4 * j + 2 * r + c];
          if (score < best[r]) {
            best[r] = score;
            idx[r] = base + code;
          }
        }
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1)
      take_min(best[r], idx[r], __shfl_xor_sync(0xffffffffu, best[r], m),
               __shfl_xor_sync(0xffffffffu, idx[r], m));
    if (t == 0) {
      best_s[16 * warp + (lane >> 2) + 8 * r] = best[r];
      idx_s[16 * warp + (lane >> 2) + 8 * r] = idx[r];
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      float b = best_s[r];
      int i = idx_s[r];
#pragma unroll
      for (int other = 1; other < kCluster; ++other)
        take_min(b, i, cluster.map_shared_rank(best_s, other)[r],
                 cluster.map_shared_rank(idx_s, other)[r]);
      if (row0 + r < n) out[row0 + r] = i == kNone ? 0 : i;
    }
  }
  cluster.sync();  // the other blocks' pairs stay until block 0 has read them
}

template <int D>
cudaError_t launch(const float* flat, const float* codebook, int* out, int n, int k,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(vq_nearest_wgmma_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Each block of a cluster whole tiles of codes; the last blocks may have fewer or none.
  const int k_part = ((k + kCluster - 1) / kCluster + kCodes - 1) / kCodes * kCodes;
  const int blocks = kCluster * ((n + kRows - 1) / kRows);
  vq_nearest_wgmma_kernel<D><<<blocks, kThreads, smem, stream>>>(flat, codebook, out, n, k,
                                                                  k_part);
  return cudaGetLastError();
}

}  // namespace

// flat [n, d] f32, codebook [k, d] f32, both contiguous and 16-byte aligned; out [n] int32.
// d in {8, 16, 32, 64, 128}, n >= 1, k >= 1. Returns a cudaError_t (0: launched).
extern "C" int lgm_vq_nearest(const void* flat, const void* codebook, void* out, int n,
                              int k, int d, void* stream) {
  const float* z = static_cast<const float*>(flat);
  const float* e = static_cast<const float*>(codebook);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || reinterpret_cast<uintptr_t>(flat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codebook) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return static_cast<int>(launch<8>(z, e, o, n, k, s));
    case 16: return static_cast<int>(launch<16>(z, e, o, n, k, s));
    case 32: return static_cast<int>(launch<32>(z, e, o, n, k, s));
    case 64: return static_cast<int>(launch<64>(z, e, o, n, k, s));
    case 128: return static_cast<int>(launch<128>(z, e, o, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
